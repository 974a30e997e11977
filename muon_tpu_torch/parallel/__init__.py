"""The multi-device pipeline over ``torch.distributed`` (counterpart of
muon_tpu.parallel).

The reference is single-controller: one process drives every device of a
``jax.sharding.Mesh``. ``torch.distributed`` is multi-controller, one
process per rank, so the port's calling convention is:

* start one process per device (``torchrun --nproc_per_node=N`` with NCCL,
  or ``init_process_group`` with its address, world size and rank);
  ``mesh = make_mesh()`` in each;
* every rank calls the same public function with the same host inputs
  (``atac.pp.tfidf(adata, mesh=mesh)``, ``atac.tl.lsi``, ``pp.neighbors``
  of one modality or of a MuData (WNN), ``tl.umap``, ``tl.mofa`` and
  ``models.mofa.fit_mofa``, or the ``sharded_*`` functions, or any of them
  under ``set_options(mesh=mesh)``);
* each rank computes on its contiguous row block, R = ceil(n / P) rows for
  the P coordinates of the mesh's cells axis, as ``shard_rows`` cuts it,
  with the single-device kernels, and the reductions across rows are the
  collectives of ``parallel/comm.py`` over the cells group; MOFA also cuts
  the features over the feat axis (``shard_mofa_state``) and sums over the
  feat group;
* every rank returns the same full result as the reference does.

At world size 1 the ``sharded_*`` functions still run (as ``shard_map``
runs on one device); only ``current_mesh`` sends the public tools to the
single-device path there. A NCCL group carries the CUDA tensors as they
are; a gloo group stages them through pinned host memory
(``comm/stage(host)``), so every rank can share one card, as the tests and
``chip_smoke.py`` run it. No multi-GPU measurement has been taken.

``dryrun_multichip`` (``parallel/dryrun.py``) runs the sharded MOFA sweep,
the pipeline and the public tools with WNN on a mesh.
"""

from .dryrun import dryrun_multichip, dryrun_on_mesh
from .mesh import (Mesh, Placement, cells_sharding, feat_sharding, gather_mofa_state,
                   grid_sharding, make_mesh, mesh_split, replicated, shard_mofa_state)
from .pipeline import (
    ShardedCSR,
    shard_rows,
    sharded_col_sums,
    sharded_ivf_knn,
    sharded_knn,
    sharded_lsi,
    sharded_rsvd,
    sharded_tfidf_data,
    sharded_umap_embed,
    sharded_values_to_scipy,
    sharded_wnn_bandwidth,
    sharded_wnn_scores,
    sharded_wnn_theta,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "mesh_split",
    "Placement",
    "cells_sharding",
    "feat_sharding",
    "grid_sharding",
    "replicated",
    "shard_mofa_state",
    "gather_mofa_state",
    "dryrun_multichip",
    "dryrun_on_mesh",
    "ShardedCSR",
    "shard_rows",
    "sharded_col_sums",
    "sharded_tfidf_data",
    "sharded_values_to_scipy",
    "sharded_rsvd",
    "sharded_lsi",
    "sharded_knn",
    "sharded_ivf_knn",
    "sharded_umap_embed",
    "sharded_wnn_bandwidth",
    "sharded_wnn_theta",
    "sharded_wnn_scores",
]
