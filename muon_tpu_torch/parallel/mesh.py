"""The device mesh over ``torch.distributed`` (counterpart of
muon_tpu/parallel/mesh.py).

The reference is single-controller: one process sees every device and
``jax.sharding.Mesh`` names them. ``torch.distributed`` is multi-controller:
one process per rank, each with its own device, joined by an initialised
process group (``torchrun --nproc_per_node=N``, or
``init_process_group`` with its address, world size and rank given). A
:class:`Mesh` names that group, this process's rank and device, and the
reference's axes ``("cells", "feat")`` with their sizes.

The pipeline of this package shards the ``"cells"`` axis only:
``make_mesh`` and the pipeline refuse ``feat`` > 1 by name; ``cells_sharding``, ``feat_sharding``,
``grid_sharding``, ``replicated`` and ``shard_mofa_state`` are not ported
yet (they come with the multi-device MOFA, ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.device import DeviceLike, resolve_device

__all__ = ["Mesh", "make_mesh", "mesh_split"]


def mesh_split(
    n_devices: int, total_feat: Optional[int] = None
) -> Tuple[int, int]:
    """Factor n_devices into (cells, feat) — cells-major since obs is the
    long axis (10⁶ cells vs 10⁵ features, SURVEY §2.6).

    ``total_feat`` (ΣD over views, when known) steers the feat-axis width
    for pod-scale meshes: wide views amortize feat shards (the W-sweep is
    embarrassingly parallel along D), narrow views leave feat shards idle
    below ~128 columns each and the psum over "feat" in every Z-sweep then
    costs more than it saves — so they get a cells-only mesh."""
    if n_devices < 4:
        return n_devices, 1
    if total_feat is not None:
        if total_feat < 512:
            return n_devices, 1
        if total_feat >= 4096 and n_devices % 8 == 0 and n_devices >= 16:
            return n_devices // 8, 8
        if total_feat >= 1024 and n_devices % 4 == 0 and n_devices >= 8:
            return n_devices // 4, 4
    if n_devices % 2 == 0:
        return n_devices // 2, 2
    return n_devices, 1


class Mesh:
    """The initialised default process group seen from one rank: ``rank``,
    ``size`` (the world size), ``device`` (this rank's), ``backend``
    (``"nccl"`` or ``"gloo"``), ``axis_names`` and ``shape`` (``{"cells": c,
    "feat": f}``, c·f = size)."""

    axis_names = ("cells", "feat")

    def __init__(self, cells: int, feat: int, device: torch.device):
        import torch.distributed as dist

        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        if cells * feat != self.size:
            raise ValueError(f"a ({cells}, {feat}) mesh needs {cells * feat} ranks, "
                             f"the group has {self.size}")
        self.backend = str(dist.get_backend())
        self.device = device
        self.shape = {"cells": cells, "feat": feat}

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, shape={self.shape}, "
                f"device={self.device}, backend={self.backend!r})")


def make_mesh(
    n_devices: Optional[int] = None,
    feat: int = 1,
    total_feat: Optional[int] = None,
    device: DeviceLike = None,
) -> Mesh:
    """A ("cells", "feat") mesh over the initialised process group.
    ``n_devices`` must be the group's world size (None takes it). Only
    ``feat=1`` is accepted: every tool of the port shards the cells axis
    alone, so ``feat`` > 1 and ``total_feat`` (which picks the feat share
    through :func:`mesh_split` in the reference) raise until the
    multi-device MOFA arrives. ``device`` is this rank's device: None is
    the current CUDA device (set it per rank first, e.g.
    ``torch.cuda.set_device(local_rank)``); ``"cpu"`` runs the rank on the
    CPU (a gloo group)."""
    import torch.distributed as dist

    if total_feat is not None or int(feat) != 1:
        raise NotImplementedError(
            f"make_mesh(feat={feat}, total_feat={total_feat}): the port's meshes have "
            "feat == 1; the feat axis comes with the multi-device MOFA"
        )
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(torchrun, or init_process_group with its address, world size and rank)"
        )
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices} differs from the world size {world}: "
                         "a mesh spans the whole process group")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world, 1, dev)
