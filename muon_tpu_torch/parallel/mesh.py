"""The device mesh over ``torch.distributed`` (counterpart of
muon_tpu/parallel/mesh.py).

The reference is single-controller: one process sees every device and
``jax.sharding.Mesh`` names them. ``torch.distributed`` is multi-controller:
one process per rank, each with its own device, joined by an initialised
process group (``torchrun --nproc_per_node=N``, or
``init_process_group`` with its address, world size and rank given). A
:class:`Mesh` names that group, this process's rank and device, and the
reference's axes ``("cells", "feat")`` with their sizes: rank r sits at
cells coordinate r // feat and feat coordinate r % feat, the reference's
``reshape(cells, feat)`` of its devices. Each axis has its process group:
the ranks of one feat coordinate share a cells group, the ranks of one
cells coordinate a feat group.

The pipeline (``parallel/pipeline.py``) shards the cells axis; on a mesh
with a feat axis the ranks of one cells coordinate repeat one another's
work, as the reference's ``shard_map`` over "cells" does. The MOFA sweep
shards both: ``shard_mofa_state`` keeps this rank's block of each leaf
(``cells_sharding``, ``feat_sharding``, ``grid_sharding``, ``replicated``
say which axis of a leaf is cut over which mesh axis) and
``gather_mofa_state`` rebuilds the whole state on every rank.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.device import DeviceLike, resolve_device

__all__ = ["Mesh", "Placement", "make_mesh", "mesh_split", "cells_sharding",
           "feat_sharding", "grid_sharding", "replicated", "shard_mofa_state",
           "gather_mofa_state"]


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
    "feat": f}``, c·f = size), this rank's coordinates ``cells_rank`` and
    ``feat_rank``, and per axis the global ranks along it (``cells_ranks``:
    the ranks that share ``feat_rank``; ``feat_ranks``: those that share
    ``cells_rank``) and their process group (``cells_group``,
    ``feat_group``). Every rank creates every group, in the same order: an
    axis of the whole world takes the default group, and an axis of one rank
    none (its collectives have nothing to exchange)."""

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
        self.cells_rank, self.feat_rank = divmod(self.rank, feat)
        along_cells = [[c * feat + f for c in range(cells)] for f in range(feat)]
        along_feat = [[c * feat + f for f in range(feat)] for c in range(cells)]
        self.cells_ranks = along_cells[self.feat_rank]
        self.feat_ranks = along_feat[self.cells_rank]
        self.cells_group = self._groups(along_cells)[self.feat_rank]
        self.feat_group = self._groups(along_feat)[self.cells_rank]

    def _groups(self, members):
        import torch.distributed as dist

        if len(members[0]) == 1:
            return [None] * len(members)
        if len(members[0]) == self.size:
            return [dist.group.WORLD]
        return [dist.new_group(ranks) for ranks in members]

    def axis(self, name: str):
        """(size, this rank's coordinate, the global ranks, the process
        group) of the axis ``"cells"`` or ``"feat"``."""
        if name == "cells":
            return self.shape["cells"], self.cells_rank, self.cells_ranks, self.cells_group
        if name == "feat":
            return self.shape["feat"], self.feat_rank, self.feat_ranks, self.feat_group
        raise ValueError(f"no mesh axis {name!r}: 'cells' or 'feat'")

    def block(self, n: int, axis: str) -> Tuple[int, int]:
        """This rank's [lo, hi) of n entries cut over ``axis``: blocks of
        ceil(n / size), the last ones shorter or empty."""
        P, i, _, _ = self.axis(axis)
        R = -(-int(n) // P)
        return min(i * R, n), min((i + 1) * R, n)

    def lengths(self, n: int, axis: str):
        """The block lengths of every coordinate of ``axis``."""
        P = self.axis(axis)[0]
        R = -(-int(n) // P)
        return [max(0, min((r + 1) * R, n) - min(r * R, n)) for r in range(P)]

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, size={self.size}, shape={self.shape}, "
                f"device={self.device}, backend={self.backend!r})")


def make_mesh(
    n_devices: Optional[int] = None,
    feat: Optional[int] = None,
    total_feat: Optional[int] = None,
    device: DeviceLike = None,
) -> Mesh:
    """A ("cells", "feat") mesh over the initialised process group.
    ``n_devices`` must be the group's world size (None takes it). ``feat``
    None picks the feat share through :func:`mesh_split` from ``total_feat``
    (the workload's ΣD, when known), as the reference does: ``make_mesh(4)``
    is (2, 2). ``device`` is this rank's device: None is the current CUDA
    device (set it per rank first, e.g. ``torch.cuda.set_device(local_rank)``);
    ``"cpu"`` runs the rank on the CPU (a gloo group). Every rank must call
    it, in the same order as its other collectives (it creates the axes'
    groups)."""
    import torch.distributed as dist

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
    if feat is None:
        _, feat = mesh_split(world, total_feat)
    feat = int(feat)
    if feat < 1 or world % feat:
        raise ValueError(f"feat={feat} does not divide the world size {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world // feat, feat, dev)


# ---------------------------------------------------------------------------
# placements: which axis of a tensor is cut over which mesh axis
# ---------------------------------------------------------------------------


class Placement(NamedTuple):
    """``axes[i]`` names the mesh axis ("cells" or "feat") that axis i of a
    tensor is cut over, or None where it is whole; ``()`` is replicated.
    The counterpart of the reference's ``NamedSharding``: here a rank holds
    its block as a tensor of its own, ``take`` cuts it from the whole
    and ``gather`` rebuilds the whole."""

    mesh: Mesh
    axes: Tuple[Optional[str], ...]

    def take(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's block of the whole tensor ``t``, contiguous (a copy
        where it is cut: the kernels take contiguous tensors only)."""
        if t is None or not any(self.axes):
            return t
        for dim, ax in enumerate(self.axes):
            if ax is not None:
                lo, hi = self.mesh.block(t.shape[dim], ax)
                t = t.narrow(dim, lo, hi - lo)
        return t.clone(memory_format=torch.contiguous_format)

    def gather(self, t: Optional[torch.Tensor], shape: Sequence[int]) -> Optional[torch.Tensor]:
        """The whole tensor of ``shape`` from every rank's block, on every
        rank."""
        from .comm import all_gather_rows

        if t is None or not any(self.axes):
            return t
        for dim, ax in enumerate(self.axes):
            if ax is not None:
                moved = t.movedim(dim, 0)
                whole = all_gather_rows(moved, self.mesh, self.mesh.lengths(shape[dim], ax),
                                        group=ax)
                t = whole.movedim(0, dim).contiguous()
        return t


def cells_sharding(mesh: Mesh, ndim: int = 2) -> Placement:
    """Axis 0 cut over "cells", the rest whole."""
    return Placement(mesh, ("cells",) + (None,) * (ndim - 1))


def feat_sharding(mesh: Mesh, ndim: int = 2, axis: int = 0) -> Placement:
    """Axis ``axis`` cut over "feat", the rest whole."""
    axes = [None] * ndim
    axes[axis] = "feat"
    return Placement(mesh, tuple(axes))


def grid_sharding(mesh: Mesh) -> Placement:
    """(N, D) tensors: rows over "cells", columns over "feat"."""
    return Placement(mesh, ("cells", "feat"))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def _placements(state: dict, mesh: Mesh) -> dict:
    """key -> Placement of every leaf of a MOFA VB state that is cut, the
    reference's ``shard_mofa_state`` key by key: Z and its spike-slab
    moments over cells, E and the masks and raw data on the grid, the
    weights and τ over feat, the sparse GP's covariates over cells;
    everything else (hyperparameters, the dense GP's ``gp_K``, the
    inducing points and per-factor GP hypers) replicated."""
    cells2, cells1 = cells_sharding(mesh, 2), cells_sharding(mesh, 1)
    grid, feat2, feat1 = grid_sharding(mesh), feat_sharding(mesh, 2), feat_sharding(mesh, 1)
    out = {"Z_mean": cells2, "Z_var": cells2, "G": cells2, "E": grid, "mask": grid,
           "M01": grid, "Y0": grid, "W_hat": feat2, "W_var": feat2, "S": feat2,
           "SW": feat2, "tau": feat1, "ln_tau": feat1, "tau_a": feat1, "tau_b": feat1,
           "Z_hat": cells2, "Z_vhat": cells2, "Z_S": cells2, "gp_cov": cells2,
           "gp_g": cells1}
    return {k: p for k, p in out.items() if k in state}


def shard_mofa_state(state: dict, mesh: Mesh) -> dict:
    """This rank's blocks of a MOFA VB state (``models/mofa.py``) that every
    rank holds whole: Z/G (N×·) over cells; E, the masks and the raw data
    (N×D) on the cells × feat grid; W/S/SW/τ (D×·) over feat; the global
    hyperparameters replicated. Each cut leaf is a contiguous copy. The
    sweep then makes the reductions the reference's XLA inserted: sums over
    cells for the column sums, over feat for the Z update."""
    out = dict(state)
    for key, p in _placements(state, mesh).items():
        val = state[key]
        out[key] = [p.take(v) for v in val] if isinstance(val, (list, tuple)) else p.take(val)
    return out


def gather_mofa_state(state: dict, mesh: Mesh, n_obs: int, n_feats: Sequence[int],
                      keys: Optional[Sequence[str]] = None) -> dict:
    """The inverse of :func:`shard_mofa_state`: the whole state on every
    rank from the ranks' blocks, for ``n_obs`` cells and views of
    ``n_feats`` features; ``keys`` gathers those alone (the others stay as
    they are)."""
    out = dict(state)
    for key, p in _placements(state, mesh).items():
        if keys is not None and key not in keys:
            continue
        val = state[key]

        def shape(v, D=None):
            if p.axes == ("cells", "feat"):
                return (n_obs, D)
            if p.axes[0] == "cells":
                return (n_obs,) + tuple(v.shape[1:])
            return (D,) + tuple(v.shape[1:])

        if isinstance(val, (list, tuple)):
            out[key] = [p.gather(v, shape(v, D) if v is not None else None)
                        for v, D in zip(val, n_feats)]
        else:
            out[key] = p.gather(val, shape(val))
    return out
