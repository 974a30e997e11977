"""The collectives of the sharded pipeline: the counterparts of the ``psum``,
``all_gather`` and ``ppermute`` that XLA inserted into the reference's
``shard_map`` programs.

    all_reduce_sum   <- lax.psum over "cells"
    all_gather_rows  <- lax.all_gather, and the host's concatenation of the
                        cells-sharded outputs (blocks of unequal length)
    ring_shift       <- lax.ppermute to rank + 1

Each takes ``group``, the mesh axis it runs along: ``"cells"`` (the
default: the ranks that share this rank's feat coordinate, the whole mesh
when feat = 1) or ``"feat"``; point-to-point peers are global ranks, and
an axis of one rank exchanges nothing. Each is timed under its
own stage with the axis in its name (``comm/all_reduce[cells]``).

Every rank of a group calls each of them in the same order. On a NCCL group CUDA
tensors go as they are. A gloo group carries CPU tensors, so a CUDA tensor
is copied to pinned host memory, sent, and copied back: the copies are
timed under their own stage, ``comm/stage(host)``, and the compute stays on
the card. A tensor a backend cannot carry (a CPU tensor on NCCL, any tensor
on another backend) raises; nothing is moved anywhere quietly.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..utils.profiling import stage

__all__ = ["all_reduce_sum", "all_gather_rows", "ring_shift"]


def _staged(mesh, t: torch.Tensor) -> bool:
    """Whether ``t`` goes through host memory on ``mesh``'s backend."""
    if mesh.backend == "nccl":
        if t.device.type != "cuda":
            raise ValueError(f"a NCCL group carries CUDA tensors, got one on {t.device}")
        return False
    if mesh.backend == "gloo":
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {t.device}")
        return t.device.type == "cuda"
    raise NotImplementedError(f"backend {mesh.backend!r}: the pipeline takes nccl or gloo")


def _to_host(t: torch.Tensor) -> torch.Tensor:
    with stage("comm/stage(host)"):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h


def _to_device(h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    with stage("comm/stage(host)"):
        return h.to(like.device, non_blocking=False)


def all_reduce_sum(t: torch.Tensor, mesh, group: str = "cells") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group``, on each of them (``t``
    itself, summed in place, unless it went through the host)."""
    import torch.distributed as dist

    size, _, _, pg = mesh.axis(group)
    t = t.contiguous()
    staged = _staged(mesh, t)
    if size == 1:
        return t
    buf = _to_host(t) if staged else t
    with stage(f"comm/all_reduce[{group}]"):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=pg)
    return _to_device(buf, t) if staged else buf


def all_gather_rows(t: torch.Tensor, mesh, lengths: Sequence[int],
                    group: str = "cells") -> torch.Tensor:
    """The row blocks of the ranks of ``group`` stacked in the order of
    their coordinates. The blocks may differ in length (``lengths``, one per
    coordinate): each is padded to the longest, gathered, and cut back."""
    import torch.distributed as dist

    size, me, _, pg = mesh.axis(group)
    lengths = [int(x) for x in lengths]
    if len(lengths) != size or lengths[me] != t.shape[0]:
        raise ValueError(f"lengths {lengths} do not match this rank's block "
                         f"of {t.shape[0]} rows")
    t = t.contiguous()
    staged = _staged(mesh, t)
    if size == 1:
        return t.clone()  # a new tensor, as a gather gives: callers write t after
    width = max(lengths)
    src = t
    if t.shape[0] < width:
        src = torch.zeros((width,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        src[: t.shape[0]] = t
    buf = _to_host(src) if staged else src
    parts: List[torch.Tensor] = [torch.empty_like(buf) for _ in range(size)]
    with stage(f"comm/all_gather[{group}]"):
        dist.all_gather(parts, buf, group=pg)
    out = torch.cat([p[:m] for p, m in zip(parts, lengths)])
    return _to_device(out, t) if staged else out


def ring_shift(t: torch.Tensor, mesh, group: str = "cells") -> torch.Tensor:
    """``t`` sent to the next coordinate of ``group`` and the block of the
    one before received, as one batch of a non-blocking send and receive (no
    ordering of blocking sends can deadlock). Every rank's block has the
    same shape. A group of one rank keeps its own."""
    import torch.distributed as dist

    size, me, ranks, _ = mesh.axis(group)
    t = t.contiguous()
    staged = _staged(mesh, t)
    if size == 1:
        return t
    send = _to_host(t) if staged else t
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, ranks[(me + 1) % size]),
           dist.P2POp(dist.irecv, recv, ranks[(me - 1) % size])]
    with stage(f"comm/ring[{group}]"):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _to_device(recv, t) if staged else recv
