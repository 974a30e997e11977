"""The collectives of the sharded pipeline: the counterparts of the ``psum``,
``all_gather`` and ``ppermute`` that XLA inserted into the reference's
``shard_map`` programs.

    all_reduce_sum   <- lax.psum over "cells"
    all_gather_rows  <- lax.all_gather, and the host's concatenation of the
                        cells-sharded outputs (blocks of unequal length)
    ring_shift       <- lax.ppermute to rank + 1

Every rank calls each of them in the same order. On a NCCL group CUDA
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


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, on every rank (``t`` itself, summed
    in place, unless it went through the host)."""
    import torch.distributed as dist

    t = t.contiguous()
    staged = _staged(mesh, t)
    buf = _to_host(t) if staged else t
    with stage("comm/all_reduce"):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return _to_device(buf, t) if staged else buf


def all_gather_rows(t: torch.Tensor, mesh, lengths: Sequence[int]) -> torch.Tensor:
    """The ranks' row blocks stacked in rank order. The blocks may differ in
    length (``lengths``, one per rank): each is padded to the longest,
    gathered, and cut back."""
    import torch.distributed as dist

    t = t.contiguous()
    staged = _staged(mesh, t)
    lengths = [int(x) for x in lengths]
    if len(lengths) != mesh.size or lengths[mesh.rank] != t.shape[0]:
        raise ValueError(f"lengths {lengths} do not match this rank's block "
                         f"of {t.shape[0]} rows")
    width = max(lengths)
    src = t
    if t.shape[0] < width:
        src = torch.zeros((width,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        src[: t.shape[0]] = t
    buf = _to_host(src) if staged else src
    parts: List[torch.Tensor] = [torch.empty_like(buf) for _ in range(mesh.size)]
    with stage("comm/all_gather"):
        dist.all_gather(parts, buf)
    out = torch.cat([p[:m] for p, m in zip(parts, lengths)])
    return _to_device(out, t) if staged else out


def ring_shift(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` sent to rank + 1 and the block of rank − 1 received, as one
    batch of a non-blocking send and receive (no ordering of blocking sends
    can deadlock). Every rank's block has the same shape. One rank keeps
    its own."""
    import torch.distributed as dist

    if mesh.size == 1:
        return t
    t = t.contiguous()
    staged = _staged(mesh, t)
    send = _to_host(t) if staged else t
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, (mesh.rank + 1) % mesh.size),
           dist.P2POp(dist.irecv, recv, (mesh.rank - 1) % mesh.size)]
    with stage("comm/ring"):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _to_device(recv, t) if staged else recv
