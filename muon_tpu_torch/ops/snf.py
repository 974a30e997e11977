"""Similarity network fusion on the device (counterpart of the jitted programs
``_affinity_matrix`` and ``_snf_diffusion_fn`` of muon_tpu/_core/tools_graph.py).

    affinity_matrix   T29  <- _affinity_matrix (:78)     (csrc/snf_kernels.cu)
    snf_normalize     T30  <- _snf_diffusion_fn (:35): normalize
    snf_dominate_set  T31  <- _snf_diffusion_fn (:35): dominateset

``snf_diffusion`` runs the reference's cross-diffusion: the affinities
normalised (T30) and their dominant sets (T31), then per iteration and
modality ``S[m] @ other @ S[m].T`` in ``torch.matmul`` (dense, float32, as
the reference computes it; TF32 refused by ``ops.device``) and T30 on each
product; the fused matrix is the normalised mean.

Each wrapper runs its plain version for tensors on the CPU; for CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import math

import torch

from ..utils.profiling import stage
from . import _kernels
from .device import on_card

__all__ = [
    "affinity_matrix",
    "affinity_matrix_plain",
    "snf_diffusion",
    "snf_dominate_set",
    "snf_dominate_set_plain",
    "snf_normalize",
    "snf_normalize_plain",
]

# sqrt(2π) as the float32 the reference's jnp.sqrt(2 * jnp.pi) gives
_SQRT_2PI = float(torch.tensor(math.sqrt(2 * math.pi), dtype=torch.float32))
# the selections keep 64 threads' lists of k (+1) entries in shared memory
MAX_SELECT = 220


def _square(name: str, x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[0] != x.shape[1] or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous square matrix, got {tuple(x.shape)}")
    if x.shape[0] > 2_000_000:
        raise ValueError(f"{name} of side {x.shape[0]} exceeds the tiled grid")
    return x.shape[0]


def affinity_matrix(dist: torch.Tensor, known: torch.Tensor, k: int, sigma: float,
                    eps: float) -> torch.Tensor:
    """T29: the local-scale Gaussian affinity (SNFtool's affinityMatrix, as
    the reference computes it) of a dense kNN distance matrix ``dist (n, n)``
    float32 whose known entries are ``known (n, n)`` bool; unknown pairs
    have no affinity."""
    if not on_card(dist):
        return affinity_matrix_plain(dist, known, k, sigma, eps)
    n = _square("dist", dist)
    if dist.dtype != torch.float32 or known.dtype != torch.bool or known.shape != dist.shape \
            or not known.is_contiguous() or known.device != dist.device:
        raise ValueError("dist must be float32 and known a contiguous bool matrix beside it")
    if not 1 <= k + 1 <= MAX_SELECT:
        raise ValueError(f"T29 takes 0 <= k < {MAX_SELECT}, got {k}")
    means = torch.empty(n, dtype=torch.float32, device=dist.device)
    out = torch.empty_like(dist)
    _kernels.launch(
        "snf_affinity", dist.device,
        dist.data_ptr(), known.data_ptr(), n, int(k), float(sigma), float(eps),
        means.data_ptr(), out.data_ptr(),
    )
    return out


def affinity_matrix_plain(dist, known, k, sigma, eps):
    known = known | known.T
    d = torch.where(known, (dist + dist.T) / 2.0, torch.inf)
    d.fill_diagonal_(0.0)
    fin = torch.isfinite(d)
    sorted_d = torch.sort(torch.where(fin, d, torch.inf), dim=1).values
    win = sorted_d[:, 1:k + 1]
    wfin = torch.isfinite(win)
    kth = torch.where(wfin, win, 0.0)
    cnt = wfin.sum(dim=1)
    means = kth.sum(dim=1) / torch.clamp(cnt, min=1) + eps
    dz = torch.where(fin, d, 0.0)
    sig = (means[:, None] + means[None, :]) / 3.0 + dz / 3.0 + eps
    scale = sigma * sig
    dens = torch.exp(-0.5 * (dz / scale) ** 2) / (scale * _SQRT_2PI)
    dens = torch.where(fin, dens, 0.0)
    dens.fill_diagonal_(0.0)
    return (dens + dens.T) / 2.0


def snf_normalize(x: torch.Tensor) -> torch.Tensor:
    """T30: x / (2·(row sum without the diagonal; 1 where 0)), 0.5 on the
    diagonal, then made symmetric, (y + yᵀ) / 2."""
    if not on_card(x):
        return snf_normalize_plain(x)
    n = _square("x", x)
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    row = torch.empty(n, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    _kernels.launch("snf_normalize", x.device, x.data_ptr(), n, row.data_ptr(),
                    out.data_ptr())
    return out


def snf_normalize_plain(x):
    row = x.sum(dim=1) - torch.diagonal(x)
    row = torch.where(row == 0, 1.0, row)
    y = x / (2.0 * row[:, None])
    y.fill_diagonal_(0.5)
    return (y + y.T) / 2.0


def snf_dominate_set(x: torch.Tensor, k: int) -> torch.Tensor:
    """T31: every entry of a row at least its k-th largest value (counted
    with repeats, as ``lax.top_k``) kept, the rest 0, and the row divided by
    its sum."""
    if not on_card(x):
        return snf_dominate_set_plain(x, k)
    n = _square("x", x)
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not 1 <= k <= min(n, MAX_SELECT):
        raise ValueError(f"T31 takes 1 <= k <= min(n, {MAX_SELECT}), got k={k}, n={n}")
    out = torch.empty_like(x)
    _kernels.launch("snf_dominate_set", x.device, x.data_ptr(), n, int(k), out.data_ptr())
    return out


def snf_dominate_set_plain(x, k):
    thresh = torch.topk(x, k, dim=1).values[:, -1]
    kept = torch.where(x >= thresh[:, None], x, 0.0)
    return kept / kept.sum(dim=1, keepdim=True)


def diffusion_step(Wn, S):
    """One cross-diffusion iteration of the normalised stack ``Wn`` (a list
    of M (n, n) matrices) through the dominant sets ``S``."""
    M = len(Wn)
    total = Wn[0].clone()
    for w in Wn[1:]:
        total += w
    out = []
    for m in range(M):
        with stage("snf/products"):
            other = (total - Wn[m]) / max(M - 1, 1)
            nxt = torch.matmul(torch.matmul(S[m], other), S[m].T)
            del other
        with stage("snf/kernels"):
            out.append(snf_normalize(nxt))
        del nxt
    return out


def snf_diffusion(Ws, n_iterations: int, k: int) -> torch.Tensor:
    """The reference's ``_snf_diffusion_fn``: ``Ws`` the M affinity matrices
    (a list, or an (M, n, n) tensor); returns the fused (n, n) matrix."""
    M = len(Ws)
    with stage("snf/kernels"):
        Wn = [snf_normalize(Ws[m]) for m in range(M)]
        S = [snf_dominate_set(Wn[m], int(k)) for m in range(M)]
    for _ in range(int(n_iterations)):
        Wn = diffusion_step(Wn, S)
    fused = Wn[0].clone()
    for w in Wn[1:]:
        fused += w
    with stage("snf/kernels"):
        return snf_normalize(fused / M)
