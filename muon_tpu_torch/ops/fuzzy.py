"""UMAP fuzzy-simplicial-set connectivities (counterpart of muon_tpu/ops/fuzzy.py).

    smooth_knn   T6  <- _smooth_knn_fn + _membership_fn (csrc/knn_kernels.cu)

Per kNN row: ρ (distance to the ``local_connectivity``-th nearest nonzero
neighbour), σ by a fixed 64-step bisection on Σ exp(−max(d−ρ, 0)/σ) =
log2(k)·bandwidth with umap-learn's lower bounds, and the membership
values, all on the device. The fuzzy union W + Wᵀ − W∘Wᵀ runs on the host
with scipy, the reference's own fallback construction (the reference's
native one-pass union equals it; the port does not import ``muon_tpu``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from scipy import sparse as sp

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor

__all__ = ["smooth_knn", "smooth_knn_plain", "membership_strengths",
           "compute_connectivities_umap"]

MIN_K_DIST_SCALE = 1e-3


def _target(k: int, bandwidth: float) -> float:
    # float32 as the reference's log2(k) * bandwidth
    return float(np.float32(np.log2(np.float32(k))) * np.float32(bandwidth))


def smooth_knn(
    dists: torch.Tensor, local_connectivity: float = 1.0,
    bandwidth: float = 1.0, n_iter: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T6: ``dists (n, k)`` float32, self and zeros allowed, rows in any
    order → ``(sigmas (n,), rhos (n,), vals (n, k))`` float32, where
    ``vals = exp(−max(dists − ρ, 0)/σ)`` (self edges not yet zeroed)."""
    if dists.device.type == "cpu":
        return smooth_knn_plain(dists, local_connectivity, bandwidth, n_iter)
    if dists.device.type != "cuda":
        raise ValueError(f"unsupported device {dists.device}")
    if dists.dtype != torch.float32 or dists.dim() != 2 or not dists.is_contiguous():
        raise ValueError(f"dists must be a contiguous 2-D float32 tensor, got "
                         f"{dists.dtype} {tuple(dists.shape)}")
    n, k = dists.shape
    if max(n, k, n * k) > 2**31 - 1:
        raise ValueError(f"dists of shape {(n, k)} exceeds the int32 range")
    mean_all = dists.mean().reshape(1)
    sigmas = torch.empty(n, dtype=torch.float32, device=dists.device)
    rhos = torch.empty_like(sigmas)
    vals = torch.empty_like(dists)
    _kernels.launch(
        "smooth_knn_membership", dists.device,
        dists.data_ptr(), n, k, float(local_connectivity), _target(k, bandwidth),
        mean_all.data_ptr(), int(n_iter), MIN_K_DIST_SCALE,
        sigmas.data_ptr(), rhos.data_ptr(), vals.data_ptr(),
    )
    return sigmas, rhos, vals


def smooth_knn_plain(
    dists: torch.Tensor, local_connectivity: float = 1.0,
    bandwidth: float = 1.0, n_iter: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    n, k = dists.shape
    target = _target(k, bandwidth)
    nonzero = dists > 0.0
    num_nonzero = nonzero.sum(dim=1)
    sorted_nz = torch.sort(torch.where(nonzero, dists, math.inf), dim=1).values
    li = math.floor(local_connectivity)
    frac = local_connectivity - li
    if li >= 1:
        lo = sorted_nz[:, min(li - 1, k - 1)]
        hi = sorted_nz[:, min(li, k - 1)]
        interp = lo + frac * (hi - lo)
    else:
        interp = frac * sorted_nz[:, 0]
    largest = sorted_nz.gather(1, (num_nonzero - 1).clamp(min=0)[:, None])[:, 0]
    rhos = torch.where(
        num_nonzero > 0, torch.where(num_nonzero > li, interp, largest), 0.0
    )

    d_adj = torch.clamp(dists - rhos[:, None], min=0.0)
    lo = torch.zeros(n, dtype=dists.dtype, device=dists.device)
    hi = torch.full_like(lo, math.inf)
    mid = torch.ones_like(lo)
    for _ in range(n_iter):
        too_big = torch.exp(-d_adj / mid[:, None]).sum(dim=1) > target
        hi = torch.where(too_big, mid, hi)
        lo = torch.where(too_big, lo, mid)
        mid = torch.where(
            too_big | ~torch.isinf(hi), (lo + hi) / 2.0, lo * 2.0
        )

    mean_d = torch.where(
        num_nonzero > 0,
        torch.where(nonzero, dists, 0.0).sum(dim=1) / num_nonzero.clamp(min=1),
        0.0,
    )
    floor = MIN_K_DIST_SCALE * torch.where(rhos > 0.0, mean_d, dists.mean())
    sigmas = torch.maximum(mid, floor)
    vals = torch.exp(-torch.clamp(dists - rhos[:, None], min=0.0) / sigmas[:, None])
    return sigmas, rhos, vals


def _to_numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _directed(knn_indices, vals):
    """COO (rows, cols, vals) of the directed membership graph: the self
    edges get 0 and padding (index < 0) is dropped."""
    idx, vals = _to_numpy(knn_indices), _to_numpy(vals)
    n, k = idx.shape
    rows = np.repeat(np.arange(n), k)
    cols = idx.reshape(-1)
    v = vals.reshape(-1).astype(np.float32, copy=True)
    v[cols == rows] = 0.0
    keep = cols >= 0
    return rows[keep], cols[keep], v[keep]


def membership_strengths(knn_indices, knn_dists, sigmas, rhos):
    """The directed membership graph as COO (rows, cols, vals) from the kNN
    table and σ, ρ: vals = exp(−max(d − ρ, 0)/σ), self edges 0."""
    d = torch.as_tensor(_to_numpy(knn_dists), dtype=torch.float32)
    sig = torch.as_tensor(_to_numpy(sigmas), dtype=torch.float32)
    rho = torch.as_tensor(_to_numpy(rhos), dtype=torch.float32)
    vals = torch.exp(-torch.clamp(d - rho[:, None], min=0.0) / sig[:, None])
    return _directed(knn_indices, vals)


def _fuzzy_union(knn_indices, vals, n_obs: int, set_op_mix_ratio: float) -> sp.csr_matrix:
    rows, cols, v = _directed(knn_indices, vals)
    W = sp.coo_matrix((v, (rows, cols)), shape=(n_obs, n_obs)).tocsr()
    Wt = W.T.tocsr()
    prod = W.multiply(Wt)
    conn = set_op_mix_ratio * (W + Wt - prod) + (1.0 - set_op_mix_ratio) * prod
    conn.eliminate_zeros()
    conn = conn.tocsr()
    conn.data = conn.data.astype(np.float32)
    conn.sort_indices()
    return conn


def compute_connectivities_umap(
    knn_indices,
    knn_dists,
    n_obs: int,
    n_neighbors: int,
    set_op_mix_ratio: float = 1.0,
    local_connectivity: float = 1.0,
    device: DeviceLike = None,
) -> sp.csr_matrix:
    """Fuzzy union of the directed membership graphs → symmetric float32
    connectivities (scanpy ``_compute_connectivities_umap`` parity).

    ``knn_dists``: numpy (uploaded to ``device``) or a tensor (used where it
    lies); σ, ρ and the membership values run there (T6), the union on the
    host."""
    if torch.is_tensor(knn_dists):
        dists = knn_dists.float().contiguous()
    else:
        dists = dense_to_tensor(knn_dists, device)
    with stage("fuzzy/smooth_knn"):
        _, _, vals = smooth_knn(dists, float(local_connectivity), 1.0)
        vals = vals.cpu().numpy()
    with stage("fuzzy/union"):
        return _fuzzy_union(knn_indices, vals, n_obs, set_op_mix_ratio)
