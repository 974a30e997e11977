"""Randomized truncated SVD over device CSR (counterpart of muon_tpu/ops/linalg.py).

Randomized subspace iteration (Halko et al. 2011) with two algorithms,
as in the reference:

* **gather** (``_rsvd_coo_fn``): alternate X·B (T2) and Xᵀ·B (T3) with
  CholeskyQR² after every product, then the SVD of the small (l, d) matrix
  QᵀX. The power iterations hand the kernels bfloat16 operands and sum in
  float32; the final Xᵀ·Q is full float32.
* **XᵀX** (``_rsvd_blocks_fn``): iterate V ← orth(XᵀX·V) through T4, then an
  exact float32 Y = X·V (T2) and Rayleigh–Ritz through ``eigh`` of the l×l
  Gram YᵀY.

Dense algebra (the Grams, Cholesky, triangular solves, ``eigh``, the small
SVD) is ``torch.linalg`` in float32, TF32 off (see ops/device.py).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
from scipy import sparse as sp

from ..utils.profiling import stage
from . import sparse as dsp
from .device import DeviceLike, resolve_device

__all__ = ["randomized_svd", "truncated_svd", "draw_omega", "Products",
           "KERNEL_OPS", "PLAIN_OPS"]


class Products(NamedTuple):
    """The sparse products an algorithm runs on: the kernel wrappers, or
    their plain versions (to compare the two on one device)."""

    spmm: Callable
    spmm_t: Callable
    gram_matmul: Callable


KERNEL_OPS = Products(dsp.spmm, dsp.spmm_t, dsp.gram_matmul)
PLAIN_OPS = Products(dsp.spmm_plain, dsp.spmm_t_plain, dsp.gram_matmul_plain)

SVD = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _cholqr(Y: torch.Tensor) -> torch.Tensor:
    """Cholesky-QR² orthonormalization of the columns of Y (n, l): the
    (n,l)ᵀ(n,l) Gram and an l×l Cholesky factor, twice; the second pass
    restores the orthogonality that float32 normal equations lose."""

    def once(Y):
        G = Y.T @ Y
        jitter = 1e-7 * (torch.trace(G) / Y.shape[1]) + 1e-30
        L = torch.linalg.cholesky(
            G + jitter * torch.eye(Y.shape[1], dtype=Y.dtype, device=Y.device)
        )
        # Y L⁻ᵀ, as solve_triangular(L, Yᵀ, lower=True)ᵀ in the reference
        return torch.linalg.solve_triangular(L.T, Y, upper=True, left=False)

    return once(once(Y))


def _blocks_profitable(n: int, d: int, nnz: int, l: int) -> bool:
    """The reference's cost-model gate for the XᵀX path, unchanged: large
    enough (≥ 2M nonzeros) and dense enough that n·d ≤ 4·nnz·(l+1)."""
    return nnz >= 2_000_000 and n * d <= 4 * nnz * (l + 1)


def draw_omega(d: int, l: int, seed: int, device: torch.device) -> torch.Tensor:
    """The (d, l) standard-normal test matrix Ω, from a ``torch.Generator``
    seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((d, l), generator=gen, dtype=torch.float32, device=device)


def _rsvd_gather(
    X: dsp.DeviceCSR, k: int, omega: torch.Tensor, n_iter: int,
    symmetric: bool = False, ops: Products = KERNEL_OPS,
) -> SVD:
    lo = torch.bfloat16
    mv = lambda B: ops.spmm(X, B.to(lo).contiguous())  # noqa: E731
    # Xᵀ ≡ X for symmetric inputs (graph Laplacians)
    rmv = mv if symmetric else (
        lambda B: ops.spmm_t(X, B.to(lo).contiguous())  # noqa: E731
    )
    Q = _cholqr(mv(omega))
    for _ in range(n_iter):
        Z = _cholqr(rmv(Q))
        Q = _cholqr(mv(Z))
    Qc = Q.contiguous()
    B = (ops.spmm(X, Qc) if symmetric else ops.spmm_t(X, Qc)).T  # (l, d) f32
    Ub, s, Vt = torch.linalg.svd(B, full_matrices=False)
    U = Q @ Ub
    return U[:, :k], s[:k], Vt[:k]


def _rsvd_blocks(
    X: dsp.DeviceCSR, k: int, omega: torch.Tensor, n_iter: int,
    ops: Products = KERNEL_OPS,
) -> SVD:
    V = _cholqr(omega)
    for _ in range(n_iter):
        V = _cholqr(ops.gram_matmul(X, V.contiguous()))
    Y = ops.spmm(X, V.contiguous())  # exact f32 final pass
    # Rayleigh–Ritz through the l×l Gram
    lam, W = torch.linalg.eigh(Y.T @ Y)
    lam, W = lam.flip(0), W.flip(1)
    s = torch.sqrt(torch.clamp(lam, min=0.0))
    U = Y @ (W / torch.clamp(s, min=1e-30))
    Vt = (V @ W).T
    return U[:, :k], s[:k], Vt[:k]


def randomized_svd(
    X,
    k: int,
    n_oversample: int = 10,
    n_iter: int = 7,
    seed: int = 0,
    method: str = "auto",
    symmetric: bool = False,
    omega=None,
    device: DeviceLike = None,
) -> SVD:
    """Truncated SVD of a sparse matrix by randomized subspace iteration.
    Returns ``(U (n,k), s (k,), Vt (k,d))`` as float32 tensors on the
    device, singular values in descending order.

    ``X``: a :class:`~muon_tpu_torch.ops.sparse.DeviceCSR` (its device is
    used) or a scipy sparse matrix (uploaded to ``device``).

    ``method``: ``"auto"`` takes the XᵀX path when ``_blocks_profitable``,
    the gather path otherwise; ``"blocks"``/``"gather"`` force a path. The
    name ``"blocks"`` is kept from the reference so callers carry over; the
    port builds no block layout, T4 works on the CSR directly.

    ``omega``: the (d, l) test matrix, numpy or tensor, to use instead of
    drawing one from ``seed`` (l = min(k + n_oversample, n, d)).
    """
    if method not in ("auto", "blocks", "gather"):
        raise ValueError(f"method must be 'auto', 'blocks' or 'gather', got {method!r}")
    if isinstance(X, dsp.DeviceCSR):
        if device is not None and resolve_device(device).type != X.device.type:
            raise ValueError(f"X is on {X.device}, device={device} was asked")
    elif sp.issparse(X):
        X = dsp.from_scipy(X, device)
    else:
        raise NotImplementedError(
            "randomized_svd of a dense matrix is not ported yet "
            "(ROADMAP: dense-input rSVD)"
        )
    n, d = X.shape
    l = min(k + n_oversample, min(n, d))
    if omega is None:
        omega = draw_omega(d, l, seed, X.device)
    else:
        if not torch.is_tensor(omega):
            omega = torch.from_numpy(np.array(omega, dtype=np.float32))
        omega = omega.to(X.device, torch.float32)
        if tuple(omega.shape) != (d, l):
            raise ValueError(f"omega must have shape {(d, l)}, got {tuple(omega.shape)}")
    with stage("linalg/rsvd"):
        if method == "blocks" or (
            method == "auto" and _blocks_profitable(n, d, X.nnz, l)
        ):
            return _rsvd_blocks(X, int(k), omega, int(n_iter))
        return _rsvd_gather(X, int(k), omega, int(n_iter), bool(symmetric))


# alias matching scipy naming
truncated_svd = randomized_svd
