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

A dense X takes the reference's plain loop: matmuls and Householder QR
(``torch.linalg.qr``) after every product.

PCA (``pca``) has the reference's three branches: implicitly centred XᵀX
iteration over T4 + T2 (``_pca_blocks``), implicitly centred gather
iteration over T2/T3 in float32 (``_pca_gather``), and CholeskyQR² over
``torch.matmul`` for a dense X (``_pca_dense``).

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
from .device import DeviceLike, dense_to_tensor, resolve_device

__all__ = ["randomized_svd", "truncated_svd", "pca", "draw_omega", "Products",
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
    return _rayleigh_ritz(Y, V, k)


def _rayleigh_ritz(Y: torch.Tensor, V: torch.Tensor, k: int) -> SVD:
    """The SVD of Y = X·V (V orthonormal) through ``eigh`` of the l×l Gram."""
    lam, W = torch.linalg.eigh(Y.T @ Y)
    lam, W = lam.flip(0), W.flip(1)
    s = torch.sqrt(torch.clamp(lam, min=0.0))
    U = Y @ (W / torch.clamp(s, min=1e-30))
    Vt = (V @ W).T
    return U[:, :k], s[:k], Vt[:k]


def _qr_iteration(mv: Callable, rmv: Callable, omega: torch.Tensor, k: int,
                  n_iter: int) -> SVD:
    """Subspace iteration with Householder QR after every product (the
    reference's dense rSVD and sparse-gather PCA loops) over ``mv`` (X·B)
    and ``rmv`` (Xᵀ·B), then the SVD of the (l, d) matrix QᵀX."""
    Q = torch.linalg.qr(mv(omega)).Q
    for _ in range(n_iter):
        Z = torch.linalg.qr(rmv(Q)).Q
        Q = torch.linalg.qr(mv(Z)).Q
    Ub, s, Vt = torch.linalg.svd(rmv(Q).T, full_matrices=False)
    U = Q @ Ub
    return U[:, :k], s[:k], Vt[:k]


def _omega(omega, d: int, l: int, seed: int, device: torch.device) -> torch.Tensor:
    """The (d, l) test matrix: ``omega`` as given (numpy or tensor), or drawn
    from ``seed``."""
    if omega is None:
        return draw_omega(d, l, seed, device)
    if not torch.is_tensor(omega):
        omega = torch.from_numpy(np.array(omega, dtype=np.float32))
    omega = omega.to(device, torch.float32)
    if tuple(omega.shape) != (d, l):
        raise ValueError(f"omega must have shape {(d, l)}, got {tuple(omega.shape)}")
    return omega


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
    used), a scipy sparse matrix (uploaded to ``device``), or a dense array
    or tensor (float32 on ``device``; ``method`` and ``symmetric`` do not
    apply to it, as in the reference).

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
        X = dense_to_tensor(X, device)
    n, d = X.shape
    l = min(k + n_oversample, min(n, d))
    omega = _omega(omega, d, l, seed, X.device)
    with stage("linalg/rsvd"):
        if torch.is_tensor(X):
            return _qr_iteration(lambda B: X @ B, lambda B: X.T @ B, omega,
                                 int(k), int(n_iter))
        if method == "blocks" or (
            method == "auto" and _blocks_profitable(n, d, X.nnz, l)
        ):
            return _rsvd_blocks(X, int(k), omega, int(n_iter))
        return _rsvd_gather(X, int(k), omega, int(n_iter), bool(symmetric))


# alias matching scipy naming
truncated_svd = randomized_svd


# ---------------------------------------------------------------------------
# PCA (counterpart of muon_tpu/ops/linalg.py pca)
# ---------------------------------------------------------------------------


def _pca_blocks(
    X: dsp.DeviceCSR, cs: torch.Tensor, k: int, omega: torch.Tensor,
    n_iter: int, ops: Products = KERNEL_OPS,
) -> SVD:
    """Implicitly centred XᵀX iteration (``_pca_blocks_fn``): with
    μ = cs/n, (X−1μᵀ)ᵀ(X−1μᵀ)V = XᵀX·V − cs(csᵀV)/n, so the power step is
    T4 less a rank-1 term and X stays sparse; the final product is the
    exact f32 T2 less μᵀV. ``cs`` is zero for uncentred PCA."""
    n = X.n_rows
    V = _cholqr(omega)
    for _ in range(n_iter):
        V = _cholqr(
            ops.gram_matmul(X, V.contiguous()) - cs[:, None] * (cs @ V)[None, :] / n
        )
    Y = ops.spmm(X, V.contiguous()) - ((cs / n) @ V)[None, :]
    return _rayleigh_ritz(Y, V, k)


def _pca_gather(
    X: dsp.DeviceCSR, mu, k: int, omega: torch.Tensor, n_iter: int,
    ops: Products = KERNEL_OPS,
) -> SVD:
    """Implicitly centred subspace iteration over T2/T3 with float32
    operands and Householder QR, as the reference's sparse gather branch.
    ``mu`` is None for uncentred PCA."""

    def mv(B):
        out = ops.spmm(X, B.contiguous())
        return out if mu is None else out - (mu @ B)[None, :]

    def rmv(B):
        out = ops.spmm_t(X, B.contiguous())
        return out if mu is None else out - mu[:, None] * B.sum(dim=0)[None, :]

    return _qr_iteration(mv, rmv, omega, k, n_iter)


def _pca_dense(
    X: torch.Tensor, k: int, omega: torch.Tensor, n_iter: int, center: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """CholeskyQR² iteration on the explicitly centred dense X
    (``_pca_dense_fn``); also returns the total variance Σ Xc²/(n−1)."""
    Xc = X - X.mean(dim=0) if center else X
    Q = _cholqr(Xc @ omega)
    for _ in range(n_iter):
        Z = _cholqr(Xc.T @ Q)
        Q = _cholqr(Xc @ Z)
    Ub, s, Vt = torch.linalg.svd((Xc.T @ Q).T, full_matrices=False)
    U = Q @ Ub
    return U[:, :k], s[:k], Vt[:k], (Xc * Xc).sum() / (X.shape[0] - 1)


def pca(
    X,
    n_comps: int = 50,
    center: bool = True,
    seed: int = 0,
    n_iter: int = 7,
    omega=None,
    device: DeviceLike = None,
):
    """PCA by randomized subspace iteration; a sparse X is never densified
    (centring folds into the products). Returns float32 tensors on the
    device: ``(scores (n,k), loadings (d,k), explained_variance (k,),
    explained_variance_ratio (k,))``.

    ``X``: scipy sparse (uploaded to ``device``) or dense. A sparse X takes
    the XᵀX branch when ``_blocks_profitable``, the gather branch otherwise.
    ``omega``: the (d, l) test matrix to use instead of drawing one from
    ``seed`` (l = min(k + 10, n, d)), for comparing with the reference.
    """
    if isinstance(X, dsp.DeviceCSR):
        raise TypeError("pass scipy sparse or dense for pca")
    if sp.issparse(X):
        dX = dsp.from_scipy(X, device)
        n, d = X.shape
        # mean and total variance on the host, as the reference takes them
        mu = np.asarray(X.mean(axis=0)).ravel().astype(np.float32)
        total_var = float(
            np.asarray((X.multiply(X)).sum()) / (n - 1)
            - float(np.sum(mu**2)) * n / (n - 1)
        )
        k = min(n_comps, min(n, d) - 1 if center else min(n, d))
        l = min(k + 10, min(n, d))
        om = _omega(omega, d, l, seed, dX.device)
        mu_t = torch.from_numpy(mu).to(dX.device)
        with stage("linalg/pca"):
            if _blocks_profitable(n, d, dX.nnz, l):
                cs = mu_t * n if center else torch.zeros_like(mu_t)
                U, s, Vt = _pca_blocks(dX, cs, int(k), om, int(n_iter))
            else:
                U, s, Vt = _pca_gather(dX, mu_t if center else None, int(k), om,
                                       int(n_iter))
    else:
        Xt = dense_to_tensor(X, device)
        n, d = Xt.shape
        k = min(n_comps, min(n, d) - 1 if center else min(n, d))
        l = min(k + 10, min(n, d))
        om = _omega(omega, d, l, seed, Xt.device)
        with stage("linalg/pca"):
            U, s, Vt, tv = _pca_dense(Xt, int(k), om, int(n_iter), bool(center))
            total_var = float(tv)
    ev = s**2 / (n - 1)
    evr = ev / total_var if total_var > 0 else ev * 0
    return U * s[None, :], Vt.T, ev, evr
