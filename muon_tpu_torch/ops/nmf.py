"""Non-negative matrix factorisation and scOpen's imputation on the device
(counterpart of muon_tpu/ops/nmf.py).

    nmf_update  T33  <- _nmf_fn (:27): one multiplicative update of H or W,
                        the other factor's Gram included
                        (csrc/decomp_kernels.cu)
    spmm_split  T2's split variant <- the same loop's products WᵀX and
                        X·Hᵀ: T3's gather over X's and Xᵀ's CSR, each with
                        its piece table built once (ops/sparse.py,
                        csrc/sparse_kernels.cu)

Each iteration updates H, then W, as the reference does:

    H ← H ⊙ WᵀX ⊘ (WᵀW·H + αH + ε),   W ← W ⊙ XHᵀ ⊘ (W·HHᵀ + αW + ε),

ε = 1e-10. The port keeps H as Hᵀ (n × k), so both updates take one form,
F ⊙ N ⊘ (F·OᵀO + αF + ε) with O the other factor, and X as CSR in both
orientations: X·Hᵀ is a product of X's CSR, (WᵀX)ᵀ = Xᵀ·W one of Xᵀ's.
scOpen's X is binarised peaks scaled per cell (0.5% nonzero at the e2e's
100,000 cells × 25,000 peaks), so a product reads the stored entries, not
all of X, and the dense X is never built. Its peaks are Pareto-popular (a
row of X holds up to tens of thousands of cells), so the products run T2's
split variant, which cuts long rows into pieces. It sums a row's stored
entries in storage order, a piece at a time, where the reference's dense
product sums every term: they agree to float32 rounding.

The reference draws its starts with ``jax.random`` inside its jit, which
torch cannot reproduce: the port draws them from a ``torch.Generator``
seeded with ``seed``, at the reference's scale √(mean(X)/k) and with its
``abs``, and takes the reference's own draws as ``W0``/``H0`` where a caller
has them (the parity tests do).

``nmf_update`` runs its plain version for tensors on the CPU; for CUDA
tensors it launches T33 or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from . import sparse as dsp
from .device import DeviceLike, dense_to_tensor, on_card, resolve_device
from .sparse import DeviceCSR

__all__ = ["nmf", "nmf_factors", "nmf_update", "nmf_update_plain", "scopen_impute",
           "scopen_operands"]

_EPS = 1e-10  # the reference's eps, taken in float32
# T33's Gram partials: at most this many chunks of the other factor's rows,
# and at most 2**24 floats of partials
_GRAM_CHUNKS, _GRAM_ROWS, _GRAM_FLOATS = 528, 64, 2**24


def nmf_update(F: torch.Tensor, numer: torch.Tensor, other: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """T33: ``F ⊙ numer ⊘ (F·OᵀO + αF + ε)`` for F and ``numer`` (rows, k)
    and the other factor O = ``other`` (other_rows, k); a new tensor. With
    F = Hᵀ, O = W it is the reference's H update, transposed; with F = W,
    O = Hᵀ its W update."""
    if not on_card(F):
        return nmf_update_plain(F, numer, other, alpha)
    return _nmf_launch(F, numer, other, alpha)[0]


def _nmf_launch(F, numer, other, alpha, events=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """T33's launch on the card: returns the update and the Gram OᵀO it
    formed (its scratch). ``events``: None, or four ``torch.cuda.Event``s
    (each recorded once already, so that it exists), which T33 records
    before its Gram, its fold and its update and after the update."""
    if F.dim() != 2 or other.dim() != 2 or other.shape[1] != F.shape[1]:
        raise ValueError(f"F (rows, k) and other (other_rows, k) must share k, got "
                         f"{tuple(F.shape)} and {tuple(other.shape)}")
    rows, k = F.shape
    r_o = other.shape[0]
    for name, t, shape in (("F", F, (rows, k)), ("numer", numer, (rows, k)),
                           ("other", other, (r_o, k))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != F.device:
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor beside F, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if max(rows, r_o) > 2**31 - 1:
        raise ValueError(f"{max(rows, r_o)} rows exceed the int32 range")
    n_chunks = min(_GRAM_CHUNKS, -(-r_o // _GRAM_ROWS), max(1, _GRAM_FLOATS // (k * k)))
    chunk = -(-r_o // n_chunks) if n_chunks else 0
    part = torch.empty((n_chunks, k, k), dtype=torch.float32, device=F.device)
    G = torch.empty((k, k), dtype=torch.float32, device=F.device)
    out = torch.empty_like(F)
    marks = None if events is None else (ctypes.c_void_p * 4)(*(e.cuda_event for e in events))
    _kernels.launch("nmf_update", F.device, F.data_ptr(), numer.data_ptr(), other.data_ptr(),
                    rows, r_o, k, float(alpha), chunk, n_chunks, part.data_ptr(),
                    G.data_ptr(), out.data_ptr(), marks)
    return out, G


def nmf_update_plain(F, numer, other, alpha):
    return F * numer / (F @ (other.T @ other) + alpha * F + _EPS)


def nmf_factors(X, XT, W: torch.Tensor, Ht: torch.Tensor,
                alpha: float, max_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``max_iter`` updates of ``W (m, k)`` and ``Ht`` = Hᵀ ``(n, k)``
    against X, given as its CSR ``X`` (m, n) and that of its transpose
    ``XT`` (n, m), all on one device: ``PiecedCSR``s (``dsp.pieced``,
    ``dsp.transpose``), or ``DeviceCSR``s whose piece tables each product
    then builds. Returns the new ``(W, Ht)``."""
    for _ in range(int(max_iter)):
        with stage("scopen/products"):
            XtW = dsp.spmm_split(XT, W)
        with stage("scopen/update"):
            Ht = nmf_update(Ht, XtW, W, alpha)
        with stage("scopen/products"):
            XHt = dsp.spmm_split(X, Ht)
        with stage("scopen/update"):
            W = nmf_update(W, XHt, Ht, alpha)
    return W, Ht


def _csr_of_dense(T: torch.Tensor) -> DeviceCSR:
    """The nonzero entries of the 2-D float32 ``T`` as CSR on its device."""
    m, n = T.shape
    nz = torch.nonzero(T)
    dsp._check_size(m, n, nz.shape[0])
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=T.device)
    torch.cumsum(torch.bincount(nz[:, 0], minlength=m), 0, out=indptr[1:])
    return DeviceCSR(T[nz[:, 0], nz[:, 1]].contiguous(), indptr.to(torch.int32),
                     nz[:, 1].to(torch.int32).contiguous(), m, n, nz.shape[0])


def _starts(X, k: int, seed: int, W0, H0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's starts W (m, k) and H (k, n), scale·|N(0, 1)| at scale
    √(mean(X)/k), drawn from a torch.Generator, or ``W0``/``H0`` where
    given; returns ``(W, Hᵀ)``."""
    m, n = X.shape
    dev = X.device
    if W0 is None or H0 is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        mean = (dsp._csr(X).data.double().sum() / (m * n)).float()
        scale = torch.sqrt(mean / k)
        W = scale * torch.abs(torch.randn((m, k), generator=gen, device=dev))
        H = scale * torch.abs(torch.randn((k, n), generator=gen, device=dev))
    if W0 is not None:
        W = dense_to_tensor(W0, dev)
    if H0 is not None:
        H = dense_to_tensor(H0, dev)
    if tuple(W.shape) != (m, k) or tuple(H.shape) != (k, n):
        raise ValueError(f"W0 must be {(m, k)} and H0 {(k, n)}, got {tuple(W.shape)} and "
                         f"{tuple(H.shape)}")
    return W, H.T.contiguous()


def nmf(X, n_components: int, alpha: float = 1.0, max_iter: int = 500, seed: int = 0,
        W0=None, H0=None, device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Factorise the dense X (m, n) ≈ W·H (all non-negative) with L2
    regularisation; X goes to the device as CSR of its nonzero entries.
    Returns ``(W (m, k), H (k, n))`` as float32 numpy arrays."""
    Xc = _csr_of_dense(dense_to_tensor(X, device))
    W, Ht = _starts(Xc, int(n_components), seed, W0, H0)
    W, Ht = nmf_factors(dsp.pieced(Xc), dsp.transpose(Xc), W, Ht, float(alpha), max_iter)
    return W.cpu().numpy(), np.ascontiguousarray(Ht.cpu().numpy().T)


def _binary_cells_by_peaks(X, dev: torch.device) -> DeviceCSR:
    """``np.greater(X, 0)`` as float32 CSR (cells, peaks) on ``dev``, holding
    only the ones: a sparse X has its duplicates summed first (as
    ``todense`` does); a dense X is uploaded and its positive entries kept."""
    from scipy import sparse as sp

    if not sp.issparse(X):
        T = dense_to_tensor(np.asarray(X), dev)
        return _csr_of_dense((T > 0).to(torch.float32))
    X = X.tocsr()
    if not X.has_canonical_format:
        X = X.copy()
        X.sum_duplicates()
    B = sp.csr_matrix(((X.data > 0).astype(np.float32), X.indices.copy(), X.indptr.copy()),
                      shape=X.shape)
    B.eliminate_zeros()
    return dsp.from_scipy(B, dev)


def scopen_operands(X, min_rho: float = 0.0, max_rho: float = 0.5,
                    device: DeviceLike = None) -> Tuple[dsp.PiecedCSR, dsp.PiecedCSR]:
    """scOpen's input to its NMF from the (cells × peaks) counts X: Xᵀ
    binarised, each cell (column) scaled by 1/(1 − ρ), ρ its dropout rate
    between ``min_rho`` and ``max_rho`` from log10 of its open peaks. Returns
    its CSR (peaks × cells) and that of its transpose (cells × peaks), each
    with the piece table of its products (``dsp.PiecedCSR``), built once."""
    dev = resolve_device(device)
    XT = _binary_cells_by_peaks(X, dev)
    counts = dsp.row_sums(XT).cpu().numpy()
    # the reference's host arithmetic, in its float32 (NumPy 2 keeps the
    # Python floats weak): the counts are exact integers on both sides
    n_open = np.log10(np.maximum(counts, 1.0))
    hi, lo = n_open.max(), n_open.min()
    denom = (hi - lo) if hi > lo else 1.0
    rho = min_rho + (max_rho - min_rho) * (hi - n_open) / denom
    scale = torch.from_numpy(np.asarray(1.0 / (1.0 - rho), dtype=np.float32)).to(dev)
    XT = XT._replace(data=dsp.scale_rows_data(XT, scale))
    return dsp.transpose(XT), dsp.pieced(XT)


def scopen_impute(
    adata,
    n_components: int = 30,
    max_iter: int = 500,
    min_rho: float = 0.0,
    max_rho: float = 0.5,
    alpha: float = 1.0,
    verbose: bool = False,
    *,
    W0=None,
    H0=None,
    device: DeviceLike = None,
):
    """scOpen (Li et al. 2019) imputation of binarised peak counts (the
    reference's ``scopen_impute``): binarise Xᵀ (peaks × cells), scale each
    cell by 1/(1 − ρ), ρ its dropout rate between ``min_rho`` and ``max_rho``
    from log10 of its open peaks, factorise, and clip W·H to [0, 1]. Writes
    ``obsm["X_scopen"]`` (Hᵀ), ``varm["scopen"]`` (W) and replaces X by the
    dense imputed (cells × peaks) matrix, float32 numpy.

    X goes to the device as CSR and is factorised there; only the factors
    and the imputed matrix come back. ``W0`` and ``H0`` give the starts
    (else drawn as ``nmf`` draws them with seed 0)."""
    dev = resolve_device(device)
    with stage("scopen/build"):
        X, XT = scopen_operands(adata.X, min_rho, max_rho, dev)
        W, Ht = _starts(X, int(n_components), 0, W0, H0)
    if verbose:
        print(f"Number of peaks: {X.shape[0]}\nNumber of cells: {X.shape[1]}")
    W, Ht = nmf_factors(X, XT, W, Ht, float(alpha), max_iter)
    del X, XT
    with stage("scopen/impute"):
        M = torch.matmul(W, Ht.T).clamp_(0.0, 1.0)
    with stage("scopen/download"):
        adata.obsm["X_scopen"] = Ht.cpu().numpy()
        adata.varm["scopen"] = W.cpu().numpy()
        adata.X = M.cpu().numpy().T
    return None
