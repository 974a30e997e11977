"""Sparse count matrices on a CUDA device (counterpart of muon_tpu/ops/sparse.py).

The JAX package keeps a padded, row-sorted COO because XLA needs static
shapes. The port keeps plain CSR on the device, with no padding and no
sentinel rows:

    data    (nnz,)     float32
    indptr  (n+1,)     int32
    indices (nnz,)     int32   column ids; need not be sorted within a row

Each product over it has a hand-written CUDA kernel (``csrc/sparse_kernels.cu``)
and a plain PyTorch version of the same arithmetic beside it. A wrapper runs
the plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises.

    tfidf_data    T1  <- _tfidf_fn
    spmm          T2  <- _spmm_fn, transpose=False
    spmm_split    T2, its rows cut into pieces <- the products of nmf._nmf_fn
    spmm_t        T3  <- _spmm_fn, transpose=True
    gram_matmul   T4  <- the XtX.V product of linalg._rsvd_blocks_fn
    row_sums      T7  <- _row_sums_fn
    scale_rows_data  T8  <- _scale_rows_fn
    col_sums      torch (``index_add_``) <- _col_sums_fn

``_binarize_fn``, ``_decode_wire_fn`` and ``_ingest_block_fn`` are not
ported yet (ROADMAP, kernels to port: K19).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from scipy import sparse as sp

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, resolve_device

__all__ = [
    "DeviceCSR",
    "from_scipy",
    "from_device_coo",
    "to_scipy_data",
    "tfidf_data",
    "spmm",
    "spmm_t",
    "spmm_split",
    "gram_matmul",
    "row_sums",
    "scale_rows_data",
    "col_sums",
    "tfidf_data_plain",
    "spmm_plain",
    "spmm_t_plain",
    "spmm_split_plain",
    "gram_matmul_plain",
    "row_sums_plain",
    "scale_rows_data_plain",
]

_INT32_MAX = np.iinfo(np.int32).max
# entries per step of the plain products: bounds the (chunk, l) gather
_PLAIN_CHUNK = 1 << 22
_PIECE = 256  # stored entries a warp of spmm_split sums at most


class DeviceCSR(NamedTuple):
    """Device-resident CSR matrix."""

    data: torch.Tensor     # (nnz,) float32
    indptr: torch.Tensor   # (n_rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def device(self) -> torch.device:
        return self.data.device


def _check_size(n: int, d: int, nnz: int) -> None:
    if max(n, d, nnz) > _INT32_MAX:
        raise ValueError(
            f"shape ({n}, {d}) with {nnz} nonzeros exceeds the int32 index range"
        )


def from_scipy(X, device: DeviceLike = None) -> DeviceCSR:
    """Upload a scipy sparse matrix as float32 CSR. The caller's matrix is
    not modified (no index sorting; the kernels do not need it)."""
    device = resolve_device(device)
    with stage("sparse/from_scipy"):
        X = X.tocsr()
        n, d = X.shape
        nnz = int(X.indptr[-1])
        _check_size(n, d, nnz)
        to = lambda a, dt: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, dtype=dt)
        ).to(device)
        return DeviceCSR(
            to(X.data[:nnz], np.float32),
            to(X.indptr, np.int32),
            to(X.indices[:nnz], np.int32),
            n, d, nnz,
        )


def from_device_coo(
    data, row, col, n_rows: int, n_cols: int, nnz: int,
    device: DeviceLike = None,
) -> DeviceCSR:
    """Carry a JAX ``DeviceCOO`` across: take the numpy arrays of its
    ``data``/``row``/``col`` (padded), drop the pad tail at index >= ``nnz``,
    and return the same matrix as CSR."""
    device = resolve_device(device)
    _check_size(n_rows, n_cols, nnz)
    data = np.asarray(data)[:nnz].astype(np.float32)
    row = np.asarray(row)[:nnz].astype(np.int64)
    col = np.asarray(col)[:nnz].astype(np.int32)
    if nnz and ((row < 0).any() or (row >= n_rows).any()
                or (col < 0).any() or (col >= n_cols).any()):
        raise ValueError("COO entry outside the matrix before index nnz")
    if (np.diff(row) < 0).any():
        raise ValueError("COO rows must be sorted (row-major order)")
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(row, minlength=n_rows), out=indptr[1:])
    return DeviceCSR(
        torch.from_numpy(data).to(device),
        torch.from_numpy(indptr.astype(np.int32)).to(device),
        torch.from_numpy(col).to(device),
        n_rows, n_cols, nnz,
    )


def to_scipy_data(X_csr, new_data: torch.Tensor) -> sp.csr_matrix:
    """A copy of scipy CSR ``X_csr`` with its values replaced by
    ``new_data`` (downloaded now). For structure-preserving transforms."""
    with stage("sparse/to_scipy"):
        out = X_csr.copy()
        out.data = new_data.detach().cpu().numpy()[: X_csr.nnz]
        return out


# ---------------------------------------------------------------------------
# kernel wrappers: plain version on the CPU, CUDA kernel on a CUDA device
# ---------------------------------------------------------------------------


def _on(X: DeviceCSR, *dense: torch.Tensor) -> str:
    """The device type every operand lies on; raises on a mix."""
    kinds = {X.data.device, X.indptr.device, X.indices.device}
    kinds.update(t.device for t in dense)
    if len(kinds) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, kinds))}")
    kind = next(iter(kinds)).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind}")
    return kind


def _check_csr(X: DeviceCSR) -> None:
    """What the CUDA kernels take; raises on anything else."""
    _check_size(X.n_rows, X.n_cols, X.nnz)
    for name, t, dt, size in (
        ("data", X.data, torch.float32, X.nnz),
        ("indptr", X.indptr, torch.int32, X.n_rows + 1),
        ("indices", X.indices, torch.int32, X.nnz),
    ):
        if t.dtype != dt:
            raise TypeError(f"X.{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1 or t.numel() != size:
            raise ValueError(f"X.{name} must have shape ({size},), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"X.{name} must be contiguous")


def _check_dense(name: str, B: torch.Tensor, rows: int, dtypes) -> None:
    if B.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {B.dtype}")
    if B.dim() != 2 or B.shape[0] != rows:
        raise ValueError(f"{name} must have shape ({rows}, l), got {tuple(B.shape)}")
    if not B.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tfidf_data(
    X: DeviceCSR,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    scale_factor: Optional[float] = 1e4,
) -> torch.Tensor:
    """T1: fused TF-IDF of the value vector (semantics of muon_tpu
    ``tfidf_data`` and of reference muon/_atac/preproc.py:85-119).
    Returns the new ``(nnz,)`` float32 values."""
    if _on(X) == "cpu":
        return tfidf_data_plain(X, log_tf, log_idf, log_tfidf, scale_factor)
    _check_csr(X)
    out = torch.empty_like(X.data)
    cs = torch.zeros(X.n_cols, dtype=torch.float32, device=X.device)
    apply, scale = _scale(scale_factor)
    _kernels.launch(
        "tfidf_values", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), X.n_rows, X.nnz,
        cs.data_ptr(), int(log_tf), int(log_idf), int(log_tfidf), int(apply),
        scale, out.data_ptr(),
    )
    return out


def _scale(scale_factor) -> Tuple[bool, float]:
    """The reference scales tf only when the factor is set and not 0 or 1."""
    if scale_factor is None or float(scale_factor) in (0.0, 1.0):
        return False, 1.0
    return True, float(scale_factor)


def spmm(X: DeviceCSR, B: torch.Tensor) -> torch.Tensor:
    """T2: X @ B for B ``(n_cols, l)`` float32 or bfloat16; float32
    ``(n_rows, l)`` result, products and sums in float32."""
    if _on(X, B) == "cpu":
        return spmm_plain(X, B)
    _check_csr(X)
    _check_dense("B", B, X.n_cols, (torch.float32, torch.bfloat16))
    out = torch.empty((X.n_rows, B.shape[1]), dtype=torch.float32, device=X.device)
    bf16 = B.dtype == torch.bfloat16
    _kernels.launch(
        "csr_spmm_bf16" if bf16 else "csr_spmm_f32", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), B.data_ptr(), int(bf16),
        X.n_rows, B.shape[1], out.data_ptr(),
    )
    return out


def spmm_split(X: DeviceCSR, B: torch.Tensor) -> torch.Tensor:
    """T2's split variant: X @ B for a float32 B ``(n_cols, l)``, each row's
    stored entries cut into pieces of at most 256, a warp a piece, and a
    row's pieces added in order, so rows of very different lengths share the
    card evenly. Float32 ``(n_rows, l)`` result; no atomics."""
    if _on(X, B) == "cpu":
        return spmm_split_plain(X, B)
    _check_csr(X)
    _check_dense("B", B, X.n_cols, (torch.float32,))
    pieces = torch.clamp((X.indptr[1:] - X.indptr[:-1] + _PIECE - 1) // _PIECE, min=1)
    row_first = torch.zeros(X.n_rows + 1, dtype=torch.int32, device=X.device)
    torch.cumsum(pieces, 0, dtype=torch.int32, out=row_first[1:])
    max_pieces = X.n_rows + -(-X.nnz // _PIECE)
    part = torch.empty((max_pieces, B.shape[1]), dtype=torch.float32, device=X.device)
    out = torch.empty((X.n_rows, B.shape[1]), dtype=torch.float32, device=X.device)
    _kernels.launch(
        "csr_spmm_split", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), B.data_ptr(),
        row_first.data_ptr(), X.n_rows, max_pieces, B.shape[1], _PIECE, part.data_ptr(),
        out.data_ptr(),
    )
    return out


def spmm_t(X: DeviceCSR, B: torch.Tensor) -> torch.Tensor:
    """T3: Xᵀ @ B for B ``(n_rows, l)`` float32 or bfloat16; float32
    ``(n_cols, l)`` result. The kernel adds with atomics, so the order of
    each sum changes from run to run."""
    if _on(X, B) == "cpu":
        return spmm_t_plain(X, B)
    _check_csr(X)
    _check_dense("B", B, X.n_rows, (torch.float32, torch.bfloat16))
    out = torch.zeros((X.n_cols, B.shape[1]), dtype=torch.float32, device=X.device)
    bf16 = B.dtype == torch.bfloat16
    _kernels.launch(
        "csr_spmm_t_bf16" if bf16 else "csr_spmm_t_f32", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), B.data_ptr(), int(bf16),
        X.n_rows, B.shape[1], out.data_ptr(),
    )
    return out


def gram_matmul(X: DeviceCSR, V: torch.Tensor) -> torch.Tensor:
    """T4: XᵀX @ V for V ``(n_cols, l)``, with the rounding points of the
    reference's XᵀX power iteration: X and V rounded to bfloat16,
    z = X·V summed in float32 then rounded to bfloat16, XᵀZ summed in
    float32."""
    if _on(X, V) == "cpu":
        return gram_matmul_plain(X, V)
    _check_csr(X)
    _check_dense("V", V, X.n_cols, (torch.float32, torch.bfloat16))
    Vh = V.to(torch.bfloat16).contiguous()
    acc = torch.zeros((X.n_cols, V.shape[1]), dtype=torch.float32, device=X.device)
    _kernels.launch(
        "csr_gram_matmul", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), Vh.data_ptr(),
        X.n_rows, V.shape[1], acc.data_ptr(),
    )
    return acc


def row_sums(X: DeviceCSR) -> torch.Tensor:
    """T7: the ``(n_rows,)`` float32 sums of each row's values (0 for an
    empty row)."""
    if _on(X) == "cpu":
        return row_sums_plain(X)
    _check_csr(X)
    out = torch.empty(X.n_rows, dtype=torch.float32, device=X.device)
    _kernels.launch(
        "csr_row_sums", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.n_rows, out.data_ptr(),
    )
    return out


def scale_rows_data(X: DeviceCSR, row_scale: torch.Tensor) -> torch.Tensor:
    """T8: the ``(nnz,)`` float32 values of diag(row_scale)·X, each value
    times its row's factor."""
    if _on(X, row_scale) == "cpu":
        return scale_rows_data_plain(X, row_scale)
    _check_csr(X)
    if row_scale.dtype != torch.float32:
        raise TypeError(f"row_scale must be torch.float32, got {row_scale.dtype}")
    if tuple(row_scale.shape) != (X.n_rows,) or not row_scale.is_contiguous():
        raise ValueError(
            f"row_scale must be contiguous with shape ({X.n_rows},), "
            f"got {tuple(row_scale.shape)}"
        )
    out = torch.empty_like(X.data)
    _kernels.launch(
        "csr_scale_rows", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), row_scale.data_ptr(), X.n_rows,
        out.data_ptr(),
    )
    return out


def col_sums(X: DeviceCSR) -> torch.Tensor:
    """The ``(n_cols,)`` float32 sums of each column's values, by
    ``index_add_`` on X's device (the reference's segment sum over the
    column ids). On a CUDA device the adds are atomic, so the last bits can
    differ from run to run."""
    _check_csr(X)
    out = torch.zeros(X.n_cols, dtype=torch.float32, device=X.device)
    return out.index_add_(0, X.indices.long(), X.data)


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def _row_ids(X: DeviceCSR) -> torch.Tensor:
    counts = (X.indptr[1:] - X.indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(X.n_rows, device=X.device), counts, output_size=X.nnz
    )


def tfidf_data_plain(
    X: DeviceCSR,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    scale_factor: Optional[float] = 1e4,
) -> torch.Tensor:
    row, col = _row_ids(X), X.indices.long()
    rs = torch.zeros(X.n_rows, dtype=torch.float32, device=X.device)
    rs.index_add_(0, row, X.data)
    cs = torch.zeros(X.n_cols, dtype=torch.float32, device=X.device)
    cs.index_add_(0, col, X.data)
    tf = X.data / rs[row]
    tf = torch.where(torch.isfinite(tf), tf, 0.0)
    apply, scale = _scale(scale_factor)
    if apply:
        tf = tf * scale
    if log_tf:
        tf = torch.log1p(tf)
    idf = X.n_rows / cs
    if log_idf:
        idf = torch.log1p(idf)
    out = tf * idf[col]
    if log_tfidf:
        out = torch.log1p(out)
    return torch.where(torch.isfinite(out), out, 0.0)


def _scatter_products(out, seg, gat, data, B) -> torch.Tensor:
    """out[seg[e]] += data[e] * B[gat[e]] over all entries e, in chunks."""
    for s in range(0, data.numel(), _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        out.index_add_(0, seg[s:e], data[s:e, None] * B[gat[s:e]])
    return out


def spmm_plain(X: DeviceCSR, B: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((X.n_rows, B.shape[1]), dtype=torch.float32, device=X.device)
    return _scatter_products(out, _row_ids(X), X.indices.long(), X.data, B.float())


def spmm_split_plain(X: DeviceCSR, B: torch.Tensor) -> torch.Tensor:
    """X @ B summed in float64, then rounded to float32."""
    out = torch.zeros((X.n_rows, B.shape[1]), dtype=torch.float64, device=X.device)
    return _scatter_products(out, _row_ids(X), X.indices.long(), X.data.double(),
                             B.double()).float()


def spmm_t_plain(X: DeviceCSR, B: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((X.n_cols, B.shape[1]), dtype=torch.float32, device=X.device)
    return _scatter_products(out, X.indices.long(), _row_ids(X), X.data, B.float())


def gram_matmul_plain(X: DeviceCSR, V: torch.Tensor) -> torch.Tensor:
    Xh = X._replace(data=X.data.to(torch.bfloat16).float())
    z = spmm_plain(Xh, V.to(torch.bfloat16))
    return spmm_t_plain(Xh, z.to(torch.bfloat16))


def row_sums_plain(X: DeviceCSR) -> torch.Tensor:
    out = torch.zeros(X.n_rows, dtype=torch.float32, device=X.device)
    return out.index_add_(0, _row_ids(X), X.data)


def scale_rows_data_plain(X: DeviceCSR, row_scale: torch.Tensor) -> torch.Tensor:
    return X.data * row_scale.float()[_row_ids(X)]
