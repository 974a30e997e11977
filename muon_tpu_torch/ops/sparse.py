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

    tfidf_data    T1  <- _tfidf_fn; with given column sums (its values mode)
                      <- the body of parallel/pipeline.py _tfidf_fn
    tfidf_col_sums  T1's sums-only mode <- the body of parallel/pipeline.py
                      _colsums_fn
    spmm          T2  <- _spmm_fn, transpose=False
    spmm_split    T2, its rows cut into pieces <- the products of nmf._nmf_fn
    spmm_t        T3  <- _spmm_fn, transpose=True, as a gather over the CSR
                      of Xᵀ (``transpose``, built once per matrix)
    gram_matmul   T4  <- the XtX.V product of linalg._rsvd_blocks_fn
    row_sums      T7  <- _row_sums_fn
    scale_rows_data  T8  <- _scale_rows_fn
    wire_decode   T38 <- _ingest_block_fn (a block at an offset), _decode_wire_fn
    binarize_data T39 <- _binarize_fn
    col_sums      torch (``index_add_``) <- _col_sums_fn

The out-of-core ingest (``from_backed``) streams an on-disk CSR
(``BackedMatrix``) to the device block by block, each block narrowed on the
host to the reference's wire types and decoded by T38; the result hangs on
the ``BackedMatrix`` under the residency tag ``_muon_tpu_torch_device``, as
the reference hangs ``_muon_tpu_device``. A ``DeviceBackedCSR`` keeps the
structure on disk and new values on the device (TF-IDF of a backed X). The
in-memory ``from_scipy`` uploads float32/int32 CSR as it is and tags nothing.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from scipy import sparse as sp

from .._core.anndata import BackedMatrix
from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, on_card, resolve_device

__all__ = [
    "DeviceCSR",
    "DeviceBackedCSR",
    "DEVICE_TAG",
    "from_scipy",
    "from_backed",
    "from_device_coo",
    "to_scipy_data",
    "wire_types",
    "wire_decode",
    "decode_wire",
    "binarize_data",
    "with_col_perm",
    "TransposedCSR",
    "transpose",
    "tfidf_data",
    "tfidf_col_sums",
    "spmm",
    "spmm_t",
    "spmm_split",
    "gram_matmul",
    "row_sums",
    "scale_rows_data",
    "col_sums",
    "tfidf_data_plain",
    "tfidf_col_sums_plain",
    "spmm_plain",
    "spmm_t_plain",
    "spmm_split_plain",
    "gram_matmul_plain",
    "row_sums_plain",
    "scale_rows_data_plain",
    "wire_decode_plain",
    "binarize_data_plain",
]

_INT32_MAX = np.iinfo(np.int32).max
# entries per step of the plain products: bounds the (chunk, l) gather
_PLAIN_CHUNK = 1 << 22
_PIECE = 256  # stored entries a warp of spmm_split and of spmm_t sums at most


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
# the out-of-core ingest (counterpart of from_backed, DeviceBackedCSR)
# ---------------------------------------------------------------------------

DEVICE_TAG = "_muon_tpu_torch_device"
_INT16_MAX = int(np.iinfo(np.int16).max)
# wire value type -> the kind T38 takes; column ids come as int16 or int32
_WIRE_VALUES = {torch.uint8: 0, torch.uint16: 1, torch.float32: 2}
_WIRE_COLS = (torch.int16, torch.int32)
_TORCH_WIRE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.uint16,
               np.dtype(np.float32): torch.float32, np.dtype(np.int16): torch.int16,
               np.dtype(np.int32): torch.int32}


def _col_type(n_cols: int) -> np.dtype:
    return np.dtype(np.int16 if n_cols < _INT16_MAX else np.int32)


def wire_types(values: np.ndarray, n_cols: int) -> Tuple[np.dtype, np.dtype]:
    """The reference's wire types of one block: values as uint8 when they
    are integral, >= 0 and below 255, as uint16 below 65535, else float32;
    column ids as int16 when ``n_cols`` < 32767, else int32."""
    col = _col_type(n_cols)
    if values.size == 0:
        return np.dtype(np.uint8 if values.dtype.kind in "iu" else np.float32), col
    lo, hi = values.min(), values.max()
    if not lo >= 0 or not hi < 65535:  # negative, NaN or too large
        return np.dtype(np.float32), col
    wt = np.dtype(np.uint8 if hi < 255 else np.uint16)
    if values.dtype.kind in "iu" or np.array_equal(values.astype(wt), values):
        return wt, col
    return np.dtype(np.float32), col


def _row_blocks(indptr: np.ndarray, block_nnz: int):
    """Row blocks of about ``block_nnz`` entries each, cut as the reference
    cuts them: a block ends at the first row boundary at or past its start
    plus ``block_nnz``, and holds at least one row."""
    n = len(indptr) - 1
    blocks, r0 = [], 0
    while r0 < n:
        r1 = int(np.searchsorted(indptr, indptr[r0] + block_nnz, side="left"))
        r1 = min(max(r1, r0 + 1), n)
        blocks.append((r0, r1))
        r0 = r1
    return blocks


class _Staging:
    """One pinned host buffer for a block's wire values and column ids, its
    device twin, and the event after the last decode that read the twin."""

    def __init__(self, cap: int, col: np.dtype, device: torch.device):
        self.host_val = torch.empty(cap * 4, dtype=torch.uint8, pin_memory=True)
        self.host_col = torch.empty(cap * col.itemsize, dtype=torch.uint8, pin_memory=True)
        self.dev_val = torch.empty_like(self.host_val, device=device)
        self.dev_col = torch.empty_like(self.host_col, device=device)
        self.done = torch.cuda.Event()
        self.done.record()

    def fill(self, values, cols, n_cols: int):
        """Narrow the block into the pinned buffer, copy it to the twin
        (asynchronous) and return the twin's typed views."""
        with stage("backed/narrow(host)"):
            vt, ct = wire_types(values, n_cols)
            nv, nc = len(values) * vt.itemsize, len(cols) * ct.itemsize
            self.host_val[:nv].numpy().view(vt)[:] = values
            self.host_col[:nc].numpy().view(ct)[:] = cols
        with stage("backed/copy"):
            self.dev_val[:nv].copy_(self.host_val[:nv], non_blocking=True)
            self.dev_col[:nc].copy_(self.host_col[:nc], non_blocking=True)
        return self.dev_val[:nv].view(_TORCH_WIRE[vt]), self.dev_col[:nc].view(_TORCH_WIRE[ct])


def from_backed(bm, block_nnz: int = 16 << 20, device: DeviceLike = None) -> DeviceCSR:
    """Stream an on-disk CSR (a sparse :class:`BackedMatrix`) to ``device`` as
    a :class:`DeviceCSR`, block by block: the host holds about one block
    (``block_nnz`` entries) of the file at a time, never the matrix.

    ``indptr`` goes up once, as the file has it. Each block's values and
    column ids are read, narrowed to their wire types (``wire_types``) and
    decoded into the preallocated ``data``/``indices`` at the block's offset
    by T38 (``wire_decode``); an empty block launches nothing. On a CUDA
    device the narrowed block goes through one of two pinned staging
    buffers, copied without blocking; a buffer is refilled only after the
    decode that read its device twin has finished, so reading block i+1
    overlaps the copy and decode of block i. Column ids keep the file's
    order within a row (the kernels do not need them sorted).

    The result is cached on ``bm`` under ``DEVICE_TAG`` and returned again
    for the same device type. A :class:`DeviceBackedCSR` returns its device
    values (its file holds other values)."""
    device = resolve_device(device)
    tag = getattr(bm, DEVICE_TAG, None)
    if isinstance(tag, DeviceCSR) and tag.shape == tuple(bm.shape):
        if tag.device.type == device.type:
            return tag
        if isinstance(bm, DeviceBackedCSR):
            raise ValueError(f"the values of X are on {tag.device}, device={device} was asked")
    if not getattr(bm, "_sparse", False):
        raise TypeError("from_backed expects a sparse (CSR group) BackedMatrix")
    h5 = bm._h5
    n, d = (int(x) for x in bm.shape)
    with stage("backed/indptr(host)"):
        indptr = np.asarray(h5["indptr"][...]).astype(np.int64)
    if indptr.shape != (n + 1,):
        raise ValueError(f"indptr has shape {indptr.shape}, expected ({n + 1},)")
    nnz = int(indptr[-1])
    _check_size(n, d, nnz)
    out = DeviceCSR(
        torch.empty(nnz, dtype=torch.float32, device=device),
        torch.from_numpy(indptr.astype(np.int32)).to(device),
        torch.empty(nnz, dtype=torch.int32, device=device),
        n, d, nnz,
    )
    blocks = [(int(indptr[r0]), int(indptr[r1])) for r0, r1 in _row_blocks(indptr, block_nnz)]
    blocks = [(s, e) for s, e in blocks if e > s]
    if blocks:
        _ingest(h5["data"], h5["indices"], blocks, out)
    try:
        setattr(bm, DEVICE_TAG, out)
    except AttributeError:
        pass
    return out


def _ingest(d_ds, i_ds, blocks, out: DeviceCSR) -> None:
    """Read, narrow and decode the entry spans ``blocks`` into ``out``."""
    cuda = out.device.type == "cuda"
    with torch.cuda.device(out.device) if cuda else contextlib.nullcontext():
        staging = None
        if cuda:
            cap = max(e - s for s, e in blocks)
            with stage("backed/pin(host)"):
                staging = [_Staging(cap, _col_type(out.n_cols), out.device) for _ in range(2)]
        for b, (s, e) in enumerate(blocks):
            st = staging[b % 2] if cuda else None
            if cuda:
                st.done.synchronize()  # its last copy and decode are over
            with stage("backed/read(host)"):
                values, cols = np.asarray(d_ds[s:e]), np.asarray(i_ds[s:e])
            if cuda:
                val, col = st.fill(values, cols, out.n_cols)
            else:
                with stage("backed/narrow(host)"):
                    vt, ct = wire_types(values, out.n_cols)
                    val, col = torch.from_numpy(values.astype(vt)), torch.from_numpy(cols.astype(ct))
            with stage("backed/decode"):
                wire_decode(val, col, out.data, out.indices, s)
            if cuda:
                st.done.record()
        for st in staging or ():
            st.done.synchronize()  # no copy outlives its pinned buffer


def decode_wire(val: torch.Tensor, col: torch.Tensor, indptr: torch.Tensor,
                n_cols: int) -> DeviceCSR:
    """A whole matrix's wire at once as a :class:`DeviceCSR` on ``val``'s
    device (the counterpart of ``_decode_wire_fn``): T38 over all of it at
    offset 0, ``indptr`` (n+1) as the rows."""
    nnz, n = val.numel(), indptr.numel() - 1
    _check_size(n, n_cols, nnz)
    data = torch.empty(nnz, dtype=torch.float32, device=val.device)
    indices = torch.empty(nnz, dtype=torch.int32, device=val.device)
    wire_decode(val, col, data, indices, 0)
    return DeviceCSR(data, indptr.to(device=val.device, dtype=torch.int32).contiguous(),
                     indices, n, int(n_cols), nnz)


class DeviceBackedCSR(BackedMatrix):
    """A sparse matrix whose STRUCTURE lives on disk (the CSR group of a
    :class:`BackedMatrix`) and whose VALUES live on the device: what a
    structure-preserving transform (TF-IDF) of a backed X gives. Device ops
    re-enter through ``DEVICE_TAG`` with nothing on the host; ``to_memory``
    and row reads take the structure from disk and download only the values
    they need. The device values keep the file's entry order, so they pair
    with the file's ``indices`` as they are."""

    def __init__(self, h5group, dX: DeviceCSR):
        self._h5 = h5group
        self.shape = tuple(dX.shape)
        self.nnz = int(dX.nnz)
        self.dtype = np.dtype(np.float32)
        self._sparse = True
        self._indptr = None
        setattr(self, DEVICE_TAG, dX)

    def to_memory(self) -> sp.csr_matrix:
        vals = getattr(self, DEVICE_TAG).data.cpu().numpy()
        return sp.csr_matrix(
            (vals, self._h5["indices"][...], self._h5["indptr"][...]), shape=self.shape
        )

    def _row_values(self, oidx, starts, ends, total: int) -> np.ndarray:
        """The values of rows ``oidx`` by one device gather of their positions
        (their column ids are read from disk as a ``BackedMatrix`` reads them)."""
        counts = ends - starts
        pos = np.repeat(starts - (np.cumsum(counts) - counts), counts) + np.arange(total)
        data = getattr(self, DEVICE_TAG).data
        return data[torch.from_numpy(pos).to(data.device)].cpu().numpy()


def with_col_perm(X: DeviceCSR) -> torch.Tensor:
    """The ``(nnz,)`` int32 permutation that sorts X's stored entries by
    column id, stably (the reference's ``perm_bycol``, for transposed
    products in entry order)."""
    return torch.argsort(X.indices, stable=True).to(torch.int32)


class TransposedCSR(NamedTuple):
    """Xᵀ as CSR with T3's piece table over its rows. The table depends on
    the structure alone, so ``with_data`` keeps it for new values."""

    csr: DeviceCSR            # Xᵀ (n_cols, n_rows)
    row_first: torch.Tensor   # (n_cols + 1,) int32: each row's first piece
    n_pieces: int             # row_first[-1]

    def with_data(self, data: torch.Tensor) -> "TransposedCSR":
        return self._replace(csr=self.csr._replace(data=data))


def transpose(X: DeviceCSR) -> TransposedCSR:
    """Xᵀ as CSR on X's device: X's entries in the order of
    ``with_col_perm``, so each row of Xᵀ keeps X's row order; with the
    exclusive prefix sum of max(1, ⌈len / 256⌉) over its rows, the pieces T3
    cuts them into."""
    with stage("sparse/transpose"):
        counts = (X.indptr[1:] - X.indptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(X.n_rows, device=X.device, dtype=torch.int32), counts,
            output_size=X.nnz)
        order = with_col_perm(X)
        lens = torch.bincount(X.indices, minlength=X.n_cols)
        indptr = torch.zeros(X.n_cols + 1, dtype=torch.int64, device=X.device)
        torch.cumsum(lens, 0, out=indptr[1:])
        row_first = torch.zeros(X.n_cols + 1, dtype=torch.int64, device=X.device)
        torch.cumsum(torch.clamp((lens + _PIECE - 1) // _PIECE, min=1), 0, out=row_first[1:])
        Xt = DeviceCSR(X.data[order], indptr.to(torch.int32), rows[order],
                       X.n_cols, X.n_rows, X.nnz)
        return TransposedCSR(Xt, row_first.to(torch.int32), int(row_first[-1]))


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
    col_sums: Optional[torch.Tensor] = None,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """T1: fused TF-IDF of the value vector (semantics of muon_tpu
    ``tfidf_data`` and of reference muon/_atac/preproc.py:85-119).
    Returns the new ``(nnz,)`` float32 values.

    ``col_sums`` ``(n_cols,)`` float32 and ``n_total``: T1's values mode,
    the IDF from the column sums and row count of a whole matrix of which
    X is a row block (the sharded pipeline's); None sums X's own columns and
    counts its rows."""
    if _on(X, *(() if col_sums is None else (col_sums,))) == "cpu":
        return tfidf_data_plain(X, log_tf, log_idf, log_tfidf, scale_factor, col_sums,
                                n_total)
    _check_csr(X)
    out = torch.empty_like(X.data)
    apply, scale = _scale(scale_factor)
    if col_sums is None:
        name, mode, n = "tfidf_values", 0, X.n_rows
        cs = torch.zeros(X.n_cols, dtype=torch.float32, device=X.device)
    else:
        name, mode, n = "tfidf_values_global", 2, X.n_rows if n_total is None else n_total
        _check_dense("col_sums", col_sums[:, None], X.n_cols, (torch.float32,))
        cs = col_sums
    _kernels.launch(
        name, X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), X.n_rows, X.nnz,
        cs.data_ptr(), mode, float(n), int(log_tf), int(log_idf), int(log_tfidf),
        int(apply), scale, out.data_ptr(),
    )
    return out


def tfidf_col_sums(X: DeviceCSR) -> torch.Tensor:
    """T1's sums-only mode: the ``(n_cols,)`` float32 column sums of X (a
    row block's, which the sharded pipeline all-reduces). The kernel adds
    with atomics: integer counts below 2^24 sum exactly, other values in an
    order that changes from run to run."""
    if _on(X) == "cpu":
        return tfidf_col_sums_plain(X)
    _check_csr(X)
    cs = torch.zeros(X.n_cols, dtype=torch.float32, device=X.device)
    _kernels.launch(
        "tfidf_col_sums", X.device,
        X.data.data_ptr(), X.indptr.data_ptr(), X.indices.data_ptr(), X.n_rows, X.nnz,
        cs.data_ptr(), 1, float(X.n_rows), 0, 0, 0, 0, 1.0, 0,
    )
    return cs


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


def _check_transpose(X: DeviceCSR, Xt: TransposedCSR) -> None:
    if Xt.csr.shape != (X.n_cols, X.n_rows) or Xt.csr.nnz != X.nnz:
        raise ValueError(f"Xt of shape {Xt.csr.shape} with {Xt.csr.nnz} nonzeros is not "
                         f"the transpose of X, {X.shape} with {X.nnz}")
    if tuple(Xt.row_first.shape) != (X.n_cols + 1,):
        raise ValueError(f"Xt.row_first must have shape ({X.n_cols + 1},), got "
                         f"{tuple(Xt.row_first.shape)}")


def spmm_t(X: DeviceCSR, B: torch.Tensor, Xt: Optional[TransposedCSR] = None) -> torch.Tensor:
    """T3: Xᵀ @ B for B ``(n_rows, l)`` float32 or bfloat16; float32
    ``(n_cols, l)`` result. The kernel gathers over ``Xt``, the CSR of Xᵀ
    with its piece table (``transpose(X)``; built here when None, so a caller
    that multiplies one X several times builds it once and passes it). Its
    sums run in an order fixed by X's structure: the same bits every run."""
    if _on(X, B, *(() if Xt is None else (Xt.csr.data, Xt.row_first))) == "cpu":
        return spmm_t_plain(X, B, Xt)
    _check_csr(X)
    _check_dense("B", B, X.n_rows, (torch.float32, torch.bfloat16))
    if Xt is None:
        Xt = transpose(X)
    _check_transpose(X, Xt)
    T = Xt.csr
    _check_csr(T)
    if Xt.row_first.dtype != torch.int32 or not Xt.row_first.is_contiguous():
        raise TypeError("Xt.row_first must be contiguous int32")
    l = B.shape[1]
    part = torch.empty((Xt.n_pieces if Xt.n_pieces > T.n_rows else 1, l),
                       dtype=torch.float32, device=X.device)
    out = torch.empty((T.n_rows, l), dtype=torch.float32, device=X.device)
    bf16 = B.dtype == torch.bfloat16
    _kernels.launch(
        "csr_spmm_t_bf16" if bf16 else "csr_spmm_t_f32", X.device,
        T.data.data_ptr(), T.indptr.data_ptr(), T.indices.data_ptr(), Xt.row_first.data_ptr(),
        T.n_rows, Xt.n_pieces, _PIECE, B.data_ptr(), int(bf16), l, part.data_ptr(),
        out.data_ptr(),
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


def wire_decode(val: torch.Tensor, col: torch.Tensor, data: torch.Tensor,
                indices: torch.Tensor, offset: int) -> None:
    """T38, in place: ``data[offset:offset+bn] = float32(val)`` and
    ``indices[offset:offset+bn] = int32(col)`` for the ``bn`` entries of one
    block of the wire format (``val`` uint8, uint16 or float32; ``col``
    int16 or int32). Nothing is launched for an empty block."""
    kinds = {t.device for t in (val, col, data, indices)}
    if len(kinds) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, kinds))}")
    bn = val.numel()
    if not on_card(data):
        return wire_decode_plain(val, col, data, indices, offset)
    vk = _WIRE_VALUES.get(val.dtype)
    if vk is None or col.dtype not in _WIRE_COLS:
        raise TypeError(f"wire types must be uint8/uint16/float32 values and int16/int32 "
                        f"columns, got {val.dtype} and {col.dtype}")
    if data.dtype != torch.float32 or indices.dtype != torch.int32:
        raise TypeError(f"data must be float32 and indices int32, got {data.dtype}, "
                        f"{indices.dtype}")
    if val.dim() != 1 or col.shape != val.shape or data.shape != indices.shape:
        raise ValueError("val and col must be (bn,) and data and indices of one shape")
    if not all(t.is_contiguous() for t in (val, col, data, indices)):
        raise ValueError("wire_decode needs contiguous tensors")
    if offset < 0 or offset + bn > data.numel() or bn > _INT32_MAX:
        raise ValueError(f"a block of {bn} at {offset} does not fit {data.numel()} entries")
    if bn:
        _kernels.launch(
            "wire_decode", data.device,
            val.data_ptr(), vk, col.data_ptr(), int(col.dtype == torch.int16), bn, int(offset),
            data.data_ptr(), indices.data_ptr(),
        )


def binarize_data(X: DeviceCSR) -> torch.Tensor:
    """T39: the ``(nnz,)`` float32 values of X with every nonzero made 1 and
    every zero 0 (NaN counts as nonzero, as in the reference)."""
    if _on(X) == "cpu":
        return binarize_data_plain(X)
    _check_csr(X)
    out = torch.empty_like(X.data)
    if X.nnz:
        _kernels.launch("binarize_values", X.device, X.data.data_ptr(), X.nnz, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the card's reference in chip_smoke.py)
# ---------------------------------------------------------------------------


def _row_ids(X: DeviceCSR) -> torch.Tensor:
    counts = (X.indptr[1:] - X.indptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(X.n_rows, device=X.device), counts, output_size=X.nnz
    )


def tfidf_col_sums_plain(X: DeviceCSR) -> torch.Tensor:
    cs = torch.zeros(X.n_cols, dtype=torch.float32, device=X.device)
    return cs.index_add_(0, X.indices.long(), X.data)


def tfidf_data_plain(
    X: DeviceCSR,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    scale_factor: Optional[float] = 1e4,
    col_sums: Optional[torch.Tensor] = None,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    row, col = _row_ids(X), X.indices.long()
    rs = torch.zeros(X.n_rows, dtype=torch.float32, device=X.device)
    rs.index_add_(0, row, X.data)
    cs = tfidf_col_sums_plain(X) if col_sums is None else col_sums
    n = X.n_rows if col_sums is None or n_total is None else n_total
    tf = X.data / rs[row]
    tf = torch.where(torch.isfinite(tf), tf, 0.0)
    apply, scale = _scale(scale_factor)
    if apply:
        tf = tf * scale
    if log_tf:
        tf = torch.log1p(tf)
    idf = n / cs
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


def spmm_t_plain(X: DeviceCSR, B: torch.Tensor,
                 Xt: Optional[TransposedCSR] = None) -> torch.Tensor:
    """Xᵀ @ B: the gather over the rows of ``Xt`` when given, else a scatter
    over X's entries."""
    if Xt is not None:
        _check_transpose(X, Xt)
        return spmm_plain(Xt.csr, B)
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


def wire_decode_plain(val: torch.Tensor, col: torch.Tensor, data: torch.Tensor,
                      indices: torch.Tensor, offset: int) -> None:
    bn = val.numel()
    data[offset:offset + bn] = val.to(torch.float32)
    indices[offset:offset + bn] = col.to(torch.int32)


def binarize_data_plain(X: DeviceCSR) -> torch.Tensor:
    return (X.data != 0).to(X.data.dtype)
