"""Dense normalisation on the device (counterpart of muon_tpu/ops/dense.py).

    clr_values    T12  <- _clr_dense_fn, and the inline seurat CLR of
                          muon_tpu/prot/preproc.py clr (csrc/dense_kernels.cu)
    tfidf_dense   T34  <- _tfidf_dense_fn (:19)          (the same source)
    l2norm_dense  T35  <- _l2norm_fn (:48)                (the same source)

``clr_values`` takes the mean of log1p(X) along an axis in float32 and
returns one of the two forms the reference computes: ``logx − gm``
(``clr_dense``) or ``log1p(x / exp(gm))`` (``prot.pp.clr``'s seurat flavor
on a dense X). ``tfidf_dense`` is the reference's dense TF-IDF and
``l2norm_dense`` its rows to unit L2 norm, both in float32 (the public
``atac.pp.tfidf`` of a dense X and ``pp.l2norm`` compute on the host, in both
packages, and call neither). Each wrapper runs its plain version for a
tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor, on_card

__all__ = [
    "clr_dense",
    "clr_values",
    "clr_values_plain",
    "l2norm_dense",
    "l2norm_dense_plain",
    "tfidf_dense",
    "tfidf_dense_plain",
]

# rows per partial column sum of T12 on axis 0 (kTileRows in the source)
_TILE_ROWS = 256
# T34's sums tile: rows and columns (kSumRows, kSumCols in the source)
_SUM_ROWS, _SUM_COLS = 256, 256


def _check_dense(X: torch.Tensor) -> None:
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    if max(X.shape) > 2**31 - 1:
        raise ValueError(f"X of shape {tuple(X.shape)} exceeds the int32 range")


def _check_axis(axis: int) -> int:
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    return int(axis)


def clr_values(X: torch.Tensor, axis: int = 0,
               seurat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """T12: ``X (n, d)`` float32 → ``(out (n, d), gm)``, with gm the float32
    mean of log1p(X) along ``axis`` ((d,) for axis 0, (n,) for axis 1) and
    out = log1p(X) − gm, or log1p(X / exp(gm)) under ``seurat``."""
    axis = _check_axis(axis)
    if not on_card(X):
        return clr_values_plain(X, axis, seurat)
    _check_dense(X)
    n, d = X.shape
    out = torch.empty_like(X)
    gm = torch.empty(d if axis == 0 else n, dtype=torch.float32, device=X.device)
    n_tiles = -(-n // _TILE_ROWS) if axis == 0 else 0
    partial = torch.empty((max(n_tiles, 1), d), dtype=torch.float32, device=X.device)
    _kernels.launch(
        "clr_dense", X.device,
        X.data_ptr(), n, d, axis, int(bool(seurat)), partial.data_ptr(),
        gm.data_ptr(), out.data_ptr(),
    )
    return out, gm


def clr_values_plain(X: torch.Tensor, axis: int = 0,
                     seurat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    axis = _check_axis(axis)
    logx = torch.log1p(X)
    gm = logx.mean(dim=axis, keepdim=True)
    out = torch.log1p(X / torch.exp(gm)) if seurat else logx - gm
    return out, gm.reshape(-1)


def clr_dense(X, axis: int = 0, device: DeviceLike = None) -> torch.Tensor:
    """``log1p(X) − mean(log1p(X), axis)`` of a dense X (numpy or tensor),
    float32 on the device (the reference's ``clr_dense``)."""
    axis = _check_axis(axis)
    Xt = dense_to_tensor(X, device)
    with stage("dense/clr"):
        return clr_values(Xt, axis)[0]


def clr_seurat_dense(X, axis: int = 0, device: DeviceLike = None) -> np.ndarray:
    """The seurat CLR of a dense X, ``log1p(x / exp(mean(log1p x, axis)))``,
    computed in float32 on the device and returned as a host array of X's
    own dtype (the reference's dense branch of ``prot.pp.clr``)."""
    dtype = np.asarray(X).dtype
    Xt = dense_to_tensor(X, device)
    with stage("dense/clr"):
        out = clr_values(Xt, axis, seurat=True)[0]
    with stage("dense/download"):
        return np.asarray(out.cpu().numpy(), dtype=dtype)


def _tfidf_scale(scale_factor) -> Optional[float]:
    """The reference scales tf only by a factor that is given and not 0 or 1."""
    if scale_factor is None or float(scale_factor) in (0.0, 1.0):
        return None
    return float(scale_factor)


def tfidf_dense(X, log_tf: bool = True, log_idf: bool = True, log_tfidf: bool = False,
                scale_factor=1e4, device: DeviceLike = None) -> torch.Tensor:
    """T34: the reference's dense TF-IDF of X (n, d) (numpy or tensor), float32
    on the device. tf = X / row sums (non-finite to 0), × ``scale_factor``
    unless it is None, 0 or 1, log1p under ``log_tf``; idf = n / column sums,
    log1p under ``log_idf``; tf·idf, log1p under ``log_tfidf``; non-finite
    values to 0. Three launches (sums, their finish, values) count as one."""
    Xt = dense_to_tensor(X, device)
    if not on_card(Xt):
        return tfidf_dense_plain(Xt, log_tf, log_idf, log_tfidf, scale_factor)
    _check_dense(Xt)
    n, d = Xt.shape
    if -(-n // _SUM_ROWS) > 65535:
        raise ValueError(f"T34 takes at most {65535 * _SUM_ROWS} rows, got {n}")
    scale = _tfidf_scale(scale_factor)
    dev = Xt.device
    rowpart = torch.empty((-(-d // _SUM_COLS), n), dtype=torch.float32, device=dev)
    colpart = torch.empty((-(-n // _SUM_ROWS), d), dtype=torch.float32, device=dev)
    rs = torch.empty(n, dtype=torch.float32, device=dev)
    idf = torch.empty(d, dtype=torch.float32, device=dev)
    out = torch.empty_like(Xt)
    with stage("dense/tfidf"):
        _kernels.launch(
            "tfidf_dense", dev,
            Xt.data_ptr(), n, d, int(bool(log_tf)), int(bool(log_idf)),
            int(bool(log_tfidf)), int(scale is not None), 0.0 if scale is None else scale,
            rowpart.data_ptr(), colpart.data_ptr(), rs.data_ptr(), idf.data_ptr(),
            out.data_ptr(),
        )
    return out


def tfidf_dense_plain(X: torch.Tensor, log_tf: bool = True, log_idf: bool = True,
                      log_tfidf: bool = False, scale_factor=1e4) -> torch.Tensor:
    tf = X / X.sum(dim=1, keepdim=True)
    tf = torch.where(torch.isfinite(tf), tf, 0.0)
    scale = _tfidf_scale(scale_factor)
    if scale is not None:
        tf = tf * scale
    if log_tf:
        tf = torch.log1p(tf)
    idf = X.shape[0] / X.sum(dim=0, keepdim=True)
    if log_idf:
        idf = torch.log1p(idf)
    out = tf * idf
    if log_tfidf:
        out = torch.log1p(out)
    return torch.where(torch.isfinite(out), out, 0.0)


def l2norm_dense(X, device: DeviceLike = None) -> torch.Tensor:
    """T35: the rows of X (n, d) (numpy or tensor) over their L2 norms, a
    zero norm taken as 1, float32 on the device (the reference's
    ``l2norm_dense``)."""
    Xt = dense_to_tensor(X, device)
    if not on_card(Xt):
        return l2norm_dense_plain(Xt)
    _check_dense(Xt)
    n, d = Xt.shape
    out = torch.empty_like(Xt)
    with stage("dense/l2norm"):
        _kernels.launch("l2norm_dense", Xt.device, Xt.data_ptr(), n, d, out.data_ptr())
    return out


def l2norm_dense_plain(X: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt((X * X).sum(dim=1, keepdim=True))
    return X / torch.where(norms == 0, 1.0, norms)
