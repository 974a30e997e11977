"""Dense normalisation on the device (counterpart of muon_tpu/ops/dense.py).

    clr_values   T12  <- _clr_dense_fn, and the inline seurat CLR of
                         muon_tpu/prot/preproc.py clr (csrc/dense_kernels.cu)

``clr_values`` takes the mean of log1p(X) along an axis in float32 and
returns one of the two forms the reference computes: ``logx − gm``
(``clr_dense``) or ``log1p(x / exp(gm))`` (``prot.pp.clr``'s seurat flavor
on a dense X). The wrapper runs the plain version for a tensor on the CPU;
for a CUDA tensor it launches T12 or raises.

``tfidf_dense`` and ``l2norm_dense`` are not ported yet (ROADMAP queue 1 item 5).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor

__all__ = ["clr_dense", "clr_values", "clr_values_plain"]

# rows per partial column sum of T12 on axis 0 (kTileRows in the source)
_TILE_ROWS = 256


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
    if X.device.type == "cpu":
        return clr_values_plain(X, axis, seurat)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    n, d = X.shape
    if max(n, d) > 2**31 - 1:
        raise ValueError(f"X of shape {(n, d)} exceeds the int32 range")
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
