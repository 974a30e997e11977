"""FastICA on the device (counterpart of muon_tpu/ops/ica.py).

    ica_contrast  T32  <- _fastica_fn (:24): the loop body's fixed-point
                          step, g = tanh(W·Xw), g·Xwᵀ/n − mean(g′)·W
                          (csrc/decomp_kernels.cu)

``fastica`` keeps the reference's host part as it is, so that both start
from the same point: X to float32 and centred, PCA whitening by
``np.linalg.svd`` of the d × d covariance, and ``W0`` from
``np.random.default_rng(random_state)``. On the device it runs the
reference's fixed ``max_iter`` symmetric sweeps in full (there is no
tolerance): T32, then the symmetric decorrelation (W·Wᵀ)^{-1/2}·W by
``torch.linalg.eigh`` with the eigenvalues clamped at 1e-12, which does not
depend on the order or signs of the eigenvectors.

``ica_contrast`` runs its plain version for tensors on the CPU; for CUDA
tensors it launches T32 or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, on_card, resolve_device

__all__ = ["fastica", "ica_contrast", "ica_contrast_plain", "pca_whiten", "sym_decorrelate"]

# T32's tile of W's rows (kTile in the source) and the blocks it aims for:
# 4 per SM of an H100 (132 SMs)
_TILE, _TARGET_BLOCKS = 32, 4 * 132


def _chunks(k: int, n: int):
    """T32's split of the n columns: enough chunks that the (tile, tile,
    chunk) grid fills the card, each a multiple of 32 columns."""
    tiles = -(-k // _TILE)
    n_chunks = max(1, min(-(-n // _TILE), -(-_TARGET_BLOCKS // (tiles * tiles))))
    chunk = -(-(-(-n // n_chunks)) // _TILE) * _TILE
    return chunk, -(-n // chunk)


def ica_contrast(Xw: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """T32: ``Xw (k, n)`` whitened float32 data and ``W (k, k)`` →
    ``tanh(W·Xw)·Xwᵀ / n − mean(1 − tanh²(W·Xw), axis=1)[:, None] · W``."""
    if not on_card(Xw):
        return ica_contrast_plain(Xw, W)
    k, n = Xw.shape
    for name, t, shape in (("Xw", Xw, (k, n)), ("W", W, (k, k))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous() \
                or t.device != Xw.device:
            raise ValueError(f"{name} must be a contiguous float32 {shape} tensor beside Xw, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if n > 2**31 - 1:
        raise ValueError(f"{n} columns exceed the int32 range")
    chunk, n_chunks = _chunks(k, n)
    part_a = torch.empty((n_chunks, k, k), dtype=torch.float32, device=Xw.device)
    part_b = torch.empty((n_chunks, k), dtype=torch.float32, device=Xw.device)
    W_new = torch.empty_like(W)
    _kernels.launch(
        "ica_contrast", Xw.device,
        Xw.data_ptr(), W.data_ptr(), k, n, chunk, n_chunks, part_a.data_ptr(),
        part_b.data_ptr(), W_new.data_ptr(),
    )
    return W_new


def ica_contrast_plain(Xw: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    g = torch.tanh(W @ Xw)
    g_prime = 1.0 - g * g
    return (g @ Xw.T) / Xw.shape[1] - g_prime.mean(dim=1)[:, None] * W


def sym_decorrelate(W: torch.Tensor) -> torch.Tensor:
    """(W·Wᵀ)^{-1/2}·W, the eigenvalues clamped at 1e-12 (the reference's)."""
    s, u = torch.linalg.eigh(W @ W.T)
    s = torch.clamp(s, min=1e-12)
    return (u * (1.0 / torch.sqrt(s))[None, :]) @ u.T @ W


def pca_whiten(X, n_components=None, random_state=None):
    """The reference's host part: X (n, d) to float32 and centred, whitened
    by ``np.linalg.svd`` of its d × d covariance to ``Xw (k, n)``, and the
    start ``W0 (k, k)`` from ``np.random.default_rng(random_state)``; k is
    ``n_components`` or min(n, d). Both float32 numpy arrays."""
    X = np.asarray(X, dtype=np.float32)
    n, d = X.shape
    k = n_components or min(n, d)
    Xc = (X - X.mean(axis=0)).T  # (d, n)
    U, s, _ = np.linalg.svd(Xc @ Xc.T / n)
    Kw = (U[:, :k] / np.sqrt(np.maximum(s[:k], 1e-12))[None, :]).T  # (k, d)
    W0 = np.random.default_rng(random_state).normal(size=(k, k)).astype(np.float32)
    return np.ascontiguousarray(Kw @ Xc, dtype=np.float32), W0


def fastica(X, n_components=None, random_state=None, max_iter: int = 200,
            whiten: bool = True, device: DeviceLike = None) -> np.ndarray:
    """Fit symmetric FastICA (logcosh contrast) and return the sources
    ``(n, k)`` float32, like sklearn's ``fit_transform``. ``whiten`` is
    taken and not read, as in the reference: the data are always whitened."""
    dev = resolve_device(device)
    with stage("ica/whiten"):
        Xw, W0 = pca_whiten(X, n_components, random_state)
        Xw = torch.from_numpy(Xw).to(dev)
        W = torch.from_numpy(W0).to(dev)
    with stage("ica/decorrelate"):
        W = sym_decorrelate(W)
    for _ in range(int(max_iter)):
        with stage("ica/contrast"):
            W = ica_contrast(Xw, W)
        with stage("ica/decorrelate"):
            W = sym_decorrelate(W)
    with stage("ica/download"):
        return (W @ Xw).T.cpu().numpy()

