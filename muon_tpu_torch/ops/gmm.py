"""Batched 1-D Gaussian-mixture EM on the device (counterpart of
muon_tpu/ops/gmm.py).

    gmm_background_means  T21  <- _background_means_fn + _em_1d
                                  (csrc/gmm_kernels.cu)

DSB's per-cell background: for every cell, the 0.25 and 0.85 quantiles of
its row seed the responsibilities of two 2-component 1-D Gaussian mixtures,
tied and full variance, each fitted by EM; the fit of lower BIC wins and its
lower component mean is the cell's background. The arithmetic is the
reference's, step by step in float32:

* quantiles by jnp's linear rule: q·(D−1), then low·w_lo + high·w_hi;
* responsibilities 0.95/0.05 by |x − q_lo| ≤ |x − q_hi|, ± 0.02·u with u
  uniform on [0, 1), clipped to [0.01, 0.99] and renormalised;
* the M-step: nk = Σr + 1e-10 (also the weights nk/D), the tied variance
  divides by D, both add ``REG_COVAR``;
* the E-step by logsumexp, ll the mean of the row's log-norms;
* the freeze: an iteration runs its E-step and its M-step, then stops the
  fit if |ll − ll_prev| < tol (ll_prev starts at −inf); the fit returns
  the ll of that last E-step and the means of that last M-step;
* BIC −2·D·ll + p·ln D (p = 4 tied, 5 full); tied wins only below.

The uniforms are an argument (``draw_init_noise`` draws them from a
``torch.Generator``), so a test can hand over the reference's draws. The
reference pads the cells to a power of two so that its program compiles
once per panel width; the port runs eagerly and pads nothing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor, resolve_device

__all__ = ["background_means", "background_means_plain", "draw_init_noise",
           "gmm_background_means", "quantiles", "REG_COVAR"]

REG_COVAR = 1e-6
LOG2PI = float(np.log(2.0 * np.pi))
# T21 keeps a cell's row and responsibilities in shared memory up to this
# width (12 bytes a value); wider rows take a scratch tensor in global memory
# (kSmemValues in the source)
SMEM_VALUES = 16384
_INT32_MAX = 2**31 - 1


def draw_init_noise(n: int, d: int, seed: int = 0,
                    device: DeviceLike = None) -> torch.Tensor:
    """The ``(2, n, d)`` float32 uniforms on [0, 1) that perturb the initial
    responsibilities of the tied (0) and the full (1) fit, from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.rand((2, n, d), generator=gen, dtype=torch.float32, device=device)


def quantiles(X: torch.Tensor) -> torch.Tensor:
    """The 0.25 and 0.85 quantiles of every row of ``X (n, d)`` float32 as
    ``(n, 2)``, the same float32 numbers as jnp.quantile's linear rule under
    jit: fma(low, w_lo, high·w_hi)."""
    d = X.shape[1]
    S = torch.sort(X, dim=1).values
    q = torch.tensor([0.25, 0.85], dtype=torch.float32) * np.float32(d - 1)
    low, high = torch.floor(q), torch.ceil(q)
    w_hi = q - low
    w_lo = 1.0 - w_hi
    lo_i = low.clamp(0, d - 1).long().to(X.device)
    hi_i = high.clamp(0, d - 1).long().to(X.device)
    # XLA contracts the first product and the sum into one FMA; the product
    # of two float32 numbers is exact in float64
    hi_part = (S[:, hi_i] * w_hi.to(X.device)).double()
    return (S[:, lo_i].double() * w_lo.to(X.device).double() + hi_part).float()


def _init_resp(X: torch.Tensor, q: torch.Tensor, u: torch.Tensor):
    near = (X - q[:, :1]).abs() <= (X - q[:, 1:]).abs()
    nz = np.float32(0.02) * u
    r0 = torch.clamp(torch.where(near, 0.95, 0.05) + nz, 0.01, 0.99)
    r1 = torch.clamp(torch.where(near, 0.05, 0.95) - nz, 0.01, 0.99)
    s = r0 + r1
    return r0 / s, r1 / s


def _m_step(X, r0, r1, tied: bool):
    d = X.shape[1]
    nk0, nk1 = r0.sum(1) + 1e-10, r1.sum(1) + 1e-10
    m0, m1 = (r0 * X).sum(1) / nk0, (r1 * X).sum(1) / nk1
    s0 = (r0 * (X - m0[:, None]) ** 2).sum(1)
    s1 = (r1 * (X - m1[:, None]) ** 2).sum(1)
    if tied:
        v0 = v1 = (s0 + s1) / d + REG_COVAR
    else:
        v0, v1 = s0 / nk0 + REG_COVAR, s1 / nk1 + REG_COVAR
    return (nk0 / d, nk1 / d), (m0, m1), (v0, v1)


def _e_step(X, w, m, v):
    lp = [(-0.5 * (np.float32(LOG2PI) + torch.log(v[k])))[:, None]
          - 0.5 * (X - m[k][:, None]) ** 2 / v[k][:, None]
          + torch.log(w[k])[:, None] for k in (0, 1)]
    amax = torch.maximum(lp[0], lp[1])
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    norm = torch.log(torch.exp(lp[0] - amax) + torch.exp(lp[1] - amax)) + amax
    return torch.exp(lp[0] - norm), torch.exp(lp[1] - norm), norm.sum(1) / X.shape[1]


def _em(X, r0, r1, tied: bool, n_iter: int, tol: float):
    """One fit for all cells at once, each frozen after its own stop:
    (means (2, n), ll (n,), iterations run (n,) int32)."""
    n = X.shape[0]
    w, m, v = _m_step(X, r0, r1, tied)
    ll = torch.full((n,), -math.inf, dtype=X.dtype, device=X.device)
    done = torch.zeros(n, dtype=torch.bool, device=X.device)
    iters = torch.zeros(n, dtype=torch.int32, device=X.device)
    for _ in range(int(n_iter)):
        if bool(done.all()):
            break
        r0, r1, ll_new = _e_step(X, w, m, v)
        w2, m2, v2 = _m_step(X, r0, r1, tied)
        iters += (~done).int()
        keep = lambda new, old: tuple(torch.where(done, o, nw)  # noqa: E731
                                      for nw, o in zip(new, old))
        w, m, v = keep(w2, w), keep(m2, m), keep(v2, v)
        new_done = done | ((ll_new - ll).abs() < tol)
        ll = torch.where(done, ll, ll_new)
        done = new_done
    return torch.stack(m), ll, iters


def background_means_plain(X: torch.Tensor, noise: torch.Tensor, n_iter: int = 100,
                           tol: float = 1e-3
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T21's function in plain PyTorch, batched over the cells: ``(means
    (n,) float32, tied (n,) bool: the tied fit won, iterations (2, n) int32:
    the EM iterations the tied and the full fit ran)``."""
    d = X.shape[1]
    q = quantiles(X)
    fits = [_em(X, *_init_resp(X, q, noise[f]), f == 0, n_iter, tol) for f in (0, 1)]
    log_d = torch.log(torch.tensor(float(d), dtype=torch.float32))
    bic = [np.float32(-2.0 * d) * ll + p * log_d.to(X.device)
           for (_, ll, _), p in zip(fits, (4, 5))]
    tied = bic[0] < bic[1]
    means = torch.where(tied, fits[0][0].min(0).values, fits[1][0].min(0).values)
    return means, tied, torch.stack([fits[0][2], fits[1][2]])


def gmm_background_means(X: torch.Tensor, noise: torch.Tensor, n_iter: int = 100,
                         tol: float = 1e-3
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """T21: for every row of ``X (n, d)`` float32 and the uniforms ``noise
    (2, n, d)`` float32, the background mean, whether the tied fit won, and
    the iterations each fit ran (see ``background_means_plain``)."""
    if X.device.type == "cpu" and noise.device.type == "cpu":
        return background_means_plain(X, noise, n_iter, tol)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    n, d = X.shape
    if d < 1 or max(n, d) > _INT32_MAX:
        raise ValueError(f"X of shape {(n, d)} is outside what T21 takes")
    if noise.device != X.device or noise.dtype != torch.float32 \
            or tuple(noise.shape) != (2, n, d) or not noise.is_contiguous():
        raise ValueError(f"noise must be a contiguous (2, {n}, {d}) float32 tensor on "
                         f"{X.device}, got {noise.dtype} {tuple(noise.shape)} on "
                         f"{noise.device}")
    if int(n_iter) < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    means = torch.empty(n, dtype=torch.float32, device=X.device)
    tied = torch.empty(n, dtype=torch.int32, device=X.device)
    iters = torch.empty((2, n), dtype=torch.int32, device=X.device)
    scratch = (torch.empty((n, 3 * d), dtype=torch.float32, device=X.device)
               if d > SMEM_VALUES else None)
    _kernels.launch(
        "gmm_background_means", X.device,
        X.data_ptr(), noise.data_ptr(), n, d, int(n_iter), float(tol),
        0 if scratch is None else scratch.data_ptr(),
        means.data_ptr(), tied.data_ptr(), iters.data_ptr(),
    )
    return means, tied.bool(), iters


def background_means(X, seed: int = 0, n_iter: int = 100, tol: float = 1e-3,
                     device: DeviceLike = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-cell background mean by the BIC-selected 2-component GMM: ``X
    (n_cells, n_proteins)`` (numpy or tensor, log-scaled values) → ``(n,)``
    float32 on the device, the lower component mean of the better (tied or
    full variance) fit. ``noise`` (2, n, d) replaces the uniforms drawn from
    ``seed``."""
    Xt = dense_to_tensor(X, device)
    n, d = Xt.shape
    if noise is None:
        noise = draw_init_noise(n, d, seed, Xt.device)
    else:
        noise = dense_to_tensor(noise, Xt.device)
    with stage("gmm/em"):
        return gmm_background_means(Xt, noise, n_iter, tol)[0]
