"""MEFISTO's Gaussian-process priors on the factors (counterpart of
``_rbf_kernel``, ``_normalize_kg``, ``_gp_group_fn``, ``_gp_hyper_fn`` and
``_gp_kmat_fn`` of muon_tpu/models/mofa.py, and of the in-step kernel
matrices of its sparse GP).

    rbf_kernel   T24  <- _rbf_kernel / _gp_kmat_fn, the sparse GP's Kmm and Knm
    kg_grad      T25  <- the gradient jax.grad takes through the kernel matrix
                         with respect to the group correlation Kg
                         (csrc/gp_kernels.cu)

The rest is dense algebra in torch: Cholesky factors and triangular solves
for the grid score of (ℓ, s) (``gp_hyper``) and, through autograd, for the
gradient steps on Kg (``gp_group``), where T24 builds the kernel matrix
forward and T25 takes it back (``RBFKg``).

Covariates are (n, p) float32, group labels float32 whole numbers (as the
reference keeps them), lengthscales and scales (F,) float32, one per
factor. Each wrapper runs its plain PyTorch version for tensors on the CPU;
for CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _kernels
from .device import on_card

__all__ = ["JITTER", "RBFKg", "gp_group", "gp_hyper", "kernel_matrices", "kg_grad",
           "kg_grad_plain", "normalize_kg", "rbf_kernel", "rbf_kernel_plain"]

JITTER = 1e-4
# T25 keeps one bin per row group in a thread's registers (kMaxGroups), and
# sums rows in chunks of 128 (kKgChunk)
MAX_GROUPS = 32
_KG_CHUNK = 128
_INT_MAX = 2**31 - 1


def _check(t: torch.Tensor, name: str, device, dim: int, shape=None) -> torch.Tensor:
    if t.device != device or t.dtype != torch.float32 or t.dim() != dim \
            or not t.is_contiguous() or (shape is not None and tuple(t.shape) != shape):
        want = f"{dim}-D" if shape is None else f"{shape}"
        raise ValueError(f"{name} must be a contiguous {want} float32 tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if max(t.shape, default=0) > _INT_MAX:
        raise ValueError(f"{name} of shape {tuple(t.shape)} exceeds the int32 range")
    return t


def _checked_args(a, b, ells, scales, ga, gb):
    dev = a.device
    na, p = _check(a, "a", dev, 2).shape
    nb = _check(b, "b", dev, 2, (b.shape[0], p)).shape[0]
    F = _check(ells, "ells", dev, 1).shape[0]
    _check(scales, "scales", dev, 1, (F,))
    if (ga is None) != (gb is None):
        raise ValueError("ga and gb come together")
    if ga is not None:
        _check(ga, "ga", dev, 1, (na,))
        _check(gb, "gb", dev, 1, (nb,))
    return dev, na, nb, p, F


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# T24
# ---------------------------------------------------------------------------


def rbf_kernel(a: torch.Tensor, b: torch.Tensor, ells: torch.Tensor, scales: torch.Tensor,
               ga: Optional[torch.Tensor] = None, gb: Optional[torch.Tensor] = None,
               Kg: Optional[torch.Tensor] = None, same: bool = False) -> torch.Tensor:
    """T24: the (F, na, nb) RBF kernel matrices of F factors between the
    points ``a`` (na, p) and ``b`` (nb, p):
    K[f, i, j] = s_f·exp(−‖aᵢ − bⱼ‖²/2ℓ_f²)·fac_f(gᵢ, gⱼ), plus 1 − s_f + 1e-4
    on the diagonal when ``same`` (a and b are one point set). fac_f is
    Kg[f, gᵢ, gⱼ] when ``Kg`` (F, G, G) is given, else [gᵢ = gⱼ] with the
    group labels ``ga``, ``gb``, else 1."""
    if Kg is not None and ga is None:
        raise ValueError("Kg needs the group labels")
    if not on_card(a):
        return rbf_kernel_plain(a, b, ells, scales, ga, gb, Kg, same)
    dev, na, nb, p, F = _checked_args(a, b, ells, scales, ga, gb)
    G = 0
    if Kg is not None:
        G = Kg.shape[-1] if Kg.dim() == 3 else -1
        _check(Kg, "Kg", dev, 3, (F, G, G))
    if same and na != nb:
        raise ValueError(f"same point set with {na} and {nb} points")
    if F > 65535:
        raise ValueError(f"{F} factors exceed the grid's 65535")
    out = torch.empty((F, na, nb), dtype=torch.float32, device=dev)
    _kernels.launch("gp_rbf_kernel", dev, a.data_ptr(), b.data_ptr(), na, nb, p,
                    ells.data_ptr(), scales.data_ptr(), F, _ptr(ga), _ptr(gb), _ptr(Kg), G,
                    int(bool(same)), out.data_ptr())
    return out


def rbf_kernel_plain(a: torch.Tensor, b: torch.Tensor, ells: torch.Tensor,
                     scales: torch.Tensor, ga: Optional[torch.Tensor] = None,
                     gb: Optional[torch.Tensor] = None, Kg: Optional[torch.Tensor] = None,
                     same: bool = False) -> torch.Tensor:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    ell, s = ells.reshape(-1, 1, 1), scales.reshape(-1, 1, 1)
    K = s * torch.exp(-0.5 * d2 / (ell * ell))
    if Kg is not None:
        gi, gj = ga.long(), gb.long()
        K = K * Kg[:, gi][:, :, gj]
    elif ga is not None:
        K = K * (ga[:, None] == gb[None, :]).to(K.dtype)
    if same:
        K = K + (1.0 - s + JITTER) * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    return K


def kernel_matrices(c: torch.Tensor, ells: torch.Tensor, scales: torch.Tensor,
                    gvec: Optional[torch.Tensor] = None,
                    Kg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense path's (K, N, N) prior covariances over the covariates ``c``
    (the reference's ``_gp_kmat_fn``)."""
    return rbf_kernel(c, c, ells, scales, gvec, gvec, Kg, same=True)


# ---------------------------------------------------------------------------
# T25
# ---------------------------------------------------------------------------


def kg_grad(dK: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ells: torch.Tensor,
            scales: torch.Tensor, ga: torch.Tensor, gb: torch.Tensor, G: int) -> torch.Tensor:
    """T25: the gradient of Σ dK·K with respect to Kg (F, G, G), K from
    :func:`rbf_kernel`: dKg[f, g, h] = s_f·Σ over i in group g, j in group h
    of dK[f, i, j]·exp(−‖aᵢ − bⱼ‖²/2ℓ_f²). Summed in a fixed order (row
    chunks, then the columns by a tree), so the same input gives the same
    bits."""
    if not on_card(dK):
        return kg_grad_plain(dK, a, b, ells, scales, ga, gb, G)
    dev, na, nb, p, F = _checked_args(a, b, ells, scales, ga, gb)
    if ga is None:
        raise ValueError("kg_grad needs the group labels")
    _check(dK, "dK", dev, 3, (F, na, nb))
    if not 0 < G <= MAX_GROUPS:
        raise ValueError(f"kg_grad takes 1 to {MAX_GROUPS} groups, got {G}")
    chunks = -(-na // _KG_CHUNK)
    if chunks > 65535 or F > 65535:
        raise ValueError(f"{na} rows or {F} factors exceed the grid")
    partial = torch.empty((max(F * chunks * nb * G, 1),), dtype=torch.float32, device=dev)
    out = torch.empty((F, G, G), dtype=torch.float32, device=dev)
    _kernels.launch("gp_kg_grad", dev, dK.data_ptr(), a.data_ptr(), b.data_ptr(), na, nb, p,
                    ells.data_ptr(), scales.data_ptr(), F, ga.data_ptr(), gb.data_ptr(), G,
                    partial.data_ptr(), out.data_ptr())
    return out


def kg_grad_plain(dK: torch.Tensor, a: torch.Tensor, b: torch.Tensor, ells: torch.Tensor,
                  scales: torch.Tensor, ga: torch.Tensor, gb: torch.Tensor,
                  G: int) -> torch.Tensor:
    """Autograd through the plain build."""
    Kg = torch.zeros((ells.shape[0], G, G), dtype=dK.dtype, device=dK.device,
                     requires_grad=True)
    with torch.enable_grad():
        K = rbf_kernel_plain(a, b, ells, scales, ga, gb, Kg)
        (g,) = torch.autograd.grad(K, Kg, dK)
    return g


class RBFKg(torch.autograd.Function):
    """K = ``rbf_kernel(c, c, ells, scales, gvec, gvec, Kg, same=True)``,
    differentiable in Kg: T24 forward, T25 backward."""

    @staticmethod
    def forward(ctx, Kg, c, ells, scales, gvec):
        ctx.save_for_backward(c, ells, scales, gvec)
        ctx.groups = Kg.shape[-1]
        return rbf_kernel(c, c, ells, scales, gvec, gvec, Kg.contiguous(), same=True)

    @staticmethod
    def backward(ctx, dK):
        c, ells, scales, gvec = ctx.saved_tensors
        return (kg_grad(dK.contiguous(), c, c, ells, scales, gvec, gvec, ctx.groups),
                None, None, None, None)


# ---------------------------------------------------------------------------
# the hyperparameters: a grid score of (ℓ, s), gradient steps on Kg
# ---------------------------------------------------------------------------


def normalize_kg(X: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Kg = corr(X Xᵀ + εI) for a stack of (G, G) matrices: PSD with a unit
    diagonal by construction."""
    G = X.shape[-1]
    Kg = X @ X.transpose(-1, -2) + eps * torch.eye(G, dtype=X.dtype, device=X.device)
    dd = torch.sqrt(torch.diagonal(Kg, dim1=-2, dim2=-1))
    return Kg / (dd[..., :, None] * dd[..., None, :])


def _marginal_terms(K: torch.Tensor, Zm: torch.Tensor, Zv: torch.Tensor):
    """For a stack of kernel matrices K (B, N, N) and moments Zm, Zv
    (B or 1, N, R): logdet K (B,), μᵀK⁻¹μ and Σᵢ (K⁻¹)ᵢᵢ vᵢ (B, R), by one
    Cholesky factor and one triangular inverse each."""
    B, N = K.shape[0], K.shape[-1]
    L = torch.linalg.cholesky(K)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    sol = torch.cholesky_solve(Zm.expand(B, N, Zm.shape[-1]), L)
    quad = (Zm * sol).sum(-2)
    eye = torch.eye(N, dtype=K.dtype, device=K.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    kinv_diag = (Linv * Linv).sum(-2)                               # (B, N)
    return logdet, quad, (kinv_diag[:, :, None] * Zv).sum(-2)


def gp_hyper(c: torch.Tensor, Zm: torch.Tensor, Zv: torch.Tensor, ells: torch.Tensor,
             scales: torch.Tensor, gvec: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per factor, the grid point (ℓ, s) of ``ells`` × ``scales`` that
    maximises −½(logdet K + μᵀK⁻¹μ + Σᵢ (K⁻¹)ᵢᵢ vᵢ) under the independent-groups
    kernel (the reference's ``_gp_hyper_fn``): one batched Cholesky over
    the scales for each ℓ, the first maximum as jnp.argmax takes it.
    Returns the (K,) lengthscales and scales, on the device."""
    n_s = scales.shape[0]
    scores = []
    for i in range(ells.shape[0]):
        K = rbf_kernel(c, c, ells[i].repeat(n_s), scales, gvec, gvec, same=True)
        logdet, quad, tr = _marginal_terms(K, Zm[None], Zv[None])    # (n_s,), (n_s, K)
        scores.append(-0.5 * (logdet[:, None] + quad + tr))
    best = torch.argmax(torch.stack(scores).reshape(-1, Zm.shape[1]), dim=0)
    return ells[best // n_s], scales[best % n_s]


def gp_group(c: torch.Tensor, Zm: torch.Tensor, Zv: torch.Tensor, ells: torch.Tensor,
             scales: torch.Tensor, gvec: torch.Tensor, X_all: torch.Tensor,
             n_steps: int = 10, lr: float = 0.2) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` normalised fixed-rate descent steps on the (K, G, G)
    parameters X of every factor's group correlation Kg = corr(XXᵀ + εI),
    on the GP marginal term ½(logdet K + μᵀK⁻¹μ + tr(K⁻¹diag v)) with (ℓ, s)
    fixed (the reference's ``_gp_group_fn``). The gradient is torch
    autograd through the Cholesky factor, with K from T24 and its gradient
    in Kg from T25. Returns (X, Kg)."""
    X = X_all.detach().clone()
    for _ in range(n_steps):
        with torch.enable_grad():
            Xg = X.requires_grad_(True)
            K = RBFKg.apply(normalize_kg(Xg), c, ells, scales, gvec)    # (K, N, N)
            logdet, quad, tr = _marginal_terms(K, Zm.T[:, :, None], Zv.T[:, :, None])
            score = 0.5 * (logdet + quad[:, 0] + tr[:, 0])
            (g,) = torch.autograd.grad(score.sum(), Xg)
        gn = torch.sqrt((g * g).sum(dim=(1, 2), keepdim=True))
        X = (X.detach() - lr * g / torch.clamp(gn, min=1e-8)).detach()
    return X, normalize_kg(X)
