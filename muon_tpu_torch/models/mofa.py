"""MOFA+ (multi-omics factor analysis) by variational Bayes on the device
(counterpart of muon_tpu/models/mofa.py).

The model is the MOFA+ group factor-analysis model (Argelaguet et al. 2020):

    Y^{m}_{nd} ≈ Σ_k z_{nk} · s^{m}_{dk} ŵ^{m}_{dk},   τ^m_d noise precision

with ARD precisions α^m_k on weights (per view), optional ARD on factors
(per group) and spike-slab sparsity s on weights. Inference is mean-field
coordinate ascent; one sweep is W → Z → τ → α → θ → ELBO. The residual
E = Y − Z·SWᵀ lives on the device once per view and is corrected by rank-1
updates inside the sweep.

Ported: gaussian, bernoulli and poisson views, masked (NaN or an explicit
mask) and unmasked, any number of groups, ``ard_weights``/``ard_factors``/
``spikeslab_weights``/``spikeslab_factors`` on and off, full-batch and
stochastic (SVI) training, MEFISTO's smooth factors (GP priors over a
covariate, dense or with inducing points, with learned group correlations
and DTW warping of the groups' covariates), checkpoint and resume, the R²
statistics and the factor order. The state is the reference's: the same
keys with the same meaning, as tensors (``state_from_reference`` and
``state_to_reference`` carry one across).

Where the reference loops over the factors inside one compiled program,
the sweeps here call four kernels per factor and view (ops/mofa.py): T17
(zk @ E, and Σ E² for τ), T18 (the posterior of one factor's weights), T19
(E @ tsw, with the mask's two sums) and T20 (the rank-1 correction of E, in
place). A bernoulli or poisson view refreshes its local bound at the start
of each sweep with T23 and then runs the masked path with B = the bound's
per-entry precisions. Smooth factors take their prior covariances from T24
(ops/gp.py) and their posteriors from torch Cholesky factors and triangular
solves. The products that stand outside the loop are ``torch.matmul``. A
sweep copies what it updates, so a state handed to a callback or a
checkpoint is never written again.

Not ported yet, and refused by name: ``mesh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import gp
from ..ops import mofa as ops
from ..ops.device import DeviceLike, resolve_device
from ..utils.profiling import stage

__all__ = ["MOFAConfig", "MOFAResult", "fit_mofa", "make_step", "make_svi_step",
           "r2_stats", "state_from_reference", "state_to_reference"]

# gamma prior hyperparameters (uninformative, mofapy2 convention)
A0 = 1e-14
B0 = 1e-14
THETA_A0 = 1.0
THETA_B0 = 1.0

CONVERGENCE_THRESHOLDS = {"fast": 5e-4, "medium": 5e-5, "slow": 5e-6}

# views trained through a local quadratic bound, whose τ the bound fixes
BOUND_LIKELIHOODS = ("bernoulli", "poisson")
# the sweep before which spike-slab factors stay dense (mofapy2's
# start_sparsity): the host loop sets the state's ``ssz_on`` there
SSZ_START = 15

F32 = torch.float32


@dataclass(frozen=True)
class MOFAConfig:
    n_factors: int = 10
    likelihoods: tuple = ("gaussian",)
    ard_weights: bool = True
    ard_factors: bool = True
    spikeslab_weights: bool = True
    spikeslab_factors: bool = False  # sample-wise sparsity on Z
    n_groups: int = 1
    seed: int = 1


@dataclass
class MOFAResult:
    Z: np.ndarray                      # (N, K)
    W: List[np.ndarray]                # per view (D_m, K) — E[s·ŵ]
    S: List[np.ndarray]                # per view spike probabilities
    alpha: np.ndarray                  # (M, K)
    tau: List[np.ndarray]              # per view (D_m,)
    theta: np.ndarray                  # (M, K)
    elbo_history: np.ndarray
    n_iterations: int
    converged: bool
    r2_per_factor: dict = field(default_factory=dict)  # {group: (M, K)}
    r2_total: dict = field(default_factory=dict)
    gp_lengthscales: "Optional[np.ndarray]" = None  # (K,) MEFISTO ℓ per factor
    gp_scales: "Optional[np.ndarray]" = None        # (K,) MEFISTO smoothness
    warped_covariates: "Optional[np.ndarray]" = None  # (N,) aligned covariate
    gp_group_corr: "Optional[np.ndarray]" = None    # (K, G, G) learned Kg


# ---------------------------------------------------------------------------
# carrying a state across
# ---------------------------------------------------------------------------


def _leaf_to_tensor(v, device):
    if v is None or torch.is_tensor(v):
        return v if v is None else v.to(device)
    a = np.asarray(v)
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    # np.require keeps a 0-dim array 0-dim (ascontiguousarray makes it 1-D)
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


def state_from_reference(state: dict, device: DeviceLike = None) -> dict:
    """A VB state of the reference's layout (``_init_state`` or a sweep's
    result, as a dict of numpy or JAX arrays, per-view entries as lists,
    absent entries None) as a dict of tensors on ``device``, floats as
    float32."""
    device = resolve_device(device)
    return {
        key: [_leaf_to_tensor(v, device) for v in val] if isinstance(val, (list, tuple))
        else _leaf_to_tensor(val, device)
        for key, val in state.items()
    }


def state_to_reference(state: dict) -> dict:
    """The inverse of :func:`state_from_reference`: every tensor as a numpy
    array on the host."""
    def leaf(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) else v

    return {key: [leaf(v) for v in val] if isinstance(val, (list, tuple)) else leaf(val)
            for key, val in state.items()}


# ---------------------------------------------------------------------------
# the two loops over the factors, shared by the full-batch and the SVI sweep
# ---------------------------------------------------------------------------


def _w_sweep(config, m, E, B, Zm, z2, zz, tau, alpha, ln_alpha, theta_ln, theta_ln1m,
             W_hat, W_var, S, SW, scale=None):
    """The K coordinate updates of one view's weights (the reference's
    ``w_body`` loop): E and the four weight tensors are updated in place."""
    K = config.n_factors
    if B is None:
        z2s, zzs = z2.sum(dim=0), zz.sum(dim=0)      # (K,)
    else:
        z2s, zzs = z2.T @ B, zz.T @ B                # (K, D)
    if scale is not None:
        z2s, zzs = z2s * scale, zzs * scale
    for k in range(K):
        zk = Zm[:, k]
        u = ops.col_dot(E, zk)
        delta = ops.w_posterior(u, tau, z2s[k], zzs[k], alpha, ln_alpha, theta_ln,
                                theta_ln1m, m, k, W_hat, W_var, S, SW,
                                spikeslab=config.spikeslab_weights, scale=scale)
        ops.rank1_update(E, zk, delta, B)


def _z_sweep(config, Zm, Zv, Es, Bs, SWs, SWW, taus, prior_prec, posterior=None):
    """The K coordinate updates of the factors (the reference's ``z_body``
    loop): Zm, Zv and every E are updated in place. ``posterior(k, p, b)``
    gives factor k's new (mean, variance) from its precision p and its
    linear term b; without one, (b/p, 1/p)."""
    M = len(Es)
    tSW = [taus[m][:, None] * SWs[m] for m in range(M)]            # (D, K)
    tSWW = [taus[m][:, None] * SWW[m] for m in range(M)]
    tSW2 = [taus[m][:, None] * SWs[m] * SWs[m] for m in range(M)]
    # an unmasked view adds the same two numbers to every cell
    p_all = [None if Bs[m] is not None else tSWW[m].sum(dim=0) for m in range(M)]
    q_all = [None if Bs[m] is not None else tSW2[m].sum(dim=0) for m in range(M)]
    for k in range(config.n_factors):
        zk = Zm[:, k]
        p = prior_prec[:, k]
        b = torch.zeros_like(p)
        for m in range(M):
            if Bs[m] is None:
                r = ops.row_dot(Es[m], tSW[m][:, k])
                p = p + p_all[m][k]
                b = b + r + zk * q_all[m][k]
            else:
                r, pb, qb = ops.row_dot(Es[m], tSW[m][:, k], Bs[m], tSWW[m][:, k],
                                        tSW2[m][:, k])
                p = p + pb
                b = b + r + zk * qb
        if posterior is None:
            z_new, v_new = b / p, 1.0 / p
        else:
            z_new, v_new = posterior(k, p, b)
        delta = zk - z_new
        for m in range(M):
            ops.rank1_update(Es[m], delta, SWs[m][:, k], Bs[m])
        Zm[:, k] = z_new
        Zv[:, k] = v_new


def _ssz_posterior(ssz_on, thz_gap, ln_az_cell, Zhat, Zvhat, ZS):
    """Spike-slab factors (z = s·ẑ, s ~ Bern(θ_z of the cell's group)): the
    weights' spike-slab update transposed to cells. Z_mean/Z_var keep the
    E[z]/Var[z] convention; ẑ, its variance and s go to column k of
    ``Zhat``, ``Zvhat``, ``ZS`` in place. Until ``ssz_on`` (a 0-dim tensor)
    turns positive the update is dense (s = 1)."""

    def posterior(k, p, b):
        z_hat = b / p
        v_hat = 1.0 / p
        lam = thz_gap[:, k] + 0.5 * ln_az_cell[:, k] - 0.5 * torch.log(p) + 0.5 * b * b / p
        s_z = torch.where(ssz_on > 0, torch.sigmoid(lam), torch.ones_like(lam))
        z_new = s_z * z_hat
        ez2 = s_z * (v_hat + z_hat * z_hat)
        Zhat[:, k] = z_hat
        Zvhat[:, k] = v_hat
        ZS[:, k] = s_z
        return z_new, torch.clamp(ez2 - z_new * z_new, min=1e-12)

    return posterior


def _dense_gp_posterior(gp_K):
    """MEFISTO's smooth factor: q(z_k) = N(Σb, Σ) with Σ = (K_k⁻¹ + diag p)⁻¹,
    by the Woodbury form Σ = K − KS(I + SKS)⁻¹SK (S = diag √p): one (N, N)
    Cholesky factor and one triangular solve, no K⁻¹."""
    eye = torch.eye(gp_K.shape[-1], dtype=gp_K.dtype, device=gp_K.device)

    def posterior(k, p, b):
        Kk = gp_K[k]
        sq = torch.sqrt(p)
        with stage("mofa/gp_solve"):
            L = torch.linalg.cholesky(eye + (sq[:, None] * Kk) * sq[None, :])
            V = torch.linalg.solve_triangular(L, sq[:, None] * Kk, upper=False)  # L⁻¹SK
            z_new = Kk @ b - V.T @ (V @ b)
            v_new = torch.clamp(torch.diagonal(Kk) - (V * V).sum(dim=0), min=1e-8)
        return z_new, v_new

    return posterior


def _sparse_gp_posterior(state):
    """The sparse (inducing-point) GP in its SGPR form: with
    Σ = K_mm + K_mn diag(p) K_nm, E[z] = K_nm Σ⁻¹ K_mn b and
    Var[z] = k_ii − diag(Nyström) + diag(K_nm Σ⁻¹ K_mm Σ⁻¹ K_mn). K_mm and
    K_nm come from T24 in every sweep, so the state never holds an (N, N)
    matrix; with a learned group correlation (``gp_Kg``) its entry of the
    factor's groups multiplies the RBF term.

    The reference factors Σ itself, whose condition grows with N·p: in
    float32 its Cholesky factor breaks down at 10⁵ cells. Here Σ is
    factored as L_m B L_mᵀ with L_m = chol(K_mm), C = L_m⁻¹ K_mn and
    B = I + C diag(p) Cᵀ, whose eigenvalues are all ≥ 1 (GPflow's SGPR):
    E[z] = Cᵀ B⁻¹ C b, diag(Nyström) = ‖cᵢ‖², and the last term
    ‖B⁻¹ cᵢ‖². The same algebra, another order of roundings."""
    cn, cu = state["gp_cov"], state["gp_cov_u"]
    gn, gu = state["gp_g"], state["gp_g_u"]
    Kg = state.get("gp_Kg")

    def posterior(k, p, b):
        ell, sc = state["gp_ell"][k:k + 1], state["gp_scale"][k:k + 1]
        Kg_k = None if Kg is None else Kg[k:k + 1]
        with stage("mofa/gp_kernel"):
            Kmm = gp.rbf_kernel(cu, cu, ell, sc, gu, gu, Kg_k, same=True)[0]
            Knm = gp.rbf_kernel(cn, cu, ell, sc, gn, gu, Kg_k)[0]
        with stage("mofa/gp_solve"):
            C = torch.linalg.solve_triangular(torch.linalg.cholesky(Kmm), Knm.T, upper=False)
            B = (C * p[None, :]) @ C.T
            B.diagonal().add_(1.0)
            LB = torch.linalg.cholesky(B)
            z_new = C.T @ torch.cholesky_solve((C @ b)[:, None], LB)[:, 0]
            D = torch.cholesky_solve(C, LB)                          # B⁻¹ C
            v_new = torch.clamp(1.0 + gp.JITTER - (C * C).sum(dim=0) + (D * D).sum(dim=0),
                                min=1e-8)
        return z_new, v_new

    return posterior


def _residual_ss(E, B, z2, zz, SWW, SW):
    """Per feature, Σ_n E[(y − z·sw)²] over the observed entries, and their
    number: ``(E*E).sum(0)`` (T17) plus the variance terms. Returns
    (ss_e, ss, n_d) with ss_e the plain Σ E²."""
    ss_e = ops.col_dot(E)
    if B is None:
        ss = ss_e + z2.sum(dim=0) @ SWW.T - zz.sum(dim=0) @ (SW * SW).T
        return ss_e, ss, float(E.shape[0])
    corr = z2 @ SWW.T - zz @ (SW * SW).T                             # (N, D)
    return ss_e, ss_e + (corr * B).sum(dim=0), B.sum(dim=0)


def _gamma_moments(a, b):
    """E[x] and E[ln x] of Gamma(a, b); ``a`` may be a Python number."""
    if not torch.is_tensor(a):
        a = torch.tensor(a, dtype=F32, device=b.device)
    return a / b, torch.digamma(a) - torch.log(b)


def _theta_moments(S, D):
    ssum = S.sum(dim=0)
    sa = THETA_A0 + ssum
    sb = THETA_B0 + D - ssum
    dg = torch.digamma(sa + sb)
    return torch.digamma(sa) - dg, torch.digamma(sb) - dg, sa / (sa + sb)


def _ssz_moments(Gh, ZS, scale=1.0):
    """θ_z of the spike-slab factors per group from the slab counts (scaled
    by N/S in SVI): E[ln θ], E[ln(1 − θ)], E[θ]."""
    s_pg = (Gh.T @ ZS) * scale                                       # (G, K)
    sa = THETA_A0 + s_pg
    sb = THETA_B0 + (Gh.sum(dim=0) * scale)[:, None] - s_pg
    dg = torch.digamma(sa + sb)
    return torch.digamma(sa) - dg, torch.digamma(sb) - dg, sa / (sa + sb)


def _slab_z2(Gh, alpha_z, ZS, Zvhat, Zhat):
    """E[ẑ²] = S(v̂ + ẑ²) + (1 − S)/α_z (the slab-conditional moment)."""
    return ZS * (Zvhat + Zhat * Zhat) + (1.0 - ZS) / (Gh @ alpha_z)


def _refresh_bounds(liks, Zm, Zv, state, Y0s, M01s, target=False):
    """T23 for every bernoulli or poisson view: ``{m: (E, B, target)}``,
    B the per-entry precisions (bernoulli) or the mask (poisson)."""
    out = {}
    z2 = None
    for m, lik in enumerate(liks):
        if lik not in BOUND_LIKELIHOODS:
            continue
        if lik == "bernoulli":
            if z2 is None:
                z2 = Zv + Zm * Zm
            SWW = state["S"][m] * (state["W_var"][m] + state["W_hat"][m] ** 2)
            out[m] = ops.bound_refresh(lik, Zm, state["SW"][m], Y0s[m], M01s[m], z2=z2,
                                       SWW=SWW, target=target)
        else:
            out[m] = ops.bound_refresh(lik, Zm, state["SW"][m], Y0s[m], M01s[m],
                                       kappa=state["tau"][m], target=target)
    return out


def make_step(config: MOFAConfig, Ds: Sequence[int], N: int, masked: Sequence[bool],
              liks: Optional[Sequence[str]] = None, smooth: bool = False,
              sparse_gp: bool = False):
    """The full-batch coordinate-ascent sweep: ``step(state) -> (new_state,
    elbo)`` with ``elbo`` a 0-dim tensor on the device. The state it is
    given is left as it was.

    A bernoulli or poisson view trains through a local quadratic bound
    refreshed at the start of every sweep (T23): bernoulli (Jaakkola) with
    the per-entry precision T = 2λ(ζ)·mask, poisson (Seeger) with the
    per-feature precision κ_d held in τ; the view then runs the masked path
    with B = T (bernoulli) or the mask (poisson), and its τ is never
    updated. With ``smooth`` the factors carry GP priors (``gp_K`` in the
    state, or the sparse GP's covariates with ``sparse_gp``) instead of the
    diagonal prior; with ``config.spikeslab_factors`` (and not ``smooth``)
    each cell's factor value has a spike-slab prior."""
    K = config.n_factors
    M = len(Ds)
    liks = list(liks) if liks is not None else ["gaussian"] * M
    nongauss = [lk in BOUND_LIKELIHOODS for lk in liks]
    ssz = config.spikeslab_factors and not smooth

    def step(state):
        Zm, Zv = state["Z_mean"].clone(), state["Z_var"].clone()
        Gh = state["G"]                      # (N, G) one-hot
        alpha, ln_alpha = state["alpha"], state["ln_alpha"]    # (M, K)
        alpha_z = state["alpha_z"]           # (G, K)
        theta_ln, theta_ln1m = state["theta_ln"], state["theta_ln1m"]
        taus = state["tau"]
        masks_eff = list(state["mask"])
        Es = [None if nongauss[m] else E.clone() for m, E in enumerate(state["E"])]
        with stage("mofa/bound_refresh"):
            for m, (E, B, _) in _refresh_bounds(liks, Zm, Zv, state, state["Y0"],
                                                state["M01"]).items():
                Es[m], masks_eff[m] = E, B
        Bs = [masks_eff[m] if masked[m] else None for m in range(M)]
        Whats = [w.clone() for w in state["W_hat"]]
        Wvs = [w.clone() for w in state["W_var"]]
        Svs = [w.clone() for w in state["S"]]
        SWs = [w.clone() for w in state["SW"]]

        with stage("mofa/w_sweep"):
            zz = Zm * Zm
            z2 = Zv + zz
            for m in range(M):
                _w_sweep(config, m, Es[m], Bs[m], Zm, z2, zz, taus[m], alpha, ln_alpha,
                         theta_ln, theta_ln1m, Whats[m], Wvs[m], Svs[m], SWs[m])

        with stage("mofa/z_sweep"):
            SWW = [Svs[m] * (Wvs[m] + Whats[m] * Whats[m]) for m in range(M)]  # E[(sŵ)²]
            if smooth:
                # the GP prior enters through the posterior; no diagonal prior
                prior_prec = torch.zeros((N, K), dtype=Zm.dtype, device=Zm.device)
            elif config.ard_factors:
                prior_prec = Gh @ alpha_z
            else:
                prior_prec = torch.ones((N, K), dtype=Zm.dtype, device=Zm.device)
            posterior = None
            if ssz:
                Zhat, Zvhat, ZS = (state[key].clone() for key in ("Z_hat", "Z_vhat", "Z_S"))
                posterior = _ssz_posterior(
                    state["ssz_on"], Gh @ (state["theta_z_ln"] - state["theta_z_ln1m"]),
                    Gh @ state["ln_alpha_z"], Zhat, Zvhat, ZS)
            elif smooth and sparse_gp:
                posterior = _sparse_gp_posterior(state)
            elif smooth:
                posterior = _dense_gp_posterior(state["gp_K"])
            _z_sweep(config, Zm, Zv, Es, Bs, SWs, SWW, taus, prior_prec, posterior)

        with stage("mofa/moments"):
            zz = Zm * Zm
            z2 = Zv + zz
            ss_views, n_d_views, new_tau, new_ln_tau = [], [], [], []
            for m in range(M):
                _, ss, n_d = _residual_ss(Es[m], Bs[m], z2, zz, SWW[m], SWs[m])
                ss_views.append(ss)
                n_d_views.append(n_d)
                if nongauss[m]:
                    # τ is fixed by the quadratic bound, never inferred
                    new_tau.append(taus[m])
                    new_ln_tau.append(state["ln_tau"][m])
                    continue
                t, lt = _gamma_moments(A0 + 0.5 * n_d, B0 + 0.5 * ss)
                new_tau.append(t)
                new_ln_tau.append(lt)

            if config.ard_weights:
                alpha_new, ln_alpha_new = [], []
                for m in range(M):
                    # E[ŵ²] = S(v+ŵ²) + (1−S)/α_prev
                    w2 = Svs[m] * (Wvs[m] + Whats[m] ** 2) + (1.0 - Svs[m]) / alpha[m][None, :]
                    a_, la_ = _gamma_moments(A0 + 0.5 * Ds[m], B0 + 0.5 * w2.sum(dim=0))
                    alpha_new.append(a_)
                    ln_alpha_new.append(la_)
                alpha = torch.stack(alpha_new)
                ln_alpha = torch.stack(ln_alpha_new)

            ln_alpha_z = state.get("ln_alpha_z")
            if config.ard_factors:
                Ng = Gh.sum(dim=0)  # (G,)
                zg = _slab_z2(Gh, alpha_z, ZS, Zvhat, Zhat) if ssz else z2
                alpha_z, la_z = _gamma_moments(A0 + 0.5 * Ng[:, None], B0 + 0.5 * (Gh.T @ zg))
                if ssz:
                    ln_alpha_z = la_z

            if ssz:
                theta_z = _ssz_moments(Gh, ZS)

            if config.spikeslab_weights:
                th = [_theta_moments(Svs[m], Ds[m]) for m in range(M)]
                theta_ln = torch.stack([t[0] for t in th])
                theta_ln1m = torch.stack([t[1] for t in th])
                theta_mean = torch.stack([t[2] for t in th])
            else:
                theta_mean = state["theta_mean"]

        with stage("mofa/elbo"):
            # up to constants; reuses the per-view ss of the τ update
            elbo = torch.zeros((), dtype=F32, device=Zm.device)
            for m in range(M):
                elbo = elbo + torch.sum(
                    0.5 * n_d_views[m] * (new_ln_tau[m] - math.log(2 * math.pi))
                    - 0.5 * new_tau[m] * ss_views[m]
                )
            # KL(Z) under the prior precision; a unit-prior surrogate under the
            # GP prior (its exact KL costs K more Cholesky factors, and only the
            # changes from sweep to sweep matter)
            kl_prec = torch.ones_like(prior_prec) if smooth else prior_prec
            elbo = elbo - 0.5 * torch.sum(kl_prec * z2 - 1.0 - torch.log(kl_prec * Zv))
            for m in range(M):
                w2 = Wvs[m] + Whats[m] ** 2
                kl_w = 0.5 * (
                    alpha[m][None, :] * w2 - 1.0 - ln_alpha[m][None, :] - torch.log(Wvs[m])
                )
                if config.spikeslab_weights:
                    # 1e-6 is the largest eps with 1-eps != 1 in f32
                    s = torch.clamp(Svs[m], 1e-6, 1.0 - 1e-6)
                    kl_s = s * (torch.log(s) - theta_ln[m][None, :]) + (1 - s) * (
                        torch.log(1 - s) - theta_ln1m[m][None, :]
                    )
                    elbo = elbo - torch.sum(s * kl_w) - torch.sum(kl_s)
                else:
                    elbo = elbo - torch.sum(kl_w)

        new_state = {"Z_mean": Zm, "Z_var": Zv}
        if ssz:
            new_state.update({
                "ssz_on": state["ssz_on"], "Z_hat": Zhat, "Z_vhat": Zvhat, "Z_S": ZS,
                "theta_z_ln": theta_z[0], "theta_z_ln1m": theta_z[1],
                "theta_z_mean": theta_z[2], "ln_alpha_z": ln_alpha_z,
            })
        new_state.update({"G": Gh, "E": Es, "mask": masks_eff, "M01": state["M01"],
                          "Y0": state["Y0"]})
        if smooth:
            keys = (("gp_cov", "gp_cov_u", "gp_ell", "gp_scale", "gp_g", "gp_g_u", "gp_Kg")
                    if sparse_gp else ("gp_K",))
            new_state.update({key: state[key] for key in keys if key in state})
        new_state.update({
            "W_hat": Whats,
            "W_var": Wvs,
            "S": Svs,
            "SW": SWs,
            "alpha": alpha,
            "ln_alpha": ln_alpha,
            "alpha_z": alpha_z,
            "tau": new_tau,
            "ln_tau": new_ln_tau,
            "theta_ln": theta_ln,
            "theta_ln1m": theta_ln1m,
            "theta_mean": theta_mean,
        })
        return new_state, elbo

    return step


def make_svi_step(config: MOFAConfig, Ds: Sequence[int], N: int, S: int,
                  liks: Optional[Sequence[str]] = None):
    """The stochastic-VI sweep over a minibatch of ``S`` cells:
    ``step(state, batch, rho) -> (new_state, objective)``. The batch's rows
    of Z get exact coordinate updates; W, τ, α and θ are re-estimated from
    batch statistics scaled by N/S and blended into the running values with
    step size ``rho``. ``batch`` is an int64 tensor of distinct rows; the
    state keeps the raw data (``Y0``, ``M01``) and τ's natural parameters
    (``tau_a``, ``tau_b``). Bernoulli and poisson views refresh their bound
    on the batch (T23), with the target that rebuilds their residuals after
    the W blend; spike-slab factors update on the batch as in
    :func:`make_step`."""
    K = config.n_factors
    M = len(Ds)
    scale = N / float(S)
    liks = list(liks) if liks is not None else ["gaussian"] * M
    nongauss = [lk in BOUND_LIKELIHOODS for lk in liks]
    ssz = config.spikeslab_factors

    def step(state, batch, rho):
        # the reference blends in float32: 1 − ρ is rounded there
        rho32 = np.float32(rho)
        keep, rho = float(np.float32(1.0) - rho32), float(rho32)

        def blend(old, new):
            return keep * old + rho * new

        with stage("mofa/svi_gather"):
            Zm_full, Zv_full = state["Z_mean"], state["Z_var"]
            Zb = Zm_full.index_select(0, batch)
            Zvb = Zv_full.index_select(0, batch)
            Gb = state["G"].index_select(0, batch)
            alpha, ln_alpha = state["alpha"], state["ln_alpha"]
            alpha_z = state["alpha_z"]
            theta_ln, theta_ln1m = state["theta_ln"], state["theta_ln1m"]
            taus = state["tau"]
            if ssz:
                Zhat_b, Zvhat_b, ZS_b = (state[key].index_select(0, batch)
                                         for key in ("Z_hat", "Z_vhat", "Z_S"))
            Ybs, Mbs = [], []
            for m in range(M):
                M01 = state["M01"][m]
                Ybs.append(state["Y0"][m].index_select(0, batch))
                Mb = M01.index_select(0, batch) if M01 is not None else None
                if Mb is None and nongauss[m]:
                    Mb = torch.ones_like(Ybs[m])
                Mbs.append(Mb)

        with stage("mofa/bound_refresh"):
            # the target per view, so that residuals can be rebuilt after the
            # W blend: E = Tgt − B·F (no mask: E = Tgt − F)
            bounds = _refresh_bounds(liks, Zb, Zvb, state, Ybs, Mbs, target=True)
            Es, Bs, Tgts = [], [], []
            for m in range(M):
                if nongauss[m]:
                    E, B, tgt = bounds[m]
                else:
                    Yb, Mb = Ybs[m], Mbs[m]
                    F = Zb @ state["SW"][m].T
                    tgt = Yb if Mb is None else Yb * Mb
                    E, B = (Yb - F, None) if Mb is None else (Yb * Mb - F * Mb, Mb)
                Es.append(E)
                Bs.append(B)
                Tgts.append(tgt)

        with stage("mofa/w_sweep"):
            zz = Zb * Zb
            z2b = Zvb + zz
            new_W, new_Wv, new_S, new_SW = [], [], [], []
            for m in range(M):
                What, Wv, Sm, SW = (state[key][m] for key in ("W_hat", "W_var", "S", "SW"))
                What_b, Wv_b, S_b, SW_b = What.clone(), Wv.clone(), Sm.clone(), SW.clone()
                _w_sweep(config, m, Es[m], Bs[m], Zb, z2b, zz, taus[m], alpha, ln_alpha,
                         theta_ln, theta_ln1m, What_b, Wv_b, S_b, SW_b, scale=scale)
                new_W.append(blend(What, What_b))
                new_Wv.append(blend(Wv, Wv_b))
                new_S.append(blend(Sm, S_b))
                new_SW.append(blend(SW, SW_b))
            # the batch residuals under the blended W
            for m in range(M):
                F = Zb @ new_SW[m].T
                Es[m] = Tgts[m] - (F if Bs[m] is None else Bs[m] * F)

        with stage("mofa/z_sweep"):
            if config.ard_factors:
                prior_prec = Gb @ alpha_z
            else:
                prior_prec = torch.ones((S, K), dtype=Zb.dtype, device=Zb.device)
            SWW = [new_S[m] * (new_Wv[m] + new_W[m] ** 2) for m in range(M)]
            posterior = None
            if ssz:
                posterior = _ssz_posterior(
                    state["ssz_on"], Gb @ (state["theta_z_ln"] - state["theta_z_ln1m"]),
                    Gb @ state["ln_alpha_z"], Zhat_b, Zvhat_b, ZS_b)
            _z_sweep(config, Zb, Zvb, Es, Bs, new_SW, SWW, taus, prior_prec, posterior)

        with stage("mofa/moments"):
            zz = Zb * Zb
            z2b = Zvb + zz
            new_tau, new_ln_tau = [], []
            new_tau_a, new_tau_b = list(state["tau_a"]), list(state["tau_b"])
            ss_e_views = []
            for m in range(M):
                ss_e, ss, n_d = _residual_ss(Es[m], Bs[m], z2b, zz, SWW[m], new_SW[m])
                ss_e_views.append(ss_e)
                if nongauss[m]:
                    new_tau.append(taus[m])
                    new_ln_tau.append(state["ln_tau"][m])
                    continue
                # a step on q(τ)'s natural parameters: blending the ratio lets
                # one underdispersed batch blow τ up
                a_hat = A0 + 0.5 * scale * n_d
                b_hat = B0 + 0.5 * scale * torch.clamp(ss, min=1e-10)
                new_tau_a[m] = blend(state["tau_a"][m], a_hat)
                new_tau_b[m] = blend(state["tau_b"][m], b_hat)
                t, lt = _gamma_moments(new_tau_a[m], new_tau_b[m])
                new_tau.append(t)
                new_ln_tau.append(lt)

            if config.ard_weights:
                alpha_new, ln_alpha_new = [], []
                for m in range(M):
                    w2 = new_S[m] * (new_Wv[m] + new_W[m] ** 2) + (
                        1.0 - new_S[m]
                    ) / alpha[m][None, :]
                    a_, la_ = _gamma_moments(A0 + 0.5 * Ds[m], B0 + 0.5 * w2.sum(dim=0))
                    alpha_new.append(blend(alpha[m], a_))
                    ln_alpha_new.append(blend(ln_alpha[m], la_))
                alpha = torch.stack(alpha_new)
                ln_alpha = torch.stack(ln_alpha_new)

            ln_alpha_z = state.get("ln_alpha_z")
            if config.ard_factors:
                Ng = Gb.sum(dim=0) * scale
                zg = _slab_z2(Gb, alpha_z, ZS_b, Zvhat_b, Zhat_b) if ssz else z2b
                a_z, la_z = _gamma_moments(A0 + 0.5 * Ng[:, None],
                                           B0 + 0.5 * ((Gb.T @ zg) * scale))
                alpha_z = blend(alpha_z, a_z)
                if ssz:
                    ln_alpha_z = blend(ln_alpha_z, la_z)
            ssz_state = {}
            if ssz:
                # θ_z from the scaled batch slab counts, expectations blended
                th_z = _ssz_moments(Gb, ZS_b, scale)
                ssz_state = {
                    "ssz_on": state["ssz_on"],
                    "Z_hat": state["Z_hat"].index_copy(0, batch, Zhat_b),
                    "Z_vhat": state["Z_vhat"].index_copy(0, batch, Zvhat_b),
                    "Z_S": state["Z_S"].index_copy(0, batch, ZS_b),
                    "theta_z_ln": blend(state["theta_z_ln"], th_z[0]),
                    "theta_z_ln1m": blend(state["theta_z_ln1m"], th_z[1]),
                    "theta_z_mean": blend(state["theta_z_mean"], th_z[2]),
                    "ln_alpha_z": ln_alpha_z,
                }

            if config.spikeslab_weights:
                th = [_theta_moments(new_S[m], Ds[m]) for m in range(M)]
                theta_ln = torch.stack([t[0] for t in th])
                theta_ln1m = torch.stack([t[1] for t in th])
                theta_mean = torch.stack([t[2] for t in th])
            else:
                theta_mean = state["theta_mean"]

            # the batch's Z back into the whole (distinct rows: no duplicates)
            Zm_full = Zm_full.index_copy(0, batch, Zb)
            Zv_full = Zv_full.index_copy(0, batch, Zvb)

        with stage("mofa/elbo"):
            # surrogate objective: the scaled batch reconstruction error
            elbo = torch.zeros((), dtype=F32, device=Zb.device)
            for m in range(M):
                elbo = elbo - 0.5 * scale * torch.sum(new_tau[m] * ss_e_views[m])

        new_state = {
            **state,
            **ssz_state,
            "Z_mean": Zm_full,
            "Z_var": Zv_full,
            "W_hat": new_W,
            "W_var": new_Wv,
            "S": new_S,
            "SW": new_SW,
            "alpha": alpha,
            "ln_alpha": ln_alpha,
            "alpha_z": alpha_z,
            "tau": new_tau,
            "ln_tau": new_ln_tau,
            "tau_a": new_tau_a,
            "tau_b": new_tau_b,
            "theta_ln": theta_ln,
            "theta_ln1m": theta_ln1m,
            "theta_mean": theta_mean,
        }
        return new_state, elbo

    return step


def r2_stats(Ym, Bm, Z, W, G, block: int):
    """Per-(group, factor) R² statistics of one view, in blocks of ``block``
    rows (the reference's ``_r2_stats_fn``). ``Bm`` is the mask or None.
    Returns float64 tensors, per group:
      ssY_g  (G,)   = Σ (Y·B)²
      t1_gk  (G,K)  = Σ_n z_nk ((Y·B) W)_nk
      t2_gk  (G,K)  = Σ_n z²_nk (B W²)_nk
      ssf_g  (G,)   = Σ (Y·B − (ZWᵀ)·B)²
    so ss_res(g, k) = ssY − 2·t1 + t2 (single factor) and the full model's
    residual comes from ssf. The products of a block run in float32; the
    four sums over the blocks are carried in float64."""
    N = Ym.shape[0]
    K, Gn = Z.shape[1], G.shape[1]
    W2 = W * W
    w2sum = W2.sum(dim=0)
    f64 = dict(dtype=torch.float64, device=Ym.device)
    ssY_g, ssf = torch.zeros(Gn, **f64), torch.zeros(Gn, **f64)
    t1, t2 = torch.zeros((Gn, K), **f64), torch.zeros((Gn, K), **f64)
    for i0 in range(0, N, block):
        Yb, Zb, Gb = Ym[i0:i0 + block], Z[i0:i0 + block], G[i0:i0 + block]
        G1 = Yb @ W  # (b, K)
        P = Zb @ W.T
        if Bm is not None:
            Bb = Bm[i0:i0 + block]
            G2 = Bb @ W2
            P = P * Bb
        else:
            G2 = w2sum.expand_as(G1)
        t1 += (Gb.T @ (Zb * G1)).double()
        t2 += (Gb.T @ (Zb * Zb * G2)).double()
        ssY_g += (Gb.T @ (Yb * Yb).sum(dim=1)).double()
        ssf += (Gb.T @ ((Yb - P) ** 2).sum(dim=1)).double()
    return ssY_g, t1, t2, ssf


# ---------------------------------------------------------------------------
# the initial state
# ---------------------------------------------------------------------------


def _draw_z0(N: int, K: int, seed: int, device: torch.device) -> torch.Tensor:
    """The initial factor means: standard normal draws from an explicit
    generator seeded with ``seed`` (not the reference's draws: hand both
    packages one ``Z0`` where they must start alike)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((N, K), generator=gen, dtype=F32, device=device)


def _draw_w0(D: int, K: int, seed: int, m: int, device: torch.device) -> torch.Tensor:
    """View ``m``'s standard normal draws for a random W start, from a
    generator of its own, seeded from (seed, 7, m): a stream apart from Z's,
    as the reference folds 7 into its key (not the reference's draws)."""
    sub = int(np.random.SeedSequence([int(seed), 7, int(m)]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(sub)
    return torch.randn((D, K), generator=gen, dtype=F32, device=device)


def _view_tensor(Y, device) -> torch.Tensor:
    if not torch.is_tensor(Y):
        # from_numpy refuses a read-only array (a JAX export, a memmap)
        Y = torch.from_numpy(np.require(np.asarray(Y), requirements=["C", "W"]))
    return Y.to(device=device, dtype=F32)


def _clean_view(Y, B, device):
    """NaN → 0 and the mask applied, on the device: (Ym, Bj)."""
    Yj = torch.nan_to_num(_view_tensor(Y, device), nan=0.0).contiguous()
    Bj = None if B is None else _view_tensor(B, device).contiguous()
    return (Yj if Bj is None else Yj * Bj), Bj


def _init_state(Ys, masks, groups_onehot, config: MOFAConfig, liks=None,
                keep_data: bool = False, Z0=None, W0=None, device: DeviceLike = None):
    """The reference's initial state. A gaussian view (masked where
    ``masks[m]`` is given) starts with W at zero, so E is the (masked) data,
    and τ from the per-feature variance over the observed entries, taken on
    the device. A bernoulli or poisson view keeps its raw data and a 0/1
    mask (``Y0``, ``M01``), holds its bound's precision in τ (1, or
    κ_d = ¼ + 0.17·maxₙ y for poisson) and starts from a random W with
    q(s) = 1, which breaks the W↔Z symmetry the bound cannot. With
    ``spikeslab_factors`` a gaussian view starts from 0.1 × a random W too,
    and the state carries the factors' spike-slab moments. ``keep_data``
    keeps what SVI needs: ``Y0``, ``M01`` and τ's natural parameters.

    ``Z0 (N, K)`` is the initial ``Z_mean``; ``W0`` a list of per-view
    (D_m, K) standard normal draws for the random W starts (an entry may be
    None where a view needs none). Each is drawn from a ``torch.Generator``
    seeded from ``config.seed`` where absent."""
    device = resolve_device(device)
    N = Ys[0].shape[0]
    K = config.n_factors
    M = len(Ys)
    G = config.n_groups
    liks = list(liks) if liks is not None else ["gaussian"] * M

    if Z0 is None:
        Zm = _draw_z0(N, K, config.seed, device)
    else:
        Zm = _view_tensor(Z0, device).clone().contiguous()
        if tuple(Zm.shape) != (N, K):
            raise ValueError(f"Z0 must have shape {(N, K)}, got {tuple(Zm.shape)}")

    def full(shape, value):
        return torch.full(shape, value, dtype=F32, device=device)

    def w_start(m, D):
        w = None if W0 is None else W0[m]
        if w is None:
            return _draw_w0(D, K, config.seed, m, device)
        w = _view_tensor(w, device).clone().contiguous()
        if tuple(w.shape) != (D, K):
            raise ValueError(f"W0[{m}] must have shape {(D, K)}, got {tuple(w.shape)}")
        return w

    state = {
        "Z_mean": Zm,
        "Z_var": full((N, K), 1.0),
        "G": _view_tensor(groups_onehot, device).contiguous(),
        "E": [],
        "mask": [],
        "M01": [],
        "Y0": [],
        "W_hat": [],
        "W_var": [],
        "S": [],
        "SW": [],
        "alpha": full((M, K), 1.0),
        "ln_alpha": full((M, K), 0.0),
        "alpha_z": full((G, K), 1.0),
        "tau": [],
        "ln_tau": [],
        # optimistic slab-probability start (mofapy2 initializes E[θ] at 1): a
        # θ=0.5 start closes the W gate on the very first sweep and every
        # factor dies; θ₀=0.99 keeps it open until W locks onto real signal
        "theta_ln": full((M, K), math.log(0.99)),
        "theta_ln1m": full((M, K), math.log(0.01)),
        "theta_mean": full((M, K), 0.99),
    }
    if config.spikeslab_factors:
        # the same optimistic start for θ_z: at θ = 0.5 the double gate (W
        # and Z both at s ≈ ½) stalls all but one factor
        th0 = 0.99
        state.update({
            "ssz_on": torch.zeros((), dtype=F32, device=device),
            "Z_hat": Zm,
            "Z_vhat": full((N, K), 1.0),
            "Z_S": full((N, K), 1.0),
            "theta_z_ln": full((G, K), math.log(th0)),
            "theta_z_ln1m": full((G, K), math.log(1.0 - th0)),
            "theta_z_mean": full((G, K), th0),
            "ln_alpha_z": full((G, K), 0.0),
        })
    for m, Y in enumerate(Ys):
        D = Y.shape[1]
        if liks[m] in BOUND_LIKELIHOODS:
            Yj = torch.nan_to_num(_view_tensor(Y, device), nan=0.0).contiguous()
            M01 = (full((N, D), 1.0) if masks[m] is None
                   else _view_tensor(masks[m], device).contiguous())
            state["M01"].append(M01)
            state["Y0"].append(Yj * M01)
            state["mask"].append(M01)
            state["E"].append(torch.zeros((N, D), dtype=F32, device=device))
            if liks[m] == "poisson":
                # Seeger's bound precision κ_d = ¼ + 0.17 maxₙ y_nd
                kappa = 0.25 + 0.17 * Yj.max(dim=0).values
                state["tau"].append(kappa)
                state["ln_tau"].append(torch.log(kappa))
            else:
                state["tau"].append(full((D,), 1.0))
                state["ln_tau"].append(full((D,), 0.0))
            if keep_data:
                # placeholders keep the per-view lists aligned; SVI never
                # updates τ of a bound-based view
                state.setdefault("tau_a", []).append(full((D,), 1.0))
                state.setdefault("tau_b", []).append(full((D,), 1.0))
            W = w_start(m, D)
            state["W_hat"].append(W)
            state["W_var"].append(full((D, K), 1.0))
            state["S"].append(full((D, K), 1.0))
            state["SW"].append(W.clone())
            continue
        Ym, Bj = _clean_view(Y, masks[m], device)
        # per-column variance over observed entries, on the device
        cnt = float(N) if Bj is None else torch.clamp(Bj.sum(dim=0), min=1.0)
        mean_d = Ym.sum(dim=0) / cnt
        var_d = (Ym * Ym).sum(dim=0) / cnt - mean_d * mean_d
        var = var_d.cpu().numpy().astype(np.float64)
        var[~np.isfinite(var) | (var <= 0)] = 1.0
        if keep_data:  # SVI recomputes batch residuals from raw data
            state["M01"].append(Bj)
            state["Y0"].append(Ym)
            # natural parameters of q(τ): blended by the SVI step
            n_obs_d = float(N) if Bj is None else Bj.sum(dim=0).cpu().numpy()
            ta = A0 + 0.5 * n_obs_d * np.ones(D)
            tb = ta * var
            state.setdefault("tau_a", []).append(_leaf_to_tensor(ta, device))
            state.setdefault("tau_b", []).append(_leaf_to_tensor(tb, device))
        else:
            state["M01"].append(None)
            state["Y0"].append(None)
        state["mask"].append(Bj)
        state["tau"].append(_leaf_to_tensor(1.0 / var, device))
        state["ln_tau"].append(_leaf_to_tensor(-np.log(var), device))
        state["W_var"].append(full((D, K), 1.0))
        if config.spikeslab_factors:
            # the double spike-slab (W and Z) stalls from a zero-W start
            W = 0.1 * w_start(m, D)
            E0 = Ym - Zm @ W.T
            state["E"].append(E0 if Bj is None else E0 * Bj)
            state["W_hat"].append(W)
            state["S"].append(full((D, K), 1.0))
            state["SW"].append(W.clone())
        else:
            # W starts at zero → E starts as (masked) Y
            state["E"].append(Ym)
            state["W_hat"].append(full((D, K), 0.0))
            state["S"].append(full((D, K), 0.5 if config.spikeslab_weights else 1.0))
            state["SW"].append(full((D, K), 0.0))
    return state


# ---------------------------------------------------------------------------
# MEFISTO's warping: host numpy, as in the reference
# ---------------------------------------------------------------------------


def _dtw_align(ref_t, ref_z, g_t, g_z, open_begin=True, open_end=True):
    """Warp a group's trajectory onto the reference time base by DTW.

    Inputs are per-unique-timepoint group-mean factor values; alignment cost
    is squared Euclidean distance between factor vectors. Returns the warped
    time for each of g's timepoints (mean of matched reference times).
    Host-side numpy: the DP runs over unique covariate values, not cells,
    and is sequential.
    """
    C = ((g_z[:, None, :] - ref_z[None, :, :]) ** 2).sum(-1)
    Tg, Tr = C.shape
    D = np.empty((Tg, Tr))
    if open_begin:
        D[0] = C[0]
    else:
        D[0] = np.cumsum(C[0])
    for i in range(1, Tg):
        prev = D[i - 1]
        # min(D[i-1,j], D[i-1,j-1]) is vectorizable; D[i,j-1] is a scan
        diag = np.concatenate(([np.inf], prev[:-1]))
        best_up = np.minimum(prev, diag)
        row = D[i]
        left = np.inf
        ci = C[i]
        for j in range(Tr):
            left = ci[j] + min(best_up[j], left)
            row[j] = left
    j = int(np.argmin(D[-1])) if open_end else Tr - 1
    matched = [[] for _ in range(Tg)]
    i = Tg - 1
    while True:
        matched[i].append(ref_t[j])
        if i == 0 and (open_begin or j == 0):
            break
        cands = []
        if i > 0:
            cands.append((D[i - 1, j], i - 1, j))
            if j > 0:
                cands.append((D[i - 1, j - 1], i - 1, j - 1))
        if j > 0:
            cands.append((D[i, j - 1], i, j - 1))
        _, i, j = min(cands)
    return np.array([np.mean(m) for m in matched])


def _warp_groups(cov_norm, groups, Zm, ref, open_begin=True, open_end=True):
    """Apply DTW warping to every non-reference group's covariate.

    cov_norm: (N,) normalized covariate; groups: (N,) int labels;
    Zm: (N, K) current E[z]. Returns the new (N,) covariate with each
    non-reference group's values replaced by their DTW-matched positions
    on the reference group's time base.
    """
    out = cov_norm.copy()
    rsel = groups == ref
    rt, rinv = np.unique(cov_norm[rsel], return_inverse=True)
    rz = np.zeros((len(rt), Zm.shape[1]))
    np.add.at(rz, rinv, Zm[rsel])
    rz /= np.bincount(rinv)[:, None]
    for g in np.unique(groups):
        if g == ref:
            continue
        gsel = groups == g
        gt, ginv = np.unique(cov_norm[gsel], return_inverse=True)
        gz = np.zeros((len(gt), Zm.shape[1]))
        np.add.at(gz, ginv, Zm[gsel])
        gz /= np.bincount(ginv)[:, None]
        warped = _dtw_align(rt, rz, gt, gz, open_begin, open_end)
        out[gsel] = warped[ginv]
    return out


def _inducing_points(cov_flat, groups, N: int, frac_inducing) -> np.ndarray:
    """The sparse GP's inducing cells: about Mu = frac_inducing·N (1000 at
    most by default) spaced by covariate quantiles within each group, every
    group covering its time range (the kernel is block-diagonal across
    groups)."""
    Mu = min(
        N,
        max(10, int(round(frac_inducing * N)))
        if frac_inducing
        else min(1000, N),
    )
    parts = []
    for g in np.unique(groups):
        rows = np.flatnonzero(groups == g)
        m_g = max(2, int(round(Mu * len(rows) / N)))
        order_c = rows[np.argsort(cov_flat[rows], kind="stable")]
        parts.append(
            order_c[
                np.linspace(0, len(rows) - 1, min(m_g, len(rows)))
                .round()
                .astype(int)
            ]
        )
    return np.unique(np.concatenate(parts))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _nan_mask(Y):
    """The 0/1 mask of a view with NaNs (numpy for a host array, a tensor
    for a device tensor), or None when it has none."""
    if isinstance(Y, np.ndarray):
        return (~np.isnan(Y)).astype(np.float32) if np.isnan(Y).any() else None
    if torch.is_tensor(Y):
        nan = torch.isnan(Y)
        return torch.where(nan, 0.0, 1.0) if bool(nan.any()) else None
    return None


def fit_mofa(
    Ys: List[np.ndarray],
    config: MOFAConfig,
    masks: Optional[List[Optional[np.ndarray]]] = None,
    groups: Optional[np.ndarray] = None,
    n_iterations: int = 1000,
    convergence_mode: str = "fast",
    elbo_every: int = 5,
    min_iterations: int = 10,
    verbose: bool = False,
    mesh=None,
    svi_mode: bool = False,
    svi_batch_fraction: float = 0.5,
    svi_learning_rate: float = 1.0,
    svi_forgetting_rate: float = 0.5,
    svi_start_stochastic: int = 1,
    callback=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    smooth_covariate: Optional[np.ndarray] = None,
    smooth_n_grid: int = 10,
    smooth_opt_every: int = 25,
    smooth_start_opt: int = 20,
    model_groups: bool = False,
    warping: bool = False,
    warping_freq: int = 20,
    warping_ref: int = 0,
    warping_open_begin: bool = True,
    warping_open_end: bool = True,
    sparse_gp: bool = False,
    frac_inducing: Optional[float] = None,
    Z0=None,
    W0=None,
    device: DeviceLike = None,
) -> MOFAResult:
    """Train MOFA+ by VB coordinate ascent.

    Ys: per-view (N, D_m) arrays (numpy, or tensors already on the device),
    NaN = missing. groups: (N,) int labels. At most ``n_iterations`` sweeps,
    with the ELBO-change convergence rule and its fast/medium/slow
    thresholds. ``smooth_covariate`` (N,) or (N, p) gives the factors GP
    priors (MEFISTO), with its options as the reference's. ``device=None``
    runs on the CUDA device; ``Z0`` is the initial ``Z_mean`` and ``W0`` the
    per-view draws of the random W starts (see ``_init_state``), each drawn
    from ``config.seed`` when absent."""
    device = resolve_device(device)
    N = Ys[0].shape[0]
    M = len(Ys)
    if groups is None:
        groups = np.zeros(N, dtype=np.int64)
    groups = np.asarray(groups)
    G = int(groups.max()) + 1
    onehot = np.zeros((N, G), dtype=np.float32)
    onehot[np.arange(N), groups] = 1.0
    config = MOFAConfig(
        n_factors=config.n_factors,
        likelihoods=config.likelihoods,
        ard_weights=config.ard_weights,
        ard_factors=config.ard_factors and G >= 1,
        spikeslab_weights=config.spikeslab_weights,
        spikeslab_factors=config.spikeslab_factors,
        n_groups=G,
        seed=config.seed,
    )

    if masks is None:
        masks = [_nan_mask(Y) for Y in Ys]

    liks = list(config.likelihoods)
    if len(liks) < M:
        liks = liks + ["gaussian"] * (M - len(liks))
    # bound-based views always run through the masked (per-entry precision)
    # path
    masked = [m is not None or lk in BOUND_LIKELIHOODS for m, lk in zip(masks, liks)]
    smooth = smooth_covariate is not None
    if smooth and svi_mode:
        raise NotImplementedError(
            "smooth factors (MEFISTO) with svi_mode are not supported yet — "
            "use full-batch training"
        )
    if config.spikeslab_factors and smooth:
        raise NotImplementedError(
            "spikeslab_factors is not supported together with smooth "
            "covariates (a factor cannot have both a GP prior and a "
            "spike-slab prior)"
        )
    if sparse_gp and not smooth:
        raise ValueError("sparse_gp requires smooth_covariate")
    if warping:
        if not smooth:
            raise ValueError("warping requires smooth_covariate")
        if G < 2:
            raise ValueError("warping requires at least two groups")
        if np.asarray(smooth_covariate).ndim > 1 and np.asarray(
            smooth_covariate
        ).shape[1] > 1:
            raise NotImplementedError(
                "warping is only supported for 1-D covariates"
            )
    # what this port leaves out, by name
    if mesh is not None:
        raise NotImplementedError(
            "mesh (training over several devices) is not ported yet (ROADMAP.md)"
        )

    Ds_all = [Y.shape[1] for Y in Ys]
    if svi_mode:
        S = max(1, min(N, int(round(svi_batch_fraction * N))))
        svi_step = make_svi_step(config, Ds_all, N, S, liks)
        rng_batch = np.random.default_rng(config.seed)
    else:
        step = make_step(config, Ds_all, N, masked, liks, smooth=smooth, sparse_gp=sparse_gp)

    it0 = 0
    resumed_elbos: list = []
    with stage("mofa/init"):
        if resume_from is not None:
            from .checkpoint import load_state

            state, prev_elbos, it0 = load_state(resume_from)
            state = state_from_reference(state, device)
            resumed_elbos = list(np.asarray(prev_elbos))
        else:
            state = _init_state(Ys, masks, onehot, config, liks, keep_data=svi_mode,
                                Z0=Z0, W0=W0, device=device)

    gp_ell = gp_scale = gp_cov = None
    if smooth:
        with stage("mofa/gp_init"):
            c = np.asarray(smooth_covariate, np.float32)
            if c.ndim == 1:
                c = c[:, None]
            # the covariate on [0, 1], so that the lengthscale grid is unitless
            span = max(float(c.max() - c.min()), 1e-9)
            cov_span, cov_min = span, float(c.min())
            gp_cov = _leaf_to_tensor((c - c.min()) / span, device)
            ell_grid = _leaf_to_tensor(
                np.geomspace(0.05, 1.0, smooth_n_grid).astype(np.float32), device)
            scale_grid = _leaf_to_tensor(
                np.linspace(0.05, 0.95, max(3, smooth_n_grid // 2)).astype(np.float32), device)
            gp_ell = torch.full((config.n_factors,), 0.2, dtype=F32, device=device)
            gp_scale = torch.full((config.n_factors,), 0.5, dtype=F32, device=device)
            gvec = _leaf_to_tensor(groups.astype(np.float32), device)
            if sparse_gp:
                idx_u = torch.from_numpy(_inducing_points(
                    gp_cov[:, 0].cpu().numpy(), groups, N, frac_inducing)).to(device)
                if "gp_cov_u" not in state:
                    state["gp_cov"] = gp_cov
                    state["gp_cov_u"] = gp_cov[idx_u]
                    state["gp_ell"] = gp_ell
                    state["gp_scale"] = gp_scale
                    state["gp_g"] = gvec
                    state["gp_g_u"] = gvec[idx_u]
            elif "gp_K" not in state:
                state["gp_K"] = gp.kernel_matrices(gp_cov, gp_ell, gp_scale, gvec)
    # the learned group correlation Kg (mofapy2's model_groups) starts at I
    # (independent groups) and is refreshed with (ℓ, s); the dense path
    # takes it into gp_K, the sparse path into the in-step kernels through
    # the state's gp_Kg, learned on the inducing cells
    learn_kg = bool(model_groups and smooth and G > 1)
    gp_Xg = gp_Kg = None
    if learn_kg:
        gp_Xg = torch.eye(G, dtype=F32, device=device)[None].repeat(config.n_factors, 1, 1)
        gp_Kg = gp.normalize_kg(gp_Xg)
        if sparse_gp:
            state["gp_Kg"] = gp_Kg

    def save(it):
        from .checkpoint import save_state

        save_state(checkpoint_path, state, np.asarray(elbos), it)

    threshold = CONVERGENCE_THRESHOLDS.get(convergence_mode, 5e-4)
    # As in the reference, ``elbos`` and ``resumed_elbos`` are one list, so
    # the count of this call's own evaluations below, len(elbos) −
    # len(resumed_elbos), is always 0 and neither convergence rule fires:
    # a fit runs every sweep it is given. Kept, so that the two packages run
    # the same number of sweeps (ROADMAP.md, faults of the reference).
    elbos = resumed_elbos
    first_elbo = elbos[0] if elbos else None
    converged = False
    it = it0
    while it < n_iterations:
        if config.spikeslab_factors and it == SSZ_START:
            state = {**state, "ssz_on": torch.ones((), dtype=F32, device=device)}
        if svi_mode:
            # steps until the next host-side event; the objectives of the
            # steps in between stay on the device and are read once
            horizon = n_iterations - it
            if config.spikeslab_factors and it < SSZ_START:
                horizon = min(horizon, SSZ_START - it)  # the ssz toggle edits state
            if callback is not None and elbo_every:
                horizon = min(horizon, elbo_every - it % elbo_every)
            if checkpoint_path and checkpoint_every:
                horizon = min(horizon, checkpoint_every - it % checkpoint_every)
            chunk = max(1, min(horizon, elbo_every))
            # ρ_t = lr · (t − t₀ + 1)^(−forgetting), the Robbins-Monro step
            # schedule; batches drawn one after the other from one generator
            rhos = np.asarray(
                [
                    min(
                        1.0,
                        svi_learning_rate
                        * max(1, it + j - svi_start_stochastic + 2)
                        ** (-svi_forgetting_rate),
                    )
                    for j in range(chunk)
                ],
                np.float32,
            )
            batches = np.stack(
                [rng_batch.choice(N, size=S, replace=False) for _ in range(chunk)]
            )
            batches_dev = torch.from_numpy(batches.astype(np.int64)).to(device)
            seq = []
            for j in range(chunk):
                state, e = svi_step(state, batches_dev[j], rhos[j])
                seq.append(e)
            elbo_seq = torch.stack(seq)
            elbo_host = None  # read lazily: one device-to-host copy per chunk
            for j in range(chunk):
                itj = it + j + 1
                if not (itj % elbo_every == 0 or itj == 1 or itj == n_iterations):
                    continue
                if elbo_host is None:
                    elbo_host = elbo_seq.cpu().numpy()
                e = float(elbo_host[j])
                elbos.append(e)
                if verbose:
                    print(f"iter {itj}: ELBO {e:.4f}")
                # the minibatch objective is noisy, so convergence is judged
                # on running-window means (5 recent evaluations against the 5
                # before them)
                if first_elbo is None:
                    first_elbo = e
                    continue
                W = 5
                fresh = len(elbos) - len(resumed_elbos)
                if fresh >= 2 * W and itj - it0 >= min_iterations:
                    recent = float(np.mean(elbos[-W:]))
                    prev = float(np.mean(elbos[-2 * W: -W]))
                    delta = abs(recent - prev)
                    if delta / max(abs(first_elbo), 1e-30) * 100 < threshold:
                        converged = True
                        break
            it += chunk
            elbo = elbo_seq[-1]
            if converged:
                break
            if callback is not None and it % elbo_every == 0:
                callback(it, state, float(elbo))
            if checkpoint_path and checkpoint_every and it % checkpoint_every == 0:
                save(it)
            continue
        state, elbo = step(state)
        it += 1
        if warping and it >= smooth_start_opt and it % warping_freq == 0:
            with stage("mofa/warp(host)"):
                cov_np = _warp_groups(
                    gp_cov[:, 0].cpu().numpy(), groups,
                    state["Z_mean"].double().cpu().numpy(), int(warping_ref),
                    warping_open_begin, warping_open_end,
                )
                gp_cov = _leaf_to_tensor(cov_np.astype(np.float32)[:, None], device)
                if sparse_gp:
                    state["gp_cov"] = gp_cov
                    state["gp_cov_u"] = gp_cov[idx_u]
                else:
                    state["gp_K"] = gp.kernel_matrices(gp_cov, gp_ell, gp_scale, gvec, gp_Kg)
        if smooth and it >= smooth_start_opt and it % smooth_opt_every == 0:
            with stage("mofa/gp_hyper"):
                if sparse_gp:
                    # the grid and Kg on the inducing cells (every group is
                    # represented there by construction)
                    cu, gu = state["gp_cov_u"], state["gp_g_u"]
                    Zu, Zvu = state["Z_mean"][idx_u], state["Z_var"][idx_u]
                    gp_ell, gp_scale = gp.gp_hyper(cu, Zu, Zvu, ell_grid, scale_grid, gu)
                    state["gp_ell"] = gp_ell
                    state["gp_scale"] = gp_scale
                    if learn_kg:
                        gp_Xg, gp_Kg = gp.gp_group(cu, Zu, Zvu, gp_ell, gp_scale, gu, gp_Xg)
                        state["gp_Kg"] = gp_Kg
                else:
                    # (ℓ, s) by the grid under the independent-groups kernel,
                    # then Kg's steps with (ℓ, s) fixed
                    gp_ell, gp_scale = gp.gp_hyper(gp_cov, state["Z_mean"], state["Z_var"],
                                                   ell_grid, scale_grid, gvec)
                    if learn_kg:
                        gp_Xg, gp_Kg = gp.gp_group(gp_cov, state["Z_mean"], state["Z_var"],
                                                   gp_ell, gp_scale, gvec, gp_Xg)
                    state["gp_K"] = gp.kernel_matrices(gp_cov, gp_ell, gp_scale, gvec, gp_Kg)
        if callback is not None and it % elbo_every == 0:
            callback(it, state, float(elbo))
        if checkpoint_path and checkpoint_every and it % checkpoint_every == 0:
            save(it)
        if it % elbo_every == 0 or it == 1 or it == n_iterations:
            e = float(elbo)
            elbos.append(e)
            if verbose:
                print(f"iter {it}: ELBO {e:.4f}")
            if first_elbo is None:
                first_elbo = e
            elif (
                len(elbos) - len(resumed_elbos) > 2
                and it - it0 >= min_iterations
            ):
                # convergence judged on iterations run in this call — a
                # resumed run must not stop on the tiny delta between the
                # checkpointed tail and its own first sweep
                delta = abs(elbos[-1] - elbos[-2])
                if delta / max(abs(first_elbo), 1e-30) * 100 < threshold:
                    converged = True
                    break

    # R²/variance-explained statistics for all (group, view, factor)
    # combinations, one blocked device pass per view
    with stage("mofa/r2_stats"):
        stats = []
        onehot_t = state["G"]
        for m in range(M):
            Ym_dev = state["Y0"][m]
            Bm_dev = state["mask"][m]
            if Ym_dev is None:
                Ym_dev, _ = _clean_view(Ys[m], Bm_dev, device)
            blk = max(1024, min(65536, N))
            stats.append(tuple(
                t.cpu().numpy() for t in
                r2_stats(Ym_dev, Bm_dev, state["Z_mean"], state["SW"][m], onehot_t, blk)
            ))
            del Ym_dev

    Zm = state["Z_mean"].cpu().numpy()
    SWs = [sw.cpu().numpy() for sw in state["SW"]]

    # factors by total variance explained, descending (mofapy2 orders them
    # so before saving)
    ss_tot = sum(st[0].sum() for st in stats)
    # ss_res(m, k) = ΣY² − 2·Σ z_k (Y·B) w_k + Σ z_k² (B w_k²)
    res_k = sum(
        st[0].sum() - 2.0 * st[1].sum(axis=0) + st[2].sum(axis=0)
        for st in stats
    )
    r2k = 1.0 - res_k / max(ss_tot, 1e-30)
    order = np.argsort(-r2k)

    result = MOFAResult(
        Z=Zm[:, order],
        W=[sw[:, order] for sw in SWs],
        S=[s.cpu().numpy()[:, order] for s in state["S"]],
        alpha=state["alpha"].cpu().numpy()[:, order],
        tau=[t.cpu().numpy() for t in state["tau"]],
        theta=state["theta_mean"].cpu().numpy()[:, order],
        elbo_history=np.asarray(elbos),
        n_iterations=it,
        converged=converged,
        gp_lengthscales=gp_ell.cpu().numpy()[order] if smooth else None,
        gp_scales=gp_scale.cpu().numpy()[order] if smooth else None,
        warped_covariates=(gp_cov[:, 0].cpu().numpy() * cov_span + cov_min
                           if warping else None),
        gp_group_corr=gp_Kg.cpu().numpy()[order] if gp_Kg is not None else None,
    )

    # variance explained per factor (MOFA convention: 1 − SS_res(k)/SS_tot,
    # per view × group), from the same statistics, reordered along k
    r2pf = {}
    r2tot = {}
    for g in range(G):
        r2 = np.zeros((M, config.n_factors))
        r2t = np.zeros(M)
        for m in range(M):
            ssY_g, t1, t2, ssf = stats[m]
            st = max(float(ssY_g[g]), 1e-30)
            res_gk = ssY_g[g] - 2.0 * t1[g] + t2[g]  # (K,) before the order
            r2[m] = 1.0 - res_gk[order] / st
            r2t[m] = max(0.0, 1.0 - float(ssf[g]) / st)
        r2pf[g] = np.maximum(r2, 0.0)
        r2tot[g] = r2t
    result.r2_per_factor = r2pf
    result.r2_total = r2tot
    return result
