"""The port's MOFA+ (muon_tpu_torch.models.mofa, ops/mofa.py T17-T20,
models/checkpoint.py, tl.mofa) held to the JAX package's on the same inputs.

Inputs come from numpy seeds; the initial ``Z_mean`` is the reference's own
draw, handed to the port as ``Z0`` (the two random generators differ). The
reference's tests run with x64 on, which turns some of its float32 sums
into float64 (a Python float through ``jnp.log``, ``jnp.zeros`` without a
dtype); in production it is float32 like the port, so the sweeps are
compared under ``jax.enable_x64(False)``. Single sweeps are held leaf by
leaf from the reference's own state (rtol 1e-4, atol 1e-5: the two sum in
another order, and the spike-slab sigmoid is steep early on); whole fits by
their ELBO trace and the factors' subspace.
"""

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    import muon_tpu as mu
    from muon_tpu.models import checkpoint as jckpt
    from muon_tpu.models import mofa as jm
    from muon_tpu.ops import sparse as jsp
except ImportError:
    jax = jnp = mu = jckpt = jm = jsp = None

import muon_tpu_torch as mt
from muon_tpu_torch.models import checkpoint as tckpt
from muon_tpu_torch.models import mofa as tm
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import mofa as ops
from muon_tpu_torch.ops import sparse as tsp

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(N=60, Ds=(20, 14), K=3, G=1, masked=False, seed=0, noise=0.3):
    """Two gaussian views from planted factors; the second view loses 15 %
    of its entries to NaN when ``masked``."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(N, K))
    Ys = [(Z @ rng.normal(size=(K, D)) + noise * rng.normal(size=(N, D))).astype(np.float32)
          for D in Ds]
    masks = [None, None]
    if masked:
        masks[1] = (rng.random(Ys[1].shape) > 0.15).astype(np.float32)
        Ys[1] = np.where(masks[1] > 0, Ys[1], np.nan).astype(np.float32)
    groups = (np.arange(N) % G).astype(np.int64)
    onehot = np.eye(G, dtype=np.float32)[groups]
    return Z, Ys, masks, groups, onehot


def _configs(K, G, spikeslab=True, ard=True, seed=3):
    kw = dict(n_factors=K, likelihoods=("gaussian",) * 2, ard_weights=ard, ard_factors=ard,
              spikeslab_weights=spikeslab, n_groups=G, seed=seed)
    return jm.MOFAConfig(**kw), tm.MOFAConfig(**kw)


def _leaves(state):
    for key, val in state.items():
        for i, v in enumerate(val if isinstance(val, (list, tuple)) else [val]):
            yield f"{key}[{i}]", v


def _assert_states_close(ref, got, rtol=RTOL, atol=ATOL):
    assert set(ref) == set(got), set(ref) ^ set(got)
    got = dict(_leaves(tm.state_to_reference(got)))
    for name, r in _leaves(ref):
        g = got[name]
        if r is None:
            assert g is None, name
            continue
        r = np.asarray(r)
        assert g.dtype == np.float32 and g.shape == r.shape, (name, g.dtype, g.shape)
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


def _canonical_correlations(A, B):
    Qa, _ = np.linalg.qr(A - A.mean(0))
    Qb, _ = np.linalg.qr(B - B.mean(0))
    return np.linalg.svd(Qa.T @ Qb, compute_uv=False)


def _reference_z0(seed, N, K):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (N, K), dtype=jnp.float32))


# ---------------------------------------------------------------------------
# T17-T20: the plain twins against numpy (float64)
# ---------------------------------------------------------------------------


def _kernel_inputs(seed=0, n=70, d=33, K=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(E=f(n, d), B=(rng.random((n, d)) > 0.2).astype(np.float32), Z=f(n, K),
                SW=f(d, K), tau=np.exp(f(d)), hyper=f(4, 2, K), n=n, d=d, K=K)


@pytest.mark.parametrize("with_z", [True, False], ids=["z", "squares"])
def test_col_dot_plain_matches_numpy(with_z):
    a = _kernel_inputs(1)
    z = _t(a["Z"])[:, 2] if with_z else None  # a strided column
    got = ops.col_dot(_t(a["E"]), z).numpy()
    E = a["E"].astype(np.float64)
    ref = a["Z"][:, 2].astype(np.float64) @ E if with_z else (E * E).sum(0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_row_dot_plain_matches_numpy(masked):
    a = _kernel_inputs(2)
    E, SW, B = _t(a["E"]), _t(a["SW"]), _t(a["B"])
    ref = a["E"].astype(np.float64) @ a["SW"][:, 1].astype(np.float64)
    if not masked:
        np.testing.assert_allclose(ops.row_dot(E, SW[:, 1]).numpy(), ref, rtol=1e-5, atol=1e-5)
        return
    r, pb, qb = ops.row_dot(E, SW[:, 1], B, SW[:, 0], SW[:, 3])
    np.testing.assert_allclose(r.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pb.numpy(), a["B"].astype(np.float64) @ a["SW"][:, 0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(qb.numpy(), a["B"].astype(np.float64) @ a["SW"][:, 3],
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="come together"):
        ops.row_dot(E, SW[:, 1], B)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_rank1_update_plain_matches_numpy(masked):
    a = _kernel_inputs(3)
    E = _t(a["E"]).clone()
    out = ops.rank1_update(E, _t(a["Z"])[:, 0], _t(a["SW"])[:, 2], _t(a["B"]) if masked else None)
    assert out.data_ptr() == E.data_ptr()  # in place
    corr = np.outer(a["Z"][:, 0], a["SW"][:, 2])
    ref = a["E"] + (corr * a["B"] if masked else corr)
    np.testing.assert_allclose(E.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("spikeslab", [True, False], ids=["spikeslab", "dense"])
@pytest.mark.parametrize("scale", [None, 2.5], ids=["full", "scaled"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_w_posterior_plain_matches_numpy(spikeslab, scale, masked):
    a = _kernel_inputs(4)
    d, K, k, m = a["d"], a["K"], 1, 1
    rng = np.random.default_rng(5)
    u = rng.normal(size=d).astype(np.float32)
    z2 = np.abs(rng.normal(size=(K, d))).astype(np.float32) + 1.0
    zz = (0.5 * z2).astype(np.float32)
    hyper = [_t(h) for h in a["hyper"]]  # alpha, ln_alpha, theta_ln, theta_ln1m
    hyper[0] = hyper[0].abs() + 0.5
    W = [_t(rng.normal(size=(d, K)).astype(np.float32)) for _ in range(3)] + [_t(a["SW"]).clone()]
    sw_old = a["SW"][:, k].astype(np.float64)
    z2_k = _t(z2)[k] if masked else _t(z2)[k, 0]  # (D,) or a 0-dim view
    zz_k = _t(zz)[k] if masked else _t(zz)[k, 0]
    delta = ops.w_posterior(_t(u), _t(a["tau"]), z2_k, zz_k, *hyper, m, k, *W,
                            spikeslab=spikeslab, scale=scale).numpy()

    tau = a["tau"].astype(np.float64)
    z2n = z2[k].astype(np.float64) if masked else float(z2[k, 0])
    zzn = zz[k].astype(np.float64) if masked else float(zz[k, 0])
    al, la, th, th1 = (float(h[m, k]) for h in hyper)
    a_ = tau * z2n + al
    b_ = tau * (u + sw_old * zzn) if scale is None else tau * scale * u + tau * sw_old * zzn
    lam = th - th1 + 0.5 * la - 0.5 * np.log(a_) + 0.5 * b_ * b_ / a_
    s = 1.0 / (1.0 + np.exp(-lam)) if spikeslab else np.ones(d)
    for got, ref in zip(W, (b_ / a_, 1.0 / a_, s, s * b_ / a_)):
        np.testing.assert_allclose(got[:, k].numpy(), ref, rtol=1e-5, atol=1e-6)
        assert got.shape == (d, K)
    np.testing.assert_allclose(delta, sw_old - s * b_ / a_, rtol=1e-5, atol=1e-5)
    # the other columns are untouched
    np.testing.assert_array_equal(W[3][:, 0].numpy(), a["SW"][:, 0])


def test_col_sums_matches_reference():
    from scipy import sparse as sp

    rng = np.random.default_rng(6)
    X = sp.random(80, 37, density=0.2, format="csr", random_state=7, dtype=np.float32)
    X.data = rng.integers(1, 5, size=X.nnz).astype(np.float32)
    got = tsp.col_sums(tsp.from_scipy(X, CPU)).numpy()
    ref = np.asarray(jsp.col_sums(jsp.from_scipy(X)))
    assert got.dtype == np.float32 and got.shape == (37,)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(X.sum(axis=0)).ravel(), rtol=1e-6)


# ---------------------------------------------------------------------------
# the initial state, one sweep, one SVI step, the R² statistics
# ---------------------------------------------------------------------------


def _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data=False):
    with jax.enable_x64(False):
        ref = jm._init_state(Ys, masks, onehot, jcfg, keep_data=keep_data)
    got = tm._init_state(Ys, masks, onehot, tcfg, keep_data=keep_data,
                         Z0=np.asarray(ref["Z_mean"]), device=CPU)
    return ref, got


@pytest.mark.parametrize("case", ["unmasked", "masked", "keep_data", "keep_data_masked"])
def test_init_state_matches_reference(case):
    _, Ys, masks, _, onehot = _problem(G=2, masked="masked" in case)
    jcfg, tcfg = _configs(3, 2)
    ref, got = _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data="keep_data" in case)
    _assert_states_close(ref, got, rtol=1e-6, atol=1e-6)
    assert ("tau_a" in got) == ("keep_data" in case)


def test_init_state_draws_z0_from_the_seed():
    _, Ys, masks, _, onehot = _problem()
    _, tcfg = _configs(3, 1, seed=11)
    a = tm._init_state(Ys, masks, onehot, tcfg, device=CPU)["Z_mean"]
    b = tm._init_state(Ys, masks, onehot, tcfg, device=CPU)["Z_mean"]
    gen = torch.Generator().manual_seed(11)
    assert torch.equal(a, b) and torch.equal(a, torch.randn((60, 3), generator=gen))
    with pytest.raises(ValueError, match="Z0 must have shape"):
        tm._init_state(Ys, masks, onehot, tcfg, Z0=np.zeros((5, 3), np.float32), device=CPU)


def _sweep_case(Ys, masks, onehot, jcfg, tcfg, warm=2):
    """The reference's state after ``warm`` sweeps, then one sweep of each
    package from it."""
    N, Ds = Ys[0].shape[0], [Y.shape[1] for Y in Ys]
    masked = [m is not None for m in masks]
    with jax.enable_x64(False):
        step = jax.jit(jm._make_step(jcfg, Ds, N, masked))
        state = jm._init_state(Ys, masks, onehot, jcfg)
        for _ in range(warm):
            state, _ = step(state)
        ref, ref_elbo = step(state)
    start = tm.state_from_reference(state, CPU)
    before = {k: v.clone() for k, v in _leaves(start) if v is not None}
    got, elbo = tm.make_step(tcfg, Ds, N, masked)(start)
    # the sweep works on copies: the state it was given is as it was
    for name, v in _leaves(start):
        assert v is None or torch.equal(v, before[name]), name
    _assert_states_close(ref, got)
    assert elbo.dtype == torch.float32 and elbo.dim() == 0
    np.testing.assert_allclose(float(elbo), float(ref_elbo), rtol=RTOL)


@pytest.mark.parametrize("ard", [True, False], ids=["ard", "no_ard"])
@pytest.mark.parametrize("spikeslab", [True, False], ids=["spikeslab", "dense"])
@pytest.mark.parametrize("G", [1, 2], ids=["1group", "2groups"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_full_batch_sweep_matches_reference(masked, G, spikeslab, ard):
    _, Ys, masks, _, onehot = _problem(G=G, masked=masked, seed=G + 2 * masked)
    _sweep_case(Ys, masks, onehot, *_configs(3, G, spikeslab, ard))


def test_toy_problem_sweep_matches_reference():
    # the shapes of the repo's entry point (one VB sweep): N = 64, D = (48, 32),
    # K = 4, G = 2, the second view masked; from the initial state itself
    rng = np.random.default_rng(0)
    N, Ds, K, G = 64, (48, 32), 4, 2
    Z = rng.normal(size=(N, K)).astype(np.float32)
    Ys = []
    for D in Ds:
        W = rng.normal(size=(D, K)).astype(np.float32)
        Ys.append(Z @ W.T + 0.1 * rng.normal(size=(N, D)).astype(np.float32))
    masks = [None, (rng.random(size=Ys[1].shape) > 0.1).astype(np.float32)]
    Ys[1] = np.where(masks[1] > 0, Ys[1], np.nan)
    onehot = np.eye(G, dtype=np.float32)[np.arange(N) % G]
    _sweep_case(Ys, masks, onehot, *_configs(K, G, seed=0), warm=0)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_svi_step_matches_reference(masked):
    # two steps with the same batches and ρ, the second from the first's state
    _, Ys, masks, _, onehot = _problem(G=2, masked=masked, seed=5)
    jcfg, tcfg = _configs(3, 2)
    N, Ds, S = 60, [20, 14], 24
    rng = np.random.default_rng(9)
    with jax.enable_x64(False):
        ref, got = _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data=True)
        jstep = jax.jit(jm._make_svi_step(jcfg, Ds, N, S, ["gaussian"] * 2))
        tstep = tm.make_svi_step(tcfg, Ds, N, S)
        for rho in (1.0, 0.70710677):
            batch = rng.choice(N, size=S, replace=False)
            ref, ref_obj = jstep(ref, jnp.asarray(batch.astype(np.int32)),
                                 jnp.asarray(np.float32(rho)))
            got, obj = tstep(got, _t(batch.astype(np.int64)), np.float32(rho))
            _assert_states_close(ref, got)
            np.testing.assert_allclose(float(obj), float(ref_obj), rtol=RTOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_r2_stats_match_reference(masked):
    rng = np.random.default_rng(12)
    N, D, K, G = 90, 17, 4, 3
    Y = rng.normal(size=(N, D)).astype(np.float32)
    B = (rng.random((N, D)) > 0.2).astype(np.float32)
    Ym = Y * B if masked else Y
    Z, W = rng.normal(size=(N, K)).astype(np.float32), rng.normal(size=(D, K)).astype(np.float32)
    onehot = np.eye(G, dtype=np.float32)[rng.integers(0, G, N)]
    ref = jm._r2_stats_fn()(jnp.asarray(Ym), jnp.asarray(B if masked else Ym), jnp.asarray(Z),
                            jnp.asarray(W), jnp.asarray(onehot), 32, masked)
    got = tm.r2_stats(_t(Ym), _t(B) if masked else None, _t(Z), _t(W), _t(onehot), 32)
    for g, r, shape in zip(got, ref, [(G,), (G, K), (G, K), (G,)]):
        assert g.dtype == torch.float64 and tuple(g.shape) == shape
        # rtol 1e-5 of the statistic's scale: an entry of t1 is a float32 sum
        # of terms of both signs, summed in another order by the two products
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())


def test_state_round_trip():
    _, Ys, masks, _, onehot = _problem(masked=True)
    jcfg, _ = _configs(3, 1)
    with jax.enable_x64(False):
        ref = jm._init_state(Ys, masks, onehot, jcfg, keep_data=True)
    back = tm.state_to_reference(tm.state_from_reference(ref, CPU))
    for (name, r), (_, b) in zip(_leaves(ref), _leaves(back)):
        assert (r is None and b is None) or np.array_equal(np.asarray(r), b), name


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------


def _fit_both(svi, n_iter=30, **kw):
    Z, Ys, _, _, _ = _problem(N=200, Ds=(40, 30), K=3, seed=21, noise=0.5)
    jcfg, tcfg = _configs(3, 1, seed=4)
    common = dict(n_iterations=n_iter, min_iterations=n_iter, convergence_mode="slow",
                  elbo_every=1, svi_mode=svi, svi_batch_fraction=0.5, **kw)
    with jax.enable_x64(False):
        ref = jm.fit_mofa(Ys, jcfg, **common)
    got = tm.fit_mofa(Ys, tcfg, Z0=_reference_z0(4, 200, 3), device=CPU, **common)
    return Z, ref, got


@pytest.mark.parametrize("svi", [False, True], ids=["full_batch", "svi"])
def test_fit_matches_reference(svi):
    # 30 fixed sweeps from the same start: the ELBO trace at rtol 1e-3, the
    # factors' subspace (smallest canonical correlation above 0.99), the same
    # factor order (column by column), and the planted factors recovered
    _kernels.reset_launch_counts()
    Z, ref, got = _fit_both(svi)
    assert not any(_kernels.launch_counts().values())  # CPU tensors: plain versions
    assert got.n_iterations == ref.n_iterations == 30 and not got.converged
    assert got.elbo_history.shape == ref.elbo_history.shape == (30,)
    np.testing.assert_allclose(got.elbo_history, ref.elbo_history, rtol=1e-3)
    assert _canonical_correlations(got.Z, ref.Z).min() > 0.99
    for k in range(3):
        assert abs(np.corrcoef(got.Z[:, k], ref.Z[:, k])[0, 1]) > 0.99, k
    assert _canonical_correlations(got.Z, Z).min() > 0.9
    assert got.Z.shape == (200, 3) and [w.shape for w in got.W] == [(40, 3), (30, 3)]
    for g, r in zip(got.W + got.tau + [got.alpha, got.theta], ref.W + ref.tau + [ref.alpha,
                                                                                   ref.theta]):
        assert g.shape == np.asarray(r).shape
    np.testing.assert_allclose(got.r2_per_factor[0], ref.r2_per_factor[0], atol=1e-3)
    np.testing.assert_allclose(got.r2_total[0], ref.r2_total[0], atol=1e-3)


def test_full_batch_elbo_rises_and_stops_where_the_reference_stops():
    # coordinate ascent: the ELBO never falls by more than float32 rounding
    # (1e-5 relative). The reference counts the evaluations of this call
    # as len(elbos) - len(resumed_elbos) over one and the same list, so its
    # convergence rule never fires and it runs every sweep it is given; the
    # port keeps that, so both run the same number of sweeps
    Z, Ys, _, _, _ = _problem(N=200, Ds=(40, 30), K=3, seed=22, noise=0.5)
    res = tm.fit_mofa(Ys, tm.MOFAConfig(n_factors=3), n_iterations=120, elbo_every=1,
                      device=CPU)
    with jax.enable_x64(False):
        ref = jm.fit_mofa(Ys, jm.MOFAConfig(n_factors=3), n_iterations=120, elbo_every=1)
    e = res.elbo_history
    assert (res.converged, res.n_iterations) == (ref.converged, ref.n_iterations) == (False, 120)
    assert (np.diff(e) >= -1e-5 * np.abs(e[:-1])).all()
    assert _canonical_correlations(res.Z, Z).min() > 0.9


def test_device_views_and_groups():
    # views handed as tensors (one with NaN), two groups: the same fit as from numpy
    _, Ys, _, groups, _ = _problem(G=2, masked=True, seed=8)
    cfg = tm.MOFAConfig(n_factors=3, seed=2)
    kw = dict(groups=groups, n_iterations=5, min_iterations=5, elbo_every=1, device=CPU)
    a = tm.fit_mofa(Ys, cfg, **kw)
    b = tm.fit_mofa([_t(Y) for Y in Ys], cfg, **kw)
    np.testing.assert_array_equal(a.Z, b.Z)
    assert sorted(a.r2_per_factor) == [0, 1] and a.r2_per_factor[1].shape == (2, 3)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


_Y = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
_COV = np.linspace(0, 1, 20)


@pytest.mark.parametrize("kwargs, cfg, exc, match", [
    (dict(mesh=object()), dict(), NotImplementedError, "mesh"),
    # the reference's own refusals, with its messages
    (dict(smooth_covariate=_COV, svi_mode=True), dict(), NotImplementedError,
     "smooth factors \\(MEFISTO\\) with svi_mode are not supported yet"),
    (dict(smooth_covariate=_COV), dict(spikeslab_factors=True), NotImplementedError,
     "spikeslab_factors is not supported together with smooth"),
    (dict(sparse_gp=True), dict(), ValueError, "sparse_gp requires smooth_covariate"),
    (dict(warping=True), dict(), ValueError, "warping requires smooth_covariate"),
    (dict(warping=True, smooth_covariate=_COV), dict(), ValueError,
     "warping requires at least two groups"),
], ids=["mesh", "smooth_svi", "smooth_spikeslab_factors", "sparse_gp_alone", "warping_alone",
        "warping_one_group"])
def test_fit_mofa_refuses(kwargs, cfg, exc, match):
    with pytest.raises(exc, match=match):
        tm.fit_mofa([_Y, _Y], tm.MOFAConfig(n_factors=2, **cfg), n_iterations=2, device=CPU,
                    **kwargs)


@pytest.mark.parametrize("kwargs, exc", [
    (dict(smooth_covariate=_COV, svi_mode=True), NotImplementedError),
    (dict(sparse_gp=True), ValueError),
    (dict(warping=True), ValueError),
], ids=["smooth_svi", "sparse_gp_alone", "warping_alone"])
def test_reference_refuses_the_same(kwargs, exc):
    with pytest.raises(exc) as ref:
        jm.fit_mofa([_Y, _Y], jm.MOFAConfig(n_factors=2), n_iterations=2, **kwargs)
    with pytest.raises(exc) as got:
        tm.fit_mofa([_Y, _Y], tm.MOFAConfig(n_factors=2), n_iterations=2, device=CPU, **kwargs)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# checkpoints cross both ways
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    # 6 sweeps in one package, checkpointed; the other resumes to 12 and
    # lands where its own 12 sweeps from the same start land
    _, Ys, _, _, _ = _problem(N=120, Ds=(25, 20), K=3, seed=31, noise=0.5)
    jcfg, tcfg = _configs(3, 1, seed=6)
    path = str(tmp_path / "state.npz")
    Z0 = _reference_z0(6, 120, 3)
    kw = dict(convergence_mode="slow", elbo_every=1)
    with jax.enable_x64(False):
        if writer == "port":
            tm.fit_mofa(Ys, tcfg, n_iterations=6, min_iterations=6, checkpoint_path=path,
                        checkpoint_every=6, Z0=Z0, device=CPU, **kw)
            res = jm.fit_mofa(Ys, jcfg, n_iterations=12, min_iterations=12, resume_from=path,
                              **kw)
            straight = jm.fit_mofa(Ys, jcfg, n_iterations=12, min_iterations=12, **kw)
        else:
            jm.fit_mofa(Ys, jcfg, n_iterations=6, min_iterations=6, checkpoint_path=path,
                        checkpoint_every=6, **kw)
            res = tm.fit_mofa(Ys, tcfg, n_iterations=12, min_iterations=12, resume_from=path,
                              device=CPU, **kw)
            straight = tm.fit_mofa(Ys, tcfg, n_iterations=12, min_iterations=12, Z0=Z0,
                                   device=CPU, **kw)
    with np.load(path) as data:
        keys = set(data.files)
    assert {"meta:iteration", "meta:elbo_history", "leaf:Z_mean", "list:E:0", "list:E:1",
            "list:mask:0", "list:Y0:1", "leaf:theta_mean"} <= keys
    assert res.n_iterations == 12
    # the checkpoint holds the trace up to the sweep before it was written
    assert len(res.elbo_history) == len(straight.elbo_history) - 1 == 11
    np.testing.assert_allclose(res.elbo_history, np.delete(straight.elbo_history, 5), rtol=1e-3)
    assert _canonical_correlations(res.Z, straight.Z).min() > 0.99


def test_checkpoint_files_load_in_either_package(tmp_path):
    _, Ys, masks, _, onehot = _problem(masked=True)
    jcfg, tcfg = _configs(3, 1)
    ref, got = _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data=True)
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    tckpt.save_state(p1, got, [1.0, 2.0], 7)
    jckpt.save_state(p2, ref, [1.0, 2.0], 7)
    for loader in (tckpt.load_state, jckpt.load_state):
        for path in (p1, p2):
            state, elbos, it = loader(path)
            assert it == 7 and list(elbos) == [1.0, 2.0]
            loaded = dict(_leaves(state))
            for name, r in _leaves(ref):
                v = loaded[name]
                assert (r is None and v is None) or np.allclose(np.asarray(r), np.asarray(v),
                                                                rtol=1e-6, atol=1e-6), name


# ---------------------------------------------------------------------------
# tl.mofa of both packages on one MuData
# ---------------------------------------------------------------------------


def _mudata(groups=False):
    import pandas as pd

    rng = np.random.default_rng(40)
    n, k = 80, 3
    Z = rng.normal(size=(n, k))
    names = [f"cell{i}" for i in range(n)]
    mods = {}
    for view, d in (("rna", 30), ("prot", 18)):
        Y = Z @ rng.normal(size=(k, d)) + 0.5 * rng.normal(size=(n, d))
        mods[view] = mu.AnnData(X=Y.astype(np.float32), obs=pd.DataFrame(index=names))
    mdata = mu.MuData(mods)
    if groups:
        mdata.obs["batch"] = ["a" if i % 3 else "b" for i in range(n)]
    return mdata


def _same_params(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _same_params(a[key], b[key])
        elif isinstance(a[key], np.ndarray):
            assert list(a[key]) == list(b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("groups", [False, True], ids=["one_group", "two_groups"])
def test_tl_mofa_matches_reference(groups, tmp_path, monkeypatch):
    import h5py

    ref_md, got_md = _mudata(groups), _mudata(groups)
    kw = dict(n_factors=3, n_iterations=40, convergence_mode="slow", seed=5,
              groups_label="batch" if groups else None)
    monkeypatch.setattr(tm, "_draw_z0",
                        lambda N, K, seed, device: _t(_reference_z0(seed, N, K)).to(device))
    with jax.enable_x64(False):
        mu.tl.mofa(ref_md, outfile=str(tmp_path / "ref.hdf5"), **kw)
    assert mt.tl.mofa(got_md, outfile=str(tmp_path / "got.hdf5"), device="cpu", **kw) is None

    assert got_md.obsm["X_mofa"].shape == ref_md.obsm["X_mofa"].shape == (80, 3)
    assert got_md.varm["LFs"].shape == ref_md.varm["LFs"].shape == (48, 3)
    assert _canonical_correlations(got_md.obsm["X_mofa"], ref_md.obsm["X_mofa"]).min() > 0.99
    _same_params(got_md.uns["mofa"]["params"], ref_md.uns["mofa"]["params"])
    gv, rv = got_md.uns["mofa"]["variance"], ref_md.uns["mofa"]["variance"]
    assert gv.keys() == rv.keys() == {"rna", "prot"}
    for view in gv:
        if groups:
            assert gv[view].keys() == rv[view].keys() == {"a", "b"}
            for g in gv[view]:
                np.testing.assert_allclose(gv[view][g], rv[view][g], atol=1e-3)
        else:
            np.testing.assert_allclose(gv[view], rv[view], atol=1e-3)
    # the model files have one layout
    with h5py.File(tmp_path / "ref.hdf5") as fr, h5py.File(tmp_path / "got.hdf5") as fg:
        names_r, names_g = [], []
        fr.visit(names_r.append)
        fg.visit(names_g.append)
        assert names_g == names_r
        assert fg["expectations/W/rna"].shape == fr["expectations/W/rna"].shape == (3, 30)
    assert not (tmp_path / "got.hdf5.interrupted.npz").exists()


def test_tl_mofa_takes_one_anndata_and_copies():
    ad = _mudata().mod["rna"]
    out = mt.tl.mofa(ad, n_factors=2, n_iterations=5, copy=True, device="cpu")
    assert "X_mofa" not in ad.obsm and out.obsm["X_mofa"].shape == (80, 2)
    assert out.varm["LFs"].shape == (30, 2)
    assert out.uns["mofa"]["variance"].keys() == {"data"}
    with pytest.raises(TypeError, match="Expected an MuData"):
        mt.tl.mofa(np.zeros((4, 4)), device="cpu")


@pytest.mark.parametrize("kwargs, match", [
    (dict(mesh=object()), "mesh"),
], ids=["mesh"])
def test_tl_mofa_refuses(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        mt.tl.mofa(_mudata(), n_factors=2, device="cpu", **kwargs)


def test_tl_mofa_refuses_a_guessed_count_likelihood():
    # counts are guessed as poisson and fitted through its bound, never as
    # gaussian; an unknown likelihood is refused
    md = _mudata()
    md.mod["prot"].X = np.random.default_rng(0).poisson(3.0, size=(80, 18)).astype(np.float32)
    mt.tl.mofa(md, n_factors=2, n_iterations=3, device="cpu")
    assert list(md.uns["mofa"]["params"]["data"]["likelihoods"]) == ["gaussian", "poisson"]
    with pytest.raises(ValueError, match="Unknown likelihood"):
        mt.tl.mofa(md, n_factors=2, likelihoods="gamma", device="cpu")


# ---------------------------------------------------------------------------
# on the card: T17-T20 against their plain versions (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launched(name, fn, times=1):
    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.launch_counts()[name] == times
    return out


def _card_inputs(cuda, n, d, K=5, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    B = (torch.rand((n, d), generator=gen, device=cuda) > 0.2).float()
    return r(n, d), B, r(n, K), r(d, K)


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(1000, 300), (257, 33), (5000, 256)])
def test_gpu_col_dot_matches_plain(cuda, n, d):
    # another order of float32 sums: within 1e-5 of Σ|z||E|
    E, _, Z, _ = _card_inputs(cuda, n, d)
    got = _launched("mofa_col_dot", lambda: ops.col_dot(E, Z[:, 2]))
    tol = 1e-5 * (Z[:, 2].abs() @ E.abs())
    assert bool(((got - ops.col_dot_plain(E, Z[:, 2])).abs() <= tol).all())
    got = _launched("mofa_col_dot", lambda: ops.col_dot(E))
    torch.testing.assert_close(got, ops.col_dot_plain(E), rtol=1e-5, atol=0)
    assert torch.equal(got, ops.col_dot(E))  # a fixed order: the same bits again


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(1000, 300), (257, 33), (5000, 256)])
def test_gpu_row_dot_matches_plain(cuda, n, d):
    E, B, _, SW = _card_inputs(cuda, n, d, seed=1)
    got = _launched("mofa_row_dot", lambda: ops.row_dot(E, SW[:, 1]))
    tol = 1e-5 * (E.abs() @ SW[:, 1].abs())
    assert bool(((got - ops.row_dot_plain(E, SW[:, 1])).abs() <= tol).all())
    got = _launched("mofa_row_dot", lambda: ops.row_dot(E, SW[:, 1], B, SW[:, 0], SW[:, 3]))
    ref = ops.row_dot_plain(E, SW[:, 1], B, SW[:, 0], SW[:, 3])
    for g, r, scale in zip(got, ref, (tol, 1e-5 * (B @ SW[:, 0].abs()),
                                      1e-5 * (B @ SW[:, 3].abs()))):
        assert bool(((g - r).abs() <= scale).all())


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(1000, 300), (257, 33)], ids=["16_bytes", "4_bytes"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_gpu_rank1_update_matches_plain(cuda, masked, n, d):
    # one product and one sum per entry, rounded as the plain version's; a row
    # length that is a multiple of 4 takes 16 bytes a thread, another 4
    E, B, Z, SW = _card_inputs(cuda, n, d, seed=2)
    ref = ops.rank1_update_plain(E.clone(), Z[:, 1], SW[:, 2], B if masked else None)
    got = E.clone()
    _launched("mofa_rank1_update", lambda: ops.rank1_update(got, Z[:, 1], SW[:, 2],
                                                            B if masked else None))
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("spikeslab", [True, False], ids=["spikeslab", "dense"])
@pytest.mark.parametrize("scale", [None, 20.0], ids=["full", "scaled"])
def test_gpu_w_posterior_matches_plain(cuda, spikeslab, scale):
    d, K, m, k = 300, 5, 1, 3
    gen = torch.Generator(device=cuda).manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    u, tau = r(d), r(d).exp()
    z2, zz = r(K, d).abs() + 1.0, r(K, d).abs()
    hyper = [r(2, K).abs() + 0.5, r(2, K), r(2, K), r(2, K)]
    W = [r(d, K) for _ in range(4)]
    for z2_k, zz_k in ((z2[k], zz[k]), (z2[k, 0], zz[k, 0])):
        Wg, Wp = [w.clone() for w in W], [w.clone() for w in W]
        got = _launched("mofa_w_posterior", lambda: ops.w_posterior(
            u, tau, z2_k, zz_k, *hyper, m, k, *Wg, spikeslab=spikeslab, scale=scale))
        ref = ops.w_posterior_plain(u, tau, z2_k, zz_k, *hyper, m, k, *Wp,
                                    spikeslab=spikeslab, scale=scale)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        for g, p in zip(Wg, Wp):
            torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_gpu_wrappers_refuse_bad_input(cuda):
    E, B, Z, SW = _card_inputs(cuda, 64, 20)
    with pytest.raises(ValueError):
        ops.col_dot(E.double())
    with pytest.raises(ValueError):
        ops.col_dot(E.T)  # not contiguous
    with pytest.raises(ValueError):
        ops.col_dot(E, Z[:10, 0])
    with pytest.raises(ValueError):
        ops.row_dot(E, SW[:, 0], B[:10], SW[:, 1], SW[:, 2])
    with pytest.raises(ValueError):
        ops.rank1_update(E, Z[:, 0].cpu(), SW[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("svi", [False, True], ids=["full_batch", "svi"])
def test_gpu_fit_matches_cpu(cuda, svi):
    # the same fit through the kernels on the card and through the plain
    # versions on the CPU; the launches follow K·M + M, K·M, K·M, 2·K·M per sweep
    _, Ys, _, groups, _ = _problem(N=600, Ds=(120, 80), K=4, G=2, masked=True, seed=50)
    cfg = tm.MOFAConfig(n_factors=4, seed=1)
    kw = dict(groups=groups, n_iterations=10, min_iterations=10, elbo_every=1,
              convergence_mode="slow", svi_mode=svi)
    cpu = tm.fit_mofa(Ys, cfg, device=CPU, Z0=_Z0_600, **kw)
    _kernels.reset_launch_counts()
    gpu = tm.fit_mofa(Ys, cfg, device=cuda, Z0=_Z0_600, **kw)
    counts = _kernels.launch_counts()
    K, M, sweeps = 4, 2, 10
    assert counts["mofa_col_dot"] == sweeps * (K * M + M)
    assert counts["mofa_w_posterior"] == counts["mofa_row_dot"] == sweeps * K * M
    assert counts["mofa_rank1_update"] == sweeps * 2 * K * M
    np.testing.assert_allclose(gpu.elbo_history, cpu.elbo_history, rtol=1e-3)
    assert _canonical_correlations(gpu.Z, cpu.Z).min() > 0.99


_Z0_600 = np.random.default_rng(77).normal(size=(600, 4)).astype(np.float32)
