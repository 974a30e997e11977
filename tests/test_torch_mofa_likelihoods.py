"""The port's bernoulli and poisson views and spike-slab factors
(muon_tpu_torch.models.mofa, ops/mofa.py T23) held to the JAX package's on
the same inputs.

Inputs come from numpy seeds; the reference's draws (Z and the random W
starts of its ``fold_in(key, 7)`` stream) are handed to the port as ``Z0``
and ``W0``. The reference runs under ``jax.enable_x64(False)``, float32
as in production. Single sweeps and SVI steps are held leaf by leaf from
the reference's own state at rtol 1e-4, atol 1e-5 (the two sum F = Zm·SWᵀ
and the row and column sums in another order); whole fits by their
invariants: the ELBO trace, the factors' subspace, the planted factors.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    import muon_tpu as mu
    from muon_tpu.models import mofa as jm
except ImportError:
    jax = jnp = mu = jm = None

import muon_tpu_torch as mt
from muon_tpu_torch.models import mofa as tm
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import mofa as ops
from test_torch_mofa import (CPU, _assert_states_close, _canonical_correlations,
                                   _launched, _leaves, _reference_z0, _t, cuda)  # noqa: F401

BOUND = ("bernoulli", "poisson")


def _reference_w0(seed, Ds, K):
    """The reference's random W starts: view m draws from split(fold_in(key, 7))[m]."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 7), max(len(Ds), 1))
    return [np.asarray(jax.random.normal(keys[m], (D, K), dtype=jnp.float32))
            for m, D in enumerate(Ds)]


def _simulate(seed=0, N=90, K=3, Ds=(30, 24, 20)):
    """Planted factors Z; a bernoulli view from logits Z·W (scale 1.2), a
    poisson view from the rate softplus(Z·W) (scale 0.8) and a gaussian view."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(N, K))
    logits = Z @ rng.normal(scale=1.2, size=(K, Ds[0]))
    Yb = (rng.random(logits.shape) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    Yp = rng.poisson(np.log1p(np.exp(Z @ rng.normal(scale=0.8, size=(K, Ds[1]))))
                     ).astype(np.float32)
    Yg = (Z @ rng.normal(size=(K, Ds[2])) + 0.3 * rng.normal(size=(N, Ds[2]))).astype(np.float32)
    return Z, {"bernoulli": Yb, "poisson": Yp, "gaussian": Yg}


def _case(liks, ssz=False, G=2, seed=0, masked_bernoulli=False, N=90, K=3):
    Z, views = _simulate(seed, N, K)
    Ys = [views[lk].copy() for lk in liks]
    masks = [None] * len(Ys)
    if masked_bernoulli:
        m = liks.index("bernoulli")
        masks[m] = (np.random.default_rng(seed + 1).random(Ys[m].shape) > 0.2).astype(np.float32)
        Ys[m] = np.where(masks[m] > 0, Ys[m], np.nan).astype(np.float32)
    onehot = np.eye(G, dtype=np.float32)[np.arange(N) % G]
    kw = dict(n_factors=K, likelihoods=tuple(liks), n_groups=G, seed=3, spikeslab_factors=ssz)
    return Z, Ys, masks, onehot, jm.MOFAConfig(**kw), tm.MOFAConfig(**kw)


# ---------------------------------------------------------------------------
# T23: the plain twin against numpy (float64)
# ---------------------------------------------------------------------------


def _bound_inputs(seed=0, n=50, d=23, K=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    Zm, SW = f(n, K), 0.6 * f(d, K)
    Zv = np.exp(f(n, K) - 2).astype(np.float32)
    SWW = (SW * SW + np.exp(f(d, K) - 3)).astype(np.float32)
    M01 = (rng.random((n, d)) > 0.2).astype(np.float32)
    return dict(Zm=Zm, SW=SW, z2=(Zv + Zm * Zm).astype(np.float32), SWW=SWW, M01=M01,
                Yb=(rng.random((n, d)) > 0.5).astype(np.float32) * M01,
                Yp=rng.poisson(2.0, size=(n, d)).astype(np.float32) * M01,
                kappa=(0.25 + 0.17 * rng.integers(1, 9, size=d)).astype(np.float32))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("lik", BOUND)
def test_bound_refresh_plain_matches_numpy(lik, masked):
    a = _bound_inputs(1)
    M = a["M01"] if masked else None
    Y = a["Yb"] if lik == "bernoulli" else a["Yp"]
    kw = dict(z2=_t(a["z2"]), SWW=_t(a["SWW"])) if lik == "bernoulli" else dict(kappa=_t(a["kappa"]))
    E, T, tgt = ops.bound_refresh(lik, _t(a["Zm"]), _t(a["SW"]), _t(Y), None if M is None else _t(M),
                                  target=True, **kw)
    m = np.ones_like(Y, dtype=np.float64) if M is None else M.astype(np.float64)
    Zm, SW, y = (a["Zm"].astype(np.float64), a["SW"].astype(np.float64),
                 Y.astype(np.float64))
    F = Zm @ SW.T
    if lik == "bernoulli":
        e2 = F * F + a["z2"].astype(np.float64) @ a["SWW"].T - (Zm * Zm) @ (SW * SW).T
        zeta = np.sqrt(np.maximum(e2, 1e-10))
        Tr = 2.0 * np.where(zeta > 1e-4, np.tanh(zeta / 2) / (4 * zeta), 0.125) * m
        Er, tr = (y - 0.5 * m) - Tr * F, y - 0.5 * m
        np.testing.assert_allclose(T.numpy(), Tr, rtol=1e-5, atol=1e-6)
    else:
        rate = np.logaddexp(F, 0.0)
        pseudo = F - (1 / (1 + np.exp(-F))) * (1 - y / np.maximum(rate, 1e-6)) / a["kappa"]
        Er, tr = (pseudo - F) * m, pseudo * m
        assert T is None if M is None else torch.equal(T, _t(M))  # the mask itself
    # the variance terms of e2 cancel: 1e-5 of the terms' scale
    np.testing.assert_allclose(E.numpy(), Er, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tgt.numpy(), tr, rtol=1e-5, atol=1e-5)
    assert E.dtype == torch.float32 and E.shape == Y.shape


def test_bound_refresh_refuses_a_gaussian_view_and_missing_moments():
    a = _bound_inputs(2)
    with pytest.raises(ValueError, match="bernoulli or poisson"):
        ops.bound_refresh("gaussian", _t(a["Zm"]), _t(a["SW"]), _t(a["Yb"]))
    with pytest.raises(ValueError, match="bernoulli needs z2"):
        ops.bound_refresh("bernoulli", _t(a["Zm"]), _t(a["SW"]), _t(a["Yb"]))
    with pytest.raises(ValueError, match="poisson needs kappa"):
        ops.bound_refresh("poisson", _t(a["Zm"]), _t(a["SW"]), _t(a["Yp"]), z2=_t(a["z2"]),
                          SWW=_t(a["SWW"]))


# ---------------------------------------------------------------------------
# the initial state, one sweep, one SVI step
# ---------------------------------------------------------------------------


def _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data=False):
    liks = list(jcfg.likelihoods)
    with jax.enable_x64(False):
        ref = jm._init_state(Ys, masks, onehot, jcfg, liks, keep_data=keep_data)
    got = tm._init_state(Ys, masks, onehot, tcfg, liks, keep_data=keep_data,
                         Z0=np.asarray(ref["Z_mean"]),
                         W0=_reference_w0(jcfg.seed, [Y.shape[1] for Y in Ys],
                                          jcfg.n_factors), device=CPU)
    return ref, got


@pytest.mark.parametrize("keep_data", [False, True], ids=["full_batch", "keep_data"])
@pytest.mark.parametrize("liks, ssz, masked", [
    (("bernoulli",), False, False),
    (("poisson",), False, False),
    (("gaussian", "bernoulli"), False, True),
    (("gaussian", "poisson"), True, False),
    (("gaussian", "gaussian"), True, False),
], ids=["bernoulli", "poisson", "gaussian_masked_bernoulli", "ssz_poisson", "ssz_gaussian"])
def test_init_state_matches_reference(liks, ssz, masked, keep_data):
    _, Ys, masks, onehot, jcfg, tcfg = _case(liks, ssz, masked_bernoulli=masked)
    ref, got = _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data)
    _assert_states_close(ref, got, rtol=1e-6, atol=1e-6)


def test_init_state_draws_w0_from_the_seed():
    _, Ys, masks, onehot, _, tcfg = _case(("bernoulli", "poisson"))
    a = tm._init_state(Ys, masks, onehot, tcfg, list(tcfg.likelihoods), device=CPU)
    b = tm._init_state(Ys, masks, onehot, tcfg, list(tcfg.likelihoods), device=CPU)
    assert torch.equal(a["W_hat"][0], b["W_hat"][0]) and torch.equal(a["SW"][1], b["SW"][1])
    assert not torch.equal(a["W_hat"][0][:20], b["W_hat"][1][:20])  # a stream per view
    assert not torch.equal(a["W_hat"][0][:, 0], a["Z_mean"][:30, 0])  # apart from Z's
    with pytest.raises(ValueError, match=r"W0\[0\] must have shape"):
        tm._init_state(Ys, masks, onehot, tcfg, list(tcfg.likelihoods),
                       W0=[np.zeros((3, 3), np.float32), None], device=CPU)


def _sweep_case(liks, ssz=False, masked=False, warm=2, toggle_at=None, G=2, seed=0):
    """The reference's state after ``warm`` sweeps (``ssz_on`` set before
    sweep ``toggle_at``), then one sweep of each package from it."""
    _, Ys, masks, onehot, jcfg, tcfg = _case(liks, ssz, G=G, seed=seed, masked_bernoulli=masked)
    N, Ds = Ys[0].shape[0], [Y.shape[1] for Y in Ys]
    bound = [m is not None or lk in BOUND for m, lk in zip(masks, liks)]
    with jax.enable_x64(False):
        step = jax.jit(jm._make_step(jcfg, Ds, N, bound, list(liks)))
        state = jm._init_state(Ys, masks, onehot, jcfg, list(liks))
        for w in range(warm):
            if w == toggle_at:
                state = {**state, "ssz_on": jnp.ones((), jnp.float32)}
            state, _ = step(state)
        ref, ref_elbo = step(state)
    start = tm.state_from_reference(state, CPU)
    before = {k: v.clone() for k, v in _leaves(start) if v is not None}
    got, elbo = tm.make_step(tcfg, Ds, N, bound, list(liks))(start)
    for name, v in _leaves(start):
        assert v is None or torch.equal(v, before[name]), name
    _assert_states_close(ref, got)
    np.testing.assert_allclose(float(elbo), float(ref_elbo), rtol=1e-4)
    return ref, got


@pytest.mark.parametrize("liks, masked", [
    (("bernoulli",), False),
    (("poisson",), False),
    (("bernoulli",), True),
    (("gaussian", "bernoulli"), False),
    (("gaussian", "poisson", "bernoulli"), True),
], ids=["bernoulli", "poisson", "masked_bernoulli", "gaussian_bernoulli", "three_views"])
def test_bound_sweep_matches_reference(liks, masked):
    ref, got = _sweep_case(liks, masked=masked)
    # τ of a bound-based view is the bound's and stays; the bernoulli mask
    # slot holds the Jaakkola precisions
    for m, lk in enumerate(liks):
        if lk in BOUND:
            np.testing.assert_array_equal(got["tau"][m].numpy(), np.asarray(ref["tau"][m]))
        if lk == "bernoulli":
            assert float(got["mask"][m].max()) <= 0.25 + 1e-7


@pytest.mark.parametrize("toggle_at", [None, 1], ids=["before_ssz_on", "after_ssz_on"])
@pytest.mark.parametrize("liks", [("gaussian", "gaussian"), ("gaussian", "bernoulli")],
                         ids=["gaussian", "gaussian_bernoulli"])
def test_spikeslab_factor_sweep_matches_reference(liks, toggle_at):
    ref, got = _sweep_case(liks, ssz=True, warm=3, toggle_at=toggle_at)
    zs = got["Z_S"].numpy()
    if toggle_at is None:
        assert (zs == 1.0).all()  # dense until the host turns ssz_on
    else:
        assert zs.min() < 1.0 and float(got["ssz_on"]) == 1.0


@pytest.mark.parametrize("liks, ssz", [
    (("gaussian", "bernoulli"), False),
    (("poisson",), False),
    (("gaussian", "gaussian"), True),
    (("gaussian", "bernoulli"), True),
], ids=["bernoulli", "poisson", "spikeslab_factors", "spikeslab_factors_bernoulli"])
def test_svi_step_matches_reference(liks, ssz):
    # three steps with the same batches and ρ, each from the last; ssz_on
    # turns on before the third
    _, Ys, masks, onehot, jcfg, tcfg = _case(liks, ssz)
    N, Ds, S = Ys[0].shape[0], [Y.shape[1] for Y in Ys], 36
    rng = np.random.default_rng(9)
    ref, got = _both_states(Ys, masks, onehot, jcfg, tcfg, keep_data=True)
    with jax.enable_x64(False):
        jstep = jax.jit(jm._make_svi_step(jcfg, Ds, N, S, list(liks)))
        tstep = tm.make_svi_step(tcfg, Ds, N, S, list(liks))
        for i, rho in enumerate((1.0, 0.70710677, 0.57735026)):
            if ssz and i == 2:
                ref = {**ref, "ssz_on": jnp.ones((), jnp.float32)}
                got = {**got, "ssz_on": torch.ones(())}
            batch = rng.choice(N, size=S, replace=False)
            ref, ref_obj = jstep(ref, jnp.asarray(batch.astype(np.int32)),
                                 jnp.asarray(np.float32(rho)))
            got, obj = tstep(got, _t(batch.astype(np.int64)), np.float32(rho))
            _assert_states_close(ref, got)
            np.testing.assert_allclose(float(obj), float(ref_obj), rtol=1e-4)


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------


def _fit_both(liks, ssz=False, svi=False, n_iter=25, N=150, seed=5, **kw):
    Z, views = _simulate(seed, N)
    Ys = [views[lk] for lk in liks]
    cfg = dict(n_factors=3, likelihoods=tuple(liks), seed=2, spikeslab_factors=ssz)
    common = dict(n_iterations=n_iter, min_iterations=n_iter, convergence_mode="slow",
                  elbo_every=1, svi_mode=svi, **kw)
    with jax.enable_x64(False):
        ref = jm.fit_mofa(Ys, jm.MOFAConfig(**cfg), **common)
    got = tm.fit_mofa(Ys, tm.MOFAConfig(**cfg), Z0=_reference_z0(2, N, 3),
                      W0=_reference_w0(2, [Y.shape[1] for Y in Ys], 3), device=CPU, **common)
    return Z, ref, got


@pytest.mark.parametrize("liks, ssz, svi", [
    (("gaussian", "bernoulli"), False, False),
    (("poisson",), False, False),
    (("gaussian", "bernoulli"), True, False),
    (("gaussian", "bernoulli"), False, True),
    (("gaussian", "gaussian"), True, True),
], ids=["bernoulli", "poisson", "spikeslab_factors", "bernoulli_svi", "spikeslab_factors_svi"])
def test_fit_matches_reference(liks, ssz, svi):
    # 25 fixed sweeps from the reference's draws: the ELBO trace at rtol
    # 1e-3, finite; the factors' subspace (canonical correlations > 0.99)
    _kernels.reset_launch_counts()
    Z, ref, got = _fit_both(liks, ssz, svi)
    assert not any(_kernels.launch_counts().values())  # CPU tensors: plain versions
    assert got.n_iterations == ref.n_iterations == 25
    assert np.isfinite(got.elbo_history).all()
    np.testing.assert_allclose(got.elbo_history, ref.elbo_history, rtol=1e-3)
    assert _canonical_correlations(got.Z, ref.Z).min() > 0.99
    for g, r in zip(got.tau, ref.tau):
        np.testing.assert_allclose(g, r, rtol=1e-3)
    if ssz:
        assert got.n_iterations > tm.SSZ_START


def test_spikeslab_factors_find_sparse_cells():
    # planted factors that are zero on half the cells: after ssz_on, Z_S
    # falls below 0.5 on a share of the cells and the planted factors are held
    rng = np.random.default_rng(11)
    N, K = 200, 3
    Z = rng.normal(size=(N, K)) * (rng.random((N, K)) > 0.5)
    Ys = [(Z @ rng.normal(size=(K, D)) + 0.3 * rng.normal(size=(N, D))).astype(np.float32)
          for D in (40, 30)]
    seen = {}

    def grab(it, state, elbo):
        seen[it] = state["Z_S"].numpy().copy()

    res = tm.fit_mofa(Ys, tm.MOFAConfig(n_factors=K, spikeslab_factors=True, seed=1),
                      n_iterations=40, elbo_every=20, callback=grab, device=CPU)
    # (0.14 of the entries at sweep 20 where half are planted at zero)
    assert (seen[20] < 0.5).mean() > 0.05 and (seen[40] < 0.5).mean() > 0.05
    assert _canonical_correlations(res.Z, Z).min() > 0.9


def test_svi_chunks_stop_at_the_ssz_toggle(monkeypatch):
    # the toggle is a host event: no chunk of SVI steps runs across it (with
    # chunks of 7 steps and no cap, steps 14-19 would run as one chunk)
    seen = []
    _, views = _simulate(3, 60)
    orig = tm.make_svi_step

    def spy(*a, **k):
        step = orig(*a, **k)

        def wrapped(state, batch, rho):
            seen.append(float(state["ssz_on"]))
            return step(state, batch, rho)
        return wrapped

    monkeypatch.setattr(tm, "make_svi_step", spy)
    tm.fit_mofa([views["gaussian"]], tm.MOFAConfig(n_factors=2, spikeslab_factors=True),
                n_iterations=20, elbo_every=7, svi_mode=True, device=CPU)
    assert seen == [0.0] * tm.SSZ_START + [1.0] * 5


# ---------------------------------------------------------------------------
# tl.mofa
# ---------------------------------------------------------------------------


def _mudata(seed=4):
    import pandas as pd

    _, views = _simulate(seed, 80)
    names = [f"c{i}" for i in range(80)]
    mods = {"rna": mu.AnnData(X=views["gaussian"], obs=pd.DataFrame(index=names)),
            "binary": mu.AnnData(X=views["bernoulli"], obs=pd.DataFrame(index=names)),
            "counts": mu.AnnData(X=views["poisson"], obs=pd.DataFrame(index=names))}
    return mu.MuData(mods)


def test_tl_mofa_guesses_likelihoods_like_the_reference(tmp_path, monkeypatch):
    import h5py

    ref_md, got_md = _mudata(), _mudata()
    kw = dict(n_factors=3, n_iterations=30, convergence_mode="slow", seed=5)
    Ds = [ref_md.mod[m].n_vars for m in ref_md.mod]
    monkeypatch.setattr(tm, "_draw_z0",
                        lambda N, K, seed, device: _t(_reference_z0(seed, N, K)).to(device))
    monkeypatch.setattr(tm, "_draw_w0", lambda D, K, seed, m, device:
                        _t(_reference_w0(seed, Ds, K)[m]).to(device))
    with jax.enable_x64(False):
        mu.tl.mofa(ref_md, outfile=str(tmp_path / "ref.hdf5"), **kw)
    assert mt.tl.mofa(got_md, outfile=str(tmp_path / "got.hdf5"), device="cpu", **kw) is None
    liks = list(got_md.uns["mofa"]["params"]["data"]["likelihoods"])
    assert liks == list(ref_md.uns["mofa"]["params"]["data"]["likelihoods"]) \
        == ["gaussian", "bernoulli", "poisson"]
    assert got_md.obsm["X_mofa"].shape == ref_md.obsm["X_mofa"].shape == (80, 3)
    assert _canonical_correlations(got_md.obsm["X_mofa"], ref_md.obsm["X_mofa"]).min() > 0.99
    for view in ("rna", "binary", "counts"):
        np.testing.assert_allclose(got_md.uns["mofa"]["variance"][view],
                                   ref_md.uns["mofa"]["variance"][view], atol=1e-3)
    with h5py.File(tmp_path / "ref.hdf5") as fr, h5py.File(tmp_path / "got.hdf5") as fg:
        names_r, names_g = [], []
        fr.visit(names_r.append)
        fg.visit(names_g.append)
        assert names_g == names_r
        got_liks = [x.decode() for x in fg["model_options/likelihoods"][:]]
        assert got_liks == ["gaussian", "bernoulli", "poisson"]
        # bound-based views are neither centred nor scaled: the raw counts
        np.testing.assert_array_equal(fg["data/counts/group1"][:], got_md.mod["counts"].X)


def test_tl_mofa_spikeslab_factors_matches_reference(tmp_path, monkeypatch):
    ref_md, got_md = _mudata(6), _mudata(6)
    for md in (ref_md, got_md):
        del md.mod["counts"]
        md.update()
    kw = dict(n_factors=3, n_iterations=25, convergence_mode="slow", seed=7,
              spikeslab_factors=True, likelihoods=["gaussian", "bernoulli"])
    Ds = [ref_md.mod[m].n_vars for m in ref_md.mod]
    monkeypatch.setattr(tm, "_draw_z0",
                        lambda N, K, seed, device: _t(_reference_z0(seed, N, K)).to(device))
    monkeypatch.setattr(tm, "_draw_w0", lambda D, K, seed, m, device:
                        _t(_reference_w0(seed, Ds, K)[m]).to(device))
    with jax.enable_x64(False):
        mu.tl.mofa(ref_md, outfile=str(tmp_path / "ref.hdf5"), **kw)
    mt.tl.mofa(got_md, outfile=str(tmp_path / "got.hdf5"), device="cpu", **kw)
    assert got_md.uns["mofa"]["params"]["model"]["spikeslab_factors"] is True
    assert _canonical_correlations(got_md.obsm["X_mofa"], ref_md.obsm["X_mofa"]).min() > 0.99


# ---------------------------------------------------------------------------
# on the card: T23 against its plain version (skips without one)
# ---------------------------------------------------------------------------


def _card_bound_inputs(cuda, n, d, K, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    Zm, SW = r(n, K), 0.3 * r(d, K)
    z2 = Zm * Zm + torch.exp(r(n, K) - 2)
    SWW = SW * SW + torch.exp(r(d, K) - 3)
    M01 = (torch.rand((n, d), generator=gen, device=cuda) > 0.2).float()
    Yb = (torch.rand((n, d), generator=gen, device=cuda) > 0.5).float() * M01
    Yp = torch.poisson(torch.full((n, d), 2.0, device=cuda), generator=gen) * M01
    kappa = 0.25 + 0.17 * Yp.max(dim=0).values
    return Zm, SW, z2, SWW, M01, Yb, Yp, kappa


@pytest.mark.gpu
@pytest.mark.parametrize("n, d, K", [(1000, 300, 15), (257, 33, 3), (70, 65, 40)])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("lik", BOUND)
def test_gpu_bound_refresh_matches_plain(cuda, lik, masked, n, d, K):
    # F, e2 and the outputs: the kernel sums over k in another order than
    # the products; ζ, T and E are held at 1e-5 of the scale of their terms,
    # F² + Σ z2·sww (not e2, which cancels)
    Zm, SW, z2, SWW, M01, Yb, Yp, kappa = _card_bound_inputs(cuda, n, d, K)
    M = M01 if masked else None
    kw = dict(z2=z2, SWW=SWW) if lik == "bernoulli" else dict(kappa=kappa)
    Y = Yb if lik == "bernoulli" else Yp
    got = _launched("mofa_bound_refresh",
                    lambda: ops.bound_refresh(lik, Zm, SW, Y, M, target=True, **kw))
    ref = ops.bound_refresh_plain(lik, Zm, SW, Y, M, target=True, **kw)
    F = Zm @ SW.T
    scale = (F * F + z2 @ SWW.T) if lik == "bernoulli" else F.abs() + 1.0
    for g, r in zip(got, ref):
        if r is None:
            assert g is None or torch.equal(g, M)
            continue
        assert bool(((g - r).abs() <= 1e-5 * (1.0 + scale)).all())
    again = ops.bound_refresh(lik, Zm, SW, Y, M, target=True, **kw)
    assert all(a is None or torch.equal(a, b) for a, b in zip(again, got))  # the same bits


@pytest.mark.gpu
def test_gpu_bound_fit_matches_cpu(cuda):
    # a bernoulli + poisson fit through the kernels and through the plain
    # versions: T23 once per bound view and sweep
    _, views = _simulate(12, 600)
    Ys = [views["bernoulli"], views["poisson"], views["gaussian"]]
    cfg = tm.MOFAConfig(n_factors=3, likelihoods=("bernoulli", "poisson", "gaussian"), seed=1)
    rng = np.random.default_rng(13)
    kw = dict(n_iterations=10, min_iterations=10, elbo_every=1, convergence_mode="slow",
              Z0=rng.normal(size=(600, 3)).astype(np.float32),
              W0=[rng.normal(size=(Y.shape[1], 3)).astype(np.float32) for Y in Ys])
    cpu = tm.fit_mofa(Ys, cfg, device=CPU, **kw)
    _kernels.reset_launch_counts()
    gpu = tm.fit_mofa(Ys, cfg, device=cuda, **kw)
    assert _kernels.launch_counts()["mofa_bound_refresh"] == 10 * 2
    np.testing.assert_allclose(gpu.elbo_history, cpu.elbo_history, rtol=1e-3)
    assert _canonical_correlations(gpu.Z, cpu.Z).min() > 0.99
