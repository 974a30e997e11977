"""The port's MEFISTO smooth factors (muon_tpu_torch.models.mofa with
ops/gp.py) held to the JAX package's on the same inputs: one sweep of the
dense and of the sparse GP from the reference's own state, whole fits with
the hyperparameter refresh, ``model_groups`` and warping, checkpoints,
``tl.mofa``'s smooth branch, and the reference's guards, message for
message.

The reference runs under ``jax.enable_x64(False)`` and hands the port its
``Z0``. Tolerances: a sparse-GP sweep at rtol 1e-4, atol 1e-5, leaf by leaf.
The dense GP's Woodbury update solves with A = I + SKS, whose condition
grows with the factors' precision: there each leaf is held within 5e-4 of
its largest entry, where the reference's own float32 sweep lies about 1e-4
from its float64 sweep from the same state. Whole fits by their ELBO trace
(rtol 1e-3), the factors' subspace and the chosen hyperparameters.
"""

import numpy as np
import pytest

try:
    import jax
    import jax.numpy as jnp
    import muon_tpu as mu
    from muon_tpu.models import mofa as jm
except ImportError:
    jax = jnp = mu = jm = None

import muon_tpu_torch as mt
from muon_tpu_torch.models import mofa as tm
from test_torch_mofa import (CPU, _assert_states_close, _canonical_correlations, _leaves,
                                   _reference_z0, _t)


def _temporal(seed=0, n=90, Ds=(30, 20), G=2, shift=False):
    """Two smooth factors over a time covariate and a rough one; G groups
    taking turns along the sorted times. With ``shift`` group 1 reads its
    clock as t² (the reference's warping test)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    Z = np.stack([np.sin(2 * np.pi * t), np.cos(3 * np.pi * t)], 1)
    Ys = [(Z @ rng.normal(size=(2, D)) + 0.4 * rng.normal(size=(n, D))).astype(np.float32)
          for D in Ds]
    groups = np.arange(n) % G
    cov = np.where(groups == 1, t ** 2, t).astype(np.float32) if shift else t
    return t, Z, Ys, groups, cov


def _active(Z):
    """The factors the ARD kept (one it switched off holds only rounding)."""
    return Z.std(axis=0) > 1e-6 * Z.std(axis=0).max()


def _active_cc(got, ref):
    keep = _active(ref)
    return _canonical_correlations(got[:, keep], ref[:, keep])


def _leaf_scaled_close(ref, got, tol):
    assert set(ref) == set(got), set(ref) ^ set(got)
    got = dict(_leaves(tm.state_to_reference(got)))
    for name, r in _leaves(ref):
        if r is None:
            assert got[name] is None, name
            continue
        r = np.asarray(r, np.float64)
        err = np.abs(got[name] - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= tol, (name, err)


# ---------------------------------------------------------------------------
# one sweep from the reference's state
# ---------------------------------------------------------------------------


def _smooth_sweep(sparse, learned_kg=False, G=2, warm=3, masked=False):
    _, _, Ys, groups, cov = _temporal(1, G=G)
    N, K = len(cov), 3
    masks = [None, None]
    if masked:
        masks[1] = (np.random.default_rng(2).random(Ys[1].shape) > 0.15).astype(np.float32)
        Ys[1] = np.where(masks[1] > 0, Ys[1], np.nan).astype(np.float32)
    onehot = np.eye(G, dtype=np.float32)[groups]
    kw = dict(n_factors=K, likelihoods=("gaussian", "gaussian"), n_groups=G, seed=3)
    jcfg, tcfg = jm.MOFAConfig(**kw), tm.MOFAConfig(**kw)
    c = ((cov - cov.min()) / (cov.max() - cov.min())).astype(np.float32)[:, None]
    gvec = groups.astype(np.float32)
    ell, sc = np.array([0.2, 0.1, 0.4], np.float32), np.array([0.5, 0.8, 0.3], np.float32)
    Kg = np.stack([np.array([[1, 0.4], [0.4, 1]], np.float32)] * K) if learned_kg else None
    masked_views = [m is not None for m in masks]
    with jax.enable_x64(False):
        state = jm._init_state(Ys, masks, onehot, jcfg)
        if sparse:
            idx = np.arange(0, N, 3)
            state.update(gp_cov=jnp.asarray(c), gp_cov_u=jnp.asarray(c[idx]),
                         gp_ell=jnp.asarray(ell), gp_scale=jnp.asarray(sc),
                         gp_g=jnp.asarray(gvec), gp_g_u=jnp.asarray(gvec[idx]))
            if learned_kg:
                state["gp_Kg"] = jnp.asarray(Kg)
        else:
            state["gp_K"] = jm._gp_kmat_fn()(jnp.asarray(c), jnp.asarray(ell), jnp.asarray(sc),
                                             jnp.asarray(gvec),
                                             None if Kg is None else jnp.asarray(Kg))
        step = jax.jit(jm._make_step(jcfg, [30, 20], N, masked_views, None, smooth=True,
                                     sparse_gp=sparse))
        for _ in range(warm):
            state, _ = step(state)
        ref, ref_elbo = step(state)
    got, elbo = tm.make_step(tcfg, [30, 20], N, masked_views, None, smooth=True,
                             sparse_gp=sparse)(tm.state_from_reference(state, CPU))
    return ref, got, float(ref_elbo), float(elbo)


@pytest.mark.parametrize("learned_kg, masked", [(False, False), (True, False), (False, True)],
                         ids=["independent_groups", "learned_kg", "masked"])
def test_dense_gp_sweep_matches_reference(learned_kg, masked):
    ref, got, ref_elbo, elbo = _smooth_sweep(False, learned_kg, masked=masked)
    _leaf_scaled_close(ref, got, 5e-4)
    np.testing.assert_allclose(elbo, ref_elbo, rtol=1e-4)


@pytest.mark.parametrize("learned_kg", [False, True], ids=["independent_groups", "learned_kg"])
def test_sparse_gp_sweep_matches_reference(learned_kg):
    ref, got, ref_elbo, elbo = _smooth_sweep(True, learned_kg)
    _assert_states_close(ref, got)
    np.testing.assert_allclose(elbo, ref_elbo, rtol=1e-4)


# ---------------------------------------------------------------------------
# whole fits
# ---------------------------------------------------------------------------


def _fit_both(n_iter=25, seed=4, G=2, shift=False, K=3, **kw):
    t, Z, Ys, groups, cov = _temporal(seed, G=G, shift=shift)
    common = dict(groups=groups, n_iterations=n_iter, min_iterations=n_iter,
                  convergence_mode="slow", elbo_every=1, smooth_covariate=cov,
                  smooth_start_opt=10, smooth_opt_every=10, **kw)
    cfg = dict(n_factors=K, seed=2)
    with jax.enable_x64(False):
        ref = jm.fit_mofa(Ys, jm.MOFAConfig(**cfg), **common)
    got = tm.fit_mofa(Ys, tm.MOFAConfig(**cfg), Z0=_reference_z0(2, len(cov), K), device=CPU,
                      **common)
    return t, Z, cov, ref, got


@pytest.mark.parametrize("kw", [
    dict(),
    dict(sparse_gp=True, frac_inducing=0.3),
    dict(model_groups=True),
    dict(model_groups=True, sparse_gp=True, frac_inducing=0.4),
], ids=["dense", "sparse", "model_groups", "model_groups_sparse"])
def test_smooth_fit_matches_reference(kw):
    # 25 sweeps with the hyperparameters refreshed after sweeps 10 and 20
    t, Z, cov, ref, got = _fit_both(**kw)
    assert got.n_iterations == ref.n_iterations == 25
    assert np.isfinite(got.elbo_history).all()
    np.testing.assert_allclose(got.elbo_history, ref.elbo_history, rtol=1e-3)
    assert _active_cc(got.Z, ref.Z).min() > 0.99
    np.testing.assert_array_equal(got.gp_lengthscales, ref.gp_lengthscales)
    np.testing.assert_array_equal(got.gp_scales, ref.gp_scales)
    assert got.warped_covariates is None and ref.warped_covariates is None
    if kw.get("model_groups"):
        # Kg of the active factors; a switched-off factor's gradient is
        # rounding, which the normalised step blows up to a whole step
        keep = _active(ref.Z)
        assert got.gp_group_corr.shape == (3, 2, 2)
        np.testing.assert_allclose(got.gp_group_corr[keep], ref.gp_group_corr[keep], atol=1e-3)
    else:
        assert got.gp_group_corr is None and ref.gp_group_corr is None


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_warped_fit_matches_reference(sparse):
    # group 1 reads its clock as t²: after the warps at sweeps 10 and 20 the
    # two packages hand back the same covariate, closer to t than t² is
    kw = dict(sparse_gp=True, frac_inducing=0.3) if sparse else {}
    t, Z, cov, ref, got = _fit_both(shift=True, warping=True, warping_freq=10, **kw)
    w, g1 = got.warped_covariates, np.arange(len(cov)) % 2 == 1
    np.testing.assert_allclose(w, ref.warped_covariates, atol=1e-6)
    np.testing.assert_allclose(w[~g1], cov[~g1], atol=1e-6)  # through the [0, 1] scaling
    assert ((w[g1] - t[g1]) ** 2).mean() < ((cov[g1] - t[g1]) ** 2).mean()


def test_smooth_fit_recovers_the_trajectories():
    t, Z, cov, ref, got = _fit_both(n_iter=30, seed=5, G=1)
    assert _canonical_correlations(got.Z, Z).min() > 0.9


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_smooth_checkpoint_crosses_packages(writer, tmp_path):
    # 12 sweeps in one package, checkpointed with gp_K; the other resumes
    # to 20 and lands where its own straight run does
    _, _, Ys, groups, cov = _temporal(6)
    cfg = dict(n_factors=3, seed=6)
    path = str(tmp_path / "state.npz")
    kw = dict(groups=groups, convergence_mode="slow", elbo_every=1, smooth_covariate=cov,
              smooth_start_opt=30)
    Z0 = _reference_z0(6, len(cov), 3)
    with jax.enable_x64(False):
        if writer == "port":
            tm.fit_mofa(Ys, tm.MOFAConfig(**cfg), n_iterations=12, checkpoint_path=path,
                        checkpoint_every=12, Z0=Z0, device=CPU, **kw)
            res = jm.fit_mofa(Ys, jm.MOFAConfig(**cfg), n_iterations=20, resume_from=path, **kw)
            straight = jm.fit_mofa(Ys, jm.MOFAConfig(**cfg), n_iterations=20, **kw)
        else:
            jm.fit_mofa(Ys, jm.MOFAConfig(**cfg), n_iterations=12, checkpoint_path=path,
                        checkpoint_every=12, **kw)
            res = tm.fit_mofa(Ys, tm.MOFAConfig(**cfg), n_iterations=20, resume_from=path,
                              device=CPU, **kw)
            straight = tm.fit_mofa(Ys, tm.MOFAConfig(**cfg), n_iterations=20, Z0=Z0,
                                   device=CPU, **kw)
    with np.load(path) as data:
        assert data["leaf:gp_K"].shape == (3, len(cov), len(cov))
    assert res.n_iterations == 20
    np.testing.assert_allclose(res.elbo_history, np.delete(straight.elbo_history, 11),
                               rtol=1e-3)
    assert _active_cc(res.Z, straight.Z).min() > 0.99


# ---------------------------------------------------------------------------
# the guards, message for message
# ---------------------------------------------------------------------------


_Y = np.random.default_rng(0).normal(size=(20, 6)).astype(np.float32)
_COV = np.linspace(0, 1, 20)
_GROUPS = np.arange(20) % 2


@pytest.mark.parametrize("kwargs, cfg, exc", [
    (dict(smooth_covariate=_COV, svi_mode=True), dict(), NotImplementedError),
    (dict(smooth_covariate=_COV), dict(spikeslab_factors=True), NotImplementedError),
    (dict(sparse_gp=True), dict(), ValueError),
    (dict(warping=True), dict(), ValueError),
    (dict(warping=True, smooth_covariate=_COV), dict(), ValueError),
    (dict(warping=True, smooth_covariate=np.stack([_COV, _COV], 1), groups=_GROUPS), dict(),
     NotImplementedError),
], ids=["smooth_svi", "smooth_spikeslab_factors", "sparse_gp_alone", "warping_alone",
        "warping_one_group", "warping_2d_covariate"])
def test_guards_match_the_reference(kwargs, cfg, exc):
    with pytest.raises(exc) as ref:
        jm.fit_mofa([_Y], jm.MOFAConfig(n_factors=2, **cfg), n_iterations=2, **kwargs)
    with pytest.raises(exc) as got:
        tm.fit_mofa([_Y], tm.MOFAConfig(n_factors=2, **cfg), n_iterations=2, device=CPU,
                    **kwargs)
    assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# tl.mofa's smooth branch
# ---------------------------------------------------------------------------


def _mudata(seed=7, shift=False, covariate_in="global"):
    import pandas as pd

    t, _, Ys, groups, cov = _temporal(seed, n=80, shift=shift)
    names = [f"c{i}" for i in range(80)]
    obs = pd.DataFrame({"time": cov, "batch": np.where(groups == 0, "ref", "warped")},
                       index=names)
    mods = {"a": mu.AnnData(X=Ys[0], obs=obs.copy() if covariate_in == "mod"
                            else pd.DataFrame(index=names)),
            "b": mu.AnnData(X=Ys[1], obs=pd.DataFrame(index=names))}
    md = mu.MuData(mods)
    if covariate_in == "global":
        md.obs["time"] = cov
    md.obs["batch"] = obs["batch"].to_numpy()
    return md, t


@pytest.mark.parametrize("case", ["dense", "sparse_model_groups", "warping"])
def test_tl_mofa_smooth_matches_reference(case, tmp_path, monkeypatch):
    import h5py

    shift = case == "warping"
    ref_md, _ = _mudata(shift=shift, covariate_in="mod" if case == "dense" else "global")
    got_md, _ = _mudata(shift=shift, covariate_in="mod" if case == "dense" else "global")
    sk = {"n_grid": 6, "opt_freq": 10, "start_opt": 10}
    kw = dict(n_factors=3, n_iterations=20, convergence_mode="slow", seed=5,
              smooth_covariate="time", groups_label="batch")
    if case == "sparse_model_groups":
        sk.update(sparseGP=True, frac_inducing=0.4, model_groups=True)
    if case == "warping":
        sk.update(warping_ref="ref", warping_freq=10)
        kw["smooth_warping"] = True
    monkeypatch.setattr(tm, "_draw_z0",
                        lambda N, K, seed, device: _t(_reference_z0(seed, N, K)).to(device))
    with jax.enable_x64(False):
        mu.tl.mofa(ref_md, outfile=str(tmp_path / "ref.hdf5"), smooth_kwargs=sk, **kw)
    mt.tl.mofa(got_md, outfile=str(tmp_path / "got.hdf5"), smooth_kwargs=sk, device="cpu", **kw)
    assert _active_cc(got_md.obsm["X_mofa"], ref_md.obsm["X_mofa"]).min() > 0.99
    gs, rs = got_md.uns["mofa"]["smooth"], ref_md.uns["mofa"]["smooth"]
    assert gs.keys() == rs.keys()
    np.testing.assert_array_equal(gs["lengthscales"], rs["lengthscales"])
    np.testing.assert_array_equal(gs["scales"], rs["scales"])
    if case == "sparse_model_groups":
        keep = _active(ref_md.obsm["X_mofa"])
        np.testing.assert_allclose(gs["group_corr"][keep], rs["group_corr"][keep], atol=1e-3)
    if case == "warping":
        assert "time_warped" in got_md.obs.columns
        np.testing.assert_allclose(got_md.obs["time_warped"].to_numpy(),
                                   ref_md.obs["time_warped"].to_numpy(), atol=1e-6)
    with h5py.File(tmp_path / "ref.hdf5") as fr, h5py.File(tmp_path / "got.hdf5") as fg:
        names_r, names_g = [], []
        fr.visit(names_r.append)
        fg.visit(names_g.append)
        assert names_g == names_r and "smooth/lengthscales" in names_g


@pytest.mark.parametrize("kwargs, match", [
    (dict(smooth_covariate="nope"), "is not a column"),
    (dict(smooth_covariate="time", smooth_warping=True), "requires groups_label"),
    (dict(smooth_covariate="time", smooth_warping=True, groups_label="batch",
          smooth_kwargs={"warping_ref": "nope"}), "no group 'nope'"),
], ids=["missing_column", "warping_without_groups", "unknown_warping_ref"])
def test_tl_mofa_smooth_guards_match_the_reference(kwargs, match):
    for pkg, extra in ((mu, {}), (mt, {"device": "cpu"})):
        md, _ = _mudata()
        with pytest.raises(ValueError, match=match):
            pkg.tl.mofa(md, n_factors=2, n_iterations=2, **kwargs, **extra)


def test_tl_mofa_refuses_a_covariate_with_missing_values():
    md, _ = _mudata()
    md.obs["time"] = np.where(np.arange(80) == 3, np.nan, md.obs["time"].to_numpy())
    with pytest.raises(ValueError, match="missing values"):
        mt.tl.mofa(md, n_factors=2, n_iterations=2, smooth_covariate="time", device="cpu")
