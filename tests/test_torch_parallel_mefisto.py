"""The port's MEFISTO smooth factors over a device mesh
(models/mofa.fit_mofa(smooth_covariate=..., mesh=)): the dense and the sparse
GP posteriors, the hyperparameter refresh, the learned group correlation Kg
and warping, held to the port's single device and to the JAX package's
``fit_mofa(mesh=make_mesh(P))``.

One spawn at each world size P in {1, 2, 4}: P ranks started by
``torch.multiprocessing``, a gloo group on the CPU joined through a
``file://`` store, one thread each, on ``make_mesh(P)``: (1, 1), (2, 1),
(2, 2). Every rank runs the cases of its P and writes its results as
``.npz``; the parent runs the port on one device and, at P = 2 and 4, the
JAX package on ``make_mesh(P)`` of its 8 virtual CPU devices under
``jax.enable_x64(False)``, and compares (a mesh of one device is the
single-device path in both packages, held by test_torch_mofa_smooth.py).
The rank worker imports no JAX. The reference's draws of Z are handed to the
port as ``Z0``.

The cases are tests/test_torch_mofa_smooth.py's: 90 cells in 2 groups, views
of 30 and 20 features, K = 3, 25 sweeps with the hyperparameters refreshed
(and the groups warped) after sweeps 10 and 20; the dense GP, the sparse GP,
``model_groups`` with each, warping with each. Besides them the reference's
own mesh case (tests/test_multichip.py::test_sparse_gp_with_mesh) and
``tl.mofa`` with a smooth covariate under ``set_options(mesh=...)``. Every
P runs the single sweeps, the checkpoint, ``tl.mofa`` and the dense and the
sparse fit; the other four fits are shared between the two meshes that cut
something, each run on one of them: ``model_groups`` dense and warping
sparse at (2, 2), ``model_groups`` sparse and warping dense at (2, 1), and
the reference's own case at (2, 1). Each mesh fit is held to one device and
to the reference's fit on the same P. (Under the whole suite's load the
ranks' collectives wait on one another, so the work of each spawn is
the file's time.)

Tolerances, each with its reason:

* one sweep from the same state: every leaf within 1e-5 of its largest
  entry of the single-device sweep (sums over cells and features cut into
  blocks and added across ranks: float32 in another order); the dense GP's
  leaves within 5e-4, the bound of tests/test_torch_mofa_smooth.py: its
  Woodbury solve conditions with N·p, so the feat sums' last bits grow.
* whole fits: each recorded ELBO within 1e-4 (relative) of the
  single-device fit's; ℓ and s equal (a grid point); Kg of the active
  factors within 1e-5; the warped covariates within 1e-6.
* across ranks: ℓ, s, Kg and the warped covariate equal bit for bit (each
  rank computes them from the same gathered Z).
* against the reference's mesh fit: test_smooth_fit_matches_reference's
  rules, the ELBO at rtol 1e-3, the active factors' canonical correlations
  above 0.99, ℓ and s equal.
"""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from muon_tpu_torch import parallel as tpar
from muon_tpu_torch.models import mofa as tm
from muon_tpu_torch.ops import gp as tgp

WORLD_SIZES = (1, 2, 4)
CPU = torch.device("cpu")
SWEEPS, K = 25, 3
MULTICHIP_SWEEPS, MULTICHIP_AT = 80, 2
CKPT_AT, CKPT_TO = 12, 20


# ---------------------------------------------------------------------------
# the fixtures' data, host numpy (no JAX)
# ---------------------------------------------------------------------------


def temporal(seed=0, n=90, Ds=(30, 20), G=2, shift=False):
    """tests/test_torch_mofa_smooth.py::_temporal: two smooth factors over a
    time covariate and a rough one, G groups taking turns along the sorted
    times; with ``shift`` group 1 reads its clock as t²."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    Z = np.stack([np.sin(2 * np.pi * t), np.cos(3 * np.pi * t)], 1)
    Ys = [(Z @ rng.normal(size=(2, D)) + 0.4 * rng.normal(size=(n, D))).astype(np.float32)
          for D in Ds]
    groups = np.arange(n) % G
    cov = np.where(groups == 1, t ** 2, t).astype(np.float32) if shift else t
    return t, Z, Ys, groups, cov


# the fits: name -> fit_mofa's MEFISTO options (the warping ones on the
# shifted clock)
MODES = {
    "dense": {},
    "sparse": dict(sparse_gp=True, frac_inducing=0.3),
    "groups": dict(model_groups=True),
    "groups_sparse": dict(model_groups=True, sparse_gp=True, frac_inducing=0.4),
    "warp": dict(warping=True, warping_freq=10),
    "warp_sparse": dict(warping=True, warping_freq=10, sparse_gp=True, frac_inducing=0.3),
}
# the fits each world size runs
MODES_AT = {1: ("dense", "sparse"), 2: ("dense", "sparse", "groups_sparse", "warp"),
            4: ("dense", "sparse", "groups", "warp_sparse")}
FITS = [(P, mode) for P in WORLD_SIZES for mode in MODES_AT[P]]
MESH_FITS = [(P, mode) for P, mode in FITS if P > 1]
# the single sweeps: name -> (sparse GP, a learned Kg, the second view masked)
SWEEP_CASES = {"dense": (False, False, False), "dense_kg_masked": (False, True, True),
               "sparse": (True, False, False), "sparse_kg": (True, True, False)}


def _fit(mode, f, mesh=None, **extra):
    t, Z, Ys, groups, cov = temporal(4, shift=mode.startswith("warp"))
    kw = dict(groups=groups, n_iterations=SWEEPS, min_iterations=SWEEPS,
              convergence_mode="slow", elbo_every=1, smooth_covariate=cov,
              smooth_start_opt=10, smooth_opt_every=10, **MODES[mode])
    kw.update(extra)
    return tm.fit_mofa(Ys, tm.MOFAConfig(n_factors=K, seed=2), Z0=f["fit_Z0"], mesh=mesh,
                       device=CPU, **kw)


def _multichip_data():
    """test_sparse_gp_with_mesh's: 160 cells, one planted smooth factor."""
    rng = np.random.default_rng(2)
    n = 160
    t = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    Z = np.stack([np.sin(2 * np.pi * t)], 1).astype(np.float32)
    Y = (Z @ rng.normal(size=(40, 1)).T + 0.3 * rng.normal(size=(n, 40))).astype(np.float32)
    return t, Z, Y


def _multichip_fit(f, mesh=None):
    t, _, Y = _multichip_data()
    return tm.fit_mofa([Y], tm.MOFAConfig(n_factors=2, seed=0, ard_factors=False),
                       n_iterations=MULTICHIP_SWEEPS, min_iterations=MULTICHIP_SWEEPS,
                       convergence_mode="slow", elbo_every=1, smooth_covariate=t,
                       sparse_gp=True, frac_inducing=0.2, Z0=f["multichip_Z0"], mesh=mesh,
                       device=CPU)


def _leaves(state):
    for key, val in state.items():
        for i, v in enumerate(val if isinstance(val, (list, tuple)) else [val]):
            if torch.is_tensor(v):
                yield f"{key}[{i}]", v.numpy()


def _sweep_state(case, f, device=CPU, warm=3):
    """The state of a sweep case after ``warm`` single-device sweeps from
    the reference's Z draw, with its step and sizes: the GP fields set as
    test_torch_mofa_smooth.py's ``_smooth_sweep`` sets them."""
    sparse, learned_kg, masked = SWEEP_CASES[case]
    _, _, Ys, groups, cov = temporal(1)
    N = len(cov)
    masks = [None, None]
    if masked:
        masks[1] = (np.random.default_rng(2).random(Ys[1].shape) > 0.15).astype(np.float32)
        Ys[1] = np.where(masks[1] > 0, Ys[1], np.nan).astype(np.float32)
    cfg = tm.MOFAConfig(n_factors=K, likelihoods=("gaussian", "gaussian"), n_groups=2, seed=3)
    state = tm._init_state(Ys, masks, np.eye(2, dtype=np.float32)[groups], cfg,
                           Z0=f["sweep_Z0"], device=device)
    c = torch.from_numpy(((cov - cov.min()) / (cov.max() - cov.min()))[:, None]).to(device)
    gvec = torch.from_numpy(groups.astype(np.float32)).to(device)
    ell = torch.tensor([0.2, 0.1, 0.4], device=device)
    sc = torch.tensor([0.5, 0.8, 0.3], device=device)
    Kg = torch.tensor([[1.0, 0.4], [0.4, 1.0]], device=device).repeat(K, 1, 1) \
        if learned_kg else None
    if sparse:
        idx = torch.arange(0, N, 3, device=device)
        state.update(gp_cov=c, gp_cov_u=c[idx].contiguous(), gp_ell=ell, gp_scale=sc, gp_g=gvec,
                     gp_g_u=gvec[idx].contiguous())
        if learned_kg:
            state["gp_Kg"] = Kg
    else:
        state["gp_K"] = tgp.kernel_matrices(c, ell, sc, gvec, Kg)

    def step(red=tm.NO_MESH):
        return tm.make_step(cfg, [30, 20], N, [m is not None for m in masks], None, smooth=True,
                            sparse_gp=sparse, red=red)

    one = step()
    for _ in range(warm):
        state, _ = one(state)
    return state, step, N, [30, 20]


def _sweep(case, f, mesh=None):
    """One sweep of ``case`` from its warmed state, on one device or sharded
    on ``mesh``; the whole state's leaves and the ELBO."""
    state, step, N, Ds = _sweep_state(case, f)
    if mesh is None:
        new, e = step()(state)
    else:
        new, e = step(tm.Reducer(mesh))(tpar.shard_mofa_state(state, mesh))
        new = tpar.gather_mofa_state(new, mesh, N, Ds)
    return dict(_leaves(new)), float(e)


def _tl_mofa(mesh, outfile):
    """``tl.mofa`` of a port MuData, 85 cells (no P divides them) in two
    batches with a shifted clock: the sparse GP with model_groups and
    warping, on one device or under ``set_options(mesh=...)``."""
    import pandas as pd

    import muon_tpu_torch as mt

    t, _, Ys, groups, cov = temporal(7, n=85, shift=True)
    names = pd.Index([f"c{i}" for i in range(85)])
    md = mt.MuData({"a": mt.AnnData(X=Ys[0], obs=pd.DataFrame(index=names)),
                    "b": mt.AnnData(X=Ys[1], obs=pd.DataFrame(index=names))})
    md.obs["time"] = cov
    md.obs["batch"] = np.where(groups == 0, "ref", "warped")
    sk = {"n_grid": 6, "opt_freq": 10, "start_opt": 10, "sparseGP": True, "frac_inducing": 0.4,
          "model_groups": True, "warping_ref": "ref", "warping_freq": 10}
    kw = dict(n_factors=K, n_iterations=20, convergence_mode="slow", seed=5,
              smooth_covariate="time", groups_label="batch", smooth_warping=True,
              smooth_kwargs=sk, outfile=str(outfile))
    if mesh is None:
        mt.tl.mofa(md, device=CPU, **kw)
    else:
        with mt.set_options(mesh=mesh):
            mt.tl.mofa(md, **kw)
    smooth = md.uns["mofa"]["smooth"]
    return {"X": np.asarray(md.obsm["X_mofa"]), "ell": np.asarray(smooth["lengthscales"]),
            "warped": md.obs["time_warped"].to_numpy()}


# ---------------------------------------------------------------------------
# the rank worker (no JAX)
# ---------------------------------------------------------------------------


def _rank_main(rank, P, store, workdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P)
    try:
        mesh = tpar.make_mesh(P, device="cpu")
        work = Path(workdir)
        f = dict(np.load(work / "inputs.npz"))
        out = {"mesh": np.array([mesh.shape["cells"], mesh.shape["feat"]])}
        for case in SWEEP_CASES:
            leaves, e = _sweep(case, f, mesh)
            out.update({f"sweep_{case}:{k}": v for k, v in leaves.items()})
            out[f"sweep_{case}:elbo"] = np.array(e)
        for mode in MODES_AT[P]:
            res = _fit(mode, f, mesh)
            out.update({f"fit_{mode}:Z": res.Z, f"fit_{mode}:elbo": res.elbo_history,
                        f"fit_{mode}:ell": res.gp_lengthscales, f"fit_{mode}:scale": res.gp_scales})
            if res.gp_group_corr is not None:
                out[f"fit_{mode}:Kg"] = res.gp_group_corr
            if res.warped_covariates is not None:
                out[f"fit_{mode}:warped"] = res.warped_covariates
        if P == MULTICHIP_AT:
            res = _multichip_fit(f, mesh)
            out.update({"multichip:Z": res.Z, "multichip:elbo": res.elbo_history})
        # a sharded checkpoint of the sparse GP (its covariates cut over cells)
        _fit("sparse", f, mesh, n_iterations=CKPT_AT, min_iterations=CKPT_AT,
             smooth_start_opt=30, checkpoint_path=str(work / "sparse_ckpt.npz"),
             checkpoint_every=CKPT_AT)
        tl = _tl_mofa(mesh, work / f"model_mesh_{rank}.hdf5")
        out.update({f"tl:{k}": v for k, v in tl.items()})
        try:
            _fit("dense", f, mesh, svi_mode=True)
            out["svi_refusal"] = np.array("")
        except NotImplementedError as e:
            out["svi_refusal"] = np.array(str(e))
        np.savez(work / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the inputs, the single-device port and the reference (JAX, imported here)
# ---------------------------------------------------------------------------


@contextmanager
def _one_torch_thread():
    """The parent's torch work on one thread: beside the reference's XLA
    thread pool in the same process, torch's own pool makes these small fits
    many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _reference_z0(seed, N, k):
    import jax
    import jax.numpy as jnp

    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (N, k), dtype=jnp.float32))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The starts (the reference's draws) and the single-device port's
    sweeps and fits from them."""
    pytest.importorskip("jax")
    f = {"sweep_Z0": _reference_z0(3, 90, K), "fit_Z0": _reference_z0(2, 90, K),
         "multichip_Z0": _reference_z0(0, 160, 2)}
    work = tmp_path_factory.mktemp("mefisto_inputs")
    with _one_torch_thread():
        single = {f"sweep_{case}": _sweep(case, f) for case in SWEEP_CASES}
        single.update({f"fit_{mode}": _fit(mode, f) for mode in MODES})
        single["multichip"] = _multichip_fit(f)
        single["ckpt_straight"] = _fit("sparse", f, n_iterations=CKPT_TO,
                                       min_iterations=CKPT_TO, smooth_start_opt=30)
        single["tl"] = _tl_mofa(None, work / "model_single.hdf5")
    path = work / "inputs.npz"
    np.savez(path, **f)
    return {"path": path, "f": f, "single": single}


def _reference_fit(mode, P):
    import jax
    from muon_tpu.models import mofa as jm
    from muon_tpu.parallel import make_mesh

    t, Z, Ys, groups, cov = temporal(4, shift=mode.startswith("warp"))
    with jax.enable_x64(False):
        return jm.fit_mofa(Ys, jm.MOFAConfig(n_factors=K, seed=2), groups=groups,
                           n_iterations=SWEEPS, min_iterations=SWEEPS, convergence_mode="slow",
                           elbo_every=1, smooth_covariate=cov, smooth_start_opt=10,
                           smooth_opt_every=10, mesh=make_mesh(P), **MODES[mode])


def _spawn(P, inputs, work):
    """Spawn the P ranks, run the reference's mesh fits, return both."""
    import shutil

    import torch.multiprocessing as mp

    shutil.copy(inputs["path"], work / "inputs.npz")
    # a mesh of one device is the single-device path in both packages, which
    # tests/test_torch_mofa_smooth.py holds to each other
    ref = {mode: _reference_fit(mode, P) for mode in MODES_AT[P]} if P > 1 else {}
    mp.spawn(_rank_main, args=(P, str(work / "store"), str(work)), nprocs=P)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(P)]
    return {"P": P, "ranks": ranks, "port": ranks[0], "ref": ref, "single": inputs["single"],
            "f": inputs["f"], "work": work}


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The spawn of each world size, made at its first use and kept: the
    tests of one P need not run together."""
    made = {}

    def run(P):
        if P not in made:
            made[P] = _spawn(P, inputs, tmp_path_factory.mktemp(f"mefisto_mesh{P}"))
        return made[P]

    return run


def _ids(params):
    return [f"P{p}" if isinstance(p, int) else f"P{p[0]}-{p[1]}" for p in params]


BY_P = pytest.mark.parametrize("P", WORLD_SIZES, ids=_ids(WORLD_SIZES))


# ---------------------------------------------------------------------------
# against the port's single device
# ---------------------------------------------------------------------------


def _active(Z):
    """The factors the ARD kept (one it switched off holds only rounding)."""
    return Z.std(axis=0) > 1e-6 * Z.std(axis=0).max()


def _canonical_correlations(A, B):
    Qa, _ = np.linalg.qr(A - A.mean(0))
    Qb, _ = np.linalg.qr(B - B.mean(0))
    return np.linalg.svd(Qa.T @ Qb, compute_uv=False)


def _active_cc(got, ref):
    keep = _active(ref)
    return _canonical_correlations(got[:, keep], ref[:, keep])


@BY_P
def test_the_mesh(runs, P):
    run = runs(P)
    cells, feat = {1: (1, 1), 2: (2, 1), 4: (2, 2)}[run["P"]]
    assert run["port"]["mesh"].tolist() == [cells, feat]


@pytest.mark.parametrize("case", list(SWEEP_CASES))
@BY_P
def test_one_sweep_matches_one_device(runs, P, case):
    run = runs(P)
    want, want_elbo = run["single"][f"sweep_{case}"]
    tol = 1e-5 if SWEEP_CASES[case][0] else 5e-4
    port = run["port"]
    for name, w in want.items():
        g = port[f"sweep_{case}:{name}"]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= tol * scale, (name, np.abs(g - w).max() / scale)
    np.testing.assert_allclose(port[f"sweep_{case}:elbo"], want_elbo, rtol=1e-5)


@pytest.mark.parametrize("P, mode", FITS, ids=_ids(FITS))
def test_fit_matches_one_device(runs, P, mode):
    run = runs(P)
    want, port = run["single"][f"fit_{mode}"], run["port"]
    got = port[f"fit_{mode}:elbo"]
    assert got.shape == want.elbo_history.shape == (SWEEPS,)
    np.testing.assert_allclose(got, want.elbo_history, rtol=1e-4)
    np.testing.assert_array_equal(port[f"fit_{mode}:ell"], want.gp_lengthscales)
    np.testing.assert_array_equal(port[f"fit_{mode}:scale"], want.gp_scales)
    if MODES[mode].get("model_groups"):
        keep = _active(want.Z)
        np.testing.assert_allclose(port[f"fit_{mode}:Kg"][keep], want.gp_group_corr[keep],
                                   atol=1e-5)
    else:
        assert f"fit_{mode}:Kg" not in port and want.gp_group_corr is None
    if MODES[mode].get("warping"):
        np.testing.assert_allclose(port[f"fit_{mode}:warped"], want.warped_covariates,
                                   atol=1e-6)
    else:
        assert f"fit_{mode}:warped" not in port and want.warped_covariates is None


@BY_P
def test_ranks_agree_bit_for_bit(runs, P):
    run = runs(P)
    # ℓ, s, Kg and the warped covariate come from the same gathered Z on
    # every rank; so does every other output
    first = run["ranks"][0]
    for other in run["ranks"][1:]:
        for key in first:
            if key.endswith((":ell", ":scale", ":Kg", ":warped")) or key.startswith("tl:"):
                np.testing.assert_array_equal(other[key], first[key], err_msg=key)


@pytest.mark.parametrize("P", [MULTICHIP_AT], ids=_ids([MULTICHIP_AT]))
def test_reference_mesh_case_recovers_the_trajectory(runs, P):
    run = runs(P)
    # test_multichip.py::test_sparse_gp_with_mesh: the planted factor's R² > 0.9
    t, Z, _ = _multichip_data()
    got, want = run["port"]["multichip:Z"], run["single"]["multichip"]
    Zi = got - got.mean(0)
    zt = Z[:, 0] - Z[:, 0].mean()
    beta, *_ = np.linalg.lstsq(Zi, zt, rcond=None)
    assert 1 - ((zt - Zi @ beta) ** 2).sum() / (zt ** 2).sum() > 0.9
    np.testing.assert_allclose(run["port"]["multichip:elbo"], want.elbo_history, rtol=1e-4)


@BY_P
def test_sharded_checkpoint_resumes_on_one_device(runs, P):
    run = runs(P)
    # the checkpoint holds the whole state (gp_cov and gp_g gathered over
    # cells); one device resumes it to sweep 20 and lands on its own
    # straight run
    path = str(run["work"] / "sparse_ckpt.npz")
    with np.load(path) as data:
        assert data["leaf:gp_cov"].shape == (90, 1) and data["leaf:gp_g"].shape == (90,)
    with _one_torch_thread():
        res = _fit("sparse", run["f"], n_iterations=CKPT_TO, min_iterations=CKPT_TO,
                   smooth_start_opt=30, resume_from=path)
    straight = run["single"]["ckpt_straight"]
    assert res.n_iterations == CKPT_TO
    np.testing.assert_allclose(res.elbo_history, np.delete(straight.elbo_history, CKPT_AT - 1),
                               rtol=1e-4)
    assert _active_cc(res.Z, straight.Z).min() > 0.99


@BY_P
def test_tl_mofa_smooth_under_set_options(runs, P):
    run = runs(P)
    got, want = {k[3:]: v for k, v in run["port"].items() if k.startswith("tl:")}, \
        run["single"]["tl"]
    assert got["X"].shape == (85, K)
    assert _active_cc(got["X"], want["X"]).min() > 0.99
    np.testing.assert_array_equal(got["ell"], want["ell"])
    np.testing.assert_allclose(got["warped"], want["warped"], atol=1e-6)


@BY_P
def test_svi_with_smooth_factors_is_still_refused(runs, P):
    run = runs(P)
    assert "smooth factors (MEFISTO) with svi_mode are not supported" in \
        str(run["port"]["svi_refusal"])


# ---------------------------------------------------------------------------
# against the reference's fit_mofa(mesh=make_mesh(P)), its own rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P, mode", MESH_FITS, ids=_ids(MESH_FITS))
def test_fit_matches_reference_mesh_fit(runs, P, mode):
    run = runs(P)
    ref, port = run["ref"][mode], run["port"]
    assert ref.n_iterations == SWEEPS
    np.testing.assert_allclose(port[f"fit_{mode}:elbo"], ref.elbo_history, rtol=1e-3)
    assert _active_cc(port[f"fit_{mode}:Z"], ref.Z).min() > 0.99
    np.testing.assert_array_equal(port[f"fit_{mode}:ell"], ref.gp_lengthscales)
    np.testing.assert_array_equal(port[f"fit_{mode}:scale"], ref.gp_scales)
    if MODES[mode].get("model_groups"):
        keep = _active(ref.Z)
        np.testing.assert_allclose(port[f"fit_{mode}:Kg"][keep], ref.gp_group_corr[keep],
                                   atol=1e-3)
    if MODES[mode].get("warping"):
        np.testing.assert_allclose(port[f"fit_{mode}:warped"], ref.warped_covariates, atol=1e-6)


# ---------------------------------------------------------------------------
# on the card: one sharded sweep at P = 1 (T24 on the sparse path) against
# the same sweep on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["dense", "sparse"])
def test_sharded_sweep_on_the_card_matches_the_cpu(case, tmp_path):
    # the warmed state of the CPU sweep moved to the card, one sharded sweep
    # there on a mesh of one rank
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from muon_tpu_torch.ops import _kernels

    f = {"sweep_Z0": np.random.default_rng(3).normal(size=(90, K)).astype(np.float32)}
    state, step, N, Ds = _sweep_state(case, f)
    want, want_e = step()(state)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = tpar.make_mesh(1, device="cuda:0")
        _kernels.reset_launch_counts()
        got, e = step(tm.Reducer(mesh))(
            tpar.shard_mofa_state(tm.state_from_reference(state, mesh.device), mesh))
        launches = _kernels.launch_counts()["gp_rbf_kernel"]
        got = tm.state_from_reference(
            tm.state_to_reference(tpar.gather_mofa_state(got, mesh, N, Ds)), CPU)
    finally:
        dist.destroy_process_group()
    assert launches == (2 * K if case == "sparse" else 0)
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(got[name] - w).max() <= 1e-4 * scale, name
    np.testing.assert_allclose(float(e), float(want_e), rtol=1e-4)
