"""The port's MOFA over a device mesh (models/mofa.fit_mofa(mesh=),
parallel.shard_mofa_state / gather_mofa_state, parallel/dryrun.py) held to
the port's single-device MOFA and to the JAX package's
``fit_mofa(mesh=make_mesh(P))`` on the reference's fixtures
(tests/test_multichip.py); and the (cells, feat) mesh itself.

One spawn at each world size P in {1, 2, 4}: P ranks started by
``torch.multiprocessing``, a gloo group on the CPU joined through a
``file://`` store, one thread each, on ``make_mesh(P)``: (1, 1), (2, 1),
(2, 2), the reference's split. Every rank runs every case and writes its
results as ``.npz``; the parent runs the port on one device and the JAX
package on ``make_mesh(P)`` of its 8 virtual CPU devices, and compares.
The rank worker imports no JAX. The reference runs with x64 off, as in
production (its tests turn x64 on), as every MOFA parity test of the port
runs it; its draws of Z and of the random W starts are handed to the port
as ``Z0`` and ``W0``.

Tolerances, each with its reason:

* one sweep from the same state: every leaf within 1e-5 of its largest
  entry of the single-device sweep (the sums over cells and features are
  cut into blocks and added across ranks: float32 in another order).
* 20 sweeps: each recorded ELBO within 1e-4 (relative) of the
  single-device fit's.
* against the reference's mesh fit: its own test's rules, Z within rtol
  1e-2 atol 1e-3 and the planted factors' R² within 0.02 (full batch,
  spike-slab factors), and the planted R² above 0.8 (SVI); at 30 sweeps.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from muon_tpu_torch import parallel as tpar
from muon_tpu_torch.models import mofa as tm

WORLD_SIZES = (1, 2, 4)
CPU = torch.device("cpu")
FIT_SWEEPS, TRACE_SWEEPS = 30, 20


# ---------------------------------------------------------------------------
# the fixtures' data, host numpy (no JAX)
# ---------------------------------------------------------------------------


def toy_problem():
    """__graft_entry__._toy_problem: two views (the second 10% missing),
    two groups, K = 4."""
    rng = np.random.default_rng(0)
    N, Ds, K, G = 64, (48, 32), 4, 2
    Z = rng.normal(size=(N, K)).astype(np.float32)
    Ys = []
    for D in Ds:
        W = rng.normal(size=(D, K)).astype(np.float32)
        Ys.append(Z @ W.T + 0.1 * rng.normal(size=(N, D)).astype(np.float32))
    masks = [None, (rng.random(size=Ys[1].shape) > 0.1).astype(np.float32)]
    Ys[1] = np.where(masks[1] > 0, Ys[1], np.nan).astype(np.float32)
    groups = np.arange(N) % G
    return Ys, masks, groups, dict(n_factors=K, n_groups=G, seed=0)


def planted(seed, n, k, Ds, noise=0.1):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, k)).astype(np.float32)
    Ys = [(Z @ rng.normal(size=(D, k)).T + noise * rng.normal(size=(n, D))).astype(np.float32)
          for D in Ds]
    return Z, Ys


def lik_problem():
    """A bernoulli, a poisson and a masked gaussian view (the recipe of
    tests/test_torch_mofa_likelihoods.py), two groups."""
    rng = np.random.default_rng(0)
    N, K, Ds = 90, 3, (30, 24, 20)
    Z = rng.normal(size=(N, K))
    logits = Z @ rng.normal(scale=1.2, size=(K, Ds[0]))
    Yb = (rng.random(logits.shape) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    Yp = rng.poisson(np.log1p(np.exp(Z @ rng.normal(scale=0.8, size=(K, Ds[1]))))
                     ).astype(np.float32)
    Yg = (Z @ rng.normal(size=(K, Ds[2])) + 0.3 * rng.normal(size=(N, Ds[2]))).astype(np.float32)
    mask = (rng.random(Yg.shape) > 0.15).astype(np.float32)
    Yg = np.where(mask > 0, Yg, np.nan).astype(np.float32)
    return Z, [Yb, Yp, Yg], np.arange(N) % 2, K


# the fits: name -> (views, fit_mofa's keywords, config's keywords)
def fit_cases():
    _, full = planted(0, 96, 3, (40, 32))
    _, svi = planted(1, 128, 3, (48,))
    _, ssz = planted(3, 120, 2, (40, 30))
    _, lik, groups, K = lik_problem()
    return {
        "full": (full, dict(), dict(n_factors=4, seed=0, ard_factors=False)),
        "svi": (svi, dict(svi_mode=True, svi_batch_fraction=0.5),
                dict(n_factors=4, seed=0, ard_factors=False)),
        "ssz": (ssz, dict(), dict(n_factors=3, seed=1, spikeslab_factors=True)),
        "lik": (lik, dict(groups=groups),
                dict(n_factors=K, seed=3, likelihoods=("bernoulli", "poisson", "gaussian"))),
    }


def sweep_cases():
    """name -> (views, masks, groups, config keywords, liks, svi)."""
    toy, masks, groups, cfg = toy_problem()
    _, lik, lgroups, K = lik_problem()
    lmask = [None, None, (~np.isnan(lik[2])).astype(np.float32)]
    _, ssz = planted(3, 120, 2, (40, 30))
    liks = ("bernoulli", "poisson", "gaussian")
    return {
        "toy": (toy, masks, groups, cfg, ("gaussian", "gaussian"), False),
        "lik": (lik, lmask, lgroups, dict(n_factors=K, n_groups=2, seed=3, likelihoods=liks),
                liks, False),
        "ssz": (ssz, [None, None], np.zeros(120, int),
                dict(n_factors=3, seed=1, spikeslab_factors=True), ("gaussian", "gaussian"),
                False),
        "svi": (toy, masks, groups, cfg, ("gaussian", "gaussian"), True),
    }


def _onehot(groups):
    return np.eye(int(groups.max()) + 1, dtype=np.float32)[groups]


def _leaves(state):
    for key, val in state.items():
        for i, v in enumerate(val if isinstance(val, (list, tuple)) else [val]):
            if torch.is_tensor(v):
                yield f"{key}[{i}]", v.numpy()


def _sweep(name, f, red=tm.NO_MESH, mesh=None):
    """One sweep (two SVI steps) of case ``name`` from its initial state, on
    one device or on ``mesh``; returns the whole state's leaves and the
    objective(s)."""
    Ys, masks, groups, cfg, liks, svi = sweep_cases()[name]
    cfg = tm.MOFAConfig(**cfg)
    N, Ds = Ys[0].shape[0], [Y.shape[1] for Y in Ys]
    W0 = [f[f"sweep_{name}_W0_{m}"] for m in range(len(Ys))]
    state = tm._init_state(Ys, masks, _onehot(groups), cfg, liks, keep_data=svi,
                           Z0=f[f"sweep_{name}_Z0"], W0=W0, device=CPU)
    if mesh is not None:
        state = tpar.shard_mofa_state(state, mesh)
    objs = []
    if svi:
        S = 24
        step = tm.make_svi_step(cfg, Ds, N, S, liks, red)
        lo, hi = mesh.block(N, "cells") if mesh is not None else (0, N)
        for batch, rho in zip(f["svi_batches"], (1.0, 0.70710677)):
            local = batch[(batch >= lo) & (batch < hi)] - lo
            state, e = step(state, torch.from_numpy(local.astype(np.int64)), np.float32(rho))
            objs.append(float(e))
    else:
        masked = [m is not None or lk != "gaussian" for m, lk in zip(masks, liks)]
        state, e = tm.make_step(cfg, Ds, N, masked, liks, red=red)(state)
        objs.append(float(e))
    if mesh is not None:
        state = tpar.gather_mofa_state(state, mesh, N, Ds)
    return dict(_leaves(state)), np.array(objs)


def _fit(name, f, mesh=None, sweeps=FIT_SWEEPS):
    Ys, kw, cfg = fit_cases()[name]
    W0 = [f[f"fit_{name}_W0_{m}"] for m in range(len(Ys))]
    return tm.fit_mofa(Ys, tm.MOFAConfig(**cfg), n_iterations=sweeps, min_iterations=sweeps,
                       convergence_mode="slow", elbo_every=1, Z0=f[f"fit_{name}_Z0"], W0=W0,
                       mesh=mesh, device=CPU, **kw)


def _tl_mofa(mesh, outfile):
    """``tl.mofa`` of test_wnn_umap_mofa_global_mesh's two modalities (n =
    485, which divides by no P), on one device or under
    ``set_options(mesh=...)``: its ``X_mofa``."""
    import pandas as pd

    import muon_tpu_torch as mt

    rng = np.random.default_rng(1)
    n, ncl = 485, 4
    labels = rng.integers(0, ncl, n)
    cents1, cents2 = rng.normal(size=(ncl, 10)) * 4, rng.normal(size=(ncl, 8)) * 4
    names = pd.Index([f"c{i}" for i in range(n)])
    md = mt.MuData({
        "a": mt.AnnData(X=(cents1[labels] + rng.normal(size=(n, 10))).astype(np.float32),
                        obs=pd.DataFrame(index=names)),
        "b": mt.AnnData(X=(cents2[labels] + rng.normal(size=(n, 8))).astype(np.float32),
                        obs=pd.DataFrame(index=names))})
    kw = dict(n_factors=4, n_iterations=TRACE_SWEEPS, outfile=str(outfile))
    if mesh is None:
        mt.tl.mofa(md, device=CPU, **kw)
    else:
        with mt.set_options(mesh=mesh):
            mt.tl.mofa(md, **kw)
    return np.asarray(md.obsm["X_mofa"])


# ---------------------------------------------------------------------------
# the rank worker (no JAX)
# ---------------------------------------------------------------------------


def _rank_main(rank, P, store, workdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P)
    try:
        mesh = tpar.make_mesh(P, device="cpu")
        f = dict(np.load(Path(workdir) / "inputs.npz"))
        out = {"mesh": np.array([mesh.shape["cells"], mesh.shape["feat"], mesh.cells_rank,
                                 mesh.feat_rank]),
               "cells_ranks": np.array(mesh.cells_ranks), "feat_ranks": np.array(mesh.feat_ranks)}
        red = tm.Reducer(mesh)
        for name in sweep_cases():
            leaves, objs = _sweep(name, f, red, mesh)
            out.update({f"sweep_{name}:{k}": v for k, v in leaves.items()})
            out[f"sweep_{name}:obj"] = objs
        for name in fit_cases():
            res = _fit(name, f, mesh, TRACE_SWEEPS if name == "lik" else FIT_SWEEPS)
            out[f"fit_{name}:Z"] = res.Z
            out[f"fit_{name}:elbo"] = res.elbo_history
            out[f"fit_{name}:W0"] = res.W[0]
            out[f"fit_{name}:r2"] = res.r2_per_factor[0]
        for tag, m in (("single", None), ("mesh", mesh)):
            out[f"tl_{tag}"] = _tl_mofa(m, Path(workdir) / f"model_{tag}_{rank}.hdf5")
        np.savez(Path(workdir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the inputs, the single-device port and the reference (JAX, imported here)
# ---------------------------------------------------------------------------


def _reference_draws(seed, N, K, Ds):
    import jax
    import jax.numpy as jnp

    z0 = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (N, K), dtype=jnp.float32))
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), 7), max(len(Ds), 1))
    return z0, [np.asarray(jax.random.normal(keys[m], (D, K), dtype=jnp.float32))
                for m, D in enumerate(Ds)]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The starts (the reference's draws), the SVI batches, and the
    single-device port's sweeps and fits from them."""
    f = {"svi_batches": np.stack([np.random.default_rng(9).choice(64, 24, replace=False)
                                  for _ in range(2)])}
    for name, (Ys, _, _, cfg, _, _) in sweep_cases().items():
        z0, w0 = _reference_draws(cfg["seed"], Ys[0].shape[0], cfg["n_factors"],
                                  [Y.shape[1] for Y in Ys])
        f[f"sweep_{name}_Z0"] = z0
        f.update({f"sweep_{name}_W0_{m}": w for m, w in enumerate(w0)})
    for name, (Ys, _, cfg) in fit_cases().items():
        z0, w0 = _reference_draws(cfg["seed"], Ys[0].shape[0], cfg["n_factors"],
                                  [Y.shape[1] for Y in Ys])
        f[f"fit_{name}_Z0"] = z0
        f.update({f"fit_{name}_W0_{m}": w for m, w in enumerate(w0)})
    single = {}
    for name in sweep_cases():
        single[f"sweep_{name}"] = _sweep(name, f)
    for name in fit_cases():
        single[f"fit_{name}"] = _fit(name, f, None,
                                     TRACE_SWEEPS if name == "lik" else FIT_SWEEPS)
    path = tmp_path_factory.mktemp("mofa_inputs") / "inputs.npz"
    np.savez(path, **f)
    return {"path": path, "f": f, "single": single}


def _reference_fit(name, f, P):
    import jax
    from muon_tpu.models import mofa as jm
    from muon_tpu.parallel import make_mesh

    Ys, kw, cfg = fit_cases()[name]
    with jax.enable_x64(False):
        return jm.fit_mofa(Ys, jm.MOFAConfig(**cfg), n_iterations=FIT_SWEEPS,
                           min_iterations=FIT_SWEEPS, convergence_mode="slow", elbo_every=1,
                           mesh=make_mesh(P), **kw)


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda p: f"P{p}")
def run(request, inputs, tmp_path_factory):
    """Spawn the P ranks, run the reference's mesh fits, return both."""
    import shutil

    import torch.multiprocessing as mp

    P = request.param
    work = tmp_path_factory.mktemp(f"mofa_mesh{P}")
    shutil.copy(inputs["path"], work / "inputs.npz")
    ref = {name: _reference_fit(name, inputs["f"], P) for name in ("full", "svi", "ssz")}
    mp.spawn(_rank_main, args=(P, str(work / "store"), str(work)), nprocs=P)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(P)]
    return {"P": P, "ranks": ranks, "port": ranks[0], "ref": ref, "single": inputs["single"]}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total_feat", [None, 120, 600, 2048, 40000])
def test_make_mesh_splits_as_mesh_split(total_feat, monkeypatch):
    # make_mesh needs a process group; its split is mesh_split's (the
    # reference's, held in tests/test_torch_parallel.py) for every world size
    import torch.distributed as dist

    for n in range(1, 17):
        monkeypatch.setattr(dist, "is_initialized", lambda: True)
        monkeypatch.setattr(dist, "get_world_size", lambda n=n: n)
        monkeypatch.setattr(dist, "get_rank", lambda: 0)
        monkeypatch.setattr(dist, "get_backend", lambda: "gloo")
        monkeypatch.setattr(dist, "new_group", lambda ranks: ("group", tuple(ranks)))
        mesh = tpar.make_mesh(n, total_feat=total_feat, device="cpu")
        c, f = tpar.mesh_split(n, total_feat)
        assert mesh.shape == {"cells": c, "feat": f}, n


def test_the_mesh_and_its_groups(run):
    P, ranks = run["P"], run["ranks"]
    cells, feat = {1: (1, 1), 2: (2, 1), 4: (2, 2)}[P]
    for r, out in enumerate(ranks):
        # rank r at (r // feat, r % feat): the reference's reshape(cells, feat)
        assert out["mesh"].tolist() == [cells, feat, r // feat, r % feat]
        assert out["cells_ranks"].tolist() == [c * feat + r % feat for c in range(cells)]
        assert out["feat_ranks"].tolist() == [(r // feat) * feat + f for f in range(feat)]


def test_every_rank_returns_the_whole_result(run):
    first = run["ranks"][0]
    for other in run["ranks"][1:]:
        for key in first:
            if key not in ("mesh", "cells_ranks", "feat_ranks"):
                np.testing.assert_array_equal(other[key], first[key], err_msg=key)


def test_tl_mofa_under_set_options(run):
    # the public tool through the global mesh, obs not padded: the fit of one
    # device by the reference's Z rule
    port = run["port"]
    assert port["tl_mesh"].shape == (485, 4)
    np.testing.assert_allclose(port["tl_mesh"], port["tl_single"], rtol=1e-2, atol=1e-3)


def test_dryrun_multichip_on_the_cpu(capfd):
    tpar.dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: mesh {'cells': 2, 'feat': 2}" in out, out


# ---------------------------------------------------------------------------
# against the port's single-device MOFA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["toy", "lik", "ssz", "svi"])
def test_one_sweep_matches_one_device(run, case):
    want, want_obj = run["single"][f"sweep_{case}"]
    port = run["port"]
    for name, w in want.items():
        g = port[f"sweep_{case}:{name}"]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(g - w).max() <= 1e-5 * scale, (name, np.abs(g - w).max() / scale)
    np.testing.assert_allclose(port[f"sweep_{case}:obj"], want_obj, rtol=1e-5)


@pytest.mark.parametrize("case", ["full", "svi", "ssz", "lik"])
def test_elbo_trace_matches_one_device(run, case):
    want = run["single"][f"fit_{case}"].elbo_history
    got = run["port"][f"fit_{case}:elbo"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:TRACE_SWEEPS], want[:TRACE_SWEEPS], rtol=1e-4)


# ---------------------------------------------------------------------------
# against the reference's fit_mofa(mesh=make_mesh(P)), its own rules
# ---------------------------------------------------------------------------


def _planted_r2(Zx, Z):
    Zi = Zx - Zx.mean(0)
    out = []
    for j in range(Z.shape[1]):
        zt = Z[:, j] - Z[:, j].mean()
        beta, *_ = np.linalg.lstsq(Zi, zt, rcond=None)
        out.append(1 - ((zt - Zi @ beta) ** 2).sum() / (zt ** 2).sum())
    return np.array(out)


def test_full_batch_fit_matches_reference(run):
    # test_fit_mofa_with_mesh: Z at rtol 1e-2 atol 1e-3, planted R² within 0.02
    got, ref = run["port"]["fit_full:Z"], run["ref"]["full"].Z
    np.testing.assert_allclose(got, ref, rtol=1e-2, atol=1e-3)
    Z, _ = planted(0, 96, 3, (40, 32))
    np.testing.assert_allclose(_planted_r2(got, Z), _planted_r2(ref, Z), atol=0.02)


def test_svi_fit_recovers_the_planted_factors(run):
    # test_svi_with_mesh: every planted factor at R² > 0.8, as the reference's
    Z, _ = planted(1, 128, 3, (48,))
    assert (_planted_r2(run["ref"]["svi"].Z, Z) > 0.8).all()
    r2 = _planted_r2(run["port"]["fit_svi:Z"], Z)
    assert (r2 > 0.8).all(), r2


def test_spikeslab_factors_fit_matches_reference(run):
    # test_spikeslab_factors_with_mesh: Z at rtol 1e-2 atol 1e-3
    np.testing.assert_allclose(run["port"]["fit_ssz:Z"], run["ref"]["ssz"].Z, rtol=1e-2,
                               atol=1e-3)
