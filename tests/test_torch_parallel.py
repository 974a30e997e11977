"""The port's multi-device pipeline (muon_tpu_torch/parallel) held to the JAX
package's sharded programs (muon_tpu/parallel) on the reference's fixtures
(tests/test_multichip.py).

One spawn at each world size P in {1, 2, 4}: P ranks started by
``torch.multiprocessing``, a gloo group on the CPU joined through a
``file://`` store (no TCP port: the suite runs in several workers), one
thread each. Every rank runs every program of the slice on the same host
inputs and writes its results as ``.npz``; the parent runs the JAX package
on ``make_mesh(P, feat=1)`` of its 8 virtual CPU devices and compares. The
rank worker imports no JAX: this module imports it only inside fixtures.
The reference's random draws the port takes as arguments (the rSVD's Ω,
the k-means steps, the UMAP negatives) are made here with its own keys.

Tolerances, each with its reason:

* column sums rtol 1e-6: integer counts, exact in float32.
* TF-IDF rtol 1e-5: the same float32 operations; the port's division by
  the column sum and log1p may differ from XLA's by an ulp.
* rSVD from the reference's Ω: s rtol 1e-4, the columns of U |cos| >
  0.9999: the same algorithm, its sums in another order.
* ring kNN: a squared distance is q² − 2q·b + b² in float32, whose
  cancellation error is about 1e-6·(q² + b²): distances within 1e-5 of
  that scale, and an id differs only where the two ids' exact distances to
  the query lie within it (a near-tie).
* IVF: k-means is held step by step from the reference's own centroids
  (within 1e-5 of the data's scale), and whole runs on data where Lloyd is
  stable (one planted cluster per centroid): the same partition, and the
  neighbour ids by the kNN rule above.
* UMAP: one epoch from the same layout with the reference's negatives,
  atol 1e-4 (the port sums each vertex's attraction directly, the reference
  by a prefix sum); the whole run's draws are the port's, so it is held to
  the reference's quality gate and to itself bit for bit.
* the public tools with ``mesh=`` and under ``set_options(mesh=...)``
  against their single-device results, as TestPublicAPIMesh does.
* ``tl.umap(mesh=)`` against the reference's: its default a and b equal
  (one scipy fit in both), the spectral seed (each package draws its own
  test matrix) by its scale and the planted clusters' separation, as
  tests/test_torch_umap.py holds it; a caller's a and b, and an
  ``init_pos`` other than the spectral seed, as the reference's mesh branch
  takes them: recorded in ``uns`` but not passed to the epochs, so the
  layout is the defaults' (on one device both packages use them).
"""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from scipy.spatial.distance import cdist

from muon_tpu_torch import parallel as tpar

WORLD_SIZES = (1, 2, 4)
LSI_K, LSI_ITERS = 6, 10
KNN_K = 10
IVF_K, IVF_CLUSTERS, IVF_STEPS = 15, 12, 8
UMAP_EPOCHS, UMAP_RS, UMAP_NEG = 100, 0, 5
UMAP_A, UMAP_B = 1.2, 0.7  # a caller's curve, away from find_ab_params' defaults


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


# ---------------------------------------------------------------------------
# the fixtures' data (tests/test_multichip.py), host numpy
# ---------------------------------------------------------------------------


def tfidf_counts():
    """test_sharded_tfidf_matches_single_device's matrix, float32."""
    X = sp.random(600, 300, density=0.05, random_state=np.random.RandomState(0),
                  format="csr", dtype=np.float64)
    X.data = np.ceil(X.data * 4)
    return X.astype(np.float32)


def planted_counts(n=512, d=200, seed=1, g=8, shift=False):
    """test_sharded_lsi_matches_single_device's planted blocks (and, with
    ``shift``, TestPublicAPIMesh._counts: no empty rows)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, g, n)
    dense = rng.poisson(0.3, (n, d)).astype(np.float64)
    for j in range(g):
        cols = slice(j * (d // g), (j + 1) * (d // g))
        dense[lab == j, cols] += rng.poisson(5.0, ((lab == j).sum(), d // g))
    if shift:
        dense[:, 0] += 1.0
    return sp.csr_matrix(dense.astype(np.float32))


def knn_points():
    rng = np.random.default_rng(2)
    return (rng.normal(size=(700, 16)) * 3).astype(np.float32)


def ivf_points():
    """Planted clusters well apart (tests/test_neighbors.py's recipe), one
    k-means centroid per cluster: Lloyd is stable over its steps."""
    rng = np.random.default_rng(8)
    centers = rng.normal(size=(IVF_CLUSTERS, 10)) * 4
    lab = np.repeat(np.arange(IVF_CLUSTERS), 300)
    return (centers[lab] + 0.3 * rng.normal(size=(len(lab), 10))).astype(np.float32), lab


def umap_points():
    """test_sharded_umap's planted clusters."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 5, 1200)
    cents = rng.normal(size=(5, 12)) * 4
    return (cents[labels] + rng.normal(size=(1200, 12))).astype(np.float32), labels


def umap_graph():
    from muon_tpu_torch.ops import fuzzy, knn

    X, _ = umap_points()
    idx, d = knn.knn(X, 15, device="cpu")
    return fuzzy.compute_connectivities_umap(idx.numpy(), d, X.shape[0], 16, device="cpu")


def _csr(f, key):
    return sp.csr_matrix((f[f"{key}_data"], f[f"{key}_indices"], f[f"{key}_indptr"]),
                         shape=tuple(f[f"{key}_shape"]))


def _put_csr(d, key, X):
    X = X.tocsr()
    d.update({f"{key}_data": X.data, f"{key}_indices": X.indices,
              f"{key}_indptr": X.indptr, f"{key}_shape": np.array(X.shape)})


def _tl_umap_cases(umap, make, G, X, mesh, owners):
    """``tl.umap(mesh=)`` of the graph ``G`` in a container made by ``make``:
    with its defaults, with a caller's a and b, and from a random start; the
    layouts, the a and b written to ``uns``, and the spectral seed of the
    default run (recorded where the modules ``owners`` call
    ``spectral_init``)."""
    out = {}
    with _recording_seeds(owners) as seeds:
        for tag, ab in (("default", {}), ("given", dict(a=UMAP_A, b=UMAP_B)),
                        ("random_init", dict(init_pos="random"))):
            h = make(X)
            h.obsp["connectivities"] = G
            h.uns["neighbors"] = {"connectivities_key": "connectivities"}
            umap(h, maxiter=UMAP_EPOCHS, random_state=UMAP_RS, mesh=mesh, **ab)
            out[f"tlumap_{tag}"] = np.asarray(h.obsm["X_umap"])
            params = h.uns["umap"]["params"]
            out[f"tlumap_{tag}_ab"] = np.array([params["a"], params["b"]], np.float64)
    out["tlumap_seed"] = seeds[0]
    return out


@contextmanager
def _recording_seeds(owners):
    """``spectral_init`` wrapped where the modules ``owners`` call it; yields
    the list of what it returns."""
    real, seeds = owners[0].spectral_init, []

    def recording(*args, **kw):
        emb = real(*args, **kw)
        seeds.append(np.array(emb))
        return emb

    for m in owners:
        m.spectral_init = recording
    try:
        yield seeds
    finally:
        for m in owners:
            m.spectral_init = real


# ---------------------------------------------------------------------------
# the rank worker (no JAX)
# ---------------------------------------------------------------------------


def _rank_main(rank, P, store, workdir):
    import torch.distributed as dist

    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import set_options
    from muon_tpu_torch import tl as ttl
    from muon_tpu_torch.ops import umap as tu
    from muon_tpu_torch.parallel import pipeline as tpipe
    from muon_tpu_torch.parallel.pipeline import SHARDED_TAG, row_block, sharded_kmeans

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P)
    try:
        mesh = tpar.make_mesh(P, feat=1, device="cpu")
        f = np.load(Path(workdir) / "inputs.npz")
        out = {}

        X = _csr(f, "tfidf")
        Xs = tpar.shard_rows(X, mesh, pad_multiple=64)
        out["col_sums"] = tpar.sharded_col_sums(Xs).numpy()
        out["tfidf"] = tpar.sharded_values_to_scipy(tpar.sharded_tfidf_data(Xs), X).data

        Ys = tpar.sharded_tfidf_data(tpar.shard_rows(_csr(f, "lsi"), mesh))
        U, s, Vt = tpar.sharded_rsvd(Ys, LSI_K, n_iter=LSI_ITERS, omega=f["omega"])
        out.update(rsvd_U=U.numpy(), rsvd_s=s.numpy(), rsvd_Vt=Vt.numpy())

        D, I = tpar.sharded_knn(f["knn_Z"], mesh, k=KNN_K)
        out.update(knn_D=D.numpy(), knn_I=I.numpy())

        Z = f["ivf_Z"]
        _, lo, hi = row_block(len(Z), mesh)
        Xl = torch.from_numpy(Z[lo:hi])
        out["kmeans_steps"] = np.stack([
            sharded_kmeans(Xl, torch.from_numpy(c), 1, mesh)[0].numpy()
            for c in f["kmeans_cents"][:-1]
        ])
        Ii, Di = tpar.sharded_ivf_knn(Z, mesh, k=IVF_K, n_clusters=IVF_CLUSTERS, seed=0)
        out.update(ivf_I=Ii.numpy(), ivf_D=Di.numpy())
        Is, Ds = tpar.sharded_ivf_knn(f["ivf_small"], mesh, k=5)
        out.update(ivf_small_I=Is.numpy(), ivf_small_D=Ds.numpy())

        G = _csr(f, "umap")
        Vb, v0, v1 = row_block(G.shape[0], mesh)
        negs = f["umap_negs"][rank][: v1 - v0]
        out["umap_epoch"] = tpar.sharded_umap_embed(
            G, mesh, n_epochs=200, random_state=UMAP_RS, init=f["umap_emb0"],
            draw_negatives=lambda epoch: negs, n_run=1)
        out["umap_a"] = tpar.sharded_umap_embed(G, mesh, n_epochs=UMAP_EPOCHS,
                                                random_state=UMAP_RS)
        out["umap_b"] = tpar.sharded_umap_embed(G, mesh, n_epochs=UMAP_EPOCHS,
                                                random_state=UMAP_RS)

        # the public tools: single-device, with mesh=, under set_options
        C = _csr(f, "public")
        a1, a2 = Holder(C.copy()), Holder(C.copy())
        tac.pp.tfidf(a1, device="cpu")
        tac.tl.lsi(a1, n_comps=LSI_K, n_iter=LSI_ITERS, device="cpu")
        tac.pp.tfidf(a2, mesh=mesh)
        out["public_tagged"] = np.array(getattr(a2.X, SHARDED_TAG, None) is not None)
        tac.tl.lsi(a2, n_comps=LSI_K, n_iter=LSI_ITERS, mesh=mesh)
        for tag, a in (("single", a1), ("mesh", a2)):
            out[f"tfidf_{tag}"] = a.X.data
            out[f"lsi_{tag}"] = a.obsm["X_lsi"]
            out[f"stdev_{tag}"] = a.uns["lsi"]["stdev"]
        n1, n2 = Holder(f["neighbors_X"]), Holder(f["neighbors_X"])
        tpp.neighbors(n1, n_neighbors=10, use_rep="X", device="cpu")
        tpp.neighbors(n2, n_neighbors=10, use_rep="X", mesh=mesh)
        out["neighbors_single"] = n1.obsp["distances"].toarray()
        out["neighbors_mesh"] = n2.obsp["distances"].toarray()
        h = Holder(f["umap_X"])
        with set_options(mesh=mesh):
            tpp.neighbors(h, n_neighbors=15, use_rep="X")
            ttl.umap(h, maxiter=UMAP_EPOCHS, random_state=UMAP_RS)
        out["public_umap"] = h.obsm["X_umap"]
        out["public_umap_direct"] = tpar.sharded_umap_embed(
            h.obsp["connectivities"], mesh, n_epochs=UMAP_EPOCHS, random_state=UMAP_RS)
        out.update(_tl_umap_cases(ttl.umap, Holder, G, f["umap_X"], mesh, [tu, tpipe]))
        np.savez(Path(workdir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference (JAX, imported here only)
# ---------------------------------------------------------------------------


def _jax_umap_one_epoch(G, mesh, emb0, P):
    """The reference's sharded UMAP run for one epoch from ``emb0``: its
    spectral seed replaced by emb0, its epoch program built with n_run = 1
    for the first chunk and the later chunks left out; and the negatives it
    draws, per rank, from its keys."""
    import jax
    import muon_tpu.ops.umap as jumap
    import muon_tpu.parallel.pipeline as jpipe

    real = jpipe._umap_epochs_fn.__wrapped__
    calls = []

    def first_epoch_only(mesh_, E_loc, Vb, n_pad, n_true, n_epochs, neg_rate, dims, n_run):
        calls.append(Vb)
        if len(calls) == 1:
            return real(mesh_, E_loc, Vb, n_pad, n_true, n_epochs, neg_rate, dims, 1)
        return lambda emb, heads, tails, eons, *rest: (emb, eons)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jumap, "spectral_init", lambda *a, **k: emb0)
        mp.setattr(jpipe, "_umap_epochs_fn", first_epoch_only)
        emb = jpipe.sharded_umap_embed(G, mesh, n_epochs=200, random_state=UMAP_RS)
    Vb, n = calls[0], G.shape[0]
    key = jax.random.fold_in(jax.random.PRNGKey(UMAP_RS), 0)
    negs = []
    for pid in range(P):
        _, sub = jax.random.split(jax.random.fold_in(key, pid))
        negs.append(np.asarray(jax.random.randint(sub, (Vb, UMAP_NEG), 0, n)))
    return np.asarray(emb), np.stack(negs).astype(np.int32)


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda p: f"P{p}")
def run(request, tmp_path_factory):
    """Spawn the P ranks, run the reference, return both."""
    import jax
    import jax.numpy as jnp
    import torch.multiprocessing as mp
    from muon_tpu.parallel import make_mesh
    from muon_tpu.parallel import pipeline as jp

    P = request.param
    work = tmp_path_factory.mktemp(f"mesh{P}")
    mesh = make_mesh(P, feat=1)
    ref = {}

    X = tfidf_counts()
    Xs = jp.shard_rows(X, mesh, pad_multiple=64)
    ref["col_sums"] = np.asarray(jp.sharded_col_sums(Xs))
    vals = np.asarray(jp.sharded_tfidf_data(Xs).data)
    R = Xs.rows_per_shard
    ref["tfidf"] = np.concatenate([
        vals[i, : X.indptr[min((i + 1) * R, X.shape[0])] - X.indptr[min(i * R, X.shape[0])]]
        for i in range(P)])

    Xl = planted_counts()
    l = LSI_K + 10
    omega = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (Xl.shape[1], l),
                                         dtype=jnp.float32))
    U, s, Vt = jp.sharded_rsvd(jp.sharded_tfidf_data(jp.shard_rows(Xl, mesh)), LSI_K,
                               n_iter=LSI_ITERS, seed=0)
    ref.update(rsvd_U=np.asarray(U), rsvd_s=np.asarray(s), rsvd_Vt=np.asarray(Vt))

    Zk = knn_points()
    D, I = jp.sharded_knn(Zk, mesh, k=KNN_K)
    ref.update(knn_D=np.asarray(D), knn_I=np.asarray(I))

    Zi, _ = ivf_points()
    n, d = Zi.shape
    Rk = -(-n // P)
    blk = max(64, min(8192, (1 << 27) // (IVF_CLUSTERS * 4), Rk))
    Rp = -(-Rk // blk) * blk
    Xp = np.zeros((Rp * P, d), np.float32)
    Xp[:n] = Zi
    valid = np.zeros(Rp * P, bool)
    valid[:n] = True
    step = jp._ivf_kmeans_fn(mesh, Rp, d, IVF_CLUSTERS, 1, blk)
    cents = [Zi[np.random.default_rng(0).choice(n, IVF_CLUSTERS, replace=False)]]
    for _ in range(IVF_STEPS):
        cents.append(np.asarray(step(jnp.asarray(Xp.reshape(P, Rp, d)),
                                     jnp.asarray(valid.reshape(P, Rp)),
                                     jnp.asarray(cents[-1]))[0]))
    ref["kmeans_cents"] = np.stack(cents)
    Ii, Di = jp.sharded_ivf_knn(Zi, mesh, k=IVF_K, n_clusters=IVF_CLUSTERS, seed=0)
    ref.update(ivf_I=np.asarray(Ii), ivf_D=np.asarray(Di))
    small = np.random.default_rng(1).normal(size=(96, 6)).astype(np.float32)

    G = umap_graph()
    emb0 = np.random.default_rng(3).uniform(-10, 10, (G.shape[0], 2)).astype(np.float32)
    ref["umap_epoch"], negs = _jax_umap_one_epoch(G, mesh, emb0, P)
    import muon_tpu as mu
    import muon_tpu.ops.umap as jumap

    with jax.enable_x64(False):
        ref.update(_tl_umap_cases(mu.tl.umap, lambda X: mu.AnnData(X=X), G, umap_points()[0],
                                  mesh, [jumap]))

    inputs = {"omega": omega, "knn_Z": Zk, "ivf_Z": Zi, "kmeans_cents": ref["kmeans_cents"],
              "ivf_small": small, "umap_emb0": emb0, "umap_negs": negs,
              "neighbors_X": (np.random.default_rng(0).normal(size=(400, 12)) * 3)
              .astype(np.float32),
              "umap_X": umap_points()[0]}
    _put_csr(inputs, "tfidf", X)
    _put_csr(inputs, "lsi", Xl)
    _put_csr(inputs, "umap", G)
    _put_csr(inputs, "public", planted_counts(512, 160, seed=0, shift=True))
    np.savez(work / "inputs.npz", **inputs)
    mp.spawn(_rank_main, args=(P, str(work / "store"), str(work)), nprocs=P)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(P)]
    return {"P": P, "ranks": ranks, "port": ranks[0], "ref": ref, "inputs": inputs}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("total_feat", [None, 120, 600, 2048, 40000])
def test_mesh_split_matches_reference(total_feat):
    from muon_tpu.parallel import mesh_split

    for n in range(1, 65):
        assert tpar.mesh_split(n, total_feat) == mesh_split(n, total_feat), n


def test_make_mesh_needs_a_group_and_the_whole_world():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_mesh(2, feat=1, device="cpu")


@pytest.mark.parametrize(
    "key, value",
    [("device", "cpu"), ("spmm_blocks", False), ("compute_dtype", "bfloat16"),
     ("display_style", "html"), ("profile", True)],
)
def test_set_options_refuses_what_the_port_does_not_read(key, value):
    from muon_tpu_torch import set_options
    from muon_tpu_torch._core.config import OPTIONS

    with pytest.raises(NotImplementedError, match="not read by the port"):
        set_options(**{key: value})
    assert OPTIONS == {"mesh": None}
    with pytest.raises(ValueError, match="valid options"):
        set_options(no_such_option=1)


def test_every_rank_returns_the_whole_result(run):
    first = run["ranks"][0]
    for other in run["ranks"][1:]:
        assert first.keys() == other.keys()
        for key in first:
            np.testing.assert_array_equal(other[key], first[key], err_msg=key)


# ---------------------------------------------------------------------------
# the programs against the reference's
# ---------------------------------------------------------------------------


def test_col_sums_match_reference(run):
    np.testing.assert_allclose(run["port"]["col_sums"], run["ref"]["col_sums"], rtol=1e-6)
    X = tfidf_counts()
    np.testing.assert_allclose(run["port"]["col_sums"], np.asarray(X.sum(axis=0)).ravel(),
                               rtol=1e-6)


def test_tfidf_matches_reference(run):
    np.testing.assert_allclose(run["port"]["tfidf"], run["ref"]["tfidf"], rtol=1e-5)


def _col_cos(a, b):
    return np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))


def test_rsvd_matches_reference_from_its_omega(run):
    port, ref = run["port"], run["ref"]
    np.testing.assert_allclose(port["rsvd_s"], ref["rsvd_s"], rtol=1e-4)
    assert (_col_cos(port["rsvd_U"], ref["rsvd_U"]) > 0.9999).all()
    assert (_col_cos(port["rsvd_Vt"].T, ref["rsvd_Vt"].T) > 0.9999).all()


def _near_tie_ids(Z, got_i, want_i, scale, tol=1e-5):
    """Where two neighbour lists differ, the exact squared distances of the
    two ids to the query must lie within ``tol`` of the row's scale."""
    rows, cols = np.nonzero(got_i != want_i)
    Z64 = Z.astype(np.float64)
    d_got = ((Z64[rows] - Z64[got_i[rows, cols]]) ** 2).sum(1)
    d_want = ((Z64[rows] - Z64[want_i[rows, cols]]) ** 2).sum(1)
    bad = np.abs(d_got - d_want) > tol * scale[rows]
    return len(rows), int(bad.sum())


def test_ring_knn_matches_reference(run):
    port, ref = run["port"], run["ref"]
    Z = knn_points()
    q2 = (Z.astype(np.float64) ** 2).sum(1)
    scale = q2 + q2.max()
    assert port["knn_I"].dtype == np.int32 and port["knn_I"].shape == (700, KNN_K + 1)
    err = np.abs(port["knn_D"] - ref["knn_D"]) / scale[:, None]
    assert err.max() <= 1e-5, err.max()
    differ, bad = _near_tie_ids(Z, port["knn_I"], ref["knn_I"], scale)
    assert bad == 0, (differ, bad)
    np.testing.assert_array_equal(port["knn_I"][:, 0], np.arange(700))


def test_kmeans_steps_match_reference(run):
    Z, _ = ivf_points()
    got = run["port"]["kmeans_steps"]
    want = run["ref"]["kmeans_cents"][1:]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(Z).max())


def test_ivf_matches_reference(run):
    port, ref = run["port"], run["ref"]
    Z, _ = ivf_points()
    assert port["ivf_I"].shape == (len(Z), IVF_K + 1)
    np.testing.assert_array_equal(port["ivf_I"][:, 0], np.arange(len(Z)))
    q2 = (Z.astype(np.float64) ** 2).sum(1)
    differ, bad = _near_tie_ids(Z, port["ivf_I"], ref["ivf_I"], q2 + q2.max())
    assert bad == 0, (differ, bad)
    np.testing.assert_allclose(port["ivf_D"], ref["ivf_D"], rtol=1e-3, atol=1e-4)
    # exact neighbours: the partition prunes nothing of these clusters
    exact = np.argsort(cdist(Z, Z), axis=1, kind="stable")[:, 1:IVF_K + 1]
    recall = np.mean([len(set(a) & set(b)) / IVF_K
                      for a, b in zip(port["ivf_I"][:, 1:], exact)])
    assert recall > 0.99, recall
    assert port["ivf_small_I"].shape == (96, 6)
    np.testing.assert_array_equal(port["ivf_small_I"][:, 0], np.arange(96))
    assert np.isfinite(port["ivf_small_D"]).all()


def test_umap_epoch_matches_reference(run):
    np.testing.assert_allclose(run["port"]["umap_epoch"], run["ref"]["umap_epoch"],
                               rtol=0, atol=1e-4)


def _same_over_other(emb, labels):
    D = cdist(emb, emb)
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    return D[same].mean() / D[~same].mean()


def test_umap_quality_and_repeatable(run):
    emb = run["port"]["umap_a"]
    assert emb.shape == (1200, 2) and np.isfinite(emb).all()
    assert _same_over_other(emb, umap_points()[1]) < 0.4
    np.testing.assert_array_equal(run["port"]["umap_b"], emb)


# ---------------------------------------------------------------------------
# the public tools (TestPublicAPIMesh)
# ---------------------------------------------------------------------------


def test_public_tfidf_lsi_mesh(run):
    port = run["port"]
    assert bool(port["public_tagged"]) == (run["P"] > 1)
    np.testing.assert_allclose(port["tfidf_mesh"], port["tfidf_single"], rtol=1e-5, atol=1e-7)
    assert (_col_cos(port["lsi_mesh"], port["lsi_single"]) > 0.999).all()
    np.testing.assert_allclose(port["stdev_mesh"], port["stdev_single"], rtol=1e-3)


def test_public_neighbors_mesh(run):
    port = run["port"]
    np.testing.assert_allclose(port["neighbors_mesh"], port["neighbors_single"], rtol=1e-3,
                               atol=1e-4)


def test_public_umap_under_set_options(run):
    port = run["port"]
    emb = port["public_umap"]
    assert emb.shape == (1200, 2) and np.isfinite(emb).all()
    assert _same_over_other(emb, umap_points()[1]) < 0.6
    if run["P"] > 1:  # a mesh of one rank takes the single-device path
        np.testing.assert_array_equal(emb, port["public_umap_direct"])


def test_public_umap_defaults_match_reference(run):
    # tl.umap(mesh=) with its defaults: the reference's a and b, and a
    # spectral seed at scale 10 that separates the planted clusters as the
    # reference's seed does (each draws its own test matrix)
    port, ref = run["port"], run["ref"]
    np.testing.assert_array_equal(port["tlumap_default_ab"], ref["tlumap_default_ab"])
    labels = umap_points()[1]
    got, want = port["tlumap_seed"], ref["tlumap_seed"]
    assert got.shape == want.shape == (1200, 2)
    assert np.abs(got).max() == pytest.approx(10.0, rel=1e-3)
    r_got, r_ref = _same_over_other(got, labels), _same_over_other(want, labels)
    assert r_ref < 0.8 and r_got < max(0.8, 1.3 * r_ref), (r_got, r_ref)
    assert _same_over_other(port["tlumap_default"], labels) < 0.6


def test_public_umap_takes_the_callers_a_and_b(run):
    # both packages write a caller's a and b to uns; over a mesh of more than
    # one rank both drop them and init_pos, as the reference's mesh branch
    # does (muon_tpu/_core/tools_graph.py:399-412), so each layout is its
    # defaults'; on one device both take them
    port, ref = run["port"], run["ref"]
    for got in (port, ref):
        np.testing.assert_array_equal(got["tlumap_given_ab"], [UMAP_A, UMAP_B])
        for tag in ("given", "random_init"):
            same = np.array_equal(got[f"tlumap_{tag}"], got["tlumap_default"])
            assert same == (run["P"] > 1), (tag, run["P"])


# ---------------------------------------------------------------------------
# on the card (skips without one): each kernel against its plain twin
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k1", [11, 21, 300])
def test_gpu_knn_ring_merge_matches_plain(cuda, k1):
    from muon_tpu_torch.ops import knn as tk

    g = torch.Generator(device=cuda).manual_seed(0)
    Q = torch.randn((1000, 50), generator=g, device=cuda)
    B = torch.randn((900, 50), generator=g, device=cuda)
    sq_q, sq_b = (Q * Q).sum(1), (B * B).sum(1)
    cd = torch.full((1000, k1), float("inf"), device=cuda)
    ci = torch.full((1000, k1), -1, dtype=torch.int32, device=cuda)
    for off in (0, 900, 1800):  # three rounds, the last block half padding
        n = 2250
        got = tk.knn_ring_merge(Q, sq_q, B, sq_b, off, n, cd, ci)
        want = tk.knn_ring_merge_plain(Q, sq_q, B, sq_b, off, n, cd, ci)
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-4)
        assert (got[1] == want[1]).float().mean() > 0.999
        cd, ci = got


@pytest.mark.gpu
def test_gpu_umap_epoch_block_matches_plain(cuda):
    from muon_tpu_torch.ops import umap as tu

    G = umap_graph()
    heads, tails, eps, _, dc = tu.edge_schedule(G, 200)
    n, v0, v1 = G.shape[0], 300, 700
    s, e = np.searchsorted(heads, [v0, v1])
    emb = torch.from_numpy(np.random.default_rng(0).uniform(-10, 10, (n, 2))
                           .astype(np.float32)).to(cuda)
    negs = torch.randint(0, n, (v1 - v0, 5), dtype=torch.int32, device=cuda)
    dcb = torch.from_numpy(dc[v0:v1]).to(cuda)
    outs = []
    for fn in (tu.umap_epoch_block, tu.umap_epoch_block_plain):
        edges = tu.umap_edges(heads[s:e], tails[s:e], eps[s:e], np.zeros(e - s, np.int8),
                              v1 - v0, cuda, v0=v0)
        eons = edges.eps.clone()
        out = torch.empty((v1 - v0, 2), device=cuda)
        fn(emb, out, edges, eons, dcb, negs, v0, 0, 1.0, 1.58, 0.9, 1.0)
        outs.append((out, eons))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-4)
    torch.testing.assert_close(outs[0][1], outs[1][1])


def _block_case(cuda, dim, epoch, neg_rate, v0, seed=0):
    """One epoch's arguments of T41 on the window [v0, v0 + 3000) of a layout
    of v0 + 4000 vertices: skewed rows, a run of 40 empty rows, rows of 0-97
    edges and at each dim's chunk length (the run kernel's C: 3072 edges at
    dim 2, 2048 at 3, 768 at 8) and a 9000-edge row walked in chunks; tails
    anywhere in the layout; no strides; eons that leave some edges due at
    ``epoch``; negatives with self hits (v0 + w), and d2 = 0 on some of the
    long row's edges. Rows longer than 96 edges keep one due edge in 100 and
    the repulsion's weight is clipped at 10, as tests/test_torch_umap.py's
    run cases: a float32 sum of thousands of attractions moves a vertex so
    far that an ulp passes plain's atol, so such sums are held by the first
    design's bits alone."""
    from muon_tpu_torch.ops import umap as tu

    rng = np.random.default_rng(seed)
    nv = 3000
    L = rng.geometric(1 / 25, nv) - 1
    L[100:140] = 0
    special = [0, 1, 31, 32, 33, 64, 65, 96, 97, 767, 768, 769, 2047, 2048, 2049, 3071, 3072,
               3073, 9000]
    L[rng.choice(np.arange(200, nv), len(special), replace=False)] = special
    n = v0 + nv + 1000
    heads = (v0 + np.repeat(np.arange(nv), L)).astype(np.int32)
    tails = rng.integers(0, n, len(heads)).astype(np.int32)
    w = np.maximum(rng.random(len(heads)) ** 2, 0.005)
    eps = (1.0 / w).astype(np.float32)
    eps[rng.random(len(eps)) < 0.2] = 1.0
    eons = eps * rng.uniform(0.3, 3.0, len(eps)).astype(np.float32) + np.float32(epoch // 2)
    long_edges = np.flatnonzero(L[heads - v0] > 96)
    eons[long_edges[long_edges % 100 != 0]] = 1e9
    edges = tu.umap_edges(heads, tails, eps, np.zeros(len(heads), np.int8), nv, cuda, v0=v0)
    gen = torch.Generator(device=cuda).manual_seed(seed + dim)
    emb = (torch.rand((n, dim), generator=gen, device=cuda) * 20 - 10).contiguous()
    hub = v0 + int(np.argmax(L))
    emb[torch.from_numpy(tails[heads == hub][:7]).long().to(cuda)] = emb[hub].clone()
    negs = torch.randint(0, n, (nv, neg_rate), generator=gen, dtype=torch.int32, device=cuda)
    if neg_rate:
        negs[:300, -1] = v0 + torch.arange(300, device=cuda, dtype=torch.int32)
    dc = np.zeros(nv, np.float32)
    np.add.at(dc, heads - v0, 1.0 / eps)
    a, b = tu.find_ab_params()
    return (emb, edges, torch.from_numpy(eons).to(cuda),
            torch.from_numpy(np.minimum(dc, 10)).to(cuda), negs,
            (v0, epoch, tu.epoch_alpha(1.0, epoch, 200), a, b, 1.0))


def _t41_first_design(emb, edges, eons, dcb, negs, v0, epoch, alpha, a, b, gamma):
    """T41's entry point without a plan: the first design's kernel."""
    from muon_tpu_torch.ops import _kernels

    nv, dim = edges.indptr.shape[0] - 1, emb.shape[1]
    out = torch.empty((nv, dim), device=emb.device)
    _kernels.launch("umap_epoch_block", emb.device, emb.data_ptr(), out.data_ptr(),
                    edges.indptr.data_ptr(), edges.tails.data_ptr(), edges.eps.data_ptr(),
                    eons.data_ptr(), dcb.data_ptr(), negs.data_ptr(), 0, 0, int(v0), nv, dim,
                    negs.shape[1], int(epoch), float(alpha), float(a), float(b), float(gamma))
    return out


def test_cpu_umap_epoch_block_builds_no_plan():
    # on the CPU T41's wrapper takes its plain version: it builds no run plan
    # (which needs the kernel library) and counts no launch
    from muon_tpu_torch.ops import _kernels
    from muon_tpu_torch.ops import umap as tu

    cpu = torch.device("cpu")
    emb, edges, eons, dcb, negs, args = _block_case(cpu, 2, 8, 5, 1000)
    nv = edges.indptr.shape[0] - 1
    e_k, e_p = eons.clone(), eons.clone()
    _kernels.reset_launch_counts()
    got = tu.umap_epoch_block(emb, torch.empty((nv, 2)), edges, e_k, dcb, negs, *args)
    assert not edges.plans and not any(_kernels.launch_counts().values())
    want = tu.umap_epoch_block_plain(emb, torch.empty((nv, 2)), edges, e_p, dcb, negs, *args)
    assert torch.equal(got, want) and torch.equal(e_k, e_p)
    assert bool((e_k != eons).any())


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3, 8])
@pytest.mark.parametrize("epoch", [0, 8, 13])
@pytest.mark.parametrize("neg_rate,v0", [(5, 1000), (0, 0), (8, 1000), (12, 1000)])
def test_gpu_umap_epoch_block_runs_keep_the_first_design(cuda, dim, epoch, neg_rate, v0):
    # T41 with its plan (T13's run kernel on the window) against the first
    # design's kernel, reached through the C entry with no plan: the same bits
    # of out_blk and eons, twice; against plain within atol 1e-4 at scale 10,
    # eons exactly. With 12 negatives T41 builds no plan and takes the first
    # design's kernel itself, so there the two are one kernel
    from muon_tpu_torch.ops import _kernels
    from muon_tpu_torch.ops import umap as tu

    emb, edges, eons, dcb, negs, args = _block_case(cuda, dim, epoch, neg_rate, v0)
    nv = edges.indptr.shape[0] - 1
    outs, eonss = [], []
    _kernels.reset_launch_counts()
    for _ in range(2):
        e = eons.clone()
        outs.append(tu.umap_epoch_block(emb, torch.empty((nv, dim), device=cuda), edges, e,
                                        dcb, negs, *args))
        eonss.append(e)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["umap_epoch_block"] == 2
    assert (dim in edges.plans) == (neg_rate <= tu.MAX_NEG_RUN)
    assert torch.equal(outs[0], outs[1]) and torch.equal(eonss[0], eonss[1])
    assert bool((eonss[0] != eons).any()) and bool((eonss[0] == eons).any())
    e_f = eons.clone()
    assert torch.equal(outs[0], _t41_first_design(emb, edges, e_f, dcb, negs, *args))
    assert torch.equal(eonss[0], e_f)
    e_p = eons.clone()
    ref = tu.umap_epoch_block_plain(emb, torch.empty((nv, dim), device=cuda), edges, e_p, dcb,
                                    negs, *args)
    torch.testing.assert_close(outs[0], ref, rtol=0, atol=1e-4)
    assert torch.equal(eonss[0], e_p)


@pytest.mark.gpu
def test_gpu_tfidf_modes_match_plain(cuda):
    from muon_tpu_torch.ops import sparse as dsp

    dX = dsp.from_scipy(planted_counts(), cuda)
    cs = dsp.tfidf_col_sums(dX)
    torch.testing.assert_close(cs, dsp.tfidf_col_sums_plain(dX))
    got = dsp.tfidf_data(dX, col_sums=2 * cs, n_total=3 * dX.n_rows)
    want = dsp.tfidf_data_plain(dX, col_sums=2 * cs, n_total=3 * dX.n_rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
