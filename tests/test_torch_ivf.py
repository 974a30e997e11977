"""The port's IVF kNN (muon_tpu_torch/ops/ivf.py, T14 and T15) held to the
JAX package's (muon_tpu/ops/ivf.py) on the same points.

Tolerances, each with its reason:

* ``build_ivf_layout`` is host numpy in both packages: array for array.
* T15 (k-means assignment): both round the operands of the cross term to
  bfloat16 and sum in float32, in another order. On an integer grid every
  product and sum is exact, so the assignments are equal; on Gaussian data
  at least 99.9% are, and a row that differs is a near-tie of its two scores
  (within 1e-5 of their scale).
* Lloyd's iteration amplifies one flipped row from step to step when a
  planted cluster is split between centroids, so the packages are held
  step by step from the same centroids (1e-5 of the data's scale on the
  update), and whole runs only where k-means is stable (one start per
  planted cluster).
* T14 (search): μ is an argument of the port's search, and the tests hand
  it the reference's (the mean over all QB slots of an item, the padded
  ones gathering row 0). Distances then follow the kNN rule, |Δd²| ≤
  1e-5·(‖q−μ‖² + ‖c−μ‖²), the cancellation error of the expanded form; a
  differing position only at such a near-tie. On integer points with 16
  queries per item that μ is a multiple of 1/16 and every term is exact in
  float32: positions and distances are equal, the many ties included (both
  break them by the place in the probe list). ``ivf_knn`` itself centres on
  the mean of the valid queries only, which rounds less: against the
  reference its distances are held to the reference's own rounding, 1e-5 of
  the norms about the reference's μ.
* scatter back: exact; the square root to rtol 1e-6 (XLA's and torch's
  float32 sqrt may differ by an ulp).
* ``ivf_knn``: the partitions of the two packages may differ (above), so
  each is held to exact kNN (recall ≥ 0.9), and to each other (≥ 0.99) on
  one shared partition, handed over through the partition cache.
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
    from muon_tpu.ops import ivf as ji
    from muon_tpu.ops import knn as jk
except ImportError:
    jax = jnp = mu = ji = jk = None

from muon_tpu_torch import pp as tpp
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import fuzzy as tf
from muon_tpu_torch.ops import ivf as ti
from muon_tpu_torch.ops import knn as tk

CPU = torch.device("cpu")


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


def clustered_data(n_per=40, n_clusters=3, d=12, seed=0, noise=0.3):
    """tests/test_neighbors.py's planted clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4
    X = np.concatenate(
        [centers[i] + noise * rng.normal(size=(n_per, d)) for i in range(n_clusters)]
    ).astype(np.float32)
    return X, np.repeat(np.arange(n_clusters), n_per)


def _recall(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)]))


def _jax_partition(X, C, iters=8, seed=0):
    init = np.random.default_rng(seed).choice(len(X), size=C, replace=False).astype(np.int32)
    cent, a = ji._kmeans_fn()(jnp.asarray(X), jnp.asarray(init), C, iters, 2048)
    return init, np.asarray(cent), np.asarray(a)


# ---------------------------------------------------------------------------
# the host layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["even", "skewed", "truncated", "small_blocks"])
def test_build_ivf_layout_matches_jax(case):
    rng = np.random.default_rng(1)
    C, n, n_probe, QB = 64, 20000, 8, 1024
    p = np.ones(C)
    if case == "skewed":          # clusters wider than L are split, never cut
        p[:3] = 40.0
    elif case == "truncated":     # P_max = 4·n_probe cuts a probe list; own chunk kept
        p[:2], n_probe = 400.0, 2
    elif case == "small_blocks":  # several work items per chunk
        QB = 128
    a = rng.choice(C, size=n, p=p / p.sum()).astype(np.int32)
    a[a == 7] = 8  # an empty cluster
    cent = rng.normal(size=(C, 16)).astype(np.float32)
    ref = ji.build_ivf_layout(a, cent, C, n_probe, QB)
    got = ti.build_ivf_layout(a, cent, C, n_probe, QB)
    assert got[4] == ref[4] and got[4] % 128 == 0
    for g, r in zip(got[:4], ref[:4]):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    order, qids, ppos, pcnt, L = got
    assert sorted(qids[qids >= 0].tolist()) == list(range(n))  # every point queried once
    if case == "skewed":
        assert np.bincount(a).max() > L
    if case == "truncated":
        assert ppos.shape[1] == 4 * n_probe
    # every item's own chunk is in its probe list
    first = qids[:, 0]
    own = ((ppos <= first[:, None]) & (first[:, None] < ppos + pcnt)).any(axis=1)
    assert own.all()


# ---------------------------------------------------------------------------
# T15 and k-means
# ---------------------------------------------------------------------------


def _scores64(X, cent):
    """float64 scores at the reference's rounding points."""
    b = lambda a: torch.from_numpy(a).to(torch.bfloat16).double().numpy()  # noqa: E731
    csq = (cent.astype(np.float64) ** 2).sum(1)
    return csq[None, :] - 2.0 * b(X) @ b(cent).T, csq


def test_kmeans_assign_integer_grid_matches_jax_exactly():
    rng = np.random.default_rng(2)
    X = rng.integers(-8, 9, size=(6000, 16)).astype(np.float32)
    init, _, ref = _jax_partition(X, 64, iters=0)
    got = ti.kmeans_assign(torch.from_numpy(X), torch.from_numpy(X[init]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_kmeans_assign_gaussian_matches_jax():
    X, _ = clustered_data(n_per=2500, n_clusters=8, d=16, seed=4)
    init, _, ref = _jax_partition(X, 64, iters=0)
    got = ti.kmeans_assign(torch.from_numpy(X), torch.from_numpy(X[init])).numpy()
    assert (got == ref).mean() >= 0.999
    S, csq = _scores64(X, X[init])
    rows = np.flatnonzero(got != ref)
    scale = csq[got[rows]] + csq[ref[rows]] + (X[rows].astype(np.float64) ** 2).sum(1)
    assert (np.abs(S[rows, got[rows]] - S[rows, ref[rows]]) <= 1e-5 * scale).all()


def test_kmeans_cross_term_stays_float32():
    # eagerly, a bfloat16 matmul in JAX returns bfloat16; under jit XLA folds
    # the float32 convert into the dot and the cross term is never rounded.
    # On data whose cross terms are large beside the gaps between scores the
    # two differ: the reference as it runs agrees with the float32 cross
    # term (the port's) and not with a rounded one
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(4000, 16)) + 6.0).astype(np.float32)
    init, _, ref = _jax_partition(X, 64, iters=0)
    Xt, ct = torch.from_numpy(X), torch.from_numpy(X[init])
    got = ti.kmeans_assign(Xt, ct).numpy()
    cross16 = (Xt.bfloat16() @ ct.bfloat16().T).float()  # rounded to bfloat16
    rounded = torch.argmin((ct * ct).sum(1)[None, :] - 2.0 * cross16, dim=1).numpy()
    assert (got == ref).mean() >= 0.999
    assert (rounded == ref).mean() < 0.9


def test_kmeans_one_step_matches_jax():
    # one Lloyd step from the same centroids: 1e-5 of the data's scale
    X, _ = clustered_data(n_per=2500, n_clusters=8, d=16, seed=4)
    init, cent1, _ = _jax_partition(X, 64, iters=1)
    Xt = torch.from_numpy(X)
    cent0 = Xt[init.astype(np.int64)]
    a0 = ti.kmeans_assign(Xt, cent0)
    got = ti._update_centroids(Xt, a0, cent0).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, cent1, rtol=0, atol=1e-5 * np.abs(X).max())


def test_kmeans_whole_run_matches_jax_and_keeps_empty_clusters():
    # one start per planted cluster, so Lloyd is stable over its 8 steps
    X, labels = clustered_data(n_per=400, n_clusters=12, d=10, seed=8)
    init = np.array([np.flatnonzero(labels == c)[0] for c in range(12)], np.int32)
    cent_j, a_j = ji._kmeans_fn()(jnp.asarray(X), jnp.asarray(init), 12, 8, 2048)
    cent, a = ti.kmeans(torch.from_numpy(X), init, 12, 8)
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(a.numpy(), labels)
    np.testing.assert_allclose(cent.numpy(), np.asarray(cent_j), rtol=0,
                               atol=1e-5 * np.abs(X).max())
    # a 13th start on the row of the first: the tie goes to the lower
    # cluster, so after one step the 13th is empty and keeps its centroid
    init = np.append(init, init[0])
    cent_j, a_j = ji._kmeans_fn()(jnp.asarray(X), jnp.asarray(init), 13, 1, 2048)
    cent, a = ti.kmeans(torch.from_numpy(X), init, 13, 1)
    np.testing.assert_array_equal(cent.numpy()[12], X[init[0]])
    np.testing.assert_array_equal(np.asarray(cent_j)[12], X[init[0]])
    np.testing.assert_allclose(cent.numpy(), np.asarray(cent_j), rtol=0,
                               atol=1e-5 * np.abs(X).max())
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))


def test_kmeans_is_repeatable():
    X, _ = clustered_data(n_per=500, n_clusters=6, d=8, seed=9)
    init = np.random.default_rng(0).choice(len(X), 32, replace=False)
    c1, a1 = ti.kmeans(torch.from_numpy(X), init, 32, 8)
    c2, a2 = ti.kmeans(torch.from_numpy(X), init, 32, 8)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)


# ---------------------------------------------------------------------------
# T14 and the scatter back
# ---------------------------------------------------------------------------


def _jax_layout(X, C, n_probe=8, QB=1024):
    _, cent, a = _jax_partition(X, C)
    order, qids, ppos, pcnt, L = ji.build_ivf_layout(a, cent, C, n_probe, QB)
    return X[order], order, qids, ppos, pcnt, L


def _jax_item_means(Xs, qids):
    """μ as the reference takes it: over all QB slots, the padded ones
    gathering row 0."""
    return Xs[np.clip(qids, 0, None)].mean(axis=1, dtype=np.float32)


def test_item_means_are_the_means_of_the_valid_queries():
    Xs, _, qids, *_ = _underfilled()
    got = ti.item_means(torch.from_numpy(Xs), torch.from_numpy(qids)).numpy()
    for it in range(len(qids)):
        q = qids[it][qids[it] >= 0]
        np.testing.assert_allclose(got[it], Xs[q].mean(axis=0), rtol=1e-5, atol=1e-6)


def _search_both(Xs, qids, ppos, pcnt, L, k, metric):
    with jax.enable_x64(False):
        rp, rd = ji._search_fn()(jnp.asarray(Xs), jnp.asarray(qids), jnp.asarray(ppos),
                                 jnp.asarray(pcnt), k, L, metric)
        rp, rd = np.asarray(rp), np.asarray(rd)
    t = torch.from_numpy
    mu_ = t(_jax_item_means(Xs, qids))
    gp, gd = ti.ivf_search(t(Xs), t(qids), t(ppos), t(pcnt), mu_, k, L, metric == "cosine")
    return (rp, rd), (gp.numpy(), gd.numpy()), mu_.numpy()


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_ivf_search_matches_jax(metric):
    X, _ = clustered_data(n_per=1000, n_clusters=8, d=16, seed=4)
    if metric == "cosine":
        X = X / np.linalg.norm(X, axis=1, keepdims=True)
    Xs, order, qids, ppos, pcnt, L = _jax_layout(X, 32)
    (rp, rd), (gp, gd), mu_ = _search_both(Xs, qids, ppos, pcnt, L, 15, metric)
    ok = qids >= 0
    assert gp.dtype == np.int32 and gd.dtype == np.float32 and gp.shape == rp.shape
    # the query itself first, at −inf; nothing missing at this size
    assert (gp[ok][:, 0] == qids[ok]).all() and np.isneginf(gd[ok][:, 0]).all()
    assert np.isfinite(gd[ok][:, 1:]).all() and np.isfinite(rd[ok][:, 1:]).all()
    assert (np.diff(gd[ok], axis=1) >= 0).all()
    # padded query slots: position 0 at +inf
    assert (gp[~ok] == 0).all() and np.isposinf(gd[~ok]).all()
    X64 = Xs.astype(np.float64)
    item = np.repeat(np.arange(len(qids)), qids.shape[1]).reshape(qids.shape)[ok]
    qc = X64[qids[ok]] - mu_[item]
    half = 0.5 if metric == "cosine" else 1.0

    def true_d2(pos):
        cc = X64[pos[:, 1:]] - mu_[item][:, None, :]
        return half * ((qc[:, None, :] - cc) ** 2).sum(-1), (cc ** 2).sum(-1)

    dg, csq_g = true_d2(gp[ok])
    dr, csq_r = true_d2(rp[ok])
    bound = 1e-5 * ((qc ** 2).sum(-1)[:, None] + np.maximum(csq_g, csq_r))
    assert (np.abs(gd[ok][:, 1:] - rd[ok][:, 1:]) <= bound).all()
    assert (np.abs(dg - dr) <= bound).all()  # a differing position is a near-tie
    assert (gp[ok] == rp[ok]).mean() >= 0.99


def test_ivf_search_integer_points_match_jax_exactly():
    rng = np.random.default_rng(5)
    X = rng.integers(-4, 5, size=(1500, 8)).astype(np.float32)
    Xs, order, qids, ppos, pcnt, L = _jax_layout(X, 16, n_probe=4, QB=16)
    (rp, rd), (gp, gd), _ = _search_both(Xs, qids, ppos, pcnt, L, 10, "euclidean")
    ok = qids >= 0
    np.testing.assert_array_equal(gd[ok], rd[ok])
    np.testing.assert_array_equal(gp[ok], rp[ok])
    assert (np.diff(gd[ok][:, 1:], axis=1) == 0).mean() > 0.2  # ties abound


def _underfilled():
    """A layout by hand: 300 sorted points, three items; the second probes
    one chunk of 5 points, fewer than k + 1 = 9, and the last one has a
    padded probe slot and padded query slots."""
    rng = np.random.default_rng(6)
    Xs = rng.normal(size=(300, 6)).astype(np.float32)
    QB, L = 64, 128
    qids = np.full((3, QB), -1, np.int32)
    qids[0, :64] = np.arange(0, 64)
    qids[1, :5] = np.arange(100, 105)
    qids[2, :40] = np.arange(200, 240)
    ppos = np.array([[0, 64], [100, -1], [200, -1]], np.int32)
    pcnt = np.array([[64, 36], [5, 0], [100, 0]], np.int32)
    order = rng.permutation(300).astype(np.int32)
    return Xs, order, qids, ppos, pcnt, L


def test_ivf_search_underfilled_item_matches_jax():
    Xs, order, qids, ppos, pcnt, L = _underfilled()
    (rp, rd), (gp, gd), _ = _search_both(Xs, qids, ppos, pcnt, L, 8, "euclidean")
    ok = qids >= 0
    np.testing.assert_array_equal(np.isposinf(gd[ok]), np.isposinf(rd[ok]))
    assert np.isposinf(gd[1, :5, 5:]).all() and np.isfinite(gd[1, :5, 1:5]).all()
    fin = np.isfinite(gd) & ok[..., None]
    np.testing.assert_array_equal(gp[fin], rp[fin])
    np.testing.assert_allclose(gd[fin], rd[fin], rtol=1e-4, atol=1e-5)
    assert (gp[~np.isfinite(gd) & ~np.isneginf(gd)] == 0).all()


@pytest.mark.parametrize("sqrt_", [False, True])
def test_scatter_back_matches_jax(sqrt_):
    Xs, order, qids, ppos, pcnt, L = _underfilled()
    t = torch.from_numpy
    Xt, qt = t(Xs), t(qids)
    pos, dv = ti.ivf_search(Xt, qt, t(ppos), t(pcnt), ti.item_means(Xt, qt), 8, L, False)
    n, k1 = 300, 9
    with jax.enable_x64(False):
        ri, rd = ji._scatter_back_fn()(jnp.asarray(pos.numpy()), jnp.asarray(dv.numpy()),
                                       jnp.asarray(order), jnp.asarray(qids.reshape(-1)),
                                       n, k1, sqrt_)
    gi, gd = ti._scatter_back(pos, dv, t(order), qt.reshape(-1), n, k1, sqrt_)
    assert gi.dtype == torch.int32 and gd.dtype == torch.float32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    if sqrt_:
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-6)
    else:
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    rows = order[100:105]  # the under-filled item: −1 in the places left over
    assert (gi.numpy()[rows, 5:] == -1).all() and (gi.numpy()[rows, :5] >= 0).all()
    assert (gi.numpy()[order[240:]] == -1).all()  # rows no item queried
    assert (gd.numpy()[:, 0] == 0).all()


# ---------------------------------------------------------------------------
# ivf_knn
# ---------------------------------------------------------------------------


def _share_partition(X, C, metric="euclidean"):
    """Hand the port the reference's partition of X through its cache."""
    key = next(k for k in ji._PARTITION_CACHE if k[:2] == X.shape and k[3] == C)
    Xt = ti._ivf_metric(torch.from_numpy(X), metric)[0]
    ti._PARTITION_CACHE[ti._partition_key(Xt, C, 8, 0)] = ji._PARTITION_CACHE[key]


def test_ivf_knn_matches_jax():
    X, _ = clustered_data(n_per=2500, n_clusters=8, d=16, seed=4)
    ji._PARTITION_CACHE.clear()
    ti._PARTITION_CACHE.clear()
    ie = tk.knn(X, 15, device=CPU)[0].numpy()
    ri, rd = ji.ivf_knn(X, 15, n_clusters=64)
    gi, gd = ti.ivf_knn(X, 15, n_clusters=64, device=CPU)  # its own partition
    assert _recall(ri, ie) >= 0.9 and _recall(gi.numpy(), ie) >= 0.9
    _share_partition(X, 64)
    _kernels.reset_launch_counts()
    si, sd = ti.ivf_knn(X, 15, n_clusters=64, device=CPU)
    assert not any(_kernels.launch_counts().values())  # CPU tensors: the plain versions
    assert _recall(si.numpy(), ri) >= 0.99
    same = si.numpy() == ri
    assert same.mean() >= 0.99
    np.testing.assert_allclose(sd.numpy()[same], rd[same], rtol=2e-3)


def test_ivf_knn_long_lists_match_jax():
    # k = 300: lists of 301 places, past the 256 a thread keeps in an array
    # on the card; on one partition the two packages agree as at k = 15
    X, _ = clustered_data(n_per=1000, n_clusters=5, d=10, seed=8)
    ji._PARTITION_CACHE.clear()
    ri, rd = ji.ivf_knn(X, 300, n_clusters=32)
    _share_partition(X, 32)
    gi, gd = ti.ivf_knn(X, 300, n_clusters=32, device=CPU)
    assert gi.shape == (5000, 301)
    same = gi.numpy() == ri
    assert _recall(gi.numpy(), ri) >= 0.99 and same.mean() >= 0.99
    np.testing.assert_allclose(gd.numpy()[same], rd[same], rtol=2e-3)


class TestIvfKnn:
    """tests/test_neighbors.py::TestIvfKnn on the port."""

    def test_recall_vs_exact(self):
        X, _ = clustered_data(n_per=2500, n_clusters=8, d=16, seed=4)
        idx_e, _ = tk.knn(X, 15, device=CPU)
        idx_a, d_a = ti.ivf_knn(X, 15, n_clusters=64, n_probe=8, device=CPU)
        ie, ia = idx_e.numpy(), idx_a.numpy()
        assert _recall(ie, ia) > 0.9
        assert (ia[:, 0] == np.arange(X.shape[0])).all()
        assert np.allclose(d_a.numpy()[:, 0], 0.0)
        assert np.isfinite(d_a.numpy()).all()
        assert (np.diff(d_a.numpy(), axis=1) >= 0).all() and (ia >= 0).all()

    def test_cosine(self):
        X, _ = clustered_data(n_per=1500, n_clusters=6, d=12, seed=5)
        idx_e, _ = tk.knn(X, 10, metric="cosine", device=CPU)
        idx_a, _ = ti.ivf_knn(X, 10, metric="cosine", n_clusters=32, device=CPU)
        assert _recall(idx_e.numpy(), idx_a.numpy()) > 0.85

    def test_method_dispatch(self):
        X, _ = clustered_data(n_per=400, n_clusters=4, d=8, seed=6)
        idx, dists = tk.knn(X, 8, approx=True, method="ivf", device=CPU)
        assert idx.shape == (1600, 9) and dists.shape == (1600, 9)
        assert tk.knn(X, 8, method="ivf", include_self=False, device=CPU)[0].shape == (1600, 8)
        with pytest.raises(NotImplementedError, match="not supported by IVF"):
            tk.knn(X, 8, metric="manhattan", method="ivf", device=CPU)

    def test_partition_cache_reuse_and_no_false_hit(self):
        ti._PARTITION_CACHE.clear()
        X, _ = clustered_data(n_per=800, n_clusters=5, d=10, seed=11)
        idx1, _ = ti.ivf_knn(X, 10, n_clusters=32, device=CPU)
        assert len(ti._PARTITION_CACHE) == 1
        key1, part1 = next(iter(ti._PARTITION_CACHE.items()))
        idx2, _ = ti.ivf_knn(X, 20, n_clusters=32, device=CPU)  # another k, same data
        assert next(iter(ti._PARTITION_CACHE.values()))[1] is part1[1]
        assert _recall(idx1.numpy(), idx2.numpy()) > 0.99
        Y = X + 1.7  # other data, another fingerprint
        ti.ivf_knn(Y, 10, n_clusters=32, device=CPU)
        keys = list(ti._PARTITION_CACHE)
        assert len(keys) == 2 and keys[0] == key1
        for s in range(4):  # at most four partitions are kept, the oldest goes
            ti.ivf_knn(X + 3.0 + s, 10, n_clusters=32, device=CPU)
        assert len(ti._PARTITION_CACHE) == 4 and key1 not in ti._PARTITION_CACHE

    def test_device_out_matches_host(self):
        # the port always returns tensors where the search ran; they hold what
        # the reference's device and host results hold, on one partition
        X, _ = clustered_data(n_per=1000, n_clusters=5, d=10, seed=7)
        ji._PARTITION_CACHE.clear()
        idx_h, d_h = ji.ivf_knn(X, 12, n_clusters=32)
        _share_partition(X, 32)
        idx_d, d_d = ti.ivf_knn(X, 12, n_clusters=32, device=CPU)
        assert torch.is_tensor(idx_d) and idx_d.device == CPU
        same = idx_d.numpy() == idx_h
        assert same.mean() >= 0.99
        assert np.allclose(d_d.numpy()[same], d_h[same], rtol=2e-3)


def test_knn_takes_ivf_above_the_threshold(monkeypatch):
    X, _ = clustered_data(n_per=400, n_clusters=4, d=8, seed=6)
    monkeypatch.setattr(tk, "IVF_THRESHOLD", 1000)
    calls = []
    real = ti.ivf_knn
    monkeypatch.setattr(ti, "ivf_knn", lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    tk.knn(X, 8, approx=True, device=CPU)
    assert len(calls) == 1
    tk.knn(X, 8, approx=False, device=CPU)   # exact stays brute force
    tk.knn(X, 8, approx=True, method="brute", device=CPU)
    assert len(calls) == 1


def test_neighbors_above_the_ivf_threshold_match_jax(monkeypatch):
    # pp.neighbors of one modality reaches IVF through approx (above 20,000
    # rows) once the threshold is lowered, in both packages. The port takes
    # the reference's partition from its cache (k-means is held above), and
    # the graphs are compared by the overlap of their edge sets and by the
    # values on the edges both hold (σ in float32 against the reference's
    # float64 bisection under x64: atol 1e-5)
    X, labels = clustered_data(n_per=2600, n_clusters=8, d=8, seed=12)
    monkeypatch.setattr(tk, "IVF_THRESHOLD", 1000)
    monkeypatch.setattr(jk, "IVF_THRESHOLD", 1000)
    ad = mu.AnnData(X)
    ji._PARTITION_CACHE.clear()
    mu.pp.neighbors(ad, n_neighbors=15)
    _share_partition(X, 128)
    h = Holder(X)
    tpp.neighbors(h, n_neighbors=15, use_rep="X", device=CPU)
    C, Cj = h.obsp["connectivities"], ad.obsp["connectivities"].tocsr()
    D, Dj = h.obsp["distances"], ad.obsp["distances"].tocsr()
    assert (np.diff(D.indptr) == 14).all()
    both = C.multiply(Cj.astype(bool)).tocsr()
    both_j = Cj.multiply(C.astype(bool)).tocsr()
    assert both.nnz / (C.nnz + Cj.nnz - both.nnz) >= 0.95
    db, db_j = D.multiply(Dj.astype(bool)).tocsr(), Dj.multiply(D.astype(bool)).tocsr()
    # the reference centres a short item (162 queries in 1024 slots here)
    # near row 0, far from its queries, so its squared distances carry
    # 1e-5 of norms of about 200 against neighbour gaps of about 0.1: the
    # distances agree to rtol 2e-3, and σ's exponent magnifies that in the
    # memberships: 99% of the shared edges within 1e-3
    np.testing.assert_allclose(db.data, db_j.data, rtol=2e-3)
    assert (np.abs(both.data - both_j.data) <= 1e-3).mean() >= 0.99
    assert (C != C.T).nnz == 0 and C.data.min() > 0 and C.data.max() <= 1
    tag = getattr(C, tf.MEMBERSHIP_TAG)
    assert tag["n"] == len(X) and tag["nnz"] == C.nnz and tag["idx"].shape == (len(X), 15)
    rows = np.repeat(np.arange(len(X)), 14)
    assert (labels[rows] == labels[D.indices]).mean() > 0.95


# ---------------------------------------------------------------------------
# on the card: T14 and T15 against their plain versions (skip without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,C", [(20000, 16, 64), (5000, 50, 100), (3000, 130, 33)])
def test_gpu_kmeans_assign_matches_plain(cuda, n, d, C):
    # d = 130 runs T15's chunked query; C = 33 a ragged last tile
    rng = np.random.default_rng(n)
    X = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(cuda)
    cent = X[torch.from_numpy(rng.choice(n, C, replace=False)).to(cuda)].contiguous()
    _kernels.reset_launch_counts()
    got = ti.kmeans_assign(X, cent)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["kmeans_assign"] == 1
    ref = ti.kmeans_assign_plain(X, cent)
    assert (got == ref).float().mean().item() >= 0.999
    S, csq = _scores64(X.cpu().numpy(), cent.cpu().numpy())
    g, r = got.cpu().numpy(), ref.cpu().numpy()
    rows = np.flatnonzero(g != r)
    scale = csq[g[rows]] + csq[r[rows]] + (X.cpu().numpy()[rows].astype(np.float64) ** 2).sum(1)
    assert (np.abs(S[rows, g[rows]] - S[rows, r[rows]]) <= 1e-5 * scale).all()
    Xi = torch.from_numpy(rng.integers(-8, 9, size=(n, d)).astype(np.float32)).to(cuda)
    ci = Xi[:C].contiguous()
    assert torch.equal(ti.kmeans_assign(Xi, ci), ti.kmeans_assign_plain(Xi, ci))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 200, 300])
@pytest.mark.parametrize("metric,d", [("euclidean", 16), ("cosine", 16), ("euclidean", 130)])
def test_gpu_ivf_search_matches_plain(cuda, metric, d, k):
    # k = 300: lists longer than 256, the heap in the outputs
    X, _ = clustered_data(n_per=1500, n_clusters=8, d=d, seed=4)
    Xt = ti._ivf_metric(torch.from_numpy(X).to(cuda), metric)[0]
    init = np.random.default_rng(0).choice(len(X), 32, replace=False)
    cent, a = ti.kmeans(Xt, init, 32, 8)
    order, qids, ppos, pcnt, L = ti.build_ivf_layout(a.cpu().numpy(), cent.cpu().numpy(),
                                                      32, 8, 1024)
    to = lambda v: torch.from_numpy(v).to(cuda)  # noqa: E731
    Xs = Xt[to(order).long()].contiguous()
    qt = to(qids)
    mu_ = ti.item_means(Xs, qt)
    args = (Xs, qt, to(ppos), to(pcnt), mu_, k, L, metric == "cosine")
    _kernels.reset_launch_counts()
    gp, gd = ti.ivf_search(*args)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["ivf_search" if k < 256 else "ivf_search_global"] == 1
    rp, rd = ti.ivf_search_plain(*args)
    ok = qt >= 0
    assert torch.equal(torch.isinf(gd), torch.isinf(rd))
    assert (gp[~ok] == 0).all() and torch.isposinf(gd[~ok]).all()
    item = torch.arange(len(qids), device=cuda)[:, None].expand_as(qt)[ok]
    qc = Xs[qt[ok].long()] - mu_[item]
    csq = ((Xs[rp[ok].long()] - mu_[item][:, None, :]) ** 2).sum(-1)
    bound = 1e-5 * ((qc ** 2).sum(-1)[:, None] + csq)
    fin = torch.isfinite(rd[ok])
    assert ((gd[ok] - rd[ok]).abs()[fin] <= bound[fin]).all()
    assert (gp[ok] == rp[ok]).float().mean().item() >= 0.99


@pytest.mark.gpu
def test_gpu_ivf_search_integer_points_and_underfilled_match_plain_exactly(cuda):
    rng = np.random.default_rng(5)
    X = rng.integers(-4, 5, size=(1500, 8)).astype(np.float32)
    Xt = torch.from_numpy(X).to(cuda)
    init = rng.choice(len(X), 16, replace=False)
    cent, a = ti.kmeans(Xt, init, 16, 8)
    order, qids, ppos, pcnt, L = ti.build_ivf_layout(a.cpu().numpy(), cent.cpu().numpy(),
                                                      16, 4, 16)
    to = lambda v: torch.from_numpy(v).to(cuda)  # noqa: E731
    Xs = Xt[to(order).long()].contiguous()
    for layout in ((Xs, qids, ppos, pcnt, L),
                   (to(_underfilled()[0]),) + _underfilled()[2:]):
        Xs_, q, pp_, pc, L_ = layout
        qt = to(q)
        # μ over all 16 slots is a multiple of 1/16: every term exact in float32
        mu_ = to(_jax_item_means(Xs_.cpu().numpy(), q))
        args = (Xs_, qt, to(pp_), to(pc), mu_, 8, L_, False)
        gp, gd = ti.ivf_search(*args)
        rp, rd = ti.ivf_search_plain(*args)
        if Xs_ is Xs:  # exact arithmetic: equal, ties included
            assert torch.equal(gp, rp) and torch.equal(gd, rd)
        else:
            assert torch.equal(gp, rp)
            torch.testing.assert_close(gd, rd, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_gpu_kmeans_update_matches_cpu_and_repeats(cuda):
    # the centroid update on the card (sort, float64 segment sums) against
    # the CPU's from the same assignment: float32 rounding of the mean only;
    # and a whole run twice: bit for bit, no float atomics anywhere
    X, labels = clustered_data(n_per=2500, n_clusters=8, d=16, seed=4)
    Xc, Xg = torch.from_numpy(X), torch.from_numpy(X).to(cuda)
    init = np.random.default_rng(0).choice(len(X), 64, replace=False)
    cent0 = Xc[torch.from_numpy(init)]
    a0 = ti.kmeans_assign(Xc, cent0)
    got = ti._update_centroids(Xg, a0.to(cuda), cent0.to(cuda))
    torch.testing.assert_close(got.cpu(), ti._update_centroids(Xc, a0, cent0),
                               rtol=1e-6, atol=1e-6)
    c1, a1 = ti.kmeans(Xg, init, 64, 8)
    c2, a2 = ti.kmeans(Xg, init, 64, 8)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert torch.bincount(a1.long(), minlength=64).sum() == len(X)


@pytest.mark.gpu
def test_gpu_ivf_knn_runs_its_kernels_and_matches_the_cpu_path(cuda):
    X, _ = clustered_data(n_per=2500, n_clusters=8, d=16, seed=4)
    ti._PARTITION_CACHE.clear()
    _kernels.reset_launch_counts()
    gi, gd = ti.ivf_knn(X, 15, n_clusters=64, device=cuda)
    counts = _kernels.launch_counts()
    assert counts["kmeans_assign"] == 9 and counts["ivf_search"] == 1
    assert gi.device.type == "cuda"
    ie = tk.knn(X, 15, device=cuda)[0]
    assert _recall(gi.cpu().numpy(), ie.cpu().numpy()) >= 0.9
    gi2, gd2 = ti.ivf_knn(X, 15, n_clusters=64, device=cuda)  # cached, and repeatable
    assert _kernels.launch_counts()["kmeans_assign"] == 9
    assert torch.equal(gi, gi2) and torch.equal(gd, gd2)


@pytest.mark.gpu
def test_gpu_ivf_wrappers_refuse_bad_input(cuda):
    X = torch.rand((100, 8), device=cuda)
    with pytest.raises(ValueError):
        ti.kmeans_assign(X.double(), X[:4].contiguous())
    with pytest.raises(ValueError):
        ti.kmeans_assign(X, X[:4, :6].contiguous())
    q = torch.arange(100, dtype=torch.int32, device=cuda).reshape(1, 100)
    pp_ = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    pc = torch.full((1, 1), 100, dtype=torch.int32, device=cuda)
    mu_ = X.mean(0, keepdim=True)
    with pytest.raises(ValueError):
        ti.ivf_search(X, q, pp_, pc, mu_, -1, 128, False)  # no place per query
    with pytest.raises(ValueError):
        ti.ivf_search(X, q, pp_, pc, mu_, 5, 64, False)  # a chunk longer than L
    with pytest.raises(ValueError):
        ti.ivf_search(X, q.long(), pp_, pc, mu_, 5, 128, False)
