"""The port's UMAP (muon_tpu_torch.ops.umap, T13's plain version on the
CPU, and tl.umap) held to the JAX package's (muon_tpu.ops.umap,
mu.tl.umap), and the whole slice clr → pca → neighbors ×3 → WNN → leiden →
umap against the reference's.

The edge schedule, the curve fit and the stride of every edge are exact.
One epoch of T13's plain version is held to the reference's jitted epoch
program (``_optimize_layout_bucketed_fn``), fed the reference's own
``jax.random`` negatives and the same layout and eons, at atol 1e-4 on a
layout of scale 10; both run in float32 (x64 off, as in production). The
two differ per epoch by a few ulps: the reference sums a bucket by a
float32 prefix sum and a boundary difference, the port directly, and pow
and the sums round differently. Early in the schedule (α near 1) the SGD
amplifies such differences from epoch to epoch, so runs of several epochs
are held epoch by epoch from the reference's own state,
and free-running only late in the schedule, where α is small; the eons,
which do not depend on the layout, are held exactly. Whole runs draw other
random numbers (``torch.Generator`` against ``jax.random``) and are held
by invariants: cluster separation and the planted-label share of each
cell's nearest neighbours in the embedding.

The membership-table spectral seed: one application of the operator (T16's
plain version) against the reference's ``matvec``, rebuilt here from its
``jnp`` ops, at rtol 1e-5 of the column norms (float32 sums in another
order); the whole seed from the reference's own start ``q0`` (the draw is
an argument of the port's ``spectral_init``) to 1e-3 in the sine of the
spanned subspace and |cos| ≥ 0.999 per column (``eigh`` fixes no sign), on
planted clusters, both in float32.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from scipy.spatial.distance import cdist

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    import muon_tpu as mu
    from muon_tpu.ops import fuzzy as jf
    from muon_tpu.ops import umap as ju
    from tests import test_tools_graph as ttg
    from tests.test_torch_wnn import clustered_data
except ImportError:
    jax = jnp = mu = jf = ju = ttg = clustered_data = None

import muon_tpu_torch as mt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import fuzzy as tf
from muon_tpu_torch.ops import umap as tu

CPU = torch.device("cpu")
N_EPOCHS = 200
NEG_RATE = 5


def _graph(n_per=50, n_clusters=4, d=10, seed=0, n_neighbors=10):
    """The fuzzy connectivities of planted clusters (the JAX package's)."""
    X, labels = clustered_data(n_per=n_per, n_clusters=n_clusters, d=d, seed=seed)
    a = mu.AnnData(X)
    mu.pp.neighbors(a, n_neighbors=n_neighbors)
    return a.obsp["connectivities"].tocsr(), labels


def _separation(emb, labels):
    D = cdist(emb, emb)
    same = labels[:, None] == labels[None, :]
    np.fill_diagonal(same, False)
    return D[same].mean() / D[~same].mean()


def _knn_share(emb, labels, k=15):
    D = cdist(emb, emb)
    np.fill_diagonal(D, np.inf)
    nn = np.argsort(D, axis=1)[:, :k]
    return float((labels[nn] == labels[:, None]).mean())


# ---------------------------------------------------------------------------
# host preparation: exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spread, min_dist", [(1.0, 0.5), (1.0, 0.1), (2.0, 0.3)])
def test_find_ab_params_matches_jax(spread, min_dist):
    assert tu.find_ab_params(spread, min_dist) == ju.find_ab_params(spread, min_dist)


@pytest.mark.parametrize("shuffled", [False, True])
@pytest.mark.parametrize("n_epochs", [50, 200, 500])
def test_edge_schedule_matches_jax(shuffled, n_epochs):
    G, _ = _graph()
    G = G.tocoo()
    if shuffled:  # COO rows out of order take the stable head sort
        order = np.random.default_rng(1).permutation(G.nnz)
        G = sp.coo_matrix((G.data[order], (G.row[order], G.col[order])), shape=G.shape)
    for got, ref in zip(tu.edge_schedule(G, n_epochs), ju.edge_schedule(G, n_epochs)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def _bucket_case(E, seed=0):
    """E head-sorted edges with the eps spread of a fuzzy graph (weights
    from (0, 1], pruned below max/n_epochs)."""
    rng = np.random.default_rng(seed)
    n = max(E // 20, 10)
    heads = np.sort(rng.integers(0, n, E)).astype(np.int32)
    tails = rng.integers(0, n, E).astype(np.int32)
    w = rng.random(E) ** 3 + 1e-3
    eps = (w.max() / w).astype(np.float32)
    return heads, tails, eps, n


@pytest.mark.parametrize("E, n_epochs", [(5_000, 200), (2_100_000, 200), (2_100_000, 500),
                                         (2_100_000, 30), (2_000_000, 200)])
def test_bucket_strides_match_jax(E, n_epochs):
    # the stride of every edge is the reference's bucket: 2M edges and more
    # are bucketed by floor(log2 eps), fewer share one stride-1 bucket. The
    # reference's buckets keep the head-sorted order, as the port's mask does
    heads, tails, eps, n = _bucket_case(E)
    shift = tu.bucket_shifts(eps, n_epochs)
    strides, heads_bs, tails_bs, eps_bs, *_ = ju._build_buckets(heads, tails, eps, n, n_epochs)
    assert (E >= 2_000_000) == (len(strides) > 1)
    assert sorted(set((1 << shift.astype(np.int64)).tolist())) == list(strides)
    for s, hb, tb, eb in zip(strides, heads_bs, tails_bs, eps_bs):
        sel = (1 << shift.astype(np.int64)) == s
        m = int(sel.sum())
        np.testing.assert_array_equal(np.asarray(hb)[:m], heads[sel])
        np.testing.assert_array_equal(np.asarray(tb)[:m], tails[sel])
        np.testing.assert_array_equal(np.asarray(eb)[:m], eps[sel])
        assert np.isinf(np.asarray(eb)[m:]).all()  # the reference's pads, never due


@pytest.mark.parametrize("E", [1_966_080, 1_966_081, 1_999_999, 2_000_000])
def test_bucket_shifts_count_the_padded_edges(E):
    # the reference pads its edge list to a 1/16 size class before it
    # buckets, and compares the padded length with 2M: 1,966,080 edges pad to
    # themselves (one bucket), one more pads to 2,097,152 (bucketed)
    heads, tails, eps, n = _bucket_case(E)
    grain = max(8192, 1 << max(E.bit_length() - 4, 3))  # as its umap_embed pads
    E_pad = -(-E // grain) * grain
    hp = np.pad(heads, (0, E_pad - E), constant_values=n - 1)
    tp = np.pad(tails, (0, E_pad - E))
    ep = np.pad(eps, (0, E_pad - E), constant_values=np.inf)
    strides, heads_bs, _, eps_bs, *_ = ju._build_buckets(hp, tp, ep, n, N_EPOCHS)
    assert (E > 1_966_080) == (len(strides) > 1)
    stride = 1 << tu.bucket_shifts(eps, N_EPOCHS).astype(np.int64)
    assert sorted(set(stride.tolist())) == list(strides)
    for s_, hb, eb in zip(strides, heads_bs, eps_bs):
        m = int((stride == s_).sum())
        np.testing.assert_array_equal(np.asarray(hb)[:m], heads[stride == s_])
        np.testing.assert_array_equal(np.asarray(eb)[:m], eps[stride == s_])
        assert np.isinf(np.asarray(eb)[m:]).all()  # only its pads are left


# ---------------------------------------------------------------------------
# T13's plain version against the reference's epoch program
# ---------------------------------------------------------------------------


def _epoch_case(max_exp, seed=0):
    """The fuzzy graph's edge schedule, its buckets split by floor(log2 eps)
    clipped to max_exp (the test builds them, since the reference's
    _build_buckets buckets only from 2M edges), a spectral layout of scale
    10, and the curve parameters."""
    G, labels = _graph(seed=seed)
    n = G.shape[0]
    heads, tails, eps, _, dc = ju.edge_schedule(G, N_EPOCHS)
    shift = np.clip(np.floor(np.log2(np.maximum(eps, 1.0))), 0, max_exp).astype(np.int8)
    emb = ju.spectral_init(G, 2, seed=3)
    a, b = ju.find_ab_params(1.0, 0.5)
    return dict(n=n, heads=heads, tails=tails, eps=eps, dc=dc, shift=shift, emb=emb, a=a, b=b)


def _ref_epochs(c, emb, eons, epoch0, n_run, key):
    """The reference's bucketed epochs from (emb, eons): the new layout, the
    new eons (flat, in edge order), and the negatives it drew."""
    f = ju._optimize_layout_bucketed_fn()
    strides = sorted(set((1 << c["shift"].astype(np.int64)).tolist()))
    sels = [(1 << c["shift"].astype(np.int64)) == s for s in strides]
    lists = {k: [] for k in ("h", "t", "e", "o", "s", "x")}
    for sel in sels:
        starts, ends = ju._row_bounds(c["heads"][sel], c["n"])
        for k, v in (("h", c["heads"][sel]), ("t", c["tails"][sel]), ("e", c["eps"][sel]),
                     ("o", eons[sel]), ("s", starts), ("x", ends)):
            lists[k].append(jnp.asarray(v))
    emb_o, eons_o, _ = f(
        jnp.asarray(emb), tuple(lists["o"]), tuple(lists["t"]), tuple(lists["h"]),
        tuple(lists["e"]), tuple(lists["s"]), tuple(lists["x"]), jnp.asarray(c["dc"]),
        float(epoch0), n_run, N_EPOCHS, c["a"], c["b"], 1.0, 1.0, NEG_RATE, key,
        tuple(strides))
    eons_new = np.empty_like(eons)
    for sel, eo in zip(sels, eons_o):
        eons_new[sel] = np.asarray(eo)
    draws, k = [], key
    for _ in range(n_run):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.randint(sub, (c["n"], NEG_RATE), 0, c["n"]),
                                dtype=np.int32))
    return np.asarray(emb_o), eons_new, draws


def _port_epochs(c, emb, eons, epoch0, draws):
    edges = tu.umap_edges(c["heads"], c["tails"], c["eps"], c["shift"], c["n"], CPU)
    cur, nxt = torch.from_numpy(emb.copy()), torch.empty(emb.shape)
    eons_t = torch.from_numpy(eons.copy())
    for i, negs in enumerate(draws):
        ep = epoch0 + i
        tu.umap_epoch(cur, nxt, edges, eons_t, torch.from_numpy(c["dc"]),
                      torch.from_numpy(negs), ep, tu.epoch_alpha(1.0, ep, N_EPOCHS),
                      c["a"], c["b"], 1.0)
        cur, nxt = nxt, cur
    return cur.numpy(), eons_t.numpy()


@pytest.mark.parametrize("max_exp, epoch0", [(0, 0), (0, 7), (3, 0), (3, 8), (3, 12)])
def test_epoch_matches_jax(max_exp, epoch0):
    # one epoch from the same layout, eons and negatives; with strides 1-8
    # epoch 8 runs every bucket, 12 the strides 1, 2 and 4, 0 all of them
    c = _epoch_case(max_exp)
    with jax.enable_x64(False):
        eons = c["eps"] + np.float32(epoch0 // 2)  # some edges due, some not
        ref, ref_eons, draws = _ref_epochs(c, c["emb"], eons, epoch0, 1, jax.random.PRNGKey(7))
    got, got_eons = _port_epochs(c, c["emb"], eons, epoch0, draws)
    assert np.abs(c["emb"]).max() == pytest.approx(10.0, rel=1e-3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_eons, ref_eons)


@pytest.mark.parametrize("max_exp", [0, 3])
def test_five_epochs_match_jax_epoch_by_epoch(max_exp):
    # five epochs, each from the reference's own state of the epoch before
    c = _epoch_case(max_exp, seed=1)
    emb, eons, key = c["emb"], c["eps"].copy(), jax.random.PRNGKey(11)
    for epoch in range(5):
        with jax.enable_x64(False):
            key, sub = jax.random.split(key)
            ref, ref_eons, draws = _ref_epochs(c, emb, eons, epoch, 1, key)
        got, got_eons = _port_epochs(c, emb, eons, epoch, draws)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got_eons, ref_eons)
        emb, eons, key = ref, ref_eons, sub


@pytest.mark.parametrize("max_exp", [0, 3])
def test_five_epochs_match_jax_free_running(max_exp):
    # five epochs run by each package on its own, late in the schedule
    # (alpha 0.025 to 0.005), where the SGD no longer amplifies the ulps;
    # the eons after five epochs are exact
    c = _epoch_case(max_exp, seed=2)
    with jax.enable_x64(False):
        ref, ref_eons, draws = _ref_epochs(c, c["emb"], c["eps"], 195, 5, jax.random.PRNGKey(3))
    got, got_eons = _port_epochs(c, c["emb"], c["eps"], 195, draws)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_eons, ref_eons)


def test_epoch_negative_quirks_match_jax():
    # a negative that is the vertex itself adds 0; one that sits on the
    # vertex's own position (d2 == 0, another vertex) adds +4.0 to every
    # component (ops/umap.py:386-390); both kept. The reference draws its
    # negatives inside its program, so the layout is edited to put some of
    # its draws on their vertex's position
    c = _epoch_case(0)
    key = jax.random.PRNGKey(0)
    with jax.enable_x64(False):
        negs = np.asarray(jax.random.randint(jax.random.split(key)[1], (c["n"], NEG_RATE),
                                             0, c["n"]))
    emb = c["emb"].copy()
    coincident = [i for i in range(0, c["n"], 9) if negs[i, 0] != i]
    for i in coincident:
        emb[negs[i, 0]] = emb[i]
    assert (negs == np.arange(c["n"])[:, None]).any(), "no self draw at this seed"
    with jax.enable_x64(False):
        ref, ref_eons, draws = _ref_epochs(c, emb, c["eps"], 0, 1, key)
    np.testing.assert_array_equal(draws[0], negs)
    got, got_eons = _port_epochs(c, emb, c["eps"], 0, draws)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # the +4 is there: without it the coincident vertices move otherwise
    moved = _port_epochs(c, emb, c["eps"], 0, [np.where(negs == negs[:, :1], -1, negs)
                                                 .clip(0)])[0]
    assert np.abs(moved[coincident] - got[coincident]).max() > 1e-3


@pytest.mark.parametrize("dim", [2, 3, 12])
def test_epoch_dimensions(dim):
    # 3 components: the same program, one more coordinate; 12: above the 8
    # that T13 keeps in registers (on the card its run-time-dim kernel)
    c = _epoch_case(3)
    emb = np.random.default_rng(dim).uniform(-10, 10, (c["n"], dim)).astype(np.float32)
    with jax.enable_x64(False):
        ref, ref_eons, draws = _ref_epochs(c, emb, c["eps"], 8, 1, jax.random.PRNGKey(dim))
    got, got_eons = _port_epochs(c, emb, c["eps"], 8, draws)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_eons, ref_eons)


# ---------------------------------------------------------------------------
# T22's plain version against the reference's asymmetric program
# ---------------------------------------------------------------------------


def _asym_case(seed=0, directed=True):
    """The upper triangle of the fuzzy graph (each edge once, one way), or
    the whole graph, its edge schedule, the tail order and a spectral layout
    of scale 10."""
    G, labels = _graph(seed=seed)
    if directed:
        G = sp.triu(G).tocsr()
    n = G.shape[0]
    heads, tails, eps, _, _ = ju.edge_schedule(G, N_EPOCHS)
    hs, he = ju._row_bounds(heads, n)
    tsort = np.argsort(tails, kind="stable")
    ts, te = ju._row_bounds(tails[tsort], n)
    emb = ju.spectral_init(sp.csr_matrix(_graph(seed=seed)[0]), 2, seed=3)
    a, b = ju.find_ab_params(1.0, 0.5)
    return dict(n=n, heads=heads, tails=tails, eps=eps, hs=hs, he=he, ts=ts, te=te,
                tsort=tsort.astype(np.int32), emb=emb, a=a, b=b, G=G, labels=labels)


def _ref_asym_epochs(c, emb, eons, epoch0, n_run, key):
    """The reference's _optimize_fn (move_other, asymmetric) from (emb,
    eons): the new layout and eons, and the negatives it drew."""
    f = ju._optimize_fn()
    emb_o, eons_o, _ = f(
        jnp.asarray(emb), jnp.asarray(eons), jnp.asarray(c["heads"]), jnp.asarray(c["tails"]),
        jnp.asarray(c["eps"]), jnp.asarray(c["hs"]), jnp.asarray(c["he"]),
        jnp.asarray(c["ts"]), jnp.asarray(c["te"]), float(epoch0), n_run, N_EPOCHS,
        c["a"], c["b"], 1.0, 1.0, NEG_RATE, key, True, False, jnp.asarray(c["tsort"]))
    draws, k = [], key
    for _ in range(n_run):
        k, sub = jax.random.split(k)
        draws.append(np.asarray(jax.random.randint(sub, (c["n"], NEG_RATE), 0, c["n"]),
                                dtype=np.int32))
    return np.asarray(emb_o), np.asarray(eons_o), draws


def _port_asym_epochs(c, emb, eons, epoch0, draws):
    edges = tu.umap_edges(c["heads"], c["tails"], c["eps"], np.zeros(len(c["eps"]), np.int8),
                          c["n"], CPU)
    by_tail = tu.umap_tails(edges)
    np.testing.assert_array_equal(by_tail.order.numpy(), c["tsort"])
    cur, nxt = torch.from_numpy(emb.copy()), torch.empty(emb.shape)
    eo, eo_next = torch.from_numpy(eons.copy()), torch.empty(len(eons))
    for i, negs in enumerate(draws):
        ep = epoch0 + i
        tu.umap_epoch_asym(cur, nxt, edges, by_tail, eo, eo_next, torch.from_numpy(negs), ep,
                           tu.epoch_alpha(1.0, ep, N_EPOCHS), c["a"], c["b"], 1.0)
        cur, nxt, eo, eo_next = nxt, cur, eo_next, eo
    return cur.numpy(), eo.numpy()


@pytest.mark.parametrize("directed", [True, False])
@pytest.mark.parametrize("epoch0", [0, 7, 150])
def test_asym_epoch_matches_jax(directed, epoch0):
    # one epoch from the same layout, eons and negatives; the whole graph
    # (symmetric) runs the same program under assume_symmetric=False
    c = _asym_case(directed=directed)
    with jax.enable_x64(False):
        eons = c["eps"] + np.float32(epoch0 // 2)  # some edges due, some not
        ref, ref_eons, draws = _ref_asym_epochs(c, c["emb"], eons, epoch0, 1,
                                                jax.random.PRNGKey(5))
    got, got_eons = _port_asym_epochs(c, c["emb"], eons, epoch0, draws)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_eons, ref_eons)
    assert np.abs(got - c["emb"]).max() > 1e-2  # the epoch moved the layout


def test_asym_five_epochs_match_jax_epoch_by_epoch():
    # five epochs, each from the reference's own state of the epoch before
    c = _asym_case(seed=1)
    emb, eons, key = c["emb"], c["eps"].copy(), jax.random.PRNGKey(13)
    for epoch in range(5):
        with jax.enable_x64(False):
            key, sub = jax.random.split(key)
            ref, ref_eons, draws = _ref_asym_epochs(c, emb, eons, epoch, 1, key)
        got, got_eons = _port_asym_epochs(c, emb, eons, epoch, draws)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got_eons, ref_eons)
        emb, eons, key = ref, ref_eons, sub


def test_asym_five_epochs_match_jax_free_running():
    # late in the schedule each package runs on its own
    c = _asym_case(seed=2)
    with jax.enable_x64(False):
        ref, ref_eons, draws = _ref_asym_epochs(c, c["emb"], c["eps"], 195, 5,
                                                jax.random.PRNGKey(3))
    got, got_eons = _port_asym_epochs(c, c["emb"], c["eps"], 195, draws)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got_eons, ref_eons)


@pytest.mark.parametrize("graph", ["directed", "assume_symmetric=False"])
def test_umap_embed_asymmetric_matches_jax_invariants(graph):
    # the whole asymmetric run in both packages (their own random draws):
    # the planted-label share of the layout within 0.05, and no kernel launched
    c = _asym_case(seed=4, directed=graph == "directed")
    kw = {} if graph == "directed" else {"assume_symmetric": False}
    ref = ju.umap_embed(c["G"], n_epochs=200, random_state=4, **kw)
    _kernels.reset_launch_counts()
    got = tu.umap_embed(c["G"], n_epochs=200, random_state=4, device=CPU, **kw)
    assert not any(_kernels.launch_counts().values())
    assert got.shape == ref.shape and np.isfinite(got).all()
    s_ref, s_got = _knn_share(ref, c["labels"]), _knn_share(got, c["labels"])
    assert abs(s_got - s_ref) <= 0.05 and s_got >= 0.9, (s_got, s_ref)


# ---------------------------------------------------------------------------
# spectral init and the whole embedding
# ---------------------------------------------------------------------------


def test_spectral_init_separates_like_jax():
    # the exact path (Dm12·G·Dm12, symmetric rSVD, 4 iterations): its own
    # random test matrix, so the seed is held by separation, and scale 10
    G, labels = _graph()
    got = tu.spectral_init(G, 2, seed=3, device=CPU)
    ref = ju.spectral_init(G, 2, seed=3)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got).max() == pytest.approx(10.0, rel=1e-3)
    r_got, r_ref = _separation(got, labels), _separation(ref, labels)
    assert r_ref < 0.8 and r_got < max(0.8, 1.3 * r_ref), (r_got, r_ref)


def _mdata():
    X1, labels = clustered_data(n_per=40, n_clusters=4, d=12, seed=0)
    X2, _ = clustered_data(n_per=40, n_clusters=4, d=9, seed=1)
    m1, m2 = mu.AnnData(X1), mu.AnnData(X2)
    md = mu.MuData({"m1": m1, "m2": m2})
    mu.pp.neighbors(m1, n_neighbors=12)
    mu.pp.neighbors(m2, n_neighbors=12)
    return md, labels


class TestUMAP:
    """tests/test_tools_graph.py::TestUMAP on the port."""

    def test_umap_mudata(self):
        md, labels = _mdata()
        mu.pp.neighbors(md)
        mt.tl.umap(md, maxiter=100, device=CPU)
        emb = md.obsm["X_umap"]
        assert emb.shape == (md.n_obs, 2) and emb.dtype == np.float32
        assert np.isfinite(emb).all()
        assert _separation(emb, labels) < 0.5
        assert md.uns["umap"]["params"]["random_state"] == 42

    def test_umap_requires_neighbors(self):
        md, _ = _mdata()
        with pytest.raises(ValueError, match="neighbors"):
            mt.tl.umap(md, device=CPU)

    def test_umap_anndata(self):
        md, _ = _mdata()
        ad = md.mod["m1"]
        mt.tl.umap(ad, maxiter=50, device=CPU)
        assert ad.obsm["X_umap"].shape == (ad.n_obs, 2)


@pytest.mark.parametrize("seed", [42, 1])
def test_umap_label_share_matches_jax(seed):
    # the default schedule (500 epochs below 10k cells): the planted-label
    # share of each cell's 15 nearest neighbours in the embedding within
    # 0.05 of the reference's, and the clusters as well separated
    md, labels = _mdata()
    mu.pp.neighbors(md)
    md_t = md.copy()
    mu.tl.umap(md, random_state=seed)
    mt.tl.umap(md_t, random_state=seed, device=CPU)
    s_ref, s_got = _knn_share(md.obsm["X_umap"], labels), _knn_share(md_t.obsm["X_umap"], labels)
    assert abs(s_got - s_ref) <= 0.05, (s_got, s_ref)
    assert _separation(md_t.obsm["X_umap"], labels) < 0.2
    assert md_t.uns["umap"]["params"].keys() == md.uns["umap"]["params"].keys()


def test_umap_refuses_what_is_not_ported():
    md, _ = _mdata()
    mu.pp.neighbors(md)
    # mesh= is ported (tests/test_torch_parallel.py): what is not a Mesh raises
    with pytest.raises(ValueError, match="parallel Mesh"):
        mt.tl.umap(md, mesh=object(), device=CPU)


def test_umap_negatives_from_a_seeded_generator():
    # the same random_state gives the same layout; another one another
    G, _ = _graph()
    e1 = tu.umap_embed(G, n_epochs=20, random_state=5, device=CPU)
    e2 = tu.umap_embed(G, n_epochs=20, random_state=5, device=CPU)
    e3 = tu.umap_embed(G, n_epochs=20, random_state=6, device=CPU)
    np.testing.assert_array_equal(e1, e2)
    assert not np.array_equal(e1, e3)


def test_cpu_umap_counts_no_launch():
    G, _ = _graph()
    _kernels.reset_launch_counts()
    tu.umap_embed(G, n_epochs=5, device=CPU)
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# the membership-table spectral seed (T16's plain version)
# ---------------------------------------------------------------------------


def port_tag(jax_tag, conn):
    """The reference's membership tag as the port's (on ``conn``)."""
    return {"idx": np.asarray(jax_tag["idx"], np.int32),
            "vals": np.asarray(jax_tag["vals"], np.float32), "n": int(jax_tag["n"]),
            "nnz": int(conn.nnz), "set_op_mix_ratio": 1.0}


def jax_tag(tag):
    """The port's membership tag as the reference's."""
    return {"idx": tag["idx"], "vals": tag["vals"], "n": tag["n"]}


def _planted(n_per=300, n_clusters=5, d=10, k=15, seed=0):
    """Overlapping planted clusters and the port's graph of them, tagged."""
    rng = np.random.default_rng(seed)
    cent = rng.normal(size=(n_clusters, d)) * 4
    X = np.concatenate([cent[i] + rng.normal(size=(n_per, d))
                        for i in range(n_clusters)]).astype(np.float32)
    a = mu.AnnData(X)
    mt.pp.neighbors(a, n_neighbors=k, device=CPU)
    return a, np.repeat(np.arange(n_clusters), n_per)


def _table(n=400, k=9, seed=7):
    """A membership table with padding (−1), self slots and an isolated row."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((n, n)), axis=1)[:, :k].astype(np.int32)
    idx[:, 0] = np.arange(n)
    idx[rng.random((n, k)) < 0.1] = -1
    idx[idx == 5] = -1  # nothing points at row 5,
    idx[5] = -1         # and it points nowhere: degree 0
    return idx, rng.random((n, k)).astype(np.float32)


def _jax_matvec(idx, vals, Q):
    """One ``matvec`` of the reference's ``_spectral_membership_fn``, from
    its own ``jnp`` ops (it is a closure there)."""
    idx, vals, Q = jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(Q)
    n, k = idx.shape
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    v = jnp.where((idx < 0) | (idx == rows), 0.0, vals)
    safe = jnp.where(idx < 0, 0, idx)
    deg = v.sum(1) + jax.ops.segment_sum(v.reshape(-1), safe.reshape(-1), num_segments=n)
    s = jnp.where(deg > 0, 1.0 / jnp.sqrt(jnp.maximum(deg, 1e-30)), 0.0)
    X = Q * s[:, None]
    y1 = (v[..., None] * X[safe]).sum(1)
    y2 = jax.ops.segment_sum((v[..., None] * X[:, None, :]).reshape(n * k, -1),
                             safe.reshape(-1), num_segments=n)
    return np.asarray((y1 + y2) * s[:, None]), np.asarray(s)


@pytest.mark.parametrize("m", [1, 10, 16])
def test_membership_matvec_matches_jax(m):
    idx, vals = _table()
    Q = np.random.default_rng(m).normal(size=(len(idx), m)).astype(np.float32)
    with jax.enable_x64(False):
        ref, s_ref = _jax_matvec(idx, vals, Q)
    op = tu.membership_operator(idx, vals, CPU)
    got = tu.membership_matvec(op, torch.from_numpy(Q)).numpy()
    np.testing.assert_allclose(op.s.numpy(), s_ref, rtol=1e-6)
    assert op.s[5] == 0 and (got[5] == 0).all()  # a row of degree 0
    assert got.dtype == np.float32
    assert (np.abs(got - ref).max(axis=0) <= 1e-5 * np.linalg.norm(ref, axis=0)).all()


def test_membership_operator_holds_the_transposed_table():
    idx, vals = _table()
    n, k = idx.shape
    op = tu.membership_operator(idx, vals, CPU)
    rows = np.repeat(np.arange(n), k)
    keep = (idx.reshape(-1) >= 0) & (idx.reshape(-1) != rows)
    W = sp.csr_matrix((vals.reshape(-1)[keep], (rows[keep], idx.reshape(-1)[keep])), shape=(n, n))
    Wt = W.T.tocsr()
    Wt.sort_indices()  # sources ascending per target: the stable sort's order
    np.testing.assert_array_equal(op.t_indptr.numpy(), Wt.indptr)
    np.testing.assert_array_equal(op.t_src.numpy(), Wt.indices)
    np.testing.assert_array_equal(op.t_val.numpy(), Wt.data)
    assert (op.vals.numpy()[~keep.reshape(n, k)] == 0).all()
    deg = np.asarray((W + Wt).sum(axis=1)).ravel()
    np.testing.assert_allclose(op.s.numpy()[deg > 0], deg[deg > 0] ** -0.5, rtol=1e-5)
    with pytest.raises(ValueError):
        tu.membership_operator(idx, vals[:, :-1], CPU)


@pytest.mark.parametrize("seed", [3, 11])
def test_spectral_membership_seed_matches_jax(seed):
    a, _ = _planted()
    conn = a.obsp["connectivities"]
    tag = getattr(conn, tf.MEMBERSHIP_TAG)
    n, m = conn.shape[0], 2 + 8
    with jax.enable_x64(False):
        key = jax.random.PRNGKey(seed)
        q0 = np.asarray(jax.random.normal(key, (n, m), dtype=jnp.float32))
        U_ref = np.asarray(ju._spectral_membership_fn()(
            jnp.asarray(tag["idx"]), jnp.asarray(tag["vals"]), key, m, 6))
        ref = ju.spectral_init(conn, 2, seed=seed, membership=jax_tag(tag),
                               membership_min_nnz=0)
    op = tu.membership_operator(tag["idx"], tag["vals"], CPU)
    U = tu.spectral_membership(op, torch.from_numpy(q0.copy())).numpy()

    def cosines(A, B):
        return np.abs((A * B).sum(0)) / np.linalg.norm(A, axis=0) / np.linalg.norm(B, axis=0)

    def sine(A, B):
        Qa, _ = np.linalg.qr(A.astype(np.float64))
        Qb, _ = np.linalg.qr(B.astype(np.float64))
        c = np.linalg.svd(Qa.T @ Qb, compute_uv=False).min()
        return np.sqrt(max(0.0, 1.0 - c * c))

    assert (cosines(U, U_ref) >= 0.999).all()
    assert sine(U, U_ref) <= 1e-3 and sine(U[:, :3], U_ref[:, :3]) <= 1e-3
    got = tu.spectral_init(conn, 2, seed=seed, membership=tag, membership_min_nnz=0,
                           q0=q0, device=CPU)
    assert got.shape == ref.shape == (n, 2) and got.dtype == np.float32
    assert np.abs(got).max() == pytest.approx(10.0, rel=1e-3)
    assert (cosines(got, ref) >= 0.999).all()
    # without q0 the start comes from a seeded torch.Generator: repeatable
    g1 = tu.spectral_init(conn, 2, seed=seed, membership=tag, membership_min_nnz=0, device=CPU)
    g2 = tu.spectral_init(conn, 2, seed=seed, membership=tag, membership_min_nnz=0, device=CPU)
    np.testing.assert_array_equal(g1, g2)
    with pytest.raises(ValueError, match="q0"):
        tu.spectral_init(conn, 2, membership=tag, membership_min_nnz=0, q0=q0[:, :4],
                         device=CPU)


def test_spectral_seeds_run_on_the_other_packages_table():
    # the tag is the carrier: each package's seed takes the other's table
    a, labels = _planted()
    conn = a.obsp["connectivities"]
    aj = mu.AnnData(np.asarray(a.X))
    mu.pp.neighbors(aj, n_neighbors=15)
    conn_j = aj.obsp["connectivities"].tocsr()
    from_jax = tu.spectral_init(conn_j, 2, seed=3, membership_min_nnz=0, device=CPU,
                                membership=port_tag(conn_j._muon_tpu_membership, conn_j))
    with jax.enable_x64(False):
        from_port = ju.spectral_init(conn, 2, seed=3, membership_min_nnz=0,
                                     membership=jax_tag(getattr(conn, tf.MEMBERSHIP_TAG)))
    assert _separation(from_jax, labels) < 0.8 and _separation(from_port, labels) < 0.8


class TestMembershipSeed:
    """tests/test_tools_graph.py::TestUMAP's two membership tests on the port."""

    def test_spectral_membership_seed_matches_union_seed(self):
        md, labels = _mdata()
        ad = md.mod["m1"]
        mt.pp.neighbors(ad, n_neighbors=12, device=CPU)
        conn = ad.obsp["connectivities"]
        tag = getattr(conn, tf.MEMBERSHIP_TAG, None)
        assert tag is not None, "compute_connectivities_umap must tag"
        fast = tu.spectral_init(conn.tocsr(), 2, seed=3, membership=tag,
                                membership_min_nnz=0, device=CPU)
        ref = tu.spectral_init(conn.tocsr(), 2, seed=3, device=CPU)
        assert fast.shape == ref.shape == (ad.n_obs, 2)
        assert np.isfinite(fast).all()
        r_fast, r_ref = _separation(fast, labels), _separation(ref, labels)
        assert r_ref < 0.8
        assert r_fast < max(0.8, 1.3 * r_ref), (r_fast, r_ref)

    def test_membership_tag_reaches_spectral_init(self, monkeypatch):
        # umap_embed rebinds the graph to a COO copy, which does not carry
        # the tag: it must be read from the matrix tl.umap was given
        md, _ = _mdata()
        ad = md.mod["m1"]
        mt.pp.neighbors(ad, n_neighbors=12, device=CPU)
        assert hasattr(ad.obsp["connectivities"], tf.MEMBERSHIP_TAG)
        seen = {}
        real = tu.spectral_init

        def spy(graph, n_components, seed=0, membership=None, **kw):
            seen["membership"] = membership
            return real(graph, n_components, seed=seed, **kw)

        monkeypatch.setattr(tu, "spectral_init", spy)
        mt.tl.umap(ad, maxiter=5, device=CPU)
        assert seen["membership"] is not None
        assert seen["membership"]["n"] == ad.n_obs


def test_membership_seed_gate(monkeypatch):
    # honoured only from membership_min_nnz edges on (8M by default), for a
    # tag made at mix ratio 1 whose nnz and n are the graph's
    a, _ = _planted(n_per=60)
    conn = a.obsp["connectivities"]
    tag = getattr(conn, tf.MEMBERSHIP_TAG)
    calls = []
    real = tu.spectral_membership
    monkeypatch.setattr(tu, "spectral_membership",
                        lambda *a_, **kw: calls.append(1) or real(*a_, **kw))

    def run(membership, graph=conn, **kw):
        calls.clear()
        tu.spectral_init(graph, 2, seed=0, membership=membership, device=CPU, **kw)
        return len(calls)

    assert tu.MEMBERSHIP_MIN_NNZ == 8_000_000
    assert run(tag) == 0                                   # below the default gate
    assert run(tag, membership_min_nnz=0) == 1
    assert run(tag, membership_min_nnz=conn.nnz + 1) == 0
    assert run(None, membership_min_nnz=0) == 0
    assert run({**tag, "set_op_mix_ratio": 0.5}, membership_min_nnz=0) == 0
    assert run({**tag, "n": tag["n"] + 1}, membership_min_nnz=0) == 0
    edited = conn.copy()                                   # an edge dropped since tagging
    edited.data[0] = 0.0
    edited.eliminate_zeros()
    assert run(tag, graph=edited, membership_min_nnz=0) == 0


# ---------------------------------------------------------------------------
# the whole slice against the reference's
# ---------------------------------------------------------------------------


def _three_modalities(n=300, n_clusters=5, seed=0):
    """Clustered RNA and ATAC counts and protein counts (bench_e2e.py's
    recipe at a small size), and the planted labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_clusters, n)

    def counts(d, per):
        boost = np.ones((n_clusters, d))
        for c in range(n_clusters):
            boost[c, rng.choice(d, size=d // 10, replace=False)] = 8.0
        pop = rng.pareto(1.2, d) + 1.0
        X = np.zeros((n, d), np.float32)
        for i in range(n):
            p = pop * boost[labels[i]]
            np.add.at(X[i], rng.choice(d, size=per, p=p / p.sum()), 1.0)
        return sp.csr_matrix(X)

    rna, atac = counts(400, 80), counts(600, 60)
    cent = rng.normal(size=(n_clusters, 30)) * 2.0
    prot = (np.maximum(cent[labels] + rng.normal(size=(n, 30)), 0.0)
            + rng.poisson(3.0, size=(n, 30))).astype(np.float32)
    return rna, atac, prot, labels


def _slice(pkg, rna, atac, prot, **dev):
    """clr → pca → neighbors ×3 → WNN → leiden → umap through one package's
    public entry points, on fresh containers."""
    ac = pkg.atac
    md = mu.MuData({"rna": mu.AnnData(rna.copy()), "atac": mu.AnnData(atac.copy()),
                    "prot": mu.AnnData(prot.copy())})
    r, a, p = md.mod["rna"], md.mod["atac"], md.mod["prot"]
    r.X = r.X.multiply(1e4 / np.maximum(r.X.sum(axis=1), 1)).tocsr().log1p()
    pkg.pp.pca(r, n_comps=20, **dev)
    ac.pp.tfidf(a, **dev)
    ac.tl.lsi(a, n_comps=20, **dev)
    pkg.prot.pp.clr(p, **dev)
    pkg.pp.pca(p, n_comps=10, **dev)
    pkg.pp.neighbors(r, n_neighbors=15, use_rep="X_pca", **dev)
    pkg.pp.neighbors(a, n_neighbors=15, use_rep="X_lsi", **dev)
    pkg.pp.neighbors(p, n_neighbors=15, use_rep="X_pca", **dev)
    pkg.pp.neighbors(md, **dev)
    pkg.tl.leiden(md, resolution=1.0)
    pkg.tl.umap(md, **dev)
    return md


def test_whole_slice_matches_jax():
    rna, atac, prot, labels = _three_modalities()
    md_j = _slice(mu, rna, atac, prot)
    md_t = _slice(mt, rna, atac, prot, device=CPU)
    lab_j = md_j.obs["leiden"].cat.codes.to_numpy()
    lab_t = md_t.obs["leiden"].cat.codes.to_numpy()
    assert ttg.ari(lab_j, lab_t) >= 0.95, ttg.ari(lab_j, lab_t)
    assert ttg.ari(labels, lab_t) >= 0.9
    # each package draws its own rSVD test matrices, so the modality graphs
    # (and each cell's weights) differ; the mean weights agree
    for m in ("rna", "atac", "prot"):
        assert abs(md_t.obs[f"{m}:mod_weight"].mean() - md_j.obs[f"{m}:mod_weight"].mean()) <= 0.01
    emb_t, emb_j = md_t.obsm["X_umap"], md_j.obsm["X_umap"]
    assert emb_t.shape == (len(labels), 2) and np.isfinite(emb_t).all()
    assert abs(_knn_share(emb_t, labels) - _knn_share(emb_j, labels)) <= 0.05
    assert _separation(emb_t, labels) < 0.5


# ---------------------------------------------------------------------------
# on the card: T13 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _random_graph(n, k, seed):
    """A symmetric kNN-like graph with skewed degrees."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    w = rng.random(n * k).astype(np.float32)
    G = sp.csr_matrix((w, (rows, cols)), shape=(n, n))
    G = G.maximum(G.T).tocsr()
    G.setdiag(0)
    G.eliminate_zeros()
    return G


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 3, 8, 9, 12])
@pytest.mark.parametrize("epoch", [0, 8, 13])
def test_gpu_umap_epoch_matches_plain(cuda, dim, epoch):
    # one epoch, the same layout, eons and negatives: direct sums in other
    # orders and powf against torch's pow, a few ulps of a layout of scale
    # 10 (atol 1e-4); the eons exactly. Up to 8 components the kernel keeps a
    # vertex in registers; 9 and 12 take the kernel with dim at run time
    G = _random_graph(20000, 15, seed=dim)
    heads, tails, eps, _, dc = tu.edge_schedule(G, N_EPOCHS)
    shift = np.clip(np.floor(np.log2(np.maximum(eps, 1.0))), 0, 3).astype(np.int8)
    edges = tu.umap_edges(heads, tails, eps, shift, G.shape[0], cuda)
    gen = torch.Generator(device=cuda).manual_seed(dim)
    emb = (torch.rand((G.shape[0], dim), generator=gen, device=cuda) * 20 - 10).contiguous()
    negs = torch.randint(0, G.shape[0], (G.shape[0], NEG_RATE), generator=gen,
                         dtype=torch.int32, device=cuda)
    negs[:50, 0] = torch.arange(50, device=cuda, dtype=torch.int32)  # self hits
    dct = torch.from_numpy(dc).to(cuda)
    eons_k, eons_p = edges.eps.clone(), edges.eps.clone()
    a, b = tu.find_ab_params()
    alpha = tu.epoch_alpha(1.0, epoch, N_EPOCHS)
    _kernels.reset_launch_counts()
    got = tu.umap_epoch(emb, torch.empty_like(emb), edges, eons_k, dct, negs, epoch,
                        alpha, a, b, 1.0)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["umap_epoch"] == 1
    ref = tu.umap_epoch_plain(emb, torch.empty_like(emb), edges, eons_p, dct, negs, epoch,
                              alpha, a, b, 1.0)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    assert torch.equal(eons_k, eons_p)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [2, 12])
@pytest.mark.parametrize("epoch", [0, 13])
def test_gpu_umap_epoch_asym_matches_plain(cuda, dim, epoch):
    # T22 on a directed graph (each edge one way): the same layout, eons and
    # negatives; direct sums in other orders (atol 1e-4 at scale 10), the
    # eons exactly, and the input eons untouched
    G = sp.triu(_random_graph(20000, 15, seed=dim)).tocsr()
    heads, tails, eps, _, _ = tu.edge_schedule(G, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, np.zeros(len(eps), np.int8), G.shape[0], cuda)
    by_tail = tu.umap_tails(edges)
    gen = torch.Generator(device=cuda).manual_seed(dim)
    emb = (torch.rand((G.shape[0], dim), generator=gen, device=cuda) * 20 - 10).contiguous()
    negs = torch.randint(0, G.shape[0], (G.shape[0], NEG_RATE), generator=gen,
                         dtype=torch.int32, device=cuda)
    negs[:50, 0] = torch.arange(50, device=cuda, dtype=torch.int32)  # self hits
    eons = edges.eps + float(epoch // 2)
    eons_in = eons.clone()
    a, b = tu.find_ab_params()
    args = (negs, epoch, tu.epoch_alpha(1.0, epoch, N_EPOCHS), a, b, 1.0)
    _kernels.reset_launch_counts()
    eo_k, eo_p = torch.empty_like(eons), torch.empty_like(eons)
    got = tu.umap_epoch_asym(emb, torch.empty_like(emb), edges, by_tail, eons, eo_k, *args)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert counts["umap_epoch_asym"] == 1 and counts["umap_epoch"] == 0
    ref = tu.umap_epoch_asym_plain(emb, torch.empty_like(emb), edges, by_tail, eons, eo_p, *args)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    assert torch.equal(eo_k, eo_p) and torch.equal(eons, eons_in)


@pytest.mark.gpu
def test_gpu_umap_embed_asymmetric_runs_t22(cuda):
    G = sp.triu(_random_graph(3000, 10, seed=1)).tocsr()
    _kernels.reset_launch_counts()
    emb = tu.umap_embed(G, n_epochs=50, init="random", device=cuda)
    counts = _kernels.launch_counts()
    assert counts["umap_epoch_asym"] == 50 and counts["umap_epoch"] == 0
    assert emb.shape == (3000, 2) and np.isfinite(emb).all()
    heads, tails, eps, _, _ = tu.edge_schedule(G, 50)
    edges = tu.umap_edges(heads, tails, eps, np.zeros(len(eps), np.int8), 3000, cuda)
    e = torch.zeros((3000, 2), device=cuda)
    negs = torch.zeros((3000, 5), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="alias"):
        tu.umap_epoch_asym(e, torch.zeros_like(e), edges, tu.umap_tails(edges), edges.eps,
                           edges.eps, negs, 0, 1.0, 1.0, 1.0, 1.0)


@pytest.mark.gpu
def test_gpu_umap_epoch_refuses_bad_input(cuda):
    G = _random_graph(100, 5, seed=0)
    heads, tails, eps, _, dc = tu.edge_schedule(G, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, np.zeros(len(eps), np.int8), 100, cuda)
    emb = torch.zeros((100, 2), device=cuda)
    dct = torch.from_numpy(dc).to(cuda)
    negs = torch.zeros((100, 5), dtype=torch.int32, device=cuda)
    args = (edges, edges.eps.clone(), dct, negs, 0, 1.0, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="alias"):
        tu.umap_epoch(emb, emb, *args)
    with pytest.raises(ValueError, match="components"):
        tu.umap_epoch(torch.zeros((100, 1), device=cuda), torch.zeros((100, 1), device=cuda),
                      *args)
    with pytest.raises(TypeError):
        tu.umap_epoch(emb, torch.empty_like(emb), edges, edges.eps.clone(), dct, negs.long(),
                      0, 1.0, 1.0, 1.0, 1.0)


@pytest.mark.gpu
def test_gpu_umap_matches_cpu_invariants(cuda):
    # the whole tl.umap on the card: T13 every epoch, T2 in the spectral
    # init; its own random draws, so held by separation
    X, labels = np.random.default_rng(0).normal(size=(2000, 10)), np.repeat(np.arange(4), 500)
    X = (X + np.repeat(np.random.default_rng(1).normal(size=(4, 10)) * 4, 500, axis=0)
         ).astype(np.float32)

    class Holder:
        def __init__(self, X):
            self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}

    h = Holder(X)
    mt.pp.neighbors(h, n_neighbors=15, use_rep="X", device=cuda)
    _kernels.reset_launch_counts()
    mt.tl.umap(h, maxiter=100, device=cuda)
    counts = _kernels.launch_counts()
    assert counts["umap_epoch"] == 100 and counts["csr_spmm_f32"] >= 1
    emb = h.obsm["X_umap"]
    assert emb.shape == (2000, 2) and np.isfinite(emb).all()
    assert _separation(emb, labels) < 0.5


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 10, 16])
def test_gpu_membership_matvec_matches_plain(cuda, m):
    # float32 sums in another order: rtol 1e-5 of the column norms; no
    # atomics, so a second launch repeats the first bit for bit
    idx, vals = _table(n=5000, k=20)
    op = tu.membership_operator(idx, vals, cuda)
    Q = torch.from_numpy(np.random.default_rng(m).normal(size=(5000, m)).astype(np.float32))
    Q = Q.to(cuda)
    _kernels.reset_launch_counts()
    got = tu.membership_matvec(op, Q)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["membership_matvec"] == 1
    ref = tu.membership_matvec_plain(op, Q)
    assert ((got - ref).abs().amax(dim=0) <= 1e-5 * torch.linalg.norm(ref, dim=0)).all()
    assert torch.equal(got, tu.membership_matvec(op, Q))
    assert (got[5] == 0).all()
    cpu = tu.membership_operator(idx, vals, CPU)
    for a_, b_ in zip(op, cpu):  # the operator itself is the CPU's, s to rounding
        if a_.dtype == torch.float32:
            torch.testing.assert_close(a_.cpu(), b_, rtol=1e-6, atol=0)
        else:
            assert torch.equal(a_.cpu(), b_)


@pytest.mark.gpu
def test_gpu_spectral_membership_launches_t16_and_matches_cpu(cuda):
    idx, vals = _table(n=3000, k=15)
    gen = torch.Generator().manual_seed(0)
    q0 = torch.randn((3000, 10), generator=gen)
    _kernels.reset_launch_counts()
    U = tu.spectral_membership(tu.membership_operator(idx, vals, cuda), q0.to(cuda))
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["membership_matvec"] == 13
    U_cpu = tu.spectral_membership(tu.membership_operator(idx, vals, CPU), q0)
    cos = (U.cpu() * U_cpu).sum(0).abs() / torch.linalg.norm(U.cpu(), dim=0) \
        / torch.linalg.norm(U_cpu, dim=0)
    assert (cos[:3] >= 0.999).all()


@pytest.mark.gpu
def test_gpu_membership_matvec_refuses_bad_input(cuda):
    idx, vals = _table(n=200, k=6)
    op = tu.membership_operator(idx, vals, cuda)
    Q = torch.rand((200, 4), device=cuda)
    with pytest.raises(ValueError):
        tu.membership_matvec(op, Q.double())
    with pytest.raises(ValueError):
        tu.membership_matvec(op, torch.rand((200, 17), device=cuda))
    with pytest.raises(ValueError):
        tu.membership_matvec(op, Q[:100])
    with pytest.raises(ValueError):
        tu.membership_matvec(op._replace(s=op.s.cpu()), Q)
