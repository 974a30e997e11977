"""The port's multiplex Leiden/Louvain (muon_tpu_torch.ops.leiden and
tl.leiden/louvain) held to the JAX package's (muon_tpu.ops.leiden,
mu.tl.leiden/louvain).

The native engines of the two packages share one source
(native/leiden.cpp), so on the same graphs, resolutions, weights and seed
they give the same labels, label for label. The Python engine draws its
randomness differently, so it is held as the reference's tests hold theirs
(tests/test_tools_graph.py::TestLeiden, TestLeidenQuality): the split-off
move, the brute-force optimum, and the planted-cluster ARI.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import muon_tpu as mu
    from muon_tpu.ops import leiden as jl
    from tests import test_tools_graph as ttg
    from tests.test_torch_wnn import clustered_data
except ImportError:
    mu = jl = ttg = clustered_data = None

import muon_tpu_torch as mt
from muon_tpu_torch import native
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import leiden as tl_

CPU = torch.device("cpu")


def _sbm(seed=0, n_per=60, k=4, p_in=0.3, p_out=0.03, weighted=False):
    """A planted k-block graph, symmetric, no diagonal."""
    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(k), n_per)
    P = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    A = (rng.random((k * n_per, k * n_per)) < P).astype(float)
    if weighted:
        A *= rng.integers(1, 4, size=A.shape)
    A = np.triu(A, 1)
    return sp.csr_matrix(A + A.T), labels


def _knn_conn(X, k=15):
    from muon_tpu_torch.ops.fuzzy import compute_connectivities_umap
    from muon_tpu_torch.ops.knn import knn

    idx, dists = knn(X, k=k, device=CPU)
    return compute_connectivities_umap(idx.numpy(), dists, X.shape[0], k + 1, device=CPU)


def _mdata():
    """tests/test_tools_graph.py's mdata_clusters (four planted clusters in
    two modalities), its graphs made by the JAX package."""
    X1, labels = clustered_data(n_per=40, n_clusters=4, d=12, seed=0)
    X2, _ = clustered_data(n_per=40, n_clusters=4, d=9, seed=1)
    m1, m2 = mu.AnnData(X1), mu.AnnData(X2)
    md = mu.MuData({"m1": m1, "m2": m2})
    mu.pp.neighbors(m1, n_neighbors=12)
    mu.pp.neighbors(m2, n_neighbors=12)
    return md, labels


# ---------------------------------------------------------------------------
# the native engine: the same labels as the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph, resolutions, weights, seed, refine", [
    ("sbm", [1.0], [1.0], 0, True),
    ("sbm", [0.5], [1.0], 3, True),
    ("sbm", [1.0], [1.0], 1, False),
    ("sbm2", [1.0, 0.7], [1.0, 0.6], 2, True),
    ("sbm2", [1.3, 1.0], [0.5, 1.0], 5, False),
    ("weighted", [1.0], [1.0], 4, True),
])
def test_native_engine_matches_jax_label_for_label(graph, resolutions, weights, seed, refine):
    if graph == "sbm":
        adjs = [_sbm(seed=seed)[0]]
    elif graph == "sbm2":
        adjs = [_sbm(seed=seed)[0], _sbm(seed=seed + 10, p_in=0.2, p_out=0.05)[0]]
    else:
        adjs = [_sbm(seed=seed, weighted=True)[0]]
    ref = jl.multiplex_leiden(adjs, resolutions, weights, seed=seed, refine=refine)
    got = tl_.multiplex_leiden(adjs, resolutions, weights, seed=seed, refine=refine)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("algorithm", ["leiden", "louvain"])
def test_tl_matches_jax_label_for_label(algorithm):
    md_j, labels = _mdata()
    md_t = md_j.copy()
    getattr(mu.tl, algorithm)(md_j, resolution=1.0, random_state=1)
    getattr(mt.tl, algorithm)(md_t, resolution=1.0, random_state=1)
    np.testing.assert_array_equal(md_t.obs[algorithm].to_numpy(), md_j.obs[algorithm].to_numpy())
    assert list(md_t.obs[algorithm].cat.categories) == list(md_j.obs[algorithm].cat.categories)
    assert md_t.uns[algorithm] == md_j.uns[algorithm]


def test_quality_matches_jax():
    A, labels = _sbm(seed=8)
    B, _ = _sbm(seed=9, p_in=0.2)
    for lab in (labels, np.arange(len(labels)) % 5):
        assert tl_.multiplex_modularity([A, B], lab, [1.0, 0.8], [1.0, 0.5]) == pytest.approx(
            jl.multiplex_modularity([A, B], lab, [1.0, 0.8], [1.0, 0.5]), rel=1e-12)


# ---------------------------------------------------------------------------
# tests/test_tools_graph.py::TestLeiden on the port
# ---------------------------------------------------------------------------


class TestLeiden:
    def test_multiplex_leiden(self):
        md, labels = _mdata()
        mt.tl.leiden(md, resolution=1.0, random_state=1)
        assert "leiden" in md.obs.columns
        assert ttg.ari(labels, md.obs["leiden"].cat.codes.to_numpy()) > 0.9

    def test_leiden_anndata(self):
        md, labels = _mdata()
        ad = md.mod["m1"]
        mt.tl.leiden(ad, resolution=1.0, random_state=1)
        assert ttg.ari(labels, ad.obs["leiden"].cat.codes.to_numpy()) > 0.9
        ref = md.copy().mod["m1"]
        mu.tl.leiden(ref, resolution=1.0, random_state=1)
        np.testing.assert_array_equal(ad.obs["leiden"].to_numpy(), ref.obs["leiden"].to_numpy())

    def test_louvain(self):
        md, labels = _mdata()
        mt.tl.louvain(md, resolution=1.0, random_state=1)
        assert ttg.ari(labels, md.obs["louvain"].cat.codes.to_numpy()) > 0.9

    def test_per_mod_resolution(self):
        md, _ = _mdata()
        ref = md.copy()
        kw = dict(resolution={"m1": 1.0, "m2": 0.8}, mod_weights={"m1": 1.0, "m2": 0.5},
                  random_state=1)
        mt.tl.leiden(md, **kw)
        mu.tl.leiden(ref, **kw)
        assert "leiden" in md.obs.columns
        np.testing.assert_array_equal(md.obs["leiden"].to_numpy(), ref.obs["leiden"].to_numpy())

    def test_resolution_effect(self):
        md, _ = _mdata()
        mt.tl.leiden(md, resolution=0.05, key_added="lo", random_state=1)
        mt.tl.leiden(md, resolution=3.0, key_added="hi", random_state=1)
        assert md.obs["lo"].nunique() <= md.obs["hi"].nunique()

    def test_no_neighbors_raises(self):
        md, _ = _mdata()
        del md.mod["m1"].uns["neighbors"]
        del md.mod["m1"].obsp["connectivities"]
        with pytest.raises(ValueError, match="run neighbors first"):
            mt.tl.leiden(md)


# ---------------------------------------------------------------------------
# tests/test_tools_graph.py::TestLeidenQuality on both engines of the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["native", "python"])
def test_split_off_move(engine):
    # two triangles joined by one weak edge, all in one community at high
    # resolution: isolating a node is a positive-gain move
    A = np.zeros((6, 6))
    for (i, j) in [(0, 1), (1, 2), (0, 2), (3, 4), (4, 5), (3, 5)]:
        A[i, j] = A[j, i] = 1.0
    A[2, 3] = A[3, 2] = 0.1
    layers = [tl_._Layer(sp.csr_matrix(A), 4.0, 1.0, engine=engine)]
    labels = np.zeros(6, dtype=np.int64)  # stuck all-in-one
    moved, _ = tl_._ENGINES[engine].local_move(layers, labels, np.random.default_rng(0))
    assert moved, engine
    assert len(np.unique(labels)) > 1, (engine, labels)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("seed,gamma", [(0, 1.0), (1, 0.7), (2, 1.3)])
def test_bruteforce_optimum_two_layers(engine, seed, gamma):
    rng = np.random.default_rng(seed)
    n = 9
    adjs = []
    for _ in range(2):
        A = (rng.random((n, n)) < 0.35).astype(np.float64)
        A = np.triu(A, 1)
        A = A + A.T
        A *= rng.integers(1, 4, size=(n, n))  # weighted
        A = (A + A.T) / 2
        adjs.append(sp.csr_matrix(A))
    res, wts = [gamma, 1.0], [1.0, 0.6]
    best_q = max(tl_.multiplex_modularity(adjs, lab, res, wts)
                 for lab in ttg.TestLeidenQuality._all_partitions(n))  # Bell(9) = 21147
    # 40 descents: the miss probability of the global optimum is ~1e-3
    got = tl_.multiplex_leiden(adjs, resolutions=res, layer_weights=wts, seed=0,
                               n_iterations=40, engine=engine)
    assert tl_.multiplex_modularity(adjs, got, res, wts) >= best_q - 1e-9


@pytest.mark.parametrize("engine", ["native", "python"])
def test_aggregated_levels_keep_rb_objective(engine):
    # self-loops kept on aggregated levels: a planted 4-block SBM is
    # recovered at resolution 1.0 instead of collapsing to one community
    A, labels = _sbm(seed=0)
    got = tl_.leiden_labels(A, resolution=1.0, seed=0, engine=engine)
    assert got.max() + 1 >= 3, "graph collapsed into too few communities"
    assert ttg.ari(labels, got) > 0.95


@pytest.mark.parametrize("engine", ["native", "python"])
def test_imbalanced_small_cluster_not_absorbed(engine):
    rng = np.random.default_rng(0)
    sizes = (600, 150, 50)
    cents = np.array([[0.0, 0.0, 0.0], [6.0, 0.0, 0.0], [0.0, 6.0, 0.0]])
    X = np.concatenate([c + rng.normal(size=(s, 3)) for s, c in zip(sizes, cents)]
                       ).astype(np.float32)
    labels_true = np.repeat(np.arange(3), sizes)
    conn = _knn_conn(X)
    for seed in range(3 if engine == "native" else 1):
        lab = tl_.multiplex_leiden([conn], resolutions=[0.1], seed=seed, engine=engine)
        assert ttg.ari(labels_true, lab) > 0.9, (seed, ttg.ari(labels_true, lab))
        small = lab[750:]
        assert (small == np.bincount(small).argmax()).mean() > 0.9


def test_overlapping_objective_beats_planted():
    rng = np.random.default_rng(0)
    sizes = (600, 150, 50)
    cents = np.array([[0.0, 0.0, 0.0], [2.2, 0.0, 0.0], [0.0, 2.2, 0.0]])
    X = np.concatenate([c + rng.normal(size=(s, 3)) for s, c in zip(sizes, cents)]
                       ).astype(np.float32)
    labels_true = np.repeat(np.arange(3), sizes)
    conn = _knn_conn(X)
    for res in (0.3, 1.0):
        qs = [tl_.multiplex_modularity([conn], tl_.multiplex_leiden(
            [conn], resolutions=[res], seed=seed, n_iterations=10), [res])
            for seed in range(3)]
        assert min(qs) > tl_.multiplex_modularity([conn], labels_true, [res])
        assert (max(qs) - min(qs)) / abs(max(qs)) < 0.01


@pytest.mark.parametrize("step", ["symmetrize", "aggregate"])
def test_native_steps_match_their_python_versions(step):
    A, labels = _sbm(seed=6, weighted=True)
    A = A + sp.diags(np.arange(A.shape[0], dtype=float) % 3)  # a diagonal to drop or keep
    if step == "symmetrize":
        for drop in (True, False):
            got = tl_._symmetrize_native(sp.csr_matrix(sp.triu(A)), drop, False)
            ref = tl_._symmetrize_py(sp.csr_matrix(sp.triu(A)), drop, False)
            assert abs(got - ref).max() == 0
    else:
        layer = tl_._Layer(A, 1.0, 1.0, drop_selfloops=False, assume_symmetric=True)
        n_comm = int(labels.max()) + 1
        got = tl_._aggregate_native(layer, labels, n_comm)
        ref = tl_._aggregate_py(layer, labels, n_comm)
        np.testing.assert_allclose(got.toarray(), ref.toarray(), rtol=1e-12)


# ---------------------------------------------------------------------------
# the engine is native or raises; the holders are duck-typed
# ---------------------------------------------------------------------------


def test_failed_native_load_raises_without_fallback(monkeypatch):
    def broken():
        raise OSError("no engine")

    monkeypatch.setattr(native, "load_leiden_lib", broken)
    with pytest.raises(OSError, match="no engine"):
        tl_.leiden_labels(_sbm(seed=0)[0])


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "leiden.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native._build_leiden()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_engine_built_into_the_build_directory():
    so = native.leiden_library_path()
    native.load_leiden_lib()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("libmuon_torch_leiden_")
    assert not list(native._HERE.glob("*.so"))


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        tl_.multiplex_leiden([_sbm(seed=0)[0]], engine="igraph")


def test_leiden_on_duck_typed_holders():
    # no pandas on the obs: the labels are an array of strings
    md_j, labels = _mdata()

    class Holder:
        def __init__(self, m):
            self.obs, self.obsp, self.uns = {}, dict(m.obsp), dict(m.uns)

    class MuHolder:
        def __init__(self, md):
            self.mod = {k: Holder(m) for k, m in md.mod.items()}
            self.n_obs = md.n_obs
            self.obsmap = {k: np.asarray(md.obsmap[k]) for k in md.mod}
            self.obs, self.obsp, self.uns = {}, {}, {}

    h = MuHolder(md_j)
    mt.tl.leiden(h, resolution=1.0, random_state=1)
    mu.tl.leiden(md_j, resolution=1.0, random_state=1)
    got = h.obs["leiden"]
    assert isinstance(got, np.ndarray) and got.dtype.kind == "U"
    np.testing.assert_array_equal(got, md_j.obs["leiden"].to_numpy().astype(str))
    assert h.uns["leiden"]["params"] == {"resolution": 1.0, "random_state": 1}


def test_leiden_counts_no_kernel_launch():
    _kernels.reset_launch_counts()
    tl_.leiden_labels(_sbm(seed=0)[0])
    assert not any(_kernels.launch_counts().values())
