"""The port's TF-IDF → LSI slice (muon_tpu_torch.atac) held to the JAX
package's (muon_tpu.atac) on deep copies of one AnnData, plus the port's
import boundary."""

import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from scipy.sparse import rand as sprand

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import muon_tpu as mu
    from muon_tpu import atac as jac
except ImportError:
    mu = jac = None

from muon_tpu_torch import atac as tac

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _planted_clusters(seed=5, n=90, d=60, g=5):
    """ATAC-like counts with planted peak blocks per cell group (as in
    tests/test_ops_sparse.py::test_lsi_matches_arpack)."""
    rng = np.random.default_rng(seed)
    dense = rng.poisson(0.2, size=(n, d)).astype(np.float64)
    for i in range(g):
        dense[i * (n // g):(i + 1) * (n // g), i * (d // g):(i + 1) * (d // g)] += \
            rng.poisson(3.0, size=(n // g, d // g))
    return sp.csr_matrix(dense.astype(np.float32))


def _col_cos(a, b):
    return np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))


def test_tfidf_lsi_slice_matches_jax():
    ad_j = mu.AnnData(_planted_clusters())
    ad_t = copy.deepcopy(ad_j)
    jac.pp.tfidf(ad_j)
    jac.tl.lsi(ad_j, n_comps=5, n_iter=12)
    tac.pp.tfidf(ad_t, device=CPU)
    tac.tl.lsi(ad_t, n_comps=5, n_iter=12, device=CPU)

    Xj, Xt = ad_j.X, ad_t.X
    assert sp.issparse(Xt) and Xt.dtype == np.float32
    np.testing.assert_array_equal(Xt.indptr, Xj.indptr)
    np.testing.assert_array_equal(Xt.indices, Xj.indices)
    np.testing.assert_allclose(Xt.data, np.asarray(Xj.data), rtol=1e-5)
    # independent Ω on the two sides: compare invariants, not coordinates
    assert ad_t.obsm["X_lsi"].shape == (90, 5)
    assert ad_t.varm["LSI"].shape == (60, 5)
    assert (_col_cos(ad_t.obsm["X_lsi"], ad_j.obsm["X_lsi"]) >= 1 - 1e-4).all()
    assert (_col_cos(ad_t.varm["LSI"], ad_j.varm["LSI"]) >= 1 - 1e-4).all()
    np.testing.assert_allclose(ad_t.uns["lsi"]["stdev"], ad_j.uns["lsi"]["stdev"],
                               rtol=1e-4)


def test_lsi_of_a_dense_matrix_matches_jax(monkeypatch):
    # the dense branch of randomized_svd, with the reference's Ω drawn in
    # place of the port's own: stdev rtol 1e-4, per-column |cos| >= 1 - 1e-4
    import jax
    import jax.numpy as jnp

    from muon_tpu_torch.ops import linalg as tla

    def jax_omega(d, l, seed, device):
        om = jax.random.normal(jax.random.PRNGKey(seed), (d, l), jnp.float32)
        return torch.tensor(np.asarray(om), device=device)

    monkeypatch.setattr(tla, "draw_omega", jax_omega)
    X = _planted_clusters().toarray()
    ad_j, ad_t = mu.AnnData(X.copy()), mu.AnnData(X.copy())
    jac.tl.lsi(ad_j, n_comps=5)
    tac.tl.lsi(ad_t, n_comps=5, device=CPU)
    np.testing.assert_allclose(ad_t.uns["lsi"]["stdev"], ad_j.uns["lsi"]["stdev"],
                               rtol=1e-4)
    assert (_col_cos(ad_t.obsm["X_lsi"], ad_j.obsm["X_lsi"]) >= 1 - 1e-4).all()
    assert (_col_cos(ad_t.varm["LSI"], ad_j.varm["LSI"]) >= 1 - 1e-4).all()


def test_lsi_embeddings_are_z_scored():
    np.random.seed(11)
    ad = mu.AnnData(sp.random(60, 40, density=0.3, format="csr").astype(np.float32))
    tac.pp.tfidf(ad, device=CPU)
    tac.tl.lsi(ad, n_comps=10, device=CPU)
    emb = ad.obsm["X_lsi"]
    assert emb.shape == (60, 10) and ad.uns["lsi"]["stdev"].shape == (10,)
    np.testing.assert_allclose(emb.mean(axis=0), 0, atol=1e-4)
    np.testing.assert_allclose(emb.std(axis=0), 1, atol=1e-3)
    assert np.all(np.diff(ad.uns["lsi"]["stdev"]) <= 0)


def test_lsi_caps_n_comps_at_the_peak_count():
    ad = mu.AnnData(_planted_clusters(n=40, d=12, g=3))
    tac.tl.lsi(ad, n_comps=50, device=CPU)
    assert ad.obsm["X_lsi"].shape == (40, 12) and ad.varm["LSI"].shape == (12, 12)


def test_lsi_unscaled_embeddings_are_unit_vectors():
    ad = mu.AnnData(_planted_clusters())
    tac.tl.lsi(ad, n_comps=4, scale_embeddings=False, device=CPU)
    np.testing.assert_allclose(np.linalg.norm(ad.obsm["X_lsi"], axis=0), 1, atol=1e-5)


# ---------------------------------------------------------------------------
# TF-IDF contracts of tests/test_atac_preproc.py, on the port
# ---------------------------------------------------------------------------


@pytest.fixture()
def adata_dense():
    np.random.seed(2020)
    return mu.AnnData(np.abs(np.random.normal(size=(4, 5))))


@pytest.fixture()
def adata_sparse():
    np.random.seed(2020)
    return mu.AnnData(sprand(100, 10, density=0.2, format="csr"))


def test_tfidf_golden_dense(adata_dense):
    tac.pp.tfidf(adata_dense, log_tf=True, log_idf=True)
    assert "%.3f" % adata_dense.X[0, 0] == "4.659"
    assert "%.3f" % adata_dense.X[3, 0] == "4.770"


# The golden 18.749 is 18.7485005 in float64, on the rounding boundary of
# its third decimal. The reference's tests reach it in float64 (x64 on);
# the port's sparse path computes in float32 (18.748499), so the sparse
# checks hold the value to float32 precision and the printed golden value
# is checked on the same matrix through the float64 dense branch.
GOLDEN_10_9 = 18.748500474652836


def test_tfidf_golden_sparse(adata_sparse):
    dense = mu.AnnData(adata_sparse.X.toarray())
    tac.pp.tfidf(dense, log_tf=True, log_idf=True)
    assert "%.3f" % dense.X[10, 9] == "18.749"
    tac.pp.tfidf(adata_sparse, log_tf=True, log_idf=True, device=CPU)
    np.testing.assert_allclose(adata_sparse.X[10, 9], GOLDEN_10_9, rtol=1e-6)
    assert "%.3f" % adata_sparse.X[50, 5] == "0.000"


def test_tfidf_on_mudata(adata_sparse):
    md = mu.MuData({"atac": adata_sparse})
    tac.pp.tfidf(md, device=CPU)
    np.testing.assert_allclose(md.mod["atac"].X[10, 9], GOLDEN_10_9, rtol=1e-6)


def test_tfidf_copy_inplace_and_layers(adata_dense):
    orig = adata_dense.X[0, 0]
    cp = tac.pp.tfidf(adata_dense, copy=True)
    assert adata_dense.X[0, 0] == orig and "%.3f" % cp.X[0, 0] == "4.659"
    res = tac.pp.tfidf(adata_dense, inplace=False)
    assert adata_dense.X[0, 0] == orig and "%.3f" % res[0, 0] == "4.659"
    tac.pp.tfidf(adata_dense, to_layer="new")
    assert adata_dense.X[0, 0] == orig and "%.3f" % adata_dense.layers["new"][0, 0] == "4.659"
    adata_dense.layers["counts"] = np.asarray(adata_dense.X).copy() + 1
    tac.pp.tfidf(adata_dense, from_layer="counts")
    assert "%.3f" % adata_dense.X[0, 0] == "2.856"


def test_tfidf_sparse_keeps_structure_and_matches_jax_dense_formula(adata_sparse):
    X = adata_sparse.X.copy()
    ref = jac.pp.tfidf(mu.AnnData(X.toarray()), inplace=False)
    tac.pp.tfidf(adata_sparse, device=CPU)
    assert adata_sparse.X.nnz == X.nnz
    np.testing.assert_array_equal(adata_sparse.X.indptr, X.indptr)
    np.testing.assert_allclose(adata_sparse.X.toarray(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pkg", [jac, tac], ids=["jax", "torch"])
def test_tfidf_argument_errors(pkg, adata_dense):
    with pytest.raises(AttributeError):
        pkg.pp.tfidf(adata_dense, log_tf=True, log_idf=True, log_tfidf=True)
    with pytest.raises(ValueError):
        pkg.pp.tfidf(adata_dense, copy=True, inplace=False)
    with pytest.raises(ValueError):
        pkg.pp.tfidf(adata_dense, to_layer="x", inplace=False)
    with pytest.raises(TypeError):
        pkg.pp.tfidf(mu.MuData({"rna": mu.AnnData(np.ones((3, 2)))}))
    with pytest.raises(TypeError):
        pkg.tl.lsi(mu.MuData({"rna": mu.AnnData(np.ones((3, 2)))}))


def test_unported_branches_raise(adata_sparse):
    with pytest.raises(NotImplementedError, match="the multi-device work, K20"):
        tac.pp.tfidf(adata_sparse, mesh=object())
    with pytest.raises(NotImplementedError, match="the multi-device work, K20"):
        tac.tl.lsi(adata_sparse, mesh=object())

    class Backed:  # the shape of muon_tpu's BackedMatrix
        _sparse, _h5, shape = True, None, (3, 2)

    holder = type("Holder", (), {"X": Backed(), "layers": {}})()
    with pytest.raises(NotImplementedError, match="the out-of-core ingest, K19"):
        tac.pp.tfidf(holder)


@pytest.mark.parametrize("sparse", [True, False])
def test_binarize_matches_jax(sparse):
    np.random.seed(3)
    X = sprand(30, 8, density=0.3, format="csr") * 3
    ad_j = mu.AnnData(X if sparse else X.toarray())
    ad_t = copy.deepcopy(ad_j)
    jac.pp.binarize(ad_j)
    tac.pp.binarize(ad_t)
    a = ad_t.X.toarray() if sparse else ad_t.X
    b = ad_j.X.toarray() if sparse else ad_j.X
    np.testing.assert_array_equal(a, b)
    assert tac.pp.binarize(ad_t, inplace=False) is not None


class Holder:
    """The least AnnData-like object: the port needs no container classes."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.layers = X, {}, {}, {}, {}


def test_slice_runs_on_a_plain_holder():
    h = Holder(_planted_clusters())
    tac.pp.tfidf(h, device=CPU)
    tac.tl.lsi(h, n_comps=5, device=CPU)
    assert h.obsm["X_lsi"].shape == (90, 5) and h.varm["LSI"].shape == (60, 5)


# ---------------------------------------------------------------------------
# import boundary: the port never imports jax, and no container libraries at
# module level
# ---------------------------------------------------------------------------


def _imports(tree, top_level_only):
    nodes = tree.body if top_level_only else ast.walk(tree)
    for node in nodes:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _root(name):
    return name.split(".")[0]


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "muon_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_port_import_boundary(path):
    tree = ast.parse(path.read_text())
    anywhere = {_root(m) for m in _imports(tree, top_level_only=False)}
    assert "jax" not in anywhere and "jaxlib" not in anywhere
    assert "muon_tpu" not in anywhere, anywhere
    # pandas and h5py only inside functions (the card's machine may lack them)
    top = {_root(m) for m in _imports(tree, top_level_only=True)}
    assert not top & {"pandas", "h5py"}, top


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gpu_slice_matches_cpu(cuda):
    ad_c = Holder(_planted_clusters())
    ad_g = Holder(_planted_clusters())
    tac.pp.tfidf(ad_c, device=CPU)
    tac.tl.lsi(ad_c, n_comps=5, n_iter=12, device=CPU)
    tac.pp.tfidf(ad_g, device=cuda)
    tac.tl.lsi(ad_g, n_comps=5, n_iter=12, device=cuda)
    np.testing.assert_allclose(ad_g.X.data, ad_c.X.data, rtol=1e-5, atol=1e-6)
    assert (_col_cos(ad_g.obsm["X_lsi"], ad_c.obsm["X_lsi"]) >= 1 - 1e-4).all()
    np.testing.assert_allclose(ad_g.uns["lsi"]["stdev"], ad_c.uns["lsi"]["stdev"],
                               rtol=1e-4)
