"""The port's per-modality PCA → neighbors slice (muon_tpu_torch.pp) held to
the JAX package's (muon_tpu.pp) on copies of one AnnData with planted
clusters."""

import copy

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    import muon_tpu as mu
    import pandas as pd
except ImportError:
    jax = jnp = mu = pd = None

import muon_tpu_torch as mt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import linalg as tla

CPU = torch.device("cpu")
N_CLUSTERS = 6


def _rna(seed=0, n=600, d=150, g=N_CLUSTERS):
    """log1p counts of g planted clusters: each boosts its own 20 genes, by
    a different amount, over Poisson noise. Returns (CSR float32, labels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, g, n)
    counts = rng.poisson(0.5, size=(n, d)).astype(np.float64)
    for c in range(g):
        rows = labels == c
        counts[np.ix_(rows, np.arange(c * 20, (c + 1) * 20))] += \
            rng.poisson(1.5 + 0.5 * c, size=(rows.sum(), 20))
    return sp.csr_matrix(np.log1p(counts).astype(np.float32)), labels


@pytest.fixture()
def reference_omega(monkeypatch):
    """Make the port draw the reference's Ω, so both packages start from the
    same test matrix."""

    def jax_omega(d, l, seed, device):
        om = jax.random.normal(jax.random.PRNGKey(seed), (d, l), jnp.float32)
        return torch.tensor(np.asarray(om), device=device)

    monkeypatch.setattr(tla, "draw_omega", jax_omega)


def _col_cos(a, b):
    return np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))


def _purity(adata, labels):
    D = adata.obsp["distances"].tocoo()
    return float((labels[D.row] == labels[D.col]).mean())


def test_pca_matches_jax(reference_omega):
    # same Ω: scores and loadings per-column |cos| >= 1 - 1e-4, variance and
    # ratio rtol 1e-4, the same keys and params
    X, _ = _rna()
    ad_j = mu.AnnData(X)
    ad_t = copy.deepcopy(ad_j)
    mu.pp.pca(ad_j, n_comps=5)
    assert mt.pp.pca(ad_t, n_comps=5, device=CPU) is None
    assert ad_t.obsm["X_pca"].shape == (600, 5) and ad_t.obsm["X_pca"].dtype == np.float32
    assert ad_t.varm["PCs"].shape == (150, 5)
    assert (_col_cos(ad_t.obsm["X_pca"], ad_j.obsm["X_pca"]) >= 1 - 1e-4).all()
    assert (_col_cos(ad_t.varm["PCs"], ad_j.varm["PCs"]) >= 1 - 1e-4).all()
    for key in ("variance", "variance_ratio"):
        np.testing.assert_allclose(ad_t.uns["pca"][key], ad_j.uns["pca"][key], rtol=1e-4)
    assert ad_t.uns["pca"]["params"] == ad_j.uns["pca"]["params"]


def test_pca_highly_variable_mask_matches_jax(reference_omega):
    X, _ = _rna(seed=1)
    hv = np.zeros(150, bool)
    hv[:90] = True
    ad_j = mu.AnnData(X, var=pd.DataFrame({"highly_variable": hv},
                                          index=[f"g{i}" for i in range(150)]))
    ad_t = copy.deepcopy(ad_j)
    mu.pp.pca(ad_j, n_comps=5, use_highly_variable=True)
    mt.pp.pca(ad_t, n_comps=5, use_highly_variable=True, device=CPU)
    assert (ad_t.varm["PCs"][~hv] == 0).all()
    assert (_col_cos(ad_t.varm["PCs"][hv], ad_j.varm["PCs"][hv]) >= 1 - 1e-4).all()
    assert ad_t.uns["pca"]["params"] == ad_j.uns["pca"]["params"]


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
def test_neighbors_on_the_same_rep_match_jax(metric):
    # given the same X_pca: the same neighbour indices, distances rtol 1e-6
    # (an ulp of XLA's sqrt), connectivities rtol 1e-5 (σ at float32
    # resolution; see tests/test_torch_fuzzy.py), the same uns["neighbors"].
    # The scores are put on a grid of 1/4: then every norm and cross term is
    # exact in float32 in both packages, so the kNN tables are identical,
    # ties included (the lower index first). On a continuous rep the
    # expanded form's rounding, |Δd²| <= 1e-5·(|q|² + |c|²), moves near-ties
    # and, through d − ρ over a small σ, the connectivities by up to 2e-3;
    # the invariants test below covers that case
    X, _ = _rna(seed=2)
    ad_j = mu.AnnData(X)
    mu.pp.pca(ad_j, n_comps=8)
    ad_j.obsm["X_pca"] = np.round(ad_j.obsm["X_pca"] * 4).astype(np.float32) / 4
    ad_t = copy.deepcopy(ad_j)
    mu.pp.neighbors(ad_j, n_neighbors=15, use_rep="X_pca", metric=metric)
    out = mt.pp.neighbors(ad_t, n_neighbors=15, use_rep="X_pca", metric=metric,
                          device=CPU)
    assert out is ad_t
    Dj, Dt = ad_j.obsp["distances"], ad_t.obsp["distances"]
    assert sp.issparse(Dt) and Dt.shape == (600, 600)
    np.testing.assert_array_equal(Dt.indptr, Dj.indptr)
    np.testing.assert_array_equal(Dt.indices, Dj.indices)
    np.testing.assert_allclose(Dt.data, Dj.data, rtol=1e-6)
    Cj, Ct = ad_j.obsp["connectivities"], ad_t.obsp["connectivities"]
    np.testing.assert_array_equal(Ct.indptr, Cj.indptr)
    np.testing.assert_array_equal(Ct.indices, Cj.indices)
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=1e-5)
    assert ad_t.uns["neighbors"] == ad_j.uns["neighbors"]


def _mean_jaccard(A, B):
    rows = lambda M: [set(r.indices) for r in M.tocsr()]  # noqa: E731
    return np.mean([len(a & b) / len(a | b) for a, b in zip(rows(A), rows(B))])


def test_slice_from_X_keeps_the_reference_invariants():
    # each package draws its own Ω: compare what does not depend on it
    X, labels = _rna(seed=3)
    ad_j = mu.AnnData(X)
    ad_t = copy.deepcopy(ad_j)
    mu.pp.pca(ad_j, n_comps=N_CLUSTERS - 1)
    mu.pp.neighbors(ad_j, n_neighbors=20, use_rep="X_pca")
    mt.pp.pca(ad_t, n_comps=N_CLUSTERS - 1, device=CPU)
    mt.pp.neighbors(ad_t, n_neighbors=20, use_rep="X_pca", device=CPU)
    # principal angles between the two score subspaces: all |cos| >= 1 - 1e-3
    Qj = np.linalg.qr(ad_j.obsm["X_pca"].astype(np.float64))[0]
    Qt = np.linalg.qr(ad_t.obsm["X_pca"].astype(np.float64))[0]
    assert np.linalg.svd(Qj.T @ Qt, compute_uv=False).min() >= 1 - 1e-3
    # mean Jaccard of the kNN sets >= 0.95; planted-label purity within 0.01
    assert _mean_jaccard(ad_t.obsp["distances"], ad_j.obsp["distances"]) >= 0.95
    pt, pj = _purity(ad_t, labels), _purity(ad_j, labels)
    assert abs(pt - pj) <= 0.01 and pt > 0.9, (pt, pj)
    # each row holds the 19 non-self neighbours; the graph is symmetric
    D, C = ad_t.obsp["distances"], ad_t.obsp["connectivities"]
    assert (np.diff(D.indptr) == 19).all() and D.diagonal().max() == 0
    assert abs(C - C.T).max() <= 1e-7
    assert C.data.min() > 0 and C.data.max() <= 1


def test_neighbors_choose_the_representation_as_jax(reference_omega):
    # without use_rep: X_pca if present, else a 50-component PCA computed
    # now (more than 50 genes), else X; n_pcs cuts PCA columns; key_added
    X, _ = _rna(seed=4)
    ad_j = mu.AnnData(X)
    ad_t = copy.deepcopy(ad_j)
    mu.pp.neighbors(ad_j, n_neighbors=10, n_pcs=6, key_added="nn")
    mt.pp.neighbors(ad_t, n_neighbors=10, n_pcs=6, key_added="nn", device=CPU)
    assert ad_t.obsm["X_pca"].shape == ad_j.obsm["X_pca"].shape == (600, 50)
    assert ad_t.uns["nn"] == ad_j.uns["nn"]
    assert set(ad_t.obsp.keys()) == {"nn_distances", "nn_connectivities"}
    assert _mean_jaccard(ad_t.obsp["nn_distances"], ad_j.obsp["nn_distances"]) >= 0.95

    # 40 genes: X itself. log1p of small counts has many exact ties, which
    # the two summation orders break apart: the kNN sets agree but for them
    small = mu.AnnData(X[:, :40])
    small_t = copy.deepcopy(small)
    mu.pp.neighbors(small, n_neighbors=8)
    mt.pp.neighbors(small_t, n_neighbors=8, device=CPU)
    assert "X_pca" not in small_t.obsm
    assert _mean_jaccard(small_t.obsp["distances"], small.obsp["distances"]) >= 0.97


class Holder:
    """The least AnnData-like object: the port needs no container classes."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


class MuHolder:
    def __init__(self, **mods):
        self.mod = mods


def test_slice_runs_on_a_plain_holder():
    X, labels = _rna(seed=5, n=300)
    h = Holder(X)
    mt.pp.pca(h, n_comps=5, device=CPU)
    mt.pp.neighbors(h, n_neighbors=12, use_rep="X_pca", device=CPU)
    assert h.obsm["X_pca"].shape == (300, 5) and h.varm["PCs"].shape == (150, 5)
    assert h.obsp["distances"].shape == (300, 300)
    assert _purity(h, labels) > 0.9
    dense = Holder(X.toarray())  # the dense PCA branch
    mt.pp.pca(dense, n_comps=5, device=CPU)
    assert (_col_cos(dense.obsm["X_pca"], h.obsm["X_pca"]) > 0.99).all()


def test_unported_branches_raise():
    X, _ = _rna(seed=6, n=100)
    mdata = MuHolder(rna=Holder(X))
    # WNN is ported: without per-modality neighbors it raises the
    # reference's error (tests/test_torch_wnn.py drives it)
    with pytest.raises(ValueError, match="Run neighbors on all modalities first"):
        mt.pp.neighbors(mdata, device=CPU)
    with pytest.raises(TypeError):
        mt.pp.pca(mdata)
    # one modality's mesh= is ported (tests/test_torch_parallel.py): what is
    # not a Mesh raises; WNN under a mesh is the rest of K20
    with pytest.raises(ValueError, match="parallel Mesh"):
        mt.pp.neighbors(Holder(X), mesh=object(), device=CPU)
    with pytest.raises(NotImplementedError, match="the rest of K20"):
        mt.pp.neighbors(mdata, mesh=object(), device=CPU)


def test_large_inputs_take_the_approx_knn(monkeypatch):
    # above 20,000 rows single_neighbors asks for the bfloat16 kNN, as the
    # reference does; checked by lowering the threshold
    from muon_tpu_torch.ops import wnn

    seen = []
    real = wnn.knn
    monkeypatch.setattr(wnn, "knn", lambda *a, **kw: seen.append(kw["approx"]) or real(*a, **kw))
    X, _ = _rna(seed=7, n=120)
    mt.pp.neighbors(Holder(X), n_neighbors=5, use_rep="X", device=CPU)
    monkeypatch.setattr(wnn, "APPROX_ROWS", 100)
    mt.pp.neighbors(Holder(X), n_neighbors=5, use_rep="X", device=CPU)
    assert seen == [False, True]


def _adata(n=30, d=12, seed=0, sparse=False, dtype=np.float32):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(dtype)
    X[4] = 0.0  # a zero norm is taken as 1
    if sparse:
        X = sp.random(n, d, density=0.3, random_state=seed, format="csr", dtype=dtype)
        X = sp.csr_matrix(X.toarray() * (np.arange(n) != 4)[:, None])
    ad = mu.AnnData(X=X, obs=pd.DataFrame(index=[f"c{i}" for i in range(n)]),
                    var=pd.DataFrame(index=[f"g{j}" for j in range(d)]))
    ad.obsm["X_pca"] = rng.normal(size=(n, 6))
    ad.obsm["X_lsi"] = rng.normal(size=(n, 5)).astype(np.float32)
    return ad


def _same(a, b):
    if sp.issparse(a):
        assert sp.issparse(b) and a.format == b.format and a.dtype == b.dtype
        a, b = a.toarray(), b.toarray()
    assert np.asarray(a).dtype == np.asarray(b).dtype and np.shape(a) == np.shape(b)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("case", [
    dict(), dict(sparse=True), dict(dtype=np.float64), dict(rep="pca", n_pcs=3),
    dict(rep="X_pca", n_pcs=0), dict(rep="lsi", n_pcs=2), dict(rep=["pca"], n_pcs=[4]),
])
def test_l2norm_matches_jax(case):
    # the same host code on copies of one AnnData: the same keys, the same
    # values and dtype, bit for bit
    make = {k: v for k, v in case.items() if k in ("sparse", "dtype")}
    kw = {k: v for k, v in case.items() if k in ("rep", "n_pcs")}
    ref, got = _adata(**make), _adata(**make)
    mu.pp.l2norm(ref, **kw)
    assert mt.pp.l2norm(got, **kw) is None
    _same(got.X, ref.X)
    for key in ("X_pca", "X_lsi"):
        _same(got.obsm[key], ref.obsm[key])


def test_l2norm_mudata_matches_jax():
    def mdata():
        return mu.MuData({"rna": _adata(seed=1), "atac": _adata(seed=2, sparse=True)})

    ref, got = mdata(), mdata()
    mu.pp.l2norm(ref)
    mt.pp.l2norm(got)
    for m in ("rna", "atac"):
        _same(got.mod[m].X, ref.mod[m].X)
    # per-modality reps and n_pcs, on a subset of the modalities
    ref, got = mdata(), mdata()
    kw = dict(mod=["rna", "atac"], rep=["pca", None], n_pcs=[2, 0])
    mu.pp.l2norm(ref, **kw)
    mt.pp.l2norm(got, **kw)
    _same(got.mod["rna"].obsm["X_pca"], ref.mod["rna"].obsm["X_pca"])
    _same(got.mod["atac"].X, ref.mod["atac"].X)
    # copy=True leaves the input as it was
    orig = mdata()
    out = mt.pp.l2norm(orig, mod="rna", copy=True)
    _same(orig.mod["rna"].X, mdata().mod["rna"].X)
    ref = mdata()
    mu.pp.l2norm(ref, mod="rna")
    _same(out.mod["rna"].X, ref.mod["rna"].X)


def test_l2norm_on_plain_holders():
    X = np.random.default_rng(3).normal(size=(20, 7)).astype(np.float32)
    h = Holder(X.copy())
    h.obsm["X_pca"] = X[:, :5].copy()
    mt.pp.l2norm(MuHolder(rna=h), rep="X_pca", n_pcs=3)
    np.testing.assert_allclose(np.linalg.norm(h.obsm["X_pca"], axis=1), 1.0, rtol=1e-6)
    assert h.obsm["X_pca"].shape == (20, 3)
    with pytest.raises(KeyError, match="umap"):
        mt.pp.l2norm(h, rep="umap")


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
    # the same rep on both devices: kNN sets agree but for near-ties (mean
    # Jaccard >= 0.99); where both hold an edge the connectivities agree to
    # atol 1e-3 (values in (0, 1]): T5 sums the cross term in another order
    # than the CPU's matmul, and exp(−(d − ρ)/σ) amplifies that rounding
    # where σ is small (2.3e-3 relative, 9.8e-5 absolute on the card);
    # the kernels ran
    X, labels = _rna(seed=8, n=3000)
    h_c, h_g = Holder(X), Holder(X)
    mt.pp.pca(h_c, n_comps=10, device=CPU)
    h_g.obsm["X_pca"] = h_c.obsm["X_pca"].copy()
    _kernels.reset_launch_counts()
    mt.pp.neighbors(h_g, n_neighbors=20, use_rep="X_pca", device=cuda)
    counts = _kernels.launch_counts()
    assert counts["knn_topk"] == 1 and counts["smooth_knn_membership"] == 1
    mt.pp.neighbors(h_c, n_neighbors=20, use_rep="X_pca", device=CPU)
    assert _mean_jaccard(h_g.obsp["distances"], h_c.obsp["distances"]) >= 0.99
    Cg, Cc = h_g.obsp["connectivities"], h_c.obsp["connectivities"]
    both = Cg.multiply(Cc.astype(bool)).tocsr()
    ref = Cc.multiply(Cg.astype(bool)).tocsr()
    np.testing.assert_allclose(both.data, ref.data, rtol=0, atol=1e-3)
    assert abs(_purity(h_g, labels) - _purity(h_c, labels)) <= 0.01
