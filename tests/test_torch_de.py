"""The port's marker ranking (muon_tpu_torch.tl.rank_genes_groups,
atac.tl.rank_peaks_groups; T3, T26-T28 through their plain versions on the
CPU) held to the JAX package's (muon_tpu) on the same data, and T26-T28
against their plain versions on the card.

Tolerances: the t-test's moments are float32 sums in another order than
XLA's, so scores and p-values agree to rtol 1e-5. The wilcoxon rank sums
and tie terms are exact (held to scipy's ``rankdata`` without tolerance),
and z to rtol 1e-6 (the port forms the tie correction in float64 from its
exact tie term, the reference in float32; equal at this size, so only the
rounding of the final operations differs), p-values to rtol 1e-5. Logreg:
the two fits take the same float32 steps with the products summed in
another order; Adam's first
step is ±lr·sign(g), so a coefficient whose first gradient lies within
rounding of 0 could step either way, and its gene is left out of the
step-by-step comparison (rtol 1e-5). None does at these data.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from scipy.stats import rankdata

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import pandas as pd

    import muon_tpu as mu
    from muon_tpu._core import tools_de as jde
except ImportError:
    pd = mu = jde = None

import muon_tpu_torch as mt
from muon_tpu_torch._core import tools_de as tde
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import de
from muon_tpu_torch.ops import sparse as dsp
from muon_tpu_torch.utils import profiling

FIELDS = ("names", "scores", "pvals", "pvals_adj", "logfoldchanges")


def _planted(seed=0, n=120, d=25):
    """The reference's DE fixture: three groups, g0 planted in a, g1 in b."""
    rng = np.random.default_rng(seed)
    X = rng.normal(1.0, 1.0, size=(n, d)).astype(np.float32)
    labels = rng.choice(["a", "b", "c"], size=n)
    X[labels == "a", 0] += 3.0
    X[labels == "b", 1] += 2.0
    return X, labels


def _ties(seed=1, n=80):
    """The reference's test_ties_handled data: integer values, heavy ties."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, 3, size=(n, 5)).astype(np.float32)
    labels = np.array(["x"] * 40 + ["y"] * 40)
    X[labels == "x", 0] += 2
    return X, labels


def _pair(X, labels, key="cluster"):
    """Two AnnData objects of the reference's class on the same data."""
    n, d = X.shape
    obs = pd.DataFrame({key: labels}, index=[f"c{i}" for i in range(n)])
    var = pd.DataFrame(index=[f"g{i}" for i in range(d)])
    make = lambda: mu.AnnData(X=X.copy(), obs=obs.copy(), var=var.copy())  # noqa: E731
    return make(), make()


def _by_name(res, field, group):
    return dict(zip(res["names"][group], res[field][group]))


def _assert_same(ref, got, fields, rtol, groups=None):
    for group in groups or ref["names"].dtype.names:
        for field in fields:
            r, g = _by_name(ref, field, group), _by_name(got, field, group)
            assert r.keys() == g.keys()
            names = sorted(r)
            np.testing.assert_allclose(np.array([g[k] for k in names], dtype=np.float64),
                                       np.array([r[k] for k in names], dtype=np.float64),
                                       rtol=rtol, atol=0, err_msg=f"{field} of {group}")


@pytest.fixture()
def reference():
    if mu is None:
        pytest.skip("needs the JAX package and its container libraries")


# ---------------------------------------------------------------------------
# t-test
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["t-test", "t-test_overestim_var"])
@pytest.mark.parametrize("sparse", [False, True])
def test_ttest_matches_reference(reference, method, sparse):
    X, labels = _planted()
    if sparse:
        X = np.clip(X, 0, None)
    a_ref, a_got = _pair(sp.csr_matrix(X) if sparse else X, labels)
    mu.tl.rank_genes_groups(a_ref, "cluster", method=method)
    mt.tl.rank_genes_groups(a_got, "cluster", method=method, device="cpu")
    ref, got = a_ref.uns["rank_genes_groups"], a_got.uns["rank_genes_groups"]
    assert list(got["names"]["a"][:1]) == ["g0"] and list(got["names"]["b"][:1]) == ["g1"]
    _assert_same(ref, got, ("scores", "pvals", "pvals_adj", "logfoldchanges"), rtol=1e-5)


def test_ttest_named_reference(reference):
    X, labels = _planted()
    a_ref, a_got = _pair(X, labels)
    kw = dict(groups=["a"], reference="b")
    mu.tl.rank_genes_groups(a_ref, "cluster", **kw)
    mt.tl.rank_genes_groups(a_got, "cluster", device="cpu", **kw)
    ref, got = a_ref.uns["rank_genes_groups"], a_got.uns["rank_genes_groups"]
    assert got["names"].dtype.names == ("a",)
    assert got["params"] == ref["params"]
    _assert_same(ref, got, ("scores", "pvals", "logfoldchanges"), rtol=1e-5)


def test_uns_fields_and_dtypes_match_reference(reference):
    X, labels = _planted()
    for method in ("t-test", "wilcoxon", "logreg"):
        a_ref, a_got = _pair(X, labels)
        kw = dict(method=method, n_genes=7, key_added="de", max_iter=3)
        mu.tl.rank_genes_groups(a_ref, "cluster", **kw)
        mt.tl.rank_genes_groups(a_got, "cluster", device="cpu", **kw)
        ref, got = a_ref.uns["de"], a_got.uns["de"]
        assert sorted(got) == sorted(ref) and got["params"] == ref["params"]
        for field in FIELDS:
            assert type(got[field]) is type(ref[field]), field
            assert got[field].dtype == ref[field].dtype, (method, field)
            assert got[field].shape == ref[field].shape == (7,)
        for group in ("a", "b", "c"):
            assert list(got["names"][group]) == list(ref["names"][group])


def test_categories_follow_pandas(reference):
    # a categorical column keeps its own order; other labels sort, as
    # pd.Categorical sorts them; a missing label is no group
    X, labels = _planted()
    a_ref, a_got = _pair(X, labels)
    cat = pd.Categorical(labels, categories=["c", "a", "b"])
    a_ref.obs["cluster"], a_got.obs["cluster"] = cat, cat
    mu.tl.rank_genes_groups(a_ref, "cluster")
    mt.tl.rank_genes_groups(a_got, "cluster", device="cpu")
    assert a_got.uns["rank_genes_groups"]["names"].dtype.names == ("c", "a", "b")
    _assert_same(a_ref.uns["rank_genes_groups"], a_got.uns["rank_genes_groups"],
                 ("scores",), rtol=1e-5)
    names, codes = tde._categories(np.array(["b", None, "a", "b"], dtype=object))
    assert names == ["a", "b"] and list(codes) == [1, -1, 0, 1]


def test_bh_adjustment_equals_reference(reference):
    rng = np.random.default_rng(3)
    p = rng.uniform(size=(4, 200)) ** 3
    p[:, :5] = p[:, 5:10]  # ties
    np.testing.assert_array_equal(tde._bh_adjust(p), jde._bh_adjust(p))


# ---------------------------------------------------------------------------
# wilcoxon
# ---------------------------------------------------------------------------


def _exact_rank_sums(X, codes, g):
    """Rank sums by scipy's tie-averaged ranks, and Σ(t³ − t) per column."""
    ranks = np.apply_along_axis(rankdata, 0, X)
    out = np.zeros((g, X.shape[1]))
    for c in range(g):
        out[c] = ranks[codes == c].sum(axis=0)
    tie = np.array([sum(t**3 - t for t in np.unique(col, return_counts=True)[1])
                    for col in X.T], dtype=np.int64)
    return out, tie


@pytest.mark.parametrize("data", ["planted", "ties"])
def test_wilcoxon_rank_sums_exact(data, monkeypatch):
    # column blocks of 2 (the block size follows RANK_BLOCK_BYTES)
    X, labels = _planted() if data == "planted" else _ties()
    monkeypatch.setattr(de, "RANK_BLOCK_BYTES", 16 * X.shape[0] * 2)
    cats, codes = np.unique(labels, return_inverse=True)
    codes = codes.astype(np.int32)
    codes[::7] = -1  # cells without a group still take part in the ranks
    rs, tie = de.wilcoxon_rank_sums(torch.from_numpy(X), torch.from_numpy(codes), len(cats))
    want_rs, want_tie = _exact_rank_sums(X, codes, len(cats))
    assert rs.dtype == torch.float64 and tie.dtype == torch.int64
    np.testing.assert_array_equal(rs.numpy(), want_rs)
    np.testing.assert_array_equal(tie.numpy(), want_tie)


RANK_EDGES = ["runs31", "runs32", "runs33", "runs4097", "zeros", "nan", "max_groups", "n1",
              "n2"]


def _rank_edge(case):
    """T26's edge cases (X (n, D) float32, codes (n,) int32, g): tie runs
    of 31-33 and 4097 cells across the kernel's 2048-cell tiles, a column of
    mostly ±0, NaNs, g = MAX_GROUPS, one and two cells."""
    rng = np.random.default_rng(len(case))
    n, g = {"runs4097": (13000, 5), "zeros": (10000, 20), "max_groups": (12000, de.MAX_GROUPS),
            "n1": (1, 2), "n2": (2, 3)}.get(case, (6500, 7))
    i = np.arange(n)
    if case.startswith("runs"):
        L = int(case[4:])
        X = np.stack([i // L, (i + 7) // L, (i + L // 2) // L, rng.integers(0, 4, n)], axis=1)
        X = rng.permutation(X.astype(np.float32))  # the sort puts the runs back
    elif case == "zeros":
        X = np.where(rng.random((n, 4)) < 0.95, 0.0, rng.integers(1, 5, (n, 4)))
        X = (X * np.where(rng.random((n, 4)) < 0.5, -1.0, 1.0)).astype(np.float32)
        X[:, 3] = -0.0
    elif case == "nan":
        X = rng.integers(0, 4, (n, 3)).astype(np.float32)
        X[rng.random((n, 3)) < 0.1] = np.nan
        X[:, 2] = np.nan
    elif case == "n2":
        X = np.array([[1.0, 2.0, -0.0], [1.0, 3.0, 0.0]], np.float32)
    else:
        X = rng.integers(0, 6, (n, 3)).astype(np.float32)
    codes = rng.integers(0, g, n).astype(np.int32)
    codes[rng.random(n) < 0.1] = -1
    return X, codes, g


@pytest.mark.parametrize("case", RANK_EDGES)
def test_wilcoxon_rank_sums_edges_exact(case):
    # the dense route's plain version held to scipy's rankdata, and to the
    # route over Xᵀ's CSR (NaNs: each a run of its own, after every number)
    X, codes, g = _rank_edge(case)
    rs, tie = de.wilcoxon_rank_sums(torch.from_numpy(X), torch.from_numpy(codes), g)
    rows, cols = np.nonzero((X != 0) | np.isnan(X))
    Xs = sp.csr_matrix((X[rows, cols], (rows, cols)), shape=X.shape)
    Xt = dsp.transpose(dsp.from_scipy(Xs, "cpu"))
    rs_c, tie_c = de.wilcoxon_rank_sums_csc(Xt, torch.from_numpy(codes), g)
    assert torch.equal(rs, rs_c) and torch.equal(tie, tie_c)
    if case != "nan":
        want_rs, want_tie = _exact_rank_sums(X, codes, g)
        np.testing.assert_array_equal(rs.numpy(), want_rs)
        np.testing.assert_array_equal(tie.numpy(), want_tie)


@pytest.mark.parametrize("data", ["planted", "ties"])
@pytest.mark.parametrize("sparse", [False, True])
def test_wilcoxon_matches_reference(reference, data, sparse, monkeypatch):
    X, labels = _planted() if data == "planted" else _ties()
    if sparse:
        X = np.clip(X, 0, None)
    a_ref, a_got = _pair(sp.csr_matrix(X) if sparse else X, labels)
    mu.tl.rank_genes_groups(a_ref, "cluster", method="wilcoxon")
    routes = []
    for name in ("wilcoxon_rank_sums", "wilcoxon_rank_sums_csc"):
        fn = getattr(de, name)
        monkeypatch.setattr(de, name, lambda *a, _fn=fn, _name=name: routes.append(_name)
                            or _fn(*a))
    with profiling.collect() as t:
        mt.tl.rank_genes_groups(a_got, "cluster", method="wilcoxon", device="cpu")
    # a sparse X goes through the CSR of its transpose, never densified
    assert routes == ["wilcoxon_rank_sums_csc" if sparse else "wilcoxon_rank_sums"]
    assert "de/densify" not in t
    assert ("sparse/transpose" in t) == sparse
    ref, got = a_ref.uns["rank_genes_groups"], a_got.uns["rank_genes_groups"]
    _assert_same(ref, got, ("scores",), rtol=1e-6)
    # a p-value's relative error is about |z| times z's (2e-6 at z = 8.8)
    _assert_same(ref, got, ("pvals", "pvals_adj", "logfoldchanges"), rtol=1e-5)


# the CSR of Xᵀ route: each case a feature of the data it must rank as the
# dense route does, "all" every one at once
CSC_CASES = ("ties", "negatives", "stored_zeros", "nan", "empty_and_full", "no_group",
             "empty_group", "all")


def _csc_case(case, n=300, D=9, seed=0):
    """A sparse X (float32 CSR, explicit entries kept, zeros included), the
    cells' codes and the group count: integer values tie among the nonzeros."""
    rng = np.random.default_rng(seed)
    every = case == "all"
    mask = rng.uniform(size=(n, D)) < 0.3
    X = rng.integers(1, 4, size=(n, D)).astype(np.float32)
    if case == "negatives" or every:
        X[:, ::2] = rng.integers(-3, 4, size=(n, (D + 1) // 2))  # a stored 0 among them
        X[:, 1] = rng.normal(size=n)
    if case == "nan" or every:
        rows = rng.choice(n, 7, replace=False)
        X[rows[:5], 2] = np.nan
        X[rows[5], 2], X[rows[6], 2] = np.inf, -np.inf
        mask[rows, 2] = True
    if case == "stored_zeros" or every:
        z = rng.uniform(size=(n, D)) < 0.05
        X[z] = np.where(rng.uniform(size=z.sum()) < 0.5, 0.0, -0.0)
        mask |= z
    if case == "empty_and_full" or every:
        mask[:, 0], mask[:, D - 1] = False, True
    rows, cols = np.nonzero(mask)
    Xs = sp.csr_matrix((X[rows, cols], (rows, cols)), shape=(n, D))
    g = 3
    codes = rng.integers(0, g, n).astype(np.int32)
    if case == "no_group" or every:
        codes[::5] = -1  # cells without a group still take part in the ranks
    if case == "empty_group" or every:
        codes[codes == 1] = 2
        g = 5  # groups 1, 3 and 4 have no cell
    return Xs, codes, g


@pytest.mark.parametrize("case", CSC_CASES)
def test_wilcoxon_csc_matches_dense_route(case):
    # T26 from the CSR of Xᵀ (its plain version on the CPU) gives the dense
    # route's rank sums and tie terms bit for bit
    Xs, codes, g = _csc_case(case)
    if case == "stored_zeros":
        assert (Xs.data == 0).sum() > 0 and np.signbit(Xs.data[Xs.data == 0]).any()
    codes_t = torch.from_numpy(codes)
    Xt = dsp.transpose(dsp.from_scipy(Xs, "cpu"))
    rs, tie = de.wilcoxon_rank_sums_csc(Xt, codes_t, g)
    want_rs, want_tie = de.wilcoxon_rank_sums_plain(torch.from_numpy(Xs.toarray()), codes_t, g)
    assert rs.dtype == torch.float64 and tie.dtype == torch.int64
    assert rs.shape == (g, Xs.shape[1]) and tie.shape == (Xs.shape[1],)
    assert torch.equal(rs, want_rs) and torch.equal(tie, want_tie)
    if not np.isnan(Xs.data).any():  # and scipy's tie-averaged ranks
        want_rs, want_tie = _exact_rank_sums(Xs.toarray(), codes, g)
        np.testing.assert_array_equal(rs.numpy(), want_rs)
        np.testing.assert_array_equal(tie.numpy(), want_tie)


# ---------------------------------------------------------------------------
# logreg
# ---------------------------------------------------------------------------


def _first_gradient_near_zero(X, labels):
    """Genes with a class whose first gradient Xᵀ(softmax(0) − onehot) lies
    within rounding (1e-4 of Σ|x|) of 0."""
    cats, codes = np.unique(labels, return_inverse=True)
    G = np.eye(len(cats))[codes]
    g1 = X.astype(np.float64).T @ (1.0 / len(cats) - G)
    return (np.abs(g1) <= 1e-4 * np.abs(X).sum(axis=0)[:, None]).any(axis=1)


@pytest.mark.parametrize("max_iter", [1, 2, 5])
@pytest.mark.parametrize("sparse", [False, True])
def test_logreg_steps_match_reference(reference, max_iter, sparse):
    X, labels = _planted()
    if sparse:
        X = np.clip(X, 0, None)
    skip = _first_gradient_near_zero(X, labels)
    assert not skip.any()  # the data leave no gene out
    a_ref, a_got = _pair(sp.csr_matrix(X) if sparse else X, labels)
    mu.tl.rank_genes_groups(a_ref, "cluster", method="logreg", max_iter=max_iter)
    mt.tl.rank_genes_groups(a_got, "cluster", method="logreg", max_iter=max_iter,
                            device="cpu")
    ref, got = a_ref.uns["rank_genes_groups"], a_got.uns["rank_genes_groups"]
    _assert_same(ref, got, ("scores",), rtol=1e-5)
    assert np.isnan(got["pvals"]["a"]).all() and np.isnan(got["pvals_adj"]["a"]).all()


def test_logreg_fit_matches_reference(reference):
    # 200 steps: the amplified rounding leaves the ranking and the
    # coefficients, not every bit
    X, labels = _planted()
    a_ref, a_got = _pair(X, labels)
    mu.tl.rank_genes_groups(a_ref, "cluster", method="logreg")
    mt.tl.rank_genes_groups(a_got, "cluster", method="logreg", device="cpu")
    ref, got = a_ref.uns["rank_genes_groups"], a_got.uns["rank_genes_groups"]
    for group in ("a", "b", "c"):
        assert len(set(ref["names"][group][:10]) & set(got["names"][group][:10])) >= 9
        r, g = _by_name(ref, "scores", group), _by_name(got, "scores", group)
        names = sorted(r)
        corr = np.corrcoef([r[k] for k in names], [g[k] for k in names])[0, 1]
        assert corr >= 0.9999, (group, corr)
    assert got["names"]["a"][0] == "g0" and got["names"]["b"][0] == "g1"


def test_logreg_step_plain_matches_autograd():
    # T27's and T28's plain versions against torch's own gradient of the
    # reference's loss and a hand-written Adam step, in float64
    rng = np.random.default_rng(5)
    n, D, g = 50, 7, 4
    X = torch.from_numpy(rng.normal(size=(n, D)))
    y = torch.from_numpy(rng.integers(0, g, n).astype(np.int32))
    wv = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(np.float64))
    W = torch.from_numpy(rng.normal(size=(D, g))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=g)).requires_grad_()
    ce = torch.nn.functional.cross_entropy(X @ W + b, y.long(), reduction="none")
    (ce * wv).sum().backward()
    dZ, db = de.logreg_softmax_grad_plain(X @ W.detach(), b.detach(), y, wv)
    np.testing.assert_allclose((X.T @ dZ).numpy(), W.grad.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(db.numpy(), b.grad.numpy(), rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# marker peaks
# ---------------------------------------------------------------------------


def test_rank_peaks_groups_matches_reference(reference):
    from muon_tpu import atac as ac

    rng = np.random.default_rng(2)
    n = 60
    peaks = [f"chr1:{i*1000}-{i*1000+500}" for i in range(6)]
    X = rng.poisson(2.0, size=(n, 6)).astype(np.float32)
    labels = np.array(["p", "q"] * 30)
    X[labels == "p", 2] += 5
    pa = pd.DataFrame({
        "peak": [p.replace(":", "_").replace("-", "_") for p in peaks],
        "gene": [f"GENE{i}" for i in range(6)],
        "distance": list(range(6)),
        "peak_type": ["promoter", "distal"] * 3,
    })
    out = []
    for rank in (ac.tl.rank_peaks_groups, mt.atac.tl.rank_peaks_groups):
        adata = mu.AnnData(
            X=X.copy(), obs=pd.DataFrame({"cl": labels}, index=[f"c{i}" for i in range(n)]),
            var=pd.DataFrame(index=peaks))
        ours = rank is mt.atac.tl.rank_peaks_groups
        (mt.atac.tl if ours else ac.tl).add_peak_annotation(adata, pa)
        kw = {"device": "cpu"} if ours else {}
        rank(adata, "cl", add_peak_type=True, add_distance=True, **kw)
        out.append(adata.uns["rank_genes_groups"])
    ref, got = out
    assert got["names"]["p"][0] == peaks[2] and got["genes"]["p"][0] == "GENE2"
    for field in ("genes", "peak_type", "distance"):
        assert set(got) >= {field}
    assert got["genes"].dtype == ref["genes"].dtype
    for group in ("p", "q"):
        assert list(got["names"][group]) == list(ref["names"][group])
        assert list(got["genes"][group]) == list(ref["genes"][group])
        assert list(got["peak_type"][group]) == list(ref["peak_type"][group])
        assert list(got["distance"][group]) == list(ref["distance"][group])


# ---------------------------------------------------------------------------
# on the card: T26-T28 against their plain versions (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n, D, g, block", [(1000, 37, 3, 0), (997, 64, 1, 10),
                                            (5000, 20, 20, 7), (33, 5, 2, 0)])
def test_gpu_wilcoxon_rank_sums_match_plain(cuda, n, D, g, block, monkeypatch):
    # integer levels make ties; one column all equal, one all distinct;
    # n off a multiple of 32; blocks of columns; a tenth of the cells no group
    rng = np.random.default_rng(n + D)
    X = rng.integers(0, 5, size=(n, D)).astype(np.float32)
    X[:, 0] = 2.0
    X[:, 1] = rng.permutation(n)
    codes = rng.integers(0, g, n).astype(np.int32)
    codes[rng.uniform(size=n) < 0.1] = -1
    Xc, cc = torch.from_numpy(X).to(cuda), torch.from_numpy(codes).to(cuda)
    if block:
        monkeypatch.setattr(de, "RANK_BLOCK_BYTES", 16 * n * block)
    _kernels.reset_launch_counts()
    rs, tie = de.wilcoxon_rank_sums(Xc, cc, g)
    torch.cuda.synchronize()
    want = -(-D // block) if block else 1
    assert _kernels.launch_counts()["wilcoxon_rank_sums"] == want
    rs_p, tie_p = de.wilcoxon_rank_sums_plain(Xc, cc, g)
    assert torch.equal(rs, rs_p) and torch.equal(tie, tie_p)
    # the CPU run of the same blocks (the plain version of each) agrees too
    rs_c, tie_c = de.wilcoxon_rank_sums(Xc.cpu(), cc.cpu(), g)
    assert torch.equal(rs.cpu(), rs_c) and torch.equal(tie.cpu(), tie_c)
    assert tie[0].item() == n**3 - n and tie[1].item() == 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", RANK_EDGES)
def test_gpu_wilcoxon_rank_sums_edges_match_plain(cuda, case):
    # tie runs across the 2048-cell tiles (a run of 4097 spans three), a
    # column of mostly ±0 (one run settled once), NaNs, g = MAX_GROUPS, n = 1
    # and 2; a block of one column too (n odd: the unaligned loads)
    X, codes, g = _rank_edge(case)
    Xc, cc = torch.from_numpy(X).to(cuda), torch.from_numpy(codes).to(cuda)
    for cols in (slice(None), slice(1, 2)):
        vals, perm = torch.sort(Xc[:, cols].T, dim=1, stable=True)
        vals, perm = vals.contiguous(), perm.contiguous()
        _kernels.reset_launch_counts()
        rs, tie = de.sorted_rank_sums(vals, perm, cc, g)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()["wilcoxon_rank_sums"] == 1
        rs_p, tie_p = de.sorted_rank_sums_plain(vals, perm, cc, g)
        assert torch.equal(rs, rs_p) and torch.equal(tie, tie_p)
    odd = Xc[: max(1, X.shape[0] - 1)]  # n off a multiple of 4
    vals, perm = torch.sort(odd.T, dim=1, stable=True)
    rs, tie = de.sorted_rank_sums(vals.contiguous(), perm.contiguous(), cc[:odd.shape[0]], g)
    rs_p, tie_p = de.sorted_rank_sums_plain(vals, perm, cc[:odd.shape[0]], g)
    assert torch.equal(rs, rs_p) and torch.equal(tie, tie_p)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["short", "long", "full", "mixed", "edges"])
def test_gpu_wilcoxon_csc_matches_plain(cuda, case):
    # short columns in shared memory; columns past its capacity (about 7,000
    # entries at 20 groups) through the scratch; columns of every cell; one
    # launch over lengths from 0 to n, longest first; the CPU cases' edges
    rng = np.random.default_rng(len(case))
    if case == "edges":
        Xs, codes, g = _csc_case("all", n=3000, D=12, seed=3)
    else:
        n, dens = {"short": (2000, np.full(40, 0.1)), "long": (40000, np.array([0.4, 0.9, 1e-4])),
                   "full": (12000, np.ones(3)), "mixed": (20000, np.geomspace(1e-4, 1.0, 30))}[case]
        mask = rng.uniform(size=(n, len(dens))) < dens
        vals = rng.integers(1, 9, size=mask.sum()).astype(np.float32) / 4  # ties
        rows, cols = np.nonzero(mask)
        Xs = sp.csr_matrix((vals, (rows, cols)), shape=(n, len(dens)))
        g = 20
        codes = rng.integers(0, g, n).astype(np.int32)
        codes[rng.uniform(size=n) < 0.1] = -1
    cc = torch.from_numpy(codes).to(cuda)
    Xt = dsp.transpose(dsp.from_scipy(Xs, cuda))
    _kernels.reset_launch_counts()
    rs, tie = de.wilcoxon_rank_sums_csc(Xt, cc, g)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["wilcoxon_rank_sums_csc"] == 1
    rs_p, tie_p = de.wilcoxon_rank_sums_csc_plain(Xt, cc, g)
    assert torch.equal(rs, rs_p) and torch.equal(tie, tie_p)
    rs_d, tie_d = de.wilcoxon_rank_sums(torch.from_numpy(Xs.toarray()).to(cuda), cc, g)
    assert torch.equal(rs, rs_d) and torch.equal(tie, tie_d)
    assert torch.equal(rs, de.wilcoxon_rank_sums_csc(Xt, cc, g)[0])  # repeats


@pytest.mark.gpu
@pytest.mark.parametrize("n, g", [(1000, 3), (999, 1), (4097, 20), (50, 40)])
def test_gpu_logreg_softmax_grad_matches_plain(cuda, n, g):
    # the same float32 operations; the bias sums in a fixed tree (rtol 1e-5
    # of the column's absolute sum) and repeat bit for bit
    rng = np.random.default_rng(n)
    Z = torch.from_numpy(rng.normal(0, 3, (n, g)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.normal(size=g).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).to(cuda)
    wv = torch.from_numpy((rng.uniform(size=n) > 0.1).astype(np.float32)).to(cuda)
    dZ, db = de.logreg_softmax_grad(Z, b, y, wv)
    dZ_p, db_p = de.logreg_softmax_grad_plain(Z, b, y, wv)
    torch.testing.assert_close(dZ, dZ_p, rtol=1e-5, atol=1e-6)
    scale = dZ_p.abs().sum(0)
    assert ((db - db_p).abs() <= 1e-5 * scale + 1e-6).all()
    assert torch.equal(db, de.logreg_softmax_grad(Z, b, y, wv)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("D, g, step", [(2000, 20, 1), (77, 1, 3), (5, 7, 200)])
def test_gpu_adam_update_matches_plain(cuda, D, g, step):
    rng = np.random.default_rng(D)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)  # noqa: E731
    W, gW, mW, b, gb, mb = t(D, g), t(D, g), t(D, g), t(g), t(g), t(g)
    vW, vb = t(D, g).abs(), t(g).abs()
    got = [x.clone() for x in (W, mW, vW, b, mb, vb)]
    want = [x.clone() for x in (W, mW, vW, b, mb, vb)]
    de.adam_update(got[0], gW, got[1], got[2], got[3], gb, got[4], got[5], step, C=0.5)
    de.adam_update_plain(want[0], gW, want[1], want[2], want[3], gb, want[4], want[5], step,
                         C=0.5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-7)


@pytest.mark.gpu
def test_gpu_rank_genes_groups_matches_cpu(cuda):
    # the whole tool on the card against the CPU run: every method
    rng = np.random.default_rng(4)
    X = sp.random(400, 60, density=0.3, random_state=4, format="csr", dtype=np.float32)
    labels = rng.choice(["a", "b", "c", "d"], size=400)

    class H:
        def __init__(self):
            self.X, self.var_names = X, np.array([f"g{i}" for i in range(60)])
            self.obs, self.uns, self.layers = {"cl": labels}, {}, {}

    for method in ("t-test", "wilcoxon", "logreg"):
        hc, hg = H(), H()
        mt.tl.rank_genes_groups(hc, "cl", method=method, device="cpu", max_iter=5)
        mt.tl.rank_genes_groups(hg, "cl", method=method, device=cuda, max_iter=5)
        rc, rg = hc.uns["rank_genes_groups"], hg.uns["rank_genes_groups"]
        for group in ("a", "b", "c", "d"):
            sc, sg = _by_name(rc, "scores", group), _by_name(rg, "scores", group)
            names = sorted(sc)
            np.testing.assert_allclose([sg[k] for k in names], [sc[k] for k in names],
                                       rtol=1e-4, atol=1e-5)
