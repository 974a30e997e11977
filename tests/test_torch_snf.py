"""The port's similarity network fusion (muon_tpu_torch.tl.snf and
ops/snf.py; T29-T31 through their plain versions on the CPU) held to the
JAX package's (muon_tpu.tl.snf, ``_affinity_matrix``, ``_snf_diffusion_fn``)
on the same arrays, and T29-T31 against their plain versions on the card.

Tolerances: the affinity is float32 elementwise arithmetic in the
reference's order after one sum of k values (rtol 1e-5); a diffusion
iteration adds two dense float32 products summed in another order than
XLA's, rtol 1e-5 after one iteration and 1e-4 after five or twenty, where
the rounding has been carried through the products.
"""

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax.numpy as jnp

    import muon_tpu as mu
    from muon_tpu._core import tools_graph as jtg
except ImportError:
    jnp = mu = jtg = None

import muon_tpu_torch as mt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import snf as ts

EPS = float(np.finfo(np.float64).eps)


def clustered_data(n_per=40, n_clusters=3, d=12, seed=0, noise=0.3):
    """tests/test_neighbors.py's recipe."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4
    X = np.concatenate(
        [centers[i] + noise * rng.normal(size=(n_per, d)) for i in range(n_clusters)]
    ).astype(np.float32)
    return X, np.repeat(np.arange(n_clusters), n_per)


def ari(a, b):
    """Adjusted Rand index (tests/test_tools_graph.py's)."""
    n = len(a)
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    C = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(C, (ia, ib), 1)
    comb = lambda x: x * (x - 1) / 2  # noqa: E731
    sum_a, sum_b = comb(C.sum(1)).sum(), comb(C.sum(0)).sum()
    exp = sum_a * sum_b / comb(n)
    return (comb(C).sum() - exp) / ((sum_a + sum_b) / 2 - exp)


@pytest.fixture()
def mdata_clusters():
    """The reference's fixture (tests/test_tools_graph.py): two modalities of
    160 cells in 4 clusters, each with its neighbors(12) by the reference."""
    if mu is None:
        pytest.skip("needs the JAX package and its container libraries")
    X1, labels = clustered_data(n_per=40, n_clusters=4, d=12, seed=0)
    X2, _ = clustered_data(n_per=40, n_clusters=4, d=9, seed=1)
    m1, m2 = mu.AnnData(X1), mu.AnnData(X2)
    md = mu.MuData({"m1": m1, "m2": m2})
    mu.pp.neighbors(m1, n_neighbors=12)
    mu.pp.neighbors(m2, n_neighbors=12)
    return md, labels


def _dense(dmat):
    dist = np.asarray(dmat.todense(), dtype=np.float32)
    return dist, np.asarray((dmat != 0).todense()).astype(bool)


def _affinities(md, k):
    """Each modality's affinity by the reference, as numpy."""
    out = []
    for mod in md.mod.values():
        dist, known = _dense(mod.obsp["distances"])
        out.append(np.asarray(jtg._affinity_matrix(
            (jnp.asarray(dist), jnp.asarray(known)), k, 0.5, EPS)))
    return out


@pytest.mark.parametrize("k", [15, 5])
def test_affinity_matches_reference(mdata_clusters, k):
    md, _ = mdata_clusters
    for mod, ref in zip(md.mod.values(), _affinities(md, k)):
        dist, known = _dense(mod.obsp["distances"])
        got = ts.affinity_matrix(torch.from_numpy(dist), torch.from_numpy(known), k, 0.5, EPS)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)


def test_affinity_of_a_dense_matrix_and_of_an_isolated_row():
    # every pair known (a dense distance matrix), and a row with no known
    # neighbour: its mean is eps alone and its affinities 0 off the diagonal
    rng = np.random.default_rng(0)
    P = rng.normal(size=(30, 3)).astype(np.float32)
    dist = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1)).astype(np.float32)
    full = ts.affinity_matrix(torch.from_numpy(dist), torch.ones((30, 30), dtype=torch.bool),
                              5, 0.5, EPS)
    assert torch.isfinite(full).all() and (full.diagonal() == 0).all()
    known = np.ones((30, 30), dtype=bool)
    known[0], known[:, 0] = False, False
    iso = ts.affinity_matrix(torch.from_numpy(dist), torch.from_numpy(known), 5, 0.5, EPS)
    assert (iso[0] == 0).all() and (iso[:, 0] == 0).all()
    if jtg is not None:
        ref = np.asarray(jtg._affinity_matrix((jnp.asarray(dist), jnp.asarray(known)), 5,
                                              0.5, EPS))
        np.testing.assert_allclose(iso.numpy(), ref, rtol=1e-5, atol=0)


@pytest.mark.parametrize("n_iterations, rtol", [(1, 1e-5), (5, 1e-4)])
def test_diffusion_matches_reference(mdata_clusters, n_iterations, rtol):
    md, _ = mdata_clusters
    Ws = _affinities(md, 15)
    ref = np.asarray(jtg._snf_diffusion_fn()(jnp.asarray(np.stack(Ws)), n_iterations, 15))
    got = ts.snf_diffusion([torch.from_numpy(w.copy()) for w in Ws], n_iterations, 15)
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=0)


def test_normalize_and_dominate_set_plain():
    # a row of zeros keeps its divisor 1; ties at the k-th value are all kept
    x = torch.tensor([[0.0, 0.0, 0.0, 0.0],
                      [1.0, 2.0, 2.0, 2.0],
                      [3.0, 1.0, 0.0, 1.0],
                      [4.0, 4.0, 1.0, 0.0]])
    y = ts.snf_normalize(x)
    assert torch.equal(y, y.T) and (y.diagonal() == 0.5).all()
    assert y[0, 1].item() == pytest.approx(0.05)  # (0 / (2·1) + 1 / (2·5)) / 2
    d = ts.snf_dominate_set(x, 2)
    np.testing.assert_allclose(d[1].numpy(), [0, 1 / 3, 1 / 3, 1 / 3])
    np.testing.assert_allclose(d[2].numpy(), [0.6, 0.2, 0, 0.2])


@pytest.mark.parametrize("n_iterations", [5, 20])
def test_snf_matches_reference(mdata_clusters, n_iterations):
    md, labels = mdata_clusters
    md_ref, md_got = md.copy(), md.copy()
    mu.tl.snf(md_ref, n_neighbors=15, n_iterations=n_iterations)
    mt.tl.snf(md_got, n_neighbors=15, n_iterations=n_iterations, device="cpu")
    assert md_got.uns["neighbors"]["params"] == md_ref.uns["neighbors"]["params"]
    for key in ("connectivities", "distances"):
        got, ref = md_got.obsp[key].tocsr(), md_ref.obsp[key].tocsr()
        assert got.dtype == ref.dtype == np.float32
        assert (got != 0).nnz == (ref != 0).nnz
        assert ((got != 0) != (ref != 0)).nnz == 0  # the same edges
        np.testing.assert_allclose(got.toarray(), ref.toarray(), rtol=1e-4, atol=0)
    conn = md_got.obsp["connectivities"].tocsr()
    rows = np.repeat(np.arange(md.n_obs), np.diff(conn.indptr))
    assert (labels[conn.indices] == labels[rows]).mean() > 0.9


def test_snf_then_leiden(mdata_clusters):
    md, labels = mdata_clusters
    mt.tl.snf(md, n_neighbors=15, n_iterations=5, key_added="snf", device="cpu")
    assert set(md.obsp) >= {"snf_connectivities", "snf_distances"}
    assert md.uns["snf"]["connectivities_key"] == "snf_connectivities"
    from muon_tpu_torch.ops.leiden import multiplex_leiden

    fused = multiplex_leiden([md.obsp["snf_connectivities"]], [1.0], [1.0], seed=1)
    assert ari(labels, fused) > 0.85


def test_snf_refuses_a_modality_without_neighbors(mdata_clusters):
    md, _ = mdata_clusters
    del md.mod["m2"].uns["neighbors"]
    with pytest.raises(ValueError, match="Run neighbors"):
        mt.tl.snf(md, device="cpu")


# ---------------------------------------------------------------------------
# on the card: T29-T31 against their plain versions (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _knn_dist(n, k, seed):
    """A dense kNN distance matrix (asymmetric, zeros off the lists) of n
    points in 4 clusters, and its known-mask; integer coordinates give ties."""
    rng = np.random.default_rng(seed)
    P = (rng.integers(0, 4, (n, 1)) * 10 + rng.integers(0, 3, (n, 5))).astype(np.float32)
    D = np.sqrt(((P[:, None] - P[None]) ** 2).sum(-1))
    np.fill_diagonal(D, np.inf)
    idx = np.argsort(D, axis=1, kind="stable")[:, :k]
    dist = np.zeros((n, n), np.float32)
    np.put_along_axis(dist, idx, np.take_along_axis(D, idx, 1).astype(np.float32), 1)
    return dist, dist != 0


@pytest.mark.gpu
@pytest.mark.parametrize("n, k", [(1000, 20), (777, 15), (70, 1), (33, 40)])
def test_gpu_snf_kernels_match_plain(cuda, n, k):
    # n off a multiple of the 32 x 32 tiles and of the 64 selection threads
    dist, known = _knn_dist(n, min(k, n - 1), seed=n)
    d, kn = torch.from_numpy(dist).to(cuda), torch.from_numpy(known).to(cuda)
    _kernels.reset_launch_counts()
    W = ts.affinity_matrix(d, kn, k, 0.5, EPS)
    Wp = ts.affinity_matrix_plain(d, kn, k, 0.5, EPS)
    torch.testing.assert_close(W, Wp, rtol=1e-5, atol=0)
    N = ts.snf_normalize(W)
    torch.testing.assert_close(N, ts.snf_normalize_plain(W), rtol=1e-5, atol=1e-12)
    kk = min(k, n)
    S = ts.snf_dominate_set(N, kk)
    Sp = ts.snf_dominate_set_plain(N, kk)
    assert torch.equal(S != 0, Sp != 0)  # the same kept entries, ties included
    torch.testing.assert_close(S, Sp, rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert counts["snf_affinity"] == counts["snf_normalize"] == counts["snf_dominate_set"] == 1


@pytest.mark.gpu
def test_gpu_snf_diffusion_matches_plain(cuda, monkeypatch):
    dist, known = _knn_dist(500, 20, seed=1)
    d, kn = torch.from_numpy(dist).to(cuda), torch.from_numpy(known).to(cuda)
    Ws = [ts.affinity_matrix(d, kn, 20, 0.5, EPS), ts.affinity_matrix(d.T.contiguous(),
                                                                      kn.T.contiguous(),
                                                                      10, 0.5, EPS)]
    got = ts.snf_diffusion(Ws, 3, 20)
    monkeypatch.setattr(ts, "snf_normalize", ts.snf_normalize_plain)
    monkeypatch.setattr(ts, "snf_dominate_set", ts.snf_dominate_set_plain)
    want = ts.snf_diffusion(Ws, 3, 20)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
