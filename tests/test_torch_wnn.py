"""The port's WNN multimodal neighbors (muon_tpu_torch.ops.wnn, T9-T11 and
the torch dedup/top-k) held to the JAX package's (muon_tpu.ops.wnn) on the
same inputs.

Kernel-level tests put the reps on a grid of 1/4 in [-2, 2]: there every
bfloat16 rounding, product, norm and cross term is exact in float32 in both
packages, so what is left to differ is the order of a few float32 sums and
an ulp of XLA's sqrt and exp. The reference's tests run with x64 on, which
makes its bandwidth score float64 (``jac`` is int / int); in production
(TPU, x64 off) it is float32, as the port's. So the bandwidth is compared
with the reference both ways: in float32 (``jax.enable_x64(False)``) the
two select the same winners; in float64 a winner may differ only where the
float32 score cannot tell two candidates apart (a near-tie, stated below).
"""

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
    from muon_tpu.ops import wnn as jw
except ImportError:
    jax = jnp = mu = jw = None

import muon_tpu_torch as mt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import wnn as tw

CPU = torch.device("cpu")


def _quarter(n, d, seed):
    """Points on a 1/4 grid in [-2, 2]: bf16-exact, exact norms and cross terms."""
    return np.random.default_rng(seed).integers(-8, 9, size=(n, d)).astype(np.float32) / 4


def _neighbor_matrix(rep, kk, seed, ragged=0.15):
    """The (n, kk) exact-kNN index matrix, self excluded, columns sorted as
    the CSR fallback reads them; a share ``ragged`` of the rows lose 1-3
    trailing entries to -1 pads (a ragged CSR graph). Also nnd (n,) f32."""
    n = len(rep)
    rng = np.random.default_rng(seed)
    d2 = ((rep[:, None, :].astype(np.float64) - rep[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :kk]
    nnd = np.sqrt(np.take_along_axis(d2, order, axis=1)).astype(np.float32)
    NI = np.sort(order, axis=1).astype(np.int32)
    for i in np.flatnonzero(rng.random(n) < ragged):
        NI[i, kk - rng.integers(1, 4):] = -1
    return NI, nnd.min(axis=1)


def _bbox(rep):
    return float(np.linalg.norm(np.ptp(rep, axis=0), ord=2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# T9 bandwidth
# ---------------------------------------------------------------------------


def _port_sigma(NI, rep, n_bw, stride, dev=CPU):
    NI_t, rep_t = _t(NI).to(dev), _t(rep).to(dev)
    return tw.wnn_bandwidth(NI_t, *tw._bandwidth_tables(NI_t, rep_t), float(len(rep)),
                            _bbox(rep), n_bw, stride)


def _jax_sigma(NI, rep, n_bw, stride):
    return np.asarray(jw._bandwidth_fn()(
        jnp.asarray(NI), jnp.asarray(rep), float(len(rep)), _bbox(rep), n_bw, 64, stride))


@pytest.mark.parametrize("kk", [8, 19])  # stride 1 below 16, stride 2 from 16
def test_bandwidth_matches_jax_in_float32(kk):
    # the reference as it runs in production (x64 off): the same winners, so
    # sigma agrees to the order of its float32 mean (rtol 1e-6)
    rep = _quarter(200, 6, seed=kk)
    NI, _ = _neighbor_matrix(rep, kk, seed=kk)
    stride = tw._auto_nn_stride(kk)
    assert stride == jw._auto_nn_stride(kk) == (2 if kk >= 16 else 1)
    n_bw = min(20, kk)
    with jax.enable_x64(False):
        ref = _jax_sigma(NI, rep, n_bw, stride)
    got = _port_sigma(NI, rep, n_bw, stride).numpy()
    assert got.dtype == np.float32 and got.shape == (200,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kk", [8, 19])
def test_bandwidth_matches_jax_in_float64(kk):
    # the reference as its tests run it (x64 on: a float64 score). At n = 200
    # and bbox ~10 float32 resolves the euclidean tie-break (an ulp of N is
    # 1.5e-5, distinct distances on the grid differ by more than 7e-5 of
    # bbox), so sigma agrees at rtol 1e-6 on all but a few cells, and where
    # it differs the two sigmas stay within 5% (a near-tie: the float32
    # sum of N - jac N and the euclidean term rounds two candidates equal)
    rep = _quarter(200, 6, seed=kk + 1)
    NI, _ = _neighbor_matrix(rep, kk, seed=kk + 1)
    stride = tw._auto_nn_stride(kk)
    ref = _jax_sigma(NI, rep, min(20, kk), stride)
    got = _port_sigma(NI, rep, min(20, kk), stride).numpy()
    same = np.isclose(got, ref, rtol=1e-6, atol=0)
    assert same.mean() >= 0.98, same.mean()
    np.testing.assert_allclose(got, ref, rtol=5e-2)


def test_bandwidth_above_the_shared_memory_limit_matches_jax():
    # kk = 139 at stride 1: C = 19,460 candidates, whose tables pass the 227 KB
    # of one block's shared memory, so on the card T9 keeps them in global
    # memory; on the CPU the same function agrees with the reference as below
    # the limit (float32, the same winners). The reference's Jaccard compare is
    # C·kk² per cell, which sets this test's 40 s
    n, kk, n_bw = 141, 139, 20
    assert tw._bandwidth_smem(kk, 6, n_bw, 1) > tw.MAX_SMEM
    rep = _quarter(n, 6, seed=3)
    NI, _ = _neighbor_matrix(rep, kk, seed=3)
    with jax.enable_x64(False):
        ref = np.asarray(jw._bandwidth_fn()(
            jnp.asarray(NI), jnp.asarray(rep), float(n), _bbox(rep), n_bw, 8, 1))
    got = _port_sigma(NI, rep, n_bw, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


def test_bandwidth_fallback_and_duplicates():
    # cell 10's candidates all share no neighbour with it (jac = 1) or are
    # pads, so sigma falls back to the mean distance over its kk slots, the
    # pad measuring cell 0 as in the reference. Cell 11 reaches cell 14
    # three times (directly and through 12 and 13): it counts once
    rep = _quarter(40, 3, seed=5)
    NI, _ = _neighbor_matrix(rep, 3, seed=5, ragged=0.3)
    NI[10], NI[20], NI[21] = [20, 21, -1], [30, 31, -1], [32, 33, -1]
    NI[30:34] = [34, 35, 36]
    NI[11], NI[12], NI[13] = [12, 13, 14], [11, 14, 15], [11, 14, 16]
    with jax.enable_x64(False):
        ref = _jax_sigma(NI, rep, 3, 1)
    got = _port_sigma(NI, rep, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    e = lambda j: np.linalg.norm(rep[10] - rep[j])  # noqa: E731
    np.testing.assert_allclose(got[10], (e(20) + e(21) + e(0)) / 3, rtol=1e-6)


# ---------------------------------------------------------------------------
# T10 theta
# ---------------------------------------------------------------------------


def _theta_inputs(seed, n1=150, n2=130, d=7, kk=9):
    rng = np.random.default_rng(seed)
    rep1 = _quarter(n1, d, seed)
    rep2 = _quarter(n2, 5, seed + 1)
    NI2, _ = _neighbor_matrix(rep2, kk, seed=seed)
    # cells present in both, in a permuted order; conv maps mod2-local to
    # mod1-local, -1 where a mod2 cell is absent from mod1
    m = 110
    rows1 = rng.permutation(n1)[:m].astype(np.int32)
    rows2 = rng.permutation(n2)[:m].astype(np.int32)
    conv = np.full(n2, -1, np.int32)
    conv[rows2] = rows1
    _, nnd = _neighbor_matrix(rep1, kk, seed=seed, ragged=0)
    sigma = (nnd + rng.random(n1).astype(np.float32) * 2 + 0.25).astype(np.float32)
    sigma[:5] = nnd[:5]  # sigma == nnd: the 1e-12 floor
    return rep1, rows1, rows2, NI2, conv, nnd, sigma


def test_theta_matches_jax():
    # ragged pads, remapped neighbours absent from mod1 (-1), permuted rows,
    # sigma at nnd (the 1e-12 floor). The neighbour mean is exact on the grid
    # but for one division; the squared distance sums in another order:
    # theta = exp(-x) moves by x times its relative rounding, so rtol 1e-5
    # (x up to ~40 here) and atol 1e-30 for the thetas that underflow
    args = _theta_inputs(seed=3)
    with jax.enable_x64(False):
        ref = np.asarray(jw._theta_fn()(*(jnp.asarray(a) for a in args)))
    got = tw.wnn_theta(*(_t(a) for a in args)).numpy()
    assert got.dtype == np.float32 and got.shape == (110,)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-30)
    assert (got > 0).any() and (got < 1).any()


# ---------------------------------------------------------------------------
# T11 fusion scores
# ---------------------------------------------------------------------------


def _fusion_inputs(seed, metric, n=120, C=37, dims=((0, 6), (6, 10))):
    rng = np.random.default_rng(seed)
    M, D = len(dims), dims[-1][1]
    X = _quarter(n, D, seed)
    present = rng.random((n, M)) > 0.1
    if metric == "cosine":
        # unit rows per modality, stored in bf16 and norm 1, as wnn_neighbors does
        for lo, hi in dims:
            nrm = np.linalg.norm(X[:, lo:hi], axis=1, keepdims=True)
            X[:, lo:hi] = X[:, lo:hi] / np.where(nrm == 0, 1, nrm)
        X = torch.from_numpy(X).to(torch.bfloat16).float().numpy()
        sq = np.ones((n, M), np.float32)
    else:
        sq = np.stack([(X[:, lo:hi] ** 2).sum(1) for lo, hi in dims], axis=1)
    for m, (lo, hi) in enumerate(dims):
        X[~present[:, m], lo:hi] = 0
        sq[~present[:, m], m] = 0
    aux = np.concatenate([sq, present.astype(np.float32)], axis=1).astype(np.float32)
    sig = rng.random((n, M)).astype(np.float32) * 3 + 0.5
    sig[0, 0] = 0.0  # the 1e-12 floor
    w = rng.random((n, M))
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)
    sigw = np.concatenate([sig, w], axis=1).astype(np.float32)
    cand = rng.integers(0, n, size=(n, C)).astype(np.int32)
    cand[rng.random((n, C)) < 0.2] = -1
    return cand, X, aux, sigw, dims


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_fusion_scores_match_jax(metric):
    # cross terms exact on the grid; what differs is an ulp of sqrt/exp in
    # each modality's term (scores in [0, 1]: atol 1e-6)
    cand, X, aux, sigw, dims = _fusion_inputs(seed=11, metric=metric)
    n, C = cand.shape
    with jax.enable_x64(False):
        cat16 = jnp.asarray(X).astype(jnp.bfloat16)
        ref = np.asarray(jw._fusion_all_fn()(jnp.asarray(cand), cat16, jnp.asarray(aux),
                                             jnp.asarray(sigw), n, dims, metric))
    got = tw.wnn_fusion_scores(_t(cand), _t(X).to(torch.bfloat16), _t(aux), _t(sigw),
                               dims, metric).numpy()
    assert got.dtype == np.float32 and got.shape == (n, C)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert (got[cand < 0] == 0).all() and (got[cand >= 0] > 0).mean() > 0.5


def test_fusion_refuses_bad_dims():
    cand, X, aux, sigw, _ = _fusion_inputs(seed=12, metric="euclidean")
    with pytest.raises(ValueError, match="dims"):
        tw._dims_offsets(((0, 6), (7, 10)), 10)
    with pytest.raises(ValueError, match="cover"):
        tw._dims_offsets(((0, 6),), 10)


@pytest.mark.parametrize("kk, fits", [(19, True), (99, True), (194, True), (195, False)])
def test_bandwidth_shared_memory_bound(kk, fits):
    # T9 holds a cell's C = kk + kk·ceil(kk/2) candidates in one block's
    # shared memory (4 bytes each for id, score and distance): the e2e's
    # kk = 19 takes 3.4 KB; past kk = 194 at d = 50 the wrapper refuses
    # before it launches
    C = kk + kk * -(-kk // 2)
    smem = tw._bandwidth_smem(kk, 50, 20, 2)
    assert smem == 4 * (kk + 3 * C + 2 * min(C, 80) + 50)
    assert (smem <= tw.MAX_SMEM) == fits


# ---------------------------------------------------------------------------
# K11: dedup + compaction, final top-k (torch)
# ---------------------------------------------------------------------------


def test_cand_dedup_matches_jax_exactly():
    rng = np.random.default_rng(21)
    cand = rng.integers(0, 15, size=(90, 24)).astype(np.int32)  # many repeats
    cand[rng.random(cand.shape) < 0.3] = -1
    cand[5] = -1  # a row with no candidate
    ref, ref_nv = jw._cand_dedup_fn()(jnp.asarray(cand), block=128)
    got, nv = tw.cand_dedup(_t(cand))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref)[:90])
    assert nv == int(ref_nv)
    assert got.dtype == torch.int32


def test_final_topk_matches_jax_exactly():
    # scores on a coarse grid (many exact ties: the lower position first),
    # -1 candidates (+inf), and scores above 1 (NaN distances, which the
    # reference on the CPU ranks first, in position order)
    rng = np.random.default_rng(22)
    scores = (rng.integers(0, 9, size=(60, 30)) / 8).astype(np.float32)
    scores[rng.random(scores.shape) < 0.05] = np.float32(1.0000001)
    cand = rng.permutation(60 * 30).reshape(60, 30).astype(np.int32)
    cand[rng.random(cand.shape) < 0.25] = -1
    cand[7, 3:] = -1  # fewer candidates than k
    with jax.enable_x64(False):
        ri, rd = (np.asarray(a) for a in jw._final_topk_fn()(jnp.asarray(scores),
                                                              jnp.asarray(cand), 11))
    gi, gd = (t.numpy() for t in tw.final_topk(_t(scores), _t(cand), 11))
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_array_equal(np.isnan(gd), np.isnan(rd))
    np.testing.assert_allclose(gd[~np.isnan(gd)], rd[~np.isnan(rd)], rtol=1e-7, atol=0)
    assert np.isnan(gd[:, 0]).any() and np.isinf(gd[7, 3:]).all()


# ---------------------------------------------------------------------------
# the whole pp.neighbors(mdata) against muon_tpu's
# ---------------------------------------------------------------------------


def clustered_data(n_per=40, n_clusters=3, d=12, seed=0, noise=0.3):
    """tests/test_neighbors.py's planted clusters."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)) * 4
    X = np.concatenate(
        [centers[i] + noise * rng.normal(size=(n_per, d)) for i in range(n_clusters)]
    ).astype(np.float32)
    return X, np.repeat(np.arange(n_clusters), n_per)


def _label_share(D, labels):
    D = D.tocoo()
    return float((labels[D.row] == labels[D.col]).mean())


def _edge_jaccard(A, B):
    a = set(zip(*A.nonzero()))
    b = set(zip(*B.nonzero()))
    return len(a & b) / max(len(a | b), 1)


def _both_packages(X1, X2, n_neighbors=10, jax_graphs=True, **kw):
    """One MuData, its per-modality graphs made by the JAX package (or by
    the port), WNN by each package on its own copy. Returns (jax, port)."""
    md = mu.MuData({"m1": mu.AnnData(X1), "m2": mu.AnnData(X2)})
    nb = mu.pp.neighbors if jax_graphs else (lambda a, **k: mt.pp.neighbors(a, device=CPU, **k))
    for m in md.mod.values():
        nb(m, n_neighbors=n_neighbors)
    md_t = md.copy()
    mu.pp.neighbors(md, **kw)
    mt.pp.neighbors(md_t, device=CPU, **kw)
    return md, md_t


def _assert_wnn_close(md, md_t, w_atol, min_overlap, conn_atol):
    for mod in md.mod:
        np.testing.assert_allclose(md_t.obs[f"{mod}:mod_weight"].to_numpy(),
                                   md.obs[f"{mod}:mod_weight"].to_numpy(), atol=w_atol)
    Dj, Dt = md.obsp["distances"], md_t.obsp["distances"]
    assert _edge_jaccard(Dj, Dt) >= min_overlap
    Cj, Ct = md.obsp["connectivities"], md_t.obsp["connectivities"]
    both = Ct.multiply(Cj.astype(bool)).tocsr()
    ref = Cj.multiply(Ct.astype(bool)).tocsr()
    np.testing.assert_allclose(both.data, ref.data, rtol=0, atol=conn_atol)
    assert md_t.uns["neighbors"] == md.uns["neighbors"]


def test_wnn_matches_jax_on_jax_graphs():
    # the per-modality graphs are the JAX package's (the port reads them
    # through the CSR fallback), so no kNN difference enters. The weights
    # differ by float32 rounding of theta (exp of up to ~40 times a rounded
    # distance) and the float64-vs-float32 bandwidth score: atol 1e-4. The
    # fused distance sqrt(0.5 (1 - score)) magnifies a score's rounding by
    # 1/(4 d) near d = 0, so the graphs are held by their edge sets (Jaccard
    # >= 0.99) and the connectivities on shared edges at atol 1e-3
    X1, labels = clustered_data()
    X2, _ = clustered_data(d=9, seed=1)
    md, md_t = _both_packages(X1, X2)
    _assert_wnn_close(md, md_t, w_atol=1e-4, min_overlap=0.99, conn_atol=1e-3)
    assert abs(_label_share(md_t.obsp["distances"], labels)
               - _label_share(md.obsp["distances"], labels)) <= 0.005


def test_wnn_overlapping_clusters_match_jax():
    # neither modality alone separates the labels: m1 merges clusters 0/1,
    # m2 merges 1/2, both noisy, so the planted-label share of the fused
    # graph is below 1. Port and JAX: the same share within
    # 0.01, weights atol 1e-4, edge Jaccard >= 0.97
    rng = np.random.default_rng(31)
    labels = np.repeat(np.arange(3), 60)
    c1 = rng.normal(size=(3, 10)) * 3
    c1[1] = c1[0]
    c2 = rng.normal(size=(3, 8)) * 3
    c2[2] = c2[1]
    X1 = (c1[labels] + rng.normal(size=(180, 10)) * 1.2).astype(np.float32)
    X2 = (c2[labels] + rng.normal(size=(180, 8)) * 1.2).astype(np.float32)
    md, md_t = _both_packages(X1, X2, n_neighbors=15)
    sj = _label_share(md.obsp["distances"], labels)
    st = _label_share(md_t.obsp["distances"], labels)
    assert 0.6 < st < 0.99 and abs(st - sj) <= 0.01, (st, sj)
    _assert_wnn_close(md, md_t, w_atol=1e-4, min_overlap=0.97, conn_atol=1e-3)


def test_wnn_duplicated_points_match_jax():
    # cells identical in every modality, fused by cosine: the bf16-rounded
    # unit rows give cross > 1, so the score of a duplicate rounds above 1
    # and sqrt(0.5 (1 - score)) is NaN. Both packages rank a NaN candidate
    # first, drop it from the distances CSR (those rows hold fewer than
    # n_neighbors + 1 entries) and carry the NaN into its connectivity.
    # With two modalities and euclidean fusion the score of a duplicate is
    # f32(w1) + f32(w2), which never rounds above 1
    X1 = _quarter(100, 6, seed=41)
    X2 = _quarter(100, 5, seed=42)
    X1[50:56], X2[50:56] = X1[:6], X2[:6]
    md, md_t = _both_packages(X1, X2, n_neighbors=8, metric="cosine")
    Dj, Dt = md.obsp["distances"], md_t.obsp["distances"]
    short = np.flatnonzero(np.diff(Dt.indptr) < 9)
    assert len(short) > 0 and set(short) <= set(range(6)) | set(range(50, 56))
    np.testing.assert_array_equal(Dt.indptr, Dj.indptr)
    np.testing.assert_array_equal(Dt.indices, Dj.indices)
    # d = sqrt(0.5 (1 - score)) magnifies a score's float32 rounding by
    # 1/(4 d): atol 1e-5 for the distances near 0
    np.testing.assert_allclose(Dt.data, Dj.data, rtol=1e-4, atol=1e-5)
    Cj, Ct = md.obsp["connectivities"], md_t.obsp["connectivities"]
    np.testing.assert_array_equal(Ct.indices, Cj.indices)
    assert np.isnan(Ct.data).any()
    np.testing.assert_array_equal(np.isnan(Ct.data), np.isnan(Cj.data))
    np.testing.assert_allclose(Ct.data, Cj.data, rtol=0, atol=1e-4)
    for mod in md.mod:
        np.testing.assert_allclose(md_t.obs[f"{mod}:mod_weight"].to_numpy(),
                                   md.obs[f"{mod}:mod_weight"].to_numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the port alone on tests/test_neighbors.py::TestWNN's cases
# ---------------------------------------------------------------------------


class TestWNN:
    def _make_mdata(self, informative=(True, True), seed=0, n_per=40):
        X1, labels = clustered_data(n_per=n_per, seed=seed)
        if informative[1]:
            X2, _ = clustered_data(n_per=n_per, d=9, seed=seed + 1)
        else:
            X2 = np.random.default_rng(seed + 2).normal(size=(X1.shape[0], 9)).astype(np.float32)
        m1, m2 = mu.AnnData(X1), mu.AnnData(X2)
        md = mu.MuData({"m1": m1, "m2": m2})
        mt.pp.neighbors(m1, n_neighbors=10, device=CPU)
        mt.pp.neighbors(m2, n_neighbors=10, device=CPU)
        return md, labels

    @staticmethod
    def _share(md, labels):
        return _label_share(md.obsp["distances"], labels)

    def test_wnn_outputs(self):
        md, labels = self._make_mdata()
        assert mt.pp.neighbors(md, device=CPU) is None
        assert "distances" in md.obsp and "connectivities" in md.obsp
        assert md.uns["neighbors"]["params"]["n_neighbors"] == 10
        w1 = md.obs["m1:mod_weight"].to_numpy()
        w2 = md.obs["m2:mod_weight"].to_numpy()
        assert np.allclose(w1 + w2, 1.0, atol=1e-5)
        D, C = md.obsp["distances"], md.obsp["connectivities"]
        assert (np.diff(D.indptr) == 11).all()  # n_neighbors + 1, no self
        assert D.diagonal().max() == 0 and D.has_sorted_indices
        assert abs(C - C.T).max() < 1e-6 and C.data.min() > 0 and C.data.max() <= 1

    def test_wnn_graph_quality(self):
        md, labels = self._make_mdata()
        mt.pp.neighbors(md, device=CPU)
        assert self._share(md, labels) > 0.95

    def test_wnn_weights_favor_informative(self):
        md, _ = self._make_mdata(informative=(True, False))
        mt.pp.neighbors(md, device=CPU)
        assert np.nanmean(md.obs["m1:mod_weight"].to_numpy()) > 0.6

    def test_wnn_requires_per_mod_neighbors(self):
        X1, _ = clustered_data()
        md = mu.MuData({"m1": mu.AnnData(X1)})
        with pytest.raises(ValueError, match="Run neighbors on all modalities first"):
            mt.pp.neighbors(md, device=CPU)

    def test_wnn_key_added(self):
        md, _ = self._make_mdata()
        mt.pp.neighbors(md, key_added="wnn", device=CPU)
        assert "wnn" in md.uns and "wnn_distances" in md.obsp
        assert "wnn_connectivities" in md.obsp and "distances" not in md.obsp

    def test_wnn_copy(self):
        md, _ = self._make_mdata()
        out = mt.pp.neighbors(md, copy=True, device=CPU)
        assert out is not md
        assert "distances" in out.obsp and "distances" not in md.obsp

    def test_wnn_ragged(self):
        md, labels = self._make_mdata()
        m2 = md.mod["m2"][: md.n_obs - 20].copy()
        md = mu.MuData({"m1": md.mod["m1"], "m2": m2})
        mt.pp.neighbors(md.mod["m1"], n_neighbors=10, device=CPU)
        mt.pp.neighbors(md.mod["m2"], n_neighbors=10, device=CPU)
        mt.pp.neighbors(md, device=CPU)
        assert md.obsp["distances"].shape == (md.n_obs, md.n_obs)
        assert self._share(md, labels) > 0.9
        # the 20 cells without m2 weigh m1 alone
        w2 = md.obs["m2:mod_weight"].to_numpy()
        assert np.isnan(w2[-20:]).all() and (md.obs["m1:mod_weight"].to_numpy()[-20:] == 1).all()

    def test_wnn_permuted_modality_order(self):
        md, _ = self._make_mdata()
        mt.pp.neighbors(md, device=CPU)
        w_ref = md.obs["m1:mod_weight"].to_numpy()
        perm = np.random.default_rng(5).permutation(md.n_obs)
        m1 = md.mod["m1"].copy()
        m2 = mu.AnnData(np.asarray(md.mod["m2"].X)[perm])
        m1.obs_names = [f"cell{i}" for i in range(md.n_obs)]
        m2.obs_names = [f"cell{perm[i]}" for i in range(md.n_obs)]
        md2 = mu.MuData({"m1": m1, "m2": m2})
        mt.pp.neighbors(md2.mod["m1"], n_neighbors=10, device=CPU)
        mt.pp.neighbors(md2.mod["m2"], n_neighbors=10, device=CPU)
        mt.pp.neighbors(md2, device=CPU)
        w1 = md2.obs["m1:mod_weight"].to_numpy()
        order = [list(md2.obs_names).index(f"cell{i}") for i in range(md.n_obs)]
        assert np.allclose(w1[order], w_ref, atol=1e-3)

    def test_wnn_add_weights_to_modalities(self):
        md, _ = self._make_mdata()
        mt.pp.neighbors(md, add_weights_to_modalities=True, device=CPU)
        w1 = md.mod["m1"].obs["mod_weight"].to_numpy()
        w2 = md.mod["m2"].obs["mod_weight"].to_numpy()
        assert np.allclose(w1 + w2, 1.0, atol=1e-5)
        assert "m1:mod_weight" not in md.obs.columns

    def test_wnn_knn_tag_fallback_equivalent(self):
        # the port hangs no tag on its graphs: WNN always reads the CSR, so
        # a fresh copy of the same CSR (no attribute survives .copy() of the
        # reference's tag either) gives an identical result
        md, _ = self._make_mdata()
        for m in md.mod.values():
            D = m.obsp["distances"]
            assert D.has_sorted_indices
            assert not any(k.startswith("_muon") for k in vars(D))
            NI, nnd = tw._neighbor_index_matrix(D)
            assert (np.diff(NI, axis=1) > 0).all()  # column-sorted, as σ reads it
            np.testing.assert_array_equal(nnd, np.minimum.reduceat(
                D.data.astype(np.float32), D.indptr[:-1]))
        mt.pp.neighbors(md, device=CPU)
        d_ref = md.obsp["distances"].copy()
        w_ref = md.obs["m1:mod_weight"].to_numpy()
        for m in md.mod.values():
            m.obsp["distances"] = sp.csr_matrix(m.obsp["distances"].toarray())
        mt.pp.neighbors(md, device=CPU)
        assert (md.obsp["distances"] != d_ref).nnz == 0
        np.testing.assert_array_equal(md.obs["m1:mod_weight"].to_numpy(), w_ref)

    def test_wnn_tag_detects_in_place_edit(self, monkeypatch):
        # editing .data or .indices in place keeps n and nnz (the reference's
        # only guard for its tag): the port rebuilds every modality's matrix
        # on every call, so WNN reads the edit
        md, _ = self._make_mdata()
        seen = []
        real = tw._neighbor_index_matrix
        monkeypatch.setattr(tw, "_neighbor_index_matrix",
                            lambda dm: seen.append(real(dm)) or seen[-1])
        mt.pp.neighbors(md, device=CPU)
        assert len(seen) == 2
        w_before = md.obs["m1:mod_weight"].to_numpy()
        D = md.mod["m1"].obsp["distances"]
        D.data[D.indptr[3]:D.indptr[4]] *= 0.5  # row 3's distances halved
        mt.pp.neighbors(md, device=CPU)
        assert len(seen) == 4
        NI, nnd = seen[2]
        assert nnd[3] == np.float32(D.data[D.indptr[3]:D.indptr[4]].min())
        assert md.obs["m1:mod_weight"].to_numpy()[3] != w_before[3]
        D.indices[D.indptr[5]], D.indices[D.indptr[5] + 1] = (
            D.indices[D.indptr[5] + 1], D.indices[D.indptr[5]])
        mt.pp.neighbors(md, device=CPU)
        assert len(seen) == 6
        np.testing.assert_array_equal(seen[4][0][5, :2], NI[5, 1::-1])

    def test_wnn_defaults_n_neighbors_to_the_modalities_mean(self):
        X1, _ = clustered_data()
        X2, _ = clustered_data(d=9, seed=1)
        md = mu.MuData({"m1": mu.AnnData(X1), "m2": mu.AnnData(X2)})
        mt.pp.neighbors(md.mod["m1"], n_neighbors=8, device=CPU)
        mt.pp.neighbors(md.mod["m2"], n_neighbors=13, device=CPU)
        mt.pp.neighbors(md, device=CPU)  # round(10.5) = 10, as the reference
        assert md.uns["neighbors"]["params"]["n_neighbors"] == 10
        assert (np.diff(md.obsp["distances"].indptr) == 11).all()


def test_wnn_on_duck_typed_holders():
    # the least MuData-like object: .mod, .obsmap (1-based), .n_obs, .obs,
    # .obsp, .uns; update_obs is optional
    class Holder:
        def __init__(self, X):
            self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}
            self.n_obs = X.shape[0]

    class MuHolder:
        def __init__(self, mods):
            self.mod, self.n_obs = mods, 120
            self.obsmap = {k: np.arange(1, 121) for k in mods}
            self.obs, self.obsp, self.uns = {}, {}, {}

    X1, labels = clustered_data()
    X2, _ = clustered_data(d=9, seed=1)
    mdh = MuHolder({"a": Holder(X1), "b": Holder(X2)})
    for h in mdh.mod.values():
        mt.pp.neighbors(h, n_neighbors=10, use_rep="X", device=CPU)
    assert mt.pp.neighbors(mdh, device=CPU) is None
    assert np.allclose(mdh.obs["a:mod_weight"] + mdh.obs["b:mod_weight"], 1.0)
    assert _label_share(mdh.obsp["distances"], labels) > 0.95
    with pytest.raises(NotImplementedError, match="the multi-device work, K20"):
        mt.pp.neighbors(mdh, mesh=object(), device=CPU)


def test_cpu_wnn_counts_no_launch():
    X1, _ = clustered_data()
    X2, _ = clustered_data(d=9, seed=1)
    md = mu.MuData({"m1": mu.AnnData(X1), "m2": mu.AnnData(X2)})
    for m in md.mod.values():
        mt.pp.neighbors(m, n_neighbors=10, device=CPU)
    _kernels.reset_launch_counts()
    mt.pp.neighbors(md, device=CPU)
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card: T9-T11 against their plain versions (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launched(name, fn):
    _kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    assert _kernels.launch_counts()[name] == 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("kk,d", [(8, 6), (19, 50), (29, 7)])
def test_gpu_wnn_bandwidth_matches_plain(cuda, kk, d):
    # the same float32 score and (score, position) order: the same winners;
    # sigma differs by the order of its float32 sums (rtol 1e-5)
    rep = np.random.default_rng(kk).normal(size=(3000, d)).astype(np.float32)
    NI, _ = _neighbor_matrix(rep[:3000], kk, seed=kk)
    NI_t, rep_t = _t(NI).to(cuda), _t(rep).to(cuda)
    tables = tw._bandwidth_tables(NI_t, rep_t)
    args = (NI_t, *tables, 3000.0, _bbox(rep), min(20, kk), tw._auto_nn_stride(kk))
    got = _launched("wnn_bandwidth", lambda: tw.wnn_bandwidth(*args))
    ref = tw.wnn_bandwidth_plain(*args)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)


@pytest.mark.gpu
def test_gpu_wnn_bandwidth_above_the_shared_memory_limit(cuda):
    # kk = 256, d = 50: 33,024 candidates per cell, 396 KB of tables, which no
    # block's shared memory holds: the variant with the tables in global
    # memory runs (its own counter) and agrees with the plain version as the
    # shared-memory variant does; kk = 194 still takes the shared-memory one
    n, kk, d = 400, 256, 50
    rep = np.random.default_rng(5).normal(size=(n, d)).astype(np.float32)
    NI, _ = _neighbor_matrix(rep, kk, seed=5)
    NI_t, rep_t = _t(NI).to(cuda), _t(rep).to(cuda)
    args = (NI_t, *tw._bandwidth_tables(NI_t, rep_t), float(n), _bbox(rep), 20, 2)
    got = _launched("wnn_bandwidth_global", lambda: tw.wnn_bandwidth(*args))
    assert _kernels.launch_counts()["wnn_bandwidth"] == 0
    torch.testing.assert_close(got, tw.wnn_bandwidth_plain(*args), rtol=1e-5, atol=0)
    args = (NI_t[:, :194].contiguous(), *tw._bandwidth_tables(NI_t[:, :194], rep_t), float(n),
            _bbox(rep), 20, 2)
    _launched("wnn_bandwidth", lambda: tw.wnn_bandwidth(*args))
    assert _kernels.launch_counts()["wnn_bandwidth_global"] == 0


@pytest.mark.gpu
def test_gpu_wnn_theta_matches_plain(cuda):
    args = [_t(a).to(cuda) for a in _theta_inputs(seed=4, n1=3000, n2=2800, d=50, kk=19)]
    got = _launched("wnn_theta", lambda: tw.wnn_theta(*args))
    ref = tw.wnn_theta_plain(*args)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_gpu_wnn_fusion_scores_match_plain(cuda, metric):
    cand, X, aux, sigw, dims = _fusion_inputs(seed=13, metric=metric, n=3000, C=400,
                                              dims=((0, 50), (50, 100)))
    args = (_t(cand).to(cuda), _t(X).to(cuda).to(torch.bfloat16), _t(aux).to(cuda),
            _t(sigw).to(cuda), dims, metric)
    got = _launched("wnn_fusion_scores", lambda: tw.wnn_fusion_scores(*args))
    ref = tw.wnn_fusion_scores_plain(*args)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_gpu_smooth_knn_keeps_nan_as_plain(cuda):
    # T6 on WNN rows with a NaN distance (a score rounded above 1): the NaN
    # stays in its membership value and the row's sigma takes the same
    # bisection as the plain version's, which propagates the NaN
    from muon_tpu_torch.ops import fuzzy as tf

    d = torch.rand((64, 9), generator=torch.Generator().manual_seed(1)) + 0.1
    d = torch.sort(d, dim=1).values
    d[3, 0] = d[10, 4] = float("nan")
    dg = d.to(cuda)
    got = _launched("smooth_knn_membership", lambda: tf.smooth_knn(dg))
    ref = tf.smooth_knn_plain(dg)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6, equal_nan=True)
    assert torch.isnan(got[2][3, 0]) and torch.isnan(got[2][10, 4])


@pytest.mark.gpu
def test_gpu_wnn_refuses_bad_input(cuda):
    NI = torch.zeros((10, 4), dtype=torch.int32, device=cuda)
    rep = torch.zeros((10, 3), device=cuda)
    tables = tw._bandwidth_tables(NI, rep)
    with pytest.raises(ValueError):
        tw.wnn_bandwidth(NI.long(), *tables, 10.0, 1.0, 4, 1)
    with pytest.raises(ValueError):
        tw.wnn_bandwidth(NI, tables[0], tables[1].float(), tables[2], 10.0, 1.0, 4, 1)
    with pytest.raises(ValueError):
        tw.wnn_fusion_scores(NI, rep.to(torch.bfloat16), torch.zeros((10, 2), device=cuda),
                             torch.zeros((10, 2), device=cuda), ((0, 2),), "euclidean")


@pytest.mark.gpu
def test_gpu_wnn_matches_cpu(cuda):
    # the whole path on the card against the CPU (plain versions) from the
    # same per-modality graphs: weights atol 1e-4, edge Jaccard >= 0.98; the
    # kernels ran, T9 once per modality, T10 once per pair, T11 once
    X1, labels = clustered_data(n_per=1000, d=20)
    X2, _ = clustered_data(n_per=1000, d=15, seed=1)

    class Holder:
        def __init__(self, X):
            self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}
            self.n_obs = X.shape[0]

    class MuHolder:
        def __init__(self, mods, n):
            self.mod, self.n_obs = mods, n
            self.obsmap = {k: np.arange(1, n + 1) for k in mods}
            self.obs, self.obsp, self.uns = {}, {}, {}

    hs = {"a": Holder(X1), "b": Holder(X2)}
    for h in hs.values():
        mt.pp.neighbors(h, n_neighbors=20, use_rep="X", device=CPU)
    md_c, md_g = MuHolder(hs, 3000), MuHolder(hs, 3000)
    mt.pp.neighbors(md_c, device=CPU)
    _kernels.reset_launch_counts()
    mt.pp.neighbors(md_g, device=cuda)
    counts = _kernels.launch_counts()
    assert counts["wnn_bandwidth"] == 2 and counts["wnn_theta"] == 4
    assert counts["wnn_fusion_scores"] == 1 and counts["knn_topk"] == 2
    assert counts["smooth_knn_membership"] == 1
    for m in ("a", "b"):
        np.testing.assert_allclose(md_g.obs[f"{m}:mod_weight"], md_c.obs[f"{m}:mod_weight"],
                                   atol=1e-4)
    assert _edge_jaccard(md_g.obsp["distances"], md_c.obsp["distances"]) >= 0.98
    assert abs(_label_share(md_g.obsp["distances"], labels)
               - _label_share(md_c.obsp["distances"], labels)) <= 0.01
