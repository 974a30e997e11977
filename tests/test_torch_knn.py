"""The port's kNN (muon_tpu_torch/ops/knn.py, T5) held to the JAX package's
(muon_tpu/ops/knn.py) on the same points.

The two packages sum the cross term in another order, so the tests state
the distance tolerance of the expanded form: |Δd²| ≤ 1e-5·(|q|² + |c|²)
(the cancellation error of |q|² + |c|² − 2q·c, not relative to d²), and
where the indices differ at a rank, the two chosen points must be equally
near within that tolerance (a near-tie the summation order decides). On
integer points every product, norm and cross term is exact in float32,
also with bfloat16 operands, so there the two agree exactly and the many
exact ties check the order: distance, then the lower index.
"""

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    from muon_tpu.ops import knn as jk
except ImportError:
    jk = None

from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import knn as tk

CPU = torch.device("cpu")
METRICS = ["euclidean", "sqeuclidean", "cosine", "correlation"]


def _gaussian(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _integer_points(n, d, seed):
    return np.random.default_rng(seed).integers(-8, 9, size=(n, d)).astype(np.float32)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).double().numpy()


def _sq_and_dists(X, metric, approx):
    """float64 (n,) scale |q|² and (n, n) distances at the reference's
    rounding points (bfloat16 operands under approx, norms unrounded)."""
    X64 = X.astype(np.float64)
    if metric in ("cosine", "correlation"):
        Z = X64 - X64.mean(axis=1, keepdims=True) if metric == "correlation" else X64
        norms = np.linalg.norm(Z, axis=1, keepdims=True)
        Z = Z / np.where(norms == 0, 1.0, norms)
        Zm = _bf16(Z) if approx else Z
        return np.ones(len(X)), 1.0 - Zm @ Zm.T
    sq = (X64 * X64).sum(axis=1)
    Xm = _bf16(X) if approx else X64
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * Xm @ Xm.T, 0.0)
    return sq, d2


def _assert_same_knn(got, ref, X, metric, approx, min_equal=0.99):
    gi, gd = (np.asarray(a) for a in got)
    ri, rd = (np.asarray(a) for a in ref)
    n = len(X)
    assert gi.shape == ri.shape and gd.shape == rd.shape
    assert gi.dtype == np.int32 and gd.dtype == np.float32
    np.testing.assert_array_equal(gi[:, 0], np.arange(n))
    assert (gd[:, 0] == 0).all()
    sq, D = _sq_and_dists(X, metric, approx)
    rows = np.arange(n)[:, None]
    bound = 1e-5 * (sq[:, None] + sq[ri])
    sqr = (lambda a: a.astype(np.float64) ** 2) if metric == "euclidean" else \
        (lambda a: a.astype(np.float64))
    assert (np.abs(sqr(gd) - sqr(rd)) <= bound).all()
    # a differing index is a near-tie: both points equally near
    assert (np.abs(D[rows, gi] - D[rows, ri]) <= bound).all()
    assert (gi == ri).mean() >= min_equal
    # every row holds distinct points, self excluded from columns 1..k
    srt = np.sort(gi, axis=1)
    assert (np.diff(srt, axis=1) > 0).all()


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("metric", METRICS)
def test_knn_matches_jax(metric, approx):
    X = _gaussian(300, 16, seed=1)
    ref = jk.knn(X, 10, metric=metric, approx=approx)
    got = tk.knn(X, 10, metric=metric, approx=approx, device=CPU)
    _assert_same_knn(got, ref, X, metric, approx)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean"])
@pytest.mark.parametrize("n,d", [(300, 16), (5000, 8)])
def test_knn_integer_points_match_jax_exactly(n, d, metric, approx):
    # n = 5000 > 4096 runs the reference's chunked two-stage top-k; at d = 8
    # with integer points most ranks are exact ties. rtol 1e-6 on euclidean:
    # XLA's float32 sqrt may differ from the correctly rounded one by an ulp
    X = _integer_points(n, d, seed=n)
    ri, rd = (np.asarray(a) for a in jk.knn(X, 10, metric=metric, approx=approx))
    gi, gd = (t.numpy() for t in tk.knn(X, 10, metric=metric, approx=approx, device=CPU))
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gd, rd, rtol=1e-6 if metric == "euclidean" else 0, atol=0)


@pytest.mark.parametrize("metric", METRICS)
def test_knn_duplicate_rows_keep_self_first(metric):
    X = _gaussian(120, 6, seed=3)
    X[50] = X[7]
    X[51] = X[7]
    ref = jk.knn(X, 5, metric=metric)
    gi, gd = (t.numpy() for t in tk.knn(X, 5, metric=metric, device=CPU))
    _assert_same_knn((gi, gd), ref, X, metric, False)
    # a duplicate lies at distance 0 (up to the rounding of the expanded
    # form) and never displaces self from column 0
    for i, dups in ((7, {50, 51}), (50, {7, 51}), (51, {7, 50})):
        assert gi[i, 0] == i and set(gi[i, 1:3]) == dups
        assert gd[i, 1:3].max() < gd[i, 3]


def test_knn_k_at_least_n_minus_1():
    X = _gaussian(12, 4, seed=4)
    for k in (11, 12, 40):
        ref = jk.knn(X, k)
        got = tk.knn(X, k, device=CPU)
        assert got[0].shape == (12, 12)
        _assert_same_knn(got, ref, X, "euclidean", False, min_equal=1.0)
    gi, gd = tk.knn(X[:1], 3, device=CPU)
    assert gi.tolist() == [[0]] and gd.tolist() == [[0.0]]


def test_knn_without_self():
    X = _gaussian(80, 5, seed=5)
    full = tk.knn(X, 6, device=CPU)
    ri, rd = (np.asarray(a) for a in jk.knn(X, 6, include_self=False))
    gi, gd = tk.knn(X, 6, include_self=False, device=CPU)
    assert torch.equal(gi, full[0][:, 1:]) and torch.equal(gd, full[1][:, 1:])
    np.testing.assert_array_equal(gi.numpy(), ri)
    np.testing.assert_allclose(gd.numpy(), rd, rtol=1e-5, atol=1e-6)


def test_unknown_metric_error_matches_jax():
    X = _gaussian(20, 3, seed=6)
    with pytest.raises(NotImplementedError) as ref:
        jk.knn(X, 3, metric="manhattan")
    with pytest.raises(NotImplementedError) as got:
        tk.knn(X, 3, metric="manhattan", device=CPU)
    assert str(got.value) == str(ref.value)
    # the aliases of the reference
    np.testing.assert_array_equal(tk.knn(X, 3, metric="l2", device=CPU)[0].numpy(),
                                  tk.knn(X, 3, metric="euclidean", device=CPU)[0].numpy())


def test_ivf_is_not_run_as_brute_force(monkeypatch):
    # method="ivf", and approx above the threshold, go to the IVF index
    # (ops/ivf.py, held in tests/test_torch_ivf.py), never to brute force
    from muon_tpu_torch.ops import ivf as ti

    X = _gaussian(60, 4, seed=7)
    calls = []
    real = ti.ivf_knn
    monkeypatch.setattr(ti, "ivf_knn", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    idx, _ = tk.knn(X, 3, method="ivf", device=CPU)
    assert len(calls) == 1 and idx.shape == (60, 4)
    np.testing.assert_array_equal(idx[:, 0].numpy(), np.arange(60))
    monkeypatch.setattr(tk, "IVF_THRESHOLD", 50)
    assert tk.knn(X, 3, approx=True, device=CPU)[0].shape == (60, 4)
    assert len(calls) == 2
    # exact kNN and forced brute force stay brute force above the threshold
    assert tk.knn(X, 3, device=CPU)[0].shape == (60, 4)
    assert tk.knn(X, 3, approx=True, method="brute", device=CPU)[0].shape == (60, 4)
    assert len(calls) == 2


def test_pairwise_sq_dists_matches_jax():
    # |Δ| ≤ 1e-5·(|q|² + |c|²), the expanded form's cancellation error
    Q, C = _gaussian(30, 7, seed=8), _gaussian(45, 7, seed=9)
    ref = np.asarray(jk.pairwise_sq_dists(Q, C))
    got = tk.pairwise_sq_dists(Q, C, device=CPU).numpy()
    bound = 1e-5 * ((Q * Q).sum(1)[:, None] + (C * C).sum(1)[None, :])
    assert got.shape == (30, 45) and (np.abs(got - ref) <= bound).all()


def test_cpu_knn_counts_no_launch():
    _kernels.reset_launch_counts()
    tk.knn(_gaussian(50, 4, seed=10), 5, device=CPU)
    assert _kernels.launch_counts()["knn_topk"] == 0


# ---------------------------------------------------------------------------
# on the card: T5 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k,d", [(19, 50), (200, 50), (19, 70), (10, 3)])
def test_gpu_knn_topk_matches_plain(cuda, metric, approx, k, d):
    # d = 50 and 70 are no multiple of the kernel's 32-wide d-chunk; k = 200
    # takes the 256-long list. Tolerances as against JAX above
    X = _gaussian(3000, d, seed=d + k)
    op, sq = tk._operand(torch.from_numpy(X).to(cuda), tk._metric(metric), approx)
    args = (k, metric in ("cosine", "correlation"), metric == "euclidean")
    _kernels.reset_launch_counts()
    got = tk.knn_topk(op, sq, *args)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["knn_topk"] == 1
    ref = tk.knn_topk_plain(op, sq, *args)
    _assert_same_knn([t.cpu() for t in got], [t.cpu() for t in ref], X, metric, approx)


@pytest.mark.gpu
@pytest.mark.parametrize("approx", [False, True])
def test_gpu_knn_integer_points_match_plain_exactly(cuda, approx):
    X = _integer_points(5000, 8, seed=11)
    got = tk.knn(X, 20, approx=approx, device=cuda)
    ref = tk.knn(X, 20, approx=approx, device=CPU)
    torch.testing.assert_close(got[0].cpu(), ref[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1].cpu(), ref[1], rtol=0, atol=0)


@pytest.mark.gpu
def test_gpu_knn_duplicates_and_small_n(cuda):
    X = _gaussian(200, 9, seed=12)
    X[150] = X[3]
    gi, gd = (t.cpu().numpy() for t in tk.knn(X, 7, device=cuda))
    assert gi[3, 0] == 3 and gi[3, 1] == 150 and gi[150, 0] == 150 and gi[150, 1] == 3
    gi, gd = tk.knn(X[:5], 10, device=cuda)  # k cut to n - 1
    assert gi.shape == (5, 5)
    assert tk.knn(X[:1], 3, device=cuda)[0].tolist() == [[0]]


@pytest.mark.gpu
def test_gpu_knn_topk_refuses_bad_input(cuda):
    X = torch.randn((300, 4), device=cuda)
    sq = (X * X).sum(1)
    with pytest.raises(ValueError):
        tk.knn_topk(X, sq, 256, False, False)  # list longer than 256
    with pytest.raises(ValueError):
        tk.knn_topk(X.double(), sq, 5, False, False)
    with pytest.raises(ValueError):
        tk.knn_topk(X.T, sq, 5, False, False)
    with pytest.raises(ValueError):
        tk.knn_topk(X, None, 5, False, False)
