"""The port's fuzzy connectivities (muon_tpu_torch/ops/fuzzy.py, T6) held to
the JAX package's (muon_tpu/ops/fuzzy.py).

Tolerances: the tests run JAX with x64 on (tests/conftest.py), and then the
reference's bisection runs in float64 whatever its input (its zeros, ones
and log2(k) become float64), while in production it runs in float32, as
the port does. So σ differs by float32 resolution: rtol 1e-5 on σ and ρ,
atol 1e-6 on the membership values (which lie in (0, 1]).
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax.numpy as jnp
    from muon_tpu.ops import fuzzy as jf
    from muon_tpu.ops import knn as jk
except ImportError:
    jnp = jf = jk = None

from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import fuzzy as tf
from muon_tpu_torch.ops import knn as tk

CPU = torch.device("cpu")


def _knn_table(n=400, d=10, k=15, seed=0):
    """A kNN table as the neighbors path makes it: self in column 0 at 0."""
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    idx, dists = tk.knn(X, k - 1, device=CPU)
    return idx.numpy(), dists.numpy()


def _edge_rows():
    """Rows the interpolation branches of ρ treat apart, unsorted: all
    zeros, one nonzero, two nonzeros, repeated values, and zeros mixed
    into a row in any position."""
    rng = np.random.default_rng(3)
    D = rng.random((40, 9)).astype(np.float32) * 3
    D[0] = 0.0
    D[1] = 0.0
    D[1, 4] = 1.25
    D[2] = 0.0
    D[2, [7, 1]] = [0.5, 2.0]
    D[3] = [0.7, 0.0, 0.7, 0.7, 0.0, 1.1, 0.7, 0.0, 0.2]
    D[4:20, 0] = 0.0
    D[20:30] = np.sort(D[20:30], axis=1)
    return D


def _jax_smooth(D, lc):
    s, r = jf._smooth_knn_fn()(jnp.asarray(D), lc, 1.0)
    v = jf._membership_fn()(jnp.asarray(D), s, r)
    return np.asarray(s), np.asarray(r), np.asarray(v)


def _assert_close_smooth(got, ref):
    s, r, v = (t.numpy() for t in got)
    rs, rr, rv = ref
    assert s.dtype == r.dtype == v.dtype == np.float32
    np.testing.assert_allclose(s, rs, rtol=1e-5)
    np.testing.assert_allclose(r, rr, rtol=1e-5)
    np.testing.assert_allclose(v, rv, rtol=0, atol=1e-6)


@pytest.mark.parametrize("local_connectivity", [1.0, 1.5, 0.5])
def test_smooth_knn_matches_jax(local_connectivity):
    _, D = _knn_table()
    got = tf.smooth_knn(torch.from_numpy(D), local_connectivity)
    _assert_close_smooth(got, _jax_smooth(D, local_connectivity))


@pytest.mark.parametrize("local_connectivity", [1.0, 1.5, 0.5, 2.5, 12.0])
def test_smooth_knn_edge_rows_match_jax(local_connectivity):
    # 2.5 and 12.0: rows with fewer nonzeros than floor(local_connectivity)
    D = _edge_rows()
    got = tf.smooth_knn(torch.from_numpy(D), local_connectivity)
    ref = _jax_smooth(D, local_connectivity)
    _assert_close_smooth(got, ref)
    assert got[1][0] == 0  # no nonzero
    if local_connectivity >= 1:  # one nonzero: the largest nonzero
        assert got[1][1] == 1.25


def test_membership_strengths_matches_jax():
    idx, D = _knn_table(n=120, k=8, seed=2)
    s, r, _ = tf.smooth_knn(torch.from_numpy(D))
    ref = jf.membership_strengths(idx, jnp.asarray(D), jnp.asarray(s.numpy()),
                                  jnp.asarray(r.numpy()))
    got = tf.membership_strengths(idx, D, s, r)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-6)
    assert (got[2][got[0] == got[1]] == 0).all()  # self edges get 0


@pytest.mark.parametrize("mix", [1.0, 0.6])
def test_compute_connectivities_umap_matches_jax(mix):
    # identical structure, values rtol 1e-5 (σ at float32 resolution, above)
    idx, D = _knn_table(seed=5)
    ref = jf.compute_connectivities_umap(idx, D, 400, 15, set_op_mix_ratio=mix)
    got = tf.compute_connectivities_umap(idx, D, 400, 15, set_op_mix_ratio=mix,
                                         device=CPU)
    assert sp.isspmatrix_csr(got) and got.dtype == np.float32
    assert got.has_sorted_indices
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)
    assert abs(got - got.T).max() <= 1e-7
    assert got.diagonal().max() == 0 and got.data.min() > 0 and got.data.max() <= 1


def test_connectivities_take_a_device_tensor():
    idx, D = _knn_table(n=60, k=6, seed=6)
    a = tf.compute_connectivities_umap(idx, torch.from_numpy(D), 60, 6)
    b = tf.compute_connectivities_umap(torch.from_numpy(idx), D, 60, 6, device=CPU)
    assert (a != b).nnz == 0


def test_cpu_smooth_knn_counts_no_launch():
    _kernels.reset_launch_counts()
    tf.smooth_knn(torch.from_numpy(_edge_rows()))
    assert _kernels.launch_counts()["smooth_knn_membership"] == 0


# ---------------------------------------------------------------------------
# on the card: T6 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("local_connectivity", [1.0, 1.5, 0.5, 2.5])
@pytest.mark.parametrize("k", [20, 201])
def test_gpu_smooth_knn_matches_plain(cuda, k, local_connectivity):
    # both in float32, with exp() and sums in another order: σ, ρ rtol 1e-5,
    # values atol 1e-6; on T5's sorted output and on unsorted edge rows
    X = torch.from_numpy(np.random.default_rng(k).normal(size=(3000, 30)).astype(np.float32))
    _, D = tk.knn(X.to(cuda), k - 1)
    for dists in (D, torch.from_numpy(_edge_rows()).to(cuda)):
        _kernels.reset_launch_counts()
        got = tf.smooth_knn(dists, local_connectivity)
        torch.cuda.synchronize()
        assert _kernels.launch_counts()["smooth_knn_membership"] == 1
        ref = tf.smooth_knn_plain(dists, local_connectivity)
        for a, b, tol in zip(got, ref, ((1e-5, 0), (1e-5, 0), (0, 1e-6))):
            torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1])


@pytest.mark.gpu
def test_gpu_smooth_knn_refuses_bad_input(cuda):
    D = torch.rand((10, 4), device=cuda)
    with pytest.raises(ValueError):
        tf.smooth_knn(D.double())
    with pytest.raises(ValueError):
        tf.smooth_knn(D.T)
