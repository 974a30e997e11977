"""The port's randomized SVD (muon_tpu_torch/ops/linalg.py) held to the JAX
package's (muon_tpu/ops/linalg.py), with the same test matrix Ω."""

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    from muon_tpu.ops import linalg as jla
except ImportError:
    jax = jnp = jla = None

from muon_tpu_torch.ops import linalg as tla
from muon_tpu_torch.ops import sparse as tsp

CPU = torch.device("cpu")


def _jax_omega(d, l, seed=0):
    """Ω exactly as the reference draws it."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (d, l), jnp.float32))


def _low_rank(seed=7, n=73, d=41):
    """Five spikes with clear gaps over full-rank unit noise.

    The noise floor is what both XᵀX paths need: their CholeskyQR factors
    the Gram of XᵀX·V, whose condition is (σ_1/σ_l)⁴, so an input of rank
    below l (as in tests/test_ops_sparse.py::test_singular_vector_cosine)
    breaks the float32 Cholesky (the reference then returns NaN)."""
    rng = np.random.default_rng(seed)
    U0 = np.linalg.qr(rng.normal(size=(n, 5)))[0]
    V0 = np.linalg.qr(rng.normal(size=(d, 5)))[0]
    spikes = (U0 * np.array([60.0, 50.0, 40.0, 30.0, 25.0])) @ V0.T
    return sp.csr_matrix((spikes + rng.normal(size=(n, d))).astype(np.float32))


def _assert_same_svd(got, ref, k):
    # s within rtol 1e-4; per-column |cos| of U and of Vᵀ >= 1 - 1e-4
    U, s, Vt = (np.asarray(a, np.float64) for a in got)
    Ur, sr, Vtr = (np.asarray(a, np.float64) for a in ref)
    assert U.shape == Ur.shape and Vt.shape == Vtr.shape and s.shape == (k,)
    np.testing.assert_allclose(s, sr, rtol=1e-4)
    for i in range(k):
        for a, b in ((U[:, i], Ur[:, i]), (Vt[i], Vtr[i])):
            c = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
            assert c >= 1 - 1e-4, (i, c)


@pytest.mark.parametrize("shape", [(50, 8), (200, 15)])
def test_cholqr_matches_jax(shape):
    # rtol 1e-5: the same f32 Grams and factors, summed in another order
    Y = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    ref = np.asarray(jla._cholqr(jnp.asarray(Y)))
    out = tla._cholqr(torch.from_numpy(Y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.T @ out, np.eye(shape[1]), atol=1e-5)


@pytest.mark.parametrize("method", ["gather", "blocks"])
def test_randomized_svd_matches_jax(method):
    X = _low_rank()
    k, l = 5, 15
    ref = jla.randomized_svd(X, k=k, n_iter=12, seed=0, method=method)
    got = tla.randomized_svd(X, k=k, n_iter=12, method=method,
                             omega=_jax_omega(X.shape[1], l), device=CPU)
    assert all(t.dtype == torch.float32 for t in got)
    _assert_same_svd(got, ref, k)


@pytest.mark.parametrize("method", ["gather", "blocks"])
def test_randomized_svd_clustered_counts_match_jax(method):
    # sparse planted-cluster counts: a different spectrum from the dense
    # low-rank case, through the same two paths
    rng = np.random.default_rng(5)
    n, d, g = 90, 60, 5
    dense = rng.poisson(0.2, size=(n, d)).astype(np.float32)
    for i in range(g):
        dense[i * 18:(i + 1) * 18, i * 12:(i + 1) * 12] += rng.poisson(3.0, size=(18, 12))
    X = sp.csr_matrix(dense)
    ref = jla.randomized_svd(X, k=4, n_iter=12, seed=3, method=method)
    got = tla.randomized_svd(X, k=4, n_iter=12, method=method,
                             omega=_jax_omega(d, 14, seed=3), device=CPU)
    _assert_same_svd(got, ref, 4)


def test_randomized_svd_symmetric_matches_jax():
    rng = np.random.default_rng(2)
    M = sp.random(60, 60, density=0.1, random_state=rng, dtype=np.float32)
    A = (M + M.T).tocsr()
    A = A + sp.diags(np.linspace(6.0, 1.0, 60).astype(np.float32))  # gaps
    A = A.tocsr().astype(np.float32)
    ref = jla.randomized_svd(A, k=4, n_iter=12, seed=0, symmetric=True)
    got = tla.randomized_svd(A, k=4, n_iter=12, symmetric=True,
                             omega=_jax_omega(60, 14), device=CPU)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4)
    # and the symmetric shortcut equals the general gather path
    full = tla.randomized_svd(A, k=4, n_iter=12, omega=_jax_omega(60, 14),
                              device=CPU)
    np.testing.assert_allclose(got[1].numpy(), full[1].numpy(), rtol=1e-4)


def test_randomized_svd_against_dense_svd():
    X = _low_rank(seed=3)
    U, s, Vt = tla.randomized_svd(X, k=5, n_iter=12, seed=1, device=CPU)
    _, sr, _ = np.linalg.svd(X.toarray().astype(np.float64))
    np.testing.assert_allclose(s.numpy(), sr[:5], rtol=1e-4)
    assert np.all(np.diff(s.numpy()) <= 0)


@pytest.mark.parametrize(
    "n,d,nnz,l",
    [(100_000, 25_000, 22_000_000, 60), (1_000_000, 1_000_000, 40_000_000, 60),
     (1000, 100, 50_000, 60), (45_000, 100, 2_250_000, 15),
     (200_000, 25_000, 2_000_000, 60)],
)
def test_blocks_gate_is_the_reference_rule(n, d, nnz, l):
    assert tla._blocks_profitable(n, d, nnz, l) == jla._blocks_profitable(n, d, nnz, l)


def test_auto_takes_the_gather_path_below_the_gate():
    X = _low_rank()
    om = _jax_omega(X.shape[1], 15)
    auto = tla.randomized_svd(X, k=5, omega=om, device=CPU)
    gather = tla.randomized_svd(X, k=5, omega=om, method="gather", device=CPU)
    for a, b in zip(auto, gather):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_randomized_svd_takes_device_csr_and_draws_from_seed():
    X = _low_rank()
    dX = tsp.from_scipy(X, CPU)
    a = tla.randomized_svd(dX, k=3, seed=4)
    b = tla.randomized_svd(dX, k=3, omega=tla.draw_omega(41, 13, 4, CPU))
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=0)
    c = tla.truncated_svd(dX, k=3, seed=5)
    assert not torch.equal(a[0], c[0])


def test_randomized_svd_refuses_what_it_does_not_take():
    X = _low_rank()
    with pytest.raises(NotImplementedError):
        tla.randomized_svd(X.toarray(), k=3, device=CPU)
    with pytest.raises(ValueError):
        tla.randomized_svd(X, k=3, method="dense", device=CPU)
    with pytest.raises(ValueError):
        tla.randomized_svd(X, k=3, omega=np.zeros((41, 3)), device=CPU)


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["gather", "blocks"])
def test_gpu_randomized_svd_kernels_match_plain(cuda, method):
    # rtol 1e-4 on s, as chip_smoke.py: the same algorithm with atomics
    # summing in another order, which can move a bf16 rounding by one ulp
    X = tsp.from_scipy(_low_rank(), cuda)
    om = tla.draw_omega(41, 15, 0, cuda)
    run = tla._rsvd_blocks if method == "blocks" else tla._rsvd_gather
    _, s, _ = run(X, 5, om, 12, ops=tla.KERNEL_OPS)
    _, sp_, _ = run(X, 5, om, 12, ops=tla.PLAIN_OPS)
    torch.testing.assert_close(s, sp_, rtol=1e-4, atol=0)
