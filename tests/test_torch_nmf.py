"""The port's NMF and scOpen (muon_tpu_torch.ops.nmf: T2's and T33's plain
versions on the CPU, and atac.pp.scopen) held to the JAX package's
(muon_tpu.ops.nmf, muon_tpu.atac.pp.scopen) on the same inputs, and T33
against its plain version on the card.

The reference draws its starts with ``jax.random`` inside its jit; the tests
draw them the same way (``_jax_starts``) and hand them to the port as
``W0``/``H0``. The reference runs in float32 (``jax.enable_x64(False)``, as
in production); the port differs by the order of its sums (the products
through X's CSR, summed in float64 by the plain version on the CPU; the
Grams): one iteration within rtol 1e-5, and the multiplicative updates
carry that forward without growth on these fixtures: after 300-800
iterations the factors read 3.5e-6 of their largest entry, W·H 2.5e-7 of
X's, scOpen's outputs 1.1e-6 (the tolerances below are 3-40× that).
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
    from muon_tpu.ops import nmf as jnmf
except ImportError:
    jax = jnp = mu = jnmf = None

import muon_tpu_torch as mt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import nmf as tnmf

CPU = torch.device("cpu")


class Holder:
    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns = X, {}, {}, {}


def _jax_starts(X, k, seed=0):
    """The reference's W and H starts (muon_tpu/ops/nmf.py:33-36), in float32."""
    @jax.jit
    def draw(X, key):
        kw, kh = jax.random.split(key)
        scale = jnp.sqrt(X.mean() / k)
        W = scale * jnp.abs(jax.random.normal(kw, (X.shape[0], k), X.dtype))
        H = scale * jnp.abs(jax.random.normal(kh, (k, X.shape[1]), X.dtype))
        return W, H

    with jax.enable_x64(False):
        W, H = draw(jnp.asarray(X, jnp.float32), jax.random.PRNGKey(seed))
    return np.array(W), np.array(H)


def _low_rank(m=40, n=30, k=3, seed=1):
    """The reference's factorisation fixture (tests/test_scopen.py)."""
    rng = np.random.default_rng(seed)
    return (rng.random((m, k)) @ rng.random((k, n))).astype(np.float32)


def _openness(seed=0, n=80, p=60, k=4):
    """The reference's scOpen fixture (tests/test_scopen.py): binarised
    low-rank openness with 40% of the open entries dropped. Returns the
    observed (cells, peaks) matrix and the truth."""
    rng = np.random.default_rng(seed)
    W = rng.random((n, k)) * (rng.random((n, k)) < 0.5)
    H = rng.random((k, p)) * (rng.random((k, p)) < 0.5)
    truth = (np.clip(W @ H, 0, 1) > 0.4).astype(np.float32)
    observed = truth * (rng.random((n, p)) < 0.6)
    return observed.astype(np.float32), truth


def _scaled_peaks(X, min_rho=0.0, max_rho=0.5):
    """The reference's scOpen input to its NMF (muon_tpu/ops/nmf.py:87-99)."""
    X = np.greater(np.asarray(X).T, 0).astype(np.float32)
    n_open = np.log10(np.maximum(X.sum(axis=0), 1.0))
    hi, lo = n_open.max(), n_open.min()
    denom = (hi - lo) if hi > lo else 1.0
    rho = min_rho + (max_rho - min_rho) * (hi - n_open) / denom
    return X * (1.0 / (1.0 - rho))


@pytest.mark.parametrize("alpha", [0.0, 1.0])
def test_one_iteration_matches_jax(alpha):
    X = _scaled_peaks(_openness()[0])
    W0, H0 = _jax_starts(X, 8)
    with jax.enable_x64(False):
        W_ref, H_ref = jnmf._nmf_fn()(jnp.asarray(X), 8, alpha, 1, jax.random.PRNGKey(0))
    Xc = tnmf._csr_of_dense(torch.from_numpy(X))
    W, Ht = tnmf.nmf_factors(Xc, mt.ops.sparse.transpose(Xc).csr, torch.from_numpy(W0),
                             torch.from_numpy(H0.T.copy()), alpha, 1)
    np.testing.assert_allclose(Ht.numpy().T, np.asarray(H_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(W.numpy(), np.asarray(W_ref), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("left", [True, False])
def test_update_is_the_reference_expression(left):
    # H * WtX / (WtW @ H + alpha * H + eps) (left: H's update, the port's on
    # Hᵀ), and W * XHt / (W @ HHt + alpha * W + eps), as written in the
    # reference's body, in float32: rtol 1e-6 (the Gram's and the k-term
    # product's order)
    rng = np.random.default_rng(7)
    k, n, m = 5, 37, 23
    F = rng.random((k, n) if left else (m, k)).astype(np.float32)
    N = rng.random(F.shape).astype(np.float32)
    O = rng.random((m, k) if left else (k, n)).astype(np.float32)  # W, or H
    with jax.enable_x64(False):
        Fj, Oj = jnp.asarray(F), jnp.asarray(O)
        eps = jnp.asarray(1e-10, jnp.float32)
        prod = (Oj.T @ Oj) @ Fj if left else Fj @ (Oj @ Oj.T)
        ref = np.asarray(Fj * jnp.asarray(N) / (prod + 0.5 * Fj + eps))
    t = (lambda a: torch.from_numpy(a.T.copy())) if left else torch.from_numpy
    got = tnmf.nmf_update(t(F), t(N), torch.from_numpy(O if left else O.T.copy()), 0.5)
    np.testing.assert_allclose(got.numpy().T if left else got.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("alpha,max_iter", [(0.0, 800), (1.0, 300)])
def test_nmf_matches_jax(alpha, max_iter):
    # the reference's fixture: W·H within 1e-5 of X's largest entry, the
    # factors within 1e-5 of their largest
    X = _low_rank()
    W0, H0 = _jax_starts(X, 3)
    with jax.enable_x64(False):
        W_ref, H_ref = jnmf.nmf(X, n_components=3, alpha=alpha, max_iter=max_iter)
    W, H = tnmf.nmf(X, 3, alpha=alpha, max_iter=max_iter, W0=W0, H0=H0, device=CPU)
    assert W.dtype == np.float32 and W.shape == (40, 3) and H.shape == (3, 30)
    np.testing.assert_allclose(W @ H, W_ref @ H_ref, rtol=0, atol=1e-5 * X.max())
    np.testing.assert_allclose(W, W_ref, rtol=0, atol=1e-5 * np.abs(W_ref).max())
    np.testing.assert_allclose(H, H_ref, rtol=0, atol=1e-5 * np.abs(H_ref).max())
    if alpha == 0.0:  # the reference test's own bar
        assert np.linalg.norm(X - W @ H) / np.linalg.norm(X) < 0.05


@pytest.mark.parametrize("form", ["dense", "csr"])
def test_scopen_matches_jax(form):
    observed, _ = _openness()
    W0, H0 = _jax_starts(_scaled_peaks(observed), 8)
    ref = mu.AnnData(observed.copy())
    with jax.enable_x64(False):
        mu.atac.pp.scopen(ref, n_components=8, max_iter=300)
    h = Holder(sp.csr_matrix(observed) if form == "csr" else observed.copy())
    mt.atac.pp.scopen(h, n_components=8, max_iter=300, W0=W0, H0=H0, device=CPU)
    assert set(h.obsm) == {"X_scopen"} and set(h.varm) == {"scopen"} and not h.uns
    for got, want in ((h.obsm["X_scopen"], ref.obsm["X_scopen"]),
                      (h.varm["scopen"], np.asarray(ref.varm["scopen"]))):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    X, X_ref = h.X, np.asarray(ref.X)
    assert isinstance(X, np.ndarray) and X.dtype == np.float32 and X.shape == (80, 60)
    np.testing.assert_allclose(X, X_ref, rtol=0, atol=1e-5)


def test_scopen_own_starts_impute():
    # the port's own starts (torch.Generator, seed 0) pass the reference
    # test's bar: imputed scores on dropped-out open entries exceed those of
    # closed entries by more than 0.05
    observed, truth = _openness()
    h = Holder(observed.copy())
    mt.atac.pp.scopen(h, n_components=8, max_iter=300, device=CPU)
    imputed = h.X
    assert imputed.min() >= 0 and imputed.max() <= 1
    dropped, closed = (truth == 1) & (observed == 0), truth == 0
    assert imputed[dropped].mean() > imputed[closed].mean() + 0.05


def test_scopen_sums_csr_duplicates_then_binarises():
    # todense sums duplicate entries before np.greater: (1, -1) at one place
    # is 0, closed; (1, 1) is open once; a stored 0 is closed. Only the ones
    # are kept, and the caller's matrix is left as it was
    X = sp.csr_matrix((np.array([1.0, -1.0, 1.0, 1.0, 3.0, 0.0], np.float32),
                       np.array([1, 1, 0, 0, 2, 3]), np.array([0, 2, 4, 6])), shape=(3, 4))
    X.has_canonical_format = False
    before = (X.data.copy(), X.indices.copy(), X.indptr.copy())
    want = np.greater(np.asarray(X.todense()), 0).astype(np.float32)
    got = tnmf._binary_cells_by_peaks(X, CPU)
    assert got.nnz == 2 and bool((got.data == 1).all())
    dense = np.zeros(got.shape, np.float32)
    rows = np.repeat(np.arange(3), np.diff(got.indptr.numpy()))
    dense[rows, got.indices.numpy()] = got.data.numpy()
    np.testing.assert_array_equal(dense, want)
    for a, b in zip(before, (X.data, X.indices, X.indptr)):
        np.testing.assert_array_equal(a, b)


def test_transpose_csr_matches_scipy():
    # the entries of each row of Xᵀ keep X's row order (a stable sort)
    rng = np.random.default_rng(3)
    X = sp.random(17, 11, density=0.3, random_state=4, format="csr", dtype=np.float32)
    X.data = rng.random(X.nnz).astype(np.float32) + 0.5
    T = mt.ops.sparse.transpose(mt.ops.sparse.from_scipy(X, CPU)).csr
    want = X.T.tocsr()
    want.sort_indices()
    assert T.shape == (11, 17) and T.nnz == X.nnz
    np.testing.assert_array_equal(T.indptr.numpy(), want.indptr)
    np.testing.assert_array_equal(T.indices.numpy(), want.indices)
    np.testing.assert_array_equal(T.data.numpy(), want.data)


def test_scopen_objective_never_rises():
    # scOpen's NMF driven in chunks of 50 iterations on scopen's own operands
    # and starts: ½‖X − WH‖² + ½α(‖W‖² + ‖H‖²) in float64 at the start and
    # after each chunk never rises by more than 1e-6 relative, and the
    # chunks end where one atac.pp.scopen call of 200 iterations ends, bit
    # for bit (the updates have no state besides W and H)
    observed, _ = _openness()
    X, XT = tnmf.scopen_operands(observed.copy(), device=CPU)
    assert X.shape == (60, 80) and XT.shape == (80, 60)
    W, Ht = tnmf._starts(X, 8, 0, None, None)
    Xd = torch.from_numpy(_scaled_peaks(observed)).double()

    def objective(W, Ht):
        W, H = W.double(), Ht.double().T
        return 0.5 * torch.sum((Xd - W @ H) ** 2).item() + 0.5 * (
            torch.sum(W ** 2).item() + torch.sum(H ** 2).item())

    obj = [objective(W, Ht)]
    for _ in range(4):
        W, Ht = tnmf.nmf_factors(X, XT, W, Ht, 1.0, 50)
        obj.append(objective(W, Ht))
    assert all(b <= a * (1 + 1e-6) for a, b in zip(obj, obj[1:]))
    assert obj[-1] < 0.9 * obj[0]
    h = Holder(observed.copy())
    mt.atac.pp.scopen(h, n_components=8, max_iter=200, device=CPU)
    np.testing.assert_array_equal(h.varm["scopen"], W.numpy())
    np.testing.assert_array_equal(h.obsm["X_scopen"], Ht.numpy())


def test_cpu_nmf_counts_no_launch():
    _kernels.reset_launch_counts()
    tnmf.nmf(_low_rank(), 3, max_iter=3, device=CPU)
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card: T33 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("k,n_vec", [(30, 100_000), (30, 25_000), (7, 333), (70, 1000)])
def test_gpu_nmf_update_matches_plain(cuda, left, k, n_vec):
    # H's update (left: the other factor has fewer rows) or W's (more rows);
    # the Gram in chunk order and the k-term product in another order (fma,
    # ascending), all terms positive: rtol 1e-5. k = 70 takes 5 passes of
    # the Gram's 1024 entries a block
    gen = torch.Generator(device=cuda).manual_seed(k)
    other_rows = n_vec // 4 + 3 if left else 4 * n_vec + 1
    F = torch.rand((n_vec, k), generator=gen, device=cuda)
    N = torch.rand((n_vec, k), generator=gen, device=cuda)
    O = torch.rand((other_rows, k), generator=gen, device=cuda)
    _kernels.reset_launch_counts()
    got = tnmf.nmf_update(F, N, O, 1.0)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["nmf_update"] == 1
    ref = tnmf.nmf_update_plain(F, N, O, 1.0)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(tnmf.nmf_update(F, N, O, 1.0), got, rtol=0, atol=0)


@pytest.mark.gpu
def test_gpu_scopen_matches_cpu(cuda):
    observed, _ = _openness()
    X, _ = tnmf.scopen_operands(observed.copy(), device=CPU)
    W0, Ht0 = tnmf._starts(X, 8, 0, None, None)
    W0, H0 = W0.numpy(), Ht0.numpy().T
    h, hc = Holder(sp.csr_matrix(observed)), Holder(observed.copy())
    _kernels.reset_launch_counts()
    mt.atac.pp.scopen(h, n_components=8, max_iter=300, W0=W0, H0=H0, device=cuda)
    counts = _kernels.launch_counts()
    assert counts["nmf_update"] == 600 and counts["csr_spmm_split"] == 600
    mt.atac.pp.scopen(hc, n_components=8, max_iter=300, W0=W0, H0=H0, device=CPU)
    np.testing.assert_allclose(h.X, hc.X, rtol=0, atol=1e-4)
    np.testing.assert_allclose(h.obsm["X_scopen"], hc.obsm["X_scopen"], rtol=0,
                               atol=1e-4 * np.abs(hc.obsm["X_scopen"]).max())
