"""The port's DSB background fit (muon_tpu_torch.ops.gmm, T21's plain
version on the CPU) held to the JAX package's (muon_tpu.ops.gmm).

Both run in float32, the reference under ``jax.enable_x64(False)``: with x64
on (as the repository's tests set it) its uniforms come out float64 and the
whole EM promotes. The reference pads the cells to a power of two and draws
its uniforms at that size, so the tests draw them at the padded size too and
hand the first rows to the port.

The quantiles are held bit for bit. The fits sum in another order than
XLA's, so an ll can differ by an ulp, which could stop a fit one iteration
apart: each fit's iteration count and the winning fit are held against the
reference's own ``_em_1d`` from the same start (its fori_loop run to every
count up to the port's, which gives the reference's ll after each
iteration and so the iteration where it stops), and the background means to
1e-4 on the cells whose fits ran alike (about 1e-6 is the float32 rounding
of the sums).
"""

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    from muon_tpu.ops import gmm as jg
except ImportError:
    jax = jnp = jg = None

from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import gmm as tg

CPU = torch.device("cpu")
N_ITER, TOL = 100, 1e-3


def scaled_counts(n, d, seed, efficiency=False):
    """DSB's input: log(counts + 10) of cells, standardised by 2,000 empty
    droplets of the same ambient profile (bench.py's recipe: Gamma(2, 2)
    ambient, a third of the proteins with Poisson(30) signal). Integer
    counts make the values take few distinct levels, so rows hold ties;
    ``efficiency`` scales each cell's counts by exp(N(0, 0.3))."""
    rng = np.random.default_rng(seed)
    ambient = rng.gamma(2.0, 2.0, d)
    empty = rng.poisson(ambient, (2000, d)).astype(np.float64)
    cells = rng.poisson(ambient, (n, d)).astype(np.float64)
    cols = rng.choice(d, max(1, d // 3), replace=False)
    cells[:, cols] += rng.poisson(30.0, (n, len(cols)))
    if efficiency:
        cells *= np.exp(rng.normal(0, 0.3, (n, 1)))
    es = np.log(empty + 10)
    return ((np.log(cells + 10) - es.mean(0)) / es.std(0, ddof=1)).astype(np.float32)


def reference_noise(n, d, seed):
    """The reference's uniforms: drawn at its padded cell count, float32,
    the first n rows (2, n, d)."""
    n_pad = max(64, 1 << (n - 1).bit_length())
    with jax.enable_x64(False):
        u = jax.random.uniform(jax.random.PRNGKey(seed), (2, n_pad, d, 1))
    return np.array(u[:, :n, :, 0])


def reference_background_means(X, seed):
    n = X.shape[0]
    n_pad = max(64, 1 << (n - 1).bit_length())
    Xp = np.concatenate([X, np.ones((n_pad - n, X.shape[1]), X.dtype)])
    with jax.enable_x64(False):
        f = jg._background_means_fn(N_ITER, TOL)
        return np.asarray(f(jnp.asarray(Xp), jax.random.PRNGKey(seed)))[:n]


def _ref_fit(tied):
    """The reference's _em_1d over the cells, each run to its own
    iteration budget (a traced fori_loop bound): (means (n, 2), ll (n,))."""
    @jax.jit
    def f(X, R, budget):
        return jax.vmap(lambda x, r, k: jg._em_1d(x, r, tied, k, TOL)[:2])(X, R, budget)
    return f


@pytest.mark.parametrize("d, eff", [(5, False), (25, False), (140, False), (140, True)])
def test_quantiles_match_jax_bit_for_bit(d, eff):
    X = scaled_counts(300, d, seed=d, efficiency=eff)
    with jax.enable_x64(False):
        ref = jax.jit(lambda A: jnp.quantile(A, jnp.asarray([0.25, 0.85]), axis=1).T)(X)
    got = tg.quantiles(torch.from_numpy(X))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("d, eff", [(5, False), (25, False), (140, False), (140, True)])
def test_background_means_match_jax(d, eff):
    # 1000 cells: the 99.9% leave room for one cell whose ll steps across
    # tol an ulp apart (about one cell in a thousand does at these sizes)
    n, seed = 1000, 1
    X = scaled_counts(n, d, seed=10 + d, efficiency=eff)
    u = reference_noise(n, d, seed)
    Xt = torch.from_numpy(X)
    means, tied, iters = tg.background_means_plain(Xt, torch.from_numpy(u), N_ITER, TOL)
    q = tg.quantiles(Xt)
    ll, same_iters = [], np.ones(n, bool)
    with jax.enable_x64(False):
        for f in (0, 1):
            r0, r1 = tg._init_resp(Xt, q, torch.from_numpy(u[f]))
            R = np.stack([r0.numpy(), r1.numpy()], axis=-1)
            fit = _ref_fit(f == 0)
            it = iters[f].numpy()
            # the reference's ll after k iterations, k = 0..the port's most:
            # it stops at the first k where |ll_k - ll_k-1| < tol
            L = np.stack([np.asarray(fit(X, R, np.full(n, k, np.int32))[1])
                          for k in range(int(it.max()) + 1)])
            full = fit(X, R, np.full(n, N_ITER, np.int32))
            steps = np.abs(L[1:] - L[:-1]) < np.float32(TOL)  # step k+1 stops
            first = np.where(steps.any(0), steps.argmax(0) + 1, N_ITER)
            same_iters &= (first == it) | ((it == N_ITER) & ~steps.any(0))
            ll.append(np.asarray(full[1]))
    log_d = np.log(np.float32(d))
    bic = [np.float32(-2.0 * d) * ll[0] + np.float32(4) * log_d,
           np.float32(-2.0 * d) * ll[1] + np.float32(5) * log_d]
    same_winner = tied.numpy() == (bic[0] < bic[1])
    ref = reference_background_means(X, seed)
    alike = same_iters & same_winner
    assert alike.mean() >= 0.999, (same_iters.mean(), same_winner.mean())
    np.testing.assert_allclose(means.numpy()[alike], ref[alike], rtol=0, atol=1e-4)
    assert np.isfinite(means.numpy()).all()
    # the fits converge: not every cell runs the whole budget
    assert (iters.numpy() < N_ITER).mean() > 0.9


def test_background_means_recovery():
    # tests/test_prot.py::TestGMMKernel through the port: the lower
    # component mean tracks each cell's planted background
    rng = np.random.default_rng(0)
    N, D = 60, 50
    bg = rng.uniform(-1.0, 0.5, size=N)
    X = np.empty((N, D), np.float32)
    for i in range(N):
        lo = rng.normal(bg[i], 0.15, size=D)
        hi = rng.normal(bg[i] + 3.0, 0.3, size=D)
        pick = rng.random(D) < 0.6
        X[i] = np.where(pick, lo, hi)
    est = tg.background_means(X, seed=1, device=CPU).numpy()
    assert np.corrcoef(est, bg)[0, 1] > 0.95
    assert np.abs(est - bg).mean() < 0.2
    ref = jg.background_means(X, seed=1)
    assert np.abs(est - ref).max() < 0.05  # other uniforms, the same fits


def test_background_means_takes_the_noise_it_is_given():
    X = scaled_counts(100, 12, seed=3)
    u = reference_noise(100, 12, seed=4)
    got = tg.background_means(X, device=CPU, noise=u)
    ref = tg.background_means_plain(torch.from_numpy(X), torch.from_numpy(u))[0]
    assert torch.equal(got, ref)
    a = tg.draw_init_noise(100, 12, seed=4, device=CPU)
    assert a.shape == (2, 100, 12) and a.dtype == torch.float32
    assert torch.equal(a, tg.draw_init_noise(100, 12, seed=4, device=CPU))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0


def test_cpu_background_means_counts_no_launch():
    _kernels.reset_launch_counts()
    tg.background_means(scaled_counts(50, 7, seed=5), device=CPU)
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card: T21 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n, d", [(3000, 5), (3000, 140), (3000, 300), (3000, 1), (40, 17000)])
def test_gpu_gmm_background_means_matches_plain(cuda, n, d):
    # d = 17000 passes the shared-memory width and takes the scratch tensor.
    # The same float32 steps summed in another order: the winner and the
    # iterations agree on >= 99.9% of cells, and there the means to 1e-4
    X = torch.from_numpy(scaled_counts(n, d, seed=d, efficiency=True)).to(cuda)
    u = tg.draw_init_noise(n, d, seed=d, device=cuda)
    _kernels.reset_launch_counts()
    got = tg.gmm_background_means(X, u)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["gmm_background_means"] == 1
    ref = tg.background_means_plain(X, u)
    alike = (got[1] == ref[1]) & (got[2] == ref[2]).all(0)
    assert alike.float().mean().item() >= 0.999
    assert (got[0] - ref[0])[alike].abs().max().item() <= 1e-4
    assert torch.equal(got[0], tg.gmm_background_means(X, u)[0])  # no atomics


@pytest.mark.gpu
def test_gpu_gmm_background_means_refuses_bad_input(cuda):
    X = torch.rand((10, 4), device=cuda)
    u = torch.rand((2, 10, 4), device=cuda)
    with pytest.raises(ValueError):
        tg.gmm_background_means(X.double(), u)
    with pytest.raises(ValueError):
        tg.gmm_background_means(X, u[:, :5])
    with pytest.raises(ValueError):
        tg.gmm_background_means(X.T, u)
    with pytest.raises(ValueError):
        tg.gmm_background_means(X, u.cpu())
