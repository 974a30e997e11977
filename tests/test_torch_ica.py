"""The port's FastICA (muon_tpu_torch.ops.ica, T32's plain version on the
CPU, and tl.ica) held to the JAX package's (muon_tpu.ops.ica._fastica_fn,
muon_tpu.tl.ica) on the same inputs, and T32 against its plain version on
the card.

Both packages whiten on the host with the same numpy code and draw the same
W0 from ``np.random.default_rng(random_state)``, so they start from the same
point. The reference's sweeps run in float32 (``jax.enable_x64(False)``, as
in production): the port differs by the order of its float32 sums and by
its eigensolver's rounding, about 1e-6 after a sweep. FastICA's fixed point
attracts, so after the full 200 sweeps the sources agree to 1e-4 (relative
to their unit scale) where the data have independent sources to find.
"""

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    import muon_tpu as mu
    from muon_tpu.ops import ica as jica
except ImportError:
    jax = jnp = mu = jica = None

import muon_tpu_torch as mt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import ica as tica

CPU = torch.device("cpu")


class Holder:
    def __init__(self, X):
        self.X, self.obsm = X, {}

    def copy(self):
        h = Holder(self.X.copy())
        h.obsm = {k: v.copy() for k, v in self.obsm.items()}
        return h


def _fixture_ica():
    """The reference's own fixture (tests/test_tools_graph.py TestICA): a
    square wave and a Laplace source mixed into 6 columns, 500 cells."""
    rng = np.random.default_rng(0)
    S = np.column_stack([np.sign(np.sin(np.arange(500) / 5.0)), rng.laplace(size=500)])
    A = rng.normal(size=(2, 6))
    return (S @ A).astype(np.float32), S


def _laplace_mixture(n=2000, d=10, seed=1):
    rng = np.random.default_rng(seed)
    S = rng.laplace(size=(n, d))
    A = rng.normal(size=(d, d))
    return (S @ A).astype(np.float32), S


def _whitened(X, k, random_state):
    """The host part both packages share (muon_tpu/ops/ica.py:56-67)."""
    n = X.shape[0]
    Xc = (X - X.mean(axis=0)).T
    U, s, _ = np.linalg.svd(Xc @ Xc.T / n)
    Kw = (U[:, :k] / np.sqrt(np.maximum(s[:k], 1e-12))[None, :]).T
    W0 = np.random.default_rng(random_state).normal(size=(k, k)).astype(np.float32)
    return (Kw @ Xc).astype(np.float32), W0


@pytest.mark.parametrize("n_iter", [0, 1, 3])
def test_sweeps_match_jax(n_iter):
    # sym_decorrelate(W0), then n_iter sweeps of contrast + decorrelation,
    # from the same whitened data and W0. The early sweeps amplify float32
    # rounding (3e-6 after the decorrelation, 1.5e-5 after 3 sweeps here):
    # within 5e-5 of the unit-norm rows
    X, _ = _laplace_mixture(n=1500, d=8, seed=3)
    Xw, W0 = _whitened(X, 8, 5)
    with jax.enable_x64(False):
        ref = np.asarray(jica._fastica_fn()(jnp.asarray(Xw), jnp.asarray(W0), n_iter))
    W = tica.sym_decorrelate(torch.from_numpy(W0))
    Xw_t = torch.from_numpy(Xw)
    for _ in range(n_iter):
        W = tica.sym_decorrelate(tica.ica_contrast(Xw_t, W))
    np.testing.assert_allclose(W.numpy(), ref, rtol=0, atol=5e-5)


def test_contrast_is_the_reference_body():
    # the body of _fastica_fn before its decorrelation, written as the
    # reference writes it, in float32: rtol 1e-5 (the sums' order)
    X, _ = _laplace_mixture(n=1000, d=6, seed=4)
    Xw, W0 = _whitened(X, 6, 0)
    with jax.enable_x64(False):
        WX = jnp.asarray(W0) @ jnp.asarray(Xw)
        g = jnp.tanh(WX)
        ref = np.asarray((g @ jnp.asarray(Xw).T) / Xw.shape[1]
                         - (1.0 - g * g).mean(axis=1)[:, None] * jnp.asarray(W0))
    got = tica.ica_contrast(torch.from_numpy(Xw), torch.from_numpy(W0))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["fixture", "laplace"])
def test_tl_ica_matches_jax(case):
    X, S = _fixture_ica() if case == "fixture" else _laplace_mixture()
    k = 2 if case == "fixture" else None
    ref_h = mu.AnnData(X.copy())
    ref_h.obsm["X_pca"] = X.copy()
    with jax.enable_x64(False):
        mu.tl.ica(ref_h, basis="X_pca", n_components=k, random_state=0)
    ref = ref_h.obsm["X_ica"]
    h = Holder(X.copy())
    h.obsm["X_pca"] = X.copy()
    mt.tl.ica(h, basis="X_pca", n_components=k, random_state=0, device=CPU)
    got = h.obsm["X_ica"]
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    # and the planted sources are found (the reference test's bar)
    cors = np.abs(np.corrcoef(S.T, got.T)[:S.shape[1], S.shape[1]:])
    assert cors.max(axis=1).min() > 0.9


def test_tl_ica_scale_and_copy():
    X, _ = _fixture_ica()
    h = Holder(X.copy())
    h.obsm["X_pca"] = X.copy()
    out = mt.tl.ica(h, n_components=2, random_state=0, scale=True, copy=True, device=CPU)
    assert "X_ica" not in h.obsm and out.obsm["X_ica"].shape == (500, 2)
    np.testing.assert_allclose(out.obsm["X_ica"].std(axis=0), 1.0, rtol=1e-5)
    plain = Holder(X.copy())
    plain.obsm["X_pca"] = X.copy()
    mt.tl.ica(plain, n_components=2, random_state=0, device=CPU)
    np.testing.assert_allclose(out.obsm["X_ica"],
                               plain.obsm["X_ica"] / plain.obsm["X_ica"].std(axis=0))


def test_cpu_ica_counts_no_launch():
    X, _ = _fixture_ica()
    _kernels.reset_launch_counts()
    tica.fastica(X, n_components=2, random_state=0, max_iter=3, device=CPU)
    assert not any(_kernels.launch_counts().values())


def test_chunks_cover_the_columns():
    # T32's split: chunks of whole 32-column steps that cover n once
    for k, n in [(1, 1), (2, 500), (50, 100_000), (70, 777), (300, 40)]:
        chunk, n_chunks = tica._chunks(k, n)
        assert chunk % 32 == 0 and (n_chunks - 1) * chunk < n <= n_chunks * chunk
        assert n_chunks <= 65535


# ---------------------------------------------------------------------------
# on the card: T32 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(50, 100_000), (2, 500), (70, 777), (33, 5000)])
def test_gpu_ica_contrast_matches_plain(cuda, k, n):
    # the sums over n in another order (chunks, lanes, fma). The result is a
    # difference of two terms each at most 1 in size (W's rows unit norm, Xw
    # white, |g| <= 1), and small where they cancel: within 1e-6 absolute
    X, _ = _laplace_mixture(n=n, d=k, seed=k)
    Xw, W0 = _whitened(X, k, 0)
    Xw_t, W = torch.from_numpy(Xw).to(cuda), tica.sym_decorrelate(torch.from_numpy(W0).to(cuda))
    _kernels.reset_launch_counts()
    got = tica.ica_contrast(Xw_t, W)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["ica_contrast"] == 1
    ref = tica.ica_contrast_plain(Xw_t, W)
    assert (got - ref).abs().max().item() <= 1e-6
    again = tica.ica_contrast(Xw_t, W)
    assert torch.equal(got, again)  # no float atomics: bit for bit


@pytest.mark.gpu
def test_gpu_tl_ica_matches_cpu(cuda):
    X, _ = _laplace_mixture()
    h, hc = Holder(X.copy()), Holder(X.copy())
    h.obsm["X_pca"], hc.obsm["X_pca"] = X.copy(), X.copy()
    _kernels.reset_launch_counts()
    mt.tl.ica(h, random_state=0, device=cuda)
    assert _kernels.launch_counts()["ica_contrast"] == 200
    mt.tl.ica(hc, random_state=0, device=CPU)
    np.testing.assert_allclose(h.obsm["X_ica"], hc.obsm["X_ica"], rtol=0, atol=1e-4)
