"""The port's dense CLR, TF-IDF and L2 norm (muon_tpu_torch.ops.dense, the
plain versions of T12, T34 and T35 on the CPU) held to the JAX package's
(muon_tpu.ops.dense.clr_dense, tfidf_dense, l2norm_dense and the seurat CLR
of muon_tpu.prot.pp.clr) on the same inputs, and T12, T34 and T35 against
their plain versions on the card.

The reference as it runs in production (x64 off) computes in float32, as
the port does: the two are compared in float32 (``jax.enable_x64(False)``),
where they differ by the order of the float32 mean's sum and an ulp of
log1p/exp: rtol 1e-6 on the mean, rtol 1e-5 (atol 1e-6 near zero) on the
values. The TF-IDF and the L2 norm differ by the sums' order and an ulp of
log1p or sqrt: rtol 1e-5 with an atol of 1e-6 of the largest value.
"""

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import jax.numpy as jnp
    from muon_tpu.ops import dense as jd
except ImportError:
    jax = jnp = jd = None

from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import dense as td

CPU = torch.device("cpu")


def _counts(n=300, d=40, seed=0):
    """Protein-like counts: the e2e's recipe (planted centres clipped at 0,
    plus Poisson(3) background), with some exact zeros."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 4, n)
    cent = rng.normal(size=(4, d)) * 2.0
    X = np.maximum(cent[labels] + rng.normal(size=(n, d)), 0.0) + rng.poisson(3.0, size=(n, d))
    X[rng.random((n, d)) < 0.05] = 0.0
    return X.astype(np.float32)


@pytest.mark.parametrize("axis", [0, 1])
def test_clr_dense_matches_jax(axis):
    X = _counts(seed=axis)
    with jax.enable_x64(False):
        ref = np.asarray(jd.clr_dense(jnp.asarray(X), axis=axis))
        gm_ref = np.asarray(jnp.log1p(jnp.asarray(X)).mean(axis=axis))
    got = td.clr_dense(X, axis=axis, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == X.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    _, gm = td.clr_values(torch.from_numpy(X), axis)
    np.testing.assert_allclose(gm.numpy(), gm_ref, rtol=1e-6)


@pytest.mark.parametrize("axis", [0, 1])
def test_clr_seurat_dense_matches_jax(axis):
    # the inline formula of muon_tpu/prot/preproc.py's dense seurat branch
    X = _counts(seed=5 + axis)
    with jax.enable_x64(False):
        xd = jnp.asarray(X)
        ref = np.asarray(jnp.log1p(xd / jnp.exp(jnp.log1p(xd).mean(axis=axis, keepdims=True))))
    got = td.clr_seurat_dense(X, axis=axis, device=CPU)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_clr_seurat_dense_keeps_the_input_dtype():
    # float32 compute, cast back to the input's dtype, as the reference
    X = _counts(seed=9).astype(np.float64)
    got = td.clr_seurat_dense(X, axis=0, device=CPU)
    assert got.dtype == np.float64
    expected = np.log1p(X / np.exp(np.log1p(X).mean(axis=0, keepdims=True)))
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)


def test_clr_values_division_not_reciprocal():
    # the seurat form divides by exp(gm) as the reference does; the plain
    # version is that expression exactly
    X = torch.from_numpy(_counts(n=50, d=7, seed=3))
    out, gm = td.clr_values_plain(X, 0, seurat=True)
    torch.testing.assert_close(out, torch.log1p(X / torch.exp(gm)[None, :]), rtol=0, atol=0)


def test_clr_values_refuses_bad_axis():
    X = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="axis"):
        td.clr_values(X, 2)
    with pytest.raises(ValueError, match="axis"):
        td.clr_dense(X.numpy(), axis=-1, device=CPU)


def test_cpu_clr_counts_no_launch():
    _kernels.reset_launch_counts()
    td.clr_dense(_counts(n=20, d=5), device=CPU)
    td.clr_seurat_dense(_counts(n=20, d=5), axis=1, device=CPU)
    assert not any(_kernels.launch_counts().values())


def _peaks(n=60, d=40, seed=0):
    """Counts with an all-zero row and an all-zero column planted (0/0 and
    n/0 in the TF-IDF)."""
    rng = np.random.default_rng(seed)
    X = rng.poisson(0.7, size=(n, d)).astype(np.float32)
    X[3] = 0.0
    X[:, 5] = 0.0
    return X


FLAGS = [(tf, idf, tfidf) for tf in (False, True) for idf in (False, True)
         for tfidf in (False, True)]


@pytest.mark.parametrize("scale_factor", [None, 1, 1e4])
@pytest.mark.parametrize("log_tf,log_idf,log_tfidf", FLAGS)
def test_tfidf_dense_matches_jax(log_tf, log_idf, log_tfidf, scale_factor):
    X = _peaks(seed=int(log_tf) + 2 * int(log_idf))
    with jax.enable_x64(False):
        ref = np.asarray(jd.tfidf_dense(jnp.asarray(X), log_tf, log_idf, log_tfidf,
                                        scale_factor))
    got = td.tfidf_dense(X, log_tf, log_idf, log_tfidf, scale_factor, device=CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == X.shape
    assert np.isfinite(got.numpy()).all() and not got[3].any() and not got[:, 5].any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(60, 40), (7, 1300)])
def test_l2norm_dense_matches_jax(shape):
    X = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    X[2] = 0.0  # a zero norm is taken as 1
    with jax.enable_x64(False):
        ref = np.asarray(jd.l2norm_dense(jnp.asarray(X)))
    got = td.l2norm_dense(X, device=CPU)
    assert got.dtype == torch.float32 and not got[2].any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_cpu_tfidf_l2norm_count_no_launch():
    _kernels.reset_launch_counts()
    td.tfidf_dense(_peaks(n=20, d=8), device=CPU)
    td.l2norm_dense(_peaks(n=20, d=8), device=CPU)
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card: T12 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("seurat", [False, True])
@pytest.mark.parametrize("shape", [(5000, 120), (777, 37), (1, 3)])
def test_gpu_clr_values_match_plain(cuda, axis, seurat, shape):
    # the mean sums in another order (tiles and trees against torch's
    # reduction): rtol 1e-6 on it, and the values within 1e-5
    X = torch.from_numpy(_counts(*shape, seed=11)).to(cuda)
    _kernels.reset_launch_counts()
    out, gm = td.clr_values(X, axis, seurat)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["clr_dense"] == 1
    ref, gm_ref = td.clr_values_plain(X, axis, seurat)
    torch.testing.assert_close(gm, gm_ref, rtol=1e-6, atol=0)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_gpu_clr_values_refuse_bad_input(cuda):
    X = torch.zeros((10, 4), device=cuda)
    with pytest.raises(ValueError):
        td.clr_values(X.double(), 0)
    with pytest.raises(ValueError):
        td.clr_values(X.T, 0)
    with pytest.raises(ValueError):
        td.clr_values(X[None], 0)


@pytest.mark.gpu
@pytest.mark.parametrize("scale_factor", [None, 1, 1e4])
@pytest.mark.parametrize("log_tf,log_idf,log_tfidf", FLAGS)
def test_gpu_tfidf_dense_matches_plain(cuda, log_tf, log_idf, log_tfidf, scale_factor):
    # two tiles of rows and of columns, zero rows and columns planted: the
    # sums in another order, rtol 1e-5
    X = torch.from_numpy(_peaks(n=700, d=600, seed=1)).to(cuda)
    X[400:410] = 0.0
    X[:, 300] = 0.0
    _kernels.reset_launch_counts()
    got = td.tfidf_dense(X, log_tf, log_idf, log_tfidf, scale_factor)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["tfidf_dense"] == 1
    ref = td.tfidf_dense_plain(X, log_tf, log_idf, log_tfidf, scale_factor)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5000, 50), (300, 1024), (300, 1025), (64, 25_000), (1, 1)])
def test_gpu_l2norm_dense_matches_plain(cuda, shape):
    # a warp per row up to 1024 columns, a block per row beyond
    gen = torch.Generator(device=cuda).manual_seed(shape[1])
    X = torch.randn(shape, generator=gen, device=cuda)
    X[0] = 0.0
    _kernels.reset_launch_counts()
    got = td.l2norm_dense(X)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["l2norm_dense"] == 1
    torch.testing.assert_close(got, td.l2norm_dense_plain(X), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the ctypes signatures against the C entry points of csrc/*.cu
# ---------------------------------------------------------------------------


def _c_parameters():
    """Each ``int mt_*(...)`` entry point of csrc/*.cu and its parameter
    types, read from the sources."""
    import re

    out = {}
    for src in _kernels._sources():
        for name, params in re.findall(r"\bint (mt_\w+)\(([^)]*)\)\s*\{", src.read_text()):
            out[name] = [" ".join(p.split()) for p in params.split(",")]
    return out


@pytest.mark.parametrize("entry", sorted(_kernels._SIGNATURES))
def test_kernel_signature_matches_the_c_entry_point(entry):
    # a pointer or the stream is c_void_p, an int c_int, a float c_float; a
    # count that disagrees would hand the kernel a shifted argument list
    import ctypes

    params = _c_parameters()[entry]
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float")
             else ctypes.c_longlong if p.startswith(("int64_t", "long long"))
             else ctypes.c_int for p in params]
    assert list(_kernels._SIGNATURES[entry]) == kinds, (entry, params)
