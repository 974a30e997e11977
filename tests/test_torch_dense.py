"""The port's dense CLR (muon_tpu_torch.ops.dense, T12's plain version on
the CPU) held to the JAX package's (muon_tpu.ops.dense.clr_dense and the
seurat CLR of muon_tpu.prot.pp.clr) on the same inputs, and T12 against its
plain version on the card.

The reference as it runs in production (x64 off) computes in float32, as
the port does: the two are compared in float32 (``jax.enable_x64(False)``),
where they differ by the order of the float32 mean's sum and an ulp of
log1p/exp: rtol 1e-6 on the mean, rtol 1e-5 (atol 1e-6 near zero) on the
values.
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
