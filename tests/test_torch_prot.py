"""The port's protein CLR (muon_tpu_torch.prot.pp.clr) held to the JAX
package's (muon_tpu.prot.pp.clr) on the same input: every case of
tests/test_prot.py::TestCLR, each flavor and axis, dense and sparse.

The port's seurat flavor computes in float32 (T12 for a dense X, T7 and T8
for a sparse one), as the reference does in production; the reference's
tests run it in float64 (x64 on), so the two agree to float32 rounding:
rtol 1e-5 (atol 1e-6 for values near 0). The stoeckius and standard
flavors are float64 in both.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy import sparse as sp
from scipy.stats import gmean

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import muon_tpu as mu
    from muon_tpu import prot as jpt
except ImportError:
    jax = mu = jpt = None

from muon_tpu_torch import prot as tpt
from muon_tpu_torch.ops import _kernels

CPU = torch.device("cpu")


def _X(seed=42):
    """tests/test_prot.py::TestCLR's matrix."""
    return np.random.default_rng(seed).poisson(5.0, size=(40, 15)).astype(np.float64)


def _sparse(X, fmt):
    Xs = X.copy()
    Xs[Xs < 4] = 0  # make it sparse
    return fmt(Xs)


def _both(X, **kw):
    """The reference's and the port's clr on copies of one AnnData."""
    a_j, a_t = mu.AnnData(X.copy()), mu.AnnData(X.copy())
    jpt.pp.clr(a_j, **kw)
    tpt.pp.clr(a_t, device=CPU, **kw)
    return a_j.X, a_t.X


def _dense(x):
    return np.asarray(x.todense()) if sp.issparse(x) else np.asarray(x)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("flavor", ["seurat", "stoeckius", "standard"])
def test_clr_dense_matches_jax(flavor, axis):
    X = _X() + (1.0 if flavor == "standard" else 0.0)  # standard: no zeros
    ref, got = _both(X, axis=axis, flavor=flavor)
    assert got.dtype == np.float64 and got.shape == X.shape
    rtol = 1e-5 if flavor == "seurat" else 1e-12
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-6 if flavor == "seurat" else 0)


@pytest.mark.parametrize("axis", [0, 1])
def test_seurat_dense_matches_manual(axis):
    X = _X()
    _, got = _both(X, axis=axis, flavor="seurat")
    expected = np.log1p(X / np.exp(np.log1p(X).mean(axis=axis, keepdims=True)))
    np.testing.assert_allclose(got, expected, rtol=1e-5)


@pytest.mark.parametrize("axis", [0, 1])
def test_seurat_sparse_matches_jax_and_dense(axis):
    fmt = sp.csc_matrix if axis == 0 else sp.csr_matrix
    Xs = _sparse(_X(), fmt)
    ref, got = _both(Xs, axis=axis, flavor="seurat")
    assert sp.issparse(got) and got.format == ref.format, "seurat flavor must preserve sparsity"
    np.testing.assert_allclose(_dense(got), _dense(ref), rtol=1e-5, atol=1e-6)
    a_de = mu.AnnData(_dense(Xs).copy())
    tpt.pp.clr(a_de, axis=axis, flavor="seurat", device=CPU)
    np.testing.assert_allclose(_dense(got), np.asarray(a_de.X), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis, given, message", [
    (0, sp.csr_matrix, "CSC format required for `axis=0`"),
    (1, sp.csc_matrix, "CSR format required for `axis=1`"),
])
def test_seurat_sparse_converts_with_the_reference_warning(axis, given, message):
    Xs = _sparse(_X(), given)
    with pytest.warns(UserWarning, match=message):
        ref, got = _both(Xs, axis=axis, flavor="seurat")
    assert got.format == ref.format
    np.testing.assert_allclose(_dense(got), _dense(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1])
def test_stoeckius(axis):
    X = _X()
    _, got = _both(X, axis=axis, flavor="stoeckius")
    Xp = X + 1
    expected = np.log(Xp / gmean(Xp, axis=axis, keepdims=True))
    np.testing.assert_allclose(got, expected, rtol=1e-6)


@pytest.mark.parametrize("flavor", ["stoeckius", "standard"])
def test_sparse_input_densifies_for_geometric_flavors(flavor):
    X = _X() + (1.0 if flavor == "standard" else 0.0)
    ref, got = _both(sp.csr_matrix(X), axis=0, flavor=flavor)
    assert not sp.issparse(got)
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_standard():
    X = _X() + 1.0  # avoid zeros
    _, got = _both(X, axis=0, flavor="standard")
    expected = np.log(X / gmean(X, axis=0, keepdims=True))
    np.testing.assert_allclose(got, expected, rtol=1e-6)


def test_seurat_matches_jax_in_float32():
    # the reference as it runs in production (x64 off): both in float32
    X = _X(seed=7).astype(np.float32)
    a_j, a_t = mu.AnnData(X.copy()), mu.AnnData(X.copy())
    with jax.enable_x64(False):
        jpt.pp.clr(a_j)
    tpt.pp.clr(a_t, device=CPU)
    assert a_t.X.dtype == np.float32
    np.testing.assert_allclose(a_t.X, a_j.X, rtol=1e-5, atol=1e-6)


def test_not_inplace():
    X = _X()
    adata = mu.AnnData(X.copy())
    out = tpt.pp.clr(adata, inplace=False, device=CPU)
    assert out is not None
    np.testing.assert_array_equal(np.asarray(adata.X), X)
    ref = jpt.pp.clr(mu.AnnData(X.copy()), inplace=False)
    np.testing.assert_allclose(out.X, ref.X, rtol=1e-5)


def test_bad_flavor_and_axis():
    adata = mu.AnnData(_X())
    with pytest.raises(ValueError, match="Unknown flavor"):
        tpt.pp.clr(adata, flavor="nope", device=CPU)
    with pytest.raises(ValueError, match="Admissible options"):
        tpt.pp.clr(adata, axis=2, device=CPU)


def test_clr_on_a_duck_typed_holder():
    # no container library: anything with .X
    class Holder:
        def __init__(self, X):
            self.X = X

    X = _X()
    h = Holder(X.copy())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tpt.pp.clr(h, device=CPU) is None
    ref, _ = _both(X, axis=0, flavor="seurat")
    np.testing.assert_allclose(h.X, ref, rtol=1e-5, atol=1e-6)


def test_cpu_clr_counts_no_launch():
    _kernels.reset_launch_counts()
    _both(_X(), axis=0, flavor="seurat")
    _both(_sparse(_X(), sp.csc_matrix), axis=0, flavor="seurat")
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Holder:
    def __init__(self, X):
        self.X = X


@pytest.mark.gpu
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("sparse", [False, True])
def test_gpu_clr_matches_cpu(cuda, axis, sparse):
    # the card through T12 (dense) or T7 + T8 (sparse) against the CPU's
    # plain versions: float32 rounding, rtol 1e-5
    rng = np.random.default_rng(3)
    X = rng.poisson(5.0, size=(3000, 120)).astype(np.float32)
    if sparse:
        X = _sparse(X, sp.csc_matrix if axis == 0 else sp.csr_matrix)
    h_c, h_g = _Holder(X.copy()), _Holder(X.copy())
    tpt.pp.clr(h_c, axis=axis, device=CPU)
    _kernels.reset_launch_counts()
    tpt.pp.clr(h_g, axis=axis, device=cuda)
    counts = _kernels.launch_counts()
    if sparse:
        assert counts["csr_row_sums"] == 1 and counts["csr_scale_rows"] == 1
    else:
        assert counts["clr_dense"] == 1
    np.testing.assert_allclose(_dense(h_g.X), _dense(h_c.X), rtol=1e-5, atol=1e-6)
