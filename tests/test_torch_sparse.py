"""The port's sparse layer (muon_tpu_torch/ops/sparse.py) held to the JAX
package's (muon_tpu/ops/sparse.py) on the same inputs.

On the CPU each kernel wrapper runs its plain PyTorch version; the tests
marked ``gpu`` compare the CUDA kernels with those plain versions on the
card and skip without one.
"""

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax.numpy as jnp
    from muon_tpu.ops import sparse as jsp
except ImportError:
    jnp = jsp = None

from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import sparse as tsp
from muon_tpu_torch.ops.device import check_matmul_precision, dense_to_tensor, resolve_device

CPU = torch.device("cpu")


def _counts(seed=0, n=60, d=40, density=0.15):
    """Small ATAC-like count matrix (float32 CSR, sorted indices)."""
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=density, random_state=rng, format="csr",
                  dtype=np.float32)
    X.data = rng.integers(1, 5, X.nnz).astype(np.float32)
    return X


def _edge_counts():
    """Counts with an empty row, a row of explicit zeros only, a column of
    explicit zeros only and an empty column."""
    rng = np.random.default_rng(1)
    n, d = 30, 12
    M = (rng.random((n, d)) < 0.3) * rng.integers(1, 6, (n, d))
    M[3] = 0          # empty row
    M[:, 5] = 0       # empty column
    M[:, 7] = 0       # stored zeros only (below)
    M[4] = 0          # stored zeros only (below)
    stored = M != 0
    stored[::4, 7] = True
    stored[4, [0, 2]] = True
    indptr = np.concatenate([[0], np.cumsum(stored.sum(1))])
    indices = np.nonzero(stored)[1]
    data = M[stored].astype(np.float32)
    X = sp.csr_matrix((data, indices, indptr), shape=(n, d))
    assert X.nnz == stored.sum() and (X.data == 0).sum() > 0
    return X


def _bf16(a):
    """Round to bfloat16 (ties to even) and return float32 values."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _dense_operand(rows, l, seed, dtype):
    B = np.random.default_rng(seed).normal(size=(rows, l)).astype(np.float32)
    if dtype == "bf16":
        B = _bf16(B)
        return B, jnp.asarray(B, jnp.bfloat16), torch.from_numpy(B).to(torch.bfloat16)
    return B, jnp.asarray(B), torch.from_numpy(B)


# ---------------------------------------------------------------------------
# T1 tfidf_data
# ---------------------------------------------------------------------------

FLAGS = [  # (log_tf, log_idf, log_tfidf)
    (True, True, False),
    (True, False, False),
    (False, True, False),
    (False, False, False),
    (False, False, True),
]


@pytest.mark.parametrize("scale_factor", [1e4, 1, None])
@pytest.mark.parametrize("flags", FLAGS)
def test_tfidf_data_matches_jax(flags, scale_factor):
    # rtol 1e-5 / atol 1e-6: the f32 row and column sums are taken in
    # another order than the reference's segment sums
    X = _edge_counts()
    log_tf, log_idf, log_tfidf = flags
    kw = dict(log_tf=log_tf, log_idf=log_idf, log_tfidf=log_tfidf,
              scale_factor=scale_factor)
    ref = np.asarray(jsp.tfidf_data(jsp.from_scipy(X), **kw))[: X.nnz]
    out = tsp.tfidf_data(tsp.from_scipy(X, CPU), **kw).numpy()
    assert out.dtype == np.float32
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_tfidf_data_zero_rows_and_columns():
    X = _edge_counts()
    out = tsp.tfidf_data(tsp.from_scipy(X, CPU)).numpy()
    res = sp.csr_matrix((out, X.indices, X.indptr), shape=X.shape).toarray()
    assert (res[3] == 0).all() and (res[4] == 0).all()
    assert (res[:, 5] == 0).all() and (res[:, 7] == 0).all()
    assert (res[X.toarray() > 0] > 0).all()


# ---------------------------------------------------------------------------
# T2 spmm / T3 spmm_t
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmm_matches_jax(dtype):
    # error <= 1e-5 x sum_j |x_ij b_jc|: f32 sums in another order
    X = _counts(seed=2)
    B, Bj, Bt = _dense_operand(X.shape[1], 9, 3, dtype)
    ref = np.asarray(jsp.spmm(jsp.from_scipy(X), Bj))
    out = tsp.spmm(tsp.from_scipy(X, CPU), Bt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (X.shape[0], 9)
    bound = 1e-5 * (abs(X) @ np.abs(B))
    assert (np.abs(out.numpy() - ref) <= bound).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_spmm_t_matches_jax(dtype):
    # same bound as spmm, over the columns of X
    X = _counts(seed=4)
    B, Bj, Bt = _dense_operand(X.shape[0], 7, 5, dtype)
    ref = np.asarray(jsp.spmm_t(jsp.from_scipy(X), Bj))
    out = tsp.spmm_t(tsp.from_scipy(X, CPU), Bt)
    assert out.dtype == torch.float32 and tuple(out.shape) == (X.shape[1], 7)
    bound = 1e-5 * (abs(X).T @ np.abs(B))
    assert (np.abs(out.numpy() - ref) <= bound).all()


def test_spmm_duplicate_entries_are_summed():
    # a CSR may store one position twice; both products count it twice
    X = sp.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32), np.array([1, 1, 0]),
         np.array([0, 2, 3])), shape=(2, 3),
    )
    B = np.arange(6, dtype=np.float32).reshape(3, 2)
    dX = tsp.from_scipy(X, CPU)
    np.testing.assert_array_equal(tsp.spmm(dX, torch.from_numpy(B)).numpy(),
                                  X.toarray() @ B)
    Bt = np.arange(4, dtype=np.float32).reshape(2, 2)
    np.testing.assert_array_equal(tsp.spmm_t(dX, torch.from_numpy(Bt)).numpy(),
                                  X.toarray().T @ Bt)


# ---------------------------------------------------------------------------
# T4 gram_matmul
# ---------------------------------------------------------------------------


def _gram_reference(X, V):
    """f64 XᵀX·V with the reference's bf16 rounding points: X and V in
    bf16, z = X·V rounded to bf16."""
    Xb = X.copy()
    Xb.data = _bf16(X.data).astype(np.float64)
    z = Xb @ _bf16(V).astype(np.float64)
    return Xb.T @ _bf16(z).astype(np.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_gram_matmul_matches_f64(seed):
    # relative Frobenius error <= 1e-4: an element of z can round to the
    # neighbouring bf16 value when its f32 and f64 sums straddle a rounding
    # boundary. This reads about 2e-8; without the bf16 rounding of z it
    # reads 7e-4, and without that of x_ij 1e-3 or more
    X = _counts(seed=seed, n=80, d=50, density=0.2)
    X.data = X.data * np.float32(0.37)  # values that bf16 does not hold exactly
    V = np.random.default_rng(seed + 10).normal(size=(50, 11)).astype(np.float32)
    out = tsp.gram_matmul(tsp.from_scipy(X, CPU), torch.from_numpy(V)).numpy()
    ref = _gram_reference(X, V)
    assert np.linalg.norm(out - ref) <= 1e-4 * np.linalg.norm(ref)


def test_gram_matmul_is_spmm_t_of_spmm_in_f32():
    # with values bf16 holds exactly, T4 is Xᵀ(bf16(X·V)) of the two products
    X = _counts(seed=6)
    V = _bf16(np.random.default_rng(7).normal(size=(X.shape[1], 5)))
    dX = tsp.from_scipy(X, CPU)
    z = tsp.spmm(dX, torch.from_numpy(V)).to(torch.bfloat16)
    np.testing.assert_allclose(
        tsp.gram_matmul(dX, torch.from_numpy(V)).numpy(),
        tsp.spmm_t(dX, z).numpy(), rtol=1e-6, atol=1e-6,
    )


# ---------------------------------------------------------------------------
# T7 row_sums / T8 scale_rows_data (the RNA library-size normalisation)
# ---------------------------------------------------------------------------


def test_row_sums_matches_jax():
    # rtol 1e-6: the same float32 values summed in another order; the
    # empty row and the row of stored zeros sum to 0
    X = _edge_counts()
    ref = np.asarray(jsp.row_sums(jsp.from_scipy(X)))
    out = tsp.row_sums(tsp.from_scipy(X, CPU)).numpy()
    assert out.dtype == np.float32 and out.shape == (X.shape[0],)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    assert out[3] == 0 and out[4] == 0


def test_scale_rows_data_matches_jax():
    # one float32 product per value: exact
    X = _edge_counts()
    s = np.random.default_rng(2).random(X.shape[0]).astype(np.float32)
    ref = np.asarray(jsp.scale_rows_data(jsp.from_scipy(X), jnp.asarray(s)))[: X.nnz]
    out = tsp.scale_rows_data(tsp.from_scipy(X, CPU), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_library_size_normalisation_matches_jax():
    # the e2e's RNA step: inv = 1e4 / max(rs, 1), log1p(scale_rows_data)
    X = _counts(seed=14, n=50, d=30)
    dj = jsp.from_scipy(X)
    inv_j = 1e4 / jnp.maximum(jsp.row_sums(dj), 1.0)
    ref = np.asarray(jnp.log1p(jsp.scale_rows_data(dj, inv_j)))[: X.nnz]
    dX = tsp.from_scipy(X, CPU)
    inv = 1e4 / torch.clamp(tsp.row_sums(dX), min=1.0)
    out = torch.log1p(tsp.scale_rows_data(dX, inv)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6)


# ---------------------------------------------------------------------------
# DeviceCSR construction
# ---------------------------------------------------------------------------


def _to_scipy(dX):
    return sp.csr_matrix(
        (dX.data.numpy(), dX.indices.numpy(), dX.indptr.numpy()), shape=dX.shape
    )


def test_from_device_coo_carries_jax_state():
    X = _counts(seed=8)
    X.data = np.random.default_rng(8).random(X.nnz).astype(np.float32)
    dX = jsp.from_scipy(X)
    assert dX.data.shape[0] > dX.nnz  # the pad tail is there to drop
    out = tsp.from_device_coo(
        np.asarray(dX.data), np.asarray(dX.row), np.asarray(dX.col),
        dX.n_rows, dX.n_cols, dX.nnz, CPU,
    )
    assert (out.n_rows, out.n_cols, out.nnz) == (dX.n_rows, dX.n_cols, dX.nnz)
    assert out.data.dtype == torch.float32 and out.indptr.dtype == torch.int32
    np.testing.assert_array_equal(_to_scipy(out).toarray(), X.toarray())


def test_from_device_coo_rejects_what_is_not_row_sorted_coo():
    X = _counts(seed=9).tocoo()
    p = np.random.default_rng(9).permutation(X.nnz)
    with pytest.raises(ValueError, match="sorted"):
        tsp.from_device_coo(X.data[p], X.row[p], X.col[p], *X.shape, X.nnz, CPU)
    with pytest.raises(ValueError, match="outside"):
        tsp.from_device_coo(np.ones(2), np.array([0, 3]), np.array([0, 0]),
                            3, 2, 2, CPU)


def test_from_scipy_leaves_caller_matrix_alone():
    X = _counts(seed=10)
    for r in range(X.shape[0]):  # reverse the indices within every row
        s, e = X.indptr[r], X.indptr[r + 1]
        X.indices[s:e] = X.indices[s:e][::-1].copy()
        X.data[s:e] = X.data[s:e][::-1].copy()
    X.has_sorted_indices = False
    indices = X.indices.copy()
    dX = tsp.from_scipy(X, CPU)
    np.testing.assert_array_equal(X.indices, indices)
    assert not X.has_sorted_indices
    B = np.random.default_rng(11).normal(size=(X.shape[1], 4)).astype(np.float32)
    np.testing.assert_allclose(tsp.spmm(dX, torch.from_numpy(B)).numpy(),
                               X.toarray() @ B, rtol=1e-5, atol=1e-5)


def test_from_scipy_types_and_shape():
    X = _counts(seed=12).astype(np.float64).tocoo()
    dX = tsp.from_scipy(X, CPU)
    assert dX.shape == X.shape and dX.nnz == X.nnz and dX.device == CPU
    assert dX.data.dtype == torch.float32
    assert dX.indptr.dtype == dX.indices.dtype == torch.int32


def test_to_scipy_data_copies_structure():
    X = _counts(seed=13)
    new = torch.arange(X.nnz, dtype=torch.float32)
    out = tsp.to_scipy_data(X, new)
    assert out is not X and out.indices is not X.indices
    np.testing.assert_array_equal(out.indptr, X.indptr)
    np.testing.assert_array_equal(out.data, np.arange(X.nnz, dtype=np.float32))


# ---------------------------------------------------------------------------
# devices, wrappers and the kernel build (no card needed)
# ---------------------------------------------------------------------------


def test_resolve_device():
    # None and "auto" mean the card; the CPU only when asked for by name
    assert resolve_device("cpu") == CPU
    if torch.cuda.is_available():
        assert resolve_device("auto").type == "cuda"
        assert resolve_device(None) == resolve_device("auto")
        assert resolve_device("cuda").type == "cuda"
    else:
        for dev in ("auto", None, "cuda"):
            with pytest.raises(RuntimeError):
                resolve_device(dev)
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_default_device_without_a_card_raises_and_names_the_cpu(monkeypatch):
    # the default never falls back to the CPU: without a card it raises and
    # says how to ask for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        dense_to_tensor(np.zeros((2, 2)))
    assert dense_to_tensor(np.zeros((2, 2)), "cpu").device == CPU


def test_tf32_is_refused():
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError):
            check_matmul_precision()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    check_matmul_precision()


def test_wrappers_refuse_mixed_devices():
    dX = tsp.from_scipy(_counts(), CPU)
    with pytest.raises(ValueError):
        tsp.spmm(dX, torch.empty((dX.n_cols, 3), device="meta"))
    with pytest.raises(ValueError):
        tsp.tfidf_data(dX._replace(data=dX.data.to("meta")))


def test_cpu_wrappers_count_no_launch():
    _kernels.reset_launch_counts()
    dX = tsp.from_scipy(_counts(), CPU)
    V = torch.ones((dX.n_cols, 3))
    tsp.tfidf_data(dX)
    tsp.spmm(dX, V)
    tsp.spmm_t(dX, torch.ones((dX.n_rows, 3)))
    tsp.gram_matmul(dX, V)
    tsp.scale_rows_data(dX, tsp.row_sums(dX))
    counts = _kernels.launch_counts()
    assert set(counts) == set(_kernels.KERNELS)
    assert not any(counts.values())


def _source_copy(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for cu in _kernels.CSRC.glob("*.cu*"):  # the sources and their shared headers
        (src / cu.name).write_bytes(cu.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", src)
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    return src / "sparse_kernels.cu"


def test_library_name_follows_the_sources(tmp_path, monkeypatch):
    first = _kernels.library_path()
    cu = _source_copy(tmp_path, monkeypatch)
    assert _kernels.library_path().name == first.name
    cu.write_text(cu.read_text() + "\n// edited\n")
    edited = _kernels.library_path().name
    assert edited != first.name
    header = cu.with_name("topk_heap.cuh")  # a shared header counts as a source
    header.write_text(header.read_text() + "\n// edited\n")
    assert _kernels.library_path().name not in (first.name, edited)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    _source_copy(tmp_path, monkeypatch)
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _kernels.build()
    assert not list((tmp_path / "_build").glob("*.so"))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _skewed_counts(n=3000, d=700, per_row=40, seed=0):
    """make_counts of chip_smoke.py at a small size: Pareto column skew."""
    rng = np.random.default_rng(seed)
    pop = rng.pareto(1.2, d) + 1.0
    cols = rng.choice(d, size=n * per_row, p=pop / pop.sum())
    rows = np.repeat(np.arange(n), per_row)
    data = rng.integers(1, 5, size=n * per_row).astype(np.float32)
    X = sp.coo_matrix((data, (rows, cols)), shape=(n, d))
    X.sum_duplicates()
    return X.tocsr()


@pytest.mark.gpu
@pytest.mark.parametrize("scale_factor", [1e4, None])
@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("make", [_skewed_counts, _edge_counts])
def test_gpu_tfidf_values(cuda, make, flags, scale_factor):
    dX = tsp.from_scipy(make(), cuda)
    kw = dict(zip(("log_tf", "log_idf", "log_tfidf"), flags), scale_factor=scale_factor)
    out = tsp.tfidf_data(dX, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tsp.tfidf_data_plain(dX, **kw), rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [60, 150])
def test_gpu_csr_spmm(cuda, dtype, l):
    dX = tsp.from_scipy(_skewed_counts(), cuda)
    B = torch.randn((dX.n_cols, l), device=cuda).to(dtype)
    out = tsp.spmm(dX, B)
    torch.cuda.synchronize()
    bound = 1e-5 * tsp.spmm_plain(dX._replace(data=dX.data.abs()), B.float().abs())
    assert ((out - tsp.spmm_plain(dX, B)).abs() <= bound).all()


def _long_rows(seed=0):
    """Rows of 0, 1, 255, 256, 257, 513, 5,000 and 40,000 stored entries over
    50,000 columns, and the Pareto-popular columns of _skewed_counts as rows."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 255, 256, 257, 513, 5000, 40000]
    rows = np.repeat(np.arange(len(lens)), lens)
    cols = np.concatenate([rng.choice(50_000, n, replace=False) for n in lens])
    data = rng.random(rows.size).astype(np.float32) + 0.5
    A = sp.csr_matrix((data, (rows, cols)), shape=(len(lens), 50_000))
    B = _skewed_counts(n=50_000, d=700).T.tocsr()
    return sp.vstack([A, B[:, :50_000]]).tocsr()


def test_spmm_split_plain_is_the_float64_product():
    X = _long_rows()
    B = np.random.default_rng(1).normal(size=(X.shape[1], 7)).astype(np.float32)
    got = tsp.spmm_split(tsp.from_scipy(X, "cpu"), torch.from_numpy(B))
    want = X.astype(np.float64) @ B.astype(np.float64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 30, 150])
def test_gpu_csr_spmm_split(cuda, l):
    # against the float64 product within 1e-5 x |X|.|B|; bit for bit from
    # run to run, and on rows of at most 256 entries bit for bit T2's sum
    X = _long_rows()
    dX = tsp.from_scipy(X, cuda)
    B = torch.randn((dX.n_cols, l), device=cuda)
    _kernels.reset_launch_counts()
    out = tsp.spmm_split(dX, B)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["csr_spmm_split"] == 1
    bound = 1e-5 * tsp.spmm_split_plain(dX._replace(data=dX.data.abs()), B.abs())
    assert ((out - tsp.spmm_split_plain(dX, B)).abs() <= bound).all()
    assert torch.equal(tsp.spmm_split(dX, B), out)
    short = torch.from_numpy(np.diff(X.indptr) <= 256).to(cuda)
    assert torch.equal(out[short], tsp.spmm(dX, B)[short])
    assert bool((out[0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [60, 150])
def test_gpu_csr_spmm_t(cuda, dtype, l):
    dX = tsp.from_scipy(_skewed_counts(), cuda)
    B = torch.randn((dX.n_rows, l), device=cuda).to(dtype)
    out = tsp.spmm_t(dX, B)
    torch.cuda.synchronize()
    bound = 1e-5 * tsp.spmm_t_plain(dX._replace(data=dX.data.abs()), B.float().abs())
    assert ((out - tsp.spmm_t_plain(dX, B)).abs() <= bound).all()


@pytest.mark.gpu
@pytest.mark.parametrize("l", [60, 150])
def test_gpu_csr_gram_matmul(cuda, l):
    # relative Frobenius error <= 1e-4, as chip_smoke.py, on the TF-IDF
    # values the path feeds T4: the atomics' order moves it by about 1e-6,
    # while dropping the bf16 rounding of z reads 5e-4 here
    dX = tsp.from_scipy(_skewed_counts(), cuda)
    dX = dX._replace(data=tsp.tfidf_data_plain(dX))
    V = torch.randn((dX.n_cols, l), device=cuda)
    out = tsp.gram_matmul(dX, V)
    torch.cuda.synchronize()
    ref = tsp.gram_matmul_plain(dX, V)
    assert torch.linalg.norm(out - ref) <= 1e-4 * torch.linalg.norm(ref)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_skewed_counts, _edge_counts])
def test_gpu_csr_row_sums_and_scale_rows(cuda, make):
    # row sums rtol 1e-6 (another order); the scaling is one exact product
    dX = tsp.from_scipy(make(), cuda)
    _kernels.reset_launch_counts()
    rs = tsp.row_sums(dX)
    out = tsp.scale_rows_data(dX, 1e4 / torch.clamp(rs, min=1.0))
    torch.cuda.synchronize()
    counts = _kernels.launch_counts()
    assert counts["csr_row_sums"] == 1 and counts["csr_scale_rows"] == 1
    torch.testing.assert_close(rs, tsp.row_sums_plain(dX), rtol=1e-6, atol=0)
    inv = 1e4 / torch.clamp(rs, min=1.0)
    torch.testing.assert_close(out, tsp.scale_rows_data_plain(dX, inv), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tsp.scale_rows_data(dX, inv[:-1])
    with pytest.raises(TypeError):
        tsp.scale_rows_data(dX, inv.double())


@pytest.mark.gpu
def test_gpu_wrappers_count_launches_and_check_inputs(cuda):
    dX = tsp.from_scipy(_skewed_counts(n=100, d=50), cuda)
    current = torch.cuda.current_device()
    _kernels.reset_launch_counts()
    tsp.spmm(dX, torch.ones((dX.n_cols, 4), device=cuda))
    assert _kernels.launch_counts()["csr_spmm_f32"] == 1
    assert torch.cuda.current_device() == current
    with pytest.raises(TypeError):
        tsp.spmm(dX, torch.ones((dX.n_cols, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        tsp.spmm(dX, torch.ones((4, dX.n_cols), device=cuda).T)
    with pytest.raises(ValueError):
        tsp.spmm_t(dX, torch.ones((dX.n_cols, 4), device=cuda))
    assert _kernels.launch_counts()["csr_spmm_f32"] == 1
