"""The port's backed mode and out-of-core ingest (muon_tpu_torch.ops.sparse
from_backed, DeviceBackedCSR, wire_decode T38, binarize_data T39; the backed
AnnData/MuData, the filters of a backed object, atac.pp.tfidf → atac.tl.lsi
of a backed X) held to the JAX package's.

The backed cases of tests/test_views_backed.py run on the port, each file
written by one package and read by both. ``from_backed`` of both packages
runs over the same h5 file and the same ``.npy`` group (a directory of
memory-mapped arrays behind the h5py group interface, as the card's machine
has no h5py), and the port's CSR is held to the reference's COO, carried
across by ``from_device_coo``, exactly. Only files whose column ids are
sorted within each row go to the reference: it lexsorts a block's entries
and then pairs those values with the file's unsorted ``indices``
(``DeviceBackedCSR.to_memory``, ``_subset``), a fault of its own; the port
keeps the file's order and is held to scipy on such a file.
"""

import zlib

import numpy as np
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import pandas as pd

    import muon_tpu as mu
    from muon_tpu import atac as jac
    from muon_tpu._core.anndata import BackedMatrix as JaxBackedMatrix
    from muon_tpu.ops import sparse as jsp
except ImportError:
    pd = mu = None
from test_torch_atac import _col_cos, _planted_clusters

import muon_tpu_torch as mt
from muon_tpu_torch import atac as tac
from muon_tpu_torch._core.anndata import BackedMatrix, NpyGroup
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import linalg as tla
from muon_tpu_torch.ops import sparse as dsp

CPU = torch.device("cpu")
PKGS = {"port": mt, "jax": mu}
WRITERS = ["port", "jax"]


def _adata(pkg, n=50, d=20, seed=0, sparse=False):
    """tests/test_views_backed.py's _adata, in either package."""
    rng = np.random.default_rng(seed)
    X = rng.poisson(1.0, size=(n, d)).astype(np.float32)
    ad = pkg.AnnData(sp.csr_matrix(X) if sparse else X)
    ad.obs["grp"] = [str(i % 3) for i in range(n)]
    ad.obsm["X_emb"] = rng.normal(size=(n, 5)).astype(np.float32)
    ad.layers["raw"] = (X * 2).copy() if not sparse else sp.csr_matrix(X * 2)
    ad.obsp["conn"] = sp.csr_matrix(
        (np.ones(n), (np.arange(n), (np.arange(n) + 1) % n)), shape=(n, n)
    )
    return ad


def _dense(M):
    return M.toarray() if sp.issparse(M) else np.asarray(M)


# ---------------------------------------------------------------------------
# tests/test_views_backed.py: TestBacked and TestOutOfCore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", WRITERS)
def test_read_h5ad_backed(tmp_path, writer):
    ad = _adata(PKGS[writer], sparse=True)
    p = str(tmp_path / "b.h5ad")
    ad.write(p)
    b, bj = mt.read_h5ad(p, backed=True), mu.read_h5ad(p, backed=True)
    assert b.isbacked and isinstance(b.X, BackedMatrix)
    for rows in (slice(5, 9), np.array([7, 2, 2, 30])):  # a range; unordered, duplicates
        got = b.X[rows]
        assert np.allclose(got.toarray(), ad.X.toarray()[rows])
        assert (got != bj.X[rows]).nnz == 0


@pytest.mark.parametrize("writer", WRITERS)
def test_read_h5ad_backed_dense(tmp_path, writer):
    ad = _adata(PKGS[writer], sparse=False)
    p = str(tmp_path / "bd.h5ad")
    ad.write(p)
    b = mt.read_h5ad(p, backed=True)
    assert isinstance(b.X, BackedMatrix)
    got = b.X[np.array([4, 1, 1]), 3:9]
    assert np.allclose(got, np.asarray(ad.X)[[4, 1, 1], 3:9])
    np.testing.assert_array_equal(got, mu.read_h5ad(p, backed=True).X[np.array([4, 1, 1]), 3:9])


@pytest.mark.parametrize("writer", WRITERS)
def test_backed_view_reads_only_rows(tmp_path, writer):
    ad = _adata(PKGS[writer], sparse=True, n=60)
    p = str(tmp_path / "bv.h5ad")
    ad.write(p)
    v = mt.read_h5ad(p, backed=True)[10:20]
    assert sp.issparse(v.X)  # a materialized subset, not a BackedMatrix
    assert np.allclose(v.X.toarray(), ad.X.toarray()[10:20])


@pytest.mark.parametrize("writer", WRITERS)
def test_read_h5mu_backed(tmp_path, writer):
    W = PKGS[writer]
    md = W.MuData({"m1": _adata(W, seed=1), "m2": _adata(W, seed=2, d=8, sparse=True)})
    p = str(tmp_path / "b.h5mu")
    md.write(p)
    b = mt.read_h5mu(p, backed=True)
    assert b.isbacked
    for mod in b.mod.values():
        assert isinstance(mod.X, BackedMatrix) and mod.isbacked
    # filtering a backed object warns then loads (reference
    # muon/_core/preproc.py:655-668)
    with pytest.warns(UserWarning, match="backed"):
        mt.pp.filter_obs(b.mod["m1"], np.arange(b.mod["m1"].n_obs) < 30)
    assert b.mod["m1"].n_obs == 30 and not b.mod["m1"].isbacked
    # the modalities share the MuData's file: m1 dropping it leaves m2 reading
    np.testing.assert_array_equal(b.mod["m2"].X[0:3].toarray(), md.mod["m2"].X[0:3].toarray())
    b.mod["m2"].file.close()
    assert b.file.is_open
    b.file.close()
    assert not b.file.is_open


@pytest.mark.parametrize("writer", WRITERS)
def test_backed_filter_reads_only_kept_rows(tmp_path, writer, monkeypatch):
    ad = _adata(PKGS[writer], sparse=True, n=80)
    p = str(tmp_path / "f.h5ad")
    ad.write(p)
    b = mt.read_h5ad(p, backed=True)
    to_memory = []
    monkeypatch.setattr(BackedMatrix, "to_memory", lambda self: to_memory.append(1))
    keep = np.zeros(80, bool)
    keep[10:20] = True
    with pytest.warns(UserWarning, match="backed"):
        mt.pp.filter_obs(b, keep)
    assert b.n_obs == 10 and not to_memory  # read row by row, never whole
    assert np.allclose(b.X.toarray(), ad.X.toarray()[10:20])


@pytest.mark.parametrize("writer", WRITERS)
def test_backed_negative_row_indices(tmp_path, writer):
    for sparse in (True, False):
        ad = _adata(PKGS[writer], sparse=sparse, n=40)
        p = str(tmp_path / f"neg_{int(sparse)}.h5ad")
        ad.write(p)
        got = _dense(mt.read_h5ad(p, backed=True).X[np.array([-1, 0, -40])])
        full = _dense(ad.X)
        assert np.allclose(got, full[[-1, 0, 0]])


def test_backed_intersect_obs_warns(tmp_path):
    md = mt.MuData({"m1": _adata(mt, 30, seed=1, sparse=True), "m2": _adata(mt, 30, seed=2)})
    p = str(tmp_path / "i.h5mu")
    md.write(p)
    b = mt.read_h5mu(p, backed=True)
    with pytest.warns(UserWarning, match="backed"):
        mt.pp.intersect_obs(b)
    assert b.n_obs == 30


def test_from_backed_multiblock(tmp_path):
    """Blockwise ingest agrees with from_scipy exactly, with tiny blocks."""
    X = sp.random(57, 23, density=0.3, random_state=1, format="csr")
    X.data = np.ceil(X.data * 9).astype(np.float32)
    bm = BackedMatrix(_h5_group(tmp_path, X))
    d1 = dsp.from_backed(bm, block_nnz=50, device=CPU)
    d2 = dsp.from_scipy(X, CPU)
    assert d1.nnz == d2.nnz == X.nnz
    torch.testing.assert_close(dsp.row_sums(d1), dsp.row_sums(d2), rtol=0, atol=0)
    torch.testing.assert_close(dsp.col_sums(d1), dsp.col_sums(d2), rtol=0, atol=0)
    assert dsp.from_backed(bm, device=CPU) is d1  # the residency tag


# ---------------------------------------------------------------------------
# from_backed of both packages over the same h5 file and .npy group
# ---------------------------------------------------------------------------


def _arrays(X, index_dtype, data_dtype):
    return {"data": X.data.astype(data_dtype), "indices": X.indices.astype(index_dtype),
            "indptr": X.indptr.astype(np.int64)}


def _h5_group(tmp_path, X, index_dtype=np.int64, data_dtype=None):
    import h5py

    f = h5py.File(str(tmp_path / "m.h5"), "w")
    g = f.create_group("X")
    g.attrs["shape"] = np.array(X.shape, np.int64)
    for k, v in _arrays(X, index_dtype, data_dtype or X.data.dtype).items():
        g.create_dataset(k, data=v)
    return g


def _npy_group(tmp_path, X, index_dtype=np.int64, data_dtype=None):
    d = tmp_path / "npy"
    d.mkdir()
    for k, v in _arrays(X, index_dtype, data_dtype or X.data.dtype).items():
        np.save(d / f"{k}.npy", v)
    np.save(d / "shape.npy", np.array(X.shape, np.int64))
    return NpyGroup(str(d))


def _csr(rng, n, d, per_row, values):
    """A CSR with ``per_row`` distinct sorted columns a row (0 for an empty
    row), values from ``values(k)``."""
    rows, cols = [], []
    for i, k in enumerate(per_row):
        rows.append(np.full(k, i))
        cols.append(np.sort(rng.choice(d, size=k, replace=False)))
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return sp.csr_matrix((values(len(rows)), (rows, cols)), shape=(n, d))


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))  # fixed across processes
    counts = lambda top: lambda m: rng.integers(1, top, m).astype(np.float32)  # noqa: E731
    if name == "uint8":
        return _csr(rng, 57, 23, rng.integers(1, 12, 57), counts(255)), 50, np.int64, None
    if name == "uint16":
        return _csr(rng, 40, 30, rng.integers(1, 12, 40), counts(65535)), 60, np.int32, None
    if name == "float32":  # non-integral and negative values, float64 on disk
        X = _csr(rng, 40, 30, rng.integers(1, 12, 40), lambda m: rng.normal(size=m))
        return X, 60, np.int64, np.float64
    if name == "mixed":  # a uint8 block, a uint16 block, a float32 block
        X = _csr(rng, 30, 40, np.full(30, 10), counts(9))
        X.data[100:200] = rng.integers(300, 60000, 100)
        X.data[200:] = rng.normal(size=100)
        return X, 100, np.int64, np.float32
    if name in ("d=32766", "d=32767"):  # int16 columns below the limit, int32 at it
        d = int(name[2:])
        X = _csr(rng, 20, d, rng.integers(1, 40, 20), counts(9))
        X.indices[-1] = d - 1
        return X, 64, np.int64, None
    if name == "block 7":  # many blocks, one row longer than a block
        return _csr(rng, 25, 30, np.r_[rng.integers(1, 6, 12), 20, rng.integers(1, 6, 12)],
                    counts(9)), 7, np.int64, None
    if name == "one block":
        return _csr(rng, 57, 23, rng.integers(1, 12, 57), counts(9)), 1 << 30, np.int64, None
    if name == "empty rows":
        per_row = rng.integers(0, 6, 40)
        per_row[[0, 1, 17, 38, 39]] = 0
        return _csr(rng, 40, 20, per_row, counts(9)), 9, np.int64, None
    if name == "nnz 0":
        return sp.csr_matrix((12, 9), dtype=np.float32), 16, np.int64, None
    raise KeyError(name)


CASES = ["uint8", "uint16", "float32", "mixed", "d=32766", "d=32767", "block 7", "one block",
         "empty rows", "nnz 0"]


@pytest.mark.parametrize("group", ["h5", "npy"])
@pytest.mark.parametrize("case", CASES)
def test_from_backed_matches_jax(tmp_path, case, group):
    X, block_nnz, index_dtype, data_dtype = _case(case)
    make = _h5_group if group == "h5" else _npy_group
    g = make(tmp_path, X, index_dtype, data_dtype)
    got = dsp.from_backed(BackedMatrix(g), block_nnz=block_nnz, device=CPU)
    ref = jsp.from_backed(JaxBackedMatrix(g), pad_multiple=8, block_nnz=block_nnz)
    want = dsp.from_device_coo(np.asarray(ref.data), np.asarray(ref.row), np.asarray(ref.col),
                               *X.shape, ref.nnz, device=CPU)
    assert got.shape == X.shape and got.nnz == X.nnz
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_array_equal(got.data.numpy(), X.data.astype(data_dtype or X.dtype)
                                  .astype(np.float32))


@pytest.mark.parametrize("values,n_cols,want", [
    ([1.0, 254.0], 10, (np.uint8, np.int16)),
    ([0.0, 255.0], 10, (np.uint16, np.int16)),
    ([3.0, 65534.0], 32766, (np.uint16, np.int16)),
    ([3.0, 65535.0], 32767, (np.float32, np.int32)),
    ([1.0, 2.5], 10, (np.float32, np.int16)),
    ([-1.0, 2.0], 10, (np.float32, np.int16)),
    ([1.0, np.nan], 10, (np.float32, np.int16)),
    (np.array([3, 254], np.int64), 10, (np.uint8, np.int16)),
    (np.array([-3, 4], np.int32), 10, (np.float32, np.int16)),
    (np.array([70000], np.int64), 10, (np.float32, np.int16)),
], ids=["u8", "u16 at 255", "u16 below 65535", "f32 at 65535", "fraction", "negative",
        "nan", "int u8", "int negative", "int too large"])
def test_wire_types_follow_the_reference(values, n_cols, want):
    # the reference's narrowing (muon_tpu/ops/sparse.py:337-358), but a
    # negative integer goes as float32 where the reference wraps it to uint8
    got = dsp.wire_types(np.asarray(values, dtype=getattr(values, "dtype", np.float32)), n_cols)
    assert got == tuple(np.dtype(t) for t in want)


def test_from_backed_refuses_what_it_cannot_take(tmp_path):
    dense = BackedMatrix(np.zeros((3, 2), np.float32))
    with pytest.raises(TypeError, match="sparse"):
        dsp.from_backed(dense, device=CPU)

    class Huge:  # an int64 indptr past the int32 range; data is never read
        attrs = {"shape": np.array([2, 3])}
        _d = {"indptr": np.array([0, 1, 2**31], np.int64), "data": None, "indices": None}

        def keys(self):
            return self._d.keys()

        def __contains__(self, k):
            return k in self._d

        def __getitem__(self, k):
            return self._d[k] if k == "indptr" else np.zeros(0, np.float32)

    with pytest.raises(ValueError, match="int32"):
        dsp.from_backed(BackedMatrix(Huge()), device=CPU)


# ---------------------------------------------------------------------------
# tfidf → lsi on read_h5mu(backed=True), both packages
# ---------------------------------------------------------------------------


@pytest.fixture()
def jax_omega(monkeypatch):
    """The reference's Ω in place of the port's own (as in
    tests/test_torch_atac.py)."""
    import jax
    import jax.numpy as jnp

    def draw(d, l, seed, device):
        om = jax.random.normal(jax.random.PRNGKey(seed), (d, l), jnp.float32)
        return torch.tensor(np.asarray(om), device=device)

    monkeypatch.setattr(tla, "draw_omega", draw)


@pytest.mark.parametrize("writer", WRITERS)
def test_backed_tfidf_lsi_matches_jax(tmp_path, writer, jax_omega):
    W = PKGS[writer]
    X = _planted_clusters()
    p = str(tmp_path / "ooc.h5mu")
    W.MuData({"atac": W.AnnData(X.copy())}).write(p)
    b_t, b_j = mt.read_h5mu(p, backed=True), mu.read_h5mu(p, backed=True)
    at, aj = b_t.mod["atac"], b_j.mod["atac"]
    tac.pp.tfidf(at, device=CPU)
    jac.pp.tfidf(aj)
    assert isinstance(at.X, dsp.DeviceBackedCSR)  # structure on disk, values on the device
    tac.tl.lsi(at, n_comps=5, n_iter=12, device=CPU)
    jac.tl.lsi(aj, n_comps=5, n_iter=12)

    Mt, Mj = at.X.to_memory(), aj.X.to_memory()
    np.testing.assert_array_equal(Mt.indptr, Mj.indptr)
    np.testing.assert_array_equal(Mt.indices, Mj.indices)
    np.testing.assert_allclose(Mt.data, np.asarray(Mj.data), rtol=1e-5)
    np.testing.assert_allclose(at.uns["lsi"]["stdev"], aj.uns["lsi"]["stdev"], rtol=1e-4)
    assert (_col_cos(at.obsm["X_lsi"], aj.obsm["X_lsi"]) >= 1 - 1e-4).all()
    assert (_col_cos(at.varm["LSI"], aj.varm["LSI"]) >= 1 - 1e-4).all()

    # against the port's in-memory path on the same counts, bit for bit
    mem = mt.AnnData(X.copy())
    tac.pp.tfidf(mem, device=CPU)
    np.testing.assert_array_equal(Mt.data, mem.X.data)
    rows = np.array([5, 1, 1, -1, 40])  # through _subset: one gather of the values
    got, want = at.X[rows], mem.X[rows]
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(at.X[rows, 3:9].toarray(), mem.X[rows][:, 3:9].toarray())
    np.testing.assert_array_equal(at.X[np.arange(60)].toarray(), mem.X[:60].toarray())


def test_backed_lsi_reads_a_backed_counts_matrix(tmp_path):
    # lsi of a BackedMatrix (no tfidf): from_backed through randomized_svd,
    # the same as lsi of the matrix in memory
    X = _planted_clusters()
    p = str(tmp_path / "c.h5ad")
    mt.AnnData(X.copy()).write(p)
    b, mem = mt.read_h5ad(p, backed=True), mt.AnnData(X.copy())
    tac.tl.lsi(b, n_comps=5, device=CPU)
    tac.tl.lsi(mem, n_comps=5, device=CPU)
    np.testing.assert_array_equal(b.uns["lsi"]["stdev"], mem.uns["lsi"]["stdev"])
    np.testing.assert_array_equal(b.obsm["X_lsi"], mem.obsm["X_lsi"])
    assert isinstance(getattr(b.X, dsp.DEVICE_TAG), dsp.DeviceCSR)


def test_unsorted_column_ids_keep_the_files_order(tmp_path):
    # a file whose rows store their column ids out of order. The reference
    # sorts each block's entries on the device but pairs them with the
    # file's unsorted indices in DeviceBackedCSR.to_memory (a fault of its
    # own, ROADMAP queue 3), so the port is held to scipy here
    X = _planted_clusters(seed=7, n=40, d=30, g=4)
    for i in range(0, 40, 3):  # reverse the column ids of every third row
        s, e = X.indptr[i], X.indptr[i + 1]
        X.indices[s:e] = X.indices[s:e][::-1].copy()
        X.data[s:e] = X.data[s:e][::-1].copy()
    assert not X.has_sorted_indices
    g = _h5_group(tmp_path, X)
    bm = BackedMatrix(g)
    dX = dsp.from_backed(bm, block_nnz=64, device=CPU)
    np.testing.assert_array_equal(dX.indices.numpy(), X.indices)  # the file's order
    np.testing.assert_array_equal(
        sp.csr_matrix((dX.data.numpy(), dX.indices.numpy(), dX.indptr.numpy()),
                      shape=X.shape).toarray(), X.toarray())
    ad, mem = mt.AnnData(X=bm), mt.AnnData(X.copy())
    tac.pp.tfidf(ad, device=CPU)
    tac.pp.tfidf(mem, device=CPU)
    np.testing.assert_array_equal(ad.X.to_memory().toarray(), mem.X.toarray())
    np.testing.assert_array_equal(ad.X[np.array([3, 0, 9])].toarray(), mem.X[[3, 0, 9]].toarray())


# ---------------------------------------------------------------------------
# the plain twins of T38 and T39, binarize_data and with_col_perm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vt,ct", [(np.uint8, np.int16), (np.uint16, np.int32),
                                   (np.float32, np.int16)])
def test_wire_decode_plain_matches_numpy(vt, ct):
    rng = np.random.default_rng(3)
    v = (rng.integers(0, 250, 37) if vt != np.float32 else rng.normal(size=37)).astype(vt)
    c = rng.integers(0, 30000, 37).astype(ct)
    data, indices = torch.full((50,), -1.0), torch.full((50,), -1, dtype=torch.int32)
    dsp.wire_decode(torch.from_numpy(v), torch.from_numpy(c), data, indices, 9)
    want_d, want_i = np.full(50, -1.0, np.float32), np.full(50, -1, np.int32)
    want_d[9:46], want_i[9:46] = v.astype(np.float32), c.astype(np.int32)
    np.testing.assert_array_equal(data.numpy(), want_d)
    np.testing.assert_array_equal(indices.numpy(), want_i)
    X = dsp.decode_wire(torch.from_numpy(v), torch.from_numpy(c),
                        torch.tensor([0, 10, 10, 37]), 30000)
    assert X.shape == (3, 30000) and X.nnz == 37
    np.testing.assert_array_equal(X.data.numpy(), v.astype(np.float32))


def test_binarize_and_col_perm_match_numpy_and_jax():
    X = _planted_clusters(seed=9, n=40, d=30, g=4)
    X.data[::5] = 0.0  # stored zeros
    dX = dsp.from_scipy(X, CPU)
    dX = dX._replace(data=dX.data.clone())
    dX.data[3] = float("nan")
    got = dsp.binarize_data(dX).numpy()
    np.testing.assert_array_equal(got, (dX.data.numpy() != 0).astype(np.float32))
    jX = jsp.from_scipy(X)
    np.testing.assert_array_equal(dsp.binarize_data(dsp.from_scipy(X, CPU)).numpy(),
                                  np.asarray(jsp.binarize_data(jX))[:X.nnz])
    perm = dsp.with_col_perm(dX)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.argsort(X.indices, kind="stable"))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(jsp.with_col_perm(jX).perm_bycol)[:X.nnz])


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("vt", [torch.uint8, torch.uint16, torch.float32])
@pytest.mark.parametrize("ct", [torch.int16, torch.int32])
@pytest.mark.parametrize("bn,offset", [(1, 0), (1023, 5), (4097, 1 << 20), (0, 3)])
def test_gpu_wire_decode_matches_plain(cuda, vt, ct, bn, offset):
    gen = torch.Generator().manual_seed(bn)
    v = (torch.randn(bn, generator=gen) * 100 if vt == torch.float32
         else torch.randint(0, 250, (bn,), generator=gen)).to(vt)
    c = torch.randint(0, 32000, (bn,), generator=gen).to(ct)
    n = offset + bn + 7
    data, indices = torch.full((n,), -1.0, device=cuda), torch.full((n,), -1, dtype=torch.int32,
                                                                   device=cuda)
    ref_d, ref_i = data.clone(), indices.clone()
    dsp.wire_decode_plain(v.to(cuda), c.to(cuda), ref_d, ref_i, offset)
    _kernels.reset_launch_counts()
    dsp.wire_decode(v.to(cuda), c.to(cuda), data, indices, offset)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["wire_decode"] == (1 if bn else 0)
    assert torch.equal(data, ref_d) and torch.equal(indices, ref_i)


@pytest.mark.gpu
def test_gpu_binarize_matches_plain(cuda):
    x = torch.randn(100_003, device=cuda)
    x[::3] = 0.0
    x[7] = float("nan")
    X = dsp.DeviceCSR(x, torch.tensor([0, x.numel()], dtype=torch.int32, device=cuda),
                      torch.zeros(x.numel(), dtype=torch.int32, device=cuda), 1, 1, x.numel())
    _kernels.reset_launch_counts()
    got = dsp.binarize_data(X)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["binarize_values"] == 1
    assert torch.equal(got, dsp.binarize_data_plain(X))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "block 7", "empty rows", "d=32767", "nnz 0"])
def test_gpu_from_backed_matches_cpu(tmp_path, cuda, case):
    # the pinned staging buffers and their device twins, reused block after block
    X, block_nnz, index_dtype, data_dtype = _case(case)
    g = _npy_group(tmp_path, X, index_dtype, data_dtype)
    want = dsp.from_backed(BackedMatrix(g), block_nnz=block_nnz, device=CPU)
    indptr = X.indptr.astype(np.int64)
    blocks = [(a, b) for a, b in dsp._row_blocks(indptr, block_nnz) if indptr[b] > indptr[a]]
    _kernels.reset_launch_counts()
    got = dsp.from_backed(BackedMatrix(g), block_nnz=block_nnz, device=cuda)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["wire_decode"] == len(blocks)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_gpu_backed_tfidf_lsi_matches_cpu(tmp_path, cuda):
    # the tolerances of tests/test_torch_atac.py::test_gpu_slice_matches_cpu
    X = _planted_clusters()
    g = _npy_group(tmp_path, X, np.int32)
    ads = {dev: mt.AnnData(X=BackedMatrix(g)) for dev in ("cpu", "cuda")}
    for dev, ad in ads.items():
        tac.pp.tfidf(ad, device=dev)
        tac.tl.lsi(ad, n_comps=5, n_iter=12, device=dev)
    g_, c_ = ads["cuda"], ads["cpu"]
    np.testing.assert_allclose(g_.X.to_memory().data, c_.X.to_memory().data, rtol=1e-5,
                               atol=1e-6)
    assert (_col_cos(g_.obsm["X_lsi"], c_.obsm["X_lsi"]) >= 1 - 1e-4).all()
    np.testing.assert_allclose(g_.uns["lsi"]["stdev"], c_.uns["lsi"]["stdev"], rtol=1e-4)
    rows = np.array([3, 89, 0, 0])
    np.testing.assert_allclose(g_.X[rows].toarray(), c_.X[rows].toarray(), rtol=1e-5,
                               atol=1e-6)
