"""The port's h5ad/h5mu I/O, readers and key grammar (muon_tpu_torch._core.h5io,
_core.io, atac.io, prot.io, _core.utils) held to the JAX package's.

The cases of tests/test_containers.py (TestIO, TestUnsRoundtrip),
tests/test_io_readers.py and tests/test_key_parsing.py, run on the port. A
file written by one package is read back by both, in each direction, and
the two reads must be equal (frames by ``pd.testing.assert_frame_equal``,
arrays element for element with their dtypes). The readers' files are
written with h5py by the test and read by both packages.
"""

import numpy as np
import pytest
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import pandas as pd

    import muon_tpu as mu
    from muon_tpu import atac as jac
    from muon_tpu import prot as jpt
    from muon_tpu._core.utils import _get_values as jax_get_values
    from test_io_readers import _write_10x_h5
    from test_torch_containers import _adata, _mdata, assert_same, snap
except ImportError:
    pd = mu = None

import muon_tpu_torch as mt
from muon_tpu_torch import atac as tac
from muon_tpu_torch import prot as tpt
from muon_tpu_torch._core.utils import _get_values

PKGS = {"port": mt, "jax": mu}
# (the package that writes the file, the other one); both read it back
DIRECTIONS = [("port", "jax"), ("jax", "port")]


def _reads(read, path, **kw):
    """``read`` of the file by both packages, the port's first; checks that
    the two reads are the same."""
    a, b = getattr(mt, read)(path, **kw), getattr(mu, read)(path, **kw)
    assert_same(snap(a), snap(b), f"{read}({path})")
    return a, b


# ---------------------------------------------------------------------------
# tests/test_containers.py: TestIO and TestUnsRoundtrip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer,other", DIRECTIONS)
def test_h5ad_roundtrip(tmp_path, writer, other):
    W = PKGS[writer]
    ad = _adata(W, 10, 5, sparse=True)
    ad.obs["cat"] = pd.Categorical(["x", "y"] * 5)
    ad.obs["num"] = np.arange(10.0)
    ad.obsm["X_pca"] = np.random.default_rng(0).normal(size=(10, 3))
    ad.uns["params"] = {"k": 5, "name": "test", "flag": True}
    ad.layers["counts"] = sp.random(10, 5, density=0.5, format="csr", random_state=1)
    path = str(tmp_path / "t.h5ad")
    ad.write(path)
    for ad2 in _reads("read_h5ad", path):
        assert ad2.shape == ad.shape
        assert list(ad2.obs["cat"]) == list(ad.obs["cat"])
        assert np.allclose(ad2.obsm["X_pca"], ad.obsm["X_pca"])
        assert ad2.uns["params"]["k"] == 5 and ad2.uns["params"]["name"] == "test"
        assert np.allclose(ad2.X.toarray(), ad.X.toarray())
        assert np.allclose(ad2.layers["counts"].toarray(), ad.layers["counts"].toarray())


@pytest.mark.parametrize("writer,other", DIRECTIONS)
def test_h5mu_roundtrip(tmp_path, writer, other):
    mdata = _mdata(PKGS[writer])
    mdata.obs["global_col"] = np.arange(50.0)
    mdata.uns["note"] = "hello"
    path = str(tmp_path / "test.h5mu")
    mdata.write(path)
    for md2 in _reads("read_h5mu", path):
        assert md2.n_obs == 50 and md2.n_vars == 50
        assert list(md2.mod) == ["mod1", "mod2"]
        assert np.allclose(np.asarray(md2.mod["mod1"].X), np.asarray(mdata.mod["mod1"].X))
        assert md2.uns["note"] == "hello"
        assert "global_col" in md2.obs.columns


@pytest.mark.parametrize("writer,other", DIRECTIONS)
def test_h5mu_subpath(tmp_path, writer, other):
    path = str(tmp_path / "test.h5mu")
    _mdata(PKGS[writer]).write(path)
    a, b = mt.read(path + "/mod1"), mu.read(path + "/mod1")
    assert type(a) is mt.AnnData and a.shape == (50, 20)
    assert_same(snap(a), snap(b))
    # a modality written into the file by the other package's write()
    PKGS[other].write(path + "/mod3", _adata(PKGS[other], 50, 7, seed=3))
    for pkg in (mt, mu):
        md = pkg.read_h5mu(path)
        assert list(md.mod) == ["mod1", "mod2", "mod3"] and md.mod["mod3"].shape == (50, 7)


@pytest.mark.parametrize("writer,other", DIRECTIONS)
def test_backed_read(tmp_path, writer, other):
    ad = _adata(PKGS[writer], 10, 5, sparse=True)
    path = str(tmp_path / "b.h5ad")
    ad.write(path)
    for pkg in (mt, mu):
        ad2 = pkg.read_h5ad(path, backed="r")
        assert ad2.isbacked and ad2.filename == path
        assert np.allclose(ad2.X.to_memory().toarray(), ad.X.toarray())
        ad2.file.close()
        assert not ad2.file.is_open


@pytest.mark.parametrize("writer,other", DIRECTIONS)
def test_uns_dataframe_roundtrip(tmp_path, writer, other):
    W, A = PKGS[writer], {"port": tac, "jax": jac}[writer]
    adata = W.AnnData(X=np.zeros((3, 2), np.float32))
    pa = pd.DataFrame({
        "peak": ["chr1_1_2", "chr1_3_4"],
        "gene": ["", "G2"],
        "distance": pd.array([pd.NA, 5], dtype="Int64"),
        "peak_type": ["intergenic", "distal"],
    })
    A.tl.add_peak_annotation(adata, pa)
    path = str(tmp_path / "pa.h5mu")
    W.MuData({"atac": adata}).write_h5mu(path)
    backs = _reads("read_h5mu", path)
    for back in backs:
        pb = back.mod["atac"].uns["atac"]["peak_annotation"]
        assert isinstance(pb, pd.DataFrame)
        assert list(pb["peak"]) == ["chr1:1-2", "chr1:3-4"]
        assert str(pb["distance"].dtype) == "Int64"
        assert pd.isna(pb["distance"].iloc[0]) and pb["distance"].iloc[1] == 5
    pd.testing.assert_frame_equal(*(b.mod["atac"].uns["atac"]["peak_annotation"] for b in backs))


@pytest.mark.parametrize("writer,other", DIRECTIONS)
def test_uns_recarray_roundtrip(tmp_path, writer, other):
    W = PKGS[writer]
    rng = np.random.default_rng(0)
    ad = W.AnnData(np.log1p(rng.poisson(2.0, size=(60, 20)).astype(np.float32)))
    ad.obs["grp"] = [str(i % 3) for i in range(60)]
    W.tl.rank_genes_groups(ad, "grp", **({"device": "cpu"} if W is mt else {}))
    path = str(tmp_path / "de.h5ad")
    ad.write(path)
    res = ad.uns["rank_genes_groups"]
    backs = _reads("read_h5ad", path)
    for back in backs:
        res2 = back.uns["rank_genes_groups"]
        for field in ("names", "scores", "pvals", "pvals_adj"):
            assert res2[field].dtype.names == res[field].dtype.names
            for g in res[field].dtype.names:
                a, b = res[field][g], res2[field][g]
                if a.dtype.kind == "O":
                    assert (a == b).all()
                else:
                    assert np.allclose(a.tolist(), b.tolist())
    for field in ("names", "scores", "pvals", "pvals_adj"):
        a, b = (x.uns["rank_genes_groups"][field] for x in backs)
        assert a.dtype == b.dtype and all((a[g] == b[g]).all() for g in a.dtype.names)


def test_write_refuses_what_the_reference_refuses(tmp_path):
    for pkg in (mt, mu):
        with pytest.raises(TypeError):
            pkg.write(str(tmp_path / "x.h5ad"), _mdata(pkg))
        with pytest.raises(TypeError):
            pkg.write(str(tmp_path / "x.h5mu"), _adata(pkg, 3, 2))
        with pytest.raises(ValueError, match="unknown file format"):
            pkg.write(str(tmp_path / "x.zarr"), _adata(pkg, 3, 2))
        with pytest.raises(ValueError, match="unknown file format"):
            pkg.read(str(tmp_path / "x.zarr"))
    assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# tests/test_io_readers.py: CellRanger h5 and snap files written by h5py
# ---------------------------------------------------------------------------


def test_10x_multimodal_split(tmp_path):
    path = str(tmp_path / "matrix.h5")
    X, _ = _write_10x_h5(path)
    mdata, ref = mt.read_10x_h5(path), mu.read_10x_h5(path)
    assert isinstance(mdata, mt.MuData) and set(mdata.mod) == {"rna", "atac", "prot"}
    assert (mdata.mod["rna"].n_vars, mdata.mod["atac"].n_vars, mdata.mod["prot"].n_vars) == \
        (15, 10, 5)
    assert mdata.n_obs == 20
    np.testing.assert_array_equal(mdata.mod["rna"].X.toarray(), X[:, :15].toarray())
    assert "interval" in mdata.mod["rna"].var.columns
    assert_same(snap(mdata), snap(ref))


def test_10x_atac_reader_filters_peaks(tmp_path):
    path = str(tmp_path / "matrix.h5")
    _write_10x_h5(path)
    adata = tac.read_10x_h5(path)
    assert adata.n_vars == 10 and (adata.var["feature_types"] == "Peaks").all()
    assert_same(snap(adata), snap(jac.read_10x_h5(path)))


def test_10x_prot_reader_filters_antibodies(tmp_path):
    path = str(tmp_path / "matrix.h5")
    _write_10x_h5(path)
    adata = tpt.read_10x_h5(path)
    assert adata.n_vars == 5
    assert_same(snap(adata), snap(jpt.read_10x_h5(path)))


def test_read_snap_pm(tmp_path):
    import h5py

    rng = np.random.default_rng(2)
    path = str(tmp_path / "sample.snap")
    n, p = 12, 8
    M = sp.random(n, p, density=0.5, random_state=3, format="coo")
    M.data = np.ceil(M.data * 4)
    with h5py.File(path, "w") as f:
        bd = f.create_group("BD")
        bd.create_dataset("name", data=np.array([f"BC{i}".encode() for i in range(n)]))
        bd.create_dataset("TN", data=rng.integers(100, 1000, n))
        pm = f.create_group("PM")
        pm.create_dataset("peakChrom", data=np.array([b"chr1"] * p))
        pm.create_dataset("peakStart", data=np.arange(p) * 1000)
        pm.create_dataset("peakEnd", data=np.arange(p) * 1000 + 500)
        pm.create_dataset("idx", data=M.row + 1)  # snap is 1-based
        pm.create_dataset("idy", data=M.col + 1)
        pm.create_dataset("count", data=M.data.astype(np.int32))
    adata = tac.read_snap(path, matrix="PM")
    assert adata.shape == (n, p)
    np.testing.assert_array_equal(adata.X.toarray(), M.toarray())
    assert "TN" in adata.obs.columns and adata.var["Chromosome"].iloc[0] == "chr1"
    assert_same(snap(adata), snap(jac.read_snap(path, matrix="PM")))


def test_read_snap_missing_matrix(tmp_path):
    import h5py

    path = str(tmp_path / "bad.snap")
    with h5py.File(path, "w") as f:
        f.create_group("BD").create_dataset("name", data=np.array([b"BC0"]))
    for reader in (tac.read_snap, jac.read_snap):
        with pytest.raises(ValueError):
            reader(path, matrix="PM")


# ---------------------------------------------------------------------------
# tests/test_key_parsing.py: the key grammar on the same containers
# ---------------------------------------------------------------------------


def _kp_mdata(pkg, same_obs):
    m1 = _adata(pkg, 20, 5, seed=1)
    m1.var_names = [f"mod1_var{i}" for i in range(5)]
    m2 = _adata(pkg, 20 if same_obs else 12, 7, seed=2)
    m2.var_names = [f"mod2_var{i}" for i in range(7)]
    m1.obs["mod1_col"] = np.arange(m1.n_obs, dtype=float)
    m2.obs["mod2_col"] = np.arange(m2.n_obs, dtype=float)
    m1.obs["common_col"] = np.ones(m1.n_obs)
    m2.obs["common_col"] = np.zeros(m2.n_obs)
    md = pkg.MuData({"mod1": m1, "mod2": m2})
    md.obs["global_col"] = np.arange(md.n_obs, dtype=float)
    md.obsm["X_emb"] = np.column_stack([np.arange(md.n_obs), -np.arange(md.n_obs)]).astype(float)
    return md


@pytest.fixture(params=[True, False], ids=["same_obs", "ragged"])
def mdata_kp(request):
    """The fixture's MuData in both packages: (port, reference, same_obs)."""
    return _kp_mdata(mt, request.param), _kp_mdata(mu, request.param), request.param


def _both(md_t, md_j, key, **kw):
    """``_get_values`` of the port and of the reference; equal, NaN for NaN."""
    a, b = _get_values(md_t, key, **kw), jax_get_values(md_j, key, **kw)
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    return a


def test_kp_global_obs(mdata_kp):
    md, ref, _ = mdata_kp
    assert np.allclose(_both(md, ref, "global_col"), np.arange(md.n_obs))


def test_kp_mod_prefixed_obs(mdata_kp):
    md, ref, same_obs = mdata_kp
    vals = _both(md, ref, "mod2:mod2_col")
    assert len(vals) == md.n_obs
    if same_obs:
        assert np.allclose(vals, np.arange(md.n_obs))
    else:
        assert np.isnan(vals.astype(float)).sum() == md.n_obs - 12


def test_kp_var_name_search(mdata_kp):
    md, ref, _ = mdata_kp
    vals = _both(md, ref, "mod1_var0")
    assert len(vals) == md.n_obs
    assert np.allclose(np.asarray(vals, dtype=float), np.asarray(md.mod["mod1"].X)[:, 0])


def test_kp_var_in_second_mod_ragged(mdata_kp):
    md, ref, same_obs = mdata_kp
    vals = np.asarray(_both(md, ref, "mod2_var0"), dtype=float)
    if not same_obs:
        assert np.isnan(vals).sum() == md.n_obs - 12


def test_kp_obsm_component(mdata_kp):
    md, ref, _ = mdata_kp
    assert np.allclose(_both(md, ref, "X_emb:2"), -np.arange(md.n_obs))


def test_kp_obsm_zero_index_raises(mdata_kp):
    md, ref, _ = mdata_kp
    for get, m in ((_get_values, md), (jax_get_values, ref)):
        with pytest.raises(ValueError):
            get(m, "X_emb:0")


def test_kp_mod_obsm_component(mdata_kp):
    md, ref, _ = mdata_kp
    for m in (md, ref):
        m.mod["mod1"].obsm["X_pca"] = np.column_stack([np.arange(20.0), np.arange(20.0) * 2])
    vals = _both(md, ref, "mod1:X_pca:2")
    assert np.allclose(np.asarray(vals, dtype=float)[:20], np.arange(20.0) * 2)


def test_kp_missing_key_raises(mdata_kp):
    md, ref, _ = mdata_kp
    for get, m in ((_get_values, md), (jax_get_values, ref)):
        with pytest.raises(ValueError):
            get(m, "not_a_key")


def test_kp_multiple_keys(mdata_kp):
    md, ref, _ = mdata_kp
    df = _both(md, ref, ["global_col", "X_emb:1"])
    assert isinstance(df, pd.DataFrame) and df.shape == (md.n_obs, 2)


def test_kp_ambiguous_var_raises():
    for pkg, get in ((mt, _get_values), (mu, jax_get_values)):
        md = pkg.MuData({"m1": _adata(pkg, 5, 2), "m2": _adata(pkg, 5, 2)})
        with pytest.raises(ValueError, match="multiple modalities"):
            get(md, "var0")


def test_kp_layer_fallback():
    mds = []
    for pkg in (mt, mu):
        m1 = _adata(pkg, 5, 2)
        m1.layers["scaled"] = np.asarray(m1.X) * 10
        mds.append(pkg.MuData({"m1": m1}))
    vals = _both(*mds, "var1", layer="scaled")
    assert np.allclose(np.asarray(vals, dtype=float), np.asarray(mds[0].mod["m1"].X)[:, 1] * 10)


def test_kp_raw_fallback():
    mds, orig = [], None
    for pkg in (mt, mu):
        m1 = _adata(pkg, 5, 3)
        m1.raw = m1
        orig = np.asarray(m1.X)[:, 2].copy()
        pkg.pp.filter_var(m1, ["var0", "var1"])  # var2 stays findable through raw
        mds.append(pkg.MuData({"m1": m1}))
    vals = _both(*mds, "var2")
    assert np.allclose(np.asarray(vals, dtype=float), orig)


def test_port_exports_the_readers_and_writers():
    names = ("read", "write", "read_h5mu", "read_h5ad", "write_h5mu", "write_h5ad",
             "read_10x_h5", "read_10x_mtx")
    for name in names:
        assert getattr(mt, name).__module__ in ("muon_tpu_torch._core.io",
                                                "muon_tpu_torch._core.h5io"), name
    assert tac.read_snap.__module__ == "muon_tpu_torch.atac.io"
    assert mt.utils.get_values is _get_values
