"""The port's containers (muon_tpu_torch.AnnData, MuData) and in-place
filters (muon_tpu_torch.pp.filter_obs, filter_var, intersect_obs,
sample_obs) held to the JAX package's on the same inputs.

Each case builds the same objects from the same numpy arrays and frames in
both packages, runs the same calls, and returns what the cases of
tests/test_containers.py and tests/test_preproc_filter.py look at: shapes,
frames, matrices, the aligned mappings, views, ``update()``'s maps and
masks, filter results and the exceptions raised. The two must be equal: the
frames by ``pd.testing.assert_frame_equal``, the arrays element for element
with their dtypes. The backed and I/O cases stay out: the port refuses
them with the name of the slice that brings them (K19).
"""

import subprocess
import sys

import numpy as np
import pytest
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import pandas as pd

    import muon_tpu as mu
except ImportError:
    pd = mu = None
try:
    from tests.test_torch_leiden import _mdata as leiden_mdata
except ImportError:
    leiden_mdata = None

import muon_tpu_torch as mt


def _adata(pkg, n_obs=50, n_vars=20, seed=0, sparse=False, obs_prefix="obs"):
    """tests/conftest.py's make_adata, in either package."""
    rng = np.random.default_rng(seed)
    if sparse:
        X = sp.random(n_obs, n_vars, density=0.3, random_state=seed, format="csr")
    else:
        X = rng.normal(size=(n_obs, n_vars)).astype(np.float32)
    obs = pd.DataFrame(index=pd.Index([f"{obs_prefix}{i}" for i in range(n_obs)]))
    var = pd.DataFrame(index=pd.Index([f"var{i}" for i in range(n_vars)]))
    return pkg.AnnData(X=X, obs=obs, var=var)


def _mdata(pkg):
    """tests/conftest.py's mdata: two modalities over the same 50 cells."""
    return pkg.MuData({"mod1": _adata(pkg, 50, 20, seed=1), "mod2": _adata(pkg, 50, 30, seed=2)})


def _arange_adata(pkg):
    """tests/test_preproc_filter.py's adata: X = arange, values name their
    (obs, var) position."""
    ad = _adata(pkg, 50, 20, seed=0)
    ad.X = np.arange(1000, dtype=np.float64).reshape(50, 20)
    return ad


def _raises(fn):
    """The name of the exception ``fn`` raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the result compared
        return type(e).__name__
    return None


def snap(obj):
    """What the container tests look at, as plain values."""
    if hasattr(obj, "mod"):
        return {
            "kind": "MuData", "shape": obj.shape, "is_view": obj.is_view, "axis": obj.axis,
            "obs": obj.obs.copy(), "var": obj.var.copy(),
            "obsmap": dict(obj.obsmap), "varmap": dict(obj.varmap),
            "obsm": dict(obj.obsm), "varm": dict(obj.varm), "obsp": dict(obj.obsp),
            "uns": sorted(obj.uns), "mod": {k: snap(v) for k, v in obj.mod.items()},
        }
    raw = obj.raw
    return {
        "kind": "AnnData", "shape": obj.shape, "is_view": obj.is_view,
        "obs": obj.obs.copy(), "var": obj.var.copy(), "X": obj.X,
        "obsm": dict(obj.obsm), "varm": dict(obj.varm), "obsp": dict(obj.obsp),
        "varp": dict(obj.varp), "layers": dict(obj.layers), "uns": sorted(obj.uns),
        "raw": None if raw is None else (raw.shape, raw.X, raw.var.copy()),
    }


def assert_same(a, b, where="result"):
    if isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, obj=where)
    elif isinstance(a, (pd.Series, pd.Index)):
        assert type(a) is type(b), where
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=where)
        assert a.dtype == b.dtype, where
    elif sp.issparse(a):
        assert sp.issparse(b) and a.format == b.format and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a.toarray(), b.toarray(), err_msg=where)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


# ---------------------------------------------------------------------------
# the cases: each takes a package and returns what is compared
# ---------------------------------------------------------------------------


def c_basic_dims(pkg):
    ad = _adata(pkg, 10, 5)
    return snap(ad), list(ad.obs_names[:2])


def c_default_index(pkg):
    return snap(pkg.AnnData(X=np.zeros((3, 2))))


def c_view_and_copy(pkg):
    ad = _adata(pkg, 10, 5)
    v = ad[[0, 2, 4]]
    c = v.copy()
    return snap(v), snap(c), snap(ad[["obs1", "obs3"]]), snap(ad[0:5, ["var0", "var2"]])


def c_bool_mask_slicing(pkg):
    ad = _adata(pkg, 10, 5)
    mask = np.zeros(10, dtype=bool)
    mask[:3] = True
    return snap(ad[mask])


def c_aligned_validation(pkg):
    ad = _adata(pkg, 10, 5)
    ad.obsm["X_pca"] = np.zeros((10, 2))
    ad.layers["counts"] = np.zeros((10, 5))
    ad.obsp["dist"] = np.zeros((10, 10))
    bad = [_raises(lambda: ad.obsm.__setitem__("bad", np.zeros((9, 2)))),
           _raises(lambda: ad.layers.__setitem__("bad", np.zeros((10, 4)))),
           _raises(lambda: ad.obsp.__setitem__("bad", np.zeros((10, 9)))),
           _raises(lambda: ad.varm.__setitem__("bad", np.zeros((4, 2))))]
    return snap(ad), bad


def c_subset_propagates(pkg):
    ad = _adata(pkg, 10, 5)
    ad.obsm["X_pca"] = np.arange(20).reshape(10, 2)
    ad.obsp["conn"] = np.arange(100).reshape(10, 10)
    ad.layers["l"] = ad.X.copy()
    ad.varm["load"] = np.arange(10.0).reshape(5, 2)
    return snap(ad[[1, 3]]), snap(ad[:, [0, 4]])


def c_raw(pkg):
    ad = _adata(pkg, 10, 5)
    ad.raw = ad
    return snap(ad[:, [0, 1]]), snap(ad[[2, 5], :]), ad.raw[[1, 2], [0, 3]].shape


def c_categorical_cleanup(pkg):
    ad = _adata(pkg, 6, 3)
    ad.obs["grp"] = pd.Categorical(["a", "a", "b", "b", "c", "c"])
    return snap(ad[[0, 1]])


def c_obs_vector(pkg):
    ad = _adata(pkg, 5, 3, sparse=True)
    ad.obs["x"] = np.arange(5.0)
    ad.var["y"] = np.arange(3) * 2
    return ad.obs_vector("x"), ad.obs_vector("var1"), ad.var_vector("y"), ad.var_vector("obs2")


def c_to_df_transpose_unique(pkg):
    ad = _adata(pkg, 4, 3)
    ad.obsm["e"] = np.ones((4, 2))
    df = ad.to_df()
    t = ad.T
    dup = pkg.AnnData(X=np.zeros((3, 2)), obs=pd.DataFrame(index=["a", "a", "b"]))
    dup.obs_names_make_unique()
    joined = pkg._core.anndata.concat_names([pd.Index(["x", "y"]), pd.Index(["y", "z"])],
                                            make_unique=True)
    return df, snap(t), list(dup.obs_names), joined


def c_shared_obs(pkg):
    md = _mdata(pkg)
    return snap(md)


def c_ragged_obs(pkg):
    return snap(pkg.MuData({"m1": _adata(pkg, 10, 4), "m2": _adata(pkg, 6, 3)}))


def c_union_order(pkg):
    return snap(pkg.MuData({"m1": _adata(pkg, 3, 2, obs_prefix="a"),
                            "m2": _adata(pkg, 3, 2, obs_prefix="b")}))


def c_mudata_view(pkg):
    md = _mdata(pkg)
    return snap(md[[0, 1, 2]]), snap(md[:, [0, 1, 25]])


def c_view_ragged(pkg):
    md = pkg.MuData({"m1": _adata(pkg, 10, 4), "m2": _adata(pkg, 6, 3)})
    return snap(md[[4, 5, 6, 7]])


def c_axis1(pkg):
    return snap(pkg.MuData({"m1": _adata(pkg, 5, 8, obs_prefix="a"),
                            "m2": _adata(pkg, 7, 8, obs_prefix="b")}, axis=1))


def c_pull_push_obs(pkg):
    m1, m2 = _adata(pkg, 5, 2), _adata(pkg, 5, 3)
    m1.obs["score"] = np.arange(5.0)
    m2.obs["score"] = np.arange(5.0) * 2
    m1.obs["only"] = pd.Categorical(list("xyxyx"))
    md = pkg.MuData({"m1": m1, "m2": m2})
    md.pull_obs()
    md.obs["glob"] = np.arange(5) + 10
    md.push_obs(["glob"])
    return snap(md)


def c_getitem_and_embedding(pkg):
    md = _mdata(pkg)
    md.obsm["X_test"] = np.zeros((50, 2))
    return (md["mod1"] is md.mod["mod1"], snap(md),
            _raises(lambda: md.obsm.__setitem__("X_bad", np.zeros((49, 2)))))


def c_update_after_modality_filter(pkg):
    md = _mdata(pkg)
    md.obs["anno"] = np.arange(50.0)
    pkg.pp.filter_obs(md.mod["mod2"], np.arange(50) % 3 == 0)
    md.update()
    return snap(md)


def c_copy_mudata(pkg):
    md = _mdata(pkg)
    md.obsm["X_e"] = np.arange(100.0).reshape(50, 2)
    md.uns["note"] = {"a": np.arange(3)}
    c = md.copy()
    c.mod["mod1"].X[0, 0] = 99.0
    return snap(md), snap(c)


def c_filter_obs_bool_mask(pkg):
    ad = _arange_adata(pkg)
    pkg.pp.filter_obs(ad, np.random.default_rng(42).random(50) > 0.5)
    return snap(ad)


def c_filter_obs_column(pkg):
    ad = _arange_adata(pkg)
    ad.obs["keep"] = np.arange(50) % 2 == 0
    pkg.pp.filter_obs(ad, "keep")
    return snap(ad)


def c_filter_obs_func(pkg):
    ad = _arange_adata(pkg)
    ad.obs["val"] = np.arange(50.0)
    pkg.pp.filter_obs(ad, "val", lambda x: x < 10)
    return snap(ad)


def c_filter_obs_nonbool_requires_func(pkg):
    ad = _arange_adata(pkg)
    ad.obs["val"] = np.arange(50.0)
    return (_raises(lambda: pkg.pp.filter_obs(ad, "val")),
            _raises(lambda: pkg.pp.filter_obs(ad, ["obs1"], lambda x: x)),
            _raises(lambda: pkg.pp.filter_obs(ad, "nope", lambda x: x)))


def c_filter_obs_names(pkg):
    ad = _arange_adata(pkg)
    pkg.pp.filter_obs(ad, ["obs1", "obs5", "obs7"])
    return snap(ad)


def c_filter_obs_by_var_values(pkg):
    ad = _arange_adata(pkg)
    pkg.pp.filter_obs(ad, "var0", lambda x: x > 500)
    return snap(ad)


def c_filter_var(pkg):
    ad = _arange_adata(pkg)
    ad.varm["v"] = np.arange(40.0).reshape(20, 2)
    pkg.pp.filter_var(ad, np.random.default_rng(1).random(20) > 0.5)
    return snap(ad)


def c_consecutive_filters(pkg):
    ad = _arange_adata(pkg)
    pkg.pp.filter_obs(ad, np.arange(50) < 30)
    pkg.pp.filter_obs(ad, np.arange(30) >= 10)
    return snap(ad)


def c_filter_propagates_sideworld(pkg):
    ad = _arange_adata(pkg)
    ad.obsm["X_pca"] = np.arange(100).reshape(50, 2)
    ad.obsp["d"] = np.arange(2500).reshape(50, 50)
    ad.layers["l"] = ad.X * 2
    ad.raw = ad
    pkg.pp.filter_obs(ad, np.arange(50) < 5)
    return snap(ad)


def c_view_raises(pkg):
    ad, md = _arange_adata(pkg), _mdata(pkg)
    return (_raises(lambda: pkg.pp.filter_obs(ad[0:10], np.ones(10, dtype=bool))),
            _raises(lambda: pkg.pp.filter_obs(md[0:10], np.ones(10, dtype=bool))))


def c_filter_sparse(pkg):
    ad = _adata(pkg, 30, 10, sparse=True)
    pkg.pp.filter_obs(ad, np.arange(30) % 3 == 0)
    return snap(ad)


def c_filter_obs_mudata(pkg):
    md = _mdata(pkg)
    pkg.pp.filter_obs(md, np.arange(50) < 20)
    return snap(md)


def c_filter_obs_ragged(pkg):
    md = pkg.MuData({"m1": _adata(pkg, 10, 4), "m2": _adata(pkg, 6, 3)})
    mask = np.zeros(10, dtype=bool)
    mask[[0, 4, 7, 8]] = True
    pkg.pp.filter_obs(md, mask)
    return snap(md)


def c_filter_obs_modality_in_its_own_order(pkg):
    # m2 holds obs7, obs5, obs3, obs1 in that order: kept rows keep it
    m2 = _adata(pkg, 8, 3)[[7, 5, 3, 1]].copy()
    md = pkg.MuData({"m1": _adata(pkg, 8, 4), "m2": m2})
    pkg.pp.filter_obs(md, np.arange(8) != 5)
    return snap(md)


def c_filter_var_mudata(pkg):
    md = _mdata(pkg)
    mask = np.zeros(50, dtype=bool)
    mask[:10] = True
    mask[25:30] = True
    pkg.pp.filter_var(md, mask)
    return snap(md)


def c_filter_global_columns_kept(pkg):
    md = _mdata(pkg)
    md.obs["anno"] = np.arange(50.0)
    md.obsm["X_e"] = np.arange(100.0).reshape(50, 2)
    pkg.pp.filter_obs(md, np.arange(50) >= 40)
    return snap(md)


def c_intersect_obs(pkg):
    md = pkg.MuData({"m1": _adata(pkg, 10, 4), "m2": _adata(pkg, 6, 3)})
    pkg.pp.intersect_obs(md)
    return snap(md)


def c_intersect_obs_no_x(pkg):
    m1 = pkg.AnnData(obs=pd.DataFrame(index=[f"obs{i}" for i in range(8)]))
    md = pkg.MuData({"m1": m1, "m2": _adata(pkg, 5, 3)})
    pkg.pp.intersect_obs(md)
    return snap(md)


def c_sample_obs(pkg):
    md = _mdata(pkg)
    return snap(pkg.pp.sample_obs(md, 0.2, random_state=0))


def c_sample_obs_groupby(pkg):
    ad = _adata(pkg, 40, 5)
    ad.obs["grp"] = pd.Categorical(["a"] * 20 + ["b"] * 20)
    return (snap(pkg.pp.sample_obs(ad, 0.5, groupby="grp", random_state=3)),
            _raises(lambda: pkg.pp.sample_obs(ad, 0.5, groupby="none")))


def c_sample_obs_seeded(pkg):
    ad = pkg.AnnData(np.arange(200, dtype=np.float32).reshape(100, 2))
    return [list(pkg.pp.sample_obs(ad, frac=0.3, random_state=s).obs_names) for s in (7, 7, 8)]


def c_pull_obs_common_unprefixed_axis1(pkg):
    A = pkg.AnnData(np.zeros((4, 3), np.float32))
    B = pkg.AnnData(np.zeros((5, 3), np.float32))
    A.obs_names = [f"a{i}" for i in range(4)]
    B.obs_names = [f"b{i}" for i in range(5)]
    A.obs["louvain"] = pd.Categorical(["x", "x", "y", "y"])
    B.obs["louvain"] = pd.Categorical(["y", "y", "y", "x", "x"])
    md = pkg.MuData({"A": A, "B": B}, axis=1)
    md.pull_obs("louvain")
    pkg.pp.filter_obs(md, "louvain", lambda x: x == "y")
    return snap(md)


def c_pull_var_common_and_prefix_unique(pkg):
    A = pkg.AnnData(np.zeros((3, 4), np.float32))
    B = pkg.AnnData(np.zeros((3, 2), np.float32))
    A.var["sel"] = [1, 0, 1, 0]
    B.var["sel"] = [0, 1]
    A.var["only_a"] = list("wxyz")
    md = pkg.MuData({"A": A, "B": B})
    md.pull_var(["sel", "only_a"])
    md.pull_var(["only_a"], prefix_unique=False)
    return snap(md)


CASES = [v for k, v in sorted(globals().items()) if k.startswith("c_")]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[2:])
def test_container_case_matches_jax(case):
    assert_same(case(mu), case(mt))


def test_port_containers_are_the_ports():
    md = _mdata(mt)
    assert type(md).__module__ == "muon_tpu_torch._core.mudata"
    assert all(type(m).__module__ == "muon_tpu_torch._core.anndata" for m in md.mod.values())
    assert type(md[[0, 1]].mod["mod1"]) is mt.AnnData
    assert type(md.copy()) is mt.MuData


# ---------------------------------------------------------------------------
# what the port refuses until K19 (the h5ad/h5mu I/O, backed mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda tmp: mt.AnnData(X=np.zeros((2, 2)), filename=str(tmp / "x.h5ad")),
    lambda tmp: _adata(mt, 3, 2).write(str(tmp / "x.h5ad")),
    lambda tmp: _adata(mt, 3, 2).write_h5ad(str(tmp / "x.h5ad")),
    lambda tmp: _mdata(mt).write(str(tmp / "x.h5mu")),
    lambda tmp: _mdata(mt).write_h5mu(str(tmp / "x.h5mu")),
], ids=["backed", "write", "write_h5ad", "mudata_write", "write_h5mu"])
def test_io_and_backed_are_refused_naming_k19(call, tmp_path):
    with pytest.raises(NotImplementedError, match="h5ad/h5mu I/O and the out-of-core ingest, K19"):
        call(tmp_path)
    assert not list(tmp_path.iterdir())


def test_filters_refuse_a_backed_object():
    class Backed:
        is_view, isbacked = False, True

    with pytest.raises(NotImplementedError, match="K19"):
        mt.pp.filter_obs(Backed(), np.ones(3, dtype=bool))


def test_port_imports_without_pandas():
    # the containers import pandas inside their functions: the port, its
    # device paths and its containers import where pandas is missing
    code = ("import sys; sys.modules['pandas'] = None\n"
            "import muon_tpu_torch, muon_tpu_torch.atac, muon_tpu_torch.prot\n"
            "import muon_tpu_torch.ops.pileup, muon_tpu_torch.atac.fragments\n"
            "from muon_tpu_torch import AnnData, MuData\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# ---------------------------------------------------------------------------
# tl.leiden writes a Categorical into the port's containers
# ---------------------------------------------------------------------------


def _port_mdata(md_j):
    return mt.MuData({k: mt.AnnData(X=m.X, obs=m.obs, obsp=dict(m.obsp), uns=dict(m.uns))
                      for k, m in md_j.mod.items()})


def test_leiden_writes_a_categorical_into_the_port_mudata():
    md_j, _ = leiden_mdata()
    md_t = _port_mdata(md_j)
    mt.tl.leiden(md_t, resolution=1.0, random_state=1)
    mu.tl.leiden(md_j, resolution=1.0, random_state=1)
    got, want = md_t.obs["leiden"], md_j.obs["leiden"]
    assert isinstance(got.dtype, pd.CategoricalDtype)
    assert list(got.cat.categories) == list(want.cat.categories)
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    # one modality (the AnnData branch)
    ad_t = _port_mdata(md_j).mod["m1"]
    mt.tl.leiden(ad_t, resolution=0.5, random_state=2)
    mu.tl.leiden(md_j.mod["m1"], resolution=0.5, random_state=2)
    assert isinstance(ad_t.obs["leiden"].dtype, pd.CategoricalDtype)
    pd.testing.assert_series_equal(ad_t.obs["leiden"], md_j.mod["m1"].obs["leiden"])
