"""HDF5 serialization of the port's containers: ``.h5ad`` / ``.h5mu``
(counterpart of muon_tpu/_core/h5io.py, the same groups, attrs and encodings,
so a file written by either package reads in the other).

Writes and reads the anndata v0.8+ element encodings (``encoding-type``
attrs: array / csr_matrix / csc_matrix / dataframe / categorical / dict /
string / numeric-scalar / rec-array / nullable-*). h5py and pandas are
imported inside the functions that need them: importing the port must not
need either (the card's machine has no h5py).
"""

from __future__ import annotations

import numpy as np
from scipy import sparse as sp

from .anndata import AnnData, BackedMatrix, Raw
from .mudata import MuData

__all__ = [
    "write_h5ad",
    "read_h5ad",
    "write_h5mu",
    "read_h5mu",
]


def _str_dtype():
    import h5py

    return h5py.string_dtype(encoding="utf-8")


def _set_enc(obj, enc_type, version="0.2.0"):
    obj.attrs["encoding-type"] = enc_type
    obj.attrs["encoding-version"] = version


# ---------------------------------------------------------------------------
# element writers
# ---------------------------------------------------------------------------


def _write_rec_array(group, key, value, compression=None):
    """Structured/record arrays (scanpy's rank_genes_groups convention) as
    HDF5 compound datasets, anndata 'rec-array' encoding; object/unicode
    fields become vlen UTF-8 strings."""
    new_dtype = [
        (name, _str_dtype() if value.dtype[name].kind in ("O", "U", "S") else value.dtype[name])
        for name in value.dtype.names
    ]
    arr = np.empty(value.shape, dtype=new_dtype)
    for name in value.dtype.names:
        col = value[name]
        if value.dtype[name].kind in ("O", "U", "S"):
            col = np.array([_decode(x) if isinstance(x, bytes) else str(x)
                            for x in np.ravel(col)], dtype=object).reshape(col.shape)
        arr[name] = col
    ds = group.create_dataset(key, data=arr, compression=compression)
    _set_enc(ds, "rec-array", "0.2.0")
    return ds


def _write_array(group, key, value, compression=None):
    value = np.asarray(value)
    if value.dtype.names is not None:
        return _write_rec_array(group, key, value, compression)
    if value.dtype.kind in ("U", "O"):
        ds = group.create_dataset(key, data=value.astype(object), dtype=_str_dtype(),
                                  compression=compression)
        _set_enc(ds, "string-array")
    elif value.dtype.kind == "b":
        ds = group.create_dataset(key, data=value, compression=compression)
        _set_enc(ds, "array")
    else:
        ds = group.create_dataset(key, data=value, compression=compression)
        _set_enc(ds, "array")
    return ds


def _write_sparse(group, key, value, compression=None):
    fmt = "csr" if sp.issparse(value) and value.format == "csr" else "csc"
    if value.format not in ("csr", "csc"):
        value = value.tocsr()
        fmt = "csr"
    g = group.create_group(key)
    _set_enc(g, f"{fmt}_matrix", "0.1.0")
    g.attrs["shape"] = np.array(value.shape, dtype=np.int64)
    g.create_dataset("data", data=value.data, compression=compression)
    g.create_dataset("indices", data=value.indices.astype(np.int64),
                     compression=compression)
    g.create_dataset("indptr", data=value.indptr.astype(np.int64),
                     compression=compression)
    return g


def _write_categorical(group, key, value, compression=None):
    g = group.create_group(key)
    _set_enc(g, "categorical", "0.2.0")
    g.attrs["ordered"] = bool(value.ordered)
    cats = np.asarray(value.categories)
    _write_array(g, "categories", cats, compression)
    g.create_dataset("codes", data=value.codes.astype(np.int32),
                     compression=compression)
    return g


def _write_df(group, key, df, compression=None):
    import pandas as pd

    g = group.create_group(key)
    _set_enc(g, "dataframe", "0.2.0")
    index_name = df.index.name or "_index"
    g.attrs["_index"] = index_name
    g.attrs.create(
        "column-order", data=[str(c) for c in df.columns], dtype=_str_dtype()
    )
    _write_array(g, index_name, np.asarray(df.index, dtype=object), compression)
    for col in df.columns:
        s = df[col]
        if isinstance(s.dtype, pd.CategoricalDtype):
            _write_categorical(g, str(col), pd.Categorical(s), compression)
        elif s.dtype == object or s.dtype.kind == "U":
            vals = s.to_numpy(dtype=object)
            has_na = pd.isna(vals).any()
            if has_na:
                vals = np.where(pd.isna(vals), "nan", vals)
            _write_array(g, str(col), vals, compression)
        elif str(s.dtype) in ("Int64", "Int32", "Float64", "boolean"):
            gg = g.create_group(str(col))
            _set_enc(gg, "nullable-integer" if "Int" in str(s.dtype)
                     else ("nullable-boolean" if s.dtype == "boolean"
                           else "nullable-float"), "0.1.0")
            mask = s.isna().to_numpy()
            vals = s.fillna(0).to_numpy()
            gg.create_dataset("values", data=vals, compression=compression)
            gg.create_dataset("mask", data=mask, compression=compression)
        else:
            _write_array(g, str(col), s.to_numpy(), compression)
    return g


def _write_mapping(group, key, mapping, compression=None):
    g = group.create_group(key)
    _set_enc(g, "dict", "0.1.0")
    for k, v in mapping.items():
        _write_elem(g, str(k), v, compression)
    return g


def _write_elem(group, key, value, compression=None):
    import pandas as pd

    if key in group:
        del group[key]
    if value is None:
        return
    if sp.issparse(value):
        _write_sparse(group, key, value, compression)
    elif isinstance(value, pd.DataFrame):
        _write_df(group, key, value, compression)
    elif isinstance(value, pd.Categorical):
        _write_categorical(group, key, value, compression)
    elif isinstance(value, (dict,)):
        _write_mapping(group, key, value, compression)
    elif isinstance(value, str):
        ds = group.create_dataset(key, data=value, dtype=_str_dtype())
        _set_enc(ds, "string")
    elif isinstance(value, (bool, np.bool_)):
        ds = group.create_dataset(key, data=bool(value))
        _set_enc(ds, "numeric-scalar")
    elif isinstance(value, (int, float, np.integer, np.floating)):
        ds = group.create_dataset(key, data=value)
        _set_enc(ds, "numeric-scalar")
    elif isinstance(value, (np.ndarray, list, tuple, pd.Index, pd.Series)):
        _write_array(group, key, np.asarray(value), compression)
    elif isinstance(value, BackedMatrix):
        _write_elem(group, key, value.to_memory(), compression)
    else:
        # best-effort: store repr as string
        ds = group.create_dataset(key, data=str(value), dtype=_str_dtype())
        _set_enc(ds, "string")


# ---------------------------------------------------------------------------
# element readers
# ---------------------------------------------------------------------------


def _decode(x):
    if isinstance(x, bytes):
        return x.decode("utf-8")
    return x


def _read_elem(obj):
    import h5py
    import pandas as pd

    enc = _decode(obj.attrs.get("encoding-type", ""))
    if isinstance(obj, h5py.Dataset):
        val = obj[()]
        if enc == "string" or (np.isscalar(val) and isinstance(val, bytes)):
            return _decode(val)
        if enc == "rec-array" or (
            hasattr(val, "dtype") and val.dtype.names is not None
        ):
            cols, dtypes = [], []
            for name in val.dtype.names:
                c = val[name]
                if c.dtype.kind in ("O", "S"):
                    c = np.array(
                        [_decode(x) for x in np.ravel(c)], dtype=object
                    ).reshape(c.shape)
                cols.append(c)
                dtypes.append((name, c.dtype))
            return np.rec.fromarrays(cols, dtype=dtypes)
        if enc == "string-array" or (
            hasattr(val, "dtype") and val.dtype.kind in ("O", "S")
        ):
            return np.array([_decode(v) for v in np.ravel(val)]).reshape(val.shape)
        if enc == "numeric-scalar" or np.isscalar(val):
            return val.item() if hasattr(val, "item") and val.shape == () else val
        return val
    # groups
    if enc in ("csr_matrix", "csc_matrix") or "indptr" in obj:
        shape = tuple(int(x) for x in obj.attrs["shape"])
        cls = sp.csr_matrix if enc != "csc_matrix" else sp.csc_matrix
        return cls(
            (obj["data"][...], obj["indices"][...], obj["indptr"][...]), shape=shape
        )
    if enc == "categorical":
        cats = _read_elem(obj["categories"])
        codes = obj["codes"][...]
        return pd.Categorical.from_codes(
            codes, categories=pd.Index(cats), ordered=bool(obj.attrs.get("ordered", False))
        )
    if enc in ("nullable-integer", "nullable-float", "nullable-boolean"):
        vals = obj["values"][...]
        mask = obj["mask"][...].astype(bool)
        if enc == "nullable-integer":
            arr = pd.array(vals, dtype="Int64")
        elif enc == "nullable-boolean":
            arr = pd.array(vals.astype(bool), dtype="boolean")
        else:
            arr = pd.array(vals.astype(float), dtype="Float64")
        arr[mask] = pd.NA
        return arr
    if enc == "dataframe" or "_index" in obj.attrs:
        index_name = _decode(obj.attrs["_index"])
        index = pd.Index(_read_elem(obj[index_name]))
        if index_name != "_index":
            index.name = index_name
        col_order = [_decode(c) for c in obj.attrs.get("column-order", [])]
        df = pd.DataFrame(index=index)
        for col in col_order:
            if col in obj:
                vals = _read_elem(obj[col])
                df[col] = vals
        return df
    # generic dict
    return {k: _read_elem(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# h5ad
# ---------------------------------------------------------------------------


def _write_adata_group(g, adata: AnnData, compression=None):
    _set_enc(g, "anndata", "0.1.0")
    X = adata.X
    if isinstance(X, BackedMatrix):
        X = X.to_memory()
    if X is not None:
        _write_elem(g, "X", X, compression)
    _write_df(g, "obs", adata.obs, compression)
    _write_df(g, "var", adata.var, compression)
    for attr in ("obsm", "varm", "obsp", "varp", "layers"):
        _write_mapping(g, attr, dict(getattr(adata, attr)), compression)
    _write_mapping(g, "uns", adata.uns, compression)
    if adata.raw is not None:
        rg = g.create_group("raw")
        _set_enc(rg, "raw", "0.1.0")
        if adata.raw.X is not None:
            _write_elem(rg, "X", adata.raw.X, compression)
        _write_df(rg, "var", adata.raw.var, compression)
        _write_mapping(rg, "varm", dict(adata.raw.varm), compression)


def _read_adata_group(g, backed=False) -> AnnData:
    obs = _read_elem(g["obs"]) if "obs" in g else None
    var = _read_elem(g["var"]) if "var" in g else None
    if "X" in g:
        X = BackedMatrix(g["X"]) if backed else _read_elem(g["X"])
    else:
        X = None
    kw = {}
    for attr in ("obsm", "varm", "obsp", "varp", "layers"):
        kw[attr] = _read_elem(g[attr]) if attr in g else {}
    uns = _read_elem(g["uns"]) if "uns" in g else {}
    adata = AnnData(X=X, obs=obs, var=var, uns=uns,
                    shape=(len(obs) if obs is not None else 0,
                           len(var) if var is not None else 0), **kw)
    if "raw" in g:
        rg = g["raw"]
        rX = _read_elem(rg["X"]) if "X" in rg else None
        rvar = _read_elem(rg["var"]) if "var" in rg else None
        rvarm = _read_elem(rg["varm"]) if "varm" in rg else {}
        adata._raw = Raw(X=rX, var=rvar, varm=rvarm)
    return adata


def write_h5ad(filename, adata: AnnData, compression=None):
    import h5py

    with h5py.File(filename, "w") as f:
        _write_adata_group(f, adata, compression)


def read_h5ad(filename, backed=None) -> AnnData:
    import h5py

    if backed:
        f = h5py.File(filename, "r")
        adata = _read_adata_group(f, backed=True)
        adata.file._h5file = f
        adata.file.filename = str(filename)
        return adata
    with h5py.File(filename, "r") as f:
        return _read_adata_group(f)


# ---------------------------------------------------------------------------
# h5mu
# ---------------------------------------------------------------------------


def write_h5mu(filename, mdata: MuData, compression=None):
    import h5py

    with h5py.File(filename, "w") as f:
        _set_enc(f, "MuData", "0.1.0")
        f.attrs["axis"] = int(mdata.axis)
        mod_g = f.create_group("mod")
        mod_g.attrs.create("mod-order", data=list(mdata.mod), dtype=_str_dtype())
        for mname, ad in mdata.mod.items():
            g = mod_g.create_group(mname)
            _write_adata_group(g, ad, compression)
        _write_df(f, "obs", mdata.obs, compression)
        _write_df(f, "var", mdata.var, compression)
        _write_mapping(f, "obsm", dict(mdata.obsm), compression)
        _write_mapping(f, "varm", dict(mdata.varm), compression)
        _write_mapping(f, "obsp", dict(mdata.obsp), compression)
        _write_mapping(f, "varp", dict(mdata.varp), compression)
        _write_mapping(f, "obsmap", dict(mdata.obsmap), compression)
        _write_mapping(f, "varmap", dict(mdata.varmap), compression)
        _write_mapping(f, "uns", mdata.uns, compression)


def read_h5mu(filename, backed=None) -> MuData:
    """Read an .h5mu file. With ``backed`` truthy ("r" or True), each
    modality's X stays on disk as a :class:`BackedMatrix` (row-selective
    reads); everything else is loaded (reference: anndata/mudata backed
    mode, muon/_core/preproc.py:655-668). The modalities share the MuData's
    open file: closing one modality's ``file`` leaves it open for the
    others, and ``mdata.file.close()`` closes it."""
    import h5py

    if backed:
        f = h5py.File(filename, "r")
        mdata = _read_h5mu_open(f, backed=True)
        mdata.file._h5file = f
        mdata.file.filename = str(filename)
        for ad in mdata.mod.values():
            ad.file._h5file = f
            ad.file.filename = str(filename)
            ad.file._shared = True  # the MuData owns the handle
        return mdata
    with h5py.File(filename, "r") as f:
        return _read_h5mu_open(f, backed=False)


def _read_h5mu_open(f, backed=False) -> MuData:
    mod_g = f["mod"]
    order = [_decode(m) for m in mod_g.attrs.get("mod-order", list(mod_g))]
    order = [m for m in order if m in mod_g]
    for m in mod_g:
        if m not in order:
            order.append(m)
    mods = {m: _read_adata_group(mod_g[m], backed=backed) for m in order}
    axis = int(f.attrs.get("axis", 0))
    mdata = MuData(mods, axis=axis)
    if "obs" in f:
        mdata._obs = _read_elem(f["obs"])
    if "var" in f:
        mdata._var = _read_elem(f["var"])
    mdata.update()
    for attr in ("obsm", "varm"):
        if attr in f:
            for k, v in _read_elem(f[attr]).items():
                if k in mdata.mod:
                    continue
                try:
                    getattr(mdata, attr)[k] = v
                except ValueError:
                    pass
    for attr in ("obsp", "varp"):
        if attr in f:
            for k, v in _read_elem(f[attr]).items():
                try:
                    getattr(mdata, attr)[k] = v
                except ValueError:
                    pass
    if "uns" in f:
        mdata._uns = _read_elem(f["uns"])
    return mdata
