"""Readers and writers of the port: h5ad / h5mu / 10x Genomics formats
(counterpart of muon_tpu/_core/io.py, on the host).

``read`` and ``write`` take in-file subpaths such as ``"file.h5mu/rna"``.
h5py, pandas and scipy.io are imported inside the functions that need them:
importing the port must not need h5py or pandas.
"""

from __future__ import annotations

import gzip
import os
from pathlib import Path

import numpy as np
from scipy import sparse as sp

from .anndata import AnnData
from .h5io import (
    _read_adata_group, _write_adata_group, read_h5ad, read_h5mu, write_h5ad, write_h5mu,
)
from .mudata import MuData

__all__ = [
    "read",
    "write",
    "read_h5ad",
    "read_h5mu",
    "write_h5ad",
    "write_h5mu",
    "read_10x_h5",
    "read_10x_mtx",
    "read_anndata_10x_h5",
]


def _str(v) -> str:
    return v.decode() if isinstance(v, bytes) else str(v)


def _gex_only(adata: AnnData) -> AnnData:
    if "feature_types" in adata.var.columns:
        return adata[:, (adata.var["feature_types"] == "Gene Expression").to_numpy()].copy()
    return adata


# ---------------------------------------------------------------------------
# 10x HDF5 (CellRanger v3+ format)
# ---------------------------------------------------------------------------


def read_anndata_10x_h5(filename, gex_only: bool = False) -> AnnData:
    """Read a CellRanger .h5 feature-barcode matrix into a single AnnData.

    Layout: ``/matrix`` CSC of shape (n_features, n_barcodes) with a
    ``features`` subgroup (id/name/feature_type/genome[/interval])."""
    import h5py
    import pandas as pd

    with h5py.File(filename, "r") as f:
        if "matrix" not in f:
            raise ValueError(f"{filename} is not a CellRanger v3 h5 file")
        g = f["matrix"]
        shape = tuple(int(x) for x in g["shape"][...])  # (n_features, n_barcodes)
        M = sp.csc_matrix((g["data"][...], g["indices"][...], g["indptr"][...]), shape=shape)
        X = M.T.tocsr()  # obs (barcodes) x var (features)
        barcodes = np.array([_str(b) for b in g["barcodes"][...]])
        feat = g["features"]
        var = pd.DataFrame(index=pd.Index([_str(v) for v in feat["name"][...]], name=None))
        var["gene_ids"] = [_str(v) for v in feat["id"][...]]
        var["feature_types"] = [_str(v) for v in feat["feature_type"][...]]
        for col in ("genome", "interval"):
            if col in feat:
                var[col] = [_str(v) for v in feat[col][...]]
        adata = AnnData(X=X, obs=pd.DataFrame(index=pd.Index(barcodes)), var=var)
        adata.var_names_make_unique()
        return _gex_only(adata) if gex_only else adata


def read_10x_h5(filename, extended: bool = True, *args, **kwargs) -> MuData:
    """Read 10x h5 into a MuData split by feature type (the ``interval`` var
    column is kept so ATAC peak coordinates survive)."""
    mdata = MuData(read_anndata_10x_h5(filename, gex_only=False))
    if extended:
        _initialise_default_files(mdata, filename)
    return mdata


def _initialise_default_files(data, path) -> None:
    """Locate the CellRanger sidecar files next to ``path`` where it can,
    as the reference's readers do (any failure leaves ``data`` as read)."""
    try:
        from ..atac.tools import initialise_default_files

        initialise_default_files(data, path)
    except Exception:
        pass


# ---------------------------------------------------------------------------
# 10x MTX directory
# ---------------------------------------------------------------------------


def _open_maybe_gz(path):
    p = str(path)
    if os.path.exists(p + ".gz"):
        return gzip.open(p + ".gz", "rt")
    return open(p, "rt")


def read_anndata_10x_mtx(path, gex_only: bool = False) -> AnnData:
    import pandas as pd
    from scipy.io import mmread

    path = Path(path)
    mtx = path / "matrix.mtx"
    mtx_file = str(mtx) + ".gz" if (path / "matrix.mtx.gz").exists() else str(mtx)
    M = mmread(mtx_file).tocsr()
    feat_file = "features.tsv" if (path / "features.tsv").exists() or (
        path / "features.tsv.gz"
    ).exists() else "genes.tsv"
    with _open_maybe_gz(path / feat_file) as fh:
        feats = pd.read_csv(fh, sep="\t", header=None)
    with _open_maybe_gz(path / "barcodes.tsv") as fh:
        barcodes = pd.read_csv(fh, sep="\t", header=None)[0].astype(str).to_numpy()
    X = M.T.tocsr()
    var = pd.DataFrame(index=pd.Index(feats[1].astype(str) if feats.shape[1] > 1
                                      else feats[0].astype(str)))
    var["gene_ids"] = feats[0].astype(str).to_numpy()
    if feats.shape[1] > 2:
        var["feature_types"] = feats[2].astype(str).to_numpy()
    if feats.shape[1] > 5:
        var["interval"] = (
            feats[3].astype(str) + ":" + feats[4].astype(str) + "-" + feats[5].astype(str)
        ).to_numpy()
    adata = AnnData(X=X, obs=pd.DataFrame(index=pd.Index(barcodes)), var=var)
    adata.var_names_make_unique()
    return _gex_only(adata) if gex_only else adata


def read_10x_mtx(path, extended: bool = True, *args, **kwargs) -> MuData:
    """Read a 10x mtx directory into MuData."""
    mdata = MuData(read_anndata_10x_mtx(path, gex_only=False))
    if extended:
        _initialise_default_files(mdata, path)
    return mdata


# ---------------------------------------------------------------------------
# generic read/write dispatch
# ---------------------------------------------------------------------------


def _split_h5mu(path: str):
    """``"dir/file.h5mu/rna"`` → ``("dir/file.h5mu", "rna")``."""
    base, _, sub = path.partition(".h5mu")
    return base + ".h5mu", sub.lstrip("/")


def read(path, backed=None):
    """Read .h5mu / .h5ad, with optional in-file subpath:
    ``read("file.h5mu/rna")`` returns just that modality."""
    p = str(path)
    if ".h5mu" in p:
        fname, sub = _split_h5mu(p)
        if sub:
            import h5py

            with h5py.File(fname, "r") as f:
                return _read_adata_group(f["mod"][sub])
        return read_h5mu(fname, backed=backed)
    if p.endswith(".h5ad"):
        return read_h5ad(p, backed=backed)
    raise ValueError(f"unknown file format: {path}")


def write(path, data=None):
    """Write MuData (.h5mu), AnnData (.h5ad), or a single modality into an
    existing .h5mu via ``write("file.h5mu/rna", adata)``."""
    p = str(path)
    if ".h5mu" in p:
        fname, sub = _split_h5mu(p)
        if sub:
            if not isinstance(data, AnnData):
                raise TypeError("writing a subpath requires an AnnData")
            import h5py

            with h5py.File(fname, "a" if os.path.exists(fname) else "w") as f:
                mod = f.require_group("mod")
                if sub in mod:
                    del mod[sub]
                _write_adata_group(mod.create_group(sub), data)
            return
        if not isinstance(data, MuData):
            raise TypeError(".h5mu requires a MuData object")
        return write_h5mu(fname, data)
    if p.endswith(".h5ad"):
        if isinstance(data, MuData):
            raise TypeError(".h5ad requires an AnnData object")
        return write_h5ad(p, data)
    raise ValueError(f"unknown file format: {path}")
