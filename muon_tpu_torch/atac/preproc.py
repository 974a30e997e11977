"""ATAC preprocessing (``ac.pp``): TF-IDF, binarize and scOpen
(counterpart of muon_tpu/atac/preproc.py).

The sparse path runs the fused TF-IDF kernel (T1, ops/sparse.tfidf_data)
over the CSR value vector and keeps the sparsity structure as it is. A
backed X (``read_h5mu(path, backed=True)``) is streamed to the device block
by block (ops/sparse.from_backed, T38) and its TF-IDF stays there, the
structure on disk (``DeviceBackedCSR``), for ``lsi`` to take. Dense
input is computed on the host in float64, as in the reference, so the
golden values of its tests hold. ``scopen`` uploads the binarised peaks as
CSR and factorises them on the device (ops/nmf.scopen_impute: T2's products,
T33's updates).
"""

from __future__ import annotations

from typing import Optional, Union
from warnings import warn

import numpy as np
from scipy.sparse import issparse

from .._core.config import resolve_mesh
from ..ops import sparse as dsp
from ..ops.device import DeviceLike
from ..utils.profiling import stage

__all__ = ["tfidf", "binarize", "scopen"]


def _get_atac(data):
    """The ATAC AnnData of ``data``: ``data.mod["atac"]`` for a MuData-like
    object (anything with ``.mod``), else ``data`` itself, which needs
    ``.X``. Duck-typed: the port's containers or any holder will do."""
    mod = getattr(data, "mod", None)
    if mod is not None:
        if "atac" in mod:
            return mod["atac"]
    elif hasattr(data, "X"):
        return data
    raise TypeError("Expected AnnData or MuData object with 'atac' modality")


def tfidf(
    data,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    scale_factor: Union[int, float, None] = 1e4,
    inplace: bool = True,
    copy: bool = False,
    from_layer: Optional[str] = None,
    to_layer: Optional[str] = None,
    mesh=None,
    device: DeviceLike = None,
):
    """TF-IDF transform of peak counts (reference muon/_atac/preproc.py:16-129).

    TF: counts normalised per cell (× scale_factor, log1p optional);
    IDF: n_cells / per-peak counts (log1p optional); returns TF·IDF.
    A sparse result is float32 CSR with the input's structure.

    ``device``: where the sparse transform runs (see ops/device.py). A
    backed sparse X becomes a ``DeviceBackedCSR``: its values on the device,
    its structure on disk; the host never holds the whole matrix.

    ``mesh`` (or ``set_options(mesh=...)``): a ``parallel.Mesh`` of more
    than one rank shards an in-memory sparse X by rows over the ranks
    (every rank passes the same X) and runs ``parallel.sharded_tfidf_data``
    on the mesh's devices (the IDF column sums all-reduced); every rank's
    result is the whole matrix, carrying its blocks for ``atac.tl.lsi``.
    """
    adata = _get_atac(data)
    mesh, device = resolve_mesh(mesh, device)
    if log_tfidf and (log_tf or log_idf):
        raise AttributeError(
            "When returning log(TF*IDF), applying neither log(TF) nor "
            "log(IDF) is possible."
        )
    if copy and not inplace:
        raise ValueError("`copy=True` cannot be used with `inplace=False`.")
    if to_layer is not None and not inplace:
        raise ValueError(
            f"`to_layer='{to_layer}'` cannot be used with `inplace=False`."
        )

    if copy:
        adata = adata.copy()

    counts = adata.X if from_layer is None else adata.layers[from_layer]

    if to_layer is not None and to_layer in adata.layers:
        warn(f"Existing layer '{to_layer}' will be overwritten")

    if getattr(counts, "_sparse", False) and hasattr(counts, "_h5"):
        dX = dsp.from_backed(counts, device=device)
        with stage("sparse/tfidf"):
            new_data = dsp.tfidf_data(
                dX, log_tf=log_tf, log_idf=log_idf, log_tfidf=log_tfidf,
                scale_factor=scale_factor,
            )
        res = dsp.DeviceBackedCSR(counts._h5, dX._replace(data=new_data))
    elif issparse(counts) and mesh is not None:
        from ..parallel.pipeline import (shard_rows, sharded_tfidf_data,
                                         sharded_values_to_scipy)

        X = counts.tocsr()
        Xs = sharded_tfidf_data(
            shard_rows(X, mesh), log_tf=log_tf, log_idf=log_idf, log_tfidf=log_tfidf,
            scale_factor=scale_factor,
        )
        res = sharded_values_to_scipy(Xs, X)
    elif issparse(counts):
        X = counts.tocsr()
        dX = dsp.from_scipy(X, device)
        with stage("sparse/tfidf"):
            new_data = dsp.tfidf_data(
                dX, log_tf=log_tf, log_idf=log_idf, log_tfidf=log_tfidf,
                scale_factor=scale_factor,
            )
        res = dsp.to_scipy_data(X, new_data)
    else:
        # dense input: host float64, for parity with the reference's numpy
        # path (golden values in tests/test_atac_preproc.py)
        Xd = np.asarray(counts, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            tf = Xd / Xd.sum(axis=1, keepdims=True)
        tf = np.nan_to_num(tf)
        if scale_factor is not None and scale_factor not in (0, 1):
            tf = tf * scale_factor
        if log_tf:
            tf = np.log1p(tf)
        with np.errstate(divide="ignore", invalid="ignore"):
            idf = Xd.shape[0] / Xd.sum(axis=0, keepdims=True)
        if log_idf:
            idf = np.log1p(idf)
        res = tf * idf
        if log_tfidf:
            res = np.log1p(res)
        res = np.nan_to_num(res, nan=0.0)

    if not inplace:
        return res
    if to_layer is not None:
        adata.layers[to_layer] = res
    else:
        adata.X = res
    if copy:
        return adata
    return None


def binarize(data, inplace: bool = True, copy: bool = False):
    """Make nonzero counts 1 (reference muon/_atac/preproc.py:132-152).
    Host-only, as in the JAX package."""
    adata = _get_atac(data)
    if copy and not inplace:
        raise ValueError("`copy=True` cannot be used with `inplace=False`.")
    if copy:
        adata = adata.copy()
    if issparse(adata.X):
        if inplace or copy:
            adata.X.data = (adata.X.data != 0).astype(adata.X.data.dtype)
        else:
            X = adata.X.copy()
            X.data = (X.data != 0).astype(X.data.dtype)
            return X
    else:
        if inplace or copy:
            adata.X = (np.asarray(adata.X) != 0).astype(np.float32)
        else:
            return (np.asarray(adata.X) != 0).astype(np.float32)
    if copy:
        return adata
    return None


def scopen(data, *args, **kwargs):
    """Bounded-NMF imputation of binarised peaks (reference
    muon/_atac/preproc.py:155-236) on the ATAC modality of ``data``; the
    arguments are those of ``ops.nmf.scopen_impute`` (``device`` among
    them)."""
    from ..ops.nmf import scopen_impute

    return scopen_impute(_get_atac(data), *args, **kwargs)
