"""Protein modality readers of the port (counterpart of muon_tpu/prot/io.py,
on the host)."""

from __future__ import annotations

from .._core import io as _io
from .._core.anndata import AnnData

__all__ = ["read_10x_h5", "read_10x_mtx"]


def _filter_prot(mdata_or_adata) -> AnnData:
    """Keep only Antibody Capture features."""
    from .._core.mudata import MuData

    if isinstance(mdata_or_adata, MuData):
        if "prot" in mdata_or_adata.mod:
            return mdata_or_adata.mod["prot"]
        adata = next(iter(mdata_or_adata.mod.values()))
    else:
        adata = mdata_or_adata
    if "feature_types" in adata.var.columns:
        mask = (adata.var["feature_types"] == "Antibody Capture").to_numpy()
        adata = adata[:, mask].copy()
    return adata


def read_10x_h5(filename: str, *args, **kwargs) -> AnnData:
    """Read 10x-h5 keeping only ``Antibody Capture`` features."""
    return _filter_prot(_io.read_10x_h5(filename, *args, **kwargs))


def read_10x_mtx(path: str, *args, **kwargs) -> AnnData:
    """Read 10x mtx directory keeping only ``Antibody Capture`` features."""
    return _filter_prot(_io.read_10x_mtx(path, *args, **kwargs))
