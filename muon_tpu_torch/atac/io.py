"""ATAC readers of the port (``ac.read_10x_h5``, ``ac.read_10x_mtx``,
``ac.read_snap``; counterpart of muon_tpu/atac/io.py, on the host). h5py and
pandas are imported inside the functions."""

from __future__ import annotations

import numpy as np

from .._core.anndata import AnnData
from .._core.io import _initialise_default_files, read_anndata_10x_h5, read_anndata_10x_mtx

__all__ = ["read_10x_h5", "read_10x_mtx", "read_snap"]


def _peaks_only(adata: AnnData) -> AnnData:
    if "feature_types" in adata.var.columns:
        return adata[:, (adata.var["feature_types"] == "Peaks").to_numpy()].copy()
    return adata


def read_10x_h5(filename, *args, **kwargs) -> AnnData:
    """Read 10x h5 keeping only Peaks features and locating CellRanger
    sidecar files."""
    adata = _peaks_only(read_anndata_10x_h5(filename))
    _initialise_default_files(adata, filename)
    return adata


def read_10x_mtx(path, *args, **kwargs) -> AnnData:
    """Read 10x mtx keeping only Peaks features."""
    return _peaks_only(read_anndata_10x_mtx(path))


def _snap_matrix(f, filename, matrix: str):
    """The var frame and 1-based COO triplets of ``matrix`` (PM, GM, AM<bin>)."""
    import pandas as pd

    if matrix == "PM":
        if "PM" not in f:
            raise ValueError(f"No peak matrix (PM) in {filename}")
        chrom = [c.decode() for c in f["PM/peakChrom"][:]]
        start = np.asarray(f["PM/peakStart"][:])
        end = np.asarray(f["PM/peakEnd"][:])
        var = pd.DataFrame(
            {"Chromosome": chrom, "Start": start, "End": end},
            index=[f"{c}:{s}-{e}" for c, s, e in zip(chrom, start, end)],
        )
        g = f["PM"]
    elif matrix == "GM":
        if "GM" not in f:
            raise ValueError(f"No gene matrix (GM) in {filename}")
        var = pd.DataFrame(index=[n.decode() for n in f["GM/name"][:]])
        g = f["GM"]
    elif matrix.startswith("AM") or matrix.isdigit():
        if "AM" not in f:
            raise ValueError(f"No cells-by-bins matrix (AM) in {filename}")
        bin_sizes = list(f["AM"].keys())
        bs = matrix[2:] or (matrix if matrix.isdigit() else "")
        if not bs:
            bs = bin_sizes[0]
        if str(bs) not in bin_sizes:
            raise ValueError(f"Bin size {bs} not in {filename} (available: {bin_sizes})")
        g = f[f"AM/{bs}"]
        chrom = [c.decode() for c in g["binChrom"][:]]
        start = np.asarray(g["binStart"][:])
        var = pd.DataFrame({"Chromosome": chrom, "Start": start},
                           index=[f"{c}:{s}" for c, s in zip(chrom, start)])
    else:
        raise ValueError(f"Unknown matrix {matrix!r}; use PM, GM, or AM<binsize>")
    return var, g["idx"][:], g["idy"][:], g["count"][:]


def read_snap(filename, matrix: str = "PM") -> AnnData:
    """Read a .snap (snaptools) HDF5 file into AnnData: the PM (peaks), GM
    (genes) or AM (bins) matrix from its COO triplets, and the barcode
    metadata of /BD."""
    import h5py
    import pandas as pd
    from scipy.sparse import coo_matrix

    with h5py.File(filename, "r") as f:
        if "BD" not in f:
            raise ValueError(f"{filename} does not look like a .snap file (no /BD)")
        barcodes = [b.decode() if isinstance(b, bytes) else str(b) for b in f["BD/name"][:]]
        obs = pd.DataFrame(index=pd.Index(barcodes, name="barcode"))
        for key in f["BD"].keys():  # barcode QC columns
            if key == "name":
                continue
            try:
                obs[key] = np.asarray(f[f"BD/{key}"][:])
            except Exception:
                pass
        var, idx, idy, count = _snap_matrix(f, filename, matrix.upper())

    # snap stores 1-based indices
    X = coo_matrix(
        (count, (np.asarray(idx) - 1, np.asarray(idy) - 1)),
        shape=(obs.shape[0], var.shape[0]),
        dtype=np.float32,
    ).tocsr()
    return AnnData(X=X, obs=obs, var=var)
