"""Protein preprocessing (``prot.pp``; counterpart of muon_tpu/prot/preproc.py):
``dsb`` and ``clr``.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple
from warnings import warn

import numpy as np
import torch
from scipy.sparse import csc_matrix, csr_matrix, issparse

from ..ops import sparse as dsp
from ..ops.dense import clr_seurat_dense
from ..ops.device import DeviceLike, resolve_device
from ..ops.gmm import background_means
from ..utils.profiling import stage

__all__ = ["dsb", "clr"]


def _is_mudata(obj) -> bool:
    """MuData-like: anything with modalities under ``.mod``."""
    return hasattr(obj, "mod")


def _names(obj) -> np.ndarray:
    return np.asarray(obj.obs_names)


def _log10_umi(rna, device: torch.device) -> np.ndarray:
    """log10(total RNA counts + 1) of every droplet, summed on the device (T7
    for a sparse X), in X's float type as the reference's scipy/numpy sum."""
    X = rna.X
    with stage("dsb/droplets"):
        if issparse(X):
            X = X.tocsr()
            if X.dtype == np.float32:
                sums = dsp.row_sums(dsp.from_scipy(X, device))
            else:
                sums = torch.from_numpy(np.asarray(X.sum(axis=1)).ravel()).to(device)
        else:
            sums = torch.from_numpy(np.asarray(X)).to(device).sum(dim=1)
        if not sums.is_floating_point():
            sums = sums.double()  # numpy's log10 of integers is float64
        return torch.log10(sums + 1).cpu().numpy()


def _in_range(v: np.ndarray, rng: Tuple[float, float]) -> np.ndarray:
    return (v >= min(*rng)) & (v < max(*rng))


def _dense_log(X, pseudocount, device: torch.device) -> torch.Tensor:
    """log(X + pseudocount) on the device, in numpy's result type (X's float
    type, float64 for integers)."""
    X = X.toarray() if issparse(X) else np.asarray(X)
    if X.dtype.kind != "f":
        X = X.astype(np.float64)
    return torch.log(torch.from_numpy(np.ascontiguousarray(X)).to(device) + pseudocount)


def _np_quantiles(flat_sorted: torch.Tensor, qs) -> np.ndarray:
    """np.quantile's linear rule over a sorted float tensor: the index and
    the weight in float64, b − a in the values' type, then a + (b − a)·t
    (b − (b − a)·(1 − t) from t = 0.5 on), in float64 for float32 values."""
    n = flat_sorted.numel()
    q = np.asarray(qs, dtype=np.float64)
    virt = (n - 1) * q
    prev = np.clip(np.floor(virt), 0, n - 1).astype(np.int64)
    nxt = np.clip(prev + 1, 0, n - 1)
    prev[virt >= n - 1] = n - 1
    gamma = virt - np.floor(virt)
    idx = torch.from_numpy(np.concatenate([prev, nxt])).to(flat_sorted.device)
    vals = flat_sorted[idx].cpu().numpy()
    a, b = vals[: len(q)], vals[len(q):]
    diff = np.subtract(b, a)
    out = np.add(a, diff * gamma)
    hi = gamma >= 0.5
    out[hi] = np.subtract(b, diff * (1 - gamma))[hi]
    return out


def dsb(
    data,
    data_raw=None,
    pseudocount: int = 10,
    denoise_counts: bool = True,
    isotype_controls: Optional[Iterable[str]] = None,
    empty_counts_range: Optional[Tuple[float, float]] = None,
    cell_counts_range: Optional[Tuple[float, float]] = None,
    scale_factor: str = "standardize",
    quantile_clipping: bool = False,
    quantile_clip: Tuple[float, float] = (0.001, 0.9995),
    add_layer: bool = False,
    random_state: Optional[int] = None,
    device: DeviceLike = None,
):
    """Denoised-and-Scaled-by-Background normalisation (Mulè et al. 2020),
    the contract of reference muon/_prot/preproc.py:17-224.

    Empty and cell droplets from the raw RNA log10-UMI ranges (or a given
    raw object); log(X + pseudocount), minus the empty droplets' mean and
    over their std (ddof 1, float64); per-cell background means from the
    BIC-selected 2-component GMM (``ops.gmm``, T21); optionally one whitened
    principal component of them and the isotype controls as the covariate;
    the intercept OLS that removes it; quantile clipping. The arithmetic
    runs on ``device``; the result comes back once, at the end.

    Takes AnnData-like objects (``.X``, ``.obs_names``, ``.var_names``,
    ``.layers``, ``obj[idx, :]``, ``.copy()``) and MuData-like ones (any
    object with ``.mod``; without ``data_raw`` it also needs
    ``data[obs_names, :]`` and ``.copy()``). Returns the filtered copy in
    the unfiltered-MuData case, else None.
    """
    device = resolve_device(device)
    toreturn = None
    if data_raw is None:
        if empty_counts_range is None or cell_counts_range is None:
            raise ValueError(
                "without data_raw, `data` must be the unfiltered object and "
                "both empty_counts_range and cell_counts_range are required"
            )
        if max(*empty_counts_range) > min(*cell_counts_range):
            raise ValueError(
                "empty_counts_range and cell_counts_range must not overlap"
            )
        if not _is_mudata(data) or "prot" not in data.mod or "rna" not in data.mod:
            raise TypeError(
                "without data_raw, `data` must be a MuData holding both "
                "'prot' and 'rna' modalities (the unfiltered object)"
            )
        if data.mod["rna"].n_obs != data.mod["prot"].n_obs:
            raise ValueError(
                "different numbers of cells in 'rna' and 'prot' modalities."
            )

        log10umi = _log10_umi(data.mod["rna"], device)
        with stage("dsb/droplets"):
            empty_idx = np.where(_in_range(log10umi, empty_counts_range))[0]
            cell_idx = np.where(_in_range(log10umi, cell_counts_range))[0]
            cellidx = _names(data.mod["prot"])[cell_idx]
            empty = data.mod["prot"][empty_idx, :]

            data = data[cellidx, :].copy()
            cells = data.mod["prot"]
        toreturn = data
    elif not _is_mudata(data_raw):
        empty = data_raw
    elif "prot" in data_raw.mod:
        empty = data_raw.mod["prot"]
    else:
        raise TypeError(
            "data_raw must be an AnnData or a MuData object with 'prot' modality"
        )

    if not _is_mudata(data):
        cells = data
    elif "prot" in data.mod:
        cells = data.mod["prot"]
    else:
        raise TypeError(
            "data must be an AnnData or a MuData object with 'prot' modality"
        )

    if pseudocount < 0:
        raise ValueError("pseudocount cannot be negative")

    if quantile_clipping:
        if len(quantile_clip) != 2:
            raise ValueError("quantile_clip must have exactly 2 values")
        qc = np.asarray(quantile_clip)
        if np.any((qc < 0) | (qc > 1)):
            raise ValueError("quantile_clip must be between 0 and 1")

    if cells.shape[1] != empty.shape[1]:
        raise ValueError("data and data_raw have different numbers of proteins")

    if empty_counts_range is None:  # data_raw is not None
        warn(
            "empty_counts_range values are not provided, treating all the "
            "non-cells as empty droplets"
        )
        keep = ~np.isin(_names(empty), _names(cells))
        empty = empty[np.where(keep)[0], :]
    elif data_raw is not None:
        warn(
            "empty_counts_range will be deprecated in the future versions",
            DeprecationWarning,
            stacklevel=2,
        )
        if not _is_mudata(data_raw) or "rna" not in data_raw.mod:
            warn(
                "data_raw must be a MuData object with 'rna' modality, "
                "ignoring empty_counts_range and treating all the non-cells "
                "as empty droplets"
            )
            keep = ~np.isin(_names(empty), _names(cells))
            empty = empty[np.where(keep)[0], :]
        else:
            log10umi = _log10_umi(data_raw.mod["rna"], device)
            in_range = _in_range(log10umi, empty_counts_range)
            empty_droplets = _names(data_raw.mod["rna"])[in_range]
            n_orig = len(empty_droplets)
            cellset = set(_names(cells))
            empty_droplets = np.array(
                [b for b in empty_droplets if b not in cellset]
            )
            if len(empty_droplets) != n_orig:
                warn(
                    f"Dropping {n_orig - len(empty_droplets)} empty droplets "
                    "as they are already defined as cells"
                )
            # pandas' get_indexer: -1 for a name the object lacks
            pos = {b: i for i, b in enumerate(_names(empty))}
            eidx = np.array([pos.get(b, -1) for b in empty_droplets], dtype=np.intp)
            empty = empty[eidx, :].copy()

    if data_raw is not None and cell_counts_range is not None:
        warn("cell_counts_range values are ignored since cells are provided in data")

    with stage("dsb/standardize"):
        empty_scaled = _dense_log(empty.X, pseudocount, device)
        cells_scaled = _dense_log(cells.X, pseudocount, device)
        cells_dtype = cells_scaled.dtype
        # float64 moments over the empty droplets, as the reference takes them
        # (muon/_prot/preproc.py:172-177)
        e64 = empty_scaled.double()
        cells_scaled = cells_scaled.double() - e64.mean(dim=0)
        if scale_factor == "standardize":
            cells_scaled = cells_scaled / e64.std(dim=0, correction=1)
        if cells_dtype.is_floating_point:
            cells_scaled = cells_scaled.to(cells_dtype)
        del empty_scaled, e64

    if denoise_counts:
        with stage("dsb/gmm"):
            bgmeans = background_means(
                cells_scaled.float().contiguous(),
                seed=0 if random_state is None else int(random_state), device=device,
            ).to(cells_scaled.dtype)
        with stage("dsb/ols"):
            if isotype_controls is not None:
                ctrl_idx = np.where(np.isin(np.asarray(cells.var_names),
                                            list(set(isotype_controls))))[0]
                if len(ctrl_idx) < len(list(isotype_controls)):
                    warn("Some isotype controls are not present in the data.")
                ctrl = torch.from_numpy(ctrl_idx).to(device)
                feats = torch.cat([cells_scaled[:, ctrl], bgmeans[:, None]], dim=1)
                # PCA(n_components=1, whiten=True): its sign is free, and the
                # OLS below does not depend on it
                U = torch.linalg.svd(feats - feats.mean(dim=0), full_matrices=False)[0]
                covar = U[:, :1] * np.sqrt(feats.shape[0] - 1)
            else:
                covar = bgmeans[:, None]
            # OLS with intercept; the reference subtracts the covariate's
            # effect and keeps the intercept (muon/_prot/preproc.py:211-214)
            A = torch.cat([torch.ones_like(covar), covar], dim=1)
            coef = torch.linalg.lstsq(A, cells_scaled).solution
            cells_scaled = cells_scaled - covar @ coef[1:]

    if quantile_clipping:
        with stage("dsb/clip"):
            # np.quantile promotes the bounds to float64, and np.clip the
            # values with them
            lo, hi = _np_quantiles(torch.sort(cells_scaled.reshape(-1)).values,
                                   quantile_clip)
            cells_scaled = cells_scaled.double().clamp(float(min(lo, hi)), float(max(lo, hi)))

    with stage("dsb/download"):
        out = cells_scaled.cpu().numpy()
    if add_layer:
        cells.layers["dsb"] = out
    else:
        cells.X = out
    return toreturn


def _seurat_sparse(x, axis: int, device: torch.device) -> None:
    """The seurat CLR of a sparse X in place, over its compressed axis (the
    columns of a CSC for axis 0, the rows of a CSR for axis 1): the segment
    sums of log1p(data) are T7 on the compressed arrays read as a CSR (of Xᵀ
    for a CSC), logmean = sum / n_along (zeros add log1p(0) = 0), then T8
    scales by 1 / exp(logmean) and log1p follows, all in float32."""
    n_seg = len(x.indptr) - 1
    n_along = x.shape[axis]
    nnz = int(x.indptr[-1])
    with stage("prot/upload"):
        data = torch.from_numpy(np.ascontiguousarray(x.data[:nnz], np.float32)).to(device)
        indptr = torch.from_numpy(np.ascontiguousarray(x.indptr, np.int32)).to(device)
        indices = torch.from_numpy(np.ascontiguousarray(x.indices[:nnz], np.int32)).to(device)
    with stage("prot/clr"):
        seg = dsp.DeviceCSR(torch.log1p(data), indptr, indices, n_seg,
                            x.shape[1 - axis], nnz)
        logmean = dsp.row_sums(seg) / n_along
        scaled = dsp.scale_rows_data(seg._replace(data=data), 1.0 / torch.exp(logmean))
        new = torch.log1p(scaled)
    with stage("prot/download"):
        x.data[:nnz] = new.cpu().numpy().astype(x.data.dtype)


def clr(
    adata,
    inplace: bool = True,
    axis: int = 0,
    flavor: str = "seurat",
    device: DeviceLike = None,
):
    """Centered-log-ratio normalisation, 3 flavors (reference
    muon/_prot/preproc.py:227-299):

    - ``seurat``: log1p-based, sparsity-preserving; on the device in
      float32 (a dense X through T12, a sparse one through T7 and T8);
    - ``stoeckius``: +1 pseudocount, dense geometric mean;
    - ``standard``: plain CLR (may produce −inf on zeros);

    the last two in float64 on the device, as the reference computes them.
    Takes any AnnData-like object with ``.X`` (and ``.copy()`` when not
    ``inplace``); returns the copy when not ``inplace``, else None.
    """
    if axis not in (0, 1):
        raise ValueError(
            "Invalid value for `axis` provided. Admissible options are `0` and `1`."
        )
    if not inplace:
        adata = adata.copy()
    device = resolve_device(device)

    x = adata.X

    if flavor == "seurat":
        if issparse(x):
            if axis == 0 and not isinstance(x, csc_matrix):
                warn(
                    "adata.X is sparse but not in CSC format. CSC format "
                    "required for `axis=0`. Converting to CSC."
                )
                x = x.tocsc()
            elif axis == 1 and not isinstance(x, csr_matrix):
                warn(
                    "adata.X is sparse but not in CSR format. CSR format "
                    "required for `axis=1`. Converting to CSR."
                )
                x = x.tocsr()
            _seurat_sparse(x, axis, device)
        else:
            x = clr_seurat_dense(x, axis, device)
    elif flavor in ("stoeckius", "standard"):
        if issparse(x):
            x = x.toarray()
        with stage("prot/clr"):
            xd = torch.from_numpy(np.array(x, dtype=np.float64)).to(device)
            if flavor == "stoeckius":
                xd = xd + 1
            # geometric mean along axis
            gm = torch.exp(torch.log(xd).mean(dim=axis, keepdim=True))
            x = torch.log(xd / gm).cpu().numpy()
    else:
        raise ValueError(f"Unknown flavor `{flavor}`.")

    adata.X = x
    return None if inplace else adata
