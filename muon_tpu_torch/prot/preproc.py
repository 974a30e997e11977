"""Protein preprocessing (``prot.pp``; counterpart of muon_tpu/prot/preproc.py).

Ported so far: ``clr``. ``dsb`` is not ported yet (ROADMAP item 9).
"""

from __future__ import annotations

from warnings import warn

import numpy as np
import torch
from scipy.sparse import csc_matrix, csr_matrix, issparse

from ..ops import sparse as dsp
from ..ops.dense import clr_seurat_dense
from ..ops.device import DeviceLike, resolve_device
from ..utils.profiling import stage

__all__ = ["clr"]


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
