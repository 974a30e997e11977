"""Preprocessing (``mu.pp``): PCA, neighbors and the L2 norm (counterpart of
muon_tpu/_core/preproc.py ``pca``, ``neighbors`` and ``l2norm``).

The tools take any AnnData-like object (``.X``, ``.obsm``, ``.varm``,
``.uns``, ``.obsp``, ``.layers``; ``.var`` is read only when present). A
MuData-like object (anything with ``.mod``) is refused where the reference
refuses it; ``neighbors`` of one runs WNN (ops/wnn.wnn_neighbors).
``l2norm`` runs on the host, as the reference's does (scipy for a sparse X,
numpy for a dense one); the device's row normalisation is
``ops.dense.l2norm_dense`` (T35), which neither package's ``l2norm`` calls.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.device import DeviceLike
from ..ops.linalg import pca as _pca_op
from ..ops.wnn import _n_vars, single_neighbors, wnn_neighbors

__all__ = ["pca", "neighbors", "l2norm"]


def _is_mudata(data) -> bool:
    return getattr(data, "mod", None) is not None


def pca(
    data,
    n_comps: int = 50,
    use_highly_variable: bool = False,
    layer=None,
    zero_center: bool = True,
    random_state: int = 0,
    device: DeviceLike = None,
):
    """PCA on the device (ops/linalg.pca: randomized subspace iteration,
    implicit centring for sparse input). Writes ``obsm["X_pca"]``,
    ``varm["PCs"]`` (zeros outside the highly-variable mask) and
    ``uns["pca"]["variance"/"variance_ratio"/"params"]`` (scanpy layout)."""
    if _is_mudata(data):
        raise TypeError(
            "Run pca per modality (e.g. mu.pp.pca(mdata.mod['rna']))"
        )
    adata = data
    X = adata.X if layer is None else adata.layers[layer]
    mask = None
    var = getattr(adata, "var", None)
    if use_highly_variable and "highly_variable" in getattr(var, "columns", ()):
        mask = np.asarray(var["highly_variable"]).astype(bool)
        X = X[:, mask]

    n_comps = min(n_comps, min(X.shape) - (1 if zero_center else 0))
    scores, loadings, ev, evr = _pca_op(
        X, n_comps=n_comps, center=zero_center, seed=random_state, device=device
    )
    adata.obsm["X_pca"] = scores.cpu().numpy()
    PCs = np.zeros((_n_vars(adata), n_comps))
    if mask is not None:
        PCs[mask] = loadings.cpu().numpy()
    else:
        PCs[:] = loadings.cpu().numpy()
    adata.varm["PCs"] = PCs
    adata.uns["pca"] = {
        "variance": ev.cpu().numpy(),
        "variance_ratio": evr.cpu().numpy(),
        "params": {
            "n_comps": int(n_comps),
            "zero_center": bool(zero_center),
            "use_highly_variable": bool(use_highly_variable),
        },
    }
    return None


def neighbors(
    mdata,
    n_neighbors: Optional[int] = None,
    n_bandwidth_neighbors: int = 20,
    n_multineighbors: int = 200,
    neighbor_keys: Optional[dict] = None,
    metric: str = "euclidean",
    low_memory: Optional[bool] = None,
    key_added: Optional[str] = None,
    weight_key: Optional[str] = "mod_weight",
    add_weights_to_modalities: bool = False,
    eps: float = 1e-4,
    copy: bool = False,
    random_state: Optional[int] = 42,
    use_rep: Optional[str] = None,
    n_pcs: Optional[int] = None,
    mesh=None,
    device: DeviceLike = None,
):
    """Neighbors. Of a MuData-like object (``.mod``, ``.obsmap``, ``.n_obs``,
    ``.obs``, ``.obsp``, ``.uns``): the WNN fusion of its modalities' own
    neighbor graphs (ops/wnn.wnn_neighbors), with the reference's
    parameters and keys; returns the copy under ``copy``, else None. Of
    one modality (the reference's AnnData branch): kNN on the device, UMAP
    connectivities, ``obsp``/``uns`` in scanpy's layout; returns the
    object."""
    if _is_mudata(mdata):
        return wnn_neighbors(
            mdata, n_neighbors=n_neighbors,
            n_bandwidth_neighbors=n_bandwidth_neighbors,
            n_multineighbors=n_multineighbors, neighbor_keys=neighbor_keys,
            metric=metric, low_memory=low_memory, key_added=key_added,
            weight_key=weight_key,
            add_weights_to_modalities=add_weights_to_modalities, eps=eps,
            copy=copy, random_state=random_state, use_rep=use_rep,
            n_pcs=n_pcs, mesh=mesh, device=device,
        )
    return single_neighbors(
        mdata, n_neighbors=n_neighbors or 15, metric=metric,
        use_rep=use_rep, n_pcs=n_pcs, key_added=key_added,
        random_state=random_state or 0, mesh=mesh, device=device,
    )


def _l2norm_inplace(X, n_dims=None):
    """The rows of X over their L2 norms (a zero norm taken as 1): a sparse X
    keeps its format; a dense one is float64 if it was, else float32, cut to
    its first ``n_dims`` columns when given."""
    from scipy import sparse as sp
    from scipy.sparse.linalg import norm as sparse_norm

    if sp.issparse(X):
        norms = sparse_norm(X, axis=1)
        norms[norms == 0] = 1.0
        inv = sp.dia_matrix((1.0 / norms, 0), shape=(X.shape[0], X.shape[0]))
        return (inv @ X).asformat(X.format)
    X = np.asarray(X, dtype=np.float64 if X.dtype == np.float64 else np.float32)
    if n_dims is not None and n_dims > 0:
        X = X[:, :n_dims]
    norms = np.linalg.norm(X, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    return X / norms


def l2norm(mdata, mod=None, rep=None, n_pcs=0, copy: bool = False):
    """Normalise observations to unit L2 norm, on X or an ``.obsm`` rep
    (reference muon/_core/preproc.py:179-261). ``rep`` names an ``.obsm`` key
    or its ``X_``-less form; a PCA rep is cut to its first ``n_pcs`` columns.
    On a MuData-like object it runs per modality (``mod``: one, several, or
    all), with ``rep`` and ``n_pcs`` one for all or one per modality."""
    if not _is_mudata(mdata):
        adata = mdata.copy() if copy else mdata
        if rep is not None and not isinstance(rep, str):
            rep = list(rep)[0]
        if n_pcs is not None and not isinstance(n_pcs, (int, np.integer)):
            n_pcs = list(n_pcs)[0]
        if rep is None or rep == "X":
            adata.X = _l2norm_inplace(adata.X)
        else:
            key = rep if rep in adata.obsm else f"X_{rep}"
            if key not in adata.obsm:
                raise KeyError(f"representation {rep!r} not found in .obsm")
            n_dims = n_pcs if (n_pcs and "pca" in key.lower()) else None
            adata.obsm[key] = _l2norm_inplace(np.asarray(adata.obsm[key]), n_dims)
        return adata if copy else None

    mdata = mdata.copy() if copy else mdata
    mods = [mod] if isinstance(mod, str) else (list(mod) if mod is not None
                                               else list(mdata.mod))
    if rep is None or isinstance(rep, str):
        reps = {m: rep for m in mods}
    else:
        reps = dict(zip(mods, rep))
    if n_pcs is None or isinstance(n_pcs, (int, np.integer)):
        npcs = {m: n_pcs for m in mods}
    else:
        npcs = dict(zip(mods, n_pcs))
    for m in mods:
        l2norm(mdata.mod[m], rep=reps.get(m), n_pcs=npcs.get(m), copy=False)
    return mdata if copy else None
