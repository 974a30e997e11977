"""Preprocessing (``mu.pp``): PCA, neighbors, the L2 norm and the in-place
filters (counterpart of muon_tpu/_core/preproc.py ``pca``, ``neighbors``,
``l2norm``, ``filter_obs``, ``filter_var``, ``intersect_obs`` and
``sample_obs``).

The tools take any AnnData-like object (``.X``, ``.obsm``, ``.varm``,
``.uns``, ``.obsp``, ``.layers``; ``.var`` is read only when present). A
MuData-like object (anything with ``.mod``) is refused where the reference
refuses it; ``neighbors`` of one runs WNN (ops/wnn.wnn_neighbors).
``l2norm`` runs on the host, as the reference's does (scipy for a sparse X,
numpy for a dense one); the device's row normalisation is
``ops.dense.l2norm_dense`` (T35), which neither package's ``l2norm`` calls.
The filters are host bookkeeping on the port's containers (``AnnData``,
``MuData``); a backed object is refused, as the containers refuse it.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional

import numpy as np

from ..ops.device import DeviceLike
from ..ops.linalg import pca as _pca_op
from ..ops.wnn import _n_vars, single_neighbors, wnn_neighbors
from .aligned import _is_frame
from .anndata import not_ported

__all__ = [
    "pca",
    "neighbors",
    "l2norm",
    "intersect_obs",
    "filter_obs",
    "filter_var",
    "sample_obs",
]


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


# ---------------------------------------------------------------------------
# in-place filtering (muon_tpu/_core/preproc.py:39-236)
# ---------------------------------------------------------------------------


def _resolve_filter_mask(data, attr, key, func):
    """Resolve (key, func) into a boolean keep-mask along `attr`."""
    from scipy import sparse as sp

    df = getattr(data, attr)
    names = getattr(data, f"{attr}_names")
    other = "obs" if attr == "var" else "var"
    other_names = getattr(data, f"{other}_names")

    if isinstance(key, str):
        if key in df.columns:
            if func is None:
                if df[key].dtype == bool:
                    func = lambda x: x  # noqa: E731
                else:
                    raise ValueError(
                        f"Function has to be provided since {key} is not boolean"
                    )
            subset = func(df[key].to_numpy())
        elif key in other_names:
            j = np.flatnonzero(other_names == key)
            X = data.X
            col = X[:, j] if attr == "obs" else X[j, :]
            if sp.issparse(col):
                col = np.asarray(col.todense())
            subset = func(np.asarray(col).reshape(-1))
        else:
            raise ValueError(
                f"Column name from .{attr} or one of the {other}_names was "
                f"expected but got {key}."
            )
    else:
        if func is not None:
            raise ValueError(
                f"When providing {attr}_names directly, func has to be None."
            )
        key = np.asarray(key)
        if key.ndim != 1:
            raise ValueError(
                f"filter key must be a column name, a sequence of names, or a "
                f"1-D boolean mask; got {key!r}"
            )
        if key.dtype == bool:
            subset = key
        else:
            subset = np.asarray(names.isin(key))
    subset = np.asarray(subset)
    if subset.dtype != bool:
        raise ValueError("filter predicate must produce a boolean mask")
    return subset


def _filter_attr(data, attr, key, func=None):
    if data.is_view:
        raise ValueError(
            "The provided object is a view. In-place filtering does not "
            "operate on views."
        )
    if data.isbacked:
        raise not_ported(f"filter_{attr} of a backed object")

    mask = _resolve_filter_mask(data, attr, key, func)

    if not _is_mudata(data):
        if attr == "obs":
            data._inplace_subset_obs(mask)
        else:
            data._inplace_subset_var(mask)
        return

    # ---- MuData branch ----------------------------------------------------
    idx = np.flatnonzero(mask)
    df = getattr(data, attr)
    setattr(data, f"_{attr}", df.iloc[idx].copy())

    attrm = getattr(data, f"{attr}m")
    attrp = getattr(data, f"{attr}p")
    new_m = {k: (v.iloc[idx] if _is_frame(v) else np.asarray(v)[idx])
             for k, v in attrm.items() if k not in data.mod}
    new_p = {k: v[idx][:, idx] for k, v in attrp.items()}

    attrmap = getattr(data, f"{attr}map")
    new_maps = {}
    new_masks = {}
    for mname, ad in data.mod.items():
        sub_map = attrmap[mname][idx].astype(np.int64)
        present = sub_map > 0
        local_keep = sub_map[present] - 1  # positions in mod, global order
        keep_sorted = np.sort(local_keep)  # modality keeps its own order
        if attr == "obs":
            ad._inplace_subset_obs(keep_sorted)
        else:
            ad._inplace_subset_var(keep_sorted)
        # re-rank: new 1-based local position for every kept global row
        rank = np.empty(local_keep.size, dtype=np.int64)
        rank[np.argsort(local_keep, kind="stable")] = np.arange(1, local_keep.size + 1)
        out_map = np.zeros(sub_map.size, dtype=np.uint32)
        out_map[present] = rank
        new_maps[mname] = out_map
        new_masks[mname] = present
    attrmap.clear()
    attrmap.update(new_maps)

    # rebuild aligned dicts against the new axis length
    am = getattr(data, f"_{attr}m_dict")
    am._data.clear()
    for k, v in new_masks.items():
        am[k] = v
    for k, v in new_m.items():
        try:
            am[k] = v
        except ValueError:
            pass
    ap = getattr(data, f"_{attr}p_dict")
    ap._data.clear()
    for k, v in new_p.items():
        try:
            ap[k] = v
        except ValueError:
            pass


def filter_obs(data, var, func=None) -> None:
    """Filter observations in place using any column in .obs, a var_name's
    values in .X, obs_names, or a boolean mask (reference
    muon/_core/preproc.py:834-856)."""
    _filter_attr(data, "obs", var, func)


def filter_var(data, var, func=None) -> None:
    """Filter variables in place (reference muon/_core/preproc.py:859-881)."""
    _filter_attr(data, "var", var, func)


def intersect_obs(mdata) -> None:
    """Subset observations in place to those present in all modalities
    (reference muon/_core/preproc.py:646-669)."""
    if mdata.isbacked:
        raise not_ported("intersect_obs of a backed MuData")
    common_obs = reduce(np.intersect1d, [m.obs_names for m in mdata.mod.values()])
    for mod in mdata.mod:
        filter_obs(mdata.mod[mod], common_obs)
    mdata.update_obs()


def sample_obs(data, frac: float = 0.1, groupby: Optional[str] = None,
               min_n: Optional[int] = None, random_state=None):
    """Subsample observations, optionally stratified by a categorical .obs
    column; returns a view (reference muon/_core/preproc.py:887-931).
    ``random_state`` seeds the draw (``np.random.default_rng``), as in the
    JAX package."""
    import pandas as pd

    rng = np.random.default_rng(random_state)
    if groupby is None:
        new_n = int(np.ceil(data.n_obs * frac))
        if min_n is not None and new_n < min_n:
            new_n = min_n
        obs_indices = rng.choice(data.n_obs, size=new_n, replace=False)
        return data[obs_indices]
    if groupby not in data.obs:
        raise ValueError(f"{groupby} is not in .obs")
    if not isinstance(data.obs[groupby].dtype, pd.CategoricalDtype):
        raise TypeError(f".obs['{groupby}'] is not categorical")
    obs_names = []
    for cat in data.obs[groupby].cat.categories:
        view = data[(data.obs[groupby] == cat).to_numpy()]
        new_n = int(np.ceil(view.n_obs * frac))
        if min_n is not None and new_n < min_n:
            new_n = min_n
        obs_names.append(rng.choice(view.obs_names.to_numpy(), size=new_n, replace=False))
    return data[np.concatenate(obs_names)]
