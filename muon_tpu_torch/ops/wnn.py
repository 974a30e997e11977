"""Single-modality neighbors (counterpart of muon_tpu/ops/wnn.py
``choose_representation`` and ``single_neighbors``).

The kNN runs through T5 (ops/knn.py) and σ, ρ and the membership values
through T6 (ops/fuzzy.py); the fuzzy union and the CSR assembly are host
work. The WNN fusion of the reference (``wnn_neighbors``) is not ported
yet (ROADMAP item 6).
"""

from __future__ import annotations

import numpy as np
from scipy import sparse as sp
from scipy.sparse import issparse

from ..utils.profiling import stage
from .device import DeviceLike
from .fuzzy import compute_connectivities_umap
from .knn import knn

__all__ = ["choose_representation", "single_neighbors"]

# above this many rows the reference's neighbors take the approximate kNN
APPROX_ROWS = 20_000


def _n_obs(adata) -> int:
    n = getattr(adata, "n_obs", None)
    return int(n) if n is not None else int(adata.X.shape[0])


def _n_vars(adata) -> int:
    n = getattr(adata, "n_vars", None)
    return int(n) if n is not None else int(adata.X.shape[1])


def _dense_X(adata) -> np.ndarray:
    X = adata.X
    if issparse(X):
        X = np.asarray(X.todense())
    return np.asarray(X, dtype=np.float32)


def _first_pcs(rep, n_pcs) -> np.ndarray:
    if n_pcs is not None and n_pcs not in (-1, 0):
        rep = rep[:, :n_pcs]
    return np.asarray(rep, dtype=np.float32)


def choose_representation(adata, use_rep=None, n_pcs=None,
                          device: DeviceLike = None) -> np.ndarray:
    """The float32 (n_obs, ·) matrix the kNN runs on (scanpy
    ``_choose_representation`` parity): ``obsm["X_pca"]`` when present,
    else a PCA of X computed now (more than 50 variables) or X itself;
    ``use_rep="X"`` or an ``obsm`` key. ``n_pcs`` cuts PCA columns."""
    if use_rep is None or use_rep == -1:
        if "X_pca" in adata.obsm:
            return _first_pcs(np.asarray(adata.obsm["X_pca"]), n_pcs)
        if _n_vars(adata) > 50:
            from .linalg import pca

            scores, *_ = pca(
                adata.X if issparse(adata.X) else np.asarray(adata.X),
                n_comps=min(50, _n_vars(adata) - 1), device=device,
            )
            adata.obsm["X_pca"] = scores.cpu().numpy()
            return _first_pcs(adata.obsm["X_pca"], n_pcs)
        return _dense_X(adata)
    if use_rep == "X":
        return _dense_X(adata)
    rep = np.asarray(adata.obsm[use_rep])
    if "pca" in str(use_rep).lower():
        return _first_pcs(rep, n_pcs)
    return np.asarray(rep, dtype=np.float32)


def single_neighbors(
    adata,
    n_neighbors: int = 15,
    use_rep=None,
    n_pcs=None,
    metric: str = "euclidean",
    key_added=None,
    random_state: int = 0,
    mesh=None,
    device: DeviceLike = None,
):
    """kNN + UMAP connectivities for one modality. Writes
    ``obsp["distances"]`` (the (n, n) CSR of the n_neighbors − 1 non-self
    distances), ``obsp["connectivities"]`` and ``uns["neighbors"]`` with the
    reference's params layout, and returns ``adata``.

    Above 20,000 rows the kNN takes the ``approx`` (bfloat16) path, as in
    the reference. ``mesh`` (multi-device) is not ported yet. No kNN tag is
    hung on the distances matrix."""
    if mesh is not None:
        raise NotImplementedError(
            "neighbors over a device mesh is not ported yet (ROADMAP item 12)"
        )
    rep = choose_representation(adata, use_rep=use_rep, n_pcs=n_pcs, device=device)
    idx_t, dists_t = knn(rep, n_neighbors - 1, metric=metric,
                         approx=rep.shape[0] > APPROX_ROWS, device=device)
    n = _n_obs(adata)
    k = idx_t.shape[1]  # n_neighbors incl. self
    with stage("neighbors/download"):
        idx = idx_t.cpu().numpy()
    conn = compute_connectivities_umap(idx, dists_t, n, k)
    with stage("neighbors/csr"):
        dists = dists_t.cpu().numpy().astype(np.float64)
        rows = np.repeat(np.arange(n), k - 1)
        dmat = sp.csr_matrix(
            (dists[:, 1:].reshape(-1), (rows, idx[:, 1:].reshape(-1))), shape=(n, n)
        )

    if key_added is None:
        key_added, conns_key, dists_key = "neighbors", "connectivities", "distances"
    else:
        conns_key, dists_key = f"{key_added}_connectivities", f"{key_added}_distances"
    adata.obsp[dists_key] = dmat
    adata.obsp[conns_key] = conn
    adata.uns[key_added] = {
        "connectivities_key": conns_key,
        "distances_key": dists_key,
        "params": {
            "n_neighbors": int(n_neighbors),
            "method": "umap",
            "random_state": random_state,
            "metric": metric,
            "use_rep": use_rep if use_rep is not None else -1,
            "n_pcs": n_pcs if n_pcs is not None else -1,
        },
    }
    return adata
