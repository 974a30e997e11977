"""ATAC tools (``ac.tl``): LSI (counterpart of muon_tpu/atac/tools.py ``lsi``).

LSI is a randomized truncated SVD of the TF-IDF matrix on the device
(ops/linalg.randomized_svd), in place of the reference's ARPACK ``svds``
(muon/_atac/tools.py:53).
"""

from __future__ import annotations

import numpy as np

from ..ops.device import DeviceLike
from ..ops.linalg import randomized_svd
from ..utils.profiling import stage
from .preproc import _get_atac

__all__ = ["lsi"]


def lsi(
    data,
    scale_embeddings: bool = True,
    n_comps: int = 50,
    n_iter: int = 7,
    random_state: int = 0,
    mesh=None,
    device: DeviceLike = None,
):
    """Latent Semantic Indexing (semantics of reference
    muon/_atac/tools.py:29-71: components in descending order, embeddings
    optionally z-scored, stdev = s/√(n−1)).

    Writes ``obsm["X_lsi"]``, ``varm["LSI"]``, ``uns["lsi"]["stdev"]``.
    ``mesh`` (multi-device) is not ported yet.
    """
    adata = _get_atac(data)
    if mesh is not None:
        raise NotImplementedError(
            "lsi over a device mesh is not ported yet (ROADMAP queue 1 item 9)"
        )
    n_comps = min(n_comps, adata.X.shape[1])
    U, s, Vt = randomized_svd(
        adata.X, k=n_comps, n_iter=n_iter, seed=random_state, device=device
    )
    with stage("lsi/host"):
        U = U.cpu().numpy()
        s = s.cpu().numpy()
        Vt = Vt.cpu().numpy()

        # the reference stores the (unit-norm) left singular vectors, then
        # z-scores them
        cell_embeddings = U
        if scale_embeddings:
            cell_embeddings = (
                cell_embeddings - cell_embeddings.mean(axis=0)
            ) / cell_embeddings.std(axis=0)

        stdev = s / np.sqrt(adata.X.shape[0] - 1)

        adata.obsm["X_lsi"] = cell_embeddings
        adata.uns["lsi"] = {"stdev": stdev}
        adata.varm["LSI"] = Vt.T
    return None
