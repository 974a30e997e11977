"""``mu.tl`` misc tools: ICA (counterpart of muon_tpu/_core/tools_misc.py)."""

from __future__ import annotations

__all__ = ["ica"]


def ica(
    data,
    basis: str = "X_pca",
    n_components=None,
    *,
    random_state=None,
    scale: bool = False,
    copy: bool = False,
    **kwargs,
):
    """Independent component analysis on an ``.obsm`` basis → ``X_ica``
    (reference muon/_core/tools.py:1365-1386): symmetric FastICA with the
    fixed-point step on the device (ops/ica.fastica, T32). ``kwargs`` go to
    ``fastica`` (``max_iter``, ``device``). ``X_ica`` is a float32 (n, k)
    numpy array, divided by its per-column std under ``scale``."""
    import numpy as np

    from ..ops.ica import fastica

    data = data.copy() if copy else data
    x_ica = fastica(
        np.asarray(data.obsm[basis]), n_components=n_components,
        random_state=random_state, **kwargs,
    )
    if scale:
        x_ica = x_ica / x_ica.std(axis=0)
    data.obsm["X_ica"] = x_ica
    return data if copy else None
