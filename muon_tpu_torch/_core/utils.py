"""Cross-modality value resolver of the port (counterpart of
muon_tpu/_core/utils.py, on the host).

The key grammar of the reference (muon/_core/utils.py:15-205): global
``.obs`` column, ``var_name`` (searched across modalities with raw/layer
fallbacks), ``mod:key``, ``obsm_key:1`` (1-based component),
``mod:obsm_key:1``, with obsmap-based reindexing of per-modality vectors
onto the global obs axis. A key is first classified into a ``_KeyRef``
(obs column / obsm component / modality-prefixed / feature), then a per-kind
reader materializes the vector. pandas is imported inside the function that
builds a frame.
"""

from __future__ import annotations

import warnings
from typing import Iterable, Optional, Union

import numpy as np
from scipy.sparse import issparse

from .anndata import AnnData
from .mudata import MuData

__all__ = ["_get_values", "get_values"]


def _spread_to_global(vec, positions):
    """Place a per-modality vector onto the global obs axis.

    ``positions`` is the container's 1-based obsmap (0 marks obs absent
    from the modality); absent slots are NaN-filled. One vectorized
    gather — the reference walks the map element-wise
    (muon/_core/utils.py:58-63)."""
    if positions is None:
        return vec
    pos = np.asarray(positions, dtype=np.int64)
    vec = np.asarray(vec)
    if vec.dtype.kind == "f":
        filled = np.full(pos.shape[0], np.nan, dtype=vec.dtype)
    elif vec.dtype.kind in "iu":
        filled = np.full(pos.shape[0], np.nan, dtype=np.float64)
    else:
        filled = np.full(pos.shape[0], np.nan, dtype=object)
    have = pos > 0
    filled[have] = vec[pos[have] - 1]
    return filled


def _densify_column(col):
    if issparse(col):
        col = np.asarray(col.todense()).squeeze()
    return np.asarray(col).reshape(-1)


# --- key classification ----------------------------------------------------


class _KeyRef:
    """A classified key: ``kind`` ∈ {"obs", "obsm", "mod", "feature"}."""

    __slots__ = ("kind", "name", "column", "submod", "subkey")

    def __init__(self, kind, name=None, column=None, submod=None, subkey=None):
        self.kind = kind
        self.name = name
        self.column = column  # 1-based component for kind == "obsm"
        self.submod = submod  # modality name for kind == "mod"
        self.subkey = subkey  # remainder key for kind == "mod"


def _classify(container, key: str) -> _KeyRef:
    """Decide what a key refers to, in contract order.

    Order (each step only fires when the earlier ones did not):
    1. a ``.obs`` column of the container itself;
    2. ``mod:rest`` when the container is a MuData, the whole key is not
       itself a var_name or obsm entry, and the prefix names a modality;
    3. ``basis:i`` when the stem is an obsm entry and ``i`` parses as an
       integer (1-based; 0 is rejected);
    4. otherwise a feature (var_name) lookup.
    """
    if key in container.obs.columns:
        return _KeyRef("obs", name=key)

    is_feature_name = key in container.var_names
    if (
        isinstance(container, MuData)
        and ":" in key
        and not is_feature_name
        and key not in container.obsm
    ):
        prefix, rest = key.split(":", 1)
        if prefix in container.mod:
            return _KeyRef("mod", submod=prefix, subkey=rest)

    if ":" in key and not is_feature_name:
        stem, tail = key.rsplit(":", 1)
        if stem in container.obsm:
            try:
                comp = int(tail)
            except ValueError:
                comp = None
            if comp == 0:
                raise ValueError(
                    ".obsm components are 1-based by convention — use "
                    f"'{stem}:1' for the first column."
                )
            if comp is not None:
                return _KeyRef("obsm", name=stem, column=comp)

    return _KeyRef("feature", name=key)


# --- per-kind readers --------------------------------------------------------


def _read_feature_anndata(adata: AnnData, key: str, use_raw, layer):
    """Pull one feature column out of an AnnData, honoring the
    raw-by-default / explicit-layer rules (reference
    muon/_core/utils.py:161-199)."""
    raw_wanted = use_raw is None or use_raw

    if raw_wanted and layer is None and adata.raw is not None:
        source, frame = adata.raw.X, adata.raw.var
    elif layer is not None and layer in adata.layers:
        if use_raw:
            warnings.warn(
                f"Reading '{key}' from layer '{layer}'; use_raw is ignored."
            )
        source, frame = adata.layers[layer], adata.var
    else:
        if raw_wanted and layer is None and adata.raw is None:
            warnings.warn(
                f"No .raw on this object; reading '{key}' from .X."
            )
        if layer is not None and layer not in adata.layers:
            warnings.warn(
                f"Layer {layer} does not exist; reading '{key}' from the "
                f"count matrix (.X) instead."
            )
        source, frame = adata.X, adata.var

    where = frame.index.get_indexer_for([key])
    if where[0] == -1:
        raise ValueError(f"No value found for key '{key}'.")
    if len(where) > 1:
        warnings.warn(
            f"'{key}' occurs more than once in the index; taking the first "
            f"match."
        )
    return _densify_column(source[:, where[0]])


def _owning_modalities(mdata: MuData, key: str, use_raw, layer):
    """Which modalities can serve ``key`` as a feature, applying the
    layer-presence demotion and raw fallback (reference
    muon/_core/utils.py:114-159)."""
    owners = {m for m in mdata.mod if key in mdata.mod[m].var_names}

    if layer is not None and len(owners) == 1:
        (only,) = owners
        if layer not in mdata.mod[only].layers:
            warnings.warn(
                f"Layer {layer} does not exist for '{key}'; the count "
                f"matrix will be used instead."
            )
            layer = None

    if (use_raw is None or use_raw) and layer is None:
        for m in mdata.mod:
            if m not in owners and mdata.mod[m].raw is not None:
                if key in mdata.mod[m].raw.var_names:
                    owners.add(m)
    return owners, layer


def _get_values(
    data: Union[AnnData, MuData],
    key: Optional[str] = None,
    use_raw: Optional[bool] = None,
    layer: Optional[str] = None,
    obsmap: Optional[np.ndarray] = None,
):
    """Resolve a key to a per-(global)-observation value vector.

    Grammar and precedence per the reference (muon/_core/utils.py:15-205);
    see ``_classify`` for the contract order.
    """
    if key is None:
        return None

    if isinstance(key, Iterable) and not isinstance(key, str):
        import pandas as pd

        columns = {
            k: _get_values(data, k, use_raw=use_raw, layer=layer, obsmap=obsmap)
            for k in key
            if k is not None
        }
        return pd.DataFrame(columns)

    if not isinstance(key, str):
        raise TypeError("Expected key to be a string.")

    ref = _classify(data, key)

    if ref.kind == "obs":
        return _spread_to_global(data.obs[ref.name].to_numpy(), obsmap)

    if ref.kind == "obsm":
        col = np.asarray(data.obsm[ref.name])[:, ref.column - 1]
        return _spread_to_global(_densify_column(col), obsmap)

    if ref.kind == "mod":
        inner = data.mod[ref.submod]
        if obsmap is None and not data.obs_names.equals(inner.obs_names):
            obsmap = data.obsmap[ref.submod]
        return _get_values(
            inner, key=ref.subkey, use_raw=use_raw, layer=layer, obsmap=obsmap
        )

    # feature lookup
    if isinstance(data, MuData):
        owners, layer = _owning_modalities(data, key, use_raw, layer)
        if len(owners) > 1:
            raise ValueError(
                f"'{key}' names a feature in multiple modalities "
                f"({sorted(owners)}); qualify it as 'mod:{key}' or make "
                f"var_names unique."
            )
        if not owners:
            raise ValueError(f"No value found for key '{key}'.")
        (owner,) = owners
        inner = data.mod[owner]
        if obsmap is None and not data.obs_names.equals(inner.obs_names):
            obsmap = data.obsmap[owner]
        return _get_values(
            inner, key=key, use_raw=use_raw, layer=layer, obsmap=obsmap
        )

    if isinstance(data, AnnData):
        vec = _read_feature_anndata(data, key, use_raw, layer)
        return _spread_to_global(vec, obsmap)

    raise TypeError("Expected data to be MuData or AnnData")


get_values = _get_values
