"""Aligned mappings (.obsm/.varm/.obsp/.varp/.layers) of the port's
containers (counterpart of muon_tpu/_core/aligned.py).

pandas is imported inside the functions that need it: importing the port
must not need it (the card's machine may lack it).
"""

from __future__ import annotations

from collections.abc import MutableMapping

import numpy as np
from scipy import sparse as sp


def _is_frame(value) -> bool:
    import pandas as pd

    return isinstance(value, pd.DataFrame)


def _value_n(value, axis: int) -> int:
    """Length of ``value`` along ``axis``."""
    if _is_frame(value):
        return value.shape[0]
    return value.shape[axis]


class AlignedDict(MutableMapping):
    """dict of arrays validated against one or two parent axes.

    ``axes=(0,)``     -> obsm/varm-style (first dim must match parent axis)
    ``axes=(0, 0)``   -> obsp-style (first two dims match n_obs)
    ``axes=(0, 1)``   -> layers-style (shape must equal parent shape)
    """

    def __init__(self, parent, axes, data=None, *, axis_name="obs"):
        self._parent = parent
        self._axes = tuple(axes)
        self._axis_name = axis_name
        self._data = {}
        if data:
            for k, v in dict(data).items():
                self[k] = v

    # -- validation ------------------------------------------------------
    def _expected(self, dim: int) -> int:
        ax = self._axes[dim]
        return self._parent.n_obs if ax == 0 else self._parent.n_vars

    def _validate(self, key, value):
        if isinstance(value, list):
            value = np.asarray(value)
        if isinstance(value, np.ndarray) or _is_frame(value) or sp.issparse(value):
            for dim in range(len(self._axes)):
                if value.ndim <= dim and len(self._axes) > 1:
                    raise ValueError(
                        f"value for {key!r} has too few dimensions ({value.ndim})"
                    )
                got = _value_n(value, dim) if dim < value.ndim else None
                want = self._expected(dim)
                if got is not None and got != want:
                    raise ValueError(
                        f"value for {key!r} has wrong length {got} along dim {dim}, "
                        f"expected {want} ({self._axis_name})"
                    )
        return value

    # -- MutableMapping --------------------------------------------------
    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        self._data[key] = self._validate(key, value)

    def __delitem__(self, key):
        del self._data[key]

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __contains__(self, key):
        return key in self._data

    def __repr__(self):
        return f"AlignedDict with keys: {', '.join(map(str, self._data))}"

    def copy(self):
        return {k: v.copy() for k, v in self._data.items()}

    def _subset(self, idx, dims=None):
        """Return plain dict with every value subset along the given dims."""
        if dims is None:
            dims = range(len(self._axes))
        out = {}
        for k, v in self._data.items():
            sub = v
            for dim in dims:
                if dim == 0:
                    sub = sub.iloc[idx] if _is_frame(sub) else sub[idx]
                elif dim == 1:
                    sub = sub[:, idx]
            out[k] = sub.copy() if hasattr(sub, "copy") else sub
        return out
