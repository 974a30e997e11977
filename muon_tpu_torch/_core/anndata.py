"""AnnData-compatible annotated data container of the port (counterpart of
muon_tpu/_core/anndata.py; host-side: X, layers and obsm are numpy or
scipy.sparse, and the tools upload what they compute on).

In memory only. A backed AnnData (``filename=``) and ``write``/
``write_h5ad`` raise NotImplementedError: the h5ad/h5mu I/O and the
out-of-core ingest come with K19. pandas is imported inside the functions
that need it: importing the port must not need it.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse as sp

from .aligned import AlignedDict, _is_frame

__all__ = ["AnnData", "Raw", "concat_names"]

# sentinel for lazily-materialized view slots ("not materialized yet",
# distinct from None which is a legal X value)
_UNSET = object()


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (the h5ad/h5mu I/O and the out-of-core ingest, K19)"
    )


# ---------------------------------------------------------------------------
# indexing helpers
# ---------------------------------------------------------------------------


def _normalize_index(idx, names, n: int) -> np.ndarray:
    """Normalize any supported index into an integer position array."""
    import pandas as pd

    if isinstance(idx, slice):
        return np.arange(n)[idx]
    if isinstance(idx, (int, np.integer)):
        return np.array([int(idx) % n if idx < 0 else int(idx)])
    if isinstance(idx, str):
        locs = np.flatnonzero(names == idx)
        if len(locs) == 0:
            raise KeyError(idx)
        return locs
    if isinstance(idx, (pd.Series, pd.Index)):
        idx = idx.to_numpy()
    idx = np.asarray(idx)
    if idx.ndim == 0:
        return _normalize_index(idx.item(), names, n)
    if idx.dtype == bool:
        if len(idx) != n:
            raise IndexError(
                f"boolean index length {len(idx)} does not match axis length {n}"
            )
        return np.flatnonzero(idx)
    if idx.dtype.kind in ("U", "O", "S"):
        indexer = names.get_indexer(idx)
        if (indexer < 0).any():
            missing = np.asarray(idx)[indexer < 0][:5]
            raise KeyError(f"names not found: {list(missing)}")
        return indexer
    return idx.astype(np.intp)


def _subset_matrix(X, oidx=None, vidx=None):
    if X is None:
        return None
    if oidx is not None:
        X = X[oidx]
    if vidx is not None:
        X = X[:, vidx]
    return X


def _remove_unused_categories(df):
    """Drop unused categories from categorical columns (anndata semantics)."""
    import pandas as pd

    for col in df.columns:
        if isinstance(df[col].dtype, pd.CategoricalDtype):
            df[col] = df[col].cat.remove_unused_categories()
    return df


def _default_index(n: int):
    import pandas as pd

    return pd.Index([str(i) for i in range(n)], name=None)


def _coerce_df(df, n: int):
    import pandas as pd

    if df is None:
        return pd.DataFrame(index=_default_index(n))
    if isinstance(df, pd.DataFrame):
        out = df.copy()
        if isinstance(out.index, pd.RangeIndex):
            out.index = _default_index(len(out))
        else:
            out.index = out.index.astype(str)
        return out
    if isinstance(df, dict):
        out = pd.DataFrame(df)
        if "index" in out.columns:
            out = out.set_index("index")
            out.index = out.index.astype(str)
        elif isinstance(out.index, pd.RangeIndex):
            out.index = _default_index(len(out))
        if len(out) == 0 and n > 0:
            out = pd.DataFrame(index=_default_index(n))
        return out
    raise TypeError(f"cannot coerce {type(df)} to a DataFrame")


def concat_names(indexes, make_unique: bool = False):
    """Concatenate indexes preserving order; optionally de-duplicate."""
    import pandas as pd

    vals = np.concatenate([np.asarray(ix, dtype=object) for ix in indexes])
    out = pd.Index(vals)
    if make_unique and out.has_duplicates:
        seen = {}
        new = []
        for v in vals:
            if v in seen:
                seen[v] += 1
                new.append(f"{v}-{seen[v]}")
            else:
                seen[v] = 0
                new.append(v)
        out = pd.Index(new)
    return out


# ---------------------------------------------------------------------------
# Raw
# ---------------------------------------------------------------------------


class Raw:
    """Frozen snapshot of X/var/varm at the time of assignment."""

    def __init__(self, adata=None, X=None, var=None, varm=None):
        if adata is not None:
            self._X = adata.X.copy() if adata.X is not None else None
            self._var = adata.var.copy()
            self._varm = {k: np.asarray(v).copy() for k, v in adata.varm.items()}
            self._obs_names = adata.obs_names.copy()
        else:
            import pandas as pd

            self._X = X
            self._var = var if var is not None else pd.DataFrame()
            self._varm = varm or {}
            self._obs_names = None

    @property
    def X(self):
        return self._X

    @property
    def var(self):
        return self._var

    @property
    def varm(self):
        return self._varm

    @property
    def var_names(self):
        return self._var.index

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    @property
    def n_obs(self):
        return self._X.shape[0] if self._X is not None else 0

    @property
    def n_vars(self):
        return len(self._var)

    def copy(self):
        return Raw(
            X=self._X.copy() if self._X is not None else None,
            var=self._var.copy(),
            varm={k: v.copy() for k, v in self._varm.items()},
        )

    def _subset_obs(self, oidx):
        return Raw(X=_subset_matrix(self._X, oidx), var=self._var.copy(),
                   varm={k: v.copy() for k, v in self._varm.items()})

    def __getitem__(self, idx):
        import pandas as pd

        if isinstance(idx, tuple):
            oidx, vidx = idx
        else:
            oidx, vidx = idx, slice(None)
        oidx = _normalize_index(oidx, self._obs_names if self._obs_names is not None
                                else pd.Index([]), self.n_obs)
        vidx = _normalize_index(vidx, self.var_names, self.n_vars)
        return Raw(
            X=_subset_matrix(self._X, oidx, vidx),
            var=self._var.iloc[vidx].copy(),
            varm={k: np.asarray(v)[vidx].copy() for k, v in self._varm.items()},
        )


# ---------------------------------------------------------------------------
# AnnData
# ---------------------------------------------------------------------------


class AnnData:
    """Annotated data matrix: ``n_obs`` observations × ``n_vars`` variables,
    the JAX package's AnnData in memory (see the module docstring)."""

    def __init__(
        self,
        X=None,
        obs=None,
        var=None,
        uns=None,
        obsm=None,
        varm=None,
        layers=None,
        obsp=None,
        varp=None,
        raw=None,
        shape=None,
        dtype=None,
        filename=None,
    ):
        if filename is not None:
            raise not_ported("a backed AnnData")
        if isinstance(X, AnnData):
            other = X
            X = other.X
            obs = obs if obs is not None else other.obs
            var = var if var is not None else other.var
            uns = uns if uns is not None else other.uns
            obsm = obsm if obsm is not None else dict(other.obsm)
            varm = varm if varm is not None else dict(other.varm)
            layers = layers if layers is not None else dict(other.layers)
            obsp = obsp if obsp is not None else dict(other.obsp)
            varp = varp if varp is not None else dict(other.varp)
            raw = raw if raw is not None else other.raw

        if isinstance(X, (list, tuple)):
            X = np.asarray(X)
        if _is_frame(X):
            import pandas as pd

            if obs is None:
                obs = pd.DataFrame(index=X.index.astype(str))
            if var is None:
                var = pd.DataFrame(index=X.columns.astype(str))
            X = X.to_numpy()
        if dtype is not None and X is not None:
            X = X.astype(dtype)

        if X is not None:
            n_obs, n_vars = X.shape
        elif shape is not None:
            n_obs, n_vars = shape
        else:
            n_obs = len(obs) if obs is not None else 0
            n_vars = len(var) if var is not None else 0

        self._X = X
        self._obs = _coerce_df(obs, n_obs)
        self._var = _coerce_df(var, n_vars)
        if len(self._obs) != n_obs:
            if len(self._obs) == 0:
                self._obs = _coerce_df(None, n_obs)
            else:
                raise ValueError(f"obs has {len(self._obs)} rows but X has {n_obs}")
        if len(self._var) != n_vars:
            if len(self._var) == 0:
                self._var = _coerce_df(None, n_vars)
            else:
                raise ValueError(f"var has {len(self._var)} rows but X has {n_vars}")

        self._uns = dict(uns) if uns else {}
        self._obsm = AlignedDict(self, (0,), obsm, axis_name="obs")
        self._varm = AlignedDict(self, (1,), varm, axis_name="var")
        self._obsp = AlignedDict(self, (0, 0), obsp, axis_name="obs")
        self._varp = AlignedDict(self, (1, 1), varp, axis_name="var")
        self._layers = AlignedDict(self, (0, 1), layers, axis_name="obs x var")
        self._raw = raw
        self._is_view = False
        self._view_of = None

    # -- view machinery ------------------------------------------------------
    def _materialize_X(self):
        parent, oidx, vidx = self._view_of
        self._X = _subset_matrix(parent.X, oidx, vidx)
        return self._X

    def _materialize_aligned(self, slot):
        parent, oidx, vidx = self._view_of
        if slot == "_obsm":
            out = AlignedDict(self, (0,), parent.obsm._subset(oidx), axis_name="obs")
        elif slot == "_varm":
            out = AlignedDict(self, (1,), parent.varm._subset(vidx), axis_name="var")
        elif slot == "_obsp":
            out = AlignedDict(self, (0, 0), parent.obsp._subset(oidx), axis_name="obs")
        elif slot == "_varp":
            out = AlignedDict(self, (1, 1), parent.varp._subset(vidx), axis_name="var")
        else:  # _layers
            data = {k: _subset_matrix(v, oidx, vidx) for k, v in parent.layers.items()}
            out = AlignedDict(self, (0, 1), data, axis_name="obs x var")
        setattr(self, slot, out)
        return out

    def _ensure_actual(self):
        """Copy-on-write: materialize every lazy slot and detach from the
        parent (anndata's view→actual semantics on mutation)."""
        if self._view_of is None:
            return
        _ = (self.X, self.layers, self.obsm, self.varm, self.obsp,
             self.varp, self.raw)
        self._view_of = None
        self._is_view = False

    # -- core dims ---------------------------------------------------------
    @property
    def X(self):
        if self._X is _UNSET:
            return self._materialize_X()
        return self._X

    @X.setter
    def X(self, value):
        if self._view_of is not None:
            self._ensure_actual()
        if value is not None and value.shape != self.shape:
            if value.shape[0] != self.n_obs or value.shape[1] != self.n_vars:
                raise ValueError(
                    f"X shape {value.shape} does not match ({self.n_obs}, {self.n_vars})"
                )
        self._X = value

    @property
    def n_obs(self):
        return len(self._obs)

    @property
    def n_vars(self):
        return len(self._var)

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    # -- annotations ---------------------------------------------------------
    @property
    def obs(self):
        return self._obs

    @obs.setter
    def obs(self, df):
        if len(df) != self.n_obs:
            raise ValueError("obs length mismatch")
        self._obs = df

    @property
    def var(self):
        return self._var

    @var.setter
    def var(self, df):
        if len(df) != self.n_vars:
            raise ValueError("var length mismatch")
        self._var = df

    @property
    def obs_names(self):
        return self._obs.index

    @obs_names.setter
    def obs_names(self, names):
        import pandas as pd

        self._obs.index = pd.Index(np.asarray(names, dtype=object))

    @property
    def var_names(self):
        return self._var.index

    @var_names.setter
    def var_names(self, names):
        import pandas as pd

        self._var.index = pd.Index(np.asarray(names, dtype=object))

    @property
    def uns(self):
        return self._uns

    @uns.setter
    def uns(self, value):
        self._uns = dict(value)

    @property
    def obsm(self):
        if self._obsm is None:
            return self._materialize_aligned("_obsm")
        return self._obsm

    @obsm.setter
    def obsm(self, value):
        self._obsm = AlignedDict(self, (0,), value, axis_name="obs")

    @property
    def varm(self):
        if self._varm is None:
            return self._materialize_aligned("_varm")
        return self._varm

    @varm.setter
    def varm(self, value):
        self._varm = AlignedDict(self, (1,), value, axis_name="var")

    @property
    def obsp(self):
        if self._obsp is None:
            return self._materialize_aligned("_obsp")
        return self._obsp

    @obsp.setter
    def obsp(self, value):
        self._obsp = AlignedDict(self, (0, 0), value, axis_name="obs")

    @property
    def varp(self):
        if self._varp is None:
            return self._materialize_aligned("_varp")
        return self._varp

    @varp.setter
    def varp(self, value):
        self._varp = AlignedDict(self, (1, 1), value, axis_name="var")

    @property
    def layers(self):
        if self._layers is None:
            return self._materialize_aligned("_layers")
        return self._layers

    @layers.setter
    def layers(self, value):
        self._layers = AlignedDict(self, (0, 1), value, axis_name="obs x var")

    @property
    def raw(self):
        if self._raw is _UNSET:
            parent, oidx, _ = self._view_of
            self._raw = parent.raw._subset_obs(oidx) if parent.raw is not None else None
        return self._raw

    @raw.setter
    def raw(self, value):
        if value is None:
            self._raw = None
        elif isinstance(value, Raw):
            self._raw = value
        elif isinstance(value, AnnData):
            self._raw = Raw(value)
        else:
            raise TypeError("raw must be AnnData, Raw or None")

    # -- state flags ---------------------------------------------------------
    @property
    def is_view(self):
        return self._is_view

    @property
    def isbacked(self):
        return False

    @property
    def filename(self):
        return None

    # -- indexing --------------------------------------------------------
    def _resolve_idx(self, index):
        if isinstance(index, tuple) and len(index) == 2:
            oidx_raw, vidx_raw = index
        else:
            oidx_raw, vidx_raw = index, slice(None)
        oidx = _normalize_index(oidx_raw, self.obs_names, self.n_obs)
        vidx = _normalize_index(vidx_raw, self.var_names, self.n_vars)
        return oidx, vidx

    def __getitem__(self, index):
        oidx, vidx = self._resolve_idx(index)
        return self._view(oidx, vidx)

    def _view(self, oidx, vidx):
        """Lazy view: O(metadata) at creation. Matrix-sized attributes
        (X, layers, obsm/varm/obsp/varp, raw) are materialized on first
        access; mutation of X triggers copy-on-write (``_ensure_actual``)."""
        new = AnnData.__new__(AnnData)
        new._view_of = (self, np.asarray(oidx), np.asarray(vidx))
        new._is_view = True
        new._obs = _remove_unused_categories(self._obs.iloc[oidx].copy())
        new._var = _remove_unused_categories(self._var.iloc[vidx].copy())
        new._uns = dict(self._uns)
        new._X = _UNSET
        new._obsm = None
        new._varm = None
        new._obsp = None
        new._varp = None
        new._layers = None
        new._raw = _UNSET
        return new

    def copy(self):
        X = self.X  # materializes the subset if self is a lazy view
        if X is not None:
            X = X.copy()
        new = AnnData(
            X=X,
            obs=self._obs.copy(),
            var=self._var.copy(),
            uns=_deepcopy_uns(self._uns),
            obsm=self.obsm.copy(),
            varm=self.varm.copy(),
            obsp=self.obsp.copy(),
            varp=self.varp.copy(),
            layers=self.layers.copy(),
            shape=self.shape,
        )
        if self.raw is not None:
            new._raw = self.raw.copy()
        return new

    # -- mutation ------------------------------------------------------------
    def _inplace_subset_obs(self, idx):
        """Subset observations in place (anndata parity)."""
        oidx = _normalize_index(idx, self.obs_names, self.n_obs)
        self._assign_from(self._view(oidx, np.arange(self.n_vars)))

    def _inplace_subset_var(self, idx):
        vidx = _normalize_index(idx, self.var_names, self.n_vars)
        self._assign_from(self._view(np.arange(self.n_obs), vidx))

    def _assign_from(self, other: "AnnData"):
        other_X = other.X  # materialize first if `other` is a lazy view
        self._obs = other._obs
        self._var = other._var
        self._X = other_X
        self._uns = other._uns
        self._obsm = AlignedDict(self, (0,), dict(other.obsm), axis_name="obs")
        self._varm = AlignedDict(self, (1,), dict(other.varm), axis_name="var")
        self._obsp = AlignedDict(self, (0, 0), dict(other.obsp), axis_name="obs")
        self._varp = AlignedDict(self, (1, 1), dict(other.varp), axis_name="var")
        self._layers = AlignedDict(self, (0, 1), dict(other.layers), axis_name="obs x var")
        self._raw = other.raw
        self._is_view = False
        self._view_of = None

    # -- accessors -------------------------------------------------------
    def obs_vector(self, key, layer=None):
        """Return a 1-D array for an obs column or a variable's values."""
        if key in self._obs.columns:
            return self._obs[key].to_numpy()
        if key in self.var_names:
            j = self.var_names.get_loc(key)
            if isinstance(j, (slice, np.ndarray)):
                j = np.arange(self.n_vars)[j][0]
            M = self.layers[layer] if layer is not None else self.X
            return _dense_ravel(M[:, j])
        raise KeyError(key)

    def var_vector(self, key, layer=None):
        if key in self._var.columns:
            return self._var[key].to_numpy()
        if key in self.obs_names:
            i = self.obs_names.get_loc(key)
            M = self.layers[layer] if layer is not None else self.X
            return _dense_ravel(M[i])
        raise KeyError(key)

    def to_df(self, layer=None):
        import pandas as pd

        M = self.layers[layer] if layer is not None else self.X
        if sp.issparse(M):
            M = np.asarray(M.todense())
        return pd.DataFrame(M, index=self.obs_names, columns=self.var_names)

    def var_names_make_unique(self, join="-"):
        self._var.index = concat_names([self._var.index], make_unique=True)

    def obs_names_make_unique(self, join="-"):
        self._obs.index = concat_names([self._obs.index], make_unique=True)

    def transpose(self):
        X = self.X
        if X is not None:
            X = X.T
            if sp.issparse(X):
                X = X.tocsr()
        return AnnData(
            X=X, obs=self._var.copy(), var=self._obs.copy(),
            uns=dict(self._uns),
            obsm=self.varm.copy(), varm=self.obsm.copy(),
            obsp=self.varp.copy(), varp=self.obsp.copy(),
            layers={k: v.T for k, v in self.layers.items()},
            shape=(self.n_vars, self.n_obs),
        )

    @property
    def T(self):
        return self.transpose()

    # -- io ----------------------------------------------------------------
    def write_h5ad(self, filename, compression=None):
        raise not_ported("write_h5ad")

    write = write_h5ad

    def __repr__(self):
        descr = f"AnnData object with n_obs × n_vars = {self.n_obs} × {self.n_vars}"
        if self._is_view:
            descr = "View of " + descr
        for attr in ("obs", "var"):
            cols = getattr(self, attr).columns
            if len(cols):
                descr += f"\n    {attr}: {', '.join(map(repr, cols))}"
        for attr in ("uns", "obsm", "varm", "layers", "obsp", "varp"):
            # repr must not force materialization of a lazy view: peek the
            # parent's keys instead (subset keys are identical)
            slot = getattr(self, f"_{attr}", None) if attr != "uns" else self._uns
            if slot is None and self._view_of is not None:
                slot = getattr(self._view_of[0], attr)
            keys = list(slot.keys()) if slot is not None else []
            if keys:
                descr += f"\n    {attr}: {', '.join(map(repr, keys))}"
        return descr


def _dense_ravel(M) -> np.ndarray:
    if sp.issparse(M):
        return np.asarray(M.todense()).ravel()
    return np.asarray(M).ravel()


def _deepcopy_uns(d):
    """Deep-copy an uns tree: walks dicts/lists/tuples, copies arrays,
    sparse matrices and pandas objects, deep-copies anything else."""
    import pandas as pd

    if isinstance(d, dict):
        return {k: _deepcopy_uns(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return type(d)(_deepcopy_uns(v) for v in d)
    if isinstance(d, (np.ndarray, pd.DataFrame, pd.Series, pd.Index,
                      pd.Categorical)) or sp.issparse(d):
        return d.copy()
    if isinstance(d, (str, bytes, int, float, bool, type(None))):
        return d
    import copy as _copy

    try:
        return _copy.deepcopy(d)
    except Exception:
        return d
