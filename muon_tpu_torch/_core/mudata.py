"""MuData-compatible multimodal container of the port (counterpart of
muon_tpu/_core/mudata.py): the ``.mod`` dict, global obs/var, per-modality
membership masks in ``.obsm[mod]``/``.varm[mod]``, 1-based index maps
``.obsmap``/``.varmap``, ``update()``, ``pull_*``/``push_*``,
cross-modality views and ``axis=1`` containers, ``write``/``write_h5mu``
(``_core/h5io.py``) and backed mode (``read_h5mu(path, backed=True)``: each
modality's X stays on disk, the modalities sharing the MuData's open file).
pandas and h5py are imported inside the functions that need them.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .aligned import AlignedDict
from .anndata import AnnData, FileManager, _deepcopy_uns, _normalize_index, concat_names

__all__ = ["MuData"]


def _union_index(indexes):
    """Union of indexes preserving order of first appearance."""
    import pandas as pd

    if len(indexes) == 1:
        return indexes[0].copy()
    if all(indexes[0].equals(ix) for ix in indexes[1:]):
        return indexes[0].copy()
    return pd.Index(
        pd.unique(np.concatenate([np.asarray(ix, dtype=object) for ix in indexes]))
    )


class ModDict(OrderedDict):
    def __init__(self, parent, *args, **kwargs):
        self._parent = parent
        super().__init__(*args, **kwargs)


class MuData:
    """Multimodal container: a dict of :class:`AnnData` plus global annotations.

    ``axis=0`` (default): observations are the shared axis (vars concatenate).
    ``axis=1``: variables are the shared axis (obs concatenate).
    """

    def __init__(self, data=None, feature_types_names=None, axis: int = 0, **kwargs):
        if isinstance(data, AnnData):
            data = self._split_anndata(data, feature_types_names)
        if data is None:
            data = {}
        self.mod = ModDict(self, data)
        self.axis = axis
        self._uns = dict(kwargs.pop("uns", None) or {})
        self._obs = kwargs.pop("obs", None)
        self._var = kwargs.pop("var", None)
        self._obsm_extra = dict(kwargs.pop("obsm", None) or {})
        self._varm_extra = dict(kwargs.pop("varm", None) or {})
        self._obsp_extra = dict(kwargs.pop("obsp", None) or {})
        self._varp_extra = dict(kwargs.pop("varp", None) or {})
        self._is_view = False
        self.file = FileManager(None)
        # filled by update()
        self.obsmap: dict = {}
        self.varmap: dict = {}
        self.update()
        # restore any explicitly passed global annotations / mappings
        for k, v in self._obsm_extra.items():
            self.obsm[k] = v
        for k, v in self._varm_extra.items():
            self.varm[k] = v
        for k, v in self._obsp_extra.items():
            self.obsp[k] = v
        for k, v in self._varp_extra.items():
            self.varp[k] = v

    # -- construction helpers ---------------------------------------------
    @staticmethod
    def _split_anndata(adata: AnnData, feature_types_names=None):
        """Split a single AnnData into modalities by ``var['feature_types']``
        (the reference's behavior for 10x multiome input)."""
        import pandas as pd

        names = {"Gene Expression": "rna", "Peaks": "atac", "Antibody Capture": "prot"}
        if feature_types_names:
            names.update(feature_types_names)
        if "feature_types" not in adata.var.columns:
            return {"data": adata}
        fts = adata.var["feature_types"].astype(str)
        mods = {}
        for ft in pd.unique(fts):
            mask = (fts == ft).to_numpy()
            mods[names.get(ft, str(ft))] = adata[:, mask].copy()
        return mods

    # -- dims ---------------------------------------------------------------
    @property
    def n_mod(self):
        return len(self.mod)

    @property
    def n_obs(self):
        return len(self._obs) if self._obs is not None else 0

    @property
    def n_vars(self):
        return len(self._var) if self._var is not None else 0

    n_var = n_vars

    @property
    def shape(self):
        return (self.n_obs, self.n_vars)

    @property
    def obs(self):
        return self._obs

    @obs.setter
    def obs(self, df):
        self._obs = df

    @property
    def var(self):
        return self._var

    @var.setter
    def var(self, df):
        self._var = df

    @property
    def obs_names(self):
        return self._obs.index

    @property
    def var_names(self):
        return self._var.index

    @property
    def uns(self):
        return self._uns

    @uns.setter
    def uns(self, value):
        self._uns = dict(value)

    @property
    def is_view(self):
        return self._is_view

    @property
    def isbacked(self):
        return self.file.filename is not None

    @property
    def filename(self):
        return self.file.filename

    def mod_names(self):
        return list(self.mod.keys())

    # -- update ---------------------------------------------------------------
    def update(self):
        self.update_obs()
        self.update_var()

    def _update_axis(self, attr: str, shared: bool):
        """Rebuild the global index, masks and maps for one axis."""
        import pandas as pd

        names_attr = f"{attr}_names"
        mods = list(self.mod.items())
        indexes = [getattr(ad, names_attr) for _, ad in mods]
        if shared:
            new_index = _union_index(indexes) if indexes else pd.Index([])
        else:
            new_index = concat_names(indexes) if indexes else pd.Index([])

        old_df = getattr(self, f"_{attr}")
        n = len(new_index)
        # carry over global columns where the index is compatible
        if old_df is not None and len(old_df.columns):
            if old_df.index.equals(new_index):
                new_df = old_df.copy()
            elif shared and not old_df.index.has_duplicates and new_index.isin(
                old_df.index
            ).all():
                new_df = old_df.loc[new_index].copy()
            else:
                new_df = pd.DataFrame(index=new_index)
        else:
            new_df = pd.DataFrame(index=new_index)
        setattr(self, f"_{attr}", new_df)

        # masks + maps
        maps = {}
        masks = {}
        if shared:
            for mname, ad in mods:
                pos = getattr(ad, names_attr).get_indexer(new_index)
                maps[mname] = (pos + 1).astype(np.uint32)
                masks[mname] = pos >= 0
        else:
            offset = 0
            for mname, ad in mods:
                k = len(getattr(ad, names_attr))
                m = np.zeros(n, dtype=np.uint32)
                m[offset : offset + k] = np.arange(1, k + 1, dtype=np.uint32)
                maps[mname] = m
                mask = np.zeros(n, dtype=bool)
                mask[offset : offset + k] = True
                masks[mname] = mask
                offset += k
        setattr(self, f"{attr}map", maps)

        # refresh the AlignedDict for this axis, preserving compatible extras
        am_attr = f"_{attr}m_dict"
        old_am = getattr(self, am_attr, None)
        new_am = AlignedDict(self, (0 if attr == "obs" else 1,), None, axis_name=attr)
        if old_am is not None:
            for k, v in old_am.items():
                if k in self.mod:
                    continue
                try:
                    new_am[k] = v
                except ValueError:
                    pass  # incompatible after axis change — drop
        for mname, mask in masks.items():
            new_am[mname] = mask
        setattr(self, am_attr, new_am)

        # pairwise extras
        ap_attr = f"_{attr}p_dict"
        old_ap = getattr(self, ap_attr, None)
        new_ap = AlignedDict(self, (0 if attr == "obs" else 1,) * 2, None, axis_name=attr)
        if old_ap is not None:
            for k, v in old_ap.items():
                try:
                    new_ap[k] = v
                except ValueError:
                    pass
        setattr(self, ap_attr, new_ap)

    def update_obs(self):
        self._update_axis("obs", shared=(self.axis in (0, -1)))

    def update_var(self):
        self._update_axis("var", shared=(self.axis in (1, -1)))

    # -- aligned mappings --------------------------------------------------
    @property
    def obsm(self):
        return self._obsm_dict

    @property
    def varm(self):
        return self._varm_dict

    @property
    def obsp(self):
        return self._obsp_dict

    @property
    def varp(self):
        return self._varp_dict

    # -- pull/push ------------------------------------------------------------
    def pull_obs(self, columns=None, mods=None, common=None, prefix_unique=True):
        """Copy per-modality ``.obs`` columns into the global ``.obs``
        (mudata ``pull_obs`` parity):

        - columns present in ALL modalities (``common``, default True) are
          merged into ONE unprefixed column (later modalities fill
          remaining/overlapping positions);
        - columns present in exactly one modality get a ``mod:column`` name
          when ``prefix_unique`` (default), an unprefixed name otherwise;
        - columns shared by some-but-not-all modalities are always
          prefixed ``mod:column``.
        """
        self._pull("obs", columns=columns, mods=mods, common=common,
                   prefix_unique=prefix_unique)

    def pull_var(self, columns=None, mods=None, common=None, prefix_unique=True):
        self._pull("var", columns=columns, mods=mods, common=common,
                   prefix_unique=prefix_unique)

    def _pull(self, attr, columns=None, mods=None, common=None, prefix_unique=True):
        import pandas as pd

        if isinstance(columns, str):
            columns = [columns]
        if common is None:
            common = True
        global_df = getattr(self, f"_{attr}")
        gmap = getattr(self, f"{attr}map")
        use_mods = mods if mods is not None else list(self.mod)

        # how many of the used modalities carry each requested column
        col_count = {}
        for mname in use_mods:
            for col in getattr(self.mod[mname], attr).columns:
                if columns is not None and col not in columns:
                    continue
                col_count[col] = col_count.get(col, 0) + 1

        merged: dict = {}
        for mname in use_mods:
            df = getattr(self.mod[mname], attr)
            cols = columns if columns is not None else list(df.columns)
            mp = gmap[mname]  # 1-based positions, 0 = absent
            present = mp > 0
            loc = mp[present].astype(np.int64) - 1
            for col in cols:
                if col not in df.columns:
                    continue
                vals = df[col]
                count = col_count.get(col, 1)
                if common and count == len(use_mods):
                    tgt = col  # merged unprefixed column
                elif count == 1 and not prefix_unique:
                    tgt = col
                else:
                    tgt = f"{mname}:{col}"
                if tgt in merged:
                    out = merged[tgt]
                else:
                    out = pd.Series(pd.NA, index=global_df.index, dtype=object)
                out.iloc[np.flatnonzero(present)] = vals.to_numpy()[loc]
                merged[tgt] = out
                if isinstance(vals.dtype, pd.CategoricalDtype):
                    merged[tgt + "\0cat"] = True
        for tgt, out in merged.items():
            if tgt.endswith("\0cat"):
                continue
            try:
                cast = out.infer_objects()
            except Exception:
                cast = out
            if merged.get(tgt + "\0cat"):
                cast = cast.astype("category")
            global_df[tgt] = cast

    def push_obs(self, columns=None, mods=None):
        self._push("obs", columns=columns, mods=mods)

    def push_var(self, columns=None, mods=None):
        self._push("var", columns=columns, mods=mods)

    def _push(self, attr, columns=None, mods=None):
        global_df = getattr(self, f"_{attr}")
        gmap = getattr(self, f"{attr}map")
        use_mods = mods if mods is not None else list(self.mod)
        cols = columns if columns is not None else list(global_df.columns)
        for mname in use_mods:
            ad = self.mod[mname]
            mp = gmap[mname]
            present = np.flatnonzero(mp > 0)
            src_rows = present[np.argsort(mp[present])]
            for col in cols:
                target = col
                if ":" in col:
                    pmod, target = col.split(":", 1)
                    if pmod != mname:
                        continue
                if col not in global_df.columns:
                    continue
                getattr(ad, attr)[target] = global_df[col].to_numpy()[src_rows]

    # -- indexing ---------------------------------------------------------
    def __getitem__(self, index):
        if isinstance(index, str):
            return self.mod[index]
        if isinstance(index, tuple) and len(index) == 2:
            oidx_raw, vidx_raw = index
        else:
            oidx_raw, vidx_raw = index, slice(None)
        oidx = _normalize_index(oidx_raw, self.obs_names, self.n_obs)
        vidx = _normalize_index(vidx_raw, self.var_names, self.n_vars)
        return self._view(oidx, vidx)

    def _view(self, oidx, vidx):
        new_mods = {}
        for mname, ad in self.mod.items():
            omap = self.obsmap[mname][oidx]
            vmap = self.varmap[mname][vidx]
            o_local = omap[omap > 0].astype(np.int64) - 1
            v_local = vmap[vmap > 0].astype(np.int64) - 1
            new_mods[mname] = ad._view(o_local, v_local)
        out = MuData(new_mods, axis=self.axis, uns=dict(self._uns))
        # carry global annotations
        out._obs = self._obs.iloc[oidx].copy()
        out._var = self._var.iloc[vidx].copy()
        out.update()
        for k, v in self.obsm.items():
            if k in self.mod:
                continue
            try:
                out.obsm[k] = np.asarray(v)[oidx]
            except Exception:
                pass
        for k, v in self.varm.items():
            if k in self.mod:
                continue
            try:
                out.varm[k] = np.asarray(v)[vidx]
            except Exception:
                pass
        for k, v in self.obsp.items():
            out.obsp[k] = v[oidx][:, oidx]
        for k, v in self.varp.items():
            out.varp[k] = v[vidx][:, vidx]
        out._is_view = True
        return out

    def copy(self):
        out = MuData(
            {k: v.copy() for k, v in self.mod.items()},
            axis=self.axis,
            uns=_deepcopy_uns(self._uns),
        )
        out._obs = self._obs.copy()
        out._var = self._var.copy()
        out.update()
        for k, v in self.obsm.items():
            if k not in self.mod:
                out.obsm[k] = v.copy()
        for k, v in self.varm.items():
            if k not in self.mod:
                out.varm[k] = v.copy()
        for k, v in self.obsp.items():
            out.obsp[k] = v.copy()
        for k, v in self.varp.items():
            out.varp[k] = v.copy()
        return out

    def __contains__(self, key):
        return key in self.mod

    def __iter__(self):
        return iter(self.mod)

    # -- io ----------------------------------------------------------------
    def write_h5mu(self, filename, compression=None):
        from .h5io import write_h5mu

        write_h5mu(filename, self, compression=compression)

    write = write_h5mu

    def __repr__(self):
        descr = f"MuData object with n_obs × n_vars = {self.n_obs} × {self.n_vars}"
        for m, ad in self.mod.items():
            descr += f"\n  {m}: {ad.n_obs} x {ad.n_vars}"
        return descr
