"""``mu.tl.mofa`` — Multi-Omics Factor Analysis on the GPU (counterpart of
muon_tpu/_core/tools_mofa.py).

MuData → per-view matrices (union/intersection obs expansion, group
splitting, likelihood guessing, centering/scaling of gaussian views), the
smooth covariate of MEFISTO and its options, training by
``muon_tpu_torch.models.mofa.fit_mofa``, HDF5 model save in the mofapy2
file layout, and write-back of ``obsm["X_mofa"]`` / ``varm["LFs"]`` /
``uns["mofa"]`` (and ``obs[f"{covariate}_warped"]`` with warping).

It takes the reference's containers or anything shaped like them: a
MuData-like object (``.mod``, ``.obs`` and ``.var`` as pandas frames,
``.obs_names``/``.var_names`` as pandas indexes, ``.n_obs``, ``.n_vars``,
``.obsm``, ``.varm``, ``.uns``) or one AnnData-like object, which is fitted
as the single view ``"data"``. h5py is imported inside the function that
writes the model file.

Not ported yet, and refused by name in ``fit_mofa``: ``mesh``.
"""

from __future__ import annotations

import os
import tempfile
from datetime import datetime
from functools import reduce
from time import strftime
from types import SimpleNamespace
from typing import Any, List, Mapping, Optional, Union
from warnings import warn

import numpy as np
from scipy.sparse import issparse

from ..ops.device import DeviceLike
from .preproc import _is_mudata

__all__ = ["mofa"]


def _densify(X):
    if issparse(X):
        return np.asarray(X.todense(), dtype=np.float32)
    return np.asarray(X, dtype=np.float32)


def _as_mudata(data):
    """``data`` itself when it has modalities; one AnnData-like object as
    the single view ``"data"`` (what the reference wraps in a MuData)."""
    if _is_mudata(data):
        return data
    if not all(hasattr(data, a) for a in ("X", "obs", "var", "obs_names", "var_names")):
        raise TypeError("Expected an MuData object")
    return SimpleNamespace(mod={"data": data}, obs=data.obs, n_obs=data.n_obs)


def _guess_likelihood(Y: np.ndarray) -> str:
    vals = Y[np.isfinite(Y)]
    if vals.size == 0:
        return "gaussian"
    if np.all((vals == 0) | (vals == 1)):
        return "bernoulli"
    if np.all(vals >= 0) and np.allclose(vals, np.round(vals)):
        return "poisson"
    return "gaussian"


def mofa(
    data,
    groups_label: Optional[str] = None,
    use_raw: bool = False,
    use_layer: Optional[str] = None,
    use_var: Optional[str] = "highly_variable",
    use_obs: Optional[str] = None,
    likelihoods: Optional[Union[str, List[str]]] = None,
    n_factors: int = 10,
    scale_views: bool = False,
    scale_groups: bool = False,
    center_groups: bool = True,
    ard_weights: bool = True,
    ard_factors: bool = True,
    spikeslab_weights: bool = True,
    spikeslab_factors: bool = False,
    n_iterations: int = 1000,
    convergence_mode: str = "fast",
    use_float32: bool = True,
    gpu_mode: bool = False,
    gpu_device: Optional[bool] = None,
    svi_mode: bool = False,
    svi_batch_size: float = 0.5,
    svi_learning_rate: float = 1.0,
    svi_forgetting_rate: float = 0.5,
    svi_start_stochastic: int = 1,
    smooth_covariate: Optional[str] = None,
    smooth_warping: bool = False,
    smooth_kwargs: Optional[Mapping[str, Any]] = None,
    save_parameters: bool = False,
    save_data: bool = True,
    save_metadata: bool = True,
    seed: int = 1,
    outfile: Optional[str] = None,
    expectations: Optional[List[str]] = None,
    save_interrupted: bool = True,
    verbose: bool = False,
    quiet: bool = True,
    copy: bool = False,
    mesh=None,
    device: DeviceLike = None,
):
    """Run MOFA+ (the parameter surface of the reference's ``tl.mofa``; the
    VB training loop is ``muon_tpu_torch.models.mofa.fit_mofa``).

    ``gpu_mode`` is accepted for API parity and ignored: compute runs on
    ``device``, the CUDA device when None. ``mesh`` (several devices) is
    not ported yet and raises in ``fit_mofa``. ``smooth_covariate`` names
    a column of ``obs`` (or of a modality's ``obs``)."""
    from ..models.mofa import MOFAConfig, fit_mofa

    mdata = _as_mudata(data)

    if outfile is None:
        outfile = os.path.join(
            tempfile.gettempdir(), "mofa_{}.hdf5".format(strftime("%Y%m%d-%H%M%S"))
        )

    if use_var and not any(
        use_var in mdata.mod[m].var.columns for m in mdata.mod
    ):
        if use_var != "highly_variable":
            warn(f"There is no column {use_var} in the provided object")
        use_var = None

    # -- observation strategy (union / intersection) --------------------------
    common_obs = reduce(
        np.intersect1d, [v.obs_names.to_numpy() for v in mdata.mod.values()]
    )
    if len(common_obs) != mdata.n_obs:
        if not use_obs:
            raise IndexError(
                "Not all the observations are the same across modalities. "
                "Please run `mu.pp.intersect_obs()` to subset the data or "
                "devise a strategy with `use_obs` ('union' or 'intersection')"
            )
        if use_obs not in ("union", "intersection"):
            raise ValueError(
                f"Expected `use_obs` argument to be 'union' or 'intersection',"
                f" not '{use_obs}'"
            )
    else:
        use_obs = None

    if use_obs == "intersection":
        obs_index = np.asarray(common_obs)
    else:
        obs_index = mdata.obs.index.to_numpy()
    N = len(obs_index)

    # -- groups ---------------------------------------------------------------
    if groups_label is not None:
        if groups_label not in mdata.obs.columns:
            raise ValueError(f"{groups_label} is not a column in mdata.obs")
        gvals = mdata.obs.loc[obs_index, groups_label]
        cats = (
            gvals.cat.categories
            if hasattr(gvals, "cat") and hasattr(gvals.cat, "categories")
            else sorted(set(gvals))
        )
        group_names = [str(c) for c in cats]
        gmap = {c: i for i, c in enumerate(cats)}
        groups = np.asarray([gmap[v] for v in gvals], dtype=np.int64)
    else:
        group_names = ["group1"]
        groups = np.zeros(N, dtype=np.int64)
    G = len(group_names)

    # -- per-view matrices -----------------------------------------------------
    views = list(mdata.mod.keys())
    Ys, feature_names = [], []
    for m in views:
        ad = mdata.mod[m]
        if use_layer is not None and use_layer in ad.layers:
            X = ad.layers[use_layer]
            fnames = ad.var_names.to_numpy()
        elif use_raw and ad.raw is not None:
            X = ad.raw.X
            fnames = ad.raw.var_names.to_numpy()
        else:
            X = ad.X
            fnames = ad.var_names.to_numpy()
        X = _densify(X)
        if use_var and use_var in ad.var.columns and X.shape[1] == ad.n_vars:
            sel = ad.var[use_var].astype(bool).to_numpy()
            X = X[:, sel]
            fnames = fnames[sel]
        # expand to the chosen obs index
        pos = ad.obs_names.get_indexer(obs_index)
        Y = np.full((N, X.shape[1]), np.nan, dtype=np.float32)
        hit = pos >= 0
        Y[hit] = X[pos[hit]]
        Ys.append(Y)
        feature_names.append(fnames)

    # -- likelihoods -------------------------------------------------------------
    if likelihoods is None:
        liks = [_guess_likelihood(Y) for Y in Ys]
    elif isinstance(likelihoods, str):
        liks = [likelihoods] * len(views)
    else:
        liks = list(likelihoods)
    for lk in liks:
        if lk not in ("gaussian", "bernoulli", "poisson"):
            raise ValueError(
                f"Unknown likelihood {lk!r}; expected gaussian, bernoulli, "
                "or poisson"
            )
    # -- center / scale (mofapy2 process_data semantics; only gaussian views
    # are centred and scaled — bound-based likelihoods keep raw counts) ------
    for i, Y in enumerate(Ys):
        if liks[i] != "gaussian":
            continue
        if center_groups:
            for g in range(G):
                rows = groups == g
                mu_ = np.nanmean(Y[rows], axis=0)
                Ys[i][rows] = Y[rows] - mu_
        if scale_groups:
            for g in range(G):
                rows = groups == g
                sd = np.nanstd(Ys[i][rows])
                if sd > 0:
                    Ys[i][rows] = Ys[i][rows] / sd
        if scale_views:
            sd = np.nanstd(Ys[i])
            if sd > 0:
                Ys[i] = Ys[i] / sd

    config = MOFAConfig(
        n_factors=n_factors,
        likelihoods=tuple(liks),
        ard_weights=ard_weights,
        ard_factors=ard_factors or G > 1,
        spikeslab_weights=spikeslab_weights,
        spikeslab_factors=spikeslab_factors,
        seed=seed,
    )
    if not quiet:
        print(
            f"[{datetime.now().strftime('%Y-%m-%d %H:%M:%S')}] "
            f"Training MOFA+: {len(views)} views, {N} cells, "
            f"K={n_factors}..."
        )
    fit_kwargs = dict(
        groups=groups,
        n_iterations=n_iterations,
        convergence_mode=convergence_mode,
        verbose=verbose and not quiet,
        svi_mode=svi_mode,
        svi_batch_fraction=svi_batch_size,
        svi_learning_rate=svi_learning_rate,
        svi_forgetting_rate=svi_forgetting_rate,
        svi_start_stochastic=svi_start_stochastic,
        mesh=mesh,
        device=device,
    )
    if smooth_covariate is not None:
        # MEFISTO smooth factors: GP priors over the covariate
        if smooth_covariate in mdata.obs.columns:
            cov = mdata.obs.loc[obs_index, smooth_covariate].to_numpy()
        else:
            # fall back to per-modality obs columns (any modality carrying
            # the column; values reindexed onto the chosen obs axis)
            cov = None
            for ad in mdata.mod.values():
                if smooth_covariate in ad.obs.columns:
                    cov = ad.obs[smooth_covariate].reindex(obs_index).to_numpy()
                    break
            if cov is None:
                raise ValueError(
                    f"smooth_covariate {smooth_covariate!r} is not a column "
                    "in mdata.obs or any modality's .obs"
                )
        cov = np.asarray(cov, dtype=np.float32)
        if np.isnan(cov).any():
            raise ValueError(
                "smooth_covariate contains missing values after aligning to "
                "the chosen obs axis"
            )
        sk = dict(smooth_kwargs or {})
        fit_kwargs["smooth_covariate"] = cov
        if "n_grid" in sk:
            fit_kwargs["smooth_n_grid"] = int(sk["n_grid"])
        if "opt_freq" in sk:
            fit_kwargs["smooth_opt_every"] = int(sk["opt_freq"])
        if "start_opt" in sk:
            fit_kwargs["smooth_start_opt"] = int(sk["start_opt"])
        if sk.get("sparseGP"):
            # inducing-point GPs
            fit_kwargs["sparse_gp"] = True
            if sk.get("frac_inducing") is not None:
                fit_kwargs["frac_inducing"] = float(sk["frac_inducing"])
        if sk.get("model_groups"):
            # the learned group-correlation matrix Kg
            fit_kwargs["model_groups"] = True
        if smooth_warping:
            # DTW alignment of each group's covariate to the reference group
            if groups_label is None:
                raise ValueError(
                    "smooth_warping requires groups_label with >= 2 groups"
                )
            ref = sk.get("warping_ref", 0)
            if not isinstance(ref, (int, np.integer)):
                if str(ref) not in group_names:
                    raise ValueError(
                        f"Expected 'warping_ref' to be a group name but "
                        f"there is no group {ref!r}"
                    )
                ref = group_names.index(str(ref))
            fit_kwargs["warping"] = True
            fit_kwargs["warping_ref"] = int(ref)
            fit_kwargs["warping_freq"] = int(sk.get("warping_freq", 20))
            fit_kwargs["warping_open_begin"] = bool(
                sk.get("warping_open_begin", True)
            )
            fit_kwargs["warping_open_end"] = bool(
                sk.get("warping_open_end", True)
            )
    if save_interrupted:
        # persist the full VB state alongside the model on Ctrl-C so a
        # partially trained model survives
        fit_kwargs["checkpoint_path"] = outfile + ".interrupted.npz"
        fit_kwargs["checkpoint_every"] = max(25, n_iterations // 20)
    try:
        res = fit_mofa(Ys, config, **fit_kwargs)
    except KeyboardInterrupt:
        if save_interrupted:
            warn(
                "Training interrupted — partial VB state is at "
                f"{outfile}.interrupted.npz (resume via "
                "muon_tpu_torch.models.mofa.fit_mofa(resume_from=...))"
            )
        raise
    else:
        if save_interrupted:
            # training finished cleanly: drop the scratch checkpoint
            try:
                os.remove(outfile + ".interrupted.npz")
            except OSError:
                pass

    # -- save model (mofapy2 HDF5 layout) ----------------------------------
    _save_model_hdf5(
        outfile, res, views, group_names, groups, obs_index, feature_names,
        liks, Ys if save_data else None, n_factors,
    )

    if copy:
        data = data.copy()
        mdata = _as_mudata(data)

    # -- write back --------------------------------------------------------
    target = data
    Z = res.Z
    if use_obs == "intersection":
        X_mofa = np.full((target.n_obs, Z.shape[1]), np.nan)
        X_mofa[target.obs.index.isin(obs_index)] = Z
    else:
        X_mofa = Z
    target.obsm["X_mofa"] = X_mofa
    if res.warped_covariates is not None:
        wc = np.full(target.n_obs, np.nan)
        if use_obs in ("union", "intersection"):
            wc[target.obs.index.isin(obs_index)] = res.warped_covariates
        else:
            wc[:] = res.warped_covariates
        target.obs[f"{smooth_covariate}_warped"] = wc
    W = np.concatenate(res.W, axis=0)  # (ΣD, K)
    if use_var:
        LFs = np.zeros((target.n_vars, W.shape[1]))
        sel_all = []
        for m in views:
            ad = mdata.mod[m]
            if use_var in ad.var.columns:
                sel_all.append(ad.var[use_var].astype(bool).to_numpy())
            else:
                sel_all.append(np.ones(ad.n_vars, dtype=bool))
        sel_all = np.concatenate(sel_all)
        LFs[sel_all] = W
        target.varm["LFs"] = LFs
    else:
        target.varm["LFs"] = W

    target.uns["mofa"] = {
        "params": {
            "data": {
                "groups_label": groups_label,
                "use_raw": use_raw,
                "use_layer": use_layer,
                "likelihoods": np.asarray(liks, dtype=object),
                "features_subset": use_var,
                "use_obs": use_obs,
                "scale_views": scale_views,
                "scale_groups": scale_groups,
                "center_groups": center_groups,
                "use_float32": use_float32,
            },
            "model": {
                "ard_factors": ard_factors,
                "ard_weights": ard_weights,
                "spikeslab_weights": spikeslab_weights,
                "spikeslab_factors": spikeslab_factors,
                "n_factors": n_factors,
            },
            "training": {
                "n_iterations": n_iterations,
                "convergence_mode": convergence_mode,
                "gpu_mode": gpu_mode,
                "seed": seed,
            },
        }
    }
    variance = {}
    if G > 1:
        for m_i, m in enumerate(views):
            variance[m] = {
                g: res.r2_per_factor[g_i][m_i]
                for g_i, g in enumerate(group_names)
            }
    else:
        for m_i, m in enumerate(views):
            variance[m] = res.r2_per_factor[0][m_i]
    target.uns["mofa"]["variance"] = variance
    # MEFISTO's smooth-factor outputs (the reference's mofapy2 keeps them in
    # the model file; here they are also in .uns)
    if res.gp_lengthscales is not None:
        target.uns["mofa"]["smooth"] = {
            "lengthscales": np.asarray(res.gp_lengthscales),
            "scales": np.asarray(res.gp_scales),
        }
        if res.warped_covariates is not None:
            target.uns["mofa"]["smooth"]["warped_covariates"] = np.asarray(
                res.warped_covariates
            )
        if res.gp_group_corr is not None:
            target.uns["mofa"]["smooth"]["group_corr"] = np.asarray(
                res.gp_group_corr
            )
    if not quiet:
        print(
            "Saved MOFA embeddings in .obsm['X_mofa'] slot and their "
            "loadings in .varm['LFs']."
        )
    if copy:
        return data
    return None


def _save_model_hdf5(
    outfile, res, views, group_names, groups, obs_index, feature_names,
    likelihoods, Ys, n_factors,
):
    """mofapy2-compatible model file: expectations/Z/<group> (K, N_g),
    expectations/W/<view> (K, D), samples/features/views/groups metadata,
    variance_explained/r2_per_factor/<group> (M, K)."""
    import h5py

    str_dt = h5py.string_dtype(encoding="utf-8")
    with h5py.File(outfile, "w") as f:
        ez = f.create_group("expectations/Z")
        for g_i, g in enumerate(group_names):
            rows = groups == g_i
            ez.create_dataset(g, data=res.Z[rows].T)
        ew = f.create_group("expectations/W")
        for m_i, m in enumerate(views):
            ew.create_dataset(m, data=res.W[m_i].T)
        sg = f.create_group("samples")
        for g_i, g in enumerate(group_names):
            sg.create_dataset(
                g, data=np.asarray(obs_index[groups == g_i], dtype=object),
                dtype=str_dt,
            )
        fg = f.create_group("features")
        for m_i, m in enumerate(views):
            fg.create_dataset(
                m, data=np.asarray(feature_names[m_i], dtype=object), dtype=str_dt
            )
        f.create_group("views").create_dataset(
            "views", data=np.asarray(views, dtype=object), dtype=str_dt
        )
        f.create_group("groups").create_dataset(
            "groups", data=np.asarray(group_names, dtype=object), dtype=str_dt
        )
        mo = f.create_group("model_options")
        mo.create_dataset(
            "likelihoods", data=np.asarray(likelihoods, dtype=object), dtype=str_dt
        )
        ve = f.create_group("variance_explained/r2_per_factor")
        vt = f.create_group("variance_explained/r2_total")
        for g_i, g in enumerate(group_names):
            ve.create_dataset(g, data=res.r2_per_factor[g_i])
            vt.create_dataset(g, data=res.r2_total[g_i])
        ts = f.create_group("training_stats")
        ts.create_dataset("elbo", data=res.elbo_history)
        ts.create_dataset("number_factors", data=np.asarray([n_factors]))
        if res.gp_lengthscales is not None:
            sm = f.create_group("smooth")
            sm.create_dataset("lengthscales", data=res.gp_lengthscales)
            sm.create_dataset("scales", data=res.gp_scales)
            if res.warped_covariates is not None:
                sm.create_dataset(
                    "warped_covariates", data=res.warped_covariates
                )
        if Ys is not None:
            dg = f.create_group("data")
            for m_i, m in enumerate(views):
                gm = dg.create_group(m)
                for g_i, g in enumerate(group_names):
                    gm.create_dataset(
                        g, data=np.nan_to_num(Ys[m_i][groups == g_i])
                    )
