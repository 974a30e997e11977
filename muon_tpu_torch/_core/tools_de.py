"""Differential expression and accessibility: ``rank_genes_groups``
(counterpart of muon_tpu/_core/tools_de.py).

The device computes what the reference's jitted programs compute
(``ops/de.py``): the per-group moments (T3 for a sparse X), the wilcoxon
rank sums and tie terms (T26, after a sort of each column block) and the
logreg fit (T27, T28 and the two products). The test statistics, p-values
(scipy's ``t.sf`` and ``norm.sf``), the Benjamini-Hochberg adjustment and
the ordering run on the host, as in the reference, and the results land in
``uns[key_added]`` with the reference's fields and dtypes: record arrays of
names (object), scores (float32), pvals and pvals_adj (float64) and
logfoldchanges (float32), one field per group. The record arrays are built
with numpy alone, so no pandas is needed unless ``obs`` is a DataFrame.

Differences from the reference: the wilcoxon rank sums are float64 and the
tie terms int64, exact at any size, where the reference's production float32
rounds both above 2²⁴ (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy import sparse as sp

from ..ops import de
from ..ops import sparse as dsp
from ..ops.device import DeviceLike, dense_to_tensor, resolve_device
from ..utils.profiling import stage

__all__ = ["rank_genes_groups"]


def _bh_adjust(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg FDR per group row."""
    n = pvals.shape[-1]
    order = np.argsort(pvals, axis=-1)
    ranked = np.take_along_axis(pvals, order, axis=-1)
    adj = ranked * n / np.arange(1, n + 1)
    adj = np.minimum.accumulate(adj[..., ::-1], axis=-1)[..., ::-1]
    out = np.empty_like(adj)
    np.put_along_axis(out, order, np.clip(adj, 0, 1), axis=-1)
    return out


def _norm_sf(z):
    from scipy.stats import norm

    return norm.sf(z)


def _categories(column):
    """The group names (strings) and each cell's code (−1: no group), in the
    order ``pd.Categorical`` gives: a categorical's own categories, else the
    sorted unique labels."""
    cat = getattr(column, "cat", None)
    if cat is not None:
        return [str(c) for c in cat.categories], np.asarray(cat.codes, dtype=np.int64)
    values = np.asarray(column, dtype=object)
    missing = np.array([v is None or (isinstance(v, float) and np.isnan(v)) for v in values],
                       dtype=bool)
    cats = np.unique(values[~missing]) if (~missing).any() else np.array([], dtype=object)
    codes = np.full(len(values), -1, dtype=np.int64)
    codes[~missing] = np.searchsorted(cats, values[~missing])
    return [str(c) for c in cats], codes


def _records(d: dict, dtype) -> np.recarray:
    """``pd.DataFrame(d).to_records(index=False, column_dtypes=dtype)``: one
    field per key, each of ``dtype``."""
    return np.rec.fromarrays([np.asarray(v, dtype=dtype) for v in d.values()],
                             dtype=[(str(k), dtype) for k in d])


def _upload(X, device: torch.device):
    """A scipy sparse X as a DeviceCSR, any other as a dense float32 tensor,
    on ``device``."""
    if sp.issparse(X):
        return dsp.from_scipy(X, device)
    return dense_to_tensor(X, device)


def _dense(Xd):
    """The dense float32 X that wilcoxon and logreg take, on Xd's device."""
    with stage("de/densify"):
        return de.dense_from_csr(Xd) if isinstance(Xd, dsp.DeviceCSR) else Xd


def rank_genes_groups(
    adata,
    groupby: str,
    groups="all",
    reference: str = "rest",
    method: str = "t-test",
    n_genes: Optional[int] = None,
    corr_method: str = "benjamini-hochberg",
    layer: Optional[str] = None,
    key_added: str = "rank_genes_groups",
    device: DeviceLike = None,
    **kwargs,
):
    """Rank genes/peaks per group vs rest (scanpy-compatible results dict).

    Methods: "t-test" / "t-test_overestim_var" (Welch on device moments),
    "wilcoxon" (device rank sums with the tie-corrected normal
    approximation), "logreg" (multinomial logistic-regression coefficients;
    ``C`` and ``max_iter`` as the reference's keywords). ``device``: the
    card by default; ``"cpu"`` runs the plain versions.
    """
    if method not in ("t-test", "t-test_overestim_var", "wilcoxon", "logreg"):
        raise ValueError(f"Unknown method {method!r}")
    device = resolve_device(device)
    X = adata.X if layer is None else adata.layers[layer]
    n, D = X.shape
    all_names, codes = _categories(adata.obs[groupby])
    if groups == "all" or groups is None:
        use_groups = all_names
    else:
        use_groups = [str(g) for g in groups]

    g = len(all_names)
    valid = codes >= 0
    counts = np.bincount(codes[valid], minlength=g).astype(np.float32)  # (g,)

    if n_genes is None or n_genes > D:
        n_genes = D

    with stage("de/upload"):
        Xd = _upload(X, device)
        codes_t = torch.from_numpy(codes.astype(np.int32)).to(device)
    s1, s2 = de.group_moments(Xd, codes_t, g)
    with stage("de/download"):
        s1, s2 = s1.cpu().numpy(), s2.cpu().numpy()  # (g, D) float32
    tot1 = s1.sum(axis=0)
    tot2 = s2.sum(axis=0)
    n_tot = counts.sum()
    var_names = np.asarray(adata.var_names)

    names_rec, scores_rec, pvals_rec, padj_rec, lfc_rec = {}, {}, {}, {}, {}

    if method in ("t-test", "t-test_overestim_var"):
        from scipy.stats import t as t_dist

        for gi, gname in enumerate(all_names):
            if gname not in use_groups:
                continue
            n1 = counts[gi]
            if reference == "rest":
                nr = n_tot - n1
                m1 = s1[gi] / max(n1, 1)
                mr = (tot1 - s1[gi]) / max(nr, 1)
                v1 = np.maximum(s2[gi] / max(n1, 1) - m1**2, 0) * n1 / max(n1 - 1, 1)
                vr = (
                    np.maximum((tot2 - s2[gi]) / max(nr, 1) - mr**2, 0)
                    * nr
                    / max(nr - 1, 1)
                )
            else:
                ri = all_names.index(str(reference))
                nr = counts[ri]
                m1 = s1[gi] / max(n1, 1)
                mr = s1[ri] / max(nr, 1)
                v1 = np.maximum(s2[gi] / max(n1, 1) - m1**2, 0) * n1 / max(n1 - 1, 1)
                vr = (
                    np.maximum(s2[ri] / max(nr, 1) - mr**2, 0) * nr / max(nr - 1, 1)
                )
            # scanpy's overestimating variant: the rest group's size replaced
            # by n1 in the denominator and the Welch-Satterthwaite dof
            nr_eff = n1 if method == "t-test_overestim_var" else nr
            denom = np.sqrt(v1 / n1 + vr / nr_eff) + 1e-30
            t = (m1 - mr) / denom
            with np.errstate(divide="ignore", invalid="ignore"):
                dof = (v1 / n1 + vr / nr_eff) ** 2 / (
                    (v1 / n1) ** 2 / max(n1 - 1, 1)
                    + (vr / nr_eff) ** 2 / max(nr_eff - 1, 1)
                )
            dof = np.nan_to_num(dof, nan=1.0)
            dof = np.maximum(dof, 1.0)
            pv = 2 * t_dist.sf(np.abs(t), dof)
            lfc = np.log2((np.expm1(m1) + 1e-9) / (np.expm1(mr) + 1e-9))
            order = np.argsort(-t)[:n_genes]
            names_rec[gname] = var_names[order]
            scores_rec[gname] = t[order].astype(np.float32)
            pvals_rec[gname] = pv[order]
            padj_rec[gname] = _bh_adjust(pv)[order]
            lfc_rec[gname] = lfc[order].astype(np.float32)

    elif method == "wilcoxon":
        Xdense = _dense(Xd)
        rank_sums, tie_term = de.wilcoxon_rank_sums(Xdense, codes_t, g)
        del Xdense
        with stage("de/download"):
            rank_sums = rank_sums.cpu().numpy()  # (g, D) float64
            tie_term = tie_term.cpu().numpy().astype(np.float64)  # exact below 2^53
        nt = float(n_tot)
        tie_corr = 1.0 - tie_term / max(nt * (nt * nt - 1.0), 1.0)
        for gi, gname in enumerate(all_names):
            if gname not in use_groups:
                continue
            n1 = counts[gi]
            nr = n_tot - n1
            mu = n1 * (n_tot + 1) / 2.0
            sigma = np.sqrt(n1 * nr * (n_tot + 1) / 12.0 * np.maximum(tie_corr, 1e-12))
            z = (rank_sums[gi] - mu) / np.maximum(sigma, 1e-30)
            pv = 2 * _norm_sf(np.abs(z))
            m1 = s1[gi] / max(n1, 1)
            mr = (tot1 - s1[gi]) / max(nr, 1)
            lfc = np.log2((np.expm1(m1) + 1e-9) / (np.expm1(mr) + 1e-9))
            order = np.argsort(-z)[:n_genes]
            names_rec[gname] = var_names[order]
            scores_rec[gname] = z[order].astype(np.float32)
            pvals_rec[gname] = pv[order]
            padj_rec[gname] = _bh_adjust(pv)[order]
            lfc_rec[gname] = lfc[order].astype(np.float32)

    else:  # logreg: scanpy's coefficients as scores, p-values NaN
        Xdense = _dense(Xd)
        y = torch.from_numpy(np.where(valid, codes, 0).astype(np.int32)).to(device)
        wv = torch.from_numpy(valid.astype(np.float32)).to(device)
        W = de.logreg_fit(Xdense, y, wv, g, C=float(kwargs.get("C", 1.0)),
                          n_steps=int(kwargs.get("max_iter", 200)))
        del Xdense
        with stage("de/download"):
            W = W.cpu().numpy()  # (D, g)

        for gi, gname in enumerate(all_names):
            if gname not in use_groups:
                continue
            n1 = counts[gi]
            nr = n_tot - n1
            coef = W[:, gi]
            m1 = s1[gi] / max(n1, 1)
            mr = (tot1 - s1[gi]) / max(nr, 1)
            lfc = np.log2((np.expm1(m1) + 1e-9) / (np.expm1(mr) + 1e-9))
            order = np.argsort(-coef)[:n_genes]
            names_rec[gname] = var_names[order]
            scores_rec[gname] = coef[order].astype(np.float32)
            pvals_rec[gname] = np.full(len(order), np.nan)
            padj_rec[gname] = np.full(len(order), np.nan)
            lfc_rec[gname] = lfc[order].astype(np.float32)

    adata.uns[key_added] = {
        "params": {
            "groupby": groupby,
            "reference": reference,
            "method": method,
            "use_raw": False,
            "layer": layer,
            "corr_method": corr_method,
        },
        "names": _records(names_rec, "O"),
        "scores": _records(scores_rec, "float32"),
        "pvals": _records(pvals_rec, "float64"),
        "pvals_adj": _records(padj_rec, "float64"),
        "logfoldchanges": _records(lfc_rec, "float32"),
    }
    return None
