"""ATAC tools (``ac.tl``): LSI and marker peaks (counterpart of
muon_tpu/atac/tools.py ``lsi``, ``rank_peaks_groups`` and
``add_genes_peaks_groups``).

LSI is a randomized truncated SVD of the TF-IDF matrix on the device
(ops/linalg.randomized_svd), in place of the reference's ARPACK ``svds``
(muon/_atac/tools.py:53). ``rank_peaks_groups`` ranks peaks with the port's
``tl.rank_genes_groups`` and joins the ranked peaks to the gene names of
``uns["atac"]["peak_annotation"]`` (a pandas DataFrame, as the reference's
``add_peak_annotation`` writes it; pandas is imported inside the function).
"""

from __future__ import annotations

import numpy as np

from ..ops.device import DeviceLike
from ..ops.linalg import randomized_svd
from ..utils.profiling import stage
from .preproc import _get_atac

__all__ = ["lsi", "add_genes_peaks_groups", "rank_peaks_groups"]


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


def add_genes_peaks_groups(data, add_peak_type: bool = False, add_distance: bool = False):
    """Attach gene names (and optionally peak_type/distance) to ranked peaks
    in ``uns["rank_genes_groups"]`` (reference muon/_atac/tools.py:251-334,
    as muon_tpu/atac/tools.py:315-380 keeps it)."""
    import pandas as pd

    adata = _get_atac(data)

    if "rank_genes_groups" not in adata.uns:
        raise KeyError(
            "There is no .uns['rank_genes_groups'] yet. Run "
            "muon_tpu_torch.tl.rank_genes_groups first."
        )
    if "atac" not in adata.uns or "peak_annotation" not in adata.uns["atac"]:
        raise KeyError(
            "There is no peak annotation yet. Run "
            "muon_tpu.atac.tl.add_peak_annotation first."
        )

    annotation = adata.uns["atac"]["peak_annotation"]
    if "peak" not in annotation.columns:
        raise KeyError("Peak annotation has to contain 'peak' column.")

    index_name = annotation.index.name
    columns = [index_name]
    if add_peak_type:
        if "peak_type" not in annotation.columns:
            raise KeyError("Peak annotation has to contain 'peak_type' column.")
        columns.append("peak_type")
        adata.uns["rank_genes_groups"]["peak_type"] = {}
    if add_distance:
        if "distance" not in annotation.columns:
            raise KeyError("Peak annotation has to contain 'distance' column.")
        columns.append("distance")
        adata.uns["rank_genes_groups"]["distance"] = {}
        annotation = annotation.copy()
        annotation["distance"] = annotation["distance"].astype(str)
    peaks_genes = (
        annotation.reset_index(drop=False)
        .loc[:, ["peak", *columns]]
        .set_index("peak")
    )

    adata.uns["rank_genes_groups"]["genes"] = {}
    for i in adata.uns["rank_genes_groups"]["names"].dtype.names:
        ann_ordered = (
            pd.DataFrame(adata.uns["rank_genes_groups"]["names"][i])
            .rename({0: "peak"}, axis=1)
            .join(peaks_genes, on="peak", how="inner", sort=False)
            .groupby("peak", sort=False)
            .agg(lambda s: ", ".join(map(str, s)))
        )
        adata.uns["rank_genes_groups"]["genes"][i] = ann_ordered[index_name].values
        if add_peak_type:
            adata.uns["rank_genes_groups"]["peak_type"][i] = ann_ordered["peak_type"].values
        if add_distance:
            adata.uns["rank_genes_groups"]["distance"][i] = ann_ordered["distance"].values

    adata.uns["rank_genes_groups"]["genes"] = pd.DataFrame(
        adata.uns["rank_genes_groups"]["genes"]
    ).to_records(index=False)


def rank_peaks_groups(data, groupby: str, add_peak_type: bool = False,
                      add_distance: bool = False, device: DeviceLike = None, **kwargs):
    """Rank peaks per cluster (``tl.rank_genes_groups`` on the device), then
    annotate them with gene names (reference muon/_atac/tools.py:337-373,
    which delegates the ranking to scanpy)."""
    from .._core.tools_de import rank_genes_groups

    adata = _get_atac(data)
    rank_genes_groups(adata, groupby, device=device, **kwargs)
    add_genes_peaks_groups(adata, add_peak_type=add_peak_type, add_distance=add_distance)
