"""ATAC tools (``ac.tl``): LSI, marker peaks, peak annotation, the file
registry and motifs (counterpart of muon_tpu/atac/tools.py ``lsi``,
``rank_peaks_groups``, ``add_genes_peaks_groups``, ``add_peak_annotation``,
``add_peak_annotation_gene_names``, ``locate_file``, ``locate_genome``,
``scan_sequences`` and ``get_sequences``).

LSI is a randomized truncated SVD of the TF-IDF matrix on the device
(ops/linalg.randomized_svd), in place of the reference's ARPACK ``svds``
(muon/_atac/tools.py:53). ``rank_peaks_groups`` ranks peaks with the port's
``tl.rank_genes_groups`` and joins the ranked peaks to the gene names of
``uns["atac"]["peak_annotation"]`` (a pandas DataFrame, as the reference's
``add_peak_annotation`` writes it; pandas is imported inside the function).
The peak annotation and the file registry are host code, copies of the
reference's. ``scan_sequences`` and ``get_sequences`` are atac/motifs.py's:
peak sequences from a genome FASTA, scanned on the card by T36.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..ops.device import DeviceLike
from ..ops.linalg import randomized_svd
from ..utils.profiling import stage
from .motifs import get_sequences, scan_sequences
from .preproc import _get_atac

__all__ = [
    "lsi",
    "add_peak_annotation",
    "add_peak_annotation_gene_names",
    "add_genes_peaks_groups",
    "rank_peaks_groups",
    "locate_file",
    "locate_genome",
    "scan_sequences",
    "get_sequences",
]


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
            "lsi over a device mesh is not ported yet (the multi-device work, K20)"
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


# ---------------------------------------------------------------------------
# Peak annotation (host-side pandas bookkeeping; reference
# muon/_atac/tools.py:83-373, as muon_tpu/atac/tools.py:125-312 keeps it)
# ---------------------------------------------------------------------------


def _region_from_underscored(token: str) -> str:
    """``chr1_840000_840700`` → ``chr1:840000-840700`` (split at the first
    two underscores only; anything after stays inside the end field)."""
    seqname, _, span = token.partition("_")
    lo, _, hi = span.partition("_")
    return f"{seqname}:{lo}-{hi}"


def _split_field(cell) -> list:
    """Fan one table cell out into its ``;``-separated parts (a non-string
    cell, e.g. an already-numeric distance, is a single part)."""
    if isinstance(cell, str):
        return cell.split(";")
    return [cell]


def _to_nullable_int(parts: list):
    """Parse distance tokens to a nullable-Int64 array; blanks and NaN/None
    become ``pd.NA``. Falls back to the raw objects if any token is not an
    integer literal (matching the tolerant reference behavior)."""
    import pandas as pd

    vals = []
    for p in parts:
        if p is None or (isinstance(p, float) and np.isnan(p)) or p is pd.NA:
            vals.append(pd.NA)
        elif isinstance(p, str):
            vals.append(pd.NA if p.strip() == "" else p)
        else:
            vals.append(p)
    try:
        return pd.array(
            [pd.NA if v is pd.NA else int(v) for v in vals], dtype="Int64"
        )
    except (ValueError, TypeError):
        return np.asarray(vals, dtype=object)


def add_peak_annotation(data, annotation, sep: str = "\t",
                        return_annotation: bool = False):
    """Parse a CellRanger ``peak_annotation.tsv`` table (a path or a
    DataFrame) into ``uns["atac"]["peak_annotation"]``.

    Behavioral contract (reference muon/_atac/tools.py:83-165): one output
    row per (peak, gene) pair — ``;``-separated gene/distance/peak_type
    records fan out into individual rows; peak ids are normalized to
    ``chrom:start-end``; distances are nullable Int64 with missing values
    as ``pd.NA``; the result is indexed by gene.
    """
    import pandas as pd

    adata = _get_atac(data)

    table = (
        annotation.copy()
        if isinstance(annotation, pd.DataFrame)
        else pd.read_csv(annotation, sep=sep)
    )

    # -- normalize peak identifiers ------------------------------------
    if "peak" in table.columns:
        peak_ids = [
            _region_from_underscored(p) if isinstance(p, str) else p
            for p in table["peak"]
        ]
    elif {"chrom", "start", "end"}.issubset(table.columns):
        peak_ids = [
            f"{c}:{s}-{e}"
            for c, s, e in zip(table["chrom"], table["start"], table["end"])
        ]
    else:
        raise AttributeError(
            "Peak annotation does not contain neither peak column nor "
            "chrom, start, and end columns."
        )

    # -- fan multi-entry records out row by row ------------------------
    out_peak: list = []
    out_gene: list = []
    out_dist: list = []
    out_type: list = []
    genes_in = table["gene"] if "gene" in table.columns else [""] * len(table)
    dists_in = (
        table["distance"] if "distance" in table.columns else [pd.NA] * len(table)
    )
    types_in = (
        table["peak_type"] if "peak_type" in table.columns else [""] * len(table)
    )
    for pid, g, d, t in zip(peak_ids, genes_in, dists_in, types_in):
        gs, ds, ts = _split_field(g), _split_field(d), _split_field(t)
        width = max(len(gs), len(ds), len(ts))
        if len(gs) == 1 and width > 1:
            gs = gs * width
        if len(ds) == 1 and width > 1:
            ds = ds * width
        if len(ts) == 1 and width > 1:
            ts = ts * width
        out_peak.extend([pid] * width)
        out_gene.extend(gs)
        out_dist.extend(ds)
        out_type.extend(ts)

    def _clean_str(xs):
        return np.asarray(
            [
                ""
                if x is None or x is pd.NA or (isinstance(x, float) and np.isnan(x))
                else x
                for x in xs
            ],
            dtype=object,
        )

    result = pd.DataFrame(
        {
            "peak": _clean_str(out_peak),
            "distance": _to_nullable_int(out_dist),
            "peak_type": _clean_str(out_type),
        },
        index=pd.Index(_clean_str(out_gene), name="gene"),
    )

    adata.uns.setdefault("atac", dict())["peak_annotation"] = result
    if return_annotation:
        return result


def add_peak_annotation_gene_names(data, gene_names=None, join_on: Optional[str] = None,
                                   return_annotation: bool = False):
    """Join gene names from the rna modality's var into the peak annotation
    (reference muon/_atac/tools.py:168-247). ``data`` is AnnData-like (then
    ``gene_names`` is a DataFrame indexed by name, with a ``join_on`` column
    of ids), or MuData-like with ``atac`` (and ``rna``, whose ``var`` is
    taken when ``gene_names`` is None)."""
    import pandas as pd

    mod = getattr(data, "mod", None)
    if mod is not None and "atac" in mod:
        adata = mod["atac"]
        if gene_names is None:
            if "rna" in mod:
                gene_names = mod["rna"].var
            else:
                raise ValueError(
                    "There is no .mod['rna'] modality. Provide `gene_names` "
                    "as a pd.DataFrame."
                )
    elif mod is None and hasattr(data, "X"):
        adata = data
    else:
        raise TypeError("Expected AnnData or MuData object with 'atac' modality")

    if "atac" not in adata.uns or "peak_annotation" not in adata.uns["atac"]:
        raise KeyError(
            "There is no peak annotation yet. Run "
            "muon_tpu_torch.atac.tl.add_peak_annotation first."
        )

    ann = adata.uns["atac"]["peak_annotation"]

    if join_on is None:
        join_on = "gene_ids"

    # Does the annotation index actually hold gene IDs? If it already holds
    # display names there is nothing to translate — just fix the axis label.
    known_ids = set(map(str, gene_names[join_on].to_numpy()))
    hits_ids = any(str(g) in known_ids for g in ann.index)
    if not hits_ids:
        if ann.index.isin(gene_names.index).any():
            ann = ann.rename_axis("gene_name")
            adata.uns["atac"]["peak_annotation"] = ann
        return ann if return_annotation else None

    # id → display-name lookup; a left merge keeps annotation row order and
    # (like the reference's index join) duplicates rows for duplicated ids
    lookup = pd.DataFrame(
        {
            join_on: gene_names[join_on].to_numpy(),
            "gene_name": gene_names.index.to_numpy(),
        }
    )
    flat = ann.reset_index()
    flat = flat.rename(columns={flat.columns[0]: join_on})
    translated = flat.merge(lookup, on=join_on, how="left")
    translated["gene_name"] = translated["gene_name"].fillna("")
    translated = translated.set_index("gene_name")
    adata.uns["atac"]["peak_annotation"] = translated

    if return_annotation:
        return translated


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
            "muon_tpu_torch.atac.tl.add_peak_annotation first."
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


# ---------------------------------------------------------------------------
# File registry (reference muon/_atac/tools.py:569-618)
# ---------------------------------------------------------------------------


def locate_file(data, key: str, file: str):
    """Register an existing file path under ``uns["files"][key]``
    (reference muon/_atac/tools.py:569-596)."""
    adata = _get_atac(data)
    if not os.path.exists(file):
        raise FileNotFoundError(f"File {file} does not exist")
    if "files" not in adata.uns:
        adata.uns["files"] = dict()
    adata.uns["files"][key] = file


def locate_genome(data, fasta_file: str):
    """Register the genome FASTA under ``uns["files"]["genome"]``
    (reference muon/_atac/tools.py:599-618)."""
    locate_file(data, "genome", fasta_file)
