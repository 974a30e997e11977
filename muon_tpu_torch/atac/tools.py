"""ATAC tools (``ac.tl``): LSI, marker peaks, peak annotation, the file
registry, motifs and the fragment QC tools (counterpart of
muon_tpu/atac/tools.py ``lsi``, ``rank_peaks_groups``,
``add_genes_peaks_groups``, ``add_peak_annotation``,
``add_peak_annotation_gene_names``, ``locate_file``, ``locate_genome``,
``scan_sequences``, ``get_sequences``, ``locate_fragments``,
``initialise_default_files``, ``count_fragments_features``,
``tss_enrichment``, ``nucleosome_signal`` and ``fetch_regions_to_df``).

LSI is a randomized truncated SVD of the TF-IDF matrix on the device
(ops/linalg.randomized_svd), in place of the reference's ARPACK ``svds``
(muon/_atac/tools.py:53). ``rank_peaks_groups`` ranks peaks with the port's
``tl.rank_genes_groups`` and joins the ranked peaks to the gene names of
``uns["atac"]["peak_annotation"]`` (a pandas DataFrame, as the reference's
``add_peak_annotation`` writes it; pandas is imported inside the function).
The peak annotation and the file registry are host code, copies of the
reference's. ``scan_sequences`` and ``get_sequences`` are atac/motifs.py's:
peak sequences from a genome FASTA, scanned on the card by T36.

The fragment tools read a tabix-indexed fragments file through the port's
native engine (atac/fragments.py). ``tss_enrichment`` piles the fragments
around each sampled TSS up on the card (ops/pileup.interval_pileup, T37)
and computes the ENCODE score there in float64 (exact integer sums, one
IEEE division), downloading the scores and the normalised matrix once;
``count_fragments_features`` (a COO → CSR on the host, scipy) and
``nucleosome_signal`` (a bincount) are host code, as in the reference, and
take no device. They return and fill the port's own containers.
"""

from __future__ import annotations

import os
from typing import Optional
from warnings import warn

import numpy as np
import torch

from .._core.anndata import AnnData
from ..ops import pileup as _pileup
from ..ops.device import DeviceLike, resolve_device
from ..ops.linalg import randomized_svd
from ..utils.profiling import stage
from . import utils
from .fragments import TabixFragments
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
    "locate_fragments",
    "initialise_default_files",
    "count_fragments_features",
    "tss_enrichment",
    "nucleosome_signal",
    "fetch_regions_to_df",
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


def locate_fragments(data, fragments: str, return_fragments: bool = False):
    """Validate a tabix-indexed fragments file and register it under
    ``uns["files"]["fragments"]`` (reference muon/_atac/tools.py:640-690,
    the connection opened with the native engine instead of pysam). As the
    reference, a failure is printed, not raised."""
    frag = None
    try:
        adata = _get_atac(data)
        frag = TabixFragments(fragments)
        if "files" not in adata.uns:
            adata.uns["files"] = dict()
        adata.uns["files"]["fragments"] = fragments
        if return_fragments:
            return frag
    except Exception as e:
        print(e)
    finally:
        if frag is not None and not return_fragments:
            frag.close()


def initialise_default_files(data, path):
    """Auto-locate CellRanger sidecar files next to the count matrix
    (reference muon/_atac/tools.py:693-743): ``atac_peak_annotation.tsv``
    and ``atac_fragments.tsv.gz`` in ``path``'s directory."""
    adata = _get_atac(data)

    default_annotation = os.path.join(os.path.dirname(str(path)), "atac_peak_annotation.tsv")
    if os.path.exists(default_annotation):
        try:
            add_peak_annotation(adata, default_annotation)
            print(
                f"Added peak annotation from {default_annotation} to "
                ".uns['atac']['peak_annotation']"
            )
            if getattr(data, "mod", None) is not None:
                try:
                    add_peak_annotation_gene_names(data)
                    print(
                        "Added gene names to peak annotation in "
                        ".uns['atac']['peak_annotation']"
                    )
                except Exception:
                    pass
        except AttributeError:
            warn(
                f"Peak annotation from {default_annotation} could not be "
                "added. Please check the annotation file is formatted "
                "correctly."
            )

    default_fragments = os.path.join(os.path.dirname(str(path)), "atac_fragments.tsv.gz")
    if os.path.exists(default_fragments):
        print(f"Located fragments file: {default_fragments}")
        locate_fragments(adata, default_fragments)


# ---------------------------------------------------------------------------
# Fragment aggregation and QC (reference muon/_atac/tools.py:746-1263)
# ---------------------------------------------------------------------------


def _open_fragments(adata, barcodes: Optional[str] = None) -> TabixFragments:
    if "files" not in adata.uns or "fragments" not in adata.uns["files"]:
        raise KeyError(
            "There is no fragments file located yet. Run "
            "muon_tpu_torch.atac.tl.locate_fragments first."
        )
    if barcodes and barcodes in adata.obs.columns:
        bcs = adata.obs[barcodes].astype(str).tolist()
    else:
        bcs = adata.obs.index.astype(str).tolist()
    return TabixFragments(adata.uns["files"]["fragments"], barcodes=bcs)


def _resolve_features(data, features):
    if features is not None:
        return features
    mod = getattr(data, "mod", None)
    if mod is not None and "rna" in mod and "interval" in mod["rna"].var.columns:
        from ..rna.utils import get_gene_annotation_from_rna

        return get_gene_annotation_from_rna(data)
    raise ValueError(
        "Argument `features` is required. It should be a BED-like DataFrame "
        "with gene coordinates and names."
    )


def count_fragments_features(
    data,
    features=None,
    stranded: bool = False,
    extend_upstream: int = 2000,
    extend_downstream: int = 0,
    count_reads: bool = True,
) -> AnnData:
    """Count fragments overlapping features → a cells × features AnnData of
    int64 CSR counts (reference muon/_atac/tools.py:746-891). Promoter
    extension is strand-aware when ``stranded=True``; ``count_reads``
    accumulates the per-fragment read support (score column) instead of 1.
    ``features`` defaults to the rna modality's ``var["interval"]``."""
    from scipy import sparse as sp

    adata = _get_atac(data)
    features = _resolve_features(data, features)

    f_cols = np.array([c.lower() for c in features.columns.values])
    for col in ("start", "end"):
        if col not in f_cols:
            raise ValueError(f"No column with feature {col}s could be found")
    chrom_col = None
    for col in ("chromosome", "chrom", "chr"):
        if col in f_cols:
            chrom_col = col
            break
    if chrom_col is None:
        raise ValueError("No column with chromosome for features could be found")

    start_col = features.columns.values[np.where(f_cols == "start")[0][0]]
    end_col = features.columns.values[np.where(f_cols == "end")[0][0]]
    chr_col = features.columns.values[np.where(f_cols == chrom_col)[0][0]]
    strand_col = None
    if stranded:
        if "strand" not in f_cols:
            raise ValueError("No column with strand for features could be found")
        strand_col = features.columns.values[np.where(f_cols == "strand")[0][0]]

    if count_reads:
        warn(
            "From v0.2, by default, unique fragments will be counted instead "
            "of reads.",
            FutureWarning,
            stacklevel=2,
        )

    n = adata.n_obs
    n_features = features.shape[0]

    with stage("count/fetch(host)"), _open_fragments(adata) as frags:
        starts = features[start_col].to_numpy().astype(np.int64)
        ends = features[end_col].to_numpy().astype(np.int64)
        chroms = features[chr_col].astype(str).to_numpy()
        if stranded:
            minus = (features[strand_col].astype(str) == "-").to_numpy()
            f_from = np.where(minus, starts - extend_downstream, starts - extend_upstream)
            f_to = np.where(minus, ends + extend_upstream, ends + extend_downstream)
        else:
            f_from = starts - extend_upstream
            f_to = ends + extend_downstream
        res = frags.fetch_many(chroms, f_from, f_to)

    with stage("count/csr(host)"):
        offs = res["region_offsets"]
        rows = np.repeat(np.arange(n_features, dtype=np.int64), np.diff(offs))
        cells = res["cells"]
        keep = cells >= 0
        vals = res["scores"][keep] if count_reads else np.ones(int(keep.sum()), np.int64)
        mx = sp.coo_matrix(
            (vals, (rows[keep], cells[keep])), shape=(n_features, n), dtype=np.int64
        ).tocsr()
        X = mx.transpose().tocsr()

    return AnnData(X=X, obs=adata.obs.copy(), var=features)


def tss_enrichment(
    data,
    features=None,
    extend_upstream: int = 1000,
    extend_downstream: int = 1000,
    n_tss: int = 2000,
    return_tss: bool = True,
    random_state=None,
    barcodes: Optional[str] = None,
    device: DeviceLike = None,
):
    """ENCODE TSS enrichment: pile fragment coverage up around at most
    ``n_tss`` sampled TSS (``features.sample(n=n_tss,
    random_state=random_state)``; the TSS is each feature's ``Start``),
    score = centre mean / flank mean; writes ``obs["tss_score"]``
    (reference muon/_atac/tools.py:894-984). Returns, under ``return_tss``,
    a cells × positions AnnData of the coverage over the flank means
    (float64). The pileup runs on ``device`` (T37 on the card), and the
    score there too."""
    import pandas as pd

    adata = _get_atac(data)
    features = _resolve_features(data, features)
    dev = resolve_device(device)

    if features.shape[0] > n_tss:
        features = features.sample(n=n_tss, random_state=random_state)

    X = _tss_pileup(adata, features, extend_upstream=extend_upstream,
                    extend_downstream=extend_downstream, barcodes=barcodes, device=dev)
    flank_means, center_means = _calculate_tss_score(X)
    with stage("pileup/score"):
        Xs = X.double()
        Xs /= torch.from_numpy(flank_means).to(dev)[:, None]
    with stage("pileup/download"):
        Xs = Xs.cpu().numpy()
    tss_scores = center_means / flank_means

    anno = pd.DataFrame({"TSS_position": range(-extend_upstream, extend_downstream + 1)})
    anno.index = anno.index.astype(str)
    tss_pileup = AnnData(X=Xs, obs=adata.obs.copy(), var=anno)

    adata.obs["tss_score"] = tss_scores
    tss_pileup.obs["tss_score"] = tss_scores

    if return_tss:
        return tss_pileup


def _tss_pileup(adata, features, extend_upstream: int = 1000, extend_downstream: int = 1000,
                barcodes: Optional[str] = None, device: DeviceLike = None) -> torch.Tensor:
    """Fragments around each feature's ``Start`` piled up per cell: an
    (n_obs, extend_upstream + extend_downstream + 1) int32 tensor on
    ``device`` (reference muon/_atac/tools.py:987-1068). The fetch is
    half-open, [Start − up, Start + down), so no fragment starting at the
    last position is read, as in the reference."""
    n = adata.n_obs
    n_pos = extend_downstream + extend_upstream + 1

    with stage("fragments/fetch(host)"), _open_fragments(adata, barcodes=barcodes) as frags:
        chromosomes = set(frags.contigs)
        features = features[features["Chromosome"].isin(chromosomes)]
        f_chr = features["Chromosome"].astype(str).to_numpy()
        f_start = features["Start"].to_numpy().astype(np.int64)
        res = frags.fetch_many(f_chr, f_start - extend_upstream, f_start + extend_downstream)
        tss_start = np.repeat(f_start - extend_upstream, np.diff(res["region_offsets"]))
        rel_starts = res["starts"] - tss_start
        rel_ends = res["ends"] - tss_start

    return _pileup.interval_pileup(res["cells"], rel_starts, rel_ends, res["scores"],
                                   n_cells=n, n_pos=n_pos, device=device)


def _calculate_tss_score(X: torch.Tensor, flank_size: int = 100, center_size: int = 1001):
    """ENCODE TSS score parts of a pileup (reference muon/_atac/tools.py:
    1071-1106): each cell's flank mean (the first and last ``flank_size``
    positions; a zero flank takes the mean of all flanks) and centre mean
    (the middle ``center_size`` positions), as float64 host arrays. The sums
    are int64 on X's device, exact; they are divided on the host, in numpy,
    as the reference's float64 means divide them (PyTorch on CUDA divides by
    a Python number as a product with its reciprocal, an ulp off)."""
    region_size = X.shape[1]
    if center_size > region_size:
        raise ValueError(
            f"`center_size` ({center_size}) must smaller than the piled up "
            f"region ({region_size})."
        )
    if center_size % 2 == 0:
        raise ValueError(f"`center_size` must be an uneven number, but is {center_size}.")

    def means(*blocks):
        total = sum(b.sum(dim=1, dtype=torch.int64) for b in blocks)
        return total.cpu().numpy() / sum(b.shape[1] for b in blocks)

    with stage("pileup/score"):
        flank_means = means(X[:, :flank_size], X[:, -flank_size:])
        flank_means[flank_means == 0] = flank_means.mean()
        center_dist = (region_size - center_size) // 2
        center_means = means(X[:, center_dist:-center_dist] if center_dist else X)
    return flank_means, center_means


def nucleosome_signal(
    data,
    n=None,
    nucleosome_free_upper_bound: int = 147,
    mononuleosomal_upper_bound: int = 294,
    barcodes: Optional[str] = None,
):
    """Per-cell ratio of mono-nucleosomal (147–294 bp) to nucleosome-free
    (< 147 bp) fragments over the first n records (default n_obs × 1e4) →
    ``obs["nucleosome_signal"]`` (reference muon/_atac/tools.py:1109-1201).
    The record scan runs in the native engine, the binning on the host."""
    adata = _get_atac(data)

    with stage("nucleosome/stream(host)"):
        with _open_fragments(adata, barcodes=barcodes) as frags:
            if n is None:
                n = int(adata.n_obs * 1e4)
            res = frags.stream(int(n))

        cells = res["cells"]
        lengths = res["ends"] - res["starts"]
        keep = cells >= 0
        cells, lengths = cells[keep], lengths[keep]

        nf = np.bincount(cells[lengths < nucleosome_free_upper_bound], minlength=adata.n_obs)
        mono = np.bincount(
            cells[(lengths >= nucleosome_free_upper_bound)
                  & (lengths < mononuleosomal_upper_bound)],
            minlength=adata.n_obs,
        )
        mat = np.stack([nf, mono], axis=1)
        mat[mat[:, 0] == 0, :] += 1  # prevent division by 0 (reference :1185)
        adata.obs["nucleosome_signal"] = mat[:, 1] / mat[:, 0]
    return None


def fetch_regions_to_df(
    fragment_path: str,
    features,
    extend_upstream: int = 0,
    extend_downstream: int = 0,
    relative_coordinates: bool = False,
):
    """Fetch fragments over regions (a BED-like DataFrame, or a region string
    ``chr:start-end``) into a tidy DataFrame (reference
    muon/_atac/tools.py:1204-1263)."""
    import pandas as pd

    if isinstance(features, str):
        features = utils.parse_region_string(features)

    dfs = []
    with TabixFragments(fragment_path) as frags:
        for i in range(features.shape[0]):
            f = features.iloc[i]
            res = frags.fetch(
                str(f.Chromosome),
                int(f.Start) - extend_upstream,
                int(f.End) + extend_downstream,
                names=True,
            )
            if len(res["starts"]) == 0:
                continue
            df = pd.DataFrame(
                {
                    "Chromosome": str(f.Chromosome),
                    "Start": res["starts"],
                    "End": res["ends"],
                    "Cell": res["names"],
                    "Score": res["scores"],
                }
            )
            df["Feature"] = f"{f.Chromosome}_{f.Start}_{f.End}"
            if relative_coordinates:
                middle = int(f.Start + (f.End - f.Start) / 2)
                df["Start"] = df["Start"] - middle
                df["End"] = df["End"] - middle
            dfs.append(df)

    return pd.concat(dfs, axis=0, ignore_index=True)
