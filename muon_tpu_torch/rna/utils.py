"""RNA gene annotation helper (counterpart of muon_tpu/rna/utils.py;
reference muon/_rna/utils.py:7-37)."""

from __future__ import annotations

__all__ = ["get_gene_annotation_from_rna"]


def get_gene_annotation_from_rna(data):
    """Parse ``var["interval"]`` (``chr:start-end``) of the rna modality into
    a DataFrame(Chromosome/Start/End/gene_id/gene_name), dropping genes
    without coordinates: the features of ATAC fragment counting and TSS
    enrichment. ``data`` is AnnData-like (``.var``) or MuData-like with an
    ``rna`` modality."""
    import pandas as pd

    mod = getattr(data, "mod", None)
    if mod is not None and "rna" in mod:
        adata = mod["rna"]
    elif mod is None and hasattr(data, "var"):
        adata = data
    else:
        raise TypeError("Expected AnnData or MuData object with 'rna' modality")

    if "interval" not in adata.var.columns:
        raise ValueError(".var object does not have a column named interval")

    parts = []
    for s in adata.var["interval"]:
        if isinstance(s, str) and ":" in s:
            chrom, rest = s.split(":", 1)
            se = rest.split("-")
            if len(se) == 2:
                parts.append((chrom, se[0], se[1]))
                continue
        parts.append((None, None, None))
    features = pd.DataFrame(parts, columns=["Chromosome", "Start", "End"])
    if "gene_ids" in adata.var.columns:
        features["gene_id"] = adata.var["gene_ids"].values
    else:
        features["gene_id"] = adata.var.index.values
    features["gene_name"] = adata.var.index.values
    features.index = adata.var.index
    features = features.loc[~features.Start.isnull()]
    features["Start"] = features["Start"].astype(int)
    features["End"] = features["End"].astype(int)
    return features
