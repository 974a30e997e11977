"""ATAC utilities (counterpart of muon_tpu/atac/utils.py; behavior of
reference muon/_atac/utils.py:5-11)."""

from __future__ import annotations

__all__ = ["parse_region_string"]


def parse_region_string(region: str):
    """Parse a genomic-region string into a one-row BED-like DataFrame.

    Accepts both ``chr1:1-2000000`` and ``chr1-1-2000000``. The chromosome
    name is everything before the first separator; start/end are the last
    two integer fields.
    """
    import pandas as pd

    for sep in (":", "-"):
        if sep in region:
            chrom, rest = region.split(sep, 1)
            break
    else:
        raise ValueError(f"cannot parse region string {region!r}")
    start_s, end_s = rest.replace(":", "-").rsplit("-", 1)[0], rest.rsplit("-", 1)[1]
    # start may itself still carry the chrom separator form chr-1-200
    start_s = start_s.split("-")[-1]
    return pd.DataFrame(
        {"Chromosome": [chrom], "Start": [int(start_s)], "End": [int(end_s)]}
    )
