"""Motif scanning: JASPAR PWMs scored on the device (counterpart of
muon_tpu/atac/motifs.py).

Reimplements the reference's MOODS-based scanning stack
(muon/_atac/tools.py:381-517) over the port's PWM scan (ops/pwm: T36
thresholds every window on the card and moves only the hits) and its own
copy of the JASPAR database (muon_tpu_torch/atac/_ref/: 746 PFMs in one
npz). pandas is imported inside the functions that build frames.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Union

import numpy as np

from ..ops import pwm as _pwm
from ..ops.device import DeviceLike, resolve_device
from ..utils.profiling import stage
from .preproc import _get_atac

__all__ = ["scan_sequences", "get_sequences"]

_REF_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_ref")


def _parse_motif_ids(filename: Optional[str] = None):
    """motif_id → TF gene name table (reference muon/_atac/tools.py:381-389)."""
    import pandas as pd

    if filename is None:
        filename = os.path.join(_REF_DIR, "motif_to_gene.txt")
    motifs = pd.read_csv(filename, sep="\t", header=None)
    motifs.columns = ["motif_id", "tf_gene_name"]
    return motifs.set_index("motif_id")


def _load_jaspar_pfms():
    data = np.load(os.path.join(_REF_DIR, "jaspar_pfms.npz"))
    names = sorted(data.files)
    return names, [data[n] for n in names]


def _background(background: Union[int, Iterable]) -> np.ndarray:
    return (_pwm.flat_bg(background) if not isinstance(background, Iterable)
            else np.asarray(list(background), np.float64))


def _parse_motif_matrices(
    files: Optional[List[str]] = None,
    background: Union[int, Iterable] = 4,
    pseudocount: float = 0.0001,
):
    """PFMs → log-odds matrices (reference muon/_atac/tools.py:392-416;
    MOODS pfm_to_log_odds semantics in ops/pwm)."""
    bg = _background(background)
    if files is None:
        names, pfms = _load_jaspar_pfms()
    else:
        names = [os.path.basename(f)[:-4] if f.endswith(".pfm") else f for f in files]
        pfms = [np.loadtxt(f) for f in files]
    matrices = [_pwm.pfm_to_log_odds(p, bg, pseudocount) for p in pfms]
    return {"motifs": names, "matrices": matrices}


class MotifScanner:
    """Device PWM scanner: matrices, per-motif p-value thresholds and the
    device it scans on (replaces MOODS.scan.Scanner, reference
    muon/_atac/tools.py:419-443)."""

    def __init__(self, matrices, bg, thresholds, device: DeviceLike = None):
        self.matrices = [np.asarray(m, np.float64) for m in matrices]
        self.bg = bg
        self.thresholds = np.asarray(thresholds, np.float64)
        self.device = resolve_device(device)

    def scan(self, sequences):
        return _pwm.find_hits(list(sequences), self.matrices, self.thresholds,
                              device=self.device)


def _prepare_motif_scanner(
    matrices=None,
    background: Union[int, Iterable] = 4,
    pvalue: float = 0.0001,
    max_hits: int = 10,
    device: DeviceLike = None,
) -> MotifScanner:
    bg = _background(background)
    if matrices is None:
        matrices = _parse_motif_matrices(files=None, background=background)["matrices"]
    with stage("motifs/thresholds(host)"):
        thresholds = [_pwm.threshold_from_p(m, bg, pvalue) for m in matrices]
    return MotifScanner(matrices, bg, thresholds, device=device)


def scan_sequences(
    sequences,
    motif_scanner: Optional[MotifScanner] = None,
    matrices=None,
    motifs=None,
    motif_meta=None,
    background: int = 4,
    pvalue: float = 0.0001,
    max_hits: int = 10,
    device: DeviceLike = None,
):
    """Scan sequences for motif hits (JASPAR by default); returns a
    DataFrame[sequence, motif_id, position, score] joined with motif
    metadata (reference muon/_atac/tools.py:446-517). ``max_hits`` is
    accepted and unused, as in the reference. ``device``: where a scanner
    built here scans (the card by default); a given ``motif_scanner`` scans
    on its own device."""
    import pandas as pd

    # the reference's AssertionErrors, raised so that they hold under -O too
    if motifs is None and matrices is not None:
        raise AssertionError(
            "Both a list of matrices and a corresponding list of motif IDs "
            "should be provided — or none to use the built-in ones, unless "
            "a scanner is provided."
        )

    if motif_scanner is None:
        if matrices is None:
            parsed = _parse_motif_matrices(files=None, background=background)
            motifs = parsed["motifs"]
            matrices = parsed["matrices"]
        motif_scanner = _prepare_motif_scanner(
            matrices=matrices, background=background, pvalue=pvalue,
            max_hits=max_hits, device=device,
        )
        if motif_meta is None:
            motif_meta = _parse_motif_ids()
    elif motifs is None:
        raise AssertionError(
            "A list of motif IDs should be provided that corresponds to the "
            "matrices that the motif scanner was built on."
        )

    sequences = list(sequences)
    seq_i, mot_i, pos, score = motif_scanner.scan(sequences)
    with stage("motifs/frame(host)"):
        seq_arr = np.empty(len(sequences), dtype=object)
        seq_arr[:] = sequences
        mot_arr = np.empty(len(motifs), dtype=object)
        mot_arr[:] = list(motifs)
        matches = pd.DataFrame(
            {
                "sequence": seq_arr[seq_i],
                "motif_id": mot_arr[mot_i],
                "position": pos,
                "score": score,
            }
        )
        if motif_meta is not None:
            matches = (
                matches.set_index("motif_id").join(motif_meta, how="left").reset_index()
            )
    return matches


def _peak_names(adata):
    """The ATAC features' names: ``var.index``, or ``var_names`` where there
    is no ``var`` with an index."""
    var = getattr(adata, "var", None)
    index = getattr(var, "index", None)
    return np.asarray(index if index is not None else adata.var_names)


def get_sequences(
    data,
    bed: Optional[str],
    fasta_file: Optional[str] = None,
    bed_file: Optional[str] = None,
) -> List[str]:
    """Extract sequences for BED intervals from an (indexed) genome FASTA
    (reference muon/_atac/tools.py:520-566 — pybedtools replaced by the
    in-repo faidx reader). ``data`` is AnnData-like, or MuData-like with an
    ``atac`` modality (duck-typed); with ``bed=None`` the peaks are its
    features, named ``chrN:start-end``."""
    adata = _get_atac(data)

    if "files" not in adata.uns or "genome" not in adata.uns["files"]:
        if fasta_file is not None:
            from .tools import locate_genome

            locate_genome(adata, fasta_file)
        else:
            raise FileNotFoundError(
                "Genome file has to be provided with `fasta_file` or located "
                "using muon_tpu_torch.atac.tl.locate_genome."
            )
    else:
        fasta_file = adata.uns["files"]["genome"]

    if bed_file is not None:
        if bed is not None:
            raise AssertionError("give either bed or bed_file")
        with open(bed_file) as f:
            bed = f.read()
    elif bed is None:
        # use all ATAC features, expected to be named chrX:NNN-NNN
        bed = "\n".join(
            i.replace(":", "-", 1).replace("-", "\t", 2) for i in _peak_names(adata)
        )

    from ._fasta import FastaFile

    sequences = []
    with stage("fasta/fetch(host)"), FastaFile(fasta_file) as fa:
        for line in bed.strip().splitlines():
            if not line.strip():
                continue
            parts = line.split("\t")
            chrom, start, end = parts[0], int(parts[1]), int(parts[2])
            sequences.append(fa.fetch(chrom, start, end))
    return sequences
