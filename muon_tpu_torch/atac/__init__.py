"""ATAC modality module (``from muon_tpu_torch import atac as ac``).

Ported so far: ``pp.tfidf``, ``pp.binarize``, ``pp.scopen``, ``tl.lsi``,
``tl.rank_peaks_groups``, ``tl.add_genes_peaks_groups``, the peak annotation
(``tl.add_peak_annotation``, ``tl.add_peak_annotation_gene_names``), the file
registry (``tl.locate_file``, ``tl.locate_genome``) and the motif scan
(``tl.get_sequences`` from a genome FASTA, ``tl.scan_sequences`` over the
JASPAR motifs, thresholded on the card by T36).
"""

from . import preproc as pp
from . import tools as tl

__all__ = ["pp", "tl"]
