"""ATAC modality module (``from muon_tpu_torch import atac as ac``).

Ported so far: ``pp.tfidf``, ``pp.binarize``, ``pp.scopen``, ``tl.lsi``,
``tl.rank_peaks_groups``, ``tl.add_genes_peaks_groups``, the peak annotation
(``tl.add_peak_annotation``, ``tl.add_peak_annotation_gene_names``), the file
registry (``tl.locate_file``, ``tl.locate_genome``), the motif scan
(``tl.get_sequences`` from a genome FASTA, ``tl.scan_sequences`` over the
JASPAR motifs, thresholded on the card by T36) and the fragment QC tools
(``tl.locate_fragments``, ``tl.initialise_default_files``,
``tl.nucleosome_signal``, ``tl.tss_enrichment`` with its pileup on the card
by T37, ``tl.count_fragments_features``, ``tl.fetch_regions_to_df``) over
the port's fragments engine (``fragments.TabixFragments``,
``fragments.write_fragments``).
"""

from . import preproc as pp
from . import tools as tl

__all__ = ["pp", "tl"]
