"""ATAC modality module (``from muon_tpu_torch import atac as ac``).

Ported so far: ``pp.tfidf``, ``pp.binarize``, ``pp.scopen``, ``tl.lsi``,
``tl.rank_peaks_groups`` and ``tl.add_genes_peaks_groups``.
"""

from . import preproc as pp
from . import tools as tl

__all__ = ["pp", "tl"]
