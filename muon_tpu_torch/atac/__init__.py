"""ATAC modality module (``from muon_tpu_torch import atac as ac``).

Ported so far: ``pp.tfidf``, ``pp.binarize`` and ``tl.lsi``.
"""

from . import preproc as pp
from . import tools as tl

__all__ = ["pp", "tl"]
