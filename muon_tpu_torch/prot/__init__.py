"""Protein modality module (``from muon_tpu_torch import prot as pt``).

``pp.dsb`` and ``pp.clr``.
"""

from . import preproc as pp

__all__ = ["pp"]
