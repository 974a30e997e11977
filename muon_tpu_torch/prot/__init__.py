"""Protein modality module (``from muon_tpu_torch import prot as pt``).

``pp.dsb`` and ``pp.clr``; the readers ``read_10x_h5`` and ``read_10x_mtx``
(the Antibody Capture features).
"""

from . import preproc as pp
from .io import read_10x_h5, read_10x_mtx

__all__ = ["pp", "read_10x_h5", "read_10x_mtx"]
