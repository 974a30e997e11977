"""RNA modality module (``from muon_tpu_torch import rna``; counterpart of
muon_tpu/rna)."""

from . import utils

__all__ = ["utils"]
