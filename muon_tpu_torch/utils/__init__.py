"""Utilities of the port: the cross-modality key grammar (``get_values``,
counterpart of muon_tpu.utils.get_values) and per-stage timing
(``utils.profiling``)."""

from .._core.utils import get_values

__all__ = ["get_values"]
