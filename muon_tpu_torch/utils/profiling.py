"""Per-stage timing (counterpart of muon_tpu/utils/profiling.py).

``stage(name)`` brackets one stage of a public tool. It records only inside
a ``collect()`` block, so untimed runs pay nothing. Before it stops the
clock it synchronises the current CUDA stream: PyTorch returns before the
device finishes, and without the synchronise a stage's kernels would be
billed to whichever stage next waits on the device.

    with collect() as t:
        ac.pp.tfidf(adata)
        ac.tl.lsi(adata)
    t  # {"sparse/from_scipy": [s, s], "sparse/tfidf": [s], ...}
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch

__all__ = ["stage", "collect"]

_active: Optional[Dict[str, List[float]]] = None


@contextmanager
def collect() -> Iterator[Dict[str, List[float]]]:
    """Record the seconds of every ``stage`` entered inside the block."""
    global _active
    outer, _active = _active, {}
    try:
        yield _active
    finally:
        _active = outer


@contextmanager
def stage(name: str) -> Iterator[None]:
    timings = _active
    if timings is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()
        timings.setdefault(name, []).append(time.perf_counter() - t0)
