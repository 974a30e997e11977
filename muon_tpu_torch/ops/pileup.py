"""Per-cell interval coverage on the device (counterpart of
muon_tpu/ops/pileup.py).

    interval_pileup  T37  <- _pileup_fn (:29), via interval_pileup (:49)
                            (csrc/pileup_kernels.cu)

The TSS pileup of ``atac.tl.tss_enrichment``: for fragments (cell, start,
end, score), with start and end relative to the window, a difference array
gets +score at the fragment's start and −score at its end (both clipped to
[0, n_pos]; a cell outside [0, n_cells) and the column n_pos spill and are
dropped), and a cumulative sum along the positions gives each cell's
coverage, an (n_cells, n_pos) int32 matrix. int32 throughout, wrapping on
overflow as the reference does; integer sums do not depend on their order,
so T37 equals the plain version bit for bit. The reference pads the
fragment axis to a power of two against XLA recompiles; the port needs no
padding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, on_card, resolve_device

__all__ = ["interval_pileup", "interval_pileup_plain"]


def _as_int32(a, device: torch.device) -> torch.Tensor:
    """A 1-D int32 tensor on ``device``; a host array is cast as numpy casts
    (an int64 wraps into int32, as the reference's ``np.asarray(a,
    np.int32)``)."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))
    return a.to(device=device, dtype=torch.int32).reshape(-1).contiguous()


def interval_pileup(cells, starts, ends, scores, n_cells: int, n_pos: int,
                    device: DeviceLike = None) -> torch.Tensor:
    """T37: per-cell coverage over [start, end) intervals, an (n_cells,
    n_pos) int32 tensor on ``device``.

    cells: row ids (outside [0, n_cells), e.g. −1 for an unknown barcode,
    skipped); starts/ends: positions relative to the window, clipped to
    [0, n_pos]; scores: per-fragment weights. Host arrays are uploaded;
    tensors are moved to ``device``. On the CPU the plain version runs; on
    the card the kernel, launched (and counted) only when there is a
    fragment."""
    dev = resolve_device(device)
    n_cells, n_pos = int(n_cells), int(n_pos)
    if not (0 <= n_cells < 2**31 and 0 <= n_pos < 2**31):
        raise ValueError(f"n_cells and n_pos must lie in [0, 2**31), got {n_cells}, {n_pos}")
    with stage("pileup/upload"):
        c, s, e, w = (_as_int32(a, dev) for a in (cells, starts, ends, scores))
    if not (len(c) == len(s) == len(e) == len(w)):
        raise ValueError(
            f"cells, starts, ends and scores differ in length: "
            f"{len(c)}, {len(s)}, {len(e)}, {len(w)}")
    if not on_card(c):
        return interval_pileup_plain(c, s, e, w, n_cells, n_pos)
    with stage("pileup/kernel"):
        out = torch.zeros((n_cells, n_pos), dtype=torch.int32, device=dev)
        if len(c) and out.numel():
            _kernels.launch(
                "interval_pileup", dev,
                c.data_ptr(), s.data_ptr(), e.data_ptr(), w.data_ptr(), len(c),
                n_cells, n_pos, out.data_ptr(),
            )
    return out


def interval_pileup_plain(cells: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
                          scores: torch.Tensor, n_cells: int, n_pos: int) -> torch.Tensor:
    """The plain version of T37 on 1-D int32 tensors: the reference's
    difference array with its spill row and column, built with
    ``index_put_(..., accumulate=True)`` in int64, summed along the
    positions and cast back to int32 (a wrap, as int32 arithmetic wraps)."""
    dev = cells.device
    diff = torch.zeros((n_cells + 1, n_pos + 1), dtype=torch.int64, device=dev)
    row = torch.where((cells >= 0) & (cells < n_cells), cells, n_cells).long()
    w = scores.long()
    diff.index_put_((row, starts.clamp(0, n_pos).long()), w, accumulate=True)
    diff.index_put_((row, ends.clamp(0, n_pos).long()), -w, accumulate=True)
    return diff[:n_cells, :n_pos].cumsum(dim=1).to(torch.int32)
