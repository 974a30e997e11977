"""PWM motif scanning on the device (counterpart of muon_tpu/ops/pwm.py).

    pwm_scan  T36  <- _conv_fn (:114) and find_hits' comparison (:166)
                      (csrc/motif_kernels.cu)

The reference one-hot encodes the sequences to (N, L, 4) float32, convolves
them with the log-odds of every motif of one width, brings every score to
the host and thresholds there. At 100,000 peaks × 500 bp × 746 JASPAR motifs
that is 3.65e10 scores (146 GB), more than the card or a host holds. So the
port keeps the sequences as uint8 base codes (0-3 for ACGT/acgt, 4 for
anything else, padding included), compares each window with its motif's
threshold on the card, and moves only the hits: T36 counts the hits of every
(sequence, motif) pair, an exclusive scan of the counts gives each pair its
place in the reference's (sequence, motif, position) order, and T36 writes
the hits there. Nothing of size N × L × M is formed on the card.

Thresholds: the reference compares float32 scores with float64 thresholds.
The port compares with the least float32 not below each threshold
(:func:`threshold_f32`), which admits exactly the same float32 scores.

The log-odds and the thresholds (MOODS' definitions) are host numpy, bit for
bit the reference's:
  lo[b,j]   = log((pfm[b,j] + pc·bg[b]) / ((Σ_b pfm[b,j] + pc) · bg[b]))
  threshold = min t with P_bg(score ≥ t) ≤ p   (exact DP distribution)

The count and write passes screen on the tensor cores and decide by the
float32 chain (csrc/motif_kernels.cu): :func:`pack_screen` rounds every
motif's log-odds to fp16 in the fragment layout of ``mma.m16n8k16``, motifs
sorted by width in groups of 16, and lowers each motif's threshold by a
margin proven on the host (:func:`screen_margins`) to the screen's bar. A
window whose screened score reaches the bar is rescored by the scores
mode's chain (column order, from 0, float32 adds over the float32 rows);
that chain alone decides, so the hits are those of the scores mode's
scores thresholded at ``thr``.

Each wrapper runs its plain version (``F.conv1d`` of the one-hot per width,
the invalid mask, the comparison, ``nonzero`` and a sort) for tensors on the
CPU; for CUDA tensors it launches T36 or raises.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, on_card, resolve_device

__all__ = [
    "flat_bg",
    "pfm_to_log_odds",
    "threshold_from_p",
    "threshold_f32",
    "encode_sequences",
    "pack_motifs",
    "pack_screen",
    "screen_margins",
    "screen_scores_plain",
    "Screen",
    "pwm_scan_hits",
    "pwm_scan_hits_plain",
    "pwm_scores",
    "pwm_scores_plain",
    "scan_scores",
    "find_hits",
]

# byte -> base code: 0-3 for ACGT and acgt, 4 for every other byte
_BASE_CODE = np.full(256, 4, np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _BASE_CODE[_b] = _i
for _i, _b in enumerate(b"acgt"):
    _BASE_CODE[_b] = _i
INVALID = 4

_MODE_COUNT, _MODE_WRITE, _MODE_SCORES = 0, 1, 2


def flat_bg(n: int = 4) -> np.ndarray:
    return np.full(n, 1.0 / n)


def pfm_to_log_odds(pfm: np.ndarray, bg=None, pseudocount: float = 0.0001) -> np.ndarray:
    """Position-frequency matrix (4, w) → log-odds (4, w), MOODS semantics
    (reference usage: muon/_atac/tools.py:414)."""
    pfm = np.asarray(pfm, np.float64)
    if bg is None:
        bg = flat_bg(4)
    bg = np.asarray(bg, np.float64)
    total = pfm.sum(axis=0, keepdims=True)
    p = (pfm + pseudocount * bg[:, None]) / (total + pseudocount)
    return np.log(p / bg[:, None])


def threshold_from_p(lo: np.ndarray, bg=None, pvalue: float = 0.0001) -> float:
    """Smallest score t with P_bg(score ≥ t) ≤ pvalue, by exact DP over the
    discretized per-column score distribution (MOODS threshold_from_p
    semantics; reference usage muon/_atac/tools.py:438)."""
    lo = np.asarray(lo, np.float64)
    if bg is None:
        bg = flat_bg(4)
    bg = np.asarray(bg, np.float64)
    w = lo.shape[1]
    # discretize to integer grid fine enough for w columns
    span = lo.max() - lo.min()
    scale = 20000.0 / max(span * w, 1e-9)
    iscores = np.round(lo * scale).astype(np.int64)  # (4, w)
    offset = iscores.min(axis=0)  # per column min
    shifted = iscores - offset[None, :]
    max_total = int(shifted.max(axis=0).sum())
    dist = np.zeros(max_total + 1)
    dist[0] = 1.0
    pos = 0
    for j in range(w):
        col = np.zeros(int(shifted[:, j].max()) + 1)
        for b in range(4):
            col[shifted[b, j]] += bg[b]
        dist = np.convolve(dist[: pos + 1], col)
        pos += int(shifted[:, j].max())
    # tail probabilities, descending score
    tail = np.cumsum(dist[::-1])[::-1]
    ok = np.nonzero(tail <= pvalue)[0]
    if len(ok) == 0:
        t_int = max_total + 1  # nothing passes
    else:
        t_int = ok[0]
    return (t_int + offset.sum()) / scale


def threshold_f32(thresholds) -> np.ndarray:
    """The least float32 not below each float64 threshold: a float32 score s
    passes ``s >= t32`` exactly when ``float64(s) >= threshold`` (rounded up
    with nextafter, never to nearest)."""
    thr = np.asarray(thresholds, np.float64)
    t32 = thr.astype(np.float32)
    low = t32.astype(np.float64) < thr
    t32[low] = np.nextafter(t32[low], np.float32(np.inf))
    return t32


def encode_sequences(sequences: Sequence[str]) -> np.ndarray:
    """uint8 base codes (n, L_max): 0-3 for ACGT or acgt, 4 for everything
    else (N, IUPAC letters, padding). One vectorised lookup over the joined
    bytes (a character outside ASCII is one invalid base)."""
    n = len(sequences)
    lengths = np.fromiter(map(len, sequences), np.int64, n)
    L = int(lengths.max()) if n else 0
    joined = np.frombuffer("".join(sequences).encode("ascii", "replace"), np.uint8)
    if n and (lengths == L).all():
        return _BASE_CODE[joined].reshape(n, L)
    codes = np.full((n, L), INVALID, np.uint8)
    codes[np.arange(L)[None, :] < lengths[:, None]] = _BASE_CODE[joined]
    return codes


def pack_motifs(log_odds: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (4, w_m) log-odds of every motif as one float32 (Σw, 4) table (a
    row per column: A, C, G, T), with each motif's first row and width."""
    widths = np.array([np.shape(lo)[1] for lo in log_odds], np.int32)
    off = np.zeros(len(widths), np.int32)
    if len(widths):
        off[1:] = np.cumsum(widths[:-1])
    lo = np.concatenate([np.asarray(m, np.float32).T for m in log_odds], axis=0) \
        if len(widths) else np.zeros((0, 4), np.float32)
    return np.ascontiguousarray(lo), off, widths


# T36's screen (csrc/motif_kernels.cu, whose header derives the margin): a
# k-step of mma.m16n8k16 multiplies 16 = 4 motif columns x 4 bases, a group
# is the 16 motifs of two n8 tiles
_NT, _STEP_COLS, _LANES = 2, 4, 32
_GROUP = 8 * _NT
_TC_ROUND = 2.0 ** -20  # a k-step's result within this of its running magnitude (assumed)
_CHAIN_ROUND = 2.0 ** -23  # one float32 add's error against a bound on its result, with room
_SLACK = 2.0 ** -20  # the float64 sums of the margin, relative


@dataclass
class Screen:
    """T36's screen of one packed motif set (:func:`pack_screen`): numpy
    arrays on the host, tensors after :meth:`to` (the margins stay numpy).

    frag        (steps, 32, 4) int32 bits: per group and k-step, each lane's
                B fragments of the group's two n8 tiles (two fp16 pairs
                each), the groups' steps in order
    groups      (G, 2) int32: first step, k-steps
    slot_motif  (16 G,) int32: the motif in each slot, by width; -1 pads
    slot_thr    (16 G,) float32: the screen's bar, thr - margin rounded
                down (+inf pads)
    slot_width  (16 G,) int32: each slot's width (0 pads)
    margin      (M,) float64: each motif's proven margin
    steps       (G,) int64: each group's k-steps (host)
    source      (lo, off, width, thr): the operands it was packed from, which
                :func:`pwm_scan_hits` holds the operands it is given to
    """

    frag: object
    groups: object
    slot_motif: object
    slot_thr: object
    slot_width: object
    margin: np.ndarray
    steps: np.ndarray
    source: tuple

    def to(self, dev) -> "Screen":
        def move(a):
            return a if isinstance(a, torch.Tensor) and a.device == dev else \
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        tables = {f: move(getattr(self, f)) for f in _SCREEN_TABLES}
        return replace(self, **tables, source=tuple(move(a) for a in self.source))


_SCREEN_TABLES = ("frag", "groups", "slot_motif", "slot_thr", "slot_width")


def _check_packed(off: np.ndarray, width: np.ndarray, rows: int) -> None:
    packed = np.zeros_like(off)
    packed[1:] = np.cumsum(width[:-1])
    if (off != packed).any() or int(width.sum()) != rows or (width < 1).any():
        raise ValueError("off and width must be the packed layout of lo (pack_motifs)")


def screen_margins(lo: np.ndarray, off: np.ndarray, width: np.ndarray,
                   steps: np.ndarray) -> np.ndarray:
    """Each motif's margin, float64: how far T36's screened score of any of
    its windows may lie from the float32 chain's (csrc/motif_kernels.cu
    derives it). With e_j = max_b |lo_j,b - fp16(lo_j,b)| and the column
    maxima |lo|_j of the fp16 and the float32 rows, summed over the motif's
    w columns into E, M16 and M32, and the group's ``steps`` k-steps:

        margin = (E + steps 2^-20 M16 + (w - 1) 2^-23 M32) (1 + 2^-20)

    ``lo`` is the packed float32 table of :func:`pack_motifs`. Raises on a
    log-odds that is not finite or that fp16 cannot hold."""
    lo = np.asarray(lo, np.float32)
    off, width = np.asarray(off, np.int64), np.asarray(width, np.int64)
    _check_packed(off, width, len(lo))
    if not np.isfinite(lo).all():
        raise ValueError("T36's screen needs finite log-odds; a motif holds "
                         f"{lo[~np.isfinite(lo)][0]}")
    with np.errstate(over="ignore"):
        lo16 = lo.astype(np.float16)
    if not np.isfinite(lo16).all():
        raise ValueError("T36's screen rounds the log-odds to fp16, whose range ends at "
                         f"65504; a motif holds {lo[~np.isfinite(lo16)][0]}")
    if not len(width):
        return np.zeros(0)
    l32, l16 = lo.astype(np.float64), lo16.astype(np.float64)
    E = np.add.reduceat(np.abs(l32 - l16).max(axis=1), off)
    M16 = np.add.reduceat(np.abs(l16).max(axis=1), off)
    M32 = np.add.reduceat(np.abs(l32).max(axis=1), off)
    return (E + np.asarray(steps) * _TC_ROUND * M16 + (width - 1) * _CHAIN_ROUND * M32) \
        * (1.0 + _SLACK)


def _below_f32(x: np.ndarray) -> np.ndarray:
    """The greatest float32 below x, with room for x's own rounding."""
    x = x - np.abs(x) * 2.0 ** -50
    x32 = x.astype(np.float32)
    low = x32.astype(np.float64) > x
    x32[low] = np.nextafter(x32[low], np.float32(-np.inf))
    return x32


def pack_screen(lo: np.ndarray, off: np.ndarray, width: np.ndarray, thr: np.ndarray) -> Screen:
    """T36's screen of the packed motifs ``lo``/``off``/``width`` (as
    :func:`pack_motifs` makes them) and their float32 thresholds ``thr``:
    the motifs sorted by width (stably) in groups of 16, each padded with
    zero columns to its group's widest motif rounded up to 4 columns,
    rounded to fp16 in the B-fragment layout of mma.m16n8k16 (for n8 tile h
    of the group, lane l holds columns tig/2 and tig/2 + 2 of its k-step,
    bases 2 (tig % 2) and the next, of slot 8 h + l / 4; tig = l % 4), and
    each motif's bar thr - margin."""
    lo = np.ascontiguousarray(lo, np.float32)
    off, width = np.asarray(off, np.int64), np.asarray(width, np.int64)
    thr = np.asarray(thr, np.float32)
    M = len(width)
    G = -(-M // _GROUP)
    order = np.argsort(width, kind="stable")
    slot_motif = np.full(G * _GROUP, -1, np.int32)
    slot_motif[:M] = order
    slot_width = np.zeros(G * _GROUP, np.int32)
    slot_width[:M] = width[order]
    wmax = slot_width.reshape(G, _GROUP).max(axis=1)
    steps = -(-wmax // _STEP_COLS)
    first = np.zeros(G, np.int64)
    first[1:] = np.cumsum(steps[:-1])
    m_steps = np.empty(M, np.int64)
    m_steps[order] = np.repeat(steps, _GROUP)[:M]
    margin = screen_margins(lo, off, width, m_steps)

    # the fp16 table [step, column of the step, slot of the group, base]
    tab = np.zeros((int(steps.sum()), _STEP_COLS, _GROUP, 4), np.float16)
    w_sorted = width[order]
    slot = np.repeat(np.arange(M), w_sorted)
    col = np.arange(len(slot)) - np.repeat(np.cumsum(w_sorted) - w_sorted, w_sorted)
    tab[first[slot // _GROUP] + col // _STEP_COLS, col % _STEP_COLS, slot % _GROUP] = \
        lo[off[order][slot] + col]
    lane = np.arange(_LANES)
    gid, tig = lane // 4, lane % 4
    bits = tab.view(np.uint16).astype(np.uint32)

    def pair(cc, slot):  # (steps, 32): bases b0 (low half) and b0 + 1 of column cc
        b0 = 2 * (tig % 2)
        return bits[:, cc, slot, b0] | (bits[:, cc, slot, b0 + 1] << 16)

    frag = np.stack([pair(cc, 8 * h + gid) for h in range(_NT)
                     for cc in (tig // 2, tig // 2 + 2)], axis=-1).view(np.int32)
    groups = np.stack([first, steps], axis=1).astype(np.int32)
    slot_thr = np.full(G * _GROUP, np.inf, np.float32)
    slot_thr[:M] = _below_f32(thr[order].astype(np.float64) - margin[order])
    return Screen(frag, groups, slot_motif, slot_thr, slot_width, margin, steps,
                  (lo, off.astype(np.int32), width.astype(np.int32), thr))


def screen_scores_plain(codes: torch.Tensor, screen: Screen) -> torch.Tensor:
    """The screen's scores without the tensor cores: the fp16 log-odds read
    back out of ``screen.frag`` by the kernel's lane layout, times the
    one-hot windows (a code of 4 a zero row, the sequence padded with such
    rows), summed by ``torch.matmul`` in float32: (n, L, 16 G), every
    position a window, in slot order (``screen.slot_motif``)."""
    frag = np.asarray(screen.frag.cpu() if isinstance(screen.frag, torch.Tensor)
                      else screen.frag).view(np.uint32)
    groups = np.asarray(screen.groups.cpu() if isinstance(screen.groups, torch.Tensor)
                        else screen.groups)
    n, L = codes.shape
    lane = np.arange(_LANES)
    gid, tig = lane // 4, lane % 4
    # B[step, k, slot]: k = 4 (column of the step) + base
    B = np.zeros((len(frag), 16, _GROUP), np.float32)
    for h in range(_NT):
        for reg, k0 in ((0, 2 * tig), (1, 2 * tig + 8)):
            for half in (0, 1):
                v = ((frag[:, :, 2 * h + reg] >> (16 * half)) & 0xFFFF).astype(np.uint16)
                B[:, k0 + half, 8 * h + gid] = v.view(np.float16)
    max_cols = int(groups[:, 1].max()) * _STEP_COLS if len(groups) else 0
    valid = codes < INVALID
    onehot = torch.zeros((n, L + max_cols, 4), dtype=torch.float32)
    onehot[:, :L].scatter_(2, codes.clamp(max=3).long().unsqueeze(2).cpu(),
                           valid.unsqueeze(2).float().cpu())
    out = torch.empty((n, L, len(groups) * _GROUP), dtype=torch.float32)
    for g, (s0, steps) in enumerate(groups.tolist()):
        cols = steps * _STEP_COLS
        win = onehot.unfold(1, cols, 1)[:, :L]  # (n, L, 4, cols)
        win = win.permute(0, 1, 3, 2).reshape(n, L, cols * 4)
        Bg = torch.from_numpy(B[s0:s0 + steps].reshape(cols * 4, _GROUP))
        out[:, :, g * _GROUP:(g + 1) * _GROUP] = win @ Bg
    return out


def _max_rows(dev: torch.device) -> int:
    """Log-odds rows (16 bytes a column) that fit the dynamic shared memory a
    block of T36's scores mode may opt into on ``dev`` (227 KB on an H100;
    T36 has no static shared memory)."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin // 16


# the screen's shared memory (screen_shm in the source): 512 bytes a k-step,
# 8 + 16 x 20 a group, and 16 warps' queues of 256 candidates and unit
# masks of 32 words
_UNIT_WORDS = 32  # a sequence's bits of (group, strip) units with a hit
_STEP_BYTES, _GROUP_BYTES = _LANES * 16, 8 + _GROUP * 20
_WARP_BYTES = 16 * (256 + _UNIT_WORDS) * 4
_MAX_GROUPS = 256


def _max_screen_bytes(dev: torch.device) -> int:
    """The dynamic shared memory a block of T36's screen may opt into on
    ``dev``."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _screen_chunks(screen: Screen, dev: torch.device) -> List[Tuple[int, int, int, int]]:
    """Runs [g0, g1) of the screen's groups, at most 256, whose fragments
    (k-steps [frag0, frag0 + steps)) and tables fit one block's shared
    memory on ``dev``: (g0, g1, frag0, steps), one launch each."""
    budget = _max_screen_bytes(dev) - _WARP_BYTES
    out, g0, used, first = [], 0, 0, 0
    for g, st in enumerate(screen.steps.tolist()):
        need = st * _STEP_BYTES + _GROUP_BYTES
        if need > budget:
            raise ValueError(f"group {g} is {st} k-steps; T36's screen takes at most "
                             f"{(budget - _GROUP_BYTES) // _STEP_BYTES}")
        if g > g0 and (used + need > budget or g - g0 == _MAX_GROUPS):
            out.append((g0, g, first, sum(screen.steps[g0:g].tolist())))
            first += out[-1][3]
            g0, used = g, 0
        used += need
    if len(screen.steps):
        out.append((g0, len(screen.steps), first, int(screen.steps[g0:].sum())))
    return out


def _chunks(lo: torch.Tensor, off: torch.Tensor,
            width: torch.Tensor) -> List[Tuple[int, int, int, int]]:
    """Runs [m0, m1) of consecutive motifs whose log-odds rows [row0, row0 +
    rows) fit one block's shared memory on ``lo``'s device: a larger set of
    motifs is scanned in chunks, one launch each. ``off`` and ``width`` must
    be the packed layout of :func:`pack_motifs`."""
    max_rows = _max_rows(lo.device)
    w_np, off_np = width.cpu().numpy(), off.cpu().numpy()
    _check_packed(off_np, w_np, lo.shape[0])
    out, m0, row0, rows = [], 0, 0, 0
    for m, w in enumerate(w_np.tolist()):
        if w > max_rows:
            raise ValueError(f"motif {m} is {w} columns wide; T36 takes at most {max_rows}")
        if rows + w > max_rows:
            out.append((m0, m, row0, rows))
            m0, row0, rows = m, row0 + rows, 0
        rows += w
    if m0 < len(w_np):
        out.append((m0, len(w_np), row0, rows))
    return out


def _check_operands(codes, lo, off, width, thr=None) -> None:
    if codes.dtype != torch.uint8 or codes.dim() != 2 or not codes.is_contiguous():
        raise ValueError(f"codes must be a contiguous 2-D uint8 tensor, got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if lo.dtype != torch.float32 or lo.dim() != 2 or lo.shape[1] != 4 or not lo.is_contiguous():
        raise ValueError(f"lo must be a contiguous (Σw, 4) float32 tensor, got {lo.dtype} "
                         f"{tuple(lo.shape)}")
    for name, t in (("off", off), ("width", width)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 tensor")
    if thr is not None and (thr.dtype != torch.float32 or thr.shape != off.shape):
        raise ValueError("thr must be a float32 tensor with one threshold a motif")
    if not all(t.device == codes.device for t in (lo, off, width, thr) if t is not None):
        raise ValueError("codes, lo, off, width and thr must lie on one device")
    if codes.shape[0] * max(len(off), 1) > 2**31 - 1 or codes.shape[1] > 2**30:
        raise ValueError(f"{codes.shape[0]} sequences × {len(off)} motifs exceed the int32 "
                         "range of T36's counts")


def _scan_args(mode, codes, lo, off, width, thr, chunk=(0, 0, 0, 0), counts=None,
               offsets=None, hits=None, scores=None, P=0, screen=None, groups=(0, 0, 0, 0),
               candidates=None, units=None) -> tuple:
    """The arguments of the C entry ``mt_pwm_scan`` but its stream:
    ``chunk`` (m0, m1, row0, rows) in the scores mode, ``screen`` and
    ``groups`` (g0, g1, frag0, steps) in the count and write modes."""
    n, L = codes.shape

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    seq, mot, pos, sc = hits if hits is not None else (None,) * 4
    tables = (None,) * 5 if screen is None else (getattr(screen, f) for f in _SCREEN_TABLES)
    return (codes.data_ptr(), n, L, lo.data_ptr(), off.data_ptr(), width.data_ptr(), ptr(thr),
            len(off), *chunk, mode, ptr(counts), ptr(offsets), ptr(seq), ptr(mot), ptr(pos),
            ptr(sc), ptr(scores), P, *(ptr(t) for t in tables), *groups, ptr(candidates),
            ptr(units))


def _launch(mode, codes, *args, **kw) -> None:
    """One T36 launch (:func:`_scan_args`)."""
    _kernels.launch("pwm_scan", codes.device, *_scan_args(mode, codes, *args, **kw))


def _check_screen(screen: Screen, lo, off, width, thr) -> Screen:
    """``screen`` on the operands' device, or ValueError when it was packed
    from other log-odds, layout or thresholds than these (bit for bit): its
    fp16 rows and its bars are right for those alone."""
    screen = screen.to(lo.device)
    ops = (lo, off, width, thr)
    if any(a.shape != b.shape or a.dtype != b.dtype for a, b in zip(screen.source, ops)):
        raise ValueError("the screen was packed for operands of other shapes or types")
    same = torch.ones((), dtype=torch.bool, device=lo.device)
    for a, b in zip(screen.source, ops):
        same &= (a.view(torch.int32) == b.view(torch.int32)).all()
    if not bool(same):
        raise ValueError("the screen was packed from other log-odds or thresholds than "
                         "the operands; pack_screen them")
    return screen


def pwm_scan_hits(codes: torch.Tensor, lo: torch.Tensor, off: torch.Tensor,
                  width: torch.Tensor, thr: torch.Tensor, screen: Optional[Screen] = None,
                  candidates: Optional[torch.Tensor] = None):
    """T36: every window of ``codes`` (n, L) uint8 whose score under a motif
    of the packed ``lo``/``off``/``width`` reaches its float32 ``thr``, as
    (seq, motif, position) int32 and score float32 tensors in (sequence,
    motif, position) order. A window with a code of 4 is no hit. ``screen``
    is :func:`pack_screen` of the same operands, bit for bit (packed here
    when not given; ValueError if it was packed from others, on the CPU
    too). Per chunk of the screen's groups two launches: the counts, then
    (after one exclusive scan of the counts over all chunks) the hits; both
    screen on the tensor cores and decide by the scores mode's chain.
    ``candidates``, a one-entry int64 tensor on the card, if given, gains
    the number of windows the count pass's screen passed to the chain."""
    if not on_card(codes):
        if screen is not None:
            _check_screen(screen, lo, off, width, thr)
        return pwm_scan_hits_plain(codes, lo, off, width, thr)
    _check_operands(codes, lo, off, width, thr)
    n, M = codes.shape[0], len(off)
    dev = codes.device
    if screen is None:
        screen = pack_screen(*(t.cpu().numpy() for t in (lo, off, width, thr))).to(dev)
    else:
        screen = _check_screen(screen, lo, off, width, thr)
    chunks = _screen_chunks(screen, dev) if n else []  # no sequence: nothing launched
    counts = torch.zeros((n, M), dtype=torch.int32, device=dev)
    # per chunk and sequence, the (group, strip) units with a hit (the write
    # pass screens only those)
    units = torch.zeros((len(chunks), n, _UNIT_WORDS), dtype=torch.int32, device=dev)
    with stage("motifs/count"):
        for c, groups in enumerate(chunks):
            _launch(_MODE_COUNT, codes, lo, off, width, thr, counts=counts, screen=screen,
                    groups=groups, candidates=candidates, units=units[c])
        flat = counts.view(-1)
        ends = torch.cumsum(flat, 0, dtype=torch.int64)
        total = int(ends[-1].item()) if flat.numel() else 0
    hits = tuple(torch.empty(total, dtype=t, device=dev)
                 for t in (torch.int32, torch.int32, torch.int32, torch.float32))
    if total:
        with stage("motifs/write"):
            cursor = ends.sub_(flat)  # each pair's first place, moved to its end
            for c, groups in enumerate(chunks):
                _launch(_MODE_WRITE, codes, lo, off, width, thr, counts=counts,
                        offsets=cursor, hits=hits, screen=screen, groups=groups,
                        units=units[c])
    return hits


@contextmanager
def _no_tf32():
    """cuDNN runs float32 convolutions in TF32 by default on the card (a
    10-bit mantissa): the plain version and the library timing run in full
    float32."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _by_width(width: torch.Tensor) -> Dict[int, List[int]]:
    groups: Dict[int, List[int]] = {}
    for m, w in enumerate(width.tolist()):
        groups.setdefault(int(w), []).append(m)
    return groups


def _conv_scores(codes: torch.Tensor, lo: torch.Tensor, off: torch.Tensor,
                 midx: List[int], w: int) -> torch.Tensor:
    """The reference's _conv_fn for the motifs ``midx`` of width ``w``:
    ``F.conv1d`` of the one-hot (n, 4, L) with (M_w, 4, w), and −inf where a
    window touches a code of 4. (n, L − w + 1, M_w) float32."""
    valid = codes < INVALID
    onehot = torch.zeros((*codes.shape, 4), dtype=torch.float32, device=codes.device)
    onehot.scatter_(2, codes.clamp(max=3).long().unsqueeze(2), valid.unsqueeze(2).float())
    rows = off[midx].long().unsqueeze(1) + torch.arange(w, device=codes.device)
    weight = lo[rows].permute(0, 2, 1).contiguous()  # (M_w, 4, w)
    with _no_tf32():
        scores = torch.nn.functional.conv1d(onehot.permute(0, 2, 1), weight)
        bad = torch.nn.functional.conv1d((~valid).float().unsqueeze(1),
                                         torch.ones((1, 1, w), device=codes.device))
    scores = scores.masked_fill_(bad > 0, float("-inf"))
    return scores.permute(0, 2, 1)


def pwm_scan_hits_plain(codes: torch.Tensor, lo: torch.Tensor, off: torch.Tensor,
                        width: torch.Tensor, thr: torch.Tensor):
    n, L = codes.shape
    parts = []
    for w, midx in _by_width(width).items():
        if w > L:
            continue
        scores = _conv_scores(codes, lo, off, midx, w)
        ok = scores >= thr[midx]
        si, pi, mi = ok.nonzero(as_tuple=True)
        parts.append((si, torch.as_tensor(midx, device=codes.device)[mi], pi, scores[ok]))
        del scores, ok
    if not parts:
        return tuple(torch.empty(0, dtype=t, device=codes.device)
                     for t in (torch.int32, torch.int32, torch.int32, torch.float32))
    si, mi, pi, sc = (torch.cat(c) for c in zip(*parts))
    key = (si * len(off) + mi) * max(L, 1) + pi
    order = torch.argsort(key)
    return (si[order].int(), mi[order].int(), pi[order].int(), sc[order])


def pwm_scores(codes: torch.Tensor, lo: torch.Tensor, off: torch.Tensor,
               width: torch.Tensor) -> torch.Tensor:
    """T36's scores mode: every window's score under every motif of one width
    (all of ``width`` equal), (n, L − w + 1, M) float32, −inf where a window
    touches a code of 4: the reference's ``_conv_fn``."""
    if not on_card(codes):
        return pwm_scores_plain(codes, lo, off, width)
    _check_operands(codes, lo, off, width)
    ws = torch.unique(width).tolist()
    if len(ws) != 1:
        raise ValueError(f"pwm_scores takes motifs of one width, got widths {ws}")
    n, L = codes.shape
    P = max(L - ws[0] + 1, 0)
    M = len(off)
    scores = torch.empty((n, P, M), dtype=torch.float32, device=codes.device)
    if P and n and M:
        for chunk in _chunks(lo, off, width):
            _launch(_MODE_SCORES, codes, lo, off, width, None, chunk, scores=scores, P=P)
    return scores


def pwm_scores_plain(codes, lo, off, width) -> torch.Tensor:
    ws = torch.unique(width).tolist()
    if len(ws) != 1:
        raise ValueError(f"pwm_scores takes motifs of one width, got widths {ws}")
    n, L = codes.shape
    if ws[0] > L:
        return torch.empty((n, 0, len(off)), dtype=torch.float32, device=codes.device)
    return _conv_scores(codes, lo, off, list(range(len(off))), ws[0])


def _upload(codes: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(codes)
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _packed(log_odds, dev):
    lo, off, width = pack_motifs(log_odds)
    return (torch.from_numpy(lo).to(dev), torch.from_numpy(off).to(dev),
            torch.from_numpy(width).to(dev))


def scan_scores(sequences: Sequence[str], log_odds: List[np.ndarray],
                device: DeviceLike = None) -> Dict[int, Tuple[np.ndarray, List[int]]]:
    """Every (sequence, offset, motif) score, for small inputs: {width:
    (scores (n, L − w + 1, M_w) float32, motif indices)}, widths in the
    order of their first motif, those wider than the longest sequence left
    out (the reference's ``scan_scores``)."""
    dev = resolve_device(device)
    codes = _upload(encode_sequences(sequences), dev)
    by_width: Dict[int, List[int]] = {}
    for m, lo in enumerate(log_odds):
        by_width.setdefault(np.shape(lo)[1], []).append(m)
    out = {}
    for w, midx in by_width.items():
        if codes.shape[1] < w:
            continue
        lo, off, width = _packed([log_odds[m] for m in midx], dev)
        out[w] = (pwm_scores(codes, lo, off, width).cpu().numpy(), midx)
    return out


def find_hits(sequences: Sequence[str], log_odds: List[np.ndarray],
              thresholds: Sequence[float], device: DeviceLike = None):
    """All (seq_idx, motif_idx, position, score) with score ≥ threshold, in
    the reference's lexsorted (sequence, motif, position) order: int64,
    int64, int64 and float32 arrays; float64 scores when no motif is as
    narrow as the longest sequence, as the reference returns them."""
    dev = resolve_device(device)
    with stage("motifs/encode(host)"):
        codes_np = encode_sequences(sequences)
    L = codes_np.shape[1]
    if not any(np.shape(lo)[1] <= L for lo in log_odds):
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64))
    packed = pack_motifs(log_odds)
    thr_np = threshold_f32(thresholds)
    screen = None
    if dev.type == "cuda":
        with stage("motifs/screen(host)"):
            screen = pack_screen(*packed, thr_np)
    with stage("motifs/upload"):
        codes = _upload(codes_np, dev)
        lo, off, width = (torch.from_numpy(a).to(dev) for a in packed)
        thr = torch.from_numpy(thr_np).to(dev)
        if screen is not None:
            screen = screen.to(dev)
    seq, mot, pos, score = pwm_scan_hits(codes, lo, off, width, thr, screen)
    with stage("motifs/download"):
        seq, mot, pos = (t.cpu().numpy().astype(np.int64) for t in (seq, mot, pos))
        score = score.cpu().numpy()
    return seq, mot, pos, score
