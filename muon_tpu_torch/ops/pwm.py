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

Each wrapper runs its plain version (``F.conv1d`` of the one-hot per width,
the invalid mask, the comparison, ``nonzero`` and a sort) for tensors on the
CPU; for CUDA tensors it launches T36 or raises.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Sequence, Tuple

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


def _max_rows(dev: torch.device) -> int:
    """Log-odds rows (16 bytes a column) that fit the dynamic shared memory a
    block of T36 may opt into on ``dev`` (227 KB on an H100; T36 has no
    static shared memory)."""
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin // 16


def _chunks(lo: torch.Tensor, off: torch.Tensor,
            width: torch.Tensor) -> List[Tuple[int, int, int, int]]:
    """Runs [m0, m1) of consecutive motifs whose log-odds rows [row0, row0 +
    rows) fit one block's shared memory on ``lo``'s device: a larger set of
    motifs is scanned in chunks, one launch each. ``off`` and ``width`` must
    be the packed layout of :func:`pack_motifs`."""
    max_rows = _max_rows(lo.device)
    w_np, off_np = width.cpu().numpy(), off.cpu().numpy()
    packed = np.zeros_like(off_np)
    packed[1:] = np.cumsum(w_np[:-1])
    if (off_np != packed).any() or int(w_np.sum()) != lo.shape[0] or (w_np < 1).any():
        raise ValueError("off and width must be the packed layout of lo (pack_motifs)")
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


def _launch(mode, codes, lo, off, width, thr, chunk, counts=None, offsets=None,
            hits=None, scores=None, P=0) -> None:
    n, L = codes.shape
    null = 0
    seq, mot, pos, sc = hits if hits is not None else (None,) * 4
    _kernels.launch(
        "pwm_scan", codes.device,
        codes.data_ptr(), n, L, lo.data_ptr(), off.data_ptr(), width.data_ptr(),
        null if thr is None else thr.data_ptr(), len(off), *chunk, mode,
        null if counts is None else counts.data_ptr(),
        null if offsets is None else offsets.data_ptr(),
        *(null if t is None else t.data_ptr() for t in (seq, mot, pos, sc)),
        null if scores is None else scores.data_ptr(), P,
    )


def pwm_scan_hits(codes: torch.Tensor, lo: torch.Tensor, off: torch.Tensor,
                  width: torch.Tensor, thr: torch.Tensor):
    """T36: every window of ``codes`` (n, L) uint8 whose score under a motif
    of the packed ``lo``/``off``/``width`` reaches its float32 ``thr``, as
    (seq, motif, position) int32 and score float32 tensors in (sequence,
    motif, position) order. A window with a code of 4 is no hit. Per chunk of
    motifs two launches: the counts, then (after one exclusive scan of the
    counts over all chunks) the hits."""
    if not on_card(codes):
        return pwm_scan_hits_plain(codes, lo, off, width, thr)
    _check_operands(codes, lo, off, width, thr)
    n, M = codes.shape[0], len(off)
    dev = codes.device
    chunks = _chunks(lo, off, width) if n else []  # no sequence: nothing launched
    counts = torch.empty((n, M), dtype=torch.int32, device=dev)
    with stage("motifs/count"):
        for chunk in chunks:
            _launch(_MODE_COUNT, codes, lo, off, width, thr, chunk, counts=counts)
        flat = counts.view(-1)
        ends = torch.cumsum(flat, 0, dtype=torch.int64)
        total = int(ends[-1].item()) if flat.numel() else 0
    hits = tuple(torch.empty(total, dtype=t, device=dev)
                 for t in (torch.int32, torch.int32, torch.int32, torch.float32))
    if total:
        with stage("motifs/write"):
            starts = ends.sub_(flat)
            for chunk in chunks:
                _launch(_MODE_WRITE, codes, lo, off, width, thr, chunk, counts=counts,
                        offsets=starts, hits=hits)
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
    with stage("motifs/upload"):
        codes = _upload(codes_np, dev)
        lo, off, width = _packed(log_odds, dev)
        thr = torch.from_numpy(threshold_f32(thresholds)).to(dev)
    seq, mot, pos, score = pwm_scan_hits(codes, lo, off, width, thr)
    with stage("motifs/download"):
        seq, mot, pos = (t.cpu().numpy().astype(np.int64) for t in (seq, mot, pos))
        score = score.cpu().numpy()
    return seq, mot, pos, score
