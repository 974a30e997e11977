"""Marker-gene statistics on the device (counterpart of the jitted programs of
muon_tpu/_core/tools_de.py).

    sorted_rank_sums     T26  <- ranksum (:175)          (csrc/de_kernels.cu)
    logreg_softmax_grad  T27  <- fit (:248): the loss's gradient in the logits
    adam_update          T28  <- fit (:248): optax.adam's update, L2 term added

``wilcoxon_rank_sums`` sorts X's columns in blocks (``torch.sort``, as the
reference sorts with ``jnp.argsort``) and hands each block to T26.
``group_moments`` gives the per-group sums of X and X² that every test
starts from: a sparse X through T3 (``ops.sparse.spmm_t``), as the
reference goes through its SpMM, a dense X through ``torch.matmul``.
``logreg_fit`` runs the reference's 200 Adam steps of softmax regression:
per step the two products X·W and Xᵀ·dZ in ``torch.matmul`` (float32, TF32
refused by ``ops.device``), T27 between them and T28 after.

Each wrapper runs its plain version for tensors on the CPU; for CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from . import sparse as dsp
from .device import on_card

__all__ = [
    "adam_update",
    "adam_update_plain",
    "dense_from_csr",
    "group_moments",
    "logreg_fit",
    "logreg_softmax_grad",
    "logreg_softmax_grad_plain",
    "sorted_rank_sums",
    "sorted_rank_sums_plain",
    "wilcoxon_rank_sums",
    "wilcoxon_rank_sums_plain",
]

# T26: the 64-bit tie term holds t^3 - t summed over runs up to n^3 < 2^63
MAX_RANK_CELLS = 2_000_000
# T26 keeps 8 warps' group counters (8 bytes each) in shared memory
MAX_GROUPS = 3_000
# bytes of one column block's sort working set (the transposed copy, the
# sorted values and the int64 permutation) that T26's wrapper aims for
RANK_BLOCK_BYTES = 4 << 30
# T27: rows each warp walks, warps a block (kGradWarps in the source), and
# the classes whose bias partials (8 warps x 4 bytes each) fit in 227 KB of
# shared memory
ROWS_PER_WARP, GRAD_WARPS, MAX_CLASSES = 32, 8, 7_000
# optax.adam's defaults, and the reference's learning rate
ADAM_B1, ADAM_B2, ADAM_EPS, LOGREG_LR = 0.9, 0.999, 1e-8, 5e-2


def _contiguous(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


# ---------------------------------------------------------------------------
# the inputs
# ---------------------------------------------------------------------------


def _onehot(codes: torch.Tensor, g: int) -> torch.Tensor:
    """(n, g) float32 indicator of each cell's group; a row of zeros for a
    cell without one (code −1)."""
    n = codes.shape[0]
    G = torch.zeros((n, g), dtype=torch.float32, device=codes.device)
    valid = codes >= 0
    G[torch.nonzero(valid).squeeze(1), codes[valid].long()] = 1.0
    return G


def dense_from_csr(X: dsp.DeviceCSR) -> torch.Tensor:
    """The (n_rows, n_cols) float32 dense matrix of a DeviceCSR, built where
    it lies (the reference densifies on the host: ``X.todense()``)."""
    out = torch.zeros(X.shape, dtype=torch.float32, device=X.device)
    rows = dsp._row_ids(X)
    out.index_put_((rows, X.indices.long()), X.data, accumulate=True)
    return out


def group_moments(X, codes: torch.Tensor, g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group sums of X and X², each (g, D) float32 (the reference's
    ``_group_moments``): a DeviceCSR through T3, a dense X through
    ``torch.matmul``, in column blocks so that X² is never whole."""
    G = _onehot(codes, g)
    with stage("de/moments"):
        if isinstance(X, dsp.DeviceCSR):
            s1 = dsp.spmm_t(X, G).T
            s2 = dsp.spmm_t(X._replace(data=X.data * X.data), G).T
            return s1.contiguous(), s2.contiguous()
        D = X.shape[1]
        step = max(1, (1 << 28) // max(X.shape[0], 1))
        s1 = torch.matmul(G.T, X)
        s2 = torch.empty_like(s1)
        for j0 in range(0, D, step):
            Xb = X[:, j0:j0 + step]
            s2[:, j0:j0 + step] = torch.matmul(G.T, Xb * Xb)
        return s1, s2


# ---------------------------------------------------------------------------
# T26: rank sums and tie terms
# ---------------------------------------------------------------------------


def wilcoxon_rank_sums(X: torch.Tensor, codes: torch.Tensor,
                       g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """For a dense X ``(n, D)`` float32 and the cells' group codes ``(n,)``
    int32 (−1: no group), the per-group sums of each column's tie-averaged
    ranks ``(g, D)`` float64 and each column's tie term Σ(t³ − t) over its
    tie runs ``(D,)`` int64, both exact. The columns go in blocks of as many
    as ``RANK_BLOCK_BYTES`` allows; each block is sorted along the cells by
    ``torch.sort``, then T26 (``sorted_rank_sums``) ranks it."""
    n, D = X.shape
    block_cols = max(1, min(D, RANK_BLOCK_BYTES // (16 * max(n, 1))))
    rank_sums = torch.empty((g, D), dtype=torch.float64, device=X.device)
    tie_term = torch.empty(D, dtype=torch.int64, device=X.device)
    for j0 in range(0, D, block_cols):
        with stage("de/rank_sort"):
            vals, perm = torch.sort(X[:, j0:j0 + block_cols].T, dim=1, stable=True)
            vals, perm = vals.contiguous(), perm.contiguous()
        with stage("de/rank_sums"):
            rs, tt = sorted_rank_sums(vals, perm, codes, g)
            rank_sums[:, j0:j0 + block_cols] = rs
            tie_term[j0:j0 + block_cols] = tt
        del vals, perm
    return rank_sums, tie_term


def wilcoxon_rank_sums_plain(X: torch.Tensor, codes: torch.Tensor,
                             g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, perm = torch.sort(X.T, dim=1, stable=True)
    return sorted_rank_sums_plain(vals, perm, codes, g)


def sorted_rank_sums(vals: torch.Tensor, perm: torch.Tensor, codes: torch.Tensor,
                     g: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """T26: from a block of b columns sorted along the n cells, ``vals (b, n)``
    float32 and ``perm (b, n)`` int64 (``torch.sort``'s), and the cells'
    codes ``(n,)`` int32, the rank sums ``(g, b)`` float64 and tie terms
    ``(b,)`` int64."""
    if not on_card(vals):
        return sorted_rank_sums_plain(vals, perm, codes, g)
    b, n = vals.shape
    _contiguous("vals", vals, torch.float32, (b, n), vals.device)
    _contiguous("perm", perm, torch.int64, (b, n), vals.device)
    _contiguous("codes", codes, torch.int32, (n,), vals.device)
    if n > MAX_RANK_CELLS or b > 2**31 - 1:
        raise ValueError(f"a block of {b} x {n}: T26 takes at most {MAX_RANK_CELLS} cells")
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"T26 takes 1 to {MAX_GROUPS} groups, got {g}")
    rank_sums = torch.empty((g, b), dtype=torch.float64, device=vals.device)
    tie_term = torch.empty(b, dtype=torch.int64, device=vals.device)
    _kernels.launch(
        "wilcoxon_rank_sums", vals.device,
        vals.data_ptr(), perm.data_ptr(), codes.data_ptr(), n, b, g,
        rank_sums.data_ptr(), tie_term.data_ptr(),
    )
    return rank_sums, tie_term


def sorted_rank_sums_plain(vals, perm, codes, g):
    b, n = vals.shape
    pos = torch.arange(n, device=vals.device).expand(b, n)
    start = torch.ones_like(vals, dtype=torch.bool)
    start[:, 1:] = vals[:, 1:] != vals[:, :-1]
    end = torch.ones_like(vals, dtype=torch.bool)
    end[:, :-1] = start[:, 1:]
    lo = torch.where(start, pos, 0).cummax(dim=1).values
    hi = torch.where(end, pos + 1, n).flip(1).cummin(dim=1).values.flip(1)
    twice = lo + 1 + hi  # twice the average rank, exact in int64
    t = (hi - lo)[end]
    tie_term = torch.zeros(b, dtype=torch.int64, device=vals.device)
    tie_term.index_add_(0, torch.nonzero(end)[:, 0], t * t * t - t)
    cell_codes = codes.long()[perm]  # (b, n)
    valid = cell_codes >= 0
    flat = torch.zeros(b * g, dtype=torch.int64, device=vals.device)
    col = torch.arange(b, device=vals.device)[:, None].expand(b, n)
    flat.index_add_(0, (col * g + cell_codes)[valid], twice[valid])
    return (flat.reshape(b, g).T.double() * 0.5).contiguous(), tie_term


# ---------------------------------------------------------------------------
# T27, T28: the logreg step
# ---------------------------------------------------------------------------


def logreg_softmax_grad(Z: torch.Tensor, b: torch.Tensor, y: torch.Tensor,
                        wv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """T27: the gradient of Σᵢ wvᵢ · CE(Zᵢ + b, yᵢ) in the logits, ``dZ (n, g)``,
    and in the bias, ``db (g,)`` (the column sums of dZ in a fixed order), for
    the logits without the bias ``Z (n, g)`` float32, ``b (g,)`` float32, the
    labels ``y (n,)`` int32 and the weights ``wv (n,)`` float32."""
    if not on_card(Z):
        return logreg_softmax_grad_plain(Z, b, y, wv)
    n, g = Z.shape
    _contiguous("Z", Z, torch.float32, (n, g), Z.device)
    _contiguous("b", b, torch.float32, (g,), Z.device)
    _contiguous("y", y, torch.int32, (n,), Z.device)
    _contiguous("wv", wv, torch.float32, (n,), Z.device)
    if n > 2**31 - 1 or g > MAX_CLASSES:
        raise ValueError(f"Z of shape {(n, g)}: T27 takes at most {MAX_CLASSES} classes")
    blocks = -(-n // (ROWS_PER_WARP * GRAD_WARPS))
    partial = torch.empty((blocks * GRAD_WARPS, g), dtype=torch.float32, device=Z.device)
    dZ = torch.empty_like(Z)
    db = torch.empty_like(b)
    _kernels.launch(
        "logreg_softmax_grad", Z.device,
        Z.data_ptr(), b.data_ptr(), y.data_ptr(), wv.data_ptr(), n, g, ROWS_PER_WARP,
        partial.data_ptr(), dZ.data_ptr(), db.data_ptr(),
    )
    return dZ, db


def logreg_softmax_grad_plain(Z, b, y, wv):
    v = Z + b
    e = torch.exp(v - v.max(dim=1, keepdim=True).values)
    s = e.sum(dim=1, keepdim=True)
    dZ = (wv[:, None] / s) * e
    rows = torch.arange(Z.shape[0], device=Z.device)
    dZ[rows, y.long()] += -wv
    return dZ, dZ.sum(dim=0)


def _adam_constants(step: int, C: float):
    """reg = 0.5 / C, optax.adam's decays and their complements, its bias
    corrections after the count's increment (float64, then float32 as the
    reference casts them), eps and −LOGREG_LR: as the float32 numbers the
    update uses."""
    f = lambda x: float(np.float32(x))  # noqa: E731
    return dict(reg=f(0.5 / C), b1=f(ADAM_B1), omb1=f(1 - ADAM_B1), b2=f(ADAM_B2),
                omb2=f(1 - ADAM_B2), bc1=f(1 - ADAM_B1 ** step),
                bc2=f(1 - ADAM_B2 ** step), eps=f(ADAM_EPS), neg_lr=f(-LOGREG_LR))


def adam_update(W, gW, mW, vW, b, gb, mb, vb, step: int, C: float = 1.0) -> None:
    """T28, in place: W's gradient ``gW`` gets the L2 term (0.5 / C)·(2W),
    then optax.adam's update of (W, mW, vW) and (b, mb, vb) at ``step``
    (1-based: the count after its increment). Every tensor float32 and
    contiguous, W-side (D, g), b-side (g,)."""
    if not on_card(W):
        return adam_update_plain(W, gW, mW, vW, b, gb, mb, vb, step, C)
    for name, t in (("gW", gW), ("mW", mW), ("vW", vW)):
        _contiguous(name, t, torch.float32, W.shape, W.device)
    _contiguous("W", W, torch.float32, W.shape, W.device)
    for name, t in (("b", b), ("gb", gb), ("mb", mb), ("vb", vb)):
        _contiguous(name, t, torch.float32, (b.numel(),), W.device)
    k = _adam_constants(step, C)
    _kernels.launch(
        "adam_update", W.device,
        W.data_ptr(), gW.data_ptr(), mW.data_ptr(), vW.data_ptr(), W.numel(),
        b.data_ptr(), gb.data_ptr(), mb.data_ptr(), vb.data_ptr(), b.numel(),
        k["reg"], k["b1"], k["omb1"], k["b2"], k["omb2"], k["bc1"], k["bc2"], k["eps"],
        k["neg_lr"],
    )


def adam_update_plain(W, gW, mW, vW, b, gb, mb, vb, step: int, C: float = 1.0) -> None:
    k = _adam_constants(step, C)
    for p, gr, m, v in ((W, gW + k["reg"] * (2.0 * W), mW, vW), (b, gb, mb, vb)):
        m.copy_(k["omb1"] * gr + k["b1"] * m)
        v.copy_(k["omb2"] * (gr * gr) + k["b2"] * v)
        u = (m / k["bc1"]) / (torch.sqrt(v / k["bc2"]) + k["eps"])
        p.add_(u * k["neg_lr"])


def logreg_fit(X: torch.Tensor, y: torch.Tensor, wv: torch.Tensor, g: int,
               C: float = 1.0, n_steps: int = 200) -> torch.Tensor:
    """The reference's ``fit``: softmax regression of the labels ``y`` with
    the weights ``wv`` on a dense X ``(n, D)`` float32, from zeros, ``n_steps``
    Adam steps (learning rate ``LOGREG_LR``) of the loss
    Σ wv·CE + (0.5 / C)·ΣW²; returns W ``(D, g)`` with each row centred."""
    D = X.shape[1]
    W = torch.zeros((D, g), dtype=torch.float32, device=X.device)
    b = torch.zeros(g, dtype=torch.float32, device=X.device)
    mW, vW, mb, vb = (torch.zeros_like(W), torch.zeros_like(W), torch.zeros_like(b),
                      torch.zeros_like(b))
    for step in range(1, n_steps + 1):
        with stage("de/logreg_products"):
            Z = torch.matmul(X, W)
        with stage("de/logreg_kernels"):
            dZ, db = logreg_softmax_grad(Z, b, y, wv)
        with stage("de/logreg_products"):
            gW = torch.matmul(X.T, dZ)
        with stage("de/logreg_kernels"):
            adam_update(W, gW, mW, vW, b, db, mb, vb, step, C)
    return W - W.mean(dim=1, keepdim=True)
