"""Exact brute-force k-nearest neighbours on a CUDA device
(counterpart of muon_tpu/ops/knn.py).

    knn_topk        T5   <- _knn_fn + _topk2 (csrc/knn_kernels.cu)
    knn_ring_merge  T40  <- one round of parallel/pipeline.py _knn_ring_fn
                            (csrc/knn_kernels.cu, on T5's float32 tile)

The reference forms (block, n) distance tiles and selects with a chunked
top-k, or the TPU's approximate top-k under ``approx``. The port selects
exactly in both cases, over distances formed at the reference's rounding
points: under ``approx`` the operands are rounded to bfloat16 and the cross
term is summed and kept in float32. (A bfloat16 matmul in JAX returns
bfloat16 when run eagerly, but the reference runs it under jit, where XLA
folds the float32 convert into the dot and the cross term is never rounded;
the compiled HLO is a float32 dot of the two rounded operands.) Above
``IVF_THRESHOLD`` rows the approximate path switches to the IVF index
(ops/ivf.py), as the reference's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor

__all__ = ["knn", "knn_topk", "knn_topk_plain", "knn_ring_merge", "knn_ring_merge_plain",
           "ring_parts", "pairwise_sq_dists", "heap_row", "IVF_THRESHOLD", "LOCAL_LIST",
           "RING_MAX_PARTS"]

# above this row count the reference's approximate path takes the IVF index
IVF_THRESHOLD = 200_000
# T5 and T14 count lists (k + 1 places, self included) longer than this
# apart (knn_topk_global, ivf_search_global: the same kernels, every heap in
# a scratch row of heap_row words)
LOCAL_LIST = 256
# T40 cuts a round's rows into at most this many parts, each selected by
# blocks of its own (csrc/knn_kernels.cu kRingMaxParts)
RING_MAX_PARTS = 8
_RING_QUERIES = 256  # queries a block of T40 (knn_tile.cuh f32t::kQT)
_RING_BLOCKS_PER_SM = 2  # its blocks an SM holds (launch bounds, 110 KB of shared memory)
_RING_MIN_PART_ROWS = 1024  # fewer rows a part would leave a block little to amortise
_RING_SHORT_LIST = 32  # longer lists take one part: each part fills and sorts its own heap
_INT32_MAX = 2**31 - 1


def _block_rows(n: int, budget: int = 1 << 28) -> int:
    """Rows of the plain version's (block, n) distance tile: the reference's
    rule, so the f32 tile stays under ``budget`` bytes."""
    return int(min(max(128, budget // (4 * max(n, 1))), n))


def _metric(metric: str) -> str:
    if metric in ("sqeuclidean",):
        return "sqeuclidean"
    if metric in ("cosine", "correlation"):
        return metric
    if metric in ("euclidean", "l2"):
        return "euclidean"
    raise NotImplementedError(
        f"metric {metric!r} not supported by the TPU kNN kernel "
        "(euclidean/sqeuclidean/cosine/correlation available)"
    )


def _operand(X: torch.Tensor, metric: str, approx: bool):
    """The rows the cross term is taken over and the float32 squared norms
    (None for cosine/correlation), as the reference forms them: cosine and
    correlation rows are normalised (centred first for correlation) in
    float32, zero norms count as 1; ``approx`` rounds the operand to
    bfloat16 after that, the norms stay float32."""
    if metric in ("cosine", "correlation"):
        Z = X - X.mean(dim=1, keepdim=True) if metric == "correlation" else X
        norms = torch.linalg.norm(Z, dim=1, keepdim=True)
        op, sq = Z / torch.where(norms == 0, 1.0, norms), None
    else:
        op, sq = X, (X * X).sum(dim=1)
    if approx:
        op = op.to(torch.bfloat16).float()
    return op.contiguous(), sq


def _variant(k: int) -> str:
    """T5's launch counter for lists of k + 1: ``knn_topk`` up to
    ``LOCAL_LIST`` places, ``knn_topk_global`` beyond."""
    return "knn_topk" if k + 1 <= LOCAL_LIST else "knn_topk_global"


def heap_row(k: int) -> int:
    """64-bit words of scratch a query's heap of k places takes on the card
    (csrc/knn_tile.cuh ``knn_heap_row``): the k nodes after 7 unused words,
    rounded up to 64 bytes, so that the 8 children of every node share one
    64-byte group."""
    return (7 + k + 7) // 8 * 8


def _bf16_rows(X: torch.Tensor) -> torch.Tensor:
    """T5's tensor-core operand: ``X`` as bfloat16, each row padded with
    zeros to a multiple of 16 columns (mma's depth, and 16-byte rows for
    cp.async). Exact for the rows ``_operand`` rounded under ``approx``."""
    n, d = X.shape
    out = torch.zeros((n, -(-d // 16) * 16), dtype=torch.bfloat16, device=X.device)
    out[:, :d] = X
    return out


def knn_topk(
    X: torch.Tensor, sq: Optional[torch.Tensor], k: int, one_minus: bool,
    take_sqrt: bool, approx: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T5: self-kNN over the rows of ``X`` ``(n, d)`` float32. Returns idx
    ``(n, k+1)`` int32 and dists ``(n, k+1)`` float32: self in column 0 at
    distance 0, then the k others with the smallest distance, ties to the
    lower index. The distance is ``max(sq_i + sq_j − 2·cross, 0)``, or
    ``1 − cross`` when ``one_minus``, with the cross term summed in
    float32; ``take_sqrt`` returns the square roots of columns 1..k. Any
    k up to n − 1. ``approx``: X holds bfloat16 values (``_operand``'s
    approx rows); on the card the tensor cores then screen the candidates
    from X as bfloat16, and the float32 fma chain of the others decides, so
    the results are those without ``approx``, sooner."""
    if X.device.type == "cpu" and (sq is None or sq.device.type == "cpu"):
        return knn_topk_plain(X, sq, k, one_minus, take_sqrt)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    n, d = X.shape
    if not (1 <= d and n <= _INT32_MAX and d <= _INT32_MAX - 15):
        raise ValueError(f"X of shape {(n, d)} is outside what T5 takes")
    if not 0 <= k <= n - 1:
        raise ValueError(f"k={k} must lie in [0, n-1={n - 1}]")
    if not one_minus:
        if sq is None or sq.device != X.device or sq.dtype != torch.float32 \
                or tuple(sq.shape) != (n,) or not sq.is_contiguous():
            raise ValueError("sq must be a contiguous (n,) float32 tensor on X's device")
    op = _bf16_rows(X) if approx else X
    idx = torch.empty((n, k + 1), dtype=torch.int32, device=X.device)
    dists = torch.empty((n, k + 1), dtype=torch.float32, device=X.device)
    heaps = torch.empty(n * heap_row(k), dtype=torch.int64, device=X.device)
    _kernels.launch(
        _variant(k), X.device, op.data_ptr(), 0 if one_minus else sq.data_ptr(), n, d, k,
        int(one_minus), int(take_sqrt), int(bool(approx)), idx.data_ptr(), dists.data_ptr(),
        heaps.data_ptr(),
    )
    return idx, dists


def _order_keys(dist: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int64 keys that sort as (distance, column) does: the float's bits
    mapped to an order-preserving int32 in the high word, the column in the
    low word. Every key is distinct, so a top-k over them has no ties."""
    bits = (dist + 0.0).view(torch.int32)  # + 0.0 turns -0 into +0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.long() << 32) | cols


def knn_topk_plain(
    X: torch.Tensor, sq: Optional[torch.Tensor], k: int, one_minus: bool,
    take_sqrt: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = X.shape[0]
    block = _block_rows(n)
    cols = torch.arange(n, device=X.device)
    idx = torch.empty((n, k + 1), dtype=torch.int32, device=X.device)
    dists = torch.empty((n, k + 1), dtype=torch.float32, device=X.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        cross = X[s:e] @ X.T
        if one_minus:
            dist = 1.0 - cross
        else:
            dist = torch.clamp((sq[s:e, None] + sq[None, :]) - 2.0 * cross, min=0.0)
        keys = _order_keys(dist, cols)
        rows = torch.arange(e - s, device=X.device)
        keys[rows, s + rows] = torch.iinfo(torch.int64).min  # self first
        pos = torch.topk(keys, k + 1, dim=1, largest=False, sorted=True).indices
        idx[s:e] = pos.int()
        dists[s:e] = dist.gather(1, pos)
    dists[:, 0] = 0.0
    if take_sqrt:
        dists[:, 1:] = torch.sqrt(torch.clamp(dists[:, 1:], min=0.0))
    return idx, dists


def _check_ring_args(Q, sq_q, B, sq_b, carried_d, carried_i) -> None:
    dev = Q.device
    nq, d = Q.shape
    nb = B.shape[0]
    k1 = carried_d.shape[1] if carried_d.dim() == 2 else -1
    for name, t, dt, shape in (
        ("Q", Q, torch.float32, (nq, d)), ("sq_q", sq_q, torch.float32, (nq,)),
        ("B", B, torch.float32, (nb, d)), ("sq_b", sq_b, torch.float32, (nb,)),
        ("carried_d", carried_d, torch.float32, (nq, k1)),
        ("carried_i", carried_i, torch.int32, (nq, k1)),
    ):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if k1 < 1 or d < 1 or max(nq * k1, nb + k1, d) > _INT32_MAX:
        raise ValueError(f"Q {(nq, d)}, B {(nb, d)} with lists of {k1} are outside "
                         "what T40 takes")


def ring_parts(nq: int, rows: int, k1: int, sms: int) -> int:
    """T40's parts for ``nq`` queries against ``rows`` rows that are points,
    lists of ``k1`` places, on a card of ``sms`` SMs: for lists of at most
    32 places, the fewest parts, a power of two up to ``RING_MAX_PARTS``
    with at least 1024 rows each, whose blocks (⌈nq / 256⌉ a part) take
    every block slot of the card (two an SM); one part for longer lists,
    where each part's own heap (filled, then sorted for the merge) costs
    more than the idle SMs (PERF.md §6). A [mesh4] round's 25,000
    queries make 98 blocks: 4 parts; [mesh1]'s 100,000 make 391: one."""
    if k1 > _RING_SHORT_LIST:
        return 1
    blocks = -(-nq // _RING_QUERIES)
    slots = _RING_BLOCKS_PER_SM * max(1, sms)
    p = 1
    while p < RING_MAX_PARTS and blocks * p < slots and rows >= 2 * p * _RING_MIN_PART_ROWS:
        p *= 2
    return p


def knn_ring_merge(
    Q: torch.Tensor, sq_q: torch.Tensor, B: torch.Tensor, sq_b: torch.Tensor,
    off: int, n: int, carried_d: torch.Tensor, carried_i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T40: one round of the sharded exact kNN. ``Q (nq, d)`` float32 are
    this rank's queries with ``sq_q`` their squared norms; ``B (nb, d)`` the
    database block of this round with ``sq_b``, its row j the point
    ``off + j`` (rows with ``off + j >= n`` are padding and never enter);
    ``carried_d``/``carried_i (nq, k+1)`` the ascending lists so far (+inf
    and −1 before the first round). Returns the merged lists: squared
    distances ``(‖q‖² − 2⟨q, b⟩) + ‖b‖²`` in float32, unclamped, and int32
    ids, ascending by (distance, carried before new, then block row). On
    the card B's rows are cut into ``ring_parts`` ranges, each selected
    apart and the lists merged: the same lists for any count."""
    if Q.device.type == "cpu":
        return knn_ring_merge_plain(Q, sq_q, B, sq_b, off, n, carried_d, carried_i)
    if Q.device.type != "cuda":
        raise ValueError(f"unsupported device {Q.device}")
    _check_ring_args(Q, sq_q, B, sq_b, carried_d, carried_i)
    nq, d = Q.shape
    k1 = carried_d.shape[1]
    if not 0 <= off <= _INT32_MAX - B.shape[0] or n > _INT32_MAX:
        raise ValueError(f"off={off}, n={n} are outside what T40 takes")
    parts = ring_parts(nq, max(0, min(B.shape[0], n - off)), k1,
                       torch.cuda.get_device_properties(Q.device).multi_processor_count)
    od = torch.empty_like(carried_d)
    oi = torch.empty_like(carried_i)
    heaps = torch.empty(parts * nq * heap_row(k1), dtype=torch.int64, device=Q.device)
    _kernels.launch(
        "knn_ring_merge", Q.device,
        Q.data_ptr(), sq_q.data_ptr(), nq, d, B.data_ptr(), sq_b.data_ptr(), B.shape[0],
        int(off), int(n), k1, int(parts), carried_d.data_ptr(), carried_i.data_ptr(),
        od.data_ptr(), oi.data_ptr(), heaps.data_ptr(),
    )
    return od, oi


def knn_ring_merge_plain(
    Q: torch.Tensor, sq_q: torch.Tensor, B: torch.Tensor, sq_b: torch.Tensor,
    off: int, n: int, carried_d: torch.Tensor, carried_i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    nq, k1 = carried_d.shape
    nb = B.shape[0]
    ids = off + torch.arange(nb, dtype=torch.int32, device=Q.device)
    masked = ids >= n
    od = torch.empty_like(carried_d)
    oi = torch.empty_like(carried_i)
    block = _block_rows(nb + k1)
    for s in range(0, nq, block):
        e = min(s + block, nq)
        d2 = (sq_q[s:e, None] - 2.0 * (Q[s:e] @ B.T)) + sq_b[None, :]
        d2 = torch.where(masked[None, :], torch.inf, d2)
        all_d = torch.cat([carried_d[s:e], d2], dim=1)
        all_i = torch.cat([carried_i[s:e], ids.expand(e - s, nb)], dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :k1]
        od[s:e] = all_d.gather(1, order)
        oi[s:e] = all_i.gather(1, order)
    return od, oi


def knn(
    X,
    k: int,
    metric: str = "euclidean",
    include_self: bool = True,
    approx: bool = False,
    method: str = "auto",
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """kNN. Returns (indices (n, k+1) int32, dists (n, k+1) float32) as
    tensors on the device, with self in column 0 (the pynndescent convention
    the reference keeps); without ``include_self``, columns 1..k. ``k`` is
    cut to n − 1.

    ``approx``: bfloat16 operands, float32 cross term, selected exactly.
    ``method``: ``"auto"`` | ``"brute"`` | ``"ivf"``. ``"ivf"``, and
    ``"auto"`` with ``approx`` above ``IVF_THRESHOLD`` rows, take the IVF
    index (ops/ivf.ivf_knn), whose pruning leaves the n² pairs unscored."""
    X = dense_to_tensor(X, device)
    n = X.shape[0]
    k = min(k, n - 1)
    if method == "ivf" or (method == "auto" and approx and n > IVF_THRESHOLD):
        from .ivf import ivf_knn

        idx, dists = ivf_knn(X, k, metric=metric, device=X.device)
        if include_self:
            return idx, dists
        return idx[:, 1:], dists[:, 1:]
    m = _metric(metric)
    with stage("knn/topk"):
        op, sq = _operand(X, m, approx)
        idx, dists = knn_topk(op, sq, k, one_minus=m in ("cosine", "correlation"),
                              take_sqrt=m == "euclidean", approx=approx)
    if include_self:
        return idx, dists
    return idx[:, 1:], dists[:, 1:]


def pairwise_sq_dists(Q, C, device: DeviceLike = None) -> torch.Tensor:
    """Squared euclidean distances (Q rows × C rows), float32."""
    Q, C = dense_to_tensor(Q, device), dense_to_tensor(C, device)
    qsq, csq = (Q * Q).sum(dim=1), (C * C).sum(dim=1)
    return torch.clamp(qsq[:, None] + csq[None, :] - 2.0 * Q @ C.T, min=0.0)
