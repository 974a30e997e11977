"""Exact brute-force k-nearest neighbours on a CUDA device
(counterpart of muon_tpu/ops/knn.py).

    knn_topk   T5  <- _knn_fn + _topk2 (csrc/knn_kernels.cu)

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

__all__ = ["knn", "knn_topk", "knn_topk_plain", "pairwise_sq_dists",
           "IVF_THRESHOLD", "LOCAL_LIST"]

# above this row count the reference's approximate path takes the IVF index
IVF_THRESHOLD = 200_000
# T5 and T14 keep a query's list (k + 1 places, self included) in a
# per-thread array up to this length, and in the query's row of the outputs
# beyond it (counted apart: knn_topk_global, ivf_search_global)
LOCAL_LIST = 256
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


def knn_topk(
    X: torch.Tensor, sq: Optional[torch.Tensor], k: int, one_minus: bool,
    take_sqrt: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T5: self-kNN over the rows of ``X`` ``(n, d)`` float32. Returns idx
    ``(n, k+1)`` int32 and dists ``(n, k+1)`` float32: self in column 0 at
    distance 0, then the k others with the smallest distance, ties to the
    lower index. The distance is ``max(sq_i + sq_j − 2·cross, 0)``, or
    ``1 − cross`` when ``one_minus``, with the cross term summed in
    float32; ``take_sqrt`` returns the square roots of columns 1..k. Any
    k up to n − 1."""
    if X.device.type == "cpu" and (sq is None or sq.device.type == "cpu"):
        return knn_topk_plain(X, sq, k, one_minus, take_sqrt)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    if X.dtype != torch.float32 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError(f"X must be a contiguous 2-D float32 tensor, got "
                         f"{X.dtype} {tuple(X.shape)}")
    n, d = X.shape
    if not (1 <= d and n <= _INT32_MAX and d <= _INT32_MAX):
        raise ValueError(f"X of shape {(n, d)} is outside what T5 takes")
    if not 0 <= k <= n - 1:
        raise ValueError(f"k={k} must lie in [0, n-1={n - 1}]")
    if not one_minus:
        if sq is None or sq.device != X.device or sq.dtype != torch.float32 \
                or tuple(sq.shape) != (n,) or not sq.is_contiguous():
            raise ValueError("sq must be a contiguous (n,) float32 tensor on X's device")
    idx = torch.empty((n, k + 1), dtype=torch.int32, device=X.device)
    dists = torch.empty((n, k + 1), dtype=torch.float32, device=X.device)
    _kernels.launch(
        "knn_topk" if k + 1 <= LOCAL_LIST else "knn_topk_global", X.device,
        X.data_ptr(), 0 if one_minus else sq.data_ptr(), n, d, k, int(one_minus),
        int(take_sqrt), idx.data_ptr(), dists.data_ptr(),
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
                              take_sqrt=m == "euclidean")
    if include_self:
        return idx, dists
    return idx[:, 1:], dists[:, 1:]


def pairwise_sq_dists(Q, C, device: DeviceLike = None) -> torch.Tensor:
    """Squared euclidean distances (Q rows × C rows), float32."""
    Q, C = dense_to_tensor(Q, device), dense_to_tensor(C, device)
    qsq, csq = (Q * Q).sum(dim=1), (C * C).sum(dim=1)
    return torch.clamp(qsq[:, None] + csq[None, :] - 2.0 * Q @ C.T, min=0.0)
