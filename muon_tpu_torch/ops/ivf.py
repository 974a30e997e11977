"""IVF (inverted-file) approximate kNN on a CUDA device (counterpart of
muon_tpu/ops/ivf.py).

    ivf_search     T14  <- _search_fn            (csrc/ivf_kernels.cu)
    kmeans_assign  T15  <- _kmeans_fn's assign   (csrc/ivf_kernels.cu): the
                           tensor cores screen, the float32 chain decides

Brute force scores every pair of rows; above ``ops/knn.IVF_THRESHOLD`` rows
the approximate path prunes instead: k-means partitions the points, the
points are sorted by cluster, and every query scores only the points of the
``n_probe`` clusters nearest to its own. The pieces, as in the reference:

* k-means: Lloyd steps from the rows ``np.random.default_rng(seed)`` picks
  (the same start in both packages). The assignment is T15; the centroid
  update sorts the rows by cluster and reduces each segment in order, so a
  partition is the same in every run.
* layout (host numpy, ``build_ivf_layout``): clusters wider than the pad
  width L are split into chunks of at most L, never cut; the probe lists
  come from the C×C centroid distances; a work item is QB consecutive
  sorted queries of one chunk with that chunk's probe list.
* search: T14, float32 distances centred on the mean of the item's
  queries, exact selection (the reference takes the TPU's approximate top-k
  on wide items).
* scatter back: rows to their original order, on the device.

The partition (centroids, assignment) is cached by a value fingerprint of
the matrix, so the neighbour graph (k ≈ 20) and WNN's candidate pool
(k ≈ 200) over the same representation run k-means once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor
from .knn import LOCAL_LIST, _bf16_rows, _order_keys, heap_row

__all__ = ["ivf_knn", "build_ivf_layout", "centroid_norms", "kmeans", "kmeans_assign",
           "kmeans_assign_chain", "kmeans_assign_plain", "item_means", "ivf_search",
           "ivf_search_plain"]

# (centroids, assignment) as numpy, by `_partition_key`; the newest last
_PARTITION_CACHE: dict = {}
_PARTITION_CACHE_MAX = 4
_INT32_MAX = 2**31 - 1
# T15's screen: a centroid is rescored by the chain when its tensor-core score
# lies within SCREEN_MARGIN (‖x̃‖² + ‖c̃‖²) of the row's best bound, the
# proven bound of the two scores' difference for rows of up to 1024 padded
# values (csrc/ivf_kernels.cu), widened in proportion beyond
SCREEN_MARGIN = 2.0**-13


def _partition_key(X: torch.Tensor, C: int, iters: int, seed: int):
    """Value fingerprint of X for the partition cache, the reference's: two
    strided samples at coprime strides, whole-array min, max and sum (so any
    single edit changes the key), the shape and the dtype. The reductions run
    where X lies; the seven scalars come back in one copy."""
    n, d = X.shape
    flat = X.reshape(-1)
    sa = flat[:: max(1, (n * d) // 4096)]
    sb = flat[1 :: max(1, (n * d) // 2731)]
    stats = torch.stack([
        sa.sum(), sa.abs().sum(), sb.sum(), (sb.float() ** 2).sum(),
        flat.min().float(), flat.max().float(), flat.float().sum(),
    ])
    vals = tuple(round(float(v), 6) for v in stats.cpu().numpy())
    return (int(n), int(d), str(X.dtype), int(C), int(iters), int(seed)) + vals


# ---------------------------------------------------------------------------
# T15 and k-means
# ---------------------------------------------------------------------------


def _check_f32_matrix(name: str, t: torch.Tensor, device, cols=None) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D float32 tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if cols is not None and t.shape[1] != cols:
        raise ValueError(f"{name} must have {cols} columns, got {t.shape[1]}")


def kmeans_assign(X: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """T15: the nearest centroid of every row of ``X (n, d)`` among ``cent
    (C, d)``, both float32 → ``(n,)`` int32. The score is ‖c‖² − 2·x·c with
    the operands of the product rounded to bfloat16, their products summed
    in float32, and ‖c‖² the float32 norm of the unrounded centroid; ties go
    to the lower cluster. On the card the operands are rounded once here
    (rows padded to a multiple of 16), the tensor cores screen the
    centroids and the float32 fma chain over u in order decides: the
    assignments are ``kmeans_assign_chain``'s bits."""
    if X.device.type == "cpu" and cent.device.type == "cpu":
        return kmeans_assign_plain(X, cent)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    _check_f32_matrix("X", X, X.device)
    _check_f32_matrix("cent", cent, X.device, cols=X.shape[1])
    n, d = X.shape
    C = cent.shape[0]
    if not (1 <= d <= _INT32_MAX - 15 and 1 <= C and max(n, C) <= _INT32_MAX):
        raise ValueError(f"X {(n, d)} with {C} centroids is outside what T15 takes")
    csq = centroid_norms(cent)
    Xb, Cb = _bf16_rows(X), _bf16_rows(cent)
    ld = Xb.shape[1]
    ct = (Cb.float() ** 2).sum(dim=1).contiguous()
    assign = torch.empty(n, dtype=torch.int32, device=X.device)
    _kernels.launch(
        "kmeans_assign", X.device,
        Xb.data_ptr(), Cb.data_ptr(), csq.data_ptr(), ct.data_ptr(), n, ld, C,
        SCREEN_MARGIN * max(1.0, ld / 1024), assign.data_ptr(),
    )
    return assign


def centroid_norms(cent: torch.Tensor) -> torch.Tensor:
    """‖c‖² of every centroid, float32, as T15 takes them: torch's sum,
    whose order may differ between the CPU and the card."""
    return (cent * cent).sum(dim=1).contiguous()


def kmeans_assign_chain(X: torch.Tensor, cent: torch.Tensor,
                        csq: Optional[torch.Tensor] = None,
                        block: int = 8192) -> torch.Tensor:
    """T15's exact arithmetic in plain torch: the cross term as the float32
    chain acc = acc + x̃_u·c̃_u over u in order (each bfloat16 product exact
    in float32, then one rounded add), the score ‖c‖² − 2·acc, the first
    smallest score. The bits of the card's kernel given the same ‖c‖²
    (``csq``; ``centroid_norms(cent)`` here unless given), for the tests
    and the smoke; ``kmeans_assign_plain`` sums by a matmul in another
    order."""
    csq = centroid_norms(cent) if csq is None else csq
    c16 = cent.to(torch.bfloat16).float()
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for s in range(0, X.shape[0], block):
        x16 = X[s:s + block].to(torch.bfloat16).float()
        acc = torch.zeros((x16.shape[0], cent.shape[0]), dtype=torch.float32, device=X.device)
        for u in range(X.shape[1]):
            acc += x16[:, u:u + 1] * c16[:, u][None, :]
        out[s:s + block] = torch.argmin(csq[None, :] - 2.0 * acc, dim=1).int()
    return out


def kmeans_assign_plain(X: torch.Tensor, cent: torch.Tensor,
                        block: int = 8192) -> torch.Tensor:
    csq = (cent * cent).sum(dim=1)
    c16 = cent.to(torch.bfloat16).float()
    out = torch.empty(X.shape[0], dtype=torch.int32, device=X.device)
    for s in range(0, X.shape[0], block):
        cross = X[s:s + block].to(torch.bfloat16).float() @ c16.T
        out[s:s + block] = torch.argmin(csq[None, :] - 2.0 * cross, dim=1).int()
    return out


def _update_centroids(X: torch.Tensor, assign: torch.Tensor,
                      cent: torch.Tensor) -> torch.Tensor:
    """The mean of every cluster's rows; an empty cluster keeps its
    centroid. The rows are sorted by cluster (stable) and each segment is
    summed in order in float64: no float atomics, so the same partition
    comes out of every run."""
    C = cent.shape[0]
    order = torch.sort(assign, stable=True).indices
    cnts = torch.bincount(assign, minlength=C)
    sums = torch.segment_reduce(X[order].double(), "sum", lengths=cnts, unsafe=True)
    new = sums.float() / cnts.clamp(min=1).float()[:, None]
    return torch.where(cnts[:, None] > 0, new, cent)


def kmeans(X: torch.Tensor, init_idx, C: int, iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` Lloyd steps from the rows ``init_idx`` and a final
    assignment: ``(centroids (C, d) float32, assignment (n,) int32)``."""
    init = torch.as_tensor(np.asarray(init_idx), dtype=torch.long, device=X.device)
    if init.shape[0] != C:
        raise ValueError(f"{init.shape[0]} initial rows for {C} clusters")
    cent = X[init].contiguous()
    for _ in range(int(iters)):
        cent = _update_centroids(X, kmeans_assign(X, cent), cent).contiguous()
    return cent, kmeans_assign(X, cent)


# ---------------------------------------------------------------------------
# the host layout
# ---------------------------------------------------------------------------


def build_ivf_layout(a_np, cent_np, C, n_probe, block_queries):
    """Host-side IVF layout: sort points by cluster, split oversize clusters
    into chunks of at most L (never cut), build per-cluster probe lists from
    the C×C centroid distances, and emit fixed-shape work items (one per QB
    consecutive sorted queries of a chunk).

    Returns (order, qids (I, QB), probe_pos (I, P), probe_cnt (I, P), L).
    """
    order = np.argsort(a_np, kind="stable").astype(np.int32)
    sizes = np.bincount(a_np, minlength=C)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)

    # chunk width: the 0.9 quantile of the cluster sizes, rounded up to 128;
    # wider clusters take several chunks
    L = int(np.quantile(sizes[sizes > 0], 0.9)) if (sizes > 0).any() else 1
    L = max(128, -(-L // 128) * 128)
    chunk_start, chunk_len, chunk_cluster = [], [], []
    for c in range(C):
        s, e = int(offsets[c]), int(offsets[c + 1])
        while s < e:
            chunk_start.append(s)
            chunk_len.append(min(L, e - s))
            chunk_cluster.append(c)
            s += L
    chunk_start = np.asarray(chunk_start, np.int32)
    chunk_len = np.asarray(chunk_len, np.int32)
    chunk_cluster = np.asarray(chunk_cluster, np.int32)

    # probe lists: the n_probe nearest clusters of each cluster
    cn = cent_np
    c2 = (cn * cn).sum(1)
    dcc = c2[:, None] + c2[None, :] - 2.0 * cn @ cn.T
    P_eff = min(n_probe, C)
    probe_of = np.argsort(dcc, axis=1)[:, :P_eff]  # (C, P)

    # probed clusters as chunks, padded to a fixed width
    chunks_of = [[] for _ in range(C)]
    for ci, cc in enumerate(chunk_cluster):
        chunks_of[cc].append(ci)
    probe_chunks = []
    for c in range(C):
        lst = []
        for pc in probe_of[c]:
            lst.extend(chunks_of[pc])
        probe_chunks.append(lst)
    P_max = max((len(x) for x in probe_chunks), default=1)
    P_max = min(P_max, 4 * P_eff)  # bound extreme skew

    # work items: per chunk, blocks of QB consecutive (sorted) queries
    QB = int(block_queries)
    item_q, item_ppos, item_pcnt = [], [], []
    for ci in range(len(chunk_start)):
        c = int(chunk_cluster[ci])
        pcs = list(probe_chunks[c][:P_max])
        if ci not in pcs:
            # a probe list cut at P_max must never lose the query block's
            # own chunk: self in column 0 is a contract downstream
            pcs[-1] = ci
        ppos = np.full(P_max, -1, np.int32)
        pcnt = np.zeros(P_max, np.int32)
        ppos[: len(pcs)] = chunk_start[pcs]
        pcnt[: len(pcs)] = chunk_len[pcs]
        s, e = int(chunk_start[ci]), int(chunk_start[ci] + chunk_len[ci])
        for qs in range(s, e, QB):
            row = np.full(QB, -1, np.int32)
            row[: min(QB, e - qs)] = np.arange(qs, min(qs + QB, e))
            item_q.append(row)
            item_ppos.append(ppos)
            item_pcnt.append(pcnt)
    qids = np.stack(item_q)
    probe_pos = np.stack(item_ppos)
    probe_cnt = np.stack(item_pcnt)
    return order, qids, probe_pos, probe_cnt, L


# ---------------------------------------------------------------------------
# T14 and the scatter back
# ---------------------------------------------------------------------------


def item_means(Xs: torch.Tensor, qids: torch.Tensor, block: int = 64) -> torch.Tensor:
    """μ of every work item, ``(I, d)`` float32: the mean of its query rows.
    Centring changes only the rounding of the distances. The reference also
    averages its padded slots, which gather row 0 and so pull μ away from a
    short item's queries; the port leaves them out, which keeps ‖q − μ‖ at
    the scale of the neighbour distances."""
    out = torch.empty((qids.shape[0], Xs.shape[1]), dtype=torch.float32, device=Xs.device)
    for s in range(0, qids.shape[0], block):
        q = qids[s:s + block]
        ok = (q >= 0)[..., None]
        rows = torch.where(ok, Xs[q.clamp(min=0).long()], 0.0)
        out[s:s + block] = rows.sum(dim=1) / ok.sum(dim=1).clamp(min=1)
    return out


def _check_search_args(Xs, qids, probe_pos, probe_cnt, mu, k, L) -> None:
    _check_f32_matrix("Xs", Xs, Xs.device)
    n, d = Xs.shape
    _check_f32_matrix("mu", mu, Xs.device, cols=d)
    I = qids.shape[0]
    for name, t, rows in (("qids", qids, I), ("probe_pos", probe_pos, I),
                          ("probe_cnt", probe_cnt, I)):
        if t.device != Xs.device:
            raise ValueError(f"{name} is on {t.device}, Xs on {Xs.device}")
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
                or t.shape[0] != rows:
            raise ValueError(f"{name} must be a contiguous ({rows}, ·) int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if probe_pos.shape != probe_cnt.shape or mu.shape[0] != I:
        raise ValueError("probe_pos, probe_cnt and mu must have a row per work item")
    if k < 0:
        raise ValueError(f"k={k} must be >= 0")
    QB, P = qids.shape[1], probe_pos.shape[1]
    if max(n, d, I * QB * (k + 1), P * L) > _INT32_MAX:
        raise ValueError("the search's shapes exceed the int32 range")
    if I and P and (int(probe_cnt.max()) > L or int(qids.max()) >= n
                    or int((probe_pos + probe_cnt).max()) > n):
        raise ValueError("a probe chunk is longer than L or runs past the rows of Xs")


def ivf_search(Xs: torch.Tensor, qids: torch.Tensor, probe_pos: torch.Tensor,
               probe_cnt: torch.Tensor, mu: torch.Tensor, k: int, L: int,
               half: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """T14: every work item's queries against its probed chunks.

    ``Xs (n, d)`` float32 points sorted by cluster; ``qids (I, QB)`` int32
    query positions into Xs (pad −1); ``probe_pos``/``probe_cnt (I, P)``
    int32 chunk starts (pad −1) and lengths (≤ ``L``); ``mu (I, d)`` the
    centre the item's distances are formed around. Returns ``(pos, dvals)``,
    both ``(I, QB, k+1)``: positions into Xs and float32 squared distances
    ``max(‖q−μ‖² + ‖c−μ‖² − 2(q−μ)·(c−μ), 0)``, halved when ``half``,
    ascending, ties to the earlier place in the probe list. The query itself
    comes first at −inf. Free places (fewer than k+1 candidates) and padded
    query slots hold position 0 at +inf."""
    if Xs.device.type == "cpu":
        return ivf_search_plain(Xs, qids, probe_pos, probe_cnt, mu, k, L, half)
    if Xs.device.type != "cuda":
        raise ValueError(f"unsupported device {Xs.device}")
    _check_search_args(Xs, qids, probe_pos, probe_cnt, mu, k, L)
    n, d = Xs.shape
    (I, QB), P = qids.shape, probe_pos.shape[1]
    pos = torch.empty((I, QB, k + 1), dtype=torch.int32, device=Xs.device)
    dvals = torch.empty((I, QB, k + 1), dtype=torch.float32, device=Xs.device)
    heaps = torch.empty(I * QB * heap_row(k + 1), dtype=torch.int64, device=Xs.device)
    _kernels.launch(
        "ivf_search" if k + 1 <= LOCAL_LIST else "ivf_search_global", Xs.device,
        Xs.data_ptr(), qids.data_ptr(), probe_pos.data_ptr(), probe_cnt.data_ptr(),
        mu.data_ptr(), n, d, I, QB, P, int(L), k + 1, int(bool(half)),
        pos.data_ptr(), dvals.data_ptr(), heaps.data_ptr(),
    )
    return pos, dvals


def ivf_search_plain(Xs: torch.Tensor, qids: torch.Tensor, probe_pos: torch.Tensor,
                     probe_cnt: torch.Tensor, mu: torch.Tensor, k: int, L: int,
                     half: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    n = Xs.shape[0]
    (I, QB), P = qids.shape, probe_pos.shape[1]
    k1, dev = k + 1, Xs.device
    pos = torch.zeros((I, QB, k1), dtype=torch.int32, device=dev)
    dvals = torch.full((I, QB, k1), math.inf, dtype=torch.float32, device=dev)
    ar = torch.arange(L, device=dev)
    width = max(P * L, k1)
    slots = torch.arange(width, device=dev)
    for it in range(I):
        valid_q = torch.nonzero(qids[it] >= 0)[:, 0]  # the padded slots stay at +inf
        if valid_q.numel() == 0:
            continue
        qs = qids[it][valid_q].long()
        ppos, pcnt = probe_pos[it].long(), probe_cnt[it].long()
        grid = ppos.clamp(min=0)[:, None] + ar[None, :]
        cvalid = ((ppos[:, None] >= 0) & (ar[None, :] < pcnt[:, None])).reshape(-1)
        cpos = grid.reshape(-1).clamp(0, n - 1)
        qc, cc = Xs[qs] - mu[it], Xs[cpos] - mu[it]
        d2 = (qc * qc).sum(dim=1)[:, None] + (cc * cc).sum(dim=1)[None, :] \
            - 2.0 * (qc @ cc.T)
        dist = torch.clamp(d2, min=0.0)
        if half:
            dist = 0.5 * dist
        dist = torch.where(cpos[None, :] == qs[:, None], -math.inf, dist)
        dist = torch.where(cvalid[None, :], dist, math.inf)
        if width > P * L:  # fewer slots than places: free places at +inf
            pad = torch.full((len(qs), width - P * L), math.inf, device=dev)
            dist = torch.cat([dist, pad], dim=1)
            cpos = torch.cat([cpos, cpos.new_zeros(width - P * L)])
        sel = torch.topk(_order_keys(dist, slots), k1, dim=1, largest=False,
                         sorted=True).indices
        dv = dist.gather(1, sel)
        pos[it, valid_q] = torch.where(dv < math.inf, cpos[sel], 0).int()
        dvals[it, valid_q] = dv
    return pos, dvals


def _scatter_back(pos: torch.Tensor, dvals: torch.Tensor, order: torch.Tensor,
                  qflat: torch.Tensor, n: int, k1: int, sqrt_: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The work items' results back in the original row order, on the
    device: ``(idx (n, k1) int32, dists (n, k1) float32)``. A place that saw
    no candidate (+inf) gets index −1; column 0 (self) gets distance 0; the
    square roots only when ``sqrt_`` (euclidean)."""
    ok = qflat >= 0
    rows = order[qflat[ok].long()].long()
    dflat = dvals.reshape(-1, k1)[ok]
    src = order[pos.reshape(-1, k1)[ok].long()]
    src = torch.where(dflat == math.inf, -1, src).int()
    idx_full = torch.full((n, k1), -1, dtype=torch.int32, device=pos.device)
    d_full = torch.zeros((n, k1), dtype=torch.float32, device=pos.device)
    idx_full[rows] = src
    d_full[rows] = dflat
    d_full[:, 0] = 0.0
    if sqrt_:
        d_full[:, 1:] = torch.sqrt(torch.clamp(d_full[:, 1:], min=0.0))
    return idx_full, d_full


def _ivf_metric(X: torch.Tensor, metric: str):
    """The rows the search runs on and its metric: cosine and correlation
    search unit rows (centred first for correlation) by half the squared
    distance, which is 1 − cos."""
    if metric in ("cosine", "correlation"):
        Z = X - X.mean(dim=1, keepdim=True) if metric == "correlation" else X
        norms = torch.linalg.norm(Z, dim=1, keepdim=True)
        return (Z / torch.where(norms == 0, 1.0, norms)).contiguous(), "cosine"
    if metric in ("euclidean", "l2"):
        return X, "euclidean"
    if metric == "sqeuclidean":
        return X, "sqeuclidean"
    raise NotImplementedError(f"metric {metric!r} not supported by IVF")


def ivf_knn(
    X,
    k: int,
    metric: str = "euclidean",
    n_clusters: Optional[int] = None,
    n_probe: int = 8,
    kmeans_iters: int = 8,
    block_queries: int = 1024,
    seed: int = 0,
    use_partition_cache: bool = True,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN through an IVF index on the device. The return
    convention of ``ops.knn.knn``: (indices (n, k+1) int32, dists (n, k+1)
    float32) as tensors on the device, self in column 0 at distance 0. A row
    whose probed chunks hold fewer than k other points gets index −1 in the
    places left over."""
    X = dense_to_tensor(X, device)
    n, d = X.shape
    k = min(k, n - 1)
    X, metric = _ivf_metric(X, metric)

    C = n_clusters or int(2 ** round(np.log2(max(np.sqrt(n), 16))))
    C = min(C, max(16, n // 64))
    C = max(1, min(C, n))  # rng.choice(n, C, replace=False) needs C <= n
    with stage("ivf/kmeans"):
        pkey = _partition_key(X, C, kmeans_iters, seed)
        hit = _PARTITION_CACHE.pop(pkey, None) if use_partition_cache else None
        if hit is not None:
            cent_np, assign_np = hit
        else:
            rng = np.random.default_rng(seed)
            init_idx = rng.choice(n, size=C, replace=False).astype(np.int32)
            cent, assign = kmeans(X, init_idx, C, kmeans_iters)
            cent_np, assign_np = cent.cpu().numpy(), assign.cpu().numpy()
        _PARTITION_CACHE[pkey] = (cent_np, assign_np)  # inserted anew: the newest
        while len(_PARTITION_CACHE) > _PARTITION_CACHE_MAX:
            _PARTITION_CACHE.pop(next(iter(_PARTITION_CACHE)))

    with stage("ivf/layout(host)"):
        order, qids, probe_pos, probe_cnt, L = build_ivf_layout(
            assign_np, cent_np, C, n_probe, block_queries
        )

    with stage("ivf/search"):
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(X.device)  # noqa: E731
        order_t, qids_t = to(order), to(qids)
        Xs = X[order_t.long()].contiguous()
        pos, dvals = ivf_search(Xs, qids_t, to(probe_pos), to(probe_cnt),
                                item_means(Xs, qids_t), int(k), int(L),
                                metric == "cosine")
    with stage("ivf/scatter_back"):
        return _scatter_back(pos, dvals, order_t, qids_t.reshape(-1), int(n),
                             int(k + 1), metric == "euclidean")
