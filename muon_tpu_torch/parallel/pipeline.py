"""Cells-axis sharding of the data pipeline over ``torch.distributed``:
TF-IDF → LSI → kNN (ring, or IVF) → UMAP, and WNN's three kernels
(counterpart of muon_tpu/parallel/pipeline.py).

The reference runs each stage as one ``shard_map`` program over the mesh's
``"cells"`` axis, every device holding a contiguous row block, and every
reduction that crosses rows a ``psum``. Here each rank runs its block's
part on its own device, with the kernels of the single-device path, and the
reductions are the collectives of ``parallel/comm.py``:

    sharded_col_sums    <- _colsums_fn      T1's sums-only mode, all_reduce
    sharded_tfidf_data  <- _tfidf_fn        T1's values mode from the summed
                                            columns and the global n
    sharded_rsvd        <- _rsvd_fn         T2 (X·B), T3 (Xᵀ·Y) + all_reduce,
                                            CholeskyQR² with all-reduced
                                            Grams, the small SVD in torch
    sharded_knn         <- _knn_ring_fn     T40 each round, ring_shift
    sharded_ivf_knn     <- _ivf_kmeans_fn   T15 + all-reduced Lloyd sums
                           _ivf_search_fn   T14 on the rank's work items
    sharded_umap_embed  <- _umap_epochs_fn  T41 each epoch, all_gather_rows
    sharded_wnn_bandwidth <- _wnn_bandwidth_fn  T9 on the rank's row window
    sharded_wnn_theta   <- _wnn_theta_fn    T10 on the rank's work items
    sharded_wnn_scores  <- _wnn_score_fn    T11 on the rank's row window,
                                            then the final top-k

The calling convention: every rank calls the same function with the same
host inputs, computes on its row block (P = the mesh's cells size, R =
ceil(n / P) rows, cells coordinate c the rows [c·R, min((c+1)·R, n))), and
returns the same full result as the reference does, on every rank. The
collectives run over the cells group; on a mesh with a feat axis the ranks
of one cells coordinate repeat one another's work, as the reference's
``shard_map`` over "cells" does on a (c, f) mesh. At P = 1 these functions
run as the reference's programs run on one device: the collectives have
nothing to exchange.

Dropped because they served only the TPU's fixed shapes, and change no
result: the padding of each block's entries to a common ``pad_multiple``
(taken and ignored, for API parity), the query rows padded with +inf, the
padded vertex and edge axes of UMAP and its 25-epoch chunks against the
TPU's watchdog, the WNN functions' rows padded to a multiple of their
``block`` (taken and ignored) and their scan over blocks.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from scipy import sparse as sp

from ..ops import ivf as _ivf
from ..ops import sparse as dsp
from ..ops.knn import knn_ring_merge
from ..ops.linalg import KERNEL_OPS, Products, _cholqr, _omega
from ..ops.umap import (edge_schedule, epoch_alpha, find_ab_params, spectral_init,
                        umap_edges, umap_epoch_block)
from ..ops import wnn as _wnn
from ..utils.profiling import stage
from .comm import all_gather_rows, all_reduce_sum, ring_shift

__all__ = [
    "ShardedCSR",
    "SHARDED_TAG",
    "shard_rows",
    "sharded_col_sums",
    "sharded_tfidf_data",
    "sharded_values_to_scipy",
    "sharded_rsvd",
    "sharded_lsi",
    "sharded_knn",
    "sharded_kmeans",
    "sharded_ivf_knn",
    "sharded_umap_embed",
    "sharded_wnn_bandwidth",
    "sharded_wnn_theta",
    "sharded_wnn_scores",
    "row_block",
]

# a sharded TF-IDF's result carries its ShardedCSR under this name, for lsi
SHARDED_TAG = "_muon_tpu_torch_sharded"


def _cells(mesh) -> int:
    return int(mesh.shape["cells"])


def row_block(n: int, mesh) -> Tuple[int, int, int]:
    """(R, lo, hi): the rows per cells coordinate and this rank's rows
    [lo, hi)."""
    return (-(-n // _cells(mesh)), *mesh.block(n, "cells"))


class ShardedCSR(NamedTuple):
    """A CSR matrix cut into row blocks, one a rank: ``local`` is this
    rank's block (rows [lo, hi) of the whole, on the rank's device, local
    row ids). The counterpart of the reference's ``ShardedCOO``."""

    local: dsp.DeviceCSR
    n_rows: int
    n_cols: int
    nnz: int
    rows_per_shard: int   # R
    n_shards: int         # P
    mesh: object

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)


def shard_rows(X, mesh, pad_multiple: int = 8192) -> ShardedCSR:
    """This rank's contiguous row block of the scipy matrix ``X`` (every
    rank passes the same X), as a float32 CSR on the mesh's device, the
    entries in X's order. ``pad_multiple`` is the reference's padding of
    each block's entries to a common length, a fixed-shape need of the TPU:
    it is taken for API parity and changes nothing here."""
    X = X.tocsr()
    n, d = X.shape
    R, lo, hi = row_block(n, mesh)
    s, e = int(X.indptr[lo]), int(X.indptr[hi])
    dsp._check_size(n, d, int(X.indptr[-1]))
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(mesh.device)  # noqa: E731
    with stage("mesh/shard_rows"):
        local = dsp.DeviceCSR(
            to(X.data[s:e], np.float32), to(X.indptr[lo:hi + 1] - s, np.int32),
            to(X.indices[s:e], np.int32), hi - lo, d, e - s,
        )
    return ShardedCSR(local, n, d, int(X.indptr[-1]), R, _cells(mesh), mesh)


def sharded_col_sums(Xs: ShardedCSR) -> torch.Tensor:
    """The column sums of the whole matrix on every rank: T1's sums-only
    mode on the block, then one all_reduce (the IDF reduction of reference
    muon/_atac/preproc.py:106)."""
    with stage("mesh/col_sums"):
        return all_reduce_sum(dsp.tfidf_col_sums(Xs.local), Xs.mesh)


def sharded_tfidf_data(
    Xs: ShardedCSR,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    scale_factor: float = 1e4,
) -> ShardedCSR:
    """TF-IDF of the sharded matrix (semantics of reference
    muon/_atac/preproc.py:85-119): row sums local, the IDF from the
    all-reduced column sums and the global n, through T1's values mode."""
    cs = sharded_col_sums(Xs)
    with stage("mesh/tfidf"):
        vals = dsp.tfidf_data(Xs.local, log_tf=log_tf, log_idf=log_idf,
                              log_tfidf=log_tfidf, scale_factor=scale_factor,
                              col_sums=cs, n_total=Xs.n_rows)
    return Xs._replace(local=Xs.local._replace(data=vals))


def sharded_values_to_scipy(Xs: ShardedCSR, X_csr) -> sp.csr_matrix:
    """A copy of ``X_csr`` (the matrix ``Xs`` was cut from) with the sharded
    values, gathered from every rank, on every rank. The result carries
    ``Xs`` under ``SHARDED_TAG``, so ``atac.tl.lsi`` over the same mesh
    reuses the blocks on the devices."""
    X_csr = X_csr.tocsr()
    lengths = [int(X_csr.indptr[min((r + 1) * Xs.rows_per_shard, Xs.n_rows)]
                   - X_csr.indptr[min(r * Xs.rows_per_shard, Xs.n_rows)])
               for r in range(Xs.n_shards)]
    with stage("mesh/gather_values"):
        vals = all_gather_rows(Xs.local.data, Xs.mesh, lengths).cpu().numpy()
    out = X_csr.copy()
    out.data = vals
    setattr(out, SHARDED_TAG, Xs)
    return out


def sharded_rsvd(
    Xs: ShardedCSR,
    k: int,
    n_oversample: int = 10,
    n_iter: int = 7,
    seed: int = 0,
    omega=None,
    ops: Products = KERNEL_OPS,
):
    """Randomized SVD of the row-sharded matrix, the arithmetic of the
    reference's ``_rsvd_fn``: X·B local (T2, float32), Xᵀ·Y local (T3,
    float32) and all-reduced, CholeskyQR² of the tall factors with the Gram
    all-reduced (jitter 1e-7·trace/l + 1e-30, twice), of the (d, l) factor
    replicated, then the SVD of the (l, d) matrix QᵀX on every rank.
    ``omega`` is the (d, l) test matrix (l = min(k + n_oversample, n, d));
    None draws it as ``ops/linalg.draw_omega`` does, the same on every rank.
    ``ops``: the products (``ops.linalg.PLAIN_OPS`` for the plain versions).
    Returns (U (n, k) gathered on every rank, s (k,), Vt (k, d)) tensors on
    the rank's device."""
    mesh, X = Xs.mesh, Xs.local
    n, d = Xs.shape
    l = min(k + n_oversample, min(n, d))
    om = _omega(omega, d, l, seed, X.device)

    def mv(B):
        return ops.spmm(X, B.contiguous())

    Xt = dsp.transpose(X)  # the CSR of the rank's block transposed, for every Xᵀ·Y

    def rmv(Y):
        return all_reduce_sum(ops.spmm_t(X, Y.contiguous(), Xt), mesh)

    def cholqr_cells(Y):
        def once(Y):
            G = all_reduce_sum(Y.T @ Y, mesh)
            jitter = 1e-7 * (torch.trace(G) / l) + 1e-30
            L = torch.linalg.cholesky(G + jitter * torch.eye(l, dtype=G.dtype, device=G.device))
            return torch.linalg.solve_triangular(L.T, Y, upper=True, left=False)

        return once(once(Y))

    with stage("mesh/rsvd"):
        Q = cholqr_cells(mv(om))
        for _ in range(int(n_iter)):
            Z = _cholqr(rmv(Q))
            Q = cholqr_cells(mv(Z))
        Bt = rmv(Q).T  # (l, d), full float32 final pass
        Ub, s, Vt = torch.linalg.svd(Bt, full_matrices=False)
        U = (Q @ Ub)[:, :k]
        U = all_gather_rows(U, mesh, mesh.lengths(n, "cells"))
    return U, s[:k], Vt[:k]


def sharded_lsi(X, mesh, k: int = 50, n_iter: int = 7, seed: int = 0, omega=None):
    """tfidf → rsvd → LSI scores, sharded (reference
    muon/_atac/preproc.py:85 + tools.py:29). Returns (scores (n, k), s (k,),
    Vt (k, d)) on every rank."""
    Xs = sharded_tfidf_data(shard_rows(X, mesh))
    U, s, Vt = sharded_rsvd(Xs, k, n_iter=n_iter, seed=seed, omega=omega)
    return U * s[None, :], s, Vt


def sharded_knn(Z, mesh, k: int = 20, chunk: int = 1024):
    """Exact kNN, queries and database sharded by rows (reference
    ``sharded_knn``, the ring of ``_knn_ring_fn``). Each rank keeps its
    query rows and one database block of R rows (its own first, padded to R
    with zeros); P rounds: T40 merges the block's candidates into the
    carried lists, then the block moves to rank + 1 (no move after the last
    round). A device holds two blocks of the database, never all of it.
    ``chunk`` (the reference's query chunk of its distance tile) is taken
    for API parity and changes nothing.

    Returns (dists (n, k+1) float32, squared and unclamped, as the
    reference's; idx (n, k+1) int32), gathered on every rank, ascending:
    column 0 is a point's nearest, itself unless a duplicate ties it."""
    Z = np.asarray(Z, np.float32)
    n, dim = Z.shape
    P = _cells(mesh)
    R, lo, hi = row_block(n, mesh)
    dev = mesh.device
    with stage("mesh/knn"):
        Q = torch.from_numpy(np.ascontiguousarray(Z[lo:hi])).to(dev)
        sq_q = (Q * Q).sum(dim=1)
        blk = torch.zeros((R, dim), dtype=torch.float32, device=dev)
        blk[: hi - lo] = Q
        k1 = int(k) + 1
        best_d = torch.full((hi - lo, k1), float("inf"), dtype=torch.float32, device=dev)
        best_i = torch.full((hi - lo, k1), -1, dtype=torch.int32, device=dev)
        for r in range(P):
            off = ((mesh.cells_rank - r) % P) * R  # the block's origin rank's first row
            best_d, best_i = knn_ring_merge(Q, sq_q, blk, (blk * blk).sum(dim=1), off, n,
                                            best_d, best_i)
            if r < P - 1:
                blk = ring_shift(blk, mesh)
        lengths = mesh.lengths(n, "cells")
        D = all_gather_rows(best_d, mesh, lengths)
        I = all_gather_rows(best_i, mesh, lengths)
    return D, I


def sharded_kmeans(X_local: torch.Tensor, cent0: torch.Tensor, iters: int, mesh):
    """``iters`` data-parallel Lloyd steps (the reference's
    ``_ivf_kmeans_fn``): T15 assigns the rank's rows, each cluster's rows
    are summed in float64 in row order (no float atomics) with their
    count, the sums and counts are all-reduced, and every rank divides
    (an empty cluster keeps its centroid). Returns (centroids (C, d), the
    rank's last assignment (rows,) int32)."""
    C = cent0.shape[0]
    cent = cent0.contiguous()
    for _ in range(int(iters)):
        a = _ivf.kmeans_assign(X_local, cent)
        order = torch.sort(a, stable=True).indices
        cnts = torch.bincount(a, minlength=C)
        sums = torch.segment_reduce(X_local[order].double(), "sum", lengths=cnts,
                                    unsafe=True)
        sums = all_reduce_sum(sums, mesh)
        cnts = all_reduce_sum(cnts.double(), mesh)
        new = sums.float() / cnts.clamp(min=1).float()[:, None]
        cent = torch.where(cnts[:, None] > 0, new, cent).contiguous()
    return cent, _ivf.kmeans_assign(X_local, cent)


def sharded_ivf_knn(
    Z,
    mesh,
    k: int = 20,
    metric: str = "euclidean",
    n_clusters=None,
    n_probe: int = 8,
    kmeans_iters: int = 8,
    block_queries: int = 1024,
    seed: int = 0,
):
    """IVF approximate kNN, sharded (reference ``sharded_ivf_knn``):
    k-means over the rows sharded by rank (``sharded_kmeans``, from the
    rows ``np.random.default_rng(seed)`` picks, as the reference), the
    host layout of ``ops/ivf.build_ivf_layout`` on every rank, then each
    rank searches its contiguous share of the work items (T14, μ the mean of
    the item's queries) against the whole cluster-sorted table, and the
    items' results are gathered and scattered back to row order. A place
    whose distance is +inf gets index −1, as in the reference.

    Returns (idx (n, k+1) int32, dists (n, k+1) float32) on every rank,
    self in column 0 — the ``ops.knn.knn`` convention."""
    Z = np.asarray(Z, np.float32)
    n, d = Z.shape
    k = min(k, n - 1)
    if metric in ("cosine", "correlation"):
        Zc = Z - Z.mean(axis=1, keepdims=True) if metric == "correlation" else Z
        norms = np.linalg.norm(Zc, axis=1, keepdims=True)
        Z = Zc / np.where(norms == 0, 1.0, norms)
        metric = "cosine"
    elif metric in ("euclidean", "l2", "sqeuclidean"):
        metric = "euclidean" if metric != "sqeuclidean" else "sqeuclidean"
    else:
        raise NotImplementedError(f"metric {metric!r} not supported by IVF")
    dev = mesh.device
    C = n_clusters or int(2 ** round(np.log2(max(np.sqrt(n), 16))))
    C = min(C, max(16, n // 64))
    C = max(1, min(C, n))
    lo, hi = mesh.block(n, "cells")
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    with stage("mesh/ivf_kmeans"):
        init_idx = np.random.default_rng(seed).choice(n, size=C, replace=False)
        cent, a_local = sharded_kmeans(to(Z[lo:hi]), to(Z[init_idx]), kmeans_iters, mesh)
        a_np = all_gather_rows(a_local, mesh, mesh.lengths(n, "cells")).cpu().numpy()
    with stage("mesh/ivf_layout(host)"):
        order, qids, probe_pos, probe_cnt, L = _ivf.build_ivf_layout(
            a_np, cent.cpu().numpy(), C, n_probe, block_queries)
    I = qids.shape[0]
    i0, i1 = mesh.block(I, "cells")
    with stage("mesh/ivf_search"):
        order_t = to(order)
        Xs = to(Z[order])
        q_l = to(qids[i0:i1])
        pos, dvals = _ivf.ivf_search(Xs, q_l, to(probe_pos[i0:i1]), to(probe_cnt[i0:i1]),
                                     _ivf.item_means(Xs, q_l), int(k), int(L),
                                     metric == "cosine")
        QB, k1 = qids.shape[1], int(k) + 1
        items = mesh.lengths(I, "cells")
        pos = all_gather_rows(pos.reshape(i1 - i0, QB * k1), mesh, items)
        dvals = all_gather_rows(dvals.reshape(i1 - i0, QB * k1), mesh, items)
    with stage("mesh/ivf_scatter_back"):
        return _ivf._scatter_back(pos, dvals, order_t, to(qids).reshape(-1), int(n), k1,
                                  metric == "euclidean")


def _negative_seed(random_state: int, rank: int, epoch: int) -> int:
    """The seed of a rank's negatives in one epoch, mixed from the three."""
    return int(np.random.SeedSequence([int(random_state), int(rank), int(epoch)])
               .generate_state(1, np.uint64)[0] >> 1)


def sharded_umap_embed(
    graph,
    mesh,
    n_components: int = 2,
    n_epochs: int = 200,
    min_dist: float = 0.5,
    spread: float = 1.0,
    alpha: float = 1.0,
    gamma: float = 1.0,
    negative_sample_rate: int = 5,
    random_state: int = 42,
    a=None,
    b=None,
    init=None,
    draw_negatives=None,
    n_run=None,
):
    """UMAP SGD, sharded (reference ``sharded_umap_embed``): the edges are
    grouped by head block, so rank r holds the edges whose head lies in its
    vertex window [r·Vb, (r+1)·Vb) (Vb = ceil(n / P)) and its attraction is
    local (the symmetric fold: an edge's tail update is its mirror's head
    update, which the mirror's own rank sums). Each epoch is one T41 launch
    on the window (attraction summed first and applied after, negatives from
    [0, n) with a self hit zeroed, the window's expected due rate) and one
    ``all_gather_rows`` of the windows into the next layout.

    The start is ``spectral_init`` of the graph (the exact seed, as the
    reference's), or ``init (n, n_components)``. Negatives are drawn for
    each cells coordinate and epoch from a ``torch.Generator`` seeded from
    (random_state, coordinate, epoch), or taken from ``draw_negatives(epoch) →
    (rows of the window, negative_sample_rate)``. So the layout is the same
    bit for bit for a fixed world size and seed; the draws are not the
    reference's, whose quality, not its bits, is the cross-check, as the
    reference states of its own. ``n_run`` runs only the first epochs of
    the ``n_epochs`` schedule (the reference's ``n_run``). Returns the (n,
    n_components) float32 layout on the host, on every rank."""
    n = graph.shape[0]
    graph = sp.coo_matrix(graph)
    if a is None or b is None:
        a, b = find_ab_params(spread, min_dist)
    dev = mesh.device
    v0, v1 = mesh.block(n, "cells")
    with stage("mesh/umap_schedule(host)"):
        heads, tails, eps, _w, dc_exp = edge_schedule(graph, n_epochs)
        s, e = np.searchsorted(heads, [v0, v1])
    if init is None:
        with stage("mesh/umap_spectral_init"):
            emb0 = spectral_init(sp.csr_matrix(graph), n_components, seed=random_state,
                                 device=dev)
    else:
        emb0 = np.asarray(init, dtype=np.float32)
        if emb0.shape != (n, n_components):
            raise ValueError(f"init must have shape {(n, n_components)}, got {emb0.shape}")
    with stage("mesh/umap_upload"):
        edges = umap_edges(heads[s:e], tails[s:e], eps[s:e], np.zeros(e - s, np.int8),
                           v1 - v0, dev, v0=v0)
        eons = edges.eps.clone()
        dc = torch.from_numpy(dc_exp[v0:v1]).to(dev)
        emb = torch.from_numpy(np.ascontiguousarray(emb0)).to(dev)
        blk = torch.empty((v1 - v0, n_components), dtype=torch.float32, device=dev)
    lengths = mesh.lengths(n, "cells")
    rate = int(negative_sample_rate)
    with stage(f"mesh/umap_sgd_{int(n_epochs)}epochs"):
        for epoch in range(int(n_epochs if n_run is None else min(n_run, n_epochs))):
            if draw_negatives is None:
                gen = torch.Generator(device=dev).manual_seed(
                    _negative_seed(random_state, mesh.cells_rank, epoch))
                negs = torch.randint(0, n, (v1 - v0, rate), generator=gen,
                                     dtype=torch.int32, device=dev)
            else:
                negs = torch.as_tensor(np.asarray(draw_negatives(epoch), np.int32)).to(dev)
            umap_epoch_block(emb, blk, edges, eons, dc, negs.contiguous(), v0, epoch,
                             epoch_alpha(alpha, epoch, n_epochs), a, b, gamma)
            emb = all_gather_rows(blk, mesh, lengths)
    return emb.cpu().numpy()


# ---------------------------------------------------------------------------
# WNN: each rank its rows over the whole, replicated tables
# ---------------------------------------------------------------------------


def _tensor(a, dtype, device) -> torch.Tensor:
    """``a`` (a tensor, or a host array; an ml_dtypes bfloat16 array by its
    bits) as a contiguous ``dtype`` tensor on ``device``."""
    if not torch.is_tensor(a):
        a = np.ascontiguousarray(a)
        if dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
            a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype).contiguous()


def sharded_wnn_bandwidth(NI, rep, mesh, n_bw: int = 20, block: int = 512,
                          nn_stride: int = 1) -> torch.Tensor:
    """WNN's kernel bandwidth σ with the query rows sharded over cells
    (reference ``sharded_wnn_bandwidth``): the neighbour matrix ``NI (n,
    kk)`` int32 (pad −1) and the representation ``rep (n, d)`` float32 are
    replicated, since a 2-hop candidate may be any row; each rank runs T9
    on its row window of the whole tables, and the windows are gathered.
    ``block`` (the reference's rows per scan step) is taken for API parity
    and changes nothing.

    Returns σ (n,) float32 on the mesh's device, on every rank: the
    single-device ``ops.wnn.wnn_bandwidth`` bit for bit."""
    dev = mesh.device
    NI_t = _tensor(NI, torch.int32, dev)
    rep_t = _tensor(rep, torch.float32, dev)
    n = NI_t.shape[0]
    rep_h = np.asarray(rep if not torch.is_tensor(rep) else rep_t.cpu().numpy(), np.float32)
    bbox = float(np.linalg.norm(np.ptp(rep_h, axis=0), ord=2))
    lo, hi = mesh.block(n, "cells")
    with stage("mesh/wnn_bandwidth"):
        sig = _wnn.wnn_bandwidth(NI_t, *_wnn._bandwidth_tables(NI_t, rep_t), float(n), bbox,
                                 int(n_bw), int(nn_stride), row0=lo, rows=hi - lo)
        return all_gather_rows(sig, mesh, mesh.lengths(n, "cells"))


def sharded_wnn_theta(rep_full, rows1, rows2, NI2_full, conv, nnd_full, sigma_full, mesh,
                      block: int = 8192) -> torch.Tensor:
    """WNN's affinity θ with the (rows1, rows2) work items sharded over
    cells (reference ``sharded_wnn_theta``): the mod1 ``rep_full``, the mod2
    neighbour matrix ``NI2_full``, the remap ``conv`` and the mod1
    ``nnd_full`` and ``sigma_full`` are replicated (a neighbour mean
    gathers arbitrary rows); each rank runs T10 on its items, and the items
    are gathered. ``block`` is taken and ignored.

    Returns θ (m,) float32 on the mesh's device, m = len(rows1), on every
    rank."""
    dev = mesh.device
    r1 = _tensor(rows1, torch.int32, dev)
    r2 = _tensor(rows2, torch.int32, dev)
    m = r1.shape[0]
    lo, hi = mesh.block(m, "cells")
    with stage("mesh/wnn_theta"):
        th = _wnn.wnn_theta(_tensor(rep_full, torch.float32, dev), r1[lo:hi].contiguous(),
                            r2[lo:hi].contiguous(), _tensor(NI2_full, torch.int32, dev),
                            _tensor(conv, torch.int32, dev),
                            _tensor(nnd_full, torch.float32, dev),
                            _tensor(sigma_full, torch.float32, dev))
        return all_gather_rows(th, mesh, mesh.lengths(m, "cells"))


def sharded_wnn_scores(cand, cat16, aux, sigw, dims, mesh, metric: str = "euclidean",
                       k: int = 20, block: int = 512):
    """WNN's fused candidate scores and the per-row top-k with the
    candidate rows sharded over cells (reference ``sharded_wnn_scores``):
    the bfloat16 table ``cat16 (n, ΣD)`` and ``aux``/``sigw (n, 2M)`` are
    replicated; each rank runs T11 on its row window and the final top-k
    (``ops.wnn.final_topk``) on its rows, and the rows are gathered.
    ``cand (n, C)`` int32 holds global candidate ids (pad −1). ``block`` is
    taken and ignored.

    Returns (idx (n, k) int32, dist (n, k) float32) on the mesh's device, on
    every rank: the single-device T11 and ``final_topk`` row for row."""
    dev = mesh.device
    cand_t = _tensor(cand, torch.int32, dev)
    n = cand_t.shape[0]
    lo, hi = mesh.block(n, "cells")
    with stage("mesh/wnn_scores"):
        c_loc = cand_t[lo:hi].contiguous()
        # a table already on the device keeps its padded rows (ops.wnn.padded_table)
        on_dev = torch.is_tensor(cat16) and cat16.device == dev and cat16.dtype == torch.bfloat16
        table = cat16 if on_dev else _tensor(cat16, torch.bfloat16, dev)
        scores = _wnn.wnn_fusion_scores(c_loc, table, _tensor(aux, torch.float32, dev),
                                        _tensor(sigw, torch.float32, dev), tuple(dims),
                                        str(metric), row0=lo)
        idx, dist = _wnn.final_topk(scores, c_loc, int(k))
        lengths = mesh.lengths(n, "cells")
        return all_gather_rows(idx, mesh, lengths), all_gather_rows(dist, mesh, lengths)
