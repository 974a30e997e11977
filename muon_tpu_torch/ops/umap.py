"""UMAP embedding on the device (counterpart of muon_tpu/ops/umap.py).

    umap_epoch         T13  <- _optimize_layout_bucketed_fn + _segsum_sorted
    membership_matvec  T16  <- _spectral_membership_fn's matvec
    umap_epoch_asym    T22  <- _optimize_fn (move_other, asymmetric)
    umap_epoch_block   T41  <- parallel/pipeline.py _umap_epochs_fn: T13 on a
                               rank's vertex window, no stride buckets
                               (all four in csrc/umap_kernels.cu)

The fuzzy graph's edges live on the device as one head-sorted edge list
(a CSR over the vertices) with a per-edge stride; each epoch is one launch
of T13, which sums the attraction of the due edges per vertex, adds the
vertex-pooled negatives scaled by the vertex's expected due rate, folds the
symmetric tail update into the head update, and writes the new layout
beside the old one (the two buffers swap), as the reference's epoch sums
every update before applying any.

Kept from the reference because they are results: the pruning and
``epochs_per_sample`` of umap-learn, the vertex-pooled negatives, the
symmetric fold, and the stride schedule (``bucket_shifts``). Dropped
because they only served the TPU: the padding of the edge axis to a
power-of-two size class, the per-bucket padded edge lists, and the 25-epoch
chunks. The negatives of each epoch are drawn as an (n, neg_rate) int32
table by ``torch.randint`` from a ``torch.Generator`` seeded with
``random_state`` and handed to T13, so a test can hand it the reference's
draws instead.

An asymmetric graph (found by the reference's ``G − Gᵀ`` probe, or any graph
under ``assume_symmetric=False``) takes the reference's other program: no
stride buckets, the repulsion scaled by the vertex's actual count of due
edges, and an explicit tail pass over the edges sorted by tail, one launch
of T22 an epoch. T22 reads ``eons`` and writes the advanced values to a
second buffer, so its tail pass decides which edges are due from the same
values as its head pass. ``tl.umap`` asserts symmetry, as the reference's
does, and so runs T13.

The spectral seed has the reference's two paths. Below 8M edges, or
without a membership tag on the graph, the exact one: the port's symmetric
randomized SVD of Dm12·G·Dm12 (T2). From 8M edges on, with the tag that
``ops/fuzzy.compute_connectivities_umap`` hangs on its result: subspace
iteration on D^-1/2 (W + Wᵀ) D^-1/2 over the directed (n, k) membership
table, each application one launch of T16, with CholeskyQR² between and a
Rayleigh-Ritz step at the end. No union CSR is scaled on the host or
uploaded. The two operators differ by the −W∘Wᵀ term of the union.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy import sparse as sp

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, resolve_device
from .fuzzy import MEMBERSHIP_TAG

__all__ = ["umap_embed", "find_ab_params", "spectral_init", "edge_schedule",
           "bucket_shifts", "UmapEdges", "umap_edges", "umap_epoch",
           "umap_epoch_plain", "UmapTails", "umap_tails", "umap_epoch_asym",
           "umap_epoch_asym_plain", "umap_epoch_block", "umap_epoch_block_plain",
           "epoch_alpha", "MembershipOperator", "membership_operator",
           "membership_matvec", "membership_matvec_plain", "spectral_membership"]

# the reference buckets edges by stride only from this many edges on
BUCKET_MIN_EDGES = 2_000_000
MAX_NEG_RATE = 32  # one warp lane per negative
MAX_SEED_COLS = 16  # T16 gives a row 16 lanes, one per column
# from this many edges on, spectral_init seeds from the membership table
MEMBERSHIP_MIN_NNZ = 8_000_000


def find_ab_params(spread: float = 1.0, min_dist: float = 0.5):
    """Fit the differentiable curve 1/(1+a x^{2b}) (umap-learn parity)."""
    from scipy.optimize import curve_fit

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    xv = np.linspace(0, spread * 3, 300)
    yv = np.zeros(xv.shape)
    yv[xv < min_dist] = 1.0
    yv[xv >= min_dist] = np.exp(-(xv[xv >= min_dist] - min_dist) / spread)
    params, _ = curve_fit(curve, xv, yv)
    return float(params[0]), float(params[1])


def edge_schedule(graph, n_epochs: int):
    """Host-side edge preparation, as the reference's: prune the edges
    umap-learn would never sample, derive ``epochs_per_sample``, sort by
    head, and the expected per-epoch due rate per vertex (``dc_exp``, the
    repulsion scale). Returns (heads, tails, epochs_per_sample, weights,
    dc_exp)."""
    n = graph.shape[0]
    graph = sp.coo_matrix(graph)
    w = graph.data.astype(np.float64)
    w[w < w.max() / float(n_epochs)] = 0.0
    keep = w > 0
    heads = graph.row[keep].astype(np.int32)
    tails = graph.col[keep].astype(np.int32)
    w = w[keep]
    eps = (w.max() / w).astype(np.float32)
    if np.any(np.diff(heads) < 0):  # CSR→COO rows arrive pre-sorted
        order = np.argsort(heads, kind="stable")
        heads, tails, eps, w = heads[order], tails[order], eps[order], w[order]
    dc_exp = np.zeros(n, np.float32)
    np.add.at(dc_exp, heads, (1.0 / eps).astype(np.float32))
    return heads, tails, eps, w, dc_exp


def _padded_edge_count(E: int) -> int:
    """The length the reference pads its edge list to before it buckets: up
    to a multiple of 1/16 of the next power of two, at least 8192."""
    grain = max(8192, 1 << max(E.bit_length() - 4, 3))
    return -(-max(E, 1) // grain) * grain


def bucket_shifts(epochs_per_sample: np.ndarray, n_epochs: int) -> np.ndarray:
    """log2 of each edge's stride: the reference's bucket ⌊log2 eps⌋,
    clipped to [0, max_exp], where max_exp = clip(⌊log2(n_epochs/12)⌋, 0, 5)
    from ``BUCKET_MIN_EDGES`` edges on and 0 below (one stride-1 bucket).
    The reference counts the edges of its padded list, so the port decides
    from that length too (and pads nothing). An edge is processed only on
    epochs divisible by its stride."""
    eps = np.asarray(epochs_per_sample)
    max_exp = (
        0 if _padded_edge_count(len(eps)) < BUCKET_MIN_EDGES
        else int(np.clip(np.floor(np.log2(max(1.0, n_epochs / 12.0))), 0, 5))
    )
    finite = np.isfinite(eps)
    bid = np.full(len(eps), max_exp, np.int64)
    bid[finite] = np.clip(
        np.floor(np.log2(np.maximum(eps[finite], 1.0))), 0, max_exp
    ).astype(np.int64)
    return bid.astype(np.int8)


def _spectral_postprocess(emb, n_components, seed):
    """Drop the trivial top eigenvector, expand to the SGD's working scale,
    add jitter."""
    emb = np.asarray(emb)[:, 1 : n_components + 1]
    expansion = 10.0 / max(np.abs(emb).max(), 1e-12)
    emb = emb * expansion
    rng = np.random.default_rng(seed)
    emb = emb + rng.normal(scale=1e-4, size=emb.shape)
    return emb.astype(np.float32)


class MembershipOperator(NamedTuple):
    """What T16 reads: the directed (n, k) membership table W, the same
    entries sorted by target (a CSR of Wᵀ), and s = deg^-1/2 of W + Wᵀ."""

    idx: torch.Tensor       # (n, k) int32 targets (−1 padding kept)
    vals: torch.Tensor      # (n, k) float32, 0 where idx < 0 or idx == row
    t_indptr: torch.Tensor  # (n+1,) int32 over the entries sorted by target
    t_src: torch.Tensor     # (nnz,) int32 source rows, ascending per target
    t_val: torch.Tensor     # (nnz,) float32
    s: torch.Tensor         # (n,) float32, 0 on rows of degree 0


def membership_operator(idx, vals, device: DeviceLike = None) -> MembershipOperator:
    """Build the operator of the spectral seed from the membership table
    (numpy or tensors): padding (−1) and self slots count 0; the transposed
    table comes from one stable sort of the flat targets, so every row of
    Wᵀ·X is summed in the same order in every run; the degrees are the row
    sums of W plus the segment sums of the sorted values."""
    device = resolve_device(device)
    idx = torch.as_tensor(np.asarray(idx) if not torch.is_tensor(idx) else idx)
    vals = torch.as_tensor(np.asarray(vals) if not torch.is_tensor(vals) else vals)
    idx = idx.to(device=device, dtype=torch.int32).contiguous()
    vals = vals.to(device=device, dtype=torch.float32)
    if idx.dim() != 2 or idx.shape != vals.shape:
        raise ValueError(f"idx {tuple(idx.shape)} and vals {tuple(vals.shape)} must be "
                         f"one (n, k) table")
    n, k = idx.shape
    if n * k > 2**31 - 1:
        raise ValueError(f"a table of shape {(n, k)} exceeds the int32 range")
    rows = torch.arange(n, dtype=torch.int32, device=device)[:, None]
    masked = (idx < 0) | (idx == rows)
    v = torch.where(masked, 0.0, vals).contiguous()
    key = torch.where(masked, n, idx).reshape(-1)
    order = torch.sort(key, stable=True).indices  # masked entries last
    counts = torch.bincount(key.long(), minlength=n + 1)[:n]
    nnz = int(counts.sum())
    t_indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, dim=0, out=t_indptr[1:])
    t_src = (order[:nnz] // k).int().contiguous()
    t_val = v.reshape(-1)[order[:nnz]].contiguous()
    deg = v.sum(dim=1) + torch.segment_reduce(t_val, "sum", lengths=counts, unsafe=True)
    s = torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp(min=1e-30)), 0.0)
    return MembershipOperator(idx, v, t_indptr.int(), t_src, t_val, s.contiguous())


def membership_matvec(op: MembershipOperator, Q: torch.Tensor) -> torch.Tensor:
    """T16: ``s ⊙ ((W + Wᵀ)(s ⊙ Q))`` for ``Q (n, m)`` float32, m ≤ 16:
    one application of D^-1/2 (W + Wᵀ) D^-1/2."""
    if Q.device.type == "cpu":
        return membership_matvec_plain(op, Q)
    if Q.device.type != "cuda":
        raise ValueError(f"unsupported device {Q.device}")
    n, k = op.idx.shape
    if Q.dtype != torch.float32 or Q.dim() != 2 or Q.shape[0] != n \
            or not Q.is_contiguous():
        raise ValueError(f"Q must be a contiguous ({n}, m) float32 tensor, got "
                         f"{Q.dtype} {tuple(Q.shape)}")
    m = Q.shape[1]
    if not 1 <= m <= MAX_SEED_COLS:
        raise ValueError(f"T16 takes 1..{MAX_SEED_COLS} columns, got {m}")
    nnz = op.t_src.shape[0]
    for name, t, dt, shape in (
        ("idx", op.idx, torch.int32, (n, k)), ("vals", op.vals, torch.float32, (n, k)),
        ("t_indptr", op.t_indptr, torch.int32, (n + 1,)),
        ("t_src", op.t_src, torch.int32, (nnz,)),
        ("t_val", op.t_val, torch.float32, (nnz,)), ("s", op.s, torch.float32, (n,)),
    ):
        if t.device != Q.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"op.{name} must be a contiguous {dt} tensor of shape "
                             f"{shape} on {Q.device}")
    Y = torch.empty_like(Q)
    _kernels.launch(
        "membership_matvec", Q.device,
        op.idx.data_ptr(), op.vals.data_ptr(), op.t_indptr.data_ptr(),
        op.t_src.data_ptr(), op.t_val.data_ptr(), op.s.data_ptr(), Q.data_ptr(),
        n, k, m, Y.data_ptr(),
    )
    return Y


def membership_matvec_plain(op: MembershipOperator, Q: torch.Tensor) -> torch.Tensor:
    n, k = op.idx.shape
    safe = op.idx.clamp(min=0).long()
    X = Q * op.s[:, None]
    y1 = (op.vals[..., None] * X[safe]).sum(dim=1)
    y2 = torch.zeros_like(X).index_add_(
        0, safe.reshape(-1), (op.vals[..., None] * X[:, None, :]).reshape(n * k, -1))
    return (y1 + y2) * op.s[:, None]


def spectral_membership(op: MembershipOperator, q0: torch.Tensor,
                        n_iter: int = 6) -> torch.Tensor:
    """The leading eigenvectors of S = D^-1/2 (W + Wᵀ) D^-1/2 by subspace
    iteration from ``q0 (n, m)``: S² and a CholeskyQR² per step (the
    symmetric rSVD it stands in for also applies the operator twice per
    step), then a Rayleigh-Ritz step; columns by |λ| descending."""
    from .linalg import _cholqr

    # the triangular solve may hand back column-major: T16 takes row-major
    Q = _cholqr(q0).contiguous()
    for _ in range(n_iter):
        Q = _cholqr(membership_matvec(op, membership_matvec(op, Q))).contiguous()
    AQ = membership_matvec(op, Q)
    lam, V = torch.linalg.eigh(Q.T @ AQ)  # ascending
    order = torch.argsort(-lam.abs(), stable=True)
    return Q @ V[:, order]


def _membership_usable(membership, graph, min_nnz: int) -> bool:
    """The reference's gate (a tag for this many rows, a graph of at least
    ``min_nnz`` edges), and the port's own: the tag was made with mix ratio
    1, where W + Wᵀ is the union graph up to −W∘Wᵀ, and the graph still has
    the edge count it was tagged with."""
    return (
        membership is not None
        and membership.get("n") == graph.shape[0]
        and membership["idx"].shape == membership["vals"].shape
        and graph.nnz >= min_nnz
        and membership.get("nnz") == graph.nnz
        and membership.get("set_op_mix_ratio") == 1.0
    )


def spectral_init(graph: sp.csr_matrix, n_components: int, seed: int = 0,
                  membership=None, membership_min_nnz: int = MEMBERSHIP_MIN_NNZ,
                  q0=None, device: DeviceLike = None) -> np.ndarray:
    """Spectral layout from the normalised graph adjacency.

    With a ``membership`` tag (``ops/fuzzy.MEMBERSHIP_TAG``) that fits the
    graph and at least ``membership_min_nnz`` edges: the seed of
    D^-1/2 (W + Wᵀ) D^-1/2 over the membership table, on the device (T16),
    m = n_components + 8 columns, 6 S² steps. ``q0 (n, m)`` is the start of
    the iteration, drawn from a ``torch.Generator`` seeded with ``seed``
    when None. Otherwise the exact path: Dm12·G·Dm12 (scaled on the host)
    through the port's symmetric randomized SVD (T2) with 4 subspace
    iterations."""
    n = graph.shape[0]
    if _membership_usable(membership, graph, membership_min_nnz):
        device = resolve_device(device)
        m = min(n_components + 8, n)
        if q0 is None:
            gen = torch.Generator(device=device).manual_seed(int(seed))
            q0 = torch.randn((n, m), generator=gen, dtype=torch.float32, device=device)
        else:
            if not torch.is_tensor(q0):
                q0 = torch.from_numpy(np.array(q0, dtype=np.float32))
            q0 = q0.to(device=device, dtype=torch.float32).contiguous()
            if tuple(q0.shape) != (n, m):
                raise ValueError(f"q0 must have shape {(n, m)}, got {tuple(q0.shape)}")
        with stage("umap/membership_operator"):
            op = membership_operator(membership["idx"], membership["vals"], device)
        with stage("umap/membership_iteration"):
            U = spectral_membership(op, q0)[:, : n_components + 1].cpu().numpy()
        return _spectral_postprocess(U, n_components, seed)

    from .linalg import randomized_svd

    deg = np.asarray(graph.sum(axis=1)).ravel()
    deg[deg == 0] = 1.0
    Dm12 = sp.dia_matrix((1.0 / np.sqrt(deg), 0), shape=(n, n))
    A = (Dm12 @ graph @ Dm12).tocsr()
    U, _, _ = randomized_svd(A.astype(np.float32), k=n_components + 1, n_iter=4,
                             seed=seed, symmetric=True, device=device)
    return _spectral_postprocess(U.cpu().numpy(), n_components, seed)


class UmapEdges(NamedTuple):
    """The head-sorted edge list on the device."""

    indptr: torch.Tensor  # (n+1,) int32, each vertex's edges [indptr[i], indptr[i+1])
    heads: torch.Tensor   # (E,) int32 (the plain version's segment ids)
    tails: torch.Tensor   # (E,) int32
    eps: torch.Tensor     # (E,) float32 epochs per sample
    shift: torch.Tensor   # (E,) int8, log2 of the stride


def umap_edges(heads, tails, eps, shift, n: int, device: DeviceLike = None,
               v0: int = 0) -> UmapEdges:
    """Upload a head-sorted edge list (numpy) as ``UmapEdges``: the CSR over
    the ``n`` vertices ``[v0, v0 + n)`` that hold its heads (the whole
    layout, or a rank's window for T41)."""
    device = resolve_device(device)
    heads = np.asarray(heads)
    if len(heads) and np.any(np.diff(heads) < 0):
        raise ValueError("edges must be sorted by head")
    if len(heads) > 2**31 - 1:
        raise ValueError(f"{len(heads)} edges exceed the int32 index range")
    if len(heads) and (heads[0] < v0 or heads[-1] >= v0 + n):
        raise ValueError(f"a head lies outside the vertices [{v0}, {v0 + n})")
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(heads - v0, minlength=n), out=indptr[1:])
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)  # noqa: E731
    return UmapEdges(to(indptr, np.int32), to(heads, np.int32), to(tails, np.int32),
                     to(eps, np.float32), to(shift, np.int8))


def _check_epoch_args(emb, out, edges, eons, dc_exp, negs) -> None:
    n, dim = emb.shape
    E = edges.tails.shape[0]
    for name, t, dt, shape in (
        ("emb", emb, torch.float32, (n, dim)),
        ("out", out, torch.float32, (n, dim)),
        ("edges.indptr", edges.indptr, torch.int32, (n + 1,)),
        ("edges.tails", edges.tails, torch.int32, (E,)),
        ("edges.eps", edges.eps, torch.float32, (E,)),
        ("edges.shift", edges.shift, torch.int8, (E,)),
        ("eons", eons, torch.float32, (E,)),
        ("dc_exp", dc_exp, torch.float32, (n,)),
        ("negs", negs, torch.int32, (n, negs.shape[1] if negs.dim() == 2 else -1)),
    ):
        if t is None:  # T22 takes no expected due rate
            continue
        if t.device != emb.device:
            raise ValueError(f"{name} is on {t.device}, emb on {emb.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}, "
                             f"got {tuple(t.shape)}")
    if dim < 2 or n * dim > 2**31 - 1:
        raise ValueError(f"T13 and T22 take at least 2 components and n * dim below 2^31, "
                         f"got n={n} dim={dim}")
    if not 0 <= negs.shape[1] <= MAX_NEG_RATE:
        raise ValueError(f"T13 and T22 take at most {MAX_NEG_RATE} negatives per vertex, "
                         f"got {negs.shape[1]}")
    if out.data_ptr() == emb.data_ptr():
        raise ValueError("out must not alias emb: the epoch reads emb whole")


def umap_epoch(emb: torch.Tensor, out: torch.Tensor, edges: UmapEdges,
               eons: torch.Tensor, dc_exp: torch.Tensor, negs: torch.Tensor,
               epoch: int, alpha: float, a: float, b: float, gamma: float) -> torch.Tensor:
    """T13: one SGD epoch. Reads ``emb (n, dim)``, writes the new layout
    into ``out`` and returns it; advances ``eons`` of the due edges in
    place. ``negs (n, neg_rate)`` int32 are the epoch's negative samples;
    ``alpha`` is the epoch's learning rate. Any ``dim`` ≥ 2: up to 8
    components a vertex stays in registers, from 9 on a second kernel of
    the same source takes the number at run time (slower, the same sums)."""
    if emb.device.type == "cpu":
        return umap_epoch_plain(emb, out, edges, eons, dc_exp, negs, epoch, alpha, a, b, gamma)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_epoch_args(emb, out, edges, eons, dc_exp, negs)
    n, dim = emb.shape
    _kernels.launch(
        "umap_epoch", emb.device,
        emb.data_ptr(), out.data_ptr(), edges.indptr.data_ptr(), edges.tails.data_ptr(),
        edges.eps.data_ptr(), eons.data_ptr(), edges.shift.data_ptr(), dc_exp.data_ptr(),
        negs.data_ptr(), n, dim, negs.shape[1], int(epoch), float(alpha), float(a),
        float(b), float(gamma),
    )
    return out


def _clipped_attraction(emb: torch.Tensor, edges: UmapEdges, due: torch.Tensor,
                        a: float, b: float) -> torch.Tensor:
    """g(e) of every edge, clipped to ±4, zero where not ``due`` (E, dim);
    ``edges.heads`` and ``edges.tails`` are rows of ``emb``."""
    diff = emb[edges.heads.long()] - emb[edges.tails.long()]
    d2 = (diff * diff).sum(-1)
    coeff = (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0)
    coeff = torch.where(d2 > 0, coeff, 0.0)
    g = torch.clamp(coeff[:, None] * diff, -4.0, 4.0)
    return torch.where(due[:, None], g, 0.0)


def _negative_sums(emb: torch.Tensor, negs: torch.Tensor, a: float, b: float,
                   gamma: float, v0: int = 0) -> torch.Tensor:
    """The vertex-pooled repulsion of the vertices ``[v0, v0 + nv)``, each
    row of ``negs (nv, R)`` one's, summed over its negatives: a self hit
    adds 0, a negative at the vertex's own position 4 (nv, dim)."""
    nv, R = negs.shape
    vneg = emb[negs.reshape(-1).long()].reshape(nv, R, -1)
    diffn = emb[v0:v0 + nv, None, :] - vneg
    d2n = (diffn * diffn).sum(-1)
    cn = (2.0 * gamma * b) / ((0.001 + d2n) * (a * d2n**b + 1.0))
    gn = torch.where(d2n[..., None] > 0, torch.clamp(cn[..., None] * diffn, -4.0, 4.0), 4.0)
    self_hit = negs.long() == v0 + torch.arange(nv, device=emb.device)[:, None]
    return torch.where(self_hit[..., None], 0.0, gn).sum(dim=1)


def umap_epoch_plain(emb: torch.Tensor, out: torch.Tensor, edges: UmapEdges,
                     eons: torch.Tensor, dc_exp: torch.Tensor, negs: torch.Tensor,
                     epoch: int, alpha: float, a: float, b: float,
                     gamma: float) -> torch.Tensor:
    stride = torch.ones_like(edges.shift, dtype=torch.int64) << edges.shift.long()
    due = (int(epoch) % stride == 0) & (eons <= float(epoch) + 1.0)
    g = _clipped_attraction(emb, edges, due, a, b)
    upd_h = torch.zeros_like(emb).index_add_(0, edges.heads.long(), g)
    eons.copy_(torch.where(due, eons + edges.eps, eons))
    upd_neg = _negative_sums(emb, negs, a, b, gamma) * dc_exp[:, None]
    return out.copy_(emb + alpha * (2.0 * upd_h + upd_neg))


def _check_block_args(emb, out_blk, edges, eons, dc_exp, negs, v0) -> None:
    n, dim = emb.shape
    nv = edges.indptr.shape[0] - 1
    E = edges.tails.shape[0]
    R = negs.shape[1] if negs.dim() == 2 else -1
    for name, t, dt, shape in (
        ("emb", emb, torch.float32, (n, dim)),
        ("out_blk", out_blk, torch.float32, (nv, dim)),
        ("edges.indptr", edges.indptr, torch.int32, (nv + 1,)),
        ("edges.tails", edges.tails, torch.int32, (E,)),
        ("edges.eps", edges.eps, torch.float32, (E,)),
        ("eons", eons, torch.float32, (E,)),
        ("dc_exp", dc_exp, torch.float32, (nv,)),
        ("negs", negs, torch.int32, (nv, R)),
    ):
        if t.device != emb.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape {shape} "
                             f"on {emb.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if dim < 2 or n * dim > 2**31 - 1 or not 0 <= v0 <= n - nv:
        raise ValueError(f"T41 takes at least 2 components, n * dim below 2^31 and a "
                         f"window inside the layout, got n={n} dim={dim} [{v0}, {v0 + nv})")
    if not 0 <= R <= MAX_NEG_RATE:
        raise ValueError(f"T41 takes at most {MAX_NEG_RATE} negatives per vertex, got {R}")
    if out_blk.data_ptr() == emb.data_ptr():
        raise ValueError("out_blk must not alias emb: the epoch reads emb whole")


def umap_epoch_block(emb: torch.Tensor, out_blk: torch.Tensor, edges: UmapEdges,
                     eons: torch.Tensor, dc_exp: torch.Tensor, negs: torch.Tensor,
                     v0: int, epoch: int, alpha: float, a: float, b: float,
                     gamma: float) -> torch.Tensor:
    """T41: one epoch of the sharded SGD on the vertex window ``[v0, v0 +
    nv)``. Reads the whole layout ``emb (n, dim)``; ``edges`` are the
    window's (a CSR over it from ``umap_edges(..., v0=v0)``, tails global,
    ``shift`` not read: every edge has stride 1), ``eons`` theirs, advanced
    in place where due (eons ≤ epoch + 1); ``dc_exp (nv,)`` and ``negs (nv,
    neg_rate)`` the window's. Writes the window's new rows into ``out_blk
    (nv, dim)`` and returns it: emb + α(2·upd_h + dc·upd_neg), every update
    summed from ``emb``."""
    if emb.device.type == "cpu":
        return umap_epoch_block_plain(emb, out_blk, edges, eons, dc_exp, negs, v0, epoch,
                                      alpha, a, b, gamma)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_block_args(emb, out_blk, edges, eons, dc_exp, negs, v0)
    nv, dim = out_blk.shape
    _kernels.launch(
        "umap_epoch_block", emb.device,
        emb.data_ptr(), out_blk.data_ptr(), edges.indptr.data_ptr(), edges.tails.data_ptr(),
        edges.eps.data_ptr(), eons.data_ptr(), dc_exp.data_ptr(), negs.data_ptr(), int(v0),
        nv, dim, negs.shape[1], int(epoch), float(alpha), float(a), float(b), float(gamma),
    )
    return out_blk


def umap_epoch_block_plain(emb: torch.Tensor, out_blk: torch.Tensor, edges: UmapEdges,
                           eons: torch.Tensor, dc_exp: torch.Tensor, negs: torch.Tensor,
                           v0: int, epoch: int, alpha: float, a: float, b: float,
                           gamma: float) -> torch.Tensor:
    nv = out_blk.shape[0]
    due = eons <= float(epoch) + 1.0
    g = _clipped_attraction(emb, edges, due, a, b)
    upd_h = torch.zeros_like(out_blk).index_add_(0, edges.heads.long() - v0, g)
    eons.copy_(torch.where(due, eons + edges.eps, eons))
    upd_neg = _negative_sums(emb, negs, a, b, gamma, v0) * dc_exp[:, None]
    return out_blk.copy_(emb[v0:v0 + nv] + alpha * (2.0 * upd_h + upd_neg))


class UmapTails(NamedTuple):
    """The edges again, sorted by tail: a CSR over the tail vertices."""

    indptr: torch.Tensor  # (n+1,) int32, vertex i is the tail of order[indptr[i]:indptr[i+1]]
    order: torch.Tensor   # (E,) int32 edge indices, ascending within a tail (stable)


def umap_tails(edges: UmapEdges) -> UmapTails:
    """The tail-sorted order of ``edges`` on their device (the reference's
    stable ``argsort(tails)``)."""
    n = edges.indptr.shape[0] - 1
    order = torch.sort(edges.tails, stable=True).indices
    counts = torch.bincount(edges.tails.long(), minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=edges.tails.device)
    torch.cumsum(counts, dim=0, out=indptr[1:])
    return UmapTails(indptr.int(), order.int())


def _check_asym_args(emb, out, edges, tails, eons, eons_out, negs) -> None:
    E = edges.tails.shape[0]
    _check_epoch_args(emb, out, edges, eons, None, negs)
    for name, t, dt, shape in (
        ("edges.heads", edges.heads, torch.int32, (E,)),
        ("tails.indptr", tails.indptr, torch.int32, (emb.shape[0] + 1,)),
        ("tails.order", tails.order, torch.int32, (E,)),
        ("eons_out", eons_out, torch.float32, (E,)),
    ):
        if t.device != emb.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor of shape {shape} "
                             f"on {emb.device}")
    if eons_out.data_ptr() == eons.data_ptr():
        raise ValueError("eons_out must not alias eons: the tail pass reads eons whole")


def umap_epoch_asym(emb: torch.Tensor, out: torch.Tensor, edges: UmapEdges,
                    tails: UmapTails, eons: torch.Tensor, eons_out: torch.Tensor,
                    negs: torch.Tensor, epoch: int, alpha: float, a: float, b: float,
                    gamma: float) -> torch.Tensor:
    """T22: one SGD epoch of an asymmetric graph. Reads ``emb (n, dim)`` and
    ``eons``, writes the new layout into ``out`` and the advanced eons into
    ``eons_out``; returns ``out``. An edge is due when eons ≤ epoch + 1 (no
    stride); the repulsion of ``negs (n, neg_rate)`` is scaled by the
    vertex's count of due head edges; the tail update is subtracted:
    out = emb + α(upd_h + upd_neg) − α·upd_t. ``edges.shift`` is not read."""
    if emb.device.type == "cpu":
        return umap_epoch_asym_plain(emb, out, edges, tails, eons, eons_out, negs, epoch,
                                     alpha, a, b, gamma)
    if emb.device.type != "cuda":
        raise ValueError(f"unsupported device {emb.device}")
    _check_asym_args(emb, out, edges, tails, eons, eons_out, negs)
    n, dim = emb.shape
    _kernels.launch(
        "umap_epoch_asym", emb.device,
        emb.data_ptr(), out.data_ptr(), edges.indptr.data_ptr(), edges.heads.data_ptr(),
        edges.tails.data_ptr(), edges.eps.data_ptr(), eons.data_ptr(), eons_out.data_ptr(),
        tails.indptr.data_ptr(), tails.order.data_ptr(), negs.data_ptr(), n, dim,
        negs.shape[1], int(epoch), float(alpha), float(a), float(b), float(gamma),
    )
    return out


def umap_epoch_asym_plain(emb: torch.Tensor, out: torch.Tensor, edges: UmapEdges,
                          tails: UmapTails, eons: torch.Tensor, eons_out: torch.Tensor,
                          negs: torch.Tensor, epoch: int, alpha: float, a: float, b: float,
                          gamma: float) -> torch.Tensor:
    due = eons <= float(epoch) + 1.0
    g = _clipped_attraction(emb, edges, due, a, b)
    heads = edges.heads.long()
    upd_h = torch.zeros_like(emb).index_add_(0, heads, g)
    order = tails.order.long()
    upd_t = torch.zeros_like(emb).index_add_(0, edges.tails.long()[order], g[order])
    dc = torch.zeros(emb.shape[0], dtype=emb.dtype, device=emb.device).index_add_(
        0, heads, due.to(emb.dtype))
    eons_out.copy_(torch.where(due, eons + edges.eps, eons))
    upd_neg = _negative_sums(emb, negs, a, b, gamma) * dc[:, None]
    return out.copy_(emb + alpha * (upd_h + upd_neg) - alpha * upd_t)


def epoch_alpha(init_alpha: float, epoch: int, n_epochs: int) -> float:
    """The epoch's learning rate init_alpha·(1 − epoch/n_epochs), in
    float32 as the reference computes it."""
    f = np.float32
    return float(f(init_alpha) * (f(1.0) - f(epoch) / f(n_epochs)))


def umap_embed(
    graph: sp.csr_matrix,
    n_components: int = 2,
    n_epochs=None,
    init="spectral",
    min_dist: float = 0.5,
    spread: float = 1.0,
    alpha: float = 1.0,
    gamma: float = 1.0,
    negative_sample_rate: int = 5,
    a=None,
    b=None,
    random_state: int = 42,
    assume_symmetric=None,
    device: DeviceLike = None,
) -> np.ndarray:
    """Optimise a low-dimensional embedding of a fuzzy simplicial graph;
    returns the (n, n_components) float32 layout on the host.

    ``assume_symmetric=True`` skips the O(nnz·log) scipy ``G − Gᵀ`` probe.
    An asymmetric graph, or ``assume_symmetric=False``, runs the
    reference's tail-pass program (T22) instead of the symmetric fold
    (T13)."""
    device = resolve_device(device)
    n = graph.shape[0]
    # read the tag before tocoo(): the COO copy does not carry it
    membership = getattr(graph, MEMBERSHIP_TAG, None)
    graph = graph.tocoo()
    if a is None or b is None:
        a, b = find_ab_params(spread, min_dist)
    if n_epochs is None:
        n_epochs = 500 if n <= 10000 else 200
    n_epochs = int(n_epochs)
    seed = random_state if isinstance(random_state, int) else 0

    with stage("umap/edge_schedule(host)"):
        heads, tails, eps, w, dc_exp = edge_schedule(graph, n_epochs)
        if assume_symmetric is None:
            Gk = sp.csr_matrix((w, (heads, tails)), shape=(n, n))
            symmetric = bool(np.abs((Gk - Gk.T).data).max(initial=0.0) < 1e-12)
        else:
            symmetric = bool(assume_symmetric)
        # the asymmetric program has no stride buckets
        shift = bucket_shifts(eps, n_epochs) if symmetric else np.zeros(len(eps), np.int8)

    if isinstance(init, np.ndarray):
        emb = np.asarray(init, dtype=np.float32)
    elif init == "random":
        rng = np.random.default_rng(random_state)
        emb = rng.uniform(-10, 10, size=(n, n_components)).astype(np.float32)
    else:
        with stage("umap/spectral_init"):
            emb = spectral_init(sp.csr_matrix(graph), n_components, seed=seed,
                                membership=membership, device=device)

    with stage("umap/upload"):
        edges = umap_edges(heads, tails, eps, shift, n, device)
        eons = edges.eps.clone()  # first due at t = eps
        dc = torch.from_numpy(dc_exp).to(device)
        cur = torch.from_numpy(np.ascontiguousarray(emb, np.float32)).to(device)
        nxt = torch.empty_like(cur)
        if not symmetric:
            by_tail, eons_nxt = umap_tails(edges), torch.empty_like(eons)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    with stage(f"umap/sgd_{n_epochs}epochs"):
        for epoch in range(n_epochs):
            negs = torch.randint(0, n, (n, int(negative_sample_rate)), generator=gen,
                                 dtype=torch.int32, device=device)
            alpha_e = epoch_alpha(alpha, epoch, n_epochs)
            if symmetric:
                umap_epoch(cur, nxt, edges, eons, dc, negs, epoch, alpha_e, a, b, gamma)
            else:
                umap_epoch_asym(cur, nxt, edges, by_tail, eons, eons_nxt, negs, epoch,
                                alpha_e, a, b, gamma)
                eons, eons_nxt = eons_nxt, eons
            cur, nxt = nxt, cur
    with stage("umap/download"):
        return cur.cpu().numpy()
