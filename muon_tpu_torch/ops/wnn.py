"""Single-modality neighbors and the WNN multimodal fusion (counterpart of
muon_tpu/ops/wnn.py).

    wnn_bandwidth      T9   <- _bandwidth_fn + _bandwidth_block_math
    wnn_theta          T10  <- _theta_fn + _theta_block_math
    wnn_fusion_scores  T11  <- _fusion_all_fn + _fusion_block_math
                                (csrc/wnn_kernels.cu)

The kNN runs through T5 (ops/knn.py) and σ, ρ and the membership values
through T6 (ops/fuzzy.py); the fuzzy union and the CSR assembly are host
work. WNN's candidate dedup and final top-k (the reference's
``_cand_dedup_fn``, ``_trim_pad_fn``, ``_final_topk_fn``) are torch, and
the modality ratios and softmax are host float64, as in the reference.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from scipy import sparse as sp
from scipy.sparse import issparse

from ..utils.profiling import stage
from . import _kernels
from .device import DeviceLike, dense_to_tensor, resolve_device
from .fuzzy import compute_connectivities_umap
from .knn import IVF_THRESHOLD, _order_keys, knn

__all__ = [
    "choose_representation", "single_neighbors", "wnn_neighbors",
    "wnn_bandwidth", "wnn_bandwidth_plain", "wnn_theta", "wnn_theta_plain",
    "wnn_fusion_scores", "wnn_fusion_scores_plain", "padded_table", "cand_dedup",
    "final_topk",
]

# above this many rows the reference's neighbors take the approximate kNN
APPROX_ROWS = 20_000
# the largest shared memory a block may opt into on sm_90 (bytes)
MAX_SMEM = 227 * 1024
# T9's static shared memory (bytes): its selection's 256-bin histogram, the
# per-warp tie counts and four scalars (kBwStatic ints in the source)
BANDWIDTH_STATIC_SMEM = 4 * (256 + 8 + 4)
# blocks of T9's global-memory variant (4 per SM of an H100), each with its
# own slice of the scratch
BANDWIDTH_SCRATCH_BLOCKS = 528
# T11: cells (warps) a block, the 16-byte pieces of a candidate's row that
# one staged chunk holds, and the candidates of a tile (kFusionTile in the
# source: a lane each)
FUSION_WARPS, FUSION_CHUNK, FUSION_TILE = 8, 7, 32


def _n_obs(adata) -> int:
    n = getattr(adata, "n_obs", None)
    return int(n) if n is not None else int(adata.X.shape[0])


def _n_vars(adata) -> int:
    n = getattr(adata, "n_vars", None)
    return int(n) if n is not None else int(adata.X.shape[1])


def _dense_X(adata) -> np.ndarray:
    X = adata.X
    if issparse(X):
        X = np.asarray(X.todense())
    return np.asarray(X, dtype=np.float32)


def _first_pcs(rep, n_pcs) -> np.ndarray:
    if n_pcs is not None and n_pcs not in (-1, 0):
        rep = rep[:, :n_pcs]
    return np.asarray(rep, dtype=np.float32)


def choose_representation(adata, use_rep=None, n_pcs=None,
                          device: DeviceLike = None) -> np.ndarray:
    """The float32 (n_obs, ·) matrix the kNN runs on (scanpy
    ``_choose_representation`` parity): ``obsm["X_pca"]`` when present,
    else a PCA of X computed now (more than 50 variables) or X itself;
    ``use_rep="X"`` or an ``obsm`` key. ``n_pcs`` cuts PCA columns."""
    if use_rep is None or use_rep == -1:
        if "X_pca" in adata.obsm:
            return _first_pcs(np.asarray(adata.obsm["X_pca"]), n_pcs)
        if _n_vars(adata) > 50:
            from .linalg import pca

            scores, *_ = pca(
                adata.X if issparse(adata.X) else np.asarray(adata.X),
                n_comps=min(50, _n_vars(adata) - 1), device=device,
            )
            adata.obsm["X_pca"] = scores.cpu().numpy()
            return _first_pcs(adata.obsm["X_pca"], n_pcs)
        return _dense_X(adata)
    if use_rep == "X":
        return _dense_X(adata)
    rep = np.asarray(adata.obsm[use_rep])
    if "pca" in str(use_rep).lower():
        return _first_pcs(rep, n_pcs)
    return np.asarray(rep, dtype=np.float32)


def single_neighbors(
    adata,
    n_neighbors: int = 15,
    use_rep=None,
    n_pcs=None,
    metric: str = "euclidean",
    key_added=None,
    random_state: int = 0,
    mesh=None,
    device: DeviceLike = None,
):
    """kNN + UMAP connectivities for one modality. Writes
    ``obsp["distances"]`` (the (n, n) CSR of the n_neighbors − 1 non-self
    distances), ``obsp["connectivities"]`` and ``uns["neighbors"]`` with the
    reference's params layout, and returns ``adata``.

    Above 20,000 rows the kNN takes the ``approx`` (bfloat16) path, and
    above ``ops/knn.IVF_THRESHOLD`` rows the IVF index, as in the reference.
    ``mesh`` (or ``set_options(mesh=...)``): a ``parallel.Mesh`` of more than
    one rank runs the exact ring kNN (``parallel.sharded_knn``, float32),
    or above ``IVF_THRESHOLD`` rows the sharded IVF index, euclidean only,
    as the reference; every rank writes the same graph. The distances carry no tag:
    WNN rebuilds its neighbour matrix from the CSR, so a graph edited in
    place is never read stale. The connectivities carry the membership
    table as numpy (``ops/fuzzy.MEMBERSHIP_TAG``), which ``tl.umap`` seeds
    from above 8M edges while the graph still has the edge count it was
    tagged with."""
    from .._core.config import resolve_mesh

    mesh, device = resolve_mesh(mesh, device)
    rep = choose_representation(adata, use_rep=use_rep, n_pcs=n_pcs, device=device)
    if mesh is None:
        idx_t, dists_t = knn(rep, n_neighbors - 1, metric=metric,
                             approx=rep.shape[0] > APPROX_ROWS, device=device)
    elif metric not in ("euclidean", "l2"):
        raise NotImplementedError(
            f"metric {metric!r} over a device mesh: the sharded kNN is euclidean, as the "
            "reference's"
        )
    elif rep.shape[0] > IVF_THRESHOLD:
        from ..parallel.pipeline import sharded_ivf_knn

        idx_t, dists_t = sharded_ivf_knn(rep, mesh, k=n_neighbors - 1)
    else:
        from ..parallel.pipeline import sharded_knn

        d2, idx_t = sharded_knn(rep, mesh, k=n_neighbors - 1)
        dists_t = torch.sqrt(torch.clamp(d2, min=0.0))
    n = _n_obs(adata)
    k = idx_t.shape[1]  # n_neighbors incl. self
    with stage("neighbors/download"):
        idx = idx_t.cpu().numpy()
    conn = compute_connectivities_umap(idx, dists_t, n, k)
    with stage("neighbors/csr"):
        dists = dists_t.cpu().numpy().astype(np.float64)
        rows = np.repeat(np.arange(n), k - 1)
        # columns sorted (scipy's COO → CSR sums duplicates, which sorts):
        # WNN reads them in this order, and σ's selection breaks ties by
        # candidate position, so the order is behaviour
        dmat = sp.csr_matrix(
            (dists[:, 1:].reshape(-1), (rows, idx[:, 1:].reshape(-1))), shape=(n, n)
        )

    if key_added is None:
        key_added, conns_key, dists_key = "neighbors", "connectivities", "distances"
    else:
        conns_key, dists_key = f"{key_added}_connectivities", f"{key_added}_distances"
    adata.obsp[dists_key] = dmat
    adata.obsp[conns_key] = conn
    adata.uns[key_added] = {
        "connectivities_key": conns_key,
        "distances_key": dists_key,
        "params": {
            "n_neighbors": int(n_neighbors),
            "method": "umap",
            "random_state": random_state,
            "metric": metric,
            "use_rep": use_rep if use_rep is not None else -1,
            "n_pcs": n_pcs if n_pcs is not None else -1,
        },
    }
    return adata


# ---------------------------------------------------------------------------
# the WNN kernels and their plain versions
# ---------------------------------------------------------------------------


def _neighbor_index_matrix(dmat: sp.csr_matrix) -> Tuple[np.ndarray, np.ndarray]:
    """CSR kNN-graph rows → fixed-width (n, kk) int32 index matrix (pad −1,
    in the CSR's own column order) and the per-row min distance (f32)."""
    n = dmat.shape[0]
    counts = np.diff(dmat.indptr)
    if counts.min() == 0:
        raise ValueError(
            "A cell has no neighbors in a modality graph. Make sure to "
            "subset before calculating nearest neighbors."
        )
    kk = int(counts.max())
    NI = np.full((n, kk), -1, dtype=np.int32)
    ND = np.full((n, kk), np.inf, dtype=np.float32)
    for_r = np.repeat(np.arange(n), counts)
    pos = np.arange(dmat.nnz) - np.repeat(dmat.indptr[:-1], counts)
    NI[for_r, pos] = dmat.indices.astype(np.int32)
    ND[for_r, pos] = dmat.data.astype(np.float32)
    return NI, ND.min(axis=1)


def _auto_nn_stride(kk: int) -> int:
    """The reference's stride of the 2-hop candidate pool: 2 once neighbour
    lists are 16 wide."""
    return 2 if kk >= 16 else 1


def _bandwidth_tables(NI: torch.Tensor, rep: torch.Tensor):
    """What T9 reads besides NI: per-row set sizes (int32), the bf16 rep and
    the squared norms of the unrounded rep (f32)."""
    return (
        (NI >= 0).sum(dim=1, dtype=torch.int32),
        rep.to(torch.bfloat16).contiguous(),
        (rep * rep).sum(dim=1),
    )


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the kernels' sqrtf and
    numpy give it: through float64, which is exact for it. torch's
    vectorised CPU float32 sqrt can be an ulp off, on some lanes only, and
    an ulp decides ties of the bandwidth score and of the final top-k."""
    return torch.sqrt(x.double()).float()


def _check(t: torch.Tensor, dtype, shape, name: str, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _bandwidth_smem(kk: int, d: int, n_bw: int, nn_stride: int) -> int:
    """T9's dynamic shared memory in bytes when one block per cell holds its
    C = kk + kk·⌈kk/stride⌉ candidates (ids, scores, distances), the sorted
    set, the top-osz order and the cell's rep. C grows as kk². Where these
    and the kernel's ``BANDWIDTH_STATIC_SMEM`` pass ``MAX_SMEM`` the wrapper
    takes the variant that keeps the candidates' tables in global memory."""
    C = kk + kk * (-(-kk // nn_stride))
    return 4 * (kk + 3 * C + 2 * min(C, 4 * n_bw) + d)


def _bandwidth_in_smem(kk: int, d: int, n_bw: int, nn_stride: int) -> bool:
    """Whether T9 keeps a cell's candidate tables in shared memory: the
    dynamic part (``_bandwidth_smem``) and the kernel's static part together
    within ``MAX_SMEM``; else the variant with the tables in global memory."""
    return _bandwidth_smem(kk, d, n_bw, nn_stride) + BANDWIDTH_STATIC_SMEM <= MAX_SMEM


def _window(n: int, row0: int, rows, what: str) -> int:
    rows = n - int(row0) if rows is None else int(rows)
    if not (0 <= int(row0) and 0 <= rows and int(row0) + rows <= n):
        raise ValueError(f"{what}: the window of {rows} rows from row {row0} lies outside "
                         f"the tables' {n} rows")
    return rows


def wnn_bandwidth(
    NI: torch.Tensor, set_sizes: torch.Tensor, rep16: torch.Tensor,
    sq: torch.Tensor, n_total: float, bbox: float, n_bw: int, nn_stride: int,
    row0: int = 0, rows=None,
) -> torch.Tensor:
    """T9: σ (rows,) float32 per cell of the window [row0, row0 + rows)
    (default: every row) from the neighbour matrix ``NI (n, kk)`` int32
    (pad −1) and the tables of :func:`_bandwidth_tables`, all of n rows:
    the mean euclidean distance to the ``n_bw`` candidates of largest
    Jaccard distance between neighbour sets (ties: largest distance), among
    the cell's neighbours and every ``nn_stride``-th neighbour of each. A
    rank of a mesh passes its rows' window over the whole tables.

    Two variants of one kernel, chosen by shape: while a cell's candidate
    tables fit a block's shared memory (``_bandwidth_in_smem``; kk ≤ 194 at
    stride 2 and d = 50) a block per cell keeps them there
    (counted as ``wnn_bandwidth``); above that they live in a scratch tensor
    in global memory, min(rows, 528) blocks walking the cells (counted as
    ``wnn_bandwidth_global``). Same arithmetic, same orders."""
    if NI.device.type == "cpu":
        return wnn_bandwidth_plain(NI, set_sizes, rep16, sq, n_total, bbox, n_bw, nn_stride,
                                   row0, rows)
    if NI.device.type != "cuda":
        raise ValueError(f"unsupported device {NI.device}")
    n, kk = NI.shape
    rows = _window(n, row0, rows, "T9")
    d = rep16.shape[1] if rep16.dim() == 2 else -1
    _check(NI, torch.int32, (n, kk), "NI", NI.device)
    _check(set_sizes, torch.int32, (n,), "set_sizes", NI.device)
    _check(rep16, torch.bfloat16, (n, d), "rep16", NI.device)
    _check(sq, torch.float32, (n,), "sq", NI.device)
    if not (kk >= 1 and d >= 1 and n_bw >= 1 and nn_stride >= 1) or n * max(kk, d) > 2**31 - 1:
        raise ValueError(f"T9 takes kk, d, n_bw, nn_stride >= 1 and n*max(kk, d) "
                         f"< 2^31; got n={n} kk={kk} d={d} n_bw={n_bw} "
                         f"nn_stride={nn_stride}")
    sigma = torch.empty(rows, dtype=torch.float32, device=NI.device)
    args = (NI.data_ptr(), set_sizes.data_ptr(), rep16.data_ptr(), sq.data_ptr(),
            n, int(row0), rows, kk, d, int(nn_stride), int(n_bw), float(n_total), float(bbox))
    if _bandwidth_in_smem(kk, d, n_bw, nn_stride):
        _kernels.launch("wnn_bandwidth", NI.device, *args, 0, 0, sigma.data_ptr())
        return sigma
    if 4 * (kk + d) > MAX_SMEM:
        raise ValueError(f"T9 keeps a cell's sorted set and rep in {4 * (kk + d)} bytes "
                         f"of shared memory, above the {MAX_SMEM} a block may take")
    C = kk + kk * (-(-kk // nn_stride))
    blocks = max(1, min(rows, BANDWIDTH_SCRATCH_BLOCKS))
    scratch = torch.empty((blocks, 3 * C + 2 * min(C, 4 * n_bw)), dtype=torch.int32,
                          device=NI.device)
    _kernels.launch("wnn_bandwidth_global", NI.device, *args, scratch.data_ptr(), blocks,
                    sigma.data_ptr())
    return sigma


def wnn_bandwidth_plain(
    NI: torch.Tensor, set_sizes: torch.Tensor, rep16: torch.Tensor,
    sq: torch.Tensor, n_total: float, bbox: float, n_bw: int, nn_stride: int,
    row0: int = 0, rows=None,
) -> torch.Tensor:
    n, kk = NI.shape
    row0 = int(row0)
    end = row0 + _window(n, row0, rows, "wnn_bandwidth_plain")
    s = NI[:, ::nn_stride].shape[1]
    C = kk + kk * s
    osz = min(C, 4 * n_bw)
    dev = NI.device
    N = torch.tensor(n_total, dtype=torch.float32, device=dev)
    bb = torch.tensor(bbox, dtype=torch.float32, device=dev)
    NI_sub = NI[:, ::nn_stride]
    rep_f = rep16.float()
    pos = torch.arange(C, device=dev)
    tri = torch.tril(torch.ones((osz, osz), dtype=torch.bool, device=dev), diagonal=-1)
    block = max(1, (1 << 25) // (C * max(kk, rep16.shape[1])))
    out = torch.empty(end - row0, dtype=torch.float32, device=dev)
    for r0 in range(row0, end, block):
        r1 = min(r0 + block, end)
        NI_b = NI[r0:r1]
        b = r1 - r0
        rows = torch.arange(r0, r1, device=dev)
        nn = NI_sub[NI_b.clamp(min=0).long()].reshape(b, kk * s)
        nn = torch.where((NI_b < 0).repeat_interleave(s, dim=1), -1, nn)
        cand = torch.cat([NI_b, nn], dim=1)
        cs = cand.clamp(min=0).long()
        Sx = torch.where(NI_b < 0, -2, NI_b)
        Sy = NI[cs]
        Sy = torch.where(Sy >= 0, Sy, -3)
        # |Sx ∩ Sy| per candidate: each entry of Sy counted in the sorted Sx
        # (the reference compares all kk × kk pairs; the counts are the same)
        Sx_sorted = torch.sort(Sx, dim=1).values
        Sy_flat = Sy.reshape(b, C * kk)
        inter = (torch.searchsorted(Sx_sorted, Sy_flat, right=True)
                 - torch.searchsorted(Sx_sorted, Sy_flat, right=False)
                 ).reshape(b, C, kk).sum(dim=-1)
        union = (set_sizes[r0:r1, None] + set_sizes[cs] - inter).clamp(min=1)
        jac = 1.0 - inter.float() / union.float()
        cross = (rep_f[r0:r1, None, :] * rep_f[cs]).sum(dim=-1)
        eucl = _sqrt(torch.clamp((sq[r0:r1, None] + sq[cs]) - 2.0 * cross, min=0.0))
        score = (N - jac * N) + (bb - eucl) / bb
        bad = (cand < 0) | (cand == rows[:, None]) | (jac >= 1.0)
        score = torch.where(bad, N + 1.0, score)
        top = torch.topk(_order_keys(score, pos), osz, dim=1, largest=False,
                         sorted=True).indices
        top_c = cand.gather(1, top)
        top_e = eucl.gather(1, top)
        top_bad = score.gather(1, top) >= N + 1.0
        dup = ((top_c[:, None, :] == top_c[:, :, None]) & tri).any(dim=-1)
        ok = ~(top_bad | dup)
        keep = ok & (torch.cumsum(ok, dim=1) <= n_bw)
        cnt = keep.sum(dim=1)
        out[r0 - row0:r1 - row0] = torch.where(
            cnt > 0, (top_e * keep).sum(dim=1) / cnt.clamp(min=1), eucl[:, :kk].mean(dim=1)
        )
    return out


def wnn_theta(
    rep: torch.Tensor, rows1: torch.Tensor, rows2: torch.Tensor,
    NI2: torch.Tensor, conv: torch.Tensor, nnd: torch.Tensor, sigma: torch.Tensor,
) -> torch.Tensor:
    """T10: θ (m,) float32 for the cells ``rows1`` (mod1-local) /
    ``rows2`` (mod2-local): r = mean of the mod1 ``rep`` (n1, d) f32 over
    the cell's mod2 neighbours ``NI2`` (n2, kk), remapped by ``conv``
    (n2,) to mod1-local ids (−1 absent); θ = exp(−max(‖x − r‖ − nnd, 0) /
    max(σ − nnd, 1e-12)) with the mod1 row's ``nnd`` and ``sigma``."""
    if rep.device.type == "cpu":
        return wnn_theta_plain(rep, rows1, rows2, NI2, conv, nnd, sigma)
    if rep.device.type != "cuda":
        raise ValueError(f"unsupported device {rep.device}")
    n1, d = rep.shape
    m = rows1.shape[0]
    n2, kk = NI2.shape
    dev = rep.device
    _check(rep, torch.float32, (n1, d), "rep", dev)
    _check(rows1, torch.int32, (m,), "rows1", dev)
    _check(rows2, torch.int32, (m,), "rows2", dev)
    _check(NI2, torch.int32, (n2, kk), "NI2", dev)
    _check(conv, torch.int32, (n2,), "conv", dev)
    _check(nnd, torch.float32, (n1,), "nnd", dev)
    _check(sigma, torch.float32, (n1,), "sigma", dev)
    if m * 32 > 2**31 - 1 or n1 * d > 2**31 - 1:
        raise ValueError(f"T10 takes m * 32 and n1 * d below 2^31, got m={m} "
                         f"n1={n1} d={d}")
    theta = torch.empty(m, dtype=torch.float32, device=dev)
    _kernels.launch(
        "wnn_theta", dev,
        rep.data_ptr(), rows1.data_ptr(), rows2.data_ptr(), NI2.data_ptr(),
        conv.data_ptr(), nnd.data_ptr(), sigma.data_ptr(), m, d, kk,
        theta.data_ptr(),
    )
    return theta


def wnn_theta_plain(
    rep: torch.Tensor, rows1: torch.Tensor, rows2: torch.Tensor,
    NI2: torch.Tensor, conv: torch.Tensor, nnd: torch.Tensor, sigma: torch.Tensor,
) -> torch.Tensor:
    m = rows1.shape[0]
    kk, d = NI2.shape[1], rep.shape[1]
    out = torch.empty(m, dtype=torch.float32, device=rep.device)
    block = max(1, (1 << 26) // max(1, kk * d))
    for r0 in range(0, m, block):
        r1 = min(r0 + block, m)
        i1 = rows1[r0:r1].long()
        nb = NI2[rows2[r0:r1].long()]
        valid = nb >= 0
        mapped = conv[torch.where(valid, nb, 0).long()]
        valid = valid & (mapped >= 0)
        gathered = rep[torch.where(valid, mapped, 0).long()]
        w = valid[..., None].float()
        r = (gathered * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        dist = _sqrt(torch.clamp(((rep[i1] - r) ** 2).sum(dim=-1), min=0.0))
        nd = nnd[i1]
        out[r0:r1] = torch.exp(
            -torch.clamp(dist - nd, min=0.0) / torch.clamp(sigma[i1] - nd, min=1e-12)
        )
    return out


def _dims_offsets(dims: Sequence[Tuple[int, int]], D: int) -> list:
    offs = [0]
    for lo, hi in dims:
        if lo != offs[-1] or hi < lo:
            raise ValueError(f"dims {dims} must be consecutive slices from 0")
        offs.append(hi)
    if offs[-1] != D:
        raise ValueError(f"dims {dims} must cover the table's {D} columns")
    return offs


def _fusion_warp_bytes(D: int, M: int, chunk: int) -> int:
    """T11's shared memory a warp (``FusionShape::warp_bytes`` in the
    source): two buffers of a tile's staged rows (a chunk of ⌈D/8⌉ 16-byte
    pieces, made an odd number of pieces), the cell's row as float32, two
    buffers of a tile's aux rows (2M words, made odd), and the cell's aux
    and sigw rows and the M + 1 slice bounds."""
    pieces = -(-D // 8)
    kc = max(1, min(pieces, chunk))
    srow, arow = kc | 1, (2 * M) | 1
    T = FUSION_TILE
    b = 2 * T * srow * 16 + 4 * 8 * pieces + 2 * T * arow * 4 + 4 * (5 * M + 1)
    return -(-b // 16) * 16


def padded_table(cat16: torch.Tensor) -> torch.Tensor:
    """The bf16 table (n, D) as T11 gathers it: its rows a stride of a
    multiple of 8 values (16 bytes) apart, 16-byte aligned, the storage
    reaching past the last row's ⌈D/8⌉·8 columns. ``cat16`` itself when it
    is so (``wnn_neighbors`` builds it so), else a copy: the (n, D) view of
    a zeroed (n, ⌈D/8⌉·8) table. The columns past D lie outside every
    modality slice, so they change no score."""
    n, D = cat16.shape
    ld = -(-D // 8) * 8
    st = cat16.stride()
    if n == 0 or (st[1] == 1 and st[0] % 8 == 0 and st[0] >= ld
                  and cat16.data_ptr() % 16 == 0
                  and cat16.untyped_storage().nbytes()
                  >= 2 * (cat16.storage_offset() + (n - 1) * st[0] + ld)):
        return cat16
    out = padded_zeros(n, D, cat16.device)
    out[:] = cat16
    return out


def padded_zeros(n: int, D: int, device) -> torch.Tensor:
    """A zeroed (n, D) bf16 table in ``padded_table``'s layout: the (n, D)
    view of an (n, ⌈D/8⌉·8) table."""
    ld = max(8, -(-D // 8) * 8)
    return torch.zeros((n, ld), dtype=torch.bfloat16, device=device)[:, :D]


def wnn_fusion_scores(
    cand: torch.Tensor, cat16: torch.Tensor, aux: torch.Tensor, sigw: torch.Tensor,
    dims: Sequence[Tuple[int, int]], metric: str, row0: int = 0,
) -> torch.Tensor:
    """T11: the fused score (rows, C) float32 of every candidate ``cand``
    (rows, C) int32 (global ids, −1 absent, scoring 0) of the cells
    [row0, row0 + rows) of the tables (default: every row; a rank of a
    mesh passes its rows' window over the whole tables):
    Σ_m w_m · exp(−dist_m/max(σ_m, 1e-12)) · present_m(cell) ·
    present_m(cand) over the modality column slices ``dims`` of the bf16
    table ``cat16`` (n, ΣD; its rows may lie a padded stride apart, as
    ``padded_table`` makes them, else the kernel gathers from such a copy).
    ``aux`` (n, 2M) = [|x|²_m | present_m], ``sigw`` (n, 2M) = [σ_m | w_m].
    ``metric``: ``"cosine"`` scores 1 − cross on unit rows, anything else the
    euclidean distance."""
    if cand.device.type == "cpu":
        return wnn_fusion_scores_plain(cand, cat16, aux, sigw, dims, metric, row0)
    if cand.device.type != "cuda":
        raise ValueError(f"unsupported device {cand.device}")
    rows, C = cand.shape
    n = cat16.shape[0]
    _window(n, row0, rows, "T11")
    D = cat16.shape[1] if cat16.dim() == 2 else -1
    M = len(dims)
    dev = cand.device
    offs = _dims_offsets(dims, D)
    _check(cand, torch.int32, (rows, C), "cand", dev)
    if cat16.device != dev or cat16.dtype != torch.bfloat16 or cat16.stride(1) != 1:
        raise ValueError(f"cat16 must be a {torch.bfloat16} tensor of shape ({n}, {D}) with "
                         f"unit column stride on {dev}, got {cat16.dtype} "
                         f"{tuple(cat16.shape)} strides {cat16.stride()} on {cat16.device}")
    _check(aux, torch.float32, (n, 2 * M), "aux", dev)
    _check(sigw, torch.float32, (n, 2 * M), "sigw", dev)
    warp_bytes = _fusion_warp_bytes(D, M, FUSION_CHUNK)
    if M < 1 or n * max(C, D) > 2**31 - 1 or warp_bytes > MAX_SMEM:
        raise ValueError(f"T11 takes M >= 1, n*max(C, D) < 2^31 and a warp's shared memory "
                         f"within {MAX_SMEM} bytes; got n={n} C={C} D={D} M={M} "
                         f"({warp_bytes} bytes)")
    table = padded_table(cat16)
    warps = max(1, min(FUSION_WARPS, MAX_SMEM // warp_bytes))
    offs_t = torch.tensor(offs, dtype=torch.int32, device=dev)
    out = torch.empty((rows, C), dtype=torch.float32, device=dev)
    _kernels.launch(
        "wnn_fusion_scores", dev,
        cand.data_ptr(), table.data_ptr(), table.stride(0), aux.data_ptr(), sigw.data_ptr(),
        offs_t.data_ptr(), n, int(row0), rows, C, D, M, int(metric == "cosine"), warps,
        FUSION_CHUNK, out.data_ptr(),
    )
    return out


def wnn_fusion_scores_plain(
    cand: torch.Tensor, cat16: torch.Tensor, aux: torch.Tensor, sigw: torch.Tensor,
    dims: Sequence[Tuple[int, int]], metric: str, row0: int = 0,
) -> torch.Tensor:
    rows, C = cand.shape
    row0 = int(row0)
    _window(cat16.shape[0], row0, rows, "wnn_fusion_scores_plain")
    M = len(dims)
    out = torch.empty((rows, C), dtype=torch.float32, device=cand.device)
    block = max(1, (1 << 26) // max(1, C * cat16.shape[1]))
    for r0 in range(0, rows, block):
        r1 = min(r0 + block, rows)
        ok = cand[r0:r1] >= 0
        cs = torch.where(ok, cand[r0:r1], 0).long()
        cc = cat16[cs].float()
        q = cat16[row0 + r0:row0 + r1].float()
        aux_q, aux_c, sw = aux[row0 + r0:row0 + r1], aux[cs], sigw[row0 + r0:row0 + r1]
        total = torch.zeros((r1 - r0, C), dtype=torch.float32, device=cand.device)
        for m, (lo, hi) in enumerate(dims):
            cross = (q[:, None, lo:hi] * cc[:, :, lo:hi]).sum(dim=-1)
            if metric == "cosine":
                dist = 1.0 - cross
            else:
                d2 = (aux_q[:, m:m + 1] + aux_c[:, :, m]) - 2.0 * cross
                dist = _sqrt(torch.clamp(d2, min=0.0))
            pres = aux_c[:, :, M + m] * aux_q[:, M + m:M + m + 1]
            sig = torch.clamp(sw[:, m:m + 1], min=1e-12)
            contrib = torch.exp(-dist / sig) * sw[:, M + m:M + m + 1]
            total = total + torch.where(ok, contrib * pres, 0.0)
        out[r0:r1] = total
    return out


def cand_dedup(cand: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Per row: sort the candidate ids, drop repeats, and move the −1 slots
    to the end, keeping the sorted order of the rest (the reference's
    ``_cand_dedup_fn``). Returns the compacted (n, C) int32 matrix and the
    largest number of valid candidates in a row."""
    cs = torch.sort(cand, dim=1).values
    dup = torch.zeros_like(cs, dtype=torch.bool)
    dup[:, 1:] = (cs[:, 1:] == cs[:, :-1]) & (cs[:, 1:] >= 0)
    cs = torch.where(dup, -1, cs)
    order = torch.sort((cs < 0).to(torch.int8), dim=1, stable=True).indices
    compact = cs.gather(1, order)
    nvalid = int((compact >= 0).sum(dim=1).max().item()) if compact.numel() else 0
    return compact, nvalid


def final_topk(scores: torch.Tensor, cand: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest candidates per row by √(0.5·(1 − score)), absent
    candidates at +inf, ties to the lower position, as the reference's
    ``_final_topk_fn`` orders them on the CPU: there the square root of a
    negative is a negative NaN, which ``lax.top_k`` of the negated distance
    ranks before every number. So a score rounded above 1 (a cell whose
    reps equal the candidate's in every modality) comes first, with a NaN
    distance. Returns (ids (n, k) int32, distances (n, k) float32)."""
    dist = _sqrt(0.5 * (1.0 - scores))
    dist = torch.where(cand >= 0, dist, torch.inf)
    key = torch.where(torch.isnan(dist), -torch.inf, dist)
    pos = torch.arange(cand.shape[1], device=cand.device)
    top = torch.topk(_order_keys(key, pos), k, dim=1, largest=False, sorted=True).indices
    return cand.gather(1, top), dist.gather(1, top)


# ---------------------------------------------------------------------------
# wnn_neighbors
# ---------------------------------------------------------------------------


def wnn_neighbors(
    mdata,
    n_neighbors=None,
    n_bandwidth_neighbors: int = 20,
    n_multineighbors: int = 200,
    neighbor_keys=None,
    metric: str = "euclidean",
    low_memory=None,
    key_added=None,
    weight_key="mod_weight",
    add_weights_to_modalities: bool = False,
    eps: float = 1e-4,
    copy: bool = False,
    random_state=42,
    use_rep=None,
    n_pcs=None,
    mesh=None,
    device: DeviceLike = None,
):
    """Weighted-nearest-neighbors fusion of the modalities' kNN graphs
    (reference ``muon_tpu.ops.wnn.wnn_neighbors``). Needs
    ``uns["neighbors"]`` (or ``neighbor_keys[mod]``) in every modality.
    Writes ``obsp["distances"/"connectivities"]`` (n_neighbors + 1 fused
    neighbours per cell, columns sorted), ``uns[key_added]`` and the
    modality weights ``obs["{mod}:{weight_key}"]`` (or each modality's
    ``obs[weight_key]`` under ``add_weights_to_modalities``). ``low_memory``
    and ``use_rep``/``n_pcs`` are accepted and unused, as in the
    reference; the representations are the ones each modality's neighbors
    used.

    ``mesh`` (or ``set_options(mesh=...)``): a ``parallel.Mesh`` of more than
    one rank takes the reference's mesh branch, every rank with the same
    inputs and writing the same result: σ by ``parallel.sharded_wnn_bandwidth``
    (T9 on the rank's rows), θ by ``sharded_wnn_theta`` (T10), each euclidean
    modality's candidates by the exact ring kNN ``sharded_knn`` (T40; another
    metric takes the single-device kNN), the fusion and its top-k by
    ``sharded_wnn_scores`` (T11). σ, θ and the weights equal the
    single-device WNN's bit for bit; the fused graph does not row for row,
    since the single-device path takes T5's approximate candidates above
    20,000 rows, as the reference's does."""
    from .._core.config import resolve_mesh

    mesh, device = resolve_mesh(mesh, device)
    device = resolve_device(device)
    mdata = mdata.copy() if copy else mdata
    if neighbor_keys is None:
        modalities = list(mdata.mod.keys())
        neighbor_keys = {}
    else:
        modalities = list(neighbor_keys.keys())
    n_mods = len(modalities)

    # -- per-modality state ----------------------------------------------------
    neighbors_params, reps, mod_reps, mod_n_pcs = {}, {}, {}, {}
    mod_neighbors = []
    for mod in modalities:
        nkey = neighbor_keys.get(mod, "neighbors")
        if nkey not in mdata.mod[mod].uns:
            raise ValueError(
                f'Did not find .uns["{nkey}"] for modality "{mod}". '
                f"Run neighbors on all modalities first."
            )
        nparams = mdata.mod[mod].uns[nkey]
        rep_key = nparams["params"].get("use_rep", None)
        rep_pcs = nparams["params"].get("n_pcs", None)
        rep_key = None if rep_key == -1 else rep_key
        rep_pcs = None if rep_pcs == -1 else rep_pcs
        mod_neighbors.append(nparams["params"].get("n_neighbors", 0))
        neighbors_params[mod] = nparams
        reps[mod] = choose_representation(mdata.mod[mod], rep_key, rep_pcs, device=device)
        mod_reps[mod] = rep_key if rep_key is not None else -1
        mod_n_pcs[mod] = rep_pcs if rep_pcs is not None else -1

    n_global = mdata.n_obs
    if n_neighbors is None:
        valid = [k for k in mod_neighbors if k > 0]
        n_neighbors = int(round(float(np.mean(valid)), 0))

    # global ↔ local index maps (obsmap is 1-based, 0 = absent)
    g2l, present, l2g = {}, {}, {}
    for mod in modalities:
        m = np.asarray(mdata.obsmap[mod], dtype=np.int64)
        present[mod] = m > 0
        g = np.full(n_global, -1, dtype=np.int32)
        g[m > 0] = (m[m > 0] - 1).astype(np.int32)
        g2l[mod] = g
        loc2glob = np.full(_n_obs(mdata.mod[mod]), -1, dtype=np.int64)
        loc2glob[m[m > 0] - 1] = np.flatnonzero(m > 0)
        l2g[mod] = loc2glob

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # -- bandwidths σ and affinity ratios θ: reps and neighbour matrices stay
    # on the device from here to the candidate phase --------------------------
    rep_dev, NI_dev, nnd_dev, sig_dev = {}, {}, {}, {}

    def load_mod(mod):
        if mod in NI_dev:
            return
        with stage(f"wnn/upload[{mod}]"):
            # rebuilt from the CSR on every call, whoever made the graph (the
            # port, the JAX package, a file) and whatever edited it since
            NI, nnd = _neighbor_index_matrix(
                mdata.mod[mod].obsp[neighbors_params[mod]["distances_key"]].tocsr()
            )
            NI_dev[mod] = upload(NI.astype(np.int32, copy=False))
            nnd_dev[mod] = upload(nnd.astype(np.float32, copy=False))
            rep_dev[mod] = dense_to_tensor(reps[mod], device)

    ratios = np.full((n_global, n_mods), -np.inf, dtype=np.float64)
    for i1, mod1 in enumerate(modalities):
        load_mod(mod1)
        rep = reps[mod1]
        kk = NI_dev[mod1].shape[1]
        bbox = float(np.linalg.norm(np.ptp(rep, axis=0), ord=2))
        n_loc = rep.shape[0]
        n_bw = min(n_bandwidth_neighbors, max(kk, 1))
        with stage(f"wnn/bandwidth[{mod1}]"):
            if mesh is not None:
                from ..parallel.pipeline import sharded_wnn_bandwidth

                sig_dev[mod1] = sharded_wnn_bandwidth(NI_dev[mod1], rep_dev[mod1], mesh,
                                                      n_bw=n_bw, nn_stride=_auto_nn_stride(kk))
            else:
                sig_dev[mod1] = wnn_bandwidth(
                    NI_dev[mod1], *_bandwidth_tables(NI_dev[mod1], rep_dev[mod1]),
                    float(n_loc), bbox, n_bw, _auto_nn_stride(kk),
                )

        # thetas/currtheta are indexed by mod1-LOCAL row (an explicit rows1
        # scatter), so partially overlapping or permuted modalities stay
        # aligned
        thetas = np.full((n_loc, max(n_mods - 1, 1)), -np.inf)
        currtheta = np.full(n_loc, -np.inf)
        lasti = 0
        for i2, mod2 in enumerate(modalities):
            both = present[mod1] & present[mod2]
            rows1 = g2l[mod1][both]          # mod1-local
            rows2 = g2l[mod2][both]          # mod2-local
            load_mod(mod2)
            conv = g2l[mod1][l2g[mod2]].astype(np.int32)  # mod2-local → mod1-local
            with stage(f"wnn/theta[{mod1}|{mod2}]"):
                theta = wnn_theta
                if mesh is not None:
                    from ..parallel.pipeline import sharded_wnn_theta

                    def theta(*args):
                        return sharded_wnn_theta(*args, mesh)
                th = theta(
                    rep_dev[mod1], upload(rows1.astype(np.int32)),
                    upload(rows2.astype(np.int32)), NI_dev[mod2], upload(conv),
                    nnd_dev[mod1], sig_dev[mod1],
                ).cpu().numpy()
            if i1 == i2:
                currtheta[rows1] = th
            else:
                thetas[rows1, lasti] = th
                lasti += 1
        own_rows_global = np.flatnonzero(present[mod1])
        own_local = g2l[mod1][own_rows_global]
        if n_mods > 1:
            ratios[own_rows_global, i1] = currtheta[own_local] / (
                np.max(thetas[own_local], axis=1) + eps
            )
        else:
            ratios[own_rows_global, i1] = 0.0

    # softmax over modalities
    r = ratios - ratios.max(axis=1, keepdims=True)
    ew = np.exp(r)
    ew[~np.isfinite(ratios)] = 0.0
    weights = ew / np.maximum(ew.sum(axis=1, keepdims=True), 1e-30)

    # -- candidate graph: each modality's n_multineighbors nearest (T5, self
    # dropped), as global ids in the modality's column block ------------------
    m_per = n_multineighbors
    cand = torch.full((n_global, n_mods * m_per), -1, dtype=torch.int32, device=device)
    fusion_metric = metric if metric in ("euclidean", "cosine") else "euclidean"
    rep16_dev, sq_dev, l2g_dev = {}, {}, {}
    for i, mod in enumerate(modalities):
        with stage(f"wnn/candidates[{mod}]"):
            n_loc_m = reps[mod].shape[0]
            cmetric = neighbors_params[mod]["params"].get("metric", "euclidean")
            k_cand = min(m_per, n_loc_m - 1)
            rdev = rep_dev.pop(mod)
            # the fusion table's view of this rep, taken while it is resident
            if fusion_metric == "cosine":
                nrm = torch.linalg.norm(rdev, dim=1, keepdim=True)
                rep16_dev[mod] = (rdev / torch.where(nrm == 0, 1.0, nrm)).to(torch.bfloat16)
                sq_dev[mod] = torch.ones(n_loc_m, dtype=torch.float32, device=device)
            else:
                rep16_dev[mod] = rdev.to(torch.bfloat16)
                sq_dev[mod] = (rdev * rdev).sum(dim=1)
            if mesh is not None and cmetric in ("euclidean", "l2"):
                # over a mesh: the exact ring kNN, query rows sharded over cells
                from ..parallel.pipeline import sharded_knn

                _, idx = sharded_knn(reps[mod], mesh, k=k_cand)
            else:
                idx, _ = knn(rdev, k_cand, metric=cmetric, approx=n_loc_m > APPROX_ROWS,
                             device=device)
            del rdev
            NI_dev.pop(mod, None)
            idx = idx[:, 1:]  # drop self
            l2g_dev[mod] = upload(l2g[mod])
            glob = torch.where(idx >= 0, l2g_dev[mod][idx.clamp(min=0).long()], -1)
            cand[l2g_dev[mod], i * m_per:i * m_per + glob.shape[1]] = glob.to(torch.int32)
            del idx, glob

    # dedup + compaction per row. The reference pads rows to a multiple of
    # 131072 and buckets the kept width to a multiple of 64 to bound its
    # recompiles; neither changes a result (kfin ≤ maxc, and the extra
    # columns are −1, scored +inf and dropped), so the port keeps neither.
    with stage("wnn/dedup"):
        cand, nvalid = cand_dedup(cand)
        maxc = min(cand.shape[1], max(nvalid, n_neighbors + 1))
        cand = cand[:, :maxc].contiguous()
    kfin = min(n_neighbors + 1, maxc)

    # -- fusion: every modality scored in one kernel over a concatenated
    # bf16 table, assembled on the device -------------------------------------
    with stage("wnn/fusion"):
        dims, off = [], 0
        for mod in modalities:
            dims.append((off, off + reps[mod].shape[1]))
            off += reps[mod].shape[1]
        # rows padded to 16 bytes, so T11 gathers them whole (padded_table)
        cat16 = padded_zeros(n_global, off, device)
        aux = torch.zeros((n_global, 2 * n_mods), dtype=torch.float32, device=device)
        sigw = torch.zeros((n_global, 2 * n_mods), dtype=torch.float32, device=device)
        for i, mod in enumerate(modalities):
            rows_d = l2g_dev[mod]
            cat16[rows_d, dims[i][0]:dims[i][1]] = rep16_dev.pop(mod)
            aux[rows_d, i] = sq_dev.pop(mod)
            aux[rows_d, n_mods + i] = 1.0
            sigw[rows_d, i] = sig_dev[mod]
        sigw[:, n_mods:] = upload(weights.astype(np.float32))
        if mesh is not None:
            # candidate rows sharded over cells, the tables replicated: T11
            # and the top-k on each rank's rows
            from ..parallel.pipeline import sharded_wnn_scores

            idx_t, dist_t = sharded_wnn_scores(cand, cat16, aux, sigw, dims, mesh,
                                               metric=fusion_metric, k=kfin)
        else:
            scores = wnn_fusion_scores(cand, cat16, aux, sigw, dims, fusion_metric)
        del cat16

    # -- final kNN, connectivities and the distances CSR ------------------------
    with stage("wnn/finalize"):
        if mesh is None:
            idx_t, dist_t = final_topk(scores, cand, kfin)
        idx_f = idx_t.cpu().numpy()
        dist_f = dist_t.cpu().numpy().astype(np.float64)
        conn = compute_connectivities_umap(idx_f, dist_t, n_global, kfin)
        # rows arrive deduped, so the CSR is built directly: one column
        # argsort per row (invalid slots last) in place of scipy's global
        # COO sort; the columns are sorted, as the reference pins
        mask = np.isfinite(dist_f) & (idx_f >= 0)
        sort_key = np.where(mask, idx_f, np.iinfo(np.int32).max)
        ordc = np.argsort(sort_key, axis=1, kind="stable")
        idx_s = np.take_along_axis(idx_f, ordc, axis=1)
        dist_s = np.take_along_axis(dist_f, ordc, axis=1)
        mask_s = np.take_along_axis(mask, ordc, axis=1)
        if ((idx_s[:, 1:] == idx_s[:, :-1]) & mask_s[:, 1:] & mask_s[:, :-1]).any():
            raise AssertionError(
                "wnn finalize: duplicate candidate columns within a row — "
                "cand_dedup invariant violated upstream"
            )
        indptr = np.zeros(n_global + 1, np.int64)
        np.cumsum(mask_s.sum(axis=1), out=indptr[1:])
        flat_keep = mask_s.ravel()
        dmat = sp.csr_matrix(
            (
                dist_s.ravel()[flat_keep],
                idx_s.ravel()[flat_keep].astype(np.int32, copy=False),
                indptr,
            ),
            shape=(n_global, n_global),
        )

        # -- write back ------------------------------------------------------------
        for i, mod in enumerate(modalities):
            if weight_key:
                if add_weights_to_modalities:
                    mdata.mod[mod].obs[weight_key] = weights[present[mod], i]
                else:
                    mdata.obs[f"{mod}:{weight_key}"] = np.where(
                        present[mod], weights[:, i], np.nan
                    )

        if key_added is None:
            key_added, conns_key, dists_key = "neighbors", "connectivities", "distances"
        else:
            conns_key, dists_key = f"{key_added}_connectivities", f"{key_added}_distances"
        mdata.obsp[dists_key] = dmat
        mdata.obsp[conns_key] = conn
        mdata.uns[key_added] = {
            "connectivities_key": conns_key,
            "distances_key": dists_key,
            "params": {
                "n_neighbors": int(n_neighbors),
                "n_multineighbors": int(n_multineighbors),
                "metric": metric,
                "eps": eps,
                "random_state": random_state,
                "use_rep": mod_reps,
                "n_pcs": mod_n_pcs,
                "method": "umap",
            },
        }
        if hasattr(mdata, "update_obs"):
            mdata.update_obs()
    return mdata if copy else None
