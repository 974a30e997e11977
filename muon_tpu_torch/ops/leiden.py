"""Multiplex Leiden/Louvain community detection on the host (counterpart of
muon_tpu/ops/leiden.py).

It optimises the RB-configuration quality summed over layers, with
per-layer resolutions and weights and one partition shared across layers:
the objective of leidenalg's ``optimise_partition_multiplex``. Louvain-style
local moving and graph aggregation; ``refine=True`` adds the Leiden
refinement (communities split into well-connected subcommunities before
aggregation, Traag et al. 2019).

The local move, the symmetrisation and the aggregation run in the native
engine (``native/leiden.cpp``, the port's own copy of the JAX package's),
which is the main path: ``engine="native"``. Where the reference falls back
to Python without a word when the native library fails, the port raises.
The Python versions of the three steps stay as the plain versions the tests
hold the engine against; they run only under ``engine="python"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
from scipy import sparse as sp

from ..utils.profiling import stage

__all__ = ["multiplex_leiden", "leiden_labels", "multiplex_modularity"]


def multiplex_modularity(
    adjacencies, labels, resolutions=None, layer_weights=None
):
    """RB-configuration quality of a partition summed over layers, the
    objective ``multiplex_leiden`` optimises:

        Q = Σ_l w_l · Σ_c ( in_c / 2m_l − γ_l (tot_c / 2m_l)² )

    with in_c the intra-community weight (ordered pairs) and tot_c the
    community degree sum, each layer symmetrised and diagonal-dropped
    exactly as the optimiser sees it."""
    L = len(adjacencies)
    if resolutions is None:
        resolutions = [1.0] * L
    if layer_weights is None:
        layer_weights = [1.0] * L
    labels = np.asarray(labels)
    layers = [
        _Layer(sp.csr_matrix(A), float(g), float(w))
        for A, g, w in zip(adjacencies, resolutions, layer_weights)
    ]
    return _quality(layers, labels)


class _Layer:
    def __init__(
        self,
        A: sp.csr_matrix,
        resolution: float,
        weight: float,
        drop_selfloops: bool = True,
        assume_symmetric: bool = False,
        engine: str = "native",
    ):
        A = A.tocsr()
        if A.dtype != np.float64:
            A = A.astype(np.float64)
        if assume_symmetric and drop_selfloops:
            # a symmetric graph with an empty diagonal (kNN/fuzzy-union
            # connectivities) needs no preparation pass at all
            if A.diagonal().any():
                assume_symmetric = False  # fall through to the full pass
            else:
                drop_selfloops = False
        if not assume_symmetric or drop_selfloops:
            # (A+Aᵀ)/2 with the diagonal dropped, in one pass. Diagonal
            # dropping applies only to input graphs; aggregated levels keep
            # their self-loops, which hold the intra-community weight (the
            # local-move scans skip j == i).
            A = _ENGINES[engine].symmetrize(A, drop_selfloops, assume_symmetric)
        self.indptr = A.indptr
        self.indices = A.indices
        self.data = A.data
        self.deg = np.asarray(A.sum(axis=1)).ravel()
        self.two_m = max(self.deg.sum(), 1e-12)
        self.gamma = resolution
        self.w = weight
        self.A = A
        self.engine = engine


def _flat_arrays(layers):
    """Concatenated CSR payloads for the native engine, built once per
    level and cached on the first layer."""
    key = tuple(id(L_) for L_ in layers)
    cached = getattr(layers[0], "_flat", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    if len(layers) > 16:
        raise ValueError("at most 16 layers supported by the native engine")
    indptr_all = np.concatenate(
        [L_.indptr.astype(np.int64, copy=False) for L_ in layers]
    )
    indices_all = np.concatenate(
        [L_.indices.astype(np.int32, copy=False) for L_ in layers]
    )
    data_all = np.concatenate(
        [L_.data.astype(np.float64, copy=False) for L_ in layers]
    )
    sizes = np.asarray([len(L_.indices) for L_ in layers], np.int64)
    payload_off = np.concatenate(
        [[0], np.cumsum(sizes)[:-1]]
    ).astype(np.int64)
    deg_all = np.concatenate(
        [L_.deg.astype(np.float64, copy=False) for L_ in layers]
    )
    two_m = np.asarray([L_.two_m for L_ in layers], np.float64)
    gamma = np.asarray([L_.gamma for L_ in layers], np.float64)
    lw = np.asarray([L_.w for L_ in layers], np.float64)
    flat = (indptr_all, indices_all, data_all, payload_off, deg_all,
            two_m, gamma, lw)
    layers[0]._flat = (key, flat)
    return flat


def _ptr(a, t):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(t))


def _local_move_native(layers, labels, rng, max_passes=20, restrict=None,
                       randomized=False, theta_frac=0.5):
    """Sequential local moving in the native engine. Returns
    ``(n_moves, total_applied_gain)``."""
    import ctypes as C

    from ..native import load_leiden_lib

    lib = load_leiden_lib()
    n = len(labels)
    L = len(layers)
    (indptr_all, indices_all, data_all, payload_off, deg_all, two_m,
     gamma, lw) = _flat_arrays(layers)
    labels64 = np.ascontiguousarray(labels, dtype=np.int64)
    if restrict is not None:
        restrict64 = np.ascontiguousarray(restrict, dtype=np.int64)
        rptr = _ptr(restrict64, C.c_int64)
    else:
        rptr = C.POINTER(C.c_int64)()

    gain = C.c_double(0.0)
    moved = lib.multiplex_local_move(
        n, L,
        _ptr(indptr_all, C.c_int64), _ptr(indices_all, C.c_int32),
        _ptr(data_all, C.c_double), _ptr(payload_off, C.c_int64),
        _ptr(deg_all, C.c_double), _ptr(two_m, C.c_double),
        _ptr(gamma, C.c_double), _ptr(lw, C.c_double),
        _ptr(labels64, C.c_int64), rptr,
        int(max_passes), int(rng.integers(0, 2**63 - 1)),
        int(bool(randomized)), float(theta_frac), C.byref(gain),
    )
    labels[:] = labels64
    return int(moved), float(gain.value)


def _local_move_py(layers, labels, rng, max_passes=20, restrict=None,
                   randomized=False, theta_frac=0.5):
    """Sequential local moving in Python (the plain version). If `restrict`
    is given (array of labels), nodes may only join communities within the
    same restricted group (Leiden refinement). ``randomized`` is the Traag
    et al. 2019 merge procedure: one pass, only currently-singleton nodes
    move, and the target among positive-gain candidates (and "stay") is
    sampled ∝ exp(gain/θ) with θ = theta_frac · max_gain."""
    n = len(labels)
    # community totals per layer and node counts
    tots = [np.zeros(n + 1) for _ in layers]
    for li, L in enumerate(layers):
        np.add.at(tots[li], labels, L.deg)
    comm_count = np.zeros(n + 1, dtype=np.int64)
    np.add.at(comm_count, labels, 1)
    free_ids = list(np.flatnonzero(comm_count == 0)[::-1])

    total_moved, total_gain = 0, 0.0
    for _ in range(1 if randomized else max_passes):
        moved = 0
        order = rng.permutation(n)
        for i in order:
            ci = labels[i]
            if randomized and comm_count[ci] != 1:
                continue  # already merged
            # accumulate k_{i→comm} for each layer
            comm_w = {}
            for li, L in enumerate(layers):
                sl = slice(L.indptr[i], L.indptr[i + 1])
                for j, w_ in zip(L.indices[sl], L.data[sl]):
                    if j == i:  # self-loop moves with the node; not a link
                        continue
                    if restrict is not None and restrict[j] != restrict[i]:
                        continue
                    key = labels[j]
                    if key not in comm_w:
                        comm_w[key] = np.zeros(len(layers))
                    comm_w[key][li] += w_
            base = comm_w.get(ci, np.zeros(len(layers)))
            # gain of leaving ci then joining d; the per-layer factor is the
            # exact ΔQ_l scale w_l·2/2m_l
            best_comm, best_gain = ci, 0.0
            cand = {}
            for d, kw in comm_w.items():
                if d == ci:
                    continue
                gain = 0.0
                for li, L in enumerate(layers):
                    ki = L.deg[i]
                    tot_d = tots[li][d]
                    tot_c = tots[li][ci] - ki
                    gain += L.w * (2.0 / L.two_m) * (
                        (kw[li] - base[li])
                        - L.gamma * ki * (tot_d - tot_c) / L.two_m
                    )
                cand[d] = gain
                if gain > best_gain + 1e-12:
                    best_gain = gain
                    best_comm = d
            to_empty = False
            if not randomized and comm_count[ci] > 1 and free_ids:
                # split-off candidate: i alone in a fresh community
                gain = 0.0
                for li, L in enumerate(layers):
                    ki = L.deg[i]
                    tot_c = tots[li][ci] - ki
                    gain += L.w * (2.0 / L.two_m) * (
                        -base[li] + L.gamma * ki * tot_c / L.two_m
                    )
                if gain > best_gain + 1e-12:
                    best_gain = gain
                    best_comm = free_ids[-1]
                    to_empty = True
            applied_gain = best_gain
            if randomized and best_gain > 0.0:
                theta = theta_frac * best_gain + 1e-300
                ds = [d for d, g in cand.items() if g > 0.0]
                ws = np.array(
                    [np.exp((cand[d] - best_gain) / theta) for d in ds]
                )
                stay = np.exp(-best_gain / theta)
                r = rng.random() * (stay + ws.sum()) - stay
                best_comm = ci
                if r >= 0.0:
                    c = np.cumsum(ws)
                    k = int(np.searchsorted(c, r, side="right"))
                    if k < len(ds):
                        best_comm = ds[k]
                        applied_gain = cand[best_comm]
            if best_comm != ci:
                if to_empty:
                    free_ids.pop()
                for li, L in enumerate(layers):
                    tots[li][ci] -= L.deg[i]
                    tots[li][best_comm] += L.deg[i]
                comm_count[ci] -= 1
                comm_count[best_comm] += 1
                if comm_count[ci] == 0:
                    free_ids.append(ci)
                labels[i] = best_comm
                moved += 1
                total_moved += 1
                total_gain += applied_gain
        if moved == 0:
            break
    return total_moved, total_gain


def _refine(layers, labels, rng):
    """Leiden refinement (Traag et al. 2019): within each community,
    rebuild from singletons by randomised merging restricted to the
    community."""
    refined = np.arange(len(labels))
    _ENGINES[layers[0].engine].local_move(
        layers, refined, rng, restrict=labels, randomized=True
    )
    # relabel contiguous
    _, refined = np.unique(refined, return_inverse=True)
    return refined


def _read_agg_handle(lib, h, n_rows, shape):
    """Copy a native AggResult handle out into a scipy CSR and free it."""
    try:
        nnz = lib.agg_nnz(h)
        out_indptr = np.ctypeslib.as_array(
            lib.agg_indptr(h), shape=(int(n_rows) + 1,)
        ).copy()
        if nnz:
            out_indices = np.ctypeslib.as_array(
                lib.agg_indices(h), shape=(nnz,)
            ).copy()
            out_data = np.ctypeslib.as_array(
                lib.agg_data(h), shape=(nnz,)
            ).copy()
        else:
            out_indices = np.empty(0, np.int32)
            out_data = np.empty(0, np.float64)
    finally:
        lib.agg_free(h)
    return sp.csr_matrix((out_data, out_indices, out_indptr), shape=shape)


def _symmetrize_native(A, drop_selfloops, assume_symmetric):
    """(A+Aᵀ)/2 with optional diagonal drop, one C++ counting-sort pass.
    Mirroring an already-symmetric matrix reproduces it exactly, so the
    same kernel covers every flag combination."""
    import ctypes as C

    from ..native import load_leiden_lib

    lib = load_leiden_lib()
    n = A.shape[0]
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    h = lib.csr_symmetrize(
        n, _ptr(indptr, C.c_int64), _ptr(indices, C.c_int32),
        _ptr(data, C.c_double), int(bool(drop_selfloops)),
    )
    return _read_agg_handle(lib, h, n, A.shape)


def _symmetrize_py(A, drop_selfloops, assume_symmetric):
    """The plain version of ``_symmetrize_native`` through a scipy COO."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    cols = A.indices.astype(np.int64, copy=False)
    if drop_selfloops:
        keep = rows != cols
        rows, cols, data = rows[keep], cols[keep], A.data[keep]
    else:
        data = A.data
    if not assume_symmetric:
        return sp.csr_matrix(
            (
                np.concatenate([data, data]) * 0.5,
                (np.concatenate([rows, cols]), np.concatenate([cols, rows])),
            ),
            shape=A.shape,
        )
    return sp.csr_matrix((data, (rows, cols)), shape=A.shape)


def _aggregate_native(L, labels, n_comm):
    """One-pass C++ counting-sort aggregation of a layer onto a partition."""
    import ctypes as C

    from ..native import load_leiden_lib

    lib = load_leiden_lib()
    n = len(labels)
    indptr = np.ascontiguousarray(L.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(L.indices, dtype=np.int32)
    data = np.ascontiguousarray(L.data, dtype=np.float64)
    labels64 = np.ascontiguousarray(labels, dtype=np.int64)
    h = lib.csr_aggregate(
        n, int(n_comm),
        _ptr(indptr, C.c_int64), _ptr(indices, C.c_int32), _ptr(data, C.c_double),
        _ptr(labels64, C.c_int64),
    )
    return _read_agg_handle(lib, h, n_comm, (n_comm, n_comm))


def _aggregate_py(L, labels, n_comm):
    """The plain version of ``_aggregate_native``: a scipy COO relabel."""
    rows = np.repeat(np.arange(len(labels)), np.diff(L.indptr))
    return sp.csr_matrix(
        (L.data, (labels[rows], labels[L.indices])), shape=(n_comm, n_comm)
    )


class _Engine(NamedTuple):
    local_move: Callable
    symmetrize: Callable
    aggregate: Callable


_ENGINES = {
    "native": _Engine(_local_move_native, _symmetrize_native, _aggregate_native),
    "python": _Engine(_local_move_py, _symmetrize_py, _aggregate_py),
}


def _aggregate(layers, labels):
    """Collapse each layer onto the partition's supernodes."""
    n_comm = int(labels.max()) + 1
    new_layers = []
    for L in layers:
        A2 = _ENGINES[L.engine].aggregate(L, labels, n_comm)
        # aggregating a symmetric layer preserves symmetry: skip (A+Aᵀ)/2
        new_layers.append(
            _Layer(A2, L.gamma, L.w, drop_selfloops=False,
                   assume_symmetric=True, engine=L.engine)
        )
    return new_layers


def _leiden_once(layers0, rng, init_labels, refine, max_levels):
    """One full move→refine→aggregate descent from ``init_labels``,
    returning fine-level labels."""
    n = len(init_labels)
    layers = layers0
    labels = init_labels.copy()
    mapping = np.arange(n)  # original node -> current supernode
    local_move = _ENGINES[layers0[0].engine].local_move

    quiet = 0
    gain0 = None  # descent's own gain scale (level-0 improvement)
    for _level in range(max_levels):
        with stage(f"leiden/move[L{_level}]"):
            moved, gain = local_move(layers, labels, rng)
        improved = moved > 0
        # compact labels
        _, labels = np.unique(labels, return_inverse=True)
        # break only after two consecutive quiet levels (the coarse-level
        # move over refined subcommunities is the escape from local
        # optima), or at the trivial fixed point of all singletons
        quiet = 0 if improved else quiet + 1
        if not improved and (
            quiet >= 2 or labels.max() + 1 == len(labels)
        ):
            break
        # diminishing returns: stop once a level's applied gain is below
        # 1e-4 of level 0's
        if gain0 is None:
            gain0 = gain
        elif improved and gain0 > 0.0 and gain < 1e-4 * gain0:
            break
        if refine:
            with stage(f"leiden/refine[L{_level}]"):
                refined = _refine(layers, labels, rng)
            # aggregate on the refined partition; communities of `labels`
            # become groups of refined supernodes
            coarse_of_refined = np.zeros(refined.max() + 1, dtype=np.int64)
            coarse_of_refined[refined] = labels
            with stage(f"leiden/agg[L{_level}]"):
                layers = _aggregate(layers, refined)
            mapping = refined[mapping]
            labels = coarse_of_refined
        else:
            layers = _aggregate(layers, labels)
            mapping = labels[mapping]
            labels = np.arange(labels.max() + 1)
    return labels[mapping]


def _quality(layers, labels):
    """RB quality of a partition against already-prepared layers: the total
    intra-community weight and Σ_c tot_c², one O(nnz) mask per layer."""
    n_comm = int(labels.max()) + 1
    q = 0.0
    for lay in layers:
        rows = np.repeat(
            np.arange(len(labels)), np.diff(lay.indptr)
        )
        intra = float(lay.data[labels[rows] == labels[lay.indices]].sum())
        tot = np.bincount(labels, weights=lay.deg, minlength=n_comm)
        q += lay.w * (
            intra / lay.two_m
            - lay.gamma * float(((tot / lay.two_m) ** 2).sum())
        )
    return q


def _sampled_symmetry_check(A: sp.csr_matrix, n_samples: int = 1024,
                            seed: int = 0) -> bool:
    """Probe whether A is symmetric by checking ``n_samples`` random stored
    entries against their transposed positions (binary search in the
    partner row); a mismatch sends the layer through the full pass."""
    nnz = A.nnz
    if nnz == 0:
        return True
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, nnz, min(n_samples, nnz))
    rows = np.searchsorted(A.indptr, pos, side="right") - 1
    cols = A.indices[pos]
    vals = A.data[pos]
    for i, j, v in zip(rows, cols, vals):
        lo, hi = A.indptr[j], A.indptr[j + 1]
        kk = np.searchsorted(A.indices[lo:hi], i)
        if kk >= hi - lo or A.indices[lo + kk] != i:
            return False
        if abs(A.data[lo + kk] - v) > 1e-6 * max(abs(v), 1e-30):
            return False
    return True


def multiplex_leiden(
    adjacencies,
    resolutions=None,
    layer_weights=None,
    seed: int = 0,
    refine: bool = True,
    max_levels: int = 10,
    n_iterations=None,
    assume_symmetric=None,
    engine: str = "native",
):
    """Cluster one shared partition over multiple graph layers.

    Runs ``n_iterations`` full descents, feeding the achieved partition
    back as the next start (leidenalg's ``n_iterations`` semantics).
    ``n_iterations=-1`` runs until the objective has not improved for 3
    consecutive descents (capped at 100); ``None`` picks 2 descents up to
    200k nodes and 1 above.

    ``engine``: ``"native"`` (the C++ engine, the main path) or
    ``"python"`` (the plain versions, for tests and small graphs).

    Returns integer labels (n,) relabelled by decreasing community size."""
    if engine not in _ENGINES:
        raise ValueError(f"engine must be 'native' or 'python', got {engine!r}")
    L = len(adjacencies)
    n = adjacencies[0].shape[0]
    if resolutions is None:
        resolutions = [1.0] * L
    if layer_weights is None:
        layer_weights = [1.0] * L

    rng = np.random.default_rng(seed)
    with stage("leiden/layer_prep"):
        layers0 = []
        for i in range(L):
            A = sp.csr_matrix(adjacencies[i])
            sym = (
                _sampled_symmetry_check(A, seed=seed)
                if assume_symmetric is None
                else bool(assume_symmetric)
            )
            layers0.append(
                _Layer(
                    A, float(resolutions[i]), float(layer_weights[i]),
                    assume_symmetric=sym, engine=engine,
                )
            )
    if n_iterations is None:
        n_iterations = 2 if n <= 200_000 else 1
    to_convergence = n_iterations < 0
    iters = 100 if to_convergence else max(1, int(n_iterations))
    best, best_q = None, -np.inf
    labels = np.arange(n)
    stall = 0
    for it in range(iters):
        if it > 0 and it % 3 == 0:
            # periodic fresh restart from singletons
            labels = np.arange(n)
        with stage(f"leiden/descent{it}"):
            labels = _leiden_once(layers0, rng, labels, refine, max_levels)
        with stage(f"leiden/quality{it}"):
            q = _quality(layers0, labels)
        # keep the best partition; refinement is stochastic, so a flat
        # descent does not stop the run (-1 stops after 3 flat descents)
        if q > best_q:
            best, best_q = labels, q
            stall = 0
        else:
            labels = best
            stall += 1
            if to_convergence and stall >= 3:
                break

    final = best
    # order communities by size, descending
    vals, counts = np.unique(final, return_counts=True)
    order = vals[np.argsort(-counts)]
    remap = {v: i for i, v in enumerate(order)}
    return np.asarray([remap[v] for v in final], dtype=np.int64)


def leiden_labels(adjacency, resolution=1.0, seed=0, refine=True,
                  engine: str = "native"):
    return multiplex_leiden([adjacency], [resolution], [1.0], seed=seed,
                            refine=refine, engine=engine)
