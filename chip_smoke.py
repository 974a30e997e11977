"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA device, nvcc

Three paths of the user journey (README.md, bench_e2e.py), through
``muon_tpu_torch``, at full width:

* ATAC: ``atac.pp.tfidf`` → ``atac.tl.lsi(n_comps=50)`` →
  ``pp.neighbors(n_neighbors=20, use_rep="X_lsi")`` on synthetic ATAC
  counts, 100,000 cells × 25,000 peaks, 250 draws per cell with Pareto(1.2)
  peak popularity (the recipe of ``bench.py::make_counts``, seed 0);
* RNA: library-size normalisation (row sums, 1e4 / max(rs, 1), row scaling,
  log1p) → ``pp.pca(n_comps=50)`` → ``pp.neighbors(n_neighbors=20,
  use_rep="X_pca")`` on the clustered RNA counts of ``bench_e2e.py::synth``
  at its scale-10 size: 100,000 cells × 20,000 genes, 100 draws per cell,
  20 planted clusters, seed 0 (labels drawn first, as there);
* WNN: the ATAC modality of the same ``synth`` (drawn next from the same
  generator: 100,000 × 25,000, 150 draws per cell, the same labels) through
  ``atac.pp.tfidf`` → ``atac.tl.lsi(n_comps=50)`` →
  ``pp.neighbors(n_neighbors=20, use_rep="X_lsi")``, then
  ``pp.neighbors(mdata)`` over {rna, atac} with the default parameters
  (n_multineighbors 200, n_bandwidth_neighbors 20).

Phases, one line each or more. A failed check is printed as ``[check
failed]`` and recorded, and the run goes on, so that one run reads every
number; at the end any recorded failure makes the exit code 1 and no result
is printed. An exception stops the run at once, with a code other than 0:

1. device: the card, the torch/CUDA/nvcc versions, which optional modules import;
2. build: compile the CUDA kernels from ``muon_tpu_torch/csrc``;
3. kernels: T1-T4 against their plain PyTorch versions at the ATAC path's
   shapes, with their tolerances, and both times (median of 5, CUDA events);
4. ATAC path, with the launch counters reset just before and read just
   after, then the gather rSVD on the same matrix with its own counts;
   checks of shapes, finiteness, z-scoring, the TF-IDF values against
   scipy, the singular values against the plain-PyTorch path with the same
   Ω, and the neighbour graph;
5. RNA path, counted the same way: the PCA branch, the graph, the planted
   labels among the neighbours, and σ and the connectivities against the
   plain-PyTorch path from the same representation;
6. kernels: T7/T8 on the RNA counts, T5 on the RNA scores (float32 and
   approx, euclidean and cosine, k+1 = 20 and 201) with the approx recall
   against float32, and T6 on T5's output, against their plain versions;
7. WNN path, counted from ``pp.neighbors(mdata)`` alone: the launches of
   T5, T6 and T9-T11, the fused graph and the modality weights; σ, θ, the
   weights and the graph against the plain-PyTorch WNN from the same
   per-modality graphs; the planted labels among the fused neighbours;
8. kernels: T9-T11 against their plain versions on the arguments the WNN
   path gave them;
9. times: the warm wall of each path with its stage split, each path's
   device busy share under the profiler, and the plain-PyTorch paths once.

The last three lines are a JSON object of the kernels (``launches`` adds
up the three main paths' counts, each read from its own run with the
counters set to 0 just before it, and ``launches_by_path`` gives each;
``gather_launches`` counts the gather rSVD side run, which is no part of
``launches``), the card's name and power limit as ``nvidia-smi`` gives
them, and ``{"ok": true, "device": ...}``. Without a CUDA device it prints
no result and exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch
from scipy import sparse as sp

N_CELLS, N_PEAKS, NNZ_PER_CELL = 100_000, 25_000, 250
N_GENES, NNZ_PER_RNA_CELL, N_CLUSTERS = 20_000, 100, 20
NNZ_PER_ATAC_CELL = 150  # bench_e2e.py's ATAC modality, N_PEAKS wide
N_MULTI = 200  # WNN's n_multineighbors (its default)
K, N_ITER, SEED = 50, 7, 0
L = K + 10
N_NEIGHBORS = 20
SPARSE_SRC = "muon_tpu_torch/csrc/sparse_kernels.cu"
KNN_SRC = "muon_tpu_torch/csrc/knn_kernels.cu"
WNN_SRC = "muon_tpu_torch/csrc/wnn_kernels.cu"
# kernel -> (source, the TPU program it replaces)
KERNEL_INFO = {
    "tfidf_values": (SPARSE_SRC, "muon_tpu/ops/sparse.py:790"),     # _tfidf_fn
    "csr_spmm_f32": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),     # _spmm_fn
    "csr_spmm_bf16": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),
    "csr_spmm_t_f32": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),   # transpose=True
    "csr_spmm_t_bf16": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),
    "csr_gram_matmul": (SPARSE_SRC, "muon_tpu/ops/linalg.py:109"),  # _rsvd_blocks_fn
    "csr_row_sums": (SPARSE_SRC, "muon_tpu/ops/sparse.py:546"),     # _row_sums_fn
    "csr_scale_rows": (SPARSE_SRC, "muon_tpu/ops/sparse.py:830"),   # _scale_rows_fn
    "knn_topk": (KNN_SRC, "muon_tpu/ops/knn.py:58"),                # _knn_fn + _topk2
    "smooth_knn_membership": (KNN_SRC, "muon_tpu/ops/fuzzy.py:32"),  # + _membership_fn
    "wnn_bandwidth": (WNN_SRC, "muon_tpu/ops/wnn.py:339"),          # _bandwidth_fn
    "wnn_theta": (WNN_SRC, "muon_tpu/ops/wnn.py:394"),              # _theta_fn
    "wnn_fusion_scores": (WNN_SRC, "muon_tpu/ops/wnn.py:470"),      # _fusion_all_fn
}
# what each path launches: the ATAC path (auto takes the XtX path for lsi,
# neighbors the approx kNN), the RNA path, and the gather rSVD side run
ATAC_PATH = ("tfidf_values", "csr_spmm_f32", "csr_gram_matmul", "knn_topk",
             "smooth_knn_membership")
RNA_PATH = ("csr_row_sums", "csr_scale_rows", "csr_gram_matmul", "csr_spmm_f32",
            "knn_topk", "smooth_knn_membership")
GATHER_PATH = ("csr_spmm_bf16", "csr_spmm_t_bf16", "csr_spmm_t_f32")
# WNN of {rna, atac}: T9 per modality, T10 per ordered pair, T11 once, T5 per
# modality for the 200-wide candidate pool, T6 once for the fused graph
WNN_PATH = {"wnn_bandwidth": 2, "wnn_theta": 4, "wnn_fusion_scores": 1, "knn_topk": 2,
            "smooth_knn_membership": 1}


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


class MuHolder:
    """The least MuData-like object WNN takes: modalities over the same
    cells, in the same order (obsmap is 1-based)."""

    def __init__(self, mods):
        self.mod, self.n_obs = mods, N_CELLS
        self.obsmap = {k: np.arange(1, N_CELLS + 1) for k in mods}
        self.obs, self.obsp, self.uns = {}, {}, {}


def make_counts(seed: int = 0) -> sp.csr_matrix:
    """Synthetic ATAC counts, the recipe of bench.py::make_counts."""
    rng = np.random.default_rng(seed)
    nnz = N_CELLS * NNZ_PER_CELL
    pop = rng.pareto(1.2, N_PEAKS) + 1.0
    pop /= pop.sum()
    cols = rng.choice(N_PEAKS, size=nnz, p=pop).astype(np.int32)
    rows = np.repeat(np.arange(N_CELLS, dtype=np.int32), NNZ_PER_CELL)
    data = rng.integers(1, 5, size=nnz).astype(np.float32)
    X = sp.coo_matrix((data, (rows, cols)), shape=(N_CELLS, N_PEAKS))
    X.sum_duplicates()
    return X.tocsr()


def make_e2e_counts(seed: int = 0):
    """Clustered RNA and ATAC counts and their planted labels, the recipe of
    bench_e2e.py::synth (its first two modalities) at 100,000 cells: labels
    first, then per modality, from the same generator, per-cluster tilted
    Pareto(1.2) feature popularity."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLUSTERS, N_CELLS)
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=N_CLUSTERS)

    def counts(d, nnz_per):
        pop = rng.pareto(1.2, d) + 1.0
        boost = np.ones((N_CLUSTERS, d))
        for c in range(N_CLUSTERS):
            boost[c, rng.choice(d, size=d // 20, replace=False)] = 8.0
        nnz = N_CELLS * nnz_per
        cols = np.empty(nnz, np.int32)
        start = 0
        for c in range(N_CLUSTERS):
            m = sizes[c] * nnz_per
            p = pop * boost[c]
            p /= p.sum()
            cols[start:start + m] = rng.choice(d, size=m, p=p)
            start += m
        rows = np.repeat(order, nnz_per).astype(np.int32)
        data = rng.integers(1, 5, size=nnz).astype(np.float32)
        X = sp.coo_matrix((data, (rows, cols)), shape=(N_CELLS, d))
        X.sum_duplicates()
        return X.tocsr()

    rna = counts(N_GENES, NNZ_PER_RNA_CELL)
    return rna, counts(N_PEAKS, NNZ_PER_ATAC_CELL), labels


FAILED = []


def check(ok, what: str) -> None:
    """Record a failed check; the run goes on so that one run reads every
    number, and exits non-zero at its end."""
    if not ok:
        FAILED.append(what)
        print(f"[check failed] {what}", flush=True)


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def importable(name: str) -> bool:
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def phase_device(kernels) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    nvcc = subprocess.run(
        [kernels._nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc='{nvcc}' | "
          + " ".join(f"{m}={importable(m)}" for m in ("triton", "pandas", "h5py")),
          flush=True)
    return smi


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines() if "registers" in ln]
    print(f"[build] {time.perf_counter() - t0:.1f}s {so.name} | " + "; ".join(regs),
          flush=True)


def phase_kernels(dsp, dX, cuda) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    results = {}

    def record(name, err, tol_ok, tol, k_fn, p_fn):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        print(f"[kernel] {name}: max_abs_err={err:.3e} ({tol}) "
              f"ms={ms:.3f} plain_ms={plain_ms:.3f}", flush=True)
        check(tol_ok, f"{name} within {tol}")

    out = dsp.tfidf_data(dX)
    torch.cuda.synchronize()
    ref = dsp.tfidf_data_plain(dX)
    diff = (out - ref).abs()
    record("tfidf_values", diff.max().item(),
           bool((diff <= 1e-6 + 1e-5 * ref.abs()).all()), "rtol 1e-5 atol 1e-6",
           lambda: dsp.tfidf_data(dX), lambda: dsp.tfidf_data_plain(dX))

    dT = dX._replace(data=out)  # the TF-IDF matrix the products see on the path
    dA = dT._replace(data=out.abs())
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        V = torch.randn((N_PEAKS, L), generator=gen, device=cuda).to(dtype)
        out = dsp.spmm(dT, V)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_plain(dT, V)).abs()
        bound = 1e-5 * dsp.spmm_plain(dA, V.float().abs())
        record(f"csr_spmm_{tag}", diff.max().item(), bool((diff <= bound).all()),
               "1e-5 x |X|.|B|", lambda: dsp.spmm(dT, V), lambda: dsp.spmm_plain(dT, V))

        Y = torch.randn((N_CELLS, L), generator=gen, device=cuda).to(dtype)
        out = dsp.spmm_t(dT, Y)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_t_plain(dT, Y)).abs()
        bound = 1e-5 * dsp.spmm_t_plain(dA, Y.float().abs())
        record(f"csr_spmm_t_{tag}", diff.max().item(), bool((diff <= bound).all()),
               "1e-5 x |X|^T.|B|", lambda: dsp.spmm_t(dT, Y),
               lambda: dsp.spmm_t_plain(dT, Y))

    V = torch.randn((N_PEAKS, L), generator=gen, device=cuda)
    out = dsp.gram_matmul(dT, V)
    torch.cuda.synchronize()
    ref = dsp.gram_matmul_plain(dT, V)
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    # 1e-4: dropping the bf16 rounding of z or of x_ij reads about 1e-3
    record("csr_gram_matmul", (out - ref).abs().max().item(), rel <= 1e-4,
           f"relative Frobenius {rel:.2e} <= 1e-4",
           lambda: dsp.gram_matmul(dT, V), lambda: dsp.gram_matmul_plain(dT, V))
    return results


def tfidf_reference(X: sp.csr_matrix) -> np.ndarray:
    """scipy/numpy float64 TF-IDF of the values (log TF x1e4, log IDF)."""
    X64 = X.astype(np.float64)
    rs = np.asarray(X64.sum(axis=1)).ravel()
    cs = np.asarray(X64.sum(axis=0)).ravel()
    row = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
    tf = np.log1p(X64.data / rs[row] * 1e4)
    return tf * np.log1p(X.shape[0] / cs[X.indices])


def check_graph(h, labels=None) -> float:
    """Checks of a neighbors result; returns the share of neighbours that
    carry the cell's own planted label (nan without labels)."""
    D, C = h.obsp["distances"], h.obsp["connectivities"]
    n = D.shape[0]
    rows = np.repeat(np.arange(n), np.diff(D.indptr))
    check((np.diff(D.indptr) == N_NEIGHBORS - 1).all(), "19 distances per row")
    check(not (D.indices == rows).any(), "self not among the neighbours")
    check(np.isfinite(D.data).all() and (D.data >= 0).all(), "distances finite, >= 0")
    check((C != C.T).nnz == 0, "connectivities symmetric")
    check(C.data.min() > 0 and C.data.max() <= 1, "connectivities in (0, 1]")
    check(h.uns["neighbors"]["params"]["n_neighbors"] == N_NEIGHBORS, "uns params")
    if labels is None:
        return float("nan")
    return float((labels[rows] == labels[D.indices]).mean())


def phase_atac_path(tac, tpp, dsp, tla, kernels, X, cuda):
    h = Holder(X.copy())
    kernels.reset_launch_counts()
    tac.pp.tfidf(h, device=cuda)
    tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_lsi", device=cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # the side run: the gather rSVD, which lsi takes below 2M nonzeros, on
    # the same matrix; its launches are counted apart from the path's
    kernels.reset_launch_counts()
    _, s_gather, _ = tla.randomized_svd(h.X, k=K, n_iter=N_ITER, seed=SEED,
                                        method="gather", device=cuda)
    torch.cuda.synchronize()
    gather_launches = kernels.launch_counts()
    print(f"[atac] container=Holder launches by tfidf+lsi+neighbors {launches}; "
          f"by the gather rSVD {gather_launches}", flush=True)
    check(tla._blocks_profitable(N_CELLS, N_PEAKS, X.nnz, L), "XtX path chosen by auto")
    for name in ATAC_PATH:
        check(launches[name] > 0, f"the ATAC path launched {name}")
    for name in GATHER_PATH:
        check(gather_launches[name] > 0, f"the gather rSVD launched {name}")

    emb, varm, stdev = h.obsm["X_lsi"], h.varm["LSI"], h.uns["lsi"]["stdev"]
    check(emb.shape == (N_CELLS, K) and varm.shape == (N_PEAKS, K)
          and stdev.shape == (K,), "output shapes")
    check(all(np.isfinite(a).all() for a in (emb, varm, stdev, h.X.data)), "finite")
    # z-scoring is float32 on the host, as in the reference: over 1e5 cells
    # its mean carries float32 rounding, so the statistics are taken in f64
    mean_err = float(np.abs(emb.mean(axis=0, dtype=np.float64)).max())
    std_err = float(np.abs(emb.std(axis=0, dtype=np.float64) - 1).max())
    ref = tfidf_reference(X)
    tfidf_err = float(np.max(np.abs(h.X.data - ref) / np.abs(ref)))
    print(f"[atac] X_lsi {emb.shape} |mean|<={mean_err:.2e} |std-1|<={std_err:.2e}; "
          f"TF-IDF vs scipy max rel {tfidf_err:.2e}", flush=True)
    check(mean_err <= 1e-3 and std_err <= 1e-3, "X_lsi z-scored to 1e-3")
    check(bool(np.all(np.diff(stdev) <= 0)), "stdev non-increasing")
    check(np.allclose(h.X.data, ref, rtol=1e-5, atol=1e-6), "TF-IDF vs scipy rtol 1e-5")

    # singular values, rtol 1e-4: against the plain-torch version of the
    # same path with the same Ω (the atomics sum in another order, which can
    # move a bf16 rounding by one ulp; the card reads about 1e-5)
    s = stdev * np.sqrt(N_CELLS - 1)
    dT = dsp.from_scipy(h.X, cuda)
    om = tla.draw_omega(N_PEAKS, L, SEED, cuda)
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())  # noqa: E731
    s_plain = tla._rsvd_blocks(dT, K, om, N_ITER, ops=tla.PLAIN_OPS)[1].cpu()
    rel_xtx = rel(torch.from_numpy(s).float(), s_plain)
    rel_gather = rel(s_gather.cpu(), tla._rsvd_gather(dT, K, om, N_ITER, ops=tla.PLAIN_OPS)[1].cpu())
    # the two algorithms against each other: after N_ITER iterations their
    # Ritz values of this flat spectrum still differ by ~3e-3 (left vs right
    # projection of the same subspace), so compare them converged
    s_g30 = tla._rsvd_gather(dT, K, om, 30)[1].cpu()
    s_b30 = tla._rsvd_blocks(dT, K, om, 30)[1].cpu()
    rel_algos = rel(s_g30, s_b30)
    rel_algos_7 = rel(s_gather.cpu(), torch.from_numpy(s).float())
    print(f"[atac] s[0]={s[0]:.4f} s[-1]={s[-1]:.4f}; "
          f"s vs plain, same omega: XtX {rel_xtx:.2e} gather {rel_gather:.2e}; "
          f"gather vs XtX: {rel_algos_7:.2e} at {N_ITER} iterations, "
          f"{rel_algos:.2e} at 30", flush=True)
    check(rel_xtx <= 1e-4, "XtX singular values vs the plain path, rtol 1e-4")
    check(rel_gather <= 1e-4, "gather singular values vs the plain path, rtol 1e-4")
    check(rel_algos <= 1e-3, "gather vs XtX singular values at 30 iterations, rtol 1e-3")
    check_graph(h)
    print(f"[atac] neighbors: distances nnz {h.obsp['distances'].nnz}, "
          f"connectivities nnz {h.obsp['connectivities'].nnz}", flush=True)
    return launches, gather_launches, h


def normalise(dsp, X, cuda, plain=False):
    """The e2e's RNA library-size normalisation (bench_e2e.py:270-278) on
    the device: T7 row sums, inv = 1e4 / max(rs, 1), T8 row scaling,
    log1p; or the same through the kernels' plain versions."""
    from muon_tpu_torch.utils.profiling import stage

    with stage("rna/normalise"):
        dX = dsp.from_scipy(X, cuda)
        rs = (dsp.row_sums_plain if plain else dsp.row_sums)(dX)
        inv = 1e4 / torch.clamp(rs, min=1.0)
        vals = torch.log1p((dsp.scale_rows_data_plain if plain else dsp.scale_rows_data)(dX, inv))
        return dsp.to_scipy_data(X, vals)


def rna_path(dsp, tpp, X, cuda):
    h = Holder(normalise(dsp, X, cuda))
    tpp.pca(h, n_comps=K, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_pca", device=cuda)
    return h


def neighbors_plain(tk, tf, rep, cuda):
    """kNN, σ/ρ/membership, union and distances CSR through the plain
    versions, as single_neighbors runs them at this size (approx kNN)."""
    X = torch.from_numpy(np.ascontiguousarray(rep, dtype=np.float32)).to(cuda)
    op, sq = tk._operand(X, "euclidean", approx=N_CELLS > 20_000)
    idx, dists = tk.knn_topk_plain(op, sq, N_NEIGHBORS - 1, False, True)
    sig, _, vals = tf.smooth_knn_plain(dists)
    idx_np = idx.cpu().numpy()
    conn = tf._fuzzy_union(idx_np, vals.cpu().numpy(), X.shape[0], 1.0)
    d_np = dists.cpu().numpy().astype(np.float64)
    n = X.shape[0]
    dmat = sp.csr_matrix((d_np[:, 1:].reshape(-1), (np.repeat(np.arange(n), N_NEIGHBORS - 1),
                                                    idx_np[:, 1:].reshape(-1))), shape=(n, n))
    return sig, conn, dmat


def rna_plain(dsp, tla, tk, tf, X, cuda):
    """The whole RNA path through the plain versions (the XtX PCA branch
    with the same Ω as pp.pca)."""
    Xn = normalise(dsp, X, cuda, plain=True)
    dN = dsp.from_scipy(Xn, cuda)
    cs = torch.from_numpy(np.asarray(Xn.mean(axis=0)).ravel().astype(np.float32)).to(cuda) * N_CELLS
    U, s, _ = tla._pca_blocks(dN, cs, K, tla.draw_omega(N_GENES, L, SEED, cuda), N_ITER,
                              ops=tla.PLAIN_OPS)
    scores = (U * s).cpu().numpy()
    return scores, s, neighbors_plain(tk, tf, scores, cuda)


def phase_rna_path(dsp, tla, tpp, tk, tf, kernels, X, labels, cuda):
    kernels.reset_launch_counts()
    h = rna_path(dsp, tpp, X, cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    xtx = tla._blocks_profitable(N_CELLS, N_GENES, h.X.nnz, L)
    print(f"[rna] {N_CELLS}x{N_GENES} nnz={X.nnz}; PCA branch "
          f"{'XtX (T4 + T2)' if xtx else 'gather'}; launches by "
          f"normalise+pca+neighbors {launches}", flush=True)
    check(xtx, "the XtX PCA branch chosen at this size")
    for name in RNA_PATH:
        check(launches[name] > 0, f"the RNA path launched {name}")
    check(launches["csr_gram_matmul"] == N_ITER and launches["csr_spmm_f32"] == 1,
          "PCA ran 7 XtX products (T4) and one f32 X.V (T2)")
    check(h.obsm["X_pca"].shape == (N_CELLS, K) and np.isfinite(h.obsm["X_pca"]).all(),
          "X_pca shape, finite")
    purity = check_graph(h, labels)

    # against the plain path from the same representation: σ rtol 1e-4 and
    # the connectivities atol 1e-5 (values in (0, 1]) on the edges both
    # graphs hold. At this size T5 and its plain version give the same
    # indices and distances, so the values differ only by σ's f32 bisection
    # in T6 against torch: an H100 reads σ 1.8e-6 to 2.7e-6 relative and the
    # connectivities 6.6e-7 to 7.8e-7, so 1e-5 leaves 10x room and still
    # catches a graph assembled wrongly (a swapped or dropped edge moves a
    # shared edge's union value by its partner's membership, ~1e-1)
    t0 = time.perf_counter()
    sig_p, conn_p, dmat_p = neighbors_plain(tk, tf, h.obsm["X_pca"], cuda)
    rep = torch.from_numpy(h.obsm["X_pca"]).to(cuda)
    op, sq = tk._operand(rep, "euclidean", approx=N_CELLS > 20_000)
    _, dists = tk.knn_topk(op, sq, N_NEIGHBORS - 1, False, True)
    sig = tf.smooth_knn(dists)[0]
    sig_rel = float(((sig - sig_p).abs() / sig_p).max())
    C, Cp = h.obsp["connectivities"], conn_p
    both = C.multiply(Cp.astype(bool)).tocsr()
    both_p = Cp.multiply(C.astype(bool)).tocsr()
    conn_err = float(np.max(np.abs(both.data - both_p.data)))
    edge_jac = both.nnz / (C.nnz + Cp.nnz - both.nnz)
    D = h.obsp["distances"]
    knn_jac = float(np.mean([
        len(set(D.indices[D.indptr[i]:D.indptr[i + 1]])
            & set(dmat_p.indices[dmat_p.indptr[i]:dmat_p.indptr[i + 1]])) / (N_NEIGHBORS - 1)
        for i in range(0, N_CELLS, 50)]))
    purity_p = float((labels[np.repeat(np.arange(N_CELLS), N_NEIGHBORS - 1)]
                      == labels[dmat_p.indices]).mean())
    print(f"[rna] vs the plain path from the same X_pca ({time.perf_counter() - t0:.1f}s): "
          f"sigma max rel {sig_rel:.2e} (<= 1e-4); connectivities max abs err "
          f"{conn_err:.2e} on shared edges (<= 1e-5), edge Jaccard {edge_jac:.5f}; "
          f"kNN overlap on every 50th cell {knn_jac:.5f}; planted-label share of "
          f"neighbours {purity:.4f} (plain path {purity_p:.4f}; chance 0.05)", flush=True)
    check(sig_rel <= 1e-4, "sigma vs plain rtol 1e-4")
    check(conn_err <= 1e-5, "connectivities vs plain atol 1e-5")
    check(edge_jac >= 0.99 and knn_jac >= 0.99, "graphs vs plain overlap >= 0.99")
    # the bar: 0.55 (11x chance; the plain path reads 0.6147 on an H100 at
    # this seed), and within 0.01 of the plain path's share in this run
    check(purity >= 0.55 and abs(purity - purity_p) <= 0.01, "planted-label share")
    return launches, h


def phase_neighbors_kernels(dsp, tk, tf, X, rep, cuda) -> dict:
    """T7/T8 on the RNA counts, T5 on the RNA scores, T6 on T5's output,
    each against its plain version."""
    results = {}

    def record(name, err, tol_ok, tol, k_fn, p_fn, extra=""):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        results.setdefault(name, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        print(f"[kernel] {name}{extra}: max_abs_err={err:.3e} ({tol}) "
              f"ms={ms:.3f} plain_ms={plain_ms:.3f}", flush=True)
        check(tol_ok, f"{name}{extra} within {tol}")

    dX = dsp.from_scipy(X, cuda)
    rs = dsp.row_sums(dX)
    torch.cuda.synchronize()
    ref = dsp.row_sums_plain(dX)
    diff = (rs - ref).abs()
    record("csr_row_sums", diff.max().item(), bool((diff <= 1e-5 * ref.abs()).all()),
           "rtol 1e-5", lambda: dsp.row_sums(dX), lambda: dsp.row_sums_plain(dX))
    inv = 1e4 / torch.clamp(rs, min=1.0)
    out = dsp.scale_rows_data(dX, inv)
    torch.cuda.synchronize()
    err = (out - dsp.scale_rows_data_plain(dX, inv)).abs().max().item()
    record("csr_scale_rows", err, err == 0, "exact", lambda: dsp.scale_rows_data(dX, inv),
           lambda: dsp.scale_rows_data_plain(dX, inv))

    Xr = torch.from_numpy(rep).to(cuda)
    gen = torch.Generator().manual_seed(2)
    sample = torch.randperm(N_CELLS, generator=gen)[:2000].to(cuda)
    exact = {}
    # the path's variant (approx euclidean, k+1 = 20) first: it is the
    # JSON line's record
    for metric, approx, k in (("euclidean", True, N_NEIGHBORS - 1),
                              ("euclidean", False, N_NEIGHBORS - 1),
                              ("cosine", True, N_NEIGHBORS - 1),
                              ("cosine", False, N_NEIGHBORS - 1),
                              ("euclidean", True, 200)):
        one_minus, take_sqrt = metric == "cosine", metric == "euclidean"
        op, sq = tk._operand(Xr, metric, approx)
        args = (op, sq, k, one_minus, take_sqrt)
        gi, gd = tk.knn_topk(*args)
        torch.cuda.synchronize()
        ri, rd = tk.knn_topk_plain(*args)
        # |Δd²| <= 1e-5·(|q|² + |c|²): the expanded form's cancellation
        # error (normalised rows for cosine: 2e-5)
        scale = 2.0 if one_minus else sq[:, None] + sq[ri.long()]
        sqr = (lambda t: t.double() ** 2) if take_sqrt else (lambda t: t.double())  # noqa: E731
        ok = bool(((sqr(gd) - sqr(rd)).abs() <= 1e-5 * scale).all())
        equal = (gi == ri).float().mean().item()
        extra = f"[{metric} {'approx' if approx else 'f32'} k+1={k + 1}]"
        line = f" equal indices {equal:.5f}"
        if approx and k == N_NEIGHBORS - 1:
            exact_i = tk.knn_topk(*tk._operand(Xr, metric, False), k, one_minus, take_sqrt)[0]
            a, e = gi[sample].cpu().numpy(), exact_i[sample].cpu().numpy()
            recall = np.mean([len(set(x[1:]) & set(y[1:])) / k for x, y in zip(a, e)])
            exact[metric] = recall
            line += f"; recall vs f32 on 2000 queries {recall:.5f}"
        record("knn_topk", (gd - rd).abs().max().item(), ok and equal >= 0.99,
               "|dd2| <= 1e-5(|q|^2+|c|^2), equal indices >= 0.99",
               lambda: tk.knn_topk(*args), lambda: tk.knn_topk_plain(*args), extra + line)
        if metric == "euclidean" and approx and k == N_NEIGHBORS - 1:
            path_dists = gd
    for metric, recall in exact.items():
        check(recall >= 0.99, f"approx {metric} recall {recall:.4f} >= 0.99")

    sig, rho, vals = tf.smooth_knn(path_dists)
    torch.cuda.synchronize()
    sp_, rp, vp = tf.smooth_knn_plain(path_dists)
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()  # noqa: E731
    s_rel, r_rel, v_err = rel(sig, sp_), rel(rho, rp), (vals - vp).abs().max().item()
    record("smooth_knn_membership", v_err,
           s_rel <= 1e-5 and r_rel <= 1e-5 and v_err <= 1e-6,
           f"sigma rel {s_rel:.1e}, rho rel {r_rel:.1e} <= 1e-5; vals atol 1e-6",
           lambda: tf.smooth_knn(path_dists), lambda: tf.smooth_knn_plain(path_dists))
    return results


@contextmanager
def wnn_probe(tw, tk, tf, plain: bool):
    """Record what ``wnn_neighbors`` hands T9, T10 and T11 and what they return,
    and the k of its kNN calls. With ``plain`` every kernel of the path
    (T5, T6, T9-T11) is routed to its plain PyTorch version for the block.
    Only this script swaps the module attributes; they are restored after."""
    rec = {"bandwidth": [], "theta": [], "fusion": [], "knn_k": []}
    targets = {(tw, "wnn_bandwidth"): "bandwidth", (tw, "wnn_theta"): "theta",
               (tw, "wnn_fusion_scores"): "fusion"}
    saved = {(m, n): getattr(m, n) for m, n in
             [*targets, (tw, "knn"), (tk, "knn_topk"), (tf, "smooth_knn")]}

    def recorder(fn, key):
        def run(*args):
            out = fn(*args)
            rec[key].append((args, out))
            return out
        return run

    def knn(X, k, **kw):
        rec["knn_k"].append(k)
        return saved[(tw, "knn")](X, k, **kw)

    try:
        for (mod, name), key in targets.items():
            fn = getattr(mod, f"{name}_plain") if plain else getattr(mod, name)
            setattr(mod, name, recorder(fn, key))
        tw.knn = knn
        if plain:
            tk.knn_topk, tf.smooth_knn = tk.knn_topk_plain, tf.smooth_knn_plain
        yield rec
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def atac_e2e_path(tac, tpp, X, cuda):
    """The e2e's ATAC modality up to its own graph, the input of WNN."""
    h = Holder(X)
    tac.pp.tfidf(h, device=cuda)
    tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_lsi", device=cuda)
    return h


def label_share(D, labels) -> float:
    rows = np.repeat(np.arange(D.shape[0]), np.diff(D.indptr))
    return float((labels[rows] == labels[D.indices]).mean())


def phase_wnn_path(tpp, tw, tk, tf, kernels, mods, labels, cuda):
    md = MuHolder(mods)
    with wnn_probe(tw, tk, tf, plain=False) as rec:
        kernels.reset_launch_counts()
        tpp.neighbors(md, device=cuda)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    print(f"[wnn] pp.neighbors(mdata) over {list(mods)} launched {launches}; "
          f"kNN k = {rec['knn_k']}", flush=True)
    for name, count in WNN_PATH.items():
        check(launches[name] == count, f"the WNN path launched {name} {count} times")
    check(rec["knn_k"] == [N_MULTI, N_MULTI], "T5 ran at k+1 = 201 per modality")

    D, C = md.obsp["distances"], md.obsp["connectivities"]
    rows = np.repeat(np.arange(N_CELLS), np.diff(D.indptr))
    inner = np.diff(rows) == 0
    check((np.diff(D.indptr) == N_NEIGHBORS + 1).all(), "21 fused neighbours per row")
    check(not (D.indices == rows).any(), "self not among the fused neighbours")
    check(bool((np.diff(D.indices)[inner] > 0).all()), "fused neighbours column-sorted")
    check(np.isfinite(D.data).all() and (D.data >= 0).all(), "fused distances finite, >= 0")
    check((C != C.T).nnz == 0, "fused connectivities symmetric")
    check(C.data.min() > 0 and C.data.max() <= 1, "fused connectivities in (0, 1]")
    w = np.stack([md.obs[f"{m}:mod_weight"] for m in mods], axis=1)
    check(bool(np.abs(w.sum(axis=1) - 1).max() <= 1e-9), "weights sum to 1")
    check(md.uns["neighbors"]["params"]["n_neighbors"] == N_NEIGHBORS, "WNN uns params")

    # the plain-PyTorch WNN from the same per-modality graphs
    md_p = MuHolder(mods)
    t0 = time.perf_counter()
    with wnn_probe(tw, tk, tf, plain=True) as rec_p:
        kernels.reset_launch_counts()
        tpp.neighbors(md_p, device=cuda)
        torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    check(not any(kernels.launch_counts().values()), "the plain WNN launched no kernel")

    def rel(a, b):
        return ((a - b).abs() / b.abs().clamp(min=1e-30)).cpu().numpy()

    sig_rel = np.concatenate([rel(a[1], b[1]) for a, b in zip(rec["bandwidth"], rec_p["bandwidth"])])
    th_rel = np.concatenate([rel(a[1], b[1]) for a, b in zip(rec["theta"], rec_p["theta"])])
    w_p = np.stack([md_p.obs[f"{m}:mod_weight"] for m in mods], axis=1)
    w_err = np.abs(w - w_p).max(axis=1)
    Dp, Cp = md_p.obsp["distances"], md_p.obsp["connectivities"]
    both = D.multiply(Dp.astype(bool))
    edge_jac = both.nnz / (D.nnz + Dp.nnz - both.nnz)
    cb = C.multiply(Cp.astype(bool)).tocsr()
    cb_p = Cp.multiply(C.astype(bool)).tocsr()
    conn_d = np.abs(cb.data - cb_p.data)
    conn_q = np.quantile(conn_d, [0.5, 0.99, 0.999])
    db = D.multiply(Dp.astype(bool)).tocsr()
    db_p = Dp.multiply(D.astype(bool)).tocsr()
    dist_rel = np.abs(db.data - db_p.data) / db_p.data
    share, share_p = label_share(D, labels), label_share(Dp, labels)
    own = {m: label_share(h.obsp["distances"], labels) for m, h in mods.items()}
    print(f"[wnn] vs the plain WNN from the same graphs: sigma rel <= 1e-5 on "
          f"{(sig_rel <= 1e-5).mean():.5f} of cells (max {sig_rel.max():.2e}); theta rel "
          f"<= 1e-4 on {(th_rel <= 1e-4).mean():.5f} (max {th_rel.max():.2e}); weights "
          f"|dw| <= 1e-4 on {(w_err <= 1e-4).mean():.5f} (max {w_err.max():.2e}); "
          f"edge Jaccard {edge_jac:.5f}; fused distances rel <= 1e-4 on "
          f"{(dist_rel <= 1e-4).mean():.5f} (max {dist_rel.max():.2e}); connectivities on "
          f"shared edges |dc| median {conn_q[0]:.2e}, 99% {conn_q[1]:.2e}, 99.9% "
          f"{conn_q[2]:.2e}, max {conn_d.max():.2e}", flush=True)
    print(f"[wnn] planted-label share of fused neighbours {share:.4f} (plain WNN "
          f"{share_p:.4f}); each modality's own graph: "
          + ", ".join(f"{m} {v:.4f}" for m, v in own.items())
          + f"; mean weights " + ", ".join(f"{m} {w[:, i].mean():.4f}" for i, m in enumerate(mods))
          + f" (chance 0.05)", flush=True)
    print(f"[times] plain-torch WNN on the card, one warm run: {t_plain:.4f}s", flush=True)
    # sigma, theta and the weights: the two versions sum in other orders, so
    # a score can round to the other side of a float32 step of N (2^-7 at
    # N = 1e5) and pick another winner. So the tight bound holds on a share,
    # and a bound on every cell catches what a share lets through (a wrong
    # fallback, a bug on rare rows). Three H100 runs read at most sigma
    # 8.3e-5, theta 1.2e-4, |dw| 4.8e-5 and fused distances 1.1e-5 relative
    check((sig_rel <= 1e-5).mean() >= 0.999, "sigma vs plain within rtol 1e-5 on >= 99.9% of cells")
    check(sig_rel.max() <= 1e-3, "sigma vs plain within rtol 1e-3 on every cell")
    check((th_rel <= 1e-4).mean() >= 0.999, "theta vs plain within rtol 1e-4 on >= 99.9%")
    check(th_rel.max() <= 1e-3, "theta vs plain within rtol 1e-3 on every row")
    check((w_err <= 1e-4).mean() >= 0.999, "weights vs plain within 1e-4 on >= 99.9%")
    check(w_err.max() <= 1e-3, "weights vs plain within 1e-3 on every cell")
    check(edge_jac >= 0.99, "fused graph vs plain edge Jaccard >= 0.99")
    # the fused distances sqrt(0.5 (1 - score)) of a row lie in a narrow
    # band, so T6's sigma is small and exp(-(d - rho)/sigma) magnifies the
    # weights' rounding (|dw| <= 5e-5) into the memberships: an H100 read a
    # largest |dc| of 8.8e-2 on identical edge sets. Held on the distances
    # and on the share of edges within 1e-3
    check((dist_rel <= 1e-4).mean() >= 0.999, "fused distances vs plain rtol 1e-4 on >= 99.9%")
    check(dist_rel.max() <= 1e-3, "fused distances vs plain rtol 1e-3 on every shared edge")
    check((conn_d <= 1e-3).mean() >= 0.999,
          "fused connectivities vs plain within 1e-3 on >= 99.9% of shared edges")
    check(abs(share - share_p) <= 0.01, "fused planted-label share within 0.01 of the plain WNN's")
    return launches, rec


def phase_wnn_kernels(tw, rec) -> dict:
    """T9-T11 against their plain versions on the arguments the WNN path
    gave them (the RNA modality's bandwidth, the RNA|ATAC theta, the fusion).
    Each is held tight on a share (a float32 near-tie may flip one winner of
    T9's selection) and within 100x that on every cell or row."""
    results = {}
    cases = (
        ("wnn_bandwidth", tw.wnn_bandwidth, tw.wnn_bandwidth_plain, rec["bandwidth"][0][0],
         "rtol 1e-5 on >= 99.9% of cells, 1e-3 on all", 1e-5),
        ("wnn_theta", tw.wnn_theta, tw.wnn_theta_plain, rec["theta"][1][0],
         "rtol 1e-5 on >= 99.9% of rows, 1e-3 on all", 1e-5),
        ("wnn_fusion_scores", tw.wnn_fusion_scores, tw.wnn_fusion_scores_plain,
         rec["fusion"][0][0], "atol 1e-5 on >= 99.9% of rows, 1e-3 on all", None),
    )
    for name, fn, plain, args, tol, tight in cases:
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        diff = (out - ref).abs()
        if tight is None:  # the row's largest absolute difference
            err, kind, tight = diff.max(dim=1).values, "row abs", 1e-5
        else:
            err, kind = diff / ref.abs().clamp(min=1e-30), "rel"
        ok = (err <= tight).float().mean().item() >= 0.999 and err.max().item() <= 100 * tight
        ms, plain_ms = median_ms(lambda: fn(*args)), median_ms(lambda: plain(*args), reps=3)
        results[name] = {"max_abs_err": diff.max().item(), "ms": ms, "plain_ms": plain_ms}
        shape = tuple(args[0].shape)
        print(f"[kernel] {name} {shape}: max_abs_err={diff.max().item():.3e} ({tol}; "
              f"largest {kind} err {err.max().item():.2e}) ms={ms:.3f} plain_ms={plain_ms:.3f}", flush=True)
        check(ok, f"{name} within {tol}")
    return results


def profiled(fn):
    """Run ``fn`` once under torch.profiler; returns (wall s, device busy s,
    copies s, top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op (aten::copy_) also carries the
    # device time of what it launched, and CUPTI adds its own buffer events
    dev = {e.key: e.device_time_total / 1e6 for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0
           and e.key != "Activity Buffer Request"}
    copies = sum(v for k, v in dev.items() if k.startswith(("Memcpy", "Memset")))
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy, copies, top


def print_profile(label, prof):
    wall, busy, copies, top = prof
    print(f"[profile] {label}: profiled wall {wall:.4f}s; device busy {busy:.4f}s "
          f"({busy / wall:.1%} of the wall; copies/memsets {copies:.4f}s); top "
          + "; ".join(f"{k[:60]} {v * 1e3:.3f}ms" for k, v in top), flush=True)


def timed_reps(label, make, run, profiling, reps=3):
    walls, splits = [], []
    for _ in range(reps):
        h = make()
        torch.cuda.synchronize()
        with profiling.collect() as t:
            t0 = time.perf_counter()
            run(h)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        splits.append({k: round(sum(v), 4) for k, v in t.items()})
    print(f"[times] {label} warm wall s {[round(w, 4) for w in walls]} "
          f"median {float(np.median(walls)):.4f}; stages {splits}", flush=True)


def phase_times(tac, tpp, dsp, tla, tk, tf, profiling, X, atac_h, X_rna, wnn_mods,
                cuda) -> None:
    def tfidf_lsi(h):
        tac.pp.tfidf(h, device=cuda)
        tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)

    def atac_neighbors(h):
        tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_lsi", device=cuda)

    def lsi_holder():
        h = Holder(atac_h.X)
        h.obsm["X_lsi"] = atac_h.obsm["X_lsi"]
        return h

    timed_reps("tfidf+lsi", lambda: Holder(X.copy()), tfidf_lsi, profiling)
    print_profile("tfidf+lsi", profiled(lambda: tfidf_lsi(Holder(X.copy()))))
    timed_reps("ATAC neighbors", lsi_holder, atac_neighbors, profiling)
    print_profile("ATAC neighbors", profiled(lambda: atac_neighbors(lsi_holder())))
    timed_reps("RNA normalise+pca+neighbors", lambda: X_rna,
               lambda X_: rna_path(dsp, tpp, X_, cuda), profiling)
    print_profile("RNA normalise+pca+neighbors",
                  profiled(lambda: rna_path(dsp, tpp, X_rna, cuda)))
    timed_reps("WNN pp.neighbors(mdata)", lambda: MuHolder(wnn_mods),
               lambda md: tpp.neighbors(md, device=cuda), profiling)
    print_profile("WNN pp.neighbors(mdata)",
                  profiled(lambda: tpp.neighbors(MuHolder(wnn_mods), device=cuda)))

    h = Holder(X.copy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X0 = h.X.tocsr()
    new = dsp.tfidf_data_plain(dsp.from_scipy(X0, cuda))
    dT = dsp.from_scipy(dsp.to_scipy_data(X0, new), cuda)
    U, s, Vt = tla._rsvd_blocks(dT, K, tla.draw_omega(N_PEAKS, L, SEED, cuda),
                                N_ITER, ops=tla.PLAIN_OPS)
    U, s, Vt = U.cpu().numpy(), s.cpu().numpy(), Vt.cpu().numpy()
    emb = (U - U.mean(axis=0)) / U.std(axis=0)
    check(np.isfinite(emb).all() and np.isfinite(s).all(), "plain path finite")
    t1 = time.perf_counter()
    neighbors_plain(tk, tf, emb, cuda)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[times] plain-torch on the card, one warm run: tfidf+lsi {t1 - t0:.4f}s, "
          f"ATAC neighbors {t2 - t1:.4f}s", flush=True)
    t0 = time.perf_counter()
    rna_plain(dsp, tla, tk, tf, X_rna, cuda)
    torch.cuda.synchronize()
    print(f"[times] plain-torch RNA normalise+pca+neighbors on the card, one warm "
          f"run: {time.perf_counter() - t0:.4f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch.ops import _kernels as kernels
    from muon_tpu_torch.ops import fuzzy as tf
    from muon_tpu_torch.ops import knn as tk
    from muon_tpu_torch.ops import linalg as tla
    from muon_tpu_torch.ops import sparse as dsp
    from muon_tpu_torch.ops import wnn as tw
    from muon_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    cuda = torch.device("cuda", 0)
    smi = phase_device(kernels)
    phase_build(kernels)

    t0 = time.perf_counter()
    X = make_counts(SEED)
    print(f"[data] ATAC {X.shape[0]}x{X.shape[1]} nnz={X.nnz} made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    X_rna, X_atac_e2e, labels = make_e2e_counts(SEED)
    print(f"[data] e2e RNA {X_rna.shape[0]}x{X_rna.shape[1]} nnz={X_rna.nnz}, ATAC "
          f"{X_atac_e2e.shape[0]}x{X_atac_e2e.shape[1]} nnz={X_atac_e2e.nnz}, "
          f"{N_CLUSTERS} planted clusters, made in {time.perf_counter() - t0:.1f}s",
          flush=True)

    results = phase_kernels(dsp, dsp.from_scipy(X, cuda), cuda)
    atac_launches, gather_launches, atac_h = phase_atac_path(
        tac, tpp, dsp, tla, kernels, X, cuda)
    rna_launches, rna_h = phase_rna_path(dsp, tla, tpp, tk, tf, kernels, X_rna, labels, cuda)
    results.update(phase_neighbors_kernels(dsp, tk, tf, X_rna, rna_h.obsm["X_pca"], cuda))
    t0 = time.perf_counter()
    wnn_mods = {"rna": rna_h, "atac": atac_e2e_path(tac, tpp, X_atac_e2e, cuda)}
    print(f"[wnn] e2e ATAC tfidf -> lsi -> neighbors in {time.perf_counter() - t0:.1f}s",
          flush=True)
    wnn_launches, wnn_rec = phase_wnn_path(tpp, tw, tk, tf, kernels, wnn_mods, labels, cuda)
    results.update(phase_wnn_kernels(tw, wnn_rec))
    del wnn_rec
    phase_times(tac, tpp, dsp, tla, tk, tf, profiling, X, atac_h, X_rna, wnn_mods, cuda)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} checks failed: {FAILED}", file=sys.stderr)
        return 1

    by_path = {"atac": atac_launches, "rna": rna_launches, "wnn": wnn_launches}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": sum(c[name] for c in by_path.values()),
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         "gather_launches": gather_launches[name],
         **results[name]}
        for name in kernels.KERNELS
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
