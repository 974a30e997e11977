"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA device, nvcc, g++

The user journey of ``bench_e2e.py`` through ``muon_tpu_torch``, at full
width, 100,000 cells:

* ATAC: ``atac.pp.tfidf`` → ``atac.tl.lsi(n_comps=50)`` →
  ``pp.neighbors(n_neighbors=20, use_rep="X_lsi")`` on synthetic ATAC
  counts, 100,000 cells × 25,000 peaks, 250 draws per cell with Pareto(1.2)
  peak popularity (the recipe of ``bench.py::make_counts``, seed 0);
* RNA: library-size normalisation (row sums, 1e4 / max(rs, 1), row scaling,
  log1p) → ``pp.pca(n_comps=50)`` → ``pp.neighbors(n_neighbors=20,
  use_rep="X_pca")`` on the clustered RNA counts of ``bench_e2e.py::synth``
  at its scale-10 size: 100,000 cells × 20,000 genes, 100 draws per cell,
  20 planted clusters, seed 0 (labels drawn first, as there);
* prot: the protein modality of the same ``synth`` (drawn after the ATAC
  one from the same generator: 100,000 × 120 dense, planted centres plus
  Poisson(3)) through ``prot.pp.clr`` → ``pp.pca(n_comps=30)`` →
  ``pp.neighbors(n_neighbors=20, use_rep="X_pca")``;
* WNN: the ATAC modality of the same ``synth`` (100,000 × 25,000, 150
  draws per cell, the same labels) through ``atac.pp.tfidf`` →
  ``atac.tl.lsi(n_comps=50)`` → ``pp.neighbors(n_neighbors=20,
  use_rep="X_lsi")``, then ``pp.neighbors(mdata)`` over {rna, atac, prot}
  with the default parameters (n_multineighbors 200, n_bandwidth_neighbors
  20);
* Leiden: ``tl.leiden(mdata, resolution=1.0)`` over the three modality
  graphs (on the host, the native engine);
* UMAP: ``tl.umap(mdata)`` on the WNN graph, 200 epochs;

and the path above 200,000 rows at 1,000,000 cells: a 1,000,000 × 50
float32 representation of 40 planted clusters whose neighbours overlap
(drawn from seed 0; no count matrix at this size) through
``pp.neighbors(n_neighbors=20)``, which takes the IVF index (k-means, the
host layout, the search, the scatter back), T6 and the native fuzzy union,
then ``tl.umap`` on its graph of about 30M edges, seeded from the membership
table;

and MOFA+ through ``models.mofa.fit_mofa`` at three sizes: the recipe of
``bench.py``'s mode ``mofa`` (10,000 cells, gaussian views of 2000 and 3000
features from 15 planted factors, seed 0, 2 warm-up sweeps and then 50
full-batch sweeps); the MOFA stage of ``bench_e2e.py`` at 100,000 cells (the
256 most variable columns of the normalised RNA and of the TF-IDF ATAC
matrix, selected on the device through ``ops.sparse.col_sums``, K = 15,
stochastic VI, 100 iterations of 50,000 cells); and the same stochastic fit
on two 1,000,000 × 256 views made on the device from 15 planted factors.

Phases, one line each or more. A failed check is printed as ``[check
failed]`` and recorded, and the run goes on, so that one run reads every
number; at the end any recorded failure makes the exit code 1 and no result
is printed. An exception stops the run at once, with a code other than 0:

1. device: the card, the torch/CUDA/nvcc versions, which optional modules import;
2. build: compile the CUDA kernels from ``muon_tpu_torch/csrc`` and the
   Leiden engine from ``muon_tpu_torch/native``;
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
7. prot path, counted the same way: T12 in ``clr``, the PCA against the
   same iteration in float64 and the exact spectrum, the graph; then T12
   against its plain version on the protein counts;
8. WNN path over {rna, atac, prot}, counted from ``pp.neighbors(mdata)``
   alone: the launches of T5, T6 and T9-T11, the fused graph and the
   modality weights; σ, θ, the weights and the graph against the
   plain-PyTorch WNN from the same per-modality graphs; the planted labels
   among the fused neighbours;
9. kernels: T9-T11 against their plain versions on the arguments the WNN
   path gave them;
10. Leiden: the ARI of the clusters against the planted labels;
11. UMAP path, counted from ``tl.umap(mdata)`` alone: T13 every epoch and
    T2 in the spectral init; one T13 epoch against its plain version from
    the spectral layout with shared negatives; the 200-epoch layouts of the
    kernel and of the plain version from the same start, held by the
    planted-label share of each cell's 15 nearest 2-D neighbours (T5 at
    d = 2), and that share's spread over 10 seeds on the same graph and
    over 5 starts jittered by 1e-4 at the checked seed;
12. times: the warm wall of each path with its stage split, each path's
    device busy share under the profiler, and the plain-PyTorch paths once;
13. ``[ivf]``, counted from ``pp.neighbors`` at 1M alone: T15 nine times,
    T14, T6, no T5; the table (self first, no −1, ascending), its recall
    over all rows against exact T5 at the same size with both times, and
    against the plain search of the same probe lists on the first 64 work
    items (what the data allows against what the port loses); the graph and
    its tag; the native union against the scipy formula with both times
    (also at 100k, after phase 5); ``ivf_knn`` again at k = 200 on the
    cached partition; the stage split;
14. ``[umap1m]``, counted from ``tl.umap`` alone: T16 thirteen times, T13
    per epoch, no T2; the layout's planted-label share against the graph's
    own; the membership seed against the exact seed by their Rayleigh
    quotients under the graph's normalised operator (a seed of noise
    fails), with both times; the stage split;
15. kernels: T14 (k+1 = 20 and 201, the first 64 work items of the 1M
    layout), T15 (all rows) and T16 (one application) against their plain
    versions;
16. repairs (after phase 12): T13 at 12 components (the kernel that takes
    the number at run time) against plain on the WNN graph; ``[wnn-wide]``,
    ``pp.neighbors(mdata)`` over neighbour lists 250 wide on the first 2,000
    cells, counted alone: T9's variant that keeps a cell's candidates in
    global memory, twice; that variant against plain at kk = 256, d = 50;
17. ``[mofa-e2e]``, counted from ``fit_mofa`` alone: the launches of T17-T20
    by the formula (per sweep T17 K·M + M, T18 and T19 K·M, T20 2·K·M), the
    wall and the stage split, and the e2e's gate: the label-probe R² of Z
    above max(0.2, 0.8 × that of the first 15 PCA components);
18. kernels: T17-T20 against their plain versions at 10,000 × 3000 (unmasked
    and masked) and 50,000 × 256, each with its bound and, where one PyTorch
    call computes the same, that call's time;
19. ``[mofa]``, counted the same way: sweeps per second, the stage split, peak
    memory; the canonical correlations of Z with the planted factors (> 0.9);
    two fits bit for bit; one sweep through the kernels against the plain
    versions from the same state (every leaf within 1e-4 of its largest
    entry); the ELBO of every sweep (never falling by more than 1e-5); the
    plain path's time;
20. ``[mofa-1m]`` (last), counted the same way: the wall, the time per
    iteration, peak memory, and the canonical correlations (> 0.9).

The last three lines are a JSON object of the kernels (``launches`` adds
up the main paths' counts, each read from its own run with the counters
set to 0 just before it, and ``launches_by_path`` gives each;
``gather_launches`` counts the gather rSVD side run, which is no part of
``launches``; ``bound_ms`` is the least time the card could take for the
kernel's measured call, ``library_ms`` the time of one PyTorch call that
computes the same function, where there is one), the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device it prints no result and exits 1.
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
N_PROT, PROT_COMPS = 120, 30  # bench_e2e.py's D_PROT and its prot pca(30)
N_MULTI = 200  # WNN's n_multineighbors (its default)
N_EPOCHS = 200  # tl.umap's epochs above 10,000 cells
K, N_ITER, SEED = 50, 7, 0
L = K + 10
N_NEIGHBORS = 20
SPARSE_SRC = "muon_tpu_torch/csrc/sparse_kernels.cu"
KNN_SRC = "muon_tpu_torch/csrc/knn_kernels.cu"
WNN_SRC = "muon_tpu_torch/csrc/wnn_kernels.cu"
DENSE_SRC = "muon_tpu_torch/csrc/dense_kernels.cu"
UMAP_SRC = "muon_tpu_torch/csrc/umap_kernels.cu"
IVF_SRC = "muon_tpu_torch/csrc/ivf_kernels.cu"
MOFA_SRC = "muon_tpu_torch/csrc/mofa_kernels.cu"
# MOFA: bench.py's mode `mofa` (10,000 cells, views of 2000 and 3000 features,
# 50 full-batch sweeps after 2), the e2e's stage (two 256-column views, SVI,
# 100 iterations of 50,000 cells) at 100,000 and at 1,000,000 cells; K = 15
MOFA_K, MOFA_N, MOFA_DS, MOFA_SWEEPS, MOFA_WARM = 15, 10_000, (2000, 3000), 50, 2
MOFA_COLS, MOFA_ITERS, MOFA_BATCH = 256, 100, 50_000
# the width of the neighbour lists that drive T9's global-memory variant: 250
# through pp.neighbors (T5 takes k + 1 <= 255), 256 for the kernel against plain
WIDE_KK, WIDE_KK_KERNEL, WIDE_CELLS = 250, 256, 2_000
# the 1M-cell path: rows, columns and planted clusters of its representation,
# the work items T14 is held to its plain version on, the seed check's sample
N_BIG, D_BIG, BIG_CLUSTERS, IVF_ITEMS, SEED_SAMPLE = 1_000_000, 50, 40, 64, 20_000
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
    "clr_dense": (DENSE_SRC, "muon_tpu/ops/dense.py:64"),           # _clr_dense_fn
    "umap_epoch": (UMAP_SRC, "muon_tpu/ops/umap.py:289"),           # _optimize_layout_bucketed_fn
    "ivf_search": (IVF_SRC, "muon_tpu/ops/ivf.py:126"),             # _search_fn
    "kmeans_assign": (IVF_SRC, "muon_tpu/ops/ivf.py:83"),           # _kmeans_fn's assign
    "membership_matvec": (UMAP_SRC, "muon_tpu/ops/umap.py:75"),     # _spectral_membership_fn
    "wnn_bandwidth_global": (WNN_SRC, "muon_tpu/ops/wnn.py:339"),   # _bandwidth_fn, wide lists
    # the loop bodies of _make_step (:94) and _make_svi_step (:811)
    "mofa_col_dot": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),       # zk @ E, (E*E).sum(0)
    "mofa_w_posterior": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),   # w_body's posterior
    "mofa_row_dot": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),       # Es[m] @ tsw, B @ tSWW
    "mofa_rank1_update": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),  # E + zk (x) delta
}
# what each path launches: the ATAC path (auto takes the XtX path for lsi,
# neighbors the approx kNN), the RNA path, and the gather rSVD side run
ATAC_PATH = ("tfidf_values", "csr_spmm_f32", "csr_gram_matmul", "knn_topk",
             "smooth_knn_membership")
RNA_PATH = ("csr_row_sums", "csr_scale_rows", "csr_gram_matmul", "csr_spmm_f32",
            "knn_topk", "smooth_knn_membership")
GATHER_PATH = ("csr_spmm_bf16", "csr_spmm_t_bf16", "csr_spmm_t_f32")
PROT_PATH = {"clr_dense": 1, "knn_topk": 1, "smooth_knn_membership": 1}
# WNN of {rna, atac, prot}: T9 per modality, T10 per ordered pair (self
# pairs included), T11 once, T5 per modality for the 200-wide candidate
# pool, T6 once for the fused graph
WNN_PATH = {"wnn_bandwidth": 3, "wnn_theta": 9, "wnn_fusion_scores": 1, "knn_topk": 3,
            "smooth_knn_membership": 1}
# tl.umap: T13 per epoch; the spectral init's symmetric gather rSVD (k = 3,
# 4 iterations): T2 in bf16 once and twice per iteration, then once in f32
UMAP_PATH = {"umap_epoch": N_EPOCHS, "csr_spmm_bf16": 9, "csr_spmm_f32": 1}
# pp.neighbors above 200,000 rows: 8 Lloyd steps and a last assignment (T15),
# the search (T14, at least once), T6, and no brute force (T5)
IVF_PATH = {"kmeans_assign": 9, "smooth_knn_membership": 1, "knn_topk": 0}
# tl.umap above 8M edges: six S² steps and the Rayleigh-Ritz product (T16),
# T13 per epoch, and nothing of the exact seed's rSVD (T2)
UMAP_BIG_PATH = {"membership_matvec": 13, "umap_epoch": N_EPOCHS, "csr_spmm_bf16": 0,
                 "csr_spmm_f32": 0}
# WNN over neighbour lists 256 wide: T9's global-memory variant per modality
WNN_WIDE_PATH = {"wnn_bandwidth_global": 2, "wnn_bandwidth": 0, "wnn_theta": 4,
                 "wnn_fusion_scores": 1}


def mofa_launches(sweeps: int, n_views: int = 2) -> dict:
    """What ``sweeps`` MOFA sweeps (full-batch or SVI) launch: per sweep T17
    K·M + M (one per factor and view, and Σ E² per view for τ), T18 and T19
    K·M, T20 2·K·M."""
    km = MOFA_K * n_views
    return {"mofa_col_dot": sweeps * (km + n_views), "mofa_w_posterior": sweeps * km,
            "mofa_row_dot": sweeps * km, "mofa_rank1_update": sweeps * 2 * km}


# the card's published peaks (H100 SXM: NVIDIA's data sheet, dense, at
# 700 W): device memory, float32 outside the tensor cores, and bfloat16 in
# them. A kernel's bound is the larger of its bytes (each input read once,
# each output written once) over the memory rate and its operations over
# the peak of their type: products of bfloat16 operands at the bfloat16
# rate, everything else at the float32 rate
HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S = 3.35e12, 67e12, 989e12


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


class MuHolder:
    """The least MuData-like object WNN takes: modalities over the same
    cells, in the same order (obsmap is 1-based)."""

    def __init__(self, mods, n: int = N_CELLS):
        self.mod, self.n_obs = mods, n
        self.obsmap = {k: np.arange(1, n + 1) for k in mods}
        self.obs, self.obsm, self.obsp, self.uns = {}, {}, {}, {}


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
    """Clustered RNA and ATAC counts, dense protein counts and their planted
    labels, the recipe of bench_e2e.py::synth at 100,000 cells: labels
    first, then per modality, from the same generator, per-cluster tilted
    Pareto(1.2) feature popularity for the counts, and for the proteins
    planted centres clipped at 0 plus Poisson(3) background."""
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
    atac = counts(N_PEAKS, NNZ_PER_ATAC_CELL)
    cent = rng.normal(size=(N_CLUSTERS, N_PROT)) * 2.0
    prot = np.maximum(
        cent[labels] + rng.normal(size=(N_CELLS, N_PROT)), 0.0
    ).astype(np.float32) + rng.poisson(3.0, size=(N_CELLS, N_PROT)).astype(np.float32)
    return rna, atac, prot, labels


FAILED = []


def check(ok, what: str) -> None:
    """Record a failed check; the run goes on so that one run reads every
    number, and exits non-zero at its end."""
    if not ok:
        FAILED.append(what)
        print(f"[check failed] {what}", flush=True)


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up. A
    spin of about a millisecond is queued before each start event, so the
    device is still busy while the host enqueues ``fn``'s launches, and the
    time is that of the launches, not of the host's gap before them."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate, and which it is."""
    by_bytes, by_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library_ms(fn):
    """The time of one PyTorch call computing the kernel's function, or None
    when that call fails on this installation (printed)."""
    try:
        return median_ms(fn)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"[library] {str(e).splitlines()[0][:160]}", flush=True)
        return None


def csr_bytes(X) -> int:
    return nbytes(X.data, X.indptr, X.indices)


def torch_csr(X):
    """A DeviceCSR as a torch sparse CSR tensor, for the library calls."""
    return torch.sparse_csr_tensor(X.indptr, X.indices, X.data, size=X.shape)


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


def phase_build(kernels, native) -> None:
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines() if "registers" in ln]
    t1 = time.perf_counter()
    native.load_leiden_lib()
    print(f"[build] {t1 - t0:.1f}s {so.name} | " + "; ".join(regs), flush=True)
    print(f"[build] Leiden engine {time.perf_counter() - t1:.1f}s "
          f"{native.leiden_library_path().name}", flush=True)


def phase_kernels(dsp, dX, cuda) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    results = {}

    def record(name, err, tol_ok, tol, k_fn, p_fn, bnd, lib_fn=None):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        lib = library_ms(lib_fn) if lib_fn is not None else None
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                         "library_ms": lib}
        print(f"[kernel] {name}: max_abs_err={err:.3e} ({tol}) ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 3)}", flush=True)
        check(tol_ok, f"{name} within {tol}")

    out = dsp.tfidf_data(dX)
    torch.cuda.synchronize()
    ref = dsp.tfidf_data_plain(dX)
    diff = (out - ref).abs()
    # per value: tf = x / rs · scale, log1p, · log1p(n / cs), finiteness
    record("tfidf_values", diff.max().item(),
           bool((diff <= 1e-6 + 1e-5 * ref.abs()).all()), "rtol 1e-5 atol 1e-6",
           lambda: dsp.tfidf_data(dX), lambda: dsp.tfidf_data_plain(dX),
           bound(csr_bytes(dX) + nbytes(out), 8 * dX.nnz, F32_OPS_PER_S))

    dT = dX._replace(data=out)  # the TF-IDF matrix the products see on the path
    dA = dT._replace(data=out.abs())
    sT = torch_csr(dT)
    sTt = torch_csr(dsp.from_scipy(sp.csr_matrix(
        (out.cpu().numpy(), dX.indices.cpu().numpy(), dX.indptr.cpu().numpy()),
        shape=dX.shape).T.tocsr(), cuda))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        V = torch.randn((N_PEAKS, L), generator=gen, device=cuda).to(dtype)
        out = dsp.spmm(dT, V)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_plain(dT, V)).abs()
        tol_ = 1e-5 * dsp.spmm_plain(dA, V.float().abs())
        # the library call only where it computes the same function: an f32 B
        record(f"csr_spmm_{tag}", diff.max().item(), bool((diff <= tol_).all()),
               "1e-5 x |X|.|B|", lambda: dsp.spmm(dT, V), lambda: dsp.spmm_plain(dT, V),
               bound(csr_bytes(dT) + nbytes(V, out), 2 * dT.nnz * L, F32_OPS_PER_S),
               (lambda: torch.sparse.mm(sT, V)) if tag == "f32" else None)

        Y = torch.randn((N_CELLS, L), generator=gen, device=cuda).to(dtype)
        out = dsp.spmm_t(dT, Y)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_t_plain(dT, Y)).abs()
        tol_ = 1e-5 * dsp.spmm_t_plain(dA, Y.float().abs())
        record(f"csr_spmm_t_{tag}", diff.max().item(), bool((diff <= tol_).all()),
               "1e-5 x |X|^T.|B|", lambda: dsp.spmm_t(dT, Y),
               lambda: dsp.spmm_t_plain(dT, Y),
               bound(csr_bytes(dT) + nbytes(Y, out), 2 * dT.nnz * L, F32_OPS_PER_S),
               (lambda: torch.sparse.mm(sTt, Y)) if tag == "f32" else None)

    V = torch.randn((N_PEAKS, L), generator=gen, device=cuda)
    out = dsp.gram_matmul(dT, V)
    torch.cuda.synchronize()
    ref = dsp.gram_matmul_plain(dT, V)
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    # 1e-4: dropping the bf16 rounding of z or of x_ij reads about 1e-3
    # X·V then Xᵀ·z, both of bfloat16 operands; V read as bfloat16
    record("csr_gram_matmul", (out - ref).abs().max().item(), rel <= 1e-4,
           f"relative Frobenius {rel:.2e} <= 1e-4",
           lambda: dsp.gram_matmul(dT, V), lambda: dsp.gram_matmul_plain(dT, V),
           bound(csr_bytes(dT) + V.numel() * 2 + nbytes(out), 4 * dT.nnz * L,
                 BF16_OPS_PER_S))
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

    def record(name, err, tol_ok, tol, k_fn, p_fn, bnd, extra="", lib_fn=None):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        lib = library_ms(lib_fn) if lib_fn is not None else None
        results.setdefault(name, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  **bnd, "library_ms": lib})
        print(f"[kernel] {name}{extra}: max_abs_err={err:.3e} ({tol}) ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 3)}", flush=True)
        check(tol_ok, f"{name}{extra} within {tol}")

    dX = dsp.from_scipy(X, cuda)
    rs = dsp.row_sums(dX)
    torch.cuda.synchronize()
    ref = dsp.row_sums_plain(dX)
    diff = (rs - ref).abs()
    offsets = dX.indptr.long()
    record("csr_row_sums", diff.max().item(), bool((diff <= 1e-5 * ref.abs()).all()),
           "rtol 1e-5", lambda: dsp.row_sums(dX), lambda: dsp.row_sums_plain(dX),
           bound(nbytes(dX.data, dX.indptr, rs), dX.nnz, F32_OPS_PER_S),
           lib_fn=lambda: torch.segment_reduce(dX.data, "sum", offsets=offsets))
    inv = 1e4 / torch.clamp(rs, min=1.0)
    out = dsp.scale_rows_data(dX, inv)
    torch.cuda.synchronize()
    err = (out - dsp.scale_rows_data_plain(dX, inv)).abs().max().item()
    record("csr_scale_rows", err, err == 0, "exact", lambda: dsp.scale_rows_data(dX, inv),
           lambda: dsp.scale_rows_data_plain(dX, inv),
           bound(nbytes(dX.data, dX.indptr, inv, out), dX.nnz, F32_OPS_PER_S))

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
        # the n² cross terms of d products each; approx: bfloat16 operands
        n_, d_ = op.shape
        record("knn_topk", (gd - rd).abs().max().item(), ok and equal >= 0.99,
               "|dd2| <= 1e-5(|q|^2+|c|^2), equal indices >= 0.99",
               lambda: tk.knn_topk(*args), lambda: tk.knn_topk_plain(*args),
               bound(nbytes(op, gi, gd) + (0 if sq is None else nbytes(sq)), 2 * n_ * n_ * d_,
                     BF16_OPS_PER_S if approx else F32_OPS_PER_S), extra + line)
        if metric == "euclidean" and approx and k == N_NEIGHBORS - 1:
            path_dists = gd
    for metric, recall in exact.items():
        check(recall >= 0.99, f"approx {metric} recall {recall:.4f} >= 0.99")

    sig, rho, vals = tf.smooth_knn(path_dists)
    torch.cuda.synchronize()
    sp_, rp, vp = tf.smooth_knn_plain(path_dists)
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()  # noqa: E731
    s_rel, r_rel, v_err = rel(sig, sp_), rel(rho, rp), (vals - vp).abs().max().item()
    # the membership pass alone: exp(−max(d − ρ, 0)/σ) of the kernel's own σ, ρ
    own = torch.exp(-torch.clamp(path_dists - rho[:, None], min=0.0) / sig[:, None])
    m_err = (vals - own).abs().max().item()
    # against the plain chain, the bisection's σ difference carries into
    # v = exp(−x) as |Δv| <= x·e^(−x)·|Δσ|/σ <= s_rel/e, beside 1e-6 of rounding
    v_tol = 1e-6 + s_rel / np.e
    # 64 bisection steps of k terms (subtract, divide, exp, add), then the k values
    record("smooth_knn_membership", v_err,
           s_rel <= 1e-5 and r_rel <= 1e-5 and m_err <= 1e-6 and v_err <= v_tol,
           f"sigma rel {s_rel:.1e}, rho rel {r_rel:.1e} <= 1e-5; vals of its own sigma, rho "
           f"{m_err:.1e} <= 1e-6; vals {v_err:.1e} <= 1e-6 + sigma rel/e = {v_tol:.1e}",
           lambda: tf.smooth_knn(path_dists), lambda: tf.smooth_knn_plain(path_dists),
           bound(nbytes(path_dists, sig, rho, vals), path_dists.numel() * (64 * 4 + 3),
                 F32_OPS_PER_S))
    return results


def prot_path(tpt, tpp, P, cuda):
    """The e2e's protein modality up to its own graph: clr (seurat, axis 0,
    T12) → pca(30) of the dense result → neighbors(20)."""
    h = Holder(P.copy())
    tpt.pp.clr(h, device=cuda)
    tpp.pca(h, n_comps=PROT_COMPS, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_pca", device=cuda)
    return h


def phase_prot_path(tpt, tpp, tla, td, kernels, P, labels, cuda):
    kernels.reset_launch_counts()
    h = prot_path(tpt, tpp, P, cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[prot] {N_CELLS}x{N_PROT} dense; launches by clr+pca+neighbors {launches}",
          flush=True)
    for name, count in PROT_PATH.items():
        check(launches[name] == count, f"the prot path launched {name} {count} times")
    # the CLR against T12's plain version on the same counts (float32 both)
    ref = td.clr_values_plain(torch.from_numpy(P).to(cuda), 0, seurat=True)[0].cpu().numpy()
    clr_err = float(np.max(np.abs(h.X - ref) / (1e-6 + np.abs(ref))))
    check(h.X.dtype == np.float32 and h.X.shape == P.shape, "clr keeps the dtype and shape")
    check(np.allclose(h.X, ref, rtol=1e-5, atol=1e-6), "clr vs the plain version rtol 1e-5")
    # PCA of the dense 100k x 120: the same iteration with the same omega in
    # float64 (float32 rounding only), and the exact spectrum of the centred
    # matrix for the 19 planted directions (20 clusters)
    X64 = torch.from_numpy(h.X).to(cuda, torch.float64)
    om = tla.draw_omega(N_PROT, PROT_COMPS + 10, SEED, cuda).double()
    s64 = tla._pca_dense(X64, PROT_COMPS, om, N_ITER, True)[1].cpu().numpy()
    exact = torch.linalg.svdvals(X64 - X64.mean(dim=0)).cpu().numpy()[:PROT_COMPS]
    s = np.sqrt(h.uns["pca"]["variance"] * (N_CELLS - 1))
    rel_same = float(np.max(np.abs(s - s64) / s64))
    rel_exact = np.abs(s - exact) / exact
    check(h.obsm["X_pca"].shape == (N_CELLS, PROT_COMPS) and np.isfinite(h.obsm["X_pca"]).all(),
          "prot X_pca shape, finite")
    check(rel_same <= 1e-4, "prot PCA vs the float64 iteration, rtol 1e-4")
    # 7 iterations of a 40-wide subspace: the weakest planted directions sit
    # near the noise bulk and converge slowly, so this bound only asks for a PCA
    check(rel_exact[:N_CLUSTERS - 1].max() <= 1e-2,
          "prot PCA's planted directions vs the exact spectrum, rtol 1e-2")
    share = check_graph(h, labels)
    print(f"[prot] clr vs plain max rel {clr_err:.2e}; PCA singular values vs float64 "
          f"same omega {rel_same:.2e}, vs exact: first {N_CLUSTERS - 1} "
          f"{rel_exact[:N_CLUSTERS - 1].max():.2e}, rest {rel_exact[N_CLUSTERS - 1:].max():.2e}; "
          f"planted-label share of neighbours {share:.4f} (chance 0.05)", flush=True)
    check(share >= 0.55, "prot planted-label share >= 0.55")
    return launches, h


def phase_dense_kernels(td, P, cuda) -> dict:
    """T12 against its plain version on the protein counts, the path's call
    (the seurat form along axis 0)."""
    X = torch.from_numpy(P).to(cuda)
    out, gm = td.clr_values(X, 0, seurat=True)
    torch.cuda.synchronize()
    ref, gm_ref = td.clr_values_plain(X, 0, seurat=True)
    gm_rel = ((gm - gm_ref).abs() / gm_ref.abs()).max().item()
    diff = (out - ref).abs()
    ok = gm_rel <= 1e-6 and bool((diff <= 1e-6 + 1e-5 * ref.abs()).all())
    ms = median_ms(lambda: td.clr_values(X, 0, seurat=True))
    plain_ms = median_ms(lambda: td.clr_values_plain(X, 0, seurat=True))
    # per value log1p, add, then exp, divide, log1p
    bnd = bound(nbytes(X, out, gm), 5 * X.numel(), F32_OPS_PER_S)
    print(f"[kernel] clr_dense {tuple(X.shape)}: max_abs_err={diff.max().item():.3e} "
          f"(mean rtol 1e-6: {gm_rel:.2e}; values rtol 1e-5 atol 1e-6) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
          f"library_ms=None", flush=True)
    check(ok, "clr_dense within its tolerance")
    return {"clr_dense": {"max_abs_err": diff.max().item(), "ms": ms, "plain_ms": plain_ms,
                          **bnd, "library_ms": None}}



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
    check(rec["knn_k"] == [N_MULTI] * len(mods), "T5 ran at k+1 = 201 per modality")

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
    return launches, rec, md


def wnn_bound(name, args, out) -> dict:
    """The bound of T9-T11 on the arguments of their measured call."""
    tensors = [a for a in args if torch.is_tensor(a)]
    bytes_ = nbytes(*tensors, out)
    if name.startswith("wnn_bandwidth"):
        # per cell, C candidates: a Jaccard count of kk binary searches over
        # the cell's sorted set, a d-wide distance, a rank among C
        NI, rep16 = args[0], args[2]
        n, kk = NI.shape
        stride = args[7]
        C = kk + kk * (-(-kk // stride))
        ops = n * C * (kk * max(1, int(np.ceil(np.log2(kk)))) + 2 * rep16.shape[1]
                       + int(np.ceil(np.log2(C))))
        return bound(bytes_, ops, F32_OPS_PER_S)
    if name == "wnn_theta":
        # per row: the mean of kk neighbour rows of d, then a distance
        rep, rows1, NI2 = args[0], args[1], args[3]
        return bound(bytes_, rows1.numel() * (NI2.shape[1] + 3) * rep.shape[1], F32_OPS_PER_S)
    # fusion: per candidate a bfloat16 cross term over the table's D columns
    cand, cat16 = args[0], args[1]
    return bound(bytes_, 2 * cand.numel() * cat16.shape[1], BF16_OPS_PER_S)


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
        bnd = wnn_bound(name, args, out)
        results[name] = {"max_abs_err": diff.max().item(), "ms": ms, "plain_ms": plain_ms,
                         **bnd, "library_ms": None}
        shape = tuple(args[0].shape)
        print(f"[kernel] {name} {shape}: max_abs_err={diff.max().item():.3e} ({tol}; "
              f"largest {kind} err {err.max().item():.2e}) ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})", flush=True)
        check(ok, f"{name} within {tol}")
    return results


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings."""
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    C = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(C, (ia, ib), 1)
    comb = lambda x: x * (x - 1) / 2  # noqa: E731
    sum_a, sum_b = comb(C.sum(1)).sum(), comb(C.sum(0)).sum()
    expected = sum_a * sum_b / comb(len(ia))
    return float((comb(C).sum() - expected) / ((sum_a + sum_b) / 2 - expected))


def phase_leiden(ttl, kernels, profiling, mods, labels):
    """Multiplex Leiden over the three modality graphs, on the host."""
    md = MuHolder(mods)
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.leiden(md, resolution=1.0)
        wall = time.perf_counter() - t0
    got = md.obs["leiden"]
    a = ari(labels, got)
    stages = stage_seconds(t)
    print(f"[leiden] tl.leiden over {list(mods)}: {len(np.unique(got))} clusters, ARI "
          f"against the planted labels {a:.4f}; wall {wall:.4f}s; stages {stages}", flush=True)
    check(not any(kernels.launch_counts().values()), "Leiden launched no kernel (host)")
    check(a >= 0.9, "Leiden ARI against the planted labels >= 0.9")
    return wall


def knn_share(tk, emb, labels, cuda, k=15) -> float:
    """The planted-label share of each cell's k nearest cells in ``emb``
    (T5, exact)."""
    idx, _ = tk.knn(np.ascontiguousarray(emb), k, device=cuda)
    idx = idx[:, 1:].long().cpu().numpy()
    return float((labels[idx] == labels[:, None]).mean())


def graph_holder(mods, wnn_md):
    """A MuData-like holder carrying the WNN graph of ``wnn_md``."""
    md = MuHolder(mods)
    md.obsp, md.uns = dict(wnn_md.obsp), dict(wnn_md.uns)
    return md


def phase_umap_path(ttl, tu, tk, kernels, mods, wnn_md, labels, cuda):
    md = graph_holder(mods, wnn_md)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ttl.umap(md, device=cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    G = md.obsp["connectivities"].tocsr()
    print(f"[umap] tl.umap(mdata) on the WNN graph ({G.nnz} edges) in {wall:.4f}s "
          f"launched {launches}", flush=True)
    for name, count in UMAP_PATH.items():
        check(launches[name] == count, f"the UMAP path launched {name} {count} times")
    emb = md.obsm["X_umap"]
    check(emb.shape == (N_CELLS, 2) and emb.dtype == np.float32 and np.isfinite(emb).all(),
          "X_umap shape, float32, finite")

    # one epoch, kernel against plain, from the spectral layout with the
    # same negatives and eons
    a, b = tu.find_ab_params()
    heads, tails, eps, _, dc = tu.edge_schedule(G, N_EPOCHS)
    shift = tu.bucket_shifts(eps, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, shift, N_CELLS, cuda)
    start = tu.spectral_init(G, 2, seed=42, device=cuda)
    emb0 = torch.from_numpy(start).to(cuda)
    dct = torch.from_numpy(dc).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    negs = torch.randint(0, N_CELLS, (N_CELLS, 5), generator=gen, dtype=torch.int32, device=cuda)
    alpha0 = tu.epoch_alpha(1.0, 0, N_EPOCHS)
    args = (dct, negs, 0, alpha0, a, b, 1.0)
    eons_k, eons_p = edges.eps.clone(), edges.eps.clone()
    out_k = tu.umap_epoch(emb0, torch.empty_like(emb0), edges, eons_k, *args)
    torch.cuda.synchronize()
    out_p = tu.umap_epoch_plain(emb0, torch.empty_like(emb0), edges, eons_p, *args)
    err = (out_k - out_p).abs().max().item()
    same_eons = bool(torch.equal(eons_k, eons_p))
    # timed from the same state: each call takes fresh eons
    pools = {k: [edges.eps.clone() for _ in range(6)] for k in ("k", "p")}
    buf = torch.empty_like(emb0)
    ms = median_ms(lambda: tu.umap_epoch(emb0, buf, edges, pools["k"].pop(), *args))
    plain_ms = median_ms(lambda: tu.umap_epoch_plain(emb0, buf, edges, pools["p"].pop(), *args))
    # at epoch 0 every stride runs: each edge's shift and eons are read,
    # and a due edge's tail and eps read and its eons written; per due edge
    # and per negative about 30 operations (two powf among them)
    E = len(eps)
    due = int((eps <= 1.0).sum())
    bnd = bound(5 * E + 12 * due + nbytes(edges.indptr, dct, negs, emb0, out_k),
                30 * (due + negs.numel()), F32_OPS_PER_S)
    strides = sorted(set((1 << shift.astype(np.int64)).tolist()))
    print(f"[kernel] umap_epoch (n={N_CELLS}, E={E}, strides {strides}, due at epoch 0 "
          f"{due}): max_abs_err={err:.3e} (<= 1e-3; eons equal {same_eons}) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
          f"library_ms=None", flush=True)
    check(err <= 1e-3 and same_eons, "umap_epoch vs plain from the spectral layout, max 1e-3")
    results = {"umap_epoch": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                              "library_ms": None}}

    # the 200 epochs of the kernel and of the plain version from the same
    # start and seed (the same negatives): held by the planted-label share
    # of each cell's 15 nearest cells in the layout
    md_k = graph_holder(mods, wnn_md)
    ttl.umap(md_k, init_pos=start, device=cuda)
    md_p = graph_holder(mods, wnn_md)
    saved = tu.umap_epoch
    tu.umap_epoch = tu.umap_epoch_plain
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ttl.umap(md_p, init_pos=start, device=cuda)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        tu.umap_epoch = saved
    check(kernels.launch_counts()["umap_epoch"] == 0, "the plain UMAP launched no T13")
    s_main = knn_share(tk, emb, labels, cuda)
    s_k = knn_share(tk, md_k.obsm["X_umap"], labels, cuda)
    s_p = knn_share(tk, md_p.obsm["X_umap"], labels, cuda)
    fused = label_share(wnn_md.obsp["distances"], labels)
    print(f"[umap] planted-label share of the 15 nearest cells in 2-D: main run {s_main:.4f}, "
          f"kernel {s_k:.4f} and plain {s_p:.4f} from the same start; the fused graph's own "
          f"{fused:.4f} (chance 0.05)", flush=True)
    print(f"[times] plain-torch UMAP (200 epochs, the same start) on the card, one warm run: "
          f"{t_plain:.4f}s", flush=True)
    check(abs(s_k - s_p) <= 0.02, "UMAP kernel vs plain share within 0.02")
    check(min(s_main, s_k) >= 0.8 * fused, "UMAP share >= 0.8 x the fused graph's")
    # the same share over other seeds (negatives, init jitter and the spectral
    # init's test matrix), on the same graph: the spread a single run is drawn from
    spread = []
    for seed in range(10):
        h = graph_holder(mods, wnn_md)
        ttl.umap(h, random_state=seed, device=cuda)
        spread.append(knn_share(tk, h.obsm["X_umap"], labels, cuda))
    print(f"[umap] the same share over random_state 0-9: min {min(spread):.4f}, median "
          f"{float(np.median(spread)):.4f}, max {max(spread):.4f} "
          f"({', '.join(f'{v:.4f}' for v in spread)})", flush=True)
    # and at this run's seed from starts jittered by 1e-4: how far the checked
    # share moves under a small change of its start (the graph itself differs
    # between runs by a few hundred edges, which moves it further)
    jitter = []
    for j in range(5):
        rng = np.random.default_rng(100 + j)
        h = graph_holder(mods, wnn_md)
        ttl.umap(h, init_pos=(start + rng.normal(scale=1e-4, size=start.shape)).astype(np.float32),
                 device=cuda)
        jitter.append(knn_share(tk, h.obsm["X_umap"], labels, cuda))
    print(f"[umap] the same share from the seed-42 start jittered by 1e-4 (5 draws): "
          f"{', '.join(f'{v:.4f}' for v in jitter)}", flush=True)
    return launches, results



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
        splits.append(stage_seconds(t))
    print(f"[times] {label} warm wall s {[round(w, 4) for w in walls]} "
          f"median {float(np.median(walls)):.4f}; stages {splits}", flush=True)


def phase_times(tac, tpp, tpt, ttl, dsp, tla, tk, tf, td, profiling, X, atac_h, X_rna,
                P, wnn_mods, wnn_md, cuda) -> None:
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
    timed_reps("prot clr+pca+neighbors", lambda: P,
               lambda P_: prot_path(tpt, tpp, P_, cuda), profiling)
    print_profile("prot clr+pca+neighbors", profiled(lambda: prot_path(tpt, tpp, P, cuda)))
    timed_reps("UMAP tl.umap(mdata)", lambda: graph_holder(wnn_mods, wnn_md),
               lambda md: ttl.umap(md, device=cuda), profiling)
    print_profile("UMAP tl.umap(mdata)",
                  profiled(lambda: ttl.umap(graph_holder(wnn_mods, wnn_md), device=cuda)))

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
    t1 = time.perf_counter()
    prot_plain(tla, tk, tf, td, P, cuda)
    torch.cuda.synchronize()
    print(f"[times] plain-torch on the card, one warm run: RNA normalise+pca+neighbors "
          f"{t1 - t0:.4f}s, prot clr+pca+neighbors {time.perf_counter() - t1:.4f}s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def prot_plain(tla, tk, tf, td, P, cuda):
    """The prot path through the plain versions: T12's, the same dense PCA
    (torch only) and the plain neighbors."""
    Xc = td.clr_values_plain(torch.from_numpy(P).to(cuda), 0, seurat=True)[0]
    U, s, _, _ = tla._pca_dense(Xc, PROT_COMPS, tla.draw_omega(N_PROT, PROT_COMPS + 10,
                                                               SEED, cuda), N_ITER, True)
    return neighbors_plain(tk, tf, (U * s).cpu().numpy(), cuda)


# the noise of the 1M representation along its five leading axes; further
# axes fall as j^-2 (the decaying spectrum of a PCA)
BIG_LEADING_SCALES = (1.0, 1.0, 1.0, 1.0, 0.7)


def make_big_rep(seed: int = 0, n: int = N_BIG):
    """The 1M-cell representation and its planted labels: 40 Gaussian
    clusters whose centres are drawn N(0, 6²) along the five leading axes,
    unit noise on four of them, 0.7 on the fifth and j^-2 on the rest, so
    that some neighbouring clusters overlap (the exact 19-NN planted-label
    share is a little below 1). The shape is a compromise: the IVF index
    recalls more the fewer dimensions the clusters fill, and the 200-epoch
    UMAP layout keeps its clusters apart only from about five dimensions
    on."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, BIG_CLUSTERS, n)
    dims = len(BIG_LEADING_SCALES)
    cent = np.zeros((BIG_CLUSTERS, D_BIG), np.float32)
    cent[:, :dims] = rng.normal(size=(BIG_CLUSTERS, dims)) * 6.0
    scale = np.concatenate([BIG_LEADING_SCALES, np.arange(2, D_BIG + 2 - dims) ** -2.0])
    rep = cent[labels] + rng.standard_normal((n, D_BIG), dtype=np.float32) * scale.astype(np.float32)
    return rep, labels


def big_holder(rep):
    h = Holder(rep)
    h.obsm["X_rep"] = rep
    return h


def stage_seconds(t) -> dict:
    return {k: round(sum(v), 4) for k, v in t.items()}


def rows_recall(a: torch.Tensor, b: torch.Tensor, block: int = 100_000) -> float:
    """The mean share of each row of ``a`` found in the same row of ``b``."""
    hits = 0
    for s in range(0, a.shape[0], block):
        hits += int((a[s:s + block, :, None] == b[s:s + block, None, :]).any(-1).sum())
    return hits / a.numel()


def plain_ivf_rows(ti, X, partition, k, cuda):
    """The port's plain search over the first IVF_ITEMS work items of the
    layout that ``ivf_knn`` builds from ``partition``: the items' rows and
    each row's k neighbours (−1 where none), in the original numbering."""
    cent_np, assign_np = partition
    order, qids, ppos, pcnt, L = ti.build_ivf_layout(assign_np, cent_np, cent_np.shape[0],
                                                     8, 1024)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    order_t = to(order)
    Xs = X[order_t.long()].contiguous()
    q, pp_, pc = (to(a[:IVF_ITEMS]) for a in (qids, ppos, pcnt))
    rp, rd = ti.ivf_search_plain(Xs, q, pp_, pc, ti.item_means(Xs, q), k, L, False)
    ok = q >= 0
    nb = torch.where(torch.isinf(rd[ok]), -1, order_t[rp[ok].long()])
    return order_t[q[ok].long()].long(), nb[:, 1:].int()


def union_times(tf, C, label: str, rounds: int = 3) -> None:
    """The host fuzzy union of a tagged graph's membership table through
    the native engine and through the scipy formula, taking turns (the
    host's cores are shared, so its clock drifts within a run): the times,
    and the two graphs against each other."""
    tag = getattr(C, tf.MEMBERSHIP_TAG)
    n = tag["n"]
    t_nat, t_ref = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        nat = tf._fuzzy_union_native(tag["idx"], tag["vals"], n, 1.0)
        t1 = time.perf_counter()
        ref = tf._fuzzy_union(tag["idx"], tag["vals"], n, 1.0)
        t_nat.append(round(t1 - t0, 4))
        t_ref.append(round(time.perf_counter() - t1, 4))
    same = nat.nnz == ref.nnz and np.array_equal(nat.indices, ref.indices) \
        and np.array_equal(nat.indptr, ref.indptr)
    err = float(np.abs(nat.data - ref.data).max()) if same else float("inf")
    print(f"[union] {label}: {n} rows, {nat.nnz} edges; native {t_nat}s, scipy {t_ref}s, "
          f"medians {np.median(t_nat):.4f} and {np.median(t_ref):.4f} (scipy over native "
          f"{np.median(t_ref) / np.median(t_nat):.2f}x); same edges {same}, largest "
          f"difference {err:.2e} (<= 1e-6)", flush=True)
    check(same and err <= 1e-6, f"{label}: the native union is the scipy formula's graph")
    check((nat != C).nnz == 0, f"{label}: the path's graph is the native union")


def phase_ivf(tpp, ti, tk, tf, kernels, profiling, rep, labels, cuda):
    """pp.neighbors of 1M rows: the IVF index, T6, the native union."""
    n, k = N_BIG, N_NEIGHBORS - 1
    h = big_holder(rep)
    ti._PARTITION_CACHE.clear()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_rep", device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[ivf] pp.neighbors of {n}x{D_BIG} in {wall:.4f}s launched "
          f"{ {k_: v for k_, v in launches.items() if v} }; stages {stage_seconds(t)}",
          flush=True)
    for name, count in IVF_PATH.items():
        check(launches[name] == count, f"the IVF path launched {name} {count} times")
    check(launches["ivf_search"] >= 1, "the IVF path launched ivf_search")
    partition = list(ti._PARTITION_CACHE.values())[-1]

    # a second, warm run from an empty partition cache, for the times
    ti._PARTITION_CACHE.clear()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        tpp.neighbors(big_holder(rep), n_neighbors=N_NEIGHBORS, use_rep="X_rep", device=cuda)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    split = stage_seconds(t)
    print(f"[times] pp.neighbors at 1M, second run: {wall2:.4f}s; stages {split}", flush=True)

    # the table itself: the same search again (the partition is cached)
    X = torch.from_numpy(rep).to(cuda)
    kernels.reset_launch_counts()
    idx, dists = ti.ivf_knn(X, k)
    torch.cuda.synchronize()
    check(kernels.launch_counts()["kmeans_assign"] == 0, "the partition cache hit at k = 19")
    check(bool((idx[:, 0] == torch.arange(n, device=cuda)).all()) and bool((dists[:, 0] == 0).all()),
          "IVF: self in column 0 at distance 0")
    check(bool((idx >= 0).all()), "IVF: no -1 in the table")
    check(bool((dists[:, 2:] >= dists[:, 1:-1]).all()) and bool(torch.isfinite(dists).all()),
          "IVF: distances finite and ascending from column 1")
    D, C = h.obsp["distances"], h.obsp["connectivities"]
    check((np.diff(D.indptr) == k).all(), "IVF graph: 19 distances per row")
    path_idx = torch.from_numpy(D.indices.reshape(n, k).astype(np.int32)).to(cuda)
    check(rows_recall(idx[:, 1:], path_idx) == 1.0, "the graph holds the table's neighbours")

    # exact kNN at the same size: T5, one launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact, _ = tk.knn(X, k, method="brute", approx=False)
    torch.cuda.synchronize()
    t_brute = time.perf_counter() - t0
    recall = rows_recall(exact[:, 1:], idx[:, 1:])
    lab = torch.from_numpy(labels).to(cuda)
    share_exact = float((lab[exact[:, 1:].long()] == lab[:, None]).float().mean())
    share = float((lab[idx[:, 1:].long()] == lab[:, None]).float().mean())
    t_ivf = sum(v for k_, v in split.items() if k_.startswith("ivf/"))
    print(f"[ivf] recall over all {n} rows against exact T5 {recall:.4f} (>= 0.9); "
          f"planted-label share of the 19 neighbours: exact {share_exact:.4f}, IVF {share:.4f} "
          f"(chance {1 / BIG_CLUSTERS:.3f}); IVF stages {t_ivf:.4f}s against brute force "
          f"(T5, float32, one launch) {t_brute:.4f}s at the same size", flush=True)
    check(recall >= 0.9, "IVF recall against exact kNN >= 0.9")
    check(0.5 < share_exact < 0.999, "the planted clusters overlap: exact share below 1")

    # what the data allows and what the port loses: on the first work items,
    # the plain search of the same probe lists against ivf_knn and against exact
    rows, plain_nb = plain_ivf_rows(ti, X, partition, k, cuda)
    held = rows_recall(plain_nb, idx[rows, 1:])
    r_plain = rows_recall(exact[rows, 1:], plain_nb)
    r_ivf = rows_recall(exact[rows, 1:], idx[rows, 1:])
    print(f"[ivf] on the {len(rows)} rows of the first {IVF_ITEMS} work items: ivf_knn holds "
          f"{held:.5f} of the plain search's neighbours (>= 0.999); recall against exact: "
          f"plain search of the same probe lists {r_plain:.4f}, ivf_knn {r_ivf:.4f} "
          f"(within 0.001)", flush=True)
    check(held >= 0.999, "ivf_knn returns the plain search's neighbours")
    check(abs(r_plain - r_ivf) <= 1e-3, "ivf_knn recalls what its probe lists allow")

    t0 = time.perf_counter()
    sym = (C != C.T).nnz == 0
    check(sym, "IVF connectivities symmetric")
    check(C.data.min() > 0 and C.data.max() <= 1, "IVF connectivities in (0, 1]")
    tag = getattr(C, tf.MEMBERSHIP_TAG, None)
    check(tag is not None and tag["n"] == n and tag["nnz"] == C.nnz
          and tag["idx"].shape == (n, N_NEIGHBORS), "the membership tag on the graph")
    print(f"[ivf] graph: {C.nnz} edges, symmetric {sym}, tagged {tag is not None} "
          f"(checked in {time.perf_counter() - t0:.1f}s)", flush=True)
    union_times(tf, C, "1M graph")

    # WNN's candidate pool on the same tensor: k = 200 from the cached partition
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    idx200, _ = ti.ivf_knn(X, N_MULTI)
    torch.cuda.synchronize()
    t200 = time.perf_counter() - t0
    agree = float((idx200[:, :N_NEIGHBORS] == idx).float().mean())
    print(f"[ivf] ivf_knn at k = {N_MULTI} on the same tensor in {t200:.4f}s launched "
          f"{ {k_: v for k_, v in kernels.launch_counts().items() if v} }; its first "
          f"{N_NEIGHBORS} columns agree with the k = 19 run on {agree:.5f} of entries", flush=True)
    check(kernels.launch_counts()["kmeans_assign"] == 0, "the partition cache hit at k = 200")
    check(agree >= 0.99, "k = 200 and k = 19 agree on >= 99% of the first 20 columns")
    return launches, h, partition


def separation(emb: torch.Tensor, lab: torch.Tensor) -> float:
    """Mean distance between rows of one label over that between rows of
    two (the reference test's seed criterion)."""
    D = torch.cdist(emb, emb)
    same = lab[:, None] == lab[None, :]
    same.fill_diagonal_(False)
    other = ~(lab[:, None] == lab[None, :])
    return float(D[same].mean() / D[other].mean())


def rayleigh(A, emb: np.ndarray) -> np.ndarray:
    """u'Au / u'u of each column u of ``emb``, in float64."""
    U = emb.astype(np.float64)
    return (U * (A @ U)).sum(axis=0) / (U * U).sum(axis=0)


def phase_umap_big(ttl, tu, tk, tf, kernels, profiling, h, labels, cuda):
    """tl.umap on the 1M graph: the membership seed (T16) and T13."""
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.umap(h, device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    G = h.obsp["connectivities"]
    print(f"[umap1m] tl.umap on {G.nnz} edges in {wall:.4f}s launched "
          f"{ {k_: v for k_, v in launches.items() if v} }; stages {stage_seconds(t)}",
          flush=True)
    for name, count in UMAP_BIG_PATH.items():
        check(launches[name] == count, f"the 1M UMAP path launched {name} {count} times")
    emb = h.obsm["X_umap"]
    check(emb.shape == (N_BIG, 2) and emb.dtype == np.float32 and np.isfinite(emb).all(),
          "1M X_umap shape, float32, finite")
    # the 15 nearest cells in 2-D through the IVF index (brute force at 1M x 2
    # costs what it costs at 50 columns)
    idx, _ = tk.knn(emb, 15, method="ivf", device=cuda)
    lab = torch.from_numpy(labels).to(cuda)
    nb = idx[:, 1:].long()
    s_umap = float(((lab[nb.clamp(min=0)] == lab[:, None]) & (nb >= 0)).float().mean())
    s_graph = label_share(h.obsp["distances"], labels)
    print(f"[umap1m] planted-label share of the 15 nearest cells in 2-D {s_umap:.4f}; the "
          f"graph's own {s_graph:.4f} (chance {1 / BIG_CLUSTERS:.3f})", flush=True)
    check(s_umap >= 0.8 * s_graph, "1M UMAP share >= 0.8 x the graph's")

    # the two seeds, each held to the exact operator A = D^-1/2 G D^-1/2 of
    # the graph: a column u of a seed is as good as its Rayleigh quotient
    # u'Au/u'u is near the top of A's spectrum (1); a column of noise reads 0
    tag = getattr(G, tf.MEMBERSHIP_TAG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast = tu.spectral_init(G, 2, seed=42, membership=tag, device=cuda)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = tu.spectral_init(G, 2, seed=42, membership=None, device=cuda)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dm12 = 1.0 / np.sqrt(np.maximum(np.asarray(G.sum(axis=1)).ravel(), 1e-30))
    A = sp.diags(dm12) @ G @ sp.diags(dm12)
    rq_fast, rq_ref = rayleigh(A, fast), rayleigh(A, ref)
    noise = np.random.default_rng(7).standard_normal(fast.shape)
    rq_noise = rayleigh(A, noise)
    # how far the two 2-D subspaces lie apart, and the reference test's own
    # criterion on a fixed sample of rows, both for the record
    qf, qr = np.linalg.qr(fast.astype(np.float64))[0], np.linalg.qr(ref.astype(np.float64))[0]
    cosines = np.linalg.svd(qf.T @ qr, compute_uv=False)
    sample = np.random.default_rng(7).choice(N_BIG, SEED_SAMPLE, replace=False)
    ls = lab[torch.from_numpy(sample).to(cuda)]
    r_fast = separation(torch.from_numpy(fast[sample]).to(cuda), ls)
    r_ref = separation(torch.from_numpy(ref[sample]).to(cuda), ls)
    print(f"[umap1m] spectral seeds: membership in {t1 - t0:.4f}s, exact in {t2 - t1:.4f}s; "
          f"Rayleigh quotients under the graph's operator: membership "
          f"{[round(float(x), 5) for x in rq_fast]}, exact {[round(float(x), 5) for x in rq_ref]}, "
          f"noise {[round(float(x), 5) for x in rq_noise]} (needs 1 - membership < max(0.1, "
          f"1.3 x (1 - exact))); cosines of the principal angles between the two seeds "
          f"{[round(float(x), 4) for x in cosines]}; same-label over other-label distance on "
          f"{SEED_SAMPLE} rows: membership {r_fast:.4f}, exact {r_ref:.4f} (the reference "
          f"test's criterion needs exact < 0.8 to say anything)", flush=True)
    check(np.isfinite(fast).all()
          and 1.0 - rq_fast.min() < max(0.1, 1.3 * (1.0 - rq_ref.min())),
          "the membership seed lies as near the top of the graph's spectrum as the exact seed")
    check(1.0 - np.abs(rq_noise).max() > 0.5, "a seed of noise would fail that check")

    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.umap(h, device=cuda)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    print(f"[times] tl.umap at 1M, second run: {wall2:.4f}s; stages {stage_seconds(t)}",
          flush=True)
    return launches


def phase_big_kernels(ti, tu, tf, rep, partition, h, cuda) -> dict:
    """T14-T16 against their plain versions at the 1M path's shapes."""
    results = {}
    X = torch.from_numpy(rep).to(cuda)
    n, d = X.shape
    cent_np, assign_np = partition
    C = cent_np.shape[0]

    def report(name, shape, err, tol, ok, ms, plain_ms, bnd, lib=None, record=True):
        if record:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                             "library_ms": lib}
        print(f"[kernel] {name} {shape}: max_abs_err={err:.3e} ({tol}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 3)}", flush=True)
        check(ok, f"{name} {shape} within {tol}")

    # T15 on all rows with the partition's centroids
    cent = torch.from_numpy(cent_np).to(cuda)
    got = ti.kmeans_assign(X, cent)
    torch.cuda.synchronize()
    ref = ti.kmeans_assign_plain(X, cent)
    equal = float((got == ref).float().mean())
    rows = torch.nonzero(got != ref)[:, 0]
    x16, c16 = X[rows].bfloat16().double(), cent.bfloat16().double()
    csq = (cent.double() ** 2).sum(1)
    score = csq[None, :] - 2.0 * x16 @ c16.T
    gap = (score.gather(1, got[rows].long()[:, None]) - score.gather(1, ref[rows].long()[:, None]))
    scale = csq[got[rows].long()] + csq[ref[rows].long()] + (X[rows].double() ** 2).sum(1)
    near = bool((gap[:, 0].abs() <= 1e-5 * scale).all())
    worst = float((gap[:, 0].abs() / scale).max()) if len(rows) else 0.0
    report("kmeans_assign", (n, d, C), worst,
           f"equal on {equal:.6f} >= 0.999 of rows, the {len(rows)} others near-ties within "
           f"1e-5 of their scale", equal >= 0.999 and near,
           median_ms(lambda: ti.kmeans_assign(X, cent)),
           median_ms(lambda: ti.kmeans_assign_plain(X, cent)),
           bound(nbytes(X, cent, got), 2 * n * C * d, BF16_OPS_PER_S))

    # T14 on the first work items of the 1M layout, at the path's k and WNN's
    order, qids, ppos, pcnt, L = ti.build_ivf_layout(assign_np, cent_np, C, 8, 1024)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    Xs = X[to(order).long()].contiguous()
    q_all, pp_all, pc_all = to(qids), to(ppos), to(pcnt)
    mu_all = ti.item_means(Xs, q_all)
    q, pp_, pc, mu_ = (a[:IVF_ITEMS].contiguous() for a in (q_all, pp_all, pc_all, mu_all))
    ok_q = q >= 0
    item = torch.arange(q.shape[0], device=cuda)[:, None].expand_as(q)[ok_q]
    qsq = ((Xs[q[ok_q].long()] - mu_[item]) ** 2).sum(-1)
    pairs = float((ok_q.sum(1) * pc.sum(1)).sum())  # (query, candidate) pairs scored
    for k in (N_NEIGHBORS - 1, N_MULTI):
        args = (Xs, q, pp_, pc, mu_, k, L, False)
        gp, gd = ti.ivf_search(*args)
        torch.cuda.synchronize()
        rp, rd = ti.ivf_search_plain(*args)
        same_inf = bool(torch.equal(torch.isinf(gd), torch.isinf(rd)))
        fin = torch.isfinite(rd[ok_q])
        csq_ = ((Xs[rp[ok_q].long()] - mu_[item][:, None, :]) ** 2).sum(-1)
        diff = (gd[ok_q] - rd[ok_q]).abs()
        within = bool((diff[fin] <= 1e-5 * (qsq[:, None] + csq_)[fin]).all())
        equal = float((gp[ok_q] == rp[ok_q]).float().mean())
        # each item reads its queries and its probed rows once and writes its results
        bytes_ = 4 * d * float(ok_q.sum() + pc.sum()) + nbytes(q, pp_, pc, mu_, gp, gd)
        report("ivf_search", f"(k+1={k + 1}, {q.shape[0]} items of {qids.shape[0]}, L={L}, "
               f"P={ppos.shape[1]})", float(diff[fin].max()),
               f"|dd2| <= 1e-5(|q-mu|^2+|c-mu|^2), equal positions {equal:.5f} >= 0.99",
               same_inf and within and equal >= 0.99,
               median_ms(lambda: ti.ivf_search(*args)),
               median_ms(lambda: ti.ivf_search_plain(*args), reps=3),
               bound(bytes_, 2 * pairs * d, F32_OPS_PER_S), record=k == N_NEIGHBORS - 1)
        whole = median_ms(lambda: ti.ivf_search(Xs, q_all, pp_all, pc_all, mu_all, k, L, False),
                          reps=3)
        all_pairs = float(((q_all >= 0).sum(1) * pc_all.sum(1)).sum())
        print(f"[kernel] ivf_search over the whole 1M layout ({qids.shape[0]} items, "
              f"{all_pairs:.4g} pairs) at k+1={k + 1}: ms={whole:.3f}; by its operations "
              f"{2 * all_pairs * d / F32_OPS_PER_S * 1e3:.3f}", flush=True)

    # T16: one application over the graph's membership table
    tag = getattr(h.obsp["connectivities"], tf.MEMBERSHIP_TAG)
    op = tu.membership_operator(tag["idx"], tag["vals"], cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    Q = torch.randn((n, 10), generator=gen, device=cuda)
    Y = tu.membership_matvec(op, Q)
    torch.cuda.synchronize()
    Yp = tu.membership_matvec_plain(op, Q)
    rel = ((Y - Yp).abs().amax(0) / torch.linalg.norm(Yp, dim=0)).max().item()
    # the library call: a CSR of S = diag(s)(W + W^T)diag(s), one product
    k_ = op.idx.shape[1]
    src = torch.arange(n, device=cuda).repeat_interleave(k_)
    dst = op.idx.reshape(-1).clamp(min=0).long()
    w = op.vals.reshape(-1) * op.s[src] * op.s[dst]
    try:
        S = torch.sparse_coo_tensor(torch.stack([torch.cat([src, dst]), torch.cat([dst, src])]),
                                    torch.cat([w, w]), (n, n)).coalesce().to_sparse_csr()
        lib = library_ms(lambda: torch.sparse.mm(S, Q))
    except (RuntimeError, NotImplementedError) as e:
        print(f"[library] {str(e).splitlines()[0][:160]}", flush=True)
        lib = None
    report("membership_matvec", (n, k_, 10), (Y - Yp).abs().max().item(),
           f"largest column error {rel:.2e} <= 1e-5 of the column's norm", rel <= 1e-5,
           median_ms(lambda: tu.membership_matvec(op, Q)),
           median_ms(lambda: tu.membership_matvec_plain(op, Q), reps=3),
           # the function reads the table, s and Q and writes Y; the transposed
           # table is the kernel's own choice and no part of the bound
           bound(nbytes(op.idx, op.vals, op.s, Q, Y), 4 * op.vals.numel() * 10,
                 F32_OPS_PER_S), lib)
    return results


# ---------------------------------------------------------------------------
# repairs of earlier kernels: T13 above 8 components, T9 above kk = 194
# ---------------------------------------------------------------------------


def phase_repairs(tpp, tw, tk, tf, tu, kernels, mods, wnn_md, cuda) -> dict:
    """T13's run-time-dim kernel at 12 components against its plain version
    on the WNN graph, and ``pp.neighbors(mdata)`` over neighbour lists 250
    wide on the first 2,000 cells, which takes T9's global-memory variant
    (counted from that call alone), then that variant against plain at
    kk = 256, d = 50 on the exact neighbours of the same cells' RNA scores."""
    G = wnn_md.obsp["connectivities"].tocsr()
    a, b = tu.find_ab_params()
    heads, tails, eps, _, dc = tu.edge_schedule(G, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, tu.bucket_shifts(eps, N_EPOCHS), N_CELLS, cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    emb0 = torch.rand((N_CELLS, 12), generator=gen, device=cuda) * 20 - 10
    negs = torch.randint(0, N_CELLS, (N_CELLS, 5), generator=gen, dtype=torch.int32, device=cuda)
    args = (torch.from_numpy(dc).to(cuda), negs, 0, tu.epoch_alpha(1.0, 0, N_EPOCHS), a, b, 1.0)
    eons_k, eons_p = edges.eps.clone(), edges.eps.clone()
    kernels.reset_launch_counts()
    out_k = tu.umap_epoch(emb0, torch.empty_like(emb0), edges, eons_k, *args)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()["umap_epoch"]
    out_p = tu.umap_epoch_plain(emb0, torch.empty_like(emb0), edges, eons_p, *args)
    err = (out_k - out_p).abs().max().item()
    pools = [edges.eps.clone() for _ in range(6)]
    buf = torch.empty_like(emb0)
    ms = median_ms(lambda: tu.umap_epoch(emb0, buf, edges, pools.pop(), *args))
    print(f"[kernel] umap_epoch at 12 components (n={N_CELLS}, E={len(eps)}; the kernel that "
          f"takes dim at run time): max_abs_err={err:.3e} (<= 1e-3; eons equal "
          f"{bool(torch.equal(eons_k, eons_p))}) ms={ms:.4f}", flush=True)
    check(err <= 1e-3 and torch.equal(eons_k, eons_p) and launched == 1,
          "umap_epoch at 12 components vs plain, max 1e-3")
    del edges, emb0, negs, out_k, out_p, pools, buf

    sub = {}
    for name, key in (("rna", "X_pca"), ("atac", "X_lsi")):
        h = Holder(None)
        h.obsm[key] = np.ascontiguousarray(mods[name].obsm[key][:WIDE_CELLS])
        h.n_obs = WIDE_CELLS
        tpp.neighbors(h, n_neighbors=WIDE_KK + 1, use_rep=key, device=cuda)
        sub[name] = h
    md = MuHolder(sub, WIDE_CELLS)
    with wnn_probe(tw, tk, tf, plain=False) as rec:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tpp.neighbors(md, device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    kk = rec["bandwidth"][0][0][0].shape[1]
    print(f"[wnn-wide] pp.neighbors(mdata) over {list(sub)} on {WIDE_CELLS} cells with "
          f"neighbour lists {kk} wide in {wall:.2f}s launched "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(kk == WIDE_KK, f"the modality graphs hold {WIDE_KK} neighbours per cell")
    for name, count in WNN_WIDE_PATH.items():
        check(launches[name] == count, f"the wide WNN path launched {name} {count} times")
    D = md.obsp["distances"]
    per_row = np.diff(D.indptr)
    check(md.uns["neighbors"]["params"]["n_neighbors"] == WIDE_KK + 1
          and per_row.min() >= 1 and per_row.max() <= WIDE_KK + 2 and np.isfinite(D.data).all(),
          f"the wide WNN graph: at most {WIDE_KK + 2} fused neighbours per row, finite")

    rep = torch.from_numpy(sub["rna"].obsm["X_pca"]).to(cuda)
    d2 = torch.cdist(rep.double(), rep.double())
    d2.fill_diagonal_(float("inf"))
    NI = torch.sort(torch.topk(d2, WIDE_KK_KERNEL, dim=1, largest=False).indices,
                    dim=1).values.int().contiguous()
    bbox = float(torch.linalg.norm(rep.max(dim=0).values - rep.min(dim=0).values))
    args = (NI, *tw._bandwidth_tables(NI, rep), float(WIDE_CELLS), bbox, 20,
            tw._auto_nn_stride(WIDE_KK_KERNEL))
    kernels.reset_launch_counts()
    out = tw.wnn_bandwidth(*args)
    torch.cuda.synchronize()
    check(kernels.launch_counts()["wnn_bandwidth_global"] == 1
          and kernels.launch_counts()["wnn_bandwidth"] == 0,
          "kk = 256 takes the global-memory variant of T9")
    ref = tw.wnn_bandwidth_plain(*args)
    rel = (out - ref).abs() / ref.abs().clamp(min=1e-30)
    ms = median_ms(lambda: tw.wnn_bandwidth(*args), reps=3)
    plain_ms = median_ms(lambda: tw.wnn_bandwidth_plain(*args), reps=1)
    bnd = wnn_bound("wnn_bandwidth_global", args, out)
    print(f"[kernel] wnn_bandwidth_global {tuple(args[0].shape)} d={args[2].shape[1]}: "
          f"max_abs_err={(out - ref).abs().max().item():.3e} (rtol 1e-5 on >= 99.9% of cells, "
          f"1e-3 on all; largest rel err {rel.max().item():.2e}) ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})",
          flush=True)
    check((rel <= 1e-5).float().mean().item() >= 0.999 and rel.max().item() <= 1e-3,
          "wnn_bandwidth_global within rtol 1e-5 on >= 99.9% of cells, 1e-3 on all")
    return launches, {"wnn_bandwidth_global": {
        "max_abs_err": (out - ref).abs().max().item(), "ms": ms, "plain_ms": plain_ms, **bnd,
        "library_ms": None}}


# ---------------------------------------------------------------------------
# MOFA: T17-T20, the full-batch fit of bench.py's mode `mofa`, the e2e's SVI
# stage at 100,000 cells, and SVI at 1,000,000 cells
# ---------------------------------------------------------------------------


def mofa_bench_views(seed: int = 0):
    """bench.py::_mofa_iters_per_sec's data: planted Z (N, K), two gaussian
    views Z·W + 0.5·noise."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(MOFA_N, MOFA_K)).astype(np.float32)
    Ys = [(Z @ rng.normal(size=(MOFA_K, d)) + 0.5 * rng.normal(size=(MOFA_N, d))
           ).astype(np.float32) for d in MOFA_DS]
    return Z, Ys


def canonical_correlations(A: torch.Tensor, B: torch.Tensor) -> np.ndarray:
    """Canonical correlations of the column spaces of A and B (centred),
    in float64 on A's device."""
    A, B = A.double(), B.double().to(A.device)
    Qa = torch.linalg.qr(A - A.mean(dim=0)).Q
    Qb = torch.linalg.qr(B - B.mean(dim=0)).Q
    return torch.linalg.svdvals(Qa.T @ Qb).cpu().numpy()


def phase_mofa_kernels(tmo, Ys, cuda) -> dict:
    """T17-T20 against their plain versions at the bench's 10,000 x 3000
    (unmasked, which the JSON line records, and masked) and at the SVI
    batch's 50,000 x 256."""
    results = {}
    gen = torch.Generator(device=cuda).manual_seed(17)

    def report(name, shape, err, tol, ok, k_fn, p_fn, bnd, lib_fn=None, record=False):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        lib = library_ms(lib_fn) if lib_fn is not None else None
        if record:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                             "library_ms": lib}
        print(f"[kernel] {name} {shape}: max_abs_err={err:.3e} ({tol}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 4)}", flush=True)
        check(ok, f"{name} {shape} within {tol}")

    def within(got, ref, scale):
        return bool(((got - ref).abs() <= 1e-5 * scale + 1e-30).all())

    cases = [(torch.from_numpy(Ys[1]).to(cuda), True),
             (torch.randn((MOFA_BATCH, MOFA_COLS), generator=gen, device=cuda), False)]
    for E, main in cases:
        n, d = E.shape
        shape = f"{n}x{d}"
        Z = torch.randn((n, MOFA_K), generator=gen, device=cuda)
        SW = 0.1 * torch.randn((d, MOFA_K), generator=gen, device=cuda)
        B = (torch.rand((n, d), generator=gen, device=cuda) > 0.1).float()
        zk, swk = Z[:, 3], SW[:, 3]  # strided columns, as the sweeps hand them

        # T17: u = zk @ E, and the column sums of E^2
        u = tmo.col_dot(E, zk)
        torch.cuda.synchronize()
        ref = tmo.col_dot_plain(E, zk)
        report("mofa_col_dot", shape, (u - ref).abs().max().item(), "1e-5 x |z|.|E|",
               within(u, ref, zk.abs() @ E.abs()), lambda: tmo.col_dot(E, zk),
               lambda: tmo.col_dot_plain(E, zk),
               bound(nbytes(E, u) + 4 * n, 2 * n * d, F32_OPS_PER_S),
               lambda: torch.mv(E.T, zk), record=main)
        ss = tmo.col_dot(E)
        ref = tmo.col_dot_plain(E)
        report("mofa_col_dot", f"{shape} squares", (ss - ref).abs().max().item(),
               "rtol 1e-5", within(ss, ref, ref), lambda: tmo.col_dot(E),
               lambda: tmo.col_dot_plain(E), bound(nbytes(E, ss), 2 * n * d, F32_OPS_PER_S),
               lambda: (E * E).sum(dim=0))
        check(torch.equal(ss, tmo.col_dot(E)) and torch.equal(u, tmo.col_dot(E, zk)),
              f"mofa_col_dot {shape} gives the same bits twice")

        # T18: the posterior of factor 3 of view 1, full-batch and scaled,
        # with a scalar (unmasked) and a per-feature (masked) z2
        tau = 1.0 / E.var(dim=0)
        zz = Z * Z
        z2 = 1.0 + zz
        hyper = [torch.full((2, MOFA_K), v, device=cuda)
                 for v in (1.0, 0.0, float(np.log(0.99)), float(np.log(0.01)))]
        Ws = [torch.zeros((d, MOFA_K), device=cuda), torch.ones((d, MOFA_K), device=cuda),
              torch.full((d, MOFA_K), 0.5, device=cuda), SW.clone()]
        for tag, z2_k, zz_k, scale in (
            ("unmasked", z2.sum(dim=0)[3], zz.sum(dim=0)[3], None),
            ("masked, scaled", (z2.T @ B)[3] * 20.0, (zz.T @ B)[3] * 20.0, 20.0),
        ):
            Wk, Wp = [w.clone() for w in Ws], [w.clone() for w in Ws]
            dk = tmo.w_posterior(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wk, scale=scale)
            torch.cuda.synchronize()
            dp = tmo.w_posterior_plain(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wp, scale=scale)
            errs = [(g - r).abs() for g, r in zip([dk, *Wk], [dp, *Wp])]
            ok = all(bool((e <= 1e-6 + 1e-5 * r.abs()).all())
                     for e, r in zip(errs, [dp, *Wp]))
            # per feature: u, tau, the old sw and (masked) z2, zz in; 4 columns and delta out
            bytes_ = 4 * d * (8 + (2 if z2_k.dim() else 0))
            report("mofa_w_posterior", f"D={d} {tag}", max(e.max().item() for e in errs),
                   "rtol 1e-5 atol 1e-6, every output", ok,
                   lambda: tmo.w_posterior(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wk, scale=scale),
                   lambda: tmo.w_posterior_plain(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wp,
                                                 scale=scale),
                   bound(bytes_, 40 * d, F32_OPS_PER_S), record=main and scale is None)

        # T19: r = E @ t, and with the mask B @ t1, B @ t2 from the same pass
        r = tmo.row_dot(E, swk)
        torch.cuda.synchronize()
        ref = tmo.row_dot_plain(E, swk)
        report("mofa_row_dot", shape, (r - ref).abs().max().item(), "1e-5 x |E|.|t|",
               within(r, ref, E.abs() @ swk.abs()), lambda: tmo.row_dot(E, swk),
               lambda: tmo.row_dot_plain(E, swk),
               bound(nbytes(E, r) + 4 * d, 2 * n * d, F32_OPS_PER_S),
               lambda: torch.mv(E, swk), record=main)
        t1, t2 = SW[:, 1], SW[:, 2]
        got = tmo.row_dot(E, swk, B, t1, t2)
        torch.cuda.synchronize()
        refs = tmo.row_dot_plain(E, swk, B, t1, t2)
        scales = (E.abs() @ swk.abs(), B @ t1.abs(), B @ t2.abs())
        report("mofa_row_dot", f"{shape} masked",
               max((g - q).abs().max().item() for g, q in zip(got, refs)),
               "1e-5 x |E|.|t|, |B|.|t1|, |B|.|t2|",
               all(within(g, q, s_) for g, q, s_ in zip(got, refs, scales)),
               lambda: tmo.row_dot(E, swk, B, t1, t2),
               lambda: tmo.row_dot_plain(E, swk, B, t1, t2),
               bound(nbytes(E, B, *got) + 12 * d, 6 * n * d, F32_OPS_PER_S))

        # T20: E += x (x) y in place (times B where masked); timed on a copy
        for tag, Bm in (("", None), (" masked", B)):
            Ek, Ep = E.clone(), E.clone()
            tmo.rank1_update(Ek, zk, swk, Bm)
            torch.cuda.synchronize()
            tmo.rank1_update_plain(Ep, zk, swk, Bm)
            err = (Ek - Ep).abs().max().item()
            report("mofa_rank1_update", shape + tag, err, "1e-6 x (|E| + |x y|)",
                   bool(((Ek - Ep).abs() <= 1e-6 * (Ep.abs() + (zk[:, None] * swk[None, :]).abs())
                         ).all()),
                   lambda: tmo.rank1_update(Ek, zk, swk, Bm),
                   lambda: tmo.rank1_update_plain(Ep, zk, swk, Bm),
                   bound(2 * nbytes(E) + (nbytes(B) if Bm is not None else 0) + 4 * (n + d),
                         (3 if Bm is not None else 2) * n * d, F32_OPS_PER_S),
                   (lambda: Ek.addr_(zk, swk)) if Bm is None else None,
                   record=main and Bm is None)
            del Ek, Ep
        del E, Z, SW, B
    torch.cuda.empty_cache()
    return results


@contextmanager
def mofa_plain(tmo):
    """Route T17-T20 to their plain versions for the block (only this script
    swaps the module attributes; they are restored after)."""
    names = ("col_dot", "w_posterior", "row_dot", "rank1_update")
    saved = {n: getattr(tmo, n) for n in names}
    try:
        for n in names:
            setattr(tmo, n, getattr(tmo, f"{n}_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(tmo, n, fn)


def check_mofa_launches(launches, sweeps: int, what: str) -> None:
    want = mofa_launches(sweeps)
    got = {k: launches[k] for k in want}
    check(got == want, f"{what} launched {want} (K·M + M, K·M, K·M, 2·K·M per sweep), "
                       f"read {got}")


def phase_mofa_full(tm, tmo, kernels, profiling, Zp, Ys, cuda):
    """bench.py's mode `mofa`: 2 warm-up sweeps, then 50, counted and timed
    from ``fit_mofa`` alone."""
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(convergence_mode="slow", elbo_every=1000, device=cuda)
    t0 = time.perf_counter()
    tm.fit_mofa(Ys, cfg, n_iterations=MOFA_WARM, min_iterations=MOFA_WARM, **kw)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profiling.collect() as t:
        t0 = time.perf_counter()
        again = tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS, **kw)
        wall_staged = time.perf_counter() - t0
    cc = canonical_correlations(torch.from_numpy(res.Z).to(cuda), torch.from_numpy(Zp))
    print(f"[mofa] fit_mofa {MOFA_N} x {MOFA_DS}, K={MOFA_K}: warm-up {MOFA_WARM} sweeps "
          f"{t_warm:.3f}s; {MOFA_SWEEPS} sweeps in {wall:.4f}s = {MOFA_SWEEPS / wall:.2f} "
          f"sweeps/s (upload, init and the R2 statistics included, as the bench times them); "
          f"peak device memory {peak:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[mofa] stage split of a second fit under the stage timers ({wall_staged:.4f}s): "
          f"{stage_seconds(t)}", flush=True)
    print(f"[mofa] canonical correlations of Z with the planted Z: min {cc.min():.4f}, "
          f"median {float(np.median(cc)):.4f}; ELBO after sweep 1 {res.elbo_history[0]:.6g}, "
          f"after {MOFA_SWEEPS} {res.elbo_history[-1]:.6g}; r2_total "
          f"{[round(float(v), 4) for v in res.r2_total[0]]}", flush=True)
    check_mofa_launches(launches, MOFA_SWEEPS, f"{MOFA_SWEEPS} full-batch sweeps")
    check(res.Z.shape == (MOFA_N, MOFA_K) and np.isfinite(res.Z).all()
          and all(np.isfinite(w).all() for w in res.W), "MOFA Z and W shapes, finite")
    check(res.n_iterations == MOFA_SWEEPS, f"fit_mofa ran {MOFA_SWEEPS} sweeps")
    check(cc.min() > 0.9, "smallest canonical correlation of Z with the planted Z > 0.9")
    same = np.array_equal(res.Z, again.Z) and all(
        np.array_equal(a, b) for a, b in zip(res.W + res.tau, again.W + again.tau)) \
        and np.array_equal(res.elbo_history, again.elbo_history)
    check(same, "two fits give identical bits (Z, W, tau, ELBO)")

    # one sweep through the kernels against the plain path, from the state
    # after two sweeps: every leaf within 1e-4 of the leaf's largest entry
    onehot = np.ones((MOFA_N, 1), np.float32)
    cfg1 = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"), n_groups=1)
    step = tm.make_step(cfg1, list(MOFA_DS), MOFA_N, [False, False])
    state = tm._init_state(Ys, [None, None], onehot, cfg1, device=cuda)
    for _ in range(2):
        state, _ = step(state)
    got, elbo_k = step(state)
    with mofa_plain(tmo):
        kernels.reset_launch_counts()
        ref, elbo_p = step(state)
        check(not any(kernels.launch_counts().values()), "the plain sweep launched no kernel")
    worst, worst_leaf = 0.0, ""
    for key, val in ref.items():
        for i, r in enumerate(val if isinstance(val, list) else [val]):
            if r is None:
                continue
            g = got[key][i] if isinstance(val, list) else got[key]
            rel = ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
            if rel > worst:
                worst, worst_leaf = rel, f"{key}[{i}]"
    elbo_rel = abs(float(elbo_k) - float(elbo_p)) / abs(float(elbo_p))
    print(f"[mofa] one sweep, kernels against the plain path from the same state: largest "
          f"leaf error {worst:.2e} of the leaf's largest entry ({worst_leaf}), ELBO rel "
          f"{elbo_rel:.2e} (<= 1e-4)", flush=True)
    check(worst <= 1e-4 and elbo_rel <= 1e-4, "one MOFA sweep vs the plain path within 1e-4")
    del state, got, ref

    # the ELBO of every sweep: coordinate ascent never lets it fall
    e = tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS,
                    convergence_mode="slow", elbo_every=1, device=cuda).elbo_history
    drop = float((-(np.diff(e)) / np.abs(e[:-1])).max())
    print(f"[mofa] ELBO of each of {len(e)} sweeps: largest relative fall {max(drop, 0):.2e} "
          f"(<= 1e-5)", flush=True)
    check(len(e) == MOFA_SWEEPS and drop <= 1e-5, "the ELBO never falls by more than 1e-5")

    # the plain path's 50 sweeps, for the time only
    with mofa_plain(tmo):
        t0 = time.perf_counter()
        tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS, **kw)
        torch.cuda.synchronize()
        print(f"[times] plain-torch MOFA ({MOFA_SWEEPS} sweeps) on the card, one warm run: "
              f"{time.perf_counter() - t0:.4f}s", flush=True)
    torch.cuda.empty_cache()
    return launches


def topvar_dense(dsp, X, cuda, dn: int) -> torch.Tensor:
    """bench_e2e.py's ``topvar_dense``: the ``dn`` columns of a CSR matrix of
    largest variance (from the device column sums of X and X²), as a dense
    (n, dn) tensor that stays on the device."""
    dX = dsp.from_scipy(X, cuda)
    n = dX.n_rows
    cs = dsp.col_sums(dX)
    c2 = dsp.col_sums(dX._replace(data=dX.data ** 2))
    var = c2 / n - (cs / n) ** 2
    sel = torch.argsort(-var, stable=True)[:dn]
    lut = torch.zeros(dX.n_cols, dtype=torch.int64, device=cuda)
    lut[sel] = torch.arange(1, dn + 1, device=cuda)
    # scatter-add into an (n, dn + 1) grid; column 0 collects the unselected
    dest = dsp._row_ids(dX) * (dn + 1) + lut[dX.indices.long()]
    out = torch.zeros(n * (dn + 1), dtype=torch.float32, device=cuda)
    out.index_add_(0, dest, dX.data)
    return out.reshape(n, dn + 1)[:, 1:]


def label_probe_r2(rep, labels) -> float:
    """bench_e2e.py's gate: R² of regressing one-hot(labels) on [rep, 1]."""
    R = np.asarray(rep, dtype=np.float64)
    n = len(R)
    sub = np.random.default_rng(1).choice(n, size=min(n, 100_000), replace=False)
    Rs = np.column_stack([R[sub], np.ones(len(sub))])
    Yoh = np.eye(N_CLUSTERS)[labels[sub]]
    resid = Yoh - Rs @ np.linalg.lstsq(Rs, Yoh, rcond=None)[0]
    return float(1.0 - (resid ** 2).sum() / ((Yoh - Yoh.mean(0)) ** 2).sum())


def phase_mofa_e2e(tm, dsp, kernels, profiling, X_rna_norm, X_atac_tfidf, rna_pca, labels, cuda):
    """The e2e's MOFA stage at 100,000 cells: the 256 most variable columns
    of the normalised RNA and the TF-IDF ATAC matrices, selected and kept on
    the device, then stochastic VI."""
    t0 = time.perf_counter()
    views = [topvar_dense(dsp, X, cuda, MOFA_COLS) for X in (X_rna_norm, X_atac_tfidf)]
    torch.cuda.synchronize()
    t_sel = time.perf_counter() - t0
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(n_iterations=MOFA_ITERS, min_iterations=20, svi_mode=True,
              svi_batch_fraction=min(MOFA_BATCH / N_CELLS, 1.0), elbo_every=5, device=cuda)
    tm.fit_mofa(views, cfg, **{**kw, "n_iterations": 2})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tm.fit_mofa(views, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profiling.collect() as t:
        tm.fit_mofa(views, cfg, **kw)
    mofa_r2, pca_r2 = label_probe_r2(res.Z, labels), label_probe_r2(rna_pca[:, :MOFA_K], labels)
    print(f"[mofa-e2e] hvg.select {t_sel:.3f}s (two {N_CELLS} x {MOFA_COLS} views on the "
          f"device); fit_mofa SVI {MOFA_ITERS} iterations of {MOFA_BATCH} cells in {wall:.4f}s "
          f"({wall / MOFA_ITERS * 1e3:.2f} ms/iteration); peak device memory {peak:.2f} GiB; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[mofa-e2e] stage split of a second fit: {stage_seconds(t)}", flush=True)
    print(f"[mofa-e2e] label-probe R2 of Z {mofa_r2:.4f} (first {MOFA_K} PCA components "
          f"{pca_r2:.4f}; the gate: above max(0.2, 0.8 x that)); objective first "
          f"{res.elbo_history[0]:.6g}, last {res.elbo_history[-1]:.6g}", flush=True)
    check_mofa_launches(launches, MOFA_ITERS, f"{MOFA_ITERS} SVI iterations at 100k")
    check(res.Z.shape == (N_CELLS, MOFA_K) and np.isfinite(res.Z).all(), "e2e MOFA Z finite")
    check(res.n_iterations == MOFA_ITERS, f"the e2e's SVI ran {MOFA_ITERS} iterations")
    check(mofa_r2 > max(0.2, 0.8 * pca_r2), "MOFA label-probe R2 above max(0.2, 0.8 x PCA's)")
    return launches


def phase_mofa_big(tm, kernels, profiling, cuda):
    """SVI at 1,000,000 cells: two (1M, 256) gaussian views from a planted Z,
    made on the device from a seed."""
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    Zp = torch.randn((N_BIG, MOFA_K), generator=gen, device=cuda)
    views = []
    for _ in range(2):
        W = torch.randn((MOFA_K, MOFA_COLS), generator=gen, device=cuda)
        views.append(Zp @ W + 0.5 * torch.randn((N_BIG, MOFA_COLS), generator=gen, device=cuda))
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(n_iterations=MOFA_ITERS, min_iterations=20, svi_mode=True,
              svi_batch_fraction=MOFA_BATCH / N_BIG, elbo_every=5, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        res = tm.fit_mofa(views, cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = stage_seconds(t)
    sweep_s = sum(v for k, v in stages.items() if k not in ("mofa/init", "mofa/r2_stats"))
    cc = canonical_correlations(torch.from_numpy(res.Z).to(cuda), Zp)
    print(f"[mofa-1m] fit_mofa SVI on two {N_BIG} x {MOFA_COLS} views, {MOFA_ITERS} iterations "
          f"of {MOFA_BATCH} cells: wall {wall:.3f}s under the stage timers, "
          f"{sweep_s / MOFA_ITERS * 1e3:.2f} ms/iteration in the sweeps; peak device memory "
          f"{peak:.2f} GiB (the views included); stages {stages}", flush=True)
    print(f"[mofa-1m] canonical correlations of Z with the planted Z: min {cc.min():.4f}, "
          f"median {float(np.median(cc)):.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check_mofa_launches(launches, MOFA_ITERS, f"{MOFA_ITERS} SVI iterations at 1M")
    check(res.Z.shape == (N_BIG, MOFA_K) and np.isfinite(res.Z).all(), "1M MOFA Z finite")
    check(cc.min() > 0.9, "1M SVI: smallest canonical correlation with the planted Z > 0.9")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import native
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import prot as tpt
    from muon_tpu_torch import tl as ttl
    from muon_tpu_torch.models import mofa as tm
    from muon_tpu_torch.ops import _kernels as kernels
    from muon_tpu_torch.ops import dense as td
    from muon_tpu_torch.ops import fuzzy as tf
    from muon_tpu_torch.ops import ivf as ti
    from muon_tpu_torch.ops import knn as tk
    from muon_tpu_torch.ops import linalg as tla
    from muon_tpu_torch.ops import mofa as tmo
    from muon_tpu_torch.ops import sparse as dsp
    from muon_tpu_torch.ops import umap as tu
    from muon_tpu_torch.ops import wnn as tw
    from muon_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    cuda = torch.device("cuda", 0)
    smi = phase_device(kernels)
    phase_build(kernels, native)

    t0 = time.perf_counter()
    X = make_counts(SEED)
    print(f"[data] ATAC {X.shape[0]}x{X.shape[1]} nnz={X.nnz} made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    X_rna, X_atac_e2e, P, labels = make_e2e_counts(SEED)
    print(f"[data] e2e RNA {X_rna.shape[0]}x{X_rna.shape[1]} nnz={X_rna.nnz}, ATAC "
          f"{X_atac_e2e.shape[0]}x{X_atac_e2e.shape[1]} nnz={X_atac_e2e.nnz}, prot "
          f"{P.shape[0]}x{P.shape[1]} dense, {N_CLUSTERS} planted clusters, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    results = phase_kernels(dsp, dsp.from_scipy(X, cuda), cuda)
    atac_launches, gather_launches, atac_h = phase_atac_path(
        tac, tpp, dsp, tla, kernels, X, cuda)
    rna_launches, rna_h = phase_rna_path(dsp, tla, tpp, tk, tf, kernels, X_rna, labels, cuda)
    union_times(tf, rna_h.obsp["connectivities"], "RNA graph at 100k")
    results.update(phase_neighbors_kernels(dsp, tk, tf, X_rna, rna_h.obsm["X_pca"], cuda))
    prot_launches, prot_h = phase_prot_path(tpt, tpp, tla, td, kernels, P, labels, cuda)
    results.update(phase_dense_kernels(td, P, cuda))
    t0 = time.perf_counter()
    wnn_mods = {"rna": rna_h, "atac": atac_e2e_path(tac, tpp, X_atac_e2e, cuda),
                "prot": prot_h}
    print(f"[wnn] e2e ATAC tfidf -> lsi -> neighbors in {time.perf_counter() - t0:.1f}s",
          flush=True)
    wnn_launches, wnn_rec, wnn_md = phase_wnn_path(tpp, tw, tk, tf, kernels, wnn_mods,
                                                   labels, cuda)
    results.update(phase_wnn_kernels(tw, wnn_rec))
    del wnn_rec
    phase_leiden(ttl, kernels, profiling, wnn_mods, labels)
    umap_launches, umap_results = phase_umap_path(ttl, tu, tk, kernels, wnn_mods, wnn_md,
                                                  labels, cuda)
    results.update(umap_results)
    phase_times(tac, tpp, tpt, ttl, dsp, tla, tk, tf, td, profiling, X, atac_h, X_rna, P,
                wnn_mods, wnn_md, cuda)
    wide_launches, wide_results = phase_repairs(tpp, tw, tk, tf, tu, kernels, wnn_mods, wnn_md,
                                                cuda)
    results.update(wide_results)
    mofa_e2e_launches = phase_mofa_e2e(tm, dsp, kernels, profiling, rna_h.X,
                                       wnn_mods["atac"].X, rna_h.obsm["X_pca"], labels, cuda)
    del X, X_rna, X_atac_e2e, P, atac_h, rna_h, prot_h, wnn_mods, wnn_md
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    Z_planted, mofa_views = mofa_bench_views(SEED)
    print(f"[data] MOFA bench views {MOFA_N} x {MOFA_DS}, K={MOFA_K} planted factors, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    results.update(phase_mofa_kernels(tmo, mofa_views, cuda))
    mofa_launches_full = phase_mofa_full(tm, tmo, kernels, profiling, Z_planted, mofa_views,
                                         cuda)
    del Z_planted, mofa_views

    t0 = time.perf_counter()
    rep, big_labels = make_big_rep(SEED)
    print(f"[data] 1M path: representation {rep.shape[0]}x{rep.shape[1]} float32, "
          f"{BIG_CLUSTERS} planted clusters, made in {time.perf_counter() - t0:.1f}s", flush=True)
    ivf_launches, big_h, partition = phase_ivf(tpp, ti, tk, tf, kernels, profiling, rep,
                                               big_labels, cuda)
    umap_big_launches = phase_umap_big(ttl, tu, tk, tf, kernels, profiling, big_h,
                                       big_labels, cuda)
    results.update(phase_big_kernels(ti, tu, tf, rep, partition, big_h, cuda))
    print(f"[times] peak device memory with the 1M path "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del rep, big_labels, big_h, partition
    torch.cuda.empty_cache()
    mofa_big_launches = phase_mofa_big(tm, kernels, profiling, cuda)
    by_path = {"atac": atac_launches, "rna": rna_launches, "prot": prot_launches,
               "wnn": wnn_launches, "umap": umap_launches, "ivf": ivf_launches,
               "umap1m": umap_big_launches, "wnn_wide": wide_launches,
               "mofa": mofa_launches_full, "mofa_e2e": mofa_e2e_launches,
               "mofa_1m": mofa_big_launches}
    print("[launches] by path (each from 0 just before it): " + "; ".join(
        f"{p} " + ", ".join(f"{k} {v}" for k, v in c.items() if v) for p, c in by_path.items())
        + f"; gather rSVD side run " + ", ".join(
        f"{k} {v}" for k, v in gather_launches.items() if v), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} checks failed: {FAILED}", file=sys.stderr)
        return 1

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
