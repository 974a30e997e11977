"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA device, nvcc

The main path is the repository's headline workload: ``atac.pp.tfidf``
then ``atac.tl.lsi(n_comps=50)`` on synthetic ATAC counts, 100,000 cells ×
25,000 peaks, 250 draws per cell with Pareto(1.2) peak popularity (the
recipe of ``bench.py::make_counts``, seed 0), through ``muon_tpu_torch``.

Phases, one line each; any failure raises and the exit code is not 0:

1. device: the card, the torch/CUDA/nvcc versions, which optional modules import;
2. build: compile the CUDA kernels from ``muon_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, with its tolerance, and both times (median of 5, CUDA events);
4. main path: tfidf + lsi with the launch counters reset just before and
   read just after, then the gather rSVD on the same matrix with its own
   counts; checks of shapes, finiteness,
   z-scoring, the TF-IDF values against scipy, and the singular values
   against the plain-PyTorch path with the same Ω;
5. times: the warm tfidf + lsi wall over 3 reps with its stage split, and
   the plain-PyTorch path once.

The last three lines are a JSON object of the kernels (``launches`` counts
tfidf + lsi, ``gather_launches`` the gather rSVD), the card's name and
power limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from scipy import sparse as sp

N_CELLS, N_PEAKS, NNZ_PER_CELL = 100_000, 25_000, 250
K, N_ITER, SEED = 50, 7, 0
L = K + 10
SOURCE = "muon_tpu_torch/csrc/sparse_kernels.cu"
REPLACES = {
    "tfidf_values": "muon_tpu/ops/sparse.py:790",      # _tfidf_fn
    "csr_spmm_f32": "muon_tpu/ops/sparse.py:590",      # _spmm_fn, transpose=False
    "csr_spmm_bf16": "muon_tpu/ops/sparse.py:590",
    "csr_spmm_t_f32": "muon_tpu/ops/sparse.py:590",    # _spmm_fn, transpose=True
    "csr_spmm_t_bf16": "muon_tpu/ops/sparse.py:590",
    "csr_gram_matmul": "muon_tpu/ops/linalg.py:109",   # _rsvd_blocks_fn
}
# what tfidf + lsi launches at this size (auto takes the XtX path), and what
# the gather rSVD launches on the same matrix
MAIN_PATH = ("tfidf_values", "csr_spmm_f32", "csr_gram_matmul")
GATHER_PATH = ("csr_spmm_bf16", "csr_spmm_t_bf16", "csr_spmm_t_f32")


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.layers = X, {}, {}, {}, {}


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


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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


def phase_main_path(tac, dsp, tla, kernels, X, cuda) -> dict:
    h = Holder(X.copy())
    kernels.reset_launch_counts()
    tac.pp.tfidf(h, device=cuda)
    tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # the side run: the gather rSVD, which lsi takes below 2M nonzeros, on
    # the same matrix; its launches are counted apart from the main path's
    kernels.reset_launch_counts()
    _, s_gather, _ = tla.randomized_svd(h.X, k=K, n_iter=N_ITER, seed=SEED,
                                        method="gather", device=cuda)
    torch.cuda.synchronize()
    gather_launches = kernels.launch_counts()
    print(f"[main] container=Holder launches by tfidf+lsi {launches}; "
          f"by the gather rSVD {gather_launches}", flush=True)
    check(tla._blocks_profitable(N_CELLS, N_PEAKS, X.nnz, L), "XtX path chosen by auto")
    for name in MAIN_PATH:
        check(launches[name] > 0, f"tfidf+lsi launched {name}")
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
    print(f"[main] X_lsi {emb.shape} |mean|<={mean_err:.2e} |std-1|<={std_err:.2e}; "
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
    print(f"[main] s[0]={s[0]:.4f} s[-1]={s[-1]:.4f}; "
          f"s vs plain, same omega: XtX {rel_xtx:.2e} gather {rel_gather:.2e}; "
          f"gather vs XtX: {rel_algos_7:.2e} at {N_ITER} iterations, "
          f"{rel_algos:.2e} at 30", flush=True)
    check(rel_xtx <= 1e-4, "XtX singular values vs the plain path, rtol 1e-4")
    check(rel_gather <= 1e-4, "gather singular values vs the plain path, rtol 1e-4")
    check(rel_algos <= 1e-3, "gather vs XtX singular values at 30 iterations, rtol 1e-3")
    return launches, gather_launches


def phase_times(tac, dsp, tla, profiling, X, cuda) -> None:
    walls, splits = [], []
    for _ in range(3):
        h = Holder(X.copy())
        torch.cuda.synchronize()
        with profiling.collect() as t:
            t0 = time.perf_counter()
            tac.pp.tfidf(h, device=cuda)
            tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
            walls.append(time.perf_counter() - t0)
        splits.append({k: round(sum(v), 4) for k, v in t.items()})
    print(f"[times] tfidf+lsi warm wall s {[round(w, 4) for w in walls]} "
          f"median {float(np.median(walls)):.4f}; stages {splits}", flush=True)

    # one more warm rep under the profiler: device busy share of the wall
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    h = Holder(X.copy())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tac.pp.tfidf(h, device=cuda)
        tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
        wall = time.perf_counter() - t0
    # device-side events only: a host op (aten::copy_) also carries the
    # device time of what it launched, and CUPTI adds its own buffer events
    dev = {e.key: e.device_time_total / 1e6 for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0
           and e.key != "Activity Buffer Request"}
    copies = sum(v for k, v in dev.items() if k.startswith(("Memcpy", "Memset")))
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] profiled wall {wall:.4f}s; device busy {busy:.4f}s "
          f"({busy / wall:.1%} of the wall; copies/memsets {copies:.4f}s); top "
          + "; ".join(f"{k[:60]} {v * 1e3:.3f}ms" for k, v in top), flush=True)

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
    print(f"[times] plain-torch tfidf+lsi on the card, one warm run: "
          f"{time.perf_counter() - t0:.4f}s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch.ops import _kernels as kernels
    from muon_tpu_torch.ops import linalg as tla
    from muon_tpu_torch.ops import sparse as dsp
    from muon_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    cuda = torch.device("cuda", 0)
    smi = phase_device(kernels)
    phase_build(kernels)

    t0 = time.perf_counter()
    X = make_counts(SEED)
    print(f"[data] {X.shape[0]}x{X.shape[1]} nnz={X.nnz} made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    results = phase_kernels(dsp, dsp.from_scipy(X, cuda), cuda)
    launches, gather_launches = phase_main_path(tac, dsp, tla, kernels, X, cuda)
    phase_times(tac, dsp, tla, profiling, X, cuda)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "gather_launches": gather_launches[name],
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
