"""T33 ``nmf_update`` (csrc/decomp_kernels.cu) on the card phase by phase:
the Gram's partials, their fold and the update, each launched alone, in
this tree and in another tree's source, at ``[scopen]``'s two updates.

Run on a machine with a CUDA card, from the root of the repo, after
``python3 exp_compare_trees.py make DIR t33`` has written the inputs (the
starts W and Hᵀ from seed 0 and the two numerators), with the other tree
unpacked in OTHER (``git archive <commit> | tar -x -C OTHER``):

    python3 exp_t33_variants.py OTHER DIR OUT

Each build is a source with a C entry ``lab_phase`` appended that launches
one phase alone (its kernels as the source's ``mt_nmf_update`` launches
them), compiled with the package's nvcc flags into OUT/NAME.so, all builds
started together: ``other`` (OTHER's source: phases 0-2 its partial Gram,
its fold and its update), ``committed`` (this tree's: phases 0-2, and phase
3 a Gram whose last block to finish folds all of G, counted by a
done counter it resets, in place of the fold's own launch; phase 4 an
empty kernel, the floor of a launch's time so measured), and this
tree's with one constant or one thread mapping changed (``VARIANTS``: the
same bits), or with a part of a phase left out for the time of the rest
(``PARTS``, whose outputs are other bits). Per build and update: each phase's time (CUDA
events around its launch, a spin queued before the start, median of 7 after
a warm one), the three in a row, each kernel's own device time under
``torch.profiler`` (mean of 10), and whether the output and G are the
committed build's bits. Prints one JSON object with the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import nmf as tnmf

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LAB_ARGS = [_I, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P]
# the other tree's three kernels, launched as its mt_nmf_update launches them
OTHER_PHASES = """
extern "C" int lab_phase(int p, const float* F, const float* N, const float* O, int rows,
                         int other_rows, int k, float alpha, int chunk, int n_chunks,
                         float* part, float* G, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t kk = (int64_t)k * k;
  if (p == 0) nmf_gram_partial_kernel<<<n_chunks, kThreads, 0, s>>>(O, other_rows, k, chunk, part);
  if (p == 1)
    nmf_gram_reduce_kernel<<<(unsigned)((kk + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        part, n_chunks, kk, G);
  if (p == 2) {
    int64_t blocks = ((int64_t)k * rows + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    nmf_update_kernel<<<(int)blocks, kThreads, 0, s>>>(F, N, G, k, rows, alpha, out);
  }
  return (int)cudaGetLastError();
}
"""
# this tree's kernels, the Gram with the fold in its last block, and an empty launch
PHASES = """
__device__ unsigned int lab_done = 0;

__global__ void lab_empty_kernel() {}

__global__ void __launch_bounds__(kGramThreads)
lab_gram_fold_kernel(const float* __restrict__ O, int other_rows, int k, int chunk,
                     float* __restrict__ part, float* __restrict__ G) {
  extern __shared__ __align__(16) float s_rows[];
  __shared__ bool last;
  gram_partial(O, other_rows, k, chunk, blockIdx.x, part, s_rows);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&lab_done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e0 = 0; e0 < k * (k + 1) / 2; e0 += kFoldEntries)
    fold_entries(part, gridDim.x, k, e0, G, s_rows);
  if (threadIdx.x == 0) lab_done = 0;
}

extern "C" int lab_phase(int p, const float* F, const float* N, const float* O, int rows,
                         int other_rows, int k, float alpha, int chunk, int n_chunks,
                         float* part, float* G, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t ok = allow_smem(gram_smem_bytes(k));
  if (ok != cudaSuccess) return (int)ok;
  if (p == 0)
    nmf_gram_partial_kernel<<<n_chunks, kGramThreads, gram_smem_bytes(k), s>>>(
        O, other_rows, k, chunk, part);
  if (p == 1)
    nmf_gram_fold_kernel<<<(k * (k + 1) / 2 + kFoldEntries - 1) / kFoldEntries, kFoldThreads, 0,
                           s>>>(part, n_chunks, k, G);
  if (p == 2)
    nmf_update_rows_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kRowThreads, 0, s>>>(
        F, N, G, k, rows, alpha, out);
  if (p == 3) {
    const size_t smem = kFoldTile * sizeof(float);  // the fold's, above the Gram's at k = 30
    lab_gram_fold_kernel<<<n_chunks, kGramThreads, smem, s>>>(O, other_rows, k, chunk, part, G);
  }
  if (p == 4) lab_empty_kernel<<<1, 32, 0, s>>>();
  return (int)cudaGetLastError();
}
"""


# name -> (pattern, replacement) on this tree's source, each found once: one
# constant or mapping changed (the same bits)
VARIANTS = {
    "split2": (r"constexpr int kRowSplit = 4;", "constexpr int kRowSplit = 2;"),
    "parts2": (r"constexpr int kGramParts = 4;", "constexpr int kGramParts = 2;"),
    "rows64": (r"constexpr int kRowsPerBlock = 128;", "constexpr int kRowsPerBlock = 64;"),
    # a warp's 32 threads on 32 rows and one group of outputs: G's loads one address a warp
    "warp_rows": (r"const int t = threadIdx\.x / kRowSplit, i0 = threadIdx\.x % kRowSplit \* kRowOut;",
                  "const int t = threadIdx.x % 32 + 32 * (threadIdx.x / (32 * kRowSplit)), "
                  "i0 = threadIdx.x / 32 % kRowSplit * kRowOut;"),
    "gram_sub4": (r"constexpr int kGramSub = 2;", "constexpr int kGramSub = 4;"),
    "fold_entries4": (r"constexpr int kFoldEntries = 8;", "constexpr int kFoldEntries = 4;"),
    "fold_batch1": (r"constexpr int kFoldBatch = 16;", "constexpr int kFoldBatch = 1;"),
}
# a part of a phase left out, for its time alone (other bits)
PARTS = {
    "gram_no_fma": (r"if \(live\) \{\n#pragma unroll 4", "if (false) {\n#pragma unroll 4"),
    "fold_no_stage": (r"copy4\(s_part \+ e \* ncs \+ c, [^;]*;", ";"),
    "fold_no_chain": (r"for \(; x \+ kFoldBatch <= nc;", "for (x = nc; x + kFoldBatch <= nc;"),
    "update_no_chain": (r"if \(l < k\) \{(\s+)const float f = fr\[l\];",
                        "if (l < 0) {\\1const float f = fr[l];"),
    "update_no_div": (r"nt\[i\] = __fdiv_rn\(", "nt[i] = __fmul_rn("),
}


def build_all(other: str, out: str) -> dict:
    mine = (_kernels.CSRC / "decomp_kernels.cu").read_text()
    sources = {
        "other": open(f"{other}/muon_tpu_torch/csrc/decomp_kernels.cu").read() + OTHER_PHASES,
        "committed": mine + PHASES,
    }
    for name, (pat, rep) in {**VARIANTS, **PARTS}.items():
        src, n = re.subn(pat, rep, mine)
        if n != 1:
            raise RuntimeError(f"{name}: {pat!r} found {n} times")
        sources[name] = src + PHASES
    jobs = {}
    for name, src in sources.items():
        cu, so = f"{out}/{name}.cu", f"{out}/{name}.so"
        with open(cu, "w") as f:
            f.write(src)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: {stdout}{stderr}")
        lib = ctypes.CDLL(so)
        lib.lab_phase.argtypes = LAB_ARGS
        lib.lab_phase.restype = ctypes.c_int
        log = (stdout + stderr).split("\n")
        lib.ptxas = [f"{log[i].split('for')[-1].strip()} | {log[i + 1].strip()} | "
                     f"{log[i + 2].strip()}" for i, line in enumerate(log)
                     if "Function properties for" in line and "nmf" in line and i + 2 < len(log)]
        libs[name] = lib
    return libs


def timed(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` after one warm-up, a spin queued
    before each start event."""
    times = []
    for _ in range(reps + 1):
        torch.cuda._sleep(2_000_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times[1:]))


def profiled(fn, reps: int = 10) -> dict:
    """Each kernel's mean device time (ms, torch.profiler) over ``reps``
    runs of ``fn``: the kernels' own spans, without a launch's floor."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        name = re.search(r"nmf_(\w+)", e.key)
        if us and name:
            out[f"profiled {name.group(1)} ms"] = us / 1e3 / reps
    return out


def digest(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_t33_variants: no CUDA device", file=sys.stderr)
        return 1
    other, inputs, out = sys.argv[1], sys.argv[2], sys.argv[3]
    os.makedirs(out, exist_ok=True)
    cuda = torch.device("cuda", 0)
    libs = build_all(other, out)
    inp = np.load(f"{inputs}/inputs.npz")
    W, Ht, XtW, XHt = (torch.from_numpy(inp[k]).to(cuda)
                       for k in ("t33_W", "t33_Ht", "t33_XtW", "t33_XHt"))
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    results = {name: {"ptxas": lib.ptxas} for name, lib in libs.items()}
    for label, F, N, O in (("Ht update", Ht, XtW, W), ("W update", W, XHt, Ht)):
        rows, k = F.shape
        r_o = O.shape[0]
        n_chunks = min(tnmf._GRAM_CHUNKS, -(-r_o // tnmf._GRAM_ROWS),
                       max(1, tnmf._GRAM_FLOATS // (k * k)))
        chunk = -(-r_o // n_chunks)
        part = torch.empty((n_chunks, k, k), device=cuda)
        G = torch.empty((k, k), device=cuda)
        res = torch.empty_like(F)
        want, want_G = tnmf._nmf_launch(F, N, O, 1.0)
        want, want_G = digest(want), digest(want_G)
        for name, lib in libs.items():

            def phase(p, lib=lib):
                err = lib.lab_phase(p, F.data_ptr(), N.data_ptr(), O.data_ptr(), rows, r_o, k,
                                    1.0, chunk, n_chunks, part.data_ptr(), G.data_ptr(),
                                    res.data_ptr(), stream())
                if err:
                    raise RuntimeError(f"{name} phase {p}: CUDA error {err}")

            row = {}
            for p, what in enumerate(("gram", "fold", "update")):
                row[f"{what} ms"] = timed(lambda p=p: phase(p))
            row["three in a row ms"] = timed(lambda: [phase(p) for p in range(3)])
            G.zero_()
            for p in range(3):
                phase(p)
            row["the committed bits (out, G)"] = [digest(res) == want, digest(G) == want_G]
            row.update(profiled(lambda: [phase(p) for p in range(3)]))
            if name in PARTS:
                results[name][label] = row
                print(f"{name} {label}: {json.dumps(row)}", flush=True)
                continue
            if name != "other":
                row["gram with the fold in its last block ms"] = timed(lambda: phase(3))
                row["that and the update ms"] = timed(lambda: [phase(3), phase(2)])
                G.zero_()
                phase(3)
                phase(2)
                row["that: the committed bits (out, G)"] = [digest(res) == want,
                                                            digest(G) == want_G]
                row["an empty launch ms"] = timed(lambda: phase(4))
            results[name][f"{label} {tuple(F.shape)} from {tuple(O.shape)}, {n_chunks} chunks "
                          f"of {chunk}"] = row
            print(f"{name} {label}: {json.dumps(row)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia-smi": smi,
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
