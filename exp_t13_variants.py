"""T13's run kernel (csrc/umap_kernels.cu, ``umap_epoch_runs_kernel``) on the
card in variants of its source, beside the source as committed: what sets
its time on the smoke's two UMAP graphs.

Run on a machine with a CUDA card, from the root of the repo, after
``python3 exp_compare_trees.py make DIR t13`` has written the graphs:

    python3 exp_t13_variants.py DIR OUT

Each variant is the committed source with some of its text replaced, built
with the package's nvcc flags into OUT/NAME.so (all builds started
together) and called through T13's C entry point with the plan ``ops.umap.run_plan``
makes for the edges its blocks hold. Per variant, at 100,000 and 1,000,000
vertices and epochs 0, 8 and 13 (the starts, negatives and eons of
``exp_compare_trees.py``'s t13 section): the launch's time (CUDA events,
median of 7, a spin queued before the start event and the eons refreshed
outside the timed span), whether ``emb_out`` and ``eons`` are the committed
build's bits, and the blocks an SM can hold (the occupancy API, dim 2),
with ptxas' registers and spills. The committed build also runs with no
negatives, and without a plan (the first design's kernel: a warp per
vertex), for the record; and a build of it whose blocks stamp their phases
(``TIMELINE``: clock64 and globaltimer from thread 0) gives each phase's
cycles, a block's length and the blocks in flight. Prints one JSON object.
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

import exp_compare_trees as ect
from muon_tpu_torch.ops import _kernels, umap as tu

KERNEL = "umap_epoch_runs_kernel"
# name -> [(pattern, replacement)], each pattern found exactly once
VARIANTS = {
    "committed": [],
    "blocks3": [(r"constexpr int kRunBlocksPerSm = 4;", "constexpr int kRunBlocksPerSm = 3;")],
    "thread_row32": [(r"constexpr int kThreadRow = 64;", "constexpr int kThreadRow = 32;")],
    "due_batch4": [(r"constexpr int kDueBatch = 2;", "constexpr int kDueBatch = 4;")],
    "edges2048": [(r"constexpr int kGFloats = 6144;", "constexpr int kGFloats = 4096;")],
    # the block's rows written back unchanged: the scan and the due edges alone
    "no_sums": [(r"(  __syncthreads\(\);\n)(\n  // two neighbouring threads per vertex)",
                 "\\1  if (tid >= nv) return;\n  for (int k = 0; k < DIM; ++k)\n"
                 "    emb_out[(int64_t)(vb0 + tid) * DIM + k] = s_ei[tid * DIM + k];\n"
                 "  if (DIM > 0) return;\n\\2")],
}
# the committed source with each block's phases stamped by its thread 0:
# globaltimer at its start and end, clock64 at its start, after the staged
# scan, the due list, the due edges, the warps' rows, and at its end
TIMELINE = [
    (r"#include <stdint.h>\n",
     "#include <stdint.h>\n__device__ unsigned long long lab_ts[16384 * 8];\n"
     "__device__ __forceinline__ unsigned long long lab_gt() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n#define LAB_AT(k, v) if (threadIdx.x == 0 && blockIdx.x < 16384) "
     "lab_ts[blockIdx.x * 8 + (k)] = (v);\n"),
    (r"(  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;\n)"
     r"(  const int2 p0)", "\\1  LAB_AT(0, lab_gt()) LAB_AT(1, clock64())\n\\2"),
    (r"(    __syncthreads\(\);  // the staged range[^\n]*\n)",
     "\\1    if (c0 == E0) { LAB_AT(2, clock64()) }\n"),
    (r"(    __syncthreads\(\);\n)(    // 2. the due edges)",
     "\\1    if (c0 == E0) { LAB_AT(3, clock64()) }\n\\2"),
    (r"(    __syncthreads\(\);\n)(    if \(chunked && warp == 0\))",
     "\\1    if (c0 == E0) { LAB_AT(4, clock64()) }\n\\2"),
    (r"(  __syncthreads\(\);\n)(\n  // two neighbouring threads per vertex)",
     "\\1  LAB_AT(5, clock64())\n\\2"),
    (r"(__fmul_rn\(neg, dc\)\)\)\);\n  \}\n)(\})",
     "\\1  LAB_AT(6, clock64()) LAB_AT(7, lab_gt())\n\\2"),
]
TIMELINE_READ = """
extern "C" int lab_timeline(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lab_ts, sizeof(lab_ts));
}
"""
OCCUPANCY = """
extern "C" int lab_blocks_per_sm(void) {
  int blocks = 0;
  cudaFuncSetAttribute(umap_epoch_runs_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       RunShape<2>::kBytes);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, umap_epoch_runs_kernel<2>,
                                                kRunThreads, RunShape<2>::kBytes);
  return blocks;
}
"""


def build_all(out: str) -> dict:
    src0 = (_kernels.CSRC / "umap_kernels.cu").read_text()
    jobs = {}
    builds = {name: (subs, OCCUPANCY) for name, subs in VARIANTS.items()}
    builds["timeline"] = (TIMELINE, OCCUPANCY + TIMELINE_READ)
    for name, (subs, extra) in builds.items():
        src = src0
        for pat, rep in subs:
            src, n = re.subn(pat, rep, src)
            if n != 1:
                raise RuntimeError(f"{name}: {pat!r} found {n} times")
        cu, so = f"{out}/{name}.cu", f"{out}/{name}.so"
        with open(cu, "w") as f:
            f.write(src + extra)
        cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: {stdout}{stderr}")
        lib = ctypes.CDLL(so)
        lib.mt_umap_epoch.argtypes = list(_kernels._SIGNATURES["mt_umap_epoch"])
        lib.mt_umap_epoch.restype = ctypes.c_int
        log = (stdout + stderr).split("\n")
        lib.ptxas = [f"{log[i + 1].strip()} | {log[i + 2].strip()}" for i, line in
                     enumerate(log) if "Function properties for" in line and KERNEL in line
                     and "ILi2E" in line and i + 2 < len(log)]
        libs[name] = lib
    return libs


def block_phases(lib, launch, eons, fresh, n_blocks: int) -> dict:
    """One launch of the timeline build after a warm one: each block's phases
    in SM cycles (median and mean over the blocks stamped), its length in ns
    (globaltimer), the launch's span and the blocks in flight on average."""
    lib.lab_timeline.argtypes = [ctypes.c_void_p]
    for _ in range(2):
        eons.copy_(fresh)
        torch.cuda.synchronize()
        launch()
        torch.cuda.synchronize()
    m = min(n_blocks, 16384)
    ts = np.zeros(16384 * 8, np.uint64)
    if lib.lab_timeline(ts.ctypes.data):
        raise RuntimeError("lab_timeline failed")
    ts = ts.reshape(16384, 8)[:m].astype(np.float64)
    names = ("staged scan", "due list", "due edges", "warps' rows", "threads' rows")
    out = {}
    for k, name in enumerate(names):
        d = ts[:, k + 2] - ts[:, k + 1]
        out[f"{name}, cycles"] = {"median": float(np.median(d)), "mean": float(d.mean()),
                                  "p99": float(np.percentile(d, 99))}
    length = ts[:, 7] - ts[:, 0]
    span = ts[:, 7].max() - ts[:, 0].min()
    out["block ns"] = {"median": float(np.median(length)), "p99": float(np.percentile(length, 99))}
    out["span ns (stamped blocks)"] = float(span)
    out["blocks in flight, mean"] = float(length.sum() / span)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_t13_variants: no CUDA device", file=sys.stderr)
        return 1
    inputs, out = sys.argv[1], sys.argv[2]
    os.makedirs(out, exist_ok=True)
    cuda = torch.device("cuda", 0)
    libs = build_all(out)
    inp = np.load(f"{inputs}/inputs.npz")
    a, b = tu.find_ab_params()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    timeline = libs.pop("timeline")
    results = {name: {"blocks_per_sm": lib.lab_blocks_per_sm(), "ptxas": lib.ptxas}
               for name, lib in libs.items()}
    results["timeline"] = {}
    for key in ("100k", "1m"):
        G = ect.umap_graph(inp, key)
        heads, tails, eps, _, dc = tu.edge_schedule(G, ect.cs.N_EPOCHS)
        n = G.shape[0]
        edges = tu.umap_edges(heads, tails, eps, tu.bucket_shifts(eps, ect.cs.N_EPOCHS), n,
                              cuda)
        # each build's plan, (n_blocks + 1, 2), for the edges its blocks hold
        indptr = edges.indptr.cpu().numpy()
        plans = {name: torch.from_numpy(tu.run_plan(indptr, lib.mt_umap_epoch_block_edges(2)))
                 .to(cuda) for name, lib in [*libs.items(), ("timeline", timeline)]}
        emb0 = torch.from_numpy(inp[f"umap{key}_start"]).to(cuda)
        negs = torch.from_numpy(inp[f"umap{key}_negs"]).to(cuda)
        dct = torch.from_numpy(dc).to(cuda)
        out_t = torch.empty_like(emb0)
        for epoch in ect.UMAP_EPOCHS:
            fresh = torch.from_numpy(ect.epoch_eons(eps, epoch)).to(cuda)
            eons = fresh.clone()
            alpha = tu.epoch_alpha(1.0, epoch, ect.cs.N_EPOCHS)

            def launch(name, with_plan=True, neg_rate=5):
                plan = plans[name]
                err = (timeline if name == "timeline" else libs[name]).mt_umap_epoch(
                    emb0.data_ptr(), out_t.data_ptr(), edges.indptr.data_ptr(),
                    edges.tails.data_ptr(), edges.eps.data_ptr(), eons.data_ptr(),
                    edges.shift.data_ptr(), dct.data_ptr(), negs.data_ptr(),
                    plan.data_ptr() if with_plan else 0, plan.shape[0] - 1, n, 2, neg_rate,
                    epoch, alpha, a, b, 1.0, stream())
                if err:
                    raise RuntimeError(f"CUDA error {err}")

            def timed(fn, reps=7):
                times = []
                for _ in range(reps + 1):
                    eons.copy_(fresh)
                    torch.cuda._sleep(2_000_000)
                    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    t0.record()
                    fn()
                    t1.record()
                    t1.synchronize()
                    times.append(t0.elapsed_time(t1))
                return float(np.median(times[1:]))

            tag = f"{key} epoch {epoch}"
            ref = None
            for name in libs:
                eons.copy_(fresh)
                launch(name)
                got = ect.digest(out_t, eons)
                ref = got if ref is None else ref
                results[name][tag] = {"ms": timed(lambda: launch(name)), "same_bits": got == ref}
            eons.copy_(fresh)
            launch("committed", with_plan=False)
            results["committed"][f"{tag}, the first design"] = {
                "ms": timed(lambda: launch("committed", with_plan=False)),
                "same_bits": ect.digest(out_t, eons) == ref}
            results["committed"][f"{tag}, no negatives"] = {
                "ms": timed(lambda: launch("committed", neg_rate=0))}
            results["timeline"][tag] = block_phases(
                timeline, lambda: launch("timeline"), eons, fresh,
                int(plans["timeline"].shape[0] - 1))
            print(f"{tag}: " + json.dumps({k: v.get(tag) for k, v in results.items()}),
                  flush=True)
        results["committed"][f"{key} plan blocks"] = int(plans["committed"].shape[0] - 1)
        del edges, emb0, negs, dct, out_t, plans, G
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
