"""T11 (csrc/wnn_kernels.cu, ``wnn_fusion_kernel``) on the card in variants of
its source and launch shapes, beside the source as committed: what sets its
time on the WNN of three's call at 100,000 cells x 600 candidates (D = 130).

Run on a machine with a CUDA card, from the root of the repo, after
``python3 exp_compare_trees.py make DIR t11`` has recorded T11's arguments:

    python3 exp_t11_variants.py DIR OUT

Each variant is the committed source with some of its text replaced, built
with the package's nvcc flags into OUT/NAME.so (all builds started together)
and called through T11's C entry point on the table padded as
``ops.wnn.padded_table`` pads it, at several (cells a block, pieces a staged
chunk). Per launch: the time (CUDA events, median of 5, a spin queued before
the start event, as chip_smoke.py's ``median_ms``), the candidate rows'
bytes over it, and whether the scores are the committed build's bits at its
default shape (the timing-only variants are not). A build whose warps count
their cycles (clock64: in all, waiting for a staged unit, issuing the
staging, running the chains) gives each phase's median over the cells.
Prints one JSON object.
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

import chip_smoke as cs
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import wnn as tw

KERNEL = "wnn_fusion_kernel"
STAGE16 = r"if \(cr >= 0\) cp_async16\("
PER = r"constexpr int kFusionPer = 1;"
# name -> ([(pattern, replacement)], [(warps, chunk)], keeps the bits)
VARIANTS = {
    "committed": ([], [(8, 7), (4, 7), (4, 5), (2, 5), (8, 5), (4, 9), (8, 3), (4, 17)], True),
    # two candidates a lane (64 a tile), their chains interleaved
    "per2": ([(PER, "constexpr int kFusionPer = 2;")], [(8, 5), (5, 5), (4, 7)], True),
    # timing only: the rows staged, no chain run
    "stage_only": ([(r"    if \(any\) \{\n      const uint4\* row",
                     "    if (any && D < 0) {\n      const uint4* row")], [(8, 7), (4, 9)], False),
    # timing only: the chains run on whatever the buffers hold, no row staged
    "compute_only": ([(STAGE16, "if (cr < -1) cp_async16(")], [(8, 7), (4, 9)], False),
}

# the committed source with each warp's cycles counted (clock64): in all,
# issuing the next unit's staging, waiting for the current unit, running the
# chains; written for the first 65,536 cells
TIMELINE = [
    (r"  if \(w >= rows\) return;  // no block-wide barrier below\n",
     "  if (w >= rows) return;  // no block-wide barrier below\n"
     "  long long lab_t0 = clock64(), lab_wait = 0, lab_stage = 0, lab_comp = 0, lab_m = 0;\n"),
    (r"      fusion_stage\(nid, v \+ 1, lane, sh, A, cat16, ld, aux, rbuf, abuf\);\n"
     r"      cp_async_wait<1>\(\);\n    \} else \{\n      cp_async_wait<0>\(\);\n    \}\n"
     r"    __syncwarp\(\);  // unit v has landed for every lane\n",
     "      lab_m = clock64();\n"
     "      fusion_stage(nid, v + 1, lane, sh, A, cat16, ld, aux, rbuf, abuf);\n"
     "      lab_stage += clock64() - lab_m;\n      lab_m = clock64();\n"
     "      cp_async_wait<1>();\n    } else {\n      lab_m = clock64();\n"
     "      cp_async_wait<0>();\n    }\n    __syncwarp();\n"
     "    lab_wait += clock64() - lab_m;\n    lab_m = clock64();\n"),
    (r"(    if \(last\) \{\n#pragma unroll\n      for \(int h = 0; h < kFusionPer; \+\+h\) \{\n"
     r"        const int p = t \* kFusionTile)",
     "    lab_comp += clock64() - lab_m;\n\\1"),
    (r"(    __syncwarp\(\);  // buffer v & 1 is read before unit v \+ 2 lands there\n  \}\n)",
     "\\1  if (lane == 0 && w < 65536) {\n    lab_ts[w * 4] = clock64() - lab_t0;\n"
     "    lab_ts[w * 4 + 1] = lab_wait;\n    lab_ts[w * 4 + 2] = lab_stage;\n"
     "    lab_ts[w * 4 + 3] = lab_comp;\n  }\n"),
    (r"#include <stdint.h>\n", "#include <stdint.h>\n__device__ long long lab_ts[65536 * 4];\n"),
]
TIMELINE_READ = """
extern "C" int lab_timeline(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, lab_ts, sizeof(lab_ts));
}
"""


def build_all(out: str) -> dict:
    src0 = (_kernels.CSRC / "wnn_kernels.cu").read_text()
    jobs = {}
    builds = {name: (subs, "") for name, (subs, _, _) in VARIANTS.items()}
    builds["timeline"] = (TIMELINE, TIMELINE_READ)
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
        lib.mt_wnn_fusion_scores.argtypes = list(_kernels._SIGNATURES["mt_wnn_fusion_scores"])
        lib.mt_wnn_fusion_scores.restype = ctypes.c_int
        log = (stdout + stderr).split("\n")
        # ptxas' lines after the kernel's entry (its stack, spills, registers)
        at = [i for i, line in enumerate(log) if "Compiling entry function" in line
              and KERNEL in line and "ILb0E" not in line][:1]
        lib.ptxas = [" | ".join(ln.split("ptxas info    : ")[-1].strip()
                                for ln in log[i + 1:i + 5]) for i in at]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_t11_variants: no CUDA device", file=sys.stderr)
        return 1
    inputs, out = sys.argv[1], sys.argv[2]
    os.makedirs(out, exist_ok=True)
    cuda = torch.device("cuda", 0)
    libs = build_all(out)
    single = np.load(f"{inputs}/wnn_single.npz")
    cand = torch.from_numpy(single["cand"]).to(cuda)
    table = tw.padded_table(torch.from_numpy(single["cat16"]).to(cuda).view(torch.bfloat16))
    aux, sigw = (torch.from_numpy(single[k]).to(cuda) for k in ("aux", "sigw"))
    dims = [tuple(int(v) for v in d) for d in single["dims"]]
    offs = torch.tensor(tw._dims_offsets(dims, table.shape[1]), dtype=torch.int32, device=cuda)
    cosine = int(str(single["metric"]) == "cosine")
    n, D = table.shape
    rows, C = cand.shape
    M = len(dims)
    gathered = int((cand >= 0).sum()) * D * 2
    scores = torch.empty((rows, C), dtype=torch.float32, device=cuda)

    def launch(lib, warps, chunk):
        err = lib.mt_wnn_fusion_scores(
            cand.data_ptr(), table.data_ptr(), table.stride(0), aux.data_ptr(), sigw.data_ptr(),
            offs.data_ptr(), n, 0, rows, C, D, M, cosine, warps, chunk, scores.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at warps={warps} chunk={chunk}")

    launch(libs["committed"], tw.FUSION_WARPS, tw.FUSION_CHUNK)
    torch.cuda.synchronize()
    want = scores.clone()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    results = {"card": card, "shape": [rows, C, n, D], "gathered_bytes": gathered}
    for name, (_, shapes, keeps) in VARIANTS.items():
        lib = libs[name]
        res = {"ptxas": lib.ptxas}
        for warps, chunk in shapes:
            try:
                launch(lib, warps, chunk)
            except RuntimeError as e:  # a block past the shared memory a block may take
                print(f"{name} warps={warps} chunk={chunk}: {e}", flush=True)
                continue
            torch.cuda.synchronize()
            same = bool(torch.equal(scores, want))
            ms = cs.median_ms(lambda: launch(lib, warps, chunk))
            res[f"warps={warps} chunk={chunk}"] = {"ms": ms, "TB/s": gathered / (ms * 1e9),
                                                   "same_bits": same}
            print(f"{name} warps={warps} chunk={chunk}: {ms:.4f} ms, "
                  f"{gathered / (ms * 1e9):.3f} TB/s, the committed bits {same}"
                  + ("" if keeps else " (timing only)"), flush=True)
        results[name] = res
    # each warp's cycles, in all and by phase (median over the first 65,536 cells)
    lib = libs["timeline"]
    lib.lab_timeline.argtypes = [ctypes.c_void_p]
    results["timeline"] = {}
    for warps, chunk in ((8, 7), (4, 17)):
        launch(lib, warps, chunk)
        torch.cuda.synchronize()
        ts = np.zeros(65536 * 4, np.int64)
        if lib.lab_timeline(ts.ctypes.data):
            raise RuntimeError("lab_timeline failed")
        ts = ts.reshape(65536, 4)[:min(rows, 65536)].astype(np.float64)
        med = {k: float(np.median(ts[:, i])) for i, k in
               enumerate(("all", "wait", "stage", "chains"))}
        results["timeline"][f"warps={warps} chunk={chunk}"] = med
        print(f"timeline warps={warps} chunk={chunk}: cycles a warp (median) {med}", flush=True)
    results["card_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
