"""The dense T26 (csrc/de_kernels.cu, ``wilcoxon_rank_sums_kernel``) on the card
in variants of its source, beside the source as committed: what sets its time
on one sorted column block of ``[de]``'s dense RNA (2684 x 100,000, g = 20).

Run on a machine with a CUDA card, from the root of the repo, after
``python3 exp_compare_trees.py make DIR t26d`` has written the RNA:

    python3 exp_t26_variants.py DIR OUT

Each variant is the committed source with some of its text replaced, built
with the package's nvcc flags into OUT/NAME.so (all builds started together)
and called through T26's C entry point on the block ``torch.sort`` sorted
(the first 2684 columns of the RNA densified on the card). Per variant: the
launch's time (CUDA events, median of 5, a spin queued before the start
event, as chip_smoke.py's ``median_ms``), ptxas' registers, and whether the
rank sums and tie terms are the committed build's bits (the timing-only
variants' are not). Prints one JSON object.
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
from muon_tpu_torch.ops import de as tde

KERNEL = "wilcoxon_rank_sums_kernel"
ADD = (r"        add_u64\(&acc\[cd\], \(unsigned\)\(open \? lov\[e\] \+ 1 : lov\[e\] \+ 1 \+ hiv\[e\]\)\);\n"
       r"        if \(open && atomicAdd\(&open_n\[cd\], 1u\) == 0u\) touched\[atomicAdd\(&n_touched, 1\)\] = cd;\n")
BOUNDS = r"__launch_bounds__\(kRankThreads\)\nwilcoxon_rank_sums_kernel"
CELL = r"      if \(cd >= 0\) \{\n" + ADD + r"      \}\n"
# name -> ([(pattern, replacement)], keeps the bits)
VARIANTS = {
    "committed": ([], True),
    # one 64-bit shared atomic a cell (a compare-and-swap loop)
    "atom64": ([(ADD, "        atomicAdd(&acc[cd], (unsigned long long)(open ? lov[e] + 1 : "
                      "lov[e] + 1 + hiv[e]));\n"
                      "        if (open && atomicAdd(&open_n[cd], 1u) == 0u) "
                      "touched[atomicAdd(&n_touched, 1)] = cd;\n")], True),
    # a warp's adds summed by group first, one atomic a group (the first design)
    "match": ([(CELL,
                "      const int key = cd >= 0 ? 2 * cd + (int)open : -1;\n"
                "      const unsigned peers = __match_any_sync(kFull, key);\n"
                "      const int sum = __reduce_add_sync(peers, open ? lov[e] + 1 : "
                "lov[e] + 1 + hiv[e]);\n"
                "      if (key >= 0 && (peers & ((1u << lane) - 1u)) == 0u) {\n"
                "        add_u64(&acc[cd], (unsigned)sum);\n"
                "        if (open && atomicAdd(&open_n[cd], (unsigned)__popc(peers)) == 0u)\n"
                "          touched[atomicAdd(&n_touched, 1)] = cd;\n"
                "      }\n")], True),
    # at most 40 registers: 6 blocks an SM
    "lb6": ([(BOUNDS, "__launch_bounds__(kRankThreads, 6)\nwilcoxon_rank_sums_kernel")], True),
    # timing only: no add into the counters
    "no_adds": ([(r"      if \(cd >= 0\) \{\n        add_u64", "      if (cd >= 0 && n < 0) {\n"
                                                           "        add_u64")], False),
    # timing only: no code gathered
    "no_codes": ([(r"for \(int e = 0; e < kRankPer; \+\+e\) code\[e\] = codes\[q\[e\]\];",
                   "for (int e = 0; e < kRankPer; ++e) code[e] = (int)(q[e] % 20);")], False),
}


def build_all(out: str) -> dict:
    src0 = (_kernels.CSRC / "de_kernels.cu").read_text()
    jobs = {}
    for name, (subs, _) in VARIANTS.items():
        src = src0
        for pat, rep in subs:
            src, n = re.subn(pat, rep, src)
            if n != 1:
                raise RuntimeError(f"{name}: {pat!r} found {n} times")
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
        lib.mt_wilcoxon_rank_sums.argtypes = list(_kernels._SIGNATURES["mt_wilcoxon_rank_sums"])
        lib.mt_wilcoxon_rank_sums.restype = ctypes.c_int
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
        print("exp_t26_variants: no CUDA device", file=sys.stderr)
        return 1
    inputs, out = sys.argv[1], sys.argv[2]
    os.makedirs(out, exist_ok=True)
    cuda = torch.device("cuda", 0)
    libs = build_all(out)
    from scipy import sparse as sp

    from muon_tpu_torch.ops import sparse as dsp

    inp = np.load(f"{inputs}/inputs.npz")
    X = sp.csr_matrix((inp["de_rna_data"], inp["de_rna_indices"], inp["de_rna_indptr"]),
                      shape=tuple(inp["de_rna_shape"]))
    Xd = tde.dense_from_csr(dsp.from_scipy(X, cuda))
    g = int(inp["de_labels"].max()) + 1
    codes = torch.from_numpy(inp["de_labels"].astype(np.int32)).to(cuda)
    vals, perm = torch.sort(Xd[:, :cs.DE_BLOCK].T, dim=1, stable=True)
    vals, perm = vals.contiguous(), perm.contiguous()
    del Xd
    b, n = vals.shape
    rank_sums = torch.empty((g, b), dtype=torch.float64, device=cuda)
    tie = torch.empty(b, dtype=torch.int64, device=cuda)

    def launch(lib):
        err = lib.mt_wilcoxon_rank_sums(vals.data_ptr(), perm.data_ptr(), codes.data_ptr(), n, b,
                                        g, rank_sums.data_ptr(), tie.data_ptr(),
                                        torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")

    want = tde.sorted_rank_sums_plain(vals, perm, codes, g)
    smi = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    results = {"card": subprocess.run(smi, capture_output=True, text=True,
                                      check=True).stdout.strip(),
               "block": [b, n], "g": g, "bytes": 12 * b * n}
    for name, (_, keeps) in VARIANTS.items():
        lib = libs[name]
        launch(lib)
        torch.cuda.synchronize()
        same = bool(torch.equal(rank_sums, want[0]) and torch.equal(tie, want[1]))
        ms = cs.median_ms(lambda: launch(lib))
        results[name] = {"ms": ms, "plain's bits": same, "ptxas": lib.ptxas}
        print(f"{name}: {ms:.4f} ms, the plain version's bits {same}"
              + ("" if keeps else " (timing only)") + f" | {lib.ptxas}", flush=True)
    results["card_after"] = subprocess.run(smi, capture_output=True, text=True,
                                           check=True).stdout.strip()
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
