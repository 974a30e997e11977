"""T24 (csrc/gp_kernels.cu, ``rbf_kernel``) on the card in variants of its
source, beside the source as committed: what sets its time at the paths'
shapes.

Run on a machine with a CUDA card, from the root of the repo:

    python3 exp_t24_variants.py OUT

Each variant is the committed source with some of its text replaced, built
with the package's nvcc flags into OUT/NAME.so (all builds started
together) and called through T24's C entry point on chip_smoke.py's
``[kernel] gp_rbf_kernel`` inputs (its generator seeded 24): gp_K (10 ×
3000² with a learned Kg of 2 groups), K_nm (100,000 × 1,000) and K_mm
(1,000²) of one factor, with group labels. Per variant and shape: the
launch's time (CUDA events, median of 7 after a warm one, a spin queued
before the start event), whether the matrix is the committed build's bits
(variants that drop work are timings only), and ptxas' registers. Prints
one JSON object.
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
from muon_tpu_torch.ops import _kernels, gp as tgp

# name -> [(pattern, replacement)], each pattern found exactly once
VARIANTS = {
    "committed": [],
    "rows8": [(r"constexpr int kMaxRowsPer = 16;", "constexpr int kMaxRowsPer = 8;")],
    "rows4": [(r"constexpr int kMaxRowsPer = 16;", "constexpr int kMaxRowsPer = 4;")],
    "plain_stores": [(r"__stcs\(reinterpret_cast<float4\*>\(dst\), "
                      r"\*reinterpret_cast<const float4\*>\(v\)\);",
                      "*reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(v);")],
    "cols32_lanes8": [(r"constexpr int kCols = 64;", "constexpr int kCols = 32;"),
                      (r"constexpr int kLanes = 4;", "constexpr int kLanes = 8;")],
    # the division as the product with RN(1 / l^2) and two fma corrections,
    # |x| and l^2 in [2^-60, 2^60] (Markstein's theorem), x = +-0 itself, else
    # the IEEE quotient: the same bits
    "reciprocal_division": [
        (r"(  const float y = __fmul_rn\(l, l\);\n)",
         "\\1  const bool fast = y >= 0x1p-60f && y <= 0x1p60f;\n"
         "  const float r = __frcp_rn(y);\n"),
        (r"float e = expf\(__fdiv_rn\(x, y\)\);",
         "float e;\n"
         "        {\n"
         "          const unsigned ax = __float_as_uint(x) & 0x7fffffffu;\n"
         "          if (!fast || ax - 0x21800000u > 0x5d800000u - 0x21800000u) {\n"
         "            e = ax == 0u ? x : __fdiv_rn(x, y);\n"
         "          } else {\n"
         "            float q = __fmul_rn(x, r);\n"
         "            float d = __fmaf_rn(-q, y, x);\n"
         "            q = __fmaf_rn(d, r, q);\n"
         "            d = __fmaf_rn(-q, y, x);\n"
         "            e = __fmaf_rn(d, r, q);\n"
         "          }\n"
         "        }\n"
         "        e = expf(e);")],
    # timings only: the exp, or the exact division, left out
    "no_exp": [(r"float e = expf\(__fdiv_rn\(x, y\)\);", "float e = __fdiv_rn(x, y);")],
    "product_only": [(r"float e = expf\(__fdiv_rn\(x, y\)\);",
                      "float e = expf(__fmul_rn(x, __frcp_rn(y)));")],
}
EXACT = ("committed", "rows8", "rows4", "plain_stores", "cols32_lanes8", "reciprocal_division")


def build_all(out: str) -> dict:
    src0 = (_kernels.CSRC / "gp_kernels.cu").read_text()
    jobs = {}
    for name, subs in VARIANTS.items():
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
        lib.mt_gp_rbf_kernel.argtypes = list(_kernels._SIGNATURES["mt_gp_rbf_kernel"])
        lib.mt_gp_rbf_kernel.restype = ctypes.c_int
        log = (stdout + stderr).split("\n")
        lib.ptxas = [f"{log[i + 1].strip()} | {log[i + 2].strip()}" for i, line in
                     enumerate(log) if "Function properties for" in line and "rbf_kernel" in line
                     and i + 2 < len(log)]
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_t24_variants: no CUDA device", file=sys.stderr)
        return 1
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    cuda = torch.device("cuda", 0)
    libs = build_all(out)
    gen = torch.Generator(device=cuda).manual_seed(24)
    ells = torch.linspace(0.05, 0.8, cs.MEF_K, device=cuda)
    scales = torch.linspace(0.1, 0.9, cs.MEF_K, device=cuda)
    Kg = tgp.normalize_kg(torch.randn((cs.MEF_K, 2, 2), generator=gen, device=cuda))
    c = torch.rand((cs.MEF_N, 1), generator=gen, device=cuda)
    g = (torch.arange(cs.MEF_N, device=cuda) >= cs.MEF_N // 2).float()
    cn = torch.rand((cs.SGP_N, 1), generator=gen, device=cuda)
    gn = (torch.arange(cs.SGP_N, device=cuda) % 2).float()
    cu, gu = cn[::cs.SGP_N // 1000].contiguous(), gn[::cs.SGP_N // 1000].contiguous()
    shapes = {"gp_K": (c, c, ells, scales, g, g, Kg, True),
              "K_nm": (cn, cu, ells[:1], scales[:1], gn, gu, None, False),
              "K_mm": (cu, cu, ells[:1], scales[:1], gu, gu, None, True)}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    results = {name: {"ptxas": lib.ptxas} for name, lib in libs.items()}
    for shape, (a, b, el, sc, ga, gb, kg, same) in shapes.items():
        F = el.shape[0]
        K = torch.empty((F, a.shape[0], b.shape[0]), device=cuda)
        G = 0 if kg is None else kg.shape[-1]

        def launch(lib):
            err = lib.mt_gp_rbf_kernel(
                a.data_ptr(), b.data_ptr(), a.shape[0], b.shape[0], a.shape[1], el.data_ptr(),
                sc.data_ptr(), F, ga.data_ptr(), gb.data_ptr(), 0 if kg is None else kg.data_ptr(),
                G, int(same), K.data_ptr(), stream())
            if err:
                raise RuntimeError(f"CUDA error {err}")

        ref = None
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            bits = K.clone()
            ref = bits if ref is None else ref
            times = []
            for _ in range(8):
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda._sleep(2_000_000)
                t0.record()
                launch(lib)
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            results[name][shape] = {"ms": float(np.median(times[1:])),
                                    "same_bits": bool(torch.equal(bits, ref))
                                    if name in EXACT else None}
            del bits
        print(f"{shape}: " + json.dumps({k: v[shape] for k, v in results.items()}), flush=True)
        del K, ref
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
