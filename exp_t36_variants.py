"""T36's screen (csrc/motif_kernels.cu, the count and write modes) on the
card in variants of its launch shape, beside the source as committed: what
sets its time at the [motifs] path's size.

Run on a machine with a CUDA card, from the root of the repo:

    python3 exp_t36_variants.py OUT

Each variant is the committed source with some of its constants replaced
(``kSWarps``: warps a block; ``kTiles``: m16 tiles of windows a warp
carries), built with the package's nvcc flags into OUT/NAME.so and called
through the same C entry point with the arguments ``ops.pwm._scan_args``
gives it. The data: 100,000 sequences of 500 uniform bases from seed 0,
1.5% of them holding a run of 200 N, and all 746 JASPAR motifs at p = 1e-4.
Per variant: the count pass alone and the write pass alone (CUDA events,
median of 5, the counts zeroed and the cursors reset outside the timed
span), the candidates, and whether its hits are the committed source's
bits; the committed source also with every bar at +inf (the screen with no
candidate: the products and the epilogue's test alone). The committed
build's SASS instruction mix of the count kernel goes to OUT/sass_mix.txt.
Prints one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter
from dataclasses import replace

import numpy as np
import torch

from muon_tpu_torch.atac import motifs as tmf
from muon_tpu_torch.ops import _kernels, pwm as tpw

VARIANTS = {
    "committed": {},
    "warps12": {"kSWarps": 12},
    "tiles4_warps12": {"kTiles": 4, "kSWarps": 12},
    "tiles1": {"kTiles": 1},
}


def build(out: str, name: str, subs: dict) -> ctypes.CDLL:
    src = (_kernels.CSRC / "motif_kernels.cu").read_text()
    for key, val in subs.items():
        src, n = re.subn(rf"constexpr int {key} = \d+;", f"constexpr int {key} = {val};", src)
        if n != 1:
            raise RuntimeError(f"{key} not found once in motif_kernels.cu")
    cu, so = f"{out}/{name}.cu", f"{out}/{name}.so"
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(so)
    lib.mt_pwm_scan.argtypes = list(_kernels._SIGNATURES["mt_pwm_scan"])
    lib.mt_pwm_scan.restype = ctypes.c_int
    # ptxas' registers and spills of the two screen kernels
    log = (proc.stdout + proc.stderr).split("\n")
    lib.ptxas = [f"{log[i + 1].strip()} | {log[i + 2].strip()}" for i, line in enumerate(log)
                 if "Function properties for" in line and "pwm_screen_kernel" in line
                 and i + 2 < len(log)]
    return lib


def sass_mix(so: str) -> str:
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True).stdout
    blocks = re.split(r"\n\s+Function : ", text)
    out = []
    for b in blocks:
        name = b.split("\n", 1)[0]
        if "pwm_screen_kernel" not in name:
            continue
        ops = Counter(m.group(1).split(".")[0] for m in
                      re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", b))
        out.append(f"{name}\n  {sum(ops.values())} instructions: " +
                   ", ".join(f"{k} {v}" for k, v in ops.most_common(40)))
    return "\n".join(out) + "\n\n" + text


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_t36_variants: no CUDA device", file=sys.stderr)
        return 1
    out = sys.argv[1]
    os.makedirs(out, exist_ok=True)
    cuda = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    n, L = 100_000, 500
    codes_np = rng.integers(0, 4, (n, L)).astype(np.uint8)
    for i in rng.choice(n, n * 3 // 200, replace=False):
        at = int(rng.integers(0, L - 200))
        codes_np[i, at:at + 200] = 4
    log_odds = tmf._parse_motif_matrices()["matrices"]
    lo_np, off_np, width_np = tpw.pack_motifs(log_odds)
    thr_np = tpw.threshold_f32([tpw.threshold_from_p(m, pvalue=1e-4) for m in log_odds])
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    codes, lo, off, width, thr = (to(a) for a in (codes_np, lo_np, off_np, width_np, thr_np))
    M = len(log_odds)
    host = tpw.pack_screen(lo_np, off_np, width_np, thr_np)
    closed = replace(host, slot_thr=np.full_like(host.slot_thr, np.inf))
    G, steps = len(host.steps), int(host.steps.sum())
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    units = torch.zeros((n, tpw._UNIT_WORDS), dtype=torch.int32, device=cuda)

    def scan(lib, mode, screen, counts, **kw):
        # one chunk of every group, the launch ops.pwm makes
        args = tpw._scan_args(mode, codes, lo, off, width, thr, counts=counts, screen=screen,
                              groups=(0, G, 0, steps), units=units, **kw)
        err = lib.mt_pwm_scan(*args, stream())
        if err:
            raise RuntimeError(f"mode {mode}: CUDA error {err}")

    def count(lib, screen, counts, cand):
        scan(lib, tpw._MODE_COUNT, screen, counts, candidates=cand)

    def write(lib, screen, counts, cursor, hits):
        scan(lib, tpw._MODE_WRITE, screen, counts, offsets=cursor, hits=hits)

    def timed(setup, fn, reps=5):
        setup()
        fn()
        times = []
        for _ in range(reps):
            setup()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times)), times

    results, ref = {}, None
    for name, subs in VARIANTS.items():
        lib = build(out, name, subs)
        if name == "committed":
            with open(f"{out}/sass_mix.txt", "w") as f:
                f.write(sass_mix(f"{out}/{name}.so"))
        screen = host.to(cuda)
        units.zero_()
        counts = torch.zeros((n, M), dtype=torch.int32, device=cuda)
        cand = torch.zeros(1, dtype=torch.int64, device=cuda)
        count(lib, screen, counts, cand)
        flat = counts.view(-1)
        ends = torch.cumsum(flat, 0, dtype=torch.int64)
        total = int(ends[-1].item())
        starts = ends - flat
        hits = [torch.empty(total, dtype=t, device=cuda)
                for t in (torch.int32, torch.int32, torch.int32, torch.float32)]
        cursor = starts.clone()
        write(lib, screen, counts, cursor, hits)
        torch.cuda.synchronize()
        got = [h.cpu().numpy() for h in hits]
        ref = got if ref is None else ref
        same = all(np.array_equal(a, b) for a, b in zip(got, ref))
        c_ms, c_all = timed(lambda: (counts.zero_(), units.zero_()),
                            lambda: count(lib, screen, counts, None))
        w_ms, w_all = timed(lambda: cursor.copy_(starts),
                            lambda: write(lib, screen, counts, cursor, hits))
        results[name] = {"subs": subs, "count_ms": c_ms, "count_all": c_all, "write_ms": w_ms,
                         "write_all": w_all, "hits": total, "candidates": int(cand.item()),
                         "same_bits_as_committed": same, "ptxas": lib.ptxas}
        if name == "committed":
            shut = closed.to(cuda)
            z_ms, z_all = timed(lambda: (counts.zero_(), units.zero_()),
                                lambda: count(lib, shut, counts, None))
            results["committed, every bar +inf"] = {"count_ms": z_ms, "count_all": z_all}
        print(f"{name}: {json.dumps(results[name])}", flush=True)
        del counts, hits, cursor, starts, ends
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
