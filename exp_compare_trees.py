"""Two checkouts of the port on one card: T9's σ, the MOFA bench fit, the
wide WNN path, T5 and T14, for a change held beside its parent in one call.

Run on a machine with a CUDA card, from the root of the repo, with the
other tree unpacked somewhere (``git archive <commit> | tar -x -C DIR``):

    python3 exp_compare_trees.py make OUT [SECTIONS]
    python3 exp_compare_trees.py run DIR parent1 OUT [SECTIONS]  # the other tree
    python3 exp_compare_trees.py run . change1 OUT [SECTIONS]    # this tree
    ...                                                          # in turns
    python3 exp_compare_trees.py compare OUT parent1 change1 ...

SECTIONS is a comma-separated subset of ``t9,mofa,wnn_wide,t5,t14`` (all
by default). ``t5``: T5 on ``make_big_rep`` at 100,000 × 50, float32 and
approx (the rows ``_operand`` rounds to bfloat16; a tree whose ``knn_topk``
has no ``approx`` argument takes them as float32), at k+1 = 20, 201 and
301. ``t14``: T14 over the whole work-item layout of the 1M representation
(``make_big_rep(0)``, C = 1024 k-means clusters from the rows
``default_rng(0)`` picks, 8 Lloyd steps, 8 probes, QB = 1024; the layout
and μ made once by ``make``), at the same three k. Each writes a SHA-256
of every output (the bits compared), T5's approx lists at k+1 = 20, and
CUDA-event times (median of 5, and the spread).

``make`` writes the inputs: chip_smoke.py's ``make_big_rep`` at 100,000 ×
50 with its exact 19-NN lists, at 2,000 × 50 with 256-NN lists (T9's
global variant), 1-D integer points below 256 that tie in large groups
(19 and 256 wide), and 50-d points each repeated four times with ragged
lists. ``run`` imports ``muon_tpu_torch`` from DIR (each run a process of
its own) and writes ``OUT/TAG.npz``: T9's σ on each input (and on the
window of rows 50,000-100,000), with T9's times (CUDA events, median of 5,
3 for the global variant); chip_smoke.py's ``[mofa]`` fit (2 warm-up
sweeps, then 50, three times: walls on the host clock), its Z, W, τ and
ELBO trace; one sweep from the state after two, between two CUDA events
(median of 20) and as the device time ``torch.profiler`` sums over its
kernels (all, and the MOFA passes' alone; mean of 5); and ``[wnn-wide]``'s
path on two planted modalities of 2,000 cells (graphs of 301, then WNN
with 300 candidates a modality; three walls) with its fused graph. ``compare`` prints which outputs are the same
bits in every run, and every time side by side.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

T9_INPUTS = ("100k", "2k", "tie19", "tie256", "dup")
SECTIONS = ("t9", "mofa", "wnn_wide", "t5", "t14")
KNN_KS = (19, 200, 300)  # lists of 20, 201, 301: the graphs, WNN's pools, the wide lists
# the device functions of the MOFA sweeps' passes over E (csrc/mofa_kernels.cu)
MOFA_KERNELS = ("col_dot_kernel", "w_posterior_kernel", "row_dot_kernel", "rank1_update_kernel",
                "rank1_col_dot_kernel")


def exact_knn(rep: np.ndarray, kk: int, cuda) -> np.ndarray:
    """The kk nearest other rows of each row, in float64, ids sorted."""
    x = torch.from_numpy(rep).to(cuda).double()
    out = []
    for s in range(0, len(x), 4096):
        d2 = torch.cdist(x[s:s + 4096], x)
        d2[torch.arange(d2.shape[0]), torch.arange(s, s + d2.shape[0])] = float("inf")
        out.append(torch.sort(torch.topk(d2, kk, dim=1, largest=False).indices, dim=1).values)
    return torch.cat(out).int().cpu().numpy()


def make(out: str, sections, cuda) -> None:
    os.makedirs(out, exist_ok=True)
    data = {}
    if "t9" in sections or "t5" in sections:
        data["r100k"] = cs.make_big_rep(0, n=100_000)[0]
    if "t9" in sections:
        data["NI100k"] = exact_knn(data["r100k"], 19, cuda)
        rep, _ = cs.make_big_rep(1, n=2000)
        data["r2k"], data["NI2k"] = rep, exact_knn(rep, 256, cuda)
        for kk, n in ((19, 1000), (256, 600)):
            r = np.random.default_rng(kk).integers(0, n // 5, size=(n, 1)).astype(np.float32)
            data[f"rtie{kk}"], data[f"NItie{kk}"] = r, exact_knn(r, kk, cuda)
        r = np.repeat(cs.make_big_rep(2, n=1000)[0], 4, axis=0)
        NI = exact_knn(r, 19, cuda)
        NI[np.random.default_rng(3).random(len(r)) < 0.15, 16:] = -1
        data["rdup"], data["NIdup"] = r, NI
    if "t14" in sections:
        from muon_tpu_torch.ops import ivf as ti

        rep, _ = cs.make_big_rep(0)
        X = torch.from_numpy(rep).to(cuda)
        C = 1024
        init = np.random.default_rng(0).choice(len(rep), size=C, replace=False)
        cent, assign = ti.kmeans(X, init.astype(np.int32), C, 8)
        order, qids, ppos, pcnt, L = ti.build_ivf_layout(assign.cpu().numpy(), cent.cpu().numpy(),
                                                         C, 8, 1024)
        Xs = X[torch.from_numpy(order).to(cuda).long()].contiguous()
        mu = ti.item_means(Xs, torch.from_numpy(qids).to(cuda))
        data.update(r1m=rep, order=order, qids=qids, ppos=ppos, pcnt=pcnt, L=np.int64(L),
                    mu=mu.cpu().numpy())
    np.savez(f"{out}/inputs.npz", **data)


def event_times(fn, reps: int) -> list:
    """Device times of ``fn`` (CUDA events, ms) over ``reps`` runs after one
    warm-up."""
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
    return times


def event_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` (CUDA events) after one warm-up."""
    return float(np.median(event_times(fn, reps)))


def spread(times) -> dict:
    return {"median": float(np.median(times)), "min": float(min(times)),
            "max": float(max(times))}


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def run_knn(tk, ti, inp, sections, res, times, cuda) -> None:
    """T5 at 100,000 × 50 in both modes and T14 over the whole 1M layout,
    each at k+1 = 20, 201, 301: the outputs' digests and the times."""
    takes_approx = "approx" in inspect.signature(tk.knn_topk).parameters
    if "t5" in sections:
        X = torch.from_numpy(inp["r100k"]).to(cuda)
        for mode in ("f32", "approx"):
            op, sq = tk._operand(X, "euclidean", mode == "approx")
            kw = {"approx": True} if mode == "approx" and takes_approx else {}
            for k in KNN_KS:
                fn = lambda: tk.knn_topk(op, sq, k, False, True, **kw)  # noqa: E731
                idx, dist = fn()
                res[f"t5_{mode}_k{k + 1}_sha256"] = np.array(digest(idx, dist))
                if mode == "approx" and k == KNN_KS[0]:
                    res["t5_approx_k20_idx"], res["t5_approx_k20_dist"] = (
                        idx.cpu().numpy(), dist.cpu().numpy())
                del idx, dist
                times[f"T5 {mode} ms, 100,000 x 50, k+1={k + 1}"] = spread(event_times(fn, 5))
    if "t14" in sections:
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
        Xs = to(inp["r1m"])[to(inp["order"]).long()].contiguous()
        args = (Xs, to(inp["qids"]), to(inp["ppos"]), to(inp["pcnt"]), to(inp["mu"]))
        for k in KNN_KS:
            fn = lambda: ti.ivf_search(*args, k, int(inp["L"]), False)  # noqa: E731
            pos, dist = fn()
            res[f"t14_k{k + 1}_sha256"] = np.array(digest(pos, dist))
            del pos, dist
            times[f"T14 ms, whole 1M layout ({len(inp['qids'])} items), k+1={k + 1}"] = spread(
                event_times(fn, 5))


def run(root: str, tag: str, out: str, sections, cuda) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import muon_tpu_torch
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch.models import mofa as tm
    from muon_tpu_torch.ops import _kernels, ivf as ti, knn as tk, wnn as tw

    if not muon_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {muon_tpu_torch.__file__}, not the tree at {root}")
    _kernels.build()
    inp = np.load(f"{out}/inputs.npz")
    res, times = {}, {}
    if "t9" in sections:
        for key in T9_INPUTS:
            rep = inp[f"r{key}"]
            NI = torch.from_numpy(inp[f"NI{key}"]).to(cuda)
            kk = NI.shape[1]
            args = (NI, *tw._bandwidth_tables(NI, torch.from_numpy(rep).to(cuda)), float(len(rep)),
                    float(np.linalg.norm(np.ptp(rep, axis=0))), min(20, kk), tw._auto_nn_stride(kk))
            res[f"sigma_{key}"] = tw.wnn_bandwidth(*args).cpu().numpy()
            if key == "100k":
                window = dict(row0=50_000, rows=50_000)
                res["sigma_100k_window"] = tw.wnn_bandwidth(*args, **window).cpu().numpy()
                times["T9 ms, 100,000 x 19"] = event_ms(lambda: tw.wnn_bandwidth(*args), 5)
                times["T9 ms, rows 50,000-100,000"] = event_ms(
                    lambda: tw.wnn_bandwidth(*args, **window), 5)
            if key == "2k":
                times["T9 ms, 2,000 x 256 (global)"] = event_ms(lambda: tw.wnn_bandwidth(*args), 3)

    if "mofa" in sections:
        _, Ys = cs.mofa_bench_views(cs.SEED)
        cfg = tm.MOFAConfig(n_factors=cs.MOFA_K, likelihoods=("gaussian", "gaussian"))
        kw = dict(convergence_mode="slow", elbo_every=1000, device=cuda)
        tm.fit_mofa(Ys, cfg, n_iterations=cs.MOFA_WARM, min_iterations=cs.MOFA_WARM, **kw)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit = tm.fit_mofa(Ys, cfg, n_iterations=cs.MOFA_SWEEPS, min_iterations=cs.MOFA_SWEEPS,
                              **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        times["[mofa] 50-sweep walls s"] = walls
        res.update(mofa_Z=fit.Z, mofa_W0=fit.W[0], mofa_W1=fit.W[1], mofa_tau0=fit.tau[0],
                   mofa_tau1=fit.tau[1], mofa_elbo=fit.elbo_history)
        cfg1 = tm.MOFAConfig(n_factors=cs.MOFA_K, likelihoods=("gaussian", "gaussian"), n_groups=1)
        step = tm.make_step(cfg1, list(cs.MOFA_DS), cs.MOFA_N, [False, False])
        state = tm._init_state(Ys, [None, None], np.ones((cs.MOFA_N, 1), np.float32), cfg1,
                               device=cuda)
        for _ in range(2):
            state, _ = step(state)
        times["one sweep ms (events, median of 20)"] = event_ms(lambda: step(state), 20)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step(state)
            torch.cuda.synchronize()
        busy = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            busy[e.key] = busy.get(e.key, 0.0) + us / 5e3
        times["one sweep, device ms (profiler, mean of 5)"] = sum(busy.values())
        times["one sweep, the MOFA kernels' device ms"] = sum(
            v for k, v in busy.items() if any(n in k for n in MOFA_KERNELS))
        del state, Ys

    if "wnn_wide" in sections:
        sub = {}
        for name, key, seed in (("rna", "X_pca", 3), ("atac", "X_lsi", 4)):
            h = cs.Holder(None)
            h.obsm[key] = np.ascontiguousarray(cs.make_big_rep(seed, n=cs.WIDE_CELLS)[0])
            h.n_obs = cs.WIDE_CELLS
            tpp.neighbors(h, n_neighbors=cs.WIDE_KK + 1, use_rep=key, device=cuda)
            sub[name] = h
        walls = []
        for _ in range(3):
            md = cs.MuHolder(sub, cs.WIDE_CELLS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tpp.neighbors(md, n_multineighbors=cs.WIDE_KK, device=cuda)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        times["[wnn-wide] path walls s"] = walls
        res["wnn_wide_connectivities"] = md.obsp["connectivities"].toarray()
    run_knn(tk, ti, inp, sections, res, times, cuda)
    np.savez(f"{out}/{tag}.npz", **res)
    with open(f"{out}/{tag}.json", "w") as f:
        json.dump(times, f)
    print(f"{tag}: {json.dumps(times)}", flush=True)


def compare(out: str, tags) -> None:
    runs = {t: np.load(f"{out}/{t}.npz") for t in tags}
    for key in runs[tags[0]].files:
        groups = []  # runs whose outputs are the same bits
        for t in tags:
            for g in groups:
                if np.array_equal(runs[g[0]][key], runs[t][key]):
                    g.append(t)
                    break
            else:
                groups.append([t])
        print(f"{key}: the same bits in every run: {len(groups) == 1}"
              + ("" if len(groups) == 1 else f"; groups {groups}"), flush=True)
        if key == "t5_approx_k20_idx" and len(groups) > 1:
            a, b = runs[groups[0][0]], runs[groups[1][0]]
            print(f"  T5 approx, k+1 = 20, {groups[0][0]} against {groups[1][0]}: equal indices "
                  f"{(a[key] == b[key]).mean():.6f}, largest distance difference "
                  f"{np.abs(a['t5_approx_k20_dist'] - b['t5_approx_k20_dist']).max():.3e}",
                  flush=True)
    times = {t: json.load(open(f"{out}/{t}.json")) for t in tags}
    for key in times[tags[0]]:
        print(f"{key}: " + "; ".join(f"{t} {times[t][key]}" for t in tags), flush=True)


def parse_sections(arg) -> tuple:
    chosen = tuple(arg[0].split(",")) if arg else SECTIONS
    unknown = set(chosen) - set(SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; choose from {SECTIONS}")
    return chosen


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_compare_trees: no CUDA device", file=sys.stderr)
        return 1
    cuda = torch.device("cuda", 0)
    mode = sys.argv[1]
    if mode == "make":
        make(sys.argv[2], parse_sections(sys.argv[3:4]), cuda)
    elif mode == "run":
        run(sys.argv[2], sys.argv[3], sys.argv[4], parse_sections(sys.argv[5:6]), cuda)
    else:
        compare(sys.argv[2], sys.argv[3:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
