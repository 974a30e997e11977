"""Two checkouts of the port on one card: T9's σ, the MOFA bench fit, the
wide WNN path, T5, T14, T40, T2's split variant, T3, T36, the MOFA
sweeps around T18, the wilcoxon markers (T26, and its dense route), the
1M k-means (T15), the UMAP epochs (T13), MEFISTO's kernel matrices (T24)
and WNN's fusion scores (T11), for a change held beside its parent in one
call.

Run on a machine with a CUDA card, from the root of the repo, with the
other tree unpacked somewhere (``git archive <commit> | tar -x -C DIR``):

    python3 exp_compare_trees.py make OUT [SECTIONS]
    python3 exp_compare_trees.py run DIR parent1 OUT [SECTIONS]  # the other tree
    python3 exp_compare_trees.py run . change1 OUT [SECTIONS]    # this tree
    ...                                                          # in turns
    python3 exp_compare_trees.py compare OUT parent1 change1 ...

SECTIONS is a comma-separated subset of
``t9,mofa,wnn_wide,t5,t14,t40,t2split,t3,t36,t18,t26,t15,t13,t24,t11,t26d``
(all by default). ``t5``: T5 on ``make_big_rep`` at 100,000 × 50, float32 and
approx (the rows ``_operand`` rounds to bfloat16; a tree whose ``knn_topk``
has no ``approx`` argument takes them as float32), at k+1 = 20, 201 and
301. ``t14``: T14 over the whole work-item layout of the 1M representation
(``make_big_rep(0)``, C = 1024 k-means clusters from the rows
``default_rng(0)`` picks, 8 Lloyd steps, 8 probes, QB = 1024; the layout
and μ made once by ``make``), at the same three k. ``t40``: T40's rounds
from the first round's empty lists, rank 0's whole ring at P = 1 ([mesh1]'s
one round, 100,000 × 100,000), 2 (two rounds of 50,000 × 50,000: [mesh2])
and 4 (four of 25,000 × 25,000: [mesh4]) over [mesh1]'s representation
(the z-scored LSI of ``make_counts``, 100,000 × 50, made on one device), at
k+1 = 21, 201 and 301, and over the e2e's RNA representation (its X_pca,
100,000 × 50) at P = 2 and k+1 = 201 (a round of WNN's candidates over the
mesh): the digest of each round's lists and each round's time; a tree that
cuts a round's rows into parts (``ring_parts``) also times each round at
1, 2, 4 and 8 parts and holds each to the automatic count's bits. ``t2split``:
T2's split variant at ``[scopen]``'s two products (Xᵀ·W and X·Hᵀ of the
e2e's ATAC counts as ``scopen_operands`` builds them, l = 30, W and Hᵀ
uniform from seed 0) through ``spmm_split``; a tree with the shared
gather also launches it on the unpadded B (its rows 30 values apart: one
value a lane over the whole warp, group 32), whose sums run in the order
of the parent's split kernel, so that digest is held to the parent's
``spmm_split``; it times that launch and ``spmm_split`` building the
piece table each call. ``t3``: T3 at the
gather path's shapes (the TF-IDF of ``make_counts``, Xᵀ prebuilt, l = 60
float32 and bfloat16). ``t36``: T36's ``pwm_scan_hits`` on
chip_smoke.py's ``[motifs]`` data (100,000 peaks of 500 bp from its seeded
genome, all 746 JASPAR motifs at p = 1e-4; a tree whose wrapper takes a
packed ``screen`` is handed one, packed once and timed apart): the hits and
the per-pair counts, the call at 100,000 and at 10,000 peaks, its
``motifs/count`` and ``motifs/write`` stages (host clock, synchronised),
and ``F.conv1d``'s scores at 10,000 peaks (TF32 off). ``t18``: the
``mofa`` section's fit, sweep and device times, and the e2e's SVI at
100,000 cells (the 256 most variable columns of the normalised RNA and the
TF-IDF ATAC of ``make_e2e_counts``, made once by ``make``; 100 iterations,
three walls) with its outputs. ``t26``: ``tl.rank_genes_groups(method=
"wilcoxon")`` on chip_smoke.py's ``[de]`` data (the normalised RNA, 100,000
× 20,000, and the TF-IDF ATAC, 100,000 × 25,000, of ``make_e2e_counts``,
made once by ``make``; the 20 planted labels): every field of ``uns``,
three walls, the stages of the last and the peak device memory above what
was held. ``t15``: the 1M k-means as ``ivf_knn`` runs it (``make_big_rep(0)``,
C = 1024 from the rows ``default_rng(0)`` picks, 8 Lloyd steps, then the
final assignment): the centroids and the assignment, three walls, T15
alone at the final centroids (CUDA events), and the rounding of X that its
wrapper makes (``knn._bf16_rows``) beside four other ways of building it.
``t13``: chip_smoke.py's two UMAP graphs, made once by ``make`` (the
connectivities of the e2e's WNN of three modalities at 100,000 cells, and
of ``pp.neighbors(20)`` of ``make_big_rep(0)`` at 1,000,000 with its
membership table), their row lengths after the edge schedule's pruning
(``make`` prints them); one epoch (epoch 0, 8 and 13, 5 negatives drawn
once) from the spectral start at 100k and a random one at 1M: ``emb_out``
and ``eons``, and T13's time (fresh eons each call, CUDA events with a
spin queued before the start event, as chip_smoke.py's ``median_ms``);
then ``tl.umap``'s 200 epochs on each graph: the layout and
``umap/sgd_200epochs`` of three runs after a warm one. ``t24``: T24 at
``[kernel] gp_rbf_kernel``'s shapes (gp_K 10 × 3000² with a learned Kg,
K_nm 100,000 × 1,000 and K_mm 1,000² of one factor, the smoke's draws): the
matrices and their times (spun as T13's); and the
smoke's dense ``[mefisto]`` fit (3,000 cells, 100 sweeps): its ELBO trace,
Z and the chosen lengthscales, and its wall. ``t11``: T11 on the three
calls chip_smoke.py makes, their arguments recorded by ``make`` (the WNN
of three modalities at 100,000 cells: the e2e's RNA, ATAC and protein
graphs; the ``[wnn-wide]`` path; and ``[mesh2]`` rank 1's window, rows
50,000-100,000 of the first): the scores' digests, each launch's time
(spun as T13's) and the candidate rows it gathers (bytes and their rate);
a tree with ``ops.wnn.padded_table`` is handed the table padded once, as
its ``wnn_neighbors`` builds it. Then ``pp.neighbors`` of the MuData
rebuilt from the three saved graphs (``chip_smoke.wnn_mods``): the digests
of ``obsp["distances"]`` and ``obsp["connectivities"]`` and its wall.
``t26d``: ``[de]``'s dense route: the normalised RNA of the ``t26``
inputs densified on the card, then ``tl.rank_genes_groups(method=
"wilcoxon")``: every field of ``uns``, the wall, and each T26 launch's
time (CUDA events around the launch alone, with a spin before its start,
as chip_smoke.py's ``launch_ms``). Each writes a SHA-256
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
import tempfile
import time

import numpy as np
import torch

import chip_smoke as cs

T9_INPUTS = ("100k", "2k", "tie19", "tie256", "dup")
SECTIONS = ("t9", "mofa", "wnn_wide", "t5", "t14", "t40", "t2split", "t3", "t36", "t18", "t26",
            "t15", "t13", "t24", "t11", "t26d", "t41", "t33")
UMAP_EPOCHS = (0, 8, 13)  # T13 at the epoch of every stride, and two of fewer
KMEANS_C, KMEANS_ITERS = 1024, 8  # the 1M path's partition (ops/ivf.ivf_knn)
KNN_KS = (19, 200, 300)  # lists of 20, 201, 301: the graphs, WNN's pools, the wide lists
RING_K1S = (21, 201, 301)  # T40's lists: the mesh graphs', WNN's pools, the wide lists
SCOPEN_L = 30  # scOpen's factors (chip_smoke.py SCOPEN_K)
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
    if "t15" in sections:
        data["r1m"] = cs.make_big_rep(0)[0]
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
    if "t40" in sections or "t3" in sections:
        from muon_tpu_torch import atac as tac

        h = cs.Holder(cs.make_counts(cs.SEED))
        if "t3" in sections:
            data.update(counts_data=h.X.data, counts_indices=h.X.indices,
                        counts_indptr=h.X.indptr)
        tac.pp.tfidf(h, device=cuda)
        if "t3" in sections:
            data["tfidf_data"] = h.X.data
        tac.tl.lsi(h, n_comps=cs.K, n_iter=cs.N_ITER, random_state=cs.SEED, device=cuda)
        data["lsi100k"] = np.ascontiguousarray(h.obsm["X_lsi"], dtype=np.float32)
    if "t40" in sections or "t2split" in sections or "t33" in sections:
        from muon_tpu_torch import pp as tpp
        from muon_tpu_torch.ops import sparse as dsp

        X_rna, X_atac, *_ = cs.make_e2e_counts(cs.SEED)
        if "t40" in sections:
            h = cs.Holder(cs.normalise(dsp, X_rna, cuda))
            tpp.pca(h, n_comps=cs.K, random_state=cs.SEED, device=cuda)
            data["rna100k"] = np.ascontiguousarray(h.obsm["X_pca"], dtype=np.float32)
        if "t2split" in sections or "t33" in sections:
            from muon_tpu_torch.ops import nmf as tnmf

            X, XT = tnmf.scopen_operands(X_atac, device=cuda)
            C = getattr(XT, "csr", XT)  # cells x peaks, binarised and scaled
            data.update(xt_data=C.data.cpu().numpy(), xt_indices=C.indices.cpu().numpy(),
                        xt_indptr=C.indptr.cpu().numpy(), xt_shape=np.array(C.shape))
        if "t33" in sections:
            # scOpen's starts from seed 0 and the two updates' numerators
            W, Ht = tnmf._starts(X, SCOPEN_L, 0, None, None)
            data.update(t33_W=W.cpu().numpy(), t33_Ht=Ht.cpu().numpy(),
                        t33_XtW=dsp.spmm_split(XT, W).cpu().numpy(),
                        t33_XHt=dsp.spmm_split(X, Ht).cpu().numpy())
    if "t36" in sections:
        from muon_tpu_torch import atac as tac
        from muon_tpu_torch.atac import motifs as tmf
        from muon_tpu_torch.ops import pwm as tpw

        with tempfile.TemporaryDirectory() as tmp:
            names, _, parsed = cs.make_motif_data(tmf, tpw, f"{tmp}/genome.fa")
            seqs = tac.tl.get_sequences(cs.PeakHolder(names), None,
                                        fasta_file=f"{tmp}/genome.fa")
        lo, off, width = tpw.pack_motifs(parsed["matrices"])
        thr = tpw.threshold_f32([tpw.threshold_from_p(m, pvalue=cs.MOTIF_P)
                                 for m in parsed["matrices"]])
        data.update(motif_codes=tpw.encode_sequences(seqs), motif_lo=lo, motif_off=off,
                    motif_width=width, motif_thr=thr)
    if "t11" in sections:
        data.update(make_t11(out, cuda))
    if "t26" in sections or "t26d" in sections:
        from muon_tpu_torch import atac as tac
        from muon_tpu_torch.ops import sparse as dsp

        X_rna, X_atac, _, labels, _ = cs.make_e2e_counts(cs.SEED)
        h = cs.Holder(X_atac)
        tac.pp.tfidf(h, device=cuda)
        for name, X in (("de_rna", cs.normalise(dsp, X_rna, cuda)), ("de_atac", h.X)):
            data.update({f"{name}_data": X.data, f"{name}_indices": X.indices,
                         f"{name}_indptr": X.indptr, f"{name}_shape": np.array(X.shape)})
        data["de_labels"] = labels
    if "t18" in sections:
        from muon_tpu_torch import atac as tac
        from muon_tpu_torch.ops import sparse as dsp

        X_rna, X_atac, *_ = cs.make_e2e_counts(cs.SEED)
        h = cs.Holder(X_atac)
        tac.pp.tfidf(h, device=cuda)
        for name, X in (("svi_rna", cs.normalise(dsp, X_rna, cuda)), ("svi_atac", h.X)):
            data[name] = cs.topvar_dense(dsp, X, cuda, cs.MOFA_COLS).cpu().numpy()
    if "t13" in sections or "t41" in sections:
        data.update(make_umap_graphs(cuda))
    np.savez(f"{out}/inputs.npz", **data)


def wide_modalities(tpp, cuda) -> dict:
    """``[wnn-wide]``'s two planted modalities of 2,000 cells with graphs
    of 301."""
    sub = {}
    for name, key, seed in (("rna", "X_pca", 3), ("atac", "X_lsi", 4)):
        h = cs.Holder(None)
        h.obsm[key] = np.ascontiguousarray(cs.make_big_rep(seed, n=cs.WIDE_CELLS)[0])
        h.n_obs = cs.WIDE_CELLS
        tpp.neighbors(h, n_neighbors=cs.WIDE_KK + 1, use_rep=key, device=cuda)
        sub[name] = h
    return sub


def make_t11(out: str, cuda) -> dict:
    """T11's arguments in the WNN of three at 100,000 cells (with the
    three graphs, as chip_smoke.save_wnn_inputs writes them into OUT) and
    in the ``[wnn-wide]`` path."""
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import prot as tpt
    from muon_tpu_torch.ops import fuzzy as tf, knn as tk, sparse as dsp, wnn as tw

    X_rna, X_atac, P, _, _ = cs.make_e2e_counts(cs.SEED)
    mods = {"rna": cs.rna_path(dsp, tpp, X_rna, cuda),
            "atac": cs.atac_e2e_path(tac, tpp, X_atac, cuda), "prot": cs.prot_path(tpt, tpp, P, cuda)}
    md = cs.MuHolder(mods)
    with cs.wnn_probe(tw, tk, tf, plain=False) as rec:
        tpp.neighbors(md, device=cuda)
    cs.save_wnn_inputs(tw, out, mods, rec, md)
    mdw = cs.MuHolder(wide_modalities(tpp, cuda), cs.WIDE_CELLS)
    with cs.wnn_probe(tw, tk, tf, plain=False) as rec:
        tpp.neighbors(mdw, n_multineighbors=cs.WIDE_KK, device=cuda)
    cand, cat16, aux, sigw, dims, metric = rec["fusion"][0][0]
    return dict(wide_cand=cand.cpu().numpy(), wide_cat16=cat16.view(torch.int16).cpu().numpy(),
                wide_aux=aux.cpu().numpy(), wide_sigw=sigw.cpu().numpy(),
                wide_dims=np.array(dims), wide_metric=np.array(metric), wnn_mods=np.array(list(mods)))


def row_lengths(G, n_epochs: int = cs.N_EPOCHS) -> dict:
    """The lengths of T13's rows: the edges per head after the edge
    schedule's pruning."""
    from muon_tpu_torch.ops import umap as tu

    heads = tu.edge_schedule(G, n_epochs)[0]
    L = np.bincount(heads, minlength=G.shape[0])
    return {"edges": int(L.sum()), "mean": float(L.mean()), "median": float(np.median(L)),
            "p99": float(np.percentile(L, 99)), "max": int(L.max()),
            "empty": int((L == 0).sum()), "over_64": int((L > 64).sum())}


def make_umap_graphs(cuda) -> dict:
    """The smoke's UMAP graphs (100k: the e2e's WNN; 1M: pp.neighbors(20) of
    make_big_rep(0), with its membership table), each epoch's start and
    negatives."""
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import prot as tpt
    from muon_tpu_torch.ops import fuzzy as tf
    from muon_tpu_torch.ops import ivf as ti
    from muon_tpu_torch.ops import sparse as dsp
    from muon_tpu_torch.ops import umap as tu

    data = {}
    X_rna, X_atac, P, *_ = cs.make_e2e_counts(cs.SEED)
    mods = {"rna": cs.rna_path(dsp, tpp, X_rna, cuda),
            "atac": cs.atac_e2e_path(tac, tpp, X_atac, cuda),
            "prot": cs.prot_path(tpt, tpp, P, cuda)}
    md = cs.MuHolder(mods)
    tpp.neighbors(md, device=cuda)
    graphs = {"100k": md.obsp["connectivities"].tocsr()}
    del X_rna, X_atac, P, mods, md
    h = cs.big_holder(cs.make_big_rep(cs.SEED)[0])
    ti._PARTITION_CACHE.clear()
    tpp.neighbors(h, n_neighbors=cs.N_NEIGHBORS, use_rep="X_rep", device=cuda)
    graphs["1m"] = h.obsp["connectivities"]
    tag = getattr(graphs["1m"], tf.MEMBERSHIP_TAG)
    data.update(umap1m_member_idx=tag["idx"], umap1m_member_vals=tag["vals"])
    del h
    for key, G in graphs.items():
        n = G.shape[0]
        data.update({f"umap{key}_data": G.data, f"umap{key}_indices": G.indices,
                     f"umap{key}_indptr": G.indptr})
        print(f"make: T13's rows at {key}: {row_lengths(G)}", flush=True)
        if key == "100k":
            start = tu.spectral_init(G, 2, seed=42, device=cuda)
        else:
            gen = torch.Generator(device=cuda).manual_seed(13)
            start = (torch.rand((n, 2), generator=gen, device=cuda) * 20 - 10).cpu().numpy()
        data[f"umap{key}_start"] = start
        rng = np.random.default_rng(3)
        data[f"umap{key}_negs"] = rng.integers(0, n, (n, 5), dtype=np.int32)
    return data


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


def spun_times(fn, reps: int) -> list:
    """As ``event_times``, with a spin of about a millisecond queued before
    each start event (chip_smoke.median_ms), so the device is still busy
    while the host enqueues ``fn``: the time of its launches, not of the
    host's gap before them."""
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
    return times


epoch_eons = cs.epoch_eons  # the eons an edge holds at an epoch of its schedule


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


def ring_rounds(tk, rep, P: int, k1: int, cuda):
    """Rank 0's ring at P ranks over ``rep`` (as ``sharded_knn`` runs it):
    each round's (od, oi), from the first round's empty lists."""
    n, d = rep.shape
    R = -(-n // P)
    Q = rep[:R].contiguous()
    sq_q = (Q * Q).sum(1)
    cd = torch.full((R, k1), float("inf"), device=cuda)
    ci = torch.full((R, k1), -1, dtype=torch.int32, device=cuda)
    rounds = []
    for r in range(P):
        off = ((0 - r) % P) * R
        B = torch.zeros((R, d), device=cuda)
        B[:min(R, n - off)] = rep[off:off + R]
        args = (Q, sq_q, B, (B * B).sum(1), off, n, cd, ci)
        rounds.append((args, lambda a=args: tk.knn_ring_merge(*a)))
        cd, ci = rounds[-1][1]()
    return rounds


def run_ring(tk, inp, res, times, cuda) -> None:
    """T40: rank 0's rounds at P = 1, 2, 4 over [mesh1]'s representation at
    k+1 = 21, 201, 301, and at P = 2 over the e2e's RNA one at k+1 = 201;
    every round's digest and time, and where the tree cuts a round into
    parts (``ring_parts``), the times at 1, 2, 4 and 8 parts, each held to
    the automatic count's bits."""
    takes_parts = hasattr(tk, "ring_parts")
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = [("lsi", P, k1) for k1 in RING_K1S for P in (1, 2, 4)] + [("rna", 2, 201)]
    for src, P, k1 in cases:
        rep = torch.from_numpy(inp[f"{src}100k"]).to(cuda)
        rounds = ring_rounds(tk, rep, P, k1, cuda)
        for r, (args, fn) in enumerate(rounds):
            key = f"t40_{src}_P{P}_k{k1}_round{r}"
            res[f"{key}_sha256"] = np.array(digest(*fn()))
            nq, nb = args[0].shape[0], args[2].shape[0]
            label = f"T40 ms, {src} P={P} round {r} ({nq} x {nb}), k+1={k1}"
            times[label] = spread(event_times(fn, 5))
            if not takes_parts:
                continue
            auto = tk.ring_parts(nq, min(nb, args[5] - args[4]), k1, sms)
            times[f"{label}: automatic parts"] = auto
            chosen = tk.ring_parts
            for p in sorted({1, 2, 4, tk.RING_MAX_PARTS}):
                tk.ring_parts = lambda *a, p=p: p
                same = digest(*fn()) == str(res[f"{key}_sha256"])
                times[f"{label}, parts={p}"] = {"same_bits": same, **spread(event_times(fn, 5))}
            tk.ring_parts = chosen
        del rounds, rep


def run_split(tsp, inp, res, times, cuda) -> None:
    """T2's split variant at [scopen]'s two products, and in a tree with the
    shared gather one value a lane over the unpadded B (the parent kernel's
    order)."""
    from muon_tpu_torch.ops import _kernels
    from scipy import sparse as sp

    shape = tuple(int(v) for v in inp["xt_shape"])
    XTs = sp.csr_matrix((inp["xt_data"], inp["xt_indices"], inp["xt_indptr"]), shape=shape)
    XT = tsp.from_scipy(XTs, cuda)
    X = tsp.transpose(XT).csr
    shared = hasattr(tsp, "pieced")
    ops = {"X^T.W": (tsp.pieced(XT) if shared else XT, shape[1]),
           "X.H^T": (tsp.pieced(X) if shared else X, shape[0])}
    rng = np.random.default_rng(0)
    for name, (A, rows) in ops.items():
        B = torch.from_numpy(rng.random((rows, SCOPEN_L), dtype=np.float32)).to(cuda)
        fn = lambda A=A, B=B: tsp.spmm_split(A, B)  # noqa: E731
        res[f"t2split_{name}_sha256"] = np.array(digest(fn()))
        res[f"t2split_{name}_repeat_same_bits"] = np.array(digest(fn()) == digest(fn()))
        times[f"T2 split ms, {name}, l={SCOPEN_L}"] = spread(event_times(fn, 5))
        if not shared:
            res[f"t2split_{name}_vw1_sha256"] = res[f"t2split_{name}_sha256"]
            continue
        C = A.csr

        def raw(Bx):
            part = torch.empty((max(A.n_pieces, 1), SCOPEN_L), device=cuda)
            out = torch.empty((C.n_rows, SCOPEN_L), device=cuda)
            _kernels.launch("csr_spmm_split", cuda, C.data.data_ptr(), C.indptr.data_ptr(),
                            C.indices.data_ptr(), A.row_first.data_ptr(), C.n_rows,
                            A.n_pieces, tsp._PIECE, Bx.data_ptr(), SCOPEN_L, SCOPEN_L,
                            part.data_ptr(), out.data_ptr())
            return out

        res[f"t2split_{name}_vw1_sha256"] = np.array(digest(raw(B)))
        times[f"T2 split ms, {name}, one value a lane (B unpadded)"] = spread(
            event_times(lambda: raw(B), 5))
        times[f"T2 split ms, {name}, its piece table built each call"] = spread(
            event_times(lambda C=C, B=B: tsp.spmm_split(C, B), 5))


def run_t3(tsp, inp, res, times, cuda) -> None:
    """T3 at the gather path's shapes: Xᵀ·B over the prebuilt Xᵀ of the
    TF-IDF of make_counts, l = 60, float32 and bfloat16."""
    from scipy import sparse as sp

    Xs = sp.csr_matrix((inp["tfidf_data"], inp["counts_indices"], inp["counts_indptr"]),
                       shape=(cs.N_CELLS, cs.N_PEAKS))
    X = tsp.from_scipy(Xs, cuda)
    Xt = tsp.transpose(X)
    B = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (cs.N_CELLS, cs.K + 10), dtype=np.float32)).to(cuda)
    for dt in (torch.float32, torch.bfloat16):
        Bd = B.to(dt)
        fn = lambda Bd=Bd: tsp.spmm_t(X, Bd, Xt)  # noqa: E731
        name = str(dt).split(".")[-1]
        res[f"t3_{name}_sha256"] = np.array(digest(fn()))
        times[f"T3 ms, {cs.N_CELLS} x {cs.N_PEAKS}, l={cs.K + 10} {name}"] = spread(
            event_times(fn, 5))


def run_t36(tpw, profiling, inp, res, times, cuda) -> None:
    """T36 at the [motifs] path's call: the hits and counts' digests, the
    call's time at 100,000 and 10,000 peaks, its two stages, and F.conv1d's
    scores at 10,000 peaks."""
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    codes = to(inp["motif_codes"])
    lo, off, width, thr = (to(inp[f"motif_{k}"]) for k in ("lo", "off", "width", "thr"))
    n, M = codes.shape[0], len(off)
    kw = {}
    if "screen" in inspect.signature(tpw.pwm_scan_hits).parameters:
        t0 = time.perf_counter()
        host = tpw.pack_screen(*(inp[f"motif_{k}"] for k in ("lo", "off", "width", "thr")))
        times["T36 screen packed on the host, ms"] = 1e3 * (time.perf_counter() - t0)
        kw["screen"] = host.to(cuda)
        times["T36 screen margins min/median/max"] = [
            float(host.margin.min()), float(np.median(host.margin)), float(host.margin.max())]
        cand = torch.zeros(1, dtype=torch.int64, device=cuda)
        tpw.pwm_scan_hits(codes, lo, off, width, thr, candidates=cand, **kw)
        times["T36 candidates of the count pass"] = int(cand.item())
    fn = lambda c=codes: tpw.pwm_scan_hits(c, lo, off, width, thr, **kw)  # noqa: E731
    hits = fn()
    res["t36_hits_sha256"] = np.array(digest(*hits))
    counts = torch.bincount(hits[0].long() * M + hits[1].long(), minlength=n * M)
    res["t36_counts_sha256"] = np.array(digest(counts.int()))
    res["t36_n_hits"] = np.array(len(hits[0]))
    del hits, counts
    times["T36 ms, 100,000 x 500 bp x 746 (count + write)"] = spread(event_times(fn, 5))
    stages = {"motifs/count": [], "motifs/write": []}
    for _ in range(5):
        with profiling.collect() as t:
            fn()
        for k in stages:
            stages[k].append(1e3 * t[k][0])
    for k, v in stages.items():
        times[f"T36 stage {k} ms (host clock, synchronised), 100,000 peaks"] = spread(v)
    c10 = codes[:10_000].contiguous()
    times["T36 ms, 10,000 x 500 bp x 746 (count + write)"] = spread(
        event_times(lambda: fn(c10), 5))
    onehot = torch.zeros((*c10.shape, 4), device=cuda)
    onehot.scatter_(2, c10.clamp(max=3).long().unsqueeze(2), (c10 < 4).float().unsqueeze(2))
    onehot = onehot.permute(0, 2, 1).contiguous()
    groups = {}
    for m, w in enumerate(width.tolist()):
        groups.setdefault(w, []).append(m)
    weights = [lo[off[midx].long().unsqueeze(1) + torch.arange(w, device=cuda)]
               .permute(0, 2, 1).contiguous() for w, midx in groups.items()]

    def conv_scores():
        before = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for W in weights:
                torch.nn.functional.conv1d(onehot, W)
        finally:
            torch.backends.cudnn.allow_tf32 = before

    times["F.conv1d scores ms, 10,000 x 500 bp x 746 (18 widths, TF32 off)"] = spread(
        event_times(conv_scores, 5))
    del onehot, weights
    torch.cuda.empty_cache()


def run_svi(tm, inp, res, times, cuda) -> None:
    """The e2e's SVI at 100,000 cells: 100 iterations of 50,000 cells,
    three walls, and the fit's outputs."""
    views = [torch.from_numpy(inp[k]).to(cuda) for k in ("svi_rna", "svi_atac")]  # as the smoke
    cfg = tm.MOFAConfig(n_factors=cs.MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(n_iterations=cs.MOFA_ITERS, min_iterations=20, svi_mode=True,
              svi_batch_fraction=min(cs.MOFA_BATCH / cs.N_CELLS, 1.0), elbo_every=5,
              device=cuda)
    tm.fit_mofa(views, cfg, **{**kw, "n_iterations": 2})  # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = tm.fit_mofa(views, cfg, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    times["[mofa-e2e] SVI 100 iterations at 100k, walls s"] = walls
    times["[mofa-e2e] SVI ms an iteration (median wall)"] = 1e3 * float(np.median(walls)) / \
        cs.MOFA_ITERS
    res.update(svi_Z=fit.Z, svi_W0=fit.W[0], svi_W1=fit.W[1], svi_tau0=fit.tau[0],
               svi_tau1=fit.tau[1], svi_elbo=fit.elbo_history)


def run_t26(ttl, profiling, inp, res, times, cuda) -> None:
    """The [de] path's wilcoxon on the RNA and the ATAC: uns, walls, stages,
    peak memory."""
    from scipy import sparse as sp

    for name in ("de_rna", "de_atac"):
        X = sp.csr_matrix((inp[f"{name}_data"], inp[f"{name}_indices"], inp[f"{name}_indptr"]),
                          shape=tuple(inp[f"{name}_shape"]))
        walls = []
        for _ in range(3):
            h = cs.DEHolder(X, inp["de_labels"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with profiling.collect() as t:
                t0 = time.perf_counter()
                ttl.rank_genes_groups(h, "planted", method="wilcoxon", device=cuda)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
        times[f"[de] wilcoxon {name} walls s"] = walls
        times[f"[de] wilcoxon {name} stages s (the last)"] = cs.stage_seconds(t)
        times[f"[de] wilcoxon {name} peak GiB above the held"] = (
            torch.cuda.max_memory_allocated() - base) / 2**30
        uns = h.uns["rank_genes_groups"]
        for field in ("names", "scores", "pvals", "pvals_adj", "logfoldchanges"):
            res[f"t26_{name}_{field}"] = np.array([uns[field][g] for g in uns[field].dtype.names],
                                                  dtype=str if field == "names" else None)
        del h, uns


def run_t15(ti, inp, res, times, cuda) -> None:
    """The 1M k-means (8 Lloyd steps and the final assignment) and T15 alone
    at its final centroids."""
    X = torch.from_numpy(inp["r1m"]).to(cuda)
    init = np.random.default_rng(0).choice(len(X), size=KMEANS_C, replace=False).astype(np.int32)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cent, assign = ti.kmeans(X, init, KMEANS_C, KMEANS_ITERS)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    times["ivf/kmeans, 1M x 50, C = 1024, 8 steps and the final assignment, walls s"] = walls
    res.update(t15_cent=cent.cpu().numpy(), t15_assign=assign.cpu().numpy())
    times["T15 ms, 1M x 50, C = 1024 (the final centroids)"] = spread(
        event_times(lambda: ti.kmeans_assign(X, cent), 5))
    from muon_tpu_torch.ops import knn as tk

    times["of it, X as padded bfloat16 rows (knn._bf16_rows) ms"] = spread(
        event_times(lambda: tk._bf16_rows(X), 5))
    times.update(rounding_variants(X))


def rounding_variants(X) -> dict:
    """``knn._bf16_rows``'s operand (X as bfloat16, rows padded with zeros to
    a multiple of 16) built in other ways, each timed (CUDA events) and held
    to the tree's bits."""
    from muon_tpu_torch.ops import knn as tk

    n, d = X.shape
    ld = -(-d // 16) * 16

    def empty_then_pad():
        out = torch.empty((n, ld), dtype=torch.bfloat16, device=X.device)
        out[:, :d] = X
        out[:, d:] = 0
        return out

    def cast_then_copy():
        out = torch.empty((n, ld), dtype=torch.bfloat16, device=X.device)
        out[:, :d] = X.to(torch.bfloat16)
        out[:, d:] = 0
        return out

    variants = {
        "empty, X copied in, the padding zeroed": empty_then_pad,
        "X.to(bfloat16), then F.pad": lambda: torch.nn.functional.pad(
            X.to(torch.bfloat16), (0, ld - d)),
        "torch.cat of X.to(bfloat16) and zeros": lambda: torch.cat(
            [X.to(torch.bfloat16), X.new_zeros((n, ld - d), dtype=torch.bfloat16)], 1),
        "X.to(bfloat16), copied into empty rows, the padding zeroed": cast_then_copy,
    }
    want = tk._bf16_rows(X)
    return {f"of it, the rounding as {name} ms (the same bits: "
            f"{torch.equal(fn(), want)})": spread(event_times(fn, 5))
            for name, fn in variants.items()}


def umap_graph(inp, key: str):
    """A graph of ``make_umap_graphs`` as the connectivities pp.neighbors
    left (the 1M graph with its membership tag)."""
    from scipy import sparse as sp

    from muon_tpu_torch.ops import fuzzy as tf

    indptr = inp[f"umap{key}_indptr"]
    n = len(indptr) - 1
    G = sp.csr_matrix((inp[f"umap{key}_data"], inp[f"umap{key}_indices"], indptr),
                      shape=(n, n))
    if f"umap{key}_member_idx" in inp.files:
        idx, vals = inp[f"umap{key}_member_idx"], inp[f"umap{key}_member_vals"]
        setattr(G, tf.MEMBERSHIP_TAG, {"idx": idx, "vals": vals, "n": n, "nnz": int(G.nnz),
                                       "set_op_mix_ratio": 1.0})
    return G


def run_t13(ttl, tu, profiling, inp, res, times, cuda) -> None:
    """One epoch at epochs 0, 8 and 13 from the saved start at 100k and 1M
    (the outputs' digests, T13's times), then tl.umap's 200 epochs on each
    graph (the layout, its sgd stage)."""
    a, b = tu.find_ab_params()
    for key in ("100k", "1m"):
        G = umap_graph(inp, key)
        heads, tails, eps, _, dc = tu.edge_schedule(G, cs.N_EPOCHS)
        edges = tu.umap_edges(heads, tails, eps, tu.bucket_shifts(eps, cs.N_EPOCHS),
                              G.shape[0], cuda)
        emb0 = torch.from_numpy(inp[f"umap{key}_start"]).to(cuda)
        negs = torch.from_numpy(inp[f"umap{key}_negs"]).to(cuda)
        dct = torch.from_numpy(dc).to(cuda)
        buf = torch.empty_like(emb0)
        for epoch in UMAP_EPOCHS:
            fresh = torch.from_numpy(epoch_eons(eps, epoch)).to(cuda)
            args = (dct, negs, epoch, tu.epoch_alpha(1.0, epoch, cs.N_EPOCHS), a, b, 1.0)
            eons = fresh.clone()
            out = tu.umap_epoch(emb0, torch.empty_like(emb0), edges, eons, *args)
            res[f"t13_{key}_epoch{epoch}_sha256"] = np.array(digest(out, eons))
            due = int((eons != fresh).sum())
            pool = [fresh.clone() for _ in range(7)]
            times[f"T13 ms at {key}, epoch {epoch} ({due} of {len(eps)} edges due)"] = spread(
                spun_times(lambda: tu.umap_epoch(emb0, buf, edges, pool.pop(), *args), 5))
        walls, sgd = [], []
        for rep in range(4):
            h = cs.Holder(None)
            h.obsp["connectivities"] = G
            h.uns["neighbors"] = {"connectivities_key": "connectivities"}
            with profiling.collect() as t:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ttl.umap(h, device=cuda)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if rep:
                walls.append(wall)
                sgd.append(t[f"umap/sgd_{cs.N_EPOCHS}epochs"][0])
        res[f"t13_{key}_layout"] = h.obsm["X_umap"]
        times[f"tl.umap at {key}, walls s"] = walls
        times[f"umap/sgd_{cs.N_EPOCHS}epochs at {key}, s"] = sgd
        del edges, emb0, negs, dct, buf, G


def run_t41(tu, inp, res, times, cuda) -> None:
    """T41 on the two windows of [mesh2] (P = 2: vertices [0, ⌈n/2⌉) and the
    rest) of each UMAP graph, no strides: epochs 0, 8 and 13 from the saved
    start with fresh eons each call (out_blk and eons, the launch's time);
    on rank 0's window also T13's entry point on the window with its zero
    shift (the run kernel reading a byte an edge; rank 0's window starts at
    vertex 0, so T13's indexing is the window's); then 200 epochs of the two
    windows in turn, each summed from the same layout and their rows
    concatenated as all_gather_rows would: the final layout and the loop's
    wall."""
    from muon_tpu_torch.ops import _kernels

    a, b = tu.find_ab_params()
    for key in ("100k", "1m"):
        G = umap_graph(inp, key)
        n = G.shape[0]
        heads, tails, eps, _, dc = tu.edge_schedule(G, cs.N_EPOCHS)
        emb0 = torch.from_numpy(inp[f"umap{key}_start"]).to(cuda)
        negs = torch.from_numpy(inp[f"umap{key}_negs"]).to(cuda)
        half = -(-n // 2)
        wins = []
        for r, (v0, v1) in enumerate(((0, half), (half, n))):
            s_, e_ = np.searchsorted(heads, [v0, v1])
            edges = tu.umap_edges(heads[s_:e_], tails[s_:e_], eps[s_:e_],
                                  np.zeros(e_ - s_, np.int8), v1 - v0, cuda, v0=v0)
            dcw = torch.from_numpy(dc[v0:v1]).to(cuda)
            negw = negs[v0:v1].contiguous()
            wins.append((v0, v1, edges, dcw, eps[s_:e_]))
            buf = torch.empty((v1 - v0, 2), device=cuda)
            for epoch in UMAP_EPOCHS:
                fresh = torch.from_numpy(epoch_eons(eps[s_:e_], epoch)).to(cuda)
                args = (dcw, negw, v0, epoch, tu.epoch_alpha(1.0, epoch, cs.N_EPOCHS), a, b, 1.0)
                eons = fresh.clone()
                out = tu.umap_epoch_block(emb0, torch.empty_like(buf), edges, eons, *args)
                tag = f"t41_{key}_rank{r}_epoch{epoch}"
                res[f"{tag}_sha256"] = np.array(digest(out, eons))
                due = int((eons != fresh).sum())
                pool = [fresh.clone() for _ in range(7)]
                times[f"T41 ms at {key}, rank {r}'s window {v0}-{v1}, epoch {epoch} ({due} of "
                      f"{len(fresh)} edges due)"] = spread(spun_times(
                          lambda: tu.umap_epoch_block(emb0, buf, edges, pool.pop(), *args), 5))
                if r:
                    continue
                plan = torch.from_numpy(tu.run_plan(
                    edges.indptr.cpu().numpy(), _kernels.library().mt_umap_epoch_block_edges(2))
                ).to(cuda)

                def t13(eons_):
                    _kernels.launch(
                        "umap_epoch", cuda, emb0.data_ptr(), buf.data_ptr(),
                        edges.indptr.data_ptr(), edges.tails.data_ptr(), edges.eps.data_ptr(),
                        eons_.data_ptr(), edges.shift.data_ptr(), dcw.data_ptr(),
                        negw.data_ptr(), plan.data_ptr(), plan.shape[0] - 1, v1, 2,
                        negw.shape[1], epoch, *(float(x) for x in args[4:]))
                    return buf

                eons = fresh.clone()
                res[f"{tag}_t13_zero_shift_sha256"] = np.array(digest(t13(eons), eons))
                pool = [fresh.clone() for _ in range(7)]
                times[f"T13's entry with the zero shift ms at {key}, rank 0's window, epoch "
                      f"{epoch}"] = spread(spun_times(lambda: t13(pool.pop()), 5))
        emb = emb0.clone()
        eons = [w[2].eps.clone() for w in wins]
        outs = [torch.empty((w[1] - w[0], 2), device=cuda) for w in wins]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in range(cs.N_EPOCHS):
            alpha = tu.epoch_alpha(1.0, epoch, cs.N_EPOCHS)
            for r, (v0, v1, edges, dcw, _) in enumerate(wins):
                gen = torch.Generator(device=cuda).manual_seed(1000 * epoch + r)
                nw = torch.randint(0, n, (v1 - v0, 5), generator=gen, dtype=torch.int32,
                                   device=cuda)
                tu.umap_epoch_block(emb, outs[r], edges, eons[r], dcw, nw, v0, epoch, alpha,
                                    a, b, 1.0)
            emb = torch.cat(outs)
        torch.cuda.synchronize()
        times[f"T41 200 epochs of two windows at {key}, wall s"] = time.perf_counter() - t0
        res[f"t41_{key}_200epochs_layout"] = emb.cpu().numpy()
        del wins, edges, emb, emb0, negs, outs, G


def run_t33(tnmf, tsp, profiling, inp, res, times, cuda) -> None:
    """T33 at [scopen]'s two updates (Hᵀ 100,000 × 30 from W 25,000 × 30,
    and W from Hᵀ) from the starts and numerators ``make`` wrote: the
    outputs' digests and each launch's time; then 500 iterations of
    nmf_factors from those starts over the operands scopen_operands builds:
    W and Hᵀ, and the ``scopen/update`` and ``scopen/products`` stages of the
    second of two runs."""
    from scipy import sparse as sp

    W = torch.from_numpy(inp["t33_W"]).to(cuda)
    Ht = torch.from_numpy(inp["t33_Ht"]).to(cuda)
    XtW = torch.from_numpy(inp["t33_XtW"]).to(cuda)
    XHt = torch.from_numpy(inp["t33_XHt"]).to(cuda)
    for name, F, N, O in (("Ht", Ht, XtW, W), ("W", W, XHt, Ht)):
        out = tnmf.nmf_update(F, N, O, 1.0)
        res[f"t33_{name}_update_sha256"] = np.array(digest(out))
        res[f"t33_{name}_update_repeat_same_bits"] = np.array(
            digest(tnmf.nmf_update(F, N, O, 1.0)) == digest(out))
        times[f"T33 ms, {name} update {tuple(F.shape)} from {tuple(O.shape)}"] = spread(
            spun_times(lambda: tnmf.nmf_update(F, N, O, 1.0), 7))
    shape = tuple(int(v) for v in inp["xt_shape"])
    XTc = tsp.from_scipy(sp.csr_matrix((inp["xt_data"], inp["xt_indices"], inp["xt_indptr"]),
                                       shape=shape), cuda)
    X, XT = tsp.transpose(XTc), tsp.pieced(XTc)
    for rep in range(2):
        with profiling.collect() as t:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            Wf, Htf = tnmf.nmf_factors(X, XT, W, Ht, 1.0, 500)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    res["t33_500_W"], res["t33_500_Ht"] = Wf.cpu().numpy(), Htf.cpu().numpy()
    times["nmf_factors 500 iterations, wall s"] = wall
    for stage_ in ("scopen/update", "scopen/products"):
        times[f"{stage_} (1000 calls), s"] = sum(t[stage_])


def run_t24(tgp, tm, res, times, cuda) -> None:
    """T24 at the smoke's three shapes (matrices and times) and the dense
    [mefisto] fit (ELBO trace, Z, lengthscales, wall)."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    ells = torch.linspace(0.05, 0.8, cs.MEF_K, device=cuda)
    scales = torch.linspace(0.1, 0.9, cs.MEF_K, device=cuda)
    Kg = tgp.normalize_kg(torch.randn((cs.MEF_K, 2, 2), generator=gen, device=cuda))
    c = torch.rand((cs.MEF_N, 1), generator=gen, device=cuda)
    g = (torch.arange(cs.MEF_N, device=cuda) >= cs.MEF_N // 2).float()
    cn = torch.rand((cs.SGP_N, 1), generator=gen, device=cuda)
    gn = (torch.arange(cs.SGP_N, device=cuda) % 2).float()
    cu, gu = cn[::cs.SGP_N // 1000].contiguous(), gn[::cs.SGP_N // 1000].contiguous()
    for name, args in (("gp_K", (c, c, ells, scales, g, g, Kg, True)),
                       ("K_nm", (cn, cu, ells[:1], scales[:1], gn, gu, None, False)),
                       ("K_mm", (cu, cu, ells[:1], scales[:1], gu, gu, None, True))):
        res[f"t24_{name}_sha256"] = np.array(digest(tgp.rbf_kernel(*args)))
        shape = "x".join(str(v) for v in (args[2].shape[0], args[0].shape[0], args[1].shape[0]))
        times[f"T24 ms, {name} {shape}"] = spread(spun_times(lambda: tgp.rbf_kernel(*args), 7))
    data = cs.mefisto_data(**cs.MEF_CASES["mefisto"][0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = cs.mefisto_fit(tm, "mefisto", data, cs.MEF_SWEEPS, device=cuda)
    torch.cuda.synchronize()
    times["[mefisto] dense fit, 100 sweeps, wall s"] = time.perf_counter() - t0
    res.update(t24_mefisto_elbo=np.asarray(fit.elbo_history), t24_mefisto_Z=fit.Z,
               t24_mefisto_ell=fit.gp_lengthscales)


def run_t11(tpp, tw, inp, out, res, times, cuda) -> None:
    """T11 on its three recorded calls, then the 100k WNN from the saved
    graphs."""
    single = np.load(f"{out}/wnn_single.npz")
    row0 = cs.N_CELLS // 2
    pad = getattr(tw, "padded_table", lambda t: t)
    for name, src, pre, lo in (("100k", single, "", 0), ("window", single, "", row0),
                               ("wide", inp, "wide_", 0)):
        cand = torch.from_numpy(src[f"{pre}cand"][lo:]).to(cuda).contiguous()
        cat16 = pad(torch.from_numpy(src[f"{pre}cat16"]).to(cuda).view(torch.bfloat16))
        aux, sigw = (torch.from_numpy(src[f"{pre}{k}"]).to(cuda) for k in ("aux", "sigw"))
        dims = [tuple(int(v) for v in d) for d in src[f"{pre}dims"]]
        args = (cand, cat16, aux, sigw, dims, str(src[f"{pre}metric"]), lo)
        res[f"t11_{name}_scores"] = np.array(digest(tw.wnn_fusion_scores(*args)))
        t = spun_times(lambda: tw.wnn_fusion_scores(*args), 5)
        gathered = int((cand >= 0).sum()) * cat16.shape[1] * 2
        times[f"T11 ms, {name} {tuple(cand.shape)} of {tuple(cat16.shape)}"] = spread(t)
        times[f"T11 {name}: candidate-row bytes gathered, TB/s at the median"] = [
            gathered, gathered / (np.median(t) * 1e9)]
    mods = cs.wnn_mods(out, [str(m) for m in inp["wnn_mods"]])
    md = cs.MuHolder(mods)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tpp.neighbors(md, device=cuda)
    torch.cuda.synchronize()
    times["[wnn] pp.neighbors(mdata) wall s"] = time.perf_counter() - t0
    for key in ("distances", "connectivities"):
        G = md.obsp[key]
        res[f"t11_wnn_{key}"] = np.array(digest(*(torch.from_numpy(np.ascontiguousarray(a))
                                                  for a in (G.data, G.indices, G.indptr))))


def run_t26d(ttl, tde, kernels, inp, res, times, cuda) -> None:
    """[de]'s dense route on the RNA densified beforehand: uns, the wall,
    each T26 launch's time."""
    from scipy import sparse as sp

    from muon_tpu_torch.ops import sparse as dsp

    X = sp.csr_matrix((inp["de_rna_data"], inp["de_rna_indices"], inp["de_rna_indptr"]),
                      shape=tuple(inp["de_rna_shape"]))
    Xd = tde.dense_from_csr(dsp.from_scipy(X, cuda))
    launch, events = kernels.launch, []

    def timed(kernel, device, *args):
        if kernel != "wilcoxon_rank_sums":
            return launch(kernel, device, *args)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        launch(kernel, device, *args)
        b.record()
        events.append((a, b))

    h = cs.DEHolder(Xd, inp["de_labels"])
    kernels.launch = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ttl.rank_genes_groups(h, "planted", method="wilcoxon", device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        kernels.launch = launch
    times["[de] wilcoxon dense wall s (T26's launches spun)"] = wall
    times["T26 dense ms, each launch (blocks of 2684 x 100,000)"] = [
        a.elapsed_time(b) for a, b in events]
    uns = h.uns["rank_genes_groups"]
    for field in ("names", "scores", "pvals", "pvals_adj", "logfoldchanges"):
        res[f"t26d_{field}"] = np.array([uns[field][g] for g in uns[field].dtype.names],
                                        dtype=str if field == "names" else None)


def run(root: str, tag: str, out: str, sections, cuda) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import muon_tpu_torch
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import tl as ttl
    from muon_tpu_torch.models import mofa as tm
    from muon_tpu_torch.ops import _kernels, ivf as ti, knn as tk, pwm as tpw, sparse as tsp
    from muon_tpu_torch.ops import gp as tgp, umap as tu, wnn as tw
    from muon_tpu_torch.utils import profiling

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

    if "mofa" in sections or "t18" in sections:
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
        sub = wide_modalities(tpp, cuda)
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
    if "t40" in sections:
        run_ring(tk, inp, res, times, cuda)
    if "t2split" in sections:
        run_split(tsp, inp, res, times, cuda)
    if "t3" in sections:
        run_t3(tsp, inp, res, times, cuda)
    if "t36" in sections:
        run_t36(tpw, profiling, inp, res, times, cuda)
    if "t18" in sections:
        run_svi(tm, inp, res, times, cuda)
    if "t26" in sections:
        run_t26(ttl, profiling, inp, res, times, cuda)
    if "t15" in sections:
        run_t15(ti, inp, res, times, cuda)
    if "t13" in sections:
        run_t13(ttl, tu, profiling, inp, res, times, cuda)
    if "t24" in sections:
        run_t24(tgp, tm, res, times, cuda)
    if "t11" in sections:
        run_t11(tpp, tw, inp, out, res, times, cuda)
    if "t26d" in sections:
        from muon_tpu_torch.ops import de as tde

        run_t26d(ttl, tde, _kernels, inp, res, times, cuda)
    if "t41" in sections:
        run_t41(tu, inp, res, times, cuda)
    if "t33" in sections:
        from muon_tpu_torch.ops import nmf as tnmf

        run_t33(tnmf, tsp, profiling, inp, res, times, cuda)
    np.savez(f"{out}/{tag}.npz", **res)
    with open(f"{out}/{tag}.json", "w") as f:
        json.dump(times, f)
    print(f"{tag}: {json.dumps(times)}", flush=True)


def compare(out: str, tags) -> None:
    """Which outputs are the same bits in every run that wrote them (a key
    one tree alone writes is compared across that tree's runs), and every
    time side by side."""
    runs = {t: np.load(f"{out}/{t}.npz") for t in tags}
    keys = list(dict.fromkeys(k for t in tags for k in runs[t].files))
    for key in keys:
        groups = []  # runs whose outputs are the same bits
        for t in (t for t in tags if key in runs[t].files):
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
    for key in dict.fromkeys(k for t in tags for k in times[t]):
        print(f"{key}: " + "; ".join(f"{t} {times[t][key]}" for t in tags if key in times[t]),
              flush=True)


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
