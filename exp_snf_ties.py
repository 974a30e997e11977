"""Where ``tl.snf`` through the kernels T29-T31 and through their plain
versions part, on chip_smoke.py's ``[snf]`` inputs (the first 10,000 cells
of the e2e's three modalities, each through its own path to neighbors(20)).

    python3 exp_snf_ties.py [--reps 4] [--cells 10000] [--device cuda]

Each repetition rebuilds the three neighbour graphs (their distances
differ in the last bits from one build to the next) and then, per modality:

* runs T29 → T30 → T31 three times and says whether the results are equal
  bit for bit (a kernel that races would differ);
* runs the plain chain and counts the rows whose dominant set (the entries
  T31 keeps) differs from the kernels', with the largest distance of a
  differing entry from the plain row's threshold, relative to it, the rows
  whose k-th and (k+1)-th largest entries lie within 1e-5 of each other
  (near ties) and the smallest such gap.

Where a dominant set differs (and in the first repetition) it runs
``tl.snf`` both ways and prints the smoke's comparison (edge Jaccard, the
shared edges' largest relative difference, the share), and once more with
the plain path taking the kernels' dominant set in the rows where the two
differ (``aligned``). The first repetition also runs the plain path with
one decision turned: the nearest tie's k-th and (k+1)-th entries swapped,
against the plain path as it is. On the CPU (``--device cpu``) both ways
are the plain versions, which only checks the script.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

NEAR = 1e-5


def compare(conn, connp, lab, cs):
    both = conn.multiply(connp.astype(bool)).tocsr()
    both_p = connp.multiply(conn.astype(bool)).tocsr()
    jac = both.nnz / (conn.nnz + connp.nnz - both.nnz)
    rel = np.abs(both.data - both_p.data) / np.abs(both_p.data)
    rows = np.repeat(np.arange(both.shape[0]), np.diff(both.indptr))
    bad = np.unique(rows[rel > 1e-4])
    return (f"Jaccard {jac:.5f}, max rel {rel.max():.3e}, rows with rel > 1e-4: {bad.size}, "
            f"share {cs.label_share(conn, lab):.4f} vs {cs.label_share(connp, lab):.4f}")


def forced(patterns, rows_of):
    """A plain T31 that takes ``patterns[m]``'s kept entries in the rows
    ``rows_of(m, mine, pat)`` selects, for the m-th call (tl.snf calls it
    once a modality, in order)."""
    calls = iter(range(len(patterns)))

    def dominate(x, k):
        m = next(calls)
        mine = x >= torch.topk(x, k, dim=1).values[:, -1:]
        take = rows_of(m, mine, patterns[m])
        kept = torch.where(torch.where(take, patterns[m], mine), x, 0.0)
        return kept / kept.sum(dim=1, keepdim=True)

    return dominate


def run_snf(cs, ttl, tsn, mods, n, k, cuda, plain=(), dominate=None):
    md = cs.MuHolder(mods, n)
    saved = tsn.snf_dominate_set
    with cs.plain_kernels(tsn, plain):
        if dominate is not None:
            tsn.snf_dominate_set = dominate
        try:
            ttl.snf(md, n_neighbors=k, n_iterations=cs.SNF_ITERS, device=cuda)
        finally:
            tsn.snf_dominate_set = saved
    return md.obsp["connectivities"].tocsr()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--cells", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()

    import chip_smoke as cs
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import prot as tpt
    from muon_tpu_torch import tl as ttl
    from muon_tpu_torch._core import tools_graph as tgr
    from muon_tpu_torch.ops import snf as tsn
    from muon_tpu_torch.ops import sparse as dsp

    cuda = torch.device(a.device)
    n, k = a.cells, cs.SNF_K
    eps = float(np.finfo(np.float64).eps)
    plain = ("affinity_matrix", "snf_normalize", "snf_dominate_set")
    X_rna, X_atac, P, labels, _ = cs.make_e2e_counts(cs.SEED)
    lab = labels[:n]
    flips = 0
    for rep in range(a.reps):
        t0 = time.perf_counter()
        mods = {"rna": cs.rna_path(dsp, tpp, X_rna[:n], cuda),
                "atac": cs.atac_e2e_path(tac, tpp, X_atac[:n], cuda),
                "prot": cs.prot_path(tpt, tpp, P[:n], cuda)}
        digest = {m: float(np.float64(h.obsp["distances"].data).sum()) for m, h in mods.items()}
        print(f"[rep {rep}] graphs in {time.perf_counter() - t0:.1f}s; distance sums "
              f"{digest}", flush=True)
        patterns, plain_patterns, nearest = [], [], (np.inf, 0, 0)
        differ = 0
        for mi, (m, h) in enumerate(mods.items()):
            dist, known = tgr._dense_distances(h.obsp["distances"], cuda)
            outs = []
            for _ in range(3):
                W = tsn.affinity_matrix(dist, known, k, 0.5, eps)
                Wn = tsn.snf_normalize(W)
                outs.append((W, Wn, tsn.snf_dominate_set(Wn, k)))
            same = all(torch.equal(x, y) for o in outs[1:] for x, y in zip(o, outs[0]))
            W, Wn, S = outs[0]
            del outs
            Wp = tsn.affinity_matrix_plain(dist, known, k, 0.5, eps)
            Wnp = tsn.snf_normalize_plain(Wp)
            Sp = tsn.snf_dominate_set_plain(Wnp, k)
            top = torch.topk(Wnp, k + 1, dim=1).values
            thr = top[:, k - 1]
            rgap = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
            near = int((rgap <= NEAR).sum())
            g, r0 = float(rgap.min()), int(rgap.argmin())
            if g < nearest[0]:
                nearest = (g, mi, r0)
            diff = (S != 0) != (Sp != 0)
            rows = torch.nonzero(diff.any(dim=1)).flatten()
            differ += rows.numel()
            gap = 0.0
            if rows.numel():
                r, c = torch.nonzero(diff, as_tuple=True)
                gap = float(((Wnp[r, c] - thr[r]).abs() / thr[r]).max())
            print(f"[rep {rep}] {m}: kernels repeat bit for bit {same}; W max rel "
                  f"{float(((W - Wp).abs() / Wp.abs().clamp_min(1e-30)).max()):.2e}, Wn "
                  f"{float(((Wn - Wnp).abs() / Wnp.abs().clamp_min(1e-30)).max()):.2e}; "
                  f"dominant sets differ in {rows.numel()} rows {rows[:10].tolist()}, "
                  f"largest relative distance of a differing entry from the plain threshold "
                  f"{gap:.2e}; near ties (k-th and k+1-th within {NEAR}) {near}, the "
                  f"smallest gap {g:.2e} (row {r0})", flush=True)
            patterns.append(S != 0)
            plain_patterns.append(Sp != 0)
            del dist, known, W, Wn, S, Wp, Wnp, Sp, top, diff
        torch.cuda.empty_cache()
        flips += differ > 0
        if differ or rep == 0:
            conn = run_snf(cs, ttl, tsn, mods, n, k, cuda)
            connp = run_snf(cs, ttl, tsn, mods, n, k, cuda, plain)
            print(f"[rep {rep}] tl.snf kernels vs plain: {compare(conn, connp, lab, cs)}",
                  flush=True)
            conna = run_snf(cs, ttl, tsn, mods, n, k, cuda, plain[:2], forced(
                patterns, lambda m, mine, pat: (mine != pat).any(dim=1, keepdim=True)))
            print(f"[rep {rep}] tl.snf kernels vs plain with the kernels' dominant sets "
                  f"where they differ: {compare(conn, conna, lab, cs)}", flush=True)
        if rep == 0:
            g, mi, r0 = nearest
            turned = [p.clone() for p in plain_patterns]
            row = turned[mi][r0]
            Wrow = tsn.snf_normalize_plain(tsn.affinity_matrix_plain(
                *tgr._dense_distances(list(mods.values())[mi].obsp["distances"], cuda),
                k, 0.5, eps))[r0]
            order = torch.argsort(Wrow, descending=True)
            row[order[k - 1]], row[order[k]] = False, True
            del Wrow
            connt = run_snf(cs, ttl, tsn, mods, n, k, cuda, plain[:2], forced(
                turned, lambda m, mine, pat: torch.zeros_like(mine[:, :1]) | (m == mi)))
            print(f"[rep 0] the plain path with one decision turned (modality {mi}, row "
                  f"{r0}, gap {g:.2e}) against it as it is: {compare(connt, connp, lab, cs)}",
                  flush=True)
            del conn, connp, conna, connt, turned
        del mods, patterns, plain_patterns
        torch.cuda.empty_cache()
    print(f"[summary] dominant sets differed between the kernels and plain in {flips} of "
          f"{a.reps} builds", flush=True)


if __name__ == "__main__":
    main()
