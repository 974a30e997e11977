"""The fused graph of chip_smoke.py's ``[snf]`` phase from both packages: the
port's ``tl.snf`` on the card and the JAX package's ``muon_tpu.tl.snf`` on
the CPU, on the same three neighbour graphs, with each one's planted-label
share of the fused neighbours.

    python3 exp_snf_witness.py dump OUT.npz
    JAX_PLATFORMS=cpu python3 exp_snf_witness.py reference OUT.npz

``dump`` (the port only; a CUDA machine, or ``--device cpu``) makes the
smoke's e2e data, runs the first ``--cells`` cells (10,000, the smoke's) of
its three modalities through the port's paths to neighbors(20), as the
smoke's ``[snf]`` phase does, then ``tl.snf(n_neighbors=20,
n_iterations=20)``, and writes the three distance graphs, the planted
labels and the port's fused connectivities. ``reference`` (the JAX package
only) runs ``muon_tpu.tl.snf`` with the same arguments on those graphs and
holds its fused graph to the port's: both shares, the edge Jaccard and the
largest relative difference of the edges both keep.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
from scipy import sparse as sp

MODS = ("rna", "atac", "prot")
# chip_smoke.py's SNF_K and SNF_ITERS: tl.snf's defaults
K, ITERS = 20, 20


def label_share(D, labels) -> float:
    rows = np.repeat(np.arange(D.shape[0]), np.diff(D.indptr))
    return float((labels[rows] == labels[D.indices]).mean())


def _save_csr(out: dict, key: str, M) -> None:
    M = sp.csr_matrix(M)
    out[f"{key}_data"], out[f"{key}_indices"], out[f"{key}_indptr"] = \
        M.data, M.indices, M.indptr


def _load_csr(z, key: str, n: int):
    return sp.csr_matrix((z[f"{key}_data"], z[f"{key}_indices"], z[f"{key}_indptr"]),
                         shape=(n, n))


def dump(path: str, n: int, device: str) -> None:
    import torch

    import chip_smoke as cs
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import prot as tpt
    from muon_tpu_torch import tl as ttl
    from muon_tpu_torch.ops import sparse as dsp

    dev = torch.device(device)
    X_rna, X_atac, P, labels, _ = cs.make_e2e_counts(cs.SEED)
    lab = labels[:n]
    mods = {"rna": cs.rna_path(dsp, tpp, X_rna[:n], dev),
            "atac": cs.atac_e2e_path(tac, tpp, X_atac[:n], dev),
            "prot": cs.prot_path(tpt, tpp, P[:n], dev)}
    del X_rna, X_atac, P
    md = cs.MuHolder(mods, n)
    t0 = time.perf_counter()
    ttl.snf(md, n_neighbors=K, n_iterations=ITERS, device=dev)
    wall = time.perf_counter() - t0
    out = {"labels": lab, "n": np.int64(n)}
    for m in MODS:
        _save_csr(out, m, mods[m].obsp["distances"])
    _save_csr(out, "fused", md.obsp["connectivities"])
    np.savez_compressed(path, **out)
    print(f"[dump] {n} cells on {dev}: shares " + ", ".join(
        f"{m} {label_share(mods[m].obsp['distances'].tocsr(), lab):.4f}" for m in MODS)
        + f"; the port's tl.snf {wall:.2f}s, fused share "
        f"{label_share(md.obsp['connectivities'].tocsr(), lab):.4f}; wrote {path}", flush=True)


def reference(path: str) -> None:
    import muon_tpu as mu

    z = np.load(path)
    n, lab = int(z["n"]), z["labels"]
    mods = {}
    for m in MODS:
        a = mu.AnnData(np.zeros((n, 1), dtype=np.float32))
        a.obsp["distances"] = _load_csr(z, m, n)
        a.uns["neighbors"] = {"distances_key": "distances",
                              "connectivities_key": "connectivities", "params": {}}
        mods[m] = a
    md = mu.MuData(mods)
    t0 = time.perf_counter()
    mu.tl.snf(md, n_neighbors=K, n_iterations=ITERS)
    wall = time.perf_counter() - t0
    ref = sp.csr_matrix(md.obsp["connectivities"])
    port = _load_csr(z, "fused", n)
    both = ref.multiply(port.astype(bool)).tocsr()
    both_p = port.multiply(ref.astype(bool)).tocsr()
    jac = both.nnz / (ref.nnz + port.nnz - both.nnz)
    rel = float(np.max(np.abs(both.data - both_p.data) / np.abs(both.data)))
    print(f"[reference] muon_tpu.tl.snf on {n} cells: {wall:.1f}s; planted-label share of "
          f"the fused neighbours {label_share(ref, lab):.4f} (the port's "
          f"{label_share(port, lab):.4f}); modality graphs' shares " + ", ".join(
              f"{m} {label_share(_load_csr(z, m, n), lab):.4f}" for m in MODS)
          + f"; edge Jaccard against the port's {jac:.5f}, shared edges' values max rel "
          f"diff {rel:.2e}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("dump", "reference"))
    ap.add_argument("path")
    ap.add_argument("--cells", type=int, default=10_000)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.mode == "dump":
        dump(a.path, a.cells, a.device)
    else:
        reference(a.path)


if __name__ == "__main__":
    main()
