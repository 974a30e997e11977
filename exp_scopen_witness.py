"""scOpen's planted-label probe over several NMF starts, from the JAX package
and from the port, on chip_smoke.py's e2e ATAC counts, beside the
label-probe R² of the same cells' ``X_lsi``.

    JAX_PLATFORMS=cpu python3 exp_scopen_witness.py reference [--cells 10000] [--seeds 0 1 2]
    python3 exp_scopen_witness.py port [--cells 100000] [--seeds 0 1 2] [--repeat 2]

Both modes fit 30 factors in 500 iterations (the smoke's ``[scopen]``).

``reference`` runs on the CPU on the first ``--cells`` cells. For each seed s
it fits the JAX package's NMF (``muon_tpu.ops.nmf.nmf``, float32, x64 off as
in production) with ``seed=s`` to scOpen's input. Seed 0 is what
``muon_tpu.atac.pp.scopen`` does, and the script checks its X_scopen against
the package's own call. Beside it the port runs from the reference's own
``jax.random`` starts of seed s, handed over as ``W0``/``H0``, and from its
own ``torch.Generator`` starts of seed s.

``port`` runs only the port, on the card unless ``--device cpu``, on the first
``--cells`` cells. For each seed s it runs ``atac.pp.scopen`` from the port's
own starts of seed s, ``--repeat`` times, and reads R² each time.

The LSI is the port's (``atac.pp.tfidf`` → ``atac.tl.lsi(n_comps=50)``, as
the smoke's e2e ATAC path). R² is chip_smoke.py's ``label_probe_r2``: one-hot
planted labels regressed on [rep, 1].
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np


class Holder:
    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


def _data(cs, n):
    t0 = time.perf_counter()
    _, X_atac, _, labels, _ = cs.make_e2e_counts(cs.SEED)
    X, lab = X_atac[:n], labels[:n]
    print(f"[data] e2e ATAC, first {X.shape[0]} cells x {X.shape[1]} peaks, nnz {X.nnz}, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return X, lab


def _lsi_r2(cs, tac, X, lab, device) -> float:
    h = Holder(X.copy())
    tac.pp.tfidf(h, device=device)
    tac.tl.lsi(h, n_comps=cs.K, n_iter=cs.N_ITER, random_state=cs.SEED, device=device)
    r2 = cs.label_probe_r2(h.obsm["X_lsi"], lab)
    print(f"[witness] label-probe R2 of X_lsi {r2:.4f} (0.8 x: {0.8 * r2:.4f})", flush=True)
    return r2


def _own_starts(tnmf, X, k, seed, device):
    """The port's own starts of ``seed`` on scOpen's input, as W0 (m, k), H0 (k, n)."""
    Xc, _ = tnmf.scopen_operands(X, device=device)
    W, Ht = tnmf._starts(Xc, k, seed, None, None)
    return W.cpu().numpy(), Ht.cpu().numpy().T


def reference(args) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    import muon_tpu as mu
    from muon_tpu.ops import nmf as jnmf
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch.ops import nmf as tnmf

    cpu = torch.device("cpu")
    k, iters = cs.SCOPEN_K, cs.SCOPEN_ITERS
    X, lab = _data(cs, args.cells)
    _lsi_r2(cs, tac, X, lab, cpu)

    # the reference's scOpen input (muon_tpu/ops/nmf.py:87-99) and starts (:33-36)
    Xs = np.greater(np.asarray(X.todense()).T, 0).astype(np.float32)
    n_open = np.log10(np.maximum(Xs.sum(axis=0), 1.0))
    hi, lo = n_open.max(), n_open.min()
    rho = 0.5 * (hi - n_open) / ((hi - lo) if hi > lo else 1.0)
    Xs = Xs * (1.0 / (1.0 - rho))

    @jax.jit
    def starts(Xj, key):
        kw, kh = jax.random.split(key)
        scale = jnp.sqrt(Xj.mean() / k)
        return (scale * jnp.abs(jax.random.normal(kw, (Xj.shape[0], k), Xj.dtype)),
                scale * jnp.abs(jax.random.normal(kh, (k, Xj.shape[1]), Xj.dtype)))

    for seed in args.seeds:
        t0 = time.perf_counter()
        with jax.enable_x64(False):
            _, H_ref = jnmf.nmf(Xs, n_components=k, alpha=1.0, max_iter=iters, seed=seed)
        t_ref = time.perf_counter() - t0
        r2_ref = cs.label_probe_r2(H_ref.T, lab)
        if seed == 0:  # the package's own scopen is this fit
            pkg = mu.AnnData(X.copy())
            with jax.enable_x64(False):
                mu.atac.pp.scopen(pkg, n_components=k, max_iter=iters)
            same_as_pkg = bool(np.array_equal(np.asarray(pkg.obsm["X_scopen"]), H_ref.T))
            print(f"[witness] seed 0: the fit is muon_tpu.atac.pp.scopen's, X_scopen equal "
                  f"{same_as_pkg}", flush=True)
            del pkg
        with jax.enable_x64(False):
            W0, H0 = (np.array(a) for a in starts(jnp.asarray(Xs), jax.random.PRNGKey(seed)))
        same = Holder(X.copy())
        t0 = time.perf_counter()
        tac.pp.scopen(same, n_components=k, max_iter=iters, W0=W0, H0=H0, device=cpu)
        t_same = time.perf_counter() - t0
        r2_same = cs.label_probe_r2(same.obsm["X_scopen"], lab)
        d_H = float(np.abs(same.obsm["X_scopen"] - H_ref.T).max() / np.abs(H_ref).max())
        del same
        W0, H0 = _own_starts(tnmf, X, k, seed, cpu)
        own = Holder(X.copy())
        tac.pp.scopen(own, n_components=k, max_iter=iters, W0=W0, H0=H0, device=cpu)
        r2_own = cs.label_probe_r2(own.obsm["X_scopen"], lab)
        del own
        print(f"[witness] seed {seed}: {args.cells} cells, k={k}, {iters} iterations: "
              f"label-probe R2 of X_scopen: the JAX package {r2_ref:.4f} ({t_ref:.1f}s), the "
              f"port from the same starts {r2_same:.4f} ({t_same:.1f}s; X_scopen within "
              f"{d_H:.2e} of the reference's largest entry), the port from its own starts "
              f"{r2_own:.4f}", flush=True)


def port(args) -> None:
    import torch

    import chip_smoke as cs
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch.ops import nmf as tnmf

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    k, iters = cs.SCOPEN_K, cs.SCOPEN_ITERS
    X, lab = _data(cs, args.cells)
    _lsi_r2(cs, tac, X, lab, dev)
    for seed in args.seeds:
        W0, H0 = _own_starts(tnmf, X, k, seed, dev)
        reads = []
        for _ in range(args.repeat):
            h = Holder(X)
            t0 = time.perf_counter()
            tac.pp.scopen(h, n_components=k, max_iter=iters, W0=W0, H0=H0, device=dev)
            wall = time.perf_counter() - t0
            reads.append((cs.label_probe_r2(h.obsm["X_scopen"], lab), wall))
            del h
        print(f"[witness] seed {seed}: {X.shape[0]} cells, k={k}, {iters} iterations, the port "
              f"from its own starts on {dev.type}: label-probe R2 of X_scopen "
              + ", ".join(f"{r:.4f} ({w:.2f}s)" for r, w in reads), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("reference", "port"))
    ap.add_argument("--cells", type=int, default=None,
                    help="first so many cells (reference: 10,000; port: all 100,000)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--repeat", type=int, default=2, help="port: runs of each seed")
    ap.add_argument("--device", default="cuda", help="port: the device")
    args = ap.parse_args()
    if args.cells is None:
        args.cells = 10_000 if args.mode == "reference" else 100_000
    (reference if args.mode == "reference" else port)(args)


if __name__ == "__main__":
    main()
