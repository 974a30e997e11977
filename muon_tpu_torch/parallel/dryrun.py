"""A dry run of the multi-device paths on tiny shapes (counterpart of the
reference's ``__graft_entry__.dryrun_multichip``): the sharded MOFA sweep,
the sharded pipeline and the public tools with WNN, over a mesh.

``dryrun_multichip(n_devices)`` spawns ``n_devices`` gloo ranks (a
``file://`` store in a temporary directory, one thread a rank) and runs
:func:`dryrun_on_mesh` in each over ``make_mesh(n_devices)``; a rank that
fails fails the spawn. A rank that is already part of a process group (the
smoke's, a test's) calls ``dryrun_on_mesh(mesh)`` itself.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..ops.device import DeviceLike

__all__ = ["dryrun_multichip", "dryrun_on_mesh"]


class _Holder:
    """The least AnnData-like object the public tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}
        self.n_obs, self.n_vars = X.shape


class _MuHolder:
    """The least MuData-like object WNN takes: modalities over the same
    cells, in the same order."""

    def __init__(self, mods):
        self.mod = mods
        self.n_obs = next(iter(mods.values())).n_obs
        self.obsmap = {k: np.arange(1, self.n_obs + 1) for k in mods}
        self.obs, self.obsm, self.obsp, self.uns = {}, {}, {}, {}


def _toy_problem(N=64, Ds=(48, 32), K=4, G=2, seed=0):
    """The reference's ``_toy_problem``: two views (the second with 10%
    missing entries, so the masked path runs too), two groups, K = 4, as
    host arrays."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(N, K)).astype(np.float32)
    Ys = []
    for D in Ds:
        W = rng.normal(size=(D, K)).astype(np.float32)
        Ys.append(Z @ W.T + 0.1 * rng.normal(size=(N, D)).astype(np.float32))
    masks = [None, (rng.random(size=Ys[1].shape) > 0.1).astype(np.float32)]
    Ys[1] = np.where(masks[1] > 0, Ys[1], np.nan)
    onehot = np.zeros((N, G), dtype=np.float32)
    onehot[np.arange(N), np.arange(N) % G] = 1.0
    return Ys, masks, onehot, K, G, seed


def dryrun_on_mesh(mesh) -> dict:
    """Two sharded MOFA sweeps of the toy problem (finite, non-decreasing
    ELBO), the sharded tfidf → lsi → ring kNN → IVF → UMAP chain on 96
    cells, then ``atac.pp.tfidf`` → ``atac.tl.lsi`` → ``pp.neighbors`` and
    WNN of two modalities under ``set_options(mesh=mesh)``. Returns what it
    checked, the same on every rank."""
    from scipy import sparse as sp

    from .. import atac, pp, set_options
    from ..models import mofa
    from ..ops.fuzzy import compute_connectivities_umap
    from .mesh import shard_mofa_state
    from .pipeline import sharded_ivf_knn, sharded_knn, sharded_lsi, sharded_umap_embed

    dev = mesh.device
    Ys, masks, onehot, K, G, seed = _toy_problem()
    config = mofa.MOFAConfig(n_factors=K, likelihoods=("gaussian",) * 2, n_groups=G, seed=seed)
    state = mofa._init_state(Ys, masks, onehot, config, device=dev)
    step = mofa.make_step(config, [Y.shape[1] for Y in Ys], Ys[0].shape[0],
                          [m is not None for m in masks], red=mofa.Reducer(mesh))
    state, e1 = step(shard_mofa_state(state, mesh))
    state, e2 = step(state)
    e1, e2 = float(e1), float(e2)
    assert np.isfinite(e1), f"non-finite ELBO from the sharded sweep: {e1}"
    assert e2 >= e1, f"the ELBO must not decrease under VB updates: {e1} -> {e2}"

    n_obs, n_feat = 96, 64
    counts = sp.random(n_obs, n_feat, density=0.2, random_state=np.random.RandomState(0),
                       format="csr")
    counts.data = np.ceil(counts.data * 4)
    scores, s_vals, _ = sharded_lsi(counts, mesh, k=4, n_iter=4)
    scores = scores.cpu().numpy()
    assert np.isfinite(scores).all()
    dists, idx = sharded_knn(scores, mesh, k=5)
    assert np.array_equal(idx.cpu().numpy()[:, 0], np.arange(n_obs))
    idx_ivf, d_ivf = sharded_ivf_knn(scores, mesh, k=5)
    assert np.array_equal(idx_ivf.cpu().numpy()[:, 0], np.arange(n_obs))
    assert torch.isfinite(d_ivf).all()
    conn = compute_connectivities_umap(idx.cpu().numpy(), torch.sqrt(dists.clamp(min=0.0)),
                                       n_obs, 6, device=dev)
    emb = sharded_umap_embed(conn, mesh, n_epochs=10, random_state=0)
    assert emb.shape == (n_obs, 2) and np.isfinite(emb).all()

    adata = _Holder(counts.copy())
    rng = np.random.default_rng(0)
    m1 = _Holder(rng.normal(size=(n_obs, 12)).astype(np.float32))
    m2 = _Holder(rng.normal(size=(n_obs, 10)).astype(np.float32))
    mdata = _MuHolder({"m1": m1, "m2": m2})
    with set_options(mesh=mesh):
        atac.pp.tfidf(adata)
        atac.tl.lsi(adata, n_comps=4, n_iter=4)
        pp.neighbors(adata, n_neighbors=6, use_rep="X_lsi")
        pp.neighbors(m1, n_neighbors=6, use_rep="X")
        pp.neighbors(m2, n_neighbors=6, use_rep="X")
        pp.neighbors(mdata, n_neighbors=6)
    assert np.isfinite(adata.obsm["X_lsi"]).all()
    assert adata.obsp["distances"].shape == (n_obs, n_obs)
    assert mdata.obsp["distances"].shape == (n_obs, n_obs) and mdata.obsp["distances"].nnz > 0
    return {"mesh": dict(mesh.shape), "elbo": (e1, e2), "s0": float(s_vals[0]),
            "wnn_nnz": int(mdata.obsp["distances"].nnz)}


def _rank(rank: int, n: int, store: str, device: str) -> None:
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n)
    try:
        out = dryrun_on_mesh(make_mesh(n, device=device))
        if rank == 0:
            print(f"dryrun_multichip OK: mesh {out['mesh']}, ELBO {out['elbo'][0]:.3f} -> "
                  f"{out['elbo'][1]:.3f}; sharded tfidf+lsi (s0={out['s0']:.3f}), ring kNN, "
                  f"IVF, UMAP; the public tools and WNN ({out['wnn_nnz']} edges) under "
                  "set_options(mesh=...)", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """Spawn ``n_devices`` gloo ranks and run :func:`dryrun_on_mesh` in each
    over ``make_mesh(n_devices)``, every rank on ``device`` (None: the
    current CUDA device; ``"cpu"`` the CPU). Raises if a rank fails."""
    import torch.multiprocessing as mp

    if device is None:
        device = f"cuda:{torch.cuda.current_device()}"
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(int(n_devices), os.path.join(tmp, "store"), str(device)),
                 nprocs=int(n_devices))
