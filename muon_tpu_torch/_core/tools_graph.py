"""SNF, multiplex Leiden/Louvain and multimodal UMAP (``mu.tl``; counterpart
of muon_tpu/_core/tools_graph.py).

The tools take MuData-like objects (``.mod``, ``.obsmap`` 1-based,
``.n_obs``, ``.obs``, ``.obsp``, ``.uns``) or AnnData-like ones (``.obs``,
``.obsp``, ``.uns``, ``.obsm``). Cluster labels go into ``obs[key_added]``
as a ``pd.Categorical`` when ``obs`` is a pandas DataFrame, and as an array
of label strings otherwise. ``snf`` builds each modality's affinity (T29)
and runs the cross-diffusion (T30, T31 and dense products) on the device
(ops/snf.py); like the reference's it is dense n × n by design.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Optional

import numpy as np
from scipy import sparse as sp

from ..ops.device import DeviceLike, resolve_device
from ..utils.profiling import stage
from .preproc import _is_mudata

__all__ = ["snf", "leiden", "louvain", "umap"]


# ---------------------------------------------------------------------------
# SNF — similarity network fusion (Wang et al. 2014)
# ---------------------------------------------------------------------------


def _dense_distances(dmat, device):
    """A modality's distance matrix as a dense float32 tensor on ``device``
    and its known-mask: a sparse matrix densified on the device (its stored
    entries summed where repeated, as ``todense`` sums them) and known where
    that sum is not 0, as the reference's ``dmat != 0``; every entry of a
    dense one."""
    import torch

    from ..ops import de
    from ..ops import sparse as dsp

    if not sp.issparse(dmat):
        dist = torch.from_numpy(np.asarray(dmat, dtype=np.float32)).to(device)
        return dist, torch.ones(dist.shape, dtype=torch.bool, device=device)
    dist = de.dense_from_csr(dsp.from_scipy(dmat, device))
    return dist, dist != 0


def snf(
    mdata,
    n_neighbors: int = 20,
    neighbor_keys=None,
    key_added: Optional[str] = None,
    n_iterations: int = 20,
    sigma: float = 0.5,
    eps: float = None,
    copy: bool = False,
    device: DeviceLike = None,
):
    """Similarity network fusion (reference muon/_core/tools.py:716-920, as
    muon_tpu/_core/tools_graph.py:109-200 computes it): per-modality
    local-scale affinities (T29), normalised cross-diffusion (T30, T31 and
    float32 products), then the fused graph's kNN as ``obsp`` distances
    (0.5 − similarity) and connectivities and ``uns[key_added]``. The final
    choice keeps each row's k *largest* fused similarities, as the
    reference's; here ``torch.topk`` on the device takes it."""
    import torch

    from ..ops import snf as tsnf

    device = resolve_device(device)
    if eps is None:
        eps = float(np.finfo(np.float64).eps)
    mdata = mdata.copy() if copy else mdata

    if neighbor_keys is None:
        modalities = list(mdata.mod.keys())
        neighbor_keys = {}
    elif isinstance(neighbor_keys, str):
        modalities = list(mdata.mod.keys())
        neighbor_keys = {m: neighbor_keys for m in modalities}
    else:
        modalities = list(neighbor_keys.keys())

    neighbors_params, mod_reps, mod_n_pcs = {}, {}, {}
    for mod in modalities:
        nkey = neighbor_keys.get(mod, "neighbors")
        if nkey not in mdata.mod[mod].uns:
            raise ValueError(
                f'Did not find .uns["{nkey}"] for modality "{mod}". '
                "Run neighbors on all modalities first."
            )
        nparams = mdata.mod[mod].uns[nkey]
        neighbors_params[mod] = nparams
        mod_reps[mod] = nparams["params"].get("use_rep", -1)
        mod_n_pcs[mod] = nparams["params"].get("n_pcs", -1)

    Ws = []
    for mod in modalities:
        with stage("snf/upload"):
            dist, known = _dense_distances(
                mdata.mod[mod].obsp[neighbors_params[mod]["distances_key"]], device)
        with stage("snf/kernels"):
            Ws.append(tsnf.affinity_matrix(dist, known, int(n_neighbors), float(sigma),
                                           float(eps)))
        del dist, known
    fused = tsnf.snf_diffusion(Ws, int(n_iterations), int(n_neighbors))
    del Ws

    n = fused.shape[0]
    with stage("snf/topk"):
        simvals, idx = torch.topk(fused, int(n_neighbors), dim=1)
        simvals = simvals.cpu().numpy().reshape(-1)
        cols = idx.cpu().numpy().reshape(-1)
    del fused
    rows = np.repeat(np.arange(n), n_neighbors)
    conn = sp.csr_matrix((simvals, (rows, cols)), shape=(n, n))
    dvals = 0.5 - simvals
    dmat = sp.csr_matrix((dvals, (rows, cols)), shape=(n, n))

    if key_added is None:
        key_added, conns_key, dists_key = "neighbors", "connectivities", "distances"
    else:
        conns_key, dists_key = f"{key_added}_connectivities", f"{key_added}_distances"
    mdata.obsp[conns_key] = conn
    mdata.obsp[dists_key] = dmat
    mdata.uns[key_added] = {
        "connectivities_key": conns_key,
        "distances_key": dists_key,
        "params": {
            "n_neighbors": n_neighbors,
            "eps": eps,
            "use_rep": mod_reps,
            "n_pcs": mod_n_pcs,
            "method": "snf",
        },
    }
    return mdata if copy else None


def _choose_graph(obj, obsp=None, neighbors_key=None):
    if obsp is not None:
        return obj.obsp[obsp]
    nkey = neighbors_key or "neighbors"
    if nkey in obj.uns:
        return obj.obsp[obj.uns[nkey]["connectivities_key"]]
    if "connectivities" in obj.obsp:
        return obj.obsp["connectivities"]
    raise ValueError("No neighbors found; run neighbors first.")


def _write_labels(obj, key_added: str, labels: np.ndarray) -> None:
    """``obs[key_added]``: a ``pd.Categorical`` of the label strings, ordered
    by label, when ``obs`` is a pandas DataFrame; the strings otherwise."""
    strings = labels.astype(str)
    if type(obj.obs).__module__.startswith("pandas"):
        import pandas as pd

        obj.obs[key_added] = pd.Categorical(
            strings, categories=[str(i) for i in sorted(set(labels))]
        )
    else:
        obj.obs[key_added] = strings


def _cluster(
    mdata,
    resolution=None,
    mod_weights=None,
    random_state: int = 0,
    key_added: str = "leiden",
    neighbors_key: Optional[str] = None,
    directed: bool = True,
    algorithm: str = "leiden",
    **kwargs,
):
    """Multiplex clustering: one partition optimised jointly over the
    per-modality connectivity graphs (reference muon/_core/tools.py:928-1054,
    leidenalg optimise_partition_multiplex semantics), on the host by the
    native engine (ops/leiden.py)."""
    from ..ops.leiden import multiplex_leiden

    if not _is_mudata(mdata):
        adj = _choose_graph(mdata, neighbors_key=neighbors_key)
        labels = multiplex_leiden(
            [adj],
            [resolution if resolution is not None else 1.0],
            [1.0],
            seed=random_state or 0,
            refine=(algorithm == "leiden"),
            n_iterations=kwargs.get("n_iterations"),
        )
        _write_labels(mdata, key_added, labels)
        mdata.uns[algorithm] = {
            "params": {"resolution": resolution, "random_state": random_state}
        }
        return

    mods = list(mdata.mod.keys())
    if isinstance(neighbors_key, Mapping):
        nkeys = {m: neighbors_key.get(m) for m in mods}
    else:
        nkeys = {m: neighbors_key for m in mods}
    adjs = [_choose_graph(mdata.mod[m], neighbors_key=nkeys[m]) for m in mods]

    if resolution is None:
        resolutions = [1.0] * len(mods)
    elif isinstance(resolution, Mapping):
        resolutions = [resolution[m] for m in mods]
    elif isinstance(resolution, (Sequence, np.ndarray)) and not isinstance(
        resolution, str
    ):
        assert len(resolution) == len(mods)
        resolutions = list(resolution)
    else:
        resolutions = [float(resolution)] * len(mods)

    if mod_weights is None:
        weights = [1.0] * len(mods)
    elif isinstance(mod_weights, Mapping):
        weights = [mod_weights.get(m, 1) for m in mods]
    elif isinstance(mod_weights, (Sequence, np.ndarray)) and not isinstance(
        mod_weights, str
    ):
        assert len(mod_weights) == len(mods)
        weights = list(mod_weights)
    else:
        weights = [float(mod_weights)] * len(mods)

    # ragged obs: expand each modality graph onto the global obs axis
    n = mdata.n_obs
    expanded = []
    for m, A in zip(mods, adjs):
        if A.shape[0] == n and bool(np.all(mdata.obsmap[m] == np.arange(1, n + 1))):
            expanded.append(A.tocsr())
        else:
            gmap = np.flatnonzero(np.asarray(mdata.obsmap[m]) > 0)
            A = A.tocoo()
            expanded.append(
                sp.csr_matrix(
                    (A.data, (gmap[A.row], gmap[A.col])), shape=(n, n)
                )
            )

    labels = multiplex_leiden(
        expanded, resolutions, weights, seed=random_state or 0,
        refine=(algorithm == "leiden"),
        n_iterations=kwargs.get("n_iterations"),
    )
    _write_labels(mdata, key_added, labels)
    mdata.uns[algorithm] = {
        "params": {
            "resolution": resolution,
            "random_state": random_state,
        }
    }


def leiden(
    data,
    resolution=None,
    mod_weights=None,
    random_state: int = 0,
    key_added: str = "leiden",
    neighbors_key=None,
    directed: bool = True,
    **kwargs,
):
    """Multiplex Leiden clustering (reference muon/_core/tools.py:1057-1130)."""
    return _cluster(
        data, resolution=resolution, mod_weights=mod_weights,
        random_state=random_state, key_added=key_added,
        neighbors_key=neighbors_key, directed=directed, algorithm="leiden",
        **kwargs,
    )


def louvain(
    data,
    resolution=None,
    mod_weights=None,
    random_state: int = 0,
    key_added: str = "louvain",
    neighbors_key=None,
    directed: bool = True,
    **kwargs,
):
    """Multiplex Louvain clustering (reference muon/_core/tools.py:1133-1206)."""
    return _cluster(
        data, resolution=resolution, mod_weights=mod_weights,
        random_state=random_state, key_added=key_added,
        neighbors_key=neighbors_key, directed=directed, algorithm="louvain",
        **kwargs,
    )


def umap(
    mdata,
    min_dist: float = 0.5,
    spread: float = 1.0,
    n_components: int = 2,
    maxiter: Optional[int] = None,
    alpha: float = 1.0,
    gamma: float = 1.0,
    negative_sample_rate: int = 5,
    init_pos="spectral",
    random_state: int = 42,
    a: Optional[float] = None,
    b: Optional[float] = None,
    copy: bool = False,
    method: str = "umap",
    neighbors_key: Optional[str] = None,
    mesh=None,
    device: DeviceLike = None,
):
    """Embed the (multimodal) neighbourhood graph with UMAP (reference
    muon/_core/tools.py:1209-1362); the SGD epochs run on the device
    (ops/umap.py, T13). Writes ``obsm["X_umap"]`` and ``uns["umap"]``.
    The connectivities go to ``umap_embed`` as the CSR that ``obsp`` holds,
    not as a copy, so the membership tag ``pp.neighbors`` hung on it arrives
    and the spectral seed of a graph above 8M edges comes from the
    membership table (T16).

    ``mesh`` (or ``set_options(mesh=...)``): a ``parallel.Mesh`` of more than
    one rank runs ``parallel.sharded_umap_embed`` as the reference's mesh
    branch calls it (``maxiter`` epochs, 200 when None): from the exact
    spectral seed, with a and b fitted to ``spread`` and ``min_dist``, so
    ``init_pos`` and a caller's ``a`` and ``b`` do not reach the layout there;
    ``uns`` still records the caller's a and b, as the reference's does.
    Every rank writes the same layout."""
    from ..ops.umap import find_ab_params, umap_embed
    from .config import resolve_mesh

    mesh, device = resolve_mesh(mesh, device)
    data = mdata.copy() if copy else mdata
    nkey = neighbors_key or "neighbors"
    if nkey not in data.uns:
        raise ValueError(
            f'Did not find .uns["{nkey}"]. Run `muon_tpu_torch.pp.neighbors` first.'
        )
    neighbors = data.uns[nkey]
    conn = data.obsp[neighbors["connectivities_key"]]

    if a is None or b is None:
        a, b = find_ab_params(spread, min_dist)

    if mesh is not None:
        from ..parallel.pipeline import sharded_umap_embed

        # the reference's mesh branch (muon_tpu/_core/tools_graph.py:399-412)
        # passes neither a, b nor init_pos: the same call here
        emb = sharded_umap_embed(
            conn.tocsr(), mesh, n_components=n_components,
            n_epochs=maxiter if maxiter else 200, min_dist=min_dist, spread=spread,
            alpha=alpha, gamma=gamma, negative_sample_rate=negative_sample_rate,
            random_state=random_state if isinstance(random_state, int) else 42,
        )
        data.obsm["X_umap"] = emb
        data.uns["umap"] = {"params": {"a": a, "b": b, "random_state": random_state}}
        return data if copy else None

    emb = umap_embed(
        conn.tocsr(),
        n_components=n_components,
        n_epochs=maxiter,
        init=init_pos if init_pos is not None else "spectral",
        # connectivities from ops/fuzzy are symmetric by construction
        assume_symmetric=True,
        min_dist=min_dist,
        spread=spread,
        alpha=alpha,
        gamma=gamma,
        negative_sample_rate=negative_sample_rate,
        a=a,
        b=b,
        random_state=random_state if isinstance(random_state, int) else 42,
        device=device,
    )
    data.obsm["X_umap"] = emb
    data.uns["umap"] = {"params": {"a": a, "b": b, "random_state": random_state}}
    return data if copy else None
