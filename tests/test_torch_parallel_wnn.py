"""The port's WNN over a device mesh (parallel.sharded_wnn_bandwidth,
sharded_wnn_theta, sharded_wnn_scores; pp.neighbors of a MuData with a
mesh) held to the JAX package's sharded programs on the reference's
fixtures (tests/test_multichip.py), and the pipeline on a mesh with a feat
axis.

One spawn at each world size P in {1, 2, 4}: P ranks started by
``torch.multiprocessing``, a gloo group on the CPU joined through a
``file://`` store, one thread each. The sharded functions run on
``make_mesh(P, feat=1)``, as the reference's; the public WNN on
``make_mesh(P)`` ((2, 2) at P = 4) under ``set_options(mesh=...)``. The
parent runs the reference on ``make_mesh(P, feat=1)`` of its 8 virtual CPU
devices and compares. The rank worker imports no JAX.

Tolerances, each with its reason:

* σ, θ, the fused distances: rtol 1e-5 atol 1e-6 (the reference test's
  own): the same float32 arithmetic, sums in another order.
* the fused ids: equal wherever the reference's distances are not tied
  (within 1e-7), as the reference's test holds them.
* the public WNN under a mesh against the port's single-device WNN: the
  weights bit for bit (σ and θ are the same kernels on the same rows);
  the per-row five largest fused distances rtol 1e-3 atol 1e-4, the
  reference test's rule (n = 485 divides by no P).
* TF-IDF → LSI on a (2, 2) mesh against (4, 1): the values bit for bit
  (integer column sums), s rtol 1e-5 and every column |cos| > 0.9999 (the
  rSVD's sums over two blocks against four).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import sparse as sp

from muon_tpu_torch import parallel as tpar

WORLD_SIZES = (1, 2, 4)
SCORE_K, BW_NBW = 10, 5
DIMS = ((0, 12), (12, 20))


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}
        self.n_obs = X.shape[0]


class MuHolder:
    """The least MuData-like object WNN takes."""

    def __init__(self, mods):
        self.mod = mods
        self.n_obs = next(iter(mods.values())).n_obs
        self.obsmap = {k: np.arange(1, self.n_obs + 1) for k in mods}
        self.obs, self.obsm, self.obsp, self.uns = {}, {}, {}, {}


# ---------------------------------------------------------------------------
# the fixtures' data (tests/test_multichip.py), host numpy
# ---------------------------------------------------------------------------


def bf16(a):
    """float32 values rounded to bfloat16 (to nearest even), as float32."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def score_inputs():
    """test_sharded_wnn_scores_match_single_device's, n = 520, C = 40."""
    rng = np.random.default_rng(0)
    n, C, M = 520, 40, 2
    cat = rng.normal(size=(n, 20)).astype(np.float32)
    aux = np.zeros((n, 2 * M), np.float32)
    for m, (lo, hi) in enumerate(DIMS):
        aux[:, m] = (cat[:, lo:hi] ** 2).sum(1)
        aux[:, M + m] = 1.0
    sigw = np.abs(rng.normal(size=(n, 2 * M))).astype(np.float32) + 0.5
    cand = rng.integers(0, n, size=(n, C)).astype(np.int32)
    cand[rng.random((n, C)) < 0.1] = -1
    return cand, cat, aux, sigw


def bandwidth_inputs():
    """test_sharded_wnn_bandwidth_matches_single_device's, n = 1000, kk = 8."""
    rng = np.random.default_rng(1)
    n, kk, d = 1000, 8, 12
    rep = rng.normal(size=(n, d)).astype(np.float32)
    NI = rng.integers(0, n, size=(n, kk)).astype(np.int32)
    NI[rng.random((n, kk)) < 0.05] = -1
    return NI, rep


def theta_inputs():
    """test_sharded_wnn_theta_matches_single_device's partial overlap."""
    rng = np.random.default_rng(2)
    n1, n2, kk, d, m = 900, 700, 6, 10, 600
    rep = rng.normal(size=(n1, d)).astype(np.float32)
    NI2 = rng.integers(0, n2, size=(n2, kk)).astype(np.int32)
    NI2[rng.random((n2, kk)) < 0.1] = -1
    rows1 = rng.choice(n1, size=m, replace=False).astype(np.int32)
    rows2 = rng.choice(n2, size=m, replace=False).astype(np.int32)
    conv = rng.integers(-1, n1, size=n2).astype(np.int32)
    nnd = np.abs(rng.normal(size=n1)).astype(np.float32) * 0.1
    sig = nnd + 0.5 + np.abs(rng.normal(size=n1)).astype(np.float32)
    return rep, rows1, rows2, NI2, conv, nnd, sig


def global_mesh_reps():
    """test_wnn_umap_mofa_global_mesh's two modalities: n = 485."""
    rng = np.random.default_rng(1)
    n, ncl = 485, 4
    labels = rng.integers(0, ncl, n)
    cents1 = rng.normal(size=(ncl, 10)) * 4
    cents2 = rng.normal(size=(ncl, 8)) * 4
    R1 = (cents1[labels] + rng.normal(size=(n, 10))).astype(np.float32)
    R2 = (cents2[labels] + rng.normal(size=(n, 8))).astype(np.float32)
    return R1, R2


def lsi_counts():
    rng = np.random.default_rng(1)
    n, d, g = 512, 200, 8
    lab = rng.integers(0, g, n)
    dense = rng.poisson(0.3, (n, d)).astype(np.float64)
    for j in range(g):
        cols = slice(j * (d // g), (j + 1) * (d // g))
        dense[lab == j, cols] += rng.poisson(5.0, ((lab == j).sum(), d // g))
    return sp.csr_matrix(dense.astype(np.float32))


def _wnn(mesh, device):
    from muon_tpu_torch import pp, set_options

    mods = {k: Holder(R) for k, R in zip(("a", "b"), global_mesh_reps())}
    for h in mods.values():
        pp.neighbors(h, n_neighbors=12, use_rep="X", device="cpu")
    md = MuHolder(mods)
    if mesh is None:
        pp.neighbors(md, device=device)
    else:
        with set_options(mesh=mesh):
            pp.neighbors(md)
    return md


# ---------------------------------------------------------------------------
# the rank worker (no JAX)
# ---------------------------------------------------------------------------


def _rank_main(rank, P, store, workdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=P)
    try:
        mesh1 = tpar.make_mesh(P, feat=1, device="cpu")
        mesh = tpar.make_mesh(P, device="cpu")
        out = {}
        cand, cat, aux, sigw = score_inputs()
        idx, dist_ = tpar.sharded_wnn_scores(cand, bf16(cat), aux, sigw, DIMS, mesh1,
                                             k=SCORE_K, block=64)
        out.update(scores_idx=idx.numpy(), scores_dist=dist_.numpy())
        NI, rep = bandwidth_inputs()
        for stride in (1, 2):
            out[f"sigma_{stride}"] = tpar.sharded_wnn_bandwidth(
                NI, rep, mesh1, n_bw=BW_NBW, block=64, nn_stride=stride).numpy()
        out["theta"] = tpar.sharded_wnn_theta(*theta_inputs(), mesh1, block=64).numpy()

        # the pipeline on the default mesh ((2, 2) at P = 4) and on (P, 1)
        X = lsi_counts()
        om = np.random.default_rng(0).normal(size=(X.shape[1], 16)).astype(np.float32)
        for tag, m in (("feat1", mesh1), ("default", mesh)):
            Xs = tpar.sharded_tfidf_data(tpar.shard_rows(X, m))
            U, s, Vt = tpar.sharded_rsvd(Xs, 6, n_iter=6, omega=om)
            out.update({f"lsi_{tag}_values": tpar.sharded_values_to_scipy(Xs, X).data,
                        f"lsi_{tag}_U": U.numpy(), f"lsi_{tag}_s": s.numpy(),
                        f"lsi_{tag}_Vt": Vt.numpy()})

        # the public WNN: one device, then under set_options(mesh=...)
        for tag, m in (("single", None), ("mesh", mesh)):
            md = _wnn(m, "cpu")
            out[f"wnn_{tag}_dist"] = md.obsp["distances"].toarray()
            out[f"wnn_{tag}_w"] = np.stack([md.obs["a:mod_weight"], md.obs["b:mod_weight"]])
        np.savez(Path(workdir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the reference (JAX, imported here only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=WORLD_SIZES, ids=lambda p: f"P{p}")
def run(request, tmp_path_factory):
    """Spawn the P ranks, run the reference's sharded programs, return both."""
    import ml_dtypes
    import torch.multiprocessing as mp
    from muon_tpu.parallel import make_mesh
    from muon_tpu.parallel import pipeline as jp

    P = request.param
    work = tmp_path_factory.mktemp(f"wnn_mesh{P}")
    mesh = make_mesh(P, feat=1)
    ref = {}
    cand, cat, aux, sigw = score_inputs()
    idx, dist_ = jp.sharded_wnn_scores(cand, cat.astype(ml_dtypes.bfloat16), aux, sigw, DIMS,
                                       mesh, k=SCORE_K, block=64)
    ref.update(scores_idx=np.asarray(idx), scores_dist=np.asarray(dist_))
    NI, rep = bandwidth_inputs()
    for stride in (1, 2):
        ref[f"sigma_{stride}"] = np.asarray(jp.sharded_wnn_bandwidth(
            NI, rep, mesh, n_bw=BW_NBW, block=64, nn_stride=stride))
    ref["theta"] = np.asarray(jp.sharded_wnn_theta(*theta_inputs(), mesh, block=64))
    mp.spawn(_rank_main, args=(P, str(work / "store"), str(work)), nprocs=P)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(P)]
    return {"P": P, "ranks": ranks, "port": ranks[0], "ref": ref}


def test_every_rank_returns_the_whole_result(run):
    first = run["ranks"][0]
    for other in run["ranks"][1:]:
        assert first.keys() == other.keys()
        for key in first:
            np.testing.assert_array_equal(other[key], first[key], err_msg=key)


# ---------------------------------------------------------------------------
# the sharded programs against the reference's
# ---------------------------------------------------------------------------


def test_sharded_scores_match_reference(run):
    port, ref = run["port"], run["ref"]
    assert port["scores_idx"].dtype == np.int32 and port["scores_idx"].shape == (520, SCORE_K)
    np.testing.assert_allclose(port["scores_dist"], ref["scores_dist"], rtol=1e-5, atol=1e-6)
    # ids equal wherever the reference's distances are not tied
    ties = np.abs(np.diff(ref["scores_dist"], axis=1)) < 1e-7
    stable = np.ones_like(ref["scores_idx"], bool)
    stable[:, 1:] &= ~ties
    stable[:, :-1] &= ~ties
    np.testing.assert_array_equal(port["scores_idx"][stable], ref["scores_idx"][stable])


@pytest.mark.parametrize("stride", [1, 2])
def test_sharded_bandwidth_matches_reference(run, stride):
    got = run["port"][f"sigma_{stride}"]
    assert got.dtype == np.float32 and got.shape == (1000,)
    np.testing.assert_allclose(got, run["ref"][f"sigma_{stride}"], rtol=1e-5, atol=1e-6)


def test_sharded_theta_matches_reference(run):
    got = run["port"]["theta"]
    assert got.dtype == np.float32 and got.shape == (600,)
    np.testing.assert_allclose(got, run["ref"]["theta"], rtol=1e-5, atol=1e-6)


def test_sharded_functions_equal_one_device(run):
    # the same kernels (their plain twins here) on each rank's rows of the
    # whole tables: the single-device functions bit for bit
    from muon_tpu_torch.ops import wnn as tw

    port = run["port"]
    NI, rep = bandwidth_inputs()
    NI_t, rep_t = torch.from_numpy(NI), torch.from_numpy(rep)
    bbox = float(np.linalg.norm(np.ptp(rep, axis=0), ord=2))
    for stride in (1, 2):
        want = tw.wnn_bandwidth(NI_t, *tw._bandwidth_tables(NI_t, rep_t), 1000.0, bbox,
                                BW_NBW, stride)
        np.testing.assert_array_equal(port[f"sigma_{stride}"], want.numpy())
    want = tw.wnn_theta(*(torch.from_numpy(a) for a in theta_inputs()))
    np.testing.assert_array_equal(port["theta"], want.numpy())
    cand, cat, aux, sigw = (torch.from_numpy(a) for a in score_inputs())
    cat16 = cat.to(torch.bfloat16)
    idx, dist_ = tw.final_topk(tw.wnn_fusion_scores(cand, cat16, aux, sigw, DIMS, "euclidean"),
                               cand, SCORE_K)
    np.testing.assert_array_equal(port["scores_idx"], idx.numpy())
    np.testing.assert_array_equal(port["scores_dist"], dist_.numpy())


@pytest.mark.parametrize("row0, rows", [(0, 1000), (0, 333), (333, 334), (667, 333), (999, 1)])
def test_bandwidth_window_equals_the_whole(row0, rows):
    # T9's plain twin on a row window: the window's rows of the whole result
    from muon_tpu_torch.ops import wnn as tw

    NI, rep = bandwidth_inputs()
    NI_t, rep_t = torch.from_numpy(NI), torch.from_numpy(rep)
    tables = tw._bandwidth_tables(NI_t, rep_t)
    whole = tw.wnn_bandwidth(NI_t, *tables, 1000.0, 9.0, BW_NBW, 2)
    part = tw.wnn_bandwidth(NI_t, *tables, 1000.0, 9.0, BW_NBW, 2, row0=row0, rows=rows)
    np.testing.assert_array_equal(part.numpy(), whole[row0:row0 + rows].numpy())
    with pytest.raises(ValueError, match="outside"):
        tw.wnn_bandwidth(NI_t, *tables, 1000.0, 9.0, BW_NBW, 2, row0=row0 + 1, rows=1000)


@pytest.mark.parametrize("row0, rows", [(0, 520), (0, 173), (173, 174), (347, 173)])
def test_fusion_window_equals_the_whole(row0, rows):
    # T11's plain twin on a row window: the window's rows of the whole result
    from muon_tpu_torch.ops import wnn as tw

    cand, cat, aux, sigw = (torch.from_numpy(a) for a in score_inputs())
    cat16 = cat.to(torch.bfloat16)
    whole = tw.wnn_fusion_scores(cand, cat16, aux, sigw, DIMS, "euclidean")
    part = tw.wnn_fusion_scores(cand[row0:row0 + rows].contiguous(), cat16, aux, sigw, DIMS,
                                "euclidean", row0=row0)
    np.testing.assert_array_equal(part.numpy(), whole[row0:row0 + rows].numpy())
    with pytest.raises(ValueError, match="outside"):
        tw.wnn_fusion_scores(cand, cat16, aux, sigw, DIMS, "euclidean", row0=1)


# ---------------------------------------------------------------------------
# the public WNN under a mesh, and the pipeline on a feat axis
# ---------------------------------------------------------------------------


def test_public_wnn_under_a_mesh(run):
    port = run["port"]
    np.testing.assert_array_equal(port["wnn_mesh_w"], port["wnn_single_w"])
    v1 = np.sort(port["wnn_single_dist"], axis=1)[:, -5:]
    v2 = np.sort(port["wnn_mesh_dist"], axis=1)[:, -5:]
    np.testing.assert_allclose(v2, v1, rtol=1e-3, atol=1e-4)


def _col_cos(a, b):
    return np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))


def test_tfidf_lsi_on_a_feat_axis_equals_cells_only(run):
    # at P = 4 the (2, 2) mesh cuts the rows in two blocks, the (4, 1) in
    # four: the TF-IDF values alike (integer column sums), the rSVD's sums in
    # another order (s rtol 1e-5, every column |cos| > 0.9999, the rule of
    # tests/test_torch_parallel.py); at P < 4 the two meshes are one
    port = run["port"]
    np.testing.assert_array_equal(port["lsi_default_values"], port["lsi_feat1_values"])
    np.testing.assert_allclose(port["lsi_default_s"], port["lsi_feat1_s"], rtol=1e-5)
    assert (_col_cos(port["lsi_default_U"], port["lsi_feat1_U"]) > 0.9999).all()
    assert (_col_cos(port["lsi_default_Vt"].T, port["lsi_feat1_Vt"].T) > 0.9999).all()
    if run["P"] < 4:
        np.testing.assert_array_equal(port["lsi_default_U"], port["lsi_feat1_U"])


# ---------------------------------------------------------------------------
# on the card (skips without one): T9 and T11 on a window against their plain twins
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("stride, row0, rows", [(1, 0, 1000), (2, 500, 500), (2, 999, 1)])
def test_gpu_bandwidth_window_matches_plain(cuda, stride, row0, rows):
    from muon_tpu_torch.ops import _kernels
    from muon_tpu_torch.ops import wnn as tw

    NI, rep = bandwidth_inputs()
    NI_t, rep_t = torch.from_numpy(NI).to(cuda), torch.from_numpy(rep).to(cuda)
    tables = tw._bandwidth_tables(NI_t, rep_t)
    before = _kernels.launch_counts()["wnn_bandwidth"]
    got = tw.wnn_bandwidth(NI_t, *tables, 1000.0, 9.0, BW_NBW, stride, row0=row0, rows=rows)
    assert _kernels.launch_counts()["wnn_bandwidth"] == before + 1
    want = tw.wnn_bandwidth_plain(NI_t, *tables, 1000.0, 9.0, BW_NBW, stride, row0=row0,
                                  rows=rows)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_gpu_bandwidth_global_window_matches_plain(cuda, monkeypatch):
    # the global-memory variant: min(rows, 528) blocks over the window
    from muon_tpu_torch.ops import _kernels
    from muon_tpu_torch.ops import wnn as tw

    NI, rep = bandwidth_inputs()
    # a limit below the shared variant's tables (1104 bytes here), above the
    # sorted set and the rep the global variant keeps there (80 bytes)
    limit = tw._bandwidth_smem(NI.shape[1], rep.shape[1], BW_NBW, 1) - 4
    assert limit >= 4 * (NI.shape[1] + rep.shape[1])
    monkeypatch.setattr(tw, "MAX_SMEM", limit)
    NI_t, rep_t = torch.from_numpy(NI).to(cuda), torch.from_numpy(rep).to(cuda)
    tables = tw._bandwidth_tables(NI_t, rep_t)
    before = _kernels.launch_counts()["wnn_bandwidth_global"]
    got = tw.wnn_bandwidth(NI_t, *tables, 1000.0, 9.0, BW_NBW, 1, row0=300, rows=600)
    assert _kernels.launch_counts()["wnn_bandwidth_global"] == before + 1
    want = tw.wnn_bandwidth_plain(NI_t, *tables, 1000.0, 9.0, BW_NBW, 1, row0=300, rows=600)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("row0, rows", [(0, 520), (260, 260), (519, 1)])
def test_gpu_fusion_window_matches_plain(cuda, row0, rows):
    from muon_tpu_torch.ops import wnn as tw

    cand, cat, aux, sigw = (torch.from_numpy(a).to(cuda) for a in score_inputs())
    cat16 = cat.to(torch.bfloat16)
    c = cand[row0:row0 + rows].contiguous()
    got = tw.wnn_fusion_scores(c, cat16, aux, sigw, DIMS, "euclidean", row0=row0)
    want = tw.wnn_fusion_scores_plain(c, cat16, aux, sigw, DIMS, "euclidean", row0=row0)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
