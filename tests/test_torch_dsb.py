"""The port's DSB (muon_tpu_torch.prot.pp.dsb) held to the JAX package's
(muon_tpu.prot.pp.dsb): every case of tests/test_prot.py::TestDSB through
the port, on the reference's own AnnData and MuData objects, and whole runs
of both packages on one object.

The port draws its uniforms from a ``torch.Generator``; the whole-run
comparisons hand it the reference's (drawn at the reference's padded cell
count) by replacing ``ops.gmm.draw_init_noise``, and run the reference with
x64 off, as in production: float32 everywhere but the float64 moments of
the empty droplets. The two then differ by float32 rounding: the log, the
sums of the EM and the least squares run in another order. Held at atol
1e-4 on ≥ 99.9% of the cells, and 1e-2 on every cell, since a fit that
stops one iteration apart (an ll an ulp across tol) moves its cell's
background a little.
"""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch
from scipy import sparse as sp

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import jax
    import muon_tpu as mu
    from muon_tpu import prot as jpt
    from tests.test_prot import _adata, _make_dsb_fixture
    from tests.test_torch_gmm import reference_noise
except ImportError:
    jax = mu = jpt = _adata = _make_dsb_fixture = reference_noise = None

from muon_tpu_torch import prot as tpt
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import gmm as tgmm

CPU = torch.device("cpu")


def _cite(n_cells=300, n_empty=1500, n_prot=25, seed=0):
    """bench.py::_make_citeseq at a small size: an unfiltered droplet pool,
    one RNA gene (its counts split cells from empties) and the proteins, an
    ambient profile plus signal on a third of them in the cells."""
    rng = np.random.default_rng(seed)
    n = n_cells + n_empty
    is_cell = np.zeros(n, bool)
    is_cell[:n_cells] = True
    rna_umi = np.where(is_cell, rng.poisson(3000, n), rng.poisson(40, n))
    rna = sp.csr_matrix(rna_umi.astype(np.float32)[:, None])
    ambient = rng.gamma(2.0, 2.0, n_prot)
    prot = rng.poisson(ambient[None, :], (n, n_prot)).astype(np.float32)
    cols = rng.choice(n_prot, n_prot // 3, replace=False)
    prot[:n_cells, cols] += rng.poisson(30.0, (n_cells, n_prot // 3)).astype(np.float32)
    return rna, prot


def _mdata(rna, prot):
    md = mu.MuData({"rna": mu.AnnData(rna.copy()), "prot": mu.AnnData(prot.copy())})
    names = [f"bc{i}" for i in range(rna.shape[0])]
    for m in md.mod.values():
        m.obs_names = pd.Index(names)
    md.update()
    return md


@pytest.fixture()
def reference_uniforms(monkeypatch):
    """Make the port draw the reference's uniforms for the cells it is given
    (the reference draws at its padded cell count, from PRNGKey(seed))."""
    def draw(n, d, seed=0, device=None):
        return torch.from_numpy(reference_noise(n, d, seed)).to(device)
    monkeypatch.setattr(tgmm, "draw_init_noise", draw)


def _close(got, ref):
    """atol 1e-4 on >= 99.9% of the rows, 1e-2 on all (see the docstring)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    row = np.abs(got - ref).max(axis=1)
    assert (row <= 1e-4).mean() >= 0.999 and row.max() <= 1e-2, row.max()


# ---------------------------------------------------------------------------
# tests/test_prot.py::TestDSB, each case through the port
# ---------------------------------------------------------------------------


def test_scaling_matches_manual():
    cells, empty = _make_dsb_fixture()
    a_cells = _adata(cells.copy())
    a_empty = _adata(empty.copy(), prefix="empty")
    tpt.pp.dsb(a_cells, a_empty, denoise_counts=False, device=CPU)
    es = np.log(empty + 10)
    expected = (np.log(cells + 10) - es.mean(axis=0)) / es.std(axis=0, ddof=1)
    np.testing.assert_allclose(np.asarray(a_cells.X), expected, rtol=1e-3, atol=1e-4)
    ref = _adata(cells.copy())
    jpt.pp.dsb(ref, _adata(empty.copy(), prefix="empty"), denoise_counts=False)
    assert a_cells.X.dtype == ref.X.dtype == np.float32
    np.testing.assert_allclose(a_cells.X, ref.X, rtol=0, atol=1e-5)


def test_mean_subtract():
    cells, empty = _make_dsb_fixture()
    a_cells, a_empty = _adata(cells.copy()), _adata(empty.copy(), prefix="empty")
    tpt.pp.dsb(a_cells, a_empty, denoise_counts=False, scale_factor="mean_subtract",
               device=CPU)
    es = np.log(empty + 10)
    expected = np.log(cells + 10) - es.mean(axis=0)
    np.testing.assert_allclose(np.asarray(a_cells.X), expected, rtol=1e-3, atol=1e-4)


def test_denoise_reduces_cell_variance():
    cells, empty = _make_dsb_fixture()
    a0, a1 = _adata(cells.copy()), _adata(cells.copy())
    e0, e1 = _adata(empty.copy(), prefix="empty"), _adata(empty.copy(), prefix="empty")
    tpt.pp.dsb(a0, e0, denoise_counts=False, device=CPU)
    tpt.pp.dsb(a1, e1, denoise_counts=True, random_state=0, device=CPU)
    # denoising removes the per-cell technical component: the per-cell
    # offset (over background-dominated values) shrinks
    assert np.median(a1.X, axis=1).std() < np.median(a0.X, axis=1).std()


def test_add_layer_and_sparse():
    cells, empty = _make_dsb_fixture()
    a_cells = _adata(sp.csr_matrix(cells))
    a_empty = _adata(sp.csr_matrix(empty), prefix="empty")
    tpt.pp.dsb(a_cells, a_empty, denoise_counts=False, add_layer=True, device=CPU)
    assert "dsb" in a_cells.layers
    assert sp.issparse(a_cells.X)  # X untouched
    dense = _adata(cells.copy())
    tpt.pp.dsb(dense, _adata(empty.copy(), prefix="empty"), denoise_counts=False, device=CPU)
    np.testing.assert_array_equal(a_cells.layers["dsb"], dense.X)


def test_quantile_clipping():
    cells, empty = _make_dsb_fixture()
    a_cells, a_empty = _adata(cells.copy()), _adata(empty.copy(), prefix="empty")
    tpt.pp.dsb(a_cells, a_empty, denoise_counts=False, quantile_clipping=True,
               quantile_clip=(0.05, 0.95), device=CPU)
    X = np.asarray(a_cells.X)
    es = np.log(empty + 10)
    raw = (np.log(cells + 10) - es.mean(axis=0)) / es.std(axis=0, ddof=1)
    q = np.quantile(raw, [0.05, 0.95])
    assert X.min() >= q[0] - 1e-4 and X.max() <= q[1] + 1e-4
    # np.quantile's bounds are float64, and np.clip takes the values there:
    # the reference's X turns float64 with the same bounds
    ref = _adata(cells.copy())
    jpt.pp.dsb(ref, _adata(empty.copy(), prefix="empty"), denoise_counts=False,
               quantile_clipping=True, quantile_clip=(0.05, 0.95))
    assert X.dtype == ref.X.dtype == np.float64
    np.testing.assert_allclose(X, ref.X, rtol=0, atol=1e-5)


def test_quantile_bounds_are_numpys():
    # the clip bounds are np.quantile's numbers over the same float32 values
    x = np.random.default_rng(0).normal(size=(300, 7)).astype(np.float32)
    qs = (0.001, 0.25, 0.5, 0.9995, 1.0, 0.0)
    got = tpt.preproc._np_quantiles(torch.sort(torch.from_numpy(x).reshape(-1)).values, qs)
    np.testing.assert_array_equal(got, np.quantile(x, qs))


def test_unfiltered_mudata_path():
    """data_raw=None: cells/empties split from raw RNA log10 UMI ranges
    (reference muon/_prot/preproc.py:67-95)."""
    rng = np.random.default_rng(7)
    n_prot = 10
    rna_counts = np.concatenate(
        [rng.integers(50, 800, size=300), rng.integers(5000, 20000, size=100)]
    )
    rna_counts = rna_counts[rng.permutation(400)]
    rna = np.zeros((400, 5), np.float32)
    rna[:, 0] = rna_counts
    prot = rng.poisson(20, size=(400, n_prot)).astype(np.float32)
    mdata = _mdata(rna, prot)
    out = tpt.pp.dsb(mdata, empty_counts_range=(1.0, 3.0), cell_counts_range=(3.5, 5.0),
                     denoise_counts=False, device=CPU)
    assert out is not None
    assert out.mod["prot"].n_obs == int(
        ((np.log10(rna_counts + 1) >= 3.5) & (np.log10(rna_counts + 1) < 5.0)).sum()
    )
    ref = jpt.pp.dsb(_mdata(rna, prot), empty_counts_range=(1.0, 3.0),
                     cell_counts_range=(3.5, 5.0), denoise_counts=False)
    assert list(out.mod["prot"].obs_names) == list(ref.mod["prot"].obs_names)
    np.testing.assert_allclose(out.mod["prot"].X, ref.mod["prot"].X, rtol=0, atol=1e-5)


def test_error_contracts():
    cells, empty = _make_dsb_fixture(n_prot=5)
    a_cells, a_empty = _adata(cells), _adata(empty, prefix="empty")
    with pytest.raises(ValueError, match="pseudocount"):
        tpt.pp.dsb(a_cells, a_empty, pseudocount=-1, device=CPU)
    with pytest.raises(ValueError, match="proteins"):
        tpt.pp.dsb(a_cells, _adata(empty[:, :3], prefix="empty"), device=CPU)
    with pytest.raises(ValueError, match="overlap"):
        tpt.pp.dsb(mu.MuData({"prot": a_cells}), empty_counts_range=(1.0, 3.0),
                   cell_counts_range=(2.0, 4.0), device=CPU)
    with pytest.raises(TypeError, match="'prot' and 'rna'"):
        tpt.pp.dsb(mu.MuData({"prot": a_cells}), empty_counts_range=(1.0, 2.0),
                   cell_counts_range=(2.0, 4.0), device=CPU)
    with pytest.raises(ValueError, match="required"):
        tpt.pp.dsb(a_cells, device=CPU)
    with pytest.raises(TypeError, match="data_raw"):
        tpt.pp.dsb(a_cells, mu.MuData({"rna": a_empty}), device=CPU)
    with pytest.raises(ValueError, match="exactly 2"):
        tpt.pp.dsb(a_cells, a_empty, quantile_clipping=True, quantile_clip=(0.1,), device=CPU)
    with pytest.raises(ValueError, match="between 0 and 1"):
        tpt.pp.dsb(a_cells, a_empty, quantile_clipping=True, quantile_clip=(0.1, 2),
                   device=CPU)


# ---------------------------------------------------------------------------
# whole runs of both packages on one object, the reference's uniforms
# ---------------------------------------------------------------------------


def test_unfiltered_dsb_matches_jax(reference_uniforms):
    # bench.py's mode `dsb` at a small size: clr on a copy, then dsb of the
    # unfiltered MuData with the bench's ranges and random_state
    rna, prot = _cite()
    with jax.enable_x64(False):
        ref = jpt.pp.dsb(_mdata(rna, prot), empty_counts_range=(0.3, 2.5),
                         cell_counts_range=(2.8, 4.5), random_state=1)
    got = tpt.pp.dsb(_mdata(rna, prot), empty_counts_range=(0.3, 2.5),
                     cell_counts_range=(2.8, 4.5), random_state=1, device=CPU)
    assert got.mod["prot"].n_obs == 300
    assert list(got.obs_names) == list(ref.obs_names)
    _close(got.mod["prot"].X, ref.mod["prot"].X)


@pytest.mark.parametrize("controls", [["p0", "p3"], ["p1", "nope"]])
def test_isotype_controls_match_jax(reference_uniforms, controls):
    cells, empty = _make_dsb_fixture(n_cells=200)
    kw = dict(isotype_controls=controls, random_state=2)
    a_j, a_t = _adata(cells.copy()), _adata(cells.copy())
    with jax.enable_x64(False), warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter("always")
        jpt.pp.dsb(a_j, _adata(empty.copy(), prefix="empty"), **kw)
    with warnings.catch_warnings(record=True) as w_t:
        warnings.simplefilter("always")
        tpt.pp.dsb(a_t, _adata(empty.copy(), prefix="empty"), device=CPU, **kw)
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    assert any("isotype" in str(w.message) for w in w_t) == ("nope" in controls)
    _close(a_t.X, a_j.X)


def test_raw_mudata_with_rna_matches_jax(reference_uniforms):
    # data_raw a MuData with rna: its empty droplets by range, those that
    # are cells dropped (with the reference's warnings, in its order)
    rna, prot = _cite(seed=4)
    raw = _mdata(rna, prot)
    cells = raw.mod["prot"][np.arange(0, 300)].copy()
    cells.obs_names = pd.Index([f"bc{i}" for i in range(300)])
    kw = dict(empty_counts_range=(0.0, 4.0), cell_counts_range=(2.8, 4.5), random_state=3)
    with jax.enable_x64(False), warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter("always")
        a_j = cells.copy()
        jpt.pp.dsb(a_j, raw, **kw)
    with warnings.catch_warnings(record=True) as w_t:
        warnings.simplefilter("always")
        a_t = cells.copy()
        tpt.pp.dsb(a_t, raw, device=CPU, **kw)
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    assert any("Dropping 300 empty droplets" in str(w.message) for w in w_t)
    _close(a_t.X, a_j.X)


@pytest.mark.parametrize("raw", ["anndata", "mudata_without_rna"])
def test_raw_without_ranges_matches_jax(reference_uniforms, raw):
    # every non-cell of the raw object counts as empty, with the warnings
    rna, prot = _cite(seed=5)
    md = _mdata(rna, prot)
    data_raw = md.mod["prot"] if raw == "anndata" else mu.MuData({"prot": md.mod["prot"]})
    kw = {} if raw == "anndata" else dict(empty_counts_range=(0.3, 2.5))
    cells = md.mod["prot"][np.arange(0, 300)].copy()
    with jax.enable_x64(False), warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter("always")
        a_j = cells.copy()
        jpt.pp.dsb(a_j, data_raw, random_state=0, **kw)
    with warnings.catch_warnings(record=True) as w_t:
        warnings.simplefilter("always")
        a_t = cells.copy()
        tpt.pp.dsb(a_t, data_raw, random_state=0, device=CPU, **kw)
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    _close(a_t.X, a_j.X)


def test_cpu_dsb_counts_no_launch():
    cells, empty = _make_dsb_fixture()
    _kernels.reset_launch_counts()
    tpt.pp.dsb(_adata(cells), _adata(empty, prefix="empty"), device=CPU)
    assert not any(_kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


class _Holder:
    """The least AnnData-like object dsb takes (no container library)."""

    def __init__(self, X, names):
        self.X, self.obs_names, self.layers = X, np.asarray(names), {}
        self.var_names = np.array([f"p{i}" for i in range(X.shape[1])])

    @property
    def shape(self):
        return self.X.shape

    def __getitem__(self, idx):
        rows = idx[0] if isinstance(idx, tuple) else idx
        return _Holder(self.X[rows], self.obs_names[rows])

    def copy(self):
        return _Holder(self.X.copy(), self.obs_names.copy())


@pytest.mark.gpu
def test_gpu_dsb_launches_t21_once_and_matches_the_cpu(cuda, monkeypatch):
    rng = np.random.default_rng(0)
    ambient = rng.gamma(2.0, 2.0, 30)
    cells = (rng.poisson(ambient, (3000, 30)) + (rng.random((3000, 30)) < 0.3)
             * rng.poisson(50, (3000, 30))).astype(np.float32)
    empty = rng.poisson(ambient, (20000, 30)).astype(np.float32)
    u = tgmm.draw_init_noise(3000, 30, seed=0, device=CPU)
    monkeypatch.setattr(tgmm, "draw_init_noise", lambda n, d, seed=0, device=None: u.to(device))
    out = {}
    for dev in (cuda, CPU):
        h = _Holder(cells.copy(), np.arange(3000).astype(str))
        _kernels.reset_launch_counts()
        tpt.pp.dsb(h, _Holder(empty, np.arange(20000).astype(str)), device=dev)
        out[dev.type] = h.X
        if dev.type == "cuda":
            assert _kernels.launch_counts()["gmm_background_means"] == 1
    row = np.abs(out["cuda"] - out["cpu"]).max(axis=1)
    assert (row <= 1e-4).mean() >= 0.999 and row.max() <= 1e-2
