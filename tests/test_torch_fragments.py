"""The port's fragments engine, fragment QC tools and TSS pileup
(muon_tpu_torch.atac.fragments, atac.tl, ops.pileup) held to the JAX
package's on the same inputs, and T37 against its plain version on the
card.

The data is tests/test_atac_fragments.py's: 40 cells (BC0..BC39), about
20,000 fragments over two chromosomes, 5% of them with unknown barcodes.
Both packages' writers write the same bytes, and each package reads the
other's file with the same records. The pileup is integer arithmetic, so
the port's plain version (``index_put_`` and ``cumsum``) equals the
reference's K17 bit for bit, cells outside [0, n_cells), starts before 0,
ends past n_pos and int32 wrap-around included; the ENCODE scores are exact
integer sums divided once in float64, so ``obs["tss_score"]`` and the
returned matrix are equal bit for bit too.
"""

import gzip
import warnings

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import pandas as pd

    import muon_tpu as mu
    from muon_tpu import atac as jac
    from muon_tpu.atac import fragments as jfr
    from muon_tpu.ops import pileup as jpl
except ImportError:
    pd = mu = jac = jfr = jpl = None

import muon_tpu_torch as mt
from muon_tpu_torch import atac as tac
from muon_tpu_torch import native
from muon_tpu_torch.atac import fragments as tfr
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import pileup as tpl

CPU = torch.device("cpu")
N_CELLS = 40
CHROMS = ["chr1", "chr2"]


def _records(seed=11):
    """tests/test_atac_fragments.py's frag_path records."""
    rng = np.random.default_rng(seed)
    recs = []
    for chrom in CHROMS:
        starts = np.sort(rng.integers(0, 500_000, size=10_000))
        for s in starts:
            length = int(rng.choice([80, 120, 200, 260, 350]))
            bc = (f"BC{rng.integers(0, N_CELLS)}" if rng.random() > 0.05
                  else f"UNKNOWN{rng.integers(5)}")
            recs.append((chrom, int(s), int(s) + length, bc, int(rng.integers(1, 4))))
    return recs


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same records written by each package: {"jax": path, "port": path}."""
    recs = _records()
    d = tmp_path_factory.mktemp("frags")
    out = {"jax": str(d / "jax_fragments.tsv.gz"), "port": str(d / "atac_fragments.tsv.gz")}
    jfr.write_fragments(out["jax"], recs)
    tfr.write_fragments(out["port"], recs)
    return out, recs


def _pair(path, barcode_col=False):
    """The same ATAC AnnData in both packages, the file located in each."""
    rng = np.random.default_rng(0)
    X = rng.poisson(1.0, size=(N_CELLS, 10)).astype(np.float32)
    obs = pd.DataFrame(index=[f"cell{i}" if barcode_col else f"BC{i}" for i in range(N_CELLS)])
    if barcode_col:
        obs["bc"] = [f"BC{i}" for i in range(N_CELLS)]
    aj, at = mu.AnnData(X=X.copy(), obs=obs.copy()), mt.AnnData(X=X.copy(), obs=obs.copy())
    jac.tl.locate_fragments(aj, path)
    tac.tl.locate_fragments(at, path)
    return aj, at


def _genes(pkg, n=60, seed=5):
    """An rna modality whose var["interval"] places n genes on the two
    chromosomes (a few without coordinates)."""
    rng = np.random.default_rng(seed)
    chroms = rng.choice(CHROMS, n)
    starts = np.sort(rng.integers(2_000, 480_000, n))
    intervals = [f"{c}:{s}-{s + int(rng.integers(500, 5000))}" for c, s in zip(chroms, starts)]
    intervals[3] = "NA"
    var = pd.DataFrame({"interval": intervals, "gene_ids": [f"ENSG{i}" for i in range(n)]},
                       index=[f"G{i}" for i in range(n)])
    return pkg.AnnData(X=np.zeros((N_CELLS, n), np.float32),
                       obs=pd.DataFrame(index=[f"BC{i}" for i in range(N_CELLS)]), var=var)


def _mudata_pair(path):
    aj, at = _pair(path)
    return (mu.MuData({"atac": aj, "rna": _genes(mu)}),
            mt.MuData({"atac": at, "rna": _genes(mt)}))


def _same_results(a, b):
    assert list(a) == list(b)
    for k in a:
        if a[k].dtype == object:
            assert a[k].tolist() == b[k].tolist(), k
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the engine: one file, both writers, both readers
# ---------------------------------------------------------------------------


def test_writers_write_the_same_bytes(files):
    paths, recs = files
    for suffix in ("", ".tbi"):
        with open(paths["jax"] + suffix, "rb") as a, open(paths["port"] + suffix, "rb") as b:
            assert a.read() == b.read()
    text = gzip.open(paths["port"]).read().decode()
    assert text == "".join(f"{c}\t{s}\t{e}\t{b}\t{sc}\n" for c, s, e, b, sc in recs)


def test_write_fragments_takes_a_frame_with_categoricals(tmp_path):
    recs = [("chr1", 5, 90, "AAACCTGAGAAACCAT-1", 2), ("chr1", 7, 1_200_000, "B", -3),
            ("chr10", 0, 1, "AAACCTGAGAAACCAT-1", 1234567)]
    df = pd.DataFrame(recs, columns=["chrom", "start", "end", "barcode", "score"])
    df["chrom"] = df["chrom"].astype("category")
    df["barcode"] = pd.Categorical.from_codes([1, 0, 1], ["B", "AAACCTGAGAAACCAT-1"])
    tfr.write_fragments(str(tmp_path / "t.tsv.gz"), df)
    jfr.write_fragments(str(tmp_path / "j.tsv.gz"), recs)
    assert (tmp_path / "t.tsv.gz").read_bytes() == (tmp_path / "j.tsv.gz").read_bytes()
    with pytest.raises(ValueError, match="tab, newline or NUL"):
        tfr.write_fragments(str(tmp_path / "bad.tsv.gz"), [("chr1", 1, 2, "a\tb", 1)])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engines_read_the_same_records(files, writer):
    paths, recs = files
    path = paths[writer]
    bcs = [f"BC{i}" for i in range(N_CELLS)]
    with jfr.TabixFragments(path, barcodes=bcs) as fj, tfr.TabixFragments(path, barcodes=bcs) as ft:
        assert ft.contigs == fj.contigs == CHROMS
        for chrom, beg, end in [("chr1", 100_000, 150_000), ("chr2", 0, 1_000),
                                ("chr1", 499_000, 600_000), ("chrMT", 0, 1000)]:
            _same_results(fj.fetch(chrom, beg, end, names=True),
                          ft.fetch(chrom, beg, end, names=True))
        q = (["chr1", "chr2", "chrX", "chr1"], [10_000, 50_000, 0, 400_000],
             [20_000, 90_000, 10, 420_000])
        _same_results(fj.fetch_many(*q, names=True), ft.fetch_many(*q, names=True))
        _same_results(fj.stream(500, names=True), ft.stream(500, names=True))
        full = ft.stream(10**9)
        _same_results(fj.stream(10**9), full)
    assert len(full["starts"]) == len(recs)
    assert full["starts"].tolist() == [r[1] for r in recs]


def test_engine_built_into_the_build_directory(files):
    so = native.fragments_library_path()
    native.load_fragments_lib()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("libmuon_torch_fragments_")
    assert not list(native._HERE.glob("*.so"))


def test_failed_engine_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "fragments.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .* fragments engine"):
        native._build("fragments")
    assert not list((tmp_path / "_build").glob("*.so"))


# ---------------------------------------------------------------------------
# K17 → T37's plain version, bit for bit
# ---------------------------------------------------------------------------


def _pileup_inputs(seed, nnz, n_cells, n_pos, big=False):
    rng = np.random.default_rng(seed)
    cells = rng.integers(-2, n_cells + 3, nnz)
    starts = rng.integers(-60, n_pos + 60, nnz)
    ends = starts + rng.integers(-20, 300, nnz)
    hi = 2**30 if big else 10
    scores = rng.integers(-hi // 2, hi, nnz)
    return cells, starts, ends, scores


@pytest.mark.parametrize("seed, nnz, n_cells, n_pos, big", [
    (0, 3000, 40, 201, False),
    (1, 5000, 7, 2001, False),
    (2, 1, 3, 5, False),
    (3, 0, 6, 11, False),
    (4, 4000, 5, 64, True),  # sums past 2**31 wrap
])
def test_pileup_plain_matches_k17_bit_for_bit(seed, nnz, n_cells, n_pos, big):
    args = _pileup_inputs(seed, nnz, n_cells, n_pos, big)
    want = jpl.interval_pileup(*args, n_cells=n_cells, n_pos=n_pos)
    _kernels.reset_launch_counts()
    got = tpl.interval_pileup(*args, n_cells=n_cells, n_pos=n_pos, device="cpu")
    assert got.dtype == torch.int32 and got.device == CPU
    assert want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not any(_kernels.launch_counts().values())


def test_pileup_casts_int64_positions_as_the_reference():
    # positions past int32 wrap when cast, in both packages
    cells = np.array([0, 1, 1])
    starts = np.array([2**32 + 3, 5, -(2**32) + 1], np.int64)
    ends = starts + 4
    scores = np.array([1, 2, 3])
    want = jpl.interval_pileup(cells, starts, ends, scores, n_cells=2, n_pos=12)
    got = tpl.interval_pileup(cells, starts, ends, scores, n_cells=2, n_pos=12, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_pileup_refuses_ragged_inputs_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="differ in length"):
        tpl.interval_pileup([0, 1], [0], [1], [1], n_cells=2, n_pos=3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tpl.interval_pileup([0], [0], [1], [1], n_cells=2, n_pos=3)


# ---------------------------------------------------------------------------
# the tools, held to the reference's on the same containers
# ---------------------------------------------------------------------------


def _features(n=50, seed=0):
    rng = np.random.default_rng(seed)
    chroms = np.where(np.arange(n) < n * 3 // 5, "chr1", "chr2")
    starts = rng.integers(1_000, 490_000, n)
    return pd.DataFrame({"Chromosome": chroms, "Start": starts,
                         "End": starts + rng.integers(200, 3000, n),
                         "Strand": rng.choice(["+", "-"], n)})


def _same_tss(aj, at, tj, tt):
    np.testing.assert_array_equal(at.obs["tss_score"].to_numpy(), aj.obs["tss_score"].to_numpy())
    assert type(tt) is mt.AnnData and tt.X.dtype == np.float64
    np.testing.assert_array_equal(tt.X, np.asarray(tj.X))
    pd.testing.assert_frame_equal(tt.obs, tj.obs)
    pd.testing.assert_frame_equal(tt.var, tj.var)


@pytest.mark.parametrize("n_tss, random_state, up, down", [
    (2000, None, 1000, 1000),  # no sampling
    (20, 7, 1000, 1000),       # features.sample(n=20, random_state=7)
    (30, 1, 300, 800),         # another window
])
def test_tss_enrichment_matches_jax(files, n_tss, random_state, up, down):
    aj, at = _pair(files[0]["port"])
    feats = _features()
    tj = jac.tl.tss_enrichment(aj, feats, extend_upstream=up, extend_downstream=down,
                               n_tss=n_tss, random_state=random_state)
    tt = tac.tl.tss_enrichment(at, feats, extend_upstream=up, extend_downstream=down,
                               n_tss=n_tss, random_state=random_state, device="cpu")
    _same_tss(aj, at, tj, tt)


def test_tss_enrichment_of_a_mudata_with_barcodes_column(files):
    aj, at = _pair(files[0]["jax"], barcode_col=True)
    mj = mu.MuData({"atac": aj, "rna": _genes(mu)})
    mt_ = mt.MuData({"atac": at, "rna": _genes(mt)})
    tj = jac.tl.tss_enrichment(mj, n_tss=25, random_state=0, barcodes="bc")
    tt = tac.tl.tss_enrichment(mt_, n_tss=25, random_state=0, barcodes="bc", device="cpu")
    _same_tss(aj, at, tj, tt)
    assert jac.tl.tss_enrichment(mj, n_tss=10, return_tss=False) is None
    assert tac.tl.tss_enrichment(mt_, n_tss=10, return_tss=False, device="cpu") is None


def test_tss_enrichment_runs_on_the_card_unless_asked(files):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, at = _pair(files[0]["port"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tac.tl.tss_enrichment(at, _features())


@pytest.mark.parametrize("stranded, count_reads", [(False, True), (False, False),
                                                   (True, True), (True, False)])
def test_count_fragments_features_matches_jax(files, stranded, count_reads):
    aj, at = _pair(files[0]["port"])
    feats = _features(seed=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        cj = jac.tl.count_fragments_features(aj, feats, stranded=stranded,
                                             count_reads=count_reads)
        ct = tac.tl.count_fragments_features(at, feats, stranded=stranded,
                                             count_reads=count_reads)
    assert type(ct) is mt.AnnData and ct.X.format == "csr" and ct.X.dtype == cj.X.dtype
    assert (ct.X != cj.X).nnz == 0 and ct.X.nnz == cj.X.nnz
    pd.testing.assert_frame_equal(ct.obs, cj.obs)
    pd.testing.assert_frame_equal(ct.var, cj.var)


def test_count_fragments_features_of_a_mudata_warns_as_jax(files):
    mj, mt_ = _mudata_pair(files[0]["port"])
    with pytest.warns(FutureWarning):
        cj = jac.tl.count_fragments_features(mj)
    with pytest.warns(FutureWarning):
        ct = tac.tl.count_fragments_features(mt_)
    assert (ct.X != cj.X).nnz == 0
    pd.testing.assert_frame_equal(ct.var, cj.var)
    for pkg_tl, adata in ((jac.tl, mu.AnnData(X=np.zeros((3, 2)))),
                          (tac.tl, mt.AnnData(X=np.zeros((3, 2))))):
        with pytest.raises(ValueError):
            pkg_tl.count_fragments_features(adata, None)
        with pytest.raises(KeyError):
            pkg_tl.count_fragments_features(adata, _features(3))


@pytest.mark.parametrize("n", [None, 5000, 0])
def test_nucleosome_signal_matches_jax(files, n):
    aj, at = _pair(files[0]["port"])
    jac.tl.nucleosome_signal(aj, n=n)
    tac.tl.nucleosome_signal(at, n=n)
    pd.testing.assert_frame_equal(at.obs, aj.obs)


@pytest.mark.parametrize("features, kw", [
    ("chr1:10000-30000", {}),
    ("chr2-100-60000", {"relative_coordinates": True}),
    ("frame", {"extend_upstream": 500, "extend_downstream": 200}),
    ("frame", {"relative_coordinates": True}),
])
def test_fetch_regions_to_df_matches_jax(files, features, kw):
    if features == "frame":
        features = _features(8, seed=3)
    dj = jac.tl.fetch_regions_to_df(files[0]["port"], features, **kw)
    dt = tac.tl.fetch_regions_to_df(files[0]["port"], features, **kw)
    pd.testing.assert_frame_equal(dt, dj)


def test_gene_annotation_and_region_strings_match_jax():
    pd.testing.assert_frame_equal(mt.rna.utils.get_gene_annotation_from_rna(_genes(mt)),
                                  mu.rna.utils.get_gene_annotation_from_rna(_genes(mu)))
    from muon_tpu.atac import utils as jut
    from muon_tpu_torch.atac import utils as tut

    for s in ("chr1:1-2000000", "chr1-1-2000000", "chrUn_KI270742v1:5-10"):
        pd.testing.assert_frame_equal(tut.parse_region_string(s), jut.parse_region_string(s))


def test_locate_and_default_files_match_jax(files, tmp_path, capsys):
    import shutil

    src = files[0]["port"]
    shutil.copy(src, tmp_path / "atac_fragments.tsv.gz")
    shutil.copy(src + ".tbi", tmp_path / "atac_fragments.tsv.gz.tbi")
    (tmp_path / "atac_peak_annotation.tsv").write_text(
        "peak\tgene\tdistance\tpeak_type\nchr1_1_2\tENSG0;ENSG1\t0;5\tpromoter;distal\n")
    mj, mt_ = _mudata_pair(src)
    jac.tl.initialise_default_files(mj, tmp_path / "filtered_feature_bc_matrix.h5")
    tac.tl.initialise_default_files(mt_, tmp_path / "filtered_feature_bc_matrix.h5")
    uj, ut = mj.mod["atac"].uns, mt_.mod["atac"].uns
    assert ut["files"] == uj["files"] == {"fragments": str(tmp_path / "atac_fragments.tsv.gz")}
    pd.testing.assert_frame_equal(ut["atac"]["peak_annotation"], uj["atac"]["peak_annotation"])
    # a missing file is printed, not raised, and not registered (as the reference)
    aj, at = mu.AnnData(X=np.zeros((2, 2))), mt.AnnData(X=np.zeros((2, 2)))
    capsys.readouterr()
    jac.tl.locate_fragments(aj, str(tmp_path / "missing.tsv.gz"))
    said_j = capsys.readouterr().out
    tac.tl.locate_fragments(at, str(tmp_path / "missing.tsv.gz"))
    assert capsys.readouterr().out == said_j and "files" not in at.uns and "files" not in aj.uns
    frag = tac.tl.locate_fragments(at, src, return_fragments=True)
    assert isinstance(frag, tfr.TabixFragments) and frag.contigs == CHROMS
    frag.close()


def test_qc_path_on_the_port_mudata_matches_jax(files):
    """The smoke's sequence at this size: nucleosome_signal → tss_enrichment
    → filter_obs on the scores → update → count_fragments_features."""
    mj, mt_ = _mudata_pair(files[0]["port"])
    out = []
    for pkg, tl, md, kw in ((mu, jac.tl, mj, {}), (mt, tac.tl, mt_, {"device": "cpu"})):
        tl.nucleosome_signal(md)
        tl.tss_enrichment(md, n_tss=40, random_state=0, **kw)
        pkg.pp.filter_obs(md.mod["atac"], "tss_score", lambda x: x >= 1.0)
        md.update()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            out.append((md, tl.count_fragments_features(md)))
    (mj, cj), (mt_, ct) = out
    assert 0 < mt_.mod["atac"].n_obs < N_CELLS
    pd.testing.assert_frame_equal(mt_.mod["atac"].obs, mj.mod["atac"].obs)
    assert mt_.n_obs == mj.n_obs
    for k in ("atac", "rna"):
        np.testing.assert_array_equal(mt_.obsmap[k], mj.obsmap[k])
        np.testing.assert_array_equal(mt_.obsm[k], mj.obsm[k])
    assert (ct.X != cj.X).nnz == 0 and ct.shape == cj.shape


# ---------------------------------------------------------------------------
# on the card (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("seed, nnz, n_cells, n_pos, big", [
    (0, 3000, 40, 201, False),
    (1, 200_000, 300, 2001, False),
    (2, 1, 3, 5, False),
    (4, 40_000, 5, 64, True),
    (5, 50_000, 20, 5000, False),  # rows longer than one 2048-word tile
])
def test_gpu_pileup_matches_plain(cuda, seed, nnz, n_cells, n_pos, big):
    args = [torch.from_numpy(a.astype(np.int32)).to(cuda)
            for a in _pileup_inputs(seed, nnz, n_cells, n_pos, big)]
    want = tpl.interval_pileup_plain(*args, n_cells, n_pos)
    _kernels.reset_launch_counts()
    got = tpl.interval_pileup(*args, n_cells=n_cells, n_pos=n_pos, device=cuda)
    torch.cuda.synchronize()
    assert _kernels.launch_counts()["interval_pileup"] == 1
    assert got.dtype == torch.int32 and got.is_contiguous() and got.shape == (n_cells, n_pos)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_gpu_pileup_launches_nothing_without_fragments(cuda):
    _kernels.reset_launch_counts()
    e = torch.empty(0, dtype=torch.int32, device=cuda)
    got = tpl.interval_pileup(e, e, e, e, n_cells=4, n_pos=9, device=cuda)
    torch.cuda.synchronize()
    assert not any(_kernels.launch_counts().values())
    assert torch.equal(got, torch.zeros((4, 9), dtype=torch.int32, device=cuda))


@pytest.mark.gpu
def test_gpu_tss_enrichment_matches_cpu(cuda, tmp_path):
    path = str(tmp_path / "f.tsv.gz")
    tfr.write_fragments(path, _records())
    X = np.zeros((N_CELLS, 2), np.float32)
    obs_names = [f"BC{i}" for i in range(N_CELLS)]
    ads = [mt.AnnData(X=X.copy()) for _ in range(2)]
    for ad in ads:
        ad.obs_names = obs_names
        tac.tl.locate_fragments(ad, path)
    feats = {"Chromosome": ["chr1"] * 30 + ["chr2"] * 20,
             "Start": list(range(10_000, 310_000, 10_000)) + list(range(5_000, 205_000, 10_000))}
    import pandas as pd_

    feats = pd_.DataFrame(feats)
    _kernels.reset_launch_counts()
    tg = tac.tl.tss_enrichment(ads[0], feats, device=cuda)
    assert _kernels.launch_counts()["interval_pileup"] == 1
    tc = tac.tl.tss_enrichment(ads[1], feats, device="cpu")
    np.testing.assert_array_equal(tg.X, tc.X)
    np.testing.assert_array_equal(ads[0].obs["tss_score"].to_numpy(),
                                  ads[1].obs["tss_score"].to_numpy())
