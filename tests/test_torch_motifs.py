"""The port's motif scan, FASTA reader and peak annotation
(muon_tpu_torch.ops.pwm, atac.motifs, atac._fasta, atac.tools) held to the
JAX package's on the same inputs, and T36 against its plain version on the
card.

On the CPU the port's ``find_hits`` and ``scan_scores`` run T36's plain
version: ``F.conv1d`` of the one-hot per width, as the reference's
``_conv_fn``, in float32. Scores agree within atol 1e-4 and rtol 1e-6 (the
same w terms summed in another order). A window within 1e-3 of its motif's
threshold may pass in one package and not the other, so hit lists are
compared with such windows set aside (and counted); the log-odds and the
thresholds are numpy in both packages and agree bit for bit.
"""

import os

import numpy as np
import pytest
import torch

# The JAX reference. A machine with only the card may lack jax and the
# container libraries; there only the ``gpu`` tests run (-m gpu --noconftest).
try:
    import pandas as pd

    import muon_tpu as mu
    from muon_tpu import atac as jac
    from muon_tpu.atac import _fasta as jfasta
    from muon_tpu.atac import motifs as jmotifs
    from muon_tpu.ops import pwm as jpwm
except ImportError:
    pd = mu = jac = jfasta = jmotifs = jpwm = None

import muon_tpu_torch as mt
from muon_tpu_torch.atac import _fasta as tfasta
from muon_tpu_torch.atac import motifs as tmotifs
from muon_tpu_torch.ops import _kernels
from muon_tpu_torch.ops import pwm as tpwm

CPU = torch.device("cpu")
NEAR = 1e-3  # windows this close to their threshold are set aside


def _subset():
    """About 40 JASPAR motifs covering every width (6-24)."""
    names, pfms = tmotifs._load_jaspar_pfms()
    widths = [p.shape[1] for p in pfms]
    pick = {widths.index(w) for w in set(widths)}
    pick |= set(range(0, len(pfms), 37))
    idx = sorted(pick)
    return [names[i] for i in idx], [pfms[i] for i in idx]


def _random_seqs(rng, n, lo, hi, alphabet="ACGTacgtN"):
    return ["".join(rng.choice(list(alphabet), int(rng.integers(lo, hi + 1))))
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the JASPAR data, log-odds and thresholds
# ---------------------------------------------------------------------------


def test_ref_copy_is_byte_equal():
    ref_dir = os.path.join(os.path.dirname(jmotifs.__file__), "_ref")
    files = sorted(os.listdir(ref_dir))
    assert files == sorted(os.listdir(tmotifs._REF_DIR))
    for f in files:
        with open(os.path.join(ref_dir, f), "rb") as a, \
                open(os.path.join(tmotifs._REF_DIR, f), "rb") as b:
            assert a.read() == b.read(), f


@pytest.mark.parametrize("bg", [None, (0.3, 0.2, 0.2, 0.3)])
def test_log_odds_and_thresholds_bit_for_bit(bg):
    names, pfms = _subset()
    assert len(names) >= 35 and len({p.shape[1] for p in pfms}) == 18
    for pfm in pfms:
        lo_ref = jpwm.pfm_to_log_odds(pfm, bg)
        lo = tpwm.pfm_to_log_odds(pfm, bg)
        assert lo.dtype == np.float64 and np.array_equal(lo, lo_ref)
        for p in (1e-4, 1e-3):
            assert tpwm.threshold_from_p(lo, bg, p) == jpwm.threshold_from_p(lo_ref, bg, p)
    parsed = tmotifs._parse_motif_matrices(background=bg if bg else 4)
    ref = jmotifs._parse_motif_matrices(background=bg if bg else 4)
    assert parsed["motifs"] == ref["motifs"] and len(parsed["motifs"]) == 746
    assert all(np.array_equal(a, b) for a, b in zip(parsed["matrices"], ref["matrices"]))


def test_threshold_f32_is_the_least_float32_not_below():
    rng = np.random.default_rng(0)
    thr = np.concatenate([rng.normal(0, 10, 1000), [0.0, 1.5, -2.25, 7.1]])
    t32 = tpwm.threshold_f32(thr)
    assert t32.dtype == np.float32
    assert (t32.astype(np.float64) >= thr).all()
    below = np.nextafter(t32, np.float32(-np.inf))
    assert (below.astype(np.float64) < thr).all()
    # a float32 score passes t32 exactly when its float64 passes the threshold
    scores = (thr + rng.normal(0, 1e-6, thr.shape)).astype(np.float32)
    assert ((scores >= t32) == (scores.astype(np.float64) >= thr)).all()


# ---------------------------------------------------------------------------
# encoding, scores and hits against the reference
# ---------------------------------------------------------------------------


def test_encode_sequences_matches_the_reference_one_hot():
    rng = np.random.default_rng(1)
    seqs = _random_seqs(rng, 20, 0, 60, "ACGTacgtNRYKMSWn") + ["", "NNNN", "acgtACGT"]
    onehot, valid = jpwm.encode_sequences(seqs)
    codes = tpwm.encode_sequences(seqs)
    assert codes.dtype == np.uint8 and codes.shape == valid.shape
    assert np.array_equal(codes < 4, valid)
    assert np.array_equal(onehot.argmax(-1)[valid], codes[valid])
    assert (codes[~valid] == 4).all()
    same_length = ["ACGTN", "acgtn"]
    assert np.array_equal(tpwm.encode_sequences(same_length),
                          [[0, 1, 2, 3, 4], [0, 1, 2, 3, 4]])
    assert tpwm.encode_sequences([]).shape == (0, 0)


def _compare_scores(ref, got):
    assert list(got) == list(ref)
    for w in ref:
        (a, ma), (b, mb) = ref[w], got[w]
        assert ma == mb and a.shape == b.shape and b.dtype == np.float32
        fin = np.isfinite(a)
        assert np.array_equal(fin, np.isfinite(b)) and (b[~fin] == -np.inf).all()
        np.testing.assert_allclose(b[fin], a[fin], rtol=1e-6, atol=1e-4)


def test_scan_scores_match_the_reference():
    rng = np.random.default_rng(2)
    _, pfms = _subset()
    lo = [tpwm.pfm_to_log_odds(p) for p in pfms]
    seqs = _random_seqs(rng, 27, 5, 300) + ["ACGTA", "N" * 40, "acgtacgtac"]
    _compare_scores(jpwm.scan_scores(seqs, lo), tpwm.scan_scores(seqs, lo, device=CPU))
    # every sequence shorter than most widths: those widths are left out
    short = _random_seqs(rng, 4, 5, 9)
    got = tpwm.scan_scores(short, lo, device=CPU)
    _compare_scores(jpwm.scan_scores(short, lo), got)
    assert max(got) <= 9
    assert tpwm.scan_scores([], lo, device=CPU) == jpwm.scan_scores([], lo) == {}


def _plant(rng, seqs, lo, thresholds, n_plants):
    """Write the consensus of motifs whose consensus clears the threshold
    into random sequences, at random offsets."""
    strong = [m for m, l in enumerate(lo)
              if l.max(axis=0).sum() >= thresholds[m] + 0.01]
    seqs = list(seqs)
    for _ in range(n_plants):
        m = int(rng.choice(strong))
        cons = "".join("ACGT"[b] for b in lo[m].argmax(axis=0))
        i = int(rng.integers(len(seqs)))
        if len(seqs[i]) < len(cons):
            continue
        at = int(rng.integers(len(seqs[i]) - len(cons) + 1))
        seqs[i] = seqs[i][:at] + cons + seqs[i][at + len(cons):]
    return seqs


def _near_keys(seqs, lo, thresholds):
    """(sequence, motif, position) of every window within NEAR of its
    motif's threshold in either package's scores."""
    keys = set()
    th_all = np.asarray(thresholds, np.float64)
    for res in (jpwm.scan_scores(seqs, lo), tpwm.scan_scores(seqs, lo, device=CPU)):
        for scores, midx in res.values():
            th = th_all[midx]
            si, pi, mi = np.nonzero(np.abs(scores - th[None, None, :]) < NEAR)
            keys |= set(zip(si.tolist(), np.asarray(midx)[mi].tolist(), pi.tolist()))
    return keys


@pytest.mark.parametrize("pvalue", [1e-4, 1e-3])
def test_find_hits_match_the_reference(pvalue):
    rng = np.random.default_rng(3)
    _, pfms = _subset()
    lo = [tpwm.pfm_to_log_odds(p) for p in pfms]
    thr = [tpwm.threshold_from_p(m, pvalue=pvalue) for m in lo]
    seqs = _plant(rng, _random_seqs(rng, 40, 20, 200), lo, thr, 30)
    ref = jpwm.find_hits(seqs, lo, thr)
    got = tpwm.find_hits(seqs, lo, thr, device=CPU)
    assert [a.dtype for a in got] == [a.dtype for a in ref]
    near = _near_keys(seqs, lo, thr)

    def kept(h):
        keep = np.array([k not in near for k in zip(*(a.tolist() for a in h[:3]))], bool)
        return tuple(a[keep] if len(a) else a for a in h)

    r, g = kept(ref), kept(got)
    assert len(r[0]) >= 30  # the planted hits at least
    for a, b in zip(r[:3], g[:3]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(g[3], r[3], rtol=1e-6, atol=1e-4)
    # the order is the reference's lexsort, set-aside windows included
    key = (got[0] * len(lo) + got[1]) * 1000 + got[2]
    assert (np.diff(key) > 0).all()
    print(f"{len(near)} windows within {NEAR} of a threshold set aside")


def test_find_hits_without_hits_keep_the_reference_dtypes():
    _, pfms = _subset()
    lo = [tpwm.pfm_to_log_odds(p) for p in pfms]
    thr = [tpwm.threshold_from_p(m) for m in lo]
    for seqs in (["N" * 50, "n" * 30], ["ACG", "TT"], []):
        ref = jpwm.find_hits(seqs, lo, thr)
        got = tpwm.find_hits(seqs, lo, thr, device=CPU)
        assert [len(a) for a in got] == [0] * 4
        assert [a.dtype for a in got] == [a.dtype for a in ref]
    # the reference's no-hit dtypes differ: float64 only when no width is scanned
    assert tpwm.find_hits(["ACG"], lo, thr, device=CPU)[3].dtype == np.float64
    assert tpwm.find_hits(["N" * 50], lo, thr, device=CPU)[3].dtype == np.float32
    # N and padding end a window: no hit overlaps them
    hits = tpwm.find_hits(["ACNGT"], [np.ones((4, 3))], [0.0], device=CPU)
    assert list(hits[2]) == []


def test_find_hits_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpwm.find_hits(["ACGT"], [np.ones((4, 3))], [0.0])


def test_scan_sequences_all_jaspar_matches_the_reference():
    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), 80)) for _ in range(5)]
    ref = jmotifs.scan_sequences(seqs, pvalue=1e-3)
    got = mt.atac.tl.scan_sequences(seqs, pvalue=1e-3, device="cpu")
    assert len(got) > 0
    pd.testing.assert_frame_equal(got, ref, check_exact=False, rtol=1e-6, atol=1e-4)


def test_scan_sequences_planted_motif_and_given_scanner():
    parsed = tmotifs._parse_motif_matrices()
    meta = tmotifs._parse_motif_ids()
    pd.testing.assert_frame_equal(meta, jmotifs._parse_motif_ids())
    name = next(n for n, m in zip(parsed["motifs"], parsed["matrices"])
                if m.shape[1] >= 12 and n in meta.index)
    lo = parsed["matrices"][parsed["motifs"].index(name)]
    consensus = "".join("ACGT"[b] for b in np.argmax(lo, axis=0))
    seq = "TTGACTGAC" + consensus + "GACTGACTG"
    kw = dict(matrices=[lo], motifs=[name], motif_meta=meta, pvalue=1e-4)
    got = tmotifs.scan_sequences([seq], device="cpu", **kw)
    pd.testing.assert_frame_equal(got, jmotifs.scan_sequences([seq], **kw))
    row = got[got["motif_id"] == name].iloc[0]
    assert row["position"] == 9 and row["tf_gene_name"] == meta.loc[name, "tf_gene_name"]
    scanner = tmotifs._prepare_motif_scanner(matrices=[lo], pvalue=1e-4, device="cpu")
    again = tmotifs.scan_sequences([seq], motif_scanner=scanner, motifs=[name])
    pd.testing.assert_frame_equal(again, jmotifs.scan_sequences(
        [seq], motif_scanner=jmotifs._prepare_motif_scanner(matrices=[lo], pvalue=1e-4),
        motifs=[name]))
    with pytest.raises(AssertionError):
        tmotifs.scan_sequences([seq], matrices=[lo], device="cpu")


# ---------------------------------------------------------------------------
# FASTA and get_sequences
# ---------------------------------------------------------------------------


@pytest.fixture()
def genome(tmp_path):
    rng = np.random.default_rng(4)
    chroms = {"chr1": 230, "chr2": 97, "chrM": 16}
    seqs = {c: "".join(rng.choice(list("ACGTacgtN"), n)) for c, n in chroms.items()}
    path = tmp_path / "genome.fa"
    with open(path, "w") as f:
        for c, s in seqs.items():
            f.write(f">{c} some description\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60] + "\n")
    return str(path), seqs


class Holder:
    """The least AnnData-like object get_sequences takes: X, uns and the
    peak names (``var_names``)."""

    def __init__(self, var_names):
        self.X, self.uns, self.var_names = None, {}, np.asarray(var_names)


def test_fasta_file_matches_the_reference(genome):
    path, seqs = genome
    regions = [("chr1", 0, 230), ("chr1", 55, 125), ("chr2", 59, 61), ("chr2", 90, 500),
               ("chrM", 3, 3), ("chrM", -5, 7)]
    with tfasta.FastaFile(path) as fa:  # builds and writes the .fai
        assert os.path.exists(path + ".fai")
        built = dict(fa.index)
        got = [fa.fetch(*r) for r in regions]
        assert fa.references == ["chr1", "chr2", "chrM"]
        with pytest.raises(KeyError):
            fa.fetch("chrX", 0, 1)
    with open(path + ".fai") as f:
        fai = f.read()
    with tfasta.FastaFile(path) as fa:  # reads the .fai
        assert fa.index == built and [fa.fetch(*r) for r in regions] == got
    os.remove(path + ".fai")
    with jfasta.FastaFile(path) as fa:
        assert fa.index == built and [fa.fetch(*r) for r in regions] == got
    with open(path + ".fai") as f:
        assert f.read() == fai
    assert got[:2] == [seqs["chr1"], seqs["chr1"][55:125]]


def test_get_sequences_matches_the_reference(genome, tmp_path):
    path, seqs = genome
    peaks = ["chr1:0-10", "chr2:4-12", "chr1:100-230", "chrM:10-16"]
    ref_ad = mu.AnnData(X=np.zeros((2, 4), np.float32), var=pd.DataFrame(index=peaks))
    jac.tl.locate_genome(ref_ad, path)
    ref = jac.tl.get_sequences(ref_ad, bed=None)
    assert ref == [seqs["chr1"][0:10], seqs["chr2"][4:12], seqs["chr1"][100:230],
                   seqs["chrM"][10:16]]
    # an AnnData (var.index) and a holder with only var_names
    port_ad = mu.AnnData(X=np.zeros((2, 4), np.float32), var=pd.DataFrame(index=peaks))
    assert mt.atac.tl.get_sequences(port_ad, None, fasta_file=path) == ref
    assert port_ad.uns["files"]["genome"] == path
    h = Holder(peaks)
    assert mt.atac.tl.get_sequences(h, None, fasta_file=path) == ref
    bed = "chr1\t2\t6\n\nchr2\t0\t97\n"
    assert mt.atac.tl.get_sequences(h, bed) == jac.tl.get_sequences(ref_ad, bed)
    bed_file = tmp_path / "peaks.bed"
    bed_file.write_text(bed)
    assert (mt.atac.tl.get_sequences(h, None, bed_file=str(bed_file))
            == jac.tl.get_sequences(ref_ad, None, bed_file=str(bed_file)))
    with pytest.raises(FileNotFoundError, match="muon_tpu_torch.atac.tl.locate_genome"):
        mt.atac.tl.get_sequences(Holder(peaks), None)
    with pytest.raises(FileNotFoundError):
        mt.atac.tl.locate_genome(Holder(peaks), str(tmp_path / "missing.fa"))
    with pytest.raises(TypeError):
        mt.atac.tl.get_sequences(object(), None, fasta_file=path)


# ---------------------------------------------------------------------------
# the peak annotation
# ---------------------------------------------------------------------------


def _both_annotate(make_data, table, **kw):
    out = []
    for tl in (jac.tl, mt.atac.tl):
        data = make_data()
        res = tl.add_peak_annotation(data, table, return_annotation=True, **kw)
        atac = data.mod["atac"] if hasattr(data, "mod") else data
        assert atac.uns["atac"]["peak_annotation"] is res
        out.append((data, res))
    return out


def _adata():
    return mu.AnnData(X=np.zeros((2, 2), np.float32))


def test_add_peak_annotation_fan_out_from_a_tsv(tmp_path):
    path = tmp_path / "peak_annotation.tsv"
    path.write_text(
        "chrom\tstart\tend\tgene\tdistance\tpeak_type\n"
        "chr1\t100\t200\tG1;G2\t0;-150\tpromoter;distal\n"
        "chr1\t500\t600\tG3\t20\tdistal\n"
        "chr2\t10\t90\tG4;G5;G6\t7\tdistal\n"
    )
    (_, ref), (_, got) = _both_annotate(_adata, str(path))
    pd.testing.assert_frame_equal(got, ref)
    assert list(got.index) == ["G1", "G2", "G3", "G4", "G5", "G6"]
    assert got["distance"].tolist() == [0, -150, 20, 7, 7, 7]


def test_add_peak_annotation_peak_column_and_missing_distance():
    table = pd.DataFrame({
        "peak": ["chr1_100_200", "chr1_500_600", "chrUn_KI270_1_9"],
        "gene": ["", "G1", "G2"],
        "distance": [None, 10, 3],
        "peak_type": ["intergenic", "promoter", "distal"],
    })
    (_, ref), (_, got) = _both_annotate(_adata, table)
    pd.testing.assert_frame_equal(got, ref)
    assert str(got["distance"].dtype) == "Int64" and pd.isna(got["distance"].iloc[0])
    assert got["peak"].tolist()[:2] == ["chr1:100-200", "chr1:500-600"]
    with pytest.raises(AttributeError):
        mt.atac.tl.add_peak_annotation(_adata(), pd.DataFrame({"gene": ["G"]}))


def _mdata():
    rna = mu.AnnData(X=np.zeros((3, 3), np.float32),
                     var=pd.DataFrame({"gene_ids": ["ENSG1", "ENSG2", "ENSG2"]},
                                      index=["GeneA", "GeneB", "GeneB2"]))
    return mu.MuData({"atac": mu.AnnData(X=np.zeros((3, 2), np.float32)), "rna": rna})


def test_add_peak_annotation_gene_names_through_rna_var():
    table = pd.DataFrame({
        "peak": ["chr1_1_2", "chr1_3_4", "chr1_5_6"],
        "gene": ["ENSG1", "ENSG2", "ENSG9"],
        "distance": [0, 5, 1],
        "peak_type": ["promoter", "distal", "distal"],
    })
    out = []
    for tl in (jac.tl, mt.atac.tl):
        md = _mdata()
        tl.add_peak_annotation(md, table)
        out.append(tl.add_peak_annotation_gene_names(md, return_annotation=True))
        assert md.mod["atac"].uns["atac"]["peak_annotation"] is out[-1]
    pd.testing.assert_frame_equal(out[1], out[0])
    assert out[1].index.name == "gene_name"
    assert list(out[1].index) == ["GeneA", "GeneB", "GeneB2", ""]
    # an annotation that already holds names is only relabelled
    out = []
    for tl in (jac.tl, mt.atac.tl):
        ad = _adata()
        tl.add_peak_annotation(ad, table.assign(gene=["GeneA", "GeneB", "X"]))
        out.append(tl.add_peak_annotation_gene_names(
            ad, gene_names=_mdata().mod["rna"].var, return_annotation=True))
    pd.testing.assert_frame_equal(out[1], out[0])
    with pytest.raises(KeyError, match="muon_tpu_torch.atac.tl.add_peak_annotation"):
        mt.atac.tl.add_peak_annotation_gene_names(_mdata())
    with pytest.raises(ValueError):
        mt.atac.tl.add_peak_annotation_gene_names(
            mu.MuData({"atac": mu.AnnData(X=np.zeros((3, 2), np.float32))}))


def test_add_genes_peaks_groups_names_the_ports_annotation():
    ad = _adata()
    ad.uns["rank_genes_groups"] = {}
    with pytest.raises(KeyError, match="muon_tpu_torch.atac.tl.add_peak_annotation"):
        mt.atac.tl.add_genes_peaks_groups(ad)


# ---------------------------------------------------------------------------
# on the card: T36 against its plain version (skips without one)
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _operands(dev, seqs, log_odds, thresholds):
    codes = torch.from_numpy(tpwm.encode_sequences(seqs)).to(dev)
    lo, off, width = (torch.from_numpy(a).to(dev) for a in tpwm.pack_motifs(log_odds))
    thr = torch.from_numpy(tpwm.threshold_f32(thresholds)).to(dev)
    return codes, lo, off, width, thr


def _jaspar(pvalue=1e-3):
    """Every 7th JASPAR motif (107, widths 6-21) and its thresholds."""
    lo = tmotifs._parse_motif_matrices()["matrices"][::7]
    return lo, [tpwm.threshold_from_p(m, pvalue=pvalue) for m in lo]


def _hits_agree(got, want):
    assert [len(a) for a in got] == [len(a) for a in want]
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b.cpu())
    torch.testing.assert_close(got[3].cpu(), want[3].cpu(), rtol=1e-6, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("max_rows", [None, 40])
def test_gpu_pwm_scan_hits_match_plain(cuda, max_rows, monkeypatch):
    if max_rows is not None:  # several chunks of motifs, each its own launches
        monkeypatch.setattr(tpwm, "_max_rows", lambda dev: max_rows)
    rng = np.random.default_rng(5)
    lo, thr = _jaspar()
    seqs = _plant(rng, _random_seqs(rng, 300, 1, 400), lo, thr, 200) + ["N" * 300]
    ops = _operands(cuda, seqs, lo, thr)
    _kernels.reset_launch_counts()
    got = tpwm.pwm_scan_hits(*ops)
    torch.cuda.synchronize()
    n_chunks = len(tpwm._chunks(*ops[1:4]))
    assert _kernels.launch_counts()["pwm_scan"] == 2 * n_chunks
    assert (max_rows is None) == (n_chunks == 1)
    want = tpwm.pwm_scan_hits_plain(*ops)
    assert len(got[0]) >= 200
    # the float32 sums of both sides hold the same terms; a flip needs a
    # window within an ulp of its threshold, which these data do not hold
    _hits_agree(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("max_rows", [None, 40])
def test_gpu_pwm_scores_match_conv1d(cuda, max_rows, monkeypatch):
    if max_rows is not None:  # several chunks of motifs, each its own launch
        monkeypatch.setattr(tpwm, "_max_rows", lambda dev: max_rows)
    rng = np.random.default_rng(6)
    lo_all = tmotifs._parse_motif_matrices()["matrices"]
    seqs = _random_seqs(rng, 200, 3, 120) + ["N" * 120, "ACGT"]
    codes = torch.from_numpy(tpwm.encode_sequences(seqs)).to(cuda)
    for w in (6, 10, 24):
        group = [m for m in lo_all if m.shape[1] == w]
        lo, off, width = (torch.from_numpy(a).to(cuda) for a in tpwm.pack_motifs(group))
        _kernels.reset_launch_counts()
        got = tpwm.pwm_scores(codes, lo, off, width)
        torch.cuda.synchronize()
        n_chunks = len(tpwm._chunks(lo, off, width))
        assert _kernels.launch_counts()["pwm_scan"] == n_chunks
        # width 10 (149 motifs) takes 38 chunks of 4 under 40 rows
        assert n_chunks == (1 if max_rows is None else -(-len(group) // (max_rows // w)))
        want = tpwm.pwm_scores_plain(codes, lo, off, width)
        assert got.shape == want.shape == (len(seqs), codes.shape[1] - w + 1, len(group))
        fin = torch.isfinite(want)
        assert torch.equal(fin, torch.isfinite(got)) and (got[~fin] == float("-inf")).all()
        torch.testing.assert_close(got[fin], want[fin], rtol=1e-6, atol=1e-4)
    # a width above L_max: no window at all
    wide = [m for m in lo_all if m.shape[1] == 24]
    short = torch.from_numpy(tpwm.encode_sequences(["ACGTACGT"] * 3)).to(cuda)
    ops = [torch.from_numpy(a).to(cuda) for a in tpwm.pack_motifs(wide)]
    assert tpwm.pwm_scores(short, *ops).shape == (3, 0, len(wide))
    with pytest.raises(ValueError, match="one width"):
        tpwm.pwm_scores(codes, *[torch.from_numpy(a).to(cuda)
                                 for a in tpwm.pack_motifs(lo_all[:20])])


@pytest.mark.gpu
def test_gpu_pwm_scan_hits_edges(cuda):
    lo, thr = _jaspar(1e-4)
    # no sequence at all: no hits, and no launch counted
    _kernels.reset_launch_counts()
    got = tpwm.pwm_scan_hits(*_operands(cuda, [], lo, thr))
    assert [len(a) for a in got] == [0] * 4
    assert _kernels.launch_counts()["pwm_scan"] == 0
    # widths above L_max, all-N sequences: no hits, and no launch is refused
    for seqs in (["ACGTA", "TTTT"], ["N" * 200, "n" * 50]):
        got = tpwm.pwm_scan_hits(*_operands(cuda, seqs, lo, thr))
        torch.cuda.synchronize()
        assert [len(a) for a in got] == [0] * 4
    # a score exactly on a threshold representable in float32 passes; one
    # float32 step above it does not
    lo1 = np.array([[0.5, -1.0], [0.25, 0.0], [-2.0, 0.125], [1.0, -0.5]])
    seqs = ["AG", "TA", "TG"]
    scores = {"AG": 0.5 + 0.125, "TA": 1.0 - 1.0, "TG": 1.0 + 0.125}  # lo1[b, j] summed
    for t in (0.625, float(np.nextafter(np.float32(0.625), np.float32(1)))):
        got = tpwm.pwm_scan_hits(*_operands(cuda, seqs, [lo1], [t]))
        want = tpwm.pwm_scan_hits_plain(*_operands(cuda, seqs, [lo1], [t]))
        _hits_agree(got, want)
        passed = {seqs[i] for i in got[0].tolist()}
        assert passed == {s for s, v in scores.items() if v >= t}
    # find_hits on the card against the CPU
    rng = np.random.default_rng(7)
    seqs = _plant(rng, _random_seqs(rng, 50, 30, 300), lo, thr, 40)
    got = tpwm.find_hits(seqs, lo, thr, device=cuda)
    want = tpwm.find_hits(seqs, lo, thr, device=CPU)
    assert [a.dtype for a in got] == [a.dtype for a in want]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-4)
