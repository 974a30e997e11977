"""Drive the PyTorch/CUDA port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA device, nvcc, g++

The user journey of ``bench_e2e.py`` through ``muon_tpu_torch``, at full
width, 100,000 cells:

* ATAC: ``atac.pp.tfidf`` → ``atac.tl.lsi(n_comps=50)`` →
  ``pp.neighbors(n_neighbors=20, use_rep="X_lsi")`` on synthetic ATAC
  counts, 100,000 cells × 25,000 peaks, 250 draws per cell with Pareto(1.2)
  peak popularity (the recipe of ``bench.py::make_counts``, seed 0);
* RNA: library-size normalisation (row sums, 1e4 / max(rs, 1), row scaling,
  log1p) → ``pp.pca(n_comps=50)`` → ``pp.neighbors(n_neighbors=20,
  use_rep="X_pca")`` on the clustered RNA counts of ``bench_e2e.py::synth``
  at its scale-10 size: 100,000 cells × 20,000 genes, 100 draws per cell,
  20 planted clusters, seed 0 (labels drawn first, as there);
* prot: the protein modality of the same ``synth`` (drawn after the ATAC
  one from the same generator: 100,000 × 120 dense, planted centres plus
  Poisson(3)) through ``prot.pp.clr`` → ``pp.pca(n_comps=30)`` →
  ``pp.neighbors(n_neighbors=20, use_rep="X_pca")``;
* WNN: the ATAC modality of the same ``synth`` (100,000 × 25,000, 150
  draws per cell, the same labels) through ``atac.pp.tfidf`` →
  ``atac.tl.lsi(n_comps=50)`` → ``pp.neighbors(n_neighbors=20,
  use_rep="X_lsi")``, then ``pp.neighbors(mdata)`` over {rna, atac, prot}
  with the default parameters (n_multineighbors 200, n_bandwidth_neighbors
  20);
* Leiden: ``tl.leiden(mdata, resolution=1.0)`` over the three modality
  graphs (on the host, the native engine);
* UMAP: ``tl.umap(mdata)`` on the WNN graph, 200 epochs;

and the path above 200,000 rows at 1,000,000 cells: a 1,000,000 × 50
float32 representation of 40 planted clusters whose neighbours overlap
(drawn from seed 0; no count matrix at this size) through
``pp.neighbors(n_neighbors=20)``, which takes the IVF index (k-means, the
host layout, the search, the scatter back), T6 and the native fuzzy union,
then ``tl.umap`` on its graph of about 30M edges, seeded from the membership
table;

and MOFA+ through ``models.mofa.fit_mofa`` at three sizes: the recipe of
``bench.py``'s mode ``mofa`` (10,000 cells, gaussian views of 2000 and 3000
features from 15 planted factors, seed 0, 2 warm-up sweeps and then 50
full-batch sweeps); the MOFA stage of ``bench_e2e.py`` at 100,000 cells (the
256 most variable columns of the normalised RNA and of the TF-IDF ATAC
matrix, selected on the device through ``ops.sparse.col_sums``, K = 15,
stochastic VI, 100 iterations of 50,000 cells); and the same stochastic fit
on two 1,000,000 × 256 views made on the device from 15 planted factors;

and MOFA+'s other likelihoods and priors at the same sizes: a bernoulli
(then a poisson) view of 3000 columns drawn from the bench's planted factors
beside its 2000-column gaussian view, the e2e's SVI stage with its ATAC
columns binarised as a bernoulli view, and spike-slab factors; and
MEFISTO's smooth factors: GP priors over time for 3,000 cells in two groups
(views of 500 and 800, K = 10; with learned group correlations and with
DTW warping), and the sparse GP at 100,000 cells with 1,000 inducing cells;

and the recipe of ``bench.py``'s mode ``dsb`` (``prot.pp.clr``, then
``prot.pp.dsb`` of the unfiltered droplets, split by their RNA counts, 140
proteins) at its own 10,000 cells + 50,000 empty droplets and at 100,000 +
500,000;

and the marker genes of the 20 planted clusters (``tl.rank_genes_groups``:
t-test, wilcoxon and logreg on the e2e's normalised RNA, wilcoxon on its
TF-IDF ATAC, the ranking ``atac.tl.rank_peaks_groups`` runs), and ``tl.snf``
of the first 10,000 cells' three modality graphs (about the 10x PBMC 10k
multiome's size: SNF is dense n × n by design) followed by ``tl.leiden``;

and the decompositions and dense normalisations: ``tl.ica`` on the e2e RNA's
``X_pca`` (100,000 × 50) and on 50 planted Laplace sources mixed into
100,000 × 50, ``atac.pp.scopen`` (30 factors, 500 iterations) on the e2e's
ATAC counts, 100,000 cells × 25,000 peaks as CSR on the card, and
``ops.dense.tfidf_dense``/``l2norm_dense`` on the same counts dense and on
the RNA's ``X_pca``.

and the fragment QC path at 100,000 cells: a tabix-indexed fragments file of
about 2.25·10⁷ records (10x barcodes, 2,200 genes on three chromosomes, a TSS
profile planted in nine cells of ten, a nucleosome ladder of lengths, 5% of
the records from barcodes of no cell) written from the seed by the port's
``write_fragments``, in a port ``MuData`` of ``rna`` (the genes' intervals)
and ``atac``, through ``atac.tl.locate_fragments`` → ``nucleosome_signal`` →
``tss_enrichment(n_tss=2000)`` → ``pp.filter_obs`` on the TSS scores and
``update()`` → ``count_fragments_features``.

Phases, one line each or more. A failed check is printed as ``[check
failed]`` and recorded, and the run goes on, so that one run reads every
number; at the end any recorded failure makes the exit code 1 and no result
is printed. An exception stops the run at once, with a code other than 0:

1. device: the card, the torch/CUDA/nvcc versions, which optional modules import;
2. build: compile the CUDA kernels from ``muon_tpu_torch/csrc`` and the
   Leiden engine from ``muon_tpu_torch/native``;
3. kernels: T1-T4 against their plain PyTorch versions at the ATAC path's
   shapes, with their tolerances, and both times (median of 5, CUDA events);
4. ATAC path, with the launch counters reset just before and read just
   after, then the gather rSVD on the same matrix with its own counts;
   checks of shapes, finiteness, z-scoring, the TF-IDF values against
   scipy, the singular values against the plain-PyTorch path with the same
   Ω, and the neighbour graph;
5. RNA path, counted the same way: the PCA branch, the graph, the planted
   labels among the neighbours, and σ and the connectivities against the
   plain-PyTorch path from the same representation;
6. kernels: T7/T8 on the RNA counts, T5 on the RNA scores (float32 and
   approx, euclidean and cosine, k+1 = 20 and 201) with the approx recall
   against float32, and T6 on T5's output, against their plain versions;
7. prot path, counted the same way: T12 in ``clr``, the PCA against the
   same iteration in float64 and the exact spectrum, the graph; then T12
   against its plain version on the protein counts;
8. WNN path over {rna, atac, prot}, counted from ``pp.neighbors(mdata)``
   alone: the launches of T5, T6 and T9-T11, the fused graph and the
   modality weights; σ, θ, the weights and the graph against the
   plain-PyTorch WNN from the same per-modality graphs; the planted labels
   among the fused neighbours;
9. kernels: T9-T11 against their plain versions on the arguments the WNN
   path gave them;
10. Leiden: the ARI of the clusters against the planted labels;
11. UMAP path, counted from ``tl.umap(mdata)`` alone: T13 every epoch and
    T2 in the spectral init; one T13 epoch against its plain version from
    the spectral layout with shared negatives; the 200-epoch layouts of the
    kernel and of the plain version from the same start, held by the
    planted-label share of each cell's 15 nearest 2-D neighbours (T5 at
    d = 2), and that share's spread over 10 seeds on the same graph and
    over 5 starts jittered by 1e-4 at the checked seed;
12. times: the warm wall of each path with its stage split, each path's
    device busy share under the profiler, and the plain-PyTorch paths once;
13. ``[ivf]``, counted from ``pp.neighbors`` at 1M alone: T15 nine times,
    T14, T6, no T5; the table (self first, no −1, ascending), its recall
    over all rows against exact T5 at the same size with both times, and
    against the plain search of the same probe lists on the first 64 work
    items (what the data allows against what the port loses); the graph and
    its tag; the native union against the scipy formula with both times
    (also at 100k, after phase 5); ``ivf_knn`` again at k = 200 on the
    cached partition; the stage split;
14. ``[umap1m]``, counted from ``tl.umap`` alone: T16 thirteen times, T13
    per epoch, no T2; the layout's planted-label share against the graph's
    own; the membership seed against the exact seed by their Rayleigh
    quotients under the graph's normalised operator (a seed of noise
    fails), with both times; the stage split;
15. kernels: T14 (k+1 = 20 and 201, the first 64 work items of the 1M
    layout), T15 (all rows) and T16 (one application) against their plain
    versions;
16. repairs (after phase 12): T13 at 12 components (the kernel that takes
    the number at run time) against plain on the WNN graph; ``[wnn-wide]``,
    ``pp.neighbors(mdata, n_multineighbors=300)`` over neighbour lists 300
    wide on the first 2,000 cells, counted alone: T9's variant that keeps a
    cell's candidates in global memory, twice, and T5's long-list variant
    for the candidates, twice; T9's variant against plain at kk = 256,
    d = 50; then phases 23 (its 100k half) and 24;
17. ``[mofa-e2e]``, counted from ``fit_mofa`` alone: the launches of T17-T20
    by the formula (per sweep T17 K·M + M, T18 and T19 K·M, T20 2·K·M), the
    wall and the stage split, and the e2e's gate: the label-probe R² of Z
    above max(0.2, 0.8 × that of the first 15 PCA components);
18. kernels: T17-T20 against their plain versions at 10,000 × 3000 (unmasked
    and masked) and 50,000 × 256, each with its bound and, where one PyTorch
    call computes the same, that call's time;
19. ``[mofa]``, counted the same way: sweeps per second, the stage split, peak
    memory; the canonical correlations of Z with the planted factors (> 0.9);
    two fits bit for bit; one sweep through the kernels against the plain
    versions from the same state (every leaf within 1e-4 of its largest
    entry); the ELBO of every sweep (never falling by more than 1e-5); the
    plain path's time;
20. ``[mofa-1m]``, counted the same way: the wall, the time per
    iteration, peak memory, and the canonical correlations (> 0.9);
21. ``[dsb]`` at 10,000 + 50,000 and at 100,000 + 500,000 droplets (last),
    each counted alone from ``clr`` and ``dsb``: T12, T7 and T21 once each;
    every cell kept; the warm walls with the stage split (``dsb/droplets``,
    ``dsb/standardize``, ``dsb/gmm``, ``dsb/ols``, ``dsb/clip``,
    ``dsb/download``), the busy share and peak memory; the whole output
    against the plain path (T7 and T21 plain) from the same uniforms; the
    planted signal columns above the ambient ones; the per-cell median
    offset smaller than without denoising; at 10,000 the isotype-control
    and clipping branches once (the warning, np.clip at np.quantile);
22. ``[kernel] gmm_background_means``: T21 against its plain version on the
    standardised cells of phase 21 (10,000 and 100,000 × 140) and at
    10,000 × 300: the same fit and iterations on ≥ 99.9% of cells, the
    means within 1e-4 there, both times, the bound from the iterations run
    (operations at the float32 and special-function rates, bytes);
23. ``[knn-wide]``: ``pp.neighbors(n_neighbors=301)`` on the 100k RNA scores
    (after phase 16) and ``ivf_knn(k=300)`` on the cached 1M partition
    (after phase 15), each counted alone: the long-list variants of T5 and
    T14 (the heap in the outputs), each against plain (phase 15 holds T14
    at k+1 = 301 on the first 64 work items);
24. ``[umap-asym]`` (after phase 23's first half): ``ops.umap.umap_embed`` of
    the 100k RNA path's directed membership graph (T6's table before the
    union), 200 epochs, counted alone: T22 every epoch and no T13; one T22
    epoch against plain from the spectral layout with shared negatives; the
    layout's planted-label share within 0.02 of the same run through T22's
    plain version and ≥ 0.8 × that of ``tl.umap``'s layout (T13) of the
    graph's union at the same seed, and its ratio to the graph's own share;
25. ``[mofa-lik-svi]`` (after phase 17), counted alone: the e2e's SVI with the
    ATAC view binarised and fitted as bernoulli: T17-T20 by the formula and
    T23 once an iteration, the wall, the label-probe gate of phase 17;
26. ``[kernel] mofa_bound_refresh`` (after phase 19): T23 against its plain
    version at 10,000 x 3000 (bernoulli, poisson) and 50,000 x 256, within
    1e-5 of 1 + F² + z2·SWWᵀ, the same bits twice;
27. ``[mofa-lik]``, bernoulli and then poisson, each counted alone: 2 + 50
    sweeps, sweeps per second, the stage split, T23 once a sweep, the ELBO
    finite, two fits bit for bit, canonical correlations > 0.9, one sweep
    against the plain path within 1e-4;
28. ``[mofa-ssz]``, counted alone: spike-slab factors at the same size on a
    planted Z with half its entries zero, the cells in 50 groups; Z_S < 0.5
    on a nonzero share after ``ssz_on``, canonical correlations > 0.9;
29. ``[kernel] gp_rbf_kernel / gp_kg_grad``: T24 at the dense gp_K (10 x
    3000²) and the sparse K_nm (100,000 x 1,000), T25 at dK 10 x 3000², each
    against its plain version;
30. ``[mefisto]``, three fits each counted alone (T24/T25 by ``gp_launches``):
    the dense GP, 100 sweeps with the hyperparameters refreshed every 25
    (the planted trajectories' canonical correlations > 0.9), then
    ``model_groups`` on groups of planted correlation −0.8 (the learned Kg's
    sign on every active factor), then warping of a clock shifted by 0.1
    (the median error of the warped covariate within a grid step);
31. ``[mefisto-sparse]``, counted alone: the sparse GP at 100,000 cells, 50
    sweeps under the stage timers, the wall, peak memory, the split of T24
    against the Cholesky factors and solves, canonical correlations > 0.9;
32. ``[de]`` (after phase 25): ``tl.rank_genes_groups`` over the 20 planted
    labels on the normalised RNA, 100,000 × 20,000: t-test (T3 on the CSR),
    wilcoxon (X dense on the card, sorted in blocks of 2684 columns, T26)
    and logreg (200 Adam steps: T27, T28 and the products), then wilcoxon on
    the TF-IDF ATAC, 100,000 × 25,000, each counted alone; the walls, the
    stage split, peak memory, and every group's 50 best-ranked features
    holding at least 80% of the features planted in it;
33. ``[kernel] wilcoxon_rank_sums / logreg_softmax_grad / adam_update``: T26
    on one sorted column block (the sort's time beside it), T27 and T28 on
    one logreg step, against their plain versions (T28 also against
    torch's fused Adam);
34. ``[snf]``: the first 10,000 cells of the e2e's three modalities through
    their own paths to neighbors(20), then ``tl.snf`` (20 neighbours, 20
    iterations) counted alone: T29 and T31 per modality, T30 per modality
    and iteration and once more; the split of the kernels against the
    products, peak memory; the fused graph against the same call through
    the plain versions, which take the kernels' dominant set in the rows
    where theirs differs, each differing entry within 1e-5 of its row's
    threshold (exp_snf_ties.py), its planted-label share (≥ 0.87; the JAX package's
    tl.snf reads the same on these graphs: exp_snf_witness.py), Leiden on
    it (ARI ≥ 0.85); T29-T31 and one diffusion iteration against their
    plain versions;
35. ``[ica]`` (after phase 34): ``tl.ica`` on the e2e RNA's ``X_pca``
    (100,000 × 50, ``n_components=None``) counted alone: T32 once per sweep,
    200; the wall, the stage split, cov(S) within 1e-3 of I; then on 50
    planted Laplace sources mixed by a 50 × 50 Gaussian matrix: every source
    matched by a recovered one with |corr| ≥ 0.95, and the whole run against
    the same call through T32's plain version from the same W0;
36. ``[scopen]``: ``atac.pp.scopen`` on the e2e's ATAC counts (100,000 ×
    25,000, 30 factors, 500 iterations) counted alone: T2's split variant
    and T33 twice per iteration, 1000 each, T7 and T8 once; the wall, the stage split, peak
    memory; ``X_scopen``'s label-probe R² at least 0.33, beside that of the
    same ATAC's ``X_lsi`` (the algorithm reads about half of X_lsi's:
    exp_scopen_witness.py); the imputed X in [0, 1]. Then the same
    fit driven again in chunks of 100 iterations from the same operands and
    starts: the objective at the start and after each chunk never up by more
    than 1e-5 relative, and the chunks end on ``atac.pp.scopen``'s factors bit
    for bit; the same fit through the plain versions, its R² within 0.01;
    one iteration through T33 against the plain update from the fitted state
    (rtol 1e-5); T2's split variant at the loop's two shapes
    against its plain version (the sums in float64);
37. ``[dense]``: ``ops.dense.tfidf_dense`` on the e2e's ATAC counts dense on
    the card (100,000 × 25,000, default flags) and ``l2norm_dense`` of the
    RNA's ``X_pca`` and of that TF-IDF, counted alone (T34 1, T35 2); then
    ``[kernel] ica_contrast / nmf_update / tfidf_dense / l2norm_dense``: each
    against its plain version at those shapes (T34 also at 1,000 × 25,000
    with zero rows and columns under every combination of the three log
    flags and ``scale_factor`` ∈ {None, 1, 1e4}).
38. ``[motifs]`` (after phase 37): a 60 Mb genome written from the seed
    (three chromosomes, runs of N, soft-masked stretches) as a FASTA, 100,000
    non-overlapping peaks of 500 bp named ``chrN:start-end`` in a holder's
    ``var_names``, the consensus of 20 JASPAR motifs of width ≥ 8 (each
    clearing its p = 1e-4 threshold) planted in 50 peaks each; then
    ``atac.tl.get_sequences`` → ``atac.tl.scan_sequences`` over all 746
    motifs at p = 1e-4, counted alone (T36 twice: count, write): the wall,
    the stages, peak memory, the hits against 1e-4 × windows, every plant
    found at its offset, every hit at or above its threshold. Then
    ``[kernel] pwm_scan`` on all 100,000 peaks: the path's frame equal row
    for row to one call of T36; that call's hits against its plain version's
    (run 10,000 peaks at a time), the same in the same order once the
    windows within 1e-3 of a threshold on either side are set aside (and
    counted); its scores mode against ``F.conv1d`` (TF32 off) width by width
    within 1e-4, -inf in the same places; its time at full size, and on
    10,000 peaks beside its plain version and ``F.conv1d``'s scores alone.
39. ``[fragments]`` (after phase 38): the fragment QC path above, counted
    alone (T37 once, in ``tss_enrichment``): each call's wall, the stages
    (``fragments/write(host)`` apart, as set-up), peak memory; T37's
    matrix equal to its plain version's at the full 100,000 × 2001, element
    for element; ``obs["tss_score"]`` and the returned matrix equal bit for
    bit to the reference's numpy score of that plain matrix; a numpy brute
    force (coverage added fragment by fragment) over 500 sampled cells and
    all 2,000 sampled TSS equal to both; the good cells' median score within
    [0.8, 1.25] of the planted enrichment (the score of the expected pileup);
    ``nucleosome_signal`` equal to a numpy bincount over the records written;
    ``count_fragments_features`` equal to a brute-force count on 50 genes;
    the ``atac`` modality and the MuData's masks after ``filter_obs`` and
    ``update()`` equal to the mask; then ``[kernel] interval_pileup``: T37
    at the path's call beside its plain version, with its bound.

The last three lines are a JSON object of the kernels (``launches`` adds
up the main paths' counts, each read from its own run with the counters
set to 0 just before it, and ``launches_by_path`` gives each;
``gather_launches`` counts the gather rSVD side run, which is no part of
``launches``; ``bound_ms`` is the least time the card could take for the
kernel's measured call, ``library_ms`` the time of one PyTorch call that
computes the same function, where there is one), the card's name and power
limit as ``nvidia-smi`` gives them, and ``{"ok": true, "device": ...}``.
Without a CUDA device it prints no result and exits 1.
"""

from __future__ import annotations

import ctypes.util
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch
from scipy import sparse as sp

N_CELLS, N_PEAKS, NNZ_PER_CELL = 100_000, 25_000, 250
N_GENES, NNZ_PER_RNA_CELL, N_CLUSTERS = 20_000, 100, 20
NNZ_PER_ATAC_CELL = 150  # bench_e2e.py's ATAC modality, N_PEAKS wide
N_PROT, PROT_COMPS = 120, 30  # bench_e2e.py's D_PROT and its prot pca(30)
N_MULTI = 200  # WNN's n_multineighbors (its default)
N_EPOCHS = 200  # tl.umap's epochs above 10,000 cells
K, N_ITER, SEED = 50, 7, 0
L = K + 10
N_NEIGHBORS = 20
SPARSE_SRC = "muon_tpu_torch/csrc/sparse_kernels.cu"
KNN_SRC = "muon_tpu_torch/csrc/knn_kernels.cu"
WNN_SRC = "muon_tpu_torch/csrc/wnn_kernels.cu"
DENSE_SRC = "muon_tpu_torch/csrc/dense_kernels.cu"
UMAP_SRC = "muon_tpu_torch/csrc/umap_kernels.cu"
IVF_SRC = "muon_tpu_torch/csrc/ivf_kernels.cu"
MOFA_SRC = "muon_tpu_torch/csrc/mofa_kernels.cu"
GMM_SRC = "muon_tpu_torch/csrc/gmm_kernels.cu"
GP_SRC = "muon_tpu_torch/csrc/gp_kernels.cu"
DE_SRC = "muon_tpu_torch/csrc/de_kernels.cu"
SNF_SRC = "muon_tpu_torch/csrc/snf_kernels.cu"
DECOMP_SRC = "muon_tpu_torch/csrc/decomp_kernels.cu"
MOTIF_SRC = "muon_tpu_torch/csrc/motif_kernels.cu"
PILEUP_SRC = "muon_tpu_torch/csrc/pileup_kernels.cu"
# MOFA: bench.py's mode `mofa` (10,000 cells, views of 2000 and 3000 features,
# 50 full-batch sweeps after 2), the e2e's stage (two 256-column views, SVI,
# 100 iterations of 50,000 cells) at 100,000 and at 1,000,000 cells; K = 15
MOFA_K, MOFA_N, MOFA_DS, MOFA_SWEEPS, MOFA_WARM = 15, 10_000, (2000, 3000), 50, 2
MOFA_COLS, MOFA_ITERS, MOFA_BATCH = 256, 100, 50_000
# MOFA's bound-based views: the scales of the planted logits and log-rates
# (bernoulli and poisson views of [mofa-lik]); the share of a planted Z set
# to zero for [mofa-ssz]
LIK_LOGIT_SCALE, LIK_RATE_SCALE, SSZ_ZERO_SHARE = 0.5, 0.3, 0.5
# [mofa-ssz]'s cells in 50 groups (samples) of 200: θ_z is learned per group
# and reaches about 1 − 1/N_g in the dense sweeps before ssz_on, and a slab
# probability falls below ½ only where ½ ln(p/α) passes about ln N_g; in one
# group of 10,000 cells no cell's does
SSZ_GROUPS = 50
# MEFISTO: 3,000 cells (about a Visium section's spots) in 2 groups on a
# time grid of 150 points, views of 500 and 800, K = 10, 6 planted smooth
# trajectories, 100 sweeps, the hyperparameters refreshed every 25 sweeps
# from sweep 20 (the reference's defaults); the model_groups fit's planted
# group correlation, the warping fit's clock shift and warping cadence; the
# sparse GP at 100,000 cells, 50 sweeps
MEF_N, MEF_TIMES, MEF_DS, MEF_K, MEF_PLANTED = 3_000, 150, (500, 800), 10, 6
MEF_SWEEPS, MEF_OPT, MEF_START = 100, 25, 20
MEF_RHO, MEF_SHIFT, MEF_WARP_FREQ = -0.8, 0.1, 20
SGP_N, SGP_TIMES, SGP_SWEEPS = 100_000, 1000, 50
# the width of the neighbour lists that drive T9's global-memory variant: 300
# through pp.neighbors (and WNN's candidates), 256 for the kernel against plain
WIDE_KK, WIDE_KK_KERNEL, WIDE_CELLS = 300, 256, 2_000
# [knn-wide]: k of pp.neighbors at 100k and of ivf_knn at 1M, lists of 301
WIDE_K = 300
# DSB: bench.py's mode `dsb` (10,000 cells, 50,000 empty droplets, 140
# proteins) and a pooled 10x run at the e2e's cell count; the bench's call
CITE_PROT = 140
DSB_SIZES = ((10_000, 50_000), (100_000, 500_000))
DSB_KW = dict(empty_counts_range=(0.3, 2.5), cell_counts_range=(2.8, 4.5), random_state=1)
# the 1M-cell path: rows, columns and planted clusters of its representation,
# the work items T14 is held to its plain version on, the seed check's sample
N_BIG, D_BIG, BIG_CLUSTERS, IVF_ITEMS, SEED_SAMPLE = 1_000_000, 50, 40, 64, 20_000
# kernel -> (source, the TPU program it replaces)
KERNEL_INFO = {
    "tfidf_values": (SPARSE_SRC, "muon_tpu/ops/sparse.py:790"),     # _tfidf_fn
    "csr_spmm_f32": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),     # _spmm_fn
    "csr_spmm_split": (SPARSE_SRC, "muon_tpu/ops/nmf.py:27"),       # _nmf_fn's products
    "csr_spmm_bf16": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),
    "csr_spmm_t_f32": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),   # transpose=True
    "csr_spmm_t_bf16": (SPARSE_SRC, "muon_tpu/ops/sparse.py:590"),
    "csr_gram_matmul": (SPARSE_SRC, "muon_tpu/ops/linalg.py:109"),  # _rsvd_blocks_fn
    "csr_row_sums": (SPARSE_SRC, "muon_tpu/ops/sparse.py:546"),     # _row_sums_fn
    "csr_scale_rows": (SPARSE_SRC, "muon_tpu/ops/sparse.py:830"),   # _scale_rows_fn
    "knn_topk": (KNN_SRC, "muon_tpu/ops/knn.py:58"),                # _knn_fn + _topk2
    "smooth_knn_membership": (KNN_SRC, "muon_tpu/ops/fuzzy.py:32"),  # + _membership_fn
    "wnn_bandwidth": (WNN_SRC, "muon_tpu/ops/wnn.py:339"),          # _bandwidth_fn
    "wnn_theta": (WNN_SRC, "muon_tpu/ops/wnn.py:394"),              # _theta_fn
    "wnn_fusion_scores": (WNN_SRC, "muon_tpu/ops/wnn.py:470"),      # _fusion_all_fn
    "clr_dense": (DENSE_SRC, "muon_tpu/ops/dense.py:64"),           # _clr_dense_fn
    "umap_epoch": (UMAP_SRC, "muon_tpu/ops/umap.py:289"),           # _optimize_layout_bucketed_fn
    "ivf_search": (IVF_SRC, "muon_tpu/ops/ivf.py:126"),             # _search_fn
    "kmeans_assign": (IVF_SRC, "muon_tpu/ops/ivf.py:83"),           # _kmeans_fn's assign
    "membership_matvec": (UMAP_SRC, "muon_tpu/ops/umap.py:75"),     # _spectral_membership_fn
    "wnn_bandwidth_global": (WNN_SRC, "muon_tpu/ops/wnn.py:339"),   # _bandwidth_fn, wide lists
    # the loop bodies of _make_step (:94) and _make_svi_step (:811)
    "mofa_col_dot": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),       # zk @ E, (E*E).sum(0)
    "mofa_w_posterior": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),   # w_body's posterior
    "mofa_row_dot": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),       # Es[m] @ tsw, B @ tSWW
    "mofa_rank1_update": (MOFA_SRC, "muon_tpu/models/mofa.py:94"),  # E + zk (x) delta
    "knn_topk_global": (KNN_SRC, "muon_tpu/ops/knn.py:58"),         # lists longer than 256
    "ivf_search_global": (IVF_SRC, "muon_tpu/ops/ivf.py:126"),      # lists longer than 256
    "gmm_background_means": (GMM_SRC, "muon_tpu/ops/gmm.py:101"),   # + _em_1d (:32)
    "umap_epoch_asym": (UMAP_SRC, "muon_tpu/ops/umap.py:407"),      # _optimize_fn, asymmetric
    # the bound refresh of _make_step (:136-170) and _make_svi_step (:860-893)
    "mofa_bound_refresh": (MOFA_SRC, "muon_tpu/models/mofa.py:136"),
    "gp_rbf_kernel": (GP_SRC, "muon_tpu/models/mofa.py:604"),       # _rbf_kernel, _gp_kmat_fn
    "gp_kg_grad": (GP_SRC, "muon_tpu/models/mofa.py:636"),          # grad of _gp_group_fn
    "wilcoxon_rank_sums": (DE_SRC, "muon_tpu/_core/tools_de.py:175"),   # ranksum
    "logreg_softmax_grad": (DE_SRC, "muon_tpu/_core/tools_de.py:248"),  # fit: dlogits
    "adam_update": (DE_SRC, "muon_tpu/_core/tools_de.py:248"),          # fit: optax.adam
    "snf_affinity": (SNF_SRC, "muon_tpu/_core/tools_graph.py:78"),      # _affinity_matrix
    "snf_normalize": (SNF_SRC, "muon_tpu/_core/tools_graph.py:35"),     # normalize
    "snf_dominate_set": (SNF_SRC, "muon_tpu/_core/tools_graph.py:35"),  # dominateset
    "ica_contrast": (DECOMP_SRC, "muon_tpu/ops/ica.py:24"),         # _fastica_fn's body
    "nmf_update": (DECOMP_SRC, "muon_tpu/ops/nmf.py:27"),           # _nmf_fn's updates, Grams
    "tfidf_dense": (DENSE_SRC, "muon_tpu/ops/dense.py:19"),         # _tfidf_dense_fn
    "l2norm_dense": (DENSE_SRC, "muon_tpu/ops/dense.py:48"),        # _l2norm_fn
    "pwm_scan": (MOTIF_SRC, "muon_tpu/ops/pwm.py:114"),             # _conv_fn + find_hits
    "interval_pileup": (PILEUP_SRC, "muon_tpu/ops/pileup.py:29"),   # _pileup_fn
}
# what each path launches: the ATAC path (auto takes the XtX path for lsi,
# neighbors the approx kNN), the RNA path, and the gather rSVD side run
ATAC_PATH = ("tfidf_values", "csr_spmm_f32", "csr_gram_matmul", "knn_topk",
             "smooth_knn_membership")
RNA_PATH = ("csr_row_sums", "csr_scale_rows", "csr_gram_matmul", "csr_spmm_f32",
            "knn_topk", "smooth_knn_membership")
GATHER_PATH = ("csr_spmm_bf16", "csr_spmm_t_bf16", "csr_spmm_t_f32")
PROT_PATH = {"clr_dense": 1, "knn_topk": 1, "smooth_knn_membership": 1}
# WNN of {rna, atac, prot}: T9 per modality, T10 per ordered pair (self
# pairs included), T11 once, T5 per modality for the 200-wide candidate
# pool, T6 once for the fused graph
WNN_PATH = {"wnn_bandwidth": 3, "wnn_theta": 9, "wnn_fusion_scores": 1, "knn_topk": 3,
            "smooth_knn_membership": 1}
# tl.umap: T13 per epoch; the spectral init's symmetric gather rSVD (k = 3,
# 4 iterations): T2 in bf16 once and twice per iteration, then once in f32
UMAP_PATH = {"umap_epoch": N_EPOCHS, "csr_spmm_bf16": 9, "csr_spmm_f32": 1}
# pp.neighbors above 200,000 rows: 8 Lloyd steps and a last assignment (T15),
# the search (T14, at least once), T6, and no brute force (T5)
IVF_PATH = {"kmeans_assign": 9, "smooth_knn_membership": 1, "knn_topk": 0}
# tl.umap above 8M edges: six S² steps and the Rayleigh-Ritz product (T16),
# T13 per epoch, and nothing of the exact seed's rSVD (T2)
UMAP_BIG_PATH = {"membership_matvec": 13, "umap_epoch": N_EPOCHS, "csr_spmm_bf16": 0,
                 "csr_spmm_f32": 0}
# WNN over neighbour lists 300 wide with 300 candidates per modality: T9's
# global-memory variant and T5's long-list variant per modality
WNN_WIDE_PATH = {"wnn_bandwidth_global": 2, "wnn_bandwidth": 0, "wnn_theta": 4,
                 "wnn_fusion_scores": 1, "knn_topk_global": 2, "knn_topk": 0}
# pp.neighbors(n_neighbors=301) at 100k, then ivf_knn(k=300) at 1M on the
# cached partition: the long-list variants of T5 and T14, once each
KNN_WIDE_PATH = {"knn_topk_global": 1, "knn_topk": 0, "smooth_knn_membership": 1,
                 "ivf_search_global": 1, "ivf_search": 0, "kmeans_assign": 0}
# umap_embed of the directed RNA membership graph: T22 per epoch, no T13
UMAP_ASYM_PATH = {"umap_epoch_asym": N_EPOCHS, "umap_epoch": 0}
# bench.py's dsb path: clr of the proteins (T12), then dsb: the RNA row sums
# of the droplet split (T7) and the background fit (T21), once each
DSB_PATH = {"clr_dense": 1, "csr_row_sums": 1, "gmm_background_means": 1}
# [de]: tl.rank_genes_groups on the e2e's normalised RNA (and its TF-IDF ATAC
# for wilcoxon): the moments through T3 twice; wilcoxon T26 once per column
# block of 2684 (RANK_BLOCK_BYTES / 16 bytes a cell at 100,000 cells); logreg
# T27 and T28 once per Adam step. Each group's 50 best-ranked features must
# hold at least 80% of the features planted (boosted) in that group
DE_TOP, DE_PLANTED, LOGREG_STEPS, DE_BLOCK = 50, 0.8, 200, 2684
DE_MOMENTS = {"csr_spmm_t_f32": 2}
DE_PATHS = {
    "t-test": {**DE_MOMENTS, "wilcoxon_rank_sums": 0, "logreg_softmax_grad": 0},
    "wilcoxon": {**DE_MOMENTS, "wilcoxon_rank_sums": -(-N_GENES // DE_BLOCK)},
    "logreg": {**DE_MOMENTS, "logreg_softmax_grad": LOGREG_STEPS, "adam_update": LOGREG_STEPS},
    "wilcoxon ATAC": {**DE_MOMENTS, "wilcoxon_rank_sums": -(-N_PEAKS // DE_BLOCK)},
}
# [snf]: the first 10,000 cells of the e2e's three modalities (the size of the
# 10x PBMC 10k multiome), tl.snf's defaults: T29 and T31 once per modality,
# T30 once per modality, then once per modality and iteration, then once
SNF_CELLS, SNF_K, SNF_ITERS, SNF_MODS = 10_000, 20, 20, 3
# the fused graph's planted-label share reads 0.884 at SNF_CELLS
SNF_SHARE = 0.87
# the kernels' and the plain versions' dominant sets may differ only this close
# (relative) to a row's threshold: T29's and T30's tolerance
SNF_NEAR = 1e-5
SNF_PATH = {"snf_affinity": SNF_MODS, "snf_dominate_set": SNF_MODS,
            "snf_normalize": SNF_MODS * (SNF_ITERS + 1) + 1}
# [ica]: fastica's 200 sweeps, run in full, T32 once each; 50 planted sources
ICA_ITERS, ICA_SOURCES = 200, 50
ICA_PATH = {"ica_contrast": ICA_ITERS}
# [scopen]: 30 factors, 500 iterations, the objective every 100; each
# iteration forms X^T W and X H^T by T2's split variant and updates H and
# then W by T33;
# scopen_operands scales the binarised cells by T7's counts through T8.
# X_scopen's label-probe R2 is the algorithm's, about half of X_lsi's
# (0.8147), and moves with the start: the port from its own starts of seeds
# 0, 1, 2 reads 0.3705, 0.3971, 0.3475 at 100,000 cells, each run twice
# alike (exp_scopen_witness.py port). On the first 10,000 cells the JAX
# package and the port from the same starts read the same R2 to 1e-4 though
# their factors part after about 200 iterations (exp_scopen_witness.py
# reference). So the gate is R2 >= 0.33, the lowest start's reading less 5%,
# and R2 within SCOPEN_R2_PLAIN of the same fit through the plain versions
# (a fault costing a tenth of R2 moves it by 0.037)
SCOPEN_K, SCOPEN_ITERS, SCOPEN_EVERY, SCOPEN_R2, SCOPEN_R2_PLAIN = 30, 500, 100, 0.33, 0.01
SCOPEN_PATH = {"nmf_update": 2 * SCOPEN_ITERS, "csr_spmm_split": 2 * SCOPEN_ITERS,
               "csr_row_sums": 1, "csr_scale_rows": 1}
# [dense]: tfidf_dense of the dense ATAC, l2norm_dense of X_pca and of that TF-IDF
DENSE_PATH = {"tfidf_dense": 1, "l2norm_dense": 2}
# [motifs]: 100,000 peaks of 500 bp from a 60 Mb genome written from the seed
# (three chromosomes, runs of N, soft-masked stretches), all 746 JASPAR
# motifs at p = 1e-4; the consensus of MOTIF_PLANTED motifs of width >= 8
# planted in MOTIF_PLANT_EACH peaks each; T36 counts, then writes (one chunk
# of motifs: 8,983 log-odds rows fit one block's shared memory)
MOTIF_PEAKS, PEAK_BP, MOTIF_P = 100_000, 500, 1e-4
MOTIF_CHROMS = (("chr1", 25_000_000), ("chr2", 20_000_000), ("chr3", 15_000_000))
MOTIF_PLANTED, MOTIF_PLANT_EACH = 20, 50
MOTIF_CHUNK = 10_000  # peaks a piece when all of them are held to plain
MOTIF_TIMED = 10_000  # peaks timed against plain and F.conv1d
MOTIF_NEAR = 1e-3  # windows this close to their threshold are set aside and counted
MOTIF_PATH = {"pwm_scan": 2}
# [fragments]: 100,000 cells, 2,200 genes on three chromosomes (gene bodies
# of 5-30 kb, gaps of 3-20 kb: no TSS window reaches another gene), per cell
# Poisson(200) fragments around TSS (in good cells FRAG_CENTRED of them
# inside the centre, the rest over the whole window; in FRAG_BAD of the
# cells none in the centre) and Poisson(25) over gene bodies past their TSS
# window (cut from 100: the host engine reads about a microsecond a record on
# the card's host, and 3e7 records grew the smoke by about 160 s; the TSS
# windows are not cut); FRAG_UNKNOWN of the records carry a barcode of no
# cell. The path: nucleosome_signal, tss_enrichment of 2,000 sampled TSS (T37
# once), filter_obs at tss_score >= 2, count_fragments_features
FRAG_GENES, FRAG_TSS, FRAG_UP, FRAG_DOWN = 2_200, 2_000, 1_000, 1_000
FRAG_CHROMS = ("chr1", "chr2", "chr3")
FRAG_TSS_PER_CELL, FRAG_BODY_PER_CELL = 200, 25
FRAG_CENTRED, FRAG_CENTRE_HALF, FRAG_BAD, FRAG_UNKNOWN = 0.7, 500, 0.1, 0.05
# the nucleosome ladder: [lo, hi) lengths and weights (free, mono-, di-)
FRAG_LADDER = ((40, 147, 0.5), (147, 294, 0.35), (294, 500, 0.15))
FRAG_MIN_SCORE = 2.0
FRAG_BRUTE_CELLS, FRAG_BRUTE_GENES = 500, 50
# the good cells' median score over the planted enrichment: a good cell has
# about 10 fragments in its flanks, so its score scatters by about a third
FRAG_BAND = (0.8, 1.25)
FRAG_PATH = {"interval_pileup": 1}


def mofa_launches(sweeps: int, n_views: int = 2, K: int = MOFA_K) -> dict:
    """What ``sweeps`` MOFA sweeps (full-batch or SVI) launch: per sweep T17
    K·M + M (one per factor and view, and Σ E² per view for τ), T18 and T19
    K·M, T20 2·K·M."""
    km = K * n_views
    return {"mofa_col_dot": sweeps * (km + n_views), "mofa_w_posterior": sweeps * km,
            "mofa_row_dot": sweeps * km, "mofa_rank1_update": sweeps * 2 * km}


# the card's published peaks (H100 SXM: NVIDIA's data sheet, dense, at
# 700 W): device memory, float32 outside the tensor cores, and bfloat16 in
# them. A kernel's bound is the larger of its bytes (each input read once,
# each output written once) over the memory rate and its operations over
# the peak of their type: products of bfloat16 operands at the bfloat16
# rate, everything else at the float32 rate
HBM_BYTES_PER_S, F32_OPS_PER_S, BF16_OPS_PER_S = 3.35e12, 67e12, 989e12
# the special-function unit (exp, log): 16 results per clock per SM (the CUDA
# programming guide's throughput table, compute capability 9.0), 132 SMs at
# the 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9


class Holder:
    """The least AnnData-like object the port's tools take."""

    def __init__(self, X):
        self.X, self.obsm, self.varm, self.uns, self.obsp, self.layers = X, {}, {}, {}, {}, {}


class MuHolder:
    """The least MuData-like object WNN takes: modalities over the same
    cells, in the same order (obsmap is 1-based); for dsb also slicing by
    the obs names of its modalities (each an ``ObsHolder``) and a copy."""

    def __init__(self, mods, n: int = N_CELLS):
        self.mod, self.n_obs = mods, n
        self.obsmap = {k: np.arange(1, n + 1) for k in mods}
        self.obs, self.obsm, self.obsp, self.uns = {}, {}, {}, {}

    def __getitem__(self, idx):
        """The cells named in ``idx[0]``, in that order, in every modality."""
        names = idx[0] if isinstance(idx, tuple) else idx
        pos = {b: i for i, b in enumerate(next(iter(self.mod.values())).obs_names)}
        rows = np.fromiter((pos[b] for b in names), np.int64, len(names))
        return MuHolder({k: m[rows] for k, m in self.mod.items()}, len(rows))

    def copy(self):
        return MuHolder({k: m.copy() for k, m in self.mod.items()}, self.n_obs)


class ObsHolder:
    """The least AnnData-like object dsb takes: X, obs and var names,
    layers, positional row slicing and a copy."""

    def __init__(self, X, obs_names, var_names=None):
        self.X, self.obs_names, self.layers = X, obs_names, {}
        self.var_names = (np.array([f"p{i}" for i in range(X.shape[1])])
                          if var_names is None else var_names)

    @property
    def shape(self):
        return self.X.shape

    @property
    def n_obs(self):
        return self.X.shape[0]

    def __getitem__(self, idx):
        rows = idx[0] if isinstance(idx, tuple) else idx
        return ObsHolder(self.X[rows], self.obs_names[rows], self.var_names)

    def copy(self):
        return ObsHolder(self.X.copy(), self.obs_names.copy(), self.var_names)


def make_counts(seed: int = 0) -> sp.csr_matrix:
    """Synthetic ATAC counts, the recipe of bench.py::make_counts."""
    rng = np.random.default_rng(seed)
    nnz = N_CELLS * NNZ_PER_CELL
    pop = rng.pareto(1.2, N_PEAKS) + 1.0
    pop /= pop.sum()
    cols = rng.choice(N_PEAKS, size=nnz, p=pop).astype(np.int32)
    rows = np.repeat(np.arange(N_CELLS, dtype=np.int32), NNZ_PER_CELL)
    data = rng.integers(1, 5, size=nnz).astype(np.float32)
    X = sp.coo_matrix((data, (rows, cols)), shape=(N_CELLS, N_PEAKS))
    X.sum_duplicates()
    return X.tocsr()


def make_e2e_counts(seed: int = 0):
    """Clustered RNA and ATAC counts, dense protein counts and their planted
    labels, the recipe of bench_e2e.py::synth at 100,000 cells: labels
    first, then per modality, from the same generator, per-cluster tilted
    Pareto(1.2) feature popularity for the counts, and for the proteins
    planted centres clipped at 0 plus Poisson(3) background; last the masks
    of the features boosted in each cluster (RNA, ATAC)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLUSTERS, N_CELLS)
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=N_CLUSTERS)
    boosts = []  # each modality's (clusters, features) mask of boosted features

    def counts(d, nnz_per):
        pop = rng.pareto(1.2, d) + 1.0
        boost = np.ones((N_CLUSTERS, d))
        for c in range(N_CLUSTERS):
            boost[c, rng.choice(d, size=d // 20, replace=False)] = 8.0
        boosts.append(boost > 1)
        nnz = N_CELLS * nnz_per
        cols = np.empty(nnz, np.int32)
        start = 0
        for c in range(N_CLUSTERS):
            m = sizes[c] * nnz_per
            p = pop * boost[c]
            p /= p.sum()
            cols[start:start + m] = rng.choice(d, size=m, p=p)
            start += m
        rows = np.repeat(order, nnz_per).astype(np.int32)
        data = rng.integers(1, 5, size=nnz).astype(np.float32)
        X = sp.coo_matrix((data, (rows, cols)), shape=(N_CELLS, d))
        X.sum_duplicates()
        return X.tocsr()

    rna = counts(N_GENES, NNZ_PER_RNA_CELL)
    atac = counts(N_PEAKS, NNZ_PER_ATAC_CELL)
    cent = rng.normal(size=(N_CLUSTERS, N_PROT)) * 2.0
    prot = np.maximum(
        cent[labels] + rng.normal(size=(N_CELLS, N_PROT)), 0.0
    ).astype(np.float32) + rng.poisson(3.0, size=(N_CELLS, N_PROT)).astype(np.float32)
    return rna, atac, prot, labels, {"rna": boosts[0], "atac": boosts[1]}


FAILED = []


def check(ok, what: str) -> None:
    """Record a failed check; the run goes on so that one run reads every
    number, and exits non-zero at its end."""
    if not ok:
        FAILED.append(what)
        print(f"[check failed] {what}", flush=True)


def median_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up. A
    spin of about a millisecond is queued before each start event, so the
    device is still busy while the host enqueues ``fn``'s launches, and the
    time is that of the launches, not of the host's gap before them."""
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
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_: float, ops: float, rate: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate, and which it is."""
    by_bytes, by_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def library_ms(fn):
    """The time of one PyTorch call computing the kernel's function, or None
    when that call fails on this installation (printed)."""
    try:
        return median_ms(fn)
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"[library] {str(e).splitlines()[0][:160]}", flush=True)
        return None


def csr_bytes(X) -> int:
    return nbytes(X.data, X.indptr, X.indices)


def torch_csr(X):
    """A DeviceCSR as a torch sparse CSR tensor, for the library calls."""
    return torch.sparse_csr_tensor(X.indptr, X.indices, X.data, size=X.shape)


def importable(name: str) -> bool:
    try:
        __import__(name)
    except ImportError:
        return False
    return True


def phase_device(kernels) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    nvcc = subprocess.run(
        [kernels._nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    print(f"[device] {torch.cuda.get_device_name(0)} | {smi} | "
          f"count={torch.cuda.device_count()} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc='{nvcc}' | "
          + " ".join(f"{m}={importable(m)}" for m in ("triton", "pandas", "h5py"))
          + f" | zlib.h={os.path.exists('/usr/include/zlib.h')} "
          f"libz={ctypes.util.find_library('z')}", flush=True)
    return smi


def phase_build(kernels, native) -> None:
    t0 = time.perf_counter()
    so = kernels.build()
    kernels.library()
    log = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
    regs = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines() if "registers" in ln]
    t1 = time.perf_counter()
    native.load_leiden_lib()
    t2 = time.perf_counter()
    native.load_fragments_lib()
    print(f"[build] {t1 - t0:.1f}s {so.name} | " + "; ".join(regs), flush=True)
    print(f"[build] Leiden engine {t2 - t1:.1f}s "
          f"{native.leiden_library_path().name}", flush=True)
    print(f"[build] fragments engine {time.perf_counter() - t2:.1f}s "
          f"{native.fragments_library_path().name}", flush=True)


def phase_kernels(dsp, dX, cuda) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    results = {}

    def record(name, err, tol_ok, tol, k_fn, p_fn, bnd, lib_fn=None):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        lib = library_ms(lib_fn) if lib_fn is not None else None
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                         "library_ms": lib}
        print(f"[kernel] {name}: max_abs_err={err:.3e} ({tol}) ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 3)}", flush=True)
        check(tol_ok, f"{name} within {tol}")

    out = dsp.tfidf_data(dX)
    torch.cuda.synchronize()
    ref = dsp.tfidf_data_plain(dX)
    diff = (out - ref).abs()
    # per value: tf = x / rs · scale, log1p, · log1p(n / cs), finiteness
    record("tfidf_values", diff.max().item(),
           bool((diff <= 1e-6 + 1e-5 * ref.abs()).all()), "rtol 1e-5 atol 1e-6",
           lambda: dsp.tfidf_data(dX), lambda: dsp.tfidf_data_plain(dX),
           bound(csr_bytes(dX) + nbytes(out), 8 * dX.nnz, F32_OPS_PER_S))

    dT = dX._replace(data=out)  # the TF-IDF matrix the products see on the path
    dA = dT._replace(data=out.abs())
    sT = torch_csr(dT)
    sTt = torch_csr(dsp.from_scipy(sp.csr_matrix(
        (out.cpu().numpy(), dX.indices.cpu().numpy(), dX.indptr.cpu().numpy()),
        shape=dX.shape).T.tocsr(), cuda))
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        V = torch.randn((N_PEAKS, L), generator=gen, device=cuda).to(dtype)
        out = dsp.spmm(dT, V)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_plain(dT, V)).abs()
        tol_ = 1e-5 * dsp.spmm_plain(dA, V.float().abs())
        # the library call only where it computes the same function: an f32 B
        record(f"csr_spmm_{tag}", diff.max().item(), bool((diff <= tol_).all()),
               "1e-5 x |X|.|B|", lambda: dsp.spmm(dT, V), lambda: dsp.spmm_plain(dT, V),
               bound(csr_bytes(dT) + nbytes(V, out), 2 * dT.nnz * L, F32_OPS_PER_S),
               (lambda: torch.sparse.mm(sT, V)) if tag == "f32" else None)

        Y = torch.randn((N_CELLS, L), generator=gen, device=cuda).to(dtype)
        out = dsp.spmm_t(dT, Y)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_t_plain(dT, Y)).abs()
        tol_ = 1e-5 * dsp.spmm_t_plain(dA, Y.float().abs())
        record(f"csr_spmm_t_{tag}", diff.max().item(), bool((diff <= tol_).all()),
               "1e-5 x |X|^T.|B|", lambda: dsp.spmm_t(dT, Y),
               lambda: dsp.spmm_t_plain(dT, Y),
               bound(csr_bytes(dT) + nbytes(Y, out), 2 * dT.nnz * L, F32_OPS_PER_S),
               (lambda: torch.sparse.mm(sTt, Y)) if tag == "f32" else None)

    V = torch.randn((N_PEAKS, L), generator=gen, device=cuda)
    out = dsp.gram_matmul(dT, V)
    torch.cuda.synchronize()
    ref = dsp.gram_matmul_plain(dT, V)
    rel = (torch.linalg.norm(out - ref) / torch.linalg.norm(ref)).item()
    # 1e-4: dropping the bf16 rounding of z or of x_ij reads about 1e-3
    # X·V then Xᵀ·z, both of bfloat16 operands; V read as bfloat16
    record("csr_gram_matmul", (out - ref).abs().max().item(), rel <= 1e-4,
           f"relative Frobenius {rel:.2e} <= 1e-4",
           lambda: dsp.gram_matmul(dT, V), lambda: dsp.gram_matmul_plain(dT, V),
           bound(csr_bytes(dT) + V.numel() * 2 + nbytes(out), 4 * dT.nnz * L,
                 BF16_OPS_PER_S))
    return results


def tfidf_reference(X: sp.csr_matrix) -> np.ndarray:
    """scipy/numpy float64 TF-IDF of the values (log TF x1e4, log IDF)."""
    X64 = X.astype(np.float64)
    rs = np.asarray(X64.sum(axis=1)).ravel()
    cs = np.asarray(X64.sum(axis=0)).ravel()
    row = np.repeat(np.arange(X.shape[0]), np.diff(X.indptr))
    tf = np.log1p(X64.data / rs[row] * 1e4)
    return tf * np.log1p(X.shape[0] / cs[X.indices])


def check_graph(h, labels=None) -> float:
    """Checks of a neighbors result; returns the share of neighbours that
    carry the cell's own planted label (nan without labels)."""
    D, C = h.obsp["distances"], h.obsp["connectivities"]
    n = D.shape[0]
    rows = np.repeat(np.arange(n), np.diff(D.indptr))
    check((np.diff(D.indptr) == N_NEIGHBORS - 1).all(), "19 distances per row")
    check(not (D.indices == rows).any(), "self not among the neighbours")
    check(np.isfinite(D.data).all() and (D.data >= 0).all(), "distances finite, >= 0")
    check((C != C.T).nnz == 0, "connectivities symmetric")
    check(C.data.min() > 0 and C.data.max() <= 1, "connectivities in (0, 1]")
    check(h.uns["neighbors"]["params"]["n_neighbors"] == N_NEIGHBORS, "uns params")
    if labels is None:
        return float("nan")
    return float((labels[rows] == labels[D.indices]).mean())


def phase_atac_path(tac, tpp, dsp, tla, kernels, X, cuda):
    h = Holder(X.copy())
    kernels.reset_launch_counts()
    tac.pp.tfidf(h, device=cuda)
    tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_lsi", device=cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # the side run: the gather rSVD, which lsi takes below 2M nonzeros, on
    # the same matrix; its launches are counted apart from the path's
    kernels.reset_launch_counts()
    _, s_gather, _ = tla.randomized_svd(h.X, k=K, n_iter=N_ITER, seed=SEED,
                                        method="gather", device=cuda)
    torch.cuda.synchronize()
    gather_launches = kernels.launch_counts()
    print(f"[atac] container=Holder launches by tfidf+lsi+neighbors {launches}; "
          f"by the gather rSVD {gather_launches}", flush=True)
    check(tla._blocks_profitable(N_CELLS, N_PEAKS, X.nnz, L), "XtX path chosen by auto")
    for name in ATAC_PATH:
        check(launches[name] > 0, f"the ATAC path launched {name}")
    for name in GATHER_PATH:
        check(gather_launches[name] > 0, f"the gather rSVD launched {name}")

    emb, varm, stdev = h.obsm["X_lsi"], h.varm["LSI"], h.uns["lsi"]["stdev"]
    check(emb.shape == (N_CELLS, K) and varm.shape == (N_PEAKS, K)
          and stdev.shape == (K,), "output shapes")
    check(all(np.isfinite(a).all() for a in (emb, varm, stdev, h.X.data)), "finite")
    # z-scoring is float32 on the host, as in the reference: over 1e5 cells
    # its mean carries float32 rounding, so the statistics are taken in f64
    mean_err = float(np.abs(emb.mean(axis=0, dtype=np.float64)).max())
    std_err = float(np.abs(emb.std(axis=0, dtype=np.float64) - 1).max())
    ref = tfidf_reference(X)
    tfidf_err = float(np.max(np.abs(h.X.data - ref) / np.abs(ref)))
    print(f"[atac] X_lsi {emb.shape} |mean|<={mean_err:.2e} |std-1|<={std_err:.2e}; "
          f"TF-IDF vs scipy max rel {tfidf_err:.2e}", flush=True)
    check(mean_err <= 1e-3 and std_err <= 1e-3, "X_lsi z-scored to 1e-3")
    check(bool(np.all(np.diff(stdev) <= 0)), "stdev non-increasing")
    check(np.allclose(h.X.data, ref, rtol=1e-5, atol=1e-6), "TF-IDF vs scipy rtol 1e-5")

    # singular values, rtol 1e-4: against the plain-torch version of the
    # same path with the same Ω (the atomics sum in another order, which can
    # move a bf16 rounding by one ulp; the card reads about 1e-5)
    s = stdev * np.sqrt(N_CELLS - 1)
    dT = dsp.from_scipy(h.X, cuda)
    om = tla.draw_omega(N_PEAKS, L, SEED, cuda)
    rel = lambda a, b: float(((a - b).abs() / b.abs()).max())  # noqa: E731
    s_plain = tla._rsvd_blocks(dT, K, om, N_ITER, ops=tla.PLAIN_OPS)[1].cpu()
    rel_xtx = rel(torch.from_numpy(s).float(), s_plain)
    rel_gather = rel(s_gather.cpu(), tla._rsvd_gather(dT, K, om, N_ITER, ops=tla.PLAIN_OPS)[1].cpu())
    # the two algorithms against each other: after N_ITER iterations their
    # Ritz values of this flat spectrum still differ by ~3e-3 (left vs right
    # projection of the same subspace), so compare them converged
    s_g30 = tla._rsvd_gather(dT, K, om, 30)[1].cpu()
    s_b30 = tla._rsvd_blocks(dT, K, om, 30)[1].cpu()
    rel_algos = rel(s_g30, s_b30)
    rel_algos_7 = rel(s_gather.cpu(), torch.from_numpy(s).float())
    print(f"[atac] s[0]={s[0]:.4f} s[-1]={s[-1]:.4f}; "
          f"s vs plain, same omega: XtX {rel_xtx:.2e} gather {rel_gather:.2e}; "
          f"gather vs XtX: {rel_algos_7:.2e} at {N_ITER} iterations, "
          f"{rel_algos:.2e} at 30", flush=True)
    check(rel_xtx <= 1e-4, "XtX singular values vs the plain path, rtol 1e-4")
    check(rel_gather <= 1e-4, "gather singular values vs the plain path, rtol 1e-4")
    check(rel_algos <= 1e-3, "gather vs XtX singular values at 30 iterations, rtol 1e-3")
    check_graph(h)
    print(f"[atac] neighbors: distances nnz {h.obsp['distances'].nnz}, "
          f"connectivities nnz {h.obsp['connectivities'].nnz}", flush=True)
    return launches, gather_launches, h


def normalise(dsp, X, cuda, plain=False):
    """The e2e's RNA library-size normalisation (bench_e2e.py:270-278) on
    the device: T7 row sums, inv = 1e4 / max(rs, 1), T8 row scaling,
    log1p; or the same through the kernels' plain versions."""
    from muon_tpu_torch.utils.profiling import stage

    with stage("rna/normalise"):
        dX = dsp.from_scipy(X, cuda)
        rs = (dsp.row_sums_plain if plain else dsp.row_sums)(dX)
        inv = 1e4 / torch.clamp(rs, min=1.0)
        vals = torch.log1p((dsp.scale_rows_data_plain if plain else dsp.scale_rows_data)(dX, inv))
        return dsp.to_scipy_data(X, vals)


def rna_path(dsp, tpp, X, cuda):
    h = Holder(normalise(dsp, X, cuda))
    tpp.pca(h, n_comps=K, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_pca", device=cuda)
    return h


def neighbors_plain(tk, tf, rep, cuda):
    """kNN, σ/ρ/membership, union and distances CSR through the plain
    versions, as single_neighbors runs them at this size (approx kNN)."""
    X = torch.from_numpy(np.ascontiguousarray(rep, dtype=np.float32)).to(cuda)
    op, sq = tk._operand(X, "euclidean", approx=N_CELLS > 20_000)
    idx, dists = tk.knn_topk_plain(op, sq, N_NEIGHBORS - 1, False, True)
    sig, _, vals = tf.smooth_knn_plain(dists)
    idx_np = idx.cpu().numpy()
    conn = tf._fuzzy_union(idx_np, vals.cpu().numpy(), X.shape[0], 1.0)
    d_np = dists.cpu().numpy().astype(np.float64)
    n = X.shape[0]
    dmat = sp.csr_matrix((d_np[:, 1:].reshape(-1), (np.repeat(np.arange(n), N_NEIGHBORS - 1),
                                                    idx_np[:, 1:].reshape(-1))), shape=(n, n))
    return sig, conn, dmat


def rna_plain(dsp, tla, tk, tf, X, cuda):
    """The whole RNA path through the plain versions (the XtX PCA branch
    with the same Ω as pp.pca)."""
    Xn = normalise(dsp, X, cuda, plain=True)
    dN = dsp.from_scipy(Xn, cuda)
    cs = torch.from_numpy(np.asarray(Xn.mean(axis=0)).ravel().astype(np.float32)).to(cuda) * N_CELLS
    U, s, _ = tla._pca_blocks(dN, cs, K, tla.draw_omega(N_GENES, L, SEED, cuda), N_ITER,
                              ops=tla.PLAIN_OPS)
    scores = (U * s).cpu().numpy()
    return scores, s, neighbors_plain(tk, tf, scores, cuda)


def phase_rna_path(dsp, tla, tpp, tk, tf, kernels, X, labels, cuda):
    kernels.reset_launch_counts()
    h = rna_path(dsp, tpp, X, cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    xtx = tla._blocks_profitable(N_CELLS, N_GENES, h.X.nnz, L)
    print(f"[rna] {N_CELLS}x{N_GENES} nnz={X.nnz}; PCA branch "
          f"{'XtX (T4 + T2)' if xtx else 'gather'}; launches by "
          f"normalise+pca+neighbors {launches}", flush=True)
    check(xtx, "the XtX PCA branch chosen at this size")
    for name in RNA_PATH:
        check(launches[name] > 0, f"the RNA path launched {name}")
    check(launches["csr_gram_matmul"] == N_ITER and launches["csr_spmm_f32"] == 1,
          "PCA ran 7 XtX products (T4) and one f32 X.V (T2)")
    check(h.obsm["X_pca"].shape == (N_CELLS, K) and np.isfinite(h.obsm["X_pca"]).all(),
          "X_pca shape, finite")
    purity = check_graph(h, labels)

    # against the plain path from the same representation: σ rtol 1e-4 and
    # the connectivities atol 1e-5 (values in (0, 1]) on the edges both
    # graphs hold. At this size T5 and its plain version give the same
    # indices and distances, so the values differ only by σ's f32 bisection
    # in T6 against torch: an H100 reads σ 1.8e-6 to 2.7e-6 relative and the
    # connectivities 6.6e-7 to 7.8e-7, so 1e-5 leaves 10x room and still
    # catches a graph assembled wrongly (a swapped or dropped edge moves a
    # shared edge's union value by its partner's membership, ~1e-1)
    t0 = time.perf_counter()
    sig_p, conn_p, dmat_p = neighbors_plain(tk, tf, h.obsm["X_pca"], cuda)
    rep = torch.from_numpy(h.obsm["X_pca"]).to(cuda)
    op, sq = tk._operand(rep, "euclidean", approx=N_CELLS > 20_000)
    _, dists = tk.knn_topk(op, sq, N_NEIGHBORS - 1, False, True)
    sig = tf.smooth_knn(dists)[0]
    sig_rel = float(((sig - sig_p).abs() / sig_p).max())
    C, Cp = h.obsp["connectivities"], conn_p
    both = C.multiply(Cp.astype(bool)).tocsr()
    both_p = Cp.multiply(C.astype(bool)).tocsr()
    conn_err = float(np.max(np.abs(both.data - both_p.data)))
    edge_jac = both.nnz / (C.nnz + Cp.nnz - both.nnz)
    D = h.obsp["distances"]
    knn_jac = float(np.mean([
        len(set(D.indices[D.indptr[i]:D.indptr[i + 1]])
            & set(dmat_p.indices[dmat_p.indptr[i]:dmat_p.indptr[i + 1]])) / (N_NEIGHBORS - 1)
        for i in range(0, N_CELLS, 50)]))
    purity_p = float((labels[np.repeat(np.arange(N_CELLS), N_NEIGHBORS - 1)]
                      == labels[dmat_p.indices]).mean())
    print(f"[rna] vs the plain path from the same X_pca ({time.perf_counter() - t0:.1f}s): "
          f"sigma max rel {sig_rel:.2e} (<= 1e-4); connectivities max abs err "
          f"{conn_err:.2e} on shared edges (<= 1e-5), edge Jaccard {edge_jac:.5f}; "
          f"kNN overlap on every 50th cell {knn_jac:.5f}; planted-label share of "
          f"neighbours {purity:.4f} (plain path {purity_p:.4f}; chance 0.05)", flush=True)
    check(sig_rel <= 1e-4, "sigma vs plain rtol 1e-4")
    check(conn_err <= 1e-5, "connectivities vs plain atol 1e-5")
    check(edge_jac >= 0.99 and knn_jac >= 0.99, "graphs vs plain overlap >= 0.99")
    # the bar: 0.55 (11x chance; the plain path reads 0.6147 on an H100 at
    # this seed), and within 0.01 of the plain path's share in this run
    check(purity >= 0.55 and abs(purity - purity_p) <= 0.01, "planted-label share")
    return launches, h


def phase_neighbors_kernels(dsp, tk, tf, X, rep, cuda) -> dict:
    """T7/T8 on the RNA counts, T5 on the RNA scores, T6 on T5's output,
    each against its plain version."""
    results = {}

    def record(name, err, tol_ok, tol, k_fn, p_fn, bnd, extra="", lib_fn=None):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        lib = library_ms(lib_fn) if lib_fn is not None else None
        results.setdefault(name, {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                  **bnd, "library_ms": lib})
        print(f"[kernel] {name}{extra}: max_abs_err={err:.3e} ({tol}) ms={ms:.3f} "
              f"plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 3)}", flush=True)
        check(tol_ok, f"{name}{extra} within {tol}")

    dX = dsp.from_scipy(X, cuda)
    rs = dsp.row_sums(dX)
    torch.cuda.synchronize()
    ref = dsp.row_sums_plain(dX)
    diff = (rs - ref).abs()
    offsets = dX.indptr.long()
    record("csr_row_sums", diff.max().item(), bool((diff <= 1e-5 * ref.abs()).all()),
           "rtol 1e-5", lambda: dsp.row_sums(dX), lambda: dsp.row_sums_plain(dX),
           bound(nbytes(dX.data, dX.indptr, rs), dX.nnz, F32_OPS_PER_S),
           lib_fn=lambda: torch.segment_reduce(dX.data, "sum", offsets=offsets))
    inv = 1e4 / torch.clamp(rs, min=1.0)
    out = dsp.scale_rows_data(dX, inv)
    torch.cuda.synchronize()
    err = (out - dsp.scale_rows_data_plain(dX, inv)).abs().max().item()
    record("csr_scale_rows", err, err == 0, "exact", lambda: dsp.scale_rows_data(dX, inv),
           lambda: dsp.scale_rows_data_plain(dX, inv),
           bound(nbytes(dX.data, dX.indptr, inv, out), dX.nnz, F32_OPS_PER_S))

    Xr = torch.from_numpy(rep).to(cuda)
    gen = torch.Generator().manual_seed(2)
    sample = torch.randperm(N_CELLS, generator=gen)[:2000].to(cuda)
    exact = {}
    # the path's variant (approx euclidean, k+1 = 20) first: it is the
    # JSON line's record
    for metric, approx, k in (("euclidean", True, N_NEIGHBORS - 1),
                              ("euclidean", False, N_NEIGHBORS - 1),
                              ("cosine", True, N_NEIGHBORS - 1),
                              ("cosine", False, N_NEIGHBORS - 1),
                              ("euclidean", True, 200)):
        one_minus, take_sqrt = metric == "cosine", metric == "euclidean"
        op, sq = tk._operand(Xr, metric, approx)
        args = (op, sq, k, one_minus, take_sqrt)
        gi, gd = tk.knn_topk(*args)
        torch.cuda.synchronize()
        ri, rd = tk.knn_topk_plain(*args)
        # |Δd²| <= 1e-5·(|q|² + |c|²): the expanded form's cancellation
        # error (normalised rows for cosine: 2e-5)
        scale = 2.0 if one_minus else sq[:, None] + sq[ri.long()]
        sqr = (lambda t: t.double() ** 2) if take_sqrt else (lambda t: t.double())  # noqa: E731
        ok = bool(((sqr(gd) - sqr(rd)).abs() <= 1e-5 * scale).all())
        equal = (gi == ri).float().mean().item()
        extra = f"[{metric} {'approx' if approx else 'f32'} k+1={k + 1}]"
        line = f" equal indices {equal:.5f}"
        if approx and k == N_NEIGHBORS - 1:
            exact_i = tk.knn_topk(*tk._operand(Xr, metric, False), k, one_minus, take_sqrt)[0]
            a, e = gi[sample].cpu().numpy(), exact_i[sample].cpu().numpy()
            recall = np.mean([len(set(x[1:]) & set(y[1:])) / k for x, y in zip(a, e)])
            exact[metric] = recall
            line += f"; recall vs f32 on 2000 queries {recall:.5f}"
        # the n² cross terms of d products each; approx: bfloat16 operands
        n_, d_ = op.shape
        record("knn_topk", (gd - rd).abs().max().item(), ok and equal >= 0.99,
               "|dd2| <= 1e-5(|q|^2+|c|^2), equal indices >= 0.99",
               lambda: tk.knn_topk(*args), lambda: tk.knn_topk_plain(*args),
               bound(nbytes(op, gi, gd) + (0 if sq is None else nbytes(sq)), 2 * n_ * n_ * d_,
                     BF16_OPS_PER_S if approx else F32_OPS_PER_S), extra + line)
        if metric == "euclidean" and approx and k == N_NEIGHBORS - 1:
            path_dists = gd
    for metric, recall in exact.items():
        check(recall >= 0.99, f"approx {metric} recall {recall:.4f} >= 0.99")

    sig, rho, vals = tf.smooth_knn(path_dists)
    torch.cuda.synchronize()
    sp_, rp, vp = tf.smooth_knn_plain(path_dists)
    rel = lambda a, b: ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()  # noqa: E731
    s_rel, r_rel, v_err = rel(sig, sp_), rel(rho, rp), (vals - vp).abs().max().item()
    # the membership pass alone: exp(−max(d − ρ, 0)/σ) of the kernel's own σ, ρ
    own = torch.exp(-torch.clamp(path_dists - rho[:, None], min=0.0) / sig[:, None])
    m_err = (vals - own).abs().max().item()
    # against the plain chain, the bisection's σ difference carries into
    # v = exp(−x) as |Δv| <= x·e^(−x)·|Δσ|/σ <= s_rel/e, beside 1e-6 of rounding
    v_tol = 1e-6 + s_rel / np.e
    # 64 bisection steps of k terms (subtract, divide, exp, add), then the k values
    record("smooth_knn_membership", v_err,
           s_rel <= 1e-5 and r_rel <= 1e-5 and m_err <= 1e-6 and v_err <= v_tol,
           f"sigma rel {s_rel:.1e}, rho rel {r_rel:.1e} <= 1e-5; vals of its own sigma, rho "
           f"{m_err:.1e} <= 1e-6; vals {v_err:.1e} <= 1e-6 + sigma rel/e = {v_tol:.1e}",
           lambda: tf.smooth_knn(path_dists), lambda: tf.smooth_knn_plain(path_dists),
           bound(nbytes(path_dists, sig, rho, vals), path_dists.numel() * (64 * 4 + 3),
                 F32_OPS_PER_S))
    return results


def prot_path(tpt, tpp, P, cuda):
    """The e2e's protein modality up to its own graph: clr (seurat, axis 0,
    T12) → pca(30) of the dense result → neighbors(20)."""
    h = Holder(P.copy())
    tpt.pp.clr(h, device=cuda)
    tpp.pca(h, n_comps=PROT_COMPS, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_pca", device=cuda)
    return h


def phase_prot_path(tpt, tpp, tla, td, kernels, P, labels, cuda):
    kernels.reset_launch_counts()
    h = prot_path(tpt, tpp, P, cuda)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"[prot] {N_CELLS}x{N_PROT} dense; launches by clr+pca+neighbors {launches}",
          flush=True)
    for name, count in PROT_PATH.items():
        check(launches[name] == count, f"the prot path launched {name} {count} times")
    # the CLR against T12's plain version on the same counts (float32 both)
    ref = td.clr_values_plain(torch.from_numpy(P).to(cuda), 0, seurat=True)[0].cpu().numpy()
    clr_err = float(np.max(np.abs(h.X - ref) / (1e-6 + np.abs(ref))))
    check(h.X.dtype == np.float32 and h.X.shape == P.shape, "clr keeps the dtype and shape")
    check(np.allclose(h.X, ref, rtol=1e-5, atol=1e-6), "clr vs the plain version rtol 1e-5")
    # PCA of the dense 100k x 120: the same iteration with the same omega in
    # float64 (float32 rounding only), and the exact spectrum of the centred
    # matrix for the 19 planted directions (20 clusters)
    X64 = torch.from_numpy(h.X).to(cuda, torch.float64)
    om = tla.draw_omega(N_PROT, PROT_COMPS + 10, SEED, cuda).double()
    s64 = tla._pca_dense(X64, PROT_COMPS, om, N_ITER, True)[1].cpu().numpy()
    exact = torch.linalg.svdvals(X64 - X64.mean(dim=0)).cpu().numpy()[:PROT_COMPS]
    s = np.sqrt(h.uns["pca"]["variance"] * (N_CELLS - 1))
    rel_same = float(np.max(np.abs(s - s64) / s64))
    rel_exact = np.abs(s - exact) / exact
    check(h.obsm["X_pca"].shape == (N_CELLS, PROT_COMPS) and np.isfinite(h.obsm["X_pca"]).all(),
          "prot X_pca shape, finite")
    check(rel_same <= 1e-4, "prot PCA vs the float64 iteration, rtol 1e-4")
    # 7 iterations of a 40-wide subspace: the weakest planted directions sit
    # near the noise bulk and converge slowly, so this bound only asks for a PCA
    check(rel_exact[:N_CLUSTERS - 1].max() <= 1e-2,
          "prot PCA's planted directions vs the exact spectrum, rtol 1e-2")
    share = check_graph(h, labels)
    print(f"[prot] clr vs plain max rel {clr_err:.2e}; PCA singular values vs float64 "
          f"same omega {rel_same:.2e}, vs exact: first {N_CLUSTERS - 1} "
          f"{rel_exact[:N_CLUSTERS - 1].max():.2e}, rest {rel_exact[N_CLUSTERS - 1:].max():.2e}; "
          f"planted-label share of neighbours {share:.4f} (chance 0.05)", flush=True)
    check(share >= 0.55, "prot planted-label share >= 0.55")
    return launches, h


def phase_dense_kernels(td, P, cuda) -> dict:
    """T12 against its plain version on the protein counts, the path's call
    (the seurat form along axis 0)."""
    X = torch.from_numpy(P).to(cuda)
    out, gm = td.clr_values(X, 0, seurat=True)
    torch.cuda.synchronize()
    ref, gm_ref = td.clr_values_plain(X, 0, seurat=True)
    gm_rel = ((gm - gm_ref).abs() / gm_ref.abs()).max().item()
    diff = (out - ref).abs()
    ok = gm_rel <= 1e-6 and bool((diff <= 1e-6 + 1e-5 * ref.abs()).all())
    ms = median_ms(lambda: td.clr_values(X, 0, seurat=True))
    plain_ms = median_ms(lambda: td.clr_values_plain(X, 0, seurat=True))
    # per value log1p, add, then exp, divide, log1p
    bnd = bound(nbytes(X, out, gm), 5 * X.numel(), F32_OPS_PER_S)
    print(f"[kernel] clr_dense {tuple(X.shape)}: max_abs_err={diff.max().item():.3e} "
          f"(mean rtol 1e-6: {gm_rel:.2e}; values rtol 1e-5 atol 1e-6) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
          f"library_ms=None", flush=True)
    check(ok, "clr_dense within its tolerance")
    return {"clr_dense": {"max_abs_err": diff.max().item(), "ms": ms, "plain_ms": plain_ms,
                          **bnd, "library_ms": None}}



@contextmanager
def wnn_probe(tw, tk, tf, plain: bool):
    """Record what ``wnn_neighbors`` hands T9, T10 and T11 and what they return,
    and the k of its kNN calls. With ``plain`` every kernel of the path
    (T5, T6, T9-T11) is routed to its plain PyTorch version for the block.
    Only this script swaps the module attributes; they are restored after."""
    rec = {"bandwidth": [], "theta": [], "fusion": [], "knn_k": []}
    targets = {(tw, "wnn_bandwidth"): "bandwidth", (tw, "wnn_theta"): "theta",
               (tw, "wnn_fusion_scores"): "fusion"}
    saved = {(m, n): getattr(m, n) for m, n in
             [*targets, (tw, "knn"), (tk, "knn_topk"), (tf, "smooth_knn")]}

    def recorder(fn, key):
        def run(*args):
            out = fn(*args)
            rec[key].append((args, out))
            return out
        return run

    def knn(X, k, **kw):
        rec["knn_k"].append(k)
        return saved[(tw, "knn")](X, k, **kw)

    try:
        for (mod, name), key in targets.items():
            fn = getattr(mod, f"{name}_plain") if plain else getattr(mod, name)
            setattr(mod, name, recorder(fn, key))
        tw.knn = knn
        if plain:
            tk.knn_topk, tf.smooth_knn = tk.knn_topk_plain, tf.smooth_knn_plain
        yield rec
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def atac_e2e_path(tac, tpp, X, cuda):
    """The e2e's ATAC modality up to its own graph, the input of WNN."""
    h = Holder(X)
    tac.pp.tfidf(h, device=cuda)
    tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)
    tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_lsi", device=cuda)
    return h


def label_share(D, labels) -> float:
    rows = np.repeat(np.arange(D.shape[0]), np.diff(D.indptr))
    return float((labels[rows] == labels[D.indices]).mean())


def phase_wnn_path(tpp, tw, tk, tf, kernels, mods, labels, cuda):
    md = MuHolder(mods)
    with wnn_probe(tw, tk, tf, plain=False) as rec:
        kernels.reset_launch_counts()
        tpp.neighbors(md, device=cuda)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    print(f"[wnn] pp.neighbors(mdata) over {list(mods)} launched {launches}; "
          f"kNN k = {rec['knn_k']}", flush=True)
    for name, count in WNN_PATH.items():
        check(launches[name] == count, f"the WNN path launched {name} {count} times")
    check(rec["knn_k"] == [N_MULTI] * len(mods), "T5 ran at k+1 = 201 per modality")

    D, C = md.obsp["distances"], md.obsp["connectivities"]
    rows = np.repeat(np.arange(N_CELLS), np.diff(D.indptr))
    inner = np.diff(rows) == 0
    check((np.diff(D.indptr) == N_NEIGHBORS + 1).all(), "21 fused neighbours per row")
    check(not (D.indices == rows).any(), "self not among the fused neighbours")
    check(bool((np.diff(D.indices)[inner] > 0).all()), "fused neighbours column-sorted")
    check(np.isfinite(D.data).all() and (D.data >= 0).all(), "fused distances finite, >= 0")
    check((C != C.T).nnz == 0, "fused connectivities symmetric")
    check(C.data.min() > 0 and C.data.max() <= 1, "fused connectivities in (0, 1]")
    w = np.stack([md.obs[f"{m}:mod_weight"] for m in mods], axis=1)
    check(bool(np.abs(w.sum(axis=1) - 1).max() <= 1e-9), "weights sum to 1")
    check(md.uns["neighbors"]["params"]["n_neighbors"] == N_NEIGHBORS, "WNN uns params")

    # the plain-PyTorch WNN from the same per-modality graphs
    md_p = MuHolder(mods)
    t0 = time.perf_counter()
    with wnn_probe(tw, tk, tf, plain=True) as rec_p:
        kernels.reset_launch_counts()
        tpp.neighbors(md_p, device=cuda)
        torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    check(not any(kernels.launch_counts().values()), "the plain WNN launched no kernel")

    def rel(a, b):
        return ((a - b).abs() / b.abs().clamp(min=1e-30)).cpu().numpy()

    sig_rel = np.concatenate([rel(a[1], b[1]) for a, b in zip(rec["bandwidth"], rec_p["bandwidth"])])
    th_rel = np.concatenate([rel(a[1], b[1]) for a, b in zip(rec["theta"], rec_p["theta"])])
    w_p = np.stack([md_p.obs[f"{m}:mod_weight"] for m in mods], axis=1)
    w_err = np.abs(w - w_p).max(axis=1)
    Dp, Cp = md_p.obsp["distances"], md_p.obsp["connectivities"]
    both = D.multiply(Dp.astype(bool))
    edge_jac = both.nnz / (D.nnz + Dp.nnz - both.nnz)
    cb = C.multiply(Cp.astype(bool)).tocsr()
    cb_p = Cp.multiply(C.astype(bool)).tocsr()
    conn_d = np.abs(cb.data - cb_p.data)
    conn_q = np.quantile(conn_d, [0.5, 0.99, 0.999])
    db = D.multiply(Dp.astype(bool)).tocsr()
    db_p = Dp.multiply(D.astype(bool)).tocsr()
    dist_rel = np.abs(db.data - db_p.data) / db_p.data
    share, share_p = label_share(D, labels), label_share(Dp, labels)
    own = {m: label_share(h.obsp["distances"], labels) for m, h in mods.items()}
    print(f"[wnn] vs the plain WNN from the same graphs: sigma rel <= 1e-5 on "
          f"{(sig_rel <= 1e-5).mean():.5f} of cells (max {sig_rel.max():.2e}); theta rel "
          f"<= 1e-4 on {(th_rel <= 1e-4).mean():.5f} (max {th_rel.max():.2e}); weights "
          f"|dw| <= 1e-4 on {(w_err <= 1e-4).mean():.5f} (max {w_err.max():.2e}); "
          f"edge Jaccard {edge_jac:.5f}; fused distances rel <= 1e-4 on "
          f"{(dist_rel <= 1e-4).mean():.5f} (max {dist_rel.max():.2e}); connectivities on "
          f"shared edges |dc| median {conn_q[0]:.2e}, 99% {conn_q[1]:.2e}, 99.9% "
          f"{conn_q[2]:.2e}, max {conn_d.max():.2e}", flush=True)
    print(f"[wnn] planted-label share of fused neighbours {share:.4f} (plain WNN "
          f"{share_p:.4f}); each modality's own graph: "
          + ", ".join(f"{m} {v:.4f}" for m, v in own.items())
          + f"; mean weights " + ", ".join(f"{m} {w[:, i].mean():.4f}" for i, m in enumerate(mods))
          + f" (chance 0.05)", flush=True)
    print(f"[times] plain-torch WNN on the card, one warm run: {t_plain:.4f}s", flush=True)
    # sigma, theta and the weights: the two versions sum in other orders, so
    # a score can round to the other side of a float32 step of N (2^-7 at
    # N = 1e5) and pick another winner. So the tight bound holds on a share,
    # and a bound on every cell catches what a share lets through (a wrong
    # fallback, a bug on rare rows). Three H100 runs read at most sigma
    # 8.3e-5, theta 1.2e-4, |dw| 4.8e-5 and fused distances 1.1e-5 relative
    check((sig_rel <= 1e-5).mean() >= 0.999, "sigma vs plain within rtol 1e-5 on >= 99.9% of cells")
    check(sig_rel.max() <= 1e-3, "sigma vs plain within rtol 1e-3 on every cell")
    check((th_rel <= 1e-4).mean() >= 0.999, "theta vs plain within rtol 1e-4 on >= 99.9%")
    check(th_rel.max() <= 1e-3, "theta vs plain within rtol 1e-3 on every row")
    check((w_err <= 1e-4).mean() >= 0.999, "weights vs plain within 1e-4 on >= 99.9%")
    check(w_err.max() <= 1e-3, "weights vs plain within 1e-3 on every cell")
    check(edge_jac >= 0.99, "fused graph vs plain edge Jaccard >= 0.99")
    # the fused distances sqrt(0.5 (1 - score)) of a row lie in a narrow
    # band, so T6's sigma is small and exp(-(d - rho)/sigma) magnifies the
    # weights' rounding (|dw| <= 5e-5) into the memberships: an H100 read a
    # largest |dc| of 8.8e-2 on identical edge sets. Held on the distances
    # and on the share of edges within 1e-3
    check((dist_rel <= 1e-4).mean() >= 0.999, "fused distances vs plain rtol 1e-4 on >= 99.9%")
    check(dist_rel.max() <= 1e-3, "fused distances vs plain rtol 1e-3 on every shared edge")
    check((conn_d <= 1e-3).mean() >= 0.999,
          "fused connectivities vs plain within 1e-3 on >= 99.9% of shared edges")
    check(abs(share - share_p) <= 0.01, "fused planted-label share within 0.01 of the plain WNN's")
    return launches, rec, md


def wnn_bound(name, args, out) -> dict:
    """The bound of T9-T11 on the arguments of their measured call."""
    tensors = [a for a in args if torch.is_tensor(a)]
    bytes_ = nbytes(*tensors, out)
    if name.startswith("wnn_bandwidth"):
        # per cell, C candidates: a Jaccard count of kk binary searches over
        # the cell's sorted set, a d-wide distance, a rank among C
        NI, rep16 = args[0], args[2]
        n, kk = NI.shape
        stride = args[7]
        C = kk + kk * (-(-kk // stride))
        ops = n * C * (kk * max(1, int(np.ceil(np.log2(kk)))) + 2 * rep16.shape[1]
                       + int(np.ceil(np.log2(C))))
        return bound(bytes_, ops, F32_OPS_PER_S)
    if name == "wnn_theta":
        # per row: the mean of kk neighbour rows of d, then a distance
        rep, rows1, NI2 = args[0], args[1], args[3]
        return bound(bytes_, rows1.numel() * (NI2.shape[1] + 3) * rep.shape[1], F32_OPS_PER_S)
    # fusion: per candidate a bfloat16 cross term over the table's D columns
    cand, cat16 = args[0], args[1]
    return bound(bytes_, 2 * cand.numel() * cat16.shape[1], BF16_OPS_PER_S)


def phase_wnn_kernels(tw, rec) -> dict:
    """T9-T11 against their plain versions on the arguments the WNN path
    gave them (the RNA modality's bandwidth, the RNA|ATAC theta, the fusion).
    Each is held tight on a share (a float32 near-tie may flip one winner of
    T9's selection) and within 100x that on every cell or row."""
    results = {}
    cases = (
        ("wnn_bandwidth", tw.wnn_bandwidth, tw.wnn_bandwidth_plain, rec["bandwidth"][0][0],
         "rtol 1e-5 on >= 99.9% of cells, 1e-3 on all", 1e-5),
        ("wnn_theta", tw.wnn_theta, tw.wnn_theta_plain, rec["theta"][1][0],
         "rtol 1e-5 on >= 99.9% of rows, 1e-3 on all", 1e-5),
        ("wnn_fusion_scores", tw.wnn_fusion_scores, tw.wnn_fusion_scores_plain,
         rec["fusion"][0][0], "atol 1e-5 on >= 99.9% of rows, 1e-3 on all", None),
    )
    for name, fn, plain, args, tol, tight in cases:
        out = fn(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        diff = (out - ref).abs()
        if tight is None:  # the row's largest absolute difference
            err, kind, tight = diff.max(dim=1).values, "row abs", 1e-5
        else:
            err, kind = diff / ref.abs().clamp(min=1e-30), "rel"
        ok = (err <= tight).float().mean().item() >= 0.999 and err.max().item() <= 100 * tight
        ms, plain_ms = median_ms(lambda: fn(*args)), median_ms(lambda: plain(*args), reps=3)
        bnd = wnn_bound(name, args, out)
        results[name] = {"max_abs_err": diff.max().item(), "ms": ms, "plain_ms": plain_ms,
                         **bnd, "library_ms": None}
        shape = tuple(args[0].shape)
        print(f"[kernel] {name} {shape}: max_abs_err={diff.max().item():.3e} ({tol}; "
              f"largest {kind} err {err.max().item():.2e}) ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})", flush=True)
        check(ok, f"{name} within {tol}")
    return results


def ari(a, b) -> float:
    """Adjusted Rand index of two labelings."""
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    C = np.zeros((ia.max() + 1, ib.max() + 1))
    np.add.at(C, (ia, ib), 1)
    comb = lambda x: x * (x - 1) / 2  # noqa: E731
    sum_a, sum_b = comb(C.sum(1)).sum(), comb(C.sum(0)).sum()
    expected = sum_a * sum_b / comb(len(ia))
    return float((comb(C).sum() - expected) / ((sum_a + sum_b) / 2 - expected))


def phase_leiden(ttl, kernels, profiling, mods, labels):
    """Multiplex Leiden over the three modality graphs, on the host."""
    md = MuHolder(mods)
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.leiden(md, resolution=1.0)
        wall = time.perf_counter() - t0
    got = md.obs["leiden"]
    a = ari(labels, got)
    stages = stage_seconds(t)
    print(f"[leiden] tl.leiden over {list(mods)}: {len(np.unique(got))} clusters, ARI "
          f"against the planted labels {a:.4f}; wall {wall:.4f}s; stages {stages}", flush=True)
    check(not any(kernels.launch_counts().values()), "Leiden launched no kernel (host)")
    check(a >= 0.9, "Leiden ARI against the planted labels >= 0.9")
    return wall


def knn_share(tk, emb, labels, cuda, k=15) -> float:
    """The planted-label share of each cell's k nearest cells in ``emb``
    (T5, exact)."""
    idx, _ = tk.knn(np.ascontiguousarray(emb), k, device=cuda)
    idx = idx[:, 1:].long().cpu().numpy()
    return float((labels[idx] == labels[:, None]).mean())


def graph_holder(mods, wnn_md):
    """A MuData-like holder carrying the WNN graph of ``wnn_md``."""
    md = MuHolder(mods)
    md.obsp, md.uns = dict(wnn_md.obsp), dict(wnn_md.uns)
    return md


def phase_umap_path(ttl, tu, tk, kernels, mods, wnn_md, labels, cuda):
    md = graph_holder(mods, wnn_md)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ttl.umap(md, device=cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    G = md.obsp["connectivities"].tocsr()
    print(f"[umap] tl.umap(mdata) on the WNN graph ({G.nnz} edges) in {wall:.4f}s "
          f"launched {launches}", flush=True)
    for name, count in UMAP_PATH.items():
        check(launches[name] == count, f"the UMAP path launched {name} {count} times")
    emb = md.obsm["X_umap"]
    check(emb.shape == (N_CELLS, 2) and emb.dtype == np.float32 and np.isfinite(emb).all(),
          "X_umap shape, float32, finite")

    # one epoch, kernel against plain, from the spectral layout with the
    # same negatives and eons
    a, b = tu.find_ab_params()
    heads, tails, eps, _, dc = tu.edge_schedule(G, N_EPOCHS)
    shift = tu.bucket_shifts(eps, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, shift, N_CELLS, cuda)
    start = tu.spectral_init(G, 2, seed=42, device=cuda)
    emb0 = torch.from_numpy(start).to(cuda)
    dct = torch.from_numpy(dc).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    negs = torch.randint(0, N_CELLS, (N_CELLS, 5), generator=gen, dtype=torch.int32, device=cuda)
    alpha0 = tu.epoch_alpha(1.0, 0, N_EPOCHS)
    args = (dct, negs, 0, alpha0, a, b, 1.0)
    eons_k, eons_p = edges.eps.clone(), edges.eps.clone()
    out_k = tu.umap_epoch(emb0, torch.empty_like(emb0), edges, eons_k, *args)
    torch.cuda.synchronize()
    out_p = tu.umap_epoch_plain(emb0, torch.empty_like(emb0), edges, eons_p, *args)
    err = (out_k - out_p).abs().max().item()
    same_eons = bool(torch.equal(eons_k, eons_p))
    # timed from the same state: each call takes fresh eons
    pools = {k: [edges.eps.clone() for _ in range(6)] for k in ("k", "p")}
    buf = torch.empty_like(emb0)
    ms = median_ms(lambda: tu.umap_epoch(emb0, buf, edges, pools["k"].pop(), *args))
    plain_ms = median_ms(lambda: tu.umap_epoch_plain(emb0, buf, edges, pools["p"].pop(), *args))
    # at epoch 0 every stride runs: each edge's shift and eons are read,
    # and a due edge's tail and eps read and its eons written; per due edge
    # and per negative about 30 operations (two powf among them)
    E = len(eps)
    due = int((eps <= 1.0).sum())
    bnd = bound(5 * E + 12 * due + nbytes(edges.indptr, dct, negs, emb0, out_k),
                30 * (due + negs.numel()), F32_OPS_PER_S)
    strides = sorted(set((1 << shift.astype(np.int64)).tolist()))
    print(f"[kernel] umap_epoch (n={N_CELLS}, E={E}, strides {strides}, due at epoch 0 "
          f"{due}): max_abs_err={err:.3e} (<= 1e-3; eons equal {same_eons}) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
          f"library_ms=None", flush=True)
    check(err <= 1e-3 and same_eons, "umap_epoch vs plain from the spectral layout, max 1e-3")
    results = {"umap_epoch": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                              "library_ms": None}}

    # the 200 epochs of the kernel and of the plain version from the same
    # start and seed (the same negatives): held by the planted-label share
    # of each cell's 15 nearest cells in the layout
    md_k = graph_holder(mods, wnn_md)
    ttl.umap(md_k, init_pos=start, device=cuda)
    md_p = graph_holder(mods, wnn_md)
    saved = tu.umap_epoch
    tu.umap_epoch = tu.umap_epoch_plain
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ttl.umap(md_p, init_pos=start, device=cuda)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    finally:
        tu.umap_epoch = saved
    check(kernels.launch_counts()["umap_epoch"] == 0, "the plain UMAP launched no T13")
    s_main = knn_share(tk, emb, labels, cuda)
    s_k = knn_share(tk, md_k.obsm["X_umap"], labels, cuda)
    s_p = knn_share(tk, md_p.obsm["X_umap"], labels, cuda)
    fused = label_share(wnn_md.obsp["distances"], labels)
    print(f"[umap] planted-label share of the 15 nearest cells in 2-D: main run {s_main:.4f}, "
          f"kernel {s_k:.4f} and plain {s_p:.4f} from the same start; the fused graph's own "
          f"{fused:.4f} (chance 0.05)", flush=True)
    print(f"[times] plain-torch UMAP (200 epochs, the same start) on the card, one warm run: "
          f"{t_plain:.4f}s", flush=True)
    check(abs(s_k - s_p) <= 0.02, "UMAP kernel vs plain share within 0.02")
    check(min(s_main, s_k) >= 0.8 * fused, "UMAP share >= 0.8 x the fused graph's")
    # the same share over other seeds (negatives, init jitter and the spectral
    # init's test matrix), on the same graph: the spread a single run is drawn from
    spread = []
    for seed in range(10):
        h = graph_holder(mods, wnn_md)
        ttl.umap(h, random_state=seed, device=cuda)
        spread.append(knn_share(tk, h.obsm["X_umap"], labels, cuda))
    print(f"[umap] the same share over random_state 0-9: min {min(spread):.4f}, median "
          f"{float(np.median(spread)):.4f}, max {max(spread):.4f} "
          f"({', '.join(f'{v:.4f}' for v in spread)})", flush=True)
    # and at this run's seed from starts jittered by 1e-4: how far the checked
    # share moves under a small change of its start (the graph itself differs
    # between runs by a few hundred edges, which moves it further)
    jitter = []
    for j in range(5):
        rng = np.random.default_rng(100 + j)
        h = graph_holder(mods, wnn_md)
        ttl.umap(h, init_pos=(start + rng.normal(scale=1e-4, size=start.shape)).astype(np.float32),
                 device=cuda)
        jitter.append(knn_share(tk, h.obsm["X_umap"], labels, cuda))
    print(f"[umap] the same share from the seed-42 start jittered by 1e-4 (5 draws): "
          f"{', '.join(f'{v:.4f}' for v in jitter)}", flush=True)
    return launches, results



def profiled(fn):
    """Run ``fn`` once under torch.profiler; returns (wall s, device busy s,
    copies s, top kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only: a host op (aten::copy_) also carries the
    # device time of what it launched, and CUPTI adds its own buffer events
    dev = {e.key: e.device_time_total / 1e6 for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.device_time_total > 0
           and e.key != "Activity Buffer Request"}
    copies = sum(v for k, v in dev.items() if k.startswith(("Memcpy", "Memset")))
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    return wall, busy, copies, top


def print_profile(label, prof):
    wall, busy, copies, top = prof
    print(f"[profile] {label}: profiled wall {wall:.4f}s; device busy {busy:.4f}s "
          f"({busy / wall:.1%} of the wall; copies/memsets {copies:.4f}s); top "
          + "; ".join(f"{k[:60]} {v * 1e3:.3f}ms" for k, v in top), flush=True)


def timed_reps(label, make, run, profiling, reps=3):
    walls, splits = [], []
    for _ in range(reps):
        h = make()
        torch.cuda.synchronize()
        with profiling.collect() as t:
            t0 = time.perf_counter()
            run(h)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        splits.append(stage_seconds(t))
    print(f"[times] {label} warm wall s {[round(w, 4) for w in walls]} "
          f"median {float(np.median(walls)):.4f}; stages {splits}", flush=True)


def phase_times(tac, tpp, tpt, ttl, dsp, tla, tk, tf, td, profiling, X, atac_h, X_rna,
                P, wnn_mods, wnn_md, cuda) -> None:
    def tfidf_lsi(h):
        tac.pp.tfidf(h, device=cuda)
        tac.tl.lsi(h, n_comps=K, n_iter=N_ITER, random_state=SEED, device=cuda)

    def atac_neighbors(h):
        tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_lsi", device=cuda)

    def lsi_holder():
        h = Holder(atac_h.X)
        h.obsm["X_lsi"] = atac_h.obsm["X_lsi"]
        return h

    timed_reps("tfidf+lsi", lambda: Holder(X.copy()), tfidf_lsi, profiling)
    print_profile("tfidf+lsi", profiled(lambda: tfidf_lsi(Holder(X.copy()))))
    timed_reps("ATAC neighbors", lsi_holder, atac_neighbors, profiling)
    print_profile("ATAC neighbors", profiled(lambda: atac_neighbors(lsi_holder())))
    timed_reps("RNA normalise+pca+neighbors", lambda: X_rna,
               lambda X_: rna_path(dsp, tpp, X_, cuda), profiling)
    print_profile("RNA normalise+pca+neighbors",
                  profiled(lambda: rna_path(dsp, tpp, X_rna, cuda)))
    timed_reps("WNN pp.neighbors(mdata)", lambda: MuHolder(wnn_mods),
               lambda md: tpp.neighbors(md, device=cuda), profiling)
    print_profile("WNN pp.neighbors(mdata)",
                  profiled(lambda: tpp.neighbors(MuHolder(wnn_mods), device=cuda)))
    timed_reps("prot clr+pca+neighbors", lambda: P,
               lambda P_: prot_path(tpt, tpp, P_, cuda), profiling)
    print_profile("prot clr+pca+neighbors", profiled(lambda: prot_path(tpt, tpp, P, cuda)))
    timed_reps("UMAP tl.umap(mdata)", lambda: graph_holder(wnn_mods, wnn_md),
               lambda md: ttl.umap(md, device=cuda), profiling)
    print_profile("UMAP tl.umap(mdata)",
                  profiled(lambda: ttl.umap(graph_holder(wnn_mods, wnn_md), device=cuda)))

    h = Holder(X.copy())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    X0 = h.X.tocsr()
    new = dsp.tfidf_data_plain(dsp.from_scipy(X0, cuda))
    dT = dsp.from_scipy(dsp.to_scipy_data(X0, new), cuda)
    U, s, Vt = tla._rsvd_blocks(dT, K, tla.draw_omega(N_PEAKS, L, SEED, cuda),
                                N_ITER, ops=tla.PLAIN_OPS)
    U, s, Vt = U.cpu().numpy(), s.cpu().numpy(), Vt.cpu().numpy()
    emb = (U - U.mean(axis=0)) / U.std(axis=0)
    check(np.isfinite(emb).all() and np.isfinite(s).all(), "plain path finite")
    t1 = time.perf_counter()
    neighbors_plain(tk, tf, emb, cuda)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"[times] plain-torch on the card, one warm run: tfidf+lsi {t1 - t0:.4f}s, "
          f"ATAC neighbors {t2 - t1:.4f}s", flush=True)
    t0 = time.perf_counter()
    rna_plain(dsp, tla, tk, tf, X_rna, cuda)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prot_plain(tla, tk, tf, td, P, cuda)
    torch.cuda.synchronize()
    print(f"[times] plain-torch on the card, one warm run: RNA normalise+pca+neighbors "
          f"{t1 - t0:.4f}s, prot clr+pca+neighbors {time.perf_counter() - t1:.4f}s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def prot_plain(tla, tk, tf, td, P, cuda):
    """The prot path through the plain versions: T12's, the same dense PCA
    (torch only) and the plain neighbors."""
    Xc = td.clr_values_plain(torch.from_numpy(P).to(cuda), 0, seurat=True)[0]
    U, s, _, _ = tla._pca_dense(Xc, PROT_COMPS, tla.draw_omega(N_PROT, PROT_COMPS + 10,
                                                               SEED, cuda), N_ITER, True)
    return neighbors_plain(tk, tf, (U * s).cpu().numpy(), cuda)


# the noise of the 1M representation along its five leading axes; further
# axes fall as j^-2 (the decaying spectrum of a PCA)
BIG_LEADING_SCALES = (1.0, 1.0, 1.0, 1.0, 0.7)


def make_big_rep(seed: int = 0, n: int = N_BIG):
    """The 1M-cell representation and its planted labels: 40 Gaussian
    clusters whose centres are drawn N(0, 6²) along the five leading axes,
    unit noise on four of them, 0.7 on the fifth and j^-2 on the rest, so
    that some neighbouring clusters overlap (the exact 19-NN planted-label
    share is a little below 1). The shape is a compromise: the IVF index
    recalls more the fewer dimensions the clusters fill, and the 200-epoch
    UMAP layout keeps its clusters apart only from about five dimensions
    on."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, BIG_CLUSTERS, n)
    dims = len(BIG_LEADING_SCALES)
    cent = np.zeros((BIG_CLUSTERS, D_BIG), np.float32)
    cent[:, :dims] = rng.normal(size=(BIG_CLUSTERS, dims)) * 6.0
    scale = np.concatenate([BIG_LEADING_SCALES, np.arange(2, D_BIG + 2 - dims) ** -2.0])
    rep = cent[labels] + rng.standard_normal((n, D_BIG), dtype=np.float32) * scale.astype(np.float32)
    return rep, labels


def big_holder(rep):
    h = Holder(rep)
    h.obsm["X_rep"] = rep
    return h


def stage_seconds(t) -> dict:
    return {k: round(sum(v), 4) for k, v in t.items()}


def rows_recall(a: torch.Tensor, b: torch.Tensor, block: int = 100_000) -> float:
    """The mean share of each row of ``a`` found in the same row of ``b``."""
    hits = 0
    for s in range(0, a.shape[0], block):
        hits += int((a[s:s + block, :, None] == b[s:s + block, None, :]).any(-1).sum())
    return hits / a.numel()


def plain_ivf_rows(ti, X, partition, k, cuda):
    """The port's plain search over the first IVF_ITEMS work items of the
    layout that ``ivf_knn`` builds from ``partition``: the items' rows and
    each row's k neighbours (−1 where none), in the original numbering."""
    cent_np, assign_np = partition
    order, qids, ppos, pcnt, L = ti.build_ivf_layout(assign_np, cent_np, cent_np.shape[0],
                                                     8, 1024)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    order_t = to(order)
    Xs = X[order_t.long()].contiguous()
    q, pp_, pc = (to(a[:IVF_ITEMS]) for a in (qids, ppos, pcnt))
    rp, rd = ti.ivf_search_plain(Xs, q, pp_, pc, ti.item_means(Xs, q), k, L, False)
    ok = q >= 0
    nb = torch.where(torch.isinf(rd[ok]), -1, order_t[rp[ok].long()])
    return order_t[q[ok].long()].long(), nb[:, 1:].int()


def union_times(tf, C, label: str, rounds: int = 3) -> None:
    """The host fuzzy union of a tagged graph's membership table through
    the native engine and through the scipy formula, taking turns (the
    host's cores are shared, so its clock drifts within a run): the times,
    and the two graphs against each other."""
    tag = getattr(C, tf.MEMBERSHIP_TAG)
    n = tag["n"]
    t_nat, t_ref = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        nat = tf._fuzzy_union_native(tag["idx"], tag["vals"], n, 1.0)
        t1 = time.perf_counter()
        ref = tf._fuzzy_union(tag["idx"], tag["vals"], n, 1.0)
        t_nat.append(round(t1 - t0, 4))
        t_ref.append(round(time.perf_counter() - t1, 4))
    same = nat.nnz == ref.nnz and np.array_equal(nat.indices, ref.indices) \
        and np.array_equal(nat.indptr, ref.indptr)
    err = float(np.abs(nat.data - ref.data).max()) if same else float("inf")
    print(f"[union] {label}: {n} rows, {nat.nnz} edges; native {t_nat}s, scipy {t_ref}s, "
          f"medians {np.median(t_nat):.4f} and {np.median(t_ref):.4f} (scipy over native "
          f"{np.median(t_ref) / np.median(t_nat):.2f}x); same edges {same}, largest "
          f"difference {err:.2e} (<= 1e-6)", flush=True)
    check(same and err <= 1e-6, f"{label}: the native union is the scipy formula's graph")
    check((nat != C).nnz == 0, f"{label}: the path's graph is the native union")


def phase_ivf(tpp, ti, tk, tf, kernels, profiling, rep, labels, cuda):
    """pp.neighbors of 1M rows: the IVF index, T6, the native union."""
    n, k = N_BIG, N_NEIGHBORS - 1
    h = big_holder(rep)
    ti._PARTITION_CACHE.clear()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        tpp.neighbors(h, n_neighbors=N_NEIGHBORS, use_rep="X_rep", device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    print(f"[ivf] pp.neighbors of {n}x{D_BIG} in {wall:.4f}s launched "
          f"{ {k_: v for k_, v in launches.items() if v} }; stages {stage_seconds(t)}",
          flush=True)
    for name, count in IVF_PATH.items():
        check(launches[name] == count, f"the IVF path launched {name} {count} times")
    check(launches["ivf_search"] >= 1, "the IVF path launched ivf_search")
    partition = list(ti._PARTITION_CACHE.values())[-1]

    # a second, warm run from an empty partition cache, for the times
    ti._PARTITION_CACHE.clear()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        tpp.neighbors(big_holder(rep), n_neighbors=N_NEIGHBORS, use_rep="X_rep", device=cuda)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    split = stage_seconds(t)
    print(f"[times] pp.neighbors at 1M, second run: {wall2:.4f}s; stages {split}", flush=True)

    # the table itself: the same search again (the partition is cached)
    X = torch.from_numpy(rep).to(cuda)
    kernels.reset_launch_counts()
    idx, dists = ti.ivf_knn(X, k)
    torch.cuda.synchronize()
    check(kernels.launch_counts()["kmeans_assign"] == 0, "the partition cache hit at k = 19")
    check(bool((idx[:, 0] == torch.arange(n, device=cuda)).all()) and bool((dists[:, 0] == 0).all()),
          "IVF: self in column 0 at distance 0")
    check(bool((idx >= 0).all()), "IVF: no -1 in the table")
    check(bool((dists[:, 2:] >= dists[:, 1:-1]).all()) and bool(torch.isfinite(dists).all()),
          "IVF: distances finite and ascending from column 1")
    D, C = h.obsp["distances"], h.obsp["connectivities"]
    check((np.diff(D.indptr) == k).all(), "IVF graph: 19 distances per row")
    path_idx = torch.from_numpy(D.indices.reshape(n, k).astype(np.int32)).to(cuda)
    check(rows_recall(idx[:, 1:], path_idx) == 1.0, "the graph holds the table's neighbours")

    # exact kNN at the same size: T5, one launch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact, _ = tk.knn(X, k, method="brute", approx=False)
    torch.cuda.synchronize()
    t_brute = time.perf_counter() - t0
    recall = rows_recall(exact[:, 1:], idx[:, 1:])
    lab = torch.from_numpy(labels).to(cuda)
    share_exact = float((lab[exact[:, 1:].long()] == lab[:, None]).float().mean())
    share = float((lab[idx[:, 1:].long()] == lab[:, None]).float().mean())
    t_ivf = sum(v for k_, v in split.items() if k_.startswith("ivf/"))
    print(f"[ivf] recall over all {n} rows against exact T5 {recall:.4f} (>= 0.9); "
          f"planted-label share of the 19 neighbours: exact {share_exact:.4f}, IVF {share:.4f} "
          f"(chance {1 / BIG_CLUSTERS:.3f}); IVF stages {t_ivf:.4f}s against brute force "
          f"(T5, float32, one launch) {t_brute:.4f}s at the same size", flush=True)
    check(recall >= 0.9, "IVF recall against exact kNN >= 0.9")
    check(0.5 < share_exact < 0.999, "the planted clusters overlap: exact share below 1")

    # what the data allows and what the port loses: on the first work items,
    # the plain search of the same probe lists against ivf_knn and against exact
    rows, plain_nb = plain_ivf_rows(ti, X, partition, k, cuda)
    held = rows_recall(plain_nb, idx[rows, 1:])
    r_plain = rows_recall(exact[rows, 1:], plain_nb)
    r_ivf = rows_recall(exact[rows, 1:], idx[rows, 1:])
    print(f"[ivf] on the {len(rows)} rows of the first {IVF_ITEMS} work items: ivf_knn holds "
          f"{held:.5f} of the plain search's neighbours (>= 0.999); recall against exact: "
          f"plain search of the same probe lists {r_plain:.4f}, ivf_knn {r_ivf:.4f} "
          f"(within 0.001)", flush=True)
    check(held >= 0.999, "ivf_knn returns the plain search's neighbours")
    check(abs(r_plain - r_ivf) <= 1e-3, "ivf_knn recalls what its probe lists allow")

    t0 = time.perf_counter()
    sym = (C != C.T).nnz == 0
    check(sym, "IVF connectivities symmetric")
    check(C.data.min() > 0 and C.data.max() <= 1, "IVF connectivities in (0, 1]")
    tag = getattr(C, tf.MEMBERSHIP_TAG, None)
    check(tag is not None and tag["n"] == n and tag["nnz"] == C.nnz
          and tag["idx"].shape == (n, N_NEIGHBORS), "the membership tag on the graph")
    print(f"[ivf] graph: {C.nnz} edges, symmetric {sym}, tagged {tag is not None} "
          f"(checked in {time.perf_counter() - t0:.1f}s)", flush=True)
    union_times(tf, C, "1M graph")

    # WNN's candidate pool on the same tensor: k = 200 from the cached partition
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    idx200, _ = ti.ivf_knn(X, N_MULTI)
    torch.cuda.synchronize()
    t200 = time.perf_counter() - t0
    agree = float((idx200[:, :N_NEIGHBORS] == idx).float().mean())
    print(f"[ivf] ivf_knn at k = {N_MULTI} on the same tensor in {t200:.4f}s launched "
          f"{ {k_: v for k_, v in kernels.launch_counts().items() if v} }; its first "
          f"{N_NEIGHBORS} columns agree with the k = 19 run on {agree:.5f} of entries", flush=True)
    check(kernels.launch_counts()["kmeans_assign"] == 0, "the partition cache hit at k = 200")
    check(agree >= 0.99, "k = 200 and k = 19 agree on >= 99% of the first 20 columns")
    return launches, h, partition


def separation(emb: torch.Tensor, lab: torch.Tensor) -> float:
    """Mean distance between rows of one label over that between rows of
    two (the reference test's seed criterion)."""
    D = torch.cdist(emb, emb)
    same = lab[:, None] == lab[None, :]
    same.fill_diagonal_(False)
    other = ~(lab[:, None] == lab[None, :])
    return float(D[same].mean() / D[other].mean())


def rayleigh(A, emb: np.ndarray) -> np.ndarray:
    """u'Au / u'u of each column u of ``emb``, in float64."""
    U = emb.astype(np.float64)
    return (U * (A @ U)).sum(axis=0) / (U * U).sum(axis=0)


def phase_umap_big(ttl, tu, tk, tf, kernels, profiling, h, labels, cuda):
    """tl.umap on the 1M graph: the membership seed (T16) and T13."""
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.umap(h, device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    G = h.obsp["connectivities"]
    print(f"[umap1m] tl.umap on {G.nnz} edges in {wall:.4f}s launched "
          f"{ {k_: v for k_, v in launches.items() if v} }; stages {stage_seconds(t)}",
          flush=True)
    for name, count in UMAP_BIG_PATH.items():
        check(launches[name] == count, f"the 1M UMAP path launched {name} {count} times")
    emb = h.obsm["X_umap"]
    check(emb.shape == (N_BIG, 2) and emb.dtype == np.float32 and np.isfinite(emb).all(),
          "1M X_umap shape, float32, finite")
    # the 15 nearest cells in 2-D through the IVF index (brute force at 1M x 2
    # costs what it costs at 50 columns)
    idx, _ = tk.knn(emb, 15, method="ivf", device=cuda)
    lab = torch.from_numpy(labels).to(cuda)
    nb = idx[:, 1:].long()
    s_umap = float(((lab[nb.clamp(min=0)] == lab[:, None]) & (nb >= 0)).float().mean())
    s_graph = label_share(h.obsp["distances"], labels)
    print(f"[umap1m] planted-label share of the 15 nearest cells in 2-D {s_umap:.4f}; the "
          f"graph's own {s_graph:.4f} (chance {1 / BIG_CLUSTERS:.3f})", flush=True)
    check(s_umap >= 0.8 * s_graph, "1M UMAP share >= 0.8 x the graph's")

    # the two seeds, each held to the exact operator A = D^-1/2 G D^-1/2 of
    # the graph: a column u of a seed is as good as its Rayleigh quotient
    # u'Au/u'u is near the top of A's spectrum (1); a column of noise reads 0
    tag = getattr(G, tf.MEMBERSHIP_TAG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast = tu.spectral_init(G, 2, seed=42, membership=tag, device=cuda)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref = tu.spectral_init(G, 2, seed=42, membership=None, device=cuda)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dm12 = 1.0 / np.sqrt(np.maximum(np.asarray(G.sum(axis=1)).ravel(), 1e-30))
    A = sp.diags(dm12) @ G @ sp.diags(dm12)
    rq_fast, rq_ref = rayleigh(A, fast), rayleigh(A, ref)
    noise = np.random.default_rng(7).standard_normal(fast.shape)
    rq_noise = rayleigh(A, noise)
    # how far the two 2-D subspaces lie apart, and the reference test's own
    # criterion on a fixed sample of rows, both for the record
    qf, qr = np.linalg.qr(fast.astype(np.float64))[0], np.linalg.qr(ref.astype(np.float64))[0]
    cosines = np.linalg.svd(qf.T @ qr, compute_uv=False)
    sample = np.random.default_rng(7).choice(N_BIG, SEED_SAMPLE, replace=False)
    ls = lab[torch.from_numpy(sample).to(cuda)]
    r_fast = separation(torch.from_numpy(fast[sample]).to(cuda), ls)
    r_ref = separation(torch.from_numpy(ref[sample]).to(cuda), ls)
    print(f"[umap1m] spectral seeds: membership in {t1 - t0:.4f}s, exact in {t2 - t1:.4f}s; "
          f"Rayleigh quotients under the graph's operator: membership "
          f"{[round(float(x), 5) for x in rq_fast]}, exact {[round(float(x), 5) for x in rq_ref]}, "
          f"noise {[round(float(x), 5) for x in rq_noise]} (needs 1 - membership < max(0.1, "
          f"1.3 x (1 - exact))); cosines of the principal angles between the two seeds "
          f"{[round(float(x), 4) for x in cosines]}; same-label over other-label distance on "
          f"{SEED_SAMPLE} rows: membership {r_fast:.4f}, exact {r_ref:.4f} (the reference "
          f"test's criterion needs exact < 0.8 to say anything)", flush=True)
    check(np.isfinite(fast).all()
          and 1.0 - rq_fast.min() < max(0.1, 1.3 * (1.0 - rq_ref.min())),
          "the membership seed lies as near the top of the graph's spectrum as the exact seed")
    check(1.0 - np.abs(rq_noise).max() > 0.5, "a seed of noise would fail that check")

    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.umap(h, device=cuda)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    print(f"[times] tl.umap at 1M, second run: {wall2:.4f}s; stages {stage_seconds(t)}",
          flush=True)
    return launches


def phase_big_kernels(ti, tu, tf, rep, partition, h, cuda) -> dict:
    """T14-T16 against their plain versions at the 1M path's shapes."""
    results = {}
    X = torch.from_numpy(rep).to(cuda)
    n, d = X.shape
    cent_np, assign_np = partition
    C = cent_np.shape[0]

    def report(name, shape, err, tol, ok, ms, plain_ms, bnd, lib=None, record=True):
        if record:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                             "library_ms": lib}
        print(f"[kernel] {name} {shape}: max_abs_err={err:.3e} ({tol}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 3)}", flush=True)
        check(ok, f"{name} {shape} within {tol}")

    # T15 on all rows with the partition's centroids
    cent = torch.from_numpy(cent_np).to(cuda)
    got = ti.kmeans_assign(X, cent)
    torch.cuda.synchronize()
    ref = ti.kmeans_assign_plain(X, cent)
    equal = float((got == ref).float().mean())
    rows = torch.nonzero(got != ref)[:, 0]
    x16, c16 = X[rows].bfloat16().double(), cent.bfloat16().double()
    csq = (cent.double() ** 2).sum(1)
    score = csq[None, :] - 2.0 * x16 @ c16.T
    gap = (score.gather(1, got[rows].long()[:, None]) - score.gather(1, ref[rows].long()[:, None]))
    scale = csq[got[rows].long()] + csq[ref[rows].long()] + (X[rows].double() ** 2).sum(1)
    near = bool((gap[:, 0].abs() <= 1e-5 * scale).all())
    worst = float((gap[:, 0].abs() / scale).max()) if len(rows) else 0.0
    report("kmeans_assign", (n, d, C), worst,
           f"equal on {equal:.6f} >= 0.999 of rows, the {len(rows)} others near-ties within "
           f"1e-5 of their scale", equal >= 0.999 and near,
           median_ms(lambda: ti.kmeans_assign(X, cent)),
           median_ms(lambda: ti.kmeans_assign_plain(X, cent)),
           bound(nbytes(X, cent, got), 2 * n * C * d, BF16_OPS_PER_S))

    # T14 on the first work items of the 1M layout, at the path's k and WNN's
    order, qids, ppos, pcnt, L = ti.build_ivf_layout(assign_np, cent_np, C, 8, 1024)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    Xs = X[to(order).long()].contiguous()
    q_all, pp_all, pc_all = to(qids), to(ppos), to(pcnt)
    mu_all = ti.item_means(Xs, q_all)
    q, pp_, pc, mu_ = (a[:IVF_ITEMS].contiguous() for a in (q_all, pp_all, pc_all, mu_all))
    ok_q = q >= 0
    item = torch.arange(q.shape[0], device=cuda)[:, None].expand_as(q)[ok_q]
    qsq = ((Xs[q[ok_q].long()] - mu_[item]) ** 2).sum(-1)
    pairs = float((ok_q.sum(1) * pc.sum(1)).sum())  # (query, candidate) pairs scored
    for k in (N_NEIGHBORS - 1, N_MULTI, WIDE_K):
        name = "ivf_search" if k + 1 <= 256 else "ivf_search_global"
        args = (Xs, q, pp_, pc, mu_, k, L, False)
        gp, gd = ti.ivf_search(*args)
        torch.cuda.synchronize()
        rp, rd = ti.ivf_search_plain(*args)
        same_inf = bool(torch.equal(torch.isinf(gd), torch.isinf(rd)))
        fin = torch.isfinite(rd[ok_q])
        csq_ = ((Xs[rp[ok_q].long()] - mu_[item][:, None, :]) ** 2).sum(-1)
        diff = (gd[ok_q] - rd[ok_q]).abs()
        within = bool((diff[fin] <= 1e-5 * (qsq[:, None] + csq_)[fin]).all())
        equal = float((gp[ok_q] == rp[ok_q]).float().mean())
        # each item reads its queries and its probed rows once and writes its results
        bytes_ = 4 * d * float(ok_q.sum() + pc.sum()) + nbytes(q, pp_, pc, mu_, gp, gd)
        report(name, f"(k+1={k + 1}, {q.shape[0]} items of {qids.shape[0]}, L={L}, "
               f"P={ppos.shape[1]})", float(diff[fin].max()),
               f"|dd2| <= 1e-5(|q-mu|^2+|c-mu|^2), equal positions {equal:.5f} >= 0.99",
               same_inf and within and equal >= 0.99,
               median_ms(lambda: ti.ivf_search(*args)),
               median_ms(lambda: ti.ivf_search_plain(*args), reps=3),
               bound(bytes_, 2 * pairs * d, F32_OPS_PER_S), record=k != N_MULTI)
        whole = median_ms(lambda: ti.ivf_search(Xs, q_all, pp_all, pc_all, mu_all, k, L, False),
                          reps=3)
        all_pairs = float(((q_all >= 0).sum(1) * pc_all.sum(1)).sum())
        print(f"[kernel] {name} over the whole 1M layout ({qids.shape[0]} items, "
              f"{all_pairs:.4g} pairs) at k+1={k + 1}: ms={whole:.3f}; by its operations "
              f"{2 * all_pairs * d / F32_OPS_PER_S * 1e3:.3f}", flush=True)

    # T16: one application over the graph's membership table
    tag = getattr(h.obsp["connectivities"], tf.MEMBERSHIP_TAG)
    op = tu.membership_operator(tag["idx"], tag["vals"], cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    Q = torch.randn((n, 10), generator=gen, device=cuda)
    Y = tu.membership_matvec(op, Q)
    torch.cuda.synchronize()
    Yp = tu.membership_matvec_plain(op, Q)
    rel = ((Y - Yp).abs().amax(0) / torch.linalg.norm(Yp, dim=0)).max().item()
    # the library call: a CSR of S = diag(s)(W + W^T)diag(s), one product
    k_ = op.idx.shape[1]
    src = torch.arange(n, device=cuda).repeat_interleave(k_)
    dst = op.idx.reshape(-1).clamp(min=0).long()
    w = op.vals.reshape(-1) * op.s[src] * op.s[dst]
    try:
        S = torch.sparse_coo_tensor(torch.stack([torch.cat([src, dst]), torch.cat([dst, src])]),
                                    torch.cat([w, w]), (n, n)).coalesce().to_sparse_csr()
        lib = library_ms(lambda: torch.sparse.mm(S, Q))
    except (RuntimeError, NotImplementedError) as e:
        print(f"[library] {str(e).splitlines()[0][:160]}", flush=True)
        lib = None
    report("membership_matvec", (n, k_, 10), (Y - Yp).abs().max().item(),
           f"largest column error {rel:.2e} <= 1e-5 of the column's norm", rel <= 1e-5,
           median_ms(lambda: tu.membership_matvec(op, Q)),
           median_ms(lambda: tu.membership_matvec_plain(op, Q), reps=3),
           # the function reads the table, s and Q and writes Y; the transposed
           # table is the kernel's own choice and no part of the bound
           bound(nbytes(op.idx, op.vals, op.s, Q, Y), 4 * op.vals.numel() * 10,
                 F32_OPS_PER_S), lib)
    return results


# ---------------------------------------------------------------------------
# repairs of earlier kernels: T13 above 8 components, T9 above kk = 194
# ---------------------------------------------------------------------------


def phase_repairs(tpp, tw, tk, tf, tu, kernels, mods, wnn_md, cuda) -> dict:
    """T13's run-time-dim kernel at 12 components against its plain version
    on the WNN graph, and ``pp.neighbors(mdata, n_multineighbors=300)`` over
    neighbour lists 300 wide on the first 2,000 cells, which takes T9's
    global-memory variant and T5's long-list variant (counted from that call
    alone), then T9's variant against plain at kk = 256, d = 50 on the exact
    neighbours of the same cells' RNA scores."""
    G = wnn_md.obsp["connectivities"].tocsr()
    a, b = tu.find_ab_params()
    heads, tails, eps, _, dc = tu.edge_schedule(G, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, tu.bucket_shifts(eps, N_EPOCHS), N_CELLS, cuda)
    gen = torch.Generator(device=cuda).manual_seed(12)
    emb0 = torch.rand((N_CELLS, 12), generator=gen, device=cuda) * 20 - 10
    negs = torch.randint(0, N_CELLS, (N_CELLS, 5), generator=gen, dtype=torch.int32, device=cuda)
    args = (torch.from_numpy(dc).to(cuda), negs, 0, tu.epoch_alpha(1.0, 0, N_EPOCHS), a, b, 1.0)
    eons_k, eons_p = edges.eps.clone(), edges.eps.clone()
    kernels.reset_launch_counts()
    out_k = tu.umap_epoch(emb0, torch.empty_like(emb0), edges, eons_k, *args)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()["umap_epoch"]
    out_p = tu.umap_epoch_plain(emb0, torch.empty_like(emb0), edges, eons_p, *args)
    err = (out_k - out_p).abs().max().item()
    pools = [edges.eps.clone() for _ in range(6)]
    buf = torch.empty_like(emb0)
    ms = median_ms(lambda: tu.umap_epoch(emb0, buf, edges, pools.pop(), *args))
    print(f"[kernel] umap_epoch at 12 components (n={N_CELLS}, E={len(eps)}; the kernel that "
          f"takes dim at run time): max_abs_err={err:.3e} (<= 1e-3; eons equal "
          f"{bool(torch.equal(eons_k, eons_p))}) ms={ms:.4f}", flush=True)
    check(err <= 1e-3 and torch.equal(eons_k, eons_p) and launched == 1,
          "umap_epoch at 12 components vs plain, max 1e-3")
    del edges, emb0, negs, out_k, out_p, pools, buf

    sub = {}
    for name, key in (("rna", "X_pca"), ("atac", "X_lsi")):
        h = Holder(None)
        h.obsm[key] = np.ascontiguousarray(mods[name].obsm[key][:WIDE_CELLS])
        h.n_obs = WIDE_CELLS
        tpp.neighbors(h, n_neighbors=WIDE_KK + 1, use_rep=key, device=cuda)
        sub[name] = h
    md = MuHolder(sub, WIDE_CELLS)
    with wnn_probe(tw, tk, tf, plain=False) as rec:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tpp.neighbors(md, n_multineighbors=WIDE_KK, device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    kk = rec["bandwidth"][0][0][0].shape[1]
    check(rec["knn_k"] == [WIDE_KK] * 2, f"WNN's candidates at k = {WIDE_KK} per modality")
    print(f"[wnn-wide] pp.neighbors(mdata, n_multineighbors={WIDE_KK}) over {list(sub)} on "
          f"{WIDE_CELLS} cells with neighbour lists {kk} wide in {wall:.2f}s launched "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(kk == WIDE_KK, f"the modality graphs hold {WIDE_KK} neighbours per cell")
    for name, count in WNN_WIDE_PATH.items():
        check(launches[name] == count, f"the wide WNN path launched {name} {count} times")
    D = md.obsp["distances"]
    per_row = np.diff(D.indptr)
    check(md.uns["neighbors"]["params"]["n_neighbors"] == WIDE_KK + 1
          and per_row.min() >= 1 and per_row.max() <= WIDE_KK + 2 and np.isfinite(D.data).all(),
          f"the wide WNN graph: at most {WIDE_KK + 2} fused neighbours per row, finite")

    rep = torch.from_numpy(sub["rna"].obsm["X_pca"]).to(cuda)
    d2 = torch.cdist(rep.double(), rep.double())
    d2.fill_diagonal_(float("inf"))
    NI = torch.sort(torch.topk(d2, WIDE_KK_KERNEL, dim=1, largest=False).indices,
                    dim=1).values.int().contiguous()
    bbox = float(torch.linalg.norm(rep.max(dim=0).values - rep.min(dim=0).values))
    args = (NI, *tw._bandwidth_tables(NI, rep), float(WIDE_CELLS), bbox, 20,
            tw._auto_nn_stride(WIDE_KK_KERNEL))
    kernels.reset_launch_counts()
    out = tw.wnn_bandwidth(*args)
    torch.cuda.synchronize()
    check(kernels.launch_counts()["wnn_bandwidth_global"] == 1
          and kernels.launch_counts()["wnn_bandwidth"] == 0,
          "kk = 256 takes the global-memory variant of T9")
    ref = tw.wnn_bandwidth_plain(*args)
    rel = (out - ref).abs() / ref.abs().clamp(min=1e-30)
    ms = median_ms(lambda: tw.wnn_bandwidth(*args), reps=3)
    plain_ms = median_ms(lambda: tw.wnn_bandwidth_plain(*args), reps=1)
    bnd = wnn_bound("wnn_bandwidth_global", args, out)
    print(f"[kernel] wnn_bandwidth_global {tuple(args[0].shape)} d={args[2].shape[1]}: "
          f"max_abs_err={(out - ref).abs().max().item():.3e} (rtol 1e-5 on >= 99.9% of cells, "
          f"1e-3 on all; largest rel err {rel.max().item():.2e}) ms={ms:.3f} "
          f"plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']})",
          flush=True)
    check((rel <= 1e-5).float().mean().item() >= 0.999 and rel.max().item() <= 1e-3,
          "wnn_bandwidth_global within rtol 1e-5 on >= 99.9% of cells, 1e-3 on all")
    return launches, {"wnn_bandwidth_global": {
        "max_abs_err": (out - ref).abs().max().item(), "ms": ms, "plain_ms": plain_ms, **bnd,
        "library_ms": None}}


# ---------------------------------------------------------------------------
# repairs of this slice: lists longer than 256 (T5, T14), the asymmetric
# UMAP epoch (T22)
# ---------------------------------------------------------------------------


def phase_knn_wide(tpp, tk, kernels, rep, labels, cuda):
    """``pp.neighbors(n_neighbors=301)`` on the 100k RNA scores, counted
    alone (T5's long-list variant at k + 1 = 301), then that variant against
    plain at the path's arguments (approx, euclidean)."""
    h = Holder(None)
    h.obsm["X_pca"], h.n_obs = rep, rep.shape[0]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tpp.neighbors(h, n_neighbors=WIDE_K + 1, use_rep="X_pca", device=cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    D = h.obsp["distances"]
    share = label_share(D, labels)
    print(f"[knn-wide] pp.neighbors(n_neighbors={WIDE_K + 1}) of the RNA scores "
          f"{rep.shape} in {wall:.4f}s launched { {k: v for k, v in launches.items() if v} }; "
          f"{D.nnz} distances, planted-label share {share:.4f}", flush=True)
    for name in ("knn_topk_global", "knn_topk", "smooth_knn_membership"):
        check(launches[name] == KNN_WIDE_PATH[name],
              f"pp.neighbors({WIDE_K + 1}) launched {name} {KNN_WIDE_PATH[name]} times")
    check((np.diff(D.indptr) == WIDE_K).all() and np.isfinite(D.data).all(),
          f"{WIDE_K} finite distances per row")

    op, sq = tk._operand(torch.from_numpy(rep).to(cuda), "euclidean", True)
    args = (op, sq, WIDE_K, False, True)
    gi, gd = tk.knn_topk(*args)
    torch.cuda.synchronize()
    ri, rd = tk.knn_topk_plain(*args)
    scale = sq[:, None] + sq[ri.long()]
    ok = bool(((gd.double() ** 2 - rd.double() ** 2).abs() <= 1e-5 * scale).all())
    equal = (gi == ri).float().mean().item()
    head = (gi[:, :N_NEIGHBORS] == tk.knn_topk(op, sq, N_NEIGHBORS - 1, False, True)[0]
            ).float().mean().item()
    ms = median_ms(lambda: tk.knn_topk(*args), reps=3)
    plain_ms = median_ms(lambda: tk.knn_topk_plain(*args), reps=1)
    n_, d_ = op.shape
    bnd = bound(nbytes(op, sq, gi, gd), 2 * n_ * n_ * d_, BF16_OPS_PER_S)
    err = (gd - rd).abs().max().item()
    print(f"[kernel] knn_topk_global (n={n_}, d={d_}, approx, k+1={WIDE_K + 1}): "
          f"max_abs_err={err:.3e} (|dd2| <= 1e-5(|q|^2+|c|^2), equal indices {equal:.5f} >= 0.99; "
          f"its first {N_NEIGHBORS} columns equal T5's at k+1={N_NEIGHBORS} on {head:.5f}) "
          f"ms={ms:.3f} plain_ms={plain_ms:.3f} bound_ms={bnd['bound_ms']:.4f} "
          f"({bnd['bound_by']}) library_ms=None", flush=True)
    check(ok and equal >= 0.99 and head >= 0.99, "knn_topk_global vs plain")
    return launches, {"knn_topk_global": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                          **bnd, "library_ms": None}}


def phase_ivf_wide(ti, kernels, X, cuda):
    """``ivf_knn(k=300)`` on the 1M representation from the cached partition
    (no union: ``pp.neighbors`` would add the host union of 300M entries),
    counted alone: T14's long-list variant once, no k-means."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    idx, dists = ti.ivf_knn(X, WIDE_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    idx19 = ti.ivf_knn(X, N_NEIGHBORS - 1)[0]
    agree = float((idx[:, :N_NEIGHBORS] == idx19).float().mean())
    n = X.shape[0]
    print(f"[knn-wide] ivf_knn(k={WIDE_K}) of {tuple(X.shape)} in {wall:.4f}s launched "
          f"{ {k: v for k, v in launches.items() if v} }; its first {N_NEIGHBORS} columns "
          f"agree with the k = 19 run on {agree:.5f} of entries; -1 in "
          f"{float((idx < 0).float().mean()):.2e} of places", flush=True)
    for name in ("ivf_search_global", "ivf_search", "kmeans_assign"):
        check(launches[name] == KNN_WIDE_PATH[name],
              f"ivf_knn({WIDE_K}) launched {name} {KNN_WIDE_PATH[name]} times")
    check(bool((idx[:, 0] == torch.arange(n, device=cuda)).all())
          and bool((dists[:, 0] == 0).all()), "ivf_knn(300): self in column 0")
    fin = torch.isfinite(dists[:, 1:]) & (idx[:, 1:] >= 0)
    check(bool((dists[:, 2:] >= dists[:, 1:-1])[fin[:, 1:]].all()), "ivf_knn(300) ascending")
    check(agree >= 0.99, "k = 300 and k = 19 agree on >= 99% of the first 20 columns")
    del idx, dists, idx19
    return launches


def phase_umap_asym(tu, tk, tf, kernels, rna_h, labels, cuda):
    """``ops.umap.umap_embed`` of the directed membership graph of the 100k
    RNA path (T6's table before the union: each edge one way), 200 epochs,
    counted alone: T22 every epoch, no T13; one epoch of T22 against plain
    from the spectral layout with shared negatives; the layout's planted-label
    share against the same run through T22's plain version, against the
    layout ``tl.umap`` makes of the same graph's union (T13) at the same
    seed, and against the graph's own share."""
    tag = getattr(rna_h.obsp["connectivities"], tf.MEMBERSHIP_TAG)
    idx, vals = tag["idx"], tag["vals"]
    n, k = idx.shape
    rows = np.repeat(np.arange(n), k)
    keep = (idx.reshape(-1) >= 0) & (idx.reshape(-1) != rows) & (vals.reshape(-1) > 0)
    W = sp.csr_matrix((vals.reshape(-1)[keep], (rows[keep], idx.reshape(-1)[keep])),
                      shape=(n, n))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    emb = tu.umap_embed(W, n_epochs=N_EPOCHS, random_state=42, device=cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    saved = tu.umap_epoch_asym
    tu.umap_epoch_asym = tu.umap_epoch_asym_plain
    try:
        emb_p = tu.umap_embed(W, n_epochs=N_EPOCHS, random_state=42, device=cuda)
    finally:
        tu.umap_epoch_asym = saved
    union = tu.umap_embed(rna_h.obsp["connectivities"], n_epochs=N_EPOCHS, random_state=42,
                          assume_symmetric=True, device=cuda)
    share, own = knn_share(tk, emb, labels, cuda), label_share(W, labels)
    share_p, share_u = knn_share(tk, emb_p, labels, cuda), knn_share(tk, union, labels, cuda)
    print(f"[umap-asym] umap_embed of the directed RNA membership graph ({W.nnz} edges, "
          f"{int((W != W.T).nnz)} entries differ from the transpose) in {wall:.4f}s launched "
          f"{ {k_: v for k_, v in launches.items() if v} }; planted-label share of the 15 "
          f"nearest cells in 2-D {share:.4f} (the plain T22 run {share_p:.4f}; tl.umap's T13 "
          f"layout of the union graph {share_u:.4f}); the graph's own {own:.4f} (the layout "
          f"reads {share / own:.3f} of it)", flush=True)
    for name, count in UMAP_ASYM_PATH.items():
        check(launches[name] == count, f"the asymmetric UMAP launched {name} {count} times")
    check(emb.shape == (n, 2) and np.isfinite(emb).all(), "asymmetric X_umap shape, finite")
    check(abs(share - share_p) <= 0.02, "asymmetric UMAP kernel vs plain share within 0.02")
    # at 200 epochs this graph's layouts reach 0.70-0.80 of its own share, the
    # union's through T13 too (0.73-0.80 on an H100), so the layout is held to
    # T13's layout of the same graph, not to the graph itself
    check(share >= 0.8 * share_u, "asymmetric UMAP share >= 0.8 x tl.umap's of the union")

    a, b = tu.find_ab_params()
    heads, tails, eps, _, _ = tu.edge_schedule(W, N_EPOCHS)
    edges = tu.umap_edges(heads, tails, eps, np.zeros(len(eps), np.int8), n, cuda)
    by_tail = tu.umap_tails(edges)
    emb0 = torch.from_numpy(tu.spectral_init(W, 2, seed=42, device=cuda)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(22)
    negs = torch.randint(0, n, (n, 5), generator=gen, dtype=torch.int32, device=cuda)
    args = (negs, 0, tu.epoch_alpha(1.0, 0, N_EPOCHS), a, b, 1.0)
    eons = edges.eps.clone()
    eo_k, eo_p = torch.empty_like(eons), torch.empty_like(eons)
    out_k = tu.umap_epoch_asym(emb0, torch.empty_like(emb0), edges, by_tail, eons, eo_k, *args)
    torch.cuda.synchronize()
    out_p = tu.umap_epoch_asym_plain(emb0, torch.empty_like(emb0), edges, by_tail, eons, eo_p,
                                     *args)
    err = (out_k - out_p).abs().max().item()
    same_eons = bool(torch.equal(eo_k, eo_p))
    buf = torch.empty_like(emb0)
    ms = median_ms(lambda: tu.umap_epoch_asym(emb0, buf, edges, by_tail, eons, eo_k, *args))
    plain_ms = median_ms(lambda: tu.umap_epoch_asym_plain(emb0, buf, edges, by_tail, eons,
                                                          eo_p, *args))
    # the function reads each edge (head, tail, eps, eons) and the layout and
    # writes the layout and the eons; the tail order is the kernel's own. Per
    # due edge and per negative about 30 operations (two powf among them)
    E, due = len(eps), int((eps <= 1.0).sum())
    bnd = bound(nbytes(edges.indptr, edges.heads, edges.tails, edges.eps, eons, negs, emb0,
                       out_k, eo_k), 30 * (due + negs.numel()), F32_OPS_PER_S)
    print(f"[kernel] umap_epoch_asym (n={n}, E={E}, due at epoch 0 {due}): max_abs_err="
          f"{err:.3e} (<= 1e-3; eons equal {same_eons}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) library_ms=None", flush=True)
    check(err <= 1e-3 and same_eons, "umap_epoch_asym vs plain, max 1e-3")
    return launches, {"umap_epoch_asym": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                          **bnd, "library_ms": None}}


# ---------------------------------------------------------------------------
# DSB: bench.py's mode `dsb` (CLR, then DSB of the unfiltered droplets) at the
# bench's size and at 100,000 cells; T21 against plain
# ---------------------------------------------------------------------------


def make_citeseq(n_cells, n_empty, n_prot=CITE_PROT, seed=0):
    """bench.py::_make_citeseq: an unfiltered CITE-seq droplet pool, real
    cells (high RNA UMI, protein signal over ambient) and empty droplets
    (low UMI, ambient only); also the signal's columns."""
    rng = np.random.default_rng(seed)
    n = n_cells + n_empty
    is_cell = np.zeros(n, bool)
    is_cell[:n_cells] = True
    rna_umi = np.where(is_cell, rng.poisson(3000, n), rng.poisson(40, n))
    # one gene is enough for the log10-UMI droplet classifier
    rna = sp.csr_matrix(rna_umi.astype(np.float32)[:, None])
    ambient = rng.gamma(2.0, 2.0, n_prot)
    prot = rng.poisson(ambient[None, :], (n, n_prot)).astype(np.float32)
    signal = rng.poisson(30.0, (n_cells, n_prot // 3)).astype(np.float32)
    cols = rng.choice(n_prot, n_prot // 3, replace=False)
    prot[:n_cells, cols] += signal
    return rna, prot, cols


@contextmanager
def dsb_plain(tg, dsp):
    """Route T21 and T7 to their plain versions for the block (only this
    script swaps the module attributes; they are restored after)."""
    saved = tg.gmm_background_means, dsp.row_sums
    try:
        tg.gmm_background_means, dsp.row_sums = tg.background_means_plain, dsp.row_sums_plain
        yield
    finally:
        tg.gmm_background_means, dsp.row_sums = saved


def rows_close(got, ref):
    """The largest row error, and whether it is within 1e-4 on >= 99.9% of the
    rows and 1e-2 on all: the same float32 steps summed in another order,
    where a fit that stops one iteration apart moves its cell a little."""
    row = np.abs(np.asarray(got, np.float64) - ref).max(axis=1)
    return float(row.max()), bool((row <= 1e-4).mean() >= 0.999 and row.max() <= 1e-2)


def phase_dsb(tpt, tg, dsp, kernels, profiling, cuda, n_cells, n_empty, branches: bool):
    """bench.py::_run_dsb's path on the device, counted alone: clr of the
    proteins (on a copy), then dsb of the unfiltered holder with the bench's
    ranges. Then the warm walls with the stage split, the busy share, the
    whole output against the plain path from the same uniforms, the planted
    signal, the per-cell offset with and without denoising; with
    ``branches`` also the isotype-control and clipping branches. Returns the
    launches and the standardised cells (T21's input)."""
    t0 = time.perf_counter()
    rna, prot, cols = make_citeseq(n_cells, n_empty, seed=SEED)
    names = np.arange(n_cells + n_empty).astype(str)
    md = MuHolder({"rna": ObsHolder(rna, names), "prot": ObsHolder(prot, names)}, len(names))
    tag = f"{n_cells}+{n_empty}"
    print(f"[data] CITE-seq {tag} droplets x {CITE_PROT} proteins "
          f"({prot.nbytes / 2**20:.0f} MiB of counts) made in {time.perf_counter() - t0:.1f}s",
          flush=True)

    def run(md_, **kw):
        return tpt.pp.dsb(md_, device=cuda, **{**DSB_KW, **kw})

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tpt.pp.clr(ObsHolder(prot.copy(), names), device=cuda)
    t1 = time.perf_counter()
    out = run(md)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    X = out.mod["prot"].X
    print(f"[dsb] {tag}: clr {t1 - t0:.4f}s, dsb {t2 - t1:.4f}s (first call); launches "
          f"{ {k: v for k, v in launches.items() if v} }; {out.n_obs} cells kept; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    for name, count in DSB_PATH.items():
        check(launches[name] == count, f"dsb {tag} launched {name} {count} times")
    check(out.n_obs == n_cells and X.shape == (n_cells, CITE_PROT) and X.dtype == np.float32
          and np.isfinite(X).all(), f"dsb {tag}: every cell kept, float32, finite")

    walls, splits = [], []
    for _ in range(2):
        with profiling.collect() as t:
            t0 = time.perf_counter()
            run(md)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        splits.append(stage_seconds(t))
    print(f"[times] dsb {tag} warm wall s {[round(w, 4) for w in walls]}; stages {splits}",
          flush=True)
    print_profile(f"dsb {tag}", profiled(lambda: run(md)))

    with dsb_plain(tg, dsp):
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        ref = run(md).mod["prot"].X
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        check(not any(kernels.launch_counts().values()), "the plain dsb launched no kernel")
    err, ok = rows_close(X, ref)
    amb = np.setdiff1d(np.arange(CITE_PROT), cols)
    sig_min, amb_max = float(X[:, cols].mean(0).min()), float(X[:, amb].mean(0).max())
    raw = run(md, denoise_counts=False).mod["prot"].X
    off0, off1 = float(np.median(raw, axis=1).std()), float(np.median(X, axis=1).std())
    print(f"[dsb] {tag}: against the plain path from the same uniforms (one warm run "
          f"{t_plain:.4f}s) largest row error {err:.2e} (1e-4 on >= 99.9% of rows, 1e-2 on "
          f"all); column means: planted signal >= {sig_min:.4f}, ambient <= {amb_max:.4f}; "
          f"per-cell median offset std {off0:.4f} without denoising, {off1:.4f} with", flush=True)
    check(ok, f"dsb {tag} vs the plain path")
    check(sig_min > amb_max + 1.0, f"dsb {tag}: the planted signal stands above the ambient")
    check(off1 < off0, f"dsb {tag}: denoising shrinks the per-cell offset")

    if branches:
        import warnings

        iso = ["p0", "p1", "p2", "absent"]
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            kernels.reset_launch_counts()
            unclipped = run(md, isotype_controls=iso).mod["prot"].X
            clipped = run(md, isotype_controls=iso, quantile_clipping=True).mod["prot"].X
        q = np.quantile(unclipped, (0.001, 0.9995))
        clip_err = float(np.abs(clipped - np.clip(unclipped, q.min(), q.max())).max())
        warned = any("isotype controls are not present" in str(x.message) for x in w)
        print(f"[dsb] {tag} isotype controls {iso} (one absent: warned {warned}) and quantile "
              f"clipping (0.001, 0.9995): {clipped.dtype}, against np.clip at np.quantile of "
              f"the unclipped run {clip_err:.2e}; T21 launched "
              f"{kernels.launch_counts()['gmm_background_means']} times", flush=True)
        # 1e-5: the two runs' least squares may round apart (a float32 solver)
        check(warned and clipped.dtype == np.float64 and clip_err <= 1e-5
              and np.isfinite(unclipped).all()
              and kernels.launch_counts()["gmm_background_means"] == 2,
              "dsb's isotype-control and clipping branches")
    del md, out, ref
    torch.cuda.empty_cache()
    return launches, raw


def scaled_counts(n, d, seed):
    """T21's input at another panel width: log(counts + 10) of cells
    standardised by 20,000 empty droplets (bench.py's ambient and signal)."""
    rng = np.random.default_rng(seed)
    ambient = rng.gamma(2.0, 2.0, d)
    es = np.log(rng.poisson(ambient, (20_000, d)) + 10.0)
    cells = rng.poisson(ambient, (n, d)).astype(np.float64)
    cols = rng.choice(d, d // 3, replace=False)
    cells[:, cols] += rng.poisson(30.0, (n, len(cols)))
    return ((np.log(cells + 10) - es.mean(0)) / es.std(0, ddof=1)).astype(np.float32)


def phase_gmm_kernel(tg, inputs, cuda) -> dict:
    """T21 against its plain version on the standardised cells of the dsb
    path (10,000 and 100,000 x 140) and at 10,000 x 300: the largest error
    where both ran the same iterations and picked the same fit, the shares
    that did, both times, and the bound from the iterations actually run."""
    results = {}
    for label, X in inputs:
        Xt = torch.from_numpy(np.ascontiguousarray(X)).to(cuda)
        n, d = Xt.shape
        u = tg.draw_init_noise(n, d, seed=1, device=cuda)
        got = tg.gmm_background_means(Xt, u)
        torch.cuda.synchronize()
        ref = tg.background_means_plain(Xt, u)
        same_fit = (got[1] == ref[1]).float().mean().item()
        same_it = (got[2] == ref[2]).all(0).float().mean().item()
        alike = (got[1] == ref[1]) & (got[2] == ref[2]).all(0)
        err = (got[0] - ref[0])[alike].abs().max().item()
        ms = median_ms(lambda: tg.gmm_background_means(Xt, u))
        plain_ms = median_ms(lambda: tg.background_means_plain(Xt, u), reps=3)
        # per value and iteration of a fit: about 30 float32 operations and 5
        # of the special-function unit (4 exp, 1 log); X and the uniforms read
        # once, the three outputs written once
        value_iters = float(got[2].double().sum()) * d
        by_f32 = 30 * value_iters / F32_OPS_PER_S * 1e3
        by_sfu = 5 * value_iters / SFU_OPS_PER_S * 1e3
        by_bytes = nbytes(Xt, u, *got) / HBM_BYTES_PER_S * 1e3
        bnd = {"bound_ms": max(by_f32, by_sfu, by_bytes),
               "bound_by": "bytes" if by_bytes >= max(by_f32, by_sfu) else "operations"}
        its = got[2].float()
        print(f"[kernel] gmm_background_means {label} ({n}x{d}): max_abs_err={err:.3e} (<= 1e-4 "
              f"where the fit and the iterations agree; the same fit on {same_fit:.5f}, equal "
              f"iterations on {same_it:.5f}, both >= 0.999) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}: f32 {by_f32:.4f}, special "
              f"functions {by_sfu:.4f}, bytes {by_bytes:.4f}) library_ms=None; iterations tied "
              f"mean {its[0].mean().item():.2f} max {int(its[0].max())}, full mean "
              f"{its[1].mean().item():.2f} max {int(its[1].max())}; tied wins on "
              f"{got[1].float().mean().item():.4f}", flush=True)
        check(same_fit >= 0.999 and same_it >= 0.999 and err <= 1e-4,
              f"gmm_background_means {label} vs plain")
        if "gmm_background_means" not in results:
            results["gmm_background_means"] = {"max_abs_err": err, "ms": ms,
                                               "plain_ms": plain_ms, **bnd, "library_ms": None}
        del Xt, u, got, ref
    return results


# ---------------------------------------------------------------------------
# MOFA: T17-T20, the full-batch fit of bench.py's mode `mofa`, the e2e's SVI
# stage at 100,000 cells, and SVI at 1,000,000 cells
# ---------------------------------------------------------------------------


def mofa_bench_views(seed: int = 0):
    """bench.py::_mofa_iters_per_sec's data: planted Z (N, K), two gaussian
    views Z·W + 0.5·noise."""
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(MOFA_N, MOFA_K)).astype(np.float32)
    Ys = [(Z @ rng.normal(size=(MOFA_K, d)) + 0.5 * rng.normal(size=(MOFA_N, d))
           ).astype(np.float32) for d in MOFA_DS]
    return Z, Ys


def canonical_correlations(A: torch.Tensor, B: torch.Tensor) -> np.ndarray:
    """Canonical correlations of the column spaces of A and B (centred),
    in float64 on A's device."""
    A, B = A.double(), B.double().to(A.device)
    Qa = torch.linalg.qr(A - A.mean(dim=0)).Q
    Qb = torch.linalg.qr(B - B.mean(dim=0)).Q
    return torch.linalg.svdvals(Qa.T @ Qb).cpu().numpy()


def phase_mofa_kernels(tmo, Ys, cuda) -> dict:
    """T17-T20 against their plain versions at the bench's 10,000 x 3000
    (unmasked, which the JSON line records, and masked) and at the SVI
    batch's 50,000 x 256."""
    results = {}
    gen = torch.Generator(device=cuda).manual_seed(17)

    def report(name, shape, err, tol, ok, k_fn, p_fn, bnd, lib_fn=None, record=False):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn)
        lib = library_ms(lib_fn) if lib_fn is not None else None
        if record:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                             "library_ms": lib}
        print(f"[kernel] {name} {shape}: max_abs_err={err:.3e} ({tol}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms={lib if lib is None else round(lib, 4)}", flush=True)
        check(ok, f"{name} {shape} within {tol}")

    def within(got, ref, scale):
        return bool(((got - ref).abs() <= 1e-5 * scale + 1e-30).all())

    cases = [(torch.from_numpy(Ys[1]).to(cuda), True),
             (torch.randn((MOFA_BATCH, MOFA_COLS), generator=gen, device=cuda), False)]
    for E, main in cases:
        n, d = E.shape
        shape = f"{n}x{d}"
        Z = torch.randn((n, MOFA_K), generator=gen, device=cuda)
        SW = 0.1 * torch.randn((d, MOFA_K), generator=gen, device=cuda)
        B = (torch.rand((n, d), generator=gen, device=cuda) > 0.1).float()
        zk, swk = Z[:, 3], SW[:, 3]  # strided columns, as the sweeps hand them

        # T17: u = zk @ E, and the column sums of E^2
        u = tmo.col_dot(E, zk)
        torch.cuda.synchronize()
        ref = tmo.col_dot_plain(E, zk)
        report("mofa_col_dot", shape, (u - ref).abs().max().item(), "1e-5 x |z|.|E|",
               within(u, ref, zk.abs() @ E.abs()), lambda: tmo.col_dot(E, zk),
               lambda: tmo.col_dot_plain(E, zk),
               bound(nbytes(E, u) + 4 * n, 2 * n * d, F32_OPS_PER_S),
               lambda: torch.mv(E.T, zk), record=main)
        ss = tmo.col_dot(E)
        ref = tmo.col_dot_plain(E)
        report("mofa_col_dot", f"{shape} squares", (ss - ref).abs().max().item(),
               "rtol 1e-5", within(ss, ref, ref), lambda: tmo.col_dot(E),
               lambda: tmo.col_dot_plain(E), bound(nbytes(E, ss), 2 * n * d, F32_OPS_PER_S),
               lambda: (E * E).sum(dim=0))
        check(torch.equal(ss, tmo.col_dot(E)) and torch.equal(u, tmo.col_dot(E, zk)),
              f"mofa_col_dot {shape} gives the same bits twice")

        # T18: the posterior of factor 3 of view 1, full-batch and scaled,
        # with a scalar (unmasked) and a per-feature (masked) z2
        tau = 1.0 / E.var(dim=0)
        zz = Z * Z
        z2 = 1.0 + zz
        hyper = [torch.full((2, MOFA_K), v, device=cuda)
                 for v in (1.0, 0.0, float(np.log(0.99)), float(np.log(0.01)))]
        Ws = [torch.zeros((d, MOFA_K), device=cuda), torch.ones((d, MOFA_K), device=cuda),
              torch.full((d, MOFA_K), 0.5, device=cuda), SW.clone()]
        for tag, z2_k, zz_k, scale in (
            ("unmasked", z2.sum(dim=0)[3], zz.sum(dim=0)[3], None),
            ("masked, scaled", (z2.T @ B)[3] * 20.0, (zz.T @ B)[3] * 20.0, 20.0),
        ):
            Wk, Wp = [w.clone() for w in Ws], [w.clone() for w in Ws]
            dk = tmo.w_posterior(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wk, scale=scale)
            torch.cuda.synchronize()
            dp = tmo.w_posterior_plain(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wp, scale=scale)
            errs = [(g - r).abs() for g, r in zip([dk, *Wk], [dp, *Wp])]
            ok = all(bool((e <= 1e-6 + 1e-5 * r.abs()).all())
                     for e, r in zip(errs, [dp, *Wp]))
            # per feature: u, tau, the old sw and (masked) z2, zz in; 4 columns and delta out
            bytes_ = 4 * d * (8 + (2 if z2_k.dim() else 0))
            report("mofa_w_posterior", f"D={d} {tag}", max(e.max().item() for e in errs),
                   "rtol 1e-5 atol 1e-6, every output", ok,
                   lambda: tmo.w_posterior(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wk, scale=scale),
                   lambda: tmo.w_posterior_plain(u, tau, z2_k, zz_k, *hyper, 1, 3, *Wp,
                                                 scale=scale),
                   bound(bytes_, 40 * d, F32_OPS_PER_S), record=main and scale is None)

        # T19: r = E @ t, and with the mask B @ t1, B @ t2 from the same pass
        r = tmo.row_dot(E, swk)
        torch.cuda.synchronize()
        ref = tmo.row_dot_plain(E, swk)
        report("mofa_row_dot", shape, (r - ref).abs().max().item(), "1e-5 x |E|.|t|",
               within(r, ref, E.abs() @ swk.abs()), lambda: tmo.row_dot(E, swk),
               lambda: tmo.row_dot_plain(E, swk),
               bound(nbytes(E, r) + 4 * d, 2 * n * d, F32_OPS_PER_S),
               lambda: torch.mv(E, swk), record=main)
        t1, t2 = SW[:, 1], SW[:, 2]
        got = tmo.row_dot(E, swk, B, t1, t2)
        torch.cuda.synchronize()
        refs = tmo.row_dot_plain(E, swk, B, t1, t2)
        scales = (E.abs() @ swk.abs(), B @ t1.abs(), B @ t2.abs())
        report("mofa_row_dot", f"{shape} masked",
               max((g - q).abs().max().item() for g, q in zip(got, refs)),
               "1e-5 x |E|.|t|, |B|.|t1|, |B|.|t2|",
               all(within(g, q, s_) for g, q, s_ in zip(got, refs, scales)),
               lambda: tmo.row_dot(E, swk, B, t1, t2),
               lambda: tmo.row_dot_plain(E, swk, B, t1, t2),
               bound(nbytes(E, B, *got) + 12 * d, 6 * n * d, F32_OPS_PER_S))

        # T20: E += x (x) y in place (times B where masked); timed on a copy
        for tag, Bm in (("", None), (" masked", B)):
            Ek, Ep = E.clone(), E.clone()
            tmo.rank1_update(Ek, zk, swk, Bm)
            torch.cuda.synchronize()
            tmo.rank1_update_plain(Ep, zk, swk, Bm)
            err = (Ek - Ep).abs().max().item()
            report("mofa_rank1_update", shape + tag, err, "1e-6 x (|E| + |x y|)",
                   bool(((Ek - Ep).abs() <= 1e-6 * (Ep.abs() + (zk[:, None] * swk[None, :]).abs())
                         ).all()),
                   lambda: tmo.rank1_update(Ek, zk, swk, Bm),
                   lambda: tmo.rank1_update_plain(Ep, zk, swk, Bm),
                   bound(2 * nbytes(E) + (nbytes(B) if Bm is not None else 0) + 4 * (n + d),
                         (3 if Bm is not None else 2) * n * d, F32_OPS_PER_S),
                   (lambda: Ek.addr_(zk, swk)) if Bm is None else None,
                   record=main and Bm is None)
            del Ek, Ep
        del E, Z, SW, B
    torch.cuda.empty_cache()
    return results


@contextmanager
def plain_kernels(module, names):
    """Route ``module``'s kernel wrappers to their plain versions for the
    block (only this script swaps the module attributes; they are restored
    after)."""
    saved = {n: getattr(module, n) for n in names}
    try:
        for n in names:
            setattr(module, n, getattr(module, f"{n}_plain"))
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


MOFA_WRAPPERS = ("col_dot", "w_posterior", "row_dot", "rank1_update", "bound_refresh")


def check_launches(launches, want: dict, what: str) -> None:
    got = {k: launches[k] for k in want}
    check(got == want, f"{what} launched {want}, read {got}")


def leaf_error(got: dict, ref: dict):
    """The largest error of any leaf of a state relative to the leaf's largest entry."""
    worst, worst_leaf = 0.0, ""
    for key, val in ref.items():
        for i, r in enumerate(val if isinstance(val, list) else [val]):
            if r is None:
                continue
            g = got[key][i] if isinstance(val, list) else got[key]
            rel = ((g - r).abs().max() / r.abs().max().clamp(min=1e-30)).item()
            if rel > worst:
                worst, worst_leaf = rel, f"{key}[{i}]"
    return worst, worst_leaf


def phase_mofa_full(tm, tmo, kernels, profiling, Zp, Ys, cuda):
    """bench.py's mode `mofa`: 2 warm-up sweeps, then 50, counted and timed
    from ``fit_mofa`` alone."""
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(convergence_mode="slow", elbo_every=1000, device=cuda)
    t0 = time.perf_counter()
    tm.fit_mofa(Ys, cfg, n_iterations=MOFA_WARM, min_iterations=MOFA_WARM, **kw)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profiling.collect() as t:
        t0 = time.perf_counter()
        again = tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS, **kw)
        wall_staged = time.perf_counter() - t0
    cc = canonical_correlations(torch.from_numpy(res.Z).to(cuda), torch.from_numpy(Zp))
    print(f"[mofa] fit_mofa {MOFA_N} x {MOFA_DS}, K={MOFA_K}: warm-up {MOFA_WARM} sweeps "
          f"{t_warm:.3f}s; {MOFA_SWEEPS} sweeps in {wall:.4f}s = {MOFA_SWEEPS / wall:.2f} "
          f"sweeps/s (upload, init and the R2 statistics included, as the bench times them); "
          f"peak device memory {peak:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[mofa] stage split of a second fit under the stage timers ({wall_staged:.4f}s): "
          f"{stage_seconds(t)}", flush=True)
    print(f"[mofa] canonical correlations of Z with the planted Z: min {cc.min():.4f}, "
          f"median {float(np.median(cc)):.4f}; ELBO after sweep 1 {res.elbo_history[0]:.6g}, "
          f"after {MOFA_SWEEPS} {res.elbo_history[-1]:.6g}; r2_total "
          f"{[round(float(v), 4) for v in res.r2_total[0]]}", flush=True)
    check_launches(launches, mofa_launches(MOFA_SWEEPS), f"{MOFA_SWEEPS} full-batch sweeps")
    check(res.Z.shape == (MOFA_N, MOFA_K) and np.isfinite(res.Z).all()
          and all(np.isfinite(w).all() for w in res.W), "MOFA Z and W shapes, finite")
    check(res.n_iterations == MOFA_SWEEPS, f"fit_mofa ran {MOFA_SWEEPS} sweeps")
    check(cc.min() > 0.9, "smallest canonical correlation of Z with the planted Z > 0.9")
    same = np.array_equal(res.Z, again.Z) and all(
        np.array_equal(a, b) for a, b in zip(res.W + res.tau, again.W + again.tau)) \
        and np.array_equal(res.elbo_history, again.elbo_history)
    check(same, "two fits give identical bits (Z, W, tau, ELBO)")

    # one sweep through the kernels against the plain path, from the state
    # after two sweeps: every leaf within 1e-4 of the leaf's largest entry
    onehot = np.ones((MOFA_N, 1), np.float32)
    cfg1 = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"), n_groups=1)
    step = tm.make_step(cfg1, list(MOFA_DS), MOFA_N, [False, False])
    state = tm._init_state(Ys, [None, None], onehot, cfg1, device=cuda)
    for _ in range(2):
        state, _ = step(state)
    got, elbo_k = step(state)
    with plain_kernels(tmo, MOFA_WRAPPERS):
        kernels.reset_launch_counts()
        ref, elbo_p = step(state)
        check(not any(kernels.launch_counts().values()), "the plain sweep launched no kernel")
    worst, worst_leaf = leaf_error(got, ref)
    elbo_rel = abs(float(elbo_k) - float(elbo_p)) / abs(float(elbo_p))
    print(f"[mofa] one sweep, kernels against the plain path from the same state: largest "
          f"leaf error {worst:.2e} of the leaf's largest entry ({worst_leaf}), ELBO rel "
          f"{elbo_rel:.2e} (<= 1e-4)", flush=True)
    check(worst <= 1e-4 and elbo_rel <= 1e-4, "one MOFA sweep vs the plain path within 1e-4")
    del state, got, ref

    # the ELBO of every sweep: coordinate ascent never lets it fall
    e = tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS,
                    convergence_mode="slow", elbo_every=1, device=cuda).elbo_history
    drop = float((-(np.diff(e)) / np.abs(e[:-1])).max())
    print(f"[mofa] ELBO of each of {len(e)} sweeps: largest relative fall {max(drop, 0):.2e} "
          f"(<= 1e-5)", flush=True)
    check(len(e) == MOFA_SWEEPS and drop <= 1e-5, "the ELBO never falls by more than 1e-5")

    # the plain path's 50 sweeps, for the time only
    with plain_kernels(tmo, MOFA_WRAPPERS):
        t0 = time.perf_counter()
        tm.fit_mofa(Ys, cfg, n_iterations=MOFA_SWEEPS, min_iterations=MOFA_SWEEPS, **kw)
        torch.cuda.synchronize()
        print(f"[times] plain-torch MOFA ({MOFA_SWEEPS} sweeps) on the card, one warm run: "
              f"{time.perf_counter() - t0:.4f}s", flush=True)
    torch.cuda.empty_cache()
    return launches


def topvar_dense(dsp, X, cuda, dn: int) -> torch.Tensor:
    """bench_e2e.py's ``topvar_dense``: the ``dn`` columns of a CSR matrix of
    largest variance (from the device column sums of X and X²), as a dense
    (n, dn) tensor that stays on the device."""
    dX = dsp.from_scipy(X, cuda)
    n = dX.n_rows
    cs = dsp.col_sums(dX)
    c2 = dsp.col_sums(dX._replace(data=dX.data ** 2))
    var = c2 / n - (cs / n) ** 2
    sel = torch.argsort(-var, stable=True)[:dn]
    lut = torch.zeros(dX.n_cols, dtype=torch.int64, device=cuda)
    lut[sel] = torch.arange(1, dn + 1, device=cuda)
    # scatter-add into an (n, dn + 1) grid; column 0 collects the unselected
    dest = dsp._row_ids(dX) * (dn + 1) + lut[dX.indices.long()]
    out = torch.zeros(n * (dn + 1), dtype=torch.float32, device=cuda)
    out.index_add_(0, dest, dX.data)
    return out.reshape(n, dn + 1)[:, 1:]


def label_probe_r2(rep, labels) -> float:
    """bench_e2e.py's gate: R² of regressing one-hot(labels) on [rep, 1]."""
    R = np.asarray(rep, dtype=np.float64)
    n = len(R)
    sub = np.random.default_rng(1).choice(n, size=min(n, 100_000), replace=False)
    Rs = np.column_stack([R[sub], np.ones(len(sub))])
    Yoh = np.eye(N_CLUSTERS)[labels[sub]]
    resid = Yoh - Rs @ np.linalg.lstsq(Rs, Yoh, rcond=None)[0]
    return float(1.0 - (resid ** 2).sum() / ((Yoh - Yoh.mean(0)) ** 2).sum())


def phase_mofa_e2e(tm, dsp, kernels, profiling, X_rna_norm, X_atac_tfidf, rna_pca, labels, cuda):
    """The e2e's MOFA stage at 100,000 cells: the 256 most variable columns
    of the normalised RNA and the TF-IDF ATAC matrices, selected and kept on
    the device, then stochastic VI."""
    t0 = time.perf_counter()
    views = [topvar_dense(dsp, X, cuda, MOFA_COLS) for X in (X_rna_norm, X_atac_tfidf)]
    torch.cuda.synchronize()
    t_sel = time.perf_counter() - t0
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(n_iterations=MOFA_ITERS, min_iterations=20, svi_mode=True,
              svi_batch_fraction=min(MOFA_BATCH / N_CELLS, 1.0), elbo_every=5, device=cuda)
    tm.fit_mofa(views, cfg, **{**kw, "n_iterations": 2})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tm.fit_mofa(views, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profiling.collect() as t:
        tm.fit_mofa(views, cfg, **kw)
    mofa_r2, pca_r2 = label_probe_r2(res.Z, labels), label_probe_r2(rna_pca[:, :MOFA_K], labels)
    print(f"[mofa-e2e] hvg.select {t_sel:.3f}s (two {N_CELLS} x {MOFA_COLS} views on the "
          f"device); fit_mofa SVI {MOFA_ITERS} iterations of {MOFA_BATCH} cells in {wall:.4f}s "
          f"({wall / MOFA_ITERS * 1e3:.2f} ms/iteration); peak device memory {peak:.2f} GiB; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[mofa-e2e] stage split of a second fit: {stage_seconds(t)}", flush=True)
    print(f"[mofa-e2e] label-probe R2 of Z {mofa_r2:.4f} (first {MOFA_K} PCA components "
          f"{pca_r2:.4f}; the gate: above max(0.2, 0.8 x that)); objective first "
          f"{res.elbo_history[0]:.6g}, last {res.elbo_history[-1]:.6g}", flush=True)
    check_launches(launches, mofa_launches(MOFA_ITERS), f"{MOFA_ITERS} SVI iterations at 100k")
    check(res.Z.shape == (N_CELLS, MOFA_K) and np.isfinite(res.Z).all(), "e2e MOFA Z finite")
    check(res.n_iterations == MOFA_ITERS, f"the e2e's SVI ran {MOFA_ITERS} iterations")
    check(mofa_r2 > max(0.2, 0.8 * pca_r2), "MOFA label-probe R2 above max(0.2, 0.8 x PCA's)")
    return launches, views


def phase_mofa_big(tm, kernels, profiling, cuda):
    """SVI at 1,000,000 cells: two (1M, 256) gaussian views from a planted Z,
    made on the device from a seed."""
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    Zp = torch.randn((N_BIG, MOFA_K), generator=gen, device=cuda)
    views = []
    for _ in range(2):
        W = torch.randn((MOFA_K, MOFA_COLS), generator=gen, device=cuda)
        views.append(Zp @ W + 0.5 * torch.randn((N_BIG, MOFA_COLS), generator=gen, device=cuda))
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(n_iterations=MOFA_ITERS, min_iterations=20, svi_mode=True,
              svi_batch_fraction=MOFA_BATCH / N_BIG, elbo_every=5, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        res = tm.fit_mofa(views, cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = stage_seconds(t)
    sweep_s = sum(v for k, v in stages.items() if k not in ("mofa/init", "mofa/r2_stats"))
    cc = canonical_correlations(torch.from_numpy(res.Z).to(cuda), Zp)
    print(f"[mofa-1m] fit_mofa SVI on two {N_BIG} x {MOFA_COLS} views, {MOFA_ITERS} iterations "
          f"of {MOFA_BATCH} cells: wall {wall:.3f}s under the stage timers, "
          f"{sweep_s / MOFA_ITERS * 1e3:.2f} ms/iteration in the sweeps; peak device memory "
          f"{peak:.2f} GiB (the views included); stages {stages}", flush=True)
    print(f"[mofa-1m] canonical correlations of Z with the planted Z: min {cc.min():.4f}, "
          f"median {float(np.median(cc)):.4f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check_launches(launches, mofa_launches(MOFA_ITERS), f"{MOFA_ITERS} SVI iterations at 1M")
    check(res.Z.shape == (N_BIG, MOFA_K) and np.isfinite(res.Z).all(), "1M MOFA Z finite")
    check(cc.min() > 0.9, "1M SVI: smallest canonical correlation with the planted Z > 0.9")
    return launches


# ---------------------------------------------------------------------------
# MOFA's bound-based views (T23), spike-slab factors, and MEFISTO's smooth
# factors (T24, T25)
# ---------------------------------------------------------------------------


def mofa_lik_views(Z: np.ndarray, seed: int = 1, d: int = MOFA_DS[1]):
    """The bound-based views of ``[mofa-lik]`` from the bench's planted Z:
    ``d`` bernoulli features drawn from the planted logits Z·W (W entries
    N(0, 0.5²), so the logits' variance is 3.75 at K = 15, not saturated) and
    ``d`` poisson counts of rate softplus(Z·W) (W entries N(0, 0.3²))."""
    rng = np.random.default_rng(seed)
    K = Z.shape[1]
    logits = Z @ (LIK_LOGIT_SCALE * rng.normal(size=(K, d)))
    Yb = (rng.random(logits.shape) < 1.0 / (1.0 + np.exp(-logits))).astype(np.float32)
    rate = np.logaddexp(0.0, Z @ (LIK_RATE_SCALE * rng.normal(size=(K, d))))
    return Yb, rng.poisson(rate).astype(np.float32)


def sparse_planted(Z: np.ndarray, seed: int = 2) -> np.ndarray:
    """Z with SSZ_ZERO_SHARE of its entries set to zero: a factor active on
    part of the cells only, what spike-slab factors are for."""
    rng = np.random.default_rng(seed)
    return (Z * (rng.random(Z.shape) >= SSZ_ZERO_SHARE)).astype(np.float32)


def mefisto_data(seed: int = 0, n: int = MEF_N, n_times: int = MEF_TIMES, ds=MEF_DS,
                 rho=None, shift: float = 0.0):
    """A time course in two groups of n/2 cells on a grid of ``n_times``
    timepoints in [0, 1] (n / 2 / n_times cells each): MEF_PLANTED smooth
    trajectories sin(2π f t + φ), f from 0.5 to 3 cycles; with ``rho`` group
    1 follows rho·(group 0's trajectory) + √(1 − rho²)·(its quarter-period
    shift); views Z·W + 0.5 noise. Group 1 reads its clock as t + ``shift``.
    Returns (t, covariate, groups, Z, views)."""
    rng = np.random.default_rng(seed)
    per = n // 2
    t_g = np.repeat(np.linspace(0.0, 1.0, n_times), per // n_times)
    t = np.concatenate([t_g, t_g])
    groups = np.repeat([0, 1], len(t_g))
    freqs = np.linspace(0.5, 3.0, MEF_PLANTED)
    phases = rng.uniform(0.0, 2 * np.pi, MEF_PLANTED)
    Z = np.sin(2 * np.pi * freqs * t[:, None] + phases)
    if rho is not None:
        other = np.sin(2 * np.pi * freqs * t[:, None] + phases + np.pi / 2)
        g1 = groups == 1
        Z[g1] = rho * Z[g1] + np.sqrt(1.0 - rho * rho) * other[g1]
    Ys = [(Z @ rng.normal(size=(MEF_PLANTED, d)) + 0.5 * rng.normal(size=(len(t), d))
           ).astype(np.float32) for d in ds]
    cov = (t + shift * (groups == 1)).astype(np.float32)
    return t, cov, groups, Z.astype(np.float32), Ys


def refreshes(sweeps: int, start: int, every: int) -> int:
    """How many hyperparameter refreshes (or warps) ``sweeps`` sweeps run."""
    return sum(1 for it in range(1, sweeps + 1) if it >= start and it % every == 0)


def gp_launches(sweeps, n_ell, kg_steps=0, warps=0, sparse=False, K=MEF_K) -> dict:
    """T24 and T25 of a MEFISTO fit: the dense path builds gp_K once, then at
    each refresh one T24 per ℓ of the grid and one for gp_K, one T24 and one
    T25 per step on Kg, and one T24 per warp; the sparse path builds K_mm and
    K_nm per factor in every sweep and never gp_K."""
    r = refreshes(sweeps, MEF_START, MEF_OPT)
    if sparse:
        t24 = 2 * K * sweeps + r * (n_ell + kg_steps)
    else:
        t24 = 1 + r * (n_ell + 1 + kg_steps) + warps
    return {"gp_rbf_kernel": t24, "gp_kg_grad": r * kg_steps, **mofa_launches(sweeps, 2, K)}


def phase_lik_kernels(tmo, Zp, Yb, Yp, cuda) -> dict:
    """T23 against its plain version at the bench's 10,000 x 3000 (bernoulli,
    which the JSON line records, and poisson) and at the SVI batch's
    50,000 x 256, from weights after a few sweeps' worth of shrinkage."""
    results = {}
    gen = torch.Generator(device=cuda).manual_seed(23)
    cases = [("bernoulli", torch.from_numpy(Yb).to(cuda), Zp, True),
             ("poisson", torch.from_numpy(Yp).to(cuda), Zp, False),
             ("bernoulli", (torch.rand((MOFA_BATCH, MOFA_COLS), generator=gen, device=cuda)
                            > 0.7).float(), None, False)]
    for lik, Y, Z, main in cases:
        n, d = Y.shape
        Zm = (torch.from_numpy(Z).to(cuda) if Z is not None
              else torch.randn((n, MOFA_K), generator=gen, device=cuda)).contiguous()
        SW = 0.3 * torch.randn((d, MOFA_K), generator=gen, device=cuda)
        z2 = Zm * Zm + 0.05
        SWW = SW * SW + 0.01
        M01 = torch.ones_like(Y)  # a bound-based view always carries its mask
        kappa = 0.25 + 0.17 * Y.max(dim=0).values
        kw = dict(z2=z2, SWW=SWW) if lik == "bernoulli" else dict(kappa=kappa)
        got = tmo.bound_refresh(lik, Zm, SW, Y, M01, **kw)
        torch.cuda.synchronize()
        ref = tmo.bound_refresh_plain(lik, Zm, SW, Y, M01, **kw)
        F = Zm @ SW.T
        scale = 1.0 + ((F * F + z2 @ SWW.T) if lik == "bernoulli" else F.abs())
        errs = [(g - r).abs() for g, r in zip(got[:2], ref[:2])]
        ok = all(bool((e <= 1e-5 * scale).all()) for e in errs)
        again = tmo.bound_refresh(lik, Zm, SW, Y, M01, **kw)
        ok = ok and all(torch.equal(a, b) for a, b in zip(again[:2], got[:2]))
        ms = median_ms(lambda: tmo.bound_refresh(lik, Zm, SW, Y, M01, **kw))
        plain_ms = median_ms(lambda: tmo.bound_refresh_plain(lik, Zm, SW, Y, M01, **kw))
        # reads Y0, M01 and the factor-sized inputs; writes E (and T)
        outs = 2 if lik == "bernoulli" else 1
        bytes_ = nbytes(Y, M01, Zm, SW) + outs * nbytes(Y) + (
            nbytes(z2, SWW) if lik == "bernoulli" else nbytes(kappa))
        per_k = 7 if lik == "bernoulli" else 2  # F's FMA; bernoulli: the variance term
        bnd = bound(bytes_, per_k * n * d * MOFA_K, F32_OPS_PER_S)
        err = max(e.max().item() for e in errs)
        print(f"[kernel] mofa_bound_refresh {lik} {n}x{d}: max_abs_err={err:.3e} "
              f"(1e-5 x (1 + F^2 + z2.SWW), bit-equal twice) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) library_ms=None", flush=True)
        check(ok, f"mofa_bound_refresh {lik} {n}x{d} within 1e-5 of plain, same bits twice")
        if main:
            results["mofa_bound_refresh"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                             **bnd, "library_ms": None}
        del Y, Zm, SW, z2, SWW, M01, F, got, ref, again
    torch.cuda.empty_cache()
    return results




def phase_mofa_lik(tm, tmo, kernels, profiling, Zp, Yg, Yb, Yp, cuda):
    """``[mofa-lik]``: bench.py's MOFA size with a bernoulli view (then a
    poisson one) beside the 2000-column gaussian view, 2 + 50 full-batch
    sweeps, counted and timed from ``fit_mofa`` alone."""
    sweeps = MOFA_SWEEPS
    want = {**mofa_launches(sweeps), "mofa_bound_refresh": sweeps}
    kw = dict(n_iterations=sweeps, min_iterations=sweeps, convergence_mode="slow",
              elbo_every=1, device=cuda)
    by_path = {}
    for lik, Y in (("bernoulli", Yb), ("poisson", Yp)):
        cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", lik))
        tm.fit_mofa([Yg, Y], cfg, **{**kw, "n_iterations": MOFA_WARM})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = tm.fit_mofa([Yg, Y], cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        by_path[lik] = launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profiling.collect() as t:
            t0 = time.perf_counter()
            again = tm.fit_mofa([Yg, Y], cfg, **kw)
            wall_staged = time.perf_counter() - t0
        cc = canonical_correlations(torch.from_numpy(res.Z).to(cuda), torch.from_numpy(Zp))
        e = res.elbo_history
        print(f"[mofa-lik] {lik}: fit_mofa {MOFA_N} x ({MOFA_DS[0]} gaussian, {MOFA_DS[1]} {lik}), "
              f"K={MOFA_K}, "
              f"{sweeps} sweeps in {wall:.4f}s = {sweeps / wall:.2f} sweeps/s; peak device memory "
              f"{peak:.2f} GiB; launches { {k: v for k, v in launches.items() if v} }", flush=True)
        print(f"[mofa-lik] {lik}: stage split of a second fit under the stage timers "
              f"({wall_staged:.4f}s): {stage_seconds(t)}", flush=True)
        print(f"[mofa-lik] {lik}: canonical correlations of Z with the planted Z: min "
              f"{cc.min():.4f}, median {float(np.median(cc)):.4f}; ELBO after sweep 1 {e[0]:.6g}, "
              f"after {sweeps} {e[-1]:.6g}; r2_total {[round(float(v), 4) for v in res.r2_total[0]]}",
              flush=True)
        check_launches(launches, want, f"[mofa-lik] {lik}, {sweeps} sweeps")
        check(np.isfinite(e).all() and len(e) == sweeps, f"[mofa-lik] {lik}: the ELBO finite")
        check(np.isfinite(res.Z).all(), f"[mofa-lik] {lik}: Z finite")
        check(cc.min() > 0.9, f"[mofa-lik] {lik}: smallest canonical correlation > 0.9")
        same = np.array_equal(res.Z, again.Z) and np.array_equal(e, again.elbo_history) and all(
            np.array_equal(a, b) for a, b in zip(res.W, again.W))
        check(same, f"[mofa-lik] {lik}: two fits give identical bits (Z, W, ELBO)")

        # one sweep through the kernels against the plain path, from the
        # state after two sweeps
        liks = ["gaussian", lik]
        cfg1 = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=tuple(liks), n_groups=1)
        step = tm.make_step(cfg1, [Yg.shape[1], Y.shape[1]], MOFA_N, [False, True], liks)
        state = tm._init_state([Yg, Y], [None, None], np.ones((MOFA_N, 1), np.float32), cfg1,
                               liks, device=cuda)
        for _ in range(2):
            state, _ = step(state)
        got, elbo_k = step(state)
        with plain_kernels(tmo, MOFA_WRAPPERS):
            kernels.reset_launch_counts()
            ref, elbo_p = step(state)
            check(not any(kernels.launch_counts().values()), "the plain sweep launched no kernel")
        worst, worst_leaf = leaf_error(got, ref)
        elbo_rel = abs(float(elbo_k) - float(elbo_p)) / abs(float(elbo_p))
        print(f"[mofa-lik] {lik}: one sweep, kernels against the plain path from the same state: "
              f"largest leaf error {worst:.2e} of the leaf's largest entry ({worst_leaf}), ELBO "
              f"rel {elbo_rel:.2e} (<= 1e-4)", flush=True)
        check(worst <= 1e-4 and elbo_rel <= 1e-4, f"[mofa-lik] {lik}: one sweep within 1e-4")
        del state, got, ref
        if lik == "bernoulli":
            with plain_kernels(tmo, MOFA_WRAPPERS):
                t0 = time.perf_counter()
                tm.fit_mofa([Yg, Y], cfg, **kw)
                torch.cuda.synchronize()
                print(f"[times] plain-torch MOFA with a bernoulli view ({sweeps} sweeps) on the "
                      f"card, one warm run: {time.perf_counter() - t0:.4f}s", flush=True)
    torch.cuda.empty_cache()
    return by_path


def phase_mofa_lik_svi(tm, kernels, profiling, views, rna_pca, labels, cuda):
    """``[mofa-lik-svi]``: the e2e's SVI stage (100 iterations of 50,000 of
    the 100,000 cells) with its 256 ATAC columns binarised and fitted as
    ``bernoulli``."""
    Ys = [views[0], (views[1] > 0).float()]
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "bernoulli"))
    kw = dict(n_iterations=MOFA_ITERS, min_iterations=20, svi_mode=True,
              svi_batch_fraction=min(MOFA_BATCH / N_CELLS, 1.0), elbo_every=5, device=cuda)
    tm.fit_mofa(Ys, cfg, **{**kw, "n_iterations": 2})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = tm.fit_mofa(Ys, cfg, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profiling.collect() as t:
        tm.fit_mofa(Ys, cfg, **kw)
    mofa_r2, pca_r2 = label_probe_r2(res.Z, labels), label_probe_r2(rna_pca[:, :MOFA_K], labels)
    print(f"[mofa-lik-svi] fit_mofa SVI, RNA gaussian + binarised ATAC bernoulli, {MOFA_ITERS} "
          f"iterations of {MOFA_BATCH} cells in {wall:.4f}s ({wall / MOFA_ITERS * 1e3:.2f} "
          f"ms/iteration); peak device memory {peak:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[mofa-lik-svi] stage split of a second fit: {stage_seconds(t)}", flush=True)
    print(f"[mofa-lik-svi] label-probe R2 of Z {mofa_r2:.4f} (first {MOFA_K} PCA components "
          f"{pca_r2:.4f}; the gate: above max(0.2, 0.8 x that))", flush=True)
    check_launches(launches, {**mofa_launches(MOFA_ITERS), "mofa_bound_refresh": MOFA_ITERS},
                   f"[mofa-lik-svi] {MOFA_ITERS} SVI iterations")
    check(res.Z.shape == (N_CELLS, MOFA_K) and np.isfinite(res.Z).all()
          and np.isfinite(res.elbo_history).all(), "[mofa-lik-svi] Z and the objective finite")
    check(mofa_r2 > max(0.2, 0.8 * pca_r2), "[mofa-lik-svi] label-probe R2 above max(0.2, 0.8 x PCA's)")
    return launches


def phase_mofa_ssz(tm, kernels, profiling, Zp, cuda):
    """``[mofa-ssz]``: ``spikeslab_factors=True`` at the ``[mofa-lik]`` size
    (2000 gaussian and 3000 bernoulli columns, K = 15, 50 sweeps) on a
    planted Z with half its entries zero, the cells in SSZ_GROUPS groups;
    ``ssz_on`` turns at sweep 15."""
    Zs = sparse_planted(Zp)
    rng = np.random.default_rng(3)
    Yg = (Zs @ rng.normal(size=(MOFA_K, MOFA_DS[0]))
          + 0.5 * rng.normal(size=(MOFA_N, MOFA_DS[0]))).astype(np.float32)
    Yb, _ = mofa_lik_views(Zs, seed=4)
    cfg = tm.MOFAConfig(n_factors=MOFA_K, likelihoods=("gaussian", "bernoulli"),
                        spikeslab_factors=True)
    seen = {}

    def grab(it, state, elbo):
        seen["Z_S"] = state["Z_S"]

    sweeps = MOFA_SWEEPS
    kw = dict(groups=np.arange(MOFA_N) % SSZ_GROUPS, n_iterations=sweeps,
              min_iterations=sweeps, convergence_mode="slow", elbo_every=sweeps, callback=grab,
              device=cuda)
    tm.fit_mofa([Yg, Yb], cfg, **{**kw, "n_iterations": MOFA_WARM})
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        res = tm.fit_mofa([Yg, Yb], cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    zs = seen["Z_S"]
    share = float((zs < 0.5).float().mean())
    cc = canonical_correlations(torch.from_numpy(res.Z).to(cuda), torch.from_numpy(Zs))
    print(f"[mofa-ssz] fit_mofa spikeslab_factors, {MOFA_N} x ({MOFA_DS[0]} gaussian, {MOFA_DS[1]} bernoulli), "
          f"K={MOFA_K}, {SSZ_GROUPS} groups, {sweeps} sweeps in {wall:.4f}s under the stage "
          f"timers; Z_S < 0.5 on "
          f"{share:.4f} of the entries after sweep {sweeps} ({SSZ_ZERO_SHARE} planted at zero); "
          f"canonical correlations with the planted Z: min {cc.min():.4f}, median "
          f"{float(np.median(cc)):.4f}; stages {stage_seconds(t)}", flush=True)
    check_launches(launches, {**mofa_launches(sweeps), "mofa_bound_refresh": sweeps},
                   f"[mofa-ssz] {sweeps} sweeps")
    check(np.isfinite(res.elbo_history).all() and np.isfinite(res.Z).all(),
          "[mofa-ssz] the ELBO and Z finite")
    check(share > 0.0, "[mofa-ssz] Z_S < 0.5 on a nonzero share of the cells after the toggle")
    check(cc.min() > 0.9, "[mofa-ssz] smallest canonical correlation > 0.9")
    return launches


def phase_gp_kernels(tgp, cuda) -> dict:
    """T24 at the dense path's (K, N, N) gp_K and the sparse path's K_nm
    (100,000 x 1,000, one factor: the JSON line), T25 at the dense
    model_groups shape, each against its plain version."""
    results = {}
    gen = torch.Generator(device=cuda).manual_seed(24)
    ells = torch.linspace(0.05, 0.8, MEF_K, device=cuda)
    scales = torch.linspace(0.1, 0.9, MEF_K, device=cuda)
    Kg = tgp.normalize_kg(torch.randn((MEF_K, 2, 2), generator=gen, device=cuda))

    def report(name, shape, err, tol, ok, k_fn, p_fn, bnd, record):
        ms, plain_ms = median_ms(k_fn), median_ms(p_fn, reps=3)
        if record:
            results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                             "library_ms": None}
        print(f"[kernel] {name} {shape}: max_abs_err={err:.3e} ({tol}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
              f"library_ms=None", flush=True)
        check(ok, f"{name} {shape} within {tol}")

    c = torch.rand((MEF_N, 1), generator=gen, device=cuda)
    g = (torch.arange(MEF_N, device=cuda) >= MEF_N // 2).float()
    cn = torch.rand((SGP_N, 1), generator=gen, device=cuda)
    gn = (torch.arange(SGP_N, device=cuda) % 2).float()
    cu, gu = cn[::SGP_N // 1000].contiguous(), gn[::SGP_N // 1000].contiguous()
    for shape, args, F_, rec in (
        (f"gp_K {MEF_K}x{MEF_N}x{MEF_N}, learned Kg", (c, c, ells, scales, g, g, Kg, True),
         MEF_K, False),
        (f"K_nm {SGP_N}x{cu.shape[0]}, one factor",
         (cn, cu, ells[:1], scales[:1], gn, gu, None, False), 1, True),
    ):
        out = tgp.rbf_kernel(*args)
        torch.cuda.synchronize()
        ref = tgp.rbf_kernel_plain(*args)
        err = (out - ref).abs().max().item()
        # writes F na nb floats; an exp per entry at the special-function rate
        bnd = bound(nbytes(out) + nbytes(args[0], args[1]), out.numel(), SFU_OPS_PER_S)
        report("gp_rbf_kernel", shape, err, "rtol 1e-6 atol 2.5e-7",
               bool(((out - ref).abs() <= 2.5e-7 + 1e-6 * ref.abs()).all()),
               lambda: tgp.rbf_kernel(*args), lambda: tgp.rbf_kernel_plain(*args), bnd, rec)
        del out, ref
    dK = torch.randn((MEF_K, MEF_N, MEF_N), generator=gen, device=cuda)
    got = tgp.kg_grad(dK, c, c, ells, scales, g, g, 2)
    torch.cuda.synchronize()
    ref = tgp.kg_grad_plain(dK, c, c, ells, scales, g, g, 2)
    tol_ = 1e-5 * tgp.kg_grad_plain(dK.abs(), c, c, ells, scales, g, g, 2) + 1e-6
    same = torch.equal(got, tgp.kg_grad(dK, c, c, ells, scales, g, g, 2))
    # reads dK once; an exp per entry
    report("gp_kg_grad", f"dK {MEF_K}x{MEF_N}x{MEF_N}, G=2", (got - ref).abs().max().item(),
           "1e-5 x the sums of |dK| exp, bit-equal twice", bool(((got - ref).abs() <= tol_).all())
           and same, lambda: tgp.kg_grad(dK, c, c, ells, scales, g, g, 2),
           lambda: tgp.kg_grad_plain(dK, c, c, ells, scales, g, g, 2),
           bound(nbytes(dK, got, c), dK.numel(), SFU_OPS_PER_S), True)
    del dK
    torch.cuda.empty_cache()
    return results


def planted_cc(Z: np.ndarray, planted: np.ndarray, cuda) -> np.ndarray:
    return canonical_correlations(torch.from_numpy(planted).to(cuda), torch.from_numpy(Z).to(cuda))


def phase_mefisto(tm, tgp, kernels, profiling, cuda):
    """``[mefisto]``: dense GP priors over time, 3,000 cells in 2 groups,
    views of 500 and 800, K = 10, 100 sweeps with the hyperparameters
    refreshed every 25 from sweep 20; then one fit with ``model_groups`` on
    anti-correlated groups and one with ``warping`` on a shifted clock."""
    n_ell = 10
    by_path = {}
    kw = dict(n_iterations=MEF_SWEEPS, min_iterations=MEF_SWEEPS, convergence_mode="slow",
              elbo_every=MEF_SWEEPS, smooth_opt_every=MEF_OPT, smooth_start_opt=MEF_START,
              device=cuda)
    cfg = tm.MOFAConfig(n_factors=MEF_K, likelihoods=("gaussian", "gaussian"))
    for case, data_kw, fit_kw in (
        ("mefisto", dict(), dict()),
        ("mefisto_groups", dict(rho=MEF_RHO), dict(model_groups=True)),
        ("mefisto_warp", dict(shift=MEF_SHIFT), dict(warping=True, warping_freq=MEF_WARP_FREQ)),
    ):
        t, cov, groups, Zp, Ys = mefisto_data(seed=5, **data_kw)
        kernels.reset_launch_counts()
        with profiling.collect() as st:
            t0 = time.perf_counter()
            res = tm.fit_mofa(Ys, cfg, groups=groups, smooth_covariate=cov, **kw, **fit_kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        by_path[case] = launches
        cc = planted_cc(res.Z, Zp, cuda)
        steps = 10 if fit_kw.get("model_groups") else 0
        warps = refreshes(MEF_SWEEPS, MEF_START, MEF_WARP_FREQ) if fit_kw.get("warping") else 0
        print(f"[mefisto] {case}: fit_mofa {MEF_N} x {MEF_DS}, 2 groups, K={MEF_K}, "
              f"{MEF_SWEEPS} sweeps in {wall:.3f}s under the stage timers; canonical correlations "
              f"of the {MEF_PLANTED} planted trajectories with Z: min {cc.min():.4f}; "
              f"gp_lengthscales {np.round(res.gp_lengthscales, 4).tolist()}, gp_scales "
              f"{np.round(res.gp_scales, 3).tolist()}; stages {stage_seconds(st)}; launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        check_launches(launches, gp_launches(MEF_SWEEPS, n_ell, steps, warps),
                       f"[mefisto] {case}")
        check(np.isfinite(res.elbo_history).all() and np.isfinite(res.Z).all(),
              f"[mefisto] {case}: the ELBO and Z finite")
        if case == "mefisto":
            check(cc.min() > 0.9, "[mefisto] the planted trajectories' canonical correlations "
                                  "with the smooth factors > 0.9")
        if case == "mefisto_groups":
            keep = res.Z.std(axis=0) > 0.05 * res.Z.std(axis=0).max()
            kg01 = res.gp_group_corr[:, 0, 1]
            print(f"[mefisto] {case}: learned Kg[0, 1] of the factors {np.round(kg01, 4).tolist()} "
                  f"(planted group correlation {MEF_RHO}; active {keep.tolist()})", flush=True)
            check(bool((kg01[keep] < 0).all()), "[mefisto] the learned Kg has the planted "
                                                 "group correlation's sign on every active factor")
        if case == "mefisto_warp":
            g1 = groups == 1
            step_t = 1.0 / (MEF_TIMES - 1)
            err = np.abs(res.warped_covariates[g1] - t[g1])
            print(f"[mefisto] {case}: |warped - latent time| of the shifted group: median "
                  f"{np.median(err):.5f}, mean {err.mean():.5f} (the shift {MEF_SHIFT}, a grid "
                  f"step {step_t:.5f})", flush=True)
            check(np.median(err) <= step_t + 1e-6, "[mefisto] the warped covariate undoes the "
                                                  "shift within a grid step")
        del Ys
    torch.cuda.empty_cache()
    return by_path


def phase_mefisto_sparse(tm, kernels, profiling, cuda):
    """``[mefisto-sparse]``: the sparse GP at 100,000 cells (``mefisto_data``
    on a grid of 1000 timepoints) with the reference's default Mu =
    min(1000, N) inducing cells, K = 10, 50 sweeps, under the stage timers
    (T24 against the Cholesky factors and solves)."""
    n_ell = 10
    t, cov, groups, Zp, Ys = mefisto_data(seed=6, n=SGP_N, n_times=SGP_TIMES)
    cfg = tm.MOFAConfig(n_factors=MEF_K, likelihoods=("gaussian", "gaussian"))
    kw = dict(groups=groups, smooth_covariate=cov, sparse_gp=True, n_iterations=SGP_SWEEPS,
              min_iterations=SGP_SWEEPS, convergence_mode="slow", elbo_every=SGP_SWEEPS,
              smooth_opt_every=MEF_OPT, smooth_start_opt=MEF_START, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with profiling.collect() as st:
        t0 = time.perf_counter()
        res = tm.fit_mofa(Ys, cfg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = stage_seconds(st)
    cc = planted_cc(res.Z, Zp, cuda)
    print(f"[mefisto-sparse] fit_mofa sparse GP, {SGP_N} x {MEF_DS}, Mu=1000, K={MEF_K}, "
          f"{SGP_SWEEPS} sweeps: wall {wall:.3f}s under the stage timers; peak device memory "
          f"{peak:.2f} GiB (the views included); the sweeps' T24 {stages.get('mofa/gp_kernel')}s "
          f"against the Cholesky factors and solves {stages.get('mofa/gp_solve')}s; stages "
          f"{stages}", flush=True)
    print(f"[mefisto-sparse] canonical correlations of the {MEF_PLANTED} planted trajectories "
          f"with Z: min {cc.min():.4f}; gp_lengthscales {np.round(res.gp_lengthscales, 4).tolist()}; "
          f"launches { {k: v for k, v in launches.items() if v} }", flush=True)
    check_launches(launches, gp_launches(SGP_SWEEPS, n_ell, sparse=True), "[mefisto-sparse]")
    check(np.isfinite(res.elbo_history).all() and np.isfinite(res.Z).all(),
          "[mefisto-sparse] the ELBO and Z finite")
    check(cc.min() > 0.9, "[mefisto-sparse] the planted trajectories' canonical correlations > 0.9")
    del Ys
    torch.cuda.empty_cache()
    return launches



class DEHolder:
    """The least AnnData-like object rank_genes_groups takes: X, layers, the
    group labels in ``obs``, feature names and uns."""

    def __init__(self, X, labels):
        self.X, self.layers, self.uns, self.obs = X, {}, {}, {"planted": labels}
        self.var_names = np.array([f"f{j}" for j in range(X.shape[1])])


def kernel_report(results, name, shape, err, tol, ok, k_fn, p_fn, bnd, lib_fn=None,
                  plain_reps=3):
    """Time a kernel and its plain version (and the library call, if any),
    print the ``[kernel]`` line, record it under ``name`` and check it."""
    ms, plain_ms = median_ms(k_fn), median_ms(p_fn, reps=plain_reps)
    lib = library_ms(lib_fn) if lib_fn is not None else None
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bnd,
                     "library_ms": lib}
    print(f"[kernel] {name} {shape}: max_abs_err={err:.3e} ({tol}) ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bnd['bound_ms']:.4f} ({bnd['bound_by']}) "
          f"library_ms={lib if lib is None else round(lib, 4)}", flush=True)
    check(ok, f"{name} {shape} within {tol}")


def planted_shares(res, boost) -> np.ndarray:
    """Each group's share of its DE_TOP best-ranked features that were
    boosted in it."""
    return np.array([boost[int(g), [int(f[1:]) for f in res["names"][g][:DE_TOP]]].mean()
                     for g in res["names"].dtype.names])


def phase_de(ttl, tde, kernels, profiling, X_rna_norm, X_atac, labels, boosts, cuda):
    """``[de]``: tl.rank_genes_groups over the 20 planted labels, each call
    counted alone: t-test (the moments through T3 on the sparse X), wilcoxon
    and logreg (X densified on the card, 8 GB) on the normalised RNA, then
    wilcoxon on the TF-IDF ATAC (the ranking ``atac.tl.rank_peaks_groups``
    runs, 10 GB dense)."""
    check(tde.RANK_BLOCK_BYTES // (16 * N_CELLS) == DE_BLOCK, "T26's column block is 2684")
    by_path = {}
    for method, X, boost, tag in (
        ("t-test", X_rna_norm, boosts["rna"], "de_ttest"),
        ("wilcoxon", X_rna_norm, boosts["rna"], "de_wilcoxon"),
        ("logreg", X_rna_norm, boosts["rna"], "de_logreg"),
        ("wilcoxon ATAC", X_atac, boosts["atac"], "de_atac"),
    ):
        h = DEHolder(X, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        kernels.reset_launch_counts()
        with profiling.collect() as t:
            t0 = time.perf_counter()
            ttl.rank_genes_groups(h, "planted", method=method.split()[0], device=cuda)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        by_path[tag] = launches
        res = h.uns["rank_genes_groups"]
        shares = planted_shares(res, boost)
        finite = all(np.isfinite(res["scores"][g]).all() for g in res["scores"].dtype.names)
        print(f"[de] {method} {X.shape[0]}x{X.shape[1]}: wall {wall:.4f}s; peak device memory "
              f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB above the "
              f"{base / 2**30:.2f} held; stages {stage_seconds(t)}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; planted share of each group's "
              f"top {DE_TOP}: min {shares.min():.3f} mean {shares.mean():.3f}", flush=True)
        check_launches(launches, DE_PATHS[method], f"[de] {method}")
        check(len(res["names"].dtype.names) == N_CLUSTERS and finite, f"[de] {method}: "
              "a field per group, finite scores")
        check(shares.min() >= DE_PLANTED, f"[de] {method}: every group's top {DE_TOP} hold "
              f">= {DE_PLANTED} planted features")
        del h, res
    torch.cuda.empty_cache()
    return by_path


def phase_de_kernels(tde, dsp, X_rna_norm, labels, cuda) -> dict:
    """T26 on the first column block of the dense normalised RNA (sorted
    once), T27 and T28 on one logreg step at the path's shapes, each against
    its plain version on the same inputs."""
    results = {}
    gen = torch.Generator(device=cuda).manual_seed(26)
    X = tde.dense_from_csr(dsp.from_scipy(X_rna_norm, cuda))
    codes = torch.from_numpy(labels.astype(np.int32)).to(cuda)
    t0 = time.perf_counter()
    vals, perm = torch.sort(X[:, :DE_BLOCK].T, dim=1, stable=True)
    vals, perm = vals.contiguous(), perm.contiguous()
    torch.cuda.synchronize()
    sort_ms = median_ms(lambda: torch.sort(X[:, :DE_BLOCK].T, dim=1, stable=True), reps=3)
    rs, tie = tde.sorted_rank_sums(vals, perm, codes, N_CLUSTERS)
    torch.cuda.synchronize()
    rs_p, tie_p = tde.sorted_rank_sums_plain(vals, perm, codes, N_CLUSTERS)
    print(f"[de] one column block {DE_BLOCK} x {N_CELLS}: torch.sort {sort_ms:.3f} ms "
          f"(first call {1e3 * (time.perf_counter() - t0):.1f} ms with T26 and its check)",
          flush=True)
    # reads the sorted block (12 bytes a cell) and the codes, writes (g + 1) x b
    kernel_report(results, "wilcoxon_rank_sums", f"{DE_BLOCK}x{N_CELLS}, g={N_CLUSTERS}",
                  (rs - rs_p).abs().max().item(), "rank sums and tie terms equal",
                  torch.equal(rs, rs_p) and torch.equal(tie, tie_p),
                  lambda: tde.sorted_rank_sums(vals, perm, codes, N_CLUSTERS),
                  lambda: tde.sorted_rank_sums_plain(vals, perm, codes, N_CLUSTERS),
                  bound(nbytes(vals, perm, codes, rs, tie), 0, F32_OPS_PER_S))
    del vals, perm, rs_p, tie_p

    W = 0.01 * torch.randn((N_GENES, N_CLUSTERS), generator=gen, device=cuda)
    b = 0.1 * torch.randn(N_CLUSTERS, generator=gen, device=cuda)
    y = codes
    wv = torch.ones(N_CELLS, device=cuda)
    Z = torch.matmul(X, W)
    dZ, db = tde.logreg_softmax_grad(Z, b, y, wv)
    torch.cuda.synchronize()
    dZ_p, db_p = tde.logreg_softmax_grad_plain(Z, b, y, wv)
    ok = bool(((dZ - dZ_p).abs() <= 1e-5 * dZ_p.abs() + 1e-7).all()) and bool(
        ((db - db_p).abs() <= 1e-5 * dZ_p.abs().sum(0) + 1e-6).all())
    # reads Z, writes dZ (the bias, labels and weights besides); two exps an entry
    kernel_report(results, "logreg_softmax_grad", f"{N_CELLS}x{N_CLUSTERS}",
                  (dZ - dZ_p).abs().max().item(), "dZ rtol 1e-5 atol 1e-7, db 1e-5 x sum|dZ|",
                  ok, lambda: tde.logreg_softmax_grad(Z, b, y, wv),
                  lambda: tde.logreg_softmax_grad_plain(Z, b, y, wv),
                  bound(nbytes(Z, b, y, wv, dZ, db), 2 * Z.numel(), SFU_OPS_PER_S))
    gW = torch.matmul(X.T, dZ)
    del X, Z, dZ_p
    state = [W, 0.1 * torch.randn(W.shape, generator=gen, device=cuda),
             torch.rand(W.shape, generator=gen, device=cuda), b,
             0.1 * torch.randn(b.shape, generator=gen, device=cuda),
             torch.rand(b.shape, generator=gen, device=cuda)]
    got, want = [t.clone() for t in state], [t.clone() for t in state]
    step = 3
    tde.adam_update(got[0], gW, got[1], got[2], got[3], db, got[4], got[5], step)
    torch.cuda.synchronize()
    tde.adam_update_plain(want[0], gW, want[1], want[2], want[3], db, want[4], want[5], step)
    err = max((a - w).abs().max().item() for a, w in zip(got, want))
    ok = all(bool(((a - w).abs() <= 1e-5 * w.abs() + 1e-7).all()) for a, w in zip(got, want))
    run = [t.clone() for t in state]
    PW, Pb = state[0].clone().requires_grad_(), state[3].clone().requires_grad_()
    PW.grad, Pb.grad = gW.clone(), db.clone()
    # torch's fused Adam, L2 as weight_decay 1 / C (its grad + wd p is (0.5 / C)(2p) + grad)
    opt = torch.optim.Adam([PW, Pb], lr=tde.LOGREG_LR, betas=(tde.ADAM_B1, tde.ADAM_B2),
                           eps=tde.ADAM_EPS, weight_decay=1.0, fused=True)
    # reads W, gW, m, v and writes W, m, v (and b's); about 15 operations an entry
    kernel_report(results, "adam_update", f"W {N_GENES}x{N_CLUSTERS}, b {N_CLUSTERS}", err,
                  "W, m, v rtol 1e-5 atol 1e-7", ok,
                  lambda: tde.adam_update(run[0], gW, run[1], run[2], run[3], db, run[4],
                                          run[5], step),
                  lambda: tde.adam_update_plain(run[0], gW, run[1], run[2], run[3], db,
                                                run[4], run[5], step),
                  bound(7 * nbytes(W, b), 15 * (W.numel() + b.numel()), F32_OPS_PER_S),
                  lambda: opt.step())
    torch.cuda.empty_cache()
    return results


def phase_snf(tac, tpp, tpt, ttl, tsn, tgr, dsp, kernels, profiling, X_rna, X_atac, P,
              labels, cuda):
    """``[snf]``: the first 10,000 cells of the e2e's three modalities, each
    through its own path to neighbors(20), then tl.snf with its defaults
    (counted alone), the same call through the plain versions, and
    tl.leiden on the fused graph; then T29-T31 and one diffusion iteration
    against their plain versions on the path's matrices."""
    n = SNF_CELLS
    lab = labels[:n]
    t0 = time.perf_counter()
    mods = {"rna": rna_path(dsp, tpp, X_rna[:n], cuda),
            "atac": atac_e2e_path(tac, tpp, X_atac[:n], cuda),
            "prot": prot_path(tpt, tpp, P[:n], cuda)}
    print(f"[snf] per-modality paths at {n} cells in {time.perf_counter() - t0:.1f}s; "
          "planted-label share of each graph's neighbours " + ", ".join(
              f"{m} {label_share(h.obsp['distances'], lab):.4f}" for m, h in mods.items()),
          flush=True)
    mod_shares = [label_share(h.obsp["distances"], lab) for h in mods.values()]
    md = MuHolder(mods, n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.snf(md, n_neighbors=SNF_K, n_iterations=SNF_ITERS, device=cuda)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    conn = md.obsp["connectivities"].tocsr()
    share = label_share(conn, lab)
    products = 2 * SNF_MODS * SNF_ITERS * 2 * float(n) ** 3
    stages = stage_seconds(t)
    print(f"[snf] tl.snf(n_neighbors={SNF_K}, n_iterations={SNF_ITERS}) on {SNF_MODS} x "
          f"{n}^2: wall {wall:.4f}s; stages {stages} (products {products:.3e} flop, "
          f"{products / max(sum(t.get('snf/products', [0])), 1e-9) / 1e12:.1f} TFLOP/s); "
          f"peak device memory {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB; "
          f"launches { {k: v for k, v in launches.items() if v} }; planted-label share of "
          f"the fused neighbours {share:.4f}", flush=True)
    check_launches(launches, SNF_PATH, "[snf]")
    check(conn.nnz == n * SNF_K and np.isfinite(conn.data).all(), "[snf] k entries a row")
    check(md.uns["neighbors"]["params"]["method"] == "snf", "[snf] uns params")

    # the same tl.snf through the kernels' plain versions (held to the JAX
    # reference's _affinity_matrix, _snf_diffusion_fn and tl.snf by
    # tests/test_torch_snf.py): the fused graph is the algorithm's. On these
    # data its planted-label share is 0.884 (the RNA graph's neighbours are
    # 54% planted), below the reference test's 0.9 on its own small fixture;
    # the JAX package's tl.snf reads the same on the same graphs
    # (exp_snf_witness.py). So the gates are the plain path's graph and share,
    # and a share of at least 0.87.
    # T31's choice is discontinuous: where a row's k-th and (k+1)-th entries
    # lie within rounding of each other, the kernels (within 2.4e-6 of their
    # plain versions) and the plain versions may keep different ones, and one
    # such decision turned moves the fused edges around it by 1e-3 and more
    # (exp_snf_ties.py). So the plain path takes the kernel path's dominant
    # set in the rows where its own differs, and every differing entry must
    # lie within SNF_NEAR of the plain row's threshold (a gate, counted).
    # T29-T31 repeat bit for bit, so the kernel path's sets are recomputed
    # here, outside its count
    kept_k = []
    for h in mods.values():
        dist, known = tgr._dense_distances(h.obsp["distances"], cuda)
        kept_k.append(tsn.snf_dominate_set(tsn.snf_normalize(
            tsn.affinity_matrix(dist, known, SNF_K, 0.5, float(np.finfo(np.float64).eps))),
            SNF_K) != 0)
        del dist, known
    turned, far = [], []

    def dominate_aligned(x, k):
        m = len(turned)
        thr = torch.topk(x, k, dim=1).values[:, -1:]
        mine = (x >= thr) & (x != 0)  # as kept_k, the entries kept and not 0
        diff = mine != kept_k[m]
        rows = diff.any(dim=1, keepdim=True)
        turned.append(int(rows.sum()))
        far.append(float(((x - thr).abs() / thr)[diff].max()) if turned[-1] else 0.0)
        kept = torch.where(torch.where(rows, kept_k[m], mine), x, 0.0)
        return kept / kept.sum(dim=1, keepdim=True)

    mdp = MuHolder(mods, n)
    t0 = time.perf_counter()
    with plain_kernels(tsn, ("affinity_matrix", "snf_normalize")):
        saved, tsn.snf_dominate_set = tsn.snf_dominate_set, dominate_aligned
        try:
            ttl.snf(mdp, n_neighbors=SNF_K, n_iterations=SNF_ITERS, device=cuda)
        finally:
            tsn.snf_dominate_set = saved
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    del kept_k
    print(f"[snf] dominant-set rows where the plain versions chose otherwise, taken from the "
          f"kernels: {dict(zip(mods, turned))}; the farthest such entry from its row's "
          f"threshold {max(far, default=0.0):.2e} (<= {SNF_NEAR})", flush=True)
    check(len(turned) == SNF_MODS and max(far, default=0.0) <= SNF_NEAR,
          f"[snf] the kernels' and the plain dominant sets differ only within {SNF_NEAR} "
          "of a row's threshold")
    connp = mdp.obsp["connectivities"].tocsr()
    share_p = label_share(connp, lab)
    both = conn.multiply(connp.astype(bool)).tocsr()
    both_p = connp.multiply(conn.astype(bool)).tocsr()
    edge_jac = both.nnz / (conn.nnz + connp.nnz - both.nnz)
    rel = float(np.max(np.abs(both.data - both_p.data) / np.abs(both_p.data)))
    print(f"[snf] the plain path ({plain_wall:.2f}s): planted-label share {share_p:.4f}; edge "
          f"Jaccard {edge_jac:.5f}, shared edges' values max rel err {rel:.2e}; the mean of the "
          f"modality graphs' shares {np.mean(mod_shares):.4f}", flush=True)
    check(edge_jac >= 0.99 and rel <= 1e-4 and abs(share - share_p) <= 0.002,
          "[snf] the fused graph against the plain path: edges >= 0.99, values rtol 1e-4")
    check(share >= SNF_SHARE, f"[snf] planted-label share of the fused neighbours >= "
          f"{SNF_SHARE}")
    del mdp, connp, both, both_p

    class Graph:
        def __init__(self):
            self.obs, self.obsp, self.uns = {}, md.obsp, md.uns

    gh = Graph()
    t0 = time.perf_counter()
    ttl.leiden(gh, resolution=1.0)
    a = ari(lab, gh.obs["leiden"])
    print(f"[snf] tl.leiden on the fused graph: {len(np.unique(gh.obs['leiden']))} clusters, "
          f"ARI {a:.4f}, {time.perf_counter() - t0:.2f}s", flush=True)
    check(a >= 0.85, "[snf] Leiden ARI on the fused graph >= 0.85")

    results = {}
    eps = float(np.finfo(np.float64).eps)
    Ws = []
    for mod, h in mods.items():
        dist, known = tgr._dense_distances(h.obsp["distances"], cuda)
        W = tsn.affinity_matrix(dist, known, SNF_K, 0.5, eps)
        Ws.append(W)
        if mod != "rna":
            continue
        torch.cuda.synchronize()
        ref = tsn.affinity_matrix_plain(dist, known, SNF_K, 0.5, eps)
        # reads dist and the mask twice (rows, then tiles), writes W; an exp an entry
        kernel_report(results, "snf_affinity", f"{n}x{n}, k={SNF_K}",
                      (W - ref).abs().max().item(), "rtol 1e-5",
                      bool(((W - ref).abs() <= 1e-5 * ref.abs()).all()),
                      lambda: tsn.affinity_matrix(dist, known, SNF_K, 0.5, eps),
                      lambda: tsn.affinity_matrix_plain(dist, known, SNF_K, 0.5, eps),
                      bound(nbytes(dist, known, W), W.numel(), SFU_OPS_PER_S))
        del ref
    del dist, known
    W = Ws[0]
    N = tsn.snf_normalize(W)
    torch.cuda.synchronize()
    ref = tsn.snf_normalize_plain(W)
    kernel_report(results, "snf_normalize", f"{n}x{n}", (N - ref).abs().max().item(),
                  "rtol 1e-5", bool(((N - ref).abs() <= 1e-5 * ref.abs()).all()),
                  lambda: tsn.snf_normalize(W), lambda: tsn.snf_normalize_plain(W),
                  bound(nbytes(W, N), 4 * W.numel(), F32_OPS_PER_S))
    S = tsn.snf_dominate_set(N, SNF_K)
    torch.cuda.synchronize()
    ref = tsn.snf_dominate_set_plain(N, SNF_K)
    kernel_report(results, "snf_dominate_set", f"{n}x{n}, k={SNF_K}",
                  (S - ref).abs().max().item(), "the same kept entries, rtol 1e-5",
                  torch.equal(S != 0, ref != 0)
                  and bool(((S - ref).abs() <= 1e-5 * ref.abs()).all()),
                  lambda: tsn.snf_dominate_set(N, SNF_K),
                  lambda: tsn.snf_dominate_set_plain(N, SNF_K),
                  bound(nbytes(N, S), 2 * N.numel(), F32_OPS_PER_S))
    del N, S, ref, W
    Wn = [tsn.snf_normalize(w) for w in Ws]
    Ss = [tsn.snf_dominate_set(w, SNF_K) for w in Wn]
    del Ws
    t0 = time.perf_counter()
    got = tsn.diffusion_step(Wn, Ss)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with plain_kernels(tsn, ("snf_normalize",)):
        want = tsn.diffusion_step(Wn, Ss)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    err = max(((g - w).abs() / w.abs().clamp(min=1e-30)).max().item() for g, w in zip(got, want))
    print(f"[snf] one diffusion iteration against the plain iteration from the same state: "
          f"max rel err {err:.3e} (<= 1e-5); {t1 - t0:.4f}s and {t2 - t1:.4f}s", flush=True)
    check(err <= 1e-5, "[snf] one diffusion iteration against plain rtol 1e-5")
    del got, want, Wn, Ss
    torch.cuda.empty_cache()
    return launches, results


def planted_sources(seed: int = SEED, n: int = N_CELLS, k: int = ICA_SOURCES):
    """k Laplace sources of n samples mixed by a k × k Gaussian matrix."""
    rng = np.random.default_rng(seed)
    S = rng.laplace(size=(n, k))
    return S, (S @ rng.normal(size=(k, k))).astype(np.float32)


def matched_corr(S: np.ndarray, R: np.ndarray) -> np.ndarray:
    """For each column of S, the largest |corr| with a column of R."""
    zs = (S - S.mean(0)) / S.std(0)
    zr = (R - R.mean(0)) / R.std(0)
    return np.abs(zs.T @ zr / len(S)).max(axis=1)


def phase_ica(ttl, tica, kernels, profiling, rna_pca, cuda):
    """``[ica]``: tl.ica on the e2e RNA's X_pca (counted alone), then on
    planted Laplace sources, through T32 and through its plain version."""
    h = Holder(None)
    h.obsm["X_pca"] = rna_pca
    ttl.ica(h, random_state=SEED, max_iter=2, device=cuda)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        ttl.ica(h, random_state=SEED, device=cuda)
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    S = h.obsm["X_ica"]
    cov_err = float(np.abs(np.cov(S.astype(np.float64), rowvar=False)
                           - np.eye(S.shape[1])).max())
    print(f"[ica] tl.ica on X_pca {rna_pca.shape[0]}x{rna_pca.shape[1]}, {ICA_ITERS} sweeps: "
          f"wall {wall:.4f}s; stages {stage_seconds(t)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; |cov(S) - I| max {cov_err:.3e}",
          flush=True)
    check_launches(launches, ICA_PATH, "[ica]")
    check(S.shape == rna_pca.shape and S.dtype == np.float32 and np.isfinite(S).all(),
          "[ica] X_ica finite float32 of X_pca's shape")
    check(cov_err <= 1e-3, "[ica] cov(S) within 1e-3 of I")

    S_true, Xp = planted_sources()
    hp, hq = Holder(None), Holder(None)
    hp.obsm["X_pca"], hq.obsm["X_pca"] = Xp, Xp
    t0 = time.perf_counter()
    ttl.ica(hp, random_state=SEED, device=cuda)
    t1 = time.perf_counter()
    with plain_kernels(tica, ("ica_contrast",)):
        ttl.ica(hq, random_state=SEED, device=cuda)
    t2 = time.perf_counter()
    corr = matched_corr(S_true, hp.obsm["X_ica"])
    dS = float(np.abs(hp.obsm["X_ica"] - hq.obsm["X_ica"]).max())
    print(f"[ica] {ICA_SOURCES} planted Laplace sources x {N_CELLS}: worst matched |corr| "
          f"{corr.min():.5f} (>= 0.95), median {np.median(corr):.5f}; {t1 - t0:.3f}s; the "
          f"same call through T32's plain version {t2 - t1:.3f}s, max |dS| {dS:.3e} "
          f"(<= 1e-3)", flush=True)
    check(corr.min() >= 0.95, "[ica] every planted source matched with |corr| >= 0.95")
    check(dS <= 1e-3, "[ica] the run through T32 within 1e-3 of the plain run")
    Xw, W0 = tica.pca_whiten(Xp, None, SEED)
    return launches, (torch.from_numpy(Xw).to(cuda), torch.from_numpy(W0).to(cuda))


def phase_scopen(tac, tnmf, dsp, kernels, profiling, X_atac, lsi, labels, cuda):
    """``[scopen]``: atac.pp.scopen on the e2e's ATAC counts, counted alone;
    then its NMF driven again in chunks of SCOPEN_EVERY iterations from the
    same operands and starts, the objective read between chunks; then one
    iteration through T33 against the plain update from the fitted state,
    and T2's split variant at the loop's two shapes against its plain
    version. Returns the launches, that state's inputs of T33 and the split
    variant's ``[kernel]`` record."""
    h = Holder(X_atac)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        tac.pp.scopen(h, n_components=SCOPEN_K, max_iter=SCOPEN_ITERS, device=cuda)
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    M, H, W = h.X, h.obsm["X_scopen"], h.varm["scopen"]
    lo, hi = float(M.min()), float(M.max())
    r2, r2_lsi = label_probe_r2(H, labels), label_probe_r2(lsi, labels)
    print(f"[scopen] atac.pp.scopen {X_atac.shape[0]}x{X_atac.shape[1]}, k={SCOPEN_K}, "
          f"{SCOPEN_ITERS} iterations: wall {wall:.4f}s; stages {stage_seconds(t)}; peak device "
          f"memory {peak:.2f} GiB above the {base / 2**30:.2f} held; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"[scopen] imputed X in [{lo}, {hi}]; label-probe R2 of X_scopen {r2:.4f} "
          f"(>= {SCOPEN_R2}), of X_lsi {r2_lsi:.4f} (ratio {r2 / r2_lsi:.3f})", flush=True)
    check_launches(launches, SCOPEN_PATH, "[scopen]")
    check(H.shape == (N_CELLS, SCOPEN_K) and W.shape == (X_atac.shape[1], SCOPEN_K)
          and np.isfinite(H).all() and np.isfinite(W).all(), "[scopen] factors finite")
    check(M.shape == X_atac.shape and M.dtype == np.float32 and lo >= 0.0 and hi <= 1.0,
          "[scopen] the imputed X float32 in [0, 1]")
    check(r2 >= SCOPEN_R2, f"[scopen] X_scopen's label-probe R2 >= {SCOPEN_R2}")
    del h, M

    # the same fit in chunks; between them ½‖X − WH‖² + ½(‖W‖² + ‖H‖²) =
    # ½‖X‖² − tr(Wᵀ·X·Hᵀ) + ½tr(WᵀW·HHᵀ) + ½(‖W‖² + ‖H‖²), in float64
    X, XT = tnmf.scopen_operands(X_atac, device=cuda)
    x2 = torch.sum(X.data.double() ** 2).item()

    def objective(W, Ht):
        W64, H64 = W.double(), Ht.double()
        cross = torch.sum(W64 * dsp.spmm_split(X, Ht).double()).item()
        gram = torch.sum((W64.T @ W64) * (H64.T @ H64)).item()
        reg = torch.sum(W64 ** 2).item() + torch.sum(H64 ** 2).item()
        return 0.5 * x2 - cross + 0.5 * gram + 0.5 * reg

    Wc, Htc = tnmf._starts(X, SCOPEN_K, 0, None, None)
    obj = [objective(Wc, Htc)]
    t0 = time.perf_counter()
    for _ in range(SCOPEN_ITERS // SCOPEN_EVERY):
        Wc, Htc = tnmf.nmf_factors(X, XT, Wc, Htc, 1.0, SCOPEN_EVERY)
        obj.append(objective(Wc, Htc))
    t_chunks = time.perf_counter() - t0
    rise = max((b - a) / abs(a) for a, b in zip(obj, obj[1:]))
    same = bool(np.array_equal(Wc.cpu().numpy(), W) and np.array_equal(Htc.cpu().numpy(), H))
    print(f"[scopen] the fit again in chunks of {SCOPEN_EVERY} ({t_chunks:.3f}s with the "
          f"objective): objective {[float(f'{o:.7g}') for o in obj]} (largest relative rise "
          f"{rise:.2e}, <= 1e-5); ends on atac.pp.scopen's factors bit for bit: {same}",
          flush=True)
    check(rise <= 1e-5, "[scopen] the objective never rises by more than 1e-5 relative")
    check(same, "[scopen] the chunked fit ends on atac.pp.scopen's factors bit for bit")
    del Wc, Htc

    # one iteration from the fitted state
    Wt = torch.from_numpy(W).to(cuda)
    Ht = torch.from_numpy(H).to(cuda)
    got = tnmf.nmf_factors(X, XT, Wt, Ht, 1.0, 1)
    torch.cuda.synchronize()
    with plain_kernels(tnmf, ("nmf_update",)):
        want = tnmf.nmf_factors(X, XT, Wt, Ht, 1.0, 1)
    err = max(((g - w).abs() / w.abs().clamp(min=1e-30)).max().item()
              for g, w in zip(got, want))
    # the whole fit through the plain versions from the same starts
    Wp, Htp = tnmf._starts(X, SCOPEN_K, 0, None, None)
    t0 = time.perf_counter()
    with plain_kernels(tnmf, ("nmf_update",)), plain_kernels(dsp, ("spmm_split",)):
        Wp, Htp = tnmf.nmf_factors(X, XT, Wp, Htp, 1.0, SCOPEN_ITERS)
    r2_plain = label_probe_r2(Htp.cpu().numpy(), labels)
    print(f"[scopen] the same fit through the plain versions ({time.perf_counter() - t0:.3f}s): "
          f"label-probe R2 {r2_plain:.4f}, the kernels' {r2:.4f} (within {SCOPEN_R2_PLAIN})",
          flush=True)
    check(abs(r2 - r2_plain) <= SCOPEN_R2_PLAIN,
          f"[scopen] X_scopen's R2 within {SCOPEN_R2_PLAIN} of the plain fit's")
    del Wp, Htp

    print(f"[scopen] one iteration through T33 against the plain update from the fitted "
          f"state: max rel err {err:.3e} (<= 1e-5)", flush=True)
    check(err <= 1e-5, "[scopen] one iteration against plain rtol 1e-5")
    del got, want

    # T2's split variant at the loop's shapes: the record is X·Hᵀ's, whose
    # rows (peaks) run from a few cells to tens of thousands
    XtW = dsp.spmm_split(XT, Wt)
    Hn = tnmf.nmf_update(Ht, XtW, Wt, 1.0)
    results = {}
    for label, A, B in (("csr_spmm_split X^T.W", XT, Wt), ("csr_spmm_split", X, Hn)):
        out = dsp.spmm_split(A, B)
        torch.cuda.synchronize()
        diff = (out - dsp.spmm_split_plain(A, B)).abs()
        lens = A.indptr[1:] - A.indptr[:-1]
        ok = bool((diff <= 1e-5 * dsp.spmm_split_plain(A, B.abs())).all())
        kernel_report(results, label, f"{A.n_rows}x{A.n_cols} nnz {A.nnz} (rows of "
                      f"{int(lens.min())}-{int(lens.max())}), k = {SCOPEN_K}",
                      diff.max().item(), "1e-5 x |X|.|B|", ok, lambda: dsp.spmm_split(A, B),
                      lambda: dsp.spmm_split_plain(A, B),
                      bound(csr_bytes(A) + nbytes(B, out), 2 * A.nnz * SCOPEN_K, F32_OPS_PER_S),
                      lambda: torch.sparse.mm(torch_csr(A), B))
        del out, diff
    del results["csr_spmm_split X^T.W"]
    XHt = dsp.spmm_split(X, Hn)
    del X, XT
    torch.cuda.empty_cache()
    return launches, (Ht, XtW, Wt, Wt, XHt, Hn), results


def phase_dense(td, tde, dsp, kernels, X_atac, rna_pca, cuda):
    """``[dense]``: tfidf_dense of the e2e's ATAC counts dense on the card and
    l2norm_dense of X_pca and of that TF-IDF, counted alone."""
    Xd = tde.dense_from_csr(dsp.from_scipy(X_atac, cuda))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    T = td.tfidf_dense(Xd, device=cuda)
    P = td.l2norm_dense(rna_pca, device=cuda)
    L = td.l2norm_dense(T, device=cuda)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    norms = torch.linalg.vector_norm(L, dim=1)
    nz = torch.linalg.vector_norm(T, dim=1) > 0
    print(f"[dense] tfidf_dense {tuple(Xd.shape)}, l2norm_dense {tuple(P.shape)} and "
          f"{tuple(L.shape)}: {wall:.4f}s with the upload of X_pca; launches "
          f"{ {k: v for k, v in launches.items() if v} }; rows of unit norm: max |norm - 1| "
          f"{(norms[nz] - 1).abs().max().item():.2e}, {int((~nz).sum())} zero rows", flush=True)
    check_launches(launches, DENSE_PATH, "[dense]")
    check(bool(torch.isfinite(T).all()) and bool(((norms[nz] - 1).abs() <= 1e-5).all()),
          "[dense] finite TF-IDF, unit rows")
    del T, L, norms, nz
    return launches, Xd, P


TINY = torch.finfo(torch.float32).tiny  # the smallest normal float32


def rel_ok(got, want, rtol, atol=0.0):
    return bool(((got - want).abs() <= rtol * want.abs() + atol).all())


def phase_decomp_kernels(tica, tnmf, td, ica_inputs, nmf_inputs, Xd, rna_pca, cuda) -> dict:
    """T32-T35 against their plain versions at the paths' shapes."""
    results = {}
    Xw, W0 = ica_inputs
    k, n = Xw.shape
    W = tica.sym_decorrelate(W0)
    got = tica.ica_contrast(Xw, W)
    torch.cuda.synchronize()
    want = tica.ica_contrast_plain(Xw, W)
    err = (got - want).abs().max().item()
    # reads Xw, W and writes W_new; two k x k x n products. W_new is the
    # difference of two terms each at most 1 in size (W's rows unit norm, Xw
    # white, |g| <= 1) that cancel: held within 1e-6 absolute
    kernel_report(results, "ica_contrast", f"Xw {k}x{n}", err, "atol 1e-6",
                  err <= 1e-6, lambda: tica.ica_contrast(Xw, W),
                  lambda: tica.ica_contrast_plain(Xw, W),
                  bound(nbytes(Xw, W, got), 4.0 * k * k * n, F32_OPS_PER_S))

    H, XtW, Wo, Wf, XHt, Ho = nmf_inputs
    for name, F, N, O in (("nmf_update", H, XtW, Wo), ("nmf_update W", Wf, XHt, Ho)):
        got = tnmf.nmf_update(F, N, O, 1.0)
        torch.cuda.synchronize()
        want = tnmf.nmf_update_plain(F, N, O, 1.0)
        rows, kk = F.shape
        # reads F, N and the other factor O, writes the update; OᵀO (2 k² flop a
        # row of O), the k-term product and 5 operations an entry of F
        # relative where the result is a normal float32; the fitted factors
        # hold subnormal entries, whose spacing is no relative precision
        kernel_report(results, name, f"{'Ht' if name == 'nmf_update' else 'W'} "
                      f"{tuple(F.shape)}, other {tuple(O.shape)}, "
                      f"{int((want.abs() < TINY).sum())} subnormal",
                      (got - want).abs().max().item(), "rtol 1e-5 atol 1.2e-38",
                      rel_ok(got, want, 1e-5, TINY),
                      lambda: tnmf.nmf_update(F, N, O, 1.0),
                      lambda: tnmf.nmf_update_plain(F, N, O, 1.0),
                      bound(nbytes(F, N, O, got),
                            2.0 * kk * kk * O.shape[0] + (2.0 * kk + 5) * kk * rows,
                            F32_OPS_PER_S))
    del results["nmf_update W"], got, want

    # T34 under every flag combination at 1,000 x 25,000, zero rows and columns planted
    small = Xd[:1000].clone()
    small[::97] = 0.0
    small[:, ::89] = 0.0
    worst = 0.0
    for log_tf in (False, True):
        for log_idf in (False, True):
            for log_tfidf in (False, True):
                for sf in (None, 1, 1e4):
                    flags = (log_tf, log_idf, log_tfidf, sf)
                    got = td.tfidf_dense(small, *flags, device=cuda)
                    want = td.tfidf_dense_plain(small, *flags)
                    atol = 1e-6 * want.abs().max().item()
                    worst = max(worst, ((got - want).abs() - atol).div(want.abs().clamp(
                        min=1e-30)).max().item())
                    check(rel_ok(got, want, 1e-5, atol), f"[kernel] tfidf_dense {flags} "
                          "rtol 1e-5")
    print(f"[kernel] tfidf_dense 1000x{Xd.shape[1]}, zero rows and columns, 24 flag "
          f"combinations: max rel err beyond atol 1e-6 x max {worst:.3e} (<= 1e-5)", flush=True)
    del small, got, want
    got = td.tfidf_dense(Xd, device=cuda)
    torch.cuda.synchronize()
    want = td.tfidf_dense_plain(Xd)
    ok = rel_ok(got, want, 1e-5, 1e-6 * want.abs().max().item())
    err = (got - want).abs().max().item()
    del want
    # reads X once, writes the values; the bound counts no second read
    kernel_report(results, "tfidf_dense", f"{tuple(Xd.shape)} default flags", err,
                  "rtol 1e-5", ok, lambda: td.tfidf_dense(Xd, device=cuda),
                  lambda: td.tfidf_dense_plain(Xd),
                  bound(nbytes(Xd, got), 6.0 * Xd.numel(), F32_OPS_PER_S))
    T = got
    del got
    torch.cuda.empty_cache()

    P = torch.from_numpy(rna_pca).to(cuda)
    for label, X in (("l2norm_dense X_pca", P), ("l2norm_dense", T)):
        got = td.l2norm_dense(X, device=cuda)
        torch.cuda.synchronize()
        want = td.l2norm_dense_plain(X)
        kernel_report(results, label, f"{tuple(X.shape)}", (got - want).abs().max().item(),
                      "rtol 1e-5 atol 1e-7", rel_ok(got, want, 1e-5, 1e-7),
                      lambda: td.l2norm_dense(X, device=cuda),
                      lambda: td.l2norm_dense_plain(X),
                      bound(nbytes(X, got), 3.0 * X.numel(), F32_OPS_PER_S),
                      lambda: torch.nn.functional.normalize(X, dim=1))
        del got, want
        torch.cuda.empty_cache()
    del results["l2norm_dense X_pca"], T, P
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# the motif scan: peak sequences from a genome FASTA, all 746 JASPAR motifs
# ---------------------------------------------------------------------------


class PeakHolder:
    """The least AnnData-like object get_sequences takes: X, uns and the
    peak names (``var_names``, ``chrN:start-end``)."""

    def __init__(self, var_names):
        self.X, self.uns, self.var_names = None, {}, np.asarray(var_names)


def write_fasta(path, chroms) -> None:
    """Each (name, uint8 bases) as a FASTA record of 60 bases a line."""
    with open(path, "wb") as f:
        for name, b in chroms:
            full = len(b) // 60 * 60
            lines = np.full((full // 60, 61), ord("\n"), np.uint8)
            lines[:, :60] = b[:full].reshape(-1, 60)
            f.write(f">{name}\n".encode())
            f.write(lines.tobytes())
            if full < len(b):
                f.write(b[full:].tobytes() + b"\n")


def strong_motifs(tpw, names, matrices, rng, k, min_width=8, margin=0.01):
    """``k`` motifs of width >= ``min_width`` (in a seeded order) whose
    consensus scores at least ``margin`` above their p = MOTIF_P threshold
    in float32: a width-6 consensus can stay below it."""
    out = []
    for m in rng.permutation(len(matrices)):
        lo = matrices[m]
        if lo.shape[1] < min_width:
            continue
        cons = lo.argmax(axis=0)
        score = np.float32(0)
        for j, b in enumerate(cons):
            score = np.float32(score + np.float32(lo[b, j]))
        thr = tpw.threshold_from_p(lo, pvalue=MOTIF_P)
        if float(score) >= thr + margin:
            out.append((int(m), names[m], "".join("ACGT"[b] for b in cons)))
        if len(out) == k:
            return out
    raise RuntimeError(f"only {len(out)} JASPAR motifs of width >= {min_width} clear p")


def make_motif_data(tmf, tpw, path, seed=SEED, chroms=MOTIF_CHROMS, n_peaks=MOTIF_PEAKS,
                    n_planted=MOTIF_PLANTED, each=MOTIF_PLANT_EACH):
    """A genome (uniform bases, runs of N, soft-masked stretches) written to
    ``path``, ``n_peaks`` non-overlapping peaks of PEAK_BP on it, and the
    consensus of ``n_planted`` JASPAR motifs planted in ``each`` peaks each
    at recorded offsets: (peak names, plants as (peak, motif id, offset))."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = []
    for name, n in chroms:
        b = acgt[rng.integers(0, 4, n)]
        for _ in range(n // 200_000):  # runs of N
            at = int(rng.integers(0, n - 5000))
            b[at:at + int(rng.integers(100, 5000))] = ord("N")
        soft = np.zeros(n, bool)
        for _ in range(n // 20_000):  # soft-masked repeats, about a quarter
            at = int(rng.integers(0, n - 12_000))
            soft[at:at + int(rng.integers(500, 12_000))] = True
        b[soft] |= 0x20
        genome.append((name, b))
    slots = [(c, s) for c, b in genome for s in range(0, len(b) - PEAK_BP + 1, PEAK_BP)]
    pick = np.sort(rng.choice(len(slots), n_peaks, replace=False))
    peaks = [slots[i] for i in pick]
    names = [f"{c}:{s}-{s + PEAK_BP}" for c, s in peaks]
    by_name = dict(genome)
    parsed = tmf._parse_motif_matrices()
    motifs = strong_motifs(tpw, parsed["motifs"], parsed["matrices"], rng, n_planted)
    targets = rng.permutation(n_peaks)[:n_planted * each]
    plants = []
    for k, (m, mid, cons) in enumerate(motifs):
        for i in targets[k * each:(k + 1) * each].tolist():
            off = int(rng.integers(0, PEAK_BP - len(cons) + 1))
            c, s = peaks[i]
            by_name[c][s + off:s + off + len(cons)] = np.frombuffer(cons.encode(), np.uint8)
            plants.append((i, mid, off))
    write_fasta(path, genome)
    return names, plants, parsed


def valid_windows(codes: torch.Tensor, w: int) -> int:
    """Windows of width w that touch no code of 4 (the ones T36 sums)."""
    bad = torch.nn.functional.pad((codes >= 4).int().cumsum(1), (1, 0))
    return int(((bad[:, w:] - bad[:, :codes.shape[1] - w + 1]) == 0).sum())


def motif_work(codes, width) -> float:
    """The adds and comparisons of a scan: per motif, each valid window's w
    adds and its comparison."""
    ws, counts = np.unique(width.cpu().numpy(), return_counts=True)
    return float(sum(int(c) * valid_windows(codes, int(w)) * (int(w) + 1)
                     for w, c in zip(ws, counts) if w <= codes.shape[1]))


def phase_motifs(tac, tmf, tpw, kernels, profiling, cuda, tmpdir):
    """``[motifs]``: get_sequences of 100,000 peaks from a 60 Mb FASTA, then
    scan_sequences over all 746 JASPAR motifs, counted alone; the planted
    consensus recalled; T36 against its plain version and F.conv1d."""
    t0 = time.perf_counter()
    fasta = f"{tmpdir}/genome.fa"
    names, plants, parsed = make_motif_data(tmf, tpw, fasta)
    print(f"[data] motifs: genome {sum(n for _, n in MOTIF_CHROMS)} bp in "
          f"{len(MOTIF_CHROMS)} chromosomes, {len(names)} peaks of {PEAK_BP} bp, "
          f"{len(plants)} planted consensus of {MOTIF_PLANTED} motifs, written in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    h = PeakHolder(names)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with profiling.collect() as t:
        t0 = time.perf_counter()
        seqs = tac.tl.get_sequences(h, None, fasta_file=fasta)
        t1 = time.perf_counter()
        hits = tac.tl.scan_sequences(seqs, device=cuda)
        wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    matrices = parsed["matrices"]
    widths = np.array([m.shape[1] for m in matrices])
    windows = int(sum(len(seqs) * (PEAK_BP - w + 1) for w in widths))
    print(f"[motifs] get_sequences {len(seqs)} peaks {t1 - t0:.3f}s, then scan_sequences "
          f"{len(matrices)} motifs, p = {MOTIF_P}: wall of both {wall:.3f}s, peak {peak:.3f} "
          f"GiB above the held; {len(hits)} hits against {MOTIF_P} x {windows} windows = "
          f"{MOTIF_P * windows:.0f} ({len(hits) / (MOTIF_P * windows):.4f} of it); stages "
          f"{stage_seconds(t)}; launches {({k: v for k, v in launches.items() if v})}",
          flush=True)
    check_launches(launches, MOTIF_PATH, "[motifs]")
    check(list(hits.columns) == ["motif_id", "sequence", "position", "score", "tf_gene_name"]
          and str(hits["position"].dtype) == "int64" and str(hits["score"].dtype) == "float32",
          f"[motifs] the reference's columns and dtypes, read {dict(hits.dtypes)}")

    # every planted consensus found at its offset
    planted_ids = {mid for _, mid, _ in plants}
    sub = hits[hits["motif_id"].isin(planted_ids)]
    found = set(zip(sub["sequence"], sub["motif_id"], sub["position"].tolist()))
    recall = np.mean([(seqs[i], mid, off) in found for i, mid, off in plants])
    print(f"[motifs] planted consensus recall {recall:.4f} ({len(plants)} plants)", flush=True)
    check(recall == 1.0, "[motifs] every planted consensus found at its offset")

    # every hit clears its motif's threshold (float64, as the reference compares)
    thresholds = np.array([tpw.threshold_from_p(m, pvalue=MOTIF_P) for m in matrices])
    index = {mid: m for m, mid in enumerate(parsed["motifs"])}
    mot = hits["motif_id"].map(index).to_numpy()
    pos_ok = ((hits["position"].to_numpy() >= 0)
              & (hits["position"].to_numpy() <= PEAK_BP - widths[mot])).all()
    check(bool((hits["score"].to_numpy().astype(np.float64) >= thresholds[mot]).all())
          and bool(pos_ok) and bool(np.isfinite(hits["score"].to_numpy()).all()),
          "[motifs] every hit finite, inside its peak, at or above its threshold")
    del sub, found
    return launches, seqs, matrices, thresholds, parsed["motifs"], hits


def phase_motif_kernel(tpw, seqs, matrices, thresholds, motif_ids, frame, cuda) -> dict:
    """T36 against its plain version at the path's full size: the path's
    frame row for row one call of T36 on all peaks, that call's hits the
    plain version's run on MOTIF_CHUNK peaks at a time, and T36's scores
    mode against F.conv1d on each piece; its time at full size and, with
    plain and F.conv1d, on MOTIF_TIMED peaks."""
    lo, off, width = (torch.from_numpy(a).to(cuda) for a in tpw.pack_motifs(matrices))
    thr = torch.from_numpy(tpw.threshold_f32(thresholds)).to(cuda)
    codes_all = torch.from_numpy(tpw.encode_sequences(seqs)).to(cuda)
    N, L = codes_all.shape
    M = len(matrices)
    got = tpw.pwm_scan_hits(codes_all, lo, off, width, thr)
    torch.cuda.synchronize()

    # the path's own frame is this call's result, row for row
    g = [t.cpu().numpy() for t in got]
    seq_arr, id_arr = np.empty(len(seqs), object), np.empty(M, object)
    seq_arr[:], id_arr[:] = seqs, list(motif_ids)
    frame_same = (len(frame) == len(g[0])
                  and np.array_equal(frame["position"].to_numpy(), g[2])
                  and np.array_equal(frame["score"].to_numpy(), g[3])
                  and np.array_equal(frame["motif_id"].to_numpy(), id_arr[g[1]])
                  and np.array_equal(frame["sequence"].to_numpy(), seq_arr[g[0]]))
    del g, seq_arr

    # the plain version and F.conv1d (TF32 off) a piece of peaks at a time,
    # width by width; windows near their threshold on either side are set
    # aside from the hit lists
    groups = {}
    for m, w in enumerate(width.tolist()):
        groups.setdefault(w, []).append(m)
    packs = {w: [torch.from_numpy(a).to(cuda) for a in tpw.pack_motifs([matrices[m] for m in midx])]
             for w, midx in groups.items()}
    near, want, score_err, inf_same = [], [], 0.0, True
    for s0 in range(0, N, MOTIF_CHUNK):
        codes = codes_all[s0:s0 + MOTIF_CHUNK].contiguous()
        h = tpw.pwm_scan_hits_plain(codes, lo, off, width, thr)
        want.append((h[0] + s0, *h[1:]))
        for w, midx in groups.items():
            S = tpw.pwm_scores(codes, *packs[w])
            torch.cuda.synchronize()
            R = tpw.pwm_scores_plain(codes, *packs[w])
            fin = torch.isfinite(R)
            inf_same &= bool(torch.equal(fin, torch.isfinite(S)))
            inf_same &= bool((torch.where(fin, -np.inf, S) == -np.inf).all())
            score_err = max(score_err, torch.where(fin, S - R, 0.0).abs().max().item())
            t_w = thr[midx]
            close = ((S - t_w).abs() < MOTIF_NEAR) | ((R - t_w).abs() < MOTIF_NEAR)
            si, pi, mi = close.nonzero(as_tuple=True)
            near.append(((si + s0) * M + torch.as_tensor(midx, device=cuda)[mi]) * L + pi)
            del S, R, fin, close
    near = torch.cat(near)
    want = [torch.cat(c) for c in zip(*want)]
    del packs, codes

    def kept(h):
        key = (h[0].long() * M + h[1].long()) * L + h[2].long()
        keep = ~torch.isin(key, near)
        return [a[keep] for a in h]

    gk, wk = kept(got), kept(want)
    same = len(gk[0]) == len(wk[0]) and all(bool(torch.equal(a, b)) for a, b in zip(gk[:3], wk[:3]))
    hit_err = (gk[3] - wk[3]).abs().max().item() if same and len(gk[3]) else 0.0
    err = max(score_err, hit_err)
    full_hits = len(got[0])
    print(f"[kernel] pwm_scan {N} peaks x {M} motifs (plain in pieces of {MOTIF_CHUNK}): the "
          f"path's frame this call's hits row for row: {frame_same}; hits {full_hits} (plain "
          f"{len(want[0])}), {len(near)} windows within {MOTIF_NEAR} of a threshold set aside "
          f"({full_hits - len(gk[0])} of the kernel's hits, {len(want[0]) - len(wk[0])} of "
          f"plain's); the rest the same in the same order: {same}, max |dscore| "
          f"{hit_err:.3e}; scores mode against F.conv1d max abs err {score_err:.3e} (1e-4), "
          f"-inf in the same places: {inf_same}", flush=True)
    check(frame_same, "[kernel] pwm_scan: the path's frame is T36's full-size hits row for row")
    check(same and hit_err <= 1e-4, "[kernel] pwm_scan hits equal plain's, scores within 1e-4")
    check(score_err <= 1e-4 and inf_same,
          "[kernel] pwm_scan scores within 1e-4 of F.conv1d, -inf in the same places")
    del got, want, gk, wk, near

    def bnd(c, n_hits):
        # codes, log-odds and thresholds read once, the hits (16 bytes) written
        return bound(nbytes(c, lo, thr) + 16.0 * n_hits, motif_work(c, width), F32_OPS_PER_S)

    ms_full = median_ms(lambda: tpw.pwm_scan_hits(codes_all, lo, off, width, thr))
    b_full = bnd(codes_all, full_hits)
    print(f"[kernel] pwm_scan {tuple(codes_all.shape)} x {M} motifs (count + write): "
          f"ms={ms_full:.4f} bound_ms={b_full['bound_ms']:.4f} ({b_full['bound_by']}, "
          f"{motif_work(codes_all, width):.4e} adds and comparisons), {full_hits} hits",
          flush=True)
    ct = codes_all[:MOTIF_TIMED].contiguous()
    n_hits = len(tpw.pwm_scan_hits(ct, lo, off, width, thr)[0])
    onehot = torch.zeros((*ct.shape, 4), device=cuda)
    onehot.scatter_(2, ct.clamp(max=3).long().unsqueeze(2), (ct < 4).float().unsqueeze(2))
    onehot = onehot.permute(0, 2, 1).contiguous()
    weights = [lo[off[midx].long().unsqueeze(1) + torch.arange(w, device=cuda)]
               .permute(0, 2, 1).contiguous() for w, midx in groups.items()]

    def conv_scores():
        # the scores alone (14.6 GB over the 18 widths), each dropped at once
        with tpw._no_tf32():
            for W in weights:
                torch.nn.functional.conv1d(onehot, W)

    results = {}
    kernel_report(results, "pwm_scan", f"{tuple(ct.shape)} x {M} motifs (count + write, "
                  f"{n_hits} hits; library: F.conv1d's scores, TF32 off)", err, "scores 1e-4",
                  True, lambda: tpw.pwm_scan_hits(ct, lo, off, width, thr),
                  lambda: tpw.pwm_scan_hits_plain(ct, lo, off, width, thr),
                  bnd(ct, n_hits), conv_scores)
    results["pwm_scan"].update(ms_full=ms_full, bound_ms_full=b_full["bound_ms"])
    del codes_all, ct, onehot, weights
    torch.cuda.empty_cache()
    return results


def ladder_lengths(rng, n: int) -> np.ndarray:
    """Fragment lengths from the nucleosome ladder FRAG_LADDER."""
    bands = rng.choice(len(FRAG_LADDER), n, p=[w for _, _, w in FRAG_LADDER])
    lo = np.array([b[0] for b in FRAG_LADDER])[bands]
    hi = np.array([b[1] for b in FRAG_LADDER])[bands]
    return rng.integers(lo, hi)


def planted_tss_enrichment() -> float:
    """The ENCODE score of a good cell's expected pileup: its TSS fragments'
    starts uniform over the centre (FRAG_CENTRED of them) or over the window,
    their lengths over the ladder; the coverage of each relative position
    counted exactly, as the path piles it up (columns -up..down)."""
    x = np.arange(-FRAG_UP, FRAG_DOWN + 1)
    cov = np.zeros(len(x))
    for lo_len, hi_len, w in FRAG_LADDER:
        for L in range(lo_len, hi_len):
            p = w / (hi_len - lo_len)
            for share, a, b in ((FRAG_CENTRED, -FRAG_CENTRE_HALF, FRAG_CENTRE_HALF - L),
                                (1 - FRAG_CENTRED, -FRAG_UP - L + 1, FRAG_DOWN - 1)):
                # starts s in [a, b] covering x: x - L < s <= x
                n_cover = np.clip(np.minimum(b, x) - np.maximum(a, x - L + 1) + 1, 0, None)
                cov += p * share * n_cover / (b - a + 1)
    centre = (len(x) - 1001) // 2
    flanks = np.r_[cov[:100], cov[-100:]]
    return float(cov[centre:-centre].mean() / flanks.mean())


def make_fragment_data(seed: int, n_cells: int):
    """The [fragments] data: barcodes, genes, and the records sorted by
    (chromosome, start) as columns (cells -1 for an unknown barcode)."""
    rng = np.random.default_rng(seed)
    # 10x barcodes: 16 bases and "-1", unique, the first n_cells of them the
    # cells', the rest unknown
    n_unknown = n_cells // 20
    draws = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n_cells * 6 // 5, 16))]
    raw = np.ascontiguousarray(draws).view("S16").ravel()
    _, first = np.unique(raw, return_index=True)
    raw = raw[np.sort(first)][:n_cells + n_unknown]
    barcodes = np.array([b.decode() + "-1" for b in raw], dtype=object)

    # genes: bodies of 5-30 kb after gaps of 3-20 kb, in order on each chromosome
    n_chr = len(FRAG_CHROMS)
    g_chr = np.repeat(np.arange(n_chr), -(-FRAG_GENES // n_chr))[:FRAG_GENES]
    gaps = rng.integers(3_000, 20_000, FRAG_GENES)
    lens = rng.integers(5_000, 30_000, FRAG_GENES)
    g_start = np.empty(FRAG_GENES, np.int64)
    for c in range(n_chr):
        m = np.flatnonzero(g_chr == c)
        ends = np.cumsum(gaps[m] + lens[m])
        g_start[m] = ends - lens[m]
    g_end = g_start + lens
    strand = rng.choice(np.array(["+", "-"]), FRAG_GENES)

    # fragments around the TSS (each gene's Start, the coordinate the path
    # reads as its TSS whatever the strand), then over gene bodies
    bad = rng.random(n_cells) < FRAG_BAD
    n_tss = rng.poisson(FRAG_TSS_PER_CELL, n_cells)
    cell_t = np.repeat(np.arange(n_cells), n_tss)
    gene_t = rng.integers(0, FRAG_GENES, len(cell_t))
    len_t = ladder_lengths(rng, len(cell_t))
    centred = ~bad[cell_t] & (rng.random(len(cell_t)) < FRAG_CENTRED)
    off = np.where(centred,
                   rng.integers(-FRAG_CENTRE_HALF, FRAG_CENTRE_HALF - len_t + 1),
                   rng.integers(-FRAG_UP - len_t + 1, FRAG_DOWN))
    n_body = rng.poisson(FRAG_BODY_PER_CELL, n_cells)
    cell_b = np.repeat(np.arange(n_cells), n_body)
    gene_b = rng.integers(0, FRAG_GENES, len(cell_b))
    len_b = ladder_lengths(rng, len(cell_b))
    start_b = rng.integers(g_start[gene_b] + FRAG_DOWN, g_end[gene_b] - len_b + 1)

    cells = np.concatenate([cell_t, cell_b])
    gene = np.concatenate([gene_t, gene_b])
    starts = np.concatenate([g_start[gene_t] + off, start_b])
    ends = starts + np.concatenate([len_t, len_b])
    chrom = g_chr[gene]
    scores = rng.integers(1, 5, len(cells))
    code = cells.copy()  # the barcode of each record
    unknown = rng.random(len(cells)) < FRAG_UNKNOWN
    code[unknown] = n_cells + rng.integers(0, n_unknown, int(unknown.sum()))
    cells[unknown] = -1
    order = np.argsort((chrom.astype(np.int64) << 40) | starts, kind="stable")
    rec = {"chrom": chrom[order], "start": starts[order], "end": ends[order],
           "cell": cells[order], "code": code[order], "score": scores[order]}
    genes = {"chrom": g_chr, "start": g_start, "end": g_end, "strand": strand}
    return barcodes, genes, rec, bad


def fragments_mudata(mt, barcodes, genes, n_cells):
    """A port MuData: ``rna`` (the genes, ``var["interval"]``) and ``atac``
    (a peak at each TSS), no counts (the QC path reads only the file)."""
    import pandas as pd

    names = [f"G{i}" for i in range(FRAG_GENES)]
    chrom = np.array(FRAG_CHROMS)[genes["chrom"]]
    obs = pd.DataFrame(index=pd.Index(barcodes[:n_cells].astype(str)))
    var_rna = pd.DataFrame({
        "gene_ids": [f"ENSG{i:011d}" for i in range(FRAG_GENES)],
        "interval": [f"{c}:{s}-{e}" for c, s, e in zip(chrom, genes["start"], genes["end"])],
        "strand": genes["strand"]}, index=names)
    var_atac = pd.DataFrame(index=[f"{c}:{s - FRAG_UP}-{s + FRAG_DOWN}"
                                   for c, s in zip(chrom, genes["start"])])
    empty = sp.csr_matrix((n_cells, FRAG_GENES), dtype=np.float32)
    return mt.MuData({"rna": mt.AnnData(X=empty, obs=obs, var=var_rna),
                      "atac": mt.AnnData(X=empty.copy(), obs=obs.copy(), var=var_atac)})


def write_fragment_file(tfr, path, barcodes, rec) -> None:
    import pandas as pd

    frame = pd.DataFrame({
        "chrom": pd.Categorical.from_codes(rec["chrom"], list(FRAG_CHROMS)),
        "start": rec["start"], "end": rec["end"],
        "barcode": pd.Categorical.from_codes(rec["code"], barcodes.astype(str)),
        "score": rec["score"]})
    tfr.write_fragments(path, frame)


def reference_tss_score(pile: np.ndarray):
    """The reference's _calculate_tss_score and division, numpy float64
    (muon_tpu/atac/tools.py:706-728, :650-653)."""
    X = np.asarray(pile, dtype=np.float64)
    flank_means = np.hstack((X[:, :100], X[:, -100:])).mean(axis=1)
    flank_means[flank_means == 0] = flank_means.mean()
    centre = (X.shape[1] - 1001) // 2
    center_means = X[:, centre:-centre].mean(axis=1)
    return X / flank_means[:, None], center_means / flank_means


def by_chrom(rec):
    """Per chromosome: the records' (starts, rows of rec), sorted by start."""
    out = {}
    for c in range(len(FRAG_CHROMS)):
        rows = np.flatnonzero(rec["chrom"] == c)
        out[c] = (rec["start"][rows], rows)
    return out


def overlapping(index, rec, c, beg, end, max_len):
    """Rows of the records on chromosome c with start < end and end > beg."""
    starts, rows = index[c]
    lo, hi = np.searchsorted(starts, [beg - max_len, end])
    r = rows[lo:hi]
    return r[rec["end"][r] > beg]


def brute_pileup(rec, index, cell_rows, tss, n_pos, max_len):
    """Coverage added fragment by fragment for the cells ``cell_rows`` over
    the TSS ``tss`` ((chrom index, position) pairs): each fragment fetched
    from [tss - up, tss + down) adds its score over its clipped span."""
    out = np.zeros((len(cell_rows), n_pos), np.int64)
    slot = np.full(int(rec["cell"].max()) + 1, -1)
    slot[cell_rows] = np.arange(len(cell_rows))
    for c, t in tss:
        beg = t - FRAG_UP
        r = overlapping(index, rec, c, beg, t + FRAG_DOWN, max_len)
        r = r[rec["cell"][r] >= 0]
        r = r[slot[rec["cell"][r]] >= 0]
        for i in r.tolist():
            lo = max(int(rec["start"][i]) - beg, 0)
            hi = min(int(rec["end"][i]) - beg, n_pos)
            out[slot[rec["cell"][i]], lo:hi] += int(rec["score"][i])
    return out


class PileupRecorder:
    """Stands in for ops.pileup.interval_pileup during the path: calls it,
    and keeps its arguments and result."""

    def __init__(self, tpl):
        self.tpl, self.wrapped, self.calls = tpl, tpl.interval_pileup, []

    def __call__(self, *args, **kwargs):
        out = self.wrapped(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out


def phase_fragments(mt, tac, tpl, tfr, kernels, profiling, cuda, tmpdir):
    """``[fragments]``: the fragment QC path on 100,000 cells, counted alone,
    with its gates; returns the launches and T37's recorded call."""
    from muon_tpu_torch.rna.utils import get_gene_annotation_from_rna

    t0 = time.perf_counter()
    barcodes, genes, rec, bad = make_fragment_data(SEED, N_CELLS)
    n_rec = len(rec["start"])
    max_len = int((rec["end"] - rec["start"]).max()) + 1
    t1 = time.perf_counter()
    path = f"{tmpdir}/atac_fragments.tsv.gz"
    with profiling.collect() as tw, profiling.stage("fragments/write(host)"):
        write_fragment_file(tfr, path, barcodes, rec)
    md = fragments_mudata(mt, barcodes, genes, N_CELLS)
    print(f"[data] fragments: {n_rec} records ({np.mean(rec['cell'] < 0):.4f} of them from "
          f"{len(barcodes) - N_CELLS} barcodes of no cell), {N_CELLS} cells ({bad.sum()} without "
          f"a TSS profile), {FRAG_GENES} genes on {len(FRAG_CHROMS)} chromosomes; made in "
          f"{t1 - t0:.1f}s, written and indexed in {stage_seconds(tw)} "
          f"({os.path.getsize(path) / 2**20:.1f} MiB)", flush=True)

    rec_pileup = PileupRecorder(tpl)
    tpl.interval_pileup = rec_pileup
    walls = {}
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    try:
        kernels.reset_launch_counts()
        with profiling.collect() as t:
            t0 = time.perf_counter()
            tac.tl.locate_fragments(md, path)
            walls["locate_fragments"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            tac.tl.nucleosome_signal(md)
            walls["nucleosome_signal"] = time.perf_counter() - t0
            nucleosome = md.mod["atac"].obs["nucleosome_signal"].to_numpy().copy()
            t0 = time.perf_counter()
            tss = tac.tl.tss_enrichment(md, n_tss=FRAG_TSS, random_state=0, device=cuda)
            walls["tss_enrichment"] = time.perf_counter() - t0
            scores = md.mod["atac"].obs["tss_score"].to_numpy().copy()
            t0 = time.perf_counter()
            mt.pp.filter_obs(md.mod["atac"], "tss_score", lambda x: x >= FRAG_MIN_SCORE)
            md.update()
            walls["filter_obs+update"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            counts = tac.tl.count_fragments_features(md)
            walls["count_fragments_features"] = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        tpl.interval_pileup = rec_pileup.wrapped
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    print(f"[fragments] walls (s) {({k: round(v, 4) for k, v in walls.items()})}, path "
          f"{sum(walls.values()):.3f}s; peak {peak:.3f} GiB above the held; stages "
          f"{stage_seconds(t)}; launches {({k: v for k, v in launches.items() if v})}",
          flush=True)
    check_launches(launches, FRAG_PATH, "[fragments]")
    check(len(rec_pileup.calls) == 1, f"[fragments] one pileup call, read {len(rec_pileup.calls)}")

    # T37's matrix against its plain version, element for element, at full size
    (cells, starts, ends, wts), kw, pile = rec_pileup.calls[0]
    n_pos = FRAG_UP + FRAG_DOWN + 1
    args = [tpl._as_int32(a, cuda) for a in (cells, starts, ends, wts)]
    plain = tpl.interval_pileup_plain(*args, N_CELLS, n_pos)
    same = bool(torch.equal(pile, plain))
    err = int((pile.long() - plain.long()).abs().max().item())
    print(f"[fragments] T37 pileup {tuple(pile.shape)} {pile.dtype} of {len(args[0])} fetched "
          f"fragments against its plain version: equal {same} (max |diff| {err})", flush=True)
    check(same and pile.shape == (N_CELLS, n_pos) and pile.dtype == torch.int32,
          "[fragments] T37's matrix equals interval_pileup_plain's at full size")

    # obs["tss_score"] and X against the reference's numpy score of the plain matrix
    plain_np = plain.cpu().numpy()
    X_ref, score_ref = reference_tss_score(plain_np)
    x_same = tss.X.dtype == np.float64 and np.array_equal(tss.X, X_ref)
    s_same = np.array_equal(scores, score_ref)
    print(f"[fragments] X {tss.X.shape} {tss.X.dtype} and tss_score equal to the numpy score of "
          f"the plain matrix bit for bit: {x_same}, {s_same}", flush=True)
    check(x_same and s_same, "[fragments] tss_score and X equal the plain path's bit for bit")
    del X_ref

    # brute force over sampled cells and all sampled TSS
    feats = get_gene_annotation_from_rna(md).sample(n=FRAG_TSS, random_state=0)
    chrom_ix = {c: i for i, c in enumerate(FRAG_CHROMS)}
    tss_list = [(chrom_ix[c], int(s)) for c, s in zip(feats["Chromosome"], feats["Start"])]
    index = by_chrom(rec)
    sample = np.sort(np.random.default_rng(SEED).choice(N_CELLS, FRAG_BRUTE_CELLS,
                                                        replace=False))
    t0 = time.perf_counter()
    brute = brute_pileup(rec, index, sample, tss_list, n_pos, max_len)
    rows = torch.from_numpy(sample).to(cuda)
    b_kernel = np.array_equal(brute, pile[rows].long().cpu().numpy())
    b_plain = np.array_equal(brute, plain_np[sample])
    print(f"[fragments] brute force over {FRAG_BRUTE_CELLS} cells x {len(tss_list)} TSS "
          f"({int((brute != 0).sum())} nonzero, {time.perf_counter() - t0:.1f}s): equal to T37's "
          f"rows {b_kernel}, to plain's {b_plain}", flush=True)
    check(b_kernel and b_plain, "[fragments] the brute-force pileup equals T37's and plain's rows")
    del plain, plain_np, args

    # the planted enrichment
    planted = planted_tss_enrichment()
    med_good, med_bad = float(np.median(scores[~bad])), float(np.median(scores[bad]))
    ratio = med_good / planted
    print(f"[fragments] median tss_score {med_good:.4f} (good cells), {med_bad:.4f} (no profile); "
          f"planted enrichment {planted:.4f}; ratio {ratio:.4f} (band {FRAG_BAND})", flush=True)
    check(FRAG_BAND[0] <= ratio <= FRAG_BAND[1],
          f"[fragments] good cells' median score within {FRAG_BAND} of the planted {planted:.3f}")

    # nucleosome_signal against a bincount over the records written
    known = rec["cell"] >= 0
    lengths = (rec["end"] - rec["start"])[known]
    kc = rec["cell"][known]
    mat = np.stack([np.bincount(kc[lengths < 147], minlength=N_CELLS),
                    np.bincount(kc[(lengths >= 147) & (lengths < 294)], minlength=N_CELLS)], 1)
    mat[mat[:, 0] == 0, :] += 1
    nuc_same = np.array_equal(nucleosome, mat[:, 1] / mat[:, 0])
    print(f"[fragments] nucleosome_signal equal to the bincount over {n_rec} records: {nuc_same} "
          f"(median {np.median(nucleosome):.4f})", flush=True)
    check(nuc_same, "[fragments] nucleosome_signal equals the bincount over the records written")

    # filter_obs and update against the mask
    mask = scores >= FRAG_MIN_SCORE
    atac = md.mod["atac"]
    f_ok = (atac.n_obs == int(mask.sum())
            and np.array_equal(atac.obs_names.to_numpy(), barcodes[:N_CELLS][mask])
            and md.n_obs == N_CELLS and np.array_equal(md.obsm["atac"], mask)
            and np.array_equal(md.obsmap["atac"][mask], np.arange(1, mask.sum() + 1))
            and not md.obsmap["atac"][~mask].any())
    print(f"[fragments] filter_obs kept {int(mask.sum())} of {N_CELLS} cells ({int(mask[bad].sum())} "
          f"of the {int(bad.sum())} without a profile); atac {atac.n_obs} cells, MuData {md.n_obs}, "
          f"masks and maps as the mask: {f_ok}", flush=True)
    check(f_ok, "[fragments] after filter_obs and update the atac cells and masks follow the mask")

    # count_fragments_features against a brute-force count on sampled genes
    new_row = np.full(N_CELLS, -1)
    new_row[mask] = np.arange(int(mask.sum()))
    picks = np.sort(np.random.default_rng(SEED + 1).choice(FRAG_GENES, FRAG_BRUTE_GENES,
                                                           replace=False))
    got = counts.X.tocsc()[:, picks].toarray()
    want = np.zeros_like(got)
    for j, g in enumerate(picks):
        r = overlapping(index, rec, int(genes["chrom"][g]), int(genes["start"][g]) - 2000,
                        int(genes["end"][g]), max_len)
        r = r[rec["cell"][r] >= 0]
        rr = new_row[rec["cell"][r]]
        np.add.at(want[:, j], rr[rr >= 0], rec["score"][r][rr >= 0])
    c_ok = (counts.shape == (int(mask.sum()), FRAG_GENES) and counts.X.dtype == np.int64
            and np.array_equal(got, want))
    print(f"[fragments] count_fragments_features {counts.shape} nnz {counts.X.nnz}: {FRAG_BRUTE_GENES} "
          f"genes equal to the brute-force count ({int(want.sum())} reads): {c_ok}", flush=True)
    check(c_ok, "[fragments] count_fragments_features equals a brute-force count on 50 genes")
    del tss, counts, md, got, want
    return launches, (cells, starts, ends, wts)


def phase_pileup_kernel(tpl, inputs, cuda) -> dict:
    """T37 against its plain version at the path's call: the same matrix,
    both times, the bound (the fragments read once, the matrix written once)."""
    n_pos = FRAG_UP + FRAG_DOWN + 1
    args = [tpl._as_int32(a, cuda) for a in inputs]
    nnz = len(args[0])
    got = tpl.interval_pileup(*args, N_CELLS, n_pos, device=cuda)
    want = tpl.interval_pileup_plain(*args, N_CELLS, n_pos)
    err = int((got.long() - want.long()).abs().max().item())
    del got, want
    results = {}
    # integer adds: two a fragment and one a matrix entry, at the float32 rate
    bnd = bound(nbytes(*args) + 4.0 * N_CELLS * n_pos, 2.0 * nnz + N_CELLS * n_pos,
                F32_OPS_PER_S)
    kernel_report(results, "interval_pileup",
                  f"{N_CELLS} x {n_pos} int32 from {nnz} fragments (library: none)", err, "exact",
                  err == 0, lambda: tpl.interval_pileup(*args, N_CELLS, n_pos, device=cuda),
                  lambda: tpl.interval_pileup_plain(*args, N_CELLS, n_pos), bnd)
    del args
    torch.cuda.empty_cache()
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    import muon_tpu_torch as mt
    from muon_tpu_torch import atac as tac
    from muon_tpu_torch import native
    from muon_tpu_torch import pp as tpp
    from muon_tpu_torch import prot as tpt
    from muon_tpu_torch import tl as ttl
    from muon_tpu_torch.atac import motifs as tmf
    from muon_tpu_torch.atac import fragments as tfr
    from muon_tpu_torch.models import mofa as tm
    from muon_tpu_torch.ops import _kernels as kernels
    from muon_tpu_torch._core import tools_graph as tgr
    from muon_tpu_torch.ops import de as tde
    from muon_tpu_torch.ops import dense as td
    from muon_tpu_torch.ops import fuzzy as tf
    from muon_tpu_torch.ops import gmm as tg
    from muon_tpu_torch.ops import gp as tgp
    from muon_tpu_torch.ops import ica as tica
    from muon_tpu_torch.ops import ivf as ti
    from muon_tpu_torch.ops import knn as tk
    from muon_tpu_torch.ops import linalg as tla
    from muon_tpu_torch.ops import mofa as tmo
    from muon_tpu_torch.ops import nmf as tnmf
    from muon_tpu_torch.ops import pileup as tpl
    from muon_tpu_torch.ops import pwm as tpw
    from muon_tpu_torch.ops import snf as tsn
    from muon_tpu_torch.ops import sparse as dsp
    from muon_tpu_torch.ops import umap as tu
    from muon_tpu_torch.ops import wnn as tw
    from muon_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    cuda = torch.device("cuda", 0)
    smi = phase_device(kernels)
    phase_build(kernels, native)

    t0 = time.perf_counter()
    X = make_counts(SEED)
    print(f"[data] ATAC {X.shape[0]}x{X.shape[1]} nnz={X.nnz} made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    X_rna, X_atac_e2e, P, labels, boosts = make_e2e_counts(SEED)
    print(f"[data] e2e RNA {X_rna.shape[0]}x{X_rna.shape[1]} nnz={X_rna.nnz}, ATAC "
          f"{X_atac_e2e.shape[0]}x{X_atac_e2e.shape[1]} nnz={X_atac_e2e.nnz}, prot "
          f"{P.shape[0]}x{P.shape[1]} dense, {N_CLUSTERS} planted clusters, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    results = phase_kernels(dsp, dsp.from_scipy(X, cuda), cuda)
    atac_launches, gather_launches, atac_h = phase_atac_path(
        tac, tpp, dsp, tla, kernels, X, cuda)
    rna_launches, rna_h = phase_rna_path(dsp, tla, tpp, tk, tf, kernels, X_rna, labels, cuda)
    union_times(tf, rna_h.obsp["connectivities"], "RNA graph at 100k")
    results.update(phase_neighbors_kernels(dsp, tk, tf, X_rna, rna_h.obsm["X_pca"], cuda))
    prot_launches, prot_h = phase_prot_path(tpt, tpp, tla, td, kernels, P, labels, cuda)
    results.update(phase_dense_kernels(td, P, cuda))
    t0 = time.perf_counter()
    wnn_mods = {"rna": rna_h, "atac": atac_e2e_path(tac, tpp, X_atac_e2e, cuda),
                "prot": prot_h}
    print(f"[wnn] e2e ATAC tfidf -> lsi -> neighbors in {time.perf_counter() - t0:.1f}s",
          flush=True)
    wnn_launches, wnn_rec, wnn_md = phase_wnn_path(tpp, tw, tk, tf, kernels, wnn_mods,
                                                   labels, cuda)
    results.update(phase_wnn_kernels(tw, wnn_rec))
    del wnn_rec
    phase_leiden(ttl, kernels, profiling, wnn_mods, labels)
    umap_launches, umap_results = phase_umap_path(ttl, tu, tk, kernels, wnn_mods, wnn_md,
                                                  labels, cuda)
    results.update(umap_results)
    phase_times(tac, tpp, tpt, ttl, dsp, tla, tk, tf, td, profiling, X, atac_h, X_rna, P,
                wnn_mods, wnn_md, cuda)
    wide_launches, wide_results = phase_repairs(tpp, tw, tk, tf, tu, kernels, wnn_mods, wnn_md,
                                                cuda)
    results.update(wide_results)
    knn_wide_launches, knn_wide_results = phase_knn_wide(tpp, tk, kernels, rna_h.obsm["X_pca"],
                                                         labels, cuda)
    results.update(knn_wide_results)
    asym_launches, asym_results = phase_umap_asym(tu, tk, tf, kernels, rna_h, labels, cuda)
    results.update(asym_results)
    mofa_e2e_launches, e2e_views = phase_mofa_e2e(tm, dsp, kernels, profiling, rna_h.X,
                                                  wnn_mods["atac"].X, rna_h.obsm["X_pca"],
                                                  labels, cuda)
    lik_svi_launches = phase_mofa_lik_svi(tm, kernels, profiling, e2e_views,
                                          rna_h.obsm["X_pca"], labels, cuda)
    del e2e_views
    torch.cuda.empty_cache()
    de_launches = phase_de(ttl, tde, kernels, profiling, rna_h.X, wnn_mods["atac"].X, labels,
                           boosts, cuda)
    results.update(phase_de_kernels(tde, dsp, rna_h.X, labels, cuda))
    snf_launches, snf_results = phase_snf(tac, tpp, tpt, ttl, tsn, tgr, dsp, kernels,
                                          profiling, X_rna, X_atac_e2e, P, labels, cuda)
    results.update(snf_results)
    ica_launches, ica_inputs = phase_ica(ttl, tica, kernels, profiling, rna_h.obsm["X_pca"],
                                         cuda)
    scopen_launches, nmf_inputs, split_results = phase_scopen(
        tac, tnmf, dsp, kernels, profiling, X_atac_e2e, wnn_mods["atac"].obsm["X_lsi"], labels,
        cuda)
    results.update(split_results)
    dense_launches, Xd, _ = phase_dense(td, tde, dsp, kernels, X_atac_e2e,
                                        rna_h.obsm["X_pca"], cuda)
    results.update(phase_decomp_kernels(tica, tnmf, td, ica_inputs, nmf_inputs, Xd,
                                        rna_h.obsm["X_pca"], cuda))
    del ica_inputs, nmf_inputs, Xd
    torch.cuda.empty_cache()
    del X, X_rna, X_atac_e2e, P, atac_h, rna_h, prot_h, wnn_mods, wnn_md, boosts
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmpdir:
        motif_launches, seqs, matrices, thresholds, motif_ids, frame = phase_motifs(
            tac, tmf, tpw, kernels, profiling, cuda, tmpdir)
    results.update(phase_motif_kernel(tpw, seqs, matrices, thresholds, motif_ids, frame, cuda))
    del seqs, matrices, thresholds, motif_ids, frame
    with tempfile.TemporaryDirectory() as tmpdir:
        frag_launches, pileup_inputs = phase_fragments(mt, tac, tpl, tfr, kernels, profiling,
                                                       cuda, tmpdir)
    results.update(phase_pileup_kernel(tpl, pileup_inputs, cuda))
    del pileup_inputs

    t0 = time.perf_counter()
    Z_planted, mofa_views = mofa_bench_views(SEED)
    print(f"[data] MOFA bench views {MOFA_N} x {MOFA_DS}, K={MOFA_K} planted factors, made in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    results.update(phase_mofa_kernels(tmo, mofa_views, cuda))
    mofa_launches_full = phase_mofa_full(tm, tmo, kernels, profiling, Z_planted, mofa_views,
                                         cuda)
    t0 = time.perf_counter()
    Yb, Yp = mofa_lik_views(Z_planted)
    print(f"[data] MOFA bound-based views {MOFA_N} x {MOFA_DS[1]} bernoulli and poisson from the "
          f"planted logits, made in {time.perf_counter() - t0:.1f}s", flush=True)
    results.update(phase_lik_kernels(tmo, Z_planted, Yb, Yp, cuda))
    lik_launches = phase_mofa_lik(tm, tmo, kernels, profiling, Z_planted, mofa_views[0], Yb, Yp,
                                  cuda)
    del Yb, Yp, mofa_views
    ssz_launches = phase_mofa_ssz(tm, kernels, profiling, Z_planted, cuda)
    del Z_planted
    results.update(phase_gp_kernels(tgp, cuda))
    mefisto_launches = phase_mefisto(tm, tgp, kernels, profiling, cuda)
    sgp_launches = phase_mefisto_sparse(tm, kernels, profiling, cuda)

    t0 = time.perf_counter()
    rep, big_labels = make_big_rep(SEED)
    print(f"[data] 1M path: representation {rep.shape[0]}x{rep.shape[1]} float32, "
          f"{BIG_CLUSTERS} planted clusters, made in {time.perf_counter() - t0:.1f}s", flush=True)
    ivf_launches, big_h, partition = phase_ivf(tpp, ti, tk, tf, kernels, profiling, rep,
                                               big_labels, cuda)
    umap_big_launches = phase_umap_big(ttl, tu, tk, tf, kernels, profiling, big_h,
                                       big_labels, cuda)
    results.update(phase_big_kernels(ti, tu, tf, rep, partition, big_h, cuda))
    ivf_wide_launches = phase_ivf_wide(ti, kernels, torch.from_numpy(rep).to(cuda), cuda)
    print(f"[times] peak device memory with the 1M path "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del rep, big_labels, big_h, partition
    torch.cuda.empty_cache()
    mofa_big_launches = phase_mofa_big(tm, kernels, profiling, cuda)
    torch.cuda.empty_cache()
    dsb_launches, gmm_inputs = [], []
    for (n_cells, n_empty), branches in zip(DSB_SIZES, (True, False)):
        launches, std_cells = phase_dsb(tpt, tg, dsp, kernels, profiling, cuda, n_cells, n_empty,
                                        branches)
        dsb_launches.append(launches)
        gmm_inputs.append((f"dsb {n_cells}+{n_empty}", std_cells))
    gmm_inputs.append(("D=300", scaled_counts(DSB_SIZES[0][0], 300, SEED)))
    results.update(phase_gmm_kernel(tg, gmm_inputs, cuda))
    del gmm_inputs
    by_path = {"atac": atac_launches, "rna": rna_launches, "prot": prot_launches,
               "wnn": wnn_launches, "umap": umap_launches, "ivf": ivf_launches,
               "umap1m": umap_big_launches, "wnn_wide": wide_launches,
               "mofa": mofa_launches_full, "mofa_e2e": mofa_e2e_launches,
               "mofa_1m": mofa_big_launches,
               "mofa_bernoulli": lik_launches["bernoulli"], "mofa_poisson": lik_launches["poisson"],
               "mofa_lik_svi": lik_svi_launches, "mofa_ssz": ssz_launches,
               **mefisto_launches, "mefisto_sparse": sgp_launches,
               "knn_wide": {k: knn_wide_launches[k] + ivf_wide_launches[k]
                            for k in knn_wide_launches},
               "umap_asym": asym_launches, **de_launches, "snf": snf_launches,
               "ica": ica_launches, "scopen": scopen_launches, "dense": dense_launches,
               "motifs": motif_launches, "fragments": frag_launches,
               "dsb": {k: sum(c[k] for c in dsb_launches) for k in dsb_launches[0]}}
    print("[launches] by path (each from 0 just before it): " + "; ".join(
        f"{p} " + ", ".join(f"{k} {v}" for k, v in c.items() if v) for p, c in by_path.items())
        + f"; gather rSVD side run " + ", ".join(
        f"{k} {v}" for k, v in gather_launches.items() if v), flush=True)
    never = [n for n in kernels.KERNELS
             if not sum(c[n] for c in by_path.values()) + gather_launches[n]]
    check(not never, f"every kernel launched on a main path or the gather run, not {never}")
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} checks failed: {FAILED}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
         "replaces": KERNEL_INFO[name][1],
         "launches": sum(c[name] for c in by_path.values()),
         "launches_by_path": {p: c[name] for p, c in by_path.items()},
         "gather_launches": gather_launches[name],
         **results[name]}
        for name in kernels.KERNELS
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
