"""muon-tpu on PyTorch and CUDA: the port of ``muon_tpu`` to an NVIDIA GPU.

It keeps the JAX package's public API and writes the same keys, with
PyTorch for the device work and hand-written CUDA kernels (``csrc/``) for
the sparse products, the kNN, the fuzzy connectivities, the WNN fusion, the
dense CLR, TF-IDF and L2 norm, the UMAP epochs, the per-factor passes and
bound refresh of MOFA+, MEFISTO's GP kernel matrices, DSB's per-cell
background fit, the marker tests' rank sums and logreg step, SNF's
affinity, normalisation and dominant-set passes, FastICA's fixed-point step,
NMF's multiplicative updates, the motif scan (every window of every
peak compared with each JASPAR motif's threshold on the card, only the hits
moved) and the TSS pileup of the fragment QC.
The JAX package ``muon_tpu`` stays beside it as the reference the port is
tested against. Ported so far: the TF-IDF → LSI path (``atac.pp.tfidf``,
``atac.tl.lsi``), per-modality PCA and neighbors (``pp.pca``,
``pp.neighbors`` of one modality), WNN (``pp.neighbors`` of a MuData), the
protein CLR and DSB (``prot.pp.clr``, ``prot.pp.dsb``), multiplex
Leiden/Louvain (``tl.leiden``, ``tl.louvain``, on the host through the
port's own native engine), UMAP (``tl.umap``, and ``ops.umap.umap_embed``
of an asymmetric graph) and MOFA+ with gaussian, bernoulli and poisson
views, spike-slab factors and MEFISTO's smooth factors, full-batch and
stochastic (``tl.mofa``, ``models.mofa.fit_mofa``; not ``mesh``), marker
ranking (``tl.rank_genes_groups``: t-test, t-test_overestim_var, wilcoxon,
logreg; ``atac.tl.rank_peaks_groups``), similarity network fusion
(``tl.snf``), ICA (``tl.ica``), scOpen's imputation (``atac.pp.scopen``), the
L2 norm (``pp.l2norm``), the dense TF-IDF and L2 norm
(``ops.dense.tfidf_dense``, ``l2norm_dense``), the peak annotation
(``atac.tl.add_peak_annotation``, ``add_peak_annotation_gene_names``) and
the motif scan (``atac.tl.get_sequences`` → ``atac.tl.scan_sequences``), the
in-memory containers (``AnnData``, ``MuData``, with ``pp.filter_obs``,
``filter_var``, ``intersect_obs``, ``sample_obs``) and the fragment QC path
(``atac.tl.locate_fragments`` → ``nucleosome_signal`` → ``tss_enrichment``
→ ``count_fragments_features``, over the port's own fragments engine); see
ROADMAP.md for the rest.

Every entry point runs on the card unless the caller passes
``device="cpu"``: the default (``device=None``) is the current CUDA device,
and without one it raises rather than run on the CPU.

The port's containers, ``AnnData`` and ``MuData``, are the JAX package's in
memory (host numpy/scipy arrays, pandas frames; the h5ad/h5mu I/O and
backed mode come with K19). The tools also take any duck-typed
AnnData-like object (``.X``, ``.obsm``, ``.varm``, ``.uns``, ``.obsp``,
``.layers``) or MuData-like object (``.mod``, ``.obsmap``, ``.n_obs``,
``.obs``, ``.obsp``, ``.uns``). pandas is imported only inside the
functions that need it, so importing the port does not need it.
"""

__version__ = "0.1.0"

from . import atac, prot, rna
from ._core import preproc as pp
from ._core import tools as tl
from ._core.anndata import AnnData, Raw
from ._core.mudata import MuData

__all__ = ["AnnData", "MuData", "Raw", "atac", "prot", "rna", "pp", "tl"]
