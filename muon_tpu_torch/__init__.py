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
moved), the TSS pileup of the fragment QC, and the out-of-core ingest's
decode of each streamed block and the binarised values.
The JAX package ``muon_tpu`` stays beside it as the reference the port is
tested against. Ported so far: the TF-IDF → LSI path (``atac.pp.tfidf``,
``atac.tl.lsi``), per-modality PCA and neighbors (``pp.pca``,
``pp.neighbors`` of one modality), WNN (``pp.neighbors`` of a MuData), the
protein CLR and DSB (``prot.pp.clr``, ``prot.pp.dsb``), multiplex
Leiden/Louvain (``tl.leiden``, ``tl.louvain``, on the host through the
port's own native engine), UMAP (``tl.umap``, and ``ops.umap.umap_embed``
of an asymmetric graph) and MOFA+ with gaussian, bernoulli and poisson
views, spike-slab factors and MEFISTO's smooth factors, full-batch and
stochastic (``tl.mofa``, ``models.mofa.fit_mofa``, over a ``mesh`` too), marker
ranking (``tl.rank_genes_groups``: t-test, t-test_overestim_var, wilcoxon,
logreg; ``atac.tl.rank_peaks_groups``), similarity network fusion
(``tl.snf``), ICA (``tl.ica``), scOpen's imputation (``atac.pp.scopen``), the
L2 norm (``pp.l2norm``), the dense TF-IDF and L2 norm
(``ops.dense.tfidf_dense``, ``l2norm_dense``), the peak annotation
(``atac.tl.add_peak_annotation``, ``add_peak_annotation_gene_names``) and
the motif scan (``atac.tl.get_sequences`` → ``atac.tl.scan_sequences``), the
containers (``AnnData``, ``MuData``, with ``pp.filter_obs``,
``filter_var``, ``intersect_obs``, ``sample_obs``), the h5ad/h5mu I/O and
the readers (``read``, ``write``, ``read_h5mu``, ``read_h5ad``,
``write_h5mu``, ``write_h5ad``, ``read_10x_h5``, ``read_10x_mtx``,
``atac.read_snap``), the out-of-core ingest (``read_h5mu(path,
backed=True)`` → ``atac.pp.tfidf`` → ``atac.tl.lsi``, the matrix streamed
to the card block by block through ``ops.sparse.from_backed``), the key
grammar (``utils.get_values``) and the fragment QC path
(``atac.tl.locate_fragments`` → ``nucleosome_signal`` → ``tss_enrichment``
→ ``count_fragments_features``, over the port's own fragments engine), and
the multi-device data pipeline over ``torch.distributed`` (``parallel``:
``atac.pp.tfidf``, ``atac.tl.lsi``, ``pp.neighbors`` of one modality and
``tl.umap`` with ``mesh=`` or under ``set_options(mesh=...)``); see
ROADMAP.md for the rest.

Every entry point runs on the card unless the caller passes
``device="cpu"``: the default (``device=None``) is the current CUDA device,
and without one it raises rather than run on the CPU.

The port's containers, ``AnnData`` and ``MuData``, are the JAX package's
(host numpy/scipy arrays, pandas frames; in backed mode X stays on disk as a
``BackedMatrix``), and files cross between the two packages both ways. The
tools also take any duck-typed AnnData-like object (``.X``, ``.obsm``,
``.varm``, ``.uns``, ``.obsp``, ``.layers``) or MuData-like object
(``.mod``, ``.obsmap``, ``.n_obs``, ``.obs``, ``.obsp``, ``.uns``). pandas
and h5py are imported only inside the functions that need them, so
importing the port needs neither.
"""

__version__ = "0.1.0"

from . import atac, parallel, prot, rna, utils
from ._core import preproc as pp
from ._core.config import set_options
from ._core import tools as tl
from ._core.anndata import AnnData, Raw
from ._core.io import (
    read,
    read_10x_h5,
    read_10x_mtx,
    read_h5ad,
    read_h5mu,
    write,
    write_h5ad,
    write_h5mu,
)
from ._core.mudata import MuData

__all__ = [
    "AnnData",
    "MuData",
    "Raw",
    "read",
    "write",
    "read_h5mu",
    "read_h5ad",
    "write_h5mu",
    "write_h5ad",
    "read_10x_h5",
    "read_10x_mtx",
    "set_options",
    "atac",
    "parallel",
    "prot",
    "rna",
    "pp",
    "tl",
    "utils",
]
