"""muon-tpu on PyTorch and CUDA: the port of ``muon_tpu`` to an NVIDIA GPU.

It keeps the JAX package's public API and writes the same keys, with
PyTorch for the device work and hand-written CUDA kernels (``csrc/``) for
the sparse products, the kNN, the fuzzy connectivities, the WNN fusion, the
dense CLR, the UMAP epoch and the per-factor passes of MOFA+.
The JAX package ``muon_tpu`` stays beside it as the reference the port is
tested against. Ported so far: the TF-IDF → LSI path (``atac.pp.tfidf``,
``atac.tl.lsi``), per-modality PCA and neighbors (``pp.pca``,
``pp.neighbors`` of one modality), WNN (``pp.neighbors`` of a MuData), the
protein CLR (``prot.pp.clr``), multiplex Leiden/Louvain (``tl.leiden``,
``tl.louvain``, on the host through the port's own native engine), UMAP
(``tl.umap``) and MOFA+ for gaussian views, full-batch and stochastic
(``tl.mofa``, ``models.mofa.fit_mofa``); see ROADMAP.md for the rest.

The port needs no container classes of its own: its tools take any
AnnData-like object (``.X``, ``.obsm``, ``.varm``, ``.uns``, ``.obsp``,
``.layers``) or MuData-like object (``.mod``, ``.obsmap``, ``.n_obs``,
``.obs``, ``.obsp``, ``.uns``).
"""

__version__ = "0.1.0"

from . import atac, prot
from ._core import preproc as pp
from ._core import tools as tl

__all__ = ["atac", "prot", "pp", "tl"]
