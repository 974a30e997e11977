"""muon-tpu on PyTorch and CUDA: the port of ``muon_tpu`` to an NVIDIA GPU.

It keeps the JAX package's public API and writes the same keys, with
PyTorch for the device work and hand-written CUDA kernels (``csrc/``) for
the sparse products. The JAX package ``muon_tpu`` stays beside it as the
reference the port is tested against. Ported so far: the TF-IDF → LSI path
(``atac.pp.tfidf``, ``atac.tl.lsi``); see ROADMAP.md for the rest.

The port needs no container classes of its own: its tools take any
AnnData-like object (``.X``, ``.obsm``, ``.varm``, ``.uns``, ``.layers``)
or MuData-like object (``.mod``).
"""

__version__ = "0.1.0"

from . import atac

__all__ = ["atac"]
