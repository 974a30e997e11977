"""Multimodal tools (``mu.tl``; counterpart of muon_tpu/_core/tools.py).

Ported so far: multiplex ``leiden`` and ``louvain`` (ops/leiden.py, the
native engine on the host), ``umap`` (ops/umap.py, T13 on the device),
``mofa`` (models/mofa.py, T17-T20 and T23-T25 on the device; every
likelihood and option of the reference's but ``mesh``), ``snf``
(ops/snf.py, T29-T31 and dense products on the device) and
``rank_genes_groups`` (t-test, t-test_overestim_var, wilcoxon, logreg;
ops/de.py, T3 and T26-T28 on the device) and ``ica`` (symmetric FastICA on
an ``.obsm`` basis; ops/ica.py, T32 and ``torch.linalg.eigh`` on the
device).
"""

from .tools_de import rank_genes_groups  # noqa: F401
from .tools_graph import leiden, louvain, snf, umap  # noqa: F401
from .tools_misc import ica  # noqa: F401
from .tools_mofa import mofa  # noqa: F401

__all__ = ["leiden", "louvain", "umap", "mofa", "snf", "rank_genes_groups", "ica"]
