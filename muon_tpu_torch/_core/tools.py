"""Multimodal tools (``mu.tl``; counterpart of muon_tpu/_core/tools.py).

Ported so far: multiplex ``leiden`` and ``louvain`` (ops/leiden.py, the
native engine on the host), ``umap`` (ops/umap.py, T13 on the device) and
``mofa`` (models/mofa.py, T17-T20 and T23-T25 on the device; every
likelihood and option of the reference's but ``mesh``).
SNF, ICA and the DE tests are not ported yet (ROADMAP queue 1 item 5).
"""

from .tools_graph import leiden, louvain, umap  # noqa: F401
from .tools_mofa import mofa  # noqa: F401

__all__ = ["leiden", "louvain", "umap", "mofa"]
