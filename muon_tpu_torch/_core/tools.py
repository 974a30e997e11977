"""Multimodal tools (``mu.tl``; counterpart of muon_tpu/_core/tools.py).

Ported so far: multiplex ``leiden`` and ``louvain`` (ops/leiden.py, the
native engine on the host) and ``umap`` (ops/umap.py, T13 on the device).
MOFA, SNF, ICA and the DE tests are not ported yet (ROADMAP items 8, 10).
"""

from .tools_graph import leiden, louvain, umap  # noqa: F401

__all__ = ["leiden", "louvain", "umap"]
