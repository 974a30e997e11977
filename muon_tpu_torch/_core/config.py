"""Global options with context-manager semantics (counterpart of
muon_tpu/_core/config.py; ``mu.set_options`` of the reference muon).

The port has one option, ``mesh``: a
:class:`~muon_tpu_torch.parallel.mesh.Mesh` (``parallel.make_mesh``) that
sends ``atac.pp.tfidf``, ``atac.tl.lsi``, ``pp.neighbors`` of one modality
and ``tl.umap`` to the sharded programs of ``parallel/pipeline.py``. The
reference's other keys (``device``, ``spmm_blocks``, ``compute_dtype``,
``display_style``, ``profile``) are not read by the port, so setting one
raises ``NotImplementedError`` by name rather than being stored and
ignored: the port's device is an argument of each tool (``device=``), its
arithmetic float32, its stage timers ``utils.profiling.collect``.
"""

from __future__ import annotations

from ..ops.device import DeviceLike, resolve_device

__all__ = ["OPTIONS", "set_options", "current_mesh", "resolve_mesh"]

OPTIONS = {"mesh": None}

# the reference's options that the port does not read
_NOT_PORTED = ("device", "spmm_blocks", "compute_dtype", "display_style", "profile")


def _valid_mesh(m) -> bool:
    if m is None:
        return True
    return hasattr(m, "shape") and "cells" in getattr(m, "axis_names", ())


def current_mesh(mesh=None):
    """The mesh a pipeline call runs on: an explicit ``mesh=`` wins over the
    ``set_options(mesh=...)`` global. None unless that mesh has more than
    one rank: a mesh of one rank falls through to the single-device path,
    as in the reference."""
    m = mesh if mesh is not None else OPTIONS.get("mesh")
    if m is None:
        return None
    if not _valid_mesh(m):
        raise ValueError("mesh must be a muon_tpu_torch.parallel Mesh with a 'cells' axis")
    if int(getattr(m, "size", 1)) <= 1:
        return None
    return m


def resolve_mesh(mesh, device: DeviceLike):
    """``(current_mesh(mesh), the call's device)``. The device is
    ``device`` without a mesh, else the mesh's own (a mesh of one rank
    included), which a ``device`` given besides must name."""
    m = mesh if mesh is not None else OPTIONS.get("mesh")
    if m is not None and hasattr(m, "device"):
        dev = None if device is None else resolve_device(device)
        if dev is not None and (dev.type != m.device.type
                                or dev.index not in (None, m.device.index)):
            raise ValueError(f"device={device} differs from the mesh's device {m.device}")
        device = m.device
    return current_mesh(mesh), device


class set_options:
    """Set global options, directly or as a context manager::

        mt.set_options(mesh=mesh)
        with mt.set_options(mesh=mesh):
            ...
    """

    def __init__(self, **kwargs):
        self.old = {}
        for k, v in kwargs.items():
            if k in _NOT_PORTED:
                raise NotImplementedError(
                    f"option {k!r} of the JAX package is not read by the port "
                    "(muon_tpu_torch has the option 'mesh' only)"
                )
            if k not in OPTIONS:
                raise ValueError(
                    f"argument name {k!r} is not in the set of valid options "
                    f"{set(OPTIONS)}"
                )
            if not _valid_mesh(v):
                raise ValueError(f"option {k!r} given an invalid value: {v!r}")
            self.old[k] = OPTIONS[k]
        OPTIONS.update(kwargs)

    def __enter__(self):
        return self

    def __exit__(self, *args):
        OPTIONS.update(self.old)
