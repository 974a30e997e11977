"""Checkpoint/resume for VB training state (counterpart of
muon_tpu/models/checkpoint.py).

The full variational state (every q-moment: Z/W/S/τ/α/θ plus masks and
residuals) round-trips through one ``.npz`` with the reference's key layout
(``leaf:<key>``, ``list:<key>:<i>``, ``meta:iteration``,
``meta:elbo_history``; an absent entry is the string ``__none__``), so a
file written by either package loads in the other.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["save_state", "load_state"]

_NONE = "__none__"


def _leaf(v):
    if v is None:
        return np.asarray(_NONE)
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _flatten(state: dict):
    flat = {}
    for key, val in state.items():
        if isinstance(val, list):
            for i, v in enumerate(val):
                flat[f"list:{key}:{i}"] = _leaf(v)
        else:
            flat[f"leaf:{key}"] = _leaf(val)
    return flat


def save_state(
    path: str,
    state: dict,
    elbo_history=None,
    iteration: int = 0,
) -> str:
    """Serialize a MOFA VB state dict (models.mofa._init_state layout, as
    tensors or arrays) with its ELBO trace; returns path."""
    flat = _flatten(state)
    flat["meta:iteration"] = np.asarray([iteration])
    if elbo_history is not None:
        flat["meta:elbo_history"] = np.asarray(elbo_history, dtype=np.float64)
    np.savez_compressed(path, **flat)
    return path


def load_state(path: str) -> Tuple[dict, np.ndarray, int]:
    """Load (state, elbo_history, iteration) saved by save_state. Arrays are
    returned as numpy; ``models.mofa.state_from_reference`` puts them on the
    device."""
    state: dict = {}
    lists: dict = {}
    elbos = np.empty(0)
    iteration = 0
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            val = data[key]
            is_none = val.dtype.kind in ("U", "S") and str(val) == _NONE
            if key == "meta:iteration":
                iteration = int(val[0])
            elif key == "meta:elbo_history":
                elbos = val
            elif key.startswith("leaf:"):
                state[key[5:]] = None if is_none else val
            elif key.startswith("list:"):
                _, name, idx = key.split(":")
                lists.setdefault(name, {})[int(idx)] = None if is_none else val
    for name, items in lists.items():
        state[name] = [items[i] for i in sorted(items)]
    return state, elbos, iteration
