"""Native (C++) host engines of the port, loaded with ctypes.

``leiden.cpp`` is the multiplex Leiden/Louvain engine (local moving,
symmetrisation, aggregation) and the one-pass fuzzy union of a kNN
membership table (``knn_fuzzy_union``): the port's own copy of the JAX
package's.
It is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` at first use into
``muon_tpu_torch/_build/``, under a name that carries a hash of the source
and flags, so an edited source rebuilds and nothing is written beside the
source. A missing compiler or a failed build raises with the compiler's
output; nothing falls back to the Python engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

__all__ = ["load_leiden_lib", "leiden_library_path"]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_BUILD_LOCK = threading.Lock()


def leiden_library_path() -> Path:
    src = _HERE / "leiden.cpp"
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"libmuon_torch_leiden_{h.hexdigest()[:16]}.so"


def _build_leiden() -> Path:
    so = leiden_library_path()
    with _BUILD_LOCK:
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(_HERE / "leiden.cpp"), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found; the Leiden engine cannot be built: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed with exit code {proc.returncode} building the Leiden "
                f"engine:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builds see whole files only
    return so


@lru_cache(maxsize=1)
def load_leiden_lib() -> ctypes.CDLL:
    """The native multiplex Leiden engine, built first if needed."""
    lib = ctypes.CDLL(str(_build_leiden()))
    c = ctypes
    lib.multiplex_local_move.restype = c.c_int64  # number of applied moves
    lib.multiplex_local_move.argtypes = [
        c.c_int64,                     # n
        c.c_int32,                     # n_layers
        c.POINTER(c.c_int64),          # indptr_all
        c.POINTER(c.c_int32),          # indices_all
        c.POINTER(c.c_double),         # data_all
        c.POINTER(c.c_int64),          # payload_off
        c.POINTER(c.c_double),         # deg_all
        c.POINTER(c.c_double),         # two_m
        c.POINTER(c.c_double),         # gamma
        c.POINTER(c.c_double),         # layer_w
        c.POINTER(c.c_int64),          # labels (in/out)
        c.POINTER(c.c_int64),          # restrict or NULL
        c.c_int32,                     # max_passes
        c.c_uint64,                    # seed
        c.c_int32,                     # randomized (refinement mode)
        c.c_double,                    # theta_frac
        c.POINTER(c.c_double),         # total applied gain out (or NULL)
    ]
    lib.csr_aggregate.restype = c.c_void_p
    lib.csr_aggregate.argtypes = [
        c.c_int64, c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.POINTER(c.c_double),
        c.POINTER(c.c_int64),
    ]
    lib.csr_symmetrize.restype = c.c_void_p
    lib.csr_symmetrize.argtypes = [
        c.c_int64,
        c.POINTER(c.c_int64), c.POINTER(c.c_int32), c.POINTER(c.c_double),
        c.c_int32,
    ]
    lib.knn_fuzzy_union.restype = c.c_void_p
    lib.knn_fuzzy_union.argtypes = [
        c.c_int64, c.c_int64,          # n, k
        c.POINTER(c.c_int32),          # idx (n, k)
        c.POINTER(c.c_float),          # vals (n, k)
        c.c_double,                    # set_op_mix_ratio
    ]
    lib.agg_nnz.restype = c.c_int64
    lib.agg_nnz.argtypes = [c.c_void_p]
    lib.agg_indptr.restype = c.POINTER(c.c_int64)
    lib.agg_indptr.argtypes = [c.c_void_p]
    lib.agg_indices.restype = c.POINTER(c.c_int32)
    lib.agg_indices.argtypes = [c.c_void_p]
    lib.agg_data.restype = c.POINTER(c.c_double)
    lib.agg_data.argtypes = [c.c_void_p]
    lib.agg_free.argtypes = [c.c_void_p]
    return lib
