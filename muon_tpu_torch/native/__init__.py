"""Native (C++) host engines of the port, loaded with ctypes.

``leiden.cpp`` is the multiplex Leiden/Louvain engine (local moving,
symmetrisation, aggregation) and the one-pass fuzzy union of a kNN
membership table (``knn_fuzzy_union``); ``fragments.cpp`` is the fragments
engine (BGZF reading and writing, ``.tbi`` parsing and building, batched
region fetch with barcode → row resolution). Both are the port's own copies
of the JAX package's.
Each is compiled with ``g++ -O3 -shared -fPIC -std=c++17`` (the fragments
engine with ``-pthread -lz``: the system zlib) at first use into
``muon_tpu_torch/_build/``, under a name that carries a hash of the source,
flags and libraries, so an edited source rebuilds and nothing is written
beside the source. A missing compiler or a failed build raises with the
compiler's output; nothing falls back to a Python engine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

__all__ = [
    "load_leiden_lib",
    "leiden_library_path",
    "load_fragments_lib",
    "fragments_library_path",
]

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# engine -> what it links: the fragments engine zlib, and threads for its writer
_LINK = {"leiden": (), "fragments": ("-pthread", "-lz")}
_BUILD_LOCK = threading.Lock()


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS + _LINK[name]).encode())
    h.update((_HERE / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"libmuon_torch_{name}_{h.hexdigest()[:16]}.so"


def leiden_library_path() -> Path:
    return _library_path("leiden")


def fragments_library_path() -> Path:
    return _library_path("fragments")


def _build(name: str) -> Path:
    so = _library_path(name)
    with _BUILD_LOCK:
        if so.exists():
            return so
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(_HERE / f"{name}.cpp"), "-o", str(tmp), *_LINK[name]]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"g++ not found; the {name} engine cannot be built: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"g++ failed with exit code {proc.returncode} building the {name} "
                f"engine:\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builds see whole files only
    return so


def _build_leiden() -> Path:
    return _build("leiden")


@lru_cache(maxsize=1)
def load_leiden_lib() -> ctypes.CDLL:
    """The native multiplex Leiden engine, built first if needed."""
    lib = ctypes.CDLL(str(_build("leiden")))
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


@lru_cache(maxsize=1)
def load_fragments_lib() -> ctypes.CDLL:
    """The native fragments engine, built first if needed."""
    lib = ctypes.CDLL(str(_build("fragments")))
    c = ctypes
    lib.frag_open.restype = c.c_void_p
    lib.frag_open.argtypes = [c.c_char_p]
    lib.frag_close.argtypes = [c.c_void_p]
    lib.frag_n_contigs.restype = c.c_int
    lib.frag_n_contigs.argtypes = [c.c_void_p]
    lib.frag_contig_name.restype = c.c_char_p
    lib.frag_contig_name.argtypes = [c.c_void_p, c.c_int]
    lib.frag_set_barcodes.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.frag_fetch.restype = c.c_long
    lib.frag_fetch.argtypes = [c.c_void_p, c.c_char_p, c.c_long, c.c_long]
    lib.frag_stream.restype = c.c_long
    lib.frag_stream.argtypes = [c.c_void_p, c.c_long]
    lib.frag_fetch_many.restype = c.c_long
    lib.frag_fetch_many.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_int32),   # tids
        c.POINTER(c.c_int64),   # begs
        c.POINTER(c.c_int64),   # ends
        c.c_long,               # n_regions
        c.POINTER(c.c_int64),   # region_offsets out (n_regions+1)
    ]
    for name, ty in [
        ("frag_starts", c.POINTER(c.c_int64)),
        ("frag_ends", c.POINTER(c.c_int64)),
        ("frag_cells", c.POINTER(c.c_int32)),
        ("frag_scores", c.POINTER(c.c_int32)),
        ("frag_name_offsets", c.POINTER(c.c_int32)),
    ]:
        fn = getattr(lib, name)
        fn.restype = ty
        fn.argtypes = [c.c_void_p]
    lib.frag_name_buf.restype = c.c_void_p
    lib.frag_name_buf.argtypes = [c.c_void_p]
    lib.frag_name_buf_len.restype = c.c_long
    lib.frag_name_buf_len.argtypes = [c.c_void_p]
    lib.frag_write_bgzf.restype = c.c_int
    lib.frag_write_bgzf.argtypes = [c.c_char_p, c.c_char_p, c.c_long]
    lib.tabix_build.restype = c.c_int
    lib.tabix_build.argtypes = [c.c_char_p]
    return lib
