"""Build, binding and launch counters of the hand-written CUDA kernels.

``csrc/*.cu`` is compiled with ``nvcc`` into one shared library with a
plain C interface, at first use, into ``muon_tpu_torch/_build/``: one
``nvcc -c`` per source, all started together, then one link. The file
name carries a hash of the sources, their shared headers (``*.cuh``) and
the flags, so an edited source rebuilds.
Nothing here runs at import: the CPU tests import every module and never
build. A missing ``nvcc`` or a failed build raises with the compiler's
output; there is no fallback to the plain versions.

Launch counters: every kernel wrapper adds one to its entry in
``_LAUNCHES`` each time it launches its kernel, and nowhere else, so a run
can show that it really went through the kernels
(``reset_launch_counts()`` before, ``launch_counts()`` after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import torch

__all__ = [
    "KERNELS",
    "build",
    "library",
    "launch",
    "launch_counts",
    "library_path",
    "reset_launch_counts",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argtypes (pointers and the stream as c_void_p, or ctypes
# would pass them as 32-bit ints and cut them)
_SIGNATURES = {
    "mt_tfidf_values": (_P, _P, _P, _I, _LL, _P, _I, _I, _I, _I, _F, _P, _P),
    "mt_csr_spmm": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    "mt_csr_spmm_t": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
    "mt_csr_spmm_split": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "mt_csr_gram_matmul": (_P, _P, _P, _P, _I, _I, _P, _P),
    "mt_csr_row_sums": (_P, _P, _I, _P, _P),
    "mt_csr_scale_rows": (_P, _P, _P, _I, _P, _P),
    "mt_knn_topk": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P),
    "mt_smooth_knn": (_P, _I, _I, _F, _F, _P, _I, _F, _P, _P, _P, _P),
    "mt_wnn_bandwidth": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P, _I, _P, _P),
    "mt_wnn_theta": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "mt_wnn_fusion_scores": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "mt_clr_dense": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
    "mt_umap_epoch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                      _F, _P),
    "mt_membership_matvec": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P),
    "mt_ivf_search": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "mt_kmeans_assign": (_P, _P, _P, _I, _I, _I, _P, _P),
    "mt_mofa_col_dot": (_P, _P, _LL, _I, _I, _P, _P, _P),
    "mt_mofa_w_posterior": (_P, _P, _P, _LL, _P, _LL, _P, _P, _P, _P, _F, _I, _I, _I, _I,
                            _I, _P, _P, _P, _P, _P, _P),
    "mt_mofa_row_dot": (_P, _P, _LL, _P, _P, _P, _LL, _I, _I, _P, _P, _P, _P),
    "mt_mofa_rank1_update": (_P, _P, _LL, _P, _LL, _P, _I, _I, _P),
    "mt_gmm_background_means": (_P, _P, _I, _I, _I, _F, _P, _P, _P, _P, _P),
    "mt_umap_epoch_asym": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _F, _F, _F, _F, _P),
    "mt_mofa_bound_refresh": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "mt_gp_rbf_kernel": (_P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P),
    "mt_gp_kg_grad": (_P, _P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P),
    "mt_wilcoxon_rank_sums": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
    "mt_logreg_softmax_grad": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    "mt_adam_update": (_P, _P, _P, _P, _LL, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F,
                       _F, _F, _F, _P),
    "mt_snf_affinity": (_P, _P, _I, _I, _F, _F, _P, _P, _P),
    "mt_snf_normalize": (_P, _I, _P, _P, _P),
    "mt_snf_dominate_set": (_P, _I, _I, _P, _P),
    "mt_ica_contrast": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "mt_nmf_update": (_P, _P, _P, _I, _I, _I, _F, _I, _I, _P, _P, _P, _P),
    "mt_tfidf_dense": (_P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P),
    "mt_l2norm_dense": (_P, _I, _I, _P, _P),
    "mt_pwm_scan": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                    _P, _P, _I, _P),
    "mt_interval_pileup": (_P, _P, _P, _P, _LL, _I, _I, _P, _P),
}

# counter name -> the C entry point it counts
KERNELS = {
    "tfidf_values": "mt_tfidf_values",
    "csr_spmm_f32": "mt_csr_spmm",
    "csr_spmm_bf16": "mt_csr_spmm",
    "csr_spmm_split": "mt_csr_spmm_split",  # rows cut into pieces, added in order
    "csr_spmm_t_f32": "mt_csr_spmm_t",
    "csr_spmm_t_bf16": "mt_csr_spmm_t",
    "csr_gram_matmul": "mt_csr_gram_matmul",
    "csr_row_sums": "mt_csr_row_sums",
    "csr_scale_rows": "mt_csr_scale_rows",
    "knn_topk": "mt_knn_topk",
    "knn_topk_global": "mt_knn_topk",  # lists longer than 256: the heap in the outputs
    "smooth_knn_membership": "mt_smooth_knn",
    "wnn_bandwidth": "mt_wnn_bandwidth",
    "wnn_bandwidth_global": "mt_wnn_bandwidth",  # the candidates in global memory
    "wnn_theta": "mt_wnn_theta",
    "wnn_fusion_scores": "mt_wnn_fusion_scores",
    "clr_dense": "mt_clr_dense",
    "umap_epoch": "mt_umap_epoch",
    "ivf_search": "mt_ivf_search",
    "ivf_search_global": "mt_ivf_search",  # lists longer than 256: the heap in the outputs
    "kmeans_assign": "mt_kmeans_assign",
    "membership_matvec": "mt_membership_matvec",
    "mofa_col_dot": "mt_mofa_col_dot",
    "mofa_w_posterior": "mt_mofa_w_posterior",
    "mofa_row_dot": "mt_mofa_row_dot",
    "mofa_rank1_update": "mt_mofa_rank1_update",
    "gmm_background_means": "mt_gmm_background_means",
    "umap_epoch_asym": "mt_umap_epoch_asym",
    "mofa_bound_refresh": "mt_mofa_bound_refresh",
    "gp_rbf_kernel": "mt_gp_rbf_kernel",
    "gp_kg_grad": "mt_gp_kg_grad",
    "wilcoxon_rank_sums": "mt_wilcoxon_rank_sums",
    "logreg_softmax_grad": "mt_logreg_softmax_grad",
    "adam_update": "mt_adam_update",
    "snf_affinity": "mt_snf_affinity",
    "snf_normalize": "mt_snf_normalize",
    "snf_dominate_set": "mt_snf_dominate_set",
    "ica_contrast": "mt_ica_contrast",
    "nmf_update": "mt_nmf_update",
    "tfidf_dense": "mt_tfidf_dense",
    "l2norm_dense": "mt_l2norm_dense",
    "pwm_scan": "mt_pwm_scan",  # each mode's launch (count, write, scores) counts one
    "interval_pileup": "mt_interval_pileup",  # scatter and row scan count as one
}

_LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked under CUDA_HOME and on PATH); the CUDA "
            "kernels of muon_tpu_torch cannot be built"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + _headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmuon_torch_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless a library of the same hash exists: the
    sources in parallel, one ``nvcc -c`` each, then one ``nvcc -shared``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o") for src in _sources()]
    jobs = []
    for src, obj in zip(_sources(), objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    log, failure = [], None
    for cmd, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0 and failure is None:
            failure = (proc.returncode, out + err)
    if failure is None:
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failure = (proc.returncode, proc.stdout + proc.stderr)
    so.with_suffix(".log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failure is not None:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {failure[0]}:\n{failure[1]}")
    os.replace(tmp, so)  # atomic: concurrent builds see whole files only
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(kernel: str, device: torch.device, *args) -> None:
    """Call the C entry point of ``kernel`` on ``device``'s current stream,
    count the launch, and raise if CUDA reports an error. The caller's
    current device is restored afterwards."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, KERNELS[kernel])(*args, stream)
    _LAUNCHES[kernel] += 1
    if err != 0:
        raise RuntimeError(
            f"{kernel}: CUDA error {err} "
            f"({lib.mt_error_string(err).decode()})"
        )


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0
