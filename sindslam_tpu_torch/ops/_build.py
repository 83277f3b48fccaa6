"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points (device pointers, ints,
floats and a stream handle; an ``int`` CUDA error code back). It is compiled
at first use, for ``sm_90a``, into ``<build dir>/<name>-<hash>.so``; the hash
covers the source and the flags, so an edited source never loads a stale
library. Nothing is built at import time. The build directory is
``$SINDSLAM_TORCH_BUILD_DIR`` if set, else ``build/sindslam_tpu_torch`` next
to the package (listed in ``.gitignore``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
KERNEL_SOURCES = ("sor_inner", "cc_labels", "fast_nms", "extract_patches")
# --fmad=false: no multiply-add contraction, so that a kernel rounds each
# operation once, as each PyTorch op of its plain version does (K1 is then
# its plain version bit for bit, as K2-K4 already were)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# every C entry point: symbol -> (source, argtypes); all return an int. Each
# kernel takes a lane count B: its tensors are (B, ...) stacks
SIGNATURES = {
    # 10 fields, buf, B, h, w, alpha, gamma, omega, inner, sweeps, stream
    "sor_inner": ("sor_inner",
                  [_P] * 11 + [_I, _I, _I, _F, _F, _F, _I, _I, _P]),
    "sor_inner_launches": ("sor_inner", [_I, _I, _I, _I]),
    # seed, mask, labels, mask bytes, mask strides (lane, row, column),
    # labels strides, buf, flags, B, h, w, n_sweeps, launches made (host
    # int), stream
    "cc_labels": ("cc_labels",
                  [_P] * 3 + [_I, _L, _I, _I, _L, _I, _I, _P, _P, _I, _I, _I,
                              _I, _P, _P]),
    "cc_labels_launches": ("cc_labels", [_I, _I, _I, _I]),
    # img, out, B, H, W, levels (host ints), n_levels, min_th, ini_th, stream
    "fast_nms": ("fast_nms", [_P, _P, _I, _I, _I, _P, _I, _F, _F, _P]),
    # img, y0, x0, out, B, N, h, w, patch, stream
    "extract_patches": ("extract_patches",
                        [_P] * 4 + [_I, _I, _I, _I, _I, _P]),
    # img, y0, x0, bins, table, out, B, N, h, w, stream
    "brief_from_patches": ("extract_patches",
                           [_P] * 6 + [_I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> str:
    d = os.environ.get("SINDSLAM_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(_CSRC)), "build", "sindslam_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def nvcc_path() -> str:
    cand = [os.path.join(os.environ[k], "bin", "nvcc")
            for k in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(k)]
    cand.append("/usr/local/cuda/bin/nvcc")
    for c in cand:
        if os.path.exists(c):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> str:
    with open(os.path.join(_CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile the named sources that have no up-to-date library, one
    ``nvcc`` per source, all started together. Returns {name: ptxas log}
    for the sources compiled by this call. Raises on a failed build."""
    todo = [(n, _target(n)) for n in names if not os.path.exists(_target(n))]
    nvcc = nvcc_path()
    procs = []
    for name, target in todo:
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, name + ".cu")]
        procs.append((name, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for name, target, tmp, proc in procs:
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(symbol: str):
    """The ctypes entry point ``symbol``, its source built if needed."""
    with _lock:
        fn = _loaded.get(symbol)
        if fn is None:
            source, argtypes = SIGNATURES[symbol]
            build([source])
            fn = getattr(ctypes.CDLL(_target(source)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[symbol] = fn
    return fn
