"""ctypes bindings for the C++ voxel store, PyTorch port's copy of
``sindslam_tpu/runtime/native.py``.

``cpp/voxel_store.cpp`` is compiled with ``g++`` at first use into
``<build dir>/voxel_store-<hash>.so`` (the build directory of
``ops/_build.py``; the hash covers the source and the flags, so an edited
source never loads a stale library). Nothing is built at import time, and a
failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from sindslam_tpu_torch.ops._build import build_dir

_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp",
                       "voxel_store.cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    """Where the store's shared library is (or will be) built."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(build_dir(),
                        f"voxel_store-{digest.hexdigest()[:16]}.so")


def _build(target: str) -> None:
    tmp = f"{target}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, _SOURCE, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {_SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.vstore_create.restype = ctypes.c_void_p
        lib.vstore_create.argtypes = [ctypes.c_double, ctypes.c_float,
                                      ctypes.c_float, ctypes.c_float,
                                      ctypes.c_float]
        lib.vstore_destroy.argtypes = [ctypes.c_void_p]
        lib.vstore_insert_async.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.vstore_flush.argtypes = [ctypes.c_void_p]
        lib.vstore_size.restype = ctypes.c_int64
        lib.vstore_size.argtypes = [ctypes.c_void_p]
        lib.vstore_export_sor.restype = ctypes.c_int64
        lib.vstore_export_sor.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.vstore_export_free.restype = ctypes.c_int64
        lib.vstore_export_free.argtypes = [
            ctypes.c_void_p, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.vstore_export_coarse.restype = ctypes.c_int64
        lib.vstore_export_coarse.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_float, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.vstore_save_pcd_sor.restype = ctypes.c_int
        lib.vstore_save_pcd_sor.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_float, ctypes.c_uint32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_int32]
        lib.vstore_save_ot.restype = ctypes.c_int
        lib.vstore_save_ot.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_float,
            ctypes.c_uint32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32]
        _lib = lib
        return lib


class VoxelStore:
    """Pythonic wrapper over the native store."""

    def __init__(self, resolution: float = 0.02, lo_hit: float = 0.85,
                 lo_miss: float = -0.4, lo_min: float = -2.0,
                 lo_max: float = 3.5):
        self._lib = load_library()
        self._h = self._lib.vstore_create(resolution, lo_hit, lo_miss,
                                          lo_min, lo_max)
        self.resolution = resolution

    def insert(self, vox_xyz: np.ndarray, rgb: np.ndarray, hit: np.ndarray
               ) -> None:
        """Queue a batch: (N, 3) int32 voxel coords, (N, 3) uint8 colors,
        (N,) uint8/bool hit flags. Returns immediately (background worker,
        which copies the batch before this returns)."""
        vox = np.ascontiguousarray(vox_xyz, np.int32)
        col = np.ascontiguousarray(rgb, np.uint8)
        h = np.ascontiguousarray(hit, np.uint8)
        n = len(h)
        if vox.shape != (n, 3) or col.shape != (n, 3):
            raise ValueError(f"insert: vox {vox.shape}, rgb {col.shape} and "
                             f"hit {h.shape} disagree")
        self._lib.vstore_insert_async(
            self._h, vox.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            col.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n)

    def flush(self) -> None:
        self._lib.vstore_flush(self._h)

    def __len__(self) -> int:
        return int(self._lib.vstore_size(self._h))

    def export(self, min_log_odds: float = 0.85, min_hits: int = 2,
               max_out: int = 4_000_000, sor_mean_k: int = 0,
               sor_stddev: float = 1.0, sor_radius: int = 6
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Occupied voxels -> ((N, 3) float32 centers [m], (N, 3) uint8 rgb).

        sor_mean_k > 0 applies kNN statistical outlier removal in the native
        store (reference pubPointCloud.cc:291-296, meanK=100 stddev=1.0)."""
        self.flush()
        xyz = np.zeros((max_out, 3), np.int32)
        rgb = np.zeros((max_out, 3), np.uint8)
        n = self._lib.vstore_export_sor(
            self._h, min_log_odds, min_hits, sor_mean_k, sor_stddev,
            sor_radius,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_out)
        centers = (xyz[:n].astype(np.float32) + 0.5) * self.resolution
        return centers, rgb[:n].copy()

    def export_free(self, max_log_odds: float = -0.4,
                    max_out: int = 8_000_000) -> np.ndarray:
        """KNOWN-FREE voxel centers (N, 3) float32 [m]: observed cells whose
        log-odds fell to or below ``max_log_odds`` (ray misses outvoted
        hits). Evidence-based free space for the projected 2-D map."""
        self.flush()
        xyz = np.zeros((max_out, 3), np.int32)
        n = self._lib.vstore_export_free(
            self._h, max_log_odds,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out)
        return (xyz[:n].astype(np.float32) + 0.5) * self.resolution

    def export_coarse(self, resolution2: float, min_log_odds: float = 0.85,
                      min_hits: int = 2, max_out: int = 4_000_000,
                      sor_mean_k: int = 0, sor_stddev: float = 1.0,
                      sor_radius: int = 6) -> Tuple[np.ndarray, np.ndarray]:
        """Re-voxelized export at a coarser `resolution2` (octomap_server's
        secondary-map role, OctomapServer.cpp:80)."""
        self.flush()
        xyz = np.zeros((max_out, 3), np.int32)
        rgb = np.zeros((max_out, 3), np.uint8)
        n = self._lib.vstore_export_coarse(
            self._h, resolution2, min_log_odds, min_hits, sor_mean_k,
            sor_stddev, sor_radius,
            xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_out)
        centers = (xyz[:n].astype(np.float32) + 0.5) * resolution2
        return centers, rgb[:n].copy()

    def save_pcd(self, path: str, min_log_odds: float = 0.85,
                 min_hits: int = 2, sor_mean_k: int = 0,
                 sor_stddev: float = 1.0, sor_radius: int = 6) -> None:
        self.flush()
        rc = self._lib.vstore_save_pcd_sor(
            self._h, path.encode(), min_log_odds, min_hits, sor_mean_k,
            sor_stddev, sor_radius)
        if rc != 0:
            raise IOError(f"failed to write {path}")

    def save_ot(self, path: str, resolution2: float = 0.0,
                min_log_odds: float = 0.85, min_hits: int = 2,
                sor_mean_k: int = 0, sor_stddev: float = 1.0,
                sor_radius: int = 6) -> None:
        """Octree-format save (ColorOcTree .ot container; the reference's
        tree->write at pubPointCloud.cc:184-185). resolution2 > 0 rebuilds
        the octree at that resolution first."""
        self.flush()
        rc = self._lib.vstore_save_ot(
            self._h, path.encode(), resolution2, min_log_odds, min_hits,
            sor_mean_k, sor_stddev, sor_radius)
        if rc != 0:
            raise IOError(f"failed to write {path}")

    def close(self) -> None:
        if self._h:
            self._lib.vstore_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
