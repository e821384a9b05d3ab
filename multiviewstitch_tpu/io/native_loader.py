"""ctypes bindings for the native IO runtime (native/libmvs_io.so).

Drop-in accelerated versions of the raw/npts/obj loaders with automatic
build-on-first-use and graceful pure-Python fallback (io/rawdepth.py,
io/meshio.py). The native library threads batch raw loads so host IO
overlaps instead of serializing the device feed (the reference loads every
depth map serially on the single main thread, Processor.cpp:35-40).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _repo_root():
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _load_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_repo_root(), "native", "libmvs_io.so")
    if not os.path.exists(so):
        # build under a private name, then rename into place: concurrent
        # processes (parallel test workers) never load a half-written file
        build = os.path.join(_repo_root(), "native", "build.sh")
        tmp = f"{so}.{os.getpid()}.tmp"
        try:
            subprocess.run(["sh", build, tmp], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (subprocess.SubprocessError, OSError):
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None

    lib.mvs_load_raw_batch.restype = ctypes.c_int
    lib.mvs_load_raw_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.mvs_write_raw.restype = ctypes.c_int
    lib.mvs_write_raw.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_int64]
    lib.mvs_parse_npts.restype = ctypes.c_int64
    lib.mvs_parse_npts.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64]
    lib.mvs_parse_obj_counts.restype = ctypes.c_int
    lib.mvs_parse_obj_counts.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.mvs_parse_obj.restype = ctypes.c_int
    lib.mvs_parse_obj.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load_lib() is not None


def load_raw_batch(paths: List[str], width: int, height: int,
                   num_threads: int = 8) -> np.ndarray:
    """Load N raw disparity files -> [N,H,W] float32 (threaded native path,
    numpy fallback)."""
    lib = _load_lib()
    n = len(paths)
    if lib is None:
        from .rawdepth import load_depth_raw
        return np.stack([load_depth_raw(p, width, height) for p in paths]) \
            if n else np.zeros((0, height, width), np.float32)
    out = np.empty((n, height, width), np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.mvs_load_raw_batch(
        arr, n, width * height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if rc != 0:
        raise IOError(f"native raw batch load failed at {paths[rc - 1]}")
    return out


def parse_npts(path: str, max_points: int = 50_000_000
               ) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load_lib()
    if lib is None:
        from .meshio import read_npts
        return read_npts(path)
    # size the buffer from the file size (>= 6 floats of ~2 chars each)
    cap = min(max_points, max(os.path.getsize(path) // 12 + 16, 16))
    buf = np.empty((cap, 6), np.float32)
    n = lib.mvs_parse_npts(path.encode(),
                           buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           cap)
    if n < 0:
        raise IOError(f"native npts parse failed: {path}")
    data = buf[:n]
    return data[:, :3].copy(), data[:, 3:].copy()


def parse_obj(path: str):
    lib = _load_lib()
    if lib is None:
        from .meshio import read_obj
        return read_obj(path)
    nv = ctypes.c_int64()
    nn = ctypes.c_int64()
    nf = ctypes.c_int64()
    if lib.mvs_parse_obj_counts(path.encode(), ctypes.byref(nv),
                                ctypes.byref(nn), ctypes.byref(nf)):
        raise IOError(f"native obj parse failed: {path}")
    verts = np.empty((nv.value, 3), np.float32)
    normals = np.empty((nn.value, 3), np.float32)
    faces = np.empty((nf.value, 3), np.int32)
    if lib.mvs_parse_obj(path.encode(),
                         verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         normals.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_float)),
                         faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         nv.value, nn.value, nf.value):
        raise IOError(f"native obj parse failed: {path}")
    return verts, (normals if nn.value else None), faces


def write_raw(path: str, data: np.ndarray):
    lib = _load_lib()
    a = np.ascontiguousarray(data, np.float32)
    if lib is None:
        a.tofile(path)
        return
    if lib.mvs_write_raw(path.encode(),
                         a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         a.size):
        raise IOError(f"native raw write failed: {path}")
