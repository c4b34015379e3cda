"""ctypes bindings of the native trajectory codec (csrc/traj_codec.cpp,
host C++, not a kernel).

The library is built with g++ at first use into `build/native/` beside the
package (gitignored; MVOC_TORCH_BUILD_DIR overrides the directory), named by
a hash of its source and flags so that an edited source rebuilds.  When it
cannot be built or loaded, a warning is logged and the trajectory store
writes the npz container instead, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "traj_codec.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-lpthread"]
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha1()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    out_dir = os.environ.get("MVOC_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "native")
    return os.path.join(out_dir, f"libtraj_codec-{h.hexdigest()[:12]}.so")


def _build(path: str) -> bool:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        subprocess.run([cxx, SOURCE, "-o", tmp, *CXX_FLAGS], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("native trajectory codec build failed (%s %s); using the npz container",
                       e, detail.decode(errors="replace").strip())
        return False


def get_lib():
    """The loaded codec library, or None when it is unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:  # pragma: no cover
            logger.warning("cannot load the native trajectory codec: %s", e)
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        lib.mvoc_f32_to_f16.argtypes = [f32p, u16p, ctypes.c_uint64]
        lib.mvoc_f16_to_f32.argtypes = [u16p, f32p, ctypes.c_uint64]
        lib.mvoc_traj_write.argtypes = [
            ctypes.c_char_p, i32p, ctypes.c_uint32, u32p, ctypes.c_uint32, f32p]
        lib.mvoc_traj_write.restype = ctypes.c_int
        lib.mvoc_traj_open.argtypes = [ctypes.c_char_p]
        lib.mvoc_traj_open.restype = ctypes.c_void_p
        lib.mvoc_traj_n_steps.argtypes = [ctypes.c_void_p]
        lib.mvoc_traj_n_steps.restype = ctypes.c_uint32
        lib.mvoc_traj_n_dims.argtypes = [ctypes.c_void_p]
        lib.mvoc_traj_n_dims.restype = ctypes.c_uint32
        lib.mvoc_traj_meta.argtypes = [ctypes.c_void_p, u32p, i32p]
        lib.mvoc_traj_gather.argtypes = [ctypes.c_void_p, u32p, ctypes.c_uint32, f32p]
        lib.mvoc_traj_gather.restype = ctypes.c_int
        lib.mvoc_traj_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def traj_write(path: str, timesteps: np.ndarray, latents_f32: np.ndarray) -> bool:
    """Write a .mvoctraj container; False when the codec is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    ts = np.ascontiguousarray(timesteps, dtype=np.int32)
    data = np.ascontiguousarray(latents_f32, dtype=np.float32)
    dims = np.asarray(data.shape[1:], dtype=np.uint32)
    rc = lib.mvoc_traj_write(
        path.encode(), _ptr(ts, ctypes.c_int32), np.uint32(len(ts)),
        _ptr(dims, ctypes.c_uint32), np.uint32(len(dims)), _ptr(data, ctypes.c_float))
    return rc == 0


class NativeTrajReader:
    """mmap-backed reader; gather_indices() converts fp16 -> fp32 in native
    threads."""

    def __init__(self, path: str):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native trajectory codec unavailable")
        self._lib = lib
        self._h = lib.mvoc_traj_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"cannot open trajectory container {path}")
        n_dims = lib.mvoc_traj_n_dims(self._h)
        self.n_steps = lib.mvoc_traj_n_steps(self._h)
        dims = np.zeros(n_dims, np.uint32)
        ts = np.zeros(self.n_steps, np.int32)
        lib.mvoc_traj_meta(self._h, _ptr(dims, ctypes.c_uint32), _ptr(ts, ctypes.c_int32))
        self.dims = tuple(int(d) for d in dims)
        self.timesteps = ts

    def gather_indices(self, indices: np.ndarray) -> np.ndarray:
        idx = np.ascontiguousarray(indices, dtype=np.uint32)
        out = np.empty((len(idx),) + self.dims, np.float32)
        rc = self._lib.mvoc_traj_gather(self._h, _ptr(idx, ctypes.c_uint32),
                                        np.uint32(len(idx)), _ptr(out, ctypes.c_float))
        if rc != 0:
            raise IndexError("trajectory step index out of range")
        return out

    def close(self):
        if self._h:
            self._lib.mvoc_traj_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
