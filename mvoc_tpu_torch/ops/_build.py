"""Build the hand-written CUDA kernels in `mvoc_tpu_torch/csrc/` at first use.

Each `csrc/*.cu` compiles with `nvcc -gencode arch=compute_90a,code=sm_90a`
into its own shared library with a plain C interface, loaded with ctypes
(no PyTorch headers in the sources, so a build takes seconds, not the
minutes an extension built against torch takes).  All sources compile in
parallel, one nvcc process each.  Libraries are named by a hash of their
sources and flags, so an edited source rebuilds and an unchanged one loads.

The build directory is `build/kernels/` beside the package (listed in
.gitignore); MVOC_TORCH_BUILD_DIR overrides it.  A failed build raises with
nvcc's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, ctypes._CFuncPtr] = {}
# nvcc's -Xptxas -v report (registers, shared memory, spills) per source
build_logs: Dict[str, str] = {}


def build_dir() -> str:
    return os.environ.get("MVOC_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "kernels")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels of mvoc_tpu_torch are built "
                       "from csrc/ with the CUDA toolkit (set CUDA_HOME)")


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest(src: str) -> str:
    h = hashlib.sha1()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def _lib_path(src: str) -> str:
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir(), f"lib{stem}-{_digest(src)}.so")


def library_path(stem: str) -> str:
    """Where the library built from csrc/<stem>.cu lives (built or not)."""
    return _lib_path(os.path.join(CSRC_DIR, f"{stem}.cu"))


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all nvcc processes
    started together.  Returns {source stem: seconds} of what was built."""
    import time

    os.makedirs(build_dir(), exist_ok=True)
    todo = [(s, _lib_path(s)) for s in _sources() if not os.path.exists(_lib_path(s))]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = []
    t0 = time.perf_counter()
    for src, out in todo:
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, src]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    times = {}
    errors = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        stem = os.path.splitext(os.path.basename(src))[0]
        build_logs[stem] = log
        times[stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def load(stem: str) -> ctypes.CDLL:
    """The ctypes library built from csrc/<stem>.cu (built on first call)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is not None:
            return lib
        src = os.path.join(CSRC_DIR, f"{stem}.cu")
        if not os.path.exists(src):
            raise FileNotFoundError(src)
        path = library_path(stem)
        if not os.path.exists(path):
            build_all()
        lib = ctypes.CDLL(path)
        _libs[stem] = lib
        return lib


def function(stem: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point `name` of csrc/<stem>.cu's library, returning a
    cudaError_t, with its argument types set once (built on first call):
    setting them on every launch costs the wrappers' host time."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(load(stem), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[(stem, name)] = fn
    return fn


def check(stem: str, err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point of
    csrc/<stem>.cu's library."""
    if err != 0:
        fn = load(stem).mvoc_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err} ({fn(int(err)).decode()})")
