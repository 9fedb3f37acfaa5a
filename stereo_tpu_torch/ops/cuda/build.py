"""Build and load the port's CUDA kernels.

All ``stereo_tpu_torch/csrc/*.cu`` sources expose a plain ``extern "C"``
interface and include no PyTorch header, so one ``nvcc`` call builds them
into one shared library in seconds, which is loaded with ``ctypes``.  The
library is named by a hash of the sources and flags and built on first use
into ``stereo_tpu_torch/_build/`` (not committed); a later process with the
same sources reuses it.  A failed build raises; nothing is fetched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
# -Xptxas -v makes ptxas print each kernel's registers, spills and static
# shared memory (``build_log``); it does not change the code.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of each kernel's launcher: every pointer and the stream are
# void*, every size an int; each returns its cudaGetLastError() code.
_SIGNATURES = {
    "stereo_matching_core": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P),
    "stereo_sampled_window": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P),
    "stereo_upsample_blend": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "stereo_gwc_volume": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

# Seconds one nvcc call may take before the build is given up (the one
# call for every kernel takes 15-20 s on the card's machine).
NVCC_TIMEOUT_S = 900
_lock = threading.Lock()
_library = None
build_seconds = 0.0   # wall time of this process's nvcc call, 0 on a cache hit
build_log = ""        # what it printed (with -Xptxas -v: registers, spills)


def _sources():
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def library_path(sources=None) -> str:
    """Where the library of ``sources`` (default: every ``csrc/*.cu``)
    lives: named by a hash of the sources and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources or _sources():
        digest.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libstereo_kernels_{digest.hexdigest()[:16]}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA kernels cannot be built")


def compile_library(sources=None):
    """Build ``sources`` (default: every ``csrc/*.cu``) in one ``nvcc``
    call, unless that library is there already.  Returns ``(path, seconds,
    log)``: the nvcc call's wall time and what it printed (0 and "" on a
    cache hit)."""
    sources = sources or _sources()
    path = library_path(sources)
    if os.path.isfile(path):
        return path, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as exc:
        raise RuntimeError(f"nvcc took more than {NVCC_TIMEOUT_S} s: "
                           f"{' '.join(cmd)}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, time.perf_counter() - start, proc.stdout + proc.stderr


def build() -> str:
    """Build every ``csrc/*.cu`` into the port's library if it is not there
    yet; returns its path."""
    global build_seconds, build_log
    path, seconds, log = compile_library()
    if seconds:
        build_seconds, build_log = seconds, log
    return path


def load(path: str) -> ctypes.CDLL:
    """Load a kernel library and declare the launchers it has."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _library
    with _lock:
        if _library is None:
            _library = load(build())
    return _library


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")
