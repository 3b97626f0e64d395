"""Build and load the package's CUDA kernels.

At first use, ``library()`` compiles every ``csrc/*.cu`` of this package
with ``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain
C interface, and loads it with ``ctypes``.  The library goes to
``build/pyslam_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources and flags, so an unchanged tree builds once.  Nothing is
built or loaded at import time.  A missing ``nvcc`` or a failed build
raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_PKG = pathlib.Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "pyslam_tpu_torch"
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (pointers, then ints, then the stream)
_SIGNATURES = {
    "pyslam_ell_matvec_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pyslam_ell_matvec_f64": [_P, _P, _P, _P, _I, _I, _I, _P],
    "pyslam_slot_reduce_f32": [_P, _P, _P, _P, _I, _I, _P],
    "pyslam_slot_reduce_f64": [_P, _P, _P, _P, _I, _I, _P],
}

_LIB = None
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): cannot build the kernels")


def build() -> pathlib.Path:
    """Compile the kernels if this exact source set has not been built yet;
    return the shared library's path.  ``BUILD_INFO`` records the build
    time and the compiler's register/spill report."""
    srcs = sorted(_SRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libpyslam_kernels.so"
    if lib_path.is_file():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libpyslam_kernels.{os.getpid()}.so"
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    (out_dir / "ptxas.log").write_text(proc.stdout + proc.stderr)
    BUILD_INFO.update(
        path=str(lib_path), seconds=seconds, cached=False, log=proc.stdout + proc.stderr
    )
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
