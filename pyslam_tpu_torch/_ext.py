"""Build and load the package's CUDA kernels.

At first use, ``library()`` compiles every ``csrc/*.cu`` of this package
with ``nvcc`` for Hopper (``sm_90a``), one compiler process per source and
all of them at once, links the objects into one shared library with a
plain C interface, and loads it with ``ctypes``.  The library goes to
``build/pyslam_tpu_torch/<hash>/`` at the repository root, keyed by a hash
of the sources, headers and flags, so an unchanged tree builds once.
Nothing is built or loaded at import time.  A missing ``nvcc`` or a failed
build raises; there is no fallback.
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
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMPILE = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c"]
_LINK = [*_ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C entry points: name -> argtypes (pointers, then scalars, then the stream)
_ELL_MATVEC = [_P, _P, _P, _P, _I, _I, _I, _P]
_SLOT_REDUCE = [_P, _P, _P, _P, _I, _I, _P]
# He, cols, Minv, b, x, scratch, iters, counter, nb, K, d, rtol, max_iters, stream
_ELL_PCG = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _D, _I, _P]
# poses, const_mask, cols, idx, entries, offsets, n_batches, then host tables
# (T_obs, sqrt_info, weight pointers; first; n_slots; loss; loss_params),
# scratch, its length, He, g, chi2, nb, K, stream
_ELL_ASSEMBLE = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P, _I, _I, _P]
_SIGNATURES = {
    "pyslam_ell_matvec_f32": _ELL_MATVEC,
    "pyslam_ell_matvec_f64": _ELL_MATVEC,
    "pyslam_slot_reduce_f32": _SLOT_REDUCE,
    "pyslam_slot_reduce_f64": _SLOT_REDUCE,
    "pyslam_ell_assemble_f32": _ELL_ASSEMBLE,
    "pyslam_ell_assemble_f64": _ELL_ASSEMBLE,
    "pyslam_ell_pcg_f32": _ELL_PCG,
    "pyslam_ell_pcg_f64": _ELL_PCG,
    # nb, K, d, element size, out (5 ints)
    "pyslam_ell_pcg_plan": [_I, _I, _I, _I, ctypes.POINTER(ctypes.c_int)],
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


def _fail(cmd, returncode, output):
    raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}")


def build() -> pathlib.Path:
    """Compile the kernels if this exact source set has not been built yet;
    return the shared library's path.  ``BUILD_INFO`` records the build
    time and the compiler's register/spill report."""
    srcs = sorted(_SRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_COMPILE + _LINK).encode())
    for s in srcs + sorted(_SRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "libpyslam_kernels.so"
    if lib_path.is_file():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    pid = os.getpid()
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    jobs = []
    for s in srcs:
        obj = out_dir / f"{s.stem}.{pid}.o"
        cmd = [nvcc, *_COMPILE, "-o", str(obj), str(s)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log = ""
    outputs = [popen.communicate() for _, _, popen in jobs]  # wait for all before raising for one
    for (cmd, _, popen), (out, err) in zip(jobs, outputs):
        if popen.returncode != 0:
            _fail(cmd, popen.returncode, out + err)
        log += out + err
    tmp = out_dir / f"libpyslam_kernels.{pid}.so"
    cmd = [nvcc, *_LINK, "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        _fail(cmd, proc.returncode, proc.stdout + proc.stderr)
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib_path)
    for _, obj, _ in jobs:
        obj.unlink()
    (out_dir / "ptxas.log").write_text(log)
    BUILD_INFO.update(path=str(lib_path), seconds=seconds, cached=False, log=log)
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
