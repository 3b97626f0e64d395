"""The native (C++) tokenizer of the port's g2o and BAL readers.

``fastio.cpp`` holds the tokenizer: one ``std::from_chars`` pass over the
file's bytes.  At first use this module compiles it with
``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/pyslam_tpu_torch/`` at the
repository root, keyed by a hash of the source, the compiler and the flags,
so an unchanged source builds once.  The build goes to a temporary file that
is renamed into place, so concurrent processes never load a half-written
library.  Nothing is built at import time.  A missing compiler or a failed
build raises with the compiler's output; there is no pure-Python fallback on
the read path (the readers keep their pure-Python tokenizers beside it as
their plain versions, for tests).

The four functions and their results and errors are the reference's
(``pyslam_tpu/native/__init__.py``); only ``available()`` raises where the
build fails, in place of returning False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "fastio.cpp"
_BUILD_ROOT = _HERE.parents[1] / "build" / "pyslam_tpu_torch"
CXX = "g++"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_LL, _D, _I = ctypes.c_longlong, ctypes.c_double, ctypes.c_int
_SIGNATURES = {
    "ps_count_tokens": (None, [ctypes.c_char_p, _LL, ctypes.POINTER(_LL), ctypes.POINTER(_LL)]),
    "ps_parse_doubles": (_LL, [ctypes.c_char_p, _LL, ctypes.POINTER(_D), _LL]),
    "ps_scan_tagged": (_LL, [ctypes.c_char_p, _LL, ctypes.c_char_p, _LL, ctypes.POINTER(_I),
                             ctypes.POINTER(_LL), ctypes.POINTER(_I), _LL, ctypes.POINTER(_D), _LL]),
}

_lib = None


def build() -> pathlib.Path:
    """Compile ``fastio.cpp`` unless this source, compiler and flag set has
    been built already; return the shared library's path."""
    h = hashlib.sha256(" ".join([CXX, *_FLAGS]).encode())
    h.update(_SRC.read_bytes())
    out_dir = _BUILD_ROOT / f"fastio-{h.hexdigest()[:16]}"
    lib_path = out_dir / "libfastio.so"
    if lib_path.is_file():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libfastio.{os.getpid()}.so"
    cmd = [CXX, *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except FileNotFoundError as e:
        raise RuntimeError(f"{CXX} not found: cannot build the native tokenizer ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _get():
    """The loaded library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def available() -> bool:
    """True once the native library is built and loaded; raises where the
    build fails."""
    return _get() is not None


def count_tokens(buf: bytes) -> tuple[int, int]:
    """(token_count, line_count) of ``buf`` in one native pass."""
    toks, lines = _LL(), _LL()
    _get().ps_count_tokens(buf, len(buf), ctypes.byref(toks), ctypes.byref(lines))
    return toks.value, lines.value


def parse_doubles(buf: bytes) -> np.ndarray:
    """All whitespace-separated doubles in ``buf`` as a (N,) f64 array: the
    native ``np.array(buf.split(), dtype=np.float64)``.  Raises ValueError
    (with the byte offset) on malformed numeric text."""
    lib = _get()
    cap, _ = count_tokens(buf)  # exact size: one count pass
    out = np.empty(cap, np.float64)
    k = lib.ps_parse_doubles(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(_D)), cap)
    if k == cap + 1:
        raise ValueError("parse_doubles: output overflow (corrupt input?)")
    if k < 0:
        raise ValueError(f"parse_doubles: bad token at byte {-k - 1}")
    return out if k == cap else out[:k].copy()


def scan_tagged(buf: bytes, tags: list[str]):
    """Scan g2o-style tagged lines natively.

    Returns ``(tag_ids, offsets, counts, fields)``: for recognised line r,
    ``tags[tag_ids[r]]`` is its record type and
    ``fields[offsets[r] : offsets[r] + counts[r]]`` its numeric payload.
    Unknown tags and comments are skipped.  Raises ValueError on malformed
    numeric text."""
    lib = _get()
    treg = "\n".join(tags).encode()
    n_toks, n_lines = count_tokens(buf)  # exact caps: fields <= tokens, records <= lines
    line_cap, field_cap = n_lines + 1, n_toks + 1
    tag_ids = np.empty(line_cap, np.int32)
    offs = np.empty(line_cap, np.int64)
    counts = np.empty(line_cap, np.int32)
    fields = np.empty(field_cap, np.float64)
    r = lib.ps_scan_tagged(
        buf, len(buf), treg, len(treg),
        tag_ids.ctypes.data_as(ctypes.POINTER(_I)),
        offs.ctypes.data_as(ctypes.POINTER(_LL)),
        counts.ctypes.data_as(ctypes.POINTER(_I)),
        line_cap,
        fields.ctypes.data_as(ctypes.POINTER(_D)),
        field_cap)
    if r == line_cap + 1 or r == -(field_cap + 2):
        raise ValueError("scan_tagged: output overflow (corrupt input?)")
    if r < 0:
        raise ValueError(f"scan_tagged: bad token at byte {-r - 1}")
    return tag_ids[:r].copy(), offs[:r].copy(), counts[:r].copy(), fields
