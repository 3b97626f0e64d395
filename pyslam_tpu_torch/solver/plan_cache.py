"""Content-keyed, bounded caches for solver plans.

Counterpart of ``pyslam_tpu/solver/plan_cache.py``, for plan reuse only:
the port has no compiled closures to keep, so a cache here maps the content
of a graph structure to the plan built for it (``sparse_chol``,
``schur_sparse``).

Keys are CONTENT hashes, never ``id()``: a recycled id with different
content would hand back a stale plan, and id-keyed entries pin their
objects and grow the cache per solve.

``content_key(obj)`` hashes dataclass fields recursively (arrays and
tensors by dtype, shape and bytes).  A tensor on a CUDA device is read to
the host to be hashed: callers hash index tensors at plan time, never
inside a solver loop.  Keys are memoized per live object in an id->key map
guarded by a weakref callback, so repeated solves with one plan hash once
and the memo never pins the plan.

``ClosureCache`` is a small LRU, so that distinct plans cannot grow a
global dict without bound; matching content always maps to one entry.
"""

from __future__ import annotations

import dataclasses
import hashlib
import weakref
from collections import OrderedDict

import numpy as np
import torch


def _update(h, v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        h.update(type(v).__name__.encode())
        for f in dataclasses.fields(v):
            _update(h, getattr(v, f.name))
    elif isinstance(v, (tuple, list)):
        h.update(f"seq{len(v)}".encode())
        for x in v:
            _update(h, x)
    elif isinstance(v, dict):
        h.update(f"map{len(v)}".encode())
        for k in sorted(v, key=repr):
            h.update(repr(k).encode())
            _update(h, v[k])
    elif torch.is_tensor(v):
        a = v.detach().cpu().contiguous()
        h.update(str((str(a.dtype), tuple(a.shape))).encode())
        h.update(a.view(-1).view(torch.uint8).numpy().tobytes() if a.numel() else b"")
    elif hasattr(v, "shape") and hasattr(v, "dtype"):  # ndarray
        a = np.asarray(v)
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())
    else:
        h.update(repr(v).encode())


# id -> key memo; weakref finalizers evict entries when the object dies, so
# a recycled id can never return a stale key.
_MEMO: dict[int, str] = {}


def content_key(obj) -> str:
    """Stable hex digest of the object's content (see module docstring)."""
    oid = id(obj)
    cached = _MEMO.get(oid)
    if cached is not None:
        return cached
    h = hashlib.sha1()
    _update(h, obj)
    key = h.hexdigest()[:16]
    try:
        weakref.finalize(obj, _MEMO.pop, oid, None)
    except TypeError:
        return key  # unweakrefable: skip the memo, still correct
    _MEMO[oid] = key
    return key


class ClosureCache:
    """Bounded LRU mapping content keys -> prepared plans."""

    def __init__(self, maxsize: int = 32):
        self._d: OrderedDict = OrderedDict()
        self.maxsize = maxsize

    def __contains__(self, key):
        return key in self._d

    def __len__(self):
        return len(self._d)

    def __getitem__(self, key):
        val = self._d[key]
        self._d.move_to_end(key)
        return val

    def __setitem__(self, key, val):
        self._d[key] = val
        self._d.move_to_end(key)
        while len(self._d) > self.maxsize:
            self._d.popitem(last=False)


__all__ = ["content_key", "ClosureCache"]
