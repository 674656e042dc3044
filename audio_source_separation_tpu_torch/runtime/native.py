"""Native (C) host-side pieces, built with the system C compiler and loaded
with ``ctypes``.

The one such piece is the FDICA frequency-permutation solver: a greedy
sweep over the bins, sequential and data-dependent (reference
``bss/fdica.py:106-138``), whose C source ``native/permutation.c`` the port
shares with the JAX package.  The library is compiled on first use with
``cc -O3 -shared -fPIC`` (``$CC`` overrides ``cc``) into ``build/native/``
beside the package by the kernels' builder (``ops/_build.py``), named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one reused.  Without a compiler the loader returns ``None`` and
the caller takes its NumPy route.
"""

import ctypes
import functools
import os
from pathlib import Path

import numpy as np

from ..ops._build import build_shared, hashed_library

REPO_DIR = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = REPO_DIR / "native"
BUILD_DIR = REPO_DIR / "build" / "native"
CC_FLAGS = ("-O3", "-shared", "-fPIC")
MAX_SOURCES = 8  # permutation.c's MAX_SOURCES


@functools.cache
def load(name):
    """The ``ctypes`` library of ``native/<name>.c``, built on first use;
    ``None`` if it cannot be built or loaded."""
    src = NATIVE_DIR / (name + ".c")
    if not src.exists():
        return None
    target = hashed_library(BUILD_DIR, name, [src], CC_FLAGS)
    if not target.exists():
        try:
            _, failed = build_shared({name: ([os.environ.get("CC", "cc"), *CC_FLAGS], src, target)})
        except OSError:
            return None
        if failed:
            return None
    try:
        return ctypes.CDLL(str(target))
    except OSError:
        return None


def solve_permutation_native(P, order):
    """Greedy permutation alignment in C.

    Args:
        P: normalised envelopes ``(n_bins, n_sources, n_frames)`` float64.
        order: the bins' processing order ``(n_bins,)`` int64.
    Returns:
        each bin's source permutation ``(n_bins, n_sources)`` int64, or
        ``None`` where the library is unavailable or ``n_sources > 8``.
    """
    n_bins, n_sources, n_frames = P.shape
    if not 1 <= n_sources <= MAX_SOURCES or order.shape != (n_bins,):
        return None
    lib = load("permutation")
    if lib is None:
        return None
    P = np.ascontiguousarray(P, dtype=np.float64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    # perms (n_bins, n_sources) int64, then the float64 criterion scratch
    # (n_sources, n_frames) that permutation.c keeps behind them
    out = np.zeros(n_bins * n_sources + n_sources * n_frames, dtype=np.int64)
    fn = lib.solve_permutation
    long_p = ctypes.POINTER(ctypes.c_long)
    fn.argtypes = [ctypes.POINTER(ctypes.c_double), long_p, ctypes.c_long, ctypes.c_long, ctypes.c_long, long_p]
    fn.restype = ctypes.c_int
    status = fn(
        P.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        order.ctypes.data_as(long_p),
        n_bins,
        n_sources,
        n_frames,
        out.ctypes.data_as(long_p),
    )
    if status != 0:
        return None
    return out[: n_bins * n_sources].reshape(n_bins, n_sources).copy()
