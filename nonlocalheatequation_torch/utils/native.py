"""Loader for the ctypes-exposed native libraries under native/build/ —
the port's own copy of ``nonlocalheatequation_tpu/utils/native.py``.

One place for the load-or-fallback policy (missing file, unloadable .so,
stale .so without the expected symbols -> None, callers use their NumPy
fallback).  The libraries are host C++ (``make -C native``), shared with
the JAX package; nothing here builds them.
"""

from __future__ import annotations

import ctypes
import os

_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "build",
)


def load_native_lib(soname: str, required_symbols: tuple[str, ...] = ()):
    """CDLL for native/build/<soname>, or None when it can't serve.

    ``required_symbols`` guards against a stale build: if any is missing the
    library is treated as absent rather than failing at first call.
    """
    path = os.path.join(_BUILD_DIR, soname)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    for sym in required_symbols:
        if not hasattr(lib, sym):
            return None
    return lib
