"""Lazy builder/loader for the MinLZ native (C++) host runtime.

Compiles every tracked ``.cpp`` in this directory into one shared library
with g++ on first use.  The library lands in ``build/`` next to the sources
(listed in ``.gitignore``) under a name keyed by a hash of the sources and
the compiler command, so a checkout never picks up a library built from
other sources.  The build targets the baseline ISA: the x86 CRC32C
instructions are dispatched at run time (``crc32c.cpp``), so one build runs
on any host of the architecture.  Pure-Python fallbacks exist for every
native entry point, so environments without a toolchain still work.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(_DIR, "build")
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden"]
_lock = threading.Lock()
_lib = None
_build_failed = False


def _sources() -> list[str]:
    return sorted(
        os.path.join(_DIR, f) for f in os.listdir(_DIR)
        if f.endswith((".cpp", ".h"))
    )


def lib_path() -> str:
    """Path of the library built from the current sources and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libminlz_native-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile into ``path``.  Concurrent processes (test workers) serialize
    on a lock file; the object is written beside the target and renamed into
    place, so no process ever loads a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(path):
            return
        tmp = path + ".partial"
        cpp = [s for s in _sources() if s.endswith(".cpp")]
        subprocess.run(["g++", *_FLAGS, "-o", tmp, *cpp], check=True,
                       capture_output=True)
        os.replace(tmp, path)


def get_lib():
    """Return the loaded native library, or None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.minlz_crc32c.restype = ctypes.c_uint32
            lib.minlz_crc32c.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
            ]
            if hasattr(lib, "minlz_huff0_decode_stream"):
                lib.minlz_huff0_decode_stream.restype = ctypes.c_long
                lib.minlz_huff0_decode_stream.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                    ctypes.c_char_p, ctypes.c_size_t,
                ]
                lib.minlz_huff0_encode_stream.restype = ctypes.c_long
                lib.minlz_huff0_encode_stream.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t,
                    ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_char_p, ctypes.c_size_t,
                ]
            _lib = lib
        except Exception:
            _build_failed = True
    return _lib
