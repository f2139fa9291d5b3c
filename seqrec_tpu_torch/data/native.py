"""ctypes binding to the port's native IO library
(``seqrec_tpu_torch/native_src/seqrec_io.cc``, its own copy of the JAX
package's parser).

The shared library is built with ``g++ -O3`` at first use, never when this
module is imported, into ``build/seqrec_tpu_torch/libseqrec_io-<digest>.so``
at the root of the checkout (beside the CUDA kernels of ``ops/_build.py``),
where ``digest`` hashes the source and the flags. As in the JAX package,
every entry point returns None when the toolchain, the build or the file is
unavailable, or when ``SEQREC_NO_NATIVE`` is set, and the caller then parses
with the Python tokenizer: this is a host loader, with no device involved.
``native_loads`` counts the files parsed natively.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "native_src", "seqrec_io.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "seqrec_tpu_torch")  # ops/_build.py's
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_lib_failed = False
native_loads = 0  # files parsed by the library (sequences and triplets)


class _SeqData(ctypes.Structure):
    _fields_ = [
        ("items", ctypes.POINTER(ctypes.c_int32)),
        ("ratings", ctypes.POINTER(ctypes.c_float)),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("users", ctypes.POINTER(ctypes.c_int64)),
        ("n_seq", ctypes.c_int64),
        ("n_interactions", ctypes.c_int64),
    ]


class _TripletData(ctypes.Structure):
    _fields_ = [
        ("users", ctypes.POINTER(ctypes.c_int64)),
        ("items", ctypes.POINTER(ctypes.c_int32)),
        ("ratings", ctypes.POINTER(ctypes.c_float)),
        ("n", ctypes.c_int64),
    ]


def library_path() -> str:
    digest = hashlib.sha1(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libseqrec_io-{digest.hexdigest()[:12]}.so")


def _build(target: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The loaded native library (built if needed), or None."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("SEQREC_NO_NATIVE") or not os.path.isfile(_SRC):
            _lib_failed = True
            return None
        target = library_path()
        if not os.path.isfile(target) and not _build(target):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(target)
        except OSError:
            _lib_failed = True
            return None
        lib.seqrec_load_sequences.restype = ctypes.POINTER(_SeqData)
        lib.seqrec_load_sequences.argtypes = [ctypes.c_char_p]
        lib.seqrec_free_sequences.argtypes = [ctypes.POINTER(_SeqData)]
        lib.seqrec_load_triplets.restype = ctypes.POINTER(_TripletData)
        lib.seqrec_load_triplets.argtypes = [ctypes.c_char_p]
        lib.seqrec_free_triplets.argtypes = [ctypes.POINTER(_TripletData)]
        _lib = lib
        return _lib


def _count():
    global native_loads
    with _lock:
        native_loads += 1


def load_sequences_native(filename: str):
    """Parse a sequences file natively: (items, ratings, offsets, users)
    numpy arrays, or None when the native path is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = lib.seqrec_load_sequences(filename.encode())
    if not ptr:
        return None
    d = ptr.contents
    try:
        items = np.ctypeslib.as_array(d.items, shape=(d.n_interactions,)).copy()
        ratings = np.ctypeslib.as_array(d.ratings, shape=(d.n_interactions,)).copy()
        offsets = np.ctypeslib.as_array(d.offsets, shape=(d.n_seq + 1,)).copy()
        users = np.ctypeslib.as_array(d.users, shape=(d.n_seq,)).copy()
    finally:
        lib.seqrec_free_sequences(ptr)
    _count()
    return items, ratings, offsets, users


def load_triplets_native(filename: str):
    """Parse a triplets file natively: (users, items, ratings), or None."""
    lib = get_lib()
    if lib is None:
        return None
    ptr = lib.seqrec_load_triplets(filename.encode())
    if not ptr:
        return None
    d = ptr.contents
    try:
        users = np.ctypeslib.as_array(d.users, shape=(d.n,)).copy()
        items = np.ctypeslib.as_array(d.items, shape=(d.n,)).copy()
        ratings = np.ctypeslib.as_array(d.ratings, shape=(d.n,)).copy()
    finally:
        lib.seqrec_free_triplets(ptr)
    _count()
    return users, items, ratings
