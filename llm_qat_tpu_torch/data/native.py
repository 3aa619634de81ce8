"""ctypes bindings for the native C++ data kernels (native/fast_data.cpp).

Counterpart of `llm_qat_tpu/data/native.py`. Compiles the shared library
on first use (g++ -O3) into `build/native/` at the checkout's root (listed
in `.gitignore`), never under `native/`; the file name carries a hash of
the source and the flags, so an edited source is rebuilt. Exposes
`chunk_tokens_native` / `gather_rows_native` with the exact semantics of
the Python `lm_datasets.chunk_tokens`, and falls back to the Python
implementations when the toolchain is unavailable (`is_available()`
reports which path is active). This is a host data path: nothing of it
runs on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "fast_data.cpp"
BUILD_DIR = _REPO_ROOT / "build" / "native"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_tried = False


def lib_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha1(_SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libfastdata-{h.hexdigest()[:12]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: a concurrent build never sees a torn file
    return True


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.count_windows.restype = ctypes.c_int64
    lib.count_windows.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_bool]
    lib.chunk_tokens.restype = ctypes.c_int64
    lib.chunk_tokens.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_bool,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.gather_rows.restype = None
    lib.gather_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def _ptr32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def chunk_tokens_native(tokens: np.ndarray, max_length: int, doc_stride: int,
                        pad_id: int, drop_partial: bool = False
                        ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native chunking; returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    tokens = np.ascontiguousarray(tokens, np.int32)
    step = doc_stride if doc_stride > 0 else max_length
    n_rows = lib.count_windows(len(tokens), max_length, step, drop_partial)
    ids = np.empty((n_rows, max_length), np.int32)
    labels = np.empty((n_rows, max_length), np.int32)
    if n_rows:
        written = lib.chunk_tokens(
            _ptr32(tokens), len(tokens), max_length, step, pad_id,
            drop_partial, _ptr32(ids), _ptr32(labels),
        )
        if written != n_rows:
            raise RuntimeError(f"chunk_tokens wrote {written} rows, "
                               f"expected {n_rows}")
    return ids, labels


def gather_rows_native(data: np.ndarray,
                       indices: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    data = np.ascontiguousarray(data, np.int32)
    indices = np.ascontiguousarray(indices, np.int64)
    if len(indices) and (indices.min() < 0 or indices.max() >= len(data)):
        raise IndexError("gather_rows_native: index out of range")
    out = np.empty((len(indices), data.shape[1]), np.int32)
    lib.gather_rows(
        _ptr32(data), data.shape[1],
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices), _ptr32(out),
    )
    return out
