"""ctypes bindings for the native feature-pack reader (port of
blim_tpu/data/native_pack.py).

The reader (`csrc/feature_pack.cpp`, a copy of native/feature_pack.cpp that
tests/test_torch_copies.py pins) mmaps a `features.pack` once and serves
batched gathers into a contiguous fp32 buffer, converting fp16 on host
threads. On first use it is built with g++ (~1 s) into
`blim_tpu_torch/_build/feature_pack-<hash>/`, keyed by a hash of the source
and the flags, so an edit rebuilds; the JAX package's tree is never written.
`load_library()` returns None when no library can be built (no g++), and
FeatureStore then reads the pack through a numpy memmap.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "feature_pack.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library lands, keyed by the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / f"feature_pack-{h.hexdigest()[:16]}" / "libfeature_pack.so"


def _build(so: Path) -> bool:
    """Compile into a temporary name and rename it into place, so processes
    that build at once never load a half-written library."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        lib = ctypes.CDLL(str(so))
        lib.pack_open.restype = ctypes.c_void_p
        lib.pack_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.pack_gather.restype = None
        lib.pack_gather.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        lib.pack_close.restype = None
        lib.pack_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


class NativePack:
    """Batched feature gathers over an mmap'd pack file."""

    def __init__(self, path: str, n_items: int, item_shape, dtype: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native feature_pack library unavailable (no g++?)")
        self.lib = lib
        self.item_shape = tuple(item_shape)
        self.item_elems = int(np.prod(item_shape))
        dtype_code = 1 if np.dtype(dtype) == np.float32 else 0
        self.handle = lib.pack_open(str(path).encode(), n_items, self.item_elems, dtype_code)
        if not self.handle:
            raise RuntimeError(f"failed to open pack {path}")

    def gather(self, indices: np.ndarray, n_threads: int = 4) -> np.ndarray:
        """indices (N,) int64 (negative => zeros) -> (N, *item_shape) float32."""
        indices = np.ascontiguousarray(indices, np.int64)
        out = np.empty((len(indices), *self.item_shape), np.float32)
        self.lib.pack_gather(
            self.handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(indices),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_threads,
        )
        return out

    def close(self):
        if self.handle:
            self.lib.pack_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
