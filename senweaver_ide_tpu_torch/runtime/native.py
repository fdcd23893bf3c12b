"""ctypes bindings for the native runtime library (native/trace_ring.cpp
inside this package).

Builds on first use with g++ and the flags of the repo's native/Makefile
into this package's _build/ (ctypes needs no binding generator —
SURVEY.md §2.6). Every consumer has a pure-Python fallback, so the
framework works without the native layer — it is an optimization, not a
dependency.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_RUNTIME_DIR = os.path.dirname(os.path.abspath(__file__))
_PKG_DIR = os.path.dirname(_RUNTIME_DIR)
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libsenweaver_native.so")
_CTL_PATH = os.path.join(_BUILD_DIR, "senweaver-ctl")
_NATIVE_SRC = os.path.join(_PKG_DIR, "native")
# native/Makefile's CXXFLAGS, and per target the extra flags and source
_CXXFLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra")
_TARGETS = ((_LIB_PATH, ("-shared", "-fPIC"), "trace_ring.cpp"),
            (_CTL_PATH, (), "senweaver_ctl.cpp"))

_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def build_native(force: bool = False) -> bool:
    """Compile both targets; returns True when the shared library exists."""
    global _build_attempted
    if (os.path.exists(_LIB_PATH) and os.path.exists(_CTL_PATH)
            and not force):
        return True
    if _build_attempted and not force:
        return os.path.exists(_LIB_PATH)
    _build_attempted = True
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        for out, extra, src in _TARGETS:
            # build beside the target and rename: concurrent first uses
            # (test workers) never load a half-written file
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", *_CXXFLAGS, *extra,
                 "-o", tmp, os.path.join(_NATIVE_SRC, src)],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return False
    return os.path.exists(_LIB_PATH)


def ctl_binary_path() -> Optional[str]:
    """Path to the senweaver-ctl CLI, building if needed."""
    if not os.path.exists(_CTL_PATH):
        build_native()
    return _CTL_PATH if os.path.exists(_CTL_PATH) else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build_native():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint64]
    lib.ring_open.restype = ctypes.c_void_p
    lib.ring_open.argtypes = [ctypes.c_char_p]
    lib.ring_append.restype = ctypes.c_int64
    lib.ring_append.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32]
    lib.ring_read.restype = ctypes.c_int64
    lib.ring_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.c_char_p, ctypes.c_uint32]
    for fn in ("ring_head", "ring_dropped", "ring_capacity"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.byte_tokenize_batch.restype = ctypes.c_int
    lib.byte_tokenize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32),
        np.ctypeslib.ndpointer(np.int32)]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


class TraceRing:
    """mmap ring-buffer span store (native; crash-durable).

    The bound analogue of the reference's bounded trace storage
    (MAX_TRACES×MAX_SPANS, traceCollectorService.ts:219-220): old records
    are overwritten once the ring wraps."""

    def __init__(self, path: str, *, slot_size: int = 4096,
                 n_slots: int = 4096):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (g++/make "
                               "missing?) — use the JSONL TraceStore")
        self._lib = lib
        self._h = lib.ring_create(path.encode(), slot_size, n_slots)
        if not self._h:
            raise OSError(f"ring_create failed for {path}")
        self.slot_size = slot_size

    def append(self, payload: bytes) -> int:
        """Returns the record's global index; raises on oversize."""
        idx = self._lib.ring_append(self._h, payload, len(payload))
        if idx < 0:
            raise ValueError(f"payload of {len(payload)} bytes exceeds "
                             f"slot size {self.slot_size}")
        return idx

    def read(self, idx: int) -> Optional[bytes]:
        buf = ctypes.create_string_buffer(self.slot_size)
        n = self._lib.ring_read(self._h, idx, buf, self.slot_size)
        if n < 0:
            return None
        return buf.raw[:n]

    @property
    def head(self) -> int:
        return int(self._lib.ring_head(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.ring_dropped(self._h))

    @property
    def capacity(self) -> int:
        return int(self._lib.ring_capacity(self._h))

    def window(self) -> Tuple[int, int]:
        """(first_valid_idx, head)."""
        head = self.head
        return max(0, head - self.capacity), head

    def close(self) -> None:
        if self._h:
            self._lib.ring_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def byte_tokenize_batch(texts: List[str], *, max_len: int,
                        bos_id: int = 256, pad_id: int = 258
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Batched byte tokenization in C++ — the host data-loader hot path
    feeding the training pipeline. Falls back to numpy when the native library
    is missing. Returns (tokens (N, max_len) int32, lengths (N,) int32)."""
    n = len(texts)
    out = np.empty((n, max_len), np.int32)
    lens = np.empty((n,), np.int32)
    lib = _load()
    raw = [t.encode("utf-8") for t in texts]
    if lib is not None:
        arr = (ctypes.c_char_p * n)(*raw)
        text_lens = np.asarray([len(b) for b in raw], np.int32)
        lib.byte_tokenize_batch(arr, text_lens, n, max_len,
                                bos_id if bos_id is not None else -1,
                                pad_id, out, lens)
        return out, lens
    for i, b in enumerate(raw):
        ids = ([bos_id] if bos_id is not None else []) + list(b)
        ids = ids[:max_len]
        lens[i] = len(ids)
        out[i, :len(ids)] = ids
        out[i, len(ids):] = pad_id
    return out, lens
