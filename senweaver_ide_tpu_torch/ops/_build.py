"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). Builds happen at first
use, never at import, into ``senweaver_ide_tpu_torch/_build/`` (listed in
``.gitignore``); the file name carries a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds and an unchanged one loads as is.
:func:`build_all` starts one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# kernel library name -> source path relative to the package
SOURCES = {
    "paged_attention": "csrc/paged_attention.cu",
    "flash_attention": "csrc/flash_attention.cu",
    "flash_decode": "csrc/flash_decode.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuiltLibrary:
    name: str
    path: str
    cdll: ctypes.CDLL
    build_seconds: float      # 0.0 when an existing build was loaded
    ptxas_log: str            # nvcc's -Xptxas -v report ("" when loaded)


_lock = threading.Lock()
_loaded: Dict[str, BuiltLibrary] = {}


def nvcc_path() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built on this machine")


def _target(name: str, nvcc: str) -> tuple:
    src = os.path.join(_PKG_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read())
    # the shared headers the sources include
    for hdr in sorted(glob.glob(os.path.join(_PKG_DIR, "csrc", "*.cuh"))):
        with open(hdr, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR,
                       f"lib{name}_{digest.hexdigest()[:16]}.so")
    return src, out


def _bind(name: str, cdll: ctypes.CDLL) -> None:
    """Declare argument and result types of every exported function."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "paged_attention":
        fn = cdll.swi_paged_flash_decode
        fn.argtypes = [p] * 10 + [      # q k v scales tables lengths
                                        # tiles out scratch
                       i, i, i, i, i, i, i,   # t tiles hq hkv d bs mb
                       i, i,                  # splits, chunk
                       i, i,                  # q / kv dtype codes
                       p]                     # stream
        fn.restype = i
        sp = cdll.swi_paged_flash_decode_splits
        sp.argtypes = [i, i, i, i, i]
        sp.restype = i
        sm = cdll.swi_paged_flash_decode_smem
        sm.argtypes = [i, i, i, i, i]
        sm.restype = ctypes.c_longlong
        occ = cdll.swi_paged_flash_decode_occupancy
        occ.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        occ.restype = i
    elif name == "flash_attention":
        ll = ctypes.POINTER(ctypes.c_longlong)
        # tensor pointers, then the dims and strides arrays, dtype, stream
        for fn, n_ptrs in (("swi_flash_attention_fwd", 6),
                           ("swi_flash_attention_bwd_dkdv", 10),
                           ("swi_flash_attention_bwd_dq", 8)):
            f = getattr(cdll, fn)
            f.argtypes = [p] * n_ptrs + [ll, ll, i, p]
            f.restype = i
        occ = cdll.swi_flash_attention_occupancy
        occ.argtypes = [i, i, ctypes.POINTER(ctypes.c_int)]
        occ.restype = i
    elif name == "flash_decode":
        fn = cdll.swi_flash_decode
        fn.argtypes = [p, p, p, p, p, p,   # q k v lengths out scratch
                       i, i, i, i, i,                # b hq hkv d smax
                       ctypes.c_longlong, ctypes.c_longlong,  # strides
                       i, i,                         # splits, chunk
                       i, p]                         # dtype code, stream
        fn.restype = i
        sp = cdll.swi_flash_decode_splits
        sp.argtypes = [i, i, i, i]
        sp.restype = i
        sm = cdll.swi_flash_decode_smem
        sm.argtypes = [i, i, i, i]
        sm.restype = ctypes.c_longlong


def build_all(names: Optional[Iterable[str]] = None) -> List[BuiltLibrary]:
    """Build (in parallel) and load the named kernel libraries, all of
    them by default. Raises with nvcc's output when a build fails."""
    names = list(SOURCES if names is None else names)
    with _lock:
        todo = [n for n in names if n not in _loaded]
        if todo:
            nvcc = nvcc_path()
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = []
            t0 = time.perf_counter()
            for n in todo:
                src, out = _target(n, nvcc)
                if os.path.exists(out):
                    procs.append((n, out, None, None))
                    continue
                tmp = f"{out}.{os.getpid()}.tmp"
                proc = subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                procs.append((n, out, tmp, proc))
            for n, out, tmp, proc in procs:
                log, secs = "", 0.0
                if proc is not None:
                    log, _ = proc.communicate()
                    secs = time.perf_counter() - t0
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed building {n} "
                            f"(rc {proc.returncode}):\n{log}")
                    os.replace(tmp, out)
                cdll = ctypes.CDLL(out)
                _bind(n, cdll)
                _loaded[n] = BuiltLibrary(name=n, path=out, cdll=cdll,
                                          build_seconds=secs,
                                          ptxas_log=log)
        return [_loaded[n] for n in names]


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = build_all([name])[0]
    return lib.cdll
