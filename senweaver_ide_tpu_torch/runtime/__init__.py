"""Native runtime: mmap trace ring, batched tokenization, job control.

The TPU-build analogue of the reference's native layer (SURVEY.md §2.6):
where the reference uses prebuilt C++ node deps (@vscode/sqlite3, spdlog,
ripgrep) and a 17.5k-LoC Rust code-cli, this package provides a C++ mmap
ring-buffer span store + batched byte tokenizer (native/trace_ring.cpp,
via ctypes) and the senweaver-ctl CLI (native/senweaver_ctl.cpp) speaking
JSON-RPC over a unix socket to ControlServer.
"""

from .control import (DEFAULT_SOCKET, ControlClient, ControlError,
                      ControlServer, Job)
from .jobs import JobRunner
from .native import (TraceRing, build_native, byte_tokenize_batch,
                     ctl_binary_path, native_available)

__all__ = [
    "DEFAULT_SOCKET", "ControlClient", "ControlError", "ControlServer", "Job", "JobRunner", "TraceRing", "build_native",
    "byte_tokenize_batch", "ctl_binary_path", "native_available",
]
