"""JSON-RPC job-control server for the trainer runtime.

The server side of senweaver-ctl (native/senweaver_ctl.cpp): a unix-socket
JSON-RPC 2.0 endpoint through which jobs are submitted, inspected, and
stopped — the trainer-scoped role of the reference's Rust code-cli RPC
(cli/src/json_rpc.rs, SURVEY.md §2.6 / §7 step 8).

Builtin methods: ping, status, submit, stop; arbitrary methods register
via ``register``. Handlers run on the server thread — keep them short
(submit should enqueue, not train)."""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .msgpack_lite import is_msgpack_request, pack, unpack_prefix

DEFAULT_SOCKET = "/tmp/senweaver-ctl.sock"


class ControlError(RuntimeError):
    """JSON-RPC error response surfaced client-side."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class ControlClient:
    """Minimal JSON-framing client for :class:`ControlServer`.

    The in-process counterpart of senweaver-ctl's send_request
    (native/senweaver_ctl.cpp): one connection per call, newline-framed
    JSON-RPC 2.0, optional auth token. Used by the dashboard's action
    endpoint and available to tests/tools."""

    def __init__(self, socket_path: str = DEFAULT_SOCKET, *,
                 token: Optional[str] = None, timeout: float = 10.0):
        self.socket_path = socket_path
        self.token = token
        self.timeout = timeout

    def call(self, method: str, params: Any = None, *,
             token: Optional[str] = None) -> Any:
        req: Dict[str, Any] = {"jsonrpc": "2.0", "id": 1, "method": method,
                               "params": params}
        auth = token if token is not None else self.token
        if auth is not None:
            req["auth"] = auth
        with socket.socket(socket.AF_UNIX) as c:
            c.settimeout(self.timeout)
            c.connect(self.socket_path)
            c.sendall(json.dumps(req).encode() + b"\n")
            c.shutdown(socket.SHUT_WR)
            data = b""
            while True:
                chunk = c.recv(65536)
                if not chunk:
                    break
                data += chunk
        resp = json.loads(data.decode())
        if "error" in resp:
            err = resp["error"] or {}
            raise ControlError(err.get("code", -32000),
                               err.get("message", "unknown error"))
        return resp.get("result")


@dataclasses.dataclass
class Job:
    job_id: str
    params: Any
    status: str = "queued"         # queued | running | done | stopped
    submitted_at: float = dataclasses.field(default_factory=time.time)
    result: Any = None


class ControlServer:
    """JSON-RPC / msgpack-RPC job-control endpoint.

    ``token``: when set, every method except ``ping`` requires the
    request to carry a matching ``auth`` field — the trainer-scoped
    analogue of the reference CLI's auth layer (cli/src/auth.rs).
    Requests whose first byte is a msgpack map are answered in msgpack
    (cli/src/msgpack_rpc.rs framing); JSON stays the default.
    """

    def __init__(self, socket_path: str = DEFAULT_SOCKET, *,
                 on_submit: Optional[Callable[[Job], None]] = None,
                 token: Optional[str] = None):
        self.socket_path = socket_path
        self.on_submit = on_submit
        self.token = token
        self.jobs: Dict[str, Job] = {}
        self._handlers: Dict[str, Callable[[Any], Any]] = {
            "ping": lambda p: "pong",
            "status": self._status,
            "submit": self._submit,
            "stop": self._stop,
        }
        self._next_job = 1
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()

    # -- builtin handlers --------------------------------------------------
    def _status(self, _params: Any) -> List[Dict[str, Any]]:
        return self.list_jobs()

    def list_jobs(self) -> List[Dict[str, Any]]:
        """Public job snapshot (the status RPC's payload) — also consumed
        in-process by the operator dashboard."""
        with self._lock:
            return [{"job_id": j.job_id, "status": j.status,
                     "submitted_at": j.submitted_at}
                    for j in self.jobs.values()]

    def _submit(self, params: Any) -> Dict[str, str]:
        with self._lock:
            job = Job(job_id=f"job-{self._next_job}", params=params)
            self._next_job += 1
            self.jobs[job.job_id] = job
        if self.on_submit:
            self.on_submit(job)
        return {"job_id": job.job_id, "status": job.status}

    def _stop(self, params: Any) -> Dict[str, str]:
        job_id = params.get("job_id") if isinstance(params, dict) else \
            str(params)
        with self._lock:
            job = self.jobs.get(job_id)
            if job is None:
                raise KeyError(f"unknown job: {job_id}")
            job.status = "stopped"
        return {"job_id": job_id, "status": "stopped"}

    def cas_job_status(self, job: Job, new_status: str, *,
                       unless: tuple = ("stopped",)) -> bool:
        """Atomically set ``job.status`` unless it is already in ``unless``.

        The public check-and-set executors need: a worker marking a job
        running/done/failed must not clobber a concurrent ``stop`` RPC
        (which writes under the same lock). Returns True when the
        transition happened."""
        with self._lock:
            if job.status in unless:
                return False
            job.status = new_status
            return True

    def register(self, method: str, fn: Callable[[Any], Any]) -> None:
        self._handlers[method] = fn

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(8)
        self._sock.settimeout(0.2)
        self._running = True
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._thread:
            self._thread.join(timeout=2)
        if self._sock:
            self._sock.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)

    def _serve(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()  # type: ignore[union-attr]
            except socket.timeout:
                continue
            except OSError:
                break
            with conn:
                try:
                    data = b""
                    conn.settimeout(2.0)
                    msgpack_mode = False
                    while True:
                        chunk = conn.recv(65536)
                        if not chunk:
                            break
                        data += chunk
                        msgpack_mode = is_msgpack_request(data[0])
                        if msgpack_mode:
                            # msgpack has no line terminator: stop once
                            # one complete value has arrived (the client
                            # half-closes after writing anyway).
                            try:
                                unpack_prefix(data)
                                break
                            except ValueError:
                                continue
                        if b"\n" in data:
                            break
                    if msgpack_mode:
                        conn.sendall(self._dispatch_msgpack(data))
                    else:
                        resp = self._dispatch(data.decode(errors="replace"))
                        conn.sendall(resp.encode())
                except OSError:
                    pass

    def _handle_request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Shared auth + dispatch core for both wire framings."""
        rid = req.get("id")
        method = req.get("method", "")
        if self.token and method != "ping" \
                and req.get("auth") != self.token:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32001,
                              "message": "unauthorized: bad or missing "
                                         "auth token"}}
        handler = self._handlers.get(method)
        if handler is None:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32601,
                              "message": f"method not found: {method}"}}
        try:
            return {"jsonrpc": "2.0", "id": rid,
                    "result": handler(req.get("params"))}
        except Exception as e:
            return {"jsonrpc": "2.0", "id": rid,
                    "error": {"code": -32000,
                              "message": f"{type(e).__name__}: {e}"}}

    def _dispatch(self, raw: str) -> str:
        # Every failure path must produce an error RESPONSE: an uncaught
        # exception here kills the serve thread (a one-packet DoS).
        try:
            req = json.loads(raw)
        except json.JSONDecodeError as e:
            return json.dumps({"jsonrpc": "2.0", "id": None,
                               "error": {"code": -32700,
                                         "message": f"parse error: {e}"}})
        try:
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            return json.dumps(self._handle_request(req))
        except Exception as e:   # non-dict req, unserializable result, …
            return json.dumps({"jsonrpc": "2.0", "id": None,
                               "error": {"code": -32000,
                                         "message": f"{type(e).__name__}: "
                                                    f"{e}"}})

    def _dispatch_msgpack(self, raw: bytes) -> bytes:
        try:
            req, _end = unpack_prefix(raw)
            if not isinstance(req, dict):
                raise ValueError("request must be a map")
            # msgpack envelope may carry params as embedded JSON text
            # (the CLI has argv JSON in hand; cf. params_json below).
            if "params_json" in req and "params" not in req:
                pj = req.pop("params_json")
                req["params"] = json.loads(pj) if pj else None
        except (ValueError, json.JSONDecodeError, RecursionError) as e:
            return pack({"jsonrpc": "2.0", "id": None,
                         "error": {"code": -32700,
                                   "message": f"parse error: {e}"}})
        try:
            return pack(self._handle_request(req))
        except Exception as e:   # e.g. a handler result pack() rejects
            return pack({"jsonrpc": "2.0", "id": None,
                         "error": {"code": -32000,
                                   "message": f"{type(e).__name__}: {e}"}})
