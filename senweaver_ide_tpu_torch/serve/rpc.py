"""Remote-replica RPC: typed fault taxonomy, wire codec, transports.

The instant a replica lives across a socket, every engine interaction
gains failure modes the in-process fleet treats as impossible. This
module names them as a TYPED taxonomy so callers can decide per class
instead of catching Exception:

====================  =========  =============================================
error                 retriable  meaning
====================  =========  =============================================
RpcTransportError     yes        the request never reached the server
                                 (refused / reset / DNS) — definitely not
                                 executed, retry freely
RpcTimeout            yes        no response within the deadline — the server
                                 MAY have executed it; only safe to retry
                                 because the server's idempotent request-id
                                 cache replays instead of re-executing
RpcServerError        yes        server answered 5xx before doing the work
RpcProtocolError      no         malformed frame — a bug, not weather
RpcApplicationError   no         the remote ENGINE raised (KeyError /
                                 ValueError / QueueFull…); re-raised locally
                                 as the original type so fleet semantics are
                                 transparent to distance
RpcCircuitOpen        no         the local circuit breaker is refusing calls
                                 to this peer (failing fast, not a wire error)
====================  =========  =============================================

Two transports speak the same ``call(method, params)`` surface:

- :class:`HttpTransport` — stdlib urllib POST of a JSON frame to
  ``{base_url}/rpc`` (the ``traces.http_trace_transport`` idiom; no SDK
  dependency). Arrays, tensors and pytrees cross the wire via
  :func:`encode` / :func:`decode` (JSON + tagged base64 buffers, the
  same frames the JAX package writes, bfloat16 as its raw bits; pickle
  fallback for exotica, never for a tensor — the fleet protocol is
  TRUSTED-PEER, same trust model as shipping raw weights).
- :class:`LoopbackTransport` — in-process delivery to an
  ``EngineRpcHandler``, consulting a
  :class:`~..resilience.chaos.NetworkFaultPlan` on every call. This is
  how ALL remote-fleet tests run hermetically on CPU: same taxonomy,
  same retry/idempotency paths, zero sockets, fake clocks.
"""

from __future__ import annotations

import base64
import io
import json
import pickle
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

RPC_PATH = "/rpc"


# -- fault taxonomy ----------------------------------------------------------
class RpcError(RuntimeError):
    """Base for every remote-call failure."""

    retriable = False


class RpcTransportError(RpcError):
    """Connection-level failure before the server saw the request."""

    retriable = True


class RpcTimeout(RpcError):
    """No response within the deadline (the server may have executed)."""

    retriable = True


class RpcServerError(RpcError):
    """Server-side 5xx before the call did its work."""

    retriable = True


class RpcProtocolError(RpcError):
    """Malformed request or response frame."""


class RpcCircuitOpen(RpcError):
    """Local circuit breaker is refusing calls to this peer."""


class RpcApplicationError(RpcError):
    """The remote engine raised; carries the original type name so the
    client re-raises it LOCALLY (KeyError stays KeyError across the
    wire — ``EnginePolicyClient`` recovery paths must not notice the
    network)."""

    def __init__(self, error_type: str, message: str):
        super().__init__(f"{error_type}: {message}")
        self.error_type = error_type
        self.message = message

    def raise_local(self):
        """Re-raise as the original exception type where that type is
        part of the engine contract; unknown types stay RpcApplication-
        Error (still typed, still not retried)."""
        builtin = {"KeyError": KeyError, "ValueError": ValueError,
                   "RuntimeError": RuntimeError, "TypeError": TypeError,
                   "IndexError": IndexError}.get(self.error_type)
        if builtin is not None:
            raise builtin(self.message) from self
        if self.error_type == "QueueFull":
            from ..rollout.engine import QueueFull
            raise QueueFull(self.message) from self
        if self.error_type == "PrefixImportError":
            from ..rollout.engine import PrefixImportError
            raise PrefixImportError(self.message) from self
        if self.error_type == "StalePublishError":
            from .weights import StalePublishError
            raise StalePublishError(self.message) from self
        if self.error_type == "LeaseLost":
            from ..resilience.lease import LeaseLost
            raise LeaseLost(self.message) from self
        if self.error_type == "LeaseUnavailable":
            from ..resilience.lease import LeaseUnavailable
            raise LeaseUnavailable(self.message) from self
        raise self


# -- wire codec --------------------------------------------------------------
# Dtype names numpy cannot hold -> (torch dtype, integer torch dtype of the
# same width that carries its raw bits). The names are the ones numpy
# prints for the ``ml_dtypes`` types, so a frame of these bits reads the
# same on either side of the wire.
_RAW_BITS = {"bfloat16": (torch.bfloat16, torch.int16),
             "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8),
             "float8_e5m2": (torch.float8_e5m2, torch.uint8)}
_BY_DTYPE = {dt: (name, raw) for name, (dt, raw) in _RAW_BITS.items()}

# The reference package's name in ``__nt__`` paths; a frame that names it
# is rebuilt from this package's module of the same path.
_FOREIGN_PKG = "senweaver_ide_tpu"
_OWN_PKG = __name__.split(".")[0]


def _nd(dtype: str, shape, arr: np.ndarray) -> Dict[str, Any]:
    """The frame of an array's bytes (read in place when contiguous)."""
    arr = np.ascontiguousarray(arr)
    data = arr.reshape(-1).view(np.uint8) if arr.size else b""
    return {"__nd__": {"dtype": dtype, "shape": list(shape),
                       "data": base64.b64encode(data).decode("ascii")}}


def _encode_tensor(t: torch.Tensor) -> Dict[str, Any]:
    """A tensor's ``__nd__`` frame: the frame numpy writes for the same
    values. One copy to the host when it lives on a card, no change of
    dtype on the way: 2- and 1-byte floats go as their raw bits under
    their own dtype name."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.to("cpu")
    t = t.contiguous()
    named = _BY_DTYPE.get(t.dtype)
    if named is not None:
        return _nd(named[0], t.shape, t.view(named[1]).numpy())
    arr = t.numpy()
    return _nd(str(arr.dtype), arr.shape, arr)


def encode(obj: Any) -> Any:
    """JSON-able encoding of engine call payloads. Scalars/str/None pass
    through; containers recurse; arrays (numpy) and tensors (on any
    device) become tagged base64 buffers; namedtuples (KVCache) are
    rebuilt by import path; anything else rides a tagged pickle
    (trusted-peer protocol), which refuses tensors."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {"__d__": {k: encode(v) for k, v in obj.items()}}
        return _encode_pickle(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = type(obj)
        return {"__nt__": f"{cls.__module__}:{cls.__qualname__}",
                "f": {name: encode(getattr(obj, name))
                      for name in obj._fields}}
    if isinstance(obj, list):
        return [encode(v) for v in obj]
    if isinstance(obj, tuple):
        return {"__t__": [encode(v) for v in obj]}
    if isinstance(obj, torch.Tensor):
        return _encode_tensor(obj)
    if hasattr(obj, "dtype") and hasattr(obj, "shape"):
        arr = np.asarray(obj)
        return _nd(str(arr.dtype), arr.shape, arr)
    return _encode_pickle(obj)


class _TensorFreePickler(pickle.Pickler):
    """A pickled tensor would carry its device storage to a peer that may
    have no such device: the fallback refuses one wherever it hides."""

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            raise RpcProtocolError(
                "a tensor reached the pickle fallback (under a dict with "
                "non-str keys or inside an object); send it in a str-keyed "
                "dict, list or tuple")
        return None


def _encode_pickle(obj: Any) -> Dict[str, str]:
    buf = io.BytesIO()
    _TensorFreePickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return {"__py__": base64.b64encode(buf.getvalue()).decode("ascii")}


def _decode_nd(spec: Dict[str, Any]) -> Any:
    buf = base64.b64decode(spec["data"])
    shape = [int(n) for n in spec["shape"]]
    raw = _RAW_BITS.get(spec["dtype"])
    if raw is not None:
        if not buf:
            return torch.empty(shape, dtype=raw[0])
        return torch.frombuffer(bytearray(buf), dtype=raw[1]).view(
            raw[0]).reshape(shape)
    try:
        dtype = np.dtype(spec["dtype"])
    except TypeError as e:
        raise RpcProtocolError(
            f"unknown array dtype {spec['dtype']!r}") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def _namedtuple_class(path: str):
    import importlib
    mod_name, qualname = path.split(":")
    top, _, rest = mod_name.partition(".")
    if top == _FOREIGN_PKG:
        mod_name = _OWN_PKG + ("." + rest if rest else "")
    cls = importlib.import_module(mod_name)
    for part in qualname.split("."):
        cls = getattr(cls, part)
    return cls


def decode(obj: Any) -> Any:
    """Inverse of :func:`encode`. bfloat16 and float8 arrays come back as
    host tensors of that dtype (numpy has no such type), every other
    array as numpy; the receiver places them on its device
    (``serve/placement.py``)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    if isinstance(obj, dict):
        if "__d__" in obj:
            return {k: decode(v) for k, v in obj["__d__"].items()}
        if "__t__" in obj:
            return tuple(decode(v) for v in obj["__t__"])
        if "__nt__" in obj:
            cls = _namedtuple_class(obj["__nt__"])
            return cls(**{k: decode(v) for k, v in obj["f"].items()})
        if "__nd__" in obj:
            return _decode_nd(obj["__nd__"])
        if "__py__" in obj:
            return pickle.loads(base64.b64decode(obj["__py__"]))
        raise RpcProtocolError(f"unknown frame tags: {sorted(obj)}")
    raise RpcProtocolError(f"unencodable frame element: {type(obj)!r}")


# -- transports --------------------------------------------------------------
def _inject_trace() -> Optional[Dict[str, Any]]:
    """The frame's ``trace`` field (W3C-traceparent style + clock
    anchors) for the ACTIVE span context — None when tracing is off or
    no span is open, so the common untraced path costs one branch and
    sends nothing. Never raises into a transport."""
    try:
        from ..obs.propagation import inject
        return inject()
    except Exception:
        return None


class HttpTransport:
    """urllib POST of one JSON frame per call to ``{base_url}/rpc``.

    Maps wire weather onto the taxonomy: connection errors →
    :class:`RpcTransportError`, deadline → :class:`RpcTimeout`, 5xx →
    :class:`RpcServerError` (with any ``Retry-After`` parsed onto
    ``.retry_after_s``), and an ``ok=false`` body →
    :class:`RpcApplicationError`. No retrying here — the client's
    RetryPolicy owns that.
    """

    def __init__(self, base_url: str, *, timeout_s: float = 5.0,
                 target: Optional[str] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.target = target or self.base_url

    def call(self, method: str, params: Optional[Dict[str, Any]] = None,
             *, request_id: Optional[str] = None,
             timeout_s: Optional[float] = None) -> Any:
        import socket
        import urllib.error
        import urllib.request

        frame = {"method": method, "params": encode(params or {})}
        if request_id is not None:
            frame["request_id"] = request_id
        trace = _inject_trace()
        if trace is not None:
            frame["trace"] = trace
        body = json.dumps(frame).encode("utf-8")
        req = urllib.request.Request(
            self.base_url + RPC_PATH, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        timeout = self.timeout_s if timeout_s is None else timeout_s
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                payload = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            if e.code >= 500:
                err = RpcServerError(f"{method}: HTTP {e.code}")
                err.retry_after_s = _header_retry_after(e)
                raise err from e
            raise RpcProtocolError(f"{method}: HTTP {e.code}") from e
        except (socket.timeout, TimeoutError) as e:
            raise RpcTimeout(f"{method}: no response in {timeout}s") from e
        except urllib.error.URLError as e:
            if isinstance(getattr(e, "reason", None),
                          (socket.timeout, TimeoutError)):
                raise RpcTimeout(
                    f"{method}: no response in {timeout}s") from e
            raise RpcTransportError(f"{method}: {e.reason}") from e
        except OSError as e:
            raise RpcTransportError(f"{method}: {e}") from e
        except json.JSONDecodeError as e:
            raise RpcProtocolError(f"{method}: bad response body") from e
        return _unwrap(method, payload)


def _header_retry_after(e) -> Optional[float]:
    from ..resilience.retry import parse_retry_after
    headers = getattr(e, "headers", None)
    if headers is None:
        return None
    return parse_retry_after(headers.get("Retry-After"))


def _unwrap(method: str, payload: Any) -> Any:
    if not isinstance(payload, dict) or "ok" not in payload:
        raise RpcProtocolError(f"{method}: malformed response frame")
    if payload["ok"]:
        return decode(payload.get("result"))
    raise RpcApplicationError(payload.get("error_type", "RuntimeError"),
                              payload.get("message", ""))


class LoopbackTransport:
    """In-process transport: the hermetic twin of :class:`HttpTransport`.

    Delivers calls straight into a handler's ``handle()`` (values pass
    by reference — no serialization cost — unless ``wire_codec=True``,
    which round-trips every frame through encode/decode to exercise the
    codec without sockets). A :class:`NetworkFaultPlan` injects the full
    weather taxonomy deterministically; ``clock`` only matters for
    bookkeeping, so chaos tests run on fake clocks with zero sleeps.

    Fault semantics (see ``NetworkFault``): ``drop``/``http_500``/
    ``partition`` fail BEFORE the handler runs; ``drop_response`` runs
    the handler then loses the answer (RpcTimeout — the retry must hit
    the server's idempotency cache, not a second execution); ``delay``
    executes and then times out only when ``delay_s`` >= the call's
    timeout, otherwise it just records latency.
    """

    def __init__(self, handler, *, target: str = "loopback",
                 fault_plan=None, timeout_s: float = 5.0,
                 wire_codec: bool = False):
        self.handler = handler
        self.target = target
        self.fault_plan = fault_plan
        self.timeout_s = timeout_s
        self.wire_codec = wire_codec
        self.calls = 0                      # guarded-by: _lock
        self.simulated_latency_s = 0.0      # guarded-by: _lock
        self._lock = threading.Lock()

    def call(self, method: str, params: Optional[Dict[str, Any]] = None,
             *, request_id: Optional[str] = None,
             timeout_s: Optional[float] = None) -> Any:
        with self._lock:
            self.calls += 1
        timeout = self.timeout_s if timeout_s is None else timeout_s
        fault = (self.fault_plan.take(self.target, method)
                 if self.fault_plan is not None else None)
        if fault is not None:
            if fault.kind == "partition":
                raise RpcTransportError(
                    f"{method}: {self.target} partitioned")
            if fault.kind == "drop":
                raise RpcTransportError(
                    f"{method}: connection reset by chaos")
            if fault.kind == "http_500":
                raise RpcServerError(f"{method}: injected HTTP 500")
        trace = _inject_trace()
        try:
            if trace is not None:
                result = self.handler.handle(method, dict(params or {}),
                                             request_id=request_id,
                                             trace=trace)
            else:
                result = self.handler.handle(method, dict(params or {}),
                                             request_id=request_id)
        except RpcError:
            raise
        except Exception as e:     # handler bug = server crash mid-call
            raise RpcServerError(f"{method}: server crashed: {e}") from e
        if fault is not None:
            if fault.kind == "drop_response":
                raise RpcTimeout(
                    f"{method}: executed but response lost")
            if fault.kind == "delay":
                with self._lock:
                    self.simulated_latency_s += fault.delay_s
                if fault.delay_s >= timeout:
                    raise RpcTimeout(
                        f"{method}: response after {fault.delay_s}s "
                        f"> timeout {timeout}s")
        if self.wire_codec:
            result = _unwrap(method, json.loads(json.dumps(
                {"ok": True, "result": encode(result)})))
        return result
