"""Server shim: one local RolloutEngine behind the rpc protocol.

:class:`EngineRpcHandler` is the whole remote side of the cross-host
fleet — a method-dispatch table over one engine plus the one piece of
state that makes retries SAFE: a bounded **idempotency cache** keyed by
the client's ``request_id``. A retried mutating call (the client saw a
timeout; the server may or may not have executed) replays the cached
outcome instead of executing twice — that is the exactly-once half of
the fleet's no-loss/no-double-execution guarantee (the retry policy is
the no-loss half). Cached outcomes include application ERRORS: a submit
that raised ValueError raises the same ValueError on replay rather than
accidentally succeeding the second time.

:func:`serve_engine_http` wraps the handler in a stdlib
``ThreadingHTTPServer`` speaking the :data:`~.rpc.RPC_PATH` JSON frame —
the real-socket deployment path. Tests mostly skip it and hand the
handler to a ``LoopbackTransport``; one end-to-end test drives the HTTP
stack on 127.0.0.1 to keep the wire honest.
"""

from __future__ import annotations

import collections
import json
import threading
from typing import Any, Dict, Optional, Tuple

from ..obs.federation import MetricsScrapeMixin
from .placement import engine_device, on_device
from .rpc import RPC_PATH, RpcApplicationError, RpcProtocolError, decode, \
    encode

# Methods that change engine state; only these consult/populate the
# idempotency cache (reads are naturally idempotent and must see fresh
# state — a cached ``step`` replay is correct, a cached ``health`` lie).
# ``scrape`` is mutating on purpose: delta shipping advances a
# per-scraper cursor, so a retried scrape must REPLAY the cached delta
# (exactly-once) rather than compute a second one and skip a window.
MUTATING_METHODS = frozenset({
    "submit", "step", "release_slot", "register_prefix", "import_prefix",
    "release_prefix", "update_params", "scrape",
    # Live migration (serve/scheduler.py). checkpoint_request mutates
    # (it freezes the row) and a lost-response retry must replay the
    # SAME snapshot; restore_checkpoint is the at-least-once install
    # whose cache hit makes it exactly-once on the engine.
    "checkpoint_request", "restore_checkpoint", "resume_request",
    "release_request"})

# Reads are never cached and must see fresh state — a cached ``step``
# replay is correct, a cached ``health`` a lie. Every dispatchable
# method must appear in exactly one classification set (rpc_lint
# RPC101 enforces it).
READONLY_METHODS = frozenset({
    "health", "meta", "is_done", "result", "result_logps",
    "export_prefix", "stats"})


class RpcHandlerBase:
    """Dispatch table + idempotency cache; subclasses provide ``_m_*``
    methods and classify each one into exactly one of three sets:

    ``mutating_methods``        consult/populate the idempotency cache —
                                a retried call REPLAYS its first outcome
    ``readonly_methods``        never cached; must see fresh state
    ``reexecute_safe_methods``  mutating but deliberately UNCACHED —
                                re-execution on a retry is safe, replay
                                is dangerous (the lease family: a cached
                                grant replayed by a restarted client
                                would resurrect a zombie epoch)

    The cache is the exactly-once half of the fleet's retry contract: a
    retried mutating call (the client saw a timeout; the server may or
    may not have executed) replays the cached outcome — including cached
    application ERRORS — instead of executing twice."""

    mutating_methods: frozenset = frozenset()
    readonly_methods: frozenset = frozenset()
    reexecute_safe_methods: frozenset = frozenset()
    # Span attribute naming the process role in a stitched trace
    # ("engine" host, "fleet" learner gateway, ...).
    span_service: str = "rpc"

    def __init__(self, *, idempotency_cache_size: int = 4096):
        self._cache_size = max(1, int(idempotency_cache_size))
        # request_id -> ("ok" | "err", payload) — replayed on duplicates
        self._cache: "collections.OrderedDict[str, Tuple[str, Any]]" = \
            collections.OrderedDict()       # guarded-by: _lock
        self.executed: Dict[str, int] = {}  # method -> count, guarded-by: _lock
        self.replays = 0                    # guarded-by: _lock
        self._lock = threading.Lock()

    # -- dispatch ------------------------------------------------------------
    def handle(self, method: str, params: Dict[str, Any], *,
               request_id: Optional[str] = None,
               trace: Optional[Dict[str, Any]] = None) -> Any:
        """Dispatch one rpc. ``trace`` is the frame's propagated span
        context (see ``obs/propagation.py``): when tracing is enabled
        the call runs under a ``rpc.server.<method>`` span stitched
        into the caller's trace. An idempotency-cache hit ANNOTATES
        that span (``replay=True``) — the replayed work itself recorded
        its span on first execution, so retried RPCs never duplicate
        spans, they just show up as annotated replays."""
        fn = getattr(self, f"_m_{method}", None)
        if fn is None:
            raise RpcProtocolError(f"unknown rpc method {method!r}")
        tracer = _maybe_tracer()
        if tracer is None or not tracer.enabled:
            outcome, _ = self._dispatch(fn, method, params, request_id)
            return self._replay(outcome)
        from ..obs.propagation import server_span
        with server_span(tracer, trace, f"rpc.server.{method}",
                         service=self.span_service,
                         method=method) as span:
            outcome, replayed = self._dispatch(fn, method, params,
                                               request_id)
            if span is not None:
                if request_id is not None:
                    span.set_attr("request_id", request_id)
                if replayed:
                    span.set_attr("replay", True)
                if outcome[0] == "err":
                    span.set_attr("app_error", outcome[1][0])
            return self._replay(outcome)

    def _dispatch(self, fn, method: str, params: Dict[str, Any],
                  request_id: Optional[str]
                  ) -> Tuple[Tuple[str, Any], bool]:
        """(outcome, replayed): the cache-or-execute core of handle."""
        cacheable = (request_id is not None
                     and method in self.mutating_methods)
        if cacheable:
            with self._lock:
                hit = self._cache.get(request_id)
                if hit is not None:
                    self._cache.move_to_end(request_id)
                    self.replays += 1
                    return hit, True
        try:
            result = fn(**params)
            outcome = ("ok", result)
        except RpcProtocolError:
            raise
        except Exception as e:
            outcome = ("err", (type(e).__name__, str(e)))
        if cacheable:
            with self._lock:
                self._cache[request_id] = outcome
                while len(self._cache) > self._cache_size:
                    self._cache.popitem(last=False)
        with self._lock:
            self.executed[method] = self.executed.get(method, 0) + 1
        return outcome, False

    @staticmethod
    def _replay(outcome: Tuple[str, Any]) -> Any:
        status, payload = outcome
        if status == "ok":
            return payload
        raise RpcApplicationError(payload[0], payload[1])


def _maybe_tracer():
    """The global tracer, or None if obs is unimportable — the server
    must handle rpcs even when observability is broken."""
    try:
        from ..obs import get_tracer
        return get_tracer()
    except Exception:
        return None


class EngineRpcHandler(MetricsScrapeMixin, RpcHandlerBase):
    """The whole remote side of the cross-host fleet: a dispatch table
    over one local engine (plus the idempotency cache from the base,
    plus the federation ``scrape`` endpoint from the mixin)."""

    mutating_methods = MUTATING_METHODS
    readonly_methods = READONLY_METHODS
    span_service = "engine"

    def __init__(self, engine, *, idempotency_cache_size: int = 4096,
                 registry=None):
        super().__init__(idempotency_cache_size=idempotency_cache_size)
        self.engine = engine
        # Host-side fencing high-water mark for versioned publishes —
        # the last line of defense against a stale writer reaching this
        # replica directly (same rule as WeightPublisher.begin, except
        # an EQUAL version at a >= epoch is an idempotent reinstall).
        self._hw_epoch = 0                  # guarded-by: _lock
        self._hw_version = 0                # guarded-by: _lock
        if registry is None:
            from ..obs import get_registry
            registry = get_registry()
        self._stale_total = registry.counter(
            "senweaver_serve_stale_publish_total",
            "Publishes rejected by (epoch, version) fencing — a stale "
            "or duplicate writer was denied.")

    # -- methods -------------------------------------------------------------
    def _m_health(self) -> Dict[str, Any]:
        return {"state": "ok",
                "has_work": bool(getattr(self.engine, "has_work", False)),
                "queue_depth": int(
                    self.engine.stats().get("queue_depth", 0))}

    def _m_meta(self) -> Dict[str, Any]:
        return {"num_slots": int(getattr(self.engine, "num_slots", 8)),
                "context_bound": int(
                    getattr(self.engine, "context_bound", 1 << 30))}

    def _m_submit(self, prompt, max_new_tokens=128, prefix_id=None,
                  eos_id=None, hold_slot=False, continue_from=None) -> int:
        """Cached-mutating: a retried submit must replay the SAME
        request id — re-executing would enqueue the prompt twice."""
        return self.engine.submit(
            list(prompt), max_new_tokens=max_new_tokens,
            prefix_id=prefix_id, eos_id=eos_id, hold_slot=hold_slot,
            continue_from=continue_from)

    def _m_step(self) -> Dict[str, Any]:
        """Cached-mutating: each step advances decode state, so a
        lost-response retry must replay that step's tokens — executing
        a second step would silently drop a token window."""
        # JSON object keys are strings; the client int()s them back.
        return {str(rid): toks
                for rid, toks in self.engine.step().items()}

    def _m_is_done(self, rid) -> bool:
        return bool(self.engine.is_done(int(rid)))

    def _m_result(self, rid):
        return list(self.engine.result(int(rid)))

    def _m_result_logps(self, rid):
        return [float(x) for x in self.engine.result_logps(int(rid))]

    def _m_release_slot(self, rid) -> None:
        """Cached-mutating: replay keeps a retried release from
        freeing a slot that was already reassigned to a new request."""
        self.engine.release_slot(int(rid))

    def _m_register_prefix(self, tokens) -> int:
        """Cached-mutating: replay returns the SAME prefix id — a
        second registration would pin a duplicate KV prefix."""
        return int(self.engine.register_prefix(list(tokens)))

    def _m_export_prefix(self, prefix_id):
        return self.engine.export_prefix(int(prefix_id))

    def _m_import_prefix(self, tokens, kv, last_logits=None) -> int:
        """Cached-mutating: replay returns the first install's prefix
        id instead of allocating the KV blocks a second time. A decoded
        buffer is on the host: it moves to the engine's device once
        here, in its own dtype (the engine refuses a mismatch)."""
        dev = engine_device(self.engine)
        if dev is not None:
            kv = on_device(kv, dev)
            last_logits = on_device(last_logits, dev)
        return int(self.engine.import_prefix(list(tokens), kv,
                                             last_logits))

    def _m_release_prefix(self, prefix_id) -> None:
        """Cached-mutating: replay keeps a retried release from
        double-decrementing the prefix refcount."""
        self.engine.release_prefix(int(prefix_id))

    def _m_update_params(self, params, version=None, epoch=None) -> None:
        """Cached-mutating: a retried install replays the first
        outcome; fresh re-execution would trip the (epoch, version)
        fence below and misreport a stale publish."""
        if version is not None:
            from .weights import StalePublishError
            v, e = int(version), int(epoch or 0)
            with self._lock:
                if e < self._hw_epoch or (e == self._hw_epoch
                                          and v < self._hw_version):
                    self._stale_total.inc()
                    raise StalePublishError(
                        f"update_params (epoch={e}, version={v}) behind "
                        f"this host's high-water mark (epoch="
                        f"{self._hw_epoch}, version={self._hw_version})")
                self._hw_epoch, self._hw_version = e, v
        # a decoded tree is on the host: one move onto the engine's
        # device, each floating leaf in the dtype of the leaf it replaces
        dev = engine_device(self.engine)
        if dev is not None:
            params = on_device(params, dev,
                               like=getattr(self.engine, "params", None))
        self.engine.update_params(params)

    # -- live migration (serve/scheduler.py) ---------------------------------
    def _m_checkpoint_request(self, rid, pause=True) -> Dict[str, Any]:
        """Cached-mutating: freezes the row, so a lost-response retry
        must replay the SAME snapshot, not cut a second one."""
        ckpt = self.engine.checkpoint_request(int(rid),
                                              pause=bool(pause))
        return ckpt.to_wire()

    def _m_restore_checkpoint(self, ckpt) -> int:
        """Cached-mutating: the at-least-once install whose cache hit
        makes it exactly-once — replay returns the first restore's rid
        instead of materializing the decode twice."""
        from ..rollout.migration import DecodeCheckpoint
        return int(self.engine.restore_request(
            DecodeCheckpoint.from_wire(ckpt)))

    def _m_resume_request(self, rid) -> None:
        """Cached-mutating: replay keeps a retried resume from
        double-unpausing a row the scheduler re-froze since."""
        self.engine.resume_request(int(rid))

    def _m_release_request(self, rid) -> bool:
        """Cached-mutating: replay preserves the first release's
        verdict — re-executing would report False for a row that THIS
        call already released."""
        return bool(self.engine.release_request(int(rid)))

    def _m_stats(self) -> Dict[str, Any]:
        return dict(self.engine.stats())


def serve_engine_http(engine_or_handler, *, host: str = "127.0.0.1",
                      port: int = 0):
    """Serve one engine over real HTTP; returns ``(server, port)``.

    ``server`` is a started ``ThreadingHTTPServer`` (daemon thread);
    call ``server.shutdown()`` when done. Port 0 picks a free port —
    the test-friendly default.
    """
    handler = (engine_or_handler
               if isinstance(engine_or_handler, RpcHandlerBase)
               else EngineRpcHandler(engine_or_handler))
    return serve_rpc_http(handler, host=host, port=port)


def serve_rpc_http(handler: RpcHandlerBase, *, host: str = "127.0.0.1",
                   port: int = 0, thread_name: str = "serve-rpc-http"):
    """Serve any :class:`RpcHandlerBase` behind the :data:`~.rpc.RPC_PATH`
    JSON frame over a stdlib ``ThreadingHTTPServer``; returns
    ``(server, port)``. Shared by the engine shim above and the
    learner gateway (``learner_server.serve_fleet_http``)."""
    import http.server

    class _Rpc(http.server.BaseHTTPRequestHandler):
        def do_POST(self):     # noqa: N802 (stdlib naming)
            if self.path != RPC_PATH:
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                frame = json.loads(self.rfile.read(length))
                method = frame["method"]
                params = decode(frame.get("params") or {})
                request_id = frame.get("request_id")
                trace = frame.get("trace")
            except (ValueError, KeyError, TypeError):
                self.send_error(400, "malformed rpc frame")
                return
            try:
                result = handler.handle(method, params,
                                        request_id=request_id,
                                        trace=trace)
                body = {"ok": True, "result": encode(result)}
            except RpcApplicationError as e:
                body = {"ok": False, "error_type": e.error_type,
                        "message": e.message}
            except RpcProtocolError as e:
                self.send_error(400, str(e))
                return
            except Exception as e:      # crash mid-call → 5xx
                self.send_error(500, str(e))
                return
            payload = json.dumps(body).encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *args):   # keep test output quiet
            pass

    server = http.server.ThreadingHTTPServer((host, port), _Rpc)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name=thread_name, daemon=True)
    thread.start()
    return server, server.server_address[1]
