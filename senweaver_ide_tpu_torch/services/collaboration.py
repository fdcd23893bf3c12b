"""Collaboration channel: device-code rooms over a local TCP coordinator.

TPU-build counterpart of the reference's RemoteCollaborationService
(browser/remoteCollaborationService.ts, 1612 LoC): WebRTC P2P remote
control with WS signaling rooms keyed by device codes (:52), 30 s
heartbeats, ≤5 reconnect attempts, and an HTTP-polling fallback (:231).

Re-scoped for the trainer: instead of sharing an editor screen, a room
shares a live training/rollout session between processes — a trainer
host broadcasts progress events and accepts control messages (pause,
checkpoint-now, config nudges) from followers on the same machine or
over an SSH-forwarded port. The transport is line-delimited JSON over
TCP; semantics kept from the reference:

- rooms are keyed by short device codes a human can read over a shoulder
- participants heartbeat; silent peers are evicted after a timeout and
  the room is told (``peer_left``)
- clients auto-reconnect up to ``MAX_RECONNECTS`` times, then drop to
  POLLING mode: short-lived connections that drain their queue — the
  reference's HTTP-polling fallback
"""

from __future__ import annotations

import json
import secrets
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

HEARTBEAT_INTERVAL_S = 30.0      # remoteCollaborationService.ts heartbeat
MAX_RECONNECTS = 5               # reconnect ceiling before polling fallback
ROOM_CODE_ALPHABET = "23456789ABCDEFGHJKMNPQRSTUVWXYZ"  # unambiguous
MAX_QUEUE = 1000


def _make_room_code() -> str:
    return "".join(secrets.choice(ROOM_CODE_ALPHABET) for _ in range(6))


class _Participant:
    def __init__(self, pid: str):
        self.pid = pid
        self.queue: Deque[Dict[str, Any]] = deque(maxlen=MAX_QUEUE)
        self.last_seen = time.time()
        self.conn: Optional[socket.socket] = None     # live push channel
        self.conn_lock = threading.Lock()

    def push(self, msg: Dict[str, Any]) -> None:
        """Push to the live connection if any; queue otherwise (the queue
        also backs the polling fallback)."""
        with self.conn_lock:
            conn = self.conn
            if conn is not None:
                try:
                    conn.sendall((json.dumps(msg) + "\n").encode())
                    return
                except OSError:
                    self.conn = None
        self.queue.append(msg)


class _Room:
    def __init__(self, code: str, host_pid: str):
        self.code = code
        self.host_pid = host_pid
        self.participants: Dict[str, _Participant] = {}
        self.created_at = time.time()


class CollabCoordinator:
    """The signaling/relay server (one per machine or per job)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 heartbeat_timeout_s: float = 3 * HEARTBEAT_INTERVAL_S):
        self._host = host
        self._port = port
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.rooms: Dict[str, _Room] = {}
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._running = False
        self._threads: List[threading.Thread] = []

    @property
    def address(self) -> tuple:
        assert self._sock is not None, "coordinator not started"
        return self._sock.getsockname()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, self._port))
        self._sock.listen(16)
        self._sock.settimeout(0.2)
        self._running = True
        for target in (self._serve, self._reap):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        for t in self._threads:
            t.join(timeout=2)
        if self._sock is not None:
            self._sock.close()

    # -- accept/serve ------------------------------------------------------
    def _serve(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()   # type: ignore[union-attr]
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        part: Optional[_Participant] = None
        try:
            conn.settimeout(0.5)
            buf = b""
            while self._running:
                try:
                    chunk = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    part = self._dispatch(conn, line, part)
        finally:
            if part is not None:
                with part.conn_lock:
                    if part.conn is conn:
                        part.conn = None
            try:
                conn.close()
            except OSError:
                pass

    # -- protocol ----------------------------------------------------------
    def _dispatch(self, conn: socket.socket, raw: bytes,
                  part: Optional[_Participant]) -> Optional[_Participant]:
        try:
            req = json.loads(raw.decode(errors="replace"))
        except json.JSONDecodeError:
            self._reply(conn, {"type": "error", "error": "bad json"})
            return part
        if not isinstance(req, dict):
            # Valid JSON, wrong shape (e.g. a bare number): without this
            # guard the .get below raised and killed the CONNECTION
            # thread (found by the adversarial frame test).
            self._reply(conn, {"type": "error", "error": "bad request"})
            return part
        rid = req.get("id")
        op = req.get("op", "")
        pid = req.get("client_id", "")
        try:
            if op == "create_room":
                with self._lock:
                    code = _make_room_code()
                    while code in self.rooms:
                        code = _make_room_code()
                    room = _Room(code, pid)
                    p = room.participants[pid] = _Participant(pid)
                    self.rooms[code] = room
                if not req.get("polling"):
                    with p.conn_lock:
                        p.conn = conn
                self._reply(conn, {"type": "ok", "id": rid, "room": code})
                return p
            if op == "join_room":
                room = self._required_room(req)
                with self._lock:
                    p = room.participants.get(pid)
                    if p is None:
                        p = room.participants[pid] = _Participant(pid)
                p.last_seen = time.time()
                if not req.get("polling"):
                    with p.conn_lock:
                        p.conn = conn
                self._relay(room, pid, {"type": "peer_joined", "peer": pid})
                self._reply(conn, {"type": "ok", "id": rid,
                                   "room": room.code,
                                   "peers": sorted(room.participants)})
                return p
            if op == "send":
                room = self._required_room(req)
                self._touch(room, pid, conn, req)
                self._relay(room, pid, {"type": "message", "from": pid,
                                        "payload": req.get("payload")})
                self._reply(conn, {"type": "ok", "id": rid})
                return part
            if op == "poll":
                room = self._required_room(req)
                p = self._touch(room, pid, conn, req)
                msgs: List[Dict[str, Any]] = []
                while p.queue:
                    msgs.append(p.queue.popleft())
                self._reply(conn, {"type": "ok", "id": rid,
                                   "messages": msgs})
                return part
            if op == "heartbeat":
                room = self._required_room(req)
                self._touch(room, pid, conn, req)
                self._reply(conn, {"type": "ok", "id": rid})
                return part
            if op == "leave":
                room = self._required_room(req)
                with self._lock:
                    room.participants.pop(pid, None)
                    empty = not room.participants
                    if empty:
                        self.rooms.pop(room.code, None)
                if not empty:
                    self._relay(room, pid, {"type": "peer_left",
                                            "peer": pid})
                self._reply(conn, {"type": "ok", "id": rid})
                return part
            raise ValueError(f"unknown op: {op}")
        except KeyError as e:
            self._reply(conn, {"type": "error", "id": rid,
                               "error": f"unknown room: {e}"})
        except Exception as e:
            self._reply(conn, {"type": "error", "id": rid,
                               "error": f"{type(e).__name__}: {e}"})
        return part

    def _room(self, code: str) -> _Room:
        with self._lock:
            room = self.rooms.get(code)
        if room is None:
            raise KeyError(code)
        return room

    def _required_room(self, req: Dict[str, Any]) -> _Room:
        code = req.get("room")
        if not code:
            # Distinct from "unknown room": the request itself is malformed.
            raise ValueError("missing 'room' field")
        return self._room(code)

    def _touch(self, room: _Room, pid: str,
               conn: Optional[socket.socket] = None,
               req: Optional[Dict[str, Any]] = None) -> _Participant:
        """Refresh liveness; transparently re-admit an evicted participant.

        If a heartbeat-evicted peer keeps talking over its still-open
        persistent connection, it is re-created here — and must get its
        push channel back (conn) plus a peer_joined broadcast, or every
        later relay would silently queue server-side while the client
        believes it is in push mode.
        """
        with self._lock:
            p = room.participants.get(pid)
            readmitted = p is None
            if readmitted:
                p = room.participants[pid] = _Participant(pid)
        p.last_seen = time.time()
        if readmitted:
            if conn is not None and not (req or {}).get("polling"):
                with p.conn_lock:
                    p.conn = conn
            self._relay(room, pid, {"type": "peer_joined", "peer": pid,
                                    "reason": "readmitted"})
        return p

    def _relay(self, room: _Room, sender: str, msg: Dict[str, Any]) -> None:
        with self._lock:
            targets = [p for pid, p in room.participants.items()
                       if pid != sender]
        for p in targets:
            p.push(msg)

    @staticmethod
    def _reply(conn: socket.socket, msg: Dict[str, Any]) -> None:
        try:
            conn.sendall((json.dumps(msg) + "\n").encode())
        except OSError:
            pass

    # -- liveness ----------------------------------------------------------
    def _reap(self) -> None:
        while self._running:
            time.sleep(min(1.0, self.heartbeat_timeout_s / 4))
            now = time.time()
            with self._lock:
                dead = [(room, pid, p)
                        for room in self.rooms.values()
                        for pid, p in room.participants.items()
                        if now - p.last_seen > self.heartbeat_timeout_s]
                for room, pid, _ in dead:
                    room.participants.pop(pid, None)
            for room, pid, _ in dead:
                self._relay(room, pid, {"type": "peer_left", "peer": pid,
                                        "reason": "heartbeat_timeout"})
            with self._lock:
                for code in [c for c, r in self.rooms.items()
                             if not r.participants]:
                    self.rooms.pop(code, None)


class CollabSession:
    """A participant: trainer host or follower.

    Holds a persistent connection for push delivery; heartbeats on an
    interval; on connection loss retries up to ``max_reconnects`` times,
    then degrades to POLLING mode (short-lived connections draining the
    server-side queue).
    """

    def __init__(self, host: str, port: int, client_id: str, *,
                 heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
                 max_reconnects: int = MAX_RECONNECTS,
                 on_message: Optional[Callable[[Dict[str, Any]], None]] = None):
        self._addr = (host, port)
        self.client_id = client_id
        self.heartbeat_interval_s = heartbeat_interval_s
        self.max_reconnects = max_reconnects
        self.on_message = on_message
        self.room: Optional[str] = None
        self.polling = False
        self.reconnects_used = 0
        self.events: Deque[Dict[str, Any]] = deque(maxlen=MAX_QUEUE)
        self._conn: Optional[socket.socket] = None
        self._conn_lock = threading.Lock()
        self._pending: Dict[int, Dict[str, Any]] = {}
        self._waiting: set = set()     # rids a _request still awaits
        self._pending_cv = threading.Condition()
        self._next_id = 1
        self._running = False
        self._reconnect_lock = threading.Lock()
        self._stop_event = threading.Event()
        self._threads: List[threading.Thread] = []

    # -- connection --------------------------------------------------------
    def connect(self) -> None:
        self._conn = socket.create_connection(self._addr, timeout=5)
        self._conn.settimeout(0.5)
        self._running = True
        self._stop_event.clear()
        if not self._threads:
            for target in (self._read_loop, self._heartbeat_loop):
                t = threading.Thread(target=target, daemon=True)
                t.start()
                self._threads.append(t)

    def close(self) -> None:
        self._running = False
        self._stop_event.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads = []
        with self._conn_lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None

    # -- API ---------------------------------------------------------------
    def create_room(self) -> str:
        resp = self._request({"op": "create_room"})
        self.room = resp["room"]
        return self.room

    def join(self, room: str) -> List[str]:
        resp = self._request({"op": "join_room", "room": room})
        self.room = room
        return resp.get("peers", [])

    def send(self, payload: Any) -> None:
        assert self.room, "join a room first"
        self._request({"op": "send", "room": self.room, "payload": payload})

    def poll(self) -> List[Dict[str, Any]]:
        """Drain queued messages (polling fallback; also usable any time)."""
        assert self.room, "join a room first"
        resp = self._request({"op": "poll", "room": self.room})
        msgs = resp.get("messages", [])
        for m in msgs:
            self._deliver(m)
        return msgs

    def leave(self) -> None:
        """Best-effort: the room may already be gone (eviction/reap)."""
        if self.room:
            try:
                self._request({"op": "leave", "room": self.room})
            except (OSError, TimeoutError, RuntimeError):
                pass
            self.room = None

    # -- internals ---------------------------------------------------------
    def _request(self, req: Dict[str, Any],
                 _attempt: int = 0) -> Dict[str, Any]:
        req = dict(req)
        req["client_id"] = self.client_id
        if self.polling:
            return self._oneshot(req)
        with self._pending_cv:
            rid = self._next_id
            self._next_id += 1
            self._waiting.add(rid)
        req["id"] = rid
        line = (json.dumps(req) + "\n").encode()
        try:
            with self._conn_lock:
                conn = self._conn
                if conn is None:
                    raise OSError("not connected")
                conn.sendall(line)
        except OSError:
            with self._pending_cv:
                self._waiting.discard(rid)
            self._handle_disconnect(conn)
            # Bounded per-request retries: a flapping coordinator that
            # accepts then drops each connection would otherwise recurse
            # forever (each successful reconnect restores the outage
            # budget, so that alone never terminates this loop).
            if _attempt + 1 >= max(self.max_reconnects, 1):
                raise OSError(
                    f"request {req.get('op')!r} failed after "
                    f"{_attempt + 1} attempts")
            return self._request({k: v for k, v in req.items()
                                  if k not in ("id", "client_id")},
                                 _attempt + 1)
        with self._pending_cv:
            try:
                deadline = time.time() + 5
                while rid not in self._pending:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no response for {req.get('op')}")
                    self._pending_cv.wait(remaining)
                resp = self._pending.pop(rid)
            finally:
                # Abandoned rid: the read loop must drop (not store) a
                # reply that straggles in after this timeout/raise.
                self._waiting.discard(rid)
                self._pending.pop(rid, None)
        if resp.get("type") == "error":
            raise RuntimeError(resp.get("error", "collab error"))
        return resp

    def _oneshot(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Polling fallback: one short-lived connection per request."""
        req = dict(req)
        req["polling"] = True
        with socket.create_connection(self._addr, timeout=5) as c:
            c.sendall((json.dumps(req) + "\n").encode())
            c.settimeout(5)
            buf = b""
            while b"\n" not in buf:
                chunk = c.recv(65536)
                if not chunk:
                    break
                buf += chunk
        line = buf.split(b"\n", 1)[0].strip()
        if not line:
            # Coordinator closed without replying (e.g. mid-shutdown).
            # Surface as OSError so best-effort callers' catches apply.
            raise OSError("no reply from coordinator")
        try:
            resp = json.loads(line.decode(errors="replace"))
        except json.JSONDecodeError as e:
            raise OSError(f"malformed reply from coordinator: {e}") from e
        if resp.get("type") == "error":
            raise RuntimeError(resp.get("error", "collab error"))
        return resp

    def _read_loop(self) -> None:
        buf = b""
        last_conn: Optional[socket.socket] = None
        while self._running:
            with self._conn_lock:
                conn = self._conn
            if conn is not last_conn:
                # New transport: a partial line from the dead socket must
                # not prefix (and corrupt) the first reply on this one.
                buf = b""
                last_conn = conn
            if conn is None:
                if self.polling:
                    return
                time.sleep(0.05)
                continue
            try:
                chunk = conn.recv(65536)
            except socket.timeout:
                continue
            except OSError:
                self._handle_disconnect(conn)
                continue
            if not chunk:
                self._handle_disconnect(conn)
                continue
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    msg = json.loads(line.decode(errors="replace"))
                except json.JSONDecodeError:
                    continue
                if "id" in msg and msg["id"] is not None:
                    with self._pending_cv:
                        if msg["id"] in self._waiting:
                            self._pending[msg["id"]] = msg
                            self._pending_cv.notify_all()
                        # else: straggler reply for an abandoned request
                elif msg.get("type") not in ("ok", "error"):
                    # id-less ok/error replies come from fire-and-forget
                    # rejoins after a reconnect — not room traffic.
                    self._deliver(msg)

    def _deliver(self, msg: Dict[str, Any]) -> None:
        self.events.append(msg)
        if self.on_message is not None:
            try:
                self.on_message(msg)
            except Exception:
                pass

    def _heartbeat_loop(self) -> None:
        while self._running:
            # Event-based wait so close() interrupts a 30 s sleep instantly.
            if self._stop_event.wait(self.heartbeat_interval_s):
                return
            if not self._running or not self.room:
                continue
            try:
                self._request({"op": "heartbeat", "room": self.room})
            except (OSError, TimeoutError, RuntimeError):
                pass

    def _handle_disconnect(self, failed: Optional[socket.socket] = None
                           ) -> None:
        """Reconnect with rejoin, ≤max_reconnects, else polling fallback.

        Idempotent per failed connection: the read loop and a sender can
        both observe the same dead socket, but only the first caller acts
        — a later caller whose ``failed`` socket is no longer current
        must NOT close the healthy replacement connection.

        The rejoin is fire-and-forget (no id): this may run on the read
        loop's own thread, which cannot simultaneously wait for the
        response it is responsible for delivering.
        """
        with self._reconnect_lock:
            with self._conn_lock:
                if self._conn is not failed:
                    return            # already handled by another thread
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                    self._conn = None
            if self.polling:
                return
            while (self._running and not self._stop_event.is_set()
                   and self.reconnects_used < self.max_reconnects):
                self.reconnects_used += 1
                try:
                    conn = socket.create_connection(self._addr, timeout=2)
                    conn.settimeout(0.5)
                    if self.room:
                        conn.sendall((json.dumps(
                            {"op": "join_room", "room": self.room,
                             "client_id": self.client_id}) + "\n").encode())
                    with self._conn_lock:
                        self._conn = conn
                    # The budget is per outage, not per session lifetime:
                    # a successful reconnect restores the full allowance.
                    self.reconnects_used = 0
                    return
                except (OSError, TimeoutError):
                    time.sleep(0.1 * self.reconnects_used)
            self.polling = True   # degraded mode; poll() still works
