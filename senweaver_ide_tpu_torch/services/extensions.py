"""Extension tool servers: MCP-style stdio JSON-RPC clients.

Mirrors `common/mcpService.ts` (365) + `electron-main/mcpChannel.ts`
(398): external tool servers are child processes speaking JSON-RPC over
stdio (StdioClientTransport, mcpChannel.ts:13,:202); the client manages
lifecycle (_createClient :239, close/recreate on failure :144-151) and
bridges the servers' tools into the agent loop
(chatThreadService.ts:1096-1107).

Protocol (newline-delimited JSON-RPC 2.0, MCP-shaped):
  → {method: "initialize"}                        ← {result: {name, ...}}
  → {method: "tools/list"}                        ← {result: {tools: [...]}}
  → {method: "tools/call", params: {name, arguments}}  ← {result: ...}

Tools are namespaced ``<server>.<tool>`` when bridged, so extension tools
can never shadow builtin names.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import threading
import time as _time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ExtensionTool:
    server: str
    name: str
    description: str = ""
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def full_name(self) -> str:
        return f"{self.server}.{self.name}"


class ExtensionServerError(RuntimeError):
    """Application-level failure (a JSON-RPC error response)."""


class ExtensionTransportError(ExtensionServerError):
    """Transport failure (dead process, closed/unresponsive stream) — the
    only class that justifies a server restart."""


class ExtensionServer:
    """One stdio child process + JSON-RPC session."""

    def __init__(self, name: str, command: List[str], *,
                 timeout_s: float = 10.0):
        self.name = name
        self.command = command
        self.timeout_s = timeout_s
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._next_id = 1
        self._rx_buf = b""          # bytes read past the current line
        self.tools: List[ExtensionTool] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._proc = subprocess.Popen(
            self.command, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True, bufsize=1)
        self._request("initialize", {"client": "senweaver_ide_tpu_torch"})
        result = self._request("tools/list", {})
        self.tools = [
            ExtensionTool(server=self.name, name=t["name"],
                          description=t.get("description", ""),
                          params=t.get("inputSchema",
                                       t.get("params", {})))
            for t in result.get("tools", [])]

    @property
    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def restart(self) -> None:
        """close/recreate on failure (mcpChannel.ts:144-151)."""
        self.stop()
        self._rx_buf = b""
        self.start()

    def stop(self) -> None:
        if self._proc is not None:
            try:
                self._proc.terminate()
                self._proc.wait(timeout=2)
            except (OSError, subprocess.TimeoutExpired):
                self._proc.kill()
            self._proc = None

    # -- rpc ---------------------------------------------------------------
    def _read_line_with_timeout(self, deadline: float) -> str:
        """Deadline-bounded readline on the child's stdout — a wedged
        server must raise, not hang the agent loop with the lock held.
        Bytes past the newline stay in ``_rx_buf`` for the next line (a
        server may flush several lines at once)."""
        import os as _os
        import selectors as _selectors
        assert self._proc and self._proc.stdout
        if b"\n" in self._rx_buf:
            line, self._rx_buf = self._rx_buf.split(b"\n", 1)
            return line.decode(errors="replace")
        fd = self._proc.stdout.fileno()
        _os.set_blocking(fd, False)
        sel = _selectors.DefaultSelector()
        sel.register(fd, _selectors.EVENT_READ)
        try:
            while True:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    raise ExtensionTransportError(
                        f"{self.name}: no response within "
                        f"{self.timeout_s:.0f}s")
                if not sel.select(timeout=min(remaining, 0.2)):
                    continue
                data = _os.read(fd, 65536)
                if not data:
                    raise ExtensionTransportError(
                        f"{self.name}: server closed the stream")
                self._rx_buf += data
                if b"\n" in self._rx_buf:
                    line, self._rx_buf = self._rx_buf.split(b"\n", 1)
                    return line.decode(errors="replace")
        finally:
            sel.close()

    def _request(self, method: str, params: Any) -> Any:
        with self._lock:
            if not self.alive:
                raise ExtensionTransportError(
                    f"extension server {self.name} is not running")
            rid = self._next_id
            self._next_id += 1
            msg = json.dumps({"jsonrpc": "2.0", "id": rid,
                              "method": method, "params": params})
            assert self._proc and self._proc.stdin and self._proc.stdout
            try:
                self._proc.stdin.write(msg + "\n")
                self._proc.stdin.flush()
            except OSError as e:
                raise ExtensionTransportError(
                    f"{self.name}: io error: {e}")
            deadline = _time.monotonic() + self.timeout_s
            while True:
                line = self._read_line_with_timeout(deadline)
                try:
                    resp = json.loads(line)
                except json.JSONDecodeError:
                    continue     # stray log line on stdout: skip it
                if resp.get("id") != rid:
                    continue     # late response from a timed-out call
                if "error" in resp:
                    raise ExtensionServerError(
                        f"{self.name}: {resp['error'].get('message')}")
                return resp.get("result")

    def call_tool(self, tool: str, arguments: Dict[str, Any]) -> Any:
        return self._request("tools/call",
                             {"name": tool, "arguments": arguments})


class ExtensionToolRegistry:
    """Manages servers and bridges their tools into a ToolsService."""

    def __init__(self):
        self.servers: Dict[str, ExtensionServer] = {}

    def add_server(self, name: str, command: List[str]) -> ExtensionServer:
        server = ExtensionServer(name, command)
        server.start()
        self.servers[name] = server
        return server

    def remove_server(self, name: str) -> None:
        server = self.servers.pop(name, None)
        if server:
            server.stop()

    def all_tools(self) -> List[ExtensionTool]:
        return [t for s in self.servers.values() for t in s.tools]

    def call(self, full_name: str, arguments: Dict[str, Any]) -> Any:
        server_name, _, tool = full_name.partition(".")
        server = self.servers.get(server_name)
        if server is None:
            raise KeyError(f"unknown extension server: {server_name}")
        try:
            return server.call_tool(tool, arguments)
        except ExtensionTransportError:
            # One recreate attempt on TRANSPORT failure only (the
            # reference's close/recreate, mcpChannel.ts:144-151);
            # application error responses must not kill a healthy,
            # possibly stateful server.
            server.restart()
            return server.call_tool(tool, arguments)

    def close(self) -> None:
        for name in list(self.servers):
            self.remove_server(name)
