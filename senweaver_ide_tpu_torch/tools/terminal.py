"""Terminal tools: ephemeral + persistent command execution.

Mirrors `browser/terminalToolService.ts` (388 LoC) semantics inside the
rollout sandbox:

- run_command: spawn, stream output, resolve on exit or after
  MAX_TERMINAL_INACTIVE_TIME_S (8 s) of output inactivity → {type:'timeout'}
  (TerminalResolveReason, toolsServiceTypes.ts:8).
- open/run/kill persistent terminals: a long-lived shell per ID; commands
  return after MAX_TERMINAL_BG_COMMAND_TIME_S (5 s) with output-so-far and
  keep running in the background (prompts.ts:29-31 caps).
- Output capped at MAX_TERMINAL_CHARS (100k), later re-capped to
  TERMINAL_OUTPUT_MAX_CHARS (5k) by the stringifier.

Commands run with cwd inside the sandbox; the environment is scrubbed to a
minimal allowlist for reproducibility (SURVEY.md §7 hermeticity).
"""

from __future__ import annotations

import dataclasses
import os
import re
import selectors
import signal
import subprocess
import time
from typing import Dict, Optional

from ..context.token_config import (MAX_TERMINAL_BG_COMMAND_TIME_S,
                                    MAX_TERMINAL_CHARS,
                                    MAX_TERMINAL_INACTIVE_TIME_S)

_ENV_ALLOWLIST = ("PATH", "HOME", "LANG", "TERM", "PYTHONPATH")

# Model-generated shell must not reach the network: rollout rewards depend
# on reproducibility, and an autonomous policy with host network access is
# a safety hazard at scale. Linux user+net namespaces (unshare -r -n) give
# no-network confinement without privileges; probed once per process.
_ISOLATION_PREFIX = ("unshare", "-r", "-n")
_isolation_supported: Optional[bool] = None


def isolation_available() -> bool:
    global _isolation_supported
    if _isolation_supported is None:
        try:
            _isolation_supported = subprocess.run(
                [*_ISOLATION_PREFIX, "true"], capture_output=True,
                timeout=10).returncode == 0
        except Exception:
            _isolation_supported = False
    return _isolation_supported


@dataclasses.dataclass
class CommandResult:
    output: str
    resolve_reason: str          # 'done' | 'timeout' | 'bgtimeout' | 'killed'
    exit_code: Optional[int]
    duration_s: float


def _scrubbed_env() -> Dict[str, str]:
    return {k: os.environ[k] for k in _ENV_ALLOWLIST if k in os.environ}


def _read_until(proc: subprocess.Popen, *, inactive_timeout: float,
                hard_timeout: Optional[float] = None) -> tuple[str, str]:
    """Drain stdout until exit, inactivity timeout, or hard timeout.
    Returns (output, reason). stdout must be in non-blocking mode: a
    backgrounded grandchild can inherit the pipe and keep it open long after
    the shell exits, so every read here must be unable to block."""
    os.set_blocking(proc.stdout.fileno(), False)  # type: ignore[union-attr]
    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)  # type: ignore[arg-type]
    chunks: list[bytes] = []
    total = 0
    start = time.monotonic()
    last_activity = start

    def drain() -> None:
        nonlocal total
        while True:
            data = proc.stdout.read(65536)  # type: ignore[union-attr]
            if not data:
                return
            last = time.monotonic()
            nonlocal last_activity
            last_activity = last
            if total < MAX_TERMINAL_CHARS:
                chunks.append(data)
                total += len(data)

    while True:
        now = time.monotonic()
        if proc.poll() is not None:
            drain()  # non-blocking: grabs whatever is buffered, no more
            return (b"".join(chunks).decode(errors="replace"), "done")
        if hard_timeout is not None and now - start >= hard_timeout:
            return (b"".join(chunks).decode(errors="replace"), "bgtimeout")
        if now - last_activity >= inactive_timeout:
            return (b"".join(chunks).decode(errors="replace"), "timeout")
        if sel.select(timeout=0.1):
            drain()


class TerminalManager:
    """Ephemeral run_command + persistent terminal pool for one sandbox."""

    def __init__(self, cwd: str, *, isolation: str = "auto"):
        """``isolation``: 'auto' = user+net namespaces when the kernel
        allows (else unisolated), 'netns' = require them (raise if
        unavailable), 'none' = plain subprocesses. ``self.isolated``
        reports the outcome — ToolsService denies terminal-class approval
        by default when it is False."""
        self.cwd = cwd
        if isolation == "none":
            self.isolated = False
        elif isolation in ("auto", "netns"):
            self.isolated = isolation_available()
            if isolation == "netns" and not self.isolated:
                raise RuntimeError(
                    "terminal isolation required but user+net namespaces "
                    "are unavailable (unshare -r -n failed)")
        else:
            raise ValueError(f"unknown isolation mode {isolation!r}")
        self._persistent: Dict[str, subprocess.Popen] = {}
        self._next_id = 1
        self._sentinel_n = 0

    def _argv(self, argv: list) -> list:
        return [*_ISOLATION_PREFIX, *argv] if self.isolated else argv

    def run_command(self, command: str, *, cwd: Optional[str] = None,
                    inactive_timeout: float = MAX_TERMINAL_INACTIVE_TIME_S
                    ) -> CommandResult:
        start = time.monotonic()
        proc = subprocess.Popen(
            self._argv(["/bin/sh", "-c", command]), cwd=cwd or self.cwd,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=_scrubbed_env(), start_new_session=True)
        out, reason = _read_until(proc, inactive_timeout=inactive_timeout)
        if reason != "done":
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        return CommandResult(output=out[:MAX_TERMINAL_CHARS],
                             resolve_reason=reason,
                             exit_code=proc.returncode if reason == "done"
                             else None,
                             duration_s=time.monotonic() - start)

    # -- persistent terminals ---------------------------------------------
    def open_persistent(self, *, cwd: Optional[str] = None) -> str:
        tid = f"terminal-{self._next_id}"
        self._next_id += 1
        proc = subprocess.Popen(
            self._argv(["/bin/sh"]), cwd=cwd or self.cwd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=_scrubbed_env(), start_new_session=True)
        os.set_blocking(proc.stdout.fileno(), False)  # type: ignore
        self._persistent[tid] = proc
        return tid

    def run_persistent(self, terminal_id: str, command: str,
                       *, bg_timeout: float = MAX_TERMINAL_BG_COMMAND_TIME_S
                       ) -> CommandResult:
        proc = self._persistent.get(terminal_id)
        if proc is None or proc.poll() is not None:
            raise KeyError(f"no persistent terminal: {terminal_id}")
        # Discard late output from a previous bgtimeout'd command so it is
        # not misattributed to this one. Bounded: a still-running command
        # that streams output forever must not wedge the drain.
        drain_deadline = time.monotonic() + 0.25
        while (proc.stdout.read(65536)  # type: ignore[union-attr]
               and time.monotonic() < drain_deadline):
            pass
        start = time.monotonic()
        # Sentinel echo so fast commands resolve immediately instead of
        # idling the full bg window (the reference resolves on completion;
        # only still-running commands hit the 5 s return-and-continue path).
        self._sentinel_n += 1
        sentinel = f"__SW_DONE_{self._sentinel_n}__"
        proc.stdin.write(  # type: ignore[union-attr]
            (command + f"\nprintf '%s\\n' {sentinel}\n").encode())
        proc.stdin.flush()  # type: ignore[union-attr]
        buf = b""
        done = False
        while time.monotonic() - start < bg_timeout:
            data = proc.stdout.read(65536)  # type: ignore[union-attr]
            if data:
                buf += data
                if sentinel.encode() in buf:   # exact CURRENT sentinel only
                    done = True
                    break
            else:
                time.sleep(0.02)
        if done:
            buf = buf[:buf.find(sentinel.encode())]
        # Anything up to a LOWER-numbered sentinel is late output of a
        # previously bgtimeout'd command that escaped the pre-drain window —
        # discard it rather than misattribute it to this command.
        stale = None
        for m in re.finditer(rb"__SW_DONE_(\d+)__\n?", buf):
            if int(m.group(1)) < self._sentinel_n:
                stale = m
        if stale is not None:
            buf = buf[stale.end():]
        out = re.sub(r"__SW_DONE_\d+__\n?", "",
                     buf.decode(errors="replace"))
        return CommandResult(
            output=out[:MAX_TERMINAL_CHARS],
            resolve_reason="done" if done else "bgtimeout",
            exit_code=None,
            duration_s=time.monotonic() - start)

    def kill_persistent(self, terminal_id: str) -> None:
        proc = self._persistent.pop(terminal_id, None)
        if proc is None:
            raise KeyError(f"no persistent terminal: {terminal_id}")
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()

    def close(self) -> None:
        for tid in list(self._persistent):
            self.kill_persistent(tid)
