"""The port's native runtime (``senweaver_ide_tpu_torch/runtime/``): its
own build of the mmap trace ring, the batched byte tokenizer and the
senweaver-ctl CLI from the package's ``native/`` sources, and the
control plane's wire against the JAX package's in both directions.

Mirrors tests/test_runtime.py and the CLI cases of
tests/test_ctl_extended.py on the port's library and binary: the ring's
roundtrip, wraparound, oversize rejection and crash durability; the
tokenizer equal to the JAX package's on seeded texts, native and
fallback; ping / submit / status / stop / a custom method / msgpack
through the port's binary; the JAX client against the port's server and
the port's client and binary against the JAX server; and the binary's
exit codes (0 result, 2 error, 1 transport, 3 singleton lock). Tests
that need the library skip only where g++ is absent.
"""

import fcntl
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from senweaver_ide_tpu.runtime import ControlClient as JaxClient
from senweaver_ide_tpu.runtime import ControlServer as JaxServer
from senweaver_ide_tpu.runtime import \
    byte_tokenize_batch as jax_tokenize_batch
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from senweaver_ide_tpu_torch.runtime import (ControlClient, ControlError,
                                             ControlServer, TraceRing,
                                             byte_tokenize_batch, native)
from senweaver_ide_tpu_torch.traces import TraceCollector


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny-model engine steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores and spins, several times slower than
    one thread. The previous setting is restored for the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ctl():
    """The port's senweaver-ctl, built (with the library) from the
    package's own sources; skips only where there is no g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    assert native.build_native(), "the port's native build failed"
    assert native.native_available()
    path = native.ctl_binary_path()
    pkg = os.path.dirname(os.path.dirname(native.__file__))
    assert path == os.path.join(pkg, "_build", "senweaver-ctl")
    return path


def _run(binary, sock, *args, env=None, timeout=30):
    proc = subprocess.run([binary, "--socket", sock, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env)
    lines = [ln for ln in proc.stdout.strip().split("\n") if ln]
    return proc.returncode, (json.loads(lines[-1]) if lines else {})


@pytest.fixture()
def server(tmp_path):
    s = ControlServer(str(tmp_path / "ctl.sock"))
    s.start()
    yield s
    s.stop()


# ---- the trace ring -------------------------------------------------------

def test_ring_append_read_roundtrip(tmp_path, ctl):
    ring = TraceRing(str(tmp_path / "spans.ring"), slot_size=256, n_slots=8)
    assert ring.append(b'{"span": 1}') == 0
    assert ring.read(0) == b'{"span": 1}'
    assert ring.read(5) is None
    ring.close()


def test_ring_wraparound_evicts_oldest(tmp_path, ctl):
    ring = TraceRing(str(tmp_path / "w.ring"), slot_size=64, n_slots=4)
    for i in range(6):
        ring.append(f"rec{i}".encode())
    assert ring.window() == (2, 6)
    assert ring.read(0) is None and ring.read(1) is None
    assert ring.read(2) == b"rec2" and ring.read(5) == b"rec5"
    ring.close()


def test_ring_oversize_rejected_and_counted(tmp_path, ctl):
    ring = TraceRing(str(tmp_path / "o.ring"), slot_size=32, n_slots=4)
    with pytest.raises(ValueError):
        ring.append(b"x" * 100)
    assert ring.dropped == 1 and ring.head == 0
    ring.close()


def test_ring_crash_durability(tmp_path, ctl):
    """Reopened after a close (a restart), the records are still there;
    a child process killed without closing leaves its record too."""
    path = str(tmp_path / "d.ring")
    ring = TraceRing(path, slot_size=128, n_slots=16)
    ring.append(b"persisted")
    ring.close()
    code = ("import os, sys; sys.path.insert(0, %r); "
            "from senweaver_ide_tpu_torch.runtime import TraceRing; "
            "r = TraceRing(%r, slot_size=128, n_slots=16); "
            "r.append(b'crashed'); os._exit(9)"
            % (os.path.dirname(os.path.dirname(os.path.abspath(
                __file__))), path))
    assert subprocess.run([sys.executable, "-c", code],
                          timeout=60).returncode == 9
    again = TraceRing(path, slot_size=128, n_slots=16)
    assert again.head == 2
    assert [again.read(0), again.read(1)] == [b"persisted", b"crashed"]
    again.close()


def test_collector_spans_land_in_the_ring(tmp_path, ctl):
    ring = TraceRing(str(tmp_path / "sink.ring"), slot_size=2048,
                     n_slots=64)
    tc = TraceCollector(span_sink=ring.append,
                        reward_fn=lambda trace: None)
    tc.start_trace("t1")
    tc.record_user_message("t1", 0, "hello ring")
    tc.record_tool_call("t1", 1, tool_name="read_file", tool_success=True)
    assert ring.head == 2
    rec = json.loads(ring.read(0).decode())
    assert rec["data"]["content_preview"] == "hello ring"
    spans = tc.get_all_traces()[0].spans
    assert [json.loads(ring.read(i))["id"] for i in range(2)] == [
        s.id for s in spans]
    ring.close()


# ---- the batched tokenizer ------------------------------------------------

def _seeded_texts(seed=0, n=24):
    rng = np.random.default_rng(seed)
    alphabet = list("abcXYZ 019_\n\t{}") + ["é", "你", "好", "🙂", "ß"]
    return [""] + ["".join(rng.choice(alphabet, size=int(k)))
                   for k in rng.integers(0, 90, n - 1)]


@pytest.mark.parametrize("max_len,bos", [(32, True), (128, True),
                                         (16, False)])
def test_byte_tokenize_batch_matches_jax(ctl, monkeypatch, max_len, bos):
    texts = _seeded_texts()
    tok = ByteTokenizer()
    kw = dict(max_len=max_len, bos_id=tok.bos_id if bos else None,
              pad_id=tok.pad_id)
    want_ids, want_lens = jax_tokenize_batch(texts, **kw)
    got_ids, got_lens = byte_tokenize_batch(texts, **kw)
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_array_equal(got_lens, want_lens)
    # the numpy fallback (no library) gives the same rows
    monkeypatch.setattr(native, "_load", lambda: None)
    fb_ids, fb_lens = byte_tokenize_batch(texts, **kw)
    np.testing.assert_array_equal(fb_ids, want_ids)
    np.testing.assert_array_equal(fb_lens, want_lens)
    for i, t in enumerate(texts):
        ref = (([tok.bos_id] if bos else []) + list(t.encode()))[:max_len]
        assert list(got_ids[i, :got_lens[i]]) == ref


# ---- the control plane through the port's binary ---------------------------

def test_ctl_ping_submit_status_stop(server, ctl):
    sock = server.socket_path
    assert _run(ctl, sock, "ping") == (0, {"jsonrpc": "2.0", "id": 1,
                                           "result": "pong"})
    code, resp = _run(ctl, sock, "submit",
                      '{"model": "qwen2.5-coder-1.5b", "steps": 10}')
    assert code == 0
    job_id = resp["result"]["job_id"]
    assert server.jobs[job_id].params["model"] == "qwen2.5-coder-1.5b"
    code, resp = _run(ctl, sock, "status")
    assert code == 0 and resp["result"][0]["job_id"] == job_id
    assert resp["result"][0]["status"] == "queued"
    code, resp = _run(ctl, sock, "stop", job_id)
    assert code == 0 and resp["result"]["status"] == "stopped"
    assert server.jobs[job_id].status == "stopped"
    # watch returns once nothing is queued or running
    code, resp = _run(ctl, sock, "--interval", "1", "watch")
    assert code == 0 and resp["result"][0]["status"] == "stopped"


def test_ctl_custom_method_and_error_text(server, ctl):
    server.register("echo", lambda p: {"you_sent": p, "on_error": "retry"})
    code, resp = _run(ctl, server.socket_path, "call", "echo", '{"a": 1}')
    assert code == 0 and resp["result"]["you_sent"] == {"a": 1}


def test_ctl_msgpack_with_auth(tmp_path, ctl):
    s = ControlServer(str(tmp_path / "auth.sock"), token="sekrit")
    s.start()
    try:
        tok = tmp_path / "tok"
        tok.write_text("sekrit\n")
        s.register("size_of", lambda p: {"n": len(p["blob"])})
        code, resp = _run(ctl, s.socket_path, "--msgpack", "--token-file",
                          str(tok), "call", "size_of",
                          json.dumps({"blob": "x" * 70_000}))
        assert code == 0 and resp["result"]["n"] == 70_000
        code, resp = _run(ctl, s.socket_path, "--msgpack", "status")
        assert code == 2 and resp["error"]["code"] == -32001
        code, resp = _run(ctl, s.socket_path, "status",
                          env=dict(os.environ, SENWEAVER_CTL_TOKEN="sekrit"))
        assert code == 0 and resp["result"] == []
    finally:
        s.stop()


def test_ctl_exit_codes(server, ctl, tmp_path):
    sock = server.socket_path
    assert _run(ctl, sock, "ping")[0] == 0
    code, resp = _run(ctl, sock, "call", "no_such_method")
    assert code == 2 and resp["error"]["code"] == -32601
    assert _run(ctl, str(tmp_path / "nobody.sock"), "ping")[0] == 1
    lock = str(tmp_path / "ctl.lock")
    fd = os.open(lock, os.O_RDWR | os.O_CREAT)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        proc = subprocess.run([ctl, "--socket", sock, "--singleton-lock",
                               lock, "ping"], capture_output=True,
                              text=True, timeout=30)
        assert proc.returncode == 3 and "singleton lock" in proc.stderr
        fcntl.flock(fd, fcntl.LOCK_UN)
    finally:
        os.close(fd)
    assert _run(ctl, sock, "--singleton-lock", lock, "ping")[0] == 0
    assert subprocess.run([ctl], capture_output=True,
                          timeout=30).returncode == 1


# ---- the wire across the packages -----------------------------------------

def _exercise(server, client_cls, sock):
    server.register("echo", lambda p: {"got": p})
    c = client_cls(sock)
    assert c.call("ping") == "pong"
    job = c.call("submit", {"type": "grpo", "rounds": 1})
    assert job == {"job_id": "job-1", "status": "queued"}
    assert [j["job_id"] for j in c.call("status")] == ["job-1"]
    assert c.call("echo", {"a": [1, 2.5, None]}) == {"got": {"a": [1, 2.5,
                                                                   None]}}
    assert c.call("stop", {"job_id": "job-1"})["status"] == "stopped"
    return c


@pytest.mark.parametrize("direction", ["jax_client_port_server",
                                       "port_client_jax_server"])
def test_control_wire_across_packages(tmp_path, direction):
    sock = str(tmp_path / "x.sock")
    if direction == "jax_client_port_server":
        server, client_cls = ControlServer(sock), JaxClient
    else:
        server, client_cls = JaxServer(sock), ControlClient
    server.start()
    try:
        c = _exercise(server, client_cls, sock)
        with pytest.raises(Exception) as e:
            c.call("no_such_method")
        assert e.value.code == -32601
        if client_cls is ControlClient:
            assert isinstance(e.value, ControlError)
        assert server.jobs["job-1"].status == "stopped"
    finally:
        server.stop()


def test_port_ctl_drives_the_jax_server(tmp_path, ctl):
    """The wire format is unchanged: the port's binary speaks JSON and
    msgpack to the JAX package's server."""
    s = JaxServer(str(tmp_path / "j.sock"))
    s.start()
    try:
        code, resp = _run(ctl, s.socket_path, "submit", '{"steps": 3}')
        assert code == 0 and resp["result"]["job_id"] == "job-1"
        code, resp = _run(ctl, s.socket_path, "--msgpack", "status")
        assert code == 0 and resp["result"][0]["job_id"] == "job-1"
        assert s.jobs["job-1"].params == {"steps": 3}
    finally:
        s.stop()


def test_default_socket_is_the_jax_packages():
    from senweaver_ide_tpu.runtime import DEFAULT_SOCKET as jax_default
    from senweaver_ide_tpu_torch.runtime import DEFAULT_SOCKET
    assert DEFAULT_SOCKET == jax_default == "/tmp/senweaver-ctl.sock"
