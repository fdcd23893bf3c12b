"""The port's cross-host fleet (``serve/rpc.py``, ``remote.py``,
``remote_server.py``) against the JAX package's.

First the wire codec, which the port rewrote for tensors: a frame of a
numpy array, an fp32 tensor or a bf16 tensor is byte for byte the frame
JAX writes for the same values (apart from the module path a namedtuple
names), a port bf16 frame decodes in JAX to the same ``ml_dtypes`` bits
and the reverse, tensors on their way out never reach the pickle
fallback, and a decoded payload is placed on the engine's device and
dtype before the engine sees it.

Then every scenario of tests/test_remote_fleet.py over ``LoopbackTransport``
(chaos from a ``NetworkFaultPlan``, fake clocks), written once and run on
both packages with the same outcomes, handler execution counts, serving
counters and leak-free engines; one replica over ``HttpTransport`` on
127.0.0.1; and live migration across the wire (the remote races of
tests/test_migration.py, and a JAX checkpoint restored on a port engine
through the codec).
"""

import json
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from senweaver_ide_tpu_torch.analysis.lock_order import LockOrderRecorder
from senweaver_ide_tpu.serve import rpc as jrpc
from senweaver_ide_tpu_torch.serve import placement
from senweaver_ide_tpu_torch.serve import rpc as trpc
from torch_fleet_sides import (FakeClock, Models, Side, both,
                               check_leaks_all, one_torch_thread,
                               outcome_view)

PROMPT = [5, 9, 2, 7, 1, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def models():
    return Models()


def _frame(codec, value):
    return json.dumps(codec.encode(value), sort_keys=True)


# ---- the wire codec -------------------------------------------------------

_RNG = np.random.default_rng(7)
_F32 = _RNG.standard_normal((3, 5)).astype(np.float32)
NUMPY_VALUES = {
    "f32": _F32, "f32_T": _F32.T, "i32": np.arange(7, dtype=np.int32),
    "i64_0d": np.int64(-3), "f32_0d": np.float32(2.5),
    "bool": np.array([True, False]), "u8": np.arange(9, dtype=np.uint8),
    "empty": np.zeros((0, 4), np.float32), "f16": _F32.astype(np.float16),
}


@pytest.mark.parametrize("name", sorted(NUMPY_VALUES))
def test_numpy_frames_equal_jax(name):
    value = NUMPY_VALUES[name]
    assert _frame(trpc, value) == _frame(jrpc, value)
    back = trpc.decode(json.loads(_frame(jrpc, value)))
    assert back.dtype == np.asarray(value).dtype
    np.testing.assert_array_equal(back, value)


@pytest.mark.parametrize("shape", [(3, 5), (2, 0), (), (4, 1, 3)])
def test_fp32_tensor_frame_equals_jax_array_frame(shape):
    a = np.asarray(_RNG.standard_normal(shape), dtype=np.float32)
    assert _frame(trpc, torch.from_numpy(a)) == _frame(jrpc, jnp.asarray(a))
    # a strided view and a transposed array encode their values, not
    # their memory
    if len(shape) == 2:
        assert _frame(trpc, torch.from_numpy(a).T) == \
            _frame(jrpc, jnp.asarray(a).T)


@pytest.mark.parametrize("shape", [(3, 5), (0, 2), (), (2, 3, 4)])
def test_bf16_frames_equal_and_cross_both_ways(shape):
    a = np.asarray(_RNG.standard_normal(shape) * 3, dtype=np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    ft, fj = _frame(trpc, t), _frame(jrpc, j)
    assert ft == fj
    assert json.loads(ft)["__nd__"]["dtype"] == "bfloat16"
    # port frame -> JAX: the same ml_dtypes bits
    in_jax = jrpc.decode(json.loads(ft))
    assert in_jax.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(in_jax.view(np.uint16),
                                  np.asarray(j).view(np.uint16))
    # JAX frame -> port: a bf16 host tensor with the same bits
    in_port = trpc.decode(json.loads(fj))
    assert isinstance(in_port, torch.Tensor)
    assert in_port.dtype == torch.bfloat16 and in_port.device.type == "cpu"
    assert torch.equal(in_port.view(torch.int16), t.view(torch.int16))


def test_float8_frames_cross_both_ways():
    a = np.linspace(-4, 4, 12, dtype=np.float32).reshape(3, 4)
    t = torch.from_numpy(a).to(torch.float8_e4m3fn)
    j = jnp.asarray(a).astype(jnp.float8_e4m3fn)
    assert _frame(trpc, t) == _frame(jrpc, j)
    back = trpc.decode(json.loads(_frame(jrpc, j)))
    assert back.dtype == torch.float8_e4m3fn
    assert torch.equal(back.view(torch.uint8), t.view(torch.uint8))


def test_containers_and_kvcache_frames_match_jax_apart_from_module():
    from senweaver_ide_tpu.models.transformer import KVCache as JKV
    from senweaver_ide_tpu_torch.models.transformer import KVCache as TKV
    k = _RNG.standard_normal((2, 1, 4, 1, 3)).astype(np.float32)
    jv = {"kv": JKV(k=jnp.asarray(k), v=jnp.asarray(k),
                    length=jnp.asarray([3], jnp.int32)),
          "xs": [1, 2.5, "a", None, (3, True)]}
    tv = {"kv": TKV(k=torch.from_numpy(k), v=torch.from_numpy(k),
                    length=torch.tensor([3], dtype=torch.int32)),
          "xs": [1, 2.5, "a", None, (3, True)]}
    ft = _frame(trpc, tv).replace("senweaver_ide_tpu_torch.",
                                  "senweaver_ide_tpu.")
    assert ft == _frame(jrpc, jv)
    # a JAX frame's namedtuple is rebuilt from the port's own module
    got = trpc.decode(json.loads(_frame(jrpc, jv)))
    assert type(got["kv"]) is TKV
    np.testing.assert_array_equal(got["kv"].k, k)
    assert got["xs"] == [1, 2.5, "a", None, (3, True)]


class _Box:
    def __init__(self):
        self.t = torch.ones(3)


def test_a_tensor_never_reaches_the_pickle_fallback():
    with pytest.raises(trpc.RpcProtocolError, match="pickle fallback"):
        trpc.encode({1: torch.zeros(2)})
    with pytest.raises(trpc.RpcProtocolError):
        trpc.encode({"box": _Box()})
    # tensor-free exotica still ride the pickle, as in JAX
    assert trpc.decode(trpc.encode({1: [2]})) == {1: [2]}


def test_decoded_payload_is_placed_on_the_engine_dtype():
    """``on_device`` with ``like``: an fp32 numpy leaf replacing a bf16
    leaf becomes bf16; a leaf of another shape, or an int leaf, keeps its
    own dtype; ``copy=True`` never aliases the caller's tensors."""
    like = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
            "n": {"s": torch.zeros(4)}}
    tree = {"w": np.ones((2, 3), np.float32),
            "n": {"s": np.ones(4, np.float32)},
            "i": np.arange(3, dtype=np.int32)}
    out = placement.on_device(tree, torch.device("cpu"), like=like)
    assert out["w"].dtype == torch.bfloat16
    assert out["n"]["s"].dtype == torch.float32
    assert out["i"].dtype == torch.int32
    src = {"w": torch.ones(2)}
    same = placement.on_device(src)
    assert same["w"].data_ptr() == src["w"].data_ptr()
    copied = placement.on_device(src, copy=True)
    assert copied["w"].data_ptr() != src["w"].data_ptr()


# ---- the remote fleet scenarios (tests/test_remote_fleet.py) --------------

def _fast(S):
    return S.res.RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=False)


def make_remote_fleet(S, n, *, clock=None, plan=None, num_slots=2,
                      probe_interval_s=0.0, max_retries=2,
                      wire_codec=False, replica_kw=None):
    clock = clock or time.monotonic
    handlers, transports, replicas = [], [], []
    for i in range(n):
        h = S.serve.EngineRpcHandler(S.engine(num_slots=num_slots))
        tr = S.serve.LoopbackTransport(h, target=f"replica-{i}",
                                       fault_plan=plan,
                                       wire_codec=wire_codec)
        replicas.append(S.serve.RemoteReplica(
            f"replica-{i}", tr, policy=_fast(S), clock=clock,
            sleep=lambda s: None, **(replica_kw or {})))
        handlers.append(h)
        transports.append(tr)
    fleet = S.serve.ServingFleet(replicas, clock=clock,
                                 retry_base_delay_s=0.0,
                                 max_retries=max_retries,
                                 probe_interval_s=probe_interval_s)
    return fleet, handlers, transports


def _executed(handlers):
    return [dict(sorted(h.executed.items())) for h in handlers]


def _leaks(handlers):
    check_leaks_all(None, [h.engine for h in handlers])


def _remote_matches_single(S):
    ref = S.reference(PROMPT, 10)
    fleet, handlers, _ = make_remote_fleet(S, 2, wire_codec=True)
    t = fleet.submit(PROMPT, max_new_tokens=10)
    fleet.run()
    assert list(fleet.outcome(t).tokens) == list(ref)
    _leaks(handlers)
    return dict(out=outcome_view(fleet.outcome(t)),
                executed=_executed(handlers))


def test_remote_fleet_matches_single_engine(models):
    both(models, _remote_matches_single)


def _prefix_across_wire(S):
    prefix = [7, 7, 7, 7, 2, 2]
    fleet, handlers, _ = make_remote_fleet(S, 2, wire_codec=True)
    pid = fleet.register_prefix(prefix)
    t1 = fleet.submit(prefix + [5, 1], max_new_tokens=4, prefix_id=pid)
    t2 = fleet.submit(prefix + [9, 3], max_new_tokens=4, prefix_id=pid)
    fleet.run()
    assert list(fleet.outcome(t1).tokens) == list(
        S.reference(prefix + [5, 1], 4))
    installed = sorted(fleet.prefix_store.lookup(pid).installed)
    _leaks(handlers)
    return dict(outs=[outcome_view(fleet.outcome(t)) for t in (t1, t2)],
                installed=installed, executed=_executed(handlers))


def test_shared_prefix_broadcast_crosses_the_wire(models):
    r = both(models, _prefix_across_wire)
    assert r["installed"] == ["replica-0", "replica-1"]


def _lost_response(S):
    plan = S.res.NetworkFaultPlan([S.res.NetworkFault(
        kind="drop_response", method="submit", call_idx=0)])
    fleet, handlers, _ = make_remote_fleet(S, 1, plan=plan)
    prompt = [4, 8, 15, 16, 23, 42]
    t = fleet.submit(prompt, max_new_tokens=6)
    fleet.run()
    assert list(fleet.outcome(t).tokens) == list(S.reference(prompt, 6))
    _leaks(handlers)
    return dict(out=outcome_view(fleet.outcome(t)),
                executed=_executed(handlers), replays=handlers[0].replays,
                injected=plan.injected_counts())


def test_lost_response_retries_replay_not_reexecute(models):
    r = both(models, _lost_response)
    assert r["executed"][0]["submit"] == 1 and r["replays"] == 1


def _pre_execution_faults(S):
    plan = S.res.NetworkFaultPlan([
        S.res.NetworkFault(kind="drop", method="submit", call_idx=0),
        S.res.NetworkFault(kind="http_500", method="submit", call_idx=1)])
    fleet, handlers, _ = make_remote_fleet(S, 1, plan=plan)
    t = fleet.submit([3, 1, 4, 1, 5], max_new_tokens=4)
    fleet.run()
    return dict(out=outcome_view(fleet.outcome(t)),
                executed=_executed(handlers), replays=handlers[0].replays,
                injected=plan.injected_counts())


def test_pre_execution_faults_retry_transparently(models):
    r = both(models, _pre_execution_faults)
    assert r["replays"] == 0 and r["injected"] == {"drop": 1,
                                                    "http_500": 1}


def _open_breaker(S):
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan()
    h = S.serve.EngineRpcHandler(S.engine())
    tr = S.serve.LoopbackTransport(h, target="replica-0", fault_plan=plan)
    rep = S.serve.RemoteReplica(
        "replica-0", tr, clock=clock, sleep=lambda s: None,
        policy=S.res.RetryPolicy(max_retries=0, base_delay_s=0.0),
        breaker_failure_threshold=3, breaker_reset_timeout_s=5.0)
    plan.partition("replica-0")
    for _ in range(3):
        with pytest.raises(S.serve.RpcTransportError):
            rep.client.stats()
    opened = (rep.breaker.state_code, rep.accepting)
    calls = tr.calls
    with pytest.raises(S.serve.RpcCircuitOpen):
        rep.client.stats()
    assert tr.calls == calls
    plan.heal()
    clock.advance(6.0)
    stats = rep.client.stats()
    return dict(opened=opened, closed=(rep.breaker.state_code,
                                       rep.accepting), stats=stats)


def test_open_breaker_fails_fast_and_recovers(models):
    r = both(models, _open_breaker)
    assert r["opened"] == (2, False) and r["closed"] == (0, True)


def _hedged_probe(S):
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan([S.res.NetworkFault(
        kind="delay", method="health", delay_s=2.0, call_idx=0)])
    h = S.serve.EngineRpcHandler(S.engine())
    tr = S.serve.LoopbackTransport(h, target="replica-0", fault_plan=plan)
    rep = S.serve.RemoteReplica("replica-0", tr, clock=clock,
                                sleep=lambda s: None, policy=_fast(S),
                                probe_timeout_s=0.5, probe_hedges=1)
    probes = [rep.probe(), rep.state, rep.probe()]
    plan.partition("replica-0")
    probes.append(rep.probe())
    return dict(probes=probes)


def test_hedged_probe_distinguishes_slow_from_dead(models):
    r = both(models, _hedged_probe)
    assert r["probes"] == ["slow", "live", "ok", "dead"]


def _mid_decode_partition(S):
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan()
    fleet, handlers, _ = make_remote_fleet(
        S, 2, clock=clock, plan=plan, probe_interval_s=1.0, max_retries=4)
    tickets = [fleet.submit([10 + i, 20 + i, 30 + i], max_new_tokens=4)
               for i in range(4)]
    fleet.step()
    to_0 = handlers[0].executed.get("submit", 0)
    plan.partition("replica-0")
    for _ in range(40):
        if not fleet.pending():
            break
        clock.advance(1.0)
        fleet.step()
    assert not fleet.pending()
    assert handlers[0].executed.get("submit", 0) == to_0
    _leaks(handlers)
    return dict(outs=[outcome_view(fleet.outcome(t)) for t in tickets],
                state=fleet.replicas[0].state, executed=_executed(handlers))


def test_mid_decode_partition_fails_over_exactly_once(models):
    r = both(models, _mid_decode_partition)
    assert r["state"] == "dead"
    assert all(o[0] == "Completed" and len(o[1]) == 4 for o in r["outs"])


def _partition_during_publish(S):
    fleet, handlers, _ = make_remote_fleet(S, 3)
    t0 = fleet.submit([1, 2, 3], max_new_tokens=3)
    fleet.run()
    plan = S.res.NetworkFaultPlan()
    fleet.replicas[1].engine.transport.fault_plan = plan
    plan.partition("replica-1")
    version = fleet.update_params(S.weights(2))
    t1 = fleet.submit([4, 5, 6], max_new_tokens=3)
    fleet.run()
    assert list(fleet.outcome(t1).tokens) == list(
        S.reference([4, 5, 6], 3, params=S.weights(2)))
    _leaks(handlers)
    return dict(version=version,
                states=[r.state for r in fleet.replicas],
                versions=[r.weight_version for r in fleet.replicas],
                outs=[outcome_view(fleet.outcome(t)) for t in (t0, t1)])


def test_partition_during_publish_quarantines_and_converges(models):
    r = both(models, _partition_during_publish)
    assert r["states"] == ["live", "dead", "live"]
    assert r["outs"][1][3] == 1


def _continuation_replay(S):
    fleet, handlers, _ = make_remote_fleet(S, 2)
    p1 = [5, 9, 2, 7, 1, 3]
    t1 = fleet.submit(p1, max_new_tokens=5, hold_slot=True)
    fleet.run()
    out1 = list(fleet.outcome(t1).tokens)
    holder = fleet._requests[t1].replica_id
    fleet.kill_replica(holder)
    full2 = p1 + out1 + [8, 4]
    t2 = fleet.submit(full2, max_new_tokens=5, continue_from=t1)
    fleet.run()
    out2 = fleet.outcome(t2)
    assert out2.replica_id != holder
    assert list(out2.tokens) == list(S.reference(full2, 5))
    _leaks(handlers)
    return dict(outs=[outcome_view(fleet.outcome(t)) for t in (t1, t2)],
                holder=holder)


def test_continuation_replays_on_survivor_after_holder_death(models):
    both(models, _continuation_replay)


def _continuation_no_survivor(S):
    fleet, _, _ = make_remote_fleet(S, 1)
    t1 = fleet.submit([1, 2, 3], max_new_tokens=3, hold_slot=True)
    fleet.run()
    fleet.kill_replica("replica-0")
    with pytest.raises(ValueError, match="no survivor"):
        fleet.submit([1, 2, 3, 9], max_new_tokens=3, continue_from=t1)
    return {}


def test_continuation_with_no_survivor_still_raises(models):
    both(models, _continuation_no_survivor)


def _resurrect(S):
    fleet, handlers, _ = make_remote_fleet(S, 2)
    prefix = [6, 6, 6, 2]
    pid = fleet.register_prefix(prefix)
    t0 = fleet.submit(prefix + [1], max_new_tokens=3, prefix_id=pid)
    fleet.run()
    with pytest.raises(ValueError, match="taken"):
        fleet.add_replica(S.engine(), replica_id="replica-0")
    fleet.kill_replica("replica-0")
    h = S.serve.EngineRpcHandler(S.engine())
    fresh = S.serve.RemoteReplica(
        "replica-0", S.serve.LoopbackTransport(h, target="replica-0"),
        policy=_fast(S), sleep=lambda s: None)
    fleet.add_replica(fresh, replica_id="replica-0")
    members = [[r is fresh for r in m if r.replica_id == "replica-0"]
               for m in (fleet.replicas, fleet.router.replicas,
                         fleet.publisher.replicas)]
    installed = sorted(fleet.prefix_store.lookup(pid).installed)
    t1 = fleet.submit(prefix + [3], max_new_tokens=3, prefix_id=pid)
    t2 = fleet.submit(prefix + [4], max_new_tokens=3, prefix_id=pid)
    fleet.run()
    _leaks(handlers + [h])
    return dict(members=members, installed=installed,
                outs=[outcome_view(fleet.outcome(t)) for t in (t0, t1, t2)])


def test_add_replica_resurrects_dead_id_cleanly(models):
    r = both(models, _resurrect)
    assert r["members"] == [[True]] * 3
    assert "replica-0" not in r["installed"]


def _epoch_without_version(S):
    h = S.serve.EngineRpcHandler(S.engine())
    rep = S.serve.RemoteReplica(
        "replica-0", S.serve.LoopbackTransport(h, target="replica-0"),
        policy=_fast(S), sleep=lambda s: None)
    with pytest.raises(ValueError, match="epoch requires version"):
        rep.client.update_params(S.params, epoch=3)
    before = h.executed.get("update_params", 0)
    rep.client.update_params(S.params, version=1, epoch=3)
    return dict(before=before, after=h.executed["update_params"])


def test_update_params_epoch_without_version_is_rejected(models):
    assert both(models, _epoch_without_version) == dict(before=0, after=1)


def _chaos_acceptance(S):
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan()
    fleet, handlers, _ = make_remote_fleet(
        S, 3, clock=clock, plan=plan, probe_interval_s=1.0, max_retries=6)
    held = fleet.submit([5, 9, 2, 7], max_new_tokens=4, hold_slot=True)
    load = [fleet.submit([11 + i, 22 + i, 33 + i], max_new_tokens=4)
            for i in range(5)]
    fleet.step()
    holder = fleet._requests[held].replica_id
    plan.partition(holder)
    for _ in range(60):
        if not fleet.pending():
            break
        clock.advance(1.0)
        fleet.step()
    first = [outcome_view(fleet.outcome(t)) for t in [held] + load]
    plan.partition("replica-1")
    version = fleet.update_params(S.weights(3))
    full2 = [5, 9, 2, 7] + first[0][1] + [6, 1]
    t2 = fleet.submit(full2, max_new_tokens=4, continue_from=held)
    for _ in range(60):
        if not fleet.pending():
            break
        clock.advance(1.0)
        fleet.step()
    assert list(fleet.outcome(t2).tokens) == list(
        S.reference(full2, 4, params=S.weights(3)))
    plan.heal()
    _leaks(handlers)
    return dict(holder=holder, first=first, version=version,
                out2=outcome_view(fleet.outcome(t2)),
                live=[r.replica_id for r in fleet.replicas
                      if r.state != "dead"],
                counts=(len(fleet._outcomes), len(fleet._requests)),
                injected=plan.injected_counts())


def test_chaos_acceptance_no_request_lost_or_doubled(models):
    r = both(models, _chaos_acceptance)
    assert r["holder"] == "replica-0" and r["live"] == ["replica-2"]
    assert r["counts"] == (7, 7)


def test_threaded_remote_fleet_lock_order_acyclic(models):
    """Threaded remote serving with a partition mid-traffic and every
    port lock under the recorder: every ticket resolves and the lock
    graph is acyclic (the JAX test's invariants; threads make the exact
    outcomes differ run to run)."""
    S = Side("port", models)
    S.obs._reset_for_tests()
    rec = LockOrderRecorder(scope="senweaver_ide_tpu_torch")
    with rec:
        plan = S.res.NetworkFaultPlan()
        handlers = [S.serve.EngineRpcHandler(S.engine(num_slots=2))
                    for _ in range(2)]
        replicas = [S.serve.RemoteReplica(
            f"replica-{i}", S.serve.LoopbackTransport(
                h, target=f"replica-{i}", fault_plan=plan),
            policy=_fast(S), sleep=lambda s: None)
            for i, h in enumerate(handlers)]
        fleet = S.serve.ServingFleet(replicas, retry_base_delay_s=0.0,
                                     max_retries=4, probe_interval_s=0.05)
        fleet.start()
        try:
            tickets, lock = [], threading.Lock()

            def submitter(seed):
                for i in range(6):
                    t = fleet.submit([seed + i, seed + i + 1, 3],
                                     max_new_tokens=4)
                    with lock:
                        tickets.append(t)
                    time.sleep(0.002)

            subs = [threading.Thread(target=submitter, args=(s,))
                    for s in (10, 40)]
            for th in subs:
                th.start()
            time.sleep(0.03)
            plan.partition("replica-0")
            for th in subs:
                th.join()
            deadline = time.monotonic() + 120.0
            while fleet.pending():
                assert time.monotonic() < deadline, "fleet did not drain"
                time.sleep(0.01)
        finally:
            fleet.stop()
        assert len(tickets) == 12
        assert all(fleet.is_done(t) for t in tickets)
    rec.assert_acyclic()
    S.obs._reset_for_tests()


def _http_end_to_end(S):
    server, port = S.serve.serve_engine_http(S.engine())
    try:
        rep = S.serve.RemoteReplica(
            "replica-0", S.serve.HttpTransport(
                f"http://127.0.0.1:{port}", timeout_s=30.0,
                target="replica-0"),
            policy=S.res.RetryPolicy(max_retries=1, base_delay_s=0.01))
        fleet = S.serve.ServingFleet([rep])
        t = fleet.submit(PROMPT, max_new_tokens=6)
        fleet.run()
        assert list(fleet.outcome(t).tokens) == list(
            S.reference(PROMPT, 6))
        version = fleet.update_params(S.weights(2))
        t2 = fleet.submit(PROMPT, max_new_tokens=6)
        fleet.run()
        assert list(fleet.outcome(t2).tokens) == list(
            S.reference(PROMPT, 6, params=S.weights(2)))
        # a shared prefix crosses the socket both ways
        pid = fleet.register_prefix(PROMPT)
        t3 = fleet.submit(PROMPT + [4], max_new_tokens=4, prefix_id=pid)
        fleet.run()
        return dict(outs=[outcome_view(fleet.outcome(x))
                          for x in (t, t2, t3)],
                    version=(version, rep.weight_version),
                    num_slots=rep.client.num_slots,
                    stats=rep.client.stats())
    finally:
        server.shutdown()
        server.server_close()


def test_http_transport_end_to_end(models):
    """One replica across a real loopback socket: submit, decode, a
    weight publish (the whole fp32 tree as ``__nd__`` frames, placed on
    the remote engine's device), a prefix, stats and the meta call."""
    r = both(models, _http_end_to_end)
    assert r["version"] == (1, 1) and r["num_slots"] == 2


# ---- live migration across the wire ---------------------------------------

def _migrate_setup(S, clock, plan=None):
    handlers, replicas = [], []
    for i in range(2):
        h = S.serve.EngineRpcHandler(S.engine(num_slots=4))
        replicas.append(S.serve.RemoteReplica(
            f"replica-{i}", S.serve.LoopbackTransport(
                h, target=f"replica-{i}", fault_plan=plan,
                wire_codec=True),
            policy=_fast(S), clock=clock, sleep=lambda s: None))
        handlers.append(h)
    fleet = S.serve.ServingFleet(replicas, clock=clock,
                                 retry_base_delay_s=0.0,
                                 probe_interval_s=0.5)
    mig = fleet.attach_migration()
    t = fleet.submit(PROMPT, max_new_tokens=12)
    for _ in range(4):
        fleet.step()
    req = fleet._requests[t]
    source = fleet._replica_by_id(req.replica_id)
    target = next(r for r in fleet.replicas if r is not source)
    return fleet, handlers, mig, t, req, source, target


def _run_clock(fleet, clock, max_steps=400):
    for _ in range(max_steps):
        if not fleet.pending():
            return
        clock.advance(1.0)
        fleet.step()
    raise AssertionError("fleet did not converge")


def _migrations(S, reason, outcome):
    m = S.obs.get_registry().get("senweaver_serve_migrations_total")
    return 0.0 if m is None else m.value(reason=reason, outcome=outcome)


def _migrate_over_wire(S, race):
    ref = S.reference(PROMPT, 12)
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan(
        [S.res.NetworkFault(kind="drop", method="restore_checkpoint",
                            times=99)] if race == "target_dies" else
        [S.res.NetworkFault(kind="drop_response",
                            method="checkpoint_request", call_idx=0)]
        if race == "checkpoint_retry" else [])
    fleet, handlers, mig, t, req, source, target = _migrate_setup(
        S, clock, plan)
    src_h = handlers[int(source.replica_id.split("-")[1])]
    out = {}
    if race == "checkpoint_retry":
        ckpt = source.engine.checkpoint_request(req.engine_rid)
        out["ckpt_kv"] = list(np.shape(ckpt.kv_k))
        source.engine.resume_request(req.engine_rid)
    else:
        out["moved"] = mig.migrate(req, source, target, reason="test",
                                   now=clock())
        if race == "source_dies":
            fleet.kill_replica(source.replica_id)
        elif race == "partition_ack":
            plan.partition(target.replica_id)
    _run_clock(fleet, clock)
    plan.heal()
    assert list(fleet.outcome(t).tokens) == list(ref)
    _leaks(handlers)
    out.update(out_t=outcome_view(fleet.outcome(t)),
               executed=_executed(handlers), src_replays=src_h.replays,
               pending=len(mig.pending),
               where=fleet.outcome(t).replica_id == source.replica_id,
               outcomes={o: _migrations(S, "test", o) for o in (
                   "completed", "install_abort", "rescued")})
    return out


@pytest.mark.parametrize("race", ["clean", "target_dies", "source_dies",
                                  "partition_ack", "checkpoint_retry"])
def test_migration_across_the_wire(models, race):
    """A decode moved between two remote replicas through the codec:
    checkpoint out (its KV as raw bf16 bits or fp32 frames), restore on
    the target, the source released on the first token after; and the
    races of tests/test_migration.py: the target's install dropped, the
    source dead after the handoff, the target partitioned before its
    ack, a lost checkpoint response replayed from the cache."""
    r = both(models, _migrate_over_wire, race)
    want = {"clean": (True, "completed"), "target_dies": (False,
                                                          "install_abort"),
            "source_dies": (True, "completed"),
            "partition_ack": (True, "rescued")}
    if race in want:
        moved, outcome = want[race]
        assert r["moved"] is moved and r["outcomes"][outcome] == 1
    else:
        assert r["src_replays"] >= 1


def test_jax_checkpoint_restores_on_a_port_engine_through_the_codec():
    """A decode on a bf16 model checkpointed by a JAX engine crosses the
    wire (its KV as ``bfloat16`` frames), decodes in the port as bf16
    host tensors, and restores token-exactly on a port engine's bf16
    pool behind the remote handler: the restore path takes a tensor
    payload as well as raw bits."""
    import dataclasses
    from senweaver_ide_tpu.models import init_params as jinit
    from senweaver_ide_tpu.models import tiny_test as jtiny
    from senweaver_ide_tpu_torch.models import params_from_numpy, tiny_test
    m = Models()
    m.jcfg = dataclasses.replace(jtiny(), dtype=jnp.bfloat16)
    m.tcfg = dataclasses.replace(tiny_test(), dtype=torch.bfloat16)
    jt = jinit(m.jcfg, jax.random.PRNGKey(0))
    m._by_seed[0] = (jt, params_from_numpy(jax.device_get(jt),
                                           device="cpu"))
    J, T = Side("jax", m), Side("port", m)
    ref = J.reference(PROMPT, 12)
    src = J.engine()
    rid = src.submit(PROMPT, max_new_tokens=12)
    for _ in range(4):
        src.step()
    ckpt = src.checkpoint_request(rid)
    assert ckpt.kv_k.dtype == ml_dtypes.bfloat16
    wire = json.loads(json.dumps(jrpc.encode(ckpt.to_wire())))
    assert wire["__d__"]["kv_k"]["__nd__"]["dtype"] == "bfloat16"
    decoded = trpc.decode(wire)
    assert decoded["kv_k"].dtype == torch.bfloat16
    h = T.serve.EngineRpcHandler(T.engine())
    new_rid = h.handle("restore_checkpoint", {"ckpt": decoded},
                       request_id="m1")
    assert h.engine.run()[new_rid] == list(ref)
    assert h.engine.stats()["migrations_in"] == 1
    check_leaks_all(None, [h.engine])


def _second_fleet_on_one_host(S):
    """Two fleets, one after the other, dispatch to the same long-lived
    engine host (one EngineRpcHandler and its idempotency cache), each
    through its own RemoteReplica client; each fleet is pumped for at
    most 50 ticks."""
    h = S.serve.EngineRpcHandler(S.engine())
    prompts = ([5, 9, 2, 7, 1, 3], [8, 8, 1, 4])
    outs, pending = [], []
    for prompt in prompts:
        rep = S.serve.RemoteReplica(
            "remote", S.serve.LoopbackTransport(h, target="remote"),
            policy=_fast(S), sleep=lambda s: None)
        fleet = S.serve.ServingFleet([rep], retry_base_delay_s=0.0)
        t = fleet.submit(prompt, max_new_tokens=6)
        for _ in range(50):
            if not fleet.pending():
                break
            fleet.step()
        pending.append(fleet.pending())
        outs.append(outcome_view(fleet.outcome(t)))
    return dict(outs=outs, pending=pending,
                executed=h.executed.get("submit", 0), replays=h.replays,
                refs=[list(S.reference(p, 6)) for p in prompts])


def test_a_second_fleet_never_gets_a_replayed_submit():
    """Fault found here, repaired in the port: the fleet keys a remote
    submit ``ticket-N-aM`` and the client sends that key as the request
    id, so a second fleet (a restarted fleet process, or a learner's
    fleet attaching to a serving host) reuses ticket 0's key on the same
    host. JAX's host replays the first fleet's cached rid: the second
    request never executes and its ticket never resolves (still pending
    after 50 ticks). The port's client puts its own nonce in every
    request id: each submit executes and completes with its own
    stream."""
    models = Models()
    j = _second_fleet_on_one_host(Side("jax", models))
    t = _second_fleet_on_one_host(Side("port", models))
    assert (j["executed"], j["replays"], j["pending"]) == (1, 1, [0, 1])
    assert j["outs"][1] is None
    assert (t["executed"], t["replays"], t["pending"]) == (2, 0, [0, 0])
    assert [o[1] for o in t["outs"]] == t["refs"]
