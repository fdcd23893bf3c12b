"""The port's serving fleet (``senweaver_ide_tpu_torch/serve/``) against
the JAX package's, scenario by scenario.

Every scenario of tests/test_serve.py and tests/test_prefix_store.py, the
fleet cases of tests/test_fleet_obs.py, the chaos cases of
tests/test_resilience.py and a ``MemoryPressurePlan`` squeeze is written
once and run on both packages (``torch_fleet_sides.both``): the same
outcomes (tokens, weight versions, attempts, rejection reasons), engine
stats, metric names and serving counters, and leak-free pools on each
side. Then what only the port has to prove, because its tensors are
mutable where JAX arrays are not: a trainer step taken in place during a
rolling publish leaves the replicas still to be swapped on the published
snapshot, bit for bit; and a donor's prefix blocks are untouched by a
peer's decode.
"""

import threading
import time

import pytest
import torch

from senweaver_ide_tpu_torch.analysis.lock_order import LockOrderRecorder
from senweaver_ide_tpu_torch.agents.llm import ChatMessage
from senweaver_ide_tpu_torch.models.tokenizer import ByteTokenizer
from torch_fleet_sides import (FakeClock, Models, both, bump_in_place,
                               check_leaks_all, engine_stats,
                               one_torch_thread, outcome_view, trees_equal)

PREFIX = [5, 9, 2, 7, 4, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def models():
    return Models()


def _outcomes(fleet, tickets):
    return [outcome_view(fleet.outcome(t)) for t in tickets]


# ---- drop-in parity and admission (tests/test_serve.py) -------------------

def _matches_single_engine(S):
    prompt = [5, 9, 2, 7, 1, 3]
    ref = S.reference(prompt, 10)
    fleet = S.serve.ServingFleet([S.engine()])
    t = fleet.submit(prompt, max_new_tokens=10)
    streamed = list(fleet.stream(t))
    assert streamed == list(ref) == list(fleet.result(t))
    out = fleet.outcome(t)
    assert isinstance(out, S.serve.Completed) and fleet.is_done(t)
    check_leaks_all(fleet)
    return dict(out=outcome_view(out), stats=fleet.stats())


def test_fleet_matches_single_engine(models):
    both(models, _matches_single_engine)


def _spreads_load(S):
    fleet = S.serve.ServingFleet([S.engine(num_slots=1),
                                  S.engine(num_slots=1)])
    tickets = [fleet.submit([i + 1, i + 2, i + 3], max_new_tokens=6)
               for i in range(4)]
    fleet.step()
    used = sorted({fleet._requests[t].replica_id for t in tickets
                   if fleet._requests[t].replica_id is not None})
    fleet.run()
    check_leaks_all(fleet)
    return dict(used=used, outs=_outcomes(fleet, tickets))


def test_fleet_spreads_load_across_replicas(models):
    r = both(models, _spreads_load)
    assert len(r["used"]) == 2
    assert all(o[0] == "Completed" for o in r["outs"])


def _priority_deadline(S):
    clock = FakeClock()
    fleet = S.serve.ServingFleet(
        [S.engine(num_slots=1)],
        admission=S.serve.AdmissionConfig(
            interactive=S.serve.ClassPolicy(max_queue=4),
            train_rollout=S.serve.ClassPolicy(max_queue=3)),
        clock=clock)
    t_run = fleet.submit([1, 2, 3], max_new_tokens=3)
    fleet.step()
    t_expire = fleet.submit([2, 3, 4], max_new_tokens=3, deadline_s=0.5)
    t_wait1 = fleet.submit([3, 4, 5], max_new_tokens=3)
    t_wait2 = fleet.submit([4, 5, 6], max_new_tokens=3)
    t_full = fleet.submit([5, 6, 7], max_new_tokens=3)
    t_inter = fleet.submit([6, 7, 8], max_new_tokens=3,
                           priority=S.serve.INTERACTIVE, deadline_s=30.0)
    with pytest.raises(S.serve.RequestRejected):
        fleet.result(t_full)
    clock.advance(1.0)
    while fleet.pending():
        fleet.step()
        clock.advance(0.01)
    inter, w1, w2 = (fleet._requests[t] for t in (t_inter, t_wait1,
                                                   t_wait2))
    assert inter.dispatched_at < min(w1.dispatched_at, w2.dispatched_at)
    assert inter.dispatched_at < inter.deadline
    depth = S.obs.get_registry().get(
        "senweaver_serve_queue_depth").samples()
    check_leaks_all(fleet)
    return dict(outs=_outcomes(fleet, [t_run, t_expire, t_wait1, t_wait2,
                                       t_full, t_inter]),
                dispatched=[fleet._requests[t].dispatched_at
                            for t in (t_run, t_wait1, t_wait2, t_inter)],
                depth=dict(depth), stats=fleet.stats())


def test_priority_deadline_semantics_fake_clock(models):
    r = both(models, _priority_deadline)
    reasons = [o[1] for o in r["outs"] if o[0] == "Rejected"]
    assert reasons == ["deadline", "queue_full"]


def _rate_limit(S):
    clock = FakeClock()
    fleet = S.serve.ServingFleet(
        [S.engine()],
        admission=S.serve.AdmissionConfig(
            interactive=S.serve.ClassPolicy(rate=1.0, burst=1.0)),
        clock=clock)
    inter = S.serve.INTERACTIVE
    t1 = fleet.submit([1, 2, 3], max_new_tokens=2, priority=inter)
    t2 = fleet.submit([1, 2, 4], max_new_tokens=2, priority=inter)
    clock.advance(1.0)
    t3 = fleet.submit([1, 2, 5], max_new_tokens=2, priority=inter)
    fleet.run()
    return dict(outs=_outcomes(fleet, [t1, t2, t3]))


def test_rate_limit_sheds_typed(models):
    r = both(models, _rate_limit)
    assert r["outs"][1] == ("Rejected", "rate_limited")


# ---- failover and rolling publication -------------------------------------

def _failover_midstream(S):
    tok = ByteTokenizer()
    msgs = [ChatMessage("system", "You are a terse helper."),
            ChatMessage("user", "say hi")]
    ref = S.PolicyClient(S.engine(max_len=512), tok,
                         default_max_new_tokens=8,
                         auto_prefix=True).chat(msgs)
    fleet = S.serve.ServingFleet([S.engine(max_len=512) for _ in range(2)],
                                 retry_base_delay_s=0.0)
    client = S.PolicyClient(fleet, tok, default_max_new_tokens=8,
                            auto_prefix=True)
    killed = []

    def on_text(_chunk):
        if killed:
            return
        pending = [t for t in fleet._requests if t not in fleet._outcomes]
        rep = fleet._requests[pending[0]].replica_id
        fleet.kill_replica(rep)
        killed.append(rep)

    resp = client.chat(msgs, on_text=on_text)
    assert killed and resp.text == ref.text
    fleet.update_params(S.weights(1))
    resp2 = client.chat(msgs)
    last = max(fleet._requests)
    return dict(text=resp.text, text2=resp2.text, killed=killed,
                last=outcome_view(fleet.outcome(last)),
                outs=[outcome_view(o) for o in fleet._outcomes.values()])


def test_failover_midstream(models):
    r = both(models, _failover_midstream)
    assert r["last"][2:4] == (1, 1)


def _last_replica_death(S):
    fleet = S.serve.ServingFleet([S.engine(num_slots=1)])
    t1 = fleet.submit([1, 2, 3], max_new_tokens=8)
    t2 = fleet.submit([4, 5, 6], max_new_tokens=8)
    fleet.step()
    fleet.kill_replica("replica-0")
    assert fleet.is_done(t1) and fleet.is_done(t2)
    check_leaks_all(fleet)
    return dict(outs=_outcomes(fleet, [t1, t2]))


def test_last_replica_death_sheds_everything_typed(models):
    r = both(models, _last_replica_death)
    assert r["outs"] == [("Rejected", "no_replicas")] * 2


def _rolling_publish(S):
    fleet = S.serve.ServingFleet([S.engine(num_slots=1),
                                  S.engine(num_slots=1)])
    t1 = fleet.submit([1, 2, 3], max_new_tokens=10)
    t2 = fleet.submit([4, 5, 6], max_new_tokens=10)
    fleet.step()
    version = fleet.publisher.begin(S.weights(1))
    skews = []
    while fleet.publisher.in_progress or fleet.pending():
        fleet.step()
        skews.append(fleet.publisher.skew())
    t3 = fleet.submit([7, 8, 9], max_new_tokens=4)
    fleet.run()
    # the post-roll stream is the new weights' stream
    assert list(fleet.outcome(t3).tokens) == list(
        S.reference([7, 8, 9], 4, params=S.weights(1)))
    check_leaks_all(fleet)
    return dict(version=version, skews=skews,
                outs=_outcomes(fleet, [t1, t2, t3]), stats=fleet.stats())


def test_rolling_publish_skew_visible_and_no_mixing(models):
    r = both(models, _rolling_publish)
    assert 1 in r["skews"] and r["skews"][-1] == 0
    assert [o[2:4] for o in r["outs"]] == [(0, 0), (0, 0), (1, 1)]


def _chaos_acceptance(S):
    fleet = S.serve.ServingFleet(
        [S.engine(num_slots=2) for _ in range(3)],
        admission=S.serve.AdmissionConfig(
            interactive=S.serve.ClassPolicy(max_queue=8),
            train_rollout=S.serve.ClassPolicy(max_queue=4)),
        retry_base_delay_s=0.0)
    tickets = [fleet.submit([i + 1, i + 2, i + 3, i + 4], max_new_tokens=6)
               for i in range(10)]
    tickets += [fleet.submit([i + 2, i + 5, i + 7], max_new_tokens=4,
                             priority=S.serve.INTERACTIVE,
                             deadline_s=60.0) for i in range(4)]
    fleet.step()
    fleet.step()
    victim = next(r for r in fleet.replicas if r.outstanding > 0)
    fleet.kill_replica(victim.replica_id)
    fleet.publisher.begin(S.weights(1))
    tickets += [fleet.submit([i + 3, i + 1, i + 9], max_new_tokens=4)
                for i in range(4)]
    steps = 0
    while fleet.pending() or fleet.publisher.in_progress:
        fleet.step()
        steps += 1
        assert steps < 2000
    outs = _outcomes(fleet, tickets)
    assert all(o is not None for o in outs)
    for o in outs:
        if o[0] == "Completed":
            assert o[2] == o[3]            # no version mixing
    check_leaks_all(fleet)
    return dict(victim=victim.replica_id, outs=outs, steps=steps,
                live={r.replica_id: r.weight_version
                      for r in fleet.replicas if r.state != "dead"},
                stats=fleet.stats())


def test_chaos_acceptance_overload_death_and_publish(models):
    r = both(models, _chaos_acceptance)
    assert any(o == ("Rejected", "queue_full") for o in r["outs"])
    assert set(r["live"].values()) == {1} and len(r["live"]) == 2


def test_threaded_fleet_stress_chaos_lock_order_clean(models):
    """``fleet.start()`` with stepper threads, two submitters, a kill and
    a publish mid-run, every port lock under the lock-order recorder:
    none lost, no version mixing, an acyclic lock graph. Threads make
    the interleaving differ run to run, so this holds the port to the
    JAX test's invariants rather than to JAX's exact outcomes."""
    from torch_fleet_sides import Side
    S = Side("port", models)
    S.obs._reset_for_tests()
    rec = LockOrderRecorder(scope="senweaver_ide_tpu_torch")
    with rec:
        fleet = S.serve.ServingFleet(
            [S.engine(num_slots=2) for _ in range(3)],
            admission=S.serve.AdmissionConfig(
                interactive=S.serve.ClassPolicy(max_queue=16),
                train_rollout=S.serve.ClassPolicy(max_queue=16)),
            retry_base_delay_s=0.0)
        fleet.start()
        try:
            tickets, lock = [], threading.Lock()

            def submitter(seed):
                for i in range(8):
                    t = fleet.submit(
                        [seed + i + 1, seed + i + 2, i + 3],
                        max_new_tokens=4,
                        priority=(S.serve.INTERACTIVE if i % 3 == 0
                                  else S.serve.TRAIN_ROLLOUT))
                    with lock:
                        tickets.append(t)
                    time.sleep(0.002)

            subs = [threading.Thread(target=submitter, args=(s,))
                    for s in (10, 40)]
            for t in subs:
                t.start()
            time.sleep(0.05)
            fleet.kill_replica(fleet.replicas[0].replica_id)
            fleet.publisher.begin(S.weights(2))
            for t in subs:
                t.join()
            deadline = time.monotonic() + 120.0
            while fleet.pending() or fleet.publisher.in_progress:
                assert time.monotonic() < deadline, "fleet failed to drain"
                time.sleep(0.01)
        finally:
            fleet.stop()
    assert len(set(tickets)) == 16
    outs = [fleet.outcome(t) for t in tickets]
    assert all(o is not None for o in outs)
    done = [o for o in outs if isinstance(o, S.serve.Completed)]
    assert done
    assert all(o.weight_version == o.weight_version_at_finish
               for o in done)
    assert {r.weight_version for r in fleet.replicas
            if r.state != "dead"} == {1}
    assert rec.order_pairs()
    rec.assert_acyclic()
    S.obs._reset_for_tests()


# ---- the shared prefix store (tests/test_prefix_store.py) -----------------

def _import_token_exact(S):
    donor = S.engine()
    tokens, kv, last = donor.export_prefix(donor.register_prefix(PREFIX))
    ref_suffix = S.reference(PREFIX + [1, 3], 8)
    ref_exact = S.reference(PREFIX, 8)
    got = []
    for last_arg in (last, None):
        eng = S.engine()
        ipid = eng.import_prefix(tokens, kv, last_arg)
        r1 = eng.submit(PREFIX + [1, 3], max_new_tokens=8, prefix_id=ipid)
        r2 = eng.submit(list(PREFIX), max_new_tokens=8, prefix_id=ipid)
        out = eng.run()
        assert out[r1] == ref_suffix and out[r2] == ref_exact
        got.append((out[r1], out[r2]))
    stats = eng.stats()
    check_leaks_all(None, [eng, donor])
    return dict(got=got, stats=stats, stats_donor=donor.stats())


def test_import_prefix_token_exact(models):
    r = both(models, _import_token_exact)
    assert r["stats"]["prefix_imports"] == 1
    assert r["stats"]["prefix_prefills"] == 0


def _import_typed_errors(S):
    donor = S.engine(max_len=64)
    _, kv, last = donor.export_prefix(donor.register_prefix(PREFIX))
    errors = []
    with pytest.raises(ValueError) as e:
        S.engine(max_len=32).import_prefix(PREFIX, kv, last)
    errors.append(type(e.value).__name__)
    eng = S.engine(max_len=64)
    if S.is_jax:
        import jax.numpy as jnp
        bad = kv._replace(k=kv.k.astype(jnp.bfloat16),
                          v=kv.v.astype(jnp.bfloat16))
    else:
        bad = kv._replace(k=kv.k.to(torch.bfloat16),
                          v=kv.v.to(torch.bfloat16))
    for args in ((PREFIX, bad, last), (PREFIX[:2], kv, last)):
        with pytest.raises(ValueError) as e:
            eng.import_prefix(*args)
        errors.append(type(e.value).__name__)
    pid1 = eng.import_prefix(PREFIX, kv, last)
    pid2 = eng.import_prefix(PREFIX, kv, last)
    stats = eng.stats()
    check_leaks_all(None, [eng])
    return dict(errors=errors, same=pid1 == pid2, stats=stats)


def test_import_prefix_typed_errors(models):
    r = both(models, _import_typed_errors)
    assert r["errors"] == ["PrefixImportError"] * 3 and r["same"]


def _import_lru(S):
    donor = S.engine(max_prefixes=4)
    exports = [donor.export_prefix(donor.register_prefix(PREFIX + [10 + i]))
               for i in range(3)]
    eng = S.engine(max_prefixes=2)
    pids = [eng.import_prefix(t, kv, last) for t, kv, last in exports]
    with pytest.raises(KeyError):
        eng.submit(PREFIX + [10, 1], max_new_tokens=2, prefix_id=pids[0])
    r = eng.submit(PREFIX + [12, 1], max_new_tokens=2, prefix_id=pids[2])
    out = eng.run()[r]
    return dict(out=out, stats=eng.stats())


def test_import_prefix_lru_accounting(models):
    r = both(models, _import_lru)
    assert r["stats"]["prefix_evictions"] == 1


def _broadcast_all(S):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(4)])
    pid = fleet.register_prefix(PREFIX)
    tickets = [fleet.submit(PREFIX + [i + 1], max_new_tokens=6,
                            prefix_id=pid) for i in range(8)]
    fleet.run()
    single = S.engine()
    rid = single.submit(PREFIX + [1], max_new_tokens=6,
                        prefix_id=single.register_prefix(PREFIX))
    assert list(fleet.outcome(tickets[0]).tokens) == single.run()[rid]
    snap = fleet.snapshot_event()
    check_leaks_all(fleet)
    return dict(outs=_outcomes(fleet, tickets),
                prefills=engine_stats(fleet, "prefix_prefills"),
                imports=engine_stats(fleet, "prefix_imports"),
                avoided=snap["prefix_prefills_avoided"],
                installs=snap["prefix_install_count"],
                stats_store=fleet.prefix_store.stats())


def test_one_prefill_broadcast_to_all(models):
    r = both(models, _broadcast_all)
    assert (r["prefills"], r["imports"], r["avoided"]) == (1, 3, 3)


def _prefix_chaos(S):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(4)])
    pid = fleet.register_prefix(PREFIX)
    t0 = fleet.submit(PREFIX + [1], max_new_tokens=4, prefix_id=pid)
    fleet.run()
    donor_id = fleet.prefix_store.lookup(pid).donor_id
    fleet.kill_replica(donor_id)
    tickets = [fleet.submit(PREFIX + [i + 2], max_new_tokens=4,
                            prefix_id=pid) for i in range(4)]
    fleet.run()
    after_kill = (engine_stats(fleet, "prefix_prefills"),
                  engine_stats(fleet, "prefix_cache_hits"))
    fleet.update_params(S.params)
    with pytest.raises(KeyError):
        fleet.submit(PREFIX + [1], max_new_tokens=4, prefix_id=pid)
    pid2 = fleet.register_prefix(PREFIX)
    t2 = fleet.submit(PREFIX + [9], max_new_tokens=4, prefix_id=pid2)
    fleet.run()
    newcomer = fleet.add_replica(S.engine())
    for r in fleet.replicas:
        if r.replica_id != newcomer.replica_id and r.state != "dead":
            fleet.kill_replica(r.replica_id)
    t3 = fleet.submit(PREFIX + [11], max_new_tokens=4, prefix_id=pid2)
    fleet.run()
    check_leaks_all(fleet)
    return dict(donor=donor_id, after_kill=after_kill,
                outs=_outcomes(fleet, [t0] + tickets + [t2, t3]),
                stats_new=newcomer.engine.stats())


def test_shared_prefix_chaos(models):
    r = both(models, _prefix_chaos)
    assert r["after_kill"][0] == 0 and r["after_kill"][1] >= 4
    assert r["stats_new"]["prefix_imports"] == 1
    assert r["stats_new"]["prefix_prefills"] == 0


def _dedup_indexed(S):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(2)])
    pid = fleet.register_prefix(PREFIX)
    same = (fleet.register_prefix(PREFIX), fleet.register_prefix(
        list(PREFIX)))
    other = fleet.register_prefix(PREFIX + [1])
    keys = sorted(fleet.prefix_store._by_key)
    fleet.update_params(S.params)
    return dict(pid=pid, same=same, other=other, keys=keys,
                after=fleet.register_prefix(PREFIX),
                stats_store=fleet.prefix_store.stats())


def test_register_prefix_dedup_is_indexed(models):
    r = both(models, _dedup_indexed)
    assert r["same"] == (r["pid"], r["pid"]) and r["after"] != r["pid"]


def _broadcast_failure(S):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(2)])
    fleet.replicas[1].engine = S.engine(max_len=32)
    pid = fleet.register_prefix(PREFIX)
    tickets = [fleet.submit(PREFIX + [i + 1], max_new_tokens=4,
                            prefix_id=pid) for i in range(4)]
    fleet.run()
    return dict(outs=_outcomes(fleet, tickets),
                failed=fleet.prefix_store.lookup(pid).failed,
                imports=engine_stats(fleet, "prefix_imports"))


def test_broadcast_failure_degrades_to_lazy(models):
    r = both(models, _broadcast_failure)
    assert r["failed"] and r["imports"] == 0


def _broadcast_disabled(S):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(2)],
                                 shared_prefix_broadcast=False)
    pid = fleet.register_prefix(PREFIX)
    tickets = [fleet.submit(PREFIX + [i + 1], max_new_tokens=4,
                            prefix_id=pid) for i in range(4)]
    fleet.run()
    return dict(outs=_outcomes(fleet, tickets),
                imports=engine_stats(fleet, "prefix_imports"))


def test_broadcast_can_be_disabled(models):
    assert both(models, _broadcast_disabled)["imports"] == 0


class _StubReplica:
    def __init__(self, rid, decode_tokens, count, warm=False):
        self.replica_id = rid
        self.outstanding_decode_tokens = decode_tokens
        self.outstanding = count
        self.accepting = True
        self._warm = warm

    def holds_prefix(self, key):
        return self._warm


def _router_and_edf(S):
    from importlib import import_module
    adm = import_module(S.serve.__name__ + ".admission")
    Router = S.serve.Router
    req = adm.FleetRequest(ticket=0, prompt=[1], max_new_tokens=4)
    picks = [
        Router([_StubReplica("fresh", 500, 1), _StubReplica(
            "draining", 6, 3)]).pick(req).replica_id,
        Router([_StubReplica("a", 10, 2), _StubReplica(
            "b", 10, 1)]).pick(req).replica_id,
        Router([_StubReplica("warm", 500, 2, warm=True), _StubReplica(
            "cold", 0, 0)]).pick(adm.FleetRequest(
                ticket=1, prompt=list(PREFIX) + [1], max_new_tokens=4,
                prefix_tokens=list(PREFIX))).replica_id]
    q = S.serve.AdmissionQueue(S.serve.AdmissionConfig(), now=0.0)

    def push(ticket, priority=S.serve.TRAIN_ROLLOUT, deadline=None):
        r = adm.FleetRequest(ticket=ticket, prompt=[1], max_new_tokens=4,
                             priority=priority, deadline=deadline,
                             submitted_at=0.0)
        assert q.offer(r, 0.0) is None
        return r

    for ticket, dl in ((0, 30.0), (1, None), (2, 10.0), (3, 20.0),
                       (4, None)):
        push(ticket, deadline=dl)
    order = []
    while True:
        picked, sheds = q.pop_ready(1.0)
        if picked is None:
            break
        order.append(picked.ticket)
    push(5, deadline=5.0)
    push(6, priority=S.serve.INTERACTIVE, deadline=50.0)
    r7 = push(7, deadline=300.0)
    r7.not_before = 100.0
    push(8, deadline=9.0)
    order += [q.pop_ready(t)[0].ticket for t in (1.0, 1.0, 1.0, 150.0)]
    return dict(picks=picks, order=order)


def test_router_and_edf_order(models):
    r = both(models, _router_and_edf, metrics=False)
    assert r["picks"] == ["draining", "b", "warm"]
    assert r["order"] == [2, 3, 0, 1, 4, 6, 5, 8, 7]


def _replica_tracks_decode_tokens(S):
    fleet = S.serve.ServingFleet([S.engine(num_slots=2)])
    rep = fleet.replicas[0]
    fleet.submit([1, 2, 3], max_new_tokens=8)
    fleet.submit([4, 5, 6], max_new_tokens=5)
    seen = []
    while fleet.pending():
        fleet.step()
        seen.append(rep.outstanding_decode_tokens)
    return dict(seen=seen)


def test_replica_tracks_remaining_decode_tokens(models):
    r = both(models, _replica_tracks_decode_tokens)
    assert r["seen"][-1] == 0


# ---- fleet observability (tests/test_fleet_obs.py) ------------------------

def _retried_scrape(S):
    from importlib import import_module
    rs = import_module(S.serve.__name__ + ".remote_server")

    class H(S.obs.MetricsScrapeMixin, rs.RpcHandlerBase):
        mutating_methods = frozenset({"scrape"})

    clock = FakeClock(0.0)
    reg = S.obs.MetricsRegistry()
    h = H()
    h.scrape_registry = reg
    h.scrape_journal = S.obs.EventJournal(clock=clock)
    h.scrape_clock = clock
    c = reg.counter("c", "")
    c.inc(1)
    h.handle("scrape", {"scraper_id": "fed"}, request_id="s1")
    c.inc(4)
    a = h.handle("scrape", {"scraper_id": "fed"}, request_id="s2")
    c.inc(100)
    b = h.handle("scrape", {"scraper_id": "fed"}, request_id="s2")
    nxt = h.handle("scrape", {"scraper_id": "fed"}, request_id="s3")
    return dict(a=a, replay=b == a, replays=h.replays,
                nxt=nxt["metrics"]["c"]["values"][""])


def test_retried_scrape_replays_cached_delta_exactly_once(models):
    r = both(models, _retried_scrape)
    assert r["replay"] and r["replays"] == 1 and r["nxt"] == 100.0


def _federator_partition(S):
    from importlib import import_module
    rs = import_module(S.serve.__name__ + ".remote_server")
    clock = FakeClock(0.0)
    journal = S.obs.EventJournal(clock=clock)
    store = S.obs.FleetMetricsStore(clock=clock,
                                    registry=S.obs.MetricsRegistry())
    reg = S.obs.MetricsRegistry()
    c = reg.counter("c", "")

    class H(S.obs.MetricsScrapeMixin, rs.RpcHandlerBase):
        mutating_methods = frozenset({"scrape"})

    h = H()
    h.scrape_registry, h.scrape_journal = reg, journal
    h.scrape_clock, h.scrape_peer = clock, "p1"
    plan = S.res.NetworkFaultPlan()
    fed = S.obs.MetricsFederator(
        store, {"p1": S.serve.LoopbackTransport(h, target="p1",
                                                fault_plan=plan)},
        clock=clock, journal=journal, interval_s=0.0, retries=0)
    c.inc(1)
    res = [fed.scrape_once(clock.advance(1.0))]
    plan.partition("p1")
    c.inc(10)
    res += [fed.scrape_once(clock.advance(1.0)) for _ in range(2)]
    stale = store.is_stale("p1")
    plan.heal("p1")
    res.append(fed.scrape_once(clock.advance(1.0)))
    kinds = [e["kind"] for e in journal.recent()]
    return dict(res=res, stale=stale, cells=store.cells("c", "p1"),
                kinds=kinds)


def test_federator_partition_marks_stale_then_recovers_full(models):
    r = both(models, _federator_partition)
    assert r["stale"] and r["cells"][""] == 11.0
    assert r["kinds"].count("peer_unreachable") == 1


# ---- chaos harness (tests/test_resilience.py) -----------------------------

class _TinySession:
    def __init__(self, log):
        self.log = log

    def run_turn(self, text):
        self.log.append(text)
        return text


def _chaos_session(S):
    log = []
    plan = S.res.FaultPlan([S.res.FaultSpec(0, 0, 0, "raise", times=1)])
    s = S.res.ChaosSession(_TinySession(log), plan)
    s.bind_episode(0, 0, 0)
    with pytest.raises(S.res.ChaosError):
        s.run_turn("t")
    s2 = S.res.ChaosSession(_TinySession(log), plan)
    s2.bind_episode(0, 0, 0)
    clean = s2.chaos_fault is None
    s2.run_turn("t")
    s3 = S.res.ChaosSession(_TinySession(log), plan)
    s3.bind_episode(1, 0, 0)
    return dict(counts=plan.injected_counts(), clean=clean,
                other=s3.chaos_fault is None, log=log)


def test_chaos_session_injects_and_budgets(models):
    r = both(models, _chaos_session)
    assert r["counts"] == {"raise": 1} and r["clean"] and r["other"]


def _chaos_engine(S):
    class Eng:
        def __init__(self):
            self.calls = 0

        def submit(self, *a, **k):
            self.calls += 1
            return self.calls

    plan = S.res.FaultPlan(engine_faults=[S.res.EngineFault(1,
                                                            kind="raise")])
    eng = plan.wrap_engine(Eng())
    first = eng.submit([1])
    with pytest.raises(S.res.ChaosError):
        eng.submit([1])
    return dict(calls=(first, eng.submit([1])),
                counts=plan.injected_counts())


def test_chaos_engine_faults_on_submit(models):
    r = both(models, _chaos_engine)
    assert r["calls"] == (1, 2) and r["counts"] == {"engine_raise": 1}


def _memory_pressure(S):
    """A squeeze of the pool on a real engine: the plan squats blocks
    through the engine's allocator at a step and gives them back later;
    decoding goes on under pressure (preempting and resuming) and every
    stream equals the unsqueezed one."""
    prompts = [[3 + i, 1, 4, 1, 5, 9, 2, 6][: 5 + i] for i in range(3)]
    refs = [S.reference(p, 12, params=S.params) for p in prompts]
    plan = S.res.MemoryPressurePlan([
        S.res.MemoryPressureFault(at_step=2, hold_blocks=14,
                                  release_step=8)])
    eng = S.engine(num_slots=3, block_size=4, num_blocks=24)
    chaos = plan.wrap_engine(eng)
    rids = [chaos.submit(p, max_new_tokens=12) for p in prompts]
    held = []
    while eng.has_work:
        chaos.step()
        held.append(plan.holding_blocks)
    plan.release_all(eng)
    outs = [eng.result(r) for r in rids]
    assert outs == [list(x) for x in refs]
    eng._alloc.check_leaks()
    return dict(outs=outs, held=held, injected=plan.injected,
                stats=eng.stats())


def test_memory_pressure_plan_squeezes_a_real_pool(models):
    r = both(models, _memory_pressure)
    assert max(r["held"]) > 0 and r["held"][-1] == 0
    assert r["stats"]["kv_preemptions"] >= 1


# ---- what only mutable tensors have to prove ------------------------------

def test_in_place_step_during_a_roll_leaves_the_snapshot_served(models):
    """Publish v1, swap the first replica, then step the trainer's
    params IN PLACE (as the port's optimizer does) before the second
    replica swaps: the second replica still installs the published
    snapshot bit for bit, and its stream is v1's stream."""
    from torch_fleet_sides import Side
    S = Side("port", models)
    S.obs._reset_for_tests()
    trainer_params = {k: (v.clone() if isinstance(v, torch.Tensor)
                          else {kk: vv.clone() for kk, vv in v.items()})
                      for k, v in S.weights(1).items()}
    published = S.serve.placement.on_device(trainer_params, copy=True)
    fleet = S.serve.ServingFleet([S.engine(num_slots=1),
                                  S.engine(num_slots=1)])
    t1 = fleet.submit([1, 2, 3], max_new_tokens=6)
    t2 = fleet.submit([4, 5, 6], max_new_tokens=10)
    fleet.step()
    fleet.publisher.begin(trainer_params)
    versions = []
    while fleet.publisher.in_progress:
        fleet.step()
        versions.append(tuple(r.weight_version for r in fleet.replicas))
        if sorted(versions[-1]) == [0, 1] and not any(
                sorted(v) == [0, 1] for v in versions[:-1]):
            bump_in_place(trainer_params, 0.5)       # mid-roll step
    assert any(sorted(v) == [0, 1] for v in versions), versions
    for r in fleet.replicas:
        assert trees_equal(r.engine.params, published)
        assert not trees_equal(r.engine.params, trainer_params)
    # the two replicas share the roll's one copy
    a, b = (r.engine.params["embed"] for r in fleet.replicas)
    assert a.data_ptr() == b.data_ptr()
    fleet.run()
    t3 = fleet.submit([7, 8, 9], max_new_tokens=6)
    fleet.run()
    assert list(fleet.outcome(t3).tokens) == list(
        S.reference([7, 8, 9], 6, params=S.weights(1)))
    assert all(isinstance(fleet.outcome(t), S.serve.Completed)
               for t in (t1, t2, t3))
    check_leaks_all(fleet)
    S.obs._reset_for_tests()


def test_donor_prefix_blocks_untouched_by_a_peer_decode(models):
    """The broadcast's donor buffer and every install own their KV: a
    peer decoding past the prefix (and the donor's own decode) leaves the
    donor's blocks, the stored buffer and the other installs as they
    were, and an export after the traffic equals the one before."""
    from torch_fleet_sides import Side
    S = Side("port", models)
    S.obs._reset_for_tests()
    fleet = S.serve.ServingFleet([S.engine(block_size=4)
                                  for _ in range(3)])
    pid = fleet.register_prefix(PREFIX)
    t0 = fleet.submit(PREFIX + [1], max_new_tokens=2, prefix_id=pid)
    fleet.run()
    entry = fleet.prefix_store.lookup(pid)
    stored = [a.clone() for a in (entry.kv.k, entry.kv.v)]
    before = {}
    for r in fleet.replicas:
        eng = r.engine
        lpid = eng._prefix_by_tokens[tuple(PREFIX)]
        blocks = eng._prefixes[lpid][1]
        before[r.replica_id] = (lpid, list(blocks),
                                eng.pool.k[:, blocks].clone(),
                                eng.pool.v[:, blocks].clone())
    # distinct block ids across installs: nothing is shared by reference
    assert all(a.data_ptr() != entry.kv.k.data_ptr()
               for a in (r.engine.pool.k for r in fleet.replicas))
    tickets = [fleet.submit(PREFIX + [i + 2, 7, 7, 7], max_new_tokens=12,
                            prefix_id=pid) for i in range(6)]
    fleet.run()
    assert all(isinstance(fleet.outcome(t), S.serve.Completed)
               for t in [t0] + tickets)
    assert torch.equal(entry.kv.k, stored[0])
    assert torch.equal(entry.kv.v, stored[1])
    for r in fleet.replicas:
        lpid, blocks, k, v = before[r.replica_id]
        assert torch.equal(r.engine.pool.k[:, blocks], k)
        assert torch.equal(r.engine.pool.v[:, blocks], v)
        _, kv, _ = r.engine.export_prefix(lpid)
        assert torch.equal(kv.k[:, 0, :len(PREFIX)],
                           stored[0][:, 0, :len(PREFIX)])
    check_leaks_all(fleet)
    S.obs._reset_for_tests()


# ---- the fleet cases of other suites: migration coordinator, groups,
# ---- tenants, speculation (tests/test_migration.py, test_group_tree.py,
# ---- test_multi_lora.py, test_spec_engine.py) -----------------------------

MIG_PROMPT = [5, 9, 2, 7, 1, 3]


def _mod(S, name):
    from importlib import import_module
    return import_module(S.serve.__name__ + "." + name)


def _migrations(S, reason, outcome):
    m = S.obs.get_registry().get("senweaver_serve_migrations_total")
    return 0.0 if m is None else m.value(reason=reason, outcome=outcome)


def _local_fleet(S, n=2, *, num_slots=4, **kw):
    clock = FakeClock()
    fleet = S.serve.ServingFleet([S.engine(num_slots=num_slots)
                                  for _ in range(n)], clock=clock,
                                 retry_base_delay_s=0.0, **kw)
    return fleet, clock


def _router_departure(S):
    adm = _mod(S, "admission")
    rep = S.serve.EngineReplica("r0", S.engine())
    router = S.serve.Router([rep])
    req = adm.FleetRequest(ticket=1, prompt=list(MIG_PROMPT),
                           max_new_tokens=32)
    rid = rep.submit(req)
    rep.step()
    before = (req.emitted, rep.outstanding_decode_tokens > 0)
    router.on_request_departure(req, tokens_survive=True)
    gone = rep.detach(rid) is req
    moved = (rep.outstanding_decode_tokens, rep.outstanding, req.emitted,
             req.attempts, req.replica_id, req.engine_rid)
    router.on_request_departure(req)
    return dict(before=before, gone=gone, moved=moved,
                died=(req.emitted, req.first_token_at, req.attempts),
                again=rep.detach(rid))


def test_router_load_never_stale_after_departure(models):
    r = both(models, _router_departure)
    assert r["gone"] and r["moved"][:2] == (0, 0)
    assert r["died"] == (0, None, 1) and r["again"] is None


def _coordinator_handoff(S, fence):
    ref = S.reference(MIG_PROMPT, 12)
    fleet, clock = _local_fleet(S)
    mig = fleet.attach_migration()
    t = fleet.submit(MIG_PROMPT, max_new_tokens=12)
    for _ in range(3 if fence else 4):
        fleet.step()
    req = fleet._requests[t]
    source = fleet._replica_by_id(req.replica_id)
    target = next(r for r in fleet.replicas if r is not source)
    if fence:
        target.stamp_version(7)
    moved = mig.migrate(req, source, target, reason="test", now=clock())
    where = (req.replica_id == target.replica_id, source.outstanding,
             len(mig.pending))
    fleet.run()
    assert list(fleet.outcome(t).tokens) == list(ref)
    check_leaks_all(fleet)
    return dict(moved=moved, where=where, pending=len(mig.pending),
                out=outcome_view(fleet.outcome(t)),
                outcomes={o: _migrations(S, "test", o)
                          for o in ("completed", "fence_abort")})


@pytest.mark.parametrize("fence", [False, True])
def test_fleet_migration_handoff_and_fence_abort(models, fence):
    """The coordinator's two-phase handoff mid-decode, token-exact and
    acked; and with a publish landing on the target between snapshot and
    install, the fence refuses the splice and the decode finishes on its
    source."""
    r = both(models, _coordinator_handoff, fence)
    if fence:
        assert r["moved"] is False and r["outcomes"]["fence_abort"] == 1
    else:
        assert r["moved"] is True and r["where"] == (True, 0, 1)
        assert r["pending"] == 0 and r["outcomes"]["completed"] == 1


def _scheduler_signals(S):
    sched_mod = _mod(S, "scheduler")
    reps = [S.serve.EngineReplica(f"r{i}", S.engine(num_slots=4))
            for i in range(3)]
    sched = sched_mod.GlobalScheduler(reps)

    def rid(rep):
        return None if rep is None else rep.replica_id

    got = [rid(sched.pick_target(reps[0]))]
    reps[1].stamp_version(3)
    got += [rid(sched.pick_target(reps[0], require_version=0)),
            rid(sched.pick_target(reps[0], require_version=3))]
    reps[2].kill()
    got.append(rid(sched.pick_target(reps[0], require_version=0)))

    class StaleStore:
        def is_stale(self, peer):
            return peer == "r1"

    sched2 = sched_mod.GlobalScheduler(reps, fleet_store=StaleStore())
    got.append(rid(sched2.pick_target(reps[0], require_version=3)))
    return dict(got=got)


def test_global_scheduler_placement_signals(models):
    r = both(models, _scheduler_signals)
    assert r["got"][1:] == ["r2", "r1", None, None]


def _kv_pressure_migrates(S):
    starved = S.engine(num_slots=3, block_size=4, num_blocks=6,
                       max_preempts=1)
    roomy = S.engine(num_slots=8)
    fleet = S.serve.ServingFleet([starved, roomy], clock=FakeClock(),
                                 retry_base_delay_s=0.0)
    fleet.attach_migration()
    armed = starved.migrate_on_pressure
    tickets = [fleet.submit([i + 2, 9, 2, 7], max_new_tokens=12)
               for i in range(6)]
    fleet.run()
    check_leaks_all(fleet)
    return dict(armed=armed, outs=_outcomes(fleet, tickets),
                completed=_migrations(S, "kv_pressure", "completed"),
                out_n=starved.stats()["migrations_out"])


def test_kv_pressure_migrates_instead_of_truncating(models):
    r = both(models, _kv_pressure_migrates)
    assert r["armed"] is True and r["completed"] >= 1
    assert all(o[0] == "Completed" and len(o[1]) == 12 for o in r["outs"])


def _squeezed_chaos_engine(S):
    """The fleet's engine behind a ``MemoryPressurePlan`` proxy:
    ``attach_migration`` arms ``migrate_on_pressure`` through the proxy,
    and a squeeze of the wrapped pool then hands its rows to the roomy
    replica instead of truncating them."""
    starved = S.engine(num_slots=3, block_size=4, num_blocks=12,
                       max_preempts=0)
    plan = S.res.MemoryPressurePlan([
        S.res.MemoryPressureFault(at_step=3, hold_blocks=8,
                                  release_step=40)])
    fleet = S.serve.ServingFleet([plan.wrap_engine(starved),
                                  S.engine(num_slots=8)],
                                 clock=FakeClock(), retry_base_delay_s=0.0)
    fleet.attach_migration()
    tickets = [fleet.submit([i + 2, 9, 2, 7], max_new_tokens=12)
               for i in range(6)]
    fleet.run()
    plan.release_all(starved)
    check_leaks_all(fleet, [starved, fleet.replicas[1].engine])
    return dict(armed=starved.migrate_on_pressure,
                outs=_outcomes(fleet, tickets),
                held=plan.injected_counts(),
                completed=_migrations(S, "kv_pressure", "completed"),
                out_n=starved.stats()["migrations_out"])


def test_attach_migration_reaches_a_chaos_wrapped_engine(models):
    """Repaired in the port, open in JAX: JAX's ``ChaosEngine`` takes the
    flag on the proxy and its engine truncates under the squeeze; the
    port's proxy forwards the write and the squeezed rows migrate."""
    from torch_fleet_sides import Side
    got = {}
    for name in ("jax", "port"):
        S = Side(name, models)
        S.obs._reset_for_tests()
        try:
            got[name] = _squeezed_chaos_engine(S)
        finally:
            S.obs._reset_for_tests()
    j, t = got["jax"], got["port"]
    assert j["held"] == t["held"] and sum(t["held"].values()) >= 1
    assert j["armed"] is False and j["completed"] == 0
    assert j["out_n"] == 0
    assert any(o[0] == "Completed" and len(o[1]) < 12 for o in j["outs"])
    assert t["armed"] is True and t["completed"] >= 1
    assert t["out_n"] >= 1
    assert all(o[0] == "Completed" and len(o[1]) == 12 for o in t["outs"])


def _scale_down(S):
    ref = S.reference(MIG_PROMPT, 12)
    fleet, clock = _local_fleet(S)
    mig = fleet.attach_migration()
    fleet.attach_autoscaler(lambda: S.engine(num_slots=4))
    same = fleet.autoscaler.migrator is mig
    t = fleet.submit(MIG_PROMPT, max_new_tokens=12)
    for _ in range(3):
        fleet.step()
    req = fleet._requests[t]
    victim = fleet._replica_by_id(req.replica_id)
    victim.drain()
    fleet.autoscaler._retiring = victim.replica_id
    while fleet.pending():
        clock.advance(0.3)
        fleet.step()
    moved = req.replica_id != victim.replica_id
    clock.advance(0.3)
    fleet.step()
    assert list(fleet.outcome(t).tokens) == list(ref)
    check_leaks_all(fleet)
    return dict(same=same, moved=moved, state=victim.state,
                completed=_migrations(S, "scale_down", "completed"))


def test_scale_down_evacuates_instead_of_draining(models):
    r = both(models, _scale_down)
    assert r == dict(same=True, moved=True, state="dead", completed=1.0)


def _eager_relief(S):
    fleet, clock = _local_fleet(S)
    fleet.attach_migration()
    t_long = fleet.submit(MIG_PROMPT, max_new_tokens=24)
    t_short = fleet.submit([4, 4, 8, 1], max_new_tokens=8)
    fleet.step()
    req_l, req_s = fleet._requests[t_long], fleet._requests[t_short]
    fleet.begin_publish(S.params, eager=True)
    blockers = len(fleet.publisher.eager_pending())
    for _ in range(60):
        fleet.step()
        if not fleet.publisher.in_progress:
            break
    converged = not fleet.publisher.in_progress
    together = req_s.replica_id == req_l.replica_id
    fleet.run()
    check_leaks_all(fleet)
    return dict(blockers=blockers, converged=converged,
                together=together,
                degrades=S.obs.get_registry().get(
                    "senweaver_serve_eager_degrades_total").value(),
                relief=_migrations(S, "eager_publish", "completed") >= 1,
                outs=_outcomes(fleet, [t_long, t_short]))


def test_eager_publish_relief_consolidates_blockers(models):
    r = both(models, _eager_relief)
    assert (r["blockers"], r["converged"], r["together"]) == (2, True, True)
    assert r["degrades"] == 0 and r["relief"]


def _eager_degrade(S):
    from importlib import import_module
    incidents = import_module(S.obs.__name__ + ".incidents")
    fleet, clock = _local_fleet(S, n=1, num_slots=2)
    t = fleet.submit(MIG_PROMPT, max_new_tokens=48)
    fleet.step()
    fleet.begin_publish(S.params, eager=True)
    fleet.publisher._eager_wait_limit = 3
    for _ in range(10):
        fleet.step()
    kinds = [e["kind"] for e in incidents.get_event_journal().recent(64)]
    fleet.run()
    return dict(degrades=S.obs.get_registry().get(
        "senweaver_serve_eager_degrades_total").value(),
        journaled="eager_degrade" in kinds,
        out=outcome_view(fleet.outcome(t)))


def test_eager_degrade_emits_incident_and_counter(models):
    r = both(models, _eager_degrade)
    assert r["degrades"] == 1 and r["journaled"]


def _group_submit(S):
    ref = S.reference(MIG_PROMPT, 8)
    fleet = S.serve.ServingFleet([S.engine(num_slots=6) for _ in range(2)])
    tickets = fleet.submit_group(MIG_PROMPT, 4, max_new_tokens=8)
    fleet.run()
    homes = {fleet._requests[t].replica_id for t in tickets}
    outs = _outcomes(fleet, tickets)
    assert all(o[1] == list(ref) for o in outs)
    host = fleet._replica_by_id(next(iter(homes)))
    check_leaks_all(fleet)
    return dict(outs=outs, homes=len(homes),
                group_prefills=host.engine.stats()["group_prefills"])


def test_fleet_group_submit_is_replica_local(models):
    r = both(models, _group_submit)
    assert r["homes"] == 1 and r["group_prefills"] == 1


TENANT_PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [8, 9, 10, 11, 12], [3, 1, 2]]


def _adapter_publish_no_drain(S, mid_flight):
    draft, dcfg = S.draft()
    lA, lA2 = S.lora(1, 4), S.lora(7, 4, scale=0.08)
    lB = S.lora(2, 16)
    prefix = [7] * 8
    engines = []
    for _ in range(4):
        e = S.engine(num_slots=2, max_len=96, block_size=4, pool=S.pool())
        e.enable_speculation(draft, dcfg, depth=2)
        engines.append(e)
    fleet = S.serve.ServingFleet(engines)
    fleet.publish_adapter("tA", lA)
    fleet.publish_adapter("tB", lB)
    pid = fleet.register_prefix(prefix)
    tickets = [
        fleet.submit(TENANT_PROMPTS[0], max_new_tokens=12, tenant_id="tA"),
        fleet.submit(TENANT_PROMPTS[1], max_new_tokens=12, tenant_id="tB"),
        fleet.submit(TENANT_PROMPTS[2], max_new_tokens=12, tenant_id="tB"),
        fleet.submit(prefix + [3], max_new_tokens=12, prefix_id=pid),
        fleet.submit(prefix + [5], max_new_tokens=12, prefix_id=pid)]
    for _ in range(3):
        fleet.step()
    if mid_flight:
        fleet.publish_adapter("tA", lA2)
    fleet.run()
    t = fleet.submit(prefix + [9], max_new_tokens=4, prefix_id=pid)
    fleet.run()
    return dict(outs=_outcomes(fleet, tickets + [t]),
                versions=dict(fleet.publisher.adapter_versions),
                staleness=[e.spec_stats()["draft_staleness"]
                           for e in engines],
                replays=S.counter_total(
                    "senweaver_serve_continuation_replays_total"),
                invalidations=S.counter_total(
                    "senweaver_serve_prefix_invalidations_total"))


@pytest.mark.parametrize("mid_flight", [False, True])
def test_fleet_adapter_publish_leaves_other_tenants_untouched(models,
                                                              mid_flight):
    """Four replicas with adapter pools and speculation: a tenant's
    adapter publish mid-flight drains nothing, drops no prefix, stamps no
    draft stale, and leaves every in-flight stream as it was without the
    publish (the JAX test compares the two runs; here each run is also
    held to JAX's)."""
    r = both(models, _adapter_publish_no_drain, mid_flight)
    assert r["replays"] == 0 and r["invalidations"] == 0
    assert r["staleness"] == [0] * 4
    assert r["versions"] == {"tA": 2 if mid_flight else 1, "tB": 1}


def _tenant_rate_affinity(S):
    adm = _mod(S, "admission")
    engines = [S.engine(num_slots=2, max_len=96, block_size=4,
                        pool=S.pool()) for _ in range(2)]
    now = [0.0]
    fleet = S.serve.ServingFleet(
        engines, clock=lambda: now[0],
        admission=S.serve.AdmissionConfig(tenant_rate=1.0,
                                          tenant_burst=2.0))
    fleet.publish_adapter("tA", S.lora(1, 4))
    tickets = [fleet.submit([1, 2, 3], max_new_tokens=2, tenant_id="tA")
               for _ in range(4)]
    shed = [outcome_view(fleet.outcome(t)) for t in tickets]
    fleet.run()
    now[0] += 10.0
    t2 = fleet.submit([4, 5, 6], max_new_tokens=2, tenant_id="tA")
    fleet.run()
    return dict(shed=shed, reason=adm.REJECT_TENANT_RATE,
                outs=_outcomes(fleet, tickets + [t2]),
                hits=S.counter_total(
                    "senweaver_serve_adapter_affinity_hits_total"))


def test_fleet_tenant_rate_limit_and_affinity(models):
    r = both(models, _tenant_rate_affinity)
    assert [o for o in r["shed"] if o is not None] == \
        [("Rejected", r["reason"])] * 2
    assert r["hits"] >= 1


def _spec_fleet_chaos(S):
    from importlib import import_module
    sc = import_module(S.serve.__name__.rsplit(".", 1)[0]
                       + ".rollout.spec_controller")
    draft, dcfg = S.draft()
    target_v1 = S.bump(S.params, 0.01)
    draft_v1 = S.bump(draft, -0.01)
    prompts = [[(i * 5 + j) % 90 + 2 for j in range(4 + i % 3)]
               for i in range(8)]
    refs = {}
    for v, pp in ((0, S.params), (1, target_v1)):
        eng = S.engine(num_slots=4, max_len=96, block_size=4, params=pp)
        rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
        out = eng.run()
        for i, r in enumerate(rids):
            refs[(v, i)] = out[r]

    def replica(i):
        e = S.engine(num_slots=2, max_len=96, block_size=4, num_blocks=14)
        if i % 2 == 0:
            e.enable_speculation(draft, dcfg, depth=(4 if i == 0 else 8))
        else:
            e.enable_speculation(draft, dcfg, controller=sc.SpecController(
                sc.SpecControllerConfig(hysteresis_steps=1)))
        return e

    engines = [replica(i) for i in range(4)]
    fleet = S.serve.ServingFleet(engines)
    tickets = [fleet.submit(p, max_new_tokens=12) for p in prompts]
    for _ in range(4):
        fleet.step()
    fleet.publish_draft(draft_v1)
    fleet.begin_publish(target_v1)
    for e in engines:
        e.set_spec_depth(2)
    fleet.run()
    outs = _outcomes(fleet, tickets)
    for i, o in enumerate(outs):
        assert o[2] == o[3] and o[1] == refs[(o[2], i)]
    for e in engines:
        e._alloc.check_leaks()
        e.spec_check_leaks()
    return dict(outs=outs,
                spec=[(e.spec_stats()["draft_version"],
                       e.spec_stats()["draft_staleness"]) for e in engines])


def test_fleet_speculation_chaos_exact_parity(models):
    """Four speculating replicas (fixed and controlled depth, tight
    pools), a draft publish and a rolling target publish mid-run, depth
    churn: every stream equals its version's reference."""
    r = both(models, _spec_fleet_chaos)
    assert all(v >= 1 and s >= 1 for v, s in r["spec"])


def _draft_stale_and_distill(S):
    from importlib import import_module
    dd = import_module(S.serve.__name__.rsplit(".", 1)[0]
                       + ".training.draft_distill")
    draft, dcfg = S.draft()
    engines = [S.engine(max_len=96, block_size=4) for _ in range(2)]
    for e in engines:
        e.enable_speculation(draft, dcfg, depth=4)
    fleet = S.serve.ServingFleet(engines)
    fleet.begin_publish(S.bump(S.params, 0.01))
    stamped = [(e.spec_stats()["draft_staleness"],
                e.spec_stats()["acceptance_ema"]) for e in engines]
    fleet.run()
    for i in range(4):
        fleet.submit([i + 1, i + 2, i + 3], max_new_tokens=8)
    fleet.run()
    distiller = dd.DraftDistiller(draft, dcfg)
    loss = distiller.round(engines, steps=2, publisher=fleet.publisher)
    versions = [e.spec_stats()["draft_version"] for e in engines]
    with pytest.raises(S.serve.StalePublishError):
        fleet.publisher.publish_draft(distiller.params, version=1)
    return dict(stamped=stamped, approx_loss=float(loss),
                version=distiller.version, versions=versions)


def test_publish_stamps_drafts_stale_and_distiller_publishes_fenced(
        models):
    r = both(models, _draft_stale_and_distill)
    assert r["stamped"] == [(1, None)] * 2
    assert r["version"] == 1 and r["versions"] == [1, 1]


# ---- a fault found here, repaired in the port ------------------------------

STALE_PREFIX = [5, 9, 2, 7, 4, 4, 8, 3, 3, 1, 2, 6]


def _stale_prefix(S, remote):
    """A donor prefix imported on replica-1; replica-1's pool is squeezed
    and its ladder evicts the idle prefix; with the donor dead, every
    later prefix request lands on replica-1 with the replica's cached,
    now stale, prefix id."""
    eng = S.engine(num_slots=2, block_size=4, num_blocks=24)
    plan = S.res.MemoryPressurePlan([S.res.MemoryPressureFault(
        at_step=1, hold_blocks=1 << 30, release_step=3)])
    second = plan.wrap_engine(eng)
    if remote:
        second = S.serve.RemoteReplica(
            "replica-1", S.serve.LoopbackTransport(
                S.serve.EngineRpcHandler(second), target="replica-1"),
            policy=S.res.RetryPolicy(max_retries=2, base_delay_s=0.0,
                                     jitter=False), sleep=lambda s: None)
    fleet = S.serve.ServingFleet([S.engine(), second],
                                 retry_base_delay_s=0.0)
    pid = fleet.register_prefix(STALE_PREFIX)
    tickets = [fleet.submit(STALE_PREFIX + [1, 2], max_new_tokens=4,
                            prefix_id=pid)]
    fleet.run()
    tickets += [fleet.submit(p, max_new_tokens=16)
                for p in ([3, 4, 5, 6], [3, 4, 9, 6])]
    fleet.run()
    evicted = eng.stats()["prefix_evictions"]
    fleet.kill_replica("replica-0")
    late = [STALE_PREFIX + [7 + i] for i in range(3)]
    tickets += [fleet.submit(p, max_new_tokens=4, prefix_id=pid)
                for p in late]
    fleet.run()
    return dict(evicted=evicted, state=fleet.replicas[1].state,
                outs=[outcome_view(fleet.outcome(t)) for t in tickets],
                refs=[list(S.reference(p, 4)) for p in late])


@pytest.mark.parametrize("remote", [False, True])
def test_evicted_prefix_re_registers_instead_of_killing_the_replica(
        models, remote):
    """When the engine drops a prefix on its own (here the pool-pressure
    ladder evicts an idle imported prefix), the replica's cached prefix
    id goes stale. JAX's replica submits it anyway: each request raises
    KeyError, three count as consecutive faults and a healthy replica is
    declared dead, shedding the rest. The port's replica registers the
    prefix again and resubmits once (over the wire with a fresh
    idempotency key), and the streams equal a plain engine's."""
    from torch_fleet_sides import Side
    got = {}
    for name in ("jax", "port"):
        S = Side(name, models)
        S.obs._reset_for_tests()
        got[name] = _stale_prefix(S, remote)
        S.obs._reset_for_tests()
    j, t = got["jax"], got["port"]
    assert j["evicted"] == t["evicted"] == 1
    assert j["outs"][:3] == t["outs"][:3]
    assert j["state"] == "dead"
    assert j["outs"][3:] == [("Rejected", "no_replicas")] * 3
    assert t["state"] == "live"
    assert [o[1] for o in t["outs"][3:]] == t["refs"]
