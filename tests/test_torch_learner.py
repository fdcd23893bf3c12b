"""The port's disaggregated learner (``serve/learner.py``,
``learner_server.py``) and its leases (``resilience/lease.py``) against
the JAX package's.

The service paths of tests/test_learner.py and
tests/test_streaming_learner.py, written once and run on both packages
(``torch_fleet_sides.both``): lease epochs, the ``(epoch, version)``
fence and the stale-publish refusal, lost responses replayed from the
idempotency cache, crash/resume republishes, the autoscaler, the
streaming service's no-drain publishes and exactly-once episodes, one
lease authority behind two fleets, rack-aware prefix fanout, and a
learner over a real HTTP socket; same versions, outcomes, handler
execution counts and learner/serving counters on both sides.

Then the port's own hazard: its trainers update params in place. A
learner that publishes and then steps in place must leave every replica
on the published snapshot, bit for bit, both in process and across
HTTP, and a real ``StreamingTrainerAdapter`` GRPO step behind the
service is held to the same rule.
"""

import time

import numpy as np
import pytest
import torch

from torch_fleet_sides import (FakeClock, Models, Side, as_numpy, both,
                               bump_in_place, check_leaks_all,
                               one_torch_thread, trees_equal)

PREFIX = [5, 9, 2, 7, 4, 4, 8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    yield from one_torch_thread()


@pytest.fixture(scope="module")
def models():
    return Models()


def _fast(S):
    return S.res.RetryPolicy(max_retries=2, base_delay_s=0.0, jitter=False)


class FakeTrainer:
    """``run_round()`` plus ``state.params``, with params that visibly
    change each round (a new tree: the JAX tests' trainer)."""

    class _State:
        def __init__(self, params):
            self.params = params

    def __init__(self, S, params):
        self.S = S
        self.state = self._State(params)
        self.rounds = 0

    def run_round(self):
        self.rounds += 1
        self.state.params = self.S.bump(self.state.params, 0.001)


class FakeStreamTrainer(FakeTrainer):
    """The streaming service's trainer contract, recording every episode
    it trained on (the exactly-once oracle)."""

    def __init__(self, S, params):
        super().__init__(S, params)
        self.trained_ids, self.published = [], []

    def train_on_batch(self, episodes):
        self.trained_ids.extend(ep.episode_id for ep in episodes)
        self.run_round()
        return {"loss": 0.1}

    def note_published(self, version):
        self.published.append(version)


def make_stack(S, n, *, clock, plan=None, lease_ttl_s=30.0,
               holder="learner-0"):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(n)],
                                 clock=clock, probe_interval_s=0.0,
                                 retry_base_delay_s=0.0)
    handler = S.serve.FleetRpcHandler(fleet, lease_ttl_s=lease_ttl_s,
                                      clock=clock)
    client = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw",
                                  fault_plan=plan),
        name=holder, policy=_fast(S), clock=clock, sleep=lambda s: None)
    return fleet, handler, client


def make_learner(S, client, trainer, *, clock, holder="learner-0",
                 state_path=None):
    return S.serve.LearnerService(
        trainer, client, clock=clock, sleep=lambda s: None,
        config=S.serve.LearnerConfig(holder=holder, state_path=state_path))


def live_versions(fleet):
    return sorted(r.weight_version for r in fleet.replicas
                  if r.state != "dead")


def _live_params_equal(S, fleet, params):
    return [trees_equal(r.engine.params, params) for r in fleet.replicas
            if r.state != "dead"]


# ---- leases and the publisher's fence -------------------------------------

def _lease_store(S):
    clock = FakeClock()
    store = S.res.LeaseStore(ttl_s=10.0)
    seen = [store.acquire("a", now=clock()).epoch]
    with pytest.raises(S.res.LeaseUnavailable):
        store.acquire("b", now=clock())
    a2 = store.acquire("a", now=clock())
    clock.advance(11.0)
    b = store.acquire("b", now=clock())
    seen += [a2.epoch, b.epoch]
    with pytest.raises(S.res.LeaseLost):
        store.renew("a", a2.epoch, now=clock())
    clock.advance(11.0)
    with pytest.raises(S.res.LeaseLost):
        store.renew("b", b.epoch, now=clock())
    c = store.acquire("c", now=clock())
    d = store.acquire("d", now=clock(), steal=True)
    seen += [c.epoch, d.epoch]
    with pytest.raises(S.res.LeaseLost):
        store.validate(c.epoch, now=clock())
    store.validate(d.epoch, now=clock())
    return dict(epochs=seen)


def test_lease_store_epochs_monotonic_across_contention_and_expiry(models):
    r = both(models, _lease_store)
    assert r["epochs"] == sorted(set(r["epochs"])) == [1, 2, 3, 4, 5]


def _publisher_fencing(S):
    clock = FakeClock()
    fleet = S.serve.ServingFleet([S.engine(), S.engine()], clock=clock,
                                 probe_interval_s=0.0)
    got = [fleet.update_params(S.params)]
    with pytest.raises(S.serve.StalePublishError):
        fleet.update_params(S.params, epoch=0, version=1)
    got.append(fleet.update_params(S.params, epoch=3, version=7))
    with pytest.raises(S.serve.StalePublishError):
        fleet.update_params(S.params, epoch=2, version=100)
    got.append(fleet.update_params(S.params, epoch=4, version=2))
    check_leaks_all(fleet)
    return dict(got=got, live=live_versions(fleet),
                skew=fleet.publisher.skew())


def test_publisher_fencing_rejects_stale_epoch_and_version(models):
    r = both(models, _publisher_fencing)
    assert r["got"] == [1, 7, 2] and r["live"] == [2, 2]


def _rounds_over_loopback(S):
    clock = FakeClock()
    fleet, handler, client = make_stack(S, 2, clock=clock)
    learner = make_learner(S, client, FakeTrainer(S, S.params), clock=clock)
    got = [learner.start()] + [learner.run_round() for _ in range(3)]
    same = _live_params_equal(S, fleet, learner.trainer.state.params)
    t = fleet.submit([1, 2, 3], max_new_tokens=4)
    fleet.run()
    toks = list(fleet.outcome(t).tokens)
    learner.stop()
    check_leaks_all(fleet)
    return dict(got=got, version=(fleet.publisher.version,
                                  fleet.publisher.epoch),
                live=live_versions(fleet), same=same, toks=toks,
                lease=handler.lease_store.current())


def test_learner_rounds_publish_and_converge_over_loopback(models):
    r = both(models, _rounds_over_loopback)
    assert r["got"] == [1, 1, 2, 3] and r["live"] == [3, 3]
    assert r["same"] == [True, True] and r["lease"] is None


def _mid_publish_kill(S, tmp_path):
    state_path = str(tmp_path / f"{S.name}_learner_state.json")
    clock = FakeClock()
    fleet, handler, client = make_stack(S, 3, clock=clock)
    a = make_learner(S, client, FakeTrainer(S, S.params), clock=clock,
                     state_path=state_path)
    a.start()
    a.run_round()
    a.run_round()
    client.publish(a.trainer.state.params, epoch=a.epoch, version=3)
    fleet.step()
    torn = sorted(set(live_versions(fleet)))
    client_b = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw"),
        name="learner-0b", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    b = make_learner(S, client_b, FakeTrainer(S, S.params), clock=clock,
                     state_path=state_path)
    started = (b.start(), b.version)
    after = (live_versions(fleet), fleet.publisher.version,
             fleet.publisher.epoch, fleet.publisher.skew())
    nxt = b.run_round()
    check_leaks_all(fleet)
    return dict(torn=torn, started=started, after=after,
                nxt=nxt, live=live_versions(fleet))


def test_mid_publish_kill_restart_republishes_without_version_mixing(
        models, tmp_path):
    r = both(models, _mid_publish_kill, tmp_path)
    assert r["torn"] == [2, 3] and r["started"] == (2, 2)
    assert r["after"] == ([2, 2, 2], 2, 2, 0) and r["live"] == [3, 3, 3]


def _split_brain(S):
    clock = FakeClock()
    fleet, handler, client_a = make_stack(S, 2, clock=clock,
                                          lease_ttl_s=10.0)
    a = make_learner(S, client_a, FakeTrainer(S, S.params), clock=clock,
                     holder="learner-a")
    a.start()
    a.run_round()
    clock.advance(11.0)
    client_b = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw"),
        name="learner-b", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    b = make_learner(S, client_b, FakeTrainer(S, S.params), clock=clock,
                     holder="learner-b")
    got = [b.start(), b.version, b.run_round()]
    with pytest.raises(S.res.LeaseLost):
        a.run_round()
    with pytest.raises(S.res.LeaseLost):
        client_a.publish(S.params, epoch=1, version=99)
    with pytest.raises(S.serve.StalePublishError):
        client_b.publish(S.params, epoch=2, version=1)
    mid = (fleet.publisher.version, fleet.publisher.epoch,
           live_versions(fleet))
    got.append(b.run_round())
    check_leaks_all(fleet)
    return dict(got=got, mid=mid, live=live_versions(fleet))


def test_duplicate_learner_split_brain_is_fenced_fleet_wide(models):
    r = both(models, _split_brain)
    assert r["got"] == [2, 1, 2, 3] and r["mid"] == (2, 2, [2, 2])


def _lost_publish_response(S):
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan([S.res.NetworkFault(
        kind="drop_response", method="publish", times=1)])
    fleet, handler, client = make_stack(S, 2, clock=clock, plan=plan)
    learner = make_learner(S, client, FakeTrainer(S, S.params), clock=clock)
    learner.start()
    v = learner.run_round()
    return dict(v=v, executed=handler.executed["publish"],
                replays=handler.replays >= 1, live=live_versions(fleet))


def test_publish_with_lost_response_replays_not_double_stages(models):
    r = both(models, _lost_publish_response)
    assert r == dict(v=1, executed=1, replays=True, live=[1, 1])


def _restarted_client_lease(S, plan_kind):
    clock = FakeClock()
    plan = None if plan_kind is None else S.res.NetworkFaultPlan([
        S.res.NetworkFault(kind="drop_response", method="acquire_lease",
                           times=1)])
    fleet, handler, client = make_stack(S, 1, clock=clock, plan=plan)
    if plan_kind is not None:
        grant = client.acquire_lease("learner-0")
        handler.lease_store.validate(grant["epoch"], now=clock())
        return dict(executed=handler.executed["acquire_lease"],
                    epoch=grant["epoch"])
    tr = S.serve.LoopbackTransport
    c1 = S.serve.FleetPublishClient(tr(handler, target="fleet-gw"),
                                    policy=_fast(S), clock=clock,
                                    sleep=lambda s: None)
    g1 = c1.acquire_lease("learner-0")
    c2 = S.serve.FleetPublishClient(tr(handler, target="fleet-gw"),
                                    policy=_fast(S), clock=clock,
                                    sleep=lambda s: None)
    g2 = c2.acquire_lease("learner-0")
    handler.lease_store.validate(g2["epoch"], now=clock())
    with pytest.raises(S.res.LeaseLost):
        handler.lease_store.validate(g1["epoch"], now=clock())
    return dict(epochs=(g1["epoch"], g2["epoch"]),
                names_differ=c1.name != c2.name)


@pytest.mark.parametrize("plan_kind", [None, "drop_response"])
def test_lease_grants_are_never_replayed(models, plan_kind):
    """A restarted default-name client gets a fresh grant; a lost
    acquire response re-executes (lease rpcs are never cached)."""
    r = both(models, _restarted_client_lease, plan_kind)
    if plan_kind is None:
        assert r == dict(epochs=(1, 2), names_differ=True)
    else:
        assert r == dict(executed=2, epoch=2)


def _callable_trainer(S, tmp_path):
    state_path = str(tmp_path / f"{S.name}_callable.json")
    clock = FakeClock()
    fleet, handler, client = make_stack(S, 2, clock=clock)
    params = S.params
    a = make_learner(S, client, lambda: params, clock=clock,
                     state_path=state_path)
    got = [a.start(), a.run_round()]
    client_b = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw"),
        name="learner-0b", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    b = make_learner(S, client_b, lambda: params, clock=clock,
                     state_path=state_path)
    got += [b.start(), b.version, fleet.publisher.epoch, b.run_round()]
    return dict(got=got, live=live_versions(fleet))


def test_callable_trainer_with_state_path_resumes_and_republishes(
        models, tmp_path):
    r = both(models, _callable_trainer, tmp_path)
    assert r["got"] == [1, 1, 2, 1, 2, 2]


def _autoscaler(S):
    clock = FakeClock()
    fleet = S.serve.ServingFleet(
        [S.engine()], clock=clock, probe_interval_s=0.0,
        admission=S.serve.AdmissionConfig(
            train_rollout=S.serve.ClassPolicy(max_queue=512)))
    ctl = fleet.attach_autoscaler(
        lambda: S.engine(),
        config=S.serve.AutoscaleConfig(
            min_replicas=1, max_replicas=2, queue_depth_high=4,
            shed_rate_high=1e9, sustain_s=1.0, idle_sustain_s=3.0,
            cooldown_s=2.0, evaluate_interval_s=0.0))
    tickets = [fleet.submit([1, 2, 3], max_new_tokens=4)
               for _ in range(24)]
    while fleet.pending():
        clock.advance(0.5)
        fleet.step()
    phases = [[a for _, a in ctl.actions]]
    for _ in range(40):
        clock.advance(0.5)
        fleet.step()
    phases.append([a for _, a in ctl.actions])
    toks = {tuple(fleet.outcome(t).tokens) for t in tickets}
    check_leaks_all(fleet)
    return dict(phases=phases, toks=sorted(toks),
                live=sum(r.state != "dead" for r in fleet.replicas))


def test_autoscaler_adds_once_under_overload_then_drains_once(models):
    r = both(models, _autoscaler)
    assert r["phases"] == [["add"], ["add", "drain"]] and r["live"] == 1


def _autoscaler_publish(S):
    clock = FakeClock()
    fleet = S.serve.ServingFleet([S.engine(), S.engine()], clock=clock,
                                 probe_interval_s=0.0)
    ctl = fleet.attach_autoscaler(
        lambda: S.engine(),
        config=S.serve.AutoscaleConfig(
            min_replicas=1, max_replicas=2, queue_depth_high=4,
            shed_rate_high=1e9, sustain_s=1.0, idle_sustain_s=0.5,
            cooldown_s=0.0, evaluate_interval_s=0.0))
    fleet.begin_publish(S.params)
    clock.advance(1.0)
    fleet.step()
    during = list(ctl.actions)
    while fleet.publisher.in_progress:
        clock.advance(0.5)
        fleet.step()
    for _ in range(10):
        clock.advance(0.5)
        fleet.step()
    return dict(during=during, after=[a for _, a in ctl.actions])


def test_autoscaler_never_drains_during_a_publish_roll(models):
    assert both(models, _autoscaler_publish) == dict(during=[],
                                                     after=["drain"])


def test_resume_republish_stamps_saved_version_onto_fleet(models):
    from senweaver_ide_tpu.training.online import _republish as jrep
    from senweaver_ide_tpu_torch.training.online import _republish as trep

    def scenario(S):
        rep = jrep if S.is_jax else trep
        fleet = S.serve.ServingFleet([S.engine(), S.engine()],
                                     clock=FakeClock(),
                                     probe_interval_s=0.0)
        got = [rep(fleet, S.params, 5), fleet.publisher.version,
               rep(fleet, S.params, 3), rep(fleet, S.params, None),
               rep(S.engine(), S.params, 5)]
        return dict(got=got, live=live_versions(fleet))

    assert both(models, scenario) == dict(got=[5, 5, 6, 7, None],
                                          live=[7, 7])


def _learner_over_http(S):
    fleet = S.serve.ServingFleet([S.engine()], probe_interval_s=0.0)
    handler = S.serve.FleetRpcHandler(fleet, clock=time.monotonic)
    server, port = S.serve.serve_fleet_http(handler)
    try:
        client = S.serve.FleetPublishClient(
            S.serve.HttpTransport(f"http://127.0.0.1:{port}",
                                  timeout_s=30.0),
            name="learner-http", policy=_fast(S))
        trainer = FakeTrainer(S, S.params)
        learner = S.serve.LearnerService(
            trainer, client, config=S.serve.LearnerConfig(
                holder="learner-http", publish_timeout_s=30.0,
                publish_poll_interval_s=0.001))
        got = [learner.start(), learner.run_round()]
        status = client.publish_status()
        same = _live_params_equal(S, fleet, trainer.state.params)
        learner.stop()
    finally:
        server.shutdown()
        server.server_close()
    return dict(got=got, live=live_versions(fleet), same=same,
                status=(status["converged"], status["version"]))


def test_learner_over_real_http_socket(models):
    """The learner publishes over a real socket: the weights cross as
    ``__nd__`` frames, and the fleet-side publisher places them on its
    engines' device before the roll (the replica then serves exactly
    the learner's params)."""
    r = both(models, _learner_over_http)
    assert r == dict(got=[1, 1], live=[1], same=[True],
                     status=(True, 1))


# ---- the streaming learner (tests/test_streaming_learner.py) -------------

def _eps(S, n, *, version, epoch=1, start=0, source="c0", group_size=2):
    return [S.exp.StreamedEpisode(
        episode_id=f"{source}/r0/i{start + i}",
        group_key=f"{source}/r0/g{(start + i) // group_size}",
        prompt_ids=[1, 2, 3], completion_ids=[4, 5],
        reward=float(i), epoch=epoch, version=version,
        behavior_logp=[-0.5, -0.25]) for i in range(n)]


def make_stream_stack(S, *, clock, plan=None, exp_plan=None,
                      state_path=None, holder="learner-0", trainer=None,
                      fleet=None):
    fleet = fleet or S.serve.ServingFleet(
        [S.engine() for _ in range(2)], clock=clock, probe_interval_s=0.0,
        retry_base_delay_s=0.0)
    handler = S.serve.FleetRpcHandler(fleet, lease_ttl_s=30.0, clock=clock)
    client = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw",
                                  fault_plan=plan),
        name=holder, policy=_fast(S), clock=clock, sleep=lambda s: None)
    trainer = trainer or FakeStreamTrainer(S, S.params)
    svc = S.serve.StreamingLearnerService(
        trainer, client,
        stream_config=S.serve.StreamingLearnerConfig(group_size=2,
                                                     min_groups=1),
        config=S.serve.LearnerConfig(holder=holder, state_path=state_path),
        clock=clock, sleep=lambda s: None)
    exp_client = S.serve.ExperienceClient(
        S.serve.LoopbackTransport(S.serve.ExperienceRpcHandler(svc),
                                  target="learner-exp",
                                  fault_plan=exp_plan),
        name="collector-0", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    return fleet, handler, svc, trainer, S.serve.EpisodeStreamer(exp_client)


def _stream_no_drain(S):
    clock = FakeClock()
    fleet, handler, svc, trainer, streamer = make_stream_stack(S,
                                                               clock=clock)
    started = svc.start()
    streamer.offer(_eps(S, 4, version=svc.version))
    flushed = streamer.flush()
    clock.advance(1.0)
    r = svc.run_step()
    outstanding = svc._outstanding_publish
    draining = []
    for _ in range(32):
        draining.append(any(rep.state == "draining"
                            for rep in fleet.replicas))
        if svc.pump_publish():
            break
    idle = svc.run_step()
    same = _live_params_equal(S, fleet, trainer.state.params)
    check_leaks_all(fleet)
    return dict(started=started, flushed=flushed,
                step=(r["mode"], r["version"], r["staleness_mean"],
                      r["episodes"]),
                outstanding=outstanding, draining=any(draining),
                version=fleet.publisher.version, published=trainer.published,
                idle=idle, same=same)


def test_streaming_learner_end_to_end_no_drain(models):
    r = both(models, _stream_no_drain)
    assert r["step"] == ("streaming", 1, 0.0, 4) and not r["draining"]
    assert r["published"] == [0, 1] and r["same"] == [True, True]


def _stream_crash(S, tmp_path):
    clock = FakeClock()
    state_path = str(tmp_path / f"{S.name}_stream.json")
    fleet, handler, svc, trainer, streamer = make_stream_stack(
        S, clock=clock, state_path=state_path)
    svc.start()
    first = _eps(S, 4, version=svc.version)
    streamer.offer(first)
    streamer.flush()
    n1 = svc.run_step()["episodes"]
    for _ in range(32):
        if svc.pump_publish():
            break
    del svc
    client2 = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw"),
        name="learner-0b", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    trainer2 = FakeStreamTrainer(S, S.params)
    svc2 = S.serve.StreamingLearnerService(
        trainer2, client2,
        stream_config=S.serve.StreamingLearnerConfig(group_size=2,
                                                     min_groups=1),
        config=S.serve.LearnerConfig(holder="learner-0",
                                     state_path=state_path),
        clock=clock, sleep=lambda s: None)
    started = (svc2.start(), svc2.version)
    streamer2 = S.serve.EpisodeStreamer(S.serve.ExperienceClient(
        S.serve.LoopbackTransport(S.serve.ExperienceRpcHandler(svc2),
                                  target="learner-exp"),
        name="collector-0", policy=_fast(S), clock=clock,
        sleep=lambda s: None))
    second = _eps(S, 4, version=svc2.version, start=4)
    streamer2.offer(first)
    streamer2.offer(second)
    out = streamer2.flush()
    n2 = svc2.run_step()["episodes"]
    trained = trainer.trained_ids + trainer2.trained_ids
    return dict(n=(n1, n2), started=started, out=out,
                trained=sorted(trained), dups=len(trained) - len(set(
                    trained)))


def test_streamed_episodes_survive_learner_crash(models, tmp_path):
    r = both(models, _stream_crash, tmp_path)
    assert r["n"] == (4, 4) and r["started"] == (2, 1)
    assert r["dups"] == 0 and len(r["trained"]) == 8


def _stream_chaos(S, kind):
    clock = FakeClock()
    plan = S.res.NetworkFaultPlan([S.res.NetworkFault(
        kind=kind, method="submit_episodes",
        times=1 if kind == "drop_response" else 8)])
    fleet, handler, svc, trainer, streamer = make_stream_stack(
        S, clock=clock, exp_plan=plan)
    svc.start()
    streamer.offer(_eps(S, 4 if kind == "drop_response" else 2,
                        version=svc.version))
    flushes = [streamer.flush()]
    if kind == "drop":
        flushes.append(streamer.pending)
        plan.faults.clear()
        flushes.append(streamer.flush())
    step = svc.run_step()
    return dict(flushes=flushes, injected=len(plan.injected),
                trained=len(set(trainer.trained_ids)),
                episodes=None if step is None else step["episodes"])


@pytest.mark.parametrize("kind", ["drop_response", "drop"])
def test_streamed_submit_chaos(models, kind):
    """A lost submit response replays from the cache (never re-offered);
    a transport that drops every retry keeps the episodes pending until
    the next healthy flush delivers them."""
    r = both(models, _stream_chaos, kind)
    if kind == "drop_response":
        assert r["flushes"] == [{"retired": 4, "pending": 0}]
        assert r["trained"] == 4
    else:
        assert r["flushes"] == [{"retired": 0, "pending": 2}, 2,
                                {"retired": 2, "pending": 0}]


def _shared_lease_authority(S):
    clock = FakeClock()
    lease_handler = S.serve.LeaseRpcHandler(ttl_s=30.0, clock=clock)

    def remote_lease_fleet(target):
        store = S.serve.RemoteLeaseStore(
            S.serve.LoopbackTransport(lease_handler, target=target),
            policy=_fast(S), clock=clock, sleep=lambda s: None)
        fleet = S.serve.ServingFleet([S.engine() for _ in range(2)],
                                     clock=clock, probe_interval_s=0.0,
                                     retry_base_delay_s=0.0)
        return fleet, S.serve.FleetRpcHandler(fleet, clock=clock,
                                              lease_store=store)

    fleet_a, handler_a = remote_lease_fleet("lease-gw-a")
    fleet_b, handler_b = remote_lease_fleet("lease-gw-b")
    client_a = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler_a, target="fleet-a"),
        name="learner-a", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    client_b = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler_b, target="fleet-b"),
        name="learner-b", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    ea = client_a.acquire_lease("learner-a")["epoch"]
    client_a.publish(S.params, epoch=1, version=1)
    eb = client_b.acquire_lease("learner-b", steal=True)["epoch"]
    with pytest.raises((S.res.LeaseLost, S.serve.StalePublishError)):
        client_a.publish(S.params, epoch=1, version=2)
    with pytest.raises(S.res.LeaseLost):
        client_a.renew_lease("learner-a", 1)
    client_b.publish(S.params, epoch=2, version=2)
    return dict(epochs=(ea, eb), a=fleet_a.publisher.version,
                b=fleet_b.publisher.version)


def test_two_fleets_share_one_lease_authority(models):
    assert both(models, _shared_lease_authority) == dict(
        epochs=(1, 2), a=1, b=2)


def _rack_aware(S):
    fleet = S.serve.ServingFleet([S.engine() for _ in range(4)],
                                 host_groups=["rackA", "rackA", "rackB",
                                              "rackB"])
    store = fleet.prefix_store
    fleet.register_prefix(PREFIX)
    r = fleet.replicas
    modes = [store.ensure(r[0], PREFIX)]
    held = [rep.holds_prefix(tuple(PREFIX)) for rep in r]
    modes += [store.ensure(r[1], PREFIX), store.ensure(r[3], PREFIX)]
    counts = (sum(rep.engine.stats()["prefix_prefills"] for rep in r),
              sum(rep.engine.stats()["prefix_imports"] for rep in r))
    check_leaks_all(fleet)
    return dict(modes=modes, held=held, counts=counts)


def test_rack_aware_fanout_and_nearest_backfill(models):
    r = both(models, _rack_aware)
    assert r["modes"] == ["donor", "import", "import"]
    assert r["held"] == [True, False, True, False]
    assert r["counts"] == (1, 3)


# ---- in-place trainers: the published snapshot stays put -----------------

class InPlaceStreamTrainer(FakeStreamTrainer):
    """The port's trainers update their params in place."""

    def run_round(self):
        self.rounds += 1
        bump_in_place(self.state.params, 0.001)


def test_in_place_learner_step_leaves_replicas_on_the_snapshot(models):
    """The streaming learner publishes version 1 and then takes its next
    step in place: every replica (one local, one behind the wire codec)
    still holds version 1's weights bit for bit, and the learner's
    params moved on."""
    S = Side("port", models)
    S.obs._reset_for_tests()
    clock = FakeClock()
    h = S.serve.EngineRpcHandler(S.engine())
    remote = S.serve.RemoteReplica(
        "replica-1", S.serve.LoopbackTransport(h, target="replica-1",
                                               wire_codec=True),
        policy=_fast(S), clock=clock, sleep=lambda s: None)
    fleet = S.serve.ServingFleet([S.engine(), remote], clock=clock,
                                 probe_interval_s=0.0,
                                 retry_base_delay_s=0.0)
    start = {k: (v.clone() if isinstance(v, torch.Tensor)
                 else {kk: vv.clone() for kk, vv in v.items()})
             for k, v in S.params.items()}
    trainer = InPlaceStreamTrainer(S, start)
    _, _, svc, _, streamer = make_stream_stack(S, clock=clock,
                                               trainer=trainer, fleet=fleet)
    svc.start()
    streamer.offer(_eps(S, 4, version=svc.version))
    streamer.flush()
    assert svc.run_step()["version"] == 1
    snapshot = as_numpy(trainer.state.params)
    while not svc.pump_publish():
        pass
    streamer.offer(_eps(S, 2, version=1, start=4))
    streamer.flush()
    bump_in_place(trainer.state.params, 0.25)   # the next in-place step
    engines = [fleet.replicas[0].engine, h.engine]
    for eng in engines:
        assert trees_equal(eng.params, snapshot)
        assert not trees_equal(eng.params, trainer.state.params)
    assert [r.weight_version for r in fleet.replicas] == [1, 1]
    check_leaks_all(None, engines)
    S.obs._reset_for_tests()


def test_streaming_adapter_grpo_step_publishes_a_snapshot(models):
    """A real GRPO step (``StreamingTrainerAdapter``, the service's
    trainer, updating in place) behind the streaming learner: the fleet
    serves the published weights bit for bit; a second holder's steal
    fences the first learner (``LeaseLost`` at the gateway, and
    ``StalePublishError`` at the fleet's publisher once the new holder
    has published), and lease epochs only climb."""
    from senweaver_ide_tpu_torch.training import (GRPOConfig,
                                                  StreamingTrainerAdapter)
    from senweaver_ide_tpu_torch.training.trainer import (clone_params,
                                                          make_train_state)
    S = Side("port", models)
    S.obs._reset_for_tests()
    clock = FakeClock()
    state = make_train_state(S.config, torch.Generator().manual_seed(0),
                             None, learning_rate=1e-2, device="cpu")
    state.params = clone_params(S.params)
    adapter = StreamingTrainerAdapter(state, S.config, None,
                                      grpo_config=GRPOConfig())
    fleet, handler, svc, _, streamer = make_stream_stack(
        S, clock=clock, trainer=adapter)
    epochs = [svc.start()]
    rng = np.random.default_rng(0)
    eps = [S.exp.StreamedEpisode(
        episode_id=f"c0/r0/i{i}", group_key=f"c0/r0/g{i // 2}",
        prompt_ids=[1, 2, 3], completion_ids=[4 + i, 5, 6],
        reward=float(rng.standard_normal()), epoch=1, version=0,
        behavior_logp=[-1.0, -1.5, -0.5]) for i in range(4)]
    streamer.offer(eps)
    streamer.flush()
    before = as_numpy(adapter.state.params)
    r = svc.run_step()
    assert r["version"] == 1
    published = as_numpy(adapter.state.params)
    assert not trees_equal(published, before)
    while not svc.pump_publish():
        pass
    for rep in fleet.replicas:
        assert trees_equal(rep.engine.params, published)
    # a second holder steals the lease: the first one's publish is
    # refused at the gateway (its epoch is no longer the live lease) and,
    # once the new holder has published, at the fleet's own fence
    other = S.serve.FleetPublishClient(
        S.serve.LoopbackTransport(handler, target="fleet-gw"),
        name="learner-1", policy=_fast(S), clock=clock,
        sleep=lambda s: None)
    epochs.append(other.acquire_lease("learner-1", steal=True)["epoch"])
    with pytest.raises(S.res.LeaseLost):
        svc.client.publish(adapter.state.params, epoch=svc.epoch,
                           version=2)
    other.publish(adapter.state.params, epoch=epochs[-1], version=2)
    while fleet.publisher.in_progress:
        fleet.step()
    with pytest.raises(S.serve.StalePublishError):
        fleet.begin_publish(adapter.state.params, epoch=svc.epoch,
                            version=3)
    assert epochs == sorted(set(epochs)) == [1, 2]
    assert (fleet.publisher.epoch, fleet.publisher.version) == (2, 2)
    assert [r.weight_version for r in fleet.replicas] == [2, 2]
    for rep in fleet.replicas:
        assert trees_equal(rep.engine.params, published)
    check_leaks_all(fleet)
    S.obs._reset_for_tests()
