"""Trainer job runner: the control plane's execution side.

``ControlServer.submit`` records jobs; this module RUNS them — the piece
that makes ``senweaver-ctl submit '{"type": "grpo", ...}'`` actually
train (the reference's code-cli drives a live server the same way;
cli/src role, SURVEY.md §2.6 / §7 step 8).

A ``JobRunner`` owns one worker thread (device steps serialize on the card
anyway) draining a queue of submitted jobs. Job specs are dicts:

- ``{"type": "grpo", "tasks": [...], "rounds": N, "group_size": G,
   "ppo_epochs": E, "accum_steps": A}`` — N on-policy rounds through a
  session factory the host process supplies (the runner is transport;
  the factory decides policy/engine/workspace).
- ``{"type": "eval_rules", "rules": [...]}`` — score a rule-set over
  the 6-pattern suite (apo/eval.py), the APO beam's scoring unit.

Progress and results land on the Job record (visible over
``senweaver-ctl status`` / ``watch``); ``stop`` flips the job's status,
which the runner checks between rounds (cooperative cancel).
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional

from .control import ControlServer, Job


class JobRunner:
    """Single-worker executor wired into a ControlServer."""

    def __init__(self, server: ControlServer, *,
                 make_session: Callable[..., "RolloutSession"],
                 train_state=None, model_config=None, mesh=None,
                 reward_override=None, pad_id: int = 0,
                 max_len: Optional[int] = None,
                 apo=None, collector=None, engine=None, device=None):
        # Factory contract: make_session() for rollout episodes;
        # make_session(rules=[...]) for rule-scored eval sessions (the
        # rules render into the session's APO prompt section);
        # make_session(rules=..., thread_id=...) for the online loop.
        self.server = server
        self.make_session = make_session
        self.state = train_state
        self.model_config = model_config
        self.mesh = mesh
        self.reward_override = reward_override
        self.pad_id = pad_id
        self.max_len = max_len
        # Online-improvement cycle dependencies (job type "online"):
        # the APOService + shared collector (+ serving engine for
        # weight publication).
        self.apo = apo
        self.collector = collector
        self.engine = engine
        # where eval_rules jobs score their traces (None: evaluate_rules'
        # default, the card)
        self.device = device
        self._queue: "queue.Queue[Job]" = queue.Queue()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        server.on_submit = self._enqueue
        server.register("job_result", self._job_result)

    # -- server-side hooks -------------------------------------------------
    def _enqueue(self, job: Job) -> None:
        self._queue.put(job)

    def _job_result(self, params: Any) -> Dict[str, Any]:
        job_id = params.get("job_id") if isinstance(params, dict) else \
            str(params)
        job = self.server.jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job: {job_id}")
        return {"job_id": job_id, "status": job.status,
                "result": job.result}

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._work, daemon=True,
                                        name="senweaver-job-runner")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    # -- execution ---------------------------------------------------------
    def _work(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            # Status transitions race with the server thread's stop RPC;
            # the server's public check-and-set serializes them so a
            # stop is never clobbered.
            if not self.server.cas_job_status(job, "running"):
                continue                        # cancelled while queued
            try:
                job.result = self._run_job(job)
                self.server.cas_job_status(job, "done")
            except Exception as e:
                # result BEFORE status (a poller keying on the terminal
                # status must find the error populated), and the same
                # CAS discipline as the success path (a stop that
                # already ACKed must not be overwritten).
                job.result = {"error": f"{type(e).__name__}: {e}",
                              "traceback": traceback.format_exc()[-2000:]}
                self.server.cas_job_status(job, "failed")

    def _run_job(self, job: Job) -> Dict[str, Any]:
        spec = job.params if isinstance(job.params, dict) else {}
        kind = spec.get("type", "grpo")
        if kind == "grpo":
            return self._run_grpo(job, spec)
        if kind == "eval_rules":
            return self._run_eval_rules(spec)
        if kind == "online":
            return self._run_online(job, spec)
        raise ValueError(f"unknown job type {kind!r}")

    def _cancelled(self, job: Job) -> bool:
        return job.status == "stopped" or self._stop.is_set()

    def _run_grpo(self, job: Job, spec: Dict[str, Any]) -> Dict[str, Any]:
        if self.state is None or self.model_config is None:
            raise ValueError("runner was built without a train state")
        from ..training import grpo_round

        tasks = spec.get("tasks") or ["improve the workspace"]
        rounds = int(spec.get("rounds", 1))
        round_metrics = []
        for r in range(rounds):
            if self._cancelled(job):
                break
            out = grpo_round(
                self.state, self.model_config, self.mesh,
                self.make_session, tasks,
                group_size=int(spec.get("group_size", 2)),
                pad_id=self.pad_id, max_len=self.max_len,
                ppo_epochs=int(spec.get("ppo_epochs", 1)),
                accum_steps=int(spec.get("accum_steps", 1)),
                reward_override=self.reward_override)
            self.state = out.state
            round_metrics.append(
                {"round": r,
                 "episodes": len(out.episodes),
                 "reward_mean": (sum(e.reward for e in out.episodes)
                                 / max(len(out.episodes), 1)),
                 **{k: round(v, 6) for k, v in out.metrics.items()}})
        return {"rounds_done": len(round_metrics),
                "step": int(self.state.step),
                "metrics": round_metrics}

    def _run_online(self, job: Job, spec: Dict[str, Any]) -> Dict[str, Any]:
        """The full improvement cycle as a control-plane job: GRPO weight
        updates every round + the APO analyze/beam cycle on its gates
        (training/online.py). Requires the runner to be built with
        apo= and collector=."""
        if self.state is None or self.model_config is None:
            raise ValueError("runner was built without a train state")
        if self.apo is None or self.collector is None:
            raise ValueError("online jobs need apo= and collector= on "
                             "the runner")
        from ..training.online import OnlineImprovementLoop

        loop = OnlineImprovementLoop(
            self.state, self.model_config, self.mesh, self.make_session,
            spec.get("tasks") or ["improve the workspace"],
            apo=self.apo, collector=self.collector, engine=self.engine,
            group_size=int(spec.get("group_size", 2)),
            pad_id=self.pad_id, max_len=self.max_len,
            ppo_epochs=int(spec.get("ppo_epochs", 1)),
            # Default is concurrent collection (requires a thread_id-
            # aware factory); a runner built on the legacy rules-only
            # factory contract must SUBMIT {"max_parallel": 1} — serial
            # collection is the attribution-safe mode the loop accepts
            # for such factories.
            max_parallel=int(spec.get("max_parallel", 8)),
            reward_override=self.reward_override)
        rounds = []
        for _ in range(int(spec.get("rounds", 1))):
            if self._cancelled(job):
                break
            r = loop.run_round()
            rounds.append({"round": r.round_idx,
                           "reward_mean": round(r.reward_mean, 4),
                           "episodes": r.episodes,
                           "rules_active": len(r.rules),
                           "analyzed": r.analyzed,
                           "beam_ran": r.beam_ran})
        self.state = loop.state
        return {"rounds_done": len(rounds), "step": int(self.state.step),
                "optimized_rules": loop.current_rules(),
                "rounds": rounds}

    def _run_eval_rules(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        from ..apo.eval import evaluate_rules
        rules = list(spec.get("rules", []))
        score = evaluate_rules(rules, lambda r: self.make_session(rules=r),
                               **({} if self.device is None
                                  else {"device": self.device}))
        return {"rules": rules, "final_reward": score}
