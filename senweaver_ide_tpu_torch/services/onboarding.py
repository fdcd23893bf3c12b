"""First-run onboarding: a resumable setup wizard for the trainer host.

The reference ships an onboarding surface that walks a new user through
provider keys, model choice, and feature opt-ins before the IDE is
usable (`browser/senweaverOnboarding*` — the last IDE-chrome row of
SURVEY §2.5 without a TPU-side analogue). Re-centered for this build,
onboarding is OPERATOR-facing: before a training/serving job is
launched, the host needs a validated workspace, a resolvable model
preset, a provider whose capabilities entry exists, and an accelerator
posture ("gpu" vs "cpu-only") — exactly the things that otherwise fail
deep inside a job with an opaque traceback.

Design:
  - A fixed ordered list of steps, each with a validator; answers land
    in ``RuntimeConfig``'s user tier (the same tier the IDE's settings
    UI writes) so every later subsystem reads them the normal way.
  - State (current step, answers, completion stamp) persists as JSON
    next to the settings file — the wizard is resumable across
    restarts, like the reference's onboarding local-storage state.
  - ``install_onboarding_channel`` exposes the whole flow over the
    trainer's JSON-RPC control socket: status/answer/skip/reset. The
    C++ senweaver-ctl CLI or the dashboard can drive it remotely.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

ONBOARDING_VERSION = 1


@dataclass(frozen=True)
class Step:
    name: str
    prompt: str
    # validate(value, service) -> normalized value; raises ValueError
    validate: Callable[[Any, "OnboardingService"], Any]
    config_key: Optional[str] = None     # user-tier destination
    optional: bool = False


def _v_workspace(value: Any, svc: "OnboardingService") -> str:
    path = os.path.abspath(os.path.expanduser(str(value)))
    os.makedirs(path, exist_ok=True)
    if not os.access(path, os.W_OK):
        raise ValueError(f"workspace {path!r} is not writable")
    return path


def _v_model(value: Any, svc: "OnboardingService") -> str:
    from ..models.config import PRESETS
    name = str(value)
    if name not in PRESETS:
        raise ValueError(f"unknown model preset {name!r}; "
                         f"available: {sorted(PRESETS)}")
    return name


def _v_provider(value: Any, svc: "OnboardingService") -> str:
    from ..models.capabilities import _DEFAULT, get_model_capabilities
    from ..transport.providers import PROVIDERS
    name = str(value)
    if name not in PROVIDERS:
        raise ValueError(f"unknown provider {name!r}; "
                         f"available: {sorted(PROVIDERS)}")
    default_model = PROVIDERS[name].default_model
    if default_model:
        # get_model_capabilities never raises — it falls back to a
        # generic 128k entry; identity-check against the fallback, same
        # as the provider conformance test, so a provider whose default
        # model has no real DB entry fails HERE, not deep inside a job
        if get_model_capabilities(default_model) is _DEFAULT:
            raise ValueError(
                f"provider {name!r} default model {default_model!r} has "
                f"no capabilities entry (models/capabilities.py)")
    return name


def _v_accelerator(value: Any, svc: "OnboardingService") -> str:
    mode = str(value)
    if mode not in ("gpu", "cpu"):
        raise ValueError("accelerator must be 'gpu' or 'cpu'")
    if mode == "gpu" and not svc.probe_accelerator():
        raise ValueError("accelerator probe failed: no CUDA "
                         "device reachable (driver hung?); pick 'cpu' "
                         "or fix the platform and retry")
    return mode


def _v_metrics(value: Any, svc: "OnboardingService") -> bool:
    if isinstance(value, bool):
        return value
    s = str(value).lower()
    if s in ("true", "yes", "on", "1"):
        return True
    if s in ("false", "no", "off", "0"):
        return False
    raise ValueError("metrics opt-in must be a boolean")


STEPS: List[Step] = [
    Step("workspace", "Directory for job workspaces and traces",
         _v_workspace, config_key="workspace.root"),
    Step("model", "Policy model preset to train/serve",
         _v_model, config_key="model.preset"),
    Step("provider", "LLM provider for APO gradient/critique calls",
         _v_provider, config_key="transport.provider"),
    Step("accelerator", "Compute posture: 'gpu' (probed) or 'cpu'",
         _v_accelerator, config_key="runtime.accelerator"),
    Step("metrics", "Opt in to local metrics JSONL (true/false)",
         _v_metrics, config_key="metrics.enabled", optional=True),
]


class OnboardingService:
    """Drives the step list; persists progress; writes validated
    answers into the RuntimeConfig user tier."""

    def __init__(self, config, state_path: Optional[str] = None, *,
                 accelerator_probe: Optional[Callable[[], bool]] = None):
        self._config = config
        base = getattr(config, "_settings_path", None)
        self._state_path = state_path or (
            os.path.join(os.path.dirname(base), "onboarding.json")
            if base else os.path.abspath("onboarding.json"))
        self._probe = accelerator_probe
        self._state = self._load()

    # -- accelerator probe (injectable for hermetic tests) ---------------
    def probe_accelerator(self, timeout_s: float = 60.0) -> bool:
        """Probe in a KILLABLE SUBPROCESS, never in-process: a wedged
        accelerator tunnel hangs backend init forever inside C++, and
        this runs on the control server's single serve thread — an
        in-process CUDA init there would wedge every subsequent RPC. The
        child passes only when a one-element tensor round-trips through
        the card."""
        if self._probe is not None:
            return bool(self._probe())
        import subprocess
        import sys
        code = ("import torch; "
                "ok = torch.cuda.is_available() and torch.full((1,), 7.0)"
                ".cuda().cpu().item() == 7.0; "
                "raise SystemExit(0 if ok else 1)")
        try:
            return subprocess.run([sys.executable, "-c", code],
                                  capture_output=True,
                                  timeout=timeout_s).returncode == 0
        except Exception:
            return False

    # -- state ------------------------------------------------------------
    def _load(self) -> Dict[str, Any]:
        try:
            with open(self._state_path) as f:
                st = json.load(f)
            if (isinstance(st, dict)
                    and st.get("version") == ONBOARDING_VERSION):
                return st
        except Exception:
            pass
        return {"version": ONBOARDING_VERSION, "answers": {},
                "completed_at": None}

    def _save(self) -> None:
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._state, f, indent=1)
        os.replace(tmp, self._state_path)

    # -- wizard API --------------------------------------------------------
    @property
    def complete(self) -> bool:
        return self._state["completed_at"] is not None

    def current_step(self) -> Optional[Step]:
        for step in STEPS:
            if step.name not in self._state["answers"]:
                return step
        return None

    def status(self) -> Dict[str, Any]:
        cur = self.current_step()
        return {
            "complete": self.complete,
            "current": cur.name if cur else None,
            "prompt": cur.prompt if cur else None,
            "steps": [{"name": s.name, "optional": s.optional,
                       "done": s.name in self._state["answers"]}
                      for s in STEPS],
            "answers": dict(self._state["answers"]),
        }

    def answer(self, step_name: str, value: Any) -> Dict[str, Any]:
        step = next((s for s in STEPS if s.name == step_name), None)
        if step is None:
            raise ValueError(f"unknown onboarding step {step_name!r}")
        if value is None:
            # str(None) would validate as the literal answer "None"
            # (e.g. a workspace directory named None); a missing value
            # is a caller error, not an answer — skip() is the explicit
            # way to decline an optional step
            raise ValueError(f"step {step_name!r} requires a value")
        normalized = step.validate(value, self)
        self._state["answers"][step.name] = normalized
        if step.config_key is not None:
            self._config.set_user(step.config_key, normalized)
        self._maybe_complete()
        self._save()
        return self.status()

    def skip(self, step_name: str) -> Dict[str, Any]:
        step = next((s for s in STEPS if s.name == step_name), None)
        if step is None:
            raise ValueError(f"unknown onboarding step {step_name!r}")
        if not step.optional:
            raise ValueError(f"step {step_name!r} is required")
        self._state["answers"][step.name] = None
        self._maybe_complete()
        self._save()
        return self.status()

    def reset(self) -> None:
        self._state = {"version": ONBOARDING_VERSION, "answers": {},
                       "completed_at": None}
        self._save()

    def _maybe_complete(self) -> None:
        if all(s.name in self._state["answers"] for s in STEPS):
            self._state["completed_at"] = time.time()


def install_onboarding_channel(server, svc: OnboardingService) -> None:
    """Expose the wizard over the trainer's JSON-RPC control socket:
    onboarding.status / onboarding.answer {step, value} /
    onboarding.skip {step} / onboarding.reset."""

    def _status(params: Any) -> Dict[str, Any]:
        return svc.status()

    def _answer(params: Any) -> Dict[str, Any]:
        if not isinstance(params, dict) or "step" not in params:
            raise ValueError("onboarding.answer expects {step, value}")
        return svc.answer(str(params["step"]), params.get("value"))

    def _skip(params: Any) -> Dict[str, Any]:
        if not isinstance(params, dict) or "step" not in params:
            raise ValueError("onboarding.skip expects {step}")
        return svc.skip(str(params["step"]))

    def _reset(params: Any) -> Dict[str, Any]:
        svc.reset()
        return svc.status()

    server.register("onboarding.status", _status)
    server.register("onboarding.answer", _answer)
    server.register("onboarding.skip", _skip)
    server.register("onboarding.reset", _reset)
