"""The port's copies of the JAX package's host-pure modules must not
drift: each file below equals its JAX original once every whole-word
``senweaver_ide_tpu`` reads ``senweaver_ide_tpu_torch``, apart from the
few comment lines ``REWORDED_LINES`` names.
This stands in for re-running the JAX package's host-plane suites
(agents, tools, prompts, sessions, obs) against the copies. A copy that
has to differ otherwise goes on ``ALLOWED_TO_DIFFER`` with the
reason."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = (
    "obs/metrics", "obs/tracing", "obs/propagation", "obs/incidents",
    "obs/alerts", "obs/federation", "obs/slo", "obs/timeline",
    "obs/training_health", "obs/telemetry", "obs/__init__",
    "resilience/faults", "resilience/retry", "resilience/guard",
    "context/token_config",
    "tools/types", "tools/registry", "tools/sandbox", "tools/search_replace",
    "tools/terminal", "tools/service", "tools/sidecars", "tools/documents",
    "tools/__init__",
    "agents/llm", "agents/registry", "agents/subagent", "agents/scheduler",
    "agents/loop", "agents/__init__",
    "prompts/grammar", "prompts/system", "prompts/fitting",
    "prompts/__init__",
    "editor/fast_apply", "services/skills", "rollout/checkpoints",
    "models/tokenizer",
    "traces/schema", "traces/features", "traces/store", "traces/uploader",
    "traces/collector", "traces/__init__",
    "rollout/policy_client", "rollout/session", "rewards/__init__",
    "apo/types", "apo/patterns", "apo/report", "apo/rollouts",
    "apo/gradient", "apo/segments", "apo/synthetic", "apo/service",
    "apo/__init__",
)

# 1-based lines of the JAX files whose comment dates a feature by the
# numbered change that brought it; the copies reword those lines to say
# what the feature is, and every other line must match.
REWORDED_LINES = {
    "resilience/guard": (24,),
    "obs/propagation": (3,),
    "obs/telemetry": (63, 184, 191),
    "obs/training_health": (3, 45),
}

# module -> why the port's file differs from the JAX one (none today:
# the trimmed package __init__s and the torch rewrites are not copies)
ALLOWED_TO_DIFFER = {}

_NAME = re.compile(r"\bsenweaver_ide_tpu\b")


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_jax_original(module):
    with open(os.path.join(ROOT, "senweaver_ide_tpu", module + ".py")) as f:
        want = _NAME.sub("senweaver_ide_tpu_torch", f.read())
    with open(os.path.join(ROOT, "senweaver_ide_tpu_torch",
                           module + ".py")) as f:
        got = f.read()
    reworded = REWORDED_LINES.get(module, ())
    if reworded:
        want_l, got_l = want.splitlines(), got.splitlines()
        assert len(got_l) == len(want_l), module
        for n in reworded:
            assert got_l[n - 1] != want_l[n - 1], (module, n)
            got_l[n - 1] = want_l[n - 1]
        got = "\n".join(got_l) + "\n"
    if module in ALLOWED_TO_DIFFER:
        assert got != want, f"{module} is allowlisted but no longer differs"
        return
    assert got == want, (f"senweaver_ide_tpu_torch/{module}.py drifted from "
                         f"its JAX original")


def test_allowlist_and_edits_name_copies():
    assert set(ALLOWED_TO_DIFFER) <= set(COPIES)
    assert set(REWORDED_LINES) <= set(COPIES)
