"""The port's copies of the JAX package's host-pure modules must not
drift: each file below equals its JAX original once every whole-word
``senweaver_ide_tpu`` reads ``senweaver_ide_tpu_torch``, apart from the
few comment lines ``REWORDED_LINES`` names.
This stands in for re-running the JAX package's host-plane suites
(agents, tools, prompts, sessions, obs) against the copies. A copy that
has to differ otherwise goes on ``ALLOWED_TO_DIFFER`` with the
reason."""

import difflib
import os
import re

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COPIES = (
    "obs/metrics", "obs/tracing", "obs/propagation", "obs/incidents",
    "obs/alerts", "obs/federation", "obs/slo", "obs/timeline",
    "obs/training_health", "obs/telemetry", "obs/__init__",
    "resilience/faults", "resilience/retry", "resilience/guard",
    "context/token_config", "context/cache", "context/estimator",
    "context/manager_types", "context/compressor", "context/tracker",
    "context/rate_limiter", "context/manager", "context/__init__",
    "models/capabilities", "editor/autocomplete",
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
    "rollout/policy_client", "rollout/session", "rollout/kv_pressure",
    "rollout/spec_controller", "rollout/group_tree",
    "rewards/__init__",
    "apo/types", "apo/patterns", "apo/report", "apo/rollouts",
    "apo/gradient", "apo/segments", "apo/synthetic", "apo/service",
    "apo/__init__",
    "resilience/lease", "resilience/__init__",
    "serve/admission", "serve/router",
    "serve/prefix_store", "serve/frontend", "serve/scheduler",
    "serve/autoscale", "serve/learner",
    "serve/learner_server", "serve/__init__",
    "runtime/msgpack_lite", "runtime/control", "runtime/jobs",
    "runtime/__init__",
    "transport/providers", "transport/http_client",
    "transport/native_clients", "transport/__init__",
    "services/config", "services/metrics", "services/collaboration",
    "services/extensions", "services/scm", "services/model_refresh",
    "services/dashboard", "services/__init__",
    "editor/diff_zones", "editor/edit_prediction", "editor/__init__",
    "tools/search_engines", "rewards/reference_impl",
    # the static-analysis gate: pure AST and threading, pointed at the
    # port by the name swap (its package root and lock-order scope)
    "analysis/__init__", "analysis/__main__", "analysis/findings",
    "analysis/jit_lint", "analysis/lock_lint", "analysis/lock_order",
    "analysis/metric_lint", "analysis/resource_lint", "analysis/rpc_lint",
    # the native sources, held to the repo's native/ (a ``.cpp`` entry
    # names the file itself)
    "native/trace_ring.cpp", "native/senweaver_ctl.cpp",
)

# Copies with a few hunks of their own, each named with its reason; the
# rest of the file must match the JAX original line for line, so the
# number of differing hunks (difflib opcodes) is part of the contract.
PATCHED = {
    # the roll holds its own copy of the params (torch tensors are
    # mutable; a trainer steps in place mid-roll): an import, the one
    # changed line in begin(), the _snapshot method
    "serve/weights": 3,
    # decoded payloads move to the engine's device before import_prefix
    # and update_params: an import, two handler bodies
    "serve/remote_server": 3,
    # a submit whose cached prefix id the engine already dropped
    # re-registers the prefix instead of faulting the replica to death
    "serve/replica": 1,
    # wire request ids carry a per-client nonce, so a new fleet's
    # idempotency keys never replay an earlier client's cached response:
    # an import, the nonce, _request_id, its use in _call
    "serve/remote": 4,
    # ChaosEngine forwards a write to an attribute its engine has
    # (attach_migration's migrate_on_pressure): the __setattr__ method
    "resilience/chaos": 1,
    # the port builds its own copies of the native sources with g++ into
    # its own _build/, never through native/Makefile into the JAX
    # package: the module docstring (two hunks), the build and source
    # paths with the Makefile's flags (two), build_native's docstring
    # and body (two), the pipeline the tokenizer feeds (one)
    "runtime/native": 7,
    # the accelerator posture is 'gpu' or 'cpu', probed in a killable
    # subprocess that imports torch and round-trips a CUDA tensor: the
    # module docstring's posture, the validator, the step's description
    # and the probe's docstring and code (two hunks)
    "services/onboarding": 5,
}

# 1-based lines of the JAX files whose comment dates a feature by the
# numbered change that brought it; the copies reword those lines to say
# what the feature is, and every other line must match.
REWORDED_LINES = {
    "resilience/guard": (24,),
    # the lines below name a numbered change, a TPU transfer, jit or
    # jax.device_put; the copies say what is meant without them
    "resilience/lease": (4,),
    "serve/prefix_store": (18,),
    "serve/learner": (3, 564, 840),
    "serve/learner_server": (210,),
    "obs/propagation": (3,),
    "obs/telemetry": (63, 184, 191),
    "obs/training_health": (3, 45),
    # a TPU step and TPU memory (HBM) in comments, a numbered change and
    # an earlier round; the metric names stay
    "runtime/jobs": (8,),
    "services/dashboard": (192, 626),
    "transport/native_clients": (6,),
    # the control server's path named the JAX package
    "native/senweaver_ctl.cpp": (7,),
}

# module -> why the port's file differs from the JAX one (none today:
# the trimmed package __init__s and the torch rewrites are not copies)
ALLOWED_TO_DIFFER = {}

_NAME = re.compile(r"\bsenweaver_ide_tpu\b")


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


def _sources(module):
    """(original, copy): a module of each package, or for a ``.cpp``
    entry the repo's native/ file and the port's copy of it."""
    if module.endswith(".cpp"):
        return (os.path.join(ROOT, module),
                os.path.join(ROOT, "senweaver_ide_tpu_torch", module))
    return (os.path.join(ROOT, "senweaver_ide_tpu", module + ".py"),
            os.path.join(ROOT, "senweaver_ide_tpu_torch", module + ".py"))


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_jax_original(module):
    original, copy = _sources(module)
    with open(original) as f:
        want = _NAME.sub("senweaver_ide_tpu_torch", f.read())
    with open(copy) as f:
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
    assert not set(PATCHED) & set(COPIES)


@pytest.mark.parametrize("module", sorted(PATCHED))
def test_patched_copy_differs_only_in_its_hunks(module):
    original, copy = _sources(module)
    with open(original) as f:
        want = _NAME.sub("senweaver_ide_tpu_torch", f.read()).splitlines()
    with open(copy) as f:
        got = f.read().splitlines()
    hunks = [op for op in difflib.SequenceMatcher(
        None, want, got, autojunk=False).get_opcodes() if op[0] != "equal"]
    assert len(hunks) == PATCHED[module], [
        (tag, want[i1:i2], got[j1:j2]) for tag, i1, i2, j1, j2 in hunks]
    # the port's hunks add or replace; they never drop JAX lines outright
    assert all(tag != "delete" for tag, *_ in hunks)


def _spec_tuple(spec):
    """A JAX PartitionSpec as the port's plain tuple."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


@pytest.mark.parametrize("table", ["PARAM_SPECS", "MOE_PARAM_SPECS",
                                   "MOE_SCALE_SPECS", "ACT_SPEC",
                                   "LOGITS_SPEC", "KV_CACHE_SPEC"])
def test_sharding_tables_equal_jax(table):
    """parallel/sharding.py's tables hold JAX's PartitionSpecs entry by
    entry as plain tuples (the port's sharding is a rewrite, not a copy:
    it returns each rank's shards)."""
    from senweaver_ide_tpu.parallel import sharding as jsh
    from senweaver_ide_tpu_torch.parallel import sharding as tsh
    want, got = getattr(jsh, table), getattr(tsh, table)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == _spec_tuple(want[k]), k
    else:
        assert got == _spec_tuple(want)
