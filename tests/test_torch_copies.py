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
    "runtime/msgpack_lite", "runtime/control", "runtime/__init__",
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
    # the JSONL reports, host-pure: a ``.py`` entry names a script of the
    # repo, and its copy is the ``torch_`` file beside it
    "scripts/serve_report.py", "scripts/prefix_report.py",
    "scripts/resilience_report.py", "scripts/analysis_report.py",
    # the flash-kernel eval, rewritten (ALLOWED_TO_DIFFER)
    "eval_flash_chip.py",
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
    # the runner takes the device its eval_rules jobs score on and passes
    # it to evaluate_rules (the signature, the attribute, the call); the
    # docstring's "TPU steps serialize on the chip" says the card
    "runtime/jobs": 4,
    # the accelerator posture is 'gpu' or 'cpu', probed in a killable
    # subprocess that imports torch and round-trips a CUDA tensor: the
    # module docstring's posture, the validator, the step's description
    # and the probe's docstring and code (two hunks)
    "services/onboarding": 5,
    # the public entry points. A quickstart runs on the card unless given
    # --cpu: the flag and the device it resolves (resolve_device) replace
    # JAX's forced CPU platform; torch.Generator seeds replace PRNGKeys;
    # every engine, train state and collector's reward head gets the
    # device; and the usage lines name the torch_ file.
    # serve: the docstring's card and usage, the flag's help, import
    # torch and resolve_device, the device after the imports,
    # load_hf_params, init_params and the engine, each a hunk
    "examples/serve.py": 8,
    # train_grpo: usage, two imports, the flag with import torch and
    # resolve_device, two imports, the device after them, the train
    # state, the session's collector
    "examples/train_grpo.py": 8,
    # online_cycle: usage, an import, the platform line, two imports, the
    # flag, the device, the train state with the collector, the APO
    # service's device
    "examples/online_cycle.py": 9,
    # qlora: usage, the card in the docstring, an import, import torch,
    # the platform line, two imports, the flag, the device, init_params,
    # the adapters' generator, the engine, the session's collector
    "examples/qlora_quickstart.py": 13,
    # control_plane: the ctl source path in the docstring, usage, the
    # import line, import torch, three imports, the flag with the device,
    # the train state, the session's collector, the runner's device, the
    # rebuild hint's source path
    "examples/control_plane.py": 12,
    # dashboard_demo: usage, an import, the platform line, an import, the
    # flag, the device, the collector
    "examples/dashboard_demo.py": 7,
    # The report selftests take ``device`` (default the card; --cpu on the
    # command line), resolve it first, run under preserved_obs (the
    # process's observability globals come back as they were) and draw
    # the tiny weights on the host from a torch.Generator seed before
    # moving them to the device, so the card and the CPU run the same
    # weights. Hunks common to each: the docstring's "CPU" proof (the
    # card or the CPU), the two module-level imports, the decorated
    # signature, resolve_device for the platform line, the model imports,
    # the weights, the --cpu flag and its use in main; then each
    # engine's device and:
    # kv_quant: the acceptance the docstring names by a number, the
    # pools' device (two), the host tier's and the export's host tensors
    # (two) where JAX asserts numpy arrays
    "scripts/kv_quant_report.py": 14,
    # kv_pressure: the acceptance named, the host-tier export's host
    # tensors
    "scripts/kv_pressure_report.py": 11,
    # spec: _drifted on host draws over flatten_params, the draft
    # teacher's weights, a second engine
    "scripts/spec_report.py": 12,
    # group_tree: the acceptance named
    "scripts/group_tree_report.py": 10,
    "scripts/migration_report.py": 9,
    # learner: the trainer's weight bump over flatten_params, its import
    "scripts/learner_report.py": 11,
    "scripts/remote_fleet_report.py": 9,
    "scripts/slo_report.py": 9,
    # fleet_obs: the acceptance named; the two engine scenarios take the
    # device (signature, imports, weights and engine each), the second
    # scenario's publish weights, the selftest passing the device on
    "scripts/fleet_obs_report.py": 17,
    # training_health: no weights; the diagnostics head's device through
    # _round_health (its signature, the launch and three calls); the
    # selftest flag's help without "CPU"
    "scripts/training_health_report.py": 11,
    # obs: --health reads the torch_ training-health report beside it
    "scripts/obs_report.py": 1,
    # The research evals at the repo root (torch_eval_*.py beside each
    # eval_*.py). Each runs on the card unless given --cpu: the flag and
    # the device it resolves replace JAX's forced CPU platform (the flag
    # and the device are one hunk each wherever they stand apart);
    # torch.Generator seeds replace PRNGKeys; every engine, train state,
    # reward head and session collector gets the device; a sibling eval
    # is imported as its torch_ file; the usage line names the torch_
    # file; the error line's comment says whom it is for (the caller).
    # Then each file's own hunks:
    # uplift_real (the base): device_collector (a TraceCollector whose
    # reward head scores on the run's device), load_policy's signature,
    # imports, template and engine (four), pretrain's signature,
    # docstring, imports, device, train state and engine (six), the
    # pretrain and probe sessions' collectors, the scorer's docstring
    # with its torch import, its sessions' collector, its batch scored
    # on the engine's device, the run's corpus (a comment where the
    # collector import stood, the collector, make_local_apo's device),
    # main's device passed to load_policy and pretraining
    "eval_uplift_real.py": 26,
    # online_real: the signature, device_collector imported where the
    # collector import stood, load_policy's and pretraining's device,
    # the shared collector and the APO service on the engine's device;
    # --ckpt has no default path (a fixed directory may hold another
    # package's or another checkout's checkpoint): it pretrains
    "eval_online_real.py": 13,
    "eval_prompt_frontier.py": 8,
    "eval_seed_robustness.py": 8,
    # generative: the proposer LM trains and serves on the device
    "eval_uplift_generative.py": 10,
    # capacity: --accel accepted and changing nothing (its help), the
    # device through both pretraining paths and load_policy; --init-from's
    # help names the port's checkpoint, not a fixed directory
    "eval_capacity.py": 12,
    # capacity_probe: --load-dir is required (no fixed directory that
    # may hold another package's or another checkout's checkpoint)
    "eval_capacity_probe.py": 8,
    # learning: --accel as in capacity; the generator helper, the
    # session's collector
    "eval_learning.py": 13,
    # moe_int8: the forward returns the logits alone (no cache), under
    # no_grad, on the params' device; the greedy loop likewise
    "eval_moe_int8.py": 13,
    # speculative: two seeded generators on the device (the unrelated
    # draft init as JAX's two keys); two docstring lines say what the
    # artifact is without naming who reads it
    "eval_speculative.py": 10,
    # uplift: the scripted policy's reward head and the --model-dir
    # engine on the device (the checkpoint loads there)
    "eval_uplift.py": 5,
    # onepointfiveb: cuda_gb (peak CUDA memory beside peak RSS), the
    # training forward on the flash-attention kernel (attn_impl="flash";
    # its plain version on CPU tensors), host batches as tensors
    "eval_onepointfiveb.py": 13,
    # sevenb: sizing_table against the card's own memory (card, hbm_gb,
    # fits_card and the decode slots; None on the CPU) in place of the
    # 16 GB TPU budget, its docstring lines; streamed_int8_init's numpy
    # stream unchanged, each finished tensor moved to the device; the
    # leaf count over dicts; the fsdp=8 note without its TPU claim; the
    # engine serves from the paged int8 pool (K1 dequantizes as it
    # reads; kv_quant's slot cache decodes with plain attention); the
    # QLoRA step's forward on the flash-attention kernel; peak CUDA
    # memory beside peak RSS
    "eval_sevenb.py": 38,
    # hf_roundtrip: leaves compared by flatten_params, the load and both
    # engines on the params' device; --ckpt has no default path (as
    # online_real's): it pretrains
    "eval_hf_roundtrip.py": 17,
    # The root entry points. Each runs on the card unless given --cpu
    # (device="cpu" for a caller): the flag and resolve_device replace
    # JAX's platform handling; torch.Generator seeds replace PRNGKeys;
    # every measure, case, engine, pool and train state takes the device.
    # bench: the docstring's card and its failure contract, the cache's
    # comment and path (no last-known-good cache), the timing comment,
    # BASELINE.json beside the script; the cache, artifact-summary and
    # backend-probe helpers replaced by the port's (_generator,
    # _tiny_params, _sync, _device_info: the card's name and the
    # nvidia-smi power limit on the line); _measure's device, generators,
    # host copy for the wait; _init_int8_params on a generator's device;
    # _measure_steps' int8 KV cache as the config's kv_quant; _PEAK_FLOPS
    # keyed by torch.cuda.get_device_name (H100 989e12, no mfu on an
    # unknown card); _measure_train's optimizer (make_optimizer: clip 1.0,
    # AdamW b2 0.95, both moments in the params' bf16) and torch batch;
    # each protocol case's params= (JAX's tree through params_from_numpy)
    # and device=, its import block, weights line and each engine's or
    # pool's device; the streaming arm trains its own copy of the params
    # (in-place steps) and counts trained episodes, not steps (a step
    # takes every ready group: JAX's loop of n_rounds steps can wait
    # forever); main's --cpu and device in place of the probe, no
    # try/except around a row or case (a failure raises), the scan row
    # without the host-loop fallback, extra["device"], no cache write or
    # artifact summaries, no _error_line, no watchdog: 159 hunks
    "bench.py": 159,
    # perf_gate: the docstring (the card, kernel builds as the window's
    # compiles, the port's own uncommitted baseline file, usage), the
    # default baseline path, the band comment; _tiny_params and _sync;
    # each case's device argument, weights, engines, the train batch on
    # the device, the reward head's features; measure()'s device and
    # card name; selftest's per-shape build cache (_built_per_shape) in
    # place of jax.jit retraces, its device; main's --cpu
    "scripts/perf_gate.py": 72,
    # __graft_entry__: the docstring and usage; torch for jax; _placement
    # (a card a rank over NCCL, ranks sharing card 0 over gloo, gloo on
    # the host for device="cpu") in place of the CPU-platform switch;
    # entry()'s device, preset and params= arguments and its torch
    # forward; dryrun_multichip spawns one process a rank (_rank_main)
    # and returns rank 0's losses, checked across ranks; its sequence is
    # dryrun_rank: ranks as mesh devices, generators, host batches placed
    # for the mesh (place_batch_for_mesh), the losses recorded, each line
    # tagged with the rank and its placement, the QLoRA fold on the
    # gathered base, the hybrid case on its members, pp and ep on ranks
    # 0-1 (the pp weights and the ep layer from weights= when given, the
    # logits and each ep rank's rows returned); __main__'s flags
    "__graft_entry__.py": 28,
}

# Copies whose named hunks above include pure drops of JAX lines: module
# -> how many. bench: the backend probe, eleven measures' ``import jax``
# lines (the prefix case's numpy import with them), the scan row's
# host-loop fallback, the cache write and artifact summaries,
# _error_line;
# __graft_entry__: the hybrid case's train state, rebuilt on the mesh's
# members. Every other copy drops nothing.
DROPPED = {"bench.py": 15, "__graft_entry__.py": 1}

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
    # a numbered change and TPU memory (HBM) in comments; the metric
    # names stay
    "services/dashboard": (192, 626),
    "transport/native_clients": (6,),
    # the control server's path named the JAX package
    "native/senweaver_ctl.cpp": (7,),
}

# module -> why the port's file differs from the JAX one (the trimmed
# package __init__s and the torch rewrites are not copies)
ALLOWED_TO_DIFFER = {
    "eval_flash_chip.py": "its sections are functions the tests run "
    "alone (parity on the CPU through the plain versions), a failing "
    "section raises where JAX's catches it into an *_error key, and the "
    "card's name, power limit and kernels_ok replace interpret_mode and "
    "lowered_on_tpu",
}

_NAME = re.compile(r"\bsenweaver_ide_tpu\b")

# a script whose copy is not torch_ + its name
RENAMED = {"__graft_entry__.py": "torch_graft_entry.py"}


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
    """(original, copy): a module of each package; for a ``.cpp`` entry
    the repo's native/ file and the port's copy of it; for a ``.py`` entry
    a script of the repo and its ``torch_`` copy beside it."""
    if module.endswith(".cpp"):
        return (os.path.join(ROOT, module),
                os.path.join(ROOT, "senweaver_ide_tpu_torch", module))
    if module.endswith(".py"):
        folder, name = os.path.split(module)
        return (os.path.join(ROOT, module),
                os.path.join(ROOT, folder, RENAMED.get(name,
                                                       "torch_" + name)))
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
    assert got == want, f"the copy {copy} drifted from its JAX original"


def test_allowlist_and_edits_name_copies():
    assert set(ALLOWED_TO_DIFFER) <= set(COPIES)
    assert set(REWORDED_LINES) <= set(COPIES)
    assert not set(PATCHED) & set(COPIES)
    assert set(DROPPED) <= set(PATCHED)


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
    # the port's hunks add or replace; they drop JAX lines outright only
    # where DROPPED names the drops
    assert sum(tag == "delete" for tag, *_ in hunks) == DROPPED.get(
        module, 0)


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
