"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package (by AST scan and by importing it under an import blocker), and
its entry points refuse to run without a card unless asked for the
CPU."""

import ast
import os
import subprocess
import sys

import jax  # noqa: F401  (test files import both frameworks)
import pytest
import torch

import senweaver_ide_tpu_torch
from senweaver_ide_tpu_torch.models import (init_params, params_from_numpy,
                                            tiny_test)
from senweaver_ide_tpu_torch.rollout import (PagedSeqKV, RolloutEngine,
                                             init_paged_pool)
from test_torch_copies import RENAMED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(senweaver_ide_tpu_torch.__file__)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "safetensors",
          "ml_dtypes", "senweaver_ide_tpu")


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


def _banned(module: str) -> bool:
    """Exact match on the top-level name: ``senweaver_ide_tpu_torch``
    shares a prefix with ``senweaver_ide_tpu`` but is not it."""
    return module.split(".")[0] in BANNED


def _entry_files(folder):
    """The port's scripts in ``folder`` of the repo: the ``torch_`` files."""
    return sorted(os.path.join(ROOT, folder, f)
                  for f in os.listdir(os.path.join(ROOT, folder))
                  if f.startswith("torch_") and f.endswith(".py"))


def _eval_files():
    """The research evals' ports: ``torch_eval_*.py`` at the repo root."""
    return sorted(os.path.join(ROOT, f) for f in os.listdir(ROOT)
                  if f.startswith("torch_eval_") and f.endswith(".py"))


# the root entry points' ports (bench.py, __graft_entry__.py)
ROOT_ENTRIES = ("torch_bench.py", "torch_graft_entry.py")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    out += _entry_files("scripts") + _entry_files("examples")
    out += _eval_files() + [os.path.join(ROOT, f) for f in ROOT_ENTRIES]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_banned_matches_exact_module_names():
    assert _banned("senweaver_ide_tpu") and _banned("senweaver_ide_tpu.ops")
    assert _banned("jax.numpy") and _banned("optax")
    assert _banned("safetensors.numpy") and _banned("ml_dtypes")
    assert not _banned("senweaver_ide_tpu_torch")
    assert not _banned("senweaver_ide_tpu_torch.models")
    assert not _banned("jaxtyping_like")


def test_no_jax_imports_in_port_sources():
    files = _port_files()
    assert len(files) > 10 and files[0].endswith("chip_smoke.py")
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [(path, n) for n in names if _banned(n)]
    assert bad == []


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
BANNED = {banned!r}

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BANNED:
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Blocker())
import senweaver_ide_tpu_torch as pkg
n = 0
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    n += 1
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print("imported", n)
"""


# modules whose scan the tests above must include: each slice's new ones
PORTED_MODULES = ("rollout/speculative", "rollout/spec_controller",
                  "rollout/group_tree", "rollout/paged_kv",
                  "rollout/engine", "training/draft_distill",
                  "training/rl_loop", "rollout/adapter_pool",
                  "rollout/migration", "models/transformer",
                  "models/quantize", "parallel/expert", "parallel/__init__",
                  "models/capabilities", "context/manager",
                  "editor/autocomplete",
                  "resilience/lease", "resilience/chaos",
                  "resilience/__init__", "serve/__init__",
                  "serve/admission", "serve/autoscale", "serve/frontend",
                  "serve/learner", "serve/learner_server",
                  "serve/placement", "serve/prefix_store", "serve/remote",
                  "serve/remote_server", "serve/replica", "serve/router",
                  "serve/rpc", "serve/scheduler", "serve/weights",
                  "runtime/__init__", "runtime/msgpack_lite",
                  "runtime/control", "runtime/native", "runtime/jobs",
                  "transport/__init__", "transport/providers",
                  "transport/http_client", "transport/native_clients",
                  "services/__init__", "services/config",
                  "services/metrics", "services/collaboration",
                  "services/extensions", "services/scm",
                  "services/model_refresh", "services/dashboard",
                  "services/onboarding", "editor/__init__",
                  "editor/diff_zones", "editor/edit_prediction",
                  "tools/__init__", "tools/search_engines",
                  "rewards/reference_impl", "parallel/mesh",
                  "parallel/comm", "parallel/sharding",
                  "parallel/distributed", "parallel/ring_attention",
                  "parallel/pipeline", "analysis/__init__",
                  "analysis/__main__", "analysis/findings",
                  "analysis/jit_lint", "analysis/lock_lint",
                  "analysis/lock_order", "analysis/metric_lint",
                  "analysis/resource_lint", "analysis/rpc_lint")


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_scan_covers_module(module):
    assert os.path.join(PKG, module + ".py") in _port_files()


# the public entry points: the quickstarts, and the reports with a device
# selftest (the JSONL-only reports touch no device)
EXAMPLES = ("serve", "train_grpo", "online_cycle", "qlora_quickstart",
            "control_plane", "dashboard_demo")
REPORTS = ("kv_quant", "kv_pressure", "spec", "group_tree", "migration",
           "learner", "remote_fleet", "slo", "fleet_obs", "training_health")
JSONL_REPORTS = ("obs", "serve", "prefix", "resilience", "analysis")
# the research evals (torch_eval_<name>.py at the repo root)
EVALS = ("capacity", "capacity_probe", "flash_chip", "hf_roundtrip",
         "learning", "moe_int8", "onepointfiveb", "online_real",
         "prompt_frontier", "seed_robustness", "sevenb", "speculative",
         "uplift", "uplift_generative", "uplift_real")
# the flags an eval cannot start without (the probe reads a checkpoint it
# is given; the card is refused before anything is read)
EVAL_ARGV = {"capacity_probe": ["--load-dir", "no_such_ckpt"]}


def test_scan_covers_every_port_script():
    files = _port_files()
    for name in EXAMPLES:
        assert os.path.join(ROOT, "examples", f"torch_{name}.py") in files
    for name in REPORTS + JSONL_REPORTS:
        assert os.path.join(ROOT, "scripts",
                            f"torch_{name}_report.py") in files
    for name in ("serving_profile", "train_profile", "flash_ab",
                 "k1_host_cost", "mesh_nccl", "smoke_parallel"):
        assert os.path.join(ROOT, "scripts", f"torch_{name}.py") in files
    for name in EVALS:
        assert os.path.join(ROOT, f"torch_eval_{name}.py") in files
    for name in ROOT_ENTRIES:
        assert os.path.join(ROOT, name) in files
    assert os.path.join(ROOT, "scripts", "torch_perf_gate.py") in files


def test_every_jax_root_entry_point_has_its_port():
    """Every script outside the JAX package and the tests that imports
    the JAX package has a torch_ file beside it."""
    missing = []
    for folder in ("", "scripts", "examples"):
        here = os.path.join(ROOT, folder)
        for f in sorted(os.listdir(here)):
            if not f.endswith(".py") or f.startswith("torch_") \
                    or f == "chip_smoke.py":
                continue
            with open(os.path.join(here, f)) as fh:
                tree = ast.parse(fh.read())
            names = [a.name for n in ast.walk(tree)
                     if isinstance(n, ast.Import) for a in n.names]
            names += [n.module or "" for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom) and n.level == 0]
            if not any(n.split(".")[0] == "senweaver_ide_tpu"
                       for n in names):
                continue
            port = RENAMED.get(f, "torch_" + f)
            if not os.path.exists(os.path.join(here, port)):
                missing.append(os.path.join(folder, f))
    assert missing == []


def test_every_jax_eval_has_its_port():
    jax_evals = sorted(f[len("eval_"):-3] for f in os.listdir(ROOT)
                       if f.startswith("eval_") and f.endswith(".py"))
    assert jax_evals == sorted(EVALS)
    assert [os.path.basename(p) for p in _eval_files()] == sorted(
        f"torch_eval_{n}.py" for n in EVALS)


def test_port_imports_with_jax_blocked():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.format(banned=BANNED)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert int(res.stdout.split()[-1]) >= 14


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_a_card(no_cuda):
    cfg = tiny_test()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_paged_pool(cfg, 4, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedSeqKV(cfg, max_len=16, block_size=4)
    PagedSeqKV(cfg, max_len=16, block_size=4, device="cpu")
    params = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutEngine(params, cfg)
    RolloutEngine(params, cfg, device="cpu")


def test_adapter_pool_refuses_without_a_card(no_cuda):
    from senweaver_ide_tpu_torch.rollout import AdapterPool
    cfg = tiny_test()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AdapterPool(cfg)
    pool = AdapterPool(cfg, device="cpu")
    assert all(a.device.type == "cpu"
               for bank in pool.banks() for a in bank.values())
    # a CPU pool on a CPU engine; the engine refuses a pool elsewhere
    params = init_params(cfg, torch.Generator(), device="cpu")
    RolloutEngine(params, cfg, adapter_pool=pool, device="cpu")


def test_init_moe_params_refuses_without_a_card(no_cuda):
    from senweaver_ide_tpu_torch.parallel import MoEConfig, init_moe_params
    cfg = MoEConfig(hidden_size=8, intermediate_size=16, num_experts=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_moe_params(cfg, torch.Generator())
    p = init_moe_params(cfg, torch.Generator(), device="cpu")
    assert p["w_gate"].device.type == "cpu"


def test_migration_module_imports_under_the_blocker():
    """The two rewritten modules of this slice import with JAX blocked
    (the package-wide walk above covers them too; this names them)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _BLOCKED_IMPORT.format(banned=BANNED) + (
        "import senweaver_ide_tpu_torch.rollout.adapter_pool\n"
        "import senweaver_ide_tpu_torch.rollout.migration\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


_SERVE_UNDER_BLOCKER = r"""
import json
import numpy as np
import torch
import senweaver_ide_tpu_torch.serve as serve
import senweaver_ide_tpu_torch.resilience as res
from senweaver_ide_tpu_torch.serve import rpc
# a frame that names the JAX package's KVCache decodes into the port's
# own class with the JAX package blocked
frame = {"__nt__": "senweaver_ide_tpu.models.transformer:KVCache",
         "f": {"k": rpc.encode(torch.zeros(1, dtype=torch.bfloat16)),
               "v": rpc.encode(np.zeros(1, np.float32)),
               "length": rpc.encode(np.int32(1))}}
kv = rpc.decode(json.loads(json.dumps(frame)))
assert type(kv).__module__ == "senweaver_ide_tpu_torch.models.transformer"
assert kv.k.dtype == torch.bfloat16
assert len(serve.__all__) >= 60 and "ChaosEngine" in res.__all__
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print("serve ok")
"""


def test_serve_and_chaos_import_with_jax_blocked():
    """The serving plane, leases and chaos harness import with the JAX
    package blocked, and the codec's namedtuple rebuild maps a JAX frame
    onto the port's module instead of importing the JAX package."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _BLOCKED_IMPORT.format(banned=BANNED) + _SERVE_UNDER_BLOCKER
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "ok"


def _entry_argv(kind, name):
    """(path, argv) of an entry point as its user runs it on the card."""
    if kind == "example":
        return os.path.join(ROOT, "examples", f"torch_{name}.py"), []
    return (os.path.join(ROOT, "scripts", f"torch_{name}_report.py"),
            ["--selftest"])


ENTRY_POINTS = ([("example", n) for n in EXAMPLES]
                + [("report", n) for n in REPORTS])


@pytest.mark.parametrize("kind,name", ENTRY_POINTS,
                         ids=[f"{k}-{n}" for k, n in ENTRY_POINTS])
def test_entry_point_refuses_without_a_card(kind, name, no_cuda,
                                            monkeypatch):
    """Without a card and without --cpu an entry point raises, naming
    CUDA; it never carries on on the CPU."""
    import runpy
    path, argv = _entry_argv(kind, name)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runpy.run_path(path, run_name="__main__")


_ENTRIES_UNDER_BLOCKER = r"""
import runpy, torch
torch.cuda.is_available = lambda: False
for path, argv in {entries!r}:
    sys.argv = [path, *argv]
    try:
        runpy.run_path(path, run_name="__main__")
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), (path, e)
    else:
        raise AssertionError(path + " ran without a card")
for path in {jsonl!r}:
    runpy.run_path(path)            # its imports, not its main
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print("entries ok")
"""


def test_entry_points_import_with_jax_blocked():
    """Every port example and report imports with the JAX package
    blocked: the quickstarts and selftests run up to their refusal of a
    missing card (the quickstarts that run at module level import all
    they use before it), the JSONL reports import their modules."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    entries = [_entry_argv(k, n) for k, n in ENTRY_POINTS]
    jsonl = [os.path.join(ROOT, "scripts", f"torch_{n}_report.py")
             for n in JSONL_REPORTS]
    code = _BLOCKED_IMPORT.format(banned=BANNED) + \
        _ENTRIES_UNDER_BLOCKER.format(entries=entries, jsonl=jsonl)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "ok"


def _refused(code, out, err=None):
    """A refusal of a missing card: the RuntimeError itself, or an eval's
    JSON error line with exit 1 (the evals print one for any failure)."""
    if err is not None:
        return "CUDA is not available" in str(err)
    last = out.strip().splitlines()[-1] if out.strip() else ""
    return code == 1 and last.startswith('{"error": ') and \
        "CUDA is not available" in last


@pytest.mark.parametrize("name", EVALS)
def test_eval_refuses_without_a_card(name, no_cuda, monkeypatch, capsys):
    """Without a card and without --cpu an eval raises, naming CUDA (or
    exits 1 with the error line naming it); it never carries on on the
    CPU."""
    import runpy
    path = os.path.join(ROOT, f"torch_eval_{name}.py")
    monkeypatch.setattr(sys, "argv", [path, *EVAL_ARGV.get(name, [])])
    monkeypatch.syspath_prepend(ROOT)
    code, err = 0, None
    try:
        runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        code = e.code
    except RuntimeError as e:
        err = e
    assert _refused(code, capsys.readouterr().out, err), (code, err)


_EVALS_UNDER_BLOCKER = r"""
import contextlib, io, runpy, torch
torch.cuda.is_available = lambda: False
sys.path.insert(0, {root!r})
for path, argv in {evals!r}:
    sys.argv = [path, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except SystemExit as e:
        assert e.code == 1 and "CUDA is not available" in buf.getvalue(), (
            path, buf.getvalue())
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), (path, e)
    else:
        raise AssertionError(path + " ran without a card")
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print("evals ok")
"""


def test_evals_import_with_jax_blocked():
    """Every eval port, and the sibling evals each imports, run up to
    their refusal of a missing card with the JAX package blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _BLOCKED_IMPORT.format(banned=BANNED) + \
        _EVALS_UNDER_BLOCKER.format(root=ROOT, evals=[
            (p, EVAL_ARGV.get(os.path.basename(p)[len("torch_eval_"):-3],
                              [])) for p in _eval_files()])
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "ok"


def test_generator_must_match_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator is on cpu"):
        init_params(tiny_test(), torch.Generator(), device="cuda")


_PARALLEL_UNDER_BLOCKER = r"""
import senweaver_ide_tpu_torch.parallel as par
from senweaver_ide_tpu_torch.parallel import distributed, sharding
assert distributed.default_backend("cpu") == "gloo"
assert distributed.default_backend("cuda") == "nccl"
assert len(sharding.PARAM_SPECS) > 40 and "moe_ffn_sharded" in par.__all__
m = par.single_device_mesh()
assert m.size == 1 and m.group("tp") is None
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print("parallel ok")
"""


def test_parallel_layouts_import_with_jax_blocked():
    """The parallel package imports, names its backends (NCCL for CUDA,
    gloo for the CPU: no silent switch) and builds a one-rank mesh with
    the JAX package blocked."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    code = _BLOCKED_IMPORT.format(banned=BANNED) + _PARALLEL_UNDER_BLOCKER
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "ok"


def test_mesh_pool_ranks_import_no_jax():
    """The rank processes of the mesh tests import tests/torch_mesh_pool.py
    and the port only: the helper names no banned module."""
    path = os.path.join(ROOT, "tests", "torch_mesh_pool.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert names and not [n for n in names if _banned(n)]


_ROOT_ENTRIES_UNDER_BLOCKER = r"""
import contextlib, io, runpy, torch
torch.cuda.is_available = lambda: False
sys.path.insert(0, {root!r})
for path, argv in {entries!r}:
    sys.argv = [path, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    except RuntimeError as e:
        assert "CUDA is not available" in str(e), (path, e)
    else:
        raise AssertionError(path + " ran without a card")
    assert buf.getvalue() == "", (path, buf.getvalue())
assert not [k for k in sys.modules if k.split(".")[0] in BANNED]
print("root entries ok")
"""


def test_root_entry_points_refuse_without_a_card_with_jax_blocked():
    """torch_bench.py, scripts/torch_perf_gate.py (its selftest and its
    measure) and torch_graft_entry.py run as their users run them, with
    the JAX package blocked and no card: each raises naming CUDA and
    prints nothing (no line, no replayed number)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    gate = os.path.join(ROOT, "scripts", "torch_perf_gate.py")
    entries = [(os.path.join(ROOT, "torch_bench.py"), []),
               (gate, ["--selftest"]), (gate, []),
               (os.path.join(ROOT, "torch_graft_entry.py"), [])]
    code = _BLOCKED_IMPORT.format(banned=BANNED) + \
        _ROOT_ENTRIES_UNDER_BLOCKER.format(root=ROOT, entries=entries)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.split()[-1] == "ok"
