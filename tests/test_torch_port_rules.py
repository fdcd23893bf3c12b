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


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "scripts", "torch_serving_profile.py"),
           os.path.join(ROOT, "scripts", "torch_train_profile.py")]
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
