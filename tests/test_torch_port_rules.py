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
from senweaver_ide_tpu_torch.rollout import RolloutEngine, init_paged_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(senweaver_ide_tpu_torch.__file__)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "safetensors",
          "ml_dtypes", "senweaver_ide_tpu")


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
    params = init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RolloutEngine(params, cfg)
    RolloutEngine(params, cfg, device="cpu")


def test_generator_must_match_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator is on cpu"):
        init_params(tiny_test(), torch.Generator(), device="cuda")
