"""Helpers of the quickstart tests (``tests/test_torch_examples.py`` and
``tests/test_torch_qlora_example.py``): run an example in this process,
spy on a module function, carry JAX weights into the port's trainer."""

import os
import runpy
import sys

import jax
import numpy as np

import senweaver_ide_tpu_torch.training as port_training
from senweaver_ide_tpu.agents.loop import AgentLoop as JaxAgentLoop
from senweaver_ide_tpu_torch.agents.loop import AgentLoop
from senweaver_ide_tpu_torch.models import params_from_numpy
from senweaver_ide_tpu_torch.obs.scope import preserved_obs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(monkeypatch, capsys, script, *argv):
    """Run ``examples/<script>`` as ``__main__``; returns its stdout."""
    path = os.path.join(ROOT, "examples", script)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    capsys.readouterr()
    with preserved_obs():
        try:
            runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            assert e.code in (0, None), e.code
    return capsys.readouterr().out


def spy(monkeypatch, module, name, calls):
    """Wrap ``module.<name>``, recording each call's result."""
    real = getattr(module, name)

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls.append(out)
        return out
    monkeypatch.setattr(module, name, spy)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def adopt(monkeypatch, jax_params):
    """Make the port's ``make_train_state`` adopt ``jax_params``."""
    real = port_training.make_train_state

    def make(config, generator=None, mesh=None, **kw):
        params = params_from_numpy(jax_params, device=kw["device"])
        return real(config, None, mesh, params=params, **kw)
    monkeypatch.setattr(port_training, "make_train_state", make)


def lines(text, prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


def skip_backoff(monkeypatch):
    """The agent loop's retry backoffs, on both sides, do not sleep."""
    for loop in (AgentLoop, JaxAgentLoop):
        monkeypatch.setitem(loop.__init__.__kwdefaults__, "sleep",
                            lambda _s: None)
