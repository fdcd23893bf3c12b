"""Helpers of the eval-script tests (``tests/test_torch_eval_*.py``): run a
``torch_eval_*.py`` script in this process, read a JAX eval's report keys
from its source, carry JAX weights into the port, one torch thread per
test module, one pretrained tiny policy per process."""

import ast
import contextlib
import io
import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny-model engine steps are thousands of small ops: with several
    pytest-xdist workers, torch's default thread pool in each of them
    oversubscribes the host's cores and spins, several times slower than
    one thread. The previous setting is restored for the next module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_backoff_sleep(monkeypatch):
    """The agent loop's retry backoffs do not sleep (the scripted policy's
    failing patterns exhaust its retries; tens of seconds of waiting)."""
    from senweaver_ide_tpu_torch.agents.loop import AgentLoop
    monkeypatch.setitem(AgentLoop.__init__.__kwdefaults__, "sleep",
                        lambda _s: None)


def run_script(monkeypatch, name, *argv):
    """Run ``<repo>/<name>`` as ``__main__`` with ``argv`` on fresh
    observability globals; returns (exit code, stdout)."""
    from senweaver_ide_tpu_torch.obs.scope import preserved_obs
    path = os.path.join(ROOT, name)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    buf, code = io.StringIO(), 0
    with preserved_obs(), contextlib.redirect_stdout(buf):
        try:
            runpy.run_path(path, run_name="__main__")
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def last_json(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    assert lines, text[-2000:]
    return json.loads(lines[-1])


def run_report(monkeypatch, name, *argv):
    """A script's JSON report; the run must exit 0 with no error key."""
    code, out = run_script(monkeypatch, name, *argv)
    report = last_json(out)
    assert code in (0, None) and "error" not in report, (code, report)
    return report


def _dict_keys(node):
    return {k.value for k in node.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def jax_report_keys(script, function, var="report"):
    """The top-level keys a JAX eval's ``function`` gives its report: the
    dict literals it returns, prints with ``json.dumps``, assigns to
    ``var`` or passes to ``var.update``, and every ``var["key"] = ...``."""
    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    keys = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
            keys |= _dict_keys(n.value)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == var and isinstance(
                        n.value, ast.Dict):
                    keys |= _dict_keys(n.value)
                if (isinstance(t, ast.Subscript)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == var
                        and isinstance(t.slice, ast.Constant)):
                    keys.add(t.slice.value)
        elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            target = n.func.value
            if (n.func.attr == "update" and isinstance(target, ast.Name)
                    and target.id == var and n.args
                    and isinstance(n.args[0], ast.Dict)):
                keys |= _dict_keys(n.args[0])
            if (n.func.attr == "dumps" and n.args
                    and isinstance(n.args[0], ast.Dict)):
                keys |= _dict_keys(n.args[0])
    assert keys, (script, function)
    return keys


def to_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def carried(jax_params):
    """JAX params as the port's CPU tensors."""
    from senweaver_ide_tpu_torch.models import params_from_numpy
    return params_from_numpy(to_numpy(jax_params), device="cpu")


_PRETRAINED = {}


@pytest.fixture(scope="session")
def pretrained_policy(tmp_path_factory):
    """(checkpoint dir, train state) of a tiny rule-following policy
    pretrained for two rounds (groups of 2, 8-token completions, serial
    collection) through torch_eval_uplift_real.pretrain_rule_policy and
    saved in the port's checkpoint format; made once a process and
    shared by every test file that loads a trained policy."""
    if not _PRETRAINED:
        import torch_eval_uplift_real as U
        from senweaver_ide_tpu_torch.training.checkpoint import \
            CheckpointManager
        state, _engine, _tok, _config, curve = U.pretrain_rule_policy(
            rounds=2, group_size=2, max_new_tokens=8, max_parallel=1,
            stop_window=8, device="cpu")
        assert len(curve) == 2 and all(-1.0 <= c <= 1.0 for c in curve)
        path = str(tmp_path_factory.mktemp("pretrained_policy"))
        CheckpointManager(path).save(state)
        _PRETRAINED.update(dir=path, state=state)
    return _PRETRAINED["dir"], _PRETRAINED["state"]


# the beam scorer's held-out texts at test size (the scripts score six)
SCORER_TASKS = ("emit bytes", "write data")


def small_recipe_patch(monkeypatch, *modules):
    """The real-policy evals' fixed recipe at test size, patched in
    torch_eval_uplift_real (where the scripts import it from) and in
    ``modules``: pretraining groups of 2 with 8-token completions (the
    scripts pin 16 and 16), the beam's scorer on SCORER_TASKS and
    probes of 2 episodes."""
    import torch_eval_uplift_real as U
    pretrain, scorer, probe = (U.pretrain_rule_policy, U.make_rule_scorer,
                               U.probe_frac_low)

    def small_pretrain(**kw):
        return pretrain(**{**kw, "group_size": 2, "max_new_tokens": 8})

    def small_scorer(*a, **kw):
        return scorer(*a, **{**kw, "eval_tasks": SCORER_TASKS})

    def small_probe(*a, **kw):
        return probe(*a, **{**kw, "episodes": 2})
    for mod in (U, *modules):
        monkeypatch.setattr(mod, "pretrain_rule_policy", small_pretrain)
        monkeypatch.setattr(mod, "make_rule_scorer", small_scorer)
        monkeypatch.setattr(mod, "probe_frac_low", small_probe)
