"""The port's static-analysis gate (``senweaver_ide_tpu_torch.analysis``,
copies of the JAX package's linters held to their originals by
tests/test_torch_copies.py) over the port's own sources: no new and no
stale findings against the port's baseline, a baseline that is small and
reasoned, the repaired findings gone, and seeded regressions that fail
the gate (tests/test_static_analysis.py:566-597 on the port).

The package's findings are computed once for the module (one pass over
the port reads every source file)."""

import json
import os
import textwrap

import pytest

from senweaver_ide_tpu_torch import analysis
from senweaver_ide_tpu_torch.analysis import __main__ as cli
from senweaver_ide_tpu_torch.analysis.findings import (apply_baseline,
                                                       load_baseline)
from senweaver_ide_tpu_torch.analysis.lock_order import LockOrderRecorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def findings():
    return analysis.collect_findings()


def _rules(found):
    return {f.rule for f in found}


def test_package_root_is_the_port():
    assert analysis.package_root() == os.path.join(ROOT,
                                                   "senweaver_ide_tpu_torch")
    assert LockOrderRecorder().scope == "senweaver_ide_tpu_torch"


def test_package_gate_is_clean(findings):
    result = apply_baseline(findings, load_baseline())
    msgs = "\n".join(f.format() for f in result.new)
    assert result.new == [], f"non-baselined findings:\n{msgs}"
    assert result.stale == [], f"stale baseline entries: {result.stale}"


def test_package_baseline_is_the_ports_own_and_reasoned():
    entries = load_baseline()
    assert len(entries) <= 10
    for e in entries:
        assert e["path"].startswith("senweaver_ide_tpu_torch/")
        assert len(e["reason"]) > 20   # a real sentence, not "ok"


def test_repaired_findings_stay_repaired(findings):
    """The metric-name hatches on the draft pool's renamed registry, the
    doc row and dashboard read they back, and the engine's guarded row
    state written in __init__: no MET or LOCK finding at all, raw."""
    assert not [f for f in findings if f.rule.startswith(("MET", "LOCK"))]
    assert {(f.rule, f.symbol) for f in findings} <= {
        (e["rule"], e["symbol"]) for e in load_baseline()}


def test_cli_exit_codes(findings, monkeypatch, capsys, tmp_path):
    """``python -m senweaver_ide_tpu_torch.analysis``: 0 on the port, 1
    without the baseline (the baselined findings are new then) and on a
    stale entry, 2 for an unknown rule; --json lists the same."""
    monkeypatch.setattr(cli, "collect_findings", lambda: list(findings))
    assert cli.main([]) == 0
    assert cli.main(["--no-baseline"]) == (1 if findings else 0)
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"entries": [{
        "rule": "LOCK101", "path": "senweaver_ide_tpu_torch/none.py",
        "symbol": "X.y", "reason": "an entry that matches no finding"}]}))
    assert cli.main(["--baseline", str(stale), "--rule", "LOCK"]) == 1
    assert cli.main(["--rule", "NOPE999"]) == 2
    capsys.readouterr()
    assert cli.main(["--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["new"] == [] and out["stale_baseline_entries"] == []


def _seeded(tmp_path, source):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "bad.py").write_text(textwrap.dedent(source))
    return analysis.run_package(root=str(pkg),
                                baseline_path=str(tmp_path / "nb.json"))


def test_package_gate_flags_real_regressions(tmp_path):
    result = _seeded(tmp_path, """
        import jax

        @jax.jit
        def f(x):
            print(x)
            return x.item()
    """)
    assert {"JIT101", "JIT103"} <= _rules(result.new)


def test_package_gate_flags_an_unguarded_write(tmp_path):
    """The regression the engine had: a ``# guarded-by: _lock`` field
    assigned in a helper outside the lock."""
    result = _seeded(tmp_path, """
        import threading

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._rows = []  # guarded-by: _lock

            def _reset(self):
                self._rows = []
    """)
    assert "LOCK101" in _rules(result.new)


def test_package_gate_flags_a_computed_metric_name(tmp_path):
    """The other regression: a registration whose name is computed, with
    no ``# metric-name:`` hatch."""
    result = _seeded(tmp_path, """
        def gauge(registry, name):
            return registry.gauge(name.replace("a", "b"), "help")
    """)
    assert "MET104" in _rules(result.new)
