"""Static + dynamic analysis gates for the codebase's invariant
planes: jit purity (analysis.jit_lint), lock discipline
(analysis.lock_lint), runtime lock ordering (analysis.lock_order),
rpc replay discipline (analysis.rpc_lint), the metric contract
(analysis.metric_lint), and resource lifetimes
(analysis.resource_lint).

Library entry points::

    from senweaver_ide_tpu_torch import analysis
    result = analysis.run_package()         # BaselineResult
    assert not result.new

CLI: ``python -m senweaver_ide_tpu_torch.analysis [--json] [--no-baseline]
[--rule RPC103] [--fix-hints]``.
Pytest gates: tests/test_static_analysis.py,
tests/test_protocol_lint.py. Rule catalog and the ``# guarded-by:`` /
``# replay:`` / ``# metric-name:`` / ``# ownership:`` conventions:
docs/static_analysis.md.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from . import (jit_lint, lock_lint, lock_order,  # noqa: F401
               metric_lint, resource_lint, rpc_lint)
from .findings import (BaselineError, BaselineResult, Finding,  # noqa: F401
                       apply_baseline, default_baseline_path,
                       load_baseline)
from .lock_order import LockOrderRecorder  # noqa: F401

RULES: Dict[str, str] = {**jit_lint.RULES, **lock_lint.RULES,
                         **rpc_lint.RULES, **metric_lint.RULES,
                         **resource_lint.RULES}


def package_root() -> str:
    """The senweaver_ide_tpu_torch package directory (what we lint)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def collect_findings(root: Optional[str] = None) -> List[Finding]:
    """Run every static pass over the package; raw findings, no
    baseline applied."""
    root = root or package_root()
    modules = jit_lint.index_package(root)
    findings = jit_lint.lint_modules(modules)
    findings.extend(lock_lint.lint_package(root))
    findings.extend(rpc_lint.lint_package(root))
    findings.extend(metric_lint.lint_package(root))
    findings.extend(resource_lint.lint_package(root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def run_package(root: Optional[str] = None,
                baseline_path: Optional[str] = None) -> BaselineResult:
    """Both passes + baseline: the gate. ``result.new`` must be empty."""
    findings = collect_findings(root)
    entries = load_baseline(baseline_path)
    return apply_baseline(findings, entries)
