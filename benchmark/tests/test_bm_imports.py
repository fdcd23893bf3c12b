"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program. Names are compared by their
top-level part whole: the port's name begins with the JAX package's."""

from __future__ import annotations

import ast
import os

from benchmark import core

FORBIDDEN = {"jax", "jaxlib", "flax", "senweaver_ide_tpu"}


def _modules():
    for d, _dirs, files in os.walk(core.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _modules()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(core.BENCH, "reference")
    for p in _modules():
        if p.startswith(ref + os.sep):
            assert "senweaver_ide_tpu_torch" not in set(_imports(p)), p
