"""Each cell once on the card through `benchmark/run.py`, short:
the result line's keys, the device it names, and ``correct``. Run on a
machine with a card: ``python3 -m pytest -m gpu benchmark/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import core
from benchmark.tests.test_bm_harness import BENCHMARK_CELLS, SEED


@pytest.mark.gpu
@pytest.mark.parametrize("cell", BENCHMARK_CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", str(trace)],
        cwd=core.ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    spec = core.load_cell(cell)
    want = spec.per_layer if trace else spec.end_to_end
    assert set(res["metrics"]) == {m["name"] for m in want}
    if trace:
        assert res["device"]["busy_s"] > 0
        assert res["breakdown"]["device_ops"]
