"""The benchmark of the PyTorch and CUDA port (``senweaver_ide_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Cells, configurations, traffic mixes and per-layer
metrics are found by name: ``configs/<config>.json``,
``traffic/<cell>.json`` (whose ``kind`` names ``drivers/<kind>.py``) and
``layer_metrics/<metric>.py``.
"""
