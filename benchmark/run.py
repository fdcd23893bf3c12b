#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the numbers compared against the reference, each beside its
limit, as the last lines of standard error, and one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``. Exits non-zero, printing no result,
without a CUDA card (or with fewer than the cell asks for), and when JAX
or the JAX package was loaded.

``--control fp8`` puts the fp8 reference in the program's place in the
comparison, ``--control half_batch`` (training cells) the reference over
half of each batch, ``--control wrong_row`` (serving cells) plants a
sampler that draws each token from another row's distribution:
calibration runs, in which ``correct`` must come out false. Measured runs
never pass ``--control``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")


def _environment() -> None:
    # Build and kernel caches at fixed paths inside the checkout, so only a
    # cell's first run in a checkout builds; libraries that could load JAX
    # by themselves are told not to.
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("fp8", "half_batch", "wrong_row"),
                    default=None)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import core
    cell = core.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"cell {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result, readings = core.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda",
                         control=args.control, root=ROOT, t_start=T0)
    found = core.forbidden_modules()
    if found:
        print(f"modules loaded that the port's run may not load: {found}",
              file=sys.stderr)
        return 3
    print(f"seconds {json.dumps(readings['seconds'])}; diag "
          f"{json.dumps(readings['diag'])}; readings "
          f"{json.dumps({k: v for k, v in readings.items() if k not in ('diag', 'seconds')})}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
