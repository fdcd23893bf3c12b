"""CLI for the static-analysis gate.

    python -m senweaver_ide_tpu_torch.analysis             # human output
    python -m senweaver_ide_tpu_torch.analysis --json      # machine output
    python -m senweaver_ide_tpu_torch.analysis --no-baseline   # raw findings
    python -m senweaver_ide_tpu_torch.analysis --rule RPC103   # one rule
    python -m senweaver_ide_tpu_torch.analysis --rule MET      # one family
    python -m senweaver_ide_tpu_torch.analysis --fix-hints     # hints for all

Exit codes: 0 clean (every finding baselined), 1 non-baselined findings
or invalid baseline, 2 usage errors. Stale baseline entries (matching
nothing — the violation was fixed but the allowlist kept it) are
reported and make the gate fail too: a baseline that can only grow is
how allowlists rot. ``--rule`` also narrows the stale check to the
selected rules, so running one linter locally never trips on another's
ledger.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import (RULES, BaselineError, collect_findings, load_baseline,
               apply_baseline)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m senweaver_ide_tpu_torch.analysis",
        description="jit purity + lock + rpc replay + metric contract "
                    "+ resource lifetime static analysis gate")
    parser.add_argument("--json", action="store_true",
                        help="emit findings as JSON")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore analysis/baseline.json")
    parser.add_argument("--baseline", default=None,
                        help="alternate baseline file")
    parser.add_argument("--rule", default=None, metavar="ID",
                        help="only this rule id (RPC103) or family "
                             "prefix (RPC, MET101…); case-insensitive")
    parser.add_argument("--fix-hints", action="store_true",
                        help="also print the fix hint for every "
                             "finding, baselined ones included")
    args = parser.parse_args(argv)

    selected = None
    if args.rule is not None:
        prefix = args.rule.upper()
        selected = {r for r in RULES if r.startswith(prefix)}
        if not selected:
            print(f"error: no rule matches {args.rule!r}; known: "
                  f"{', '.join(sorted(RULES))}", file=sys.stderr)
            return 2

    findings = collect_findings()
    try:
        entries = ([] if args.no_baseline
                   else load_baseline(args.baseline))
    except BaselineError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if selected is not None:
        findings = [f for f in findings if f.rule in selected]
        entries = [e for e in entries if e["rule"] in selected]
    result = apply_baseline(findings, entries)

    if args.json:
        print(json.dumps({
            "new": [f.to_dict() for f in result.new],
            "baselined": [f.to_dict() for f in result.baselined],
            "stale_baseline_entries": result.stale,
        }, indent=2, sort_keys=True))
    else:
        for f in result.new:
            print(f.format())
        if args.fix_hints:
            for f in result.baselined:
                print(f"baselined: {f.format()}")
        for e in result.stale:
            print(f"stale baseline entry: {e['rule']} {e['path']} "
                  f"[{e['symbol']}] — no longer fires; remove it")
        print(f"{len(result.new)} finding(s), "
              f"{len(result.baselined)} baselined, "
              f"{len(result.stale)} stale baseline entr(y/ies)")

    return 1 if (result.new or result.stale) else 0


if __name__ == "__main__":
    sys.exit(main())
