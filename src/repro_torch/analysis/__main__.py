"""CLI: `python -m repro_torch.analysis [--strict] [--rule ID ...]
[--list-rules]`.

Exit 0 when the tree is contract-clean, 1 when it is not, 2 on a usage
error (the reference's codes, src/repro/analysis/__main__.py). Non-strict
mode fails only on unwaived diagnostics; `--strict` (what chip_smoke.py's
`contract_gate()` runs) additionally fails on stale waivers and waivers
missing a justification, so the waiver set can never rot. Waived
diagnostics are always echoed with their justification.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.rules import RULES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="ContractGuard AST contract linter for the port (layer "
                    "1). The hot-loop audit (layer 2) needs a live server: "
                    "`pytest tests/test_torch_analysis.py` runs it on the "
                    "CPU, chip_smoke.py on the card.")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale/unjustified waivers")
    ap.add_argument("--rule", action="append", metavar="ID",
                    help="run only this rule id (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name in sorted(RULES):
            doc = (RULES[name].__doc__ or
                   sys.modules[RULES[name].__module__].__doc__ or "")
            head = doc.strip().splitlines()[0] if doc.strip() else ""
            print(f"{name:24s} {head}")
        return 0

    rules = None
    if args.rule:
        unknown = set(args.rule) - set(RULES)
        if unknown:
            ap.error(f"unknown rule(s): {', '.join(sorted(unknown))} "
                     f"(see --list-rules)")
        rules = {r: RULES[r] for r in args.rule}

    report = run_lint(rules=rules)
    print(report.format(strict=args.strict))
    return 0 if report.ok(strict=args.strict) else 1


if __name__ == "__main__":
    sys.exit(main())
