"""repro-lint for the PyTorch port: ``python -m repro_torch.analysis PATH...``

Walks the given files/directories and reports violations of:

  R0  suppression hygiene — markers must carry a reason
  R1  host syncs inside @hot_path functions
  R2  capture hazards in functions handed to ``capture`` (core/capture.py)
  R3  kernel hygiene (a plain counterpart per launcher, no try around a
      launch)
  R4  protocol conformance + scheduler layout/family purity

Exit status: 0 when clean, 1 when any unsuppressed finding remains,
2 on usage errors.

Suppression syntax
------------------
A finding is suppressed by a marker on the SAME line or the LINE ABOVE:

    out = host_pull(toks)  # repro-lint: ok(R1, the tick's one batched pull)

The reason is REQUIRED: ``# repro-lint: ok(R1)`` suppresses nothing and is
itself reported (rule R0).
"""
import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import RULE_DOCS, RULES, analyze_paths

DEFAULT_PATHS = ["src/repro_torch", "examples/torch_port", "chip_smoke.py"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files or directories to analyze (default: "
                         + " ".join(DEFAULT_PATHS) + ")")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to run (default: all), "
                         "e.g. --rules R1,R2")
    ap.add_argument("--format", choices=("human", "json"), default="human",
                    help="report format on stdout")
    ap.add_argument("--json-out", default=None, metavar="PATH",
                    help="additionally write the JSON report to PATH")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule ids + one-line docs and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            print(f"{rid}  {RULE_DOCS[rid]}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}; "
                  f"known: {', '.join(sorted(RULES))}", file=sys.stderr)
            return 2

    findings = analyze_paths(args.paths, rules)
    report = {"findings": [f.to_dict() for f in findings],
              "count": len(findings),
              "rules": sorted(rules or RULES)}
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(report, indent=2))
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"repro-lint (port): {len(findings)} finding(s) over rules "
              f"{','.join(report['rules'])}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
