"""``python -m repro_torch.analysis`` -- the PlaneCheck CLI.

Usage::

    python -m repro_torch.analysis src/repro_torch          # report all
    python -m repro_torch.analysis --check src/repro_torch  # the gate:
                                                  # exit 1 on
                                                  # non-baselined findings
    python -m repro_torch.analysis --write-baseline src/repro_torch
    python -m repro_torch.analysis --json src/repro_torch   # for tools

The baseline lives at ``PLANECHECK_TORCH_BASELINE.json`` (repo root)
unless
``--baseline`` points elsewhere.  Every entry must carry a one-line
justification; ``--check`` also fails on unjustified entries, and
warns on stale ones (entries that no longer match any finding).
"""

from __future__ import annotations

import argparse
import json
import sys

from . import Baseline, RULES, run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PlaneCheck for the port: hot-loop + lock-discipline "
                    "analyzer")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to analyze "
                             "(default: src/repro_torch)")
    parser.add_argument("--check", action="store_true",
                        help="exit 1 on any non-baselined finding "
                             "(the CI gate)")
    parser.add_argument("--baseline",
                        default="PLANECHECK_TORCH_BASELINE.json",
                        help="baseline file (default: "
                             "PLANECHECK_TORCH_BASELINE.json)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write all current findings to the baseline "
                             "(justifications left as TODO)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit findings as JSON")
    parser.add_argument("--rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule}  {desc}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    baseline = Baseline.load(args.baseline)
    errors = baseline.validate()
    findings, new = run(paths, baseline)

    if args.write_baseline:
        Baseline.write(args.baseline, findings)
        print(f"wrote {len(findings)} entries to {args.baseline} "
              "(fill in the justifications)")
        return 0

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "new": [f.to_dict() for f in new],
            "baseline_errors": errors,
        }, indent=2))
    else:
        for f in new:
            print(f.format())
        n_base = len(findings) - len(new)
        print(f"planecheck: {len(findings)} finding(s), "
              f"{n_base} baselined, {len(new)} new", file=sys.stderr)
        for err in errors:
            print(f"planecheck: baseline error: {err}", file=sys.stderr)
        for e in baseline.stale():
            print(f"planecheck: warning: stale baseline entry "
                  f"{e.get('rule')} {e.get('file')}:{e.get('symbol')}",
                  file=sys.stderr)

    if args.check and (new or errors):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
