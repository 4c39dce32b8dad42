"""``python -m sparse_coding_tpu_torch.fsck <dir> [--repair] [--json]`` —
the cold-state auditor (the port's copy of the JAX package's CLI).

It imports no torch and initializes no CUDA, so it audits a host whose
card is wedged. A human-readable summary goes to stderr; stdout is ONE
JSON line unless ``--json`` asks for the full report. Exit status: 0
clean, 1 findings, 2 fatal findings (a resume over this tree must not
proceed).
"""

from __future__ import annotations

import argparse
import json
import sys

from sparse_coding_tpu_torch.fsck.core import run_fsck


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparse_coding_tpu_torch.fsck",
        description="Audit (and optionally repair) a run dir's durable "
                    "state.")
    ap.add_argument("root", help="run dir, or any artifact tree")
    ap.add_argument("--repair", action="store_true",
                    help="apply the provably-safe repair subset, then "
                         "re-scan")
    ap.add_argument("--json", action="store_true",
                    help="print the full report JSON to stdout instead of "
                         "the one-line summary")
    ap.add_argument("--stale-after-s", type=float, default=300.0,
                    help="lease staleness window (default: 300)")
    ap.add_argument("--no-report", action="store_true",
                    help="skip writing <root>/fsck/report.json")
    args = ap.parse_args(argv)

    report = run_fsck(args.root, repair=args.repair,
                      write_report=not args.no_report,
                      stale_after_s=args.stale_after_s)

    for f in report.findings:
        mark = "FATAL " if f.fatal else ""
        fix = f" [repair: {f.repair}]" if f.repair else ""
        print(f"{mark}{f.kind:<12} {f.artifact_class:<18} {f.path}: "
              f"{f.detail}{fix}", file=sys.stderr)
    for a in report.repaired:
        print(f"repaired     {a['action']:<18} {a['path']}",
              file=sys.stderr)
    print(f"fsck: {len(report.findings)} finding(s), "
          f"{len(report.fatal)} fatal, {len(report.repaired)} repaired "
          f"under {report.root}", file=sys.stderr)

    if args.json:
        print(report.to_json())
    else:
        print(json.dumps({"findings": len(report.findings),
                          "fatal": len(report.fatal),
                          "repaired": len(report.repaired),
                          "clean": report.clean}, sort_keys=True))
    if report.fatal:
        return 2
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
