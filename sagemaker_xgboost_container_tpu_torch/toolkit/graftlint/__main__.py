"""graftlint CLI: ``python -m sagemaker_xgboost_container_tpu_torch.toolkit.graftlint``.

Exit codes: 0 clean, 1 findings, 2 an unparseable file or an internal error
(a finding and a broken tool are told apart).
"""

import argparse
import json
import os
import sys

from . import core


def _find_root(start):
    """Walk up until a directory containing the package (or .git) appears."""
    cur = os.path.abspath(start)
    while True:
        if os.path.isdir(os.path.join(cur, core.PACKAGE)) or os.path.isdir(
            os.path.join(cur, ".git")
        ):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="graftlint",
        description="the port's lint gate: capture safety, concurrency/IO "
        "discipline, contract drift, legacy gates",
    )
    parser.add_argument("paths", nargs="*", help="files/dirs to scan "
                        "(default: the package under --root)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--select", default=None,
                        help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--disable", default=None,
                        help="comma-separated rule ids to skip")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: {})".format(core.DEFAULT_BASELINE))
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline (the self-check mode)")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write current findings to the baseline and exit 0")
    parser.add_argument("--stats", action="store_true",
                        help="print per-rule hit counts (live/suppressed/baselined)")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(core.known_rules().items()):
            sys.stdout.write("{:32} {}\n".format(rule, desc))
        return 0

    root = args.root or _find_root(os.getcwd())
    select = [r.strip() for r in args.select.split(",")] if args.select else None
    disable = [r.strip() for r in args.disable.split(",")] if args.disable else None

    report = core.run(
        root,
        paths=args.paths or None,
        select=select,
        disable=disable,
        baseline_path=args.baseline,
        use_baseline=not args.no_baseline,
    )

    if args.write_baseline:
        path = args.baseline or os.path.join(root, core.DEFAULT_BASELINE)
        # regenerate from every live finding: the new ones AND the ones the
        # existing baseline already grandfathers (report.findings alone is
        # post-baseline, so writing just it would un-grandfather the rest)
        live = report.findings + report.baselined
        # entries OUTSIDE this run's scope — rules not run, or files not
        # scanned but still present — had no chance to re-match; carry
        # them over so a --select/paths-narrowed regeneration never
        # un-grandfathers the rest. Entries for deleted files are dropped.
        carried = []
        if os.path.isfile(path):
            rules_run = set(core.known_rules())
            if select is not None:
                rules_run &= set(select)
            rules_run -= set(disable or ())
            scanned = {sf.relpath for sf in report.project.files}
            try:
                old_entries = core.load_baseline_entries(path)
            except (OSError, ValueError) as e:
                sys.stderr.write(
                    "graftlint: cannot merge baseline {}: {}\n".format(path, e)
                )
                return 2
            for entry in old_entries:
                erule, epath = entry.get("rule", ""), entry.get("path", "")
                out_of_scope = erule not in rules_run or (
                    epath not in scanned
                    and os.path.isfile(os.path.join(report.project.root, epath))
                )
                if out_of_scope:
                    carried.append(entry)
        core.write_baseline(path, report.project, live, extra_entries=carried)
        sys.stderr.write(
            "graftlint: wrote {} baseline entries to {} "
            "({} carried from outside this run's scope)\n".format(
                len(live) + len(carried), path, len(carried)
            )
        )
        return 0

    if args.format == "json":
        payload = {
            "version": 1,
            "findings": [f.as_dict() for f in report.findings],
            "baselined": [f.as_dict() for f in report.baselined],
            "suppressed": [
                dict(f.as_dict(), reason=s.reason)
                for f, s in report.suppressed
            ],
            "errors": report.errors,
            "stats": {
                rule: {"live": v[0], "suppressed": v[1], "baselined": v[2]}
                for rule, v in sorted(report.all_stats().items())
            },
        }
        sys.stdout.write(json.dumps(payload, indent=2, sort_keys=True) + "\n")
    else:
        for f in report.findings:
            sys.stderr.write(
                "{}:{}: [{}] {}\n".format(f.path, f.line, f.rule, f.message)
            )
        for err in report.errors:
            sys.stderr.write("graftlint: error: {}\n".format(err))
        if args.stats:
            sys.stderr.write("rule hit counts (live/suppressed/baselined):\n")
            for rule, v in sorted(report.all_stats().items()):
                sys.stderr.write(
                    "  {:32} {:3d} / {:3d} / {:3d}\n".format(rule, v[0], v[1], v[2])
                )
        if not report.findings and not report.errors:
            sys.stderr.write(
                "graftlint: OK ({} files, {} suppressed, {} baselined)\n".format(
                    len(report.project.files),
                    len(report.suppressed),
                    len(report.baselined),
                )
            )

    if report.errors:
        return 2
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
