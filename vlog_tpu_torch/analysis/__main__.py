"""CLI: ``python -m vlog_tpu_torch.analysis`` — the port's source-level
invariant gate.

Exit codes: 0 = clean (or every finding baselined), 1 = non-baselined
findings, 2 = usage error. ``--baseline-update`` rewrites the baseline
from the current full run (then add justification comments by hand and
commit); ``--rule`` restricts to one or more passes, in which case the
baseline and stale-entry report are restricted to the same rules.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from vlog_tpu_torch.analysis import (PASSES, default_baseline,
                                     default_pkg_dir, load_baseline,
                                     render_baseline, run_passes)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vlog_tpu_torch.analysis",
        description="Project-invariant static analysis over "
                    "vlog_tpu_torch/.")
    ap.add_argument("--rule", action="append", metavar="RULE[,RULE...]",
                    help="run only these passes (repeatable and/or "
                         f"comma-separated; known: {', '.join(sorted(PASSES))})")
    ap.add_argument("--root", type=Path, default=None,
                    help="package dir to scan "
                         "(default: this vlog_tpu_torch)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="baseline file (default: the package's "
                         "analysis/BASELINE.txt)")
    ap.add_argument("--baseline-update", action="store_true",
                    help="rewrite the baseline from this run and exit 0")
    args = ap.parse_args(argv)
    if args.rule:
        args.rule = [r for spec in args.rule
                     for r in spec.split(",") if r]

    pkg_dir = (args.root or default_pkg_dir()).resolve()
    baseline_path = args.baseline or default_baseline(pkg_dir)
    try:
        findings = run_passes(pkg_dir, rules=args.rule)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.baseline_update:
        from vlog_tpu_torch.analysis.core import entry_line, parse_entry

        if args.rule:
            # A rule-restricted update splices: the other rules' entry
            # lines — AND their hand-written justification comments —
            # stay byte-for-byte; only the selected rules' entries are
            # dropped and regenerated (appended, to be justified by
            # hand like any new entry).
            try:
                old_lines = baseline_path.read_text().splitlines()
            except OSError:
                old_lines = []
            kept = [ln for ln in old_lines
                    if (parse_entry(ln) or (None,))[0] not in args.rule]
            fresh = [entry_line(key)
                     for key in sorted({f.key for f in findings})]
            body = "\n".join(kept).rstrip("\n")
            if fresh:
                body += "\n" + "\n".join(fresh)
            baseline_path.write_text(body + "\n" if body else "")
            total = len(fresh) + sum(
                1 for ln in kept if parse_entry(ln) is not None)
        else:
            baseline_path.write_text(render_baseline(findings))
            total = len({f.key for f in findings})
        print(f"baseline: wrote {total} finding(s) to {baseline_path}")
        return 0

    known = load_baseline(baseline_path)
    if args.rule:
        known = {k for k in known if k[0] in args.rule}
    fresh = [f for f in findings if f.key not in known]
    stale = known - {f.key for f in findings}
    for f in fresh:
        print(f.render())
    if stale:
        # informational: a baselined finding that no longer fires means
        # the debt was paid — prune the entry (not an error: pruning
        # must not block the fix that earned it)
        for rule, file, message in sorted(stale):
            print(f"note: stale baseline entry: {rule} | {file} | {message}")
    suppressed = len(findings) - len(fresh)
    print(f"{len(fresh)} finding(s) ({suppressed} baselined, "
          f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'})")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
