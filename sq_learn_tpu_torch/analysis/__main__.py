"""CLI: ``python -m sq_learn_tpu_torch.analysis`` (counterpart of
``sq_learn_tpu/analysis/__main__.py``), run from the repository root.

Exit status: 0 = clean (every finding baselined, docs fresh), 1 = any
fresh finding, stale baseline entry, docs drift, or selftest failure.

    python -m sq_learn_tpu_torch.analysis                  # lint the port
    python -m sq_learn_tpu_torch.analysis --check-docs     # + docs drift gate
    python -m sq_learn_tpu_torch.analysis --docs > docs/torch/knobs.md
    python -m sq_learn_tpu_torch.analysis --selftest       # rules fire on bad fixtures
    python -m sq_learn_tpu_torch.analysis --write-baseline # refresh suppressions
"""

import argparse
import json
import os
import sys

from .core import load_baseline, match_baseline, run
from .rules import ALL_RULES, get_rules

DEFAULT_BASELINE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m sq_learn_tpu_torch.analysis",
        description="sqcheck over the port — static invariant checker")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint "
                         "(default: sq_learn_tpu_torch)")
    ap.add_argument("--root", default=None,
                    help="project root for relative paths and doc "
                         "checks (default: cwd)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression baseline JSON")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, suppressing nothing")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(existing justifications are kept)")
    ap.add_argument("--docs", action="store_true",
                    help="print the generated knob table and exit")
    ap.add_argument("--check-docs", action="store_true",
                    help="also fail on registry/docs drift")
    ap.add_argument("--selftest", action="store_true",
                    help="prove every rule fires on its bad fixture")
    args = ap.parse_args(argv)

    if args.list_rules:
        for r in ALL_RULES:
            print(f"{r.name:20s} {r.description}")
        return 0

    root = os.path.abspath(args.root or os.getcwd())

    if args.docs:
        from .docs import load_registry_module, render_knob_table

        sys.stdout.write(render_knob_table(load_registry_module(root)))
        return 0

    if args.selftest:
        from .selftest import run_selftest

        return run_selftest(verbose=True)

    names = args.rules.split(",") if args.rules else None
    paths = args.paths or [os.path.join(root, "sq_learn_tpu_torch")]
    findings, errors = run(paths, get_rules(names), root=root)

    status = 0
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
        status = 1

    if args.write_baseline:
        old = {(e["rule"], e["path"], e["message"]): e["justification"]
               for e in load_baseline(args.baseline)}
        entries, seen = [], set()
        for f in findings:
            if f.key() in seen:  # keys are line-free; one entry per key
                continue
            seen.add(f.key())
            entries.append(dict(f.as_dict(),
                                justification=old.get(
                                    f.key(), "TODO: justify or fix")))
        with open(args.baseline, "w") as fh:
            json.dump(entries, fh, indent=2, sort_keys=True)
            fh.write("\n")
        print(f"wrote {len(entries)} baseline entries to "
              f"{args.baseline}")
        return status

    baseline = [] if args.no_baseline else load_baseline(args.baseline)
    fresh, suppressed, stale = match_baseline(findings, baseline)
    for f in fresh:
        print(f)
    for e in stale:
        print(f"stale baseline entry (prune it): [{e['rule']}] "
              f"{e['path']}: {e['message']}")
    if fresh or stale:
        status = 1

    if args.check_docs:
        from .docs import check_docs

        problems = check_docs(root)
        for p in problems:
            print(f"docs: {p}")
        if problems:
            status = 1

    checked = "all" if names is None else ",".join(names)
    print(f"sqcheck: {len(findings)} finding(s), {len(fresh)} fresh, "
          f"{len(suppressed)} baselined, {len(stale)} stale "
          f"(rules: {checked})")
    return status


if __name__ == "__main__":
    sys.exit(main())
