"""CLI: ``python -m sq_learn_tpu_torch.obs
<audit|frontier|trace|storage|report|budget|control|fleet|regress> ...``.

- ``audit <jsonl> [...] [--json] [--confidence C]`` — Clopper–Pearson
  audit of a run's (ε, δ) guarantee records; exits 1 on any flagged site
  (:mod:`.guarantees`).
- ``frontier <jsonl> [...] [--json]`` — the accuracy-vs-theoretical-
  quantum-runtime table with its Pareto frontier, and the per-tenant
  effective-(ε, δ) table (:mod:`.frontier`).
- ``trace <jsonl> [...] [-o out.json]`` — the run as Chrome trace-event
  JSON, several files merged onto pid lanes (:mod:`.trace`).
- ``storage <jsonl> [...] [--json] [--advise] [--top N]`` — the storage
  ledger: per-surface accounting and the per-shard heat × bytes table of
  the run's ``io`` records, with placement advice; exits 2 when there is
  no ``io`` record (:mod:`.storage`).
- ``report <jsonl> [...] [--json]`` — the human view of a run: top spans
  by self time, counters, the quantum ledger, the guarantee audit, the
  frontier, the storage surfaces, serving SLOs, error budgets, effective
  (ε, δ), controller decisions, faults and probes (:mod:`.report`).
- ``budget <jsonl> [...] [--json]`` — the per-tenant error-budget table;
  exits 1 when a tenant's multi-window burn alert fired, 2 when the
  artifacts carry no budget record (:mod:`.budget`).
- ``control <jsonl> [...] [--json]`` — the serving controller's decision
  history; exits 2 when the artifacts carry no control record
  (:mod:`.control`).
- ``fleet <run_dir | shard.jsonl ...> [--json] [-o trace.json]
  [--merged merged.jsonl]`` — an elastic run's per-process shards merged
  into one clock-aligned timeline: per-host rollups, each generation's
  detect → shrink → re-init → resume path and the commit-ledger
  reconciliation; exits 1 when the ledger disagrees with itself, 2 when
  there is no shard (:mod:`.fleet`).

- ``regress <record-file> [--root DIR] [--no-exit-code] | --selftest
  [--device cpu|cuda]`` — bands a fresh metric record against the
  history of the same metric and backend under ``--root``; exits 1 on a
  red verdict (unless ``--no-exit-code``), 2 on bad usage. ``--selftest``
  injects a real regression and checks that it goes red, on
  ``--device`` or else the configured device (:mod:`.regress`).
"""

import sys


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "audit":
        from .guarantees import main as run
    elif cmd == "frontier":
        from .frontier import main as run
    elif cmd == "trace":
        from .trace import main as run
    elif cmd == "storage":
        from .storage import main as run
    elif cmd == "report":
        from .report import main as run
    elif cmd == "budget":
        from .budget import main as run
    elif cmd == "control":
        from .control import main as run
    elif cmd == "fleet":
        from .fleet import main as run
    elif cmd == "regress":
        from .regress import main as run
    else:
        print(f"unknown subcommand {cmd!r} (expected audit, frontier, "
              "trace, storage, report, budget, control, fleet or regress)",
              file=sys.stderr)
        return 2
    return run(rest)


if __name__ == "__main__":
    sys.exit(main())
