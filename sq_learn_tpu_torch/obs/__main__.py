"""CLI: ``python -m sq_learn_tpu_torch.obs
<audit|frontier|trace|storage> ...``.

- ``audit <jsonl> [...] [--json] [--confidence C]`` — Clopper–Pearson
  audit of a run's (ε, δ) guarantee records; exits 1 on any flagged site
  (:mod:`.guarantees`).
- ``frontier <jsonl> [...] [--json]`` — the accuracy-vs-theoretical-
  quantum-runtime table with its Pareto frontier (:mod:`.frontier`).
- ``trace <jsonl> [...] [-o out.json]`` — the run as Chrome trace-event
  JSON, several files merged onto pid lanes (:mod:`.trace`).
- ``storage <jsonl> [...] [--json] [--advise] [--top N]`` — the storage
  ledger: per-surface accounting and the per-shard heat × bytes table of
  the run's ``io`` records, with placement advice; exits 2 when there is
  no ``io`` record (:mod:`.storage`).

The JAX package's other subcommands read records of planes the port does
not have yet; each raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it.
"""

import sys

#: subcommands of the JAX package's CLI that wait for a plane of the port
_LATER = {
    "report": "ROADMAP.md §1 item 7, serving/ and its obs readers (report "
              "reads the budget and control records)",
    "regress": "ROADMAP.md §1 item 7, the rest of obs (regress bands the "
               "JAX package's bench trajectory)",
    "budget": "ROADMAP.md §1 item 7, serving/ and its obs readers",
    "control": "ROADMAP.md §1 item 7, serving/ and its obs readers",
    "fleet": "ROADMAP.md §1 item 6, multi-GPU (the elastic fleet)",
}


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
    elif cmd in _LATER:
        raise NotImplementedError(
            f"'{cmd}' is not ported yet: {_LATER[cmd]}")
    else:
        print(f"unknown subcommand {cmd!r} (expected audit, frontier, "
              "trace or storage)", file=sys.stderr)
        return 2
    return run(rest)


if __name__ == "__main__":
    sys.exit(main())
