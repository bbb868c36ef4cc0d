"""Shared plumbing of the port's contract smokes (``python -m
sq_learn_tpu_torch.<plane>.smoke``, ``serving.control_smoke``,
``parallel.elastic_smoke``).

Each smoke takes ``--device {cuda,cpu}``; the default is the configured
device, the card. The device is resolved before anything else: without
CUDA, and without ``--device cpu``, the smoke prints the
:func:`~sq_learn_tpu_torch._config.resolve_device` message and exits 2,
writes no artifact and never falls back to the CPU. Its summary line
carries ``launches``, the hand-written kernels' counts
(:mod:`sq_learn_tpu_torch.ops.kernels`), with the counts its child and
worker processes reported summed in. Its artifact goes to ``SQ_OBS_PATH``,
else to ``sq_<plane>_smoke-torch.jsonl`` in the temporary directory.
"""

import argparse
import json
import os
import sys
import tempfile

#: exit code of a smoke whose device is missing (1 is a broken contract)
NO_DEVICE = 2


def argument_parser(prog, doc):
    """The smoke's parser with ``--device``; the caller adds the rest."""
    ap = argparse.ArgumentParser(prog=prog, description=doc.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="where to compute (default: the configured "
                         "device, the card)")
    return ap


def _drop_env_artifact():
    """Close the run ``SQ_OBS=1`` opened at import, and remove its sink
    when it holds nothing but this process's ``meta`` line: a smoke that
    cannot start leaves no artifact."""
    from . import obs

    rec = obs.disable()
    if rec is None or not rec.path or not os.path.exists(rec.path):
        return
    try:
        with open(rec.path) as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
    except (OSError, ValueError):
        return
    if all(r.get("type") == "meta" and r.get("pid") == os.getpid()
           for r in lines):
        os.remove(rec.path)


def resolve(prog, name):
    """The smoke's :class:`torch.device` for ``--device name``; exits
    :data:`NO_DEVICE` with the configured-device message when it cannot
    be had."""
    from ._config import resolve_device

    try:
        return resolve_device(name)
    except RuntimeError as exc:
        _drop_env_artifact()
        print(f"{prog}: {exc}; or run the smoke with --device cpu",
              file=sys.stderr)
        raise SystemExit(NO_DEVICE) from None


def run(main, device):
    """Run ``main(device)`` with ``device`` as the configured device;
    returns its exit code."""
    from ._config import config_context

    with config_context(device=str(device)):
        return main(device)


def cli(prog, doc, main, argv=None):
    """A smoke's entry point with ``--device`` only: parse, resolve the
    device (or exit), run ``main(device)``; returns its exit code."""
    args = argument_parser(prog, doc).parse_args(argv)
    return run(main, resolve(prog, args.device))


def artifact_path(plane):
    """The smoke's artifact: ``SQ_OBS_PATH`` when it is set, else
    ``sq_<plane>_smoke-torch.jsonl`` in the temporary directory
    (``TMPDIR``), a file no JAX smoke writes."""
    from . import _knobs

    return _knobs.get_raw("SQ_OBS_PATH", os.path.join(
        tempfile.gettempdir(), f"sq_{plane}_smoke-torch.jsonl"))


def summary_line(stdout, key):
    """The JSON summary line of a smoke's ``stdout`` that carries ``key``
    (the last such line), or None."""
    for line in reversed(stdout.splitlines()):
        try:
            doc = json.loads(line)
        except ValueError:
            continue
        if isinstance(doc, dict) and key in doc:
            return doc
    return None


def launches(*reported):
    """This process's kernel launches, ``{"lloyd_step", "argkmin"}``, plus
    every dict of counts in ``reported`` (children, workers)."""
    from .ops.kernels import argkmin, lloyd_step

    out = {"lloyd_step": int(lloyd_step.launches),
           "argkmin": int(argkmin.launches)}
    for other in reported:
        for key in out:
            out[key] += int((other or {}).get(key, 0))
    return out


def child_env(**overrides):
    """The environment of a smoke's child process: this one's, with the
    repository first on ``PYTHONPATH`` (the child runs ``python -m`` from
    any directory) and ``overrides`` applied (None removes a name)."""
    from . import _knobs

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = _knobs.environ(PYTHONSTARTUP=None, **overrides)
    path = env.get("PYTHONPATH")
    env["PYTHONPATH"] = repo if not path else os.pathsep.join([repo, path])
    return env
