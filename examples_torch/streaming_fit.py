"""Streaming clustering on a larger-than-memory CSV, with resume, on the
port.

The port's counterpart of ``examples/streaming_fit.py``. It ties three
pieces together:

- :func:`csv_stream_batches` — a stateful NumPy CSV stream that yields
  fixed-size batches without loading the file (the port has no native
  host parser: this module keeps its own copy of the JAX package's NumPy
  stream, with the same contract);
- ``MiniBatchQKMeans.partial_fit`` — the incremental-state API (the
  reference's only streaming surface, ``_dmeans.py:2139``, fixed here);
- ``utils.checkpoint`` — the fitted state round-trips to disk mid-stream,
  so an interrupted ingest resumes where it stopped.

The working directory is removed at the end.

Run: python examples_torch/streaming_fit.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device  # noqa: E402

import argparse  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402

#: which parser reads the stream (the JAX driver prints
#: ``native_available()`` here)
PARSER = "NumPy stream"

#: a field's leading numeric prefix, as C's ``strtof`` reads it
_NUM_PREFIX = re.compile(
    r"^\s*[-+]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)",
    re.IGNORECASE)


def _parse_lines(lines, delimiter, n_cols):
    """Parse CSV lines into an (n, n_cols) float32 array: each field is
    its leading numeric prefix (a junk suffix ignored, so ``1_000`` is
    1.0), with inf/nan literals; missing or non-numeric fields are NaN,
    extra fields are dropped."""
    rows = np.full((len(lines), n_cols), np.nan, np.float32)
    for i, line in enumerate(lines):
        parts = line.rstrip("\r\n").split(delimiter)
        for c in range(min(n_cols, len(parts))):
            m = _NUM_PREFIX.match(parts[c])
            if m:
                rows[i, c] = float(m.group(0))
    return rows


def _probe_n_cols(path, delimiter, skip_header):
    """The column count from the first non-blank data line: one line of
    lookahead, never a scan of the whole file."""
    with open(path, "r") as f:
        for _ in range(skip_header):
            f.readline()
        line = f.readline()
        while line and not line.strip():
            line = f.readline()
        return line.count(delimiter) + 1 if line else 0


def csv_stream_batches(path, batch_rows, delimiter=",", skip_header=1,
                       n_cols=None):
    """Yield (≤ batch_rows, n_cols) float32 arrays from a numeric CSV
    without loading the file (the contract of the JAX package's
    ``native.csv_stream_batches``): the column count from one line of
    lookahead, blank and whitespace-only lines skipped, non-numeric
    fields NaN, extra fields dropped, the last batch short. One open
    file, read once: a consumer that stops and later resumes iterating
    the same stream continues where it stopped."""
    path = os.fspath(path)
    if batch_rows <= 0:
        raise ValueError(f"batch_rows must be > 0, got {batch_rows}")
    if n_cols is None:
        n_cols = _probe_n_cols(path, delimiter, skip_header)
    if n_cols <= 0:
        return iter(())
    return _stream_batches(path, batch_rows, delimiter, skip_header, n_cols)


def _stream_batches(path, batch_rows, delimiter, skip_header, n_cols):
    with open(path, "r") as f:
        for _ in range(skip_header):
            f.readline()
        while True:
            lines = []
            while len(lines) < batch_rows:
                line = f.readline()
                if not line:
                    break
                if line.strip():
                    lines.append(line)
            if not lines:
                return
            yield _parse_lines(lines, delimiter, n_cols)


def write_events(csv_path):
    """Synthesize the "big" file on disk (stand-in for CICIDS-scale
    logs): 20 000 rows of five 12-wide blobs. Returns the rows."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10.0, size=(5, 12))
    X = np.vstack([c + rng.normal(size=(4000, 12)) for c in centers])
    rng.shuffle(X)
    np.savetxt(csv_path, X.astype(np.float32), delimiter=",",
               header=",".join(f"f{i}" for i in range(12)))
    return X


def new_estimator():
    """The driver's mini-batch q-means, before its first batch."""
    from sq_learn_tpu_torch.models import MiniBatchQKMeans

    return MiniBatchQKMeans(n_clusters=5, delta=0.3,
                            true_distance_estimate=False, random_state=0)


def main(argv=None):
    ap = add_device_argument(argparse.ArgumentParser())
    args = ap.parse_args(argv)

    with on_device(args.device), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from sq_learn_tpu_torch.utils import load_estimator, save_estimator

        workdir = tempfile.mkdtemp(prefix="sq_streaming_")
        try:
            csv_path = os.path.join(workdir, "events.csv")
            ckpt_dir = os.path.join(workdir, "ckpt")

            X = write_events(csv_path)
            print(f"wrote {X.shape[0]} rows to {csv_path} "
                  f"(parser: {PARSER})")

            est = new_estimator()
            stream = csv_stream_batches(csv_path, batch_rows=1024)
            for i, batch in enumerate(stream):
                est.partial_fit(batch)
                if i == 9:  # simulate an interruption mid-ingest
                    save_estimator(est, ckpt_dir)
                    saved_steps, saved_inertia = est.n_steps_, est.inertia_
                    print(f"checkpointed after {est.n_steps_} batches "
                          f"(inertia {est.inertia_:.1f})")
                    break

            resumed = load_estimator(ckpt_dir)
            for batch in stream:  # the SAME stream object — ingest continues
                resumed.partial_fit(batch)
            print(f"resumed to {resumed.n_steps_} batches "
                  f"(inertia {resumed.inertia_:.1f})")

            labels = np.asarray(resumed.predict(X[:10].astype(np.float32)))
            print("labels of first 10 rows:", labels)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    return {"rows": int(X.shape[0]), "saved_steps": int(saved_steps),
            "saved_inertia": float(saved_inertia),
            "n_steps": int(resumed.n_steps_),
            "inertia": float(resumed.inertia_), "labels": labels.tolist(),
            "centers": np.asarray(resumed.cluster_centers_)}


if __name__ == "__main__":
    main()
