"""Reading obs JSONL artifacts (the port's copy of the JAX package's
``load_jsonl``, ``sq_learn_tpu/obs/trace.py:67-90``)."""

import json


def load_jsonl(path):
    """Decode one obs JSONL file into a list of record dicts (lines that
    are not JSON objects are skipped: a partly written run is still
    readable). ``.jsonl.gz`` archives open transparently."""
    if str(path).endswith(".gz"):
        import gzip

        opener = gzip.open(path, "rt")
    else:
        opener = open(path)
    records = []
    with opener as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records
