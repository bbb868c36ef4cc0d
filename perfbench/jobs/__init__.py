"""The jobs a traffic file can name, and what they share.

A traffic file (``traffic/<mix>.json``) names its ``job`` and gives that
job's parameters; ``jobs/<job>.py`` drives it through the program, request
by request, with ``make(config, traffic, rows, seed, device, impl,
traced)`` returning an object with:

- ``kind``: "fit" or "predict", which the metrics' readers go by;
- ``warm(requests)``: the cell's own requests before the window;
- ``request(i)``: the window's i-th request, ended in a device sync;
- ``recorders``: {name: :class:`Recorder`} of the program functions it
  wraps;
- ``work()``: what each completed request did, for the readers;
- ``release()``: drop the program's state before the judge;
- ``judge()``: (the worst of each compared number, answers judged).

Every job keeps, from the seed, a sample of its answers for the reference
to judge once the window has closed. ``impl="control"`` puts the plain
reference, with TF32 products, in the program's place (never in a
benchmark run: see ``readings.py``).
"""

import random

import torch

from perfbench import named


class Sample:
    """A reservoir sample, drawn from the seed, of at most ``size``
    answers in each stratum."""

    def __init__(self, size, seed):
        self.size = size
        self.rng = random.Random(seed)
        self.seen = {}
        self.kept = {}

    def offer(self, stratum, make):
        """Count one answer of ``stratum``; ``make()`` builds the record
        to keep, called only if the answer is kept."""
        seen = self.seen.get(stratum, 0)
        kept = self.kept.setdefault(stratum, [])
        if seen < self.size:
            kept.append(make())
        else:
            j = self.rng.randrange(seen + 1)
            if j < self.size:
                kept[j] = make()
        self.seen[stratum] = seen + 1

    def records(self):
        return [r for stratum in sorted(self.kept) for r in self.kept[stratum]]


class Recorder:
    """Wraps a function of the program where a module binds it: keeps the
    last answer and, in a traced run, puts each call in a profiler range
    ``perfbench.<name>`` and records its shape (``shape(*args,
    **kwargs)``, a dict whose device tensors are read after the window)."""

    def __init__(self, module, name, shape, traced):
        self.module, self.name, self.shape = module, name, shape
        self.fn = getattr(module, name)
        self.traced = traced
        self.calls = []
        self.last = None
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.traced:
            self.calls.append(self.shape(*args, **kwargs))
            with torch.profiler.record_function(f"perfbench.{self.name}"):
                out = self.fn(*args, **kwargs)
        else:
            out = self.fn(*args, **kwargs)
        self.last = out
        return out

    def read_calls(self):
        """The recorded calls, each (0-d or 1-d) tensor in them read as its
        sum: all of a key's tensors in one read from the device."""
        calls = [dict(c) for c in self.calls]
        keys = {k for c in calls for k, v in c.items() if torch.is_tensor(v)}
        for key in keys:
            at = [i for i, c in enumerate(calls) if torch.is_tensor(c[key])]
            sums = torch.stack([calls[i][key].reshape(-1).long().sum()
                                for i in at]).tolist()
            for i, s in zip(at, sums):
                calls[i][key] = int(s)
        return calls

    def restore(self):
        setattr(self.module, self.name, self.fn)


def random_state(seed, i):
    """The ``random_state`` of request ``i`` of a run with ``seed``: a
    31-bit number drawn from both, so that every seed fits other starts."""
    return random.Random(f"perfbench:{int(seed)}:{int(i)}").getrandbits(31)


def worst(readings):
    """The largest of each number over the judged answers."""
    out = {}
    for got in readings:
        for name, value in got.items():
            out[name] = max(out.get(name, value), value)
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make(config, traffic, rows, seed, device, impl="program", traced=False):
    """The job that the traffic file names, from ``jobs/<job>.py``."""
    return named.load("jobs", traffic["job"]).make(
        config, traffic, rows, seed, device, impl, traced)
