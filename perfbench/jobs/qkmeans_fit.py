"""Job ``qkmeans_fit``: repeated q-means sweeps on the rows resident on the
device. Request ``i`` is one user's sweep: one ``QKMeans(...).fit(X)`` for
each δ of the traffic's ``deltas`` in turn, with its ``estimator``
settings and one ``random_state`` drawn from the run's seed and ``i``
(:func:`perfbench.jobs.random_state`), so that every seed fits other
starts. Each fit ends in a device synchronize.

Traffic keys: ``estimator``, ``deltas``, ``warm_requests``,
``judge_sample`` (fits kept per δ for the judge), and ``judge_optimum``,
which only ``readings.py`` sets: the judge also fits the plain float64
reference on each sampled fit's settings and reads ``optimum_gap``.
``impl="worst_restart"`` (``readings.py`` alone) runs the plain float32
reference keeping its worst restart: the fault that number is about.
"""

import time

from perfbench import jobs
from perfbench.reference import judge, round_tf32
from perfbench.reference import qkmeans as ref_qkmeans


def _lloyd_shape(X, weights, x_sq_norms, centers, *, gumbel=None,
                 window=0.0, active=None):
    R, k, _ = centers.shape
    return {"n": X.shape[0], "m": X.shape[1], "k": k, "R": R,
            "active": R if active is None else active,
            "x_itemsize": X.element_size()}


class FitJob:
    kind = "fit"

    def __init__(self, config, traffic, rows, seed, device, impl, traced):
        self.X = rows["X"]
        self.k = config["n_clusters"]
        self.deltas = [float(d) for d in traffic["deltas"]]
        self.settings = dict(traffic["estimator"])
        self.seed, self.device, self.impl = seed, device, impl
        self.sample = jobs.Sample(traffic["judge_sample"], seed)
        self.optimum = bool(traffic.get("judge_optimum", False))
        self.fits = []  # (n_iter, seconds) of every fit in the window
        self.recorders = {}
        if impl == "program":
            from sq_learn_tpu_torch.models import QKMeans
            from sq_learn_tpu_torch.models import qkmeans as program

            self.estimator = QKMeans
            self.recorders["lloyd_step"] = jobs.Recorder(
                program, "lloyd_step", _lloyd_shape, traced)

    def fit(self, random_state, delta):
        t0 = time.perf_counter()
        if self.impl == "program":
            est = self.estimator(n_clusters=self.k, delta=delta,
                                 random_state=random_state,
                                 device=self.device, **self.settings)
            est.fit(self.X)
            out = {"labels": est.labels_, "centers": est.cluster_centers_,
                   "inertia": est.inertia_, "n_iter": int(est.n_iter_)}
        elif self.impl == "worst_restart":
            out = self.reference(self.X, random_state, delta, keep="worst")
        else:
            out = self.reference(self.X, random_state, delta,
                                 rounding=round_tf32)
        jobs.sync(self.device)
        out["seconds"] = time.perf_counter() - t0
        return out

    def reference(self, X, random_state, delta, **kwargs):
        """The plain reference's fit of X at the job's settings."""
        s = self.settings
        return ref_qkmeans.fit(
            X, self.k, n_init=s.get("n_init", 10),
            max_iter=s.get("max_iter", 300), tol=s.get("tol", 1e-4),
            delta=delta, seed=random_state, **kwargs)

    def sweep(self, i):
        rs = jobs.random_state(self.seed, i)
        return [(d, rs, self.fit(rs, d)) for d in self.deltas]

    def warm(self, requests):
        for i in range(requests):
            self.sweep(-1 - i)

    def request(self, i):
        for delta, rs, out in self.sweep(i):
            self.fits.append((out["n_iter"], out["seconds"]))
            self.sample.offer(self.deltas.index(delta),
                              lambda: {"delta": delta, "random_state": rs,
                                       **out})

    def work(self):
        """What each completed fit did, for the metrics' readers: its
        shape, ``n_iter_`` and seconds (call to device synchronize)."""
        n, m = self.X.shape
        R = self.settings.get("n_init", 10)
        return [{"n": n, "m": m, "k": self.k, "R": R, "n_iter": it,
                 "seconds": sec} for it, sec in self.fits]

    def release(self):
        for rec in self.recorders.values():
            rec.restore()

    def judge(self):
        """The worst of each number over the sampled fits. The fits at the
        mix's smallest δ are judged as settled (one exact Lloyd step from
        their centers); a wide δ-window stops the loop on its patience rule
        away from a fixed point."""
        scales = judge.data_scales(self.X)
        records = self.sample.records()
        X64 = self.X.double() if self.optimum else None

        def one(rec):
            best = None
            if X64 is not None:
                best = self.reference(X64, rec["random_state"],
                                      rec["delta"])["inertia"]
            return judge.qkmeans(self.X, rec, rec["delta"], scales,
                                 settled=rec["delta"] == min(self.deltas),
                                 reference_inertia=best)

        return jobs.worst(one(rec) for rec in records), len(records)


def make(config, traffic, rows, seed, device, impl, traced):
    return FitJob(config, traffic, rows, seed, device, impl, traced)
