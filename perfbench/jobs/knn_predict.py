"""Job ``knn_predict``: ``KNeighborsClassifier(...)`` is fitted in set-up on
the first ``train_rows`` rows; each request predicts the next
``query_rows`` rows, resident on the device, in one of ``query_orders``
orders drawn from the seed, and ends in a device synchronize.

Traffic keys: ``estimator``, ``train_rows``, ``query_rows``,
``query_orders``, ``warm_requests``, ``judge_sample`` (predicts kept for
the judge).
"""

import torch

from perfbench import data, jobs
from perfbench.reference import judge, round_tf32
from perfbench.reference import knn as ref_knn


def _argkmin_shape(X_train, x_sq_train, X_query, k):
    return {"nq": X_query.shape[0], "nt": X_train.shape[0],
            "m": X_train.shape[1], "k": int(k)}


class PredictJob:
    kind = "predict"

    def __init__(self, config, traffic, rows, seed, device, impl, traced):
        nt, nq = traffic["train_rows"], traffic["query_rows"]
        X, y = rows["X"], rows["y"]
        self.T = X[:nt]
        self.y_train = y[:nt].cpu().numpy()
        self.Q = X[nt:nt + nq]
        self.k = int(traffic["estimator"]["n_neighbors"])
        self.n_classes = config["n_classes"]
        gen = data.generator(seed, device)
        self.orders = [torch.randperm(nq, generator=gen, device=device)
                       for _ in range(traffic["query_orders"])]
        self.queries = [self.Q[o].contiguous() for o in self.orders]
        self.device, self.impl = device, impl
        self.sample = jobs.Sample(traffic["judge_sample"], seed)
        self.rows = []
        self.recorders = {}
        if impl == "program":
            from sq_learn_tpu_torch.models import KNeighborsClassifier
            from sq_learn_tpu_torch.models import neighbors as program

            self.recorders["argkmin"] = jobs.Recorder(
                program, "argkmin", _argkmin_shape, traced)
            self.model = KNeighborsClassifier(
                device=device, **traffic["estimator"]).fit(self.T,
                                                           self.y_train)

    def predict(self, i):
        j = i % len(self.queries)
        if self.impl == "program":
            labels = self.model.predict(self.queries[j])
            idx = self.recorders["argkmin"].last[0]
        else:
            out = ref_knn.predict(self.T, self.y_train, self.n_classes,
                                  self.queries[j], self.k, round_tf32)
            labels, idx = out["labels"], out["idx"]
        jobs.sync(self.device)
        return j, labels, idx

    def warm(self, requests):
        for i in range(requests):
            self.predict(i)

    def request(self, i):
        j, labels, idx = self.predict(i)
        self.rows.append(self.queries[j].shape[0])
        self.sample.offer(0, lambda: {"order": j, "labels": labels,
                                      "idx": idx})

    def work(self):
        nt, m = self.T.shape
        return [{"nq": nq, "nt": nt, "m": m, "k": self.k} for nq in self.rows]

    def release(self):
        for rec in self.recorders.values():
            rec.restore()
        self.model = None

    def judge(self):
        truth = judge.knn_truth(self.T, self.Q, self.k)
        sq_norm = float((self.T.double() ** 2).sum(dim=1).mean())
        records = self.sample.records()
        return jobs.worst(
            judge.knn(self.T, self.queries[rec["order"]], self.y_train,
                      self.n_classes, truth[self.orders[rec["order"]]], rec,
                      self.k, sq_norm)
            for rec in records), len(records)


def make(config, traffic, rows, seed, device, impl, traced):
    return PredictJob(config, traffic, rows, seed, device, impl, traced)
