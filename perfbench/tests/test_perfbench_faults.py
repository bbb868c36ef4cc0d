"""The check of each cell fails the control (the plain reference with TF32
products in the program's place) and a run whose timed path is broken
underneath: once for each fault the cell can have. The runs skip the look
for a card and use small sizes on the CPU."""

import numpy as np
import pytest
import torch

from perfbench import harness


def _cicids_rows(share):
    """The cicids2017 configuration at 1/``share`` of each class's rows."""
    counts = harness.load_cell("cicids2017.delta_sweep")[1]["class_counts"]
    return {"class_counts": {k: max(1, v // share)
                             for k, v in counts.items()}}


#: the sweep's estimator settings at 4 restarts, for a small CPU run
SMALL_FIT = {**harness.load_cell("cicids2017.delta_sweep")[2]["estimator"],
             "n_init": 4}
from sq_learn_tpu_torch.models import QKMeans
from sq_learn_tpu_torch.models import neighbors as knn_module
from sq_learn_tpu_torch.models import qkmeans as qkmeans_module

QMEANS = {
    "mnist784.qmeans": ({"n_samples": 3000}, {}),
    "cicids2017.delta_sweep": (_cicids_rows(400), {"estimator": SMALL_FIT}),
}
KNN = ("mnist784.knn", {"n_samples": 6000},
       {"train_rows": 4000, "query_rows": 2000})


def _run(workload, cfg, traffic, impl="program"):
    return harness.run(workload, 2**31 + 101, 0.5, 0, impl=impl,
                       device="cpu", config_overrides=cfg,
                       traffic_overrides=traffic, log=lambda *a: None)


def _failed(result):
    return [n for n, c in result["checks"].items()
            if not c["value"] <= c["limit"]]


@pytest.mark.parametrize("workload", sorted(QMEANS))
def test_qkmeans_control_fails(workload):
    r = _run(workload, *QMEANS[workload], impl="control")
    assert not r["correct"] and "inertia_gap" in _failed(r)


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(qkmeans_module, "_update_centers",
                        lambda sums, counts, centers: centers)


def _half_batch(monkeypatch):
    fit = QKMeans.fit
    monkeypatch.setattr(QKMeans, "fit",
                        lambda self, X, *a, **kw: fit(self, X[:len(X) // 2],
                                                      *a, **kw))


def _answer_altered(monkeypatch):
    single = qkmeans_module.lloyd_single

    def altered(*args, **kwargs):
        labels, *rest = single(*args, **kwargs)
        k = args[3].shape[1]
        labels = labels.clone()
        labels[:, ::97] = (labels[:, ::97] + 1) % k
        return (labels, *rest)

    monkeypatch.setattr(qkmeans_module, "lloyd_single", altered)


@pytest.mark.parametrize("workload", sorted(QMEANS))
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
def test_qkmeans_fault_fails(workload, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(workload, *QMEANS[workload])
    assert not r["correct"], r["checks"]


def test_optimum_reading_tells_a_worse_restart_from_the_program():
    """``readings.py --optimum``: the program's fit lies at the float64
    reference's optimum, the reference keeping its worst restart well above
    it; the run's limits never compare the number."""
    cfg, traffic = QMEANS["mnist784.qmeans"]
    traffic = {**traffic, "judge_optimum": True}
    got = {}
    for impl in ("program", "worst_restart"):
        numbers = {}
        r = harness.run("mnist784.qmeans", 2**31 + 103, 0.5, 0, impl=impl,
                        device="cpu", config_overrides=cfg,
                        traffic_overrides=traffic, log=lambda *a: None,
                        judged_out=numbers)
        assert "optimum_gap" not in r["checks"]
        got[impl] = numbers["optimum_gap"]
    assert abs(got["program"]) < 1e-6 < 1e-2 < got["worst_restart"]


def test_knn_control_fails():
    r = _run(*KNN, impl="control")
    assert not r["correct"] and _failed(r) == ["neighbor_gap"]


def _search_half(X_train, x_sq, X_query, k):
    half = X_query[:X_query.shape[0] // 2].contiguous()
    return _search(X_train, x_sq, half, k)


def _neighbor_altered(X_train, x_sq, X_query, k):
    idx, d2 = _search(X_train, x_sq, X_query, k)
    idx = idx.clone()
    idx[::13, 0] = (idx[::13, 0] + 1) % X_train.shape[0]
    return idx, d2


def _buffers_unwritten(X_train, x_sq, X_query, k):
    _search(X_train, x_sq, X_query, k)
    return (torch.zeros((X_query.shape[0], k), dtype=torch.int32),
            torch.zeros((X_query.shape[0], k)))


_search = knn_module.argkmin


@pytest.mark.parametrize("fault", [_search_half, _neighbor_altered,
                                   _buffers_unwritten])
def test_knn_fault_fails(fault, monkeypatch):
    monkeypatch.setattr(knn_module, "argkmin", fault)
    r = _run(*KNN)
    assert not r["correct"], r["checks"]


def test_knn_label_altered_fails(monkeypatch):
    predict = knn_module.KNeighborsClassifier.predict

    def altered(self, X):
        labels = np.array(predict(self, X))
        labels[5] = (labels[5] + 1) % 10
        return labels

    monkeypatch.setattr(knn_module.KNeighborsClassifier, "predict", altered)
    r = _run(*KNN)
    assert not r["correct"] and _failed(r) == ["vote_mismatch"]
