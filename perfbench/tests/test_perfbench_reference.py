"""The plain reference and the judge against the port's CPU route at a tiny
size (this test imports the port; the reference does not)."""

import numpy as np
import pytest
import torch

from perfbench import data
from perfbench.reference import judge, knn, no_rounding, qkmeans, round_tf32
from sq_learn_tpu_torch.models import KNeighborsClassifier, QKMeans
from sq_learn_tpu_torch.ops import kernels


def _rows(n, m, k, seed=5):
    classes, scales = data.recipe("graded_pair_surrogate").geometry(
        n, m, (0.3, 1.0, 3.0)[:k // 2], seed)
    gen = data.generator(seed, "cpu")
    y = data.uniform_labels(len(classes), n, gen, "cpu")
    return data.rows(classes, scales, 4.0, y, gen, "cpu"), y


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -(1.0 + 2**-12), 3.14159265], dtype=torch.float32)
    r = round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                      # a tie goes to even
    assert r[3] == 1.0 + 2**-9              # a tie goes to even
    assert r[4] == -1.0
    assert abs(float(r[5]) - 3.14159265) <= 3.14159265 * 2**-11
    bits = r.view(torch.int32) & 0x1FFF
    assert int(bits.abs().sum()) == 0


def test_knn_search_agrees_with_the_ports_plain_search():
    X, _ = _rows(900, 64, 6)
    T, Q = X[:700].contiguous(), X[700:].contiguous()
    idx = knn.search(T, Q, 7)
    ref_idx, _ = kernels.argkmin_reference(T, (T * T).sum(1), Q, 7)
    d_ours = judge._exact_sq(Q, T, idx)
    d_port = judge._exact_sq(Q, T, ref_idx.long())
    torch.testing.assert_close(d_ours, d_port, rtol=1e-9, atol=1e-6)


def test_knn_judge_passes_the_ports_predict_and_fails_tf32():
    X, y = _rows(1500, 784, 10)
    T, Q = X[:1200].contiguous(), X[1200:].contiguous()
    y_train = y[:1200].numpy()
    model = KNeighborsClassifier(n_neighbors=7, device="cpu").fit(T, y_train)
    labels = model.predict(Q)
    idx, _ = kernels.argkmin_reference(T, (T * T).sum(1), Q, 7)
    truth = judge.knn_truth(T, Q, 7)
    sq = float((T.double() ** 2).sum(1).mean())
    got = judge.knn(T, Q, y_train, 10, truth, {"labels": labels, "idx": idx},
                    7, sq)
    assert got == {"rows_missing": 0.0, "neighbor_gap": got["neighbor_gap"],
                   "vote_mismatch": 0.0}
    assert got["neighbor_gap"] < 1e-5
    ctl = knn.predict(T, y_train, 10, Q, 7, round_tf32)
    bad = judge.knn(T, Q, y_train, 10, truth, ctl, 7, sq)
    assert bad["neighbor_gap"] > 3 * got["neighbor_gap"]


def test_knn_judge_reads_broken_answers():
    X, y = _rows(600, 32, 6)
    T, Q = X[:500].contiguous(), X[500:].contiguous()
    y_train = y[:500].numpy()
    truth = judge.knn_truth(T, Q, 5)
    sq = float((T.double() ** 2).sum(1).mean())
    good = knn.predict(T, y_train, 6, Q, 5)
    idx = good["idx"].clone()
    idx[:, 0] = idx[:, 1]                    # a repeated neighbour
    assert judge.knn(T, Q, y_train, 6, truth, {**good, "idx": idx}, 5,
                     sq)["neighbor_gap"] == np.inf
    assert judge.knn(T, Q, y_train, 6, truth,
                     {**good, "labels": good["labels"][:50]}, 5,
                     sq)["rows_missing"] == 50
    flipped = good["labels"].copy()
    flipped[3] = (flipped[3] + 1) % 6
    assert judge.knn(T, Q, y_train, 6, truth, {**good, "labels": flipped}, 5,
                     sq)["vote_mismatch"] == 1


def test_qkmeans_judge_passes_the_ports_fit_and_the_reference():
    X, _ = _rows(3000, 64, 6)
    scales = judge.data_scales(X)
    est = QKMeans(n_clusters=6, n_init=4, delta=0.5,
                  true_distance_estimate=False, sketch=0, random_state=3,
                  device="cpu").fit(X)
    fit = {"labels": est.labels_, "centers": est.cluster_centers_,
           "inertia": est.inertia_}
    got = judge.qkmeans(X, fit, 0.5, scales, settled=True)
    assert got["rows_missing"] == 0 and got["labels_outside"] == 0
    assert got["inertia_gap"] < 1e-5 and got["window_excess"] < 1e-5
    ref = qkmeans.fit(X, 6, n_init=4, delta=0.5, seed=3,
                      rounding=no_rounding)
    got = judge.qkmeans(X, ref, 0.5, scales, settled=True)
    assert got["inertia_gap"] < 1e-5 and got["labels_outside"] == 0


def test_qkmeans_judge_reads_broken_fits():
    X, _ = _rows(3000, 64, 6)
    scales = judge.data_scales(X)
    ref = qkmeans.fit(X, 6, n_init=2, delta=0.0, seed=1)
    assert judge.qkmeans(X, {**ref, "labels": ref["labels"][:10]}, 0.0,
                         scales)["rows_missing"] == 2990
    moved = ref["labels"].copy()
    moved[::50] = (moved[::50] + 1) % 6
    assert judge.qkmeans(X, {**ref, "labels": moved}, 0.0,
                         scales)["labels_outside"] > 0
    start = X[:6].numpy()                    # centers never updated
    lab = torch.cdist(X, X[:6]).argmin(1).numpy()
    d2 = ((X.double()[:, None, :] - X[:6].double()) ** 2).sum(-1)
    stale = {"labels": lab, "centers": start,
             "inertia": float(d2.min(1).values.sum())}
    assert judge.qkmeans(X, stale, 0.0, scales, settled=False)[
        "inertia_gap"] < 1e-6
    assert judge.qkmeans(X, stale, 0.0, scales, settled=True)[
        "inertia_gap"] > 1e-2


@pytest.mark.parametrize("delta", [0.0, 0.5])
def test_reference_fit_keeps_its_labels_in_the_window(delta):
    X, _ = _rows(2000, 32, 6)
    ref = qkmeans.fit(X, 6, n_init=3, delta=delta, seed=2)
    got = judge.qkmeans(X, ref, delta, judge.data_scales(X))
    assert got["labels_outside"] == 0 and got["window_excess"] < 1e-6


def test_optimum_gap_reads_a_worse_restart_against_the_best():
    X, _ = _rows(3000, 64, 6)
    scales = judge.data_scales(X)
    best = qkmeans.fit(X.double(), 6, n_init=6, delta=0.0, seed=4)
    worst = qkmeans.fit(X, 6, n_init=6, delta=0.0, seed=4, keep="worst")
    assert worst["inertia"] >= best["inertia"]
    same = judge.qkmeans(X, best, 0.0, scales,
                         reference_inertia=best["inertia"])
    assert abs(same["optimum_gap"]) < 1e-9
    got = judge.qkmeans(X, worst, 0.0, scales,
                        reference_inertia=best["inertia"])
    assert got["optimum_gap"] == pytest.approx(
        worst["inertia"] / best["inertia"] - 1, rel=1e-4, abs=1e-9)
    assert "optimum_gap" not in judge.qkmeans(X, best, 0.0, scales)
