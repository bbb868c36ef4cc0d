"""Accuracy vs theoretical quantum runtime — the paper's trade-off,
measured, on the port.

The port's counterpart of ``examples/runtime_tradeoff.py``. The
framework's thesis (reference ``README.rst:26-44``) is that ε/δ are
*runtime* parameters: a looser error budget buys theoretical quantum
runtime and costs accuracy. This driver states that trade-off end to end
with the framework's own instruments:

1. a q-means δ-sweep on clustered synthetic data — measured ARI per δ
   joined with ``QKMeans.quantum_runtime_model`` (the closed-form q-means
   cost, reference ``_dmeans.py:1440-1449``); its fits run the fused
   Lloyd kernel on the card;
2. a qPCA ε+δ-sweep — downstream 1-NN accuracy on the tomography-noised
   projection joined with ``QPCA.accumulate_q_runtime`` (the QADRA
   accountant, reference ``_qPCA.py:1123-1208``); its searches run the
   fused k-nearest kernel;

every point lands as a schema-valid ``tradeoff`` JSONL record, the
guarantee auditor checks the simulated routines honored their declared
(ε, δ) along the way, and the script ends by rendering the frontier
table (``python -m sq_learn_tpu_torch.obs frontier`` over the same
artifact reproduces it). It exits non-zero when the audit flags a site.

Usage: python examples_torch/runtime_tradeoff.py
       [--out /tmp/tradeoff.jsonl] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device  # noqa: E402

import argparse  # noqa: E402

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/sq_runtime_tradeoff.jsonl")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    out_path = args.out

    with on_device(args.device):
        from sq_learn_tpu_torch import obs
        from sq_learn_tpu_torch.metrics import adjusted_rand_score
        from sq_learn_tpu_torch.models import QPCA, QKMeans

        open(out_path, "w").close()
        obs.enable(out_path)
        try:
            result = _sweeps(obs, adjusted_rand_score, QPCA, QKMeans)
            # -- the artifact: audit + frontier over this run's records --
            audit = obs.guarantees.audit()
            flagged = sorted(s for s, a in audit.items() if a["flagged"])
            draws = sum(a["trials"] for a in audit.values())
            print(f"\nguarantee audit ({draws} draws):")
            print(obs.guarantees.render(audit))
            rec = obs.get_recorder()
            sweeps = obs.frontier.collect(rec.tradeoff_records)
            print("\naccuracy vs theoretical quantum runtime:")
            frontier = obs.frontier.render(sweeps)
            print(frontier)
        finally:
            obs.disable()
    print(f"\nartifact: {out_path} "
          f"(render with: python -m sq_learn_tpu_torch.obs frontier "
          f"{out_path})")
    if flagged:
        sys.exit(f"guarantee audit flagged: {flagged}")
    result.update(draws=draws, flagged=flagged, frontier=frontier,
                  out=out_path)
    return result


def _sweeps(obs, adjusted_rand_score, QPCA, QKMeans):
    """Both legs under the enabled recorder; returns their points."""
    rng = np.random.default_rng(0)
    k, m = 6, 32
    # tight margins (center scale ~ cluster scale) so the error dials
    # visibly bend the accuracy instead of saturating at 1.0
    centers = rng.normal(scale=1.6, size=(k, m))
    X = np.concatenate([
        rng.normal(loc=c, scale=1.0, size=(512, m)) for c in centers
    ]).astype(np.float32)
    y = np.repeat(np.arange(k), 512)
    perm = rng.permutation(len(X))  # class-stratified holdout splits
    X, y = X[perm], y[perm]

    # -- leg 1: q-means δ-sweep (ARI vs quantum_runtime_model) ----------
    print("q-means δ-sweep:")
    leg1 = {}
    for delta in (0.0, 2.0, 8.0, 32.0):
        est = QKMeans(n_clusters=k, n_init=2, delta=delta,
                      true_distance_estimate=False, random_state=0).fit(X)
        ari = float(adjusted_rand_score(y, est.labels_))
        q_rt = c_rt = None
        if delta > 0:
            quantum, classical = est.quantum_runtime_model(*X.shape)
            q_rt, c_rt = float(np.ravel(quantum)[0]), float(classical)
        obs.frontier.record_tradeoff(
            "example_qkmeans_delta", delta, accuracy=ari,
            accuracy_metric="ari", q_runtime=q_rt, c_runtime=c_rt,
            budget={"delta": delta})
        leg1[delta] = {"ari": ari, "q_runtime": q_rt}
        print(f"  delta={delta:<4}  ari={ari:.4f}  "
              f"q_runtime={'-' if q_rt is None else f'{q_rt:.3e}'}")

    # -- leg 2: qPCA ε+δ-sweep (1-NN acc vs accumulate_q_runtime) ------
    from sq_learn_tpu_torch.models import KNeighborsClassifier

    n_comp = 8
    pca = QPCA(n_components=n_comp, svd_solver="full", random_state=0)
    pca.fit(X)
    # the QADRA twin fits a subsample, so θ must come from the SAME
    # subsample's spectrum (σ scales with √n — a full-data median would
    # select nothing on the twin and zero out the cost model)
    sub = X[:1024]
    theta = float(np.median(
        QPCA(n_components=n_comp, svd_solver="full",
             random_state=0).fit(sub).singular_values_))
    split = len(X) // 2
    knn = KNeighborsClassifier(n_neighbors=1)
    print("qPCA ε+δ-sweep:")
    leg2 = {}
    for err in (0.4, 1.6, 6.4):
        out = pca.transform(
            X, classic_transform=False, epsilon_delta=err,
            quantum_representation=True, norm="est_representation",
            true_tomography=False)
        Xq, _, f_norm = out["quantum_representation_results"]
        acc = float(np.mean(
            knn.fit(Xq[:split], y[:split]).predict(Xq[split:])
            == y[split:]))
        # the QADRA accountant at this point's ε = δ = err/2 (a twin fit
        # carries the flags; the cost is evaluated at the full shape)
        q = QPCA(n_components=n_comp, svd_solver="full", random_state=0)
        q.fit(sub, estimate_all=True, theta_major=theta,
              eps=err / 2, delta=err / 2, true_tomography=False)
        q_rt = float(np.sum([np.asarray(c, float)
                             for c in q.accumulate_q_runtime(*X.shape)]))
        obs.frontier.record_tradeoff(
            "example_qpca_eps_delta", err, accuracy=acc,
            accuracy_metric="holdout_1nn_acc", q_runtime=q_rt,
            c_runtime=float(X.shape[0]) * float(X.shape[1]) ** 2,
            budget={"eps": err / 2, "delta": err / 2},
            f_norm_err=float(f_norm))
        leg2[err] = {"acc": acc, "q_runtime": q_rt, "f_norm": float(f_norm)}
        print(f"  eps+delta={err:<4}  acc={acc:.4f}  q_runtime={q_rt:.3e}")
    return {"qkmeans": leg1, "qpca": leg2}


if __name__ == "__main__":
    main()
