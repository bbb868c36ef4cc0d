"""The framework's thesis as one runnable driver, on the port: δ is an
explicit accuracy/runtime dial.

The port's counterpart of ``examples/delta_tradeoff.py``: sweeps the
q-means quantum error budget δ over an overlapping-class dataset (the
CICIDS-shaped surrogate, whose graded near-duplicate class pairs merge
progressively as δ grows — reference ``README.rst:26-44`` describes
exactly this trade-off without ever measuring it) and prints ARI +
wall-clock per δ beside a classical sklearn KMeans baseline, where
sklearn is installed. The rows are standardized on the device, and
every fit's Lloyd steps run the fused Lloyd kernel on the card.

Run: python examples_torch/delta_tradeoff.py [--n-samples 20000]
     [--n-init 10] [--device cpu]

Deliberately NOT the same configuration as BASELINE #5 (50k rows,
n_init=3): this driver optimizes for a clean demonstration at a smaller
default size, where 3 restarts can land in a pair-merging local optimum
that muddies the curve; n_init=10 (sklearn's own default) makes δ the
only variable.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device, synchronize  # noqa: E402

import argparse  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402

DELTAS = (0.0, 0.1, 0.3, 0.5, 1.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-samples", type=int, default=20_000)
    # sklearn's KMeans default; fewer restarts can land in a
    # pair-merging local optimum (see module docstring)
    ap.add_argument("--n-init", type=int, default=10)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    with on_device(args.device) as device, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from sq_learn_tpu_torch.datasets import load_cicids
        from sq_learn_tpu_torch.metrics import adjusted_rand_score
        from sq_learn_tpu_torch.models import QKMeans
        from sq_learn_tpu_torch.preprocessing import StandardScaler

        X, y, real = load_cicids(n_samples=args.n_samples)
        if len(X) > args.n_samples:
            # the real-CSV branch of load_cicids returns every row; honor
            # the flag by subsampling (deterministic) so quick demos stay
            # quick
            idx = np.random.default_rng(0).choice(
                len(X), args.n_samples, replace=False)
            X, y = X[idx], y[idx]
        X = StandardScaler().fit_transform(X)  # a tensor on the device
        k = int(len(np.unique(y)))
        print(f"dataset: {X.shape[0]}x{X.shape[1]}, k={k} "
              f"({'real CICIDS' if real else 'surrogate'})")

        sklearn_ari = None
        try:
            from sklearn.cluster import KMeans as SKKMeans
            from sklearn.metrics import adjusted_rand_score as sk_ari

            t0 = time.perf_counter()
            sk = SKKMeans(n_clusters=k, n_init=args.n_init,
                          random_state=0).fit(X.cpu().numpy())
            sklearn_ari = float(sk_ari(y, sk.labels_))
            print(f"classical sklearn KMeans: ARI "
                  f"{sklearn_ari:.3f} in "
                  f"{time.perf_counter() - t0:.2f}s  (the exact answer at "
                  f"full classical cost)")
        except Exception as exc:
            print(f"(classical sklearn baseline unavailable: {exc} — "
                  "showing the δ-sweep alone)")

        print(f"{'δ':>5} | {'ARI':>6} | {'fit s':>7} | note")
        sweep = {}
        for delta in DELTAS:
            est = QKMeans(n_clusters=k, n_init=args.n_init, delta=delta,
                          true_distance_estimate=False, random_state=0)
            t0 = time.perf_counter()
            est.fit(X)
            synchronize(device)
            t = time.perf_counter() - t0
            ari = float(adjusted_rand_score(y, est.labels_))
            sweep[delta] = {"ari": ari, "fit_s": t, "n_iter": est.n_iter_}
            note = ("exact classical Lloyd" if delta == 0
                    else "δ-window label noise")
            print(f"{delta:5.1f} | {ari:6.3f} | {t:7.3f} | {note}")
    print("\nδ=0 matches classical quality; growing δ trades clustering "
          "accuracy for a cheaper quantum circuit — the dial the "
          "reference's README describes.")
    return {"shape": tuple(X.shape), "k": k, "real": real,
            "sklearn_ari": sklearn_ari, "sweep": sweep}


if __name__ == "__main__":
    main()
