"""MNIST qPCA + KNN experiment driver, on the port.

The port's counterpart of ``examples/mnist_trial.py`` (the working
equivalent of the reference's ``sklearn/MnistTrial.py:10-28``): load
MNIST (the port's offline surrogate), fit qPCA with the quantum
estimators enabled, apply the quantum transform at a chosen total error
ε+δ, and report 10-fold stratified-CV KNN accuracy plus the F-norm
deviation of the estimated representation. The CV's searches run the
fused k-nearest kernel (``argkmin``) on the card.

Run: python examples_torch/mnist_trial.py [--n-components 61]
     [--eps-delta 0.8] [--subsample 10000] [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device, synchronize  # noqa: E402

import argparse  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from sq_learn_tpu_torch.datasets import load_mnist  # noqa: E402
from sq_learn_tpu_torch.model_selection import (  # noqa: E402
    StratifiedKFold, cross_validate)
from sq_learn_tpu_torch.models import KNeighborsClassifier, QPCA  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-components", type=int, default=61)
    ap.add_argument("--eps-delta", type=float, default=0.8)
    ap.add_argument("--subsample", type=int, default=10_000,
                    help="rows of MNIST to use (0 = all 70k)")
    ap.add_argument("--folds", type=int, default=10)
    add_device_argument(ap)
    args = ap.parse_args(argv)

    with on_device(args.device) as device:
        X, y, real = load_mnist()
        if args.subsample:
            X, y = X[: args.subsample], y[: args.subsample]
        print(f"data: {X.shape} "
              f"({'real MNIST' if real else 'synthetic surrogate'})")

        eps = delta = args.eps_delta / 2
        t0 = time.perf_counter()
        pca = QPCA(n_components=args.n_components, svd_solver="full",
                   random_state=0).fit(
            X, estimate_all=True, eps=eps, delta=delta, theta_major=1e-9,
            true_tomography=False)
        t_fit = time.perf_counter() - t0
        print(f"qPCA fit: {t_fit:.2f}s  (top-k extracted: {pca.topk})")

        t0 = time.perf_counter()
        Xq = pca.transform(X, classic_transform=False,
                           use_classical_components=False)
        synchronize(device)
        t_tr = time.perf_counter() - t0
        Xc = pca.transform(X)
        f_err = float(torch.linalg.norm(Xq - Xc))
        print(f"quantum transform: {t_tr:.2f}s  F-norm deviation vs "
              f"classic: {f_err:.3f}")

        res = cross_validate(
            KNeighborsClassifier(n_neighbors=7), Xq, y,
            cv=StratifiedKFold(args.folds))
        scores = np.asarray(res["test_score"])
        print(f"{args.folds}-fold KNN accuracy: "
              f"{np.mean(scores):.4f} ± {np.std(scores):.4f}")
    return {"shape": tuple(X.shape), "real": real, "fit_s": t_fit,
            "topk": int(pca.topk), "transform_s": t_tr, "f_norm": f_err,
            "folds": args.folds, "cv_mean": float(np.mean(scores)),
            "cv_std": float(np.std(scores)), "scores": scores.tolist()}


if __name__ == "__main__":
    main()
