"""qPCA documentation example, on the port.

The port's counterpart of ``examples/qpca_demo.py`` (the working
equivalent of the reference's ``sklearn/Sheet.py``): fit qPCA on the
digits with every quantum estimator enabled, print the estimated
spectrum and retained variance, and compare quantum-vs-classical
theoretical runtime surfaces.

Run: python examples_torch/qpca_demo.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _device import add_device_argument, on_device  # noqa: E402

import argparse  # noqa: E402
import warnings  # noqa: E402

import numpy as np  # noqa: E402

from sq_learn_tpu_torch.datasets import load_digits  # noqa: E402
from sq_learn_tpu_torch.models import QPCA  # noqa: E402


def main(argv=None):
    ap = add_device_argument(argparse.ArgumentParser())
    args = ap.parse_args(argv)

    with on_device(args.device), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X, _ = load_digits()

        pca = QPCA(n_components=8, random_state=0)
        pca.fit(X, estimate_all=True, theta_estimate=True, p=0.8,
                eps_theta=0.05, eta=0.05, eps=0.1, delta=0.1,
                true_tomography=False, spectral_norm_est=True,
                condition_number_est=True)

        print("classical singular values:",
              np.round(pca.singular_values_, 2))
        print("estimated singular values:",
              np.round(pca.estimate_s_values, 2))
        print("spectral norm: true %.2f, estimated %.2f"
              % (pca.spectral_norm, pca.est_spectral_norm))
        print("estimated theta for p=0.8: %.3f" % pca.est_theta)
        print("top-k selected: %d components carrying %.1f%% variance"
              % (pca.topk, 100 * pca.topk_p))

        n_grid, m_grid, q_rt, c_rt = pca.runtime_comparison(100_000, 1_000)
        crossover = q_rt < c_rt
        print("quantum runtime model beats classical on %.1f%% of the "
              "(n<=100k, m<=1k) grid" % (100 * crossover.mean()))
    return {"singular_values": np.asarray(pca.singular_values_).tolist(),
            "estimated_singular_values":
                np.asarray(pca.estimate_s_values).tolist(),
            "spectral_norm": float(pca.spectral_norm),
            "est_spectral_norm": float(pca.est_spectral_norm),
            "est_theta": float(pca.est_theta), "topk": int(pca.topk),
            "topk_p": float(pca.topk_p),
            "crossover": float(crossover.mean())}


if __name__ == "__main__":
    main()
