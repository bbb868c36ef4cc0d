"""Decomposition — reference-namespace facade (``sklearn/decomposition``):
``qPCA`` and ``PCA`` resolve to the port's
:class:`~sq_learn_tpu_torch.models.qpca.QPCA` and ``PCA``."""

from ..models.qpca import PCA, QPCA

# the reference's class name (``_qPCA.py:113``)
qPCA = QPCA

_TRUNCATED_SVD = ("TruncatedSVD is not ported yet: ROADMAP.md §1 item 7, "
                  "remaining estimators (models/truncated_svd.py)")


class TruncatedSVD:
    """Placeholder for the JAX package's ``TruncatedSVD``: constructing it
    raises ``NotImplementedError`` naming the ROADMAP item that ports it."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_TRUNCATED_SVD)


__all__ = ["PCA", "QPCA", "qPCA", "TruncatedSVD"]
