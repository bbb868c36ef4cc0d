"""Decomposition — reference-namespace facade (``sklearn/decomposition``):
``qPCA``, ``PCA`` and ``TruncatedSVD`` resolve to the port's
:class:`~sq_learn_tpu_torch.models.qpca.QPCA`, ``PCA`` and
:class:`~sq_learn_tpu_torch.models.truncated_svd.TruncatedSVD`."""

from ..models.qpca import PCA, QPCA
from ..models.truncated_svd import TruncatedSVD

# the reference's class name (``_qPCA.py:113``)
qPCA = QPCA

__all__ = ["PCA", "QPCA", "qPCA", "TruncatedSVD"]
