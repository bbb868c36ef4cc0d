"""SVM — reference-namespace facade (``sklearn/svm``): ``QLSSVC``
(``svm/_qSVM.py:10``), the quantum least-squares SVM, resolves to the
port's :class:`~sq_learn_tpu_torch.models.qlssvc.QLSSVC`."""

from ..models.qlssvc import QLSSVC, lssvc_solve

__all__ = ["QLSSVC", "lssvc_solve"]
