"""A plain k-nearest search and vote in plain torch, which the control runs
in the program's place: each query ranks the train rows by ‖t‖² − 2·q·t,
keeps the k smallest (ascending) and votes them uniformly, ties to the
lowest class. ``rounding`` is applied to both operands of the product:
:func:`~perfbench.reference.round_tf32` makes it TF32."""

import torch

from . import no_rounding
from .judge import vote


def search(T, Q, k, rounding=no_rounding):
    """(nq, k) int64 indices of each query's k nearest train rows."""
    tsq = (T * T).sum(dim=1)
    Tr = rounding(T)
    out = torch.empty((Q.shape[0], k), dtype=torch.int64, device=Q.device)
    step = max(1, (1 << 27) // T.shape[0])
    for r0 in range(0, Q.shape[0], step):
        score = tsq[None, :] - 2.0 * (rounding(Q[r0:r0 + step]) @ Tr.T)
        out[r0:r0 + step] = torch.topk(score, k, dim=1, largest=False,
                                       sorted=True).indices
    return out


def predict(T, y_train, n_classes, Q, k, rounding=no_rounding):
    """{"labels", "idx"} of one predict, as the judge reads an answer."""
    idx = search(T, Q, k, rounding)
    return {"labels": vote(y_train, idx.cpu().numpy(), n_classes),
            "idx": idx}
