"""A plain δ-means fit (the reference q-means of ``true_distance_estimate=
False``) in plain torch, which the control runs in the program's place.

k-means++ starts (greedy, 2 + ⌊ln k⌋ trials), then every restart's Lloyd
loop batched: distances ‖x‖² + ‖c‖² − 2·x·c on the centered rows, a label
drawn uniformly among the centers within δ of the nearest (Gumbel argmax),
the farthest rows moved into empty clusters, the centers updated while the
shift exceeds tol × the mean per-feature variance and, with δ > 0, the best
inertia improved within 10 iterations. Of each restart the better of its
last and its best centers, and of the restarts the best, is returned with
its labels (``keep="worst"`` returns the worst restart instead: a planted
fault, which only ``readings.py`` runs). ``rounding`` is applied to both
operands of every product: :func:`~perfbench.reference.round_tf32` makes
the products TF32.
"""

import math

import torch

from . import no_rounding


def _d2(Xc, xsq, C, rounding):
    """(R, n, k) squared distances of the rows to each restart's centers."""
    csq = (C * C).sum(dim=-1)
    prod = torch.matmul(rounding(Xc), rounding(C).transpose(1, 2))
    return xsq[None, :, None] + csq[:, None, :] - 2.0 * prod


def _pick(d2, delta, gen):
    nearest = d2.min(dim=-1).values
    if delta <= 0:
        return d2.argmin(dim=-1), nearest
    noise = torch.empty_like(d2).exponential_(generator=gen).log_().neg_()
    noise = torch.where(d2 <= (nearest + delta)[..., None], noise,
                        torch.full_like(noise, -torch.inf))
    return noise.argmax(dim=-1), nearest


def _kmeanspp(Xc, xsq, k, R, gen, rounding):
    n = Xc.shape[0]
    trials = 2 + int(math.log(k))
    out = torch.empty((R, k, Xc.shape[1]), dtype=Xc.dtype, device=Xc.device)
    for r in range(R):
        first = torch.randint(0, n, (1,), generator=gen, device=Xc.device)
        out[r, 0] = Xc[first[0]]
        pot = _d2(Xc, xsq, out[r, :1][None], rounding)[0, :, 0].clamp_min(0)
        for c in range(1, k):
            cand = torch.multinomial(pot + 1e-30, trials, replacement=True,
                                     generator=gen)
            dc = _d2(Xc, xsq, Xc[cand][None], rounding)[0].clamp_min(0)
            new_pot = torch.minimum(pot[:, None], dc)
            best = int(new_pot.sum(dim=0).argmin())
            out[r, c] = Xc[cand[best]]
            pot = new_pot[:, best]
    return out


def fit(X, n_clusters, *, n_init=10, max_iter=300, tol=1e-4, delta=0.0,
        seed=0, rounding=no_rounding, patience=10, keep="best"):
    """Fit on X (n, m), float32 or float64; returns {"labels", "centers", "inertia",
    "n_iter"} as host values, as a fitted estimator exposes them."""
    gen = torch.Generator(device=X.device)
    gen.manual_seed(int(seed) % (1 << 63))
    n, _ = X.shape
    k, R = n_clusters, n_init
    mean = X.mean(dim=0)
    Xc = X - mean
    xsq = (Xc * Xc).sum(dim=1)
    tol_abs = tol * float(X.var(dim=0, correction=0).mean())
    C = _kmeanspp(Xc, xsq, k, R, gen, rounding)
    it = torch.zeros(R, dtype=torch.int64, device=X.device)
    shift = torch.full((R,), math.inf, device=X.device)
    best_inertia = torch.full((R,), math.inf, device=X.device)
    best_C, best_it = C.clone(), it.clone()
    active = torch.ones(R, dtype=torch.bool, device=X.device)
    for _ in range(max_iter):
        if not bool(active.any()):
            break
        labels, nearest = _pick(_d2(Xc, xsq, C, rounding), delta, gen)
        inertia = nearest.sum(dim=1)
        sums = torch.zeros_like(C)
        counts = torch.zeros((R, k), device=X.device)
        for r in range(R):
            sums[r].index_add_(0, labels[r], Xc)
            counts[r] = torch.bincount(labels[r], minlength=k).float()
            empty = torch.nonzero(counts[r] == 0).flatten()
            if len(empty):
                far = torch.sort(nearest[r], descending=True,
                                 stable=True).indices[:len(empty)]
                for e, row in zip(empty.tolist(), far.tolist()):
                    donor = int(labels[r, row])
                    sums[r, donor] -= Xc[row]
                    counts[r, donor] -= 1
                    sums[r, e] = Xc[row]
                    counts[r, e] = 1
        safe = torch.where(counts > 0, counts, torch.ones_like(counts))
        new_C = torch.where((counts > 0)[..., None], sums / safe[..., None],
                            C)
        better = active & (inertia < best_inertia)
        best_it = torch.where(better, it, best_it)
        best_inertia = torch.where(better, inertia, best_inertia)
        best_C = torch.where(better[:, None, None], C, best_C)
        new_shift = ((new_C - C) ** 2).sum(dim=(1, 2))
        C = torch.where(active[:, None, None], new_C, C)
        shift = torch.where(active, new_shift, shift)
        it = it + active.long()
        active = (it < max_iter) & (shift > tol_abs)
        if delta > 0:
            active &= it - best_it <= patience
    lab_l, near_l = _pick(_d2(Xc, xsq, C, rounding), delta, gen)
    lab_b, near_b = _pick(_d2(Xc, xsq, best_C, rounding), delta, gen)
    in_l, in_b = near_l.sum(dim=1), near_b.sum(dim=1)
    last = in_l < in_b
    inertia = torch.where(last, in_l, in_b)
    win = int(inertia.argmin() if keep == "best" else inertia.argmax())
    centers = (C if bool(last[win]) else best_C)[win] + mean
    labels = (lab_l if bool(last[win]) else lab_b)[win]
    return {"labels": labels.cpu().numpy(), "centers": centers.cpu().numpy(),
            "inertia": float(inertia[win]), "n_iter": int(it[win])}
