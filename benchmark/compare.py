"""The training check's measure of two sets of leaves."""

from __future__ import annotations

import torch


def leaf_gap(prog: dict, ref: dict, names, q: float = 1.0) -> float:
    """Each leaf's | |prog| - |ref| | / max(|ref|, median |ref|): the gap
    between the two norms of a leaf, against the reference's norm of that
    leaf or of the median leaf, whichever is larger (some leaves'
    gradients are all but zero). ``q`` = 1: the worst leaf's; 0.5: the
    median leaf's."""
    pn = {n: float(prog[n].double().norm()) for n in names}
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = float(torch.tensor(sorted(rn.values())).median())
    gaps = torch.tensor([abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30)
                         for n in names], dtype=torch.float64)
    return float(gaps.max() if q >= 1.0 else gaps.quantile(q))
