"""Segmentation metrics (counterpart: segtpu/utils/metrics.py).

The confusion matrix is one ``torch.bincount`` over ``gt * K + pred`` on
the labels' device; a pixel whose label lies outside [0, K) (255 marks
ignore) counts nowhere. The rest are the JAX package's numpy functions.
"""

from __future__ import annotations

import numpy as np
import torch

IGNORE_LABEL = 255


def confusion_matrix(pred, gt, num_classes: int):
    """[..., H, W] int predictions/labels -> [K, K] int64 confusion matrix.

    Rows = ground truth, cols = prediction."""
    k = num_classes
    pred = torch.as_tensor(pred).reshape(-1).long()
    gt = torch.as_tensor(gt).reshape(-1).long().to(pred.device)
    valid = (gt >= 0) & (gt < k)
    idx = torch.where(valid, gt * k + pred, k * k)
    return torch.bincount(idx, minlength=k * k + 1)[:k * k].reshape(k, k)


def compute_iu(cm) -> np.ndarray:
    """Per-class IoU from a confusion matrix; NaN for a class absent from
    both rows and columns."""
    cm = np.asarray(cm, np.float64)
    tp = np.diag(cm)
    denom = cm.sum(0) + cm.sum(1) - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        iu = np.where(denom > 0, tp / denom, np.nan)
    return iu


def mean_iou(cm) -> float:
    iu = compute_iu(cm)
    return float(np.nanmean(iu))


def spearman(a, b) -> float:
    """Spearman rank correlation (average ranks for ties)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)

    def ranks(x):
        order = np.argsort(x, kind="mergesort")
        r = np.empty_like(x)
        r[order] = np.arange(len(x), dtype=np.float64)
        for v in np.unique(x):           # average tied ranks
            m = x == v
            r[m] = r[m].mean()
        return r

    ra, rb = ranks(a), ranks(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0
