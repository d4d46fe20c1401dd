"""The plain f32 reference of one training step.

Forward in train mode (BatchNorm on batch statistics) with an auxiliary
1x1 head on every decoder block; the loss is the mean cross-entropy of
the main head plus ``aux_weight`` times each aux head's, every head's
logits bilinearly upsampled (``align_corners``) to the labels' size in
f32, pixels whose label lies outside [0, K) ignored. The update is SGD
per group of parameters (``encoder``, ``decoder``, by the first part of
the name): the group's gradient clipped by its global norm (kept where
the norm is under the clip, scaled to the clip otherwise), weight decay
added, then the momentum trace ``trace = momentum * trace + g`` and
``p -= lr * trace``.

Imports torch and the reference model alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.reference.model import Net, from_dict


def nll_mean(logits, labels, num_classes: int):
    """Mean NLL over the pixels whose label lies in [0, K): logits
    [N, K, h, w] upsampled to the labels' [N, H, W] first, in f32."""
    if tuple(logits.shape[-2:]) != tuple(labels.shape[-2:]):
        logits = F.interpolate(logits.float(), size=tuple(labels.shape[-2:]),
                               mode="bilinear", align_corners=True)
    valid = (labels >= 0) & (labels < num_classes)
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -torch.gather(logp, 1, torch.where(valid, labels, 0).long()[:, None])
    nll = torch.where(valid, nll[:, 0], 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def loss_of(weights: Dict[str, torch.Tensor], cfg: dict, images, labels, *,
            aux_weight: float):
    """images: normalized f32 [N, H, W, 3]; labels int [N, H, W]."""
    net = Net(from_dict(weights), cfg, train=True)
    logits, aux = net(images.permute(0, 3, 1, 2).float(), with_aux=True)
    K = int(cfg["num_classes"])
    loss = nll_mean(logits, labels, K)
    for a in aux:
        loss = loss + aux_weight * nll_mean(a, labels, K)
    return loss


def sgd_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             traces: Dict[str, torch.Tensor], groups: dict
             ) -> Dict[str, torch.Tensor]:
    """One update in place; returns the gradients after each group's
    clip (before the weight decay)."""
    clipped = {}
    for key, g in groups.items():
        names = [n for n in params if n.split(".", 1)[0] == key]
        if not names:
            continue
        norm = torch.sqrt(sum(grads[n].double().square().sum()
                              for n in names)).float()
        for n in names:
            gn = grads[n] if norm < g["clip"] else grads[n] / norm * g["clip"]
            clipped[n] = gn
            traces[n] = g["momentum"] * traces[n] + (gn + g["wd"] * params[n])
            params[n] = params[n] - g["lr"] * traces[n]
    return clipped


def run_steps(weights: Dict[str, torch.Tensor], trainable: List[str],
              cfg: dict, batches, *, aux_weight: float, groups: dict):
    """The reference's first ``len(batches)`` steps from ``weights``:
    (losses, the first step's clipped gradients, the parameters after
    the last step). ``trainable`` names the parameters (the rest of
    ``weights`` are BatchNorm statistics, unused in train mode)."""
    params = {n: weights[n].detach().clone() for n in trainable}
    traces = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for images, labels in batches:
        leaves = {n: p.detach().requires_grad_(True)
                  for n, p in params.items()}
        loss = loss_of({**weights, **leaves}, cfg, images, labels,
                       aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            clipped = sgd_step(params, dict(zip(leaves, grads)), traces,
                               groups)
        losses.append(float(loss.detach()))
        if first is None:
            first = clipped
    return losses, first, params
