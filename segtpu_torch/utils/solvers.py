"""Optimizers (counterpart: segtpu/utils/solvers.py).

``GroupSGD`` runs the JAX package's optax chain on each group of
parameters, exactly:

1. ``clip_by_global_norm(clip)``: the group's norm is
   sqrt(sum of every leaf's sum of squares); gradients stay as they are
   while norm < clip and become ``g / norm * clip`` otherwise (not
   ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 and clamps);
2. ``add_decayed_weights(wd)``: ``g + wd * p``;
3. ``sgd(lr, momentum)``: ``trace = g + momentum * trace`` from zeros,
   then ``p += -lr * trace`` (momentum 0 is optax's plain ``sgd(lr)``).

A parameter without a gradient (a frozen encoder's) steps on a zero
gradient, as optax steps on the zeros ``stop_gradient`` gives: its
weight decay and momentum still move it. Parameters and state are
updated in place.

``PopulationSGD`` is the same chain on each sample of a K-stacked
population (the supernet's vmapped chain): one norm per sample.

``Adam`` is ``optax.adam(lr)``, the search controller's optimizer, on
nested dicts of tensors, without updating in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from segtpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class SGDGroup:
    lr: float
    momentum: float
    wd: float
    clip: float


def _device_of(params: Mapping[str, torch.Tensor]):
    """The device of the first tensor of ``params`` (None when empty)."""
    for t in params.values():
        return t.device
    return None


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of every tensor's sum of squares), a 0-d f32 tensor."""
    norms = torch._foreach_norm(list(tensors))
    return torch.stack(norms).square().sum().sqrt()


class GroupSGD:
    """Per-group SGD: ``groups`` maps a label to its ``SGDGroup``. A single
    group takes every parameter; several split them by top-level module,
    ``encoder`` or ``decoder``, as ``optax.multi_transform`` labels the JAX
    tree."""

    def __init__(self, groups: Mapping[str, SGDGroup]):
        self.groups = dict(groups)

    def label(self, name: str) -> str:
        if len(self.groups) == 1:
            return next(iter(self.groups))
        return name.split(".", 1)[0]

    def init(self, params: Mapping[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """The momentum traces, zeros like the parameters."""
        return {n: torch.zeros_like(p, memory_format=torch.preserve_format)
                for n, p in params.items()}

    @torch.no_grad()
    def update(self, grads: Mapping[str, Optional[torch.Tensor]],
               opt_state: Dict[str, torch.Tensor],
               params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One step of every group, in place. Returns each group's global
        gradient norm before the clip. Traced as ``segtpu.train.optimizer``."""
        names: Dict[str, list] = {k: [] for k in self.groups}
        for n in params:
            names[self.label(n)].append(n)
        norms = {}
        with span("segtpu.train.optimizer", device=_device_of(params)):
            for key, cfg in self.groups.items():
                if not names[key]:
                    continue
                p = [params[n] for n in names[key]]
                g = [grads[n] if grads.get(n) is not None
                     else torch.zeros_like(params[n]) for n in names[key]]
                norms[key] = norm = global_norm(g)
                keep = norm < cfg.clip
                g = [torch.where(keep, t, t / norm * cfg.clip) for t in g]
                if cfg.wd:
                    g = torch._foreach_add(g, p, alpha=cfg.wd)
                trace = [opt_state[n] for n in names[key]]
                torch._foreach_mul_(trace, cfg.momentum)
                torch._foreach_add_(trace, g)
                torch._foreach_add_(p, trace, alpha=-cfg.lr)
        return norms


def create_optimisers(*, enc_lr: float = 1e-3, dec_lr: float = 3e-3,
                      enc_mom: float = 0.9, dec_mom: float = 0.9,
                      enc_wd: float = 1e-5, dec_wd: float = 0.0,
                      enc_grad_clip: float = 3.0,
                      dec_grad_clip: float = 3.0) -> GroupSGD:
    """The encoder and decoder groups of a ``Segmenter``'s parameters,
    each with its own lr, momentum, weight decay and clip."""
    return GroupSGD({
        "encoder": SGDGroup(enc_lr, enc_mom, enc_wd, enc_grad_clip),
        "decoder": SGDGroup(dec_lr, dec_mom, dec_wd, dec_grad_clip)})


def sgd_chain(lr: float, *, momentum: float = 0.9, wd: float = 0.0,
              clip: float) -> GroupSGD:
    """One group over every parameter: the JAX search's stage-1 chain
    ``optax.chain(clip_by_global_norm, add_decayed_weights, sgd)``."""
    return GroupSGD({"all": SGDGroup(lr, momentum, wd, clip)})


def _per_sample(v, t):
    """A [K] vector shaped to broadcast over a [K, ...] leaf."""
    return v.reshape((-1,) + (1,) * (t.dim() - 1))


class PopulationSGD:
    """``sgd_chain`` on each sample of a population, the JAX supernet's
    vmapped optax chain: every leaf carries a leading K axis, and sample
    k's gradients are clipped by sample k's own global norm (over the
    k-th slice of every leaf), then decayed, then pushed through the
    momentum trace, as ``GroupSGD`` does for one sample. ``GroupSGD``
    given K-stacked leaves would clip the whole population by one norm.
    ``update`` returns new tensors and changes none it is given."""

    def __init__(self, lr: float, *, momentum: float = 0.9, wd: float = 0.0,
                 clip: float):
        self.group = SGDGroup(lr, momentum, wd, clip)

    @staticmethod
    def norms(grads) -> torch.Tensor:
        """[K]: each sample's sqrt(sum over every leaf of its slice's sum
        of squares)."""
        return torch.stack([torch.linalg.vector_norm(t.flatten(1), dim=1)
                            for t in grads]).square().sum(0).sqrt()

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor],
               opt_state: Mapping[str, torch.Tensor],
               params: Mapping[str, torch.Tensor]):
        """-> (new parameters, new momentum traces)."""
        cfg, names = self.group, list(params)
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        norm = self.norms(g)
        keep = norm < cfg.clip
        g = [torch.where(_per_sample(keep, t), t,
                         t / _per_sample(norm, t) * cfg.clip) for t in g]
        if cfg.wd:
            g = torch._foreach_add(g, p, alpha=cfg.wd)
        trace = torch._foreach_mul([opt_state[n] for n in names],
                                   cfg.momentum)
        torch._foreach_add_(trace, g)
        new_p = torch._foreach_add(p, trace, alpha=-cfg.lr)
        return dict(zip(names, new_p)), dict(zip(names, trace))


def polyak_decay(decay: float, step: int) -> float:
    """``min(decay, step / (step + 1))`` in f32, as the JAX package
    computes Polyak's effective decay."""
    s = np.float32(step)
    return float(np.minimum(np.float32(decay), s / (s + np.float32(1.0))))


@torch.no_grad()
def polyak_update(avg_params: Dict[str, torch.Tensor],
                  params: Mapping[str, torch.Tensor], decay: float,
                  step: int) -> Dict[str, torch.Tensor]:
    """Polyak averaging in place: ``avg = d * avg + (1 - d) * p`` with
    ``d = polyak_decay(decay, step)`` (``step``: the count of steps
    before this one), in f32 as the JAX package computes it: a running
    mean over the first 1 / (1 - decay) steps. Traced as
    ``segtpu.train.polyak``."""
    d = np.float32(polyak_decay(decay, step))
    one_minus = np.float32(1.0) - d
    avg = [avg_params[n] for n in params]
    with span("segtpu.train.polyak", device=_device_of(params)):
        torch._foreach_mul_(avg, float(d))
        torch._foreach_add_(avg, list(params.values()),
                            alpha=float(one_minus))
    return avg_params


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (``rest``: trees of the
    same structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


class AdamState(NamedTuple):
    count: int  # steps taken
    mu: Any     # first moments, a tree like the parameters
    nu: Any     # second moments


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, eps_root 0), written out rather than ``torch.optim.Adam`` so
    that its state is a tree like the parameters and a step returns new
    tensors, as optax's does. optax's arithmetic, in f32 (the bias
    corrections ``1 - decay ** count`` too):

        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * g * g + b2 * nu
        count += 1
        p += -lr * (mu / (1 - b1 ** count)) / (sqrt(nu / (1 - b2 ** count))
                                                + eps)
    """

    def __init__(self, lr: float, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> AdamState:
        zeros = lambda p: torch.zeros_like(p)  # noqa: E731
        return AdamState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        """-> (new parameters, new state); neither input is changed."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        one, n = np.float32(1.0), np.float32(count)
        c1 = float(one - np.float32(b1) ** n)
        c2 = float(one - np.float32(b2) ** n)

        def step(p, m, v):
            return p + (-self.lr) * ((m / c1) / (torch.sqrt(v / c2)
                                                 + self.eps))

        return tree_map(step, params, mu, nu), AdamState(count, mu, nu)
