"""RL controller: an LSTM that emits decoder genotypes
(counterpart: segtpu/rl/controller.py).

An LSTM (hidden ~100) with token embeddings emits the genotype slot by
slot: the contextual cell (the first op, then per node two positions
and two ops), then per block a connection pair (the micro spec), or per
block two pool indices, an aggregation and an op (the template spec).
Each slot has its own vocabulary size; a [n_slots, max_vocab] validity
mask holds them, and every slot's categorical is masked by its row
(invalid logits -1e9, the entropy summed over the valid entries only).
The JAX package's ``lax.scan`` over the slots is a Python loop here.

The parameters are a tree of tensors with the JAX package's names
(``embed``, ``slot_embed``, ``lstm.{wx,wh,b}``, ``head.{w,b}``), so
weights carry across (``convert.from_jax.load_jax_controller``) and
snapshots are read by both packages. ``evaluate`` takes actions
[n_slots] or a batch [K, n_slots].
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch

from segtpu_torch.ops.layer_factory import NUM_OPS


class MicroControllerSpec(NamedTuple):
    """Static description of the micro (CVPR'19) decision sequence."""
    num_enc_taps: int = 4
    num_blocks: int = 3      # merge blocks (conns pairs)
    num_cell_nodes: int = 3  # paired nodes after node 0
    num_ops: int = NUM_OPS
    hidden_size: int = 100   # reference --lstm-hidden-size
    emb_size: int = 100      # reference --op-size token embedding dim
    logit_tanh: float = 2.5  # ENAS-style logit squashing (0 = off)

    @property
    def slot_sizes(self) -> List[int]:
        """Vocabulary size per decision slot, in sampling order:
        [op0] + per cell node k: [pos, pos, op, op] + per block: [i, j]."""
        sizes = [self.num_ops]
        for k in range(1, self.num_cell_nodes + 1):
            sizes += [k + 1, k + 1, self.num_ops, self.num_ops]
        for b in range(self.num_blocks):
            sizes += [self.num_enc_taps + b] * 2
        return sizes

    @property
    def n_slots(self) -> int:
        return len(self.slot_sizes)

    @property
    def max_vocab(self) -> int:
        return max(self.slot_sizes)

    def mask(self) -> np.ndarray:
        return _mask(self.slot_sizes)


class TemplateControllerSpec(NamedTuple):
    """The template (WACV'20) decision sequence: per block two pool
    indices, an aggregation template and a post-op."""
    num_enc_taps: int = 4
    num_blocks: int = 3
    num_agg_ops: int = 2     # AGG_OP_NAMES: psum, cat
    num_ops: int = NUM_OPS
    hidden_size: int = 100
    emb_size: int = 100
    logit_tanh: float = 2.5

    @property
    def slot_sizes(self) -> List[int]:
        sizes: List[int] = []
        for b in range(self.num_blocks):
            pool = self.num_enc_taps + b
            sizes += [pool, pool, self.num_agg_ops, self.num_ops]
        return sizes

    @property
    def n_slots(self) -> int:
        return len(self.slot_sizes)

    @property
    def max_vocab(self) -> int:
        return max(self.slot_sizes)

    def mask(self) -> np.ndarray:
        return _mask(self.slot_sizes)


def _mask(sizes) -> np.ndarray:
    m = np.zeros((len(sizes), max(sizes)), np.bool_)
    for i, s in enumerate(sizes):
        m[i, :s] = True
    return m


def controller_init(generator: torch.Generator, spec, *, device="cpu",
                    dtype=torch.float32):
    """The controller's parameter tree: uniform(-1, 1) * sqrt(1 / fan)
    from ``generator`` (a CPU generator), biases zero, on ``device``."""
    h, e, v = spec.hidden_size, spec.emb_size, spec.max_vocab

    def u(shape, fan):
        return ((torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1)
                * math.sqrt(1.0 / fan)).to(device)

    return {
        # token embeddings (+1 row: the start token)
        "embed": u((v + 1, e), e),
        # slot-type embedding added to the input (tells decisions apart)
        "slot_embed": u((spec.n_slots, e), e),
        "lstm": {
            "wx": u((e, 4 * h), e),
            "wh": u((h, 4 * h), h),
            "b": torch.zeros(4 * h, dtype=dtype, device=device),
        },
        "head": {"w": u((h, v), h),
                 "b": torch.zeros(v, dtype=dtype, device=device)},
    }


def _lstm_step(p, h, c, x):
    z = x @ p["wx"] + h @ p["wh"] + p["b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _slot_logits(params, spec, h):
    logits = h @ params["head"]["w"] + params["head"]["b"]
    if spec.logit_tanh > 0:
        logits = spec.logit_tanh * torch.tanh(logits)
    return logits


def _masked_dist(logits, mask):
    """-> (masked logits, log-probs, entropy over the valid entries)."""
    logits = torch.where(mask, logits, -1e9)
    logp = torch.log_softmax(logits, dim=-1)
    p = torch.exp(logp)
    entropy = -torch.where(mask, p * logp, 0.0).sum(-1)
    return logits, logp, entropy


def _start(params, spec, batch):
    dev, dt = params["embed"].device, params["embed"].dtype
    h = torch.zeros(*batch, spec.hidden_size, device=dev, dtype=dt)
    x = params["embed"][spec.max_vocab].expand(*batch, spec.emb_size)
    return h, h, x


def _slot_mask(spec, device):
    return torch.as_tensor(spec.mask(), device=device)


@torch.no_grad()
def sample(params, spec, generator: torch.Generator):
    """-> (actions [n_slots] int64, log-probs [n_slots], entropies
    [n_slots]), each slot drawn from its masked categorical with
    ``generator``, which lies on the parameters' device."""
    mask = _slot_mask(spec, params["embed"].device)
    h, c, x = _start(params, spec, ())
    actions, logprobs, entropies = [], [], []
    for s in range(spec.n_slots):
        h, c = _lstm_step(params["lstm"], h, c, x + params["slot_embed"][s])
        logits, logp, entropy = _masked_dist(
            _slot_logits(params, spec, h), mask[s])
        a = torch.multinomial(torch.softmax(logits, -1), 1,
                              generator=generator)[0]
        actions.append(a)
        logprobs.append(logp[a])
        entropies.append(entropy)
        x = params["embed"][a]
    return (torch.stack(actions), torch.stack(logprobs),
            torch.stack(entropies))


def evaluate(params, spec, actions):
    """Re-score stored actions ([n_slots], or [K, n_slots]) -> (log-probs,
    entropies) of the same shape, differentiable in ``params``."""
    dev = params["embed"].device
    if not isinstance(actions, torch.Tensor):
        actions = torch.from_numpy(np.array(actions, np.int64))
    actions = actions.to(dev).long()
    mask = _slot_mask(spec, dev)
    h, c, x = _start(params, spec, actions.shape[:-1])
    logprobs, entropies = [], []
    for s in range(spec.n_slots):
        a = actions[..., s]
        h, c = _lstm_step(params["lstm"], h, c, x + params["slot_embed"][s])
        _, logp, entropy = _masked_dist(_slot_logits(params, spec, h),
                                        mask[s])
        logprobs.append(torch.gather(logp, -1, a[..., None])[..., 0])
        entropies.append(entropy)
        x = params["embed"][a]
    return torch.stack(logprobs, -1), torch.stack(entropies, -1)


def _ints(actions) -> List[int]:
    if isinstance(actions, torch.Tensor):
        actions = actions.detach().cpu().numpy()
    return [int(x) for x in np.asarray(actions)]


def genotype_from_actions(actions, spec: MicroControllerSpec):
    """Decode a sampled action vector into [cell_config, conns]."""
    a = _ints(actions)
    assert len(a) == spec.n_slots
    it = iter(a)
    cell = [next(it)]
    for _ in range(spec.num_cell_nodes):
        p1, p2, o1, o2 = next(it), next(it), next(it), next(it)
        cell.append([p1, p2, o1, o2])
    conns = [[next(it), next(it)] for _ in range(spec.num_blocks)]
    return [cell, conns]


def template_genotype_from_actions(actions, spec: TemplateControllerSpec):
    """Decode actions -> [[i, j, agg, op], ...] (a template genotype)."""
    a = _ints(actions)
    assert len(a) == spec.n_slots
    it = iter(a)
    return [[next(it), next(it), next(it), next(it)]
            for _ in range(spec.num_blocks)]


def actions_from_genotype(genotype, spec: MicroControllerSpec):
    """Inverse of ``genotype_from_actions``: [cell_config, conns] -> the
    action vector [n_slots] int64, in the controller's slot order."""
    cell, conns = genotype
    a: list = [cell[0]]
    for p1, p2, o1, o2 in cell[1:]:
        a.extend([p1, p2, o1, o2])
    for i, j in conns:
        a.extend([i, j])
    assert len(a) == spec.n_slots
    return torch.tensor(a, dtype=torch.int64)
