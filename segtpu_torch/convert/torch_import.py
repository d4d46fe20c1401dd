"""Upstream PyTorch checkpoints into the port
(counterpart: segtpu/convert/torch_import.py).

The released segmenter ``.ckpt`` state dicts and the ImageNet
MobileNet-v2 weights of the tonylins/pytorch-mobilenet-v2 lineage are
torch state dicts, and the port's modules hold OIHW weights as they do,
so a weight is copied as it is, after a shape check; BatchNorm
``weight``/``bias``/``running_mean``/``running_var`` become the port's
``scale``/``bias``/``mean``/``var``.

* ``load_mbv2_state_dict`` maps the encoder by name (tonylins naming):
  ``features.0.{0,1}`` the stem conv and BN, ``features.{1..17}.conv.{i}``
  the inverted residuals (convs at 0, 3 when the expansion is 1, else at
  0, 3, 6; each BN right after its conv); the classification head
  (``features.18``) is not read.
* ``match_by_shape_order`` maps any state dict whose tensors come in the
  order of the JAX package's parameter tree: a conv-bn consumes [conv
  weight, bn weight, bn bias, running mean, running var], a classifier
  [weight, bias]; ``num_batches_tracked`` is skipped. The first shape
  that does not match and any tensor left over raise.
* ``load_segmenter_checkpoint`` builds the segmenter of a genotype of
  either decoder family and fills it by order.

Each fills the port's module in place and returns it. No JAX import.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from segtpu_torch.core.layers import Conv, ConvBN
from segtpu_torch.models.encoders import _MBV2_CFG, MobileNetV2
from segtpu_torch.models.segmenter import Segmenter
from segtpu_torch.utils.helpers import resolve_device

_BN_NAMES = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
             ("var", "running_var"))


def _to_np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _fill(dst: torch.Tensor, src, what: str) -> None:
    arr = _to_np(src)
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch at '{what}': torch {arr.shape} vs "
                         f"the model's {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(arr))


def _conv_bn(m: ConvBN, sd: Dict[str, Any], conv_key: str, bn_key: str):
    _fill(m.w, sd[conv_key + ".weight"], conv_key + ".weight")
    for ours, theirs in _BN_NAMES:
        key = f"{bn_key}.{theirs}"
        _fill(getattr(m, ours), sd[key], key)


def _unwrap(sd):
    """A checkpoint's state dict: under ``state_dict`` if nested, with
    ``module.`` (DataParallel) taken out of every key."""
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.replace("module.", ""): v for k, v in sd.items()}


def load_mbv2_state_dict(sd: Dict[str, Any], model: MobileNetV2 = None, *,
                         prefix: str = "features.") -> MobileNetV2:
    """A tonylins-named torch state dict into the port's ``MobileNetV2``
    (a new one when ``model`` is None), in place; returns it. A missing
    key raises ``KeyError``, a wrong shape ``ValueError``."""
    if model is None:
        model = MobileNetV2(generator=torch.Generator().manual_seed(0))
    _conv_bn(model.stem, sd, f"{prefix}0.0", f"{prefix}0.1")
    layer = 1
    for t, _, n, _ in _MBV2_CFG:
        for _ in range(n):
            blk = model.blocks[layer - 1]
            base = f"{prefix}{layer}.conv"
            if t == 1:      # [dw, BN, relu, pw, BN]
                _conv_bn(blk.dw, sd, f"{base}.0", f"{base}.1")
                _conv_bn(blk.project, sd, f"{base}.3", f"{base}.4")
            else:           # [pw, BN, relu, dw, BN, relu, pw, BN]
                _conv_bn(blk.expand, sd, f"{base}.0", f"{base}.1")
                _conv_bn(blk.dw, sd, f"{base}.3", f"{base}.4")
                _conv_bn(blk.project, sd, f"{base}.6", f"{base}.7")
            layer += 1
    return model


def load_mbv2_checkpoint(path: str, model: MobileNetV2 = None
                         ) -> MobileNetV2:
    """A torch-saved MobileNet-v2 checkpoint file into ``model`` (a new
    ``MobileNetV2`` when None)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return load_mbv2_state_dict(_unwrap(sd), model)


def match_by_shape_order(sd: Dict[str, Any], model: torch.nn.Module
                         ) -> torch.nn.Module:
    """The tensors of ``sd``, in order, into ``model`` (a port
    ``Segmenter``, ``MobileNetV2`` or decoder) in place, walked in the
    order of the JAX package's parameter tree, which is the order the
    port's modules register their children in: each ``ConvBN`` takes
    [conv weight, bn weight, bn bias, running mean, running var], each
    classifier ``Conv`` [weight, bias]. Every shape is checked; a
    mismatch (a wrong genotype or op table) raises at the first tensor
    that does not fit, and so do tensors left over. Returns ``model``."""
    stream = iter([(k, v) for k, v in sd.items()
                   if not k.endswith("num_batches_tracked")])

    def take(dst, kind):
        try:
            k, v = next(stream)
        except StopIteration:
            raise ValueError(f"state_dict exhausted wanting {kind} "
                             f"{tuple(dst.shape)}")
        _fill(dst, v, f"{k} ({kind})")

    def walk(m):
        if isinstance(m, ConvBN):
            take(m.w, "conv.weight")
            for ours, theirs in _BN_NAMES:
                take(getattr(m, ours), f"bn.{theirs}")
            return
        if isinstance(m, Conv):
            if not hasattr(m, "b"):
                raise TypeError("a conv without bias has no counterpart in "
                                "the parameter tree's walk")
            take(m.w, "conv.weight")
            take(m.b, "conv.bias")
            return
        own = list(m.named_parameters(recurse=False)) + list(
            m.named_buffers(recurse=False))
        if own:
            raise TypeError(f"{type(m).__name__} holds tensors of its own "
                            f"({[n for n, _ in own]}) outside a conv")
        for child in m.children():
            walk(child)

    walk(model)
    leftovers = [k for k, _ in stream]
    if leftovers:
        raise ValueError(f"{len(leftovers)} unconsumed torch params, "
                         f"first: {leftovers[0]}")
    return model


def load_segmenter_checkpoint(path: str, genotype, num_classes: int, *,
                              device="cuda"):
    """A released segmenter ``.ckpt``: the port's ``Segmenter`` for
    ``genotype`` (either decoder family) filled by
    ``match_by_shape_order``, in eval mode, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = Segmenter(genotype, num_classes,
                      generator=torch.Generator().manual_seed(0))
    match_by_shape_order(_unwrap(sd), model)
    return model.eval().to(dev)
