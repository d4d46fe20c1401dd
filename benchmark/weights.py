"""Weights and inputs made from ``--seed``, on the device, in a few calls.

Both sides get the same tensors: the program loads the weights into its
model (``program.build_model``), the reference reads them by name.

Weights: every convolution kaiming-uniform (bound sqrt(3 / fan_in)), and
BatchNorm that is not the identity (scale U(0.5, 1.5), bias N(0, 0.1),
running mean N(0, 0.1), running variance U(0.5, 1.5)), so that the
program's folding of BatchNorm into its weights is exercised; the aux
classifiers' biases N(0, 0.1), the main classifier's centred
(``center_classifier``).

Frames: smooth random colour fields (a coarse random image upsampled)
with fine noise on top, so that neighbouring pixels agree and the masks
hold regions of several classes, as street scenes do.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.model import (IMG_MEAN, IMG_STD, Net,
                                       from_dict, normalize, param_spec)

SEED_MASK = (1 << 63) - 1
CENTER_HW = (256, 512)        # the frame the classifier is centred on
CENTER_STREAM = 999


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``(seed, stream)``: one stream for the
    weights, one for each kind of input."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) & SEED_MASK)
    return g


def make_weights(cfg: dict, seed: int, device, *, aux: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """{state-dict name: f32 tensor on ``device``} for the model of
    ``cfg`` (with its aux heads when ``aux``)."""
    spec = param_spec(cfg, aux=aux)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    g = generator(seed, device, 0)
    uni = torch.rand(sum(sizes), generator=g, device=device)
    gau = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(spec, sizes):
        u, z = uni[at:at + n].view(shape), gau[at:at + n].view(shape)
        at += n
        if kind == "conv":
            bound = math.sqrt(3.0 / fan_in)
            out[name] = (2 * u - 1) * bound
        elif kind in ("bn_scale", "bn_var"):
            out[name] = u + 0.5
        elif kind in ("bn_bias", "bn_mean", "clf_bias"):
            out[name] = 0.1 * z
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
    center_classifier(out, cfg, seed, device)
    return out


def center_classifier(weights, cfg: dict, seed: int, device,
                      hw=CENTER_HW):
    """Set the classifier's bias to minus each class's mean logit over a
    frame of the seed (the reference, eval mode, f32, on the CPU in one
    thread, so that a serving cell's set-up loads no convolution library
    and takes as long in every run), so that no
    class wins everywhere: random weights otherwise give a mask of one
    class, whose comparison says little. Masks then hold regions of every
    class, and their boundaries are near-ties, as a trained model's are."""
    host = {k: v.cpu() for k, v in weights.items()}
    host["decoder.clf.b"] = torch.zeros_like(host["decoder.clf.b"])
    frame = make_frames(seed, CENTER_STREAM, 1, *hw, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # on a shared host, threads that wait
    try:                          # on each other made this take 1 to 8 s
        with torch.no_grad():
            logits = Net(from_dict(host), cfg)(normalize(frame))
    finally:
        torch.set_num_threads(threads)
    weights["decoder.clf.b"] = (-logits.mean((0, 2, 3))).to(device)


def smooth_fields(g, n: int, h: int, w: int, device, *, cell: int = 64):
    """[n, 3, h, w] f32 in [0, 1]: a coarse random field (one value per
    ``cell`` pixels) upsampled bilinearly, plus noise of a tenth."""
    coarse = torch.rand((n, 3, max(h // cell, 1) + 1, max(w // cell, 1) + 1),
                        generator=g, device=device)
    x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=True)
    x = x + 0.1 * (torch.rand((n, 3, h, w), generator=g, device=device)
                   - 0.5)
    return x.clamp(0, 1)


def make_frames(seed: int, stream: int, n: int, h: int, w: int, device):
    """uint8 frames [n, h, w, 3] on ``device``."""
    g = generator(seed, device, stream)
    x = smooth_fields(g, n, h, w, device)
    return (x * 255).round().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def make_train_batch(seed: int, stream: int, n: int, h: int, w: int,
                     num_classes: int, ignore_share: float, device):
    """(images: normalized f32 [n, h, w, 3], labels: int64 [n, h, w]) on
    ``device``: frames as ``make_frames`` normalized as the loaders do,
    and labels constant on 16x16 squares, a square ignored (255) with
    probability ``ignore_share``."""
    g = generator(seed, device, stream)
    x = smooth_fields(g, n, h, w, device)
    mean = x.new_tensor(IMG_MEAN)[:, None, None]
    std = x.new_tensor(IMG_STD)[:, None, None]
    images = ((x - mean) / std).permute(0, 2, 3, 1).contiguous()
    qh, qw = -(-h // 16), -(-w // 16)
    cls = torch.randint(0, num_classes, (n, qh, qw), generator=g,
                        device=device)
    drop = torch.rand((n, qh, qw), generator=g, device=device) < ignore_share
    cls = torch.where(drop, 255, cls)
    labels = cls.repeat_interleave(16, 1).repeat_interleave(16, 2)
    return images, labels[:, :h, :w].contiguous()
