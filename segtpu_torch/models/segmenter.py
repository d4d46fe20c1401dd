"""Encoder + decoder composition (counterpart: segtpu/models/segmenter.py).

``Segmenter.forward`` returns logits at 1/4 input resolution
[N, K, H/4, W/4]; the engine upsamples.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS, MobileNetV2
from segtpu_torch.models.families import get_family, infer_family
from segtpu_torch.utils.helpers import resolve_device


class Segmenter(nn.Module):
    """MobileNet-v2 encoder + genotype decoder, eval mode.

    x: [N, 3, H, W] (``input_format="nhwc3"``) or its space-to-depth
    form [N, 12, H/2, W/2] (``"s2d12"``); H and W multiples of 32.
    """

    def __init__(self, genotype, num_classes: int, *, agg_size: int = 48,
                 repeats: int = 1, family: str = None,
                 generator: torch.Generator):
        super().__init__()
        fam = get_family(family) if family else infer_family(genotype)
        fam.validate(genotype)
        self.genotype = genotype
        self.num_classes = num_classes
        self.encoder = MobileNetV2(generator=generator)
        self.decoder = fam.build(genotype, MBV2_TAP_CHANNELS, num_classes,
                                 agg_size=agg_size, repeats=repeats,
                                 generator=generator)

    def forward(self, x, *, input_format: str = "nhwc3",
                align_corners: bool = True):
        taps = self.encoder(x, input_format=input_format)
        return self.decoder(taps, align_corners=align_corners)


def create_segmenter(genotype, num_classes: int, *,
                     generator: torch.Generator, device="cuda",
                     **kw) -> Segmenter:
    """A ``Segmenter`` initialized from ``generator`` (a CPU
    ``torch.Generator``), in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = Segmenter(genotype, num_classes, generator=generator, **kw)
    return model.eval().to(dev)

