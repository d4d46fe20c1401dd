"""Encoder + decoder composition (counterpart: segtpu/models/segmenter.py).

``Segmenter.forward`` returns logits at 1/4 input resolution
[N, K, H/4, W/4] (the NAS decoders), or at the head's output stride
(the ``deeplab`` family: 1/16); the engine upsamples. In train mode (``.train()``)
every BatchNorm normalizes with its batch's stats and moves its running
stats; ``with_aux`` adds the decoder's auxiliary logits and
``freeze_encoder`` runs the encoder as stage-1 proxy training does.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS, MobileNetV2
from segtpu_torch.models.families import get_family, infer_family
from segtpu_torch.utils.helpers import resolve_device


class Segmenter(nn.Module):
    """MobileNet-v2 encoder + genotype decoder.

    x: [N, 3, H, W] (``input_format="nhwc3"``) or its space-to-depth
    form [N, 12, H/2, W/2] (``"s2d12"``); H and W multiples of 32.
    ``aux`` builds the decoder's per-block auxiliary heads (training),
    ``aux_cell`` a private cell in each (micro family).
    """

    def __init__(self, genotype, num_classes: int, *, agg_size: int = 48,
                 repeats: int = 1, aux: bool = False, aux_cell: bool = False,
                 family: str = None, generator: torch.Generator):
        super().__init__()
        fam = get_family(family) if family else infer_family(genotype)
        fam.validate(genotype)
        self.family = fam.name
        self.genotype = genotype
        self.num_classes = num_classes
        self.encoder = MobileNetV2(
            output_stride=fam.encoder_stride(genotype), generator=generator)
        self.decoder = fam.build(genotype, MBV2_TAP_CHANNELS, num_classes,
                                 agg_size=agg_size, repeats=repeats,
                                 aux=aux, aux_cell=aux_cell,
                                 generator=generator)
        self.eval()

    @classmethod
    def from_parts(cls, genotype, num_classes: int, encoder: nn.Module,
                   decoder: nn.Module) -> "Segmenter":
        """A ``Segmenter`` over ``encoder`` and ``decoder`` themselves (not
        copies), in eval mode: the search's stage 2 goes on from the
        decoder stage 1 trained."""
        model = cls.__new__(cls)
        nn.Module.__init__(model)
        model.family = infer_family(genotype).name
        model.genotype = genotype
        model.num_classes = num_classes
        model.encoder = encoder
        model.decoder = decoder
        return model.eval()

    def forward(self, x, *, input_format: str = "nhwc3",
                align_corners: bool = True, with_aux: bool = False,
                freeze_encoder: bool = False):
        """logits, or (logits, aux logits) with ``with_aux``.

        ``freeze_encoder`` runs the encoder in eval mode (its BatchNorm on
        the running stats, which stay as they are) and without autograd,
        so its parameters get no gradient: the JAX package's
        ``stop_gradient`` on the taps."""
        if freeze_encoder:
            was_training = self.encoder.training
            self.encoder.eval()
            try:
                with torch.no_grad():
                    taps = self.encoder(x, input_format=input_format)
            finally:
                self.encoder.train(was_training)
        else:
            taps = self.encoder(x, input_format=input_format)
        return self.decoder(taps, align_corners=align_corners,
                            with_aux=with_aux)


def create_segmenter(genotype, num_classes: int, *,
                     generator: torch.Generator, device="cuda",
                     **kw) -> Segmenter:
    """A ``Segmenter`` initialized from ``generator`` (a CPU
    ``torch.Generator``), in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = Segmenter(genotype, num_classes, generator=generator, **kw)
    return model.eval().to(dev)

