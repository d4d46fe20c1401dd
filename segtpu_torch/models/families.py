"""Decoder-family dispatch (counterpart: segtpu/models/families.py).

A family bundles the genotype check and the decoder module: the micro
(CVPR'19) ``MicroDecoder`` and the template (WACV'20)
``TemplateDecoder``, built with the same arguments (``aux`` and
``aux_cell`` included; the template family ignores ``aux_cell``), so the
segmenter, the engine and the trainer take either; and the port's own
``deeplab`` family, DeepLab-v3's ASPP head (``aspp_decoder.ASPPDecoder``),
whose "genotype" is a head config (``aspp_decoder.DEEPLABV3``) and whose
encoder runs at the config's output stride (``encoder_stride``; 32 for
the NAS families). The engine serves it; sharded serving and training
(``trainable`` False: its head has no aux heads) refuse it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from segtpu_torch.models import aspp_decoder as deeplab
from segtpu_torch.models import micro_decoders as micro
from segtpu_torch.models import template_decoders as template


def _stride32(genotype) -> int:
    return 32


class DecoderFamily(NamedTuple):
    name: str
    validate: Callable
    build: Callable
    encoder_stride: Callable = _stride32
    trainable: bool = True


MICRO = DecoderFamily("micro", micro.validate_genotype, micro.MicroDecoder)
TEMPLATE = DecoderFamily("template", template.validate_template_genotype,
                         template.TemplateDecoder)
DEEPLAB = DecoderFamily("deeplab", deeplab.validate_aspp_head,
                        deeplab.ASPPDecoder, deeplab.encoder_stride,
                        trainable=False)

FAMILIES = {"micro": MICRO, "cvpr": MICRO,
            "template": TEMPLATE, "wacv": TEMPLATE, "deeplab": DEEPLAB}


def get_family(name: str) -> DecoderFamily:
    return FAMILIES[name]


def infer_family(genotype) -> DecoderFamily:
    """Classify a genotype literal by shape: [cell, conns] -> micro,
    [[i,j,agg,op], ...] -> template (structural, as in the JAX package);
    a head config (a dict with ``rates``) -> deeplab."""
    if deeplab.is_aspp_head(genotype):
        return DEEPLAB
    if (isinstance(genotype, (list, tuple)) and len(genotype) == 2
            and isinstance(genotype[0], (list, tuple))
            and len(genotype[0]) >= 1
            and isinstance(genotype[0][0], int)
            and isinstance(genotype[1], (list, tuple))
            and len(genotype[1]) >= 1
            and all(isinstance(c, (list, tuple)) and len(c) == 2
                    for c in genotype[1])):
        return MICRO
    return TEMPLATE
