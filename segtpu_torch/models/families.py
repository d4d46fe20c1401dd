"""Decoder-family dispatch (counterpart: segtpu/models/families.py).

A family bundles the genotype check and the decoder module: the micro
(CVPR'19) ``MicroDecoder`` and the template (WACV'20)
``TemplateDecoder``, built with the same arguments, so the segmenter
and the engine take either.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from segtpu_torch.models import micro_decoders as micro
from segtpu_torch.models import template_decoders as template


class DecoderFamily(NamedTuple):
    name: str
    validate: Callable
    build: Callable


MICRO = DecoderFamily("micro", micro.validate_genotype, micro.MicroDecoder)
TEMPLATE = DecoderFamily("template", template.validate_template_genotype,
                         template.TemplateDecoder)

FAMILIES = {"micro": MICRO, "cvpr": MICRO,
            "template": TEMPLATE, "wacv": TEMPLATE}


def get_family(name: str) -> DecoderFamily:
    return FAMILIES[name]


def infer_family(genotype) -> DecoderFamily:
    """Classify a genotype literal by shape: [cell, conns] -> micro,
    [[i,j,agg,op], ...] -> template (structural, as in the JAX package)."""
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
