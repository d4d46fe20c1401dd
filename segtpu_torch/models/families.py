"""Decoder-family dispatch (counterpart: segtpu/models/families.py).

Only the micro (CVPR'19) family is built in the port so far; the
template (WACV'20) family is classified but not yet ported.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from segtpu_torch.models import micro_decoders as micro


class DecoderFamily(NamedTuple):
    name: str
    validate: Callable
    build: Callable


def _template_not_ported(*_args, **_kw):
    raise NotImplementedError(
        "the template (WACV'20) decoder family is not ported to "
        "segtpu_torch yet; it comes with the template-family slice, after "
        "the encoder (slice 2) and decoder (slice 3) kernel slices "
        "(ROADMAP.md Queue A)")


MICRO = DecoderFamily("micro", micro.validate_genotype, micro.MicroDecoder)
TEMPLATE = DecoderFamily("template", _template_not_ported,
                         _template_not_ported)

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
