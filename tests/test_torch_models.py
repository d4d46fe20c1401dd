"""segtpu_torch models vs the JAX package, on the CPU in f32.

Weights come from ``segmenter_init``/``mbv2_init``, with BatchNorm
stats and scales perturbed from a numpy seed, and are carried into the
port by ``load_jax_params``. Encoder taps agree to 1e-4 and segmenter
logits to atol = rtol = 1e-4 (deep f32 conv stacks summed in different
orders).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.models.arch_literals import ARCHS as JAX_ARCHS
from segtpu.models.encoders import (mbv2_init, mbv2_apply,
                                    space_to_depth as jax_s2d)
from segtpu.models.segmenter import segmenter_init, segmenter_apply

from segtpu_torch.convert import load_jax_params
from segtpu_torch.models import (ARCHS, TEMPLATE_ARCHS, GenotypeError,
                                 TemplateDecoder, validate_genotype)
from segtpu_torch.models.encoders import MobileNetV2, space_to_depth
from segtpu_torch.models.families import infer_family
from segtpu_torch.models.segmenter import Segmenter, create_segmenter

from test_torch_layers import _nchw, _nhwc, _np_tree, perturb_bn


def _gen():
    return torch.Generator().manual_seed(0)


def test_arch_literals_match():
    assert ARCHS == JAX_ARCHS


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(space_to_depth(_nchw(x))),
                                  np.asarray(jax_s2d(jnp.asarray(x))))


@pytest.mark.parametrize("input_format", ["nhwc3", "s2d12"])
def test_encoder_taps_match_jax(input_format):
    rng = np.random.default_rng(1)
    p, s = perturb_bn(*_np_tree(mbv2_init(jax.random.PRNGKey(0))), rng)
    x = rng.standard_normal((2, 64, 96, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    if input_format == "s2d12":
        xj = jax_s2d(xj)
    want = jax.jit(lambda p, s, x: mbv2_apply(
        p, s, x, input_format=input_format)[0])(p, s, xj)
    enc = MobileNetV2(generator=_gen())
    load_jax_params(enc, p, s)
    xt = _nchw(np.asarray(xj))
    with torch.no_grad():
        got = enc(xt, input_format=input_format)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bad", [
    "nonsense",
    [[99], [[0, 1]]],                              # op out of range
    [[0, [0, 5, 1, 1]], [[0, 1]]],                 # cell position too big
    [[0, [0, 1, 1, 1]], [[0, 9]]],                 # conn index too big
    [[0, [0, 1, 1]], [[0, 1]]],                    # wrong node arity
    [[0], []],                                     # no blocks
])
def test_invalid_genotypes_rejected(bad):
    with pytest.raises(GenotypeError):
        validate_genotype(bad)


@pytest.mark.parametrize("arch", ["arch0", "arch1", "arch2"])
def test_segmenter_logits_match_jax(arch):
    genotype = ARCHS[arch]
    rng = np.random.default_rng(2)
    p, s = perturb_bn(*_np_tree(segmenter_init(jax.random.PRNGKey(3),
                                               genotype, num_classes=19)), rng)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    fn = jax.jit(lambda p, s, x: segmenter_apply(genotype, p, s, x)[0])
    want = np.asarray(fn(p, s, jnp.asarray(x)))
    model = Segmenter(genotype, 19, generator=_gen()).eval()
    load_jax_params(model, p, s)
    with torch.no_grad():
        got = model(_nchw(x))
    assert got.shape == (2, 19, 16, 16)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-4)


def test_load_jax_params_rejects_mismatched_trees():
    genotype = ARCHS["arch2"]
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(0), genotype,
                                   num_classes=5))
    model = Segmenter(genotype, 5, generator=_gen())
    w = p["decoder"]["clf"]["w"]
    p["decoder"]["clf"]["w"] = w[..., :4]
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, p, s)
    p["decoder"]["clf"]["w"] = w
    p["decoder"]["extra"] = {"w": w}
    with pytest.raises(ValueError, match="extra"):
        load_jax_params(model, p, s)
    del p["decoder"]["extra"]
    del s["encoder"]["stem"]["var"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_params(model, p, s)


def test_template_family_not_ported_yet():
    """Since the template family was ported (the name is kept): a
    template0 ``Segmenter`` builds a ``TemplateDecoder`` and takes the
    JAX weights of ``segmenter_init``."""
    genotype = TEMPLATE_ARCHS["template0"]
    assert infer_family(genotype).name == "template"
    assert infer_family(ARCHS["arch0"]).name == "micro"
    model = Segmenter(genotype, 5, generator=_gen())
    assert isinstance(model.decoder, TemplateDecoder)
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(0), genotype,
                                   num_classes=5))
    load_jax_params(model, p, s)
    np.testing.assert_array_equal(
        model.decoder.blocks[1]["reduce"].w.detach().numpy(),
        np.transpose(p["decoder"]["blocks"][1]["reduce"]["w"], (3, 2, 0, 1)))
    assert sorted(model.decoder.blocks[0].keys()) == ["b1", "b2", "op"]


def test_create_segmenter_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the CUDA-less behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_segmenter(ARCHS["arch0"], 19, generator=_gen())
    m = create_segmenter(ARCHS["arch0"], 19, generator=_gen(), device="cpu")
    assert not m.training
    assert 1e5 < sum(p.numel() for p in m.parameters()) < 1e7
