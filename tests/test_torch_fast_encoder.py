"""segtpu_torch folded encoder and the engine's kernel path vs the JAX
package's fused encoder (``mbv2_chw_apply``) and Pallas engine, both in
interpret mode, on the CPU.

Weights from ``mbv2_init``/``segmenter_init`` with BatchNorm perturbed
from a numpy seed, carried over by ``load_jax_params``. f32 taps agree
to rtol = atol = 1e-4 (17 blocks of f32 sums in different orders); the
bf16 test states the share of bit-identical tap elements it measured
and holds the error against the f32 taps.
Engine masks agree with ``build_infer_fn(use_pallas=True,
pallas_interpret=True)`` on >= 99.9 % of f32 pixels.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.engine.inference import build_infer_fn
from segtpu.models.encoders import mbv2_init, space_to_depth as jax_s2d
from segtpu.models.fast_encoder import mbv2_chw_apply
from segtpu.models.segmenter import segmenter_init

from segtpu_torch.convert import load_jax_params
from segtpu_torch.engine import Segmenter
from segtpu_torch.models import ARCHS
from segtpu_torch.models.encoders import MobileNetV2
from segtpu_torch.models.fast_encoder import FoldedMobileNetV2, fold_encoder
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet

from test_torch_layers import _np_tree, perturb_bn


@pytest.fixture(scope="module")
def encoder():
    rng = np.random.default_rng(11)
    p, s = perturb_bn(*_np_tree(mbv2_init(jax.random.PRNGKey(1))), rng)
    enc = MobileNetV2(generator=torch.Generator().manual_seed(0))
    load_jax_params(enc, p, s)
    x = rng.standard_normal((1, 64, 96, 3)).astype(np.float32)
    x12 = np.ascontiguousarray(
        np.transpose(np.asarray(jax_s2d(jnp.asarray(x))), (0, 3, 1, 2)))
    return p, s, enc.eval(), x12


def _taps(encoder, dtype):
    p, s, enc, x12 = encoder
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = mbv2_chw_apply(p, s, jnp.asarray(x12).astype(jdt), interpret=True)
    folded = fold_encoder(enc, dtype)
    with torch.no_grad():
        got = folded(torch.from_numpy(x12).to(dtype))
    assert len(got) == len(want) == 4
    return got, want


def test_folded_encoder_taps_match_pallas_f32(encoder):
    got, want = _taps(encoder, torch.float32)
    for g, w, c, stride in zip(got, want, (24, 32, 96, 320), (4, 8, 16, 32)):
        assert g.shape == (1, c, 64 // stride, 96 // stride)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_folded_encoder_taps_bf16(encoder):
    """bf16 taps: measured bit-identical shares 99.99 %, 100 %, 45.9 %,
    30.1 % (floors 99.9, 99, 40, 28 %). A bf16 element that rounds the
    other way (an f32 sum-order tie at a rounding boundary) perturbs every
    sum downstream of it, so by the stride-16 stage most elements have
    such an ancestor. Both bf16 results stay as close to the f32 JAX taps:
    measured worst error 0.68 / 0.77 / 0.83 / 0.63 % of the tap's largest
    value (JAX's own bf16 taps: 0.68 / 0.77 / 0.85 / 0.67 %); held <= 1 %."""
    got, want = _taps(encoder, torch.bfloat16)
    _, want32 = _taps(encoder, torch.float32)
    floors = (0.999, 0.99, 0.40, 0.28)
    for g, w, w32, floor in zip(got, want, want32, floors):
        wb = torch.from_numpy(np.array(w.astype(jnp.float32))).to(
            torch.bfloat16)
        rate = (g.view(torch.int16) == wb.view(torch.int16)).float().mean()
        assert rate.item() >= floor, rate.item()
        ref = torch.from_numpy(np.array(w32))
        err = (g.float() - ref).abs().max() / ref.abs().max()
        assert err.item() <= 1e-2, err.item()


def test_fold_encoder_layout_and_dtypes(encoder):
    *_, enc, _ = encoder
    folded = fold_encoder(enc, torch.bfloat16)
    assert isinstance(folded, FoldedMobileNetV2)
    assert folded.stem_w.shape == (32, 12, 2, 2)
    assert folded.stem_w.dtype == torch.bfloat16
    assert folded.stem_b.dtype == torch.float32
    assert len(folded.blocks) == 17 and sum(folded.tap_after) == 4
    strides = [b.stride for b in folded.blocks]
    assert strides.count(2) == 4 and strides.count(1) == 13
    b0, b1 = folded.blocks[0], folded.blocks[1]
    assert b0.w_exp is None and b1.w_exp.dtype == torch.bfloat16
    assert b1.w_dw.dtype == torch.float32           # depthwise stays f32
    assert b1.w_proj.dtype == torch.bfloat16
    assert [b.residual for b in folded.blocks].count(True) == 10
    with pytest.raises(ValueError, match="f32"):
        fold_encoder(enc.to(torch.bfloat16), torch.bfloat16)
    enc.float()


def test_engine_kernel_path_matches_jax_pallas_engine():
    """The port's engine (front, folded encoder, decoder, tail; plain
    versions on the CPU) vs the JAX engine's own kernel path."""
    genotype = ARCHS["arch0"]
    p, s = perturb_bn(*_np_tree(segmenter_init(jax.random.PRNGKey(6),
                                               genotype, num_classes=19)),
                      np.random.default_rng(6))
    model = SegmenterNet(genotype, 19,
                         generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    imgs = np.random.default_rng(7).integers(0, 256, (2, 40, 72, 3),
                                             dtype=np.uint8)
    fn = build_infer_fn(genotype, num_classes=19, input_hw=(40, 72),
                        compute_dtype=jnp.float32, use_pallas=True,
                        pallas_interpret=True)
    want = np.asarray(fn(p, s, jnp.asarray(imgs)))
    seg = Segmenter(model.eval(), compute_dtype=torch.float32, device="cpu")
    got = seg.predict_batch(imgs)
    assert got.shape == want.shape == (2, 40, 72)
    rate = (got == want).mean()
    assert rate >= 0.999, f"mask agreement {rate}"
