"""segtpu_torch folded decoder vs the JAX package's fast decoder
(``build_fast_decoder``, Pallas kernels in interpret mode), on the CPU.

Weights from ``segmenter_init`` with BatchNorm perturbed from a numpy
seed, carried over by ``load_jax_params``; the four taps are seeded
numpy arrays at the encoder's tap widths for a 64x512 frame, so the
stride-4 cell is 128 wide and the JAX side runs its fused cell kernel
there too. f32 logits agree to rtol = atol = 1e-4 for every released
genotype (measured worst difference 3e-6); the bf16 test states the
share of bit-identical logits it measured and holds the error against
the f32 logits.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.models.fast_decoder import build_fast_decoder
from segtpu.models.segmenter import segmenter_init

from segtpu_torch.convert import load_jax_params
from segtpu_torch.models import ARCHS
from segtpu_torch.models.fast_decoder import (FoldedMicroDecoder,
                                              fold_decoder)
from segtpu_torch.models.segmenter import Segmenter as SegmenterNet

from test_torch_layers import _np_tree, perturb_bn

K = 7
TAP_SHAPES = [(24, 16, 128), (32, 8, 64), (96, 4, 32), (320, 2, 16)]


def _setup(arch, seed):
    genotype = ARCHS[arch]
    p, s = perturb_bn(*_np_tree(segmenter_init(jax.random.PRNGKey(seed),
                                               genotype, num_classes=K)),
                      np.random.default_rng(seed))
    model = SegmenterNet(genotype, K, generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    rng = np.random.default_rng(seed + 1)
    taps = [np.abs(rng.standard_normal((1, c, h, w))).astype(np.float32)
            for c, h, w in TAP_SHAPES]
    return genotype, p, s, model.eval(), taps


def _logits(arch, seed, dtype):
    genotype, p, s, model, taps = _setup(arch, seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    fast = build_fast_decoder(genotype, p["decoder"], s["decoder"],
                              taps_channel_first=True, interpret=True)
    want = fast([jnp.asarray(t).astype(jdt) for t in taps])
    dec = fold_decoder(model.decoder, dtype)
    with torch.no_grad():
        got = dec([torch.from_numpy(t).to(dtype) for t in taps])
    return got, want


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_folded_decoder_matches_fast_decoder_f32(arch):
    got, want = _logits(arch, 3, torch.float32)
    assert got.shape == (1, K, 16, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_folded_decoder_bf16():
    """arch0 bf16 logits: measured 43.7 % bit-identical to JAX's (floor
    40 %). Where JAX resizes a small map it rounds the interpolation and
    then adds the other branch in bf16, where the port's resize kernel
    adds in f32 and rounds once; each element rounded the other way then
    spreads through the cells. Both stay as close to the f32 logits:
    worst error 1.01 % (port) and 0.97 % (JAX) of their largest value,
    held <= 1.5 %."""
    got, want = _logits("arch0", 4, torch.bfloat16)
    want32 = _logits("arch0", 4, torch.float32)[1]
    wb = torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        torch.bfloat16)
    rate = (got.view(torch.int16) == wb.view(torch.int16)).float().mean()
    assert rate.item() >= 0.40, rate.item()
    ref = torch.from_numpy(np.array(want32))
    err = (got.float() - ref).abs().max() / ref.abs().max()
    assert err.item() <= 1.5e-2, err.item()


def test_fold_decoder_layout_and_dtypes():
    *_, model, _ = _setup("arch0", 5)
    dec = fold_decoder(model.decoder, torch.bfloat16)
    assert isinstance(dec, FoldedMicroDecoder)
    assert dec.lazy == [True, True, True, True]      # every tap read once
    assert dec.collect == [6] and dec.cell_collect == [4]
    assert dec.adapt[0].w.dtype == torch.bfloat16
    assert dec.adapt[0].b.dtype == torch.float32
    node0 = dec.node0[0]
    assert node0.kind == "sep" and node0.rep(0)[0].dtype == torch.float32
    assert node0.rep(0)[2].dtype == torch.bfloat16
    kinds = [[op.kind for op in pair] for pair in dec.nodes[0]]
    assert kinds == [["sep", "gap"], ["conv", "sep"], ["sep", "conv"]]
    assert dec.nodes[0][0][1].w.dtype == torch.float32   # pool 1x1 in f32
    assert dec._cell_plan(0)[1] == 1     # node0 whole, nodes 1-3 fused
    assert dec.clf_w.dtype == torch.bfloat16 and dec.clf_b.dtype == \
        torch.float32
    with pytest.raises(ValueError, match="f32"):
        fold_decoder(model.decoder.to(torch.bfloat16), torch.bfloat16)
