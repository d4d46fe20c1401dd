"""segtpu_torch tail (plain version) vs the JAX package's Pallas tail.

The JAX kernel ``upsample_argmax`` runs in interpret mode with small
tiles, channel-first. Masks must agree on >= 99.99 % of pixels, and
every pixel that differs must be a near-tie: its two classes' upsampled
f32 logits within 1e-3 relative (the two sides round the same values,
but the JAX dot may fuse a multiply-add).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from segtpu.core.resize import resize_bilinear as jax_resize
from segtpu.kernels.upsample_argmax import upsample_argmax as jax_tail

from segtpu_torch.kernels.upsample_argmax import (interp_taps, upsample_argmax,
                                                  upsample_argmax_plain)


def assert_masks_agree(got, want, up_f32):
    """got/want: uint8 [B, H, W]; up_f32: [B, K, H, W] upsampled logits."""
    assert got.shape == want.shape
    diff = got != want
    rate = 1.0 - diff.mean()
    assert rate >= 0.9999, f"mask agreement {rate}"
    if diff.any():
        b, y, x = np.nonzero(diff)
        vg = up_f32[b, got[diff], y, x]
        vw = up_f32[b, want[diff], y, x]
        scale = np.maximum(np.abs(vw), 1.0)
        assert np.all(np.abs(vg - vw) <= 1e-3 * scale), "non-tie mismatch"


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("shape,out_hw,crop_hw", [
    ((2, 19, 16, 32), (64, 128), None),        # 4x, CityScapes class count
    ((1, 7, 24, 24), (96, 96), (70, 90)),      # crop of the padded grid
    ((1, 5, 9, 13), (40, 50), None),           # odd, non-integer scale
])
def test_tail_matches_pallas_kernel(dtype, align_corners, shape, out_hw,
                                    crop_hw):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        x = np.asarray(xj.astype(jnp.float32))   # the values both sides see
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jax_tail(xj, out_hw, crop_hw=crop_hw,
                               align_corners=align_corners,
                               channel_first=True, tile_h=32, interpret=True))
    got = upsample_argmax_plain(xt, out_hw, crop_hw=crop_hw,
                                align_corners=align_corners).numpy()
    ho, wo = crop_hw or out_hw
    assert got.dtype == np.uint8 and got.shape == (shape[0], ho, wo)
    up = np.asarray(jax_resize(jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                               out_hw, align_corners=align_corners))
    up = np.transpose(up, (0, 3, 1, 2))[:, :, :ho, :wo]
    assert_masks_agree(got, want, up)


def test_taps_reproduce_interp_matrix():
    from segtpu_torch.core.resize import _interp_matrix
    for n_in, n_out, ac in [(16, 64, True), (16, 64, False), (9, 40, False),
                            (8, 8, True)]:
        taps, wts = interp_taps(n_in, n_out, ac, n_out, False)
        dense = np.zeros((n_out, n_in), np.float32)
        np.add.at(dense, (np.arange(n_out), taps[0]), wts[0])
        np.add.at(dense, (np.arange(n_out), taps[1]), wts[1])
        np.testing.assert_array_equal(dense, _interp_matrix(n_in, n_out, ac))


def test_tail_ties_go_to_lower_class_and_wrapper_stays_plain_on_cpu():
    x = torch.zeros(1, 4, 8, 8)
    x[:, 2] = 1.0
    x[:, 3] = 1.0                                   # tie between 2 and 3
    before = upsample_argmax.launches
    got = upsample_argmax(x, (32, 32))
    assert upsample_argmax.launches == before
    assert got.dtype == torch.uint8 and bool((got == 2).all())
    with pytest.raises(ValueError):
        upsample_argmax(x.half(), (32, 32))
    with pytest.raises(ValueError):
        upsample_argmax(x, (32, 32), crop_hw=(40, 8))
