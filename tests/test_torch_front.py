"""segtpu_torch front (plain version) vs the JAX package's front.

bf16: bit-identical (compared as int16 bit patterns) to the Pallas
kernel ``normalize_s2d_front`` run in interpret mode. f32: within
atol 1e-6 of the XLA front ``_normalize_s2d_chw`` (XLA may rewrite the
divide by std; values are O(1), so 1e-6 is a few f32 ulp).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from segtpu.engine.inference import _normalize_s2d_chw, _stage_u8
from segtpu.kernels.front import normalize_s2d_front as jax_front

from segtpu_torch.kernels.front import (normalize_s2d_front,
                                        normalize_s2d_front_plain)


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("shape", [(2, 32, 256, 3), (1, 16, 512, 3)])
def test_front_bf16_bit_identical_to_pallas_kernel(shape):
    img = _img(shape, 0)
    n, h, w, _ = shape
    want = jax_front(jnp.asarray(_stage_u8(img)[0]), hw=(h, w),
                     out_dtype=jnp.bfloat16, interpret=True)
    want = np.array(want.astype(jnp.float32)).reshape(n, 12, h // 2, w // 2)
    got = normalize_s2d_front_plain(torch.from_numpy(img))
    assert got.dtype == torch.bfloat16 and got.shape == (n, 12, h // 2, w // 2)
    want_bits = torch.from_numpy(want).to(torch.bfloat16).view(torch.int16)
    assert torch.equal(got.view(torch.int16), want_bits)


@pytest.mark.parametrize("shape", [(2, 32, 256, 3), (1, 10, 46, 3)])
def test_front_f32_matches_xla_front(shape):
    img = _img(shape, 1)
    want = np.asarray(_normalize_s2d_chw(jnp.asarray(img), jnp.float32))
    got = normalize_s2d_front_plain(torch.from_numpy(img),
                                    out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_front_pads_margin_with_zeros(dtype):
    img = torch.from_numpy(_img((2, 40, 72, 3), 2))
    got = normalize_s2d_front_plain(img, padded_hw=(64, 96), out_dtype=dtype)
    assert got.shape == (2, 12, 32, 48)
    inner = normalize_s2d_front_plain(img, out_dtype=dtype)
    assert torch.equal(got[:, :, :20, :36], inner)
    assert not got[:, :, 20:].any() and not got[:, :, :, 36:].any()


def test_front_wrapper_runs_plain_on_cpu_without_launching():
    img = torch.from_numpy(_img((1, 8, 16, 3), 3))
    before = normalize_s2d_front.launches
    got = normalize_s2d_front(img, padded_hw=(32, 32))
    assert normalize_s2d_front.launches == before
    assert torch.equal(got, normalize_s2d_front_plain(img, padded_hw=(32, 32)))
    with pytest.raises(ValueError):
        normalize_s2d_front(img[:, :7])                     # odd H
    with pytest.raises(ValueError):
        normalize_s2d_front(img.float())                    # not uint8
