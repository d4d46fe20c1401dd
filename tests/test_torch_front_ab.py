"""segtpu_torch.kernels.front_ab (plain twins) against the front
experiments' own Pallas kernels, run in interpret mode on seeded random
images: scripts/exp_front_kernel.py::_front_kernel (the single-rounding
front, fed the pair-blocked bytes) and scripts/ab_normalize.py::_s2d_kernel
(the channels-last front). Both bit-identical (compared as int16 bit
patterns).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from segtpu.engine.inference import _stage_u8

from segtpu_torch.kernels.front import normalize_s2d_front_plain
from segtpu_torch.kernels.front_ab import (front_single_round,
                                           front_single_round_plain,
                                           normalize_s2d_nhwc,
                                           normalize_s2d_nhwc_plain)
from segtpu_torch.scripts import ab_normalize, exp_front_kernel

from test_torch_vpu_floor import load_script


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _bits(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).view(torch.int16)


@pytest.mark.parametrize("n,h,w", [(2, 32, 256), (1, 64, 512)])
def test_front_single_round_bit_identical_to_pallas_kernel(n, h, w):
    mod = load_script("exp_front_kernel")
    img = _img((n, h, w, 3), h + w)
    want = mod.build_fused_front(h, w, n)(jnp.asarray(_stage_u8(img)[0]))
    got = front_single_round_plain(torch.from_numpy(img))
    assert got.dtype == torch.bfloat16 and got.shape == (n, 12, h // 2, w // 2)
    assert torch.equal(got.view(torch.int16).reshape(n, 12, -1), _bits(want))


@pytest.mark.parametrize("n,h,w", [(1, 64, 128), (2, 32, 256)])
def test_normalize_s2d_nhwc_bit_identical_to_pallas_kernel(n, h, w):
    mod = load_script("ab_normalize")
    img = _img((n, h, w, 3), h * w)
    want = mod.v_pallas(jnp.asarray(img))
    got = normalize_s2d_nhwc_plain(torch.from_numpy(img))
    assert got.dtype == torch.bfloat16 and got.shape == (n, h // 2, w // 2, 12)
    assert torch.equal(got.view(torch.int16), _bits(want))


@pytest.mark.parametrize("fn,ulps", [(front_single_round_plain, 1),
                                     (normalize_s2d_nhwc_plain, 2)])
def test_variants_differ_from_production_front_by_a_few_ulp(fn, ulps):
    """The variants round differently from the production front; values
    lie in [-2.2, 2.7], where a bf16 ulp is at most 2**-6."""
    img = torch.from_numpy(_img((1, 32, 64, 3), 5))
    got = fn(img).float()
    if got.shape[1] != 12:
        got = got.permute(0, 3, 1, 2)
    diff = (got - normalize_s2d_front_plain(img).float()).abs()
    assert diff.max().item() <= ulps * 2.0 ** -6 and diff.max().item() > 0


def test_wrappers_run_twin_on_cpu_without_launching():
    img = torch.from_numpy(_img((1, 8, 16, 3), 6))
    before = (front_single_round.launches, normalize_s2d_nhwc.launches)
    assert torch.equal(front_single_round(img), front_single_round_plain(img))
    assert torch.equal(normalize_s2d_nhwc(img), normalize_s2d_nhwc_plain(img))
    assert (front_single_round.launches, normalize_s2d_nhwc.launches) == before


@pytest.mark.parametrize("fn", [front_single_round, normalize_s2d_nhwc])
def test_wrappers_check_shape_dtype_and_device(fn):
    img = torch.from_numpy(_img((1, 8, 16, 3), 7))
    with pytest.raises(ValueError):
        fn(img[:, :7])                                       # odd H
    with pytest.raises(ValueError):
        fn(img.float())                                      # not uint8
    with pytest.raises(ValueError):
        fn(img[..., :2])                                     # not 3 channels
    with pytest.raises(ValueError):
        fn(img.to("meta"))                                   # not cuda or cpu


@pytest.mark.parametrize("script", [exp_front_kernel, ab_normalize])
def test_scripts_run_on_cpu_only_when_asked(script):
    out = script.run(device="cpu", n=1, h=16, w=32)
    assert out["device"] == "cpu" and out["max_abs_err_vs_production"] < 0.05
    assert all(v is None for v in out["ms"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            script.run()
