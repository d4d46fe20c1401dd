"""segtpu_torch.kernels.tail_flat (plain twin) against the flat-tail
experiment's own Pallas kernel (scripts/exp_tail_flat.py::_kernel), run
in interpret mode on seeded random features with the script's seeded
classifier.

Tolerances: the masks agree on >= 99.99 % of pixels and every mismatch is
a near-tie of the twin's f32 W-pass values (top two within 1e-2 of
max(|top|, 1)), because the 48- (here 8-) term classifier sum may round
to bf16 differently in XLA's dot order than in the twin's channel order;
the bf16 logits stage, against the kernel's own dot, is >= 99.9 %
bit-equal.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu_torch.kernels.tail_flat import (classifier_plain,
                                            clf_upsample_argmax,
                                            clf_upsample_argmax_plain)
from segtpu_torch.kernels.upsample_argmax import interp_taps
from segtpu_torch.scripts import exp_tail_flat

from test_torch_vpu_floor import load_script


def _w_pass(logits, out_hw):
    """The twin's f32 W-pass values [B, K, Ho, Wo] of bf16 logits."""
    h, w = logits.shape[-2:]
    rows, rw = interp_taps(h, out_hw[0], True, out_hw[0], True)
    cols, cw = interp_taps(w, out_hw[1], True, out_hw[1], True)
    x = logits.float()
    t = (x[:, :, rows[0], :] * torch.from_numpy(rw[0])[:, None]
         + x[:, :, rows[1], :] * torch.from_numpy(rw[1])[:, None])
    t = t.to(torch.bfloat16).float()
    return t[..., cols[0]] * torch.from_numpy(cw[0]) \
        + t[..., cols[1]] * torch.from_numpy(cw[1])


@pytest.mark.parametrize("k", [3, 5])
def test_clf_upsample_argmax_matches_pallas_kernel(k):
    b, cin, h, w, out_hw = 1, 8, 16, 128, (64, 512)
    mod = load_script("exp_tail_flat")
    tail, (wclf_j, bclf_j) = mod.build_flat_tail(b, h, w, k, cin, out_hw,
                                                 tile_h=64)
    feat = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (b, cin, h, w)).astype(np.float32) * 0.5).to(torch.bfloat16)
    feat_j = jnp.asarray(feat.float().numpy().reshape(b, cin, h * w),
                         jnp.bfloat16)
    want = np.asarray(tail(feat_j))[:, :out_hw[0], :out_hw[1]]
    wclf = torch.from_numpy(np.array(wclf_j.astype(jnp.float32))).to(
        torch.bfloat16)
    bclf = torch.from_numpy(np.array(bclf_j))[:, 0]

    # the logits stage, against the kernel's own dot
    lg_j = jax.lax.dot_general(wclf_j, feat_j, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32)
    lg_j = (jnp.transpose(lg_j, (1, 0, 2)) + bclf_j).astype(jnp.bfloat16)
    lg = classifier_plain(feat, wclf, bclf)
    lg_want = torch.from_numpy(np.array(lg_j.astype(jnp.float32))).to(
        torch.bfloat16).reshape(lg.shape)
    assert (lg.view(torch.int16) == lg_want.view(torch.int16)).float().mean() >= 0.999

    got = clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)
    assert got.dtype == torch.uint8 and got.shape == (b,) + out_hw
    same = got.numpy() == want
    assert same.mean() >= 0.9999
    v = _w_pass(lg, out_hw)
    for bi, y, x in np.argwhere(~same):
        top = v[bi, :, y, x]
        gap = (top[int(got[bi, y, x])] - top[int(want[bi, y, x])]).abs().item()
        assert gap <= 1e-2 * max(top.abs().max().item(), 1.0), (bi, y, x, gap)


def test_wrapper_runs_twin_on_cpu_without_launching():
    g = torch.Generator().manual_seed(0)
    feat = torch.randn((1, 4, 6, 10), generator=g).to(torch.bfloat16)
    wclf, bclf = torch.randn((3, 4), generator=g), torch.randn(3, generator=g)
    before = clf_upsample_argmax.launches
    got = clf_upsample_argmax(feat, wclf, bclf, (21, 37))
    assert clf_upsample_argmax.launches == before
    assert got.shape == (1, 21, 37) and got.dtype == torch.uint8
    assert torch.equal(got, clf_upsample_argmax_plain(feat, wclf, bclf, (21, 37)))


def test_wrapper_checks_shape_dtype_and_device():
    feat = torch.zeros((1, 4, 6, 10), dtype=torch.bfloat16)
    wclf, bclf = torch.zeros((3, 4)), torch.zeros(3)
    with pytest.raises(ValueError):
        clf_upsample_argmax(feat.float(), wclf, bclf, (12, 20))   # not bf16
    with pytest.raises(ValueError):
        clf_upsample_argmax(feat, wclf[:, :3], bclf, (12, 20))    # C
    with pytest.raises(ValueError):
        clf_upsample_argmax(feat, wclf, bclf[:2], (12, 20))       # K
    with pytest.raises(ValueError):
        clf_upsample_argmax(feat, torch.zeros((300, 4)), torch.zeros(300),
                            (12, 20))                             # > 256 classes
    with pytest.raises(ValueError):
        clf_upsample_argmax(feat.to("meta"), wclf, bclf, (12, 20))


def test_script_runs_on_cpu_only_when_asked():
    out = exp_tail_flat.run(device="cpu", b=1, cin=4, h=8, w=16, k=5)
    assert out["device"] == "cpu" and out["mask_agreement_vs_chain"] > 0.9
    assert all(v is None for v in out["ms"].values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            exp_tail_flat.run()
