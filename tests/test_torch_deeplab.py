"""The deeplab family (DeepLab-v3's ASPP head on MobileNet-v2 at output
stride 16) on the CPU, held to its plain f32 reference
(``segtpu_torch/reference/deeplabv3_mnv2.py``; the JAX package has no
counterpart), at b2 64x128 frames and the published widths: the dilated
encoder's schedule and twin, the head's kernel plan and twin, the folded
engine, the spans and counters, and the paths that refuse the family.

    python -m pytest tests/test_torch_deeplab.py -q
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from segtpu_torch.core.layers import ConvBN
from segtpu_torch.engine import Segmenter, ShardedSegmenter
from segtpu_torch.engine import inference
from segtpu_torch.engine.trainer import make_train_step
from segtpu_torch.kernels import aspp as aspp_mod
from segtpu_torch.kernels import chw_ops
from segtpu_torch.kernels.aspp import (aspp_chw, aspp_chw_plain, aspp_halo,
                                       aspp_smem)
from segtpu_torch.kernels.chw_ops import (inv_res_chw, inv_res_chw_plain,
                                          inv_res_plan, inv_res_plans,
                                          inv_res_window, pack_weights)
from segtpu_torch.models import ARCHS, GenotypeError, create_segmenter
from segtpu_torch.models.aspp_decoder import (DEEPLABV3, ASPPDecoder,
                                              FoldedASPPDecoder)
from segtpu_torch.models.encoders import MobileNetV2, block_schedule
from segtpu_torch.models.families import (DEEPLAB, MICRO, TEMPLATE,
                                          get_family, infer_family)
from segtpu_torch.models.fast_encoder import fold_encoder
from segtpu_torch.reference import deeplabv3_mnv2 as ref
from segtpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
K = 19
CFG = {"aspp_rates": [6, 12, 18], "aspp_channels": 256, "output_stride": 16,
       "num_classes": K, "align_corners": True}
# the bf16 engine's masks against the f32 reference's argmax: its 17
# blocks, head and tail round in bf16 (measured 98.21 % on these frames,
# whose 4x8 logit map gives each logit a 16x16 patch of pixels, so one
# near-tie flipped moves up to 256 of the 16384 pixels)
BF16_MASK_FLOOR = 0.97


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturbed(model, gen):
    """BatchNorm that is not the identity, a classifier bias of 0.1."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ConvBN):
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return model


@pytest.fixture(scope="module")
def model():
    gen = torch.Generator().manual_seed(23)
    m = perturbed(create_segmenter(DEEPLABV3, K, generator=gen,
                                   device="cpu"), gen)
    with torch.no_grad():     # centred on the frames: masks of many classes
        lg = ref.Net(ref.from_dict(m.state_dict()), CFG)(
            ref.normalize(torch.from_numpy(frames_np())))
        m.decoder.clf.b.copy_(-lg.mean((0, 2, 3)))
    return m


def frames_np(n=2, h=64, w=128, seed=3):
    """Smooth random colour fields (neighbours agree), uint8 NHWC."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.random((n, 3, h // 16 + 1, w // 16 + 1)))
    x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=True)
    x = x + 0.1 * (torch.from_numpy(rng.random((n, 3, h, w))) - 0.5)
    return (x.clamp(0, 1) * 255).round().to(torch.uint8).permute(
        0, 2, 3, 1).contiguous().numpy()


@pytest.fixture(scope="module")
def frames():
    return frames_np()


# ------------------------------------------------------------- families

def test_families_find_the_deeplab_head():
    assert get_family("deeplab") is DEEPLAB
    assert infer_family(DEEPLABV3) is DEEPLAB
    assert infer_family(ARCHS["arch0"]) is MICRO
    assert infer_family([[3, 2, 0, 2], [4, 1, 1, 4]]) is TEMPLATE
    assert MICRO.trainable and TEMPLATE.trainable and not DEEPLAB.trainable
    assert DEEPLAB.encoder_stride(DEEPLABV3) == 16
    assert MICRO.encoder_stride(ARCHS["arch0"]) == 32


@pytest.mark.parametrize("head", [
    {"rates": [], "channels": 256, "output_stride": 16},
    {"rates": [6, 12, 18, 24], "channels": 256, "output_stride": 16},
    {"rates": [6, 0], "channels": 256, "output_stride": 16},
    {"rates": [6, 12, 18], "channels": 250, "output_stride": 16},
    {"rates": [6, 12, 18], "channels": 256, "output_stride": 8},
    {"rates": [6, 12, 18], "channels": 256, "output_stride": 16, "x": 1},
])
def test_malformed_heads_raise(head):
    with pytest.raises(GenotypeError):
        DEEPLAB.validate(head)


# ------------------------------------------------------------- encoder

def test_output_stride_16_schedule():
    """slim's rule: the 160-channel stage's first block runs at stride 1
    and rate 1, the other two and the 320-channel block at rate 2; every
    other block as at output stride 32."""
    s32, s16 = block_schedule(32), block_schedule(16)
    assert all(r == 1 for _, r in s32)
    assert s16[:13] == s32[:13]
    assert s32[13:] == [(2, 1), (1, 1), (1, 1), (1, 1)]
    assert s16[13:] == [(1, 1), (1, 2), (1, 2), (1, 2)]
    assert ref.schedule(16) == s16 and ref.schedule(32) == s32
    enc = MobileNetV2(output_stride=16,
                      generator=torch.Generator().manual_seed(0))
    assert [(b.dw.stride, b.dw.dilation, b.dw.padding)
            for b in enc.blocks[13:]] == [(1, 1, 1), (1, 2, 2), (1, 2, 2),
                                          (1, 2, 2)]
    taps = enc(torch.zeros(1, 3, 64, 128))
    assert [tuple(t.shape[1:]) for t in taps] == [
        (24, 16, 32), (32, 8, 16), (96, 4, 8), (320, 4, 8)]
    with pytest.raises(ValueError):
        block_schedule(8)


def test_arch0_folded_encoder_keeps_rate_one():
    """The NAS families' encoder is unchanged: every block at rate 1, no
    atrous span, the first 13 blocks' draws the same at both strides."""
    seg = create_segmenter(ARCHS["arch0"], K, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    folded = fold_encoder(seg.encoder, torch.bfloat16)
    assert all(b.dilation == 1 for b in folded.blocks)
    assert folded.atrous_from == len(folded.blocks) == 17
    e32 = MobileNetV2(generator=torch.Generator().manual_seed(4))
    e16 = MobileNetV2(output_stride=16,
                      generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(
        e32.state_dict().values(), e16.state_dict().values()))


def _block(cin, t, cout, seed, h=9, w=12, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    cmid = cin * t
    x = torch.randn(2, cin, h, w, generator=g).to(dtype)
    return (x, torch.randn(cmid, cin, 1, 1, generator=g) * 0.3,
            torch.randn(cmid, generator=g) * 0.1,
            torch.randn(cmid, 1, 3, 3, generator=g) * 0.3,
            torch.randn(cmid, generator=g) * 0.1,
            torch.randn(cout, cmid, 1, 1, generator=g) * 0.3,
            torch.randn(cout, generator=g) * 0.1)


@pytest.mark.parametrize("rate", [1, 2])
@pytest.mark.parametrize("residual", [False, True])
def test_dilated_twin_is_the_conv2d_composition(rate, residual):
    """``inv_res_chw``'s twin at rate 1 and 2 against expand, depthwise at
    the rate (zero padding of the rate) and project as ``F.conv2d``."""
    x, we, be, wd, bd, wp, bp = _block(8, 3, 8, seed=rate + 2 * residual)
    got = inv_res_chw_plain(x, we, be, wd, bd, wp, bp, residual=residual,
                            dilation=rate)
    mid = F.conv2d(x, we, be).clamp(0, 6)
    d = F.conv2d(mid, wd, bd, padding=rate, dilation=rate,
                 groups=wd.shape[0]).clamp(0, 6)
    want = F.conv2d(d, wp, bp) + (x if residual else 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(inv_res_chw(x, we, be, wd, bd, wp, bp,
                                   residual=residual, dilation=rate), got)


def test_rate_two_plans_and_entry(monkeypatch):
    """Rate 2 widens the window by 2 a side, never prefetches, takes its
    measured plan by shape and rate, and hands the entry the rate as its
    last int, as a rate-1 launch hands it 1."""
    assert inv_res_window(4, 16, 1, 2) == (8, 20)
    assert inv_res_window(4, 16, 1) == (6, 18)
    plans = inv_res_plans(160, 960, 160, 64, 128, 1, torch.bfloat16, True,
                          dilation=2)
    assert plans and all(p.pf == 0 for p in plans)
    assert inv_res_plan(160, 960, 160, 64, 128, 1, torch.bfloat16, 8, True,
                        sm_count=132, dilation=2)[:5] == (16, 8, 48, 12, 0)
    seen = []
    monkeypatch.setattr(chw_ops, "_launch",
                        lambda fn, t, *a: seen.append((fn, a)) or 0)
    monkeypatch.setattr(chw_ops, "_inv_res_entry", lambda: "entry")
    monkeypatch.setattr(chw_ops, "_sm_count", lambda dev: 132)
    x, *ws = _block(16, 6, 16, seed=5, h=8, w=16, dtype=torch.bfloat16)
    chw_ops._inv_res_launch(x, *ws, stride=1, residual=True, what="t",
                            dilation=2)
    chw_ops._inv_res_launch(x, *ws, stride=1, residual=True, what="t")
    (fn2, a2), (fn1, a1) = seen
    plan = inv_res_plan(16, 96, 16, 8, 16, 1, torch.bfloat16, 2, True,
                        sm_count=132, dilation=2)
    assert fn2 == fn1 == "entry" and len(a2) == len(a1) == 8 + 16
    assert a2[8:] == chw_ops.inv_res_args(plan, 2, 16, 96, 16, 8, 16, 1,
                                          True, True, 2)
    assert a2[-1] == 2 and a1[-1] == 1
    with pytest.raises(ValueError, match="rate"):
        chw_ops._inv_res_launch(x, *ws, stride=1, residual=True, what="t",
                                dilation=3)


# ---------------------------------------------------------------- head

def _head_args(seed=0, cin=64, cout=16, h=5, w=7, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cin, h, w, generator=g).to(dtype)
    ws = [torch.randn(cout, cin, 1, 1, generator=g) * 0.1] + [
        torch.randn(cout, cin, 3, 3, generator=g) * 0.05 for _ in range(3)]
    bs = [torch.randn(cout, generator=g) * 0.1 for _ in ws]
    vec = torch.randn(2, 4 * cout, generator=g)
    return x, ws, bs, [1, 2, 3, 5], vec


def test_aspp_twin_is_the_conv2d_branches():
    x, ws, bs, dil, vec = _head_args()
    got = aspp_chw_plain(x, ws, bs, dil, vec)
    want = torch.cat([F.conv2d(x, wt, b, padding=d * (wt.shape[-1] // 2),
                               dilation=d) for wt, b, d in zip(ws, bs, dil)],
                     1) + vec[:, :, None, None]
    torch.testing.assert_close(got, want.relu(), rtol=1e-5, atol=1e-5)
    assert torch.equal(aspp_chw(x, ws, bs, dil, vec), got)


def test_aspp_launch_hands_the_plan_to_the_entry(monkeypatch):
    """The 3x3 branches first, each with its output offset; the halo the
    widest reach rounded to 8; the shared bytes ``aspp_smem``'s. The
    kernel takes bf16 only, input channels in multiples of 32."""
    seen = []
    monkeypatch.setattr(aspp_mod, "_launch",
                        lambda fn, t, *a: seen.append(a) or 0)
    monkeypatch.setattr(aspp_mod, "_aspp_entry", lambda: "entry")
    x, ws, bs, _, _ = _head_args(dtype=torch.bfloat16)
    dil = [1, 6, 12, 18]
    aspp_mod._aspp_launch(x, ws, bs, dil, None, None)
    (a,), = [seen]
    assert a[-8:] == (2, 64, 5, 7, 64, 24, 3, aspp_smem(24, 3))
    assert a[7] == 4 and a[8] is None
    assert aspp_halo([1, 3, 3, 3], dil) == 24
    assert aspp_halo([1], [1]) == 0
    assert aspp_smem(24, 3) == 98048 and aspp_smem(0, 1) == 47104
    assert 2 * (aspp_smem(24, 3) + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="bf16"):
        aspp_mod._aspp_launch(x.float(), ws, bs, dil, None, None)
    with pytest.raises(ValueError, match="multiples of 32"):
        aspp_mod._aspp_launch(x[:, :48], [w[:, :48] for w in ws], bs, dil,
                              None, None)


def test_pooled_vector_is_the_concat_projection(model):
    """The folded head's pooled branch as a per-image vector added inside
    the projection equals the projection of the concatenation with the
    broadcast pooled map (f32)."""
    folded = FoldedASPPDecoder(model.decoder, torch.float32)
    f = torch.randn(2, 320, 4, 8, generator=torch.Generator().manual_seed(1))
    ws, bs, _ = folded.branch_weights()
    cat = aspp_chw(f, ws, bs, folded.dilations)
    got = aspp_chw(cat, [folded.proj_w], [folded.proj_b], [1],
                   folded.vector(f))
    p = torch.relu(f.mean((2, 3)) @ folded.pool_w.t() + folded.pool_b)
    full = torch.cat([cat, p[:, :, None, None].expand(-1, -1, 4, 8)], 1)
    w_full = torch.cat([folded.proj_w[:, :, 0, 0], folded.proj_pool_w], 1)
    want = torch.relu(torch.einsum("oc,bchw->bohw", w_full, full)
                      + folded.proj_b[:, None, None])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_folded_head_buffers(model):
    folded = FoldedASPPDecoder(model.decoder, torch.bfloat16)
    assert folded.dilations == [1, 6, 12, 18]
    assert tuple(folded.wp1.shape) == (9, 256, 320)
    assert tuple(folded.wp0.shape) == (1, 256, 320)
    assert tuple(folded.proj_wp.shape) == (1, 256, 1024)
    assert folded.proj_pool_w.dtype == torch.float32
    assert tuple(folded.proj_pool_w.shape) == (256, 256)
    assert torch.equal(folded.wp1, pack_weights(folded.w1.float()))
    assert not any(k.startswith("wp") or k == "proj_wp"
                   for k in folded.state_dict())


# -------------------------------------------------- against the reference

def test_plain_model_matches_the_reference(model, frames):
    """The port's plain ``models.Segmenter`` against the reference's
    forward, f32, on seeded weights: same state-dict names, logits at
    1/16 within 1e-4."""
    sd = model.state_dict()
    assert {n for n, *_ in ref.param_spec(CFG)} == set(sd)
    x = ref.normalize(torch.from_numpy(frames))
    with torch.no_grad():
        got = model(x)
        want = ref.Net(ref.from_dict(sd), CFG)(x)
    assert got.shape == (2, K, 4, 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_engine_twin_path_matches_the_reference(model, frames):
    """The folded engine (BatchNorm folded, the head's pooled vector, the
    twins of every kernel) in f32 against the reference's served logits
    at full resolution, within 1e-4."""
    seg = Segmenter(model, device="cpu", compute_dtype=torch.float32)
    got = seg.predict(frames, return_logits=True)
    want = ref.served_logits(model.state_dict(), CFG,
                             torch.from_numpy(frames))
    assert got.shape == (2, K, 64, 128)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)


def test_engine_bf16_masks_against_the_reference(model, frames):
    """The bf16 engine's masks against the reference's argmax: at least
    BF16_MASK_FLOOR of the pixels agree."""
    seg = Segmenter(model, device="cpu")
    masks = seg.predict_batch(frames)
    want = ref.served_logits(model.state_dict(), CFG,
                             torch.from_numpy(frames)).argmax(1).numpy()
    rate = float((masks == want).mean())
    assert len(np.unique(want)) >= 8
    assert rate >= BF16_MASK_FLOOR, rate


def test_spans_and_counters(model, frames):
    """A deeplab call records the atrous and aspp spans and three rate-2
    blocks; an arch0 call records neither span."""
    seg = Segmenter(model, device="cpu")
    arch0 = Segmenter(create_segmenter(ARCHS["arch0"], K, device="cpu",
                                       generator=torch.Generator()
                                       .manual_seed(0)), device="cpu")
    n0 = inv_res_chw.dilated_calls
    with profiling.tracing():
        profiling.collect()
        seg.predict_batch(frames[:1])
        names = {s["name"] for s in profiling.collect()}
        arch0.predict_batch(frames[:1])
        arch0_names = {s["name"] for s in profiling.collect()}
    assert inv_res_chw.dilated_calls - n0 == 3
    for n in ("segtpu.engine.encoder.atrous", "segtpu.engine.decoder.aspp"):
        assert n in names and n not in arch0_names
    assert "segtpu.engine.encoder" in arch0_names


def test_wide_frame_takes_the_flat_tail(model, monkeypatch):
    """A 2048-wide frame gives 128-wide logits at output stride 16: the
    engine's rule takes the W-first tail."""
    calls = []
    real = inference.upsample_argmax_flat
    monkeypatch.setattr(inference, "upsample_argmax_flat",
                        lambda *a, **kw: calls.append(a[1]) or real(*a, **kw))
    seg = Segmenter(model, device="cpu")
    out = seg.predict(np.zeros((32, 2048, 3), np.uint8))
    assert out.shape == (32, 2048) and calls == [(2, 128)]


def test_sharded_serving_and_training_refuse_the_family(model):
    seg = Segmenter(model, device="cpu")
    with pytest.raises(TypeError, match="deeplab"):
        ShardedSegmenter(seg, ["cpu", "cpu"])
    with pytest.raises(TypeError, match="deeplab"):
        make_train_step(DEEPLABV3, None, num_classes=K)
    with pytest.raises(TypeError, match="aux"):
        ASPPDecoder(DEEPLABV3, (24, 32, 96, 320), K, aux=True,
                    generator=torch.Generator())


def test_reference_stands_alone():
    """The reference imports torch alone, and the benchmark holds the same
    file."""
    src = (ROOT / "segtpu_torch" / "reference" / "deeplabv3_mnv2.py")
    tree = ast.parse(src.read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom)}
    assert mods <= {"__future__", "contextlib", "typing", "torch"}
    copy = ROOT / "benchmark" / "reference" / "deeplabv3_mnv2.py"
    assert copy.read_bytes() == src.read_bytes()
