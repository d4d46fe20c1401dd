"""The port's analytic roofline (``segtpu_torch.utils.roofline``) against
the JAX package's (``segtpu.utils.roofline``), on the CPU:

* for arch0, arch1 and arch2 at 1024x2048 and 512x512 with
  ``detail=True``, the encoder's (stem and inverted residuals) and the
  decoder's ``gflop`` and ``mb``, and every encoder and decoder block's
  ``gflop``, equal the JAX walk's (relative 1e-12): the model's
  arithmetic;
* every time is the H100's rates (``segtpu_torch.scripts``) applied to
  the counts: the optimistic time at the bf16 peak and the HBM rate, the
  attainable one as the largest of the bytes, the tensor-core and the
  CUDA-core terms; and the module keeps no TPU constant;
* the front's and the tail's counts equal the formulas of
  ``chip_smoke.py``'s bounds, which now read them from here;
* the units the roofline charges the decoder's 1x1s and cell ops to are
  those the folded decoder launches: as many ``pw_tc_kernel`` calls
  (``pw_chain_chw``, ``pw_multi_chw``) as 1x1s charged to the tensor
  cores, and as many ``conv_chw`` calls of a cell op as dense cell ops
  charged to the CUDA cores, counted on the CPU.
"""

import numpy as np
import pytest
import torch

from segtpu.utils import roofline as jax_roofline

from segtpu_torch.models import ARCHS, create_segmenter
from segtpu_torch.models import fast_decoder
from segtpu_torch.models.fast_decoder import fold_decoder
from segtpu_torch.scripts import (BF16_FLOP_PER_S, F32_FLOP_PER_S,
                                  HBM_BYTES_PER_S, bound_ms)
from segtpu_torch.utils import roofline

import chip_smoke

K = 19
ARCH_NAMES = ("arch0", "arch1", "arch2")
SHAPES = ((1024, 2048), (512, 512))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """{(arch, hw): (the port's roofline, JAX's)}, detail=True."""
    return {(a, hw): (roofline.compute_roofline(*hw, a, num_classes=K,
                                                detail=True),
                      jax_roofline.compute_roofline(*hw, a, num_classes=K,
                                                    detail=True))
            for a in ARCH_NAMES for hw in SHAPES}


def _by_name(items):
    return {it["name"]: it for it in items}


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_encoder_and_decoder_workload_equal_jax(pairs, arch, hw):
    port, jax_r = pairs[(arch, hw)]
    segs, jsegs = _by_name(port["segments"]), _by_name(jax_r["segments"])
    for name in ("encoder stem 2x2x12->32", "encoder inv-res blocks (fused)",
                 f"decoder ({arch}, 48ch cells)"):
        for key in ("gflop", "mb"):
            assert segs[name][key] == pytest.approx(jsegs[name][key],
                                                    rel=1e-12), (name, key)
    blocks, jblocks = _by_name(port["blocks"]), _by_name(jax_r["blocks"])
    assert list(blocks) == list(jblocks)
    for name in blocks:
        if name in ("front", "tail"):
            continue
        assert blocks[name]["gflop"] == pytest.approx(
            jblocks[name]["gflop"], rel=1e-12), name


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_times_are_the_h100_rates_applied_to_the_counts(pairs, arch):
    for hw in SHAPES:
        r, _ = pairs[(arch, hw)]
        for s in r["segments"]:
            t_op = s["gflop"] * 1e9 / BF16_FLOP_PER_S * 1e3
            t_mem = s["mb"] * 1e6 / HBM_BYTES_PER_S * 1e3
            assert s["achievable_ms"] == pytest.approx(max(t_op, t_mem),
                                                       rel=1e-12)
            assert s["bound"] == ("tensor cores" if t_op > t_mem else "HBM")
            assert s["tensor_core_gflop"] + s["cuda_core_gflop"] == \
                pytest.approx(s["gflop"], rel=1e-12), s["name"]
        for item in r["segments"] + r["blocks"]:
            mb = item.get("attain_mb", item["mb"])
            want = max(mb * 1e6 / HBM_BYTES_PER_S,
                       item["tensor_core_gflop"] * 1e9 / BF16_FLOP_PER_S,
                       item["cuda_core_gflop"] * 1e9 / F32_FLOP_PER_S) * 1e3
            assert item["attain_ms"] == pytest.approx(want, rel=1e-12)
        assert r["total_ms"] == pytest.approx(
            sum(s["achievable_ms"] for s in r["segments"]), rel=1e-12)
        assert r["attainable_ms"] == pytest.approx(
            sum(s["attain_ms"] for s in r["segments"]), rel=1e-12)
        assert r["roofline_ips"] == pytest.approx(1e3 / r["total_ms"])
        assert r["attainable_ips"] == pytest.approx(1e3 / r["attainable_ms"])
        assert r["attainable_ips"] < r["roofline_ips"]
        assert (r["peak_bf16_tflops"], r["peak_hbm_gbs"],
                r["peak_f32_tflops"]) == (BF16_FLOP_PER_S / 1e12,
                                          HBM_BYTES_PER_S / 1e9,
                                          F32_FLOP_PER_S / 1e12)
        # the encoder runs on the CUDA cores alone
        enc = _by_name(r["segments"])["encoder inv-res blocks (fused)"]
        assert enc["cuda_core_gflop"] == enc["gflop"]
    for name in ("PEAK_BF16_TFLOPS", "PEAK_HBM_GBS", "PEAK_VPU_F32_TFLOPS",
                 "_mxu_eff"):
        assert not hasattr(roofline, name)


def test_front_and_tail_counts_equal_chip_smoke_formulas():
    for n, h, w, k in ((8, 1024, 2048, 19), (1, 512, 512, 19),
                       (2, 256, 384, 5)):
        hp2, wp2 = h // 2, w // 2
        assert roofline.front_work(h, w, n) == (
            n * h * w * 3 + n * 12 * hp2 * wp2 * 2, 0, n * 12 * hp2 * wp2 * 2)
        qh, qw = h // 4, w // 4
        assert roofline.tail_work(h, w, k, n) == (
            n * k * qh * qw * 2 + n * h * w, 0, n * k * h * (3 * qw + 4 * w))
        assert roofline.tail_work(h, w, k, n, 4, flat=True) == (
            n * k * qh * qw * 4 + n * h * w, 0, n * k * w * (3 * qh + 4 * h))
    b = chip_smoke.bounds({})
    N, H, W = chip_smoke.N, chip_smoke.H, chip_smoke.W
    assert b["front"] == bound_ms(*roofline.front_work(H, W, N))
    assert b["upsample_argmax"] == bound_ms(
        *roofline.tail_work(H, W, chip_smoke.K, N))
    for hw in SHAPES:
        r = roofline.compute_roofline(*hw, "arch0", num_classes=K)
        front, tail = r["segments"][0], r["segments"][-1]
        nbytes, _, ops = roofline.front_work(*hw)
        assert (front["mb"], front["gflop"]) == (nbytes / 1e6, ops / 1e9)
        nbytes, _, ops = roofline.tail_work(*hw, K, flat=hw[1] == 512)
        assert (tail["mb"], tail["gflop"]) == (nbytes / 1e6, ops / 1e9)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decoder_units_are_the_launches(arch, monkeypatch):
    """The folded decoder on small taps, its wrappers counted: as many
    pw_chain_chw and pw_multi_chw calls as the roofline's tensor-core
    1x1s; a conv_chw k = 1 call for each CUDA-core adapt of a tap read
    whole, each CUDA-core aggregate 1x1 outside a resize chain and a
    CUDA-core classifier; a cell op's conv_chw call for each dense cell
    op on the CUDA cores, in each block."""
    model = create_segmenter(ARCHS[arch], K, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    dec = fold_decoder(model.decoder, torch.float32)
    calls = {"pw": 0, "conv1x1": 0, "cell": 0}
    for name in ("pw_chain_chw", "pw_multi_chw"):
        real = getattr(fast_decoder, name)

        def counted(*a, _real=real, **kw):
            calls["pw"] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(fast_decoder, name, counted)
    real_conv = fast_decoder.conv_chw

    def conv(*a, **kw):
        # a cell op passes its dilation; the 1x1s of the adapts, the
        # aggregates and the classifier do not
        calls["cell" if "dilation" in kw else "conv1x1"] += 1
        return real_conv(*a, **kw)
    monkeypatch.setattr(fast_decoder, "conv_chw", conv)
    hw = (64, 128)
    taps_hw = [(hw[0] // s, hw[1] // s) for s in (4, 8, 16, 32)]
    rng = np.random.default_rng(0)
    taps = [torch.from_numpy(rng.standard_normal((1, c, *t)).astype(
        np.float32)) for c, t in zip((24, 32, 96, 320), taps_hw)]
    with torch.inference_mode():
        dec(taps)
    adapt, aggs, head = roofline.decoder_1x1_units(ARCHS[arch], taps_hw)
    units = [u for pair in aggs for u in pair] + [head]
    assert calls["pw"] == units.count("tc")
    lazy_cc = sum(1 for e, (i, j) in enumerate(ARCHS[arch][1])
                  for x, u in zip((i, j), aggs[e]) if x < 4 and u == "cc"
                  and adapt[x] == "cc" and dec.lazy[x])
    eager_taps = sum(1 for lz in dec.lazy if not lz)
    assert calls["conv1x1"] == (eager_taps + units.count("cc") - lazy_cc)
    cell_units = roofline.cell_conv_units(ARCHS[arch][0])
    assert calls["cell"] == cell_units.count("cc") * len(ARCHS[arch][1])
