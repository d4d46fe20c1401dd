"""The benchmark's work counts (``benchmark/counts``): held to the
program's ``utils/roofline.py`` walk at 1024x2048, and by construction
to what the plain reference computes and reads.

    python -m pytest benchmark/tests -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.counts import work  # noqa: E402
from benchmark.peaks import least_seconds  # noqa: E402
from benchmark.reference.model import (MBV2, Net, TAP_CHANNELS,  # noqa: E402
                                       from_dict, normalize)
from benchmark.weights import make_frames, make_weights  # noqa: E402

CONFIGS = ("arch0", "template0")


def cfg_of(name):
    return json.loads((ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


def test_encoder_matches_roofline_walk_but_the_stem():
    """The encoder's count is the program's walk term for term, except the
    stem: 27 multiply-adds an output (the 3x3 function), not 48 (the
    2x2 convolution of 12 space-to-depth channels one route runs)."""
    from segtpu_torch.utils.roofline import compute_roofline
    h, w = 1024, 2048
    segs = {s["name"]: s["gflop"]
            for s in compute_roofline(h, w, "arch0")["segments"]}
    stem_48 = segs["encoder stem 2x2x12->32"] * 1e9
    stem_27 = stem_48 * 27 / 48
    walk = segs["encoder inv-res blocks (fused)"] * 1e9 + stem_48
    assert work.encoder_flop(h, w) == pytest.approx(walk - stem_48 + stem_27,
                                                    rel=1e-12)


def test_micro_decoder_matches_roofline_walk_but_two_terms():
    """arch0's decoder count is the walk's (adapts, the cell ops at each
    block's size) but for the two terms the walk over-counts: each
    aggregate 1x1 at its own input's size (the walk charges both at the
    block's), and the classifier over the 48 channels arch0 collects (the
    walk charges 2 x 48). With those two replaced, equal; and the whole,
    front and tail added as the walk counts them, is gflop_total."""
    from segtpu_torch.utils.roofline import compute_roofline
    h, w = 1024, 2048
    cfg = cfg_of("arch0")
    roof = compute_roofline(h, w, "arch0")
    segs = {s["name"]: s["gflop"] for s in roof["segments"]}
    agg, K = 48, 19
    hw = work.taps_hw(h, w)
    npx = [a * b for a, b in hw]
    walk_aggs = mine_aggs = 0.0
    for i, j in cfg["genotype"][1]:
        bh, bw = max(hw[i][0], hw[j][0]), max(hw[i][1], hw[j][1])
        walk_aggs += 2 * 2.0 * bh * bw * agg * agg
        mine_aggs += 2.0 * (npx[i] + npx[j]) * agg * agg
        hw.append((bh, bw))
        npx.append(bh * bw)
    head = (h // 4) * (w // 4)
    walk_head, mine_head = 2.0 * head * 2 * agg * K, 2.0 * head * agg * K
    walk = segs["decoder (arch0, 48ch cells)"] * 1e9
    assert work.decoder_flop(cfg, h, w) == pytest.approx(
        walk - walk_aggs + mine_aggs - walk_head + mine_head, rel=1e-12)
    front_tail = (segs["front: normalize+s2d"]
                  + segs["tail: upsample+argmax"]) * 1e9
    total = (work.encoder_flop(h, w) + work.decoder_flop(cfg, h, w)
             + front_tail)
    stem_48 = segs["encoder stem 2x2x12->32"] * 1e9
    diff = (stem_48 * 21 / 48 + walk_aggs - mine_aggs + walk_head
            - mine_head)
    assert total + diff == pytest.approx(roof["gflop_total"] * 1e9,
                                         rel=1e-12)
    assert roof["gflop_total"] == pytest.approx(39.09, abs=0.005)


def _conv_flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_never_exceed_the_reference_function(name):
    """Each layer's FLOPs are at most the multiply-adds (x2) the plain
    reference computes for it (counted by PyTorch's FLOP counter), so its
    least time never exceeds what an implementation needs."""
    cfg = cfg_of(name)
    h, w = 128, 256
    wts = make_weights(cfg, 3, "cpu")
    net = Net(from_dict(wts), cfg)
    x = normalize(make_frames(3, 1, 1, h, w, "cpu"))
    with torch.no_grad():
        enc = _conv_flops(lambda: net.encoder(x))
        taps = net.encoder(x)
        fam = net.micro if cfg["family"] == "micro" else net.template
        dec = _conv_flops(lambda: fam(taps, False))
    assert work.encoder_flop(h, w) <= enc
    assert work.decoder_flop(cfg, h, w) <= dec
    # and close to it: only the pool branch's 1x1 and the resizes'
    # products are left out
    assert work.encoder_flop(h, w) == pytest.approx(enc, rel=1e-9)
    assert work.decoder_flop(cfg, h, w) >= 0.9 * dec


@pytest.mark.parametrize("name", CONFIGS)
def test_bytes_are_inputs_weights_outputs_once(name):
    """Each layer's bytes are the sizes of the tensors the reference's
    layer reads and writes, each once, in the served dtype (uint8 frames
    and masks), and its weights: no intermediate."""
    cfg = cfg_of(name)
    n, h, w = 2, 128, 256
    e = work.ESIZE[cfg["compute_dtype"]]
    wts = make_weights(cfg, 4, "cpu")
    net = Net(from_dict(wts), cfg)
    frames = make_frames(4, 1, n, h, w, "cpu")
    x = normalize(frames)
    with torch.no_grad():
        taps = net.encoder(x)
        logits = net(x)
    L = work.served_layers(cfg, n, h, w)
    size = lambda ts: sum(t.numel() for t in ts) * e  # noqa: E731
    enc_w = sum(t.numel() for k, t in wts.items()
                if k.startswith("encoder.") and k.endswith(".w")) * e
    dec_w = sum(t.numel() for k, t in wts.items()
                if k.startswith("decoder.") and k.endswith(".w")) * e
    assert [t.shape[1] for t in taps] == list(TAP_CHANNELS)
    assert L["front"]["bytes"] == frames.numel() + size([x])
    assert L["encoder"]["bytes"] == size([x]) + size(taps) + enc_w
    assert L["decoder"]["bytes"] == size(taps) + size([logits]) + dec_w
    assert L["tail"]["bytes"] == size([logits]) + n * h * w
    for v in L.values():
        assert least_seconds(v["flop"], v["bytes"]) > 0


def test_tail_counts_the_cheaper_order():
    K, h, w = 19, 1024, 2048
    h_first = K * h * (3 * (w // 4) + 4 * w)
    w_first = K * w * (3 * (h // 4) + 4 * h)
    assert work.tail_flop(K, h, w) == min(h_first, w_first)
    assert work.tail_flop(K, 512, 512) == K * 512 * (3 * 128 + 4 * 512)


def test_mbv2_table_is_the_published_one():
    """arXiv:1801.04381 Table 2 at width 1.0."""
    assert MBV2 == ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                    (6, 320, 1, 1))
