"""The benchmark's own count of each layer's work: dot-product FLOPs and
the least bytes, per call of ``n`` frames of h x w.

A layer's least time is the larger of its FLOPs at the bf16 tensor-core
peak and its bytes at the HBM rate (``benchmark.peaks``). The bytes are
the layer's inputs, weights and outputs, each counted once, never an
intermediate between the layer's own kernels. The FLOPs are what the
layer's function needs, whatever route computes it:

* the encoder: the MobileNet-v2 walk (expand, depthwise 3x3, project, as
  the program's ``utils/roofline.py`` walks it), its stem counted as the
  function it is, a 3x3 stride-2 convolution of 3 channels (27
  multiply-adds an output), not as the 2x2 convolution of 12
  space-to-depth channels (48) that one route runs;
* the micro decoder: that walk's adapt 1x1s, cell ops and classifier,
  with each aggregate 1x1 at its own input's resolution (it runs before
  its upsample) and the classifier over the channels actually collected;
* the template decoder: the same rules over its blocks (``psum``: a 1x1
  on each input at its own resolution; ``cat``: the reduce 1x1 at the
  block's);
* the tail: bilinear upsampling and argmax, in whichever of its two
  separable orders (H first or W first) takes fewer operations;
* the front: no product; bytes alone.

Global-average-pool ops and resizes inside the decoder are counted as no
FLOPs (a lower bound: least times never exceed what any implementation
needs). ``tests/test_benchmark_counts.py`` holds these counts to the
program's ``utils/roofline.py`` at 1024x2048 term by term, and their
bytes to the tensors the reference reads and writes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.reference.model import (MBV2, OPS, AGG_OPS, TAP_CHANNELS,
                                       STRIDE, param_spec)

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def padded(h: int, w: int) -> Tuple[int, int]:
    return -(-h // STRIDE) * STRIDE, -(-w // STRIDE) * STRIDE


def taps_hw(h: int, w: int) -> List[Tuple[int, int]]:
    hp, wp = padded(h, w)
    return [(hp // s, wp // s) for s in (4, 8, 16, 32)]


def weight_elements(cfg: dict, prefix: str, *, aux: bool = False) -> int:
    """Convolution weight elements of the parameters under ``prefix``."""
    n = 0
    for name, shape, kind, _ in param_spec(cfg, aux=aux):
        if kind == "conv" and name.startswith(prefix):
            size = 1
            for d in shape:
                size *= d
            n += size
    return n


# -- FLOPs of one frame ------------------------------------------------

def encoder_flop(h: int, w: int) -> float:
    hp, wp = padded(h, w)
    eh, ew = hp // 2, wp // 2
    flop = 2.0 * eh * ew * 27 * 32                  # the 3x3/2 stem
    cin = 32
    for t, c, n, s in MBV2:
        for i in range(n):
            stride = s if i == 0 else 1
            mid = cin * t
            oh, ow = eh // stride, ew // stride
            if t != 1:
                flop += 2.0 * eh * ew * cin * mid   # expand 1x1
            flop += 2.0 * 9 * oh * ow * mid         # depthwise 3x3
            flop += 2.0 * oh * ow * mid * c         # project 1x1
            cin, eh, ew = c, oh, ow
    return flop


def op_flop(index: int, npx: int, c: int, repeats: int) -> float:
    kind, k, _ = OPS[index]
    if kind == "sep":
        return repeats * (2.0 * k * k * npx * c + 2.0 * npx * c * c)
    if kind == "conv":
        return 2.0 * k * k * npx * c * c
    return 0.0                                      # gap, skip, none


def decoder_flop(cfg: dict, h: int, w: int, *, aux: bool = False) -> float:
    agg, K = int(cfg["agg_size"]), int(cfg["num_classes"])
    reps = int(cfg.get("repeats", 1))
    hw = taps_hw(h, w)
    npx = [a * b for a, b in hw]
    flop = sum(2.0 * p * c * agg for p, c in zip(npx, TAP_CHANNELS))
    used = set()
    if cfg["family"] == "micro":
        cell, conns = cfg["genotype"]
        ops = [cell[0]] + [o for nd in cell[1:] for o in nd[2:]]
        blocks = [(i, j, None) for i, j in conns]
    else:
        blocks = [(i, j, (agg_op, op)) for i, j, agg_op, op in cfg["genotype"]]
    for i, j, tmpl in blocks:
        bh, bw = max(hw[i][0], hw[j][0]), max(hw[i][1], hw[j][1])
        bpx = bh * bw
        if tmpl is None or AGG_OPS[tmpl[0]] == "psum":
            flop += 2.0 * (npx[i] + npx[j]) * agg * agg
        else:
            flop += 2.0 * bpx * 2 * agg * agg
        for o in (ops if tmpl is None else [tmpl[1]]):
            flop += op_flop(o, bpx, agg, reps)
        if aux:
            flop += 2.0 * bpx * agg * K
        hw.append((bh, bw))
        npx.append(bpx)
        used.update((i, j))
    collect = [i for i in range(len(hw)) if i not in used]
    head_px = max(hw[i][0] for i in collect) * max(hw[i][1] for i in collect)
    flop += 2.0 * head_px * len(collect) * agg * K
    return flop


def tail_flop(K: int, h: int, w: int) -> float:
    """Bilinear upsampling of [K, hp/4, wp/4] to hp x wp (two multiplies
    and an add a tap pair), then one compare a class and pixel, in the
    cheaper of the two separable orders."""
    hp, wp = padded(h, w)
    qh, qw = hp // 4, wp // 4
    h_first = K * hp * (3 * qw + 4 * wp)
    w_first = K * wp * (3 * qh + 4 * hp)
    return float(min(h_first, w_first))


# -- each layer of the served call, for n frames -------------------------

def served_layers(cfg: dict, n: int, h: int, w: int) -> Dict[str, Dict]:
    """{layer: {"flop", "bytes"}} of one served call of n frames: front,
    encoder, decoder and tail."""
    e = ESIZE[cfg["compute_dtype"]]
    K = int(cfg["num_classes"])
    hp, wp = padded(h, w)
    image = n * 3 * hp * wp * e                     # the normalized frame
    taps = sum(n * c * a * b * e for c, (a, b) in zip(TAP_CHANNELS,
                                                     taps_hw(h, w)))
    logits = n * K * (hp // 4) * (wp // 4) * e
    return {
        "front": {"flop": 0.0, "bytes": float(n * h * w * 3 + image)},
        "encoder": {"flop": n * encoder_flop(h, w),
                    "bytes": float(image + taps
                                   + weight_elements(cfg, "encoder.") * e)},
        "decoder": {"flop": n * decoder_flop(cfg, h, w),
                    "bytes": float(taps + logits
                                   + weight_elements(cfg, "decoder.") * e)},
        "tail": {"flop": n * tail_flop(K, h, w),
                 "bytes": float(logits + n * h * w)},
    }


def served_flop(cfg: dict, h: int, w: int) -> float:
    """The forward's FLOPs a frame: the four layers' sum."""
    return sum(v["flop"] for v in served_layers(cfg, 1, h, w).values())


def train_flop(cfg: dict, h: int, w: int) -> float:
    """A training step's FLOPs a frame: three times the forward with
    the aux heads (forward, and the backward's two products a weight)."""
    return 3.0 * (encoder_flop(h, w) + decoder_flop(cfg, h, w, aux=True))
