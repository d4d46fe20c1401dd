"""The benchmark's own count of the work of DeepLab-v3 with ASPP on
MobileNet-v2 at output stride 16 (``configs/deeplabv3_mnv2_os16.json``),
per call of ``n`` frames of h x w: dot-product FLOPs and the least bytes
of each served layer, as ``work.py`` counts the NAS configurations.

A layer's least time is the larger of its FLOPs at the bf16 tensor-core
peak and its bytes at the HBM rate (``benchmark.peaks``). The bytes are
the layer's inputs, weights and outputs, each counted once; the FLOPs
what the layer's function needs, whatever route computes it:

* the encoder: the stem as the 3x3 stride-2 convolution of 3 channels
  (27 multiply-adds an output), then each block's expand, depthwise 3x3
  (9 taps at any rate) and project at its own output size under the
  output_stride rule (``reference/deeplabv3_mnv2.schedule``); its output
  the 320-channel map alone (the only one the head reads);
* ``atrous``: the four blocks at stride 16 (the first 160-channel block at
  rate 1, then three at rate 2), their input (96 channels) and output
  (320) at 1/16;
* the head: the 1x1 branch and the 3x3 atrous branches at every pixel of
  the 1/16 map; the image-pooling branch's 1x1 once a frame (on one
  pooled pixel) and its slice of the projection once a frame too (it is
  constant over the map: a lower bound, as global pools count no FLOPs);
  the projection over the other branches' channels at every pixel; the
  classifier; its bytes the map f, the weights and the logits;
* the tail: bilinear upsampling of the 1/16 logits and the argmax, in
  the cheaper of its two separable orders;
* the front: no product; bytes alone.

``tests/test_benchmark_dlv3.py`` holds these counts term by term to the
convolutions the reference runs at 1024x2048.
"""

from __future__ import annotations

from typing import Dict, Tuple

from benchmark.reference.deeplabv3_mnv2 import MBV2, PAD, param_spec, schedule

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def padded(h: int, w: int) -> Tuple[int, int]:
    return -(-h // PAD) * PAD, -(-w // PAD) * PAD


def map_hw(cfg: dict, h: int, w: int) -> Tuple[int, int]:
    """The head's map: the padded frame at the output stride."""
    hp, wp = padded(h, w)
    os_ = int(cfg["output_stride"])
    return hp // os_, wp // os_


def weight_elements(cfg: dict, prefix: str, blocks=None) -> int:
    """Convolution weight elements of the parameters under ``prefix`` (and
    of the encoder blocks ``blocks``, where given)."""
    n = 0
    for name, shape, kind, _ in param_spec(cfg):
        if kind != "conv" or not name.startswith(prefix):
            continue
        if blocks is not None and int(name.split(".")[2]) not in blocks:
            continue
        size = 1
        for d in shape:
            size *= d
        n += size
    return n


def encoder_walk(cfg: dict, h: int, w: int):
    """[(block index, FLOPs, stride at its output)] of the 17 blocks, and
    the stem's FLOPs, for one frame."""
    hp, wp = padded(h, w)
    eh, ew = hp // 2, wp // 2
    stem = 2.0 * eh * ew * 27 * 32
    sched = iter(schedule(int(cfg["output_stride"])))
    out, cin, bi, at = [], 32, 0, 2
    for t, c, n, _ in MBV2:
        for _ in range(n):
            stride, _ = next(sched)
            mid = cin * t
            oh, ow = eh // stride, ew // stride
            flop = 2.0 * eh * ew * cin * mid if t != 1 else 0.0
            flop += 2.0 * 9 * oh * ow * mid + 2.0 * oh * ow * mid * c
            at *= stride
            out.append((bi, flop, at))
            cin, eh, ew, bi = c, oh, ow, bi + 1
    return stem, out


def atrous_blocks(cfg: dict, h: int, w: int) -> list:
    """Indices of the blocks that run at the configuration's output stride
    but at 32 without the output_stride rule (at 16: the last four)."""
    _, walk32 = encoder_walk(dict(cfg, output_stride=32), h, w)
    return [bi for bi, _, at in walk32 if at > int(cfg["output_stride"])]


def encoder_flop(cfg: dict, h: int, w: int) -> float:
    stem, walk = encoder_walk(cfg, h, w)
    return stem + sum(f for _, f, _ in walk)


def atrous_flop(cfg: dict, h: int, w: int) -> float:
    _, walk = encoder_walk(cfg, h, w)
    keep = set(atrous_blocks(cfg, h, w))
    return sum(f for bi, f, _ in walk if bi in keep)


def head_flop(cfg: dict, h: int, w: int) -> float:
    mh, mw = map_hw(cfg, h, w)
    npx = mh * mw
    cin, ch = MBV2[-1][1], int(cfg["aspp_channels"])
    nr, K = len(cfg["aspp_rates"]), int(cfg["num_classes"])
    flop = 2.0 * npx * ch * cin * (1 + 9 * nr)       # 1x1 and atrous
    flop += 2.0 * ch * cin + 2.0 * ch * ch           # pooled: once a frame
    flop += 2.0 * npx * ch * ch * (nr + 1)           # projection
    flop += 2.0 * npx * ch * K                       # classifier
    return flop


def tail_flop(cfg: dict, h: int, w: int) -> float:
    """Bilinear upsampling of [K, hp/os, wp/os] to hp x wp (two multiplies
    and an add a tap pair), then a compare a class and pixel, in the
    cheaper of the two separable orders."""
    hp, wp = padded(h, w)
    qh, qw = map_hw(cfg, h, w)
    K = int(cfg["num_classes"])
    return float(min(K * hp * (3 * qw + 4 * wp), K * wp * (3 * qh + 4 * hp)))


def served_layers(cfg: dict, n: int, h: int, w: int) -> Dict[str, Dict]:
    """{layer: {"flop", "bytes"}} of one served call of n frames: front,
    encoder, atrous (inside the encoder), head and tail."""
    e = ESIZE[cfg["compute_dtype"]]
    K = int(cfg["num_classes"])
    hp, wp = padded(h, w)
    mh, mw = map_hw(cfg, h, w)
    image = n * 3 * hp * wp * e
    f = n * MBV2[-1][1] * mh * mw * e
    logits = n * K * mh * mw * e
    blocks = atrous_blocks(cfg, h, w)
    atrous_in = n * MBV2[4][1] * mh * mw * e          # the 96-channel tap
    return {
        "front": {"flop": 0.0, "bytes": float(n * h * w * 3 + image)},
        "encoder": {"flop": n * encoder_flop(cfg, h, w),
                    "bytes": float(image + f
                                   + weight_elements(cfg, "encoder.") * e)},
        "atrous": {"flop": n * atrous_flop(cfg, h, w),
                   "bytes": float(atrous_in + f + weight_elements(
                       cfg, "encoder.blocks.", set(blocks)) * e)},
        "head": {"flop": n * head_flop(cfg, h, w),
                 "bytes": float(f + logits
                                + weight_elements(cfg, "decoder.") * e)},
        "tail": {"flop": n * tail_flop(cfg, h, w),
                 "bytes": float(logits + n * h * w)},
    }


def served_flop(cfg: dict, h: int, w: int) -> float:
    """The forward's FLOPs a frame: front, encoder, head and tail (the
    atrous blocks are inside the encoder)."""
    layers = served_layers(cfg, 1, h, w)
    return sum(layers[k]["flop"] for k in ("front", "encoder", "head",
                                           "tail"))
