"""Classifier-fused upsample + argmax tail, from the flat-tail experiment
(counterpart: scripts/exp_tail_flat.py::_kernel).

``clf_upsample_argmax`` launches the CUDA kernel (csrc/tail_flat.cu) on a
CUDA tensor, counted in ``clf_upsample_argmax.launches``, and runs
``clf_upsample_argmax_plain`` on a CPU tensor. Both compute, bit for bit,

    argmax_k upsample(bf16(wclf @ feat + bclf))[:, k]

from the decoder's bf16 feature map [B, C, h, w], with the experiment's
rounding: the classifier sum in f32 from zero in channel order, rounded
to bf16; the H pass with bf16 weights, rounded to bf16; the W pass with
bf16 weights in f32 (the production tail, ``upsample_argmax``, keeps its
W weights in f32, so the two masks differ at near-ties); a strict-greater
argmax, ties to the lower class. align_corners bilinear, as the
experiment. The TPU kernel's 16-row views and 128-column padding are its
tiling and are not carried over. Not wired into the engine.

The kernel walks bands of output rows down a segment of output columns,
keeping the logit rows it has classified in a ring; ``clf_tail_plan``
lays it out (``clf_tail_smem``: the shared bytes the C entry checks,
``clf_tail_walk`` and ``clf_new_rows``: the steps and rows each block
takes, ``clf_tail_recompute``: the classifier's recomputed share).
``clf_upsample_argmax_v1`` launches the first-form kernel (v1) for A/B timing only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from segtpu_torch.kernels.chw_ops import _launch, _on_cpu, _plan_ints
from segtpu_torch.kernels.upsample_argmax import (_plain_core, interp_taps,
                                                  tail_span)


def _geometry(feat, wclf, bclf, out_hw):
    if feat.ndim != 4 or feat.dtype != torch.bfloat16:
        raise ValueError(f"clf_upsample_argmax takes bf16 feat [B, C, h, w], "
                         f"got {feat.dtype} {tuple(feat.shape)}")
    b, c, h, w = feat.shape
    if wclf.ndim != 2 or wclf.shape[1] != c or bclf.shape != (wclf.shape[0],):
        raise ValueError(f"clf_upsample_argmax takes wclf [K, {c}] and bclf "
                         f"[K], got {tuple(wclf.shape)} {tuple(bclf.shape)}")
    k = wclf.shape[0]
    if not 1 <= k <= 256:
        raise ValueError(f"a uint8 mask holds at most 256 classes, got {k}")
    if wclf.device != feat.device or bclf.device != feat.device:
        raise ValueError("wclf and bclf must lie on feat's device")
    ho, wo = int(out_hw[0]), int(out_hw[1])
    if ho < 1 or wo < 1:
        raise ValueError(f"output size {(ho, wo)}")
    return b, c, h, w, k, ho, wo


def classifier_plain(feat, wclf, bclf):
    """bf16 logits [B, K, h, w]: ``sum_c wclf[:, c] * feat[:, c]`` in f32
    from zero in channel order, ``+ bclf``, rounded to bf16."""
    w = wclf.to(torch.bfloat16).float()
    acc = torch.zeros((feat.shape[0], w.shape[0]) + feat.shape[2:],
                      device=feat.device)
    for c in range(feat.shape[1]):
        acc = acc + w[:, c, None, None] * feat[:, c:c + 1].float()
    return (acc + bclf.float()[:, None, None]).to(torch.bfloat16)


def clf_upsample_argmax_plain(feat, wclf, bclf, out_hw):
    """Plain PyTorch version of ``clf_upsample_argmax`` (same bits)."""
    _, _, h, w, _, ho, wo = _geometry(feat, wclf, bclf, out_hw)
    rows, rw = interp_taps(h, ho, True, ho, True)
    cols, cw = interp_taps(w, wo, True, wo, True)
    dev = feat.device
    rows, cols = (torch.from_numpy(t).long().to(dev) for t in (rows, cols))
    rw, cw = (torch.from_numpy(t).to(dev) for t in (rw, cw))
    return _plain_core(classifier_plain(feat, wclf, bclf), rows, rw, cols, cw,
                       ho, wo)


# The kernel's layout (csrc/tail_flat.cu clf_tail_kernel): bands of BR
# output rows x segments of SW output columns, each thread 8 consecutive
# output columns of one row (a half-warp 128 columns, BR even), so BR * SW
# / 8 threads, at most 512; classifier units of 4 columns x 4 classes
# (CLF_CK: the weights' rows are padded to it).
CLF_PX = 8
CLF_CK = 4
CLF_MAX_THREADS = 512
_SMEM_LIMIT = 227 * 1024           # opt-in shared memory per block, H100
# the (BR, SW) tiles the plan may take, in its order of preference: the
# widest segment first (the least recomputed classifier; the fastest at the
# script's b8 48-channel 256x512 -> 1024x2048, K = 19, on an H100:
# exp_tail_flat --tiles times them all), then 8-row bands before 4-row
# ones (at 720x1280, (8, 256) in one chunk of classes beat (4, 512) in
# three)
CLF_TILES = ((8, 512), (8, 256), (4, 512), (4, 256), (8, 128))
V1_TILE = (16, 256)   # the v1 kernel's output tile, as in the .cu


class ClfTailPlan(NamedTuple):
    br: int          # output rows of a band
    sw: int          # output columns of a segment
    nr: int          # input rows a band's taps name at most (the ring)
    nc: int          # input columns staged (a multiple of 8)
    kc: int          # classes a chunk of the H and W passes
    smem: int        # shared bytes


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def clf_tail_smem(br: int, nr: int, nc: int, kc: int, c: int, k: int) -> int:
    """Shared bytes of a block (csrc/tail_flat.cu ClfLayout): the weights
    f32 [C][K rounded up to 4], the bias, the logit ring bf16 [K][nr][nc],
    two feature buffers bf16 [C][nr][nc], the H pass f32 [kc][br][nc + 1],
    each region but the last rounded up to 16 bytes."""
    kp = -(-k // CLF_CK) * CLF_CK
    return (_r16(4 * c * kp) + _r16(4 * kp) + _r16(2 * k * nr * nc)
            + 2 * _r16(2 * c * nr * nc) + 4 * kc * br * (nc + 1))


@functools.lru_cache(maxsize=None)
def clf_tail_plan(c: int, k: int, h: int, w: int, ho: int, wo: int,
                  tile=None) -> ClfTailPlan:
    """The layout of a launch from [B, c, h, w] features to a (ho, wo)
    mask of k classes: the first tile of CLF_TILES (or ``tile``) whose
    block fits shared memory with one class a chunk at least, the classes
    in the fewest chunks, of sizes as even as they go (a further chunk
    costs two barriers, a thinner tile more: ``exp_tail_flat --tiles``);
    nr and nc from the tap tables (the most input rows a band names, the
    input columns a segment names from its first low tap aligned down to
    8). The arithmetic does not depend on the plan."""
    rows, _ = interp_taps(h, ho, True, ho, True)
    cols, _ = interp_taps(w, wo, True, wo, True)
    for br, sw in CLF_TILES if tile is None else (tuple(tile),):
        if br % 2 or sw % (16 * CLF_PX) or br * sw // CLF_PX > \
                CLF_MAX_THREADS:
            raise ValueError(f"no fused-tail kernel for a {br}x{sw} band")
        nr = tail_span(rows, br)
        nc = -(-tail_span(cols, sw, 8) // 8) * 8
        fixed = clf_tail_smem(br, nr, nc, 0, c, k)
        most = min(k, (_SMEM_LIMIT - fixed) // (4 * br * (nc + 1)))
        if most >= 1:
            kc = -(-k // -(-k // most))
            return ClfTailPlan(br, sw, nr, nc, kc,
                               clf_tail_smem(br, nr, nc, kc, c, k))
    raise ValueError(f"fused tail of {k} classes, {c} channels {h}x{w} -> "
                     f"{ho}x{wo}: no tile fits shared memory")


def clf_tail_args(plan: ClfTailPlan, wo: int, out_ptr: int) -> tuple:
    """The 7 ints the C entry takes: the plan and vout (8-byte mask stores
    where ``wo`` is a multiple of 8 and the mask 8-byte aligned)."""
    return tuple(plan) + (int(wo % CLF_PX == 0 and out_ptr % 8 == 0),)


def clf_tail_walk(plan: ClfTailPlan, b: int, ho: int, wo: int, grid: int):
    """The steps of each of ``grid`` persistent blocks (the kernel's
    ClfWalk): block i takes steps [total * i // grid, total * (i + 1) //
    grid) of the (image, segment, band) sequence, bands fastest. Yields
    (block, step, image, band, first output row, first output column)."""
    nseg, nband = -(-wo // plan.sw), -(-ho // plan.br)
    total = b * nseg * nband
    for blk in range(grid):
        for g in range(total * blk // grid, total * (blk + 1) // grid):
            col, band = divmod(g, nband)
            yield (blk, g, col // nseg, band, band * plan.br,
                   col % nseg * plan.sw)


def clf_new_rows(rows: np.ndarray, first: bool, band: int, oy0: int,
                 br: int, ho: int):
    """[lo, hi]: the input rows a step classifies (ClfWalk::new_rows): its
    band's taps, less those of the band above unless the step is its
    block's first or the band a column's first."""
    lo, hi = int(rows[0, oy0]), int(rows[1, min(oy0 + br, ho) - 1])
    if not first and band != 0:
        lo = max(lo, int(rows[1, oy0 - 1]) + 1)
    return lo, hi


def clf_tail_recompute(plan: ClfTailPlan, b: int, h: int, w: int, ho: int,
                       wo: int, grid: int) -> float:
    """Pixels the classifier computes over those of the feature map, for
    ``grid`` blocks: the segments' staged columns (the taps' span, aligned
    to 8) and the rows a block's first band classifies again."""
    rows, _ = interp_taps(h, ho, True, ho, True)
    done, last = 0, None
    for blk, g, _, band, oy0, _ in clf_tail_walk(plan, b, ho, wo, grid):
        lo, hi = clf_new_rows(rows, blk != last, band, oy0, plan.br, ho)
        last = blk
        done += max(0, hi - lo + 1) * plan.nc
    return done / (b * h * w)


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, w: int, ho: int, wo: int, device: torch.device):
    """Tap tables (bf16-rounded weights) of one geometry, uploaded once
    per device."""
    rows, rw = interp_taps(h, ho, True, ho, True)
    cols, cw = interp_taps(w, wo, True, wo, True)
    return tuple(torch.from_numpy(t).to(device) for t in (rows, rw, cols, cw))


@functools.lru_cache(maxsize=None)
def _clf_entry():
    """``segtpu_clf_upsample_argmax``: feat, wclf, bclf, out, 7 ints (B,
    C, K, h, w, Ho, Wo), the four tables, the plan's 7 ints, the stream."""
    from segtpu_torch.kernels._build import load
    fn = load("tail_flat").segtpu_clf_upsample_argmax
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return fn


def _kernel_operands(feat, wclf, bclf, out_hw):
    b, c, h, w, k, ho, wo = _geometry(feat, wclf, bclf, out_hw)
    if not feat.is_contiguous() or w % 8 or feat.data_ptr() % 16:
        raise ValueError("clf_upsample_argmax kernel needs a contiguous feat "
                         "of width a multiple of 8 at a 16-byte aligned "
                         f"address (it copies 16-byte rows), got w = {w}")
    return (b, c, h, w, k, ho, wo, wclf.to(torch.bfloat16).contiguous(),
            bclf.to(torch.float32).contiguous())


def _clf_launch(feat, wclf, bclf, out_hw, tile=None):
    """The kernel on checked CUDA operands (csrc/tail_flat.cu
    clf_tail_kernel, with the plan of ``clf_tail_plan``; ``tile`` another
    of its tiles, for exp_tail_flat's sweep)."""
    b, c, h, w, k, ho, wo, wk, bk = _kernel_operands(feat, wclf, bclf, out_hw)
    tables = _device_tables(h, w, ho, wo, feat.device)
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=feat.device)
    ints = _plan_ints(clf_tail_args(clf_tail_plan(c, k, h, w, ho, wo, tile),
                                    wo, out.data_ptr()))
    rc = _launch(_clf_entry(), feat, feat.data_ptr(), wk.data_ptr(),
                 bk.data_ptr(), out.data_ptr(), b, c, k, h, w, ho, wo,
                 *(t.data_ptr() for t in tables), ctypes.addressof(ints))
    if rc != 0:
        raise RuntimeError(f"clf_upsample_argmax kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def clf_upsample_argmax(feat, wclf, bclf, out_hw):
    """feat bf16 [B, C, h, w], wclf [K, C] (rounded to bf16), bclf f32 [K]
    -> uint8 mask [B, Ho, Wo] (see the module doc). On a CUDA tensor this
    launches the kernel (``clf_upsample_argmax.launches``)."""
    if _on_cpu(feat, "clf_upsample_argmax"):
        return clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)
    out = _clf_launch(feat, wclf, bclf, out_hw)
    clf_upsample_argmax.launches += 1
    return out


clf_upsample_argmax.launches = 0


def _band(taps: np.ndarray, tile: int) -> int:
    """The most input rows (columns) one output tile's taps reach."""
    n = taps.shape[1]
    return max(int(taps[1, min(s + tile, n) - 1] - taps[0, s]) + 1
               for s in range(0, n, tile))


@functools.lru_cache(maxsize=None)
def v1_bands(h: int, w: int, ho: int, wo: int):
    """The v1 kernel's band rows and columns of one geometry."""
    return (_band(interp_taps(h, ho, True, ho, True)[0], V1_TILE[0]),
            _band(interp_taps(w, wo, True, wo, True)[0], V1_TILE[1]))


def v1_smem(c: int, k: int, h: int, w: int, ho: int, wo: int) -> int:
    """Shared bytes of a v1 block (csrc/tail_flat.cu v1::smem_bytes);
    above 227 KB it cannot launch (K = 150 at 48 channels)."""
    band_r, band_c = v1_bands(h, w, ho, wo)
    feats = c * band_r * ((band_c + 14) // 8 * 8)
    region = max(feats, k * V1_TILE[0] * band_c)
    return c * -(-k // 8) * 8 * 4 + (-(-k * band_r * band_c // 8) * 8
                                     + region) * 2


def clf_upsample_argmax_v1(feat, wclf, bclf, out_hw):
    """The first-form (v1) kernel of ``clf_upsample_argmax`` (csrc/tail_flat.cu
    v1::clf_upsample_argmax_kernel: a 16 x 256 tile a block, its feature
    band staged whole before any arithmetic), for A/B timing beside the
    wrapper's kernel only: CUDA tensors, no launch count, on no path."""
    if feat.device.type != "cuda":
        raise ValueError("clf_upsample_argmax_v1 takes CUDA tensors")
    b, c, h, w, k, ho, wo, wk, bk = _kernel_operands(feat, wclf, bclf, out_hw)
    tables = _device_tables(h, w, ho, wo, feat.device)
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=feat.device)
    from segtpu_torch.kernels._build import load
    fn = load("tail_flat").segtpu_clf_upsample_argmax_v1
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    rc = _launch(fn, feat, feat.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                 out.data_ptr(), b, c, k, h, w, ho, wo,
                 *v1_bands(h, w, ho, wo), *(t.data_ptr() for t in tables))
    if rc != 0:
        raise RuntimeError(f"clf_upsample_argmax_v1 launch failed: CUDA "
                           f"error {rc}")
    return out
