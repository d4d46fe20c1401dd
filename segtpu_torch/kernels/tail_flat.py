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
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from segtpu_torch.kernels.chw_ops import _launch, _on_cpu
from segtpu_torch.kernels.upsample_argmax import _plain_core, interp_taps

TILE = (16, 256)      # output rows and columns of a block, as in the .cu


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


def _band(taps: np.ndarray, tile: int) -> int:
    """The most input rows (columns) one output tile's taps reach."""
    n = taps.shape[1]
    return max(int(taps[1, min(s + tile, n) - 1] - taps[0, s]) + 1
               for s in range(0, n, tile))


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, w: int, ho: int, wo: int, device: torch.device):
    """Tap tables (bf16-rounded weights) and band sizes of one geometry,
    uploaded once per device."""
    rows, rw = interp_taps(h, ho, True, ho, True)
    cols, cw = interp_taps(w, wo, True, wo, True)
    bands = (_band(rows, TILE[0]), _band(cols, TILE[1]))
    return tuple(torch.from_numpy(t).to(device)
                 for t in (rows, rw, cols, cw)) + bands


def clf_upsample_argmax(feat, wclf, bclf, out_hw):
    """feat bf16 [B, C, h, w], wclf [K, C] (rounded to bf16), bclf f32 [K]
    -> uint8 mask [B, Ho, Wo] (see the module doc). On a CUDA tensor this
    launches the kernel (``clf_upsample_argmax.launches``)."""
    if _on_cpu(feat, "clf_upsample_argmax"):
        return clf_upsample_argmax_plain(feat, wclf, bclf, out_hw)
    b, c, h, w, k, ho, wo = _geometry(feat, wclf, bclf, out_hw)
    if not feat.is_contiguous() or w % 8 or feat.data_ptr() % 16:
        raise ValueError("clf_upsample_argmax kernel needs a contiguous feat "
                         "of width a multiple of 8 at a 16-byte aligned "
                         f"address (it copies 16-byte rows), got w = {w}")
    wk = wclf.to(torch.bfloat16).contiguous()
    bk = bclf.to(torch.float32).contiguous()
    rows, rw, cols, cw, band_r, band_c = _device_tables(h, w, ho, wo,
                                                        feat.device)
    out = torch.empty((b, ho, wo), dtype=torch.uint8, device=feat.device)
    from segtpu_torch.kernels._build import load
    fn = load("tail_flat").segtpu_clf_upsample_argmax
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    rc = _launch(fn, feat, feat.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                 out.data_ptr(), b, c, k, h, w, ho, wo, band_r, band_c,
                 rows.data_ptr(), rw.data_ptr(), cols.data_ptr(), cw.data_ptr())
    if rc != 0:
        raise RuntimeError(f"clf_upsample_argmax kernel launch failed: CUDA "
                           f"error {rc}")
    clf_upsample_argmax.launches += 1
    return out


clf_upsample_argmax.launches = 0
