"""MobileNet-v2 with BatchNorm folded, every stage one fused kernel
(counterpart: segtpu/models/fast_encoder.py::mbv2_chw_apply).

``fold_encoder(enc, compute_dtype)`` folds eval BatchNorm into the conv
weights of a ``MobileNetV2`` from its f32 weights and returns a
``FoldedMobileNetV2``: the s2d stem as one ``conv_chw`` (k=2, relu6),
the 13 stride-1 blocks as ``inv_res_chw`` and the 4 stride-2 blocks as
``inv_res_s2_chw``, each handed its expand and project weights in the
CUDA-core kernel's layout (``pack_inv_res``), packed once here. An
encoder at output stride 16 (``MobileNetV2(output_stride=16)``) runs
its last four blocks as ``inv_res_chw`` at stride 1, three of them at
depthwise rate 2 (``dilation=2``). Its
forward takes the space-to-depth planes [N, 12, H/2, W/2] and returns
the four taps (strides 4/8/16/32), with the tap rule of
``encoders.MobileNetV2``. Dense weights are rounded to
the compute dtype once, after folding in f32; depthwise weights and
biases stay f32 (the JAX path's numerics).

``mbv2_chw_sharded`` is the H-sharded mode (counterpart:
``mbv2_chw_apply(spatial_axis=...)``): every stage runs its unmodified
kernel on the shard's rows extended by true neighbour rows and drops
the output rows computed on the kernel's own zero padding
(overlap-discard), so each tap is, bit for bit, the shard's rows of the
unsharded tap.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from segtpu_torch.kernels.chw_ops import (conv_chw, fold_bn, inv_res_chw,
                                          inv_res_s2_chw, pack_inv_res)
from segtpu_torch.models.encoders import (_MBV2_CFG, _TAP_STAGES,
                                          MobileNetV2, block_schedule,
                                          stem_s2d_kernel)
from segtpu_torch.parallel.collectives import halo_exchange
from segtpu_torch.utils.profiling import span


def _fold(conv_bn):
    if conv_bn.w.dtype != torch.float32:
        raise ValueError(f"fold_encoder folds f32 weights, got "
                         f"{conv_bn.w.dtype}: fold before casting")
    return fold_bn(conv_bn.w, conv_bn.scale, conv_bn.bias, conv_bn.mean,
                   conv_bn.var)


class FoldedInvRes(nn.Module):
    """One inverted residual with BN folded: expand (None for t = 1),
    depthwise 3x3 at ``stride`` and rate ``dilation`` and project, as
    buffers."""

    def __init__(self, blk, compute_dtype):
        super().__init__()
        self.stride = blk.dw.stride
        self.dilation = blk.dw.dilation
        self.residual = blk.residual
        if hasattr(blk, "expand"):
            w, b = _fold(blk.expand)
            self.register_buffer("w_exp", w.to(compute_dtype))
            self.register_buffer("b_exp", b)
        else:
            self.register_buffer("w_exp", None)
            self.register_buffer("b_exp", None)
        w, b = _fold(blk.dw)
        self.register_buffer("w_dw", w)
        self.register_buffer("b_dw", b)
        w, b = _fold(blk.project)
        self.register_buffer("w_proj", w.to(compute_dtype))
        self.register_buffer("b_proj", b)
        # the CUDA-core kernel's layout of the expand and project weights,
        # packed once (not saved: they are the weights above, transposed)
        pe, pp = pack_inv_res(self.w_exp, self.w_proj, compute_dtype)
        self.register_buffer("packed_exp", pe, persistent=False)
        self.register_buffer("packed_proj", pp, persistent=False)

    def forward(self, x, use_kernels: bool = True):
        args = (x, self.w_exp, self.b_exp, self.w_dw, self.b_dw,
                self.w_proj, self.b_proj)
        packed = (self.packed_exp, self.packed_proj)
        if self.stride == 2:
            return inv_res_s2_chw(*args, use_kernels=use_kernels,
                                  packed=packed)
        return inv_res_chw(*args, residual=self.residual,
                           use_kernels=use_kernels, packed=packed,
                           dilation=self.dilation)


class FoldedMobileNetV2(nn.Module):
    """s2d12 planes [N, 12, H/2, W/2] -> the 4 encoder taps."""

    def __init__(self, enc: MobileNetV2, compute_dtype):
        super().__init__()
        w, b = _fold(enc.stem)
        self.register_buffer("stem_w", stem_s2d_kernel(w).to(compute_dtype))
        self.register_buffer("stem_b", b)
        self.blocks = nn.ModuleList(FoldedInvRes(blk, compute_dtype)
                                    for blk in enc.blocks)
        # a tap after the last block of each tap stage (encoders.py)
        self.tap_after = []
        for stage, (_, _, n, _) in enumerate(_MBV2_CFG):
            self.tap_after += [stage in _TAP_STAGES and i == n - 1
                               for i in range(n)]
        # the blocks whose stride or rate the output_stride rule changed
        # (at 16: the 160- and 320-channel ones) run inside the device span
        # segtpu.engine.encoder.atrous; at 32 there are none
        self.atrous_from = next(
            (i for i, (a, b) in enumerate(zip(
                block_schedule(32), block_schedule(enc.output_stride)))
             if a != b), len(self.blocks))

    def stem(self, x12, use_kernels: bool = True):
        return conv_chw(x12, self.stem_w, self.stem_b, k=2, act="relu6",
                        use_kernels=use_kernels)

    def forward(self, x12, use_kernels: bool = True) -> List[torch.Tensor]:
        y = self.stem(x12, use_kernels)
        taps = []
        k = self.atrous_from

        def run(y, lo, hi):
            for blk, is_tap in zip(self.blocks[lo:hi], self.tap_after[lo:hi]):
                y = blk(y, use_kernels)
                if is_tap:
                    taps.append(y)
            return y

        y = run(y, 0, k)
        if k < len(self.blocks):
            with span("segtpu.engine.encoder.atrous", device=y.device):
                run(y, k, len(self.blocks))
        return taps


def crop_h(y, top: int, bottom: int = 0):
    """y without its first ``top`` and last ``bottom`` rows, contiguous
    (the kernels take contiguous tensors)."""
    if not (top or bottom):
        return y
    return y[:, :, top:y.shape[2] - bottom].contiguous()


def mbv2_chw_sharded(encs, x12s, use_kernels: bool = True):
    """The folded encoder on an H-sharded frame. ``encs[s]`` is the
    ``FoldedMobileNetV2`` on shard s's device (shards of one device share
    one), ``x12s[s]`` the shard's rows [N, 12, H/2n, W/2] of the
    space-to-depth planes. Returns the four taps, each a list of the
    shards' rows.

    The stem's k=2 taps reach one row up: one halo row above, output row
    0 dropped. A stride-1 block's 3x3 reaches one row each way: one halo
    row each side, both edge rows dropped. A stride-2 block reads rows
    2i-1..2i+1: two halo rows above (the local rows stay even), the top
    output row dropped. At the ends of the mesh there is no halo and no
    row to drop: the kernel's own padding is the image's
    (``halo_exchange(ends=False)``)."""
    uk, last = use_kernels, len(encs) - 1
    if any(blk.dilation != 1 for blk in encs[0].blocks):
        raise ValueError("the H-sharded encoder runs rate-1 blocks (one "
                         "halo row a stage), not a dilated encoder")

    def stage(fn_of, ys, up: int, dn: int, drop_top: int, drop_bottom: int):
        ext = halo_exchange(ys, up, dn, ends=False)
        return [crop_h(fn_of(enc)(x, uk), drop_top if s > 0 else 0,
                       drop_bottom if s < last else 0)
                for s, (enc, x) in enumerate(zip(encs, ext))]

    ys = stage(lambda enc: enc.stem, x12s, 1, 0, 1, 0)
    taps = []
    for bi, is_tap in enumerate(encs[0].tap_after):
        def block(enc, bi=bi):
            return enc.blocks[bi]
        if encs[0].blocks[bi].stride == 2:
            ys = stage(block, ys, 2, 0, 1, 0)
        else:
            ys = stage(block, ys, 1, 1, 1, 1)
        if is_tap:
            taps.append(ys)
    return taps


def fold_encoder(enc: MobileNetV2, compute_dtype=torch.bfloat16
                 ) -> FoldedMobileNetV2:
    """A ``FoldedMobileNetV2`` of ``enc``'s f32 weights, on enc's device."""
    return FoldedMobileNetV2(enc, compute_dtype).eval()
