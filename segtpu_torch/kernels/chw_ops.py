"""Folded-BatchNorm convolutions, the fused MobileNet-v2 blocks and the
decoder's fused ops (counterpart: segtpu/kernels/chw_ops.py — fold_bn,
conv_chw, inv_res_chw, inv_res_s2_chw, pw_chain_chw, pw_multi_chw,
sep_conv_chw, pair_op_chw, cell_op_chw).

Every function takes and returns plain contiguous NCHW tensors; weights
are OIHW with eval BatchNorm already folded in (``fold_bn``). The TPU
kernels' flat-pixel layouts, row-split planes, quadrant splits and 0/1
permutation matmuls only moved bytes into the TPU's lane layout: they
do not change the function and are not carried over.

Each wrapper launches its CUDA kernel (``csrc/conv_chw.cu``,
``inv_res.cu``, ``pointwise.cu``, ``cell.cu``) on a CUDA tensor,
counted in its ``.launches``, and runs its plain twin (``*_plain``,
same signature) on a CPU tensor, or on a CUDA tensor when the caller
passes ``use_kernels=False``. Numerics, as the TPU kernels:

* dense and 1x1 weights are rounded to the compute dtype (x's dtype),
  depthwise weights and all biases stay f32;
* dense products take compute-dtype operands and accumulate in f32,
  then ``+ bias``, the activation and the optional ``acc``/``vec_acc``
  adds run in f32, and the result is rounded once;
* depthwise convs run in f32 on the upcast input;
* a chain of 1x1 stages and a cell's nodes round every intermediate to
  the compute dtype, as storing it would; a separable conv rounds its
  depthwise output once, before its 1x1 product; two branches of a
  node are summed in f32;
* in the inverted residual the expanded tensor stays f32 and is never
  rounded; zero padding is applied to it (the depthwise input), not to
  the block input; the depthwise result (+ bias, relu6) is rounded to
  the compute dtype once, just before the project product; then
  ``+ bias``, ``+ residual`` (the input upcast) and one final rounding.

The plain twins compute the same sums in the kernels' f32 order with
elementwise f32 tensor ops on upcast operands: a dense sum runs over
input channels, then taps, in ascending order, starting from zero; a
depthwise sum over taps in row-major order; the 1x1 products over
channels. Each step is one rounded multiply and one rounded add (a bf16
product is exact in f32, so fused multiply-adds on bf16 operands round
the same way; depthwise and f32 products round separately). The f32
kernels, every depthwise sum and the bf16 conv_chw (the stem and the
decoder's 1x1s), inverted-residual and resize kernels follow that order
and give the twin's bits, on any device and at any
batch size, where a library convolution's sum order is unspecified: its
bf16 roundings would differ here and there, and those differences grow
through the 17 blocks of the encoder.

The bf16 decoder kernels of ``cell.cu`` (``sep_conv_chw``,
``pair_op_chw``, ``cell_op_chw``) and ``pointwise.cu``
(``pw_chain_chw``, ``pw_multi_chw``) compute their dense and 1x1
products on the tensor cores (``mma.sync``), which sum 16 exact products
at a time in their own f32 order: they match their twins to a tolerance
(most elements bit for bit, the rest one rounding apart), not bit for
bit. Their order is the same for every pixel wherever it sits in a tile,
a shard's row window or a batch, so the kernels' own results do not
depend on tiling, sharding or batching. Their weights are packed by
``pack_weights``, once, where the folded decoder is built, and handed to
the wrappers (``packed=``, a branch's ``"wp"``); their tiles and shared
memory are planned by ``node_plan`` and ``pw_plan``, which mirror the
sources' layouts.

The inverted residual has such a kernel too, ``inv_res.cu``'s
``inv_res_tc_kernel`` (bf16, planned by ``inv_res_tc_plan``), behind its
own entry ``inv_res_tc_chw``. No serving path calls it: through the
encoder's 17 blocks its sum order moves arch0's masks further from the
twins' than the slice checks allow, so ``inv_res_chw`` and
``inv_res_s2_chw`` run the CUDA-core kernel, bf16 and f32, and keep
their twins' bits.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from segtpu_torch.core.layers import ACTIVATIONS, BN_EPS, relu6
from segtpu_torch.kernels._build import count_launch

_ACT_CODE = {"none": 0, "relu": 1, "relu6": 2}
_SMEM_LIMIT = 227 * 1024      # opt-in shared memory per block on the H100
_TWO_BLOCKS = 113 * 1024      # shared memory that leaves room for two blocks


@torch.no_grad()
def fold_bn(w, scale, bias, mean, var, eps: float = BN_EPS):
    """OIHW conv weight + eval BatchNorm -> (folded weight, folded bias),
    in f32: ``inv = scale * rsqrt(var + eps)``, ``(w * inv, bias - mean
    * inv)`` per output channel."""
    inv = scale.float() * torch.rsqrt(var.float() + eps)
    return (w.float() * inv[:, None, None, None],
            bias.float() - mean.float() * inv)


def _check_x(x, what: str):
    if x.ndim != 4:
        raise ValueError(f"{what} takes x [B, C, H, W], got {tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} computes in bf16 or f32, not {x.dtype}")


def _on_cpu(x, what: str) -> bool:
    """True for a CPU tensor (run the plain version), False for a CUDA
    one (launch the kernel); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return False


def _use_plain(x, use_kernels: bool, what: str) -> bool:
    return _on_cpu(x, what) or not use_kernels


def _launch(fn, t, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` with ``t``'s device current
    and on that device's current stream: the entry launches on the
    current device, so a tensor of another card than the thread's
    current one needs the switch around the launch itself. Counted in
    ``_build.launch_count()``."""
    with torch.cuda.device(t.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    count_launch()
    return rc


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _ptrs(ts):
    """ctypes array of the tensors' data pointers (None -> null)."""
    return (ctypes.c_void_p * len(ts))(
        *[None if t is None else t.data_ptr() for t in ts])


def _ints(vs):
    return (ctypes.c_int * len(vs))(*vs)


def _on(t, dtype, dev):
    """t as a contiguous ``dtype`` tensor on ``dev`` (no copy when it
    already is one); None stays None."""
    if t is None:
        return None
    if t.device != dev:
        raise ValueError(f"operand on {t.device}, x on {dev}")
    return t.to(dtype).contiguous()


# ---------------------------------------------------------------- conv_chw

def _conv_geometry(x, w, bias, acc, vec_acc, k, dilation, depthwise, act):
    _check_x(x, "conv_chw")
    b, c, h, wd = x.shape
    if k not in (1, 2, 3, 5):
        raise ValueError(f"conv_chw takes k in (1, 2, 3, 5), not {k}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    if act not in _ACT_CODE:
        raise ValueError(f"act is one of {sorted(_ACT_CODE)}, not {act!r}")
    cout = c if depthwise else w.shape[0]
    want = (c, 1, k, k) if depthwise else (cout, c, k, k)
    if tuple(w.shape) != want:
        raise ValueError(f"conv_chw weight must be OIHW {want}, got "
                         f"{tuple(w.shape)}")
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias must be [{cout}], got {tuple(bias.shape)}")
    if acc is not None and tuple(acc.shape) != (b, cout, h, wd):
        raise ValueError(f"acc must be {(b, cout, h, wd)}, got "
                         f"{tuple(acc.shape)}")
    if vec_acc is not None and tuple(vec_acc.shape) != (b, cout):
        raise ValueError(f"vec_acc must be {(b, cout)}, got "
                         f"{tuple(vec_acc.shape)}")
    return b, c, h, wd, cout


def _pads(k: int, dilation: int):
    """Tap offsets are dilation * (t - k // 2), t = 0..k-1: k = 2 reads
    dy, dx in {-d, 0} (pad (d, 0)), odd k pads symmetrically."""
    lo = dilation * (k // 2)
    return lo, dilation * (k - 1) - lo


def _taps(xp, k: int, dilation: int, stride: int, out_hw):
    """Tap views of the zero-padded xp, row-major: tap (ky, kx) of output
    (i, j) reads xp[stride * i + dilation * ky, stride * j + dilation * kx]."""
    ho, wo = out_hw
    return [xp[:, :, dilation * ky:dilation * ky + stride * (ho - 1) + 1:stride,
               dilation * kx:dilation * kx + stride * (wo - 1) + 1:stride]
            for ky in range(k) for kx in range(k)]


def _dense_sum(taps, w):
    """sum over channels c, then taps t, of w[o, c, t] * tap_t[c], one
    rounded multiply and add per step from zero (the kernels' order)."""
    b, c, h, wd = taps[0].shape
    y = taps[0].new_zeros((b, w.shape[0], h, wd))
    wt = w.reshape(w.shape[0], c, len(taps))
    for ci in range(c):
        for t, xt in enumerate(taps):
            y += wt[:, ci, t, None, None] * xt[:, ci:ci + 1]
    return y


def _depthwise_sum(taps, w):
    """sum over taps t of w[c, t] * tap_t[c], the kernels' order."""
    y = torch.zeros_like(taps[0])
    wt = w.reshape(w.shape[0], len(taps))
    for t, xt in enumerate(taps):
        y += wt[:, t, None, None] * xt
    return y


def conv_chw_plain(x, w, bias, acc=None, vec_acc=None, *, k: int,
                   dilation: int = 1, depthwise: bool = False,
                   act: str = "relu"):
    """Plain PyTorch version of ``conv_chw`` (same signature, numerics
    and sum order)."""
    _, _, h, wd, _ = _conv_geometry(x, w, bias, acc, vec_acc, k, dilation,
                                    depthwise, act)
    lo, hi = _pads(k, dilation)
    taps = _taps(F.pad(x.float(), (lo, hi, lo, hi)), k, dilation, 1, (h, wd))
    if depthwise:
        y = _depthwise_sum(taps, w.float())
    else:
        y = _dense_sum(taps, w.to(x.dtype).float())
    y = ACTIVATIONS[act](y + bias.float()[:, None, None])
    if acc is not None:
        y = y + acc.float()
    if vec_acc is not None:
        y = y + vec_acc.float()[:, :, None, None]
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _conv_entry():
    from segtpu_torch.kernels._build import load
    fn = load("conv_chw").segtpu_conv_chw
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_ints(args: tuple):
    """A plan's ints as the C array the entry reads (made once a plan)."""
    return _ints(args)


def _conv_launch(x, w, bias, acc, vec_acc, k, dilation, depthwise, act):
    """The kernel on checked operands (csrc/conv_chw.cu; k = 1 dense takes
    conv1x1_kernel with the plan of ``conv1x1_args``, k = 2 dense at
    dilation 1 conv_k2_kernel with the plan of ``stem_args``)."""
    b, c, h, wd, cout = _conv_geometry(x, w, bias, acc, vec_acc, k,
                                       dilation, depthwise, act)
    if not x.is_contiguous():
        raise ValueError("conv_chw kernel needs a contiguous x")
    if acc is not None and (acc.dtype != x.dtype or not acc.is_contiguous()):
        raise ValueError("conv_chw kernel needs acc contiguous in x's dtype")
    dev = x.device
    wk = _on(w, torch.float32 if depthwise else x.dtype, dev)
    bk = _on(bias, torch.float32, dev)
    vk = _on(vec_acc, torch.float32, dev)
    if acc is not None and acc.device != dev:
        raise ValueError(f"acc on {acc.device}, x on {dev}")
    out = torch.empty((b, cout, h, wd), dtype=x.dtype, device=dev)
    plan = None
    ptrs = [t.data_ptr() for t in (x, acc, out) if t is not None]
    if k == 1 and not depthwise:
        plan = _plan_ints(conv1x1_args(c, cout, h * wd, x.element_size(),
                                       ptrs))
    elif k == 2 and not depthwise and dilation == 1:
        plan = _plan_ints(stem_args(c, cout, wd, x.element_size(), ptrs))
    fn = _conv_entry()
    rc = _launch(fn, x, x.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                 acc.data_ptr() if acc is not None else None,
                 vk.data_ptr() if vk is not None else None, out.data_ptr(),
                 b, c, cout, h, wd, k, dilation, int(depthwise),
                 _ACT_CODE[act], int(x.dtype == torch.bfloat16),
                 None if plan is None else ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"conv_chw kernel launch failed: CUDA error {rc}")
    return out


def conv_chw(x, w, bias, acc=None, vec_acc=None, *, k: int,
             dilation: int = 1, depthwise: bool = False, act: str = "relu",
             use_kernels: bool = True):
    """x [B, C, H, W] -> act(conv(x, w) + bias) (+ acc) (+ vec_acc)
    [B, Cout, H, W], with BN folded into the OIHW weight ``w`` (dense
    [Cout, C, k, k] or depthwise [C, 1, k, k]) and f32 ``bias``.

    k in (1, 2, 3, 5) at any dilation, zero-padded to the same size;
    act "relu", "relu6" or "none"; ``acc`` [B, Cout, H, W] and
    ``vec_acc`` [B, Cout] are added after the activation in f32. On a
    CUDA tensor this launches the kernel (``conv_chw.launches``)."""
    if _use_plain(x, use_kernels, "conv_chw"):
        return conv_chw_plain(x, w, bias, acc, vec_acc, k=k,
                              dilation=dilation, depthwise=depthwise,
                              act=act)
    out = _conv_launch(x, w, bias, acc, vec_acc, k, dilation, depthwise, act)
    conv_chw.launches += 1
    return out


conv_chw.launches = 0


# A k = 1 dense conv_chw launch (csrc/conv_chw.cu conv1x1_kernel): one warp
# per group of CO output channels, each thread CO channels x PX pixels of a
# run of 32 * PX pixels, the input staged through a ring of four chunks.
_PW_LANES = 32
_PW_STAGES = 4
_PW_MAX_GROUPS = 8
_FOUR_BLOCKS = 228 * 1024 // 4 - 1024     # shared memory for four blocks
# the thread tile (CO, PX): of the tiles conv1x1_kernel instantiates,
# (12, 4) is within 2 % of the fastest at both launch shapes of the arch0
# path (48 -> 48 at 8x128x256, 48 -> 19 at 8x256x512), measured on an
# H100 by ``pw_resize_probe.py --tiles``
CONV1X1_TILES = ((12, 4), (8, 8), (4, 16), (20, 2))
_CONV1X1_TILE = (12, 4)
_CONV1X1_KC = 32                          # input channels a staged chunk


class Conv1x1Plan(NamedTuple):
    co: int          # output channels a thread accumulates (CO)
    px: int          # consecutive pixels a thread accumulates (PX)
    ng: int          # channel groups, one warp each
    kc: int          # input channels of a staged chunk
    groups: int      # blocks along Cout, ng * co channels each
    smem: int        # shared bytes


def conv1x1_smem(cin: int, co: int, px: int, ng: int, kc: int,
                 esize: int) -> int:
    """Shared bytes of a k = 1 block (csrc/conv_chw.cu ``conv1x1_smem``):
    the f32 weights [cin][ng * co] and bias [ng * co], then four input
    chunks [kc][32 * px] of ``esize``-byte elements."""
    return (4 * (cin + 1) * ng * co
            + _PW_STAGES * kc * _PW_LANES * px * esize)


def conv1x1_plan(cin: int, cout: int, esize: int,
                 tile=_CONV1X1_TILE) -> Conv1x1Plan:
    """The layout of a k = 1 dense launch: the thread tile ``tile`` (CO,
    PX), up to 8 channel groups a block (96 channels: all of Cout 19 and
    48, so every input byte is read once), 32 input channels a staged
    chunk. Of the splits of Cout into blocks, the fewest whose shared
    memory leaves room for four blocks per SM, else one. The sum order
    does not depend on the plan."""
    co, px = tile
    kc = min(cin, _CONV1X1_KC)
    for limit in (_FOUR_BLOCKS, _SMEM_LIMIT):
        for groups in range(_cdiv(cout, _PW_MAX_GROUPS * co), cout + 1):
            ng = _cdiv(_cdiv(cout, groups), co)
            smem = conv1x1_smem(cin, co, px, ng, kc, esize)
            if smem <= limit:
                return Conv1x1Plan(co, px, ng, kc, _cdiv(cout, ng * co),
                                   smem)
    raise ValueError(f"conv_chw 1x1: {cin} -> {cout} channels do not fit "
                     f"shared memory")


_conv1x1_plan = functools.lru_cache(maxsize=None)(conv1x1_plan)


def vector_ok(ptrs, *sizes) -> bool:
    """16-byte loads and stores: every size (elements of a row or plane)
    a multiple of 8 and every data pointer 16-byte aligned."""
    return all(n % 8 == 0 for n in sizes) and all(p % 16 == 0 for p in ptrs)


def conv1x1_args(cin: int, cout: int, hw: int, esize: int, ptrs) -> tuple:
    """The 7 ints the C entry takes for a k = 1 dense call: the plan's
    (co, px, ng, kc, groups, smem) and the vector path (1 when a channel
    plane of ``hw`` pixels and the pointers of x, acc and out allow it)."""
    p = _conv1x1_plan(cin, cout, esize)
    return (p.co, p.px, p.ng, p.kc, p.groups, p.smem,
            int(vector_ok(ptrs, hw) and hw % p.px == 0))


# A dense k = 2 conv_chw launch at dilation 1, the stem (csrc/conv_chw.cu
# conv_k2_kernel): one warp per group of CO output channels and part of a
# row segment, each thread CO channels x PX pixels of one output row, input
# rows y - 1 and y staged through a ring of four chunks.
_K2_LANES = 32
_K2_STAGES = 4
_K2_MAX_WARPS = 8
# the thread tiles (CO, PX) conv_k2_kernel instantiates; the plan's is the
# first, the fastest at the stem's b8 launch on an H100
# (``stem_tail_probe.py --tiles`` times them all)
STEM_TILES = ((8, 8), (16, 4), (4, 16))


class StemPlan(NamedTuple):
    co: int          # output channels a thread accumulates (CO)
    px: int          # consecutive pixels a thread accumulates (PX)
    ng: int          # channel groups
    np: int          # parts of a row segment (S = np * 32 * px pixels)
    kc: int          # input channels of a staged chunk
    groups: int      # blocks along Cout, ng * co channels each
    smem: int        # shared bytes


def stem_row(px: int, np_: int, esize: int) -> int:
    """Elements of a staged input row (csrc/conv_chw.cu ``k2_row``): one
    16-byte chunk of left halo, then the segment of np * 32 * px."""
    return 16 // esize + np_ * _K2_LANES * px


def stem_smem(cin: int, co: int, px: int, ng: int, np_: int, kc: int,
              esize: int) -> int:
    """Shared bytes of a k = 2 block (csrc/conv_chw.cu ``conv_k2_smem``):
    the f32 weights [cin][4][ng * co] and bias [ng * co], then four input
    chunks [kc][2 rows][stem_row] of ``esize``-byte elements."""
    return (4 * (4 * cin + 1) * ng * co
            + _K2_STAGES * kc * 2 * stem_row(px, np_, esize) * esize)


def stem_plan(cin: int, cout: int, width: int, esize: int,
              tile=STEM_TILES[0]) -> StemPlan:
    """The layout of a dense k = 2 launch at dilation 1 on rows of
    ``width`` pixels: the thread tile ``tile`` (CO, PX), up to 8 warps a
    block, split between channel groups (as few blocks along Cout as
    fit) and parts of a row segment (as many as the width takes). The
    largest chunk of input channels whose shared memory leaves room for
    two blocks per SM, else one. The sum order does not depend on the
    plan."""
    co, px = tile
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        for groups in range(_cdiv(cout, _K2_MAX_WARPS * co), cout + 1):
            ng = _cdiv(_cdiv(cout, groups), co)
            np_ = max(1, min(_K2_MAX_WARPS // ng,
                             _cdiv(width, _K2_LANES * px)))
            fixed = stem_smem(cin, co, px, ng, np_, 0, esize)
            per_kc = stem_smem(cin, co, px, ng, np_, 1, esize) - fixed
            kc = min(cin, (limit - fixed) // per_kc)
            if kc >= 1:
                return StemPlan(co, px, ng, np_, kc, _cdiv(cout, ng * co),
                                stem_smem(cin, co, px, ng, np_, kc, esize))
    raise ValueError(f"conv_chw k=2: {cin} -> {cout} channels do not fit "
                     f"shared memory")


_stem_plan = functools.lru_cache(maxsize=None)(stem_plan)


def stem_args(cin: int, cout: int, width: int, esize: int, ptrs,
              tile=STEM_TILES[0]) -> tuple:
    """The 8 ints the C entry takes for a dense k = 2 call at dilation 1:
    the plan's (co, px, ng, np, kc, groups, smem) for ``tile`` and the
    vector path (1 when rows of ``width`` pixels and the pointers of x,
    acc and out allow 16-byte loads and stores of a thread's pixels)."""
    p = _stem_plan(cin, cout, width, esize, tile)
    return tuple(p) + (int(vector_ok(ptrs, width)
                           and width % max(8, p.px) == 0),)


# ------------------------------------------------------ inverted residuals

def _r4(v: int) -> int:
    return -(-v // 4) * 4


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def inv_res_window(th: int, tw: int, stride: int, dilation: int = 1):
    """(rows, cols) of the input window an output tile of th x tw reads:
    the tile plus a halo of the depthwise rate (stride 1), or rows
    2i-1..2i+1 of every output row i (stride 2)."""
    return (stride * th + 2 * dilation + 1 - stride,
            stride * tw + 2 * dilation + 1 - stride)


def _tile_ok(th, tw, ho, wo):
    """A tile no more than twice the output's extent in each dimension."""
    return (th == 1 or th // 2 < ho) and (tw == 4 or tw // 2 < wo)


# A CUDA-core inverted-residual launch (csrc/inv_res.cu inv_res_kernel):
# persistent blocks, each taking th x tw output tiles in turn; the mid
# channels in chunks of mc; each thread an rp x 4 project tile (rp output
# channels x 4 pixels) held in registers across every chunk and 8 x 4
# expand tiles; ceil(cout / rp) * th * tw / 4 threads; with pf, a block
# prefetches its next tile's window while it computes the current one. The
# rp the kernel instantiates, per compute dtype:
INV_RES_TILES = {torch.bfloat16: (4, 8, 12, 20), torch.float32: (4, 8)}
_IR_RE = 8            # mid channels of an expand thread tile (kRE)
_IR_SMALL = 13        # floats of a mid channel's small weights (kSmall)
_IR_SHIFT = 3         # a prefetched window's column 0 (kShift)
_SM_SMEM = 228 * 1024     # shared memory of an SM (a block reserves 1 KB)
_SM_REGS = 65536
_SM_THREADS = 2048
_IR_MCS = (64, 48, 32, 24, 16, 8, 4)      # mid chunks a plan may take
_IR_HW = ((1, 2, 4, 8, 16), (4, 8, 16, 32, 64))   # tile rows, columns


class InvResPlan(NamedTuple):
    th: int          # output tile rows
    tw: int          # output tile columns (a power of 2, >= 4)
    mc: int          # mid channels of a chunk
    rp: int          # output channels of a thread's project tile (x 4 px)
    pf: int          # 1: the next tile's window prefetched (two windows)
    nt: int          # threads of a block
    smem: int        # shared bytes
    blocks: int      # blocks resident on an SM (shared memory, threads,
                     # registers at the instantiation's cap)


def inv_res_threads(rp: int) -> int:
    """Most threads of a block of the rp instantiation (csrc/inv_res.cu
    ``max_threads``): 512 where an rp x 4 tile leaves a thread within 128
    registers (rp <= 12), else 256."""
    return 512 if rp <= 12 else 256


def inv_res_regs(rp: int) -> int:
    """The register cap of a thread of the rp instantiation: 128 with
    blocks of up to 512 threads, else the hardware's 255."""
    return 128 if inv_res_threads(rp) == 512 else 255


def inv_res_smem(cin: int, cout: int, mc: int, th: int, tw: int,
                 stride: int, rp: int, pf: int, expand: bool,
                 esize: int, dilation: int = 1) -> int:
    """Shared-memory bytes of one CUDA-core inverted-residual block
    (csrc/inv_res.cu ``cc::smem_bytes``): the window [cin][rows][cols
    rounded to 4] in the compute dtype (``esize`` bytes; with pf two of
    them, their columns from 3 before the window's), each rounded to 16
    bytes; then f32: with an expand, mid [mc][window] and the chunk's
    expand weights [cin][mc rounded to 8]; the depthwise output [mc][th
    tw]; the chunk's project weights [mc][cout rounded to rp]; two buffers
    of the chunk's small weights (13 floats a mid channel); an int a
    window quad (its in-image mask). ``dilation``: the depthwise rate,
    whose halo widens the window."""
    wh, ww = inv_res_window(th, tw, stride, dilation)
    xp = wh * _r4(_IR_SHIFT * pf + ww)
    floats = ((mc * xp + cin * _cdiv(mc, _IR_RE) * _IR_RE if expand else 0)
              + mc * th * tw + mc * _cdiv(cout, rp) * rp + 2 * _IR_SMALL * mc
              + xp // 4)
    return (1 + pf) * _r16(cin * xp * esize) + 4 * floats


def inv_res_resident(nt: int, smem: int, regs: int) -> int:
    """Blocks of ``nt`` threads, ``smem`` shared bytes and ``regs``
    registers a thread that an H100 SM holds at once."""
    warps = _cdiv(nt, 32)
    per_warp = _cdiv(32 * regs, 256) * 256
    return min(_SM_SMEM // (smem + 1024), _SM_THREADS // (32 * warps),
               _SM_REGS // (warps * per_warp), 32)


def inv_res_plans(cin: int, cmid: int, cout: int, ho: int, wo: int,
                  stride: int, dtype, expand: bool, vec: bool = True,
                  dilation: int = 1):
    """Every plan a CUDA-core launch may take: an instantiated rp of
    ``dtype``, a tile th x tw (no more than twice the output's extent
    where any tile is), at most ``inv_res_threads`` threads, mc dividing
    cmid, prefetch or not (prefetch only where ``vec``: the input's rows
    allow aligned 4-value copies, and at depthwise rate 1), in 227 KB of
    shared memory. The sum order does not depend on the plan."""
    mcs = [m for m in _IR_MCS if cmid % m == 0]
    esize = torch.tensor([], dtype=dtype).element_size()
    plans = []
    for rp in INV_RES_TILES[dtype]:
        regs = inv_res_regs(rp)
        for th in _IR_HW[0]:
            for tw in _IR_HW[1]:
                nt = _cdiv(cout, rp) * (th * tw // 4)
                if nt > inv_res_threads(rp):
                    continue
                for mc in mcs:
                    for pf in (0, 1) if vec and dilation == 1 else (0,):
                        smem = inv_res_smem(cin, cout, mc, th, tw, stride,
                                            rp, pf, expand, esize, dilation)
                        if smem <= _SMEM_LIMIT:
                            plans.append(InvResPlan(
                                th, tw, mc, rp, pf, nt, smem,
                                inv_res_resident(nt, smem, regs)))
    near = [p for p in plans if _tile_ok(p.th, p.tw, ho, wo)]
    return near or plans


def inv_res_cost(plan: InvResPlan, cin: int, cmid: int, cout: int, ho: int,
                 wo: int, stride: int, batch: int, expand: bool,
                 sm_count: int, esize: int = 2, dilation: int = 1) -> float:
    """A model of a launch's time in SM cycles. Each tile's phases, chunk
    after chunk, cost the larger of their warp-instructions (all counted
    with their idle lanes) at 4 a cycle when 8 warps or more are resident
    (half a warp-instruction a cycle for each warp below that) and their
    shared-memory wavefronts at one a cycle: the expand's 8 x 4 tiles,
    32 fmaf, a quad of the window (``esize``-byte values) and 2 broadcast
    weight loads an input channel, 8 quads stored; the depthwise, ~90
    instructions and ~16 wavefronts a run of 4 outputs;
    the project's rp x 4 tiles, a quad and rp / 4 broadcasts a mid
    channel. The barriers' and the staging's latency (mostly hidden with
    prefetch) are shared by the blocks resident together; the tiles come
    in whole waves over the card. It only orders plans; the measured
    table decides the encoder's shapes."""
    th, tw, mc, rp, pf, nt, _, blocks = plan
    re = _IR_RE
    wh, ww = inv_res_window(th, tw, stride, dilation)
    xp = wh * _r4(_IR_SHIFT * pf + ww)
    warps, chunks = _cdiv(nt, 32), cmid // mc
    rate = min(4.0, 0.5 * blocks * warps)
    e_rounds = _cdiv(_cdiv(mc, re) * (xp // 4), nt) * expand
    rows = 2 if th % 2 == 0 else 1      # tile rows a depthwise item
    d_rounds = _cdiv(mc * th * (tw // 4) // rows, nt)
    instr = warps * (e_rounds * ((4 * re + 1 + re // 4) * cin + 8 * re)
                     + d_rounds * rows * (80 + 10 * stride)
                     + mc * (4 * rp + rp // 4 + 4))
    waves_smem = warps * (e_rounds * (cin * (esize + re // 4) + 4 * re)
                          + d_rounds * rows * 16 + mc * (4 + rp // 4))
    per_chunk = max(instr / rate, waves_smem)
    stage = warps * _cdiv(cin * xp // 4, nt) * (10 if pf else 30) / rate
    latency = (chunks * 3 * 300 + (300 if pf else 2000)) / blocks
    grid = batch * _cdiv(ho, th) * _cdiv(wo, tw)
    waves = _cdiv(grid, sm_count * blocks)
    return waves * blocks * (chunks * per_chunk + stage + latency)


# (cin, cmid, cout, stride, rate) -> (th, tw, mc, rp, pf): of the plans
# ``python3 segtpu_torch/kernels/inv_res_sweep.py --top 200`` times at the
# MobileNet-v2 blocks of a bf16 b8 1024x2048 batch on an H100, the one with
# the least time summed over a shape's blocks (PERF.md); the last three, the
# stride-16 blocks of an output stride 16 encoder (the 160- and 320-channel
# stage at 64x128 a frame, depthwise rate 1 then 2), timed alike by
# ``python3 segtpu_torch/kernels/aspp_probe.py --sweep 40``
_MEASURED_PLANS = {
    (32, 32, 16, 1, 1): (16, 32, 8, 8, 1),
    (16, 96, 24, 2, 1): (8, 32, 24, 4, 1),
    (24, 144, 24, 1, 1): (8, 64, 16, 12, 0),
    (24, 144, 32, 2, 1): (8, 32, 24, 4, 0),
    (32, 192, 32, 1, 1): (16, 32, 24, 8, 0),
    (32, 192, 64, 2, 1): (8, 32, 24, 8, 0),
    (64, 384, 64, 1, 1): (8, 32, 32, 8, 0),
    (64, 384, 96, 1, 1): (8, 32, 32, 12, 0),
    (96, 576, 96, 1, 1): (8, 32, 32, 12, 0),
    (96, 576, 160, 2, 1): (4, 32, 24, 20, 0),
    (160, 960, 160, 1, 1): (4, 32, 32, 20, 0),
    (160, 960, 320, 1, 1): (4, 16, 64, 20, 0),
    (96, 576, 160, 1, 1): (4, 32, 64, 20, 0),
    (160, 960, 160, 1, 2): (16, 8, 48, 12, 0),
    (160, 960, 320, 1, 2): (8, 8, 48, 20, 0),
}


def inv_res_plan(cin: int, cmid: int, cout: int, ho: int, wo: int,
                 stride: int, dtype, batch: int, expand: bool, *,
                 sm_count: int, vec: bool = True,
                 dilation: int = 1) -> InvResPlan:
    """The plan of one CUDA-core launch: for bf16, the measured plan of the
    block shape and depthwise rate (``_MEASURED_PLANS``) where there is
    one and it is among ``inv_res_plans``; otherwise the plan
    ``inv_res_cost`` rates fastest."""
    plans = inv_res_plans(cin, cmid, cout, ho, wo, stride, dtype, expand,
                          vec, dilation)
    if not plans:
        raise ValueError(f"inv_res: no plan fits for cin={cin} cmid={cmid} "
                         f"cout={cout}")
    if dtype == torch.bfloat16:
        t = _MEASURED_PLANS.get((cin, cmid, cout, stride, dilation))
        hit = [p for p in plans if p[:5] == t]
        if hit:
            return hit[0]
    esize = torch.tensor([], dtype=dtype).element_size()
    return min(plans, key=lambda p: inv_res_cost(
        p, cin, cmid, cout, ho, wo, stride, batch, expand, sm_count, esize,
        dilation))


_inv_res_plan = functools.lru_cache(maxsize=None)(inv_res_plan)


def inv_res_args(plan: InvResPlan, b: int, cin: int, cmid: int, cout: int,
                 h: int, w: int, stride: int, residual: bool,
                 bf16: bool, dilation: int = 1) -> tuple:
    """The 16 ints the C entry ``segtpu_inv_res`` takes after its eight
    pointers: the shapes, the plan's (th, tw, mc, rp, pf), the residual
    and bf16 flags, the plan's shared bytes and the depthwise rate."""
    return (b, cin, cmid, cout, h, w, stride, plan.th, plan.tw, plan.mc,
            plan.rp, plan.pf, int(residual), int(bf16), plan.smem, dilation)


def pack_inv_res(w_exp, w_proj, dtype):
    """The CUDA-core kernel's weights, (expand or None, project): the
    OIHW expand [Cmid, Cin, 1, 1] and project [Cout, Cmid, 1, 1] weights
    rounded to the compute ``dtype`` and held as f32 [Cin][Cmid] and
    [Cmid][Cout], so that each chunk's weights are contiguous rows. The
    values are the compute dtype's: the products do not change."""
    def t(wt):
        return (wt.to(dtype).float().reshape(wt.shape[0], wt.shape[1])
                .t().contiguous())
    return (None if w_exp is None else t(w_exp)), t(w_proj)


def _inv_res_geometry(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, stride,
                      residual, what):
    _check_x(x, what)
    b, cin, h, w = x.shape
    cmid = w_dw.shape[0]
    if w_exp is None:
        if cmid != cin:
            raise ValueError(f"{what}: without expand the dw width {cmid} "
                             f"must equal the input's {cin}")
    elif (tuple(w_exp.shape) != (cmid, cin, 1, 1)
          or b_exp is None or tuple(b_exp.shape) != (cmid,)):
        raise ValueError(f"{what}: expand weight must be OIHW "
                         f"{(cmid, cin, 1, 1)} with a [{cmid}] bias")
    if tuple(w_dw.shape) != (cmid, 1, 3, 3) or tuple(b_dw.shape) != (cmid,):
        raise ValueError(f"{what}: dw weight must be {(cmid, 1, 3, 3)} "
                         f"with a [{cmid}] bias, got {tuple(w_dw.shape)}")
    cout = w_proj.shape[0]
    if (tuple(w_proj.shape) != (cout, cmid, 1, 1)
            or tuple(b_proj.shape) != (cout,)):
        raise ValueError(f"{what}: project weight must be OIHW "
                         f"(Cout, {cmid}, 1, 1) with a [Cout] bias")
    if residual and (stride != 1 or cin != cout):
        raise ValueError(f"{what}: a residual needs stride 1 and Cin == Cout")
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"{what}: stride 2 needs even H, W, got {(h, w)}")
    return b, cin, cmid, cout, h, w


def _inv_res_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                   stride: int, residual: bool, dilation: int = 1):
    _, _, h, w = x.shape
    xf = x.float()
    mid = xf
    if w_exp is not None:   # f32 expand, never rounded
        mid = relu6(_dense_sum([xf], w_exp.to(x.dtype).float())
                    + b_exp.float()[:, None, None])
    d = dilation            # zero padding of the rate, taps d apart
    taps = _taps(F.pad(mid, (d, d, d, d)), 3, d, stride,
                 (h // stride, w // stride))
    d = relu6(_depthwise_sum(taps, w_dw.float())
              + b_dw.float()[:, None, None])
    d = d.to(x.dtype).float()          # the one rounding before project
    y = (_dense_sum([d], w_proj.to(x.dtype).float())
         + b_proj.float()[:, None, None])
    if residual:
        y = y + xf
    return y.to(x.dtype)


def inv_res_chw_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                      residual: bool = False, dilation: int = 1):
    """Plain PyTorch version of ``inv_res_chw`` (same signature and
    numerics)."""
    _inv_res_geometry(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, 1,
                      residual, "inv_res_chw")
    return _inv_res_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                          stride=1, residual=residual, dilation=dilation)


def inv_res_s2_chw_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj):
    """Plain PyTorch version of ``inv_res_s2_chw`` (same signature and
    numerics)."""
    _inv_res_geometry(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, 2,
                      False, "inv_res_s2_chw")
    return _inv_res_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                          stride=2, residual=False)


def _inv_res_packed(packed, w_exp, w_proj, what):
    """``packed`` (None, or (pack_weights(w_exp) or None, pack_weights(
    w_proj))) checked against the block's weights; a pair."""
    if packed is None:
        return None, None
    if len(packed) != 2:
        raise ValueError(f"{what}: packed is (expand, project), got "
                         f"{len(packed)} weights")
    pe, pp = packed
    if w_exp is None and pe is not None:
        raise ValueError(f"{what}: a packed expand weight for a block "
                         f"without an expand")
    if w_exp is not None:
        _check_packed(pe, tuple(w_exp.shape), what)
    _check_packed(pp, tuple(w_proj.shape), what)
    return pe, pp


def _inv_res_kernel_args(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                         stride, residual, what):
    """The block's geometry checked for either kernel: (b, cin, cmid,
    cout, h, w) and the f32 biases and depthwise weight on x's device."""
    geo = _inv_res_geometry(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                            stride, residual, what)
    if geo[2] % 4 or geo[3] % 4:
        raise ValueError(f"{what} kernel needs the mid and output widths "
                         f"in multiples of 4, got {geo[2]}, {geo[3]}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous x")
    dev = x.device
    return geo, tuple(_on(v, torch.float32, dev)
                      for v in (b_exp, w_dw, b_dw, b_proj))


def _check_inv_res_packed(packed, w_exp, w_proj, dev, what):
    """``packed`` (``pack_inv_res``'s pair, or None to pack for this
    call) checked against the block's weights: f32, contiguous, on x's
    device. Returns the pair."""
    if packed is None:
        return None
    if len(packed) != 2:
        raise ValueError(f"{what}: packed is (expand, project), got "
                         f"{len(packed)} weights")
    for pk, wt in zip(packed, (w_exp, w_proj)):
        if (pk is None) != (wt is None):
            raise ValueError(f"{what}: packed weights do not match the "
                             f"block's (an expand without its pair)")
        if pk is None:
            continue
        want = (wt.shape[1], wt.shape[0])
        if (tuple(pk.shape) != want or pk.dtype != torch.float32
                or pk.device != dev or not pk.is_contiguous()):
            raise ValueError(f"{what}: packed weight must be {want} f32 "
                             f"contiguous on {dev} (pack_inv_res), got "
                             f"{tuple(pk.shape)} {pk.dtype} on {pk.device}")
    return packed


@functools.lru_cache(maxsize=None)
def _inv_res_entry():
    from segtpu_torch.kernels._build import load
    fn = load("inv_res").segtpu_inv_res
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 16 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _inv_res_tc_entry():
    from segtpu_torch.kernels._build import load
    fn = load("inv_res").segtpu_inv_res_tc
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _inv_res_launch(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                    stride: int, residual: bool, what: str, tile=None,
                    packed=None, dilation: int = 1):
    """``inv_res_kernel`` (CUDA cores, bf16 or f32) on a CUDA tensor, at
    depthwise ``dilation`` 1, or 2 at stride 1; ``tile`` an ``InvResPlan``, else
    ``inv_res_plan``'s; ``packed`` ``pack_inv_res``'s weights, else
    packed for this call."""
    if dilation not in (1, 2) or (dilation == 2 and stride != 1):
        raise ValueError(f"{what} kernel runs rate 1, or rate 2 at stride "
                         f"1, not rate {dilation} at stride {stride}")
    (b, cin, cmid, cout, h, w), (be, wd, bd, bp) = _inv_res_kernel_args(
        x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, stride, residual, what)
    dev = x.device
    pe, pp = (_check_inv_res_packed(packed, w_exp, w_proj, dev, what)
              or pack_inv_res(w_exp, w_proj, x.dtype))
    if be is not None and be.data_ptr() % 16:   # read by 16-byte copies
        be = be.clone()
    vec = w % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
    plan = tile or _inv_res_plan(cin, cmid, cout, h // stride, w // stride,
                                 stride, x.dtype, b, w_exp is not None,
                                 sm_count=_sm_count(dev), vec=vec,
                                 dilation=dilation)
    out = torch.empty((b, cout, h // stride, w // stride), dtype=x.dtype,
                      device=dev)
    ints = inv_res_args(plan, b, cin, cmid, cout, h, w, stride, residual,
                        x.dtype == torch.bfloat16, dilation)
    rc = _launch(_inv_res_entry(), x, x.data_ptr(),
                 pe.data_ptr() if pe is not None else None,
                 be.data_ptr() if be is not None else None, wd.data_ptr(),
                 bd.data_ptr(), pp.data_ptr(), bp.data_ptr(), out.data_ptr(),
                 *ints)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out


def _inv_res_tc_launch(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                       stride: int, residual: bool, what: str, tile=None,
                       packed=(None, None)):
    """``inv_res_tc_kernel`` (tensor cores, bf16) on a CUDA tensor;
    ``tile`` a plan (th, tw, mc, mt, nt16), else ``inv_res_tc_plan``'s;
    ``packed`` as ``_inv_res_packed`` returns it."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the tensor-core kernel takes bf16, got "
                         f"{x.dtype}")
    (b, cin, cmid, cout, h, w), (be, wd, bd, bp) = _inv_res_kernel_args(
        x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, stride, residual, what)
    dev = x.device
    we = None if w_exp is None else _tc_operand([w_exp], packed[0], dev, what)
    wp = _tc_operand([w_proj], packed[1], dev, what)
    th, tw, mc, mt, nt16 = tile or _inv_res_tc_plan(
        cin, cmid, cout, h // stride, w // stride, stride, b,
        sm_count=_sm_count(dev))
    out = torch.empty((b, cout, h // stride, w // stride), dtype=x.dtype,
                      device=dev)
    rc = _launch(_inv_res_tc_entry(), x, x.data_ptr(),
                 we.data_ptr() if we is not None else None,
                 be.data_ptr() if be is not None else None, wd.data_ptr(),
                 bd.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
                 b, cin, cmid, cout, h, w, stride, th, tw, mc, mt, nt16,
                 int(residual), inv_res_tc_smem(cin, mc, cout, th, tw, stride))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out


def inv_res_chw(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                residual: bool = False, use_kernels: bool = True,
                packed=None, dilation: int = 1):
    """Fused stride-1 inverted residual, x [B, Cin, H, W] -> [B, Cout,
    H, W]: expand 1x1 + relu6 (skipped when ``w_exp`` is None), dw 3x3
    at rate ``dilation`` (zero padding ``dilation``) + relu6, project 1x1
    (+ x when ``residual``), BN folded into every OIHW weight. On a CUDA
    tensor this launches the CUDA-core kernel, bf16 or f32
    (``inv_res_chw.launches``; rate 1 or 2), with ``packed``
    (``pack_inv_res`` of the expand and project weights, made once by the
    weights' owner) or weights packed for the call. Calls at a rate above
    1, on either route, count in ``inv_res_chw.dilated_calls``."""
    if dilation > 1:
        inv_res_chw.dilated_calls += 1
    if _use_plain(x, use_kernels, "inv_res_chw"):
        return inv_res_chw_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                                 residual=residual, dilation=dilation)
    out = _inv_res_launch(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                          stride=1, residual=residual, what="inv_res_chw",
                          packed=packed, dilation=dilation)
    inv_res_chw.launches += 1
    return out


def inv_res_s2_chw(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                   use_kernels: bool = True, packed=None):
    """Fused stride-2 inverted residual (torch pad=1: output (i, j) reads
    input rows 2i-1..2i+1 and columns 2j-1..2j+1), x [B, Cin, H, W]
    (H, W even) -> [B, Cout, H/2, W/2]. On a CUDA tensor this launches
    the CUDA-core kernel (``inv_res_s2_chw.launches``; ``packed`` as for
    ``inv_res_chw``)."""
    if _use_plain(x, use_kernels, "inv_res_s2_chw"):
        return inv_res_s2_chw_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj,
                                    b_proj)
    out = _inv_res_launch(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                          stride=2, residual=False, what="inv_res_s2_chw",
                          packed=packed)
    inv_res_s2_chw.launches += 1
    return out


def inv_res_tc_chw(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, *,
                   stride: int = 1, residual: bool = False, packed=None):
    """``inv_res_chw`` (stride 1) or ``inv_res_s2_chw`` (stride 2) of a
    bf16 x on the tensor cores (``inv_res_tc_kernel``), which sum each
    product in their own f32 order: a few elements in a thousand one
    rounding from the twins'. No serving path calls it (the encoder's
    blocks run ``inv_res_chw``/``inv_res_s2_chw``: through 17 blocks this
    order moves arch0's masks under the slice floor, PERF.md); the smoke
    test and ``inv_res_sweep`` do. ``packed``: (``pack_weights(w_exp)`` or
    None, ``pack_weights(w_proj)``), or None to pack them for the call.
    On a CPU tensor this runs the plain twin; on a CUDA tensor it
    launches the kernel (``inv_res_tc_chw.launches``)."""
    if stride not in (1, 2):
        raise ValueError(f"inv_res_tc_chw: stride 1 or 2, got {stride}")
    what = "inv_res_tc_chw"
    pk = _inv_res_packed(packed, w_exp, w_proj, what)
    if _on_cpu(x, what):
        _inv_res_geometry(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                          stride, residual, what)
        return _inv_res_plain(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                              stride=stride, residual=residual)
    out = _inv_res_tc_launch(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj,
                             stride=stride, residual=residual, what=what,
                             packed=pk)
    inv_res_tc_chw.launches += 1
    return out


inv_res_chw.launches = 0
inv_res_chw.dilated_calls = 0
inv_res_s2_chw.launches = 0
inv_res_tc_chw.launches = 0


# ------------------------------------- tensor-core weights and plans

def _r8(v: int) -> int:
    return -(-v // 8) * 8


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def pack_weights(w, dtype=torch.bfloat16):
    """OIHW [Cout, Cin, k, k] -> [k * k, Np, Kc] in ``dtype``, Np = Cout
    and Kc = Cin rounded up to 8 and 16 with zeros: packed[t, o, c] =
    w[o, c, t // k, t % k], the bf16 kernels' B operand (one row of input
    channels per output channel and tap)."""
    cout, cin, kh, kw = w.shape
    out = torch.zeros((kh * kw, _r8(cout), _r16(cin)), dtype=dtype,
                      device=w.device)
    out[:, :cout, :cin] = w.to(dtype).permute(2, 3, 0, 1).reshape(
        kh * kw, cout, cin)
    return out


def _check_packed(packed, shape, what):
    """``packed`` is None or ``pack_weights`` of an OIHW weight of
    ``shape``: the bf16 kernels' B operand, packed once by the weights'
    owner (``models/fast_decoder.py`` folds it beside the OIHW weight)."""
    if packed is None:
        return
    cout, cin, kh, kw = shape
    want = (kh * kw, _r8(cout), _r16(cin))
    if tuple(packed.shape) != want or packed.dtype != torch.bfloat16:
        raise ValueError(f"{what}: packed weight must be {want} bf16 "
                         f"(pack_weights of {tuple(shape)}), got "
                         f"{tuple(packed.shape)} {packed.dtype}")


def _tc_operand(parts, packed, dev, what):
    """The bf16 kernels' B operand of the OIHW weight that is ``parts``
    concatenated along input channels: ``packed`` where its owner made
    it (already checked by ``_check_packed``), else packed for this
    call."""
    if packed is None:
        return pack_weights(parts[0] if len(parts) == 1
                            else torch.cat(parts, 1))
    if packed.device != dev or not packed.is_contiguous():
        raise ValueError(f"{what}: packed weight must be contiguous on {dev}")
    return packed


# ---------------------------- tensor-core inverted residuals (bf16)

_TC_WARPS = 8         # warps of an inverted-residual block (256 threads)
_TC_RAW = 32          # input channels a staged raw window holds (kRC)
_TC_ACC = 80          # most f32 project accumulators a thread holds

# (cin, cmid, cout, stride) -> (th, tw, mc, mt, nt16): the plan fastest on
# average over three runs of ``python3 -m segtpu_torch.kernels.inv_res_sweep
# --kernel tc`` at the MobileNet-v2 blocks of a bf16 b8 1024x2048 batch on an
# H100 (PERF.md)
_MEASURED_TC_TILES = {
    (32, 32, 16, 1): (8, 32, 32, 2, 1), (16, 96, 24, 2): (4, 16, 32, 1, 1),
    (24, 144, 24, 1): (8, 16, 48, 1, 2), (24, 144, 32, 2): (8, 8, 48, 1, 1),
    (32, 192, 32, 1): (8, 32, 32, 2, 2), (32, 192, 64, 2): (4, 16, 32, 1, 2),
    (64, 384, 64, 1): (8, 16, 48, 2, 2), (64, 384, 96, 1): (4, 16, 64, 1, 3),
    (96, 576, 96, 1): (8, 8, 64, 1, 3), (96, 576, 160, 2): (8, 16, 32, 2, 5),
    (160, 960, 160, 1): (8, 16, 64, 2, 5), (160, 960, 320, 1): (4, 16, 64, 2, 5),
}


def inv_res_tc_smem(cin: int, mc: int, cout: int, th: int, tw: int,
                    stride: int) -> int:
    """Shared-memory bytes of one bf16 inverted-residual block
    (csrc/inv_res.cu ``tc::layout``): two buffers of the chunk's f32
    depthwise weights and biases; f32 mid [mc][plane] (rows of the
    window's columns rounded to 4, the plane rounded to 4 mod 16) and
    bf16 d [th tw][mc + 8], the raw window [min(Cin16, 32)][rows]
    [8-aligned staged cols] over both; bf16 xt [window pixels rounded to
    16][Cin16 + 8], the chunk's expand weights [mc][Cin16 + 8] (an
    identity without an expand) and project weights [Cout16][mc + 8]."""
    wh, ww = inv_res_window(th, tw, stride)
    cin16, dp = _r16(cin), mc + 8
    plane = ((wh * _r4(ww) + 11) & ~15) + 4
    small = 4 * 2 * (_r4(9 * mc) + 2 * mc)
    mid, d = 4 * mc * plane, 2 * th * tw * dp
    raw = 2 * min(cin16, _TC_RAW) * wh * _r8(7 + ww)
    xt = 2 * _r16(wh * ww) * (cin16 + 8)
    we = 2 * mc * (cin16 + 8)
    return small + max(mid + d, raw) + xt + we + 2 * _r16(cout) * dp


def inv_res_tc_layouts(cout: int):
    """[(mt, nt16, pixels)] of the warp layouts a block of ``cout`` output
    channels can take: WN = Cout16 / (16 nt16) warps across the channels
    (1, 2, 4 or 8), 8 / WN across the tile's pixels, each mt m16 tiles."""
    c16 = _r16(cout)
    out = []
    for nt16 in range(1, 6):
        wn = c16 // (16 * nt16)
        if c16 % (16 * nt16) == 0 and wn in (1, 2, 4, 8):
            out += [(mt, nt16, 16 * mt * (_TC_WARPS // wn))
                    for mt in (1, 2) if 8 * mt * nt16 <= _TC_ACC]
    return out


def inv_res_tc_plans(cin: int, cmid: int, cout: int, ho: int, wo: int,
                     stride: int):
    """Every plan (th, tw, mc, mt, nt16) a bf16 block may launch with:
    a warp layout of ``inv_res_tc_layouts``, a tile th x tw of its pixels
    (tw a multiple of 4, no more than twice the output's extent where
    any tile is), mc a multiple of 16 up to 64 dividing cmid, in 227 KB
    of shared memory. The sum order does not depend on the plan."""
    plans = [(p // tw, tw, mc, mt, nt16)
             for mt, nt16, p in inv_res_tc_layouts(cout)
             for tw in (4, 8, 16, 32, 64) if p % tw == 0
             for mc in (16, 32, 48, 64) if cmid % mc == 0
             and inv_res_tc_smem(cin, mc, cout, p // tw, tw,
                                 stride) <= _SMEM_LIMIT]
    near = [t for t in plans if _tile_ok(t[0], t[1], ho, wo)]
    return near or plans


def inv_res_tc_plan(cin: int, cmid: int, cout: int, ho: int, wo: int,
                    stride: int, batch: int, *, sm_count: int):
    """(th, tw, mc, mt, nt16) of one bf16 inverted-residual launch: the
    measured plan of the block shape where there is one and it is among
    ``inv_res_tc_plans``; otherwise, of those plans, the first by: two
    blocks fit an SM (shared memory and 40 accumulators a thread), every
    one of the card's ``sm_count`` multiprocessors gets two blocks, the
    most pixels a tile, the least window recomputed per pixel, mc nearest
    32."""
    plans = inv_res_tc_plans(cin, cmid, cout, ho, wo, stride)
    if not plans:
        raise ValueError(f"inv_res: no tensor-core plan fits for cin={cin} "
                         f"cmid={cmid} cout={cout} at {ho}x{wo}")
    t = _MEASURED_TC_TILES.get((cin, cmid, cout, stride))
    if t is not None and t in plans:
        return t

    def key(plan):
        th, tw, mc, mt, nt16 = plan
        wh, ww = inv_res_window(th, tw, stride)
        two = (inv_res_tc_smem(cin, mc, cout, th, tw, stride) <= _TWO_BLOCKS
               and 8 * mt * nt16 <= _TC_ACC // 2)
        full = batch * _cdiv(ho, th) * _cdiv(wo, tw) >= 2 * sm_count
        return (not two, not full, -th * tw, wh * ww / (th * tw),
                abs(mc - 32), -tw)
    return min(plans, key=key)


_inv_res_tc_plan = functools.lru_cache(maxsize=None)(inv_res_tc_plan)


_PW_PIXELS = 128      # pixels of a pointwise block (csrc/pointwise.cu kTP)
_TC_GROUP = 64        # output channels a bf16 kernel accumulates at once


def pw_smem(kc: int, cins, couts) -> int:
    """Shared-memory bytes of a bf16 pointwise block (csrc/pointwise.cu
    ``layout``): stage 0's input chunk [kc][128 + 8], the weights [nw][wcols
    + 8], two intermediates [128][cmax + 8] for a chain, the output
    [no][128 + 8], all bf16."""
    ap = _PW_PIXELS + 8
    wcols = max([kc] + [_r16(c) for c in cins[1:]])
    nw = max(min(_TC_GROUP, _r16(c)) for c in couts)
    no = min(_TC_GROUP, _r16(couts[-1]))
    cmax = max((_r16(c) for c in couts[:-1]), default=0)
    inter = _PW_PIXELS * (cmax + 8) if cmax else 0
    return 2 * (kc * ap + nw * (wcols + 8) + 2 * inter + no * ap)


@functools.lru_cache(maxsize=None)
def _pw_plan(cins: tuple, couts: tuple):
    return pw_plan(cins, couts)


def pw_plan(cins, couts):
    """(kc, shared bytes) of a bf16 pointwise launch whose stages take
    ``cins`` and give ``couts`` channels: the most stage-0 channels per
    staged chunk (a multiple of 16) that leave room for two blocks per SM,
    else that fit one. The sum order does not depend on kc."""
    kp0 = _r16(cins[0])
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        for kc in range(kp0, 0, -16):
            smem = pw_smem(kc, cins, couts)
            if smem <= limit:
                return kc, smem
    raise ValueError(f"pointwise: stages {list(zip(cins, couts))} do not fit "
                     f"shared memory")


_NODE_TH, _NODE_TW = 8, 32                  # csrc/cell.cu's output tile
_NODE_PIXELS = _NODE_TH * _NODE_TW


def node_window(k: int, dil: int, kyg: int):
    """(rows, columns, staged columns) of a bf16 node window for ``kyg``
    tap rows of a k x k conv at dilation ``dil``: the staged columns start
    at an 8-aligned image column and are a multiple of 8."""
    lo = dil * (k // 2)
    sw = _NODE_TW + dil * (k - 1)
    return _NODE_TH + dil * (kyg - 1), sw, _r8((-lo) % 8 + sw)


def node_branch_smem(kind: str, cin: int, k: int, dil: int, cc: int,
                     kyg: int, n16: int) -> int:
    """Shared-memory bytes of one branch of a bf16 node (csrc/cell.cu
    ``branch_bytes``): sep, the depthwise output [256][Kc + 8], the 1x1
    weights [n16][Kc + 8], the f32 depthwise weights and biases and two
    windows of cc channels (one filling while the other is read); conv, a
    window of cc channels, its channel-innermost copy and two buffers of a
    window's weights [kyg * k][n16][cc + 8]."""
    if kind == "sep":
        kp = _r16(cin) + 8
        sh, _, swa = node_window(k, dil, k)
        return (2 * (_NODE_PIXELS * kp + n16 * kp + 2 * cc * sh * swa)
                + 4 * (_r4(cin * k * k) + _r4(cin)))
    if kind == "conv":
        sh, sw, swa = node_window(k, dil, kyg)
        return 2 * (cc * sh * swa + sh * sw * (cc + 8)
                    + 2 * kyg * k * n16 * (cc + 8))
    return 0


def _node_sums_bytes(cout: int):
    """(n16, bytes of the f32 branch-sum buffer [n16][256 + 4])."""
    n16 = _r16(min(cout, _TC_GROUP))
    return n16, 4 * n16 * (_NODE_PIXELS + 4)


def node_smem(branches, plans, cout: int) -> int:
    """Shared-memory bytes of a bf16 node launch with these plans: the
    branch that stages more runs first, over the whole of it; the branch
    sums sit at the top, beside the second branch's staging."""
    n16, sums = _node_sums_bytes(cout)
    sizes = sorted((node_branch_smem(kind, cin, k, dil, cc, kyg, n16)
                    for (kind, cin, k, dil), (cc, kyg) in zip(branches, plans)
                    if kind in ("conv", "sep")), reverse=True)
    if not sizes:
        return 0
    if len(sizes) == 1:
        return max(sizes[0], sums)
    return max(sizes[0], sizes[1] + sums)


def _node_rounds(kind: str, cin: int, k: int, cc: int, kyg: int) -> int:
    """Windows a branch stages with this plan."""
    if kind == "sep":
        return -(-cin // cc)
    if kind == "conv":
        return -(-_r16(cin) // cc) * (k // kyg)
    return 0


@functools.lru_cache(maxsize=None)
def _node_plan(branches: tuple, cout: int):
    return node_plan(branches, cout)


def node_plan(branches, cout: int):
    """([(cc, kyg)] per branch, shared bytes) of a bf16 node launch;
    ``branches`` lists (kind, cin, k, dil). A sep branch stages cc channels
    per window (a multiple of 4, or all); a conv branch a multiple of 16
    with every tap row (kyg = k), or 16 channels one tap row at a time
    (kyg = 1). Of the plans that leave room for two blocks per SM (else of
    those that fit one) the one with the fewest windows is taken. Every
    plan keeps the sum order (16 channels, tap row, tap column), so the
    plan does not change the bits."""
    cands = []
    for kind, cin, k, dil in branches:
        if kind == "sep":
            cands.append([(cc, k) for cc in range(min(cin, _TC_GROUP), 0, -1)
                          if cc % 4 == 0 or cc == cin])
        elif kind == "conv":
            cands.append([(cc, k) for cc in range(min(_r16(cin), _TC_GROUP),
                                                  0, -16)]
                         + ([(16, 1)] if k > 1 else []))
        else:
            cands.append([(0, 0)])
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        best = None
        for plans in itertools.product(*cands):
            smem = node_smem(branches, plans, cout)
            if smem > limit:
                continue
            rounds = sum(_node_rounds(kind, cin, k, cc, kyg) for
                         (kind, cin, k, _), (cc, kyg) in zip(branches, plans))
            if best is None or (rounds, -smem) < best[0]:
                best = ((rounds, -smem), list(plans), smem)
        if best is not None:
            return best[1], best[2]
    raise ValueError(f"node: branches {list(branches)} do not fit shared "
                     f"memory")


# ------------------------------------------------- decoder 1x1 products

def _pw_geometry(xs, stages, acts, what):
    """Checks the sources and stages of a 1x1 chain; returns (B, H, W,
    output channels, the stages' weight shapes)."""
    if not xs:
        raise ValueError(f"{what} needs at least one source")
    for x in xs:
        _check_x(x, what)
    b, _, h, w = xs[0].shape
    for x in xs[1:]:
        if (x.shape[0], *x.shape[2:]) != (b, h, w) or x.dtype != xs[0].dtype:
            raise ValueError(f"{what}: sources differ in batch, size or "
                             f"dtype: {tuple(x.shape)} {x.dtype}")
    if not stages or len(acts) != len(stages):
        raise ValueError(f"{what}: {len(stages)} stages, {len(acts)} acts")
    c = sum(x.shape[1] for x in xs)
    shapes = []
    for (wt, bias), act in zip(stages, acts):
        shape = _w_shape(wt)
        shapes.append(shape)
        if len(shape) != 4 or shape[1:] != (c, 1, 1):
            raise ValueError(f"{what}: stage weight must be OIHW (Cout, {c}, "
                             f"1, 1), got {shape}")
        if tuple(bias.shape) != (shape[0],):
            raise ValueError(f"{what}: bias must be [{shape[0]}], got "
                             f"{tuple(bias.shape)}")
        if act not in _ACT_CODE:
            raise ValueError(f"act is one of {sorted(_ACT_CODE)}, not {act!r}")
        c = shape[0]
    return b, h, w, c, shapes


def _w_shape(w):
    """The shape of a stage weight, or of the concatenation along input
    channels of a list of parts (a multi-source product's weights)."""
    if not isinstance(w, (list, tuple)):
        return tuple(w.shape)
    o, _, *hw = w[0].shape
    for p in w:
        if p.ndim != 4 or p.shape[0] != o or list(p.shape[2:]) != hw:
            return tuple(tuple(p.shape) for p in w)   # rejected by the caller
    return (o, sum(p.shape[1] for p in w), *hw)


def _pw_plain(xs, stages, acts):
    """The chain in the kernel's order: stage 0 over the sources'
    channels in turn, every stage rounded to the dtype."""
    dt = xs[0].dtype
    y = torch.cat([x.float() for x in xs], 1)
    for (wt, bias), act in zip(stages, acts):
        y = ACTIVATIONS[act](_dense_sum([y], wt.to(dt).float())
                             + bias.float()[:, None, None])
        y = y.to(dt).float()
    return y.to(dt)


def _pw_packed(packed, shapes, what):
    """``packed`` (None, or one ``pack_weights`` operand or None per
    stage) checked against the stages' weight shapes; a list per stage."""
    if packed is None:
        return [None] * len(shapes)
    if len(packed) != len(shapes):
        raise ValueError(f"{what}: {len(packed)} packed weights for "
                         f"{len(shapes)} stages")
    for p, shape in zip(packed, shapes):
        _check_packed(p, shape, what)
    return list(packed)


def _pw_launch(xs, stages, acts, packed, what):
    """The kernel on checked sources, stages and packed weights (a list
    from ``_pw_packed``)."""
    b, h, w, cout, shapes = _pw_geometry(xs, stages, acts, what)
    if len(xs) > 4 or len(stages) > 4 or (len(stages) > 1 and len(xs) > 1):
        raise ValueError(f"{what} kernel takes up to 4 sources for one "
                         f"stage, or one source for up to 4 stages")
    if not all(x.is_contiguous() for x in xs):
        raise ValueError(f"{what} kernel needs contiguous sources")
    dev, dt = xs[0].device, xs[0].dtype
    bf16 = dt == torch.bfloat16
    parts = [list(wt) if isinstance(wt, (list, tuple)) else [wt]
             for wt, _ in stages]
    cins = [shape[1] for shape in shapes]
    couts = [shape[0] for shape in shapes]
    for p in parts:
        if any(t.device != dev for t in p):
            raise ValueError(f"operand on {p[0].device}, x on {dev}")
    # bf16: packed for the tensor cores; f32: [cout, cin] as given
    ws = [_tc_operand(p, pk, dev, what) if bf16 else
          _on(torch.cat(p, 1).reshape(p[0].shape[0], -1), dt, dev)
          for p, pk in zip(parts, packed)]
    kc, smem = _pw_plan(tuple(cins), tuple(couts)) if bf16 else (0, 0)
    bs = [_on(bias, torch.float32, dev) for _, bias in stages]
    out = torch.empty((b, cout, h, w), dtype=dt, device=dev)
    arrays = (_ptrs(xs), _ints([x.shape[1] for x in xs]), _ptrs(ws),
              _ptrs(bs), _ints(cins), _ints(couts),
              _ints([_ACT_CODE[a] for a in acts]))
    from segtpu_torch.kernels._build import load
    fn = load("pointwise").segtpu_pointwise
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
        ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    a = [ctypes.addressof(arr) for arr in arrays]
    rc = _launch(fn, out, a[0], a[1], len(xs), a[2], a[3], a[4], a[5], a[6],
                 len(stages), out.data_ptr(), b, h * w, int(bf16), kc, smem)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out


def pw_chain_chw_plain(x, stages, *, acts=None):
    """Plain PyTorch version of ``pw_chain_chw`` (same signature, numerics
    and sum order)."""
    acts = ["relu"] * len(stages) if acts is None else list(acts)
    _pw_geometry([x], stages, acts, "pw_chain_chw")
    return _pw_plain([x], stages, acts)


def pw_chain_chw(x, stages, *, acts=None, packed=None,
                 use_kernels: bool = True):
    """x [B, C0, H, W] through 1x1 stages [(w OIHW [C_i+1, C_i, 1, 1],
    f32 bias), ...] -> [B, Cn, H, W]: each stage act(w @ y + bias) in
    f32, rounded to x's dtype (the storage rounding of running the stages
    one by one). ``acts`` per stage, default all "relu". ``packed``: per
    stage, ``pack_weights(w)`` made once by the weights' owner, or None
    (the bf16 kernel then packs w for the call). On a CUDA tensor this
    launches the kernel (``pw_chain_chw.launches``)."""
    acts = ["relu"] * len(stages) if acts is None else list(acts)
    packed = _pw_packed(packed, _pw_geometry([x], stages, acts,
                                             "pw_chain_chw")[4],
                        "pw_chain_chw")
    if _use_plain(x, use_kernels, "pw_chain_chw"):
        return pw_chain_chw_plain(x, stages, acts=acts)
    out = _pw_launch([x], stages, acts, packed, "pw_chain_chw")
    pw_chain_chw.launches += 1
    return out


def pw_multi_chw_plain(xs, ws, bias, *, act: str = "none"):
    """Plain PyTorch version of ``pw_multi_chw``."""
    stages = [(torch.cat(list(ws), 1), bias)]
    _pw_geometry(xs, stages, [act], "pw_multi_chw")
    return _pw_plain(xs, stages, [act])


def pw_multi_chw(xs, ws, bias, *, act: str = "none", packed=None,
                 use_kernels: bool = True):
    """sum_i ws[i] @ xs[i] + bias, then act: xs[i] [B, C_i, H, W] and
    ws[i] OIHW [Cout, C_i, 1, 1] -> [B, Cout, H, W], equal to a 1x1 conv
    of the concatenated sources without the concatenation (the decoder
    head). ``packed``: ``pack_weights`` of the ws concatenated along
    input channels, made once by their owner, or None. On a CUDA tensor
    this launches the kernel (``pw_multi_chw.launches``)."""
    stages = [(list(ws), bias)]
    packed = _pw_packed(None if packed is None else [packed], _pw_geometry(
        xs, stages, [act], "pw_multi_chw")[4], "pw_multi_chw")
    if _use_plain(xs[0], use_kernels, "pw_multi_chw"):
        return pw_multi_chw_plain(xs, ws, bias, act=act)
    out = _pw_launch(list(xs), stages, [act], packed, "pw_multi_chw")
    pw_multi_chw.launches += 1
    return out


pw_chain_chw.launches = 0
pw_multi_chw.launches = 0


# --------------------------------------------------- decoder cell nodes
#
# A branch is a dict: {"kind": "conv", "k", "dil", "w" (OIHW [Cout, Cin,
# k, k]), "b"}, {"kind": "sep", "k", "dil", "wdw" ([Cin, 1, k, k] f32),
# "bdw", "wpw" (OIHW [Cout, Cin, 1, 1]), "bpw"}, {"kind": "skip"} or
# {"kind": "none"}; in ``cell_op_chw`` it also names its source ("entry"),
# and {"kind": "vec", "vec": [B, Cout] f32} is a global-average-pool
# branch's vector. Conv and sep branches end in relu.

_KIND = {"none": 0, "conv": 1, "sep": 2, "skip": 3}


def _branch_check(br, x, shape, what):
    kind = br["kind"]
    if kind not in _KIND:
        raise ValueError(f"{what}: branch kind {kind!r} is not one of "
                         f"{sorted(_KIND)}")
    if kind == "none":
        return
    b, cout, h, w = shape
    _check_x(x, what)
    if (x.shape[0], *x.shape[2:]) != (b, h, w):
        raise ValueError(f"{what}: branch input {tuple(x.shape)} does not "
                         f"match the output {shape}")
    cin = x.shape[1]
    if kind == "skip":
        if cin != cout:
            raise ValueError(f"{what}: a skip branch needs {cout} channels")
        return
    k, dil = br["k"], br["dil"]
    if k not in (1, 3, 5) or dil < 1:
        raise ValueError(f"{what}: k in (1, 3, 5) and dilation >= 1, got "
                         f"{k}, {dil}")
    if kind == "conv":
        want = {"w": (cout, cin, k, k), "b": (cout,)}
    else:
        want = {"wdw": (cin, 1, k, k), "bdw": (cin,),
                "wpw": (cout, cin, 1, 1), "bpw": (cout,)}
    for name, shp in want.items():
        if tuple(br[name].shape) != shp:
            raise ValueError(f"{what}: {kind} {name} must be {shp}, got "
                             f"{tuple(br[name].shape)}")
    _check_packed(br.get("wp"), want["w" if kind == "conv" else "wpw"], what)


def _branch_plain(br, x, dt):
    """A branch's f32 value in the kernel's order (None for "none")."""
    kind = br["kind"]
    if kind == "none":
        return None
    if kind == "skip":
        return x.float()
    k, dil = br["k"], br["dil"]
    h, w = x.shape[-2:]
    lo, hi = _pads(k, dil)
    taps = _taps(F.pad(x.float(), (lo, hi, lo, hi)), k, dil, 1, (h, w))
    if kind == "conv":
        return torch.relu(_dense_sum(taps, br["w"].to(dt).float())
                          + br["b"].float()[:, None, None])
    mid = torch.relu(_depthwise_sum(taps, br["wdw"].float())
                     + br["bdw"].float()[:, None, None])
    return torch.relu(_dense_sum([mid.to(dt).float()], br["wpw"].to(dt).float())
                      + br["bpw"].float()[:, None, None])


def _node_plain(pairs, add, vec, shape, ref):
    dt = ref.dtype
    tot = None
    for br, x in pairs:
        y = _branch_plain(br, x, dt)
        if y is not None:
            tot = y if tot is None else tot + y
    if tot is None:
        tot = torch.zeros(shape, dtype=torch.float32, device=ref.device)
    if add is not None:
        tot = tot + add.float()
    if vec is not None:
        tot = tot + vec.float()[:, :, None, None]
    return tot.to(dt)


def _node_launch(pairs, add, vec, shape, dt, dev, what):
    b, cout, h, w = shape
    for _, x in pairs:
        if x is not None and (x.dtype != dt or not x.is_contiguous()
                              or x.device != dev):
            raise ValueError(f"{what} kernel needs every input contiguous "
                             f"in {dt} on {dev}")
    if add is not None and (add.dtype != dt or not add.is_contiguous()
                            or tuple(add.shape) != shape):
        raise ValueError(f"{what} kernel needs acc {shape} contiguous in {dt}")
    vk = _on(vec, torch.float32, dev)
    bf16 = dt == torch.bfloat16
    cols = {n: [] for n in ("kind", "x", "cin", "k", "dil", "w", "b", "wdw",
                            "bdw")}
    for br, x in pairs:
        kind = br["kind"]
        cols["kind"].append(_KIND[kind])
        cols["x"].append(x)
        cols["cin"].append(0 if x is None else x.shape[1])
        cols["k"].append(br.get("k", 1))
        cols["dil"].append(br.get("dil", 1))
        conv, sep = kind == "conv", kind == "sep"
        wt = br["w"] if conv else br["wpw"] if sep else None
        if wt is not None and wt.device != dev:
            raise ValueError(f"operand on {wt.device}, x on {dev}")
        # bf16: packed for the tensor cores; f32: OIHW as given
        cols["w"].append(None if wt is None else
                         _tc_operand([wt], br.get("wp"), dev, what) if bf16
                         else _on(wt, dt, dev))
        cols["b"].append(_on(br["b"] if conv else br["bpw"], torch.float32,
                             dev) if conv or sep else None)
        cols["wdw"].append(_on(br["wdw"], torch.float32, dev) if sep else None)
        cols["bdw"].append(_on(br["bdw"], torch.float32, dev) if sep else None)
    plans, smem = _node_plan(tuple(zip([br["kind"] for br, _ in pairs],
                                       cols["cin"], cols["k"], cols["dil"])),
                             cout) if bf16 else ([(0, 0)] * len(pairs), 0)
    arrays = [_ints(cols["kind"]), _ptrs(cols["x"]), _ints(cols["cin"]),
              _ints(cols["k"]), _ints(cols["dil"]), _ptrs(cols["w"]),
              _ptrs(cols["b"]), _ptrs(cols["wdw"]), _ptrs(cols["bdw"]),
              _ints([cc for cc, _ in plans]), _ints([g for _, g in plans])]
    out = torch.empty(shape, dtype=dt, device=dev)
    from segtpu_torch.kernels._build import load
    fn = load("cell").segtpu_cell_node
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 14 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = _launch(fn, out, len(pairs),
                 *[ctypes.addressof(a) for a in arrays],
                 None if add is None else add.data_ptr(),
                 None if vk is None else vk.data_ptr(), out.data_ptr(),
                 b, cout, h, w, int(bf16), smem)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
    return out


def _node(pairs, add, vec, shape, ref, plain: bool, what):
    """One node, checked, through its plain twin or the kernel."""
    for br, x in pairs:
        _branch_check(br, x, shape, what)
    if add is not None and tuple(add.shape) != shape:
        raise ValueError(f"acc must be {shape}, got {tuple(add.shape)}")
    if vec is not None and tuple(vec.shape) != shape[:2]:
        raise ValueError(f"vec_acc must be {shape[:2]}, got "
                         f"{tuple(vec.shape)}")
    if plain:
        return _node_plain(pairs, add, vec, shape, ref)
    return _node_launch(pairs, add, vec, shape, ref.dtype, ref.device, what)


def _op_branch(op, weights, packed=None):
    """('conv' | 'sep', k, dilation), its weights and its packed dense or
    1x1 weight (or None) -> a branch dict."""
    kind, k, dil = op
    if kind == "conv":
        w, b = weights
        return {"kind": "conv", "k": k, "dil": dil, "w": w, "b": b,
                "wp": packed}
    if kind == "sep":
        wdw, bdw, wpw, bpw = weights
        return {"kind": "sep", "k": k, "dil": dil, "wdw": wdw, "bdw": bdw,
                "wpw": wpw, "bpw": bpw, "wp": packed}
    raise ValueError(f"op kind is 'conv' or 'sep', not {kind!r}")


def _sep_args(x, w_dw, b_dw, w_pw, b_pw, acc, vec_acc, k, dilation,
              packed=None):
    _check_x(x, "sep_conv_chw")
    br = _op_branch(("sep", k, dilation), (w_dw, b_dw, w_pw, b_pw), packed)
    shape = (x.shape[0], w_pw.shape[0], *x.shape[2:])
    return [(br, x)], acc, vec_acc, shape


def sep_conv_chw_plain(x, w_dw, b_dw, w_pw, b_pw, acc=None, vec_acc=None, *,
                       k: int, dilation: int = 1):
    """Plain PyTorch version of ``sep_conv_chw``."""
    return _node(*_sep_args(x, w_dw, b_dw, w_pw, b_pw, acc, vec_acc, k,
                            dilation), x, True, "sep_conv_chw")


def sep_conv_chw(x, w_dw, b_dw, w_pw, b_pw, acc=None, vec_acc=None, *,
                 k: int, dilation: int = 1, packed=None,
                 use_kernels: bool = True):
    """Separable conv with BN folded: relu(pw(round(relu(dw(x) + b_dw)))
    + b_pw) (+ acc) (+ vec_acc), x [B, C, H, W] -> [B, Cout, H, W]; the
    depthwise k x k (dilation, zero padding) in f32 with f32 weights
    [C, 1, k, k], the 1x1 OIHW [Cout, C, 1, 1] in the dtype.
    ``packed``: ``pack_weights(w_pw)`` made once by the weights' owner,
    or None (the bf16 kernel then packs it for the call). On a CUDA
    tensor this launches the kernel (``sep_conv_chw.launches``)."""
    plain = _use_plain(x, use_kernels, "sep_conv_chw")
    out = _node(*_sep_args(x, w_dw, b_dw, w_pw, b_pw, acc, vec_acc, k,
                           dilation, packed), x, plain, "sep_conv_chw")
    if not plain:
        sep_conv_chw.launches += 1
    return out


def _pair_args(x1, weights1, x2, weights2, op1, op2, packed=None):
    _check_x(x1, "pair_op_chw")
    p1, p2 = (None, None) if packed is None else packed
    b1, b2 = _op_branch(op1, weights1, p1), _op_branch(op2, weights2, p2)
    cout = (weights1[0] if op1[0] == "conv" else weights1[2]).shape[0]
    return [(b1, x1), (b2, x2)], None, None, (x1.shape[0], cout,
                                              *x1.shape[2:])


def pair_op_chw_plain(x1, weights1, x2, weights2, *, op1, op2):
    """Plain PyTorch version of ``pair_op_chw``."""
    return _node(*_pair_args(x1, weights1, x2, weights2, op1, op2), x1, True,
                 "pair_op_chw")


def pair_op_chw(x1, weights1, x2, weights2, *, op1, op2, packed=None,
                use_kernels: bool = True):
    """A cell node's two branches in one kernel: op1(x1) + op2(x2), each
    op ('conv' | 'sep', k, dilation) ending in relu, summed in f32 and
    rounded once; weights (w, b) for conv, (w_dw, b_dw, w_pw, b_pw) for
    sep, as ``conv_chw``/``sep_conv_chw`` take them. ``packed``: the two
    ops' ``pack_weights`` of w (conv) or w_pw (sep), each None where the
    bf16 kernel is to pack it for the call; or None. On a CUDA tensor
    this launches the kernel (``pair_op_chw.launches``)."""
    plain = _use_plain(x1, use_kernels, "pair_op_chw")
    out = _node(*_pair_args(x1, weights1, x2, weights2, op1, op2, packed), x1,
                plain, "pair_op_chw")
    if not plain:
        pair_op_chw.launches += 1
    return out


def _cell(srcs, nodes_desc, collect, plain: bool):
    if not srcs:
        raise ValueError("cell_op_chw needs at least one source")
    _check_x(srcs[0], "cell_op_chw")
    shape = tuple(srcs[0].shape)
    for s in srcs:
        if tuple(s.shape) != shape or s.dtype != srcs[0].dtype:
            raise ValueError(f"cell_op_chw sources differ: {tuple(s.shape)}")
    entries = list(srcs)
    for branches in nodes_desc:
        pairs, vec = [], None
        for br in branches:
            if br["kind"] == "vec":
                v = br["vec"].float()
                vec = v if vec is None else vec + v
            elif br["kind"] == "none":
                pairs.append((br, None))
            else:
                if not 0 <= br["entry"] < len(entries):
                    raise ValueError(f"cell_op_chw: entry {br['entry']} "
                                     f"not yet computed")
                pairs.append((br, entries[br["entry"]]))
        if len(pairs) > 2:
            raise ValueError("cell_op_chw: a node has at most two branches "
                             "besides its vectors")
        entries.append(_node(pairs or [({"kind": "none"}, None)], None, vec,
                             shape, srcs[0], plain, "cell_op_chw"))
    if not collect or any(not 0 <= c < len(entries) for c in collect):
        raise ValueError(f"cell_op_chw: bad collect {collect}")
    ents = [entries[c] for c in collect]
    if len(ents) == 1:
        return ents[0]
    if plain:
        acc = ents[0]
        for e in ents[1:]:
            acc = (acc.float() + e.float()).to(acc.dtype)
        return acc
    if len(ents) > 8:
        raise ValueError("cell_op_chw kernel sums at most 8 outputs")
    out = torch.empty_like(ents[0])
    arr = _ptrs(ents)
    from segtpu_torch.kernels._build import load
    fn = load("cell").segtpu_cell_collect
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = _launch(fn, out, ctypes.addressof(arr), len(ents), out.data_ptr(),
                 out.numel(), int(out.dtype == torch.bfloat16))
    if rc != 0:
        raise RuntimeError(f"cell_op_chw collect launch failed: CUDA error "
                           f"{rc}")
    return out


def cell_op_chw_plain(srcs, nodes_desc, collect):
    """Plain PyTorch version of ``cell_op_chw``."""
    return _cell(srcs, nodes_desc, collect, True)


def cell_op_chw(srcs, nodes_desc, collect, *, use_kernels: bool = True):
    """The fused suffix of a decoder cell: ``srcs`` are the materialized
    entries [B, C, H, W]; each node of ``nodes_desc`` is a list of branch
    dicts (see above, each naming its source entry: srcs first, then the
    nodes in order) and appends one entry, its branch sum plus vectors
    rounded to the dtype; returns the rounded left-to-right sum of the
    ``collect`` entries. On a CUDA tensor this launches one node kernel
    per node and, for a sum of several entries, the collect kernel
    (``cell_op_chw.launches`` counts calls)."""
    plain = _use_plain(srcs[0], use_kernels, "cell_op_chw")
    out = _cell(srcs, nodes_desc, collect, plain)
    if not plain:
        cell_op_chw.launches += 1
    return out


sep_conv_chw.launches = 0
pair_op_chw.launches = 0
cell_op_chw.launches = 0
