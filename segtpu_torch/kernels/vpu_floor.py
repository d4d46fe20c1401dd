"""The f32 floor experiment's kernels
(counterpart: scripts/exp_vpu_floor.py::_fma_kernel, ::_tap_kernel and
::_tap_kernel_roll).

``fma_peak`` and ``dw_tap_sum`` launch the CUDA kernels
(csrc/vpu_floor.cu) on a CUDA tensor, counted in their ``.launches``, and
run their plain twins (``*_plain``) on a CPU tensor.

``fma_peak`` runs ``n_acc`` independent multiply-add chains per element
and sums them; the kernel issues fused multiply-adds (the instruction
whose rate is measured) and the twin a rounded multiply and a rounded
add, so the two agree to a relative 1e-5. ``dw_tap_sum`` is the
production depthwise tap loop (``segtpu/kernels/chw_ops.py::_dw_tap_sum``)
on a halo'd flat tile; kernel and twin sum in the same order and agree
bit for bit. Its kernel streams strips of each plane through shared
memory, laid out by ``tap_plan`` (``tap_margin``, ``tap_smem``,
``tap_args``: the ints the C entry checks against its own layout);
``dw_tap_sum_v1`` launches the first-form kernel (v1) for A/B timing only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from segtpu_torch.kernels.chw_ops import _launch, _on_cpu, _plan_ints

FMA_N_ACC = (1, 2, 4, 8, 16)


def taps(k: int, dilation: int, h: int, w: int):
    """(tap index, dy, dx) triples of a k x k kernel at ``dilation``,
    row-major; taps that can never touch an h x w image are dropped
    (counterpart: segtpu/kernels/chw_ops.py::_taps)."""
    half = k // 2
    out = []
    for ky in range(k):
        for kx in range(k):
            dy, dx = dilation * (ky - half), dilation * (kx - half)
            if abs(dy) < h and abs(dx) < w:
                out.append((ky * k + kx, dy, dx))
    return out


# ------------------------------------------------------------------ fma_peak

def _fma_check(x, n_fma: int, n_acc: int):
    if x.dtype != torch.float32:
        raise ValueError(f"fma_peak takes f32, not {x.dtype}")
    if n_acc not in FMA_N_ACC or n_fma < n_acc:
        raise ValueError(f"fma_peak takes n_acc in {FMA_N_ACC} and n_fma >= "
                         f"n_acc, got n_fma={n_fma} n_acc={n_acc}")
    return n_fma // n_acc


def fma_peak_plain(x, *, n_fma: int = 256, n_acc: int = 4):
    """Plain PyTorch version of ``fma_peak``: ``acc * c + x`` rounded
    twice a step."""
    reps = _fma_check(x, n_fma, n_acc)
    accs = [x * (1.0 + 0.125 * i) for i in range(n_acc)]
    for _ in range(reps):
        accs = [a * (1.0 + 0.0625 * i) + x for i, a in enumerate(accs)]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_peak(x, *, n_fma: int = 256, n_acc: int = 4):
    """x f32 (any shape) -> f32 of the same shape: per element, ``n_acc``
    chains ``acc_i = x * (1 + 0.125 i)``, then ``n_fma // n_acc`` times
    ``acc_i = acc_i * (1 + 0.0625 i) + x``, then the sum of the chains.
    On a CUDA tensor this launches the kernel (``fma_peak.launches``)."""
    if _on_cpu(x, "fma_peak"):
        return fma_peak_plain(x, n_fma=n_fma, n_acc=n_acc)
    reps = _fma_check(x, n_fma, n_acc)
    if not x.is_contiguous():
        raise ValueError("fma_peak kernel needs a contiguous x")
    out = torch.empty_like(x)
    from segtpu_torch.kernels._build import load
    fn = load("vpu_floor").segtpu_fma_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = _launch(fn, x, x.data_ptr(), out.data_ptr(), x.numel(), n_acc, reps)
    if rc != 0:
        raise RuntimeError(f"fma_peak kernel launch failed: CUDA error {rc}")
    fma_peak.launches += 1
    return out


fma_peak.launches = 0


# ---------------------------------------------------------------- dw_tap_sum

def tap_halo(k: int, dilation: int, w: int) -> int:
    """The halo (in flat pixels) the experiment puts on each side of a
    tile: one row more than the deepest tap reaches."""
    return (dilation * (k // 2) + 1) * w


def _tap_geometry(x, wt, k: int, dilation: int, w: int, halo: int):
    if x.ndim != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"dw_tap_sum takes bf16 x [G, C, halo + P + halo], "
                         f"got {x.dtype} {tuple(x.shape)}")
    g, c, total = x.shape
    if wt.dtype != torch.float32 or wt.shape[:2] != (k * k, c) or wt.numel() != k * k * c:
        raise ValueError(f"dw_tap_sum takes f32 weights [k*k, C(, 1)] = "
                         f"[{k * k}, {c}], got {wt.dtype} {tuple(wt.shape)}")
    if wt.device != x.device:
        raise ValueError(f"weights on {wt.device}, x on {x.device}")
    p = total - 2 * halo
    tl = taps(k, dilation, 10**6, w)
    reach = max(abs(dy) for _, dy, _ in tl) * w + max(abs(dx) for _, _, dx in tl)
    if p <= 0 or p % w or halo < reach:
        raise ValueError(f"dw_tap_sum needs P = {p} > 0 a multiple of w = {w} "
                         f"and a halo {halo} >= the taps' reach {reach}")
    return g, c, p, tl


def dw_tap_sum_plain(x, wt, *, k: int, dilation: int, w: int, halo=None):
    """Plain PyTorch version of ``dw_tap_sum`` (same order, same bits)."""
    halo = tap_halo(k, dilation, w) if halo is None else halo
    _, c, p, tl = _tap_geometry(x, wt, k, dilation, w, halo)
    wt = wt.reshape(k * k, c, 1)
    col = torch.arange(p, device=x.device) % w
    acc = None
    for dx in sorted({t[2] for t in tl}):
        part = None
        for j, dy, dx_t in tl:
            if dx_t != dx:
                continue
            s = halo + dy * w + dx
            term = wt[j] * x[:, :, s:s + p].float()
            part = term if part is None else part + term
        if dx != 0:
            part = part * ((col + dx >= 0) & (col + dx < w)).float()
        acc = part if acc is None else acc + part
    return acc


# The tap kernel's layout (csrc/vpu_floor.cu dw_tap_kernel): persistent
# blocks take strips of S flat outputs of one (g, c) plane, each thread 8
# consecutive outputs; the span staged for a strip reaches tap_margin
# elements either side; two such buffers, each with the k*k f32 weights.
TAP_MAX_THREADS = 256
_SMEM_LIMIT = 227 * 1024           # opt-in shared memory per block, H100
# the (k, dilation) pairs compiled with their windows in registers: the
# vocabulary's depthwise convs (segtpu_torch/ops/layer_factory.py
# _CONV_SPECS: sep 3x3 and 5x5 at dilation 1, 3x3 at 3, 5x5 at 6) and k = 7
TAP_COMPILED = ((3, 1), (5, 1), (7, 1), (3, 3), (5, 6))
# flat outputs a strip aims at, and at for a halo of 4 rows or more, whose
# span would otherwise be mostly halo
TAP_STRIP = 4096
TAP_STRIP_DEEP = 8192


class TapPlan(NamedTuple):
    s: int           # flat outputs of a strip (a multiple of 8)
    nt: int          # threads of a block
    lo: int          # elements staged before a strip's first output
    hi: int          # elements staged after its last
    kt: int          # compiled k (0: any k, the run-time form)
    dt: int          # compiled dilation (0 with kt)
    smem: int        # shared bytes


def _r8(v: int) -> int:
    return -(-v // 8) * 8


def tap_margin(k: int, dilation: int, w: int) -> int:
    """Elements staged on each side of a strip (csrc/vpu_floor.cu
    ``tap_margin``): the kept taps' reach (the deepest rows and the
    widest kept |dx|) rounded up to 8, plus 8 for the vector reads."""
    half = k // 2
    rx = max((abs(dilation * (kx - half)) for kx in range(k)
              if abs(dilation * (kx - half)) < w), default=0)
    return _r8(dilation * half * w + rx) + 8


def tap_smem(s: int, margin: int, k: int) -> int:
    """Shared bytes of a tap block (``tap_smem``): two buffers, each the
    bf16 span ``margin + s + margin`` and the k*k f32 weights, each
    rounded up to 16 bytes."""
    return 2 * (-(-2 * (2 * margin + s) // 16) * 16 + -(-4 * k * k // 16) * 16)


@functools.lru_cache(maxsize=None)
def tap_plan(c: int, k: int, dilation: int, w: int, rows: int) -> TapPlan:
    """The layout of a tap launch on C planes of ``rows`` rows of width
    ``w``: strips of whole rows near TAP_STRIP outputs (TAP_STRIP_DEEP
    where the taps reach 4 rows or more), a multiple of 8 (a strip may end
    inside a row), at most the plane, halved until two buffers fit shared
    memory; the compiled form where (k, dilation) is in TAP_COMPILED, w is
    a multiple of 8 and every dx is kept, else the run-time form; 128
    threads at k = 7 (its 56 partial sums a thread), else 256. The sums do
    not depend on the plan. ``c`` does not change the layout: it is in the
    key so a plan names its case."""
    if not 1 <= k <= 15 or dilation < 1 or w < 1 or rows < 1 or c < 1:
        raise ValueError(f"no tap plan for C={c} k={k} dil={dilation} w={w} "
                         f"rows={rows}")
    margin = tap_margin(k, dilation, w)
    half = k // 2
    fixed = (k, dilation) in TAP_COMPILED and w % 8 == 0 \
        and dilation * half < w
    target = TAP_STRIP_DEEP if dilation * half >= 4 else TAP_STRIP
    s = min(_r8(max(1, target // w) * w), _r8(rows * w))
    while tap_smem(s, margin, k) > _SMEM_LIMIT and s > 8:
        s = _r8(s // 2)
    smem = tap_smem(s, margin, k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"a tap strip of k={k} dil={dilation} w={w} does "
                         f"not fit shared memory")
    nt = 128 if fixed and k == 7 else TAP_MAX_THREADS
    return TapPlan(s, nt, margin, margin, k if fixed else 0,
                   dilation if fixed else 0, smem)


def tap_args(plan: TapPlan, p: int, halo: int, x_ptr: int,
             out_ptr: int) -> tuple:
    """The 9 ints the C entry takes: the plan, then vin (16-byte staging
    where the halo'd plane and the halo are whole 16-byte chunks and x is
    16-byte aligned) and vout (float4 stores where P is a multiple of 4
    and the output 16-byte aligned)."""
    vin = (p + 2 * halo) % 8 == 0 and halo % 8 == 0 and x_ptr % 16 == 0
    vout = p % 4 == 0 and out_ptr % 16 == 0
    return tuple(plan) + (int(vin), int(vout))


def _entry(name: str, n_ints: int, plan: bool):
    from segtpu_torch.kernels._build import load
    fn = getattr(load("vpu_floor"), name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p] * (2 if plan else 1)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _tap_entry():
    """``segtpu_dw_tap_sum``: x, w, out, 7 ints (G, C, P, w, halo, k,
    dilation), the plan's 9 ints, the stream."""
    return _entry("segtpu_dw_tap_sum", 7, True)


@functools.lru_cache(maxsize=None)
def _tap_v1_entry():
    return _entry("segtpu_dw_tap_sum_v1", 7, False)


def _tap_launch(x, wt, k: int, dilation: int, w: int, halo: int):
    """The kernel on a checked CUDA x (csrc/vpu_floor.cu dw_tap_kernel,
    with the plan of ``tap_plan``)."""
    g, c, p, _ = _tap_geometry(x, wt, k, dilation, w, halo)
    if k > 15 or not x.is_contiguous():
        raise ValueError("dw_tap_sum kernel takes k <= 15 and a contiguous x")
    wt = wt.contiguous()
    out = torch.empty((g, c, p), dtype=torch.float32, device=x.device)
    ints = _plan_ints(tap_args(tap_plan(c, k, dilation, w, p // w), p, halo,
                               x.data_ptr(), out.data_ptr()))
    rc = _launch(_tap_entry(), x, x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                 g, c, p, w, halo, k, dilation, ctypes.addressof(ints))
    if rc != 0:
        raise RuntimeError(f"dw_tap_sum kernel launch failed: CUDA error {rc}")
    return out


def dw_tap_sum(x, wt, *, k: int, dilation: int, w: int, halo=None):
    """Depthwise tap sum over a halo'd flat tile: x bf16 [G, C, halo + P +
    halo] (rows of width ``w``), wt f32 [k*k, C] or [k*k, C, 1] -> f32
    [G, C, P] (see csrc/vpu_floor.cu). ``halo`` defaults to
    ``tap_halo(k, dilation, w)``. On a CUDA tensor this launches the
    kernel (``dw_tap_sum.launches``)."""
    if _on_cpu(x, "dw_tap_sum"):
        return dw_tap_sum_plain(x, wt, k=k, dilation=dilation, w=w, halo=halo)
    halo = tap_halo(k, dilation, w) if halo is None else halo
    out = _tap_launch(x, wt, k, dilation, w, halo)
    dw_tap_sum.launches += 1
    return out


dw_tap_sum.launches = 0


def dw_tap_sum_v1(x, wt, *, k: int, dilation: int, w: int, halo=None):
    """The first-form (v1) kernel of ``dw_tap_sum`` (csrc/vpu_floor.cu
    dw_tap_sum_v1_kernel: a thread an output, k*k scalar loads), for A/B
    timing beside the wrapper's kernel only: CUDA tensors, no launch
    count, on no path."""
    halo = tap_halo(k, dilation, w) if halo is None else halo
    g, c, p, _ = _tap_geometry(x, wt, k, dilation, w, halo)
    if x.device.type != "cuda" or not x.is_contiguous() or k > 15:
        raise ValueError("dw_tap_sum_v1 takes a contiguous CUDA x, k <= 15")
    wt = wt.contiguous()
    out = torch.empty((g, c, p), dtype=torch.float32, device=x.device)
    rc = _launch(_tap_v1_entry(), x, x.data_ptr(), wt.data_ptr(),
                 out.data_ptr(), g, c, p, w, halo, k, dilation)
    if rc != 0:
        raise RuntimeError(f"dw_tap_sum_v1 launch failed: CUDA error {rc}")
    return out
