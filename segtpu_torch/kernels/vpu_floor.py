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
bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from segtpu_torch.kernels.chw_ops import _launch, _on_cpu

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


def dw_tap_sum(x, wt, *, k: int, dilation: int, w: int, halo=None):
    """Depthwise tap sum over a halo'd flat tile: x bf16 [G, C, halo + P +
    halo] (rows of width ``w``), wt f32 [k*k, C] or [k*k, C, 1] -> f32
    [G, C, P] (see csrc/vpu_floor.cu). ``halo`` defaults to
    ``tap_halo(k, dilation, w)``. On a CUDA tensor this launches the
    kernel (``dw_tap_sum.launches``)."""
    if _on_cpu(x, "dw_tap_sum"):
        return dw_tap_sum_plain(x, wt, k=k, dilation=dilation, w=w, halo=halo)
    halo = tap_halo(k, dilation, w) if halo is None else halo
    g, c, p, _ = _tap_geometry(x, wt, k, dilation, w, halo)
    if k > 15 or not x.is_contiguous():
        raise ValueError("dw_tap_sum kernel takes k <= 15 and a contiguous x")
    wt = wt.contiguous()
    out = torch.empty((g, c, p), dtype=torch.float32, device=x.device)
    from segtpu_torch.kernels._build import load
    fn = load("vpu_floor").segtpu_dw_tap_sum
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = _launch(fn, x, x.data_ptr(), wt.data_ptr(), out.data_ptr(), g, c, p,
                 w, halo, k, dilation)
    if rc != 0:
        raise RuntimeError(f"dw_tap_sum kernel launch failed: CUDA error {rc}")
    dw_tap_sum.launches += 1
    return out


dw_tap_sum.launches = 0
