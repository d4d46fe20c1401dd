#!/usr/bin/env python3
"""Chip smoke test of the segtpu_torch serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card (built for sm_90a)
    python3 chip_smoke.py --profile  # also print a torch.profiler breakdown

Phases, each a hard failure (non-zero exit) when it fails:

1. build: compile every CUDA source of the path (one nvcc each, in
   parallel) from segtpu_torch/csrc into segtpu_torch/_build.
2. front: the front kernel against its plain PyTorch version at
   8x1024x2048 on the card — bf16 and f32 bit-identical.
3. tail: the upsample+argmax kernel against its plain version on seeded
   bf16 logits [8,19,256,512] -> 1024x2048, uncropped and cropped to
   1000x2000 (and f32 uncropped): masks identical on >= 99.99 % of
   pixels, every mismatch a near-tie (top-2 f32 logits within 1e-3 of
   max(|top1|, 1)).
4. slice: Segmenter for arch0, 19 classes, seeded weights with BatchNorm
   perturbed. predict_batch on 8 seeded 1024x2048 frames (the main
   path, launch counts reset just before and read just after) and
   predict on one 1000x1500 frame (the pad path, likewise): masks agree
   >= 99.9 % with the same Segmenter run with use_kernels=False on the
   card; f32 masks on a small frame agree >= 99.9 % with the CPU run;
   predict_stream gives predict's masks in order; logits are finite.
5. timing with CUDA events: each kernel, its plain version and one
   PyTorch library call computing the same function where there is
   one, and predict_batch at b8 from a device-resident batch.

Prints the kernels JSON line and the card's name and power limit, then,
last, {"ok": true, "device": {...}}. Writes chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM data sheet, f32 outside the tensor cores

N, H, W, K = 8, 1024, 2048, 19


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from segtpu_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        log = f"{lib}.log"
        if os.path.exists(log):
            for line in open(log).read().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")


def phase_front(torch):
    from segtpu_torch.kernels.front import (normalize_s2d_front,
                                            normalize_s2d_front_plain)
    g = torch.Generator(device="cuda").manual_seed(1)
    img = torch.randint(0, 256, (N, H, W, 3), generator=g, device="cuda",
                        dtype=torch.uint8)
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        got = normalize_s2d_front(img, out_dtype=dt)
        want = normalize_s2d_front_plain(img, out_dtype=dt)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (N, 12, H // 2, W // 2),
              f"front shape {tuple(got.shape)}")
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        same = torch.equal(got.view(bits), want.view(bits))
        err = (got.float() - want.float()).abs().max().item()
        print(f"[front] {dt}: bit-identical={same} max_abs_err={err}")
        check(same, f"front kernel {dt} differs from the plain version")
        res[str(dt)] = err
    return img, res["torch.bfloat16"]


def near_tie_ok(logits, out_hw, crop_hw, got, want) -> int:
    """Check every mismatched pixel is a near-tie; returns the count."""
    from segtpu_torch.kernels.upsample_argmax import interp_taps
    diff = (got != want).nonzero().cpu().numpy()
    if len(diff) == 0:
        return 0
    h, w = logits.shape[-2:]
    ho, wo = crop_hw or out_hw
    rows, rw = interp_taps(h, out_hw[0], True, ho, False)
    cols, cw = interp_taps(w, out_hw[1], True, wo, False)
    lg = logits.float().cpu().numpy().astype(np.float64)
    for b, y, x in diff[:10000]:
        v = sum(rw[i, y] * cw[j, x] * lg[b, :, rows[i, y], cols[j, x]]
                for i in range(2) for j in range(2))
        top = np.sort(v)[::-1]
        if top[0] - top[1] > 1e-3 * max(abs(top[0]), 1.0):
            fail(f"tail mismatch at {(b, y, x)} is not a near-tie: {top[:2]}")
    return len(diff)


def phase_tail(torch):
    from segtpu_torch.kernels.upsample_argmax import (upsample_argmax,
                                                      upsample_argmax_plain)
    g = torch.Generator(device="cuda").manual_seed(2)
    logits = torch.randn((N, K, H // 4, W // 4), generator=g,
                         device="cuda").to(torch.bfloat16)
    worst = 0
    cases = [(logits, None), (logits, (1000, 2000)), (logits.float(), None)]
    for x, crop in cases:
        got = upsample_argmax(x, (H, W), crop_hw=crop)
        want = upsample_argmax_plain(x, (H, W), crop_hw=crop)
        torch.cuda.synchronize()
        ho, wo = crop or (H, W)
        check(got.shape == want.shape == (N, ho, wo) and got.dtype == torch.uint8,
              f"tail shape {tuple(got.shape)}")
        rate = (got == want).float().mean().item()
        n_bad = near_tie_ok(x, (H, W), crop, got, want)
        print(f"[tail] {x.dtype} crop={crop}: agreement={rate!r} "
              f"mismatches={n_bad}")
        check(rate >= 0.9999, f"tail agreement {rate} < 99.99 %")
        worst = max(worst, (got.int() - want.int()).abs().max().item())
    return logits, worst


def make_model(torch):
    from segtpu_torch.core.layers import ConvBN
    from segtpu_torch.models import ARCHS, create_segmenter
    gen = torch.Generator().manual_seed(0)
    model = create_segmenter(ARCHS["arch0"], K, generator=gen, device="cpu")
    with torch.no_grad():     # BatchNorm that is not the identity
        for m in model.modules():
            if isinstance(m, ConvBN):
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return model


def phase_slice(torch):
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.kernels.upsample_argmax import upsample_argmax
    model = make_model(torch)
    seg = Segmenter(model, device="cuda")
    ref = Segmenter(model, device="cuda", use_kernels=False)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)

    # the main path: predict_batch at b8, counts read around it alone
    normalize_s2d_front.launches = upsample_argmax.launches = 0
    t0 = time.perf_counter()
    masks = seg.predict_batch(frames)
    cold_s = time.perf_counter() - t0
    launches = {"front": normalize_s2d_front.launches,
                "upsample_argmax": upsample_argmax.launches}
    print(f"[slice] predict_batch b8 {H}x{W}: launches={launches} "
          f"first call {cold_s:.2f} s")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    check(masks.shape == (N, H, W) and masks.dtype == np.uint8,
          f"mask shape {masks.shape} {masks.dtype}")
    check(int(masks.max()) < K, "mask class out of range")
    want = ref.predict_batch(frames)
    rate = float((masks == want).mean())
    print(f"[slice] b8 masks vs use_kernels=False: agreement={rate!r} "
          f"classes={np.bincount(masks.ravel(), minlength=K).tolist()}")
    check(rate >= 0.999, f"slice agreement {rate} < 99.9 %")

    # the pad path: 1000x1500 -> padded 1024x1504, cropped back
    one = rng.integers(0, 256, (1000, 1500, 3), dtype=np.uint8)
    normalize_s2d_front.launches = upsample_argmax.launches = 0
    m1 = seg.predict(one)
    pad_launches = {"front": normalize_s2d_front.launches,
                    "upsample_argmax": upsample_argmax.launches}
    check(all(v > 0 for v in pad_launches.values()),
          f"pad path missed a kernel: {pad_launches}")
    check(m1.shape == (1000, 1500), f"pad-path mask shape {m1.shape}")
    rate1 = float((m1 == ref.predict(one)).mean())
    print(f"[slice] predict 1000x1500: launches={pad_launches} "
          f"agreement={rate1!r}")
    check(rate1 >= 0.999, f"pad-path agreement {rate1} < 99.9 %")

    logits = seg.predict(frames[:1], return_logits=True)
    check(logits.shape == (1, K, H, W) and bool(np.isfinite(logits).all()),
          "full-resolution logits not finite or misshaped")

    # the card against the CPU, f32, small frame
    small = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    on_gpu = Segmenter(model, device="cuda",
                       compute_dtype=torch.float32).predict(small)
    on_cpu = Segmenter(model, device="cpu",
                       compute_dtype=torch.float32).predict(small)
    rate_cpu = float((on_gpu == on_cpu).mean())
    print(f"[slice] f32 2x64x128 card vs CPU: agreement={rate_cpu!r}")
    check(rate_cpu >= 0.999, f"card vs CPU agreement {rate_cpu} < 99.9 %")

    stream_in = [frames[i, :512, :1024] for i in range(3)]
    streamed = list(seg.predict_stream(stream_in))
    check(len(streamed) == 3 and all(
        np.array_equal(s, seg.predict(f)) for s, f in zip(streamed, stream_in)),
        "predict_stream differs from predict")
    print("[slice] predict_stream: 3 frames in order")
    return seg, ref, frames, launches, rate


def phase_timing(torch, img, logits, seg, ref, frames):
    import torch.nn.functional as F
    from segtpu_torch.kernels.front import (normalize_s2d_front,
                                            normalize_s2d_front_plain)
    from segtpu_torch.kernels.upsample_argmax import (upsample_argmax,
                                                      upsample_argmax_plain)
    t = {}
    t["front"] = cuda_ms(lambda: normalize_s2d_front(img), 50)
    t["front_plain"] = cuda_ms(lambda: normalize_s2d_front_plain(img), 10)
    t["tail"] = cuda_ms(lambda: upsample_argmax(logits, (H, W)), 20)
    t["tail_plain"] = cuda_ms(lambda: upsample_argmax_plain(logits, (H, W)), 5)
    t["tail_library"] = cuda_ms(lambda: F.interpolate(
        logits.float(), size=(H, W), mode="bilinear",
        align_corners=True).argmax(1), 10)
    x = torch.from_numpy(frames).cuda()
    t["slice_b8"] = cuda_ms(lambda: seg.predict_batch(x), 10)
    t["slice_b8_plain_ends"] = cuda_ms(lambda: ref.predict_batch(x), 5)
    for k, v in t.items():
        print(f"[timing] {k}: {v:.4f} ms")
    print(f"[timing] slice b8: {N * 1000.0 / t['slice_b8']:.1f} images/s "
          f"device-resident")
    return t


def bounds():
    """Least time for the card: max(bytes / HBM rate, f32 ops / peak)."""
    hp2, wp2 = H // 2, W // 2
    front_bytes = N * H * W * 3 + N * 12 * hp2 * wp2 * 2
    front_ops = N * 12 * hp2 * wp2 * 2                   # one mul, one add
    h, w = H // 4, W // 4
    tail_bytes = N * K * h * w * 2 + N * H * W
    # H pass shared by the output columns: 2 mul + 1 add per (row, input
    # column); W pass: 2 mul + 1 add per output pixel; 1 compare each
    tail_ops = N * K * H * (3 * w + 4 * W)
    out = {}
    for name, b, o in (("front", front_bytes, front_ops),
                       ("upsample_argmax", tail_bytes, tail_ops)):
        tb, to = b / HBM_BYTES_PER_S * 1e3, o / F32_FLOP_PER_S * 1e3
        out[name] = (max(tb, to), "bytes" if tb >= to else "operations")
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    try:
        import segtpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"segtpu_torch is not importable beside this script: {e}")
    # the f32 reference comparisons use full f32 (no TF32) everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    img, front_err = phase_front(torch)
    logits, tail_err = phase_tail(torch)
    seg, ref, frames, launches, _ = phase_slice(torch)
    t = phase_timing(torch, img, logits, seg, ref, frames)
    b = bounds()
    kernels = [
        {"name": "front", "route": "cuda",
         "source": "segtpu_torch/csrc/front.cu",
         "replaces": "segtpu/kernels/front.py:80",
         "launches": launches["front"], "max_abs_err": front_err,
         "ms": t["front"], "plain_ms": t["front_plain"],
         "bound_ms": b["front"][0], "bound_by": b["front"][1],
         "library_ms": None},
        {"name": "upsample_argmax", "route": "cuda",
         "source": "segtpu_torch/csrc/upsample_argmax.cu",
         "replaces": "segtpu/kernels/upsample_argmax.py:221",
         "launches": launches["upsample_argmax"], "max_abs_err": tail_err,
         "ms": t["tail"], "plain_ms": t["tail_plain"],
         "bound_ms": b["upsample_argmax"][0],
         "bound_by": b["upsample_argmax"][1],
         "library_ms": t["tail_library"]},
    ]
    if "--profile" in sys.argv[1:]:
        profile(torch, seg, frames)
    gpu = gpu_line()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "kernels": kernels, "timing_ms": t}, f,
                  indent=1)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def profile(torch, seg, frames):
    """Device time by kernel over two b8 predict_batch calls."""
    from torch.profiler import ProfilerActivity, profile as prof
    x = torch.from_numpy(frames).cuda()
    seg.predict_batch(x)
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            seg.predict_batch(x)
        torch.cuda.synchronize()
    print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


if __name__ == "__main__":
    main()
