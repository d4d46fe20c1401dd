"""Closed-loop serving of DeepLab-v3 with ASPP on MobileNet-v2 at output
stride 16 (the program's ``deeplab`` family): ``serve_closed``'s loop
(a ring of uint8 batches made on the card from the seed, ``predict_batch``
back to back with at most ``depth`` calls in flight, ``images_per_s``),
with the set-up and the check of this configuration:

* set-up: the program's ``deeplab`` family is looked up before anything
  else (a program without it fails at once); every served kernel library,
  the head's ``aspp`` with them, is built at once (one ``nvcc`` a
  source, in parallel, so a cold checkout's build stays in set-up); the
  weights come from the seed (``weights.generator``, the distributions of
  ``weights.make_weights``) by the names of ``reference/deeplabv3_mnv2``,
  and the classifier's bias is centred on a frame of the seed as
  ``weights.center_classifier`` centres it, by that reference;
* check: ``inconsistent_calls`` at 0, and the ``widest_gap`` of
  ``served.compare_masks``'s rule (the gap by which the served class's
  logit lies below the reference's best, in units of the frame's logit
  spread) against that reference, a frame at a time, on the set-up masks
  of ``check_slots`` batches drawn from the seed.

``control_checks(run)``: the same numbers with the reference's float8
e4m3 masks in the program's place (``tools/calibrate_dlv3.py``).
"""

from __future__ import annotations

import math
import os
import time

import torch

from benchmark import program, served
from benchmark.loops import serve_closed
from benchmark.reference.deeplabv3_mnv2 import (Net, exact_f32, fp8_round,
                                                from_dict, normalize,
                                                param_spec, served_logits)
from benchmark.weights import (CENTER_HW, CENTER_STREAM, generator,
                               make_frames)

FAMILY = "deeplab"
LIBRARIES = program.SERVED_LIBRARIES + ("aspp",)

window = serve_closed.window
traced = serve_closed.traced
release = serve_closed.release


def head_config(cfg: dict) -> dict:
    """The program's head config of the configuration file."""
    return {"rates": [int(r) for r in cfg["aspp_rates"]],
            "channels": int(cfg["aspp_channels"]),
            "output_stride": int(cfg["output_stride"])}


def require_family():
    """The program's deeplab family, or an error at once."""
    from segtpu_torch.models.families import FAMILIES
    if FAMILY not in FAMILIES:
        raise RuntimeError(f"the program has no {FAMILY!r} decoder family")


def build_kernels(device) -> dict:
    """``program.build_kernels`` with the head's library among them."""
    from segtpu_torch.kernels import _build
    from segtpu_torch.utils.cache import enable_compilation_cache
    os.environ.pop("SEGTPU_NO_CACHE", None)
    enable_compilation_cache(str(program.ROOT / "segtpu_torch" / "_build"))
    if torch.device(device).type != "cuda":
        return {"build_s": 0.0, "built": []}
    t0 = time.perf_counter()
    _build.build(LIBRARIES)
    return {"build_s": time.perf_counter() - t0,
            "built": sorted(_build.built())}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{state-dict name: f32 tensor on ``device``}: convolutions
    kaiming-uniform, BatchNorm not the identity, the classifier's bias
    centred (``weights.make_weights``'s distributions and streams)."""
    spec = param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    g = generator(seed, device, 0)
    uni = torch.rand(sum(sizes), generator=g, device=device)
    gau = torch.randn(sum(sizes), generator=g, device=device)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(spec, sizes):
        u, z = uni[at:at + n].view(shape), gau[at:at + n].view(shape)
        at += n
        if kind == "conv":
            out[name] = (2 * u - 1) * math.sqrt(3.0 / fan_in)
        elif kind in ("bn_scale", "bn_var"):
            out[name] = u + 0.5
        elif kind in ("bn_bias", "bn_mean", "clf_bias"):
            out[name] = 0.1 * z
        else:
            raise ValueError(f"{name}: unknown kind {kind!r}")
    center_classifier(out, cfg, seed, device)
    return out


def center_classifier(weights, cfg: dict, seed: int, device, hw=CENTER_HW):
    """The classifier's bias set to minus each class's mean logit over a
    frame of the seed (the reference, f32, on the CPU in one thread), so
    that masks hold regions of every class (``weights.center_classifier``)."""
    host = {k: v.cpu() for k, v in weights.items()}
    host["decoder.clf.b"] = torch.zeros_like(host["decoder.clf.b"])
    frame = make_frames(seed, CENTER_STREAM, 1, *hw, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            logits = Net(from_dict(host), cfg)(normalize(frame))
    finally:
        torch.set_num_threads(threads)
    weights["decoder.clf.b"] = (-logits.mean((0, 2, 3))).to(device)


def build_engine(cfg: dict, weights: dict, device):
    """The served engine over the program's deeplab model holding
    ``weights`` (checked by name)."""
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.models import create_segmenter
    model = create_segmenter(head_config(cfg), int(cfg["num_classes"]),
                             family=FAMILY, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    model = model.to(device)
    model.load_state_dict(weights, strict=True)
    return Segmenter(model, align_corners=bool(cfg.get("align_corners", True)),
                     compute_dtype=program.DTYPES[cfg["compute_dtype"]],
                     device=device)


def setup(run):
    require_family()
    t0 = time.perf_counter()
    built = build_kernels(run.device)
    t1 = time.perf_counter()
    program.init_device(run.device)
    t2 = time.perf_counter()
    run.weights = make_weights(run.cfg, run.seed, run.device)
    run.sync()
    t3 = time.perf_counter()
    run.seg = build_engine(run.cfg, run.weights, run.device)
    run.sync()
    run.note(build_s=built["build_s"], built=built["built"],
             kernels_s=t1 - t0, device_init_s=t2 - t1, weights_s=t3 - t2,
             engine_s=time.perf_counter() - t3)
    t = run.traffic
    t0 = time.perf_counter()
    n, h, w = int(t["batch"]), int(t["height"]), int(t["width"])
    run.frames = [make_frames(run.seed, 1 + s, n, h, w, run.device)
                  for s in range(int(t["ring"]))]
    t1 = time.perf_counter()
    # the first call captures the shape's program; a pass over the ring
    # gives each batch's masks, which every later call must repeat
    run.keep = [run.seg.predict_batch(f) for f in run.frames]
    run.sync()
    t2 = time.perf_counter()
    for f in run.frames:
        run.seg.predict_batch(f)
    run.sync()
    run.bad = torch.zeros((), dtype=torch.int64, device=run.device)
    run.note(frames_s=t1 - t0, capture_and_first_pass_s=t2 - t1,
             warm_pass_s=time.perf_counter() - t2)


def compare_masks(run, frames, masks, *, quant=None):
    """(widest gap, mismatch %) of uint8 masks [n, H, W] against this
    configuration's reference (``served.compare_masks``'s rule), a frame
    at a time; ``quant`` rounds the reference's own convolutions."""
    widest, wrong, total = 0.0, 0, 0
    with exact_f32(), torch.no_grad():
        for i in range(len(frames)):
            f = torch.as_tensor(frames[i:i + 1]).to(run.device)
            m = torch.as_tensor(masks[i:i + 1]).to(run.device)
            lg = served_logits(run.weights, run.cfg, f, quant=quant)
            if tuple(m.shape) != (1, *lg.shape[-2:]) or m.dtype != torch.uint8:
                return float("inf"), float("inf")
            bad = m.long() >= lg.shape[1]
            got = lg.gather(1, m.long().clamp_max(lg.shape[1] - 1)[:, None])
            gap = (lg.max(1).values - got[:, 0]) / lg.std(1).mean()
            gap = torch.where(bad, torch.inf, gap)
            widest = max(widest, float(gap.max()))
            wrong += int((lg.argmax(1) != m.long()).sum())
            total += m.numel()
            del lg
    return widest, 100.0 * wrong / max(total, 1)


def mask_checks(run, frames, masks) -> dict:
    widest, mismatch = compare_masks(run, frames, masks)
    run.note(mismatch_pct=mismatch, compared_frames=len(frames))
    return {"widest_gap": (widest, float(run.limits["widest_gap"]))}


def check(run) -> dict:
    slots = served.sample(run.seed, len(run.frames),
                          int(run.traffic["check_slots"]))
    frames = torch.cat([run.frames[s] for s in slots])
    masks = torch.cat([run.keep[s] for s in slots])
    del run.frames
    out = {"inconsistent_calls": (float(run.inconsistent_calls), 0.0)}
    out.update(mask_checks(run, frames, masks))
    return out


def control_checks(run) -> dict:
    """The check's numbers on the frames the cell compares, with the float8
    e4m3 reference's masks (every convolution's input and weight through
    ``fp8_round``) in the program's place."""
    t = run.traffic
    n, h, w = int(t["batch"]), int(t["height"]), int(t["width"])
    run.weights = make_weights(run.cfg, run.seed, run.device)
    slots = served.sample(run.seed, int(t["ring"]), int(t["check_slots"]))
    frames = torch.cat([make_frames(run.seed, 1 + s, n, h, w, run.device)
                        for s in slots])
    masks = []
    with exact_f32(), torch.no_grad():
        for i in range(len(frames)):
            lg = served_logits(run.weights, run.cfg, frames[i:i + 1],
                               quant=fp8_round)
            masks.append(lg.argmax(1).to(torch.uint8))
    return mask_checks(run, frames, torch.cat(masks))
