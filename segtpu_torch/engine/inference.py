"""Serving engine: uint8 image in, uint8 mask out
(counterpart: segtpu/engine/inference.py).

For even H and W the path is

    front kernel (normalize + space-to-depth, zero-padded to the stride
    multiple) -> folded encoder (stem conv_chw, 13 inv_res_chw and 4
    inv_res_s2_chw kernels, BatchNorm folded) -> folded decoder
    (micro: pw_chain_chw, resize_chw, sep_conv_chw, cell_op_chw and the
    classifier's conv_chw or pw_multi_chw; template: conv_chw k = 1,
    resize_chw, the block ops' kernels and the same classifier) -> tail
    kernel (upsample + argmax, cropped to H x W)

as the JAX engine's Pallas branch runs ``mbv2_chw_apply`` and
``build_fast_decoder`` or ``build_fast_template_decoder``, by the
genotype's family. The port's ``deeplab`` family (DeepLab-v3's ASPP head
on an output stride 16 encoder, ``models/aspp_decoder.py``) takes the
same path: its encoder's last four blocks run ``inv_res_chw`` at stride
1 (three at depthwise rate 2), its head ``kernels.aspp.aspp_chw`` on the
tensor cores and the classifier's ``conv_chw``, and its 1/16 logits the
tail the rule picks (W-first at a 128-wide map, a 2048-wide frame). For odd H or W (the front kernel takes even
sizes) the image is normalized on the device, zero-padded to the stride
multiple, which is even, and packed by space-to-depth into the same
folded encoder: the JAX engine runs such frames through the unfolded
encoder's 3x3 stride-2 stem ("nhwc3"), which is the same function, as
``encoders.stem_s2d_kernel`` shows. The tail is the W-first
``upsample_argmax_flat`` where the decoder's width is 128 (a 512-wide
padded frame) and ``upsample_argmax`` elsewhere, the JAX engine's
``flat_tail_profitable`` rule. Compute is bf16 by default, f32
selectable; the tail's interpolation and argmax run in f32.

On a CUDA device the front, the folded encoder and decoder and the tail
run as the hand-written kernels of ``segtpu_torch.kernels``;
``use_kernels=False`` swaps in their plain PyTorch versions (the
reference run), and on the CPU the plain versions are what the wrappers
run.

``predict``, ``predict_batch`` and ``predict_stream`` run one program per
(shape bucket, ``return_logits``, staged shape), as the JAX engine does
(``Segmenter._compiled``): on a card a CUDA graph of the call
(``utils.aot.aot_graph``), replayed, whose launches are those of the
eager call in the same order; eager on the CPU and under
``SEGTPU_NO_AOT=1``. ``infer``, which the sharded modes' replicas call
from threads, runs eagerly.

Under ``utils.profiling.tracing()`` a call records its spans: the root
``segtpu.engine.predict`` with the call's request id; ``.stage`` and
``.fetch`` (host to card and back) where ``predict`` gets numpy;
``.replay`` (the static-input copy, the graph's replay and the output's
clone, or the eager call); and inside the program the four layers
``.front``, ``.encoder``, ``.decoder`` and ``.tail``, whose device
spans a graph holds as event nodes (a traced program is captured apart
from the untraced one). The deeplab family's program also holds
``.encoder.atrous`` (its four stride-16 blocks) and ``.decoder.aspp``
(the head); the NAS families' programs hold neither. ``predict_stream`` records ``.stream.stage``
and ``.stream.fetch``. Always on, a ``Segmenter`` counts its
``replays``, ``eager_calls``, ``captures`` and ``launches``: the
port's kernels the card ran for its calls (a replay adds the launches
its graph holds, a capture's own launches count only as the graph's).
"""

from __future__ import annotations

import copy
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.kernels._build import launch_count
from segtpu_torch.kernels.front import normalize_s2d_front
from segtpu_torch.kernels.upsample_argmax import (flat_tail_profitable,
                                                  upsample_argmax,
                                                  upsample_argmax_flat,
                                                  upsample_argmax_sharded)
from segtpu_torch.models.fast_decoder import (FoldedMicroDecoder,
                                              FoldedTemplateDecoder,
                                              ShardedMicroDecoder,
                                              ShardedTemplateDecoder,
                                              fold_decoder)
from segtpu_torch.models.fast_encoder import fold_encoder, mbv2_chw_sharded
from segtpu_torch.parallel.collectives import halo_exchange, per_device
from segtpu_torch.utils.aot import aot_graph
from segtpu_torch.utils.cache import enable_compilation_cache
from segtpu_torch.utils.helpers import (IMG_MEAN, IMG_SCALE, IMG_STD,
                                        resolve_device)
from segtpu_torch.utils.profiling import enabled as tracing_enabled
from segtpu_torch.utils.profiling import span

STRIDE = 32  # encoder output stride — pad-to-stride rule


def pad_to_stride(hw: Tuple[int, int], stride: int = STRIDE) -> Tuple[int, int]:
    h, w = hw
    return (-(-h // stride) * stride, -(-w // stride) * stride)


def _stage_u8(img_u8) -> Tuple[np.ndarray, bool]:
    """uint8 [..., H, W, 3] -> (contiguous [N, H, W, 3], squeeze). The
    front kernel reads the contiguous HWC bytes directly (the JAX
    engine's pair-blocked staging is a view of the same memory)."""
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim == 3:
        return img[None], True
    if img.ndim != 4 or img.shape[-1] != 3:
        raise ValueError(f"expected uint8 [H, W, 3] or [N, H, W, 3], got "
                         f"{img.shape}")
    return img, False


@functools.lru_cache(maxsize=None)
def _norm_constants(dev: torch.device):
    """(mean [3, 1, 1], std [3, 1, 1], scale []) in f32 on ``dev``, copied
    there once: a call then makes no host-to-device copy (which a CUDA
    graph's capture refuses). Made outside inference mode."""
    with torch.inference_mode(False):
        return (torch.from_numpy(IMG_MEAN).to(dev)[:, None, None],
                torch.from_numpy(IMG_STD).to(dev)[:, None, None],
                torch.tensor(IMG_SCALE, dtype=torch.float32, device=dev))


def normalize_on_device(img_u8, compute_dtype):
    """uint8 [N, H, W, 3] -> normalized [N, 3, H, W] in compute_dtype,
    the arithmetic of ``prepare_img`` in f32."""
    mean, std, scale = _norm_constants(img_u8.device)
    x = img_u8.permute(0, 3, 1, 2).float() * scale
    return ((x - mean) / std).to(compute_dtype)


class Segmenter:
    """User-facing inference API.

    >>> seg = Segmenter(model)                 # model: models.Segmenter
    >>> mask = seg.predict(img_u8)             # uint8 [H,W,3] -> uint8 [H,W]
    >>> masks = seg.predict_batch(imgs_u8)     # uint8 [N,H,W,3]

    At construction the engine folds the model's BatchNorm into the
    conv weights of its encoder and decoder, from the f32 weights, and
    keeps the folded copies on ``device``; the caller's model is left as
    it is. Entry points run on the card unless ``device="cpu"`` is
    passed.
    """

    def __init__(self, model, *, align_corners: bool = True,
                 compute_dtype=torch.bfloat16, device="cuda",
                 use_kernels: bool = True):
        if compute_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"compute_dtype is bf16 or f32, not {compute_dtype}")
        # the kernels build once per machine, where the knobs say
        enable_compilation_cache()
        self.device = resolve_device(device)
        self.align_corners = align_corners
        self.compute_dtype = compute_dtype
        self.use_kernels = use_kernels
        self.encoder = fold_encoder(model.encoder,
                                    compute_dtype).to(self.device)
        self.decoder = fold_decoder(model.decoder,
                                    compute_dtype).to(self.device)
        self.num_classes = model.num_classes
        self.family = getattr(model, "family", None)
        self._cache: Dict[Tuple, object] = {}
        self.replays = self.eager_calls = self.captures = self.launches = 0

    def replica(self, device) -> "Segmenter":
        """This engine with copies of its folded weights on ``device``
        (itself when that is its own device)."""
        device = resolve_device(device)
        # "cuda" and "cuda:0" name one card: compare where tensors land
        if torch.empty(0, device=device).device == self.encoder.stem_b.device:
            return self
        rep = copy.copy(self)
        rep.device = device
        rep._cache = {}
        rep.encoder = copy.deepcopy(self.encoder).to(device)
        rep.decoder = copy.deepcopy(self.decoder).to(device)
        return rep

    def infer(self, imgs):
        """uint8 [N, H, W, 3] tensor on the engine's device -> uint8
        mask [N, H, W] on the device (asynchronous on CUDA), eagerly."""
        n0 = launch_count()
        out = self._run(imgs, return_logits=False)
        self.eager_calls += 1
        self.launches += launch_count() - n0
        return out

    def _compiled(self, hw: Tuple[int, int], return_logits: bool,
                  staged_shape: Tuple[int, ...]):
        """The program of one (shape bucket, ``return_logits``, staged
        shape) on the engine's device (``utils.aot.aot_graph``), made on
        the first call that needs it. A graph reads the weights it was
        captured with, so its key names this engine; with tracing on it
        holds its spans' event nodes, so its key says "traced"."""
        key = (hw, return_logits, tuple(staged_shape), str(self.device))
        if tracing_enabled():
            key += ("traced",)
        if key not in self._cache:
            example = torch.zeros(staged_shape, dtype=torch.uint8,
                                  device=self.device)
            self._cache[key] = prog = aot_graph(
                functools.partial(self._run, return_logits=return_logits),
                ("Segmenter", id(self), *key), example)
            self.captures += prog.graph is not None
        return self._cache[key]

    def _call(self, imgs, return_logits: bool, request=None):
        """uint8 [N, H, W, 3] on the engine's device through its program."""
        if imgs.dtype != torch.uint8 or imgs.ndim != 4:
            raise ValueError(f"expected uint8 [N, H, W, 3], got "
                             f"{imgs.dtype} {tuple(imgs.shape)}")
        with span("segtpu.engine.replay", request):
            n0, c0 = launch_count(), self.captures
            prog = self._compiled(tuple(imgs.shape[1:3]), return_logits,
                                  tuple(imgs.shape))
            out = prog(imgs)
            issued = launch_count() - n0
            if prog.graph is None:
                self.eager_calls += 1
                self.launches += issued
            else:
                # a capture's launches only went into the graph; its
                # warm-up's ran, as do the replay's
                self.replays += 1
                captured = prog.launches if self.captures > c0 else 0
                self.launches += issued - captured + prog.launches
        return out

    @torch.inference_mode()
    def _run(self, imgs, *, return_logits: bool):
        n, h, w, _ = imgs.shape
        hp, wp = pad_to_stride((h, w))
        dev = imgs.device
        with span("segtpu.engine.front", device=dev):
            if h % 2 == 0 and w % 2 == 0:
                x12 = normalize_s2d_front(imgs, padded_hw=(hp, wp),
                                          out_dtype=self.compute_dtype,
                                          use_kernels=self.use_kernels)
            else:
                x = normalize_on_device(imgs, self.compute_dtype)
                x = F.pad(x, (0, wp - w, 0, hp - h))
                x12 = x.reshape(n, 3, hp // 2, 2, wp // 2, 2).permute(
                    0, 3, 5, 1, 2, 4).reshape(n, 12, hp // 2, wp // 2)
        with span("segtpu.engine.encoder", device=dev):
            taps = self.encoder(x12.contiguous(),
                                use_kernels=self.use_kernels)
        with span("segtpu.engine.decoder", device=dev):
            logits = self.decoder(taps, align_corners=self.align_corners,
                                  use_kernels=self.use_kernels)
        with span("segtpu.engine.tail", device=dev):
            if return_logits:
                up = resize_bilinear(logits.float(), (hp, wp),
                                     align_corners=self.align_corners)
                return up[:, :, :h, :w]
            if flat_tail_profitable(logits.shape[-1]):
                lh, lw = logits.shape[-2:]
                return upsample_argmax_flat(
                    logits.reshape(n, logits.shape[1], lh * lw), (lh, lw),
                    (hp, wp), crop_hw=(h, w),
                    align_corners=self.align_corners,
                    use_kernels=self.use_kernels)
            return upsample_argmax(logits, (hp, wp), crop_hw=(h, w),
                                   align_corners=self.align_corners,
                                   use_kernels=self.use_kernels)

    def predict(self, img_u8, *, return_logits: bool = False):
        """Single image [H, W, 3] or batch [N, H, W, 3] of uint8.

        A numpy array in gives numpy out, after the device finishes; a
        tensor in gives a tensor on the engine's device out, without
        waiting. ``return_logits`` gives f32 full-resolution logits
        [(N,) K, H, W] (bilinear, cropped) instead of the mask."""
        with span("segtpu.engine.predict"):
            if isinstance(img_u8, torch.Tensor):
                squeeze = img_u8.ndim == 3
                imgs = img_u8[None] if squeeze else img_u8
                out = self._call(imgs.to(self.device), return_logits)
                return out[0] if squeeze else out
            imgs, squeeze = _stage_u8(img_u8)
            with span("segtpu.engine.stage"):
                imgs = torch.from_numpy(imgs).to(self.device)
            out = self._call(imgs, return_logits)
            with span("segtpu.engine.fetch"):
                out = out.cpu().numpy()
            return out[0] if squeeze else out

    predict_batch = predict

    def predict_stream(self, images):
        """Yield the mask of each image (numpy) in order. On CUDA the
        host-to-device copy of frame i+1 runs on a side stream from
        pinned memory while the card computes frame i."""
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None

        def stage(im):
            """(frame on the device, its copy's event, squeeze, the pinned
            buffer, the frame's request id while tracing)."""
            with span("segtpu.engine.stream.stage") as s:
                req = None if s is None else s.request
                imgs, squeeze = _stage_u8(im)
                host = torch.from_numpy(imgs)
                if not cuda:
                    return host, None, squeeze, None, req
                host = host.pin_memory()
                with torch.cuda.stream(copy_stream):
                    dev = host.to(self.device, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(copy_stream)
                # the pinned buffer must outlive its asynchronous copy
                return dev, ready, squeeze, host, req

        def finish(out, squeeze, req):
            with span("segtpu.engine.stream.fetch", req):
                out = out.cpu().numpy()
            return out[0] if squeeze else out

        it = iter(images)
        try:
            nxt = stage(next(it))
        except StopIteration:
            return
        pending = None
        while nxt is not None:
            cur, ready, squeeze, _host, req = nxt
            try:
                nxt = stage(next(it))
            except StopIteration:
                nxt = None
            if ready is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ready)
                cur.record_stream(compute)
            out = self._call(cur, False, req)
            if pending is not None:
                yield finish(*pending)
            pending = (out, squeeze, req)
        yield finish(*pending)


class ShardedSegmenter:
    """One frame's H split over ``devices`` (counterpart:
    segtpu/engine/inference.py::build_sharded_pallas_infer).

    >>> sh = ShardedSegmenter(seg, [torch.device("cuda:0")] * 4)
    >>> masks = sh.predict(imgs_u8)            # uint8 [N, H, W, 3]

    Shard s of n runs, on ``devices[s]``: the front kernel on its H/n
    rows, the folded encoder with an overlap-discard halo exchange
    around every stage (``mbv2_chw_sharded``), the decoder, and
    ``upsample_argmax_sharded`` on its logit rows and one halo row of
    each neighbour, and returns its H/n rows of the mask. The batch is
    not split. ``devices`` may name one device several times (logical
    shards of one card, which then run one after another); the folded
    weights are copied once per distinct device.

    A micro decoder runs H-sharded (``ShardedMicroDecoder``). Without a
    global-average-pool op in the genotype its logits are the unsharded
    engine's bit for bit; a pool branch's mean is summed per shard,
    which moves near-ties. A template decoder runs as the JAX package
    runs it (``ShardedTemplateDecoder``): on the gathered taps, whole,
    once per device, each shard keeping its rows of the logits, which
    are the unsharded engine's bit for bit. The masks are the unsharded
    engine's wherever the logits are and that engine takes the H-first
    tail (a decoder 128 wide takes the W-first one, whose roundings
    differ).

    Frames are stride-32 multiples with H % (2 n) == 0. A decoder of
    neither family (the deeplab family's head, whose dilated encoder
    reaches two rows a stage) raises ``TypeError``.
    """

    def __init__(self, seg: Segmenter, devices: Sequence):
        if isinstance(seg.decoder, FoldedMicroDecoder):
            sharded = ShardedMicroDecoder
        elif isinstance(seg.decoder, FoldedTemplateDecoder):
            sharded = ShardedTemplateDecoder
        else:
            family = getattr(seg, "family", type(seg.decoder).__name__)
            raise TypeError(f"sharded serving takes the micro or template "
                            f"family, not the {family!r} family "
                            f"({type(seg.decoder).__name__})")
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("sharded inference needs at least one device")
        self.n = len(self.devices)
        self.seg = seg
        reps = per_device(self.devices, seg.replica)
        self.encoders = [r.encoder for r in reps]
        self.decoder = sharded(
            [r.decoder for r in reps], align_corners=seg.align_corners,
            use_kernels=seg.use_kernels)

    def check_shape(self, h: int, w: int):
        n = self.n
        if pad_to_stride((h, w)) != (h, w):
            raise ValueError(
                f"sharded inference needs stride-{STRIDE}-multiple "
                f"shapes, got {h}x{w} (pad on host or use mode='data')")
        if h % (2 * n):
            raise ValueError(f"H={h} must divide 2*n_shards={2 * n}")
        if (h // n) % 2 or w % 2:
            raise ValueError("sharded s2d front needs even local H and W")

    @torch.inference_mode()
    def infer_shards(self, imgs, *, return_taps: bool = False):
        """uint8 [N, H, W, 3] tensor -> the shards' uint8 mask rows
        [N, H/n, W], each on its shard's device (asynchronous on CUDA).
        ``return_taps`` gives the sharded encoder's taps instead."""
        if imgs.ndim != 4:
            raise ValueError(f"sharded inference takes [N, H, W, 3], got "
                             f"{tuple(imgs.shape)}")
        n, seg = self.n, self.seg
        _, h, w, _ = imgs.shape
        self.check_shape(h, w)
        hl = h // n
        # host spans only: a layer's shards run on several devices' streams
        with span("segtpu.engine.front"):
            x12s = [normalize_s2d_front(
                imgs[:, s * hl:(s + 1) * hl].to(dev).contiguous(),
                out_dtype=seg.compute_dtype, use_kernels=seg.use_kernels)
                for s, dev in enumerate(self.devices)]
        with span("segtpu.engine.encoder"):
            taps = mbv2_chw_sharded(self.encoders, x12s, seg.use_kernels)
        if return_taps:
            return taps
        with span("segtpu.engine.decoder"):
            logits = halo_exchange(self.decoder(taps), 1, 1)
        with span("segtpu.engine.tail"):
            return [upsample_argmax_sharded(
                x, (h, w), shard=s, n_shards=n,
                align_corners=seg.align_corners,
                use_kernels=seg.use_kernels)
                for s, x in enumerate(logits)]

    def infer(self, imgs):
        """uint8 [N, H, W, 3] tensor -> uint8 mask [N, H, W] on the first
        shard's device."""
        rows = self.infer_shards(imgs)
        return torch.cat([r.to(self.devices[0]) for r in rows], dim=1)

    def predict(self, img_u8):
        """A batch [N, H, W, 3] (or one frame [H, W, 3]) of uint8: numpy
        in gives numpy out, a tensor in gives a tensor on the first
        shard's device. Traced as ``Segmenter.predict`` is, with host
        spans of the four layers."""
        with span("segtpu.engine.predict"):
            if isinstance(img_u8, torch.Tensor):
                squeeze = img_u8.ndim == 3
                out = self.infer(img_u8[None] if squeeze else img_u8)
                return out[0] if squeeze else out
            imgs, squeeze = _stage_u8(img_u8)
            out = self.infer(torch.from_numpy(imgs))
            with span("segtpu.engine.fetch"):
                out = out.cpu().numpy()
            return out[0] if squeeze else out

    predict_batch = predict
