#!/usr/bin/env python3
"""Chip smoke test of the segtpu_torch serving path on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA card (built for sm_90a)
    python3 chip_smoke.py --profile  # also print torch.profiler breakdowns
    python3 chip_smoke.py --control 7  # a control: see phase_control

Phases, each a hard failure (non-zero exit) when it fails:

1. build: compile every CUDA source of the path (one nvcc each, in
   parallel) from segtpu_torch/csrc into segtpu_torch/_build.
2. front: the front kernel against its plain PyTorch version at
   8x1024x2048 on the card — bf16 and f32 bit-identical.
3. tail: the upsample+argmax kernel against its plain version on seeded
   bf16 logits [8,19,256,512] -> 1024x2048, uncropped, cropped to
   1000x2000, at align_corners False and in f32, and on one frame's
   [19,256,384] -> 1024x1536 cropped to the pad path's 1000x1500 (a
   ragged width): masks bit for bit (tail_cases). Then the H-sharded
   tail (the H-first kernel on each shard's window) and the W-first
   tail at other sizes, bf16 and f32, bit for bit (window_flat_forms:
   every shard of a split stitched, at align_corners False, an odd
   width and n = 8; the W-first tail cropped to G2's 500x498, an odd
   frame with a ragged width, 5 classes).
4. encoder: the folded arch0 encoder (seeded weights, BatchNorm
   perturbed and folded) stage by stage on the front's output for the
   seeded b8 frames: each of the 18 launches of the main path (stem
   conv_chw, 13 inv_res_chw, 4 inv_res_s2_chw, every served bf16 block
   on the CUDA cores, whose sums give the twins' bits) against its plain
   twin on the same input, bf16, bit for bit. Each block
   is also run on the tensor-core kernel (inv_res_tc_chw, which no
   serving path calls) and held to its twin at >= 99 % of output elements
   bit-identical and a worst error <= 1e-2 of max(|ref|, 1), which that
   kernel's own f32 sum order needs. The served kernel's output feeds the
   next stage. Then every stage in f32 at 2x128x256, bit for bit, and
   conv_chw's other forms (k = 1 and 2 bit for bit; the stem's and the
   tail's forms of stem_tail_probe.forms and the stem on a shard's window
   of rows, whose rows must equal the whole input's, bit for bit) and
   odd-sized blocks at small shapes, f32 and bf16 (inv_res_forms: the
   CUDA-core kernel bit for bit, the tensor-core one at the tolerance
   above; Cin 24, and a stride-2 block on a shard's rows with its 2-row
   halo, whose rows must equal the whole input's). Each launch is timed
   in turns with, for a block, the tensor-core kernel, and a cuDNN
   yardstick (F.conv2d with the folded
   weights: one call for the stem, the three-call expand/dw/project
   sequence for a block, without the activations and residual, since no
   one call computes a block), each over a ~25 ms window, and once with
   its plain twin. Each block's line prints its bound and its f32 FMA
   floor (the products as f32 multiply-adds at the measured 59.5
   TFLOP/s) without and with the expand's halo at the plan's tiles.
5. decoder: the folded arch0 decoder on the kernels' taps of seeded b8
   1024x2048 frames, every kernel call recorded and replayed against its
   plain twin (conv_chw's k = 1 calls and resize_chw's bit for bit, each
   printed with its bytes bound and its f32 FMA floor at the card's
   measured 59.5 TFLOP/s; the rest bf16 as in phase 4; a cell_op_chw call
   node by node, each
   node against the twin's node on the same entries, and the whole call
   at >= 99 % bit-identical and a worst error <= 2e-2 of max(|ref|, 1):
   the tensor-core nodes sum in another f32 order than the twins and a
   rounding apart in one node moves the next node's sums), timed with it and with the same
   function as PyTorch library calls (cuDNN convolutions, F.interpolate;
   kernel and library in turns, each over a ~25 ms window); likewise on
   genotype G2's b8 512x512 path for the kernels arch0 does not reach
   (pair_op_chw, pw_multi_chw) and the W-first tail on its logits, bf16
   and f32 bit for bit (flat_tail_checks), timed beside the H-first
   tail at the same shape (G2's conv_chw k = 1 and resize_chw calls bit
   for bit, untimed). The
   bf16 taps and logits are held against the unfolded model run in f32
   through cuDNN (worst error <= 3 % of the largest tap value, <= 5 % of
   the largest logit), the kernels' encoder taps are as close to that
   run's (mean absolute error) as the plain twins' encoder's taps, within
   ENC_TAPS_ALLOWANCE, and the kernels' masks agree with that run's at
   least as well as the plain twins' decoder's do, less 0.1 %. Then every
   decoder call in f32 at small shapes against its twin (1e-4; conv_chw
   k = 1 and resize_chw bit for bit) and its library version (1e-4 of the
   largest value), the decoder kernels' other forms at odd sizes, and
   conv_chw k = 1's and resize_chw's forms of pw_resize_probe.forms (the
   scalar and 16-byte paths, acc, vec_acc, 1-3 chain stages, 700
   channels, a row window; bf16 and f32) bit for bit. Then the template
   family: every call of template0's decoder (weights of TEMPLATE_SEED)
   on the b8 1024x2048 taps against its twin (conv_chw k = 1 and
   resize_chw bit for bit, sep_conv_chw at _compare), and the template
   forms (TEMPLATE_FORMS: each of the 11 ops in a block under both
   aggregations, with conv_chw's standalone k = 3 dense forms at
   dilations 1, 3 and 12 and a pw_multi_chw head) on 2x256x512 frames,
   bf16 and f32: every call against its twin, the masks by the slice
   rule at MASK_FLOOR["template0"], the f32 logits at 1e-4.
6. slice: Segmenter for arch0, 19 classes, seeded weights with BatchNorm
   perturbed. predict_batch on 8 seeded 1024x2048 frames (the main
   path, launch counts reset just before and read just after, each
   kernel's count checked: PATH_LAUNCHES, where the tensor-core inverted
   residual has none; the encoder's route printed) and predict on one
   1000x1500
   frame (the pad path, likewise) and on one 999x1501 frame (odd: no
   front kernel, the padded frame packed by space-to-depth on the
   device): masks against the same Segmenter run with use_kernels=False
   on the card: >= 99.6 % of pixels equal (arch0's chained tensor-core
   nodes; measured 99.66-99.74 %), and every pixel that differs a
   near-tie of the plain run's logits (top-2 within 2e-2 of
   max(|top1|, 1));
   f32 masks on a small frame agree >= 99.9 % with the CPU run;
   predict_stream gives predict's masks in order; logits are finite.
   Then G2's path, predict_batch on 8 frames of 512x512 (G2_LAUNCHES,
   masks >= 99.9 % equal, every pixel that differs a near-tie): the launches of pair_op_chw, pw_multi_chw and
   upsample_argmax_flat are read there. Then template0's path (the WACV
   template family): predict_batch on the 8 1024x2048 frames, counts
   reset and read around it (TEMPLATE_LAUNCHES), masks against its
   use_kernels=False run at MASK_FLOOR["template0"] with every mismatch
   a near-tie, and f32 masks on a small frame >= 99.9 % equal to the
   CPU run's.
7. timing with CUDA events: each kernel, its plain version and one
   PyTorch library call computing the same function where there is
   one, and predict_batch at b8 from a device-resident batch (arch0's
   and template0's, printed with the card's name and power limit;
   template0's space call in phase 8). The
   encoder serves every block on the CUDA-core kernel (the slice masks
   fall under MASK_FLOOR with any block shape on the tensor cores): the
   engine is also run with the blocks of one shape at a time on the
   tensor-core kernel (on_tensor_cores), then all of them, its masks
   against the plain twins' printed, and the last timed. The stem's and
   the tail's timing lines print their bounds (the stem's bytes bound and
   its f32 FMA floor).

8. sharded: four logical shards on the one card (devices = [cuda:0] * 4,
   run one after another). upsample_argmax_sharded on the tail phase's
   logits, every shard at n = 2, 4, 8, bf16 and f32: bit-identical to its
   plain twin and to the unsharded kernel's rows. make_sharded_infer_fn
   mode="space", n = 4, on the slice phase's model and b8 1024x2048
   frames (the sharded path: counts reset just before, read just after,
   SPACE_LAUNCHES): masks >= 99.9 % equal to the unsharded engine's
   (arch0's pool branch sums its mean per shard), encoder taps
   bit-equal, each shard's stem launch (its rows and the halo row above)
   bit for bit its twin and the unsharded stem's rows, and so with every
   block on the tensor cores (taps and the data mode's masks). Every kernel call of the sharded decoder on that path
   (quarter-height windows with their halos, resize_chw's row-window
   form) is recorded and replayed against its plain twin as in phase 5,
   and the whole sharded call is run again on the plain twins
   (use_kernels=False): each shard's logits within 2 % of the largest of
   the twins' (bit-identical share and worst error printed), masks held
   by the slice rule. arch2 and a pool-free arch0 (whose first decoder
   block computes whole at n = 4) at 2x512x1024 (arch2 also at n = 2):
   masks bit-equal to the unsharded engine's. mode="data", 4 parts of the
   b8 batch: masks bit-equal, DATA_LAUNCHES. Times with CUDA events: the
   sharded tail per shard and summed (beside a quarter of the unsharded
   tail), one space call and one data call beside the unsharded call.
   template0 (its decoder runs whole on the gathered taps, as the JAX
   package runs the template family sharded): the space call at n = 4
   on the b8 frames (TEMPLATE_SPACE_LAUNCHES) and at 2x512x1024 with n =
   2 and 4, and mode="data" (TEMPLATE_DATA_LAUNCHES): masks bit-equal to
   the unsharded engine's (both take the H-first tail at these widths),
   every decoder call of the space call against its twin and its logit
   rows the unsharded decoder's bit for bit; its space and data calls
   timed.

9. experiments: the four ported TPU experiments (segtpu_torch.scripts:
   exp_vpu_floor, exp_front_kernel, ab_normalize, exp_tail_flat), each
   run once through its run() at its default sizes with the launch counts
   reset just before and read just after (EXPERIMENT_KERNELS: each of its
   kernels launched, no serving kernel of another script's); the runs of
   exp_vpu_floor and exp_tail_flat time every tap and roll case and the
   fused tail's case in turns with the kernel's v1 form (kept for the
   A/B only), its twin and a PyTorch library yardstick, beside each
   case's bound. Then each of their five kernels against its plain twin
   at the scripts' shapes: fma_peak at every (n_fma, n_acc) of the peak
   cases (rel 1e-5: the kernel fuses the multiply-add, the twin rounds
   twice), the two front variants on the 8x1024x2048 batch, bit-identical;
   dw_tap_sum bit for bit at every tap and roll case and at the chip forms
   (tap_checks: C = 1, k = 9 and 15, rows that end inside a strip, w = 8,
   a sign form whose column-0 outputs are zeros signed by the wrapped
   read), and the fused classifier tail bit for bit on the b8 48-channel
   256x512 features and at its forms (clf_tail_checks: K = 1, 3, 21, 150;
   C = 8, 64; 1000x2000; 720x1280; w = 8; B = 1), every form also timed
   as the cases are (exp_vpu_floor forms, exp_tail_flat.run_forms); each
   kernel's row timed with its twin and, for the tap loop and the tail, a
   PyTorch library yardstick and the v1 kernel.

10. train: proxy training on the port (segtpu_torch.engine.trainer), arch0
   at full width with aux heads as run_training builds it (weight seed
   TRAIN_SEED), TrainConfig's defaults (enc_lr 1e-3, dec_lr 3e-3, enc_wd
   1e-5, dec_wd 0, clips 3, aux_weight 0.15, Polyak), on its 16x512x512
   crop of seeded f32 normal images and K-class labels with a band of
   255. (1) One make_train_step on the card and on the CPU (PyTorch's own
   convolutions) from the same weights on 2 of the images, TF32 off: the
   loss within 1e-4, each group's gradient norm within 1e-3 or
   NORM_SPREAD x the CPU's own spread under a one-rounding move of the
   images, every updated parameter and BatchNorm running stat within 1e-4
   of max(|leaf|, 1). (2) 2 warm-up and 10 timed steps
   with CUDA events on the device-resident batch, TF32 off and at
   PyTorch's defaults (cuDNN TF32 on), each from the seeded weights: ms a
   step, images/s, peak memory, every loss finite and the last below the
   first, no serving kernel launched. (3) Stage 1: the encoder's taps
   cached (make_encoder_cache_fn), 2 + 5 timed make_decoder_train_step
   steps: the loss falls, the encoder's parameters and stats untouched.
   (4) make_eval_step and validate over the batch's two halves: the
   confusion matrices count every valid label, the mIoU is finite. (5)
   The hand-off: the trained state's Polyak weights and live BatchNorm
   stats served by the engine at b8 1024x2048 bf16 (the slice phase's
   frames): PATH_LAUNCHES, every decoder call against its twin as in
   phase 5, the masks against use_kernels=False by the near-tie rule
   (agreement printed; no floor). The control trains the same state and
   adds the hand-off's decoder calls to the checks that must fail.
11. search: the NAS search (segtpu_torch.search.run_search) at the
   published widths (MobileNet-v2 1.0, agg_size 48, the controller's
   LSTM hidden and embedding 100), 21 classes (PASCAL VOC), 512x512
   crops, SearchConfig's batch sizes (8, 8) and epochs (5, 1), cut to
   SyntheticDataset(n=32) (the repository's one dataset, phase 12's, is
   5 classes of 64x64 images, not 21 at 512x512), 3
   iterations of cvpr/PPO, then one resumed iteration, then 2 of
   wacv/REINFORCE: every record "ok" with a finite reward in [0, 1] and
   a genotype of the controller's family, controller.npz written, the
   resume continuing at step 3 with the first three records kept;
   seconds an iteration, stage 1 and stage 2 ms a step, the encoder
   cache's ms (search._cache_taps over the meta-train crops, after a
   warm-up pass), peak memory, whether native_io loaded. The controller
   (micro spec, after two PPO updates on the CPU) against its CPU twin on
   the same weights: evaluate's log-probs and entropies on the card's
   samples within 1e-5, one PPO update's parameters within 1e-3 of the
   CPU's own move, Adam's moments within 1e-4 of each leaf's max, the
   baseline within 1e-7 (CTRL_TOL). The CLI in process: search
   --synthetic --num-iters 1 at 512x512, train --synthetic --num-epochs 1
   at 128x128, and infer on a seeded 1024x2048 .npy frame with a torch
   checkpoint of make_model's arch0: PATH_LAUNCHES, and the mask bit-equal
   to engine.Segmenter.predict on the same weights. The search
   reproduces its rewards (run_search, run_supernet_search and
   run_fleet_search run under deterministic algorithms,
   segtpu_torch.utils.helpers.deterministic): 2 iterations of cvpr/PPO
   as a library call in two fresh processes started together (without
   CUBLAS_WORKSPACE_CONFIG, which run_search sets), then twice in this
   process: each pair's rewards equal; the same pair at PyTorch's default
   algorithms (run_search.__wrapped__) prints its spread and both pairs'
   seconds.
12. supernet: the population search (segtpu_torch.supernet, the mesh's
   population steps, parallel.fleet) at the settings of the repo's
   recorded supernet search (artifacts/search_v2/summary.json "proxy":
   population 8, 64x64 crops, batch (8, 8), epochs (16, 0)) on its
   dataset (artifacts/search_v2/data, 24 train images, 5 classes, its
   PNGs read by read_png), agg_size 48, 3 blocks, 3 cell nodes, cut to 3
   rounds of cvpr/PPO, then 2 of wacv/REINFORCE at population 4
   (SUPERNET_CUTS): seconds a round, stage-1 ms a population step, peak
   memory. Checks: (a) K x rounds records, "mode" supernet, rewards in
   [0, 1], the snapshot at step K x rounds with the last record's
   baseline; (b) one vectorised K = 8 population step against the 8
   samples' sequential steps (make_sequential_train_step), TF32 off, and
   (c) the step and eval on make_mesh(4, 1) of the one card against the
   unsharded ones: losses and every state leaf within POP_TOL of
   max(|leaf|, POP_FLOOR), confusion matrices within CM_SHARE of their
   sum; (d) one round of run_fleet_search on [cuda:0] * 4 at
   FLEET_EPOCHS against search.proxy_train one genotype after another,
   run twice (the card against itself printed), both under
   deterministic algorithms, rewards within FLEET_TOL (0: equal); (e)
   measure_proxy_fidelity on tests/test_supernet.py's real and
   degenerate genotypes at its config: both proxies rank the real one
   first, rho 1; (f) the wacv/REINFORCE search run twice from its seed:
   the rewards equal. Then the CLI: search --synthetic --supernet 8 and
   --fleet, one round each, and --supernet 8 --pop-devices 4, which must
   raise make_mesh's ValueError on fewer than four cards.
   (d)'s deterministic algorithms are torch.use_deterministic_algorithms
   and cuDNN's (CUBLAS_WORKSPACE_CONFIG set when main starts); it also
   runs the sequential pair twice with PyTorch's default algorithms and
   prints both pairs' spreads and times (a measurement, not a check).
13. data_parallel: phase train's configuration (arch0 with aux heads,
   b16 512x512, TF32 off) with more ignored pixels in the first shard's
   images. The sharded train step (parallel.make_sharded_train_step) on
   make_mesh(2, 1) of the one card (two logical shards, a thread each,
   meeting at every train BatchNorm) against the unsharded step on the
   whole batch, by tests/test_torch_data_parallel.py's rule: the loss at
   rel 2e-4; by group the parameters, traces, Polyak averages and
   running stats within max(floor x the unsharded step's move, 4 x its
   own spread on the batch reversed). The sharded eval's confusion
   matrix equal to the unsharded one's. run_training with data_parallel
   for an epoch of SyntheticDataset(n=32) on the one card (unsharded,
   as the JAX package on one device) against the run without it: the
   same step count and each loss within 1e-4; and with data_parallel
   over devices=[cuda:0] * 2 (the branch several cards take: the sharded
   step on make_mesh(2, 1)) against the run without it: the sharded
   step built once, the same step count and each loss within rel 2e-4.
   The ms of a sharded and an unsharded step.
14. fidelity: main_search fidelity --device cuda (the f32 engine, every
   served kernel's f32 route) on a torch checkpoint of make_model's
   arch0 (BatchNorm perturbed, 19 classes) against a golden made by the
   unfolded model in f32 on the CPU (normalize, pad, forward, bilinear
   with align_corners, crop), at the drill's 56x72 and at 1024x2048,
   each held to --max-dlogit 1e-3; each worst max|dlogit| printed.
15. space: the space axis of sharded training (core/bands.py: each shard
   a band of rows of every activation, the ops that read across rows
   meeting the shards of their data row) on logical shards of the card:
   phase data_parallel's step and rule on (1, 2) and (2, 2) meshes at
   its b16 512x512 batch, and one step of 2 frames of 1024x2048 on
   (1, 4), each against the unsharded step on the whole batch (the
   unsharded step's own spread the larger of its run on the batch
   reversed and on the images one rounding up); the sharded eval on
   (2, 2) equal to the unsharded one; the (1, 2) step with zero halos
   (every band reading zeros past its cuts), which must fail the rule.
   The ms of each step against the unsharded step's, and the peak memory
   of each (every shard on the one card: not a shard's own).

Prints the kernels JSON line (each row also with its launches on
template0's path) and the card's name and power limit, then, last,
{"ok": true, "device": {...}}. Writes chiprun_out/chip_smoke.json.

--control BITS runs a control instead of the phases: the outputs of the
node, 1x1 and inverted-residual kernels (cell.cu's node_tc_kernel and
node_kernel, pointwise.cu's pw_tc_kernel and pointwise_kernel,
inv_res.cu's inv_res_tc_kernel and inv_res_kernel), of conv_chw's dense
forms (k = 1, the stem's k = 2, k = 3 and 5) and of resize_chw, bf16 and
f32, rounded once more, to BITS significant bits, and the input of the
tail kernels' launches (H-first, H-sharded, W-first) likewise, and the
checks that hold those kernels at a tolerance (phase 4's 17 tensor-core
block stages, phase 5's calls, encoder taps and f32 reference, phase 6's
arch0, G2 and template0 masks, phase 8's shard logits, the template
forms' masks and f32 logits) or bit for bit (conv_chw k = 1 and
resize_chw at every launch of phase 5's main, G2, template0 and f32
paths, the forms, phase 8's sharded decoders of arch0 and template0 and
the template forms; the stem and the 17 served blocks at phase 4's b8
and f32 launches, their forms and windows, phase 8's four shard stems;
the tail's phase 3 cases and forms, window_flat_forms, G2's flat tail in
bf16 and f32 on G2's logits made before the rounding, and phase 8's
unsharded rows; the decoder calls of phase 10's hand-off; phase 9's
dw_tap_sum cases and forms, its output rounded likewise, and the fused
classifier tail's, the last byte of its mask with its low bit flipped)
run on it. Phase 11's checks join them: the controller's card values
(log-probs, entropies, the update's parameters, Adam's moments and the
baseline) rounded likewise before they are held to the CPU's, and the
CLI's infer run under the rounding against the engine's predict run
without it. Phase 12's (a)-(e) join them (supernet_control): (a) on one
round of each run with the snapshot's baseline rounded, (b) and (c) with
the vectorised and the sharded step's outputs rounded, (d) with the
fleet's workers training from the next worker's seed, (e) with the
supernet's masks rolled to the other genotype. Phase 13's four join
them: the sharded step under ghost BN (each shard normalizing by its own
moments), the sharded eval with every shard on the first shard's rows,
run_training's one-card data_parallel run from the next seed (a control
that any code fails: it shows only that the check reads the losses),
its run over two logical shards under ghost BN; phase 14's two, on the
checkpoint of the next seed; phase 11's and 12's reproducibility checks
with each pair's second run from the next seed (a control that any code
fails: it shows that the checks read the rewards); and phase 15's three
steps and its eval under zero halos.
The checks that hold kernels against kernels (sharded or data mode
against the unsharded engine) and phase 10's card against the CPU are
not in it: the rounding moves both sides alike.
It prints how many fail and exits 0 when every one of them fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

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


def tail_cases(torch, logits):
    """[(what, fn(use_kernels))]: phase 3's tail calls on the seeded
    logits: uncropped, cropped to 1000x2000, at align_corners False, in
    f32, and the pad path's 1000x1500 crop of a 1024x1536 grid (a ragged
    width: the scalar store path)."""
    from segtpu_torch.kernels.upsample_argmax import upsample_argmax
    pad = logits[:1, :, :, :W // 4 * 3 // 4].contiguous()   # 256 x 384
    cases = [("bf16", logits, (H, W), None, True),
             ("bf16 crop", logits, (H, W), (H - 24, W - 48), True),
             ("bf16 align_corners=False", logits, (H, W), None, False),
             ("f32", logits.float(), (H, W), None, True),
             ("bf16 pad crop", pad, (H, W * 3 // 4), (H - 24, W * 3 // 4 - 36),
              True)]
    return [(f"tail {what} {tuple(x.shape)} -> {grid} crop={crop}",
             lambda uk, x=x, grid=grid, crop=crop, ac=ac: upsample_argmax(
                 x, grid, crop_hw=crop, align_corners=ac, use_kernels=uk))
            for what, x, grid, crop, ac in cases]


def window_flat_forms(torch):
    """[(what, fn(use_kernels))]: the H-sharded tail's and the W-first
    tail's forms at other sizes, bf16 and f32. The sharded tail's is
    every shard of an n-way split (windows from halo_exchange), stitched:
    at align_corners False, at an odd width (the scalar load and store
    paths), and at n = 8 (three logit rows a shard at 24 rows); the
    W-first tail's: G2's shape cropped to 500x498 (a width that is not a
    multiple of 4: the scalar store), an odd frame cropped to a ragged
    width at align_corners False, and 5 classes uncropped."""
    from segtpu_torch.kernels.upsample_argmax import (upsample_argmax_flat,
                                                      upsample_argmax_sharded)
    from segtpu_torch.parallel import halo_exchange
    g = torch.Generator(device="cuda").manual_seed(12)
    out = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for shape, grid, n, ac in [((2, K, 64, 128), (256, 512), 4, False),
                                   ((2, K, 64, 93), (256, 372), 4, True),
                                   ((2, K, 64, 128), (256, 512), 8, True),
                                   ((1, 7, 24, 37), (96, 150), 8, False)]:
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            ext = [e.contiguous() for e in
                   halo_exchange(list(x.chunk(n, dim=2)), 1, 1)]
            out.append((f"sharded tail {shape} -> {grid} n={n} "
                        f"align_corners={ac} {tag}",
                        lambda uk, ext=ext, grid=grid, n=n, ac=ac: torch.cat(
                            [upsample_argmax_sharded(
                                e, grid, shard=s, n_shards=n,
                                align_corners=ac, use_kernels=uk)
                             for s, e in enumerate(ext)], dim=1)))
        for shape, grid, crop, ac in [((N, K, 128, 128), (H2, W2),
                                       (500, 498), True),
                                      ((2, K, 37, 45), (148, 180),
                                       (145, 179), False),
                                      ((1, 5, 16, 24), (64, 96), None, True)]:
            b, k, h, w = shape
            x = torch.randn((b, k, h * w), generator=g,
                            device="cuda").to(dt)
            out.append((f"flat tail {shape} -> {grid} crop={crop} "
                        f"align_corners={ac} {tag}",
                        lambda uk, x=x, hw=(h, w), grid=grid, crop=crop, ac=ac:
                        upsample_argmax_flat(x, hw, grid, crop_hw=crop,
                                             align_corners=ac,
                                             use_kernels=uk)))
    return out


def phase_tail(torch):
    g = torch.Generator(device="cuda").manual_seed(2)
    logits = torch.randn((N, K, H // 4, W // 4), generator=g,
                         device="cuda").to(torch.bfloat16)
    for what, fn in tail_cases(torch, logits) + window_flat_forms(torch):
        got = fn(True)
        check(got.dtype == torch.uint8, f"{what}: mask of {got.dtype}")
        _exact(torch, got, fn(False), what)
    return logits, 0


def _compare(torch, got, want, what):
    """bf16: share of bit-identical elements and the worst error as a
    share of max(|ref|, 1); f32: allclose at 1e-4."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{what}: non-finite output")
    err = ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()
    abs_err = (g - w).abs().max().item()
    if got.dtype == torch.bfloat16:
        rate = (got.view(torch.int16) == want.view(torch.int16)).float()
        rate = rate.mean().item()
        ok = rate >= 0.99 and err <= 1e-2
        print(f"[check] {what}: bit-identical={rate!r} worst={err!r}")
        check(ok, f"{what}: bit-identical {rate} < 99 % or error {err} > 1e-2")
    else:
        ok = torch.allclose(g, w, rtol=1e-4, atol=1e-4)
        print(f"[check] {what}: f32 max_abs_err={abs_err!r}")
        check(ok, f"{what}: f32 kernel differs from plain beyond 1e-4")
    return abs_err


def _exact(torch, got, want, what):
    """got bit for bit equal to its twin's want (shape, dtype, every
    bit): the CUDA-core kernels that sum in the twins' order, and the
    tail's masks. Returns the worst absolute error (0.0)."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} "
          f"{want.dtype}")
    check(bool(torch.isfinite(got.float()).all()), f"{what}: non-finite output")
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
    same = torch.equal(got.view(view), want.view(view))
    err = (got.float() - want.float()).abs().max().item()
    print(f"[check] {what}: bit-identical={same} max_abs_err={err!r}")
    check(same, f"{what}: differs from its plain twin (max_abs_err {err})")
    return err


def exact_call(name, a) -> bool:
    """A recorded call of the kernels held to their twins bit for bit:
    resize_chw and conv_chw's k = 1 dense form (conv1x1_kernel)."""
    return name == "resize_chw" or (
        name == "conv_chw" and a["k"] == 1 and not a["depthwise"])


def _bits_rate(torch, got, want) -> float:
    return (got.view(torch.int16) == want.view(torch.int16)).float().mean().item()


# a bf16 cell_op_chw call's worst error against its twin's whole call, as
# a share of max(|ref|, 1): two bf16 roundings near 1 (each node is held
# to 1e-2 on its own; measured worst 0.0127 on an H100)
CELL_CALL_TOL = 2e-2


def check_call(torch, name, fn, a, what):
    """A recorded decoder call's kernel output against its plain twin's on
    the same inputs (``_exact`` for ``exact_call``, else ``_compare``);
    returns (kernel output, worst abs error). A bf16 ``cell_op_chw`` call launches one node kernel per node,
    each node reading the ones before: its nodes are held one by one, each
    against the twin's node on the same entries (the kernel's earlier
    nodes), then the collect sum; the whole call is held to the twin's
    whole call at >= 99 % bit-identical and a worst error <= CELL_CALL_TOL
    of max(|ref|, 1) (two chained roundings: a node one rounding apart
    moves the next node's sums)."""
    got = replay(fn, a, True)
    what = f"{what} {tuple(got.shape)}"
    if exact_call(name, a):
        return got, _exact(torch, got, replay(fn, a, False), what)
    if name != "cell_op_chw" or got.dtype != torch.bfloat16:
        return got, _compare(torch, got, replay(fn, a, False), what)
    from segtpu_torch.kernels.chw_ops import cell_op_chw
    entries, worst = list(a["srcs"]), 0.0
    for i, node in enumerate(a["nodes_desc"]):
        j = len(entries)
        step = cell_op_chw(entries, [node], [j])
        worst = max(worst, _compare(torch, step, cell_op_chw(
            entries, [node], [j], use_kernels=False), f"{what} node {i}"))
        entries.append(step)
    if len(a["collect"]) > 1:
        worst = max(worst, _compare(
            torch, cell_op_chw(entries, [], a["collect"]),
            cell_op_chw(entries, [], a["collect"], use_kernels=False),
            f"{what} collect"))
    want = replay(fn, a, False)
    rate = _bits_rate(torch, got, want)
    rel = ((got.float() - want.float()).abs()
           / want.float().abs().clamp_min(1.0)).max().item()
    print(f"[check] {what} whole call: bit-identical={rate!r} worst={rel!r}")
    check(rate >= 0.99 and rel <= CELL_CALL_TOL,
          f"{what}: whole call bit-identical {rate} < 99 % or error {rel} > "
          f"{CELL_CALL_TOL}")
    return got, worst


def encoder_stages(enc):
    """(kernel name, stage fn(x, use_kernels), cuDNN yardstick fn(x),
    work fn(x) -> (bytes, dot flops, f32 flops), tensor-core fn(x) or
    None) for the stem and the 17 blocks of a FoldedMobileNetV2, in path
    order. The stage fn is the served block (the CUDA-core kernel); the
    last runs the block on the tensor-core kernel (``inv_res_tc_chw``)."""
    import torch.nn.functional as F

    def stem_lib(x):
        h, w = x.shape[-2:]
        return F.conv2d(x, enc.stem_w, enc.stem_b.to(x.dtype),
                        padding=1)[..., :h, :w]

    stages = [("conv_chw", enc.stem, stem_lib,
               lambda x: conv_work(x.shape, 32, 2, False, x.element_size()),
               None)]
    for blk in enc.blocks:
        def lib(x, blk=blk):
            dt = x.dtype
            if blk.w_exp is not None:
                x = F.conv2d(x, blk.w_exp, blk.b_exp.to(dt))
            x = F.conv2d(x, blk.w_dw.to(dt), blk.b_dw.to(dt),
                         stride=blk.stride, padding=1, groups=x.shape[1])
            return F.conv2d(x, blk.w_proj, blk.b_proj.to(dt))

        def work(x, blk=blk):
            return inv_res_work(x.shape, blk.w_dw.shape[0],
                                blk.w_proj.shape[0], blk.stride,
                                blk.w_exp is not None, x.element_size())
        name = "inv_res_s2_chw" if blk.stride == 2 else "inv_res_chw"
        stages.append((name, blk, lib, work, tc_block(blk)))
    return stages


def tc_block(blk):
    """fn(x, use_kernels=True): the folded block ``blk`` on the
    tensor-core kernel (``inv_res_tc_chw``), its expand and project
    weights packed once, here; the plain twin without kernels."""
    from segtpu_torch.kernels.chw_ops import inv_res_tc_chw, pack_weights
    packed = (None if blk.w_exp is None else pack_weights(blk.w_exp),
              pack_weights(blk.w_proj))

    def forward(x, use_kernels: bool = True):
        if not use_kernels:
            return type(blk).forward(blk, x, False)
        return inv_res_tc_chw(x, blk.w_exp, blk.b_exp, blk.w_dw, blk.b_dw,
                              blk.w_proj, blk.b_proj, stride=blk.stride,
                              residual=blk.residual, packed=packed)
    return forward


def block_floor_ms(blk, x):
    """(f32 FMA floor ms with the expand's halo, the plan): a folded
    block's products on x as f32 multiply-adds at the measured rate, the
    expand over every tile's whole window at the plan ``inv_res_plan``
    gives the launch."""
    from segtpu_torch.kernels.chw_ops import _sm_count, inv_res_plan
    from segtpu_torch.kernels.inv_res_sweep import fma_floor_ms
    b, cin, h, w = x.shape
    cmid, cout, st = blk.w_dw.shape[0], blk.w_proj.shape[0], blk.stride
    expand = blk.w_exp is not None
    plan = inv_res_plan(cin, cmid, cout, h // st, w // st, st, x.dtype, b,
                        expand, sm_count=_sm_count(x.device))
    return fma_floor_ms(cin, cmid, cout, st, b, h, w, expand, plan), plan


def phase_encoder(torch, img):
    """Phase 4 (see the module doc). Returns per-kernel sums over the
    main path's launches (worst abs error, kernel/plain/library ms and,
    for the blocks, the tensor-core and CUDA-core kernels' ms, bytes and
    operations) and each launch's times."""
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.models.fast_encoder import fold_encoder
    from segtpu_torch.scripts import (F32_FMA_MEASURED_FLOP_PER_S as
                                      FMA_MEASURED, bound_ms,
                                      cuda_ms as adaptive_ms, turns_ms)
    model = make_model(torch)
    names = ("conv_chw", "inv_res_chw", "inv_res_s2_chw")
    res = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                   bytes=0, dot=0, f32=0, n=0) for n in names}
    for n in names[1:]:
        res[n].update(tc_ms=0.0, tc_max_abs_err=0.0)
    enc = fold_encoder(model.encoder, torch.bfloat16).to("cuda")
    y = normalize_s2d_front(img)
    stage_ms = []
    with torch.inference_mode():
        for i, (name, fn, lib, work, tc) in enumerate(encoder_stages(enc)):
            what = f"stage {i:2d} {name} {tuple(y.shape)}"
            got = fn(y, True)
            want = fn(y, False)
            torch.cuda.synchronize()
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"],
                                   _exact(torch, got, want, what))
            arms = {"ms": lambda: fn(y, True), "lib": lambda: lib(y)}
            if tc is not None:
                # the tensor-core kernel, which no serving path calls
                r["tc_max_abs_err"] = max(r["tc_max_abs_err"], _compare(
                    torch, tc(y), want, f"{what} tensor cores"))
                arms["tc"] = lambda: tc(y)
            # the kernels and cuDNN in turns, each over a ~25 ms window
            t = turns_ms(arms, adaptive_ms)
            ms, lib_ms = t["ms"], t["lib"]
            plain_ms = cuda_ms(lambda: fn(y, False), 1, warmup=1)
            nbytes, dot, f32 = work(y)
            bms, by = bound_ms(nbytes, dot, f32)
            floor = dot / FMA_MEASURED * 1e3
            halo = None if tc is None else block_floor_ms(fn, y)
            print(f"[timing] {what}: {ms:.4f} ms"
                  + (f" (CUDA cores; tensor cores {t['tc']:.4f} ms)"
                     if tc else "")
                  + f", plain {plain_ms:.4f} ms, cuDNN yardstick "
                  f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}), f32 FMA "
                  f"floor {floor:.4f} ms"
                  + ("" if halo is None else
                     f" ({halo[0]:.4f} ms with the halo at plan "
                     f"{tuple(halo[1])})"))
            stage_ms.append((name, list(y.shape), ms, plain_ms, lib_ms,
                             t.get("tc"), bms, floor,
                             None if halo is None else halo[0]))
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("tc_ms", t.get("tc")),
                           ("bytes", nbytes), ("dot", dot), ("f32", f32),
                           ("n", 1)):
                if v is not None:
                    r[key] += v
            y = got
        check([res[n]["n"] for n in names] == [1, 13, 4],
              f"encoder stage counts {[res[n]['n'] for n in names]}")

        # f32 at a small batch, every stage
        enc32 = fold_encoder(model.encoder, torch.float32).to("cuda")
        y = normalize_s2d_front(img[:2, :128, :256].contiguous(),
                                out_dtype=torch.float32)
        for i, (name, fn, *_) in enumerate(encoder_stages(enc32)):
            got = fn(y, True)
            _exact(torch, got, fn(y, False), f"f32 stage {i:2d} {name}")
            y = got
        phase_kernel_forms(torch)
    return res, stage_ms


def stem_tail_forms(torch):
    """[(what, fn(use_kernels))]: the stem's (conv_chw k = 2) and the
    tail's other forms at odd sizes, bf16 and f32 (stem_tail_probe.forms:
    ragged widths, a plane off a 16-byte boundary, C 7-48, Cout 8-100,
    acc and vec_acc, a window of rows; the tail at a ragged crop,
    align_corners False, an odd scale, 150 classes in chunks)."""
    from segtpu_torch.kernels.pw_resize_probe import seeded
    from segtpu_torch.kernels.stem_tail_probe import forms
    return forms(torch, seeded(torch, 12))


def stem_window_checks(torch):
    """[(what, check())]: the stem on a window of rows as the sharded stem
    feeds it (a shard's 16 rows and the halo row above them), bit for bit
    its twin, and its rows but the first the whole input's rows, bf16
    and f32."""
    from segtpu_torch.kernels.chw_ops import conv_chw
    g = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((2, 12, 64, 96), generator=g, device="cuda")
    wt = torch.randn((32, 12, 2, 2), generator=g, device="cuda") * 0.2
    b = torch.randn(32, generator=g, device="cuda") * 0.1
    out = []
    for dt in (torch.bfloat16, torch.float32):
        def run(dt=dt):
            xd, wd = x.to(dt), wt.to(dt)
            whole = conv_chw(xd, wd, b, k=2, act="relu6")
            win = xd[:, :, 15:32].contiguous()
            got = conv_chw(win, wd, b, k=2, act="relu6")
            what = f"stem window rows 15..31 of 64x96 {dt}"
            _exact(torch, got, conv_chw(win, wd, b, k=2, act="relu6",
                                        use_kernels=False), what)
            check(torch.equal(got[:, :, 1:], whole[:, :, 16:32]),
                  f"{what}: rows differ from the whole input's rows")
        out.append((f"stem window {dt}", run))
    return out


def inv_res_forms(torch, tensor_cores=True):
    """[(what, check())]: odd-sized inverted residuals (tiles cut by the
    image edge, Cin 24, no expand, stride 2) at small shapes, f32 and
    bf16 on the served CUDA-core kernel, bit for bit its twin, and, with
    ``tensor_cores``, bf16 on the tensor-core kernel at its tolerance;
    then a stride-2 block on a shard's rows as mbv2_chw_sharded feeds it
    (rows 14..35 of a 36-row input: 2 halo rows above), whose output rows
    but the first must be the whole input's rows 8..17, bit for bit."""
    from segtpu_torch.kernels.chw_ops import (inv_res_chw, inv_res_s2_chw,
                                              inv_res_tc_chw)
    g = torch.Generator(device="cuda").manual_seed(4)

    def block(x, *ws, stride, residual=False, tc=False, use_kernels=True):
        if tc:
            return inv_res_tc_chw(x, *ws, stride=stride, residual=residual)
        if stride == 2:
            return inv_res_s2_chw(x, *ws, use_kernels=use_kernels)
        return inv_res_chw(x, *ws, residual=residual,
                           use_kernels=use_kernels)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    kernels = ((torch.float32, False), (torch.bfloat16, False))
    if tensor_cores:
        kernels += ((torch.bfloat16, True),)
    out = []
    block_cases = [  # stride, cin, t, cout, residual, h, w
        (1, 16, 6, 24, False, 13, 21),
        (1, 32, 6, 32, True, 9, 11),
        (1, 32, 1, 16, False, 17, 30),
        (2, 32, 1, 16, False, 14, 22),
        (2, 96, 6, 160, False, 10, 6),
        (1, 160, 6, 320, False, 3, 5),
        (1, 24, 6, 24, True, 13, 21),      # Cin 24: K padded to 32
    ]
    for stride, cin, t, cout, residual, h, w in block_cases:
        cmid = cin * t
        wts = ((rnd(cmid, cin, 1, 1, scale=0.2), rnd(cmid, scale=0.1))
               if t != 1 else (None, None)) + (
            rnd(cmid, 1, 3, 3, scale=0.3), rnd(cmid, scale=0.1),
            rnd(cout, cmid, 1, 1, scale=0.1), rnd(cout, scale=0.1))
        x = rnd(2, cin, h, w)
        for dt, tc in kernels:
            ws = tuple(None if v is None else
                       (v.to(dt) if j in (0, 4) else v)
                       for j, v in enumerate(wts))
            what = (f"inv_res s{stride} {cin}x{t}->{cout} res={residual} "
                    f"{h}x{w} {dt}" + (" tensor cores" if tc else
                                       " CUDA cores"))

            def run(x=x.to(dt), ws=ws, stride=stride, residual=residual,
                    tc=tc, what=what):
                got = block(x, *ws, stride=stride, residual=residual, tc=tc)
                want = block(x, *ws, stride=stride, residual=residual,
                             use_kernels=False)
                (_compare if tc else _exact)(torch, got, want, what)
            out.append((what, run))
    wts = (rnd(192, 32, 1, 1, scale=0.2), rnd(192, scale=0.1),
           rnd(192, 1, 3, 3, scale=0.3), rnd(192, scale=0.1),
           rnd(64, 192, 1, 1, scale=0.1), rnd(64, scale=0.1))
    x = rnd(2, 32, 36, 32)
    for dt, tc in kernels:
        ws = tuple(v.to(dt) if j in (0, 4) else v for j, v in enumerate(wts))
        what = (f"inv_res s2 32x6->64 shard rows 14..35 {dt} "
                + ("tensor cores" if tc else "CUDA cores"))

        def run(x=x.to(dt), ws=ws, tc=tc, what=what):
            whole = block(x, *ws, stride=2, tc=tc)
            part = x[:, :, 14:].contiguous()
            got = block(part, *ws, stride=2, tc=tc)
            (_compare if tc else _exact)(
                torch, got, inv_res_s2_chw(part, *ws, use_kernels=False),
                what)
            check(torch.equal(got[:, :, 1:], whole[:, :, 8:]),
                  f"{what}: rows differ from the whole input's rows")
        out.append((what, run))
    return out


def phase_kernel_forms(torch):
    """conv_chw's decoder forms and inverted residuals at odd sizes
    (tiles cut by the image edge), small shapes, f32 and bf16."""
    from segtpu_torch.kernels.chw_ops import conv_chw
    g = torch.Generator(device="cuda").manual_seed(4)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    conv_cases = [  # k, dilation, depthwise, act, cin, cout, acc, vec
        (3, 2, False, "relu", 48, 48, False, False),
        (3, 12, False, "relu", 48, 48, False, False),
        (5, 1, True, "relu", 48, 48, False, False),
        (5, 6, True, "none", 48, 48, True, False),
        (1, 1, False, "none", 96, 19, True, False),
        (1, 1, False, "relu", 48, 48, False, True),
        (3, 1, False, "relu", 48, 48, False, True),
        (2, 1, False, "relu6", 12, 32, False, False),
    ]
    for k, dil, dw, act, cin, cout, use_acc, use_vec in conv_cases:
        x = rnd(2, cin, 37, 70)
        w = rnd(cin, 1, k, k, scale=0.3) if dw else rnd(cout, cin, k, k,
                                                        scale=0.1)
        b = rnd(cout, scale=0.1)
        acc = rnd(2, cout, 37, 70) if use_acc else None
        vec = rnd(2, cout) if use_vec else None
        for dt in (torch.float32, torch.bfloat16):
            args = (x.to(dt), w if dw else w.to(dt), b,
                    None if acc is None else acc.to(dt), vec)
            kw = dict(k=k, dilation=dil, depthwise=dw, act=act)
            (_exact if k in (1, 2) and not dw and dil == 1 else _compare)(
                torch, conv_chw(*args, **kw),
                     conv_chw(*args, **kw, use_kernels=False),
                     f"conv_chw k={k} dil={dil} dw={dw} {act} acc={use_acc} "
                     f"vec={use_vec} {dt}")
    for what, fn in stem_tail_forms(torch):
        _exact(torch, fn(True), fn(False), what)
    for what, fn in stem_window_checks(torch):
        fn()
    for what, run in inv_res_forms(torch):
        run()


DECODER_KERNELS = ("conv_chw", "pw_chain_chw", "pw_multi_chw",
                   "sep_conv_chw", "pair_op_chw", "cell_op_chw", "resize_chw")
# A valid genotype of the search space whose decoder takes the paths
# arch0's does not: a two-branch node before the pool's source (pair_op_chw)
# and two collected entries (pw_multi_chw, the head without its concat).
# At 512x512 frames its decoder is 128 wide, so the engine ends in the
# W-first tail (upsample_argmax_flat). Its frames are the second path.
G2 = [[2, [0, 1, 5, 3], [2, 1, 4, 0], [3, 2, 8, 9]], [[3, 2], [2, 4], [1, 0]]]
H2 = W2 = 512
G2_ONLY = ("pw_multi_chw", "pair_op_chw", "upsample_argmax_flat")
# The template (WACV'20) family: template0 (models/arch_literals.py) is the
# third path. TEMPLATE_FORMS put each of the 11 ops in a block, under both
# aggregations, between them: form 0's first block adds a resized branch
# to one at the block's size (a plain add), form 2's adds one inside the
# resize kernel (acc), form 1 collects two entries (pw_multi_chw); they run
# on 2 frames of TEMPLATE_FORMS_HW. The template models take the weight
# seed TEMPLATE_SEED: with random weights most seeds give masks of nearly
# one class, where a mask check (and the control) has little to see; this
# one's masks hold several.
TEMPLATE_FORMS = [[[3, 2, 0, 0], [4, 1, 1, 1], [5, 0, 0, 2], [6, 2, 1, 3]],
                  [[3, 2, 1, 4], [4, 1, 0, 5], [4, 0, 1, 6], [6, 3, 0, 7]],
                  [[2, 3, 0, 8], [1, 4, 1, 9], [0, 5, 0, 10], [6, 2, 1, 0]]]
TEMPLATE_FORMS_HW = (256, 512)
TEMPLATE_SEED = 2


def record_decoder(torch, dec, taps):
    """Run the folded decoder on taps with every kernel wrapper it calls
    wrapped to record (name, wrapper, bound arguments). Returns (logits,
    calls)."""
    import inspect
    import segtpu_torch.models.fast_decoder as fd
    saved = {n: getattr(fd, n) for n in DECODER_KERNELS}
    calls = []

    def wrap(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            ba = inspect.signature(fn).bind(*args, **kw)
            ba.apply_defaults()
            calls.append((name, fn, dict(ba.arguments)))
            return out
        return rec

    for n, f in saved.items():
        setattr(fd, n, wrap(n, f))
    try:
        with torch.inference_mode():
            logits = dec(taps)
    finally:
        for n, f in saved.items():
            setattr(fd, n, f)
    return logits, calls


def replay(fn, a, use_kernels: bool):
    kw = dict(a)
    kw["use_kernels"] = use_kernels
    return fn(**kw)


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _branch_ops(br, x):
    """(dot flops, f32 flops) of one cell branch on x."""
    if br["kind"] not in ("conv", "sep"):
        return 0, 0
    b, c, h, w = x.shape
    k = br["k"]
    if br["kind"] == "conv":
        return 2 * b * h * w * c * br["w"].shape[0] * k * k, 0
    return 2 * b * h * w * c * br["wpw"].shape[0], 2 * b * h * w * c * k * k


def call_work(name, a, out):
    """(bytes, dot flops, f32 flops) one decoder call must move and do:
    each input read once, the output written once, intermediates kept
    on chip; dense and 1x1 products as dot flops, depthwise and
    interpolation arithmetic as f32 flops."""
    if name == "conv_chw":
        x = a["x"]
        nb, dot, f32 = conv_work(x.shape, out.shape[1], a["k"], a["depthwise"],
                                 x.element_size())
        return nb + _nb(a["acc"]), dot, f32
    if name in ("pw_chain_chw", "pw_multi_chw"):
        xs = [a["x"]] if name == "pw_chain_chw" else list(a["xs"])
        ws = [w for w, _ in a["stages"]] if name == "pw_chain_chw" \
            else list(a["ws"])
        b, _, h, w = xs[0].shape
        return (_nb(*xs, out), sum(2 * b * h * w * wt.shape[0] * wt.shape[1]
                                   for wt in ws), 0)
    if name == "sep_conv_chw":
        br = {"kind": "sep", "k": a["k"], "wpw": a["w_pw"]}
        dot, f32 = _branch_ops(br, a["x"])
        return _nb(a["x"], a["acc"], out), dot, f32
    if name == "pair_op_chw":
        tot = [0, 0]
        for x, wts, op in ((a["x1"], a["weights1"], a["op1"]),
                           (a["x2"], a["weights2"], a["op2"])):
            br = {"kind": op[0], "k": op[1], "w": wts[0],
                  "wpw": wts[2] if op[0] == "sep" else None}
            d, f = _branch_ops(br, x)
            tot[0] += d
            tot[1] += f
        return _nb(a["x1"], a["x2"], out), tot[0], tot[1]
    if name == "cell_op_chw":
        x = a["srcs"][0]
        dot = f32 = 0
        for branches in a["nodes_desc"]:
            for br in branches:
                d, f = _branch_ops(br, x)
                dot += d
                f32 += f
        return _nb(*a["srcs"], out), dot, f32
    if name == "resize_chw":
        chain = a["acc_chain"]
        nb = _nb(a["x"], a["acc"], out) + (_nb(chain[0]) if chain else 0)
        b, _, oh, ow = out.shape
        dot = sum(2 * b * oh * ow * w.shape[0] * w.shape[1]
                  for w, _ in chain[1]) if chain else 0
        # 6 multiplies and 3 adds per output element, 1 add for acc
        return nb, dot, 10 * out.numel()
    raise ValueError(name)


def _lib_branch(torch, br, x):
    import torch.nn.functional as F
    dt = x.dtype
    if br["kind"] == "skip":
        return x
    if br["kind"] == "none":
        return None
    k, dil = br["k"], br["dil"]
    pad = dil * (k // 2)
    if br["kind"] == "conv":
        return F.relu(F.conv2d(x, br["w"].to(dt), br["b"].to(dt), padding=pad,
                               dilation=dil))
    mid = F.relu(F.conv2d(x, br["wdw"].to(dt), br["bdw"].to(dt), padding=pad,
                          dilation=dil, groups=x.shape[1]))
    return F.relu(F.conv2d(mid, br["wpw"].to(dt), br["bpw"].to(dt)))


def _lib_node(torch, pairs, add, vec):
    tot = None
    for br, x in pairs:
        y = _lib_branch(torch, br, x)
        if y is not None:
            tot = y if tot is None else tot + y
    if add is not None:
        tot = tot + add
    if vec is not None:
        tot = tot + vec.to(tot.dtype)[:, :, None, None]
    return tot


def library_call(torch, name, a):
    """The call's function as PyTorch library calls in its dtype (cuDNN
    convolutions, ``F.interpolate``), the yardstick and the independent
    reference of each decoder kernel."""
    import torch.nn.functional as F
    if name == "conv_chw":
        x = a["x"]
        k, dil = a["k"], a["dilation"]
        dt = x.dtype
        y = F.conv2d(x, a["w"].to(dt), a["bias"].to(dt), padding=dil * (k // 2),
                     dilation=dil, groups=x.shape[1] if a["depthwise"] else 1)
        y = {"relu": F.relu, "relu6": F.relu6}.get(a["act"], lambda v: v)(y)
        if a["acc"] is not None:
            y = y + a["acc"]
        if a["vec_acc"] is not None:
            y = y + a["vec_acc"].to(dt)[:, :, None, None]
        return y
    if name == "pw_chain_chw":
        y = a["x"]
        for w, b in a["stages"]:
            y = F.relu(F.conv2d(y, w.to(y.dtype), b.to(y.dtype)))
        return y
    if name == "pw_multi_chw":
        x = torch.cat(list(a["xs"]), 1)
        return F.conv2d(x, torch.cat(list(a["ws"]), 1).to(x.dtype),
                        a["bias"].to(x.dtype))
    if name == "sep_conv_chw":
        br = {"kind": "sep", "k": a["k"], "dil": a["dilation"],
              "wdw": a["w_dw"], "bdw": a["b_dw"], "wpw": a["w_pw"],
              "bpw": a["b_pw"]}
        return _lib_node(torch, [(br, a["x"])], a["acc"], a["vec_acc"])
    if name == "pair_op_chw":
        from segtpu_torch.kernels.chw_ops import _op_branch
        return _lib_node(torch, [
            (_op_branch(a["op1"], a["weights1"]), a["x1"]),
            (_op_branch(a["op2"], a["weights2"]), a["x2"])], None, None)
    if name == "cell_op_chw":
        entries = list(a["srcs"])
        for branches in a["nodes_desc"]:
            vec = None
            pairs = []
            for br in branches:
                if br["kind"] == "vec":
                    vec = br["vec"] if vec is None else vec + br["vec"]
                elif br["kind"] != "none":
                    pairs.append((br, entries[br["entry"]]))
            y = _lib_node(torch, pairs, None, vec) if pairs else \
                vec.to(entries[0].dtype)[:, :, None, None].expand_as(entries[0])
            entries.append(y)
        out = None
        for c in a["collect"]:
            out = entries[c] if out is None else out + entries[c]
        return out
    if name == "resize_chw":
        y = F.interpolate(a["x"], size=tuple(a["out_hw"]), mode="bilinear",
                          align_corners=a["align_corners"])
        if a["acc"] is not None:
            y = y + a["acc"]
        if a["acc_chain"] is not None:
            y = y + library_call(torch, "pw_chain_chw", {
                "x": a["acc_chain"][0], "stages": a["acc_chain"][1]})
        return y
    raise ValueError(name)


def _lib_compare(torch, got, ref, what, tol):
    """Worst error of a kernel's output against an independent library
    reference, as a share of the reference's largest magnitude."""
    err = ((got.float() - ref.float()).abs().max()
           / ref.float().abs().max().clamp_min(1e-30)).item()
    print(f"[decoder] {what}: vs library f32 relative worst={err!r}")
    check(err <= tol, f"{what}: {err} > {tol} of the library reference")
    return err


def decoder_calls(torch, genotype, hw, dtype, batch, seed: int = 0):
    """(model, folded decoder, frames, taps, logits, recorded decoder
    calls) for seeded frames through the kernels (``seed``: the model's
    weights)."""
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.models.fast_decoder import fold_decoder
    from segtpu_torch.models.fast_encoder import fold_encoder
    model = make_model(torch, genotype, seed)
    enc = fold_encoder(model.encoder, dtype).to("cuda")
    dec = fold_decoder(model.decoder, dtype).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    img = torch.randint(0, 256, (batch, *hw, 3), generator=g, device="cuda",
                        dtype=torch.uint8)
    x12 = normalize_s2d_front(img, out_dtype=dtype)
    with torch.inference_mode():
        taps = enc(x12)
    logits, calls = record_decoder(torch, dec, taps)
    return model, dec, img, taps, logits, calls


def phase_decoder(torch, res):
    """Phase 5 (see the module doc). Adds each decoder kernel's launches
    (path, worst error, kernel/plain/library ms, bytes and operations) to
    ``res``; returns each launch's times and the G2 path's logits."""
    for n in DECODER_KERNELS + ("upsample_argmax_flat",):
        res.setdefault(n, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                               library_ms=0.0, bytes=0, dot=0, f32=0, n=0))
    from segtpu_torch.models import ARCHS
    from segtpu_torch.scripts import (F32_FMA_MEASURED_FLOP_PER_S as
                                      FMA_MEASURED, bound_ms,
                                      cuda_ms as adaptive_ms, turns_ms)
    stage_ms = []
    paths = (("main", ARCHS["arch0"], (H, W)), ("G2", G2, (H2, W2)))
    for path, genotype, hw in paths:
        model, dec, img, taps, logits, calls = decoder_calls(
            torch, genotype, hw, torch.bfloat16, N)
        print(f"[decoder] {path} {N}x{hw[0]}x{hw[1]}: calls "
              f"{[c[0] for c in calls]}")
        with torch.inference_mode():
            for i, (name, fn, a) in enumerate(calls):
                # the main path's kernels are measured on it, the rest on G2
                if path == "G2" and name not in G2_ONLY:
                    if exact_call(name, a):
                        check_call(torch, name, fn, a,
                                   f"{path} call {i:2d} {name}")
                    continue
                got, err = check_call(torch, name, fn, a,
                                      f"{path} call {i:2d} {name}")
                shape = tuple(got.shape)
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], err)
                # kernel and library in turns, each over a ~25 ms window
                t = turns_ms({"ms": lambda: replay(fn, a, True),
                              "lib": lambda: library_call(torch, name, a)},
                             adaptive_ms)
                ms, lib_ms = t["ms"], t["lib"]
                plain_ms = cuda_ms(lambda: replay(fn, a, False), 1, warmup=1)
                print(f"[timing] {path} call {i:2d} {name} {shape}: "
                      f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                      f"{lib_ms:.4f} ms")
                nb, dot, f32 = call_work(name, a, got)
                # the dot products as f32 FMAs on the CUDA cores at the
                # card's measured rate: the floor of a design that keeps
                # the twins' sum order
                fma_ms = dot / FMA_MEASURED * 1e3
                bms = bound_ms(nb, dot, f32)[0]
                print(f"[timing] {path} call {i:2d} {name} {shape}: bound "
                      f"{bms:.4f} ms, f32 FMA floor {fma_ms:.4f} ms")
                stage_ms.append((path, name, list(shape), ms, plain_ms,
                                 lib_ms, bms, fma_ms))
                for key, v in (("ms", ms), ("plain_ms", plain_ms),
                               ("library_ms", lib_ms), ("bytes", nb),
                               ("dot", dot), ("f32", f32), ("n", 1)):
                    r[key] += v
        if path == "main":
            check_encoder_reference(torch, model, dec, img)
            check_library_reference(torch, model, dec, img, taps, logits)
        else:
            flat_tail(torch, logits, res["upsample_argmax_flat"], stage_ms)
    check(res["pw_multi_chw"]["n"] > 0 and res["pair_op_chw"]["n"] > 0,
          "the G2 path did not reach pw_multi_chw and pair_op_chw")
    decoder_f32(torch)
    phase_decoder_forms(torch)
    for what, fn in exact_forms(torch):
        _exact(torch, fn(True), fn(False), what)
    phase_template_decoder(torch)
    return stage_ms


def exact_forms(torch):
    """[(what, fn(use_kernels))]: conv_chw's k = 1 and resize_chw's forms
    at odd sizes and widths, bf16 and f32 (pw_resize_probe.forms: the
    scalar and 16-byte paths, acc and vec_acc, Cout over 96, one to three
    chain stages, a 100-wide stage, 700 channels in chunks, a row window)."""
    from segtpu_torch.kernels.pw_resize_probe import forms, seeded
    return forms(torch, seeded(torch, 9))


def flat_tail_checks(torch, logits):
    """[(what, check())]: the W-first tail on G2's decoder logits ->
    512x512 masks, bf16 and f32, bit for bit its plain twin's; each
    returns the worst difference of mask values (0)."""
    from segtpu_torch.kernels.upsample_argmax import (
        upsample_argmax_flat, upsample_argmax_flat_plain)
    b, k, h, w = logits.shape
    flat = logits.reshape(b, k, h * w)
    out = []
    for x in (flat, flat.float()):
        what = f"G2 flat tail {tuple(x.shape)} {x.dtype} -> {H2}x{W2}"
        out.append((what, lambda x=x, what=what: _exact(
            torch, upsample_argmax_flat(x, (h, w), (H2, W2)),
            upsample_argmax_flat_plain(x, (h, w), (H2, W2)), what)))
    return out


def flat_tail(torch, logits, r, stage_ms):
    """The W-first tail on G2's decoder logits: ``flat_tail_checks``, then
    timed in turns with F.interpolate + argmax and the H-first tail at
    the same shape, each over a ~25 ms window, and both tails as the
    launches of a CUDA graph (the card's time without the Python that
    issues them: at ~0.04 ms a call the host can set the pace)."""
    import torch.nn.functional as F
    from segtpu_torch.kernels.stem_tail_probe import graph_ms
    from segtpu_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_flat, upsample_argmax_flat_plain)
    from segtpu_torch.scripts import cuda_ms as adaptive_ms, turns_ms
    b, k, h, w = logits.shape
    flat = logits.reshape(b, k, h * w)
    for _, run in flat_tail_checks(torch, logits):
        r["max_abs_err"] = max(r["max_abs_err"], run())
    t = turns_ms({
        "ms": lambda: upsample_argmax_flat(flat, (h, w), (H2, W2)),
        "lib": lambda: F.interpolate(logits.float(), size=(H2, W2),
                                     mode="bilinear",
                                     align_corners=True).argmax(1),
        "h_first": lambda: upsample_argmax(logits, (H2, W2))}, adaptive_ms)
    ms, lib_ms, four_d_ms = t["ms"], t["lib"], t["h_first"]
    r["graph_ms"] = graph_ms(
        torch, lambda: upsample_argmax_flat(flat, (h, w), (H2, W2)))
    four_d_graph_ms = graph_ms(torch, lambda: upsample_argmax(logits,
                                                               (H2, W2)))
    plain_ms = cuda_ms(lambda: upsample_argmax_flat_plain(flat, (h, w),
                                                          (H2, W2)), 3)
    print(f"[timing] G2 flat tail {tuple(logits.shape)} -> {H2}x{W2}: "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, "
          f"H-first tail {four_d_ms:.4f} ms; as CUDA graphs: "
          f"{r['graph_ms']!r} ms, H-first tail {four_d_graph_ms!r} ms")
    stage_ms.append(("G2", "upsample_argmax_flat", [b, H2, W2], ms, plain_ms,
                     lib_ms))
    r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, n=1,
             bytes=logits.numel() * logits.element_size() + b * H2 * W2,
             # W pass 2 mul + 1 add per (class, input row, output column),
             # H pass 2 mul + 1 add and 1 compare per (class, output pixel)
             dot=0, f32=b * k * W2 * (3 * h + 4 * H2))


def phase_decoder_forms(torch):
    """The decoder kernels' forms neither path reaches, at odd sizes
    (tiles cut by the image edge), f32 and bf16, each against its plain
    twin: a cell whose collect sums three entries (the collect kernel),
    skip, none and vector-only nodes, a sep conv with acc and vec_acc, a
    pair of two dense convs, a three-stage chain, three sources; and
    widths the served paths do not reach (Cout over 64, Cin not a
    multiple of 16, a k = 1 sep, a chain 80 wide in its middle)."""
    from segtpu_torch.kernels.chw_ops import (cell_op_chw, pair_op_chw,
                                              pw_chain_chw, pw_multi_chw,
                                              sep_conv_chw)
    from segtpu_torch.kernels.resize_chw import resize_chw
    g = torch.Generator(device="cuda").manual_seed(6)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    c, hw = 16, (37, 70)
    conv = {"kind": "conv", "k": 3, "dil": 2, "w": rnd(c, c, 3, 3, scale=0.1),
            "b": rnd(c, scale=0.1)}
    sep = {"kind": "sep", "k": 5, "dil": 1, "wdw": rnd(c, 1, 5, 5, scale=0.2),
           "bdw": rnd(c, scale=0.1), "wpw": rnd(c, c, 1, 1, scale=0.2),
           "bpw": rnd(c, scale=0.1)}
    vec = rnd(2, c).abs()
    w1 = rnd(c, c, 1, 1, scale=0.2)
    nodes = [[dict(conv, entry=0), {"kind": "skip", "entry": 1}],
             [{"kind": "none"}, {"kind": "vec", "vec": vec}],
             [dict(sep, entry=2), {"kind": "none"}],
             [{"kind": "skip", "entry": 3}, dict(sep, entry=0)]]
    stages = [(rnd(24, c, 1, 1, scale=0.2), rnd(24, scale=0.1)),
              (rnd(20, 24, 1, 1, scale=0.2), rnd(20, scale=0.1)),
              (rnd(c, 20, 1, 1, scale=0.2), rnd(c, scale=0.1))]
    x40, x24 = rnd(2, 40, *hw), rnd(2, 24, *hw)
    wide = {"sep": (rnd(40, 1, 3, 3, scale=0.2), rnd(40, scale=0.1),
                    rnd(96, 40, 1, 1, scale=0.2), rnd(96, scale=0.1)),
            "conv": (rnd(96, 40, 5, 5, scale=0.05), rnd(96, scale=0.1))}
    k1 = (rnd(24, 1, 1, 1, scale=0.5), rnd(24, scale=0.1),
          rnd(24, 24, 1, 1, scale=0.2), rnd(24, scale=0.1))
    chain80 = [(rnd(80, 40, 1, 1, scale=0.2), rnd(80, scale=0.1)),
               (rnd(24, 80, 1, 1, scale=0.2), rnd(24, scale=0.1))]
    w19, b19 = rnd(19, 64, 1, 1, scale=0.2), rnd(19, scale=0.1)
    vec24 = rnd(2, 24)
    for dt in (torch.float32, torch.bfloat16):
        x, y = rnd(2, c, *hw).to(dt), rnd(2, c, *hw).to(dt)
        small = rnd(2, c, 19, 35).to(dt)
        cases = {
            "cell collect [2, 4, 5]": lambda uk: cell_op_chw(
                [x, y], nodes, [2, 4, 5], use_kernels=uk),
            "sep acc vec": lambda uk: sep_conv_chw(
                x, sep["wdw"], sep["bdw"], sep["wpw"], sep["bpw"], y, vec,
                k=5, dilation=3, use_kernels=uk),
            "pair conv conv": lambda uk: pair_op_chw(
                x, (conv["w"], conv["b"]), y, (conv["w"][:, :, :1, :1],
                                              conv["b"]),
                op1=("conv", 3, 12), op2=("conv", 1, 1), use_kernels=uk),
            "chain 3 stages": lambda uk: pw_chain_chw(x, stages,
                                                      use_kernels=uk),
            "multi 3 sources": lambda uk: pw_multi_chw(
                [x, y, x], [w1, w1.flip(0), w1], conv["b"], act="relu",
                use_kernels=uk),
            "resize chain": lambda uk: resize_chw(
                small, hw, acc_chain=(x, stages), align_corners=False,
                use_kernels=uk),
            # widths the served paths do not reach: Cout 96 (two launches
            # of 64 and 32 channels), Cin 40 and 24 (K padded to 16), a
            # k = 1 sep, a chain whose middle stage is 80 wide
            "pair sep conv wide": lambda uk: pair_op_chw(
                x40.to(dt), wide["sep"], x40.to(dt), wide["conv"],
                op1=("sep", 3, 3), op2=("conv", 5, 1), use_kernels=uk),
            "sep k1 vec": lambda uk: sep_conv_chw(
                x24.to(dt), *k1, None, vec24, k=1, use_kernels=uk),
            "chain 40-80-24": lambda uk: pw_chain_chw(
                x40.to(dt), chain80, acts=["relu6", "none"], use_kernels=uk),
            "multi 24+40": lambda uk: pw_multi_chw(
                [x24.to(dt), x40.to(dt)], [w19[:, :24], w19[:, 24:]], b19,
                use_kernels=uk),
        }
        for what, fn in cases.items():
            (_exact if what.startswith("resize") else _compare)(
                torch, fn(True), fn(False), f"{what} {dt}")


# the tensor-core encoder's taps may be this share further (mean absolute
# error) from the f32 cuDNN run than the plain twins' encoder's taps: the
# two differ by the f32 order of the blocks' sums alone
ENC_TAPS_ALLOWANCE = 0.02


def check_encoder_reference(torch, model, dec, img):
    """The bf16 encoder with every block on the tensor cores, and the
    plain twins' encoder, on the frames ``img``, against the unfolded
    encoder run in f32 through cuDNN (no TF32): for each tap the tensor
    cores' mean absolute error is at most (1 + ENC_TAPS_ALLOWANCE) times
    the twins'. Then the masks of the kernels' decoder ``dec`` on each of
    the two encoders' taps against the f32 model's: the tensor-core
    encoder's agree with them at least as well as the twins' encoder's,
    less 0.1 %."""
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.kernels.upsample_argmax import upsample_argmax
    from segtpu_torch.models.fast_encoder import fold_encoder
    enc = fold_encoder(model.encoder, torch.bfloat16).to("cuda")
    m32 = model.to("cuda").float().eval()
    hw = tuple(img.shape[1:3])
    try:
        with torch.inference_mode():
            x12 = normalize_s2d_front(img)
            with on_tensor_cores(enc):
                taps = enc(x12)
            twins = enc(x12, use_kernels=False)
            taps32 = m32.encoder(normalize_s2d_front(
                img, out_dtype=torch.float32), input_format="s2d12")
            for i, (tk, tt, t32) in enumerate(zip(taps, twins, taps32)):
                ek, et = ((t.float() - t32).abs().mean().item()
                          for t in (tk, tt))
                print(f"[encoder] tap {i} {tuple(tk.shape)} mean abs error vs "
                      f"f32: tensor cores {ek!r}, plain twins {et!r}, ratio "
                      f"{ek / et!r} (allowed {1 + ENC_TAPS_ALLOWANCE})")
                check(ek <= et * (1 + ENC_TAPS_ALLOWANCE),
                      f"encoder tap {i}: the tensor cores' taps are {ek} from "
                      f"the f32 run, the twins' {et}")
            m_f32 = upsample_argmax(m32.decoder(taps32), hw)
            agree = [(upsample_argmax(dec(t), hw) == m_f32).float().mean()
                     .item() for t in (taps, twins)]
    finally:
        model.to("cpu")
    print(f"[encoder] masks vs the f32 reference, the kernels' decoder on "
          f"the tensor-core encoder's taps {agree[0]!r}, on the plain twins' "
          f"encoder's {agree[1]!r}")
    check(agree[0] >= agree[1] - 1e-3, f"the tensor-core encoder's masks "
          f"agree {agree[0]} with the f32 reference, the twins' {agree[1]}")


def check_library_reference(torch, model, dec, img, taps, logits):
    """The bf16 kernels' taps and logits on the b8 frames against the
    unfolded model run in f32 through cuDNN (no TF32), an implementation
    independent of the kernels and their twins: worst error <= 3 % of the
    largest tap value and <= 5 % of the largest logit. Then the masks of
    the kernels' logits and of the plain twins' decoder on the same taps
    against the f32 run's: the kernels' agree with it at least as well as
    the twins' do, less 0.1 %."""
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.kernels.upsample_argmax import upsample_argmax
    m32 = model.to("cuda").float().eval()
    hw = tuple(img.shape[1:3])
    with torch.inference_mode():
        x32 = normalize_s2d_front(img, out_dtype=torch.float32)
        taps32 = m32.encoder(x32, input_format="s2d12")
        logits32 = m32.decoder(taps32)
        for i, (t, t32) in enumerate(zip(taps, taps32)):
            _lib_compare(torch, t, t32, f"tap {i} {tuple(t.shape)}", 3e-2)
        _lib_compare(torch, logits, logits32, f"logits {tuple(logits.shape)}",
                     5e-2)
        m_f32 = upsample_argmax(logits32, hw)
        m_kernels = upsample_argmax(logits, hw)
        m_twins = upsample_argmax(dec(taps, use_kernels=False), hw)
        agree = [(m == m_f32).float().mean().item()
                 for m in (m_kernels, m_twins)]
    print(f"[decoder] masks vs the f32 reference: kernels {agree[0]!r}, "
          f"plain twins {agree[1]!r}")
    check(agree[0] >= agree[1] - 1e-3, f"the kernels' masks agree "
          f"{agree[0]} with the f32 reference, the twins' {agree[1]}")
    model.to("cpu")


def decoder_f32(torch):
    """Every decoder call of both paths in f32 at 2x128x256 (G2 at
    2x128x128): kernel against its plain twin at rtol = atol = 1e-4 and
    against its library version at 1e-4 of the largest value."""
    from segtpu_torch.models import ARCHS
    for genotype, hw in ((ARCHS["arch0"], (128, 256)), (G2, (128, 128))):
        *_, calls = decoder_calls(torch, genotype, hw, torch.float32, 2)
        with torch.inference_mode():
            for i, (name, fn, a) in enumerate(calls):
                got = replay(fn, a, True)
                (_exact if exact_call(name, a) else _compare)(
                    torch, got, replay(fn, a, False),
                    f"f32 call {i:2d} {name} {tuple(got.shape)}")
                _lib_compare(torch, got, library_call(torch, name, a),
                             f"f32 call {i:2d} {name}", 1e-4)


def make_model(torch, genotype=None, seed: int = 0):
    from segtpu_torch.core.layers import ConvBN
    from segtpu_torch.models import ARCHS, create_segmenter
    gen = torch.Generator().manual_seed(seed)
    model = create_segmenter(genotype or ARCHS["arch0"], K, generator=gen,
                             device="cpu")
    with torch.no_grad():     # BatchNorm that is not the identity
        for m in model.modules():
            if isinstance(m, ConvBN):
                m.scale.uniform_(0.5, 1.5, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.mean.normal_(0.0, 0.1, generator=gen)
                m.var.uniform_(0.5, 1.5, generator=gen)
    return model


# a pixel is a near-tie where the plain twins' top-2 f32 logits are within
# this share of max(|top1|, 1): a rounding can flip its class
NEAR_TIE = 2e-2
# least share of pixels whose class the kernels' masks share with the
# plain twins': G2 as every mask check before the tensor-core decoder;
# arch0 just under its measured 99.66-99.74 % (H100): its 3x3 dense
# branches and dilated sep convs chain more roundings per pixel
MASK_FLOOR = {"G2": 0.999, "arch0": 0.996, "template0": 0.999}


def tie_gaps(torch, ref, x):
    """f32 [N, H, W] on the card: the gap between the top-2 logits of the
    plain-twin engine ``ref`` on the uint8 frames ``x``, as a share of
    max(|top1|, 1)."""
    gaps = []
    for i in range(x.shape[0]):          # one frame's logits at a time
        lg = ref.predict(x[i:i + 1], return_logits=True)
        top = lg.topk(2, dim=1).values
        gaps.append((top[:, 0] - top[:, 1])
                    / top[:, 0].abs().clamp_min(1.0))
    return torch.cat(gaps)


def mask_stats(torch, got, want, gaps):
    """(share of pixels equal, pixels that differ off near-ties of the
    twins' logits, the widest top-2 gap of a pixel that differs)."""
    got, want = (torch.as_tensor(m).to(gaps.device) for m in (got, want))
    diff = got != want
    rate = 1.0 - diff.float().mean().item()
    off = int((diff & (gaps > NEAR_TIE)).sum().item())
    widest = gaps[diff].max().item() if bool(diff.any()) else 0.0
    return rate, off, widest


def masks_hold(torch, got, want, gaps, floor, what):
    """The slice rule, masks of the kernels against the plain twins': at
    least ``floor`` of the pixels equal, and every pixel that differs a
    near-tie of the twins' logits (the kernels' dense and 1x1 sums run in
    another f32 order than the twins', and a rounding apart at one node
    moves its neighbours' sums; through the decoder's chained nodes that
    flips classes where two logits nearly tie). Returns the agreement."""
    rate, off, widest = mask_stats(torch, got, want, gaps)
    print(f"[slice] {what}: agreement={rate!r} (floor {floor}) near-ties="
          f"{(gaps <= NEAR_TIE).float().mean().item()!r} widest gap of a "
          f"mismatch={widest!r} mismatches off near-ties={off}")
    check(rate >= floor, f"{what}: masks agree on {rate} < {floor}")
    check(off == 0, f"{what}: {off} pixels differ off near-ties (gap > "
          f"{NEAR_TIE})")
    return rate


# launches over one b8 predict_batch of each path
PATH_LAUNCHES = {"front": 1, "conv_chw": 4, "inv_res_chw": 13,
                 "inv_res_s2_chw": 4, "pw_chain_chw": 1, "pw_multi_chw": 0,
                 "sep_conv_chw": 3, "pair_op_chw": 0, "cell_op_chw": 3,
                 "resize_chw": 3, "upsample_argmax": 1,
                 "upsample_argmax_flat": 0, "upsample_argmax_sharded": 0}
G2_LAUNCHES = {"front": 1, "conv_chw": 5, "inv_res_chw": 13,
               "inv_res_s2_chw": 4, "pw_chain_chw": 2, "pw_multi_chw": 1,
               "sep_conv_chw": 3, "pair_op_chw": 3, "cell_op_chw": 3,
               "resize_chw": 3, "upsample_argmax": 0,
               "upsample_argmax_flat": 1, "upsample_argmax_sharded": 0}
# the experiments' kernels: no serving path launches them
EXPERIMENT_KERNELS = {
    "exp_vpu_floor": ("fma_peak", "dw_tap_sum"),
    "exp_front_kernel": ("front_single_round",),
    "ab_normalize": ("normalize_s2d_nhwc",),
    "exp_tail_flat": ("clf_upsample_argmax",)}
EXPERIMENT_ONLY = {n: 0 for ks in EXPERIMENT_KERNELS.values() for n in ks}
# the tensor-core inverted residual: no serving path launches it either
TC_ONLY = {"inv_res_tc_chw": 0}
PATH_LAUNCHES.update(EXPERIMENT_ONLY, **TC_ONLY)
G2_LAUNCHES.update(EXPERIMENT_ONLY, **TC_ONLY)
# one b8 1024x2048 call over N_SHARDS logical shards: all three decoder
# blocks shard, so every kernel of the unsharded path runs once per shard,
# the fused cell suffix as one cell_op_chw call per node (3 blocks x 3 nodes)
N_SHARDS = 4
SPACE_LAUNCHES = {"front": 4, "conv_chw": 16, "inv_res_chw": 52,
                  "inv_res_s2_chw": 16, "pw_chain_chw": 4, "pw_multi_chw": 0,
                  "sep_conv_chw": 12, "pair_op_chw": 0, "cell_op_chw": 36,
                  "resize_chw": 12, "upsample_argmax": 0,
                  "upsample_argmax_flat": 0, "upsample_argmax_sharded": 4,
                  **EXPERIMENT_ONLY, **TC_ONLY}
DATA_LAUNCHES = {n: N_SHARDS * v for n, v in PATH_LAUNCHES.items()}
# one b8 1024x2048 predict_batch of template0: the stem and ten 1x1s (4
# adapts, b1 and b2 of the two psum blocks, the cat block's reduce, the
# classifier), the three resizes of a branch below its block's size (a
# branch at the block's size is added in PyTorch), block 0's sep_conv_3x3;
# block 1's pool op and block 2's skip launch no kernel
TEMPLATE_LAUNCHES = {"front": 1, "conv_chw": 11, "inv_res_chw": 13,
                     "inv_res_s2_chw": 4, "pw_chain_chw": 0,
                     "pw_multi_chw": 0, "sep_conv_chw": 1, "pair_op_chw": 0,
                     "cell_op_chw": 0, "resize_chw": 3, "upsample_argmax": 1,
                     "upsample_argmax_flat": 0, "upsample_argmax_sharded": 0,
                     **EXPERIMENT_ONLY, **TC_ONLY}
# its space call over N_SHARDS logical shards of one card: the front and
# the stem per shard, the decoder once (one device) on the gathered taps,
# the sharded tail per shard
TEMPLATE_SPACE_LAUNCHES = dict(TEMPLATE_LAUNCHES, front=N_SHARDS,
                               conv_chw=N_SHARDS + 10,
                               inv_res_chw=N_SHARDS * 13,
                               inv_res_s2_chw=N_SHARDS * 4, upsample_argmax=0,
                               upsample_argmax_sharded=N_SHARDS)
TEMPLATE_DATA_LAUNCHES = {n: N_SHARDS * v
                          for n, v in TEMPLATE_LAUNCHES.items()}
# arch0 without its pool branch: halos of 12 rows and no re-associated sum
NO_POOL = [[2, [0, 1, 3, 9], [2, 0, 5, 2], [1, 3, 8, 0]],
           [[3, 2], [4, 1], [5, 0]]]


def kernel_wrappers():
    from segtpu_torch.kernels import chw_ops
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.kernels.resize_chw import resize_chw
    from segtpu_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_flat, upsample_argmax_sharded)
    out = {"front": normalize_s2d_front}
    for n in ("conv_chw", "inv_res_chw", "inv_res_s2_chw", "inv_res_tc_chw",
              "pw_chain_chw", "pw_multi_chw", "sep_conv_chw", "pair_op_chw",
              "cell_op_chw"):
        out[n] = getattr(chw_ops, n)
    out.update(resize_chw=resize_chw, upsample_argmax=upsample_argmax,
               upsample_argmax_flat=upsample_argmax_flat,
               upsample_argmax_sharded=upsample_argmax_sharded)
    from segtpu_torch.kernels import front_ab, tail_flat, vpu_floor
    out.update(fma_peak=vpu_floor.fma_peak, dw_tap_sum=vpu_floor.dw_tap_sum,
               front_single_round=front_ab.front_single_round,
               normalize_s2d_nhwc=front_ab.normalize_s2d_nhwc,
               clf_upsample_argmax=tail_flat.clf_upsample_argmax)
    return out


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {n: fn.launches for n, fn in kernel_wrappers().items()}


def phase_slice(torch):
    from segtpu_torch.engine import Segmenter
    model = make_model(torch)
    seg = Segmenter(model, device="cuda")
    ref = Segmenter(model, device="cuda", use_kernels=False)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)

    # the main path: predict_batch at b8, counts read around it alone
    reset_counts()
    t0 = time.perf_counter()
    masks = seg.predict_batch(frames)
    cold_s = time.perf_counter() - t0
    launches = read_counts()
    print(f"[slice] predict_batch b8 {H}x{W}: launches={launches} "
          f"first call {cold_s:.2f} s")
    print("[slice] encoder route: all 17 blocks on inv_res_kernel (CUDA "
          "cores), none on inv_res_tc_kernel (on the tensor cores, with any "
          "block shape, arch0's masks fall under MASK_FLOOR: phase 7)")
    check(all(launches[n] > 0 for n, v in PATH_LAUNCHES.items() if v),
          f"a kernel of the main path was not launched: {launches}")
    check(launches == PATH_LAUNCHES,
          f"main-path launches {launches}, expected {PATH_LAUNCHES}")
    check(masks.shape == (N, H, W) and masks.dtype == np.uint8,
          f"mask shape {masks.shape} {masks.dtype}")
    check(int(masks.max()) < K, "mask class out of range")
    print(f"[slice] b8 classes="
          f"{np.bincount(masks.ravel(), minlength=K).tolist()}")
    x = torch.from_numpy(frames).cuda()
    gaps = tie_gaps(torch, ref, x)
    rate = masks_hold(torch, masks, ref.predict_batch(frames), gaps,
                      MASK_FLOOR["arch0"], "b8 masks vs use_kernels=False")

    # the pad path: 1000x1500 -> padded 1024x1504, cropped back
    one = rng.integers(0, 256, (1000, 1500, 3), dtype=np.uint8)
    reset_counts()
    m1 = seg.predict(one)
    pad_launches = read_counts()
    check(all(pad_launches[n] > 0 for n, v in PATH_LAUNCHES.items() if v),
          f"pad path missed a kernel: {pad_launches}")
    check(m1.shape == (1000, 1500), f"pad-path mask shape {m1.shape}")
    print(f"[slice] predict 1000x1500: launches={pad_launches}")
    one_t = torch.from_numpy(one).cuda()[None]
    masks_hold(torch, m1[None], ref.predict(one)[None],
               tie_gaps(torch, ref, one_t), MASK_FLOOR["arch0"],
               "pad path 1000x1500")

    # an odd frame: normalized on the card, zero-padded and packed by
    # space-to-depth into the same folded encoder (no front kernel)
    odd = rng.integers(0, 256, (999, 1501, 3), dtype=np.uint8)
    reset_counts()
    m3 = seg.predict(odd)
    odd_launches = read_counts()
    check(odd_launches["front"] == 0 and all(
        odd_launches[n] > 0 for n, v in PATH_LAUNCHES.items()
        if v and n != "front"), f"odd-frame path launches {odd_launches}")
    print(f"[slice] predict 999x1501: launches={odd_launches}")
    check(m3.shape == (999, 1501), f"odd-frame mask shape {m3.shape}")
    odd_t = torch.from_numpy(odd).cuda()[None]
    masks_hold(torch, m3[None], ref.predict(odd)[None],
               tie_gaps(torch, ref, odd_t), MASK_FLOOR["arch0"],
               "odd frame 999x1501")

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

    # the second path: genotype G2 on 8 frames of 512x512, whose decoder
    # runs pair_op_chw and pw_multi_chw and ends in the W-first tail
    seg2 = Segmenter(make_model(torch, G2), device="cuda")
    ref2 = Segmenter(make_model(torch, G2), device="cuda", use_kernels=False)
    frames2 = rng.integers(0, 256, (N, H2, W2, 3), dtype=np.uint8)
    reset_counts()
    m2 = seg2.predict_batch(frames2)
    g2_launches = read_counts()
    print(f"[slice] G2 predict_batch b8 {H2}x{W2}: launches={g2_launches}")
    check(g2_launches == G2_LAUNCHES,
          f"G2-path launches {g2_launches}, expected {G2_LAUNCHES}")
    masks_hold(torch, m2, ref2.predict_batch(frames2),
               tie_gaps(torch, ref2, torch.from_numpy(frames2).cuda()),
               MASK_FLOOR["G2"], "G2 b8 masks vs use_kernels=False")
    launches = {n: g2_launches[n] if n in G2_ONLY else v
                for n, v in launches.items()}
    del seg2, ref2

    stream_in = [frames[i, :512, :1024] for i in range(3)]
    streamed = list(seg.predict_stream(stream_in))
    check(len(streamed) == 3 and all(
        np.array_equal(s, seg.predict(f)) for s, f in zip(streamed, stream_in)),
        "predict_stream differs from predict")
    print("[slice] predict_stream: 3 frames in order")
    return seg, ref, frames, launches, rate, masks, gaps


def template_call_checks(torch, genotype, hw, dtype, batch, what):
    """[(what, kernel name, check())]: every kernel call of the folded
    template decoder (weights of TEMPLATE_SEED) on the kernels' taps of
    ``batch`` seeded frames, held against its plain twin by
    ``check_call``: conv_chw k = 1 and resize_chw bit for bit, the rest at
    ``_compare``."""
    *_, calls = decoder_calls(torch, genotype, hw, dtype, batch,
                              TEMPLATE_SEED)
    out = []
    for i, (name, fn, a) in enumerate(calls):
        w = f"{what} call {i:2d} {name}"
        out.append((w, name, lambda name=name, fn=fn, a=a, w=w: check_call(
            torch, name, fn, a, w)))
    return out


def template_forms(torch):
    """[(what, check())]: each of TEMPLATE_FORMS on 2 seeded frames of
    TEMPLATE_FORMS_HW, bf16 and f32: every decoder call against its twin
    (``template_call_checks``), the engine's masks against its
    use_kernels=False run by the slice rule at MASK_FLOOR["template0"],
    and in f32 the decoder's logits against the twins' on the same taps
    at 1e-4 (``_compare``). This reaches conv_chw's k = 3 dense forms
    (dilations 1, 3, 12) that no other served path calls outside a cell,
    and pw_multi_chw as a template head."""
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.kernels.front import normalize_s2d_front
    hw = TEMPLATE_FORMS_HW
    frames = np.random.default_rng(14).integers(0, 256, (2, *hw, 3),
                                                dtype=np.uint8)
    out = []
    for gi, genotype in enumerate(TEMPLATE_FORMS):
        for dt in (torch.bfloat16, torch.float32):
            tag = (f"template form {gi} {'bf16' if dt == torch.bfloat16 else 'f32'}"
                   f" 2x{hw[0]}x{hw[1]}")
            out += [(w, run) for w, _, run in template_call_checks(
                torch, genotype, hw, dt, 2, tag)]

            def engines(genotype=genotype, dt=dt):
                model = make_model(torch, genotype, TEMPLATE_SEED)
                return (Segmenter(model, device="cuda", compute_dtype=dt),
                        Segmenter(model, device="cuda", compute_dtype=dt,
                                  use_kernels=False))

            def masks(engines=engines, what=f"{tag} masks"):
                seg, ref = engines()
                x = torch.from_numpy(frames).cuda()
                got = seg.predict_batch(x)
                print(f"[template] {what}: classes "
                      f"{torch.bincount(got.flatten().long()).tolist()}")
                masks_hold(torch, got, ref.predict_batch(x),
                           tie_gaps(torch, ref, x), MASK_FLOOR["template0"],
                           f"{what} vs use_kernels=False")
            out.append((f"{tag} masks vs use_kernels=False", masks))
            if dt == torch.float32:
                def logits(engines=engines, what=f"{tag} logits"):
                    seg, _ = engines()
                    x = torch.from_numpy(frames).cuda()
                    with torch.inference_mode():
                        taps = seg.encoder(normalize_s2d_front(
                            x, out_dtype=torch.float32))
                        _compare(torch, seg.decoder(taps),
                                 seg.decoder(taps, use_kernels=False),
                                 f"{what} vs the twins'")
                out.append((f"{tag} logits vs the twins'", logits))
    return out


def phase_template_decoder(torch):
    """Phase 5's template part: every call of template0's decoder on the
    b8 1024x2048 path held against its twin (``template_call_checks``;
    the calls counted against TEMPLATE_LAUNCHES less the stem), then
    ``template_forms``."""
    from segtpu_torch.models import TEMPLATE_ARCHS
    checks = template_call_checks(torch, TEMPLATE_ARCHS["template0"], (H, W),
                                  torch.bfloat16, N, "template0 main")
    seen = {name: 0 for name in DECODER_KERNELS}
    with torch.inference_mode():
        for _, name, run in checks:
            run()
            seen[name] += 1
    want = {name: TEMPLATE_LAUNCHES[name] - (name == "conv_chw")
            for name in DECODER_KERNELS}
    check(seen == want, f"template0 decoder calls {seen}, expected {want}")
    print(f"[decoder] template0 {N}x{H}x{W}: calls against their twins {seen}")
    del checks
    forms = template_forms(torch)
    for _, run in forms:
        run()
    print(f"[decoder] template forms: {len(forms)} checks")


def template_slice(torch, frames):
    """Phase 6's template path: template0 (weights of TEMPLATE_SEED) on the
    slice phase's b8 1024x2048 frames, predict_batch with the counts reset
    just before and read just after (TEMPLATE_LAUNCHES), its masks against
    the same engine with use_kernels=False by the slice rule at
    MASK_FLOOR["template0"]; then f32 masks on a small frame against the
    CPU run, >= 99.9 %. Returns (engine, masks, launches, agreement)."""
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.models import TEMPLATE_ARCHS
    model = make_model(torch, TEMPLATE_ARCHS["template0"], TEMPLATE_SEED)
    seg = Segmenter(model, device="cuda")
    ref = Segmenter(model, device="cuda", use_kernels=False)
    reset_counts()
    masks = seg.predict_batch(frames)
    launches = read_counts()
    print(f"[slice] template0 predict_batch b8 {H}x{W}: launches={launches}")
    check(all(launches[n] > 0 for n, v in TEMPLATE_LAUNCHES.items() if v),
          f"a kernel of the template path was not launched: {launches}")
    check(launches == TEMPLATE_LAUNCHES,
          f"template-path launches {launches}, expected {TEMPLATE_LAUNCHES}")
    check(masks.shape == (N, H, W) and masks.dtype == np.uint8
          and int(masks.max()) < K, f"template0 masks {masks.shape} "
          f"{masks.dtype}")
    print(f"[slice] template0 b8 classes="
          f"{np.bincount(masks.ravel(), minlength=K).tolist()}")
    x = torch.from_numpy(frames).cuda()
    rate = masks_hold(torch, masks, ref.predict_batch(frames),
                      tie_gaps(torch, ref, x), MASK_FLOOR["template0"],
                      "template0 b8 masks vs use_kernels=False")
    del ref
    small = np.random.default_rng(15).integers(0, 256, (2, 64, 128, 3),
                                               dtype=np.uint8)
    on_gpu = Segmenter(model, device="cuda",
                       compute_dtype=torch.float32).predict(small)
    on_cpu = Segmenter(model, device="cpu",
                       compute_dtype=torch.float32).predict(small)
    rate_cpu = float((on_gpu == on_cpu).mean())
    print(f"[slice] template0 f32 2x64x128 card vs CPU: agreement={rate_cpu!r}")
    check(rate_cpu >= 0.999, f"template0 card vs CPU agreement {rate_cpu} "
          f"< 99.9 %")
    return seg, masks, launches, rate


def template_sharded(torch, seg, frames, masks, t):
    """Phase 8's template path: template0's space call, n = N_SHARDS, on
    the b8 1024x2048 frames (counts reset just before, read just after:
    TEMPLATE_SPACE_LAUNCHES), masks bit-equal to the unsharded engine's
    (the decoder runs whole on the gathered taps, which are bit-equal, and
    both engines take the H-first tail); every decoder call of that call
    against its twin, and its logit rows the unsharded decoder's bit for
    bit; 2x512x1024 at n = 2 and 4, bit-equal; mode="data" on 4 parts of
    the batch (TEMPLATE_DATA_LAUNCHES), bit-equal. Times the space and the
    data call into ``t``; returns the space call's launches."""
    from segtpu_torch.engine import ShardedSegmenter
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.parallel import make_mesh, make_sharded_infer_fn
    n = N_SHARDS
    devices = [torch.device("cuda", 0)] * n
    x = torch.from_numpy(frames).cuda()
    space = make_sharded_infer_fn(seg, make_mesh(1, n, devices=devices),
                                  mode="space")
    reset_counts()
    got = space(x)
    launches = read_counts()
    torch.cuda.synchronize()
    print(f"[sharded] template0 space n={n} b8 {H}x{W}: launches={launches}")
    check(launches == TEMPLATE_SPACE_LAUNCHES, f"template0 space launches "
          f"{launches}, expected {TEMPLATE_SPACE_LAUNCHES}")
    check(np.array_equal(got.cpu().numpy(), masks),
          "template0 space masks differ from the unsharded engine's")
    print("[sharded] template0 space masks: bit-equal")
    sh = ShardedSegmenter(seg, devices)
    rows, calls = record_decoder(torch, sh.decoder,
                                 sh.infer_shards(x, return_taps=True))
    seen = {name: 0 for name in DECODER_KERNELS}
    with torch.inference_mode():
        for i, (name, fn, a) in enumerate(calls):
            check_call(torch, name, fn, a, f"template0 space call {i:2d} {name}")
            seen[name] += 1
        want = seg.decoder(seg.encoder(normalize_s2d_front(x)))
    check(seen == {name: TEMPLATE_SPACE_LAUNCHES[name] - n * (name == "conv_chw")
                   for name in DECODER_KERNELS},
          f"template0 sharded decoder calls {seen}")
    check(torch.equal(torch.cat(rows, dim=2), want),
          "template0 sharded logit rows differ from the unsharded decoder's")
    print(f"[sharded] template0 decoder calls against their twins {seen}; "
          f"logit rows bit-equal")
    del rows, calls, want
    small = np.random.default_rng(8).integers(0, 256, (2, 512, 1024, 3),
                                              dtype=np.uint8)
    want_s = seg.predict_batch(small)
    for k in (2, 4):
        same = bool(np.array_equal(
            ShardedSegmenter(seg, devices[:1] * k).predict(small), want_s))
        print(f"[sharded] template0 2x512x1024 n={k}: bit-equal={same}")
        check(same, f"template0 space masks at n={k} differ from the "
              f"unsharded engine's")
    data = make_sharded_infer_fn(seg, make_mesh(n, 1, devices=devices),
                                 mode="data")
    reset_counts()
    got_d = data(x)
    data_launches = read_counts()
    torch.cuda.synchronize()
    check(data_launches == TEMPLATE_DATA_LAUNCHES, f"template0 data launches "
          f"{data_launches}, expected {TEMPLATE_DATA_LAUNCHES}")
    check(np.array_equal(got_d.cpu().numpy(), masks),
          "template0 data-mode masks differ from the unsharded engine's")
    print("[sharded] template0 data masks: bit-equal")
    t["template0_space_b8"] = cuda_ms(lambda: space(x), 5)
    t["template0_data_b8"] = cuda_ms(lambda: data(x), 5)
    print(f"[timing] template0 {n} logical shards on one card: space "
          f"{t['template0_space_b8']:.4f} ms, data "
          f"{t['template0_data_b8']:.4f} ms, unsharded "
          f"{t['template0_b8']:.4f} ms per b8 call on {gpu_line()}")
    return launches


def tensor_core_encoder(torch, seg, ref, frames, gaps):
    """The engine with encoder blocks on the tensor-core kernel
    (``on_tensor_cores``), which no serving path runs: first the blocks of
    one shape at a time, then every block; the masks against the plain
    twins' (printed, the measurement behind serving every block on the
    CUDA cores: MASK_FLOOR holds the served route, and phase 5's
    check_encoder_reference holds this one against an f32 run), the
    launches (every block on inv_res_tc_kernel) and the ms of a b8
    predict_batch with every block on the tensor cores."""
    shapes = [(blk.w_dw.shape[0] if blk.w_exp is None
               else blk.w_exp.shape[1], blk.w_dw.shape[0],
               blk.w_proj.shape[0], blk.stride) for blk in seg.encoder.blocks]
    want = ref.predict_batch(frames)
    for shape in dict.fromkeys(shapes):
        with on_tensor_cores(seg.encoder, {i for i, s in enumerate(shapes)
                                           if s == shape}):
            rate, off, widest = mask_stats(torch, seg.predict_batch(frames),
                                           want, gaps)
        print(f"[timing] tensor cores on the {shape} blocks alone: b8 "
              f"masks vs use_kernels=False: agreement={rate!r} mismatches "
              f"off near-ties={off} widest gap={widest!r}")
    with on_tensor_cores(seg.encoder):
        reset_counts()
        masks = seg.predict_batch(frames)
        tc = {n: read_counts()[n] for n in ("inv_res_tc_chw", "inv_res_chw",
                                            "inv_res_s2_chw")}
        check(tc == {"inv_res_tc_chw": 17, "inv_res_chw": 0,
                     "inv_res_s2_chw": 0},
              f"tensor-core encoder launches {tc}")
        rate, off, widest = mask_stats(torch, masks, want, gaps)
        print(f"[timing] tensor-core encoder: launches {tc}; b8 masks vs "
              f"use_kernels=False: agreement={rate!r} (the served route's "
              f"floor {MASK_FLOOR['arch0']}) mismatches off near-ties={off} "
              f"widest gap={widest!r}")
        x = torch.from_numpy(frames).cuda()
        return cuda_ms(lambda: seg.predict_batch(x), 10)


def phase_timing(torch, img, logits, seg, ref, frames, gaps):
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
    t["slice_b8_plain_kernels"] = cuda_ms(lambda: ref.predict_batch(x), 5)
    t["slice_b8_tensor_core_encoder"] = tensor_core_encoder(
        torch, seg, ref, frames, gaps)
    tail_bound, tail_by = bounds({})["upsample_argmax"]
    for k, v in t.items():
        print(f"[timing] {k}: {v:.4f} ms" + (
            f" (bound {tail_bound:.4f} ms, {tail_by})" if k == "tail" else ""))
    print(f"[timing] slice b8: {N * 1000.0 / t['slice_b8']:.1f} images/s "
          f"device-resident")
    return t


def sharded_tail_rows(torch, logits) -> int:
    """upsample_argmax_sharded on the tail phase's logits, every shard at
    n = 2, 4, 8, bf16 and f32, bit for bit against its plain twin and
    against the unsharded kernel's rows; returns the worst difference of
    mask values (0)."""
    from segtpu_torch.kernels.upsample_argmax import (
        upsample_argmax, upsample_argmax_sharded,
        upsample_argmax_sharded_plain)
    from segtpu_torch.parallel import halo_exchange
    worst = 0
    for x in (logits, logits.float()):
        full = upsample_argmax(x, (H, W))
        for n in (2, 4, 8):
            rows = H // n
            for s, e in enumerate(halo_exchange(list(x.chunk(n, dim=2)), 1, 1)):
                got = upsample_argmax_sharded(e, (H, W), shard=s, n_shards=n)
                want = upsample_argmax_sharded_plain(e, (H, W), shard=s,
                                                     n_shards=n)
                torch.cuda.synchronize()
                check(got.shape == (N, rows, W) and got.dtype == torch.uint8,
                      f"sharded tail shape {tuple(got.shape)}")
                worst = max(worst, (got.int() - want.int()).abs().max().item())
                check(torch.equal(got, want),
                      f"sharded tail {x.dtype} shard {s}/{n} differs from its "
                      f"plain twin")
                check(torch.equal(got, full[:, s * rows:(s + 1) * rows]),
                      f"sharded tail {x.dtype} shard {s}/{n} differs from the "
                      f"unsharded kernel's rows")
        print(f"[sharded] tail {x.dtype}: every shard at n=2,4,8 bit-identical "
              f"to its twin and to the unsharded rows")
    return worst


def sharded_tail(torch, logits, tail_ms):
    """upsample_argmax_sharded on the tail phase's logits: the checks of
    ``sharded_tail_rows``, then the N_SHARDS shards timed, beside the
    unsharded tail's ``tail_ms`` over N_SHARDS. Returns the kernel's row
    of the kernels line, without its launches."""
    import torch.nn.functional as F
    from segtpu_torch.kernels.upsample_argmax import (
        upsample_argmax_sharded, upsample_argmax_sharded_plain)
    from segtpu_torch.parallel import halo_exchange
    worst = sharded_tail_rows(torch, logits)
    n, rows = N_SHARDS, H // N_SHARDS
    r = dict(max_abs_err=worst, ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0,
             dot=0, f32=0, n=n, per_shard_ms=[])
    for s, e in enumerate(halo_exchange(list(logits.chunk(n, dim=2)), 1, 1)):
        ms = cuda_ms(lambda: upsample_argmax_sharded(
            e, (H, W), shard=s, n_shards=n), 20)
        r["per_shard_ms"].append(ms)
        r["ms"] += ms
        r["plain_ms"] += cuda_ms(lambda: upsample_argmax_sharded_plain(
            e, (H, W), shard=s, n_shards=n), 3)
        r["library_ms"] += cuda_ms(lambda: F.interpolate(
            e.float(), size=(rows, W), mode="bilinear",
            align_corners=True).argmax(1), 10)
        r["bytes"] += e.numel() * e.element_size() + N * rows * W
        # as the unsharded tail's count in bounds(), over the shard's rows
        r["f32"] += N * K * rows * (3 * e.shape[3] + 4 * W)
    print(f"[timing] sharded tail n={n}: per shard "
          f"{[round(v, 4) for v in r['per_shard_ms']]} ms, summed "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
          f"{r['library_ms']:.4f} ms; the unsharded tail over {n}: "
          f"{tail_ms / n:.4f} ms")
    return r


# a shard's bf16 logits against the plain twins' sharded call: worst error
# as a share of the twins' largest logit (measured 1.16-1.20 % on an H100)
SHARD_LOGITS_TOL = 2e-2


def shard_logits_hold(torch, logits_k, want_logits):
    """Each shard's logits of the kernels' sharded call within
    SHARD_LOGITS_TOL of the largest of the plain twins' (bit-identical
    share and worst error as a share of max(|ref|, 1) printed)."""
    for s, (lk, lp) in enumerate(zip(logits_k, want_logits)):
        g, w = lk.float(), lp.float()
        rel = ((g - w).abs() / w.abs().clamp_min(1.0)).max().item()
        of_max = ((g - w).abs().max() / w.abs().max()).item()
        print(f"[sharded] space shard {s} logits {tuple(lk.shape)} vs the "
              f"plain twins': bit-identical={_bits_rate(torch, lk, lp)!r} "
              f"worst={rel!r} worst of the largest={of_max!r}")
        check(of_max <= SHARD_LOGITS_TOL, f"shard {s}: logits differ from "
              f"the plain twins' by {of_max} > {SHARD_LOGITS_TOL} of the "
              f"largest")


def sharded_stem_checks(torch, seg, x):
    """[(what, check())]: each shard's stem launch of an H-sharded b8 call
    (its rows of the space-to-depth planes and, but for the first shard,
    the halo row above them, as mbv2_chw_sharded feeds it), bit for bit
    its twin, and its rows but the halo's the unsharded stem's rows."""
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.parallel import halo_exchange
    n = N_SHARDS
    with torch.inference_mode():
        x12 = normalize_s2d_front(x)
        whole = seg.encoder.stem(x12)
    rows = x12.shape[2] // n
    ext = halo_exchange(list(x12.split(rows, dim=2)), 1, 0, ends=False)
    out = []
    for s_, e in enumerate(ext):
        def run(s_=s_, e=e.contiguous()):
            what = f"sharded stem shard {s_}/{n} {tuple(e.shape)}"
            with torch.inference_mode():
                got = seg.encoder.stem(e)
                _exact(torch, got, seg.encoder.stem(e, False), what)
            top = 1 if s_ > 0 else 0
            check(torch.equal(got[:, :, top:],
                              whole[:, :, s_ * rows:(s_ + 1) * rows]),
                  f"{what}: rows differ from the unsharded stem's")
        out.append((f"sharded stem shard {s_}", run))
    return out


def phase_sharded(torch, seg, ref, frames, masks, gaps, t):
    """Phase 8 (see the module doc). Returns the sharded path's launch
    counts; adds its times to ``t``."""
    from segtpu_torch.engine import Segmenter, ShardedSegmenter
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.models import ARCHS
    from segtpu_torch.models.fast_decoder import decoder_shard_plan
    from segtpu_torch.parallel import make_mesh, make_sharded_infer_fn
    n = N_SHARDS
    devices = [torch.device("cuda", 0)] * n
    x = torch.from_numpy(frames).cuda()
    plan = decoder_shard_plan(ARCHS["arch0"], (H, W), n)
    print(f"[sharded] arch0 {H}x{W} n={n} plan: "
          f"{[b['sharded'] for b in plan['blocks']]}")

    # the sharded path: one space-mode call, counts read around it alone
    space = make_sharded_infer_fn(seg, make_mesh(1, n, devices=devices),
                                  mode="space")
    reset_counts()
    got = space(x)
    launches = read_counts()
    torch.cuda.synchronize()
    print(f"[sharded] space n={n} b8 {H}x{W}: launches={launches}")
    check(launches == SPACE_LAUNCHES,
          f"space-mode launches {launches}, expected {SPACE_LAUNCHES}")
    check(got.shape == (N, H, W) and got.dtype == torch.uint8,
          f"space-mode mask shape {tuple(got.shape)} {got.dtype}")
    rate = float((got.cpu().numpy() == masks).mean())
    print(f"[sharded] space masks vs the unsharded engine: agreement={rate!r}")
    check(rate >= 0.999, f"space-mode agreement {rate} < 99.9 %")
    sh = ShardedSegmenter(seg, devices)
    with torch.inference_mode():
        want_taps = seg.encoder(normalize_s2d_front(x))
    for i, (tap, whole) in enumerate(zip(sh.infer_shards(x, return_taps=True),
                                         want_taps)):
        check(torch.equal(torch.cat(tap, dim=2), whole),
              f"sharded encoder tap {i} differs from the unsharded tap")
    print("[sharded] arch0 encoder taps: 4 bit-equal")
    for _, run in sharded_stem_checks(torch, seg, x):
        run()
    # the tensor-core encoder (not the served route): its taps and the
    # data-mode masks bit-equal too, the plan changing with the rows
    with on_tensor_cores(seg.encoder):
        with torch.inference_mode():
            want_tc = seg.encoder(normalize_s2d_front(x))
            for i, (tap, whole) in enumerate(zip(
                    sh.infer_shards(x, return_taps=True), want_tc)):
                check(torch.equal(torch.cat(tap, dim=2), whole),
                      f"sharded tensor-core encoder tap {i} differs from the "
                      f"unsharded tap")
        data_tc = make_sharded_infer_fn(seg, make_mesh(n, 1, devices=devices),
                                        mode="data")
        check(torch.equal(data_tc(x), torch.as_tensor(
            seg.predict_batch(frames)).to(x.device)),
              "tensor-core encoder: data-mode masks differ from the "
              "unsharded engine's")
    print("[sharded] tensor-core encoder: 4 space taps and the data-mode "
          "masks bit-equal to the unsharded engine's")
    del want_taps, want_tc

    # every launch of the sharded decoder against its twin at this path's
    # shapes: windows of H/n rows plus halo, resize_chw with shard=(s, n, h)
    logits_k, calls = record_decoder(
        torch, sh.decoder, sh.infer_shards(x, return_taps=True))
    seen = {name: 0 for name in DECODER_KERNELS}
    windows = 0
    with torch.inference_mode():
        for i, (name, fn, a) in enumerate(calls):
            check_call(torch, name, fn, a, f"space call {i:2d} {name}"
                       + (f" shard={a['shard']}" if a.get("shard") else ""))
            seen[name] += 1
            windows += bool(a.get("shard"))
    stems = {"conv_chw": n}                 # the encoder's stem, per shard
    check(seen == {name: SPACE_LAUNCHES[name] - stems.get(name, 0)
                   for name in DECODER_KERNELS},
          f"sharded decoder calls compared {seen}, launches {SPACE_LAUNCHES}")
    check(windows == SPACE_LAUNCHES["resize_chw"],
          f"{windows} of the resize_chw calls took a row window")
    print(f"[sharded] decoder calls against their twins: {seen}, "
          f"{windows} row-window resizes")
    del calls

    # the whole sharded call on the plain twins
    ref_sh = ShardedSegmenter(ref, devices)
    with torch.inference_mode():
        want_logits = ref_sh.decoder(ref_sh.infer_shards(x, return_taps=True))
    shard_logits_hold(torch, logits_k, want_logits)
    masks_hold(torch, got, ref_sh.predict(x), gaps, MASK_FLOOR["arch0"],
               f"space n={n} masks vs use_kernels=False")
    del logits_k, want_logits, ref_sh

    # genotypes without a pool branch: masks bit for bit
    rng = np.random.default_rng(8)
    small = rng.integers(0, 256, (2, 512, 1024, 3), dtype=np.uint8)
    for name, genotype, ns in (("arch2", ARCHS["arch2"], (2, 4)),
                               ("no_pool", NO_POOL, (4,))):
        seg_g = Segmenter(make_model(torch, genotype), device="cuda")
        want = seg_g.predict_batch(small)
        for k in ns:
            shards = [b["sharded"] for b in decoder_shard_plan(
                genotype, small.shape[1:3], k)["blocks"]]
            m = ShardedSegmenter(seg_g, devices[:1] * k).predict(small)
            same = bool(np.array_equal(m, want))
            print(f"[sharded] {name} 2x512x1024 n={k} blocks sharded="
                  f"{shards}: bit-equal={same}")
            check(same, f"{name} space masks at n={k} differ from the "
                  f"unsharded engine's")
        if name == "no_pool":
            check(not all(shards), "no block of the pool-free genotype "
                  "computed whole")
        del seg_g

    # batch fan-out: 4 parts of the b8 batch
    data = make_sharded_infer_fn(seg, make_mesh(n, 1, devices=devices),
                                 mode="data")
    reset_counts()
    got_d = data(x)
    data_launches = read_counts()
    torch.cuda.synchronize()
    print(f"[sharded] data {n} parts of b8: launches={data_launches}")
    check(data_launches == DATA_LAUNCHES,
          f"data-mode launches {data_launches}, expected {DATA_LAUNCHES}")
    same_d = got_d.cpu().numpy() == masks
    check(bool(same_d.all()),
          f"data-mode masks differ from the unsharded engine's: agreement "
          f"{float(same_d.mean())!r}, per frame "
          f"{same_d.mean(axis=(1, 2)).tolist()}")
    print("[sharded] data masks: bit-equal")

    t["space_b8"] = cuda_ms(lambda: space(x), 5)
    t["data_b8"] = cuda_ms(lambda: data(x), 5)
    print(f"[timing] {n} logical shards on one card, one after another: "
          f"space {t['space_b8']:.4f} ms, data {t['data_b8']:.4f} ms, "
          f"unsharded {t['slice_b8']:.4f} ms per b8 call")
    return launches, rate


def _experiment_row(err, fn, plain, lib, nbytes, dot, f32, what, old=None,
                    issue=0):
    """A kernel's row of ``work``: times of the kernel, its twin, the
    library yardstick (None where there is none) and, for a redesigned
    kernel, its earlier form (``old``, kept for this A/B: ``old_ms``), each
    over a ~25 ms window, all timed alike: in turns, kernel, twin, library,
    old, then back, each arm's lower time kept. ``issue``: f32
    instructions of a kernel that may fuse nothing (``bounds()``)."""
    from segtpu_torch.scripts import cuda_ms as adaptive_ms, turns_ms
    arms = {"ms": fn, "plain_ms": plain}
    if lib is not None:
        arms["library_ms"] = lib
    if old is not None:
        arms["old_ms"] = old
    r = dict(max_abs_err=err, library_ms=None, bytes=nbytes, dot=dot,
             f32=f32, issue=issue, n=1)
    r.update(turns_ms(arms, adaptive_ms))
    print(f"[timing] {what}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"library {r['library_ms']!r} ms"
          + (f", v1 kernel {r['old_ms']:.4f} ms" if old is not None else ""))
    return r


def tap_checks(torch):
    """[(what, run)] of the tap loop's exact checks: dw_tap_sum against
    its plain twin, bit for bit, at every tap and roll case of
    exp_vpu_floor and every chip form (TAP_FORMS: C = 1, k = 9 and 15, rows
    that end inside a strip, w = 8, the sign form), on seeded inputs made
    in the run."""
    from segtpu_torch.kernels.vpu_floor import dw_tap_sum, dw_tap_sum_plain
    from segtpu_torch.scripts import bits_equal, exp_vpu_floor as ev
    cases = [case + (False,) for case in ev.TAP_CASES + ev.ROLL_CASES]
    out = []
    for c, k, dil, w, rows, sign in cases + list(ev.TAP_FORMS):
        what = (f"dw_tap_sum C={c} k={k} dil={dil} w={w} rows={rows}"
                + (" sign" if sign else ""))

        def run(c=c, k=k, dil=dil, w=w, rows=rows, sign=sign, what=what):
            x, wt = ev.tap_inputs(c, k, dil, w, rows, ev.TAP_GRID, "cuda",
                                  seed=12, sign=sign)
            kw = dict(k=k, dilation=dil, w=w)
            got = dw_tap_sum(x, wt, **kw)
            torch.cuda.synchronize()
            same = bits_equal(got, dw_tap_sum_plain(x, wt, **kw))
            print(f"[experiments] {what}: bit-identical={same}")
            check(same, f"{what} differs from its twin")
        out.append((what, run))
    return out


def clf_tail_checks(torch):
    """[(what, run)] of the fused tail's exact checks: the mask of
    clf_upsample_argmax against its plain twin's, bit for bit, at the
    script's sizes (b8, 48 channels, 256x512 -> 1024x2048, K = 19) and
    every chip form (exp_tail_flat.TAIL_FORMS: K = 1, 3, 21, 150; C = 8,
    64; 1000x2000; 720x1280; w = 8; B = 1), classes in range."""
    from segtpu_torch.kernels.tail_flat import (clf_upsample_argmax,
                                                clf_upsample_argmax_plain)
    from segtpu_torch.scripts import bits_equal, exp_tail_flat as et
    out = []
    for b, cin, h, w, k, ho, wo in ((N, 48, H // 4, W // 4, K, H, W),) \
            + et.TAIL_FORMS:
        what = f"clf_upsample_argmax b{b} {cin}ch {h}x{w} -> {ho}x{wo} K={k}"

        def run(b=b, cin=cin, h=h, w=w, k=k, ho=ho, wo=wo, what=what):
            feat, wclf, bclf = et.tail_inputs(b, cin, h, w, k, "cuda")
            got = clf_upsample_argmax(feat, wclf, bclf, (ho, wo))
            torch.cuda.synchronize()
            same = bits_equal(got, clf_upsample_argmax_plain(feat, wclf, bclf,
                                                             (ho, wo)))
            print(f"[experiments] {what}: bit-identical={same}")
            check(got.shape == (b, ho, wo) and int(got.max()) < k,
                  f"{what}: shape {tuple(got.shape)} or class out of range")
            check(same, f"{what} differs from its plain twin")
        out.append((what, run))
    return out


def phase_experiments(torch):
    """Phase 9 (see the module doc). Returns the experiments' launch
    counts, their kernels' rows of ``work`` and the scripts' results."""
    import importlib
    from segtpu_torch.kernels.front_ab import (
        front_single_round, front_single_round_plain, normalize_s2d_nhwc,
        normalize_s2d_nhwc_plain)
    from segtpu_torch.kernels.tail_flat import (clf_upsample_argmax,
                                                clf_upsample_argmax_plain,
                                                clf_upsample_argmax_v1)
    from segtpu_torch.kernels.vpu_floor import (dw_tap_sum, dw_tap_sum_plain,
                                                dw_tap_sum_v1, fma_peak,
                                                fma_peak_plain)
    from segtpu_torch.scripts import bits_equal, exp_tail_flat, exp_vpu_floor

    # each script's run, the counts read around it alone
    launches, results = {}, {}
    for script, names in EXPERIMENT_KERNELS.items():
        mod = importlib.import_module(f"segtpu_torch.scripts.{script}")
        reset_counts()
        t0 = time.perf_counter()
        results[script] = mod.run()
        counts = read_counts()
        print(f"[experiments] {script}: {time.perf_counter() - t0:.1f} s, "
              f"launches { {n: counts[n] for n in names} }")
        check(all(counts[n] > 0 for n in names),
              f"{script} did not launch each of {names}: {counts}")
        stray = [n for n in EXPERIMENT_ONLY if n not in names and counts[n]]
        check(not stray, f"{script} launched another script's kernel: {stray}")
        launches.update({n: counts[n] for n in names})

    work = {}
    # fma_peak: every peak case, rel 1e-5; the row at the script's
    # default chains, (n_fma, n_acc) = (256, 4)
    g = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn(exp_vpu_floor.PEAK_SHAPE, generator=g, device="cuda")
    errs = {}
    for n_fma, n_acc in exp_vpu_floor.PEAK_CASES:
        got = fma_peak(x, n_fma=n_fma, n_acc=n_acc)
        want = fma_peak_plain(x, n_fma=n_fma, n_acc=n_acc)
        torch.cuda.synchronize()
        rel = exp_vpu_floor.rel_err(got, want)
        errs[n_fma, n_acc] = (got - want).abs().max().item()
        print(f"[experiments] fma_peak n_fma={n_fma} n_acc={n_acc}: max rel "
              f"err {rel!r}, max abs err {errs[n_fma, n_acc]!r}")
        check(rel <= exp_vpu_floor.PEAK_RTOL,
              f"fma_peak {n_fma}/{n_acc}: relative error {rel} > 1e-5")
    work["fma_peak"] = _experiment_row(
        errs[256, 4], lambda: fma_peak(x, n_fma=256, n_acc=4),
        lambda: fma_peak_plain(x, n_fma=256, n_acc=4), None,
        2 * x.numel() * 4, 0, exp_vpu_floor.peak_flops(x.numel(), 256, 4),
        f"fma_peak {tuple(x.shape)} n_fma=256 n_acc=4")
    del x, got, want

    # dw_tap_sum: every tap and roll case and every chip form bit for bit;
    # the row at the first case, (C, k, dil) = (48, 3, 1), beside the v1
    # kernel; the scripts' runs time every case and form in turns
    for _, run in tap_checks(torch):
        run()
    c, k, dil, w, rows = exp_vpu_floor.TAP_CASES[0]
    x, wt = exp_vpu_floor.tap_inputs(c, k, dil, w, rows,
                                     exp_vpu_floor.TAP_GRID, "cuda", seed=12)
    kw = dict(k=k, dilation=dil, w=w)
    want = dw_tap_sum_plain(x, wt, **kw)
    tap_lib, lib_out = exp_vpu_floor.tap_library(x, wt, k, dil, w)
    lib_err = (lib_out(tap_lib()) - want).abs().max().item()
    check(lib_err <= exp_vpu_floor.LIB_RTOL * want.abs().max().item(),
          f"the tap loop's grouped-conv yardstick differs by {lib_err}")
    work["dw_tap_sum"] = _experiment_row(
        0.0, lambda: dw_tap_sum(x, wt, **kw),
        lambda: dw_tap_sum_plain(x, wt, **kw), tap_lib,
        x.numel() * 2 + wt.numel() * 4 + want.numel() * 4, 0, 0,
        f"dw_tap_sum {tuple(x.shape)} C={c} k={k} dil={dil}",
        old=lambda: dw_tap_sum_v1(x, wt, **kw),
        issue=exp_vpu_floor.tap_ops(c, k, dil, w, rows,
                                    exp_vpu_floor.TAP_GRID))
    del x, want
    forms = {"dw_tap_sum": exp_vpu_floor.run(which="forms")["forms"],
             "clf_upsample_argmax": exp_tail_flat.run_forms()["forms"]}

    # the two front variants on the 8x1024x2048 batch, bit for bit
    g = torch.Generator(device="cuda").manual_seed(13)
    img = torch.randint(0, 256, (N, H, W, 3), generator=g, device="cuda",
                        dtype=torch.uint8)
    front_bytes = N * H * W * 3 + N * 12 * (H // 2) * (W // 2) * 2
    for name, fn, plain in (
            ("front_single_round", front_single_round, front_single_round_plain),
            ("normalize_s2d_nhwc", normalize_s2d_nhwc, normalize_s2d_nhwc_plain)):
        got = fn(img)
        torch.cuda.synchronize()
        same = bits_equal(got, plain(img))
        print(f"[experiments] {name} {tuple(got.shape)}: bit-identical={same}")
        check(same, f"{name} differs from its plain twin")
        work[name] = _experiment_row(
            0.0, lambda: fn(img), lambda: plain(img), None, front_bytes,
            0, 2 * N * 12 * (H // 2) * (W // 2), f"{name} {tuple(img.shape)}")
    del img, got

    # the classifier-fused tail at the script's sizes and every chip form,
    # bit for bit; the row at the script's sizes beside the v1 kernel
    for _, run in clf_tail_checks(torch):
        run()
    b, cin, h, w, k = N, 48, H // 4, W // 4, K
    feat, wclf, bclf = exp_tail_flat.tail_inputs(b, cin, h, w, k, "cuda")
    got = clf_upsample_argmax(feat, wclf, bclf, (H, W))
    agree = (exp_tail_flat.library(feat, wclf, bclf, (H, W)) == got).float(
        ).mean().item()
    print(f"[experiments] clf_upsample_argmax {tuple(feat.shape)} -> "
          f"{tuple(got.shape)}: mask agreement with the library yardstick "
          f"{agree!r}")
    work["clf_upsample_argmax"] = _experiment_row(
        0.0, lambda: clf_upsample_argmax(feat, wclf, bclf, (H, W)),
        lambda: clf_upsample_argmax_plain(feat, wclf, bclf, (H, W)),
        lambda: exp_tail_flat.library(feat, wclf, bclf, (H, W)),
        *exp_tail_flat.tail_work(b, cin, h, w, k, H, W),
        f"clf_upsample_argmax {tuple(feat.shape)}",
        old=lambda: clf_upsample_argmax_v1(feat, wclf, bclf, (H, W)))
    # the CUDA-core floor the twin's channel-order sum forces, beside the
    # bound
    work["clf_upsample_argmax"].update(
        floor_ms=exp_tail_flat.tail_floor(b, cin, h, w, k, H, W)["f32 issue"],
        floor_by="f32 issue")
    results["forms"] = forms
    return launches, work, results


def conv_work(x_shape, cout: int, k: int, depthwise: bool, elt: int):
    """(bytes, dot flops, f32 flops) a conv_chw call must move and do:
    x read once, the weight and bias read once, the output written
    once; dense products count as dot flops, depthwise as f32 flops."""
    b, c, h, w = x_shape
    wbytes = (c * k * k * 4) if depthwise else (cout * c * k * k * elt)
    nbytes = b * c * h * w * elt + wbytes + cout * 4 + b * cout * h * w * elt
    flops = 2 * b * cout * h * w * k * k * (1 if depthwise else c)
    return (nbytes, 0, flops) if depthwise else (nbytes, flops, 0)


def inv_res_work(x_shape, cmid: int, cout: int, stride: int, expand: bool,
                 elt: int):
    """(bytes, dot flops, f32 flops) of one fused block: x read once,
    weights once, the output written once (the expanded tensor never
    leaves the chip); expand and project are dot flops, the 3x3
    depthwise f32 flops."""
    b, cin, h, w = x_shape
    ho, wo = h // stride, w // stride
    wbytes = ((cmid * cin * elt + cmid * 4) if expand else 0) \
        + cmid * 10 * 4 + cout * cmid * elt + cout * 4
    nbytes = b * cin * h * w * elt + wbytes + b * cout * ho * wo * elt
    dot = 2 * b * (h * w * cin * cmid if expand else 0) \
        + 2 * b * ho * wo * cmid * cout
    return nbytes, dot, 2 * b * ho * wo * cmid * 9


def bounds(work):
    """Least time for the card (``segtpu_torch.scripts.bound_ms``): the
    largest of the bytes over the HBM rate, the dot products over the
    bf16 tensor-core peak, the other f32 arithmetic over the f32
    CUDA-core peak and the f32 instructions of a kernel that may fuse
    nothing (``issue``) over the issue rate (separate pipes, so they can
    overlap). ``work`` holds the encoder and decoder kernels' bytes and
    operations summed over their measured launches."""
    from segtpu_torch.scripts import bound_ms
    hp2, wp2 = H // 2, W // 2
    front_bytes = N * H * W * 3 + N * 12 * hp2 * wp2 * 2
    front_ops = N * 12 * hp2 * wp2 * 2                   # one mul, one add
    h, w = H // 4, W // 4
    tail_bytes = N * K * h * w * 2 + N * H * W
    # H pass shared by the output columns: 2 mul + 1 add per (row, input
    # column); W pass: 2 mul + 1 add per output pixel; 1 compare each
    tail_ops = N * K * H * (3 * w + 4 * W)
    work = dict(work)
    work["front"] = dict(bytes=front_bytes, dot=0, f32=front_ops)
    work["upsample_argmax"] = dict(bytes=tail_bytes, dot=0, f32=tail_ops)
    return {name: bound_ms(r["bytes"], r["dot"], r["f32"], r.get("issue", 0))
            for name, r in work.items()}


# name: (source under segtpu_torch/csrc, the TPU kernel it replaces)
KERNEL_ROWS = {
    "front": ("front.cu", "segtpu/kernels/front.py:80"),
    "conv_chw": ("conv_chw.cu", "segtpu/kernels/chw_ops.py:731"),
    "inv_res_chw": ("inv_res.cu", "segtpu/kernels/chw_ops.py:1101"),
    "inv_res_s2_chw": ("inv_res.cu", "segtpu/kernels/chw_ops.py:1345"),
    "pw_chain_chw": ("pointwise.cu", "segtpu/kernels/chw_ops.py:367"),
    "pw_multi_chw": ("pointwise.cu", "segtpu/kernels/chw_ops.py:285"),
    "resize_chw": ("resize.cu", "segtpu/kernels/resize_chw.py:100"),
    "sep_conv_chw": ("cell.cu", "segtpu/kernels/chw_ops.py:853"),
    "pair_op_chw": ("cell.cu", "segtpu/kernels/chw_ops.py:908"),
    "cell_op_chw": ("cell.cu", "segtpu/kernels/chw_ops.py:1760"),
    "upsample_argmax": ("upsample_argmax.cu",
                        "segtpu/kernels/upsample_argmax.py:221"),
    "upsample_argmax_flat": ("upsample_argmax.cu",
                             "segtpu/kernels/upsample_argmax.py:413"),
    "upsample_argmax_sharded": ("upsample_argmax.cu",
                                "segtpu/kernels/upsample_argmax.py:276"),
    "fma_peak": ("vpu_floor.cu", "scripts/exp_vpu_floor.py:56"),
    # _tap_kernel, and _tap_kernel_roll (:126), the same function
    "dw_tap_sum": ("vpu_floor.cu", "scripts/exp_vpu_floor.py:87"),
    "front_single_round": ("front_ab.cu", "scripts/exp_front_kernel.py:38"),
    "normalize_s2d_nhwc": ("front_ab.cu", "scripts/ab_normalize.py:58"),
    "clf_upsample_argmax": ("tail_flat.cu", "scripts/exp_tail_flat.py:38"),
}
SHARDED_ONLY = ("upsample_argmax_sharded",)
SCRIPT_OF = {n: s for s, ns in EXPERIMENT_KERNELS.items() for n in ns}


@contextlib.contextmanager
def coarse_decoder(torch, bits: int):
    """A control: the kernels held to their twins at a tolerance or bit
    for bit made wrong on purpose, each output rounded once more to
    ``bits`` significant bits (bf16 keeps 8): up to 2^-bits of the value,
    on about half the elements at bits = 7, where the tensor-core kernels
    differ from their twins by one rounding on a few elements in a
    thousand. The node, 1x1 and inverted-residual kernels (``cell.cu``,
    ``pointwise.cu``, ``inv_res.cu``, the tensor-core and the CUDA-core
    ones), conv_chw's dense kernels (k = 1, the stem's k = 2, and k = 3
    and 5 at any dilation, which the template forms reach) and
    resize_chw's kernel, in bf16 and f32; and the tail kernel's input, a
    rounded copy of the logits, so that its masks are those of other
    logits, and so of the H-sharded and W-first tails' launches. The
    experiments' dw_tap_sum output is rounded likewise, and the last byte
    of the fused classifier tail's mask has its low bit flipped (its K = 1
    masks are all zero whatever the input)."""
    import importlib
    from segtpu_torch.kernels import chw_ops
    rz = importlib.import_module("segtpu_torch.kernels.resize_chw")
    ua = importlib.import_module("segtpu_torch.kernels.upsample_argmax")

    def coarsen(out):
        m, e = torch.frexp(out.float())
        out.copy_(torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e))
        return out

    def coarse(launch):
        def run(*args, **kw):
            return coarsen(launch(*args, **kw))
        return run

    def coarse_conv(launch):
        def run(x, w, bias, acc, vec_acc, k, dilation, depthwise, act):
            out = launch(x, w, bias, acc, vec_acc, k, dilation, depthwise,
                         act)
            return out if depthwise else coarsen(out)
        return run

    def coarse_tail(launch):
        def run(logits, *args):
            return launch(coarsen(logits.clone()), *args)
        return run

    def flip_last(launch):
        def run(*args):
            out = launch(*args)
            out.view(-1)[-1:] ^= 1
            return out
        return run

    patches = [(chw_ops, n, coarse) for n in (
        "_node_launch", "_pw_launch", "_inv_res_tc_launch", "_inv_res_launch")]
    patches += [(chw_ops, "_conv_launch", coarse_conv),
                (rz, "_resize_launch", coarse)]
    patches += [(ua, n, coarse_tail) for n in
                ("_tail_launch", "_sharded_launch", "_flat_launch")]
    vf = importlib.import_module("segtpu_torch.kernels.vpu_floor")
    tf = importlib.import_module("segtpu_torch.kernels.tail_flat")
    patches += [(vf, "_tap_launch", coarse), (tf, "_clf_launch", flip_last)]
    saved = [(mod, n, getattr(mod, n)) for mod, n, _ in patches]
    for mod, n, make in patches:
        setattr(mod, n, make(getattr(mod, n)))
    try:
        yield
    finally:
        for mod, n, f in saved:
            setattr(mod, n, f)


@contextlib.contextmanager
def on_tensor_cores(enc, blocks=None):
    """Every block of the folded bf16 encoder ``enc`` (or those of the
    indices ``blocks``) on the tensor-core kernel (``tc_block``), until the
    context ends; the rest, and every block without kernels, as served."""
    chosen = [blk for i, blk in enumerate(enc.blocks)
              if blocks is None or i in blocks]
    for blk in chosen:
        blk.forward = tc_block(blk)
    try:
        yield
    finally:
        for blk in chosen:
            del blk.forward


def must_fail(what, fn) -> bool:
    """Runs a check that a control must fail; True when it failed."""
    try:
        fn()
    except SystemExit:
        print(f"[control] {what}: fails, as it must")
        return True
    print(f"[control] {what}: PASSES on the control")
    return False


def phase_control(torch, bits: int) -> dict:
    """``--control BITS``: the checks that hold the tensor-core kernels
    at a tolerance, those that hold conv_chw's k = 1 and 2, resize_chw,
    the tail and the served inverted residual bit for bit, and the
    template path's checks against the twins, run with
    ``coarse_decoder(bits)``: each must fail. Returns {check: failed}."""
    from segtpu_torch.engine import Segmenter, ShardedSegmenter
    from segtpu_torch.models import ARCHS
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.models.fast_encoder import fold_encoder
    res = {}
    # G2's decoder logits as phase 5 makes them, before the control: the
    # control's own decoder rounds them to BITS bits already, and rounding
    # them once more (the flat tail's control) would change nothing
    *_, g2_logits, g2_calls = decoder_calls(torch, G2, (H2, W2),
                                            torch.bfloat16, N)
    del g2_calls
    with coarse_decoder(torch, bits):
        # phase 4's block stages on phase 2's frames, each fed the last
        g = torch.Generator(device="cuda").manual_seed(1)
        img = torch.randint(0, 256, (N, H, W, 3), generator=g, device="cuda",
                            dtype=torch.uint8)
        enc = fold_encoder(make_model(torch).encoder,
                           torch.bfloat16).to("cuda")
        y = normalize_s2d_front(img)
        with torch.inference_mode():
            for i, (name, fn, _, _, tc) in enumerate(encoder_stages(enc)):
                if tc is not None:
                    res[f"stage {i:2d} {name} tensor cores vs its twin"] = \
                        must_fail(f"stage {i:2d} {name} tensor cores",
                                  lambda: _compare(torch, tc(y), fn(y, False),
                                                   f"stage {i}"))
                res[f"stage {i:2d} {name} vs its twin"] = must_fail(
                    f"stage {i:2d} {name}", lambda: _exact(
                        torch, fn(y, True), fn(y, False), f"stage {i}"))
                y = fn(y, True)
            # the f32 stages, phase 4's inverted-residual forms (the served
            # kernel's) and the stem's and the tail's, the stem on a shard's
            # window, phase 3's tail cases
            enc32 = fold_encoder(make_model(torch).encoder,
                                 torch.float32).to("cuda")
            y = normalize_s2d_front(img[:2, :128, :256].contiguous(),
                                    out_dtype=torch.float32)
            for i, (name, fn, *_) in enumerate(encoder_stages(enc32)):
                what = f"f32 stage {i:2d} {name}"
                res[f"{what} vs its twin"] = must_fail(what, lambda: _exact(
                    torch, fn(y, True), fn(y, False), what))
                y = fn(y, True)
            for what, run in inv_res_forms(torch, tensor_cores=False):
                res[f"form {what} vs its twin"] = must_fail(what, run)
            for what, fn in stem_tail_forms(torch):
                res[f"form {what} vs its twin"] = must_fail(
                    what, lambda: _exact(torch, fn(True), fn(False), what))
            for what, run in stem_window_checks(torch):
                res[f"{what} vs its twin and the whole rows"] = must_fail(
                    what, run)
            g = torch.Generator(device="cuda").manual_seed(2)
            logits = torch.randn((N, K, H // 4, W // 4), generator=g,
                                 device="cuda").to(torch.bfloat16)
            for what, fn in tail_cases(torch, logits) + window_flat_forms(
                    torch):
                res[f"{what} vs its twin"] = must_fail(
                    what, lambda: _exact(torch, fn(True), fn(False), what))
            res["sharded tail vs the unsharded kernel's rows"] = must_fail(
                "sharded tail rows", lambda: sharded_tail_rows(torch, logits))
            # phase 9's exact checks of the two redesigned experiment
            # kernels, every case and form
            for what, run in tap_checks(torch) + clf_tail_checks(torch):
                res[f"{what} vs its twin"] = must_fail(what, run)
        del enc, enc32, y, img, logits
        model, dec, img, taps, logits, calls = decoder_calls(
            torch, ARCHS["arch0"], (H, W), torch.bfloat16, N)
        res["tensor-core encoder vs the f32 cuDNN run, against the twins'"] = \
            must_fail("tensor-core encoder", lambda: check_encoder_reference(
                torch, model, dec, img))
        with torch.inference_mode():
            for i, (name, fn, a) in enumerate(calls):
                if name in ("sep_conv_chw", "cell_op_chw", "pw_chain_chw") \
                        or exact_call(name, a):
                    res[f"main call {i:2d} {name} vs its twin"] = must_fail(
                        f"main call {i:2d} {name}",
                        lambda: check_call(torch, name, fn, a, f"call {i}"))
        res["logits and masks vs the f32 cuDNN run"] = must_fail(
            "f32 reference", lambda: check_library_reference(
                torch, model, dec, img, taps, logits))
        del calls, taps, logits
        # the bit-exact checks of conv_chw's k = 1 and resize_chw: G2's
        # calls, every f32 call, the forms
        from segtpu_torch.models import ARCHS as _A
        for path, genotype, hw, dtype, batch in (
                ("G2", G2, (H2, W2), torch.bfloat16, N),
                ("f32 arch0", _A["arch0"], (128, 256), torch.float32, 2),
                ("f32 G2", G2, (128, 128), torch.float32, 2)):
            *_, logits, calls = decoder_calls(torch, genotype, hw, dtype,
                                              batch)
            with torch.inference_mode():
                for i, (name, fn, a) in enumerate(calls):
                    if exact_call(name, a):
                        what = f"{path} call {i:2d} {name}"
                        res[f"{what} vs its twin"] = must_fail(
                            what, lambda: check_call(torch, name, fn, a, what))
                if path == "G2":
                    for what, run in flat_tail_checks(torch, g2_logits):
                        res[f"{what} vs its twin"] = must_fail(what, run)
            del calls, logits
        with torch.inference_mode():
            for what, fn in exact_forms(torch):
                res[f"form {what} vs its twin"] = must_fail(
                    what, lambda: _exact(torch, fn(True), fn(False), what))
        frames = np.random.default_rng(3).integers(0, 256, (N, H, W, 3),
                                                   dtype=np.uint8)
        for name, genotype, fr in (("arch0", ARCHS["arch0"], frames),
                                   ("G2", G2, frames[:, :H2, :W2].copy())):
            model = make_model(torch, genotype)
            seg = Segmenter(model, device="cuda")
            ref = Segmenter(model, device="cuda", use_kernels=False)
            x = torch.from_numpy(fr).cuda()
            gaps = tie_gaps(torch, ref, x)
            res[f"{name} b8 masks vs use_kernels=False"] = must_fail(
                f"{name} masks", lambda: masks_hold(
                    torch, seg.predict_batch(fr), ref.predict_batch(fr),
                    gaps, MASK_FLOOR[name], f"control {name} b8 masks"))
            if name != "arch0":
                continue
            devices = [torch.device("cuda", 0)] * N_SHARDS
            sh, ref_sh = (ShardedSegmenter(e, devices) for e in (seg, ref))
            with torch.inference_mode():
                got = sh.decoder(sh.infer_shards(x, return_taps=True))
                want = ref_sh.decoder(ref_sh.infer_shards(x,
                                                          return_taps=True))
            res["space shard logits vs the plain twins"] = must_fail(
                "space logits", lambda: shard_logits_hold(torch, got, want))
            del got, want
            for what, run in sharded_stem_checks(torch, seg, x):
                res[f"{what} vs its twin"] = must_fail(what, run)
            # the sharded decoder's conv_chw k = 1 and resize_chw calls
            _, calls = record_decoder(torch, sh.decoder,
                                      sh.infer_shards(x, return_taps=True))
            with torch.inference_mode():
                for i, (name, fn, a) in enumerate(calls):
                    if exact_call(name, a):
                        what = f"space call {i:2d} {name}"
                        res[f"{what} vs its twin"] = must_fail(
                            what, lambda: check_call(torch, name, fn, a, what))
            del calls, sh, ref_sh
    res.update(template_control(torch, frames, bits))
    res.update(handoff_control(torch, frames, bits))
    res.update(search_control(torch, bits))
    res.update(supernet_control(torch, bits))
    res.update(data_parallel_control(torch))
    res.update(fidelity_control(torch))
    res.update(space_control(torch))
    return res


def template_control(torch, frames, bits: int) -> dict:
    """The control's template checks: template0's b8 decoder calls
    against their twins, its masks on the b8 ``frames`` against its
    use_kernels=False run, the decoder calls of its space call, and every
    check of ``template_forms``, run inside ``coarse_decoder(bits)``. The
    decoder calls are recorded before the rounding, as G2's logits are:
    recorded under it, a resize of a map that is constant per channel
    (a 1x1 of the pool op's broadcast) reads values rounded already, and
    its output, rounded again, does not move. Returns {check: failed}."""
    from segtpu_torch.engine import Segmenter, ShardedSegmenter
    from segtpu_torch.models import TEMPLATE_ARCHS
    t0, res = TEMPLATE_ARCHS["template0"], {}
    main = [(f"{w} vs its twin", run) for w, _, run in template_call_checks(
        torch, t0, (H, W), torch.bfloat16, N, "template0 main")]
    forms = template_forms(torch)
    model = make_model(torch, t0, TEMPLATE_SEED)
    seg = Segmenter(model, device="cuda")
    ref = Segmenter(model, device="cuda", use_kernels=False)
    x = torch.from_numpy(frames).cuda()
    gaps = tie_gaps(torch, ref, x)
    sh = ShardedSegmenter(seg, [torch.device("cuda", 0)] * N_SHARDS)
    _, calls = record_decoder(torch, sh.decoder,
                              sh.infer_shards(x, return_taps=True))
    space = [(f"template0 space call {i:2d} {name} vs its twin",
              lambda name=name, fn=fn, a=a, i=i: check_call(
                  torch, name, fn, a, f"template0 space call {i:2d} {name}"))
             for i, (name, fn, a) in enumerate(calls)]
    with coarse_decoder(torch, bits):
        with torch.inference_mode():
            for what, run in main + space:
                res[what] = must_fail(what, run)
        res["template0 b8 masks vs use_kernels=False"] = must_fail(
            "template0 masks", lambda: masks_hold(
                torch, seg.predict_batch(frames), ref.predict_batch(frames),
                gaps, MASK_FLOOR["template0"], "control template0 b8 masks"))
        for what, run in forms:
            res[what] = must_fail(what, run)
    return res


# ------------------------------------------------------------------ train
#
# Phase 10: proxy training on the port, arch0 at full width with aux heads
# as run_training builds it, TrainConfig's defaults, at its 16x512x512
# crop, then the hand-off of the trained weights to the served engine.

TRAIN_SEED = 12
PARITY_N = 2
TRAIN_WARMUP, TRAIN_STEPS, STAGE1_STEPS = 2, 10, 5
# card against CPU, one step from the same weights (cuDNN's backward is not
# deterministic, and sums in another order than PyTorch's CPU convolutions);
# parameters and running stats as a share of max(|leaf|, 1)
PARITY_TOL = {"loss": 1e-4, "norm": 1e-3, "param": 1e-4, "stats": 1e-4}
# a group's gradient norm from random init moves by up to 3.1e-3 on the
# CPU when only the images move by one rounding (arch0, 2x512x512, the
# encoder's; 1.1e-3 the decoder's): the norm is held to
# max(PARITY_TOL["norm"], NORM_SPREAD x that spread, measured here), up
# to 2.5e-2 there
NORM_SPREAD = 8


@contextlib.contextmanager
def tf32(torch, conv: bool):
    """cuDNN's TF32 switch, with cuBLAS's off (PyTorch's default), both
    restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = conv
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def dims(batch) -> str:
    """"NxHxW" of a batch's images."""
    n, h, w, _ = batch["image"].shape
    return f"{n}x{h}x{w}"


@contextlib.contextmanager
def cpu_f32_convolutions(torch):
    """PyTorch's own CPU convolutions: oneDNN's f32 backward loses up to
    10 % on some weight gradients on a CPU with AMX."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = was


def train_batch(seed: int = 21):
    """TrainConfig's batch (batch_size crops of crop_size) of f32 normal
    images (the loaders' normalized NHWC) and labels of K classes with a
    band of 255 (ignored)."""
    cfg = train_config()
    n, (h, w) = cfg.batch_size, cfg.crop_size
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((n, h, w, 3), dtype=np.float32)
    label = rng.integers(0, K, (n, h, w)).astype(np.int32)
    label[:, h * 25 // 64:h * 29 // 64] = 255
    return {"image": image, "label": label}


def train_model(torch):
    """arch0 with aux heads, as run_training builds it, on the CPU."""
    from segtpu_torch.models import ARCHS, create_segmenter
    gen = torch.Generator().manual_seed(TRAIN_SEED)
    return create_segmenter(ARCHS["arch0"], K, aux=True, device="cpu",
                            generator=gen)


def train_config():
    from segtpu_torch.train import TrainConfig
    return TrainConfig(num_classes=K)


def train_setup(torch, model):
    """(state, step): make_train_step with TrainConfig's defaults (both
    SGD groups, clips, aux weight, Polyak) on ``model``'s device."""
    from segtpu_torch.engine.trainer import init_train_state, make_train_step
    from segtpu_torch.utils.solvers import create_optimisers
    cfg = train_config()
    opt = create_optimisers(
        enc_lr=cfg.enc_lr, dec_lr=cfg.dec_lr, enc_wd=cfg.enc_wd,
        dec_wd=cfg.dec_wd, enc_grad_clip=cfg.enc_grad_clip,
        dec_grad_clip=cfg.dec_grad_clip)
    return (init_train_state(model, opt, do_polyak=cfg.do_polyak),
            make_train_step(model.genotype, opt, num_classes=K,
                            aux_weight=cfg.aux_weight))


def one_step(torch, model, batch):
    """(loss, group norms, params, stats) after one step of ``model``."""
    state, step = train_setup(torch, model)
    state, loss = step(state, batch)
    return (float(loss), {g: float(n) for g, n in state.grad_norms.items()},
            state.params, state.stats)


def train_parity(torch, batch):
    """Phase 10.1: one step on the card and on the CPU from the same
    weights on PARITY_N images, TF32 off; the CPU's own spread is the step
    on the images one rounding apart."""
    import copy
    small = {k: v[:PARITY_N] for k, v in batch.items()}
    rng = np.random.default_rng(22)
    moved = dict(small, image=(small["image"] * (1.0 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], small["image"].shape))).astype(np.float32))
    cpu_model = train_model(torch)
    spread_model = copy.deepcopy(cpu_model)
    card_model = copy.deepcopy(cpu_model).cuda()
    with tf32(torch, False):
        loss_g, norms_g, params_g, stats_g = one_step(torch, card_model, small)
    with cpu_f32_convolutions(torch):
        loss_c, norms_c, params_c, stats_c = one_step(torch, cpu_model, small)
        _, norms_s, _, _ = one_step(torch, spread_model, moved)
    worst = {"loss": abs(loss_g - loss_c) / abs(loss_c)}
    for g in norms_c:
        rel = abs(norms_g[g] - norms_c[g]) / norms_c[g]
        spread = abs(norms_s[g] - norms_c[g]) / norms_c[g]
        tol = max(PARITY_TOL["norm"], NORM_SPREAD * spread)
        print(f"[train] parity {g} gradient norm: card {norms_g[g]!r} CPU "
              f"{norms_c[g]!r} rel {rel!r} (CPU spread {spread!r}, tol "
              f"{tol!r})")
        check(rel <= tol, f"{g} gradient norm card vs CPU rel {rel} > {tol}")
        worst[f"norm_{g}"] = rel
    # each leaf's worst difference as a share of max(|leaf|, 1): a
    # BatchNorm's running mean after a zero-mean input is ~0 itself, and
    # its features' unit scale is what a difference is seen against
    for key, got, want in (("param", params_g, params_c),
                           ("stats", stats_g, stats_c)):
        worst[key], worst[f"{key}_leaf"] = max(
            (((got[n].detach().cpu() - t.detach()).abs().max()
              / t.detach().abs().max().clamp_min(1.0)).item(), n)
            for n, t in want.items())
    print(f"[train] parity card vs CPU, one step {dims(small)}, "
          f"TF32 off: loss {loss_g!r} vs {loss_c!r}; worst {worst}")
    for key in ("loss", "param", "stats"):
        check(worst[key] <= PARITY_TOL[key],
              f"card vs CPU {key}: {worst[key]} > {PARITY_TOL[key]}")
    return worst


def run_train(torch, gbatch, warmup: int, steps: int):
    """(state, losses, ms a step, peak bytes): make_train_step on a new
    seeded model on the card, ``warmup`` steps and then ``steps`` timed
    with CUDA events, the serving kernels' counts read around them."""
    state, step = train_setup(torch, train_model(torch).cuda())
    losses = []
    for _ in range(warmup):
        state, loss = step(state, gbatch)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        state, loss = step(state, gbatch)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    launched = {n: c for n, c in read_counts().items() if c}
    check(not launched, f"the train step launched serving kernels: {launched}")
    ms = start.elapsed_time(end) / max(steps, 1)
    return state, [float(x) for x in losses], ms, \
        torch.cuda.max_memory_allocated()


def falls(losses, what):
    check(all(np.isfinite(losses)), f"{what}: a loss is not finite: {losses}")
    check(losses[-1] < losses[0], f"{what}: the loss did not fall: {losses}")


def train_stage1(torch, model, gbatch):
    """Phase 10.3: the encoder's taps cached once, then the decoder alone
    over them (make_decoder_train_step, TrainConfig's decoder group as one
    chain), timed as phase 10.2; the encoder untouched."""
    import copy
    from segtpu_torch.engine.trainer import (init_train_state,
                                             make_decoder_train_step,
                                             make_encoder_cache_fn)
    from segtpu_torch.utils.solvers import sgd_chain
    model = copy.deepcopy(model)
    before = {k: v.clone() for k, v in model.encoder.state_dict().items()}
    cfg = train_config()
    opt = sgd_chain(cfg.dec_lr, wd=cfg.dec_wd, clip=cfg.dec_grad_clip)
    state = init_train_state(model.decoder, opt, do_polyak=cfg.do_polyak)
    step = make_decoder_train_step(model.genotype, opt, num_classes=K,
                                   aux_weight=cfg.aux_weight)
    t0 = time.perf_counter()
    taps = make_encoder_cache_fn()(model.encoder, gbatch["image"])
    torch.cuda.synchronize()
    cache_s = time.perf_counter() - t0
    b = {"taps": taps, "label": gbatch["label"]}
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, loss = step(state, b)
        losses.append(loss)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STAGE1_STEPS):
        state, loss = step(state, b)
        losses.append(loss)
    end.record()
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    falls(losses, "stage 1")
    after = model.encoder.state_dict()
    check(all(torch.equal(before[k], after[k]) for k in before),
          "stage 1 touched the encoder's parameters or stats")
    ms = start.elapsed_time(end) / STAGE1_STEPS
    print(f"[train] stage 1: taps cached in {cache_s:.3f} s, "
          f"{STAGE1_STEPS} decoder steps {ms:.4f} ms a step, losses "
          f"{losses}; the encoder untouched")
    return {"ms": ms, "losses": losses, "cache_s": cache_s}


def train_eval(torch, state, gbatch):
    """Phase 10.4: make_eval_step and validate over the batch's halves on
    the trained state's eval_params_stats."""
    from segtpu_torch.engine.trainer import (eval_params_stats,
                                             make_eval_step, validate)
    eval_step = make_eval_step(state.model.genotype, num_classes=K)
    params, stats = eval_params_stats(state)
    half = len(gbatch["label"]) // 2
    batches = [{k: v[i:i + half] for k, v in gbatch.items()}
               for i in (0, half)]
    total = sum(int(eval_step(params, stats, b).sum()) for b in batches)
    label = gbatch["label"]
    valid = int(((label >= 0) & (label < K)).sum())
    check(total == valid, f"confusion matrices count {total} pixels, the "
          f"labels {valid} valid ones")
    miou = validate(eval_step, params, stats, batches, num_classes=K)
    check(bool(np.isfinite(miou)), f"mIoU {miou} not finite")
    print(f"[train] eval: 2 batches of {dims(batches[0])}, "
          f"confusion total {total} = valid labels, mIoU {miou!r}")
    return miou


def handoff_model(torch, state):
    """The trained state's eval_params_stats (Polyak weights, live BN
    stats) in a Segmenter on the CPU, as a user serves it."""
    from segtpu_torch.engine.trainer import eval_params_stats
    params, stats = eval_params_stats(state)
    model = train_model(torch)
    model.load_state_dict({k: v.detach().cpu()
                           for k, v in {**params, **stats}.items()})
    return model


def handoff_call_checks(torch, model, x, what):
    """[(what, kernel name, check())]: every kernel call of ``model``'s
    folded bf16 decoder on the kernels' taps of the uint8 frames ``x`` (on
    the card), held against its plain twin by ``check_call``."""
    from segtpu_torch.kernels.front import normalize_s2d_front
    from segtpu_torch.models.fast_decoder import fold_decoder
    from segtpu_torch.models.fast_encoder import fold_encoder
    enc = fold_encoder(model.encoder, torch.bfloat16).to("cuda")
    dec = fold_decoder(model.decoder, torch.bfloat16).to("cuda")
    with torch.inference_mode():
        taps = enc(normalize_s2d_front(x))
    _, calls = record_decoder(torch, dec, taps)
    out = []
    for i, (name, fn, a) in enumerate(calls):
        w = f"{what} call {i:2d} {name}"
        out.append((w, name, lambda name=name, fn=fn, a=a, w=w: check_call(
            torch, name, fn, a, w)))
    return out


def train_handoff(torch, state, frames):
    """Phase 10.5: the trained weights served by the engine at b8
    1024x2048 bf16, counts read around predict_batch (PATH_LAUNCHES);
    every decoder call against its twin; the masks against use_kernels=
    False by the near-tie rule (no floor: the agreement is recorded)."""
    from segtpu_torch.engine import Segmenter
    model = handoff_model(torch, state)
    seg = Segmenter(model, device="cuda")
    ref = Segmenter(model, device="cuda", use_kernels=False)
    reset_counts()
    masks = seg.predict_batch(frames)
    launches = read_counts()
    print(f"[train] hand-off predict_batch b8 {H}x{W}: launches={launches}")
    check(launches == PATH_LAUNCHES,
          f"hand-off launches {launches}, expected {PATH_LAUNCHES}")
    check(masks.shape == (N, H, W) and int(masks.max()) < K,
          f"hand-off masks {masks.shape} max {masks.max()}")
    x = torch.from_numpy(frames).cuda()
    checks = handoff_call_checks(torch, model, x, "hand-off")
    with torch.inference_mode():
        for _, _, run in checks:
            run()
    rate = masks_hold(torch, masks, ref.predict_batch(frames),
                      tie_gaps(torch, ref, x), 0.0,
                      "hand-off b8 masks vs use_kernels=False")
    print(f"[train] hand-off: {len(checks)} decoder calls against their "
          f"twins, masks agree on {rate!r}, classes "
          f"{np.bincount(masks.ravel(), minlength=K).tolist()}")
    return {"mask_agreement": rate, "calls": len(checks),
            "launches": launches}


def phase_train(torch, frames):
    """Phase 10 (see the module doc). Returns its numbers for the JSON."""
    torch.cuda.empty_cache()
    batch = train_batch()
    parity = train_parity(torch, batch)
    gbatch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    gpu = gpu_line()
    timed = {}
    n = len(batch["label"])
    for name, conv in (("tf32_off", False), ("pytorch_default", True)):
        with tf32(torch, conv):
            st, losses, ms, peak = run_train(torch, gbatch, TRAIN_WARMUP,
                                             TRAIN_STEPS)
        falls(losses, f"train ({name})")
        timed[name] = {"ms": ms, "images_per_s": n * 1000.0 / ms,
                       "peak_bytes": peak, "losses": losses,
                       "cudnn_tf32": conv, "matmul_tf32": False}
        print(f"[train] make_train_step arch0 aux {dims(batch)}, "
              f"cudnn.allow_tf32={conv} matmul.allow_tf32=False: "
              f"{ms:.4f} ms a step ({TRAIN_STEPS} timed after "
              f"{TRAIN_WARMUP}), {n * 1000.0 / ms:.2f} images/s, peak "
              f"{peak / 2 ** 30:.3f} GiB on {gpu}; losses {losses}")
        if name == "tf32_off":
            state = st
        del st
    with tf32(torch, False):
        stage1 = train_stage1(torch, state.model, gbatch)
        miou = train_eval(torch, state, gbatch)
    handoff = train_handoff(torch, state, frames)
    return {"gpu": gpu, "parity_worst": parity, "steps": timed,
            "stage1": stage1, "eval_miou": miou, "handoff": handoff}


TRAIN_KERNEL_KINDS = (
    ("convolutions and products", ("conv", "cudnn", "gemm", "xmma", "sm90",
                                   "sm80", "cutlass", "dgrad", "wgrad")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index")))


def kernel_rows(torch, p):
    """[(name, ms, launches)] of the device's kernels in a profile (an
    operator's row repeats its kernels' time, so kernels only)."""
    return [(e.key, (getattr(e, "self_device_time_total", None)
                     or getattr(e, "self_cuda_time_total", 0)) / 1e3,
             e.count)
            for e in p.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def bn_alone(torch, state, step, gbatch, reps: int = 3) -> dict:
    """The train-mode BatchNorm (``core.layers.bn_train``) of one step,
    forward and backward, run alone: one step run with a spy that records
    the shape of each call, then every call at its shape on seeded
    inputs, its output's gradient the same shape. Its kernels' device
    time (profiler) and its time on the stream (CUDA events, over
    ``reps`` runs, the host's gaps included)."""
    from torch.profiler import ProfilerActivity, profile as prof
    import segtpu_torch.core.layers as layers
    real, shapes = layers.bn_train, []

    def spy(y, *rest):
        shapes.append((tuple(y.shape), y.dtype))
        return real(y, *rest)

    layers.bn_train = spy
    try:
        step(state, gbatch)
    finally:
        layers.bn_train = real
    gen = torch.Generator(device="cuda").manual_seed(5)
    calls = []
    for shape, dtype in shapes:
        c = shape[1]
        calls.append((
            torch.randn(shape, generator=gen, device="cuda", dtype=dtype,
                        requires_grad=True),
            torch.ones(c, device="cuda", requires_grad=True),
            torch.zeros(c, device="cuda", requires_grad=True),
            torch.zeros(c, device="cuda"), torch.ones(c, device="cuda"),
            torch.randn(shape, generator=gen, device="cuda", dtype=dtype)))

    def run():
        for y, scale, bias, mean, var, g in calls:
            torch.autograd.grad(real(y, scale, bias, mean, var),
                                (y, scale, bias), g)

    run()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        run()
        torch.cuda.synchronize()
    rows = kernel_rows(torch, p)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return {"calls": len(calls), "device_ms": sum(r[1] for r in rows),
            "launches": sum(r[2] for r in rows),
            "stream_ms": start.elapsed_time(end) / reps}


def profile_train(torch):
    """``--profile``: device time by kernel over two make_train_step
    steps (TF32 off) on TrainConfig's batch, summed by kind of kernel (the
    first kind whose words a kernel's name holds), beside the steps' time
    on the host's clock; then the step's BatchNorm timed alone
    (``bn_alone``)."""
    from torch.profiler import ProfilerActivity, profile as prof
    batch = train_batch()
    gbatch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with tf32(torch, False):
        state, step = train_setup(torch, train_model(torch).cuda())
        for _ in range(TRAIN_WARMUP):
            state, _ = step(state, gbatch)
        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            for _ in range(2):
                state, _ = step(state, gbatch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        bn = bn_alone(torch, state, step, gbatch)
    kinds, launches = {}, 0
    for key, ms, count in kernel_rows(torch, p):
        launches += count
        kind = next((k for k, words in TRAIN_KERNEL_KINDS
                     if any(w in key.lower() for w in words)), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    dev_ms = sum(kinds.values())
    print(f"[profile] train step {dims(batch)}: two steps "
          f"{wall_ms:.2f} ms on the host's clock (profiler on), {dev_ms:.2f} "
          f"ms of device time in {launches} kernel launches; by kind "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / dev_ms:.1f} %)"
                      for k, v in sorted(kinds.items(),
                                         key=lambda kv: -kv[1])))
    print(f"[profile] train step {dims(batch)}: BatchNorm (bn_train) "
          f"forward and backward, its {bn['calls']} calls of a step run "
          f"alone: {bn['device_ms']:.4f} ms of device time in "
          f"{bn['launches']} launches ({200 * bn['device_ms'] / dev_ms:.1f} "
          f"% of a step's {dev_ms / 2:.2f}), {bn['stream_ms']:.4f} ms on the "
          f"stream")
    print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    return {"wall_ms_two_steps": wall_ms, "device_ms_two_steps": dev_ms,
            "launches_two_steps": launches, "by_kind_ms": kinds,
            "bn_alone": bn}


def handoff_control(torch, frames, bits: int) -> dict:
    """The control's hand-off checks: the trained state of phase 10.2
    (TF32 off), its decoder calls recorded before the rounding and run
    inside ``coarse_decoder(bits)``. Returns {check: failed}."""
    batch = train_batch()
    gbatch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    state, *_ = run_train(torch, gbatch, TRAIN_WARMUP, TRAIN_STEPS)
    del gbatch
    checks = handoff_call_checks(torch, handoff_model(torch, state),
                                 torch.from_numpy(frames).cuda(), "hand-off")
    res = {}
    with coarse_decoder(torch, bits):
        with torch.inference_mode():
            for what, _, run in checks:
                res[f"{what} vs its twin"] = must_fail(what, run)
    return res


# ------------------------------------------------------------------ search
#
# Phase 11: the NAS search on the port, segtpu_torch.search.run_search, at
# the published widths (MobileNet-v2 1.0, agg_size 48, the controller's
# LSTM hidden and embedding 100), 21 classes (PASCAL VOC, the CVPR'19
# search's data), the train phase's 512x512 crop and SearchConfig's batch
# sizes (8, 8) and epochs (5, 1); cut to SyntheticDataset(n=32), 3
# iterations of cvpr/PPO then one resumed, and 2 of wacv/REINFORCE.

SEARCH_K = 21
SEARCH_CROP = (512, 512)
SEARCH_SEED = 42
SEARCH_ITERS = {"cvpr": 3, "wacv": 2}
SEARCH_CUTS = ("SyntheticDataset(n=32): 21 classes at 512x512 crops, the "
               "published task's shapes; the repository's one dataset, "
               "artifacts/search_v2/data (phase supernet's), holds 32 "
               "64x64 images of 5 classes",
               "num_iters 3 with cvpr/PPO, then one resumed iteration",
               "2 iterations with wacv/REINFORCE")
# card against CPU on the same controller weights: evaluate's log-probs
# and entropies (max |d|); one PPO update's parameters as a share of the
# CPU's own move, Adam's moments as a share of each leaf's max |.|, the
# EMA baseline (max |d|)
CTRL_TOL = {"logprob": 1e-5, "entropy": 1e-5, "param": 1e-3, "mu": 1e-4,
            "nu": 1e-4, "baseline": 1e-7}
# the controller's CPU updates before the parity (Adam's moments not zero)
# and the reward of the update held card against CPU
CTRL_WARM_REWARDS, CTRL_REWARD = (0.3, 0.1), 0.37
# the CLI's train at a small crop, as the contract asks
CLI_TRAIN_CROP = 128


def search_config(snapshot_dir, **kw):
    from segtpu_torch.config import SearchConfig
    return SearchConfig(**{**dict(
        synthetic=True, num_classes=SEARCH_K, crop_size=SEARCH_CROP,
        seed=SEARCH_SEED, snapshot_dir=snapshot_dir), **kw})


def coarse_values(torch, bits):
    """The control's rounding of the card's controller values: each to
    ``bits`` significant bits (identity when ``bits`` is None)."""
    def run(t):
        if bits is None:
            return t
        m, e = torch.frexp(t.float())
        return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits, e)
    return run


def _leaves(tree):
    return ([x for v in tree.values() for x in _leaves(v)]
            if isinstance(tree, dict) else [tree])


def controller_checks(torch, bits=None):
    """[(what, error, limit)]: the controller's card against its CPU twin
    on the same weights (the micro spec at the published sizes, after
    CTRL_WARM_REWARDS' PPO updates on the CPU): evaluate on actions the
    card sampled (which stay inside their masks), and one PPO update from
    that state; the card's values rounded by ``coarse_values(bits)``."""
    from segtpu_torch.rl import agent as ag, controller as ct
    from segtpu_torch.utils.solvers import AdamState, tree_map
    cfg = search_config("")
    spec = ct.MicroControllerSpec(hidden_size=cfg.lstm_hidden_size,
                                  emb_size=cfg.op_size)

    def make(device):
        return ag.create_agent(
            torch.Generator().manual_seed(SEARCH_SEED), spec=spec,
            algo="ppo", lr=cfg.ctrl_lr, baseline_decay=cfg.ctrl_baseline_decay,
            entropy_coef=cfg.ctrl_entropy_coef, device=device)

    cpu = make("cpu")
    gen = torch.Generator().manual_seed(1)
    for r in CTRL_WARM_REWARDS:
        _, a, lp, _ = ag.sample_genotype(cpu, gen)
        cpu = ag.train_agent(cpu, a, r, old_logprobs=lp)
    st = cpu.state
    to = lambda t: t.cuda()  # noqa: E731
    card = make("cuda")._replace(state=ag.AgentState(
        tree_map(to, st.params), AdamState(st.opt_state.count,
                                           tree_map(to, st.opt_state.mu),
                                           tree_map(to, st.opt_state.nu)),
        st.baseline.cuda()))
    _, actions, logprobs, _ = ag.sample_genotype(
        card, torch.Generator(device="cuda").manual_seed(2))
    a = actions.cpu().numpy()
    check(((a >= 0) & (a < np.asarray(spec.slot_sizes))).all(),
          f"the card's sample left its masks: {a}")
    rnd = coarse_values(torch, bits)
    lp_g, ent_g = ct.evaluate(card.state.params, spec, actions)
    lp_c, ent_c = ct.evaluate(st.params, spec, actions.cpu())
    out = [("controller evaluate log-probs, card vs CPU",
            (rnd(lp_g).cpu() - lp_c).abs().max().item(), CTRL_TOL["logprob"]),
           ("controller evaluate entropies, card vs CPU",
            (rnd(ent_g).cpu() - ent_c).abs().max().item(),
            CTRL_TOL["entropy"])]
    new_g = ag.train_agent(card, actions, CTRL_REWARD,
                           old_logprobs=logprobs).state
    new_c = ag.train_agent(cpu, actions.cpu(), CTRL_REWARD,
                           old_logprobs=logprobs.cpu()).state

    def worst(got, want):
        return max((rnd(g).cpu() - w).abs().max().item()
                   for g, w in zip(_leaves(got), _leaves(want)))

    move = max((n - o).abs().max().item()
               for n, o in zip(_leaves(new_c.params), _leaves(st.params)))
    out.append(("controller PPO update parameters, card vs CPU",
                worst(new_g.params, new_c.params), CTRL_TOL["param"] * move))
    for m in ("mu", "nu"):
        got, want = getattr(new_g.opt_state, m), getattr(new_c.opt_state, m)
        top = max(w.abs().max().item() for w in _leaves(want))
        out.append((f"controller PPO update Adam {m}, card vs CPU",
                    worst(got, want), CTRL_TOL[m] * top))
    out.append(("controller PPO update baseline, card vs CPU",
                abs(rnd(new_g.baseline).item() - new_c.baseline.item()),
                CTRL_TOL["baseline"]))
    check(new_g.opt_state.count == new_c.opt_state.count,
          "Adam's step counts differ")
    return out


def cli_infer(torch, tmp, bits=None):
    """(mask of ``main_search infer`` on a seeded uint8 1024x2048 .npy
    frame and a torch checkpoint of make_model's arch0 (K = 19), the
    engine's predict on the same weights, the launches of the CLI's run).
    With ``bits`` the CLI runs inside ``coarse_decoder(bits)``."""
    from segtpu_torch import main_search
    from segtpu_torch.convert.torch_import import load_segmenter_checkpoint
    from segtpu_torch.engine import Segmenter
    from segtpu_torch.models import ARCHS
    ckpt = os.path.join(tmp, "arch0.ckpt")
    frame = os.path.join(tmp, "frame.npy")
    out = os.path.join(tmp, "frame_mask.npy")
    torch.save(make_model(torch).state_dict(), ckpt)
    np.save(frame, np.random.default_rng(7).integers(0, 256, (H, W, 3),
                                                     dtype=np.uint8))
    want = Segmenter(load_segmenter_checkpoint(
        ckpt, ARCHS["arch0"], K, device="cpu"), device="cuda").predict(
        np.load(frame))
    ctx = (coarse_decoder(torch, bits) if bits is not None
           else contextlib.nullcontext())
    reset_counts()
    with ctx:
        main_search.main(["infer", "--image", frame, "--ckpt", ckpt,
                          "--num-classes", str(K), "--output", out])
    return np.load(out), want, read_counts()


def check_records(saver, n, family, what):
    from segtpu_torch.models.families import infer_family
    recs = saver.history
    check(len(recs) == n, f"{what}: {len(recs)} records, expected {n}")
    for r in recs:
        check(r["status"] == "ok", f"{what}: step {r['step']} {r['status']}")
        check(np.isfinite(r["reward"]) and 0.0 <= r["reward"] <= 1.0,
              f"{what}: step {r['step']} reward {r['reward']}")
        check(infer_family(r["genotype"]).name == family,
              f"{what}: step {r['step']} genotype {r['genotype']}")


def run_timed_search(torch, cfg):
    """(saver, seconds, peak bytes) of run_search(cfg) on the card."""
    from segtpu_torch.search import run_search
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    saver = run_search(cfg, device="cuda")
    torch.cuda.synchronize()
    return (saver, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


# run_search, run_supernet_search and run_fleet_search run under
# deterministic algorithms (segtpu_torch.utils.helpers.deterministic), so a
# search reproduces its rewards from its seed: a short cvpr/PPO search
# (SEARCH_REPRO_ITERS iterations at the phase's settings) as a library call
# in two fresh processes started together (CUBLAS_WORKSPACE_CONFIG unset
# there: run_search sets it), then twice in this process; and twice with
# PyTorch's default algorithms (run_search.__wrapped__), a measurement of
# what determinism costs
SEARCH_REPRO_ITERS = 2
SEARCH_REPRO_TIMEOUT = 600


def fresh_search(snapshot_dir, seed):
    """A new process that runs the short search by ``run_search`` and
    prints its rewards as its last line."""
    code = ("import json, chip_smoke\n"
            "from segtpu_torch.search import run_search\n"
            f"cfg = chip_smoke.search_config({snapshot_dir!r}, "
            f"num_iters={SEARCH_REPRO_ITERS}, ctrl_version='cvpr', "
            f"ctrl_algo='ppo', seed={seed})\n"
            "print(json.dumps([r['reward'] for r in "
            "run_search(cfg, device='cuda').history]))\n")
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    return subprocess.Popen(
        [sys.executable, "-c", code], env=env, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def search_repro(torch, tmp, control: bool = False):
    """[(what, ok, detail)], numbers: the short search in two fresh
    processes, then twice in this process, each pair's rewards equal;
    without ``control`` also twice at PyTorch's default algorithms, each
    run's seconds. ``control``: each pair's second run from the next
    seed (a control that any code fails: it shows that the checks read
    the rewards)."""
    from segtpu_torch.search import run_search
    seeds = (SEARCH_SEED, SEARCH_SEED + int(control))

    def cfg(name, seed):
        return search_config(os.path.join(tmp, name), seed=seed,
                             num_iters=SEARCH_REPRO_ITERS,
                             ctrl_version="cvpr", ctrl_algo="ppo")

    procs = [fresh_search(os.path.join(tmp, f"fresh{i}"), seed)
             for i, seed in enumerate(seeds)]
    fresh = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SEARCH_REPRO_TIMEOUT)
            check(p.returncode == 0, f"a fresh process's search failed "
                  f"({p.returncode}): {err[-2000:]}")
            fresh.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    runs = [("deterministic", run_search, seeds[0]),
            ("deterministic again", run_search, seeds[1])]
    if not control:
        runs += [("default", run_search.__wrapped__, SEARCH_SEED),
                 ("default again", run_search.__wrapped__, SEARCH_SEED)]
    nums = {"fresh_processes": fresh}
    for name, fn, seed in runs:
        saver, secs, _ = timed(torch, lambda: fn(cfg(name, seed),
                                                 device="cuda"))
        nums[name] = {"rewards": [r["reward"] for r in saver.history],
                      "seconds": secs}
    det = [nums["deterministic"]["rewards"],
           nums["deterministic again"]["rewards"]]
    checks = [(f"run_search in two fresh processes, {SEARCH_REPRO_ITERS} "
               f"iterations from one seed", fresh[0] == fresh[1],
               f"rewards {fresh[0]!r} and {fresh[1]!r}"),
              ("run_search twice in this process from one seed",
               det[0] == det[1], f"rewards {det[0]!r} and {det[1]!r}")]
    return checks, nums


def encoder_cache_ms(torch, cfg):
    """ms of search._cache_taps over run_search's meta-train cache loader
    (the encoder's taps of every fixed crop, once per search), after one
    warm-up pass; and the cached taps' bytes."""
    from segtpu_torch import search
    from segtpu_torch.data.datasets import BatchLoader, create_loaders
    from segtpu_torch.models.encoders import MobileNetV2
    ds = search._make_dataset(cfg)
    train, _ = create_loaders(ds, batch_size=cfg.batch_size[1],
                              crop=cfg.crop_size,
                              meta_train_prct=cfg.meta_train_prct,
                              seed=cfg.seed)
    loader = BatchLoader(ds, batch_size=cfg.batch_size[0],
                         crop=cfg.crop_size, train=False, seed=cfg.seed,
                         indices=train.indices)
    enc = MobileNetV2(generator=torch.Generator().manual_seed(0)).cuda()
    search._cache_taps(enc, loader)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cached = search._cache_taps(enc, loader)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    nbytes = sum(t.numel() * t.element_size()
                 for b in cached for t in b["taps"])
    return ms, len(cached), nbytes


def phase_search(torch):
    """Phase 11: the search at the published widths on the card, its
    resume, the controller against the CPU, the CLI. Returns its numbers
    for the JSON."""
    import tempfile
    from segtpu_torch import main_search
    from segtpu_torch.data import native_io
    torch.cuda.empty_cache()
    gpu = gpu_line()
    for cut in SEARCH_CUTS:
        print(f"[search] cut: {cut}")
    print(f"[search] native_io loaded: {native_io.available()} "
          f"({native_io._LIB_PATH}) on {gpu}")
    os.makedirs("chiprun_out", exist_ok=True)
    res = {"gpu": gpu, "cuts": list(SEARCH_CUTS),
           "native_io": native_io.available()}
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        cfg = search_config(os.path.join(tmp, "cvpr"),
                            num_iters=SEARCH_ITERS["cvpr"],
                            ctrl_version="cvpr", ctrl_algo="ppo")
        print(f"[search] cvpr/PPO: {cfg}")
        saver, secs, peak = run_timed_search(torch, cfg)
        check_records(saver, SEARCH_ITERS["cvpr"], "micro", "cvpr/PPO")
        check(os.path.exists(os.path.join(cfg.snapshot_dir,
                                          "controller.npz")),
              "controller.npz not written")
        recs = saver.history
        resumed, _, _ = run_timed_search(torch, dataclasses.replace(
            cfg, num_iters=cfg.num_iters + 1, resume=True))
        check([r["step"] for r in resumed.history]
              == list(range(cfg.num_iters + 1))
              and resumed.history[:cfg.num_iters] == recs,
              f"resume did not continue at step {cfg.num_iters}: "
              f"{[r['step'] for r in resumed.history]}")
        wcfg = search_config(os.path.join(tmp, "wacv"),
                             num_iters=SEARCH_ITERS["wacv"],
                             ctrl_version="wacv", ctrl_algo="reinforce")
        wsaver, wsecs, wpeak = run_timed_search(torch, wcfg)
        check_records(wsaver, SEARCH_ITERS["wacv"], "template",
                      "wacv/REINFORCE")
        for name, rs, total, pk in (("cvpr/PPO", recs, secs, peak),
                                    ("cvpr/PPO resumed",
                                     resumed.history[cfg.num_iters:], None,
                                     None),
                                    ("wacv/REINFORCE", wsaver.history, wsecs,
                                     wpeak)):
            for r in rs:
                print(f"[search] {name} step {r['step']}: {r['seconds']} s "
                      f"(stage 1 {r['stage1_ms']:.2f} ms a step, stage 2 "
                      f"{r['stage2_ms']:.2f} ms a step), reward "
                      f"{r['reward']!r}, mIoUs {r['miou1']!r} "
                      f"{r['miou2']!r}, {r['genotype']} on {gpu}")
            if total is not None:
                print(f"[search] {name}: {len(rs)} iterations in "
                      f"{total:.2f} s with the encoder cache, peak "
                      f"{pk / 2 ** 30:.3f} GiB on {gpu}")
        res.update(cvpr=recs, cvpr_resumed=resumed.history[cfg.num_iters:],
                   wacv=wsaver.history, cvpr_s=secs, wacv_s=wsecs,
                   cvpr_peak_bytes=peak, wacv_peak_bytes=wpeak)
        ms, n, nbytes = encoder_cache_ms(torch, cfg)
        print(f"[search] encoder cache: {n} batches of {cfg.batch_size[0]}x"
              f"{cfg.crop_size[0]}x{cfg.crop_size[1]} in {ms:.2f} ms, "
              f"{nbytes / 2 ** 20:.1f} MiB of taps on {gpu}")
        res.update(cache_ms=ms, cache_batches=n, cache_bytes=nbytes)
        ctrl = controller_checks(torch)
        for what, err, limit in ctrl:
            print(f"[search] {what}: {err!r} (limit {limit!r}) on {gpu}")
            check(err <= limit, f"{what}: {err} > {limit}")
        res["controller"] = {w: [e, lim] for w, e, lim in ctrl}
        main_search.main(["search", "--synthetic", "--num-iters", "1",
                          "--crop-size", *map(str, SEARCH_CROP),
                          "--snapshot-dir", os.path.join(tmp, "cli_search")])
        check(os.path.exists(os.path.join(tmp, "cli_search",
                                          "controller.npz")),
              "the CLI's search wrote no snapshot")
        main_search.main(["train", "--synthetic", "--num-epochs", "1",
                          "--crop-size", str(CLI_TRAIN_CROP),
                          str(CLI_TRAIN_CROP), "--batch-size", "8",
                          "--snapshot-dir", os.path.join(tmp, "cli_train")])
        check(os.path.exists(os.path.join(tmp, "cli_train",
                                          "best_params.npz")),
              "the CLI's train wrote no checkpoint")
        got, want, launches = cli_infer(torch, tmp)
        print(f"[search] CLI infer 1x{H}x{W}: launches {launches}, classes "
              f"{np.bincount(got.ravel(), minlength=K).tolist()}")
        check(launches == PATH_LAUNCHES,
              f"CLI infer launches {launches}, expected {PATH_LAUNCHES}")
        check(len(np.unique(want)) > 1, "the infer mask is one class")
        check(np.array_equal(got, want),
              f"CLI infer mask differs from Segmenter.predict on "
              f"{int((got != want).sum())} pixels")
        res["cli_infer_launches"] = launches
        checks, res["repro"] = search_repro(torch, tmp)
    for what, ok, detail in checks:
        print(f"[search] {what}: {detail} on {gpu}")
        check(ok, f"{what}: {detail}")
    r = res["repro"]
    spread = max(abs(a - b) for a, b in zip(r["default"]["rewards"],
                                            r["default again"]["rewards"]))
    print(f"[search] {SEARCH_REPRO_ITERS} iterations of cvpr/PPO: "
          f"{r['deterministic']['seconds']:.2f} / "
          f"{r['deterministic again']['seconds']:.2f} s under deterministic "
          f"algorithms (spread 0), {r['default']['seconds']:.2f} / "
          f"{r['default again']['seconds']:.2f} s with PyTorch's defaults "
          f"(spread {spread!r}) on {gpu}")
    return res


def search_control(torch, bits: int) -> dict:
    """The control's search checks: the controller's card values rounded
    to ``bits`` bits against the CPU's, and the CLI's infer inside
    ``coarse_decoder(bits)`` against the engine's predict outside it.
    Returns {check: failed}."""
    import tempfile
    res = {}
    for what, err, limit in controller_checks(torch, bits):
        res[what] = must_fail(what, lambda: check(
            err <= limit, f"{what}: {err} > {limit}"))
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        got, want, _ = cli_infer(torch, tmp, bits)
        repro = search_repro(torch, tmp, control=True)[0]
    res["CLI infer mask vs Segmenter.predict"] = must_fail(
        "CLI infer mask", lambda: check(np.array_equal(got, want),
                                        "CLI infer mask differs"))
    for what, ok, detail in repro:
        res[what] = must_fail(what, lambda: check(ok, f"{what}: {detail}"))
    return res


# ------------------------------------------------------------------ supernet
#
# Phase 12: the population search on the port (segtpu_torch.supernet, the
# mesh's population steps, parallel.fleet) at the settings of the repo's
# recorded supernet search (artifacts/search_v2/summary.json "proxy":
# population 8, 64x64 crops, batch (8, 8), epochs (16, 0)) on its dataset
# (artifacts/search_v2/data), agg_size 48, 3 blocks, 3 cell nodes.

SUPERNET_DATA = os.path.join("artifacts", "search_v2", "data")
SUPERNET_PROXY = dict(crop_size=(64, 64), batch_size=(8, 8),
                      num_epochs=(16, 0))
SUPERNET_CLASSES = 5      # scripts/run_search_demo.py:27; checked on the masks
SUPERNET_SEED = 0
# (ctrl_version, ctrl_algo, population, rounds)
SUPERNET_RUNS = (("cvpr", "ppo", 8, 3), ("wacv", "reinforce", 4, 2))
SUPERNET_CUTS = (
    "3 rounds of cvpr/PPO at population 8 (the recorded search ran 100)",
    "then 2 rounds of wacv/REINFORCE at population 4",
    "the encoder random from the seed (the recorded search pre-trained "
    "arch0's on the task first)",
    "the dataset's PNGs read by read_png into .npy (no PIL, no native_io "
    "on the card)")
# (b) the vectorised population step against the samples' sequential
# steps, (c) the 4-shard step against the unsharded: losses, and every
# parameter, statistic, trace and Polyak leaf, within POP_TOL of
# max(its max |.|, POP_FLOOR); (c) the confusion matrices within CM_SHARE
# of their sum (tests/test_parallel.py:256-261)
POP_TOL, POP_FLOOR = 1e-4, 1e-2
POP_SHARDS = 4
CM_SHARE = 0.002
# (d) the fleet's rewards against proxy_train one genotype after another,
# at FLEET_EPOCHS (the phase's 16 stage-1 epochs cut to 4: the check is
# placement and seeds, not the proxy). With PyTorch's default algorithms
# the card's proxy trainings are not bit-reproducible (the same genotypes
# and seeds run twice one after another moved a reward by 4.2e-3 at 16
# epochs, by 2.9e-5 to 7.7e-5 at 4, on an H100 80GB HBM3 at 700 W); under
# deterministic algorithms they are (spread 0 in three runs, the fleet
# equal to sequential in two), so both sides run that way and FLEET_TOL
# is that spread
FLEET_WORKERS = 4
FLEET_EPOCHS = (4, 0)
FLEET_TOL = 0.0
# (e) tests/test_supernet.py:239-250: its genotypes and its config
FIDELITY_REAL = [[3, [1, 1, 4, 6], [2, 2, 6, 5], [3, 0, 7, 8]],
                 [[0, 0], [1, 0], [3, 4]]]
FIDELITY_DEGEN = [[10, [1, 1, 10, 10], [2, 2, 10, 10], [3, 3, 10, 10]],
                  [[0, 1], [2, 3], [1, 2]]]
FIDELITY_CFG = dict(synthetic=True, num_classes=5, crop_size=(64, 64),
                    batch_size=(8, 8), num_epochs=(10, 0), seed=0)


def read_png(path):
    """An 8-bit, non-interlaced grey or RGB PNG -> uint8 [H, W(, 3)]: the
    IDAT stream inflated by zlib and each row's filter undone."""
    import struct
    import zlib
    b = open(path, "rb").read()
    check(b[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    i, idat = 8, []
    while i < len(b):
        n, t = struct.unpack(">I4s", b[i:i + 8])
        if t == b"IHDR":
            w, h, depth, ctype, _, _, lace = struct.unpack(
                ">IIBBBBB", b[i + 8:i + 21])
        elif t == b"IDAT":
            idat.append(b[i + 8:i + 8 + n])
        i += 12 + n
    check(depth == 8 and ctype in (0, 2) and lace == 0,
          f"{path}: depth {depth}, colour type {ctype}, interlace {lace}")
    c = 3 if ctype == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)),
                        np.uint8).reshape(h, 1 + w * c)
    out = np.zeros((h, w * c), np.int32)
    for y in range(h):
        f, x = raw[y, 0], raw[y, 1:].astype(np.int32)
        up = out[y - 1] if y else np.zeros(w * c, np.int32)
        if f == 0:
            out[y] = x
        elif f == 2:
            out[y] = (x + up) & 255
        else:
            row = out[y]
            for j in range(w * c):
                a = row[j - c] if j >= c else 0
                ul = up[j - c] if j >= c else 0
                if f == 1:
                    pred = a
                elif f == 3:
                    pred = (a + up[j]) >> 1
                else:       # Paeth
                    pa, pb, pc = (abs(up[j] - ul), abs(a - ul),
                                  abs(a + up[j] - 2 * ul))
                    pred = (a if pa <= pb and pa <= pc
                            else up[j] if pb <= pc else ul)
                row[j] = (x[j] + pred) & 255
    out = out.astype(np.uint8).reshape(h, w, c)
    return out[..., 0] if c == 1 else out


def supernet_dataset(tmp) -> str:
    """SUPERNET_DATA's lists with every PNG as a .npy under ``tmp``; the
    masks must hold classes 0..SUPERNET_CLASSES-1 and 255. -> the root."""
    labels = set()
    for lst in ("train.lst", "val.lst"):
        lines = []
        for line in open(os.path.join(SUPERNET_DATA, lst)).read().split():
            arr = read_png(os.path.join(SUPERNET_DATA, line))
            if line.startswith("masks"):
                labels |= set(np.unique(arr).tolist())
            npy = line.rsplit(".", 1)[0] + ".npy"
            os.makedirs(os.path.join(tmp, os.path.dirname(npy)),
                        exist_ok=True)
            np.save(os.path.join(tmp, npy), arr)
            lines.append(npy)
        with open(os.path.join(tmp, lst), "w") as f:
            f.write("\n".join(f"{a} {b}" for a, b in
                              zip(lines[::2], lines[1::2])) + "\n")
    check(labels == set(range(SUPERNET_CLASSES)) | {255},
          f"the search_v2 masks hold {sorted(labels)}")
    return tmp


def supernet_config(root, snapshot_dir, **kw):
    from segtpu_torch.config import SearchConfig
    return SearchConfig(**{**dict(
        data_root=root, train_list=os.path.join(root, "train.lst"),
        val_list=os.path.join(root, "val.lst"),
        num_classes=SUPERNET_CLASSES, seed=SUPERNET_SEED, agg_size=48,
        num_blocks=3, num_cell_nodes=3, snapshot_dir=snapshot_dir,
        **SUPERNET_PROXY), **kw})


def _rounded(torch, bits, tree):
    rnd = coarse_values(torch, bits)
    return {k: rnd(v) for k, v in tree.items()}


def supernet_records(torch, saver, cfg, k, rounds, bits=None):
    """(a) (what, ok, detail): k x rounds records, each "mode" supernet
    with a finite reward in [0, 1]; the snapshot loads at step k x rounds
    with the baseline of the last record (the loaded baseline rounded by
    ``coarse_values(bits)``)."""
    from segtpu_torch import search
    from segtpu_torch.utils.saver import SearchSaver
    recs = saver.history
    agent = search.create_search_agent(cfg, "cpu")
    snap = SearchSaver(cfg.snapshot_dir).load(agent.state.params)
    base = (None if snap is None else coarse_values(torch, bits)(
        torch.tensor(snap[2], dtype=torch.float64)).item())
    ok = (len(recs) == k * rounds
          and all(r["mode"] == "supernet" and np.isfinite(r["reward"])
                  and 0.0 <= r["reward"] <= 1.0 for r in recs)
          and snap is not None and snap[0] == k * rounds
          and base == recs[-1]["baseline"])
    return (f"supernet {cfg.ctrl_version}/{cfg.ctrl_algo} records and "
            f"snapshot", ok, f"{len(recs)} records, snapshot step "
            f"{None if snap is None else snap[0]}, baseline {base!r} against "
            f"{recs[-1]['baseline'] if recs else None!r}")


def population_setup(torch, cfg):
    """The K = 8 population of checks (b), (c) and the profile: (spec,
    optimizer, a fresh PopState, masks of 8 genotypes sampled by the cvpr
    controller, the first cached train batch, the first val batch)."""
    from segtpu_torch import search, supernet as sn
    from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS
    from segtpu_torch.rl.agent import sample_genotype
    k = SUPERNET_RUNS[0][2]
    _, enc, loaders = search.search_setup(cfg, None, None, "cuda")
    batch = search._cache_taps(enc, loaders["cache_train"])[0]
    val = search._cache_taps(enc, loaders["cache_val"])[0]
    agent = search.create_search_agent(cfg, "cuda")
    acts = torch.stack([sample_genotype(agent, torch.Generator(
        device="cuda").manual_seed(i))[1] for i in range(k)])
    spec = sn.spec_of(cfg)
    pop = sn.population_init(torch.Generator().manual_seed(SUPERNET_SEED),
                             spec, MBV2_TAP_CHANNELS, k, do_polyak=True,
                             device="cuda")
    return (spec, sn.population_optimizer(cfg), pop,
            sn.masks_from_actions(acts, spec), batch, val)


def profile_supernet(torch):
    """``--profile``: device time by kind of kernel of three K = 8
    population steps replayed as the CUDA graph and of one eager step,
    beside their time on the host's clock, at phase 12's settings."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile as prof
    from segtpu_torch import supernet as sn
    out = {}
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        root = supernet_dataset(os.path.join(tmp, "data"))
        cfg = supernet_config(root, os.path.join(tmp, "profile"))
        spec, opt, pop, masks, batch, _ = population_setup(torch, cfg)
        graphed = sn.GraphedPopulationStep(spec, opt,
                                           aux_weight=cfg.dec_aux_weight)
        eager = sn.make_population_train_step(spec, opt,
                                              aux_weight=cfg.dec_aux_weight)
        state = [graphed(pop, masks, batch)[0]]

        def graph_steps():
            for _ in range(3):
                state[0] = graphed(state[0], masks, batch)[0]

        eager(pop, masks, batch)
        for what, fn, n in (("graph", graph_steps, 3),
                            ("eager", lambda: eager(pop, masks, batch), 1)):
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
            kinds, launches = {}, 0
            for key, ms, count in kernel_rows(torch, p):
                launches += count
                kind = next((k for k, words in TRAIN_KERNEL_KINDS
                             if any(w in key.lower() for w in words)),
                            "other")
                kinds[kind] = kinds.get(kind, 0.0) + ms / n
            dev_ms = sum(kinds.values())
            print(f"[profile] supernet K = 8 step ({what}): {wall_ms:.2f} "
                  f"ms on the host's clock (profiler on), {dev_ms:.2f} ms "
                  f"of device time in {launches // n} kernel launches; by "
                  f"kind " + ", ".join(
                      f"{k} {v:.2f} ms ({100 * v / dev_ms:.1f} %)"
                      for k, v in sorted(kinds.items(),
                                         key=lambda kv: -kv[1])))
            if what == "graph":
                print(p.key_averages().table(sort_by="cuda_time_total",
                                             row_limit=15))
            out[what] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                         "launches": launches // n, "by_kind_ms": kinds}
    return out


def population_checks(torch, cfg, bits=None):
    """(b) and (c) on the phase's first cached batch and K = 8 genotypes
    sampled by the cvpr controller: one vectorised population step
    against the 8 samples' sequential steps, and the step and eval on
    make_mesh(POP_SHARDS, 1) of one card against the unsharded ones; the
    vectorised (b) and sharded (c) outputs rounded by
    ``coarse_values(bits)``. -> ([(what, ok, detail)], numbers)."""
    from segtpu_torch import supernet as sn
    from segtpu_torch.parallel.mesh import (
        gather_population, make_mesh, make_sharded_population_eval,
        make_sharded_population_step, shard_population)
    spec, opt, pop, masks, batch, val = population_setup(torch, cfg)
    vec = sn.make_population_train_step(spec, opt,
                                        aux_weight=cfg.dec_aux_weight)
    seq = sn.make_sequential_train_step(spec, opt,
                                        aux_weight=cfg.dec_aux_weight)
    ev = sn.make_population_eval_step(spec)

    def worst(a, la, b, lb):
        """(losses' max |d| over their max, worst leaf's max |d| over
        max(its max |.|, POP_FLOOR), that leaf)."""
        loss = ((_rounded(torch, bits, {"l": la})["l"] - lb).abs().max()
                / lb.abs().max()).item()
        leaf = (0.0, None)
        for field in ("params", "stats", "opt_state", "polyak"):
            got = _rounded(torch, bits, getattr(a, field))
            for n, t in getattr(b, field).items():
                e = ((got[n] - t).abs().max().item()
                     / max(t.abs().max().item(), POP_FLOOR))
                leaf = max(leaf, (e, f"{field} {n}"))
        return loss, leaf

    graphed = sn.GraphedPopulationStep(spec, opt,
                                       aux_weight=cfg.dec_aux_weight)
    a, la = vec(pop, masks, batch)
    b, lb = seq(pop, masks, batch)
    g, lg = graphed(pop, masks, batch)
    loss_b, leaf_b = worst(a, la, b, lb)
    loss_g, leaf_g = worst(g, lg, b, lb)
    state = [g]

    def graphed_step():
        state[0] = graphed(state[0], masks, batch)[0]

    nums = {"vectorised_step_ms": cuda_ms(lambda: vec(pop, masks, batch), 5),
            "graphed_step_ms": cuda_ms(graphed_step, 20),
            "sequential_step_ms": cuda_ms(lambda: seq(pop, masks, batch), 1,
                                          warmup=0),
            "b_loss": loss_b, "b_leaf": leaf_b, "b_graphed_loss": loss_g,
            "b_graphed_leaf": leaf_g}
    out = [("supernet vectorised step (eager and CUDA graph) vs sequential, "
            "K = 8",
            max(loss_b, leaf_b[0], loss_g, leaf_g[0]) <= POP_TOL,
            f"eager: losses {loss_b!r}, worst leaf {leaf_b!r}; graph: losses "
            f"{loss_g!r}, worst leaf {leaf_g!r} (limit {POP_TOL})")]
    mesh = make_mesh(POP_SHARDS, 1,
                     devices=[torch.device("cuda", 0)] * POP_SHARDS)
    shards, mshards = shard_population(mesh, pop, masks)
    s, ls = make_sharded_population_step(vec, mesh)(shards, mshards, batch)
    cms = ev(a.eval_params(), a.stats, masks, val)
    cms_s = make_sharded_population_eval(ev, mesh)(
        s.eval_params(), s.stats, mshards, val)
    cms_s = coarse_values(torch, bits)(cms_s.double()).round().long()
    loss_c, leaf_c = worst(gather_population(s), ls, a, la)
    share = ((cms_s - cms).abs().sum() / cms.sum()).item()
    nums.update(c_loss=loss_c, c_leaf=leaf_c, c_cm_share=share)
    out.append((f"supernet {POP_SHARDS}-shard step vs unsharded, K = 8",
                loss_c <= POP_TOL and leaf_c[0] <= POP_TOL
                and share <= CM_SHARE,
                f"losses {loss_c!r}, worst leaf {leaf_c!r}, confusion "
                f"{share!r} of the sum (limits {POP_TOL}, {CM_SHARE})"))
    return out, nums


def fleet_check(torch, cfg, bits=None):
    """(d) One round of run_fleet_search on [cuda:0] * FLEET_WORKERS
    against search.proxy_train run one genotype after another on fresh
    loaders with the records' genotypes and the workers' seeds, both
    under deterministic algorithms (``utils.helpers.deterministic``, which
    run_fleet_search enters itself), where the card's proxy training is
    bit-reproducible; the sequential run twice, its
    spread printed. Without ``bits`` the sequential pair also runs with
    PyTorch's default algorithms, which are not, and prints its spread
    and time beside. With ``bits`` (a control) the fleet's workers train
    from the next worker's seed. -> ((what, ok, detail), numbers)."""
    from segtpu_torch import search
    from segtpu_torch.data.datasets import SegmentationDataset
    from segtpu_torch.parallel.fleet import run_fleet_search
    from segtpu_torch.utils.helpers import deterministic
    ds = SegmentationDataset(cfg.data_root, cfg.train_list)
    proxy_train = search.proxy_train

    def sequential():
        out = []
        for i, r in enumerate(saver.history):
            fresh = search.search_loaders(cfg, ds)
            out.append(search.compute_reward(*proxy_train(
                r["genotype"], enc, cfg, c_train, c_val, fresh["train"],
                fresh["val"], rng_seed=cfg.seed + i)))
        return out

    with deterministic():
        if bits is not None:
            def shifted(*a, rng_seed, **kw):
                return proxy_train(*a, rng_seed=rng_seed + 1, **kw)
            search.proxy_train = shifted
        try:
            (saver, secs, peak) = timed(torch, lambda: run_fleet_search(
                cfg, devices=[torch.device("cuda", 0)] * FLEET_WORKERS,
                dataset=ds))
        finally:
            search.proxy_train = proxy_train
        _, enc, loaders = search.search_setup(cfg, ds, None, "cuda")
        c_train = search._cache_taps(enc, loaders["cache_train"])
        c_val = search._cache_taps(enc, loaders["cache_val"])
        seq, seq_s, _ = timed(torch, sequential)
        again = sequential()
    got = [r["reward"] for r in saver.history]
    err = max(abs(g - w) for g, w in zip(got, seq))
    spread = max(abs(g - w) for g, w in zip(again, seq))
    nums = {"fleet_s": secs, "sequential_s": seq_s, "fleet_peak": peak,
            "fleet_rewards": got, "sequential_rewards": seq, "err": err,
            "sequential_again": again, "spread": spread}
    if bits is None:
        dflt, dflt_s, _ = timed(torch, sequential)
        dflt_again = sequential()
        nums.update(default_rewards=dflt, default_again=dflt_again,
                    default_s=dflt_s, default_spread=max(
                        abs(g - w) for g, w in zip(dflt_again, dflt)))
        print(f"[supernet] proxy_train one genotype after another, twice: "
              f"spread {spread!r} in {seq_s:.2f} s under deterministic "
              f"algorithms, {nums['default_spread']!r} in {dflt_s:.2f} s "
              f"with PyTorch's defaults")
    ok = (len(got) == FLEET_WORKERS and err <= FLEET_TOL
          and all(r["status"] == "ok" for r in saver.history))
    return ((f"fleet of {FLEET_WORKERS} vs sequential proxy_train", ok,
             f"rewards {got!r} against {seq!r}: max |d| {err!r} (limit "
             f"{FLEET_TOL}), sequential against itself {spread!r}"), nums)


def fidelity_check(torch, bits=None):
    """(e) measure_proxy_fidelity on FIDELITY_REAL and FIDELITY_DEGEN at
    FIDELITY_CFG: both proxies rank the real genotype first, rho 1. With
    ``bits`` (a control) the supernet's masks go to the other sample
    (rolled by one along K)."""
    from segtpu_torch import supernet as sn
    from segtpu_torch.config import SearchConfig
    masks_fn = sn.masks_from_actions
    if bits is not None:
        def rolled(actions, spec):
            return {k: v.roll(1, 0) for k, v in masks_fn(actions,
                                                         spec).items()}
        sn.masks_from_actions = rolled
    try:
        (rho, r_pg, r_sn, _), secs, _ = timed(
            torch, lambda: sn.measure_proxy_fidelity(
                SearchConfig(**FIDELITY_CFG), seed=0, device="cuda",
                genotypes=[FIDELITY_REAL, FIDELITY_DEGEN]))
    finally:
        sn.masks_from_actions = masks_fn
    ok = r_pg[0] > r_pg[1] and r_sn[0] > r_sn[1] and rho == 1.0
    return (("measure_proxy_fidelity real above degenerate, rho 1", ok,
             f"per-genotype {r_pg!r}, supernet {r_sn!r}, rho {rho!r}"),
            {"per_genotype": r_pg, "supernet": r_sn, "rho": rho,
             "seconds": secs})


def timed(torch, fn):
    """(fn(), seconds, peak bytes) on the card."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def phase_supernet(torch):
    """Phase 12: the population search on the card at the recorded
    search's settings, checks (a)-(e), the CLI's three search modes.
    Returns its numbers for the JSON."""
    import tempfile
    from segtpu_torch import main_search, supernet as sn
    from segtpu_torch.data.datasets import SegmentationDataset
    torch.cuda.empty_cache()
    gpu = gpu_line()
    t_phase = time.perf_counter()
    for cut in SUPERNET_CUTS:
        print(f"[supernet] cut: {cut}")
    res = {"gpu": gpu, "cuts": list(SUPERNET_CUTS)}
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        root = supernet_dataset(os.path.join(tmp, "data"))
        for version, algo, k, rounds in SUPERNET_RUNS:
            cfg = supernet_config(root, os.path.join(tmp, version),
                                  num_iters=rounds, ctrl_version=version,
                                  ctrl_algo=algo)
            print(f"[supernet] {version}/{algo} population {k}: {cfg}")
            ds = SegmentationDataset(root, cfg.train_list)
            saver, secs, peak = timed(torch, lambda: sn.run_supernet_search(
                cfg, population=k, dataset=ds, device="cuda"))
            what, ok, detail = supernet_records(torch, saver, cfg, k, rounds)
            print(f"[supernet] (a) {what}: {detail}")
            check(ok, f"{what}: {detail}")
            for rnd in range(rounds):
                rs = saver.history[rnd * k:(rnd + 1) * k]
                print(f"[supernet] {version}/{algo} round {rnd}: "
                      f"{rs[0]['seconds']} s, stage 1 "
                      f"{rs[0]['stage1_ms']:.2f} ms a population step, "
                      f"rewards {[x['reward'] for x in rs]!r} on {gpu}")
            print(f"[supernet] {version}/{algo}: {rounds} rounds in "
                  f"{secs:.2f} s with the encoder cache, peak "
                  f"{peak / 2 ** 30:.3f} GiB on {gpu}")
            res[version] = {"records": saver.history, "seconds": secs,
                            "peak_bytes": peak}
        cfg = supernet_config(root, os.path.join(tmp, "checks"))
        checks, nums = population_checks(torch, cfg)
        (fleet, fnums) = fleet_check(torch, dataclasses.replace(
            cfg, num_iters=1, num_epochs=FLEET_EPOCHS,
            snapshot_dir=os.path.join(tmp, "fleet")))
        (fid, enums) = fidelity_check(torch)
        repro = supernet_repro(torch, root, tmp)
        res.update(population=nums, fleet=fnums, fidelity=enums)
        for what, ok, detail in checks + [fleet, fid, repro]:
            print(f"[supernet] {what}: {detail} on {gpu}")
            check(ok, f"{what}: {detail}")
        print(f"[supernet] population step K = 8: vectorised "
              f"{nums['vectorised_step_ms']:.2f} ms eager, "
              f"{nums['graphed_step_ms']:.2f} ms as a CUDA graph, "
              f"sequential {nums['sequential_step_ms']:.2f} ms; fleet round "
              f"{fnums['fleet_s']:.2f} s against "
              f"{fnums['sequential_s']:.2f} s sequential (the card against "
              f"itself: {fnums['spread']!r}); fidelity "
              f"{enums['seconds']:.2f} s on {gpu}")
        # the CLI's three search modes (a card each: --pop-devices 4 needs
        # four, and make_mesh says so)
        cli = ["search", "--synthetic", "--num-iters", "1", "--crop-size",
               "64", "64", "--num-epochs", "1", "0"]
        for flags in (["--supernet", "8"], ["--fleet"]):
            out = os.path.join(tmp, "cli" + flags[0])
            main_search.main(cli + flags + ["--snapshot-dir", out])
            check(os.path.exists(os.path.join(out, "controller.npz")),
                  f"the CLI's search {flags} wrote no snapshot")
        if torch.cuda.device_count() < 4:
            try:
                main_search.main(cli + ["--supernet", "8", "--pop-devices",
                                        "4"])
                fail("--pop-devices 4 ran on fewer than four cards")
            except ValueError as e:
                print(f"[supernet] CLI --supernet 8 --pop-devices 4 on "
                      f"{torch.cuda.device_count()} card: ValueError: {e}")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[supernet] phase: {res['phase_s']:.2f} s on {gpu}")
    return res


def supernet_repro(torch, root, tmp, control: bool = False):
    """(what, ok, detail): SUPERNET_RUNS' wacv/REINFORCE search run twice
    from SUPERNET_SEED gives the same rewards (run_supernet_search runs
    under deterministic algorithms). ``control``: the second run from
    the next seed."""
    from segtpu_torch import supernet as sn
    from segtpu_torch.data.datasets import SegmentationDataset
    version, algo, k, rounds = SUPERNET_RUNS[1]
    rewards = []
    for i, seed in enumerate((SUPERNET_SEED, SUPERNET_SEED + int(control))):
        cfg = supernet_config(root, os.path.join(tmp, f"repro{i}"),
                              num_iters=rounds, ctrl_version=version,
                              ctrl_algo=algo, seed=seed)
        rewards.append([r["reward"] for r in sn.run_supernet_search(
            cfg, population=k, device="cuda",
            dataset=SegmentationDataset(root, cfg.train_list)).history])
    return (f"{version}/{algo} supernet search twice from one seed",
            rewards[0] == rewards[1],
            f"rewards {rewards[0]!r} and {rewards[1]!r}")


def supernet_control(torch, bits: int) -> dict:
    """The control's supernet checks: (a) on one round of each run with
    the snapshot's baseline rounded to ``bits`` bits, (b) and (c) with
    the vectorised and sharded outputs rounded, (d) with the fleet's
    workers on the next worker's seed, (e) with the supernet's masks
    rolled to the other genotype. Returns {check: failed}."""
    import tempfile
    from segtpu_torch import supernet as sn
    from segtpu_torch.data.datasets import SegmentationDataset
    res = {}
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        root = supernet_dataset(os.path.join(tmp, "data"))
        checks = []
        for version, algo, k, _ in SUPERNET_RUNS:
            cfg = supernet_config(root, os.path.join(tmp, version),
                                  num_iters=1, ctrl_version=version,
                                  ctrl_algo=algo)
            saver = sn.run_supernet_search(
                cfg, population=k, device="cuda",
                dataset=SegmentationDataset(root, cfg.train_list))
            checks.append(supernet_records(torch, saver, cfg, k, 1, bits))
        cfg = supernet_config(root, os.path.join(tmp, "checks"))
        checks += population_checks(torch, cfg, bits)[0]
        checks.append(fleet_check(torch, dataclasses.replace(
            cfg, num_iters=1, num_epochs=FLEET_EPOCHS,
            snapshot_dir=os.path.join(tmp, "fleet")), bits)[0])
        checks.append(fidelity_check(torch, bits)[0])
        checks.append(supernet_repro(torch, root, tmp, control=True))
    for what, ok, detail in checks:
        res[what] = must_fail(what, lambda: check(ok, f"{what}: {detail}"))
    return res


# ---------------------------------------------------------------------------
# Phase 13: data-parallel training on logical shards of the one card
# ---------------------------------------------------------------------------

# the sharded step against the unsharded step on the whole batch, by
# tests/test_torch_data_parallel.py's rule: the loss at DP_LOSS_RTOL; by
# group the parameters, traces, Polyak averages and running stats within
# max(DP_FLOOR x the unsharded step's move, DP_SPREAD x its own spread on
# the batch in reversed order)
DP_SHARDS = 2
DP_LOSS_RTOL = 2e-4
DP_SPREAD = 4
DP_FLOOR = {"params": 1e-2, "trace": 1e-2, "polyak": 1e-2, "stats": 1e-3}
DP_TIMED = 3
# run_training with data_parallel on one card against the run without it:
# each step's loss within DP_RUN_RTOL (cuDNN's backward is not
# deterministic); over two logical shards of the card, within
# DP_LOSS_RTOL
DP_RUN_RTOL = 1e-4
DP_RUN_IMAGES = 32


def dp_batch():
    """phase train's batch with more ignored pixels in the first shard's
    images (their top quarter), so the shards' valid counts differ."""
    b = train_batch()
    b["label"][:train_config().batch_size // DP_SHARDS, :128] = 255
    return b


def _local_moments(yf):
    """Ghost BN, the control's sharded-step fault: each shard's own
    moments."""
    mean = yf.mean((0, 2, 3))
    var = (yf - mean[:, None, None]).square().mean((0, 2, 3))
    return mean, var, yf.numel() // yf.shape[1]


@contextlib.contextmanager
def ghost_bn(on: bool):
    from segtpu_torch.core import layers
    saved = layers._batch_moments
    if on:
        layers._batch_moments = _local_moments
    try:
        yield
    finally:
        layers._batch_moments = saved


def dp_snap(state, loss=None):
    return {"params": {k: v.detach().clone() for k, v in state.params.items()},
            "trace": {k: v.clone() for k, v in state.opt_state.items()},
            "polyak": {k: v.clone() for k, v in state.polyak.items()},
            "stats": {k: v.clone() for k, v in state.stats.items()},
            "loss": None if loss is None else float(loss)}


def dp_step(torch, model, batch, mesh=None, ghost=False):
    """(state before, state after, the step's state): one step of
    train_setup's step, sharded over ``mesh`` when given, on a copy of
    ``model``."""
    import copy
    from segtpu_torch.parallel import make_sharded_train_step
    state, step = train_setup(torch, copy.deepcopy(model))
    if mesh is not None:
        step = make_sharded_train_step(step, mesh)
    before = dp_snap(state)
    with ghost_bn(ghost):
        state, loss = step(state, batch)
    return before, dp_snap(state, loss), state


def _dist(torch, a, b, group):
    return float(torch.sqrt(sum(
        (a[k].double() - b[k].double()).square().sum()
        for k in a if k.startswith(group + "."))))


def dp_compare(torch, want, reverse, before, got):
    """(worst ratio of error to limit, rows): the sharded step's state
    against the unsharded step's by the rule above; ``reverse`` the
    unsharded step's own run on the batch reversed, or a list of such
    runs, whose largest spread counts."""
    rows = [("loss", None, abs(got["loss"] - want["loss"])
             / abs(want["loss"]), DP_LOSS_RTOL)]
    for key in ("params", "trace", "polyak", "stats"):
        for group in ("encoder", "decoder"):
            spread = max(_dist(torch, r[key], want[key], group) for r in (
                reverse if isinstance(reverse, list) else [reverse]))
            update = _dist(torch, want[key], before[key], group)
            rows.append((key, group, _dist(torch, got[key], want[key], group),
                         max(DP_FLOOR[key] * update, DP_SPREAD * spread)))
    return max(err / limit for _, _, err, limit in rows), rows


def dp_step_check(torch, model, batch, mesh, ghost=False):
    """(what, ok, detail), worst ratio: the sharded step against the
    unsharded step on the whole batch."""
    rev = {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}
    before, want, _ = dp_step(torch, model, batch)
    reverse = dp_step(torch, model, rev)[1]
    got = dp_step(torch, model, batch, mesh, ghost)[1]
    worst, rows = dp_compare(torch, want, reverse, before, got)
    return ((f"sharded train step on {DP_SHARDS} logical shards vs "
             f"unsharded", worst <= 1.0,
             f"worst error / limit {worst!r}: " + ", ".join(
                 f"{k}{'' if g is None else ' ' + g} {e:.3g}/{lim:.3g}"
                 for k, g, e, lim in rows)), worst)


def dp_eval_check(torch, state, batch, mesh, fault=False):
    """(what, ok, detail): the sharded eval's confusion matrix against
    the unsharded one's on the trained state. ``fault`` (a control):
    every shard evaluates the first shard's rows."""
    from segtpu_torch.engine.trainer import eval_params_stats, make_eval_step
    from segtpu_torch.parallel import make_sharded_eval_step, mesh as pm
    ev = make_eval_step(state.model.genotype, num_classes=K)
    params, stats = eval_params_stats(state)
    shard_batch = pm.shard_batch
    if fault:
        pm.shard_batch = lambda m, b: [shard_batch(m, b)[0]] * DP_SHARDS
    try:
        got = make_sharded_eval_step(ev, mesh)(params, stats, batch)
    finally:
        pm.shard_batch = shard_batch
    want = ev(params, stats, batch)
    diff = int((got - want).abs().sum())
    return (f"sharded eval on {DP_SHARDS} logical shards vs unsharded",
            bool(torch.equal(got, want)),
            f"confusion matrices differ in {diff} of {int(want.sum())} "
            f"counts")


def dp_run_training(torch, tmp, data_parallel: bool, seed: int,
                    devices=None):
    """(per-step losses, state, seconds, the data axis of each sharded
    step it built): run_training on the card, one epoch of
    SyntheticDataset(DP_RUN_IMAGES) at TrainConfig's batch and crop,
    validated once, sharded over ``devices`` when given."""
    import segtpu_torch.train as tr
    from segtpu_torch.data.datasets import BatchLoader, SyntheticDataset
    from segtpu_torch.models import ARCHS
    cfg = dataclasses.replace(
        train_config(), num_epochs=1, val_every=1,
        data_parallel=data_parallel, seed=seed,
        snapshot_dir=os.path.join(tmp, f"dp{data_parallel}{devices}"))
    ds = SyntheticDataset(n=DP_RUN_IMAGES, hw=cfg.crop_size, num_classes=K)
    loaders = [BatchLoader(ds, batch_size=cfg.batch_size, crop=cfg.crop_size,
                           train=t) for t in (True, False)]
    real, losses = tr.hard_sync, []
    real_sharded, meshes = tr.make_sharded_train_step, []

    def sharding(step, mesh):
        meshes.append(mesh.shape["data"])
        return real_sharded(step, mesh)

    def recording(loss):
        # run_training syncs on each step's loss
        real(loss)
        losses.append(float(loss))

    tr.hard_sync, tr.make_sharded_train_step = recording, sharding
    try:
        t0 = time.perf_counter()
        _, state = tr.run_training(ARCHS["arch0"], *loaders, cfg,
                                   device="cuda", devices=devices)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        tr.hard_sync, tr.make_sharded_train_step = real, real_sharded
    return losses, state, secs, meshes


def dp_run_checks(torch, tmp, control: bool = False):
    """[(what, ok, detail)], numbers: run_training with data_parallel on
    the one card (unsharded, as the JAX package on one device), and over
    DP_SHARDS logical shards of it (``devices``), each against the run
    without it. ``control``: the one-card run's model from the next
    seed, the sharded run under ghost BN."""
    base, _, base_s, _ = dp_run_training(torch, tmp, False, TRAIN_SEED)
    n = DP_RUN_IMAGES // train_config().batch_size
    checks, nums = [], {"unsharded_losses": base, "unsharded_seconds": base_s}
    runs = ((f"on {torch.cuda.device_count()} card", None, DP_RUN_RTOL, [],
             TRAIN_SEED + control, False),
            (f"over {DP_SHARDS} logical shards of the card",
             dp_mesh(torch).devices, DP_LOSS_RTOL, [DP_SHARDS], TRAIN_SEED,
             control))
    for key, (where, devices, rtol, meshes, seed, ghost) in zip(
            ("run_training", "run_training_sharded"), runs):
        with ghost_bn(ghost):
            got, state, secs, built = dp_run_training(
                torch, tmp, True, seed, devices)
        worst = max(abs(g - w) / abs(w) for g, w in zip(got, base))
        ok = (built == meshes and len(got) == len(base) == n
              and state.step == n and all(np.isfinite(got))
              and worst <= rtol)
        checks.append((f"run_training data_parallel {where} vs without", ok,
                       f"sharded steps built {built}, {len(got)} steps, "
                       f"losses {got!r} against {base!r}: worst rel "
                       f"{worst!r} (limit {rtol})"))
        nums[key] = {"losses": got, "worst_rel": worst, "seconds": secs,
                     "sharded_steps_built": built}
    return checks, nums


def dp_step_ms(torch, model, batch, mesh=None):
    """ms a step over DP_TIMED steps after one, CUDA events."""
    import copy
    from segtpu_torch.parallel import make_sharded_train_step
    state, step = train_setup(torch, copy.deepcopy(model))
    if mesh is not None:
        step = make_sharded_train_step(step, mesh)
    state, _ = step(state, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(DP_TIMED):
        state, _ = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / DP_TIMED


def dp_mesh(torch):
    from segtpu_torch.parallel import make_mesh
    return make_mesh(DP_SHARDS, 1, devices=[torch.device("cuda", 0)]
                     * DP_SHARDS)


def phase_data_parallel(torch):
    """Phase 13 (see the module doc). Returns its numbers for the JSON."""
    import tempfile
    torch.cuda.empty_cache()
    gpu = gpu_line()
    t_phase = time.perf_counter()
    batch = dp_batch()
    gbatch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = train_model(torch).cuda()
    mesh = dp_mesh(torch)
    res = {"gpu": gpu, "shards": DP_SHARDS}
    with tf32(torch, False):
        step_chk, res["step_worst"] = dp_step_check(torch, model, batch,
                                                    mesh)
        state = dp_step(torch, model, gbatch)[2]
        eval_chk = dp_eval_check(torch, state, gbatch, mesh)
        os.makedirs("chiprun_out", exist_ok=True)
        with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
            run_chks, res["run_training"] = dp_run_checks(torch, tmp)
        res["unsharded_ms"] = dp_step_ms(torch, model, gbatch)
        res["sharded_ms"] = dp_step_ms(torch, model, gbatch, mesh)
    for what, ok, detail in (step_chk, eval_chk, *run_chks):
        print(f"[data_parallel] {what}: {detail} on {gpu}")
        check(ok, f"{what}: {detail}")
    print(f"[data_parallel] arch0 aux {dims(batch)} TF32 off: unsharded "
          f"{res['unsharded_ms']:.4f} ms a step, sharded over {DP_SHARDS} "
          f"logical shards {res['sharded_ms']:.4f} ms ({DP_TIMED} timed "
          f"after 1); run_training data_parallel one epoch "
          f"{res['run_training']['run_training']['seconds']:.2f} s, over "
          f"{DP_SHARDS} logical shards "
          f"{res['run_training']['run_training_sharded']['seconds']:.2f} s, "
          f"against {res['run_training']['unsharded_seconds']:.2f} s "
          f"without, on {gpu}")
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[data_parallel] phase: {res['phase_s']:.2f} s on {gpu}")
    return res


def data_parallel_control(torch) -> dict:
    """The control's data-parallel checks: the sharded step under ghost
    BN, the sharded eval with every shard on the first shard's rows,
    run_training's one-card data_parallel run from the next seed and its
    run over logical shards under ghost BN. Returns {check: failed}."""
    import tempfile
    batch = dp_batch()
    gbatch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    model = train_model(torch).cuda()
    mesh = dp_mesh(torch)
    with tf32(torch, False):
        checks = [dp_step_check(torch, model, batch, mesh, ghost=True)[0]]
        state = dp_step(torch, model, gbatch)[2]
        checks.append(dp_eval_check(torch, state, gbatch, mesh, fault=True))
        os.makedirs("chiprun_out", exist_ok=True)
        with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
            checks += dp_run_checks(torch, tmp, control=True)[0]
    return {what: must_fail(what, lambda: check(ok, f"{what}: {detail}"))
            for what, ok, detail in checks}


# ---------------------------------------------------------------------------
# Phase 14: the CLI's fidelity on the card
# ---------------------------------------------------------------------------

# the drill's image (tests/test_fidelity_drill.py: 56x72, padded to
# 64x96) gated at FIDELITY_MAX_DLOGIT, and the headline frame
FIDELITY_SHAPES = ((56, 72), (H, W))
FIDELITY_MAX_DLOGIT = 1e-3


def fidelity_files(torch, tmp, hw, seed: int):
    """(checkpoint, golden): a torch checkpoint of make_model's arch0 (K =
    19, BatchNorm perturbed) from ``seed``, and the golden of a seeded
    uint8 frame of ``hw``: the unfolded model's f32 logits on the CPU
    (normalized, padded to the stride, bilinear with align_corners,
    cropped), [H, W, K]."""
    import torch.nn.functional as F
    from segtpu_torch.utils.helpers import prepare_img
    model = make_model(torch, seed=seed).eval()
    ckpt = os.path.join(tmp, f"arch0_seed{seed}.ckpt")
    torch.save(model.state_dict(), ckpt)
    h, w = hw
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    img = np.random.default_rng(31).integers(0, 256, (h, w, 3),
                                             dtype=np.uint8)
    x = np.pad(prepare_img(img), ((0, hp - h), (0, wp - w), (0, 0)))
    with torch.no_grad():
        logits = model(torch.from_numpy(np.ascontiguousarray(
            np.transpose(x[None], (0, 3, 1, 2)))))
        logits = F.interpolate(logits, size=(hp, wp), mode="bilinear",
                               align_corners=True)[:, :, :h, :w]
    golden = os.path.join(tmp, f"golden_{h}x{w}.npz")
    np.savez(golden, image=img,
             logits=np.ascontiguousarray(
                 np.transpose(logits[0].numpy(), (1, 2, 0))))
    return ckpt, golden


def run_fidelity(torch, ckpt, golden, max_dlogit=None):
    """(exit code, worst max|dlogit|, output) of ``main_search fidelity``
    on the card."""
    import io
    from segtpu_torch import main_search
    argv = ["fidelity", "--arch", "arch0", "--num-classes", str(K), "--ckpt",
            ckpt, "--golden", golden, "--device", "cuda"]
    if max_dlogit is not None:
        argv += ["--max-dlogit", str(max_dlogit)]
    out, rc = io.StringIO(), 0
    with contextlib.redirect_stdout(out):
        try:
            main_search.main(argv)
        except SystemExit as e:
            rc = e.code
    text = out.getvalue()
    worst = float(text.rsplit("worst max|dlogit|:", 1)[1].split()[0])
    return rc, worst, text


def fidelity_checks(torch, tmp, wrong: bool = False):
    """[(what, ok, detail)], numbers: the CLI's fidelity at each of
    FIDELITY_SHAPES with --max-dlogit FIDELITY_MAX_DLOGIT; ``wrong`` (a
    control): the checkpoint of the next seed against the golden."""
    checks, nums = [], {}
    for hw in FIDELITY_SHAPES:
        ckpt, golden = fidelity_files(torch, tmp, hw, 0)
        if wrong:
            ckpt, _ = fidelity_files(torch, tmp, (32, 32), 1)
        t0 = time.perf_counter()
        rc, worst, text = run_fidelity(torch, ckpt, golden,
                                       FIDELITY_MAX_DLOGIT)
        secs = time.perf_counter() - t0
        what = f"fidelity {hw[0]}x{hw[1]} f32 on the card vs the CPU golden"
        checks.append((what, rc == 0 and worst <= FIDELITY_MAX_DLOGIT,
                       f"exit {rc}, worst max|dlogit| {worst!r} (limit "
                       f"{FIDELITY_MAX_DLOGIT})"))
        nums[f"{hw[0]}x{hw[1]}"] = {"worst": worst, "rc": rc,
                                    "seconds": secs, "output": text}
    return checks, nums


def phase_fidelity(torch):
    """Phase 14 (see the module doc). Returns its numbers for the JSON."""
    import tempfile
    torch.cuda.empty_cache()
    gpu = gpu_line()
    t_phase = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        checks, nums = fidelity_checks(torch, tmp)
    for what, ok, detail in checks:
        print(f"[fidelity] {what}: {detail} on {gpu}")
        check(ok, f"{what}: {detail}")
    for shape, r in nums.items():
        print(f"[fidelity] {shape}: worst max|dlogit| {r['worst']!r} "
              f"({r['seconds']:.2f} s with the golden's checks) on {gpu}")
    res = {"gpu": gpu, "shapes": nums,
           "phase_s": time.perf_counter() - t_phase}
    print(f"[fidelity] phase: {res['phase_s']:.2f} s on {gpu}")
    return res


def fidelity_control(torch) -> dict:
    """The control's fidelity checks, on a wrong checkpoint. Returns
    {check: failed}."""
    import tempfile
    os.makedirs("chiprun_out", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="chiprun_out") as tmp:
        checks, _ = fidelity_checks(torch, tmp, wrong=True)
    return {what: must_fail(what, lambda: check(ok, f"{what}: {detail}"))
            for what, ok, detail in checks}


# ---------------------------------------------------------------------------
# Phase 15: the space axis of sharded training on logical shards of the card
# ---------------------------------------------------------------------------

# phase data_parallel's configuration and rule on (data, space) meshes of
# logical shards of the card, and one step at the full resolution the axis
# is for. The unsharded step's own spread is the larger of its run on the
# batch reversed and on the images one rounding up (np.nextafter): at b2
# reversing the batch barely reorders a sum (on the CPU at 2x64x128 it
# moved the parameters by 1e-8, the images one rounding apart by 9e-5,
# and the (1, 4) bands, which sum each convolution's rows in another
# order, by 4e-5)
SPACE_MESHES = ((1, 2), (2, 2))
SPACE_FULL_MESH = (1, 4)
SPACE_FULL_BATCH = 2


@contextlib.contextmanager
def zero_halos(on: bool):
    """The phase's own control (and the --control's fault), when ``on``:
    every band reads zeros past its cuts, not the other shards' rows."""
    import copy
    from segtpu_torch.core import bands
    real = bands.Bands.rows

    def rows(self, lo, hi):
        own = copy.copy(self)
        own.parts = [p if i == self.rank else p.new_zeros(p.shape)
                     for i, p in enumerate(self.parts)]
        return real(own, lo, hi)

    if on:
        bands.Bands.rows = rows
    try:
        yield
    finally:
        bands.Bands.rows = real


def full_batch():
    """SPACE_FULL_BATCH frames of H x W (the serving phases' 1024x2048)
    as phase train's batch: normal images, K classes, a band of 255, and
    the first image's top quarter ignored too (the bands' valid counts
    differ)."""
    rng = np.random.default_rng(24)
    image = rng.standard_normal((SPACE_FULL_BATCH, H, W, 3), dtype=np.float32)
    label = rng.integers(0, K, (SPACE_FULL_BATCH, H, W)).astype(np.int32)
    label[:, H * 25 // 64:H * 29 // 64] = 255
    label[0, :H // 4] = 255
    return {"image": image, "label": label}


def space_mesh(torch, shape):
    from segtpu_torch.parallel import make_mesh
    return make_mesh(*shape, devices=[torch.device("cuda", 0)]
                     * (shape[0] * shape[1]))


def space_step_checks(torch, model, batch, runs):
    """[(what, ok, detail)], {mesh: worst ratio}: one step sharded on each
    (data, space) mesh of ``runs`` ((mesh, zero_halos) pairs) against the
    unsharded step on the whole batch, by phase data_parallel's rule
    (dp_compare) with the spread above."""
    rev = {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}
    up = dict(batch, image=np.nextafter(batch["image"], np.float32(np.inf)))
    before, want, _ = dp_step(torch, model, batch)
    spreads = [dp_step(torch, model, b)[1] for b in (rev, up)]
    out, worst = [], {}
    for shape, halos in runs:
        with zero_halos(halos):
            got = dp_step(torch, model, batch, space_mesh(torch, shape))[1]
        w, rows = dp_compare(torch, want, spreads, before, got)
        worst[f"{shape}{' zero halos' if halos else ''}"] = w
        out.append((f"space step on a {shape} mesh of logical shards vs "
                    f"unsharded, {dims(batch)}", w <= 1.0,
                    f"worst error / limit {w!r}: " + ", ".join(
                        f"{k}{'' if g is None else ' ' + g} {e:.3g}/{lim:.3g}"
                        for k, g, e, lim in rows)))
    return out, worst


def space_eval_check(torch, state, batch, shape, halos=False):
    """(what, ok, detail), numbers: the eval sharded on a (data, space)
    mesh against the unsharded eval on the trained state. The confusion
    matrices equal, or the slice's near-tie rule: every pixel whose class
    differs a near-tie (top-2 gap <= NEAR_TIE of max(|top1|, 1)) of the
    unsharded eval's logits (cuDNN picks its algorithms at a band's
    shapes, and a rounding apart flips a near-tie). The classes and the
    logits are read where the eval step makes them."""
    from segtpu_torch.core import bands
    from segtpu_torch.engine import trainer
    from segtpu_torch.parallel import make_sharded_eval_step
    ev = trainer.make_eval_step(state.model.genotype, num_classes=K)
    params, stats = trainer.eval_params_stats(state)
    preds, logits = {}, []
    cm_fn, resize_fn = trainer.confusion_matrix, trainer.resize_bilinear

    def cm_recording(pred, label, k):
        member = bands.mesh_member()
        preds[None if member is None else member[1]] = pred
        return cm_fn(pred, label, k)

    def resize_recording(*a, **kw):
        out = resize_fn(*a, **kw)
        if bands.mesh_member() is None:
            logits.append(out)
        return out

    trainer.confusion_matrix = cm_recording
    trainer.resize_bilinear = resize_recording
    try:
        with zero_halos(halos):
            got = make_sharded_eval_step(ev, space_mesh(torch, shape))(
                params, stats, batch)
        want = ev(params, stats, batch)
    finally:
        trainer.confusion_matrix, trainer.resize_bilinear = cm_fn, resize_fn
    data, space = shape
    pred = torch.cat([torch.cat([preds[d * space + s] for s in range(space)],
                                1) for d in range(data)])
    top = logits[0].float().topk(2, dim=1).values
    gaps = (top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(1.0)
    differ = pred != preds[None]
    off = int((differ & (gaps > NEAR_TIE)).sum())
    widest = gaps[differ].max().item() if bool(differ.any()) else 0.0
    counts = int((got - want).abs().sum())
    # the classes read are those the sharded matrix counts
    read = torch.equal(cm_fn(pred, torch.as_tensor(batch["label"]).to(
        pred.device).long(), K).to(got.device), got)
    nums = {"cm_counts_differ": counts, "pixels_differ": int(differ.sum()),
            "off_near_ties": off, "widest_gap": widest}
    return ((f"space eval on a {shape} mesh of logical shards vs unsharded",
             off == 0 and read,
             f"confusion matrices differ in {counts} of {int(want.sum())} "
             f"counts; {int(differ.sum())} pixels' classes differ, "
             f"{off} of them off near-ties (gap > {NEAR_TIE}; widest "
             f"{widest!r})"), nums)


def step_ms_peak(torch, model, batch, mesh=None):
    """(ms a step, peak bytes over those steps) of dp_step_ms."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = dp_step_ms(torch, model, batch, mesh)
    return ms, torch.cuda.max_memory_allocated()


def space_checks(torch, control: bool = False):
    """([(what, ok, detail)], [the zero-halo step's], numbers): the step
    on SPACE_MESHES at phase train's batch and on SPACE_FULL_MESH at
    full_batch(), the eval on SPACE_MESHES[1]; without ``control`` also
    the step on SPACE_MESHES[0] under zero halos, which must fail; with
    it (the --control's) every check runs under zero halos."""
    batch = dp_batch()
    model = train_model(torch).cuda()
    runs = [(m, control) for m in SPACE_MESHES]
    with tf32(torch, False):
        steps, worst = space_step_checks(
            torch, model, batch,
            runs + ([] if control else [(SPACE_MESHES[0], True)]))
        full, w_full = space_step_checks(torch, model, full_batch(),
                                         [(SPACE_FULL_MESH, control)])
        state = dp_step(torch, model, {k: torch.from_numpy(v).cuda()
                                       for k, v in batch.items()})[2]
        eval_chk, eval_nums = space_eval_check(torch, state, batch,
                                               SPACE_MESHES[1], control)
    worst.update(w_full)
    return (steps[:len(runs)] + full + [eval_chk], steps[len(runs):],
            {"worst": worst, "eval": eval_nums})


def phase_space(torch):
    """Phase 15 (see the module doc). Returns its numbers for the JSON."""
    torch.cuda.empty_cache()
    gpu = gpu_line()
    t_phase = time.perf_counter()
    checks, [(what, ok, detail)], res = space_checks(torch)
    res["gpu"] = gpu
    for c_what, c_ok, c_detail in checks:
        print(f"[space] {c_what}: {c_detail} on {gpu}")
        check(c_ok, f"{c_what}: {c_detail}")
    print(f"[space] control, zero halos: {what}: {detail} on {gpu}")
    check(not ok, f"zero halos passed the rule: {detail}")
    model = train_model(torch).cuda()
    ms = {}
    with tf32(torch, False):
        for name, b, shape in (
                ("b16", dp_batch(), None),
                *((f"b16 {m}", dp_batch(), m) for m in SPACE_MESHES),
                ("full", full_batch(), None),
                (f"full {SPACE_FULL_MESH}", full_batch(), SPACE_FULL_MESH)):
            gb = {k: torch.from_numpy(v).cuda() for k, v in b.items()}
            ms[name] = step_ms_peak(torch, model, gb, None if shape is None
                                    else space_mesh(torch, shape))
            print(f"[space] arch0 aux {dims(b)} TF32 off, "
                  f"{'unsharded' if shape is None else f'on {shape}'}: "
                  f"{ms[name][0]:.4f} ms a step ({DP_TIMED} timed after 1), "
                  f"peak {ms[name][1] / 2 ** 30:.3f} GiB (every shard on "
                  f"the one card) on {gpu}")
            del gb
    res["ms_peak"] = ms
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"[space] phase: {res['phase_s']:.2f} s on {gpu}")
    return res


def space_control(torch) -> dict:
    """The control's space checks, under zero halos. Returns {check:
    failed}."""
    checks, _, _ = space_checks(torch, control=True)
    return {what: must_fail(what, lambda: check(ok, f"{what}: {detail}"))
            for what, ok, detail in checks}


def main() -> None:
    try:
        from segtpu_torch.utils.helpers import CUBLAS_WORKSPACE
    except ImportError as e:
        fail(f"segtpu_torch is not importable beside this script: {e}")
    # before cuBLAS first runs, as main_search.main sets it: the search
    # phases' deterministic algorithms need this workspace
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a card")
    # the f32 reference comparisons use full f32 (no TF32) everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    if "--control" in sys.argv[1:]:
        bits = int(sys.argv[sys.argv.index("--control") + 1])
        res = phase_control(torch, bits)
        print(f"[control] {sum(res.values())} of {len(res)} checks fail")
        print(gpu_line())
        print(json.dumps({"control_bits": bits, "checks": res}))
        sys.exit(0 if all(res.values()) else 1)
    img, front_err = phase_front(torch)
    logits, tail_err = phase_tail(torch)
    work, stage_ms = phase_encoder(torch, img)
    dec_ms = phase_decoder(torch, work)
    seg, ref, frames, launches, _, masks, gaps = phase_slice(torch)
    seg_t, masks_t, t_launches, t_rate = template_slice(torch, frames)
    t = phase_timing(torch, img, logits, seg, ref, frames, gaps)
    x = torch.from_numpy(frames).cuda()
    t["template0_b8"] = cuda_ms(lambda: seg_t.predict_batch(x), 10)
    print(f"[timing] template0 predict_batch b8 {H}x{W}: "
          f"{t['template0_b8']:.4f} ms ({N * 1000.0 / t['template0_b8']:.1f} "
          f"images/s device-resident) on {gpu_line()}")
    work["upsample_argmax_sharded"] = sharded_tail(torch, logits, t["tail"])
    space_launches, space_rate = phase_sharded(torch, seg, ref, frames, masks,
                                               gaps, t)
    t_space_launches = template_sharded(torch, seg_t, frames, masks_t, t)
    launches.update({n: space_launches[n] for n in SHARDED_ONLY})
    exp_launches, exp_work, experiments = phase_experiments(torch)
    launches.update(exp_launches)
    work.update(exp_work)
    for name, r in work.items():
        for key in ("ms", "plain_ms", "library_ms", "tc_ms"):
            if key in r:
                t[f"{name}_{key}_path_sum"] = r[key]
        print(f"[timing] {name} over its {r['n']} measured launches: "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']!r} ms"
              + (f" (CUDA cores; tensor cores {r['tc_ms']:.4f} ms)"
                 if "tc_ms" in r else ""))
    # conv_chw's launches split: the stem (phase 4) and the decoder's 1x1s
    dec_conv = [c for c in dec_ms if c[0] == "main" and c[1] == "conv_chw"]
    t["conv_chw_split"] = {
        "stem": {"ms": stage_ms[0][2], "plain_ms": stage_ms[0][3],
                 "library_ms": stage_ms[0][4], "bound_ms": stage_ms[0][6]},
        "decoder_1x1": {"n": len(dec_conv),
                        "ms": sum(c[3] for c in dec_conv),
                        "plain_ms": sum(c[4] for c in dec_conv),
                        "library_ms": sum(c[5] for c in dec_conv),
                        "bound_ms": sum(c[6] for c in dec_conv),
                        "fma_floor_ms": sum(c[7] for c in dec_conv)}}
    print(f"[timing] conv_chw split: {t['conv_chw_split']}")
    b = bounds(work)
    work["front"] = dict(max_abs_err=front_err, ms=t["front"],
                         plain_ms=t["front_plain"], library_ms=None)
    work["upsample_argmax"] = dict(max_abs_err=tail_err, ms=t["tail"],
                                   plain_ms=t["tail_plain"],
                                   library_ms=t["tail_library"])
    kernels = []
    for name, (src, replaces) in KERNEL_ROWS.items():
        r = work[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"segtpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "template0_launches": t_launches[name],
            "path": "G2 b8 512x512" if name in G2_ONLY else
            f"space n={N_SHARDS} b8 1024x2048" if name in SHARDED_ONLY else
            f"segtpu_torch.scripts.{SCRIPT_OF[name]}" if name in SCRIPT_OF
            else "main b8 1024x2048",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": b[name][0],
            "bound_by": b[name][1], "library_ms": r["library_ms"],
            **({"tensor_cores_ms": r["tc_ms"],
                "tensor_cores_max_abs_err": r["tc_max_abs_err"]}
               if "tc_ms" in r else {}),
            **({"graph_ms": r["graph_ms"]} if "graph_ms" in r else {}),
            **({"old_ms": r["old_ms"]} if "old_ms" in r else {}),
            **({"floor_ms": r["floor_ms"], "floor_by": r["floor_by"]}
               if "floor_ms" in r else {})})
    train = phase_train(torch, frames)
    search = phase_search(torch)
    supernet = phase_supernet(torch)
    data_parallel = phase_data_parallel(torch)
    fidelity = phase_fidelity(torch)
    space = phase_space(torch)
    if "--profile" in sys.argv[1:]:
        profile(torch, seg, seg_t, frames)
        train["profile"] = profile_train(torch)
        supernet["profile"] = profile_supernet(torch)
    gpu = gpu_line()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"gpu": gpu, "kernels": kernels, "timing_ms": t,
                   "encoder_stage_ms": stage_ms, "decoder_call_ms": dec_ms,
                   "sharded": {
                       "n_shards": N_SHARDS, "space_launches": space_launches,
                       "space_mask_agreement": space_rate,
                       "tail_per_shard_ms":
                           work["upsample_argmax_sharded"]["per_shard_ms"]},
                   "template0": {
                       "launches": t_launches, "mask_agreement": t_rate,
                       "space_launches": t_space_launches},
                   "experiments": experiments, "train": train,
                   "search": search, "supernet": supernet,
                   "data_parallel": data_parallel, "fidelity": fidelity,
                   "space": space},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def profile(torch, seg, seg_t, frames):
    """Device time by kernel over two b8 calls of the unsharded engine,
    of the same with every encoder block on the tensor cores, of the
    space-sharded one (N_SHARDS logical shards), then of the template0
    engine ``seg_t``, each beside the calls' time on the host's clock."""
    from torch.profiler import ProfilerActivity, profile as prof
    from segtpu_torch.engine import ShardedSegmenter
    x = torch.from_numpy(frames).cuda()
    sharded = ShardedSegmenter(seg, [torch.device("cuda", 0)] * N_SHARDS)

    for what, fn, ctx in (
            ("unsharded", seg.predict_batch, contextlib.nullcontext()),
            ("unsharded, tensor-core encoder", seg.predict_batch,
             on_tensor_cores(seg.encoder)),
            (f"space n={N_SHARDS}", sharded.predict,
             contextlib.nullcontext()),
            ("template0 unsharded", seg_t.predict_batch,
             contextlib.nullcontext())):
        with ctx:
            fn(x)
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as p:
                t0 = time.perf_counter()
                for _ in range(2):
                    fn(x)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(r[1] for r in kernel_rows(torch, p))
        print(f"[profile] {what}: two calls {wall_ms:.2f} ms on the host's "
              f"clock (profiler on), {dev_ms:.2f} ms of device time")
        print(p.key_averages().table(sort_by="cuda_time_total",
                                     row_limit=22))


if __name__ == "__main__":
    main()
