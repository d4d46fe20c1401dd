"""Full training of a fixed architecture (counterpart: segtpu/train.py).

``run_training`` is the JAX package's loop: train steps over an epoch's
batches, the epoch's mean loss, validation every ``val_every`` epochs
(and after the last) on the Polyak weights with the live BatchNorm
stats, the best of them saved as ``best_params.npz`` in the JAX
package's checkpoint format, and an optional KD teacher run in eval
mode; with ``data_parallel`` and several devices, the batch split over
them. ``load_trained`` loads such a checkpoint, written by either
package, into a ``Segmenter`` that ``segtpu_torch.engine.Segmenter``
serves, and ``measure_checkpoint_miou`` measures one on a split.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional, Tuple

import torch

from segtpu_torch.convert.from_jax import load_jax_params, to_jax_tree
from segtpu_torch.engine.trainer import (eval_params_stats, images_to,
                                         init_train_state, make_eval_step,
                                         make_train_step, validate)
from segtpu_torch.models.segmenter import create_segmenter
from segtpu_torch.parallel.mesh import make_mesh, make_sharded_train_step
from segtpu_torch.utils.helpers import resolve_device
from segtpu_torch.utils.profiling import StepTimer, hard_sync
from segtpu_torch.utils.saver import load_pytree, save_pytree
from segtpu_torch.utils.solvers import create_optimisers

log = logging.getLogger("segtpu_torch.train")


@dataclasses.dataclass
class TrainConfig:
    """``run_training``'s settings. ``crop_size``, ``shorter_side`` (the
    scale jitter's base) and ``batch_size`` are what the caller's loaders
    are to use: ``run_training`` takes its batches as they come."""
    num_classes: int = 21
    crop_size: Tuple[int, int] = (512, 512)
    shorter_side: Optional[int] = 512
    batch_size: int = 16
    num_epochs: int = 100
    enc_lr: float = 1e-3
    dec_lr: float = 3e-3
    enc_wd: float = 1e-5
    dec_wd: float = 0.0
    enc_grad_clip: float = 3.0
    dec_grad_clip: float = 3.0
    aux_weight: float = 0.15
    do_polyak: bool = True
    do_kd: bool = False
    kd_coeff: float = 0.3
    val_every: int = 5
    seed: int = 42
    snapshot_dir: str = "snapshots/train"
    data_parallel: bool = False  # shard the batch over all devices


def run_training(genotype, train_loader, val_loader, cfg: TrainConfig, *,
                 model=None, teacher=None, device="cuda", devices=None):
    """Train ``genotype`` -> (best val mIoU, TrainState).

    ``model``: a ``Segmenter`` with aux heads to start from (on its own
    device); by default one with heads from ``torch.Generator`` seed
    ``cfg.seed`` on ``device``. ``teacher``: a ``Segmenter`` whose eval
    logits are the KD targets when ``cfg.do_kd``. The loaders yield the
    JAX package's batch dicts (``image`` f32 [N,H,W,3], ``label``).
    ``cfg.data_parallel`` splits each batch over ``devices``
    (``make_sharded_train_step`` on ``make_mesh(len(devices), 1)``; the
    batch size must divide by the count): by default every card of a
    CUDA ``device``. Over one device, as on one card or on the CPU by
    default, it trains unsharded, as the JAX package does on one
    device. A caller may repeat a device (``["cpu"] * 2``) to drive the
    sharded step on one."""
    if model is None:
        model = create_segmenter(
            genotype, cfg.num_classes, aux=True, device=resolve_device(device),
            generator=torch.Generator().manual_seed(cfg.seed))
    opt = create_optimisers(
        enc_lr=cfg.enc_lr, dec_lr=cfg.dec_lr, enc_wd=cfg.enc_wd,
        dec_wd=cfg.dec_wd, enc_grad_clip=cfg.enc_grad_clip,
        dec_grad_clip=cfg.dec_grad_clip)
    state = init_train_state(model, opt, do_polyak=cfg.do_polyak)
    step = make_train_step(genotype, opt, num_classes=cfg.num_classes,
                           aux_weight=cfg.aux_weight,
                           kd_coeff=cfg.kd_coeff if cfg.do_kd else 0.0)
    dev = next(model.parameters()).device
    if cfg.data_parallel:
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if dev.type == "cuda" else [dev])
        if len(devices) > 1:
            step = make_sharded_train_step(
                step, make_mesh(len(devices), 1, devices=devices))
            log.info("data-parallel over %d devices", len(devices))

    teacher_fn = None
    if cfg.do_kd and teacher is not None:
        teacher.eval()

        @torch.no_grad()
        def teacher_fn(image):
            return teacher(images_to(image, dev))

    eval_step = make_eval_step(genotype, num_classes=cfg.num_classes)
    os.makedirs(cfg.snapshot_dir, exist_ok=True)
    best = -1.0
    timer = StepTimer(warmup=2)
    for epoch in range(cfg.num_epochs):
        t0 = time.time()
        losses = []
        for batch in train_loader:
            b = {"image": batch["image"], "label": batch["label"]}
            if teacher_fn is not None:
                b["teacher"] = teacher_fn(b["image"])
            with timer.step(n_items=len(b["label"])):
                state, loss = step(state, b)
                hard_sync(loss)
            losses.append(loss)
        log.info("epoch %d: loss %.4f (%.1fs, %.1f img/s)", epoch,
                 float(torch.stack(losses).mean()), time.time() - t0,
                 timer.items_per_sec or 0.0)
        if (epoch + 1) % cfg.val_every == 0 or epoch == cfg.num_epochs - 1:
            eval_params, eval_stats = eval_params_stats(state)
            miou = validate(eval_step, eval_params, eval_stats, val_loader,
                            num_classes=cfg.num_classes)
            log.info("epoch %d: val mIoU %.4f (best %.4f)", epoch, miou, best)
            if miou > best:
                best = miou
                save_pytree(os.path.join(cfg.snapshot_dir, "best_params.npz"),
                            {"params": to_jax_tree(eval_params),
                             "stats": to_jax_tree(eval_stats)})
    return best, state


def load_trained(path: str, genotype, num_classes: int, *, device="cuda"):
    """A ``run_training`` best checkpoint (of either package) as a
    ``Segmenter`` with aux heads, in eval mode, on ``device``."""
    model = create_segmenter(genotype, num_classes, aux=True, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    tree = load_pytree(path)
    load_jax_params(model, tree["params"], tree["stats"])
    return model.to(resolve_device(device))


def measure_checkpoint_miou(ckpt_path: str, genotype, *, data_root: str,
                            val_list: str, num_classes: int,
                            crop=(64, 64), batch_size: int = 8,
                            device="cuda") -> float:
    """Val mIoU of a ``run_training`` best checkpoint on an on-disk split
    (a ``.lst`` manifest under ``data_root``), in eval batches of
    ``crop``: the one implementation behind every measurement of a
    reused checkpoint, so that two of them cannot measure different
    splits."""
    from segtpu_torch.data.datasets import BatchLoader, SegmentationDataset
    model = load_trained(ckpt_path, genotype, num_classes, device=device)
    params = {n: p.detach() for n, p in model.named_parameters()}
    stats = dict(model.named_buffers())
    loader = BatchLoader(SegmentationDataset(data_root, val_list),
                         batch_size=batch_size, crop=crop, train=False)
    return float(validate(make_eval_step(genotype, num_classes=num_classes),
                          params, stats, loader, num_classes=num_classes))
