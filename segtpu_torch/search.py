"""The NAS outer loop (counterpart: segtpu/search.py).

Each iteration: the controller samples a genotype; its decoder is built
(an invalid genotype scores ``invalid_reward`` and the loop goes on);
stage 1 trains the decoder alone on the encoder's cached taps, stage 2
the whole segmenter end to end for a short while, each followed by
validation; the reward, the geometric mean of the two mIoUs, drives one
policy update.

The encoder's taps of the fixed (unaugmented) meta-train and meta-val
crops are computed once per search and stay on the device. Training and
evaluation run through ``engine.trainer`` (library convolutions forward
and backward, as the JAX package's run through XLA): no hand-written
kernel is on this path. Decoder weights come from a ``torch.Generator``
seeded ``cfg.seed + step`` (``init_decoder``), the controller's draws
from a generator on the device seeded from ``cfg.seed`` and the step;
the data layer draws from numpy's generators as the JAX package does.
"""

from __future__ import annotations

import copy
import logging
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from segtpu_torch.config import SearchConfig
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.data.datasets import (BatchLoader, SegmentationDataset,
                                        SyntheticDataset, create_loaders)
from segtpu_torch.engine.trainer import (
    _labels_to, decoder_dims, eval_params_stats, images_to, init_train_state,
    make_decoder_train_step, make_encoder_cache_fn, make_eval_step,
    make_train_step)
from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS, MobileNetV2
from segtpu_torch.models.families import infer_family
from segtpu_torch.models.micro_decoders import GenotypeError, prettify
from segtpu_torch.models.segmenter import Segmenter
from segtpu_torch.rl.agent import create_agent, sample_genotype, train_agent
from segtpu_torch.rl.controller import (MicroControllerSpec,
                                        TemplateControllerSpec)
from segtpu_torch.utils.helpers import deterministic, resolve_device
from segtpu_torch.utils.metrics import confusion_matrix, mean_iou
from segtpu_torch.utils.saver import SearchSaver
from segtpu_torch.utils.solvers import create_optimisers, sgd_chain

log = logging.getLogger("segtpu_torch.search")


def _seed(*words: int) -> int:
    """A 64-bit seed from integers, for independent generator streams."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def _make_dataset(cfg: SearchConfig):
    if cfg.synthetic or not cfg.train_list:
        return SyntheticDataset(n=32, hw=cfg.crop_size,
                                num_classes=cfg.num_classes, seed=cfg.seed)
    return SegmentationDataset(cfg.data_root, cfg.train_list)


def _cache_taps(encoder, loader) -> List[Dict[str, Any]]:
    """The encoder-feature cache: each batch of the fixed crops of
    ``loader`` -> its 4 taps and its labels, on the encoder's device."""
    cache_fn = make_encoder_cache_fn()
    dev = next(encoder.parameters()).device
    return [{"taps": cache_fn(encoder, batch["image"]),
             "label": _labels_to(batch["label"], dev)} for batch in loader]


def init_decoder(genotype, cfg: SearchConfig, *, seed: int, device):
    """The decoder a proxy training starts from (with aux heads, and aux
    cells as ``cfg.aux_cell`` says), drawn from a CPU ``torch.Generator``
    seeded ``seed``, on ``device``. Raises ``GenotypeError`` for an
    invalid genotype."""
    fam = infer_family(genotype)
    fam.validate(genotype)
    return fam.build(genotype, MBV2_TAP_CHANNELS, cfg.num_classes,
                     agg_size=cfg.agg_size, repeats=cfg.sep_repeats,
                     aux=True, aux_cell=cfg.aux_cell,
                     generator=torch.Generator().manual_seed(seed)).to(device)


def _make_decoder_eval_step(genotype, num_classes: int, fam):
    """Stage 1's eval step: ``step(params, stats, batch)`` over cached
    taps -> the [K, K] confusion matrix; the decoder's logits upsampled
    in f32 to the labels' size, argmax with ties to the lower class. As
    ``make_eval_step``, a skeleton of the decoder at the width and repeat
    count the parameters imply runs on them."""
    skeletons = {}

    @torch.no_grad()
    def step(params, stats, batch):
        dims = decoder_dims(params, prefix="")
        if dims not in skeletons:
            dec = fam.build(genotype, MBV2_TAP_CHANNELS, num_classes,
                            agg_size=dims[0], repeats=dims[1],
                            generator=torch.Generator().manual_seed(0))
            skeletons[dims] = dec, list(dec.state_dict().keys())
        dec, keys = skeletons[dims]
        merged = {**params, **stats}
        logits = torch.func.functional_call(
            dec, {k: merged[k] for k in keys}, (list(batch["taps"]),))
        label = batch["label"]
        logits = resize_bilinear(logits, label.shape[-2:],
                                 compute_dtype=torch.float32)
        pred = torch.argmax(logits.float(), dim=1)
        return confusion_matrix(pred, label, num_classes)

    return step


def _sync(dev) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def stage1_reward(genotype, cfg: SearchConfig, cached_train, cached_val, *,
                  rng_seed: int, device, kd_coeff: float = 0.0,
                  timings: Optional[dict] = None):
    """Stage 1 of a proxy training: ``genotype``'s decoder from
    ``init_decoder(seed=rng_seed)`` trained alone over the cached tap
    batches for ``cfg.num_epochs[0]`` epochs, then evaluated over the
    cached val batches -> (miou1, the train state). ``timings``, when
    given, receives the steps and seconds of the training and of the
    evaluation (the device synchronized around them)."""
    dev = torch.device(device)
    fam = infer_family(genotype)
    dec = init_decoder(genotype, cfg, seed=rng_seed, device=dev)
    t0 = _sync(dev)
    opt_dec = sgd_chain(cfg.dec_lr, momentum=0.9, wd=cfg.dec_wd,
                        clip=cfg.dec_grad_clip)
    state = init_train_state(dec, opt_dec, do_polyak=cfg.do_polyak)
    step1 = make_decoder_train_step(genotype, opt_dec,
                                    num_classes=cfg.num_classes,
                                    aux_weight=cfg.dec_aux_weight,
                                    kd_coeff=kd_coeff)
    for _ in range(cfg.num_epochs[0]):
        for batch in cached_train:
            state, loss = step1(state, batch)
    t1 = _sync(dev)
    eval_dec = _make_decoder_eval_step(genotype, cfg.num_classes, fam)
    eval_params, eval_stats = eval_params_stats(state)
    cm = np.zeros((cfg.num_classes, cfg.num_classes), np.int64)
    for batch in cached_val:
        cm += eval_dec(eval_params, eval_stats, batch).cpu().numpy()
    if timings is not None:
        timings.update(stage1_steps=cfg.num_epochs[0] * len(cached_train),
                       stage1_s=t1 - t0, eval1_s=_sync(dev) - t1)
    return mean_iou(cm), state


def proxy_train(genotype, encoder, cfg: SearchConfig, cached_train,
                cached_val, train_loader, val_loader, *, rng_seed: int = 0,
                teacher_fn=None, timings: Optional[dict] = None):
    """Two-stage proxy training of one genotype -> (miou1, miou2).

    ``encoder``: the search's encoder module (not changed: stage 2 trains
    a copy). ``cached_train``/``cached_val``: the device-resident tap
    batches of stage 1 (a batch may carry ``teacher`` logits for KD);
    ``train_loader``/``val_loader``: the image loaders of stage 2;
    ``teacher_fn`` (images -> logits) gives KD targets for each augmented
    batch when ``cfg.do_kd``. ``timings``, when given, receives each
    stage's steps and seconds (the device synchronized around them)."""
    dev = next(encoder.parameters()).device
    kd_coeff = cfg.kd_coeff if cfg.do_kd else 0.0
    miou1, state = stage1_reward(genotype, cfg, cached_train, cached_val,
                                 rng_seed=rng_seed, device=dev,
                                 kd_coeff=kd_coeff, timings=timings)

    # ---- stage 2: a short end-to-end fine-tune ----
    t2 = _sync(dev)
    model = Segmenter.from_parts(genotype, cfg.num_classes,
                                 copy.deepcopy(encoder), state.model)
    opt2 = create_optimisers(enc_lr=cfg.enc_lr, dec_lr=cfg.dec_lr,
                             enc_wd=cfg.enc_wd, dec_wd=cfg.dec_wd,
                             enc_grad_clip=cfg.enc_grad_clip,
                             dec_grad_clip=cfg.dec_grad_clip)
    state2 = init_train_state(model, opt2, do_polyak=cfg.do_polyak)
    step2 = make_train_step(genotype, opt2, num_classes=cfg.num_classes,
                            aux_weight=cfg.dec_aux_weight, kd_coeff=kd_coeff)
    for _ in range(cfg.num_epochs[1]):
        for batch in train_loader:
            batch = {"image": batch["image"], "label": batch["label"]}
            if teacher_fn is not None:
                batch["teacher"] = teacher_fn(batch["image"])
            state2, loss = step2(state2, batch)
    t3 = _sync(dev)
    eval_full = make_eval_step(genotype, num_classes=cfg.num_classes)
    eval_params2, eval_stats2 = eval_params_stats(state2)
    cm = np.zeros((cfg.num_classes, cfg.num_classes), np.int64)
    for batch in val_loader:
        cm += eval_full(eval_params2, eval_stats2, batch).cpu().numpy()
    miou2 = mean_iou(cm)
    if timings is not None:
        timings.update(
            stage2_steps=cfg.num_epochs[1] * len(train_loader),
            stage2_s=t3 - t2, eval2_s=_sync(dev) - t3)
    return miou1, miou2


def compute_reward(miou1: float, miou2: float) -> float:
    """Geometric mean of the two proxy stages' mIoUs; NaN counts as 0."""
    m1 = max(miou1, 0.0) if math.isfinite(miou1) else 0.0
    m2 = max(miou2, 0.0) if math.isfinite(miou2) else 0.0
    return math.sqrt(m1 * m2)


def search_loaders(cfg: SearchConfig, dataset):
    """{"train", "val": the proxy task's stage-2 loaders; "cache_train",
    "cache_val": the fixed-crop loaders of the encoder cache, batch
    ``cfg.batch_size[0]``} over ``dataset``."""
    train_loader, val_loader = create_loaders(
        dataset, batch_size=cfg.batch_size[1], crop=cfg.crop_size,
        meta_train_prct=cfg.meta_train_prct,
        shorter_side=cfg.shorter_side, seed=cfg.seed)
    loaders = {"train": train_loader, "val": val_loader}
    for name, src in (("cache_train", train_loader),
                      ("cache_val", val_loader)):
        loaders[name] = BatchLoader(
            dataset, batch_size=cfg.batch_size[0], crop=cfg.crop_size,
            train=False, seed=cfg.seed, indices=src.indices)
    return loaders


def search_setup(cfg: SearchConfig, dataset, encoder, device, *,
                 enc_seed: Optional[int] = None):
    """-> (dataset, encoder on ``device``, ``search_loaders``).
    ``dataset`` defaults to ``cfg``'s; ``encoder`` to a ``MobileNetV2``
    drawn from ``enc_seed`` (default ``_seed(cfg.seed, 0)``), or
    ``cfg.enc_ckpt``'s weights."""
    dataset = dataset if dataset is not None else _make_dataset(cfg)
    if encoder is None:
        encoder = MobileNetV2(generator=torch.Generator().manual_seed(
            _seed(cfg.seed, 0) if enc_seed is None else enc_seed))
        if cfg.enc_ckpt:
            from segtpu_torch.convert.torch_import import load_mbv2_checkpoint
            load_mbv2_checkpoint(cfg.enc_ckpt, encoder)
    return dataset, encoder.to(device), search_loaders(cfg, dataset)


def create_search_agent(cfg: SearchConfig, device):
    """The controller and its agent for ``cfg`` (its family's spec, algo
    and hyperparameters), drawn from ``_seed(cfg.seed, 1)``."""
    if cfg.ctrl_version in ("wacv", "template"):
        spec = TemplateControllerSpec(
            num_blocks=cfg.num_blocks, hidden_size=cfg.lstm_hidden_size,
            emb_size=cfg.op_size)
    else:
        spec = MicroControllerSpec(
            num_blocks=cfg.num_blocks, num_cell_nodes=cfg.num_cell_nodes,
            hidden_size=cfg.lstm_hidden_size, emb_size=cfg.op_size)
    return create_agent(torch.Generator().manual_seed(_seed(cfg.seed, 1)),
                        spec=spec, algo=cfg.ctrl_algo, lr=cfg.ctrl_lr,
                        baseline_decay=cfg.ctrl_baseline_decay,
                        entropy_coef=cfg.ctrl_entropy_coef, device=device)


def describe(genotype) -> str:
    """What the search logs of a genotype: ``prettify``'s lines for a
    micro genotype, the literal for a template one (``prettify`` reads
    micro genotypes only)."""
    if infer_family(genotype).name == "micro":
        return prettify(genotype)
    return repr(genotype)


@deterministic()
def run_search(cfg: SearchConfig, *, dataset=None, encoder=None,
               teacher=None, device="cuda"):
    """The whole NAS loop on ``device``, under deterministic algorithms
    (``utils.helpers.deterministic``, the caller's settings restored
    after), so its rewards are the same run to run from ``cfg.seed``.
    Returns the ``SearchSaver`` (history and best genotypes).

    ``encoder``: a ``MobileNetV2`` to search on (by default one from
    ``cfg.seed``, or ``cfg.enc_ckpt``'s weights); ``teacher``: a trained
    ``Segmenter`` whose logits are distilled into every proxy training
    when ``cfg.do_kd`` (the reference's --do-kd)."""
    dev = resolve_device(device)
    _, encoder, loaders = search_setup(cfg, dataset, encoder, dev)
    train_loader, val_loader = loaders["train"], loaders["val"]
    cache_train_loader = loaders["cache_train"]
    log.info("caching encoder features for stage-1 proxy training")
    cached_train = _cache_taps(encoder, cache_train_loader)
    cached_val = _cache_taps(encoder, loaders["cache_val"])

    teacher_fn = None
    if cfg.do_kd and teacher is not None:
        teacher.eval()

        @torch.no_grad()
        def teacher_fn(image):
            return teacher(images_to(image, dev))

        # stage-1 KD targets: the teacher's logits of the fixed crops
        for batch, host in zip(cached_train, cache_train_loader):
            batch["teacher"] = teacher_fn(host["image"])

    agent = create_search_agent(cfg, dev)

    saver = SearchSaver(cfg.snapshot_dir)
    start = 0
    if cfg.resume:
        restored = saver.load(agent.state.params)
        if restored is not None:
            start, params, baseline = restored
            agent = agent._replace(state=agent.state._replace(
                params=params, baseline=torch.tensor(
                    baseline, dtype=torch.float32, device=dev)))
            log.info("resumed search at step %d", start)

    for step in range(start, cfg.num_iters):
        t0 = time.time()
        gen = torch.Generator(device=dev).manual_seed(
            _seed(cfg.seed, 2, step))
        genotype, actions, logprobs, _ = sample_genotype(agent, gen)
        timings: dict = {}
        try:
            miou1, miou2 = proxy_train(
                genotype, encoder, cfg, cached_train, cached_val,
                train_loader, val_loader, rng_seed=cfg.seed + step,
                teacher_fn=teacher_fn, timings=timings)
            reward = compute_reward(miou1, miou2)
            status = "ok"
        except GenotypeError as e:  # an invalid arch: invalid_reward
            miou1 = miou2 = 0.0
            reward = cfg.invalid_reward
            status = f"invalid: {e}"
        agent = train_agent(agent, actions, reward, old_logprobs=logprobs)
        extra = {"miou1": miou1, "miou2": miou2, "status": status,
                 "seconds": round(time.time() - t0, 2),
                 "baseline": float(agent.state.baseline)}
        for k in (1, 2):
            if timings.get(f"stage{k}_steps"):
                extra[f"stage{k}_ms"] = (1e3 * timings[f"stage{k}_s"]
                                         / timings[f"stage{k}_steps"])
        saver.record(step, genotype, reward, extra)
        log.info("step %d reward=%.4f (miou1=%.4f miou2=%.4f) %.1fs\n%s",
                 step, reward, miou1, miou2, time.time() - t0,
                 describe(genotype) if status == "ok" else status)
        if (step + 1) % cfg.val_every == 0:
            saver.save(step + 1, agent.state.params,
                       float(agent.state.baseline))
    saver.save(cfg.num_iters, agent.state.params,
               float(agent.state.baseline))
    return saver
