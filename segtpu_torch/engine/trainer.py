"""Training engine: losses, train steps, eval step
(counterpart: segtpu/engine/trainer.py).

Per batch: forward -> CE(main) + sum of aux_weight * CE(aux heads)
[+ kd_coeff * KD] -> backward -> per-group clip -> SGD -> Polyak. Two-stage
proxy training: stage 1 trains the decoder alone on cached encoder taps
(``make_encoder_cache_fn``, ``make_decoder_train_step``), stage 2 the
whole model (``make_train_step``).

The JAX steps are pure functions of pytrees; here the state holds the
module, whose parameters and BatchNorm running stats (its buffers) a
step updates in place, and the steps keep the JAX signatures:
``step(state, batch) -> (state, loss)``. Batches arrive as the JAX
package's loaders give them: ``image`` f32 [N, H, W, 3] normalized and
``label`` int [N, H, W], numpy arrays or tensors; a step moves them to
the model's device once, as NCHW. ``teacher`` (KD targets) and the
cached ``taps`` are the port's NCHW tensors. Convolutions forward and
backward are library calls (cuDNN on the card), as the JAX package's
are XLA's: no Pallas kernel is on its train or eval path. Train-mode
BatchNorm and its activation run as hand-written CUDA kernels on a
card's tensors (``kernels.bn_train.bn_act_train``), forward and
backward, and written out elsewhere.

Under ``utils.profiling.tracing()`` a ``make_train_step`` step records
host and device spans: the root ``segtpu.train.step`` with the state's
step as its request id, ``.forward`` (the model with its aux heads, one
``.bn`` child a train BatchNorm, with its activation on the kernel
route), ``.loss``, ``.backward`` (the
gradients), ``.optimizer`` and ``.polyak``; its ``parts`` record the
same below whatever calls them (``parallel.mesh``'s sharded step).
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from segtpu_torch.core.bands import global_hw
from segtpu_torch.core.resize import resize_bilinear
from segtpu_torch.utils.metrics import confusion_matrix, mean_iou
from segtpu_torch.utils.profiling import span
from segtpu_torch.utils.solvers import polyak_update


@dataclasses.dataclass
class TrainState:
    """``model`` holds the parameters and the BatchNorm running stats;
    ``opt_state`` the momentum traces by parameter name; ``polyak`` the
    averaged parameters (or None); ``grad_norms`` each optimizer group's
    global gradient norm before the clip, of the last step."""
    model: nn.Module
    opt_state: Dict[str, torch.Tensor]
    polyak: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0
    grad_norms: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def stats(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_buffers())


def init_train_state(model: nn.Module, optimizer, *,
                     do_polyak: bool = False) -> TrainState:
    params = {n: p.detach() for n, p in model.named_parameters()}
    return TrainState(model, optimizer.init(params),
                      {n: p.clone() for n, p in params.items()}
                      if do_polyak else None, 0)


def eval_params_stats(state: TrainState):
    """The (params, stats) pair to evaluate with: the Polyak-averaged
    parameters when the state keeps them, with the LIVE BatchNorm
    running stats (themselves a moving average), as the JAX package
    pairs them."""
    params = (state.polyak if state.polyak is not None
              else {n: p.detach() for n, p in state.params.items()})
    return params, state.stats


def _nll_sum_count(logits, labels, *, num_classes: int):
    """(sum of the NLL over the pixels whose label lies in [0, K), their
    count): the parts of the JAX package's ``cross_entropy``, which is
    their quotient; logits [N, K, h, w] are upsampled to the labels'
    [N, H, W] first, in f32. Written out (not
    ``F.cross_entropy(ignore_index=255)``): every label outside [0, K) is
    ignored, as in the JAX package. On a band of rows (``core.bands``)
    both sizes are global: the logits' band of the labels' size."""
    hw = global_hw(labels)
    if global_hw(logits) != hw:
        logits = resize_bilinear(logits, hw, compute_dtype=torch.float32)
    logits = logits.float()
    valid = (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits, dim=1)
    nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum(), valid.sum()


def _kd_sum_count(student_logits, teacher_logits):
    """(sum over pixels of the teacher's softmax against the student's
    log-softmax, summed over classes, the number of pixels): the parts of
    the JAX package's ``kd_loss`` at temperature 1, as its
    ``segmentation_loss`` calls it. On a band, as ``_nll_sum_count``."""
    hw = global_hw(teacher_logits)
    if global_hw(student_logits) != hw:
        student_logits = resize_bilinear(student_logits, hw,
                                         compute_dtype=torch.float32)
    p_t = torch.softmax(teacher_logits.float(), dim=1)
    logp_s = torch.log_softmax(student_logits.float(), dim=1)
    per_pixel = -(p_t * logp_s).sum(1)
    return per_pixel.sum(), per_pixel.new_tensor(per_pixel.numel())


def segmentation_loss_terms(logits, aux_logits, labels, *, num_classes: int,
                            aux_weight: float = 0.3, teacher_logits=None,
                            kd_coeff: float = 0.0):
    """``segmentation_loss``'s terms for one shard of a batch, as
    (weight, sum, count): the main head's NLL (weight 1), each aux
    head's (``aux_weight``), and the KD term's (``kd_coeff``) when it is
    on. ``combine_loss_terms`` makes the loss of the whole batch from
    every shard's terms."""
    terms = [(1.0, *_nll_sum_count(logits, labels, num_classes=num_classes))]
    terms += [(aux_weight, *_nll_sum_count(a, labels, num_classes=num_classes))
              for a in aux_logits]
    if teacher_logits is not None and kd_coeff > 0:
        terms.append((kd_coeff, *_kd_sum_count(logits, teacher_logits)))
    return terms


def combine_loss_terms(shard_terms, device):
    """The loss of a batch split into shards, from each shard's
    ``segmentation_loss_terms``: each term is the shards' sums over the
    shards' counts, both summed in shard order on ``device`` (not the
    mean of the shards' means, which differs as soon as the shards hold
    different numbers of ignored pixels), and the terms weighted and
    added in order."""
    loss = None
    for parts in zip(*shard_terms):
        total, count = parts[0][1].to(device), parts[0][2].to(device)
        for _, s, c in parts[1:]:
            total, count = total + s.to(device), count + c.to(device)
        value = total / count.clamp_min(1)
        loss = value if loss is None else loss + parts[0][0] * value
    return loss


def segmentation_loss(logits, aux_logits, labels, *, num_classes: int,
                      aux_weight: float = 0.3, teacher_logits=None,
                      kd_coeff: float = 0.0):
    """Mean CE of the main head + aux_weight x each aux head's [+
    kd_coeff x KD]: ``combine_loss_terms`` of the batch as one shard."""
    return combine_loss_terms(
        [segmentation_loss_terms(logits, aux_logits, labels,
                                 num_classes=num_classes,
                                 aux_weight=aux_weight,
                                 teacher_logits=teacher_logits,
                                 kd_coeff=kd_coeff)], logits.device)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def images_to(image, device) -> torch.Tensor:
    """Normalized f32 images [N, H, W, 3] (numpy or tensor) -> [N, 3, H, W]
    on ``device``."""
    x = torch.as_tensor(image, dtype=torch.float32).to(device)
    return x.permute(0, 3, 1, 2).contiguous()


def _labels_to(label, device) -> torch.Tensor:
    return torch.as_tensor(label).to(device).long()


def _refuse_untrainable(genotype) -> None:
    """The steps train a family whose decoder carries the aux heads the
    loss reads (``DecoderFamily.trainable``); a served-only family
    raises."""
    from segtpu_torch.models.families import infer_family
    family = infer_family(genotype)
    if not family.trainable:
        raise TypeError(f"make_train_step trains a family with aux heads, "
                        f"not the {family.name!r} family, which is served "
                        f"only")


def _check_genotype(module: nn.Module, genotype) -> None:
    if module.genotype != genotype:
        raise ValueError(f"the step was made for genotype {genotype!r}, the "
                         f"state's model is {module.genotype!r}")


def _apply_update(state: TrainState, optimizer, loss,
                  polyak_decay: float) -> TrainState:
    """Gradients of ``loss`` for every parameter (None where it does not
    reach, which the optimizer steps on zeros), the optimizer's step, the
    Polyak average, step + 1."""
    names, params = zip(*state.model.named_parameters())
    with span("segtpu.train.backward", device=loss.device):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    params = dict(zip(names, params))
    state.grad_norms = optimizer.update(dict(zip(names, grads)),
                                        state.opt_state, params)
    if state.polyak is not None:
        polyak_update(state.polyak, params, polyak_decay, step=state.step)
    state.step += 1
    return state


@dataclasses.dataclass
class StepParts:
    """What ``parallel.mesh.make_sharded_train_step`` needs of a
    ``make_train_step`` step: its genotype, ``terms(forward, batch,
    device)`` (one shard's ``segmentation_loss_terms``, the model run by
    ``forward``) and ``update(state, loss)`` (the gradients of the whole
    batch's loss, the optimizer's step, Polyak, step + 1)."""
    genotype: object
    terms: object
    update: object


def make_train_step(genotype, optimizer, *, num_classes: int,
                    aux_weight: float = 0.3, kd_coeff: float = 0.0,
                    freeze_encoder: bool = False, polyak_decay: float = 0.99):
    """Full-model train step over a ``Segmenter`` state.

    batch = {'image': f32 normalized [N,H,W,3], 'label': int [N,H,W],
             optional 'teacher': NCHW teacher logits}.
    ``freeze_encoder``: the encoder runs in eval mode without gradients
    (its parameters still take weight decay and momentum on zero
    gradients, as under optax). Polyak averaging runs when the state
    keeps an average (``init_train_state(do_polyak=True)``). The step
    carries its ``StepParts`` as ``step.parts``."""
    _refuse_untrainable(genotype)
    loss_kw = dict(num_classes=num_classes, aux_weight=aux_weight,
                   kd_coeff=kd_coeff)

    def forward(model, batch, dev):
        """(logits, aux logits, labels, teacher logits or None)."""
        with span("segtpu.train.forward", device=dev):
            logits, aux = model(images_to(batch["image"], dev),
                                with_aux=True, freeze_encoder=freeze_encoder)
            teacher = batch.get("teacher")
            return (logits, aux, _labels_to(batch["label"], dev),
                    None if teacher is None
                    else torch.as_tensor(teacher).to(dev))

    def terms(model, batch, dev):
        logits, aux, label, teacher = forward(model, batch, dev)
        with span("segtpu.train.loss", device=dev):
            return segmentation_loss_terms(logits, aux, label,
                                           teacher_logits=teacher, **loss_kw)

    def update(state, loss):
        return _apply_update(state, optimizer, loss, polyak_decay)

    def step(state: TrainState, batch):
        model = state.model
        _check_genotype(model, genotype)
        dev = _device(model)
        with span("segtpu.train.step", state.step, dev):
            model.train()
            logits, aux, label, teacher = forward(model, batch, dev)
            with span("segtpu.train.loss", device=dev):
                loss = segmentation_loss(logits, aux, label,
                                         teacher_logits=teacher, **loss_kw)
            return update(state, loss), loss.detach()

    step.parts = StepParts(genotype, terms, update)
    return step


# ---------------------------------------------------------------------------
# Stage 1: cached encoder features (CVPR'19 §3.3)
# ---------------------------------------------------------------------------


def make_encoder_cache_fn():
    """Eval-mode encoder forward without autograd: ``cache(encoder,
    images)`` -> the 4 NCHW taps on the encoder's device (the JAX
    ``cache(enc_params, enc_stats, images)``; here the encoder module
    holds both). The encoder's mode is restored after."""

    @torch.no_grad()
    def cache(encoder: nn.Module, images):
        was_training = encoder.training
        encoder.eval()
        try:
            return encoder(images_to(images, _device(encoder)))
        finally:
            encoder.train(was_training)

    return cache


def make_decoder_train_step(genotype, optimizer, *, num_classes: int,
                            aux_weight: float = 0.3, kd_coeff: float = 0.0):
    """Stage-1 step over cached taps: the state's model is a decoder
    (``MicroDecoder`` or ``TemplateDecoder``). batch = {'taps': the 4
    NCHW taps, 'label': ..., optional 'teacher'}. Polyak averaging, when
    the state keeps an average, at the JAX step's default decay 0.99."""

    def step(state: TrainState, batch):
        dec = state.model
        _check_genotype(dec, genotype)
        dev = _device(dec)
        dec.train()
        taps = [torch.as_tensor(t).to(dev) for t in batch["taps"]]
        logits, aux = dec(taps, with_aux=True)
        teacher = batch.get("teacher")
        loss = segmentation_loss(
            logits, aux, _labels_to(batch["label"], dev),
            num_classes=num_classes, aux_weight=aux_weight,
            teacher_logits=None if teacher is None
            else torch.as_tensor(teacher).to(dev), kd_coeff=kd_coeff)
        return _apply_update(state, optimizer, loss, 0.99), loss.detach()

    return step


_REP = re.compile(r"\.reps\.(\d+)\.")


def decoder_dims(params, prefix: str = "decoder.") -> Tuple[int, int]:
    """(agg_size, repeats) of the decoder whose tensors ``params`` (a
    name -> tensor mapping) holds under ``prefix``: the width of its
    first adapt conv, and one more than the largest separable-conv repeat
    index (1 where no op of the genotype repeats)."""
    agg = params[f"{prefix}adapt.0.w"].shape[0]
    reps = [int(m.group(1)) for n in params if n.startswith(prefix)
            for m in [_REP.search(n)] if m]
    return int(agg), 1 + max(reps, default=0)


def make_eval_step(genotype, *, num_classes: int):
    """Eval step: ``step(params, stats, batch)`` -> the [K, K] confusion
    matrix on the parameters' device. ``params`` and ``stats`` are name
    -> tensor mappings (``eval_params_stats``) of a ``Segmenter`` of
    ``genotype`` at any decoder width and repeat count: a skeleton
    ``Segmenter`` without heads at the ``decoder_dims`` they imply, made
    on the CPU once for each, gives their structure, and the step runs it
    on them with ``torch.func.functional_call``: logits upsampled in f32
    to the labels' size, argmax (ties to the lower class), confusion
    matrix. Entries the skeleton lacks (training's aux heads) are not
    read. Each thread that calls the step has skeletons of its own
    (``functional_call`` swaps a module's tensors while it runs), so the
    sharded eval may call it from a thread a shard."""
    from segtpu_torch.models.segmenter import Segmenter
    local = threading.local()

    def skeleton(params):
        dims = decoder_dims(params)
        skeletons = local.__dict__.setdefault("skeletons", {})
        if dims not in skeletons:
            model = Segmenter(genotype, num_classes, agg_size=dims[0],
                              repeats=dims[1],
                              generator=torch.Generator().manual_seed(0))
            skeletons[dims] = model, list(model.state_dict().keys())
        return skeletons[dims]

    @torch.no_grad()
    def step(params, stats, batch):
        model, keys = skeleton(params)
        merged = {**params, **stats}
        tensors = {k: merged[k] for k in keys}
        dev = tensors[keys[0]].device
        label = _labels_to(batch["label"], dev)
        logits = torch.func.functional_call(
            model, tensors, (images_to(batch["image"], dev),))
        logits = resize_bilinear(logits, global_hw(label),
                                 compute_dtype=torch.float32)
        pred = torch.argmax(logits.float(), dim=1)
        return confusion_matrix(pred, label, num_classes)

    return step


def validate(eval_step, params, stats, batches, *, num_classes: int) -> float:
    """mIoU of the confusion matrices summed over ``batches``."""
    cm = np.zeros((num_classes, num_classes), np.int64)
    for batch in batches:
        cm += eval_step(params, stats, batch).cpu().numpy()
    return mean_iou(cm)
