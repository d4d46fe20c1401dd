"""Training steps back to back: ``make_train_step`` (aux heads, the
``optimizer`` groups of ``GroupSGD``, Polyak when ``polyak``) on a ring of
``ring`` distinct batches of ``batch`` crops [height, width] made on the
card from the seed, in the ``precision`` the traffic states (``tf32``
false: f32 products without TF32, on both sides).

Set-up builds the one train state and step, and drives them through the
first ``check_steps`` steps, each on its own batch, through the window's
own call; the same state goes on into the window. End to end:
``train_images_per_s``, the images of every step in the window over the
window's time, which ends in a synchronize.

Check, against the reference's first ``check_steps`` steps from the same
weights on the same batches. A leaf's gap is | |program| - |reference| |
over the larger of the reference leaf's norm and the median leaf's.
Compared: ``grad_gap``, the first step's gradient as the optimizer took
it (read from its momentum trace after one step, less the weight decay),
by the worst leaf; ``change_median``, the parameters' change over those
steps, by the median leaf, leaving out the leaves whose reference
gradient is under a thousandth of the median leaf's (they move by
rounding alone). Noted, not compared: each step's loss (``loss_gap``)
and the change by the worst leaf (``change_worst``): on the small
BatchNorm leaves, whose gradients are residues of sums that cancel, three
steps amplify any difference of rounding, the order of a sum included.
Two runs of the program from one seed differ in it by themselves (cuDNN's
backward sums in an order that changes from run to run), and agree bit
for bit with deterministic algorithms.
"""

from __future__ import annotations

import time

import torch

from benchmark import program
from benchmark.compare import leaf_gap
from benchmark.reference.model import exact_f32
from benchmark.reference.train import run_steps
from benchmark.served import Fence
from benchmark.trace import record_function
from benchmark.weights import make_train_batch, make_weights


def _flags(t: dict):
    if t["precision"] != "float32":
        raise ValueError(f"train precision {t['precision']!r}: float32 only")
    tf32 = bool(t["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def _groups(t: dict) -> dict:
    return {k: {"lr": float(v["lr"]), "momentum": float(v["momentum"]),
                "wd": float(v["wd"]), "clip": float(v["clip"])}
            for k, v in t["optimizer"].items()}


def setup(run, *, wrap=None):
    from segtpu_torch.engine.trainer import init_train_state, make_train_step
    from segtpu_torch.utils.solvers import GroupSGD, SGDGroup
    t = run.traffic
    _flags(t)
    t0 = time.perf_counter()
    program.init_device(run.device)
    t_init = time.perf_counter()
    run.weights = make_weights(run.cfg, run.seed, run.device, aux=True)
    model = program.build_model(run.cfg, run.weights, run.device, aux=True)
    opt = GroupSGD({k: SGDGroup(**g) for k, g in _groups(t).items()})
    run.state = init_train_state(model, opt, do_polyak=bool(t["polyak"]))
    run.step = make_train_step(
        run.cfg["genotype"], opt, num_classes=int(run.cfg["num_classes"]),
        aux_weight=float(t["aux_weight"]))
    if wrap is not None:             # a planted fault (benchmark/tools)
        run.step = wrap(run.step)
    n, h, w = int(t["batch"]), int(t["height"]), int(t["width"])
    run.batches = [dict(zip(("image", "label"), make_train_batch(
        run.seed, 1 + s, n, h, w, int(run.cfg["num_classes"]),
        float(t["ignore_share"]), run.device))) for s in range(int(t["ring"]))]
    run.sync()
    t1 = time.perf_counter()
    run.trainable = [name for name, _ in model.named_parameters()]
    losses = []
    for k in range(int(t["check_steps"])):
        run.state, loss = run.step(run.state, run.batches[k])
        losses.append(float(loss))
        if k == 0:
            run.trace1 = {name: run.state.opt_state[name].detach().clone()
                          for name in run.trainable}
    run.losses = losses
    run.after = {name: p.detach().clone()
                 for name, p in run.state.model.named_parameters()}
    run.next_batch = int(t["check_steps"])
    run.sync()
    run.note(device_init_s=t_init - t0, weights_model_batches_s=t1 - t_init,
             first_steps_s=time.perf_counter() - t1, first_losses=losses)


def _steps(run, seconds: float, label: str) -> tuple:
    fence = Fence(run.device, int(run.traffic["depth"]))
    ring = len(run.batches)
    run.sync()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < seconds:
        with record_function(label):
            run.state, _ = run.step(run.state,
                                    run.batches[run.next_batch % ring])
        run.next_batch += 1
        fence.mark()
        steps += 1
    run.sync()
    return steps, time.perf_counter() - t0


def window(run, seconds: float) -> dict:
    steps, elapsed = _steps(run, seconds, "bench.step")
    images = steps * int(run.traffic["batch"])
    run.attempted += steps
    run.window_images, run.window_s = images, elapsed
    run.window_requests = steps
    run.note(window_steps=steps, window_s=elapsed)
    return {"train_images_per_s": images / elapsed}


def traced(run, seconds: float) -> int:
    return _steps(run, seconds, "bench.step")[0]


def release(run):
    del run.state, run.step
    if run.cuda():
        torch.cuda.empty_cache()


def check(run) -> dict:
    t = run.traffic
    groups = _groups(t)
    k = int(t["check_steps"])
    batches = [(b["image"], b["label"]) for b in run.batches[:k]]
    with exact_f32():
        ref_losses, ref_g, ref_p = run_steps(
            run.weights, run.trainable, run.cfg, batches,
            aux_weight=float(t["aux_weight"]), groups=groups)
    names = run.trainable
    wd = {n: groups[n.split(".", 1)[0]]["wd"] for n in names}
    prog_g = {n: run.trace1[n] - wd[n] * run.weights[n] for n in names}
    gmed = float(torch.tensor(sorted(float(ref_g[n].norm())
                                     for n in names)).median())
    moving = [n for n in names if float(ref_g[n].norm()) >= 1e-3 * gmed]
    prog_d = {n: run.after[n] - run.weights[n] for n in names}
    ref_d = {n: ref_p[n] - run.weights[n] for n in names}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(run.losses, ref_losses))
    run.note(ref_losses=ref_losses, prog_losses=run.losses,
             change_leaves=len(moving), leaves=len(names), loss_gap=loss_gap,
             change_worst=leaf_gap(prog_d, ref_d, moving))
    lim = run.limits
    return {"grad_gap": (leaf_gap(prog_g, ref_g, names),
                         float(lim["grad_gap"])),
            "change_median": (leaf_gap(prog_d, ref_d, moving, q=0.5),
                              float(lim["change_median"]))}
