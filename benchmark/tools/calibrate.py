"""The readings that the check's limits are set from, on the card, in one
process (the kernels built once):

    python3 benchmark/tools/calibrate.py --workload serve_arch0_city_b8 \
        --mode sound --seeds 3000000001 ... --seconds 2

Modes:

* ``sound``: the program as the cell runs it: set-up, a short window at
  the cell's load, the check; each number compared, per seed;
* ``control``: the lower-precision control put in the program's place.
  Serving cells: the reference computed with every convolution's input
  and weight in float8 e4m3 (one step below the bf16 the configuration
  states) gives the masks; no window. Training: the program itself on its
  own TF32 path (TF32 on for the products), one step below f32 without
  TF32;
* ``half_batch`` (training): the program's step given half of each
  batch, its loss the mean over those rows;
* ``frozen`` (training): a step that returns its state unchanged.

Prints one JSON line a seed: {"seed", "mode", "checks": {number: value}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness, served  # noqa: E402
from benchmark.reference.model import exact_f32, fp8_round, served_logits  # noqa: E402
from benchmark.weights import make_frames, make_weights  # noqa: E402


def half_batch(step):
    """The step on the first half of each batch."""
    def halved(state, batch):
        n = batch["label"].shape[0] // 2
        return step(state, {k: v[:n] for k, v in batch.items()})
    halved.parts = step.parts
    return halved


def frozen(step):
    """A step that returns its state unchanged: the parameters and the
    momentum traces put back after the real step."""
    def run(state, batch):
        params = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        traces = {n: t.clone() for n, t in state.opt_state.items()}
        state, loss = step(state, batch)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n])
            for n, t in state.opt_state.items():
                t.copy_(traces[n])
        return state, loss
    run.parts = step.parts
    return run


def control_masks(run, frames):
    """The float8 reference's masks of ``frames``, a frame at a time."""
    out = []
    with exact_f32(), torch.no_grad():
        for i in range(len(frames)):
            f = torch.as_tensor(frames[i:i + 1]).to(run.device)
            lg = served_logits(run.weights, run.cfg, f, quant=fp8_round)
            out.append(lg.argmax(1).to(torch.uint8))
    return torch.cat(out)


def serve_control(run) -> dict:
    """The serving check's numbers on the frames the cell compares, with
    the control's masks in the program's place."""
    t = run.traffic
    n, h, w = int(t["batch"]), int(t["height"]), int(t["width"])
    run.weights = make_weights(run.cfg, run.seed, run.device)
    slots = served.sample(run.seed, int(t["ring"]), int(t["check_slots"]))
    frames = torch.cat([make_frames(run.seed, 1 + s, n, h, w, run.device)
                        for s in slots])
    return served.mask_checks(run, frames, control_masks(run, frames))


FAULTS = {"half_batch": half_batch, "frozen": frozen}


def one(workload, seed, mode, seconds, device, overrides):
    man = harness.manifest()
    run = harness.Run(man, workload, seed, device, overrides)
    if mode == "control" and run.traffic["kind"] == "train_steps":
        run.traffic["tf32"] = True
    run.seconds = seconds
    t0 = time.perf_counter()
    if mode == "control" and run.traffic["kind"] != "train_steps":
        checks = serve_control(run)
    else:
        run.loop.setup(run, **({"wrap": FAULTS[mode]} if mode in FAULTS
                               else {}))
        run.loop.window(run, seconds)
        run.loop.release(run)
        run.sync()
        checks = run.loop.check(run)
    return {"workload": workload, "seed": seed, "mode": mode,
            "seconds": time.perf_counter() - t0,
            "checks": {k: v for k, (v, _) in checks.items()},
            "notes": run.notes}


def main(argv=None):
    ap = argparse.ArgumentParser("benchmark/tools/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("sound", "control", *FAULTS),
                    default="sound")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--overrides", type=json.loads, default={},
                    help="traffic parameters to replace (a JSON object), "
                         "for a rehearsal at a small size")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        rec = one(args.workload, seed, args.mode, args.seconds, args.device,
                  args.overrides)
        print(json.dumps(rec), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
