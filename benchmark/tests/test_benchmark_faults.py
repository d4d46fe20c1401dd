"""The check fails what it must: the lower-precision control and the
faults each cell can have, with the timed path broken underneath and the
rest of a run driven as the harness drives it (the harness's look for a
card skipped: on the CPU at a small size, the cells' own limits).

    python -m pytest benchmark/tests -q

The training cell's control (the program on its TF32 path) means
something on a card alone: ``test_train_control_fails_on_the_card`` runs
there, at a size a test holds, and skips on the CPU.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmark" / "tools"))

import calibrate  # noqa: E402
from benchmark import harness  # noqa: E402

SMALL = {"batch": 2, "height": 64, "width": 128, "ring": 3,
         "trace_seconds": 0.1}
# the control's gap grows with the frame (more near-ties to flip): it is
# read at a quarter of the cell's width, on 8 frames
CONTROL = {"batch": 4, "height": 256, "width": 512, "ring": 2,
           "check_slots": 2}
TRAIN_SMALL = {"batch": 4, "height": 64, "width": 64, "ring": 4,
               "trace_seconds": 0.1}
SERVING = ("serve_arch0_city_b8", "serve_template0_city_b8")
SEED = 3000000321


def failed_numbers(result):
    return sorted(k for k, c in result["checks"].items()
                  if not c["value"] <= c["limit"])


@pytest.mark.parametrize("cell", SERVING)
def test_sound_runs_pass(cell):
    r = harness.execute(cell, SEED, 0.3, False, device="cpu",
                        overrides=SMALL)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", SERVING)
def test_an_altered_answer_fails(cell, monkeypatch):
    """Every served mask gets a corner block of the next class where it
    is produced, in the engine."""
    from segtpu_torch.engine.inference import Segmenter
    real = Segmenter._run

    def altered(self, imgs, *, return_logits):
        out = real(self, imgs, return_logits=return_logits).clone()
        h, w = out.shape[-2:]
        out[:, :h // 8, :w // 8] = (out[:, :h // 8, :w // 8] + 1) % 19
        return out

    monkeypatch.setattr(Segmenter, "_run", altered)
    r = harness.execute(cell, SEED, 0.3, False, device="cpu",
                        overrides=SMALL)
    assert not r["correct"]
    assert "widest_gap" in failed_numbers(r)


def test_an_answer_altered_in_some_calls_fails(monkeypatch):
    """Every other call of the window returns a mask with one pixel moved:
    the calls that differ from the batch's first are failed."""
    from segtpu_torch.engine.inference import Segmenter
    real = Segmenter._run
    count = {"n": 0}

    def sometimes(self, imgs, *, return_logits):
        out = real(self, imgs, return_logits=return_logits)
        count["n"] += 1
        if count["n"] > 2 * SMALL["ring"] and count["n"] % 2 == 1:
            out = out.clone()
            out[0, 0, 0] = (out[0, 0, 0] + 1) % 19
        return out

    monkeypatch.setattr(Segmenter, "_run", sometimes)
    r = harness.execute("serve_arch0_city_b8", SEED, 0.8, False,
                        device="cpu", overrides=SMALL)
    assert not r["correct"]
    assert failed_numbers(r) == ["inconsistent_calls"]
    assert r["failed"] > 0


@pytest.mark.parametrize("cell", ("serve_arch0_city_b8",
                                  "serve_template0_city_b8"))
def test_the_float8_control_fails(cell):
    """The reference in float8 in the program's place, on three seeds."""
    for seed in (SEED, SEED + 1, SEED + 2):
        rec = calibrate.one(cell, seed, "control", 0.3, "cpu", CONTROL)
        lim = harness.Run(harness.manifest(), cell, seed, "cpu").limits
        assert any(v > lim[k] for k, v in rec["checks"].items()), rec


def _train_fault(monkeypatch, wrap):
    import segtpu_torch.engine.trainer as trainer
    real = trainer.make_train_step

    def make(*a, **kw):
        return wrap(real(*a, **kw))

    monkeypatch.setattr(trainer, "make_train_step", make)
    return harness.execute("train_arch0_city512_b64", SEED, 0.3, False,
                           device="cpu", overrides=TRAIN_SMALL)


def test_train_sound_run_passes():
    torch.backends.mkldnn.enabled = False
    try:
        r = harness.execute("train_arch0_city512_b64", SEED, 0.3, False,
                            device="cpu", overrides=TRAIN_SMALL)
    finally:
        torch.backends.mkldnn.enabled = True
    assert r["correct"], r["checks"]


def test_a_step_that_keeps_its_state_fails(monkeypatch):
    r = _train_fault(monkeypatch, calibrate.frozen)
    assert not r["correct"]
    assert {"grad_gap", "change_median"} <= set(failed_numbers(r))


def test_half_the_batch_left_out_fails(monkeypatch):
    r = _train_fault(monkeypatch, calibrate.half_batch)
    assert not r["correct"]
    assert "grad_gap" in failed_numbers(r)


def test_train_control_fails_on_the_card(card):
    """The program with TF32 on, against the cell's limits, on three
    seeds, at a size a test holds."""
    over = dict(TRAIN_SMALL, batch=8, height=256, width=256)
    for seed in (SEED, SEED + 1, SEED + 2):
        rec = calibrate.one("train_arch0_city512_b64", seed, "control", 0.3,
                            "cuda:0", over)
        lim = harness.Run(harness.manifest(), "train_arch0_city512_b64",
                          seed, "cpu").limits
        assert any(v > lim[k] for k, v in rec["checks"].items()), rec
