"""The frozen plain reference (``benchmark/reference``) held to the
program's plain PyTorch runs on the CPU at small sizes, from the same
seeded weights. The tests may import the program; the reference may not.

    python -m pytest benchmark/tests -q
"""

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import program  # noqa: E402
from benchmark.compare import leaf_gap  # noqa: E402
from benchmark.reference.model import (Net, from_dict, normalize,  # noqa: E402
                                       served_logits)
from benchmark.reference.train import loss_of, run_steps, sgd_step  # noqa: E402
from benchmark.weights import (make_frames, make_train_batch,  # noqa: E402
                               make_weights)

CONFIGS = ("arch0", "template0")
GROUPS = {"encoder": dict(lr=1e-3, momentum=0.9, wd=1e-5, clip=3.0),
          "decoder": dict(lr=3e-3, momentum=0.9, wd=0.0, clip=3.0)}


def cfg_of(name):
    return json.loads((ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_program_unfolded(name):
    cfg = cfg_of(name)
    wts = make_weights(cfg, 11, "cpu")
    model = program.build_model(cfg, wts, "cpu")
    x = normalize(make_frames(11, 1, 2, 64, 128, "cpu"))
    with torch.no_grad():
        got = model(x)
        ref = Net(from_dict(wts), cfg)(x)
    assert got.shape == ref.shape == (2, 19, 16, 32)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("name", CONFIGS)
def test_masks_match_the_program_in_f32(name):
    """The engine in f32 (its plain versions on the CPU) against the
    reference's served logits: the same classes but at near-ties."""
    cfg = dict(cfg_of(name), compute_dtype="float32")
    wts = make_weights(cfg, 12, "cpu")
    seg = program.build_engine(cfg, wts, "cpu")
    frames = make_frames(12, 2, 2, 64, 128, "cpu")
    masks = seg.predict_batch(frames).long()
    with torch.no_grad():
        lg = served_logits(wts, cfg, frames)
    gap = lg.max(1).values - lg.gather(1, masks[:, None])[:, 0]
    assert len(torch.unique(masks)) >= 2
    assert float(gap.max()) <= 1e-4
    assert float((lg.argmax(1) != masks).float().mean()) <= 2e-3


@pytest.mark.parametrize("name", CONFIGS)
def test_train_step_matches_the_program(name):
    from segtpu_torch.engine.trainer import init_train_state, make_train_step
    from segtpu_torch.utils.solvers import GroupSGD, SGDGroup
    cfg = cfg_of(name)
    wts = make_weights(cfg, 13, "cpu", aux=True)
    model = program.build_model(cfg, wts, "cpu", aux=True)
    opt = GroupSGD({k: SGDGroup(**g) for k, g in GROUPS.items()})
    state = init_train_state(model, opt)
    step = make_train_step(cfg["genotype"], opt, num_classes=19,
                           aux_weight=0.3)
    img, lab = make_train_batch(13, 1, 4, 64, 64, 19, 0.05, "cpu")
    state, loss = step(state, {"image": img, "label": lab})
    names = [n for n, _ in model.named_parameters()]
    losses, ref_g, _ = run_steps(wts, names, cfg, [(img, lab)],
                                 aux_weight=0.3, groups=GROUPS)
    assert float(loss) == pytest.approx(losses[0], rel=1e-5)
    got = {n: state.opt_state[n] - GROUPS[n.split(".")[0]]["wd"] * wts[n]
           for n in names}
    # train-mode BatchNorm amplifies roundings into the gradients (the
    # program's own runs move them by ~1 % here); norms by the worst leaf
    assert leaf_gap(got, ref_g, names) <= 0.05


def test_loss_is_the_program_loss():
    from segtpu_torch.engine.trainer import segmentation_loss
    cfg = cfg_of("arch0")
    wts = make_weights(cfg, 14, "cpu", aux=True)
    model = program.build_model(cfg, wts, "cpu", aux=True).train()
    img, lab = make_train_batch(14, 1, 2, 64, 64, 19, 0.2, "cpu")
    with torch.no_grad():
        logits, aux = model(img.permute(0, 3, 1, 2), with_aux=True)
        got = segmentation_loss(logits, aux, lab, num_classes=19,
                                aux_weight=0.3)
        ref = loss_of(wts, cfg, img, lab, aux_weight=0.3)
    assert float(got) == pytest.approx(float(ref), rel=1e-5)


@pytest.mark.parametrize("scale", (1e-3, 10.0))
def test_sgd_step_is_the_program_update(scale):
    """Below and above the clip."""
    from segtpu_torch.utils.solvers import GroupSGD, SGDGroup
    g = torch.Generator().manual_seed(1)
    shapes = {"encoder.a": (8, 3), "encoder.b": (5,), "decoder.c": (4, 4)}
    params = {n: torch.randn(s, generator=g) for n, s in shapes.items()}
    grads = {n: scale * torch.randn(s, generator=g) for n, s in shapes.items()}
    opt = GroupSGD({k: SGDGroup(**v) for k, v in GROUPS.items()})
    prog = {n: p.clone() for n, p in params.items()}
    state = opt.init(prog)
    ref = {n: p.clone() for n, p in params.items()}
    traces = {n: torch.zeros_like(p) for n, p in ref.items()}
    for _ in range(3):
        opt.update(grads, state, prog)
        sgd_step(ref, grads, traces, GROUPS)
    for n in shapes:
        torch.testing.assert_close(prog[n], ref[n], rtol=1e-6, atol=1e-7)
