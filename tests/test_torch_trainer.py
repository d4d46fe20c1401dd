"""segtpu_torch's training engine vs the JAX package's, on the CPU in f32.

The same ``segmenter_init`` weights (carried over by ``load_jax_params``)
and seeded numpy batches (2x64x64, K = 5 classes, labels holding 255 and
the out-of-range 7) go through ``jax.jit`` and through the port, with
PyTorch's oneDNN convolutions off (``_exact_convolutions``: on this
CPU, which has AMX, their f32 backward loses up to 10 % on some weight
gradients; PyTorch's own convolutions keep f32). "rel t" means
max|got - want| <= t * max|want| over a tensor:

* train-mode BatchNorm on a conv whose output has mean^2 >> var:
  outputs and running stats rel 1e-5 (a one-pass E[x^2] - E[x]^2
  variance would be ~1e-4 off there), gradients rel 1e-4 (the scale's
  sums x_hat, whose ~1e-6 rounding there the conv's sum order sets);
* ``segmentation_loss`` with aux heads, with and without KD, on the same
  logits: |d| <= 1e-5 |loss|;
* every gradient leaf of the loss with aux heads (an aux cell in arch0's)
  and KD on the running stats: max|d| <= 1e-4 * max|g_leaf| + 1e-7;
* train mode, where arch0 and template0 at this size are chaotic from
  random init: JAX against itself (``SPREAD_SIDES``: the same batch in
  reversed order, which only reorders its sums, the weights one rounding
  apart, or the inputs one rounding apart) moves the first step's
  gradients by up to ~16 %. There a quantity is held to max(a floor,
  SPREAD x the largest of those moves of JAX's own), and the test asserts
  that this limit stays below what a wrong step would move: the
  first step's gradients and group norms (floor rel 1e-4 of the group's
  L2 norm; SPREAD x the spread below the gradient's size), and three
  steps of each variant (``VARIANTS``), each step of the port from JAX's
  state before it: the loss (floor 1e-5 |loss|), and by group the
  parameters, momentum traces, Polyak averages (floor 1e-2 of JAX's own
  move in the step; SPREAD x the spread below that move) and BatchNorm
  stats (floor 1e-3 of the move). Planted faults (``FAULTS``: no encoder
  update, the learning rates swapped, Polyak skipped) fail those limits
  by 4.8x to 29x;
* the frozen encoder exactly, over the port's three steps on its own
  state: its parameters follow weight decay and momentum alone (rel 1e-6
  against the chain in numpy) and its stats stay as they were;
* the eval step's confusion matrix equal to JAX's;
* a model with aux heads served by the engine (use_kernels=False) with
  logits equal to the same model's without heads.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

from segtpu.core.layers import conv_bn_apply, conv_bn_init
from segtpu.engine.trainer import (
    init_train_state as jax_init_train_state,
    make_decoder_train_step as jax_make_decoder_train_step,
    make_encoder_cache_fn as jax_make_encoder_cache_fn,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
    segmentation_loss as jax_segmentation_loss)
from segtpu.models.segmenter import segmenter_apply, segmenter_init
from segtpu.utils.solvers import create_optimisers as jax_create_optimisers

from segtpu_torch.convert import load_jax_params, to_jax_tree
from segtpu_torch.core.layers import ConvBN
from segtpu_torch.engine import Segmenter as Engine
from segtpu_torch.engine.trainer import (
    TrainState, eval_params_stats, init_train_state,
    make_decoder_train_step, make_encoder_cache_fn, make_eval_step,
    make_train_step, segmentation_loss)
from segtpu_torch.models import ARCHS, TEMPLATE_ARCHS
from segtpu_torch.models.segmenter import Segmenter
from segtpu_torch.utils.solvers import (create_optimisers, global_norm,
                                        sgd_chain)

from test_torch_layers import _nchw, _nhwc, _np_tree, perturb_bn

K = 5
N, HW = 2, 64
STEPS = 3
GENOTYPES = {"arch0": ARCHS["arch0"], "template0": TEMPLATE_ARCHS["template0"]}
# TrainConfig's learning rates and clips (both groups' gradient norms are
# above 3 here), with weight decay raised to show in f32 over three steps
OPT = dict(enc_lr=1e-3, dec_lr=3e-3, enc_wd=1e-2, dec_wd=1e-3,
           enc_grad_clip=3.0, dec_grad_clip=3.0)
# the search's stage-1 chain
STAGE1 = dict(lr=3e-3, momentum=0.9, wd=1e-3, clip=3.0)
AUX_WEIGHT = 0.15
KD_COEFF = 0.3
# JAX's own spread in train mode: the largest move of its result with
# the batch in reversed order, the weights one rounding apart, or the
# inputs (images, or stage 1's taps) one rounding apart. The port's
# difference from JAX, its convolutions summing in another order at every
# layer, is held to SPREAD x that: measured up to 1.7x
SPREAD = 4
SPREAD_SIDES = ("reversed", "perturbed", "images")
# the floor of each step's limit, as a share of JAX's own move in the
# step: measured up to 1e-3 (stage 1's traces) and 5e-6 (its stats),
# where the spread is below it
FLOOR = {"params": 1e-2, "trace": 1e-2, "polyak": 1e-2, "stats": 1e-3}
VARIANTS = {
    "plain": dict(genotype="arch0"),
    "frozen_encoder": dict(genotype="arch0", freeze_encoder=True),
    "aux_cell": dict(genotype="arch0", aux_cell=True),
    "template_kd": dict(genotype="template0", kd=True),
    "stage1": dict(genotype="arch0", stage1=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_convolutions():
    """PyTorch's own f32 convolutions, not oneDNN's, for every test."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


def _flat(tree, prefix=""):
    """A pytree -> {dotted path: numpy leaf}."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _rel(got, want) -> float:
    """max|got - want| / max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _dist(a, b, group=None) -> float:
    """L2 distance of two pytrees over the leaves of ``group``."""
    a, b = _flat(a), _flat(b)
    assert a.keys() == b.keys(), sorted(a.keys() ^ b.keys())
    return float(np.sqrt(sum(
        np.square(a[k].astype(np.float64) - b[k]).sum()
        for k in b if group is None or k.startswith(group + "."))))


def _groups(tree):
    return ["encoder", "decoder"] if "encoder" in tree else [None]


def _batch(seed=0, reverse=False):
    """Normalized images, labels in [0, K) with a band of 255 and a patch
    of the out-of-range 7, and 1/4-resolution teacher logits (NHWC);
    ``reverse``: the same batch with its images in reversed order."""
    rng = np.random.default_rng(seed)
    image = rng.standard_normal((N, HW, HW, 3)).astype(np.float32)
    label = rng.integers(0, K, (N, HW, HW)).astype(np.int32)
    label[:, 20:28] = 255
    label[0, 40:44, :10] = 7
    teacher = rng.standard_normal((N, HW // 4, HW // 4, K)).astype(np.float32)
    out = (image, label, teacher)
    return tuple(np.ascontiguousarray(a[::-1]) for a in out) if reverse \
        else out


def _one_rounding(tree, seed=11):
    """Every leaf times 1 +- 2^-23 (random signs): one f32 rounding."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a * (1.0 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], a.shape))).astype(np.float32), tree)


def _running_stats(stats, rng):
    """Running stats away from (0, 1); train mode does not read them, the
    frozen encoder and the eval step do."""
    if isinstance(stats, list):
        return [_running_stats(v, rng) for v in stats]
    if "mean" in stats:
        return {"mean": rng.normal(0, 0.1, stats["mean"].shape).astype(
                    np.float32),
                "var": rng.uniform(0.5, 1.5, stats["var"].shape).astype(
                    np.float32)}
    return {k: _running_stats(v, rng) for k, v in stats.items()}


def _setup(genotype_name, aux_cell=False, seed=0, perturb=False):
    """JAX's init with aux heads (BatchNorm's scale and bias as
    ``segmenter_init`` makes them unless ``perturb``) and the port's model
    holding the same weights."""
    genotype = GENOTYPES[genotype_name]
    p, s = _np_tree(segmenter_init(jax.random.PRNGKey(seed), genotype,
                                   num_classes=K, aux=True,
                                   aux_cell=aux_cell))
    rng = np.random.default_rng(seed)
    if perturb:
        p, s = perturb_bn(p, s, rng)
    else:
        s = _running_stats(s, rng)
    model = Segmenter(genotype, K, aux=True, aux_cell=aux_cell,
                      generator=torch.Generator().manual_seed(0))
    load_jax_params(model, p, s)
    return genotype, p, s, model


# ------------------------------------------------------------ BatchNorm


def _conv_bn_case():
    """A 1x1 conv of inputs around 20 with positive weights: its output's
    mean^2 is ~1e3 times its variance."""
    rng = np.random.default_rng(0)
    cin, cout = 4, 6
    p, s = _np_tree(conv_bn_init(jax.random.PRNGKey(1), 1, 1, cin, cout))
    p, s = perturb_bn(p, s, rng)
    p["w"] = np.abs(p["w"]) + 0.2
    x = (20.0 + rng.standard_normal((N, 12, 10, cin))).astype(np.float32)
    m = ConvBN(cin, cout, 1, act="relu",
               generator=torch.Generator().manual_seed(0))
    load_jax_params(m, p, s)
    conv = torch.nn.functional.conv2d(_nchw(x), m.w)
    assert (conv.mean((0, 2, 3)) ** 2 / conv.var((0, 2, 3))).min() > 300
    return p, s, x, m


def test_train_batchnorm_two_pass_matches_jax():
    p, s, x, m = _conv_bn_case()
    want, want_stats = conv_bn_apply(p, s, jnp.asarray(x), act="relu",
                                     train=True)
    assert _rel(_nhwc(m.train()(_nchw(x))), want) <= 1e-5
    for k in ("mean", "var"):
        assert _rel(getattr(m, k).numpy(), want_stats[k]) <= 1e-5, k
    # eval mode reads the running stats the train call moved, as JAX's
    want_eval, _ = conv_bn_apply(p, _np_tree(want_stats), jnp.asarray(x),
                                 act="relu", train=False)
    assert _rel(_nhwc(m.eval()(_nchw(x))), want_eval) <= 1e-5


def test_train_batchnorm_gradients_match_jax():
    """The vector-Jacobian product of train-mode conv-BN-relu for the
    input and every parameter, through the batch mean and variance."""
    p, s, x, m = _conv_bn_case()
    ct = np.random.default_rng(5).standard_normal(
        (N, 12, 10, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda p, x: conv_bn_apply(p, s, x, act="relu",
                                                train=True)[0],
                     p, jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(ct))
    xt = _nchw(x).requires_grad_(True)
    names, params = zip(*m.train().named_parameters())
    got = torch.autograd.grad(m(xt), (xt,) + params, _nchw(ct))
    assert _rel(_nhwc(got[0]), want_x) <= 1e-4
    got_p = _flat(to_jax_tree(dict(zip(names, got[1:]))))
    for k, w in _flat(_np_tree(want_p)).items():
        assert _rel(got_p[k], w) <= 1e-4, k


# ----------------------------------------------------------------- loss


@pytest.mark.parametrize("kd", [False, True])
def test_segmentation_loss_matches_jax(kd):
    """Logits at 1/4 resolution and two aux heads at 1/8 and 1/16, all
    upsampled to the labels' size inside the loss."""
    rng = np.random.default_rng(1)
    _, label, teacher = _batch()
    logits = rng.standard_normal((N, 16, 16, K)).astype(np.float32) * 3
    aux = [rng.standard_normal((N, s, s, K)).astype(np.float32)
           for s in (8, 4)]
    want = jax_segmentation_loss(
        jnp.asarray(logits), [jnp.asarray(a) for a in aux],
        jnp.asarray(label), num_classes=K, aux_weight=AUX_WEIGHT,
        teacher_logits=jnp.asarray(teacher) if kd else None,
        kd_coeff=KD_COEFF)
    got = segmentation_loss(
        _nchw(logits), [_nchw(a) for a in aux], torch.from_numpy(label),
        num_classes=K, aux_weight=AUX_WEIGHT,
        teacher_logits=_nchw(teacher) if kd else None, kd_coeff=KD_COEFF)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


# ------------------------------------------------------------ gradients


def _loss_and_grads(genotype_name, train, aux_cell, perturb):
    """{side: (loss, gradients)} of the full loss with aux heads and KD:
    JAX's, the port's, and with ``train`` JAX's spread sides."""
    genotype, p, s, model = _setup(genotype_name, aux_cell, perturb=perturb)

    def loss_fn(params, image, label, teacher):
        logits, aux, _ = segmenter_apply(genotype, params, s, image,
                                         train=train, with_aux=True)
        return jax_segmentation_loss(
            logits, aux, label, num_classes=K, aux_weight=AUX_WEIGHT,
            teacher_logits=teacher, kd_coeff=KD_COEFF)

    run = jax.jit(jax.value_and_grad(loss_fn))
    out = {}
    for side in ("jax",) + (SPREAD_SIDES if train else ()):
        image, label, teacher = _batch(reverse=side == "reversed")
        if side == "images":
            image = _one_rounding(image, seed=5)
        loss, grads = run(_one_rounding(p) if side == "perturbed" else p,
                          *map(jnp.asarray, (image, label, teacher)))
        out[side] = (float(loss), _np_tree(grads))
    image, label, teacher = _batch()
    model.train(train)
    logits, aux = model(_nchw(image), with_aux=True)
    loss = segmentation_loss(
        logits, aux, torch.from_numpy(label), num_classes=K,
        aux_weight=AUX_WEIGHT, teacher_logits=_nchw(teacher),
        kd_coeff=KD_COEFF)
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params)))
    out["port"] = (float(loss.detach()), to_jax_tree(grads), grads)
    return out


@pytest.mark.parametrize("name,aux_cell", [("arch0", True),
                                           ("template0", False)])
def test_gradients_match_jax(name, aux_cell):
    """BatchNorm on its running stats (perturbed), where the loss is
    well-conditioned: every leaf at the tight tolerance."""
    r = _loss_and_grads(name, train=False, aux_cell=aux_cell, perturb=True)
    (loss, want), (got_loss, got, _) = r["jax"], r["port"]
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        tol = 1e-4 * np.abs(want[k]).max() + 1e-7
        assert np.abs(got[k] - want[k]).max() <= tol, k


def test_train_mode_gradients_match_jax():
    """Train-mode BatchNorm from segmenter_init (arch0, aux-cell heads,
    KD): the loss at 1e-5, each group's gradient (and its global norm,
    what the clip reads) within SPREAD x JAX's own spread, which stays
    below the gradient's own size: a zero gradient fails."""
    r = _loss_and_grads("arch0", train=True, aux_cell=True, perturb=False)
    (loss, want), (got_loss, got, got_t) = r["jax"], r["port"]
    spread = [r[side] for side in SPREAD_SIDES]
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    for group in ("encoder", "decoder"):
        scale = _dist(want[group], jax.tree.map(np.zeros_like, want[group]))
        moved = max(_dist(s[1], want, group) for s in spread)
        assert SPREAD * moved < scale, group
        assert _dist(got, want, group) <= max(1e-4 * scale,
                                              SPREAD * moved), group
        norm = float(optax.global_norm(want[group]))
        got_norm = float(global_norm(g for n, g in got_t.items()
                                     if n.startswith(group + ".")))
        assert abs(got_norm - norm) <= max(1e-5 * norm, SPREAD * max(
            abs(float(optax.global_norm(s[1][group])) - norm)
            for s in spread)), group


# --------------------------------------------------------- three steps
#
# The port's step k starts from JAX's state before it: its parameters,
# BatchNorm stats, momentum traces, Polyak average and step count. In
# train mode a step's gradients move with the rounding (see the module
# doc), and a run left to itself carries each step's difference into the
# next, so the steps are held one at a time against JAX's. The frozen
# encoder's test runs the port's steps on its own state.


def _named(tree):
    """A pytree in the JAX layout -> {dotted path: tensor}, conv kernels
    HWIO -> OIHW, as ``load_jax_params`` carries them; always a copy (the
    port's step writes into it)."""
    out = {}
    for k, a in _flat(tree).items():
        if k.rsplit(".", 1)[-1] == "w":
            a = np.transpose(a, (3, 2, 0, 1))
        out[k] = torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)
    return out


def _traces(opt_state):
    """The momentum traces of an optax state (one chain, or one chain a
    group under ``multi_transform``) as one tree in the params' layout."""
    out = {}
    for _, tree in optax.tree_utils.tree_get_all_with_path(opt_state,
                                                           "trace"):
        out.update({k: v for k, v in tree.items()
                    if not isinstance(v, optax.MaskedNode)})
    return _np_tree(out)


def _jax_snap(state, loss=None):
    return {"params": _np_tree(state.params), "stats": _np_tree(state.stats),
            "trace": _traces(state.opt_state),
            "polyak": _np_tree(state.polyak), "step": int(state.step),
            "loss": None if loss is None else float(loss)}


@functools.lru_cache(maxsize=None)
def _jax_cache():
    return jax_make_encoder_cache_fn()


def _jax_step(variant, genotype, opt, kd, freeze):
    """One compiled JAX step of ``variant``."""
    if VARIANTS[variant].get("stage1"):
        return jax_make_decoder_train_step(genotype, opt, num_classes=K,
                                           aux_weight=AUX_WEIGHT)
    return jax_make_train_step(genotype, opt, num_classes=K,
                               aux_weight=AUX_WEIGHT, kd_coeff=kd,
                               freeze_encoder=freeze)


def _jax_batch(v, p, s, reverse=False):
    image, label, teacher = _batch(reverse=reverse)
    batch = {"image": jnp.asarray(image), "label": jnp.asarray(label)}
    if v.get("kd"):
        batch["teacher"] = jnp.asarray(teacher)
    if v.get("stage1"):
        batch["taps"] = _jax_cache()(p["encoder"], s["encoder"],
                                     batch["image"])
    return batch


@functools.lru_cache(maxsize=None)
def _jax_run(variant):
    """JAX's STEPS steps of ``variant`` from the shared init: its states
    (``_jax_snap``) before the first step and after each, and for each
    step every spread side's one step from the same state before it."""
    v = VARIANTS[variant]
    genotype, p, s, _ = _setup(v["genotype"], v.get("aux_cell", False))
    if v.get("stage1"):
        opt = optax.chain(optax.clip_by_global_norm(STAGE1["clip"]),
                          optax.add_decayed_weights(STAGE1["wd"]),
                          optax.sgd(STAGE1["lr"],
                                    momentum=STAGE1["momentum"]))
        state = jax_init_train_state(p["decoder"], s["decoder"], opt,
                                     do_polyak=True)
    else:
        opt = jax_create_optimisers(**OPT)
        state = jax_init_train_state(p, s, opt, do_polyak=True)
    step = _jax_step(variant, genotype, opt,
                     KD_COEFF if v.get("kd") else 0.0,
                     v.get("freeze_encoder", False))
    batch = _jax_batch(v, p, s)
    inputs = "taps" if v.get("stage1") else "image"
    states, sides = [_jax_snap(state)], {side: [] for side in SPREAD_SIDES}
    for _ in range(STEPS):
        for side in SPREAD_SIDES:
            moved, b = state, batch
            if side == "reversed":
                b = _jax_batch(v, p, s, reverse=True)
            elif side == "perturbed":
                moved = state._replace(
                    params=_one_rounding(_np_tree(state.params)))
            else:
                b = dict(batch, **{inputs: _one_rounding(
                    jax.tree.map(np.asarray, batch[inputs]), seed=5)})
            sides[side].append(_jax_snap(*step(moved, b)))
        state, loss = step(state, batch)
        states.append(_jax_snap(state, loss))
    return states, sides


# faults planted in the port's run by the test (``_port_run``): the
# quantity each must throw out of its limits, and in which groups
FAULTS = {
    "no_encoder_update": ("params", ("encoder",)),
    "learning_rates_swapped": ("params", ("encoder", "decoder")),
    "polyak_skipped": ("polyak", ("encoder", "decoder")),
}


@functools.lru_cache(maxsize=None)
def _port_run(variant, fault=None):
    """The port's step k of ``variant`` from JAX's state before it, for
    each k, as ``_jax_snap`` gives JAX's. ``fault``: one of ``FAULTS``,
    planted here: the encoder's learning rate 0, the two groups'
    learning rates swapped, or the Polyak average put back as it was
    before the step."""
    v = VARIANTS[variant]
    genotype, _, _, model = _setup(v["genotype"], v.get("aux_cell", False))
    image, label, teacher = _batch()
    batch = {"image": image, "label": label}
    if v.get("kd"):
        batch["teacher"] = _nchw(teacher)
    if v.get("stage1"):
        module = model.decoder
        batch["taps"] = make_encoder_cache_fn()(model.encoder, image)
        opt = sgd_chain(STAGE1["lr"], momentum=STAGE1["momentum"],
                        wd=STAGE1["wd"], clip=STAGE1["clip"])
        step = make_decoder_train_step(genotype, opt, num_classes=K,
                                       aux_weight=AUX_WEIGHT)
    else:
        module = model
        kw = dict(OPT)
        if fault == "no_encoder_update":
            kw["enc_lr"] = 0.0
        elif fault == "learning_rates_swapped":
            kw["enc_lr"], kw["dec_lr"] = kw["dec_lr"], kw["enc_lr"]
        opt = create_optimisers(**kw)
        step = make_train_step(genotype, opt, num_classes=K,
                               aux_weight=AUX_WEIGHT,
                               kd_coeff=KD_COEFF if v.get("kd") else 0.0,
                               freeze_encoder=v.get("freeze_encoder", False))
    out = []
    for before in _jax_run(variant)[0][:-1]:
        load_jax_params(module, before["params"], before["stats"])
        state = TrainState(module, _named(before["trace"]),
                           _named(before["polyak"]), before["step"])
        kept = {n: t.clone() for n, t in state.polyak.items()}
        state, loss = step(state, batch)
        if fault == "polyak_skipped":
            state.polyak = kept
        out.append({"params": to_jax_tree(state.params),
                    "stats": to_jax_tree(state.stats),
                    "trace": to_jax_tree(state.opt_state),
                    "polyak": to_jax_tree(state.polyak),
                    "step": state.step, "loss": float(loss)})
    return out


def _errors(variant, what, got):
    """[(step, group, error, spread, update)] of ``what`` in the port's
    steps ``got``: the L2 distance to JAX's state after the step, the
    largest of the spread sides' distances to it, and JAX's own move in
    the step, by group."""
    states, sides = _jax_run(variant)
    out = []
    for k in range(STEPS):
        want, before = states[k + 1][what], states[k][what]
        for group in _groups(want):
            out.append((k + 1, group, _dist(got[k][what], want, group),
                        max(_dist(sides[side][k][what], want, group)
                            for side in SPREAD_SIDES),
                        _dist(want, before, group)))
    return out


def _limit(what, spread, update):
    return max(FLOOR[what] * update, SPREAD * spread)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("what", ["losses", "params", "stats", "polyak"])
def test_steps_match_jax(variant, what):
    """"params" holds the parameters and the momentum traces."""
    got = _port_run(variant)
    states = _jax_run(variant)[0]
    if what == "losses":
        sides = _jax_run(variant)[1]
        for k in range(STEPS):
            w = states[k + 1]["loss"]
            spread = max(abs(sides[side][k]["loss"] - w)
                         for side in SPREAD_SIDES)
            assert abs(got[k]["loss"] - w) <= max(1e-5 * abs(w),
                                                  SPREAD * spread), \
                (k + 1, got[k]["loss"], w, spread)
            assert got[k]["step"] == states[k + 1]["step"] == k + 1
        return
    for key in ("params", "trace") if what == "params" else (what,):
        for k, group, err, spread, update in _errors(variant, key, got):
            limit = _limit(key, spread, update)
            assert err <= limit, (
                f"{key} step {k} {group}: {err} > max({FLOOR[key]} x "
                f"{update}, {SPREAD} x {spread})")
            if key != "stats" and update > 0:
                # the limit still catches a step skipped or taken twice
                assert SPREAD * spread < update, (key, k, group)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_step_limits(fault):
    """Each fault planted in the port's plain run throws its quantity out
    of ``test_steps_match_jax``'s limits at every step: the limits are
    tight enough to see a missing encoder update, the groups' learning
    rates swapped, and a skipped Polyak average."""
    what, groups = FAULTS[fault]
    got = _port_run("plain", fault)
    for k, group, err, spread, update in _errors("plain", what, got):
        if group in groups:
            assert err > _limit(what, spread, update), (fault, k, group)


def test_frozen_encoder_decays_and_keeps_its_stats():
    """Under freeze_encoder the encoder's parameters take weight decay
    and momentum on zero gradients, as optax gives them, and its
    BatchNorm stats stay as they were: the port's STEPS steps on its own
    state and JAX's, exact, no spread."""
    genotype, p0, s0, model = _setup("arch0")
    image, label, _ = _batch()
    opt = create_optimisers(**OPT)
    state = init_train_state(model, opt, do_polyak=True)
    step = make_train_step(genotype, opt, num_classes=K,
                           aux_weight=AUX_WEIGHT, freeze_encoder=True)
    for _ in range(STEPS):
        state, _ = step(state, {"image": image, "label": label})
    assert state.step == STEPS
    got_p = _flat(to_jax_tree(state.params)["encoder"])
    got_s = to_jax_tree(state.stats)["encoder"]
    jax_p = _flat(_jax_run("frozen_encoder")[0][-1]["params"]["encoder"])
    lr, wd, mom = OPT["enc_lr"], OPT["enc_wd"], 0.9
    for k, p in _flat(p0["encoder"]).items():
        want, trace = p.astype(np.float32), np.zeros_like(p)
        for _ in range(STEPS):
            trace = (wd * want + mom * trace).astype(np.float32)
            want = (want - lr * trace).astype(np.float32)
        if not np.any(p):                 # a zero bias decays to zero
            assert not np.any(got_p[k]) and not np.any(jax_p[k]), k
            continue
        assert _rel(got_p[k], want) <= 1e-6, k
        assert _rel(jax_p[k], want) <= 1e-6, k
        assert _rel(got_p[k], p) > 1e-5, k
    assert _dist(got_s, s0["encoder"]) == 0.0


def test_stage1_cached_taps_match_jax():
    _, p, s, model = _setup("arch0")
    image = _batch()[0]
    want = _jax_cache()(p["encoder"], s["encoder"], jnp.asarray(image))
    got = make_encoder_cache_fn()(model.encoder.train(), image)
    assert model.encoder.training
    for g, w in zip(got, want):
        assert _rel(_nhwc(g), w) <= 1e-5


# ------------------------------------------------------------ eval step


def test_eval_step_confusion_matrix_matches_jax():
    genotype, p, s, model = _setup("arch0", perturb=True)
    image, label, _ = _batch()
    want = jax_make_eval_step(genotype, num_classes=K)(
        p, s, {"image": jnp.asarray(image), "label": jnp.asarray(label)})
    state = init_train_state(model, create_optimisers())
    params, stats = eval_params_stats(state)
    got = make_eval_step(genotype, num_classes=K)(
        params, stats, {"image": image, "label": label})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == int(((label >= 0) & (label < K)).sum())


# ------------------------------------------------------- the hand-off


@pytest.mark.parametrize("name", list(GENOTYPES))
def test_model_with_aux_heads_serves_as_without(name):
    """The heads draw from the generator after every other module: the
    same seed gives the same served weights with or without them, and
    the engine ignores the heads."""
    genotype = GENOTYPES[name]
    with_heads, without = (
        Segmenter(genotype, K, aux=aux, aux_cell=aux,
                  generator=torch.Generator().manual_seed(3)).eval()
        for aux in (True, False))
    assert len(with_heads.state_dict()) > len(without.state_dict())
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3), np.uint8)
    got, want = (Engine(m, device="cpu", compute_dtype=torch.float32,
                        use_kernels=False).predict(img, return_logits=True)
                 for m in (with_heads, without))
    np.testing.assert_array_equal(got, want)
