"""segtpu_torch's masked supernet against segtpu's, on the CPU.

Weights: a port supernet (BatchNorm perturbed) is written into the JAX
pytree whose structure ``jax.eval_shape(supernet_init)`` gives, and a
fresh port module loads that tree back through ``load_jax_params``, so
both packages run the same weights. SupernetSpec(agg_size 8, 4 classes),
two images, 16x16 stride-4 taps, 64x64 labels with a band of 255. Each
JAX reference is computed once, un-vmapped, in module fixtures.

* Against JAX: ``masks_from_actions`` and ``template_masks_from_actions``
  exactly; the micro and template forwards in eval and train mode
  (logits, aux logits, new BatchNorm statistics) and one sample's loss
  and gradient (JAX's ``one_loss`` under ``jax.value_and_grad``) at
  ``TOL``; one sample's confusion matrix exactly.
* Against the port itself: each one-hot op mask selects its ``Op``; the
  supernet equals the discrete micro decoder on equal-resolution taps; a
  K = 3 population step (vmapped) equals the 3 samples' sequential steps
  (``make_sequential_train_step``: autograd and ``sgd_chain``); the clip
  is per sample; the eval counts every valid label;
  ``load_jax_population`` carries a JAX ``PopState`` across; the CUDA
  graph step's in-place buffers (run without a graph here) follow the
  eager step.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

import segtpu.supernet as jsn
from segtpu.core.resize import resize_bilinear as jax_resize
from segtpu.engine.trainer import segmentation_loss as jax_loss
from segtpu.utils.metrics import confusion_matrix as jax_confusion

from segtpu_torch import supernet as sn
from segtpu_torch.convert import load_jax_params, load_jax_population
from segtpu_torch.core.layers import ConvBN
from segtpu_torch.models.encoders import MBV2_TAP_CHANNELS
from segtpu_torch.models.micro_decoders import (MicroDecoder,
                                                _decoder_collect_inds)
from segtpu_torch.ops.layer_factory import OP_NAMES, Op
from segtpu_torch.rl import controller as ctrl
from segtpu_torch.utils.solvers import PopulationSGD, sgd_chain

SPEC = sn.SupernetSpec(num_classes=4, agg_size=8)
JSPEC = jsn.SupernetSpec(num_classes=4, agg_size=8)
AUX_WEIGHT = 0.15
# f32: forwards and statistics elementwise
TOL = dict(rtol=1e-4, atol=1e-5)
# each gradient leaf within GRAD_TOL of its max |.| (tighter than TOL's
# atol for every leaf here); measured: 1.5e-4 at worst of 857 leaves
# (a 3x3 conv whose gradient peaks at 7.3e-5), 1.2e-4 next (adapt.2's
# BatchNorm bias), the rest <= 7.4e-5: train-mode BatchNorm's sums
GRAD_TOL = 3e-4
MICRO_ACTIONS = [1, 1, 1, 2, 0, 2, 2, 9, 4, 3, 3, 0, 2, 0, 1, 2, 3, 1, 2]
TEMPLATE_ACTIONS = [3, 2, 1, 5, 4, 1, 0, 4, 0, 5, 1, 3]
FAMILIES = {"micro": (jsn.supernet_init, jsn.supernet_apply,
                      jsn.masks_from_actions, MICRO_ACTIONS),
            "template": (jsn.template_supernet_init,
                         jsn.template_supernet_apply,
                         jsn.template_masks_from_actions, TEMPLATE_ACTIONS)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs, restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _exact_convolutions():
    """PyTorch's own f32 convolutions, not oneDNN's (whose f32 backward
    loses bits on AMX CPUs, tests/test_torch_trainer.py)."""
    was = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = was


def perturb(net, seed):
    """Non-identity BatchNorm in every ConvBN of ``net``."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, ConvBN):
                c = m.scale.shape
                m.scale.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
                m.bias.copy_(torch.tensor(rng.normal(0, 0.1, c)))
                m.mean.copy_(torch.tensor(rng.normal(0, 0.1, c)))
                m.var.copy_(torch.tensor(rng.uniform(0.5, 1.5, c)))
    return net


def _key(path):
    return ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


@functools.lru_cache(maxsize=None)
def _jax_shapes(family):
    init = FAMILIES[family][0]
    return jax.eval_shape(lambda k: init(k, JSPEC, MBV2_TAP_CHANNELS),
                          jax.random.PRNGKey(0))


def jax_trees(net, family):
    """(params, stats) of ``net`` as numpy trees in the JAX init's
    structure (empty dicts for skip and none), kernels HWIO."""
    shapes = _jax_shapes(family)
    named = {**dict(net.named_parameters()), **dict(net.named_buffers())}

    def leaf(path, sd):
        arr = named[_key(path)].detach().numpy().copy()
        if arr.ndim == 4:
            arr = arr.transpose(2, 3, 1, 0)
        assert arr.shape == sd.shape, _key(path)
        return arr

    return tuple(jax.tree_util.tree_map_with_path(leaf, t) for t in shapes)


def flat(tree):
    """A JAX tree -> {dotted path: numpy}, kernels OIHW."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        x = np.asarray(x)
        out[_key(path)] = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x
    return out


def port_net(family, trees=None):
    """A fresh port supernet, with ``trees`` loaded when given."""
    net = sn.SUPERNETS[family](SPEC, MBV2_TAP_CHANNELS,
                               generator=torch.Generator().manual_seed(9))
    return load_jax_params(net, *trees) if trees is not None else net


def _batch():
    rng = np.random.RandomState(0)
    taps = [rng.randn(2, 16 // s, 16 // s, c).astype(np.float32)
            for s, c in zip((1, 2, 4, 8), MBV2_TAP_CHANNELS)]
    label = rng.randint(0, 4, size=(2, 64, 64)).astype(np.int32)
    label[:, :6] = 255
    return taps, label


@pytest.fixture(scope="module")
def world():
    """Per family: the JAX trees, masks; the shared batch both ways."""
    taps, label = _batch()
    out = {"taps_nhwc": [jnp.asarray(t) for t in taps],
           "label": label,
           "batch": {"taps": [torch.from_numpy(t.transpose(0, 3, 1, 2).copy())
                              for t in taps],
                     "label": torch.from_numpy(label)}}
    for i, family in enumerate(FAMILIES):
        net = perturb(port_net(family), i)
        mask_fn, actions = FAMILIES[family][2], FAMILIES[family][3]
        out[family] = {"trees": jax_trees(net, family),
                       "jmasks": mask_fn(np.asarray(actions), JSPEC),
                       "masks": sn.MASK_FNS[family](torch.tensor(actions),
                                                    SPEC)}
    return out


@pytest.fixture(scope="module")
def jax_forwards(world):
    """(family, train) -> JAX's (logits, aux, new stats), computed once."""
    cache = {}

    def get(family, train):
        if (family, train) not in cache:
            w = world[family]
            cache[family, train] = FAMILIES[family][1](
                JSPEC, *w["trees"], w["jmasks"], world["taps_nhwc"],
                train=train, with_aux=True)
        return cache[family, train]

    return get


def _close(got, want, what, **tol):
    np.testing.assert_allclose(got, want, err_msg=what, **(tol or TOL))


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


# ------------------------------------------------------------ masks


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_masks_match_jax(family):
    """Each of three sampled action vectors' masks equal JAX's exactly,
    and the [K, n_slots] batch equals the stacked singles."""
    spec = (ctrl.MicroControllerSpec() if family == "micro"
            else ctrl.TemplateControllerSpec())
    params = ctrl.controller_init(torch.Generator().manual_seed(3), spec)
    acts = torch.stack([ctrl.sample(params, spec, torch.Generator()
                                    .manual_seed(i))[0] for i in range(3)])
    batched = sn.MASK_FNS[family](acts, SPEC)
    for i, a in enumerate(acts):
        want = FAMILIES[family][2](a.numpy(), JSPEC)
        got = sn.MASK_FNS[family](a, SPEC)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
            np.testing.assert_array_equal(batched[k][i].numpy(),
                                          got[k].numpy())


# ------------------------------------------------------------ forwards


@pytest.mark.parametrize("family,train", [("micro", False), ("micro", True),
                                          ("template", False),
                                          ("template", True)])
def test_forward_matches_jax(world, jax_forwards, family, train):
    """Logits, the aux heads' logits and (train mode) the new BatchNorm
    running statistics on JAX's weights carried across."""
    w = world[family]
    logits_j, aux_j, stats_j = jax_forwards(family, train)
    net = port_net(family, w["trees"]).train(train)
    logits, aux = net(w["masks"], world["batch"]["taps"], with_aux=True)
    _close(logits.detach().numpy(), _nchw(logits_j), "logits")
    assert len(aux) == len(aux_j) == SPEC.num_blocks
    for b, (a, aj) in enumerate(zip(aux, aux_j)):
        _close(a.detach().numpy(), _nchw(aj), f"aux {b}")
    want = flat(stats_j)
    got = dict(net.named_buffers())
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], k)
    if train:   # a masked-off op's statistics moved too (op 0)
        k = ("blocks.0.node0.0.conv.mean" if family == "micro"
             else "blocks.0.ops.0.conv.mean")
        assert not np.allclose(want[k], flat(w["trees"][1])[k])


def test_loss_and_gradient_match_jax(world):
    """One micro sample's loss and gradient: the port's vmapped
    ``make_population_grad_fn`` at K = 1 against JAX's one_loss under
    ``jax.value_and_grad`` (not vmapped)."""
    w = world["micro"]
    jparams, jstats = w["trees"]
    label = jnp.asarray(world["label"])

    def one_loss(params):
        logits, aux, _ = jsn.supernet_apply(
            JSPEC, params, jstats, w["jmasks"], world["taps_nhwc"],
            train=True, with_aux=True)
        return jax_loss(logits, aux, label, num_classes=4,
                        aux_weight=AUX_WEIGHT)

    loss_j, grads_j = jax.value_and_grad(one_loss)(jparams)
    net = port_net("micro", w["trees"])
    one = lambda t: {k: v[None] for k, v in t.items()}  # noqa: E731
    grads, losses = sn.make_population_grad_fn(SPEC, aux_weight=AUX_WEIGHT)(
        one({k: p.detach() for k, p in net.named_parameters()}),
        one({k: b.clone() for k, b in net.named_buffers()}),
        one(w["masks"]), world["batch"])
    _close(losses[0].item(), float(loss_j), "loss")
    want = flat(grads_j)
    assert sorted(grads) == sorted(want)
    for k, g in want.items():
        err = np.abs(grads[k][0].numpy() - g).max()
        assert err <= GRAD_TOL * np.abs(g).max() + 1e-8, (k, err)


def test_confusion_matrix_matches_jax(world, jax_forwards):
    """One sample's eval: the port's population eval at K = 1 against
    JAX's eval-mode logits resized in f32, argmax, confusion matrix."""
    w = world["micro"]
    logits_j = jax_forwards("micro", False)[0]
    up = jax_resize(logits_j, world["label"].shape[1:3],
                    compute_dtype=jnp.float32)
    want = np.asarray(jax_confusion(jnp.argmax(up, -1),
                                    jnp.asarray(world["label"]), 4))
    net = port_net("micro", w["trees"])
    one = lambda t: {k: v[None] for k, v in t.items()}  # noqa: E731
    got = sn.make_population_eval_step(SPEC)(
        one({k: p.detach() for k, p in net.named_parameters()}),
        one(dict(net.named_buffers())), one(w["masks"]), world["batch"])
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert len(np.flatnonzero(want.sum(0))) > 1   # not one class


# ------------------------------------------------------------ the port


@pytest.mark.parametrize("op", range(len(OP_NAMES)))
def test_one_hot_selects_its_op(op):
    ops = sn.AllOps(8, generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 8, 8, generator=torch.Generator().manual_seed(1))
    mask = torch.nn.functional.one_hot(torch.tensor(op), len(OP_NAMES))
    torch.testing.assert_close(ops(x, mask.float()), ops[op](x), rtol=0,
                               atol=0)
    assert isinstance(ops[op], Op) and ops[op].name == OP_NAMES[op]


def test_supernet_matches_discrete_decoder():
    """With equal-resolution taps (every resize the identity) the micro
    supernet's one-hot forward equals the discrete ``MicroDecoder`` built
    from the genotype's slices of its weights; no cell node re-selects
    position 0, the case where the cell input would leak."""
    spec = sn.SupernetSpec(num_classes=5, agg_size=16)
    genotype = [[1, [1, 1, 2, 0], [2, 2, 9, 4], [3, 3, 0, 2]],
                [[0, 1], [2, 3], [1, 2]]]
    cell, conns = genotype
    sup = perturb(sn.Supernet(spec, MBV2_TAP_CHANNELS,
                              generator=torch.Generator().manual_seed(0)), 1)
    dec = MicroDecoder(genotype, MBV2_TAP_CHANNELS, 5, agg_size=16,
                       generator=torch.Generator().manual_seed(0))
    src = sup.state_dict()
    collect = _decoder_collect_inds(conns, 4)
    sd = {}
    for k in dec.state_dict():
        parts = k.split(".")
        if parts[0] == "adapt":
            sd[k] = src[k]
        elif parts[0] == "clf":
            sd[k] = (torch.cat([src["clf.w"][i] for i in collect]).t()
                     [:, :, None, None] if parts[1] == "w" else src["clf.b"])
        else:
            b, rest = parts[1], parts[2:]
            if rest[0] == "agg":
                name = {"branch1": "agg1", "branch2": "agg2"}[rest[1]]
                sd[k] = src[".".join(["blocks", b, name] + rest[2:])]
            elif rest[1] == "node0":
                sd[k] = src[".".join(["blocks", b, "node0", str(cell[0])]
                                     + rest[2:])]
            else:
                n, ab = int(rest[2]), rest[3]
                o = cell[n + 1][2 if ab == "a" else 3]
                sd[k] = src[".".join(["blocks", b, "nodes", str(n), ab,
                                      str(o)] + rest[4:])]
    dec.load_state_dict(sd)
    rng = np.random.RandomState(7)
    taps = [torch.from_numpy(rng.randn(2, c, 8, 8).astype(np.float32))
            for c in MBV2_TAP_CHANNELS]
    actions = ctrl.actions_from_genotype(genotype, ctrl.MicroControllerSpec())
    got, _ = sup(sn.masks_from_actions(actions, spec), taps)
    torch.testing.assert_close(got, dec(taps), **TOL)


def _population(family, k, seed=0):
    return sn.population_init(torch.Generator().manual_seed(seed), SPEC,
                              MBV2_TAP_CHANNELS, k, family=family,
                              do_polyak=True, device="cpu")


def _masks(family, k):
    spec = (ctrl.MicroControllerSpec() if family == "micro"
            else ctrl.TemplateControllerSpec())
    params = ctrl.controller_init(torch.Generator().manual_seed(1), spec)
    acts = torch.stack([ctrl.sample(params, spec, torch.Generator()
                                    .manual_seed(i))[0] for i in range(k)])
    return sn.MASK_FNS[family](acts, SPEC)


# the optimizer of the search's stage 1 at a clip every sample exceeds
OPT = PopulationSGD(0.05, momentum=0.9, wd=1e-4, clip=0.5)
# each leaf within SEQ_TOL of max(its max |.|, SEQ_FLOOR); measured over
# two steps: <= 9e-8 absolute everywhere, <= 1.2e-5 of the leaf's max for
# every leaf above 1e-4 (a few depthwise BatchNorm biases sit near 1e-7,
# their gradients cancelling, where the 9e-8 lands)
SEQ_TOL, SEQ_FLOOR = 1e-5, 0.1


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_population_step_equals_sequential(world, family):
    """Two vmapped steps of a K = 3 population equal the 3 samples'
    sequential steps: losses, parameters, momentum traces, Polyak
    averages (first step at decay 0.5) and BatchNorm statistics."""
    pop = _population(family, 3)
    masks = _masks(family, 3)
    vec = sn.make_population_train_step(SPEC, OPT, family=family)
    seq = sn.make_sequential_train_step(SPEC, OPT, family=family)
    a = b = pop
    for _ in range(2):
        a, la = vec(a, masks, world["batch"])
        b, lb = seq(b, masks, world["batch"])
        torch.testing.assert_close(la, lb, rtol=1e-6, atol=1e-6)
    assert a.step == b.step == 2
    for field in ("params", "stats", "opt_state", "polyak"):
        got, want = getattr(a, field), getattr(b, field)
        assert sorted(got) == sorted(want)
        for k in want:
            err = (got[k] - want[k]).abs().max().item()
            assert err <= SEQ_TOL * max(want[k].abs().max().item(),
                                        SEQ_FLOOR), (field, k, err)
    # the step moved every sample, and the start state is untouched
    fresh = _population(family, 3)
    for k, t in pop.params.items():
        torch.testing.assert_close(t, fresh.params[k], rtol=0, atol=0)
    assert not torch.equal(a.params["clf.w"], pop.params["clf.w"])


def test_clip_is_per_sample():
    """Sample 0's gradients scaled by 100 leave samples 1 and 2's updates
    as they were; every sample's update is ``sgd_chain``'s on that sample
    alone. One norm over the population fails both."""
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(3, 4, 5, generator=g),
              "b": torch.randn(3, 6, generator=g)}
    grads = {n: torch.randn(t.shape, generator=g) for n, t in params.items()}
    trace = {n: torch.randn(t.shape, generator=g) for n, t in params.items()}
    assert (PopulationSGD.norms(list(grads.values())) > OPT.group.clip).all()
    p1, t1 = OPT.update(grads, trace, params)
    scaled = {n: torch.cat([x[:1] * 100, x[1:]]) for n, x in grads.items()}
    p2, t2 = OPT.update(scaled, trace, params)
    for n in params:
        torch.testing.assert_close(p2[n][1:], p1[n][1:], rtol=0, atol=0)
        torch.testing.assert_close(t2[n][1:], t1[n][1:], rtol=0, atol=0)
    cfg = OPT.group
    for i in range(3):
        p = {n: t[i].clone() for n, t in params.items()}
        tr = {n: t[i].clone() for n, t in trace.items()}
        sgd_chain(cfg.lr, momentum=cfg.momentum, wd=cfg.wd,
                  clip=cfg.clip).update({n: t[i] for n, t in grads.items()},
                                        tr, p)
        for n in params:
            torch.testing.assert_close(p1[n][i], p[n], rtol=1e-6, atol=1e-7)
            torch.testing.assert_close(t1[n][i], tr[n], rtol=1e-6, atol=1e-7)


def test_population_eval_counts_every_label(world):
    pop = _population("template", 2)
    cms = sn.make_population_eval_step(SPEC, family="template")(
        pop.eval_params(), pop.stats, _masks("template", 2), world["batch"])
    label = world["label"]
    assert cms.shape == (2, 4, 4) and cms.dtype == torch.int64
    assert (cms.sum((1, 2)) == int(((label >= 0) & (label < 4)).sum())).all()


def test_jax_population_converts(world):
    """A JAX PopState (K-stacked trees, optax's chain state with its
    momentum trace, Polyak, step) -> the port's PopState leaf for leaf."""
    pop, _ = sn.make_population_train_step(SPEC, OPT)(
        _population("micro", 2), _masks("micro", 2), world["batch"])
    nets = []
    for i in range(2):
        net = port_net("micro")
        net.load_state_dict({**sn.sample_of(pop.params, i),
                             **sn.sample_of(pop.stats, i)})
        nets.append(net)

    def stacked(field):
        trees = []
        for i, net in enumerate(nets):
            if field != "params":
                net.load_state_dict(sn.sample_of(getattr(pop, field), i),
                                    strict=False)
            trees.append(jax_trees(net, "micro")[0])
        return jax.tree.map(lambda *xs: np.stack(xs), *trees)

    stats = jax.tree.map(lambda *xs: np.stack(xs),
                         *[jax_trees(n, "micro")[1] for n in nets])
    params = stacked("params")
    opt = optax.chain(optax.clip_by_global_norm(0.5),
                      optax.add_decayed_weights(1e-4),
                      optax.sgd(0.05, momentum=0.9))
    state = jax.vmap(opt.init)(params)
    state = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(state),
        jax.tree_util.tree_leaves(stacked("opt_state")))
    polyak = stacked("polyak")
    got = load_jax_population(jsn.PopState(params, stats, state, polyak,
                                           jnp.asarray(pop.step)))
    assert got.step == pop.step == 1
    for field in ("params", "stats", "opt_state", "polyak"):
        g, w = getattr(got, field), getattr(pop, field)
        assert sorted(g) == sorted(w), field
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=0)


def test_graphed_step_buffers_equal_eager(world):
    """``GraphedPopulationStep``'s in-place buffers (on a CPU, without
    the graph the card captures) follow the eager step over three steps
    and a new population copied in; Polyak's add is written otherwise,
    within 1e-6."""
    masks = _masks("micro", 3)
    eager = sn.make_population_train_step(SPEC, OPT)
    graphed = sn.GraphedPopulationStep(SPEC, OPT)
    batch2 = {"taps": [t.flip(0) for t in world["batch"]["taps"]],
              "label": world["batch"]["label"].flip(0)}
    for seed in (0, 5):
        a = b = _population("micro", 3, seed)
        for i in range(3):
            batch = (world["batch"], batch2)[i % 2]
            a, la = eager(a, masks, batch)
            b, lb = graphed(b, masks, batch)
            torch.testing.assert_close(lb, la, rtol=0, atol=0)
        assert a.step == b.step == 3
        for field in ("params", "stats", "opt_state", "polyak"):
            tol = 1e-6 if field == "polyak" else 0
            for k, t in getattr(a, field).items():
                torch.testing.assert_close(getattr(b, field)[k], t,
                                           rtol=0, atol=tol)


def test_resize_matrices_cached_for_autograd():
    """The resize's device copies of its matrices (cached so that a CUDA
    graph's capture makes no host copy) serve autograd after a first
    resize in inference mode, as the engine's precedes training."""
    from segtpu_torch.core.resize import resize_bilinear
    with torch.inference_mode():
        first = resize_bilinear(torch.ones(1, 2, 5, 7), (9, 11))
    x = torch.randn(1, 2, 5, 7, requires_grad=True)
    y = resize_bilinear(x, (9, 11))
    y.sum().backward()
    torch.testing.assert_close(first, torch.ones(1, 2, 9, 11))
    assert x.grad.shape == x.shape and torch.isfinite(x.grad).all()
