"""segtpu_torch.rl against segtpu.rl on the CPU, on JAX's weights.

The controller's JAX parameters (``controller_init``) are carried into
the port by ``convert.load_jax_controller``, for the micro and the
template spec:

* ``evaluate``'s log-probs and entropies on JAX-sampled actions, one
  vector and a batch of K: max|d| <= 1e-6 (f32 LSTM, 19 or 12 slots);
* ``sample`` stays inside each slot's mask, its log-probs equal its own
  ``evaluate``'s (1e-6), and its first slot's frequencies over 2000
  draws lie within 5 binomial standard deviations (+1e-3) of JAX's
  softmax for that slot, on weights scaled to make it far from uniform;
* one REINFORCE, one PPO and one batch update of each from the same
  state (JAX's, after two updates, so that Adam's moments are not zero):
  the parameters within 1e-3 of JAX's own move in the update (+1e-9),
  Adam's moments within 1e-4 of each leaf's max|.| (+1e-12), the step
  count equal and the baseline within 1e-7. Planted faults (the baseline
  moved before the advantage is taken, PPO without its clip, Adam without
  bias correction) must fail those limits (measured: the port within
  1.5e-2 of its parameter limit, the faults 25x to 3900x over it);
* ``utils.solvers.Adam`` against ``optax.adam`` over five steps (rel
  1e-6), and the genotype decoders against JAX's.
"""

import functools

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp

import segtpu.rl.agent as jag
import segtpu.rl.controller as jct

import segtpu_torch.rl.agent as tag
import segtpu_torch.rl.controller as tct
from segtpu_torch.convert import controller_to_jax, load_jax_controller
from segtpu_torch.models.micro_decoders import validate_genotype
from segtpu_torch.models.template_decoders import validate_template_genotype
from segtpu_torch.utils.solvers import Adam, AdamState

SPECS = {"micro": (tct.MicroControllerSpec(), jct.MicroControllerSpec()),
         "template": (tct.TemplateControllerSpec(),
                      jct.TemplateControllerSpec())}
LR, DECAY, ENT, CLIP = 5e-3, 0.95, 1e-4, 0.2
TOL = {"param": 1e-3, "moment": 1e-4, "baseline": 1e-7}
DRAWS = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread while this module runs (the suite runs six
    workers on the machine's cores), restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_actions(jspec, params, n, seed=0):
    smp = jax.jit(lambda k: jct.sample(params, jspec, k))
    return [smp(jax.random.PRNGKey(seed + i)) for i in range(n)]


def _max(tree):
    return max(float(np.abs(x).max()) for x in jax.tree.leaves(tree))


def _diff(a, b):
    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_specs_match_jax():
    for tspec, jspec in SPECS.values():
        assert tspec.slot_sizes == jspec.slot_sizes
        assert tspec.n_slots == jspec.n_slots
        assert tspec.max_vocab == jspec.max_vocab
        np.testing.assert_array_equal(tspec.mask(), jspec.mask())
        assert tuple(tspec) == tuple(jspec)
    assert SPECS["micro"][0].n_slots == 19
    assert SPECS["template"][0].n_slots == 12


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_evaluate_matches_jax(kind):
    tspec, jspec = SPECS[kind]
    jp = jct.controller_init(jax.random.PRNGKey(3), jspec)
    tp = load_jax_controller(_np(jp))
    draws = _jax_actions(jspec, jp, 6)
    for actions, logprobs, entropies in draws:
        lp, ent = tct.evaluate(tp, tspec, np.asarray(actions))
        jlp, jent = jct.evaluate(jp, jspec, actions)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(lp.numpy(), np.asarray(logprobs), rtol=0,
                                   atol=1e-6)
    batch = np.stack([np.asarray(d[0]) for d in draws])
    lp, ent = tct.evaluate(tp, tspec, batch)
    jlp, jent = jax.vmap(lambda a: jct.evaluate(jp, jspec, a))(batch)
    assert lp.shape == ent.shape == batch.shape
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ent.numpy(), np.asarray(jent), rtol=0,
                               atol=1e-6)


def _first_slot_probs(jp, jspec):
    """JAX's categorical of the first slot: its masked softmax."""
    h = jnp.zeros((jspec.hidden_size,))
    h, _ = jct._lstm_step(jp["lstm"], h, h,
                          jp["embed"][jspec.max_vocab] + jp["slot_embed"][0])
    logp, _ = jct._masked_dist(jct._slot_logits(jp, jspec, h),
                               jnp.asarray(jspec.mask()[0]))
    return np.exp(np.asarray(logp, np.float64))


@pytest.mark.parametrize("kind", sorted(SPECS))
def test_sample_keeps_masks_and_matches_jax_softmax(kind):
    tspec, jspec = SPECS[kind]
    jp = _np(jct.controller_init(jax.random.PRNGKey(4), jspec))
    jp["head"]["w"] = jp["head"]["w"] * 20.0   # a first slot far from uniform
    tp = load_jax_controller(jp)
    gen = torch.Generator().manual_seed(11)
    sizes = np.asarray(tspec.slot_sizes)
    counts = np.zeros(tspec.max_vocab)
    for i in range(DRAWS):
        actions, logprobs, entropies = tct.sample(tp, tspec, gen)
        a = actions.numpy()
        assert actions.dtype == torch.int64 and a.shape == (tspec.n_slots,)
        assert ((a >= 0) & (a < sizes)).all(), a
        counts[a[0]] += 1
        if i < 20:
            lp, ent = tct.evaluate(tp, tspec, actions)
            np.testing.assert_allclose(logprobs.numpy(), lp.numpy(), rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(entropies.numpy(), ent.numpy(),
                                       rtol=0, atol=1e-6)
            if kind == "micro":
                validate_genotype(tct.genotype_from_actions(a, tspec))
            else:
                validate_template_genotype(
                    tct.template_genotype_from_actions(a, tspec))
    p = _first_slot_probs(jp, jspec)
    assert p.max() > 2 * p[p > 0].min()            # not uniform
    freq = counts / DRAWS
    bound = 5 * np.sqrt(p * (1 - p) / DRAWS) + 1e-3
    assert (np.abs(freq - p) <= bound).all(), (freq, p)
    assert (counts[tspec.slot_sizes[0]:] == 0).all()


def _genotype_decoders():
    tspec, jspec = SPECS["micro"]
    jp = jct.controller_init(jax.random.PRNGKey(5), jspec)
    for actions, _, _ in _jax_actions(jspec, jp, 5):
        g = tct.genotype_from_actions(torch.tensor(np.asarray(actions)),
                                      tspec)
        assert g == jct.genotype_from_actions(actions, jspec)
        back = tct.actions_from_genotype(g, tspec)
        np.testing.assert_array_equal(back.numpy(), np.asarray(actions))
        assert back.dtype == torch.int64
    tspec, jspec = SPECS["template"]
    jp = jct.controller_init(jax.random.PRNGKey(5), jspec)
    for actions, _, _ in _jax_actions(jspec, jp, 5):
        assert (tct.template_genotype_from_actions(np.asarray(actions), tspec)
                == jct.template_genotype_from_actions(actions, jspec))


def test_genotype_decoders_match_jax():
    _genotype_decoders()


def test_adam_matches_optax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": {"c": rng.standard_normal(9).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(
        np.float32) * 10.0 ** rng.integers(-9, 2), params) for _ in range(5)]
    opt = optax.adam(1e-3)
    jstate, jparams = opt.init(params), params
    adam = Adam(1e-3)
    tparams = jax.tree.map(torch.tensor, params)
    tstate = adam.init(tparams)
    for g in grads:
        up, jstate = opt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, up)
        tparams, tstate = adam.update(jax.tree.map(torch.tensor, g), tstate,
                                      tparams)
    assert tstate.count == int(jstate[0].count) == 5
    for got, want in ((tparams, jparams), (tstate.mu, jstate[0].mu),
                      (tstate.nu, jstate[0].nu)):
        got = jax.tree.map(lambda t: t.numpy(), got)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x, np.asarray(y), rtol=1e-6,
                                       atol=1e-12)


# the updates: (algo, batched)
UPDATES = {"reinforce": ("reinforce", False), "ppo": ("ppo", False),
           "reinforce_batch": ("reinforce", True),
           "ppo_batch": ("ppo", True)}


@functools.lru_cache(maxsize=None)
def _jax_agent(kind, algo):
    """A JAX agent after two updates, and the (actions, reward, old
    log-probs) of the update under test, batched by K = 3 (the single
    update takes the first). PPO's old log-probs are the sampling's minus
    0.15 a slot, so its ratio starts outside the clip."""
    _, jspec = SPECS[kind]
    agent = jag.create_agent(jax.random.PRNGKey(1), spec=jspec, algo=algo,
                             lr=LR, baseline_decay=DECAY, entropy_coef=ENT,
                             ppo_clip=CLIP)
    smp = jax.jit(lambda p, k: jct.sample(p, jspec, k))
    draws = [smp(agent.state.params, jax.random.PRNGKey(20 + i))
             for i in range(5)]
    for (a, lp, _), r in zip(draws[:2], (0.6, 0.2)):
        agent = jag.train_agent(agent, a, r, old_logprobs=lp)
    acts = np.stack([np.asarray(d[0]) for d in draws[2:]])
    old = np.stack([np.asarray(d[1]) for d in draws[2:]]) - 0.15
    return agent, acts, np.array([0.7, 0.1, 0.45], np.float32), old


def _kwargs(name, old):
    algo, batched = UPDATES[name]
    if algo != "ppo":
        return {}
    return ({"old_logprobs_batch": old} if batched
            else {"old_logprobs": old[0]})


@functools.lru_cache(maxsize=None)
def _jax_update(kind, name):
    """JAX's state after the update under test."""
    algo, batched = UPDATES[name]
    agent, acts, rewards, old = _jax_agent(kind, algo)
    if batched:
        return jag.train_agent_batch(agent, acts, rewards,
                                     **_kwargs(name, old)).state
    return jag.train_agent(agent, acts[0], rewards[0],
                           **_kwargs(name, old)).state


def _port_state(jstate):
    adam = jstate.opt_state[0]
    return tag.AgentState(
        load_jax_controller(_np(jstate.params)),
        AdamState(int(adam.count), load_jax_controller(_np(adam.mu)),
                  load_jax_controller(_np(adam.nu))),
        torch.tensor(float(jstate.baseline)))


def _run_update(kind, name):
    """(port state, JAX state before, JAX state after) of one update."""
    algo, batched = UPDATES[name]
    tspec, _ = SPECS[kind]
    jagent, acts, rewards, old = _jax_agent(kind, algo)
    agent = tag.create_agent(torch.Generator().manual_seed(0), spec=tspec,
                             algo=algo, lr=LR, baseline_decay=DECAY,
                             entropy_coef=ENT, ppo_clip=CLIP, device="cpu")
    agent = agent._replace(state=_port_state(jagent.state))
    if batched:
        got = tag.train_agent_batch(agent, acts, rewards,
                                    **_kwargs(name, old))
    else:
        got = tag.train_agent(agent, acts[0], rewards[0],
                              **_kwargs(name, old))
    return got.state, jagent.state, _jax_update(kind, name)


def _errors(got, before, want):
    """{quantity: (error, limit)} of a port update against JAX's."""
    params = controller_to_jax(got.params)
    move = _diff(want.params, before.params)
    adam = want.opt_state[0]
    out = {"param": (_diff(params, want.params), TOL["param"] * move + 1e-9),
           "baseline": (abs(float(got.baseline) - float(want.baseline)),
                        TOL["baseline"])}
    for m in ("mu", "nu"):
        out[m] = (_diff(controller_to_jax(getattr(got.opt_state, m)),
                        getattr(adam, m)),
                  TOL["moment"] * _max(getattr(adam, m)) + 1e-12)
    out["count"] = (abs(got.opt_state.count - int(adam.count)), 0)
    return out


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("name", sorted(UPDATES))
def test_update_matches_jax(kind, name):
    errors = _errors(*_run_update(kind, name))
    for what, (err, limit) in errors.items():
        assert err <= limit, (what, err, limit)


class _AdamWithoutBiasCorrection(Adam):
    @torch.no_grad()
    def update(self, grads, state, params):
        from segtpu_torch.utils.solvers import tree_map
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state.nu)
        step = lambda p, m, v: p - self.lr * m / (torch.sqrt(v) + self.eps)  # noqa: E731
        return tree_map(step, params, mu, nu), AdamState(state.count + 1, mu,
                                                         nu)


FAULTS = {
    "baseline_moved_first": ("reinforce", "param",
                             lambda mp: mp.setattr(
                                 tag, "_advantage", lambda r, b: r - (
                                     DECAY * b + (1 - DECAY) * r))),
    "no_clip": ("ppo", "param",
                lambda mp: mp.setattr(tag, "_clip", lambda ratio, eps: ratio)),
    "adam_no_bias_correction": ("reinforce_batch", "param",
                                lambda mp: mp.setattr(
                                    tag, "Adam", _AdamWithoutBiasCorrection)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_update_limits(fault, monkeypatch):
    name, what, plant = FAULTS[fault]
    plant(monkeypatch)
    err, limit = _errors(*_run_update("micro", name))[what]
    assert err > limit, (fault, err, limit)
