"""Policy-gradient agent: REINFORCE with an EMA baseline, and PPO
(counterpart: segtpu/rl/agent.py).

The reward is the proxy-training score (the geometric mean of the two
stages' mIoUs, from the search loop). Each update takes the advantage
against the baseline before the EMA moves it, steps the controller's
parameters with ``utils.solvers.Adam`` (``optax.adam(lr)``), then moves
the baseline. PPO takes ``ppo_epochs`` clipped steps from the log-probs
of the sampling. The batch updates (the fleet's form) average over K
(actions, reward) pairs. Updates return a new ``AgentState`` and leave
the old one as it was.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from segtpu_torch.rl import controller as ctrl
from segtpu_torch.rl.controller import MicroControllerSpec
from segtpu_torch.utils.solvers import Adam, AdamState, tree_map


class AgentState(NamedTuple):
    params: Any           # the controller's parameter tree
    opt_state: AdamState
    baseline: torch.Tensor  # EMA reward baseline, 0-d f32


class Agent(NamedTuple):
    spec: MicroControllerSpec
    state: AgentState
    algo: str
    update_fn: Callable  # (state, actions, reward[, old_logprobs])
    batch_update_fn: Callable = None  # (state, actions[K], rewards[K], ...)


def _advantage(reward, baseline):
    """The reward against the baseline before this update moves it (not
    a gradient path)."""
    return reward - baseline


def _clip(ratio, eps: float):
    """PPO's clipped probability ratio."""
    return torch.clamp(ratio, 1 - eps, 1 + eps)


def _grad_step(optimizer, loss_fn, params, opt_state):
    """One Adam step on ``loss_fn(params)`` -> (params, opt_state, loss)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = []
    tree_map(leaves.append, live)
    loss = loss_fn(live)
    grads = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(grads), live)
    new_params, opt_state = optimizer.update(
        grads, opt_state, tree_map(torch.Tensor.detach, live))
    return new_params, opt_state, loss.detach()


def create_agent(generator: torch.Generator, *,
                 spec: MicroControllerSpec = MicroControllerSpec(),
                 algo: str = "reinforce", lr: float = 1e-4,
                 baseline_decay: float = 0.95, entropy_coef: float = 1e-4,
                 ppo_epochs: int = 4, ppo_clip: float = 0.2,
                 device="cuda") -> Agent:
    """An agent whose controller is initialized from ``generator`` (a
    CPU generator) on ``device``; the hyperparameters' names follow the
    reference's flags (--ctrl-lr, --ctrl-baseline-decay)."""
    from segtpu_torch.utils.helpers import resolve_device
    assert algo in ("reinforce", "ppo")
    dev = resolve_device(device)
    params = ctrl.controller_init(generator, spec, device=dev)
    optimizer = Adam(lr)
    state = AgentState(params, optimizer.init(params),
                       torch.zeros((), device=dev))

    def moved(state, reward):
        return baseline_decay * state.baseline + (1 - baseline_decay) * reward

    def reinforce_update(state: AgentState, actions, reward):
        adv = _advantage(reward, state.baseline)

        def loss_fn(params):
            logprobs, entropies = ctrl.evaluate(params, spec, actions)
            return (-torch.sum(logprobs) * adv
                    - entropy_coef * torch.sum(entropies))

        params, opt_state, loss = _grad_step(optimizer, loss_fn,
                                             state.params, state.opt_state)
        return AgentState(params, opt_state, moved(state, reward)), loss

    def ppo_epochs_of(state, loss_fn):
        params, opt_state = state.params, state.opt_state
        for _ in range(ppo_epochs):
            params, opt_state, loss = _grad_step(optimizer, loss_fn, params,
                                                 opt_state)
        return params, opt_state, loss

    def ppo_update(state: AgentState, actions, reward, old_logprobs):
        adv = _advantage(reward, state.baseline)
        old_sum = torch.sum(old_logprobs)

        def loss_fn(params):
            logprobs, entropies = ctrl.evaluate(params, spec, actions)
            ratio = torch.exp(torch.sum(logprobs) - old_sum)
            clipped = _clip(ratio, ppo_clip)
            return (-torch.minimum(ratio * adv, clipped * adv)
                    - entropy_coef * torch.sum(entropies))

        params, opt_state, loss = ppo_epochs_of(state, loss_fn)
        return AgentState(params, opt_state, moved(state, reward)), loss

    def reinforce_batch_update(state: AgentState, actions, rewards):
        """K sampled archs and their K rewards in one step: the mean of
        the K single-sample losses."""
        adv = _advantage(rewards, state.baseline)

        def loss_fn(params):
            logprobs, entropies = ctrl.evaluate(params, spec, actions)
            return (-torch.mean(torch.sum(logprobs, -1) * adv)
                    - entropy_coef * torch.mean(torch.sum(entropies, -1)))

        params, opt_state, loss = _grad_step(optimizer, loss_fn,
                                             state.params, state.opt_state)
        return AgentState(params, opt_state,
                          moved(state, torch.mean(rewards))), loss

    def ppo_batch_update(state: AgentState, actions, rewards, old_logprobs):
        adv = _advantage(rewards, state.baseline)
        old_sum = torch.sum(old_logprobs, -1)

        def loss_fn(params):
            logprobs, entropies = ctrl.evaluate(params, spec, actions)
            ratio = torch.exp(torch.sum(logprobs, -1) - old_sum)
            clipped = _clip(ratio, ppo_clip)
            return (-torch.mean(torch.minimum(ratio * adv, clipped * adv))
                    - entropy_coef * torch.mean(torch.sum(entropies, -1)))

        params, opt_state, loss = ppo_epochs_of(state, loss_fn)
        return AgentState(params, opt_state,
                          moved(state, torch.mean(rewards))), loss

    update_fn = reinforce_update if algo == "reinforce" else ppo_update
    batch_update_fn = (reinforce_batch_update if algo == "reinforce"
                       else ppo_batch_update)
    return Agent(spec, state, algo, update_fn, batch_update_fn)


def _device(agent: Agent) -> torch.device:
    return agent.state.params["embed"].device


def sample_genotype(agent: Agent, generator: torch.Generator):
    """-> (genotype, actions, logprobs, entropies), a micro or template
    genotype by the agent's spec (reference --ctrl-version cvpr/wacv);
    ``generator`` lies on the controller's device."""
    actions, logprobs, entropies = ctrl.sample(agent.state.params,
                                               agent.spec, generator)
    if isinstance(agent.spec, ctrl.TemplateControllerSpec):
        genotype = ctrl.template_genotype_from_actions(actions, agent.spec)
    else:
        genotype = ctrl.genotype_from_actions(actions, agent.spec)
    return genotype, actions, logprobs, entropies


def _f32(x, dev):
    return torch.as_tensor(x, dtype=torch.float32).to(dev)


def train_agent_batch(agent: Agent, actions_batch, rewards, *,
                      old_logprobs_batch=None) -> Agent:
    """One policy update from K (actions, reward) pairs (the fleet's)."""
    dev = _device(agent)
    actions_batch = torch.as_tensor(actions_batch).to(dev).long()
    rewards = _f32(rewards, dev)
    if agent.algo == "reinforce":
        new_state, _ = agent.batch_update_fn(agent.state, actions_batch,
                                             rewards)
    else:
        assert old_logprobs_batch is not None
        new_state, _ = agent.batch_update_fn(agent.state, actions_batch,
                                             rewards,
                                             _f32(old_logprobs_batch, dev))
    return agent._replace(state=new_state)


def train_agent(agent: Agent, actions, reward, *, old_logprobs=None) -> Agent:
    """One policy update from a scalar reward; returns the agent with its
    new state."""
    dev = _device(agent)
    reward = _f32(reward, dev)
    actions = torch.as_tensor(actions).to(dev).long()
    if agent.algo == "reinforce":
        new_state, _ = agent.update_fn(agent.state, actions, reward)
    else:
        assert old_logprobs is not None, "PPO needs the sampling logprobs"
        new_state, _ = agent.update_fn(agent.state, actions, reward,
                                       _f32(old_logprobs, dev))
    return agent._replace(state=new_state)
