"""Carry the JAX package's weights into the port.

``load_jax_params(model, params, stats)`` takes the ``segmenter_init``
pytrees as numpy (nested dicts and lists, e.g. after
``jax.tree.map(np.asarray, ...)``) and fills a ``segtpu_torch``
``Segmenter``. The port's modules mirror the pytrees leaf for leaf, so
a pytree path ``encoder.blocks.3.dw.w`` is the state-dict key of the
same name:

* conv kernels ``w`` go from HWIO to OIHW (a depthwise [kh, kw, 1, C]
  becomes [C, 1, kh, kw] by the same permutation);
* BatchNorm ``scale``/``bias`` and ``mean``/``var`` and the
  classifier bias ``b`` are copied;
* the stem keeps its 3x3 kernel; the port derives its own
  ``stem_s2d_kernel``;
* the masked supernet's per-slot classifier ``clf.w`` [pool_max,
  agg_size, K] is the same in both packages and is copied as it is, so
  a ``supernet_init`` (params, stats) loads into ``supernet.Supernet``.

Any missing, extra or mis-shaped leaf raises. No JAX import.

``to_jax_params(model)`` is the way back: the model's parameters and
buffers as numpy pytrees in ``segmenter_init``'s layout (nested dicts,
lists where the keys are indices, conv kernels OIHW -> HWIO);
``to_jax_tree`` does the same for any name -> tensor mapping, such as
gradients or Polyak averages.

``load_jax_controller(params)`` carries the search controller's
``controller_init`` tree (numpy) into the port's controller tree of f32
tensors, names and shapes as they are (its matrices are products'
operands, not conv kernels); ``controller_to_jax`` is the way back.

``load_jax_population(pop)`` turns a JAX supernet ``PopState`` (every
leaf K-stacked) into the port's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = np.asarray(tree)
        return
    for k, v in items:
        _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)


def _to_port(key: str, arr: np.ndarray, stacked: bool = False):
    """One JAX leaf in the port's layout: a conv kernel ``w`` HWIO ->
    OIHW; the supernet's per-slot classifier ``clf.w`` [pool_max, C, K]
    as it is. ``stacked``: the leaf has a leading population axis."""
    if key.rsplit(".", 1)[-1] != "w":
        return arr
    lead = 1 if stacked else 0
    if key == "clf.w" and arr.ndim == 3 + lead:
        return arr
    if arr.ndim != 4 + lead:
        raise ValueError(f"{key}: conv kernel must be 4-D HWIO, got shape "
                         f"{arr.shape}")
    perm = (3, 2, 0, 1)                                      # HWIO -> OIHW
    return np.transpose(arr, (0,) + tuple(p + 1 for p in perm)
                        if stacked else perm)


def load_jax_params(model: torch.nn.Module, params, stats) -> torch.nn.Module:
    """Copy JAX ``params``/``stats`` into ``model`` in place; returns it."""
    leaves: Dict[str, np.ndarray] = {}
    _flatten(params, "", leaves)
    stat_leaves: Dict[str, np.ndarray] = {}
    _flatten(stats, "", stat_leaves)
    clash = leaves.keys() & stat_leaves.keys()
    if clash:
        raise ValueError(f"leaves in both params and stats: {sorted(clash)}")
    leaves.update(stat_leaves)

    state = model.state_dict()
    missing = sorted(state.keys() - leaves.keys())
    extra = sorted(leaves.keys() - state.keys())
    if missing or extra:
        raise ValueError(f"JAX pytree does not match the model: missing "
                         f"{missing[:8]} ({len(missing)}), extra "
                         f"{extra[:8]} ({len(extra)})")
    with torch.no_grad():
        for key, arr in leaves.items():
            arr = _to_port(key, arr)
            dst = state[key]
            if tuple(arr.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(arr.shape)} does not "
                                 f"match the model's {tuple(dst.shape)}")
            dst.copy_(torch.tensor(arr, dtype=torch.float32))
    return model


def _listify(tree):
    """Nested dicts whose keys are all indices 0..n-1 become lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        idx = sorted(out, key=int)
        if [int(k) for k in idx] == list(range(len(idx))):
            return [out[k] for k in idx]
    return out


def to_jax_tree(named: Mapping[str, torch.Tensor]):
    """``{"encoder.blocks.3.dw.w": tensor, ...}`` -> the numpy pytree of
    the same paths, conv kernels ``w`` OIHW -> HWIO."""
    tree: dict = {}
    for key, t in named.items():
        arr = np.array(t.detach().float().cpu())      # a copy, never a view
        if key.rsplit(".", 1)[-1] == "w" and arr.ndim == 4:
            arr = np.transpose(arr, (2, 3, 1, 0))            # OIHW -> HWIO
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return _listify(tree)


def to_jax_params(model: torch.nn.Module):
    """(params, stats) of ``model`` as numpy pytrees in the JAX package's
    layout: its parameters, and its BatchNorm running stats."""
    return (to_jax_tree(dict(model.named_parameters())),
            to_jax_tree(dict(model.named_buffers())))


_CONTROLLER_KEYS = {"embed": None, "slot_embed": None,
                    "lstm": ["b", "wh", "wx"], "head": ["b", "w"]}


def load_jax_controller(params, *, device="cpu"):
    """A JAX controller tree (``embed``, ``slot_embed``, ``lstm.{wx,wh,b}``,
    ``head.{w,b}``; numpy leaves) -> the port's tree of f32 tensors on
    ``device``. A missing or extra leaf raises."""
    keys = {k: sorted(v) if isinstance(v, dict) else None
            for k, v in params.items()}
    if keys != _CONTROLLER_KEYS:
        raise ValueError(f"controller tree {keys}, expected "
                         f"{_CONTROLLER_KEYS}")

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.tensor(np.asarray(tree), dtype=torch.float32,
                            device=device)

    return tensors(params)


def controller_to_jax(params):
    """The port's controller tree -> numpy, in the JAX package's layout."""
    if isinstance(params, dict):
        return {k: controller_to_jax(v) for k, v in params.items()}
    return np.array(params.detach().float().cpu())


def _stacked(tree, device) -> Dict[str, torch.Tensor]:
    leaves: Dict[str, np.ndarray] = {}
    _flatten(tree, "", leaves)
    return {k: torch.tensor(_to_port(k, v, stacked=True),
                            dtype=torch.float32, device=device)
            for k, v in leaves.items()}


def _momentum_trace(opt_state):
    """The ``trace`` tree of optax's momentum state inside a (nested)
    chain state, found by its field name; None without momentum."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    if isinstance(opt_state, (list, tuple)):
        for s in opt_state:
            t = _momentum_trace(s)
            if t is not None:
                return t
    return None


def load_jax_population(pop, *, device="cpu"):
    """A JAX supernet ``PopState`` (K-stacked ``params``/``stats``, an
    optax chain state with a momentum trace, ``polyak`` or None, the
    shared ``step``; leaves numpy or arrays) -> the port's
    ``segtpu_torch.supernet.PopState`` on ``device``: the same leaves by
    state-dict name, conv kernels [K, kh, kw, cin, cout] -> [K, cout,
    cin, kh, kw]. A chain without momentum gives zero traces."""
    from segtpu_torch.supernet import PopState
    params = _stacked(pop.params, device)
    trace = _momentum_trace(pop.opt_state)
    return PopState(
        params, _stacked(pop.stats, device),
        _stacked(trace, device) if trace is not None
        else {k: torch.zeros_like(v) for k, v in params.items()},
        None if pop.polyak is None else _stacked(pop.polyak, device),
        int(np.asarray(pop.step)))
