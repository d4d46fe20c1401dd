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
  ``stem_s2d_kernel``.

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
            if key.rsplit(".", 1)[-1] == "w":
                if arr.ndim != 4:
                    raise ValueError(f"{key}: conv kernel must be 4-D HWIO, "
                                     f"got shape {arr.shape}")
                arr = np.transpose(arr, (3, 2, 0, 1))        # HWIO -> OIHW
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
        if key.rsplit(".", 1)[-1] == "w":
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
