"""Checkpoints (counterpart: segtpu/utils/saver.py).

A pytree (nested dicts and lists of arrays or tensors) is saved as one
``.npz`` whose keys are its paths joined by "/", the JAX package's
format: ``params/encoder/blocks/3/dw/w``. With the trees of
``segtpu_torch.convert.to_jax_params`` a checkpoint of the port loads in
``segtpu.train.load_trained`` and one of the JAX package in the port's
``segtpu_torch.train.load_trained``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().cpu().numpy()
        out[prefix] = np.asarray(tree)
        return
    for k, v in items:
        _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)


def save_pytree(path: str, tree) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    np.savez(path, **flat)


def load_pytree(path: str) -> dict:
    """An ``.npz`` of ``save_pytree`` as nested dicts keyed by the path's
    parts (a list's indices as strings), numpy leaves."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parts, leaf = key.split("/")
            node = tree
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
