"""Checkpoints (counterpart: segtpu/utils/saver.py).

A pytree (nested dicts and lists of arrays or tensors) is saved as one
``.npz`` whose keys are its paths joined by "/", the JAX package's
format: ``params/encoder/blocks/3/dw/w``. With the trees of
``segtpu_torch.convert.to_jax_params`` a checkpoint of the port loads in
``segtpu.train.load_trained`` and one of the JAX package in the port's
``segtpu_torch.train.load_trained``.

``SearchSaver`` keeps a search's records and snapshots in the JAX
package's files (``search_log.jsonl``, ``search_state.json``,
``controller.npz`` keyed ``embed``, ``lstm/wx``, ...), so a search
snapshot of either package resumes in the other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

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


def load_pytree_like(path: str, template):
    """An ``.npz`` of ``save_pytree`` in the structure of ``template``, a
    nested dict of tensors: each leaf a tensor of its template leaf's
    shape, dtype and device."""
    with np.load(path) as data:
        def leaf(t, key):
            arr = data[key]
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, the "
                                 f"template's is {tuple(t.shape)}")
            return torch.from_numpy(np.array(arr)).to(t.device, t.dtype)

        def walk(t, prefix):
            if isinstance(t, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                        for k, v in t.items()}
            return leaf(t, prefix)

        return walk(template, "")


class SearchSaver:
    """A search's records (``search_log.jsonl``), its best genotypes and
    its snapshots: the controller's parameters (``controller.npz``) with
    the step, baseline and history (``search_state.json``)."""

    def __init__(self, snapshot_dir: str, keep_top: int = 5):
        self.dir = snapshot_dir
        self.keep_top = keep_top
        os.makedirs(snapshot_dir, exist_ok=True)
        self.history: List[Dict[str, Any]] = []

    @property
    def _meta_path(self):
        return os.path.join(self.dir, "search_state.json")

    def record(self, step: int, genotype, reward: float, extra=None):
        self.history.append({"step": step, "genotype": genotype,
                             "reward": float(reward), **(extra or {})})
        with open(os.path.join(self.dir, "search_log.jsonl"), "a") as f:
            f.write(json.dumps(self.history[-1]) + "\n")

    def best(self, k: Optional[int] = None):
        k = k or self.keep_top
        return sorted(self.history, key=lambda r: -r["reward"])[:k]

    def save(self, step: int, controller_params, baseline: float):
        save_pytree(os.path.join(self.dir, "controller.npz"),
                    controller_params)
        with open(self._meta_path, "w") as f:
            json.dump({"step": step, "baseline": float(baseline),
                       "history": self.history, "best": self.best()}, f)

    def load(self, controller_template):
        """-> (step, controller parameters like ``controller_template``,
        baseline), or None where there is no snapshot."""
        if not os.path.exists(self._meta_path):
            return None
        with open(self._meta_path) as f:
            meta = json.load(f)
        params = load_pytree_like(os.path.join(self.dir, "controller.npz"),
                                  controller_template)
        self.history = meta["history"]
        return meta["step"], params, meta["baseline"]
