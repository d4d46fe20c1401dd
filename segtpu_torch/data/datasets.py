"""Datasets and loaders (counterpart: segtpu/data/datasets.py).

``SegmentationDataset`` reads a ``.lst`` manifest of "img_path
mask_path" pairs (masks are uint8 class-index images, 255 = ignore);
``create_loaders`` splits a dataset into meta-train and meta-val by
``meta_train_prct``. ``BatchLoader`` gives fixed-shape numpy batches
(pad and crop on the host) from a background thread, as the JAX
package's does; a step moves them to the card
(``engine.trainer.images_to``). For the same dataset and seed the
batches are byte for byte the JAX package's: the same numpy generators
(``default_rng(seed + epoch)``, ``create_loaders``' permutation) drive
the same transforms.

Images decode from ``.npy`` with numpy, else with the native library
(``native_io``) or, where it is absent, with PIL; where neither loads,
reading a non-``.npy`` file raises.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from segtpu_torch.data import native_io
from segtpu_torch.data.label_maps import LABEL_MAPS
from segtpu_torch.data.transforms import (
    Compose, Normalise, Pad, RandomCrop, RandomMirror, ResizeShorterScale)
from segtpu_torch.utils.metrics import IGNORE_LABEL


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"cannot decode images here: the native IO library "
            f"({native_io._LIB_PATH}, make -C native) is not loadable and "
            f"PIL is not installed; use .npy files") from None
    return Image


def _read_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if native_io.available():  # C++ GIL-free decode (native/segtpu_io.cc)
        return native_io.decode_image(path)
    img = _pil_image().open(path)
    img = img.convert("RGB") if img.mode != "L" else img
    return np.asarray(img)


def _read_mask(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if native_io.available():
        return native_io.decode_image(path)  # palette index = class id
    return np.asarray(_pil_image().open(path))


class SegmentationDataset:
    """``.lst`` manifest dataset. ``label_map``: None (masks already in
    train ids) or a dataset name of ``label_maps.LABEL_MAPS``."""

    def __init__(self, data_root: str, list_path: str,
                 transform: Optional[Callable] = None,
                 label_map: Optional[str] = None):
        self.data_root = data_root
        self.transform = transform
        self.label_map = LABEL_MAPS[label_map]
        self.pairs: List[Tuple[str, str]] = []
        with open(list_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    self.pairs.append((parts[0], parts[1]))

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        img_p, msk_p = self.pairs[i]
        mask = _read_mask(os.path.join(self.data_root, msk_p)).astype(np.uint8)
        return {"image": _read_image(os.path.join(self.data_root, img_p)),
                "mask": self.label_map(mask)}


class SyntheticDataset:
    """Random image/mask pairs from ``np.random.RandomState(seed)``: the
    stand-in where no dataset is at hand."""

    def __init__(self, n: int = 16, hw: Tuple[int, int] = (64, 64),
                 num_classes: int = 5, seed: int = 0):
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, size=(n, *hw, 3), dtype=np.uint8)
        self.masks = rng.randint(0, num_classes, size=(n, *hw)).astype(np.uint8)
        self.transform = None

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return {"image": self.images[i], "mask": self.masks[i]}


class BatchLoader:
    """Fixed-shape batches with background prefetch.

    Yields {'image': f32 [N,H,W,3] normalized (or uint8 without
    ``normalise_on_host``), 'label': int32 [N,H,W]} numpy batches. Each
    pass draws from ``np.random.default_rng(seed + epoch)``. Training
    drops the ragged tail; evaluation keeps it, repeating its last
    sample with an all-ignore mask to fill the batch."""

    def __init__(self, dataset, *, batch_size: int, crop: Tuple[int, int],
                 train: bool, shorter_side: Optional[int] = None,
                 normalise_on_host: bool = True, seed: int = 0,
                 prefetch: int = 2, indices: Optional[Sequence[int]] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.crop = crop
        self.train = train
        self.seed = seed
        self.prefetch = prefetch
        self.indices = list(indices if indices is not None
                            else range(len(dataset)))
        ts = []
        if train:
            if shorter_side:
                ts.append(ResizeShorterScale(shorter_side))
            ts += [Pad(crop), RandomCrop(crop), RandomMirror()]
        else:
            ts.append(Pad(crop))
        if normalise_on_host:
            ts.append(Normalise())
        self.transform = Compose(ts)
        self._epoch = 0

    def __len__(self):
        return len(self.indices) // self.batch_size if self.train else \
            -(-len(self.indices) // self.batch_size)

    def _make_batches(self, rng: np.random.Generator):
        order = np.array(self.indices)
        if self.train:
            rng.shuffle(order)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs]
            n_valid = len(idx)
            if n_valid < bs:  # eval tail: repeat the last sample
                idx = np.concatenate([idx, np.repeat(idx[-1], bs - n_valid)])
            imgs, msks = [], []
            ch, cw = self.crop
            for k, i in enumerate(idx):
                s = self.transform(self.dataset[int(i)], rng)
                imgs.append(np.ascontiguousarray(s["image"][:ch, :cw]))
                msk = np.ascontiguousarray(s["mask"][:ch, :cw])
                if k >= n_valid:
                    # a repeat is all-ignore: every image counts once in
                    # the confusion matrix and the loss
                    msk = np.full_like(msk, IGNORE_LABEL)
                msks.append(msk)
            yield {"image": np.stack(imgs),
                   "label": np.stack(msks).astype(np.int32)}

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        self._epoch += 1
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for batch in self._make_batches(rng):
                    q.put(batch)
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item


def create_loaders(dataset, *, batch_size: int, crop: Tuple[int, int],
                   meta_train_prct: float = 0.9, shorter_side=None,
                   seed: int = 0, normalise_on_host: bool = True):
    """Meta-train and meta-val loaders of the search's proxy task."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = max(int(n * meta_train_prct), 1)
    train = BatchLoader(dataset, batch_size=batch_size, crop=crop,
                        train=True, shorter_side=shorter_side, seed=seed,
                        normalise_on_host=normalise_on_host,
                        indices=perm[:n_train])
    val = BatchLoader(dataset, batch_size=batch_size, crop=crop,
                      train=False, seed=seed,
                      normalise_on_host=normalise_on_host,
                      indices=perm[n_train:] if n_train < n else perm[:1])
    return train, val
