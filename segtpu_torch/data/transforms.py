"""Data transforms (counterpart: segtpu/data/transforms.py): Pad,
RandomCrop, RandomMirror, ResizeShorterScale, Normalise.

Geometric augmentation and the optional host-side normalization stay in
numpy on the host, as in the JAX package, and draw from an explicit
``np.random.Generator``: for the same generator state they give the
same bytes as the JAX package's transforms. Each transform is a
callable on a sample dict {'image': HWC uint8/float, 'mask': HW uint8}.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from segtpu_torch.core.resize import _interp_matrix
from segtpu_torch.utils.helpers import IMG_MEAN, IMG_SCALE, IMG_STD
from segtpu_torch.utils.metrics import IGNORE_LABEL


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class Pad:
    """Pad the image (default value: the per-channel image mean in pixel
    units, ~0 after Normalise) and the mask (the ignore label) to at
    least ``size``."""

    def __init__(self, size: Tuple[int, int], img_val=None,
                 msk_val: int = IGNORE_LABEL):
        self.size = size
        # IMG_MEAN is in normalized units; / IMG_SCALE gives pixel units
        # (~[123.7, 116.3, 103.5]), right for raw uint8 and float images
        self.img_val = (np.asarray(IMG_MEAN) / IMG_SCALE
                        if img_val is None else np.asarray(img_val))
        self.msk_val = msk_val

    def __call__(self, sample, rng=None):
        img, msk = sample["image"], sample["mask"]
        h, w = img.shape[:2]
        ph, pw = max(self.size[0] - h, 0), max(self.size[1] - w, 0)
        if ph or pw:
            val = self.img_val
            if img.ndim == 2:
                val = np.mean(val)
            out = np.empty((h + ph, w + pw) + img.shape[2:], img.dtype)
            out[:] = (np.round(val) if np.issubdtype(img.dtype, np.integer)
                      else val)
            out[:h, :w] = img
            img = out
            msk = np.pad(msk, ((0, ph), (0, pw)),
                         constant_values=self.msk_val)
        return {**sample, "image": img, "mask": msk}


class RandomCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, sample, rng):
        img, msk = sample["image"], sample["mask"]
        h, w = img.shape[:2]
        ch, cw = self.size
        assert h >= ch and w >= cw, "Pad before RandomCrop"
        top = int(rng.integers(0, h - ch + 1))
        left = int(rng.integers(0, w - cw + 1))
        return {**sample,
                "image": img[top:top + ch, left:left + cw],
                "mask": msk[top:top + ch, left:left + cw]}


class RandomMirror:
    def __call__(self, sample, rng):
        if rng.random() < 0.5:
            return {**sample,
                    "image": sample["image"][:, ::-1],
                    "mask": sample["mask"][:, ::-1]}
        return sample


class ResizeShorterScale:
    """Scale jitter: resize so that the shorter side lands in
    [shorter_side * low, shorter_side * high]; nearest for masks,
    bilinear for images."""

    def __init__(self, shorter_side: int, low: float = 0.5,
                 high: float = 2.0):
        self.shorter_side = shorter_side
        self.low = low
        self.high = high

    def __call__(self, sample, rng):
        img, msk = sample["image"], sample["mask"]
        h, w = img.shape[:2]
        scale = rng.uniform(self.low, self.high)
        target = self.shorter_side * scale
        factor = target / min(h, w)
        nh, nw = max(int(round(h * factor)), 1), max(int(round(w * factor)), 1)
        return {**sample,
                "image": _resize_img(img, (nh, nw)),
                "mask": _resize_nearest(msk, (nh, nw))}


class Normalise:
    """(x * scale - mean) / std as float32: the host-side pipeline's
    normalization (the served engine normalizes on the card)."""

    def __init__(self, scale: float = IMG_SCALE, mean=IMG_MEAN, std=IMG_STD):
        self.scale, self.mean, self.std = scale, np.asarray(mean), np.asarray(std)

    def __call__(self, sample, rng=None):
        img = sample["image"].astype(np.float32)
        img = (img * self.scale - self.mean) / self.std
        return {**sample, "image": img.astype(np.float32)}


def _resize_nearest(x: np.ndarray, out_hw) -> np.ndarray:
    h, w = x.shape[:2]
    oh, ow = out_hw
    # cv2-compatible nearest: src = floor(dst * in / out)
    ri = np.minimum((np.arange(oh) * (h / oh)).astype(np.int64), h - 1)
    ci = np.minimum((np.arange(ow) * (w / ow)).astype(np.int64), w - 1)
    return x[ri][:, ci]


def _resize_img(x: np.ndarray, out_hw) -> np.ndarray:
    """Bilinear (half-pixel, cv2 INTER_LINEAR semantics) in numpy, by the
    two interpolation matrices of ``core.resize``."""
    h, w = x.shape[:2]
    oh, ow = out_hw
    ah = _interp_matrix(h, oh, False)
    aw = _interp_matrix(w, ow, False)
    y = x.astype(np.float32)
    squeeze = y.ndim == 2
    if squeeze:
        y = y[..., None]
    y = np.einsum("oi,iwc->owc", ah, y)
    y = np.einsum("pj,ojc->opc", aw, y)
    if squeeze:
        y = y[..., 0]
    if np.issubdtype(x.dtype, np.integer):
        y = np.clip(np.rint(y), np.iinfo(x.dtype).min,
                    np.iinfo(x.dtype).max).astype(x.dtype)
    return y
