"""Shared constants (counterpart: segtpu/utils/helpers.py)."""

from __future__ import annotations

import numpy as np

# prepare_img constants — ImageNet stats with 1/255 scaling, as float32
# exactly as the JAX package holds them
IMG_SCALE = 1.0 / 255.0
IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resolve_device(device) -> "torch.device":
    """The device an entry point runs on. ``"cuda"`` (the default of
    every entry point) raises when no card is present: the port never
    falls back to the CPU unless the caller asks for it."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "segtpu_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return dev
