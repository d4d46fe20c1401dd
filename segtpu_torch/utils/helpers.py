"""Shared helpers (counterpart: segtpu/utils/helpers.py)."""

from __future__ import annotations

import contextlib
import os

import numpy as np

# prepare_img constants — ImageNet stats with 1/255 scaling, as float32
# exactly as the JAX package holds them
IMG_SCALE = 1.0 / 255.0
IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)

# cuBLAS's workspace as deterministic algorithms need it; PyTorch sizes the
# workspace when cuBLAS first runs in a process, so the CLI sets it first
CUBLAS_WORKSPACE = ":4096:8"


def prepare_img(img):
    """uint8 RGB HWC -> normalized float32 (host-side, numpy), the
    arithmetic the serving front runs on the card."""
    return ((img.astype(np.float32) * IMG_SCALE) - IMG_MEAN) / IMG_STD


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def compute_params(params) -> int:
    """Total parameter count of a module or of a name -> tensor mapping."""
    tensors = (params.parameters() if hasattr(params, "parameters")
               else params.values())
    return sum(t.numel() for t in tensors)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (``torch.use_deterministic_algorithms``
    and cuDNN's), both restored after: the search's proxy training on
    the card is then bit-reproducible from its seed, as the JAX
    package's is. ``CUBLAS_WORKSPACE_CONFIG`` is set to
    ``CUBLAS_WORKSPACE`` unless the caller set it; it sizes cuBLAS's
    workspace only where cuBLAS has not run yet in the process."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic = saved[2]


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
