"""segtpu_torch — the PyTorch/CUDA port of ``segtpu`` for NVIDIA Hopper.

Mirrors ``segtpu``'s module layout. Plain tensor code is PyTorch (NCHW);
the TPU's Pallas kernels become hand-written CUDA kernels under
``segtpu_torch/csrc``, built on first use (``segtpu_torch.kernels._build``).
Importing this package touches neither CUDA nor a compiler.
"""
