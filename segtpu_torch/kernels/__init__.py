"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version. Importing this package builds nothing: a kernel is
compiled (``_build``) the first time a CUDA tensor reaches it."""

from segtpu_torch.kernels.front import (  # noqa: F401
    normalize_s2d_front, normalize_s2d_front_plain)
from segtpu_torch.kernels.upsample_argmax import (  # noqa: F401
    upsample_argmax, upsample_argmax_plain)
