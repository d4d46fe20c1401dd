"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version. Importing this package builds nothing: a kernel is
compiled (``_build``) the first time a CUDA tensor reaches it."""

from segtpu_torch.kernels.chw_ops import (  # noqa: F401
    cell_op_chw, cell_op_chw_plain, conv_chw, conv_chw_plain, fold_bn,
    inv_res_chw, inv_res_chw_plain, inv_res_s2_chw, inv_res_s2_chw_plain,
    pair_op_chw, pair_op_chw_plain, pw_chain_chw, pw_chain_chw_plain,
    pw_multi_chw, pw_multi_chw_plain, sep_conv_chw, sep_conv_chw_plain)
from segtpu_torch.kernels.front import (  # noqa: F401
    normalize_s2d_front, normalize_s2d_front_plain)
from segtpu_torch.kernels.resize_chw import (  # noqa: F401
    resize_chw, resize_chw_plain, shard_interp_bands)
from segtpu_torch.kernels.upsample_argmax import (  # noqa: F401
    upsample_argmax, upsample_argmax_flat, upsample_argmax_flat_plain,
    upsample_argmax_plain, upsample_argmax_sharded,
    upsample_argmax_sharded_plain)
