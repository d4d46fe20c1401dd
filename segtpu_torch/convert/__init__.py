from segtpu_torch.convert.from_jax import load_jax_params  # noqa: F401
from segtpu_torch.convert.torch_import import (  # noqa: F401
    load_mbv2_checkpoint, load_mbv2_state_dict, load_segmenter_checkpoint,
    match_by_shape_order)
