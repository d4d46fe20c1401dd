from segtpu_torch.convert.from_jax import (  # noqa: F401
    controller_to_jax, load_jax_controller, load_jax_params,
    load_jax_population, to_jax_params, to_jax_tree)
from segtpu_torch.convert.torch_import import (  # noqa: F401
    load_mbv2_checkpoint, load_mbv2_state_dict, load_segmenter_checkpoint,
    match_by_shape_order)
