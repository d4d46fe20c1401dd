from segtpu_torch.convert.from_jax import load_jax_params  # noqa: F401
