"""Plain f32 references of configurations the JAX package has no counterpart of (torch alone)."""
