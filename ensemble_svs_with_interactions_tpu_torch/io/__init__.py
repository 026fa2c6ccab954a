"""Label I/O (copy of the JAX package's jax-free ``io`` modules)."""
