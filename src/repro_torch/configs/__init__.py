"""Architecture configurations (plain data, copied from the JAX package)."""
