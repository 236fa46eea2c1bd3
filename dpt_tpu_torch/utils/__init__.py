"""Image I/O, metrics and state conversion from the JAX package."""
