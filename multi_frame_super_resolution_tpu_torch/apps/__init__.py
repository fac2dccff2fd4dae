"""Command-line apps of the port (counterparts of the JAX package's apps/)."""
