"""Checkpoint I/O shared with the JAX package."""
