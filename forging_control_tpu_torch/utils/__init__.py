"""Utilities: checkpoints in the JAX package's npz format."""
