"""Weights and checkpoints: the bridge to the JAX parameter layout."""
