"""Checkpoints: the port of the JAX package's ``repro/checkpoint``."""
