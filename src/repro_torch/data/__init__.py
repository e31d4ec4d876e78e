"""Data: stateless seeded synthetic streams (batch = f(seed, step))."""

from .synthetic import SyntheticLM, host_batch

__all__ = ["SyntheticLM", "host_batch"]
