"""Data: stateless seeded synthetic streams (batch = f(seed, step))."""

from .synthetic import SyntheticClassification, SyntheticLM, host_batch

__all__ = ["SyntheticLM", "SyntheticClassification", "host_batch"]
