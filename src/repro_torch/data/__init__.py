"""Data: stateless seeded synthetic streams (batch = f(seed, step))."""

from .synthetic import SyntheticLM

__all__ = ["SyntheticLM"]
