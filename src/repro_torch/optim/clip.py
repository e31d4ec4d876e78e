"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in float32."""
    sums = [torch.sum(torch.square(leaf.to(torch.float32)))
            for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` by ``min(1, max_norm / (norm + 1e-9))``; returns
    (clipped grads in their own dtypes, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
