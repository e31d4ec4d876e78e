"""Global-norm gradient clipping (port of ``repro.optim.clip``).

Under a training mesh a rank holds blocks of the gradients: the sum of
squares adds each leaf's blocks over the axes the leaf is cut on and
counts a leaf replicated over an axis once.
"""

from __future__ import annotations

import torch

from ..distributed.sharding import _names, psum
from ..tree import tree_leaves, tree_map

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree, specs=None) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every leaf, in float32; ``specs`` (a
    spec a leaf, in ``tree_leaves`` order) names the mesh axes each
    leaf's blocks are cut over."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(leaf.to(torch.float32)))
            for leaf in leaves]
    if specs is None:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    groups: dict[tuple, list] = {}
    for s, spec in zip(sums, specs):
        axes = tuple(a for ax in spec for a in _names(ax))
        groups.setdefault(axes, []).append(s)
    parts = [psum(torch.sum(torch.stack(v)), axes)
             for axes, v in groups.items()]
    return torch.sqrt(torch.sum(torch.stack(parts)))


def clip_by_global_norm(grads, max_norm: float, specs=None):
    """Scale ``grads`` by ``min(1, max_norm / (norm + 1e-9))``; returns
    (clipped grads in their own dtypes, the norm before clipping)."""
    norm = global_norm(grads, specs)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), norm
