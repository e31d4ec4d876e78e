"""Carry the reference's parameters over to the port.

``repro.models.init_params`` returns a pytree whose layer leaves are
stacked over a leading ``n_periods`` axis.  :func:`from_jax` takes that
tree as numpy arrays (``jax.tree.map(np.asarray, params)``; this module
itself never imports JAX) and returns the port's layout: one dict per
layer, in order, with every leaf a torch tensor on ``device``.  The LSQ
scales (``alpha_w``, ``alpha_a``) and the residual scales
(``alpha_r1``/``alpha_r2``, which the ``qat`` datapath's residual
re-quantization reads) come along with the weights.

:func:`tree_to_torch` carries any other numpy tree: an SC linear's QAT
dict (``w``, ``alpha_w``, ``alpha_a``), the paper's TNN (``w_in``,
``blocks``, ``w_out``) or an ``export_sc_linear`` dict (``w_int``,
``thresholds``, ``sum_max``, ``alpha_*``).
"""

from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .device import resolve_device

__all__ = ["from_jax", "to_torch", "tree_to_torch"]


def to_torch(a, device: torch.device) -> torch.Tensor:
    """One numpy array (bfloat16 included) -> a torch tensor on device."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _tree(obj, fn):
    if isinstance(obj, dict):
        return {k: _tree(v, fn) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree(v, fn) for v in obj]
    return fn(obj)


def tree_to_torch(tree, device: str | torch.device | None = None):
    """A tree of dicts and lists whose leaves are numpy arrays (or numpy
    scalars) -> the same tree of torch tensors on ``device``; Python
    numbers, strings and ``None`` stay as they are (an exported layer's
    ``alpha_a``, ``sum_max`` and ``alpha_out``)."""
    dev = resolve_device(device)

    def leaf(a):
        if isinstance(a, (np.ndarray, np.generic)):
            return to_torch(a, dev)
        return a
    return _tree(tree, leaf)


def from_jax(params_np: dict, cfg: ModelConfig,
             device: str | torch.device | None = None) -> dict:
    """The reference's parameter tree (as numpy) -> the port's."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_periods):
        for j in range(len(cfg.period)):
            layers.append(_tree(params_np["periods"][f"p{j}"],
                                lambda a: to_torch(np.asarray(a)[i], dev)))
    def conv(a):
        return to_torch(a, dev)
    return {"embed": _tree(params_np["embed"], conv),
            "layers": layers,
            "final_norm": _tree(params_np["final_norm"], conv),
            "lm_head": _tree(params_np["lm_head"], conv)}
