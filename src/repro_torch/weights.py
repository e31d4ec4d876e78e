"""Carry the reference's parameters (and training state) over to the port.

``repro.models.init_params`` returns a pytree whose layer leaves are
stacked over a leading ``n_periods`` axis.  :func:`from_jax` takes that
tree as numpy arrays (``jax.tree.map(np.asarray, params)``; this module
itself never imports JAX) and returns the port's layout: one dict per
layer, in order, with every leaf a torch tensor on ``device``.  The LSQ
scales (``alpha_w``, ``alpha_a``) and the residual scales
(``alpha_r1``/``alpha_r2``, which the ``qat`` datapath's residual
re-quantization reads) come along with the weights, and so do the
recurrent mixers' nested leaves (rwkv6's ``maa`` (5, d), ``tm_w2`` (5,
lora, d), ``ln_x``; mamba's ``a_log`` (d_inner, d_state)).  Given the
reference's ``TrainState`` instead (as numpy, the same way), it returns
the port's :class:`~repro_torch.train.step.TrainState`: the parameters,
AdamW's ``m`` / ``v`` in the same layout, ``count`` and ``step``.
:func:`cache_from_jax` carries the reference's paged serving cache the
same way (page pools and per-slot state rows), and
:func:`dense_cache_from_jax` its dense cache (``init_cache`` /
``prefill`` output: ``pos`` and each layer's K / V or state), so that a
decode can continue from the reference's own state.  Given a serving mesh's rules (``mesh=``),
:func:`from_jax` and :func:`cache_from_jax` return this rank's block of
the parameters or of the cache, in the serving layout
(``models.param_specs`` / ``paged_cache_specs``).  A compressed
``TrainState`` brings its error state along (None where the reference's
leaf has none).

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
from .distributed.sharding import MeshRules, shard_tree
from .tree import tree_map

__all__ = ["from_jax", "cache_from_jax", "dense_cache_from_jax", "to_torch",
           "tree_to_torch"]


def to_torch(a, device: torch.device) -> torch.Tensor:
    """One numpy array (bfloat16 included) -> a torch tensor on device."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


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
    return tree_map(leaf, tree)


def _unstack(periods_np: dict, cfg: ModelConfig, dev: torch.device) -> list:
    """``{"p{j}": tree with leaves (n_periods, ...)}`` -> one tree a
    layer, in order."""
    layers = []
    for i in range(cfg.n_periods):
        for j in range(len(cfg.period)):
            layers.append(tree_map(lambda a: to_torch(np.asarray(a)[i], dev),
                                   periods_np[f"p{j}"]))
    return layers


def _params(params_np: dict, cfg: ModelConfig, dev: torch.device) -> dict:
    layers = _unstack(params_np["periods"], cfg, dev)

    def conv(a):
        return to_torch(a, dev)
    out = {"embed": tree_map(conv, params_np["embed"]),
           "layers": layers,
           "final_norm": tree_map(conv, params_np["final_norm"]),
           "lm_head": tree_map(conv, params_np["lm_head"])}
    if "frontend" in params_np:         # a vision / audio stub's projections
        out["frontend"] = tree_map(conv, params_np["frontend"])
    return out


def from_jax(tree_np, cfg: ModelConfig,
             device: str | torch.device | None = None, *,
             mesh: MeshRules | None = None):
    """The reference's parameter tree, or its ``TrainState``, as numpy ->
    the port's; with ``mesh``, this rank's block of the parameters."""
    dev = resolve_device(device)
    if not hasattr(tree_np, "opt"):
        params = _params(tree_np, cfg, dev)
        if mesh is None:
            return params
        from .models import param_specs
        return shard_tree(params, param_specs(cfg), mesh)
    if mesh is not None:
        raise ValueError("a TrainState has no serving layout: call "
                         "from_jax without mesh=")
    from .train.step import TrainState
    opt = tree_np.opt
    error = getattr(tree_np, "error", None)
    return TrainState(
        params=_params(tree_np.params, cfg, dev),
        opt={"m": _params(opt["m"], cfg, dev),
             "v": _params(opt["v"], cfg, dev),
             "count": to_torch(opt["count"], dev)},
        step=to_torch(tree_np.step, dev),
        error=None if error is None else _params(error, cfg, dev))


def cache_from_jax(cache_np: dict, cfg: ModelConfig,
                   device: str | torch.device | None = None, *,
                   mesh: MeshRules | None = None) -> dict:
    """The reference's paged cache (``init_paged_cache`` / the serving
    steps' output) as numpy -> the port's: one entry a layer, each with
    its attention pools or its per-slot state rows (``max_slots + 1``
    rows), in the reference's nesting (rwkv's ``cmix: {"shift"}``); with
    ``mesh``, this rank's block of it."""
    cache = {"layers": _unstack(cache_np["periods"], cfg,
                                resolve_device(device))}
    if mesh is None:
        return cache
    from .models import paged_cache_specs
    keys = {k for e in cache["layers"] for k in e}
    fmt = "sc" if "k_resid" in keys else "int8" if "k_scale" in keys \
        else "fp"
    return shard_tree(cache, paged_cache_specs(cfg, fmt), mesh, logical=True)


def dense_cache_from_jax(cache_np: dict, cfg: ModelConfig,
                         device: str | torch.device | None = None) -> dict:
    """The reference's dense cache (``init_cache`` / ``prefill`` /
    ``decode_step`` output) as numpy -> the port's: ``pos`` as a 0-d int32
    tensor and one entry a layer (``k`` / ``v`` (B, T, Hkv, Dh), or the
    recurrent state of B rows)."""
    dev = resolve_device(device)
    return {"pos": to_torch(np.asarray(cache_np["pos"], np.int32), dev),
            "layers": _unstack(cache_np["periods"], cfg, dev)}
