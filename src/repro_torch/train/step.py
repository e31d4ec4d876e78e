"""The train step: loss -> grads -> clip -> (compress) -> AdamW.

Port of ``repro.train.step``.  Gradients come from ``torch.autograd``
through the port's loss (the flash kernel forward, the LSQ gradient);
with ``grad_accum > 1`` the batch is cut into that many microbatches
along its first axis and their gradients are summed in float32, as the
reference's scan does.  The step updates the state in place (the
reference's launcher donates it; see ``optim/adamw.py``) and returns it.

Weight decay follows the reference's rule as it acts on the reference's
layout: ``p.ndim >= 2`` there counts the leading axis that stacks the
layers, so every per-layer leaf of two or more entries per layer decays,
norm scales and per-channel ``alpha_w`` included, while the final norm
and the per-layer scalars do not (:func:`decay_mask`).

With ``grad_compress`` the clipped gradients go through the int8
error-feedback round trip (``distributed.compression``) before AdamW,
the residual carried in ``TrainState.error``.  One scale covers a leaf
of every layer of one period position, as one stacked leaf of the
reference's (:func:`_scale_groups`).

Under a training mesh (``sharding.fsdp_active``; the state holds this
rank's blocks, ``shard_tree`` of ``param_specs(cfg, serving=False)``) the
step cuts the batch over the batch axes (a field that is a block already
stays as it is), and the loss is the global token-weighted mean
(``models.loss_fn``).  A leaf cut over "data" gets its gradient
reduce-scattered by the FSDP gather's backward and then summed over the
batch axes it is not cut on ("pod"); a leaf kept whole is summed over
every batch axis.  Clipping, compression's scales and the metrics count
each leaf's blocks once; AdamW updates the local blocks.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..distributed.compression import compress_decompress, init_error_state
from ..distributed.sharding import (_names, axis_size, batch_axes,
                                    current_rules, fsdp_active, psum,
                                    shard_tree, spec_of)
from ..models import loss_fn
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..tree import tree_leaves, tree_map, tree_paths

__all__ = ["TrainState", "init_train_state", "build_train_step",
           "decay_mask"]


class TrainState(NamedTuple):
    params: dict
    opt: dict
    step: torch.Tensor          # 0-d int32, on the parameters' device
    error: dict | None = None   # gradient compression's error feedback


def _scale_groups(params: dict, cfg: ModelConfig) -> dict:
    """A key a leaf of ``params``: layer ``i``'s leaves share it with the
    same leaf of every layer at ``i``'s period position (one stacked leaf
    of the reference's, one compression scale); every other leaf its own
    path."""
    n = len(cfg.period)

    def key(path: str) -> str:
        parts = path.split("/")
        if parts[0] == "layers":
            return "/".join(["layers", str(int(parts[1]) % n), *parts[2:]])
        return path
    paths = iter(tree_paths(params))
    return tree_map(lambda _: key(next(paths)[0]), params)


def decay_mask(params: dict) -> list[bool]:
    """Which leaves of ``params`` (in ``tree_leaves`` order) AdamW decays:
    those whose leaf in the reference's stacked layout has two or more
    dimensions, i.e. a per-layer leaf with one or more."""
    return [p.ndim + (path.startswith("layers/")) >= 2
            for path, p in tree_paths(params)]


def _cut_batch(batch: dict) -> dict:
    """This rank's block of each batch field over the batch axes."""
    nb = axis_size(batch_axes())
    for k, v in batch.items():
        if not hasattr(v, "mesh_spec") and v.shape[0] % nb:
            raise ValueError(f"batch field {k!r} of {v.shape[0]} rows does "
                             f"not split over {nb} batch ranks")
    specs = {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in batch.items()}
    return shard_tree(batch, specs, current_rules(), logical=True)


def _sum_over_batch(g: torch.Tensor, spec: tuple) -> torch.Tensor:
    """A rank's gradient of a leaf summed over the batch axes the leaf is
    not cut on (its "data" cut was reduce-scattered already)."""
    cut = {a for ax in spec for a in _names(ax)}
    return psum(g, tuple(a for a in batch_axes() if a not in cut))


def init_train_state(params, cfg: ModelConfig,
                     grad_compress: bool = False) -> TrainState:
    opt = adamw_init(params, cfg.opt_state_dtype)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt["count"].device),
                      error=init_error_state(params) if grad_compress
                      else None)


def build_train_step(cfg: ModelConfig, lr_schedule: Callable,
                     grad_accum: int = 1, max_grad_norm: float = 1.0,
                     grad_compress: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are 0-d tensors: loss, ce and aux (the MoE balance loss; with
    accumulation, means over the microbatches), grad_norm, lr, step."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def value_and_grad(leaves, params, batch):
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = loss_fn(params, batch, cfg)
            # a leaf the loss never reads (an audio stub's token table)
            # gets a zero gradient, as jax.grad gives it
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return ({k: v.detach() for k, v in metrics.items()}, grads)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        leaves = tree_leaves(params)
        dev = leaves[0].device
        mesh = fsdp_active()
        batch = {k: v if hasattr(v, "mesh_spec") else v.to(dev)
                 for k, v in batch.items()}
        if mesh:
            batch = _cut_batch(batch)
        if grad_accum == 1:
            metrics, grads = value_and_grad(leaves, params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % grad_accum:
                raise ValueError(f"batch {n} is not a multiple of "
                                 f"grad_accum={grad_accum}")
            mb = n // grad_accum
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                     for p in leaves]
            sums = dict.fromkeys(("loss", "ce", "aux"), 0.0)
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                m, g = value_and_grad(leaves, params, micro)
                for acc, gi in zip(grads, g):
                    acc += gi
                sums = {k: v + m[k] for k, v in sums.items()}
            grads = [g / grad_accum for g in grads]
            metrics = {k: v / grad_accum for k, v in sums.items()}
        for p in leaves:
            p.requires_grad_(False)
        # grads: a flat list in tree_leaves(params) order
        specs = [spec_of(p) for p in leaves] if mesh else None
        if mesh:
            grads = [_sum_over_batch(g, s) for g, s in zip(grads, specs)]
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm, specs)
        error = state.error
        if grad_compress and error is not None:
            it = iter(grads)
            gtree, error = compress_decompress(
                tree_map(lambda _: next(it), params), error,
                shared=_scale_groups(params, cfg), specs=specs)
            grads = tree_leaves(gtree)
        lr = lr_schedule(state.step)
        adamw_update(grads, state.opt, params, lr,
                     decay_mask=decay_mask(params))
        metrics = dict(metrics, grad_norm=gnorm, lr=lr,
                       step=state.step.to(torch.float32))
        return TrainState(params, state.opt, state.step + 1,
                          error), metrics

    return train_step
