"""The train step: loss -> grads -> clip -> AdamW.

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
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..models import loss_fn
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..tree import tree_leaves, tree_paths

__all__ = ["TrainState", "init_train_state", "build_train_step",
           "decay_mask"]


class TrainState(NamedTuple):
    params: dict
    opt: dict
    step: torch.Tensor          # 0-d int32, on the parameters' device
    error: dict | None = None   # gradient compression (not ported)


def _no_compression() -> None:
    raise NotImplementedError(
        "grad_compress is not ported yet: distributed/compression.py comes "
        "with mesh serving (ROADMAP Queue 1 item 11)")


def decay_mask(params: dict) -> list[bool]:
    """Which leaves of ``params`` (in ``tree_leaves`` order) AdamW decays:
    those whose leaf in the reference's stacked layout has two or more
    dimensions, i.e. a per-layer leaf with one or more."""
    return [p.ndim + (path.startswith("layers/")) >= 2
            for path, p in tree_paths(params)]


def init_train_state(params, cfg: ModelConfig,
                     grad_compress: bool = False) -> TrainState:
    if grad_compress:
        _no_compression()
    opt = adamw_init(params, cfg.opt_state_dtype)
    return TrainState(params=params, opt=opt,
                      step=torch.zeros((), dtype=torch.int32,
                                       device=opt["count"].device))


def build_train_step(cfg: ModelConfig, lr_schedule: Callable,
                     grad_accum: int = 1, max_grad_norm: float = 1.0,
                     grad_compress: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    are 0-d tensors: loss, ce and aux (the MoE balance loss; with
    accumulation, means over the microbatches), grad_norm, lr, step."""
    if grad_compress:
        _no_compression()
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def value_and_grad(leaves, params, batch):
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        return ({k: v.detach() for k, v in metrics.items()}, grads)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        leaves = tree_leaves(params)
        dev = leaves[0].device
        batch = {k: v.to(dev) for k, v in batch.items()}
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
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = lr_schedule(state.step)
        adamw_update(grads, state.opt, params, lr,
                     decay_mask=decay_mask(params))
        metrics = dict(metrics, grad_norm=gnorm, lr=lr,
                       step=state.step.to(torch.float32))
        return TrainState(params, state.opt, state.step + 1,
                          state.error), metrics

    return train_step
