"""AdamW with a configurable state dtype.

Port of ``repro.optim.adamw``: ``m`` / ``v`` mirror the parameter tree
in ``state_dtype`` (bfloat16 halves their memory), the update math runs
in float32, and only parameters with two or more dimensions decay
(``decay_mask`` overrides that rule leaf by leaf).

The update is in place: the reference's launcher donates the training
state to its jitted step, so the old state is never read again, and
writing into the same tensors keeps one copy of the parameters and of
``m`` / ``v`` on the card instead of two.

Under a training mesh each rank holds its block of every parameter, and
``m`` / ``v`` are blocks of the same cut (ZeRO: no replicated optimizer
memory; :func:`opt_state_specs`); the update is elementwise, so a rank
updates its blocks alone.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map

__all__ = ["adamw_init", "adamw_update", "opt_state_specs"]


def adamw_init(params, state_dtype: str = "float32") -> dict:
    dt = getattr(torch, state_dtype)

    def zeros(p):
        z = torch.zeros(p.shape, dtype=dt, device=p.device)
        if hasattr(p, "mesh_spec"):         # a block: the state's is too
            z.mesh_spec = p.mesh_spec
        return z
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_specs) -> dict:
    """The optimizer state's specs: ``m`` / ``v`` cut as the parameters,
    the step count whole."""
    return {"m": param_specs, "v": param_specs, "count": ()}


@torch.no_grad()
def adamw_update(grads, opt_state: dict, params, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, decay_mask=None):
    """One AdamW step, written into ``params`` and ``opt_state`` (see the
    module docstring); returns them.  ``lr`` is a float or a 0-d float32
    tensor; ``grads`` a tree with the leaves of ``params`` in order (a
    flat list will do), ``decay_mask`` a tree or list of bools (default:
    ``p.ndim >= 2``)."""
    count = opt_state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    leaves = tree_leaves(params)
    mask = ([p.ndim >= 2 for p in leaves] if decay_mask is None
            else tree_leaves(decay_mask))
    for p, g, m, v, dm in zip(leaves, tree_leaves(grads),
                              tree_leaves(opt_state["m"]),
                              tree_leaves(opt_state["v"]), mask):
        gf = g.to(torch.float32)
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        step = (mf / bc1) / (torch.sqrt(vf / bc2) + eps)
        decay = weight_decay if dm else 0.0
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (step + decay * pf))
        m.copy_(mf)
        v.copy_(vf)
    opt_state["count"] = count
    return params, opt_state
