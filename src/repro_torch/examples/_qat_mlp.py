"""The QAT TNN MLP that the paper's accuracy mechanisms run on.

Port of ``benchmarks/_qat_mlp.py``.  The paper's accuracy experiments
(Tables III / IV, Figs 2 / 5 / 8) ran ResNet18 on CIFAR and a TNN MLP on
MNIST; offline, the mechanisms are reproduced on
``SyntheticClassification`` with the paper's TNN MLP shape
(784-256-256-10) and a residual block, so the §III claims are testable.

    W-A-R notation: weight BSL - activation BSL - residual BSL.

The parameters are a dict: ``w_in``, ``blocks`` (a list of dicts with
``w``, ``alpha_w``, ``alpha_a``, ``alpha_r``) and ``w_out``.  Gradients
come from autograd through the LSQ function of ``core.quant``, and the
update is the port's AdamW.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .. import prng
from ..core.quant import lsq_fake_quant, thermometer_act_quant
from ..data import SyntheticClassification
from ..device import resolve_device
from ..optim import adamw_init, adamw_update
from ..tree import tree_leaves

__all__ = ["QatSpec", "init_mlp", "mlp_forward", "fit_mlp", "train_mlp",
           "eval_mlp", "DATASET"]

DATASET = SyntheticClassification(n_classes=10, dim=784, seed=0)


@dataclass(frozen=True)
class QatSpec:
    weight_bsl: int | None = 2      # None = float weights
    act_bsl: int | None = 2         # None = float activations
    resid_bsl: int | None = None    # None = no residual path at all
    hidden: int = 256
    n_blocks: int = 2


def init_mlp(key: torch.Tensor, spec: QatSpec,
             device: str | torch.device | None = None) -> dict:
    """The reference's init from a ``prng`` key: ``split(key, n_blocks +
    2)``, normal draws (within an ulp or so of ``jax.random.normal``)
    at the reference's scales, on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    ks = prng.split(key.to(dev), spec.n_blocks + 2)
    h = spec.hidden

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)
    return {"w_in": prng.normal(ks[0], (784, h)) * (1 / 28.0),
            "blocks": [{"w": prng.normal(ks[1 + i], (h, h)) / math.sqrt(h),
                        "alpha_w": scalar(0.05), "alpha_a": scalar(0.5),
                        "alpha_r": scalar(0.1)}
                       for i in range(spec.n_blocks)],
            "w_out": prng.normal(ks[-1], (h, 10)) / math.sqrt(h)}


def _q_w(w, alpha, spec: QatSpec):
    if spec.weight_bsl is None:
        return w
    half = spec.weight_bsl // 2
    return lsq_fake_quant(w, alpha, -half, half)


def _q_a(x, alpha, spec: QatSpec):
    if spec.act_bsl is None:
        return x
    return thermometer_act_quant(x, alpha, spec.act_bsl)


def mlp_forward(params: dict, x: torch.Tensor, spec: QatSpec) -> torch.Tensor:
    """Float front end, then per block thermometer activations times
    ternary weights and a ReLU (plus, with ``resid_bsl``, the §III
    high-precision residual), then the float head; returns logits."""
    h = torch.relu(x @ params["w_in"])
    for blk in params["blocks"]:
        xa = _q_a(h, blk["alpha_a"], spec)
        wq = _q_w(blk["w"], blk["alpha_w"], spec)
        y = torch.relu(xa @ wq)
        if spec.resid_bsl is not None:
            # high-precision residual fusion (paper §III, Fig 6b)
            r = lsq_fake_quant(h, blk["alpha_r"], -spec.resid_bsl // 2,
                               spec.resid_bsl // 2)
            h = y + r
        else:
            h = y
    return h @ params["w_out"]


def _loss(params: dict, batch: dict, spec: QatSpec) -> torch.Tensor:
    logits = mlp_forward(params, batch["x"], spec)
    oh = F.one_hot(batch["y"].long(), 10).to(logits.dtype)
    return -torch.mean(torch.sum(oh * F.log_softmax(logits, dim=-1), -1))


def fit_mlp(params: dict, spec: QatSpec, steps: int, batch: int = 256,
            lr: float = 2e-3) -> list[float]:
    """Train ``params`` in place for ``steps`` steps of ``DATASET``
    batches 0, 1, ... (drawn on the parameters' device): cross entropy,
    AdamW without weight decay, a 20-step linear warm-up.  Returns the
    losses."""
    dev = params["w_in"].device
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = adamw_init(params)
    losses = []
    for i in range(steps):
        b = DATASET.batch(i, batch, dev)
        loss = _loss(params, b, spec)
        # a scale the spec leaves unused gets a zero gradient, as in jax
        grads = [torch.zeros_like(p) if g is None else g for p, g in
                 zip(leaves, torch.autograd.grad(loss, leaves,
                                                 allow_unused=True))]
        adamw_update(grads, opt, params, lr * min(1.0, (i + 1) / 20),
                     weight_decay=0.0)
        losses.append(loss.detach())
    for p in leaves:
        p.requires_grad_(False)
    return [float(v) for v in losses]


def train_mlp(spec: QatSpec, steps: int = 250, batch: int = 256,
              lr: float = 2e-3, seed: int = 0,
              device: str | torch.device | None = None) -> dict:
    """QAT-train the MLP from ``init_mlp(prng.key(seed))``; returns the
    parameters."""
    params = init_mlp(prng.key(seed), spec, device)
    fit_mlp(params, spec, steps, batch, lr)
    return params


@torch.no_grad()
def eval_mlp(params: dict, spec: QatSpec, n_batches: int = 10,
             batch: int = 512) -> float:
    """Accuracy over the held-out steps ``10_000 + i``."""
    dev = params["w_in"].device
    correct = total = 0
    for i in range(n_batches):
        b = DATASET.batch(10_000 + i, batch, dev)
        logits = mlp_forward(params, b["x"], spec)
        correct += int(torch.sum(torch.argmax(logits, -1) == b["y"]))
        total += batch
    return correct / total
