"""SC-friendly fake quantizers (paper §III-B) with the LSQ gradient.

Port of ``repro.core.quant``: LSQ fake-quant (learned step size, Esser
et al. 2020) with the reference's custom VJP, ternary weights,
thermometer activations and the two scale inits.
"""

from __future__ import annotations

import torch

__all__ = ["lsq_fake_quant", "ternary_weight_quant", "thermometer_act_quant",
           "init_alpha", "ternary_weight_init_alpha"]


def _reduce_to_shape(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Sum ``x`` over the axes along which a tensor of ``shape`` was
    broadcast against it (the reference's ``_reduce_to_shape``)."""
    if shape == ():
        return torch.sum(x)
    while x.ndim > len(shape):
        x = torch.sum(x, dim=0)
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape))
                 if b == 1 and a != 1)
    if axes:
        x = torch.sum(x, dim=axes, keepdim=True)
    return x.reshape(shape)


class _LSQ(torch.autograd.Function):
    """Value ``alpha * clip(round(x / alpha), qn, qp)``; gradient as the
    reference's ``_lsq_fwd`` / ``_lsq_bwd``:

    * ``gx``: straight through inside ``[qn, qp]`` (in ``x / alpha``
      units), zero outside;
    * ``galpha``: ``g * dalpha * gscale`` in float32, with ``dalpha`` the
      rail (``qn`` or ``qp``) outside the range and ``q - x / alpha``
      (taken in ``x.dtype``) inside it, and ``gscale = 1 / sqrt(x.numel()
      * max(qp, 1))``, summed to alpha's shape.

    The backward keeps ``x`` and ``alpha`` and forms ``x / alpha`` and
    ``q`` again, the same ops on the same operands: one tensor of x's
    size held for the backward in place of two, none when ``x`` is held
    anyway (a weight).
    """

    @staticmethod
    def _scaled(x, alpha, qn: int, qp: int):
        a = alpha.to(x.dtype)
        xs = x / a
        return a, xs, torch.clamp(torch.round(xs), qn, qp)

    @staticmethod
    def forward(ctx, x, alpha, qn: int, qp: int, numel: int | None):
        a, _, q = _LSQ._scaled(x, alpha, qn, qp)
        ctx.save_for_backward(x, alpha)
        ctx.qn, ctx.qp = qn, qp
        ctx.alpha_shape = tuple(alpha.shape)
        # a Python float: x.numel() can pass 2**31
        n = x.numel() if numel is None else numel
        ctx.gscale = 1.0 / float(n * max(qp, 1)) ** 0.5
        return q * a

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        qn, qp = ctx.qn, ctx.qp
        _, xs, q = _LSQ._scaled(x, alpha, qn, qp)
        gx = torch.where((xs >= qn) & (xs <= qp), g, torch.zeros((),
                         dtype=g.dtype, device=g.device))
        dalpha = torch.where(xs <= qn, float(qn),
                             torch.where(xs >= qp, float(qp), q - xs))
        galpha = g.to(torch.float32) * dalpha.to(torch.float32) * ctx.gscale
        return gx, _reduce_to_shape(galpha, ctx.alpha_shape), None, None, \
            None


def lsq_fake_quant(x: torch.Tensor, alpha: torch.Tensor, qn: int,
                   qp: int, numel: int | None = None) -> torch.Tensor:
    """``alpha * clip(round(x / alpha), qn, qp)`` with the LSQ gradient.

    The value path runs in ``x.dtype``: alpha is cast to it first, so a
    bf16 model stays bf16 and the rounding boundary is computed against
    the cast alpha, as in the reference; alpha's gradient accumulates in
    float32.  ``numel`` (default ``x.numel()``) sizes the gradient's
    scale: a rank's block of a sharded tensor passes the whole tensor's.
    """
    return _LSQ.apply(x, alpha, qn, qp, numel)


def ternary_weight_quant(w: torch.Tensor, alpha: torch.Tensor,
                         numel: int | None = None) -> torch.Tensor:
    """2-bit-BSL (ternary) weight fake-quant: levels {-1, 0, +1}."""
    return lsq_fake_quant(w, alpha, -1, 1, numel)


def thermometer_act_quant(x: torch.Tensor, alpha: torch.Tensor,
                          bsl: int, numel: int | None = None
                          ) -> torch.Tensor:
    """L-bit-BSL activation fake-quant: levels [-L/2, L/2]."""
    half = bsl // 2
    return lsq_fake_quant(x, alpha, -half, half, numel)


def init_alpha(x: torch.Tensor, qp: int) -> torch.Tensor:
    """LSQ init: ``2 * mean|x| / sqrt(qp)``."""
    return 2.0 * torch.mean(torch.abs(x)) / float(max(qp, 1)) ** 0.5


def ternary_weight_init_alpha(w: torch.Tensor) -> torch.Tensor:
    """Per-tensor ternary step: ``max(1.4 * mean|w|, 1e-8)``, the midpoint
    of TWN's 0.7 * mean|w| threshold and LSQ's 2 * mean|w| step."""
    return torch.clamp(1.4 * torch.mean(torch.abs(w)), min=1e-8)
