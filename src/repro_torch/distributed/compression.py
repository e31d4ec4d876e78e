"""int8 gradient compression with error feedback.

Port of ``repro.distributed.compression``.  A gradient quantizes to int8
with one scale a tensor (``max |g| / 127``) and the quantization residual
feeds into the next step's gradient (the error state), so the error does
not accumulate.

* :func:`compress_decompress` is the quantize / dequantize round trip
  with error feedback that the train step applies after clipping
  (``build_train_step(grad_compress=True)``).  The reference stacks a
  layer's leaves over the layers of one period position, so one scale
  covers all of them; the port keeps a dict a layer, and ``shared``
  names the leaves that share a scale (the largest of their maxima, an
  exact max), which gives the reference's numbers.
* :func:`compressed_psum` is the explicit compressed all-reduce over a
  process group: int8 levels summed as int32 (exact, in any order), the
  largest scale of the group (a ``MAX`` all-reduce) applied to the sum.
"""

from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_map, tree_paths

__all__ = ["init_error_state", "compress_decompress", "compressed_psum"]


def _compressed(path: str, p: torch.Tensor) -> bool:
    """Does a leaf carry an error state?  The reference's rule, ``ndim >=
    2`` in its layout, where a per-layer leaf has one more (leading)
    dimension."""
    return p.ndim + path.startswith("layers/") >= 2


def init_error_state(params):
    """A float32 zero error a leaf of two or more dimensions (in the
    reference's layout), None elsewhere; the structure of ``params``."""
    paths = iter(tree_paths(params))

    def zero(p):
        path, _ = next(paths)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device) \
            if _compressed(path, p) else None
    return tree_map(zero, params)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quant_int8(g: torch.Tensor, scale: torch.Tensor | None = None):
    """int8 levels of ``g`` and the scale (``max |g| / 127`` unless given),
    as the reference's ``_quant_int8``."""
    if scale is None:
        scale = _scale(torch.max(torch.abs(g)))
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_decompress(grads, error_state, shared=None, specs=None):
    """The error-feedback int8 round trip.  ``grads`` and ``error_state``
    have one structure (a None error leaves its gradient as it is);
    ``shared``, of the same structure, gives each leaf a key, and the
    leaves of one key share one scale (default: a scale a leaf).  Under
    a training mesh the leaves are blocks: ``specs`` (a spec a leaf, in
    ``tree_leaves`` order) names the axes each is cut over, and a scale
    is the maximum over every rank's block.  Returns (grads',
    error_state')."""
    gs = tree_leaves(grads)
    es = [e for _, e in _aligned(grads, error_state)]
    keys = list(range(len(gs))) if shared is None \
        else [k for _, k in _aligned(grads, shared)]
    gf = [None if e is None else g.to(torch.float32) + e
          for g, e in zip(gs, es)]
    amax = {}
    for k, f in zip(keys, gf):
        if f is not None:
            m = torch.max(torch.abs(f))
            amax[k] = m if k not in amax else torch.maximum(amax[k], m)
    if specs is not None:
        from .sharding import _names, pmax
        cut = {k: tuple(a for ax in s for a in _names(ax))
               for k, s in zip(keys, specs)}
        amax = {k: pmax(m, cut[k]) for k, m in amax.items()}
    out_g, out_e = [], []
    for g, e, f, k in zip(gs, es, gf, keys):
        if f is None:
            out_g.append(g)
            out_e.append(e)
            continue
        q, scale = _quant_int8(f, _scale(amax[k]))
        deq = q.to(torch.float32) * scale
        out_g.append(deq.to(g.dtype))
        out_e.append(f - deq)
    gi, ei = iter(out_g), iter(out_e)
    return (tree_map(lambda _: next(gi), grads),
            tree_map(lambda _: next(ei), grads))


def _aligned(tree, other):
    """(leaf of ``tree``, the matching entry of ``other``: a leaf, or None
    where ``other`` holds None) in ``tree_leaves(tree)`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k, v in tree.items()
                for pair in _aligned(v, None if other is None
                                     else other[k])]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in _aligned(v, None if other is None
                                     else other[i])]
    return [(tree, other)]


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """The compressed all-reduce of ``g`` over ``group``: the int8 levels
    summed in int32 and scaled by the group's largest scale (float32)."""
    import torch.distributed as dist
    q, scale = _quant_int8(g.to(torch.float32))
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    scale = scale.clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    return total.to(torch.float32) * scale
