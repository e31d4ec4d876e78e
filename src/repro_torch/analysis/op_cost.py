"""Operations and bytes of one step, op by op (``hlo_cost.py``'s role).

The reference walks compiled HLO; its parser is XLA's and has no
counterpart here.  The port runs the step and counts it:

* each aten op under a ``TorchDispatchMode``: operations by
  ``torch.utils.flop_counter``'s formulas (and the products' shapes for
  the composite ``matmul`` / ``einsum`` / ``linear``, which reach the mode
  undecomposed in inference mode), bytes as its operands plus its results
  (an eager op reads and writes device memory; a view moves nothing; an
  in-place op reads its other operands and writes as many bytes into
  the one it mutates);
* each kernel, at its front door (``kernels/dispatch.py``,
  ``kernels/ops.py``), from its own formula: the bytes it must move and
  the operations it does on this call's inputs, the formulas
  ``chip_smoke.py`` bounds the kernels with.  The aten ops issued inside
  a front door (its plain version on the CPU, the wrapper's scratch on
  the card) are not counted again;
* each collective of a mesh (``distributed.sharding``'s gathers,
  all-reduces and reduce-scatters, ``sharding.wire_log``): the bytes it
  brings a rank, by mesh axes.

Precision classes: ``bf16`` (bf16 / fp16), ``int8``, ``fp64`` and
``fp32`` (float32 and the integer work of the CUDA cores), each at its
rate in ``roofline.HwSpec``.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["StepCost", "step_cost", "approx_bsn_cost", "ternary_cost",
           "batched_ternary_cost", "sort_cost", "paged_decode_cost",
           "paged_prefill_cost", "flash_cost", "kv_bytes_per_pos",
           "matmul_flops"]


def _precision(dt: torch.dtype) -> str:
    if dt in (torch.bfloat16, torch.float16):
        return "bf16"
    if dt in (torch.int8, torch.uint8):
        return "int8"
    if dt == torch.float64:
        return "fp64"
    return "fp32"


# ---------------------------------------------------------------------------
# the kernels' formulas: (bytes, operations, precision)
# ---------------------------------------------------------------------------

def approx_bsn_cost(rows: int, total: int) -> tuple[int, int, str]:
    """The adder: each int32 count read once, one add each, one int32 out
    a row."""
    return rows * total * 4 + rows * 4, rows * total, "fp32"


def ternary_cost(m: int, k: int, n: int, out_bsl: int = 0
                 ) -> tuple[int, int, str]:
    """int8 x (m, k) and w (k, n) read, int32 (m, n) written, the SI
    thresholds read; 2 m n k products and adds, m n out_bsl compares."""
    return (m * k + k * n + 4 * m * n + 4 * n * out_bsl,
            2 * m * n * k + m * n * out_bsl, "int8")


def batched_ternary_cost(e: int, m: int, k: int, n: int
                         ) -> tuple[int, int, str]:
    return e * k * n + e * m * k + 4 * e * m * n, 2 * e * m * n * k, "int8"


def sort_cost(nbytes: int, rows: int, length: int) -> tuple[int, int, str]:
    """Rows read and written once; two operations a compare-exchange of
    the bitonic network's L/2 log L (log L + 1) / 2."""
    levels = length.bit_length() - 1
    exchanges = rows * (length // 2) * levels * (levels + 1) // 2
    return nbytes, 2 * exchanges, "fp32"


def kv_bytes_per_pos(fmt: str, Hkv: int, D: int, itemsize: int = 2) -> int:
    """Bytes one cached position costs a K or V pool (codes + scales +
    residuals)."""
    return {"fp": itemsize * Hkv * D, "int8": Hkv * D + 4 * Hkv,
            "sc": 2 * Hkv * D + 4 * Hkv}[fmt]


def paged_decode_cost(*, q_numel: int, q_itemsize: int, table_numel: int,
                      S: int, n_live: int, fmt: str, Hkv: int, G: int,
                      D: int, kv_itemsize: int = 2) -> tuple[int, int, str]:
    """q read and the output written, the tables and lengths, and each
    live position's K and V once; 4 G D operations a live position and
    KV head (q.k and p.v)."""
    nbytes = (2 * q_numel * q_itemsize + table_numel * 4 + S * 4
              + 2 * n_live * kv_bytes_per_pos(fmt, Hkv, D, kv_itemsize))
    return nbytes, 4 * n_live * Hkv * G * D, \
        "bf16" if q_itemsize == 2 else "fp32"


def paged_prefill_cost(*, q_numel: int, q_itemsize: int, table_numel: int,
                       G: int, C: int, Hkv: int, Gq: int, D: int,
                       start: int, fmt: str, kv_itemsize: int = 2
                       ) -> tuple[int, int, str]:
    """q read and written, the tables, each seen position's K and V once;
    4 D operations a causal (query, key) pair and query head."""
    pairs = sum(start + c + 1 for c in range(C))
    T = start + C
    nbytes = (2 * q_numel * q_itemsize + table_numel * 4
              + 2 * G * T * kv_bytes_per_pos(fmt, Hkv, D, kv_itemsize))
    return nbytes, 4 * G * pairs * Hkv * Gq * D, \
        "bf16" if q_itemsize == 2 else "fp32"


def flash_cost(B: int, S: int, Hq: int, Hkv: int, D: int, causal: bool,
               itemsize: int = 2) -> tuple[int, int, str]:
    """q, k, v, o once and the float32 LSE; 4 D operations a (query, key)
    pair the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = itemsize * B * S * D * (2 * Hq + 2 * Hkv) + 4 * B * Hq * S
    return nbytes, 4 * B * Hq * pairs * D, \
        "bf16" if itemsize == 2 else "fp32"


# ---------------------------------------------------------------------------
# aten ops
# ---------------------------------------------------------------------------

def matmul_flops(a: tuple, b: tuple) -> int:
    """2 x the multiply-adds of ``torch.matmul`` on shapes ``a``, ``b``."""
    if len(a) == 1:
        a = (1, *a)
    if len(b) == 1:
        b = (*b, 1)
    batch = torch.broadcast_shapes(a[:-2], b[:-2])
    return 2 * math.prod(batch) * a[-2] * a[-1] * b[-1]


def _einsum_flops(eq: str, shapes: list[tuple]) -> int:
    """2 x the product of every index's size, for a two-operand einsum."""
    ins = eq.replace(" ", "").split("->")[0].split(",")
    sizes = {}
    for sub, shp in zip(ins, shapes):
        for c, n in zip(sub, shp):
            sizes[c] = n
    return 2 * math.prod(sizes.values()) if len(ins) == 2 else 0


def _op_flops(name: str, func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    ts = [a for a in tree_leaves(args) if isinstance(a, torch.Tensor)]
    if name == "matmul" and len(ts) >= 2:
        return matmul_flops(tuple(ts[0].shape), tuple(ts[1].shape))
    if name == "linear" and len(ts) >= 2:
        return matmul_flops(tuple(ts[0].shape), tuple(ts[1].shape[::-1]))
    if name == "einsum" and len(ts) >= 2:
        return _einsum_flops(args[0], [tuple(t.shape) for t in ts])
    fn = flop_registry.get(func._overloadpacket)
    if fn is None:
        return 0
    try:
        return int(fn(*args, **(kwargs or {}), out_val=out))
    except (TypeError, ValueError):
        return 0


def _ptr(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (meta tensors have no data
    pointer; the storage object identifies them all the same)."""
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return id(t)


def _is_inplace(func) -> bool:
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)


@dataclass
class StepCost:
    """One step's counted cost on one rank."""
    flops: dict = field(default_factory=dict)       # precision -> ops
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    wire_by_axes: dict = field(default_factory=dict)  # "data,model" -> B
    launches: dict = field(default_factory=dict)    # kernel -> calls
    by_site: dict = field(default_factory=dict)     # site -> [ops, bytes]

    def add(self, site: str, nbytes: float, ops: float, prec: str) -> None:
        self.hbm_bytes += nbytes
        if ops:
            self.flops[prec] = self.flops.get(prec, 0) + ops
        s = self.by_site.setdefault(site, [0, 0])
        s[0] += ops
        s[1] += nbytes

    def top(self, n: int = 8) -> list:
        return sorted(((k, v[0], v[1]) for k, v in self.by_site.items()),
                      key=lambda r: -r[2])[:n]


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost, inside: list):
        super().__init__()
        self.cost, self.inside = cost, inside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.inside[0]:
            return out
        from .contracts import _frames, provenance
        import sys
        name = func.overloadpacket.__name__
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        in_ptrs = {_ptr(t) for t in ins}
        if outs and all(_ptr(o) in in_ptrs for o in outs) \
                and not _is_inplace(func):
            return out          # a view (or ``to`` that kept its input)
        if _is_inplace(func):
            # the mutated operand is touched where the others land: its
            # other operands read and as many bytes written
            dst = {id(o) for o in outs}
            nbytes = 2 * sum(t.numel() * t.element_size() for t in ins
                             if id(t) not in dst)
        else:
            nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        flops = _op_flops(name, func, args, kwargs, out)
        prec = _precision(ins[0].dtype) if ins else "fp32"
        self.cost.add(provenance(_frames(sys._getframe(1))), nbytes, flops,
                      prec)
        return out


# the front doors and each one's formula on its arguments
def _decode_formula(q, k_pages, v_pages, page_tables, lengths, *,
                    kv_format="fp", kv_aux=None):
    S, Hkv, G, D = q.shape
    n_live = int((lengths.to(torch.int64) + 1).sum())
    return paged_decode_cost(q_numel=q.numel(), q_itemsize=q.element_size(),
                             table_numel=page_tables.numel(), S=S,
                             n_live=n_live, fmt=kv_format, Hkv=Hkv, G=G,
                             D=D, kv_itemsize=k_pages.element_size())


def _prefill_formula(q, k_pages, v_pages, page_tables, start, *,
                     kv_format="fp", kv_aux=None):
    G, C, Hkv, Gq, D = q.shape
    return paged_prefill_cost(q_numel=q.numel(),
                              q_itemsize=q.element_size(),
                              table_numel=page_tables.numel(), G=G, C=C,
                              Hkv=Hkv, Gq=Gq, D=D, start=start,
                              fmt=kv_format,
                              kv_itemsize=k_pages.element_size())


def _ternary_formula(x_q, w_int, thresholds_q=None):
    if w_int.ndim == 3:
        e, k, n = w_int.shape
        return batched_ternary_cost(e, x_q.shape[1], k, n)
    k, n = w_int.shape
    m = x_q.numel() // k
    return ternary_cost(m, k, n, 0 if thresholds_q is None
                        else thresholds_q.shape[-1])


def _approx_formula(counts, spec, *, cycles=1):
    rows = counts.numel() // counts.shape[-1]
    return approx_bsn_cost(rows, counts.shape[-1])


def _sort_formula(x, *, descending=True):
    return sort_cost(2 * x.numel() * x.element_size(), *x.shape)


def _flash_formula(q, k, v, *, causal=True, scale=None):
    B, S, Hq, D = q.shape
    return flash_cost(B, S, Hq, k.shape[2], D, causal, q.element_size())


_FRONT_DOORS = (
    ("kernels.dispatch", "paged_attn_decode", "paged_attn_decode",
     _decode_formula),
    ("kernels.dispatch", "paged_attn_prefill", "paged_attn_prefill",
     _prefill_formula),
    ("kernels.dispatch", "approx_bsn", "approx_bsn", _approx_formula),
    ("kernels.dispatch", "flash_attention", "flash_attention",
     _flash_formula),
    ("kernels.ops", "ternary_matmul", "ternary_matmul", _ternary_formula),
    ("kernels.ops", "sort_rows", "bsn_sort", _sort_formula),
)


@contextlib.contextmanager
def _front_doors(inside: list, pending: list):
    from .contracts import wrap_functions
    kernels = {fn: (kernel, formula)
               for _, fn, kernel, formula in _FRONT_DOORS}

    def make(inner, fn_name):
        kernel, formula = kernels[fn_name]

        def wrapped(*a, **kw):
            if inside[0]:
                return inner(*a, **kw)
            inside[0] = True
            try:
                out = inner(*a, **kw)
            finally:
                inside[0] = False
            # evaluated after the step: a formula may read lengths
            pending.append((kernel, formula, a, kw))
            return out
        return wrapped
    with wrap_functions([(m, fn) for m, fn, _, _ in _FRONT_DOORS], make):
        yield


def step_cost(run) -> StepCost:
    """Run ``run()`` (one step) and count it."""
    from ..distributed.sharding import wire_log
    cost = StepCost()
    inside, pending = [False], []
    with _front_doors(inside, pending), wire_log() as wire, \
            _Counter(cost, inside):
        run()
    for kernel, formula, a, kw in pending:
        nbytes, ops, prec = formula(*a, **kw)
        cost.add(f"kernel {kernel}", nbytes, ops, prec)
        name = kernel
        if kernel == "ternary_matmul" and a[1].ndim == 3:
            name = "ternary_matmul_batched"
        elif kernel == "approx_bsn" and kw.get("cycles", 1) > 1:
            name = "approx_bsn_temporal"
        cost.launches[name] = cost.launches.get(name, 0) + 1
    for _, names, nbytes in wire:
        key = ",".join(names)
        cost.wire_by_axes[key] = cost.wire_by_axes.get(key, 0.0) + nbytes
    cost.wire_bytes = float(sum(cost.wire_by_axes.values()))
    return cost
