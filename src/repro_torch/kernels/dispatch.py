"""Kernel dispatch: the tensor's device picks the kernel or its plain version.

Port of ``repro.kernels.dispatch`` with one rule in place of backend
knobs: a CUDA tensor goes to the hand-written CUDA kernel (which launches
or raises), a CPU tensor goes to the kernel's plain PyTorch version.
There is no scope, no environment variable and no row threshold that
would send a CUDA tensor to the plain version.  A meta tensor (the
dry-run's trace, ``launch/dryrun.py``) takes the kernel's route too, where
the kernel's custom op gives the outputs' shapes (``build.on_card``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..core.bsn import ApproxBSNSpec, spec_stages
from . import ref
from .build import on_card
from .approx_bsn import (approx_bsn_cuda, approx_bsn_plain,
                         approx_bsn_temporal_cuda, approx_bsn_temporal_plain)
from .flash_attention import FlashAttention, flash_attention_cuda
from .paged_attention import paged_attn_decode_cuda, paged_attn_prefill_cuda
from . import plan as kplan

__all__ = ["approx_bsn", "paged_attn_decode", "paged_attn_verify",
           "paged_attn_prefill", "flash_attention", "KernelEntry",
           "KERNEL_REGISTRY"]

_flash_plain = functools.partial(ref.flash_attention_ref, return_lse=True)


def approx_bsn(counts: torch.Tensor, spec: ApproxBSNSpec, *,
               cycles: int = 1) -> torch.Tensor:
    """Approximate-BSN accumulation of ``(..., cycles * width)`` popcounts
    -> ``(...,)`` int32 output popcounts; the represented value is
    ``spec.scale * (out - cycles * spec.out_bsl // 2)``.  ``cycles > 1``
    is the Fig 12 temporal adder (its own kernel)."""
    total = cycles * spec.width
    if counts.shape[-1] != total:
        raise ValueError(f"expected trailing dim {total} (cycles={cycles} "
                         f"x width={spec.width}), got {tuple(counts.shape)}")
    batch = counts.shape[:-1]
    rows = math.prod(batch)
    x2 = counts.reshape(rows, total).to(torch.int32)
    kw = dict(in_bsl=spec.in_bsl, stages=spec_stages(spec))
    if cycles > 1:
        kw["cycles"] = cycles
        run = (approx_bsn_temporal_cuda if on_card(counts)
               else approx_bsn_temporal_plain)
    else:
        run = approx_bsn_cuda if on_card(counts) else approx_bsn_plain
    if on_card(counts):
        x2 = x2.contiguous()
    return run(x2, **kw).reshape(batch)


def paged_attn_decode(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor, *, kv_format: str = "fp",
                      kv_aux: dict | None = None) -> torch.Tensor:
    """Batched one-token paged decode, (S, Hkv, G, D) -> (S, Hkv, G, D);
    compressed pools pass ``k_scale``/``v_scale`` (+ sc ``k_resid``/
    ``v_resid``) in ``kv_aux``."""
    aux = kv_aux or {}
    if on_card(q):
        return paged_attn_decode_cuda(q, k_pages, v_pages, page_tables,
                                      lengths, kv_format=kv_format, **aux)
    return ref.paged_attn_decode_ref(q, k_pages, v_pages, page_tables,
                                     lengths, kv_format=kv_format,
                                     kv_aux=aux)


def paged_attn_verify(q: torch.Tensor, k_pages: torch.Tensor,
                      v_pages: torch.Tensor, page_tables: torch.Tensor,
                      lengths: torch.Tensor, *, kv_format: str = "fp",
                      kv_aux: dict | None = None) -> torch.Tensor:
    """The speculative verify window, (S, T, Hkv, G, D) queries at
    positions ``lengths + t`` -> (S, T, Hkv, G, D).  Row t is
    :func:`paged_attn_decode` at length ``lengths + t`` (on the card one
    launch of the decode kernel), so each row equals plain decode's bit
    for bit on either device."""
    return torch.stack(
        [paged_attn_decode(q[:, t].contiguous(), k_pages, v_pages,
                           page_tables, lengths + t, kv_format=kv_format,
                           kv_aux=kv_aux)
         for t in range(q.shape[1])], dim=1)


def paged_attn_prefill(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, page_tables: torch.Tensor,
                       start: int, *, kv_format: str = "fp",
                       kv_aux: dict | None = None) -> torch.Tensor:
    """One chunk of paged prefill, (G, C, Hkv, Gq, D) at positions
    ``[start, start + C)`` against every page written so far, causal."""
    aux = kv_aux or {}
    if on_card(q):
        return paged_attn_prefill_cuda(q, k_pages, v_pages, page_tables,
                                       start=start, kv_format=kv_format,
                                       **aux)
    return ref.paged_attn_prefill_ref(q, k_pages, v_pages, page_tables,
                                      start, kv_format=kv_format,
                                      kv_aux=aux)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Differentiable flash attention, q (B, S, Hq, D) and k / v
    (B, S, Hkv, D) -> (B, S, Hq, D); q is multiplied by ``scale`` (default
    ``1/sqrt(D)``) in float32.  The forward is the flash kernel on CUDA
    tensors and the plain version on CPU ones; the gradient is
    ``kernels/flash_attention.flash_attention_backward`` on both."""
    run = flash_attention_cuda if on_card(q) else _flash_plain
    return FlashAttention.apply(q, k, v, causal, scale, run)


# ---------------------------------------------------------------------------
# the registry of launches the kernel audit and chip_smoke.py read
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelEntry:
    """One launcher of ``build.KERNELS``: its plan builder
    (``kernels/plan.py``), its C ``*_geometry`` entry point and that
    entry point's arguments for a case, and its audit cases (the shapes
    ``chip_smoke.py`` runs it at)."""
    name: str
    geometry_entry: str
    plan_fn: Callable[..., kplan.LaunchPlan]
    geometry_args: Callable[..., tuple]
    case_fn: Callable[[], list]
    uses_sms: bool = False

    def cases(self) -> list[tuple[str, dict]]:
        return self.case_fn()

    def plan(self, *, sms: int = 132, **kw) -> kplan.LaunchPlan:
        """The case's plan; ``sms``: the card's SM count, which only the
        ternary matmul's K split reads."""
        return self.plan_fn(**kw, **({"sms": sms} if self.uses_sms else {}))


_FMTS = (("fp", kplan.KV_BF16), ("int8", kplan.KV_INT8),
         ("sc", kplan.KV_SC))
_F32_FMTS = (("fp32", kplan.KV_F32), ("int8", kplan.KV_INT8),
             ("sc", kplan.KV_SC))


def _arch(name: str):
    from ..configs import get_arch
    return get_arch(name)


def _decode_cases() -> list:
    """chip_smoke.py phase 3's decode shapes (8 serving lanes, 32 lanes of
    a 4096-token window, jamba's head dim 128), the engines of phases 4,
    7, 8 and 10 (granite D 64, qwen3-moe G 16, jamba D 128: 4 lanes of
    16 pages; the verify window is decode launches at later lengths) and
    the tiny float32 engines held card == CPU."""
    g, q, j = (_arch(a) for a in ("granite-3-2b", "qwen3-moe-235b-a22b",
                                  "jamba-1.5-large-398b"))
    shapes = [("serving", 8, 8, 4, 64, 16),
              ("4096", 32, 8, 4, 64, 256),
              ("jamba D128", 5, 8, 8, 128, 16)]
    for tag, c in (("granite engine", g), ("qwen3 engine", q),
                   ("jamba engine", j)):
        shapes.append((tag, 4, c.n_kv_heads, c.n_heads // c.n_kv_heads,
                       c.head_dim, 16))
    out = [(f"{tag} {fmt}", dict(S=S, Hkv=Hkv, G=G, D=D, page=16,
                                 maxp=maxp, num_pages=S * maxp + 1,
                                 kv_kind=kind))
           for tag, S, Hkv, G, D, maxp in shapes for fmt, kind in _FMTS]
    out += [(f"tiny {fmt}", dict(S=2, Hkv=2, G=2, D=16, page=4, maxp=8,
                                 num_pages=17, kv_kind=kind,
                                 q_dtype=kplan.Q_F32))
            for fmt, kind in _F32_FMTS]
    return out


def _prefill_cases() -> list:
    """Phase 3's prefill chunks (the second chunk of a 128-token prompt,
    at block_q 32 and 16; the last 64-token chunk of a 4096-token
    prompt; jamba's head dim 128; qwen3-moe's GQA group of 16 at both
    chunks), the engines' second 64-token chunk of phase 4's 128-token
    prompt, and the tiny float32 engines' chunk."""
    q = _arch("qwen3-moe-235b-a22b")
    shapes = [("serving", 4, 8, 4, 64, 64, 8, 32),
              ("serving bq16", 4, 8, 4, 64, 64, 8, 16),
              ("4096", 4, 8, 4, 64, 4032, 256, 32),
              ("jamba D128", 4, 8, 8, 128, 64, 8, 32),
              ("qwen3 Gq16", 4, 4, 16, 64, 64, 8, 32),
              ("qwen3 Gq16 4096", 4, 4, 16, 64, 4032, 256, 32),
              ("granite engine", 4, 8, 4, 64, 64, 16, 32),
              ("qwen3 engine", 4, q.n_kv_heads, q.n_heads // q.n_kv_heads,
               q.head_dim, 64, 16, 32)]
    out = [(f"{tag} {fmt}", dict(G=G, C=64, Hkv=Hkv, Gq=Gq, D=D, page=16,
                                 width=w, start=st, block_q=bq,
                                 num_pages=G * w + 1, kv_kind=kind))
           for tag, G, Hkv, Gq, D, st, w, bq in shapes
           for fmt, kind in _FMTS]
    out += [(f"tiny {fmt}", dict(G=2, C=8, Hkv=2, Gq=2, D=16, page=4,
                                 width=4, start=0, block_q=8, num_pages=17,
                                 kv_kind=kind, q_dtype=kplan.Q_F32))
            for fmt, kind in _F32_FMTS]
    return out


# granite-3-2b's projections, (K, N)
_GRANITE_PROJ = {"q/o": (2048, 2048), "k/v": (2048, 512),
                 "gate/up": (2048, 8192), "down": (8192, 2048),
                 "lm_head": (2048, 49408)}


def _padded(m: int, k: int, n: int) -> tuple[int, int]:
    mult = 4 if m <= 16 else 16
    return -(-k // mult) * mult, -(-n // mult) * mult


def _ternary_cases() -> list:
    """Phase 3's ternary matmul shapes (decode at 4 lanes, the 64- and
    256-row prefill chunks, the SI epilogue, the ragged shapes as
    ``ops.ternary_matmul`` pads them, phase 8's rwkv6 channel mix and
    jamba in_proj) and a tiny product."""
    shapes = [(f"decode {k}", 4, *v, 0) for k, v in _GRANITE_PROJ.items()]
    shapes += [(f"oracle prefill {k}", 64, *_GRANITE_PROJ[k], 0)
               for k in ("q/o", "gate/up", "down")]
    shapes += [(f"prefill {k}", 256, *_GRANITE_PROJ[k], 0)
               for k in ("q/o", "k/v", "gate/up", "down")]
    shapes += [("stress lm_head", 256, 2048, 49408, 0),
               ("decode q/o SI", 4, 2048, 2048, 8),
               ("TNN layer SI", 256, 256, 256, 8),
               ("full range SI", 64, 784, 256, 32),
               ("ragged", 5, 1001, 1003, 0), ("ragged SI", 5, 1001, 1003, 8),
               ("ragged M 64", 64, 1001, 1003, 0),
               ("ragged M 64 SI", 64, 1001, 1003, 8),
               ("tiny", 4, 64, 128, 0)]
    shapes += [(f"{tag} {k}", m, kk, n, 0)
               for tag, m in (("decode", 4), ("prefill", 256))
               for k, kk, n in (("rwkv6 cmix wk", 4096, 14336),
                                ("rwkv6 cmix wv", 14336, 4096),
                                ("jamba in_proj", 8192, 32768))]
    out = []
    for label, m, k, n, bsl in shapes:
        kp, np_ = _padded(m, k, n)
        out.append((label, dict(batch=1, M=m, N=np_, K=kp, out_bsl=bsl)))
    return out


def _batched_cases() -> list:
    """Phase 3's expert products: qwen3-moe's and jamba's at decode (4
    lanes) and at 256-row prefill rounds, and a dbrx-like one."""
    shapes = (("qwen3 decode gate/up", 128, 4, 4096, 1536),
              ("qwen3 decode down", 128, 4, 1536, 4096),
              ("qwen3 prefill gate/up", 128, 256, 4096, 1536),
              ("qwen3 prefill down", 128, 256, 1536, 4096),
              ("dbrx-like", 16, 32, 6144, 10752),
              ("jamba decode gate/up", 16, 4, 8192, 24576),
              ("jamba decode down", 16, 4, 24576, 8192),
              ("jamba prefill gate/up", 16, 256, 8192, 24576),
              ("jamba prefill down", 16, 256, 24576, 8192))
    return [(label, dict(batch=e, M=m, N=n, K=k))
            for label, e, m, k, n in shapes]


def _approx_cases(temporal: bool) -> list:
    """Phase 3's adder shapes: w_up / w_down at 4 decode slots and
    lm_head's row block (spatial), w_up folded over 8 and 2 cycles
    (temporal), and a multi-stage spec."""
    from ..core.bsn import default_approx_spec, spec_stages
    from ..core.sc_layers import COUNTS_BUDGET_BYTES
    if temporal:
        return [(f"w_up 4 slots T{c}", dict(
            rows=4 * 8192, width=w, cycles=c, temporal=True,
            stages=spec_stages(default_approx_spec(w, 8))))
            for w, c in ((256, 8), (1024, 2))]
    lm_rows = max(1, COUNTS_BUDGET_BYTES // (4 * 49408 * 2048))
    out = [(label, dict(rows=rows, width=k, cycles=1,
                        stages=spec_stages(default_approx_spec(k, 8))))
           for label, rows, k in (("w_up 4 slots", 4 * 8192, 2048),
                                  ("w_down 4 slots", 4 * 2048, 8192),
                                  ("lm_head block", lm_rows * 49408, 2048))]
    out.append(("multi-stage", dict(rows=4096, width=2048, cycles=1,
                                    stages=((16, 2, 4), (8, 4, 3),
                                            (16, 0, 2)))))
    return out


def _approx_args(rows, width, cycles, stages, temporal=False) -> tuple:
    flat = [v for st in stages for v in st]
    return (rows, width, cycles, 8, (ctypes.c_int * len(flat))(*flat),
            len(stages))


def _flash_cases() -> list:
    """Phase 3's flash shapes: the training step's (B 2, S 4096, Hq 32,
    Hkv 8, D 64), a (1, 2) training mesh rank's half of its heads (Hq 16,
    Hkv 4) and jamba's (D 128), bf16; hubert-xlarge's encoder (D
    80, bidirectional) and llava-next-34b's dense prefill (GQA 7, D 128);
    a ragged bidirectional one; the float32 kernel's, its gradient
    check's at D 128 and the tiny float32 hubert's head at D 80."""
    return [("train B2 S4096", dict(B=2, S=4096, Hq=32, Hkv=8, D=64)),
            ("train (1, 2) local heads", dict(B=2, S=4096, Hq=16, Hkv=4,
                                              D=64)),
            ("jamba B1 S4096 D128", dict(B=1, S=4096, Hq=64, Hkv=8, D=128)),
            ("hubert B2 S1500 D80 bidirectional",
             dict(B=2, S=1500, Hq=16, Hkv=16, D=80, causal=False)),
            ("llava prefill B2 S2896 GQA7",
             dict(B=2, S=2896, Hq=56, Hkv=8, D=128)),
            ("float32 D80 bidirectional",
             dict(B=2, S=1500, Hq=16, Hkv=16, D=80, bf16=False,
                  causal=False)),
            ("ragged S1000 bidirectional",
             dict(B=1, S=1000, Hq=8, Hkv=2, D=64, causal=False)),
            ("float32 S1024", dict(B=1, S=1024, Hq=8, Hkv=2, D=64,
                                   bf16=False)),
            ("float32 grad D128", dict(B=2, S=512, Hq=16, Hkv=2, D=128,
                                       bf16=False))]


def _registry() -> dict[str, KernelEntry]:
    decode_args = (lambda S, Hkv, G, D, page, maxp, kv_kind,
                   q_dtype=kplan.Q_BF16, **_:
                   (S, Hkv, G, D, page, maxp, q_dtype, kv_kind))
    prefill_args = (lambda G, C, Hkv, Gq, D, page, width, start, kv_kind,
                    block_q=32, q_dtype=kplan.Q_BF16, **_:
                    (G, C, Hkv, Gq, D, page, width, start,
                     max(1, min(block_q, C)), q_dtype, kv_kind))
    ternary_args = (lambda batch, M, N, K, out_bsl=0, **_:
                    (batch, M, N, K, out_bsl))
    entries = [
        KernelEntry("approx_bsn", "approx_bsn_geometry",
                    kplan.approx_bsn_plan, _approx_args,
                    lambda: _approx_cases(False)),
        KernelEntry("approx_bsn_temporal", "approx_bsn_geometry",
                    kplan.approx_bsn_plan, _approx_args,
                    lambda: _approx_cases(True)),
        KernelEntry("paged_attn_decode", "paged_attn_decode_geometry",
                    kplan.paged_decode_plan, decode_args, _decode_cases),
        KernelEntry("paged_attn_prefill", "paged_attn_prefill_geometry",
                    kplan.paged_prefill_plan, prefill_args, _prefill_cases),
        KernelEntry("ternary_matmul", "ternary_matmul_geometry",
                    kplan.ternary_matmul_plan, ternary_args,
                    _ternary_cases, uses_sms=True),
        KernelEntry("ternary_matmul_batched", "ternary_matmul_geometry",
                    kplan.ternary_matmul_plan, ternary_args,
                    _batched_cases, uses_sms=True),
        KernelEntry("bsn_sort", "bsn_sort_geometry", kplan.bsn_sort_plan,
                    lambda rows, L, dtype: (rows, L, dtype),
                    lambda: [("exact BSN q_proj 4 tokens",
                              dict(rows=4 * 2048, L=16384, dtype=0)),
                             ("int32 4096 x 1024",
                              dict(rows=4096, L=1024, dtype=1)),
                             ("float32 4096 x 1024",
                              dict(rows=4096, L=1024, dtype=2))]),
        KernelEntry("flash_attention", "flash_attention_geometry",
                    kplan.flash_attention_plan,
                    lambda B, S, Hq, Hkv, D, bf16=True, causal=True:
                    (B, S, Hq, Hkv, D, int(bf16)), _flash_cases),
    ]
    return {e.name: e for e in entries}


KERNEL_REGISTRY = _registry()
