#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port serves on the card.

Drives ``src/repro_torch`` (never ``jax`` or the ``repro`` package) on one
CUDA card, in phases; any failure ends the run with a non-zero exit:

1. the card: torch's device name and ``nvidia-smi``'s name / power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and read
   their machine code (``cuobjdump -sass``): the bf16 flash and paged-
   prefill kernels must use the tensor cores (HMMA) and, at D 64, they
   and the split paged-decode kernel use no local memory; the ternary
   matmul's tensor-core kernel must use the integer tensor cores (IGMMA)
   and no local memory;
3. hold each kernel against its plain PyTorch version at the shapes its
   path gives it (the BSN adders, the ternary matmul with and without
   its SI epilogue, and the sort bit-exact; attention within a stated
   tolerance for fp / int8 / sc pools, ragged lengths and poisoned trash
   pages; the paged kernels at the serving shapes and at 4096-token
   contexts: 32 decode lanes of 1024-4095 tokens, the last 64-token
   prefill chunk of a 4096-token prompt), with kernel / plain / library-
   yardstick times and a roofline bound (the paged kernels' device times
   from torch.profiler beside their times per call with the host; the
   ternary matmul on both sides of its dp4a / tensor-core crossover,
   over the full int8 range too, against ``torch._int_mm`` with w in
   the reference's (K, N) layout and column-major; its batched launch at
   qwen3-moe's and jamba's expert shapes, decode and prefill, and a
   dbrx-like one, with empty expert rows, against E back-to-back
   ``_int_mm`` calls; the paged kernels and the single ternary matmul at
   phase 8's shapes too: jamba's attention at head_dim 128, rwkv6's
   channel mix and jamba's ``in_proj``);
4. serve full-width granite-3-2b (bf16, random weights from a seed,
   ``--layers`` of its 40 layers, 20 by default) through
   ``ServeEngine`` on qat x fp, sc_int x int8 (every projection
   through the ternary matmul kernel) and sc_int_approx x sc: every
   kernel on the path must have launched, the batched tokens must equal
   ``sequential_generate``'s, and a tiny float32 config must give the
   same tokens on the card as on the CPU; one sc_int prefill is profiled
   by ternary-matmul kernel instance;
5. the SC integer datapath at published width: the paper's TNN
   (784-256-256-10, seeded random QAT parameters) exported and fed a
   batch of 256 through the fused-SI ternary matmul, the exact BSN's
   bit-level circuit (the sort kernel) over a full granite projection,
   and the temporal adder on full-width ``w_up``; each kernel of the path
   must have launched and every integer must agree with its plain
   version and with the exact integer path;
6. train full-width granite-3-2b (bf16, sc_qat, per-layer recompute,
   seeded random initial weights) for 3 AdamW steps on 2 x 4096 tokens
   of ``SyntheticLM`` through ``build_train_step``: every attention
   forward and its recompute runs the flash kernel (layers x 2 x 3
   launches),
   losses and gradient norms are finite, step 1 (learning rate 0) changes
   no parameter and step 2 changes every watched one whose AdamW update
   does not round away in bf16; one more step is profiled, and
   all its layers x 2 flash forwards must be the tensor-core kernel; and
   a tiny float32 config's train step on the card equals the same step on
   the CPU within a stated tolerance;
7. serve full-width qwen3-moe-235b-a22b (128 experts top-8, qk_norm,
   bf16, seeded random weights, ``--moe-layers`` of its 94 layers, 4 by
   default,
   capacity factor E / k = 16 so no token drops) on the same three pairs
   and traffic (8 new tokens): batched tokens equal
   ``sequential_generate``'s, the paged kernels at G 16 and, under both
   integer datapaths, one batched ``ternary_matmul`` launch per expert
   product (3 a layer in each prefill chunk round and decode step; the
   dense projections take the single kernel under sc_int and the BSN
   adder under sc_int_approx); one decode step and the batched prefill
   profiled per pair; and tiny float32 qwen3 and dbrx configs give the
   same tokens on the card as on the CPU;
8. serve the recurrent mixers at full width (bf16, seeded random
   weights) on the same three pairs and traffic (8 new tokens):
   rwkv6-7b whole (``--rwkv-layers``, default its 32 layers; d 4096, 64
   wkv heads of 64, d_ff 14336, vocab 65536) and jamba-1.5-large-398b at
   ``--jamba-layers`` (default 5 of its 72: mamba + dense, mamba + MoE,
   mamba + dense, mamba + MoE, attention + dense; d 8192, d_inner 16384,
   16 experts top-2, capacity factor E / k = 8), each lane's recurrent
   state in per-slot rows of the paged cache: batched tokens equal
   ``sequential_generate``'s, every kernel of the pair's path launched
   (on rwkv6 none under qat, the ternary matmul under sc_int, the BSN
   adder under sc_int_approx; on jamba the paged kernels too and the
   batched ternary matmul 3 times a MoE layer a round under both integer
   datapaths), one decode step and the prefill profiled per pair; and
   tiny float32 rwkv6 and jamba configs give the same tokens on the card
   as on the CPU;
9. train the recurrent mixers at full width and serve the dense path:
   rwkv6-7b (``--rwkv-train-layers`` of its 32 layers, 2 by default) under
   sc_qat, per-layer recompute and AdamW on 1 x 4096 tokens of
   ``SyntheticLM``, 3 steps and a profiled one with the registered token
   scan, one step with the chunked wkv from the same parameters and batch
   (its learning rate 0, its loss within 1e-2 relative of the scan's, and
   on layer 0's operands the chunked wkv within 1e-5 of the scan's
   largest entry); jamba-1.5-large-398b at 1 layer (mamba + dense; any
   deeper cut reaches an MoE layer of 9.7 B expert parameters) on 1 x
   4096 tokens, 3 steps with its bfloat16 AdamW state; both with
   phase 6's gates (finite losses, lr 0 moves nothing, step 2 moves
   every watched leaf whose update exceeds half an ulp).  Then granite-
   3-2b at phase 4's depth through the dense cache: ``prefill`` + 8
   teacher-forced ``decode_step``s against ``paged_prefill`` +
   ``paged_decode_step`` with quantization off (logits within 5e-2 of the
   largest), and the dense ``sequential_generate`` on qat / sc_int /
   sc_int_approx x fp, each kernel launched the predicted number of
   times (the flash kernel once a layer a prefill, the ternary matmul or
   the BSN adder by the projections' rows), its tokens printed beside
   the engine's with the first parting and its logit gap (not gated: on
   the fake-quant lattice a one-ulp difference between the flash and the
   paged kernels becomes whole quanta); and tiny float32 rwkv6 (both wkv
   forms) and jamba (a whole period) train steps, dense
   ``sequential_generate`` tokens and ``prefill_mode="exact"`` engine
   tokens on the card equal to the CPU's.

Phase 3 also holds the flash kernel against its plain version at phase
6's shape (O and the log-sum-exp), at jamba's attention shape (B 1, S
4096, 64 / 8 heads, D 128), at a ragged bidirectional GQA shape (all
bf16: the tensor-core kernel), in float32 (the CUDA-core kernel), and its
gradient against autograd through the plain version at D 64 and D 128;
and it measures what rounding P to one bf16 term, or to the kernel's
two, does to O.  Phases 4, 7 and 8 hold the batched engine against the
paged oracle (``serving.engine._paged_sequential_generate``) on every
pair; ``sequential_generate`` itself runs the dense cache for fp, as the
reference's, and phase 9 holds that.

Run from the repository root::

    python3 chip_smoke.py                 # full run (20 / 4 / 32 / 5 / 2 layers)
    python3 chip_smoke.py --layers 2 --moe-layers 1 --rwkv-layers 2 \
        --jamba-layers 2 --rwkv-train-layers 1   # quick check

Phase 4 also profiles one decode step per datapath (torch.profiler):
device busy time, the device's idle share, and the PyTorch ops that take
the device time, written to ``chiprun_out/profile_*.txt``.
It also times one decode step's float products (``matmul_rows``,
float64) against a bf16 ``torch.matmul`` on the same operands.

The last stdout line is ``{"ok": true, "device": {...}}``; the line before
it holds the per-kernel JSON summary.  Details go to
``chiprun_out/chip_smoke.json``, the kernels' ``ptxas`` report to
``chiprun_out/ptxas.log`` and the flash and sort kernels' machine code to
``chiprun_out/sass.txt``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM published peaks (dense): HBM3 bytes/s; bf16 and int8
# tensor-core and fp32 CUDA-core operations/s (the CUDA-core rate also
# stands for the integer adds and compares of the BSN kernels)
HBM_BPS = 3.35e12
BF16_OPS = 989e12
INT8_OPS = 1979e12
FP32_OPS = 67e12

ATTN_ATOL = 1e-2        # bf16 outputs: one bf16 ulp at |o| <= 2 is 7.8e-3
SEED = 0
NEW_TOKENS = 12
ACT_BSL = 8

# granite-3-2b's projections at full width, (K, N)
GRANITE_PROJ = {"q/o": (2048, 2048), "k/v": (2048, 512),
                "gate/up": (2048, 8192), "down": (8192, 2048),
                "lm_head": (2048, 49408)}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, ops, ops_rate):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


SASS_KERNELS = ("flash_fwd_mma_kernel", "flash_fwd_kernel",
                "bsn_sort_reg_kernel", "paged_decode_split_kernel",
                "paged_prefill_mma_kernel", "ternary_matmul_mma_kernel")


def read_sass(so_path):
    """The tensor-core and register-level kernels' machine code in the
    built library (``cuobjdump -sass``): per kernel instance its tensor-
    core (HMMA / HGMMA) and local-memory (LDL / STL) instructions.  Each
    bf16 flash and paged-prefill instance must use the tensor cores; at
    D 64 the flash, paged-prefill and paged-decode kernels spill nothing;
    every int8 ternary-matmul tensor-core instance uses the integer tensor
    cores (IGMMA, wgmma's; or IMMA, mma.sync's) and no local memory."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        log("sass: cuobjdump not found, machine code not read")
        return None
    sass = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, check=True).stdout
    kept, found = [], []
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        kernel = next((k for k in SASS_KERNELS if k in name), None)
        if kernel is None:
            continue
        tmpl = re.search(r"kernelI(.*?)E+v", name)
        tmpl = tmpl.group(1) if tmpl else ""
        d64 = re.match(r"Li64(E|$)", tmpl) is not None
        if kernel in ("flash_fwd_mma_kernel", "bsn_sort_reg_kernel",
                      "ternary_matmul_mma_kernel") or (
                kernel.startswith("paged_") and d64):
            kept.append("Function : " + block)
        found.append(dict(kernel=kernel, template=tmpl, d64=d64,
                          hmma=len(re.findall(r"\bH(?:G)?MMA\b", block)),
                          imma=len(re.findall(r"\bI(?:G)?MMA\b", block)),
                          ldl=len(re.findall(r"\bLDL\b", block)),
                          stl=len(re.findall(r"\bSTL\b", block))))
    (OUT_DIR / "sass.txt").write_text("".join(kept))
    for f in found:
        f["d128"] = re.match(r"Li128(E|$)", f["template"]) is not None
        log(f"sass {f['kernel']}<{f['template']}>: {f['hmma']} HMMA, "
            f"{f['imma']} IMMA / IGMMA, {f['ldl']} LDL, {f['stl']} STL")
    # jamba's head dim: a spill there is recorded, not refused; the bf16
    # flash instances at D 128 must use the tensor cores
    d128 = [f for f in found if (f["kernel"].startswith("paged_")
                                 or f["kernel"].startswith("flash_"))
            and f["d128"]]
    log("paged and flash kernels at D 128 (local memory): " + "; ".join(
        f"{f['kernel']}<{f['template']}> {f['hmma']} HMMA {f['ldl']} LDL "
        f"{f['stl']} STL" for f in d128))
    flash128 = [f for f in d128 if f["kernel"] == "flash_fwd_mma_kernel"]
    if not flash128 or not all(f["hmma"] > 0 for f in flash128):
        raise AssertionError(f"flash_fwd_mma_kernel at D 128: tensor-core "
                             f"instructions missing: {flash128}")
    for kernel, count in (("flash_fwd_mma_kernel", 4),
                          ("paged_prefill_mma_kernel", 12)):
        inst = [f for f in found if f["kernel"] == kernel]
        if len(inst) != count or not all(f["hmma"] > 0 for f in inst):
            raise AssertionError(f"{kernel}: tensor-core instructions "
                                 f"missing: {inst}")
    inst = [f for f in found if f["kernel"] == "ternary_matmul_mma_kernel"]
    if len(inst) != 2 or not all(f["imma"] > 0 and f["ldl"] + f["stl"] == 0
                                 for f in inst):
        raise AssertionError(f"ternary_matmul_mma_kernel: IMMA missing or "
                             f"local memory used: {inst}")
    for kernel in ("flash_fwd_mma_kernel", "paged_prefill_mma_kernel",
                   "paged_decode_split_kernel"):
        d64 = [f for f in found if f["kernel"] == kernel and f["d64"]]
        if not d64 or any(f["ldl"] + f["stl"] for f in d64):
            raise AssertionError(f"{kernel} at D 64 uses local memory: "
                                 f"{d64}")
    return found


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_approx_bsn(torch, dev, gen):
    from repro_torch.core.bsn import default_approx_spec, spec_stages
    from repro_torch.core.sc_layers import COUNTS_BUDGET_BYTES
    from repro_torch.kernels.approx_bsn import (approx_bsn_cuda,
                                                approx_bsn_plain)
    cases = []
    # (label, rows, K): the adder's launches on the main path at 4 decode
    # slots, and lm_head's row block under the counts budget
    lm_rows = max(1, COUNTS_BUDGET_BYTES // (4 * 49408 * 2048))
    for label, rows, k in (("w_up 4 slots", 4 * 8192, 2048),
                           ("w_down 4 slots", 4 * 2048, 8192),
                           ("lm_head block", lm_rows * 49408, 2048)):
        spec = default_approx_spec(k, 8)
        x = torch.randint(-4, 5, (rows, 1), generator=gen, device=dev,
                          dtype=torch.int32)
        w = torch.randint(-1, 2, (1, k), generator=gen, device=dev,
                          dtype=torch.int32)
        counts = (x * w + 4).contiguous()        # partial-product counts
        kw = dict(in_bsl=spec.in_bsl, stages=spec_stages(spec))
        got = approx_bsn_cuda(counts, **kw)
        want = approx_bsn_plain(counts, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"approx_bsn {label}: kernel != plain")
        ms = time_ms(lambda: approx_bsn_cuda(counts, **kw))
        plain_ms = time_ms(lambda: approx_bsn_plain(counts, **kw), iters=5)
        b_ms, b_by = bound(rows * k * 4 + rows * 4, rows * k, FP32_OPS)
        cases.append(dict(label=label, rows=rows, width=k,
                          stages=list(kw["stages"]), max_abs_err=0,
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None))
        log(f"approx_bsn {label}: rows={rows} width={k} bit-exact "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f}")
    # a multi-stage spec with a non-pow2 stride, exercising the shared-
    # memory stage chain (not on the serving path; correctness only)
    counts = torch.randint(0, 9, (4096, 2048), generator=gen, device=dev,
                           dtype=torch.int32)
    stages = ((16, 2, 4), (8, 4, 3), (16, 0, 2))
    if not torch.equal(approx_bsn_cuda(counts, in_bsl=8, stages=stages),
                       approx_bsn_plain(counts, in_bsl=8, stages=stages)):
        raise AssertionError("approx_bsn multi-stage: kernel != plain")
    log("approx_bsn multi-stage (16,2,4)(8,4,3)(16,0,2): bit-exact")
    return cases


def _levels(torch, gen, dev, shape):
    return torch.randint(-ACT_BSL // 2, ACT_BSL // 2 + 1, shape,
                         generator=gen, device=dev, dtype=torch.int8)


def _ternary(torch, gen, dev, shape):
    return torch.randint(-1, 2, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def device_ms_per_call(torch, fn, calls=10):
    """Device time of one call of ``fn`` (its kernels' own time under
    torch.profiler, averaged over ``calls``): at decode shapes a call's
    host work (Python checks, the ctypes call) outlasts its kernel, so
    CUDA events around back-to-back calls would time the host."""
    fn()
    for _ in range(3):          # the profiler now and then records no kernel
        ms = device_ms(torch, lambda: [fn() for _ in range(calls)]) / calls
        if ms > 0:
            return ms
    # some library calls' kernels escape the profiler's trace: time them
    # with CUDA events over back-to-back calls (the host's launch work
    # included, where it outlasts the kernel)
    ms = time_ms(fn)
    log(f"device_ms_per_call: torch.profiler traced no kernel of "
        f"{getattr(fn, '__name__', fn)}; CUDA events give {ms:.4f} ms")
    return ms


def _int_mm_ms(torch, x, w):
    """``torch._int_mm`` where it takes the shape (it refuses M <= 16 and
    K, N not multiples of 8), else None."""
    try:
        torch._int_mm(x, w)
    except RuntimeError:
        return None
    return device_ms_per_call(torch, lambda: torch._int_mm(x, w))


def int_mm_yardstick(torch, x, w):
    """``torch._int_mm``'s device ms on the same operands, with ``w`` in
    the reference's (K, N) row-major layout and column-major (what
    cuBLASLt's int8 kernels prefer), both laid out outside the timed
    region; ``library_ms`` is the faster.  ``_int_mm`` refuses M <= 16,
    so a decode row times it on x zero-padded to 32 rows."""
    import torch.nn.functional as F
    m = x.shape[0]
    padded = m <= 16
    if padded:
        x = F.pad(x, (0, 0, 0, 32 - m))
    w_cm = w.t().contiguous().t()
    kn, cm = _int_mm_ms(torch, x, w), _int_mm_ms(torch, x, w_cm)
    known = [t for t in (kn, cm) if t is not None]
    return dict(library_ms=min(known) if known else None,
                int_mm_kn_ms=kn, int_mm_cm_ms=cm,
                library_note="_int_mm padded to 32 rows" if padded
                else "_int_mm")


def _full_range(torch, gen, dev, shape):
    return torch.randint(-128, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


# (label, M, K, N, out_bsl): decode at 4 lanes, the B = 1 oracle's
# 64-row prefill chunk, the engine's 256-row chunks (4 requests x 64),
# a stress shape the engine never runs (it takes logits only for each
# request's last row, so lm_head runs at M <= 4)
TERNARY_SHAPES = (
    [(f"decode {k}", 4, *GRANITE_PROJ[k], 0) for k in GRANITE_PROJ]
    + [(f"oracle prefill {k}", 64, *GRANITE_PROJ[k], 0)
       for k in ("q/o", "gate/up", "down")]
    + [(f"prefill {k}", 256, *GRANITE_PROJ[k], 0)
       for k in ("q/o", "k/v", "gate/up", "down")]
    + [("stress 256 x 2048 x 49408 (not on the serving path)", 256,
        *GRANITE_PROJ["lm_head"], 0),
       ("decode q/o SI", 4, 2048, 2048, 8),
       ("TNN layer SI", 256, 256, 256, 8),
       ("full int8 range", 256, 2048, 2048, 0),
       ("full int8 range SI", 64, 784, 256, 32),
       ("ragged", 5, 1001, 1003, 0), ("ragged SI", 5, 1001, 1003, 8),
       ("ragged M 64", 64, 1001, 1003, 0),
       ("ragged M 64 SI", 64, 1001, 1003, 8)]
    # phase 8's widest single products: rwkv6-7b's channel mix (d 4096,
    # d_ff 14336) and jamba-1.5-large's mamba in_proj (8192 -> 2 x 16384),
    # at 4 decode lanes and the engine's 256-row prefill chunks
    + [(f"{tag} {k}", m, kk, n, 0)
       for tag, m in (("decode", 4), ("prefill", 256))
       for k, kk, n in (("rwkv6 cmix wk", 4096, 14336),
                        ("rwkv6 cmix wv", 14336, 4096),
                        ("jamba in_proj", 8192, 32768))])


def check_ternary_matmul(torch, dev, gen, shapes=TERNARY_SHAPES):
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ternary_matmul_ref
    from repro_torch.kernels.ternary_matmul import ternary_matmul_cuda

    def stopgap(x, w):          # the float32 product it replaces
        return torch.round(torch.matmul(x.to(torch.float32),
                                        w.to(torch.float32))).to(torch.int32)

    cases = []
    for label, m, k, n, out_bsl in shapes:
        if label.startswith("full"):
            x = _full_range(torch, gen, dev, (m, k))
            w = _full_range(torch, gen, dev, (k, n))
        else:
            x = _levels(torch, gen, dev, (m, k))
            w = _ternary(torch, gen, dev, (k, n))
        t = None
        if out_bsl:
            lim = 128 * 128 * math.isqrt(k) if label.startswith("full") \
                else k
            t = torch.sort(torch.randint(-lim, lim + 1, (n, out_bsl),
                                         generator=gen, device=dev,
                                         dtype=torch.int32), dim=-1).values
        run = ops.ternary_matmul if label.startswith("ragged") \
            else ternary_matmul_cuda
        got = run(x, w, t)
        want = ternary_matmul_ref(x, w, t)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"ternary_matmul {label}: kernel != plain")
        ms = device_ms_per_call(torch, lambda: run(x, w, t))
        # with the host: the least of 5 means over 50 back-to-back calls
        # (host time on a shared machine scatters upward)
        call_ms = min(time_ms(lambda: run(x, w, t), iters=50)
                      for _ in range(5))
        plain_ms = device_ms_per_call(torch,
                                      lambda: ternary_matmul_ref(x, w, t))
        lib = dict(library_ms=None, library_note="none")
        stop_ms = None
        if t is None:
            lib = int_mm_yardstick(torch, x, w)
            stop_ms = device_ms_per_call(torch, lambda: stopgap(x, w))
        nbytes = m * k + k * n + 4 * m * n + 4 * n * out_bsl
        b_ms, b_by = bound(nbytes, 2 * m * n * k + m * n * out_bsl,
                           INT8_OPS)
        cases.append(dict(label=label, M=m, K=k, N=n, out_bsl=out_bsl,
                          max_abs_err=0, ms=ms, call_ms=call_ms,
                          plain_ms=plain_ms, stopgap_ms=stop_ms,
                          bound_ms=b_ms, bound_by=b_by, **lib))
        log(f"ternary_matmul {label}: M={m} K={k} N={n} out_bsl={out_bsl} "
            f"bit-exact device ms={ms:.4f} (per call with the host "
            f"{call_ms:.4f}) plain_ms={plain_ms:.4f} library_ms="
            f"{lib['library_ms']} ({lib['library_note']}; (K, N) "
            f"{lib.get('int_mm_kn_ms')}, column-major "
            f"{lib.get('int_mm_cm_ms')}) stopgap_ms={stop_ms} "
            f"bound_ms={b_ms:.4f} ({b_by}) bound/ms={b_ms / ms:.3f}")
    return cases


# (label, E, M, K, N): qwen3-moe-235b-a22b's expert products at decode
# (4 lanes: capacity 4 a expert) and at the engine's 256-row prefill
# chunk rounds (capacity 256 at cf = E / k), and a dbrx-like shape
BATCHED_SHAPES = (
    ("qwen3 decode gate/up", 128, 4, 4096, 1536),
    ("qwen3 decode down", 128, 4, 1536, 4096),
    ("qwen3 prefill gate/up", 128, 256, 4096, 1536),
    ("qwen3 prefill down", 128, 256, 1536, 4096),
    ("dbrx-like", 16, 32, 6144, 10752),
    # jamba-1.5-large's experts (16, d 8192, d_ff 24576; phase 8) at
    # decode and at the 256-row prefill chunk rounds (capacity 256 at
    # cf = E / k = 8)
    ("jamba decode gate/up", 16, 4, 8192, 24576),
    ("jamba decode down", 16, 4, 24576, 8192),
    ("jamba prefill gate/up", 16, 256, 8192, 24576),
    ("jamba prefill down", 16, 256, 24576, 8192))


def _expert_operands(torch, gen, dev, e, m, k, n):
    """Full int8 range, with the empty expert rows of a dispatch: every
    third expert's x all zero, and each expert's rows past a random fill
    of its capacity zero."""
    x = _full_range(torch, gen, dev, (e, m, k))
    w = _full_range(torch, gen, dev, (e, k, n))
    x[::3] = 0
    fill = torch.randint(0, m + 1, (e, 1), generator=gen, device=dev)
    x[torch.arange(m, device=dev)[None, :].expand(e, m) >= fill] = 0
    return x, w


def int_mm_experts_ms(torch, x, w):
    """Device ms of E back-to-back ``torch._int_mm`` calls, one per
    expert, w column-major and x zero-padded to 32 rows where M <= 16
    (``_int_mm`` refuses fewer), all laid out outside the timed region."""
    import torch.nn.functional as F
    e, m = x.shape[:2]
    xs = [F.pad(x[i], (0, 0, 0, 32 - m)) if m <= 16 else x[i]
          for i in range(e)]
    ws = [w[i].t().contiguous().t() for i in range(e)]

    def run():
        for a, b in zip(xs, ws):
            torch._int_mm(a, b)
    return device_ms_per_call(torch, run, calls=3)


def check_ternary_matmul_batched(torch, dev, gen, shapes=BATCHED_SHAPES):
    """The batched ternary matmul (E products, one launch) against its
    plain version, bit for bit, at the MoE expert shapes."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ternary_matmul_ref
    cases = []
    for label, e, m, k, n in shapes:
        x, w = _expert_operands(torch, gen, dev, e, m, k, n)
        got = ops.ternary_matmul(x, w)
        want = ternary_matmul_ref(x, w)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"batched ternary_matmul {label}: kernel "
                                 f"!= plain")
        del got, want
        ms = device_ms_per_call(torch, lambda: ops.ternary_matmul(x, w))
        plain_ms = device_ms_per_call(torch,
                                      lambda: ternary_matmul_ref(x, w),
                                      calls=2)
        lib_ms = int_mm_experts_ms(torch, x, w)
        nbytes = e * k * n + e * m * k + 4 * e * m * n
        b_ms, b_by = bound(nbytes, 2 * e * m * n * k, INT8_OPS)
        cases.append(dict(label=label, E=e, M=m, K=k, N=n, max_abs_err=0,
                          ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          library_note=f"{e} x _int_mm, w column-major",
                          bound_ms=b_ms, bound_by=b_by))
        log(f"ternary_matmul batched {label}: E={e} M={m} K={k} N={n} "
            f"bit-exact device ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} ({e} x _int_mm, w column-major) "
            f"bound_ms={b_ms:.4f} ({b_by}) bound/ms={b_ms / ms:.3f}")
        del x, w
        torch.cuda.empty_cache()
    return cases


def check_temporal(torch, dev, gen):
    from repro_torch.core.bsn import default_approx_spec, spec_stages
    from repro_torch.kernels.approx_bsn import (approx_bsn_temporal_cuda,
                                                approx_bsn_temporal_plain)
    cases = []
    # (label, rows, width, cycles): w_up at 4 decode slots, K = 2048
    # folded onto a 256-wide adder over 8 cycles; and 2 cycles of 1024
    for label, rows, width, cycles in (("w_up 4 slots T8", 4 * 8192, 256, 8),
                                       ("w_up 4 slots T2", 4 * 8192, 1024,
                                        2)):
        spec = default_approx_spec(width, ACT_BSL)
        x = _levels(torch, gen, dev, (rows, 1)).to(torch.int32)
        w = _ternary(torch, gen, dev, (1, width * cycles)).to(torch.int32)
        counts = (x * w + ACT_BSL // 2).contiguous()
        kw = dict(in_bsl=ACT_BSL, stages=spec_stages(spec), cycles=cycles)
        got = approx_bsn_temporal_cuda(counts, **kw)
        want = approx_bsn_temporal_plain(counts, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"approx_bsn_temporal {label}: kernel != "
                                 f"plain")
        ms = time_ms(lambda: approx_bsn_temporal_cuda(counts, **kw))
        plain_ms = time_ms(lambda: approx_bsn_temporal_plain(counts, **kw),
                           iters=5)
        total = cycles * width
        b_ms, b_by = bound(rows * total * 4 + rows * 4, rows * total,
                           FP32_OPS)
        cases.append(dict(label=label, rows=rows, width=width,
                          cycles=cycles, stages=list(kw["stages"]),
                          max_abs_err=0, ms=ms, plain_ms=plain_ms,
                          library_ms=None, bound_ms=b_ms, bound_by=b_by))
        log(f"approx_bsn_temporal {label}: rows={rows} width={width} "
            f"cycles={cycles} bit-exact ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={b_ms:.4f}")
    return cases


def _exact_bsn_bits(torch, x_q, w_int):
    """The exact BSN's input for every (token, output channel): the K
    ternary products as thermometer codes, ``(T, N, K, act_bsl)`` int8."""
    from repro_torch.core.coding import encode_thermometer
    from repro_torch.core.multiplier import ternary_scale_bits
    bits = encode_thermometer(x_q, ACT_BSL)              # (T, K, L)
    return ternary_scale_bits(w_int.t(), bits[:, None])


def sort_bound(nbytes, rows, length):
    levels = length.bit_length() - 1
    exchanges = rows * (length // 2) * levels * (levels + 1) // 2
    return bound(nbytes, 2 * exchanges, FP32_OPS)


def check_bsn_sort(torch, dev, gen):
    from repro_torch.kernels.bsn_sort import bsn_sort_cuda, bsn_sort_plain
    cases = []
    # the exact BSN of q_proj at 4 tokens: one row per (token, channel) of
    # K * act_bsl = 16384 bits (phase 5 checks its popcounts against the
    # integer path); then the other dtypes the sort takes
    k, n = GRANITE_PROJ["q/o"]
    x_q = _levels(torch, gen, dev, (4, k))
    w = _ternary(torch, gen, dev, (k, n))
    bits = _exact_bsn_bits(torch, x_q, w).reshape(4 * n, k * ACT_BSL)
    rows_i32 = torch.randint(-2 ** 31, 2 ** 31 - 1, (4096, 1024),
                             generator=gen, device=dev, dtype=torch.int32)
    rows_f32 = torch.randn((4096, 1024), generator=gen, device=dev)
    for label, x in (("exact BSN q_proj 4 tokens", bits),
                     ("int32 4096 x 1024", rows_i32),
                     ("float32 4096 x 1024", rows_f32)):
        got = bsn_sort_cuda(x)
        want = bsn_sort_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"bsn_sort {label}: kernel != plain")
        ms = time_ms(lambda: bsn_sort_cuda(x))
        plain_ms = time_ms(lambda: bsn_sort_plain(x), iters=3, warmup=1)
        lib_ms = time_ms(lambda: torch.sort(x, dim=-1, descending=True))
        rows, length = x.shape
        b_ms, b_by = sort_bound(2 * x.numel() * x.element_size(), rows,
                                length)
        cases.append(dict(label=label, rows=rows, L=length,
                          dtype=str(x.dtype), max_abs_err=0, ms=ms,
                          plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by))
        log(f"bsn_sort {label}: bit-exact ms={ms:.4f} plain_ms={plain_ms:.4f}"
            f" library_ms(torch.sort)={lib_ms:.4f} bound_ms={b_ms:.4f} "
            f"({b_by})")
    return cases


def _pools(torch, gen, dev, fmt, N, page, Hkv, D):
    from repro_torch.core.kv_quant import kv_quant
    pools = {}
    for name in ("k", "v"):
        x = torch.randn((N, page, Hkv, D), generator=gen, device=dev)
        qd = kv_quant(x.to(torch.bfloat16), fmt)
        pools[f"{name}_pages"] = qd["q"].contiguous()
        if "scale" in qd:
            pools[f"{name}_scale"] = qd["scale"].contiguous()
        if "resid" in qd:
            pools[f"{name}_resid"] = qd["resid"].contiguous()
    return pools


def _poison(torch, pools, pages):
    """Big codes AND big scales on ``pages``: any leak is loud."""
    out = {k: v.clone() for k, v in pools.items()}
    idx = torch.as_tensor(sorted(pages), device=next(iter(pools.values()))
                          .device, dtype=torch.long)
    for v in out.values():
        v[idx] = 127 if v.dtype == torch.int8 else 3.0e4
    return out


def _kv_bytes_per_pos(fmt, Hkv, D):
    """Bytes one cached position costs per K or V (codes+scales+resid)."""
    return {"fp": 2 * Hkv * D, "int8": Hkv * D + 4 * Hkv,
            "sc": 2 * Hkv * D + 4 * Hkv}[fmt]


def _gathered_heads(torch, pools, aux, tables, fmt, group):
    """The window the plain version attends, gathered and dequantized, as
    SDPA's (lanes, Hq, T, D) bf16 K and V (each KV head repeated
    ``group`` times): the yardstick's inputs, made outside its timing."""
    from repro_torch.kernels.ref import gather_pages_dequant
    out = []
    for name in ("k", "v"):
        g = gather_pages_dequant(pools[f"{name}_pages"], tables,
                                 kv_format=fmt, scale=aux.get(f"{name}_scale"),
                                 resid=aux.get(f"{name}_resid"))
        out.append(g.to(torch.bfloat16).permute(0, 2, 1, 3)
                   .repeat_interleave(group, dim=1))
    return out


def _attn_times(torch, kernel, plain, sdpa):
    """Device ms per call of the kernel, its plain version and SDPA
    (torch.profiler), and the kernel's and SDPA's time per call with the
    host (CUDA events over back-to-back calls)."""
    return dict(ms=device_ms_per_call(torch, kernel),
                call_ms=time_ms(kernel),
                plain_ms=device_ms_per_call(torch, plain, calls=3),
                library_ms=device_ms_per_call(torch, sdpa),
                library_call_ms=time_ms(sdpa))


# decode shapes: (label prefix, S, maxp, lengths).  "serving": 8 lanes,
# a padded lane (length 0, all-trash table), lengths with (len + 1) %
# page in {0, 1, page - 1} and a full window; "4096": 32 ragged lanes
# of 1024-4095 tokens (granite-3-2b's context).
def _decode_shapes(page):
    long_lens = [1024 + 99 * i for i in range(32)]
    long_lens[-1] = 4095
    return (("", 8, 16, [0, page - 1, page, 2 * page - 2, 37, 100, 150,
                         16 * page - 1]),
            ("4096 ", 32, 256, long_lens))


# jamba-1.5-large's attention (phase 8: Hkv 8, G 8, D 128): its 4 decode
# lanes of 32-135 tokens (phase 8's traffic) and a padded lane
JAMBA_ATTN = dict(G=8, D=128)
JAMBA_DECODE_SHAPES = (("jamba D128 ", 5, 16, [0, 32, 57, 96, 135]),)


def check_decode(torch, dev, gen, G=4, D=64, shapes=None):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attn_decode_cuda
    from repro_torch.kernels.ref import paged_attn_decode_ref
    Hkv, page = 8, 16
    cases = []
    for prefix, S, maxp, lens in shapes or _decode_shapes(page):
        N = S * maxp + 1
        perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
        tables = perm[:S * maxp].reshape(S, maxp).to(torch.int32)
        if lens[0] == 0:
            tables[0] = 0
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((S, Hkv, G, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        for fmt in ("fp", "int8", "sc"):
            label = prefix + fmt
            pools = _pools(torch, gen, dev, fmt, N, page, Hkv, D)
            aux = {k: v for k, v in pools.items()
                   if not k.endswith("_pages")}
            args = (q, pools["k_pages"], pools["v_pages"], tables, lengths)
            got = paged_attn_decode_cuda(*args, kv_format=fmt, **aux)
            want = paged_attn_decode_ref(*args, kv_format=fmt, kv_aux=aux)
            # poison the trash page and every page past each live length
            tab = tables.tolist()
            dead = {0} | {tab[s][j] for s in range(S)
                          for j in range(lens[s] // page + 1, maxp)}
            pp = _poison(torch, pools, dead)
            paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
            pois = paged_attn_decode_cuda(q, pp["k_pages"], pp["v_pages"],
                                          tables, lengths, kv_format=fmt,
                                          **paux)
            del pp, paux
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            if not (err <= ATTN_ATOL and torch.isfinite(got.float()).all()):
                raise AssertionError(f"decode {label}: max_abs_err {err}")
            # a padded lane attends the trash page itself (its own write)
            live = slice(1, None) if lens[0] == 0 else slice(None)
            if not torch.equal(pois[live], got[live]):
                raise AssertionError(f"decode {label}: poisoned pages "
                                     f"leaked")
            # yardstick: one SDPA call on the gathered, dequantized window
            kh, vh = _gathered_heads(torch, pools, aux, tables, fmt, G)
            qh = q.reshape(S, Hkv * G, 1, D)
            mask = (torch.arange(maxp * page, device=dev)[None, :]
                    <= lengths[:, None])[:, None, None, :]
            times = _attn_times(
                torch,
                lambda: paged_attn_decode_cuda(*args, kv_format=fmt, **aux),
                lambda: paged_attn_decode_ref(*args, kv_format=fmt,
                                              kv_aux=aux),
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       attn_mask=mask))
            del kh, vh
            n_live = sum(n + 1 for n in lens)
            nbytes = (2 * q.numel() * 2 + tables.numel() * 4 + S * 4
                      + 2 * n_live * _kv_bytes_per_pos(fmt, Hkv, D))
            b_ms, b_by = bound(nbytes, 4 * n_live * Hkv * G * D, BF16_OPS)
            cases.append(dict(label=label, S=S, Hkv=Hkv, G=G, D=D,
                              page=page, maxp=maxp, lengths=lens,
                              max_abs_err=err, **times, bound_ms=b_ms,
                              bound_by=b_by))
            log(f"paged_attn_decode {label}: S={S} maxp={maxp} "
                f"max_abs_err={err:.3g} poison-invisible device ms="
                f"{times['ms']:.4f} (per call with the host "
                f"{times['call_ms']:.4f}) plain_ms={times['plain_ms']:.4f} "
                f"library_ms(SDPA)={times['library_ms']:.4f} (with the "
                f"host {times['library_call_ms']:.4f}) bound_ms={b_ms:.5f} "
                f"({b_by})")
            del pools, aux, got, want, pois
    return cases


# prefill shapes: (label prefix, start, width).  "serving": the second
# chunk of a 128-token prompt; "4096": the last 64-token chunk of a
# 4096-token prompt at the engine's default prefill_chunk.
PREFILL_SHAPES = (("", 64, 8), ("4096 ", 4032, 256))
JAMBA_PREFILL_SHAPES = (("jamba D128 ", 64, 8),)


def check_prefill(torch, dev, gen, G=4, D=64, shapes=PREFILL_SHAPES):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attn_prefill_cuda
    from repro_torch.kernels.ref import paged_attn_prefill_ref
    Gr, C, Hkv, Gq, page = 4, 64, 8, G, 16
    cases = []
    for prefix, start, width in shapes:
        N = Gr * width + 1
        perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
        tables = perm[:Gr * width].reshape(Gr, width).to(torch.int32) \
            .contiguous()
        q = torch.randn((Gr, C, Hkv, Gq, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        seen = (start + C) // page
        for fmt in ("fp", "int8", "sc"):
            label = prefix + fmt
            pools = _pools(torch, gen, dev, fmt, N, page, Hkv, D)
            aux = {k: v for k, v in pools.items()
                   if not k.endswith("_pages")}
            args = (q, pools["k_pages"], pools["v_pages"], tables)
            got = paged_attn_prefill_cuda(*args, start=start, kv_format=fmt,
                                          **aux)
            got2 = paged_attn_prefill_cuda(*args, start=start, block_q=16,
                                           kv_format=fmt, **aux)
            want = paged_attn_prefill_ref(*args, start, kv_format=fmt,
                                          kv_aux=aux)
            tab = tables.tolist()
            dead = {0} | {tab[g][j] for g in range(Gr)
                          for j in range(seen, width)}
            pp = _poison(torch, pools, dead)
            paux = {k: v for k, v in pp.items() if not k.endswith("_pages")}
            pois = paged_attn_prefill_cuda(q, pp["k_pages"], pp["v_pages"],
                                           tables, start=start,
                                           kv_format=fmt, **paux)
            del pp, paux
            torch.cuda.synchronize()
            err = max((got.float() - want.float()).abs().max().item(),
                      (got2.float() - want.float()).abs().max().item())
            if not (err <= ATTN_ATOL and torch.isfinite(got.float()).all()):
                raise AssertionError(f"prefill {label}: max_abs_err {err}")
            if not torch.equal(pois, got):
                raise AssertionError(f"prefill {label}: poisoned pages "
                                     f"leaked")
            kh, vh = _gathered_heads(torch, pools, aux, tables[:, :seen],
                                     fmt, Gq)
            qh = q.reshape(Gr, C, Hkv * Gq, D).permute(0, 2, 1, 3)
            T = seen * page
            mask = (torch.arange(T, device=dev)[None, :]
                    <= start + torch.arange(C, device=dev)[:, None])
            times = _attn_times(
                torch,
                lambda: paged_attn_prefill_cuda(*args, start=start,
                                                kv_format=fmt, **aux),
                lambda: paged_attn_prefill_ref(*args, start, kv_format=fmt,
                                               kv_aux=aux),
                lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                       attn_mask=mask))
            del kh, vh
            times["ms_block_q16"] = device_ms_per_call(
                torch, lambda: paged_attn_prefill_cuda(
                    *args, start=start, block_q=16, kv_format=fmt, **aux))
            pairs = sum(start + c + 1 for c in range(C))    # causal (q, k)
            nbytes = (2 * q.numel() * 2 + tables.numel() * 4
                      + 2 * Gr * T * _kv_bytes_per_pos(fmt, Hkv, D))
            b_ms, b_by = bound(nbytes, 4 * Gr * pairs * Hkv * Gq * D,
                               BF16_OPS)
            cases.append(dict(label=label, G=Gr, C=C, Hkv=Hkv, Gq=Gq, D=D,
                              page=page, start=start, width=width,
                              max_abs_err=err, **times, bound_ms=b_ms,
                              bound_by=b_by))
            log(f"paged_attn_prefill {label}: start={start} "
                f"max_abs_err={err:.3g} (block_q 32, 16) poison-invisible "
                f"device ms={times['ms']:.4f} (per call with the host "
                f"{times['call_ms']:.4f}) plain_ms={times['plain_ms']:.4f} "
                f"library_ms(SDPA)={times['library_ms']:.4f} (with the "
                f"host {times['library_call_ms']:.4f}) bound_ms={b_ms:.5f} "
                f"({b_by}); block_q 16: {times['ms_block_q16']:.4f}")
            del pools, aux, got, got2, want, pois
    return cases


FLASH_SHAPE = dict(B=2, S=4096, Hq=32, Hkv=8, D=64)   # phase 6's attention
# jamba-1.5-large's attention layers over a train_4k sequence
JAMBA_FLASH_SHAPE = dict(B=1, S=4096, Hq=64, Hkv=8, D=128)
LSE_ATOL = 1e-4         # float32 log-sum-exp, sums in another order
FLASH_F32_TOL = 1e-5    # the float32 kernel: O and LSE, float32 sums
GRAD_TOL = 1e-4         # float32 gradients against autograd


def _flash_inputs(torch, gen, dev, B, S, Hq, Hkv, D, dtype):
    return tuple(torch.randn((B, S, h, D), generator=gen, device=dev)
                 .to(dtype) for h in (Hq, Hkv, Hkv))


def flash_bound(B, S, Hq, Hkv, D, causal, itemsize=2):
    """q, k, v, o read / written once plus the float32 LSE; 4 D operations
    per (query, key) pair the mask keeps (q.k and p.v), at the bf16
    tensor-core peak (``itemsize`` 2) or the float32 CUDA-core peak (4)."""
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = itemsize * B * S * D * (2 * Hq + 2 * Hkv) + 4 * B * Hq * S
    return bound(nbytes, 4 * B * Hq * pairs * D,
                 BF16_OPS if itemsize == 2 else FP32_OPS)


def p_rounding_error(torch, q, k, v, rows=512):
    """What rounding P does to O, on the first ``rows`` causal query rows
    (those that see few keys, where one weight moves O most): P as one
    bf16 term, and as the kernel's bf16 hi + lo terms, each against
    float32 P; outputs cast to bf16 as the kernel's are.  Returns
    {name: (max |dO|, outputs off by more than ATTN_ATOL)}."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q[:, :rows].float().reshape(B, rows, Hkv, Hq // Hkv, D) / math.sqrt(D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, :rows].float())
    keep = torch.tril(torch.ones((rows, rows), dtype=torch.bool,
                                 device=q.device))
    p = torch.exp(s.masked_fill(~keep, float("-inf"))
                  - s.masked_fill(~keep, float("-inf")).amax(-1, True))
    l = p.sum(-1, keepdim=True)

    def out(pp):
        return (torch.einsum("bhgqk,bkhd->bhgqd", pp, v[:, :rows].float())
                / l).to(torch.bfloat16).float()
    exact = out(p)
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    res = {}
    for name, pp in (("one_bf16_term", hi), ("bf16_hi_lo", hi + lo)):
        err = (out(pp) - exact).abs()
        res[name] = (err.max().item(), int((err > ATTN_ATOL).sum().item()))
    return res


def check_flash(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref
    cases = []
    # bf16 runs the tensor-core kernel, float32 the CUDA-core one
    for label, shp, causal, dtype in (
            ("train B2 S4096 causal", FLASH_SHAPE, True, torch.bfloat16),
            ("jamba B1 S4096 Hq64 Hkv8 D128 causal", JAMBA_FLASH_SHAPE,
             True, torch.bfloat16),
            ("ragged S1000 bidirectional GQA",
             dict(B=1, S=1000, Hq=8, Hkv=2, D=64), False, torch.bfloat16),
            ("float32 S1024 causal GQA",
             dict(B=1, S=1024, Hq=8, Hkv=2, D=64), True, torch.float32)):
        q, k, v = _flash_inputs(torch, gen, dev, **shp, dtype=dtype)
        out, lse = flash_attention_cuda(q, k, v, causal=causal)
        want, want_lse = flash_attention_ref(q, k, v, causal,
                                             return_lse=True)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        o_tol, l_tol = ((ATTN_ATOL, LSE_ATOL) if dtype == torch.bfloat16
                        else (FLASH_F32_TOL, FLASH_F32_TOL))
        if not (err <= o_tol and lse_err <= l_tol
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"flash {label}: max_abs_err {err}, lse "
                                 f"{lse_err}")
        del want, want_lse
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal),
                     iters=10)
        plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal),
                           iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal, enable_gqa=True), iters=10)
        b_ms, b_by = flash_bound(**shp, causal=causal,
                                 itemsize=q.element_size())
        cases.append(dict(label=label, **shp, causal=causal,
                          dtype=str(dtype), max_abs_err=err,
                          lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"flash_attention {label}: max_abs_err={err:.3g} lse_err="
            f"{lse_err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms(SDPA)={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by})")
        if shp is FLASH_SHAPE:
            cases[-1]["p_rounding"] = pr = p_rounding_error(torch, q, k, v)
            log("flash P operand, first 512 rows: " + "; ".join(
                f"{n} max |dO| {e:.3g}, {c} outputs over {ATTN_ATOL}"
                for n, (e, c) in pr.items()))
    # the gradient: the kernel's LSE and the blocked backward against
    # autograd through the plain version, float32, at D 64 and at jamba's
    # D 128 (the CUDA-core kernel's two instances)
    grad_errs = {}
    for D, Hq, Hkv in ((64, 8, 2), (128, 16, 2)):
        q, k, v = _flash_inputs(torch, gen, dev, B=2, S=512, Hq=Hq, Hkv=Hkv,
                                D=D, dtype=torch.float32)
        g = torch.randn(q.shape, generator=gen, device=dev)
        leaves = tuple(t.requires_grad_() for t in (q, k, v))
        got = torch.autograd.grad(dispatch.flash_attention(*leaves), leaves,
                                  g)
        want = torch.autograd.grad(flash_attention_ref(*leaves), leaves, g)
        grad_errs[D] = max((a - b).abs().max().item()
                           for a, b in zip(got, want))
    grad_err = max(grad_errs.values())
    if not grad_err <= GRAD_TOL:
        raise AssertionError(f"flash backward: max_abs_err {grad_errs}")
    # the backward's time at phase 6's shape (PyTorch ops, not a kernel)
    q, k, v = _flash_inputs(torch, gen, dev, **FLASH_SHAPE,
                            dtype=torch.bfloat16)
    leaves = tuple(t.requires_grad_() for t in (q, k, v))
    g = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    out = dispatch.flash_attention(*leaves)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                 retain_graph=True),
                     iters=3, warmup=1)
    log(f"flash backward B2 S512 float32: max_abs_err D64 "
        f"{grad_errs[64]:.3g}, D128 {grad_errs[128]:.3g} (tol {GRAD_TOL}); "
        f"backward at the train shape (PyTorch ops) {bwd_ms:.2f} ms")
    cases[0].update(grad_max_abs_err=grad_errs[64], backward_ms=bwd_ms)
    cases[1].update(grad_max_abs_err=grad_errs[128])
    return cases


# ---------------------------------------------------------------------------
# phase 4: the serving main path at full width
# ---------------------------------------------------------------------------

PAIRS = (("qat", "fp"), ("sc_int", "int8"), ("sc_int_approx", "sc"))
PATH_KERNELS = {"qat": ("paged_attn_decode", "paged_attn_prefill"),
                "sc_int": ("paged_attn_decode", "paged_attn_prefill",
                           "ternary_matmul"),
                "sc_int_approx": ("paged_attn_decode", "paged_attn_prefill",
                                  "approx_bsn")}


def _dev_us(e):
    return getattr(e, "self_device_time_total", None) \
        or getattr(e, "self_cuda_time_total", 0)


def _time_batched():
    """Put a pair of CUDA events around every batched ternary matmul (the
    MoE experts'), so that a profiled run reads their device time apart
    from the single products' (the same kernels; the profiler does not
    tie a kernel launched through ctypes to a ``record_function`` range).
    Returns a function that undoes it and gives the device ms."""
    import torch
    from repro_torch.kernels import ops
    inner = ops.ternary_matmul_cuda
    pairs = []

    def timed(x, w, t=None):
        if x.ndim != 3:
            return inner(x, w, t)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(x, w, t)
        end.record()
        pairs.append((start, end))
        return out
    ops.ternary_matmul_cuda = timed

    def finish():
        ops.ternary_matmul_cuda = inner
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs)
    return finish


def profile_decode_step(torch, eng, label, step_ms):
    """One decode step under torch.profiler: device time by kernel, and
    the device's idle share of the step, both against the profiled wall
    time (which the profiler's own host work inflates) and against
    ``step_ms``, the same engine's unprofiled mean decode step; and the
    device ms of the batched ternary matmul's launches (the MoE experts)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    finish = _time_batched()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batched_ms = finish()
    events = prof.key_averages()
    # busy = the kernels themselves; the top list names the PyTorch ops
    # (host-side events) that launched them
    cuda = torch.autograd.DeviceType.CUDA
    busy_ms = sum(_dev_us(e) for e in events if e.device_type == cuda) / 1e3
    rows = sorted(((_dev_us(e), e.key, e.count) for e in events
                   if e.device_type != cuda and _dev_us(e) > 0),
                  reverse=True)
    (OUT_DIR / f"profile_{label}.txt").write_text(events.table(
        sort_by="self_cuda_time_total", row_limit=40))
    top = [dict(name=k, ms=us / 1e3, calls=n) for us, k, n in rows[:10]]
    ours_ms = sum(_dev_us(e) for e in events if e.device_type == cuda and any(
        k in e.key for k in ("decode_kernel", "prefill_kernel",
                             "paged_decode_", "paged_prefill_",
                             "approx_bsn_kernel", "ternary_matmul_",
                             "bsn_sort_reg_kernel"))) / 1e3
    idle = 1 - busy_ms / wall_ms
    idle_unprofiled = 1 - busy_ms / step_ms
    log(f"profile {label}: step wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy_ms:.1f} idle_share={idle:.3f} (vs unprofiled step "
        f"{step_ms:.1f} ms: {idle_unprofiled:.3f}) port_kernels_ms="
        f"{ours_ms:.2f} batched_ternary_matmul_ms={batched_ms:.3f} top ops: "
        + "; ".join(f"{t['name']} {t['ms']:.2f} ms x{t['calls']}"
                    for t in top[:6]))
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=idle,
                idle_share_unprofiled=idle_unprofiled,
                port_kernels_ms=ours_ms,
                batched_ternary_matmul_ms=batched_ms, top=top)


def profile_prefill(torch, eng, label):
    """The engine's batched chunked prefill of its queued prompts under
    torch.profiler: device ms and launches of each ``ternary_matmul``
    kernel instance (by the profiler's kernel names), the batched
    launches' device ms, the device busy ms and idle share of the whole
    prefill and the PyTorch ops that take the device time."""
    import re
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    finish = _time_batched()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._admit()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        batched_ms = finish()
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == cuda]
    kernels = {}
    for e in events:
        hit = re.search(r"(ternary_matmul\w*_kernel<[^>]*>)", e.key)
        if hit:
            k = kernels.setdefault(hit.group(1), dict(ms=0.0, launches=0))
            k["ms"] += _dev_us(e) / 1e3
            k["launches"] += e.count
    busy = sum(_dev_us(e) for e in events) / 1e3
    rows = sorted(((_dev_us(e), e.key, e.count) for e in averages
                   if e.device_type != cuda and _dev_us(e) > 0),
                  reverse=True)
    res = dict(device_busy_ms=busy, wall_ms=wall_ms,
               idle_share=1 - busy / wall_ms,
               ternary_matmul_ms=sum(k["ms"] for k in kernels.values()),
               batched_ternary_matmul_ms=batched_ms,
               ternary_matmul_kernels=kernels,
               top=[dict(name=k, ms=us / 1e3, calls=n)
                    for us, k, n in rows[:10]])
    log(f"profile prefill {label}: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy:.2f} idle_share={res['idle_share']:.3f} ternary_matmul "
        f"device ms={res['ternary_matmul_ms']:.3f} (batched "
        f"{res['batched_ternary_matmul_ms']:.3f}) by kernel: "
        + "; ".join(f"{name} {k['ms']:.3f} ms x{k['launches']}"
                    for name, k in sorted(kernels.items()))
        + " top ops: " + "; ".join(f"{t['name']} {t['ms']:.2f} ms "
                                   f"x{t['calls']}" for t in res["top"][:6]))
    return res


def _dense_weights(tree):
    """Every projection weight ``w`` under ``tree`` (a params subtree)."""
    if isinstance(tree, dict):
        if "w" in tree:
            return [tree["w"]]
        return [w for v in tree.values() for w in _dense_weights(v)]
    if isinstance(tree, list):
        return [w for v in tree for w in _dense_weights(v)]
    return []


def device_ms(torch, fn):
    """Device busy ms of one call of ``fn``: the kernels' own time under
    torch.profiler, free of the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(_dev_us(e) for e in prof.key_averages()
               if e.device_type == cuda) / 1e3


def product_cost(torch, dev, params, cfg, rows=4):
    """Device ms of one decode step's float products at ``rows`` lanes,
    every layer's own weights in turn: ``models.common.matmul_rows`` (the
    qat and unquantized path: float64 casts for batch invariance) against
    one bf16 ``torch.matmul`` on the same operands (a yardstick, not
    batch-invariant), and the time to read the bf16 weights once."""
    from repro_torch.models.common import matmul_rows
    gen = torch.Generator(dev).manual_seed(SEED)
    ws = [w for lp in params["layers"] for w in _dense_weights(lp)]
    ws.append(params["lm_head"]["w"])
    xs = [torch.randn((rows, w.shape[0]), generator=gen, device=dev)
          .to(w.dtype) for w in ws]

    def step(product):
        for x, w in zip(xs, ws):
            product(x, w)

    step(matmul_rows)                       # warm up both
    step(torch.matmul)
    res = dict(rows=rows, matmul_rows_ms=device_ms(
                   torch, lambda: step(matmul_rows)),
               bf16_matmul_ms=device_ms(torch, lambda: step(torch.matmul)),
               weight_read_bound_ms=sum(w.numel() * w.element_size()
                                        for w in ws) / HBM_BPS * 1e3,
               # one large product: CUDA events over repeated calls
               lm_head_matmul_rows_ms=time_ms(
                   lambda: matmul_rows(xs[-1], ws[-1])),
               lm_head_bf16_matmul_ms=time_ms(
                   lambda: torch.matmul(xs[-1], ws[-1])))
    log(f"float products of one decode step at {rows} lanes (device ms): "
        f"matmul_rows (float64) {res['matmul_rows_ms']:.2f}, bf16 "
        f"torch.matmul {res['bf16_matmul_ms']:.2f}, bf16 weight read bound "
        f"{res['weight_read_bound_ms']:.2f}; lm_head alone "
        f"{res['lm_head_matmul_rows_ms']:.3f} / "
        f"{res['lm_head_bf16_matmul_ms']:.3f}")
    return res


def serve_pair(torch, dev, cfg, params, prompts, datapath, fmt,
               new_tokens, kernels):
    """Serve ``prompts`` through ``ServeEngine`` (4 slots, pages of 16,
    prefill chunks of 64) on one datapath x kv_format pair, the launch
    counts set to 0 just before and read just after: every kernel of
    ``kernels`` must have launched and the batched tokens must equal the
    paged oracle's (``_paged_sequential_generate``: one request at a time
    on a private paged cache, for every format).  Returns (result, a
    function that makes the same engine afresh with the prompts
    queued)."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.engine import (_cfg_for_datapath,
                                            _paged_sequential_generate)

    def engine():
        eng = ServeEngine(params, cfg, max_slots=4, max_len=256,
                          page_size=16, prefill_chunk=64, datapath=datapath,
                          kv_format=fmt, device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=new_tokens)
        return eng

    eng = engine()
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._admit()                       # batched chunked prefill
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    done, steps = [], 0
    t1 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        done += eng.step()
        steps += 1
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t1
    launches = dict(kbuild.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    tag = f"{cfg.name} {datapath}x{fmt}"
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    got = [r.generated for r in sorted(done, key=lambda r: r.rid)]
    if len(got) != len(prompts):
        raise AssertionError(f"{tag}: {len(got)} of {len(prompts)} "
                             f"requests finished")
    want = _paged_sequential_generate(
        params, _cfg_for_datapath(cfg, datapath), prompts, new_tokens, None,
        256, fmt, 16, dev)
    if got != want:
        raise AssertionError(f"{tag}: batched tokens differ from the "
                             f"paged oracle\n{got}\n{want}")
    if any(not 0 <= t < cfg.vocab_size for g in got for t in g):
        raise AssertionError(f"{tag}: token out of vocab")
    n_tok = sum(len(g) for g in got)
    res = dict(datapath=datapath, kv_format=fmt, layers=cfg.n_layers,
               prompt_lens=[len(p) for p in prompts], new_tokens=new_tokens,
               prefill_ms=t_prefill * 1e3, decode_steps=steps,
               decode_ms_per_step=t_decode * 1e3 / max(steps, 1),
               tokens_per_s=n_tok / (t_prefill + t_decode),
               max_memory_allocated=peak, launches=launches,
               tokens=got, tokens_equal_sequential=True)
    log(f"serve {tag}: prefill_ms={res['prefill_ms']:.1f} "
        f"decode_ms_per_step={res['decode_ms_per_step']:.1f} "
        f"steps={steps} tokens/s={res['tokens_per_s']:.2f} "
        f"max_memory_allocated={peak / 2**30:.2f} GiB "
        f"launches={launches} batched==sequential")
    return res, engine


def _prompts(torch, cfg, plens):
    rng = torch.Generator().manual_seed(SEED)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
            for n in plens]


def serve(torch, dev, layers):
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import init_params
    cfg = get_arch("granite-3-2b")
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    log(f"init_params granite-3-2b layers={layers} d_model={cfg.d_model} "
        f"vocab={cfg.padded_vocab} dtype={cfg.dtype}: "
        f"{time.perf_counter() - t0:.1f} s")
    prompts = _prompts(torch, cfg, (32, 57, 96, 128))
    totals = dict.fromkeys(kbuild.KERNELS, 0)
    results = []
    for datapath, fmt in PAIRS:
        res, engine = serve_pair(torch, dev, cfg, params, prompts, datapath,
                                 fmt, NEW_TOKENS, PATH_KERNELS[datapath])
        for k, v in res["launches"].items():
            totals[k] += v
        results.append(res)
        eng = engine()                      # profile a fresh third step
        eng.step()
        eng.step()
        res["profile"] = profile_decode_step(torch, eng, f"{datapath}_{fmt}",
                                             res["decode_ms_per_step"])
        if datapath == "sc_int":
            res["profile_prefill"] = profile_prefill(
                torch, engine(), f"{datapath}_{fmt}")
        del eng
    return results, totals, product_cost(torch, dev, params, cfg)


TINY_SCALE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  vocab_pad_multiple=32, dtype="float32")
# tiny float32 configs held card == CPU: granite, and qwen3 / dbrx /
# rwkv6 / jamba at the reference's REDUCED sizes (tests/
# test_models_smoke.py)
TINY = {"granite-3-2b": dict(d_ff=128, vocab_size=64),
        "rwkv6-7b": dict(d_ff=128, vocab_size=131, n_kv_heads=4,
                         rwkv_head_dim=16),
        # one whole period: every kind of jamba layer
        "jamba-1.5-large-398b": dict(n_layers=8, d_ff=96, vocab_size=131,
                                     n_experts=4, n_experts_per_tok=2,
                                     mamba_d_state=8, moe_group_size=16,
                                     moe_capacity_factor=2.0),
        "qwen3-moe-235b-a22b": dict(d_ff=48, vocab_size=131, n_experts=8,
                                    n_experts_per_tok=2, moe_group_size=16,
                                    moe_capacity_factor=4.0),
        "dbrx-132b": dict(d_ff=96, vocab_size=131, n_experts=4,
                          n_experts_per_tok=2, moe_group_size=16,
                          moe_capacity_factor=2.0)}


def live_ssm(params):
    """Mamba's ``conv_w`` at 10x its init draw, in place.  At the
    reference's init scale every input of ``x_proj`` rounds to activation
    level 0 on all three datapaths, so the SSM's B, C and dt are constants
    and its state stays zero: the scaled taps put the recurrence on the
    path that phase 8 holds batched == sequential."""
    for lp in params["layers"]:
        if "conv_w" in lp["mixer"]:
            lp["mixer"]["conv_w"].mul_(10)
    return params


def tiny_card_equals_cpu(torch, dev, arch="granite-3-2b"):
    """A tiny float32 config: tokens on the card (kernels) equal tokens on
    the CPU (plain versions), for each datapath x format pair."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    cfg = get_arch(arch).scaled(**{**TINY_SCALE, **TINY[arch]})
    cpu = live_ssm(init_params(cfg, torch.Generator().manual_seed(SEED),
                               "cpu"))
    gpu = _to(cpu, dev)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    for datapath, fmt in PAIRS:
        toks = []
        for params, d in ((cpu, "cpu"), (gpu, dev)):
            eng = ServeEngine(params, cfg, max_slots=2, max_len=32,
                              page_size=4, datapath=datapath, kv_format=fmt,
                              device=d)
            for p in prompts:
                eng.submit(p, max_new_tokens=5)
            toks.append([r.generated for r in sorted(
                eng.run_to_completion(), key=lambda r: r.rid)])
        if toks[0] != toks[1]:
            raise AssertionError(f"tiny {arch} {datapath}x{fmt}: card "
                                 f"{toks[1]} != cpu {toks[0]}")
        log(f"tiny {arch} {datapath}x{fmt}: card tokens == cpu tokens")


# ---------------------------------------------------------------------------
# phase 5: the SC integer datapath at published width
# ---------------------------------------------------------------------------

SC_PATH_KERNELS = ("ternary_matmul", "bsn_sort", "approx_bsn_temporal")


def _tnn_params(torch, dev):
    """Seeded random QAT parameters of the paper's TNN (784-256-256-10),
    at the scales of its QAT init; no trained weights are in the repo."""
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    return {"w_in": randn(784, 256) / 28.0,
            "blocks": [{"w": randn(256, 256) / 16.0,
                        "alpha_w": torch.tensor(0.05, device=dev),
                        "alpha_a": torch.tensor(0.5, device=dev)}
                       for _ in range(2)],
            "w_out": randn(256, 10) / 16.0}, randn(256, 784)


def tnn_forward(torch, layers, params, x):
    """The exported TNN: float frontend, the SC integer core (the ternary
    matmul with the SI ReLU fused; q codes between layers), float head."""
    from repro_torch.core.coding import quantize_levels
    from repro_torch.core.sc_layers import sc_linear_int
    h = torch.relu(x @ params["w_in"])
    x_q = quantize_levels(h, layers[0]["alpha_a"], ACT_BSL).to(torch.int8)
    inputs = []
    for layer in layers:
        inputs.append(x_q)
        x_q = sc_linear_int(layer, x_q).to(torch.int8)
    h = x_q.to(torch.float32) * layers[-1]["alpha_a"]
    return h @ params["w_out"], inputs, x_q


def sc_pipeline(torch, dev):
    """Drive the SC integer datapath end to end on the card and check it by
    its own means: plain versions, the unfused epilogue, the exact integer
    path and the QAT view."""
    from repro_torch.core import si
    from repro_torch.core.bsn import ApproxBSNSpec, StageSpec, exact_bsn_bits
    from repro_torch.core.sc_layers import (SCQuantConfig, _si_epilogue,
                                            export_sc_linear, sc_linear_int,
                                            sc_linear_int_approx,
                                            sc_linear_qat)
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ref import ternary_matmul_ref
    cfg = SCQuantConfig(mode="sc_int", act_bsl=ACT_BSL)
    gen = torch.Generator(dev).manual_seed(SEED + 1)
    torch.cuda.synchronize()
    kbuild.reset_launches()
    t0 = time.perf_counter()

    # the TNN, exported, a batch of 256 through the fused-SI kernel
    params, x = _tnn_params(torch, dev)
    layers = [export_sc_linear(blk, cfg, act_fn=si.relu_fn, out_bsl=ACT_BSL,
                               alpha_out=float(blk["alpha_a"]))
              for blk in params["blocks"]]
    logits, inputs, codes = tnn_forward(torch, layers, params, x)
    sums0 = sc_linear_int({"w_int": layers[0]["w_int"]}, inputs[0])
    y_qat = sc_linear_qat(params["blocks"][0],
                          inputs[0].to(torch.float32) * 0.5, cfg)

    # the exact BSN's circuit over q_proj at 4 tokens, with the SI taps
    k, n = GRANITE_PROJ["q/o"]
    x_q = _levels(torch, gen, dev, (4, k))
    w_q = _ternary(torch, gen, dev, (k, n))
    sorted_bits = exact_bsn_bits(_exact_bsn_bits(torch, x_q, w_q))
    sum_max = k * ACT_BSL // 2
    t = si.si_thresholds(si.relu_fn, 2 * sum_max, ACT_BSL,
                         alpha_in=0.5 * 0.05, alpha_out=0.5)
    q_int = {"w_int": w_q, "thresholds": t[None], "sum_max": sum_max}
    sums_q = sc_linear_int({"w_int": w_q}, x_q)
    si_q = sc_linear_int(q_int, x_q)
    si_bits = si.apply_si_bits(sorted_bits, t)

    # the temporal adder on full-width w_up at 4 tokens: K = 2048 over 8
    # cycles of a 256-wide adder, default and exact (no clip, stride 1)
    k_up, n_up = GRANITE_PROJ["gate/up"]
    cycles = 8
    xu = _levels(torch, gen, dev, (4, k_up))
    wu = {"w_int": _ternary(torch, gen, dev, (k_up, n_up))}
    approx_t = sc_linear_int_approx(wu, xu, ACT_BSL, cycles=cycles)
    exact_spec = ApproxBSNSpec(width=k_up // cycles, in_bsl=ACT_BSL,
                               stages=(StageSpec(k_up // cycles),))
    exact_t = sc_linear_int_approx(wu, xu, ACT_BSL, exact_spec,
                                   cycles=cycles)
    sums_up = sc_linear_int(wu, xu)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)

    missing = [k for k in SC_PATH_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"SC datapath: kernels never launched: "
                             f"{missing}")
    # checks (their plain-version launches come after the counts are read)
    for i, (layer, xin) in enumerate(zip(layers, inputs)):
        t_q = (torch.as_tensor(layer["thresholds"], device=dev)
               - layer["sum_max"]).to(torch.int32).expand(256, ACT_BSL)
        out = codes if i == len(layers) - 1 else inputs[i + 1]
        plain = ternary_matmul_ref(xin, layer["w_int"], t_q)
        unfused = _si_epilogue(layer, ternary_matmul_ref(xin,
                                                         layer["w_int"]))
        if not (torch.equal(out.to(torch.int32), plain)
                and torch.equal(plain, unfused)):
            raise AssertionError(f"TNN layer {i}: kernel q codes != plain")
    if not torch.equal(sums0, ternary_matmul_ref(inputs[0],
                                                 layers[0]["w_int"])):
        raise AssertionError("TNN layer 0: kernel sums != plain")
    qat_err = (y_qat - sums0.to(torch.float32) * 0.5 * 0.05).abs().max()
    if not (logits.shape == (256, 10) and torch.isfinite(logits).all()
            and qat_err.item() <= 1e-4):
        raise AssertionError(f"TNN: logits {tuple(logits.shape)} or QAT "
                             f"view off by {qat_err.item()}")
    pop = torch.sum(sorted_bits, dim=-1, dtype=torch.int32)
    if not torch.equal(pop - sum_max, sums_q):
        raise AssertionError("exact BSN circuit != ternary_matmul sums")
    si_pop = torch.sum(si_bits, dim=-1, dtype=torch.int32) - ACT_BSL // 2
    if not (torch.equal(si_pop, si_q)
            and torch.equal(si_q, _si_epilogue(q_int, sums_q))):
        raise AssertionError("SI taps != fused SI epilogue")
    if not torch.equal(exact_t, sums_up):
        raise AssertionError("temporal adder with the exact spec != "
                             "ternary_matmul sums")
    if not (approx_t.shape == (4, n_up) and
            (approx_t - sums_up).abs().max().item() <= k_up * ACT_BSL):
        raise AssertionError("temporal adder output out of range")
    res = dict(seconds=seconds, launches=launches,
               tnn_batch=256, tnn_codes_range=[int(codes.min()),
                                               int(codes.max())],
               tnn_qat_max_abs_err=qat_err.item(),
               temporal_max_abs_dev_from_exact=(approx_t - sums_up).abs()
               .max().item())
    log(f"SC datapath: TNN 784-256-256-10 batch 256 q codes == plain "
        f"(fused SI == unfused), QAT view within {qat_err.item():.2g}; "
        f"exact BSN circuit == ternary_matmul over q_proj (4 x 2048 rows "
        f"of 16384 bits), SI taps == fused SI; temporal adder (w_up, 8 "
        f"cycles) exact spec == ternary_matmul, default spec max |dev| "
        f"{res['temporal_max_abs_dev_from_exact']}; {seconds:.2f} s; "
        f"launches={launches}")
    return res


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 3
TRAIN_LR = 1e-3
# tiny card == CPU train step, float32.  Without quantization: loss and
# grad norm (products and sums in another order) within 1e-5 relative;
# params after one AdamW step (~lr * sign(g), lr 5e-4) within 2e-5, so a
# gradient within float32 rounding of zero that flips its step still
# shows; m within 5e-5 and v within 1e-4 of each leaf's largest entry.
# Under sc_qat the fake-quant lattice turns a one-ulp difference of an
# activation into a whole quantum (1.0 at act_bsl 8) now and then, which
# moves the gradients, so there the loss alone, within 1e-5 relative.
TINY_TRAIN_TOL = dict(metric=1e-5, params=2e-5, m=5e-5, v=1e-4)


# the leaves each trained arch watches ("layers/-1" is the last layer)
WATCH = {
    "granite-3-2b": ("layers/0/mixer/wq/w", "layers/-1/ffn/w_down/w",
                     "layers/0/norm1/scale", "layers/0/mixer/wq/alpha_a",
                     "embed/table", "lm_head/w"),
    "rwkv6-7b": ("layers/0/mixer/wr/w", "layers/-1/ffn/wv/w",
                 "layers/0/mixer/w0", "layers/0/mixer/maa",
                 "layers/0/norm1/scale", "layers/0/mixer/wr/alpha_a",
                 "embed/table", "lm_head/w"),
    "jamba-1.5-large-398b": ("layers/0/mixer/in_proj/w",
                             "layers/0/mixer/a_log", "layers/0/mixer/dt_bias",
                             "layers/-1/ffn/w_down/w", "layers/0/norm1/scale",
                             "layers/0/mixer/in_proj/alpha_a", "embed/table",
                             "lm_head/w")}


def _watch(params, arch="granite-3-2b"):
    """The watched leaves of ``params`` (to see which steps change them),
    keyed by path with the last layer's index written out."""
    out = {}
    for path in WATCH[arch]:
        node, parts = params, path.split("/")
        if parts[0] == "layers":
            parts[1] = str(int(parts[1]) % len(params["layers"]))
        for part in parts:
            node = node[int(part)] if isinstance(node, list) else node[part]
        out["/".join(parts)] = node
    return out


def _rounded_away(torch, state, lr, arch="granite-3-2b"):
    """Per watched leaf, the largest ratio of the last AdamW update to half
    an ulp of the entry it was added to, recomputed from the optimizer's
    own m / v / count exactly as ``optim.adamw_update`` forms it: below 1
    the update rounds away in the leaf's dtype, and the leaf stays."""
    import inspect
    from repro_torch.optim import adamw_update
    arg = {k: p.default for k, p in
           inspect.signature(adamw_update).parameters.items()}
    c = float(state.opt["count"])
    bc1, bc2 = 1 - arg["b1"] ** c, 1 - arg["b2"] ** c
    ratios = {}
    for (k, p), m, v in zip(_watch(state.params, arch).items(),
                            _watch(state.opt["m"], arch).values(),
                            _watch(state.opt["v"], arch).values()):
        step = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + arg["eps"])
        if p.ndim + k.startswith("layers/") >= 2:      # train.decay_mask
            step = step + arg["weight_decay"] * p.float()
        ulp = torch.finfo(p.dtype).eps * torch.exp2(torch.floor(torch.log2(
            p.float().abs().clamp(min=torch.finfo(p.dtype).tiny))))
        ratios[k] = (lr * step.abs() / (ulp / 2)).max().item()
    return ratios


MMA_KERNEL = "flash_fwd_mma_kernel"     # the bf16 tensor-core forward


def profile_train_step(torch, step_fn, state, batch, n_flash,
                       label="train"):
    """One train step under torch.profiler: device busy time, the device's
    idle share of the step's wall time, and the flash forward's time over
    its ``n_flash`` launches, all of them the tensor-core kernel; the
    step's metrics too."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    busy_ms = sum(_dev_us(e) for e in events if e.device_type == cuda) / 1e3
    # every flash forward of a bf16 step is the tensor-core kernel
    flash = [e for e in events if e.device_type == cuda
             and "flash_fwd" in e.key]
    flash_ms = sum(_dev_us(e) for e in flash) / 1e3
    flash_calls = {e.key: e.count for e in flash}
    rows = sorted(((_dev_us(e), e.key, e.count) for e in events
                   if e.device_type != cuda and _dev_us(e) > 0),
                  reverse=True)
    (OUT_DIR / f"profile_{label}.txt").write_text(events.table(
        sort_by="self_cuda_time_total", row_limit=40))
    if (sum(flash_calls.values()) != n_flash
            or not all(MMA_KERNEL in k for k in flash_calls)):
        raise AssertionError(f"profiled train step: flash kernels "
                             f"{flash_calls}, expected {n_flash} launches "
                             f"of {MMA_KERNEL}")
    top = [dict(name=k, ms=us / 1e3, calls=n) for us, k, n in rows[:10]]
    res = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1 - busy_ms / wall_ms, flash_kernel_ms=flash_ms,
               flash_kernel_calls=flash_calls, top=top,
               metrics={k: float(v) for k, v in metrics.items()})
    log(f"profile {label} step: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy_ms:.1f} idle_share={res['idle_share']:.3f} flash_kernel_ms="
        f"{flash_ms:.1f} ({n_flash} launches of {MMA_KERNEL}) top ops: "
        + "; ".join(f"{t['name']} {t['ms']:.1f} ms x{t['calls']}"
                    for t in top[:6]))
    return res


def train_arch(torch, dev, arch, layers, batch):
    """Train ``arch`` at its published widths, ``layers`` deep, from
    seeded random weights (mamba's conv taps scaled by :func:`live_ssm`)
    with its registered quantization, recompute, dtypes and AdamW state,
    on ``batch`` x 4096 tokens of ``SyntheticLM``: 3 steps, with the
    gates of phase 6 (a flash launch per attention layer's forward and
    recompute, finite losses, step 1 at lr 0 moves nothing, step 2 moves
    every watched leaf whose update exceeds half an ulp), then one
    profiled step.  On rwkv6 :func:`chunked_wkv_step` runs first, from
    the same parameters and batch as the profiled scan step, whose loss
    its loss must be within ``CHUNKED_LOSS_RTOL`` of."""
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import init_params
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_leaves
    cfg = get_arch(arch)
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    if (cfg.quant.mode, cfg.remat, cfg.dtype) != ("sc_qat", "full",
                                                  "bfloat16"):
        raise AssertionError(f"{arch} trains {cfg.quant.mode} / {cfg.remat} "
                             f"/ {cfg.dtype}")
    n_attn = sum(cfg.period[i % len(cfg.period)].mixer == "attn"
                 for i in range(layers))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = live_ssm(init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                  dev))
    n_params = sum(p.numel() for p in tree_leaves(params))
    state = init_train_state(params, cfg)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=SEED)
    batches = [ds.batch(i, batch) for i in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state_gib = torch.cuda.memory_allocated() / 2**30
    log(f"init train state {arch} layers={layers} d_model={cfg.d_model} "
        f"params={n_params / 1e9:.3f} B opt_state={cfg.opt_state_dtype} "
        f"wkv={cfg.rwkv_wkv_impl}: {setup_s:.1f} s, {state_gib:.2f} GiB")
    # warmup_cosine(0) = 0: step 1 moves nothing, step 2 runs at the peak
    step_fn = build_train_step(cfg, lambda s: warmup_cosine(
        s, TRAIN_LR, 1, TRAIN_STEPS))
    initial = {k: v.clone() for k, v in _watch(state.params, arch).items()}

    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    torch.cuda.synchronize()
    steps, changed = [], []
    for i in range(TRAIN_STEPS):
        t1 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t1
        steps.append(dict({k: float(v) for k, v in m.items()}, sec=sec))
        changed.append({k: (v != initial[k]).float().mean().item()
                        for k, v in _watch(state.params, arch).items()})
        if i == 1:
            rounded = _rounded_away(torch, state, steps[-1]["lr"], arch)
        log(f"train {arch} step {i + 1}: loss={steps[-1]['loss']:.4f} "
            f"grad_norm={steps[-1]['grad_norm']:.4f} lr="
            f"{steps[-1]['lr']:.3g} {sec:.2f} s; share of watched entries "
            f"changed: " + ", ".join(f"{k} {c:.3g}"
                                     for k, c in changed[-1].items()))
    launches = dict(kbuild.LAUNCHES)

    want = n_attn * 2 * TRAIN_STEPS                # forward + recompute
    if launches["flash_attention"] != want:
        raise AssertionError(f"{arch}: flash kernel launched "
                             f"{launches['flash_attention']} times, "
                             f"expected {want}")
    if not all(math.isfinite(s[k]) for s in steps
               for k in ("loss", "grad_norm")):
        raise AssertionError(f"{arch}: non-finite loss or grad norm: {steps}")
    if any(changed[0].values()):
        raise AssertionError(f"{arch}: step 1 (lr 0) changed parameters: "
                             f"{changed[0]}")
    # step 2 must move every watched leaf, except one whose AdamW update
    # (recomputed from the optimizer state) is below half an ulp of all
    # its entries: at random init the clip by a ~1e12 gradient norm leaves
    # some step sizes' updates that small (ROADMAP Queue 3 item 7)
    stuck = {k: rounded[k] for k, c in changed[1].items() if c == 0}
    log(f"{arch} step 2: largest update / half-ulp per watched leaf: "
        + ", ".join(f"{k} {r:.3g}" for k, r in rounded.items()))
    if not any(changed[1].values()) or any(r >= 1 for r in stuck.values()):
        raise AssertionError(f"{arch}: step 2 left parameters unchanged: "
                             f"{changed[1]}; update / half-ulp {rounded}")
    later = [s["sec"] for s in steps[1:]]
    sec_per_step = sum(later) / len(later)
    res = dict(arch=arch, layers=layers, params=n_params, batch=batch,
               seq=TRAIN_SEQ, quant=cfg.quant.mode, remat=cfg.remat,
               opt_state_dtype=cfg.opt_state_dtype,
               wkv_impl=cfg.rwkv_wkv_impl, lr=TRAIN_LR, setup_s=setup_s,
               state_gib=state_gib, steps=steps, changed=changed,
               update_over_half_ulp=rounded, sec_per_step=sec_per_step,
               tokens_per_s=batch * TRAIN_SEQ / sec_per_step,
               launches=launches)
    if arch == RWKV_ARCH:
        state, res["chunked"] = chunked_wkv_step(torch, cfg, state,
                                                 batches[TRAIN_STEPS])
    res["max_memory_allocated"] = peak = torch.cuda.max_memory_allocated()
    log(f"train {arch} layers={layers} batch={batch}x{TRAIN_SEQ}: sec/step "
        f"(steps 2-{TRAIN_STEPS}) {sec_per_step:.3f} tokens/s "
        f"{res['tokens_per_s']:.0f} max_memory_allocated="
        f"{peak / 2**30:.2f} GiB launches={launches}")
    res["profile"] = profile_train_step(
        torch, step_fn, state, batches[TRAIN_STEPS], n_attn * 2,
        label="train" if arch == "granite-3-2b" else f"train_{arch}")
    res["profile"]["idle_share_unprofiled"] = \
        1 - res["profile"]["device_busy_ms"] / (sec_per_step * 1e3)
    log(f"train {arch} step idle share against the unprofiled step "
        f"({sec_per_step * 1e3:.1f} ms): "
        f"{res['profile']['idle_share_unprofiled']:.3f}")
    if arch == RWKV_ARCH:
        c = res["chunked"]
        scan_loss = res["profile"]["metrics"]["loss"]
        c["loss_rel_gap"] = gap = abs(c["loss"] - scan_loss) / abs(scan_loss)
        log(f"rwkv6 chunked wkv step: loss {c['loss']:.6f} against the "
            f"scan's {scan_loss:.6f} on the same parameters and batch: "
            f"relative gap {gap:.3g} (tol {CHUNKED_LOSS_RTOL}); "
            f"{c['step_s'][0]:.2f} s its first call, {c['step_s'][1]:.2f} s "
            f"its second, against the scan's {sec_per_step:.2f} s a step")
        if not gap <= CHUNKED_LOSS_RTOL:
            raise AssertionError(f"rwkv6 chunked wkv loss gap {gap}")
    del state, params
    return res


def tiny_train_card_equals_cpu(torch, dev, configs):
    """One train step of each tiny float32 config on the card (flash
    kernel) against the same step on the CPU (plain version), without
    quantization and under sc_qat, at ``TINY_TRAIN_TOL``.  ``configs``
    holds (label, sc_qat config, sequence length, small-gradient rule);
    with the rule, where the CPU's first-step gradient is below 1e-6 the
    step ``lr * g / (|g| + eps)`` is set by the gradient's rounding, and
    those parameter entries are held within ``2 lr``."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import init_params
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_leaves
    tol = TINY_TRAIN_TOL
    res = {}
    for label, qat, seq, small_grad_rule in configs:
        n_attn = sum(qat.period[i % len(qat.period)].mixer == "attn"
                     for i in range(qat.n_layers))
        batch = SyntheticLM(vocab_size=qat.vocab_size, seq_len=seq,
                            seed=SEED).batch(0, 4)
        for cfg in (qat.scaled(quant=qat.quant.with_mode("none")), qat):
            cpu = live_ssm(init_params(cfg, torch.Generator().manual_seed(
                SEED), "cpu"))
            gpu = _to(cpu, dev)
            step_fn = build_train_step(cfg, lambda s: warmup_cosine(
                s + 1, 1e-3, 2, 10))
            before = kbuild.LAUNCHES["flash_attention"]
            (sc, mc), (sg, mg) = [step_fn(init_train_state(p, cfg), batch)
                                  for p in (cpu, gpu)]
            if kbuild.LAUNCHES["flash_attention"] - before != n_attn * 2:
                raise AssertionError(f"tiny {label} train step: the card "
                                     f"did not run the flash kernel")
            errs = {k: abs(float(mg[k]) - float(mc[k])) / abs(float(mc[k]))
                    for k in ("loss", "grad_norm")}
            slack = 2 * float(mc["lr"]) if small_grad_rule else 0.0
            errs["params"] = max(
                ((a.cpu() - b).abs() - torch.where(
                    m.abs() < (1 - 0.9) * 1e-6, slack, 0.0)).max().item()
                for a, b, m in zip(tree_leaves(sg.params),
                                   tree_leaves(sc.params),
                                   tree_leaves(sc.opt["m"])))
            for name in ("m", "v"):
                errs[name] = max(((a.cpu() - b).abs().max()
                                  / b.abs().max().clamp(min=1e-30)).item()
                                 for a, b in zip(tree_leaves(sg.opt[name]),
                                                 tree_leaves(sc.opt[name])))
            checked = ("loss",) if cfg.quant.enabled else tuple(errs)
            bad = {k: errs[k] for k in checked
                   if errs[k] > tol["metric" if k in ("loss", "grad_norm")
                                    else k]}
            if bad:
                raise AssertionError(f"tiny {label} train step "
                                     f"{cfg.quant.mode}: card != cpu {bad}")
            log(f"tiny {label} train step {cfg.quant.mode}: card == cpu on "
                f"{', '.join(checked)} ("
                + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
                + f"; tolerances {tol})")
            res[f"{label} {cfg.quant.mode}"] = errs
    return res


# ---------------------------------------------------------------------------
# phase 7: serving a mixture of experts at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-235b-a22b"
RWKV_ARCH, JAMBA_ARCH = "rwkv6-7b", "jamba-1.5-large-398b"
ARCH_NEW_TOKENS = 8


def arch_path_kernels(cfg, datapath):
    """The port's kernels a pair's path runs on ``cfg``: the paged kernels
    where a layer is attention (rwkv6 has none), the ternary matmul
    (sc_int) or the BSN adder (sc_int_approx) for the dense projections,
    and the batched ternary matmul for the experts under both integer
    datapaths (experts keep the exact accumulator under sc_int_approx)."""
    specs = [cfg.period[i % len(cfg.period)] for i in range(cfg.n_layers)]
    kernels = []
    if any(s.mixer == "attn" for s in specs):
        kernels += ["paged_attn_decode", "paged_attn_prefill"]
    if datapath != "qat":
        kernels.append("ternary_matmul" if datapath == "sc_int"
                       else "approx_bsn")
        if any(s.ffn == "moe" for s in specs):
            kernels.append("ternary_matmul_batched")
    return tuple(kernels)


def serve_arch(torch, dev, arch, layers):
    """Phases 7 and 8: ``arch`` at its published widths, bf16, seeded
    random weights (mamba's conv taps scaled by :func:`live_ssm`),
    ``layers`` deep, at capacity factor E / k where it has experts (no
    token drops, so batched == sequential is defined), served on the
    three pairs with phase 4's traffic and 8 new tokens: batched ==
    sequential, every kernel of the pair's path launched, the batched
    ternary matmul exactly 3 times a MoE layer in each prefill chunk
    round and decode step under sc_int*, one decode step and the batched
    prefill profiled."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import init_params
    from repro_torch.serving.paging import pad_pow2
    base = get_arch(arch)
    cfg = base.scaled(n_layers=layers)
    if base.n_experts:
        cfg = cfg.scaled(moe_capacity_factor=float(
            base.n_experts // base.n_experts_per_tok))
    n_moe = sum(cfg.period[i % len(cfg.period)].ffn == "moe"
                for i in range(layers))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = live_ssm(init_params(
        cfg, torch.Generator(dev).manual_seed(SEED), dev))
    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated() / 2**30
    kinds = sorted({f"{s.mixer}+{s.ffn}" for s in
                    (cfg.period[i % len(cfg.period)] for i in range(layers))})
    log(f"init_params {arch} layers={layers} ({', '.join(kinds)}) "
        f"d_model={cfg.d_model} experts={cfg.n_experts} vocab="
        f"{cfg.padded_vocab} cf={cfg.moe_capacity_factor} dtype="
        f"{cfg.dtype}: {time.perf_counter() - t0:.1f} s, "
        f"{weights_gib:.2f} GiB")
    plens = (32, 57, 96, 128)
    prompts = _prompts(torch, cfg, plens)
    rounds = pad_pow2(max(plens)) // 64       # the engine's chunk rounds
    totals = dict.fromkeys(kbuild.KERNELS, 0)
    results = []
    for datapath, fmt in PAIRS:
        res, engine = serve_pair(torch, dev, cfg, params, prompts, datapath,
                                 fmt, ARCH_NEW_TOKENS,
                                 arch_path_kernels(cfg, datapath))
        n = res["launches"]["ternary_matmul_batched"]
        want = 0 if datapath == "qat" else \
            3 * n_moe * (rounds + res["decode_steps"])
        if n != want:
            raise AssertionError(f"{arch} {datapath}x{fmt}: batched "
                                 f"ternary_matmul launched {n} times, not "
                                 f"{want}")
        for k, v in res["launches"].items():
            totals[k] += v
        res["weights_gib"] = weights_gib
        results.append(res)
        eng = engine()                      # profile a fresh third step
        eng.step()
        eng.step()
        res["profile"] = profile_decode_step(
            torch, eng, f"{arch}_{datapath}_{fmt}",
            res["decode_ms_per_step"])
        del eng
        res["profile_prefill"] = profile_prefill(
            torch, engine(), f"{arch} {datapath}_{fmt}")
    return results, totals


# ---------------------------------------------------------------------------
# phase 9: training the recurrent mixers, and the dense serving path
# ---------------------------------------------------------------------------

RECURRENT_TRAIN_BATCH = 1       # PERF.md section 4: rwkv6's (S, H, K, V) scan
# jamba's layer 1 is MoE with 9.7 B expert parameters, past one card
JAMBA_TRAIN_LAYERS = 1
CHUNKED_LOSS_RTOL = 1e-2        # chunked wkv against the token scan, bf16
# layer 0's chunked wkv against the token scan, float32, of the largest
# entry: sound forms read 5e-7 to 1.2e-6, the smallest planted fault
# (decays a token late) 2.2e-4 (chip_wkv_faults.py; PERF.md section 6)
WKV_RTOL = 1e-5
DENSE_LOGIT_RTOL = 5e-2         # dense vs paged logits, of the largest
DENSE_NEW_TOKENS = 8


def wkv_gap(torch, operands, chunked):
    """``chunked`` (``_wkv_chunked`` or a stand-in) against the token scan
    on one layer's wkv operands, in float32: the largest |difference| of
    y and of the final state, each over the largest |scan| entry; and of
    y again with the bonus ``u`` drawn from a seeded normal (it is zero
    at init, which would leave the bonus term unchecked)."""
    from repro_torch.models import rwkv6
    r, k, v, w, u, s0, chunk = operands
    drawn = torch.randn(u.shape, device=u.device, generator=torch.Generator(
        u.device).manual_seed(SEED))
    out = {}
    with torch.no_grad():
        for tag, uu in (("", u), (" u drawn", drawn)):
            ys, ss = rwkv6._wkv_scan(r, k, v, w, uu, s0)
            yc, sc = chunked(r, k, v, w, uu, s0, chunk)
            out["y" + tag] = ((yc - ys).abs().max() / ys.abs().max()).item()
            if not tag:
                out["state"] = ((sc - ss).abs().max()
                                / ss.abs().max()).item()
    return out


def chunked_wkv_step(torch, cfg, state, batch):
    """One rwkv6 train step with the chunked wkv at learning rate 0 from
    ``state`` on ``batch``, run twice (the first call of a new path pays
    its warm-up, as the scan's first step does); it must move no watched
    leaf.  Layer 0's wkv operands, taken from the step's first forward,
    hold ``_wkv_chunked`` against ``_wkv_scan`` within ``WKV_RTOL``
    (:func:`wkv_gap`).  Returns (state, result); the caller holds the
    step's loss against the scan step's."""
    from repro_torch.models import rwkv6
    from repro_torch.train import build_train_step
    before = {k: v.clone() for k, v in _watch(state.params, RWKV_ARCH).items()}
    step_fn = build_train_step(cfg.scaled(rwkv_wkv_impl="chunked"),
                               lambda s: 0.0)
    chunked, seen = rwkv6._wkv_chunked, []

    def record(*operands):
        if not seen:
            seen.append([t.detach() if torch.is_tensor(t) else t
                         for t in operands])
        return chunked(*operands)

    res = dict(step_s=[])
    for i in range(2):
        rwkv6._wkv_chunked = record if i == 0 else chunked
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            res["step_s"].append(time.perf_counter() - t1)
        finally:
            rwkv6._wkv_chunked = chunked
    res["loss"] = float(m["loss"])
    moved = [k for k, v in _watch(state.params, RWKV_ARCH).items()
             if not torch.equal(v, before[k])]
    if moved or not math.isfinite(res["loss"]):
        raise AssertionError(f"rwkv6 chunked step at lr 0: moved {moved}, "
                             f"loss {res['loss']}")
    res["wkv_rel_err"] = err = wkv_gap(torch, seen[0], chunked)
    log(f"rwkv6 layer 0 wkv, chunked against the token scan (S "
        f"{seen[0][0].shape[1]}, chunk {seen[0][6]}): y {err['y']:.3g}, "
        f"final state {err['state']:.3g}, y with u drawn "
        f"{err['y u drawn']:.3g}, of the largest (tol {WKV_RTOL})")
    if not max(err.values()) <= WKV_RTOL:
        raise AssertionError(f"rwkv6 chunked wkv against the scan: {err}")
    return state, res


def _predicted_launches(cfg, datapath, forwards):
    """Launches of the projection kernel that a run of dense ``forwards``
    (one (rows, count) pair a kind of forward: a prefill of ``rows``
    positions, or ``count`` one-token decode steps) makes: the ternary
    matmul once a projection under sc_int; under sc_int_approx the BSN
    adder once a block of rows, blocks of ``COUNTS_BUDGET_BYTES // (4 N
    K)`` rows (``core.sc_layers.sc_linear_int_approx``)."""
    from repro_torch.core.sc_layers import COUNTS_BUDGET_BYTES
    d, hd = cfg.d_model, cfg.head_dim
    shapes = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
              (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
              (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)] * cfg.n_layers
    shapes.append((d, cfg.padded_vocab))
    total = 0
    for rows, count in forwards:
        for k, n in shapes:
            if datapath == "sc_int":
                total += count
            else:
                block = max(1, COUNTS_BUDGET_BYTES // (4 * n * k))
                total += count * -(-rows // block)
    return total


def dense_serving(torch, dev, layers):
    """Phase 9: granite-3-2b at phase 4's depth (seeded random weights, as
    phase 4's) through the dense cache.  With quantization off, ``prefill``
    of a 128-token prompt and 8 teacher-forced ``decode_step``s against
    ``paged_prefill`` (chunks of 64) and ``paged_decode_step`` on the same
    tokens: logits within ``DENSE_LOGIT_RTOL`` of the largest.  Then the
    dense ``sequential_generate`` on qat / sc_int / sc_int_approx x fp
    over phase 4's prompts: finite, every token in the vocabulary, each
    kernel of its path launched exactly the predicted number of times;
    its tokens printed beside the engine's on the same pair, with the
    first parting and the dense logit gap there (not gated)."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import (decode_step, init_paged_cache,
                                    init_params, paged_decode_step,
                                    paged_prefill, prefill)
    from repro_torch.serving import ServeEngine, sequential_generate
    from repro_torch.serving.engine import (_cfg_for_datapath,
                                            _pad_prefill_cache)
    cfg = get_arch("granite-3-2b").scaled(n_layers=layers)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = _prompts(torch, cfg, (32, 57, 96, 128))
    res = {}
    # quantization off: the dense path against the paged one
    off = cfg.scaled(quant=cfg.quant.with_mode("none"))
    seq = prompts[3] + _prompts(torch, cfg, (DENSE_NEW_TOKENS,))[0]
    plen, page = len(prompts[3]), 16
    kbuild.reset_launches()
    with torch.inference_mode():
        toks = torch.tensor([seq], dtype=torch.int32, device=dev)
        lg, cache = prefill(params, {"tokens": toks[:, :plen]}, off)
        cache = _pad_prefill_cache(cache, len(seq))
        dense = [lg[0, -1]]
        for t in range(plen, len(seq)):
            lg, cache = decode_step(params, cache, toks[:, t:t + 1], off)
            dense.append(lg[0, 0])
        n_flash = kbuild.LAUNCHES["flash_attention"]
        maxp = len(seq) // page + 1
        pcache = init_paged_cache(off, 1, maxp + 1, page, "fp", device=dev)
        tables = torch.arange(1, maxp + 1, dtype=torch.int32,
                              device=dev)[None]
        slot = torch.zeros((1,), dtype=torch.int32, device=dev)
        lg, pcache = paged_prefill(params, pcache, toks[:, :plen], tables,
                                   torch.tensor([plen], device=dev), off,
                                   chunk=64, slot_ids=slot)
        paged = [lg[0]]
        for t in range(plen, len(seq)):
            lg, pcache = paged_decode_step(
                params, pcache, toks[0, t:t + 1], slot, tables,
                torch.tensor([t], dtype=torch.int32, device=dev), off)
            paged.append(lg[0])
    dense, paged = (torch.stack(x).float()[:, :cfg.vocab_size]
                    for x in (dense, paged))
    err = ((dense - paged).abs().max() / paged.abs().max()).item()
    res["dense_vs_paged"] = dict(prompt_len=plen, decode_steps=len(paged) - 1,
                                 max_rel_err=err, flash_launches=n_flash,
                                 argmax_equal=bool(torch.equal(
                                     dense.argmax(-1), paged.argmax(-1))))
    log(f"dense vs paged granite-3-2b layers={layers} quant off: prefill of "
        f"{plen} + {len(paged) - 1} decode steps, logits max |diff| / max "
        f"|logit| {err:.3g} (tol {DENSE_LOGIT_RTOL}); greedy ids equal: "
        f"{res['dense_vs_paged']['argmax_equal']}; flash launches {n_flash}")
    if not (err <= DENSE_LOGIT_RTOL and n_flash == layers
            and torch.isfinite(dense).all()):
        raise AssertionError(f"dense vs paged: {res['dense_vs_paged']}")
    # the dense oracle on the three datapaths, beside the engine on fp
    totals = dict.fromkeys(kbuild.KERNELS, 0)
    for datapath in ("qat", "sc_int", "sc_int_approx"):
        eng = ServeEngine(params, cfg, max_slots=4, max_len=256,
                          page_size=16, prefill_chunk=64, datapath=datapath,
                          kv_format="fp", device=dev)
        for p in prompts:
            eng.submit(p, max_new_tokens=DENSE_NEW_TOKENS)
        engine_toks = [r.generated for r in sorted(
            eng.run_to_completion(), key=lambda r: r.rid)]
        del eng
        kbuild.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sequential_generate(params, cfg, prompts,
                                  max_new_tokens=DENSE_NEW_TOKENS,
                                  max_len=256, datapath=datapath,
                                  kv_format="fp", device=dev)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(kbuild.LAUNCHES)
        for k, v in launches.items():
            totals[k] += v
        dcfg = _cfg_for_datapath(cfg, datapath)
        want = {"flash_attention": layers * len(prompts)}
        forwards = [(len(p), 1) for p in prompts] + \
            [(1, len(g) - 1) for g in got]
        if datapath != "qat":
            want["ternary_matmul" if datapath == "sc_int" else "approx_bsn"] \
                = _predicted_launches(dcfg, datapath, forwards)
        wrong = {k: (launches[k], n) for k, n in want.items()
                 if launches[k] != n}
        others = {k: v for k, v in launches.items() if k not in want and v}
        if wrong or others or any(not 0 <= t < cfg.vocab_size
                                  for g in got for t in g):
            raise AssertionError(f"dense sequential_generate {datapath}: "
                                 f"launches {wrong} {others}, tokens {got}")
        partings = []
        for p, g, e in zip(prompts, got, engine_toks):
            first = next((i for i, (a, b) in enumerate(zip(g, e)) if a != b),
                         None)
            if first is None:
                partings.append(None)
                continue
            with torch.inference_mode():
                lg, _ = prefill(params, {"tokens": torch.tensor(
                    [p + g[:first]], dtype=torch.int32, device=dev)}, dcfg)
            gap = float(lg[0, -1, g[first]] - lg[0, -1, e[first]])
            partings.append(dict(at=first, dense=g[first], engine=e[first],
                                 dense_logit_gap=gap))
        res[datapath] = dict(seconds=sec, launches=launches,
                             predicted=want, tokens=got,
                             engine_tokens=engine_toks, partings=partings)
        log(f"dense sequential_generate granite-3-2b layers={layers} "
            f"{datapath}xfp: {sec:.1f} s, launches {want} as predicted")
        for p, g, e, pt in zip(prompts, got, engine_toks, partings):
            log(f"  prompt of {len(p)}: dense {g} engine {e}"
                + ("" if pt is None else
                   f" (first parting at {pt['at']}: dense {pt['dense']} / "
                   f"engine {pt['engine']}, dense logit gap "
                   f"{pt['dense_logit_gap']:.4g})"))
    del params
    return res, totals


# tiny float32 configs at the REDUCED shapes of tests/test_models_smoke.py
# (its COMMON: mamba_chunk 8); jamba's AdamW state in float32 here, so
# that phase 6's m / v tolerances apply (its bfloat16 state trains at
# full width above)
TINY_RECURRENT = {
    "rwkv6-7b scan": ("rwkv6-7b", dict(rwkv_wkv_impl="scan")),
    "rwkv6-7b chunked": ("rwkv6-7b", dict(rwkv_wkv_impl="chunked",
                                          rwkv_chunk=8)),
    "jamba-1.5-large-398b": ("jamba-1.5-large-398b",
                             dict(opt_state_dtype="float32"))}


def _tiny_cfg(arch, **kw):
    from repro_torch.configs import get_arch
    return get_arch(arch).scaled(**{**TINY_SCALE, **TINY[arch]},
                                 mamba_chunk=8, **kw)


def tiny_dense_tokens_card_equals_cpu(torch, dev):
    """Tiny float32 granite, rwkv6 and jamba: the dense
    ``sequential_generate`` (fp, the three datapaths) and the
    ``prefill_mode="exact"`` engine (the three pairs) give the same tokens
    on the card as on the CPU."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine, sequential_generate
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    for arch in ("granite-3-2b", RWKV_ARCH, JAMBA_ARCH):
        cfg = _tiny_cfg(arch)
        cpu = live_ssm(init_params(cfg, torch.Generator().manual_seed(SEED),
                                   "cpu"))
        gpu = _to(cpu, dev)
        for datapath, fmt in PAIRS:
            toks = []
            for params, d in ((cpu, "cpu"), (gpu, dev)):
                dense = sequential_generate(params, cfg, prompts,
                                            max_new_tokens=5, max_len=32,
                                            datapath=datapath, device=d)
                eng = ServeEngine(params, cfg, max_slots=2, max_len=32,
                                  page_size=4, datapath=datapath,
                                  kv_format=fmt, prefill_mode="exact",
                                  device=d)
                for p in prompts:
                    eng.submit(p, max_new_tokens=5)
                toks.append((dense, [r.generated for r in sorted(
                    eng.run_to_completion(), key=lambda r: r.rid)]))
            if toks[0] != toks[1]:
                raise AssertionError(f"tiny {arch} {datapath}: card "
                                     f"{toks[1]} != cpu {toks[0]}")
            log(f"tiny {arch} {datapath}: dense sequential_generate (fp) and "
                f"exact-prefill engine ({fmt}) tokens on the card == cpu")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # phases 4, 6 and 7 were cut from 40 and 8 layers when phase 8 came,
    # to keep the whole run near half the driver's 1200 s
    ap.add_argument("--layers", type=int, default=20,
                    help="granite-3-2b depth to serve and train (of 40; "
                         "full width always)")
    ap.add_argument("--moe-layers", type=int, default=4,
                    help="qwen3-moe-235b-a22b depth to serve in phase 7 "
                         "(of 94; full width always)")
    ap.add_argument("--rwkv-layers", type=int, default=32,
                    help="rwkv6-7b depth to serve in phase 8 (of 32; full "
                         "width always)")
    ap.add_argument("--jamba-layers", type=int, default=5,
                    help="jamba-1.5-large-398b depth to serve in phase 8 "
                         "(of 72; full width always; 5 holds every kind "
                         "of its layers and fits one card)")
    # 8 layers run 8.4 s a step, and the profiler takes ~3 minutes over
    # the ~280 k ops of one step: 2 keep phase 9 near 150 s
    ap.add_argument("--rwkv-train-layers", type=int, default=2,
                    help="rwkv6-7b depth to train in phase 9 (of 32; full "
                         "width always)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build as kbuild
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    if "jax" in sys.modules or "repro" in sys.modules:
        raise AssertionError("the port imported jax or repro")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # wall seconds of each phase, from the start of phase 1
    phase_s, t_phase = {}, [time.perf_counter()]

    def mark(n):
        now = time.perf_counter()
        phase_s[f"phase {n}"] = now - t_phase[0]
        log(f"phase {n}: {now - t_phase[0]:.1f} s")
        t_phase[0] = now

    # phase 1: the card
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)
    mark(1)

    # phase 2: build the kernels from the checkout's sources
    res = kbuild.build()
    kbuild.library()
    log(f"build: {res.seconds:.1f} s -> {res.path.name}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "ptxas.log").write_text(res.log)
    gen = torch.Generator(dev).manual_seed(SEED)
    sass = read_sass(res.path)
    mark(2)

    # phase 3: each kernel against its plain version
    bsn = check_approx_bsn(torch, dev, gen)
    tmp = check_temporal(torch, dev, gen)
    dec = check_decode(torch, dev, gen)
    dec += check_decode(torch, dev, gen, shapes=JAMBA_DECODE_SHAPES,
                        **JAMBA_ATTN)
    pre = check_prefill(torch, dev, gen)
    pre += check_prefill(torch, dev, gen, shapes=JAMBA_PREFILL_SHAPES,
                         **JAMBA_ATTN)
    tmm = check_ternary_matmul(torch, dev, gen)
    tmb = check_ternary_matmul_batched(torch, dev, gen)
    srt = check_bsn_sort(torch, dev, gen)
    fla = check_flash(torch, dev, gen)
    mark(3)

    # phase 4: the main path at full width, then the tiny card==cpu check
    serving, launches, products = serve(torch, dev, args.layers)
    tiny_card_equals_cpu(torch, dev)
    mark(4)

    # phase 5: the SC integer datapath
    sc = sc_pipeline(torch, dev)
    for k, v in sc["launches"].items():
        launches[k] += v
    mark(5)

    # phase 6: training at full width, then the tiny card==cpu step
    training = train_arch(torch, dev, "granite-3-2b", args.layers,
                          TRAIN_BATCH)
    for k, v in training["launches"].items():
        launches[k] += v
    training["tiny_card_vs_cpu"] = tiny_train_card_equals_cpu(
        torch, dev, [("granite-3-2b", _tiny_cfg("granite-3-2b"), 100, False)])
    mark(6)

    # phase 7: a mixture of experts at full width, then tiny MoE card==cpu
    moe_serving, moe_launches = serve_arch(torch, dev, MOE_ARCH,
                                           args.moe_layers)
    for k, v in moe_launches.items():
        launches[k] += v
    for arch in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        tiny_card_equals_cpu(torch, dev, arch)
    mark(7)

    # phase 8: the recurrent mixers at full width, then tiny card==cpu
    recurrent = {}
    for arch, layers in ((RWKV_ARCH, args.rwkv_layers),
                         (JAMBA_ARCH, args.jamba_layers)):
        recurrent[arch], rec_launches = serve_arch(torch, dev, arch, layers)
        for k, v in rec_launches.items():
            launches[k] += v
        tiny_card_equals_cpu(torch, dev, arch)

    mark(8)

    # phase 9: training the recurrent mixers, the dense serving path, and
    # tiny card==cpu train steps and tokens
    recurrent_training = {
        arch: train_arch(torch, dev, arch, layers, RECURRENT_TRAIN_BATCH)
        for arch, layers in ((RWKV_ARCH, args.rwkv_train_layers),
                             (JAMBA_ARCH, JAMBA_TRAIN_LAYERS))}
    for r in recurrent_training.values():
        for k, v in r["launches"].items():
            launches[k] += v
    dense, dense_launches = dense_serving(torch, dev, args.layers)
    for k, v in dense_launches.items():
        launches[k] += v
    recurrent_training["tiny_card_vs_cpu"] = tiny_train_card_equals_cpu(
        torch, dev, [(label, _tiny_cfg(arch, **kw), 96, True)
                     for label, (arch, kw) in TINY_RECURRENT.items()])
    tiny_dense_tokens_card_equals_cpu(torch, dev)
    mark(9)

    def entry(name, source, replaces, cases, main):
        c = next(x for x in cases if x["label"] == main)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(x["max_abs_err"] for x in cases),
                "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"], "at": main}

    csrc = "src/repro_torch/kernels/csrc/"
    summary = {"kernels": [
        entry("approx_bsn", csrc + "approx_bsn.cu",
              "src/repro/kernels/approx_bsn.py:170", bsn, "lm_head block"),
        entry("approx_bsn_temporal", csrc + "approx_bsn.cu",
              "src/repro/kernels/approx_bsn.py:187", tmp, "w_up 4 slots T8"),
        entry("paged_attn_decode", csrc + "paged_attention.cu",
              "src/repro/kernels/paged_attention.py:238", dec, "fp"),
        entry("paged_attn_prefill", csrc + "paged_attention.cu",
              "src/repro/kernels/paged_attention.py:414", pre, "fp"),
        entry("ternary_matmul", csrc + "ternary_matmul.cu",
              "src/repro/kernels/ternary_matmul.py:81", tmm,
              "decode lm_head"),
        entry("ternary_matmul_batched", csrc + "ternary_matmul.cu",
              "src/repro/kernels/ternary_matmul.py:81", tmb,
              "qwen3 decode gate/up"),
        entry("bsn_sort", csrc + "bsn_sort.cu",
              "src/repro/kernels/bsn_sort.py:54", srt,
              "exact BSN q_proj 4 tokens"),
        entry("flash_attention", csrc + "flash_attention.cu",
              "src/repro/kernels/flash_attention.py:75", fla,
              "train B2 S4096 causal"),
    ]}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"device": name, "nvidia_smi": smi, "build_s": res.seconds,
         "sass": sass,
         "approx_bsn": bsn, "approx_bsn_temporal": tmp,
         "paged_attn_decode": dec, "paged_attn_prefill": pre,
         "ternary_matmul": tmm, "ternary_matmul_batched": tmb,
         "bsn_sort": srt, "flash_attention": fla,
         "serving": serving, "sc_datapath": sc, "training": training,
         "moe_serving": moe_serving, "recurrent_serving": recurrent,
         "recurrent_training": recurrent_training, "dense_serving": dense,
         "float_products": products, "phase_s": phase_s, **summary},
        indent=1))
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
