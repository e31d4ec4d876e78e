#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port serves on the card.

Drives ``src/repro_torch`` (never ``jax`` or the ``repro`` package) on one
CUDA card, in phases; any failure ends the run with a non-zero exit:

1. the card: torch's device name and ``nvidia-smi``'s name / power limit;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` and read
   their machine code (``cuobjdump -sass``): the bf16 flash and paged-
   prefill kernels must use the tensor cores (HMMA; the flash kernel at
   D 64, 80 and 128 and the paged prefill at D 64 and 128 on 16-position
   pages wgmma's HGMMA) and, at D 64, they and the split paged-decode
   kernel use no local memory (the flash kernel at D 80 neither); the
   ternary
   matmul's tensor-core kernel must use the integer tensor cores (IGMMA)
   and no local memory;
3. hold each kernel against its plain PyTorch version at the shapes its
   path gives it (the BSN adders, the ternary matmul with and without
   its SI epilogue, and the sort bit-exact; attention within a stated
   tolerance for fp / int8 / sc pools, ragged lengths and poisoned trash
   pages; the paged kernels at the serving shapes and at 4096-token
   contexts: 32 decode lanes of 1024-4095 tokens, the last 64-token
   prefill chunk of a 4096-token prompt, the prefill at qwen3-moe's GQA
   group of 16 too, logging the kernel each prefill case ran, block_q 16
   and 32 bit-equal), with kernel / plain / library-
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
   ``--layers`` of its 40 layers, 6 by default) through
   ``ServeEngine`` on qat x fp, sc_int x int8 (every projection
   through the ternary matmul kernel) and sc_int_approx x sc: every
   kernel on the path must have launched, the batched tokens must equal
   ``sequential_generate``'s, and a tiny float32 config must give the
   same tokens on the card as on the CPU; one prefill a pair is profiled
   by ternary-matmul kernel instance and by paged-prefill kernel (every
   paged-prefill call must be the wgmma kernel, as in phases 7 and 8);
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
   all its layers x 2 flash forwards must be the wgmma kernel; and
   a tiny float32 config's train step on the card equals the same step on
   the CPU within a stated tolerance;
7. serve full-width qwen3-moe-235b-a22b (128 experts top-8, qk_norm,
   bf16, seeded random weights, ``--moe-layers`` of its 94 layers, 2 by
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
   rwkv6-7b at ``--rwkv-layers`` (default 4 of its 32 layers; d 4096, 64
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
   times (the flash kernel once a layer a prefill, and the profiled
   quantization-off prefill's flash forwards the wgmma kernel; the
   ternary matmul or
   the BSN adder by the projections' rows), its tokens printed beside
   the engine's with the first parting and its logit gap (not gated: on
   the fake-quant lattice a one-ulp difference between the flash and the
   paged kernels becomes whole quanta); and tiny float32 rwkv6 (both wkv
   forms) and jamba (a whole period) train steps, dense
   ``sequential_generate`` tokens and ``prefill_mode="exact"`` engine
   tokens on the card equal to the CPU's;
10. seeded sampling, logprobs and speculative decoding on granite-3-2b at
   phase 4's depth and traffic: three lanes sampled (temperature 0.9,
   top-p 0.8, top-k 50, seeds 100-102), one greedy, logprobs=5 on a
   sampled and the greedy lane.  On the three pairs the batched tokens
   equal the paged oracle's under the same ``SamplingParams``, the
   sampled lanes part from phase 4's greedy tokens and the greedy lane
   keeps them; a pool of 24 pages (one lane outgrows it) preempts and
   gives the same tokens; on a captured decode step every logprob row's
   logsumexp is within 1e-4 of 0, the tokens outside the kept set score
   -inf, and the kept set equals a plain float64 rule's away from ties
   (a boundary within 1e-5 of flipping); ``spec_decode=True, draft_len=4`` on qat x fp and sc_int x
   int8 gives the tokens and logprobs of spec-off (and, with the target
   as its own drafter on qat x fp, accepts every draft); tiny float32
   granite and jamba give the CPU's sampled and speculative tokens on the
   card.
   It prints the sampled decode step's ms beside phase 4's greedy one,
   the sampler's device ms, and ``spec_stats`` with the ms a committed
   token, spec-on against spec-off.
11. mesh serving: 2 ranks of a (1, 2) tensor-parallel mesh on the one
   card (gloo: NCCL refuses two ranks on one card; the parent builds the
   kernels, the ranks load them) serve granite-3-2b at phase 4's depth
   and traffic on the three pairs, each rank holding 4 of 8 KV heads,
   4096 of d_ff 8192 and 24704 of the padded vocabulary's 49408: every
   rank's tokens equal phase 4's mesh-off tokens, every kernel of the
   pair's path launched on every rank, the sc_int q-domain sums of a
   captured decode step equal the mesh-off step's bit for bit, a seeded
   sampled run with logprobs and a ``spec_decode`` run on qat x fp equal
   their mesh-off runs, qwen3-moe-235b-a22b at 2 layers on sc_int x int8
   (64 experts a rank, cf 16) equals its mesh-off tokens, a (1, 1) mesh
   equals no mesh, and a tiny float32 mesh gives the same tokens on the
   card as on the CPU.  Each rank's decode ms a step, prefill ms, peak
   memory and the collectives' ms in a profiled step are printed, and
   labelled: two ranks sharing one H100 are not a tensor-parallel
   speedup.
12. the analysis gates (``repro_torch.analysis``) on the card: every
   registered launch plan's geometry equals its launcher's C++
   (``*_geometry`` entry points), the kernel audit passes with this
   build's ``ptxas`` registers, spills and static shared memory (printed
   per kernel instance), the ``inplace``, ``dtype`` and ``host`` contract
   passes hold on phase 4's engine (full-width granite at phase 4's depth)
   on qat x fp and sc_int x int8 (every device-to-host sync of a prefill
   and a decode step named by its site, each on the allowance list), the
   roofline of the qat decode step is printed beside its measured time,
   and the autotune sweeps of the prefill's ``block_q`` and of
   ``DP4A_MAX_ROWS`` print their times (candidates the audit refuses are
   pruned, never launched).  Any violation fails the run.
13. the vision and audio front ends at full width (bf16, sc_qat, seeded
   random weights) and the circuit models: hubert-xlarge
   (``--hubert-layers`` of its 48, all by default) encoded whole through
   ``forward`` over 2 utterances of 1500 frames (30 s at 50 frames/s; the
   launcher's 0.1 N(0, 1) frames of width 512): finite logits (2, 1500,
   512), frame 0's logits move with the last frame (bidirectional), one
   flash launch a layer at D 80, its ms, busy / idle share and peak
   memory; at 2 layers in float32 without quantization its logits on the
   card equal the CPU's within 1e-5 of the largest; llava-next-34b
   (``--llava-layers`` of its 60, 4 by default) through the dense
   ``prefill`` of 2 requests, each 2880 patch embeddings (1024 wide)
   and 16 text tokens (flash at GQA 7), then 8 greedy ``decode_step``s on
   the dense cache: each request's tokens in the batch equal its tokens
   alone; prefill ms, decode ms a step, peak memory.  Then Table V's
   figures from ``core/hwmodel.py`` (the baseline's calibration exact,
   the approximate adders' MSE through the approx-BSN kernels),
   ``core/fault.py`` at three bit error rates and ``core/fsm_baseline.py``
   on 1024-bit streams, card == CPU bit for bit; and the examples
   ``python -m repro_torch.examples.quickstart`` and ``design_space
   --width 4608`` exit 0 on the card.
14. the training mesh: 2 ranks on the one card over gloo train
   full-width granite-3-2b at phase 6's depth, batch, dtype and
   quantization on a (1, 2) mesh (tensor-parallel) and a (2, 1) mesh
   (FSDP over "data"), 2 steps each from phase 6's seed and batches: each
   step's loss equals phase 6's unsharded step within ``MESH_TRAIN_RTOL``
   (its grad norm printed beside it, with the kinds of leaf that move it
   most: under sc_qat the LSQ scales' gradients are sums that cancel,
   Queue 3 item 7; so are the same (1, 2) step in float32 against the
   unsharded one in float32, and the unsharded bf16 step against the
   float32 one and against itself with layer 0's ``wo`` an ulp up); one
   step with
   quantization off equals the unsharded one in loss and grad norm
   within the same tolerance, and the unsharded step on half the batch
   (a planted fault) must not; every watched leaf (gathered) moves at
   step 2,
   each rank launches the flash kernel once a layer's forward and
   recompute (on its 16 local query heads under (1, 2)); s / step, the
   collectives' ms and each rank's peak memory are printed beside the
   dry-run's predicted peak (``launch.dryrun.predict_train_peak``, traced
   on the host meanwhile), labelled: two ranks share one H100.  Then a
   tiny float32 step without quantization on both meshes on the card
   equals the CPU's unsharded step at ``TINY_TRAIN_TOL``.
15. the recurrent archs on the training mesh, the same way: 2 ranks train
   full-width rwkv6-7b at ``--rwkv-train-layers`` (the chunked wkv: the
   token scan's operands of 2 rows are past the card) and jamba's layers
   0 and 4 (mamba + dense, attention + dense) on (1, 2) and (2, 1), 2
   steps of 2 x 4096 tokens each, bf16 sc_qat: each step's loss, and a
   quantization-off step's loss and grad norm (rwkv6's in float32:
   ``FLOAT32_QUANT_OFF``), within ``MESH_TRAIN_RTOL`` of the unsharded
   steps run first; step 2 moves
   every watched leaf whose update exceeds half an ulp (phase 9's rule);
   each rank launches the flash kernel at D 128 once a forward and
   recompute of jamba's attention layer, with its 32 / 4 local heads on
   (1, 2); s / step, the collectives' ms and the peaks beside the
   dry-run's prediction.  Then long_500k's decode: jamba's layer 4 alone
   (float32, quantization off) at batch 1 over a 524288-position dense
   cache of seeded random K / V, 4 teacher-forced ``decode_step``s
   straddling the two ranks' blocks, the time cut over "data" on a (2, 1)
   mesh (the dry-run's long_500k rules): logits within ``LONG_LOGIT_RTOL``
   of mesh-off's largest and K / V written where mesh-off writes them,
   bit for bit, and nowhere else; ms a step each.  Then tiny float32 rwkv6
   and jamba (a whole period, MoE and flash) steps on both meshes on the
   card equal the CPU's unsharded step at ``TINY_TRAIN_TOL``.
16. the paper's TNN trained and served on the card: the W2-A8 QAT MLP
   (784-256-256-10, ``repro_torch.examples._qat_mlp``) trained for 250
   AdamW steps of 256 ``SyntheticClassification`` rows drawn on the card
   from seed 0, its QAT accuracy, its export (ternary weights and SI
   tables) and 4 served batches of 256 through ``ternary_matmul`` with
   the fused SI (``examples/serve_sc.py`` part 1): 2 launches a batch,
   each layer's codes equal to the plain version's and to the unfused SI
   epilogue's bit for bit, and the integer path's accuracy within the
   reference's 3.5 points of the QAT model's; the first 3 steps at batch
   16 from the init with power-of-two scales on the card equal the CPU's
   within ``TNN_STEP_TOL`` (a planted fault, the steps at twice the
   learning rate, must read above it);
   s a training step and device ms a served batch.

Phase 3 also holds the flash kernel against its plain version at phase
6's shape (O and the log-sum-exp), at jamba's attention shape (B 1, S
4096, 64 / 8 heads, D 128) and at its (1, 2) rank's (B 2, S 4096, 32 / 4
heads), at hubert's (B 2, S 1500, 16 heads of D 80, bidirectional) and
llava's prefill (B 2, S 2896, 56 / 8 heads, D 128, causal), at a ragged
bidirectional GQA shape (all bf16: the wgmma kernel), in float32 (the
CUDA-core kernel), logging the kernel each case ran, and its gradient
against autograd through the plain version at D 64 and D 128; and it
measures what rounding P to one bf16 term, to one fp16 term, or to the
kernel's two bf16 terms, does to O. Phases 4, 7 and 8 hold the
batched engine against the paged oracle
(``serving.engine._paged_sequential_generate``) on every pair;
``sequential_generate`` itself runs the dense cache for fp, as the
reference's, and phase 9 holds that.

Run from the repository root::

    python3 chip_smoke.py                 # full run (6 / 2 / 4 / 5 / 2 /
                                          # 48 / 4 layers)
    python3 chip_smoke.py --layers 2 --moe-layers 1 --rwkv-layers 2 \
        --jamba-layers 2 --rwkv-train-layers 1 --hubert-layers 2 \
        --llava-layers 1                 # quick check

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
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# The H100 SXM's published peaks (HBM3 bytes/s; bf16 and int8 tensor-core
# and fp32 CUDA-core operations/s, the last also standing for the integer
# adds and compares of the BSN kernels), the least time of a kernel's
# work (bound) and each kernel's bytes and operations: one copy, in the
# port's roofline (repro_torch.analysis.roofline, .op_cost)
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.analysis.op_cost import (
        approx_bsn_cost, batched_ternary_cost, flash_cost,
        paged_decode_cost, paged_prefill_cost, sort_cost, ternary_cost)
    from repro_torch.analysis.roofline import (BF16_OPS, FP32_OPS, HBM_BPS,
                                               INT8_OPS, bound)
    _NO_PORT = None
except ImportError as e:            # chip_smoke.py without its repository
    _NO_PORT = e

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


def kernel_bound(cost):
    """(ms, "bytes" | "operations") of an op_cost formula's (bytes,
    operations, precision)."""
    nbytes, ops, prec = cost
    return bound(nbytes, ops, {"bf16": BF16_OPS, "int8": INT8_OPS}.get(
        prec, FP32_OPS))


# the bf16 flash forward at the models' head widths (D 64, 80, 128)
MMA_KERNEL = "flash_fwd_wgmma_kernel"
# the bf16 paged prefill at the engine's pages and D 64 / 128 (wgmma)
PREFILL_WGMMA = "paged_prefill_wgmma_kernel"
SASS_KERNELS = ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel",
                "flash_fwd_kernel", "bsn_sort_reg_kernel",
                "paged_decode_split_kernel", "paged_prefill_mma_kernel",
                PREFILL_WGMMA, "ternary_matmul_mma_kernel")


def read_sass(so_path):
    """The tensor-core and register-level kernels' machine code in the
    built library (``cuobjdump -sass``): per kernel instance its tensor-
    core (HMMA / HGMMA; HGMMA alone) and local-memory (LDL / STL)
    instructions.  Each bf16 flash and paged-prefill instance must use the
    tensor cores, each wgmma flash instance (D 64, 80, 128) and each
    wgmma paged-prefill instance (D 64, 128 x bf16 / int8 / sc pools)
    wgmma's HGMMA; at D 64 the flash, both paged-prefill and the paged-
    decode kernels, and at D 80 the flash kernel, spill nothing; every
    int8 ternary-matmul
    tensor-core instance uses the integer tensor cores (IGMMA, wgmma's;
    or IMMA, mma.sync's) and no local memory."""
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
        if kernel in ("flash_fwd_wgmma_kernel", "flash_fwd_mma_kernel",
                      "bsn_sort_reg_kernel", "ternary_matmul_mma_kernel") or (
                kernel.startswith("paged_") and d64):
            kept.append("Function : " + block)
        found.append(dict(kernel=kernel, template=tmpl, d64=d64,
                          hmma=len(re.findall(r"\bH(?:G)?MMA\b", block)),
                          hgmma=len(re.findall(r"\bHGMMA\b", block)),
                          imma=len(re.findall(r"\bI(?:G)?MMA\b", block)),
                          ldl=len(re.findall(r"\bLDL\b", block)),
                          stl=len(re.findall(r"\bSTL\b", block))))
    (OUT_DIR / "sass.txt").write_text("".join(kept))
    for f in found:
        f["d128"] = re.match(r"Li128(E|$)", f["template"]) is not None
        log(f"sass {f['kernel']}<{f['template']}>: {f['hmma']} HMMA "
            f"({f['hgmma']} HGMMA), {f['imma']} IMMA / IGMMA, {f['ldl']} "
            f"LDL, {f['stl']} STL")
    # jamba's head dim: a spill there is recorded, not refused; the bf16
    # flash instances at D 128 must use the tensor cores
    d128 = [f for f in found if (f["kernel"].startswith("paged_")
                                 or f["kernel"].startswith("flash_"))
            and f["d128"]]
    log("paged and flash kernels at D 128 (local memory): " + "; ".join(
        f"{f['kernel']}<{f['template']}> {f['hmma']} HMMA {f['ldl']} LDL "
        f"{f['stl']} STL" for f in d128))
    flash128 = [f for f in d128 if f["kernel"] == MMA_KERNEL]
    if not flash128 or not all(f["hgmma"] > 0 for f in flash128):
        raise AssertionError(f"{MMA_KERNEL} at D 128: wgmma instructions "
                             f"missing: {flash128}")
    # the routes: flash wgmma at D 64, 80, 128, mma.sync at D 16, 32; the
    # paged prefill wgmma at D 64 and 128 on 16-position pages (3 pool
    # kinds each), mma.sync at every head dim (D 16, 32; D 64, 128 on
    # other pages)
    for kernel, count, op in ((MMA_KERNEL, 3, "hgmma"),
                              ("flash_fwd_mma_kernel", 2, "hmma"),
                              ("paged_prefill_mma_kernel", 12, "hmma"),
                              (PREFILL_WGMMA, 6, "hgmma")):
        inst = [f for f in found if f["kernel"] == kernel]
        if len(inst) != count or not all(f[op] > 0 for f in inst):
            raise AssertionError(f"{kernel}: tensor-core instructions "
                                 f"missing: {inst}")
    inst = [f for f in found if f["kernel"] == "ternary_matmul_mma_kernel"]
    if len(inst) != 2 or not all(f["imma"] > 0 and f["ldl"] + f["stl"] == 0
                                 for f in inst):
        raise AssertionError(f"ternary_matmul_mma_kernel: IMMA missing or "
                             f"local memory used: {inst}")
    for kernel in (MMA_KERNEL, "paged_prefill_mma_kernel", PREFILL_WGMMA,
                   "paged_decode_split_kernel"):
        d64 = [f for f in found if f["kernel"] == kernel and f["d64"]]
        if not d64 or any(f["ldl"] + f["stl"] for f in d64):
            raise AssertionError(f"{kernel} at D 64 uses local memory: "
                                 f"{d64}")
    # hubert's head: the bf16 instance at D 80 spills nothing either
    d80 = [f for f in found if f["kernel"] == MMA_KERNEL
           and re.match(r"Li80(E|$)", f["template"])]
    if len(d80) != 1 or d80[0]["ldl"] + d80[0]["stl"]:
        raise AssertionError(f"{MMA_KERNEL} at D 80: missing or uses local "
                             f"memory: {d80}")
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
        b_ms, b_by = kernel_bound(approx_bsn_cost(rows, k))
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
        b_ms, b_by = kernel_bound(ternary_cost(m, k, n, out_bsl))
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
        b_ms, b_by = kernel_bound(batched_ternary_cost(e, m, k, n))
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
        b_ms, b_by = kernel_bound(approx_bsn_cost(rows, total))
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
    return kernel_bound(sort_cost(nbytes, rows, length))


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
            b_ms, b_by = kernel_bound(paged_decode_cost(
                q_numel=q.numel(), q_itemsize=2, table_numel=tables.numel(),
                S=S, n_live=n_live, fmt=fmt, Hkv=Hkv, G=G, D=D))
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
# qwen3-moe-235b-a22b's attention (phase 7: Hkv 4, Gq 16, D 64), both chunks
QWEN3_ATTN = dict(G=16, D=64, Hkv=4)
QWEN3_PREFILL_SHAPES = (("qwen3 Gq16 ", 64, 8), ("qwen3 Gq16 4096 ", 4032,
                                                 256))
# the serving chunk on 32-position pages, two table lanes past the chunk:
# a geometry paged_prefill_mma_kernel keeps (pages other than 16)
MMA_PREFILL = dict(page=32, shapes=(("page32 ", 64, 6),))


def prefill_kernel_name(torch, q, page, fmt, kv_dtype, block_q, start,
                        width):
    """The kernel paged_attn_prefill_launch picks for these operands, by
    its C geometry (``Geometry::kernel``)."""
    from repro_torch.kernels import build as kbuild, plan as kplan
    Gr, C, Hkv, Gq, D = q.shape
    kind = {"int8": 2, "sc": 3}.get(fmt, 0 if kv_dtype == torch.float32
                                    else 1)
    geo = kbuild.geometry("paged_attn_prefill_geometry", Gr, C, Hkv, Gq, D,
                          page, width, start, block_q,
                          0 if q.dtype == torch.float32 else 1, kind)
    return kplan.PAGED_PREFILL_KERNELS[geo["kernel"]]


def check_prefill(torch, dev, gen, G=4, D=64, shapes=PREFILL_SHAPES,
                  Hkv=8, page=16):
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import paged_attn_prefill_cuda
    from repro_torch.kernels.ref import paged_attn_prefill_ref
    Gr, C, Gq = 4, 64, G
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
            # a row's result does not depend on block_q
            if not torch.equal(got, got2):
                raise AssertionError(f"prefill {label}: block_q 16 and 32 "
                                     f"differ")
            kernel = prefill_kernel_name(torch, q, page, fmt,
                                         pools["k_pages"].dtype, 32, start,
                                         width)
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
            b_ms, b_by = kernel_bound(paged_prefill_cost(
                q_numel=q.numel(), q_itemsize=2, table_numel=tables.numel(),
                G=Gr, C=C, Hkv=Hkv, Gq=Gq, D=D, start=start, fmt=fmt))
            cases.append(dict(label=label, kernel=kernel, G=Gr, C=C, Hkv=Hkv,
                              Gq=Gq, D=D, page=page, start=start,
                              width=width, max_abs_err=err, **times,
                              bound_ms=b_ms, bound_by=b_by))
            log(f"paged_attn_prefill {label} ({kernel}): start={start} "
                f"max_abs_err={err:.3g} (block_q 32, 16: equal) "
                f"poison-invisible "
                f"device ms={times['ms']:.4f} (per call with the host "
                f"{times['call_ms']:.4f}) plain_ms={times['plain_ms']:.4f} "
                f"library_ms(SDPA)={times['library_ms']:.4f} (with the "
                f"host {times['library_call_ms']:.4f}) bound_ms={b_ms:.5f} "
                f"({b_by}); block_q 16: {times['ms_block_q16']:.4f}")
            del pools, aux, got, got2, want, pois
    return cases


FLASH_SHAPE = dict(B=2, S=4096, Hq=32, Hkv=8, D=64)   # phase 6's attention
# phase 14's: a rank of the (1, 2) training mesh attends with its half of
# the query heads and the KV heads they read
FLASH_LOCAL_SHAPE = dict(B=2, S=4096, Hq=16, Hkv=4, D=64)
# jamba-1.5-large's attention layers over a train_4k sequence
JAMBA_FLASH_SHAPE = dict(B=1, S=4096, Hq=64, Hkv=8, D=128)
# phase 15's: jamba's attention on a rank of the (1, 2) training mesh, its
# half of the query heads and the KV heads they read
JAMBA_LOCAL_FLASH_SHAPE = dict(B=2, S=4096, Hq=32, Hkv=4, D=128)
# phase 13's: hubert-xlarge's encoder (2 utterances of 1500 frames, 16
# heads of 80, bidirectional) and llava-next-34b's dense prefill (2
# requests of 2880 patches + 16 tokens, 56 q heads over 8 KV heads)
HUBERT_FLASH_SHAPE = dict(B=2, S=1500, Hq=16, Hkv=16, D=80)
LLAVA_FLASH_SHAPE = dict(B=2, S=2896, Hq=56, Hkv=8, D=128)
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
    return kernel_bound(flash_cost(B, S, Hq, Hkv, D, causal, itemsize))


def p_rounding_error(torch, q, k, v, rows=512):
    """What rounding P does to O, on the first ``rows`` causal query rows
    (those that see few keys, where one weight moves O most): P as one
    bf16 term, as one fp16 term (the cheaper operand a kernel could take,
    were V in fp16) and as the kernel's bf16 hi + lo terms, each against
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
    for name, pp in (("one_bf16_term", hi),
                     ("one_fp16_term", p.to(torch.float16).float()),
                     ("bf16_hi_lo", hi + lo)):
        err = (out(pp) - exact).abs()
        res[name] = (err.max().item(), int((err > ATTN_ATOL).sum().item()))
    return res


def check_flash(torch, dev, gen):
    import torch.nn.functional as F
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.plan import FLASH_KERNELS
    from repro_torch.kernels.ref import flash_attention_ref
    cases = []
    # phase 14's and phase 15's shapes draw their inputs from streams of
    # their own, so that the other cases keep the inputs they had before
    # they came
    own_gen = {id(FLASH_LOCAL_SHAPE): torch.Generator(dev).manual_seed(
        SEED + 14), id(JAMBA_LOCAL_FLASH_SHAPE): torch.Generator(
            dev).manual_seed(SEED + 15)}
    # bf16 runs a tensor-core kernel (wgmma at these D), float32 the
    # CUDA-core one: the launch's own geometry names it
    for label, shp, causal, dtype in (
            ("train B2 S4096 causal", FLASH_SHAPE, True, torch.bfloat16),
            ("train (1, 2) local heads B2 S4096 Hq16 Hkv4 causal",
             FLASH_LOCAL_SHAPE, True, torch.bfloat16),
            ("jamba B1 S4096 Hq64 Hkv8 D128 causal", JAMBA_FLASH_SHAPE,
             True, torch.bfloat16),
            ("ragged S1000 bidirectional GQA",
             dict(B=1, S=1000, Hq=8, Hkv=2, D=64), False, torch.bfloat16),
            ("float32 S1024 causal GQA",
             dict(B=1, S=1024, Hq=8, Hkv=2, D=64), True, torch.float32),
            ("hubert B2 S1500 Hq16 D80 bidirectional", HUBERT_FLASH_SHAPE,
             False, torch.bfloat16),
            ("llava prefill B2 S2896 Hq56 Hkv8 D128 causal",
             LLAVA_FLASH_SHAPE, True, torch.bfloat16),
            ("jamba train (1, 2) local heads B2 S4096 Hq32 Hkv4 D128 causal",
             JAMBA_LOCAL_FLASH_SHAPE, True, torch.bfloat16)):
        q, k, v = _flash_inputs(torch, own_gen.get(id(shp), gen), dev,
                                **shp, dtype=dtype)
        kernel = FLASH_KERNELS[build.geometry(
            "flash_attention_geometry", shp["B"], shp["S"], shp["Hq"],
            shp["Hkv"], shp["D"], int(dtype == torch.bfloat16))["kernel"]][0]
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
                          dtype=str(dtype), kernel=kernel, max_abs_err=err,
                          lse_max_abs_err=lse_err, ms=ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
        log(f"flash_attention {label} ({kernel}): max_abs_err={err:.3g} "
            f"lse_err={lse_err:.3g} ms={ms:.4f} plain_ms={plain_ms:.4f} "
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
    next(c for c in cases if c["label"].startswith("jamba")).update(
        grad_max_abs_err=grad_errs[128])
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
    kernel instance and of each paged-prefill kernel (by the profiler's
    kernel names), the batched launches' device ms, the device busy ms
    and idle share of the whole prefill and the PyTorch ops that take the
    device time.  The engines serve bf16 at D 64 / 128 on 16-position
    pages: every paged-prefill call must have run the wgmma kernel (and,
    past a 1024-key split, its combine) and nothing else."""
    import re
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build as kbuild
    torch.cuda.synchronize()
    n0 = kbuild.LAUNCHES["paged_attn_prefill"]
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
    n_calls = kbuild.LAUNCHES["paged_attn_prefill"] - n0
    cuda = torch.autograd.DeviceType.CUDA
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == cuda]
    kernels, paged = {}, {}
    for e in events:
        for pattern, into in (
                (r"(ternary_matmul\w*_kernel<[^>]*>)", kernels),
                (r"\b((?:paged_prefill_\w+|prefill)_kernel)\b", paged)):
            hit = re.search(pattern, e.key)
            if hit:
                k = into.setdefault(hit.group(1), dict(ms=0.0, launches=0))
                k["ms"] += _dev_us(e) / 1e3
                k["launches"] += e.count
    chunks = sorted(k for k in paged if k != "paged_prefill_combine_kernel")
    if n_calls and chunks != [PREFILL_WGMMA]:
        raise AssertionError(f"profile prefill {label}: {n_calls} paged "
                             f"prefill calls ran {chunks}, not "
                             f"{PREFILL_WGMMA} alone")
    busy = sum(_dev_us(e) for e in events) / 1e3
    rows = sorted(((_dev_us(e), e.key, e.count) for e in averages
                   if e.device_type != cuda and _dev_us(e) > 0),
                  reverse=True)
    res = dict(device_busy_ms=busy, wall_ms=wall_ms,
               idle_share=1 - busy / wall_ms,
               ternary_matmul_ms=sum(k["ms"] for k in kernels.values()),
               batched_ternary_matmul_ms=batched_ms,
               ternary_matmul_kernels=kernels,
               paged_prefill_calls=n_calls, paged_prefill_kernels=paged,
               top=[dict(name=k, ms=us / 1e3, calls=n)
                    for us, k, n in rows[:10]])
    log(f"profile prefill {label}: wall_ms={wall_ms:.1f} device_busy_ms="
        f"{busy:.2f} idle_share={res['idle_share']:.3f} ternary_matmul "
        f"device ms={res['ternary_matmul_ms']:.3f} (batched "
        f"{res['batched_ternary_matmul_ms']:.3f}) by kernel: "
        + "; ".join(f"{name} {k['ms']:.3f} ms x{k['launches']}"
                    for name, k in sorted(kernels.items()))
        + f"; paged prefill: {n_calls} calls, by kernel: "
        + "; ".join(f"{name} {k['ms']:.3f} ms x{k['launches']}"
                    for name, k in sorted(paged.items()))
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
    an ulp of the entry it was added to (:func:`_update_over_half_ulp`)."""
    return _update_over_half_ulp(
        torch, *(_watch(t, arch) for t in (state.params, state.opt["m"],
                                           state.opt["v"])),
        float(state.opt["count"]), lr)


def _update_over_half_ulp(torch, params, m_w, v_w, count, lr):
    """Per watched leaf (``params``, ``m_w``, ``v_w``: whole leaves keyed
    by path), the largest ratio of the last AdamW update to half an ulp of
    the entry it was added to, recomputed from the optimizer's own m / v /
    ``count`` exactly as ``optim.adamw_update`` forms it: below 1 the
    update rounds away in the leaf's dtype, and the leaf stays."""
    import inspect
    from repro_torch.optim import adamw_update
    arg = {k: p.default for k, p in
           inspect.signature(adamw_update).parameters.items()}
    c = count
    bc1, bc2 = 1 - arg["b1"] ** c, 1 - arg["b2"] ** c
    ratios = {}
    for (k, p), m, v in zip(params.items(), m_w.values(), v_w.values()):
        step = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + arg["eps"])
        if p.ndim + k.startswith("layers/") >= 2:      # train.decay_mask
            step = step + arg["weight_decay"] * p.float()
        ulp = torch.finfo(p.dtype).eps * torch.exp2(torch.floor(torch.log2(
            p.float().abs().clamp(min=torch.finfo(p.dtype).tiny))))
        ratios[k] = (lr * step.abs() / (ulp / 2)).max().item()
    return ratios


def flash_profile(torch, events):
    """The flash forwards among a profile's events: their device ms and
    {kernel name: launches}."""
    cuda = torch.autograd.DeviceType.CUDA
    flash = [e for e in events if e.device_type == cuda
             and "flash_fwd" in e.key]
    return (sum(_dev_us(e) for e in flash) / 1e3,
            {e.key: e.count for e in flash})


def check_flash_profile(calls, n_flash, what):
    """``n_flash`` flash forwards, every one of them the wgmma kernel."""
    if (sum(calls.values()) != n_flash
            or not all(MMA_KERNEL in k for k in calls)):
        raise AssertionError(f"{what}: flash kernels {calls}, expected "
                             f"{n_flash} launches of {MMA_KERNEL}")


def profile_train_step(torch, step_fn, state, batch, n_flash,
                       label="train"):
    """One train step under torch.profiler: device busy time, the device's
    idle share of the step's wall time, and the flash forward's time over
    its ``n_flash`` launches, all of them the wgmma kernel; the step's
    metrics too."""
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
    # every flash forward of a bf16 step is the wgmma kernel
    flash_ms, flash_calls = flash_profile(torch, events)
    rows = sorted(((_dev_us(e), e.key, e.count) for e in events
                   if e.device_type != cuda and _dev_us(e) > 0),
                  reverse=True)
    (OUT_DIR / f"profile_{label}.txt").write_text(events.table(
        sort_by="self_cuda_time_total", row_limit=40))
    check_flash_profile(flash_calls, n_flash, f"profiled {label} step")
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
        if i == 0:
            by_kind = _grad_norms_by_kind(state, steps[-1]["grad_norm"])
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
               step1_grad_norm_by_kind=by_kind,
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
        # under the profiler: each layer's flash forward is the wgmma kernel
        out = {}
        prof = _profiled(torch, lambda: out.update(r=prefill(
            params, {"tokens": toks[:, :plen]}, off)), "dense_prefill")
        check_flash_profile(prof["flash_kernel_calls"], layers,
                            "the profiled dense prefill")
        lg, cache = out["r"]
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
                                 flash_kernel_calls=prof[
                                     "flash_kernel_calls"],
                                 argmax_equal=bool(torch.equal(
                                     dense.argmax(-1), paged.argmax(-1))))
    log(f"dense vs paged granite-3-2b layers={layers} quant off: prefill of "
        f"{plen} + {len(paged) - 1} decode steps, logits max |diff| / max "
        f"|logit| {err:.3g} (tol {DENSE_LOGIT_RTOL}); greedy ids equal: "
        f"{res['dense_vs_paged']['argmax_equal']}; flash launches {n_flash} "
        f"(profiled: {prof['flash_kernel_ms']:.2f} ms of {MMA_KERNEL})")
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


# ---------------------------------------------------------------------------
# phase 10: seeded sampling, logprobs and speculative decoding
# ---------------------------------------------------------------------------

SPEC_PAIRS = (("qat", "fp"), ("sc_int", "int8"))
DRAFT_LEN = 4
LSE_ATOL = 1e-4         # a full logprob row's logsumexp, float32
KEPT_MARGIN = 1e-5      # a kept-set boundary nearer than this is a near-tie
# phase 4's prompts hold 23 pages of 16 at admission (prompt + 1 each);
# the 57-token lane needs a 24th at its 8th new token, so 23 usable pages
# (plus the trash page) force a preemption
PREEMPT_PAGES = 24


def sampling_requests():
    """Three sampled lanes (seeds 100-102) and a greedy one; logprobs=5 on
    the second sampled lane and on the greedy lane."""
    from repro_torch.serving import SamplingParams
    sps = [SamplingParams(temperature=0.9, top_p=0.8, top_k=50,
                          seed=100 + i) for i in range(3)]
    sps.append(SamplingParams())
    return [dataclasses.replace(sp, logprobs=5) if i in (1, 3) else sp
            for i, sp in enumerate(sps)]


def _spy_pick(capture):
    """Wrap the engine's token pick so that its second call's (the first
    decode step's, after the batched prefill's) logits, positions and
    sampling tensors are kept; returns a function that undoes it."""
    from repro_torch.serving import engine as eng_mod
    inner = eng_mod._pick

    calls = []

    def spy(logits, positions, samp, vocab_size, do_sample, lp_k):
        calls.append(lp_k)
        if len(calls) == 2:             # the first decode step's
            capture.append((logits.clone(), positions.clone(),
                            {k: v.clone() for k, v in samp.items()}))
        return inner(logits, positions, samp, vocab_size, do_sample, lp_k)
    eng_mod._pick = spy

    def undo():
        eng_mod._pick = inner
    return undo


def serve_sampled(torch, dev, cfg, params, prompts, datapath, fmt, sps,
                  kernels, spec=False, num_pages=None,
                  perfect_draft=False):
    """Serve ``prompts`` with ``sps`` through ``ServeEngine`` (4 slots,
    pages of 16, chunks of 64), the launch counts set to 0 just before and
    read just after (every kernel of ``kernels`` must launch).  Returns the
    tokens, the logprobs records, the launches, the prefill and decode wall
    times, the decode steps, the preemptions and ``spec_stats``.
    ``perfect_draft`` drafts on the target's own datapath."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.serving import ServeEngine
    eng = ServeEngine(params, cfg, max_slots=4, max_len=256, page_size=16,
                      prefill_chunk=64, datapath=datapath, kv_format=fmt,
                      num_pages=num_pages, spec_decode=spec,
                      draft_len=DRAFT_LEN, device=dev)
    if perfect_draft:
        eng.cfg_draft = eng.cfg
    preempted = []
    grow = eng._grow_or_preempt

    def watch(active):
        before = [eng.slots[i] for i in active]
        out = grow(active)
        preempted.extend(r.rid for r in before if r._table is None)
        return out
    eng._grow_or_preempt = watch
    for p, sp in zip(prompts, sps):
        eng.submit(p, max_new_tokens=NEW_TOKENS, sampling=sp)
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._admit()
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
    tag = f"{cfg.name} {datapath}x{fmt}{' spec' if spec else ''}"
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels never launched: {missing}")
    done = sorted(done, key=lambda r: r.rid)
    if len(done) != len(prompts):
        raise AssertionError(f"{tag}: {len(done)} of {len(prompts)} "
                             f"requests finished")
    got = [r.generated for r in done]
    if any(not 0 <= t < cfg.vocab_size for g in got for t in g):
        raise AssertionError(f"{tag}: token out of vocab")
    return dict(datapath=datapath, kv_format=fmt, spec=spec, tokens=got,
                logprobs=[r.logprobs for r in done], launches=launches,
                prefill_ms=t_prefill * 1e3, decode_ms=t_decode * 1e3,
                decode_steps=steps,
                decode_ms_per_step=t_decode * 1e3 / max(steps, 1),
                # tokens committed by decode steps (prefill gives one)
                decode_tokens=sum(len(g) - 1 for g in got),
                preempted=preempted,
                spec_stats=eng.spec_stats if spec else None)


def plain_kept_set(torch, row, temperature, top_k, top_p, min_p):
    """One sampled lane's kept set by the filters' plain rule, in float64
    and with none of the sampler's code: sort the scaled row, keep every
    value >= the k-th, softmax over those, keep the shortest descending
    prefix whose preceding mass is < top_p (widened to ties), then min-p.
    Returns (kept ids, margin): the margin is the least distance of a
    boundary from flipping (relative for the k-th value, absolute for the
    top-p mass and the min-p probability)."""
    x = row.double() / max(float(temperature), 1e-8)
    srt = torch.sort(x, descending=True).values
    V = x.numel()
    k = min(max(int(top_k) if int(top_k) > 0 else V, 1), V)
    kth = srt[k - 1]
    keep = x >= kth
    below = srt[srt < kth]          # ties at the k-th value are all kept
    margins = [float((kth - below[0]) / kth.abs().clamp_min(1e-30))
               if below.numel() else float("inf")]
    p = torch.softmax(torch.where(keep, x, -torch.inf), dim=0)
    sp = torch.sort(p, descending=True).values
    before = torch.cumsum(sp, 0) - sp
    n = int((before < float(top_p)).sum())
    keep = keep & (p >= sp[n - 1])
    if float(top_p) < 1:            # 1 turns the filter off
        if sp[n - 1] > 0:
            margins.append(float(top_p) - float(before[n - 1]))
        if n < V and sp[n] > 0:
            margins.append(float(before[n]) - float(top_p))
    thr = float(min_p) * float(p.max())
    keep = keep & (p >= thr)
    if float(min_p) > 0:
        margins.append(float((p - thr).abs().min()))
    return set(torch.nonzero(keep)[:, 0].tolist()), min(margins)


def check_logprob_rows(torch, cfg, captured):
    """On a captured decode step (the engine's own logits): every lane's
    full logprob row has logsumexp within LSE_ATOL of 0; a sampled lane's
    finite entries are exactly its kept set, a greedy lane's all finite;
    and a sampled lane's kept set equals :func:`plain_kept_set`'s unless a
    boundary lies within KEPT_MARGIN of flipping (a near-tie, counted).
    Returns the sampler's, the logprobs' and the argmax's device ms on
    those logits."""
    from repro_torch.serving.sampling import (filter_logits, greedy_tokens,
                                              sample_tokens,
                                              token_logprobs)
    logits, pos, samp = captured
    V = cfg.vocab_size
    tok = sample_tokens(logits, pos, samp, V)
    _, ids, lps = token_logprobs(logits, tok, samp, V, V)
    lse = torch.logsumexp(lps, dim=-1)
    if lse.abs().max() > LSE_ATOL:
        raise AssertionError(f"logprob rows' logsumexp {lse.tolist()}")
    masked = filter_logits(logits[:, :V].float(), samp["temperature"],
                           samp["top_k"], samp["top_p"], samp["min_p"])
    kept, margins, near_ties = [], [], 0
    for s in range(logits.shape[0]):
        fin = set(ids[s][torch.isfinite(lps[s])].tolist())
        want = set(range(V)) if samp["temperature"][s] == 0 else \
            set(torch.nonzero(torch.isfinite(masked[s]))[:, 0].tolist())
        if fin != want:
            raise AssertionError(f"lane {s}: {len(fin)} finite logprobs, "
                                 f"{len(want)} kept tokens")
        kept.append(len(want))
        if samp["temperature"][s] > 0:
            plain, margin = plain_kept_set(
                torch, logits[s, :V].float(), samp["temperature"][s],
                samp["top_k"][s], samp["top_p"][s], samp["min_p"][s])
            margins.append(margin)
            if margin < KEPT_MARGIN:
                near_ties += 1
            elif plain != want:
                raise AssertionError(
                    f"lane {s}: {len(want)} kept tokens, the plain rule "
                    f"keeps {len(plain)} (margin {margin:.3e})")
    return dict(
        logsumexp_max_abs=float(lse.abs().max()), kept=kept,
        plain_kept_margin=min(margins), plain_kept_near_ties=near_ties,
        sampler_ms=device_ms(torch, lambda: sample_tokens(logits, pos, samp,
                                                          V)),
        logprobs_ms=device_ms(torch, lambda: token_logprobs(
            logits, tok, samp, V, 8)),
        greedy_ms=device_ms(torch, lambda: greedy_tokens(logits, V)))


def _spec_kernels(datapath):
    return tuple(dict.fromkeys(PATH_KERNELS[datapath]
                               + PATH_KERNELS["sc_int_approx"]))


def sampled_serving(torch, dev, layers, greedy_runs, smi):
    """Phase 10 at full width (see the module docstring); ``greedy_runs``
    are phase 4's results on the same weights and prompts."""
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serving.engine import (_cfg_for_datapath,
                                            _paged_sequential_generate)
    cfg = get_arch("granite-3-2b")
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = _prompts(torch, cfg, (32, 57, 96, 128))
    sps = sampling_requests()
    greedy = {r["datapath"]: r for r in greedy_runs}
    totals = dict.fromkeys(PATH_KERNELS["sc_int_approx"]
                           + PATH_KERNELS["sc_int"], 0)
    out = dict(layers=layers, requests=[dataclasses.asdict(sp)
                                        for sp in sps], runs=[])

    def add(res):
        for k, v in res["launches"].items():
            totals[k] = totals.get(k, 0) + v
        out["runs"].append(res)

    plain = {}
    for datapath, fmt in PAIRS:
        capture = []
        undo = _spy_pick(capture)
        try:
            res = serve_sampled(torch, dev, cfg, params, prompts, datapath,
                                fmt, sps, PATH_KERNELS[datapath])
        finally:
            undo()
        tag = f"{datapath}x{fmt}"
        want = _paged_sequential_generate(
            params, _cfg_for_datapath(cfg, datapath), prompts, NEW_TOKENS,
            None, 256, fmt, 16, dev, sps)
        if res["tokens"] != want:
            raise AssertionError(f"sampled {tag}: batched tokens differ "
                                 f"from the paged oracle\n{res['tokens']}"
                                 f"\n{want}")
        g = greedy[datapath]["tokens"]
        if res["tokens"][3] != g[3]:
            raise AssertionError(f"sampled {tag}: the greedy lane parts "
                                 f"from phase 4's tokens")
        if any(res["tokens"][i] == g[i] for i in range(3)):
            raise AssertionError(f"sampled {tag}: a sampled lane gave the "
                                 f"greedy tokens")
        res["lanes"] = check_logprob_rows(torch, cfg, capture[0])
        res["greedy_decode_ms_per_step"] = \
            greedy[datapath]["decode_ms_per_step"]
        add(res)
        plain[datapath] = res
        la = res["lanes"]
        log(f"sampled granite-3-2b {tag} ({smi}): batched == paged oracle, "
            f"greedy lane == phase 4; decode_ms_per_step sampled "
            f"{res['decode_ms_per_step']:.1f} vs greedy (phase 4) "
            f"{res['greedy_decode_ms_per_step']:.1f}; sampler device ms "
            f"{la['sampler_ms']:.3f}, logprobs (k 8) {la['logprobs_ms']:.3f}"
            f", argmax {la['greedy_ms']:.3f} at 4 x {cfg.vocab_size}; "
            f"logsumexp |max| {la['logsumexp_max_abs']:.2e}; kept "
            f"{la['kept']} (== the plain float64 rule, least boundary "
            f"margin {la['plain_kept_margin']:.3e}, near-ties "
            f"{la['plain_kept_near_ties']}); launches {res['launches']}")

    # (b) a pool that one lane outgrows: preemption replays the streams
    res = serve_sampled(torch, dev, cfg, params, prompts, "qat", "fp", sps,
                        PATH_KERNELS["qat"], num_pages=PREEMPT_PAGES)
    if not res["preempted"]:
        raise AssertionError("the small pool never preempted")
    if res["tokens"] != plain["qat"]["tokens"]:
        raise AssertionError(f"preempted tokens differ\n{res['tokens']}")
    res["role"] = "preemption"
    add(res)
    log(f"sampled qatxfp with {PREEMPT_PAGES} pages ({smi}): preempted "
        f"rids {res['preempted']}, tokens equal")

    # (d) speculative decoding against spec-off
    for datapath, fmt in SPEC_PAIRS:
        res = serve_sampled(torch, dev, cfg, params, prompts, datapath, fmt,
                            sps, _spec_kernels(datapath), spec=True)
        off = plain[datapath]
        tag = f"{datapath}x{fmt}"
        if res["tokens"] != off["tokens"]:
            raise AssertionError(f"spec {tag}: tokens differ from "
                                 f"spec-off\n{res['tokens']}\n"
                                 f"{off['tokens']}")
        for a, b in zip(res["logprobs"], off["logprobs"]):
            if len(a) != len(b) or any(
                    [t for t, _ in x["top"]] != [t for t, _ in y["top"]]
                    or abs(x["logprob"] - y["logprob"]) > 1e-6
                    for x, y in zip(a, b)):
                raise AssertionError(f"spec {tag}: logprobs differ from "
                                     f"spec-off")
        st = res["spec_stats"]
        res["ms_per_token"] = res["decode_ms"] / res["decode_tokens"]
        res["spec_off_ms_per_token"] = off["decode_ms"] / \
            off["decode_tokens"]
        add(res)
        log(f"spec granite-3-2b {tag} draft_len {DRAFT_LEN} ({smi}): "
            f"tokens and logprobs == spec-off; acceptance "
            f"{st['acceptance_rate']:.3f}, tokens a round "
            f"{st['tokens_per_round']:.2f} over {st['rounds']} rounds; ms a "
            f"committed token {res['ms_per_token']:.1f} vs spec-off "
            f"{res['spec_off_ms_per_token']:.1f}; launches "
            f"{res['launches']}")

    # (d') the drafter pointed at the target: every draft is accepted, so
    # the commit of accepted drafts runs at full width too
    res = serve_sampled(torch, dev, cfg, params, prompts, "qat", "fp", sps,
                        PATH_KERNELS["qat"], spec=True, perfect_draft=True)
    st = res["spec_stats"]
    if res["tokens"] != plain["qat"]["tokens"] \
            or st["acceptance_rate"] != 1.0:
        raise AssertionError(f"spec with the target as drafter: {st}\n"
                             f"{res['tokens']}")
    res["role"] = "perfect drafter"
    res["ms_per_token"] = res["decode_ms"] / res["decode_tokens"]
    add(res)
    log(f"spec granite-3-2b qatxfp, the target as drafter ({smi}): tokens "
        f"== spec-off, acceptance 1.0, tokens a round "
        f"{st['tokens_per_round']:.2f} over {st['rounds']} rounds; ms a "
        f"committed token {res['ms_per_token']:.1f}")
    return out, totals


def tiny_sampled_card_equals_cpu(torch, dev):
    """Tiny float32 granite and jamba: sampled tokens (the three pairs) and
    speculative tokens (qat x fp, sc_int x int8) on the card equal the
    CPU's, and spec-on equals spec-off."""
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]]
    sps = sampling_requests()
    for arch in ("granite-3-2b", JAMBA_ARCH):
        cfg = _tiny_cfg(arch)
        cpu = live_ssm(init_params(cfg, torch.Generator().manual_seed(SEED),
                                   "cpu"))
        gpu = _to(cpu, dev)
        for datapath, fmt in PAIRS:
            specs = (False, True) if (datapath, fmt) in SPEC_PAIRS \
                else (False,)
            for spec in specs:
                toks = []
                for params, d in ((cpu, "cpu"), (gpu, dev)):
                    eng = ServeEngine(params, cfg, max_slots=2, max_len=32,
                                      page_size=4, datapath=datapath,
                                      kv_format=fmt, spec_decode=spec,
                                      draft_len=DRAFT_LEN, device=d)
                    for p, sp in zip(prompts, sps):
                        eng.submit(p, max_new_tokens=6, sampling=sp)
                    toks.append([r.generated for r in sorted(
                        eng.run_to_completion(), key=lambda r: r.rid)])
                if toks[0] != toks[1]:
                    raise AssertionError(
                        f"tiny {arch} {datapath}x{fmt} spec={spec}: card "
                        f"{toks[1]} != cpu {toks[0]}")
                if spec and toks[1] != plain:
                    raise AssertionError(f"tiny {arch} {datapath}x{fmt}: "
                                         f"spec-on != spec-off")
                plain = toks[1]
            log(f"tiny {arch} {datapath}x{fmt}: sampled"
                f"{' and spec' if len(specs) > 1 else ''} tokens on the "
                f"card == cpu")


# ---------------------------------------------------------------------------
# phase 11: mesh serving, 2 ranks of a tensor-parallel mesh on the one card
# ---------------------------------------------------------------------------

MESH_RANKS = 2
MESH_MOE_LAYERS = 2
MESH_LABEL = "2 ranks sharing one H100; not a tensor-parallel speedup"


def _granite_cfg(layers, mode=None):
    """granite-3-2b at ``layers``, its registered quantization or
    ``mode``."""
    from repro_torch.configs import get_arch
    cfg = get_arch("granite-3-2b")
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    return cfg.scaled(quant=cfg.quant.with_mode(mode)) if mode else cfg


def _granite(torch, dev, layers):
    from repro_torch.models import init_params
    cfg = _granite_cfg(layers)
    return cfg, init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)


def _moe_cfg(layers):
    from repro_torch.configs import get_arch
    base = get_arch(MOE_ARCH)
    return base.scaled(n_layers=layers, moe_capacity_factor=float(
        base.n_experts // base.n_experts_per_tok))


def _engine(params, cfg, dev, datapath, fmt, mesh=None, **kw):
    from repro_torch.serving import ServeEngine
    return ServeEngine(params, cfg, max_slots=4, max_len=256, page_size=16,
                       prefill_chunk=64, datapath=datapath, kv_format=fmt,
                       device=dev, mesh=mesh, **kw)


def _serve_timed(torch, eng, prompts, new_tokens, sps=None):
    """Queue ``prompts``, prefill (timed), decode to the end (timed), with
    the launch counts set to 0 just before: tokens, logprobs, ms, launches
    and the peak memory."""
    from repro_torch.kernels import build as kbuild
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=new_tokens,
                   sampling=None if sps is None else sps[i])
    torch.cuda.reset_peak_memory_stats()
    kbuild.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._admit()
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    done, steps = [], 0
    t1 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        done += eng.step()
        steps += 1
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t1
    done = sorted(done, key=lambda r: r.rid)
    return dict(tokens=[r.generated for r in done],
                logprobs=[r.logprobs for r in done],
                prefill_ms=t_prefill * 1e3, decode_steps=steps,
                decode_ms_per_step=t_decode * 1e3 / max(steps, 1),
                launches=dict(kbuild.LAUNCHES),
                max_memory_allocated=torch.cuda.max_memory_allocated())


def _captured_sums(torch, eng, prompts):
    """Every sc_int q-domain sum of the first decode step after the
    batched prefill, in call order, on the host."""
    from repro_torch.core import sc_layers
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    eng._admit()
    inner, sums = sc_layers.sc_linear_int, []

    def spy(int_params, x_q):
        out = inner(int_params, x_q)
        sums.append(out.cpu().numpy())
        return out
    sc_layers.sc_linear_int = spy
    try:
        eng.step()
    finally:
        sc_layers.sc_linear_int = inner
    return sums


def _collective_step(torch, eng):
    """One decode step (the engine's third) under torch.profiler, each
    mesh gather timed by a pair of CUDA events: the device busy ms and
    the collectives' ms (each gather's device-to-host copy, gloo, and
    host-to-device copy, the card idle in between)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed import sharding
    eng.step()
    eng.step()
    inner, pairs = sharding.gather, []

    def timed(x, axis=sharding.MODEL, dim=-1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = inner(x, axis, dim)
        b.record()
        pairs.append((a, b))
        return out
    # every module that imported the function by name
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("repro_torch.")
            and getattr(m, "gather", None) is inner]
    torch.cuda.synchronize()
    for m in mods:
        m.gather = timed
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for m in mods:
            m.gather = inner
    cuda = torch.autograd.DeviceType.CUDA
    busy = sum(_dev_us(e) for e in prof.key_averages()
               if e.device_type == cuda) / 1e3
    return dict(wall_ms=wall, device_busy_ms=busy, gathers=len(pairs),
                collective_ms=sum(a.elapsed_time(b) for a, b in pairs))


def mesh_rank_work(torch, rules, layers, dev):
    """One rank of phase 11 (both ranks run it): granite-3-2b at ``layers``
    on the three pairs under the (1, 2) mesh, a captured sc_int step, a
    sampled run with logprobs and a speculative run on qat x fp, a
    profiled step, qwen3-moe at ``MESH_MOE_LAYERS`` layers expert-parallel
    on sc_int x int8, and a tiny float32 mesh on the card and on the
    CPU."""
    from repro_torch.models import init_params
    cfg, params = _granite(torch, dev, layers)
    prompts = _prompts(torch, cfg, (32, 57, 96, 128))
    out = {"pairs": {}}
    for datapath, fmt in PAIRS:
        out["pairs"][datapath] = _serve_timed(
            torch, _engine(params, cfg, dev, datapath, fmt, rules), prompts,
            NEW_TOKENS)
    out["sums"] = _captured_sums(
        torch, _engine(params, cfg, dev, "sc_int", "int8", rules), prompts)
    out["sampled"] = _serve_timed(
        torch, _engine(params, cfg, dev, "qat", "fp", rules), prompts,
        NEW_TOKENS, sampling_requests())
    out["spec"] = _serve_timed(
        torch, _engine(params, cfg, dev, "qat", "fp", rules,
                       spec_decode=True, draft_len=DRAFT_LEN), prompts,
        NEW_TOKENS)
    eng = _engine(params, cfg, dev, "qat", "fp", rules)
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    out["profile"] = _collective_step(torch, eng)
    del eng, params
    torch.cuda.empty_cache()
    mcfg = _moe_cfg(MESH_MOE_LAYERS)
    mparams = init_params(mcfg, torch.Generator(dev).manual_seed(SEED), dev)
    out["moe"] = _serve_timed(
        torch, _engine(mparams, mcfg, dev, "sc_int", "int8", rules),
        _prompts(torch, mcfg, (32, 57, 96, 128)), ARCH_NEW_TOKENS)
    del mparams
    torch.cuda.empty_cache()
    tcfg = _tiny_cfg("granite-3-2b")
    cpu = init_params(tcfg, torch.Generator().manual_seed(SEED), "cpu")
    tiny = {}
    for datapath, fmt in PAIRS:
        for params_d, d, on in ((cpu, "cpu", "cpu"),
                                (_to(cpu, dev), dev, "card")):
            from repro_torch.serving import ServeEngine
            e = ServeEngine(params_d, tcfg, max_slots=2, max_len=32,
                            page_size=4, datapath=datapath, kv_format=fmt,
                            device=d, mesh=rules)
            for p in ([1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12, 13, 14]):
                e.submit(p, max_new_tokens=5)
            tiny[f"{datapath}/{on}"] = [r.generated for r in sorted(
                e.run_to_completion(), key=lambda r: r.rid)]
    out["tiny"] = tiny
    return out


def mesh_rank(rank, port, layers, queue):
    """The entry point of a spawned rank: the gloo group over localhost,
    the (1, 2) serving mesh, the kernels the parent built (loaded, not
    rebuilt), then :func:`mesh_rank_work`.  Any failure goes back to the
    parent, which fails the run."""
    import datetime
    import traceback

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}",
            world_size=MESH_RANKS, rank=rank,
            timeout=datetime.timedelta(seconds=600))
        from repro_torch.kernels import build as kbuild
        kbuild.library()
        from repro_torch.launch.mesh import make_serving_mesh, serving_rules
        rules = serving_rules(make_serving_mesh(
            model_parallel=MESH_RANKS, backend="gloo"))
        out = mesh_rank_work(torch, rules, layers, torch.device("cuda"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _spawn_ranks(layers, timeout=900):
    """Start the ranks of phase 11 and wait for them."""
    return _spawn(mesh_rank, (layers,), "phase 11", timeout)


def _spawn(target, args, what, timeout=900):
    """Start ``MESH_RANKS`` ranks of ``target(rank, port, *args, queue)``
    and wait for them; every rank must report and exit 0, and none
    outlives this call."""
    import socket
    import torch.multiprocessing as mp
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, *args, queue),
                         daemon=True) for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in procs:
            rank, out, err = queue.get(timeout=timeout)
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if errors or any(c != 0 for c in codes):
        raise AssertionError(f"{what}: mesh ranks failed (exit codes "
                             f"{codes})\n" + "\n".join(errors))
    return [results[r] for r in range(MESH_RANKS)]


def _mesh_off(torch, dev, layers):
    """Phase 11's mesh-off runs, before any rank starts (so that the card
    never holds three copies of a model): the captured sc_int step, the
    sampled and speculative qat x fp runs, a (1, 1) mesh with no process
    group (tokens), and qwen3-moe at ``MESH_MOE_LAYERS`` layers."""
    from repro_torch.launch.mesh import make_serving_mesh, serving_rules
    from repro_torch.models import init_params
    cfg, params = _granite(torch, dev, layers)
    prompts = _prompts(torch, cfg, (32, 57, 96, 128))
    off = {"sums": _captured_sums(
        torch, _engine(params, cfg, dev, "sc_int", "int8"), prompts)}
    off["sampled"] = _serve_timed(torch, _engine(params, cfg, dev, "qat",
                                                 "fp"), prompts, NEW_TOKENS,
                                  sampling_requests())
    off["spec"] = _serve_timed(
        torch, _engine(params, cfg, dev, "qat", "fp", spec_decode=True,
                       draft_len=DRAFT_LEN), prompts, NEW_TOKENS)
    one = serving_rules(make_serving_mesh(model_parallel=1))
    off["mesh_1x1"] = _serve_timed(
        torch, _engine(params, cfg, dev, "qat", "fp", one), prompts,
        NEW_TOKENS)
    del params
    torch.cuda.empty_cache()
    mcfg = _moe_cfg(MESH_MOE_LAYERS)
    mparams = init_params(mcfg, torch.Generator(dev).manual_seed(SEED), dev)
    off["moe"] = _serve_timed(
        torch, _engine(mparams, mcfg, dev, "sc_int", "int8"),
        _prompts(torch, mcfg, (32, 57, 96, 128)), ARCH_NEW_TOKENS)
    del mparams
    torch.cuda.empty_cache()
    return off


def mesh_serving(torch, dev, layers, greedy_runs, smi):
    """Phase 11 (see the module docstring); ``greedy_runs`` are phase 4's
    mesh-off results on the same weights and prompts.  Returns the
    results and the ranks' launch counts, summed."""
    from repro_torch.kernels import build as kbuild
    off = _mesh_off(torch, dev, layers)
    phase4 = {r["datapath"]: r["tokens"] for r in greedy_runs}
    if off["mesh_1x1"]["tokens"] != phase4["qat"]:
        raise AssertionError("phase 11: a (1, 1) mesh's tokens differ from "
                             "no mesh's")
    log("phase 11: (1, 1) mesh == no mesh (granite qat x fp tokens)")
    t0 = time.perf_counter()
    ranks = _spawn_ranks(layers)
    ranks_s = time.perf_counter() - t0
    launches = dict.fromkeys(kbuild.KERNELS, 0)
    for rank, res in enumerate(ranks):
        for datapath, fmt in PAIRS:
            r = res["pairs"][datapath]
            tag = f"phase 11 rank {rank} granite {datapath}x{fmt}"
            if r["tokens"] != phase4[datapath]:
                raise AssertionError(f"{tag}: mesh tokens differ from "
                                     f"phase 4's mesh-off tokens\n"
                                     f"{r['tokens']}\n{phase4[datapath]}")
            missing = [k for k in PATH_KERNELS[datapath]
                       if r["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{tag}: kernels never launched: "
                                     f"{missing}")
            for k, v in r["launches"].items():
                launches[k] += v
            log(f"{tag}: prefill_ms={r['prefill_ms']:.1f} "
                f"decode_ms_per_step={r['decode_ms_per_step']:.1f} "
                f"max_memory_allocated="
                f"{r['max_memory_allocated'] / 2**30:.2f} GiB launches="
                f"{ {k: v for k, v in r['launches'].items() if v} } "
                f"({MESH_LABEL}; {smi})")
        m = res["moe"]
        if m["tokens"] != off["moe"]["tokens"]:
            raise AssertionError(f"phase 11 rank {rank} qwen3-moe: mesh "
                                 f"tokens differ from mesh-off")
        missing = [k for k in arch_path_kernels(_moe_cfg(MESH_MOE_LAYERS),
                                                "sc_int")
                   if m["launches"][k] == 0]
        if missing:
            raise AssertionError(f"phase 11 rank {rank} qwen3-moe: kernels "
                                 f"never launched: {missing}")
        for k, v in m["launches"].items():
            launches[k] += v
        for key in ("sampled", "spec"):
            if (res[key]["tokens"], res[key]["logprobs"]) != (
                    off[key]["tokens"], off[key]["logprobs"]):
                raise AssertionError(f"phase 11 rank {rank}: {key} run "
                                     f"differs from mesh-off")
            for k, v in res[key]["launches"].items():
                launches[k] += v
        for datapath, fmt in PAIRS:
            tiny = res["tiny"]
            if tiny[f"{datapath}/cpu"] != tiny[f"{datapath}/card"]:
                raise AssertionError(f"phase 11 rank {rank} tiny "
                                     f"{datapath}x{fmt}: card != cpu")
        p = res["profile"]
        log(f"phase 11 rank {rank}: profiled qat decode step wall_ms="
            f"{p['wall_ms']:.1f} device_busy_ms={p['device_busy_ms']:.1f} "
            f"collective_ms={p['collective_ms']:.1f} over {p['gathers']} "
            f"gathers; qwen3-moe {MESH_MOE_LAYERS} layers sc_int x int8 "
            f"decode_ms_per_step={m['decode_ms_per_step']:.1f} "
            f"prefill_ms={m['prefill_ms']:.1f} ({MESH_LABEL}; {smi})")
    import numpy as np
    want = off["sums"]
    if not want or any(len(r["sums"]) != len(want) for r in ranks):
        raise AssertionError("phase 11: captured steps differ in length")
    for i, parts in enumerate(zip(*(r["sums"] for r in ranks))):
        got = np.concatenate(parts, axis=-1)
        if got.shape != want[i].shape or not np.array_equal(got, want[i]):
            raise AssertionError(f"phase 11: sc_int sum {i} of the captured "
                                 f"step differs from mesh-off")
    log(f"phase 11: mesh tokens == phase 4 on the three pairs, sc_int sums "
        f"of a step ({len(want)} products) == mesh-off bit for bit, "
        f"sampled + logprobs and spec_decode == mesh-off, qwen3-moe "
        f"expert-parallel == mesh-off, tiny mesh card == cpu; ranks "
        f"{ranks_s:.1f} s")
    return dict(ranks=[{k: v for k, v in r.items() if k != "sums"}
                       for r in ranks], ranks_s=ranks_s,
                label=MESH_LABEL, nvidia_smi=smi,
                mesh_off={k: v for k, v in off.items() if k != "sums"},
                sums_checked=len(want)), launches


# ---------------------------------------------------------------------------
# phase 12: the analysis gates on the card
# ---------------------------------------------------------------------------

def plan_equals_geometry(torch, kbuild):
    """Every registered launch plan's geometry against its launcher's C++
    (``*_geometry``) on this card; returns the number of cases."""
    from repro_torch.kernels.dispatch import KERNEL_REGISTRY
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bad, n = [], 0
    for entry in KERNEL_REGISTRY.values():
        for label, kw in entry.cases():
            want = entry.plan(sms=sms, **kw).geometry()
            got = kbuild.geometry(entry.geometry_entry,
                                  *entry.geometry_args(**kw))
            n += 1
            if got != want:
                bad.append((entry.name, label, {
                    k: (want[k], got[k]) for k in want
                    if want[k] != got[k]}))
    if bad:
        raise AssertionError(f"launch plans differ from the C geometry "
                             f"(plan, C): {bad}")
    return n, sms


def kernel_instances(kernels, sms):
    """This build's registers, spills and static shared memory of every
    kernel instance a registered case launches, beside the case's threads
    and dynamic shared memory (the largest of its cases)."""
    from repro_torch.analysis.kernel_audit import find_instance
    from repro_torch.kernels.dispatch import KERNEL_REGISTRY
    out = {}
    for entry in KERNEL_REGISTRY.values():
        for label, kw in entry.cases():
            plan = entry.plan(sms=sms, **kw)
            for p in (plan, plan.combine):
                if p is None:
                    continue
                k = find_instance(kernels, p.kernel)
                row = out.setdefault(p.kernel, dict(
                    launcher=entry.name, registers=k["registers"],
                    spill_stores=k["spill_stores"],
                    spill_loads=k["spill_loads"], static_smem=k["smem"],
                    threads=p.threads, dynamic_smem=0, case=label))
                if p.smem >= row["dynamic_smem"]:
                    row.update(dynamic_smem=p.smem, threads=p.threads,
                               case=label)
    return out


def analysis_gates(torch, dev, layers, smi, ptxas_log):
    """Phase 12: plans == C geometry, the kernel audit with this build's
    ptxas log, the contract passes on phase 4's engine (qat x fp and
    sc_int x int8), the roofline of its qat decode step and the autotune
    sweeps; any violation raises."""
    from repro_torch.analysis.contracts import run_engine_contracts
    from repro_torch.analysis.kernel_audit import (audit_registry,
                                                   parse_ptxas_log)
    from repro_torch.analysis.op_cost import step_cost
    from repro_torch.analysis.report import roofline_table
    from repro_torch.analysis.roofline import StepShape, roofline_from_step
    from repro_torch.configs import get_arch
    from repro_torch.kernels import autotune
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import init_params
    from repro_torch.serving import ServeEngine
    out = {"nvidia_smi": smi}
    n, sms = plan_equals_geometry(torch, kbuild)
    out["geometry_cases"] = n
    log(f"analysis: {n} launch plans == their C geometry ({sms} SMs)")

    audit = audit_registry(ptxas_log=ptxas_log, sms=sms)
    bad = [(k, v["message"]) for k, c in audit["kernels"].items()
           for p in c["passes"] for v in p["violations"]]
    if bad:
        raise AssertionError(f"kernel audit with this build's ptxas log: "
                             f"{bad[:10]}")
    kernels = parse_ptxas_log(ptxas_log)
    out["kernel_audit_cells"] = len(audit["kernels"])
    out["instances"] = kernel_instances(kernels, sms)
    log(f"kernel audit: {len(audit['kernels'])} cells clean with this "
        f"build's ptxas log ({smi}); by kernel instance:")
    for k, r in sorted(out["instances"].items()):
        log(f"  {k} ({r['launcher']}, largest at {r['case']}): "
            f"{r['registers']} registers x {r['threads']} threads, spills "
            f"{r['spill_stores']} / {r['spill_loads']} B, smem "
            f"{r['dynamic_smem']} dynamic + {r['static_smem']} static B")

    cfg = get_arch("granite-3-2b")
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    prompts = _prompts(torch, cfg, (32, 57, 96, 128))

    def engine(datapath, fmt):
        return ServeEngine(params, cfg, max_slots=4, max_len=256,
                           page_size=16, prefill_chunk=64,
                           datapath=datapath, kv_format=fmt, device=dev)
    out["contracts"] = {}
    for datapath, fmt in (("qat", "fp"), ("sc_int", "int8")):
        label = f"granite/{datapath}/{fmt}"
        results = run_engine_contracts(engine(datapath, fmt), label,
                                       prompts, on_card=True)
        out["contracts"][label] = [r.to_dict() for r in results]
        bad = [v.message for r in results for v in r.violations]
        if bad:
            raise AssertionError(f"contracts {label}: {bad}")
        for r in results:
            log(f"contract {r.passname} {r.label}: ok; "
                + "; ".join(r.notes))

    # the roofline of the qat decode step: one step unrecorded (timed),
    # then one counted
    eng = engine("qat", "fp")
    for p in prompts:
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    eng._admit()
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    measured = time.perf_counter() - t0
    cost = step_cost(eng.step)
    rep = roofline_from_step(
        cost, eng.cfg, StepShape("decode 4 lanes", 256, 4, "decode"),
        measured_s=measured,
        peak_hbm_bytes=torch.cuda.max_memory_allocated(),
        note=f"{cfg.name} at {layers} layers, phase 4's engine; {smi}")
    out["roofline"] = [dataclasses.asdict(rep)]
    out["roofline_top"] = cost.top(10)
    log(f"roofline of the qat decode step ({smi}):\n"
        + roofline_table(out["roofline"]))
    log("  counted by site (ops, bytes): " + "; ".join(
        f"{s} {o:.3g} {b:.3g}" for s, o, b in out["roofline_top"]))

    # autotune sweeps (report only: no default changes)
    gen = torch.Generator(dev).manual_seed(SEED)
    sweeps = {}
    Hkv, Gq, page, width = 8, 4, 16, 16
    # phase 3's serving chunk (the second 64 of a 128-token prompt) on the
    # bf16 kernel (at most 128 / Gq = 32 rows a block); a 256-row chunk
    # on the float32 kernel, whose block_q 256 needs 298 KB of shared
    # memory and is pruned
    for tag, dtype, d, Gr, C, start, cands in (
            ("bf16 D64 fp, 4 x 64 at 64", torch.bfloat16, 64, 4, 64, 64,
             (8, 16, 32)),
            ("float32 D128 fp32, 1 x 256 at 0", torch.float32, 128, 1, 256,
             0, (16, 32, 64, 128, 256))):
        N = Gr * width + 1
        tables = (torch.randperm(N - 1, generator=gen, device=dev) + 1)[
            :Gr * width].reshape(Gr, width).to(torch.int32).contiguous()
        q = torch.randn((Gr, C, Hkv, Gq, d), generator=gen,
                        device=dev).to(dtype)
        kp = torch.randn((N, page, Hkv, d), generator=gen,
                         device=dev).to(dtype)
        vp = torch.randn((N, page, Hkv, d), generator=gen,
                         device=dev).to(dtype)
        sweeps[f"block_q {tag}"] = autotune.sweep_block_q(
            q, kp, vp, tables, start=start, candidates=cands,
            kernels=kernels)
    for m in (8, 16, 32):
        x = _levels(torch, gen, dev, (m, 2048))
        w = _ternary(torch, gen, dev, (2048, 2048))
        sweeps[f"DP4A_MAX_ROWS M {m} q/o"] = autotune.sweep_dp4a_rows(
            x, w, candidates=(4, 8, 16, 32), kernels=kernels, sms=sms)
    out["autotune"] = sweeps
    for tag, sw in sweeps.items():
        log(f"autotune {tag} ({smi}): winner {sw['winner']}; ms "
            + ", ".join(f"{k} {v:.4f}" for k, v in sw["ms"].items())
            + (f"; pruned {sorted(sw['pruned'])}" if sw["pruned"] else ""))
    return out


# ---------------------------------------------------------------------------
# phase 13: the vision and audio front ends, the circuit models, examples
# ---------------------------------------------------------------------------

HUBERT_ARCH = "hubert-xlarge"
LLAVA_ARCH = "llava-next-34b"
HUBERT_UTTERANCES, HUBERT_FRAMES = 2, 1500   # 30 s each at 50 frames/s
LLAVA_REQUESTS, LLAVA_TEXT = 2, 16           # text tokens after the image
LLAVA_NEW_TOKENS = 8                         # greedy decode steps
FRONTEND_F32_LAYERS = 2
F32_LOGIT_RTOL = 1e-5    # float32 card against CPU, of the largest logit
FAULT_BERS = (1e-3, 1e-2, 1e-1)
FSM_STREAM = 1024        # bits a stochastic stream (Fig 1's length)
HW_RTOL = 1e-12
# Table V: the 3x3x512 conv (4608 2-bit products) through the baseline,
# the spatial approximate BSN and the spatial-temporal one (512 wide, 9
# cycles); the specs of the repository's Table V benchmark
TABLE_V_WIDTH = 4608
TABLE_V_SPATIAL = ((64, 48, 1), (72, 1024, 8))
TABLE_V_TEMPORAL = (512, ((64, 48, 1), (8, 72, 8)), 9)


def _frames(torch, dev, utterances, frames, step=0):
    """The launcher's audio-stub batch (``launch/train.train_batch``):
    0.1 N(0, 1) frame features from ``fold_in(key(8), step)``."""
    from repro_torch import prng
    return 0.1 * prng.normal(prng.fold_in(prng.key(8), step).to(dev),
                             (utterances, frames, 512))


def _profiled(torch, fn, label):
    """``fn()`` once under torch.profiler: its wall ms (synchronised),
    device busy ms, the device's idle share and the flash forwards' ms
    and {kernel: launches}."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    busy_ms = sum(_dev_us(e) for e in events if e.device_type == cuda) / 1e3
    (OUT_DIR / f"profile_{label}.txt").write_text(events.table(
        sort_by="self_cuda_time_total", row_limit=30))
    flash_ms, flash_calls = flash_profile(torch, events)
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, flash_kernel_ms=flash_ms,
                flash_kernel_calls=flash_calls)


def hubert_encoder(torch, dev, layers):
    """hubert-xlarge at full width, ``layers`` of its 48, bf16, sc_qat:
    ``forward`` over 2 utterances of 1500 frames, one flash launch a
    layer.  Gates: finite logits (2, 1500, 512), and frame 0's logits
    move when the last frame does (bidirectional attention).  The last
    gate runs the same weights with quantization off: at this init every
    0.1 N(0, 1) frame feature rounds to activation level 0 (``alpha_a``
    1.0 at act_bsl 8), so under sc_qat every frame's logits are the same
    and no frame can move another's."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import forward, init_params
    cfg = get_arch(HUBERT_ARCH)
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    frames = _frames(torch, dev, HUBERT_UTTERANCES, HUBERT_FRAMES)

    def run(fr):
        return forward(params, {"frames": fr}, cfg)[0]
    with torch.inference_mode():
        run(frames)                                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        t0 = time.perf_counter()
        logits = run(frames)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(kbuild.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = _profiled(torch, lambda: run(frames), "hubert_forward")
        moved = frames.clone()
        moved[:, -1] += 1.0
        qat_dist = (run(moved)[:, 0] - logits[:, 0]).float().abs().max() \
            .item()
        off = cfg.scaled(quant=cfg.quant.with_mode("none"))
        dist = (forward(params, {"frames": moved}, off)[0][:, 0]
                - forward(params, {"frames": frames}, off)[0][:, 0]) \
            .float().abs().max().item()
    shape = (HUBERT_UTTERANCES, HUBERT_FRAMES, cfg.padded_vocab)
    finite = bool(torch.isfinite(logits.float()).all())
    if tuple(logits.shape) != shape or not finite:
        raise AssertionError(f"hubert logits {tuple(logits.shape)} (want "
                             f"{shape}), finite {finite}")
    if not dist > 0:
        raise AssertionError("hubert: frame 0's logits ignore the last "
                             "frame (not bidirectional)")
    if launches["flash_attention"] != layers:
        raise AssertionError(f"hubert: {launches['flash_attention']} flash "
                             f"launches, {layers} expected")
    check_flash_profile(prof["flash_kernel_calls"], layers,
                        "hubert's profiled forward")
    res = dict(layers=layers, ms=ms, peak_gib=peak, launches=launches,
               frame0_moved_by=dist, frame0_moved_by_sc_qat=qat_dist, **prof)
    log(f"hubert-xlarge {layers}/48 layers, {HUBERT_UTTERANCES} x "
        f"{HUBERT_FRAMES} frames, bf16 sc_qat: forward ms={ms:.1f} "
        f"busy_ms={prof['device_busy_ms']:.1f} idle_share="
        f"{prof['idle_share']:.3f} peak_gib={peak:.2f} flash launches "
        f"{launches['flash_attention']} ({prof['flash_kernel_ms']:.2f} ms "
        f"of {MMA_KERNEL}); logits {shape} finite; frame 0 "
        f"moves by {dist:.3g} when the last frame changes (quantization "
        f"off; {qat_dist:.3g} under sc_qat)")
    return res


def hubert_f32_card_equals_cpu(torch, dev):
    """hubert-xlarge at full width, FRONTEND_F32_LAYERS layers, float32,
    quantization off, one utterance: ``forward``'s logits on the card
    (the float32 flash kernel at D 80) equal the CPU's within
    F32_LOGIT_RTOL of the largest."""
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_params
    cfg = get_arch(HUBERT_ARCH)
    cfg = cfg.scaled(n_layers=FRONTEND_F32_LAYERS, dtype="float32",
                     quant=cfg.quant.with_mode("none"))
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    frames = _frames(torch, "cpu", 1, HUBERT_FRAMES)
    with torch.inference_mode():
        want = forward(cpu, {"frames": frames}, cfg)[0]
        got = forward(_to(cpu, dev), {"frames": frames.to(dev)},
                      cfg)[0].cpu()
    err = ((got - want).abs().max() / want.abs().max()).item()
    log(f"hubert-xlarge {FRONTEND_F32_LAYERS} layers float32, 1 x "
        f"{HUBERT_FRAMES} frames: card logits == cpu within {err:.3g} of "
        f"the largest (tol {F32_LOGIT_RTOL})")
    if not err <= F32_LOGIT_RTOL:
        raise AssertionError(f"hubert float32 card vs cpu: {err}")
    return err


def llava_serving(torch, dev, layers):
    """llava-next-34b at full width, ``layers`` of its 60, bf16, sc_qat:
    the dense ``prefill`` of LLAVA_REQUESTS requests, each IMG_TOKENS
    patch embeddings and LLAVA_TEXT text tokens, then LLAVA_NEW_TOKENS
    greedy ``decode_step``s on the dense cache.  Gate: each request's
    tokens in the batch equal its tokens alone."""
    from repro_torch import prng
    from repro_torch.configs import get_arch
    from repro_torch.configs.llava_next_34b import IMG_TOKENS
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving.engine import _pad_prefill_cache
    from repro_torch.serving.sampling import greedy_tokens
    cfg = get_arch(LLAVA_ARCH)
    if layers != cfg.n_layers:
        cfg = cfg.scaled(n_layers=layers)
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    patches = 0.02 * prng.normal(prng.fold_in(prng.key(7), 0).to(dev),
                                 (LLAVA_REQUESTS, IMG_TOKENS, 1024))
    text = prng.randint(prng.key(SEED).to(dev), (LLAVA_REQUESTS, LLAVA_TEXT),
                        0, cfg.vocab_size)
    S = IMG_TOKENS + LLAVA_TEXT

    def generate(rows):
        batch = {"patch_embeds": patches[rows], "tokens": text[rows]}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch, cfg)
        tok = greedy_tokens(logits[:, -1], cfg.vocab_size)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cache = _pad_prefill_cache(cache, S + LLAVA_NEW_TOKENS)
        toks, margins = [tok], []
        for _ in range(LLAVA_NEW_TOKENS):
            logits, cache = decode_step(params, cache, tok[:, None], cfg)
            top2 = logits[:, 0, :cfg.vocab_size].float().topk(2).values
            margins.append((top2[:, 0] - top2[:, 1]).min())
            tok = greedy_tokens(logits[:, 0], cfg.vocab_size)
            toks.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (torch.stack(toks, 1).tolist(), (t1 - t0) * 1e3,
                (t2 - t1) * 1e3 / LLAVA_NEW_TOKENS,
                float(torch.stack(margins).min()))

    rows = list(range(LLAVA_REQUESTS))
    with torch.inference_mode():
        generate(rows[:1])                           # warm-up
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        batched, prefill_ms, decode_ms, margin = generate(rows)
        launches = dict(kbuild.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        alone = [generate([r])[0][0] for r in rows]
    if batched != alone:
        raise AssertionError(f"llava: batched tokens {batched} != alone "
                             f"{alone}")
    if launches["flash_attention"] != layers:
        raise AssertionError(f"llava: {launches['flash_attention']} flash "
                             f"launches in the prefill, {layers} expected")
    res = dict(layers=layers, requests=LLAVA_REQUESTS, positions=S,
               prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
               peak_gib=peak, launches=launches, tokens=batched,
               least_decode_margin=margin)
    log(f"llava-next-34b {layers}/60 layers, {LLAVA_REQUESTS} requests of "
        f"{IMG_TOKENS} patches + {LLAVA_TEXT} tokens, bf16 sc_qat: prefill "
        f"ms={prefill_ms:.1f} decode ms/step={decode_ms:.1f} peak_gib="
        f"{peak:.2f} flash launches {launches['flash_attention']}; batched "
        f"tokens == alone {batched} (least top-2 margin {margin:.3g})")
    return res


def circuit_models(torch, dev):
    """Table V's figures from ``core/hwmodel.py`` with their MSE through
    the approximate-BSN kernels; ``core/fault.py`` at FAULT_BERS and
    ``core/fsm_baseline.py`` on FSM_STREAM-bit streams, card == CPU bit
    for bit under one key."""
    from repro_torch import prng
    from repro_torch.core import fault, fsm_baseline, hwmodel
    from repro_torch.core.bsn import ApproxBSNSpec, StageSpec, SubSampleSpec
    from repro_torch.examples.design_space import measure_mse

    def spec(width, stages):
        return ApproxBSNSpec(width, 2, tuple(
            StageSpec(g, SubSampleSpec(c, s)) for g, c, s in stages))
    base = hwmodel.bsn_cost(TABLE_V_WIDTH * 2)
    if abs(base.area_um2 / 2.95e5 - 1) > HW_RTOL \
            or abs(base.delay_ns / 4.33 - 1) > HW_RTOL:
        raise AssertionError(f"hwmodel: Table V baseline {base}")
    spatial = spec(TABLE_V_WIDTH, TABLE_V_SPATIAL)
    sp = hwmodel.approx_bsn_cost(spatial)
    w, stages, cycles = TABLE_V_TEMPORAL
    temporal = spec(w, stages)
    st = hwmodel.spatial_temporal_cost(temporal, cycles)
    st_adp = st.area_um2 * cycles * st.delay_ns
    table = dict(baseline=dict(area_um2=base.area_um2,
                               delay_ns=base.delay_ns, adp=base.adp),
                 spatial=dict(area_um2=sp.area_um2, delay_ns=sp.delay_ns,
                              adp_reduction=base.adp / sp.adp,
                              mse=measure_mse(spatial, 1, device=dev)),
                 spatial_temporal=dict(
                     area_um2=st.area_um2, delay_ns=st.delay_ns,
                     adp_reduction=base.adp / st_adp,
                     mse=measure_mse(temporal, cycles, device=dev)),
                 tops_per_watt_065v=hwmodel.tops_per_watt(2, 0.65))
    log(f"hwmodel Table V: baseline area {base.area_um2:.4g} um2 delay "
        f"{base.delay_ns:.3f} ns adp {base.adp:.4g}; spatial adp "
        f"reduction {table['spatial']['adp_reduction']:.2f}x mse "
        f"{table['spatial']['mse']:.3g} (paper 2.8x, 3.79e-7); spatial-"
        f"temporal {table['spatial_temporal']['adp_reduction']:.2f}x mse "
        f"{table['spatial_temporal']['mse']:.3g} (paper 4.1x); "
        f"{table['tops_per_watt_065v']:.1f} TOPS/W at 0.65 V (paper 198.9)")

    gen = torch.Generator().manual_seed(SEED)
    x_q = torch.randint(-4, 5, (4096, 256), generator=gen, dtype=torch.int32)
    flips = {}
    for ber in FAULT_BERS:
        k = prng.fold_in(prng.key(SEED), int(ber * 1e6))
        got = [(fault.thermometer_under_ber(x.to(d), 8, ber, k).cpu(),
                fault.binary_under_ber(x.to(d), 4, ber, k).cpu())
               for x, d in ((x_q, dev), (x_q, "cpu"))]
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            raise AssertionError(f"fault at ber {ber}: card != cpu")
        therm, binary = got[1]
        flips[ber] = dict(
            thermometer_mse=float(((therm - x_q).float() ** 2).mean()),
            binary_mse=float(((binary - x_q).float() ** 2).mean()))
    log("fault (card == cpu bit for bit): " + "; ".join(
        f"ber {b}: thermometer mse {v['thermometer_mse']:.4g}, binary "
        f"{v['binary_mse']:.4g}" for b, v in flips.items()))

    x = torch.linspace(-0.9, 0.9, 64)
    fsm = {}
    streams = [fsm_baseline.stochastic_bitstream(x.to(d), FSM_STREAM,
                                                 prng.key(SEED)).cpu()
               for d in (dev, "cpu")]
    if not torch.equal(*streams):
        raise AssertionError("fsm: card stream != cpu stream")
    for name, fn in (("stanh", fsm_baseline.fsm_stanh),
                     ("relu", fsm_baseline.fsm_relu)):
        t0 = time.perf_counter()
        card = fn(streams[0].to(dev), 8).cpu()
        card_ms = (time.perf_counter() - t0) * 1e3
        cpu = fn(streams[1], 8)
        if not torch.equal(card, cpu):
            raise AssertionError(f"fsm_{name}: card != cpu")
        fsm[name] = dict(card_ms=card_ms)
    log(f"fsm_stanh / fsm_relu on 64 streams of {FSM_STREAM} bits: card == "
        f"cpu bit for bit ({fsm['stanh']['card_ms']:.0f} / "
        f"{fsm['relu']['card_ms']:.0f} ms on the card, a loop over the "
        "stream)")
    return dict(table_v=table, fault=flips, fsm=fsm)


def run_examples(torch):
    """``python -m repro_torch.examples.quickstart`` and ``design_space
    --width 4608`` on the card, both at once: each must exit 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, argv in (("quickstart", []),
                       ("design_space", ["--width", "4608"])):
        procs[name] = (argv, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.examples.{name}", *argv],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = {}
    try:
        for name, (argv, t0, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            s = time.perf_counter() - t0
            (OUT_DIR / f"example_{name}.txt").write_text(stdout + stderr)
            if proc.returncode:
                raise AssertionError(f"example {name} exited "
                                     f"{proc.returncode}: {stderr[-2000:]}")
            tail = stdout.strip().splitlines()[-2:]
            out[name] = dict(seconds=s, tail=tail)
            log(f"example {name} {' '.join(argv)}: exit 0 in {s:.1f} s; "
                + " | ".join(tail))
    finally:
        for _, _, proc in procs.values():
            proc.kill()
            proc.wait()
    return out


def frontends_and_circuits(torch, dev, hubert_layers, llava_layers, smi):
    """Phase 13: hubert's encoder and llava's dense serving at full width,
    hubert's float32 card == CPU check, the circuit models, the examples.
    Returns (results, the main path's launches: hubert's forward and
    llava's batched prefill and decode)."""
    out = {"nvidia_smi": smi}
    out["hubert"] = hubert_encoder(torch, dev, hubert_layers)
    out["llava"] = llava_serving(torch, dev, llava_layers)
    launches = {k: out["hubert"]["launches"][k] + out["llava"]["launches"][k]
                for k in out["hubert"]["launches"]}
    out["hubert_float32_card_vs_cpu"] = hubert_f32_card_equals_cpu(torch,
                                                                    dev)
    out["circuit_models"] = circuit_models(torch, dev)
    out["examples"] = run_examples(torch)
    return out, launches


# ---------------------------------------------------------------------------
# phase 14: the training mesh, 2 ranks of a (1, 2) and a (2, 1) mesh
# ---------------------------------------------------------------------------

TRAIN_MESHES = ((1, 2), (2, 1))
MESH_TRAIN_STEPS = 2
# a sharded step against the unsharded one, set from phase 14's readings
# (PERF.md, PR 24): losses within 5.7e-4 of phase 6's, quantization off
# within 2.8e-4 (bf16 products whose partial sums add in another order);
# 3e-3 sits 5x above them, and the fault the phase plants (one rank's
# half of the batch taken as the whole, read unsharded) must read above
# it.  Under sc_qat the grad norm is read, not held: its LSQ scales'
# gradients are sums that cancel (ROADMAP Queue 3 item 7; the CPU tests
# hold them leaf by leaf in float64), so it is read in bf16 and float32,
# and by kind of leaf
MESH_TRAIN_RTOL = 3e-3


def _grad_norms_by_kind(state, grad_norm):
    """Step 1's gradient norm over each kind of leaf (its path without the
    layer index), from AdamW's first moment after one step from zero:
    ``m = 0.1 g`` clipped to norm 1.  Under a mesh every rank takes part
    and each leaf's blocks count once."""
    import re

    from repro_torch.distributed.sharding import fsdp_active, spec_of
    from repro_torch.optim import global_norm
    from repro_torch.tree import tree_paths
    kinds: dict[str, list] = {}
    for path, leaf in tree_paths(state.opt["m"]):
        kinds.setdefault(re.sub(r"^layers/\d+/", "", path), []).append(leaf)
    mesh = fsdp_active()
    return {k: 10 * max(grad_norm, 1.0) * float(global_norm(
        v, [spec_of(t) for t in v] if mesh else None))
        for k, v in sorted(kinds.items())}


def _norm_shift(got, want):
    """The three kinds of leaf that move the squared grad norm most
    between two steps (:func:`_grad_norms_by_kind`), each with its share
    of the whole squared norm's change and its own relative gap."""
    d = {k: got[k] ** 2 - want[k] ** 2 for k in want}
    total = sum(abs(v) for v in d.values()) or 1.0
    top = sorted(d, key=lambda k: -abs(d[k]))[:3]
    return {k: dict(share=abs(d[k]) / total,
                    gap=abs(got[k] - want[k]) / max(want[k], 1e-30))
            for k in top}


def _timed_collectives(torch):
    """Wrap the mesh's collectives (gather, all-reduce, reduce-scatter) with
    host timers around a synchronize; returns (restore, the ms list)."""
    from repro_torch.distributed import sharding
    spent, saved = [], {}

    def wrap(inner):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            spent.append((time.perf_counter() - t0) * 1e3)
            return out
        return timed
    for name in ("_all_gather", "_all_reduce", "_reduce_scatter"):
        saved[name] = getattr(sharding, name)
        setattr(sharding, name, wrap(saved[name]))

    def restore():
        for name, fn in saved.items():
            setattr(sharding, name, fn)
    return restore, spent


def _tiny_mesh_case(torch):
    """Phase 6's tiny granite, float32, quantization off: its config, the
    CPU's initial params and batch."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    qat = _tiny_cfg("granite-3-2b")
    cfg = qat.scaled(quant=qat.quant.with_mode("none"))
    params = init_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=100,
                        seed=SEED).batch(0, 4)
    return cfg, params, batch


def _tiny_step(torch, cfg, params, batch, rules=None):
    """One step of the tiny case (``tiny_train_card_equals_cpu``'s
    schedule) under ``rules``: metrics and the whole params / m / v, on
    the host."""
    from repro_torch.distributed.sharding import (mesh_rules, shard_tree,
                                                  unshard_tree)
    from repro_torch.models import param_specs
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_paths
    with mesh_rules(rules):
        if rules is not None:
            params = shard_tree(params, param_specs(cfg, serving=False),
                                rules)
        step = build_train_step(cfg, lambda s: warmup_cosine(
            s + 1, 1e-3, 2, 10))
        state, m = step(init_train_state(params, cfg), batch)
        whole = unshard_tree(state)
    return {"metrics": {k: float(v) for k, v in m.items()},
            **{name: {k: v.cpu() for k, v in tree_paths(tree)}
               for name, tree in (("params", whole.params),
                                  ("m", whole.opt["m"]),
                                  ("v", whole.opt["v"]))}}


def _first_step(torch, dev, cfg, rules=None, float32=False,
                rows=TRAIN_BATCH, nudge=False):
    """Step 1 (lr 0) of ``cfg`` at full width from phase 6's seed (mamba's
    taps live) on the first ``rows`` of phase 6's first batch, in the
    config's dtype or (``float32``) on its bf16 weights upcast, with
    ``nudge`` layer 0's ``wo`` scaled by 1 + 2^-7 (each entry about one
    bf16 ulp up), under the active ``rules`` or unsharded: its loss, grad
    norm and grad norm by kind of leaf (:func:`_grad_norms_by_kind`)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import shard_tree
    from repro_torch.models import init_params, param_specs
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_map
    params = live_ssm(init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                  dev))
    if nudge:
        params["layers"][0]["mixer"]["wo"]["w"].mul_(1 + 2 ** -7)
    if float32:
        cfg = cfg.scaled(dtype="float32")
        params = tree_map(lambda t: t.float() if t.dtype == torch.bfloat16
                          else t, params)
    if rules is not None:
        params = shard_tree(params, param_specs(cfg, serving=False), rules)
    step_fn = build_train_step(cfg, lambda s: warmup_cosine(
        s, TRAIN_LR, 1, TRAIN_STEPS))
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        seed=SEED).batch(0, TRAIN_BATCH)
    batch = {k: v[:rows] for k, v in batch.items()}
    state, m = step_fn(init_train_state(params, cfg), batch)
    out = {k: float(m[k]) for k in ("loss", "grad_norm")}
    out["by_kind"] = _grad_norms_by_kind(state, out["grad_norm"])
    del params, state
    torch.cuda.empty_cache()
    return out


def _mesh_train(torch, dev, cfg, rules, arch="granite-3-2b"):
    """``MESH_TRAIN_STEPS`` steps of ``cfg`` at full width under ``rules``
    from phase 6's seed (mamba's taps live), schedule and batches of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``: the launch counts set to 0 just
    before the steps, the collectives timed at the last step, the peak
    memory of the steps, the share of each watched leaf's entries that
    step 2 changed (:func:`_changed_share`) and, for a leaf it left, the
    largest update over half an ulp (:func:`_update_over_half_ulp`), step
    1's grad norm by kind of leaf."""
    from repro_torch.data import SyntheticLM
    from repro_torch.distributed.sharding import (mesh_rules, shard_tree,
                                                  unshard_tree)
    from repro_torch.kernels import build as kbuild
    from repro_torch.models import init_params, param_specs
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    params = live_ssm(init_params(cfg, torch.Generator(dev).manual_seed(SEED),
                                  dev))
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, seed=SEED)
    with mesh_rules(rules):
        if rules is not None:
            params = shard_tree(params, param_specs(cfg, serving=False),
                                rules)
            torch.cuda.empty_cache()
        state = init_train_state(params, cfg)
        step_fn = build_train_step(cfg, lambda s: warmup_cosine(
            s, TRAIN_LR, 1, TRAIN_STEPS))
        before = {k: v.clone()
                  for k, v in _watch(state.params, arch).items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kbuild.reset_launches()
        steps, collective_ms = [], None
        for i in range(MESH_TRAIN_STEPS):
            batch = ds.batch(i, TRAIN_BATCH)
            last = i == MESH_TRAIN_STEPS - 1
            restore, spent = _timed_collectives(torch) if last \
                else (lambda: None, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                state, m = step_fn(state, batch)
                torch.cuda.synchronize()
            finally:
                restore()
            steps.append(dict({k: float(v) for k, v in m.items()},
                              sec=time.perf_counter() - t0))
            if i == 0:
                by_kind = _grad_norms_by_kind(state, steps[-1]["grad_norm"])
            if last:
                collective_ms = dict(ms=sum(spent), calls=len(spent))
        launches = dict(kbuild.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        changed = _changed_share(torch, before, _watch(state.params, arch),
                                 rules)
        # a leaf step 2 left: its update against half an ulp, whole
        stuck = {k: None for k, c in changed.items() if c == 0}
        rounded = _update_over_half_ulp(torch, *(
            unshard_tree({k: v for k, v in _watch(t, arch).items()
                          if k in stuck})
            for t in (state.params, state.opt["m"], state.opt["v"])),
            float(state.opt["count"]), steps[-1]["lr"]) if stuck else {}
    del state, params, before
    torch.cuda.empty_cache()
    return dict(steps=steps, launches=launches, peak_bytes=peak,
                collectives_last_step=collective_ms, changed=changed,
                update_over_half_ulp=rounded,
                step1_grad_norm_by_kind=by_kind)


def _changed_share(torch, before, after, rules):
    """The share of each watched leaf's entries that differ between
    ``before`` and ``after`` (this rank's blocks): the counts summed over
    every rank of the mesh, a leaf held whole on several ranks counted
    once on each in both terms."""
    from repro_torch.distributed.sharding import psum
    counts = torch.stack([torch.stack([(after[k] != v).sum().double(),
                                       torch.tensor(float(v.numel()),
                                                    device=v.device,
                                                    dtype=torch.float64)])
                          for k, v in before.items()])
    if rules is not None:
        counts = psum(counts, rules.mesh.axis_names)
    return {k: (c[0] / c[1]).item() for k, c in zip(before, counts)}


def train_mesh_rank_work(torch, layers, dev):
    """One rank of phase 14 (both ranks run it): full-width granite-3-2b at
    ``layers`` trained on each mesh of ``TRAIN_MESHES``
    (:func:`_mesh_train`), then one step with quantization off under the
    same rules; then the tiny float32 step on the card under each mesh."""
    from repro_torch.distributed.sharding import mesh_rules
    from repro_torch.launch.mesh import _grid, training_rules
    out = {}
    for shape in TRAIN_MESHES:
        name = "x".join(map(str, shape))
        rules = training_rules(_grid(shape, ("data", "model"), "gloo"))
        out[name] = _mesh_train(torch, dev, _granite_cfg(layers), rules)
        with mesh_rules(rules):
            out[name]["quant_off"] = _first_step(
                torch, dev, _granite_cfg(layers, "none"), rules)
            out[name]["sc_qat_float32"] = _first_step(
                torch, dev, _granite_cfg(layers, "sc_qat"), rules, True) \
                if shape[1] > 1 else None
        torch.cuda.empty_cache()
    cfg, cpu, batch = _tiny_mesh_case(torch)
    out["tiny"] = {}
    for shape in TRAIN_MESHES:
        rules = training_rules(_grid(shape, ("data", "model"), "gloo"))
        res = _tiny_step(torch, cfg, _to(cpu, dev), batch, rules)
        # numpy through the queue: a tensor would need this process alive
        out["tiny"]["x".join(map(str, shape))] = {
            k: v if k == "metrics" else {n: t.numpy() for n, t in v.items()}
            for k, v in res.items()}
    return out


def train_mesh_rank(rank, port, work, arg, queue):
    """The entry point of a spawned rank of phases 14 and 15: the gloo
    group over localhost, the kernels the parent built (loaded, not
    rebuilt), then ``work`` (the name of this module's function: its
    ``(torch, arg, device)``)."""
    import datetime
    import os
    import traceback

    # two ranks share the card: segments that grow leave less of it
    # reserved and unused between them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}",
            world_size=MESH_RANKS, rank=rank,
            timeout=datetime.timedelta(seconds=600))
        from repro_torch.kernels import build as kbuild
        kbuild.library()
        out = globals()[work](torch, arg, torch.device("cuda"))
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def _predicted_peaks(cases):
    """The dry-run's peak a rank for each of ``cases`` ({label: (arch,
    layers, the period's layers kept or None, config overrides, mesh
    shape)}, trained on ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens), traced on
    the host (meta tensors, a fake process group) in a process of its own
    while the ranks train: returns the reader of its result."""
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "from repro_torch.launch.dryrun import predict_train_peak; "
            "print(json.dumps({k: predict_train_peak(a, n, "
            f"{TRAIN_BATCH}, {TRAIN_SEQ}, m, keep, over) for k, (a, n, keep, "
            f"over, m) in {cases!r}.items()}}))")
    proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT / "src")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def read():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            proc.kill()
        if proc.returncode:
            raise AssertionError(f"the dry-run's prediction failed:\n"
                                 f"{stderr[-3000:]}")
        return json.loads(stdout.strip().splitlines()[-1])
    return read


def _tiny_errors(torch, got, want):
    """A tiny step against the CPU's at ``TINY_TRAIN_TOL``'s measures,
    with phase 6's small-gradient rule: where the first-step gradient is
    below 1e-6 the step ``lr g / (|g| + eps)`` is its rounding's, and
    those parameter entries are held within 2 lr."""
    errs = {k: abs(got["metrics"][k] - want["metrics"][k])
            / abs(want["metrics"][k]) for k in ("loss", "grad_norm")}
    slack = 2 * want["metrics"]["lr"]
    errs["params"] = max(
        ((a - b).abs() - torch.where(m.abs() < (1 - 0.9) * 1e-6, slack,
                                     0.0)).max().item()
        for a, b, m in zip(got["params"].values(), want["params"].values(),
                           want["m"].values()))
    for k in ("m", "v"):
        errs[k] = max(((a - b).abs().max()
                       / b.abs().max().clamp(min=1e-30)).item()
                      for a, b in zip(got[k].values(), want[k].values()))
    return errs


def _held_gaps(per, label_values, what):
    """Each (label, value of a rank's result, the unsharded value): the
    ranks' values must be one finite number; returns its relative gaps."""
    gaps = {}
    for label, got_of, want in label_values:
        got = [got_of(p) for p in per]
        if len(set(got)) != 1 or not math.isfinite(got[0]):
            raise AssertionError(f"{what} {label}: the ranks' values {got}")
        gaps[label] = abs(got[0] - want) / abs(want)
    return gaps


def training_mesh(torch, dev, layers, training, smi):
    """Phase 14 (see the module docstring): the ranks' runs against phase
    6's unsharded steps (``training``), the tiny card steps against the
    CPU's unsharded step, the peaks beside the dry-run's.  Returns
    (results, the main path's launches, both ranks')."""
    torch.cuda.empty_cache()
    predicted = _predicted_peaks({
        "x".join(map(str, m)): ("granite-3-2b", layers, None, {}, m)
        for m in TRAIN_MESHES})
    off_ref = _first_step(torch, dev, _granite_cfg(layers, "none"))
    # the planted fault: a rank that trains on its half of the batch
    half = _first_step(torch, dev, _granite_cfg(layers, "none"),
                       rows=TRAIN_BATCH // 2)
    fault = {k: abs(half[k] - off_ref[k]) / abs(off_ref[k])
             for k in ("loss", "grad_norm")}
    if not fault["grad_norm"] > MESH_TRAIN_RTOL:
        raise AssertionError(f"phase 14: half the batch reads {fault}, "
                             f"inside the tolerance {MESH_TRAIN_RTOL}")
    qat32_ref = _first_step(torch, dev, _granite_cfg(layers, "sc_qat"),
                            float32=True)
    nudged = _first_step(torch, dev, _granite_cfg(layers, "sc_qat"),
                         nudge=True)
    t0 = time.perf_counter()
    ranks = _spawn(train_mesh_rank, ("train_mesh_rank_work", layers),
                   "phase 14")
    wall_s = time.perf_counter() - t0
    tcfg, tcpu, tbatch = _tiny_mesh_case(torch)
    want_tiny = _tiny_step(torch, tcfg, tcpu, tbatch)
    peaks = predicted()
    ref = training["steps"]
    out = {"nvidia_smi": smi, "label": MESH_LABEL, "ranks_wall_s": wall_s,
           "tolerance": MESH_TRAIN_RTOL, "meshes": {},
           "half_batch_fault": dict(fault, values=half, whole=off_ref),
           "sc_qat_float32_unsharded": qat32_ref,
           "sc_qat_nudged_unsharded": nudged,
           "sc_qat_nudged_gap": abs(nudged["grad_norm"]
                                    - training["steps"][0]["grad_norm"])
           / training["steps"][0]["grad_norm"],
           "sc_qat_bf16_vs_float32_unsharded": abs(
               ref[0]["grad_norm"] - qat32_ref["grad_norm"])
           / qat32_ref["grad_norm"],
           "tiny_card_vs_cpu": {}}
    out["sc_qat_precision_shift"] = _norm_shift(
        qat32_ref["by_kind"], training["step1_grad_norm_by_kind"])
    out["sc_qat_nudge_shift"] = _norm_shift(
        nudged["by_kind"], training["step1_grad_norm_by_kind"])
    log(f"train mesh: the planted fault (half the batch, unsharded) reads "
        f"loss {fault['loss']:.3g}, grad norm {fault['grad_norm']:.3g} off "
        f"the whole batch's (tol {MESH_TRAIN_RTOL}); sc_qat step 1 "
        f"unsharded grad norm bf16 {ref[0]['grad_norm']:.1f}, float32 "
        f"{qat32_ref['grad_norm']:.1f} (relative gap "
        f"{out['sc_qat_bf16_vs_float32_unsharded']:.3g}; moved most by "
        + ", ".join(f"{k} {v['share']:.2f} {v['gap']:.3g}" for k, v in
                    out["sc_qat_precision_shift"].items())
        + f"); layer 0's wo an ulp up: grad norm {nudged['grad_norm']:.1f} "
        f"(relative gap {out['sc_qat_nudged_gap']:.3g}; moved most by "
        + ", ".join(f"{k} {v['share']:.2f} {v['gap']:.3g}" for k, v in
                    out["sc_qat_nudge_shift"].items())
        + f") [{smi}]")
    launches = {}
    for shape in TRAIN_MESHES:
        name = "x".join(map(str, shape))
        per = [r[name] for r in ranks]
        gaps = _held_gaps(per, [
            (f"sc_qat step {i + 1} {k}",
             lambda p, i=i, k=k: p["steps"][i][k], ref[i][k])
            for i in range(MESH_TRAIN_STEPS) for k in ("loss", "grad_norm")]
            + [(f"quant-off {k}", lambda p, k=k: p["quant_off"][k],
                off_ref[k]) for k in ("loss", "grad_norm")]
            + ([("sc_qat float32 grad_norm",
                 lambda p: p["sc_qat_float32"]["grad_norm"],
                 qat32_ref["grad_norm"])] if shape[1] > 1 else []),
            f"phase 14 {name}")
        held = {k: v for k, v in gaps.items() if "grad_norm" not in k
                or k.startswith("quant-off")}
        if not max(held.values()) <= MESH_TRAIN_RTOL:
            raise AssertionError(
                f"phase 14 {name}: off the unsharded steps by {held} (tol "
                f"{MESH_TRAIN_RTOL}): {[p['steps'] for p in per]} against "
                f"{ref[:2]}")
        want = layers * 2 * MESH_TRAIN_STEPS      # forward + recompute
        for p in per:
            if not all(c > 0 for c in p["changed"].values()):
                raise AssertionError(f"phase 14 {name}: step 2 left a "
                                     f"watched leaf unchanged: "
                                     f"{p['changed']}")
            if p["launches"]["flash_attention"] != want:
                raise AssertionError(
                    f"phase 14 {name}: a rank launched the flash kernel "
                    f"{p['launches']['flash_attention']} times, expected "
                    f"{want}")
            for k, v in p["launches"].items():
                launches[k] = launches.get(k, 0) + v
        pred = peaks[name]["peak"]
        shift = {"sc_qat bf16": _norm_shift(
            per[0]["step1_grad_norm_by_kind"],
            training["step1_grad_norm_by_kind"])}
        if per[0]["sc_qat_float32"] is not None:
            shift["sc_qat float32"] = _norm_shift(
                per[0]["sc_qat_float32"]["by_kind"], qat32_ref["by_kind"])
        log(f"train mesh {name}: step 1's squared grad norm against the "
            f"unsharded step's, moved most by (share of the change, the "
            f"kind's own gap) " + "; ".join(
                f"{lab}: " + ", ".join(f"{k} {v['share']:.2f} "
                                       f"{v['gap']:.3g}"
                                       for k, v in sh.items())
                for lab, sh in shift.items()))
        out["meshes"][name] = dict(
            per_rank=per, gaps=gaps, quant_off_unsharded=off_ref,
            grad_norm_shift=shift,
            predicted_peak_bytes=pred, prediction_trace_s=peaks[name][
                "trace_s"],
            peak_over_predicted=[p["peak_bytes"] / pred for p in per])
        for r, p in enumerate(per):
            c = p["collectives_last_step"]
            log(f"train mesh {name} rank {r}: losses "
                f"{[round(s['loss'], 4) for s in p['steps']]} grad norms "
                f"{[round(s['grad_norm'], 1) for s in p['steps']]} (phase "
                f"6: {[round(s['loss'], 4) for s in ref[:2]]}, "
                f"{[round(s['grad_norm'], 1) for s in ref[:2]]}; quant-off "
                f"step loss {p['quant_off']['loss']} grad_norm "
                f"{p['quant_off']['grad_norm']} against {off_ref['loss']}, "
                f"{off_ref['grad_norm']}; relative gaps "
                + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
                + f"; held: {', '.join(held)}, tol {MESH_TRAIN_RTOL}); "
                f"s/step {[round(s['sec'], 2) for s in p['steps']]}, the "
                f"last step's collectives {c['ms']:.1f} ms over "
                f"{c['calls']} calls (a sync around each); peak "
                f"{p['peak_bytes'] / 2**30:.2f} GiB, the dry-run's "
                f"prediction {pred / 2**30:.2f} GiB (measured / predicted "
                f"{p['peak_bytes'] / pred:.3f}); flash launches "
                f"{p['launches']['flash_attention']} [{MESH_LABEL}; {smi}]")
    for shape in TRAIN_MESHES:
        name = "x".join(map(str, shape))
        for r, rk in enumerate(ranks):
            got = {k: v if k == "metrics" else {
                n: torch.from_numpy(a) for n, a in v.items()}
                for k, v in rk["tiny"][name].items()}
            errs = _tiny_errors(torch, got, want_tiny)
            bad = {k: e for k, e in errs.items()
                   if e > TINY_TRAIN_TOL["metric" if k in ("loss",
                                                           "grad_norm")
                                         else k]}
            if bad:
                raise AssertionError(f"phase 14 tiny {name} rank {r}: the "
                                     f"card's mesh step != the CPU's {bad}")
            out["tiny_card_vs_cpu"][f"{name} rank {r}"] = errs
            log(f"tiny train mesh {name} rank {r}: card == the CPU's "
                "unsharded step ("
                + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
                + f"; tolerances {TINY_TRAIN_TOL})")
    return out, launches


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
# phase 15: the recurrent archs on the training mesh; long_500k's decode
# ---------------------------------------------------------------------------

# jamba's layers 0 and 4: mamba + dense, then attention + dense (an MoE
# layer's 9.7 B expert parameters are past one card shared by two ranks)
JAMBA_MESH_KEEP = (0, 4)
# rwkv6 trains with the chunked wkv here: the token scan keeps (S, H, K, V)
# operands of 4.3 GB a row a layer, and 1 row at 2 layers peaked at 37.30
# GiB (PERF.md, PR 19): 2 rows are past the card, let alone two ranks.
# Chunks of 16: the chunked form keeps (C, C, H, K) operands a chunk, S C H
# K in all, and at its default 32 a (1, 2) rank of 2 rows ran out of the
# card shared with the other rank (PERF.md, PR 25)
RWKV_MESH = dict(rwkv_wkv_impl="chunked", rwkv_chunk=16)
# long_500k's decode: jamba's layer 4 alone at batch 1 over the shape's
# 524288 positions, the K / V time cut over "data" on a (2, 1) mesh (two
# blocks of 262144); 4 teacher-forced steps straddle the blocks' boundary
# the archs whose quantization-off step runs in float32 on the bf16 weights
# upcast: in bf16 rwkv6's grad norm is carried by the bonus u's gradient, a
# sum over every token that cancels, and the mesh's bf16 partial sums part
# it from the unsharded step's by 3.1e-3 / 5.6e-3 on (2, 1) / (1, 2)
# against 2.2e-6 / 2.4e-6 in float32 (PERF.md, PR 25); jamba's float32 step
# is past the card, and in bf16 it reads 3e-6 / 1.4e-4
FLOAT32_QUANT_OFF = (RWKV_ARCH,)
# phase 9's tiny configs the card's mesh steps hold against the CPU (the
# chunked wkv runs at full width above)
TINY_MESH = ("rwkv6-7b scan", "jamba-1.5-large-398b")
LONG_CONTEXT = 524288
LONG_POSITIONS = (262143, 262144, 262145, 262146)
LONG_MESH = (2, 1)
# float32 sums in another order (the blocks' log-sum-exp merge): logits of
# the largest, as the CPU test of the same decode
LONG_LOGIT_RTOL = 1e-5


def _mesh_arch_cfg(arch, rwkv_layers, mode="sc_qat"):
    """Phase 15's full-width training config: rwkv6 at ``rwkv_layers``
    with ``RWKV_MESH``, jamba's layers ``JAMBA_MESH_KEEP``; quantization
    ``mode``."""
    from repro_torch.configs import get_arch
    cfg = get_arch(arch)
    if arch == JAMBA_ARCH:
        cfg = cfg.scaled(n_layers=len(JAMBA_MESH_KEEP), period=tuple(
            cfg.period[i] for i in JAMBA_MESH_KEEP))
    else:
        cfg = cfg.scaled(n_layers=rwkv_layers, **RWKV_MESH)
    return cfg.scaled(quant=cfg.quant.with_mode(mode))


def _flash_heads(torch):
    """Record the (query heads, KV heads, head dim) of every flash launch
    through ``dispatch.flash_attention``; returns (restore, the list)."""
    from repro_torch.kernels import dispatch
    inner, seen = dispatch.flash_attention, []

    def spy(q, k, v, *a, **kw):
        seen.append((q.shape[2], k.shape[2], q.shape[3]))
        return inner(q, k, v, *a, **kw)
    dispatch.flash_attention = spy

    def restore():
        dispatch.flash_attention = inner
    return restore, seen


def _long_rules():
    """The dry-run's long_500k rules on ``LONG_MESH``: the training
    mapping with the batch of 1 on no axis ("seq", K / V time, over
    "data")."""
    from repro_torch.distributed.sharding import MeshRules, multipod_mapping
    from repro_torch.launch.mesh import _grid
    return MeshRules(mesh=_grid(LONG_MESH, ("data", "model"), "gloo"),
                     mapping=dict(multipod_mapping(), batch=()))


def long_decode(torch, dev, rules=None):
    """long_500k's decode on jamba's layer 4 alone (attention + dense, d
    8192, 64 / 8 heads of 128, vocab 65536; full width, seeded random
    weights) in float32 without quantization: a dense cache of batch 1
    and ``LONG_CONTEXT`` positions, seeded random K / V below the first
    of ``LONG_POSITIONS``, then a teacher-forced ``decode_step`` at each.
    Under ``rules`` (:func:`_long_rules`) a rank holds its block of the
    positions.  Returns each step's logits and ms, the K / V rows this
    rank wrote at the positions it holds, the positions whose K or V
    changed, and the peak memory.  float32: in bf16 the logits are bf16
    themselves, so a gate of 1e-5 could hold only bit for bit, and under
    sc_qat the attention's context (~1e-3 at random init) quantizes to 0
    and would hide the merge."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import (DATA, axis_index,
                                                  mesh_rules, shard_tree)
    from repro_torch.models import (cache_specs, decode_step, init_cache,
                                    init_params, param_specs)
    base = get_arch(JAMBA_ARCH)
    cfg = base.scaled(n_layers=1, period=(base.period[4],), dtype="float32",
                      quant=base.quant.with_mode("none"))
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    cache = init_cache(cfg, 1, LONG_CONTEXT, device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 15)
    p0 = LONG_POSITIONS[0]
    for key in ("k", "v"):
        t = cache["layers"][0][key]
        t[:, :p0] = torch.randn(t[:, :p0].shape, generator=gen, device=dev)
    cache["pos"].fill_(p0)
    tokens = torch.randint(0, cfg.vocab_size, (len(LONG_POSITIONS), 1, 1),
                           generator=gen, device=dev, dtype=torch.int32)
    out = dict(ms=[], logits=[], written={}, changed={})
    torch.cuda.reset_peak_memory_stats()
    with mesh_rules(rules), torch.no_grad():
        if rules is not None:
            params = shard_tree(params, param_specs(cfg), rules)
            cache = shard_tree(cache, cache_specs(cfg, seq_shard=True),
                               rules, logical=True)
            torch.cuda.empty_cache()
        T = cache["layers"][0]["k"].shape[1]
        t0 = axis_index(DATA) * T if rules is not None else 0
        before = {k: cache["layers"][0][k].clone() for k in ("k", "v")}
        for tok in tokens:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = decode_step(params, cache, tok, cfg)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t1) * 1e3)
            out["logits"].append(logits[0, 0].cpu().numpy())
        for key in ("k", "v"):
            now = cache["layers"][0][key]
            hit = (now != before[key]).flatten(2).any(-1).any(0)
            out["changed"][key] = [t0 + int(i) for i in
                                   hit.nonzero().flatten().tolist()]
            for pos in LONG_POSITIONS:
                if t0 <= pos < t0 + T:
                    out["written"][f"{key} {pos}"] = \
                        now[:, pos - t0].cpu().numpy()
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, cache, before
    torch.cuda.empty_cache()
    return out


def _tiny_recurrent_case(torch, label):
    """Phase 9's tiny float32 ``label`` (``TINY_RECURRENT``) without
    quantization: its config, the CPU's initial params (mamba's taps live)
    and a batch of 4 x 96 tokens."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    arch, kw = TINY_RECURRENT[label]
    qat = _tiny_cfg(arch, **kw)
    cfg = qat.scaled(quant=qat.quant.with_mode("none"))
    params = live_ssm(init_params(cfg, torch.Generator().manual_seed(SEED),
                                  "cpu"))
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=96,
                        seed=SEED).batch(0, 4)
    return cfg, params, batch


def recurrent_mesh_rank_work(torch, rwkv_layers, dev):
    """One rank of phase 15 (both ranks run it): rwkv6-7b and jamba's
    layers 0 and 4 trained on each mesh of ``TRAIN_MESHES``
    (:func:`_mesh_train`, the flash launches' local heads recorded) and
    one step each with quantization off; long_500k's decode on
    ``LONG_MESH``; the tiny float32 steps on the card under each mesh."""
    from repro_torch.distributed.sharding import mesh_rules
    from repro_torch.launch.mesh import _grid, training_rules
    out = {}
    for arch in (RWKV_ARCH, JAMBA_ARCH):
        for shape in TRAIN_MESHES:
            name = f"{arch} {'x'.join(map(str, shape))}"
            rules = training_rules(_grid(shape, ("data", "model"), "gloo"))
            restore, heads = _flash_heads(torch)
            try:
                out[name] = _mesh_train(torch, dev, _mesh_arch_cfg(
                    arch, rwkv_layers), rules, arch)
            finally:
                restore()
            out[name]["flash_heads"] = sorted(set(heads))
            with mesh_rules(rules):
                out[name]["quant_off"] = _first_step(
                    torch, dev, _mesh_arch_cfg(arch, rwkv_layers, "none"),
                    rules, arch in FLOAT32_QUANT_OFF)
    out["long"] = long_decode(torch, dev, _long_rules())
    out["tiny"] = {}
    for label in TINY_MESH:
        cfg, cpu, batch = _tiny_recurrent_case(torch, label)
        for shape in TRAIN_MESHES:
            rules = training_rules(_grid(shape, ("data", "model"), "gloo"))
            res = _tiny_step(torch, cfg, _to(cpu, dev), batch, rules)
            # numpy through the queue: a tensor would need this process alive
            out["tiny"][f"{label} {'x'.join(map(str, shape))}"] = {
                k: v if k == "metrics" else {n: t.numpy()
                                             for n, t in v.items()}
                for k, v in res.items()}
    return out


def recurrent_training_mesh(torch, dev, rwkv_layers, smi):
    """Phase 15 (see the module docstring): the unsharded steps and
    long_500k's mesh-off decode on the parent's card, then the ranks'
    runs held against them, the tiny card steps against the CPU's, the
    peaks beside the dry-run's.  Returns (results, the main path's
    launches, both ranks')."""
    torch.cuda.empty_cache()
    archs = (RWKV_ARCH, JAMBA_ARCH)
    predicted = _predicted_peaks({
        f"{a} {'x'.join(map(str, m))}":
        (a, _mesh_arch_cfg(a, rwkv_layers).n_layers,
         JAMBA_MESH_KEEP if a == JAMBA_ARCH else None,
         {} if a == JAMBA_ARCH else RWKV_MESH, m)
        for a in archs for m in TRAIN_MESHES})
    refs = {}
    for arch in archs:
        t0 = time.perf_counter()
        refs[arch] = _mesh_train(torch, dev, _mesh_arch_cfg(
            arch, rwkv_layers), None, arch)
        refs[arch]["quant_off"] = _first_step(
            torch, dev, _mesh_arch_cfg(arch, rwkv_layers, "none"),
            float32=arch in FLOAT32_QUANT_OFF)
        log(f"recurrent train mesh {arch}: unsharded steps "
            + ", ".join(f"loss {s['loss']:.4f} grad_norm "
                        f"{s['grad_norm']:.4g} {s['sec']:.2f} s"
                        for s in refs[arch]["steps"])
            + f"; quantization off loss {refs[arch]['quant_off']['loss']} "
            f"grad_norm {refs[arch]['quant_off']['grad_norm']}; peak "
            f"{refs[arch]['peak_bytes'] / 2**30:.2f} GiB; "
            f"{time.perf_counter() - t0:.1f} s [{smi}]")
    long_off = long_decode(torch, dev)
    t0 = time.perf_counter()
    ranks = _spawn(train_mesh_rank, ("recurrent_mesh_rank_work",
                                     rwkv_layers), "phase 15")
    wall_s = time.perf_counter() - t0
    want_tiny = {label: _tiny_step(torch, *_tiny_recurrent_case(torch,
                                                                label))
                 for label in TINY_MESH}
    peaks = predicted()
    out = {"nvidia_smi": smi, "label": MESH_LABEL, "ranks_wall_s": wall_s,
           "tolerance": MESH_TRAIN_RTOL, "unsharded": refs, "meshes": {},
           "long_500k": {}, "tiny_card_vs_cpu": {}}
    launches = {}
    for arch in archs:
        cfg = _mesh_arch_cfg(arch, rwkv_layers)
        n_attn = sum(spec.mixer == "attn" for spec in cfg.period)
        ref, off_ref = refs[arch]["steps"], refs[arch]["quant_off"]
        for shape in TRAIN_MESHES:
            mesh = "x".join(map(str, shape))
            name = f"{arch} {mesh}"
            per = [r[name] for r in ranks]
            gaps = _held_gaps(per, [
                (f"sc_qat step {i + 1} {k}",
                 lambda p, i=i, k=k: p["steps"][i][k], ref[i][k])
                for i in range(MESH_TRAIN_STEPS)
                for k in ("loss", "grad_norm")]
                + [(f"quant-off {k}", lambda p, k=k: p["quant_off"][k],
                    off_ref[k]) for k in ("loss", "grad_norm")],
                f"phase 15 {name}")
            held = {k: v for k, v in gaps.items() if "grad_norm" not in k
                    or k.startswith("quant-off")}
            shift = _norm_shift(per[0]["quant_off"]["by_kind"],
                                off_ref["by_kind"])
            log(f"recurrent train mesh {name}: the quantization-off step's "
                f"({'float32' if arch in FLOAT32_QUANT_OFF else 'bf16'}) "
                f"squared grad norm against the unsharded step's, moved most "
                f"by (share of the change, the kind's own gap) "
                + ", ".join(f"{k} {v['share']:.2f} {v['gap']:.3g}"
                            for k, v in shift.items()))
            if not max(held.values()) <= MESH_TRAIN_RTOL:
                raise AssertionError(
                    f"phase 15 {name}: off the unsharded steps by {held} "
                    f"(tol {MESH_TRAIN_RTOL}): {[p['steps'] for p in per]} "
                    f"against {ref}")
            want_flash = n_attn * 2 * MESH_TRAIN_STEPS  # forward + recompute
            local = shape[1] > 1
            want_heads = [(cfg.n_heads // shape[1], cfg.n_kv_heads
                           // shape[1], cfg.head_dim)] if n_attn else []
            for r, p in enumerate(per):
                stuck = {k: p["update_over_half_ulp"][k]
                         for k, c in p["changed"].items() if c == 0}
                if not any(p["changed"].values()) \
                        or any(v >= 1 for v in stuck.values()):
                    raise AssertionError(
                        f"phase 15 {name} rank {r}: step 2 left watched "
                        f"leaves unchanged: {p['changed']}; update / "
                        f"half-ulp {p['update_over_half_ulp']}")
                flash = p["launches"].get("flash_attention", 0)
                if flash != want_flash or p["flash_heads"] != want_heads:
                    raise AssertionError(
                        f"phase 15 {name} rank {r}: flash launched {flash} "
                        f"times at {p['flash_heads']} (heads, KV heads, D), "
                        f"expected {want_flash} at {want_heads}")
                for k, v in p["launches"].items():
                    launches[k] = launches.get(k, 0) + v
            pred = peaks[name]["peak"]
            out["meshes"][name] = dict(
                per_rank=per, gaps=gaps, quant_off_shift=shift,
                predicted_peak_bytes=pred,
                peak_over_predicted=[p["peak_bytes"] / pred for p in per],
                tensor_parallel=local)
            for r, p in enumerate(per):
                c = p["collectives_last_step"]
                log(f"recurrent train mesh {name} rank {r}: losses "
                    f"{[round(s['loss'], 4) for s in p['steps']]} grad norms "
                    f"{[round(s['grad_norm'], 1) for s in p['steps']]} "
                    f"(unsharded: {[round(s['loss'], 4) for s in ref]}, "
                    f"{[round(s['grad_norm'], 1) for s in ref]}; quant-off "
                    f"step loss {p['quant_off']['loss']} grad_norm "
                    f"{p['quant_off']['grad_norm']} against "
                    f"{off_ref['loss']}, {off_ref['grad_norm']}; relative "
                    f"gaps " + ", ".join(f"{k} {v:.3g}" for k, v in
                                         gaps.items())
                    + f"; held: {', '.join(held)}, tol {MESH_TRAIN_RTOL}); "
                    f"s/step {[round(s['sec'], 2) for s in p['steps']]}, the "
                    f"last step's collectives {c['ms']:.1f} ms over "
                    f"{c['calls']} calls (a sync around each); peak "
                    f"{p['peak_bytes'] / 2**30:.2f} GiB, the dry-run's "
                    f"prediction {pred / 2**30:.2f} GiB (measured / "
                    f"predicted {p['peak_bytes'] / pred:.3f}); flash "
                    f"launches {p['launches'].get('flash_attention', 0)} at "
                    f"{p['flash_heads']}; watched leaves changed at step 2 "
                    + ", ".join(f"{k} {v:.3g}" for k, v in p["changed"]
                                .items())
                    + f" [{MESH_LABEL}; {smi}]")
    # long_500k: the (2, 1) mesh's decode against mesh-off's
    longs = [rk["long"] for rk in ranks]
    written = {}
    for r, lg in enumerate(longs):
        for i, (got, want) in enumerate(zip(lg["logits"],
                                            long_off["logits"])):
            err = float(abs(got - want).max() / abs(want).max())
            out["long_500k"][f"rank {r} step {i + 1} logit_err"] = err
            if not err <= LONG_LOGIT_RTOL:
                raise AssertionError(f"phase 15 long_500k rank {r} step "
                                     f"{i + 1}: logits off mesh-off's by "
                                     f"{err} of the largest")
        for k, v in lg["written"].items():
            if k in written:
                raise AssertionError(f"phase 15 long_500k: {k} written on "
                                     f"two ranks")
            written[k] = v
        for key, hit in lg["changed"].items():
            mine = [p for p in LONG_POSITIONS
                    if f"{key} {p}" in lg["written"]]
            if hit != mine:
                raise AssertionError(f"phase 15 long_500k rank {r}: {key} "
                                     f"changed at {hit}, expected {mine}")
    if long_off["changed"] != {k: list(LONG_POSITIONS) for k in ("k", "v")}:
        raise AssertionError(f"phase 15 long_500k mesh-off wrote "
                             f"{long_off['changed']}")
    for k, want in long_off["written"].items():
        if k not in written or not (written[k] == want).all():
            raise AssertionError(f"phase 15 long_500k: {k} not written as "
                                 f"mesh-off writes it")
    out["long_500k"].update(
        positions=list(LONG_POSITIONS), context=LONG_CONTEXT,
        mesh_off_ms=long_off["ms"], ranks_ms=[lg["ms"] for lg in longs],
        mesh_off_peak_bytes=long_off["peak_bytes"],
        ranks_peak_bytes=[lg["peak_bytes"] for lg in longs])
    log(f"long_500k decode (jamba layer 4 alone, float32, {LONG_CONTEXT} "
        f"positions, K / V time over \"data\" on {LONG_MESH}): logits within "
        + ", ".join(f"{v:.3g}" for k, v in out["long_500k"].items()
                    if k.endswith("logit_err"))
        + f" of the largest (tol {LONG_LOGIT_RTOL}); K / V written at "
        f"{list(LONG_POSITIONS)} as mesh-off, nowhere else; ms a step "
        f"mesh-off {[round(x, 1) for x in long_off['ms']]}, "
        + ", ".join(f"rank {r} {[round(x, 1) for x in lg['ms']]}"
                    for r, lg in enumerate(longs))
        + f"; peak GiB mesh-off {long_off['peak_bytes'] / 2**30:.2f}, ranks "
        + ", ".join(f"{lg['peak_bytes'] / 2**30:.2f}" for lg in longs)
        + f" [{MESH_LABEL}; {smi}]")
    for label in TINY_MESH:
        for shape in TRAIN_MESHES:
            key = f"{label} {'x'.join(map(str, shape))}"
            for r, rk in enumerate(ranks):
                got = {k: v if k == "metrics" else {
                    n: torch.from_numpy(a) for n, a in v.items()}
                    for k, v in rk["tiny"][key].items()}
                errs = _tiny_errors(torch, got, want_tiny[label])
                bad = {k: e for k, e in errs.items()
                       if e > TINY_TRAIN_TOL["metric" if k in (
                           "loss", "grad_norm") else k]}
                if bad:
                    raise AssertionError(f"phase 15 tiny {key} rank {r}: "
                                         f"the card's mesh step != the "
                                         f"CPU's {bad}")
                out["tiny_card_vs_cpu"][f"{key} rank {r}"] = errs
                log(f"tiny recurrent train mesh {key} rank {r}: card == the "
                    "CPU's unsharded step ("
                    + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
                    + f"; tolerances {TINY_TRAIN_TOL})")
    return out, launches


# ---------------------------------------------------------------------------
# phase 16: the paper's TNN trained and served on the card
# ---------------------------------------------------------------------------

TNN_STEPS, TNN_BATCH, TNN_SERVE_BATCHES = 250, 256, 4
TNN_GATE = 0.035            # the reference's gate on the QAT -> integer drop
TNN_CHECK_STEPS, TNN_CHECK_BATCH = 3, 16
# the first 3 steps from the init with power-of-two LSQ scales, card
# against CPU: 8.6e-4 read on an H100 (700 W), the planted fault 1.1e-2.
# At the init's own scales (0.05, 0.5) the card's step-0 loss already
# parts by 5.0e-3: the quantized blocks' sums are inexact in float32 and
# their order decides levels at the lattice's rounding boundaries and
# ReLU gradients at its zeros (ROADMAP Queue 3 item 16)
TNN_STEP_TOL = 2e-3
TNN_DYADIC = {"alpha_w": 2.0 ** -4, "alpha_a": 2.0 ** -1, "alpha_r": 2.0 ** -3}


def _tnn_steps(qat, init, spec, device, lr=2e-3, steps=TNN_CHECK_STEPS):
    """``steps`` steps of ``init`` (a CPU copy) on ``device``: the losses
    and the parameters, back on the CPU."""
    from repro_torch.tree import tree_leaves, tree_map
    params = tree_map(lambda t: t.to(device, copy=True), init)
    losses = qat.fit_mlp(params, spec, steps, TNN_CHECK_BATCH, lr)
    return losses, [t.cpu() for t in tree_leaves(params)]


def _tnn_gap(a, b):
    """The largest difference between two runs' losses and parameters."""
    return max(max(abs(x - y) for x, y in zip(a[0], b[0])),
               max(float((x - y).abs().max()) for x, y in zip(a[1], b[1])))


def trained_tnn(torch, dev, smi):
    """QAT-train the TNN on the card, export it and serve it through the
    fused-SI ternary matmul (part 1 of ``examples/serve_sc.py``); hold
    the codes, the launches, the accuracy gate and a card == CPU check
    of the first steps."""
    from repro_torch import prng
    from repro_torch.core.sc_layers import _si_epilogue
    from repro_torch.examples import _qat_mlp as qat
    from repro_torch.examples import serve_sc
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.ref import ternary_matmul_ref
    spec = serve_sc.SPEC

    # read, not held: the step-0 loss on the card against the CPU's at the
    # init's own scales (ROADMAP Queue 3 item 16)
    init = qat.init_mlp(prng.key(SEED), spec, device="cpu")
    lattice_gap = abs(_tnn_steps(qat, init, spec, dev, steps=1)[0][0]
                      - _tnn_steps(qat, init, spec, "cpu", steps=1)[0][0])

    # the first steps on the card against the same steps on the CPU, from
    # one init (its scales powers of two), and a planted fault that must
    # read above the tolerance
    for blk in init["blocks"]:
        blk.update({k: torch.tensor(v) for k, v in TNN_DYADIC.items()})
    cpu = _tnn_steps(qat, init, spec, "cpu")
    card = _tnn_steps(qat, init, spec, dev)
    fault = _tnn_steps(qat, init, spec, dev, lr=4e-3)
    step_gap, fault_gap = _tnn_gap(card, cpu), _tnn_gap(fault, cpu)
    log(f"TNN: first {TNN_CHECK_STEPS} steps at batch {TNN_CHECK_BATCH}, "
        f"card vs CPU: max |loss or param gap| {step_gap:.3g} (tolerance "
        f"{TNN_STEP_TOL:g}); planted fault (twice the lr) {fault_gap:.3g}; "
        f"losses card {card[0]} CPU {cpu[0]}; at the init's own scales "
        f"the step-0 loss parts by {lattice_gap:.3g} (read)")
    if not step_gap <= TNN_STEP_TOL < fault_gap:
        raise AssertionError(f"TNN steps: card vs CPU {step_gap} or the "
                             f"planted fault {fault_gap} against "
                             f"{TNN_STEP_TOL}")

    # the main path: train, evaluate, export, serve
    torch.cuda.synchronize()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    params = qat.init_mlp(prng.key(SEED), spec, dev)
    losses = qat.fit_mlp(params, spec, TNN_STEPS, TNN_BATCH)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    acc_qat = qat.eval_mlp(params, spec)
    layers = serve_sc.export_int_model(params)
    batches = [qat.DATASET.batch(30_000 + i, TNN_BATCH, dev)
               for i in range(TNN_SERVE_BATCHES)]
    served_launches = []
    with torch.no_grad():
        codes, logits = [], []
        for b in batches:
            before = kbuild.LAUNCHES["ternary_matmul"]
            codes.append(serve_sc.serve_codes(params, layers, b["x"]))
            logits.append(serve_sc.head_logits(params, layers,
                                               codes[-1][-1]))
            served_launches.append(kbuild.LAUNCHES["ternary_matmul"]
                                   - before)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.LAUNCHES)

    # checks (their plain-version launches come after the counts are read)
    if served_launches != [len(layers)] * TNN_SERVE_BATCHES or any(
            v for k, v in launches.items() if k != "ternary_matmul"):
        raise AssertionError(f"TNN serving: ternary_matmul launches a batch "
                             f"{served_launches}, all {launches}")
    with torch.no_grad():
        for j, batch_codes in enumerate(codes):
            for i, layer in enumerate(layers):
                xin, out = batch_codes[i], batch_codes[i + 1]
                sum_max = layer["w_int"].shape[0] * ACT_BSL // 2
                plain = ternary_matmul_ref(xin, layer["w_int"],
                                           layer["thresholds_q"])
                unfused = _si_epilogue(
                    {"thresholds": layer["thresholds_q"][:1] + sum_max,
                     "sum_max": sum_max},
                    ternary_matmul_ref(xin, layer["w_int"]))
                if not (torch.equal(out.to(torch.int32), plain)
                        and torch.equal(plain, unfused)):
                    raise AssertionError(f"TNN batch {j} layer {i}: kernel "
                                         f"codes != plain")
    correct = sum(int(torch.sum(torch.argmax(lg, -1) == b["y"]))
                  for lg, b in zip(logits, batches))
    acc_int = correct / (TNN_BATCH * TNN_SERVE_BATCHES)
    drop = acc_qat - acc_int
    if not (all(lg.shape == (TNN_BATCH, 10) and bool(torch.isfinite(lg).all())
                for lg in logits) and drop < TNN_GATE):
        raise AssertionError(f"TNN: integer accuracy {acc_int} against QAT "
                             f"{acc_qat} (gate {TNN_GATE})")
    x = batches[0]["x"]
    with torch.no_grad():
        serve_ms = time_ms(lambda: serve_sc.serve_batch(params, layers, x))
    res = dict(seconds=seconds, launches=launches,
               served_launches=served_launches, train_steps=TNN_STEPS,
               train_batch=TNN_BATCH, train_s=train_s,
               s_per_step=train_s / TNN_STEPS, first_loss=losses[0],
               last_loss=losses[-1], acc_qat=acc_qat, acc_int=acc_int,
               drop=drop, alpha_a=[l["alpha_a"] for l in layers],
               serve_ms=serve_ms, step_gap=step_gap, lattice_gap=lattice_gap,
               fault_gap=fault_gap, nvidia_smi=smi)
    log(f"TNN W2-A8: QAT accuracy {acc_qat * 100:.2f}%, integer accuracy "
        f"{acc_int * 100:.2f}% ({TNN_SERVE_BATCHES} x {TNN_BATCH} at steps "
        f"30000+), drop {drop * 100:.2f} pp (gate {TNN_GATE * 100:.1f}), "
        f"alpha_a {res['alpha_a']}; "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; {train_s / TNN_STEPS:.4f}"
        f" s a training step ({TNN_STEPS} steps of {TNN_BATCH}); "
        f"{serve_ms:.4f} ms a served batch of {TNN_BATCH} (CUDA events); "
        f"ternary_matmul launches a batch {served_launches}, codes == "
        f"plain == unfused SI; {seconds:.2f} s; {smi}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # phases 4, 6 and 7 were cut from 40 and 8 layers when phase 8 came,
    # to keep the whole run near half the driver's 1200 s; granite from 20
    # to 6 layers when phase 15 came (on one H100 the phases summed to
    # 1103.5 s at 20 layers before phase 15, and to 1084.9 s with it at
    # 10)
    ap.add_argument("--layers", type=int, default=6,
                    help="granite-3-2b depth to serve (phases 4, 10 and "
                         "11) and train (of 40; full width always)")
    # 2 since phase 15 came (4 since phase 8)
    ap.add_argument("--moe-layers", type=int, default=2,
                    help="qwen3-moe-235b-a22b depth to serve in phase 7 "
                         "(of 94; full width always)")
    # 4 of 32 since phase 15 came (16 since phase 14): the whole run stays
    # inside its 1200 s limit (the sc_int_approx prefill is phase 8's
    # largest cost; at 32 layers the run took 1110 s of phases, at 16 1053
    # s)
    ap.add_argument("--rwkv-layers", type=int, default=4,
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
    ap.add_argument("--hubert-layers", type=int, default=48,
                    help="hubert-xlarge depth to encode in phase 13 (of 48; "
                         "full width always)")
    # a llava layer holds ~0.56 G parameters, its embedding and lm_head
    # 0.46 G each; 4 keep phase 13 near its share of the time limit
    ap.add_argument("--llava-layers", type=int, default=4,
                    help="llava-next-34b depth to serve in phase 13 (of "
                         "60; full width always)")

    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        if _NO_PORT is not None:
            raise _NO_PORT
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
    pre += check_prefill(torch, dev, gen, shapes=QWEN3_PREFILL_SHAPES,
                         **QWEN3_ATTN)
    mma = check_prefill(torch, dev, gen, **MMA_PREFILL)
    if {c["kernel"] for c in mma} != {"paged_prefill_mma_kernel"}:
        raise AssertionError(f"prefill on 32-position pages ran "
                             f"{sorted({c['kernel'] for c in mma})}, not "
                             f"paged_prefill_mma_kernel")
    pre += mma
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

    # phase 10: seeded sampling, logprobs and speculative decoding, then
    # tiny card==cpu sampled and speculative tokens
    sampled, sampled_launches = sampled_serving(torch, dev, args.layers,
                                                serving, smi)
    for k, v in sampled_launches.items():
        launches[k] += v
    tiny_sampled_card_equals_cpu(torch, dev)
    mark(10)

    # phase 11: mesh serving, 2 ranks of a (1, 2) mesh on the one card
    mesh, mesh_launches = mesh_serving(torch, dev, args.layers, serving, smi)
    for k, v in mesh_launches.items():
        launches[k] += v
    mark(11)

    # phase 12: the analysis gates on the card
    analysis = analysis_gates(torch, dev, args.layers, smi, res.log)
    mark(12)

    # phase 13: the vision and audio front ends, the circuit models and
    # the examples
    frontends, fe_launches = frontends_and_circuits(
        torch, dev, args.hubert_layers, args.llava_layers, smi)
    for k, v in fe_launches.items():
        launches[k] += v
    mark(13)

    # phase 14: the training mesh, 2 ranks of (1, 2) and (2, 1) meshes
    train_mesh, tm_launches = training_mesh(torch, dev, args.layers,
                                            training, smi)
    for k, v in tm_launches.items():
        launches[k] += v
    mark(14)

    # phase 15: the recurrent archs on the training mesh, long_500k's
    # decode over a cache cut in time over "data"
    recurrent_mesh, rm_launches = recurrent_training_mesh(
        torch, dev, args.rwkv_train_layers, smi)
    for k, v in rm_launches.items():
        launches[k] += v
    mark(15)

    # phase 16: the paper's TNN trained, exported and served on the card
    tnn = trained_tnn(torch, dev, smi)
    for k, v in tnn["launches"].items():
        launches[k] += v
    mark(16)

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
         "sampled_serving": sampled, "mesh_serving": mesh,
         "analysis": analysis, "roofline": analysis["roofline"],
         "frontends": frontends, "training_mesh": train_mesh,
         "recurrent_training_mesh": recurrent_mesh, "trained_tnn": tnn,
         "float_products": products, "phase_s": phase_s, **summary},
        indent=1))
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
