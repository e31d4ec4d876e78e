#!/usr/bin/env python3
"""Where the wgmma paged prefill's time goes over int8 / sc pools, on one
CUDA card.

Times ``paged_attn_prefill_cuda`` (``paged_prefill_wgmma_kernel``) at
phase 3's 4096-chunk shapes (granite's Gq 4, qwen3-moe's Gq 16) and at the
serving chunk, as built from ``src/``, and two copies of the kernel
source with a part of the producer's widening taken out, each built on
its own and timed the same way.  The copies compute wrong numbers on
purpose; nothing in the package is changed, and only their times are
read:

- ``no_arith``: the raw codes (and residuals) are stored into the stage
  as they are: the shared-memory loads and stores stay, the widening's
  arithmetic (PRMT, FADD / FFMA, F2F) goes;
- ``no_pass``: the producer warpgroup neither reads the raw stage nor
  writes the bf16 stage (TMA, the scales, the fence and the barriers
  stay): what the products and the consumers' softmax take alone.

fp pools do not widen and are timed as the control.  Run from the
repository root::

    python3 chip_prefill_ablation.py

Prints the card's name and power limit and one line a variant (device ms
a call, torch.profiler); writes ``chiprun_out/prefill_ablation.json``.
"""

import json
import subprocess
import sys
from pathlib import Path

from chip_flash_ablation import time_variants

ROOT = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc/paged_attention.cu")
# the copies' trees, inside the ignored build directory
WORK = ROOT / "src/repro_torch/_build/prefill_ablation"

# (anchor in the kernel source, what takes its place)
VARIANTS = {
    "no_arith": ("            uint32_t w[8];\n"
                 "            widen_joined<KIND>(code, resid, w);\n",
                 "            const uint32_t w[8] = {code.x, code.y, code.z,"
                 " code.w, resid.x, resid.y, resid.z, resid.w};\n"),
    "no_pass": ("          for (int i = 0; i < UNITS / 128; ++i) {\n",
                "          for (int i = 0; i < 0; ++i) {\n"),
}

# timed in a child process per tree, so each imports its own build
TIMER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import repro_torch              # this tree's, before chip_smoke adds src/
import chip_smoke as cs
from repro_torch.kernels.paged_attention import paged_attn_prefill_cuda
dev = torch.device("cuda")
gen = torch.Generator(dev).manual_seed(cs.SEED)
out = {}
for label, start, width, Hkv, Gq in (("4096", 4032, 256, 8, 4),
                                     ("qwen3 4096", 4032, 256, 4, 16),
                                     ("serving", 64, 8, 8, 4)):
    N = 4 * width + 1
    tables = (torch.randperm(N - 1, generator=gen, device=dev) + 1) \
        .reshape(4, width).to(torch.int32)
    q = torch.randn((4, 64, Hkv, Gq, 64), generator=gen, device=dev) \
        .to(torch.bfloat16)
    for fmt in ("fp", "int8", "sc"):
        pools = cs._pools(torch, gen, dev, fmt, N, 16, Hkv, 64)
        aux = {k: v for k, v in pools.items() if not k.endswith("_pages")}
        out[f"{label} {fmt}"] = cs.device_ms_per_call(
            torch, lambda: paged_attn_prefill_cuda(
                q, pools["k_pages"], pools["v_pages"], tables, start=start,
                kv_format=fmt, **aux))
        del pools, aux
print(json.dumps(out))
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_prefill_ablation: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / CSRC).is_file():
        print("chip_prefill_ablation: the repro_torch sources are missing",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    times = time_variants(TIMER, CSRC, WORK, VARIANTS)
    if times is None:
        return 1
    res = {"nvidia_smi": smi, **times}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "prefill_ablation.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
