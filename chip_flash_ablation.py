#!/usr/bin/env python3
"""Where the bf16 flash forward's time goes, on one CUDA card.

Times ``flash_attention_cuda`` (``flash_fwd_wgmma_kernel``) at phase 3's
bf16 shapes as built from ``src/``, and three copies of the kernel source
with one part of a tile's work taken out, each built on its own and timed
the same way.  The copies compute wrong numbers on purpose; nothing in
the package is changed, and only their times are read:

- ``no_lo``: P V without its lo product (P as one bf16 term);
- ``no_exp``: the weights without ``ex2`` (the argument stands in);
- ``no_weights``: no row max, exponentials or sums (the weights are S).

Also counts the instruction kinds of the D 64 instance in the built
library (``cuobjdump -sass``).  Run from the repository root::

    python3 chip_flash_ablation.py

Prints the card's name and power limit, one line a variant and the
instruction counts; writes ``chiprun_out/flash_ablation.json``.
"""

import json
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = Path("src/repro_torch/kernels/csrc/flash_attention.cu")
# the copies' trees, inside the ignored build directory
WORK = ROOT / "src/repro_torch/_build/flash_ablation"

# (anchor in the kernel source, what takes its place)
VARIANTS = {
    "no_lo": ("      for (int kk = 0; kk < WG_BK / 16; ++kk)\n"
              "        wg_pv<D>(o, o16, p_lo[kk], dv + st, dv16 + st, kk);\n",
              ""),
    "no_exp": ("      s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -base[e >> 1]));",
               "      s[4 * j + e] = fmaf(s[4 * j + e], c, -base[e >> 1]);"),
    "no_weights": ("      if (key0 + WG_BK > S || (causal && key0 + WG_BK - 1 > "
                   "wrow0))\n"
                   "        wg_weights<true>(s, m_r, l_r, corr, c, key0, S, "
                   "causal, r_lo, tq);\n"
                   "      else\n"
                   "        wg_weights<false>(s, m_r, l_r, corr, c, key0, S, "
                   "causal, r_lo, tq);\n",
                   "      corr[0] = corr[1] = 1.f;\n"),
}

# timed in a child process per tree, so each imports its own build
TIMER = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
import repro_torch              # this tree's, before chip_smoke adds src/
import chip_smoke as cs
from repro_torch.kernels.flash_attention import flash_attention_cuda
dev = torch.device("cuda")
gen = torch.Generator(dev).manual_seed(cs.SEED)
out = {}
for label, shp, causal in (
        ("train", cs.FLASH_SHAPE, True), ("local", cs.FLASH_LOCAL_SHAPE, True),
        ("jamba", cs.JAMBA_FLASH_SHAPE, True),
        ("hubert", cs.HUBERT_FLASH_SHAPE, False),
        ("llava", cs.LLAVA_FLASH_SHAPE, True)):
    q, k, v = cs._flash_inputs(torch, gen, dev, **shp, dtype=torch.bfloat16)
    out[label] = cs.time_ms(
        lambda: flash_attention_cuda(q, k, v, causal=causal), iters=20)
print(json.dumps(out))
"""


def edited_tree(csrc: Path, work: Path, name: str,
                variants: dict) -> Path:
    """``src`` as it is (``name`` "full"), or a copy under ``work`` whose
    ``csrc`` has the variant's anchor replaced."""
    if name == "full":
        return ROOT / "src"
    anchor, repl = variants[name]
    dst = work / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = dst / csrc.relative_to("src")
    text = path.read_text()
    if text.count(anchor) != 1:
        raise RuntimeError(f"{name}: its anchor is not once in {csrc}")
    path.write_text(text.replace(anchor, repl))
    return dst


def time_variants(timer: str, csrc: Path, work: Path,
                  variants: dict) -> dict | None:
    """Runs ``timer`` (a child program printing a JSON object of ms) on
    the tree of "full", of each variant, then of "full" again; prints a
    line each; returns {name: [result, ...]}, None if a child failed."""
    res = {}
    for name in ("full", *variants, "full"):
        src = edited_tree(csrc, work, name, variants)
        out = subprocess.run([sys.executable, "-c", timer, str(src),
                              str(ROOT)], capture_output=True, text=True)
        if out.returncode:
            print(out.stderr[-3000:], file=sys.stderr)
            return None
        ms = json.loads(out.stdout.strip().splitlines()[-1])
        res.setdefault(name, []).append(ms)
        print(f"{name}: " + " ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + " ms", flush=True)
    return res


def sass_counts(so: str) -> dict:
    """Instruction kinds of flash_fwd_wgmma_kernel<64> in the library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    block = next(b for b in sass.split("Function : ")[1:]
                 if "flash_fwd_wgmma_kernelILi64" in b.split("\n", 1)[0])
    ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     block)
    return dict(Counter(ops).most_common(12), total=len(ops))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_flash_ablation: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / CSRC).is_file():
        print("chip_flash_ablation: the repro_torch sources are missing",
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
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    res["sass_d64"] = sass_counts(str(build.build().path))
    print("flash_fwd_wgmma_kernel<64> instructions:", res["sass_d64"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_ablation.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
