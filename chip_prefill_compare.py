#!/usr/bin/env python3
"""Time the paged prefill of other trees of the port beside this one's,
on one card, in turns.

Runs ``chip_smoke.check_prefill`` (this checkout's: the same shapes,
checks and timing code) against each tree's own ``src`` in a process of
its own, in the order others, this, this, others reversed (parent,
change, change, parent for one other tree), so that every tree's kernels
are timed in one call on one card.  Each run builds its tree's kernels
into that tree's ``src/repro_torch/_build``, and also times the host's
side of a serving-chunk call (fp and sc: Python wrapper, tensor maps,
launches) as wall microseconds a call over back-to-back calls, where the
host outlasts the kernel.  Once, in this process, it times one
``cuTensorMapEncodeTiled`` of a serving pool's map through libcuda (what
the wgmma kernels' launches pay per map), beside a trivial driver call
through the same ctypes path.  Prints one line a case and run, and
writes ``chiprun_out/prefill_compare.json``.

    git archive <commit> | tar -x -C .chip_archive/parent
    python3 chip_prefill_compare.py .chip_archive/parent [tree ...]

Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "prefill_compare.json"

_CHILD = r"""
import json, sys
root, tree = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import chip_smoke as cs
for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
    del sys.modules[name]
sys.path.insert(0, tree + "/src")
import statistics, time
import torch
from repro_torch.kernels import build, plan
assert build.__file__.startswith(tree), build.__file__
if not hasattr(plan, "PAGED_PREFILL_KERNELS"):   # trees before the wgmma one
    plan.PAGED_PREFILL_KERNELS = {0: "prefill_kernel",
                                  1: "paged_prefill_mma_kernel"}
build.library()
dev = torch.device("cuda")
gen = torch.Generator(dev).manual_seed(cs.SEED)
cases = cs.check_prefill(torch, dev, gen)
cases += cs.check_prefill(torch, dev, gen, shapes=cs.JAMBA_PREFILL_SHAPES,
                          **cs.JAMBA_ATTN)
cases += cs.check_prefill(torch, dev, gen, shapes=cs.QWEN3_PREFILL_SHAPES,
                          **cs.QWEN3_ATTN)
cases += cs.check_prefill(torch, dev, gen, **cs.MMA_PREFILL)
from repro_torch.kernels.paged_attention import paged_attn_prefill_cuda
host = {}
for fmt in ("fp", "sc"):       # the serving chunk: start 64, 8 lanes
    pools = cs._pools(torch, gen, dev, fmt, 33, 16, 8, 64)
    aux = {k: v for k, v in pools.items() if not k.endswith("_pages")}
    tables = (torch.randperm(32, generator=gen, device=dev) + 1) \
        .reshape(4, 8).to(torch.int32)
    q = torch.randn((4, 64, 8, 4, 64), generator=gen, device=dev) \
        .to(torch.bfloat16)
    call = lambda: paged_attn_prefill_cuda(q, pools["k_pages"],
                                           pools["v_pages"], tables,
                                           start=64, kv_format=fmt, **aux)
    reps = []
    for _ in range(7):
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        torch.cuda.synchronize()
        reps.append((time.perf_counter() - t0) / 2000 * 1e6)
    host[fmt] = statistics.median(reps)
print("RESULT " + json.dumps(dict(cases=cases, host_us=host)), flush=True)
"""


def run(tree: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT),
                           str(tree.resolve())], capture_output=True,
                          text=True, timeout=1200)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode:
        print(proc.stdout[-4000:])
        raise SystemExit(f"{tree}: exit {proc.returncode}")
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    import torch
    if len(sys.argv) < 2:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card")
        return 1
    others = [Path(a) for a in sys.argv[1:]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    encode = encode_us(torch)
    print("host us a call: cuTensorMapEncodeTiled {encode:.3f}, "
          "cuDriverGetVersion {trivial:.3f} (ctypes)".format(**encode),
          flush=True)
    runs = []
    order = [(str(t), t) for t in others] + [("this", ROOT)]
    for label, tree in order + order[::-1]:
        res = run(tree)
        runs.append(dict(tree=label, path=str(tree), **res))
        for c in res["cases"]:
            print(f"{label} {c['label']:22s} {c.get('kernel', '-'):27s} "
                  f"ms={c['ms']:.4f} call_ms={c['call_ms']:.4f} "
                  f"sdpa={c['library_ms']:.4f} bound={c['bound_ms']:.5f} "
                  f"err={c['max_abs_err']:.3g}", flush=True)
        print(f"{label} host us a serving-chunk call: "
              + " ".join(f"{k} {v:.2f}" for k, v in res["host_us"].items()),
              flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(dict(nvidia_smi=smi, encode_us=encode,
                                   runs=runs), indent=1))
    return 0


def encode_us(torch, calls: int = 20000) -> dict:
    """Host microseconds a call of cuTensorMapEncodeTiled over the serving
    chunk's bf16 K pool (33 pages of 16 x 8 heads x 64, a 64-column box of
    a page in 128B swizzle, as tensor_map_4d encodes it), and of
    cuDriverGetVersion, the same ctypes path's own cost."""
    import ctypes
    import time
    cuda = ctypes.CDLL("libcuda.so.1")
    pool = torch.zeros((33, 16, 8, 64), dtype=torch.bfloat16, device="cuda")
    buf = (ctypes.c_uint8 * 192)()          # a CUtensorMap, 64-byte aligned
    tmap = ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63)
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    # BFLOAT16 9, rank 4, no interleave, SWIZZLE_128B 3, L2 256B 3, no fill
    args = (tmap, 9, 4, ctypes.c_void_p(pool.data_ptr()),
            (u64 * 4)(64, 8, 16, 33), (u64 * 3)(128, 8 * 128, 16 * 8 * 128),
            (u32 * 4)(64, 1, 16, 1), (u32 * 4)(1, 1, 1, 1), 0, 3, 3, 0)
    version = ctypes.c_int()
    out = {}
    for name, fn, a in (("encode", cuda.cuTensorMapEncodeTiled, args),
                        ("trivial", cuda.cuDriverGetVersion,
                         (ctypes.byref(version),))):
        rc = fn(*a)
        if rc:
            raise RuntimeError(f"{name}: CUresult {rc}")
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(*a)
            reps.append((time.perf_counter() - t0) / calls * 1e6)
        out[name] = min(reps)
    return out


if __name__ == "__main__":
    sys.exit(main())
