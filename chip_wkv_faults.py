#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s wkv check sits from a sound and a faulty
chunked wkv, on one CUDA card.

Runs phase 9's :func:`chip_smoke.chunked_wkv_step` on full-width rwkv6-7b
(1 layer, seeded weights, one ``SyntheticLM`` row of 4096 tokens), keeps
layer 0's wkv operands, and reads :func:`chip_smoke.wkv_gap` on them for
the sound ``_wkv_chunked`` at three chunk sizes and for stand-ins with a
planted fault (nothing in the package is changed).  The readings set
``chip_smoke.WKV_RTOL``.  Run from the repository root::

    python3 chip_wkv_faults.py

Prints one line a reading and writes ``chiprun_out/wkv_faults.json``.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_wkv_faults: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, rwkv6
    from repro_torch.train import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_arch("rwkv6-7b").scaled(n_layers=1)
    state = init_train_state(init_params(
        cfg, torch.Generator(dev).manual_seed(cs.SEED), dev), cfg)
    batch = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ,
                        seed=cs.SEED).batch(cs.TRAIN_STEPS, 1)
    seen, gap = [], cs.wkv_gap

    def keep(torch_, operands, chunked):
        seen.append(operands)
        return gap(torch_, operands, chunked)

    cs.wkv_gap = keep
    _, step = cs.chunked_wkv_step(torch, cfg, state, batch)
    good = rwkv6._wkv_chunked

    def at_chunk(c):
        return lambda r, k, v, w, u, s0, _: good(r, k, v, w, u, s0, c)

    def no_carry(r, k, v, w, u, s0, c):
        y = torch.cat([good(*(t[:, i:i + c] for t in (r, k, v, w)), u, s0,
                            c)[0] for i in range(0, r.shape[1], c)], 1)
        return y, good(r, k, v, w, u, s0, c)[1]

    def with_w(f):
        return lambda r, k, v, w, u, s0, c: good(r, k, v, f(w), u, s0, c)

    readings = {
        "sound, chunk 32 (the config's)": good,
        "sound, chunk 16": at_chunk(16),
        "sound, chunk 64": at_chunk(64),
        "y zeroed": lambda *a: (good(*a)[0] * 0, good(*a)[1]),
        "u dropped": lambda r, k, v, w, u, s0, c: good(r, k, v, w, u * 0,
                                                       s0, c),
        "decays a token late": with_w(
            lambda w: torch.cat([w[:, :1], w[:, :-1]], 1)),
        "decays of the next head": with_w(lambda w: w.roll(1, dims=2)),
        "state not carried across chunks": no_carry,
        "decays rounded to bf16": with_w(lambda w: w.bfloat16().float()),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = dict(nvidia_smi=smi, operands=list(seen[0][0].shape),
               chunk=seen[0][6], step=step, tol=cs.WKV_RTOL)
    print(smi, flush=True)
    for name, fn in readings.items():
        out[name] = gap(torch, seen[0], fn)
        print(f"wkv reading, {name}: " + ", ".join(
            f"{k} {v:.3g}" for k, v in out[name].items()), flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "wkv_faults.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
