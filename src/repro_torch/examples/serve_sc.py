"""Serve an LM on the integer SC datapath through the port's ServeEngine.

Continuous batching over the paged KV cache (int8 pool), every
projection re-quantized on the fly to the int8 x ternary datapath
(``datapath="sc_int"``: the ``ternary_matmul`` kernel on the card),
batched decode held token for token against the one-request-at-a-time
oracle, first greedy and then seeded sampling (temperature / top-p with
a seed a request), which must be just as reproducible: the sampler's
streams are keyed by (seed, position) only.

    PYTHONPATH=src python -m repro_torch.examples.serve_sc [--smoke]

Port of part 2 of ``examples/serve_sc.py``.  Its part 1 (QAT-train the
paper's TNN, export it and serve it through the fused-SI kernel) needs
the QAT MLP trainer of ``benchmarks/_qat_mlp.py``, which is not ported
yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_arch
from ..device import resolve_device
from ..models import init_params
from ..serving import (EngineConfig, SamplingParams, ServeEngine,
                       sequential_generate)


def _tokens(done) -> list[list[int]]:
    return [r.generated for r in sorted(done, key=lambda r: r.rid)]


def serve_lm_engine(smoke: bool = False,
                    device: str | torch.device | None = None) -> dict:
    """Greedy, then seeded-sampled continuous batching on sc_int x int8;
    raises if either parts from the sequential oracle.  Returns the
    tokens of both runs."""
    dev = resolve_device(device)
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=64, vocab_pad_multiple=32, dtype="float32")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n_req, max_new = (4, 6) if smoke else (6, 12)
    prompts = [[(3 * i + j) % 64 for j in range(4 + i)]
               for i in range(n_req)]
    config = EngineConfig(max_slots=4, max_len=64, page_size=16,
                          datapath="sc_int", kv_format="int8").validate()
    oracle = dict(max_new_tokens=max_new, max_len=64, datapath="sc_int",
                  kv_format=config.kv_format, device=dev)

    eng = ServeEngine(params, cfg, config=config, device=dev)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    t0 = time.perf_counter()
    greedy = _tokens(eng.run_to_completion())
    dt = time.perf_counter() - t0
    toks = sum(len(g) for g in greedy)
    print(f"[serve_sc] engine: {len(greedy)} requests through 4 slots, "
          f"{toks} tokens in {dt * 1e3:.0f} ms ({toks / dt:.0f} tok/s) on "
          f"{dev}, paged KV ({eng.page_size}-token pages, "
          f"{config.kv_format} pool), int8 x ternary datapath")
    if greedy != sequential_generate(params, cfg, prompts, **oracle):
        raise AssertionError("batched decode diverged from the sequential "
                             "oracle")
    print("[serve_sc] OK: batched continuous-batching output is "
          "token-identical to per-request sequential decode")

    sps = [SamplingParams(temperature=0.8, top_p=0.9, seed=17 + i)
           for i in range(len(prompts))]
    eng = ServeEngine(params, cfg, config=config, device=dev)
    for p, sp in zip(prompts, sps):
        eng.submit(p, max_new_tokens=max_new, sampling=sp)
    sampled = _tokens(eng.run_to_completion())
    if sampled != sequential_generate(params, cfg, prompts, sampling=sps,
                                      **oracle):
        raise AssertionError("sampled decode diverged from the sequential "
                             "oracle")
    if sampled == greedy:
        raise AssertionError("sampling degenerated to greedy")
    print("[serve_sc] OK: seeded sampled decode (temperature=0.8, "
          "top_p=0.9) reproduces the sequential oracle token for token")
    return {"greedy": greedy, "sampled": sampled}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fewer requests and tokens")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print("[serve_sc] ServeEngine (paged KV, sc_int)")
    return serve_lm_engine(args.smoke, args.device)


if __name__ == "__main__":
    main()
