"""Serve trained models on the integer SC datapath (what the silicon runs).

Part 1, the paper's TNN MLP, exported:
1. QAT-trains the TNN MLP (784-256-256-10, W2-A8) on the synthetic set;
2. exports every layer to ternary int8 weights and SI threshold tables
   (the activation fused into the selective interconnect);
3. serves batches through ``ternary_matmul`` with its fused SI epilogue
   (the hand-written kernel on the card) and holds the integer path's
   accuracy against the QAT model's.

Part 2, an LM through the port's ServeEngine: continuous batching over
the paged KV cache (int8 pool), every projection re-quantized on the fly
to the int8 x ternary datapath (``datapath="sc_int"``), batched decode
held token for token against the one-request-at-a-time oracle, first
greedy and then seeded sampling (temperature / top-p with a seed a
request), which must be just as reproducible: the sampler's streams are
keyed by (seed, position) only.

    PYTHONPATH=src python -m repro_torch.examples.serve_sc [--smoke]

Port of ``examples/serve_sc.py``.  As there, ``export_int_model``
requantizes each layer's output to that layer's own ``alpha_a``, though
``serve_batch`` feeds it to the next layer, which QAT trained with its
own ``alpha_a``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_arch
from ..core import si
from ..core.coding import quantize_levels
from ..device import resolve_device
from ..kernels import ops
from ..models import init_params
from ..serving import (EngineConfig, SamplingParams, ServeEngine,
                       sequential_generate)
from ._qat_mlp import DATASET, QatSpec, eval_mlp, train_mlp

SPEC = QatSpec(weight_bsl=2, act_bsl=8, resid_bsl=None)
ACT_BSL = 8


def export_int_model(params: dict) -> list[dict]:
    """QAT params -> the integer datapath: int8 ternary weights
    ``w_int`` (K, N) and SI tables ``thresholds_q`` (N, 8) in the q
    domain, on the parameters' device.  Computed in numpy on the host,
    as the reference computes them, so the tables are its bit for bit."""
    layers = []
    for blk in params["blocks"]:
        dev = blk["w"].device
        w = blk["w"].detach().cpu().numpy().astype(np.float32)
        aw = float(blk["alpha_w"])
        aa = float(blk["alpha_a"])
        w_int = np.clip(np.round(w / aw), -1, 1).astype(np.int8)
        sum_max = w.shape[0] * ACT_BSL // 2
        # the SI realises the ReLU and the requantization
        t_counts = si.si_thresholds(si.relu_fn, 2 * sum_max, ACT_BSL,
                                    alpha_in=aa * aw, alpha_out=aa)
        t_q = (t_counts.astype(np.int64) - sum_max).astype(np.int32)
        layers.append({"w_int": torch.from_numpy(w_int).to(dev),
                       "thresholds_q": torch.from_numpy(
                           np.tile(t_q, (w.shape[1], 1))).to(dev),
                       "alpha_a": aa})
    return layers


def serve_codes(params: dict, int_layers: list[dict],
                x: torch.Tensor) -> list[torch.Tensor]:
    """The float front end, then the SC integer core: the int8 codes that
    enter the first layer, then each layer's output codes (one
    ``ternary_matmul`` with the fused SI a layer)."""
    h = torch.relu(x @ params["w_in"])
    # a 0-d tensor, not a Python float: CUDA divides by a host scalar as a
    # multiply by its reciprocal, which can move a code at a .5 boundary
    alpha_a = torch.tensor(int_layers[0]["alpha_a"], device=h.device)
    codes = [quantize_levels(h, alpha_a, ACT_BSL).to(torch.int8)]
    for layer in int_layers:
        out_q = ops.ternary_matmul(codes[-1], layer["w_int"],
                                   layer["thresholds_q"])
        codes.append(out_q.to(torch.int8))
    return codes


def head_logits(params: dict, int_layers: list[dict],
                code: torch.Tensor) -> torch.Tensor:
    """The last layer's codes -> logits through the float head."""
    h = code.to(torch.float32) * int_layers[-1]["alpha_a"]
    return h @ params["w_out"]


def serve_batch(params: dict, int_layers: list[dict],
                x: torch.Tensor) -> torch.Tensor:
    """float input -> front end (float) -> SC integer core -> logits."""
    return head_logits(params, int_layers,
                       serve_codes(params, int_layers, x)[-1])


def serve_tnn(steps: int = 250, batch: int = 256, eval_batches: int = 4,
              eval_batch: int = 256, gate: bool = True,
              device: str | torch.device | None = None) -> dict:
    """Part 1: QAT-train the TNN, export it and serve ``eval_batches``
    batches of the held-out steps ``30_000 + i``.  With ``gate`` it
    raises when the integer path's accuracy is 3.5 points or more below
    the QAT model's (the reference's gate)."""
    dev = resolve_device(device)
    print(f"[serve_sc] QAT-training the TNN (W2-A8), {steps} steps...")
    params = train_mlp(SPEC, steps=steps, batch=batch, seed=0, device=dev)
    acc_qat = eval_mlp(params, SPEC)
    print(f"[serve_sc] QAT accuracy: {acc_qat * 100:.2f}%")

    int_layers = export_int_model(params)
    n_int8 = sum(int(l["w_int"].numel()) for l in int_layers)
    alpha_a = [l["alpha_a"] for l in int_layers]
    print(f"[serve_sc] exported {len(int_layers)} SC layers, "
          f"{n_int8 / 1e3:.0f}k ternary weights, SI tables fused "
          f"(alpha_a {alpha_a})")

    correct = total = 0
    lat = []
    for i in range(eval_batches):
        b = DATASET.batch(30_000 + i, eval_batch, dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = serve_batch(params, int_layers, b["x"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        correct += int(torch.sum(torch.argmax(logits, -1) == b["y"]))
        total += eval_batch
    acc_int = correct / total
    print(f"[serve_sc] integer-datapath accuracy: {acc_int * 100:.2f}% "
          f"(QAT reference {acc_qat * 100:.2f}%)")
    steady = (f"steady {np.mean(lat[1:]):.1f} ms" if len(lat) > 1
              else "single batch")
    print(f"[serve_sc] batch-{eval_batch} latency on {dev}: first "
          f"{lat[0]:.1f} ms, {steady} (host clock)")
    drop = acc_qat - acc_int
    if gate:
        if not drop < 0.035:
            raise AssertionError(f"integer path diverged from QAT by "
                                 f"{drop:.3f}")
        print("[serve_sc] OK: silicon-equivalent datapath matches QAT "
              f"within {drop * 100:.2f}pp")
    return {"acc_qat": acc_qat, "acc_int": acc_int, "drop": drop,
            "alpha_a": alpha_a, "latency_ms": lat}


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
                    help="fewer QAT steps, serving batches, requests and "
                         "tokens, and no converged-accuracy gate (the "
                         "token-identity checks stay on)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    tnn = serve_tnn(steps=60 if args.smoke else 250,
                    eval_batches=1 if args.smoke else 4,
                    gate=not args.smoke, device=args.device)
    print("[serve_sc] -- part 2: ServeEngine (paged KV, sc_int) --")
    return {"tnn": tnn, **serve_lm_engine(args.smoke, args.device)}


if __name__ == "__main__":
    main()
