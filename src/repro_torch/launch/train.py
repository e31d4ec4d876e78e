"""Training launcher: the end-to-end entry point of the port's training path.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduce 8 --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/run1

Port of ``repro.launch.train``.  It trains on the CUDA card unless
``--device cpu`` is given; ``--reduce`` divides widths and depth
(``--reduce 1`` is the full configuration).  The step runs the flash
kernel in every attention layer and the recurrent archs' training scans
(``--arch rwkv6-7b`` / ``jamba-1.5-large-398b``), AdamW in the arch's
state dtype, asynchronous checkpoints, SIGTERM-safe preemption and
stateless data resume.
"""

from __future__ import annotations

import argparse

import torch

from ..configs import get_arch
from ..configs.base import ModelConfig, list_archs
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import init_params
from ..optim import warmup_cosine
from ..train import build_train_step, init_train_state, run_training
from ..tree import tree_leaves

__all__ = ["reduced_config", "main"]


def reduced_config(cfg: ModelConfig, factor: int, seq: int) -> ModelConfig:
    """The reference's reduction: widths and depth divided by ``factor``,
    vocabulary cut to 2048, float32, at most 8 experts of which 2 per
    token, in groups of 64 tokens."""
    if factor <= 1:
        return cfg
    period = len(cfg.period)
    layers = max(period, (cfg.n_layers // factor) // period * period)
    d_model = max(64, cfg.d_model // factor // 64 * 64)
    heads = max(4, cfg.n_heads // factor)
    kv = max(2, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return cfg.scaled(
        n_layers=layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        d_ff=max(128, cfg.d_ff // factor // 32 * 32),
        vocab_size=min(cfg.vocab_size, 2048),
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        n_experts_per_tok=min(cfg.n_experts_per_tok, 2)
        if cfg.n_experts else 0,
        vocab_pad_multiple=64, dtype="float32",
        attn_q_chunk=min(cfg.attn_q_chunk, max(seq // 2, 16)),
        moe_group_size=64, d_head=64)


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list_archs(), required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--reduce", type=int, default=8,
                    help="width/depth reduction factor (1 = full config)")
    ap.add_argument("--quant", choices=["none", "sc_qat"], default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_config(get_arch(args.arch), args.reduce, args.seq)
    if args.quant:
        cfg = cfg.with_quant(args.quant) if args.quant != "none" \
            else cfg.scaled(quant=cfg.quant.with_mode("none"))
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"quant={cfg.quant.mode} on {dev}")

    gen = torch.Generator(dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {n / 1e6:.1f}M parameters")
    state = init_train_state(params, cfg)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=args.seq,
                     seed=args.seed)
    step_fn = build_train_step(
        cfg, lambda s: warmup_cosine(s, args.lr, 10, args.steps),
        grad_accum=args.grad_accum)
    state, history = run_training(
        step_fn, state, lambda step: ds.batch(step, args.batch), args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        log_every=max(args.steps // 20, 1))
    if history:
        print(f"[train] done: loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f}")
    return state, history


if __name__ == "__main__":
    main()
