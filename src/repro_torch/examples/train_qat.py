"""SC-QAT train a reduced zoo LM on the synthetic Markov language, with
checkpoints and restart.

The training launcher's path as a library: the port's
``build_train_step`` (the flash kernel in every attention layer on the
card, LSQ fake quantization, AdamW) on a granite-family model cut to
4 layers of width 256 (2.6M parameters).

    PYTHONPATH=src python -m repro_torch.examples.train_qat [--steps 300]

Port of ``examples/train_qat.py``.  A rerun with the same
``--ckpt-dir`` resumes from its latest checkpoint.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_arch
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import init_params
from ..optim import warmup_cosine
from ..train import build_train_step, init_train_state, run_training
from ..tree import tree_leaves


def run(steps: int = 300, batch: int = 16, seq: int = 128,
        device: str | torch.device | None = None,
        ckpt_dir: str | None = None) -> tuple[float, float, float]:
    """Train; return (first logged loss, last logged loss, the language's
    entropy floor)."""
    dev = resolve_device(device)
    cfg = get_arch("granite-3-2b").scaled(
        n_layers=4, d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
        vocab_size=512, vocab_pad_multiple=64, dtype="float32")
    print(f"[train_qat] {cfg.name} reduced: {cfg.n_layers}L d={cfg.d_model} "
          f"quant={cfg.quant.mode} (W{cfg.quant.weight_bsl}-"
          f"A{cfg.quant.act_bsl}-R{cfg.quant.resid_bsl}) on {dev}")
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train_qat] {n / 1e6:.1f}M params")
    state = init_train_state(params, cfg)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq, seed=0)
    step_fn = build_train_step(
        cfg, lambda s: warmup_cosine(s, 2e-3, 20, steps))
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.mkdtemp(), "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    state, hist = run_training(
        step_fn, state, lambda s: ds.batch(s, batch), steps,
        ckpt_dir=ckpt_dir, ckpt_every=100,
        log_every=max(steps // 15, 1))
    floor = ds.entropy_floor()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train_qat] loss {first:.3f} -> {last:.3f} (entropy floor of "
          f"the synthetic language: {floor:.3f})")
    print(f"[train_qat] checkpoints in {ckpt_dir}: a rerun resumes from the "
          "latest step (kill -TERM to test preemption safety)")
    return first, last, floor


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    first, last, _ = run(args.steps, args.batch, args.seq, args.device,
                         args.ckpt_dir)
    if last >= first - 0.5:
        raise AssertionError("the SC-QAT LM failed to learn")
    print("[train_qat] OK")


if __name__ == "__main__":
    main()
