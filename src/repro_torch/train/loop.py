"""Fault-tolerant training loop (port of ``repro.train.loop``).

* resume from the latest checkpoint on start;
* periodic asynchronous checkpoints, and one on SIGTERM (preemption);
* a heartbeat every ``log_every`` steps with the wall time per step;
* stateless data (``batch_fn(step)``), so a resumed run replays nothing.
"""

from __future__ import annotations

import signal
import time
from typing import Callable

from ..checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                          wait_for_saves)

__all__ = ["run_training"]


def run_training(train_step: Callable, state, batch_fn: Callable,
                 n_steps: int, ckpt_dir: str | None = None,
                 ckpt_every: int = 100, log_every: int = 10,
                 log_fn: Callable = print):
    """Run steps up to ``n_steps`` with checkpoint / restart; returns the
    final state and the logged metrics (floats, with ``sec_per_step``)."""
    start = 0
    if ckpt_dir is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore_checkpoint(ckpt_dir, last, state)
            start = int(last)
            log_fn(f"[loop] resumed from checkpoint step {start}")

    stop = {"flag": False}

    def _on_term(signum, frame):
        stop["flag"] = True

    prev = signal.signal(signal.SIGTERM, _on_term)
    history = []
    t_last = time.monotonic()
    try:
        for step in range(start, n_steps):
            state, metrics = train_step(state, batch_fn(step))
            if (step + 1) % log_every == 0 or step == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                now = time.monotonic()
                m["sec_per_step"] = (now - t_last) / log_every
                t_last = now
                history.append({"step": step + 1, **m})
                log_fn(f"[loop] step {step + 1} " +
                       " ".join(f"{k}={v:.4g}" for k, v in m.items()))
            if ckpt_dir is not None and ((step + 1) % ckpt_every == 0
                                         or stop["flag"]
                                         or step == n_steps - 1):
                save_checkpoint(ckpt_dir, step + 1, state)
            if stop["flag"]:
                log_fn(f"[loop] SIGTERM: checkpointed at {step + 1}, "
                       f"exiting")
                break
    finally:
        wait_for_saves()
        signal.signal(signal.SIGTERM, prev)
    return state, history
