"""Deterministic synthetic language: a sparse, seeded first-order Markov
chain (port of ``repro.data.synthetic.SyntheticLM``).

Every batch is a pure function of (seed, step), so a restarted job
replays nothing.  The transition table is the reference's exactly
(``np.random.default_rng(seed)``).  The start states and the choices of
successor differ from the reference's: it draws them from ``jax.random``
threefry keys, which the port does not have until threefry is ported
(ROADMAP Queue 1 item 8), so the port draws them from a numpy generator
keyed by ``(seed, step)``.  The language is the same; the samples are
not.  Tests that hold the port against the reference feed both the same
numpy batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["SyntheticLM"]


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    seed: int = 0
    branching: int = 4          # out-degree of the Markov chain

    def _transitions(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, self.vocab_size,
                            (self.vocab_size, self.branching))

    def batch(self, step: int, batch_size: int) -> dict:
        """``tokens`` / ``targets`` (B, S) int32 and ``loss_mask`` (B, S)
        float32, on the CPU; a pure function of ``step``."""
        trans = self._transitions()
        rng = np.random.default_rng([self.seed, step])
        state = rng.integers(0, self.vocab_size, (batch_size,))
        choice = rng.integers(0, self.branching,
                              (batch_size, self.seq_len + 1))
        seq = np.empty((batch_size, self.seq_len + 1), np.int64)
        for t in range(self.seq_len + 1):
            state = trans[state, choice[:, t]]
            seq[:, t] = state
        seq = torch.from_numpy(seq.astype(np.int32))
        return {"tokens": seq[:, :-1].contiguous(),
                "targets": seq[:, 1:].contiguous(),
                "loss_mask": torch.ones((batch_size, self.seq_len),
                                        dtype=torch.float32)}

    def entropy_floor(self) -> float:
        """CE of the perfect model: log(branching) (uniform choice)."""
        return float(np.log(self.branching))

