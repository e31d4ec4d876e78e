"""Deterministic synthetic language: a sparse, seeded first-order Markov
chain (port of ``repro.data.synthetic.SyntheticLM``).

Every batch is a pure function of (seed, step), so a restarted job
replays nothing.  The transition table is the reference's exactly
(``np.random.default_rng(seed)``), and so are the start states and the
choices of successor: they come from the same threefry keys
(``fold_in(key(seed), step)``, split in two) through the port's copy of
``jax.random`` (``repro_torch.prng``), so a batch equals the reference's
bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng

__all__ = ["SyntheticLM", "host_batch"]


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
        k0, k1 = prng.split(prng.fold_in(prng.key(self.seed), step))
        state = prng.randint(k0, (batch_size,), 0, self.vocab_size).numpy()
        choice = prng.randint(k1, (batch_size, self.seq_len + 1), 0,
                              self.branching).numpy()
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



def host_batch(ds: SyntheticLM, step: int, global_batch: int,
               host_id: int = 0, n_hosts: int = 1) -> dict:
    """Host ``host_id``'s rows of step ``step``'s global batch: its
    ``global_batch / n_hosts`` contiguous rows, so that a job restarted
    on another host count sees the same global data."""
    if global_batch % n_hosts:
        raise ValueError(f"global batch {global_batch} does not split "
                         f"over {n_hosts} hosts")
    per_host = global_batch // n_hosts
    full = ds.batch(step, global_batch)
    lo = host_id * per_host
    return {k: v[lo:lo + per_host] for k, v in full.items()}
