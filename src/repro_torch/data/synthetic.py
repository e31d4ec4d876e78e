"""Deterministic synthetic datasets (port of ``repro.data.synthetic``).

``SyntheticLM`` is a sparse, seeded first-order Markov chain;
``SyntheticClassification`` labels Gaussian inputs with a fixed random
teacher MLP, the stand-in for MNIST in the paper-mechanism experiments.

Every batch is a pure function of (seed, step), so a restarted job
replays nothing.  The tables (the Markov transitions, the teacher) are
the reference's exactly (``np.random.default_rng(seed)``), and the draws
come from the same threefry keys through the port's copy of
``jax.random`` (``repro_torch.prng``): a ``SyntheticLM`` batch equals the
reference's bit for bit, and a ``SyntheticClassification`` input is
within an ulp or so of it (``prng.normal``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..device import resolve_device

__all__ = ["SyntheticLM", "SyntheticClassification", "host_batch"]


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


@dataclass(frozen=True)
class SyntheticClassification:
    """Labels from a fixed random teacher MLP over Gaussian inputs.

    A prototype-matching task is linearly separable, and any quantization
    still scores ~100% on it; a nonlinear teacher makes representation
    capacity matter, so the paper's activation-quantization cliff (Table
    III) shows.  ``margin`` is kept as the reference keeps it: the filter
    takes the more confident half of an oversampled batch, whatever it is.
    """
    n_classes: int = 10
    dim: int = 784
    seed: int = 0
    teacher_hidden: int = 48
    margin: float = 0.25

    def _teacher(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        w1 = rng.normal(0, 1 / np.sqrt(self.dim),
                        (self.dim, self.teacher_hidden)).astype(np.float32)
        w2 = rng.normal(0, 1 / np.sqrt(self.teacher_hidden),
                        (self.teacher_hidden, self.n_classes)
                        ).astype(np.float32)
        return w1, w2

    def batch(self, step: int, batch_size: int,
              device: str | torch.device | None = None) -> dict:
        """``x`` (B, dim) float32 and ``y`` (B,) int32, drawn on the card
        unless ``device`` says otherwise: 2B normal rows, of which the B
        with the widest top-2 margin of the teacher's logits are kept, in
        descending order of margin (a stable sort, as ``jnp.argsort``)."""
        dev = resolve_device(device)
        w1, w2 = (torch.from_numpy(a).to(dev) for a in self._teacher())
        k = prng.fold_in(prng.key(self.seed + 1).to(dev), step)
        x = prng.normal(k, (2 * batch_size, self.dim))
        logits = torch.tanh(x @ w1) @ w2
        top2 = torch.topk(logits, 2, dim=-1).values
        conf = top2[:, 0] - top2[:, 1]
        order = torch.sort(-conf, stable=True).indices[:batch_size]
        y = torch.argmax(logits[order], dim=-1)     # first index on ties
        return {"x": x[order], "y": y.to(torch.int32)}


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
