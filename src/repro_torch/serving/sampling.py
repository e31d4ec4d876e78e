"""Token selection.  Port of ``repro.serving.sampling.greedy_tokens``;
seeded sampling and logprobs are later work."""

from __future__ import annotations

import torch

__all__ = ["greedy_tokens"]


def greedy_tokens(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Argmax over the real vocabulary (the padded slots are cropped
    first) in float32; ties go to the lowest id.  (S, V_padded) ->
    (S,) int32."""
    lf = logits[:, :vocab_size].to(torch.float32)
    return torch.argmax(lf, dim=-1).to(torch.int32)
