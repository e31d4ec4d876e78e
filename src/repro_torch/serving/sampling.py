"""Token selection: greedy argmax, seeded sampling, logprobs and the
speculative acceptance rule.

Port of ``repro.serving.sampling``.  Per-request :class:`SamplingParams`
are packed into flat per-lane tensors (:func:`pack_sampling`) and the
whole batch samples in one pass on the logits' device.  The reference's
contract holds unchanged:

* a request's stream is a pure function of ``(seed, position)``:
  ``key = fold_in(PRNGKey(seed), t)`` for the token at sequence index
  ``t`` (:func:`repro_torch.prng.lane_keys`), so batched == sequential,
  preemption replays the same tokens, and a draft and a target row at the
  same position share their Gumbel noise;
* filters apply to ``logits / temperature`` in the order top-k (ties at
  the k-th value all kept), top-p over the top-k-renormalized
  probabilities (the shortest descending prefix whose preceding mass is
  ``< top_p``, widened to every token tied with the smallest kept
  probability), min-p (``prob >= min_p * max_prob``); then the draw is
  ``argmax(masked + gumbel)``;
* ``temperature == 0`` is the exact argmax of the cropped float32 row;
* logprobs score a token under the distribution it was drawn from: raw
  ``log_softmax`` for greedy lanes, the filtered one for sampled lanes.

A row's result never depends on the other rows in the call, so a lane
draws the same token at batch 1 (the sequential oracle) as at batch 4
(the engine) on the card too.  Sorts and maxima are exact in any order;
the softmax sums and the top-p prefix sums, whose order a reduction or
scan kernel may choose by the row count, run here as elementwise adds in
one fixed order (``models.common.sum_fixed`` and :func:`_cumsum_fixed`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import prng
from ..models.common import sum_fixed

__all__ = ["SamplingParams", "pack_sampling", "filter_logits",
           "sample_tokens", "greedy_tokens", "lane_keys", "token_logprobs",
           "speculative_accept"]

_TINY = float(torch.finfo(torch.float32).tiny)


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling controls.

    ``temperature == 0`` is greedy argmax (the default).  ``top_k == 0``,
    ``top_p == 1`` and ``min_p == 0`` turn their filters off.  ``seed``
    names the draw stream; only its low 32 bits count.  ``logprobs = N``
    returns, for every generated token, its log-probability and the top-N
    (token, logprob) pairs; 0 turns logprobs off."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    seed: int = 0
    logprobs: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.logprobs < 0:
            raise ValueError(f"logprobs must be >= 0 (0 = off), "
                             f"got {self.logprobs}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), "
                             f"got {self.top_k}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if not 0 <= self.min_p <= 1:
            raise ValueError(f"min_p must be in [0, 1], got {self.min_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def pack_sampling(sps: list[SamplingParams], pad_to: int | None = None,
                  device: str | torch.device = "cpu"
                  ) -> dict[str, torch.Tensor]:
    """Per-lane tensors on ``device``: ``seed`` (int32, the low 32 bits
    as the reference packs them), ``temperature``, ``top_k``, ``top_p``,
    ``min_p``.  Padded lanes are greedy."""
    n = len(sps) if pad_to is None else pad_to
    if n < len(sps):
        raise ValueError(f"pad_to={n} is below the {len(sps)} lanes")
    out = {"seed": np.zeros((n,), np.int32),
           "temperature": np.zeros((n,), np.float32),
           "top_k": np.zeros((n,), np.int32),
           "top_p": np.ones((n,), np.float32),
           "min_p": np.zeros((n,), np.float32)}
    for i, sp in enumerate(sps):
        out["seed"][i] = np.uint32(sp.seed & 0xFFFFFFFF).astype(np.int32)
        out["temperature"][i] = sp.temperature
        out["top_k"][i] = sp.top_k
        out["top_p"][i] = sp.top_p
        out["min_p"][i] = sp.min_p
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def lane_keys(seeds: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The (seed, position) stream: one ``(2,)`` key a lane, ``(S, 2)``."""
    return prng.lane_keys(seeds, positions)


def _cumsum_fixed(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis by doubling (step ``d``
    adds each entry's value ``d`` places back): elementwise adds in an
    order fixed by the axis length alone."""
    d = 1
    while d < x.shape[-1]:
        x = torch.cat([x[..., :d], x[..., d:] + x[..., :-d]], dim=-1)
        d *= 2
    return x


def _softmax_fixed(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: ``exp(x - max)`` over its
    sum, the sum taken by :func:`~repro_torch.models.common.sum_fixed`."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / sum_fixed(e, -1)[..., None]


def _log_softmax_fixed(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax``: ``x - max - log(sum(exp(x - max)))``."""
    shifted = x - torch.amax(x, dim=-1, keepdim=True)
    return shifted - torch.log(sum_fixed(torch.exp(shifted), -1))[..., None]


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  min_p: torch.Tensor) -> torch.Tensor:
    """Temperature-scale then mask ``(S, V)`` float32 logit rows with the
    per-lane ``(S,)`` controls: ``-inf`` outside the kept set (see the
    module docstring for the order and the tie rules)."""
    V = logits.shape[-1]
    neg_inf = torch.tensor(-torch.inf, device=logits.device)
    scaled = logits / torch.clamp_min(temperature, 1e-8)[:, None]

    # top-k: threshold at the k-th largest value, keep boundary ties
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, V), 1, V)
    kth = torch.gather(sorted_desc, 1, (k_eff - 1).long()[:, None])
    keep = scaled >= kth

    # top-p over the top-k-renormalized distribution, widened to every
    # token tied with the smallest kept probability
    probs = _softmax_fixed(torch.where(keep, scaled, neg_inf))
    sp = torch.sort(probs, dim=-1, descending=True).values
    mass_before = _cumsum_fixed(sp) - sp
    n_keep = torch.sum(mass_before < top_p[:, None], dim=-1)   # >= 1
    p_thr = torch.gather(sp, 1, (n_keep - 1)[:, None])
    keep = keep & (probs >= p_thr)

    # min-p relative to the row's best token
    pmax = torch.amax(probs, dim=-1, keepdim=True)
    keep = keep & (probs >= min_p[:, None] * pmax)
    return torch.where(keep, scaled, neg_inf)


def greedy_tokens(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Argmax over the real vocabulary (the padded slots are cropped
    first) in float32; ties go to the lowest id.  (S, V_padded) ->
    (S,) int32.  An all-greedy batch runs this and no sampler op."""
    lf = logits[:, :vocab_size].to(torch.float32)
    return torch.argmax(lf, dim=-1).to(torch.int32)


def sample_tokens(logits: torch.Tensor, positions: torch.Tensor,
                  samp: dict[str, torch.Tensor],
                  vocab_size: int) -> torch.Tensor:
    """One token a lane: ``(S, V_padded)`` logits, ``(S,)`` positions (the
    0-based sequence index of the token drawn), ``samp`` from
    :func:`pack_sampling`.  Lanes with ``temperature == 0`` take the exact
    argmax; the others ``argmax(filter_logits + gumbel)`` with the
    Gumbel noise ``-log(-log(max(u, tiny)))`` of the lane's stream.
    Returns (S,) int32."""
    lf = logits[:, :vocab_size].to(torch.float32)
    greedy = torch.argmax(lf, dim=-1)
    masked = filter_logits(lf, samp["temperature"], samp["top_k"],
                           samp["top_p"], samp["min_p"])
    u = prng.uniform(lane_keys(samp["seed"], positions), vocab_size)
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, _TINY)))
    drawn = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(samp["temperature"] > 0, drawn,
                       greedy).to(torch.int32)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor,
                   samp: dict[str, torch.Tensor], vocab_size: int, k: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score the drawn ``tokens`` (S,) under the distribution each was
    drawn from; ``k`` is the top-list width.  Returns (chosen (S,), top
    ids (S, k) int32, top logprobs (S, k)), float32.  Filtered-out tokens
    score ``-inf``; the top list breaks ties to the lower id, as
    ``jax.lax.top_k`` (a stable descending sort)."""
    lf = logits[:, :vocab_size].to(torch.float32)
    raw_lp = _log_softmax_fixed(lf)
    masked = filter_logits(lf, samp["temperature"], samp["top_k"],
                           samp["top_p"], samp["min_p"])
    lp = torch.where((samp["temperature"] > 0)[:, None],
                     _log_softmax_fixed(masked), raw_lp)
    chosen = torch.gather(lp, 1, tokens.long()[:, None])[:, 0]
    top_lp, top_ids = torch.sort(lp, dim=-1, descending=True, stable=True)
    return chosen, top_ids[:, :k].to(torch.int32), top_lp[:, :k]


def speculative_accept(draft: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """The accepted prefix's length a lane: the number of leading
    positions where the ``(S, k)`` draft and target tokens agree.
    Returns (S,) int32."""
    match = (draft == target).to(torch.int32)
    return torch.sum(torch.cumprod(match, dim=-1), dim=-1,
                     dtype=torch.int32)
