"""Continuous-batching serve engine: paged KV cache, batched decode.

Port of ``repro.serving.engine`` for serving on one card, or on each rank
of a ``torch.distributed`` mesh:

* **Paged KV.**  Attention KV lives in flat page pools shared by every
  request; a host-side free-list allocator (``paging.py``) hands out
  pages and each request keeps a page table.  Prefill writes the pages
  decode reads.
* **Chunked prefill.**  Admitted requests prefill as one padded
  ``(G, L)`` batch, chunk by chunk, straight into the pools
  (``paged_prefill``).  ``prefill_mode="exact"`` instead prefills each
  request alone at its exact length on the dense path (``prefill``) and
  scatters the result into its pages and state rows: the per-request
  oracle, which gives the chunked path's tokens on an fp cache (on a
  compressed one its prefill attends to float K / V: ROADMAP Queue 3
  item 11).
* **One batched decode step** per tick over every active slot
  (``paged_decode_step``), mixed progress handled by per-slot lengths
  and page tables.
* **Power-of-two buckets** for lanes, prompt length and table width, as
  in the reference.  Padded lanes point at the trash page 0 and the
  scratch row ``max_slots``; they cost work, never correctness.
* **Seeded sampling and logprobs** (``sampling.py``).  A request's
  ``SamplingParams`` ride its lane; a token at sequence index ``t`` is
  drawn from the stream ``(seed, t)`` alone: prefill draws at the prompt
  length, a decode step at ``lengths + 1``.  A batch with no sampled lane
  runs ``greedy_tokens`` and no sampler op, and a batch where no request
  asked for logprobs scores nothing.
* **Speculative decoding** (``spec_decode``).  A round drafts
  ``draft_len`` tokens by decode steps on the sc_int_approx datapath over
  the same params and cache (recurrent rows restored after), scores the
  window ``[last token, drafts]`` in one target step
  (``paged_verify_step``) with the same (seed, position) streams, and
  commits the target's tokens up to and including the first that differs
  from its draft: spec-on gives the tokens of spec-off.
* **Mesh serving** (``mesh``: ``launch.mesh.serving_rules``).  One
  process a rank, every rank running this same engine: the parameters
  and the paged cache are cut to the rank's block at construction
  (``models.param_specs`` / ``paged_cache_specs``), every model call runs
  under the rules, and the logits come back whole on every rank, so every
  rank picks and commits the same tokens.  All host bookkeeping (queue,
  slots, allocator, page tables) ignores the mesh.

Datapaths: ``"qat"`` serves the fake-quant forward, ``"sc_int"`` the
integer int8 x ternary -> int32 datapath, ``"sc_int_approx"`` the same
through the approximate BSN adder.  On the card the paged attention and
the BSN adder run the hand-written CUDA kernels; with ``device="cpu"``
their plain PyTorch versions.  :func:`sequential_generate` is the
one-request-at-a-time oracle the batched engine must reproduce: the
dense cache (``prefill`` + ``decode_step``) for ``kv_format="fp"``, as
the reference's, and a private paged cache for the compressed formats.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.kv_quant import check_kv_format, kv_quant
from ..device import resolve_device
from ..distributed.sharding import MeshRules, mesh_rules, shard_tree
from ..models import (decode_step, gather_state_rows, init_paged_cache,
                      paged_cache_specs, paged_decode_step, paged_prefill,
                      paged_verify_step, param_specs, prefill,
                      scatter_state_rows, select_state_snapshot)
from .config import DATAPATHS, EngineConfig
from .paging import (TRASH_PAGE, PageAllocator, PageTable, pad_pow2,
                     pages_needed)
from .sampling import (SamplingParams, greedy_tokens, pack_sampling,
                       sample_tokens, speculative_accept, token_logprobs)

__all__ = ["Request", "SamplingParams", "ServeEngine", "EngineConfig",
           "DATAPATHS", "sequential_generate"]


def _cfg_for_datapath(cfg: ModelConfig, datapath: str) -> ModelConfig:
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath must be one of {DATAPATHS}, "
                         f"got {datapath!r}")
    if datapath == "qat" or not cfg.quant.enabled:
        return cfg
    q = dataclasses.replace(cfg.quant, mode="sc_int",
                            int_approx=(datapath == "sc_int_approx"))
    return cfg.scaled(quant=q)


def _check_servable(cfg: ModelConfig) -> None:
    """The engine serves token prompts through a decode step.  An encoder
    has no decode step (the reference asserts as much) and a front-end
    arch's inputs are embeddings, which the reference's engine never
    passes; both are served through ``models.forward`` (and a causal
    front-end arch through ``prefill`` / ``decode_step``)."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: an encoder has no decode step; "
                         "serve it through models.forward")
    if cfg.frontend != "none":
        raise ValueError(f"{cfg.name}: its {cfg.frontend} inputs are not "
                         "token prompts; serve it through models.prefill "
                         "and decode_step")


def _check_params_device(params: dict, device: torch.device) -> None:
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(f"params live on {table.device}, the engine on "
                         f"{device}")


def _pick(logits: torch.Tensor, positions: torch.Tensor, samp: dict | None,
          vocab_size: int, do_sample: bool, lp_k: int):
    """The tokens of one step's logits rows, drawn at ``positions``, and
    their logprobs (None unless ``lp_k``): the sampler when ``do_sample``,
    else the plain argmax (``samp`` is needed only by those two)."""
    nxt = sample_tokens(logits, positions, samp, vocab_size) if do_sample \
        else greedy_tokens(logits, vocab_size)
    lp = token_logprobs(logits, nxt, samp, vocab_size, lp_k) if lp_k \
        else None
    return nxt, lp


def _modes(sps: list[SamplingParams]) -> tuple[bool, int]:
    """(whether any lane samples, the logprobs width): a batch with no
    sampled lane takes the argmax alone."""
    return any(not sp.greedy for sp in sps), _lp_bucket(sps)


def _lp_bucket(sps: list[SamplingParams]) -> int:
    """The top-list width a step computes: the batch's largest
    ``logprobs``, padded to a power of two; 0 when nobody asked."""
    m = max((sp.logprobs for sp in sps), default=0)
    return pad_pow2(m) if m else 0


def _lp_record(chosen, ids, lps, n: int) -> dict:
    """One token's logprobs, its top list cropped to the request's own
    ``logprobs=n``."""
    return {"logprob": float(chosen),
            "top": [(int(t), float(p)) for t, p in zip(ids[:n], lps[:n])]}


def _lp_host(lp) -> tuple | None:
    return None if lp is None else tuple(a.cpu().numpy() for a in lp)


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    generated: list[int] = field(default_factory=list)
    done: bool = False
    # one dict per generated token when sampling.logprobs > 0:
    # {"logprob": float, "top": [(token, logprob), ...]}, scored under the
    # distribution the token was drawn from
    logprobs: list[dict] = field(default_factory=list)
    # engine internals
    _table: PageTable | None = field(default=None, repr=False)
    _len: int = field(default=0, repr=False)      # tokens held in cache


class ServeEngine:
    """Continuous-batching engine over the paged cache.

    ``device`` defaults to ``cuda`` and must be where ``params`` live;
    ``device="cpu"`` runs the plain versions of the kernels.  With a
    ``mesh``, ``params`` are the whole parameters (the same on every
    rank) and the engine keeps only this rank's block of them.
    """

    def __init__(self, params: dict, cfg: ModelConfig, max_slots: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 num_pages: int | None = None, prefill_chunk: int = 64,
                 datapath: str = "qat", kv_format: str = "fp",
                 prefill_mode: str = "chunked", spec_decode: bool = False,
                 draft_len: int = 4, *,
                 mesh: MeshRules | None = None,
                 device: str | torch.device | None = None,
                 config: EngineConfig | None = None):
        if config is None:
            config = EngineConfig(
                max_slots=max_slots, max_len=max_len, page_size=page_size,
                num_pages=num_pages, prefill_chunk=prefill_chunk,
                datapath=datapath, kv_format=kv_format,
                prefill_mode=prefill_mode, spec_decode=spec_decode,
                draft_len=draft_len, mesh=mesh)
        config.validate()
        _check_servable(cfg)
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.config = config
        self.cfg = _cfg_for_datapath(cfg, config.datapath)
        self.datapath = config.datapath
        self.kv_format = config.kv_format
        self.prefill_mode = config.prefill_mode
        # the drafter: the same params and cache on sc_int_approx
        self.spec_decode, self.draft_len = config.spec_decode, \
            config.draft_len
        self.cfg_draft = _cfg_for_datapath(cfg, "sc_int_approx")
        self._spec_rounds = self._spec_draft_tokens = 0
        self._spec_accepted = self._spec_emitted = 0
        self._samp_key = self._samp_packed = None
        self.max_slots, self.max_len = config.max_slots, config.max_len
        self.page_size = config.page_size
        self.max_pages = pages_needed(config.max_len, config.page_size)
        num_pages = config.num_pages
        if num_pages is None:
            # full residency for every slot + the reserved trash page
            num_pages = config.max_slots * self.max_pages + 1
        self.allocator = PageAllocator(num_pages)
        self._rid = itertools.count()
        self.queue: list[Request] = []
        self.slots: list[Request | None] = [None] * config.max_slots
        cache = init_paged_cache(self.cfg, config.max_slots, num_pages,
                                 config.page_size, config.kv_format,
                                 device=self.device)
        self.rules = config.mesh
        if self.rules is not None:
            params = shard_tree(params, param_specs(self.cfg), self.rules)
            cache = shard_tree(cache, paged_cache_specs(
                self.cfg, config.kv_format), self.rules, logical=True)
        self.params, self.cache = params, cache
        self._chunk = pad_pow2(max(config.prefill_chunk, config.page_size))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A step's lane array on the engine's device.  To the card it goes
        through pinned host memory without blocking the host: the caching
        host allocator keeps the pinned block until the copy has run."""
        if self.device.type != "cuda":
            return torch.as_tensor(a, device=self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).pin_memory().to(
            self.device, non_blocking=True)

    @contextlib.contextmanager
    def _run(self):
        """The scope of every model call: no autograd, and the mesh's
        rules active."""
        with torch.inference_mode(), mesh_rules(self.rules):
            yield

    # -- submission -----------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: int | None = None,
               sampling: SamplingParams | None = None) -> int:
        if len(prompt) == 0:
            raise ValueError("empty prompt: need at least one token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if len(prompt) > self.max_len - 1:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds "
                             f"max_len={self.max_len}")
        need = pages_needed(len(prompt) + 1, self.page_size)
        if need > self.allocator.num_pages - 1:
            raise ValueError(f"prompt needs {need} pages but the pool "
                             f"holds {self.allocator.num_pages - 1}")
        r = Request(next(self._rid), list(prompt), max_new_tokens, eos_id,
                    sampling if sampling is not None else SamplingParams())
        self.queue.append(r)
        return r.rid

    def _free_slot(self) -> int | None:
        for i, s in enumerate(self.slots):
            if s is None:
                return i
        return None

    # -- admission ------------------------------------------------------
    def _admit(self) -> None:
        group: list[tuple[int, Request]] = []
        while self.queue:
            slot = self._free_slot()
            if slot is None:
                break
            req = self.queue[0]
            table = PageTable(self.page_size)
            # reserve prompt pages + the first decode write up front
            if not table.ensure(len(req.prompt) + 1, self.allocator):
                break                         # pool pressure: wait
            self.queue.pop(0)
            req._table, req._len = table, len(req.prompt)
            self.slots[slot] = req
            group.append((slot, req))
        if not group:
            return
        if self.prefill_mode == "chunked":
            self._prefill_group(group)
        else:
            for slot, r in group:
                self._prefill_one(slot, r)

    def _prefill_group(self, group: list[tuple[int, Request]]) -> None:
        """Batched chunked prefill of one padded (G, L) bucket: padded
        lanes are all-trash tables, zero lengths and the scratch row."""
        reqs = [r for _, r in group]
        plens = [len(r.prompt) for r in reqs]
        G = pad_pow2(len(reqs), hi=self.max_slots)
        L = pad_pow2(max(plens), lo=self.page_size)
        chunk = min(self._chunk, L)
        width = pad_pow2(max(L // self.page_size,
                             max(len(r._table.pages) for r in reqs)))
        tokens = np.zeros((G, L), np.int32)
        tables = np.full((G, width), TRASH_PAGE, np.int32)
        lens = np.zeros((G,), np.int32)
        slot_ids = np.full((G,), self.max_slots, np.int32)   # scratch row
        for g, (slot, r) in enumerate(group):
            tokens[g, :plens[g]] = r.prompt
            tables[g] = r._table.padded(width)
            lens[g] = plens[g]
            slot_ids[g] = slot
        sps = [r.sampling for r in reqs]
        do_sample, lp_k = _modes(sps)
        samp = pack_sampling(sps, pad_to=G, device=self.device) \
            if do_sample or lp_k else None
        lens = self._tensor(lens)
        with self._run():
            logits, self.cache = paged_prefill(
                self.params, self.cache, self._tensor(tokens),
                self._tensor(tables), lens, self.cfg,
                chunk=chunk, slot_ids=self._tensor(slot_ids))
            # the first generated token sits at sequence index prompt_len
            nxt, lp = _pick(logits, lens, samp, self.cfg.vocab_size,
                            do_sample, lp_k)
        nxt, lp = nxt.cpu().numpy(), _lp_host(lp)
        for g, r in enumerate(reqs):
            self._commit(r, int(nxt[g]), lp, g)

    def _prefill_one(self, slot: int, req: Request) -> None:
        """Exact-length dense prefill of one request, then its K / V and
        recurrent state scattered into its pages and its slot's rows
        (``prefill_mode="exact"``)."""
        toks = torch.tensor([req.prompt], dtype=torch.int32,
                            device=self.device)
        do_sample, lp_k = _modes([req.sampling])
        samp = pack_sampling([req.sampling], device=self.device) \
            if do_sample or lp_k else None
        pos = torch.tensor([len(req.prompt)], dtype=torch.int32,
                           device=self.device)
        with self._run():
            logits, cache_one = prefill(self.params, {"tokens": toks},
                                        self.cfg)
            tok, lp = _pick(logits[:, -1], pos, samp, self.cfg.vocab_size,
                            do_sample, lp_k)
            self._scatter_prefill(slot, req, cache_one)
        self._commit(req, int(tok[0]), _lp_host(lp), 0)

    def _scatter_prefill(self, slot: int, req: Request,
                         cache_one: dict) -> None:
        """Write a one-request, exact-length dense cache into the paged
        layout: each attention layer's K / V quantized per position
        (``kv_quant``, as the chunked path's quantize-on-scatter), padded
        to whole pages and written to the request's pages; each recurrent
        layer's state into row ``slot``."""
        plen = len(req.prompt)
        page = self.page_size
        npg = pages_needed(plen, page)
        phys = torch.as_tensor(req._table.pages[:npg], dtype=torch.long,
                               device=self.device)
        rows = []
        for entry, one in zip(self.cache["layers"], cache_one["layers"]):
            for name in ("k", "v"):
                if name not in one:
                    continue
                for part, val in kv_quant(one[name][0],
                                          self.kv_format).items():
                    pool = entry[f"{name}_pages" if part == "q"
                                 else f"{name}_{part}"]
                    pad = val.new_zeros((npg * page - plen, *val.shape[1:]))
                    pool[phys] = torch.cat([val, pad]).reshape(
                        npg, page, *val.shape[1:]).to(pool.dtype)
            rows.append({k: v for k, v in one.items() if k not in ("k", "v")})
        scatter_state_rows(self.cache, rows, torch.tensor(
            [slot], dtype=torch.int32, device=self.device))

    def _commit(self, r: Request, tok: int, lp: tuple | None, at) -> None:
        """Append one generated token and its logprobs record (entry
        ``at`` of the step's host logprobs: a lane, or a (lane, window
        row)), then apply the stop rule."""
        r.generated.append(tok)
        if lp is not None and r.sampling.logprobs > 0:
            r.logprobs.append(_lp_record(lp[0][at], lp[1][at], lp[2][at],
                                         r.sampling.logprobs))
        self._check_done(r)

    def _check_done(self, r: Request) -> None:
        """The stop rule, mirroring ``sequential_generate``'s loop: stop
        after the token that reaches eos, ``max_new_tokens`` or
        ``max_len - 1`` cached tokens."""
        hit_eos = r.eos_id is not None and r.generated \
            and r.generated[-1] == r.eos_id
        if hit_eos or len(r.generated) >= r.max_new_tokens \
                or r._len >= self.max_len - 1:
            r.done = True

    # -- stepping -------------------------------------------------------
    def _grow_or_preempt(self, active: list[int]) -> list[int]:
        """Make sure every active slot can take one more token; under pool
        pressure preempt the youngest request (free its pages, requeue it
        for re-prefill).  Greedy decode is deterministic and a sampled
        stream is keyed by (seed, position) alone, so a preempted request
        regenerates the same tokens."""
        for i in list(active):
            r = self.slots[i]
            if r is None or r.done:
                continue
            while not r._table.ensure(r._len + 1, self.allocator):
                victims = sorted((j for j in active if j != i),
                                 key=lambda j: self.slots[j].rid)
                if not victims:
                    r.done = True             # nothing to evict: truncate
                    break
                v = victims[-1]
                vr = self.slots[v]
                vr._table.release(self.allocator)
                vr._table, vr._len = None, 0
                vr.generated = []
                vr.logprobs = []
                self.queue.insert(0, vr)
                self.slots[v] = None
                active.remove(v)
        return [i for i in active
                if self.slots[i] is not None and not self.slots[i].done]

    def _sweep_done(self, done: list[Request]) -> None:
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                r._table.release(self.allocator)
                r._table = None
                done.append(r)
                self.slots[i] = None

    def _packed_sampling(self, active: list[int], Sb: int) -> dict:
        """The decode step's per-lane sampling tensors, packed and
        uploaded again only when the lane composition changes."""
        key = (tuple(self.slots[i].rid for i in active), Sb)
        if self._samp_key != key:
            self._samp_key = key
            self._samp_packed = pack_sampling(
                [self.slots[i].sampling for i in active], pad_to=Sb,
                device=self.device)
        return self._samp_packed

    def _step_batch(self, active: list[int]):
        """The (Sb, maxp) power-of-two bucketed lane tensors of one decode
        step (tokens, slot ids, page tables, lengths), the sampling
        tensors (None for a greedy batch without logprobs), whether any
        lane samples, and the logprobs width."""
        Sb = pad_pow2(len(active), hi=self.max_slots)
        maxp = pad_pow2(max(len(self.slots[i]._table.pages)
                            for i in active))
        tokens = np.zeros((Sb,), np.int32)
        slot_ids = np.full((Sb,), self.max_slots, np.int32)  # scratch
        tables = np.full((Sb, maxp), TRASH_PAGE, np.int32)
        lengths = np.zeros((Sb,), np.int32)
        for lane, i in enumerate(active):
            r = self.slots[i]
            tokens[lane] = r.generated[-1]
            slot_ids[lane] = i
            tables[lane] = r._table.padded(maxp)
            lengths[lane] = r._len
        do_sample, lp_k = _modes([self.slots[i].sampling
                                  for i in active])
        samp = self._packed_sampling(active, Sb) if do_sample or lp_k \
            else None
        return (*(self._tensor(a) for a in (tokens, slot_ids, tables,
                                            lengths)),
                samp, do_sample, lp_k)

    # -- speculative decoding -------------------------------------------
    def _ensure_spec_window(self, active: list[int]) -> bool:
        """Can every lane take ``draft_len + 1`` more positions, growing
        its pages without preemption?  If not, the step falls back to
        plain decode: speculation never evicts work that plain decode
        would keep (pages grown before a later lane failed stay with
        their table)."""
        k = self.draft_len
        if any(self.slots[i]._len + k > self.max_len - 1 for i in active):
            return False
        return all(self.slots[i]._table.ensure(
            self.slots[i]._len + k + 1, self.allocator) for i in active)

    def _draft(self, tokens, slot_ids, tables, lengths, samp,
               do_sample) -> torch.Tensor:
        """``draft_len`` decode steps on the drafter's datapath: (S, k)
        draft tokens, drawn from the target's streams.  Their K/V writes
        sit past the committed length until the verify window overwrites
        them; the recurrent rows are put back as they were."""
        rows0 = gather_state_rows(self.cache, slot_ids)
        tok, drafts = tokens, []
        for t in range(self.draft_len):
            logits, self.cache = paged_decode_step(
                self.params, self.cache, tok, slot_ids, tables, lengths + t,
                self.cfg_draft)
            tok = _pick(logits, lengths + 1 + t, samp, self.cfg.vocab_size,
                        do_sample, 0)[0]
            drafts.append(tok)
        scatter_state_rows(self.cache, rows0, slot_ids)
        return torch.stack(drafts, dim=1)

    def _verify(self, tokens, drafts, slot_ids, tables, lengths, samp,
                do_sample, lp_k):
        """One target step over the window ``[tokens, drafts]``: the
        target's token at every window row (row t drawn at ``lengths + 1
        + t``, the position plain decode would use), the accepted prefix
        length a lane, and the logprobs (None unless ``lp_k``).  Each lane
        commits the state snapshot of its last committed token."""
        win = torch.cat([tokens[:, None], drafts], dim=1)
        logits, self.cache, snaps = paged_verify_step(
            self.params, self.cache, win, slot_ids, tables, lengths,
            self.cfg)
        S, T, V = logits.shape
        pos = (lengths[:, None] + 1 + torch.arange(
            T, dtype=torch.int32, device=lengths.device)[None, :]).reshape(-1)
        sampf = None if samp is None else \
            {k: v.repeat_interleave(T) for k, v in samp.items()}
        tau, lp = _pick(logits.reshape(S * T, V), pos, sampf,
                        self.cfg.vocab_size, do_sample, lp_k)
        tau = tau.reshape(S, T)
        m = speculative_accept(drafts, tau[:, :T - 1])
        scatter_state_rows(self.cache, select_state_snapshot(snaps, m),
                           slot_ids)
        if lp is not None:
            lp = (lp[0].reshape(S, T), lp[1].reshape(S, T, lp_k),
                  lp[2].reshape(S, T, lp_k))
        return tau, m, lp

    def _spec_round(self, active: list[int]) -> None:
        """Draft, verify, and commit each lane's accepted drafts plus the
        target's token after them (always the target's own draws, so
        requests cannot tell this from plain decode)."""
        tokens, slot_ids, tables, lengths, samp, do_sample, lp_k = \
            self._step_batch(active)
        with self._run():
            drafts = self._draft(tokens, slot_ids, tables, lengths, samp,
                                 do_sample)
            tau, m, lp = self._verify(tokens, drafts, slot_ids, tables,
                                      lengths, samp, do_sample, lp_k)
        tau, m, lp = tau.cpu().numpy(), m.cpu().numpy(), _lp_host(lp)
        self._spec_rounds += 1
        self._spec_draft_tokens += self.draft_len * len(active)
        for lane, i in enumerate(active):
            r = self.slots[i]
            self._spec_accepted += int(m[lane])
            for j in range(int(m[lane]) + 1):
                r._len += 1
                self._spec_emitted += 1
                self._commit(r, int(tau[lane, j]), lp, (lane, j))
                if r.done:
                    break

    @property
    def spec_stats(self) -> dict:
        """Speculative decoding's counts since construction;
        ``acceptance_rate`` is accepted drafts over drafted tokens,
        ``tokens_per_round`` committed tokens a verify step."""
        return {
            "rounds": self._spec_rounds,
            "draft_tokens": self._spec_draft_tokens,
            "accepted_tokens": self._spec_accepted,
            "emitted_tokens": self._spec_emitted,
            "acceptance_rate": (self._spec_accepted
                                / max(self._spec_draft_tokens, 1)),
            "tokens_per_round": (self._spec_emitted
                                 / max(self._spec_rounds, 1)),
        }

    def step(self) -> list[Request]:
        """Admit, then ONE batched decode step (a speculative round when
        ``spec_decode`` is on and every lane has room for its window).
        Returns finished requests."""
        self._admit()
        done: list[Request] = []
        # requests finished at prefill free their pages before growth
        self._sweep_done(done)
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if self.spec_decode and active \
                and self._ensure_spec_window(active):
            self._spec_round(active)
        else:
            active = self._grow_or_preempt(active)
            if active:
                self._decode(active)
        self._sweep_done(done)          # decode-finished + truncated
        return done

    def _decode(self, active: list[int]) -> None:
        """One batched decode step; the token drawn sits at sequence
        index ``lengths + 1``."""
        tokens, slot_ids, tables, lengths, samp, do_sample, lp_k = \
            self._step_batch(active)
        with self._run():
            logits, self.cache = paged_decode_step(
                self.params, self.cache, tokens, slot_ids, tables, lengths,
                self.cfg)
            nxt, lp = _pick(logits, lengths + 1, samp, self.cfg.vocab_size,
                            do_sample, lp_k)
        nxt, lp = nxt.cpu().numpy(), _lp_host(lp)
        for lane, i in enumerate(active):
            r = self.slots[i]
            r._len += 1
            self._commit(r, int(nxt[lane]), lp, lane)

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        out: list[Request] = []
        for _ in range(max_steps):
            out += self.step()
            if not self.queue and all(s is None for s in self.slots):
                break
        return out


# ---------------------------------------------------------------------------
# sequential oracle
# ---------------------------------------------------------------------------

def _pad_prefill_cache(cache: dict, max_len: int) -> dict:
    """A dense prefill cache with its ``k`` / ``v`` zero-padded along time
    to ``max_len`` positions, the decode horizon."""
    def fit(name, a):
        if name in ("k", "v"):
            return torch.cat([a, a.new_zeros((a.shape[0],
                                              max_len - a.shape[1],
                                              *a.shape[2:]))], dim=1)
        return a
    return {"pos": cache["pos"],
            "layers": [{k: fit(k, v) for k, v in e.items()}
                       for e in cache["layers"]]}


def sequential_generate(params: dict, cfg: ModelConfig,
                        prompts: list[list[int]], max_new_tokens: int = 16,
                        eos_id: int | None = None, max_len: int = 256,
                        datapath: str = "qat", kv_format: str = "fp",
                        page_size: int = 8, *,
                        sampling: SamplingParams | list | None = None,
                        device: str | torch.device | None = None
                        ) -> list[list[int]]:
    """One request at a time: the oracle the batched engine's tokens are
    held against.  Stop conditions mirror ``ServeEngine``.  ``sampling``
    is one :class:`SamplingParams` for every prompt or a list of one a
    prompt (None: greedy); tokens are picked by the engine's sampler at
    batch 1 with the same (seed, position) streams, and greedy requests
    take the argmax alone.

    ``kv_format="fp"`` runs the dense cache, as the reference's oracle:
    ``prefill`` of the exact prompt, its K / V padded to ``max_len``, then
    one ``decode_step`` a token.  The compressed formats have no dense
    counterpart (their codes live in page pools), so they run
    :func:`_paged_sequential_generate`.
    """
    dev = resolve_device(device)
    _check_params_device(params, dev)
    check_kv_format(kv_format)
    cfg = _cfg_for_datapath(cfg, datapath)
    sps = sampling if isinstance(sampling, list) \
        else [sampling] * len(prompts)
    if len(sps) != len(prompts):
        raise ValueError(f"sampling list has {len(sps)} entries for "
                         f"{len(prompts)} prompts")
    sps = [sp if sp is not None else SamplingParams() for sp in sps]
    if kv_format != "fp":
        return _paged_sequential_generate(params, cfg, prompts,
                                          max_new_tokens, eos_id, max_len,
                                          kv_format, page_size, dev, sps)
    outs = []
    with torch.inference_mode():
        for prompt, sp in zip(prompts, sps):
            pick = _picker(sp, cfg.vocab_size, dev)
            toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
            logits, cache = prefill(params, {"tokens": toks}, cfg)
            cache = _pad_prefill_cache(cache, max_len)
            length = len(prompt)
            gen = [pick(logits[:, -1], length)]
            while (len(gen) < max_new_tokens
                   and length < max_len - 1
                   and (eos_id is None or gen[-1] != eos_id)):
                tok = torch.tensor([[gen[-1]]], dtype=torch.int32,
                                   device=dev)
                logits, cache = decode_step(params, cache, tok, cfg)
                gen.append(pick(logits[:, 0], length + 1))
                length += 1
            outs.append(gen)
    return outs


def _picker(sp: SamplingParams, vocab_size: int, device: torch.device):
    """The oracles' ``pick(logits (1, V), t)``: the token at sequence
    index ``t`` by the engine's rule at batch 1 (greedy requests skip the
    sampler, as the engine's all-greedy batches)."""
    samp = None if sp.greedy else pack_sampling([sp], device=device)

    def pick(logits: torch.Tensor, t: int) -> int:
        pos = torch.tensor([t], dtype=torch.int32, device=device)
        return int(_pick(logits, pos, samp, vocab_size, not sp.greedy,
                         0)[0][0])
    return pick


def _paged_sequential_generate(params: dict, cfg: ModelConfig,
                               prompts: list[list[int]], max_new_tokens: int,
                               eos_id: int | None, max_len: int,
                               kv_format: str, page_size: int,
                               device: torch.device,
                               sampling: list[SamplingParams] | None = None
                               ) -> list[list[int]]:
    """The one-request paged oracle (``cfg`` already on its datapath): a
    private single-slot cache with an identity page table (page ``j`` of
    the request at physical page ``j + 1``), one chunked
    ``paged_prefill`` over the whole prompt, then one
    ``paged_decode_step`` per token.  No allocator, bucketing, admission
    or batching, so the batched engine's tokens can be held against it in
    every format.  ``sampling``: one :class:`SamplingParams` a prompt
    (None: all greedy)."""
    dev = device
    sps = sampling or [SamplingParams()] * len(prompts)
    slot_ids = torch.zeros((1,), dtype=torch.int32, device=dev)
    outs = []
    with torch.inference_mode():
        for prompt, sp in zip(prompts, sps):
            pick = _picker(sp, cfg.vocab_size, dev)
            L = pad_pow2(max(len(prompt), page_size))
            maxp = max(pages_needed(max_len, page_size), L // page_size)
            cache = init_paged_cache(cfg, 1, maxp + 1, page_size, kv_format,
                                     device=dev)
            tables = torch.arange(1, maxp + 1, dtype=torch.int32,
                                  device=dev)[None, :]
            toks = np.zeros((1, L), np.int32)
            toks[0, :len(prompt)] = prompt
            plen = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
            logits, cache = paged_prefill(
                params, cache, torch.as_tensor(toks, device=dev), tables,
                plen, cfg, chunk=L, slot_ids=slot_ids)
            length = len(prompt)
            gen = [pick(logits, length)]
            while (len(gen) < max_new_tokens
                   and length < max_len - 1
                   and (eos_id is None or gen[-1] != eos_id)):
                tok = torch.tensor([gen[-1]], dtype=torch.int32, device=dev)
                lengths = torch.tensor([length], dtype=torch.int32,
                                       device=dev)
                logits, cache = paged_decode_step(
                    params, cache, tok, slot_ids, tables, lengths, cfg)
                gen.append(pick(logits, length + 1))
                length += 1
            outs.append(gen)
    return outs
