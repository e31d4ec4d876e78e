"""Continuous-batching serve engine: paged KV cache, batched decode.

Port of ``repro.serving.engine`` for greedy serving on one card:

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

import dataclasses
import itertools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.kv_quant import check_kv_format, kv_quant
from ..device import resolve_device
from ..models import (decode_step, init_paged_cache, paged_decode_step,
                      paged_prefill, prefill, scatter_state_rows)
from .config import DATAPATHS, EngineConfig
from .paging import (TRASH_PAGE, PageAllocator, PageTable, pad_pow2,
                     pages_needed)
from .sampling import greedy_tokens

__all__ = ["Request", "ServeEngine", "EngineConfig", "DATAPATHS",
           "sequential_generate"]


def _cfg_for_datapath(cfg: ModelConfig, datapath: str) -> ModelConfig:
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath must be one of {DATAPATHS}, "
                         f"got {datapath!r}")
    if datapath == "qat" or not cfg.quant.enabled:
        return cfg
    q = dataclasses.replace(cfg.quant, mode="sc_int",
                            int_approx=(datapath == "sc_int_approx"))
    return cfg.scaled(quant=q)


def _check_params_device(params: dict, device: torch.device) -> None:
    table = params["embed"]["table"]
    if table.device.type != device.type:
        raise ValueError(f"params live on {table.device}, the engine on "
                         f"{device}")


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    generated: list[int] = field(default_factory=list)
    done: bool = False
    # engine internals
    _table: PageTable | None = field(default=None, repr=False)
    _len: int = field(default=0, repr=False)      # tokens held in cache


class ServeEngine:
    """Greedy continuous-batching engine over the paged cache.

    ``device`` defaults to ``cuda`` and must be where ``params`` live;
    ``device="cpu"`` runs the plain versions of the kernels.
    """

    def __init__(self, params: dict, cfg: ModelConfig, max_slots: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 num_pages: int | None = None, prefill_chunk: int = 64,
                 datapath: str = "qat", kv_format: str = "fp",
                 prefill_mode: str = "chunked", *,
                 device: str | torch.device | None = None,
                 config: EngineConfig | None = None):
        if config is None:
            config = EngineConfig(
                max_slots=max_slots, max_len=max_len, page_size=page_size,
                num_pages=num_pages, prefill_chunk=prefill_chunk,
                datapath=datapath, kv_format=kv_format,
                prefill_mode=prefill_mode)
        config.validate()
        self.device = resolve_device(device)
        _check_params_device(params, self.device)
        self.config = config
        self.cfg = _cfg_for_datapath(cfg, config.datapath)
        self.datapath = config.datapath
        self.kv_format = config.kv_format
        self.prefill_mode = config.prefill_mode
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
        self.params = params
        self.cache = init_paged_cache(self.cfg, config.max_slots, num_pages,
                                      config.page_size, config.kv_format,
                                      device=self.device)
        self._chunk = pad_pow2(max(config.prefill_chunk, config.page_size))

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    # -- submission -----------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               eos_id: int | None = None) -> int:
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
        r = Request(next(self._rid), list(prompt), max_new_tokens, eos_id)
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
        with torch.inference_mode():
            logits, self.cache = paged_prefill(
                self.params, self.cache, self._tensor(tokens),
                self._tensor(tables), self._tensor(lens), self.cfg,
                chunk=chunk, slot_ids=self._tensor(slot_ids))
            nxt = greedy_tokens(logits, self.cfg.vocab_size).cpu().numpy()
        for g, r in enumerate(reqs):
            r.generated.append(int(nxt[g]))
            self._check_done(r)

    def _prefill_one(self, slot: int, req: Request) -> None:
        """Exact-length dense prefill of one request, then its K / V and
        recurrent state scattered into its pages and its slot's rows
        (``prefill_mode="exact"``)."""
        toks = torch.tensor([req.prompt], dtype=torch.int32,
                            device=self.device)
        with torch.inference_mode():
            logits, cache_one = prefill(self.params, {"tokens": toks},
                                        self.cfg)
            tok = int(greedy_tokens(logits[:, -1], self.cfg.vocab_size)[0])
            self._scatter_prefill(slot, req, cache_one)
        req.generated.append(tok)
        self._check_done(req)

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
        for re-prefill).  Greedy decode is deterministic, so a preempted
        request regenerates the same tokens."""
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

    def _step_batch(self, active: list[int]):
        """The (Sb, maxp) power-of-two bucketed lane tensors of one decode
        step: tokens, slot ids, page tables, lengths."""
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
        return tuple(self._tensor(a)
                     for a in (tokens, slot_ids, tables, lengths))

    def step(self) -> list[Request]:
        """Admit, then ONE batched decode step.  Returns finished
        requests."""
        self._admit()
        done: list[Request] = []
        # requests finished at prefill free their pages before growth
        self._sweep_done(done)
        active = [i for i, r in enumerate(self.slots) if r is not None]
        active = self._grow_or_preempt(active)
        if active:
            tokens, slot_ids, tables, lengths = self._step_batch(active)
            with torch.inference_mode():
                logits, self.cache = paged_decode_step(
                    self.params, self.cache, tokens, slot_ids, tables,
                    lengths, self.cfg)
                nxt = greedy_tokens(logits,
                                    self.cfg.vocab_size).cpu().numpy()
            for lane, i in enumerate(active):
                r = self.slots[i]
                r.generated.append(int(nxt[lane]))
                r._len += 1
                self._check_done(r)
        self._sweep_done(done)          # decode-finished + truncated
        return done

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
                        device: str | torch.device | None = None
                        ) -> list[list[int]]:
    """One request at a time, greedy: the oracle the batched engine's
    tokens are held against.  Stop conditions mirror ``ServeEngine``.

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
    if kv_format != "fp":
        return _paged_sequential_generate(params, cfg, prompts,
                                          max_new_tokens, eos_id, max_len,
                                          kv_format, page_size, dev)
    outs = []
    with torch.inference_mode():
        for prompt in prompts:
            toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
            logits, cache = prefill(params, {"tokens": toks}, cfg)
            cache = _pad_prefill_cache(cache, max_len)
            length = len(prompt)
            gen = [int(greedy_tokens(logits[:, -1], cfg.vocab_size)[0])]
            while (len(gen) < max_new_tokens
                   and length < max_len - 1
                   and (eos_id is None or gen[-1] != eos_id)):
                tok = torch.tensor([[gen[-1]]], dtype=torch.int32,
                                   device=dev)
                logits, cache = decode_step(params, cache, tok, cfg)
                gen.append(int(greedy_tokens(logits[:, 0],
                                             cfg.vocab_size)[0]))
                length += 1
            outs.append(gen)
    return outs


def _paged_sequential_generate(params: dict, cfg: ModelConfig,
                               prompts: list[list[int]], max_new_tokens: int,
                               eos_id: int | None, max_len: int,
                               kv_format: str, page_size: int,
                               device: torch.device) -> list[list[int]]:
    """The one-request paged oracle (``cfg`` already on its datapath): a
    private single-slot cache with an identity page table (page ``j`` of
    the request at physical page ``j + 1``), one chunked
    ``paged_prefill`` over the whole prompt, then one
    ``paged_decode_step`` per token.  No allocator, bucketing, admission
    or batching, so the batched engine's tokens can be held against it in
    every format."""
    dev = device
    slot_ids = torch.zeros((1,), dtype=torch.int32, device=dev)
    outs = []
    with torch.inference_mode():
        for prompt in prompts:
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
            gen = [int(greedy_tokens(logits, cfg.vocab_size)[0])]
            while (len(gen) < max_new_tokens
                   and length < max_len - 1
                   and (eos_id is None or gen[-1] != eos_id)):
                tok = torch.tensor([gen[-1]], dtype=torch.int32, device=dev)
                lengths = torch.tensor([length], dtype=torch.int32,
                                       device=dev)
                logits, cache = paged_decode_step(
                    params, cache, tok, slot_ids, tables, lengths, cfg)
                gen.append(int(greedy_tokens(logits, cfg.vocab_size)[0]))
                length += 1
            outs.append(gen)
    return outs
