"""Sweeps of the kernels' launch knobs on the card.

Port of ``repro.kernels.autotune``: small deterministic sweeps that time
each candidate of a knob on the caller's tensors and report the fastest.
Candidates are vetted before they run: each one's launch plans
(``kernels/plan.py``) go through the kernel audit
(``repro_torch.analysis.kernel_audit``), and a candidate the audit
refuses (shared memory above a block's, a grid past CUDA's limits,
registers, bounds) is pruned and never launched, as the reference prunes
by ``estimate_vmem``.  Times are device times on CUDA events; there is
no CPU fallback.

The knobs swept are those that are launch arguments today: the paged
prefill's ``block_q`` (rows of a block) and ``DP4A_MAX_ROWS`` (the rows up
to which the ternary matmul runs its dp4a kernel).  The compiled split
sizes (``SPLIT_TOKENS``, ``PF_SPLIT_KEYS``) are not launch arguments and
are not swept (ROADMAP).  A sweep reports; it changes no default.
"""

from __future__ import annotations

import torch

from .plan import LaunchPlan, paged_prefill_plan, ternary_matmul_plan

__all__ = ["time_callable", "sweep", "sweep_block_q", "sweep_dp4a_rows"]

# host microseconds a launch may take (its Python wrapper and ctypes call)
_HOST_US = 200.0


def time_callable(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` calls: CUDA
    events around the run, after ``warmup`` calls.  The stream first
    sleeps ``_HOST_US`` microseconds a call (at 2 GHz) so that the host
    enqueues every call before the first event runs: the events then
    time the card, not the host's launch work (a decode-sized kernel
    takes a few microseconds, its Python wrapper tens)."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_callable times the card, and there is none")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(iters * _HOST_US * 2e3))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _audit(plans: list[LaunchPlan], kernels: dict | None) -> list[str]:
    from ..analysis.kernel_audit import run_plan_audits
    return [v.message for p in plans
            for r in run_plan_audits(p, p.name, kernels)
            for v in r.violations]


def sweep(build, candidates: dict, *, iters: int = 20, plan_for=None,
          kernels: dict | None = None) -> dict:
    """Time ``build(**kwargs)()`` for each candidate ``{label: kwargs}``
    and pick the fastest.  ``plan_for(**kwargs)`` (optional) gives a
    candidate's launch plans; a candidate whose plans fail the kernel
    audit (``kernels``: the parsed ptxas log, default the committed
    sample) is pruned, with the audit's messages, and never runs.
    Returns ``{"winner", "ms": {label: ms}, "pruned": {label:
    [messages]}}``."""
    pruned, ms = {}, {}
    for label, kw in candidates.items():
        if plan_for is not None:
            plans = plan_for(**kw)
            plans = plans if isinstance(plans, list) else [plans]
            bad = _audit(plans, kernels)
            if bad:
                pruned[label] = bad
                continue
        ms[label] = time_callable(build(**kw), iters=iters)
    winner = min(ms, key=ms.get) if ms else None
    return {"winner": winner, "ms": ms, "pruned": pruned}


def sweep_block_q(q, k_pages, v_pages, page_tables, *, start: int,
                  kv_format: str = "fp", kv_aux: dict | None = None,
                  candidates=(8, 16, 32, 64, 128, 256), iters: int = 20,
                  kernels: dict | None = None) -> dict:
    """The paged prefill's ``block_q`` on one chunk (the wrapper's default
    is 32)."""
    from .paged_attention import paged_attn_prefill_cuda
    from .plan import KV_BF16, KV_F32, KV_INT8, KV_SC, Q_BF16, Q_F32
    aux = kv_aux or {}
    G, C, Hkv, Gq, D = q.shape
    kind = {"int8": KV_INT8, "sc": KV_SC}.get(
        kv_format, KV_F32 if k_pages.dtype == torch.float32 else KV_BF16)
    qd = Q_F32 if q.dtype == torch.float32 else Q_BF16

    def build(block_q):
        return lambda: paged_attn_prefill_cuda(
            q, k_pages, v_pages, page_tables, start=start, block_q=block_q,
            kv_format=kv_format, **aux)

    def plan_for(block_q):
        return paged_prefill_plan(
            G=G, C=C, Hkv=Hkv, Gq=Gq, D=D, page=k_pages.shape[1],
            width=page_tables.shape[1], start=start,
            num_pages=k_pages.shape[0], kv_kind=kind,
            block_q=max(1, min(block_q, C)), q_dtype=qd)
    return sweep(build, {f"block_q {b}": dict(block_q=b)
                         for b in candidates},
                 iters=iters, plan_for=plan_for, kernels=kernels)


def sweep_dp4a_rows(x_q, w_int, *, candidates=(4, 8, 16, 32, 64),
                    iters: int = 20, kernels: dict | None = None,
                    sms: int = 132) -> dict:
    """``DP4A_MAX_ROWS`` for a product of ``x_q (M, K)`` rows: at a
    threshold ``t >= M`` the rows run the dp4a kernel, in launches of at
    most 16 rows (the compiled threshold is 16, so a threshold above it
    is emulated one 16-row launch at a time); at ``t < M`` they run the
    tensor-core kernel, x padded to 17 rows where M <= 16.  Every
    candidate computes the same sums."""
    import torch.nn.functional as F

    from .ternary_matmul import DP4A_MAX_ROWS, ternary_matmul_cuda
    m, k = x_q.shape
    n = w_int.shape[1]

    def blocks(t):
        if m <= t:
            return [(i, min(i + DP4A_MAX_ROWS, m))
                    for i in range(0, m, DP4A_MAX_ROWS)]
        return None

    def build(t):
        rows = blocks(t)
        if rows is not None:
            parts = [x_q[a:b].contiguous() for a, b in rows]
            return lambda: [ternary_matmul_cuda(p, w_int) for p in parts]
        xp = F.pad(x_q, (0, 0, 0, max(0, DP4A_MAX_ROWS + 1 - m)))
        return lambda: ternary_matmul_cuda(xp.contiguous(), w_int)

    def plan_for(t):
        rows = blocks(t)
        if rows is not None:
            return [ternary_matmul_plan(batch=1, M=b - a, N=n, K=k, sms=sms)
                    for a, b in rows]
        return [ternary_matmul_plan(batch=1, M=max(m, DP4A_MAX_ROWS + 1),
                                    N=n, K=k, sms=sms)]
    return sweep(build, {f"DP4A_MAX_ROWS {t}": dict(t=t)
                         for t in candidates},
                 iters=iters, plan_for=plan_for, kernels=kernels)
