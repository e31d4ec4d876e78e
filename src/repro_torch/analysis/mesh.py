"""The ``sharding`` contract on a (1, 2) gloo mesh of CPU ranks.

:func:`run_sharding_cells` starts one process a rank (``torch.distributed``
over gloo on ``localhost``), builds the serving mesh in each, and runs
every cell there: an engine under the mesh, its pool leaves' spec tags
recorded after construction, a prefill chunk, then one decode step whose
gathers are counted (``contracts.audit_sharding``).  A cell passes when
it passes on every rank.  ``inject="gather-pool"`` makes every attention
layer gather its whole K pool each decode step (the bug class the
budget exists for): the injection test of the pass.
"""

from __future__ import annotations

import datetime
import socket
import traceback

import torch

from .contracts import (PassResult, audit_sharding, count_gathers,
                        pool_leaves, results_to_json)

__all__ = ["sharding_cell", "run_sharding_cells", "free_port"]

PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def sharding_cell(cfg, datapath: str, kv_format: str, rules, *,
                  inject: str | None = None) -> PassResult:
    """One engine under ``rules``: spec tags after construction, a
    prefill, one decode step with its gathers counted."""
    from ..distributed.sharding import MODEL, gather, spec_of
    from ..models import attention, init_params
    from ..serving import ServeEngine
    from ..serving.paging import pad_pow2
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(params, cfg, max_slots=4, max_len=64, num_pages=256,
                      datapath=datapath, kv_format=kv_format, device="cpu",
                      mesh=rules)
    tags = {k: spec_of(v) for k, v in pool_leaves(eng.cache).items()}
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=4)
    eng._admit()
    inner = attention.attn_decode_paged
    if inject == "gather-pool":
        def leaky(p, x, cfg_, pools, lengths):
            gather(pools["k_pages"], MODEL, 2)
            return inner(p, x, cfg_, pools, lengths)
        attention.attn_decode_paged = leaky
    gathers: list = []
    try:
        with count_gathers(gathers):
            eng.step()
    finally:
        attention.attn_decode_paged = inner
    lanes = pad_pow2(len(PROMPTS), hi=eng.max_slots)
    label = f"{cfg.name}/{datapath}/{kv_format}/mesh1x2"
    return audit_sharding(label + (f"/{inject}" if inject else ""), eng,
                          tags, gathers, lanes=lanes)


def _rank(rank: int, world: int, port: int, cells: list, queue) -> None:
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        from ..launch.mesh import make_serving_mesh, serving_rules
        rules = serving_rules(make_serving_mesh(model_parallel=world,
                                                backend="gloo"))
        out = {}
        for key, cfg, dp, kf, inject in cells:
            out[key] = results_to_json([sharding_cell(cfg, dp, kf, rules,
                                                      inject=inject)])
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def run_sharding_cells(cells: list, world: int = 2,
                       timeout: float = 300) -> dict:
    """{key: results JSON} of ``cells`` ((key, cfg, datapath, kv_format,
    inject) each) on a (1, ``world``) gloo mesh; a cell is ok when it is
    ok on every rank (each rank's passes are kept)."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_rank, daemon=True,
                         args=(r, world, port, cells, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    per_rank = {}
    try:
        for _ in procs:
            rank, res, err = queue.get(timeout=timeout)
            if err is not None:
                raise RuntimeError(f"mesh rank {rank} failed:\n{err}")
            per_rank[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    out = {}
    for key, *_ in cells:
        ranks = [per_rank[r][key] for r in range(world)]
        out[key] = {"ok": all(c["ok"] for c in ranks),
                    "violation_count": sum(c["violation_count"]
                                           for c in ranks),
                    "passes": [p for c in ranks for p in c["passes"]]}
    return out
