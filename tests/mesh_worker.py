"""Both sides of the port's CPU mesh tests, without JAX.

A test builds *cases* (a config, the reference's parameters as numpy,
engine and request settings), :class:`Job` starts one process a rank
(``torch.distributed`` over gloo on ``localhost``), every rank builds
the serving mesh and runs every case through ``ServeEngine(mesh=...)``,
and the parent gets each rank's results back.  :func:`serve` is the run
itself; the parent calls it with ``rules=None`` for the mesh-off run.
This module imports torch, numpy and ``repro_torch`` only, so a rank
never loads JAX or the reference; each rank runs one torch thread (the
port tests' one-thread rule) and every case at once, so a file pays the
ranks' start-up once.
"""

from __future__ import annotations

import datetime
import socket
import traceback

import numpy as np
import torch

PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
ENGINE = dict(max_slots=2, max_len=32, page_size=8)
QAT_ATOL = 5e-5         # the qat logits tolerance of the port's tests


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def serve(case: dict, rules=None) -> dict:
    """Run one case on the port's engine (under ``rules``, or mesh-off):
    the requests' tokens and logprobs, the host trace of every step (the
    slots' page tables and the allocator's free count), the shapes of
    the engine's parameter and cache leaves and, with ``case["sums"]``,
    every sc_int q-domain sum of the run in call order."""
    from repro_torch.core import sc_layers
    from repro_torch.serving import SamplingParams, ServeEngine
    from repro_torch.tree import tree_map, tree_paths
    from repro_torch.weights import from_jax
    cfg, dev = case["cfg"], case.get("device", "cpu")
    if "port_params" in case:               # the port's layout, as numpy
        params = tree_map(lambda a: torch.from_numpy(a).to(dev),
                          case["port_params"])
    else:
        params = from_jax(case["params"], cfg, device=dev,
                          mesh=rules if case.get("shard_first") else None)
    eng = ServeEngine(params, cfg, device=dev, mesh=rules,
                      **{**ENGINE, **case.get("engine", {})})
    sps = case.get("sampling") or [{}] * len(PROMPTS)
    for p, sp in zip(PROMPTS, sps):
        eng.submit(p, max_new_tokens=case.get("max_new", 4),
                   sampling=SamplingParams(**sp))
    sums, inner = [], sc_layers.sc_linear_int
    if case.get("sums"):
        def spy(int_params, x_q):
            out = inner(int_params, x_q)
            sums.append(out.clone())
            return out
        sc_layers.sc_linear_int = spy
    trace, done = [], []
    try:
        for _ in range(200):
            done += eng.step()
            trace.append(([None if r is None else list(r._table.pages)
                           for r in eng.slots], eng.allocator.free_count))
            if not eng.queue and all(s is None for s in eng.slots):
                break
    finally:
        sc_layers.sc_linear_int = inner
    done = sorted(done, key=lambda r: r.rid)
    return {"generated": [r.generated for r in done],
            "logprobs": [r.logprobs for r in done],
            "trace": trace,
            "num_pages": eng.allocator.num_pages,
            "shapes": {k: tuple(v.shape) for k, v in
                       tree_paths({"params": eng.params,
                                   "cache": eng.cache})},
            "sums": [s.cpu().numpy() for s in sums]}


def _child(name, rank, world, port, data_parallel, cases, queue):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        from repro_torch.launch.mesh import make_serving_mesh, serving_rules
        rules = serving_rules(make_serving_mesh(
            model_parallel=world // data_parallel,
            data_parallel=data_parallel, backend="gloo"))
        out = {}
        for cid, case in cases.items():
            try:
                out[cid] = serve(case, rules)
            except Exception as e:
                raise AssertionError(f"case {cid!r} failed") from e
        dist.barrier()
        dist.destroy_process_group()
        queue.put(((name, rank), out, None))
    except BaseException:
        queue.put(((name, rank), None, traceback.format_exc()))
        raise


class Job:
    """Every mesh of ``meshes`` ({name: (world, data_parallel)}: ``world``
    ranks as a (data_parallel, world / data_parallel) mesh) running every
    case of ``cases`` ({id: case}), all meshes at once, started at
    construction; :meth:`collect` waits for them."""

    def __init__(self, meshes: dict, cases: dict):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.meshes = meshes
        self.queue = ctx.Queue()
        self.procs = {}
        for name, (world, dp) in meshes.items():
            port = free_port()
            for r in range(world):
                self.procs[name, r] = ctx.Process(
                    target=_child, args=(name, r, world, port, dp, cases,
                                         self.queue), daemon=True)
        for p in self.procs.values():
            p.start()

    def collect(self, timeout: float = 240) -> dict:
        """{name: [each rank's {id: result}]}; a rank that fails (or exits
        non-zero) fails the call, and no rank outlives it."""
        results, errors = {}, []
        try:
            for _ in self.procs:
                key, out, err = self.queue.get(timeout=timeout)
                if err is not None:
                    errors.append(f"mesh {key[0]} rank {key[1]}:\n{err}")
                    break
                results[key] = out
        finally:
            for p in self.procs.values():
                p.join(timeout=30 if not errors else 5)
                if p.is_alive():
                    p.kill()
                    p.join()
        codes = {k: p.exitcode for k, p in self.procs.items()}
        if errors or any(c != 0 for c in codes.values()):
            raise AssertionError(f"mesh ranks failed (exit codes {codes})\n"
                                 + "\n".join(errors))
        return {name: [results[name, r] for r in range(world)]
                for name, (world, _) in self.meshes.items()}


def _rank_main(target, rank, world, port, args, queue):
    torch.set_num_threads(1)
    try:
        import torch.distributed as dist
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=120))
        out = target(rank, world, *args)
        dist.barrier()
        dist.destroy_process_group()
        queue.put((rank, out, None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
        raise


def on_ranks(target, world: int, *args, timeout: float = 120) -> list:
    """``target(rank, world, *args)`` (a function of this module) on each
    rank of a gloo group of ``world`` ranks; each rank's result."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue, port = ctx.Queue(), free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(target, r, world, port, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in procs:
            rank, res, err = queue.get(timeout=timeout)
            if err is not None:
                raise AssertionError(f"rank {rank}:\n{err}")
            out[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return [out[r] for r in range(world)]


def psum(rank, world, grads):
    """``distributed.compressed_psum`` of this rank's gradient."""
    from repro_torch.distributed import compressed_psum
    return compressed_psum(torch.from_numpy(grads[rank])).numpy()


def gathered(rank, world, parts, device):
    """``sharding.gather`` over a (1, world) mesh of this rank's entry of
    each of ``parts`` ({name: (per-rank numpy arrays, torch dtype name,
    dim)}), on ``device``; the results' raw bits as numpy."""
    from repro_torch.distributed.sharding import gather, mesh_rules
    from repro_torch.launch.mesh import make_serving_mesh, serving_rules
    rules = serving_rules(make_serving_mesh(world, backend="gloo"))
    out = {}
    with mesh_rules(rules):
        for name, (arrays, dtype, dim) in parts.items():
            x = torch.from_numpy(arrays[rank]).to(device).view(
                getattr(torch, dtype))
            y = gather(x, "model", dim)
            assert y.device == x.device and y.dtype == x.dtype
            out[name] = y.cpu().view(_raw(y.dtype)).numpy()
    return out


def _raw(dtype):
    return {1: torch.uint8, 2: torch.int16, 4: torch.int32,
            8: torch.int64}[torch.empty((), dtype=dtype).element_size()]


def run_all(calls: list, threads: int = 6) -> list:
    """Call every function of ``calls`` (the reference's runs, which
    spend their time compiling) on a few threads; their results."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(lambda f: f(), calls))


def join_sums(per_rank: list[list[np.ndarray]]) -> list[np.ndarray]:
    """A "model"-only mesh's sc_int sums, call by call, put back together
    along the output columns (a projection every rank ran whole is
    taken from rank 0)."""
    out = []
    for parts in zip(*per_rank):
        if all(p.shape == parts[0].shape for p in parts) and all(
                np.array_equal(p, parts[0]) for p in parts):
            out.append(parts[0])
        else:
            out.append(np.concatenate(parts, axis=-1))
    return out


def live_ssm(params_np: dict) -> dict:
    """Mamba's ``conv_w`` at 10x the reference's draw (reference layout,
    numpy), as the port's recurrent tests: at the init scale the SSM's
    inputs all round to activation level 0 and its state stays zero."""
    periods = {name: dict(pp, mixer=dict(pp["mixer"],
                                         conv_w=pp["mixer"]["conv_w"] * 10))
               if "conv_w" in pp["mixer"] else pp
               for name, pp in params_np["periods"].items()}
    return dict(params_np, periods=periods)


def forced_logits(params, cfg, prompt, tokens, datapath, fmt="fp", page=8,
                  max_len=32):
    """The port's logits (mesh-off) at each generated position of
    ``prompt`` followed by ``tokens``: ``paged_prefill`` then
    ``paged_decode_step`` on a single-slot cache, as the paged oracle."""
    from repro_torch.models import (init_paged_cache, paged_decode_step,
                                    paged_prefill)
    from repro_torch.serving.engine import _cfg_for_datapath
    from repro_torch.serving.paging import pad_pow2
    c = _cfg_for_datapath(cfg, datapath)
    L = pad_pow2(max(len(prompt), page))
    maxp = max(max_len // page, L // page)
    cache = init_paged_cache(c, 1, maxp + 1, page, fmt, device="cpu")
    tables = torch.arange(1, maxp + 1, dtype=torch.int32)[None, :]
    slot = torch.zeros((1,), dtype=torch.int32)
    toks = torch.zeros((1, L), dtype=torch.int32)
    toks[0, :len(prompt)] = torch.tensor(prompt)
    with torch.inference_mode():
        lg, cache = paged_prefill(params, cache, toks, tables,
                                  torch.tensor([len(prompt)]), c, chunk=L,
                                  slot_ids=slot)
        out = [lg[0, :c.vocab_size]]
        for i, t in enumerate(tokens[:-1]):
            lg, cache = paged_decode_step(
                params, cache, torch.tensor([t], dtype=torch.int32), slot,
                tables, torch.tensor([len(prompt) + i], dtype=torch.int32),
                c)
            out.append(lg[0, :c.vocab_size])
    return out


def assert_matches_reference(got, want, case, datapath):
    """The port's greedy tokens equal the reference's; on the qat
    datapath a request may part from the reference only at an exact tie
    of the fake-quant lattice (ROADMAP Queue 3 item 10: the port's
    float64 product keeps the tie and takes the lower id, the reference's
    float32 sum breaks it by rounding), with the reference's whole
    sequence greedy under the port's own logits within ``QAT_ATOL``."""
    if datapath != "qat" or got == want:
        assert got == want, (got, want)
        return
    from repro_torch.weights import from_jax
    params = from_jax(case["params"], case["cfg"], device="cpu")
    fmt = case.get("engine", {}).get("kv_format", "fp")
    for prompt, g, w in zip(PROMPTS, got, want):
        if g == w:
            continue
        logits = forced_logits(params, case["cfg"], prompt, w, datapath, fmt)
        first = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        for i, (lg, t) in enumerate(zip(logits, w)):
            assert float(lg[t]) >= float(lg.max()) - QAT_ATOL, (prompt, i)
        lg = logits[first]
        assert float(lg[g[first]]) == float(lg[w[first]]) == \
            float(lg.max()), (prompt, first)
