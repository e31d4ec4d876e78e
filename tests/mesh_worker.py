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
ranks' start-up once; a job's cases reach its ranks through a temporary
file (:func:`_stash`), so that all of them start together.

The training mesh's side: :class:`Ranks` runs a function of this module
on a gloo group; :func:`train_step_case` is one train step (mesh-on under
training rules, or mesh-off), :func:`decode_step_case` one dense decode
step over a time-cut cache (or a batch-cut one), :func:`prefill_case` the
dense prefill in the training layout, :func:`restore_on_mesh` a
checkpoint restored as blocks; :func:`mesh_cases` runs cases of every
kind on one mesh.
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


def _stash(obj) -> str:
    """``obj`` pickled to a temporary file, whose path the ranks get: a
    spawn's arguments go through a pipe that blocks the parent until the
    child has started, so large ones would start the ranks one by one."""
    import os
    import pickle
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump(obj, f)
    return path


def _unstash(path: str):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def _drop(path: str) -> None:
    import os
    if os.path.exists(path):
        os.unlink(path)


def _child(name, rank, world, port, data_parallel, cases, queue):
    torch.set_num_threads(1)
    try:
        cases = _unstash(cases)
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
        self.path = _stash(cases)
        for name, (world, dp) in meshes.items():
            port = free_port()
            for r in range(world):
                self.procs[name, r] = ctx.Process(
                    target=_child, args=(name, r, world, port, dp, self.path,
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
            _drop(self.path)
        codes = {k: p.exitcode for k, p in self.procs.items()}
        if errors or any(c != 0 for c in codes.values()):
            raise AssertionError(f"mesh ranks failed (exit codes {codes})\n"
                                 + "\n".join(errors))
        return {name: [results[name, r] for r in range(world)]
                for name, (world, _) in self.meshes.items()}


def _rank_main(target, rank, world, port, args, queue):
    torch.set_num_threads(1)
    try:
        args = _unstash(args)
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


class Ranks:
    """``target(rank, world, *args)`` (a function of this module) on each
    rank of a gloo group of ``world`` ranks, started at construction;
    several may run at once.  :meth:`collect` waits for each rank's
    result; a rank that fails fails the call, and no rank outlives it."""

    def __init__(self, target, world: int, *args):
        import torch.multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.queue, port = ctx.Queue(), free_port()
        self.path = _stash(args)
        self.procs = [ctx.Process(target=_rank_main, daemon=True,
                                  args=(target, r, world, port, self.path,
                                        self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def collect(self, timeout: float = 120) -> list:
        out = {}
        try:
            for _ in self.procs:
                rank, res, err = self.queue.get(timeout=timeout)
                if err is not None:
                    raise AssertionError(f"rank {rank}:\n{err}")
                out[rank] = res
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
            _drop(self.path)
        assert all(p.exitcode == 0 for p in self.procs), \
            [p.exitcode for p in self.procs]
        return [out[r] for r in range(len(self.procs))]


def on_ranks(target, world: int, *args, timeout: float = 120) -> list:
    """``target(rank, world, *args)`` on each rank of a gloo group of
    ``world`` ranks; each rank's result."""
    return Ranks(target, world, *args).collect(timeout)


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



# -- the training mesh ----------------------------------------------------

def _mesh_rules(shape, seq: bool = False):
    """Training rules on a (data, model) or (pod, data, model) mesh; with
    ``seq`` the long-context decode's (the batch of 1 on no axis, K / V
    time over "data"), as the dry-run's long_500k cell."""
    from repro_torch.distributed.sharding import MeshRules
    from repro_torch.launch.mesh import _grid, training_rules
    axes = ("pod", "data", "model")[-len(shape):]
    rules = training_rules(_grid(tuple(shape), axes, backend="gloo"))
    if seq:
        rules = MeshRules(mesh=rules.mesh, mapping=dict(rules.mapping,
                                                        batch=()))
    return rules


def train_step_case(case: dict, rules=None) -> dict:
    """One ``build_train_step`` step of ``case`` (a config, the port's
    parameters as numpy, a numpy batch, ``grad_compress``) under
    ``rules`` (or mesh-off): the metrics and the whole params, ``m`` and
    ``v`` after it (gathered from the blocks), as numpy."""
    from repro_torch.distributed.sharding import (mesh_rules, shard_tree,
                                                  unshard_tree)
    from repro_torch.models import param_specs
    from repro_torch.optim import warmup_cosine
    from repro_torch.train import build_train_step, init_train_state
    from repro_torch.tree import tree_map, tree_paths
    cfg, comp = case["cfg"], case.get("grad_compress", False)
    params = tree_map(lambda a: torch.from_numpy(a.copy()), case["params"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    with mesh_rules(rules):
        if rules is not None:
            params = shard_tree(params, param_specs(cfg, serving=False),
                                rules)
        state = init_train_state(params, cfg, grad_compress=comp)
        step = build_train_step(cfg, lambda s: warmup_cosine(
            s + 1, 1e-3, 2, 10), grad_compress=comp)
        state, m = step(state, batch)
        if case.get("ckpt_dir"):
            from repro_torch.checkpoint import save_checkpoint
            save_checkpoint(case["ckpt_dir"], 1, state, async_=False)
        whole = unshard_tree(state)
    return {"metrics": {k: float(v) for k, v in m.items()},
            **{name: {k: _numpy(v) for k, v in tree_paths(tree)}
               for name, tree in (("params", whole.params),
                                  ("m", whole.opt["m"]),
                                  ("v", whole.opt["v"]))}}


def _numpy(t: torch.Tensor) -> np.ndarray:
    """``t`` as numpy; bfloat16 (jamba's optimizer state) as float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_mesh(rank, world, shape, cases):
    """Every case of ``cases`` ({id: case}) on a ``shape`` training mesh
    of gloo ranks (``train_step_case``)."""
    rules = _mesh_rules(shape)
    return {cid: train_step_case(case, rules) for cid, case in cases.items()}


def restore_on_mesh(rank, world, shape, cfg, jobs):
    """``restore_checkpoint`` of step 1 of each ``(directory, prefix,
    target)`` of ``jobs`` onto a ``shape`` training mesh (each rank its
    blocks, under the training layout; ``prefix`` the key the params sit
    under in the checkpoint, or None), gathered whole again: each leaf's
    raw bits and the blocks' shapes."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.distributed.sharding import mesh_rules, unshard_tree
    from repro_torch.models import param_specs
    from repro_torch.tree import tree_map, tree_paths
    rules = _mesh_rules(shape)
    out = []
    for ckpt_dir, prefix, target in jobs:
        specs = param_specs(cfg, serving=False)
        tgt = tree_map(lambda a: torch.from_numpy(a.copy()), target)
        if prefix:
            tgt, specs = {prefix: tgt}, {prefix: specs}
        with mesh_rules(rules):
            blocks = restore_checkpoint(ckpt_dir, 1, tgt, rules=rules,
                                        specs=specs)
            whole = unshard_tree(blocks)
        out.append(({k: v.view(_raw(v.dtype)).numpy()
                     for k, v in tree_paths(whole)},
                    {k: tuple(v.shape) for k, v in tree_paths(blocks)}))
    return out


def decode_step_case(case: dict, rules=None) -> dict:
    """One dense ``decode_step`` of ``case`` (a config, the port's params,
    a cache as numpy, tokens; ``cache_kw``, the ``cache_specs`` options,
    default ``kv_head_shard=False``: time over "model") under ``rules``
    (or mesh-off), the params in the serving layout: the logits and the
    cache after the step, whole."""
    from repro_torch.distributed.sharding import (mesh_rules, shard_tree,
                                                  unshard_tree)
    from repro_torch.models import cache_specs, decode_step, param_specs
    from repro_torch.tree import tree_map, tree_paths
    cfg = case["cfg"]
    params = tree_map(lambda a: torch.from_numpy(a.copy()), case["params"])
    cache = tree_map(lambda a: torch.from_numpy(a.copy()), case["cache"])
    tokens = torch.from_numpy(case["tokens"])
    with mesh_rules(rules), torch.no_grad():
        if rules is not None:
            params = shard_tree(params, param_specs(cfg), rules)
            cache = shard_tree(cache, cache_specs(
                cfg, **case.get("cache_kw", dict(kv_head_shard=False))),
                rules, logical=True)
            tokens = shard_tree(tokens, ("batch", None), rules, logical=True)
        logits, new = decode_step(params, cache, tokens, cfg)
        if rules is not None:
            from repro_torch.distributed.sharding import batch_axes, gather
            logits = gather(logits, batch_axes(), 0)
            # a recurrent layer's new state is a fresh block of the leaf
            # it replaces
            new = tree_map(_tag_like, new, cache)
        whole = unshard_tree(new)
    return {"logits": logits.numpy(),
            "cache": {k: v.numpy() for k, v in tree_paths(whole)}}


def _tag_like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    if hasattr(old, "mesh_spec") and not hasattr(new, "mesh_spec"):
        new.mesh_spec = old.mesh_spec
    return new


def decode_mesh(rank, world, shape, case):
    return decode_step_case(case, _mesh_rules(shape))


def prefill_case(case: dict, rules=None) -> dict:
    """The dense ``prefill`` of ``case``'s tokens (a config, the port's
    params, a numpy batch) under ``rules`` (or mesh-off), the params in
    the training layout and the batch cut over the batch axes, as the
    dry-run's prefill cell: the logits of the whole batch."""
    from repro_torch.distributed.sharding import (batch_axes, gather,
                                                  mesh_rules, shard_tree)
    from repro_torch.models import param_specs, prefill
    from repro_torch.tree import tree_map
    cfg = case["cfg"]
    params = tree_map(lambda a: torch.from_numpy(a.copy()), case["params"])
    batch = {"tokens": torch.from_numpy(case["batch"]["tokens"])}
    with mesh_rules(rules), torch.no_grad():
        if rules is not None:
            params = shard_tree(params, param_specs(cfg, serving=False),
                                rules)
            batch = shard_tree(batch, {"tokens": ("batch", None)}, rules,
                               logical=True)
        logits, _ = prefill(params, batch, cfg)
        logits = gather(logits, batch_axes(), 0)
    return {"logits": logits.numpy()}


_KINDS = {"train": train_step_case, "prefill": prefill_case,
          "decode": decode_step_case}


def mesh_cases(rank, world, shape, cases):
    """Every case of ``cases`` ({id: case}, each with its ``kind``:
    "train", "prefill", "decode", or "seq_decode", the long-context
    decode's rules) on a ``shape`` mesh of gloo ranks."""
    out = {}
    for cid, case in cases.items():
        kind = case.get("kind", "train")
        rules = _mesh_rules(shape, seq=kind == "seq_decode")
        out[cid] = _KINDS.get(kind, decode_step_case)(case, rules)
    return out


def case_off(case: dict) -> dict:
    """A case of :func:`mesh_cases` mesh-off."""
    return _KINDS.get(case.get("kind", "train"), decode_step_case)(case)
