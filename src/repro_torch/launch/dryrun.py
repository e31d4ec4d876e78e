"""Multi-pod dry-run: every (architecture x input shape x mesh) cell of the
port traced at full size as rank 0 of a 256- or 512-rank world, with its
memory, its counted cost and its roofline recorded.

Port of ``repro.launch.dryrun``.  Where the reference lowers and compiles
each cell on 512 forced host devices and reads XLA's memory and cost
analyses, the port runs the cell's real code, rank 0's share of it, on
tensors without data:

* the world is ``torch.distributed``'s ``"fake"`` backend (every
  collective a no-op of the right shape) at 512 ranks, the mesh
  ``launch.mesh.make_production_mesh`` over it, the rules
  ``sharding.multipod_mapping``;
* the tensors are meta tensors standing for the card's (PyTorch's CPU
  build runs no autograd on fake CUDA tensors): rank 0's blocks of the
  params, optimizer state, batch and cache; the kernels' routes are
  traced through their custom ops' shape functions
  (``kernels.build.on_card``), not through their plain versions;
* ``train`` runs ``train.build_train_step`` under the training layout
  (``param_specs(serving=False)``), ``prefill`` the dense ``prefill``
  (an encoder's ``forward``) under the training layout, ``decode`` one
  ``decode_step`` under the serving layout with the cache of
  ``cache_specs``, its time axis over "model" when the KV heads do not
  divide it, or over "data" for long_500k, whose batch of 1 takes no
  mesh axis (the reference's rules);
* the record keeps the reference's keys: ``memory_analysis`` (the exact
  bytes of rank 0's argument blocks; the peak of live storages through
  the step, arguments included, counted as each storage is made and
  freed), ``cost_analysis`` (``analysis/op_cost.step_cost``'s operations
  and bytes) and ``roofline`` (``roofline_from_step`` at the H100 SXM's
  data-sheet peaks, each mesh axis's collective bytes priced at the link
  it crosses: :data:`LINKS`).

These are counts of a trace on the host priced at published peaks, not
measurements on a card.

One cell:   python -m repro_torch.launch.dryrun --arch granite-3-2b \\
                --shape train_4k --mesh both
All cells:  python -m repro_torch.launch.dryrun --all   (a subprocess a
            cell, so one cell's failure cannot take the sweep down)

Skip rules (the reference's): encoder archs skip decode shapes; pure
full-attention archs skip long_500k.  Skips are recorded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..analysis.op_cost import step_cost
from ..analysis.roofline import H100_SXM, roofline_from_step
from ..configs import SHAPES, get_arch, list_archs, shape_by_name
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.sharding import (MeshRules, mesh_rules, multipod_mapping,
                                    shard_tree)
from ..models import (batch_specs, cache_specs, decode_step, forward,
                      init_cache, init_params, param_specs, prefill)
from ..tree import tree_leaves, tree_map
from .mesh import make_production_mesh, mesh_chips, mesh_name

__all__ = ["REPORT_DIR", "VLM_IMG_TOKENS", "LINKS", "cell_skip_reason",
           "all_cells", "run_cell", "sweep", "main"]

REPORT_DIR = str(Path(__file__).resolve().parents[3] / "experiments"
                 / "dryrun_torch")
VLM_IMG_TOKENS = 2880
WORLD = 512
# one direction, per GPU: an axis whose ranks share one 8-GPU node rides
# NVLink; one that spans nodes is held to the node's network, one
# ConnectX-7 400 Gb/s port a GPU (NVIDIA DGX H100 data sheet)
NODE = 8
LINKS = {"nvlink": (450e9, "NVLink 4, 450 GB/s a direction (H100 SXM "
                           "data sheet: 900 GB/s bidirectional)"),
         "network": (50e9, "InfiniBand NDR, 400 Gb/s = 50 GB/s a GPU "
                           "(DGX H100 data sheet: 8 x ConnectX-7)")}


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if cfg.is_encoder and shape.kind == "decode":
        return "encoder-only: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("pure full-attention arch: 524k context needs "
                "sub-quadratic attention")
    return None


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in list_archs() for s in SHAPES]


# ---------------------------------------------------------------------------
# rank 0's blocks, as meta tensors
# ---------------------------------------------------------------------------

def _meta(make):
    """The tree ``make()`` returns, as meta tensors of its shapes and
    dtypes (``make`` runs on fake host tensors: nothing is allocated)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = tree_map(lambda t: _Leaf(tuple(t.shape), t.dtype), make())
    return tree_map(lambda sd: torch.empty(sd.shape, dtype=sd.dtype,
                                           device="meta"), shapes)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    shape: tuple
    dtype: torch.dtype


def _batch(cfg: ModelConfig, shape: ShapeConfig, kind: str) -> dict:
    """The cell's whole batch (meta), as the reference's ``_batch_sds``."""
    b, s = shape.global_batch, shape.seq_len
    f = {}
    if cfg.frontend == "vision_stub":
        img = min(VLM_IMG_TOKENS, s // 2)
        f["patch_embeds"] = (b, img, 1024), torch.bfloat16
        f["tokens"] = (b, s - img), torch.int32
    elif cfg.frontend == "audio_stub":
        f["frames"] = (b, s, 512), torch.bfloat16
    else:
        f["tokens"] = (b, s), torch.int32
    if kind == "train":
        f["targets"] = (b, s), torch.int32
        f["loss_mask"] = (b, s), torch.float32
    return {k: torch.empty(sh, dtype=dt, device="meta")
            for k, (sh, dt) in f.items()}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _LiveBytes(TorchDispatchMode):
    """The bytes of storages made inside the block and still alive, and
    their peak: a storage counts from the op that makes it until the last
    tensor on it is freed (weakref finalizers; autograd's saved tensors
    keep theirs alive).  Storages of ``known`` tensors (the arguments)
    are not counted."""

    def __init__(self, known):
        super().__init__()
        self.seen = {t.untyped_storage()._cdata for t in tree_leaves(known)
                     if isinstance(t, torch.Tensor)}
        self.refs: dict[int, int] = {}
        self.size: dict[int, int] = {}
        self.live = self.peak = 0

    def _drop(self, key: int) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            self.live -= self.size.pop(key)
            del self.refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out) if isinstance(out, (list, tuple)) \
                else [out]:
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self.seen:
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.size[key] = t.untyped_storage().nbytes()
                self.live += self.size[key]
                self.peak = max(self.peak, self.live)
            self.refs[key] += 1
            weakref.finalize(t, self._drop, key)
        return out


def _links(mesh) -> dict:
    """Each mesh axis's link: NVLink if its ranks share one node."""
    out = {}
    stride = 1
    for name, n in reversed(list(zip(mesh.axis_names, mesh.shape))):
        out[name] = "nvlink" if stride * n <= NODE else "network"
        stride *= n
    return out


def _priced(cost, links: dict):
    """The H100 SXM spec with its link rate the one that prices this
    step's collectives (each axis's bytes at its link), and the bytes and
    links by axes."""
    t = 0.0
    for axes, nbytes in cost.wire_by_axes.items():
        # a group over several axes is held to its slowest link
        kind = "network" if any(links[a] == "network"
                                for a in axes.split(",")) else "nvlink"
        t += nbytes / LINKS[kind][0]
    bw = cost.wire_bytes / t if t else H100_SXM.link_bw
    return dataclasses.replace(H100_SXM, link_bw=bw)


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _world() -> None:
    import torch.distributed as dist
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=WORLD,
                                store=FakeStore())


def _trace(cfg: ModelConfig, shape: ShapeConfig, rules: MeshRules):
    """Rank 0's share of the cell: (its step as a callable, the argument
    tree, the tree of arguments written in place)."""
    mesh = rules.mesh
    params = shard_tree(_meta(lambda: init_params(cfg, torch.Generator(),
                                                  device="cpu")),
                        param_specs(cfg, serving=shape.kind == "decode"),
                        rules)
    if shape.kind == "train":
        from ..optim import constant_lr
        from ..train import build_train_step, init_train_state
        state = init_train_state(params, cfg)
        batch = shard_tree(_batch(cfg, shape, "train"),
                           batch_specs(cfg, "train"), rules, logical=True)
        step = build_train_step(cfg, lambda s: constant_lr(s, 3e-4))
        return (lambda: step(state, batch)[1]), (state, batch), state
    if shape.kind == "prefill":
        batch = shard_tree(_batch(cfg, shape, "prefill"),
                           batch_specs(cfg, "prefill"), rules, logical=True)
        if cfg.is_encoder:
            def run():
                return forward(params, batch, cfg, mode="train")[0]
        else:
            def run():
                return prefill(params, batch, cfg)
        return torch.no_grad()(run), (params, batch), None
    b, s = shape.global_batch, shape.seq_len
    seq_shard = shape.name == "long_500k"
    tp = mesh.axis_size("model")
    kv_head_shard = cfg.n_kv_heads % tp == 0 and not seq_shard
    cache = shard_tree(
        _meta(lambda: init_cache(cfg, b, s, device="cpu")),
        cache_specs(cfg, seq_shard=seq_shard, kv_head_shard=kv_head_shard),
        rules, logical=True)
    tok = shard_tree(torch.empty((b, 1), dtype=torch.int32, device="meta"),
                     ("batch", None), rules, logical=True)
    return torch.no_grad()(lambda: decode_step(params, cache, tok, cfg)), \
        (params, cache, tok), cache


def trace_step(cfg: ModelConfig, shape: ShapeConfig,
               rules: MeshRules) -> dict:
    """Rank 0's share of a cell under ``rules`` (a mesh over the fake
    world), traced twice on meta tensors: once for the peak of live
    storages (arguments included), once under ``op_cost.step_cost`` (its
    count keeps each kernel call's operands until the step ends, which
    the peak must not see).  Returns the cost, the peak, the argument /
    output / in-place bytes and the seconds the traces took."""
    t0 = time.time()
    with mesh_rules(rules):
        run, args, aliased = _trace(cfg, shape, rules)
        live = _LiveBytes(args)
        with live:
            out = run()
        out_bytes = _nbytes(out)
        del out
        cost = step_cost(run)
    arg = _nbytes(args)
    return dict(cost=cost, peak=arg + live.peak, argument=arg,
                output=out_bytes, alias=_nbytes(aliased),
                trace_s=time.time() - t0)


def predict_train_peak(arch: str, layers: int, batch: int, seq: int,
                       mesh_shape: tuple, keep: tuple | None = None,
                       overrides: dict | None = None) -> dict:
    """The dry-run's peak bytes a rank for ``arch`` cut to ``layers`` (its
    period cut to the layers ``keep`` names, when given) with config
    ``overrides``, training on ``batch`` x ``seq`` tokens over a (data,
    model) mesh of ``mesh_shape`` (rank 0's share; ``chip_smoke.py`` sets
    it beside the card's measured peak)."""
    from .mesh import _grid, training_rules
    _world()
    cfg = get_arch(arch)
    if keep is not None:
        cfg = cfg.scaled(period=tuple(cfg.period[i] for i in keep))
    cfg = cfg.scaled(n_layers=layers, **(overrides or {}))
    rules = training_rules(_grid(tuple(mesh_shape), ("data", "model"),
                                 "fake"))
    t = trace_step(cfg, ShapeConfig("chip", seq, batch, "train"), rules)
    return dict(peak=t["peak"], argument=t["argument"],
                trace_s=t["trace_s"])


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             quant: str | None = None, report_dir: str = REPORT_DIR,
             verbose: bool = True, overrides: dict | None = None) -> dict:
    cfg = get_arch(arch)
    if quant:
        cfg = cfg.with_quant(quant) if quant != "none" \
            else cfg.scaled(quant=cfg.quant.with_mode("none"))
    if overrides:
        cfg = cfg.scaled(**overrides)
    shape = shape_by_name(shape_name)
    _world()
    mesh = make_production_mesh(multi_pod=multi_pod, backend="fake")
    mname = mesh_name(mesh)
    record = {"arch": arch, "shape": shape_name, "mesh": mname,
              "chips": mesh_chips(mesh), "quant": cfg.quant.mode,
              "status": "?"}
    skip = cell_skip_reason(cfg, shape)
    if skip:
        record.update(status="skipped", reason=skip)
        _save(record, report_dir)
        if verbose:
            print(f"[dryrun] SKIP {arch} x {shape_name} x {mname}: {skip}")
        return record
    mapping = multipod_mapping()
    if shape.global_batch == 1:
        # long_500k: the batch cannot take a mesh axis; "seq" carries the
        # context instead
        mapping = dict(mapping, batch=())
    rules = MeshRules(mesh=mesh, mapping=mapping)
    t = trace_step(cfg, shape, rules)
    cost, peak, links = t["cost"], t["peak"], _links(mesh)
    rep = roofline_from_step(cost, cfg, shape, mesh=mname,
                             n_chips=mesh_chips(mesh),
                             hw=_priced(cost, links), peak_hbm_bytes=peak,
                             note="counts of a host trace at data-sheet "
                                  "peaks")
    record.update(
        status="ok", lower_s=round(t["trace_s"], 1), compile_s=0.0,
        traced_periods=cfg.n_periods,
        memory_analysis={
            "argument_size_in_bytes": t["argument"],
            "output_size_in_bytes": t["output"],
            "temp_size_in_bytes": peak - t["argument"],
            "alias_size_in_bytes": t["alias"],
            "peak_memory_in_bytes": peak,
        },
        cost_analysis={"flops": float(sum(cost.flops.values())),
                       "bytes accessed": float(cost.hbm_bytes)},
        roofline=dict(json.loads(rep.to_json()),
                      flops_per_device=float(sum(cost.flops.values())),
                      collective_breakdown=dict(cost.wire_by_axes),
                      links={a: LINKS[k][1] for a, k in links.items()}),
    )
    _save(record, report_dir)
    if verbose:
        r = record["roofline"]
        print(f"[dryrun] OK {arch} x {shape_name} x {mname}: "
              f"peak/device {peak / 2 ** 30:.2f} GiB  "
              f"terms(c/m/coll)={r['t_compute']:.3e}/{r['t_memory']:.3e}/"
              f"{r['t_collective']:.3e}s  bottleneck={r['bottleneck']} "
              f"frac={r['roofline_fraction']:.2f} (trace {t['trace_s']:.1f}s)")
    return record


def _save(record: dict, report_dir: str):
    os.makedirs(report_dir, exist_ok=True)
    fn = (f"{record['arch']}__{record['shape']}__{record['mesh']}"
          f"__{record.get('quant', 'q')}.json")
    with open(os.path.join(report_dir, fn), "w") as f:
        json.dump(record, f, indent=1)


# ---------------------------------------------------------------------------
# the sweep (a subprocess a cell)
# ---------------------------------------------------------------------------

def sweep(meshes: list[bool], quant: str | None, report_dir: str,
          only_missing: bool = False, cells=None, timeout: float = 14400,
          overrides: dict | None = None):
    """Every cell of ``cells`` (default :func:`all_cells`) on each mesh,
    each in its own process (``overrides`` passed on as ``--set``); a
    cell that fails, or runs past ``timeout`` seconds, is recorded as
    failed with its error's tail.  Returns 1 if any failed.  The
    recurrent archs' prefill_32k cells trace the per-token recurrence
    over 32768 positions: jamba's takes more than an hour on the host."""
    results = []
    for arch, shape_name in (cells or all_cells()):
        for multi in meshes:
            mname = "2x16x16" if multi else "16x16"
            out = os.path.join(
                report_dir, f"{arch}__{shape_name}__{mname}"
                f"__{quant or get_arch(arch).quant.mode}.json")
            if only_missing and os.path.exists(out):
                with open(out) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    results.append((arch, shape_name, mname, prev["status"]))
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape_name,
                   "--mesh", "multi" if multi else "single",
                   "--report-dir", report_dir]
            if quant:
                cmd += ["--quant", quant]
            for k, v in (overrides or {}).items():
                cmd += ["--set", f"{k}={v}"]
            t0 = time.time()
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout)
            except subprocess.TimeoutExpired as e:
                err = e.stderr or b""
                r = subprocess.CompletedProcess(
                    cmd, 1, "", f"timed out after {timeout} s\n" + (
                        err.decode() if isinstance(err, bytes) else err))
            status = "ok"
            if r.returncode != 0:
                status = "FAILED"
                fail = {"arch": arch, "shape": shape_name, "mesh": mname,
                        "quant": quant or get_arch(arch).quant.mode,
                        "status": "failed", "stderr": r.stderr[-4000:]}
                _save(fail, report_dir)
            print(f"[sweep] {arch} x {shape_name} x {mname}: {status} "
                  f"({time.time() - t0:.0f}s)")
            sys.stdout.write(r.stdout[-2000:] if r.returncode == 0
                             else r.stderr[-2000:] + "\n")
            results.append((arch, shape_name, mname, status))
    bad = [r for r in results if r[3] == "FAILED"]
    print(f"[sweep] done: {len(results)} cells, {len(bad)} failed")
    for b in bad:
        print("  FAILED:", b)
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--quant", choices=["none", "sc_qat"], default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only-missing", action="store_true")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. --set ce_chunks=8")
    args = ap.parse_args()
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        if v.lstrip("-").isdigit():
            overrides[k] = int(v)
        elif v in ("True", "False"):
            overrides[k] = v == "True"
        else:
            overrides[k] = v

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        sys.exit(sweep(meshes, args.quant, args.report_dir,
                       args.only_missing))
    assert args.arch and args.shape, "--arch/--shape or --all"
    for multi in meshes:
        try:
            run_cell(args.arch, args.shape, multi, args.quant,
                     args.report_dir, overrides=overrides or None)
        except Exception:
            traceback.print_exc()
            sys.exit(1)


if __name__ == "__main__":
    main()
