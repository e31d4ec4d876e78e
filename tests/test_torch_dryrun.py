"""The port's multi-pod dry-run (``repro_torch.launch.dryrun``) and its
tables (``repro_torch.analysis.report``) against the reference's.

* ``all_cells`` and ``cell_skip_reason`` equal the reference's (40 cells,
  9 skips); ``dryrun_table`` on the same records gives the reference's
  string.
* One cell, granite-3-2b ``decode_32k`` on the 16 x 16 mesh, runs in a
  subprocess as rank 0 of the fake 512-rank world: its
  ``argument_size_in_bytes`` equals the bytes of rank 0's blocks counted
  from the reference's own specs over ``jax.eval_shape`` of its
  ``init_params`` / ``init_cache`` (no 512-device compile); the record
  holds a peak, the counted operations and a roofline.
* The recurrent archs' cells: rwkv6-7b ``decode_32k`` and jamba
  ``long_500k`` (8 of its 72 layers: one period) end ``ok``, their
  argument bytes the count under the reference's serving
  ``param_specs`` (the leaves where the port's serving layout departs
  from it, ROADMAP Queue 1 item 11, under the port's spec: the port
  serves the recurrent mixers' and the experts' contractions whole) and
  its ``cache_specs`` (``seq_shard=True`` for long_500k, whose batch of
  1 takes no mesh axis).
* ``sweep`` records a cell that fails as ``failed`` with its error: a
  query-head count whose groups no rank's block divides.
* The kernels' routes trace through their custom ops' shape functions:
  flash attention on meta tensors at S 4096 never makes an (S, S) tensor.
"""

import importlib
import json
import math
import os
import subprocess
import sys
from functools import partial

import jax
import numpy as np
import pytest
import torch

from port_fixtures import _one_torch_thread  # noqa: F401
from repro.analysis.report import dryrun_table as jdryrun_table
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.distributed.sharding import multipod_mapping as jmultipod_mapping
from repro.models import cache_specs as jcache_specs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import param_specs as jparam_specs
from repro_torch.analysis import report
from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch import dryrun
from repro_torch.models import param_specs

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = {"data": 16, "model": 16}            # the single-pod mesh


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with the process's XLA_FLAGS left
    as they were (the module sets 512 host devices at import for its own
    runs, which must not reach the JAX of this test process)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                             *args], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


# the leaves of the port's serving layout that depart from the
# reference's (ROADMAP Queue 1 item 11; tests/test_torch_train_mesh.py)
SERVING_DEPARTURES = {
    "mamba": {"in_proj", "x_proj", "out_proj"},
    "rwkv6": {"wr", "wk", "wv", "wg", "wo", "ln_x"},
    "rwkv_cmix": {"wk", "wv", "wr"},
    "moe": {"w_down"},
}
# the recurrent cells run: (arch, shape, overrides)
RECURRENT_CELLS = {"rwkv6-decode_32k": ("rwkv6-7b", "decode_32k", {}),
                   "jamba-long_500k": ("jamba-1.5-large-398b", "long_500k",
                                       {"n_layers": 8})}
# 48 query heads over 12 KV heads: a rank of 16 holds 3 of a group of 4
UNEVEN = {"n_heads": 48, "n_kv_heads": 12, "n_layers": 1}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The granite decode cell, the recurrent cells and a cell that fails
    (through ``sweep``, which records the failure), each a subprocess,
    started together."""
    d = str(tmp_path_factory.mktemp("dryrun"))
    bad_dir = str(tmp_path_factory.mktemp("dryrun_failed"))
    procs = {"ok": _run(["--arch", "granite-3-2b", "--shape", "decode_32k",
                         "--mesh", "single", "--report-dir", d])}
    for name, (arch, shape, over) in RECURRENT_CELLS.items():
        procs[name] = _run(["--arch", arch, "--shape", shape, "--mesh",
                            "single", "--report-dir", d]
                           + [f"--set={k}={v}" for k, v in over.items()])
    code = ("import sys; from repro_torch.launch.dryrun import sweep; "
            f"sys.exit(sweep([False], None, {bad_dir!r}, "
            "cells=[('granite-3-2b', 'prefill_32k')], timeout=240, "
            f"overrides={UNEVEN!r}))")
    procs["bad"] = subprocess.Popen([sys.executable, "-c", code],
                                    env=dict(os.environ, PYTHONPATH=SRC),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=240)
        finally:
            p.kill()
        out[name] = (p.returncode, stdout, stderr)
    recs = {(r["arch"], r["shape"]): r for r in report.load_records(d)}
    recs["bad"] = report.load_records(bad_dir)
    return out, recs


def test_cells_and_skips_equal_the_reference():
    ref = _reference_dryrun()
    assert dryrun.all_cells() == ref.all_cells()
    assert len(dryrun.all_cells()) == 40
    skips = 0
    for arch, shape in dryrun.all_cells():
        got = dryrun.cell_skip_reason(get_arch(arch), SHAPES[shape])
        want = ref.cell_skip_reason(jget_arch(arch), JSHAPES[shape])
        assert got == want, (arch, shape)
        skips += got is not None
    assert skips == 9
    assert dryrun.VLM_IMG_TOKENS == ref.VLM_IMG_TOKENS
    for name, s in SHAPES.items():
        j = JSHAPES[name]
        assert (s.seq_len, s.global_batch, s.kind, s.tokens) == \
            (j.seq_len, j.global_batch, j.kind, j.tokens)


def _records():
    ro = {"flops_per_device": 1.234e15, "wire_bytes_per_device": 5.6e10,
          "t_compute": 1.0, "t_memory": 2.0, "t_collective": 3.0,
          "bottleneck": "collective", "model_flops_total": 1e18,
          "useful_flops_ratio": 0.5, "roofline_fraction": 0.25}
    ma = {"peak_memory_in_bytes": 7.5 * 2 ** 30,
          "argument_size_in_bytes": 3 * 2 ** 30}
    return [
        {"arch": "b-arch", "shape": "decode_32k", "mesh": "16x16",
         "status": "ok", "memory_analysis": ma, "roofline": ro,
         "compile_s": 12.4},
        {"arch": "a-arch", "shape": "long_500k", "mesh": "2x16x16",
         "status": "skipped", "reason": "pure full-attention arch"},
        {"arch": "a-arch", "shape": "train_4k", "mesh": "16x16",
         "status": "failed", "stderr": "boom"},
        {"arch": "a-arch", "shape": "train_4k", "mesh": "2x16x16",
         "status": "ok", "memory_analysis": ma, "roofline": ro},
    ]


def test_dryrun_table_equals_the_reference():
    recs = _records()
    assert report.dryrun_table(recs) == jdryrun_table(recs)


def _per_device_bytes(shapes, specs, mapping) -> int:
    """Rank 0's bytes of each leaf under the specs on the 16 x 16 mesh: a
    dimension cut by axes whose sizes divide it (the port's and the
    reference's ``fit_spec`` rule)."""
    def one(sd, spec):
        n = 1
        for dim, ax in zip(sd.shape, tuple(spec) + (None,) * len(sd.shape)):
            names = () if ax is None else (ax,) if isinstance(ax, str) \
                else tuple(ax)
            names = tuple(a for m in names for a in mapping.get(m, (m,)))
            k = math.prod(MESH.get(a, 1) for a in names)
            n *= dim // k if names and dim % k == 0 else dim
        return n * np.dtype(sd.dtype).itemsize
    leaves = jax.tree.leaves(jax.tree.map(
        one, shapes, specs,
        is_leaf=lambda s: isinstance(s, (tuple, jax.sharding.PartitionSpec))))
    return int(sum(leaves))


def test_decode_cell_argument_bytes_equal_the_reference_specs(cells):
    rc, stdout, stderr = cells[0]["ok"]
    assert rc == 0, stderr[-3000:]
    rec = cells[1][("granite-3-2b", "decode_32k")]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    jc = jget_arch("granite-3-2b")
    shape = JSHAPES["decode_32k"]
    b, s = shape.global_batch, shape.seq_len
    physical = {a: (a,) for a in MESH}
    logical = {k: tuple(v) for k, v in jmultipod_mapping().items()}
    params = _per_device_bytes(
        jax.eval_shape(partial(jinit_params, cfg=jc), jax.random.key(0)),
        jparam_specs(jc, serving=True), physical)
    cache = _per_device_bytes(
        jax.eval_shape(partial(jinit_cache, jc, b, s)),
        jcache_specs(jc, kv_head_shard=jc.n_kv_heads % MESH["model"] == 0),
        logical)
    tokens = _per_device_bytes(jax.ShapeDtypeStruct((b, 1), np.int32),
                               ("batch", None), logical)
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == params + cache + tokens
    assert ma["peak_memory_in_bytes"] >= ma["argument_size_in_bytes"]
    assert rec["cost_analysis"]["flops"] > 0
    ro = rec["roofline"]
    assert ro["flops_per_device"] == rec["cost_analysis"]["flops"]
    assert ro["bottleneck"] in ("compute", "memory", "collective")
    assert set(ro["links"]) == {"data", "model"}
    json.dumps(rec)


@pytest.mark.parametrize("name", list(RECURRENT_CELLS))
def test_recurrent_cell_argument_bytes_equal_the_reference_specs(cells,
                                                                 name):
    rc, stdout, stderr = cells[0][name]
    assert rc == 0, stderr[-3000:]
    arch, shape_name, over = RECURRENT_CELLS[name]
    rec = cells[1][(arch, shape_name)]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    jc = jget_arch(arch).scaled(**over)
    shape = JSHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    seq = shape_name == "long_500k"
    physical = {a: (a,) for a in MESH}
    logical = {k: tuple(v) for k, v in jmultipod_mapping().items()}
    if seq:
        logical["batch"] = ()
    params = _per_device_bytes(
        jax.eval_shape(partial(jinit_params, cfg=jc), jax.random.key(0)),
        _serving_specs(arch, over), physical)
    cache = _per_device_bytes(
        jax.eval_shape(partial(jinit_cache, jc, b, s)),
        jcache_specs(jc, seq_shard=seq, kv_head_shard=not seq and
                     jc.n_kv_heads % MESH["model"] == 0), logical)
    tokens = _per_device_bytes(jax.ShapeDtypeStruct((b, 1), np.int32),
                               ("batch", None), logical)
    ma = rec["memory_analysis"]
    assert ma["argument_size_in_bytes"] == params + cache + tokens
    assert ma["peak_memory_in_bytes"] >= ma["argument_size_in_bytes"]
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def _serving_specs(arch, over):
    """The reference's serving ``param_specs`` (stacked periods) with the
    port's spec (a leading None for the stacked axis) at the leaves where
    the port's serving layout departs."""
    jc = jget_arch(arch).scaled(**over)
    specs = jparam_specs(jc, serving=True)
    port = param_specs(get_arch(arch).scaled(**over), serving=True)
    for i, spec in enumerate(jc.period):
        for part, kind in (("mixer", spec.mixer), ("ffn", spec.ffn)):
            for leaf in SERVING_DEPARTURES.get(kind, ()):
                specs["periods"][f"p{i}"][part][leaf] = {
                    k: jax.sharding.PartitionSpec(None, *v) for k, v in
                    port["layers"][i][part][leaf].items()}
    return specs


def test_sweep_records_a_failed_cell(cells):
    rc, stdout, stderr = cells[0]["bad"]
    assert rc == 1
    assert "1 failed" in stdout
    rec, = cells[1]["bad"]
    assert (rec["arch"], rec["shape"], rec["status"]) == \
        ("granite-3-2b", "prefill_32k", "failed")
    assert "NotImplementedError" in rec["stderr"]
    assert "unevenly" in rec["stderr"]


def test_flash_traces_the_kernel_route_on_meta_tensors():
    """The flash kernel's custom op gives the outputs' shapes on meta
    tensors: a causal S 4096 forward, B 1, 8 / 2 heads of 64, never holds
    an (S, S) float32 tensor (64 MiB a head) as the plain version's
    logits would, and its backward runs on them too."""
    from repro_torch.kernels import dispatch
    q = torch.empty(1, 4096, 8, 64, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k = torch.empty(1, 4096, 2, 64, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    live = dryrun._LiveBytes((q, k))
    with live:
        o = dispatch.flash_attention(q, k, k, causal=True)
    assert o.shape == q.shape and o.device.type == "meta"
    assert live.peak < 4096 * 4096 * 4
    o.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
