"""Checkpoint store: per-leaf .npy files + a JSON manifest, async + atomic.

Port of ``repro.checkpoint.store`` with the same on-disk layout:
``step_N/manifest.json`` (per leaf: file, shape, dtype, bytes) and
``step_N/proc_0/<leaf path with / as __>.npy``.

* **atomic**: files go to ``step_N.tmp/``, which is renamed to
  ``step_N/`` only after the manifest is fsynced, so a writer killed
  mid-save never leaves a checkpoint that :func:`latest_step` picks up;
* **async**: the device -> host copy happens on the caller's thread, the
  file writes on a background thread; :func:`wait_for_saves` joins them.

numpy has no bfloat16, so a bf16 leaf is written as its uint16 bits with
``"bfloat16"`` in the manifest; a reference checkpoint's bf16 leaves
(ml_dtypes' raw 2-byte records) read back the same way.

* **a mesh**: a tree of blocks (``sharding.shard_tree``) is saved whole:
  every rank takes part in gathering each leaf, and rank 0 writes the
  files, in the same layout;
* **elastic**: :func:`restore_checkpoint` with ``rules`` and ``specs``
  returns this rank's block of each leaf under the current mesh (the
  reference's ``shardings=``), whatever mesh saved it.  A checkpoint the
  reference wrote, its layers stacked over a leading period axis under
  ``periods/p<i>/``, restores into the port's per-layer tree.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..distributed.sharding import current_rules, shard_tree, unshard_tree
from ..tree import tree_leaves, tree_map, tree_paths

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "wait_for_saves"]

_PENDING: list[threading.Thread] = []


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    # a copy even on the CPU: the training step updates leaves in place
    # while the background thread writes
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree, async_: bool = True):
    """Save a tree at ``ckpt_dir/step_{step}``; with ``async_`` it returns
    once the leaves are on the host.  A tree of mesh blocks is gathered
    whole first (every rank must call it) and only rank 0 writes."""
    if current_rules() is not None and any(
            hasattr(v, "mesh_spec") for v in tree_leaves(tree)):
        tree = unshard_tree(tree)
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_rank() != 0:
            return
    host = {k: _to_host(v) for k, v in tree_paths(tree)}

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(os.path.join(tmp, "proc_0"), exist_ok=True)
        manifest = {"step": step, "leaves": {}}
        for k, (v, dtype) in host.items():
            fn = k.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, "proc_0", fn), v)
            manifest["leaves"][k] = {"file": f"proc_0/{fn}",
                                     "shape": list(v.shape),
                                     "dtype": dtype,
                                     "nbytes": int(v.nbytes)}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write()


def wait_for_saves():
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def latest_step(ckpt_dir: str) -> int | None:
    """The newest complete checkpoint's step (``step_N`` holding a
    manifest), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _stacked_key(k: str, manifest: dict) -> tuple[str, int] | None:
    """A reference checkpoint's (key, row) of the port's ``layers/<i>/...``
    leaf: the reference stacks layer ``i`` at row ``i // P`` of
    ``periods/p<i % P>/...``, P the period's length."""
    parts = k.split("/")
    if parts[0] != "layers":
        return None
    period = {key.split("/")[1] for key in manifest["leaves"]
              if key.startswith("periods/")}
    if not period:
        return None
    i, n = int(parts[1]), len(period)
    return "/".join(["periods", f"p{i % n}", *parts[2:]]), i // n


def _spec_paths(specs, prefix: str = "") -> list[tuple[str, tuple]]:
    """``(path, spec)`` pairs of a spec tree, whose leaves are spec tuples
    (a named tuple is a node, as in ``tree_paths``)."""
    if specs is None:
        return []
    if isinstance(specs, tuple) and not hasattr(specs, "_fields"):
        return [(prefix[:-1], specs)]
    if hasattr(specs, "_fields"):
        specs = specs._asdict()
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    return [pair for k, v in items
            for pair in _spec_paths(v, f"{prefix}{k}/")]


def _load_leaf(base: str, meta: dict) -> torch.Tensor:
    arr = np.load(os.path.join(base, meta["file"]))
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(ckpt_dir: str, step: int, target_tree, *,
                       rules=None, specs=None):
    """Restore into the structure of ``target_tree``: each leaf comes back
    with the target leaf's dtype and device.  With ``rules`` (the current
    mesh) and ``specs`` (physical spec tuples mirroring the tree, None for
    a leaf kept whole) each leaf is this rank's block, tagged as
    ``shard_tree`` tags it; the target's leaves may be whole or blocks."""
    base = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    paths = iter(k for k, _ in tree_paths(target_tree))
    leaf_spec = dict(_spec_paths(specs))

    def load(tgt: torch.Tensor) -> torch.Tensor:
        k = next(paths)
        if k in manifest["leaves"]:
            t = _load_leaf(base, manifest["leaves"][k])
        else:
            ref = _stacked_key(k, manifest)
            if ref is None or ref[0] not in manifest["leaves"]:
                raise KeyError(f"checkpoint has no leaf {k}")
            t = _load_leaf(base, manifest["leaves"][ref[0]])[ref[1]]
        whole = tuple(t.shape)
        t = t.to(dtype=tgt.dtype, device=tgt.device)
        if rules is not None:
            t = shard_tree(t, tuple(leaf_spec.get(k) or ()), rules)
        if tuple(tgt.shape) not in (whole, tuple(t.shape)):
            raise ValueError(f"checkpoint leaf {k}: shape {whole} != "
                             f"target {tuple(tgt.shape)}")
        return t
    return tree_map(load, target_tree)
