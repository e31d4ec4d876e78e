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
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np
import torch

from ..tree import tree_map, tree_paths

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
    once the leaves are on the host."""
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


def restore_checkpoint(ckpt_dir: str, step: int, target_tree):
    """Restore into the structure of ``target_tree``: each leaf comes back
    with the target leaf's dtype and device."""
    base = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    paths = iter(k for k, _ in tree_paths(target_tree))

    def load(tgt: torch.Tensor) -> torch.Tensor:
        k = next(paths)
        meta = manifest["leaves"][k]
        arr = np.load(os.path.join(base, meta["file"]))
        if tuple(arr.shape) != tuple(tgt.shape):
            raise ValueError(f"checkpoint leaf {k}: shape {arr.shape} != "
                             f"target {tuple(tgt.shape)}")
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(dtype=tgt.dtype, device=tgt.device)
    return tree_map(load, target_tree)
