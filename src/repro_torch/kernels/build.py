"""Build, load and launch the port's CUDA kernels.

The sources in ``csrc/`` are plain CUDA C++ with a C interface: no
PyTorch header is involved, so ``nvcc`` takes seconds, not minutes.  At
the first CUDA call :func:`library` compiles every ``csrc/*.cu`` to an
object file (one ``nvcc`` per source, all started together), links them
into one shared library for ``sm_90a``, caches it under ``_build/`` keyed
by a hash of the sources and flags, and loads it with ``ctypes``.  On a
machine with CUDA a missing ``nvcc`` or a failed build raises: nothing
falls back to the plain PyTorch versions.  Importing this module touches
neither the compiler nor the card.

:func:`launch` is the one place a kernel is started: it calls the C entry
point (which returns ``cudaGetLastError()`` after its launch, or refuses
arguments its kernel cannot take, such as a shared-memory layout above
what a block has), raises on a non-zero code with the entry point's
message, and adds one to that kernel's count in :data:`LAUNCHES`.

Each wrapper's launch is also a ``torch.library`` custom op
(:func:`kernel_op`) with a shape function beside it: a call on plain
CUDA tensors runs the launch directly, past the op's dispatcher and its
host time, and a call on meta tensors (the dry-run's full-size trace,
which holds no data; :func:`on_card`) or fake tensors goes through the
op and gets its outputs' shapes without building or launching anything,
so the trace follows the kernel route, not the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

__all__ = ["KERNELS", "LAUNCHES", "GEOMETRY_FIELDS", "BuildResult", "build",
           "library", "launch", "geometry", "reset_launches", "stream_of",
           "kernel_op", "on_card"]

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# "ternary_matmul_batched" counts the ternary matmul's launches that hold
# a batch of products (the MoE experts'), "ternary_matmul" the single ones
KERNELS = ("approx_bsn", "approx_bsn_temporal", "paged_attn_decode",
           "paged_attn_prefill", "ternary_matmul", "ternary_matmul_batched",
           "bsn_sort", "flash_attention")
# launches of each kernel since the last reset_launches()
LAUNCHES: dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_G = ctypes.POINTER(ctypes.c_longlong)
# what a ``*_geometry`` entry point writes (csrc/common.cuh's Geometry)
GEOMETRY_FIELDS = ("kernel", "grid_x", "grid_y", "grid_z", "threads",
                   "smem", "splits", "per_split", "block", "combine_grid",
                   "combine_threads")
_SIGNATURES = {
    # counts, out, rows, width, cycles, in_bsl, stages (group, clip,
    # stride)*n, n_stages, stream
    "approx_bsn_launch": [_P, _P, _I, _I, _I, _I, ctypes.POINTER(_I), _I,
                          _P],
    # q, k, v, k_scale, v_scale, k_resid, v_resid, tables, lengths, out,
    # scratch, S, Hkv, G, D, page, maxp, q_dtype, kv_kind, stream
    "paged_attn_decode_launch": [_P] * 11 + [_I] * 8 + [_P],
    # positions one decode split / keys one prefill split cover (they
    # size the scratch of the split partials)
    "paged_attn_decode_split_tokens": [],
    # q, k, v, k_scale, v_scale, k_resid, v_resid, tables, out, scratch,
    # G, C, Hkv, Gq, D, page, width, start, block_q, n_pages, q_dtype,
    # kv_kind, stream
    "paged_attn_prefill_launch": [_P] * 10 + [_I] * 12 + [_P],
    "paged_attn_prefill_split_tokens": [],
    # x, w, thresholds (or null), out, batch, M, N, K, out_bsl, stream
    "ternary_matmul_launch": [_P] * 4 + [_I] * 5 + [_P],
    # in, out, rows, L, dtype code, descending, stream
    "bsn_sort_launch": [_P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, lse, B, S, Hq, Hkv, D, scale, causal, dtype, stream
    "flash_attention_launch": [_P] * 5 + [_I] * 5
                              + [ctypes.c_float, _I, _I, _P],
    # the launches' geometry for the sizes of their launch's arguments:
    # S, Hkv, G, D, page, maxp, q_dtype, kv_kind, out
    "paged_attn_decode_geometry": [_I] * 8 + [_G],
    # G, C, Hkv, Gq, D, page, width, start, block_q, q_dtype, kv_kind, out
    "paged_attn_prefill_geometry": [_I] * 11 + [_G],
    # batch, M, N, K, out_bsl (0: no SI epilogue), out
    "ternary_matmul_geometry": [_I] * 5 + [_G],
    # rows, width, cycles, in_bsl, stages, n_stages, out
    "approx_bsn_geometry": [_I] * 4 + [ctypes.POINTER(_I), _I, _G],
    # rows, L, dtype code, out
    "bsn_sort_geometry": [_I] * 3 + [_G],
    # B, S, Hq, Hkv, D, dtype code, out
    "flash_attention_geometry": [_I] * 6 + [_G],
}


@dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float          # 0.0 when the cached library was reused
    log: str                # nvcc / ptxas output (registers, spills)


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_entries: dict[str, ctypes._CFuncPtr] = {}     # bound once, by name


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def build() -> BuildResult:
    """Compile ``csrc/*.cu`` into the cached shared library (or reuse it,
    with the log its build left beside it)."""
    so = BUILD_DIR / f"repro_kernels_{_digest()}.so"
    if so.exists():
        log = so.with_suffix(".log")
        return BuildResult(so, 0.0, log.read_text() if log.exists() else "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", *(str(o) for _, o, _ in jobs), "-o",
             str(tmp_so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode:
            raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
        tmp_log = tmp_so.with_suffix(".log")
        tmp_log.write_text("\n".join(logs))
        os.replace(tmp_log, so.with_suffix(".log"))
        os.replace(tmp_so, so)      # atomic: concurrent builds agree
    return BuildResult(so, time.perf_counter() - t0, "\n".join(logs))


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_kernels_error_string.argtypes = [ctypes.c_int]
    lib.repro_kernels_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(build().path)
        return _lib


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` and count one launch of ``kernel``."""
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries.setdefault(entry, getattr(library(), entry))
    rc = fn(*args)
    if rc != 0:
        msg = library().repro_kernels_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: launch failed ({rc}: {msg})")
    LAUNCHES[kernel] += 1


def geometry(entry: str, *args) -> dict[str, int]:
    """What C entry point ``entry`` (a ``*_geometry``) reports for a
    launch's sizes: its grid, block, shared memory and splits, one value a
    name of :data:`GEOMETRY_FIELDS`.  Raises on the refusal the launch
    would make; counts no launch."""
    fn = _entries.get(entry)
    if fn is None:
        fn = _entries.setdefault(entry, getattr(library(), entry))
    out = (ctypes.c_longlong * len(GEOMETRY_FIELDS))()
    rc = fn(*args, out)
    if rc != 0:
        msg = library().repro_kernels_error_string(rc).decode()
        raise RuntimeError(f"{entry}: refused ({rc}: {msg})")
    return dict(zip(GEOMETRY_FIELDS, (int(v) for v in out)))


def on_card(t: torch.Tensor) -> bool:
    """Does ``t`` take a kernel's route: a CUDA tensor, or a meta tensor
    standing for one in the dry-run's trace (PyTorch's CPU build runs no
    autograd on fake CUDA tensors, so the trace runs on meta)?"""
    return t.is_cuda or t.is_meta


def kernel_op(name: str, fake):
    """Register the decorated function (a wrapper's allocation and launch,
    its arguments annotated) as the custom op ``repro_torch::<name>``,
    with ``fake`` (same arguments) giving its outputs on fake tensors.
    The decorated name calls the function itself when every tensor
    argument is a plain tensor with storage, the op otherwise."""
    def wrap(fn):
        op = torch.library.custom_op(f"repro_torch::{name}", fn,
                                     mutates_args=())
        op.register_fake(fake)

        @functools.wraps(fn)
        def call(*args):
            if all(type(a) is torch.Tensor and not a.is_meta
                   for a in args if isinstance(a, torch.Tensor)):
                return fn(*args)
            return op(*args)
        return call
    return wrap


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
