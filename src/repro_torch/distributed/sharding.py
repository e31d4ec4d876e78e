"""Logical-axis sharding over a torch.distributed (data, model) mesh.

Port of ``repro.distributed.sharding`` as explicit SPMD: one process a
rank, each holding only its block of a sharded tensor, every rank running
the same program.  Model code names *logical* axes ("batch", "model",
"expert", "seq", "fsdp") and the active :class:`MeshRules` resolves them
to the physical axes of a :class:`ProcessMesh`, as in the reference.

Where the reference pins an activation with ``constrain(x, None, ...)``
and lets GSPMD insert the collective, the port writes the collective
out: :func:`gather` concatenates the blocks of every rank of one mesh
axis along one dimension, an exact copy (raw bits through the process
group: bfloat16, int8 and ``-0.0`` come back as they went).  Nothing
here sums across ranks, so a sharded run can equal an unsharded one bit
for bit.

* :func:`shard_tree` returns this rank's block of every leaf of a whole
  tree under a spec tree, each dimension cut by :func:`fit_spec` (a dim
  the axis does not divide stays whole), and records the fitted spec on
  the block (:func:`spec_of`), so that the layers know which of their
  outputs come out sharded;
* :func:`cols` puts the last axis of a product in the layout a layer
  asks for: this rank's block of it (the heads, channels or experts a
  rank owns) or all of it, gathering or slicing as the weight's spec
  says;
* :func:`split_lanes` splits a step's lanes over the "data" axis in
  contiguous blocks (:func:`lane_slice`); :func:`gather_lanes` puts
  them back together.

With no rules active every helper is the identity, so the same model
code runs unsharded.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch


__all__ = ["ProcessMesh", "MeshRules", "mesh_rules", "current_rules",
           "serving_mapping", "fit_spec", "shard_tree", "spec_of",
           "is_sharded", "axis_size", "axis_index", "block", "splits",
           "gather", "cols", "split_lanes", "lane_slice", "gather_lanes"]

MODEL, DATA = "model", "data"


@dataclass(frozen=True, eq=False)
class ProcessMesh:
    """A (data, model) grid of torch.distributed ranks, row-major: rank
    ``r`` of the mesh sits at data index ``r // model`` and model index
    ``r % model``.  ``groups`` holds, for each axis, the process group of
    the ranks that share this rank's other coordinate (None for an axis
    of size 1); ``backend`` is the groups' backend ("gloo" or "nccl")."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]
    groups: dict
    backend: str | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)] \
            if name in self.axis_names else 1

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)] \
            if name in self.axis_names else 0


@dataclass(frozen=True, eq=False)
class MeshRules:
    """A mesh and the logical -> physical axis mapping (the serving
    mapping by default: the port has no training mesh)."""
    mesh: ProcessMesh
    mapping: dict = field(default_factory=lambda: serving_mapping())

    def resolve(self, logical) -> tuple:
        """Logical axis names (or None) -> one physical spec entry a
        dimension: None, an axis name, or a tuple of them."""
        parts = []
        for ax in logical:
            phys = () if ax is None else tuple(
                a for a in self.mapping.get(ax, ())
                if a in self.mesh.axis_names)
            parts.append(None if not phys
                         else phys[0] if len(phys) == 1 else phys)
        return tuple(parts)


_ACTIVE: list[MeshRules] = []


@contextlib.contextmanager
def mesh_rules(rules: MeshRules | None):
    """Make ``rules`` the active rules inside the block (None: no mesh)."""
    if rules is None:
        yield None
        return
    _ACTIVE.append(rules)
    try:
        yield rules
    finally:
        _ACTIVE.pop()


def current_rules() -> MeshRules | None:
    return _ACTIVE[-1] if _ACTIVE else None


def serving_mapping() -> dict:
    """The tensor-parallel serving mapping: weights resident over "model"
    (output channels and experts), "batch" over "data", and the
    training-only axes ("fsdp", "seq") on nothing."""
    return {"batch": (DATA,), "model": (MODEL,), "expert": (MODEL,),
            "fsdp": (), "seq": ()}


def _names(ax) -> tuple:
    return () if ax is None else ax if isinstance(ax, tuple) else (ax,)


def fit_spec(spec: tuple, shape, mesh: ProcessMesh) -> tuple:
    """Drop the spec axes a concrete shape cannot take on this mesh: a
    dimension keeps its axes only if they all exist and their sizes'
    product divides it (a 2-KV-head pool on a 4-way "model" axis stays
    whole on that dimension)."""
    parts = []
    for i in range(len(shape)):
        ax = spec[i] if i < len(spec) else None
        names = _names(ax)
        total = math.prod(mesh.axis_size(a) for a in names)
        ok = bool(names) and all(a in mesh.axis_names for a in names) \
            and shape[i] % total == 0
        parts.append(ax if ok else None)
    return tuple(parts)


def _block_index(names: tuple, mesh: ProcessMesh) -> tuple[int, int]:
    """(this rank's block, the number of blocks) of a dimension cut over
    the axes ``names``, the first axis the slowest."""
    idx, total = 0, 1
    for a in names:
        idx = idx * mesh.axis_size(a) + mesh.axis_index(a)
        total *= mesh.axis_size(a)
    return idx, total


def _local(x: torch.Tensor, spec: tuple, mesh: ProcessMesh) -> torch.Tensor:
    out = x
    for dim, ax in enumerate(spec):
        names = _names(ax)
        if not names:
            continue
        i, n = _block_index(names, mesh)
        step = x.shape[dim] // n
        out = out.narrow(dim, i * step, step)
    # a fresh tensor, never a view that would keep the whole leaf alive
    out = out.clone(memory_format=torch.contiguous_format)
    out.mesh_spec = spec
    return out


def shard_tree(tree, spec_tree, rules: MeshRules, logical: bool = False):
    """This rank's block of every leaf of ``tree`` (whole tensors, the
    same on every rank) under ``spec_tree``: the same structure with
    physical spec tuples at the leaves (``logical=False``, the
    ``param_specs`` convention) or logical-axis tuples resolved through
    ``rules`` (``logical=True``, the ``paged_cache_specs`` convention);
    None for a leaf kept whole.  Every spec goes through
    :func:`fit_spec`.  Each block is a fresh tensor carrying its fitted
    spec (:func:`spec_of`); a leaf kept whole is copied too.  A leaf
    that is a block already stays as it is: sharding twice is sharding
    once."""
    def put(x, spec):
        if hasattr(x, "mesh_spec"):        # a block already
            return x
        spec = () if spec is None else tuple(spec)
        if logical:
            spec = rules.resolve(spec)
        return _local(x, fit_spec(spec, x.shape, rules.mesh), rules.mesh)

    def walk(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, None if s is None else s[k])
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not isinstance(t, torch.Tensor):
            return [walk(v, None if s is None else s[i])
                    for i, v in enumerate(t)]
        return put(t, s)
    return walk(tree, spec_tree)


def spec_of(t: torch.Tensor) -> tuple:
    """The fitted spec :func:`shard_tree` cut ``t`` by (() if none)."""
    return getattr(t, "mesh_spec", ())


def is_sharded(t: torch.Tensor, dim: int, axis: str = MODEL) -> bool:
    """Is dimension ``dim`` of ``t`` cut over ``axis`` (a mesh axis of
    size > 1, under the active rules)?"""
    spec = spec_of(t)
    if not spec or current_rules() is None:
        return False
    ax = spec[dim % len(spec)]
    return axis in _names(ax) and axis_size(axis) > 1


def axis_size(axis: str = MODEL) -> int:
    rules = current_rules()
    return 1 if rules is None else rules.mesh.axis_size(axis)


def axis_index(axis: str = MODEL) -> int:
    rules = current_rules()
    return 0 if rules is None else rules.mesh.axis_index(axis)


def splits(n: int, axis: str = MODEL) -> bool:
    """Does ``axis`` (of size > 1) cut a dimension of ``n`` into equal
    blocks?  The layers' rule for what a rank owns: the heads, channels
    or experts of a dimension the axis splits, every one otherwise."""
    k = axis_size(axis)
    return k > 1 and n % k == 0


def block(n: int, axis: str = MODEL) -> slice:
    """This rank's block of a dimension of ``n`` under :func:`splits`
    (all of it when the axis does not split it)."""
    if not splits(n, axis):
        return slice(None)
    step = n // axis_size(axis)
    i = axis_index(axis)
    return slice(i * step, (i + 1) * step)


def gather(x: torch.Tensor, axis: str = MODEL, dim: int = -1
           ) -> torch.Tensor:
    """Concatenate the ``x`` of every rank of mesh axis ``axis`` (in axis
    order; the same shape on every rank) along ``dim``: the collective
    the reference's ``constrain`` to replicated stands for.  The bytes
    travel as uint8 (gloo gathers no 16-bit integers), so the result is
    an exact copy whatever the dtype, ``-0.0`` included.  A gloo group
    takes CUDA tensors through host memory (gloo gathers host tensors
    only); NCCL gathers on the card."""
    rules = current_rules()
    n = axis_size(axis)
    if rules is None or n == 1:
        return x
    group = rules.mesh.groups[axis]
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    staged = rules.mesh.backend == "gloo" and raw.is_cuda
    if staged:
        # gloo gathers host tensors only (NCCL gathers on the card)
        raw = raw.cpu()  # lint: host-ok: gloo stages through the host
    parts = [torch.empty_like(raw) for _ in range(n)]
    torch.distributed.all_gather(parts, raw, group=group)
    out = torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                    dim=dim)
    return out.to(x.device) if staged else out


def cols(y: torch.Tensor, w: torch.Tensor, local: bool,
         axis: str = MODEL, w_dim: int = -1, y_dim: int = -1
         ) -> torch.Tensor:
    """``y`` (whose dimension ``y_dim`` is the output dimension ``w_dim``
    of the weight ``w`` that produced it) in the layout asked for: this
    rank's block of that dimension (``local``) or all of it.  A sharded
    ``w`` gives the block, which :func:`gather` completes; a whole ``w``
    gives all of it, which :func:`block` cuts."""
    sharded = is_sharded(w, w_dim, axis)
    if local:
        if sharded:
            return y
        sl = [slice(None)] * y.ndim
        sl[y_dim] = block(y.shape[y_dim], axis)
        return y[tuple(sl)]
    return gather(y, axis, y_dim) if sharded else y


# -- the step's lanes over "data" -----------------------------------------

_LANES: list[slice | None] = []


@contextlib.contextmanager
def split_lanes(n: int):
    """Inside the block a step of ``n`` lanes runs this data rank's
    contiguous block of them, when the "data" axis splits ``n``
    (:func:`lane_slice`); otherwise every data rank runs all of them."""
    _LANES.append(block(n, DATA) if splits(n, DATA) else None)
    try:
        yield lane_slice()
    finally:
        _LANES.pop()


def lane_slice() -> slice:
    return (_LANES[-1] if _LANES else None) or slice(None)


def gather_lanes(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """All lanes of a lane-split step from this data rank's block (the
    identity when the step's lanes are not split)."""
    if not _LANES or _LANES[-1] is None:
        return x
    return gather(x, DATA, dim)
