"""Logical-axis sharding over a torch.distributed mesh of any number of
axes: (data, model) for serving, (data, model) or (pod, data, model) for
training.

Port of ``repro.distributed.sharding`` as explicit SPMD: one process a
rank, each holding only its block of a sharded tensor, every rank running
the same program.  Model code names *logical* axes ("batch", "model",
"expert", "seq", "fsdp", "zero") and the active :class:`MeshRules`
resolves them to the physical axes of a :class:`ProcessMesh`, as in the
reference (:func:`serving_mapping`, :func:`multipod_mapping`).

Where the reference pins an activation with ``constrain`` and lets GSPMD
insert the collective, the port writes the collective out.  Each one is
a ``torch.autograd.Function`` over the process group of the ranks that
share this rank's coordinates off the named axes (a logical axis that
resolves to two physical axes gets one group over the ranks of both):

* :func:`gather` concatenates the blocks of every rank of the axes along
  one dimension, an exact copy (raw bits through the process group:
  bfloat16, int8 and ``-0.0`` come back as they went); its gradient is
  the reduce-scatter (sum) of the incoming gradient, the FSDP gradient
  of a weight gathered at use;
* :func:`psum` all-reduces (sums) over the axes; its gradient is the
  incoming one, as the row-parallel products and the loss's reductions
  over the batch want it (the gradient downstream is the same on every
  rank);
* :func:`sum_grads` is the identity whose gradient is all-reduced: what
  enters a column-parallel product or a rank's own experts from the
  replicated residual stream collects the gradient of every rank's block.

Serving sums across no rank: its layers only :func:`gather`, so a
sharded serving run equals an unsharded one bit for bit.  Training sums
(the row-parallel products, the vocabulary-parallel loss, the
reduce-scatter of the FSDP gradients), so the training mesh agrees with
the unsharded step within a tolerance, not bit for bit.

* :func:`shard_tree` returns this rank's block of every leaf of a whole
  tree under a spec tree, each dimension cut by :func:`fit_spec` (a dim
  the axes do not divide stays whole), and records the fitted spec on
  the block (:func:`spec_of`), so that the layers know which of their
  inputs and outputs come sharded; :func:`unshard_tree` puts the whole
  leaves back together;
* :func:`cols` puts the last axis of a serving product in the layout a
  layer asks for: this rank's block of it (the heads, channels or experts
  a rank owns) or all of it, gathering or slicing as the weight's spec
  says;
* :func:`split_lanes` splits a serving step's lanes over the "data" axis
  in contiguous blocks (:func:`lane_slice`); :func:`gather_lanes` puts
  them back together;
* :func:`wire_log` records the bytes each collective brings a rank, by
  mesh axes (``analysis/op_cost.py`` reads it).

With no rules active every helper is the identity, so the same model
code runs unsharded.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch


__all__ = ["ProcessMesh", "MeshRules", "mesh_rules", "current_rules",
           "serving_mapping", "multipod_mapping", "fit_spec", "shard_tree",
           "unshard_tree", "spec_of", "is_sharded", "cut_axes", "axis_size",
           "axis_index", "block", "splits", "gather", "psum", "sum_grads",
           "pmax", "cols", "split_lanes", "lane_slice", "gather_lanes",
           "fsdp_active", "batch_axes", "wire_log"]

POD, DATA, MODEL = "pod", "data", "model"


@dataclass(frozen=True, eq=False)
class ProcessMesh:
    """A grid of torch.distributed ranks, row-major: the last axis is the
    fastest, so on a (data, model) mesh rank ``r`` sits at data index
    ``r // model`` and model index ``r % model``.  ``groups`` holds, for
    each tuple of axes (in mesh order) whose sizes multiply past 1, the
    process group of the ranks that share this rank's coordinates on the
    other axes; ``backend`` is the groups' backend ("gloo", "nccl", or
    "fake" for the dry-run)."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    coords: tuple[int, ...]
    groups: dict
    backend: str | None = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, name) -> int:
        """The size of an axis, or the product of a tuple's (1 for an
        axis the mesh lacks)."""
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in _names(name) if a in self.axis_names)

    def axis_index(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)] \
            if name in self.axis_names else 0

    def group(self, names):
        """The process group over ``names`` (an axis or a tuple), None
        when their sizes multiply to 1."""
        key = tuple(a for a in self.axis_names if a in _names(names))
        return self.groups.get(key)


@dataclass(frozen=True, eq=False)
class MeshRules:
    """A mesh and the logical -> physical axis mapping (the serving
    mapping by default; :func:`multipod_mapping` for training)."""
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


def multipod_mapping() -> dict:
    """The training mapping (the reference's): the batch over every data
    axis ("pod" and "data"), FSDP and sequence over "data", ZeRO over
    both, "model" and the experts over "model".  On a mesh without a
    "pod" axis it is the single-pod mapping."""
    return {"batch": (POD, DATA), "fsdp": (DATA,), "zero": (POD, DATA),
            "seq": (DATA,), "model": (MODEL,), "expert": (MODEL,)}


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


def unshard_tree(tree):
    """The whole leaves of a tree of blocks (each gathered over the axes
    its :func:`spec_of` names, dimension by dimension); a leaf that is
    no block comes back as it is."""
    def whole(x):
        if not isinstance(x, torch.Tensor):
            return x
        for dim, ax in enumerate(spec_of(x)):
            if _names(ax):
                x = gather(x, ax, dim)
        return x

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not isinstance(t, torch.Tensor):
            out = [walk(v) for v in t]
            return type(t)(*out) if hasattr(t, "_fields") else out
        return whole(t)
    with torch.no_grad():
        return walk(tree)


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


def cut_axes(t: torch.Tensor, dim: int) -> tuple:
    """The mesh axes that cut dimension ``dim`` of ``t`` under the active
    rules (``()`` when it is whole on every rank)."""
    spec = spec_of(t)
    if not spec or current_rules() is None:
        return ()
    names = _names(spec[dim % len(spec)])
    return names if axis_size(names) > 1 else ()


def axis_size(axis=MODEL) -> int:
    """The size of a mesh axis (or the product of a tuple's) under the
    active rules; 1 without rules."""
    rules = current_rules()
    return 1 if rules is None else rules.mesh.axis_size(axis)


def axis_index(axis=MODEL) -> int:
    """This rank's index on a mesh axis, or its block index over a tuple
    of axes (the first the slowest)."""
    rules = current_rules()
    return 0 if rules is None else _block_index(_names(axis), rules.mesh)[0]


def fsdp_active() -> bool:
    """Do the active rules map "fsdp" onto the mesh (a training mapping:
    weights cut over "data" are gathered at use, the batch is cut over
    the batch axes)?"""
    rules = current_rules()
    return rules is not None and rules.resolve(("fsdp",)) != (None,)


def batch_axes() -> tuple:
    """The physical axes "batch" resolves to under the active rules."""
    rules = current_rules()
    return () if rules is None else _names(rules.resolve(("batch",))[0])


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


# -- the collectives ------------------------------------------------------

_WIRE: list[list] = []


@contextlib.contextmanager
def wire_log():
    """Inside the block every collective appends (kind, axes, bytes it
    brings this rank) to the yielded list: a ring all-gather or
    reduce-scatter over n ranks moves (n - 1) / n of the whole tensor, an
    all-reduce twice that."""
    log: list = []
    _WIRE.append(log)
    try:
        yield log
    finally:
        _WIRE.pop()


def _record(kind: str, names: tuple, nbytes: float) -> None:
    for log in _WIRE:
        log.append((kind, names, float(nbytes)))


def _group(names: tuple):
    """(mesh, process group, ranks) of the axes ``names`` under the active
    rules, or None when they hold one rank."""
    rules = current_rules()
    n = axis_size(names)
    if rules is None or n == 1:
        return None
    return rules.mesh, rules.mesh.group(names), n


def _staged(mesh: ProcessMesh, t: torch.Tensor) -> bool:
    """gloo takes host tensors only: a CUDA tensor goes through the host
    (NCCL collects on the card)."""
    return mesh.backend == "gloo" and t.is_cuda


def _all_gather(x: torch.Tensor, names: tuple, dim: int) -> torch.Tensor:
    mesh, group, n = _group(names)
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    staged = _staged(mesh, raw)
    if staged:
        raw = raw.cpu()  # lint: host-ok: gloo stages through the host
    parts = [torch.empty_like(raw) for _ in range(n)]
    torch.distributed.all_gather(parts, raw, group=group)
    _record("all_gather", names, raw.numel() * (n - 1))
    out = torch.cat([p.view(x.dtype).reshape(x.shape) for p in parts],
                    dim=dim)
    return out.to(x.device) if staged else out


def _all_reduce(x: torch.Tensor, names: tuple) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``names``, a new tensor."""
    mesh, group, n = _group(names)
    staged = _staged(mesh, x)
    buf = x.detach().to("cpu") if staged else x.detach().clone()
    torch.distributed.all_reduce(buf, group=group)
    _record("all_reduce", names,
            2 * buf.numel() * buf.element_size() * (n - 1) / n)
    return buf.to(x.device) if staged else buf


def _reduce_scatter(g: torch.Tensor, names: tuple, dim: int
                    ) -> torch.Tensor:
    """This rank's block (along ``dim``) of the sum of ``g`` over the
    ranks of ``names``."""
    mesh, group, n = _group(names)
    k = g.shape[dim] // n
    i = _block_index(names, mesh)[0]
    if mesh.backend == "nccl":
        full = g.movedim(dim, 0).contiguous()
        out = torch.empty((k, *full.shape[1:]), dtype=g.dtype,
                          device=g.device)
        torch.distributed.reduce_scatter_tensor(out, full, group=group)
        _record("reduce_scatter", names,
                full.numel() * full.element_size() * (n - 1) / n)
        return out.movedim(0, dim)
    # gloo (and the dry-run's fake group): the whole sum, then the block;
    # priced as the reduce-scatter it stands for
    staged = _staged(mesh, g)
    buf = g.detach().to("cpu") if staged else g.detach().contiguous().clone()
    torch.distributed.all_reduce(buf, group=group)
    _record("reduce_scatter", names,
            buf.numel() * buf.element_size() * (n - 1) / n)
    out = buf.narrow(dim, i * k, k)
    return out.to(g.device) if staged else out.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names, dim):
        ctx.names, ctx.dim = names, dim
        return _all_gather(x, names, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.names, ctx.dim), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        return _all_reduce(x, names)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, names):
        ctx.names = names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.names), None


def gather(x: torch.Tensor, axis=MODEL, dim: int = -1) -> torch.Tensor:
    """Concatenate the ``x`` of every rank of mesh axis ``axis`` (an axis
    or a tuple of them, the first the slowest; the same shape on every
    rank) along ``dim``: the collective the reference's ``constrain`` to
    replicated stands for.  The bytes travel as uint8 (gloo gathers no
    16-bit integers), so the result is an exact copy whatever the dtype,
    ``-0.0`` included.  Its gradient is the reduce-scatter (sum) of the
    incoming gradient over the same ranks."""
    names = _names(axis)
    if _group(names) is None:
        return x
    return _Gather.apply(x, names, dim % x.ndim)


def psum(x: torch.Tensor, axis=MODEL) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (an axis or a tuple),
    on every one of them; its gradient is the incoming gradient."""
    names = _names(axis)
    if _group(names) is None:
        return x
    return _Psum.apply(x, names)


def pmax(x: torch.Tensor, axis=MODEL) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks of ``axis`` (no
    gradient)."""
    names = _names(axis)
    g = _group(names)
    if g is None:
        return x
    mesh, group, n = g
    staged = _staged(mesh, x)
    buf = x.detach().to("cpu") if staged else x.detach().clone()
    torch.distributed.all_reduce(buf, op=torch.distributed.ReduceOp.MAX,
                                 group=group)
    _record("all_reduce", names,
            2 * buf.numel() * buf.element_size() * (n - 1) / n)
    return buf.to(x.device) if staged else buf


def sum_grads(x: torch.Tensor, axis=MODEL) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the ranks of ``axis``:
    what enters a rank's block of a sharded computation from a replicated
    value."""
    names = _names(axis)
    if _group(names) is None:
        return x
    return _SumGrads.apply(x, names)


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
