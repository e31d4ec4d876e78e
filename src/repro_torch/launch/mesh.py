"""Mesh construction over an initialised torch.distributed group.

Port of ``repro.launch.mesh``.  Where the reference lays visible JAX
devices out as a grid, the port lays out the ranks of the default process
group, row-major (the last axis the fastest): on a (data, model) mesh rank
``r`` takes data index ``r // model`` and model index ``r % model``.  Each
tuple of axes gets the process groups of the ranks that share the other
coordinates (one private function, :func:`_grid`, makes every mesh).  The
caller starts the processes, initialises the group and names the backend
("gloo" or "nccl"; the dry-run's "fake"); nothing here picks or switches
one.  With no process group a (1, 1) mesh still builds, and it runs
exactly like no mesh.

* :func:`make_serving_mesh`: the (data, model) mesh of the tensor-
  parallel serving engine, with :func:`serving_rules`;
* :func:`make_production_mesh`: the training and dry-run mesh, (16, 16)
  data x model or (2, 16, 16) pod x data x model, with
  :func:`training_rules` (``sharding.multipod_mapping``).
"""

from __future__ import annotations

import itertools
import math

import torch.distributed as dist

from ..distributed.sharding import (DATA, MODEL, POD, MeshRules, ProcessMesh,
                                    multipod_mapping, serving_mapping)

__all__ = ["make_serving_mesh", "make_production_mesh", "serving_rules",
           "training_rules", "mesh_chips", "mesh_name"]


def _grid(shape: tuple[int, ...], axes: tuple[str, ...],
          backend: str | None = None, what: str = "mesh") -> ProcessMesh:
    """The row-major ``shape`` mesh over the first ``prod(shape)`` ranks.
    Every rank of the job must call it (the subgroups are made
    collectively, every rank entering every ``new_group`` call).  Raises
    RuntimeError when the world is too small, or on a rank past the
    mesh."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    need = math.prod(shape)
    if world < need:
        raise RuntimeError(f"{what} {shape} needs {need} ranks, found "
                           f"{world}")
    if backend is None and init:
        backend = dist.get_backend()
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    coords = tuple((rank // st) % n for st, n in zip(strides, shape))
    groups = {}
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            if math.prod(shape[i] for i in sub) == 1:
                continue
            rest = [i for i in range(len(axes)) if i not in sub]
            # one group for each coordinate of the other axes
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                ranks = sorted(
                    sum(strides[i] * c for i, c in zip(rest, fixed))
                    + sum(strides[i] * c for i, c in zip(sub, free))
                    for free in itertools.product(
                        *(range(shape[i]) for i in sub)))
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups[tuple(axes[i] for i in sub)] = g
    if rank >= need:
        raise RuntimeError(f"rank {rank} lies outside the {shape} {what}")
    return ProcessMesh(shape=tuple(shape), axis_names=tuple(axes),
                       coords=coords, groups=groups, backend=backend)


def make_serving_mesh(model_parallel: int | None = None,
                      data_parallel: int = 1,
                      backend: str | None = None) -> ProcessMesh:
    """The (data, model) mesh over the first ``data_parallel *
    model_parallel`` ranks; ``model_parallel`` defaults to every rank
    after ``data_parallel`` is carved off."""
    if model_parallel is None:
        init = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if init else 1
        model_parallel = max(1, world // data_parallel)
    return _grid((data_parallel, model_parallel), (DATA, MODEL), backend,
                 "serving mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         backend: str | None = None) -> ProcessMesh:
    """(16, 16) data x model on a single pod; (2, 16, 16) pod x data x
    model across two pods, 512 ranks."""
    if multi_pod:
        return _grid((2, 16, 16), (POD, DATA, MODEL), backend,
                     "production mesh")
    return _grid((16, 16), (DATA, MODEL), backend, "production mesh")


def serving_rules(mesh: ProcessMesh) -> MeshRules:
    """:class:`MeshRules` with the serving mapping: what
    ``ServeEngine(mesh=...)`` takes."""
    return MeshRules(mesh=mesh, mapping=serving_mapping())


def training_rules(mesh: ProcessMesh) -> MeshRules:
    """:class:`MeshRules` with the training mapping
    (``sharding.multipod_mapping``): what the sharded train step runs
    under."""
    return MeshRules(mesh=mesh, mapping=multipod_mapping())


def mesh_chips(mesh: ProcessMesh) -> int:
    return mesh.size


def mesh_name(mesh: ProcessMesh) -> str:
    return "x".join(str(s) for s in mesh.shape)
