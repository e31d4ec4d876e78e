"""Serving mesh construction over an initialised torch.distributed group.

Port of ``repro.launch.mesh``'s serving half.  Where the reference lays
visible JAX devices out as a (data, model) grid, the port lays out the
ranks of the default process group: rank ``r`` takes data index ``r //
model_parallel`` and model index ``r % model_parallel``, and each axis
gets the process groups of the ranks that share the other coordinate.
The caller starts the processes, initialises the group and names the
backend ("gloo" or "nccl"); nothing here picks or switches one.  With
no process group a (1, 1) mesh still builds, and it serves exactly like
no mesh.  ``make_production_mesh`` and the training mesh are not ported
(ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import torch.distributed as dist

from ..distributed.sharding import (DATA, MODEL, MeshRules, ProcessMesh,
                                    serving_mapping)

__all__ = ["make_serving_mesh", "serving_rules", "mesh_chips", "mesh_name"]


def make_serving_mesh(model_parallel: int | None = None,
                      data_parallel: int = 1,
                      backend: str | None = None) -> ProcessMesh:
    """The (data, model) mesh over the first ``data_parallel *
    model_parallel`` ranks; ``model_parallel`` defaults to every rank
    after ``data_parallel`` is carved off.  Every rank of the job must
    call it (the subgroups are made collectively).  Raises RuntimeError
    when the world is too small, or on a rank past the mesh."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if model_parallel is None:
        model_parallel = max(1, world // data_parallel)
    need = data_parallel * model_parallel
    if world < need:
        raise RuntimeError(
            f"serving mesh ({data_parallel}, {model_parallel}) needs "
            f"{need} ranks, found {world}")
    if backend is None and init:
        backend = dist.get_backend()
    groups = {}
    for axis, size in ((DATA, data_parallel), (MODEL, model_parallel)):
        if size == 1:
            groups[axis] = None
            continue
        # every rank enters every new_group call, member or not
        for fixed in range(need // size):
            if axis == MODEL:
                ranks = [fixed * model_parallel + m
                         for m in range(model_parallel)]
            else:
                ranks = [d * model_parallel + fixed
                         for d in range(data_parallel)]
            g = dist.new_group(ranks, backend=backend)
            if rank in ranks:
                groups[axis] = g
    if rank >= need:
        raise RuntimeError(f"rank {rank} lies outside the ({data_parallel}, "
                           f"{model_parallel}) serving mesh")
    return ProcessMesh(shape=(data_parallel, model_parallel),
                       axis_names=(DATA, MODEL),
                       coords=(rank // model_parallel,
                               rank % model_parallel),
                       groups=groups, backend=backend)


def serving_rules(mesh: ProcessMesh) -> MeshRules:
    """:class:`MeshRules` with the serving mapping: what
    ``ServeEngine(mesh=...)`` takes."""
    return MeshRules(mesh=mesh, mapping=serving_mapping())


def mesh_chips(mesh: ProcessMesh) -> int:
    return mesh.size


def mesh_name(mesh: ProcessMesh) -> str:
    return "x".join(str(s) for s in mesh.shape)
