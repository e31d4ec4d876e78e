"""Distributed serving and training: the mesh's sharding rules and
collectives (``sharding.py``; the serving and the training mappings) and
int8 gradient compression (``compression.py``)."""

from .compression import compress_decompress, compressed_psum, init_error_state
from .sharding import (MeshRules, ProcessMesh, current_rules, fit_spec,
                       mesh_rules, multipod_mapping, serving_mapping,
                       shard_tree, unshard_tree)

__all__ = ["MeshRules", "ProcessMesh", "current_rules", "fit_spec",
           "mesh_rules", "multipod_mapping", "serving_mapping", "shard_tree",
           "unshard_tree", "compress_decompress", "compressed_psum",
           "init_error_state"]
