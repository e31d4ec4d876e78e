"""Distributed serving and training: the (data, model) mesh's sharding
rules and collectives (``sharding.py``) and int8 gradient compression
(``compression.py``)."""

from .compression import compress_decompress, compressed_psum, init_error_state
from .sharding import (MeshRules, ProcessMesh, current_rules, fit_spec,
                       mesh_rules, serving_mapping, shard_tree)

__all__ = ["MeshRules", "ProcessMesh", "current_rules", "fit_spec",
           "mesh_rules", "serving_mapping", "shard_tree",
           "compress_decompress", "compressed_psum", "init_error_state"]
