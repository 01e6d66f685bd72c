"""Gangs of processes over one model (port of substratus_tpu/parallel/):
the rendezvous (distributed.py), the mesh of ranks (mesh.py) and the
logical-axis sharding rules (sharding.py)."""
from substratus_tpu_torch.parallel.mesh import MESH_AXES, Mesh, build_mesh, local_mesh
from substratus_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    SERVE_RULES,
    LogicalRules,
    serve_rules_for,
    shard_params,
    spec_for,
)

__all__ = [
    "MESH_AXES",
    "Mesh",
    "build_mesh",
    "local_mesh",
    "LogicalRules",
    "DEFAULT_RULES",
    "SERVE_RULES",
    "serve_rules_for",
    "shard_params",
    "spec_for",
]
