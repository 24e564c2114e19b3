"""Multi-device execution over torch.distributed (port of
tempo_tpu/parallel/): a (dp, sp) mesh of ranks, one controller and its
followers (mesh.py, launch.py).

The reference's axes map onto the ranks:

  dp  -- blocks across ranks (the reference's per-block job fan-out)
  sp  -- rows *within* a block across ranks (page sharding)

Collectives (all_reduce / all_gather / gather) replace the reference's
result-merging combiners on the host, as its pmax / psum / all_gather
do. The sharded search and the distributed query step of the reference
are not ported yet.
"""

from .bloom import sharded_bloom_union
from .find import sharded_find, sharded_find_rows, stack_block_ids
from .mesh import DISPATCH_LOCK, Mesh, MeshError, make_mesh
from .multiquery import mesh_batch_eligible, mesh_eval_multiquery
from .timeseries import sharded_timeseries

__all__ = [
    "DISPATCH_LOCK",
    "Mesh",
    "MeshError",
    "make_mesh",
    "sharded_find",
    "sharded_find_rows",
    "stack_block_ids",
    "sharded_bloom_union",
    "mesh_batch_eligible",
    "mesh_eval_multiquery",
    "sharded_timeseries",
]
