"""Multi-device execution over torch.distributed (port of
tempo_tpu/parallel/): a (dp, sp) mesh of ranks, one controller and its
followers (mesh.py, launch.py).

The reference's axes map onto the ranks:

  dp  -- blocks across ranks (the reference's per-block job fan-out)
  sp  -- rows *within* a block across ranks (page sharding)

Collectives (all_reduce / all_gather / reduce_scatter / gather) replace
the reference's result-merging combiners on the host, as its pmax /
psum / psum_scatter / all_gather do. Every program of the reference's
parallel package has its port here: the sharded find (both forms), the
sharded bloom union, mesh-batched search, the sharded metrics fold, the
sharded search (search.py) and the composed query step (step.py).
"""

from .bloom import sharded_bloom_union
from .find import sharded_find, sharded_find_rows, stack_block_ids
from .mesh import DISPATCH_LOCK, Mesh, MeshError, make_mesh
from .multiquery import mesh_batch_eligible, mesh_eval_multiquery
from .search import sharded_search
from .step import distributed_query_step
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
    "sharded_search",
    "distributed_query_step",
]
