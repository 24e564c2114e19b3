"""Distributed bloom union: the compaction collective (port of
tempo_tpu/parallel/bloom.py).

Compacting K blocks unions K same-geometry sharded blooms. The stacked
(K, NS, W) words shard over the mesh by their first axis; every rank ORs
its K / n blooms with B10a, an all_gather over sp then over dp brings
every rank's partial (NCCL has no bitwise-OR reduction, so no
all_reduce), and B10a over the partials gives the union on every rank.
An axis of one rank takes neither its all_gather nor its B10a: a mesh of
one rank makes one B10a a union and no collective.
"""

from __future__ import annotations

import numpy as np

from ..block.bloom import ShardedBloom
from ..ops.bloom_ops import union
from .mesh import DISPATCH_LOCK, program


@program("bloom_union")
def _union_body(mesh, static: dict, ops: dict):
    acc = union(ops["stacked"])  # B10a over this rank's blooms
    # over an axis of one rank the gather holds this rank's partial alone,
    # whose union is itself: no all_gather, no B10a
    if mesh.sp > 1:
        acc = union(mesh.all_gather(acc, "sp"))  # B10a over the sp partials
    if mesh.dp > 1:
        acc = union(mesh.all_gather(acc, "dp"))  # and over the dp partials
    return acc.cpu().numpy()


def sharded_bloom_union(mesh, blooms: list[ShardedBloom]) -> ShardedBloom:
    """Union many same-geometry blooms across the mesh; ValueError on a
    geometry mismatch."""
    first = blooms[0]
    for b in blooms[1:]:
        if b.n_shards != first.n_shards or b.shard_bits != first.shard_bits:
            raise ValueError("bloom geometry mismatch")
    n = mesh.size
    K = ((len(blooms) + n - 1) // n) * n
    stacked = np.zeros((K,) + first.words.shape, dtype=np.uint32)
    for i, b in enumerate(blooms):
        stacked[i] = b.words
    with DISPATCH_LOCK:  # collective programs must not interleave
        words = mesh.run("bloom_union", {}, shard0={"stacked": stacked.view(np.int32)})
    out = ShardedBloom(first.n_shards, first.shard_bits)
    out.words = words.view(np.uint32)
    return out
