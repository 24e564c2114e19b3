"""Sharded trace-ID lookup: the multi-device Find (port of
tempo_tpu/parallel/find.py).

Every rank holds a slice of the stacked per-block sorted trace-id
indexes (blocks over the flattened (dp, sp) axis: rank r holds blocks
r * Bl .. (r + 1) * Bl - 1) and runs K3's batched bisection locally.

  * `sharded_find_rows`: every block reports its own hit row; a gather
    lands the (B, Q) rows on the controller for the partial-trace
    combiner (the service path: TempoDB._device_find, the find batcher).
  * `sharded_find`: per query the (global block, row) hit. One launch
    on each rank (M1 fused with K3) searches its blocks and keeps, per
    query, the max of the int64 key (block << 32) | row (-1 for a miss);
    one all_reduce MAX over the world elects the mesh's highest block
    holding the id together with that block's row, the pair the
    reference's two pmax stages (over sp, then dp, twice) return. MAX is
    associative and commutative, so one collective over every rank
    equals the reference's sp-then-dp pair, in one round trip. Misses
    are (-1, -1).
"""

from __future__ import annotations

import numpy as np

from ..ops.device import PAD_I32, bucket, pad_rows
from ..ops.find import bisect_rows, decode_keys, find_elect
from .mesh import DISPATCH_LOCK, program

_ID_PAD = np.int32(2**31 - 1)


def stack_block_ids(id_code_arrays: list[np.ndarray],
                    n_shards: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Stack per-block sorted id-code arrays (Ti, 4) into (B, T, 4) padded
    for an n_shards-way mesh: T = common power-of-two bucket, B padded to a
    multiple of n_shards with empty blocks. Returns (ids, n_valid, T)."""
    B = len(id_code_arrays)
    T = bucket(max([a.shape[0] for a in id_code_arrays] + [1]))
    Bp = ((B + n_shards - 1) // n_shards) * n_shards if B else n_shards
    ids = np.full((Bp, T, 4), _ID_PAD, dtype=np.int32)
    n_valid = np.zeros((Bp,), dtype=np.int32)
    for i, a in enumerate(id_code_arrays):
        ids[i, : a.shape[0]] = a
        n_valid[i] = a.shape[0]
    return ids, n_valid, T


def _operands(mesh, id_code_arrays, query_codes):
    ids, n_valid, T = stack_block_ids(id_code_arrays, mesh.size)
    queries = pad_rows(np.asarray(query_codes, np.int32), bucket(query_codes.shape[0]), PAD_I32)
    return {"queries": queries}, {"ids": ids, "n_valid": n_valid}, T


@program("find_rows")
def _find_rows_body(mesh, static: dict, ops: dict):
    rows = bisect_rows(ops["ids"], ops["queries"], ops["n_valid"], static["n_steps"])  # K3
    out = mesh.gather0(rows)
    return None if out is None else out.reshape(-1, rows.shape[1]).cpu().numpy()


@program("find")
def _find_body(mesh, static: dict, ops: dict):
    base = mesh.rank * ops["ids"].shape[0]
    keys = find_elect(ops["ids"], ops["queries"], ops["n_valid"], static["n_steps"],
                      base)  # K3 and M1, one launch
    return decode_keys(mesh.all_reduce(keys, "max").cpu().numpy())


def sharded_find_rows(mesh, id_code_arrays: list[np.ndarray],
                      query_codes: np.ndarray) -> np.ndarray:
    """Host entry for the per-block-rows Find. Returns (B, Q) int32
    row-in-block (-1 miss), B = len(id_code_arrays)."""
    q = query_codes.shape[0]
    if not id_code_arrays or q == 0:
        return np.full((len(id_code_arrays), q), -1, dtype=np.int32)
    bcast, shard0, T = _operands(mesh, id_code_arrays, query_codes)
    with DISPATCH_LOCK:  # collective programs must not interleave
        out = mesh.run("find_rows", {"n_steps": int(T).bit_length()}, bcast=bcast, shard0=shard0)
    return out[: len(id_code_arrays), :q]


def sharded_find(mesh, id_code_arrays: list[np.ndarray], query_codes: np.ndarray) -> np.ndarray:
    """Host entry: look up Q trace ids across many blocks on the mesh.
    Returns (Q, 2) int32 [block, row] (-1, -1 on a miss)."""
    q = query_codes.shape[0]
    if not id_code_arrays or q == 0:
        return np.full((q, 2), -1, dtype=np.int32)
    bcast, shard0, T = _operands(mesh, id_code_arrays, query_codes)
    with DISPATCH_LOCK:  # collective programs must not interleave
        out = mesh.run("find", {"n_steps": int(T).bit_length()}, bcast=bcast, shard0=shard0)
    out = out[:q].astype(np.int32, copy=True)
    out[out[:, 0] < 0] = -1  # normalize misses to (-1, -1)
    return out
