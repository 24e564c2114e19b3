"""Batched trace-ID lookup (port of tempo_tpu/ops/find.py).

Q query ids against B blocks' sorted 128-bit trace-id indexes, ids as 4
order-preserving int32 lanes (block/schema.trace_id_to_codes). All
queries step through the log2(T) bisection together. CUDA tensors run
kernel K3 (csrc/find.cu): a warp per (block, query) searching 32 rows a
step, equal to the bisection on a sorted index (the contract in the
source); CPU tensors run `_bisect_plain`, the reference's lockstep
bisection written in torch.
The sharded find's election (M1, `find_elect`, in the same source) runs
K3's search and elects, in the same launch, each query's highest hit
block with its row as one packed int64 key, (block << 32) | row, -1 for
a miss; parallel/find.py puts one all_reduce MAX after it, and
`decode_keys` unpacks the keys.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import bucket, pad_rows, resolve_device

_ID_PAD = np.int32(2**31 - 1)  # +max rows sort after every real id


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rowwise a < b for (..., 4) int32 lanes, lexicographic."""
    lt = a < b
    eq = a == b
    return lt[..., 0] | (
        eq[..., 0] & (lt[..., 1] | (eq[..., 1] & (lt[..., 2] | (eq[..., 2] & lt[..., 3]))))
    )


def _bisect_plain(ids: torch.Tensor, queries: torch.Tensor, n_valid: torch.Tensor,
                  n_steps: int) -> torch.Tensor:
    """Plain version of K3: ids (B,T,4), queries (Q,4), n_valid (B,) ->
    (B,Q) int32 row or -1 (bisect_ids, vmapped over blocks)."""
    B, T, _ = ids.shape
    Q = queries.shape[0]
    lo = torch.zeros((B, Q), dtype=torch.int32, device=ids.device)
    hi = n_valid.to(torch.int32)[:, None].expand(B, Q).clone()
    rows = torch.arange(B, device=ids.device)[:, None]
    for _ in range(n_steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        mid_ids = ids[rows, torch.clamp(mid, 0, T - 1).long()]
        less = _lex_less(mid_ids, queries[None])
        lo = torch.where(less, mid + 1, lo)
        hi = torch.where(less, hi, mid)
    found = ids[rows, torch.clamp(lo, 0, T - 1).long()]
    ok = (lo < n_valid[:, None]) & torch.all(found == queries[None], dim=-1)
    return torch.where(ok, lo, -1).to(torch.int32)


def bisect_rows(ids: torch.Tensor, queries: torch.Tensor, n_valid: torch.Tensor,
                n_steps: int) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if ids.device.type == "cpu":
        return _bisect_plain(ids, queries, n_valid, n_steps)
    from .. import kernels

    return kernels.find_rows(ids, queries, n_valid, n_steps)


def _device_ids(blk, device: torch.device) -> tuple[torch.Tensor, int]:
    """Padded (T,4) copy of a block's sorted id codes on `device`, cached
    on the (immutable) block object: repeated finds skip the upload."""
    cache = blk.__dict__.setdefault("_dev_ids", {})
    a = blk.trace_index["trace.id_codes"]
    n = int(a.shape[0])
    hit = cache.get(str(device))
    if hit is not None and hit[1] == n:
        return hit
    ids = pad_rows(np.asarray(a, dtype=np.int32), bucket(max(n, 1)), _ID_PAD)
    hit = (torch.from_numpy(np.array(ids, dtype=np.int32)).to(device), n)
    cache[str(device)] = hit
    return hit


def lookup_ids_blocks_cached(blocks: list, query_codes: np.ndarray, device) -> np.ndarray:
    """Multi-block lookup over the blocks' cached device indexes. On a
    card, ONE K3 launch (kernels.find_blocks) searches every block's own
    (T_b,4) index through a descriptor a block, the queries riding in the
    launch's parameter: nothing is stacked or uploaded, and the (B, Q)
    rows come back in one read. On the CPU the plain version bisects one
    (B,T,4) stack (pad rows +max). Returns (B, Q) int32 row-in-block (-1
    miss). Every block reports its own hit row, so callers combine
    partial traces (the reference's Find fan-out + combiner,
    tempodb/tempodb.go:271-352)."""
    dev = resolve_device(device)
    B, q = len(blocks), query_codes.shape[0]
    if B == 0 or q == 0:
        return np.full((B, q), -1, dtype=np.int32)
    per = [_device_ids(b, dev) for b in blocks]
    T = max(int(t.shape[0]) for t, _ in per)
    if dev.type == "cuda":
        from .. import kernels

        return kernels.find_blocks(per, query_codes, int(T).bit_length()).cpu().numpy()
    ids = torch.full((B, T, 4), int(_ID_PAD), dtype=torch.int32, device=dev)
    for i, (t, _) in enumerate(per):
        ids[i, : t.shape[0]] = t
    n_valid = torch.tensor([n for _, n in per], dtype=torch.int32, device=dev)
    queries = torch.from_numpy(np.ascontiguousarray(query_codes, np.int32))
    return _bisect_plain(ids, queries, n_valid, int(T).bit_length()).numpy()


def _find_elect_plain(rows: torch.Tensor, base: int) -> torch.Tensor:
    """Plain version of M1: rows (Bl, Q) are K3's hits of the global
    blocks base .. base + Bl - 1 -> (Q,) int64, per query the max of the
    key (block << 32) | row over the blocks with a hit, -1 where none:
    the highest block holding the id and its row, the pair the
    reference's two pmax stages elect (tempo_tpu/parallel/find.py:44-64)."""
    gblock = base + torch.arange(rows.shape[0], dtype=torch.int64, device=rows.device)[:, None]
    return torch.where(rows >= 0, (gblock << 32) | rows.to(torch.int64), -1).amax(dim=0)


def find_elect(ids: torch.Tensor, queries: torch.Tensor, n_valid: torch.Tensor, n_steps: int,
               base: int) -> torch.Tensor:
    """K3 and M1 in one kernel launch on CUDA tensors (ids (Bl,T,4) of the
    global blocks base .. base + Bl - 1), the plain versions on CPU
    tensors: (Q,) int64 packed keys."""
    if ids.device.type == "cpu":
        return _find_elect_plain(_bisect_plain(ids, queries, n_valid, n_steps), base)
    from .. import kernels

    return kernels.find_elect(ids, queries, n_valid, n_steps, base)


def decode_keys(keys: np.ndarray) -> np.ndarray:
    """(Q,) int64 packed keys -> (Q, 2) int32 [block, row]: the block is
    the high word (arithmetic shift), the row the low word as int32; a
    miss (-1) decodes to (-1, -1)."""
    keys = np.asarray(keys, np.int64)
    return np.stack([(keys >> 32).astype(np.int32),
                     (keys & 0xFFFFFFFF).astype(np.uint32).view(np.int32)], axis=-1)
