"""Bloom filter kernels (B10): compaction union and batch membership test.

Port of tempo_tpu/ops/bloom_ops.py. When compaction inputs share bloom
geometry, the output block's filter is one elementwise OR over the
stacked (n_blocks, n_shards, words) bits (B10a) instead of re-inserting
every id. B10b tests many ids against one block's full bloom; nothing
calls it on a path of either package (the JAX package's own tests do),
and the port keeps it with its kernel all the same. CUDA tensors go to
the kernels (csrc/bloom.cu), CPU tensors to the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..block.bloom import _K, WORD_BITS, ShardedBloom, shard_for_trace_id
from ..util.hashing import bloom_hashes


def union(stacked: torch.Tensor) -> torch.Tensor:
    """(K, S, W) uint32 bit patterns (int32 storage) -> (S, W) OR."""
    if stacked.device.type == "cuda":
        return kernels.bloom_union(stacked)
    return _union_plain(stacked)


def _union_plain(stacked: torch.Tensor) -> torch.Tensor:
    out = stacked[0].clone()
    for j in range(1, stacked.shape[0]):
        out |= stacked[j]
    return out


def union_blooms(blooms: list[ShardedBloom], device) -> ShardedBloom:
    """Union of same-geometry blooms on `device`; ValueError on a
    geometry mismatch (the caller rebuilds instead)."""
    first = blooms[0]
    for b in blooms[1:]:
        if b.n_shards != first.n_shards or b.shard_bits != first.shard_bits:
            raise ValueError("bloom geometry mismatch")
    return union_planes([b.words for b in blooms], first.n_shards, first.shard_bits, device)


def union_planes(blooms, n_shards: int, shard_bits: int, device) -> ShardedBloom:
    """The OR of K blooms given shard by shard (blooms[k][s] the (W,)
    uint32 words of bloom k's shard s; a (S, W) array serves as well),
    on `device`. Each shard is written once, straight into one (K, S, W)
    host buffer; on a card that buffer is pinned: one upload, one B10a
    launch, one pinned download and one synchronize."""
    device = torch.device(device)
    card = device.type == "cuda"
    sb = ShardedBloom(n_shards, shard_bits)
    host = torch.empty((len(blooms),) + sb.words.shape, dtype=torch.int32, pin_memory=card)
    h = host.numpy().view(np.uint32)
    for k, shards in enumerate(blooms):
        if len(shards) != n_shards:
            raise ValueError(f"bloom {k}: {len(shards)} shards, expected {n_shards}")
        for i, words in enumerate(shards):
            h[k, i] = words
    out = union(host.to(device, non_blocking=True))
    if card:
        back = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        back.copy_(out, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        out = back
    sb.words = out.numpy().view(np.uint32)
    return sb


def bits_set(words: torch.Tensor, word_idx: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    """words (S, W), word_idx (Q, K, 2) [shard, word], bit_idx (Q, K)
    -> (Q,) bool: all K bits set."""
    if words.device.type == "cuda":
        return kernels.bloom_test(words, word_idx, bit_idx)
    return _test_plain(words, word_idx, bit_idx)


def _test_plain(words: torch.Tensor, word_idx: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    s = word_idx[..., 0].clamp(0, words.shape[0] - 1).long()
    w = word_idx[..., 1].clamp(0, words.shape[1] - 1).long()
    gathered = words[s, w].long() & 0xFFFFFFFF
    ok = (bit_idx >= 0) & (bit_idx < WORD_BITS)
    bit = (gathered >> bit_idx.clamp(0, WORD_BITS - 1).long()) & 1
    return (ok & (bit == 1)).all(dim=-1)


def positions(trace_ids: list[bytes], n_shards: int, shard_bits: int):
    """Host side of the test: every id's K (shard, word) pairs and bit
    indexes, (Q, K, 2) and (Q, K) int32."""
    q = len(trace_ids)
    word_idx = np.zeros((q, _K, 2), dtype=np.int32)
    bit_idx = np.zeros((q, _K), dtype=np.int32)
    for i, tid in enumerate(trace_ids):
        shard = shard_for_trace_id(tid, n_shards)
        for j, pos in enumerate(bloom_hashes(tid, _K, shard_bits)):
            word_idx[i, j] = (shard, pos // WORD_BITS)
            bit_idx[i, j] = pos % WORD_BITS
    return word_idx, bit_idx


def batch_test(bloom_words: np.ndarray, shard_bits: int, n_shards: int,
               trace_ids: list[bytes], device) -> np.ndarray:
    """Test many trace ids against a block's full (n_shards, W) bloom.
    The hash positions are computed on the host; the gather and test run
    on `device`."""
    if not trace_ids:
        return np.zeros(0, dtype=bool)
    word_idx, bit_idx = positions(trace_ids, n_shards, shard_bits)
    words = torch.from_numpy(np.ascontiguousarray(bloom_words).view(np.int32))
    return bits_set(words.to(device), torch.from_numpy(word_idx).to(device),
                     torch.from_numpy(bit_idx).to(device)).cpu().numpy()
