"""Sharded bloom filter over trace IDs.

Same role as the reference's ShardedBloomFilter (common/bloom.go:20-93):
the find-by-ID fast path tests ONE shard (selected by a hash of the
trace id) so a lookup fetches bloom_shard_size bytes, not the whole
filter. Bits live in a flat uint32 array, bit-identical to the JAX package's
filter, so either package reads the other's bloom objects. Inserts and
tests here are pure Python / numpy (the JAX package's fallbacks of its
native helpers); a block cut sets its bits with the B9b kernel
(ops/blockcut.py) and compaction unions filters with B10a
(ops/bloom_ops.py).

Shard count is derived from the expected item count and target false
positive rate, like the reference sizes shards from fp+shard size.
"""

from __future__ import annotations

import math

import numpy as np

from ..util.hashing import bloom_hashes, fnv1a_32

WORD_BITS = 32
DEFAULT_FP_RATE = 0.01
SHARD_SIZE_BYTES = 100 * 1024  # reference default bloom shard size ~100KiB
_K = 7  # hash count; ~optimal for 10 bits/item


def shard_for_trace_id(trace_id: bytes, n_shards: int) -> int:
    return fnv1a_32(trace_id) % n_shards


def shard_count(expected_items: int, fp_rate: float = DEFAULT_FP_RATE) -> int:
    """Shards so that each holds <= SHARD_SIZE_BYTES of bits at ~10 bits/item."""
    if expected_items <= 0:
        return 1
    bits_per_item = max(1.0, -math.log(max(fp_rate, 1e-9)) / (math.log(2) ** 2))
    total_bits = expected_items * bits_per_item
    return max(1, math.ceil(total_bits / (SHARD_SIZE_BYTES * 8)))


class ShardedBloom:
    def __init__(self, n_shards: int, shard_bits: int = SHARD_SIZE_BYTES * 8):
        # power-of-two bits per shard keeps device-side modulo a mask
        self.shard_bits = 1 << (shard_bits - 1).bit_length()
        self.n_shards = n_shards
        self.words = np.zeros((n_shards, self.shard_bits // WORD_BITS), dtype=np.uint32)

    @classmethod
    def for_estimated_items(cls, n: int, fp_rate: float = DEFAULT_FP_RATE) -> "ShardedBloom":
        shards = shard_count(n, fp_rate)
        per_shard = max(1, n // shards)
        bits_per_item = max(1.0, -math.log(max(fp_rate, 1e-9)) / (math.log(2) ** 2))
        bits = max(1024, int(per_shard * bits_per_item))
        return cls(shards, bits)

    def add(self, trace_id: bytes) -> None:
        shard = shard_for_trace_id(trace_id, self.n_shards)
        for pos in bloom_hashes(trace_id, _K, self.shard_bits):
            self.words[shard, pos // WORD_BITS] |= np.uint32(1 << (pos % WORD_BITS))

    def add_many(self, trace_ids: list[bytes]) -> None:
        for tid in trace_ids:
            self.add(tid)

    def add_array(self, ids: np.ndarray) -> None:
        """Insert a (n, 16) uint8 id array."""
        ids = np.ascontiguousarray(ids, dtype=np.uint8)
        if ids.size:
            self.add_many([ids[i].tobytes() for i in range(ids.shape[0])])

    def test(self, trace_id: bytes) -> bool:
        shard = shard_for_trace_id(trace_id, self.n_shards)
        return self.test_shard(self.words[shard], trace_id)

    def test_shard(self, shard_words: np.ndarray, trace_id: bytes) -> bool:
        for pos in bloom_hashes(trace_id, _K, self.shard_bits):
            if not (int(shard_words[pos // WORD_BITS]) >> (pos % WORD_BITS)) & 1:
                return False
        return True

    # ---- serialization: one object per shard, like the reference's
    # bloom-0..bloom-N block objects
    def shard_bytes(self, shard: int) -> bytes:
        return self.words[shard].tobytes()

    @classmethod
    def shard_from_bytes(cls, data: bytes) -> np.ndarray:
        return np.frombuffer(data, dtype=np.uint32)

    @staticmethod
    def positions(trace_id: bytes, shard_bits: int) -> list[int]:
        return bloom_hashes(trace_id, _K, shard_bits)


def union_shards(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Host-side union; compaction unions on the device instead
    (ops/bloom_ops.union_blooms)."""
    return np.bitwise_or(a, b)
