"""Hashing primitives for the bloom filters and the ring: FNV-1a picks
the shard and seeds a splitmix64-style double hash for the bit
positions, and FNV-1a over tenant + trace id is a trace's ring token --
the same functions as the JAX package (tempo_tpu/util/hashing.py), so
either package tests the other's bloom objects and places a trace on the
same ingester.
"""

from __future__ import annotations

_FNV32_OFFSET = 0x811C9DC5
_FNV32_PRIME = 0x01000193
_FNV64_OFFSET = 0xCBF29CE484222325
_FNV64_PRIME = 0x00000100000001B3
_MASK32 = 0xFFFFFFFF
_MASK64 = 0xFFFFFFFFFFFFFFFF


def fnv1a_32(data: bytes) -> int:
    h = _FNV32_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV32_PRIME) & _MASK32
    return h


def fnv1a_64(data: bytes) -> int:
    h = _FNV64_OFFSET
    for b in data:
        h ^= b
        h = (h * _FNV64_PRIME) & _MASK64
    return h


def ring_token(tenant: str, trace_id: bytes) -> int:
    """32-bit placement token for a (tenant, trace id) pair: one hash
    over tenant-then-id decides the owning ring segment (the shape of the
    reference's TokenFor, pkg/util/hash.go:7-16)."""
    return fnv1a_32(tenant.encode("utf-8") + trace_id)


def splitmix64(x: int) -> int:
    """One round of the splitmix64 finalizer (public domain constant set)."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & _MASK64


def bloom_hashes(key: bytes, k: int, m_bits: int) -> list[int]:
    """k bit positions for `key` in an m_bits bloom via double hashing.

    h_i = h1 + i*h2 (Kirsch-Mitzenmacher double hashing) keeps this a
    two-hash computation host-side and a pure gather on device.
    """
    h1 = fnv1a_64(key)
    h2 = splitmix64(h1) | 1  # odd => full-period stepping
    return [((h1 + i * h2) & _MASK64) % m_bits for i in range(k)]
