// The bloom's three hashes of one trace id on the card, shared by B9b
// (blockcut.cu, a cut's ids into the words) and B10b (bloom.cu, ids
// tested against the words): FNV-1a 32 picks the shard, FNV-1a 64 is h1,
// splitmix64(h1) | 1 is h2, and bit i of the shard is (h1 + i h2) mod
// shard_bits -- tempo_tpu_torch/util/hashing.py (fnv1a_32, bloom_hashes)
// and block/bloom.py, so either side reads the other's bits.
#pragma once

#include <stdint.h>

struct TtBloomHash {
    uint32_t h32;            // FNV-1a 32 of the id's bytes
    unsigned long long h1;   // FNV-1a 64
    unsigned long long h2;   // splitmix64(h1) | 1
};

// The id is the first `len` (0..16) bytes of the 16-byte slot v, byte j
// in bits 8 (j & 3) of word j >> 2 (little-endian); bytes past len are
// not hashed. A call with len = 16 folds to the straight 16-byte loop.
__device__ __forceinline__ TtBloomHash tt_bloom_hash(const uint4 v, int len) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t h32 = 0x811C9DC5u;
    unsigned long long h1 = 0xCBF29CE484222325ull;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        if (j < len) {
            const uint32_t b = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
            h32 = (h32 ^ b) * 0x01000193u;
            h1 = (h1 ^ b) * 0x00000100000001B3ull;
        }
    }
    unsigned long long z = h1 + 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return {h32, h1, (z ^ (z >> 31)) | 1ull};
}
