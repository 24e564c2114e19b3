// B10a/B10b: bloom filter union and batch membership test.
//
// Replaces the two jitted programs of tempo_tpu/ops/bloom_ops.py:
//   B10a :20 _union_kernel  OR-reduce of K stacked (S, W) uint32 blooms
//   B10b :48 _test_kernel   per query, K word gathers, a bit test each,
//                           AND over the K bits
// Both are bound by bytes: the union reads K words and writes one per
// output word; the test reads K words and K (shard, word, bit) triples a
// query and writes one bool.
#include "common.cuh"

// B10a: one thread per output word.
__global__ void union_kernel(const uint32_t* __restrict__ stacked, int k, long long n_words,
                             uint32_t* __restrict__ out) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_words) return;
    uint32_t acc = 0;
    for (int j = 0; j < k; ++j) acc |= stacked[(long long)j * n_words + i];
    out[i] = acc;
}

TT_EXPORT int tt_bloom_union(const uint32_t* stacked, int k, long long n_words, uint32_t* out,
                             void* stream) {
    union_kernel<<<tt_blocks(n_words, 256), 256, 0, (cudaStream_t)stream>>>(stacked, k, n_words,
                                                                            out);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

// B10b: one thread per query. word_idx is (q, k, 2) [shard, word], bit_idx
// (q, k). Indices clamp into the words as XLA's gather clamps them; a bit
// index outside [0, 32) tests 0, as XLA's logical shift by >= 32 gives 0.
__global__ void test_kernel(const uint32_t* __restrict__ words, int n_shards, int n_words,
                            const int32_t* __restrict__ word_idx,
                            const int32_t* __restrict__ bit_idx, int q, int k,
                            uint8_t* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= q) return;
    bool all = true;
    for (int j = 0; j < k; ++j) {
        long long e = (long long)i * k + j;
        int s = tt_clamp(word_idx[2 * e], 0, n_shards - 1);
        int w = tt_clamp(word_idx[2 * e + 1], 0, n_words - 1);
        unsigned b = (unsigned)bit_idx[e];
        uint32_t word = words[(long long)s * n_words + w];
        all = all && b < 32u && ((word >> b) & 1u);
    }
    out[i] = all ? 1 : 0;
}

TT_EXPORT int tt_bloom_test(const uint32_t* words, int n_shards, int n_words,
                            const int32_t* word_idx, const int32_t* bit_idx, int q, int k,
                            uint8_t* out, void* stream) {
    test_kernel<<<tt_blocks(q, 256), 256, 0, (cudaStream_t)stream>>>(words, n_shards, n_words,
                                                                      word_idx, bit_idx, q, k,
                                                                      out);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}
