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

// B10a: the OR of K planes of n_words words (a (K, S, W) stack, S x W =
// n_words) in ONE launch (kernels.bloom_union; ops/bloom_ops.union_planes
// writes every input's shards into one pinned buffer and uploads it
// once). Bound: bytes -- each input word read once, each output word
// written once ((K + 1) x 4 B an output word: 7.9 MB, 2.35 us at 3.35
// TB/s, for 4 x 12 x 32,768 words). A thread takes a quad of 4 output
// words: the K planes' 16-byte loads issued together (BU_CHUNK of them
// unrolled, a loop over the chunks past that), then one 16-byte store.
// Where n_words is not a multiple of 4 (plane k's quads would then sit
// off 16 bytes for some k) or a pointer is off a 16-byte boundary, the
// same loop takes one word an item. The grid is sized to the card and
// strides over the items. The loads and the store are evict-first: the
// words are read once, and with cold inputs that measured 4.6 us against
// 5.4 for default-cached ones, the same warm (scripts/rowgroup_union_ab.py
// --split). The old kernel took a word a thread with K 4-byte loads.
#define BU_THREADS 128
#define BU_CHUNK 8

__device__ __forceinline__ void bu_or(uint4& acc, const uint4& v) {
    acc.x |= v.x;
    acc.y |= v.y;
    acc.z |= v.z;
    acc.w |= v.w;
}
__device__ __forceinline__ void bu_or(uint32_t& acc, const uint32_t& v) { acc |= v; }

// items of T (a quad or a word), n_items a plane; the planes n_items apart
template <typename T>
__device__ __forceinline__ void bu_items(const T* __restrict__ in, int k, long long n_items,
                                         T* __restrict__ out) {
    const long long stride = (long long)gridDim.x * BU_THREADS;
    for (long long i = (long long)blockIdx.x * BU_THREADS + threadIdx.x; i < n_items;
         i += stride) {
        T acc = {};
        for (int k0 = 0; k0 < k; k0 += BU_CHUNK) {
            T v[BU_CHUNK];
#pragma unroll
            for (int u = 0; u < BU_CHUNK; ++u)  // the chunk's loads issued first
                if (k0 + u < k) v[u] = __ldcs(in + (long long)(k0 + u) * n_items + i);
#pragma unroll
            for (int u = 0; u < BU_CHUNK; ++u)
                if (k0 + u < k) bu_or(acc, v[u]);
        }
        __stcs(out + i, acc);
    }
}

__global__ void __launch_bounds__(BU_THREADS)
    union_kernel(const uint32_t* __restrict__ stacked, int k, long long n_words, int vec,
                 uint32_t* __restrict__ out) {
    if (vec)
        bu_items((const uint4*)stacked, k, n_words >> 2, (uint4*)out);
    else
        bu_items(stacked, k, n_words, out);
}

static int bu_sms = 0, bu_per_sm = 0;

TT_EXPORT int tt_bloom_union(const uint32_t* stacked, int k, long long n_words, uint32_t* out,
                             void* stream) {
    if (k < 1 || n_words < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSuccess;
    if (!bu_sms) {
        int dev;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&bu_sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bu_per_sm, union_kernel,
                                                               BU_THREADS, 0)))
            return (int)e;
    }
    const int vec = (n_words & 3) == 0 && (((uintptr_t)stacked) & 15) == 0 &&
                    (((uintptr_t)out) & 15) == 0;
    const long long items = vec ? n_words >> 2 : n_words;
    const long long want = (items + BU_THREADS - 1) / BU_THREADS;
    const long long card = (long long)(bu_per_sm > 1 ? bu_per_sm : 1) * bu_sms;
    const int ctas = (int)(want < card ? want : card);
    union_kernel<<<ctas, BU_THREADS, 0, (cudaStream_t)stream>>>(stacked, k, n_words, vec, out);
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
