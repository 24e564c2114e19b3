// B10a/B10b: bloom filter union and batch membership test.
//
// Replaces the two jitted programs of tempo_tpu/ops/bloom_ops.py:
//   B10a :20 _union_kernel  OR-reduce of K stacked (S, W) uint32 blooms
//   B10b :48 _test_kernel   per query, K word gathers, a bit test each,
//                           AND over the K bits (the positions hashed
//                           on the host there; here on the card)
// Both are bound by bytes: the union reads K words and writes one per
// output word; the test reads an id and K words and writes one byte.
#include "bloomhash.cuh"
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

// B10b: many trace ids tested against a block's full bloom in ONE launch,
// the hashing on the card (kernels.bloom_test; ops/bloom_ops.batch_test
// sends the words and the ids end to end in one pinned buffer, or the ids
// alone where the words already lie on the card, and downloads one byte
// an id). One thread an id: one 16-byte load of its zero-padded slot and
// one of its length (0..16), tt_bloom_hash (bloomhash.cuh, B9b's hash)
// over that length; the shard is FNV-1a 32 % n_shards, bit i (i < k) is
// (h1 + i h2) mod shard_bits -- a mask where shard_bits is a power of
// two, a 64-bit % otherwise (util/hashing.bloom_hashes takes any m_bits).
// The k word loads are issued together, then ANDed; one byte is stored.
// The shard row and the word clamp into the words as XLA's gather clamps
// them (the reference's _test_kernel over the host's positions).
//
// Bound: bytes -- 16 B of id, 1 B of length and 1 B out an id, and the
// words read once: a 32-byte sector of each of the k words an id tests,
// never more than the whole bloom (0.66 MB, 0.2 us at 3.35 TB/s, for
// 32,768 ids at k = 7 in one shard of 2^19 bits, whose 64 KB stay in
// L2); the integer work, about 110 operations an id, is about 0.05 us.
// The old kernel took the host's (shard, word) pairs and bit indexes,
// 2 k index loads and k word loads an id one after another.
#define BT_THREADS 256
#define BT_KMAX 8

template <bool POW2>
__global__ void __launch_bounds__(BT_THREADS)
    test_ids_kernel(const uint32_t* __restrict__ words, unsigned n_rows,
                    unsigned long long n_words, const uint4* __restrict__ ids,
                    const uint8_t* __restrict__ lens, int q, unsigned n_shards,
                    unsigned long long shard_bits, int k, uint8_t* __restrict__ out) {
    const int t = blockIdx.x * BT_THREADS + threadIdx.x;
    if (t >= q) return;
    const TtBloomHash h = tt_bloom_hash(__ldg(ids + t), __ldg(lens + t));
    unsigned s = h.h32 % n_shards;
    if (s >= n_rows) s = n_rows - 1;
    const uint32_t* row = words + (unsigned long long)s * n_words;
    uint32_t w[BT_KMAX];
    unsigned b[BT_KMAX];
#pragma unroll
    for (int i = 0; i < BT_KMAX; ++i) {  // every word's load issued first
        w[i] = 0xFFFFFFFFu;
        b[i] = 0;
        if (i < k) {
            const unsigned long long x = h.h1 + (unsigned long long)i * h.h2;
            const unsigned long long pos = POW2 ? (x & (shard_bits - 1)) : x % shard_bits;
            const unsigned long long wi = pos >> 5;
            b[i] = (unsigned)(pos & 31);
            w[i] = __ldg(row + (wi < n_words ? wi : n_words - 1));
        }
    }
    uint32_t all = 1u;
#pragma unroll
    for (int i = 0; i < BT_KMAX; ++i) all &= w[i] >> b[i];
    out[t] = (uint8_t)(all & 1u);
}

// words: n_rows x n_words uint32; ids: q 16-byte slots, 16 B aligned;
// lens: q bytes, each at most 16; out: q bytes (0 or 1).
TT_EXPORT int tt_bloom_test_ids(const uint32_t* words, int n_rows, long long n_words,
                                const void* ids, const uint8_t* lens, int q, int n_shards,
                                long long shard_bits, int k, uint8_t* out, void* stream) {
    if (q < 1 || n_rows < 1 || n_words < 1 || n_shards < 1 || shard_bits < 1 || k < 1 ||
        k > BT_KMAX || (((uintptr_t)ids) & 15))
        return (int)cudaErrorInvalidValue;
    const dim3 grid(tt_blocks(q, BT_THREADS));
    cudaStream_t st = (cudaStream_t)stream;
    if ((shard_bits & (shard_bits - 1)) == 0)
        test_ids_kernel<true><<<grid, BT_THREADS, 0, st>>>(
            words, (unsigned)n_rows, (unsigned long long)n_words, (const uint4*)ids, lens, q,
            (unsigned)n_shards, (unsigned long long)shard_bits, k, out);
    else
        test_ids_kernel<false><<<grid, BT_THREADS, 0, st>>>(
            words, (unsigned)n_rows, (unsigned long long)n_words, (const uint4*)ids, lens, q,
            (unsigned)n_shards, (unsigned long long)shard_bits, k, out);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}
