// B9a/B9b/B9c: the block cut's device steps (a block's finalize).
//
// Replaces the three jitted programs of tempo_tpu/ops/blockcut.py:
//   B9a :54-58   _compiled_remap    gather every code through the
//                                   dictionary's sort permutation
//   B9b :89-134 _bloom_scatter,     hash every trace id to its bits (on
//       _compiled_bloom             the host there) and OR them into the
//                                   bloom's words: here all on the card
//   B9c :149-158 _compiled_rowgroup per row group, min/max of start_ms and
//                                   max of dur_us
// The XLA programs pad to power-of-two buckets; these kernels take the
// true lengths and produce the same values. All three are bound by bytes:
// each reads its inputs once and writes its outputs once.
#include "common.cuh"

// B9a: every code column of a cut through one table in ONE launch
// (kernels.remap_many; kernels.remap_codes is the same kernel with one
// segment). The columns arrive end to end in one buffer (one upload);
// segment j is codes [off[j], off[j + 1]), the bounds by value. Negative
// codes (absent / sentinel) pass through; a code past the table clamps to
// its last entry, so the kernel never reads outside the table (a cut
// never makes such a code).
//
// Bound: bytes -- 8 B a code (read once, written once) and the table once.
// The table is read at random, so it is kept close: the shared route
// copies it into each CTA's shared memory (cp.async, 16 B at a time)
// while it fits RM_SMEM_MAX, the l2 route reads it through the read-only
// path (kernels.remap_plan, a pure function of its size). The codes
// stream: a thread takes a quad (4 codes from a multiple of 4, one 16 B
// load and store) and RM_UNROLL of them in flight; a quad that a
// segment's start or end cuts (or codes off a 16 B boundary) goes code by
// code. The grid is sized to the card (co-resident CTAs), fewer where the
// codes are few, so that a CTA copies the table once for many quads.
#define RM_THREADS 512
#define RM_SEGS 64                 // kernels.py REMAP_SEGS
#define RM_UNROLL 2
#define RM_QUADS_CTA (RM_THREADS * RM_UNROLL)  // quads a CTA takes at least
#define RM_SMEM_MAX (192 * 1024)   // kernels.py REMAP_SMEM_MAX

struct RemapArgs {
    const int32_t* codes;
    int32_t* out;
    const int32_t* table;
    int r, n_seg, vec;             // vec: codes and out 16 B aligned
    int off[RM_SEGS + 1];          // segment j: codes [off[j], off[j + 1])
    int quad[RM_SEGS + 1];         // quads before segment j
};

template <bool SMEM>
__device__ __forceinline__ int rm_one(const int32_t* tab, int r, int c) {
    if (c < 0) return c;
    const int i = c < r ? c : r - 1;
    return SMEM ? tab[i] : __ldg(tab + i);
}

// route: SMEM (the table in shared memory) or l2
template <bool SMEM>
__global__ void __launch_bounds__(RM_THREADS) remap_kernel(const __grid_constant__ RemapArgs a) {
    extern __shared__ __align__(16) int32_t s_tab[];
    const int r = a.r, tid = threadIdx.x;
    if (SMEM) {
        int i = tid;
        if ((((uintptr_t)a.table) & 15) == 0) {
            for (int j = 4 * tid; j + 4 <= r; j += 4 * RM_THREADS)
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                                 (unsigned)__cvta_generic_to_shared(s_tab + j)),
                             "l"(a.table + j));
            i = (r & ~3) + tid;  // the last r % 4 entries
        }
        for (; i < r; i += RM_THREADS) tt_copy4(s_tab + i, a.table + i);
        tt_copy_wait();
        __syncthreads();
    }
    const int32_t* tab = SMEM ? s_tab : a.table;
    const int nq = a.quad[a.n_seg], stride = gridDim.x * RM_THREADS;
    for (int q0 = blockIdx.x * RM_THREADS + tid; q0 < nq; q0 += RM_UNROLL * stride) {
        int4 x[RM_UNROLL];
        int e0[RM_UNROLL], lo[RM_UNROLL], hi[RM_UNROLL];
        bool whole[RM_UNROLL];
#pragma unroll
        for (int u = 0; u < RM_UNROLL; ++u) {  // every whole quad's load issued first
            const int q = q0 + u * stride;
            whole[u] = false;
            lo[u] = hi[u] = e0[u] = 0;
            if (q >= nq) continue;
            int j = 0, top = a.n_seg - 1;  // the last segment whose quads start at or before q
            while (j < top) {
                const int mid = (j + top + 1) >> 1;
                if (a.quad[mid] <= q) j = mid;
                else top = mid - 1;
            }
            lo[u] = a.off[j];
            hi[u] = a.off[j + 1];
            e0[u] = (lo[u] & ~3) + 4 * (q - a.quad[j]);
            whole[u] = a.vec && e0[u] >= lo[u] && e0[u] + 4 <= hi[u];
            if (whole[u]) x[u] = __ldcs((const int4*)(a.codes + e0[u]));
        }
#pragma unroll
        for (int u = 0; u < RM_UNROLL; ++u) {
            if (whole[u]) {
                const int4 y = make_int4(rm_one<SMEM>(tab, r, x[u].x), rm_one<SMEM>(tab, r, x[u].y),
                                         rm_one<SMEM>(tab, r, x[u].z), rm_one<SMEM>(tab, r, x[u].w));
                __stcs((int4*)(a.out + e0[u]), y);
            } else {
                for (int e = max(e0[u], lo[u]); e < min(e0[u] + 4, hi[u]); ++e)
                    a.out[e] = rm_one<SMEM>(tab, r, a.codes[e]);
            }
        }
    }
}

static int rm_attrs_set = 0;
static int rm_sms = 0;

// codes: the segments end to end; offs: n_seg + 1 bounds (host memory),
// 0 = offs[0] <= ... <= offs[n_seg]; route 0 l2, 1 shared.
TT_EXPORT int tt_remap_many(const int32_t* codes, const int* offs, int n_seg,
                            const int32_t* table, int r, int route, int32_t* out, void* stream) {
    if (n_seg < 1 || n_seg > RM_SEGS || r < 1 || offs[0] != 0 || route < 0 || route > 1 ||
        (route == 1 && 4LL * r > RM_SMEM_MAX))
        return (int)cudaErrorInvalidValue;
    RemapArgs a{codes, out, table, r, n_seg,
                (((uintptr_t)codes) & 15) == 0 && (((uintptr_t)out) & 15) == 0};
    a.quad[0] = 0;
    for (int j = 0; j < n_seg; ++j) {
        const int lo = offs[j], hi = offs[j + 1];
        if (hi < lo) return (int)cudaErrorInvalidValue;
        a.off[j] = lo;
        a.quad[j + 1] = a.quad[j] + (hi > lo ? ((hi + 3) >> 2) - (lo >> 2) : 0);
    }
    a.off[n_seg] = offs[n_seg];
    cudaError_t e = cudaSuccess;
    if (!rm_attrs_set) {
        int dev;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&rm_sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaFuncSetAttribute(remap_kernel<true>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, RM_SMEM_MAX)))
            return (int)e;
        rm_attrs_set = 1;
    }
    const int smem = route == 1 ? ((4 * r + 15) & ~15) : 0;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route == 1 ? (const void*)remap_kernel<true> : (const void*)remap_kernel<false>,
        RM_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    const int nq = a.quad[n_seg];
    const int want = (nq + RM_QUADS_CTA - 1) / RM_QUADS_CTA;
    const int card = (per_sm > 1 ? per_sm : 1) * rm_sms;
    const int ctas = want < 1 ? 1 : want < card ? want : card;
    cudaStream_t st = (cudaStream_t)stream;
    if (route == 1)
        remap_kernel<true><<<ctas, RM_THREADS, smem, st>>>(a);
    else
        remap_kernel<false><<<ctas, RM_THREADS, 0, st>>>(a);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

// B9b: the bloom of a cut in ONE launch, the hashing on the card
// (kernels.bloom_bits; CutEngine.bloom_bits uploads the words and the
// ids in one pinned buffer, the words straight into the output, and
// downloads the words once). One thread an id: FNV-1a 32 of its 16 bytes
// picks the shard (% n_shards, any count), FNV-1a 64 is h1, splitmix64(h1)
// | 1 is h2, and bit i (i < k) is (h1 + i h2) & (shard_bits - 1) of that
// shard (tempo_tpu_torch/util/hashing.py, block/bloom.py; shard_bits is
// a power of two, so the modulo is a mask). Each bit is atomicOr'ed into
// flat word (shard shard_bits + pos) / 32 of the words in place; a word
// past the end is dropped, as XLA's scatter drops it. An OR needs no
// dedupe: the host's set of distinct (word, bit) pairs and its 3
// uploads, the copy kernel and the OR kernel went.
//
// Bound: bytes -- 16 B an id read, each word read and written once (0.66
// MB, 0.20 us at 3.35 TB/s, for a cut's 32,768 ids and 16,384 words);
// the integer work, about 110 operations an id, is under 0.1 us. A
// cut's words (64 KB a shard) stay in L2, so the 7 atomics an id are
// served there; the id load is one 16 B read-only load.
__global__ void __launch_bounds__(256) bloom_ids_kernel(const uint4* __restrict__ ids, int n_ids,
                                                        unsigned n_shards,
                                                        unsigned long long shard_bits, int k,
                                                        uint32_t* __restrict__ words,
                                                        unsigned long long n_words) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_ids) return;
    const uint4 v = __ldg(ids + t);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t h32 = 0x811C9DC5u;
    unsigned long long h1 = 0xCBF29CE484222325ull;
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // byte j of the id (little-endian words)
        const uint32_t b = (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
        h32 = (h32 ^ b) * 0x01000193u;
        h1 = (h1 ^ b) * 0x00000100000001B3ull;
    }
    unsigned long long z = h1 + 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    const unsigned long long h2 = (z ^ (z >> 31)) | 1ull;
    const unsigned long long base = (unsigned long long)(h32 % n_shards) * shard_bits;
    const unsigned long long mask = shard_bits - 1;
    for (int i = 0; i < k; ++i) {
        const unsigned long long bit = base + ((h1 + (unsigned long long)i * h2) & mask);
        if ((bit >> 5) < n_words) atomicOr(words + (bit >> 5), 1u << (unsigned)(bit & 31));
    }
}

// words: n_words uint32, ORed in place; ids: n_ids x 16 bytes, 16 B
// aligned; shard_bits a power of two.
TT_EXPORT int tt_bloom_bits(uint32_t* words, long long n_words, const void* ids, int n_ids,
                            int n_shards, long long shard_bits, int k, void* stream) {
    if (n_words < 1 || n_ids < 1 || n_shards < 1 || k < 1 || shard_bits < 1 ||
        (shard_bits & (shard_bits - 1)) || (((uintptr_t)ids) & 15))
        return (int)cudaErrorInvalidValue;
    bloom_ids_kernel<<<tt_blocks(n_ids, 256), 256, 0, (cudaStream_t)stream>>>(
        (const uint4*)ids, n_ids, (unsigned)n_shards, (unsigned long long)shard_bits, k, words,
        (unsigned long long)n_words);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}

// B9c: one block per row group. Groups are the contiguous ranges
// [g * group, min((g + 1) * group, n)), every one non-empty, so no group
// id array and no trash segment exist. Each thread folds a strided slice,
// then warps fold by shuffles and the block through shared memory.
#define RG_THREADS 512

__device__ __forceinline__ void rg_fold(int& lo, int& hi, int& du, int lo2, int hi2, int du2) {
    lo = min(lo, lo2);
    hi = max(hi, hi2);
    du = max(du, du2);
}

__global__ void rowgroup_kernel(const int32_t* __restrict__ start_ms,
                                const int32_t* __restrict__ dur_us, int n, int group,
                                int32_t* __restrict__ out, int n_groups) {
    __shared__ int s_lo[RG_THREADS / 32], s_hi[RG_THREADS / 32], s_du[RG_THREADS / 32];
    int g = blockIdx.x;
    long long a = (long long)g * group;
    long long b = a + group < n ? a + group : n;
    int lo = INT32_MAXV, hi = PAD_I32, du = PAD_I32;
    for (long long i = a + threadIdx.x; i < b; i += blockDim.x) {
        int s = start_ms[i];
        rg_fold(lo, hi, du, s, s, dur_us[i]);
    }
    for (int off = 16; off > 0; off >>= 1)
        rg_fold(lo, hi, du, __shfl_down_sync(0xffffffffu, lo, off),
                __shfl_down_sync(0xffffffffu, hi, off), __shfl_down_sync(0xffffffffu, du, off));
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        s_lo[warp] = lo;
        s_hi[warp] = hi;
        s_du[warp] = du;
    }
    __syncthreads();
    if (warp == 0) {
        int nw = blockDim.x >> 5;
        lo = lane < nw ? s_lo[lane] : INT32_MAXV;
        hi = lane < nw ? s_hi[lane] : PAD_I32;
        du = lane < nw ? s_du[lane] : PAD_I32;
        for (int off = 16; off > 0; off >>= 1)
            rg_fold(lo, hi, du, __shfl_down_sync(0xffffffffu, lo, off),
                    __shfl_down_sync(0xffffffffu, hi, off),
                    __shfl_down_sync(0xffffffffu, du, off));
        if (lane == 0) {
            out[g] = lo;
            out[n_groups + g] = hi;
            out[2 * n_groups + g] = du;
        }
    }
}

// out: (3, n_groups) int32 rows [start_ms min | start_ms max | dur_us max]
TT_EXPORT int tt_rowgroup(const int32_t* start_ms, const int32_t* dur_us, int n, int group,
                          int32_t* out, int n_groups, void* stream) {
    rowgroup_kernel<<<n_groups, RG_THREADS, 0, (cudaStream_t)stream>>>(start_ms, dur_us, n, group,
                                                                       out, n_groups);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}
