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
#include <cooperative_groups.h>

#include "bloomhash.cuh"
#include "common.cuh"

namespace cg = cooperative_groups;

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
// downloads the words once). One thread an id, hashed over its 16 bytes
// by tt_bloom_hash (bloomhash.cuh, shared with B10b): FNV-1a 32 picks the
// shard (% n_shards, any count), FNV-1a 64 is h1, splitmix64(h1) | 1 is
// h2, and bit i (i < k) is (h1 + i h2) & (shard_bits - 1) of that
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
    const TtBloomHash h = tt_bloom_hash(__ldg(ids + t), 16);
    const unsigned long long base = (unsigned long long)(h.h32 % n_shards) * shard_bits;
    const unsigned long long mask = shard_bits - 1;
    for (int i = 0; i < k; ++i) {
        const unsigned long long bit = base + ((h.h1 + (unsigned long long)i * h.h2) & mask);
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

// B9c: a cut's row-group stats in ONE launch over a card-wide grid
// (kernels.rowgroup_minmax; CutEngine.rowgroup_minmax sends start_ms and
// dur_us end to end in one pinned upload). Groups are the contiguous
// ranges [g * group, min((g + 1) * group, n)), every one non-empty, so no
// group id array and no trash segment exist. Group g is C CTAs (blockIdx
// g * C .. g * C + C - 1), one thread-block cluster of C where C > 1; C
// comes from kernels.rowgroup_plan (1, 2, 4 or 8), so a cut's 16 groups
// of 65,536 spans run as 128 CTAs, not 16.
//
// Bound: bytes -- 8 B a span read once, 12 B a group written (8.4 MB,
// 2.5 us at 3.35 TB/s, for a cut's 1,048,576 spans). A CTA's slice of
// its group is cut at a multiple of 4 rows; its threads take the aligned
// quads of the slice (a 16-byte load of start_ms and one of dur_us a
// quad, RG_UNROLL quads a thread in flight) and the rows a slice end or
// a group edge cuts off a quad one at a time, as they take every row
// where the two columns' 16-byte phases differ (sh < 0). The loads keep
// the default caching: a cut's columns were just uploaded and may still
// be in L2; evict-first loads measured 0-5 % slower warm at 2^20 spans
// and 6-43 % at 2^22, for 0.4-0.5 us less cold
// (scripts/rowgroup_union_ab.py --split). The edge rows load beside the
// quads. Each thread folds its rows, warps fold by __reduce_*_sync and
// the CTA through
// shared memory; every rank then stores its (lo, hi, du) into rank 0's
// shared memory (distributed shared memory), and after the cluster
// barrier rank 0 folds the C partials and writes column g. Rank 0 reads
// only its own shared memory after that barrier, so no CTA exits while
// another reads its memory. No memset, no global atomic, no second pass.
// C == 1 is a plain launch of the kernel without its cluster steps.
#define RG_THREADS 512
#define RG_UNROLL 4
#define RG_CLUSTER_MAX 8  // kernels.py ROWGROUP_CLUSTER_MAX

__device__ __forceinline__ void rg_fold(int& lo, int& hi, int& du, int lo2, int hi2, int du2) {
    lo = min(lo, lo2);
    hi = max(hi, hi2);
    du = max(du, du2);
}

// sh: the rows before start_ms's first 16-byte boundary (dur_us's the
// same), or -1: every row one at a time. CLUSTER: C > 1 CTAs a group,
// launched as clusters of C; without it a CTA is a group and writes its
// column itself (the cluster steps cost about 0.6 us a launch at C = 1,
// scripts/rowgroup_union_ab.py at 1,000 rows in groups of 333).
template <bool CLUSTER>
__global__ void __launch_bounds__(RG_THREADS)
    rowgroup_kernel(const int32_t* __restrict__ start_ms, const int32_t* __restrict__ dur_us,
                    long long n, long long group, int sh, int32_t* __restrict__ out,
                    int n_groups) {
    __shared__ int s_warp[3][RG_THREADS / 32];
    __shared__ int s_part[3 * RG_CLUSTER_MAX];  // rank 0's holds the cluster's partials
    int C = 1, r = 0;
    if constexpr (CLUSTER) {
        C = (int)cg::this_cluster().num_blocks();
        r = (int)cg::this_cluster().block_rank();
        asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // this CTA has started
    }
    const int tid = threadIdx.x, g = blockIdx.x / C;
    const long long a = (long long)g * group, b = a + group < n ? a + group : n;
    const long long sl = ((b - a + C - 1) / C + 3) & ~3LL;  // a multiple of 4 rows
    const long long lo_r = a + r * sl < b ? a + r * sl : b;
    const long long hi_r = lo_r + sl < b ? lo_r + sl : b;
    int lo = INT32_MAXV, hi = PAD_I32, du = PAD_I32;
    long long qa = hi_r, qb = hi_r;  // the slice's aligned quads: rows [qa, qb)
    if (sh >= 0) {
        qa = lo_r + ((sh - lo_r) & 3);
        qb = hi_r - ((hi_r - sh) & 3);
        if (qb <= qa) qa = qb = hi_r;
    }
    const long long nq = (qb - qa) >> 2;
    // beside the quads at most 3 rows before qa and 3 from qb: threads 0-5
    // load one each before the quads' loads, so that the edges cost no
    // round trip of their own
    int es = 0, ed = 0;
    bool edge = false;
    if (nq > 0 && tid < 6) {
        const long long e = tid < 3 ? qa - 3 + tid : qb + tid - 3;
        edge = tid < 3 ? e >= lo_r : e < hi_r;
        if (edge) {
            es = start_ms[e];
            ed = dur_us[e];
        }
    }
    const int4* s4 = (const int4*)(start_ms + qa);
    const int4* d4 = (const int4*)(dur_us + qa);
    for (long long q0 = tid; q0 < nq; q0 += RG_UNROLL * RG_THREADS) {
        int4 x[RG_UNROLL], y[RG_UNROLL];
#pragma unroll
        for (int u = 0; u < RG_UNROLL; ++u) {  // every load issued before the folds
            const long long q = q0 + u * RG_THREADS;
            if (q < nq) {
                x[u] = __ldg(s4 + q);
                y[u] = __ldg(d4 + q);
            }
        }
#pragma unroll
        for (int u = 0; u < RG_UNROLL; ++u) {
            if (q0 + u * RG_THREADS < nq) {
                lo = min(lo, min(min(x[u].x, x[u].y), min(x[u].z, x[u].w)));
                hi = max(hi, max(max(x[u].x, x[u].y), max(x[u].z, x[u].w)));
                du = max(du, max(max(y[u].x, y[u].y), max(y[u].z, y[u].w)));
            }
        }
    }
    if (edge) rg_fold(lo, hi, du, es, es, ed);
    if (nq == 0)  // no quad (sh < 0, or a slice within one): the slice row by row
        for (long long i = lo_r + tid; i < hi_r; i += RG_THREADS) {
            const int s = start_ms[i];
            rg_fold(lo, hi, du, s, s, dur_us[i]);
        }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    du = __reduce_max_sync(0xffffffffu, du);
    const int warp = tid >> 5, lane = tid & 31;
    if (lane == 0) {
        s_warp[0][warp] = lo;
        s_warp[1][warp] = hi;
        s_warp[2][warp] = du;
    }
    __syncthreads();
    if (warp == 0) {
        const bool w = lane < RG_THREADS / 32;
        lo = __reduce_min_sync(0xffffffffu, w ? s_warp[0][lane] : INT32_MAXV);
        hi = __reduce_max_sync(0xffffffffu, w ? s_warp[1][lane] : PAD_I32);
        du = __reduce_max_sync(0xffffffffu, w ? s_warp[2][lane] : PAD_I32);
    }
    if constexpr (CLUSTER) {
        cg::cluster_group cl = cg::this_cluster();
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank has started
        if (tid == 0) {
            int* p = cl.map_shared_rank(s_part, 0);
            p[3 * r] = lo;
            p[3 * r + 1] = hi;
            p[3 * r + 2] = du;
        }
        cl.sync();  // every partial landed in rank 0's shared memory
        if (r == 0 && warp == 0) {
            const bool w = lane < C;
            lo = __reduce_min_sync(0xffffffffu, w ? s_part[3 * lane] : INT32_MAXV);
            hi = __reduce_max_sync(0xffffffffu, w ? s_part[3 * lane + 1] : PAD_I32);
            du = __reduce_max_sync(0xffffffffu, w ? s_part[3 * lane + 2] : PAD_I32);
        }
    }
    if (r == 0 && tid == 0) {
        out[g] = lo;
        out[n_groups + g] = hi;
        out[2 * n_groups + g] = du;
    }
}

// out: (3, n_groups) int32 rows [start_ms min | start_ms max | dur_us
// max]; C CTAs a group (1, 2, 4 or 8), a cluster where C > 1.
TT_EXPORT int tt_rowgroup(const int32_t* start_ms, const int32_t* dur_us, int n, int group,
                          int C, int32_t* out, int n_groups, void* stream) {
    if (n < 1 || group < 1 || n_groups != (int)(((long long)n + group - 1) / group) ||
        (C != 1 && C != 2 && C != 4 && C != 8) || (long long)n_groups * C > 0x7FFFFFFFLL ||
        (((uintptr_t)start_ms) & 3) || (((uintptr_t)dur_us) & 3))
        return (int)cudaErrorInvalidValue;
    const int ps = (int)((((uintptr_t)start_ms) >> 2) & 3);
    const int pd = (int)((((uintptr_t)dur_us) >> 2) & 3);
    const int sh = ps == pd ? (4 - ps) & 3 : -1;
    cudaStream_t st = (cudaStream_t)stream;
    if (C == 1) {
        rowgroup_kernel<false><<<n_groups, RG_THREADS, 0, st>>>(start_ms, dur_us, (long long)n,
                                                              (long long)group, sh, out, n_groups);
        TT_LAUNCHED_SLOT(2);
        return (int)cudaGetLastError();
    }
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    cfg.gridDim = dim3((unsigned)(n_groups * C));
    cfg.blockDim = dim3(RG_THREADS);
    cfg.stream = st;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, rowgroup_kernel<true>, start_ms, dur_us,
                                             (long long)n, (long long)group, sh, out, n_groups);
    if (e != cudaSuccess) return (int)e;
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}
