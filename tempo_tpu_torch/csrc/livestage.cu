// B7a-B7d: the live head's device programs (the ingester's staged
// live/cut/flushing traces).
//
// Replaces the four jitted programs of tempo_tpu/ops/livestage.py:
//   B7a :147 _compiled_live_filter -> run  slot mask: alive, n_slots, the
//                                          time window, min duration, and
//                                          per tag / name code membership
//                                          over the (owner, code) rows
//   B7b :243 _compiled_find -> run         first alive slot whose 4 id
//                                          codes equal the query's, or -1
//                                          (one launch, below)
//   B7c :290 _append_rows_device           dynamic_update_slice of a row
//                                          column (the delta append; every
//                                          column of a refresh in one launch)
//   B7d :298 _patch_slots_device           dst.at[idx].set(vals) of dirty
//                                          slots, 1-D or (slot_b, 4)
// All four are bound by bytes. B7c and B7d write a NEW tensor (the
// wrapper allocates it): the live snapshot a query holds is immutable, as
// the JAX arrays are, so the resident columns are never written in place.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

// B7a: one __global__ a chunk of up to 32 query codes, nothing else on
// the stream (no memset, no upload). XLA's B7a makes one segment_max
// pass over every row a code; here one row pass compares each row's code
// with the chunk's codes of its kind and ors bit j of every equal code j
// into its owner slot's hit word, and a slot pass ANDs the prefilters
// with `hit == all bits`. The codes travel by value in the
// __grid_constant__ LiveArgs (tag codes first, then name codes), so a
// live search uploads nothing. The row pass reads only the snapshot's
// real rows, n_kv kv rows and n_name name rows, LV_UNROLL independent
// coalesced code loads a thread; an owner is read, clamped to [0,
// slot_b - 1], and or'ed only on a hit. Rows past the real ones are the
// stager's padding, owner 0 and code PAD_I32 (the JAX package's fill):
// the reference reads them, so a query code equal to PAD_I32 of a kind
// whose bucket has padding sets its bit on slot 0 directly. Result:
// `_live_filter_plain` (ops/livestage.py) bit for bit.
//
// The hit words carry the call's epoch: a 64-bit word is epoch << 32 |
// bits, a hit raises it to at least epoch << 32 (dropping an older call's
// bits: epochs only grow) and then ors its bits in, and the slot pass
// reads an older epoch as no bits. So nothing zeroes the words before a
// call (a zero phase and a second grid barrier cost about 1.4 us), and
// they cannot sit in the call's fresh allocation: they live a stream,
// with the epoch, in scratch the wrapper keeps (zero when made; calls on
// one stream run in order). The row pass must be complete before the
// slot pass reads the words: a cooperative launch, rows, grid.sync(),
// slots, its grid LV_COOP_PER_SM CTAs an SM at most (grid-stride loops).
// (A plain launch whose last CTAs to finish their rows waited for the
// rest and shared the slot pass was 2-3 % faster at 1 and 3 codes and
// 11 % at 33 on an NVIDIA H100 80GB HBM3 at 700 W; it spun on a device
// counter and kept a ticket count a stream, so it went: PERF.md.)
// Bound: bytes: 17 B a slot (alive, start_s, end_s, dur_ms read, the mask
// written), 4 B a real row of a kind with a query code (its code), 4 B a
// row that hits (its owner); about 6.5 MB, 1.9 us at 3.35 TB/s, for the
// live head's 16,384 slots and 1.56 M real rows. The launch and the grid
// barrier are the rest.
#define LIVE_CHUNK 32
#define LV_THREADS 512
#define LV_UNROLL 4        // independent row loads a thread
#define LV_COOP_PER_SM 2   // the cooperative grid: at most 2 CTAs an SM

struct LiveArgs {
    const int32_t *start_s, *end_s, *dur_ms, *alive;
    const int32_t *kv_owner, *kv_code, *name_owner, *name_code;
    unsigned long long* hit;  // slot_b words: epoch << 32 | hit bits
    bool* mask;
    unsigned int epoch;
    int slot_b, n_slots, n_kv, n_name;  // n_kv / n_name: the real rows the pass reads
    int kv_pad, name_pad;               // the kind's bucket has padding past its real rows
    int f_start, t0, f_end, t1, f_min, dmin;
    int first;       // the first chunk: the prefilters; later chunks AND into the mask
    int n_tags, n;   // codes [0, n_tags) are tag codes, [n_tags, n) name codes
    int32_t code[LIVE_CHUNK];
};

// or bits into slot o's word for this call's epoch: a max with epoch <<
// 32 first (a word of an older call becomes the bare tag, one of this
// call keeps its bits), then the or; one thread's two atomics on one word
// land in order, and neither waits for a result
__device__ __forceinline__ void live_or(const LiveArgs& a, int o, unsigned int bits) {
    atomicMax(a.hit + o, (unsigned long long)a.epoch << 32);
    atomicOr(a.hit + o, (unsigned long long)bits);
}

// the row pass over CTAs [cta, ...) of n_ctas: rows [0, nk) are kv rows,
// [nk, nk + nn) name rows (a kind without a code of the chunk has none)
__device__ __forceinline__ void live_rows(const LiveArgs& a, long long cta, long long n_ctas) {
    const long long nk = a.n_tags > 0 ? a.n_kv : 0, nn = a.n > a.n_tags ? a.n_name : 0;
    const long long total = nk + nn, step = n_ctas * LV_THREADS * LV_UNROLL;
    for (long long r0 = cta * LV_THREADS * LV_UNROLL + threadIdx.x; r0 < total; r0 += step) {
        int c[LV_UNROLL];
#pragma unroll
        for (int u = 0; u < LV_UNROLL; ++u) {  // every load issued before any compare
            const long long r = r0 + (long long)u * LV_THREADS;
            c[u] = r < nk ? __ldg(a.kv_code + r) : (r < total ? __ldg(a.name_code + (r - nk)) : 0);
        }
#pragma unroll
        for (int u = 0; u < LV_UNROLL; ++u) {
            const long long r = r0 + (long long)u * LV_THREADS;
            if (r >= total) break;
            const bool kv = r < nk;
            const int j0 = kv ? 0 : a.n_tags, j1 = kv ? a.n_tags : a.n;
            unsigned int bits = 0;
            for (int j = j0; j < j1; ++j) bits |= (unsigned int)(a.code[j] == c[u]) << j;
            if (bits) {
                const int o = kv ? __ldg(a.kv_owner + r) : __ldg(a.name_owner + (r - nk));
                live_or(a, tt_clamp(o, 0, a.slot_b - 1), bits);
            }
        }
    }
}

// the slot pass over slots start, start + stride, ...: every load of a
// slot issued before any test (the prefilters are uniform, so no load
// waits on another)
__device__ __forceinline__ void live_slots(const LiveArgs& a, long long start, long long stride) {
    unsigned int pad = 0;  // the padding rows: owner 0, code PAD_I32
    for (int j = 0; j < a.n; ++j)
        if (a.code[j] == PAD_I32 && (j < a.n_tags ? a.kv_pad : a.name_pad)) pad |= 1u << j;
    const unsigned int full = a.n == 32 ? 0xFFFFFFFFu : (1u << a.n) - 1u;
    for (long long i = start; i < a.slot_b; i += stride) {
        int al = 0, es = 0, ss = 0, du = 0;
        bool m = false;
        unsigned long long w = 0;
        if (a.first) {
            al = a.alive[i];
            if (a.f_start) es = a.end_s[i];
            if (a.f_end) ss = a.start_s[i];
            if (a.f_min) du = a.dur_ms[i];
        } else {
            m = a.mask[i];
        }
        if (a.n > 0) w = __ldcg(a.hit + i);
        if (a.first)
            m = (al > 0) & (i < a.n_slots) & (!a.f_start | (es >= a.t0)) &
                (!a.f_end | (ss <= a.t1)) & (!a.f_min | (du >= a.dmin));
        if (a.n > 0) {
            const unsigned int h = (unsigned int)(w >> 32) == a.epoch ? (unsigned int)w : 0u;
            m = m && (h | (i == 0 ? pad : 0u)) == full;
        }
        a.mask[i] = m;
    }
}

__global__ void __launch_bounds__(LV_THREADS) live_filter_kernel(const __grid_constant__ LiveArgs a) {
    cg::grid_group g = cg::this_grid();
    if (a.n > 0) {
        live_rows(a, blockIdx.x, gridDim.x);
        g.sync();
    }
    live_slots(a, g.thread_rank(), g.size());
}

static int lv_coop_ctas = 0;  // CTAs of the cooperative grid that fit at once

// One launch: the first chunk's codes (`first`) or a later one's.
// hit: the stream's slot_b (or more) 64-bit hit words; state: the
// stream's epoch on the host, read, used and advanced here. The wrapper
// makes one call a chunk of up to 32 codes.
TT_EXPORT int tt_live_filter(const int32_t* start_s, const int32_t* end_s, const int32_t* dur_ms,
                             const int32_t* alive, int slot_b, const int32_t* kv_owner,
                             const int32_t* kv_code, int n_kv, int kv_b,
                             const int32_t* name_owner, const int32_t* name_code, int n_name,
                             int name_b, const int32_t* codes, int n_tags, int n, int f_start,
                             int t0, int f_end, int t1, int f_min, int dmin, int n_slots,
                             int first, unsigned long long* hit, unsigned long long* state,
                             bool* mask, void* stream) {
    if (slot_b < 1 || n < 0 || n > LIVE_CHUNK || n_tags < 0 || n_tags > n || n_kv < 0 ||
        n_kv > kv_b || n_name < 0 || n_name > name_b || state[0] < 1 ||
        state[0] > 0xFFFFFFFFull)
        return (int)cudaErrorInvalidValue;
    LiveArgs a = {start_s, end_s, dur_ms, alive, kv_owner, kv_code, name_owner, name_code,
                  hit, mask, (unsigned int)state[0], slot_b, n_slots, n_kv, n_name,
                  kv_b > n_kv, name_b > n_name, f_start, t0, f_end, t1, f_min, dmin, first,
                  n_tags, n, {0}};
    for (int j = 0; j < n; ++j) a.code[j] = codes[j];
    cudaError_t e;
    if (!lv_coop_ctas) {
        int dev, sms, per_sm = 0;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, live_filter_kernel,
                                                               LV_THREADS, 0)))
            return (int)e;
        lv_coop_ctas = (per_sm < LV_COOP_PER_SM ? per_sm : LV_COOP_PER_SM) * sms;
    }
    const long long rows = (n_tags > 0 ? (long long)n_kv : 0) + (n > n_tags ? n_name : 0);
    const long long per = (long long)LV_THREADS * LV_UNROLL;
    long long ctas = (rows + per - 1) / per;
    const long long slots = ((long long)slot_b + LV_THREADS - 1) / LV_THREADS;
    ctas = ctas > slots ? ctas : slots;  // at least a CTA a LV_THREADS slots
    ctas = ctas > lv_coop_ctas ? lv_coop_ctas : ctas;
    void* args[] = {&a};
    if ((e = cudaLaunchCooperativeKernel((const void*)live_filter_kernel, dim3((unsigned)ctas),
                                         dim3(LV_THREADS), args, 0, (cudaStream_t)stream)))
        return (int)e;
    if ((e = cudaGetLastError())) return (int)e;
    TT_LAUNCHED_SLOT(0);
    state[0] += 1;
    return 0;
}

// B7b: the lowest slot below lim = clamp(n_slots, 0, slot_b) that is
// alive and whose 4 id codes equal (q0, q1, q2, q3), or -1: `argmax`'s
// first match. One launch and nothing else: the query arrives as four
// kernel arguments, so no query is uploaded, and the minimum is reduced
// inside the launch, so no word is preset and no atomic touches device
// memory. The launch is one thread-block cluster of C = ceil(lim /
// LF_SLOTS_CTA) CTAs, at most 8 (portable); past 8 CTAs' worth of slots
// the cluster strides over them. Each thread walks slots r * LF_THREADS +
// tid + k * C * LF_THREADS in rounds of LF_UNROLL (int4 loads of the
// codes, coalesced loads of alive, all issued before any compare) and
// stops at its first match; a warp takes its minimum by
// __reduce_min_sync, the CTA through one shared word a warp, and each CTA
// folds its minimum into rank 0's shared word through distributed shared
// memory (a shared-memory atomicMin); after the cluster barrier rank 0
// writes the word (0xFFFFFFFF reads as -1). The barrier is split: each
// CTA arrives when rank 0's word is set, before its loads, and waits
// only before its remote atomic, so the wait overlaps the loads.
//
// Bound: bytes, 20 B a slot below lim (0.33 MB, 0.098 us at 3.35 TB/s at
// the live head's 16,384 slots), far under a launch; so the launch is the
// cost. A launch with the cluster attribute costs more than a plain one,
// and one CTA reads a few thousand slots in about a launch's time, so the
// plan launches a cluster only where the slots need more than one CTA:
// C == 1 is a plain launch (no cluster attribute; the cluster barrier and
// the shared atomic then act on the CTA itself). Times by C: chip_smoke.py's
// `[split] B7b` line (PERF.md). The old route (a memset of the word, a
// thread a slot with a device atomicMin, the query uploaded by the caller)
// made three stream operations before the read-back.
#define LF_THREADS 512
#define LF_UNROLL 4
#define LF_SLOTS_CTA (LF_THREADS * LF_UNROLL)
#define LF_CLUSTER_MAX 8

__global__ void __launch_bounds__(LF_THREADS)
    live_find_kernel(const int4* __restrict__ id_codes, const int32_t* __restrict__ alive,
                     int lim, int q0, int q1, int q2, int q3, int32_t* __restrict__ out) {
    __shared__ unsigned s_warp[LF_THREADS / 32];
    __shared__ unsigned s_min;  // rank 0's is the cluster's
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks(), r = (int)cl.block_rank();
    if (threadIdx.x == 0) s_min = 0xFFFFFFFFu;
    asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // s_min set
    const int stride = C * LF_THREADS;
    unsigned best = 0xFFFFFFFFu;
    for (long long i = (long long)r * LF_THREADS + threadIdx.x; i < lim && best == 0xFFFFFFFFu;
         i += (long long)LF_UNROLL * stride) {
        int4 c[LF_UNROLL];
        int al[LF_UNROLL];
#pragma unroll
        for (int u = 0; u < LF_UNROLL; ++u) {
            const long long j = i + (long long)u * stride;
            al[u] = 0;
            if (j < lim) {
                c[u] = __ldg(id_codes + j);
                al[u] = __ldg(alive + j);
            }
        }
#pragma unroll
        for (int u = LF_UNROLL - 1; u >= 0; --u)  // the lowest match written last
            if (al[u] > 0 && c[u].x == q0 && c[u].y == q1 && c[u].z == q2 && c[u].w == q3)
                best = (unsigned)(i + (long long)u * stride);
    }
    best = __reduce_min_sync(0xFFFFFFFFu, best);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = best;
    __syncthreads();
    unsigned v = threadIdx.x < LF_THREADS / 32 ? s_warp[threadIdx.x] : 0xFFFFFFFFu;
    if (threadIdx.x < 32) v = __reduce_min_sync(0xFFFFFFFFu, v);
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every rank's s_min set
    if (threadIdx.x == 0 && v != 0xFFFFFFFFu) atomicMin(cl.map_shared_rank(&s_min, 0), v);
    cl.sync();  // every fold landed; no CTA leaves before
    if (r == 0 && threadIdx.x == 0) *out = (int32_t)s_min;
}

// The plan: C = ceil(lim / LF_SLOTS_CTA) CTAs, clamped to [1, 8]. One
// CTA is a plain launch, more a cluster of them.
TT_EXPORT int tt_live_find(const int32_t* id_codes, const int32_t* alive, int slot_b,
                           int n_slots, int q0, int q1, int q2, int q3, int32_t* out,
                           void* stream) {
    if (slot_b < 0) return (int)cudaErrorInvalidValue;
    const int lim = n_slots < slot_b ? (n_slots > 0 ? n_slots : 0) : slot_b;
    long long C = ((long long)lim + LF_SLOTS_CTA - 1) / LF_SLOTS_CTA;
    C = C < 1 ? 1 : (C > LF_CLUSTER_MAX ? LF_CLUSTER_MAX : C);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute at[1];
    cfg.gridDim = dim3((unsigned)C);
    cfg.blockDim = dim3(LF_THREADS);
    cfg.stream = (cudaStream_t)stream;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = (unsigned)C;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = C > 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, live_find_kernel, (const int4*)id_codes, alive,
                                             lim, q0, q1, q2, q3, out);
    if (e != cudaSuccess) return (int)e;
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}

// B7c: a delta refresh's appends, every row column that takes new rows
// in ONE launch (kernels.live_append_many; kernels.live_append is the
// same kernel with one segment). Column c becomes out[c], a new tensor:
// out[c][i] = src[off[c] + i - s[c]] inside the window [s[c], s[c] +
// m[c]), dst[c][i] outside it. The wrapper clamps each start as
// jax.lax.dynamic_update_slice does (a negative start counts from the
// end, then [0, n - m]). The segments arrive end to end in one buffer
// (one pinned upload a refresh; before, a pageable upload and a launch a
// column, four a refresh).
//
// Bound: bytes -- each output written once, dst read outside the window,
// src read inside it: 8 B a row of every column (about 25 MB, 7.5 us at
// 3.35 TB/s, for a refresh's 2 x 2^20 kv and 2 x 2^19 name rows). A
// thread takes a quad (4 rows from a multiple of 4 of its column) and
// LA_UNROLL of them in flight over a grid sized to the card: one 16 B
// load from src or dst and one 16 B store where the quad lies wholly on
// one side of the window; element by element where the window's edge or
// the column's end cuts it. The stager places each segment so that its
// offset minus its start is a multiple of 4 (kernels.append_plan): then a
// quad inside the window reads src 16 B aligned too; a segment placed
// otherwise (a caller's own src) reads its quads 4 B at a time.
#define LA_COLS 4          // kernels.py APPEND_COLS
#define LA_THREADS 256
#define LA_UNROLL 2
#define LA_QUADS_CTA (LA_THREADS * LA_UNROLL)

struct AppendArgs {
    const int32_t* src;            // the segments, end to end
    const int32_t* dst[LA_COLS];
    int32_t* out[LA_COLS];         // 16 B aligned (the wrapper's allocation)
    int n[LA_COLS];                // column lengths
    int s[LA_COLS];                // clamped starts
    int e[LA_COLS];                // window ends, s + m
    int off[LA_COLS];              // segment offsets in src
    int vec[LA_COLS];              // bit 0: dst 16 B aligned; bit 1: src quads 16 B aligned
    int quad[LA_COLS + 1];         // quads before column c
    int n_col;
};

__device__ __forceinline__ int4 la_load4(const int32_t* p, bool vec) {
    return vec ? *(const int4*)p : make_int4(p[0], p[1], p[2], p[3]);
}

__global__ void __launch_bounds__(LA_THREADS) live_append_kernel(const __grid_constant__ AppendArgs a) {
    const int nq = a.quad[a.n_col], stride = gridDim.x * LA_THREADS;
    for (int q0 = blockIdx.x * LA_THREADS + threadIdx.x; q0 < nq; q0 += LA_UNROLL * stride) {
        int4 x[LA_UNROLL];
        int col[LA_UNROLL], e0[LA_UNROLL];
        bool whole[LA_UNROLL];
#pragma unroll
        for (int u = 0; u < LA_UNROLL; ++u) {  // every whole quad's load issued first
            const int q = q0 + u * stride;
            whole[u] = false;
            col[u] = e0[u] = 0;
            if (q >= nq) continue;
            int c = 0;
#pragma unroll
            for (int j = 1; j < LA_COLS; ++j) c += j < a.n_col && a.quad[j] <= q;
            const int i = 4 * (q - a.quad[c]), s = a.s[c], e = a.e[c];
            col[u] = c;
            e0[u] = i;
            if (i + 4 > a.n[c]) continue;  // the column's ragged end
            if (i >= s && i + 4 <= e) {
                whole[u] = true;
                x[u] = la_load4(a.src + a.off[c] + (i - s), a.vec[c] & 2);
            } else if (i + 4 <= s || i >= e) {
                whole[u] = true;
                x[u] = la_load4(a.dst[c] + i, a.vec[c] & 1);
            }
        }
#pragma unroll
        for (int u = 0; u < LA_UNROLL; ++u) {
            if (q0 + u * stride >= nq) continue;
            const int c = col[u], i0 = e0[u];
            int32_t* out = a.out[c];
            if (whole[u]) {
                *(int4*)(out + i0) = x[u];
                continue;
            }
            const int s = a.s[c], e = a.e[c], top = min(i0 + 4, a.n[c]);
            for (int i = i0; i < top; ++i)
                out[i] = (i >= s && i < e) ? a.src[a.off[c] + (i - s)] : a.dst[c][i];
        }
    }
}

static int la_sms = 0, la_per_sm = 0;

// geom: n_col rows of (n, s, m, off), s already clamped to [0, n - m];
// dst, out: n_col device addresses each (host arrays).
TT_EXPORT int tt_live_append_many(const int32_t* src, const long long* dst, const long long* out,
                                  const int* geom, int n_col, void* stream) {
    if (n_col < 1 || n_col > LA_COLS) return (int)cudaErrorInvalidValue;
    AppendArgs a{};
    a.src = src;
    a.n_col = n_col;
    long long nq = 0;
    for (int c = 0; c < n_col; ++c) {
        const int n = geom[4 * c], s = geom[4 * c + 1], m = geom[4 * c + 2], off = geom[4 * c + 3];
        if (n < 1 || m < 0 || m > n || s < 0 || s > n - m || off < 0 || (out[c] & 15))
            return (int)cudaErrorInvalidValue;
        a.dst[c] = (const int32_t*)dst[c];
        a.out[c] = (int32_t*)out[c];
        a.n[c] = n;
        a.s[c] = s;
        a.e[c] = s + m;
        a.off[c] = off;
        a.vec[c] = ((dst[c] & 15) == 0) |
                   ((((uintptr_t)src + 4LL * ((long long)off - s)) & 15) == 0 ? 2 : 0);
        a.quad[c] = (int)nq;
        nq += (n + 3) / 4;
    }
    if (nq > 0x7FFFFFF0LL / 4) return (int)cudaErrorInvalidValue;
    a.quad[n_col] = (int)nq;
    cudaError_t e = cudaSuccess;
    if (!la_sms) {
        int dev;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&la_sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&la_per_sm, live_append_kernel,
                                                               LA_THREADS, 0)))
            return (int)e;
    }
    const long long want = (nq + LA_QUADS_CTA - 1) / LA_QUADS_CTA;
    const long long card = (long long)(la_per_sm > 1 ? la_per_sm : 1) * la_sms;
    const int ctas = (int)(want < 1 ? 1 : want < card ? want : card);
    live_append_kernel<<<ctas, LA_THREADS, 0, (cudaStream_t)stream>>>(a);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}

// B7d. Bound: bytes -- the column read and written once, idx and vals
// read once (0.53 MB, 0.16 us at 3.35 TB/s, for 2,048 rows of a
// (16,384, 4) column), far under a launch, so the launches and the
// wrapper's host path are the cost: a full copy and then a scatter (two
// launches) became one launch. CTA b owns the output rows [b R, (b + 1) R), R a
// multiple of 4, so every range starts 16-byte aligned where dst and out
// do: it copies its range (int4 loads and stores where aligned), waits at
// __syncthreads, then walks all m indices and writes the values of those
// that fall in its range. No row is written by two CTAs, so the copy and
// the patch cannot race. The grid is bounded (PATCH_MAX_CTAS), so the
// index walk (4 B an index a CTA, from L2) stays small as n grows, and a
// CTA copies at least PATCH_MIN_WORDS, so a small column takes few CTAs.
// A negative index counts from the end (index + n), as jnp indexing
// normalises it; an index still outside [0, n) is dropped, as XLA's
// scatter drops it. Repeated indices must carry equal values (the stager
// pads with a repeated real index and its own value); with unequal values
// which one lands is not specified, as in XLA.
#define PATCH_THREADS 256
#define PATCH_MIN_WORDS 4096
#define PATCH_MAX_CTAS 528  // 4 a SM of the H100's 132

__global__ void __launch_bounds__(PATCH_THREADS)
    live_patch_kernel(const int32_t* __restrict__ dst, int n, int width, long long rows,
                      const int32_t* __restrict__ idx, const int32_t* __restrict__ vals, int m,
                      int32_t* __restrict__ out) {
    const long long r0 = blockIdx.x * rows, r1 = min((long long)n, r0 + rows);
    long long e0 = r0 * width;
    const long long e1 = r1 * width;
    if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(out)) & 15) == 0) {
        const long long nv = (e1 - e0) >> 2;
        const int4* s4 = reinterpret_cast<const int4*>(dst + e0);
        int4* o4 = reinterpret_cast<int4*>(out + e0);
        for (long long x = threadIdx.x; x < nv; x += blockDim.x) o4[x] = s4[x];
        e0 += nv << 2;
    }
    for (long long x = e0 + threadIdx.x; x < e1; x += blockDim.x) out[x] = dst[x];
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
        long long r = idx[j];
        if (r < 0) r += n;
        if (r < r0 || r >= r1) continue;
        for (int lane = 0; lane < width; ++lane)
            out[r * width + lane] = vals[(long long)j * width + lane];
    }
}

TT_EXPORT int tt_live_patch(const int32_t* dst, int n, int width, const int32_t* idx,
                            const int32_t* vals, int m, int32_t* out, void* stream) {
    if (n < 0 || width < 1 || m < 0) return (int)cudaErrorInvalidValue;
    long long ctas = ((long long)n * width + PATCH_MIN_WORDS - 1) / PATCH_MIN_WORDS;
    ctas = ctas < 1 ? 1 : (ctas > PATCH_MAX_CTAS ? PATCH_MAX_CTAS : ctas);
    long long rows = (((long long)n + ctas - 1) / ctas + 3) & ~3LL;
    if (rows < 4) rows = 4;
    live_patch_kernel<<<tt_blocks(n, (int)rows), PATCH_THREADS, 0, (cudaStream_t)stream>>>(
        dst, n, width, rows, idx, vals, m, out);
    TT_LAUNCHED_SLOT(3);
    return (int)cudaGetLastError();
}
