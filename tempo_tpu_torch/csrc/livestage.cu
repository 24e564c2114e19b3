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
//                                          column (the delta append)
//   B7d :298 _patch_slots_device           dst.at[idx].set(vals) of dirty
//                                          slots, 1-D or (slot_b, 4)
// All four are bound by bytes. XLA's B7a makes one segment_max pass over
// every row per query code; here one pass over the kv rows and one over
// the name rows compare each row's code against up to 32 query codes held
// in shared memory and atomicOr bit i into a per-slot hit word, and a
// slot pass ANDs `hit == all bits` into the mask: the rows are read once
// per 32 codes, not once per code. B7c and B7d write a NEW tensor (the
// wrapper allocates it): the live snapshot a query holds is immutable, as
// the JAX arrays are, so the resident columns are never written in place.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define LIVE_CHUNK 32

// B7a step 1: one thread per row. The chunk's codes [lo, hi) of the
// combined list (tag codes first, then name codes) sit in shared memory;
// this pass takes the ones of its row kind, [a, b), and ORs bit (j - lo)
// of every code j equal to the row's code into its owner slot's word.
__global__ void live_rows_kernel(const int32_t* __restrict__ owner,
                                 const int32_t* __restrict__ code, int n_rows,
                                 const int32_t* __restrict__ q, int lo, int a, int b,
                                 int slot_b, unsigned int* __restrict__ hit) {
    __shared__ int32_t s_q[LIVE_CHUNK];
    int nq = b - a;
    if (threadIdx.x < nq) s_q[threadIdx.x] = q[a + threadIdx.x];
    __syncthreads();
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rows) return;
    int c = code[r];
    unsigned int bits = 0;
    for (int j = 0; j < nq; ++j) bits |= (unsigned int)(s_q[j] == c) << (a - lo + j);
    if (bits) atomicOr(hit + tt_clamp(owner[r], 0, slot_b - 1), bits);
}

// B7a step 2: one thread per slot. The first pass applies the scalar
// prefilters; every pass with codes ANDs `hit == full` and re-zeroes the
// word for the next chunk.
__global__ void live_slots_kernel(const int32_t* __restrict__ start_s,
                                  const int32_t* __restrict__ end_s,
                                  const int32_t* __restrict__ dur_ms,
                                  const int32_t* __restrict__ alive, int slot_b, int n_slots,
                                  int f_start, int t0, int f_end, int t1, int f_min, int dmin,
                                  int first, unsigned int full, unsigned int* __restrict__ hit,
                                  bool* __restrict__ mask) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= slot_b) return;
    bool m;
    if (first) {
        m = alive[i] > 0 && i < n_slots;
        if (f_start) m = m && end_s[i] >= t0;
        if (f_end) m = m && start_s[i] <= t1;
        if (f_min) m = m && dur_ms[i] >= dmin;
    } else {
        m = mask[i];
    }
    if (full) {
        m = m && hit[i] == full;
        hit[i] = 0;
    }
    mask[i] = m;
}

// q: n_tags tag codes then n_names name codes (device). hit: slot_b words
// of scratch. mask: slot_b bools.
TT_EXPORT int tt_live_filter(const int32_t* start_s, const int32_t* end_s, const int32_t* dur_ms,
                             const int32_t* alive, int slot_b, const int32_t* kv_owner,
                             const int32_t* kv_code, int kv_b, const int32_t* name_owner,
                             const int32_t* name_code, int name_b, const int32_t* q, int n_tags,
                             int n_names, int f_start, int t0, int f_end, int t1, int f_min,
                             int dmin, int n_slots, unsigned int* hit, bool* mask,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int n = n_tags + n_names;
    int err;
    if (n > 0) {
        err = (int)cudaMemsetAsync(hit, 0, sizeof(unsigned int) * (size_t)slot_b, st);
        if (err) return err;
    }
    int first = 1;
    for (int lo = 0; first || lo < n; lo += LIVE_CHUNK) {
        int hi = lo + LIVE_CHUNK < n ? lo + LIVE_CHUNK : n;
        int ta = lo, tb = hi < n_tags ? hi : n_tags;  // tag codes of the chunk
        int na = lo > n_tags ? lo : n_tags, nb = hi;  // name codes of the chunk
        if (tb > ta && kv_b > 0) {
            live_rows_kernel<<<tt_blocks(kv_b, 256), 256, 0, st>>>(kv_owner, kv_code, kv_b, q,
                                                                   lo, ta, tb, slot_b, hit);
            TT_LAUNCHED_SLOT(0);
            if ((err = (int)cudaGetLastError())) return err;
        }
        if (nb > na && name_b > 0) {
            live_rows_kernel<<<tt_blocks(name_b, 256), 256, 0, st>>>(
                name_owner, name_code, name_b, q, lo, na, nb, slot_b, hit);
            TT_LAUNCHED_SLOT(0);
            if ((err = (int)cudaGetLastError())) return err;
        }
        int w = hi - lo;
        unsigned int full = w <= 0 ? 0u : (w == 32 ? 0xFFFFFFFFu : (1u << w) - 1u);
        live_slots_kernel<<<tt_blocks(slot_b, 256), 256, 0, st>>>(
            start_s, end_s, dur_ms, alive, slot_b, n_slots, f_start, t0, f_end, t1, f_min, dmin,
            first, full, hit, mask);
        TT_LAUNCHED_SLOT(0);
        if ((err = (int)cudaGetLastError())) return err;
        first = 0;
    }
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

// B7c: out[i] = src[i - s] inside the window [s, s + m), dst[i] outside.
// As jax.lax.dynamic_update_slice does, a negative start counts from the
// end (start + n) and s is that start clamped to [0, n - m].
__global__ void live_append_kernel(const int32_t* __restrict__ dst, int n,
                                   const int32_t* __restrict__ src, int m, int s,
                                   int32_t* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = (i >= s && i - s < m) ? src[i - s] : dst[i];
}

TT_EXPORT int tt_live_append(const int32_t* dst, int n, const int32_t* src, int m, int start,
                             int32_t* out, void* stream) {
    int s = start < 0 ? start + n : start;
    s = s < 0 ? 0 : (s > n - m ? n - m : s);
    live_append_kernel<<<tt_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(dst, n, src, m, s,
                                                                           out);
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
