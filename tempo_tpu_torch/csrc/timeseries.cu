// B6: the TraceQL-metrics fold -- span mask -> time bucket -> segmented
// count / value count / f32 sum / min / max per (group, bucket).
//
// Replaces tempo_tpu/ops/timeseries.py:46/:53 `_compiled_ts(...).run`.
// The span-level condition tree arrives as K1's postfix span program
// over the shared descriptor table (cond.cuh: K1's leaf semantics, f32
// promotion, dictionary tables, sattr/rattr owner rows, PAD guards);
// trace-target conditions (C_TCOND) read their trace column at the
// span's clamped span.trace_sid. A span is kept when its int32 bucket
// floor((start_ms - t0) / step) lies in [0, n_buckets) and its group id
// in [0, G); the (G, n_buckets) accumulators are the reference's
// [:n_groups, :n_buckets] slice (padded rows and columns of the
// reference are never read). Counts, value counts, min and max are
// exact (min and max as order-preserving int32 encodings of the f32
// values, -0.0 below +0.0 as in XLA; a NaN encodes to the end of the
// order that makes it win, so it propagates as XLA's min and max do);
// the f32 sum is order-dependent, as XLA's scatter-add is.
//
// Bound: bytes. The function must read each column the program names
// (4 B a span) plus start_ms, gid, val and vpres (13 B a span), and
// write the accumulators once.
//
// Design (tt_timeseries, ts_one_kernel): ONE __global__ a call (after
// K1's res pass where the program has resource.attr conditions), a
// cooperative launch (cudaLaunchKernelEx with cudaLaunchAttributeCooperative,
// the grid no larger than what is co-resident) whose grid-wide syncs
// (cooperative_groups::this_grid().sync()) take the place of the
// memsets, the init and the finish launches. It writes one packed int32
// allocation: the A planes counts | vcnt | vsum | vmin | vmax (A = 5 for
// a value fold, else 1) of G x n_buckets cells, min and max decoded
// before the kernel ends; on the cluster route K partial grids follow
// them as scratch. Routes, chosen before launch by
// kernels.timeseries_plan on (cells, has_val):
//   shared  the grid fits one CTA: each CTA writes its slice of the
//           output's identity, then folds its spans into a private copy
//           with shared-memory atomics; the 8 CTAs of a cluster reduce
//           their copies, CTA r its slice of cells, through distributed
//           shared memory loads (cooperative_groups::cluster_group::
//           map_shared_rank); after the grid syncs, each CTA adds its
//           reduced slice into the output with one device atomic a
//           touched cell (a cluster a copy: 8x fewer than a CTA a copy),
//           and a value fold syncs again and decodes min and max. This
//           beat writing each cluster's grid as a partial and merging
//           the partials after the sync, and flushing each CTA's own
//           copy with no cluster (PERF.md);
//   cluster a value grid past one CTA, within 16 CTAs' shared memory: CTA
//           r of a cluster owns `per` cells of every plane. In rounds of
//           TS_ROUND spans a CTA, each span is filed as a record (the
//           cell's offset in its owner's slice, the presence bit, the
//           value) in the CTA's outbox, bucketed by owner (slots from
//           warp-aggregated counters); after a cluster barrier each owner
//           pulls its records from every outbox of its cluster through
//           distributed shared memory and folds them with local atomics.
//           No span's atomic leaves its owner's SM;
//           then each cluster writes its grid as partial k of K, the
//           grid syncs, and every CTA reduces a grid-stride slice of the
//           output words over the K partials (f32 sums in partial order)
//           and writes them once, decoded;
//   global  a counts-only grid past one CTA, or a grid past the cluster's
//           capacity: the kernel writes each plane's identity, syncs,
//           folds every span with device-memory atomics, syncs, and
//           decodes min and max in place.
// Records, not remote atomics: an atomic into another CTA's shared memory
// costs about as much as a device-memory atomic on the H100 (PERF.md).
// M4 (tt_timeseries_stacked) keeps the memset / init / fold / finish
// launches of ts_fold_kernel.
#include <cooperative_groups.h>

#include "cond.cuh"

namespace cg = cooperative_groups;

#define TS_SMEM_MAX (96 * 1024)

__device__ __forceinline__ int ts_enc(float f) {
    int i = __float_as_int(f);
    return i >= 0 ? i : i ^ 0x7FFFFFFF;
}

// a NaN wins a min (lowest int) and a max (highest int); both decode to
// a NaN bit pattern, and no other float encodes to either
__device__ __forceinline__ int ts_enc_min(float f) { return isnan(f) ? PAD_I32 : ts_enc(f); }
__device__ __forceinline__ int ts_enc_max(float f) { return isnan(f) ? INT32_MAXV : ts_enc(f); }

__device__ __forceinline__ int ts_floordiv(int a, int b) {
    int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// the span mask: K1's span program plus C_TCOND leaves
__device__ __forceinline__ bool ts_span_mask(const int32_t* prog, int len, const long long* desc,
                                             int s, const uint8_t* resmask, int n_res_b,
                                             const int32_t* res_idx, const int32_t* tsid,
                                             int n_traces_b) {
    unsigned long long st = 0;
    for (int p = 0; p < len; p += 2) {
        int code = prog[p], arg = prog[p + 1];
        bool v;
        if (code == C_AND || code == C_OR) {
            bool b = st & 1, a = (st >> 1) & 1;
            st >>= 2;
            v = code == C_AND ? (a && b) : (a || b);
        } else if (code == C_COND) {
            v = span_leaf(desc + (long long)arg * DW, s, true, resmask, n_res_b, res_idx);
        } else if (code == C_TCOND) {
            const long long* d = desc + (long long)arg * DW;
            v = cmp_at(d, (const void*)d[D_COL], tt_clamp(tsid[s], 0, n_traces_b - 1));
        } else {
            v = code == C_TRUE;
        }
        st = (st << 1) | (unsigned long long)v;
    }
    return st & 1;
}

__global__ void ts_init_kernel(int32_t* __restrict__ vmin, int32_t* __restrict__ vmax, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    vmin[i] = ts_enc(__int_as_float(0x7F800000));   // +inf
    vmax[i] = ts_enc(__int_as_float((int)0xFF800000));  // -inf
}

// Both folds: B6 over one block (descs == NULL: desc, t0 and n_spans as
// given) and M4 over Bl stacked blocks (blockIdx.y = block b, its
// descriptor table descs[b], origin t0s[b], span count nspans[b], and
// its row b * S of tsid, start_ms, gid, val and vpres), all into one
// (G, n_buckets) grid.
template <bool SMEM>
__global__ void ts_fold_kernel(const int32_t* __restrict__ prog, int len,
                               const long long* __restrict__ desc,
                               const long long* __restrict__ descs, long long S,
                               const uint8_t* __restrict__ resmask, int n_res_b,
                               const int32_t* __restrict__ res_idx, const int32_t* __restrict__ tsid,
                               int n_traces_b, const int32_t* __restrict__ start_ms,
                               const int32_t* __restrict__ gid, const float* __restrict__ val,
                               const uint8_t* __restrict__ vpres, int t0, int n_spans,
                               const int32_t* __restrict__ t0s, const int32_t* __restrict__ nspans,
                               int step, int n_buckets, int G, int has_val,
                               int32_t* __restrict__ counts, int32_t* __restrict__ vcnt,
                               float* __restrict__ vsum, int32_t* __restrict__ vmin,
                               int32_t* __restrict__ vmax) {
    extern __shared__ int32_t smem[];
    if (descs) {
        const int b = blockIdx.y;
        const long long o = (long long)b * S;
        desc = (const long long*)descs[b];
        tsid += o;
        start_ms += o;
        gid += o;
        if (has_val) {
            val += o;
            vpres += o;
        }
        t0 = t0s[b];
        n_spans = nspans[b];
    }
    const int cells = G * n_buckets;
    int32_t *c_acc = counts, *vc_acc = vcnt, *mn_acc = vmin, *mx_acc = vmax;
    float* vs_acc = vsum;
    if (SMEM) {
        c_acc = smem;
        vc_acc = smem + cells;
        vs_acc = (float*)(smem + 2 * cells);
        mn_acc = smem + 3 * cells;
        mx_acc = smem + 4 * cells;
        for (int i = threadIdx.x; i < cells; i += blockDim.x) {
            c_acc[i] = 0;
            if (has_val) {
                vc_acc[i] = 0;
                vs_acc[i] = 0.f;
                mn_acc[i] = ts_enc(__int_as_float(0x7F800000));
                mx_acc[i] = ts_enc(__int_as_float((int)0xFF800000));
            }
        }
        __syncthreads();
    }
    const int stride = gridDim.x * blockDim.x;
    for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_spans; s += stride) {
        if (!ts_span_mask(prog, len, desc, s, resmask, n_res_b, res_idx, tsid, n_traces_b)) continue;
        // int32 wrap-around subtraction, as XLA's int32 arithmetic
        const int b = ts_floordiv((int)((unsigned)start_ms[s] - (unsigned)t0), step);
        const int g = gid[s];
        if (b < 0 || b >= n_buckets || g < 0 || g >= G) continue;
        const int cell = g * n_buckets + b;
        atomicAdd(c_acc + cell, 1);
        if (has_val && vpres[s]) {
            const float v = val[s];
            atomicAdd(vc_acc + cell, 1);
            atomicAdd(vs_acc + cell, v);
            atomicMin(mn_acc + cell, ts_enc_min(v));
            atomicMax(mx_acc + cell, ts_enc_max(v));
        }
    }
    if (!SMEM) return;
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        if (c_acc[i]) atomicAdd(counts + i, c_acc[i]);
        if (has_val && vc_acc[i]) {
            atomicAdd(vcnt + i, vc_acc[i]);
            atomicAdd(vsum + i, vs_acc[i]);
            atomicMin(vmin + i, mn_acc[i]);
            atomicMax(vmax + i, mx_acc[i]);
        }
    }
}

// order-preserving int32 encodings back to f32, in place
__global__ void ts_finish_kernel(int32_t* __restrict__ vmin, int32_t* __restrict__ vmax, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int a = vmin[i], b = vmax[i];
    vmin[i] = a >= 0 ? a : a ^ 0x7FFFFFFF;
    vmax[i] = b >= 0 ? b : b ^ 0x7FFFFFFF;
}

#define TS_THREADS 512
#define TS_R 4                            // spans a thread a round on the cluster route
#define TS_ROUND (TS_THREADS * TS_R)      // kernels.py TS_ROUND
#define TS_HEAD 72                        // counters and offsets before the outbox
#define TS_EXCH_WORDS (TS_HEAD + 2 * TS_ROUND)  // kernels.py TS_EXCH
#define TS_CLUSTER_MAX 16
#define TS_SMEM_CTA_MAX (200 * 1024)      // kernels.py TS_SMEM_MAX

// one fold's arguments (a struct: cudaLaunchKernelEx passes it by value)
struct TsArgs {
    const int32_t* prog;
    int len;
    const long long* desc;
    const uint8_t* resmask;
    int n_res_b;
    const int32_t* res_idx;
    const int32_t* tsid;
    int n_traces_b;
    const int32_t* start_ms;
    const int32_t* gid;
    const float* val;
    const uint8_t* vpres;
    int t0, step, n_spans, n_buckets, G, has_val;
    int cells, per;    // per: cells of each plane a CTA owns (the shared route: all)
    int32_t* scratch;  // K partial grids of A planes (the cluster route)
    int32_t* out;      // A planes of cells, decoded
};

__device__ __forceinline__ int ts_identity(int plane) {
    // counts, vcnt, vsum: 0; vmin: enc(+inf); vmax: enc(-inf)
    return plane == 3 ? 0x7F800000 : plane == 4 ? (int)(0xFF800000u ^ 0x7FFFFFFFu) : 0;
}

__device__ __forceinline__ int ts_decode(int x) { return x >= 0 ? x : x ^ 0x7FFFFFFF; }

// plane p's reduction of two accumulators
__device__ __forceinline__ int ts_combine(int p, int x, int y) {
    return p == 2 ? __float_as_int(__int_as_float(x) + __int_as_float(y))
                  : p == 3 ? min(x, y) : p == 4 ? max(x, y) : x + y;
}

// the cell span s folds into, or -1
__device__ __forceinline__ int ts_cell(const TsArgs& a, int s, int start, int g) {
    if (!ts_span_mask(a.prog, a.len, a.desc, s, a.resmask, a.n_res_b, a.res_idx, a.tsid,
                      a.n_traces_b))
        return -1;
    // int32 wrap-around subtraction, as XLA's int32 arithmetic
    const int b = ts_floordiv((int)((unsigned)start - (unsigned)a.t0), a.step);
    if (b < 0 || b >= a.n_buckets || g < 0 || g >= a.G) return -1;
    return g * a.n_buckets + b;
}

// the A accumulators of one span at p[0], p[stride], ... p[4 stride]
__device__ __forceinline__ void ts_fold_span(int32_t* p, long long stride, bool has_val,
                                             bool pres, float v) {
    atomicAdd(p, 1);
    if (has_val && pres) {
        atomicAdd(p + stride, 1);
        atomicAdd((float*)(p + 2 * stride), v);
        atomicMin(p + 3 * stride, ts_enc_min(v));
        atomicMax(p + 4 * stride, ts_enc_max(v));
    }
}

// spans s0 + u stride (u < TS_R): their cells (-1: none), presence and values,
// every load issued before the first span's mask
__device__ __forceinline__ void ts_load(const TsArgs& a, int s0, int stride, int* cell, bool* pr,
                                        float* v) {
    int st[TS_R], g[TS_R];
#pragma unroll
    for (int u = 0; u < TS_R; ++u) {
        const int s = s0 + u * stride;
        pr[u] = false;
        v[u] = 0.f;
        if (s < a.n_spans) {
            st[u] = a.start_ms[s];
            g[u] = a.gid[s];
            if (a.has_val) {
                pr[u] = a.vpres[s];
                v[u] = a.val[s];
            }
        }
    }
#pragma unroll
    for (int u = 0; u < TS_R; ++u) {
        const int s = s0 + u * stride;
        cell[u] = s < a.n_spans ? ts_cell(a, s, st[u], g[u]) : -1;
    }
}

// every span of the grid-stride loop into `fold`
template <typename F>
__device__ __forceinline__ void ts_each_span(const TsArgs& a, F fold) {
    const int stride = gridDim.x * blockDim.x;
    for (int s0 = blockIdx.x * blockDim.x + threadIdx.x; s0 < a.n_spans; s0 += TS_R * stride) {
        int cell[TS_R];
        bool pr[TS_R];
        float v[TS_R];
        ts_load(a, s0, stride, cell, pr, v);
#pragma unroll
        for (int u = 0; u < TS_R; ++u)
            if (cell[u] >= 0) fold(cell[u], pr[u], v[u]);
    }
}

// ROUTE 0 global, 1 shared, 2 cluster (see the header)
template <int ROUTE>
__global__ void __launch_bounds__(TS_THREADS, 2) ts_one_kernel(TsArgs a) {
    extern __shared__ int32_t smem[];
    cg::grid_group grid = cg::this_grid();
    const int A = a.has_val ? 5 : 1, cells = a.cells, tid = threadIdx.x;
    const long long n_out = (long long)A * cells;
    const long long gstride = (long long)gridDim.x * blockDim.x;
    const long long gtid = (long long)blockIdx.x * blockDim.x + tid;
    if (ROUTE == 0) {
        for (long long i = gtid; i < n_out; i += gstride) a.out[i] = ts_identity((int)(i / cells));
        grid.sync();
        ts_each_span(a, [&](int cell, bool pres, float v) {
            ts_fold_span(a.out + cell, cells, a.has_val, pres, v);
        });
        grid.sync();
        for (long long i = 3LL * cells + gtid; i < n_out; i += gstride) a.out[i] = ts_decode(a.out[i]);
        return;
    }
    cg::cluster_group cl = cg::this_cluster();
    const int C = (int)cl.num_blocks(), r = (int)cl.block_rank(), per = a.per;
    const int q = blockIdx.x / C, K = gridDim.x / C;
    if (ROUTE == 1) {
        // the output's identity, published to every CTA by the grid sync
        // before the flush
        for (long long i = gtid; i < n_out; i += gstride) a.out[i] = ts_identity((int)(i / cells));
        // a private copy of the whole grid a CTA, local atomics only
        for (int j = tid; j < A * cells; j += blockDim.x) smem[j] = ts_identity(j / cells);
        __syncthreads();
        ts_each_span(a, [&](int cell, bool pres, float v) {
            ts_fold_span(smem + cell, cells, a.has_val, pres, v);
        });
        cl.sync();
        // CTA r reduces its slice of cells over the cluster's C copies
        // (distributed shared memory loads) into its own copy, whose slice
        // r no other CTA reads
        const int sl = (cells + C - 1) / C, lo = r * sl, m = max(0, min(sl, cells - lo));
        for (int j = tid; j < A * m; j += blockDim.x) {
            const int p = j / m, i = p * cells + lo + (j - p * m);
            int y[TS_CLUSTER_MAX];  // every copy's word requested before the first is combined
#pragma unroll
            for (int t = 1; t < TS_CLUSTER_MAX; ++t)
                if (t < C) y[t] = cl.map_shared_rank(smem, (r + t) % C)[i];
            int x = smem[i];
#pragma unroll
            for (int t = 1; t < TS_CLUSTER_MAX; ++t)
                if (t < C) x = ts_combine(p, x, y[t]);
            smem[i] = x;
        }
        cl.sync();  // no CTA leaves while another reads its copy
        grid.sync();
        // the cluster's slice into the output, one device atomic a cell it touched
        for (int j = tid; j < A * m; j += blockDim.x) {
            const int p = j / m, i = p * cells + lo + (j - p * m), x = smem[i];
            if (x == ts_identity(p)) continue;
            if (p == 2) atomicAdd((float*)a.out + i, __int_as_float(x));
            else if (p == 3) atomicMin(a.out + i, x);
            else if (p == 4) atomicMax(a.out + i, x);
            else atomicAdd(a.out + i, x);
        }
        if (A == 1) return;
        grid.sync();
        for (long long i = 3LL * cells + gtid; i < n_out; i += gstride) a.out[i] = ts_decode(a.out[i]);
        return;
    } else {
        // owner slices: CTA r owns cells [r per, (r + 1) per) of each plane.
        // A round: each thread takes TS_R spans, files a record (the cell's
        // offset in its owner's slice | presence << 31, the value) in this
        // CTA's outbox, bucketed by owner; after a cluster barrier each
        // owner pulls its records from every outbox (distributed shared
        // memory loads) and folds them with local atomics
        int32_t* cnt = smem;                       // records a owner this round
        int32_t* off = smem + 16;                  // their offsets in the outbox (17)
        int32_t* from = smem + 33;                 // where this CTA's records start in CTA r + t's
        int32_t* pre = smem + 49;                  // and their prefix over t (17)
        int2* outbox = (int2*)(smem + TS_HEAD);
        int32_t* slice = smem + TS_EXCH_WORDS;
        for (int j = tid; j < A * per; j += blockDim.x) slice[j] = ts_identity(j / per);
        if (tid < TS_CLUSTER_MAX) cnt[tid] = 0;
        __syncthreads();
        const int lane = tid & 31;
        const int rounds = (a.n_spans + gridDim.x * TS_ROUND - 1) / (gridDim.x * TS_ROUND);
        for (int rd = 0; rd < rounds; ++rd) {
            const int s0 = (rd * gridDim.x + blockIdx.x) * TS_ROUND + tid;
            int cell[TS_R], slot[TS_R];
            bool pr[TS_R];
            float v[TS_R];
            ts_load(a, s0, TS_THREADS, cell, pr, v);
#pragma unroll
            for (int u = 0; u < TS_R; ++u) {  // a slot in the owner's bucket, a warp's lanes aggregated
                const int key = cell[u] >= 0 ? cell[u] / per : -1;
                const unsigned same = __match_any_sync(0xffffffffu, key);
                const int leader = __ffs(same) - 1;
                int b = 0;
                if (key >= 0 && lane == leader) b = atomicAdd(&cnt[key], __popc(same));
                slot[u] = __shfl_sync(0xffffffffu, b, leader) + __popc(same & ((1u << lane) - 1));
            }
            __syncthreads();
            if (tid == 0) {
                int acc = 0;
                for (int o = 0; o < C; ++o) {
                    off[o] = acc;
                    acc += cnt[o];
                }
                off[C] = acc;
            }
            __syncthreads();
#pragma unroll
            for (int u = 0; u < TS_R; ++u) {
                if (cell[u] < 0) continue;
                const int o = cell[u] / per;
                outbox[off[o] + slot[u]] = make_int2((cell[u] - o * per) | ((int)pr[u] << 31),
                                                     __float_as_int(v[u]));
            }
            cl.sync();
            if (tid < C) {  // this CTA's range in each outbox, fetched at once
                const int32_t* roff = cl.map_shared_rank(off, (r + tid) % C);
                from[tid] = roff[r];
                cnt[tid] = roff[r + 1] - roff[r];
            }
            __syncthreads();
            if (tid == 0) {
                pre[0] = 0;
                for (int t = 0; t < C; ++t) pre[t + 1] = pre[t] + cnt[t];
            }
            __syncthreads();
            const int total = pre[C];
            for (int k0 = tid; k0 < total; k0 += TS_R * blockDim.x) {
                int2 rec[TS_R];  // TS_R records requested before the first is folded
#pragma unroll
                for (int u = 0; u < TS_R; ++u) {
                    const int k = k0 + u * blockDim.x;
                    if (k < total) {
                        int t = 0;
                        while (pre[t + 1] <= k) ++t;
                        rec[u] = cl.map_shared_rank(outbox, (r + t) % C)[from[t] + k - pre[t]];
                    }
                }
#pragma unroll
                for (int u = 0; u < TS_R; ++u)
                    if (k0 + u * blockDim.x < total)
                        ts_fold_span(slice + (rec[u].x & 0x7FFFFFFF), per, a.has_val,
                                     rec[u].x < 0, __int_as_float(rec[u].y));
            }
            cl.sync();  // every outbox read before the next round refills it
            if (tid < TS_CLUSTER_MAX) cnt[tid] = 0;
            __syncthreads();
        }
        // this cluster's grid as partial q: plane p of partial q at
        // scratch + q n_out + p cells
        const int lo = r * per, m = max(0, min(per, cells - lo));
        for (int j = tid; j < A * m; j += blockDim.x) {
            const int p = j / m, k = j - p * m;
            a.scratch[(long long)q * n_out + (long long)p * cells + lo + k] = slice[p * per + k];
        }
    }
    grid.sync();
    // each output word once: the K partials in order, min and max decoded
    for (long long i = gtid; i < n_out; i += gstride) {
        const int p = (int)(i / cells);
        const int32_t* src = a.scratch + i;
        int x = src[0], k = 1;
        for (; k + 8 <= K; k += 8) {  // eight partials requested, then combined in order
            int y[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) y[u] = src[(k + u) * n_out];
#pragma unroll
            for (int u = 0; u < 8; ++u) x = ts_combine(p, x, y[u]);
        }
        for (; k < K; ++k) x = ts_combine(p, x, src[k * n_out]);
        a.out[i] = p >= 3 ? ts_decode(x) : x;
    }
}

static int ts_attrs_set = 0;

static cudaError_t ts_attrs() {
    if (ts_attrs_set) return cudaSuccess;
    cudaError_t e = cudaSuccess;
    for (const void* k : {(const void*)ts_one_kernel<1>, (const void*)ts_one_kernel<2>}) {
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     TS_SMEM_CTA_MAX);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (e == cudaSuccess) ts_attrs_set = 1;
    return e;
}

static const void* ts_kernel(int route) {
    return route == 0 ? (const void*)ts_one_kernel<0>
                      : route == 1 ? (const void*)ts_one_kernel<1> : (const void*)ts_one_kernel<2>;
}

static void ts_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* at, int ctas, int cluster,
                      int smem, cudaStream_t st) {
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3(ctas);
    cfg->blockDim = dim3(TS_THREADS);
    cfg->dynamicSmemBytes = smem;
    cfg->stream = st;
    at[0].id = cudaLaunchAttributeCooperative;
    at[0].val.cooperative = 1;
    cfg->attrs = at;
    cfg->numAttrs = 1;
    if (cluster > 1) {
        at[1].id = cudaLaunchAttributeClusterDimension;
        at[1].val.clusterDim.x = cluster;
        at[1].val.clusterDim.y = 1;
        at[1].val.clusterDim.z = 1;
        cfg->numAttrs = 2;
    }
}

// CTAs of one route (0 global, 1 shared, 2 cluster) that can be
// co-resident on the current device (the cooperative launch's limit),
// with `cluster` CTAs a cluster and `smem` bytes each. Returns 0 and sets
// *ctas, or the cudaError_t.
TT_EXPORT int tt_timeseries_ctas(int route, int cluster, int smem, int* ctas) {
    cudaError_t e = ts_attrs();
    if (e != cudaSuccess) return (int)e;
    int dev, sms, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)))
        return (int)e;
    if (cluster <= 1) {
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ts_kernel(route), TS_THREADS,
                                                          smem);
        *ctas = per_sm * sms;
        return (int)e;
    }
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at[2];
    ts_config(&cfg, &at[0], cluster, cluster, smem, 0);
    cfg.attrs = &at[1];  // the cluster dimension alone
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, ts_kernel(route), &cfg);
    *ctas = clusters * cluster;
    return (int)e;
}

// desc/prog/rconds: the span program buffer (ops/filter.py layout);
// resmask: n_rc * n_res_b scratch. route 0 global, 1 shared (a private
// copy of the grid a CTA), 2 cluster (`per` cells of each plane a CTA);
// cluster CTAs a cluster, `smem` bytes each; scratch: ctas / cluster
// partial grids (route 2). out: the A planes of G x n_buckets
// cells (vmin / vmax as f32 bits). ctas: the grid, at most
// tt_timeseries_ctas' count, a multiple of cluster.
TT_EXPORT int tt_timeseries(const long long* desc, const int32_t* prog, int len,
                            const int32_t* rconds, int n_rc, uint8_t* resmask, int n_res_b,
                            const int32_t* res_idx, const int32_t* tsid, int n_traces_b,
                            const int32_t* start_ms, const int32_t* gid, const float* val,
                            const uint8_t* vpres, int t0, int step, int n_spans, int n_buckets,
                            int G, int has_val, int route, int cluster, int per, int smem,
                            int ctas, int32_t* scratch, int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    long long cells = (long long)G * n_buckets;
    const int A = has_val ? 5 : 1;
    const long long need = route == 1 ? 4LL * A * cells
                                      : 4LL * A * per + 4LL * TS_EXCH_WORDS;
    if (step < 1 || n_buckets < 1 || G < 1 || cells > (1 << 24) || n_spans < 0 || ctas < 1 ||
        (has_val && (!val || !vpres)) || route < 0 || route > 2 ||
        (route > 0 && (cluster < 1 || cluster > TS_CLUSTER_MAX || ctas % cluster ||
                       (route == 2 && !scratch) ||
                       smem < need || smem > TS_SMEM_CTA_MAX ||
                       (route == 2 && (per < 1 || (long long)per * cluster < cells)))))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = ts_attrs();
    if (e != cudaSuccess) return (int)e;
    if (n_rc > 0) {
        long long n = (long long)n_rc * n_res_b;
        res_pass_kernel<<<tt_blocks(n, 256), 256, 0, st>>>(desc, rconds, n_rc, n_res_b, resmask);
        TT_LAUNCHED();
    }
    TsArgs a{prog, len, desc, resmask, n_res_b, res_idx, tsid, n_traces_b, start_ms, gid, val,
             vpres, t0, step, n_spans, n_buckets, G, has_val, (int)cells, per, scratch, out};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute at[2];
    ts_config(&cfg, at, ctas, route > 0 ? cluster : 1, route > 0 ? smem : 0, st);
    e = route == 0 ? cudaLaunchKernelEx(&cfg, ts_one_kernel<0>, a)
                   : route == 1 ? cudaLaunchKernelEx(&cfg, ts_one_kernel<1>, a)
                                : cudaLaunchKernelEx(&cfg, ts_one_kernel<2>, a);
    if (e != cudaSuccess) return (int)e;
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}

// M4: B6 over this rank's Bl stacked blocks in ONE launch (the block on
// gridDim.y), into one (G, n_buckets) grid (parallel/timeseries.py).
// Replaces the per-shard fold of tempo_tpu/parallel/timeseries.py:45-131
// (`make_sharded_timeseries`' `local`) before its psum / pmin / pmax.
// Each block brings its own descriptor table (descs[b]: its dictionary
// codes the query its own way, and its columns sit at its own row), its
// own origin t0s[b] and span count nspans[b]; group ids are global.
// min and max stay in B6's ordered-int32 encoding (vmin / vmax as int32)
// so the caller's all_reduce MIN / MAX keep B6's NaN, -0 and inf rules;
// tt_ts_stacked_finish decodes them after the collective.
//
// Bound: bytes -- per span the columns the program names plus start_ms,
// gid, val and vpres (13 B), the grid written once. Launch slot 1.
TT_EXPORT int tt_timeseries_stacked(const long long* descs, int Bl, const int32_t* prog, int len,
                                    long long S, const int32_t* tsid, int n_traces_b,
                                    const int32_t* start_ms, const int32_t* gid, const float* val,
                                    const uint8_t* vpres, const int32_t* t0s,
                                    const int32_t* nspans, int step,
                                    int n_buckets, int G, int has_val, int32_t* counts,
                                    int32_t* vcnt, float* vsum, int32_t* vmin, int32_t* vmax,
                                    void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    long long cells = (long long)G * n_buckets;
    if (Bl < 1 || Bl > 65535 || step < 1 || n_buckets < 1 || G < 1 || cells > (1 << 24) ||
        S < 0 || S > INT32_MAXV ||
        (has_val && (!val || !vpres || !vcnt || !vsum || !vmin || !vmax)))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int32_t) * cells, st);
    if (e == cudaSuccess && has_val) e = cudaMemsetAsync(vcnt, 0, sizeof(int32_t) * cells, st);
    if (e == cudaSuccess && has_val) e = cudaMemsetAsync(vsum, 0, sizeof(float) * cells, st);
    if (e != cudaSuccess) return (int)e;
    if (has_val) {
        ts_init_kernel<<<tt_blocks(cells, 256), 256, 0, st>>>(vmin, vmax, (int)cells);
        TT_LAUNCHED_SLOT(1);
    }
    size_t smem = (size_t)cells * sizeof(int32_t) * (has_val ? 5 : 1);
    int span_blocks = tt_blocks(S, 256);  // a block's spans fit its row of S
    if (smem <= TS_SMEM_MAX) {
        e = cudaFuncSetAttribute(ts_fold_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)TS_SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        int per = (264 + Bl - 1) / Bl;  // about 2 blocks a SM in all, each flushes its cells
        dim3 grid(span_blocks < per ? span_blocks : per, Bl);
        ts_fold_kernel<true><<<grid, 256, smem, st>>>(
            prog, len, nullptr, descs, S, nullptr, 0, nullptr, tsid, n_traces_b, start_ms, gid,
            val, vpres, 0, 0, t0s, nspans, step, n_buckets, G, has_val, counts, vcnt, vsum, vmin,
            vmax);
    } else {
        int per = (132 * 16 + Bl - 1) / Bl;
        dim3 grid(span_blocks < per ? span_blocks : per, Bl);
        ts_fold_kernel<false><<<grid, 256, 0, st>>>(
            prog, len, nullptr, descs, S, nullptr, 0, nullptr, tsid, n_traces_b, start_ms, gid,
            val, vpres, 0, 0, t0s, nspans, step, n_buckets, G, has_val, counts, vcnt, vsum, vmin,
            vmax);
    }
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}

// M4's decode after the collective: vmin / vmax (n,) in place to f32 bits
TT_EXPORT int tt_ts_stacked_finish(int32_t* vmin, int32_t* vmax, int n, void* stream) {
    if (n < 1) return (int)cudaErrorInvalidValue;
    ts_finish_kernel<<<tt_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(vmin, vmax, n);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}
