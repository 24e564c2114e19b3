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
// reference are never read).
//
// Design: one thread per span (grid-stride). When the accumulators fit
// in shared memory (TS_SMEM_MAX bytes) each block folds into its own
// copy with shared-memory atomics and flushes the touched cells with
// global atomics; otherwise every span goes straight to global atomics.
// Counts, value counts, min and max are exact (min and max as
// order-preserving int32 encodings of the f32 values, -0.0 below +0.0 as
// in XLA; a NaN encodes to the end of the order that makes it win, so
// it propagates as XLA's min and max do); the f32 sum is order-dependent,
// as XLA's scatter-add is.
//
// Bound: bytes. The function must read each column the program names
// (4 B a span) plus start_ms, gid, val and vpres (13 B a span), and
// write the accumulators once.
#include "cond.cuh"

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

// desc/prog/rconds: the span program buffer (ops/filter.py layout);
// resmask: n_rc * n_res_b scratch; outputs (G, n_buckets): counts, and
// with has_val vcnt, vsum, vmin, vmax (vmin/vmax come back as f32 bits)
TT_EXPORT int tt_timeseries(const long long* desc, const int32_t* prog, int len,
                            const int32_t* rconds, int n_rc, uint8_t* resmask, int n_res_b,
                            const int32_t* res_idx, const int32_t* tsid, int n_traces_b,
                            const int32_t* start_ms, const int32_t* gid, const float* val,
                            const uint8_t* vpres, int t0, int step, int n_spans, int n_buckets,
                            int G, int has_val, int32_t* counts, int32_t* vcnt, float* vsum,
                            int32_t* vmin, int32_t* vmax, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    long long cells = (long long)G * n_buckets;
    if (step < 1 || n_buckets < 1 || G < 1 || cells > (1 << 24) || n_spans < 0 ||
        (has_val && (!val || !vpres || !vcnt || !vsum || !vmin || !vmax)))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaMemsetAsync(counts, 0, sizeof(int32_t) * cells, st);
    if (e == cudaSuccess && has_val) e = cudaMemsetAsync(vcnt, 0, sizeof(int32_t) * cells, st);
    if (e == cudaSuccess && has_val) e = cudaMemsetAsync(vsum, 0, sizeof(float) * cells, st);
    if (e != cudaSuccess) return (int)e;
    if (n_rc > 0) {
        long long n = (long long)n_rc * n_res_b;
        res_pass_kernel<<<tt_blocks(n, 256), 256, 0, st>>>(desc, rconds, n_rc, n_res_b, resmask);
        TT_LAUNCHED();
    }
    if (has_val) {
        ts_init_kernel<<<tt_blocks(cells, 256), 256, 0, st>>>(vmin, vmax, (int)cells);
        TT_LAUNCHED();
    }
    size_t smem = (size_t)cells * sizeof(int32_t) * (has_val ? 5 : 1);
    int span_blocks = tt_blocks(n_spans, 256);
    if (smem <= TS_SMEM_MAX) {
        e = cudaFuncSetAttribute(ts_fold_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)TS_SMEM_MAX);
        if (e != cudaSuccess) return (int)e;
        int blocks = span_blocks < 264 ? span_blocks : 264;  // 2 a SM: each flushes its cells
        ts_fold_kernel<true><<<blocks, 256, smem, st>>>(
            prog, len, desc, nullptr, 0, resmask, n_res_b, res_idx, tsid, n_traces_b, start_ms,
            gid, val, vpres, t0, n_spans, nullptr, nullptr, step, n_buckets, G, has_val, counts,
            vcnt, vsum, vmin, vmax);
    } else {
        int blocks = span_blocks < 132 * 16 ? span_blocks : 132 * 16;
        ts_fold_kernel<false><<<blocks, 256, 0, st>>>(
            prog, len, desc, nullptr, 0, resmask, n_res_b, res_idx, tsid, n_traces_b, start_ms,
            gid, val, vpres, t0, n_spans, nullptr, nullptr, step, n_buckets, G, has_val, counts,
            vcnt, vsum, vmin, vmax);
    }
    TT_LAUNCHED();
    if (has_val) {
        ts_finish_kernel<<<tt_blocks(cells, 256), 256, 0, st>>>(vmin, vmax, (int)cells);
        TT_LAUNCHED();
    }
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
