// K4: res_to_span -- broadcast resource-axis columns to span rows.
//
// Replaces tempo_tpu/ops/stage.py:178-182 `_res_to_span` (a jitted
// clamped gather, one program a column). Semantics per column: out[i] =
// res[min(res_idx[i], n_res - 1)] where res_idx[i] >= 0, else PAD_I32.
//
// ONE launch for every resource column of a staged block (staging's
// `plan.materialize`) or of a stacked fold (M4's mesh body: per-block
// tables, res_idx (Bl, S)): C columns ride by value (RS_COLS a launch;
// more take a launch a chunk), and the outputs are one (C, Bl, S)
// allocation whose rows become the span@<col> columns.
//
// Bound: bytes -- res_idx read once for all C columns and each output
// written once, (4 + 4 C) B a span, plus the tables. A thread takes a
// quad of 4 spans (one 16 B load of res_idx, one 16 B store a column);
// spans off a 16 B boundary, and a quad that a block's row boundary
// cuts, go one at a time. The tables are gathered at random through the
// read-only path: a staged block's table of 1,024 entries stays in L1
// and L2. A copy of the tables in each CTA's shared memory (cp.async)
// measured no faster on the H100 at that size, at one and two columns
// and over 3 stacked blocks (scripts/stage_elect_ab.py), so the tables
// are read where they lie, whatever their size. The grid is sized to
// the card and strides over the quads.
#include "common.cuh"

#define RS_COLS 8                  // kernels.py RES_COLS: columns a launch
#define RS_THREADS 256
#define RS_UNROLL 2
#define RS_QUADS_CTA (RS_THREADS * RS_UNROLL)  // quads a CTA takes at least

struct ResArgs {
    const int32_t* idx;            // (Bl, S) res_idx, rows end to end
    int32_t* out;                  // (C, Bl, S)
    const int32_t* tab[RS_COLS];   // column c: (Bl, n_res[c]) tables
    int n_res[RS_COLS];
    long long n;                   // Bl * S spans
    int Bl, S, C, vec;             // vec: 16 B loads and stores (aligned)
};

__device__ __forceinline__ int rs_one(const ResArgs& a, int c, int b, int r) {
    if (r < 0) return PAD_I32;
    const int nr = a.n_res[c];
    return __ldg(a.tab[c] + b * nr + (r < nr ? r : nr - 1));
}

// one span at a time: e in [0, n)
__device__ __forceinline__ void rs_span(const ResArgs& a, long long e) {
    const int b = a.Bl == 1 ? 0 : (int)(e / a.S);
    const int r = a.idx[e];
    for (int c = 0; c < a.C; ++c) a.out[c * a.n + e] = rs_one(a, c, b, r);
}

__global__ void __launch_bounds__(RS_THREADS) res_to_span_kernel(const __grid_constant__ ResArgs a) {
    const long long nq = a.vec ? a.n >> 2 : 0;  // whole quads
    const long long stride = (long long)gridDim.x * RS_THREADS;
    long long q0 = (long long)blockIdx.x * RS_THREADS + threadIdx.x;
    int4 x[RS_UNROLL];
#pragma unroll
    for (int u = 0; u < RS_UNROLL; ++u)  // the first quads' loads, issued before the loop
        if (q0 + u * stride < nq) x[u] = __ldcs((const int4*)a.idx + q0 + u * stride);
    for (bool first = true; q0 < nq; q0 += RS_UNROLL * stride, first = false) {
        if (!first) {
#pragma unroll
            for (int u = 0; u < RS_UNROLL; ++u)  // every quad's load issued first
                if (q0 + u * stride < nq) x[u] = __ldcs((const int4*)a.idx + q0 + u * stride);
        }
#pragma unroll
        for (int u = 0; u < RS_UNROLL; ++u) {
            const long long q = q0 + u * stride;
            if (q >= nq) continue;
            const long long e = 4 * q;
            const int b = a.Bl == 1 ? 0 : (int)(e / a.S);
            if ((long long)(b + 1) * a.S < e + 4) {  // a row boundary cuts the quad
                for (int k = 0; k < 4; ++k) rs_span(a, e + k);
                continue;
            }
            for (int c = 0; c < a.C; ++c) {
                const int4 y = make_int4(rs_one(a, c, b, x[u].x), rs_one(a, c, b, x[u].y),
                                         rs_one(a, c, b, x[u].z), rs_one(a, c, b, x[u].w));
                __stcs((int4*)(a.out + c * a.n + e), y);
            }
        }
    }
    // the spans past the last whole quad (all of them where !vec)
    for (long long e = 4 * nq + (long long)blockIdx.x * RS_THREADS + threadIdx.x; e < a.n;
         e += stride)
        rs_span(a, e);
}

static int rs_ctas = 0;  // co-resident CTAs on the card

// idx: Bl rows of S res_idx; tabs: C table pointers (each Bl rows of
// n_res[c]), host memory; out: (C, Bl, S).
TT_EXPORT int tt_res_to_span(const long long* tabs, const int* n_res, int C, const int32_t* idx,
                             int Bl, int S, int32_t* out, void* stream) {
    if (C < 1 || C > RS_COLS || Bl < 1 || S < 0) return (int)cudaErrorInvalidValue;
    ResArgs a{};
    a.idx = idx;
    a.out = out;
    a.n = (long long)Bl * S;
    a.Bl = Bl;
    a.S = S > 0 ? S : 1;
    a.C = C;
    // column c > 0 starts at out + c n: on a 16 B boundary where n % 4 == 0
    a.vec = (((uintptr_t)idx) & 15) == 0 && (((uintptr_t)out) & 15) == 0 &&
            (C == 1 || (a.n & 3) == 0);
    for (int c = 0; c < C; ++c) {
        if (n_res[c] < 1) return (int)cudaErrorInvalidValue;
        a.tab[c] = (const int32_t*)tabs[c];
        a.n_res[c] = n_res[c];
    }
    if (a.n == 0) return 0;
    if (!rs_ctas) {
        int dev, sms, per_sm;
        cudaError_t e;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, res_to_span_kernel,
                                                               RS_THREADS, 0)))
            return (int)e;
        rs_ctas = (per_sm > 1 ? per_sm : 1) * sms;
    }
    const long long want = ((a.n >> 2) + RS_QUADS_CTA - 1) / RS_QUADS_CTA;
    const int ctas = (int)(want < 1 ? 1 : want < rs_ctas ? want : rs_ctas);
    res_to_span_kernel<<<ctas, RS_THREADS, 0, (cudaStream_t)stream>>>(a);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}
