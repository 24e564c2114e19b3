// B5a: Q multi-query predicate programs over one staged block, and B5b:
// the row-wise top-k over their (Q, T) trace masks.
//
// B5a replaces tempo_tpu/ops/multiquery.py:350/:356
// `_compiled_multiquery(...).run`, bit for bit. Each query is a CNF
// program (tempo_tpu_torch/ops/multiquery.py lower_plan): span
// conditions (int32 column, opcode, operands, a PAD guard for span@res
// columns) OR-ed within a clause, clauses AND-ed within a tracify group,
// a group true for a trace when any of its spans passes; trace
// conditions and group results are atoms, OR-ed within a trace clause,
// trace clauses AND-ed (clauses at index >= n_tclauses count as true).
// The matched-span count is the union of the query's live groups (every
// valid span when it has none), zeroed where the trace fails.
//
// Design: one thread block per (tile of MQ_WARPS traces, query), the
// query's program tables and column pointers loaded once into shared
// memory. One warp walks one trace's span range 32 spans at a time;
// each lane evaluates its span into a group bitmask (at most MQ_NG = 8
// groups), __reduce_or_sync folds the per-group hits and
// __ballot_sync/__popc the union count, and lane 0 folds the trace
// clauses. Nothing of XLA's (Q, P, S) intermediates is built.
//
// Bound: bytes. The function must read each span column the programs
// name once (4 B a span) plus span_off, and write 5 B a (query, trace);
// this kernel re-reads the columns once per query (from L2 when a block
// fits), so it moves up to Q times that floor.
//
// B5b replaces tempo_tpu/ops/multiquery.py:459/:461 `_compiled_mq_select`:
// the composite-key bitonic select of K2 (select.cuh), run once for all
// Q rows with the row on gridDim.y; launch slot 1 of this library.
//
// M2 (mq_partial, slot 2) and M3 (mq_combine, slot 3) split B5a at the
// mesh's all_reduce: the span-level half over one rank's row slice, then
// the trace-level half over the summed counts (below). All three share
// mq_span_bits and mq_trace_ok.
#include "select.cuh"

// program table layout, one int32 row of MQ_W words per query
// (mirrored by tempo_tpu_torch/ops/multiquery.py _LAYOUT)
#define MQ_P 32
#define MQ_NC 16
#define MQ_NG 8
#define MQ_PT 16
#define MQ_NA 16
#define MQ_TC 8
enum MqField {
    O_COND_COL = 0,
    O_COND_OP = O_COND_COL + MQ_P,
    O_COND_V0 = O_COND_OP + MQ_P,
    O_COND_V1 = O_COND_V0 + MQ_P,
    O_COND_GUARD = O_COND_V1 + MQ_P,
    O_CLAUSE_OFF = O_COND_GUARD + MQ_P,
    O_GROUP_OFF = O_CLAUSE_OFF + MQ_NC + 1,
    O_TCOND_COL = O_GROUP_OFF + MQ_NG + 1,
    O_TCOND_OP = O_TCOND_COL + MQ_PT,
    O_TCOND_V0 = O_TCOND_OP + MQ_PT,
    O_TCOND_V1 = O_TCOND_V0 + MQ_PT,
    O_ATOM_KIND = O_TCOND_V1 + MQ_PT,
    O_ATOM_IDX = O_ATOM_KIND + MQ_NA,
    O_TCLAUSE_OFF = O_ATOM_IDX + MQ_NA,
    O_N_GROUPS = O_TCLAUSE_OFF + MQ_TC + 1,
    O_N_TCLAUSES,
    MQ_W_USED
};
#define MQ_W 296
static_assert(MQ_W_USED <= MQ_W, "program row too short");
#define MQ_SC 32  // span columns a group may name
#define MQ_TCOLS 16  // trace columns
#define MQ_WARPS 8

// the reference's _cmp_code: padded slots (-1) and unknown codes are false
__device__ __forceinline__ bool cmp_code(int op, int x, int v0, int v1) {
    switch (op) {
        case 0: return x == v0;
        case 1: return x != v0;
        case 2: return x != v0 && x >= 0;
        case 3: return x < v0;
        case 4: return x <= v0;
        case 5: return x > v0;
        case 6: return x >= v0;
        case 7: return x >= v0 && x <= v1;
        default: return false;
    }
}

// The span-level half of one program, shared by B5a and M2: the bitmask
// of the NG groups whose clauses all hold for span s (AND over a
// group's clauses of an OR over each clause's conditions; the table
// offsets clamped as XLA clamps its gathers).
__device__ __forceinline__ unsigned mq_span_bits(const int32_t* pg, const int32_t* const* scol,
                                                 int n_sc, int s, int P, int NC, int NG) {
    unsigned bits = 0;
    for (int g = 0; g < NG; ++g) {
        const int c0 = tt_clamp(pg[O_GROUP_OFF + g], 0, NC);
        const int c1 = tt_clamp(pg[O_GROUP_OFF + g + 1], 0, NC);
        bool ok = true;  // AND over the group's clauses
        for (int c = c0; c < c1 && ok; ++c) {
            const int p0 = tt_clamp(pg[O_CLAUSE_OFF + c], 0, P);
            const int p1 = tt_clamp(pg[O_CLAUSE_OFF + c + 1], 0, P);
            bool any = false;  // OR over the clause's conditions
            for (int p = p0; p < p1 && !any; ++p) {
                const int x = n_sc > 0 ? scol[tt_clamp(pg[O_COND_COL + p], 0, n_sc - 1)][s] : 0;
                any = cmp_code(pg[O_COND_OP + p], x, pg[O_COND_V0 + p], pg[O_COND_V1 + p]) &&
                      (pg[O_COND_GUARD + p] == 0 || x != PAD_I32);
            }
            ok = any;
        }
        if (ok) bits |= 1u << g;
    }
    return bits;
}

// The trace-level half, shared by B5a and M3: the trace clauses over the
// group hits gany (bit g) and trace t's trace columns; clauses at index
// >= n_tclauses count as true.
__device__ __forceinline__ bool mq_trace_ok(const int32_t* pg, unsigned gany,
                                            const int32_t* const* tcol, int n_tc, int t, int NG,
                                            int PT, int NA, int TC) {
    bool tm = true;
    for (int c = 0; c < TC && tm; ++c) {
        bool cl = c >= pg[O_N_TCLAUSES];
        const int a0 = tt_clamp(pg[O_TCLAUSE_OFF + c], 0, NA);
        const int a1 = tt_clamp(pg[O_TCLAUSE_OFF + c + 1], 0, NA);
        for (int a = a0; a < a1 && !cl; ++a) {
            const int kind = pg[O_ATOM_KIND + a], idx = pg[O_ATOM_IDX + a];
            bool v;
            if (kind == 0) {
                v = (gany >> tt_clamp(idx, 0, NG - 1)) & 1u;
            } else {
                const int j = tt_clamp(idx, 0, PT - 1);
                const int x = n_tc > 0 ? tcol[tt_clamp(pg[O_TCOND_COL + j], 0, n_tc - 1)][t] : 0;
                v = cmp_code(pg[O_TCOND_OP + j], x, pg[O_TCOND_V0 + j], pg[O_TCOND_V1 + j]);
            }
            cl = v && kind >= 0;
        }
        tm = cl;
    }
    return tm;
}

// the live-group mask of a program: bits 0 .. n_groups - 1
__device__ __forceinline__ unsigned mq_live(const int32_t* pg) {
    const int ng = pg[O_N_GROUPS];
    return ng >= 32 ? 0xFFFFFFFFu : ((1u << (ng < 0 ? 0 : ng)) - 1u);
}

__global__ void __launch_bounds__(MQ_WARPS * 32)
mq_eval_kernel(const int32_t* __restrict__ progs, int P, int NC, int NG, int PT, int NA, int TC,
               const long long* __restrict__ span_cols, int n_sc,
               const long long* __restrict__ trace_cols, int n_tc,
               const int32_t* __restrict__ span_off, int n_spans, int n_traces, int n_traces_b,
               uint8_t* __restrict__ tm_out, int32_t* __restrict__ cnt_out) {
    __shared__ int32_t pg[MQ_W];
    __shared__ const int32_t* scol[MQ_SC];
    __shared__ const int32_t* tcol[MQ_TCOLS];
    const int q = blockIdx.y;
    for (int i = threadIdx.x; i < MQ_W; i += blockDim.x) pg[i] = progs[(long long)q * MQ_W + i];
    for (int i = threadIdx.x; i < n_sc; i += blockDim.x) scol[i] = (const int32_t*)span_cols[i];
    for (int i = threadIdx.x; i < n_tc; i += blockDim.x) tcol[i] = (const int32_t*)trace_cols[i];
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * MQ_WARPS + (threadIdx.x >> 5);
    if (t >= n_traces_b) return;  // whole warps leave together
    const int lo = tt_clamp(span_off[t], 0, n_spans);
    const int hi = tt_clamp(span_off[t + 1], 0, n_spans);
    const int ng = pg[O_N_GROUPS];
    const unsigned live = mq_live(pg);
    unsigned gany = 0;  // group g true for this trace: bit g
    int ucount = 0;
    for (int base = lo; base < hi; base += 32) {
        const int s = base + lane;
        unsigned bits = 0;
        bool u = false;
        if (s < hi) {
            bits = mq_span_bits(pg, scol, n_sc, s, P, NC, NG);
            u = ng > 0 ? (bits & live) != 0 : true;
        }
        gany |= __reduce_or_sync(0xFFFFFFFFu, bits);
        ucount += __popc(__ballot_sync(0xFFFFFFFFu, u));
    }
    if (lane != 0) return;
    const bool tm = t < n_traces && mq_trace_ok(pg, gany, tcol, n_tc, t, NG, PT, NA, TC);
    const long long o = (long long)q * n_traces_b + t;
    tm_out[o] = tm;
    cnt_out[o] = tm ? ucount : 0;
}

// progs: (q_b, MQ_W) int32; span_cols / trace_cols: device arrays of
// column pointers (n_spans_b / n_traces_b int32 each); tm, counts: (q_b, n_traces_b)
TT_EXPORT int tt_multiquery(const int32_t* progs, int q_b, int P, int NC, int NG, int PT, int NA,
                            int TC, const long long* span_cols, int n_sc,
                            const long long* trace_cols, int n_tc, const int32_t* span_off,
                            int n_spans, int n_traces, int n_traces_b, uint8_t* tm,
                            int32_t* counts, void* stream) {
    if (P < 1 || P > MQ_P || NC < 1 || NC > MQ_NC || NG < 1 || NG > MQ_NG || PT < 1 ||
        PT > MQ_PT || NA < 1 || NA > MQ_NA || TC < 1 || TC > MQ_TC || n_sc < 0 || n_sc > MQ_SC ||
        n_tc < 0 || n_tc > MQ_TCOLS || q_b < 1 || q_b > 65535 || n_traces_b < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((n_traces_b + MQ_WARPS - 1) / MQ_WARPS, q_b);
    mq_eval_kernel<<<grid, MQ_WARPS * 32, 0, (cudaStream_t)stream>>>(
        progs, P, NC, NG, PT, NA, TC, span_cols, n_sc, trace_cols, n_tc, span_off, n_spans,
        n_traces, n_traces_b, tm, counts);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

// B5b: tm, counts (rows, n); key (n,) shared; out (rows, 3k+1)
TT_EXPORT int tt_mq_select(const uint8_t* tm, const int32_t* key, const int32_t* counts, int n,
                           int rows, int k, u64* comp, int n_pad, int32_t* out, void* stream) {
    return tt_select_rows(tm, key, counts, n, rows, k, comp, n_pad, out, (cudaStream_t)stream, 1);
}

// M2: the span-level half of B5a on this rank's row slice
// [row0, row0 + Sl) of a row-sharded block (parallel/multiquery.py).
// Replaces the per-shard fold of tempo_tpu/parallel/multiquery.py:57-100
// (`fold_rows` + `seg_partial`): per (query, trace) the PARTIAL counts
// of the trace's spans inside the slice for which each group holds
// (rows 0 .. NG - 1) and for which the union of live groups holds (row
// NG; every valid span when the program has no group), out
// (q_b, NG + 1, n_traces_b) int32. The trace's global range
// span_off[t] .. span_off[t + 1] is clipped to the slice, and a span
// counts only when row0 + s < n_spans; a trace with no rows here counts
// 0. The caller's all_reduce SUM stitches the partials exactly.
//
// Design: B5a's warp-per-trace walk with mq_span_bits; each group's
// count is the popcount of its ballot. Launch slot 2.
// Bound: bytes -- the slice's named span columns (4 B a span) once per
// query, span_off read and (NG + 1) x 4 B written per (query, trace).
__global__ void __launch_bounds__(MQ_WARPS * 32)
mq_partial_kernel(const int32_t* __restrict__ progs, int P, int NC, int NG,
                  const int32_t* __restrict__ span_mat, int n_sc, int Sl, int row0,
                  const int32_t* __restrict__ span_off, int n_spans, int n_traces_b,
                  int32_t* __restrict__ out) {
    __shared__ int32_t pg[MQ_W];
    __shared__ const int32_t* scol[MQ_SC];
    const int q = blockIdx.y;
    for (int i = threadIdx.x; i < MQ_W; i += blockDim.x) pg[i] = progs[(long long)q * MQ_W + i];
    for (int i = threadIdx.x; i < n_sc; i += blockDim.x) scol[i] = span_mat + (long long)i * Sl;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int t = blockIdx.x * MQ_WARPS + (threadIdx.x >> 5);
    if (t >= n_traces_b) return;  // whole warps leave together
    const int lo = tt_clamp(span_off[t] - row0, 0, Sl);
    const int hi = tt_clamp(span_off[t + 1] - row0, 0, Sl);
    const int ng = pg[O_N_GROUPS];
    const unsigned live = mq_live(pg);
    int gcount[MQ_NG];
    for (int g = 0; g < MQ_NG; ++g) gcount[g] = 0;
    int ucount = 0;
    for (int base = lo; base < hi; base += 32) {
        const int s = base + lane;
        unsigned bits = 0;
        bool u = false;
        if (s < hi && row0 + s < n_spans) {
            bits = mq_span_bits(pg, scol, n_sc, s, P, NC, NG);
            u = ng > 0 ? (bits & live) != 0 : true;
        }
#pragma unroll
        for (int g = 0; g < MQ_NG; ++g)
            if (g < NG) gcount[g] += __popc(__ballot_sync(0xFFFFFFFFu, (bits >> g) & 1u));
        ucount += __popc(__ballot_sync(0xFFFFFFFFu, u));
    }
    if (lane != 0) return;
    int32_t* o = out + (long long)q * (NG + 1) * n_traces_b + t;
#pragma unroll
    for (int g = 0; g < MQ_NG; ++g)
        if (g < NG) o[(long long)g * n_traces_b] = gcount[g];
    o[(long long)NG * n_traces_b] = ucount;
}

// M3: the trace-level half on the summed counts (q_b, NG + 1,
// n_traces_b) of M2 (tempo_tpu/parallel/multiquery.py:102-125
// `combine`): group g holds for trace t when its count is > 0; the
// trace clauses over those hits and the trace columns; tm & valid
// trace; the union count where tm holds, else 0. M2 then M3 equal B5a
// bit for bit on any row split.
//
// Design: one thread per (trace, query), the program row and the trace
// column pointers in shared memory, mq_trace_ok. Launch slot 3.
// Bound: bytes -- (NG + 1) x 4 B of counts and the named trace columns
// read, 5 B written per (query, trace).
__global__ void mq_combine_kernel(const int32_t* __restrict__ progs, int NG, int PT, int NA,
                                  int TC, const int32_t* __restrict__ counts,
                                  const int32_t* __restrict__ trace_mat, int n_tc, int n_traces,
                                  int n_traces_b, uint8_t* __restrict__ tm_out,
                                  int32_t* __restrict__ cnt_out) {
    __shared__ int32_t pg[MQ_W];
    __shared__ const int32_t* tcol[MQ_TCOLS];
    const int q = blockIdx.y;
    for (int i = threadIdx.x; i < MQ_W; i += blockDim.x) pg[i] = progs[(long long)q * MQ_W + i];
    for (int i = threadIdx.x; i < n_tc; i += blockDim.x)
        tcol[i] = trace_mat + (long long)i * n_traces_b;
    __syncthreads();
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_traces_b) return;
    const int32_t* c = counts + (long long)q * (NG + 1) * n_traces_b + t;
    unsigned gany = 0;
    for (int g = 0; g < NG; ++g)
        if (c[(long long)g * n_traces_b] > 0) gany |= 1u << g;
    const bool tm = t < n_traces && mq_trace_ok(pg, gany, tcol, n_tc, t, NG, PT, NA, TC);
    const long long o = (long long)q * n_traces_b + t;
    tm_out[o] = tm;
    cnt_out[o] = tm ? c[(long long)NG * n_traces_b] : 0;
}

static int mq_dims_bad(int P, int NC, int NG, int PT, int NA, int TC, int q_b) {
    return P < 1 || P > MQ_P || NC < 1 || NC > MQ_NC || NG < 1 || NG > MQ_NG || PT < 1 ||
           PT > MQ_PT || NA < 1 || NA > MQ_NA || TC < 1 || TC > MQ_TC || q_b < 1 || q_b > 65535;
}

// progs (q_b, MQ_W); span_mat (n_sc, Sl) the slice's span columns;
// span_off (n_traces_b + 1,) global; out (q_b, NG + 1, n_traces_b)
TT_EXPORT int tt_mq_partial(const int32_t* progs, int q_b, int P, int NC, int NG,
                            const int32_t* span_mat, int n_sc, int Sl, int row0,
                            const int32_t* span_off, int n_spans, int n_traces_b, int32_t* out,
                            void* stream) {
    if (mq_dims_bad(P, NC, NG, 1, 1, 1, q_b) || n_sc < 0 || n_sc > MQ_SC || Sl < 0 ||
        row0 < 0 || n_traces_b < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((n_traces_b + MQ_WARPS - 1) / MQ_WARPS, q_b);
    mq_partial_kernel<<<grid, MQ_WARPS * 32, 0, (cudaStream_t)stream>>>(
        progs, P, NC, NG, span_mat, n_sc, Sl, row0, span_off, n_spans, n_traces_b, out);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}

// counts (q_b, NG + 1, n_traces_b) summed; trace_mat (n_tc, n_traces_b);
// tm, cnt (q_b, n_traces_b)
TT_EXPORT int tt_mq_combine(const int32_t* progs, int q_b, int NG, int PT, int NA, int TC,
                            const int32_t* counts, const int32_t* trace_mat, int n_tc,
                            int n_traces, int n_traces_b, uint8_t* tm, int32_t* cnt,
                            void* stream) {
    if (mq_dims_bad(1, 1, NG, PT, NA, TC, q_b) || n_tc < 0 || n_tc > MQ_TCOLS || n_traces_b < 1)
        return (int)cudaErrorInvalidValue;
    dim3 grid((n_traces_b + 255) / 256, q_b);
    mq_combine_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        progs, NG, PT, NA, TC, counts, trace_mat, n_tc, n_traces, n_traces_b, tm, cnt);
    TT_LAUNCHED_SLOT(3);
    return (int)cudaGetLastError();
}
