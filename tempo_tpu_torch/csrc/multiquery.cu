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
    const unsigned live = ng >= 32 ? 0xFFFFFFFFu : ((1u << (ng < 0 ? 0 : ng)) - 1u);
    unsigned gany = 0;  // group g true for this trace: bit g
    int ucount = 0;
    for (int base = lo; base < hi; base += 32) {
        const int s = base + lane;
        unsigned bits = 0;
        bool u = false;
        if (s < hi) {
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
            u = ng > 0 ? (bits & live) != 0 : true;
        }
        gany |= __reduce_or_sync(0xFFFFFFFFu, bits);
        ucount += __popc(__ballot_sync(0xFFFFFFFFu, u));
    }
    if (lane != 0) return;
    bool tm = t < n_traces;
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
