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
// Design. A grid sized to the card (at most the CTAs resident at once)
// walks tiles of MQ_TT traces; gridDim.y takes the programs in chunks of
// 32 / P, so that a chunk's conditions fill one 32-bit word. Each CTA
// reads its chunk's program rows into shared memory once and compiles
// them there (mq_compile, below): equality conditions into a hash of
// (column, value) -> condition bits, the others into a list, and, where
// the offsets are monotone, the clause / group / union structure into
// word masks. A warp walks one trace's spans 32 at a time: each lane's
// n_sc column words arrive once, coalesced, by cp.async into the warp's
// stage in shared memory; then one condition word a span (a hash probe
// a column), a handful of word operations for every program of the
// chunk at once, one __reduce_or_sync of the group words a trace and one
// __reduce_add_sync of four programs' unions a step; lane q folds
// program q's trace clauses. A tile's tm and counts
// are staged per program in shared memory and written out as rows,
// coalesced, in the (q_b, n_traces_b) layout B5b and the batcher read.
// Offsets are gathered as the reference gathers them (a negative index
// counts from the end; signed count differences), so programs and span
// offsets that no lowering or staging writes still give its answers.
//
// Bound: bytes. The function must read each span column the programs
// name once (4 B a span) plus span_off, and write 5 B a (program,
// trace): at chip_smoke.py's phase-4b shape (16 programs of two
// conditions, 1,048,576 spans, 32,768 traces) 8.4 MB of columns and 2.6
// MB of output, 0.0033 ms at 3.35 TB/s. Each column word comes from
// device memory once a chunk, each program once a CTA. What is left is
// the per-trace run of the chunk (scripts/batched_search_ab.py --split:
// 42.7 us of device time against the earlier design's 170.8, NVIDIA H100
// 80GB HBM3, 700 W; PERF.md has each phase's share).
//
// B5b replaces tempo_tpu/ops/multiquery.py:459/:461 `_compiled_mq_select`:
// K2's masked top-k (select.cuh) on each of the Q rows, launch slot 1 of
// this library. Where kernels.select_plan takes K2's two-pass route,
// tt_mq_select_tiled runs it with the row on gridDim.y of the tile pass
// (each CTA reads one tile of its row's mask, the shared key and nothing
// of counts) and one merge CTA a row: 2 launches a call. Elsewhere (k >
// K_SMALL, or candidates not fewer than the rows) tt_mq_select runs the
// full sort of select.cuh, its passes over all Q rows at once. Bound:
// bytes -- Q x n x 1 B of mask, the key, counts at the Q x k winners and
// the output (672 KB, 0.00020 ms at the phase-4b shape); the two passes
// took 26.6 us of device time there against 115.3 for the full sort and
// 110 for torch.topk (same card, same script).
//
// M2 (mq_partial, slot 2) and M3 (mq_combine, slot 3) split B5a at the
// mesh's all_reduce: the span-level half over one rank's row slice, then
// the trace-level half over the summed counts (below). M2 runs B5a's
// compiled chunk (mq_compile, mq_cond_bits, mq_group_word, mq_union_word;
// mq_span_bits elsewhere) and counts where B5a ORs; M3 shares
// mq_trace_ok with B5a.
#include <mutex>

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

#define MQ_QC 32  // programs a chunk holds at most (32 / P): lane q of a warp folds program q
#define MQ_TT 64  // traces a tile: MQ_TT / MQ_WARPS a warp
#define MQ_SMEM_MAX (110 * 1024)  // B5a's dynamic shared memory at the largest chunk and n_sc

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

// The span halves of a chunk of nq programs, compiled once a CTA
// (mq_compile). The chunk holds at most 32 / P programs, so its
// conditions fit one word: condition p of the chunk's program q is bit
// q * P + p. A span's word (mq_cond_bits) takes the equality conditions
// from one hash probe a column -- hkey/hmask map (column, value) to the
// bits of the conditions it meets -- and evaluates the others one by one:
// other[i].x = col | m3 << 8 | bit << 16, and the condition holds for a
// value v when bit (v < y ? 0 : v == y ? 1 : 2) of m3 is set and z <= v
// <= w (cmp_code and the PAD guard in one form). A condition that can
// never hold (a padded slot; an equality guarded at PAD) has no bit set.
//
// Offsets are gathered as the reference gathers them (mq_jidx: a negative
// index counts from the end of its table, then clamps), and a group holds
// where its signed count of clauses that hold equals the difference of
// its two offsets. Where every program's clause and group offsets lie in
// their tables and are monotone (lower_plan gives no other), that is: each
// clause is a run of bits and each group a run of clauses holding all
// together, so the chunk's programs run as word operations (mq_group_word,
// mq_union_word): OR within each clause's run (sc: the bits whose
// partner s = 1, 2, 4, 8, 16 above lies in the same clause) to the
// clause's first bit (hc), AND over each group's clause heads (sg, to the
// group's first bit, hg); program q's union holds where any of its P
// bits is set among its live groups' heads (lhg) and cu. A group with no
// clause holds on every span, a group
// with an empty clause on none (gdesc: a group's head bit, or 32 for
// always, 33 for never; cu: the programs whose union always holds).
// Other chunks, of B5a and of M2, run each program's row as it stands
// (mq_span_bits).
#define MQ_HASH 64  // hash slots: twice the conditions a chunk holds
#define MQ_EMPTY (~0ull)  // an empty hash slot (no column is 2^32 - 1)
#define MQ_ALWAYS 32
#define MQ_NEVER 33
#define MQ_RUNS 14  // a program's run words: sc[5], sg[5], hc, hg, lhg, cu
struct __align__(16) MqProg {
    int4 other[32];
    unsigned long long hkey[MQ_HASH];
    unsigned hmask[MQ_HASH];
    unsigned eqcols;  // the columns with an equality condition
    int n_other, regular;
    unsigned sc[5], sg[5], hc, hg, lhg, cu;
    unsigned char gdesc[MQ_QC * MQ_NG];
    unsigned run[MQ_QC * MQ_RUNS];  // compile scratch: each program's run words
    int bad[MQ_QC];  // compile scratch: the program's offsets are not regular
};

// the row an offset gathers from a table of n rows, as XLA's gather takes
// the reference's: a negative index counts from the end, then clamps
__device__ __forceinline__ int mq_jidx(int i, int n) { return tt_clamp(i < 0 ? i + n : i, 0, n - 1); }

// bits [lo, hi) of a word, none when hi <= lo
__device__ __forceinline__ unsigned mq_range_bits(int lo, int hi) {
    if (hi <= lo) return 0u;
    return (hi - lo >= 32 ? 0xFFFFFFFFu : ((1u << (hi - lo)) - 1u)) << lo;
}

__device__ __forceinline__ int4 mq_cond(const int32_t* pg, int p, int n_sc) {
    const int op = pg[O_COND_OP + p], v0 = pg[O_COND_V0 + p];
    int m3 = 0, lo = PAD_I32, hi = INT32_MAXV;  // m3 bits: v < v0, v == v0, v > v0
    switch (op) {
        case 0: m3 = 2; break;
        case 1: m3 = 5; break;
        case 2: m3 = 5; lo = 0; break;
        case 3: m3 = 1; break;
        case 4: m3 = 3; break;
        case 5: m3 = 4; break;
        case 6: m3 = 6; break;
        case 7: m3 = 6; hi = pg[O_COND_V1 + p]; break;
        default: break;
    }
    if (pg[O_COND_GUARD + p] != 0 && lo == PAD_I32) lo = PAD_I32 + 1;  // v != PAD
    const int col = n_sc > 0 ? tt_clamp(pg[O_COND_COL + p], 0, n_sc - 1) : 0;
    return make_int4(col | (m3 << 8), v0, lo, hi);
}

__device__ __forceinline__ unsigned mq_hash(int v, int col) {
    return ((unsigned)v * 0x9E3779B1u ^ (unsigned)col * 0x85EBCA77u) >> 26;
}

__device__ __forceinline__ unsigned long long mq_key(int v, int col) {
    return ((unsigned long long)(unsigned)col << 32) | (unsigned)v;
}

// a run [a, b) of bits into program words m[0..4]: bits whose partner
// s = 1, 2, 4, 8, 16 above lies in the run
__device__ __forceinline__ void mq_run(unsigned* m, int a, int b) {
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        const unsigned r = mq_range_bits(a, b - (1 << i));
        if (r) atomicOr(m + i, r);
    }
}

// Compile the span halves of the nq <= 32 / P program rows pg[q * MQ_W]
// into pr, all threads of the CTA together (at least one warp): one item
// a condition, clause or group of each program, then warp 0 folds the
// programs' runs into the chunk's words. Ends with the CTA synced.
__device__ void mq_compile(const int32_t* pg, int nq, int P, int NC, int NG, int n_sc,
                           MqProg* pr) {
    for (int i = threadIdx.x; i < MQ_HASH; i += blockDim.x) {
        pr->hkey[i] = MQ_EMPTY;
        pr->hmask[i] = 0;
    }
    for (int i = threadIdx.x; i < nq * MQ_RUNS; i += blockDim.x) pr->run[i] = 0;
    for (int i = threadIdx.x; i < nq; i += blockDim.x) pr->bad[i] = 0;
    if (threadIdx.x == 0) {
        pr->eqcols = 0;
        pr->n_other = 0;
    }
    __syncthreads();
    const int per = P + NC + NG;  // a program's conditions, clauses and groups
    for (int i = threadIdx.x; i < nq * per; i += blockDim.x) {
        const int q = i / per, j = i - q * per, base = q * P;
        const int32_t* r = pg + q * MQ_W;
        unsigned* run = pr->run + q * MQ_RUNS;
        if (j < P) {  // condition j: to the hash or to other[]
            const int4 e = mq_cond(r, j, n_sc);
            const int col = e.x & 0xFF, m3 = (e.x >> 8) & 7, bit = base + j;
            if (m3 == 0) continue;  // never holds
            if (m3 == 2 && e.w == INT32_MAXV && (e.z == PAD_I32 || e.z == PAD_I32 + 1)) {
                if (e.z == PAD_I32 + 1 && e.y == PAD_I32) continue;  // guarded at PAD: never
                const unsigned long long key = mq_key(e.y, col);
                for (unsigned h = mq_hash(e.y, col);; h = (h + 1) & (MQ_HASH - 1)) {
                    const unsigned long long k = atomicCAS(pr->hkey + h, MQ_EMPTY, key);
                    if (k == MQ_EMPTY || k == key) {
                        atomicOr(pr->hmask + h, 1u << bit);
                        break;
                    }
                }
                atomicOr(&pr->eqcols, 1u << col);
            } else {
                pr->other[atomicAdd(&pr->n_other, 1)] = make_int4(e.x | (bit << 16), e.y, e.z, e.w);
            }
        } else if (j < P + NC) {  // clause c
            const int c = j - P;
            const int ra = r[O_CLAUSE_OFF + c], rb = r[O_CLAUSE_OFF + c + 1];
            if (ra < 0 || rb > P || ra > rb) {
                atomicOr(pr->bad + q, 1);
            } else if (rb > ra && c >= r[O_GROUP_OFF] && c < r[O_GROUP_OFF + NG]) {
                mq_run(run, base + ra, base + rb);  // a clause some group names
                atomicOr(run + 10, 1u << (base + ra));
            }
        } else {  // group g
            const int g = j - P - NC;
            const int ra = r[O_GROUP_OFF + g], rb = r[O_GROUP_OFF + g + 1];
            const int ng = r[O_N_GROUPS];
            if (g == 0 && ng <= 0) atomicOr(run + 13, 1u << base);  // no group: every span
            if (ra < 0 || rb > NC || ra > rb) {
                atomicOr(pr->bad + q, 1);
                continue;
            }
            int d = MQ_ALWAYS;
            if (rb > ra) {
                bool empty = false;
                for (int c = ra; c < rb; ++c) empty = empty || r[O_CLAUSE_OFF + c + 1] <= r[O_CLAUSE_OFF + c];
                d = empty ? MQ_NEVER : base + r[O_CLAUSE_OFF + ra];
                if (!empty) {
                    mq_run(run + 5, d, base + r[O_CLAUSE_OFF + rb]);
                    atomicOr(run + 11, 1u << d);
                    if (g < ng) atomicOr(run + 12, 1u << d);
                }
            } else if (g < ng) {
                atomicOr(run + 13, 1u << base);  // a live group that always holds
            }
            pr->gdesc[q * MQ_NG + g] = (unsigned char)d;
        }
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // warp 0: lane q folds program q in, where it is regular
        const unsigned full = 0xFFFFFFFFu;
        const int q = threadIdx.x;
        const bool real = q < nq, mono = !real || pr->bad[q] == 0;
        const bool regular = __all_sync(full, mono);
        unsigned w[MQ_RUNS];
#pragma unroll
        for (int k = 0; k < MQ_RUNS; ++k)
            w[k] = __reduce_or_sync(full, real && mono ? pr->run[q * MQ_RUNS + k] : 0u);
        if (q == 0) {
            pr->regular = regular;
#pragma unroll
            for (int i = 0; i < 5; ++i) {
                pr->sc[i] = w[i];
                pr->sg[i] = w[5 + i];
            }
            pr->hc = w[10];
            pr->hg = w[11];
            pr->lhg = w[12];
            pr->cu = w[13];
        }
    }
    __syncthreads();
}

// The chunk's condition word for one span whose value of column j is
// v[j * vs]: one hash probe a column with equality conditions, then the
// other conditions.
__device__ __forceinline__ unsigned mq_cond_bits(const MqProg& pr, const int32_t* v,
                                                 long long vs) {
    unsigned cb = 0;
    for (unsigned m = pr.eqcols; m; m &= m - 1) {
        const int col = __ffs(m) - 1;
        const int x = v[col * vs];
        const unsigned long long key = mq_key(x, col);
        for (unsigned h = mq_hash(x, col);; h = (h + 1) & (MQ_HASH - 1)) {
            const unsigned long long k = pr.hkey[h];
            if (k == key) {
                cb |= pr.hmask[h];
                break;
            }
            if (k == MQ_EMPTY) break;
        }
    }
    for (int i = 0; i < pr.n_other; ++i) {
        const int4 c = pr.other[i];
        const int x = v[(c.x & 0xFF) * vs];
        const int sel = (x > c.y) + (x >= c.y);
        cb |= (unsigned)((c.x >> (8 + sel)) & (x >= c.z) & (x <= c.w) & 1) << ((c.x >> 16) & 31);
    }
    return cb;
}

// the live-group mask of a program row: bits 0 .. n_groups - 1
__device__ __forceinline__ unsigned mq_live(const int32_t* pg) {
    const int ng = pg[O_N_GROUPS];
    return ng >= 32 ? 0xFFFFFFFFu : ((1u << (ng < 0 ? 0 : ng)) - 1u);
}

// whether clause c of a program row holds for one span whose value of
// column j is val(j): a condition in [co[c], co[c + 1]) does (each offset
// gathered by mq_jidx)
template <class Val>
__device__ __forceinline__ bool mq_clause(const int32_t* pg, int c, Val val, int n_sc, int P) {
    const int p1 = mq_jidx(pg[O_CLAUSE_OFF + c + 1], P + 1);
    bool any = false;  // OR over the clause's conditions
    for (int p = mq_jidx(pg[O_CLAUSE_OFF + c], P + 1); p < p1 && !any; ++p) {
        const int x = n_sc > 0 ? val(tt_clamp(pg[O_COND_COL + p], 0, n_sc - 1)) : 0;
        any = cmp_code(pg[O_COND_OP + p], x, pg[O_COND_V0 + p], pg[O_COND_V1 + p]) &&
              (pg[O_COND_GUARD + p] == 0 || x != PAD_I32);
    }
    return any;
}

// The span-level half of one program row as it stands, shared by M2 and
// by B5a's chunks that are not regular: the bitmask of the NG groups that
// hold for one span whose value of column j is val(j). Group g holds
// where its signed count of clauses that hold over [go[g], go[g + 1])
// equals the difference of those offsets (the reference's cumsum
// differences; each offset gathered by mq_jidx). Where that difference is
// the range's length (every monotone row) all its clauses must hold, and
// the group stops at the first that fails.
template <class Val>
__device__ __forceinline__ unsigned mq_span_bits(const int32_t* pg, Val val, int n_sc, int P,
                                                 int NC, int NG) {
    unsigned bits = 0;
    for (int g = 0; g < NG; ++g) {
        const int ra = pg[O_GROUP_OFF + g], rb = pg[O_GROUP_OFF + g + 1];
        const int a = mq_jidx(ra, NC + 1), b = mq_jidx(rb, NC + 1);
        const int want = (int)((unsigned)rb - (unsigned)ra);  // int32
        const bool all = b >= a && want == b - a;
        int n = 0;  // the clauses that hold
        for (int c = min(a, b); c < max(a, b); ++c) {
            if (mq_clause(pg, c, val, n_sc, P))
                ++n;
            else if (all)
                break;
        }
        bits |= (unsigned)(all ? n == b - a : (b < a ? -n : n) == want) << g;
    }
    return bits;
}

// The run words of a regular chunk, held in registers
struct MqWords {
    unsigned sc[5], sg[5], hc, hg, lhg, cu;
};

// The span-level half of every program of a regular chunk at once: the
// word of its evaluated groups' head bits that hold, from the span's
// condition word cb.
__device__ __forceinline__ unsigned mq_group_word(const MqWords& w, unsigned cb) {
    unsigned y = cb;
#pragma unroll
    for (int i = 0; i < 5; ++i) y |= (y >> (1 << i)) & w.sc[i];
    unsigned z = (y & w.hc) | ~w.hc;
#pragma unroll
    for (int i = 0; i < 5; ++i) z &= (z >> (1 << i)) | ~w.sg[i];
    return z & w.hg;
}

// program q's union holds for the span where any of bits [q * P, q * P +
// P) of this word is set (its live groups' heads that hold, and cu)
__device__ __forceinline__ unsigned mq_union_word(const MqWords& w, unsigned gw) {
    return (gw & w.lhg) | w.cu;
}

// trace condition j of a program row for trace t of the trace columns
// tcol (n_tc of them)
__device__ __forceinline__ bool mq_tcond(const int32_t* pg, int j, const int32_t* const* tcol,
                                         int n_tc, int t) {
    const int x = n_tc > 0 ? tcol[tt_clamp(pg[O_TCOND_COL + j], 0, n_tc - 1)][t] : 0;
    return cmp_code(pg[O_TCOND_OP + j], x, pg[O_TCOND_V0 + j], pg[O_TCOND_V1 + j]);
}

// The trace-level half, shared by B5a and M3: the trace clauses over the
// group hits gany (bit g) and the trace conditions, cond(j) for condition
// j; clauses at index >= n_tclauses count as true.
template <class Cond>
__device__ __forceinline__ bool mq_trace_ok(const int32_t* pg, unsigned gany, Cond cond, int NG,
                                            int PT, int NA, int TC) {
    bool tm = true;
    for (int c = 0; c < TC && tm; ++c) {
        bool cl = c >= pg[O_N_TCLAUSES];
        const int a0 = mq_jidx(pg[O_TCLAUSE_OFF + c], NA + 1);
        const int a1 = mq_jidx(pg[O_TCLAUSE_OFF + c + 1], NA + 1);
        for (int a = a0; a < a1 && !cl; ++a) {
            const int kind = pg[O_ATOM_KIND + a], idx = pg[O_ATOM_IDX + a];
            const bool v = kind == 0 ? (gany >> tt_clamp(idx, 0, NG - 1)) & 1u
                                     : cond(tt_clamp(idx, 0, PT - 1));
            cl = v && kind >= 0;
        }
        tm = cl;
    }
    return tm;
}

// B5a's dynamic shared memory for a chunk of qc programs: the compiled
// chunk and its program rows, the warps' span stages, a tile's staged
// outputs and offsets
__host__ __device__ __forceinline__ size_t mq_smem(int qc, int n_sc) {
    const int n_stage = n_sc > 0 ? n_sc : 1;
    return sizeof(MqProg) + (size_t)qc * MQ_W * 4 + (size_t)MQ_WARPS * n_stage * 32 * 4 +
           (size_t)qc * (MQ_TT + 1) * 5 + (MQ_TT + 1) * 4;
}

__global__ void __launch_bounds__(MQ_WARPS * 32, 4)
mq_eval_kernel(const int32_t* __restrict__ progs, int q_b, int qc, int P, int NC, int NG, int PT,
               int NA, int TC, const long long* __restrict__ span_cols, int n_sc,
               const long long* __restrict__ trace_cols, int n_tc,
               const int32_t* __restrict__ span_off, int n_spans, int n_spans_b, int n_traces,
               int n_traces_b, uint8_t* __restrict__ tm_out, int32_t* __restrict__ cnt_out) {
    extern __shared__ __align__(16) unsigned char mq_dyn[];
    __shared__ const int32_t* scol[MQ_SC];
    __shared__ const int32_t* tcol[MQ_TCOLS];
    __shared__ int32_t zero;
    const int q0 = blockIdx.y * qc, nq = min(qc, q_b - q0);
    const int n_stage = n_sc > 0 ? n_sc : 1;
    MqProg* pr = (MqProg*)mq_dyn;
    int32_t* pg = (int32_t*)(pr + 1);
    int32_t* stage = pg + nq * MQ_W;
    int32_t* cnt_s = stage + MQ_WARPS * n_stage * 32;
    int32_t* off_s = cnt_s + nq * (MQ_TT + 1);
    uint8_t* tm_s = (uint8_t*)(off_s + MQ_TT + 1);
    for (int i = threadIdx.x; i < nq * MQ_W; i += blockDim.x)  // every word in flight at once
        tt_copy4(pg + i, progs + (long long)q0 * MQ_W + i);
    tt_copy_wait();
    for (int i = threadIdx.x; i < n_sc; i += blockDim.x) scol[i] = (const int32_t*)span_cols[i];
    for (int i = threadIdx.x; i < n_tc; i += blockDim.x) tcol[i] = (const int32_t*)trace_cols[i];
    if (threadIdx.x == 0) zero = 0;
    __syncthreads();
    mq_compile(pg, nq, P, NC, NG, n_sc, pr);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t* my = stage + warp * n_stage * 32 + lane;  // this lane's value of column j: my[32 j]
    const int32_t* vals = n_sc > 0 ? my : &zero;
    const long long vs = n_sc > 0 ? 32 : 0;
    const bool regular = pr->regular;
    const unsigned pm = mq_range_bits(0, P);  // a program's bits, from bit 0
    MqWords w;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        w.sc[i] = pr->sc[i];
        w.sg[i] = pr->sg[i];
    }
    w.hc = pr->hc;
    w.hg = pr->hg;
    w.lhg = pr->lhg;
    w.cu = pr->cu;
    const int n_tiles = (n_traces_b + MQ_TT - 1) / MQ_TT;
    for (int x = blockIdx.x; x < n_tiles; x += gridDim.x) {
        const int t0 = x * MQ_TT, nt = min(MQ_TT, n_traces_b - t0);
        for (int i = threadIdx.x; i <= nt; i += blockDim.x) off_s[i] = span_off[t0 + i];
        __syncthreads();
        for (int i = warp; i < nt; i += MQ_WARPS) {  // whole warps take each trace
            const int t = t0 + i;
            unsigned gq = 0;  // lane q: the groups that hold for program q
            int cq = 0;  // lane q: the union count of program q
            if (t < n_traces) {
                // the trace's spans as the reference gathers its offsets;
                // where they run backwards every count is negated
                const int lo = min(mq_jidx(off_s[i], n_spans_b + 1), n_spans);
                const int hi = min(mq_jidx(off_s[i + 1], n_spans_b + 1), n_spans);
                const int a = min(lo, hi), b = max(lo, hi);
                unsigned heads = 0;  // regular: this lane's spans' group words, OR-ed
                for (int base = a; base < b; base += 32) {
                    const int s = base + lane;
                    const bool in = s < b;
                    if (in) {  // the span's column words, all in flight at once
                        for (int j = 0; j < n_sc; ++j) tt_copy4(my + 32 * j, scol[j] + s);
                        tt_copy_wait();
                    }
                    const unsigned cb = in && regular ? mq_cond_bits(*pr, vals, vs) : 0u;
                    if (regular) {
                        const unsigned gw = in ? mq_group_word(w, cb) : 0u;
                        const unsigned u = in ? mq_union_word(w, gw) : 0u;
                        heads |= gw;
                        for (int q4 = 0; q4 < nq; q4 += 4) {  // four programs' counts a sum
                            unsigned packed = 0;
#pragma unroll
                            for (int c = 0; c < 4; ++c)
                                if (q4 + c < nq)
                                    packed |= (unsigned)(((u >> ((q4 + c) * P)) & pm) != 0) << (8 * c);
                            const unsigned sum = __reduce_add_sync(0xFFFFFFFFu, packed);
                            if ((unsigned)(lane - q4) < 4u) cq += (sum >> (8 * (lane - q4))) & 0xFFu;
                        }
                        continue;
                    }
                    for (int q4 = 0; q4 < nq; q4 += 4) {  // four programs a vote
                        unsigned wb = 0, uw = 0;  // their group bits, a byte each; unions
                        if (in) {
#pragma unroll
                            for (int c = 0; c < 4; ++c) {
                                const int32_t* r = pg + (q4 + c) * MQ_W;
                                if (q4 + c < nq) {
                                    const unsigned g = mq_span_bits(
                                        r, [&](int j) { return vals[j * vs]; }, n_sc, P, NC, NG);
                                    wb |= g << (8 * c);
                                    uw |= (unsigned)(r[O_N_GROUPS] > 0 ? (g & mq_live(r)) != 0
                                                                       : true) << c;
                                }
                            }
                        }
                        const unsigned r = __reduce_or_sync(0xFFFFFFFFu, wb);
#pragma unroll
                        for (int c = 0; c < 4; ++c) {
                            const int n = __popc(__ballot_sync(0xFFFFFFFFu, (uw >> c) & 1u));
                            if (lane == q4 + c) {
                                gq |= (r >> (8 * c)) & 0xFFu;
                                cq += n;
                            }
                        }
                    }
                }
                if (regular) {
                    const unsigned r = __reduce_or_sync(0xFFFFFFFFu, heads);
                    if (lane < nq)
                        for (int g = 0; g < NG; ++g) {
                            const int d = pr->gdesc[lane * MQ_NG + g];
                            const bool held = d < 32 ? (r >> d) & 1u : d == MQ_ALWAYS && hi > lo;
                            gq |= (unsigned)held << g;
                        }
                }
                if (hi < lo) {  // every group's count below zero: none holds
                    gq = 0;
                    cq = -cq;
                }
            }
            if (lane < nq) {
                const int32_t* r = pg + lane * MQ_W;
                const bool tm =
                    t < n_traces &&
                    mq_trace_ok(r, gq, [&](int j) { return mq_tcond(r, j, tcol, n_tc, t); }, NG,
                                PT, NA, TC);
                tm_s[lane * (MQ_TT + 1) + i] = tm;
                cnt_s[lane * (MQ_TT + 1) + i] = tm ? cq : 0;
            }
        }
        __syncthreads();
        for (int e = threadIdx.x; e < nq * nt; e += blockDim.x) {  // each program's row, coalesced
            const int q = e / nt, i = e - q * nt;
            const long long o = (long long)(q0 + q) * n_traces_b + t0 + i;
            tm_out[o] = tm_s[q * (MQ_TT + 1) + i];
            cnt_out[o] = cnt_s[q * (MQ_TT + 1) + i];
        }
        __syncthreads();  // the next tile reuses off_s and the staged outputs
    }
}

// A kernel's grid, shared by B5a, M2 and M3: CTAs a query chunk, at most
// the CTAs resident at once over the chunks (the occupancy of one chunk's
// shared memory, cached per kernel, device and size), at least one, at
// most a tile each
struct MqOcc {
    std::mutex mu;
    int dev = -1;
    size_t smem = 0;
    int ctas = 0;
};

template <class F>
static int mq_grid_x(F kernel, MqOcc& oc, size_t smem_max, int threads, int n_tiles,
                     int n_chunks, size_t smem, int* err) {
    int dev, ctas = 1;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
        std::lock_guard<std::mutex> lock(oc.mu);
        if (dev == oc.dev && smem == oc.smem) {
            ctas = oc.ctas;
        } else {
            int sms = 0, per = 0;
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (e == cudaSuccess && smem_max > 0)
                e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_max);
            if (e == cudaSuccess)
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, smem);
            ctas = sms * (per > 0 ? per : 1);
            if (e == cudaSuccess) {
                oc.dev = dev;
                oc.smem = smem;
                oc.ctas = ctas;
            }
        }
    }
    *err = (int)e;
    const int gx = ctas / n_chunks;
    return gx < 1 ? 1 : (gx > n_tiles ? n_tiles : gx);
}

// progs: (q_b, MQ_W) int32; span_cols / trace_cols: device arrays of
// column pointers (n_spans_b / n_traces_b int32 each); tm, counts: (q_b, n_traces_b)
TT_EXPORT int tt_multiquery(const int32_t* progs, int q_b, int P, int NC, int NG, int PT, int NA,
                            int TC, const long long* span_cols, int n_sc,
                            const long long* trace_cols, int n_tc, const int32_t* span_off,
                            int n_spans, int n_spans_b, int n_traces, int n_traces_b,
                            uint8_t* tm, int32_t* counts, void* stream) {
    if (P < 1 || P > MQ_P || NC < 1 || NC > MQ_NC || NG < 1 || NG > MQ_NG || PT < 1 ||
        PT > MQ_PT || NA < 1 || NA > MQ_NA || TC < 1 || TC > MQ_TC || n_sc < 0 || n_sc > MQ_SC ||
        n_tc < 0 || n_tc > MQ_TCOLS || q_b < 1 || q_b > 65535 || n_traces_b < 1 ||
        n_spans_b < n_spans)
        return (int)cudaErrorInvalidValue;
    const int qc = q_b < MQ_QC / P ? q_b : MQ_QC / P;  // the chunk's conditions fill one word
    const int n_chunks = (q_b + qc - 1) / qc;
    const size_t smem = mq_smem(qc, n_sc);
    int err;
    static MqOcc occ;
    const int gx = mq_grid_x(mq_eval_kernel, occ, MQ_SMEM_MAX, MQ_WARPS * 32,
                             (n_traces_b + MQ_TT - 1) / MQ_TT, n_chunks, smem, &err);
    if (err) return err;
    mq_eval_kernel<<<dim3(gx, n_chunks), MQ_WARPS * 32, smem, (cudaStream_t)stream>>>(
        progs, q_b, qc, P, NC, NG, PT, NA, TC, span_cols, n_sc, trace_cols, n_tc, span_off,
        n_spans, n_spans_b, n_traces, n_traces_b, tm, counts);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

// B5b, the full sort: tm, counts (rows, n); key (n,) shared; comp: rows
// * n_pad scratch; out (rows, 3k+1)
TT_EXPORT int tt_mq_select(const uint8_t* tm, const int32_t* key, const int32_t* counts, int n,
                           int rows, int k, u64* comp, int n_pad, int32_t* out, void* stream) {
    return tt_select_rows(tm, key, counts, n, rows, k, comp, n_pad, out, (cudaStream_t)stream, 1);
}

// B5b, the two passes: K2's plan for (n, k); cand: rows * tiles * k_pad
// words; tcount: rows * tiles words; out (rows, 3k+1)
TT_EXPORT int tt_mq_select_tiled(const uint8_t* tm, const int32_t* key, const int32_t* counts,
                                 int n, int rows, int k, int lg_k, int tile, int tiles, int buf,
                                 u64* cand, int32_t* tcount, int32_t* out, void* stream) {
    return tt_select_tiled_rows(tm, key, counts, n, rows, k, lg_k, tile, tiles, buf, cand, tcount,
                                out, (cudaStream_t)stream, 1);
}

// M2 (mq_partial, slot 2): the span-level half of B5a on this rank's
// row slice [row0, row0 + Sl) of a row-sharded block
// (parallel/multiquery.py). Replaces the per-shard fold of
// tempo_tpu/parallel/multiquery.py:57-100 (`fold_rows` + `seg_partial`):
// per (query, trace) the PARTIAL counts of the trace's spans inside the
// slice for which each group holds (rows 0 .. NG - 1) and for which the
// union of live groups holds (row NG; every valid span when the program
// has no group), out (q_b, NG + 1, n_traces_b) int32. A trace's range is
// the reference's clip of its global offsets to the slice,
// clip(span_off[t] - row0, 0, Sl) .. clip(span_off[t + 1] - row0, 0, Sl)
// (no index wrap; the int32 difference wraps, as the reference's does),
// its counts negated where that runs backwards, and a span counts only
// where row0 + s < n_spans. The caller's all_reduce SUM stitches the
// partials exactly.
//
// Design: B5a's compiled chunk over the slice. A grid sized to the card
// walks tiles of MQ2_TT traces, gridDim.y the chunks of 32 / P programs;
// each CTA copies the span half of its chunk's rows (mq_span_word, 5 P +
// NC + NG + 3 words a program) and compiles it once (mq_compile), its
// first tile's span offsets in flight meanwhile (then always a tile
// ahead). A tile's threads clip its ranges and vote: a tile with nothing
// to count in the slice (on a rank of an n-rank mesh, all but about 1 / n
// of the tiles) writes its zeros as 16-byte stores and walks nothing.
// Elsewhere a warp walks one trace, 32 spans a step, each lane's column
// words staged by cp.async as in B5a. In a regular chunk a span gives one
// condition word, the group word gw and the union word u, and the warp
// sums columns: lane l counts the spans whose gw has bit l set (mq_colsum:
// 8 __reduce_add_sync a word), and the valid spans; at the trace's end
// each of the chunk's K = nq (NG + 1) counters takes one column by a
// shuffle (csrc: a group's head bit, every valid span, or none; a
// program's union the one live head it has, and only where it has two or
// more a column of its own, lane l then also counting the spans for which
// program l's union holds). Other chunks run each program's row
// (mq_span_bits) and count by ballots, lane k % 32 owning counter k. A
// tile's K rows go out as 16-byte stores (n_traces_b a multiple of 4:
// kernels.mq_partial refuses other input).
// Bound: bytes -- the slice's named span columns (4 B a span) once,
// span_off, and (NG + 1) x 4 B written per (query, trace).
#define MQ2_TT 16  // traces a tile of M2: 2 a warp

// word j of the span half of a program row: its P conditions' five
// fields, clause offsets c <= NC, group offsets g <= NG, n_groups
// (5 P + NC + NG + 3 words)
__device__ __forceinline__ int mq_span_word(int j, int P, int NC, int NG) {
    if (j < 5 * P) {
        const int f = j / P;
        return f * MQ_P + j - f * P;
    }
    j -= 5 * P;
    if (j <= NC) return O_CLAUSE_OFF + j;
    j -= NC + 1;
    return j <= NG ? O_GROUP_OFF + j : O_N_GROUPS;
}

// M2's dynamic shared memory for a chunk of qc programs: the compiled
// chunk and its rows, the warps' span stages, a tile's ranges, the
// counters' column sums and a tile's counts
__host__ __device__ __forceinline__ size_t mq2_smem(int qc, int NG, int n_sc) {
    const int n_stage = n_sc > 0 ? n_sc : 1, k = qc * (NG + 1);
    return sizeof(MqProg) + (size_t)qc * MQ_W * 4 + (size_t)MQ_WARPS * n_stage * 32 * 4 +
           MQ2_TT * 16 + (size_t)k * 4 + (size_t)k * (MQ2_TT + 1) * 4;
}
#define MQ2_VALID 64  // a counter's column: every valid span
#define MQ2_NONE 65  // none
#define MQ2_SMEM_MAX mq2_smem(MQ_QC, MQ_NG, MQ_SC)

// lane l of a warp: the lanes whose word x has bit l set, four bits to one
// __reduce_add_sync (bits 4 j .. 4 j + 3 spread to the four bytes by one
// multiply: no two partial products meet; a byte counts at most 32)
__device__ __forceinline__ unsigned mq_colsum(unsigned x, int lane) {
    unsigned mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const unsigned s =
            __reduce_add_sync(0xFFFFFFFFu, (((x >> (4 * j)) & 0xFu) * 0x204081u) & 0x01010101u);
        if ((lane >> 2) == j) mine = (s >> (8 * (lane & 3))) & 0xFFu;
    }
    return mine;
}

__global__ void __launch_bounds__(MQ_WARPS * 32)
mq_partial_kernel(const int32_t* __restrict__ progs, int q_b, int qc, int P, int NC, int NG,
                  const int32_t* __restrict__ span_mat, int n_sc, int Sl, int row0,
                  const int32_t* __restrict__ span_off, int n_spans, int n_traces_b,
                  int32_t* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char mq_dyn[];
    __shared__ const int32_t* scol[MQ_SC];
    __shared__ int32_t zero;
    const int q0 = blockIdx.y * qc, nq = min(qc, q_b - q0);
    const int n_stage = n_sc > 0 ? n_sc : 1;
    const int K = nq * (NG + 1);
    MqProg* pr = (MqProg*)mq_dyn;
    int32_t* pg = (int32_t*)(pr + 1);
    int32_t* stage = pg + nq * MQ_W;
    int4* rng_s = (int4*)(stage + MQ_WARPS * n_stage * 32);  // trace i: walk [x, y), z backwards
    int32_t* csrc = (int32_t*)(rng_s + MQ2_TT);  // counter k's column sum (below)
    int32_t* cnt_s = csrc + K;  // counter k of trace i: [k * (MQ2_TT + 1) + i]
    // thread i < MQ2_TT: trace i's offsets of the CTA's next tile, read a
    // tile ahead (the first while the chunk compiles)
    const int n_tiles = (n_traces_b + MQ2_TT - 1) / MQ2_TT;
    int o0 = 0, o1 = 0;
    auto next_offsets = [&](int x) {
        const int t = x * MQ2_TT + threadIdx.x;
        if (x < n_tiles && threadIdx.x < MQ2_TT && t < n_traces_b) {
            o0 = span_off[t];
            o1 = span_off[t + 1];
        }
    };
    next_offsets(blockIdx.x);
    const int nw = 5 * P + NC + NG + 3;  // only the words the span half reads
    for (int i = threadIdx.x; i < nq * nw; i += blockDim.x) {
        const int q = i / nw, o = q * MQ_W + mq_span_word(i - q * nw, P, NC, NG);
        tt_copy4(pg + o, progs + (long long)q0 * MQ_W + o);
    }
    tt_copy_wait();
    for (int i = threadIdx.x; i < n_sc; i += blockDim.x) scol[i] = span_mat + (long long)i * Sl;
    if (threadIdx.x == 0) zero = 0;
    __syncthreads();
    mq_compile(pg, nq, P, NC, NG, n_sc, pr);
    const bool regular = pr->regular;  // the chunk runs as word operations
    // in a regular chunk, counter k = q (NG + 1) + g reads one column sum:
    // bit d of the group word (group g's head), MQ2_VALID every valid span
    // (a group with no clause), MQ2_NONE none. Program q's union is the
    // valid spans where it always holds (cu), its one live head's column
    // where it has one, none where it has none, else 32 + q: the union
    // column, summed only where some program needs it
    bool union_col = false;
    for (int k = threadIdx.x; k < K && regular; k += blockDim.x) {
        const int q = k / (NG + 1), g = k - q * (NG + 1);
        int src;
        if (g < NG) {
            const int e = pr->gdesc[q * MQ_NG + g];
            src = e < 32 ? e : e == MQ_ALWAYS ? MQ2_VALID : MQ2_NONE;
        } else {
            const unsigned heads = pr->lhg & mq_range_bits(q * P, q * P + P);
            src = (pr->cu >> (q * P)) & 1u ? MQ2_VALID
                  : heads == 0u             ? MQ2_NONE
                  : (heads & (heads - 1u)) == 0u ? __ffs(heads) - 1
                                            : 32 + q;
            union_col = union_col || src == 32 + q;
        }
        csrc[k] = src;
    }
    union_col = __syncthreads_or(union_col);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int32_t* my = stage + warp * n_stage * 32 + lane;  // this lane's value of column j: my[32 j]
    const int32_t* vals = n_sc > 0 ? my : &zero;
    const long long vs = n_sc > 0 ? 32 : 0;
    const unsigned pm = mq_range_bits(0, P);  // a program's bits, from bit 0
    MqWords w;
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        w.sc[i] = pr->sc[i];
        w.sg[i] = pr->sg[i];
    }
    w.hc = pr->hc;
    w.hg = pr->hg;
    w.lhg = pr->lhg;
    w.cu = pr->cu;
    const int vend = tt_clamp(n_spans - row0, 0, Sl);  // spans past n_spans count nowhere
    const long long r0 = (long long)q0 * (NG + 1);  // the chunk's first output row
    for (int x = blockIdx.x; x < n_tiles; x += gridDim.x) {
        const int t0 = x * MQ2_TT, nt = min(MQ2_TT, n_traces_b - t0);
        bool walk = false;
        if (threadIdx.x < nt) {  // the reference's clip of its int32 difference, which wraps
            const int lo = tt_clamp((int)((unsigned)o0 - (unsigned)row0), 0, Sl);
            const int hi = tt_clamp((int)((unsigned)o1 - (unsigned)row0), 0, Sl);
            const int a = min(lo, hi), e = max(a, min(max(lo, hi), vend));
            rng_s[threadIdx.x] = make_int4(a, e, hi < lo, 0);
            walk = e > a;
        }
        next_offsets(x + gridDim.x);
        const bool any = __syncthreads_or(walk);  // else the tile's rows are zeros
        for (int i = warp; any && i < nt; i += MQ_WARPS) {  // whole warps take each trace
            const int4 rg = rng_s[i];
            int32_t* ci = cnt_s + i;  // counter k at ci[k * (MQ2_TT + 1)]
            // regular: lane l's column sums over the trace -- spans whose
            // group word has bit l set, whose program l's union holds -- and
            // the valid spans; else lane k % 32 owns counter k in ci
            unsigned gsum = 0, usum = 0, vsum = 0;
            for (int k = lane; k < K && !regular; k += 32) ci[k * (MQ2_TT + 1)] = 0;
            for (int base = rg.x; base < rg.y; base += 32) {
                const int s = base + lane;
                const bool in = s < rg.y;
                if (in) {  // the span's column words, all in flight at once
                    for (int j = 0; j < n_sc; ++j) tt_copy4(my + 32 * j, scol[j] + s);
                    tt_copy_wait();
                }
                if (regular) {
                    const unsigned gw = in ? mq_group_word(w, mq_cond_bits(*pr, vals, vs)) : 0u;
                    gsum += mq_colsum(gw, lane);
                    vsum += __popc(__ballot_sync(0xFFFFFFFFu, in));
                    if (union_col) {
                        const unsigned u = in ? mq_union_word(w, gw) : 0u;
                        unsigned uq = 0;  // bit q: program q's union holds
                        for (int q = 0; q < nq; ++q)
                            uq |= (unsigned)((u >> (q * P)) & pm ? 1 : 0) << q;
                        usum += mq_colsum(uq, lane);
                    }
                    continue;
                }
                for (int q = 0; q < nq; ++q) {  // each program's row as it stands
                    const int32_t* r = pg + q * MQ_W;
                    unsigned bits = 0;  // its groups, then its union at bit NG
                    if (in) {
                        bits = mq_span_bits(r, [&](int j) { return vals[j * vs]; }, n_sc, P, NC,
                                            NG);
                        bits |= (unsigned)(r[O_N_GROUPS] > 0 ? (bits & mq_live(r)) != 0 : true)
                                << NG;
                    }
                    for (int g = 0; g <= NG; ++g) {
                        const int n = __popc(__ballot_sync(0xFFFFFFFFu, (bits >> g) & 1u));
                        const int k = q * (NG + 1) + g;
                        if (lane == (k & 31)) ci[k * (MQ2_TT + 1)] += n;
                    }
                }
            }
            if (regular) {
                for (int k0 = 0; k0 < K; k0 += 32) {  // whole warps: the shuffles
                    const int k = k0 + lane, src = k < K ? csrc[k] : MQ2_NONE;
                    const unsigned gs = __shfl_sync(0xFFFFFFFFu, gsum, src & 31);
                    const unsigned us = __shfl_sync(0xFFFFFFFFu, usum, src & 31);
                    const int c =
                        (int)(src < 32 ? gs : src < 64 ? us : src == MQ2_VALID ? vsum : 0u);
                    if (k < K) ci[k * (MQ2_TT + 1)] = rg.z ? -c : c;
                }
            } else if (rg.z) {  // backwards: negated, as the reference's signed differences
                for (int k = lane; k < K; k += 32) ci[k * (MQ2_TT + 1)] = -ci[k * (MQ2_TT + 1)];
            }
        }
        if (any) __syncthreads();
        const int n4 = nt >> 2;  // 16 bytes a store: n_traces_b and so nt a multiple of 4
        for (int e = threadIdx.x; e < K * n4; e += blockDim.x) {
            const int k = e / n4, c = (e - k * n4) * 4;
            int4 v = make_int4(0, 0, 0, 0);
            if (any) {
                const int32_t* r = cnt_s + k * (MQ2_TT + 1) + c;
                v = make_int4(r[0], r[1], r[2], r[3]);
            }
            *(int4*)(out + (r0 + k) * n_traces_b + t0 + c) = v;
        }
        __syncthreads();  // the next tile reuses the ranges and the counts
    }
}

// M3 (mq_combine, slot 3): the trace-level half on the summed counts
// (q_b, NG + 1, n_traces_b) of M2 (tempo_tpu/parallel/multiquery.py:102-125
// `combine`): group g holds for trace t when its count is > 0; the trace
// clauses over those hits and the trace columns; tm & valid trace; the
// union count where tm holds, else 0. M2 then M3 equal B5a bit for bit on
// any row split.
//
// Design: a grid sized to the card (at most the CTAs resident at once,
// over the queries on gridDim.y), each CTA copying the trace half of its
// program row (mq_trace_word) once. A thread takes 4 consecutive traces:
// the NG + 1 counts (its first step's in flight while the CTA reads the
// program row) and each trace condition's column as 16-byte loads,
// the conditions into one 64-bit word (bit 4 j + r: condition j for
// trace t + r), mq_trace_ok four times, one 4-byte tm store and one
// 16-byte cnt store (tm and cnt are the two halves of one allocation:
// one download). n_traces_b is a multiple of 4 and every base 16-byte
// aligned (kernels.mq_combine_packed refuses other input).
// Bound: bytes -- (NG + 1) x 4 B of counts and the named trace columns
// read, 5 B written per (query, trace).
#define MQ3_THREADS 256

// the words of a program row the trace half reads: its PT trace
// conditions, NA atoms, trace clause offsets c <= TC, n_tclauses
__device__ __forceinline__ bool mq_trace_word(int j, int PT, int NA, int TC) {
    if (j < O_TCOND_COL) return false;
    if (j < O_ATOM_KIND) return (j - O_TCOND_COL) % MQ_PT < PT;
    if (j < O_TCLAUSE_OFF) return (j - O_ATOM_KIND) % MQ_NA < NA;
    if (j < O_N_GROUPS) return j - O_TCLAUSE_OFF <= TC;
    return j == O_N_TCLAUSES;
}

// traces t .. t + 3 of a row, 16 bytes at once
__device__ __forceinline__ int4 mq_load4(const int32_t* p) { return __ldg((const int4*)p); }

__device__ __forceinline__ int mq_lane4(int4 v, int r) {
    return r == 0 ? v.x : r == 1 ? v.y : r == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(MQ3_THREADS)
mq_combine_kernel(const int32_t* __restrict__ progs, int NG, int PT, int NA, int TC,
                  const int32_t* __restrict__ counts, const int32_t* __restrict__ trace_mat,
                  int n_tc, int n_traces, int n_traces_b, uint8_t* __restrict__ tm_out,
                  int32_t* __restrict__ cnt_out) {
    __shared__ int32_t pg[MQ_W];
    const int q = blockIdx.y;
    const long long nb = n_traces_b;
    const int32_t* cq = counts + (long long)q * (NG + 1) * nb;
    const int n4 = n_traces_b >> 2, step = gridDim.x * blockDim.x;
    // the group bits (bit 8 r + g: group g's count for trace t + r is above
    // zero) and union counts of a step, the first step's read before the
    // program row arrives
    auto counts4 = [&](int x, unsigned& gp, int4& un) {
        const int t = 4 * x;
        gp = 0;
        for (int g = 0; g < NG; ++g) {
            const int4 v = mq_load4(cq + g * nb + t);
            gp |= (unsigned)(v.x > 0) << g | (unsigned)(v.y > 0) << (8 + g) |
                  (unsigned)(v.z > 0) << (16 + g) | (unsigned)(v.w > 0) << (24 + g);
        }
        un = mq_load4(cq + NG * nb + t);
    };
    const int x0 = blockIdx.x * blockDim.x + threadIdx.x;
    unsigned gp = 0;
    int4 un = make_int4(0, 0, 0, 0);
    if (x0 < n4) counts4(x0, gp, un);
    for (int i = threadIdx.x; i < MQ_W; i += blockDim.x)
        if (mq_trace_word(i, PT, NA, TC)) pg[i] = progs[(long long)q * MQ_W + i];
    __syncthreads();
    for (int x = x0; x < n4; x += step) {
        const int t = 4 * x;
        if (x != x0) counts4(x, gp, un);
        unsigned long long tb = 0;  // bit 4 j + r: trace condition j holds for trace t + r
        for (int j = 0; j < PT; ++j) {
            const int op = pg[O_TCOND_OP + j];
            if ((unsigned)op > 7u) continue;  // no such compare: never holds
            const int4 v =
                n_tc > 0 ? mq_load4(trace_mat + tt_clamp(pg[O_TCOND_COL + j], 0, n_tc - 1) * nb + t)
                         : make_int4(0, 0, 0, 0);
            const int v0 = pg[O_TCOND_V0 + j], v1 = pg[O_TCOND_V1 + j];
            const unsigned b = (unsigned)cmp_code(op, v.x, v0, v1) |
                               (unsigned)cmp_code(op, v.y, v0, v1) << 1 |
                               (unsigned)cmp_code(op, v.z, v0, v1) << 2 |
                               (unsigned)cmp_code(op, v.w, v0, v1) << 3;
            tb |= (unsigned long long)b << (4 * j);
        }
        unsigned tm4 = 0;
        int4 c4;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const bool ok = t + r < n_traces &&
                            mq_trace_ok(pg, (gp >> (8 * r)) & 0xFFu,
                                        [&](int j) { return ((tb >> (4 * j + r)) & 1ull) != 0; },
                                        NG, PT, NA, TC);
            tm4 |= (unsigned)ok << (8 * r);
            const int c = ok ? mq_lane4(un, r) : 0;
            if (r == 0) c4.x = c;
            if (r == 1) c4.y = c;
            if (r == 2) c4.z = c;
            if (r == 3) c4.w = c;
        }
        const long long o = (long long)q * nb + t;
        *(unsigned*)(tm_out + o) = tm4;
        *(int4*)(cnt_out + o) = c4;
    }
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
        row0 < 0 || n_traces_b < 1 || n_traces_b % 4)
        return (int)cudaErrorInvalidValue;
    const int qc = q_b < MQ_QC / P ? q_b : MQ_QC / P;  // the chunk's conditions fill one word
    const int n_chunks = (q_b + qc - 1) / qc;
    const size_t smem = mq2_smem(qc, NG, n_sc);
    static MqOcc occ;
    int err;
    int gx = mq_grid_x(mq_partial_kernel, occ, MQ2_SMEM_MAX, MQ_WARPS * 32,
                             (n_traces_b + MQ2_TT - 1) / MQ2_TT, n_chunks, smem, &err);
    if (err) return err;
    mq_partial_kernel<<<dim3(gx, n_chunks), MQ_WARPS * 32, smem, (cudaStream_t)stream>>>(
        progs, q_b, qc, P, NC, NG, span_mat, n_sc, Sl, row0, span_off, n_spans, n_traces_b, out);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}

// counts (q_b, NG + 1, n_traces_b) summed; trace_mat (n_tc, n_traces_b);
// tm, cnt (q_b, n_traces_b)
TT_EXPORT int tt_mq_combine(const int32_t* progs, int q_b, int NG, int PT, int NA, int TC,
                            const int32_t* counts, const int32_t* trace_mat, int n_tc,
                            int n_traces, int n_traces_b, uint8_t* tm, int32_t* cnt,
                            void* stream) {
    if (mq_dims_bad(1, 1, NG, PT, NA, TC, q_b) || n_tc < 0 || n_tc > MQ_TCOLS || n_traces_b < 1 ||
        n_traces_b % 4)
        return (int)cudaErrorInvalidValue;
    const int n4 = n_traces_b / 4;
    static MqOcc occ;
    int err;
    const int gx = mq_grid_x(mq_combine_kernel, occ, 0, MQ3_THREADS,
                             (n4 + MQ3_THREADS - 1) / MQ3_THREADS, q_b, 0, &err);
    if (err) return err;
    mq_combine_kernel<<<dim3(gx, q_b), MQ3_THREADS, 0, (cudaStream_t)stream>>>(
        progs, NG, PT, NA, TC, counts, trace_mat, n_tc, n_traces, n_traces_b, tm, cnt);
    TT_LAUNCHED_SLOT(3);
    return (int)cudaGetLastError();
}
