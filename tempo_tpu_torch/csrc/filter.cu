// K1: the TraceQL filter program.
//
// Replaces tempo_tpu/ops/filter.py:286 `_compiled(...).run`, the jitted
// predicate program launched by `eval_block` (:476). The host
// (tempo_tpu_torch/ops/filter.py) compiles the trace-level condition
// tree into short postfix programs over a table of condition
// descriptors; operand values, column pointers and dictionary tables
// travel as data, so one compiled program serves every operand value,
// as the jit cache does in the reference.
//
// Launches, in order:
//   res pass    one thread per (rattr condition, resource): any matching
//               attr row in [rattr.off[r], rattr.off[r+1]) -> res mask
//   span pass   one thread per span row: every span-level leaf (span and
//               span@res columns compare directly, sattr conditions loop
//               over the span's own attr rows, rattr conditions gather
//               the res mask through the clamped span.res_idx) and the
//               AND/OR between them -> one span mask slot
//   struct      `>` one parent gather; `>>` pointer doubling, one launch
//               per pass; `~` per-parent counts by atomicAdd, then a
//               gather (orphan rule of filter.py:339-346 kept as is)
//
// On a mesh shard (tempo_tpu_torch/parallel/search.py) the span pass and
// the struct kernels run once a block on the shard's rows: generic-attr
// and resource leaves arrive as mask slots (meshsearch.cu, M5), and the
// struct kernels read the lhs mask (and, for `>>` and `~`, the parent
// table) gathered over the sp axis, writing the shard's rows from row0.
// The trace pass is meshsearch.cu's M7 and M8, split at a collective.
//   trace pass  one thread per trace over [span_off[t], span_off[t+1]):
//               the trace program (a tracify leaf asks whether any span
//               of the trace is set in its slot), then the union count
//               -> trace_mask and matched-span counts
//   epilogue    span_out only: span_mask = union & trace_mask[tsid] &
//               valid, then its per-trace counts
//
// Bound: bytes. Each launch streams its columns once (4 B a span per
// column, 12 B an attr row); the struct passes re-read one mask and the
// parent column per pass. No fast-math: f32 compares keep IEEE
// semantics, subnormals included. The leaf semantics (compare, attr
// rows, res mask) live in cond.cuh, shared with B6 (timeseries.cu).
#include "cond.cuh"

// postfix program of (code, arg) pairs over a bit stack
__global__ void span_pass_kernel(const int32_t* __restrict__ prog, int len,
                                 const long long* __restrict__ desc,
                                 const uint8_t* __restrict__ slots, uint8_t* __restrict__ out,
                                 int n_spans_b, int n_spans, const uint8_t* __restrict__ resmask,
                                 int n_res_b, const int32_t* __restrict__ res_idx) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_spans_b) return;
    bool valid = s < n_spans;
    unsigned long long st = 0;
    for (int p = 0; p < len; p += 2) {
        int code = prog[p], arg = prog[p + 1];
        bool v;
        if (code == C_AND || code == C_OR) {
            bool b = st & 1, a = (st >> 1) & 1;
            st >>= 2;
            v = code == C_AND ? (a && b) : (a || b);
        } else if (code == C_COND) {
            v = span_leaf(desc + (long long)arg * DW, s, valid, resmask, n_res_b, res_idx);
        } else if (code == C_MASK) {
            v = slots[(long long)arg * n_spans_b + s] != 0;
        } else {
            v = code == C_TRUE && valid;
        }
        st = (st << 1) | (unsigned long long)v;
    }
    out[s] = st & 1;
}

// rm, pidx and out hold the n_out rows from global row row0; lm all nb
// (one block: row0 0 and n_out nb; a shard: lm gathered over the mesh)
__global__ void struct_child_kernel(const uint8_t* __restrict__ lm, const uint8_t* __restrict__ rm,
                                    const int32_t* __restrict__ pidx, uint8_t* __restrict__ out,
                                    int nb, int n_spans, int row0, int n_out) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_out) return;
    int p = pidx[s];
    bool has_p = p >= 0 && row0 + s < n_spans;
    out[s] = rm[s] && has_p && lm[tt_clamp(p, 0, nb - 1)];
}

__global__ void desc_init_kernel(const uint8_t* __restrict__ lm, const int32_t* __restrict__ pidx,
                                 uint8_t* __restrict__ acc, int32_t* __restrict__ ptr,
                                 int nb, int n_spans) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nb) return;
    int p = pidx[s];
    bool has_p = p >= 0 && s < n_spans;
    int safe = tt_clamp(p, 0, nb - 1);
    acc[s] = has_p && lm[safe];
    ptr[s] = has_p ? safe : -1;
}

// one pointer-doubling pass: reads (acc, ptr), writes (acc2, ptr2)
__global__ void desc_step_kernel(const uint8_t* __restrict__ acc, const int32_t* __restrict__ ptr,
                                 uint8_t* __restrict__ acc2, int32_t* __restrict__ ptr2, int nb) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nb) return;
    int p = ptr[s];
    bool alive = p >= 0;
    int ps = tt_clamp(p, 0, nb - 1);
    acc2[s] = acc[s] || (alive && acc[ps]);
    int pp = ptr[ps];
    ptr2[s] = alive ? (pp >= 0 ? pp : -1) : -1;
}

__global__ void desc_final_kernel(const uint8_t* __restrict__ rm, const uint8_t* __restrict__ acc,
                                  uint8_t* __restrict__ out, int row0, int n_out) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_out) return;
    out[s] = rm[s] && acc[row0 + s];
}

__global__ void sib_count_kernel(const uint8_t* __restrict__ lm, const int32_t* __restrict__ pidx,
                                 int32_t* __restrict__ cnt, int32_t* __restrict__ orphan_flag,
                                 int nb, int n_spans) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nb) return;
    if (!lm[s] || s >= n_spans) return;
    int p = pidx[s];
    if (p >= 0) atomicAdd(&cnt[tt_clamp(p, 0, nb - 1)], 1);
    if (p == -2) *orphan_flag = 1;
}

__global__ void sib_final_kernel(const uint8_t* __restrict__ lm, const uint8_t* __restrict__ rm,
                                 const int32_t* __restrict__ pidx, const int32_t* __restrict__ cnt,
                                 const int32_t* __restrict__ orphan_flag, uint8_t* __restrict__ out,
                                 int nb, int n_spans, int row0, int n_out) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_out) return;
    int g = row0 + s;
    int p = pidx[g];
    bool valid = g < n_spans;
    bool has_p = p >= 0 && valid;
    bool l = lm[g] != 0, r = rm[s] != 0;
    int sibs = cnt[tt_clamp(p, 0, nb - 1)] - (int)(l && has_p);
    bool orphan = p == -2 && valid;
    out[s] = (r && has_p && sibs > 0) || (r && orphan && *orphan_flag);
}

// any span of [lo, hi) set in one mask slot
__device__ __forceinline__ bool seg_any(const uint8_t* slot, int lo, int hi) {
    for (int s = lo; s < hi; ++s)
        if (slot[s]) return true;
    return false;
}

__global__ void trace_pass_kernel(const int32_t* __restrict__ prog, int len,
                                  const long long* __restrict__ desc,
                                  const uint8_t* __restrict__ slots, const int32_t* __restrict__ tslots,
                                  int n_tr, int n_spans_b, int n_spans,
                                  const int32_t* __restrict__ span_off, int n_traces, int n_traces_b,
                                  uint8_t* __restrict__ trace_mask, int32_t* __restrict__ counts) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_traces_b) return;
    int lo = span_off[t], hi = min(span_off[t + 1], n_spans);
    unsigned long long st = 0;
    for (int p = 0; p < len; p += 2) {
        int code = prog[p], arg = prog[p + 1];
        bool v;
        if (code == C_AND || code == C_OR) {
            bool b = st & 1, a = (st >> 1) & 1;
            st >>= 2;
            v = code == C_AND ? (a && b) : (a || b);
        } else if (code == C_TRACIFY) {
            v = seg_any(slots + (long long)tslots[arg] * n_spans_b, lo, hi);
        } else if (code == C_COND) {
            const long long* d = desc + (long long)arg * DW;
            v = cmp_at(d, (const void*)d[D_COL], t);
        } else {
            v = code == C_TRUE;
        }
        st = (st << 1) | (unsigned long long)v;
    }
    bool tm = (st & 1) && t < n_traces;
    trace_mask[t] = tm;
    if (!counts) return;
    // matched spans: the union of every tracify mask (all valid spans
    // when the tree has none), zeroed where the trace fails
    int ucount = 0;
    if (tm) {
        for (int s = lo; s < hi; ++s) {
            bool u = n_tr == 0;
            for (int i = 0; i < n_tr && !u; ++i) u = slots[(long long)tslots[i] * n_spans_b + s] != 0;
            ucount += u;
        }
    }
    counts[t] = ucount;
}

__global__ void span_epilogue_kernel(const uint8_t* __restrict__ slots, const int32_t* __restrict__ tslots,
                                     int n_tr, int n_spans_b, int n_spans,
                                     const int32_t* __restrict__ tsid,
                                     const uint8_t* __restrict__ trace_mask, int n_traces_b,
                                     uint8_t* __restrict__ span_mask) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_spans_b) return;
    bool u = n_tr == 0;
    for (int i = 0; i < n_tr; ++i) u = u || slots[(long long)tslots[i] * n_spans_b + s];
    span_mask[s] = u && s < n_spans && trace_mask[tt_clamp(tsid[s], 0, n_traces_b - 1)];
}

__global__ void seg_count_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ span_off,
                                 int n_spans, int n_traces_b, int32_t* __restrict__ counts) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_traces_b) return;
    int c = 0, hi = min(span_off[t + 1], n_spans);
    for (int s = span_off[t]; s < hi; ++s) c += mask[s] != 0;
    counts[t] = c;
}

TT_EXPORT int tt_filter_res_pass(const long long* desc, const int32_t* rconds, int n_rc,
                                 int n_res_b, uint8_t* resmask, void* stream) {
    long long n = (long long)n_rc * n_res_b;
    res_pass_kernel<<<tt_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(
        desc, rconds, n_rc, n_res_b, resmask);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_filter_span_pass(const int32_t* prog, int len, const long long* desc,
                                  const uint8_t* slots, uint8_t* out, int n_spans_b, int n_spans,
                                  const uint8_t* resmask, int n_res_b, const int32_t* res_idx,
                                  void* stream) {
    span_pass_kernel<<<tt_blocks(n_spans_b, 256), 256, 0, (cudaStream_t)stream>>>(
        prog, len, desc, slots, out, n_spans_b, n_spans, resmask, n_res_b, res_idx);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}

// op: 0 '>', 1 '>>', 2 '~'. scratch: 2*nb int32 + 2*nb uint8 (for '>>'),
// nb+1 int32 (for '~'; the last word is the orphan flag). lm is over all
// nb rows, and so is pidx for '>>' and '~'; rm and out (and pidx for
// '>') hold n_out rows from global row row0 -- a mesh shard's rows
// against the masks and parent table gathered over its sp axis
// (tempo_tpu/parallel/search.py:203-256). One block: row0 0, n_out nb.
TT_EXPORT int tt_filter_struct(int op, const uint8_t* lm, const uint8_t* rm, uint8_t* out,
                               const int32_t* pidx, int nb, int n_spans, int n_passes,
                               int32_t* scratch_i32, uint8_t* scratch_u8, int row0, int n_out,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int g = tt_blocks(nb, 256), go = tt_blocks(n_out, 256);
    if (op == 0) {
        struct_child_kernel<<<go, 256, 0, st>>>(lm, rm, pidx, out, nb, n_spans, row0, n_out);
        TT_LAUNCHED();
    } else if (op == 1) {
        uint8_t* acc[2] = {scratch_u8, scratch_u8 + nb};
        int32_t* ptr[2] = {scratch_i32, scratch_i32 + nb};
        desc_init_kernel<<<g, 256, 0, st>>>(lm, pidx, acc[0], ptr[0], nb, n_spans);
        TT_LAUNCHED();
        for (int i = 0; i < n_passes; ++i) {
            desc_step_kernel<<<g, 256, 0, st>>>(acc[i & 1], ptr[i & 1], acc[(i + 1) & 1],
                                                ptr[(i + 1) & 1], nb);
            TT_LAUNCHED();
        }
        desc_final_kernel<<<go, 256, 0, st>>>(rm, acc[n_passes & 1], out, row0, n_out);
        TT_LAUNCHED();
    } else {
        cudaError_t e = cudaMemsetAsync(scratch_i32, 0, (size_t)(nb + 1) * sizeof(int32_t), st);
        if (e != cudaSuccess) return (int)e;
        sib_count_kernel<<<g, 256, 0, st>>>(lm, pidx, scratch_i32, scratch_i32 + nb, nb, n_spans);
        TT_LAUNCHED();
        sib_final_kernel<<<go, 256, 0, st>>>(lm, rm, pidx, scratch_i32, scratch_i32 + nb, out, nb,
                                             n_spans, row0, n_out);
        TT_LAUNCHED();
    }
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_filter_trace_pass(const int32_t* prog, int len, const long long* desc,
                                   const uint8_t* slots, const int32_t* tslots, int n_tr,
                                   int n_spans_b, int n_spans, const int32_t* span_off,
                                   int n_traces, int n_traces_b, uint8_t* trace_mask,
                                   int32_t* counts, void* stream) {
    trace_pass_kernel<<<tt_blocks(n_traces_b, 128), 128, 0, (cudaStream_t)stream>>>(
        prog, len, desc, slots, tslots, n_tr, n_spans_b, n_spans, span_off, n_traces,
        n_traces_b, trace_mask, counts);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_filter_span_epilogue(const uint8_t* slots, const int32_t* tslots, int n_tr,
                                      int n_spans_b, int n_spans, const int32_t* tsid,
                                      const uint8_t* trace_mask, int n_traces_b,
                                      const int32_t* span_off, uint8_t* span_mask,
                                      int32_t* counts, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    span_epilogue_kernel<<<tt_blocks(n_spans_b, 256), 256, 0, st>>>(
        slots, tslots, n_tr, n_spans_b, n_spans, tsid, trace_mask, n_traces_b, span_mask);
    TT_LAUNCHED();
    seg_count_kernel<<<tt_blocks(n_traces_b, 128), 128, 0, st>>>(
        span_mask, span_off, n_spans, n_traces_b, counts);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}
