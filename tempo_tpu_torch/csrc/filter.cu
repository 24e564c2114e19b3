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
// Where the lhs mask crossed the sp axis bit-packed (M6's pack before the
// all_gather), tt_filter_struct_packed runs the same kernels reading bit
// p of the packed row (lhs_at<true>) where tt_filter_struct reads byte
// lm[p]: no (Bl, S) byte mask is unpacked between the collective and the
// struct pass (tempo_tpu/parallel/search.py:175-189's unpackbits).
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
//
// Two routes, chosen before launch by kernels.filter_plan from data known
// when the block was staged (ops/filter.trace_tiles):
//   multi-launch  the kernels above, each writing a byte-a-span mask slot
//                 to device memory for the next to read back; `>>` alone
//                 is init + log2(n_spans_b) doubling passes + final.
//   trace tile    filter_tile_kernel: a CTA takes a tile of whole traces
//                 (at most `tile` spans) and runs the whole program there
//                 in one launch: span steps one thread a span into bit
//                 slots in shared memory, struct steps on the tile's
//                 parent rows held in shared memory (every parent lies in
//                 its span's own trace: the plan checks it), the trace
//                 program one thread a trace over the slot words, then
//                 trace_mask, counts and (span_out) the span mask. The
//                 block-wide orphan rule of `~` needs one flag a `~` node
//                 over every tile: where the block holds orphans, a first
//                 launch of the same kernel runs the steps up to the last
//                 `~` and writes each tile's flag word; the main launch
//                 ORs them. A program with resource.attr conditions keeps
//                 the block-wide res pass first. So 1 launch a program,
//                 2 with a res pass or a flag pass, 3 with both.
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

// the lhs mask at row p (0 <= p < nb): byte lm[p], or, PACKED, bit p of
// the row packed 8 to a byte, row 8j at bit 7 of byte j (np.packbits)
template <bool PACKED>
__device__ __forceinline__ bool lhs_at(const uint8_t* __restrict__ lm, int p) {
    if (PACKED) return (__ldg(lm + (p >> 3)) >> (7 - (p & 7))) & 1;
    return lm[p] != 0;
}

// rm, pidx and out hold the n_out rows from global row row0; lm all nb
// (one block: row0 0 and n_out nb; a shard: lm gathered over the mesh)
template <bool PACKED>
__global__ void struct_child_kernel(const uint8_t* __restrict__ lm, const uint8_t* __restrict__ rm,
                                    const int32_t* __restrict__ pidx, uint8_t* __restrict__ out,
                                    int nb, int n_spans, int row0, int n_out) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n_out) return;
    int p = pidx[s];
    bool has_p = p >= 0 && row0 + s < n_spans;
    out[s] = rm[s] && has_p && lhs_at<PACKED>(lm, tt_clamp(p, 0, nb - 1));
}

template <bool PACKED>
__global__ void desc_init_kernel(const uint8_t* __restrict__ lm, const int32_t* __restrict__ pidx,
                                 uint8_t* __restrict__ acc, int32_t* __restrict__ ptr,
                                 int nb, int n_spans) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nb) return;
    int p = pidx[s];
    bool has_p = p >= 0 && s < n_spans;
    int safe = tt_clamp(p, 0, nb - 1);
    acc[s] = has_p && lhs_at<PACKED>(lm, safe);
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

template <bool PACKED>
__global__ void sib_count_kernel(const uint8_t* __restrict__ lm, const int32_t* __restrict__ pidx,
                                 int32_t* __restrict__ cnt, int32_t* __restrict__ orphan_flag,
                                 int nb, int n_spans) {
    int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= nb) return;
    if (!lhs_at<PACKED>(lm, s) || s >= n_spans) return;
    int p = pidx[s];
    if (p >= 0) atomicAdd(&cnt[tt_clamp(p, 0, nb - 1)], 1);
    if (p == -2) *orphan_flag = 1;
}

template <bool PACKED>
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
    bool l = lhs_at<PACKED>(lm, g), r = rm[s] != 0;
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

// ------------------------------------------------------- the trace-tile route
#define FT_THREADS 512
#define FT_FULL 0xffffffffu
#define SW 5  // step table row width (ops/filter.py _FilterProgram.steps_off)
enum StepKind { S_SPAN = 0, S_CHILD, S_DESC, S_SIB };

__device__ __forceinline__ bool ft_bit(const uint32_t* b, int i) {
    return (b[i >> 5] >> (i & 31)) & 1u;
}

// the bits of word w that lie in [lo, hi)
__device__ __forceinline__ uint32_t ft_range(int w, int lo, int hi) {
    int a = lo - 32 * w, e = hi - 32 * w;
    uint32_t m = e >= 32 ? FT_FULL : (e <= 0 ? 0u : (1u << e) - 1u);
    return a <= 0 ? m : (a >= 32 ? 0u : m & ~((1u << a) - 1u));
}

// any bit of [lo, hi) set in one slot
__device__ __forceinline__ bool ft_any(const uint32_t* slot, int lo, int hi) {
    for (int w = lo >> 5; w < ((hi + 31) >> 5); ++w)
        if (slot[w] & ft_range(w, lo, hi)) return true;
    return false;
}

// one span's postfix span program; C_MASK reads a bit slot of the tile
__device__ __forceinline__ bool ft_span_prog(const int32_t* code, int len, const long long* desc,
                                             const uint32_t* bits, int W, int i, int s,
                                             const uint8_t* resmask, int n_res_b,
                                             const int32_t* res_idx) {
    unsigned long long st = 0;
    for (int p = 0; p < len; p += 2) {
        int c = code[p], arg = code[p + 1];
        bool v;
        if (c == C_AND || c == C_OR) {
            bool b = st & 1, a = (st >> 1) & 1;
            st >>= 2;
            v = c == C_AND ? (a && b) : (a || b);
        } else if (c == C_COND) {
            v = span_leaf(desc + (long long)arg * DW, s, true, resmask, n_res_b, res_idx);
        } else if (c == C_MASK) {
            v = ft_bit(bits + (long long)arg * W, i);
        } else {
            v = c == C_TRUE;
        }
        st = (st << 1) | (unsigned long long)v;
    }
    return st & 1;
}

// One CTA a tile: traces [bounds[b], bounds[b+1]), spans [S0, S0 + n)
// with n <= tile, every span valid. Shared memory (kernels.filter_plan's
// smem): n_slots bit slots and a '>>' accumulator of tile/32 words each,
// the local parent row a span (int16: -1 none, -2 orphan), and 2 x tile
// int16 of scratch ('>>' pointers, ping-pong; '~' counts as int32).
// flag_pass: run steps [0, n_run) and write this tile's `~` flags
// (bit j: some lhs span of the j-th `~` is an orphan) to tile_flags[b];
// else run every step and the trace program, the flags ORed over all
// tiles (tile_flags null: the block has no orphan, every flag is 0).
__global__ void __launch_bounds__(FT_THREADS) filter_tile_kernel(
        const char* __restrict__ base, const int32_t* __restrict__ steps, int n_run, int n_slots,
        const long long* __restrict__ desc, const int32_t* __restrict__ tcode, int tlen,
        const int32_t* __restrict__ tslots, int n_tr, const uint8_t* __restrict__ resmask,
        int n_res_b, const int32_t* __restrict__ res_idx, const int32_t* __restrict__ pidx,
        const int32_t* __restrict__ span_off, const int32_t* __restrict__ bounds, int n_tiles,
        int tile, int n_passes, int n_spans, int n_spans_b, int n_traces,
        uint32_t* __restrict__ tile_flags, int flag_pass, uint8_t* __restrict__ trace_mask,
        int32_t* __restrict__ counts, uint8_t* __restrict__ span_mask) {
    extern __shared__ uint32_t ft_sm[];
    __shared__ uint32_t sib_flags;
    const int W = tile >> 5;
    uint32_t* bits = ft_sm;
    uint32_t* acc2 = bits + (long long)n_slots * W;
    int16_t* pl = (int16_t*)(acc2 + W);
    int16_t* scr = pl + tile;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t0 = bounds[blockIdx.x], t1 = bounds[blockIdx.x + 1];
    const int S0 = min(span_off[t0], n_spans);
    const int n = min(span_off[t1], n_spans) - S0;
    const int nw = (n + 31) >> 5;
    if (tid == 0) sib_flags = 0;
    if (pidx)
        for (int i = tid; i < n; i += FT_THREADS) {
            int p = pidx[S0 + i];
            pl[i] = (int16_t)(p >= 0 ? p - S0 : (p == -2 ? -2 : -1));
        }
    __syncthreads();
    if (!flag_pass && tile_flags) {
        uint32_t f = 0;
        for (int i = tid; i < n_tiles; i += FT_THREADS) f |= tile_flags[i];
        for (int o = 16; o; o >>= 1) f |= __shfl_xor_sync(FT_FULL, f, o);
        if (lane == 0 && f) atomicOr(&sib_flags, f);
        __syncthreads();
    }

    for (int k = 0; k < n_run; ++k) {
        const int32_t* st = steps + k * SW;
        const int kind = st[0];
        uint32_t* out = bits + (long long)st[3] * W;
        if (kind == S_SPAN) {
            const int32_t* code = (const int32_t*)(base + st[1]);
            for (int i0 = 0; i0 < n; i0 += FT_THREADS) {
                int i = i0 + tid;
                bool v = i < n && ft_span_prog(code, st[2], desc, bits, W, i, S0 + i, resmask,
                                               n_res_b, res_idx);
                uint32_t w = __ballot_sync(FT_FULL, v);
                if (lane == 0 && (i0 >> 5) + warp < nw) out[(i0 >> 5) + warp] = w;
            }
        } else {
            const uint32_t* lm = bits + (long long)st[1] * W;
            const uint32_t* rm = bits + (long long)st[2] * W;
            if (kind == S_CHILD) {
                for (int i0 = 0; i0 < n; i0 += FT_THREADS) {
                    int i = i0 + tid;
                    int p = i < n ? pl[i] : -1;
                    uint32_t w = __ballot_sync(FT_FULL, p >= 0 && ft_bit(rm, i) && ft_bit(lm, p));
                    if (lane == 0 && (i0 >> 5) + warp < nw) out[(i0 >> 5) + warp] = w;
                }
            } else if (kind == S_DESC) {
                // pointer doubling in the tile: after pass j, acc holds the
                // lhs OR over ancestors 1..2^j hops up; every ancestor lies
                // in the trace, so 2^n_passes >= the longest trace covers
                // them all (the plain version's extra passes change nothing)
                int16_t *pa = scr, *pb = scr + tile;
                uint32_t *aa = out, *ab = acc2;
                for (int i0 = 0; i0 < n; i0 += FT_THREADS) {
                    int i = i0 + tid;
                    int p = i < n ? pl[i] : -1;
                    uint32_t w = __ballot_sync(FT_FULL, p >= 0 && ft_bit(lm, p));
                    if (lane == 0 && (i0 >> 5) + warp < nw) aa[(i0 >> 5) + warp] = w;
                    if (i < n) pa[i] = (int16_t)(p >= 0 ? p : -1);
                }
                __syncthreads();
                for (int it = 0; it < n_passes; ++it) {
                    int alive_any = 0;
                    for (int i0 = 0; i0 < n; i0 += FT_THREADS) {
                        int i = i0 + tid;
                        int p = i < n ? pa[i] : -1;
                        bool alive = p >= 0;
                        uint32_t w = __ballot_sync(FT_FULL, i < n && (ft_bit(aa, i) ||
                                                                      (alive && ft_bit(aa, p))));
                        if (lane == 0 && (i0 >> 5) + warp < nw) ab[(i0 >> 5) + warp] = w;
                        if (i < n) pb[i] = alive ? pa[p] : (int16_t)-1;
                        alive_any |= alive;
                    }
                    uint32_t* ta = aa; aa = ab; ab = ta;
                    int16_t* tp = pa; pa = pb; pb = tp;
                    if (!__syncthreads_or(alive_any)) break;
                }
                // each warp reads and writes only its own words: aa may be out
                for (int i0 = 0; i0 < n; i0 += FT_THREADS) {
                    int i = i0 + tid;
                    uint32_t w = __ballot_sync(FT_FULL, i < n && ft_bit(rm, i) && ft_bit(aa, i));
                    if (lane == 0 && (i0 >> 5) + warp < nw) out[(i0 >> 5) + warp] = w;
                }
            } else {  // S_SIB: per-parent lhs counts in shared memory
                int32_t* cnt = (int32_t*)scr;
                for (int i = tid; i < n; i += FT_THREADS) cnt[i] = 0;
                __syncthreads();
                int lhs_orphan = 0;
                for (int i = tid; i < n; i += FT_THREADS) {
                    int p = pl[i];
                    bool l = ft_bit(lm, i);
                    if (l && p >= 0) atomicAdd(&cnt[p], 1);
                    lhs_orphan |= l && p == -2;
                }
                if (__syncthreads_or(lhs_orphan) && flag_pass && tid == 0) sib_flags |= 1u << st[4];
                const bool F = !flag_pass && ((sib_flags >> st[4]) & 1u);
                for (int i0 = 0; i0 < n; i0 += FT_THREADS) {
                    int i = i0 + tid;
                    int p = i < n ? pl[i] : -1;
                    bool l = i < n && ft_bit(lm, i), r = i < n && ft_bit(rm, i);
                    bool v = r && ((p >= 0 && cnt[p] - (int)l > 0) || (p == -2 && F));
                    uint32_t w = __ballot_sync(FT_FULL, v);
                    if (lane == 0 && (i0 >> 5) + warp < nw) out[(i0 >> 5) + warp] = w;
                }
            }
        }
        __syncthreads();
    }
    if (flag_pass) {
        if (tid == 0) tile_flags[blockIdx.x] = sib_flags;
        return;
    }

    // the trace program, one thread a trace over the tile's bit slots
    // (a warp takes 32 neighbouring traces: their offsets load coalesced)
    for (int t = t0 + tid; t < t1; t += FT_THREADS) {
        const int lo = min(span_off[t], n_spans) - S0, hi = min(span_off[t + 1], n_spans) - S0;
        unsigned long long st = 0;
        for (int p = 0; p < tlen; p += 2) {
            int c = tcode[p], arg = tcode[p + 1];
            bool v;
            if (c == C_AND || c == C_OR) {
                bool b = st & 1, a = (st >> 1) & 1;
                st >>= 2;
                v = c == C_AND ? (a && b) : (a || b);
            } else if (c == C_TRACIFY) {
                v = ft_any(bits + (long long)tslots[arg] * W, lo, hi);
            } else if (c == C_COND) {
                const long long* d = desc + (long long)arg * DW;
                v = cmp_at(d, (const void*)d[D_COL], t);
            } else {
                v = c == C_TRUE;
            }
            st = (st << 1) | (unsigned long long)v;
        }
        const bool tm = (st & 1) && t < n_traces;
        // matched spans: the union of every tracify slot (every span when
        // the tree has none), zero where the trace fails
        int c = 0;
        if (tm)
            for (int w = lo >> 5; w < ((hi + 31) >> 5); ++w) {
                uint32_t u = n_tr ? 0u : FT_FULL;
                for (int j = 0; j < n_tr; ++j) u |= bits[(long long)tslots[j] * W + w];
                c += __popc(u & ft_range(w, lo, hi));
            }
        trace_mask[t] = tm;
        counts[t] = c;
        if (span_mask)
            for (int i = lo; i < hi; ++i) {
                bool u = n_tr == 0;
                for (int j = 0; j < n_tr && !u; ++j) u = ft_bit(bits + (long long)tslots[j] * W, i);
                span_mask[S0 + i] = tm && u;
            }
    }
    if (span_mask && blockIdx.x == gridDim.x - 1)
        for (int s = S0 + n + tid; s < n_spans_b; s += FT_THREADS) span_mask[s] = 0;
}

// The trace-tile route of one program run (kernels.filter_run): the res
// pass when n_rc > 0, the flag pass when tile_flags is set, then the
// main pass. Pointers into the program buffer are computed by the caller
// (span codes: base + the step table's offsets).
TT_EXPORT int tt_filter_tiles(const char* base, const int32_t* steps, int n_steps, int last_sib,
                              int n_slots, const long long* desc, const int32_t* tcode, int tlen,
                              const int32_t* tslots, int n_tr, const int32_t* rconds, int n_rc,
                              uint8_t* resmask, int n_res_b, const int32_t* res_idx,
                              const int32_t* pidx, const int32_t* span_off, const int32_t* bounds,
                              int n_tiles, int tile, int n_passes, int n_spans, int n_spans_b,
                              int n_traces, uint32_t* tile_flags, uint8_t* trace_mask,
                              int32_t* counts, uint8_t* span_mask, int smem, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n_rc > 0) {
        long long n = (long long)n_rc * n_res_b;
        res_pass_kernel<<<tt_blocks(n, 256), 256, 0, st>>>(desc, rconds, n_rc, n_res_b, resmask);
        TT_LAUNCHED();
    }
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(filter_tile_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    if (tile_flags) {
        filter_tile_kernel<<<n_tiles, FT_THREADS, smem, st>>>(
            base, steps, last_sib + 1, n_slots, desc, tcode, tlen, tslots, n_tr, resmask, n_res_b,
            res_idx, pidx, span_off, bounds, n_tiles, tile, n_passes, n_spans, n_spans_b, n_traces,
            tile_flags, 1, trace_mask, counts, span_mask);
        TT_LAUNCHED();
    }
    filter_tile_kernel<<<n_tiles, FT_THREADS, smem, st>>>(
        base, steps, n_steps, n_slots, desc, tcode, tlen, tslots, n_tr, resmask, n_res_b, res_idx,
        pidx, span_off, bounds, n_tiles, tile, n_passes, n_spans, n_spans_b, n_traces, tile_flags, 0,
        trace_mask, counts, span_mask);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
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
// PACKED: lm is nb / 8 bytes, the mask packed 8 rows to a byte; its
// launches count in slot 1 (kernels.py "struct_packed").
template <bool PACKED>
static int filter_struct(int op, const uint8_t* lm, const uint8_t* rm, uint8_t* out,
                         const int32_t* pidx, int nb, int n_spans, int n_passes,
                         int32_t* scratch_i32, uint8_t* scratch_u8, int row0, int n_out,
                         cudaStream_t st) {
    const int slot = PACKED ? 1 : 0;
    int g = tt_blocks(nb, 256), go = tt_blocks(n_out, 256);
    if (op == 0) {
        struct_child_kernel<PACKED><<<go, 256, 0, st>>>(lm, rm, pidx, out, nb, n_spans, row0,
                                                        n_out);
        TT_LAUNCHED_SLOT(slot);
    } else if (op == 1) {
        uint8_t* acc[2] = {scratch_u8, scratch_u8 + nb};
        int32_t* ptr[2] = {scratch_i32, scratch_i32 + nb};
        desc_init_kernel<PACKED><<<g, 256, 0, st>>>(lm, pidx, acc[0], ptr[0], nb, n_spans);
        TT_LAUNCHED_SLOT(slot);
        for (int i = 0; i < n_passes; ++i) {
            desc_step_kernel<<<g, 256, 0, st>>>(acc[i & 1], ptr[i & 1], acc[(i + 1) & 1],
                                                ptr[(i + 1) & 1], nb);
            TT_LAUNCHED_SLOT(slot);
        }
        desc_final_kernel<<<go, 256, 0, st>>>(rm, acc[n_passes & 1], out, row0, n_out);
        TT_LAUNCHED_SLOT(slot);
    } else {
        cudaError_t e = cudaMemsetAsync(scratch_i32, 0, (size_t)(nb + 1) * sizeof(int32_t), st);
        if (e != cudaSuccess) return (int)e;
        sib_count_kernel<PACKED><<<g, 256, 0, st>>>(lm, pidx, scratch_i32, scratch_i32 + nb, nb,
                                                    n_spans);
        TT_LAUNCHED_SLOT(slot);
        sib_final_kernel<PACKED><<<go, 256, 0, st>>>(lm, rm, pidx, scratch_i32, scratch_i32 + nb,
                                                     out, nb, n_spans, row0, n_out);
        TT_LAUNCHED_SLOT(slot);
    }
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_filter_struct(int op, const uint8_t* lm, const uint8_t* rm, uint8_t* out,
                               const int32_t* pidx, int nb, int n_spans, int n_passes,
                               int32_t* scratch_i32, uint8_t* scratch_u8, int row0, int n_out,
                               void* stream) {
    return filter_struct<false>(op, lm, rm, out, pidx, nb, n_spans, n_passes, scratch_i32,
                                scratch_u8, row0, n_out, (cudaStream_t)stream);
}

// the same struct pass over an lhs mask packed 8 rows to a byte (nb % 8 == 0)
TT_EXPORT int tt_filter_struct_packed(int op, const uint8_t* pk, const uint8_t* rm, uint8_t* out,
                                      const int32_t* pidx, int nb, int n_spans, int n_passes,
                                      int32_t* scratch_i32, uint8_t* scratch_u8, int row0,
                                      int n_out, void* stream) {
    if (nb % 8) return (int)cudaErrorInvalidValue;
    return filter_struct<true>(op, pk, rm, out, pidx, nb, n_spans, n_passes, scratch_i32,
                               scratch_u8, row0, n_out, (cudaStream_t)stream);
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
