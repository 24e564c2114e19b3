// M5-M8: the per-shard halves of the sharded search (parallel/search.py),
// the parts of tempo_tpu/parallel/search.py:95-333 (`make_sharded_search`,
// its `local`) that K1 (filter.cu) cannot do on a shard. A rank holds Bl
// blocks (the dp axis) and a slice of each block's span rows and
// generic-attr rows (the sp axis): span rows [row0, row0 + Sl), attr rows
// [arow0, arow0 + Al). Every condition leaf reads its own block's
// operands through K1's descriptor rows (cond.cuh), one descriptor table
// a block, their addresses in `descs`.
//
//   M5 attr_partial (slot 0)  per (block, owner): how many of the
//        shard's attr rows of that owner match a generic-attr leaf
//        (`owner_counts` of the reference's `attr_mask`, search.py:
//        122-170): the owner's global offsets clipped to the shard. A
//        resource leaf is an owner with one row, itself (the res column
//        is replicated along sp). Then, after the caller's collective
//        (a reduce-scatter over sp for span attrs, an all_reduce SUM
//        for resource attrs, none for a resource column), attr_mask
//        turns the summed counts into the leaf's span mask slot: > 0 at
//        the span, or at its clamped span.res_idx, and only for valid
//        rows. K1 reads that slot as a C_MASK leaf.
//   M6 mask_pack (slot 1), mask_unpack (slot 2)  the bool lhs mask of a
//        struct node 8 rows to a byte before the sp all_gather and back
//        after, in jnp.packbits' big-endian order: bit 7 of byte j is
//        row 8j (`gather_mask`, search.py:175-189).
//   M7 search_partial (slot 3)  per (block, trace): the shard's matched
//        spans of each tracify slot and of their union (every valid row
//        when the tree has none), over the trace's offsets clipped to
//        the shard, or without trace.span_off by atomicAdd at the clamped
//        span.trace_sid (`seg_reduce`, search.py:272-290). Exact int32,
//        so any split sums (all_reduce SUM over sp) to the whole block's
//        counts.
//   M8 search_finish (slot 4)  the trace program over the summed counts:
//        a tracify leaf is count > 0, a trace condition compares its
//        block's trace column with that block's operands; trace_mask and
//        where(trace_mask, union count, 0) (`ev_trace`, search.py:
//        292-322).
//
// Bound: bytes for all of them. M5 reads each attr row's key once (4 B),
// the vtype and value only of the rows whose key matches, and each owner
// offset once; M6 moves 9 B a row; M7 reads each
// slot byte once (and the offsets or trace_sid); M8 reads the counts and
// the trace columns once. A thread an owner, a byte, a trace or a span
// row: simple kernels first, as every first port here.
#include "cond.cuh"

__device__ __forceinline__ int attr_count(const long long* d, int lo, int hi) {
    const int32_t* keycol = (const int32_t*)d[D_KEYCOL];
    const int32_t* vtcol = (const int32_t*)d[D_VTCOL];
    const void* col = (const void*)d[D_COL];
    int key = (int)d[D_KEY], vt = (int)d[D_VT];
    int c = 0;
    for (int j = lo; j < hi; ++j) {
        if (keycol[j] != key) continue;
        if (vt < 0 || (vtcol[j] == vt && cmp_at(d, col, j))) ++c;  // vt < 0: 'any'
    }
    return c;
}

__global__ void attr_partial_kernel(const long long* __restrict__ descs, int cond, int bl,
                                    int n_seg, int al, int arow0, int32_t* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * n_seg) return;
    int b = (int)(t / n_seg), o = (int)(t % n_seg);
    const long long* d = (const long long*)descs[b] + (long long)cond * DW;
    if ((int)d[D_KIND] == K_RES) {
        out[t] = cmp_at(d, (const void*)d[D_COL], o);
        return;
    }
    const int32_t* off = (const int32_t*)d[D_OFF];
    int lo = tt_clamp(off[o] - arow0, 0, al), hi = tt_clamp(off[o + 1] - arow0, 0, al);
    // ecs[hi] - ecs[lo] of the reference, negative on a falling offset
    out[t] = hi >= lo ? attr_count(d, lo, hi) : -attr_count(d, hi, lo);
}

__global__ void attr_mask_kernel(const int32_t* __restrict__ cnt, int n_own,
                                 const int32_t* __restrict__ res_idx,
                                 const int32_t* __restrict__ n_spans, int bl, int sl, int row0,
                                 uint8_t* __restrict__ out, long long out_stride) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * sl) return;
    int b = (int)(t / sl), s = (int)(t % sl);
    bool v;
    if (!res_idx) {
        v = cnt[t] > 0;  // span attrs: the counts are the shard's own rows
    } else {
        int r = res_idx[t];
        v = r >= 0 && cnt[(long long)b * n_own + tt_clamp(r, 0, n_own - 1)] > 0;
    }
    out[b * out_stride + s] = v && s < n_spans[b] - row0;
}

__global__ void mask_pack_kernel(const uint8_t* __restrict__ in, long long stride, int bl,
                                 int nbytes, uint8_t* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * nbytes) return;
    int b = (int)(t / nbytes), j = (int)(t % nbytes);
    const uint8_t* p = in + b * stride + 8LL * j;
    unsigned v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= (unsigned)(p[k] != 0) << (7 - k);
    out[t] = (uint8_t)v;
}

__global__ void mask_unpack_kernel(const uint8_t* __restrict__ in, int bl, int nbytes,
                                   uint8_t* __restrict__ out) {
    long long n = 8LL * nbytes;
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * n) return;
    long long b = t / n, s = t % n;
    out[t] = (in[b * nbytes + s / 8] >> (7 - (int)(s % 8))) & 1;
}

// the union of the tracify slots at row s (every valid row without one)
__device__ __forceinline__ bool union_at(const uint8_t* sb, const int32_t* tslots, int n_tr,
                                         int sl, int s, bool valid) {
    if (n_tr == 0) return valid;
    for (int i = 0; i < n_tr; ++i)
        if (sb[(long long)tslots[i] * sl + s]) return true;
    return false;
}

__global__ void search_partial_off_kernel(const uint8_t* __restrict__ slots, int n_slots,
                                          const int32_t* __restrict__ tslots, int n_tr,
                                          const int32_t* __restrict__ span_off,
                                          const int32_t* __restrict__ n_spans, int bl, int sl,
                                          int row0, int nt, int32_t* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * nt) return;
    int b = (int)(t / nt), tr = (int)(t % nt);
    const int32_t* off = span_off + (long long)b * (nt + 1);
    int lo = tt_clamp(off[tr] - row0, 0, sl), hi = tt_clamp(off[tr + 1] - row0, 0, sl);
    int a = min(lo, hi), e = max(lo, hi), sign = hi >= lo ? 1 : -1;
    const uint8_t* sb = slots + (long long)b * n_slots * sl;
    int32_t* ob = out + (long long)b * (n_tr + 1) * nt + tr;
    for (int i = 0; i < n_tr; ++i) {
        const uint8_t* m = sb + (long long)tslots[i] * sl;
        int c = 0;
        for (int s = a; s < e; ++s) c += m[s] != 0;
        ob[(long long)i * nt] = sign * c;
    }
    int nv = n_spans[b] - row0, c = 0;
    for (int s = a; s < e; ++s) c += union_at(sb, tslots, n_tr, sl, s, s < nv);
    ob[(long long)n_tr * nt] = sign * c;
}

__global__ void search_partial_sid_kernel(const uint8_t* __restrict__ slots, int n_slots,
                                          const int32_t* __restrict__ tslots, int n_tr,
                                          const int32_t* __restrict__ tsid,
                                          const int32_t* __restrict__ n_spans, int bl, int sl,
                                          int row0, int nt, int32_t* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * sl) return;
    int b = (int)(t / sl), s = (int)(t % sl);
    int sid = tt_clamp(tsid[t], 0, nt);  // a masked row past the traces drops out
    if (sid == nt) return;
    const uint8_t* sb = slots + (long long)b * n_slots * sl;
    int32_t* ob = out + (long long)b * (n_tr + 1) * nt + sid;
    for (int i = 0; i < n_tr; ++i)
        if (sb[(long long)tslots[i] * sl + s]) atomicAdd(ob + (long long)i * nt, 1);
    if (union_at(sb, tslots, n_tr, sl, s, s < n_spans[b] - row0))
        atomicAdd(ob + (long long)n_tr * nt, 1);
}

__global__ void search_finish_kernel(const int32_t* __restrict__ prog, int len,
                                     const long long* __restrict__ descs,
                                     const int32_t* __restrict__ counts, int n_tr, int bl, int nt,
                                     uint8_t* __restrict__ tm, int32_t* __restrict__ cnt) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)bl * nt) return;
    int b = (int)(t / nt), tr = (int)(t % nt);
    const long long* desc = (const long long*)descs[b];
    const int32_t* cb = counts + (long long)b * (n_tr + 1) * nt + tr;
    unsigned long long st = 0;
    for (int p = 0; p < len; p += 2) {
        int code = prog[p], arg = prog[p + 1];
        bool v;
        if (code == C_AND || code == C_OR) {
            bool y = st & 1, x = (st >> 1) & 1;
            st >>= 2;
            v = code == C_AND ? (x && y) : (x || y);
        } else if (code == C_TRACIFY) {
            v = cb[(long long)arg * nt] > 0;
        } else if (code == C_COND) {
            const long long* d = desc + (long long)arg * DW;
            v = cmp_at(d, (const void*)d[D_COL], tr);
        } else {
            v = code == C_TRUE;
        }
        st = (st << 1) | (unsigned long long)v;
    }
    bool m = st & 1;
    tm[t] = m;
    cnt[t] = m ? cb[(long long)n_tr * nt] : 0;
}

TT_EXPORT int tt_attr_partial(const long long* descs, int cond, int bl, int n_seg, int al,
                              int arow0, int32_t* out, void* stream) {
    attr_partial_kernel<<<tt_blocks((long long)bl * n_seg, 256), 256, 0, (cudaStream_t)stream>>>(
        descs, cond, bl, n_seg, al, arow0, out);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_attr_mask(const int32_t* cnt, int n_own, const int32_t* res_idx,
                           const int32_t* n_spans, int bl, int sl, int row0, uint8_t* out,
                           long long out_stride, void* stream) {
    attr_mask_kernel<<<tt_blocks((long long)bl * sl, 256), 256, 0, (cudaStream_t)stream>>>(
        cnt, n_own, res_idx, n_spans, bl, sl, row0, out, out_stride);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_mask_pack(const uint8_t* in, long long stride, int bl, int nbytes, uint8_t* out,
                           void* stream) {
    mask_pack_kernel<<<tt_blocks((long long)bl * nbytes, 256), 256, 0, (cudaStream_t)stream>>>(
        in, stride, bl, nbytes, out);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_mask_unpack(const uint8_t* in, int bl, int nbytes, uint8_t* out, void* stream) {
    mask_unpack_kernel<<<tt_blocks(8LL * bl * nbytes, 256), 256, 0, (cudaStream_t)stream>>>(
        in, bl, nbytes, out);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_search_partial(const uint8_t* slots, int n_slots, const int32_t* tslots, int n_tr,
                                const int32_t* span_off, const int32_t* tsid,
                                const int32_t* n_spans, int bl, int sl, int row0, int nt,
                                int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (span_off) {
        search_partial_off_kernel<<<tt_blocks((long long)bl * nt, 128), 128, 0, st>>>(
            slots, n_slots, tslots, n_tr, span_off, n_spans, bl, sl, row0, nt, out);
    } else {
        size_t n = (size_t)bl * (n_tr + 1) * nt * sizeof(int32_t);
        cudaError_t e = cudaMemsetAsync(out, 0, n, st);
        if (e != cudaSuccess) return (int)e;
        search_partial_sid_kernel<<<tt_blocks((long long)bl * sl, 256), 256, 0, st>>>(
            slots, n_slots, tslots, n_tr, tsid, n_spans, bl, sl, row0, nt, out);
    }
    TT_LAUNCHED_SLOT(3);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_search_finish(const int32_t* prog, int len, const long long* descs,
                               const int32_t* counts, int n_tr, int bl, int nt, uint8_t* tm,
                               int32_t* cnt, void* stream) {
    search_finish_kernel<<<tt_blocks((long long)bl * nt, 128), 128, 0, (cudaStream_t)stream>>>(
        prog, len, descs, counts, n_tr, bl, nt, tm, cnt);
    TT_LAUNCHED_SLOT(4);
    return (int)cudaGetLastError();
}
