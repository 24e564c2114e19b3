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
// the vtype and value only of the rows whose key matches, each owner
// offset once and writes each count once; M6 moves 9 B a row; M7 reads
// each slot byte once (and the offsets or trace_sid); M8 reads the counts
// and the trace columns once. M6-M8 are a thread a byte, a trace or a
// span row: simple kernels first, as every first port here.
//
// M5's count (attr_tile_kernel) is a CTA a tile of AP_TILE consecutive
// owners of one block. Its contract: out[b, o] = E(hi) - E(lo) with lo =
// clamp(off[o] - arow0, 0, al), hi = clamp(off[o + 1] - arow0, 0, al)
// (in 64 bits) and E(x) the shard's matching rows below x -- the
// reference's ecs[hi] - ecs[lo], negative on a falling offset, bit for
// bit `_attr_partial_plain` (ops/meshsearch.py) for every arow0, shard
// cut, leaf op and offset row. The CTA reads the block's descriptor once
// into shared memory and the tile's n + 1 offsets coalesced (scalar
// loads: block b's offset row starts 4 b (n_seg + 1) bytes into the
// column, not 16-byte aligned), clipped. A CTA-wide vote asks whether
// the clipped offsets c[0..n] are monotone. If they are, the tile's rows
// are one window [c[0], c[n]), walked in chunks of AP_CHUNK rows: the
// chunk's keys are copied to shared memory (cp.async, AP_ROWS 4-byte
// copies a thread, all in flight at once and none holding a register;
// the window's first chunk is issued before the vote), then the vtype
// and value of the rows whose key matched are loaded, AP_BATCH rows a
// thread together, and the hits are balloted into AP_WORDS words with an
// exclusive prefix of their popcounts. E(c[i]) - E(c[0]) is the running
// base plus the prefix and popcount at c[i], taken in the chunk that
// holds c[i], so a window of any length is walked (no cap on an owner's
// rows), and owner i's count is the difference of its two offsets'
// values. A tile that is not monotone (offsets no writer produces)
// counts each owner's rows itself, signs included, as the first port
// did. A resource leaf writes its compare per resource. What bounds it
// on the card: each CTA's chain of round trips (descriptor, offsets, the
// chunk's keys, then the values of the rows whose key matched), hidden
// by the CTAs an SM holds (AP_MIN_CTAS, by shared memory). Phase 15's
// windows (about 4,096 rows a tile) fit one chunk, so a value leaf waits
// for its values once a tile where chunks of 2,048 keys in registers
// waited twice: 12 % less device time for a `str` leaf, 2 % more for an
// `any` leaf (NVIDIA H100 80GB HBM3, 700 W; PERF.md has them and
// the variants measured).
#include "cond.cuh"

#define AP_THREADS 256
#define AP_OWN 8                             // owners a thread
#define AP_ROWS 32                           // rows a thread a chunk (bits of one hit word)
#define AP_MIN_CTAS 5                        // CTAs an SM (shared memory: 42 KB a CTA)
#define AP_BATCH 2                           // value loads a thread issues together
#define AP_TILE (AP_THREADS * AP_OWN)        // owners a CTA
#define AP_CHUNK (AP_THREADS * AP_ROWS)      // rows a chunk, their keys in shared memory
#define AP_WORDS (AP_CHUNK / 32)             // hit words a chunk
#define AP_WPL (AP_WORDS / 32)               // words a lane of the prefix warp
static_assert(AP_ROWS <= 32 && AP_ROWS % 4 == 0, "a thread's hits are one word; whole words a lane");

__device__ __forceinline__ int attr_count(const long long* d, int lo, int hi) {
    const int32_t* keycol = (const int32_t*)d[D_KEYCOL];
    const int32_t* vtcol = (const int32_t*)d[D_VTCOL];
    const void* col = (const void*)d[D_COL];
    int key = (int)d[D_KEY], vt = (int)d[D_VT];
    int c = 0;
    for (int j = lo; j < hi; ++j)
        c += keycol[j] == key && (vt < 0 || (vtcol[j] == vt && cmp_at(d, col, j)));
    return c;
}

__device__ __forceinline__ int clip_off(int32_t off, int arow0, int al) {
    long long x = (long long)off - arow0;
    return (int)(x < 0 ? 0 : (x > al ? al : x));
}

// the keys of the chunk's rows [base, w1) into s_key (row base + r at r),
// AP_ROWS 4-byte copies a thread that hold no register while in flight
// (tt_copy_wait lands them)
__device__ __forceinline__ void chunk_keys(int32_t* s_key, const int32_t* keycol, int base, int w1) {
#pragma unroll
    for (int u = 0; u < AP_ROWS; ++u) {
        const int r = u * AP_THREADS + (int)threadIdx.x;
        if (base + r < w1) tt_copy4(s_key + r, keycol + base + r);
    }
}

// of the rows in `hit` (bit u: row base + u AP_THREADS + tid, its key the
// leaf's), those whose vtype and value match too; AP_BATCH rows' loads
// issued together, so a thread with a few such rows waits about once
__device__ __forceinline__ unsigned chunk_values(const long long* d, const int32_t* vtcol,
                                                 const int32_t* col, int vt, int base,
                                                 unsigned hit) {
    for (unsigned todo = hit; todo;) {
        unsigned bit[AP_BATCH];
        int v[AP_BATCH], x[AP_BATCH];
#pragma unroll
        for (int q = 0; q < AP_BATCH; ++q) {
            bit[q] = todo & (0u - todo);  // the lowest row left, or 0
            todo ^= bit[q];
            const int j = base + (__ffs(bit[q]) - 1) * AP_THREADS + (int)threadIdx.x;
            if (bit[q]) {
                v[q] = __ldg(vtcol + j);
                x[q] = __ldg(col + j);
            }
        }
#pragma unroll
        for (int q = 0; q < AP_BATCH; ++q)
            if (bit[q] && !(v[q] == vt && cmp_word(d, x[q]))) hit ^= bit[q];
    }
    return hit;
}

__global__ void __launch_bounds__(AP_THREADS, AP_MIN_CTAS)
    attr_tile_kernel(const long long* __restrict__ descs, int cond, int n_seg, int al, int arow0,
                     int32_t* __restrict__ out) {
    __shared__ long long s_d[DW];
    __shared__ int s_off[AP_TILE + 1];   // the tile's clipped offsets c[0..n], then E(c[i]) - E(c[0])
    __shared__ int32_t s_key[AP_CHUNK];  // the chunk's keys
    __shared__ unsigned s_word[AP_WORDS];
    __shared__ int s_pre[AP_WORDS + 1];  // exclusive prefix; [AP_WORDS] the chunk's total
    const int tid = threadIdx.x, b = blockIdx.y;
    const int o0 = blockIdx.x * AP_TILE, n = min(AP_TILE, n_seg - o0);
    if (tid < DW) s_d[tid] = ((const long long*)descs[b])[(long long)cond * DW + tid];
    __syncthreads();
    const long long* d = s_d;
    int32_t* ob = out + (long long)b * n_seg + o0;
    if ((int)d[D_KIND] == K_RES) {
        const void* col = (const void*)d[D_COL];
        for (int i = tid; i < n; i += AP_THREADS) ob[i] = cmp_at(d, col, o0 + i);
        return;
    }
    // one round trip: the window's two ends (the same two words for every
    // thread) and this thread's offsets c[tid + m AP_THREADS], coalesced;
    // then the window's first keys, copied before the vote, which they do
    // not wait for
    const int32_t* off = (const int32_t*)d[D_OFF] + o0;
    const int32_t* keycol = (const int32_t*)d[D_KEYCOL];
    const int w0 = clip_off(__ldg(off), arow0, al), w1 = clip_off(__ldg(off + n), arow0, al);
    int c[AP_OWN + 1];
#pragma unroll
    for (int m = 0; m <= AP_OWN; ++m) {
        const int i = tid + m * AP_THREADS;
        c[m] = i <= n ? clip_off(__ldg(off + i), arow0, al) : w1;
        if (i <= n) s_off[i] = c[m];
    }
    chunk_keys(s_key, keycol, w0, w1);
    __syncthreads();
    bool mono = true;
#pragma unroll
    for (int m = 0; m < AP_OWN; ++m) {
        const int i = tid + m * AP_THREADS;
        if (i < n) mono &= c[m] <= s_off[i + 1];
    }
    if (!__syncthreads_and(mono)) {  // each owner's rows, the sign of a falling range kept
        tt_copy_wait();              // the copies land before the CTA leaves
        for (int i = tid; i < n; i += AP_THREADS) {
            const int lo = s_off[i], hi = s_off[i + 1];
            ob[i] = hi >= lo ? attr_count(d, lo, hi) : -attr_count(d, hi, lo);
        }
        return;
    }
    const int32_t* vtcol = (const int32_t*)d[D_VTCOL];
    const int32_t* col = (const int32_t*)d[D_COL];
    const int key = (int)d[D_KEY], vt = (int)d[D_VT];
    const int lane = tid & 31, warp = tid >> 5;
    unsigned done = 0;  // bit m: c[m] holds E(c[m]) - E(w0), taken in the chunk that holds it
    int run = 0;        // E(base) - E(w0)
    for (int base = w0; base < w1; base += AP_CHUNK) {
        if (base != w0) chunk_keys(s_key, keycol, base, w1);
        tt_copy_wait();  // this thread's copies: it reads only its own rows
        unsigned hit = 0;  // bit u: row base + u AP_THREADS + tid
#pragma unroll
        for (int u = 0; u < AP_ROWS; ++u) {
            const int r = u * AP_THREADS + tid;
            if (base + r < w1 && s_key[r] == key) hit |= 1u << u;
        }
        if (vt >= 0 && hit) hit = chunk_values(d, vtcol, col, vt, base, hit);
#pragma unroll
        for (int u = 0; u < AP_ROWS; ++u) {
            const unsigned m = __ballot_sync(0xFFFFFFFFu, hit >> u & 1);
            if (lane == 0) s_word[u * (AP_THREADS / 32) + warp] = m;  // rows base + 32 word
        }
        __syncthreads();
        if (warp == 0) {
            int cw[AP_WPL], t = 0;
#pragma unroll
            for (int q = 0; q < AP_WPL; ++q) t += cw[q] = __popc(s_word[lane * AP_WPL + q]);
            int incl = t;
#pragma unroll
            for (int sh = 1; sh < 32; sh <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, incl, sh);
                if (lane >= sh) incl += y;
            }
            int e = incl - t;
#pragma unroll
            for (int q = 0; q < AP_WPL; ++q) {
                s_pre[lane * AP_WPL + q] = e;
                e += cw[q];
            }
            if (lane == 31) s_pre[AP_WORDS] = incl;
        }
        __syncthreads();
#pragma unroll
        for (int m = 0; m <= AP_OWN; ++m) {  // each offset in the chunk that holds it
            const int pos = c[m] - base;
            if (!(done >> m & 1) && pos < AP_CHUNK) {
                const int k = pos >> 5;
                c[m] = run + s_pre[k] + __popc(s_word[k] & ((1u << (pos & 31)) - 1u));
                done |= 1u << m;
            }
        }
        run += s_pre[AP_WORDS];
        __syncthreads();  // the next chunk rewrites the words
    }
#pragma unroll
    for (int m = 0; m <= AP_OWN; ++m) {  // c[m] == w1 past the last chunk: the total
        const int i = tid + m * AP_THREADS;
        if (i <= n) s_off[i] = done >> m & 1 ? c[m] : run;
    }
    __syncthreads();
    for (int i = tid; i < n; i += AP_THREADS) ob[i] = s_off[i + 1] - s_off[i];
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
    if (bl < 1 || bl > 65535 || n_seg < 1 || al < 0) return (int)cudaErrorInvalidValue;
    static bool carved = false;  // AP_MIN_CTAS CTAs' shared memory an SM
    if (!carved) {
        const cudaError_t e = cudaFuncSetAttribute(
            attr_tile_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
        if (e) return (int)e;
        carved = true;
    }
    const dim3 grid((unsigned)((n_seg + AP_TILE - 1) / AP_TILE), (unsigned)bl);  // a CTA a tile
    attr_tile_kernel<<<grid, AP_THREADS, 0, (cudaStream_t)stream>>>(descs, cond, n_seg, al, arow0,
                                                                    out);
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
