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
//   M6 mask_pack (slot 1)  the lhs mask of a struct node 8 rows to a byte
//        before the sp all_gather, in jnp.packbits' big-endian order:
//        bit 7 of byte j is row 8j, any nonzero byte a 1 (`gather_mask`,
//        search.py:175-189). Its unpack is read inside K1's shard struct
//        pass (filter.cu tt_filter_struct_packed): no byte mask is
//        written after the collective. An sp axis of one rank gathers
//        nothing, so it packs nothing (parallel/search.py).
//   M7 search_partial (slot 2)  per (block, trace): the shard's matched
//        spans of each tracify slot and of their union (every valid row
//        when the tree has none), over the trace's offsets clipped to
//        the shard, or without trace.span_off by atomicAdd at the clamped
//        span.trace_sid (`seg_reduce`, search.py:272-290). Exact int32,
//        so any split sums (all_reduce SUM over sp) to the whole block's
//        counts.
//   M8 search_finish (slot 3)  the trace program over the summed counts:
//        a tracify leaf is count > 0, a trace condition compares its
//        block's trace column with that block's operands; trace_mask and
//        where(trace_mask, union count, 0) (`ev_trace`, search.py:
//        292-322).
//   M7 + M8 search_fused (slot 4)  both in one launch where the sp axis
//        is one rank (nothing to sum between them): M7's tile, then M8's
//        program on the tile's counts, which never reach device memory.
//
// Bound: bytes for all of them. M5 reads each attr row's key once (4 B),
// the vtype and value only of the rows whose key matches, each owner
// offset once and writes each count once; M6 moves 9/8 B a row; M7 reads
// each slot byte once (and the offsets or trace_sid) and writes the
// counts; M8 reads the counts and the trace columns once; the fused route
// reads what M7 reads and writes what M8 writes. M7's trace_sid route is
// a thread a span row, as first ported.
//
// M6's pack (mask_pack_kernel) is one launch over a grid sized to the
// card, a row of CTAs a mask row, a thread an output byte from one 8-byte
// read-only load folded by a multiply (pack8). A row of Sl % 8 == 0 bytes
// at a base and stride that are multiples of 8 (a mask slot's view, or a
// contiguous row) is always so aligned.
//
// M7's count (search_tile_kernel, its contract bit for bit
// `_search_partial_plain`, ops/meshsearch.py, for every row0, shard cut
// and offset row) is a CTA a tile of ST_TILE consecutive traces of one
// block, M5's pattern over slot bytes: the tile's offsets clipped to the
// shard (the int32 difference, as M5's), a CTA-wide vote on their
// monotony, then the window [c[0], c[n]) read once, a chunk of ST_CHUNK
// rows at a time, 16 bytes a load (a byte a row at an unaligned head or
// tail), every slot's bytes turned into a bit a row (their OR the
// union's) and a CTA-wide popcount prefix a stream; a trace's count is
// the prefix at its two offsets' difference. The slot list comes by value
// (the first ST_TR), and the slot count is a template argument (0-3; a
// tree of more walks each trace), so a tile keeps only its streams'
// registers. A tile whose offsets fall (no writer produces them) walks
// each trace's rows signed, as the first port did. M8
// (search_finish_kernel) takes 4 consecutive traces a thread, counts
// loaded and tm / cnt stored 4 at once, the program's operations and its
// trace conditions' indexes by value and those conditions' descriptor
// rows copied to shared memory once a CTA (a program of more than ST_PROG
// operations or ST_TC conditions copied whole to shared memory instead,
// its conditions read from the block's table), the grid at most 8 CTAs an
// SM. What bounds them on the card: M7's chain of two round trips a tile
// (the offsets, then the window), one wave of ST_MIN_CTAS CTAs an SM at
// phase 15's 640 tiles (4.30 µs of bytes, 6.6-6.8 µs measured); M8's
// launch and its one round trip (3.2-3.4 µs); the fused route drops M8's
// launch and the counts' 2.6 MB (7.0-7.2 µs against 9.8-10.1 for the two;
// NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// M5's count (attr_tile_kernel) is a CTA a tile of AP_TILE consecutive
// owners of one block. Its contract: out[b, o] = E(hi) - E(lo) with lo =
// clamp(off[o] - arow0, 0, al), hi = clamp(off[o + 1] - arow0, 0, al)
// (the int32 difference, which wraps, as the reference's) and E(x) the
// shard's matching rows below x -- the reference's ecs[hi] - ecs[lo],
// negative on a falling offset, bit for bit `_attr_partial_plain`
// (ops/meshsearch.py) for every arow0, shard cut, leaf op and offset row.
// The CTA reads the block's descriptor once into shared memory and the
// tile's n + 1 offsets coalesced (scalar loads: block b's offset row
// starts 4 b (n_seg + 1) bytes into the column, not 16-byte aligned),
// clipped. A CTA-wide vote asks whether
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

// clamp(off - arow0, 0, al) of the reference's int32 difference, which wraps
__device__ __forceinline__ int clip_off(int32_t off, int arow0, int al) {
    const int x = (int)((unsigned)off - (unsigned)arow0);
    return x < 0 ? 0 : (x > al ? al : x);
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

// the 8 bytes of x (byte k the row 8j + k) to one byte, row 8j + k at bit
// 7 - k, any nonzero byte a 1: bit 7 of a byte is set where the byte is
// nonzero (the low 7 bits plus 0x7F carry into bit 7, never out of the
// byte), shifted to bit 0; the multiply by 0x8040201008040201 moves byte
// k's bit to bit 63 - k, where no two of the 64 partial products meet
__device__ __forceinline__ unsigned pack8(unsigned long long x) {
    x = (((x & 0x7F7F7F7F7F7F7F7FULL) + 0x7F7F7F7F7F7F7F7FULL) | x) >> 7;
    x &= 0x0101010101010101ULL;
    return (unsigned)((x * 0x8040201008040201ULL) >> 56);
}

// the CTAs of grid row blockIdx.y walk mask row blockIdx.y, a thread a
// packed byte from one 8-byte read-only load
__global__ void mask_pack_kernel(const uint8_t* __restrict__ in, long long stride, int nbytes,
                                 uint8_t* __restrict__ out) {
    const uint2* row = reinterpret_cast<const uint2*>(in + blockIdx.y * stride);
    uint8_t* o = out + (long long)blockIdx.y * nbytes;
    for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < nbytes; j += gridDim.x * blockDim.x) {
        const uint2 v = __ldg(row + j);
        o[j] = (uint8_t)pack8(((unsigned long long)v.y << 32) | v.x);
    }
}

// the union of the tracify slots at row s (every valid row without one)
__device__ __forceinline__ bool union_at(const uint8_t* sb, const int32_t* tslots, int n_tr,
                                         int sl, int s, bool valid) {
    if (n_tr == 0) return valid;
    for (int i = 0; i < n_tr; ++i)
        if (sb[(long long)tslots[i] * sl + s]) return true;
    return false;
}

#define ST_THREADS 128
#define ST_OWN 4                             // traces a thread
#define ST_TILE (ST_THREADS * ST_OWN)        // traces a CTA
#define ST_VEC 8                             // 16-byte loads a thread a chunk a slot
#define ST_CHUNK (ST_THREADS * ST_VEC * 16)  // rows a chunk
#define ST_WORDS (ST_CHUNK / 32)             // bit words a chunk a stream
#define ST_WPT (ST_WORDS / ST_THREADS)       // words a thread in the prefix
#define ST_STREAMS 4                         // streams a tile counts: up to 3 slots and their union
#define ST_TR 32                             // tracify slots by value (the fused route's bits)
#define ST_PROG 64                           // trace program operations by value
#define ST_TC 16                             // trace conditions' descriptor rows a CTA
#define ST_MIN_CTAS 5                        // CTAs an SM (registers): phase 15's 640 tiles in one wave
static_assert(ST_WORDS % ST_THREADS == 0 && ST_WORDS <= ST_TILE + 1, "a chunk's prefix fits s_p");
static_assert(ST_OWN == 4, "M8 and the fused route take 4 traces a thread");

// M7's and M8's launch, by value: the slot list, the trace program and
// its conditions' indexes ride in the parameter
struct TailArgs {
    const uint8_t* slots;
    const int32_t* span_off;
    const int32_t* n_spans;
    const int32_t* tslots;   // the slot list in the program buffer (slots past ST_TR)
    int32_t* counts;         // M7's output and M8's input, (bl, n_tr + 1, nt)
    const long long* descs;  // a descriptor table a block
    const int2* prog;        // the trace program in its buffer (read where it is long)
    uint8_t* tm;
    int32_t* cnt;
    int n_slots, sl, row0, nt, n_tr;
    int n_ops, n_tc;  // n_tc < 0: a long program, copied to shared memory a CTA
    int vec;          // slot rows 16-byte aligned: 16-byte loads
    int vec4;         // counts, tm and cnt 4 traces a vector
    int tslot[ST_TR];
    int tc[ST_TC];     // the program's trace conditions
    int2 op[ST_PROG];  // (code, arg); a C_COND's arg is its index in tc
};

__device__ __forceinline__ int tslot_at(const TailArgs& a, int i) {
    return i < ST_TR ? a.tslot[i] : __ldg(a.tslots + i);
}

// bit k: byte k of w is not 0
__device__ __forceinline__ unsigned nz4(unsigned w) {
    const unsigned y = (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
    return (y >> 7 | y >> 14 | y >> 21 | y >> 28) & 0xFu;
}

__device__ __forceinline__ unsigned bits16(uint4 v) {
    return nz4(v.x) | nz4(v.y) << 4 | nz4(v.z) << 8 | nz4(v.w) << 12;
}

// rows [r, r + 16) of one slot row p, the bytes outside [w0, w1) as 0:
// one 16-byte load where the rows lie inside and are aligned, else a
// byte a row (a window's unaligned head and tail), a loop that holds no
// more registers than one load
__device__ __forceinline__ uint4 rows16(const uint8_t* p, int r, int w0, int w1, bool vec) {
    if (vec && r >= w0 && r + 16 <= w1) return __ldg((const uint4*)(p + r));
    unsigned long long lo = 0, hi = 0;
#pragma unroll 1
    for (int k = max(w0 - r, 0); k < min(w1 - r, 16); ++k) {
        const unsigned long long x = __ldg(p + r + k);
        if (k < 8) lo |= x << (8 * k);
        else hi |= x << (8 * (k - 8));
    }
    return make_uint4((unsigned)lo, (unsigned)(lo >> 32), (unsigned)hi, (unsigned)(hi >> 32));
}

// a chunk of one slot row: load u of thread t holds rows g + 16 (u
// ST_THREADS + t), every load issued before any is used
__device__ __forceinline__ void chunk_rows(uint4 (&v)[ST_VEC], const uint8_t* p, int g, int w0,
                                           int w1, bool vec) {
#pragma unroll
    for (int u = 0; u < ST_VEC; ++u)
        v[u] = rows16(p, g + 16 * (u * ST_THREADS + (int)threadIdx.x), w0, w1, vec);
}

// one stream's bits into its chunk words: lanes 2l and 2l + 1 hold the
// two halves of word (u ST_THREADS + tid) / 2
__device__ __forceinline__ void put_words(unsigned* s_w, const unsigned (&h)[ST_VEC]) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int u = 0; u < ST_VEC; ++u) {
        const unsigned hi = __shfl_down_sync(0xFFFFFFFFu, h[u], 1);
        if (!(tid & 1)) s_w[(u * ST_THREADS + tid) >> 1] = h[u] | hi << 16;
    }
}

// a trace's count over its clipped offsets [lo, hi) walked a byte a row,
// negative where hi < lo (the reference's ecs[hi] - ecs[lo]): each slot's
// to slot(s, count); returns the union's (the valid rows' without a slot)
template <class Slot>
__device__ __forceinline__ int walk_trace(const TailArgs& a, const uint8_t* sb, int lo, int hi,
                                          int nvp, Slot slot) {
    if (a.n_tr == 0) return min(hi, nvp) - min(lo, nvp);
    const int x = min(lo, hi), e = max(lo, hi), sign = hi >= lo ? 1 : -1;
    int c0 = 0;
    for (int s = 0; s < a.n_tr; ++s) {
        const uint8_t* m = sb + (long long)tslot_at(a, s) * a.sl;
        int c = 0;
        for (int r = x; r < e; ++r) c += __ldg(m + r) != 0;
        if (s == 0) c0 = c;
        slot(s, sign * c);
    }
    if (a.n_tr == 1) return sign * c0;
    int u = 0;
    for (int r = x; r < e; ++r) {
        bool any = false;
        for (int s = 0; s < a.n_tr && !any; ++s)
            any = __ldg(sb + (long long)tslot_at(a, s) * a.sl + r) != 0;
        u += any;
    }
    return sign * u;
}

// block b's trace program: the operations by value and the conditions'
// descriptor rows copied to shared memory; a long program copied to
// shared memory, its conditions read from the block's table. The caller
// syncs before reading either.
__device__ __forceinline__ void trace_program(const TailArgs& a, int b, long long* s_d,
                                              int2* s_long, const int2*& prog,
                                              const long long*& dbase) {
    if (a.n_tc >= 0) {
        if (a.n_tc > 0) {
            const long long* desc = (const long long*)__ldg(a.descs + b);
            for (int j = threadIdx.x; j < a.n_tc * DW; j += blockDim.x)
                s_d[j] = desc[(long long)a.tc[j / DW] * DW + j % DW];
        }
        prog = a.op;
        dbase = s_d;
        return;
    }
    for (int j = threadIdx.x; j < a.n_ops; j += blockDim.x) s_long[j] = a.prog[j];
    prog = s_long;
    dbase = (const long long*)__ldg(a.descs + b);
}

// the postfix trace program on traces tr0 + q, q < nq: bit q of the
// result is trace_mask; leaf(arg) gives tracify slot arg's bits
template <class Leaf>
__device__ __forceinline__ unsigned run_program(const int2* prog, int n_ops,
                                                const long long* dbase, int tr0, int nq,
                                                Leaf leaf) {
    unsigned long long st[4] = {0ull, 0ull, 0ull, 0ull};
    for (int p = 0; p < n_ops; ++p) {
        const int2 o = prog[p];
        unsigned v = 0;  // bit q: trace tr0 + q
        if (o.x == C_AND || o.x == C_OR) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const unsigned y = st[q] & 1, x = (st[q] >> 1) & 1;
                st[q] >>= 2;
                v |= (o.x == C_AND ? x & y : x | y) << q;
            }
        } else if (o.x == C_TRACIFY) {
            v = leaf(o.y);
        } else if (o.x == C_COND) {
            const long long* d = dbase + (long long)o.y * DW;
            const void* col = (const void*)d[D_COL];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (q < nq && cmp_at(d, col, tr0 + q)) v |= 1u << q;
        } else {
            v = o.x == C_TRUE ? 0xFu : 0u;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) st[q] = st[q] << 1 | (v >> q & 1);
    }
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) m |= (unsigned)(st[q] & 1) << q;
    return m & ((1u << nq) - 1);
}

// tm and where(tm, union count, 0) of traces tr0 + q, q < nq, of block b
__device__ __forceinline__ void put_trace(const TailArgs& a, int b, int tr0, int nq, unsigned m,
                                          const int (&uc)[4]) {
    uint8_t* tm = a.tm + (long long)b * a.nt + tr0;
    int32_t* cnt = a.cnt + (long long)b * a.nt + tr0;
    if (a.vec4 && nq == 4) {
        *(uchar4*)tm = make_uchar4(m & 1, m >> 1 & 1, m >> 2 & 1, m >> 3 & 1);
        *(int4*)cnt = make_int4(m & 1 ? uc[0] : 0, m & 2 ? uc[1] : 0, m & 4 ? uc[2] : 0,
                                m & 8 ? uc[3] : 0);
        return;
    }
    for (int q = 0; q < nq; ++q) {
        tm[q] = m >> q & 1;
        cnt[q] = m >> q & 1 ? uc[q] : 0;
    }
}

// traces tr0 + q, q < nq, of one counts row; 0 past nq
__device__ __forceinline__ void counts4(const int32_t* p, int nq, bool vec4, int (&x)[4]) {
    if (vec4 && nq == 4) {
        const int4 v = __ldg((const int4*)p);
        x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
        return;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = q < nq ? __ldg(p + q) : 0;
}

// M7 (FUSED false) and the fused route (true): a CTA a tile of ST_TILE
// consecutive traces of block blockIdx.y. The tile's clipped offsets
// c[0..n] go to shared memory and a CTA-wide vote asks whether they are
// monotone. If they are (and the tree has at most 3 tracify slots), the
// tile's rows are one window [c[0], c[n]), read once in chunks of
// ST_CHUNK rows on a grid of 32-row words from c[0] & ~31: each slot's
// chunk 16 bytes a load (the window's first chunk of the first slot
// issued before the vote), turned into a bit a row, the slots' OR the
// union's bits; a CTA-wide exclusive prefix of each stream's word
// popcounts gives P(x) = the stream's rows in [c[0], x) for every offset
// in the chunk, and a trace's count is P(hi) - P(lo). A tile that is
// not monotone walks each trace's rows, signs kept. M7 writes the counts;
// the fused route runs M8's program on them, 4 traces a thread, and
// writes only tm and cnt.
template <bool FUSED, int NTR>
__global__ void __launch_bounds__(ST_THREADS, ST_MIN_CTAS)
    search_tile_kernel(const __grid_constant__ TailArgs a) {
    // NTR: the tree's tracify slots, 0-3 (the tile route), or -1 for
    // more (every tile walks); NS: the streams a tile counts, the slots
    // then their union (slot 0's with one slot; none without a slot)
    constexpr int NS = NTR < 0 ? 0 : (NTR <= 1 ? NTR : NTR + 1), NSA = NS > 0 ? NS : 1;
    static_assert(NS <= ST_STREAMS, "a tile counts at most ST_STREAMS streams");
    __shared__ int s_c[ST_TILE + 1];                // the tile's clipped offsets
    __shared__ unsigned s_w[NSA][ST_WORDS];         // a chunk's words a stream
    __shared__ int s_p[NSA][ST_TILE + 1];           // a chunk's prefix; then P at each offset
    __shared__ int s_wt[NSA][ST_THREADS / 32];      // the prefix's warp totals
    __shared__ long long s_d[FUSED ? ST_TC * DW : 1];
    extern __shared__ int2 s_long[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.y;
    const int t0 = blockIdx.x * ST_TILE, n = min(ST_TILE, a.nt - t0);
    const int n_tr = NTR < 0 ? a.n_tr : NTR, sl = a.sl;
    const int2* prog = nullptr;
    const long long* dbase = nullptr;
    if constexpr (FUSED) trace_program(a, b, s_d, s_long, prog, dbase);
    const int32_t* off = a.span_off + (long long)b * (a.nt + 1) + t0;
    const int w0 = clip_off(__ldg(off), a.row0, sl), w1 = clip_off(__ldg(off + n), a.row0, sl);
    int c[ST_OWN + 1];
#pragma unroll
    for (int m = 0; m <= ST_OWN; ++m) {
        const int i = tid + m * ST_THREADS;
        c[m] = i <= n ? clip_off(__ldg(off + i), a.row0, sl) : w1;
        if (i <= n) s_c[i] = c[m];
    }
    const uint8_t* sb = a.slots + (long long)b * a.n_slots * sl;
    const int nvp = min(max(__ldg(a.n_spans + b) - a.row0, 0), sl);
    const bool vec = a.vec;
    const int g0 = w0 & ~31;
    uint4 v[ST_VEC];
    if constexpr (NTR > 0) chunk_rows(v, sb + (long long)a.tslot[0] * sl, g0, w0, w1, vec);
    __syncthreads();
    bool mono = NTR >= 0;
#pragma unroll
    for (int m = 0; m < ST_OWN; ++m) {
        const int i = tid + m * ST_THREADS;
        if (i < n) mono &= c[m] <= s_c[i + 1];
    }
    int uc[4];
    unsigned tb[4];
    if (!__syncthreads_and(mono)) {
        if constexpr (!FUSED) {  // each trace's rows, coalesced writes a slot
            int32_t* ob = a.counts + (long long)b * (n_tr + 1) * a.nt + t0;
            for (int i = tid; i < n; i += ST_THREADS) {
                ob[(long long)n_tr * a.nt + i] = walk_trace(
                    a, sb, s_c[i], s_c[i + 1], nvp,
                    [&](int s, int x) { ob[(long long)s * a.nt + i] = x; });
            }
            return;
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int i = ST_OWN * tid + q;
                tb[q] = 0;
                uc[q] = i < n ? walk_trace(a, sb, s_c[i], s_c[i + 1], nvp,
                                           [&](int s, int x) { tb[q] |= (unsigned)(x > 0) << s; })
                              : 0;
            }
        }
    } else {
        unsigned done = 0;  // bit m: P[.][m] taken, in the chunk that holds c[m]
        int run[NSA], P[NSA][ST_OWN + 1];
#pragma unroll
        for (int s = 0; s < NSA; ++s) run[s] = 0;
        for (int g = g0; NS > 0 && g < w1; g += ST_CHUNK) {  // no slot: the union is arithmetic
            unsigned h[ST_VEC], uh[ST_VEC];
#pragma unroll
            for (int s = 0; s < (NTR > 0 ? NTR : 0); ++s) {
                if (g != g0 || s != 0) chunk_rows(v, sb + (long long)a.tslot[s] * sl, g, w0, w1, vec);
#pragma unroll
                for (int u = 0; u < ST_VEC; ++u) {
                    h[u] = bits16(v[u]);
                    uh[u] = s ? uh[u] | h[u] : h[u];
                }
                put_words(s_w[s], h);
            }
            if constexpr (NTR >= 2) put_words(s_w[NTR], uh);
            __syncthreads();
            int t[NSA], incl[NSA], tot[NSA];
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                t[s] = 0;
#pragma unroll
                for (int q = 0; q < ST_WPT; ++q) t[s] += __popc(s_w[s][tid * ST_WPT + q]);
                incl[s] = t[s];
#pragma unroll
                for (int sh = 1; sh < 32; sh <<= 1) {
                    const int y = __shfl_up_sync(0xFFFFFFFFu, incl[s], sh);
                    if (lane >= sh) incl[s] += y;
                }
                if (lane == 31) s_wt[s][warp] = incl[s];
            }
            __syncthreads();
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                int e = incl[s] - t[s];
                tot[s] = 0;
#pragma unroll
                for (int w = 0; w < ST_THREADS / 32; ++w) {
                    const int x = s_wt[s][w];
                    e += w < warp ? x : 0;
                    tot[s] += x;
                }
#pragma unroll
                for (int q = 0; q < ST_WPT; ++q) {
                    s_p[s][tid * ST_WPT + q] = e;
                    e += __popc(s_w[s][tid * ST_WPT + q]);
                }
            }
            __syncthreads();
#pragma unroll
            for (int m = 0; m <= ST_OWN; ++m) {  // each offset in the chunk that holds it
                const int pos = c[m] - g;
                if (!(done >> m & 1) && pos < ST_CHUNK) {
                    const int k = pos >> 5;
                    const unsigned low = (1u << (pos & 31)) - 1u;
#pragma unroll
                    for (int s = 0; s < NS; ++s)
                        P[s][m] = run[s] + s_p[s][k] + __popc(s_w[s][k] & low);
                    done |= 1u << m;
                }
            }
#pragma unroll
            for (int s = 0; s < NS; ++s) run[s] += tot[s];
            __syncthreads();  // the next chunk rewrites the words and the prefix
        }
#pragma unroll
        for (int m = 0; m <= ST_OWN; ++m) {  // c[m] == w1 past the last chunk: the total
            const int i = tid + m * ST_THREADS;
#pragma unroll
            for (int s = 0; s < NS; ++s)
                if (i <= n) s_p[s][i] = done >> m & 1 ? P[s][m] : run[s];
        }
        __syncthreads();
        // trace i's count of stream s; the union's, arithmetic without a slot
        auto count = [&](int s, int i) { return s_p[s][i + 1] - s_p[s][i]; };
        auto ucount = [&](int i) {
            if constexpr (NS > 0) return count(NS - 1, i);
            else return min(s_c[i + 1], nvp) - min(s_c[i], nvp);
        };
        if constexpr (!FUSED) {
            int32_t* ob = a.counts + (long long)b * (n_tr + 1) * a.nt + t0;
            for (int i = tid; i < n; i += ST_THREADS) {
#pragma unroll
                for (int s = 0; s < (NTR > 0 ? NTR : 0); ++s) ob[(long long)s * a.nt + i] = count(s, i);
                ob[(long long)n_tr * a.nt + i] = ucount(i);
            }
            return;
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int i = ST_OWN * tid + q;
                tb[q] = 0;
                uc[q] = 0;
                if (i >= n) continue;
#pragma unroll
                for (int s = 0; s < (NTR > 0 ? NTR : 0); ++s)
                    tb[q] |= (unsigned)(count(s, i) > 0) << s;
                uc[q] = ucount(i);
            }
        }
    }
    if constexpr (FUSED) {  // M8 on the tile's counts, 4 consecutive traces a thread
        const int i0 = ST_OWN * tid, nq = min(4, n - i0);
        if (nq <= 0) return;
        const unsigned m = run_program(prog, a.n_ops, dbase, t0 + i0, nq, [&](int arg) {
            return (tb[0] >> arg & 1) | (tb[1] >> arg & 1) << 1 | (tb[2] >> arg & 1) << 2 |
                   (tb[3] >> arg & 1) << 3;
        });
        put_trace(a, b, t0 + i0, nq, m, uc);
    }
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

// M8: the trace program over the summed counts of block blockIdx.y, 4
// consecutive traces a thread (a tracify leaf's counts and the union's
// loaded 4 at once), the grid sized to the card
__global__ void __launch_bounds__(ST_THREADS) search_finish_kernel(const __grid_constant__ TailArgs a) {
    __shared__ long long s_d[ST_TC * DW];
    extern __shared__ int2 s_long[];
    const int b = blockIdx.y, nt = a.nt;
    const int2* prog;
    const long long* dbase;
    trace_program(a, b, s_d, s_long, prog, dbase);
    __syncthreads();
    const int32_t* cb = a.counts + (long long)b * (a.n_tr + 1) * nt;
    const bool vec4 = a.vec4;
    for (int tr0 = ST_OWN * (blockIdx.x * ST_THREADS + threadIdx.x); tr0 < nt;
         tr0 += ST_OWN * ST_THREADS * gridDim.x) {
        const int nq = min(4, nt - tr0);
        int uc[4];
        counts4(cb + (long long)a.n_tr * nt + tr0, nq, vec4, uc);
        const unsigned m = run_program(prog, a.n_ops, dbase, tr0, nq, [&](int arg) {
            int x[4];
            counts4(cb + (long long)arg * nt + tr0, nq, vec4, x);
            return (unsigned)(x[0] > 0) | (x[1] > 0) << 1 | (x[2] > 0) << 2 | (x[3] > 0) << 3;
        });
        put_trace(a, b, tr0, nq, m, uc);
    }
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

#define MP_THREADS 256
static int mp_ctas = 0;  // the card-sized grid: resident CTAs a SM x SMs

// in and stride multiples of 8 (kernels.mask_pack checks, this checks
// again): every row's 8-byte loads aligned
TT_EXPORT int tt_mask_pack(const uint8_t* in, long long stride, int bl, int nbytes, uint8_t* out,
                           void* stream) {
    if (bl < 1 || bl > 65535 || nbytes < 1 || (((uintptr_t)in) & 7) || (stride & 7))
        return (int)cudaErrorInvalidValue;
    if (!mp_ctas) {
        int dev, sms, per_sm;
        cudaError_t e;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mask_pack_kernel,
                                                               MP_THREADS, 0)))
            return (int)e;
        mp_ctas = (per_sm > 1 ? per_sm : 1) * sms;
    }
    const int want = (nbytes + MP_THREADS - 1) / MP_THREADS;
    const int cap = mp_ctas / bl > 1 ? mp_ctas / bl : 1;  // the card's CTAs over the rows
    mask_pack_kernel<<<dim3(want < cap ? want : cap, bl), MP_THREADS, 0, (cudaStream_t)stream>>>(
        in, stride, nbytes, out);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}

static int st_sms = 0;  // the card's SMs: M8's grid

// the launch's common fields; the slot list by value (its first ST_TR)
static int tail_args(TailArgs& a, const uint8_t* slots, int n_slots, const int32_t* tslots,
                     const int32_t* tslots_host, int n_tr, const int32_t* span_off,
                     const int32_t* n_spans, int bl, int sl, int row0, int nt) {
    if (bl < 1 || bl > 65535 || n_tr < 0 || sl < 0 || nt < 0) return (int)cudaErrorInvalidValue;
    a.slots = slots;
    a.span_off = span_off;
    a.n_spans = n_spans;
    a.tslots = tslots;
    a.n_slots = n_slots;
    a.sl = sl;
    a.row0 = row0;
    a.nt = nt;
    a.n_tr = n_tr;
    a.vec = (uintptr_t)slots % 16 == 0 && sl % 16 == 0;
    for (int i = 0; i < n_tr && i < ST_TR; ++i) a.tslot[i] = tslots_host[i];
    return 0;
}

// the trace program (len int32, (code, arg) pairs) by value with its
// trace conditions' indexes, or, past ST_PROG operations or ST_TC
// conditions, read from its buffer; returns the dynamic shared memory a
// CTA needs (a long program's copy)
static size_t tail_program(TailArgs& a, const int32_t* prog, const int32_t* prog_host, int len,
                           const long long* descs, uint8_t* tm, int32_t* cnt) {
    a.descs = descs;
    a.prog = (const int2*)prog;
    a.tm = tm;
    a.cnt = cnt;
    a.n_ops = len / 2;
    a.n_tc = 0;
    bool fits = a.n_ops <= ST_PROG;
    for (int p = 0; p < a.n_ops && fits; ++p) {
        const int code = prog_host[2 * p], arg = prog_host[2 * p + 1];
        int j = 0;
        if (code == C_COND) {
            while (j < a.n_tc && a.tc[j] != arg) ++j;
            if (j == a.n_tc) {
                if (j == ST_TC) {
                    fits = false;
                    break;
                }
                a.tc[a.n_tc++] = arg;
            }
        }
        a.op[p] = make_int2(code, code == C_COND ? j : arg);
    }
    if (fits) return 0;
    a.n_tc = -1;
    return (size_t)a.n_ops * sizeof(int2);
}

// room for a long program's copy beside the kernel's static shared memory
template <typename K>
static int tail_smem(K kernel, size_t dyn) {
    if (!dyn) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)dyn);
}

template <int NTR>
static int tail_fused(const TailArgs& a, dim3 grid, size_t dyn, cudaStream_t st) {
    const int e = tail_smem(search_tile_kernel<true, NTR>, dyn);
    if (e) return e;
    search_tile_kernel<true, NTR><<<grid, ST_THREADS, dyn, st>>>(a);
    return 0;
}

static unsigned tail_tiles(int nt) { return (unsigned)tt_blocks(nt, ST_TILE); }

TT_EXPORT int tt_search_partial(const uint8_t* slots, int n_slots, const int32_t* tslots,
                                const int32_t* tslots_host, int n_tr, const int32_t* span_off,
                                const int32_t* tsid, const int32_t* n_spans, int bl, int sl,
                                int row0, int nt, int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (span_off) {
        TailArgs a = {};
        const int e = tail_args(a, slots, n_slots, tslots, tslots_host, n_tr, span_off, n_spans,
                                bl, sl, row0, nt);
        if (e) return e;
        a.counts = out;
        const dim3 grid(tail_tiles(nt), (unsigned)bl);
        switch (n_tr) {  // the tile route's slots are compile-time
            case 0: search_tile_kernel<false, 0><<<grid, ST_THREADS, 0, st>>>(a); break;
            case 1: search_tile_kernel<false, 1><<<grid, ST_THREADS, 0, st>>>(a); break;
            case 2: search_tile_kernel<false, 2><<<grid, ST_THREADS, 0, st>>>(a); break;
            case 3: search_tile_kernel<false, 3><<<grid, ST_THREADS, 0, st>>>(a); break;
            default: search_tile_kernel<false, -1><<<grid, ST_THREADS, 0, st>>>(a);
        }
    } else {
        size_t n = (size_t)bl * (n_tr + 1) * nt * sizeof(int32_t);
        cudaError_t e = cudaMemsetAsync(out, 0, n, st);
        if (e != cudaSuccess) return (int)e;
        search_partial_sid_kernel<<<tt_blocks((long long)bl * sl, 256), 256, 0, st>>>(
            slots, n_slots, tslots, n_tr, tsid, n_spans, bl, sl, row0, nt, out);
    }
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_search_finish(const int32_t* prog, const int32_t* prog_host, int len,
                               const long long* descs, const int32_t* counts, int n_tr, int bl,
                               int nt, uint8_t* tm, int32_t* cnt, void* stream) {
    if (bl < 1 || bl > 65535 || n_tr < 0 || nt < 0 || len < 0) return (int)cudaErrorInvalidValue;
    if (!st_sms) {
        int dev;
        cudaError_t e;
        if ((e = cudaGetDevice(&dev)) ||
            (e = cudaDeviceGetAttribute(&st_sms, cudaDevAttrMultiProcessorCount, dev)))
            return (int)e;
    }
    TailArgs a = {};
    a.counts = (int32_t*)counts;
    a.n_tr = n_tr;
    a.nt = nt;
    const size_t dyn = tail_program(a, prog, prog_host, len, descs, tm, cnt);
    a.vec4 = nt % 4 == 0 && (uintptr_t)counts % 16 == 0 && (uintptr_t)tm % 4 == 0 &&
             (uintptr_t)cnt % 16 == 0;
    int e = tail_smem(search_finish_kernel, dyn);
    if (e) return e;
    // a CTA a tile of ST_TILE traces of one block, at most 8 CTAs an SM
    // over all blocks; the rest by a stride
    unsigned x = tail_tiles(nt), cap = (unsigned)(8 * st_sms / bl > 1 ? 8 * st_sms / bl : 1);
    search_finish_kernel<<<dim3(x < cap ? x : cap, (unsigned)bl), ST_THREADS, dyn,
                           (cudaStream_t)stream>>>(a);
    TT_LAUNCHED_SLOT(3);
    return (int)cudaGetLastError();
}

TT_EXPORT int tt_search_fused(const uint8_t* slots, int n_slots, const int32_t* tslots,
                              const int32_t* tslots_host, int n_tr, const int32_t* span_off,
                              const int32_t* n_spans, int bl, int sl, int row0, int nt,
                              const int32_t* prog, const int32_t* prog_host, int len,
                              const long long* descs, uint8_t* tm, int32_t* cnt, void* stream) {
    if (n_tr > ST_TR || !span_off || len < 0) return (int)cudaErrorInvalidValue;
    TailArgs a = {};
    int e = tail_args(a, slots, n_slots, tslots, tslots_host, n_tr, span_off, n_spans, bl, sl,
                      row0, nt);
    if (e) return e;
    const size_t dyn = tail_program(a, prog, prog_host, len, descs, tm, cnt);
    a.vec4 = nt % 4 == 0 && (uintptr_t)tm % 4 == 0 && (uintptr_t)cnt % 16 == 0;
    const dim3 grid(tail_tiles(nt), (unsigned)bl);
    cudaStream_t st = (cudaStream_t)stream;
    switch (n_tr) {
        case 0: e = tail_fused<0>(a, grid, dyn, st); break;
        case 1: e = tail_fused<1>(a, grid, dyn, st); break;
        case 2: e = tail_fused<2>(a, grid, dyn, st); break;
        case 3: e = tail_fused<3>(a, grid, dyn, st); break;
        default: e = tail_fused<-1>(a, grid, dyn, st);
    }
    if (e) return e;
    TT_LAUNCHED_SLOT(4);
    return (int)cudaGetLastError();
}
