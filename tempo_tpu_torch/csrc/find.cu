// K3: batched trace-ID lookup -- a warp per (block, query), 32-ary search.
// M1: the sharded find's election, fused with K3's search (below).
//
// Replaces tempo_tpu/ops/find.py:68 `_lookup_blocks_kernel` (a vmap of
// `bisect_ids` over B sorted per-block indexes) and :64 `_lookup_kernel`,
// its B = 1 form.
//
// Contract. Block b's index is n_valid rows of 4 int32 lanes, sorted
// ascending by the signed lexicographic compare (`lex_less`; duplicates
// allowed), as the block writer writes it; its rows past n_valid (pad rows
// 2**31 - 1 in the port's caches, anything in a caller's stack) are never
// read on the search route. The reference's lockstep bisection with
// n_steps >= bit_length(n_valid) ends at the lower bound L of the query
// among the real rows, or past n_valid, where its result is -1 either way:
// so its result is L where L < n_valid and row L equals the query, else -1,
// and that is what the warp search returns. A (block, query) whose n_steps
// is below bit_length(n_valid), or whose n_valid lies outside [0, T], runs
// the reference's lockstep loop itself (clamped probe, floor mid) on one
// lane, so the result equals `_bisect_plain` at every n_steps.
//
// Bound: the launch and a chain of dependent loads, not bytes: the old
// kernel (a thread a (block, query)) ran n_steps = 16 dependent loads at
// T = 32,768. Here each step's 32 lanes probe 32 evenly spaced rows of
// [lo, hi) with read-only loads and a __ballot_sync of "row < query"
// narrows the range about 32x: 3 dependent steps at 32,768 rows (2 at
// 1,024), then the lane at the lower bound tests equality.
//
// Nothing is stacked or uploaded for a find: the launcher takes a host
// table of descriptors, one a block, (pointer, n_valid, T) of the block's
// own cached (T, 4) index, and passes FIND_BLOCKS of them and up to
// FIND_INLINE_Q queries by value in one __grid_constant__ parameter
// (about 1.6 KB of the 4 KB limit). More queries are read from the
// device (the caller's one upload); more blocks take a launch a chunk of
// FIND_BLOCKS. The stacked form (kernels.find_rows, the mesh bodies) runs
// the same kernel with descriptors over the stack's slices and n_valid
// read from the device.
#include "common.cuh"

#define FIND_BLOCKS 64    // descriptors a launch
#define FIND_INLINE_Q 32  // queries carried in the parameter
#define FIND_WARPS 4      // warps a CTA, a warp a (block, query)
#define ELECT_WARPS 16    // the election: warps a CTA (a query) at most
#define FULL_MASK 0xFFFFFFFFu

struct FindDesc {
    const int4* ids;  // the block's (T, 4) index
    int n_valid;      // its real rows (unused where FindArgs.nv_dev is set)
    int T;            // its rows, pad included: the lockstep probe's clamp
};

struct FindArgs {
    FindDesc d[FIND_BLOCKS];
    int4 q[FIND_INLINE_Q];  // the queries, where qdev is NULL
    const int4* qdev;       // (Q, 4) queries on the device, or NULL
    const int32_t* nv_dev;  // this chunk's n_valid on the device, or NULL
    int32_t* out;           // this chunk's (B, Q) rows (K3)
    long long* keys;        // Q packed keys (the election)
    int B, Q, n_steps;
    int gbase, fold;        // the election: this chunk's first global block; max into keys
};

__device__ __forceinline__ bool lex_less(const int4 a, const int4 q) {
    return a.x < q.x || (a.x == q.x && (a.y < q.y || (a.y == q.y && (a.z < q.z ||
           (a.z == q.z && a.w < q.w)))));
}

__device__ __forceinline__ bool lex_eq(const int4 a, const int4 q) {
    return a.x == q.x && a.y == q.y && a.z == q.z && a.w == q.w;
}

// the reference's bisect_ids for one (block, query), step for step
__device__ int find_lockstep(const int4* __restrict__ blk, int T, int nv, int n_steps,
                             const int4 q) {
    int lo = 0, hi = nv;
    for (int s = 0; s < n_steps; ++s) {
        const int mid = (int)((unsigned)lo + (unsigned)hi) >> 1;  // jnp's floor division
        const bool less = lex_less(__ldg(blk + tt_clamp(mid, 0, T - 1)), q);
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    return lo < nv && lex_eq(__ldg(blk + tt_clamp(lo, 0, T - 1)), q) ? lo : -1;
}

// The lower bound L of q among rows [0, nv) is kept in [lo, hi]: rows
// below lo are less than q, row hi (where hi < nv) is not. While 32 or
// more rows are open, lane j probes row lo + floor(j (hi - lo) / 32)
// (distinct rows, the first at lo); the c lanes whose rows are less
// form a prefix, so L lies after probe c - 1 and at or before probe c.
// Then lanes 0 .. hi - lo probe rows lo .. hi (those below nv), L is lo
// plus their count of "less", and lane L - lo holds row L.
__device__ int find_warp(const int4* __restrict__ blk, int nv, const int4 q, int lane) {
    int lo = 0, hi = nv;
    while (hi - lo >= 32) {
        const long long len = hi - lo;
        const bool less = lex_less(__ldg(blk + lo + (int)((lane * len) >> 5)), q);
        const int c = __popc(__ballot_sync(FULL_MASK, less));
        if (c == 0) {
            hi = lo;
            break;
        }
        if (c < 32) hi = lo + (int)((c * len) >> 5);
        lo += (int)(((c - 1) * len) >> 5) + 1;
    }
    const int p = lo + lane;
    bool less = false, eq = false;
    if (lane <= hi - lo && p < nv) {
        const int4 r = __ldg(blk + p);
        less = lex_less(r, q);
        eq = lex_eq(r, q);
    }
    const int c = __popc(__ballot_sync(FULL_MASK, less));  // <= hi - lo <= 31
    return __shfl_sync(FULL_MASK, eq, c) ? lo + c : -1;
}

__global__ void __launch_bounds__(FIND_WARPS * 32) find_kernel(const __grid_constant__ FindArgs a) {
    const int lane = threadIdx.x & 31;
    const long long w = (long long)blockIdx.x * FIND_WARPS + (threadIdx.x >> 5);
    if (w >= (long long)a.B * a.Q) return;  // a whole warp at once
    const int b = (int)(w / a.Q), qi = (int)(w - (long long)b * a.Q);
    const int4 q = a.qdev ? __ldg(a.qdev + qi) : a.q[qi];
    const FindDesc d = a.d[b];
    const int nv = a.nv_dev ? __ldg(a.nv_dev + b) : d.n_valid;
    const int bits = nv > 0 ? 32 - __clz(nv) : 0;
    if (nv < 0 || nv > d.T || a.n_steps < bits) {  // the same for the whole warp
        if (lane == 0) a.out[w] = find_lockstep(d.ids, d.T, nv, a.n_steps, q);
        return;
    }
    const int r = find_warp(d.ids, nv, q, lane);
    if (lane == 0) a.out[w] = r;
}

// The sharded find's election, fused with K3 (M1): one CTA a query. Its
// warps walk this launch's blocks (warp w takes blocks w, w + nw, ...)
// with the same search as find_kernel and keep the max of the packed key
// (int64(gbase + b) << 32) | uint32(row), -1 for a miss; the CTA's
// maximum is one 8-byte store a query. One max of that key elects the
// highest global block holding the id together with that block's row:
// what the reference's two pmax stages return
// (tempo_tpu/parallel/find.py:44-64), and a miss stays -1, which decodes
// to (-1, -1). A chunk after the first (fold) maxes its key into the
// previous chunk's, launched before it on the same stream.
__global__ void __launch_bounds__(ELECT_WARPS * 32) find_elect_kernel(const __grid_constant__ FindArgs a) {
    __shared__ long long s_key[ELECT_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int qi = blockIdx.x;
    const int4 q = a.qdev ? __ldg(a.qdev + qi) : a.q[qi];
    long long key = -1;
    for (int b = warp; b < a.B; b += nw) {  // b rises: a later hit is a higher block
        const FindDesc d = a.d[b];
        const int nv = a.nv_dev ? __ldg(a.nv_dev + b) : d.n_valid;
        const int bits = nv > 0 ? 32 - __clz(nv) : 0;
        int r = -1;
        if (nv < 0 || nv > d.T || a.n_steps < bits) {  // the same for the whole warp
            if (lane == 0) r = find_lockstep(d.ids, d.T, nv, a.n_steps, q);
        } else {
            r = find_warp(d.ids, nv, q, lane);
        }
        if (r >= 0) key = ((long long)(a.gbase + b) << 32) | (unsigned)r;
    }
    if (lane == 0) s_key[warp] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < nw; ++w) key = s_key[w] > key ? s_key[w] : key;
        if (a.fold) key = a.keys[qi] > key ? a.keys[qi] : key;
        a.keys[qi] = key;
    }
}

// The blocks: desc, a host table of B rows of 3 int64 (index pointer,
// n_valid, T); or, where desc is NULL, the B slices of a (B, T, 4) stack
// on the device. The queries: q_host, a host (Q, 4) table, where Q <=
// FIND_INLINE_Q; else q_dev, Q rows on the device. nv_dev: B n_valid on
// the device (the stacked form), or NULL to take the table's. K3 (keys
// NULL) writes out, (B, Q) rows on the device, a launch a chunk of
// FIND_BLOCKS blocks; the election (keys set) writes keys, Q packed keys
// on the device, the chunks folding into one key a query (one launch
// where B <= FIND_BLOCKS).
static int find_launches(const long long* desc, const int32_t* stack, int T, int B,
                         const int32_t* q_host, const int32_t* q_dev, int Q,
                         const int32_t* nv_dev, int n_steps, int32_t* out, long long* keys,
                         int base, cudaStream_t st) {
    if (B < 0 || Q < 0 || (!q_dev && (!q_host || Q > FIND_INLINE_Q)) ||
        (!desc && (!stack || !nv_dev || T < 1 || ((uintptr_t)stack & 15))) || base < 0)
        return (int)cudaErrorInvalidValue;
    FindArgs a;
    a.qdev = (const int4*)q_dev;
    if (!q_dev)
        for (int i = 0; i < Q; ++i)
            a.q[i] = make_int4(q_host[4 * i], q_host[4 * i + 1], q_host[4 * i + 2],
                               q_host[4 * i + 3]);
    a.Q = Q;
    a.n_steps = n_steps;
    a.keys = keys;
    for (int b0 = 0; b0 < B && Q > 0; b0 += FIND_BLOCKS) {
        a.B = B - b0 < FIND_BLOCKS ? B - b0 : FIND_BLOCKS;
        for (int b = 0; b < a.B; ++b) {
            if (!desc) {
                a.d[b] = FindDesc{(const int4*)stack + (long long)(b0 + b) * T, 0, T};
                continue;
            }
            const long long* r = desc + 3LL * (b0 + b);
            if (r[2] < 1 || r[2] > INT32_MAXV || (r[0] & 15)) return (int)cudaErrorInvalidValue;
            a.d[b] = FindDesc{(const int4*)r[0], (int)r[1], (int)r[2]};
        }
        a.nv_dev = nv_dev ? nv_dev + b0 : nullptr;
        if (keys) {
            a.gbase = base + b0;
            a.fold = b0 > 0;
            const int nw = a.B < ELECT_WARPS ? a.B : ELECT_WARPS;
            find_elect_kernel<<<Q, nw * 32, 0, st>>>(a);
            TT_LAUNCHED_SLOT(1);
        } else {
            a.out = out + (long long)b0 * Q;
            find_kernel<<<tt_blocks((long long)a.B * Q, FIND_WARPS), FIND_WARPS * 32, 0, st>>>(a);
            TT_LAUNCHED();
        }
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    return 0;
}

TT_EXPORT int tt_find(const long long* desc, const int32_t* stack, int T, int B,
                      const int32_t* q_host, const int32_t* q_dev, int Q, const int32_t* nv_dev,
                      int n_steps, int32_t* out, void* stream) {
    return find_launches(desc, stack, T, B, q_host, q_dev, Q, nv_dev, n_steps, out, nullptr, 0,
                         (cudaStream_t)stream);
}

// M1 with K3 (launch slot 1): keys, Q int64 on the device, for the
// global blocks base .. base + B - 1.
//
// Bound: K3's chain of dependent loads and the launch; the bytes are the
// probed rows, the queries and 8 B a query out.
TT_EXPORT int tt_find_elect(const long long* desc, const int32_t* stack, int T, int B,
                            const int32_t* q_host, const int32_t* q_dev, int Q,
                            const int32_t* nv_dev, int n_steps, int base, long long* keys,
                            void* stream) {
    if (!keys || B < 1) return (int)cudaErrorInvalidValue;
    return find_launches(desc, stack, T, B, q_host, q_dev, Q, nv_dev, n_steps, nullptr, keys, base,
                         (cudaStream_t)stream);
}
