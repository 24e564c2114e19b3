// K3: batched trace-ID lookup -- lockstep lexicographic bisection.
//
// Replaces tempo_tpu/ops/find.py:68 `_lookup_blocks_kernel` (a vmap of
// `bisect_ids` over B sorted per-block indexes). One thread per
// (block, query): the query's four int32 lanes sit in registers and the
// thread runs exactly n_steps bisection steps with the reference's
// signed lane compares (`_lex_less`, `_lex_eq`), including its clamped
// probe index, so out-of-range states resolve the same way.
//
// Bound: each thread touches n_steps + 1 index rows of 16 B; at the
// find path's shapes (a few queries, a few blocks) the launch itself
// dominates, which is why the wrapper stacks every candidate block into
// ONE launch.
#include "common.cuh"

__device__ __forceinline__ bool lex_less(const int4 a, const int q0, const int q1,
                                         const int q2, const int q3) {
    return a.x < q0 || (a.x == q0 && (a.y < q1 || (a.y == q1 && (a.z < q2 ||
           (a.z == q2 && a.w < q3)))));
}

__global__ void find_kernel(const int4* __restrict__ ids, int B, int T,
                            const int4* __restrict__ queries, int Q,
                            const int32_t* __restrict__ n_valid, int n_steps,
                            int32_t* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)B * Q) return;
    int b = (int)(t / Q), q = (int)(t % Q);
    const int4 qq = queries[q];
    const int4* blk = ids + (long long)b * T;
    int nv = n_valid[b];
    int lo = 0, hi = nv;
    for (int s = 0; s < n_steps; ++s) {
        int mid = (lo + hi) / 2;
        int4 m = blk[tt_clamp(mid, 0, T - 1)];
        bool less = lex_less(m, qq.x, qq.y, qq.z, qq.w);
        lo = less ? mid + 1 : lo;
        hi = less ? hi : mid;
    }
    int4 f = blk[tt_clamp(lo, 0, T - 1)];
    bool ok = lo < nv && f.x == qq.x && f.y == qq.y && f.z == qq.z && f.w == qq.w;
    out[t] = ok ? lo : -1;
}

TT_EXPORT int tt_find(const int32_t* ids, int B, int T, const int32_t* queries, int Q,
                      const int32_t* n_valid, int n_steps, int32_t* out, void* stream) {
    long long n = (long long)B * Q;
    find_kernel<<<tt_blocks(n, 128), 128, 0, (cudaStream_t)stream>>>(
        (const int4*)ids, B, T, (const int4*)queries, Q, n_valid, n_steps, out);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}

// M1: the election of the sharded find (parallel/find.py), run on K3's
// local (Bl, Q) rows of this rank's blocks, whose global ids are
// base .. base + Bl - 1. Replaces the per-shard arithmetic of
// tempo_tpu/parallel/find.py:47-68 (`make_sharded_find`'s `local`):
//   winner == NULL (stage 1): per query the highest global block with a
//     hit, or -1; the caller's all_reduce MAX elects the mesh's winner;
//   winner != NULL (stage 2): per query the row of the block equal to
//     winner[q] (-1 where this rank does not hold it); a second
//     all_reduce MAX hands every rank the winner's row.
// The two stages keep block and row apart: block * T + row overflows
// int32 (find.py:55). One thread per query walks the Bl rows.
//
// Bound: bytes -- the (Bl, Q) rows read once, Q words written; at the
// find path's shapes the launch itself dominates. Launch slot 1.
__global__ void find_elect_kernel(const int32_t* __restrict__ rows, int Bl, int Q, int base,
                                  const int32_t* __restrict__ winner, int32_t* __restrict__ out) {
    int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= Q) return;
    int best = -1;
    const int w = winner ? winner[q] : 0;
    for (int b = 0; b < Bl; ++b) {
        const int r = rows[(long long)b * Q + q];
        if (r < 0) continue;
        if (!winner) best = base + b;  // b rises: the last hit is the highest
        else if (base + b == w && r > best) best = r;
    }
    out[q] = best;
}

TT_EXPORT int tt_find_elect(const int32_t* rows, int Bl, int Q, int base, const int32_t* winner,
                            int32_t* out, void* stream) {
    if (Bl < 0 || Q < 1 || base < 0) return (int)cudaErrorInvalidValue;
    find_elect_kernel<<<tt_blocks(Q, 128), 128, 0, (cudaStream_t)stream>>>(rows, Bl, Q, base,
                                                                          winner, out);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}
