// B8a/B8b: the metrics-generator's segmented reduces.
//
// Replaces the two jitted programs of tempo_tpu/ops/reduce.py:
//   B8a :23 _reduce_kernel       per series: call count, f32 latency sum,
//                                histogram over searchsorted(edges, dur)
//   B8b :63 _edge_reduce_kernel  per service-graph edge: count, failed
//                                count, client and server f32 sums,
//                                client and server histograms
// Semantics kept from the JAX programs: a row counts only when
// i < n_valid; an id outside [0, n_ids) is dropped from every output
// (segment_sum's FILL_OR_DROP); the bucket is searchsorted(..., 'left')
// in f32, written as the count of edges e with !(v <= e), so a value
// equal to an edge falls in that edge's bucket (Prometheus `le`) and NaN
// in the last one, as numpy sorts it.
//
// Bound: bytes. A fold reads 8 B a row (B8b: 16 B) and writes its output
// table once; for a live registry (2^18 series x 17 words) the table,
// not the window, is most of the bytes. The f32 atomics add in an order
// that changes from run to run: counts and histograms are exact, sums
// equal the plain version's within f32 rounding (exactly on dyadic
// durations).
//
// B8a writes one packed int32 table (kernels.span_views): row s = [calls,
// f32 sum bits, hist (nb)], nb + 2 words a series, so the first n rows
// are one contiguous download. One route: one memset of the table, then
// span_reduce_kernel, a thread a row with three atomicAdds into its
// series' row. A scan-tile route like B8b's (a CTA owning up to 1,024
// ids in shared memory, streaming every row's id, writing its rows once
// with no memset) lost to it or tied in device time at every window and
// table size measured: the memset lands in L2, which holds the table,
// and costs less than the tiles' id reads (PERF.md).
//
// B8b writes its six outputs into one packed int32 buffer (kernels.
// edge_views): counts | fcounts | csum | ssum (n_ids each) | chist |
// shist (n_ids x nb each). Two routes, chosen before launch by
// kernels.edge_plan on (n_valid, n_ids, nb):
//   tile    edge_tile_kernel: a CTA owns `per` consecutive edge ids, zeroes
//           their 4 + 2 nb cells in shared memory, streams every row's id
//           and folds the rows in its range with shared-memory atomics,
//           then writes its range once, coalesced: one launch, no memset,
//           no device-memory atomic, each output word written once. Every
//           CTA reads every id (4 B a row a CTA, from L2), so it is taken
//           while CTAs x n_valid stays small.
//   atomic  one memset of the packed buffer, then edge_reduce_kernel.
#include "common.cuh"

#define RD_MAX_EDGES 256  // kernels.py REDUCE_MAX_EDGES

__device__ __forceinline__ int rd_bucket(float v, const float* e, int ne) {
    int b = 0;
    for (int j = 0; j < ne; ++j) b += !(v <= e[j]);
    return b;
}

// B8a: the packed (n_ids, ne + 3) table, zeroed first
__global__ void span_reduce_kernel(const int32_t* __restrict__ sid, const float* __restrict__ dur,
                                   int n_valid, const float* __restrict__ edges, int ne, int n_ids,
                                   int32_t* __restrict__ out) {
    __shared__ float e[RD_MAX_EDGES];
    for (int j = threadIdx.x; j < ne; j += blockDim.x) e[j] = edges[j];
    __syncthreads();
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_valid) return;
    int s = sid[i];
    if (s < 0 || s >= n_ids) return;
    float v = dur[i];
    int32_t* row = out + (long long)s * (ne + 3);
    atomicAdd(row, 1);
    atomicAdd((float*)(row + 1), v);
    atomicAdd(row + 2 + rd_bucket(v, e, ne), 1);
}

__global__ void edge_reduce_kernel(const int32_t* __restrict__ eid, const float* __restrict__ cdur,
                                   const float* __restrict__ sdur,
                                   const int32_t* __restrict__ failed, int n_valid,
                                   const float* __restrict__ edges, int ne, int n_ids,
                                   int32_t* __restrict__ counts, int32_t* __restrict__ fcounts,
                                   float* __restrict__ csum, float* __restrict__ ssum,
                                   int32_t* __restrict__ chist, int32_t* __restrict__ shist) {
    __shared__ float e[RD_MAX_EDGES];
    for (int j = threadIdx.x; j < ne; j += blockDim.x) e[j] = edges[j];
    __syncthreads();
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_valid) return;
    int s = eid[i];
    if (s < 0 || s >= n_ids) return;
    float c = cdur[i], v = sdur[i];
    long long row = (long long)s * (ne + 1);
    atomicAdd(&counts[s], 1);
    int f = failed[i];
    if (f) atomicAdd(&fcounts[s], f);
    atomicAdd(&csum[s], c);
    atomicAdd(&ssum[s], v);
    atomicAdd(&chist[row + rd_bucket(c, e, ne)], 1);
    atomicAdd(&shist[row + rd_bucket(v, e, ne)], 1);
}

__global__ void edge_tile_kernel(const int32_t* __restrict__ eid, const float* __restrict__ cdur,
                                 const float* __restrict__ sdur,
                                 const int32_t* __restrict__ failed, int n_valid,
                                 const float* __restrict__ edges, int ne, int n_ids, int per,
                                 int32_t* __restrict__ out) {
    extern __shared__ int32_t rd_sm[];
    const int nb = ne + 1, lo = blockIdx.x * per, m = min(per, n_ids - lo);
    int32_t* cnt = rd_sm;
    int32_t* fcnt = cnt + per;
    float* cs = (float*)(fcnt + per);
    float* ss = cs + per;
    int32_t* ch = (int32_t*)(ss + per);
    int32_t* sh = ch + per * nb;
    float* e = (float*)(sh + per * nb);
    for (int j = threadIdx.x; j < ne; j += blockDim.x) e[j] = edges[j];
    for (int j = threadIdx.x; j < per * (4 + 2 * nb); j += blockDim.x) rd_sm[j] = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n_valid; i += blockDim.x) {
        int s = eid[i];
        if (s < lo || s >= lo + m) continue;
        int k = s - lo, f = failed[i];
        float c = cdur[i], v = sdur[i];
        atomicAdd(&cnt[k], 1);
        if (f) atomicAdd(&fcnt[k], f);
        atomicAdd(&cs[k], c);
        atomicAdd(&ss[k], v);
        atomicAdd(&ch[k * nb + rd_bucket(c, e, ne)], 1);
        atomicAdd(&sh[k * nb + rd_bucket(v, e, ne)], 1);
    }
    __syncthreads();
    const long long n = n_ids, cells = n * nb;
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
        out[lo + j] = cnt[j];
        out[n + lo + j] = fcnt[j];
        out[2 * n + lo + j] = __float_as_int(cs[j]);
        out[3 * n + lo + j] = __float_as_int(ss[j]);
    }
    for (int j = threadIdx.x; j < m * nb; j += blockDim.x) {
        out[4 * n + (long long)lo * nb + j] = ch[j];
        out[4 * n + cells + (long long)lo * nb + j] = sh[j];
    }
}

static int rd_zero(void* p, long long words, cudaStream_t st) {
    return (int)cudaMemsetAsync(p, 0, (size_t)words * 4, st);
}

// sid, dur: (n,) with n >= n_valid; edges: (ne,) f32, ne <= RD_MAX_EDGES;
// out: the packed (n_ids, ne + 3) table, zeroed here, then folded
TT_EXPORT int tt_span_reduce(const int32_t* sid, const float* dur, int n_valid,
                             const float* edges, int ne, int n_ids, int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (n_valid < 0 || n_ids < 1 || ne < 0 || ne > RD_MAX_EDGES) return (int)cudaErrorInvalidValue;
    int err = rd_zero(out, (long long)n_ids * (ne + 3), st);
    if (err) return err;
    span_reduce_kernel<<<tt_blocks(n_valid, 256), 256, 0, st>>>(sid, dur, n_valid, edges, ne,
                                                                 n_ids, out);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

// eid, cdur, sdur, failed: (n,) with n >= n_valid; out: the packed
// n_ids x (4 + 2 (ne + 1)) words. tiled: edge_tile_kernel with `per` ids
// a CTA and `smem` bytes of shared memory; else a memset, then the
// atomic fold.
TT_EXPORT int tt_edge_reduce(const int32_t* eid, const float* cdur, const float* sdur,
                             const int32_t* failed, int n_valid, const float* edges, int ne,
                             int n_ids, int tiled, int per, int smem, int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const long long n = n_ids, cells = n * (ne + 1);
    if (tiled) {
        edge_tile_kernel<<<tt_blocks(n_ids, per), 256, smem, st>>>(
            eid, cdur, sdur, failed, n_valid, edges, ne, n_ids, per, out);
    } else {
        int err = rd_zero(out, 4 * n + 2 * cells, st);
        if (err) return err;
        edge_reduce_kernel<<<tt_blocks(n_valid, 256), 256, 0, st>>>(
            eid, cdur, sdur, failed, n_valid, edges, ne, n_ids, out, out + n, (float*)(out + 2 * n),
            (float*)(out + 3 * n), out + 4 * n, out + 4 * n + cells);
    }
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}
