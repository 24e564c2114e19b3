// The masked top-k by an int32 key, ties to the lower index, over one
// or many rows: the device code of K2 (select.cu, one row) and of B5b
// (multiquery.cu, Q rows on gridDim.y), so both keep one tie rule and
// one pair of routes.
//
// Each row element becomes one 64-bit composite key
//     (u32(key ^ 0x80000000) << 32) | (0xFFFFFFFF - idx)
// with masked elements at key -2^31. All composites of a row are
// distinct, and their descending order is exactly lax.top_k's: larger
// key first, equal keys by lower index, masked elements last in index
// order. The first k are emitted as the packed row [idx(k) | count(k) |
// valid(k) | n_match]. The order is total, so the first k' slots of a
// k-select equal a k'-select (the prefix property the batched search
// relies on).
//
// Two routes, chosen by the wrapper from (n, k) alone
// (kernels.select_plan), each over `rows` rows of length n (mask and
// counts row-major with row stride n, the packed output with row stride
// 3k + 1; the key column is shared by every row: the trace start key of
// one staged block):
//   - tt_select_rows, the full sort: a bitonic sort of each row over its
//     power-of-two-padded length (pad composite 0 sorts after every real
//     element) in device memory, then an emit;
//   - tt_select_tiled_rows, two passes (select.cu's notes): a tile pass,
//     grid (tiles, rows), each CTA keeping its tile's top k_pad; a merge
//     pass, grid (rows), one CTA a row folding its row's candidates.
// Each launch adds one to the caller's launch slot.
#pragma once

#include "common.cuh"

typedef unsigned long long u64;
#define TILE 2048

__global__ void select_keys_kernel(const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ key, int n, int n_pad,
                                   u64* __restrict__ comp, int32_t* __restrict__ out,
                                   int out_stride, int k) {
    const long long row = blockIdx.y;
    mask += row * n;
    comp += row * n_pad;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    int hit = 0;
    if (i < n_pad) {
        u64 c = 0;
        if (i < n) {
            hit = mask[i] != 0;
            int kv = hit ? key[i] : PAD_I32;
            c = ((u64)((uint32_t)kv ^ 0x80000000u) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)i);
        }
        comp[i] = c;
    }
    // one atomic per warp for the match count
    unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
    if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(out + row * out_stride + 3 * k, __popc(ballot));
}

// one compare-exchange pass of the bitonic network over device memory
// (strides >= TILE)
__global__ void bitonic_global_kernel(u64* __restrict__ a, int n_pad, int j, int kk) {
    a += (long long)blockIdx.y * n_pad;
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_pad / 2) return;
    int i = (t / j) * 2 * j + (t % j);
    int l = i + j;
    bool desc = (i & kk) == 0;
    u64 x = a[i], y = a[l];
    if ((x < y) == desc) {
        a[i] = y;
        a[l] = x;
    }
}

// every pass with stride < TILE for the merge sizes kk in [kk_lo, kk_hi],
// inside one TILE-element tile in shared memory (TILE/2 threads)
__global__ void bitonic_tile_kernel(u64* __restrict__ a, int n_pad, int kk_lo, int kk_hi) {
    __shared__ u64 s[TILE];
    a += (long long)blockIdx.y * n_pad;
    int base = blockIdx.x * TILE;
    for (int x = threadIdx.x; x < TILE; x += blockDim.x) s[x] = a[base + x];
    __syncthreads();
    int t = threadIdx.x;
    for (int kk = kk_lo; kk <= kk_hi; kk <<= 1) {
        for (int j = min(kk >> 1, TILE >> 1); j > 0; j >>= 1) {
            int i = (t / j) * 2 * j + (t % j);
            int l = i + j;
            bool desc = ((base + i) & kk) == 0;
            u64 x = s[i], y = s[l];
            if ((x < y) == desc) {
                s[i] = y;
                s[l] = x;
            }
            __syncthreads();
        }
    }
    for (int x = threadIdx.x; x < TILE; x += blockDim.x) a[base + x] = s[x];
}

__global__ void select_emit_kernel(const u64* __restrict__ comp, const uint8_t* __restrict__ mask,
                                   const int32_t* __restrict__ counts, int n, int n_pad, int k,
                                   int32_t* __restrict__ out, int out_stride) {
    const long long row = blockIdx.y;
    comp += row * n_pad;
    mask += row * n;
    counts += row * n;
    out += row * out_stride;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= k) return;
    uint32_t idx = 0xFFFFFFFFu - (uint32_t)(comp[i] & 0xFFFFFFFFull);
    out[i] = (int32_t)idx;
    out[k + i] = counts[idx];
    out[2 * k + i] = mask[idx] != 0;
}

// rows x (mask, counts) of length n -> rows x [idx(k)|count(k)|valid(k)|n_match].
// n_pad: power of two >= max(n, TILE); comp: rows * n_pad scratch;
// out: rows * (3k+1). Each launch adds one to launch slot `slot`.
static int tt_select_rows(const uint8_t* mask, const int32_t* key, const int32_t* counts, int n,
                          int rows, int k, u64* comp, int n_pad, int32_t* out, cudaStream_t st,
                          int slot) {
    if (n_pad < TILE || (n_pad & (n_pad - 1)) || n_pad < n || k < 1 || k > n || rows < 1 ||
        rows > 65535)
        return (int)cudaErrorInvalidValue;
    int stride = 3 * k + 1;
    cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)rows * stride, st);
    if (e != cudaSuccess) return (int)e;
    select_keys_kernel<<<dim3(tt_blocks(n_pad, 256), rows), 256, 0, st>>>(mask, key, n, n_pad, comp,
                                                                         out, stride, k);
    TT_LAUNCHED_SLOT(slot);
    int tiles = n_pad / TILE;
    bitonic_tile_kernel<<<dim3(tiles, rows), TILE / 2, 0, st>>>(comp, n_pad, 2, TILE);
    TT_LAUNCHED_SLOT(slot);
    for (int kk = 2 * TILE; kk <= n_pad; kk <<= 1) {
        for (int j = kk >> 1; j >= TILE; j >>= 1) {
            bitonic_global_kernel<<<dim3(tt_blocks(n_pad / 2, 256), rows), 256, 0, st>>>(comp, n_pad,
                                                                                         j, kk);
            TT_LAUNCHED_SLOT(slot);
        }
        bitonic_tile_kernel<<<dim3(tiles, rows), TILE / 2, 0, st>>>(comp, n_pad, kk, kk);
        TT_LAUNCHED_SLOT(slot);
    }
    select_emit_kernel<<<dim3(tt_blocks(k, 256), rows), 256, 0, st>>>(comp, mask, counts, n, n_pad,
                                                                     k, out, stride);
    TT_LAUNCHED_SLOT(slot);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- two passes
#define SEL_THREADS 1024
#define SEL_MAX_SMEM (128 * 1024)  // the largest tile or merge buffer: 16,384 composites

// position of pair q's lower element in a compare-exchange pass of stride j
__device__ __forceinline__ int sel_lower(int q, int j) {
    return ((q & ~(j - 1)) << 1) + (q & (j - 1));
}

// The barrier after a compare-exchange pass of stride j, before one of
// stride next (0: no pass follows). Where both strides are at most 32, a
// warp's 32 consecutive pairs q of both passes lie in the same aligned
// 64 composites (or whole runs of at most 64), so each warp reads only
// what it wrote itself and __syncwarp orders it; a wider stride crosses
// warps and takes the CTA's barrier.
__device__ __forceinline__ void sel_barrier(int j, int next) {
    if (j <= 32 && next > 0 && next <= 32)
        __syncwarp();
    else
        __syncthreads();
}

// Sort every run of K = 2^lg_k composites of s[0, len) descending: the
// bitonic network, with the last merge size made descending for all runs.
__device__ void sel_sort_runs(u64* s, int len, int lg_k) {
    const int K = 1 << lg_k;
    for (int kk = 2; kk <= K; kk <<= 1) {
        for (int j = kk >> 1; j > 0; j >>= 1) {
            for (int q = threadIdx.x; q < (len >> 1); q += blockDim.x) {
                int i = sel_lower(q, j), l = i + j;
                bool desc = kk == K || (i & kk) == 0;
                u64 x = s[i], y = s[l];
                if ((x < y) == desc) {
                    s[i] = y;
                    s[l] = x;
                }
            }
            sel_barrier(j, j > 1 ? j >> 1 : (kk < K ? kk : 0));
        }
    }
}

// s holds `runs` (a power of two) runs of K = 2^lg_k composites, each
// sorted descending, at s[r K, (r + 1) K). Leaves the top K of their
// union sorted descending in s[0, K). Each round pairs live run A with
// the run B half a stride away and keeps max(A[p], B[K-1-p]) in A's
// place: the upper K of A and B, a bitonic sequence, which K's bitonic
// merge then sorts descending. Live runs sit at run index multiples of
// 2^t after round t, so every thread reads and writes in place.
__device__ void sel_tournament(u64* s, int runs, int lg_k) {
    const int K = 1 << lg_k, H = K >> 1;
    for (int t = 1; (1 << t) <= runs; ++t) {
        const int live = runs >> t;
        for (int q = threadIdx.x; q < (live << lg_k); q += blockDim.x) {
            int r = q >> lg_k, p = q & (K - 1);
            int a = ((r << t) << lg_k) + p;
            int b = (((r << t) + (1 << (t - 1))) << lg_k) + (K - 1 - p);
            u64 x = s[a], y = s[b];
            if (y > x) s[a] = y;
        }
        __syncthreads();
        for (int j = H; j > 0; j >>= 1) {
            for (int q = threadIdx.x; q < live * H; q += blockDim.x) {
                int r = q >> (lg_k - 1), i = ((r << t) << lg_k) + sel_lower(q & (H - 1), j);
                int l = i + j;
                u64 x = s[i], y = s[l];
                if (x < y) {
                    s[i] = y;
                    s[l] = x;
                }
            }
            sel_barrier(j, j >> 1);
        }
    }
}

// Pass 1: CTA (x, r) takes tile x of `tile` elements (a power of two, a
// multiple of SEL_THREADS, at least 2 K) of row r; elements past n are
// the pad composite 0. Row r's candidates and tile counts follow row r -
// 1's: gridDim.x runs of K, gridDim.x words.
__global__ void __launch_bounds__(SEL_THREADS)
    select_tile_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ key, int n,
                       int tile, int lg_k, u64* __restrict__ cand, int32_t* __restrict__ tcount) {
    extern __shared__ u64 s[];
    const long long row = blockIdx.y;
    mask += row * n;
    cand += (row * gridDim.x) << lg_k;
    tcount += row * gridDim.x;
    const long long base = (long long)blockIdx.x * tile;
    int hits = 0;
    for (int x = threadIdx.x; x < tile; x += blockDim.x) {
        long long i = base + x;
        u64 c = 0;
        int hit = 0;
        if (i < n) {
            hit = mask[i] != 0;
            int kv = hit ? key[i] : PAD_I32;
            c = ((u64)((uint32_t)kv ^ 0x80000000u) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)i);
        }
        s[x] = c;
        hits += __syncthreads_count(hit);  // every thread takes the same trips
    }
    if (threadIdx.x == 0) tcount[blockIdx.x] = hits;
    sel_sort_runs(s, tile, lg_k);
    sel_tournament(s, tile >> lg_k, lg_k);
    u64* dst = cand + ((long long)blockIdx.x << lg_k);
    for (int p = threadIdx.x; p < (1 << lg_k); p += blockDim.x) dst[p] = s[p];
}

// Pass 2, one CTA a row (blockIdx.x): the running top K in s[0, K); each
// chunk fills the other runs of the buffer (`buf` composites, at least 2
// K) with the row's next candidate runs, pads the rest to a power of two
// with 0, and folds.
__global__ void __launch_bounds__(SEL_THREADS)
    select_merge_kernel(const u64* __restrict__ cand, const int32_t* __restrict__ tcount,
                        int tiles, int lg_k, int buf, const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ counts, int n, int k,
                        int32_t* __restrict__ out) {
    extern __shared__ u64 s[];
    __shared__ int n_match;
    const long long row = blockIdx.x;
    cand += (row * tiles) << lg_k;
    tcount += row * tiles;
    mask += row * n;
    counts += row * n;
    out += row * (3 * k + 1);
    const int per = buf >> lg_k;
    if (threadIdx.x == 0) n_match = 0;
    for (int next = 0, slot0 = 0; next < tiles; slot0 = 1) {
        int take = min(per - slot0, tiles - next), runs = 1;
        while (runs < slot0 + take) runs <<= 1;
        const u64* src = cand + ((long long)next << lg_k);
        const int have = take << lg_k;
        u64* dst = s + (slot0 << lg_k);
        for (int x = threadIdx.x; x < ((runs - slot0) << lg_k); x += blockDim.x)
            dst[x] = x < have ? src[x] : 0ull;
        __syncthreads();
        sel_tournament(s, runs, lg_k);
        __syncthreads();
        next += take;
    }
    int c = 0;
    for (int x = threadIdx.x; x < tiles; x += blockDim.x) c += tcount[x];
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xFFFFFFFFu, c, o);
    if ((threadIdx.x & 31) == 0 && c) atomicAdd(&n_match, c);
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
        uint32_t idx = 0xFFFFFFFFu - (uint32_t)(s[i] & 0xFFFFFFFFull);
        out[i] = (int32_t)idx;
        out[k + i] = counts[idx];
        out[2 * k + i] = mask[idx] != 0;
    }
    if (threadIdx.x == 0) out[3 * k] = n_match;
}

// Lift both kernels' dynamic shared memory limit to SEL_MAX_SMEM, once
// per device.
static int sel_smem_limit() {
    static std::atomic<unsigned long long> done{0};
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const unsigned long long bit = 1ull << (dev & 63);
    if (done.load(std::memory_order_relaxed) & bit) return 0;
    e = cudaFuncSetAttribute(select_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SEL_MAX_SMEM);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(select_merge_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SEL_MAX_SMEM);
    if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
    return (int)e;
}

static bool sel_pow2(long long x) { return x > 0 && (x & (x - 1)) == 0; }

// The two-pass route over `rows` rows. k_pad = 2^lg_k >= k; tile and
// buf as the kernels say; tiles = ceil(n / tile); cand: rows * tiles *
// k_pad words; tcount: rows * tiles words; out: rows * (3k+1).
static int tt_select_tiled_rows(const uint8_t* mask, const int32_t* key, const int32_t* counts,
                                int n, int rows, int k, int lg_k, int tile, int tiles, int buf,
                                u64* cand, int32_t* tcount, int32_t* out, cudaStream_t st,
                                int slot) {
    if (lg_k < 0 || lg_k > 13 || k < 1 || k > n || k > (1 << lg_k) || !sel_pow2(tile) ||
        tile % SEL_THREADS || tile < (2 << lg_k) || !sel_pow2(buf) || buf < (2 << lg_k) ||
        (long long)tile * 8 > SEL_MAX_SMEM || (long long)buf * 8 > SEL_MAX_SMEM ||
        tiles != (int)(((long long)n + tile - 1) / tile) || rows < 1 || rows > 65535)
        return (int)cudaErrorInvalidValue;
    int err = sel_smem_limit();
    if (err) return err;
    select_tile_kernel<<<dim3(tiles, rows), SEL_THREADS, tile * sizeof(u64), st>>>(
        mask, key, n, tile, lg_k, cand, tcount);
    TT_LAUNCHED_SLOT(slot);
    if ((err = (int)cudaGetLastError())) return err;
    select_merge_kernel<<<rows, SEL_THREADS, buf * sizeof(u64), st>>>(
        cand, tcount, tiles, lg_k, buf, mask, counts, n, k, out);
    TT_LAUNCHED_SLOT(slot);
    return (int)cudaGetLastError();
}
