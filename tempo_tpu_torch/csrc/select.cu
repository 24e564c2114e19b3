// K2: masked top-k by an int32 key, ties to the lower index.
//
// Replaces tempo_tpu/ops/select.py:41 `_compiled_select` and :79
// `_compiled_select_multi` (`lax.top_k` over `where(mask, key, -2^31)`):
// the packed int32 row [idx(k) | count(k) | valid(k) | n_match], in the
// composite order of select.cuh (larger key first, equal keys by lower
// index, masked rows last in index order), so the first k' slots of a
// k-select equal a k'-select.
//
// Bound: bytes. The function needs the mask (1 B a row), the key of
// each masked row (4 B), counts at the k winners and the 3k + 1 output
// words: on chip_smoke.py's search shape (N = 327,680 rows, about 73 %
// of them masked, k = 64) 1.29 MB, 0.38 us at 3.35 TB/s; the two-pass
// route took 0.037 ms there, about 97x that (PERF.md). A full sort
// (select.cuh, tt_select) re-reads an 8 B composite a row in each of its
// log^2 passes over device memory: 47 launches and about 300 MB of
// scratch traffic at that shape.
//
// For k up to K_SMALL (kernels.select_plan) this file takes two passes:
//   1. tile pass, one CTA a tile of `tile` rows: the composites go
//      straight from mask and key into shared memory; the CTA counts its
//      matches into a per-tile word and keeps its tile's top k_pad
//      (k_pad = the power of two at or above k) by a bitonic top-k --
//      runs of k_pad sorted, then pairs of runs folded keeping the upper
//      half (Shanbhag, Pirk and Madden, SIGMOD 2018) -- written to
//      tiles x k_pad candidates;
//   2. merge pass, one CTA: it folds the candidate runs chunk by chunk
//      into a running top k_pad in shared memory (any number of tiles),
//      sums the tile counts and gathers counts and mask at the winners.
// So the input is read once, there are 2 launches instead of 47, and the
// scratch is tiles x k_pad x 8 + tiles x 4 bytes (the wrapper's). Larger
// k takes the full sort, tt_select; the wrapper chooses by (n, k) alone.
//
// The merge pass runs on one SM, so its time grows with the candidates.
// The tile starts at max(4,096, 2 k_pad) and doubles, up to the 16,384
// rows shared memory holds, while the candidates would be 65,536 or more
// (kernels.SELECT_CANDS): at N = 327,680 and k = 1,024, tiles of 4,096,
// 8,192 and 16,384 took 0.1526, 0.1272 and 0.1532 ms (chip_smoke.py's
// "K2 tiles" line, NVIDIA H100 80GB HBM3, 700 W). What bounds each pass
// (shared memory, instruction issue or the merge's one SM) is not
// measured; chip_smoke.py's "K2 split" line gives each pass's device time.
//
// K_SMALL = 2,048, from chip_smoke.py's sweep on the same card at N =
// 16,384, 32,768 and 327,680: the two-pass route beat the full sort at
// k = 64, 256, 1,024 and 2,048 at all three (at 2,048: 0.0518 against
// 0.0661, 0.0623 against 0.0818, 0.1967 against 0.2397 ms) and lost at
// 4,096 at all three (0.0886 against 0.0666, 0.1003 against 0.0823,
// 0.2645 against 0.2385 ms). Below 16,384 rows it is not measured.
#include "select.cuh"

#define SEL_THREADS 1024
#define SEL_MAX_SMEM (128 * 1024)  // the largest tile or merge buffer: 16,384 composites

// n_pad: power of two >= max(n, TILE); comp: n_pad scratch; out: 3k+1
TT_EXPORT int tt_select(const uint8_t* mask, const int32_t* key, const int32_t* counts,
                        int n, int k, u64* comp, int n_pad, int32_t* out, void* stream) {
    return tt_select_rows(mask, key, counts, n, 1, k, comp, n_pad, out, (cudaStream_t)stream, 0);
}

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

// Pass 1: one CTA a tile of `tile` rows (a power of two, a multiple of
// SEL_THREADS, at least 2 K). Rows past n are the pad composite 0.
__global__ void __launch_bounds__(SEL_THREADS)
    select_tile_kernel(const uint8_t* __restrict__ mask, const int32_t* __restrict__ key, int n,
                       int tile, int lg_k, u64* __restrict__ cand, int32_t* __restrict__ tcount) {
    extern __shared__ u64 s[];
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

// Pass 2, one CTA: the running top K in s[0, K); each chunk fills the
// other runs of the buffer (`buf` composites, at least 2 K) with the next
// candidate runs, pads the rest to a power of two with 0, and folds.
__global__ void __launch_bounds__(SEL_THREADS)
    select_merge_kernel(const u64* __restrict__ cand, const int32_t* __restrict__ tcount,
                        int tiles, int lg_k, int buf, const uint8_t* __restrict__ mask,
                        const int32_t* __restrict__ counts, int k, int32_t* __restrict__ out) {
    extern __shared__ u64 s[];
    __shared__ int n_match;
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

// The two-pass route. k_pad = 2^lg_k >= k; tile and buf as the kernels
// say; tiles = ceil(n / tile); cand: tiles * k_pad words; tcount: tiles
// words; out: 3k+1.
TT_EXPORT int tt_select_tiled(const uint8_t* mask, const int32_t* key, const int32_t* counts,
                              int n, int k, int lg_k, int tile, int tiles, int buf, u64* cand,
                              int32_t* tcount, int32_t* out, void* stream) {
    if (lg_k < 0 || lg_k > 13 || k < 1 || k > n || k > (1 << lg_k) || !sel_pow2(tile) ||
        tile % SEL_THREADS || tile < (2 << lg_k) || !sel_pow2(buf) || buf < (2 << lg_k) ||
        (long long)tile * 8 > SEL_MAX_SMEM || (long long)buf * 8 > SEL_MAX_SMEM ||
        tiles != (int)(((long long)n + tile - 1) / tile))
        return (int)cudaErrorInvalidValue;
    int err = sel_smem_limit();
    if (err) return err;
    cudaStream_t st = (cudaStream_t)stream;
    select_tile_kernel<<<tiles, SEL_THREADS, tile * sizeof(u64), st>>>(mask, key, n, tile, lg_k,
                                                                       cand, tcount);
    TT_LAUNCHED();
    if ((err = (int)cudaGetLastError())) return err;
    select_merge_kernel<<<1, SEL_THREADS, buf * sizeof(u64), st>>>(cand, tcount, tiles, lg_k, buf,
                                                                   mask, counts, k, out);
    TT_LAUNCHED();
    return (int)cudaGetLastError();
}
