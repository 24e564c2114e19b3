// The masked top-k by an int32 key, ties to the lower index, over one
// or many rows, by a full sort: the device code of B5b (multiquery.cu, Q
// rows on gridDim.y) and of K2's route for k > K_SMALL (select.cu, one
// row; its two-pass route builds the same composites), so all keep one
// tie rule.
//
// Each row element becomes one 64-bit composite key
//     (u32(key ^ 0x80000000) << 32) | (0xFFFFFFFF - idx)
// with masked elements at key -2^31. All composites of a row are
// distinct, and their descending order is exactly lax.top_k's: larger
// key first, equal keys by lower index, masked elements last in index
// order. A bitonic sort over the power-of-two-padded length (pad
// composite 0 sorts after every real element) orders each row; the
// first k are emitted as the packed row [idx(k) | count(k) | valid(k) |
// n_match]. The order is total, so the first k' slots of a k-select
// equal a k'-select (the prefix property the batched search relies on).
//
// The key column is shared by every row (the trace start key of one
// staged block); mask and counts are per row.
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
