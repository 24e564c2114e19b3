// B9a/B9b/B9c: the block cut's device steps (a block's finalize).
//
// Replaces the three jitted programs of tempo_tpu/ops/blockcut.py:
//   B9a :53-58   _compiled_remap    gather every code through the
//                                   dictionary's sort permutation
//   B9b :104-112 _compiled_bloom    OR the deduped one-bit words of every
//                                   trace id into the bloom's words
//   B9c :149-158 _compiled_rowgroup per row group, min/max of start_ms and
//                                   max of dur_us
// The XLA programs pad to power-of-two buckets; these kernels take the
// true lengths and produce the same values. All three are bound by bytes:
// each reads its inputs once and writes its outputs once.
#include "common.cuh"

// B9a: one thread per code. Negative codes (absent / sentinel) pass
// through; a code past the table clamps to its last entry, so the kernel
// never reads outside the table (a cut never makes such a code).
__global__ void remap_kernel(const int32_t* __restrict__ col, int n,
                             const int32_t* __restrict__ remap, int r,
                             int32_t* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int c = col[i];
    out[i] = c >= 0 ? remap[c < r ? c : r - 1] : c;
}

TT_EXPORT int tt_remap(const int32_t* col, int n, const int32_t* remap, int r, int32_t* out,
                       void* stream) {
    remap_kernel<<<tt_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(col, n, remap, r, out);
    TT_LAUNCHED_SLOT(0);
    return (int)cudaGetLastError();
}

// B9b: copy the words, then one thread per (word, bit) pair ORs its bit
// in. An OR needs no dedupe; the host dedupes all the same, so the inputs
// equal the reference's. Pairs past the words are dropped, as XLA's
// scatter drops out-of-range updates.
__global__ void copy_words_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                  long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = in[i];
}

__global__ void bloom_or_kernel(const int32_t* __restrict__ word_idx,
                                const uint32_t* __restrict__ bits, int m,
                                uint32_t* __restrict__ out, long long n_words) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    int w = word_idx[i];
    if (w >= 0 && w < n_words) atomicOr(out + w, bits[i]);
}

TT_EXPORT int tt_bloom_bits(const uint32_t* words, long long n_words, const int32_t* word_idx,
                            const uint32_t* bits, int m, uint32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    copy_words_kernel<<<tt_blocks(n_words, 256), 256, 0, st>>>(words, out, n_words);
    TT_LAUNCHED_SLOT(1);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (m > 0) {
        bloom_or_kernel<<<tt_blocks(m, 256), 256, 0, st>>>(word_idx, bits, m, out, n_words);
        TT_LAUNCHED_SLOT(1);
    }
    return (int)cudaGetLastError();
}

// B9c: one block per row group. Groups are the contiguous ranges
// [g * group, min((g + 1) * group, n)), every one non-empty, so no group
// id array and no trash segment exist. Each thread folds a strided slice,
// then warps fold by shuffles and the block through shared memory.
#define RG_THREADS 512

__device__ __forceinline__ void rg_fold(int& lo, int& hi, int& du, int lo2, int hi2, int du2) {
    lo = min(lo, lo2);
    hi = max(hi, hi2);
    du = max(du, du2);
}

__global__ void rowgroup_kernel(const int32_t* __restrict__ start_ms,
                                const int32_t* __restrict__ dur_us, int n, int group,
                                int32_t* __restrict__ out, int n_groups) {
    __shared__ int s_lo[RG_THREADS / 32], s_hi[RG_THREADS / 32], s_du[RG_THREADS / 32];
    int g = blockIdx.x;
    long long a = (long long)g * group;
    long long b = a + group < n ? a + group : n;
    int lo = INT32_MAXV, hi = PAD_I32, du = PAD_I32;
    for (long long i = a + threadIdx.x; i < b; i += blockDim.x) {
        int s = start_ms[i];
        rg_fold(lo, hi, du, s, s, dur_us[i]);
    }
    for (int off = 16; off > 0; off >>= 1)
        rg_fold(lo, hi, du, __shfl_down_sync(0xffffffffu, lo, off),
                __shfl_down_sync(0xffffffffu, hi, off), __shfl_down_sync(0xffffffffu, du, off));
    int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) {
        s_lo[warp] = lo;
        s_hi[warp] = hi;
        s_du[warp] = du;
    }
    __syncthreads();
    if (warp == 0) {
        int nw = blockDim.x >> 5;
        lo = lane < nw ? s_lo[lane] : INT32_MAXV;
        hi = lane < nw ? s_hi[lane] : PAD_I32;
        du = lane < nw ? s_du[lane] : PAD_I32;
        for (int off = 16; off > 0; off >>= 1)
            rg_fold(lo, hi, du, __shfl_down_sync(0xffffffffu, lo, off),
                    __shfl_down_sync(0xffffffffu, hi, off),
                    __shfl_down_sync(0xffffffffu, du, off));
        if (lane == 0) {
            out[g] = lo;
            out[n_groups + g] = hi;
            out[2 * n_groups + g] = du;
        }
    }
}

// out: (3, n_groups) int32 rows [start_ms min | start_ms max | dur_us max]
TT_EXPORT int tt_rowgroup(const int32_t* start_ms, const int32_t* dur_us, int n, int group,
                          int32_t* out, int n_groups, void* stream) {
    rowgroup_kernel<<<n_groups, RG_THREADS, 0, (cudaStream_t)stream>>>(start_ms, dur_us, n, group,
                                                                       out, n_groups);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}
