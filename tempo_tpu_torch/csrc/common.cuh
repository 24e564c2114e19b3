// Shared definitions for the port's kernels: every entry point is a
// plain C function that launches on the caller's stream and returns the
// cudaError_t of the launch (0 = success), so the Python wrapper
// (tempo_tpu_torch/kernels.py) can bind it with ctypes and raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))

#define PAD_I32 ((int32_t)0x80000000)
#define INT32_MAXV ((int32_t)0x7FFFFFFF)

// __global__ launches this library has made, per kernel slot (a library
// holding two kernels, like multiquery.cu, counts each in its own slot):
// one wrapper call may make several (a filter program run, a bitonic
// select). Each launch site is followed by TT_LAUNCHED() (slot 0) or
// TT_LAUNCHED_SLOT(i); kernels.grid_launches() reads the counts.
#define TT_SLOTS 8
static std::atomic<unsigned long long> tt_grid_launches_[TT_SLOTS];
#define TT_LAUNCHED_SLOT(i) tt_grid_launches_[i].fetch_add(1, std::memory_order_relaxed)
#define TT_LAUNCHED() TT_LAUNCHED_SLOT(0)

// the count of one slot so far; reset != 0 also sets it back to 0
TT_EXPORT unsigned long long tt_grid_launches(int reset, int slot) {
    if (slot < 0 || slot >= TT_SLOTS) return 0;
    return reset ? tt_grid_launches_[slot].exchange(0) : tt_grid_launches_[slot].load();
}

static inline int tt_blocks(long long n, int threads) {
    long long b = (n + threads - 1) / threads;
    return (int)(b < 1 ? 1 : b);
}

__device__ __forceinline__ int tt_clamp(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// 4 bytes from device to shared memory without passing through registers
// (cp.async, sm_80 and later); tt_copy_wait waits for this thread's copies
__device__ __forceinline__ void tt_copy4(int32_t* dst, const int32_t* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

__device__ __forceinline__ void tt_copy_wait() {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
