// The per-span condition semantics of the TraceQL filter program,
// shared by K1 (filter.cu) and B6 (timeseries.cu) so the compare rules
// exist once: the reference's `_cmp` (f32 promotion of an int column
// against a float operand, dictionary tables, PAD guards) and
// `_cond_mask` (span and span@res columns compare directly, sattr
// conditions loop over the span's own attr rows, rattr conditions
// gather a per-resource mask through the clamped span.res_idx).
// The host side of the layout is tempo_tpu_torch/ops/filter.py.
#pragma once

#include "common.cuh"

enum Op {
    OP_EQ = 0, OP_NE, OP_NE_PRESENT, OP_LT, OP_LE, OP_GT, OP_GE, OP_RANGE,
    OP_EXISTS, OP_NE_CLAMPED, OP_INTABLE, OP_NOTINTABLE
};
enum Kind { K_SPAN = 0, K_TRACE, K_RES, K_SATTR, K_RATTR };
// C_TCOND (B6 only): a trace-target condition read at the span's trace
enum Code { C_COND = 0, C_MASK, C_TRUE, C_FALSE, C_AND, C_OR, C_TRACIFY, C_TCOND };

// descriptor row: DW int64 fields (layout mirrored by ops/filter.py)
enum Field {
    D_OP = 0, D_KIND, D_FLOATCMP, D_COLFLOAT, D_VT, D_COL, D_KEYCOL, D_VTCOL, D_OFF,
    D_TABLE, D_TABLEN, D_V0, D_V1, D_KEY, D_F0, D_F1, D_RSLOT
};
#define DW 17

template <typename T>
__device__ __forceinline__ bool cmp_t(int op, T x, T a, T b) {
    switch (op) {
        case OP_EQ: return x == a;
        case OP_NE: return x != a;
        case OP_NE_PRESENT: return (x != a) && (x >= (T)0);
        case OP_NE_CLAMPED:
            return (x != a) || (x == (T)INT32_MAXV) || (x == (T)(-INT32_MAXV));
        case OP_LT: return x < a;
        case OP_LE: return x <= a;
        case OP_GT: return x > a;
        case OP_GE: return x >= a;
        case OP_RANGE: return (x >= a) && (x <= b);
        default: return true;  // OP_EXISTS
    }
}

// the reference's _cmp on one 32-bit element w of the leaf's column
// (an int32, or the bits of an f32 where D_COLFLOAT)
__device__ __forceinline__ bool cmp_word(const long long* d, int w) {
    int op = (int)d[D_OP];
    if (op == OP_EXISTS) return true;
    if (!d[D_FLOATCMP]) {
        int x = w;
        if (op == OP_INTABLE || op == OP_NOTINTABLE) {
            const uint8_t* table = (const uint8_t*)d[D_TABLE];
            bool hit = table[tt_clamp(x, 0, (int)d[D_TABLEN] - 1)] > 0;
            if (op == OP_NOTINTABLE) hit = !hit;
            return hit && x >= 0;
        }
        return cmp_t<int>(op, x, (int)d[D_V0], (int)d[D_V1]);
    }
    // int32 vs f32 promotes to f32, as in the jitted program
    float x = d[D_COLFLOAT] ? __int_as_float(w) : (float)w;
    return cmp_t<float>(op, x, __int_as_float((int)d[D_F0]), __int_as_float((int)d[D_F1]));
}

// the reference's _cmp on one element of column `col` at `row`
__device__ __forceinline__ bool cmp_at(const long long* d, const void* col, long long row) {
    if ((int)d[D_OP] == OP_EXISTS) return true;
    return cmp_word(d, ((const int32_t*)col)[row]);
}

// any attr row of [lo, hi) matching key (+ vtype and value)
__device__ __forceinline__ bool attr_any(const long long* d, int lo, int hi) {
    const int32_t* keycol = (const int32_t*)d[D_KEYCOL];
    const int32_t* vtcol = (const int32_t*)d[D_VTCOL];
    const void* col = (const void*)d[D_COL];
    int key = (int)d[D_KEY], vt = (int)d[D_VT];
    for (int j = lo; j < hi; ++j) {
        if (keycol[j] != key) continue;
        if (vt < 0) return true;  // 'any': key presence
        if (vtcol[j] == vt && cmp_at(d, col, j)) return true;
    }
    return false;
}

__global__ void res_pass_kernel(const long long* __restrict__ desc, const int32_t* __restrict__ rconds,
                                int n_rc, int n_res_b, uint8_t* __restrict__ resmask) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n_rc * n_res_b) return;
    int k = (int)(t / n_res_b), r = (int)(t % n_res_b);
    const long long* d = desc + (long long)rconds[k] * DW;
    const int32_t* off = (const int32_t*)d[D_OFF];
    resmask[t] = attr_any(d, off[r], off[r + 1]);
}

__device__ bool span_leaf(const long long* d, int s, bool valid, const uint8_t* resmask,
                          int n_res_b, const int32_t* res_idx) {
    if (!valid) return false;
    switch ((int)d[D_KIND]) {
        case K_SPAN: return cmp_at(d, (const void*)d[D_COL], s);
        case K_RES: {
            // span@<res col>: PAD marks spans without a resource row
            int x = ((const int32_t*)d[D_COL])[s];
            return x != PAD_I32 && cmp_at(d, (const void*)d[D_COL], s);
        }
        case K_SATTR: {
            const int32_t* off = (const int32_t*)d[D_OFF];
            return attr_any(d, off[s], off[s + 1]);
        }
        case K_RATTR: {
            int r = res_idx[s];
            return r >= 0 && resmask[(long long)d[D_RSLOT] * n_res_b + tt_clamp(r, 0, n_res_b - 1)];
        }
    }
    return false;
}
