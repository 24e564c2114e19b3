// B7a-B7d: the live head's device programs (the ingester's staged
// live/cut/flushing traces).
//
// Replaces the four jitted programs of tempo_tpu/ops/livestage.py:
//   B7a :147 _compiled_live_filter -> run  slot mask: alive, n_slots, the
//                                          time window, min duration, and
//                                          per tag / name code membership
//                                          over the (owner, code) rows
//   B7b :243 _compiled_find -> run         first alive slot whose 4 id
//                                          codes equal the query's, or -1
//   B7c :290 _append_rows_device           dynamic_update_slice of a row
//                                          column (the delta append)
//   B7d :298 _patch_slots_device           dst.at[idx].set(vals) of dirty
//                                          slots, 1-D or (slot_b, 4)
// All four are bound by bytes. XLA's B7a makes one segment_max pass over
// every row per query code; here one pass over the kv rows and one over
// the name rows compare each row's code against up to 32 query codes held
// in shared memory and atomicOr bit i into a per-slot hit word, and a
// slot pass ANDs `hit == all bits` into the mask: the rows are read once
// per 32 codes, not once per code. B7c and B7d write a NEW tensor (the
// wrapper allocates it): the live snapshot a query holds is immutable, as
// the JAX arrays are, so the resident columns are never written in place.
#include "common.cuh"

#define LIVE_CHUNK 32

// B7a step 1: one thread per row. The chunk's codes [lo, hi) of the
// combined list (tag codes first, then name codes) sit in shared memory;
// this pass takes the ones of its row kind, [a, b), and ORs bit (j - lo)
// of every code j equal to the row's code into its owner slot's word.
__global__ void live_rows_kernel(const int32_t* __restrict__ owner,
                                 const int32_t* __restrict__ code, int n_rows,
                                 const int32_t* __restrict__ q, int lo, int a, int b,
                                 int slot_b, unsigned int* __restrict__ hit) {
    __shared__ int32_t s_q[LIVE_CHUNK];
    int nq = b - a;
    if (threadIdx.x < nq) s_q[threadIdx.x] = q[a + threadIdx.x];
    __syncthreads();
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n_rows) return;
    int c = code[r];
    unsigned int bits = 0;
    for (int j = 0; j < nq; ++j) bits |= (unsigned int)(s_q[j] == c) << (a - lo + j);
    if (bits) atomicOr(hit + tt_clamp(owner[r], 0, slot_b - 1), bits);
}

// B7a step 2: one thread per slot. The first pass applies the scalar
// prefilters; every pass with codes ANDs `hit == full` and re-zeroes the
// word for the next chunk.
__global__ void live_slots_kernel(const int32_t* __restrict__ start_s,
                                  const int32_t* __restrict__ end_s,
                                  const int32_t* __restrict__ dur_ms,
                                  const int32_t* __restrict__ alive, int slot_b, int n_slots,
                                  int f_start, int t0, int f_end, int t1, int f_min, int dmin,
                                  int first, unsigned int full, unsigned int* __restrict__ hit,
                                  bool* __restrict__ mask) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= slot_b) return;
    bool m;
    if (first) {
        m = alive[i] > 0 && i < n_slots;
        if (f_start) m = m && end_s[i] >= t0;
        if (f_end) m = m && start_s[i] <= t1;
        if (f_min) m = m && dur_ms[i] >= dmin;
    } else {
        m = mask[i];
    }
    if (full) {
        m = m && hit[i] == full;
        hit[i] = 0;
    }
    mask[i] = m;
}

// q: n_tags tag codes then n_names name codes (device). hit: slot_b words
// of scratch. mask: slot_b bools.
TT_EXPORT int tt_live_filter(const int32_t* start_s, const int32_t* end_s, const int32_t* dur_ms,
                             const int32_t* alive, int slot_b, const int32_t* kv_owner,
                             const int32_t* kv_code, int kv_b, const int32_t* name_owner,
                             const int32_t* name_code, int name_b, const int32_t* q, int n_tags,
                             int n_names, int f_start, int t0, int f_end, int t1, int f_min,
                             int dmin, int n_slots, unsigned int* hit, bool* mask,
                             void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int n = n_tags + n_names;
    int err;
    if (n > 0) {
        err = (int)cudaMemsetAsync(hit, 0, sizeof(unsigned int) * (size_t)slot_b, st);
        if (err) return err;
    }
    int first = 1;
    for (int lo = 0; first || lo < n; lo += LIVE_CHUNK) {
        int hi = lo + LIVE_CHUNK < n ? lo + LIVE_CHUNK : n;
        int ta = lo, tb = hi < n_tags ? hi : n_tags;  // tag codes of the chunk
        int na = lo > n_tags ? lo : n_tags, nb = hi;  // name codes of the chunk
        if (tb > ta && kv_b > 0) {
            live_rows_kernel<<<tt_blocks(kv_b, 256), 256, 0, st>>>(kv_owner, kv_code, kv_b, q,
                                                                   lo, ta, tb, slot_b, hit);
            TT_LAUNCHED_SLOT(0);
            if ((err = (int)cudaGetLastError())) return err;
        }
        if (nb > na && name_b > 0) {
            live_rows_kernel<<<tt_blocks(name_b, 256), 256, 0, st>>>(
                name_owner, name_code, name_b, q, lo, na, nb, slot_b, hit);
            TT_LAUNCHED_SLOT(0);
            if ((err = (int)cudaGetLastError())) return err;
        }
        int w = hi - lo;
        unsigned int full = w <= 0 ? 0u : (w == 32 ? 0xFFFFFFFFu : (1u << w) - 1u);
        live_slots_kernel<<<tt_blocks(slot_b, 256), 256, 0, st>>>(
            start_s, end_s, dur_ms, alive, slot_b, n_slots, f_start, t0, f_end, t1, f_min, dmin,
            first, full, hit, mask);
        TT_LAUNCHED_SLOT(0);
        if ((err = (int)cudaGetLastError())) return err;
        first = 0;
    }
    return 0;
}

// B7b: one thread per slot; a match takes the lowest index by an unsigned
// atomicMin into a word preset to 0xFFFFFFFF, which reads as -1 when no
// slot matched (argmax's first-match order; -1 otherwise).
__global__ void live_find_kernel(const int4* __restrict__ id_codes,
                                 const int32_t* __restrict__ alive, int slot_b, int n_slots,
                                 const int32_t* __restrict__ q, unsigned int* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= slot_b || i >= n_slots || alive[i] <= 0) return;
    int4 c = id_codes[i];
    if (c.x == q[0] && c.y == q[1] && c.z == q[2] && c.w == q[3])
        atomicMin(out, (unsigned int)i);
}

TT_EXPORT int tt_live_find(const int32_t* id_codes, const int32_t* alive, int slot_b,
                           int n_slots, const int32_t* q, int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int err = (int)cudaMemsetAsync(out, 0xFF, sizeof(int32_t), st);
    if (err) return err;
    live_find_kernel<<<tt_blocks(slot_b, 256), 256, 0, st>>>(
        (const int4*)id_codes, alive, slot_b, n_slots, q, (unsigned int*)out);
    TT_LAUNCHED_SLOT(1);
    return (int)cudaGetLastError();
}

// B7c: out[i] = src[i - s] inside the window [s, s + m), dst[i] outside.
// As jax.lax.dynamic_update_slice does, a negative start counts from the
// end (start + n) and s is that start clamped to [0, n - m].
__global__ void live_append_kernel(const int32_t* __restrict__ dst, int n,
                                   const int32_t* __restrict__ src, int m, int s,
                                   int32_t* __restrict__ out) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    out[i] = (i >= s && i - s < m) ? src[i - s] : dst[i];
}

TT_EXPORT int tt_live_append(const int32_t* dst, int n, const int32_t* src, int m, int start,
                             int32_t* out, void* stream) {
    int s = start < 0 ? start + n : start;
    s = s < 0 ? 0 : (s > n - m ? n - m : s);
    live_append_kernel<<<tt_blocks(n, 256), 256, 0, (cudaStream_t)stream>>>(dst, n, src, m, s,
                                                                           out);
    TT_LAUNCHED_SLOT(2);
    return (int)cudaGetLastError();
}

// B7d: copy the rows, then one thread per (index, lane) writes its value.
// A negative index counts from the end (index + n), as jnp indexing
// normalises it; an index still outside [0, n) is dropped, as XLA's
// scatter drops it. Repeated indices must carry equal values (the stager
// pads with a repeated real index and its own value); with unequal values
// which one lands is not specified, as in XLA.
__global__ void live_copy_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                                 long long n) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = in[i];
}

__global__ void live_patch_kernel(int n, int width, const int32_t* __restrict__ idx,
                                  const int32_t* __restrict__ vals, int m,
                                  int32_t* __restrict__ out) {
    long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)m * width) return;
    int k = (int)(t / width), lane = (int)(t % width);
    long long r = idx[k];
    if (r < 0) r += n;
    if (r < 0 || r >= n) return;
    out[r * width + lane] = vals[t];
}

TT_EXPORT int tt_live_patch(const int32_t* dst, int n, int width, const int32_t* idx,
                            const int32_t* vals, int m, int32_t* out, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    long long total = (long long)n * width;
    live_copy_kernel<<<tt_blocks(total, 256), 256, 0, st>>>(dst, out, total);
    TT_LAUNCHED_SLOT(3);
    int err = (int)cudaGetLastError();
    if (err || m == 0) return err;
    live_patch_kernel<<<tt_blocks((long long)m * width, 256), 256, 0, st>>>(n, width, idx, vals,
                                                                          m, out);
    TT_LAUNCHED_SLOT(3);
    return (int)cudaGetLastError();
}
