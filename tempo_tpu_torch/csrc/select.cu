// K2: masked top-k by an int32 key, ties to the lower index.
//
// Replaces tempo_tpu/ops/select.py:42 `_compiled_select` and :84
// `_compiled_select_multi` (`lax.top_k` over `where(mask, key, -2^31)`).
// The composite-key bitonic select itself is in select.cuh, shared with
// the row-wise B5b (multiquery.cu); this is its one-row entry.
//
// Bound: the function must read mask+key+counts (9 B a row) once; the
// sort makes log^2 passes over 8 B a row instead, so the kernel is
// bandwidth-bound at many times that floor. Sub-sequences of up to
// TILE rows sort in shared memory, which removes the short-stride
// passes from device memory.
#include "select.cuh"

// n_pad: power of two >= max(n, TILE); comp: n_pad scratch; out: 3k+1
TT_EXPORT int tt_select(const uint8_t* mask, const int32_t* key, const int32_t* counts,
                        int n, int k, u64* comp, int n_pad, int32_t* out, void* stream) {
    return tt_select_rows(mask, key, counts, n, 1, k, comp, n_pad, out, (cudaStream_t)stream, 0);
}
