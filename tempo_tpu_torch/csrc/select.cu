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
// For k up to K_SMALL (kernels.select_plan) this file takes the two
// passes of select.cuh (tt_select_tiled_rows, here on one row; B5b,
// multiquery.cu, runs the same kernels on Q rows with the row on
// gridDim.y of the tile pass and one merge CTA a row):
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
// scratch is tiles x k_pad x 8 + tiles x 4 bytes a row (the wrapper's).
// Larger k takes the full sort, tt_select; the wrapper chooses by (n, k)
// alone.
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

// The full sort. mask, counts: (rows, n); key (n,) shared; n_pad: power
// of two >= max(n, TILE); comp: rows * n_pad scratch; out: (rows, 3k+1).
// K2 calls it with one row (kernels.select_topk).
TT_EXPORT int tt_select(const uint8_t* mask, const int32_t* key, const int32_t* counts,
                        int n, int rows, int k, u64* comp, int n_pad, int32_t* out,
                        void* stream) {
    return tt_select_rows(mask, key, counts, n, rows, k, comp, n_pad, out, (cudaStream_t)stream,
                          0);
}

// The two-pass route. k_pad = 2^lg_k >= k; tiles = ceil(n / tile); cand:
// rows * tiles * k_pad words; tcount: rows * tiles words; out: (rows, 3k+1).
TT_EXPORT int tt_select_tiled(const uint8_t* mask, const int32_t* key, const int32_t* counts,
                              int n, int rows, int k, int lg_k, int tile, int tiles, int buf,
                              u64* cand, int32_t* tcount, int32_t* out, void* stream) {
    return tt_select_tiled_rows(mask, key, counts, n, rows, k, lg_k, tile, tiles, buf, cand,
                                tcount, out, (cudaStream_t)stream, 0);
}
