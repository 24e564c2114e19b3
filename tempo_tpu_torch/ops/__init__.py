"""The device operations: staging (K4), the filter program (K1), top-k
selection (K2), the trace-ID bisection (K3), batched search (B5a, B5b),
metrics folds (B6), the block cut (B9a-B9c), the bloom union and test
(B10a, B10b), the live head's slot mask, find, row append and slot
patch (B7a-B7d, with the LiveStager), the metrics-generator's
segmented reduces (B8a, B8b) and one rank's share of the sharded search
(meshsearch: M5-M8). Each module holds the plain
PyTorch version beside the dispatch to its CUDA kernel
(tempo_tpu_torch/kernels.py)."""
