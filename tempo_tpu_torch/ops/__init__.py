"""The device operations: staging (K4), the filter program (K1), top-k
selection (K2), the trace-ID bisection (K3), batched search (B5a, B5b),
metrics folds (B6), the block cut (B9a-B9c), the bloom union and test
(B10a, B10b) and the live head's slot mask, find, row append and slot
patch (B7a-B7d, with the LiveStager). Each module holds the plain
PyTorch version beside the dispatch to its CUDA kernel
(tempo_tpu_torch/kernels.py)."""
