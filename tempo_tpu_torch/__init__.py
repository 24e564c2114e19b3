"""PyTorch/CUDA port of tempo_tpu, slice by slice: find-by-ID, TraceQL
search (single and batched) and TraceQL metrics over complete blocks,
and the storage write path (the block cut, compaction and retention),
with every device program on those paths written by hand in CUDA C++
for Hopper (csrc/, bound in kernels.py).

Imports torch, never jax, and nothing of the tempo_tpu package; blocks
on disk are the same vtpu2 format both packages read and write."""
