"""PyTorch/CUDA port of tempo_tpu, slice by slice: find-by-ID, TraceQL
search (single and batched) and TraceQL metrics over complete blocks,
the storage write path (the block cut, compaction and retention), and
the ingest plane with the live head (the WAL, the ingester, live search
and find over staged columns), and the metrics-generator behind the
distributor (span-metrics and service-graph folds), the mesh programs
over torch.distributed (parallel/), and the read plane served by the
single binary (services/app.py: the query frontend, the querier, the
result cache and the job plane behind the HTTP API), with every device program
of the JAX package written by hand in CUDA C++ for Hopper (csrc/, bound
in kernels.py).

Imports torch, never jax, and nothing of the tempo_tpu package; blocks
and WAL files on disk are the same formats both packages read and
write."""
