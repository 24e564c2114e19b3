"""Build, load and launch the port's hand-written CUDA kernels.

Each source in csrc/ is compiled by its own `nvcc` (all started at
once) into a shared library with a plain C interface under
build/tempo_tpu_torch/ at first use, and bound with ctypes. Nothing is
built or loaded at import: the CPU tests import every module.

Every wrapper checks device, dtype, shape and contiguity, allocates its
outputs with torch.empty, launches on the current stream, raises if the
C entry returns a nonzero cudaError_t, and adds one to LAUNCHES[name].
LAUNCHES counts wrapper calls: one filter_run is one run of a whole
filter program, which on the trace tiles (filter_plan) launches one
kernel, after a res pass for resource.attr conditions and a flag pass
for `~` on a block with orphans, and on the multi-launch route a res
pass, a span pass per slot, its struct kernels (`>>` alone is init +
n_passes doubling + final) and a trace pass; one select_topk, and one
mq_select over all its rows, launches a tile pass and a merge pass
where select_plan takes the tiles, else a key pass, its bitonic passes
and an emit; one find launches one kernel a chunk of FIND_BLOCKS
blocks (a descriptor a block, no stack); one multiquery, one live_find,
one live_patch, one edge_reduce, one span_reduce and one timeseries
(without a res pass) launch one kernel.
grid_launches() reads the __global__ launches each library counts
itself, per kernel. There is no CPU path
here: the ops modules send CPU tensors to their plain PyTorch versions
and only CUDA tensors to these wrappers.

Every failure to build, load, accept arguments or launch raises
KernelError. Callers that isolate per-item failures (the batching
executor's group fallback) let this class through: a kernel fault is
never hidden behind a plain version or another route.

| kernel      | source             | replaces (JAX package)                         |
|-------------|--------------------|------------------------------------------------|
| filter      | csrc/filter.cu     | tempo_tpu/ops/filter.py:286 _compiled(...).run |
| select      | csrc/select.cu     | tempo_tpu/ops/select.py:42, :84                |
| find        | csrc/find.cu       | tempo_tpu/ops/find.py:68 _lookup_blocks_kernel |
| res_to_span | csrc/stage.cu      | tempo_tpu/ops/stage.py:178 _res_to_span        |
| multiquery  | csrc/multiquery.cu | tempo_tpu/ops/multiquery.py:356 run (B5a)      |
| mq_select   | csrc/multiquery.cu | tempo_tpu/ops/multiquery.py:461 sel (B5b)      |
| timeseries  | csrc/timeseries.cu | tempo_tpu/ops/timeseries.py:53 run (B6)        |
| remap       | csrc/blockcut.cu   | tempo_tpu/ops/blockcut.py:53-58 (B9a)          |
| bloom_bits  | csrc/blockcut.cu   | tempo_tpu/ops/blockcut.py:104-112 (B9b)        |
| rowgroup    | csrc/blockcut.cu   | tempo_tpu/ops/blockcut.py:149-158 (B9c)        |
| bloom_union | csrc/bloom.cu      | tempo_tpu/ops/bloom_ops.py:20 _union_kernel    |
| bloom_test  | csrc/bloom.cu      | tempo_tpu/ops/bloom_ops.py:48 _test_kernel     |
| live_filter | csrc/livestage.cu  | tempo_tpu/ops/livestage.py:147 run (B7a)       |
| live_find   | csrc/livestage.cu  | tempo_tpu/ops/livestage.py:243 run (B7b)       |
| live_append | csrc/livestage.cu  | tempo_tpu/ops/livestage.py:290 (B7c)           |
| live_patch  | csrc/livestage.cu  | tempo_tpu/ops/livestage.py:298 (B7d)           |
| span_reduce | csrc/reduce.cu     | tempo_tpu/ops/reduce.py:23 _reduce_kernel (B8a) |
| edge_reduce | csrc/reduce.cu     | tempo_tpu/ops/reduce.py:63 _edge_reduce_kernel (B8b) |
| find_elect  | csrc/find.cu       | tempo_tpu/parallel/find.py:47-68 local (M1)    |
| mq_partial  | csrc/multiquery.cu | tempo_tpu/parallel/multiquery.py:57-100 (M2)   |
| mq_combine  | csrc/multiquery.cu | tempo_tpu/parallel/multiquery.py:102-125 (M3)  |
| timeseries_stacked | csrc/timeseries.cu | tempo_tpu/parallel/timeseries.py:45-131 local (M4) |
| attr_partial | csrc/meshsearch.cu | tempo_tpu/parallel/search.py:122-170 (M5)      |
| mask_pack   | csrc/meshsearch.cu | tempo_tpu/parallel/search.py:175-189 (M6)      |
| mask_unpack | csrc/meshsearch.cu | tempo_tpu/parallel/search.py:175-189 (M6)      |
| search_partial | csrc/meshsearch.cu | tempo_tpu/parallel/search.py:272-290 (M7)   |
| search_finish | csrc/meshsearch.cu | tempo_tpu/parallel/search.py:292-322 (M8)    |

The write path's kernels: launches on their path, what bounds them, and
the one PyTorch call that computes the same function (the yardstick
chip_smoke.py times; the port calls none):

| kernel      | launches on its path                     | bound (bytes moved)                 | one PyTorch call                                   |
|-------------|------------------------------------------|-------------------------------------|----------------------------------------------------|
| remap       | one per code column of a cut (29)        | 8 B a code + the table              | none: a clamp, a gather and a select               |
| bloom_bits  | one per cut without a given bloom        | words read and written, 8 B a pair  | index_put_(accumulate=True) on zeroed words        |
| rowgroup    | one per cut with spans                   | 8 B a span + 12 B a group           | torch.segment_reduce (max of [-start, start, dur]) |
| bloom_union | one per compaction job whose union fits  | K + 1 words per output word         | none: no bitwise-OR reduction over a dimension     |
| bloom_test  | none (no caller, as in the JAX package)  | K words and K index triples a query | none: a gather, a shift and an all                 |

The live head's kernels (ops/livestage.py, the ingester's staged
live/cut/flushing traces):

| kernel      | launches on its path                      | bound (bytes moved)                 | one PyTorch call                                   |
|-------------|-------------------------------------------|-------------------------------------|----------------------------------------------------|
| live_filter | one per live search on the device route   | 17 B a slot, 4 B a real row, 4 B a hit | none: a membership test per code over owner rows |
| live_find   | one per live find, TEMPO_LIVE_FIND_DEVICE | 20 B a slot                         | none: an all over 4 lanes, then a first-true index |
| live_append | two per row kind per delta refresh        | the column read and written once    | torch.slice_scatter                                |
| live_patch  | six per delta refresh with dirty slots    | the column read and written once    | torch.index_put (out of place)                     |

live_filter is one cooperative launch a chunk of 32 codes (the codes by
value, only the snapshot's real rows read, hit words tagged with the
call's epoch in scratch kept a stream, one grid barrier), no upload and
no memset.
live_find is one launch with the query as four kernel arguments: no
upload, no memset, no device atomic (a thread-block cluster of up to 8
CTAs where the slots need more than one, their minima folded through
distributed shared memory; else one CTA, launched without a cluster).

The metrics-generator's kernels (ops/reduce.py, fed by the distributor's
streaming tap):

| kernel      | launches on its path                        | bound (bytes moved)                   | one PyTorch call                               |
|-------------|---------------------------------------------|---------------------------------------|------------------------------------------------|
| span_reduce | one per tap window; one per legacy collect  | 8 B a row + 4 B x S x (nb + 2) written | none: searchsorted, two bincounts, index_add_  |
| edge_reduce | one per tap window that completed an edge   | 16 B a row + 4 B x E x (2 nb + 4)     | none: the same per side, and a failed bincount |

span_reduce writes one packed table (span_views): a memset, then the
atomic fold.
edge_reduce writes one packed allocation (edge_views) by one of two
routes (edge_plan): a tile CTA a range of edge ids in shared memory (one
launch, no memset), or a memset and the atomic fold. timeseries (B6)
writes one packed allocation (timeseries_views) in one cooperative
launch (after the res pass of a program with resource.attr conditions)
by the route timeseries_plan picks: the grid in each CTA's shared
memory, spread over a thread-block cluster's, or device-memory atomics.

The mesh programs' kernels (parallel/, one body on every rank of a
mesh; a collective between the halves):

| kernel      | launches on its path                           | bound (bytes moved)                   | one PyTorch call                               |
|-------------|------------------------------------------------|---------------------------------------|------------------------------------------------|
| find_elect  | two per sharded_find on every rank             | 4 B x Bl x Q read, 4 B x Q written    | none: a where, then an amax                    |
| mq_partial  | one per mesh-batched window on every rank      | 4 B a span a column, (NG+1) x 4 B out | none: a cumsum and two gathers per group       |
| mq_combine  | one per mesh-batched window on every rank      | (NG+1) x 4 B in, 5 B out a trace      | none: a compare, a gather and an all per query |
| timeseries_stacked | fold, then finish for value folds, per stacked fold on every rank | 13 B a span + the columns | none: index_add_ and two scatter_reduce_ |
| attr_partial | count (a CTA a tile of owners), then mask, per attr or res leaf of a sharded search on every rank | 4 B an attr row, 8 B a row of the leaf's key, the offsets and counts; 5 B a span row for the mask | none: a compare, a cumsum and two gathers per leaf |
| mask_pack   | one per struct node of a sharded search (bit-packing on) | 9 B a span row                    | none: a shift and a sum over a reshaped view   |
| mask_unpack | one per struct node of a sharded search (bit-packing on) | 9 B a span row                    | none: a shift and a mask over a broadcast view |
| search_partial | one per sharded search on every rank          | 1 B a span row a tracify slot + the offsets | none: a cumsum and two gathers per slot, or index_add_ |
| search_finish | one per sharded search on every rank           | the counts and trace columns read, 5 B a trace out | none: the trace program's compares and folds |

K1 on a mesh shard (parallel/search.py) runs its span and struct passes
through filter_span_shard and filter_struct_shard: each call runs one
step of the program on every block of the shard and counts one filter
launch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(_ROOT, "build", "tempo_tpu_torch")
SOURCES = ("filter", "select", "find", "stage", "multiquery", "timeseries", "blockcut",
           "bloom", "livestage", "reduce", "meshsearch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# launches per kernel, counted where each wrapper launches (under a
# lock: the batchers launch from several threads)
LAUNCHES = {"filter": 0, "select": 0, "find": 0, "res_to_span": 0,
            "multiquery": 0, "mq_select": 0, "timeseries": 0, "remap": 0, "bloom_bits": 0,
            "rowgroup": 0, "bloom_union": 0, "bloom_test": 0, "live_filter": 0,
            "live_find": 0, "live_append": 0, "live_patch": 0, "span_reduce": 0,
            "edge_reduce": 0, "find_elect": 0, "mq_partial": 0, "mq_combine": 0,
            "timeseries_stacked": 0, "attr_partial": 0, "mask_pack": 0, "mask_unpack": 0,
            "search_partial": 0, "search_finish": 0}
# source -> its kernels, in the library's launch-counter slot order
_KERNEL_OF = {"filter": ("filter",), "select": ("select",), "find": ("find", "find_elect"),
              "stage": ("res_to_span",),
              "multiquery": ("multiquery", "mq_select", "mq_partial", "mq_combine"),
              "timeseries": ("timeseries", "timeseries_stacked"), "blockcut": ("remap", "bloom_bits", "rowgroup"),
              "bloom": ("bloom_union", "bloom_test"),
              "livestage": ("live_filter", "live_find", "live_append", "live_patch"),
              "reduce": ("span_reduce", "edge_reduce"),
              "meshsearch": ("attr_partial", "mask_pack", "mask_unpack", "search_partial",
                             "search_finish")}


class KernelError(RuntimeError):
    """A kernel did not build, load, take its arguments or launch."""

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "tt_res_to_span": ("stage", [_P, _I, _P, _P, _I, _P]),
    "tt_find": ("find", [_P, _P, _I, _I, _P, _P, _I, _P, _I, _P, _P]),
    "tt_select": ("select", [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P]),
    "tt_select_tiled": ("select", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "tt_filter_res_pass": ("filter", [_P, _P, _I, _I, _P, _P]),
    "tt_filter_span_pass": ("filter", [_P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _P]),
    "tt_filter_struct": ("filter", [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _P]),
    "tt_filter_trace_pass": ("filter", [_P, _I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _P, _P, _P]),
    "tt_filter_span_epilogue": ("filter", [_P, _P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P]),
    "tt_filter_tiles": ("filter", [_P, _P, _I, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _I, _P,
                                   _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P]),
    "tt_multiquery": ("multiquery", [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _P,
                                     _I, _I, _I, _I, _P, _P, _P]),
    "tt_mq_select": ("multiquery", [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P]),
    "tt_mq_select_tiled": ("multiquery", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                          _P]),
    "tt_timeseries": ("timeseries", [_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]),
    "tt_timeseries_ctas": ("timeseries", [_I, _I, _I, _P]),
    "tt_remap": ("blockcut", [_P, _I, _P, _I, _P, _P]),
    "tt_bloom_bits": ("blockcut", [_P, _L, _P, _P, _I, _P, _P]),
    "tt_rowgroup": ("blockcut", [_P, _P, _I, _I, _P, _I, _P]),
    "tt_bloom_union": ("bloom", [_P, _I, _L, _P, _P]),
    "tt_bloom_test": ("bloom", [_P, _I, _I, _P, _P, _I, _I, _P, _P]),
    "tt_live_filter": ("livestage", [_P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I, _I, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]),
    "tt_live_find": ("livestage", [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P]),
    "tt_live_append": ("livestage", [_P, _I, _P, _I, _I, _P, _P]),
    "tt_live_patch": ("livestage", [_P, _I, _I, _P, _P, _I, _P, _P]),
    "tt_span_reduce": ("reduce", [_P, _P, _I, _P, _I, _I, _P, _P]),
    "tt_edge_reduce": ("reduce", [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P]),
    "tt_find_elect": ("find", [_P, _I, _I, _I, _P, _P, _P]),
    "tt_mq_partial": ("multiquery", [_P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _P, _P]),
    "tt_mq_combine": ("multiquery", [_P, _I, _I, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P]),
    "tt_timeseries_stacked": ("timeseries", [_P, _I, _P, _I, _L, _P, _I, _P, _P, _P, _P, _P, _P,
                                             _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]),
    "tt_ts_stacked_finish": ("timeseries", [_P, _P, _I, _P]),
    "tt_attr_partial": ("meshsearch", [_P, _I, _I, _I, _I, _I, _P, _P]),
    "tt_attr_mask": ("meshsearch", [_P, _I, _P, _P, _I, _I, _I, _P, _L, _P]),
    "tt_mask_pack": ("meshsearch", [_P, _L, _I, _I, _P, _P]),
    "tt_mask_unpack": ("meshsearch", [_P, _I, _I, _P, _P]),
    "tt_search_partial": ("meshsearch", [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P]),
    "tt_search_finish": ("meshsearch", [_P, _I, _P, _P, _I, _I, _I, _P, _P, _P]),
}

# one lock over build and load: the first use may come from several
# batcher threads at once; the first builds and binds, the rest wait and
# find the bound table
_lock = threading.RLock()
_fns: dict[str, ctypes._CFuncPtr] | None = None
_grid_fns: dict[str, ctypes._CFuncPtr] = {}  # source -> tt_grid_launches of its library


_count_lock = threading.Lock()


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for src, fn in _grid_fns.items():
        for slot in range(len(_KERNEL_OF[src])):
            fn(1, slot)


def grid_launches() -> dict[str, int]:
    """__global__ launches per kernel since the last reset_counts(), as
    counted inside each library (0 before the libraries are loaded)."""
    out = dict.fromkeys(LAUNCHES, 0)
    for src, fn in _grid_fns.items():
        for slot, name in enumerate(_KERNEL_OF[src]):
            out[name] = int(fn(0, slot))
    return out


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _digest(src: str) -> str:
    """Flags, the source and every shared header (a source may include
    any of them)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    names = [src + ".cu"] + sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in names:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> dict[str, str]:
    """Compile every source that has no up-to-date library (one nvcc
    process per source, run in parallel). Returns source -> .so path."""
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        libs, procs = {}, []
        try:
            for src in SOURCES:
                lib = os.path.join(BUILD_DIR, f"lib{src}-{_digest(src)}.so")
                libs[src] = lib
                if os.path.exists(lib):
                    continue
                tmp = f"{lib}.{os.getpid()}.tmp"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src + ".cu")]
                procs.append((src, tmp, lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        except OSError as e:  # no nvcc
            raise KernelError(f"nvcc could not start: {e}") from e
        errors = []
        for src, tmp, lib, p in procs:
            out, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc {src}.cu failed ({p.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise KernelError("\n".join(errors))
        return libs


def _load() -> dict:
    global _fns
    with _lock:
        if _fns is None:
            try:
                libs = {src: ctypes.CDLL(path) for src, path in build().items()}
            except OSError as e:
                raise KernelError(f"kernel library did not load: {e}") from e
            fns, grid_fns = {}, {}
            for name, (src, argtypes) in _SIGNATURES.items():
                fn = getattr(libs[src], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            for src, lib in libs.items():
                fn = lib.tt_grid_launches
                fn.argtypes = [_I, _I]
                fn.restype = ctypes.c_ulonglong
                grid_fns[src] = fn
            _grid_fns.update(grid_fns)
            _fns = fns
        return _fns


def _call(name: str, *args) -> None:
    # _fns is bound once, whole, under _lock: once set it is read without it
    err = (_fns or _load())[name](*args)
    if err != 0:
        raise KernelError(f"{name}: CUDA error {err}")


_SAME_DEVICE = contextlib.nullcontext()


def _on(dev: torch.device):
    """The device guard for a launch on dev, entered only where dev is
    not already the current device."""
    return _SAME_DEVICE if dev.index == torch.cuda.current_device() else torch.cuda.device(dev)


def _stream(dev: torch.device) -> int:
    # the raw cudaStream_t of dev's current stream, without building a
    # torch.cuda.Stream object (9 us a call on the card's host)
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device,
           shape: tuple | None = None) -> None:
    if t.device != device:
        raise KernelError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise KernelError(f"{name}: not contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise KernelError(f"CUDA kernel called with a tensor on {t.device}")
    return t.device


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


# ------------------------------------------------------------------ K4
def res_to_span(res: torch.Tensor, res_idx: torch.Tensor) -> torch.Tensor:
    """K4: res[clip(res_idx)] where res_idx >= 0 else PAD_I32.
    Bound: bytes (8 B a span row)."""
    dev = _cuda_device(res)
    _check(res, "res", torch.int32, dev)
    _check(res_idx, "res_idx", torch.int32, dev)
    if res.dim() != 1 or res_idx.dim() != 1 or res.shape[0] == 0:
        raise KernelError("res_to_span: 1-D res (non-empty) and res_idx expected")
    out = torch.empty_like(res_idx)
    with _on(dev):
        _call("tt_res_to_span", res.data_ptr(), res.shape[0], res_idx.data_ptr(),
              out.data_ptr(), res_idx.shape[0], _stream(dev))
    _count("res_to_span")
    return out


# ------------------------------------------------------------------ K3
FIND_BLOCKS = 64  # csrc/find.cu: block descriptors a launch
FIND_INLINE_Q = 32  # csrc/find.cu: queries carried in the launch's parameter


def _find_launch(dev: torch.device, B: int, desc, stack: torch.Tensor | None, q_host,
                 q_dev: torch.Tensor | None, Q: int, nv_dev: torch.Tensor | None,
                 n_steps: int) -> torch.Tensor:
    # desc and q_host are ctypes arrays: addressof is cheaper than a numpy
    # array's .ctypes.data, which builds an object on every call
    out = torch.empty((B, Q), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_find", None if desc is None else ctypes.addressof(desc), _ptr(stack),
              0 if stack is None else stack.shape[1], B,
              None if q_host is None else ctypes.addressof(q_host), _ptr(q_dev), Q,
              _ptr(nv_dev), int(n_steps), out.data_ptr(), _stream(dev))
    _count("find")
    return out


def find_rows(ids: torch.Tensor, queries: torch.Tensor, n_valid: torch.Tensor,
              n_steps: int) -> torch.Tensor:
    """K3 on a stack: (B,T,4) sorted id codes x (Q,4) queries -> (B,Q)
    row or -1, with n_valid (B,) on the device (the mesh bodies' form).
    One launch a chunk of FIND_BLOCKS blocks, its descriptors made by
    the launcher over the stack's slices. Bound: a chain of dependent
    loads (3 steps of a warp at T = 32,768) and the launch."""
    dev = _cuda_device(ids)
    _check(ids, "ids", torch.int32, dev)
    _check(queries, "queries", torch.int32, dev)
    _check(n_valid, "n_valid", torch.int32, dev)
    if ids.dim() != 3 or ids.shape[2] != 4 or queries.dim() != 2 or queries.shape[1] != 4:
        raise KernelError("find_rows: ids (B,T,4) and queries (Q,4) expected")
    B, T, _ = ids.shape
    if n_valid.shape != (B,) or T == 0:
        raise KernelError("find_rows: n_valid (B,) and T > 0 expected")
    if ids.data_ptr() % 16 or queries.data_ptr() % 16:
        raise KernelError("find_rows: ids and queries must be 16-byte aligned")
    return _find_launch(dev, B, None, ids, None, queries, queries.shape[0], n_valid, n_steps)


def find_blocks(tables: list, queries: np.ndarray, n_steps: int) -> torch.Tensor:
    """K3 over blocks' own indexes: tables = [(ids (T_b,4) int32 on one
    card, n_valid)] and queries (Q,4) int32 on the host -> (B,Q) row or
    -1. Nothing is stacked: each block is a descriptor (pointer, n_valid,
    T_b), and up to FIND_INLINE_Q queries ride in the launch's parameter
    (more take one upload). One launch a chunk of FIND_BLOCKS blocks."""
    if not tables:
        raise KernelError("find_blocks: no blocks")
    dev = _cuda_device(tables[0][0])
    flat = []
    for i, (t, n) in enumerate(tables):
        _check(t, "ids", torch.int32, dev)
        if t.dim() != 2 or t.shape[1] != 4 or t.shape[0] == 0 or not 0 <= n <= t.shape[0]:
            raise KernelError(f"find_blocks: block {i}: ids {tuple(t.shape)}, n_valid {n}")
        flat += (t.data_ptr(), n, t.shape[0])
    desc = (ctypes.c_longlong * len(flat))(*flat)
    queries = np.asarray(queries, dtype=np.int32)
    if queries.ndim != 2 or queries.shape[1] != 4:
        raise KernelError("find_blocks: queries (Q,4) expected")
    Q, B = queries.shape[0], len(tables)
    if Q <= FIND_INLINE_Q:
        q_host = (ctypes.c_int32 * (4 * Q))(*queries.ravel().tolist())
        return _find_launch(dev, B, desc, None, q_host, None, Q, None, n_steps)
    q_dev = torch.from_numpy(np.ascontiguousarray(queries)).to(dev)
    return _find_launch(dev, B, desc, None, None, q_dev, Q, None, n_steps)


# ------------------------------------------------------------------ K2
_SORT_TILE = 2048  # csrc/select.cuh TILE: the full sort's shortest padded length
SELECT_TILE = 4096  # rows of a tile-pass CTA at least (csrc/select.cu)
SELECT_BUF = 16384  # composites the merge pass holds in shared memory; the largest tile
SELECT_CANDS = 65536  # candidates at which the tile doubles: the merge pass is one CTA
K_SMALL = 2048  # the largest k on the two-pass route: chip_smoke.py's sweep (csrc/select.cu)


class SelectPlan(NamedTuple):
    """K2's route and scratch sizes for (n, k). `tiled`: the two-pass
    route (tt_select_tiled); else the full sort (tt_select)."""

    tiled: bool
    k_pad: int  # the power of two at or above k
    tile: int  # rows a tile-pass CTA takes (a power of two, >= 2 k_pad, <= SELECT_BUF)
    tiles: int  # tile-pass CTAs: ceil(n / tile); tiles * k_pad candidates
    buf: int  # composites the merge pass holds: SELECT_BUF, >= 2 k_pad
    n_pad: int  # the full sort's padded length
    scratch: int  # int64 words of scratch the route takes


def _tiled_plan(n: int, k: int) -> SelectPlan:
    k_pad = 1 << (k - 1).bit_length()
    tile = max(SELECT_TILE, 2 * k_pad)
    while tile < SELECT_BUF and -(-n // tile) * k_pad >= SELECT_CANDS:
        tile *= 2
    tiles = -(-n // tile)
    return SelectPlan(True, k_pad, tile, tiles, SELECT_BUF, 0,
                      tiles * k_pad + (tiles + 1) // 2)


def _sort_plan(n: int, k: int) -> SelectPlan:
    n_pad = max(_SORT_TILE, 1 << (n - 1).bit_length())
    return SelectPlan(False, 1 << (k - 1).bit_length(), 0, 0, 0, n_pad, n_pad)


def select_plan(n: int, k: int) -> SelectPlan:
    """The two-pass route for k <= K_SMALL where its candidates are
    fewer than the rows; the full sort otherwise."""
    plan = _tiled_plan(n, k)
    return plan if k <= K_SMALL and plan.tiles * plan.k_pad < n else _sort_plan(n, k)


def select_topk(mask: torch.Tensor, key: torch.Tensor, counts: torch.Tensor,
                k: int) -> torch.Tensor:
    """K2: packed [idx(k) | count(k) | valid(k) | n_match] int32 of the
    masked top-k by key, ties to the lower index (lax.top_k order).
    Bound: bytes (the mask, the key of each masked row, counts at the k
    winners, the output); the route is select_plan's."""
    return _select_run(mask, key, counts, k, None)


# the exports of each row-wise top-k: (two passes, full sort)
_SELECT_EXPORTS = {"select": ("tt_select_tiled", "tt_select"),
                   "mq_select": ("tt_mq_select_tiled", "tt_mq_select")}


def _select_run(mask, key, counts, k: int, plan: SelectPlan | None,
                name: str = "select") -> torch.Tensor:
    """K2 (name "select": mask (n,)) or B5b ("mq_select": mask (Q, n),
    each row selected alone, key shared) by plan, select_plan's when
    None; scratch: rows x the plan's, in one allocation."""
    dev = _cuda_device(mask)
    if mask.dim() != (1 if name == "select" else 2):
        raise KernelError(f"{name}: mask {'(n,)' if name == 'select' else '(Q, n)'} expected")
    n, rows = mask.shape[-1], (1 if mask.dim() == 1 else mask.shape[0])
    _check(mask, "mask", torch.bool, dev)
    _check(key, "key", torch.int32, dev, (n,))
    _check(counts, "counts", torch.int32, dev, tuple(mask.shape))
    if not 0 < k <= n:
        raise KernelError(f"{name}: need 0 < k <= n, got k={k} n={n}")
    plan = plan or select_plan(n, k)
    scratch = torch.empty(rows * plan.scratch, dtype=torch.int64, device=dev)
    out = torch.empty((*mask.shape[:-1], 3 * k + 1), dtype=torch.int32, device=dev)
    tiled, full = _SELECT_EXPORTS[name]
    with _on(dev):
        if plan.tiled:
            cand = scratch.data_ptr()
            _call(tiled, mask.data_ptr(), key.data_ptr(), counts.data_ptr(), n, rows, int(k),
                  plan.k_pad.bit_length() - 1, plan.tile, plan.tiles, plan.buf, cand,
                  cand + 8 * rows * plan.tiles * plan.k_pad, out.data_ptr(), _stream(dev))
        else:
            _call(full, mask.data_ptr(), key.data_ptr(), counts.data_ptr(), n, rows, int(k),
                  scratch.data_ptr(), plan.n_pad, out.data_ptr(), _stream(dev))
    _count(name)
    return out


# ------------------------------------------------------------------ K1
FILTER_TILE = 4096  # spans a trace tile holds at least (csrc/filter.cu: 8 a thread of 512)
FILTER_TILE_MAX = 16384  # the longest trace the tile route takes (int16 local rows)
FILTER_SMEM_MAX = 200 * 1024  # shared memory a tile CTA may take (227 KB on the H100)
_FT_MAX_SIBS = 32  # `~` nodes a flag word holds


class FilterPlan(NamedTuple):
    """K1's route for one program on one staged block. `tiled`: the
    trace-tile route (tt_filter_tiles); else the multi-launch kernels."""

    tiled: bool
    flag_pass: bool  # a first launch for the block-wide `~` orphan flags
    n_passes: int  # `>>` doubling passes: 2^n_passes >= the longest trace
    smem: int  # bytes of shared memory a tile CTA takes


MULTI_LAUNCH = FilterPlan(False, False, 0, 0)


def filter_tile_smem(prog, tile: int) -> int:
    """Shared memory of one tile CTA: a bit slot a program slot and one
    `>>` accumulator (tile / 32 words each), then for struct steps the
    int16 local parent row a span and 2 x tile int16 of scratch."""
    return 4 * (tile // 32) * (max(prog.n_slots, 1) + 1) + (6 * tile if prog.struct_steps else 0)


def filter_plan(prog, tiles, span_out: bool) -> FilterPlan:
    """The trace-tile route where the staged block's tiling (ops/filter.
    TraceTiles, computed at staging) makes it exact: the traces partition
    the rows and the longest fits a tile; for struct steps every parent
    row lies in its span's own trace; for span_out span.trace_sid agrees
    with the ranges; the tile's shared memory fits; and, where the block
    holds orphans and the program a `~`, at most 32 `~` nodes, none whose
    lhs another `~` feeds (its flag would need that `~`'s). Otherwise the
    multi-launch route. A pure function of the program and staging data."""
    if tiles is None or tiles.bounds is None or tiles.tile > FILTER_TILE_MAX:
        return MULTI_LAUNCH
    if prog.struct_steps and not tiles.parents_local:
        return MULTI_LAUNCH
    if span_out and not tiles.tsid_local:
        return MULTI_LAUNCH
    flag_pass = prog.n_sib > 0 and tiles.has_orphans
    if flag_pass and (prog.n_sib > _FT_MAX_SIBS or prog.sib_nested):
        return MULTI_LAUNCH
    smem = filter_tile_smem(prog, tiles.tile)
    if smem > FILTER_SMEM_MAX:
        return MULTI_LAUNCH
    return FilterPlan(True, flag_pass, max(1, (max(tiles.max_trace, 1) - 1).bit_length()), smem)


def filter_run(prog, buf: torch.Tensor, cols: dict, n_spans: int, n_traces: int,
               n_spans_b: int, n_res_b: int, n_traces_b: int, span_out: bool,
               tiles=None, plan: FilterPlan | None = None):
    """K1: run one compiled filter program (ops/filter._FilterProgram)
    whose descriptor/program/table buffer `buf` is already on the card,
    by the route `plan` names (default filter_plan(prog, tiles,
    span_out); tiles: the staged block's ops/filter.TraceTiles). A tiled
    plan other than filter_plan's is refused: only the multi-launch route
    may be forced.
    Returns (span_mask | None, trace_mask, counts). Bound: bytes -- one
    streaming read of every column the program touches."""
    dev = _cuda_device(buf)
    _check(buf, "program buffer", torch.uint8, dev)
    if plan is None:
        plan = filter_plan(prog, tiles, span_out)
    elif plan.tiled and plan != filter_plan(prog, tiles, span_out):
        raise KernelError("filter: the trace tiles are not exact for this program on this block")
    if plan.tiled:
        return _filter_tiles(prog, buf, cols, n_spans, n_traces, n_spans_b, n_res_b, n_traces_b,
                             span_out, tiles, plan)
    base = buf.data_ptr()
    desc = base + prog.desc_off
    st = _stream(dev)
    need = ["trace.span_off"] + (["span.trace_sid"] if span_out else [])
    if prog.struct_steps:
        need.append("span.parent_idx")
    if prog.rconds:
        need.append("span.res_idx")
    for name in need:
        if name not in cols:
            raise KernelError(f"filter: staged column {name} missing")
        _check(cols[name], name, torch.int32, dev)
    slots = torch.empty((max(prog.n_slots, 1), n_spans_b), dtype=torch.uint8, device=dev)
    resmask = (torch.empty((len(prog.rconds), n_res_b), dtype=torch.uint8, device=dev)
               if prog.rconds else None)
    trace_mask = torch.empty(n_traces_b, dtype=torch.bool, device=dev)
    counts = torch.empty(n_traces_b, dtype=torch.int32, device=dev)
    slot_stride = n_spans_b
    with _on(dev):
        if prog.rconds:
            _call("tt_filter_res_pass", desc, base + prog.rconds_off, len(prog.rconds),
                  n_res_b, resmask.data_ptr(), st)
        scratch_i = scratch_u = None
        if any(op == ">>" for op, *_ in prog.struct_steps):
            scratch_i = torch.empty(2 * n_spans_b, dtype=torch.int32, device=dev)
            scratch_u = torch.empty(2 * n_spans_b, dtype=torch.uint8, device=dev)
        elif prog.struct_steps:
            scratch_i = torch.empty(n_spans_b + 1, dtype=torch.int32, device=dev)
        n_passes = max(1, (n_spans_b - 1).bit_length())
        for step in prog.steps:
            if step[0] == "span":
                _, off, ln, out_slot = step
                _call("tt_filter_span_pass", base + off, ln, desc, slots.data_ptr(),
                      slots.data_ptr() + out_slot * slot_stride, n_spans_b, n_spans,
                      _ptr(resmask), n_res_b, _ptr(cols.get("span.res_idx")), st)
            else:
                _, op, lslot, rslot, out_slot = step
                _call("tt_filter_struct", {">": 0, ">>": 1, "~": 2}[op],
                      slots.data_ptr() + lslot * slot_stride,
                      slots.data_ptr() + rslot * slot_stride,
                      slots.data_ptr() + out_slot * slot_stride,
                      cols["span.parent_idx"].data_ptr(), n_spans_b, n_spans, n_passes,
                      _ptr(scratch_i), _ptr(scratch_u), 0, n_spans_b, st)
        _call("tt_filter_trace_pass", base + prog.trace_off, prog.trace_len, desc,
              slots.data_ptr(), base + prog.tslots_off, len(prog.tslots), n_spans_b, n_spans,
              cols["trace.span_off"].data_ptr(), n_traces, n_traces_b, trace_mask.data_ptr(),
              None if span_out else counts.data_ptr(), st)
        span_mask = None
        if span_out:
            span_mask = torch.empty(n_spans_b, dtype=torch.bool, device=dev)
            _call("tt_filter_span_epilogue", slots.data_ptr(), base + prog.tslots_off,
                  len(prog.tslots), n_spans_b, n_spans, cols["span.trace_sid"].data_ptr(),
                  trace_mask.data_ptr(), n_traces_b, cols["trace.span_off"].data_ptr(),
                  span_mask.data_ptr(), counts.data_ptr(), st)
    _count("filter")
    return span_mask, trace_mask, counts


def _filter_tiles(prog, buf, cols, n_spans, n_traces, n_spans_b, n_res_b, n_traces_b, span_out,
                  tiles, plan: FilterPlan):
    """K1's trace-tile route: one tile CTA a tile of whole traces (csrc/
    filter.cu filter_tile_kernel), one __global__ a program (two with the
    res pass or the flag pass, three with both). One allocation holds
    every output and the pass's scratch: counts | tile flags |
    trace_mask | span_mask | res mask."""
    dev = buf.device
    if tiles is None or tiles.bounds is None or (tiles.n_spans, tiles.n_traces_b) != (
            n_spans, n_traces_b):
        raise KernelError("filter: the trace-tile route needs this staged block's tiles")
    n_tiles = tiles.bounds.shape[0] - 1
    _check(tiles.bounds, "tile bounds", torch.int32, dev, (n_tiles + 1,))

    def staged(name):
        if name not in cols:
            raise KernelError(f"filter: staged column {name} missing")
        _check(cols[name], name, torch.int32, dev,
               (n_traces_b + 1,) if name == "trace.span_off" else (n_spans_b,))
        return cols[name]

    span_off = staged("trace.span_off")
    pidx = staged("span.parent_idx") if prog.struct_steps else None
    res_idx = staged("span.res_idx") if prog.rconds else None
    n_flags = n_tiles if plan.flag_pass else 0
    n_rc = len(prog.rconds)
    o_tm = 4 * (n_traces_b + n_flags)
    o_sm = o_tm + n_traces_b
    o_rm = o_sm + (n_spans_b if span_out else 0)
    raw = torch.empty(o_rm + n_rc * n_res_b, dtype=torch.uint8, device=dev)
    p = raw.data_ptr()
    counts = raw[:4 * n_traces_b].view(torch.int32)
    trace_mask = raw[o_tm:o_sm].view(torch.bool)
    span_mask = raw[o_sm:o_rm].view(torch.bool) if span_out else None
    base = buf.data_ptr()
    with _on(dev):
        _call("tt_filter_tiles", base, base + prog.steps_off, len(prog.steps), prog.last_sib,
              max(prog.n_slots, 1), base + prog.desc_off, base + prog.trace_off, prog.trace_len,
              base + prog.tslots_off, len(prog.tslots), base + prog.rconds_off, n_rc,
              p + o_rm if n_rc else None, n_res_b, _ptr(res_idx), _ptr(pidx),
              span_off.data_ptr(), tiles.bounds.data_ptr(), n_tiles, tiles.tile,
              plan.n_passes, n_spans, n_spans_b, n_traces, p + 4 * n_traces_b if n_flags else None,
              p + o_tm, p, p + o_sm if span_out else None, plan.smem, _stream(dev))
    _count("filter")
    return span_mask, trace_mask, counts


# ------------------------------------------------------------------ B5a
MQ_MAX = (32, 16, 8, 16, 16, 8)  # csrc/multiquery.cu MQ_P, MQ_NC, MQ_NG, MQ_PT, MQ_NA, MQ_TC
MQ_W = 296  # csrc/multiquery.cu MQ_W: int32 words of one packed program row


def multiquery(progs: torch.Tensor, dims: tuple, col_ptrs: torch.Tensor, n_sc: int, n_tc: int,
               span_off: torch.Tensor, n_spans: int, n_traces: int, n_traces_b: int,
               n_spans_b: int):
    """B5a: q_b packed CNF programs (progs (q_b, MQ_W) int32, table dims
    (P, NC, NG, PT, NA, TC)) over one staged block whose span columns
    (n_spans_b rows each: a negative span offset counts from their end,
    as the reference gathers it) and then trace columns are the n_sc +
    n_tc int64 device pointers of col_ptrs. Returns (tm (q_b,
    n_traces_b) bool, counts int32).
    One launch: a grid sized to the card walks tiles of traces; each CTA
    compiles a chunk of 32 / P programs in shared memory into one
    condition word a span (equality conditions by one hash probe a
    column) and, for monotone offsets, word operations for its clauses,
    groups and unions. Each span's column words are read from device
    memory once a chunk. Bound: bytes (the named span columns once, the
    outputs)."""
    dev = _cuda_device(progs)
    q_b = progs.shape[0]
    _check(progs, "progs", torch.int32, dev, (q_b, MQ_W))
    _check(col_ptrs, "col_ptrs", torch.int64, dev, (max(n_sc + n_tc, 1),))
    _check(span_off, "span_off", torch.int32, dev, (n_traces_b + 1,))
    if len(dims) != 6 or any(not 1 <= d <= m for d, m in zip(dims, MQ_MAX)):
        raise KernelError(f"multiquery: program dims {dims} outside {MQ_MAX}")
    tm = torch.empty((q_b, n_traces_b), dtype=torch.bool, device=dev)
    counts = torch.empty((q_b, n_traces_b), dtype=torch.int32, device=dev)
    base = col_ptrs.data_ptr()
    with _on(dev):
        _call("tt_multiquery", progs.data_ptr(), q_b, *(int(d) for d in dims), base, n_sc,
              base + 8 * n_sc, n_tc, span_off.data_ptr(), int(n_spans), int(n_spans_b),
              int(n_traces), n_traces_b, tm.data_ptr(), counts.data_ptr(), _stream(dev))
    _count("multiquery")
    return tm, counts


# ------------------------------------------------------------------ B5b
def mq_select(tm: torch.Tensor, key: torch.Tensor, counts: torch.Tensor, k: int) -> torch.Tensor:
    """B5b: K2's masked top-k on every row of tm (Q, n); key (n,) is
    shared by the rows. Returns (Q, 3k+1) int32 rows [idx(k) | count(k) |
    valid(k) | n_match]. The route is select_plan(n, k)'s, as K2's: two
    passes (a tile pass over (tiles, Q) CTAs reading the mask and key
    once, a merge CTA a row; 2 launches) where it takes the tiles, else
    the full sort over all rows at once. Bound: bytes (the mask, the
    key, counts at the Q x k winners, the output)."""
    return _select_run(tm, key, counts, k, None, "mq_select")


# ------------------------------------------------------------------ B6
TS_THREADS = 512  # csrc/timeseries.cu TS_THREADS
TS_ROUND = 2048  # spans a CTA a round on the cluster route (csrc/timeseries.cu TS_ROUND)
TS_EXCH = 4 * (72 + 2 * TS_ROUND)  # bytes of a cluster-route CTA's counters and outbox
TS_SMEM_CTA = 96 * 1024  # shared memory a CTA of the shared / cluster routes aims at (2 a SM)
TS_SMEM_MAX = 200 * 1024  # shared memory a CTA may take (csrc/timeseries.cu TS_SMEM_CTA_MAX)
TS_SHARED_CLUSTER = 8  # CTAs whose private grids one cluster reduces on the shared route
TS_CLUSTER = 16  # CTAs a cluster on the cluster route (16: the H100's non-portable size)
TS_ROUTES = ("global", "shared", "cluster")  # csrc/timeseries.cu's route codes


class TsPlan(NamedTuple):
    """B6's route for a grid of `cells` (group, bucket) cells: "shared"
    (a private copy of the grid in each CTA's shared memory; clusters of
    `cluster` CTAs reduce their copies and add them into the output with
    device atomics), "cluster" (the grid spread over
    a cluster of `cluster` CTAs, `per` cells of each plane a CTA, spans
    routed to their cell's owner) or "global" (device-memory atomics);
    `smem` bytes a CTA."""

    route: str
    cluster: int
    per: int
    smem: int


def timeseries_route(route: str, cells: int, has_val: bool) -> TsPlan:
    """The plan of `route` for a grid of `cells` cells: "shared" a private
    grid a CTA in clusters of TS_SHARED_CLUSTER, "cluster" the grid over
    TS_CLUSTER CTAs, "global" device-memory atomics. Raises where the
    grid does not fit the route's shared memory (TS_SMEM_MAX a CTA). Pass
    it to timeseries(plan=) to force a route."""
    words = 4 * (5 if has_val else 1)
    if route == "global":
        return TsPlan("global", 1, 0, 0)
    if route == "shared":
        p = TsPlan("shared", TS_SHARED_CLUSTER, cells, words * cells)
    elif route == "cluster":
        per = -(-cells // TS_CLUSTER)
        p = TsPlan("cluster", TS_CLUSTER, per, words * per + TS_EXCH)
    else:
        raise KernelError(f"timeseries: no route {route!r}")
    if p.smem > TS_SMEM_MAX:
        raise KernelError(f"timeseries: the {route} route cannot hold {cells} cells")
    return p


def timeseries_plan(cells: int, has_val: bool) -> TsPlan:
    """The shared route while the A planes (5 with values, else 1) fit a
    CTA's TS_SMEM_CTA; past that, a value grid takes the cluster route
    while each CTA's share and the record outbox fit TS_SMEM_MAX, and a
    counts-only grid the global route (one native atomic a span, which
    beat the cluster route in chip_smoke.py's sweep); past the cluster,
    the global route. A pure function of the grid."""
    if 4 * (5 if has_val else 1) * cells <= TS_SMEM_CTA:
        return timeseries_route("shared", cells, has_val)
    if has_val:
        with contextlib.suppress(KernelError):
            return timeseries_route("cluster", cells, has_val)
    return timeseries_route("global", cells, has_val)


_ts_ctas: dict = {}


def _timeseries_ctas(dev: torch.device, plan: TsPlan) -> int:
    """CTAs of plan's route that can be co-resident on dev (the
    cooperative launch's limit), asked of the device once a route."""
    key = (dev.index, plan.route, plan.cluster, plan.smem)
    if key not in _ts_ctas:
        n = ctypes.c_int(0)
        with _on(dev):
            _call("tt_timeseries_ctas", TS_ROUTES.index(plan.route), plan.cluster, plan.smem,
                  ctypes.byref(n))
        if n.value < plan.cluster:
            raise KernelError(f"timeseries: no co-resident grid for {plan}")
        _ts_ctas[key] = n.value
    return _ts_ctas[key]


def _timeseries_grid(dev: torch.device, plan: TsPlan, n_spans: int) -> int:
    """The grid of one call: what the spans fill (a multiple of the
    cluster), at most what is co-resident."""
    c = plan.cluster
    ctas = min(_timeseries_ctas(dev, plan), max(1, -(-n_spans // (TS_THREADS * c))) * c)
    return ctas - ctas % c


@functools.lru_cache(maxsize=256)
def _timeseries_launch(dev: torch.device, cells: int, has_val: bool, n_spans: int):
    """(timeseries_plan's route, its grid) for a shape, worked out once."""
    plan = timeseries_plan(cells, has_val)
    return plan, _timeseries_grid(dev, plan, n_spans)


def timeseries_views(packed: torch.Tensor, has_val: bool, n_groups: int, n_buckets: int):
    """The planes of one packed B6 output (int32, A x n_groups x n_buckets
    words; words past them are scratch): (counts,) or (counts, vcnt,
    vsum, vmin, vmax), vsum, vmin and vmax as f32 views."""
    cells = n_groups * n_buckets
    if not has_val:
        return (packed[:cells].view(n_groups, n_buckets),)
    planes = packed[:5 * cells].view(5, n_groups, n_buckets)
    counts, vcnt = planes.unbind(0)[:2]
    return (counts, vcnt) + planes.view(torch.float32).unbind(0)[2:]


def timeseries_fold(prog, buf: torch.Tensor, cols: dict, start_ms: torch.Tensor, gid: torch.Tensor,
                    val: torch.Tensor | None, vpres: torch.Tensor | None, t0: int, step: int,
                    n_spans: int, n_res_b: int, n_traces_b: int, n_buckets: int, n_groups: int,
                    plan: TsPlan | None = None) -> torch.Tensor:
    """B6: the span program of `prog` (ops/timeseries._SpanProgram, its
    descriptor buffer `buf` on the card) -> one packed int32 allocation
    (timeseries_views' layout, then the cluster route's partial grids),
    by the route `plan` names (default timeseries_plan; timeseries_route
    forces one). One __global__ (after the res pass of a program with
    resource.attr conditions).
    Bound: bytes -- one read of every column the program names plus
    start_ms, gid, val and vpres, the accumulators written once."""
    dev = _cuda_device(buf)
    _check(buf, "program buffer", torch.uint8, dev)
    n_spans_b = start_ms.shape[0]
    _check(start_ms, "span.start_ms", torch.int32, dev, (n_spans_b,))
    _check(gid, "gid", torch.int32, dev, (n_spans_b,))
    has_val = val is not None
    if has_val:
        _check(val, "val", torch.float32, dev, (n_spans_b,))
        _check(vpres, "vpres", torch.bool, dev, (n_spans_b,))
    _check(cols["span.trace_sid"], "span.trace_sid", torch.int32, dev)
    if prog.rconds:
        _check(cols["span.res_idx"], "span.res_idx", torch.int32, dev)
    cells = n_groups * n_buckets
    if step < 1 or not 0 < n_buckets or not 0 < n_groups or not 0 <= n_spans <= n_spans_b \
            or cells > 1 << 24:
        raise KernelError(f"timeseries: step {step}, {n_groups} x {n_buckets} cells, "
                          f"{n_spans} spans of {n_spans_b}")
    if plan is None:
        plan, ctas = _timeseries_launch(dev, cells, has_val, n_spans)
    elif plan != timeseries_route(plan.route, cells, has_val):
        raise KernelError(f"timeseries: plan {plan} refused for {cells} cells")
    else:
        ctas = _timeseries_grid(dev, plan, n_spans)
    c = plan.cluster
    n_planes = 5 if has_val else 1
    n_out = n_planes * cells
    scratch = (ctas // c) * n_out if plan.route == "cluster" else 0
    packed = torch.empty(n_out + scratch, dtype=torch.int32, device=dev)
    resmask = (torch.empty((len(prog.rconds), n_res_b), dtype=torch.uint8, device=dev)
               if prog.rconds else None)
    (_, off, ln, _), = prog.steps
    base, p = buf.data_ptr(), packed.data_ptr()
    with _on(dev):
        _call("tt_timeseries", base + prog.desc_off, base + off, ln, base + prog.rconds_off,
              len(prog.rconds), _ptr(resmask), n_res_b, _ptr(cols.get("span.res_idx")),
              cols["span.trace_sid"].data_ptr(), n_traces_b, start_ms.data_ptr(), gid.data_ptr(),
              _ptr(val), _ptr(vpres), int(t0), int(step), int(n_spans), int(n_buckets),
              int(n_groups), int(has_val), TS_ROUTES.index(plan.route), c, plan.per, plan.smem,
              ctas, p + 4 * n_out if scratch else None, p, _stream(dev))
    _count("timeseries")
    return packed


def timeseries(prog, buf: torch.Tensor, cols: dict, start_ms: torch.Tensor, gid: torch.Tensor,
               val: torch.Tensor | None, vpres: torch.Tensor | None, t0: int, step: int,
               n_spans: int, n_res_b: int, n_traces_b: int, n_buckets: int, n_groups: int,
               plan: TsPlan | None = None):
    """B6 -> (n_groups, n_buckets) accumulators: (counts,) or (counts,
    vcnt, vsum, vmin, vmax), views of timeseries_fold's one allocation."""
    return timeseries_views(
        timeseries_fold(prog, buf, cols, start_ms, gid, val, vpres, t0, step, n_spans, n_res_b,
                        n_traces_b, n_buckets, n_groups, plan),
        val is not None, n_groups, n_buckets)


# ------------------------------------------------------------------ B9a
def remap_codes(col: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """B9a: where(col >= 0, remap[min(col, r - 1)], col) over an int32
    code column. Bound: bytes (8 B a code; the table stays in L2)."""
    dev = _cuda_device(col)
    _check(col, "col", torch.int32, dev)
    _check(remap, "remap", torch.int32, dev)
    if col.dim() != 1 or remap.dim() != 1 or remap.shape[0] == 0:
        raise KernelError("remap_codes: 1-D col and a non-empty 1-D remap expected")
    out = torch.empty_like(col)
    with _on(dev):
        _call("tt_remap", col.data_ptr(), col.shape[0], remap.data_ptr(), remap.shape[0],
              out.data_ptr(), _stream(dev))
    _count("remap")
    return out


# ------------------------------------------------------------------ B9b
def bloom_bits(words: torch.Tensor, word_idx: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """B9b: a copy of words (any shape, uint32 bit patterns in int32)
    with bits[i] ORed into flat word word_idx[i]. Bound: bytes (the
    words read and written once, 8 B a pair)."""
    dev = _cuda_device(words)
    _check(words, "words", torch.int32, dev)
    m = word_idx.shape[0]
    _check(word_idx, "word_idx", torch.int32, dev, (m,))
    _check(bits, "bits", torch.int32, dev, (m,))
    out = torch.empty_like(words)
    with _on(dev):
        _call("tt_bloom_bits", words.data_ptr(), words.numel(), word_idx.data_ptr(),
              bits.data_ptr(), m, out.data_ptr(), _stream(dev))
    _count("bloom_bits")
    return out


# ------------------------------------------------------------------ B9c
def rowgroup_minmax(start_ms: torch.Tensor, dur_us: torch.Tensor, group: int) -> torch.Tensor:
    """B9c: (3, G) int32 rows [min start_ms | max start_ms | max dur_us]
    of the contiguous groups of `group` rows (the last one partial).
    Bound: bytes (8 B a span)."""
    dev = _cuda_device(start_ms)
    n = start_ms.shape[0]
    _check(start_ms, "start_ms", torch.int32, dev, (n,))
    _check(dur_us, "dur_us", torch.int32, dev, (n,))
    if n == 0 or group < 1:
        raise KernelError(f"rowgroup_minmax: {n} rows in groups of {group}")
    n_groups = -(-n // group)
    out = torch.empty((3, n_groups), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_rowgroup", start_ms.data_ptr(), dur_us.data_ptr(), n, int(group),
              out.data_ptr(), n_groups, _stream(dev))
    _count("rowgroup")
    return out


# ------------------------------------------------------------------ B10a
def bloom_union(stacked: torch.Tensor) -> torch.Tensor:
    """B10a: OR-reduce of (K, S, W) uint32 blooms (int32 storage) ->
    (S, W). Bound: bytes (K + 1 words moved per output word)."""
    dev = _cuda_device(stacked)
    _check(stacked, "stacked", torch.int32, dev)
    if stacked.dim() != 3 or stacked.shape[0] == 0:
        raise KernelError("bloom_union: (K, S, W) with K > 0 expected")
    out = torch.empty(stacked.shape[1:], dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_bloom_union", stacked.data_ptr(), stacked.shape[0], out.numel(),
              out.data_ptr(), _stream(dev))
    _count("bloom_union")
    return out


# ------------------------------------------------------------------ B10b
def bloom_test(words: torch.Tensor, word_idx: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    """B10b: words (S, W) uint32 (int32 storage), word_idx (Q, K, 2)
    [shard, word], bit_idx (Q, K) -> (Q,) bool: every bit set. Bound:
    bytes (K words and K index triples a query)."""
    dev = _cuda_device(words)
    _check(words, "words", torch.int32, dev)
    if words.dim() != 2 or 0 in words.shape:
        raise KernelError("bloom_test: non-empty (S, W) words expected")
    q, k = bit_idx.shape if bit_idx.dim() == 2 else (-1, -1)
    _check(bit_idx, "bit_idx", torch.int32, dev, (q, k))
    _check(word_idx, "word_idx", torch.int32, dev, (q, k, 2))
    out = torch.empty(q, dtype=torch.bool, device=dev)
    with _on(dev):
        _call("tt_bloom_test", words.data_ptr(), words.shape[0], words.shape[1],
              word_idx.data_ptr(), bit_idx.data_ptr(), q, k, out.data_ptr(), _stream(dev))
    _count("bloom_test")
    return out


# ------------------------------------------------------------------ B7a
LIVE_CHUNK = 32  # query codes a launch carries by value (csrc/livestage.cu)
_live_scratch: dict = {}  # (device, stream) -> (hit words, [epoch])
_live_lock = threading.Lock()


def _live_stream_scratch(dev: torch.device, stream: int, slot_b: int, launches: int):
    """B7a's words on one stream: slot_b 64-bit hit words tagged with the
    call's epoch, zero when made, and the host's [epoch] the launcher
    advances. Calls on one stream run in order, and the caller holds
    _live_lock, so no two calls share an epoch. A new set is made for a
    larger bucket and before the 32-bit epoch would wrap."""
    key = (dev.index, stream)
    got = _live_scratch.get(key)
    if got is None or got[0].shape[0] < slot_b or got[1][0] + launches > 2**32 - 1:
        got = _live_scratch[key] = (torch.zeros(slot_b, dtype=torch.int64, device=dev),
                                    (ctypes.c_uint64 * 1)(1))
    return got


def live_filter(slots: tuple, kv: tuple, names: tuple, codes, n_tags: int,
                t0: int | None, t1: int | None, dmin: int | None, n_slots: int,
                n_kv: int | None = None, n_name: int | None = None) -> torch.Tensor:
    """B7a: the live head's slot mask. slots = (start_s, end_s, dur_ms,
    alive), each (slot_b,) int32; kv and names = (owner, code) row
    columns, of which the first n_kv / n_name are real (None: all) and
    the rest the stager's padding, owner 0 and code PAD_I32; codes =
    n_tags tag codes then the name codes, as ints (carried by value: no
    upload); t0, t1, dmin are the clipped thresholds, None where the
    filter is off. Returns (slot_b,) bool. One cooperative launch a
    chunk of LIVE_CHUNK codes (one for none), no memset. Bound: bytes (17 B a slot, 4 B a real row of
    a kind with a code, 4 B a row that hits)."""
    dev = _cuda_device(slots[3])
    slot_b = slots[0].shape[0]
    for name, t in zip(("start_s", "end_s", "dur_ms", "alive"), slots):
        _check(t, name, torch.int32, dev, (slot_b,))
    rows = []
    for kind, (owner, code), n_real in (("kv", kv, n_kv), ("name", names, n_name)):
        _check(owner, f"{kind}_owner", torch.int32, dev)
        _check(code, f"{kind}_code", torch.int32, dev, tuple(owner.shape))
        if owner.dim() != 1:
            raise KernelError(f"live_filter: 1-D {kind} rows expected")
        b = owner.shape[0]
        n_real = b if n_real is None else int(n_real)
        if not 0 <= n_real <= b:
            raise KernelError(f"live_filter: {n_real} real {kind} rows of {b}")
        rows.append((n_real, b))
    if isinstance(codes, torch.Tensor) and codes.device.type != "cpu":
        raise KernelError("live_filter: codes on the card; pass them as ints")
    q = [int(c) for c in (codes.tolist() if isinstance(codes, torch.Tensor) else codes)]
    if (not 0 <= n_tags <= len(q) or slot_b == 0
            or any(c < -(2**31) or c >= 2**31 for c in q)):
        raise KernelError(f"live_filter: {len(q)} int32 codes with {n_tags} tags over "
                          f"{slot_b} slots")
    stream = _stream(dev)
    mask = torch.empty(slot_b, dtype=torch.bool, device=dev)
    flags = [(0, 0) if v is None else (1, int(v)) for v in (t0, t1, dmin)]
    cols = [t.data_ptr() for t in slots]
    n_tags = int(n_tags)
    with _on(dev), _live_lock:
        chunks = range(0, max(len(q), 1), LIVE_CHUNK)
        hit, state = _live_stream_scratch(dev, stream, slot_b, len(chunks))
        for lo in chunks:
            chunk = q[lo:lo + LIVE_CHUNK]
            arr = (ctypes.c_int32 * LIVE_CHUNK)(*chunk)
            _call("tt_live_filter", *cols, slot_b, kv[0].data_ptr(), kv[1].data_ptr(),
                  *rows[0], names[0].data_ptr(), names[1].data_ptr(), *rows[1],
                  ctypes.addressof(arr), min(max(n_tags - lo, 0), len(chunk)), len(chunk),
                  *flags[0], *flags[1], *flags[2], int(n_slots), int(lo == 0), hit.data_ptr(),
                  ctypes.addressof(state), mask.data_ptr(), stream)
    _count("live_filter")
    return mask


# ------------------------------------------------------------------ B7b
def live_find(id_codes: torch.Tensor, alive: torch.Tensor, codes, n_slots: int) -> torch.Tensor:
    """B7b: (1,) int32, the first slot < n_slots that is alive and whose
    4 id codes equal `codes` (4 ints, passed to the kernel as its
    arguments), else -1. One launch: a thread-block cluster of one CTA a
    2,048 slots (at most 8), one CTA without a cluster where that is all.
    Bound: bytes (20 B a slot); the launch is the cost."""
    dev = _cuda_device(id_codes)
    slot_b = id_codes.shape[0]
    _check(id_codes, "id_codes", torch.int32, dev, (slot_b, 4))
    _check(alive, "alive", torch.int32, dev, (slot_b,))
    q = [int(c) for c in codes]
    if len(q) != 4 or min(q) < -(2**31) or max(q) >= 2**31:
        raise KernelError(f"live_find: 4 int32 codes expected, got {q}")
    if id_codes.data_ptr() % 16:
        raise KernelError("live_find: id_codes must be 16-byte aligned")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_live_find", id_codes.data_ptr(), alive.data_ptr(), slot_b,
              max(-(2**31), min(int(n_slots), 2**31 - 1)), *q, out.data_ptr(), _stream(dev))
    _count("live_find")
    return out


# ------------------------------------------------------------------ B7c
def live_append(dst: torch.Tensor, src: torch.Tensor, start: int) -> torch.Tensor:
    """B7c: a new column equal to dst with src written at start; a
    negative start counts from the end, and the start is clamped to
    [0, len(dst) - len(src)] (dynamic_update_slice). Bound: bytes (dst
    read, src read, the column written)."""
    dev = _cuda_device(dst)
    n, m = dst.shape[0], src.shape[0]
    _check(dst, "dst", torch.int32, dev, (n,))
    _check(src, "src", torch.int32, dev, (m,))
    if m > n or n == 0:
        raise KernelError(f"live_append: {m} rows into a column of {n}")
    out = torch.empty_like(dst)
    with _on(dev):
        _call("tt_live_append", dst.data_ptr(), n, src.data_ptr(), m, int(start),
              out.data_ptr(), _stream(dev))
    _count("live_append")
    return out


# ------------------------------------------------------------------ B7d
def live_patch(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """B7d: a new column equal to dst ((n,) or (n, 4) int32) with rows
    idx set to vals; a negative index counts from the end, one still
    outside [0, n) is dropped. Bound: bytes (the column read and written,
    the index and values read)."""
    dev = _cuda_device(dst)
    if dst.dim() not in (1, 2):
        raise KernelError("live_patch: (n,) or (n, w) column expected")
    n, width = dst.shape[0], (dst.shape[1] if dst.dim() == 2 else 1)
    m = idx.shape[0]
    _check(dst, "dst", torch.int32, dev)
    _check(idx, "idx", torch.int32, dev, (m,))
    _check(vals, "vals", torch.int32, dev, (m,) + tuple(dst.shape[1:]))
    out = torch.empty_like(dst)
    with _on(dev):
        _call("tt_live_patch", dst.data_ptr(), n, width, idx.data_ptr(), vals.data_ptr(), m,
              out.data_ptr(), _stream(dev))
    _count("live_patch")
    return out


# ------------------------------------------------------------------ B8a/B8b
REDUCE_MAX_EDGES = 256  # csrc/reduce.cu RD_MAX_EDGES


def _reduce_args(name: str, ids: torch.Tensor, rows: dict, n_valid: int, edges: torch.Tensor,
                 n_ids: int) -> torch.device:
    dev = _cuda_device(ids)
    n = ids.shape[0]
    _check(ids, "ids", torch.int32, dev, (n,))
    for col, (t, dtype) in rows.items():
        _check(t, col, dtype, dev, (n,))
    _check(edges, "edges", torch.float32, dev)
    if edges.dim() != 1 or edges.shape[0] > REDUCE_MAX_EDGES:
        raise KernelError(f"{name}: 1-D edges of at most {REDUCE_MAX_EDGES} expected")
    if not 0 <= n_valid <= n or n_ids < 1 or n_ids * (edges.shape[0] + 1) >= 2**31:
        raise KernelError(f"{name}: {n_valid} valid rows of {n} into {n_ids} ids")
    return dev


def span_views(packed: torch.Tensor, n_ids: int, nb: int):
    """The three outputs of one packed B8a table (int32, row s = [calls,
    f32 sum bits, hist (nb)], nb + 2 words a row): calls (n_ids,) int32,
    lat_sum (n_ids,) f32, hist (n_ids, nb) int32, as strided views."""
    t = packed[:n_ids * (nb + 2)].view(n_ids, nb + 2)
    return t[:, 0], t.view(torch.float32)[:, 1], t[:, 2:]


def span_fold(sid: torch.Tensor, dur: torch.Tensor, n_valid: int, edges: torch.Tensor,
              n_ids: int) -> torch.Tensor:
    """B8a: rows i < n_valid with 0 <= sid[i] < n_ids -> one packed int32
    allocation (span_views' layout): one memset, then the atomic fold.
    Bound: bytes (8 B a row, the table written once)."""
    dev = _reduce_args("span_reduce", sid, {"dur": (dur, torch.float32)}, n_valid, edges, n_ids)
    nb = edges.shape[0] + 1
    packed = torch.empty(n_ids * (nb + 2), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_span_reduce", sid.data_ptr(), dur.data_ptr(), int(n_valid), edges.data_ptr(),
              nb - 1, int(n_ids), packed.data_ptr(), _stream(dev))
    _count("span_reduce")
    return packed


def span_reduce(sid: torch.Tensor, dur: torch.Tensor, n_valid: int, edges: torch.Tensor,
                n_ids: int):
    """B8a -> calls (n_ids,) int32, lat_sum (n_ids,) f32, hist (n_ids,
    len(edges) + 1) int32, the bucket being searchsorted(edges, dur,
    'left'): views of span_fold's one allocation."""
    return span_views(span_fold(sid, dur, n_valid, edges, n_ids), n_ids, edges.shape[0] + 1)


REDUCE_SMEM = 48 * 1024  # shared memory of a B8b tile CTA at most (no opt-in needed)
REDUCE_CTAS = 132  # SMs of an H100 SXM: the tile route spreads small tables over them
# CTAs x rows at most on the tile route: chip_smoke.py's sweep (the tile
# route won at 1,490,944 id reads and lost at 8,388,608)
EDGE_TILE_READS = 1 << 21


class EdgePlan(NamedTuple):
    """B8b's route for (n_valid, n_ids, nb). `tiled`: edge_tile_kernel, a
    CTA a range of `per` ids in `smem` bytes of shared memory; else one
    memset and the atomic fold."""

    tiled: bool
    per: int
    ctas: int
    smem: int


def edge_plan(n_valid: int, n_ids: int, nb: int) -> EdgePlan:
    """The tile route while every CTA re-reading every row's id costs
    little (CTAs x n_valid <= EDGE_TILE_READS); the atomic route past it."""
    words = 4 + 2 * nb
    cap = max(1, (REDUCE_SMEM - 4 * (nb - 1)) // (4 * words))
    per = max(1, min(cap, -(-n_ids // REDUCE_CTAS)))
    ctas = -(-n_ids // per)
    return EdgePlan(ctas * n_valid <= EDGE_TILE_READS, per, ctas, 4 * (per * words + nb - 1))


def edge_views(packed: torch.Tensor, n_ids: int, nb: int):
    """The six outputs of one packed B8b buffer (int32, n_ids x (4 + 2
    nb) words): counts, failed_counts (n_ids,) int32, client_sum,
    server_sum (n_ids,) f32, client_hist, server_hist (n_ids, nb) int32."""
    n, cells = n_ids, n_ids * nb
    return (packed[:n], packed[n:2 * n], packed[2 * n:3 * n].view(torch.float32),
            packed[3 * n:4 * n].view(torch.float32),
            packed[4 * n:4 * n + cells].view(n_ids, nb),
            packed[4 * n + cells:4 * n + 2 * cells].view(n_ids, nb))


def edge_fold(eid: torch.Tensor, cdur: torch.Tensor, sdur: torch.Tensor, failed: torch.Tensor,
              n_valid: int, edges: torch.Tensor, n_ids: int,
              plan: EdgePlan | None = None) -> torch.Tensor:
    """B8b: the six per-edge folds of one window in one pass, into one
    packed int32 allocation (edge_views' layout), by the route `plan`
    names (default edge_plan). Bound: bytes (16 B a row, the tables
    written once)."""
    dev = _reduce_args("edge_reduce", eid, {"cdur": (cdur, torch.float32),
                                            "sdur": (sdur, torch.float32),
                                            "failed": (failed, torch.int32)},
                       n_valid, edges, n_ids)
    nb = edges.shape[0] + 1
    plan = plan or edge_plan(n_valid, n_ids, nb)
    packed = torch.empty(n_ids * (4 + 2 * nb), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_edge_reduce", eid.data_ptr(), cdur.data_ptr(), sdur.data_ptr(),
              failed.data_ptr(), int(n_valid), edges.data_ptr(), nb - 1, int(n_ids),
              int(plan.tiled), plan.per, plan.smem, packed.data_ptr(), _stream(dev))
    _count("edge_reduce")
    return packed


def edge_reduce(eid: torch.Tensor, cdur: torch.Tensor, sdur: torch.Tensor, failed: torch.Tensor,
                n_valid: int, edges: torch.Tensor, n_ids: int, plan: EdgePlan | None = None):
    """B8b -> counts, failed_counts (n_ids,) int32, client_sum,
    server_sum (n_ids,) f32, client_hist, server_hist (n_ids, len(edges)
    + 1) int32: views of edge_fold's one allocation."""
    return edge_views(edge_fold(eid, cdur, sdur, failed, n_valid, edges, n_ids, plan), n_ids,
                      edges.shape[0] + 1)


# ------------------------------------------------------------------ M1
def find_elect(rows: torch.Tensor, base: int, winner: torch.Tensor | None = None) -> torch.Tensor:
    """M1 on K3's local (Bl, Q) rows of the blocks base .. base + Bl - 1:
    stage 1 (winner None) the highest global block with a hit per query,
    stage 2 the row of the block equal to winner[q]; -1 where none.
    Bound: bytes (the rows read once)."""
    dev = _cuda_device(rows)
    if rows.dim() != 2 or rows.shape[1] == 0:
        raise KernelError("find_elect: (Bl, Q) rows with Q > 0 expected")
    bl, q = rows.shape
    _check(rows, "rows", torch.int32, dev)
    if winner is not None:
        _check(winner, "winner", torch.int32, dev, (q,))
    out = torch.empty(q, dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_find_elect", rows.data_ptr(), bl, q, int(base), _ptr(winner), out.data_ptr(),
              _stream(dev))
    _count("find_elect")
    return out


# ------------------------------------------------------------------ M2/M3
def mq_partial(progs: torch.Tensor, dims: tuple, span_mat: torch.Tensor, row0: int,
               span_off: torch.Tensor, n_spans: int) -> torch.Tensor:
    """M2: B5a's span-level half of q_b packed programs over the row slice
    span_mat (n_sc, Sl) starting at global row row0 -> partial counts
    (q_b, NG + 1, n_traces_b) int32. Bound: bytes (the slice's columns
    once per query)."""
    dev = _cuda_device(progs)
    q_b = progs.shape[0]
    _check(progs, "progs", torch.int32, dev, (q_b, MQ_W))
    _check(span_mat, "span_mat", torch.int32, dev)
    _check(span_off, "span_off", torch.int32, dev)
    if span_mat.dim() != 2 or span_off.dim() != 1 or span_off.shape[0] < 2:
        raise KernelError("mq_partial: span_mat (n_sc, Sl) and span_off (NT + 1,) expected")
    if len(dims) != 6 or any(not 1 <= d <= m for d, m in zip(dims, MQ_MAX)):
        raise KernelError(f"mq_partial: program dims {dims} outside {MQ_MAX}")
    P, NC, NG = (int(d) for d in dims[:3])
    n_sc, sl = span_mat.shape
    nt_b = span_off.shape[0] - 1
    out = torch.empty((q_b, NG + 1, nt_b), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_mq_partial", progs.data_ptr(), q_b, P, NC, NG, span_mat.data_ptr(), n_sc, sl,
              int(row0), span_off.data_ptr(), int(n_spans), nt_b, out.data_ptr(), _stream(dev))
    _count("mq_partial")
    return out


def mq_combine(progs: torch.Tensor, dims: tuple, counts: torch.Tensor, trace_mat: torch.Tensor,
               n_traces: int):
    """M3: the trace-level half over the summed (q_b, NG + 1, n_traces_b)
    counts and trace_mat (n_tc, n_traces_b) -> (tm bool, counts int32),
    each (q_b, n_traces_b). Bound: bytes (the counts and the trace
    columns read once)."""
    dev = _cuda_device(progs)
    q_b = progs.shape[0]
    _check(progs, "progs", torch.int32, dev, (q_b, MQ_W))
    if len(dims) != 6 or any(not 1 <= d <= m for d, m in zip(dims, MQ_MAX)):
        raise KernelError(f"mq_combine: program dims {dims} outside {MQ_MAX}")
    NG, PT, NA, TC = (int(d) for d in dims[2:])
    if counts.dim() != 3 or trace_mat.dim() != 2:
        raise KernelError("mq_combine: counts (q_b, NG + 1, NT) and trace_mat (n_tc, NT) expected")
    nt_b = counts.shape[2]
    _check(counts, "counts", torch.int32, dev, (q_b, NG + 1, nt_b))
    _check(trace_mat, "trace_mat", torch.int32, dev, (trace_mat.shape[0], nt_b))
    tm = torch.empty((q_b, nt_b), dtype=torch.bool, device=dev)
    cnt = torch.empty((q_b, nt_b), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_mq_combine", progs.data_ptr(), q_b, NG, PT, NA, TC, counts.data_ptr(),
              trace_mat.data_ptr(), trace_mat.shape[0], int(n_traces), nt_b, tm.data_ptr(),
              cnt.data_ptr(), _stream(dev))
    _count("mq_combine")
    return tm, cnt


# ------------------------------------------------------------------ M4
def timeseries_stacked(prog, bufs: list, descs: torch.Tensor, cols: dict, gid: torch.Tensor,
                       val: torch.Tensor | None, vpres: torch.Tensor | None, t0s: torch.Tensor,
                       nspans: torch.Tensor, step: int, n_buckets: int, n_groups: int):
    """M4: the span program of `prog` (ops/timeseries._SpanProgram) over Bl
    stacked blocks, block b's descriptor buffer bufs[b] pointing at row b
    of the (Bl, S) columns in cols and descs (Bl,) int64 on the card
    holding each buffer's descriptor address -> one (n_groups, n_buckets)
    grid:
    (counts,) or (counts, vcnt, vsum, vmin, vmax) with vmin / vmax in
    B6's ordered-int32 encoding (timeseries_stacked_finish decodes them).
    Bound: bytes (13 B a span plus the named columns)."""
    dev = _cuda_device(gid)
    if gid.dim() != 2:
        raise KernelError("timeseries_stacked: (Bl, S) gid expected")
    bl, S = gid.shape
    _check(gid, "gid", torch.int32, dev)
    start_ms, tsid = cols["span.start_ms"], cols["span.trace_sid"]
    _check(start_ms, "span.start_ms", torch.int32, dev, (bl, S))
    _check(tsid, "span.trace_sid", torch.int32, dev, (bl, S))
    has_val = val is not None
    if has_val:
        _check(val, "val", torch.float32, dev, (bl, S))
        _check(vpres, "vpres", torch.bool, dev, (bl, S))
    _check(t0s, "t0s", torch.int32, dev, (bl,))
    _check(nspans, "nspans", torch.int32, dev, (bl,))
    if len(bufs) != bl or prog.rconds or len(prog.steps) != 1:
        raise KernelError("timeseries_stacked: one span program buffer a block, no rattr conds")
    if step < 1 or n_buckets < 1 or n_groups < 1:
        raise KernelError(f"timeseries_stacked: step {step}, {n_groups} x {n_buckets} cells")
    for b in bufs:
        _check(b, "program buffer", torch.uint8, dev)
    _check(descs, "descs", torch.int64, dev, (bl,))
    n_traces_b = next((t.shape[1] for n, t in cols.items() if n.startswith("trace.")), 1)
    (_, off, ln, _), = prog.steps
    shape = (n_groups, n_buckets)
    outs = [torch.empty(shape, dtype=torch.int32, device=dev)]
    if has_val:
        outs += [torch.empty(shape, dtype=torch.int32, device=dev),
                 torch.empty(shape, dtype=torch.float32, device=dev),
                 torch.empty(shape, dtype=torch.int32, device=dev),
                 torch.empty(shape, dtype=torch.int32, device=dev)]
    with _on(dev):
        _call("tt_timeseries_stacked", descs.data_ptr(), bl, bufs[0].data_ptr() + off, ln, S,
              tsid.data_ptr(), int(n_traces_b), start_ms.data_ptr(), gid.data_ptr(), _ptr(val),
              _ptr(vpres), t0s.data_ptr(), nspans.data_ptr(), int(step),
              int(n_buckets), int(n_groups), int(has_val), outs[0].data_ptr(),
              *(_ptr(o) for o in outs[1:]) if has_val else (None,) * 4, _stream(dev))
    _count("timeseries_stacked")
    return tuple(outs)


def timeseries_stacked_finish(vmin: torch.Tensor, vmax: torch.Tensor):
    """M4's decode, run after the collective: the ordered-int32 vmin and
    vmax back to f32, in place; returns their f32 views. Counted with
    the fold (one more launch of timeseries_stacked)."""
    dev = _cuda_device(vmin)
    _check(vmin, "vmin", torch.int32, dev)
    _check(vmax, "vmax", torch.int32, dev, tuple(vmin.shape))
    with _on(dev):
        _call("tt_ts_stacked_finish", vmin.data_ptr(), vmax.data_ptr(), vmin.numel(), _stream(dev))
    _count("timeseries_stacked")
    return vmin.view(torch.float32), vmax.view(torch.float32)


# ------------------------------------------------------------------ K1 on a shard
def filter_span_shard(prog, bufs: list, step: tuple, slots: torch.Tensor, n_local: list) -> None:
    """K1's span pass for one span step ("span", off, len, out_slot) of a
    sharded program (ops/filter._FilterProgram, sharded=True) on every
    block of a mesh shard: slots (Bl, n_slots, Sl) uint8, block b's
    descriptors and code in bufs[b], its valid rows n_local[b]. Writes
    the step's slot in place. Bound: bytes (each column the step names
    read once, the slot written)."""
    dev = _cuda_device(slots)
    _check(slots, "slots", torch.uint8, dev)
    if slots.dim() != 3 or len(bufs) != slots.shape[0] or len(n_local) != slots.shape[0]:
        raise KernelError("filter_span_shard: slots (Bl, n_slots, Sl), a buffer and a count a block")
    _, off, ln, out_slot = step
    sl = slots.shape[2]
    with _on(dev):
        for b, buf in enumerate(bufs):
            _check(buf, "program buffer", torch.uint8, dev)
            base, sb = buf.data_ptr(), slots[b].data_ptr()
            _call("tt_filter_span_pass", base + off, ln, base + prog.desc_off, sb, sb + out_slot * sl,
                  sl, int(n_local[b]), None, 1, None, _stream(dev))
    _count("filter")


def filter_struct_shard(op: str, lm_g: torch.Tensor, slots: torch.Tensor, rslot: int,
                        out_slot: int, pidx: torch.Tensor, n_spans: list, row0: int) -> None:
    """K1's struct kernels for one struct node on every block of a mesh
    shard: lm_g (Bl, S) the lhs mask gathered over sp (bool or uint8),
    the rhs and output slots of slots (Bl, n_slots, Sl), pidx the shard's
    parent rows (Bl, Sl) for '>' or the gathered table (Bl, S) for '>>'
    and '~'; n_spans the blocks' span counts, row0 the shard's first row.
    Writes the output slot in place. Bound: bytes (the mask and parent
    table read once a pass)."""
    dev = _cuda_device(slots)
    _check(slots, "slots", torch.uint8, dev)
    if lm_g.dtype not in (torch.bool, torch.uint8):
        raise KernelError(f"filter_struct_shard: lhs mask dtype {lm_g.dtype}")
    _check(lm_g, "lm_g", lm_g.dtype, dev)
    bl, _, sl = slots.shape
    S = lm_g.shape[1]
    _check(pidx, "pidx", torch.int32, dev, (bl, sl if op == ">" else S))
    if lm_g.shape[0] != bl or len(n_spans) != bl or not 0 <= row0 <= S - sl:
        raise KernelError(f"filter_struct_shard: {bl} blocks of {sl} rows at {row0} in {S}")
    scratch_i = scratch_u = None
    if op == ">>":
        scratch_i = torch.empty(2 * S, dtype=torch.int32, device=dev)
        scratch_u = torch.empty(2 * S, dtype=torch.uint8, device=dev)
    elif op == "~":
        scratch_i = torch.empty(S + 1, dtype=torch.int32, device=dev)
    n_passes = max(1, (S - 1).bit_length())
    with _on(dev):
        for b in range(bl):
            _call("tt_filter_struct", {">": 0, ">>": 1, "~": 2}[op], lm_g[b].data_ptr(),
                  slots[b, rslot].data_ptr(), slots[b, out_slot].data_ptr(), pidx[b].data_ptr(), S,
                  int(n_spans[b]), n_passes, _ptr(scratch_i), _ptr(scratch_u), int(row0), sl,
                  _stream(dev))
    _count("filter")


# ------------------------------------------------------------------ M5-M8
def attr_partial(descs: torch.Tensor, cond: int, n_seg: int, al: int, arow0: int) -> torch.Tensor:
    """M5: per (block, owner) the shard's matching attr rows of leaf
    `cond`, through each block's descriptor table (descs (Bl,) int64
    addresses): the owner's global offsets minus arow0 clipped to
    [0, al) -> (Bl, n_seg) int32 partial counts; a resource leaf gives
    its compare per resource. One launch: a CTA a tile of 2,048 owners,
    whose rows it reads as one coalesced window where the tile's clipped
    offsets are monotone (csrc/meshsearch.cu). Bound: bytes (4 B
    an attr row's key, the vtype and value of the rows whose key matches,
    the offsets and the counts once)."""
    dev = _cuda_device(descs)
    _check(descs, "descs", torch.int64, dev)
    bl = descs.shape[0]
    if descs.dim() != 1 or not 1 <= bl <= 65535 or n_seg < 1 or al < 0:
        raise KernelError(f"attr_partial: {bl} blocks, {n_seg} owners, {al} rows")
    out = torch.empty((bl, n_seg), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_attr_partial", descs.data_ptr(), int(cond), bl, int(n_seg), int(al), int(arow0),
              out.data_ptr(), _stream(dev))
    _count("attr_partial")
    return out


def attr_mask(cnt: torch.Tensor, res_idx: torch.Tensor | None, n_spans: torch.Tensor, row0: int,
              slots: torch.Tensor, slot: int) -> None:
    """M5's second half, after the collective: the summed counts cnt
    (Bl, Sl) of a span attr leaf (res_idx None), or (Bl, n_own) of a
    resource leaf gathered through the clamped res_idx (Bl, Sl), > 0 on
    valid rows -> slot `slot` of slots (Bl, n_slots, Sl), in place.
    Counted as an attr_partial launch. Bound: bytes (9 B a span row)."""
    dev = _cuda_device(slots)
    _check(slots, "slots", torch.uint8, dev)
    bl, n_slots, sl = slots.shape
    _check(cnt, "cnt", torch.int32, dev)
    _check(n_spans, "n_spans", torch.int32, dev, (bl,))
    if res_idx is None:
        _check(cnt, "cnt", torch.int32, dev, (bl, sl))
    else:
        _check(res_idx, "res_idx", torch.int32, dev, (bl, sl))
    if cnt.dim() != 2 or cnt.shape[0] != bl or cnt.shape[1] < 1 or not 0 <= slot < n_slots:
        raise KernelError(f"attr_mask: counts {tuple(cnt.shape)} into slot {slot} of {n_slots}")
    with _on(dev):
        _call("tt_attr_mask", cnt.data_ptr(), cnt.shape[1], _ptr(res_idx), n_spans.data_ptr(), bl,
              sl, int(row0), slots[:, slot].data_ptr(), n_slots * sl, _stream(dev))
    _count("attr_partial")


def mask_pack(m: torch.Tensor) -> torch.Tensor:
    """M6: (Bl, Sl) 0/1 bytes (rows may be strided, Sl % 8 == 0) -> (Bl,
    Sl / 8) uint8, bit 7 of byte j the row 8j (np.packbits). Bound:
    bytes (9 B a row)."""
    dev = _cuda_device(m)
    if m.dtype not in (torch.bool, torch.uint8) or m.dim() != 2 or m.stride(1) != 1:
        raise KernelError("mask_pack: (Bl, Sl) bool or uint8 rows of unit stride expected")
    bl, sl = m.shape
    if sl % 8:
        raise KernelError(f"mask_pack: {sl} rows do not pack 8 to a byte")
    out = torch.empty((bl, sl // 8), dtype=torch.uint8, device=dev)
    with _on(dev):
        _call("tt_mask_pack", m.data_ptr(), m.stride(0), bl, sl // 8, out.data_ptr(), _stream(dev))
    _count("mask_pack")
    return out


def mask_unpack(pk: torch.Tensor) -> torch.Tensor:
    """M6: (Bl, n) uint8 -> (Bl, 8n) bool (np.unpackbits). Bound: bytes
    (9 B a row)."""
    dev = _cuda_device(pk)
    _check(pk, "pk", torch.uint8, dev)
    if pk.dim() != 2:
        raise KernelError("mask_unpack: (Bl, n) bytes expected")
    bl, n = pk.shape
    out = torch.empty((bl, 8 * n), dtype=torch.bool, device=dev)
    with _on(dev):
        _call("tt_mask_unpack", pk.data_ptr(), bl, n, out.data_ptr(), _stream(dev))
    _count("mask_unpack")
    return out


def search_partial(prog, buf: torch.Tensor, slots: torch.Tensor, span_off: torch.Tensor | None,
                   tsid: torch.Tensor | None, n_spans: torch.Tensor, row0: int,
                   nt: int) -> torch.Tensor:
    """M7: per (block, trace) the shard's matched rows of each tracify
    slot of `prog` and of their union -> (Bl, n_tr + 1, nt) int32
    partial counts; through span_off (Bl, nt + 1) clipped to the shard,
    or by atomicAdd at the clamped tsid (Bl, Sl). The slot list is read
    from buf. Bound: bytes (a byte a row a slot, the offsets or tsid)."""
    dev = _cuda_device(slots)
    _check(slots, "slots", torch.uint8, dev)
    _check(buf, "program buffer", torch.uint8, dev)
    bl, n_slots, sl = slots.shape
    _check(n_spans, "n_spans", torch.int32, dev, (bl,))
    if span_off is not None:
        _check(span_off, "span_off", torch.int32, dev, (bl, nt + 1))
    elif tsid is not None:
        _check(tsid, "tsid", torch.int32, dev, (bl, sl))
    else:
        raise KernelError("search_partial: span_off or tsid expected")
    n_tr = len(prog.tslots)
    out = torch.empty((bl, n_tr + 1, nt), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_search_partial", slots.data_ptr(), n_slots, buf.data_ptr() + prog.tslots_off, n_tr,
              _ptr(span_off), _ptr(tsid) if span_off is None else None, n_spans.data_ptr(), bl, sl,
              int(row0), int(nt), out.data_ptr(), _stream(dev))
    _count("search_partial")
    return out


def search_finish(prog, buf: torch.Tensor, descs: torch.Tensor, counts: torch.Tensor):
    """M8: the trace program of `prog` (its code read from buf) over the
    summed (Bl, n_tr + 1, nt) counts, trace conditions through each
    block's descriptor table (descs (Bl,) int64) -> (trace_mask bool,
    where(trace_mask, union count, 0) int32), each (Bl, nt). Bound:
    bytes (the counts and trace columns read, 5 B a trace written)."""
    dev = _cuda_device(counts)
    _check(buf, "program buffer", torch.uint8, dev)
    _check(descs, "descs", torch.int64, dev)
    bl = descs.shape[0]
    n_tr = len(prog.tslots)
    if counts.dim() != 3:
        raise KernelError("search_finish: counts (Bl, n_tr + 1, nt) expected")
    nt = counts.shape[2]
    _check(counts, "counts", torch.int32, dev, (bl, n_tr + 1, nt))
    tm = torch.empty((bl, nt), dtype=torch.bool, device=dev)
    cnt = torch.empty((bl, nt), dtype=torch.int32, device=dev)
    with _on(dev):
        _call("tt_search_finish", buf.data_ptr() + prog.trace_off, prog.trace_len, descs.data_ptr(),
              counts.data_ptr(), n_tr, bl, nt, tm.data_ptr(), cnt.data_ptr(), _stream(dev))
    _count("search_finish")
    return tm, cnt
