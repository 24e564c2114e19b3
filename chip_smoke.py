"""Chip smoke for the PyTorch/CUDA port (tempo_tpu_torch): drives its read,
write and ingest paths on one NVIDIA card and holds every kernel against its plain
PyTorch version.

    python3 chip_smoke.py

Phases, in order (any failure raises; no CPU fallback):
  1. device    nvidia-smi name/power limit and torch's device name
  2. build     nvcc builds every kernel from tempo_tpu_torch/csrc
  3. corpus    10 blocks x 32,768 traces x 32 spans = 10,485,760 spans
               (util/synth.py, seed 7, the shape of bench.py:544), written
               with the stdlib gzip codec into a temporary LocalBackend;
               TempoDB() on the default device + poll_now()
  4. kernels   K1-K4 vs their plain versions on block 0 at full width,
               bit for bit (every output is an int or a bool), each K1
               query matching at least one trace; the sibling query runs
               on block 0's columns with a random-tree parent_idx (the
               synth chain has no siblings; 5 % orphans in every tile);
               K1's 8 forms and the 2 extra search forms by both routes
               (the trace tiles the plan picks, and the multi-launch
               kernels forced through the plan argument), then both routes
               on a 9,600-span chain (tiles of 16,384), a 19,200-span trace
               (past the tile: multi-launch) and group-range staging;
               K4 on one column and on two in one call (one __global__);
               times by CUDA events (warm),
               the byte bound at 3.35 TB/s, and a one-call PyTorch
               yardstick where one exists
  5. find      find_trace_by_id on 48 present + 16 absent ids, one K3
               __global__ a find (no stack: a descriptor a block)
  6. search    10 TraceQL queries (limit 20) on the card, each response
               equal to a second TempoDB(device="cpu") over the same
               backend; then 2 of them on the per-block fallback
               (search_block per block, staged budget 0), card vs CPU
  7. launches  every kernel launched at least once by phases 5-6 (wrapper
               calls; the __global__ launches behind them are logged);
               K1 at most 120 __global__ for phase 6's 10 searches
  4b. (in phase 4) B5a with 16 same-shape programs (operands taken from
               block 0's own spans, so each matches; one __global__ a
               call), B5b at k = 64 over their rows (two passes: two
               __global__ a call; its order equal to torch.topk's), then
               B5a at Q = 1, 4 and 16 and B5b at k = 64, 256, 2,048 and
               K_SMALL + 1 by both routes, each against its plain
               version, B6 for `rate() by (resource.service.name)` and
               `avg_over_time(duration) by (name)` at a 60 s step, plus a
               dyadic-value fold; each against its plain version (B6's
               f32 sum at rtol 1e-5, exact on dyadic values), B6's route
               logged; then B6's sweep over block 0's spans: counts-only
               and value grids of 3,904, 31,232 and 200,019 cells by
               every route each fits, against the plain version
  8. batched search on block 0: the 16 queries as one
               search_blocks_multi group (1 B5a + 1 B5b call, 1 and 2
               __global__, occupancy 16) and from 16 threads; a mixed burst with ineligible
               queries (fallbacks); a search_block_shard_multi burst over
               row-group ranges; each response equal to the CPU port's
               unbatched answer; no fused_error; the host-clock wall of
               the 16-query burst batched vs sequential
  9. batched find: the 64 ids of phase 5 through find_in_blocks_multi
               and from 16 threads, equal to phase 5's sequential traces
  10. metrics  4 TraceQL metrics range queries over the 10 blocks at a
               60 s step, each launching B6 once per block (one __global__
               a call), series equal to TempoDB(device="cpu")
  4c. (in phase 4) B9a's one-column form over block 0's span.name_id
               with a seeded permutation of its dictionary (both of its
               routes), B9b of block 0's 32,768 ids, ids -> words on the
               card (equal to its stored bloom), B9c of its 16 row groups (equal
               to its stored stats; rowgroup_plan's grid of clusters), B10a
               over blocks 0-3's blooms and 4 seeded 12-shard blooms (a
               thread a quad), B10b (the ids hashed on the card) of 48
               own and 16 absent ids and of all 32,768 ids (the kernel
               line's row), each against its plain version, bit for bit
  11. cut      every trace of block 0 materialized and cut by
               TempoDB.write_block on the card (B9a once for all 29 code
               columns, B9b once with no host hashing, B9c; B9a's row in the kernel line is this
               cut's codes in one call) and
               by a CPU TempoDB into another store: equal blocks; 48
               finds in the new tenant equal the materialized traces; 2
               searches card vs CPU; the cut's host/kernel split, the
               bloom step apart from the row-group step
  12. compact  the 10 corpus blocks through the compactor service on the
               card (Compactor.run_once at concurrency 2: compact_tenants,
               the pipelined sweep) and compact_once on a CPU copy of the
               store: equal outputs, the pipeline's stage walls, overlap
               and prefetch logged; phase 5's 64 finds unchanged; 2
               searches card vs CPU; tag discovery (search_tags, the
               values of service.name, name and a span attribute) and
               find_candidates of phase 5's ids equal on the card and the
               CPU copy, before and after; then 4 blocks of 8
               traces merged on the union route (one B10a call and
               __global__ from one pinned upload, no bloom
               rebuilt, every id tests present through B10b), the same 4
               blocks on the default concat route (parts readable by
               find); retention_once on each tenant
  13. ingest   the ingest plane and the live head: block 0's first 16,384
               traces (phase 11's materialized pairs) pushed as segments
               in 64 windows of 256 into an Ingester on the card and one
               on the CPU, 1,024 of them in two segments (the second half
               1-6 windows later), every live trace cut after window 32;
               a live search and a WAL feature checkpoint every 8 windows,
               each refresh's route logged and its device columns held
               against the host tails, one B7c call and __global__ a delta
               refresh that appends rows; 10 live searches equal to the CPU
               ingester and the index walk; 48 present + 16 absent finds
               on the map and the device route (one B7b __global__ a
               device find); rate() over the live head
               card vs CPU; the flush (B9a-B9c) after a copy of the WAL,
               and a replay of that copy into a new Ingester; then B7a-B7d
               against their plain versions on the staged 16,384-slot head
               (B7b at every cluster size, and find_slot_device's call;
               B7c on the first delta refresh's columns in one call)
  14. generator the metrics-generator behind the distributor's streaming
               tap: block 0's traces 16,384-32,767 (524,288 spans) pushed
               in 64 windows of 256 (the first 8 as OTLP bytes through
               push_raw, 1,024 traces in two segments in consecutive
               windows) through a Distributor over a Ring (rf 1, a
               heartbeating Lifecycler) of one Ingester on the card, with a
               card MetricsGenerator behind generator_window_tap; the tap
               flushed after each push and the window's cached columns
               folded by a CPU generator: equal registries (counts and
               buckets exact, f32 sums at rtol 1e-5), zero extra decodes,
               no tap error or drop; the card's legacy planes over the same
               traces equal the streaming state by series key and edge
               pair; one metrics_text() scrape and link_rtt_ms logged; then
               B8a and B8b against their plain versions at the last
               window's shape, B8b by both routes (its route and count
               logged), B8a's sweep of 305-65,536 rows x 4,096 and 2^18
               ids and B8b's of 305-65,536 rows x 4,096 and 65,536 ids
               (both routes), each against the plain version
  15. mesh     the mesh programs over torch.distributed (parallel/), on a
               hard-linked copy of the corpus as phases 5-10 saw it: run 1
               on an NCCL mesh of one rank calls the host entries directly
               (TempoDB takes no mesh route at one rank, as the reference):
               sharded_find_rows and sharded_find of phase 5's 64 ids over
               the 10 blocks, sharded_bloom_union of their blooms (one
               B10a and no all_gather at one rank; run 2 three a rank),
               mesh_eval_multiquery of phase 4b's 16 programs on block 0
               and the stacked fold (try_metrics_mesh) of
               `rate() by (resource.service.name)`, each equal to the
               single-card route; sharded_search of the 8 K1 forms with
               per-block operands, equal to K1 block by block;
               search_blocks_device of the 10 searches against phase 6;
               distributed_query_step of the 64 ids, the span query and
               the 10 blooms against the three host entries; run 2 in the
               same process after run 1's group is destroyed: a gloo 2x2
               mesh of this process and three spawned followers, all on the
               card, under a TempoDB whose 64 + 12 finds, 16-query burst on
               block 0, 10 searches (`>>` and `~` refused by the budget,
               as reckoned) and 4 metrics queries take the mesh routes
               (routing counted by reason) and equal phases 5, 8 and 10 and
               run 1's answers, then the step at 2x2; run 1's sharded
               searches (sp = 1) take M7 and M8 in one launch
               (search_fused) and no M6 (no pack, no gather), run 2's
               (sp = 2) M7, the sum, then M8, and a pack and a packed
               struct read a struct node; each sharded find and step one
               M1 launch (K3's search and the election) and no K3 on
               rank 0; then M1-M8 and the fused route against their plain
               versions at the shapes the runs gave them (M1 at run 1's,
               beside K3 then the old two stages' arithmetic; M4 on each
               of its routes, one cooperative __global__ a fold; M6's
               pack and K1's struct pass over the packed mask on run 1's
               `>` node, split as run 2's two sp shards and whole), M7
               beside torch.segment_reduce,
               and the device µs of M1, M4, M6, M7, M8 and the fused
               route queued
  16. app      the read plane and the single binary on the card: an App
               (target all, multitenancy on, TempoDB, Ingester and
               generator on cuda:0) over a hard-linked copy of the corpus
               as phases 5-10 saw it, HTTP on 127.0.0.1, tenant `smoke`:
               phase 5's 48 + 16 finds via /api/traces (equal traces,
               404s), the 10 searches at limit 20 (each holds min(20,
               matches) traces, each equal to the facade's search at a
               limit above every match count), two of them at limit 65,536
               against the facade's whole answer, a repeat (X-Tempo-Cache
               hit, equal body), a stream whose final event equals the
               blocking body, search/tags and service.name's values equal
               to the facade's, the count query of phase 10 through
               /api/metrics/query_range (two time-shard jobs) equal to
               phase 10's series, the 10 searches again through a
               dispatcher-only Frontend drained by one thread over the
               wire job plane (poll_job -> worker.execute_job ->
               complete_job; a `multi` job at least), then 16 OTLP JSON
               pushes found live, searched, flushed and found in the
               backend; no failed job, and K1, K2, K3, B6 and B7a launched
               through the App; each step's wall beside the card's name
               and power limit
Each path's launch counts are set to 0 just before it and read just
after. The line before the last is the kernel table (JSON); the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import cProfile
import dataclasses
import functools
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT_OPS_PER_S = 67e12  # non-tensor 32-bit rate of the H100 SXM data sheet
N_BLOCKS, N_TRACES, SPANS_PER = 10, 1 << 15, 32
TENANT = "smoke"
CODEC = "gzip"  # the card's image has no zstandard wheel; gzip is stdlib

# (label, query) -- phase 4 covers one of each kind; phase 6 adds a
# duration range and an OR
K1_QUERIES = [
    ("span", '{ span.http.status_code = 500 && kind = server }'),
    ("res", '{ resource.service.name = "svc-007" }'),
    ("sattr", '{ span.attr.key005 = "value-00042" }'),
    ("rattr", '{ resource.attr.key000 =~ "value-00[0-4].*" }'),
    ("table", '{ name =~ "op-00[0-3].*" }'),
    ("child", '{ kind = server } > { status = error }'),
    ("descendant", '{ name = "op-0001" } >> { kind = client }'),
    ("sibling", '{ kind = producer } ~ { kind = consumer }'),
]
SEARCH_QUERIES = [q for _, q in K1_QUERIES] + [
    '{ duration > 500ms && duration < 600ms }',
    '{ status = error } || { span.http.status_code = 404 }',
]
# the batcher-eligible forms of tests/test_batchexec.py:48-56 over the
# synth corpus, then forms the batcher refuses (regex table, structural
# relation, generic attr table)
BATCH_FORMS = [
    '{ name = "op-0042" }',
    '{ duration > 900ms }',
    '{ status = error && kind = server }',
    '{ name = "op-0100" || duration < 1ms }',
    '{ span.http.status_code >= 500 }',
    '{ name = "op-0007" && resource.service.name = "svc-007" }',
]
INELIGIBLE = ['{ name =~ "op-00[0-3].*" }', '{ name = "op-0001" } >> { kind = client }',
              '{ span.attr.key005 = "value-00042" }']
METRICS_QUERIES = [
    '{ true } | rate() by (resource.service.name)',
    '{ span.http.status_code = 500 } | count_over_time() by (kind)',
    '{ true } | avg_over_time(duration) by (name)',
    '{ kind = server } | max_over_time(duration) by (resource.service.name)',
]
METRICS_STEP_S = 60  # about 60 buckets over the corpus's hour
# phase 6's K1 __global__ launches at most: 100 program runs (10 searches
# x 10 blocks) on the trace tiles, one each, plus the res pass of the
# resource.attr form's 10 (the blocks hold no orphan: no flag pass)
K1_SEARCH_GRIDS = 120
# f32 latency sums: atomics on the card add in another order than the CPU
# generator's fold, and the legacy plane folds all spans at once
GEN_RTOL = 1e-5


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def host_ms(fn, reps: int = 40, rounds: int = 7, warm: int = 5) -> float:
    """A call's wall on the host clock, for calls that end in a
    read-back (so the card's work is inside each call): the median of
    `rounds` means of `reps` calls (the host's jitter moves a mean)."""
    for _ in range(warm):
        fn()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(means))


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def random_tree_parents(cols: dict, n_spans: int, rng, p_orphan: float = 0.05) -> np.ndarray:
    """A padded span.parent_idx with a random tree inside each trace:
    every non-first span's parent is a uniformly drawn earlier span of
    its trace, or -2 (orphan) with probability p_orphan; first spans
    are roots (-1). Rows past n_spans keep the staged padding."""
    off = cols["trace.span_off"].cpu().numpy().astype(np.int64)
    sid = cols["span.trace_sid"][:n_spans].cpu().numpy().astype(np.int64)
    pos = np.arange(n_spans, dtype=np.int64)
    lo = off[sid]
    par = lo + np.floor(rng.random(n_spans) * (pos - lo)).astype(np.int64)
    par = np.where(rng.random(n_spans) < p_orphan, -2, par)
    out = cols["span.parent_idx"].cpu().numpy().copy()
    out[:n_spans] = np.where(pos == lo, -1, par)
    return out


def same_response(r, c) -> bool:
    a = [(t.trace_id, t.matched_spans, t.start_time_unix_nano) for t in r.traces]
    b = [(t.trace_id, t.matched_spans, t.start_time_unix_nano) for t in c.traces]
    return a == b and r.inspected_spans == c.inspected_spans


def max_abs_err(got, want) -> int:
    if not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()))
    return err


def batch_queries(blk, n: int = 16) -> list[str]:
    """n queries of one shape, `{ name = .. && resource.service.name = .. }`,
    their operands read off n random spans of the block, so each
    matches at least the trace of its span."""
    names, ridx = blk.pack.read("span.name_id"), blk.pack.read("span.res_idx")
    svc, d = blk.pack.read("res.service_id"), blk.dictionary
    rows = np.random.default_rng(17).choice(names.shape[0], n, replace=False)
    return [f'{{ name = "{d.string(int(names[r]))}" && '
            f'resource.service.name = "{d.string(int(svc[ridx[r]]))}" }}' for r in rows]


def same_series(a, b) -> bool:
    """Counts and value counts exact; min and max exact; the f32 sums
    (merged in f64) at rtol 1e-5."""
    if set(a.series) != set(b.series) or a.inspected_spans != b.inspected_spans:
        return False
    for k, st in a.series.items():
        for f, arr in st.items():
            other = b.series[k][f]
            if f == "vsum":
                if not np.allclose(arr, other, rtol=1e-5, atol=0):
                    return False
            elif not np.array_equal(arr, other):
                return False
    return True


CUT_TENANT, SMALL_TENANT, CONCAT_TENANT = "smoke-cut", "smoke-small", "smoke-concat"


def canon_trace(t) -> list:
    """A trace as a sorted list of its spans with their resource, scope,
    attributes, events and links: equal for equal traces whatever the
    order of their batches (kind and status as ints: a decoded proto
    carries ints where a materialized trace carries the enums)."""
    if t is None:
        return None
    out = []
    for res, scope, sp in t.all_spans():
        out.append(repr((sp.span_id, sp.parent_span_id, sp.name, int(sp.kind), sp.start_unix_nano,
                         sp.end_unix_nano, int(sp.status_code), sp.status_message, sp.trace_state,
                         sorted(sp.attrs.items()), sorted(res.attrs.items()),
                         (scope.name, scope.version),
                         [(e.name, e.time_unix_nano, sorted(e.attrs.items())) for e in sp.events],
                         [(ln.trace_id, ln.span_id, sorted(ln.attrs.items())) for ln in sp.links])))
    return sorted(out)


def same_block(be_a, meta_a, be_b, meta_b, what: str) -> None:
    """Raise unless two blocks are equal column for column, with equal
    dictionary, bloom words, row groups and meta (block id aside)."""
    from tempo_tpu_torch.block.versioned import open_block_versioned

    da, db_ = json.loads(meta_a.to_json()), json.loads(meta_b.to_json())
    da.pop("block_id"), db_.pop("block_id")
    if da != db_:
        raise AssertionError(f"{what}: metas differ: "
                             f"{ {k: (v, db_.get(k)) for k, v in da.items() if db_.get(k) != v} }")
    a, b = open_block_versioned(be_a, meta_a), open_block_versioned(be_b, meta_b)
    if a.pack.names() != b.pack.names():
        raise AssertionError(f"{what}: column sets differ")
    for name in a.pack.names():
        if not np.array_equal(a.pack.read(name), b.pack.read(name)):
            raise AssertionError(f"{what}: column {name} differs")
    ra, rb = a.dictionary.raw(), b.dictionary.raw()
    if ra[0] != rb[0] or not np.array_equal(ra[1], rb[1]):
        raise AssertionError(f"{what}: dictionaries differ")
    for i in range(meta_a.bloom_shards):
        if not np.array_equal(a.bloom_shard(i), b.bloom_shard(i)):
            raise AssertionError(f"{what}: bloom shard {i} differs")


class CallTimes:
    """Host-clock seconds spent in patched callables, by label; kernel
    wrappers are timed between two synchronizes, so their time is the
    launch and the kernel's run."""

    def __init__(self):
        self.s: dict[str, float] = {}
        self._undo = []

    def patch(self, owner, attr: str, label: str, sync: bool = False) -> None:
        fn = getattr(owner, attr)

        def timed(*a, **k):
            if sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if sync:
                    torch.cuda.synchronize()
                self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def phase_4c(blocks, metas, absent, dev, table) -> None:
    """B9a/B9b/B9c and B10a/B10b against their plain versions at full
    width on block 0 (and blocks 0-3 for the union)."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block import schema as S
    from tempo_tpu_torch.ops import blockcut as BC
    from tempo_tpu_torch.ops import bloom_ops as BO

    blk0, meta0 = blocks[0], metas[0]
    ids0 = blk0.trace_index["trace.id"]
    rng = np.random.default_rng(19)

    def row(name, source, replaces, err, ms, pms, b, lms):
        table.append({"name": name, "route": "cuda", "source": f"tempo_tpu_torch/csrc/{source}",
                      "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
                      "plain_ms": pms, "bound_ms": b[0], "bound_by": b[1], "library_ms": lms})

    # B9a -- span.name_id through a seeded permutation of the dictionary:
    # the one-column form (its row in the kernel line is phase 11's cut)
    col = torch.from_numpy(blk0.pack.read("span.name_id").copy()).to(dev)
    r = len(blk0.dictionary)
    remap = torch.from_numpy(rng.permutation(r).astype(np.int32)).to(dev)
    for plan in ("shared", "l2"):
        if max_abs_err(kernels.remap_codes(col, remap, plan), BC._remap_plain(col, remap)):
            raise AssertionError(f"B9a ({plan} route) differs from its plain version")
    n = col.shape[0]
    ms = cuda_ms(lambda: kernels.remap_codes(col, remap))
    us = device_ms(lambda: kernels.remap_codes(col, remap)) * 1e3
    b = bound(n * 8 + r * 4, n)
    log(f"[B9a] one column, {n} codes, table of {r} ({kernels.remap_plan(r)} route): {ms:.4f} ms, "
        f"device {us:.2f} µs (queued), bound {b[0]:.5f} ms")

    # B9b -- the whole function at phase 11's shape: block 0's ids into
    # its own geometry from zero words (ids -> words on the card); the
    # result is block 0's stored bloom. Beside it the host hashing it
    # replaced (bloom_scatter) and, as a yardstick, the old route's
    # index_put_ over the reference's pairs; no one PyTorch call hashes
    # and scatters, so the row's library_ms is null
    n_shards, bits = meta0.bloom_shards, meta0.bloom_shard_bits
    ids_d = torch.from_numpy(np.ascontiguousarray(ids0, dtype=np.uint8)).to(dev)
    zeros = torch.zeros((n_shards, bits // 32), dtype=torch.int32, device=dev)
    kernels.reset_counts()
    got = kernels.bloom_bits(zeros.clone(), ids_d, bits, BC._K)
    if kernels.grid_launches()["bloom_bits"] != 1:
        raise AssertionError("B9b: not one __global__ a call")
    err = max_abs_err(got, BC._bloom_bits_plain(zeros.clone(), ids_d, bits))
    stored = np.stack([blk0.bloom_shard(i) for i in range(n_shards)]).view(np.int32)
    t0 = time.perf_counter()
    word_idx, onehot, _ = BC.bloom_scatter([bytes(x) for x in ids0], n_shards, bits)
    hash_s = time.perf_counter() - t0
    wi64 = torch.from_numpy(word_idx).to(dev).long()
    bt = torch.from_numpy(onehot.view(np.int32)).to(dev)
    old = torch.zeros(zeros.numel(), dtype=torch.int32, device=dev)
    old.index_put_((wi64,), bt, accumulate=True)
    if err or not np.array_equal(got.cpu().numpy(), stored) or \
            not np.array_equal(old.view(zeros.shape).cpu().numpy(), stored):
        raise AssertionError("B9b differs from its plain version, the old route or block 0's "
                             "bloom")
    w = zeros.clone()  # the calls OR into w again: the same bits
    ms = cuda_ms(lambda: kernels.bloom_bits(w, ids_d, bits, BC._K))
    us = device_ms(lambda: kernels.bloom_bits(w, ids_d, bits, BC._K)) * 1e3
    pms = cuda_ms(lambda: BC._bloom_bits_plain(w, ids_d, bits), reps=5, warm=1)
    old_ms = cuda_ms(lambda: old.index_put_((wi64,), bt, accumulate=True))
    t, m = ids_d.shape[0], wi64.shape[0]
    # bytes: 16 B an id, the words read and written; operations: about
    # 110 integer operations an id (two FNV-1a passes over 16 bytes,
    # splitmix64, 7 positions and their atomics)
    b = bound(t * 16 + zeros.numel() * 8, t * 110)
    log(f"[B9b] {t} ids -> {m} distinct bits in {n_shards} x {bits} bits, ids -> words on the "
        f"card: {ms:.4f} ms, device {us:.2f} µs (queued), plain {pms:.4f} ms, bound {b[0]:.5f} "
        f"ms ({b[1]}); equal to block 0's stored bloom; the host hashing it replaces "
        f"(bloom_scatter) {hash_s:.3f} s, and the old route's index_put_ over its pairs "
        f"{old_ms:.4f} ms (yardstick)")
    row("bloom_bits", "blockcut.cu", "tempo_tpu/ops/blockcut.py:89-134", err, ms, pms, b, None)

    # B9c -- block 0's row groups of 65,536 spans
    rgs = S.DEFAULT_ROW_GROUP_SPANS
    sm = torch.from_numpy(blk0.pack.read("span.start_ms").copy()).to(dev)
    du = torch.from_numpy(blk0.pack.read("span.dur_us").copy()).to(dev)
    got = kernels.rowgroup_minmax(sm, du, rgs)
    err = max_abs_err(got, BC._rowgroup_plain(sm, du, rgs))
    stored = np.asarray([[g.start_ms_min for g in meta0.row_groups],
                         [g.start_ms_max for g in meta0.row_groups],
                         [g.dur_us_max for g in meta0.row_groups]], np.int32)
    if err or not np.array_equal(got.cpu().numpy(), stored):
        raise AssertionError("B9c differs from its plain version or block 0's row groups")
    n, G = sm.shape[0], got.shape[1]
    lengths = torch.full((G,), rgs, dtype=torch.int64, device=dev)
    lengths[-1] = n - rgs * (G - 1)
    seg = torch.stack([-sm, sm, du], dim=1)  # one max gives -min, max, max
    try:
        torch.segment_reduce(seg, "max", lengths=lengths, axis=0)
        seg_kind = "int32"
    except RuntimeError:  # no integer kernel: float64 holds int32 exactly
        seg, seg_kind = seg.double(), "float64"
    lib = torch.segment_reduce(seg, "max", lengths=lengths, axis=0)
    if not torch.equal(lib.to(torch.int64).T, torch.stack([-got[0], got[1], got[2]]).to(torch.int64)):
        raise AssertionError("B9c differs from torch.segment_reduce")
    kernels.reset_counts()
    kernels.rowgroup_minmax(sm, du, rgs)
    if kernels.grid_launches()["rowgroup"] != 1:
        raise AssertionError("B9c: not one __global__ a call")
    plan = kernels.rowgroup_plan(n, rgs)
    ms = cuda_ms(lambda: kernels.rowgroup_minmax(sm, du, rgs))
    us = device_ms(lambda: kernels.rowgroup_minmax(sm, du, rgs)) * 1e3
    pms = cuda_ms(lambda: BC._rowgroup_plain(sm, du, rgs))
    lms = cuda_ms(lambda: torch.segment_reduce(seg, "max", lengths=lengths, axis=0))
    b = bound(n * 8 + G * 12, 3 * n)
    log(f"[B9c] {n} spans in {G} groups: {ms:.4f} ms, device {us:.2f} µs (queued), plan "
        f"C = {plan.clusters} CTAs a group, a grid of {plan.ctas}; plain {pms:.4f} ms, "
        f"segment_reduce ({seg_kind}) {lms:.4f} ms, bound {b[0]:.5f} ms; equal to block 0's "
        f"row groups")
    row("rowgroup", "blockcut.cu", "tempo_tpu/ops/blockcut.py:149-158", err, ms, pms, b, lms)

    # B10a -- the blooms of blocks 0-3, then 4 seeded 12-shard blooms
    stacked = torch.from_numpy(np.stack([np.stack([blk.bloom_shard(i) for i in range(n_shards)])
                                         for blk in blocks[:4]]).view(np.int32)).to(dev)
    wide = torch.from_numpy(rng.integers(0, 2**32, (4, 12, 1 << 15), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(dev)
    for label, x in (("blocks 0-3", stacked), ("4 x 12 x 2^20 bits", wide)):
        got = kernels.bloom_union(x)
        err = max_abs_err(got, BO._union_plain(x))
        host = np.bitwise_or.reduce(x.cpu().numpy(), axis=0)
        if err or not np.array_equal(got.cpu().numpy(), host):
            raise AssertionError(f"B10a {label} differs from its plain version")
        kernels.reset_counts()
        kernels.bloom_union(x)
        if kernels.grid_launches()["bloom_union"] != 1:
            raise AssertionError("B10a: not one __global__ a call")
        ms = cuda_ms(lambda: kernels.bloom_union(x))
        us = device_ms(lambda: kernels.bloom_union(x)) * 1e3
        pms = cuda_ms(lambda: BO._union_plain(x))
        b = bound(x.numel() * 4 + got.numel() * 4, x.numel())
        route = "quads" if got.numel() % 4 == 0 else "words"
        log(f"[B10a {label}] {tuple(x.shape)}: {ms:.4f} ms, device {us:.2f} µs (queued), "
            f"a thread a quad of {route}; plain {pms:.4f} ms, bound {b[0]:.5f} ms")
        if x is stacked:
            row("bloom_union", "bloom.cu", "tempo_tpu/ops/bloom_ops.py:20", err, ms, pms, b, None)

    # B10b -- the id route: the ids hashed on the card. 48 of block 0's
    # own ids (all present) and phase 5's 16 absent ids, then all 32,768
    # of its ids (all present), against block 0's bloom; each held bit for
    # bit against the plain id route, against _test_plain over the host's
    # positions() and against the host's bloom_test
    own = [bytes(ids0[i]) for i in rng.choice(len(ids0), 48, replace=False)]
    words_np = np.stack([blk0.bloom_shard(i) for i in range(n_shards)])
    words = torch.from_numpy(words_np.view(np.int32)).to(dev)
    for q_ids in (own + absent, [bytes(r) for r in ids0]):
        q = len(q_ids)
        slots, lens = np.empty((q, 16), np.uint8), np.empty(q, np.uint8)
        BO.pack_ids(q_ids, slots, lens)
        s_d, l_d = torch.from_numpy(slots).to(dev), torch.from_numpy(lens).to(dev)
        got = kernels.bloom_test(words, s_d, l_d, n_shards, bits, BC._K)
        plain = BO._test_ids_plain(words.cpu(), torch.from_numpy(slots), torch.from_numpy(lens),
                                   n_shards, bits)
        word_idx, bit_idx = BO.positions(q_ids, n_shards, bits)
        wq, bq = torch.from_numpy(word_idx).to(dev), torch.from_numpy(bit_idx).to(dev)
        err = max_abs_err(got, plain.to(dev))
        hits = got.cpu().numpy()
        host = [blk0.bloom_test(t) for t in q_ids]
        path = BO.batch_test(words_np, bits, n_shards, q_ids, dev)
        path_card = BO.batch_test(words, bits, n_shards, q_ids)
        if err or hits.tolist() != BO._test_plain(words, wq, bq).cpu().tolist() \
                or hits.tolist() != host or not hits[:48].all() \
                or not np.array_equal(path, hits) or not np.array_equal(path_card, hits):
            raise AssertionError(f"B10b at {q} ids differs from its plain id route, "
                                 "_test_plain over positions() or the host bloom test")
        kernels.reset_counts()
        BO.batch_test(words_np, bits, n_shards, q_ids, dev)
        if kernels.LAUNCHES["bloom_test"] != 1 or kernels.grid_launches()["bloom_test"] != 1:
            raise AssertionError("B10b: batch_test is not one launch")
        ms = cuda_ms(lambda: kernels.bloom_test(words, s_d, l_d, n_shards, bits, BC._K))
        us = device_ms(lambda: kernels.bloom_test(words, s_d, l_d, n_shards, bits, BC._K)) * 1e3
        pms = host_ms(lambda: BO._test_ids_plain(words.cpu(), torch.from_numpy(slots),
                                                 torch.from_numpy(lens), n_shards, bits),
                      reps=5, rounds=3, warm=1)
        path_ms = host_ms(lambda: BO.batch_test(words_np, bits, n_shards, q_ids, dev),
                          reps=5, rounds=5, warm=2)
        card_ms = host_ms(lambda: BO.batch_test(words, bits, n_shards, q_ids),
                          reps=5, rounds=5, warm=2)
        # bytes: 16 B of id, 1 B of length and 1 B out an id, and the
        # words read once -- a 32-byte sector of each of the K words an id
        # tests, never more than the whole bloom (at 32,768 ids its 64 KB
        # stay in L2); operations: about 110 integer operations an id
        b = bound(min(q * BC._K * 32, words.numel() * 4) + 18 * q, q * 110)
        absent_hits = f", {int(hits[48:].sum())} of 16 absent pass" if q == 64 else ""
        log(f"[B10b] {q} ids x {BC._K} bits: every present id tests present{absent_hits}; "
            f"kernel {ms:.4f} ms, device "
            f"{us:.2f} µs (queued); batch_test from numpy words {path_ms:.3f} ms, from card words "
            f"{card_ms:.3f} ms (host clock); plain id route {pms:.3f} ms (numpy), bound "
            f"{b[0]:.6f} ms")
    row("bloom_test", "bloom.cu", "tempo_tpu/ops/bloom_ops.py:48", err, ms, pms, b, None)


def phase_11(db, blk0, dev, tmp) -> tuple[dict, list, tuple]:
    """The cut at full width: every trace of block 0 materialized and cut
    on the card by TempoDB.write_block, and again by a CPU TempoDB into
    another store; the two blocks equal; finds and searches on the new
    tenant. Returns the cut's wrapper calls, the materialized (trace id,
    trace) pairs, which phase 13 pushes, and B9a's inputs (the codes on
    the card, the segment bounds, the table) for its row."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.block import builder as BB
    from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
    from tempo_tpu_torch.ops import blockcut as BC

    t0 = time.perf_counter()
    n = blk0.meta.total_traces
    traces = blk0.materialize_traces(list(range(n)))
    tid_rows = blk0.trace_index["trace.id"]
    pairs = [(tid_rows[i].tobytes(), t) for i, t in enumerate(traces)]
    mat_s = time.perf_counter() - t0
    times = CallTimes()
    times.patch(BB.BlockBuilder, "add_trace", "add_trace")
    times.patch(BB, "write_block", "write objects")
    times.patch(BC.CutEngine, "remap_many", "remap steps (one upload, launch, download)")
    times.patch(BC.CutEngine, "bloom_bits", "bloom step (one upload, launch, download)")
    times.patch(BC.CutEngine, "rowgroup_minmax", "row-group step (one upload, launch, download)")
    cut_args, hashed = [], []
    many, scatter = kernels.remap_many, BC.bloom_scatter

    def keep_many(codes, offs, remap, plan=None):  # the cut's codes, for B9a's row
        cut_args.append((codes, list(offs), remap))
        return many(codes, offs, remap, plan)

    def host_hashing(*a, **k):  # the card cut must not hash on the host
        hashed.append(len(a[0]))
        return scatter(*a, **k)

    kernels.remap_many, BC.bloom_scatter = keep_many, host_hashing
    for name in ("remap_many", "bloom_bits", "rowgroup_minmax"):
        times.patch(kernels, name, "kernels (synchronized)", sync=True)
    kernels.reset_counts()
    try:
        t0 = time.perf_counter()
        meta = db.write_block(CUT_TENANT, pairs)
        card_s = time.perf_counter() - t0
    finally:
        times.restore()
        kernels.remap_many, BC.bloom_scatter = many, scatter
    counts, grids = dict(kernels.LAUNCHES), kernels.grid_launches()
    log(f"[cut] {n} traces, {meta.total_spans} spans materialized from block 0 in {mat_s:.1f} s; "
        f"card cut {card_s:.2f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in times.s.items())
        + f"; wrapper calls {counts}; __global__ launches {grids}")
    if counts["remap"] != 1 or grids["remap"] != 1 or len(cut_args) != 1 \
            or counts["bloom_bits"] != 1 or grids["bloom_bits"] != 1 or counts["rowgroup"] != 1 \
            or grids["rowgroup"] != 1:
        raise AssertionError(f"cut: not one B9a, one B9b and one B9c launch a cut: "
                             f"{counts}, {grids}")
    if hashed:
        raise AssertionError(f"cut: bloom_scatter hashed {hashed} ids on the host")
    codes, offs, remap = cut_args[0]
    lens = np.diff(offs).tolist()
    log(f"[cut] B9a: {len(lens)} code columns, {codes.shape[0]} codes in one launch "
        f"(column lengths {lens}), table of {remap.shape[0]}")
    cpu_be = LocalBackend(os.path.join(tmp, "cut-cpu"))
    cpu_db = TempoDB(TempoDBConfig(), backend=cpu_be, device="cpu")
    t0 = time.perf_counter()
    cmeta = cpu_db.write_block(CUT_TENANT, pairs)
    cpu_s = time.perf_counter() - t0
    same_block(db.backend, meta, cpu_be, cmeta, "cut card vs CPU")
    log(f"[cut] CPU cut {cpu_s:.2f} s; card and CPU blocks equal (columns, dictionary of "
        f"{meta.dict_size}, bloom {meta.bloom_shards} x {meta.bloom_shard_bits} bits, "
        f"{len(meta.row_groups)} row groups)")
    pick = np.random.default_rng(29).choice(n, 48, replace=False)
    t0 = time.perf_counter()
    for i in pick:
        got = db.find_trace_by_id(CUT_TENANT, pairs[i][0])
        if canon_trace(got) != canon_trace(traces[i]):
            raise AssertionError(f"cut find {pairs[i][0].hex()}: not the materialized trace")
    find_s = time.perf_counter() - t0
    # two queries read off block 0's own spans, so each matches (the synth
    # corpus keeps http status in a dedicated column only, so a
    # materialized trace carries no http.status_code attribute)
    for q in batch_queries(blk0, 2):
        req = SearchRequest(query=q, limit=20)
        r = db.search(CUT_TENANT, req)
        if not r.traces or not same_response(r, cpu_db.search(CUT_TENANT, req)):
            raise AssertionError(f"cut search {q}: card and CPU differ")
    log(f"[cut] 48 finds in the new tenant equal block 0's traces ({find_s:.2f} s); 2 searches "
        f"card vs CPU agree")
    return counts, pairs, cut_args[0]


def phase_11_table(cut, table) -> dict:
    """B9a against its plain version on phase 11's cut: every code column
    in one call (kernels.remap_many), by each route; times by CUDA events
    and queued device time, the bound from the cut's bytes. Returns the
    device split of the one-call cut against a call a column."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import blockcut as BC

    codes, offs, remap = cut
    want = BC._remap_many_plain(codes, offs, remap)
    err = max(max_abs_err(kernels.remap_many(codes, offs, remap, plan), want)
              for plan in ("shared", "l2"))
    if err:
        raise AssertionError("B9a over the cut differs from its plain version")
    n, r = codes.shape[0], remap.shape[0]
    ms = cuda_ms(lambda: kernels.remap_many(codes, offs, remap))
    us = device_ms(lambda: kernels.remap_many(codes, offs, remap)) * 1e3
    pms = cuda_ms(lambda: BC._remap_many_plain(codes, offs, remap), reps=5, warm=1)
    b = bound(n * 8 + r * 4, n)
    log(f"[B9a] phase 11's cut, {len(offs) - 1} columns, {n} codes, table of {r} "
        f"({kernels.remap_plan(r)} route): {ms:.4f} ms, device {us:.2f} µs (queued), plain "
        f"{pms:.4f} ms, bound {b[0]:.5f} ms")
    table.append({"name": "remap", "route": "cuda", "source": "tempo_tpu_torch/csrc/blockcut.cu",
                  "replaces": "tempo_tpu/ops/blockcut.py:54-58", "launches": 0,
                  "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b[0],
                  "bound_by": b[1], "library_ms": None})
    return {f"B9a, phase 11's cut ({len(offs) - 1} columns, {n} codes)": {
        "shared route": lambda: kernels.remap_many(codes, offs, remap, "shared"),
        "l2 route": lambda: kernels.remap_many(codes, offs, remap, "l2")}}


DISCOVERY_TAGS = ("service.name", "name", "attr.key007")  # a resource, the intrinsic, a span attr


def tag_discovery(db, cpu, ids, when: str) -> dict:
    """search_tags and search_tag_values of DISCOVERY_TAGS on the card's
    TempoDB and the CPU copy (equal, none empty), and find_candidates of
    `ids` on both (the same blocks by level, trace count and time range:
    compaction outputs get new ids). Returns the card's answers."""
    t0 = time.perf_counter()
    answers = []
    for d in (db, cpu):
        a = {"tags": d.search_tags(TENANT)}
        for tag in DISCOVERY_TAGS:
            a[tag] = d.search_tag_values(TENANT, tag)
        answers.append(a)
    if answers[0] != answers[1] or not all(answers[0].values()):
        raise AssertionError(f"tag discovery {when}: card and CPU differ")

    def key(metas):
        return sorted((m.compaction_level, m.total_traces, m.start_time_unix_nano,
                       m.end_time_unix_nano) for m in metas)

    n = 0
    for tid in ids:
        got = db.find_candidates(TENANT, tid)
        if key(got) != key(cpu.find_candidates(TENANT, tid)):
            raise AssertionError(f"find_candidates {tid.hex()} {when}: card and CPU differ")
        n += len(got)
    log(f"[discovery] {when}: {len(answers[0]['tags'])} tags, "
        + ", ".join(f"{t} {len(answers[0][t])} values" for t in DISCOVERY_TAGS)
        + f", equal on the card and the CPU copy; find_candidates of {len(ids)} ids "
        f"({n} candidates) equal; {time.perf_counter() - t0:.2f} s")
    return answers[0]


def phase_12(db, store, tmp, dev, present, absent, seq_found) -> dict:
    """Compaction last: the 10 corpus blocks on the card and on a CPU
    copy of the store; the union route on small blocks; the concat route;
    retention. Returns the union path's wrapper calls."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.block.bloom import ShardedBloom
    from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
    from tempo_tpu_torch.db import compactor as comp
    from tempo_tpu_torch.services.compactor import Compactor
    from tempo_tpu_torch.ops import blockcut as BC
    from tempo_tpu_torch.ops import bloom_ops as BO
    from tempo_tpu_torch.util.testdata import make_traces

    copy = os.path.join(tmp, "store-cpu")
    shutil.copytree(store, copy)
    cpu = TempoDB(TempoDBConfig(), backend=LocalBackend(copy), device="cpu")
    cpu.poll_now()
    cfg = db.cfg.compaction
    for job in comp.select_jobs(TENANT, db.metas(TENANT), cfg):
        ids_n, need, have = comp.union_capacity([db.open_block(m) for m in job.blocks])
        log(f"[compact] job {job.hash}: {len(job.blocks)} blocks, route "
            f"{comp.route(job, cfg)}, union needs {need:.0f} bits for {ids_n} ids of "
            f"{have} -> {'fits' if need <= have else 'rebuild'}")
    discovery_before = tag_discovery(db, cpu, present + absent, "before compaction")
    # the card through the compactor service's pipelined sweep (2 workers
    # under an 8 GiB admission budget: the reference's 1 GiB default sizes
    # a 1-2 core compactor box, and two of these jobs' estimates pass it;
    # retention held off here, it runs below), the CPU copy through the
    # sequential compact_once, the oracle
    cfg.concurrency, retention0, cfg.retention_s = 2, cfg.retention_s, 10**10
    cfg.pipeline_mem_budget_bytes = 8 << 30
    svc, sweeps = Compactor(db), []
    sweep = db.compact_tenants
    db.compact_tenants = lambda *a, **k: sweeps.append(sweep(*a, **k)) or sweeps[-1]
    kernels.reset_counts()
    t0 = time.perf_counter()
    try:
        svc.run_once()
    finally:
        card_s = time.perf_counter() - t0
        cfg.concurrency, cfg.retention_s, cfg.pipeline_mem_budget_bytes = None, retention0, None
        del db.compact_tenants
    counts = dict(kernels.LAUNCHES)
    if svc.stats.errors or len(sweeps) != 1:
        raise AssertionError(f"compactor: {len(sweeps)} pipelined sweeps, errors "
                             f"{svc.stats.errors!r}")
    t0 = time.perf_counter()
    cres = cpu.compact_once(TENANT)
    cpu_s = time.perf_counter() - t0
    res = [oc.result for oc in sweeps[0] if oc.tenant == TENANT]
    if len(res) != len(cres) or not res or len(res) != len(sweeps[0]) or \
            svc.stats.blocks_compacted != sum(len(c.compacted_ids) for c in cres):
        raise AssertionError(f"compaction: {len(res)} card jobs, {len(cres)} CPU jobs")
    for r, c in zip(res, cres):
        if sorted(r.compacted_ids) != sorted(c.compacted_ids) or \
                len(r.new_blocks) != len(c.new_blocks):
            raise AssertionError("compaction: card and CPU jobs differ")
        for m, cm in zip(r.new_blocks, c.new_blocks):
            same_block(db.backend, m, cpu.backend, cm, f"compaction output {m.block_id}")
    st = db.compaction_stats.snapshot()
    log(f"[compact] {len(res)} jobs ({[len(r.compacted_ids) for r in res]} blocks in, "
        f"{[len(r.new_blocks) for r in res]} out) card {card_s:.1f} s through "
        f"Compactor.run_once (compact_tenants, 2 workers), CPU compact_once {cpu_s:.1f} s; "
        f"outputs equal; wrapper calls {counts}")
    log("[compact pipeline] stage s " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(st["stage_seconds"].items()))
        + f"; run wall {st['wall_seconds']:.2f} s, overlap ratio {st['overlap_ratio']:.2f}, "
        f"prefetch {st['prefetch']}, jobs in flight at most {st['max_jobs_inflight']}, "
        f"est. bytes in flight at most {st['max_bytes_inflight']}")
    t0 = time.perf_counter()
    for tid in present + absent:
        got = db.find_trace_by_id(TENANT, tid)
        want = seq_found.get(tid)
        if (got is None) != (want is None) or (got is not None and
                                               dataclasses.asdict(got) != dataclasses.asdict(want)):
            raise AssertionError(f"find {tid.hex()} after compaction differs from phase 5")
    log(f"[compact] phase 5's 64 finds on the compacted blocklist "
        f"({len(db.metas(TENANT))} blocks) equal phase 5's answers, {time.perf_counter() - t0:.2f} s")
    for q in (SEARCH_QUERIES[0], SEARCH_QUERIES[5]):
        req = SearchRequest(query=q, limit=20)
        r = db.search(TENANT, req)
        if not r.traces or not same_response(r, cpu.search(TENANT, req)):
            raise AssertionError(f"search {q} after compaction: card and CPU differ")
    if tag_discovery(db, cpu, present + absent, "after compaction") != discovery_before:
        raise AssertionError("tag discovery after compaction differs from before")

    # the union route: 4 blocks of 8 traces cut on the card, merged with
    # the concat route off; one B10a call, no bloom rebuilt
    small = make_traces(32, seed=71, n_spans=6)
    for t in (SMALL_TENANT, CONCAT_TENANT):
        for i in range(4):
            db.write_block(t, small[i * 8:(i + 1) * 8])

    def no_rebuild(*a, **k):
        raise AssertionError("bloom rebuilt id by id; the union route was not taken")

    saved = [(ShardedBloom, n, getattr(ShardedBloom, n)) for n in ("add", "add_many", "add_array")]
    saved.append((BC.CutEngine, "bloom_bits", BC.CutEngine.bloom_bits))
    concat0, cfg.concat_small_input_bytes = cfg.concat_small_input_bytes, 0
    for owner, name, _ in saved:
        setattr(owner, name, no_rebuild)
    kernels.reset_counts()
    try:
        sres = db.compact_once(SMALL_TENANT)
        (out,) = db.metas(SMALL_TENANT)
        blk = db.open_block(out)
        words = np.stack([blk.bloom_shard(i) for i in range(out.bloom_shards)])
        hits = BO.batch_test(words, out.bloom_shard_bits, out.bloom_shards,
                             [t for t, _ in small], dev)
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
        cfg.concat_small_input_bytes = concat0
    union_counts, union_grids = dict(kernels.LAUNCHES), kernels.grid_launches()
    if len(sres) != 1 or union_counts["bloom_union"] != len(sres) or not hits.all() \
            or union_grids["bloom_union"] != len(sres):
        raise AssertionError(f"union route: {len(sres)} jobs, wrapper calls {union_counts}, "
                             f"__global__ {union_grids['bloom_union']} B10a, "
                             f"{int(hits.sum())} of 32 ids test present")
    log(f"[compact union] 4 blocks of 8 traces: {len(sres)} job, one B10a __global__, "
        f"wrapper calls {union_counts}; "
        f"bloom {out.bloom_shards} x {out.bloom_shard_bits} bits unioned, all 32 ids test "
        f"present on the card")
    cres2 = db.compact_once(CONCAT_TENANT)
    parts = [m for r in cres2 for m in r.new_blocks]
    if not parts or not all("/" in m.block_id for m in parts):
        raise AssertionError("default config: the small blocks did not take the concat route")
    for tid, t in small[::3]:
        got = db.find_trace_by_id(CONCAT_TENANT, tid)
        if got is None or got.span_count() != t.span_count():
            raise AssertionError(f"concat part find {tid.hex()}")
    log(f"[compact concat] the same 4 blocks by default: a compound of {len(parts)} parts, "
        f"readable by find")
    for t in (TENANT, SMALL_TENANT, CONCAT_TENANT):
        r = db.retention_once(t)
        log(f"[retention] {t}: marked {len(r.marked)}, deleted {len(r.deleted)}")
        if t == TENANT:
            marked = len(r.marked)
    rc = cpu.retention_once(TENANT)
    log(f"[retention] {TENANT} on the CPU copy: marked {len(rc.marked)}, deleted {len(rc.deleted)}")
    if len(rc.marked) != marked:
        raise AssertionError("retention: card and CPU marked different block counts")
    return union_counts


ING_TENANT = "smoke-ingest"
N_LIVE, WINDOW, N_SPLIT = 1 << 14, 256, 1024  # the reference ingester's 64 MiB head, in windows


def split_trace(t):
    """Two partial traces holding the first and the second half of t's
    spans, each under its own copy of the resource and scope batches."""
    from tempo_tpu_torch.wire.model import ResourceSpans, ScopeSpans, Trace

    spans = [(ri, si, sp) for ri, rs in enumerate(t.resource_spans)
             for si, ss in enumerate(rs.scope_spans) for sp in ss.spans]
    halves = []
    for part in (spans[:len(spans) // 2], spans[len(spans) // 2:]):
        tr, batches = Trace(), {}
        for ri, si, sp in part:
            rs = t.resource_spans[ri]
            if ri not in batches:
                batches[ri] = ResourceSpans(resource=rs.resource)
                tr.resource_spans.append(batches[ri])
            new_rs = batches[ri]
            scope = rs.scope_spans[si].scope
            if not new_rs.scope_spans or new_rs.scope_spans[-1].scope is not scope:
                new_rs.scope_spans.append(ScopeSpans(scope=scope))
            new_rs.scope_spans[-1].spans.append(sp)
        halves.append(tr)
    return halves


def dump(resp) -> list:
    """Every wire-relevant field of a live search response, in order."""
    return [(t.trace_id, t.start_time_unix_nano, t.root_service_name, t.root_trace_name,
             t.duration_ms) for t in resp.traces]


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def phase_13(db, dev, pairs, queries, span_s, tmp, n_live=N_LIVE, window=WINDOW,
             n_split=N_SPLIT) -> dict:
    """The ingest plane and the live head: block 0's first n_live traces
    pushed in windows into an Ingester on the card and one on the CPU,
    searched (`queries`: two TraceQL queries that match), found, folded
    by metrics over `span_s` (the block's first and last second),
    flushed and replayed. Returns the live path's wrapper calls and the
    staged head's last snapshot before the flush."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
    from tempo_tpu_torch.db.metrics_exec import align_params
    from tempo_tpu_torch.db.wal import WAL
    from tempo_tpu_torch.services.ingester import Ingester
    from tempo_tpu_torch.services.overrides import Overrides
    from tempo_tpu_torch.wire.segment import segment_for_write

    def seg_of(tid, t):
        lo, hi = t.time_range_nanos()
        return (tid, lo // 10**9, hi // 10**9 + 1, segment_for_write(t, lo // 10**9, hi // 10**9 + 1))

    # ---- a. setup: a card ingester over the card TempoDB, a CPU twin
    ing = Ingester(WAL(os.path.join(tmp, "ingest-wal")), db, Overrides(), device=dev)
    cpu_db = TempoDB(TempoDBConfig(), backend=LocalBackend(os.path.join(tmp, "ingest-cpu")),
                     device="cpu")
    cpu_ing = Ingester(WAL(os.path.join(tmp, "ingest-wal-cpu")), cpu_db, Overrides(),
                       device="cpu")
    inst, cinst = ing.instance(ING_TENANT), cpu_ing.instance(ING_TENANT)
    st = inst.live_engine.stager

    # ---- b. pushes: windows of `window` traces; n_split traces in two
    # segments, the second half `lag` windows later
    t0 = time.perf_counter()
    live = pairs[:n_live]
    n_win = n_live // window
    rng = np.random.default_rng(37)
    split = set(rng.choice(n_live - window, n_split, replace=False).tolist())
    windows = [[] for _ in range(n_win)]
    for i, (tid, t) in enumerate(live):
        if i in split:
            a, b = split_trace(t)
            windows[i // window].append(seg_of(tid, a))
            windows[min(i // window + int(rng.integers(1, 7)), n_win - 1)].append(seg_of(tid, b))
        else:
            windows[i // window].append(seg_of(tid, t))
    n_segs = sum(len(w) for w in windows)
    log(f"[ingest] {n_live} traces ({sum(t.span_count() for _, t in live)} spans) encoded as "
        f"{n_segs} segments ({n_split} traces in two) in {n_win} windows in "
        f"{time.perf_counter() - t0:.1f} s")

    def check_columns(snap):
        """The first n rows and slots of the device columns equal the
        host tails, bit for bit."""
        n = snap.n_slots
        for name in ("start_s", "end_s", "dur_ms", "key_s", "alive", "id_codes"):
            if not np.array_equal(snap.dev[name][:n].cpu().numpy(), getattr(snap, name)):
                raise AssertionError(f"device column {name} differs from the host tail")
        for name, k in (("kv_owner", snap.n_kv), ("kv_code", snap.n_kv),
                        ("name_owner", snap.n_name), ("name_code", snap.n_name)):
            if not np.array_equal(snap.dev[name][:k].cpu().numpy(), getattr(snap, name)):
                raise AssertionError(f"device column {name} differs from the host tail")

    # the delta refreshes' B7c calls (dsts, src, segs, starts): the first
    # is the B7c row's input (phase_13_table)
    appends = []
    many = kernels.live_append_many

    def keep_many(dsts, src, segs, starts):
        appends.append((list(dsts), src, list(segs), list(starts)))
        return many(dsts, src, segs, starts)

    kernels.live_append_many = keep_many
    times = CallTimes()
    times.patch(kernels, "live_append_many", "B7c", sync=True)
    times.patch(kernels, "live_patch", "B7d", sync=True)
    push_s, refreshes = [], []
    app0 = st.stats["append_calls"]
    kernels.reset_counts()
    try:
        for w, batch in enumerate(windows):
            t0 = time.perf_counter()
            inst.push_segments(batch)
            push_s.append(time.perf_counter() - t0)
            cinst.push_segments(batch)
            if w == n_win // 2 - 1:
                n_cut = inst.cut_complete_traces(force=True)
                if n_cut != cinst.cut_complete_traces(force=True):
                    raise AssertionError("cut: card and CPU cut different counts")
                log(f"[ingest] after window {w + 1}: {n_cut} live traces cut")
            if w % 8 == 7:
                s0 = dict(st.stats)
                t0 = time.perf_counter()
                r = inst.search_live(SearchRequest(limit=20))
                wall = time.perf_counter() - t0
                snap = st._snap
                check_columns(snap)
                up = st.last_upload if st.stats["bytes"] != s0["bytes"] else None
                refreshes.append(up)
                feats = inst.flush_wal_features(), cinst.flush_wal_features()
                log(f"[ingest] window {w + 1}: refresh {'full' if up and up['full'] else 'delta'} "
                    f"({up['rows'] if up else 0} rows, {up['bytes'] if up else 0} B sent), "
                    f"{snap.n_slots} slots / {snap.n_kv} kv rows / {snap.n_name} name rows in "
                    f"buckets {snap.slot_b} / {snap.kv_b} / {snap.name_b}; encode "
                    f"{st.stats['encode_s'] - s0['encode_s']:.2f} s, upload "
                    f"{st.stats['upload_s'] - s0['upload_s']:.3f} s; search {wall:.2f} s, "
                    f"{len(r.traces)} traces; device columns equal the host tails; "
                    f"{feats[0]} features checkpointed")
    finally:
        times.restore()
        kernels.live_append_many = many
    push_counts, push_grids = dict(kernels.LAUNCHES), kernels.grid_launches()
    n_app = st.stats["append_calls"] - app0  # delta refreshes that appended rows
    if not any(u is not None and not u["full"] for u in refreshes):
        raise AssertionError(f"no delta refresh among {refreshes}")
    if dev.type == "cuda" and (push_counts["live_append"] < 1 or push_counts["live_patch"] < 1):
        raise AssertionError(f"no delta refresh launched B7c and B7d: {push_counts}")
    if dev.type == "cuda" and not (push_counts["live_append"] == push_grids["live_append"]
                                   == len(appends) == n_app):
        raise AssertionError(f"B7c: {push_counts['live_append']} calls, "
                             f"{push_grids['live_append']} __global__ for {n_app} delta "
                             f"refreshes with new rows (one each expected)")
    log(f"[ingest] B7c: {n_app} delta refreshes appended rows, one call and one __global__ "
        f"each, columns a call {[len(a[0]) for a in appends]}, rows appended "
        f"{[[m for _, m in a[2]] for a in appends]}")
    if dev.type == "cuda" and push_grids["live_patch"] != push_counts["live_patch"]:
        raise AssertionError(f"B7d: {push_grids['live_patch']} __global__ launches in "
                             f"{push_counts['live_patch']} calls (one a call expected)")
    log(f"[ingest] push wall a window (WAL append included): p50 {pct(push_s, 50) * 1e3:.2f} ms, "
        f"p99 {pct(push_s, 99) * 1e3:.2f} ms; refreshes: encode {st.stats['encode_s']:.2f} s, "
        f"upload {st.stats['upload_s']:.3f} s of which B7c {times.s.get('B7c', 0):.4f} s and "
        f"B7d {times.s.get('B7d', 0):.4f} s (synchronized); {st.stats}; "
        f"features decoded {inst.columnar.decodes} ({inst.columnar.decode_s:.1f} s); "
        f"wrapper calls {nonzero(push_counts)}, __global__ launches {nonzero(push_grids)}")

    # ---- c. searches: card engine == CPU ingester == the card's index walk
    r0 = live[123][1]
    res0, sp0 = r0.resource_spans[0].resource, r0.resource_spans[0].scope_spans[0].spans[0]
    (ak, av), = list(sp0.attrs.items())[:1]
    durs = sorted(max(0, t.time_range_nanos()[1] - t.time_range_nanos()[0]) // 10**6
                  for _, t in live[:2000])
    lo_s = min(t.time_range_nanos()[0] for _, t in live[:2000]) // 10**9
    reqs = [
        (SearchRequest(tags={"service.name": res0.service_name}, limit=20), True),
        (SearchRequest(tags={"name": sp0.name}, limit=20), True),
        (SearchRequest(tags={"service.name": res0.service_name, ak: str(av)}, limit=20), True),
        (SearchRequest(min_duration_ms=durs[len(durs) * 9 // 10], limit=20), True),
        (SearchRequest(max_duration_ms=durs[len(durs) // 10], limit=20), True),
        (SearchRequest(start=lo_s + 600, end=lo_s + 900, limit=20), True),
        (SearchRequest(limit=20), True),
        (SearchRequest(tags={"service.name": res0.service_name}, min_duration_ms=durs[len(durs) // 2],
                       limit=20), False),
    ] + [(SearchRequest(query=q, limit=20), True) for q in queries]
    kernels.reset_counts()
    card_s, index_s = [], []
    for req, must in reqs:
        t0 = time.perf_counter()
        got = inst.search_live(req)
        card_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        oracle = inst.search_live_index(req)
        index_s.append(time.perf_counter() - t0)
        want = cinst.search_live(req)
        if dump(got) != dump(want) or dump(got) != dump(oracle) or (must and not got.traces):
            raise AssertionError(f"live search {req}: card {len(got.traces)}, CPU "
                                 f"{len(want.traces)}, index walk {len(oracle.traces)}")
    search_counts = dict(kernels.LAUNCHES)
    if dev.type == "cuda" and (search_counts["live_filter"] != len(reqs)
                               or search_counts["select"] < len(reqs)):
        raise AssertionError(f"live searches: wrapper calls {nonzero(search_counts)}")
    log(f"[ingest] {len(reqs)} live searches equal the CPU ingester and the index walk; card "
        f"engine {[round(s * 1e3, 1) for s in card_s]} ms, index walk "
        f"{[round(s * 1e3, 1) for s in index_s]} ms (the first walk builds every trace's "
        f"index); wrapper calls {nonzero(search_counts)}")
    # where a warm live tag search's host-clock wall goes: the first
    # search run once more under the profiler, the top functions by own time
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    inst.search_live(reqs[0][0])
    prof.disable()
    wall = time.perf_counter() - t0
    own = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:6]
    log(f"[ingest profile] live tag search: {wall * 1e3:.1f} ms under the profiler; own time "
        + "; ".join(f"{os.path.basename(f)}:{ln} {fn} {tt * 1e3:.1f} ms"
                    for (f, ln, fn), (_, _, tt, _, _) in own))

    # ---- d. finds: 48 present (16 split) and 16 absent, map and device
    split_l = sorted(split)
    pick = ([split_l[i] for i in rng.choice(len(split_l), 16, replace=False)]
            + [int(i) for i in rng.choice(sorted(set(range(n_live)) - split), 32, replace=False)])
    absent = []
    known = {tid for tid, _ in pairs}
    while len(absent) < 16:
        t = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        if t not in known:
            absent.append(t)
    find_s = {}
    kernels.reset_counts()
    for route in ("map", "device"):
        if route == "device":
            os.environ["TEMPO_LIVE_FIND_DEVICE"] = "1"
        try:
            t0 = time.perf_counter()
            got = [inst.find_trace_by_id(live[i][0]) for i in pick] + \
                  [inst.find_trace_by_id(t) for t in absent]
            find_s[route] = time.perf_counter() - t0
        finally:
            os.environ.pop("TEMPO_LIVE_FIND_DEVICE", None)
        for i, g in zip(pick, got):
            if canon_trace(g) != canon_trace(live[i][1]):
                raise AssertionError(f"live find {route} {live[i][0].hex()}: not the trace")
        if any(g is not None for g in got[len(pick):]):
            raise AssertionError(f"live find {route}: an absent id returned a trace")
    find_counts = dict(kernels.LAUNCHES)
    find_grids = kernels.grid_launches()["live_find"]
    if dev.type == "cuda" and not (find_counts["live_find"] == find_grids
                                   == len(pick) + len(absent)):
        raise AssertionError(f"live finds: wrapper calls {nonzero(find_counts)}, "
                             f"{find_grids} __global__")
    log(f"[ingest] {len(pick)} present ({sum(i in split for i in pick)} split) + {len(absent)} "
        f"absent live finds equal the materialized traces on both routes: map "
        f"{find_s['map']:.2f} s, device {find_s['device']:.2f} s; wrapper calls {nonzero(find_counts)}")

    # ---- e. metrics over the live head, card vs CPU
    mq = METRICS_QUERIES[0]
    mreq = align_params(mq, span_s[0], span_s[1], METRICS_STEP_S)
    t0 = time.perf_counter()
    a = inst.metrics_query_range(mreq)
    metrics_s = time.perf_counter() - t0
    b = cinst.metrics_query_range(mreq)
    if not a.series or not same_series(a, b):
        raise AssertionError(f"live metrics {mq}: card {len(a.series)} series, CPU {len(b.series)}")
    log(f"[ingest] {mq} over the live head: {len(a.series)} series, {a.inspected_spans} spans, "
        f"card {metrics_s:.2f} s, equal to the CPU ingester")
    full_snap = st._snap

    # ---- f. flush: copy the WAL, then cut and write the head
    wal_copy = os.path.join(tmp, "ingest-wal-copy")
    shutil.copytree(ing.wal.dir, wal_copy)
    kernels.reset_counts()
    t0 = time.perf_counter()
    inst.cut_complete_traces(force=True)
    meta = inst.cut_block_if_ready(force=True)
    flush_s = time.perf_counter() - t0
    flush_counts = dict(kernels.LAUNCHES)
    if dev.type == "cuda" and (flush_counts["remap"] < 1 or flush_counts["bloom_bits"] != 1
                               or flush_counts["rowgroup"] != 1
                               or kernels.grid_launches()["rowgroup"] != 1):
        raise AssertionError(f"flush: B9a-B9c not all launched, or not one B9c __global__: "
                             f"{flush_counts}")
    if meta.total_traces != n_live:
        raise AssertionError(f"flush wrote {meta.total_traces} traces of {n_live}")
    for i in pick:
        if canon_trace(db.find_trace_by_id(ING_TENANT, live[i][0])) != canon_trace(live[i][1]):
            raise AssertionError(f"flushed find {live[i][0].hex()}: not the trace")
    if inst.search_live(SearchRequest(limit=20)).traces or inst.live or inst.cut or inst.flushing:
        raise AssertionError("the live head is not empty after the flush")
    log(f"[ingest] flush of {meta.total_traces} traces ({meta.total_spans} spans) in "
        f"{flush_s:.2f} s; wrapper calls {nonzero(flush_counts)}; 48 finds in the block equal the "
        f"materialized traces; the live head searches empty")

    # ---- g. replay the WAL copy into a new ingester over a new card TempoDB
    rdb = TempoDB(TempoDBConfig(), backend=LocalBackend(os.path.join(tmp, "ingest-replay")),
                  device=dev)
    ring = Ingester(WAL(wal_copy), rdb, Overrides(), device=dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    n_rec = ring.replay_wal()
    replay_s = time.perf_counter() - t0
    rinst = ring.instances[ING_TENANT]
    if n_rec != n_segs or rinst.columnar.seeded <= 0 or rinst.blocks_flushed != 1:
        raise AssertionError(f"replay: {n_rec} records of {n_segs}, seeded "
                             f"{rinst.columnar.seeded}, {rinst.blocks_flushed} blocks")
    for i in pick:
        if canon_trace(rdb.find_trace_by_id(ING_TENANT, live[i][0])) != canon_trace(live[i][1]):
            raise AssertionError(f"replayed find {live[i][0].hex()}: not the trace")
    log(f"[ingest] replay of {n_rec} records in {replay_s:.2f} s ({rinst.columnar.seeded} "
        f"features seeded, {rinst.columnar.decodes} decoded); wrapper calls "
        f"{nonzero(kernels.LAUNCHES)}; 48 finds equal the materialized traces")
    return {"counts": {k: push_counts[k] + search_counts[k] + find_counts[k]
                       for k in push_counts}, "snap": full_snap,
            "append": appends[0] if appends else None}


def phase_13_table(snap, table, append_call) -> dict:
    """B7a-B7d against their plain versions on the staged live head at
    full width (B7c at phase 13's first delta refresh with new rows,
    `append_call`: its columns, upload and segments); times by CUDA
    events, the byte bound, yardsticks. Returns B7a's device-time split
    by route and code count, B7b's by cluster size and B7c's one call
    against a call a column (device_split's input)."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import livestage as L

    d, n = snap.dev, snap.n_slots
    dev = d["alive"].device

    def row(name, replaces, err, ms, pms, b, lms):
        table.append({"name": name, "route": "cuda",
                      "source": "tempo_tpu_torch/csrc/livestage.cu", "replaces": replaces,
                      "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": pms,
                      "bound_ms": b[0], "bound_by": b[1], "library_ms": lms})

    # B7a -- two tag codes and one name code read off a staged trace,
    # with the window and min-duration prefilters on; the codes as ints,
    # the snapshot's real rows only (the wrapper's default route)
    tid = snap.slot_tid[n // 3]
    own = [int(c) for c in snap.kv_code[snap.kv_owner == n // 3]]
    tag = own[:2]
    name = [int(snap.name_code[snap.name_owner == n // 3][0])]
    slots = (d["start_s"], d["end_s"], d["dur_ms"], d["alive"])
    kv, nm = (d["kv_owner"], d["kv_code"]), (d["name_owner"], d["name_code"])
    t0, t1, dmin = int(snap.end_s.min()), int(snap.start_s.max()), int(snap.dur_ms[n // 3])
    # the sweep's codes: 1 (a tag), 3 (the row's), 33 (32 of the trace's
    # tags, repeated where it has fewer, and the name: two launches)
    sweep = {1: (tag[:1], 1), 3: (tag + name, 2), 33: ((own * 32)[:32] + name, 32)}

    def b7a(codes=tag + name, nt=2):
        return kernels.live_filter(slots, kv, nm, codes, nt, t0, t1, dmin, n, snap.n_kv,
                                   snap.n_name)

    def b7a_plain(codes=tag + name, nt=2):
        return L._live_filter_plain(slots, kv, nm, torch.tensor(codes, dtype=torch.int32,
                                                                device=dev), nt, t0, t1, dmin, n)

    kernels.reset_counts()
    got = b7a()
    err = max_abs_err(got, b7a_plain())
    if err or not bool(got[n // 3]) or kernels.grid_launches()["live_filter"] != 1:
        raise AssertionError("B7a differs from its plain version, misses its own trace or was "
                             "not one __global__")
    for k, (codes, nt) in sweep.items():
        want = b7a_plain(codes, nt)
        if max_abs_err(b7a(codes, nt), want) or not bool(want[n // 3]):
            raise AssertionError(f"B7a differs at {k} codes")
    ms, pms = cuda_ms(b7a), cuda_ms(b7a_plain, reps=5, warm=1)
    # bytes (kernels.live_filter's bound): the four slot columns read and
    # the mask written (17 B a slot), each real row's code read (the
    # snapshot's n_kv kv rows and n_name name rows: both kinds have a code
    # here), and the owner of each row that hits
    sb, nkv, nnm = snap.slot_b, snap.n_kv, snap.n_name
    hits = int(np.isin(snap.kv_code[:nkv], tag).sum()) + \
        int(np.isin(snap.name_code[:nnm], name).sum())
    b = bound(sb * 17 + (nkv + nnm) * 4 + hits * 4, (nkv * 2 + nnm) + sb * 4)
    log(f"[B7a] {n} slots in {sb}, {nkv} of {snap.kv_b} kv + {nnm} of {snap.name_b} name rows, "
        f"2 tag codes + 1 name code: {hits} rows hit, {int(got.sum())} slots, {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b[0]:.5f} ms")
    row("live_filter", "tempo_tpu/ops/livestage.py:147", err, ms, pms, b, None)

    # the path's call: eval_live_device (the codes as ints, one launch),
    # then a synchronise, on the host clock
    def b7a_path():
        m = L.eval_live_device(snap, tag, name, t0, t1, dmin)
        torch.cuda.synchronize()
        return m

    if not bool(b7a_path()[n // 3]):
        raise AssertionError("B7a: eval_live_device misses its own trace")
    log(f"[B7a path] eval_live_device: {host_ms(b7a_path):.4f} ms a call (host clock, "
        f"synchronised)")
    splits = {f"B7a by codes, the live head's {sb} slots": {
        str(k): functools.partial(b7a, codes, nt) for k, (codes, nt) in sweep.items()}}

    # B7b -- the id codes of that trace
    from tempo_tpu_torch.block import schema as S

    codes = S.trace_id_to_codes(tid)
    qid = torch.tensor(codes, dtype=torch.int32, device=dev)
    kernels.reset_counts()
    got = kernels.live_find(d["id_codes"], d["alive"], codes, n)
    err = max_abs_err(got, L._live_find_plain(d["id_codes"], d["alive"], qid, n))
    if err or int(got.item()) != n // 3 or kernels.grid_launches()["live_find"] != 1:
        raise AssertionError("B7b differs from its plain version, misses its slot or was not "
                             "one __global__")
    ms = cuda_ms(lambda: kernels.live_find(d["id_codes"], d["alive"], codes, n))
    pms = cuda_ms(lambda: L._live_find_plain(d["id_codes"], d["alive"], qid, n))
    b = bound(sb * 20 + 16 + 4, sb * 5)
    log(f"[B7b] {sb} slots: {ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.6f} ms")
    row("live_find", "tempo_tpu/ops/livestage.py:243", err, ms, pms, b, None)
    # the path's call (find_slot_device: the codes, the launch and the
    # read-back, host clock); then every cluster size the plan takes (C =
    # ceil(n / 2,048) CTAs, at most 8), each reached by its n_slots, held
    # against the plain version, and timed at 2,048 slots (one CTA, a
    # plain launch), 2,049 (a cluster of 2) and 8,192 and 16,384 (4, 8)
    if L.find_slot_device(snap, tid) != n // 3:
        raise AssertionError("B7b: find_slot_device misses its slot")
    path_ms = host_ms(lambda: L.find_slot_device(snap, tid))
    for c in range(1, 9):
        for n_c in (2048 * (c - 1) + 1, 2048 * c):
            if n_c > sb:
                continue
            cq = [int(x) for x in d["id_codes"][n_c - 1].tolist()]
            want = L._live_find_plain(d["id_codes"], d["alive"],
                                      torch.tensor(cq, dtype=torch.int32, device=dev), n_c)
            if max_abs_err(kernels.live_find(d["id_codes"], d["alive"], cq, n_c), want):
                raise AssertionError(f"B7b differs from its plain version at {n_c} slots")
    log(f"[B7b path] find_slot_device: {path_ms:.4f} ms a call (host clock, read-back included)")
    splits[f"B7b by the plan's CTAs (n_slots, C), the live head's {sb} slots"] = {
        f"{n_c},{min(8, -(-n_c // 2048))}": functools.partial(
            kernels.live_find, d["id_codes"], d["alive"], codes, n_c)
        for n_c in (2048, 2049, 8192, 16384) if n_c <= sb}

    # B7c -- phase 13's first delta refresh with new rows as the stager
    # made it: its columns (kv owner and code, name owner and code) from
    # one upload in one call; the yardstick a torch.slice_scatter a column
    if append_call is None:
        raise AssertionError("B7c: phase 13 made no delta append")
    dsts, src, segs, starts = append_call
    kernels.reset_counts()
    got = kernels.live_append_many(dsts, src, segs, starts)
    err = max(max_abs_err(g, w) for g, w in
              zip(got, L._append_many_plain(dsts, src, segs, starts)))
    windows = []
    for dst, (o, m), st in zip(dsts, segs, starts):
        s = kernels.append_start(st, dst.shape[0], m)
        windows.append((dst, src[o:o + m], s, s + m))

    def slice_scatters():
        return [torch.slice_scatter(dst, x, 0, a, e) for dst, x, a, e in windows]

    if err or kernels.grid_launches()["live_append"] != 1 or \
            not all(torch.equal(x, g) for x, g in zip(slice_scatters(), got)):
        raise AssertionError("B7c differs from its plain version or torch.slice_scatter, or "
                             "was not one __global__")
    ms = cuda_ms(lambda: kernels.live_append_many(dsts, src, segs, starts))
    us = device_ms(lambda: kernels.live_append_many(dsts, src, segs, starts)) * 1e3
    pms = cuda_ms(lambda: L._append_many_plain(dsts, src, segs, starts))
    lms = cuda_ms(slice_scatters)
    # each column written once, dst read outside its window, src inside
    rows = sum(dst.shape[0] for dst in dsts)
    b = bound(rows * 8, 0)
    log(f"[B7c] phase 13's delta refresh, {len(dsts)} columns of "
        f"{[dst.shape[0] for dst in dsts]} rows, {[m for _, m in segs]} appended at {starts}, "
        f"one call: {ms:.4f} ms, device {us:.2f} µs (queued), plain {pms:.4f} ms, "
        f"{len(dsts)} slice_scatter {lms:.4f} ms, bound {b[0]:.5f} ms")
    row("live_append", "tempo_tpu/ops/livestage.py:289-294", err, ms, pms, b, lms)
    splits[f"B7c, phase 13's delta refresh ({len(dsts)} columns, {rows} rows)"] = {
        "one call": lambda: kernels.live_append_many(dsts, src, segs, starts),
        "a call a column": lambda: [kernels.live_append(dst, x, a) for dst, x, a, _ in windows]}

    # B7d -- one refresh's dirty slots (2,048) into the (slot_b, 4) id codes
    g = torch.Generator().manual_seed(41)
    idx = torch.randperm(n, generator=g)[:2048].to(torch.int32).to(dev)
    k = idx.shape[0]
    vals = d["id_codes"][idx.long()].flip(1).contiguous()
    dst = d["id_codes"]
    got = kernels.live_patch(dst, idx, vals)
    err = max_abs_err(got, L._patch_plain(dst, idx, vals))
    idx64 = idx.long()
    if err or not torch.equal(torch.index_put(dst, (idx64,), vals), got):
        raise AssertionError("B7d differs from its plain version or torch.index_put")
    ms = cuda_ms(lambda: kernels.live_patch(dst, idx, vals))
    pms = cuda_ms(lambda: L._patch_plain(dst, idx, vals))
    lms = cuda_ms(lambda: torch.index_put(dst, (idx64,), vals))
    # dst read outside the patched rows (idx has no repeats here), idx
    # and vals read, out written
    b = bound((dst.numel() - vals.numel()) * 4 + idx.numel() * 4 + vals.numel() * 4
              + dst.numel() * 4, 0)
    log(f"[B7d] {k} rows of {tuple(dst.shape)}: {ms:.4f} ms, plain {pms:.4f} ms, index_put "
        f"{lms:.4f} ms, bound {b[0]:.6f} ms")
    row("live_patch", "tempo_tpu/ops/livestage.py:298", err, ms, pms, b, lms)
    # where B7d's time goes: the kernel's device time (the profiler's, and
    # CUDA events around 200 bare ctypes calls, which leave out the
    # wrapper's checks, allocation and count) against the wrapper's
    kernels.reset_counts()
    kernels.live_patch(dst, idx, vals)
    if kernels.grid_launches()["live_patch"] != 1:
        raise AssertionError("B7d: not one __global__ launch a call")
    out = torch.empty_like(dst)
    fn = kernels._fns["tt_live_patch"]
    args = (dst.data_ptr(), dst.shape[0], dst.shape[1], idx.data_ptr(), vals.data_ptr(), k,
            out.data_ptr(), kernels._stream(dev))
    bare_ms = cuda_ms(lambda: fn(*args), reps=200)

    def guard():
        with kernels._on(dev):
            pass

    def host_us(f, reps=2000) -> float:
        f()
        t0 = time.perf_counter()
        for _ in range(reps):
            f()
        us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return us

    # the wrapper's host path by part (host clock, 2,000 calls each)
    host = {"wrapper": host_us(lambda: kernels.live_patch(dst, idx, vals)),
            "bare ctypes call": host_us(lambda: fn(*args)),
            "empty_like": host_us(lambda: torch.empty_like(dst)),
            "three checks": host_us(lambda: (
                kernels._check(dst, "dst", torch.int32, dev),
                kernels._check(idx, "idx", torch.int32, dev, (k,)),
                kernels._check(vals, "vals", torch.int32, dev, tuple(vals.shape)))),
            "stream lookup": host_us(lambda: kernels._stream(dev)),
            "device guard": host_us(guard)}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(50):
            kernels.live_patch(dst, idx, vals)
        torch.cuda.synchronize()
    dev_us = [e.self_device_time_total / e.count for e in prof.key_averages()
              if e.key.startswith("live_patch_kernel")]
    after_ms = cuda_ms(lambda: kernels.live_patch(dst, idx, vals))
    log(f"[B7d split] kernel device time {dev_us[0] / 1e3 if dev_us else 'not measured'} ms "
        f"(profiler), 200 bare ctypes calls {bare_ms:.4f} ms a call (CUDA events), the wrapper "
        f"{ms:.4f} ms a call (cuda_ms; {after_ms:.4f} ms after the profiler); host µs a call: "
        + ", ".join(f"{name} {us:.2f}" for name, us in host.items()))
    return splits


GEN_TENANT = "smoke-gen"


def phase_14(db, dev, pairs, tmp, n_traces=N_LIVE, window=WINDOW, n_split=N_SPLIT) -> dict:
    """The metrics-generator behind the distributor's streaming tap:
    block 0's traces n_traces..2*n_traces-1 (phase 11's materialized
    pairs) pushed in windows of `window` traces -- the first 8 as OTLP
    bytes through push_raw, the rest as model batches through push, n_split
    traces in two segments in consecutive windows -- through a Distributor
    over a Ring of one Ingester on the card, with a card MetricsGenerator
    behind generator_window_tap. After every push the tap is flushed and
    the same window's cached SpanColumns are folded by a CPU generator;
    then the card's legacy planes fold the same traces whole. Returns the
    path's wrapper calls and the last window's B8a / B8b arguments."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.db.wal import WAL
    from tempo_tpu_torch.ingest.columnar import ColumnarIngest
    from tempo_tpu_torch.ops import reduce as R
    from tempo_tpu_torch.ring.ring import InMemoryKV, Lifecycler, Ring
    from tempo_tpu_torch.services import generator as G
    from tempo_tpu_torch.services.app import generator_window_tap
    from tempo_tpu_torch.services.distributor import Distributor
    from tempo_tpu_torch.services.ingester import Ingester
    from tempo_tpu_torch.services.overrides import Overrides
    from tempo_tpu_torch.util.linkcost import link_rtt_ms
    from tempo_tpu_torch.wire.model import Trace
    from tempo_tpu_torch.wire.otlp_pb import encode_trace

    # ---- a. windows of whole traces and halves
    t0 = time.perf_counter()
    traces = pairs[n_traces:2 * n_traces]
    n_win = n_traces // window
    rng = np.random.default_rng(43)
    split = set(rng.choice(n_traces - window, n_split, replace=False).tolist())
    windows = [[] for _ in range(n_win)]
    for i, (_, t) in enumerate(traces):
        if i in split:
            a, b = split_trace(t)
            windows[i // window].append(a)
            windows[i // window + 1].append(b)
        else:
            windows[i // window].append(t)
    n_spans = sum(t.span_count() for _, t in traces)

    # ---- b. topology: Ring(rf 1) of one card Ingester, Distributor, the tap
    ing = Ingester(WAL(os.path.join(tmp, "gen-wal")), db, Overrides(), device=dev)
    kv = InMemoryKV()
    lc = Lifecycler(kv, "ingester", "ingester-0")
    gen = G.MetricsGenerator(Overrides(), device=dev)
    cpu_gen = G.MetricsGenerator(Overrides(), device="cpu")
    tap = generator_window_tap(ing, gen)
    tapped = []  # each tap call's segment list, for the CPU twin

    def recording_tap(tenant, segs, push_ts):
        tapped.append(segs)
        tap(tenant, segs, push_ts)

    dist = Distributor(Ring(kv, "ingester", replication_factor=1),
                       {lc.desc.addr: ing}.__getitem__, Overrides(),
                       generator_window=recording_tap)
    col = ing.instance(GEN_TENANT).columnar
    last = {}
    orig = {name: getattr(R, name) for name in ("span_fold", "edge_fold")}

    def keep(name):
        def call(*a):
            if a[0].device.type == "cuda":  # the card's folds, not the CPU twin's
                last[name] = a
            return orig[name](*a)
        return call

    times = CallTimes()
    times.patch(ColumnarIngest, "features_for", "tap decodes (features_for)")
    times.patch(kernels, "span_fold", "B8a (synchronized)", sync=True)
    times.patch(kernels, "edge_fold", "B8b (synchronized)", sync=True)
    for name in orig:
        setattr(R, name, keep(name))
    push_s, flush_s = [], []
    kernels.reset_counts()
    lc.start()
    try:
        # ---- c. 64 pushes, each tapped, flushed, and twinned on the CPU
        for w, batch in enumerate(windows):
            rs = [r for t in batch for r in t.resource_spans]
            payload = encode_trace(Trace(resource_spans=rs)) if w < 8 else None
            t1 = time.perf_counter()
            got = dist.push_raw(GEN_TENANT, payload) if w < 8 else dist.push(GEN_TENANT, rs)
            push_s.append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            if not dist.flush_generator_tap(timeout_s=300.0):
                raise AssertionError(f"window {w + 1}: the tap did not drain")
            flush_s.append(time.perf_counter() - t1)
            if got != sum(t.span_count() for t in batch) or len(tapped) != 1:
                raise AssertionError(f"window {w + 1}: {got} spans pushed, {len(tapped)} taps")
            cpu_gen.push_window(GEN_TENANT, [col.cached(seg).spans for seg in tapped.pop()],
                                col.dict)
            if w == n_win // 2 - 1:  # the live-trace limit (10,000) as in phase 13
                ing.instance(GEN_TENANT).cut_complete_traces(force=True)
    finally:
        lc.leave()
        dist.stop()
        times.restore()
        for name, fn in orig.items():
            setattr(R, name, fn)
    stream_counts = dict(kernels.LAUNCHES)
    stream_grids = kernels.grid_launches()
    wall = time.perf_counter() - t0
    st = col.stats()
    ds = dist.stats
    log(f"[generator] {n_traces} traces ({n_spans} spans, {n_split} in two segments) in "
        f"{n_win} windows of {window} (8 by push_raw) in {wall:.1f} s: push_raw p50 "
        f"{pct(push_s[:8], 50) * 1e3:.1f} ms, push p50 {pct(push_s[8:], 50) * 1e3:.1f} ms p99 "
        f"{pct(push_s[8:], 99) * 1e3:.1f} ms (slowest: window {int(np.argmax(push_s)) + 1}, "
        f"{max(push_s) * 1e3:.1f} ms), tap flush p50 "
        f"{pct(flush_s, 50) * 1e3:.1f} ms p99 {pct(flush_s, 99) * 1e3:.1f} ms; "
        + ", ".join(f"{k} {v:.3f} s" for k, v in times.s.items())
        + f"; generator stats {gen.stats}; columnar {st}; distributor {ds}; "
        f"wrapper calls {nonzero(stream_counts)}, __global__ {nonzero(stream_grids)}")
    if st["decodes"] - st["cached"] != 0 or st["decodes"] != n_traces + n_split:
        raise AssertionError(f"tap decodes: {st}")
    if ds.gen_tap_errors or ds.gen_tap_dropped or ds.traces_pushed != n_traces + n_split:
        raise AssertionError(f"distributor: {ds}")
    if dev.type == "cuda" and (stream_counts["span_reduce"] != n_win
                               or stream_grids["span_reduce"] != n_win
                               or not 0 < stream_counts["edge_reduce"] <= n_win
                               or stream_grids["edge_reduce"] != stream_counts["edge_reduce"]):
        raise AssertionError(f"streaming folds: wrapper calls {nonzero(stream_counts)}, "
                             f"__global__ {nonzero(stream_grids)}")

    # ---- d. the card's registry against the CPU generator's: same windows,
    # same dictionary, so the same sids and edge ids
    def planes(g):
        procs = g._procs(GEN_TENANT)
        return procs["span-metrics"], procs["service-graphs"]

    (sm, sg), (csm, csg) = planes(gen), planes(cpu_gen)
    if [vars(k) for k in sm.key_list] != [vars(k) for k in csm.key_list] \
            or sg.edge_list != csg.edge_list:
        raise AssertionError("card and CPU generators hold different series or edges")
    sum_err = 0.0
    for a, b, exact, sums in ((sm, csm, ("calls", "lat_count", "lat_buckets"), ("lat_sum",)),
                              (sg, csg, ("counts", "failed_counts", "client_buckets",
                                         "server_buckets"), ("client_sum", "server_sum"))):
        for name in exact:
            if not np.array_equal(getattr(a, name), getattr(b, name)):
                raise AssertionError(f"card vs CPU generator: {name} differs")
        for name in sums:
            x, y = getattr(a, name), getattr(b, name)
            if not np.allclose(x, y, rtol=GEN_RTOL, atol=0):
                raise AssertionError(f"card vs CPU generator: {name} beyond rtol {GEN_RTOL}")
            sum_err = max(sum_err, float(np.abs(x - y).max()))
    n_series, n_edges = len(sm.key_list), len(sg.edge_list)
    if n_series == 0 or n_edges == 0 or int(sm.calls.sum()) != n_spans:
        raise AssertionError(f"{n_series} series, {n_edges} edges, {int(sm.calls.sum())} calls")
    log(f"[generator] card registry equals the CPU generator's: {n_series} series, {n_edges} "
        f"edges ({int(sg.counts.sum())} completed, {len(sg.pending)} pending, {sg.expired} "
        f"expired), counts and buckets exact, sums within rtol {GEN_RTOL} (max abs err "
        f"{sum_err:.3g} s)")

    # ---- e. the legacy planes on the card: the same traces, whole, one collect
    t1 = time.perf_counter()
    lsm, lsg = G.SpanMetricsProcessor(device=dev), G.ServiceGraphsProcessor(device=dev)
    whole = [t for _, t in traces]
    lsm.push(GEN_TENANT, whole)
    lsg.push(GEN_TENANT, whole)
    n_edge_rows = len(lsg._eid)
    lsm.collect()
    lsg.collect()
    legacy_s = time.perf_counter() - t1
    counts = dict(kernels.LAUNCHES)
    if dev.type == "cuda" and counts["span_reduce"] != stream_counts["span_reduce"] + 3:
        raise AssertionError(f"legacy collect: wrapper calls {nonzero(counts)}")

    def by_key(p):
        return {(k.service, k.span_name, k.kind, k.status): i for i, k in enumerate(p.key_list)}

    ks, kl = by_key(sm), by_key(lsm)
    es, el = {e: i for i, e in enumerate(sg.edge_list)}, {e: i for i, e in enumerate(lsg.edge_list)}
    if set(ks) != set(kl) or set(es) != set(el):
        raise AssertionError("streaming and legacy planes hold different series or edges")
    keys, edges = sorted(ks), sorted(es)
    si, li = [ks[k] for k in keys], [kl[k] for k in keys]
    sei, lei = [es[e] for e in edges], [el[e] for e in edges]
    for a, b, ia, ib, exact, sums in (
            (sm, lsm, si, li, ("calls", "lat_count", "lat_buckets"), ("lat_sum",)),
            (sg, lsg, sei, lei, ("counts", "failed_counts", "client_buckets", "server_buckets"),
             ("client_sum", "server_sum"))):
        for name in exact:
            if not np.array_equal(getattr(a, name)[ia], getattr(b, name)[ib]):
                raise AssertionError(f"streaming vs legacy: {name} differs")
        for name in sums:
            if not np.allclose(getattr(a, name)[ia], getattr(b, name)[ib], rtol=GEN_RTOL, atol=0):
                raise AssertionError(f"streaming vs legacy: {name} beyond rtol {GEN_RTOL}")
    log(f"[generator] legacy planes on the card ({n_spans} spans, {n_edge_rows} completed "
        f"edges, 3 B8a launches) in {legacy_s:.1f} s equal the streaming state by series key "
        f"and edge pair")

    # ---- f. a scrape, and the link's round trip
    t1 = time.perf_counter()
    lines = gen.metrics_text()
    scrape_s = time.perf_counter() - t1
    rtt = link_rtt_ms(dev)
    log(f"[generator] metrics_text: {len(lines)} lines in {scrape_s:.2f} s; link_rtt_ms({dev}) "
        f"= {rtt:.4f} ms; wrapper calls {nonzero(counts)}")
    return {"counts": counts, "last": last, "n_series": n_series,
            "b8b": (stream_counts["edge_reduce"], stream_grids["edge_reduce"])}


def phase_14_table(last, table, b8b_stream, n_series) -> dict:
    """B8a and B8b against their plain versions at the shape of phase 14's
    last window; times by CUDA events, the byte bound. B8b by both of its
    routes there; each over a sweep of window and table sizes against the
    plain version (B8b's by both routes: the sweep that sets
    EDGE_TILE_READS). Returns the calls to time for device_split."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import reduce as R

    def row(name, replaces, err, ms, pms, b):
        table.append({"name": name, "route": "cuda", "source": "tempo_tpu_torch/csrc/reduce.cu",
                      "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
                      "plain_ms": pms, "bound_ms": b[0], "bound_by": b[1], "library_ms": None})

    def compare(got, want, sums):
        err = 0.0
        for k, (g, w) in enumerate(zip(got, want)):
            if k in sums:
                if not torch.allclose(g, w, rtol=GEN_RTOL, atol=0):
                    raise AssertionError(f"output {k} beyond rtol {GEN_RTOL}")
                err = max(err, float((g - w).abs().max().item()))
            elif max_abs_err(g, w):
                raise AssertionError(f"output {k} (counts or histogram) differs")
        return err

    # B8a -- the last window's spans into the registry's series table;
    # the row times span_reduce (the fold and span_views), as before
    # the packed table
    def b8a_check(sid, dur, n_valid, edges, n_ids):
        kernels.reset_counts()
        got = kernels.span_reduce(sid, dur, n_valid, edges, n_ids)
        if kernels.grid_launches()["span_reduce"] != 1:
            raise AssertionError(f"B8a: {kernels.grid_launches()['span_reduce']} __global__ a "
                                 f"call")
        err = compare(got, R._reduce_plain(sid, dur, n_valid, edges, n_ids), (1,))
        fn = functools.partial(kernels.span_reduce, sid, dur, n_valid, edges, n_ids)
        return err, fn, cuda_ms(fn)

    sid, dur, n_valid, edges, sb = last["span_fold"]
    nb = edges.shape[0] + 1
    err, fn, ms = b8a_check(sid, dur, n_valid, edges, sb)
    pms = cuda_ms(lambda: R._reduce_plain(sid, dur, n_valid, edges, sb))
    b = bound(n_valid * 8 + 4 * sb * (nb + 2), n_valid * (nb - 1))
    log(f"[B8a] {n_valid} spans of {sid.shape[0]} into {sb} series x {nb} buckets: {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b[0]:.5f} ms, max abs err {err:.3g}; one download a window "
        f"of {n_series} x {nb + 2} words = {n_series * (nb + 2) * 4 / 1e6:.2f} MB")
    row("span_reduce", "tempo_tpu/ops/reduce.py:23", err, ms, pms, b)
    splits = {"B8a, phase 14's window": {"atomic": fn}}
    # the sweep: random windows made on the card, against the plain version
    gen = torch.Generator(device=sid.device).manual_seed(90)
    for n_rows in (305, 8480, 65536):
        for n_ids in (4096, 1 << 18):
            n = max(1024, n_rows)
            s = torch.randint(-2, min(n_ids, 180_000) + 2, (n,), device=sid.device,
                              generator=gen, dtype=torch.int32)
            d = torch.empty(n, device=sid.device).exponential_(20.0, generator=gen)
            err_s, fn_s, t = b8a_check(s, d, n_rows, edges, n_ids)
            splits[f"B8a sweep, {n_rows} rows x {n_ids} ids"] = {"atomic": fn_s}
            log(f"[B8a sweep] {n_rows} rows into {n_ids} ids: {t:.4f} ms, bound "
                f"{bound(n_rows * 8 + 4 * n_ids * (nb + 2), 0)[0]:.5f} ms; max abs err {err_s:.3g}")

    # B8b -- the last window's completed edges, by the route edge_plan
    # picks and by the other one
    def b8b_routes(eid, cdur, sdur, failed, n_valid, edges, n_ids):
        plan = kernels.edge_plan(n_valid, n_ids, nb)
        want = R._edge_reduce_plain(eid, cdur, sdur, failed, n_valid, edges, n_ids)
        err, ms = 0.0, {}
        for p in (plan, plan._replace(tiled=not plan.tiled)):
            kernels.reset_counts()
            got = kernels.edge_reduce(eid, cdur, sdur, failed, n_valid, edges, n_ids, p)
            if kernels.grid_launches()["edge_reduce"] != 1:
                raise AssertionError(f"B8b tiled={p.tiled}: not one __global__ a call")
            err = max(err, compare(got, want, (2, 3)))
            ms["tile" if p.tiled else "atomic"] = cuda_ms(
                lambda: kernels.edge_fold(eid, cdur, sdur, failed, n_valid, edges, n_ids, p))
        return plan, err, ms, want

    eid, cdur, sdur, failed, n_valid, edges, eb = last["edge_fold"]
    plan, err, ms2, _ = b8b_routes(eid, cdur, sdur, failed, n_valid, edges, eb)
    route = "tile" if plan.tiled else "atomic"
    ms = ms2[route]
    pms = cuda_ms(lambda: R._edge_reduce_plain(eid, cdur, sdur, failed, n_valid, edges, eb))
    b = bound(n_valid * 16 + 4 * eb * (2 * nb + 4), 2 * n_valid * (nb - 1))
    log(f"[B8b] {n_valid} edges of {eid.shape[0]} into {eb} edge ids: route {route} "
        f"({plan.ctas} CTAs of {plan.per} ids), {ms:.4f} ms; the other route "
        f"{ms2['atomic' if plan.tiled else 'tile']:.4f} ms; plain {pms:.4f} ms, bound "
        f"{b[0]:.5f} ms, max abs err {err:.3g}; phase 14's stream: {b8b_stream[0]} calls, "
        f"{b8b_stream[1]} __global__")
    row("edge_reduce", "tempo_tpu/ops/reduce.py:63", err, ms, pms, b)
    splits["B8b, phase 14's window"] = {("tile" if p.tiled else "atomic"): (
        lambda p=p: kernels.edge_fold(eid, cdur, sdur, failed, n_valid, edges, eb, p))
        for p in (plan, plan._replace(tiled=not plan.tiled))}
    # the sweep: random windows made on the card, each route against the
    # plain version
    gen = torch.Generator(device=eid.device).manual_seed(91)
    for n_rows in (305, 1024, 8192, 65536):
        for n_ids in (4096, 65536):
            n = max(1024, n_rows)
            e = torch.randint(-2, n_ids + 2, (n,), device=eid.device, generator=gen,
                              dtype=torch.int32)
            c = torch.empty(n, device=eid.device).exponential_(20.0, generator=gen)
            v = torch.empty(n, device=eid.device).exponential_(20.0, generator=gen)
            f = torch.randint(0, 2, (n,), device=eid.device, generator=gen, dtype=torch.int32)
            p, err_s, t, _ = b8b_routes(e, c, v, f, n_rows, edges, n_ids)
            log(f"[B8b sweep] {n_rows} rows into {n_ids} ids: tile {t['tile']:.4f} ms "
                f"({p.ctas} CTAs of {p.per} ids, {p.ctas * n_rows} id reads), atomic "
                f"{t['atomic']:.4f} ms; edge_plan takes the {'tile' if p.tiled else 'atomic'} "
                f"route (EDGE_TILE_READS {kernels.EDGE_TILE_READS}); max abs err {err_s:.3g}")
    return splits


MESH_WORLD, MESH_DP, MESH_SP = 4, 2, 2  # run 2: gloo ranks that share the card
MESH_TIMEOUT_S = 300.0
# K1_QUERIES labels whose stacked group runs 2 refuse before any IO
# (db/search._stacked_words_est; reckoned before the run): at sp = 2,
# `>>` and `~` hold 4 span columns x S_b (1,048,576) + the offsets +
# one gathered lhs mask (S_b x 2) + the gathered parent table and the
# doubling temporaries (4 x S_b x 2): 14.7 M words a block, x 10 blocks
# x 4 B = 588 MB > 512 MiB. Every other query fits (`span.attr`: 8.4 M
# words, 337 MB), and at sp = 1 all ten do (`>>` and `~` 9.5 M, 379 MB).
MESH_SEARCH_FALLBACK = ("descendant", "sibling")


class Capture:
    """The last arguments of patched callables, by name: the shapes the
    mesh path gave each kernel, for the kernel-vs-plain rows."""

    def __init__(self):
        self.args: dict[str, tuple] = {}
        self.calls: dict[str, int] = {}
        self._undo = []

    def patch(self, owner, attr: str, keep: bool = True) -> None:
        fn = getattr(owner, attr)

        def spy(*a, **k):
            self.calls[attr] = self.calls.get(attr, 0) + 1
            if keep:
                self.args[attr] = (a, k)
            return fn(*a, **k)

        setattr(owner, attr, spy)
        self._undo.append((owner, attr, fn))

    def restore(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


class Counts:
    """Launch counts path by path: take() reads the counts since the last
    take (or reset) and sets them to 0 for the next path."""

    def __init__(self):
        from tempo_tpu_torch import kernels

        self.kernels = kernels
        self.total: dict[str, int] = dict.fromkeys(kernels.LAUNCHES, 0)
        kernels.reset_counts()

    def take(self, what: str, need: tuple = ()) -> dict:
        c = dict(self.kernels.LAUNCHES)
        self.kernels.reset_counts()
        for k, v in c.items():
            self.total[k] += v
        missing = [k for k in need if c[k] <= 0]
        if missing:
            raise AssertionError(f"{what}: kernels not launched {missing}; counts {nonzero(c)}")
        return c


def stack_query(blocks, q: str, mesh):
    """A query's unpruned blocks, its one plan structure, and the group
    stacked for the mesh (db/search.stack_group), as search_blocks_device
    stacks it."""
    from tempo_tpu_torch.db import SearchRequest
    from tempo_tpu_torch.db import search as SM

    req = SearchRequest(query=q, limit=20)
    items = [(b, p) for b, p in ((b, SM._plan_for_block(b, req)) for b in blocks) if not p.prune]
    keys = {(p.tree, p.conds) for _, p in items}
    if len(keys) != 1:
        raise AssertionError(f"{q}: {len(keys)} plan structures over the blocks")
    tree, conds = keys.pop()
    stacked = SM.stack_group(items, tree, conds, mesh)
    if stacked is None:
        raise AssertionError(f"{q}: the stacked group was refused")
    return items, tree, conds, stacked


def blooms_of(blocks) -> list:
    from tempo_tpu_torch.block.bloom import ShardedBloom

    out = []
    for blk in blocks:
        b = ShardedBloom(blk.meta.bloom_shards, blk.meta.bloom_shard_bits)
        b.words = np.stack([blk.bloom_shard(i) for i in range(blk.meta.bloom_shards)])
        out.append(b)
    return out


def pad_stacked(host: dict, n_spans, Bp: int):
    """Stacked columns padded with empty blocks to Bp rows (offsets repeat
    their last value: empty segments; other columns PAD or 0)."""
    from tempo_tpu_torch.ops.device import PAD_I32

    out = {}
    for n, a in host.items():
        pad = np.zeros((Bp - a.shape[0],) + a.shape[1:], a.dtype)
        if n.endswith(".off") or n == "trace.span_off":
            pad[:] = 0
        elif a.dtype == np.int32:
            pad[:] = PAD_I32
        out[n] = np.concatenate([a, pad])
    return out, np.concatenate([n_spans, np.zeros(Bp - len(n_spans), np.int32)])


def run_step(mesh, blocks, q_codes, q: str, world: int, host_find, host_union):
    """distributed_query_step once: every block's ids, the 64 ids, one
    span query with the same operands in every block, every block's
    bloom; held against the three host entries called apart. The launch
    counts are set to 0 just before the step, so the caller reads the
    step's own launches, not those of the answer it is held against."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.parallel import distributed_query_step, sharded_search
    from tempo_tpu_torch.parallel import find as PF

    items, tree, conds, (host, n_spans, operands, nt) = stack_query(blocks, q, mesh)
    if len(items) != len(blocks) or any(
            not (np.array_equal(o.ints, operands[0].ints)
                 and np.array_equal(o.floats, operands[0].floats)) for o in operands[:len(items)]):
        raise AssertionError(f"step: {q} needs one operand set for every block")
    want_tm, want_sc = sharded_search(mesh, tree, conds, operands, host, n_spans, nt=nt)
    ids, n_valid, T = PF.stack_block_ids([b.trace_index["trace.id_codes"] for b in blocks], world)
    B = ids.shape[0]
    host, n_spans = pad_stacked(host, n_spans, B)
    blooms = np.zeros((B,) + blooms_of(blocks[:1])[0].words.shape, np.uint32)
    for i, b in enumerate(blooms_of(blocks)):
        blooms[i] = b.words
    names = tuple(sorted(host))
    S = host["span.trace_sid"].shape[1]
    R = next((host[n].shape[1] for n in names if n.startswith("res.")), 1)
    fn = distributed_query_step(mesh, tree, conds, names, B, T, q_codes.shape[0], S, R, nt, B,
                                blooms.shape[1], blooms.shape[2])
    kernels.reset_counts()
    t0 = time.perf_counter()
    hits, tm, sc, union = fn(ids, n_valid, q_codes, operands[0].ints, operands[0].floats, n_spans,
                             tuple(host[n] for n in names), blooms)
    step_s = time.perf_counter() - t0
    nb = len(want_tm)
    if not (np.array_equal(hits, host_find) and np.array_equal(tm[:nb], want_tm)
            and np.array_equal(sc[:nb], want_sc) and not tm[nb:].any()
            and np.array_equal(union, host_union) and want_tm.any()):
        raise AssertionError("step: differs from sharded_find, sharded_search and "
                             "sharded_bloom_union called apart")
    return step_s, int(tm.sum())


def phase_15(store, dev, tmp, ids64, seq_found, batch_q, block0_id, want16, metrics_want,
             lo_s, hi_s, search_want) -> dict:
    """The mesh: run 1 on a one-rank NCCL mesh calls the host entries at
    full size against the single-card routes; run 2 on a gloo 2x2 mesh
    of four processes on the card drives a TempoDB whose finds, burst,
    searches and metrics take the mesh routes, against phases 5-10; the
    composed step in both. Returns the wrapper calls of both runs, the
    captured kernel inputs and the shards of run 1's searches."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.block import schema as S
    from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
    from tempo_tpu_torch.db import batchexec as BX
    from tempo_tpu_torch.db import metrics_exec as ME
    from tempo_tpu_torch.db import search as SM
    from tempo_tpu_torch.db import tempodb as TDB
    from tempo_tpu_torch.db.metrics_mesh import try_metrics_mesh
    from tempo_tpu_torch.ops import bloom_ops as BO
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import find as FD
    from tempo_tpu_torch.ops import meshsearch as MS
    from tempo_tpu_torch.ops import multiquery as MQ
    from tempo_tpu_torch.ops import stage as ST
    from tempo_tpu_torch.parallel import find as PF
    from tempo_tpu_torch.parallel import (
        launch,
        mesh_eval_multiquery,
        sharded_bloom_union,
        sharded_search,
    )
    from tempo_tpu_torch.parallel import multiquery as PMQ
    from tempo_tpu_torch.parallel import timeseries as PTS
    from tempo_tpu_torch.traceql.plan import plan_search_request

    cap = Capture()
    cap.patch(PF, "find_elect")
    cap.patch(PMQ, "mq_partial")
    cap.patch(PMQ, "mq_combine")
    cap.patch(PMQ, "mesh_eval_multiquery")  # run 2's block, for M2 on every rank's slice
    cap.patch(PTS, "timeseries_stacked")
    shards_seen: list = []  # the ShardSearch of each sharded search, for the kernel rows
    partial0, fused0 = MS.ShardSearch.partial, MS.ShardSearch.partial_finish

    def partial_spy(self):
        shards_seen.append(self)
        return partial0(self)

    def fused_spy(self):  # an sp axis of one rank: M7 and M8 in one launch
        shards_seen.append(self)
        return fused0(self)

    MS.ShardSearch.partial = partial_spy
    MS.ShardSearch.partial_finish = fused_spy
    q_codes = np.asarray([S.trace_id_to_codes(t.rjust(16, b"\x00")) for t in ids64], np.int32)
    n_present = sum(seq_found.get(t) is not None for t in ids64)
    counts = Counts()
    shards, times = {}, {}
    try:
        # ---- run 1: one rank, the host entries called directly
        t_run = time.perf_counter()
        db = TempoDB(TempoDBConfig(), backend=LocalBackend(store), device=dev)
        db.poll_now()
        blocks = [db.open_block(m) for m in db.metas(TENANT)]
        t0 = time.perf_counter()
        mesh = launch.init_controller(1, f"file://{tmp}/pg-run1", "nccl", dev,
                                      timeout_s=MESH_TIMEOUT_S)
        up1_s = time.perf_counter() - t0  # the communicators are built here
        try:
            if db.mesh is not mesh or db._batch_mesh() is not None:
                raise AssertionError("run 1: TempoDB did not take the one-rank mesh")
            codes = [b.trace_index["trace.id_codes"] for b in blocks]
            t0 = time.perf_counter()
            rows = PF.sharded_find_rows(mesh, codes, q_codes)
            rows_s = time.perf_counter() - t0
            want_rows = FD.lookup_ids_blocks_cached(blocks, q_codes, dev)
            if not np.array_equal(rows, want_rows) or int((rows >= 0).any(axis=0).sum()) != \
                    n_present:
                raise AssertionError("run 1: sharded_find_rows differs from K3 on one card")
            before = dict(kernels.LAUNCHES)
            elect = PF.sharded_find(mesh, codes, q_codes)
            if (kernels.LAUNCHES["find_elect"] - before["find_elect"],
                    kernels.LAUNCHES["find"] - before["find"]) != (1, 0):
                raise AssertionError("run 1: sharded_find was not one find_elect launch")
            for qi in range(len(ids64)):
                hit = np.nonzero(want_rows[:, qi] >= 0)[0]
                want = (hit.max(), want_rows[hit.max(), qi]) if hit.size else (-1, -1)
                if tuple(elect[qi]) != tuple(int(x) for x in want):
                    raise AssertionError(f"run 1: sharded_find of {ids64[qi].hex()}: "
                                         f"{tuple(elect[qi])} != {want}")
            blooms = blooms_of(blocks)
            before, gathers = dict(kernels.LAUNCHES), mesh.calls["all_gather"]
            union = sharded_bloom_union(mesh, blooms)
            u_b10a = kernels.LAUNCHES["bloom_union"] - before["bloom_union"]
            u_gathers = mesh.calls["all_gather"] - gathers
            if (u_b10a, u_gathers) != (1, 0):  # an axis of one rank gathers nothing
                raise AssertionError(f"run 1: sharded_bloom_union made {u_b10a} B10a and "
                                     f"{u_gathers} all_gather (1 and 0 expected)")
            if not np.array_equal(union.words, BO.union_blooms(blooms, dev).words):
                raise AssertionError("run 1: sharded_bloom_union differs from B10a on one card")
            log(f"[mesh run 1] sharded_bloom_union of {len(blooms)} blooms: {u_b10a} B10a, "
                f"{u_gathers} all_gather; equal to B10a on one card")
            blk0 = blocks[0]
            bplans = [plan_search_request(blk0.dictionary, {}, query=q) for q in batch_q]
            lowered = [MQ.lower_plan(p) for p in bplans]
            staged = ST.stage_block(blk0, F.required_columns(bplans[0].conds)
                                    + ["trace.start_ms"], device=dev)
            progs = MQ.pack_queries(lowered, len(lowered))
            tm, cnt = mesh_eval_multiquery(mesh, lowered, staged, progs)
            tm1, c1 = MQ.eval_multiquery(lowered, staged, progs)
            if not (np.array_equal(tm, tm1.cpu().numpy()) and np.array_equal(cnt, c1.cpu().numpy())
                    and tm.any(axis=1).all()):
                raise AssertionError("run 1: mesh_eval_multiquery differs from B5a on one card")
            del staged, tm1, c1
            # one stacked fold (run 2 takes all four): the cut that keeps the
            # smoke inside its limit
            for mq_text, want in zip(METRICS_QUERIES[:1], metrics_want[:1]):
                mreq = ME.align_params(mq_text, lo_s, hi_s, METRICS_STEP_S)
                resp = ME.MetricsResponse(fn=want.fn, start_ms=mreq.start_ms,
                                          step_ms=mreq.step_ms, n_buckets=mreq.n_buckets,
                                          label_names=want.label_names)
                t0 = time.perf_counter()
                ok = try_metrics_mesh(mesh, blocks, ME.parse_metrics_query(mq_text), mreq, resp)
                if not ok or not same_series(resp, want):
                    raise AssertionError(f"run 1: the stacked fold of {mq_text} (taken: {ok}) "
                                         "differs from phase 10")
                log(f"[mesh run 1] {mq_text}: stacked fold of {len(blocks)} blocks equals "
                    f"phase 10, {time.perf_counter() - t0:.2f} s")
            counts.take("run 1: find, union, multiquery, fold",
                        ("find", "find_elect", "bloom_union", "mq_partial", "mq_combine",
                         "timeseries_stacked"))

            # the sharded search of the 8 K1 forms, per-block operands,
            # against K1 block by block (the K1 runs are not on the path)
            groups, want_k1 = {}, {}
            for label, q in K1_QUERIES:
                items, tree, conds, stacked = stack_query(blocks, q, mesh)
                groups[label] = (tree, conds, stacked)
                k1 = []
                for blk, p in items:
                    st = ST.stage_block(blk, F.required_columns(p.conds) + list(p.extra_cols),
                                        cache=False, device=dev)
                    k1.append([t.cpu().numpy() for t in F.eval_block(
                        (p.tree, p.conds), st.cols, F.Operands.build(p.rows, p.tables or None),
                        st.n_spans, st.n_traces, st.n_spans_b, st.n_res_b, st.n_traces_b,
                        span_out=False)])
                    del st
                want_k1[label] = k1
            kernels.reset_counts()
            t0 = time.perf_counter()
            for label, q in K1_QUERIES:
                tree, conds, (host, n_spans, operands, nt) = groups[label]
                t1 = time.perf_counter()
                tm, sc = sharded_search(mesh, tree, conds, operands, host, n_spans, nt=nt)
                times[label] = time.perf_counter() - t1
                if label in ("span", "sattr", "child"):
                    shards[label] = shards_seen[-1]
                shards_seen.clear()
                for bi, (tm1, c1) in enumerate(want_k1[label]):
                    if not (np.array_equal(tm[bi], tm1) and np.array_equal(sc[bi], c1)):
                        raise AssertionError(f"run 1: sharded search {label} block {bi} differs "
                                             "from K1")
                times[label] = (round(times[label], 3), int(tm.sum()))
            search1_s = time.perf_counter() - t0
            del groups, want_k1
            c_search = counts.take("run 1: 8 sharded searches",
                                   ("filter", "attr_partial", "search_fused"))
            if c_search["search_fused"] != len(K1_QUERIES) or c_search["search_partial"] or \
                    c_search["search_finish"]:
                raise AssertionError(f"run 1 (sp = 1): M7 and M8 not fused {nonzero(c_search)}")
            log(f"[mesh run 1] 8 sharded searches ({len(blocks)} blocks, per-block operands) "
                f"equal K1 block by block, {search1_s:.2f} s "
                f"(s, traces: {times}); wrapper calls "
                f"{nonzero(c_search)}")

            # the stacked route for the 10 searches, against phase 6
            t0 = time.perf_counter()
            stacked1 = []
            for q, want in zip(SEARCH_QUERIES, search_want):
                got = SM.search_blocks_device(blocks, SearchRequest(query=q, limit=20), mesh)
                shards_seen.clear()
                if got is None or not same_response(got, want):
                    raise AssertionError(f"run 1: search_blocks_device {q} differs from phase 6")
                stacked1.append(got)
            stacked1_s = time.perf_counter() - t0
            c_stacked = counts.take("run 1: search_blocks_device", ("filter", "search_fused"))
            for what, c in (("8 sharded searches", c_search), ("stacked searches", c_stacked)):
                if c["mask_pack"] or c["struct_packed"]:  # sp = 1 gathers nothing
                    raise AssertionError(f"run 1 (sp = 1): M6 launched in the {what} "
                                         f"{nonzero(c)}")
            log(f"[mesh run 1] search_blocks_device of the 10 searches: {stacked1_s:.2f} s, "
                f"equal to phase 6; wrapper calls {nonzero(c_stacked)}")
            # the per-block route's answers for the queries run 2 refuses
            budget, SM._DEVICE_SEARCH_MAX_BYTES = SM._DEVICE_SEARCH_MAX_BYTES, 0
            try:
                per_block = {label: db.search_blocks(TENANT, db.metas(TENANT),
                                                     SearchRequest(query=q, limit=20))
                             for label, q in K1_QUERIES if label in MESH_SEARCH_FALLBACK}
            finally:
                SM._DEVICE_SEARCH_MAX_BYTES = budget
            gathers = mesh.calls["all_gather"]
            step1_s, step1_hits = run_step(mesh, blocks, q_codes, K1_QUERIES[0][1], 1, elect,
                                           union.words)
            step1_gathers = mesh.calls["all_gather"] - gathers
            shards_seen.clear()
            c_step = counts.take("run 1: the step", ("find_elect", "bloom_union", "filter",
                                                     "search_fused"))
            if (c_step["find_elect"], c_step["find"]) != (1, 0):
                raise AssertionError(f"run 1: the step's find was not one find_elect launch: "
                                     f"{nonzero(c_step)}")
            if (c_step["bloom_union"], step1_gathers) != (1, 0):
                raise AssertionError(f"run 1: the step's union made {c_step['bloom_union']} "
                                     f"B10a and {step1_gathers} all_gather (1 and 0 expected)")
            elect1 = cap.args["find_elect"]  # run 1's shape, for M1's row
            log(f"[mesh run 1] distributed_query_step ({len(ids64)} ids, {K1_QUERIES[0][1]}, "
                f"{len(blocks)} blooms): {step1_s:.2f} s, {step1_hits} traces, equal to the three "
                f"host entries; wrapper calls {nonzero(c_step)}")
            secs1, calls1 = mesh.collective_seconds(), dict(mesh.calls)
        finally:
            launch.shutdown(mesh, [])
        del db, blocks, codes, blooms
        log(f"[mesh run 1] nccl world 1 on {dev}: up in {up1_s:.2f} s; find rows "
            f"({len(ids64)} ids x {len(want_rows)} blocks) {rows_s:.3f} s, elect, union, "
            f"multiquery and a stacked fold equal the single-card routes; collectives (s) "
            f"{ {k: round(v, 6) for k, v in secs1.items()} }, calls {calls1}; "
            f"{time.perf_counter() - t_run:.1f} s")

        # ---- run 2: gloo 2x2, four processes on the card, TempoDB routes
        t_run = time.perf_counter()
        free0 = torch.cuda.mem_get_info(dev)[0]
        init = f"file://{tmp}/pg-run2"
        procs = launch.spawn_followers(MESH_WORLD, init, "gloo", dev, dp=MESH_DP, sp=MESH_SP,
                                       timeout_s=MESH_TIMEOUT_S)
        mesh = launch.init_controller(MESH_WORLD, init, "gloo", dev, dp=MESH_DP, sp=MESH_SP,
                                      timeout_s=MESH_TIMEOUT_S)
        codes = None
        try:
            up_s = time.perf_counter() - t_run
            db = TempoDB(TempoDBConfig(device_promote_touches=1), backend=LocalBackend(store),
                         device=dev)
            db.poll_now()
            metas = db.metas(TENANT)
            if db.mesh is not mesh or db._batch_mesh() is not mesh:
                raise AssertionError("run 2: TempoDB did not take the 2x2 mesh")
            r0 = BX.routing_counts()
            # the single-card K3 lookup under both names the find routes call
            # it by (tempodb imports it at load, the batcher at each group)
            cap.patch(FD, "lookup_ids_blocks_cached", keep=False)
            cap.patch(TDB, "lookup_ids_blocks_cached", keep=False)
            cap.patch(PF, "sharded_find_rows", keep=False)
            t0 = time.perf_counter()
            cands = [[m for m in metas if m.may_contain_id(t.rjust(16, b"\x00").hex())]
                     for t in ids64]
            got = db.find_in_blocks_multi([(TENANT, t, c) for t, c in zip(ids64, cands)])
            lone = ids64[:8] + ids64[-4:]
            for t in lone:  # lone finds: the batcher's one-item groups
                got.append(db.find_trace_by_id(TENANT, t))
            find_s = time.perf_counter() - t0
            for t, g in zip(ids64 + lone, got):
                w = seq_found.get(t)
                if (g is None) != (w is None) or (w is not None and
                                                  dataclasses.asdict(g) != dataclasses.asdict(w)):
                    raise AssertionError(f"run 2: find {t.hex()} differs from phase 5")
            meta0 = next(m for m in metas if m.block_id == block0_id)
            reqs16 = [SearchRequest(query=q, limit=20) for q in batch_q]
            t0 = time.perf_counter()
            burst = db.search_blocks_multi([(TENANT, [meta0], r) for r in reqs16])
            burst_s = time.perf_counter() - t0
            if not all(same_response(g, w) for g, w in zip(burst, want16)):
                raise AssertionError("run 2: the 16-query burst differs from phase 8")
            t0 = time.perf_counter()
            for mq_text, want in zip(METRICS_QUERIES, metrics_want):
                r = db.metrics_query_range(TENANT, ME.align_params(mq_text, lo_s, hi_s,
                                                                   METRICS_STEP_S))
                if not same_series(r, want):
                    raise AssertionError(f"run 2: {mq_text} differs from phase 10")
            metrics_s = time.perf_counter() - t0
            counts.take("run 2: finds, burst, metrics",
                        ("find", "mq_partial", "mq_combine", "timeseries_stacked"))

            # the 10 searches through TempoDB.search_blocks: the stacked
            # route, or the per-block route where the budget refuses
            routed: list = []
            device0 = TDB.search_blocks_device

            def device_spy(*a, **k):
                out = device0(*a, **k)
                routed.append(out is not None)
                shards_seen.clear()
                return out

            TDB.search_blocks_device = device_spy
            try:
                t0 = time.perf_counter()
                for (label, _), q, want1 in zip(K1_QUERIES + [("", "")] * 2, SEARCH_QUERIES,
                                                stacked1):
                    r = db.search(TENANT, SearchRequest(query=q, limit=20))
                    want = per_block.get(label, want1)
                    if not same_response(r, want):
                        raise AssertionError(f"run 2: search {q} differs from run 1's answer on "
                                             "its route")
                search2_s = time.perf_counter() - t0
            finally:
                TDB.search_blocks_device = device0
            want_routed = [label not in MESH_SEARCH_FALLBACK
                           for label, _ in K1_QUERIES + [("", "")] * 2]
            c_search2 = counts.take("run 2: 10 searches through TempoDB",
                                    ("filter", "attr_partial", "mask_pack", "struct_packed",
                                     "search_partial", "search_finish"))
            if c_search2["mask_pack"] != c_search2["struct_packed"]:
                raise AssertionError(f"run 2 (sp = {MESH_SP}): a pack a struct node and its "
                                     f"packed struct read expected {nonzero(c_search2)}")
            if c_search2["search_fused"]:
                raise AssertionError(f"run 2 (sp = {MESH_SP}): the fused route launched "
                                     f"{nonzero(c_search2)}")
            routes = {k: v - r0.get(k, 0) for k, v in BX.routing_counts().items()
                      if v != r0.get(k, 0)}
            blocks = [db.open_block(m) for m in metas]
            host_find = PF.sharded_find(mesh, [b.trace_index["trace.id_codes"] for b in blocks],
                                        q_codes)
            before, gathers = dict(kernels.LAUNCHES), mesh.calls["all_gather"]
            host_union = sharded_bloom_union(mesh, blooms_of(blocks)).words
            u2_b10a = kernels.LAUNCHES["bloom_union"] - before["bloom_union"]
            u2_gathers = mesh.calls["all_gather"] - gathers
            if (u2_b10a, u2_gathers) != (3, 2):  # this rank's, the sp and the dp partials
                raise AssertionError(f"run 2: sharded_bloom_union made {u2_b10a} B10a and "
                                     f"{u2_gathers} all_gather on rank 0 (3 and 2 expected)")
            step2_s, step2_hits = run_step(mesh, blocks, q_codes, K1_QUERIES[0][1], MESH_WORLD,
                                           host_find, host_union)
            shards_seen.clear()
            c_step2 = counts.take("run 2: the step", ("find_elect", "bloom_union",
                                                      "filter", "search_partial",
                                                      "search_finish"))
            if (c_step2["find_elect"], c_step2["find"]) != (1, 0):  # run_step resets the counts
                raise AssertionError(f"run 2: the step's find was not one find_elect launch: "
                                     f"{nonzero(c_step2)}")
            if c_step2["bloom_union"] != 3:
                raise AssertionError(f"run 2: the step's union made {c_step2['bloom_union']} "
                                     f"B10a on rank 0 (3 expected)")
            free1 = torch.cuda.mem_get_info(dev)[0]
            smi_mem = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                                      "--format=csv,noheader"], capture_output=True, text=True,
                                     check=True).stdout.strip()
            secs2, calls2 = mesh.collective_seconds(), dict(mesh.calls)
        finally:
            cap.restore()
            codes = launch.shutdown(mesh, procs, join_timeout_s=60)
        n_sharded = cap.calls.get("sharded_find_rows", 0)
        log(f"[mesh run 2] 10 searches through TempoDB: {search2_s:.2f} s, stacked route "
            f"{routed} (predicted {want_routed}), answers equal run 1's route; wrapper calls "
            f"{nonzero(c_search2)}; step {step2_s:.2f} s, {step2_hits} traces, equal to the "
            f"three host entries, wrapper calls {nonzero(c_step2)}; sharded_bloom_union "
            f"{u2_b10a} B10a and {u2_gathers} all_gather on rank 0")
        log(f"[mesh run 2] gloo {MESH_DP}x{MESH_SP} on {dev}: up in {up_s:.1f} s; "
            f"{len(got)} finds {find_s:.2f} s in {n_sharded} sharded finds "
            f"({cap.calls.get('lookup_ids_blocks_cached', 0)} single-card K3 lookups); burst "
            f"{burst_s:.2f} s; 4 metrics queries {metrics_s:.2f} s; routing {routes}; "
            f"collectives (s) { {k: round(v, 6) for k, v in secs2.items()} }, calls {calls2}; "
            f"card memory free {free0 / 2**30:.2f} -> {free1 / 2**30:.2f} GiB of this process's "
            f"view, nvidia-smi used/total {smi_mem}; followers exit {codes}; "
            f"{time.perf_counter() - t_run:.1f} s")
        if codes != [0] * (MESH_WORLD - 1):
            raise AssertionError(f"run 2: followers exited {codes}")
        # the batcher cuts each candidate set's ids into groups of at most
        # its cap, as the reference's does: a group of one takes
        # _device_find (tempo_tpu/db/batchexec.py:419-420) and records no
        # route. A group or lone find that some block's bloom passes makes
        # one sharded find; one that passes none looks nothing up.
        def gated(pairs):
            return any(db.open_block(m).bloom_test(t) for t, c in pairs for m in c)

        per_key = {}
        for t, c in zip(ids64, cands):
            if c:
                per_key.setdefault(tuple(m.block_id for m in c), []).append((t, c))
        cap_n, grouped, want_sharded = db.batchers.find.max_batch, 0, 0
        for pairs in per_key.values():
            for i in range(0, len(pairs), cap_n):
                chunk = pairs[i:i + cap_n]
                if gated(chunk):
                    want_sharded += 1
                    grouped += len(chunk) if len(chunk) > 1 else 0
        want_sharded += sum(gated([(t, c)]) for t, c in zip(lone, cands[:8] + cands[-4:]))
        want_routes = {("find_batch", "mesh", "coalesced"): grouped,
                       ("search_batch", "mesh", "mesh_batched"): len(reqs16),
                       ("metrics_mesh", "device", "stacked"): len(METRICS_QUERIES) * len(metas),
                       ("search_mesh", "fallback", "pre_io_budget"):
                           len(MESH_SEARCH_FALLBACK) * len(metas)}
        bad = {k: (routes.get(k, 0), v) for k, v in want_routes.items() if routes.get(k, 0) != v}
        off = [k for k in routes if k not in want_routes]
        if bad or off or cap.calls.get("lookup_ids_blocks_cached", 0) or \
                n_sharded != want_sharded or routed != want_routed:
            raise AssertionError(f"run 2: routes {routes}, {n_sharded} sharded finds, stacked "
                                 f"searches {routed}; expected {want_routes}, {want_sharded} "
                                 f"sharded finds, {want_routed}")
    finally:
        cap.restore()
        MS.ShardSearch.partial = partial0
    cap.args["find_elect"] = elect1
    return {"counts": counts.total, "args": cap.args, "shards": shards}


def phase_15_table(p15: dict, table) -> dict:
    """M1-M8 against their plain versions at the shapes the mesh path gave
    them (M1 from run 1, M2-M4 from run 2's rank 0, M5-M8 and the fused
    route from run 1's sharded searches); times by CUDA events, the bound
    of each; M7's one-call yardstick (torch.segment_reduce), none for the
    rest (no one call computes them). Returns M1's device-time split (the
    fused launch, K3 alone), M5's by leaf and M7's, M8's and the fused
    route's (device_split's input)."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import find as FD
    from tempo_tpu_torch.ops import multiquery as MQ
    from tempo_tpu_torch.ops import timeseries as TS

    def row(name, source, replaces, err, ms, pms, b, lms=None):
        table.append({"name": name, "route": "cuda", "source": f"tempo_tpu_torch/csrc/{source}",
                      "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
                      "plain_ms": pms, "bound_ms": b[0], "bound_by": b[1], "library_ms": lms})

    args = p15["args"]

    # M1 -- run 1's sharded find on its one rank: K3's search and the
    # election in one launch, against the plain election over the plain
    # search; beside it K3 then the old two stages' arithmetic (plain)
    (ids, qs, nv, steps, base), _ = args["find_elect"]
    kernels.reset_counts()
    got = kernels.find_elect(ids, qs, nv, steps, base)
    err = max_abs_err(got, FD._find_elect_plain(FD._bisect_plain(ids, qs, nv, steps), base))
    bl, q = ids.shape[0], qs.shape[0]
    if err or kernels.grid_launches()["find_elect"] != -(-bl // kernels.FIND_BLOCKS):
        raise AssertionError("M1 differs from its plain version, or took more __global__ than "
                             "one a 64 blocks")

    def two_stage(rows):
        gblock = base + torch.arange(bl, dtype=torch.int32, device=rows.device)[:, None]
        blk = torch.where(rows >= 0, gblock, -1)
        best = blk.amax(dim=0)
        return best, torch.where(blk == best[None, :], rows, -1).amax(dim=0)

    def m1():
        return kernels.find_elect(ids, qs, nv, steps, base)

    ms = cuda_ms(m1)
    pms = cuda_ms(lambda: FD._find_elect_plain(FD._bisect_plain(ids, qs, nv, steps), base))
    k3_two_ms = cuda_ms(lambda: two_stage(kernels.find_rows(ids, qs, nv, steps)))
    probes = sum(int(n).bit_length() + 1 for n in nv.tolist() if n > 0)  # rows a query needs
    b = bound(q * 16 + bl * 4 + probes * q * 16 + q * 8, probes * q * 8)
    log(f"[M1] Bl={bl} T={ids.shape[1]} Q={q} (K3 and the election, one launch): {ms:.4f} ms, "
        f"plain {pms:.4f} ms, K3 then the two stages' arithmetic (plain) {k3_two_ms:.4f} ms, "
        f"bound {b[0]:.6f} ms")
    row("find_elect", "find.cu", "tempo_tpu/parallel/find.py:44-64", err, ms, pms, b)
    m1_split = {f"M1, phase 15's run 1 (Bl={bl}, Q={q})": {
        "K3 and the election, one launch": m1,
        "K3 alone": functools.partial(kernels.find_rows, ids, qs, nv, steps)}}

    # M2, M3 -- run 2's last window on rank 0's row slice (timed); M2
    # also on the other ranks' slices of the same block, where traces are
    # cut at the slice's start
    (prow, dims, span_mat, row0, span_off, n_spans), _ = args["mq_partial"]
    (_, lowered, staged, _), _ = args["mesh_eval_multiquery"]
    tables = MQ.program_tables(prow, dims)
    q_b, sl = prow.shape[0], span_mat.shape[1]
    names = lowered[0].shape.span_cols
    whole = (torch.stack([staged.cols[c] for c in names]) if names else
             torch.zeros((1, staged.n_spans_b), dtype=torch.int32, device=span_mat.device))
    if row0 != 0 or not torch.equal(whole[:, :sl], span_mat):
        raise AssertionError("M2: the captured slice is not rank 0's of the captured block")
    err = 0
    for r0 in range(0, whole.shape[1], sl):
        sm = span_mat if r0 == 0 else whole[:, r0:r0 + sl].contiguous()
        got_r = kernels.mq_partial(prow, dims, sm, r0, span_off, n_spans)
        err = max(err, max_abs_err(got_r, MQ._mq_partial_plain(sm, span_off, tables, r0,
                                                               n_spans)))
        if r0 == 0:
            got = got_r
    if err:
        raise AssertionError("M2 differs from its plain version")
    del whole
    n_conds = int((tables["cond_op"] >= 0).sum(dim=1).max().item())
    ms = cuda_ms(lambda: kernels.mq_partial(prow, dims, span_mat, row0, span_off, n_spans))
    m2_us = device_ms(lambda: kernels.mq_partial(prow, dims, span_mat, row0, span_off,
                                                 n_spans)) * 1e3
    pms = cuda_ms(lambda: MQ._mq_partial_plain(span_mat, span_off, tables, row0, n_spans),
                  reps=3, warm=1)
    b = bound(span_mat.numel() * 4 + span_off.numel() * 4 + got.numel() * 4,
              q_b * sl * max(1, n_conds))
    log(f"[M2] Q={q_b} slice {sl} rows at {row0} (equal to the plain version on all "
        f"{staged.n_spans_b // sl} slices), {span_mat.shape[0]} columns: {ms:.4f} ms, "
        f"device {m2_us:.2f} µs (queued), plain {pms:.4f} ms, bound {b[0]:.5f} ms")
    row("mq_partial", "multiquery.cu", "tempo_tpu/parallel/multiquery.py:130", err, ms, pms, b)
    (crow, cdims, counts, trace_mat, n_traces), _ = args["mq_combine"]
    ctables = MQ.program_tables(crow, cdims)
    got = kernels.mq_combine(crow, cdims, counts, trace_mat, n_traces)
    err = max_abs_err(got, MQ._mq_combine_plain(counts, trace_mat, ctables, n_traces))
    if err:
        raise AssertionError("M3 differs from its plain version")
    nt_b = counts.shape[2]
    ms = cuda_ms(lambda: kernels.mq_combine(crow, cdims, counts, trace_mat, n_traces))
    m3_us = device_ms(lambda: kernels.mq_combine(crow, cdims, counts, trace_mat,
                                                 n_traces)) * 1e3
    pms = cuda_ms(lambda: MQ._mq_combine_plain(counts, trace_mat, ctables, n_traces))
    b = bound(counts.numel() * 4 + trace_mat.numel() * 4 + q_b * nt_b * 5, q_b * nt_b)
    log(f"[M3] Q={q_b} x {nt_b} traces: {ms:.4f} ms, device {m3_us:.2f} µs (queued; M2 "
        f"{m2_us:.2f}), plain {pms:.4f} ms, bound {b[0]:.5f} ms")
    row("mq_combine", "multiquery.cu", "tempo_tpu/parallel/multiquery.py:130", err, ms, pms, b)

    # M4 -- run 2's last stacked fold on rank 0's blocks
    (query, cols, operands, gid, val, vpres, t0s, nspans, step, nb, ng), _ = \
        args["timeseries_stacked"]
    want = TS._timeseries_stacked_plain(query[0], query[1], cols, operands, gid, val, vpres,
                                        t0s.tolist(), nspans.tolist(), step, nb, ng)
    err = 0.0
    for plan in (None, *(kernels.timeseries_route(rt, ng * nb, val is not None)
                         for rt in ("shared", "cluster", "global"))):
        kernels.reset_counts()
        got = TS.timeseries_stacked(query, cols, operands, gid, val, vpres, t0s, nspans, step, nb,
                                    ng, plan)
        if kernels.grid_launches()["timeseries_stacked"] != 1:
            raise AssertionError(f"M4 ({plan}): not one __global__ a fold")
        for k, (g, w) in enumerate(zip(got, want)):
            if k == 2:
                if not torch.allclose(g, w, rtol=1e-5, atol=0):
                    raise AssertionError("M4's f32 sums beyond rtol 1e-5")
                err = max(err, float((g - w).abs().max().item()))
            elif max_abs_err(g, w):
                raise AssertionError(f"M4 ({plan}) output {k} differs from its plain version")
    if len(want) == 5:
        mn, mx = kernels.timeseries_stacked_finish(got[3].clone(), got[4].clone())
        if not (torch.equal(mn.view(torch.int32), TS.ts_decode(want[3]).view(torch.int32))
                and torch.equal(mx.view(torch.int32), TS.ts_decode(want[4]).view(torch.int32))):
            raise AssertionError("M4's finish differs from the plain decode")
    prog, buf, blocks = TS.stacked_program(query, cols, operands, t0s, nspans)

    def m4():
        return kernels.timeseries_stacked(prog, buf, blocks, cols, gid, val, vpres, step, nb, ng)

    ms = cuda_ms(m4)
    m4_us = device_ms(m4) * 1e3
    pms = cuda_ms(lambda: TS._timeseries_stacked_plain(query[0], query[1], cols, operands, gid,
                                                       val, vpres, t0s.tolist(), nspans.tolist(),
                                                       step, nb, ng), reps=3, warm=1)
    spans = int(nspans.sum())
    named = {c.col if c.target != "res" else f"span@{c.col}" for c in query[1]}
    per_span = 8 + 4 * len([n for n in named if not n.startswith("trace.")]) \
        + (4 if any(n.startswith("trace.") for n in named) else 0) + (5 if val is not None else 0)
    b = bound(spans * per_span + ng * nb * 4 * len(want), spans * 4)
    log(f"[M4] {gid.shape[0]} blocks, {spans} spans into {ng} x {nb} "
        f"({kernels.timeseries_plan(ng * nb, val is not None).route} route): {ms:.4f} ms, "
        f"device {m4_us:.2f} µs (queued), plain {pms:.4f} ms, bound {b[0]:.5f} ms, "
        f"max abs err {err:.3g}")
    row("timeseries_stacked", "timeseries.cu", "tempo_tpu/parallel/timeseries.py:51-131", err, ms,
        pms, b)
    return {**m1_split, **phase_15_search_table(p15["shards"], row)}


def phase_15_search_table(shards: dict, row) -> dict:
    """M5-M8 against their plain versions on the shards of run 1's
    sharded searches (10 blocks at full width, one rank): M5 on the
    `span.attr` query (and an `any` leaf of its key on the same rows),
    M6's pack of the `>` query's lhs slot and K1's struct pass reading
    it packed (on the slot's two sp = 2 halves, as run 2 runs them, and
    whole), M7 and M8 on the span query, then the fused
    route of both on it. No one PyTorch call computes any of them but M7
    (torch.segment_reduce a slot). Returns M5's calls by leaf, M6's (and
    the struct pass over the byte mask beside the packed one) and M7's,
    M8's and the fused route's calls."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import meshsearch as MS

    def check(got, want, what):
        if not torch.equal(got, want):
            raise AssertionError(f"{what} differs from its plain version")
        return 0

    # M5 -- the span attr leaf's counts, then its mask
    sh = shards["sattr"]
    i, slot = next(iter(sh.prog.leaf_slots.items()))
    c = sh.conds[i]
    n_seg, al = sh.cols["sattr.off"].shape[1] - 1, sh.cols["sattr.key_id"].shape[1]
    cnt = kernels.attr_partial(sh.descs, i, n_seg, al, 0)
    err = check(cnt, MS._attr_partial_plain(c, sh.cols, sh.ops_i, sh.ops_f, i, sh.tables.get(i),
                                            0), "M5")
    kernels.attr_mask(cnt, None, sh.n_spans_t, 0, sh.slots, slot)
    check(sh.slot(slot) != 0, MS._attr_mask_plain(cnt, None, sh.n_spans_t, 0, sh.sl), "M5's mask")
    ms = cuda_ms(lambda: kernels.attr_partial(sh.descs, i, n_seg, al, 0))
    pms = cuda_ms(lambda: MS._attr_partial_plain(c, sh.cols, sh.ops_i, sh.ops_f, i,
                                                 sh.tables.get(i), 0), reps=3, warm=1)
    # the bytes this leaf needs: every real row's key, the vtype and value
    # of the rows whose key matches (the only rows M5 reads them for), the
    # offsets and the counts
    last = sh.cols["sattr.off"][:, -1:]
    rows_real = int(last.sum().item())
    real = torch.arange(al, device=last.device)[None] < last
    n_key = int(((sh.cols["sattr.key_id"] == sh.ops_i[:, i, 0:1]) & real).sum().item())
    per_key = 0 if c.col == "any" else \
        4 + sh.cols[f"sattr.{F._ATTR_VALUE_COL[c.col]}"].element_size()
    bl = sh.slots.shape[0]
    b = bound(rows_real * 4 + n_key * per_key + bl * (n_seg + 1) * 4 + bl * n_seg * 4,
              rows_real + n_key * 2)
    log(f"[M5] {bl} blocks, {rows_real} attr rows ({n_key} of the leaf's key) into {n_seg} "
        f"owners: {ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.5f} ms")
    row("attr_partial", "meshsearch.cu", "tempo_tpu/parallel/search.py:122-170", err, ms, pms, b)
    # the sweep: an `any` leaf of the same key over the same shard rows
    # (each key row a hit: no vtype or value read)
    anyc = F.Cond("sattr", "any", "exists")
    ints = sh.ops_i[:, i:i + 1].cpu().numpy().copy()
    ints[:, :, 1:] = 0
    sh_any = MS.ShardSearch(F.normalize_tree(("cond", 0), (anyc,)), (anyc,), sh.cols, ints,
                            np.zeros((bl, 1, 2), np.float32), {}, sh.n_spans, sh.sp_index, sh.nt)
    check(kernels.attr_partial(sh_any.descs, 0, n_seg, al, 0),
          MS._attr_partial_plain(anyc, sh.cols, sh_any.ops_i, sh_any.ops_f, 0, None, 0),
          "M5's any leaf")
    # descs holds the addresses of the ShardSearch's descriptor tables
    # (its bufs), so each call holds the ShardSearch: the splits run after
    # this function returns, when sh_any would be gone and its tables freed
    def m5_call(s_, j):
        return kernels.attr_partial(s_.descs, j, n_seg, al, 0)

    m5_splits = {f"M5 by leaf, phase 15's shard ({bl} x {n_seg} owners, {rows_real} rows)": {
        c.col: functools.partial(m5_call, s_, j) for c, s_, j in ((c, sh, i), (anyc, sh_any, 0))}}

    # M6 -- the `>` node's lhs mask packed, then K1's shard struct pass
    # reading the packed row (M6's unpack), each against its plain version
    # (the struct step over the unpacked row): at run 2's shape (sp = 2:
    # each shard's half-width slot view, the two packed halves joined as
    # the all_gather joins them, each shard's pass from its row0), then
    # at run 1's (the whole block's slot view, row0 0), which is timed.
    # Every output slot is filled with 7 first: a pass that leaves rows
    # unwritten fails the check
    sh = shards["child"]
    _, op, lslot, rslot, oslot = next(st for st in sh.prog.steps if st[0] == "struct")
    pidx = sh.cols["span.parent_idx"]
    half = sh.sl // 2
    halves = [sh.slots[:, :, k * half:(k + 1) * half].clone() for k in (0, 1)]
    parts = []
    for k, sl_k in enumerate(halves):
        m_k = sl_k[:, lslot]
        parts.append(kernels.mask_pack(m_k))
        check(parts[-1], MS._mask_pack_plain(m_k), f"M6 pack, sp = 2 shard {k}")
    pk_g = torch.cat(parts, dim=1)
    for k, sl_k in enumerate(halves):
        pidx_k = pidx if op != ">" else pidx[:, k * half:(k + 1) * half].contiguous()
        sl_k[:, oslot].fill_(7)
        kernels.filter_struct_shard(op, pk_g, sl_k, rslot, oslot, pidx_k, sh.n_spans, k * half,
                                    packed=True)
        want = F._struct_step_plain(op, MS._mask_unpack_plain(pk_g), sl_k[:, rslot] != 0, pidx_k,
                                    sh.n_spans_t, k * half)
        check(sl_k[:, oslot] != 0, want, f"K1's packed struct pass, sp = 2 shard {k}")
        check(want, sh.slot(oslot)[:, k * half:(k + 1) * half] != 0,
              f"the sp = 2 shard {k}'s `{op}` against run 1's answer")
        if not want.any():
            raise AssertionError(f"the `{op}` node matched nothing on sp = 2 shard {k}; the "
                                 "packed read's check is vacuous")
    m = sh.slot(lslot)
    pk = kernels.mask_pack(m)
    err = check(pk, MS._mask_pack_plain(m), "M6 pack") + check(pk, pk_g, "M6 pack of the halves")
    m6_split = {"mask_pack": functools.partial(kernels.mask_pack, m)}
    ms, pms = cuda_ms(m6_split["mask_pack"]), cuda_ms(lambda: MS._mask_pack_plain(m))
    nrow = m.shape[0] * m.shape[1]
    b = bound(nrow + nrow // 8, nrow)
    row("mask_pack", "meshsearch.cu", "tempo_tpu/parallel/search.py:175-189", err, ms, pms, b)
    work = sh.slots.clone()

    def packed_pass():
        kernels.filter_struct_shard(op, pk, work, rslot, oslot, pidx, sh.n_spans, 0, packed=True)

    def plain_pass():
        return F._struct_step_plain(op, MS._mask_unpack_plain(pk), work[:, rslot] != 0, pidx,
                                    sh.n_spans_t, 0)

    want = plain_pass()
    work[:, oslot].fill_(7)
    packed_pass()
    err = check(work[:, oslot] != 0, want, "K1's struct pass over the packed lhs mask")
    if not want.any():
        raise AssertionError("the `>` node matched nothing; the packed read's check is vacuous")
    ms_s, pms_s = cuda_ms(packed_pass), cuda_ms(plain_pass, reps=3, warm=1)
    # bytes: the packed row, the rhs and output rows, the parent rows
    b_s = bound(nrow // 8 + nrow * 2 + pidx.numel() * 4, nrow)
    row("struct_packed", "filter.cu", "tempo_tpu/parallel/search.py:175-189", err, ms_s, pms_s,
        b_s)
    m6_split["struct_packed"] = packed_pass
    m6_split["struct pass over the byte mask"] = functools.partial(
        kernels.filter_struct_shard, op, m, work, rslot, oslot, pidx, sh.n_spans, 0)
    smi_m6 = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                            capture_output=True, text=True).stdout.strip()
    log(f"[M6] {tuple(m.shape)} (row stride {m.stride(0)}), `{op}` node, {smi_m6}: pack "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.5f} ms (both equal on run 2's two "
        f"sp = 2 shards); the packed struct pass {ms_s:.4f} ms, plain (unpack, then the "
        f"struct step) {pms_s:.4f} ms, bound {b_s[0]:.5f} ms")
    m5_splits[f"M6, phase 15's `{op}` node ({tuple(m.shape)}; {smi_m6})"] = m6_split

    # M7, M8 -- the span query's partial counts, then its trace program;
    # then both in one launch, as a one-rank sp axis runs them
    sh = shards["span"]
    span_off = sh.cols["trace.span_off"]
    n_tr = len(sh.prog.tslots)

    def m7():
        return kernels.search_partial(sh.prog, sh.bufs[0], sh.slots, span_off, None, sh.n_spans_t,
                                      0, sh.nt)

    def m7_plain():
        return MS._search_partial_plain(sh.slots, sh.prog.tslots, span_off, None, sh.n_spans_t, 0,
                                        sh.nt)

    counts = m7()
    err = check(counts, m7_plain(), "M7")
    # the yardstick: torch.segment_reduce (f32: it has no int kernel) of
    # each tracify slot and of their union over the clipped offsets
    masks = [sh.slots[:, s] != 0 for s in sh.prog.tslots]
    union = functools.reduce(torch.logical_or, masks) if masks else \
        torch.arange(sh.sl, device=span_off.device)[None] < sh.n_spans_t[:, None]
    segs = [m.to(torch.float32) for m in masks + [union]]
    clipped = torch.clamp(span_off.long(), 0, sh.sl)

    def m7_lib():
        return [torch.segment_reduce(x, "sum", offsets=clipped, axis=1) for x in segs]

    if not all(torch.equal(y.to(torch.int32), counts[:, j]) for j, y in enumerate(m7_lib())):
        raise AssertionError("M7 differs from torch.segment_reduce")
    ms, pms, lms = cuda_ms(m7), cuda_ms(m7_plain, reps=3, warm=1), cuda_ms(m7_lib)
    spans = int(sh.n_spans_t.sum().item())
    b = bound(spans * max(n_tr, 1) + span_off.numel() * 4 + counts.numel() * 4,
              spans * max(n_tr, 1))
    log(f"[M7] {bl} blocks, {spans} spans, {n_tr} tracify slots: {ms:.4f} ms, plain {pms:.4f} ms, "
        f"segment_reduce x {len(segs)} {lms:.4f} ms, bound {b[0]:.5f} ms")
    row("search_partial", "meshsearch.cu", "tempo_tpu/parallel/search.py:272-290", err, ms, pms, b,
        lms)
    code = sh.prog.code(sh.prog.trace_off)

    def m8():
        return kernels.search_finish(sh.prog, sh.bufs[0], sh.descs, counts)

    def m8_plain():
        return MS._search_finish_plain(code, sh.conds, sh.cols, sh.ops_i, sh.ops_f, sh.tables,
                                       counts)

    got, want = m8(), m8_plain()
    err = check(got[0], want[0], "M8's trace mask") + check(got[1], want[1], "M8's counts")
    if not got[0].any():
        raise AssertionError("M8: the span query matched nothing; the check is vacuous")
    ms, pms = cuda_ms(m8), cuda_ms(m8_plain)
    b = bound(counts.numel() * 4 + got[0].numel() * 5, counts.numel())
    log(f"[M8] {bl} x {sh.nt} traces: {ms:.4f} ms, plain {pms:.4f} ms, bound {b[0]:.5f} ms")
    row("search_finish", "meshsearch.cu", "tempo_tpu/parallel/search.py:292-322", err, ms, pms, b)

    def fused():
        return kernels.search_fused(sh.prog, sh.bufs[0], sh.descs, sh.slots, span_off,
                                    sh.n_spans_t, 0, sh.nt)

    def fused_plain():
        return MS._search_finish_plain(code, sh.conds, sh.cols, sh.ops_i, sh.ops_f, sh.tables,
                                       m7_plain())

    got = fused()
    err = check(got[0], want[0], "the fused route's trace mask") + \
        check(got[1], want[1], "the fused route's counts")
    ms, pms = cuda_ms(fused), cuda_ms(fused_plain, reps=3, warm=1)
    b = bound(spans * max(n_tr, 1) + span_off.numel() * 4 + got[0].numel() * 5,
              spans * max(n_tr, 1))
    log(f"[M7+M8 fused] {bl} blocks, {spans} spans into {bl} x {sh.nt} traces: {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b[0]:.5f} ms")
    row("search_fused", "meshsearch.cu", "tempo_tpu/parallel/search.py:272-322", err, ms, pms, b)
    # each call holds sh: descs are the addresses of its descriptor tables
    m5_splits[f"M7, M8 and the fused route, phase 15's shard ({bl} x {sh.nt} traces, {spans} "
              f"spans)"] = {"search_partial": m7, "search_finish": m8, "search_fused": fused}
    return m5_splits


APP_HIGH_LIMIT = 1 << 16  # above the match count of phase 16's two high-limit searches
FACADE_LIMIT = 1 << 19  # above every query's match count: the corpus holds 327,680 traces


def _http(base: str, path: str, body: bytes | None = None, ctype: str = "application/json"):
    """(status, body, headers) of one request to the App, as tenant `smoke`."""
    import urllib.error
    import urllib.request

    headers = {"X-Scope-OrgID": TENANT}
    if body is not None:
        headers["Content-Type"] = ctype
    req = urllib.request.Request(base + path, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _held_by_facade(want: dict, q: str, got: list, limit: int) -> None:
    """Phase 16's rule for a search answered at `limit` through the
    frontend (its jobs merge in completion order, each capped at the
    limit): it holds min(limit, matches) traces, each one that the
    facade's search at a limit above the match count (`want`: trace id
    -> its wire fields) returns, with equal fields."""
    if len(got) != min(limit, len(want)):
        raise AssertionError(f"app search {q}: {len(got)} traces, {len(want)} matches")
    for t in got:
        if want.get(t["traceID"]) != t:
            raise AssertionError(f"app search {q}: trace {t['traceID']} {t} is not the "
                                 f"facade's {want.get(t['traceID'])}")


def phase_16(store, dev, present, absent, seq_found, metrics_want, lo_s, hi_s, smi) -> dict:
    """The read plane and the single binary: an App (target all,
    multitenancy on) on the card over a hard-linked copy of the corpus
    as phases 5-10 saw it, served over HTTP on 127.0.0.1, driven as
    tenant `smoke`: phase 5's finds, the 10 searches (held against the
    facade by _held_by_facade), two of them at APP_HIGH_LIMIT against
    the facade's whole answer, a repeat served by the result cache, a
    stream, tag discovery, a count query against phase 10's answer, the
    10 searches again through a second, dispatcher-only Frontend that
    one thread drains over the wire job plane (poll_job ->
    worker.execute_job -> complete_job), then 16 OTLP JSON pushes found
    live, searched, flushed and found in the backend. Counts from 0
    just before; returns the wrapper calls, each step's wall and the
    failed jobs."""
    import socket

    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.db import SearchRequest
    from tempo_tpu_torch.db import metrics_exec as ME
    from tempo_tpu_torch.services.app import App, AppConfig
    from tempo_tpu_torch.services.frontend import Frontend
    from tempo_tpu_torch.services.ingester import IngesterConfig
    from tempo_tpu_torch.services.worker import execute_job
    from tempo_tpu_torch.util.testdata import make_traces
    from tempo_tpu_torch.wire import otlp_json

    walls: dict = {}

    def step(name: str, t0: float) -> None:
        walls[name] = time.perf_counter() - t0
        log(f"[app] {name}: {walls[name]:.2f} s ({smi})")

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    kernels.reset_counts()
    t_phase = t0 = time.perf_counter()
    app = App(AppConfig(target="all", multitenancy=True, storage_path=store, http_port=port,
                        compaction_cycle_s=9999, device=str(dev), instance_id="smoke-app",
                        ingester=IngesterConfig(max_trace_idle_s=0.0, max_block_age_s=0.0,
                                                flush_check_period_s=9999)))
    fe2 = None
    try:
        app.start()
        app.serve_http(background=True)
        base = f"http://127.0.0.1:{port}"
        if _http(base, "/ready")[0] != 200 or len(app.db.metas(TENANT)) != N_BLOCKS:
            raise AssertionError(f"app not ready over {len(app.db.metas(TENANT))} blocks")
        step("start", t0)

        # ---- finds: phase 5's ids
        t0 = time.perf_counter()
        for tid in present:
            st, body, _ = _http(base, f"/api/traces/{tid.hex()}")
            if st != 200 or canon_trace(otlp_json.loads(body)) != canon_trace(seq_found[tid]):
                raise AssertionError(f"app find {tid.hex()}: {st}, not phase 5's trace")
        for tid in absent:
            st, _, _ = _http(base, f"/api/traces/{tid.hex()}")
            if st != 404:
                raise AssertionError(f"app find {tid.hex()} (absent): {st}")
        step(f"{len(present)} + {len(absent)} finds", t0)

        # ---- the 10 searches at limit 20, held against the facade
        t0 = time.perf_counter()
        app_answers, heads = [], []
        for q in SEARCH_QUERIES:
            st, body, h = _http(base, f"/api/search?q={urllib.parse.quote(q)}&limit=20")
            if st != 200:
                raise AssertionError(f"app search {q}: {st} {body[:200]}")
            app_answers.append(json.loads(body))
            heads.append(h["X-Tempo-Cache"])
        step("10 searches (first touch)", t0)
        t0 = time.perf_counter()
        facade = {}
        for q, a in zip(SEARCH_QUERIES, app_answers):
            want = app.db.search(TENANT, SearchRequest(query=q, limit=FACADE_LIMIT))
            if len(want.traces) >= FACADE_LIMIT:
                raise AssertionError(f"facade {q}: {len(want.traces)} traces at {FACADE_LIMIT}")
            facade[q] = {t.trace_id: t.to_dict() for t in want.traces}
            _held_by_facade(facade[q], q, a["traces"], 20)
        log("[app] matches a query (the facade at limit " + str(FACADE_LIMIT) + "): "
            + ", ".join(str(len(facade[q])) for q in SEARCH_QUERIES))
        step("facade check of the 10 answers", t0)
        t0 = time.perf_counter()
        high = {}
        for qi in (1, 2):  # svc-007 and the sattr form: their matches fit APP_HIGH_LIMIT
            q = SEARCH_QUERIES[qi]
            st, body, _ = _http(base, f"/api/search?q={urllib.parse.quote(q)}"
                                      f"&limit={APP_HIGH_LIMIT}")
            got = json.loads(body)
            if st != 200 or not 0 < len(facade[q]) < APP_HIGH_LIMIT or \
                    {t["traceID"]: t for t in got["traces"]} != facade[q]:
                raise AssertionError(f"app search {q} at {APP_HIGH_LIMIT}: {len(got['traces'])} "
                                     f"traces, the facade {len(facade[q])}")
            high[qi] = got
            log(f"[app] {q} at limit {APP_HIGH_LIMIT}: {len(facade[q])} traces, equal sets")
        step("2 searches at the high limit", t0)

        # ---- a repeat (the result cache) and a stream
        t0 = time.perf_counter()
        st, body, h = _http(base, f"/api/search?q={urllib.parse.quote(SEARCH_QUERIES[0])}"
                                  "&limit=20")
        if st != 200 or h["X-Tempo-Cache"] != "hit" or json.loads(body) != app_answers[0]:
            raise AssertionError(f"app repeat: {st} {h['X-Tempo-Cache']}, heads {heads}")
        app.frontend.result_cache.clear()
        st, body, h = _http(base, f"/api/search?q={urllib.parse.quote(SEARCH_QUERIES[2])}"
                                  f"&limit={APP_HIGH_LIMIT}&stream=true")
        events = [json.loads(ln) for ln in body.decode().splitlines() if ln]
        final = events[-1] if events else {}
        if st != 200 or not final.get("done") or final["traces"] != high[2]["traces"] or \
                final["metrics"]["inspectedSpans"] != high[2]["metrics"]["inspectedSpans"]:
            raise AssertionError(f"app stream: {st}, {len(events)} events, final differs from "
                                 "the blocking body")
        log(f"[app] repeat: X-Tempo-Cache hit, equal body (first pass: {heads}); stream: "
            f"{len(events)} events, {final['jobsCompleted']}/{final['jobsTotal']} jobs, final "
            "event equal to the blocking body")
        step("repeat and stream", t0)

        # ---- tags
        t0 = time.perf_counter()
        st1, b1, _ = _http(base, "/api/search/tags")
        st2, b2, _ = _http(base, "/api/search/tag/service.name/values")
        if (st1, st2) != (200, 200) or \
                json.loads(b1)["tagNames"] != app.db.search_tags(TENANT) or \
                json.loads(b2)["tagValues"] != app.db.search_tag_values(TENANT, "service.name"):
            raise AssertionError("app tags differ from the facade's")
        step("tags", t0)

        # ---- metrics: the count query, against phase 10's answer
        t0 = time.perf_counter()
        mq = METRICS_QUERIES[1]
        st, body, _ = _http(base, f"/api/metrics/query_range?q={urllib.parse.quote(mq)}"
                                  f"&start={lo_s}&end={hi_s}&step={METRICS_STEP_S}")
        if st != 200 or json.loads(body) != json.loads(json.dumps(ME.to_prometheus(metrics_want))):
            raise AssertionError(f"app metrics {mq}: {st}, series differ from phase 10")
        step(f"metrics {mq} ({len(metrics_want.series)} series)", t0)

        # ---- the wire job plane: a second, dispatcher-only frontend
        t0 = time.perf_counter()
        fe2 = Frontend(app.querier, n_workers=0, hedge_after_s=0.0)
        for w in ("smoke-w1", "smoke-w2"):  # two cache domains: the affinity scan merges
            fe2.poll_job(wait_s=0.01, worker_id=w)
        outs: list = [None] * len(SEARCH_QUERIES)

        def run(i, q):
            outs[i] = fe2.search(TENANT, SearchRequest(query=q, limit=20))

        threads = [threading.Thread(target=run, args=(i, q), daemon=True)
                   for i, q in enumerate(SEARCH_QUERIES)]
        for t in threads:
            t.start()
        n_jobs = len(SEARCH_QUERIES) * len(fe2._build_search_jobs(
            TENANT, SearchRequest(), {}, app.db.metas(TENANT)))
        deadline = time.monotonic() + 60
        while sum(fe2.queue.depths().values()) < n_jobs and time.monotonic() < deadline:
            time.sleep(0.01)
        kinds: dict = {}
        while any(t.is_alive() for t in threads):
            job = fe2.poll_job(wait_s=0.2, worker_id="smoke-w1")
            if job is None:
                continue
            kinds[job["kind"]] = kinds.get(job["kind"], 0) + 1
            out = execute_job(app.querier, job["tenant"], job["kind"], job["payload"])
            fe2.complete_job(job["id"], True, result=out)
        for t in threads:
            t.join(timeout=5)
        if "multi" not in kinds:
            raise AssertionError(f"job plane: no multi job among {kinds}")
        for q, o, a in zip(SEARCH_QUERIES, outs, app_answers):
            if o is None or [t.to_dict() for t in o.traces] != a["traces"]:
                raise AssertionError(f"job plane search {q} differs from the app's answer")
        log(f"[app] job plane: {n_jobs} jobs of 10 searches, wire jobs by kind {kinds}, "
            f"remote results {fe2.stats_jobs_remote}, placements {fe2.stats['placements']}")
        step("job plane (10 searches)", t0)

        # ---- live data: pushed, found live, searched, flushed, found again
        t0 = time.perf_counter()
        live = make_traces(16, seed=16, n_spans=8)
        for _, tr in live:
            st, body, _ = _http(base, "/v1/traces", otlp_json.dumps(tr).encode())
            if st != 200:
                raise AssertionError(f"push: {st} {body[:200]}")
        for tid, tr in live:
            st, body, _ = _http(base, f"/api/traces/{tid.hex()}")
            if st != 200 or canon_trace(otlp_json.loads(body)) != canon_trace(tr):
                raise AssertionError(f"live find {tid.hex()}: {st}")
        lq = urllib.parse.quote('{ resource.k8s.cluster.name = "prod" }')
        st, body, _ = _http(base, f"/api/search?q={lq}&limit=100")
        if st != 200 or sorted(t["traceID"] for t in json.loads(body)["traces"]) != \
                sorted(t.hex() for t, _ in live):
            raise AssertionError(f"live search: {st}")
        if _http(base, "/flush", b"")[0] != 204:
            raise AssertionError("flush refused")
        for tid, tr in live:
            st, body, _ = _http(base, f"/api/traces/{tid.hex()}")
            if st != 200 or canon_trace(otlp_json.loads(body)) != canon_trace(tr):
                raise AssertionError(f"find {tid.hex()} after the flush: {st}")
        if len(app.db.metas(TENANT)) != N_BLOCKS + 1:
            raise AssertionError(f"flush: {len(app.db.metas(TENANT))} blocks")
        step("16 pushes, live finds and search, flush, backend finds", t0)
        counts = dict(kernels.LAUNCHES)
        failed = {"app": dict(app.frontend.stats["jobs_failed"]),
                  "job plane": dict(fe2.stats["jobs_failed"])}
    finally:
        if fe2 is not None:
            fe2.stop()
        app.stop()
    walls["phase"] = time.perf_counter() - t_phase
    log(f"[app] frontend stats {app.frontend.stats}; cache {app.frontend.result_cache.stats()}")
    log(f"[app] wrapper calls {nonzero(counts)}")
    missing = [k for k in ("filter", "select", "find", "timeseries", "live_filter")
               if counts[k] <= 0]
    if missing or any(failed.values()):
        raise AssertionError(f"phase 16: kernels not launched {missing}, failed jobs {failed}")
    return {"counts": counts, "walls": walls}


def b6_sweep(prog, buf, staged, ns: int, n_b: int, t0: int, step: int, splits: dict) -> None:
    """B6 over block 0's spans (`{ true }`, 61 buckets of the rate query's
    axis) at counts-only and value grids of 3,904, 31,232 and 200,019
    cells (64, 512 and 3,279 groups; random gid and values made on the
    card), by timeseries_plan's route and every other route the grid fits
    (timeseries_route), each against the plain version: the sweep behind
    timeseries_plan's rules. Each point's routes join `splits` for their
    device time."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import timeseries as TS

    dev = staged.cols["span.start_ms"].device
    nsb, nrb, ntb = staged.n_spans_b, staged.n_res_b, staged.n_traces_b
    gen = torch.Generator(device=dev).manual_seed(61)
    for n_g in (64, 512, 3279):
        cells = n_g * n_b
        gid = torch.randint(-1, n_g, (nsb,), device=dev, generator=gen, dtype=torch.int32)
        val = torch.empty(nsb, device=dev).exponential_(0.02, generator=gen)
        pres = torch.rand(nsb, device=dev, generator=gen) < 0.9
        for has_val in (False, True):
            v, pr = (val, pres) if has_val else (None, None)
            want = TS._timeseries_plain(None, (), staged.cols, None, None, {}, gid, v, pr, t0, step,
                                        ns, n_b, n_g, nsb, nrb, ntb)
            plans = []
            for route in kernels.TS_ROUTES:
                try:
                    plans.append(kernels.timeseries_route(route, cells, has_val))
                except kernels.KernelError:
                    pass  # the grid does not fit that route's shared memory
            times, fns = {}, {}
            for p in plans:
                fn = functools.partial(kernels.timeseries, prog, buf, staged.cols,
                                       staged.cols["span.start_ms"], gid, v, pr, t0, step, ns,
                                       nrb, ntb, n_b, n_g, p)
                for i, (g, w) in enumerate(zip(fn(), want)):
                    if not torch.allclose(g, w, rtol=1e-5 if i == 2 else 0, atol=0,
                                          equal_nan=True):
                        raise AssertionError(f"B6 sweep {cells} cells {p}: output {i} differs")
                fns[p.route] = fn
                times[p.route] = cuda_ms(fn)
            splits[f"B6 sweep, {cells} cells {'with values' if has_val else 'counts only'}"] = fns
            log(f"[B6 sweep] {cells} cells {'with values' if has_val else 'counts only'}: "
                + ", ".join(f"{k} {t:.4f} ms" for k, t in times.items())
                + f"; timeseries_plan takes {kernels.timeseries_plan(cells, has_val).route}")


def device_ms(fn, reps: int = 20) -> float:
    """The card's time a call: the calls wait behind a sleep kernel long
    enough for the host to queue them all (checked, and the sleep
    doubled until it is), so the card runs them back to back whatever
    the host's pace; CUDA events around them."""
    fn()
    torch.cuda.synchronize()
    cycles = 4_000_000
    while True:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.record()
        torch.cuda.synchronize()
        if s.elapsed_time(a) > 1.2 * host_ms:
            return a.elapsed_time(b) / reps
        cycles *= 2


def device_split(what: str, fns: dict) -> None:
    """Device time a call of each route (device_ms, 20 calls each): fns
    maps a route's name to a call. Run after every other timing."""
    log(f"[split] {what}: device µs a call (queued) "
        + ", ".join(f"{route} {device_ms(fn) * 1e3:.2f}" for route, fn in fns.items()))


def k2_split(mask, key, counts, k_search: int) -> None:
    """K2's two passes' device time apart (the profiler, 20 calls each),
    at the search shape and a live search's 16,384 rows, k = k_search
    and K_SMALL. Run after every other timing: a CUDA-event time taken
    just after the profiler reads high."""
    from torch.profiler import ProfilerActivity, profile

    from tempo_tpu_torch import kernels

    for n, k in ((mask.shape[0], k_search), (mask.shape[0], kernels.K_SMALL), (16384, k_search),
                 (16384, kernels.K_SMALL)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                kernels.select_topk(mask[:n], key[:n], counts[:n], k)
            torch.cuda.synchronize()
        split = {e.key.split("(")[0]: e.self_device_time_total / e.count
                 for e in prof.key_averages() if e.key.startswith("select_")}
        log(f"[K2 split] N={n} k={k}: device µs a call (profiler) "
            + (", ".join(f"{name} {us:.2f}" for name, us in sorted(split.items()))
               or "not measured"))


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 2
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.block import open_block
    from tempo_tpu_torch.block import schema as S
    from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
    from tempo_tpu_torch.db import batchexec as BX
    from tempo_tpu_torch.db import metrics_exec as ME
    from tempo_tpu_torch.db import search as SM
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import find as FD
    from tempo_tpu_torch.ops import multiquery as MQ
    from tempo_tpu_torch.ops import select as SE
    from tempo_tpu_torch.ops import stage as ST
    from tempo_tpu_torch.ops import timeseries as TS
    from tempo_tpu_torch.ops.device import PAD_I32, bucket, pad_rows
    from tempo_tpu_torch.traceql.plan import plan_metrics_filter, plan_search_request
    from tempo_tpu_torch.util.synth import synth_block

    # ---- 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    # ---- 2. build
    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] nvcc {len(kernels.SOURCES)} sources in {time.perf_counter() - t0:.1f} s")

    tmp = tempfile.mkdtemp(prefix="tempo-smoke-")
    try:
        # ---- 3. corpus
        t0 = time.perf_counter()
        rng = np.random.default_rng(7)
        backend = LocalBackend(os.path.join(tmp, "store"))
        ids_per = []
        for _ in range(N_BLOCKS):
            _, ids = synth_block(backend, TENANT, rng, N_TRACES, SPANS_PER, codec=CODEC)
            ids_per.append(ids)
        db = TempoDB(TempoDBConfig(), backend=backend)
        db.poll_now()
        metas = db.metas(TENANT)
        assert len(metas) == N_BLOCKS and db.device.type == "cuda", (len(metas), db.device)
        total = sum(m.total_spans for m in metas)
        assert total == N_BLOCKS * N_TRACES * SPANS_PER
        log(f"[corpus] {N_BLOCKS} blocks, {total} spans, codec {CODEC}, "
            f"{sum(m.size_bytes for m in metas) / 1e6:.1f} MB in {time.perf_counter() - t0:.1f} s")

        # ---- 4. kernels vs plain on block 0 (fresh readers, uncached staging)
        dev = db.device
        blk0 = open_block(backend, TENANT, metas[0].block_id)
        plans = [(label, q, plan_search_request(blk0.dictionary, {}, query=q))
                 for label, q in K1_QUERIES + list(zip(("range", "or"), SEARCH_QUERIES[8:]))]
        needed = sorted({n for _, _, p in plans for n in F.required_columns(p.conds)}
                        | {n for _, _, p in plans for n in p.extra_cols} | {"trace@gkey_s"})
        staged = ST.stage_block(blk0, needed, cache=False, device=dev)
        cols = staged.cols
        ns, nt, nsb, nrb, ntb = (staged.n_spans, staged.n_traces, staged.n_spans_b,
                                 staged.n_res_b, staged.n_traces_b)
        attr_rows = {"sattr": int(cols["sattr.off"][-1].item()),
                     "rattr": int(cols["rattr.off"][-1].item())}
        table = []
        # the same columns with siblings: a random tree per trace, with
        # orphans (the over-match rule of `~`), through staged_from_numpy
        sib_np = {k: v.cpu().numpy() for k, v in cols.items()}
        sib_np["span.parent_idx"] = random_tree_parents(cols, ns, np.random.default_rng(13))
        sib_staged = ST.staged_from_numpy(sib_np, ns, nt, staged.n_res, dev)
        sib_cols = sib_staged.cols

        def k1_prog(p, cols):
            ops = F.Operands.build(p.rows, p.tables or None)
            tables = {i: pad_rows(np.asarray(t, np.uint8), bucket(max(1, len(t))), 0)
                      for i, t in (p.tables or {}).items()}
            tree = F.normalize_tree(p.tree, p.conds) if p.tree is not None else None
            prog = F._program(tree, tuple(p.conds))
            ops_i = torch.from_numpy(ops.ints).to(dev)
            ops_f = torch.from_numpy(ops.floats).to(dev)
            ttab = {i: torch.from_numpy(t).to(dev) for i, t in tables.items()}
            return prog, prog.buffer(cols, ops, tables), (tree, p.conds, cols, ops_i, ops_f, ttab)

        def k1_routes(label, p, st, span_out, timed):
            """K1 on staged block st by the route its plan picks and by the
            multi-launch route, forced through the plan argument, each
            equal to the plain version; the plan, each route's outputs,
            __global__ launches and (timed) CUDA-event ms."""
            cols, tiles = st.cols, st.tiles
            sh = (st.n_spans, st.n_traces, st.n_spans_b, st.n_res_b, st.n_traces_b)
            prog, buf, pa = k1_prog(p, cols)
            want = F._run_plain(*pa, *sh, span_out)
            fplan = kernels.filter_plan(prog, tiles, span_out)
            out = {}
            if timed:
                splits[f"K1 {label}"] = {
                    route: (lambda rp=rp: kernels.filter_run(prog, buf, cols, *sh, span_out, tiles,
                                                             rp))
                    for route, rp in (("trace tiles", fplan), ("multi-launch", kernels.MULTI_LAUNCH))}
            for route, rp in (("tiles", fplan), ("multi", kernels.MULTI_LAUNCH)):
                if route == "tiles" and not fplan.tiled:
                    continue
                kernels.reset_counts()
                got = kernels.filter_run(prog, buf, cols, *sh, span_out, tiles, rp)
                grids = kernels.grid_launches()["filter"]
                got = got if span_out else got[1:]
                if max_abs_err(got, want) or not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"K1 {label} ({route}, span_out={span_out}) differs from "
                                         f"its plain version")
                ms = (cuda_ms(lambda: kernels.filter_run(prog, buf, cols, *sh, span_out, tiles, rp))
                      if timed else None)
                out[route] = (got, grids, ms)
            if fplan.tiled and out["tiles"][1] != 1 + bool(prog.rconds) + fplan.flag_pass:
                raise AssertionError(f"K1 {label}: {out['tiles'][1]} __global__ launches on the "
                                     f"trace tiles")
            return prog, fplan, want, out, pa

        splits = {}  # device-time splits, taken after every other timing
        # K1 -- per form, span_out=False as on the search path, by both
        # routes: the trace tiles block 0's staging gives (the sibling form
        # on the forest: orphans in every tile, so a flag pass first), and
        # the multi-launch kernels; the table row sums the eight
        # K1_QUERIES forms on the route the plan takes
        k1 = {"ms": 0.0, "plain_ms": 0.0, "nbytes": 0, "ops": 0}
        for label, q, p in plans:
            assert not p.prune, q
            st = sib_staged if label == "sibling" else staged
            prog, fplan, want, out, pa = k1_routes(label, p, st, False, True)
            if not fplan.tiled:
                raise AssertionError(f"K1 {label}: the plan did not take the trace tiles")
            got, grids, ms = out["tiles"]
            matched = int(got[0].sum().item())
            if matched == 0:
                raise AssertionError(f"K1 {label}: {q} matched no trace; the check is vacuous")
            pms = cuda_ms(lambda: F._run_plain(*pa, ns, nt, nsb, nrb, ntb, False), reps=5, warm=1)
            # bytes the program must move: each column it reads, real rows
            # once, plus its outputs
            read = {"trace.span_off": (nt + 1) * 4}
            for i in prog.span_conds | prog.trace_conds:
                c = p.conds[i]
                if c.target in ("sattr", "rattr"):
                    n = attr_rows[c.target]
                    names = [f"{c.target}.key_id", f"{c.target}.vtype"]
                    if c.col != "any":
                        names.append(f"{c.target}.{F._ATTR_VALUE_COL[c.col]}")
                    read.update({x: n * 4 for x in names})
                    own = ns if c.target == "sattr" else staged.n_res
                    read[f"{c.target}.off"] = (own + 1) * 4
                    if c.target == "rattr":
                        read["span.res_idx"] = ns * 4
                else:
                    name = f"span@{c.col}" if c.target == "res" else c.col
                    read[name] = (nt if c.target == "trace" else ns) * 4
            if prog.struct_steps:
                read["span.parent_idx"] = ns * 4
            nbytes = sum(read.values()) + ntb * 5
            b_ms, _ = bound(nbytes, ns * max(1, len(p.conds)))
            _, mgrids, mms = out["multi"]
            log(f"[K1 {label:10s}] {q}: {matched} traces; trace tiles {ms:.4f} ms ({grids} "
                f"__global__{', a flag pass' if fplan.flag_pass else ''}), multi-launch "
                f"{mms:.4f} ms ({mgrids} __global__), plain {pms:.4f} ms, bound {b_ms:.4f} ms, "
                f"{len(prog.steps)} span/struct steps, {st.tiles.bounds.shape[0] - 1} tiles of "
                f"{st.tiles.tile} spans")
            if label in dict(K1_QUERIES):
                k1["ms"] += ms
                k1["plain_ms"] += pms
                k1["nbytes"] += nbytes
                k1["ops"] += ns * max(1, len(p.conds))

        # K1 with span_out=True, once (the span-mask epilogue), both routes
        _, _, want, _, _ = k1_routes("span, span_out", plans[0][2], staged, True, False)
        if not int(want[0].sum().item()):
            raise AssertionError("K1 span_out=True matched nothing")

        # K1 where the tiles end, on block 0's columns: a trace of 9,600
        # spans (its traces 0-299 merged, a chain 9,600 deep: the tile
        # grows to 16,384 and `>>` takes 14 passes), one of 19,200 (past
        # FILTER_TILE_MAX: the multi-launch route), then group-range
        # staging (span_base 65,536: parents stay block-global, so struct
        # forms take the multi-launch route); both routes against the
        # plain version wherever the plan allows each
        off0 = sib_np["trace.span_off"].astype(np.int64)
        for n_merge, want_tiled in ((300, True), (600, False)):
            long_np = {k: v.copy() for k, v in sib_np.items()}
            lo_end = int(off0[n_merge])
            long_np["trace.span_off"][1:n_merge] = lo_end
            long_np["span.trace_sid"][:lo_end] = 0
            long_np["span.parent_idx"][:lo_end] = np.arange(-1, lo_end - 1)
            lst = ST.staged_from_numpy(long_np, ns, nt, staged.n_res, dev)
            for label, q, p in plans:
                if label not in ("span", "descendant", "sibling"):
                    continue
                _, fplan, _, out, _ = k1_routes(label, p, lst, False, False)
                if fplan.tiled != want_tiled:
                    raise AssertionError(f"K1 {label}, a {lo_end}-span trace: tiled "
                                         f"{fplan.tiled}")
                log(f"[K1 long trace] {lo_end} spans, {label}: route "
                    f"{'trace tiles' if fplan.tiled else 'multi-launch'} (tile {lst.tiles.tile}, "
                    f"{fplan.n_passes} `>>` passes), __global__ {({r: o[1] for r, o in out.items()})}, "
                    f"both equal to the plain version")
            del long_np, lst
        del sib_np
        gst = ST.stage_block(blk0, needed, groups=[1, 2], cache=False, device=dev)
        if gst.span_base == 0 or gst.tiles.parents_local:
            raise AssertionError(f"group-range staging: span_base {gst.span_base}, parents local "
                                 f"{gst.tiles.parents_local}")
        routes = {}
        for label, q, p in plans:
            _, fplan, _, out, _ = k1_routes(label, p, gst, False, False)
            routes[label] = ("tiles" if fplan.tiled else "multi", {r: o[1] for r, o in out.items()})
            if fplan.tiled == bool(p.has_struct):
                raise AssertionError(f"K1 {label} on group-range staging: tiled {fplan.tiled}")
        log(f"[K1 group range] groups 1-2 ({gst.n_spans} spans from row {gst.span_base}): each "
            f"form equal to the plain version by its routes: {routes}")
        del gst
        k1_bound = bound(k1["nbytes"], k1["ops"])
        table.append({"name": "filter", "route": "cuda", "source": "tempo_tpu_torch/csrc/filter.cu",
                      "replaces": "tempo_tpu/ops/filter.py:286", "launches": 0,
                      "max_abs_err": 0, "ms": k1["ms"], "plain_ms": k1["plain_ms"],
                      "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "library_ms": None})

        # K2 -- block 0 at k=32 and k=N, then the search path's shape:
        # ten blocks' trace vectors concatenated, k=64
        cols = staged.cols
        prog, buf, _ = k1_prog(plans[0][2], cols)
        tm, counts = kernels.filter_run(prog, buf, cols, ns, nt, nsb, nrb, ntb, False,
                                        staged.tiles)[1:]
        key = cols["trace@gkey_s"]
        for k in (32, ntb):
            got = kernels.select_topk(tm, key, counts, k)
            if max_abs_err(got, SE._select_plain(tm, key, counts, k)):
                raise AssertionError(f"K2 differs from its plain version at k={k}")
        mask10, key10, cnt10 = torch.cat([tm] * N_BLOCKS), torch.cat([key] * N_BLOCKS), \
            torch.cat([counts] * N_BLOCKS)
        n10, k10 = mask10.shape[0], SE.k_bucket(40)
        if not kernels.select_plan(n10, k10).tiled:
            raise AssertionError(f"K2 at the search shape N={n10} k={k10}: not the two-pass route")
        kernels.reset_counts()
        got = kernels.select_topk(mask10, key10, cnt10, k10)
        grids = kernels.grid_launches()["select"]
        err = max_abs_err(got, SE._select_plain(mask10, key10, cnt10, k10))
        if err or grids != 2:
            raise AssertionError(f"K2 at the search shape: max_abs_err {err}, {grids} __global__ "
                                 f"launches (2 expected)")
        comp = (torch.where(mask10, key10, int(PAD_I32)).to(torch.int64) * (1 << 32)
                + ((1 << 32) - 1 - torch.arange(n10, device=dev)))
        # the yardsticks order the same composites: a full stable sort, and
        # torch.topk (distinct composites, so its order is the same)
        if not torch.equal(torch.topk(comp, k10).indices.to(torch.int32), got[:k10]):
            raise AssertionError("K2 differs from torch.topk at the search shape")
        ms = cuda_ms(lambda: kernels.select_topk(mask10, key10, cnt10, k10))
        pms = cuda_ms(lambda: SE._select_plain(mask10, key10, cnt10, k10))
        sort_ms = cuda_ms(lambda: torch.sort(comp, descending=True, stable=True))
        topk_ms = cuda_ms(lambda: torch.topk(comp, k10))
        lms = min(sort_ms, topk_ms)
        # the bytes the function needs: the mask, the key of each masked
        # row (counted on the card), counts at the k winners, the output
        hits10 = int(mask10.sum().item())
        b_ms, b_by = bound(n10 + 4 * hits10 + 4 * k10 + (3 * k10 + 1) * 4, n10)
        log(f"[K2] N={n10} k={k10}: {ms:.4f} ms ({grids} __global__ launches), plain {pms:.4f} ms, "
            f"torch.sort {sort_ms:.4f} ms, torch.topk {topk_ms:.4f} ms, bound {b_ms:.6f} ms "
            f"({hits10} masked rows)")
        # both routes on the search path's sizes (a live search's 16,384
        # rows, a block's 32,768, ten blocks), each held against the plain
        # version: the sweep that sets K_SMALL, and the first k past it
        for n_s in (16384, ntb, n10):
            m, ky, c = mask10[:n_s], key10[:n_s], cnt10[:n_s]
            for k in sorted({64, 256, 1024, 2048, 4096, kernels.K_SMALL + 1}):
                want = SE._select_plain(m, ky, c, k)
                times = []
                for plan in (kernels._tiled_plan(n_s, k), kernels._sort_plan(n_s, k)):
                    if max_abs_err(kernels._select_run(m, ky, c, k, plan), want):
                        raise AssertionError(f"K2 differs from its plain version at N={n_s} "
                                             f"k={k}, tiled={plan.tiled}")
                    times.append(cuda_ms(lambda: kernels._select_run(m, ky, c, k, plan)))
                t = kernels._tiled_plan(n_s, k)
                log(f"[K2 sweep] N={n_s} k={k}: two-pass {times[0]:.4f} ms (tile {t.tile}, "
                    f"{t.tiles * t.k_pad} candidates), full sort {times[1]:.4f} ms, torch.topk "
                    f"{cuda_ms(lambda: torch.topk(comp[:n_s], k)):.4f} ms; select_plan takes the "
                    f"{'two-pass' if kernels.select_plan(n_s, k).tiled else 'full sort'} "
                    f"(K_SMALL {kernels.K_SMALL})")
        # the tile size against the one-CTA merge at the search shape
        for k in (1024, 2048):
            kp, sizes = 1 << (k - 1).bit_length(), []
            for tile in (4096, 8192, 16384):
                tiles = -(-n10 // tile)
                plan = kernels.SelectPlan(True, kp, tile, tiles, kernels.SELECT_BUF, 0,
                                          tiles * kp + (tiles + 1) // 2)
                if tile >= 2 * kp:
                    t_ms = cuda_ms(lambda: kernels._select_run(mask10, key10, cnt10, k, plan))
                    sizes.append(f"tile {tile} ({tiles * kp} candidates) {t_ms:.4f} ms")
            log(f"[K2 tiles] N={n10} k={k}: " + ", ".join(sizes))
        table.append({"name": "select", "route": "cuda", "source": "tempo_tpu_torch/csrc/select.cu",
                      "replaces": "tempo_tpu/ops/select.py:84", "launches": 0, "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lms})

        # K3 -- every block's index against 48 present + 16 absent ids,
        # on the stack and on the blocks' own indexes; the row times the
        # wrapper the find path calls at phase 5's shape (one block's
        # cached index, one id, kernels.find_blocks), and the log line
        # adds the path's call and the stacked form at phase 4's shape
        # (one block, the queries padded to their bucket: 1,024 rows, the
        # row's shape before the find path stopped stacking)
        blks = [open_block(backend, TENANT, m.block_id) for m in metas]
        qrng = np.random.default_rng(11)
        present = [ids_per[b][i].tobytes() for b, i in zip(qrng.integers(0, N_BLOCKS, 48),
                                                           qrng.integers(0, N_TRACES, 48))]
        known = {bytes(r) for ids in ids_per for r in ids}
        absent = []
        while len(absent) < 16:
            t = qrng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            if t not in known:
                absent.append(t)
        qcodes = np.asarray([S.trace_id_to_codes(t) for t in present + absent], np.int32)
        T = bucket(N_TRACES)
        steps = T.bit_length()
        ids = torch.from_numpy(np.stack([pad_rows(b.trace_index["trace.id_codes"], T, 2**31 - 1)
                                         for b in blks]).astype(np.int32)).to(dev)
        nv = torch.tensor([N_TRACES] * N_BLOCKS, dtype=torch.int32, device=dev)
        qs = torch.from_numpy(pad_rows(qcodes, bucket(len(qcodes)), PAD_I32)).to(dev)
        got = kernels.find_rows(ids, qs, nv, steps)
        want = FD._bisect_plain(ids, qs, nv, steps)
        err = max_abs_err(got, want)
        hits = int((got[:, :48] >= 0).sum().item())
        if err or hits != 48 or int((got[:, 48:64] >= 0).sum().item()):
            raise AssertionError(f"K3: err {err}, {hits} of 48 present ids found")
        kernels.reset_counts()
        got = kernels.find_blocks([FD._device_ids(b, dev) for b in blks], qcodes, steps)
        if max_abs_err(got, want[:, :len(qcodes)]) or kernels.grid_launches()["find"] != 1:
            raise AssertionError("K3 over the blocks' own indexes differs from the stack's, or "
                                 "was not one __global__")
        # phase 5's shape: block 0's cached index and one present id
        one = [blks[0]]
        q1 = np.ascontiguousarray(blks[0].trace_index["trace.id_codes"][5:6], dtype=np.int32)
        per1 = [FD._device_ids(blks[0], dev)]
        ids1, nv1 = ids[:1].contiguous(), nv[:1].contiguous()
        q1_dev = torch.from_numpy(q1).to(dev)
        got = kernels.find_blocks(per1, q1, steps)
        err = max(err, max_abs_err(got, FD._bisect_plain(ids1, q1_dev, nv1, steps)))
        if err or int(got[0, 0]) != 5 or int(FD.lookup_ids_blocks_cached(one, q1, dev)[0, 0]) != 5:
            raise AssertionError("K3 at the find path's shape differs from its plain version "
                                 "or misses block 0's row 5")
        ms = cuda_ms(lambda: kernels.find_blocks(per1, q1, steps))
        pms = cuda_ms(lambda: FD._bisect_plain(ids1, q1_dev, nv1, steps))
        path_ms = host_ms(lambda: FD.lookup_ids_blocks_cached(one, q1, dev))
        stacked_ms = cuda_ms(lambda: kernels.find_rows(ids1, qs, nv1, steps))
        b_ms, b_by = bound(16 + 4 + (steps + 1) * 16 + 4, steps * 8)
        log(f"[K3] B=1 T={T} Q=1 (kernels.find_blocks, phase 5's shape): {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {b_ms:.3g} ms; the path's call (lookup_ids_blocks_cached, "
            f"read-back included, host clock) {path_ms:.4f} ms; stacked B=1 Q={qs.shape[0]} "
            f"(kernels.find_rows, phase 4's shape) {stacked_ms:.4f} ms")
        splits["K3, the find path's shape and phase 4's stacked one"] = {
            "1 block, 1 id": functools.partial(kernels.find_blocks, per1, q1, steps),
            f"stacked B=1 Q={qs.shape[0]}": functools.partial(kernels.find_rows, ids1, qs, nv1,
                                                             steps)}
        table.append({"name": "find", "route": "cuda", "source": "tempo_tpu_torch/csrc/find.cu",
                      "replaces": "tempo_tpu/ops/find.py:68", "launches": 0, "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None})

        # K4 -- res.service_id to span rows of block 0; and two columns in
        # one call (staging's form: the second table is the first reversed)
        res, ridx = cols["res.service_id"], cols["span.res_idx"]
        two = [res, torch.flip(res, [0])]
        kernels.reset_counts()
        got = kernels.res_to_span(res, ridx)
        err = max_abs_err(got, ST._res_to_span_plain(res, ridx))
        err = max(err, max_abs_err(kernels.res_to_span_many(two, ridx),
                                   ST._res_to_span_many_plain(two, ridx)))
        if err or kernels.grid_launches()["res_to_span"] != 2:
            raise AssertionError("K4 differs from its plain version, or took more than one "
                                 "__global__ a call")
        ms = cuda_ms(lambda: kernels.res_to_span(res, ridx))
        pms = cuda_ms(lambda: ST._res_to_span_plain(res, ridx))
        ms2 = cuda_ms(lambda: kernels.res_to_span_many(two, ridx))
        ridx_c = torch.clamp(ridx, 0, res.shape[0] - 1)
        lms = cuda_ms(lambda: torch.where(ridx >= 0, torch.index_select(res, 0, ridx_c),
                                          int(PAD_I32)))
        b_ms, b_by = bound(res.shape[0] * 4 + ridx.shape[0] * 8, ridx.shape[0])
        log(f"[K4] n_res_b={res.shape[0]} n_spans_b={ridx.shape[0]}: {ms:.4f} ms, two "
            f"columns in one call {ms2:.4f} ms, plain {pms:.4f} ms, "
            f"index_select+where {lms:.4f} ms, bound {b_ms:.4f} ms (two columns "
            f"{bound(2 * res.shape[0] * 4 + ridx.shape[0] * 12, 2 * ridx.shape[0])[0]:.4f} ms)")
        splits["K4, phase 4's shape (one column, two in one call)"] = {
            "one column": functools.partial(kernels.res_to_span, res, ridx),
            "two columns": functools.partial(kernels.res_to_span_many, two, ridx)}
        table.append({"name": "res_to_span", "route": "cuda", "source": "tempo_tpu_torch/csrc/stage.cu",
                      "replaces": "tempo_tpu/ops/stage.py:178-182", "launches": 0,
                      "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lms})

        # B5a -- 16 programs of one shape over block 0, different operands
        batch_q = batch_queries(blk0)
        bplans = [plan_search_request(blk0.dictionary, {}, query=q) for q in batch_q]
        lowered = [MQ.lower_plan(p) for p in bplans]
        if any(lq is None or lq.shape != lowered[0].shape for lq in lowered):
            raise AssertionError("B5a: the 16 queries do not lower to one program shape")
        shape = lowered[0].shape
        mq_staged = ST.stage_block(
            blk0, F.required_columns(bplans[0].conds) + ["trace.start_ms"], cache=False,
            device=dev)
        progs = MQ.pack_queries(lowered, 16)
        prog_t, dims, ptr_t = MQ.device_program(lowered, mq_staged, progs)
        sc = [mq_staged.cols[n] for n in shape.span_cols]
        tc = [mq_staged.cols[n] for n in shape.trace_cols]
        span_off = mq_staged.cols["trace.span_off"]

        def b5a():
            return kernels.multiquery(prog_t, dims, ptr_t, len(sc), len(tc), span_off, ns, nt, ntb,
                                      nsb)

        tprogs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in progs.items()}

        def b5a_plain():
            return MQ._multiquery_plain(sc, tc, span_off, tprogs, ns, nt, nsb, ntb)

        kernels.reset_counts()
        mq_tm, mq_cnt = b5a()
        b5a_grids = kernels.grid_launches()["multiquery"]
        err = max_abs_err((mq_tm, mq_cnt), b5a_plain())
        per_row = mq_tm.sum(dim=1).tolist()
        if err or min(per_row) < 1 or b5a_grids != 1:
            raise AssertionError(f"B5a: err {err}, matched traces per query {per_row}, "
                                 f"{b5a_grids} __global__ a call")
        ms = cuda_ms(b5a)
        dev_us = device_ms(b5a) * 1e3
        pms = cuda_ms(b5a_plain, reps=3, warm=1)
        n_conds = max(len(p.conds) for p in bplans)
        b_ms, b_by = bound(4 * ns * len(sc) + 4 * (ntb + 1) + 4 * nt * len(tc)
                           + 16 * 4 * kernels.MQ_W + 16 * ntb * 5, 16 * ns * n_conds)
        log(f"[B5a] Q=16 {shape.span_cols}: {per_row} traces, {ms:.4f} ms ({b5a_grids} "
            f"__global__ a call), device {dev_us:.2f} µs (queued), plain {pms:.4f} ms, "
            f"bound {b_ms:.4f} ms")
        table.append({"name": "multiquery", "route": "cuda",
                      "source": "tempo_tpu_torch/csrc/multiquery.cu",
                      "replaces": "tempo_tpu/ops/multiquery.py:356", "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": None})
        # the sweep: the first 1 and 4 of the programs, then all 16, each
        # against the plain version
        sweep = []
        for q in (1, 4, 16):
            progs_q = MQ.pack_queries(lowered[:q], q)
            prog_q, _, ptr_q = MQ.device_program(lowered[:q], mq_staged, progs_q)
            tp_q = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in progs_q.items()}

            def b5a_q(prog_q=prog_q, ptr_q=ptr_q):
                return kernels.multiquery(prog_q, dims, ptr_q, len(sc), len(tc), span_off, ns, nt,
                                          ntb, nsb)

            if max_abs_err(b5a_q(), MQ._multiquery_plain(sc, tc, span_off, tp_q, ns, nt, nsb, ntb)):
                raise AssertionError(f"B5a at Q={q} differs from its plain version")
            sweep.append(f"Q={q} {cuda_ms(b5a_q):.4f} ms")
        log("[B5a sweep] " + ", ".join(sweep) + "; each equal to the plain version")

        # B5b -- the 16 rows, k = 64, by the route select_plan takes (two
        # passes); yardstick: one torch.topk of the (Q, T) composite keys
        # (unique, so its order is defined)
        mq_key = mq_staged.cols["trace.start_ms"]
        mq_plan = kernels.select_plan(ntb, 64)
        kernels.reset_counts()
        got = kernels.mq_select(mq_tm, mq_key, mq_cnt, 64)
        b5b_grids = kernels.grid_launches()["mq_select"]
        err = max_abs_err(got, MQ._mq_select_plain(mq_tm, mq_key, mq_cnt, 64))
        comp16 = (torch.where(mq_tm, mq_key[None, :], int(PAD_I32)).to(torch.int64) * (1 << 32)
                  + ((1 << 32) - 1 - torch.arange(ntb, device=dev))[None, :])
        lib_idx = torch.topk(comp16, 64, dim=1).indices
        if err or not torch.equal(lib_idx.to(torch.int32), got[:, :64]):
            raise AssertionError("B5b differs from its plain version or from torch.topk's order")
        if not mq_plan.tiled or b5b_grids != 2:
            raise AssertionError(f"B5b at Q=16 N={ntb} k=64: tiled {mq_plan.tiled}, {b5b_grids} "
                                 f"__global__ a call (2 expected)")
        ms = cuda_ms(lambda: kernels.mq_select(mq_tm, mq_key, mq_cnt, 64))
        dev_us = device_ms(lambda: kernels.mq_select(mq_tm, mq_key, mq_cnt, 64)) * 1e3
        pms = cuda_ms(lambda: MQ._mq_select_plain(mq_tm, mq_key, mq_cnt, 64))
        lms = cuda_ms(lambda: torch.topk(comp16, 64, dim=1))
        lib_us = device_ms(lambda: torch.topk(comp16, 64, dim=1)) * 1e3
        # the mask (1 B a row and trace), the shared key, counts at the
        # 16 x 64 winners, the output
        b_ms, b_by = bound(16 * ntb + ntb * 4 + 16 * 64 * 4 + 16 * (3 * 64 + 1) * 4, 16 * ntb)
        log(f"[B5b] Q=16 N={ntb} k=64: {ms:.4f} ms (two passes, tile {mq_plan.tile}, "
            f"{mq_plan.tiles} tiles a row, {b5b_grids} __global__ a call), device {dev_us:.2f} µs "
            f"(queued), plain {pms:.4f} ms, torch.topk {lms:.4f} ms and {lib_us:.2f} µs (queued), "
            f"bound {b_ms:.5f} ms")
        table.append({"name": "mq_select", "route": "cuda",
                      "source": "tempo_tpu_torch/csrc/multiquery.cu",
                      "replaces": "tempo_tpu/ops/multiquery.py:461", "launches": 0,
                      "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lms})
        # the sweep: both routes at each k, each against the plain version
        for k in (64, 256, 2048, kernels.K_SMALL + 1):
            want = MQ._mq_select_plain(mq_tm, mq_key, mq_cnt, k)
            times = {}
            for plan in (kernels._tiled_plan(ntb, k), kernels._sort_plan(ntb, k)):
                def b5b_k(k=k, plan=plan):
                    return kernels._select_run(mq_tm, mq_key, mq_cnt, k, plan, "mq_select")

                if max_abs_err(b5b_k(), want):
                    raise AssertionError(f"B5b differs from its plain version at k={k}, "
                                         f"tiled={plan.tiled}")
                times["two passes" if plan.tiled else "full sort"] = cuda_ms(b5b_k)
            log(f"[B5b sweep] Q=16 N={ntb} k={k}: " + ", ".join(f"{r} {t:.4f} ms"
                                                                 for r, t in times.items())
                + f", torch.topk {cuda_ms(lambda: torch.topk(comp16, k, dim=1)):.4f} ms; "
                f"select_plan takes the "
                f"{'two passes' if kernels.select_plan(ntb, k).tiled else 'full sort'}")
        del mq_staged, sc, tc, span_off, tprogs, mq_tm, mq_cnt, comp16, lib_idx

        # B6 -- two metrics folds over block 0 at a 60 s step, then the
        # 512-group value fold again on dyadic values (exact sums)
        base_s = metas[0].start_time_unix_nano // 10**9
        b6 = {"ms": 0.0, "plain_ms": 0.0, "nbytes": 0, "ops": 0, "err": 0}
        for label, mq_text, dyadic in (("rate by service", METRICS_QUERIES[0], False),
                                       ("avg(duration) by name", METRICS_QUERIES[2], False),
                                       ("avg by name, dyadic", METRICS_QUERIES[2], True)):
            mq = ME.parse_metrics_query(mq_text)
            planned = plan_metrics_filter(mq, blk0.dictionary)
            gid, labels = ME.resolve_groups(blk0, mq.agg.by)
            mreq = ME.align_params(mq_text, base_s, base_s + 3600, METRICS_STEP_S)
            _, n_b, t0_rel = ME._block_axis(blk0, mreq)
            needed_ts = [n for n in F.required_columns(planned.conds)
                         if n != "trace.span_off"] + ["span.start_ms"]
            ts_staged = ST.stage_block(blk0, needed_ts, cache=False, device=dev)
            gid_t = torch.from_numpy(pad_rows(gid, nsb, np.int32(-1))).to(dev)
            val_t = pres_t = None
            if mq.agg.field is not None:
                val, pres = ME._value_column(blk0, mq.agg.field)
                if dyadic:
                    val = np.random.default_rng(3).integers(-511, 512, ns) / 8
                val_t = torch.from_numpy(pad_rows(val.astype(np.float32), nsb, np.float32(0))).to(dev)
                pres_t = torch.from_numpy(pad_rows(pres, nsb, False)).to(dev)
            ops_ts = F.Operands.build(planned.rows, planned.tables or None)
            prog = TS._span_program(planned.tree, tuple(planned.conds))
            buf = prog.buffer(ts_staged.cols, ops_ts, {})
            G = len(labels)

            def b6_run():
                return kernels.timeseries(prog, buf, ts_staged.cols, ts_staged.cols["span.start_ms"],
                                          gid_t, val_t, pres_t, t0_rel, mreq.step_ms, ns, nrb,
                                          ntb, n_b, G)

            ops_i = torch.from_numpy(ops_ts.ints).to(dev)
            ops_f = torch.from_numpy(ops_ts.floats).to(dev)

            def b6_plain():
                return TS._timeseries_plain(planned.tree, planned.conds, ts_staged.cols, ops_i,
                                            ops_f, {}, gid_t, val_t, pres_t, t0_rel,
                                            mreq.step_ms, ns, n_b, G, nsb, nrb, ntb)

            got, want = b6_run(), b6_plain()
            same = all(torch.equal(g, w) for i, (g, w) in enumerate(zip(got, want))
                       if i != 2 or dyadic)
            err = 0.0
            if len(got) == 5 and not dyadic:  # the f32 sum: atomics add in any order
                diff = (got[2] - want[2]).abs()
                err = float(diff.max())
                same = same and float((diff / want[2].abs().clamp_min(1e-30)).max()) <= 1e-5
            folded = int(got[0].sum().item())
            if not same or folded != ns:
                raise AssertionError(f"B6 {label}: differs from its plain version "
                                     f"(folded {folded} of {ns} spans)")
            ms = cuda_ms(b6_run)
            pms = cuda_ms(b6_plain, reps=5, warm=1)
            n_out = len(got)
            nbytes = ns * 8 + (ns * 5 if val_t is not None else 0) + G * n_b * 4 * n_out
            b_ms, _ = bound(nbytes, ns * 4)
            tplan = kernels.timeseries_plan(G * n_b, val_t is not None)
            log(f"[B6 {label}] {G} groups x {n_b} buckets: route {tplan.route} (cluster "
                f"{tplan.cluster}, {tplan.per} cells a CTA, {tplan.smem} B), {folded} spans folded, "
                f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.5f} ms")
            if not dyadic:
                splits[f"B6 {label}"] = {tplan.route: functools.partial(
                    kernels.timeseries, prog, buf, ts_staged.cols,
                    ts_staged.cols["span.start_ms"], gid_t, val_t, pres_t, t0_rel, mreq.step_ms,
                    ns, nrb, ntb, n_b, G)}
                b6["ms"] += ms
                b6["plain_ms"] += pms
                b6["nbytes"] += nbytes
                b6["ops"] += ns * 4
            b6["err"] = max(b6["err"], err)
            if label == "rate by service":
                b6_sweep(prog, buf, ts_staged, ns, n_b, t0_rel, mreq.step_ms, splits)
            del ts_staged, gid_t, val_t, pres_t, buf, got, want
        b_ms, b_by = bound(b6["nbytes"], b6["ops"])
        table.append({"name": "timeseries", "route": "cuda",
                      "source": "tempo_tpu_torch/csrc/timeseries.cu",
                      "replaces": "tempo_tpu/ops/timeseries.py:53", "launches": 0,
                      "max_abs_err": b6["err"], "ms": b6["ms"], "plain_ms": b6["plain_ms"],
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})

        # ---- 4c. the write path's kernels (B9a/B9b/B9c, B10a/B10b)
        phase_4c(blks, metas, absent, dev, table)
        del staged, cols, sib_staged, sib_cols, blks, ids, comp  # K2's inputs stay for k2_split
        torch.cuda.synchronize()

        # ---- 5./6. the main path: counts from 0, read right after
        kernels.reset_counts()
        t0 = time.perf_counter()
        seq_found = {}  # phase 9's reference answers
        for tid in present:
            tr = seq_found[tid] = db.find_trace_by_id(TENANT, tid)
            if tr is None or tr.span_count() != SPANS_PER or tr.trace_id() != tid:
                raise AssertionError(f"find {tid.hex()}: wrong trace")
        for tid in absent:
            if db.find_trace_by_id(TENANT, tid) is not None:
                raise AssertionError(f"find {tid.hex()}: absent id returned a trace")
        log(f"[find] 48 present + 16 absent ids in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        responses = [db.search(TENANT, SearchRequest(query=q, limit=20)) for q in SEARCH_QUERIES]
        dev_s = time.perf_counter() - t0
        counts_after = dict(kernels.LAUNCHES)
        grids_after = kernels.grid_launches()

        cpu_db = TempoDB(TempoDBConfig(), backend=backend, device="cpu")
        cpu_db.poll_now()
        t0 = time.perf_counter()
        for q, r in zip(SEARCH_QUERIES, responses):
            if not same_response(r, cpu_db.search(TENANT, SearchRequest(query=q, limit=20))):
                raise AssertionError(f"search {q}: card and CPU responses differ")
            log(f"[search] {q}: {len(r.traces)} traces, inspected {r.inspected_spans} spans")
        log(f"[search] {len(SEARCH_QUERIES)} queries: card {dev_s:.2f} s (first touch stages "
            f"every block), CPU check {time.perf_counter() - t0:.2f} s")
        # the per-block fallback, taken when a fused search would outgrow
        # the staged budget
        budget = SM._DEVICE_SEARCH_MAX_BYTES
        SM._DEVICE_SEARCH_MAX_BYTES = 0
        try:
            for q in (SEARCH_QUERIES[0], SEARCH_QUERIES[5]):
                req = SearchRequest(query=q, limit=20)
                r = db.search(TENANT, req)
                if not r.traces or not same_response(r, cpu_db.search(TENANT, req)):
                    raise AssertionError(f"per-block search {q}: card and CPU responses differ")
                log(f"[search per-block] {q}: {len(r.traces)} traces, card and CPU agree")
        finally:
            SM._DEVICE_SEARCH_MAX_BYTES = budget

        # ---- 7. launches
        log(f"[launches] wrapper calls {counts_after}, __global__ launches {grids_after}")
        missing = [k for k in ("filter", "select", "find", "res_to_span") if counts_after[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: {missing}")
        if grids_after["find"] != counts_after["find"]:
            raise AssertionError(f"K3: {grids_after['find']} __global__ for "
                                 f"{counts_after['find']} finds (one each)")
        if grids_after["res_to_span"] != counts_after["res_to_span"]:
            raise AssertionError(f"K4: {grids_after['res_to_span']} __global__ for "
                                 f"{counts_after['res_to_span']} staged blocks (one each)")
        if grids_after["filter"] > K1_SEARCH_GRIDS:
            raise AssertionError(f"K1: {grids_after['filter']} __global__ launches for "
                                 f"{counts_after['filter']} program runs of the "
                                 f"{len(SEARCH_QUERIES)} searches (at most {K1_SEARCH_GRIDS})")
        log(f"[launches] K1: {counts_after['filter']} program runs, {grids_after['filter']} "
            f"__global__ (at most {K1_SEARCH_GRIDS}; 500 on the multi-launch route)")
        launches = dict(counts_after)

        # ---- 8. batched search on block 0
        meta0 = metas[0]
        seq_db = TempoDB(TempoDBConfig(batch_enabled=False), backend=backend, device="cpu")
        seq_db.poll_now()
        cblk = seq_db.open_block(meta0)

        def unbatched(req, groups=None):
            """The CPU port's answer without batching: the single-block
            engine for batcher-eligible plans (the batcher's own fallback),
            the fused engine otherwise (the route the card takes too)."""
            p = SM._plan_for_block(cblk, req)
            if groups is not None or (not p.prune and MQ.lower_plan(p) is not None):
                return SM.search_block(cblk, req, groups_range=groups, device="cpu")
            return seq_db.search_blocks(TENANT, [meta0], req)

        reqs16 = [SearchRequest(query=q, limit=20) for q in batch_q]
        want16 = [unbatched(r) for r in reqs16]
        routing0 = BX.routing_counts()
        kernels.reset_counts()
        t0 = time.perf_counter()
        got16 = db.search_blocks_multi([(TENANT, [meta0], r) for r in reqs16])
        first_s = time.perf_counter() - t0
        group_counts = dict(kernels.LAUNCHES)
        group_grids = kernels.grid_launches()
        if not all(same_response(g, w) for g, w in zip(got16, want16)):
            raise AssertionError("batched search: a response differs from the unbatched CPU answer")
        occ = db.batchers.search.stats["max_occupancy"]
        if group_counts["multiquery"] != 1 or group_counts["mq_select"] != 1 or \
                group_counts["filter"] or occ != 16 or group_grids["multiquery"] != 1 or \
                group_grids["mq_select"] != 2:
            raise AssertionError(f"batched search: launches {group_counts}, __global__ "
                                 f"{group_grids} (B5a 1, B5b 2 on the two passes), occupancy {occ}")
        log(f"[batch] 16 queries, one group (first run of this column set, {first_s:.2f} s): "
            f"occupancy {occ}, wrapper calls {group_counts}, __global__ launches {group_grids}")
        with ThreadPoolExecutor(16) as ex:
            got = [f.result() for f in [ex.submit(db.search_blocks, TENANT, [meta0], r)
                                        for r in reqs16]]
        if not all(same_response(g, w) for g, w in zip(got, want16)):
            raise AssertionError("threaded batched search differs from the unbatched CPU answer")
        mixed = [SearchRequest(query=q, limit=20) for q in BATCH_FORMS + INELIGIBLE] + reqs16[:7]
        got = db.search_blocks_multi([(TENANT, [meta0], r) for r in mixed])
        for r, g in zip(mixed, got):
            if isinstance(g, Exception) or not same_response(g, unbatched(r)):
                raise AssertionError(f"mixed burst {r.query}: differs from the unbatched CPU answer")
        n_groups = len(meta0.row_groups)
        ranges = [list(range(i, min(i + 4, n_groups))) for i in range(0, n_groups, 4)]
        jobs = [(TENANT, meta0, r, g) for g in ranges for r in reqs16[:4]]
        got = db.search_block_shard_multi(jobs)
        for (_, _, r, g), resp in zip(jobs, got):
            if isinstance(resp, Exception) or not same_response(resp, unbatched(r, g)):
                raise AssertionError(f"shard burst {r.query} {g}: differs from the CPU answer")
        path_counts = dict(kernels.LAUNCHES)
        routing = {k: v - routing0.get(k, 0) for k, v in BX.routing_counts().items()
                   if v != routing0.get(k, 0)}
        log(f"[batch] threads, mixed burst ({len(mixed)}) and shard burst ({len(jobs)} jobs over "
            f"{len(ranges)} ranges) agree with the CPU; routing {routing}; wrapper calls "
            f"{path_counts}; stats {db.batchers.search.stats}")
        if any(k[2] == "fused_error" for k in routing) or path_counts["multiquery"] <= 0 \
                or path_counts["mq_select"] <= 0:
            raise AssertionError(f"batched search path: routing {routing}, launches {path_counts}")
        launches["multiquery"], launches["mq_select"] = path_counts["multiquery"], \
            path_counts["mq_select"]
        # the 16-query burst on the warm block, batched vs sequential, in turns
        walls = {"batched": [], "sequential": []}
        blk0_db = db.open_block(meta0)
        for _ in range(3):
            t0 = time.perf_counter()
            db.search_blocks_multi([(TENANT, [meta0], r) for r in reqs16])
            walls["batched"].append(time.perf_counter() - t0)
            kernels.reset_counts()
            t0 = time.perf_counter()
            for r in reqs16:
                SM.search_block(blk0_db, r, device=dev)
            walls["sequential"].append(time.perf_counter() - t0)
            seq_counts = dict(kernels.LAUNCHES)
        log(f"[batch] 16-query burst host-clock wall (s): batched {walls['batched']}, "
            f"sequential {walls['sequential']}; sequential wrapper calls {seq_counts}")

        # ---- 9. batched find: phase 5's ids, as multi-lookups and from threads
        ids64 = present + absent

        def cands(tid):
            return [m for m in metas if m.may_contain_id(tid.rjust(16, b"\x00").hex())]

        def same_trace(a, b) -> bool:
            return (a is None) == (b is None) and (a is None or
                                                   dataclasses.asdict(a) == dataclasses.asdict(b))

        # every fused find group, logged as its ids, the blocks past its
        # bloom gate and the Q of its K3 call (0: no block passed, no K3)
        group_log, tls = [], threading.local()
        fused0, lookup0 = BX._run_find_group_fused, FD.lookup_ids_blocks_cached

        def fused_spy(items):
            tls.rec = {"ids": len(items), "blocks": 0, "q": 0}
            group_log.append(tls.rec)
            try:
                return fused0(items)
            finally:
                tls.rec = None

        def lookup_spy(blocks, query, device):
            if getattr(tls, "rec", None) is not None:
                tls.rec["blocks"], tls.rec["q"] = len(blocks), int(query.shape[0])
            return lookup0(blocks, query, device)

        BX._run_find_group_fused, FD.lookup_ids_blocks_cached = fused_spy, lookup_spy
        routing0 = BX.routing_counts()
        kernels.reset_counts()
        try:
            t0 = time.perf_counter()
            got = db.find_in_blocks_multi([(TENANT, t, cands(t)) for t in ids64])
            multi_s = time.perf_counter() - t0
            multi_finds, multi_groups = kernels.LAUNCHES["find"], list(group_log)
            with ThreadPoolExecutor(16) as ex:
                got_t = [f.result() for f in [ex.submit(db.find_trace_by_id, TENANT, t)
                                              for t in ids64]]
        finally:
            BX._run_find_group_fused, FD.lookup_ids_blocks_cached = fused0, lookup0
        find_counts = dict(kernels.LAUNCHES)
        routing = {k: v - routing0.get(k, 0) for k, v in BX.routing_counts().items()
                   if v != routing0.get(k, 0)}
        for t, a, b in zip(ids64, got, got_t):
            if not (same_trace(a, seq_found.get(t)) and same_trace(b, seq_found.get(t))):
                raise AssertionError(f"batched find {t.hex()}: differs from the sequential trace")
        fstats = db.batchers.find.stats
        wide = [g for g in group_log if g["q"] > 1]
        log(f"[find batch] 64 ids: find_in_blocks_multi {multi_s:.2f} s in {multi_finds} K3 "
            f"calls, fused groups (ids, blocks past the bloom gate, K3 Q) "
            f"{[(g['ids'], g['blocks'], g['q']) for g in multi_groups]}; then 16 threads, "
            f"fused groups {[(g['ids'], g['blocks'], g['q']) for g in group_log[len(multi_groups):]]}"
            f"; wrapper calls {nonzero(find_counts)}; routing {routing}; stats {fstats}")
        if ("find_batch", "fallback", "fused_error") in routing or not wide \
                or find_counts["find"] < len(wide) or fstats["max_occupancy"] < 2:
            raise AssertionError(f"batched find: routing {routing}, K3 calls with Q > 1 "
                                 f"{len(wide)}, launches {find_counts}, stats {fstats}")

        # ---- 10. metrics over the 10 blocks, card vs TempoDB(device="cpu")
        lo_s = min(m.start_time_unix_nano for m in metas) // 10**9
        hi_s = -(-max(m.end_time_unix_nano for m in metas) // 10**9)
        ts_total, metrics_card = 0, []
        for mq_text in METRICS_QUERIES:
            mreq = ME.align_params(mq_text, lo_s, hi_s, METRICS_STEP_S)
            kernels.reset_counts()
            t0 = time.perf_counter()
            r = db.metrics_query_range(TENANT, mreq)
            card_s = time.perf_counter() - t0
            n_ts = kernels.LAUNCHES["timeseries"]
            n_grid = kernels.grid_launches()["timeseries"]
            t0 = time.perf_counter()
            c = cpu_db.metrics_query_range(TENANT, mreq)
            cpu_s = time.perf_counter() - t0
            # one __global__ a B6 call: the fold (no query here has a
            # resource.attr condition, so no res pass)
            if n_ts != N_BLOCKS or n_grid != N_BLOCKS or not r.series or not same_series(r, c):
                raise AssertionError(f"metrics {mq_text}: {n_ts} B6 calls ({n_grid} __global__), "
                                     f"series {len(r.series)} vs CPU {len(c.series)}")
            ts_total += n_ts
            metrics_card.append(r)
            log(f"[metrics] {mq_text}: {len(r.series)} series x {mreq.n_buckets} buckets, "
                f"{n_ts} B6 calls ({n_grid} __global__), card {card_s:.2f} s, CPU check {cpu_s:.2f} s")
        launches["timeseries"] = ts_total
        # where a warm metrics query's host-clock wall goes: a profile of
        # the first query run once more, the top functions by own time
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        db.metrics_query_range(TENANT, ME.align_params(METRICS_QUERIES[0], lo_s, hi_s,
                                                       METRICS_STEP_S))
        prof.disable()
        wall = time.perf_counter() - t0
        own = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])[:5]
        log(f"[metrics profile] {METRICS_QUERIES[0]}: {wall:.2f} s under the profiler; own time "
            + "; ".join(f"{os.path.basename(f)}:{ln} {fn} {tt:.2f} s" for (f, ln, fn), (_, _, tt, _, _)
                        in own))

        # phase 15 runs on the corpus as phases 5-10 saw it: a hard-linked
        # copy of the store (phase 12 compacts and expires the original)
        mesh_store = os.path.join(tmp, "store-mesh")
        shutil.copytree(os.path.join(tmp, "store"), mesh_store, copy_function=os.link)
        # and phase 16's App, which writes its flush into its own copy
        app_store = os.path.join(tmp, "store-app")
        shutil.copytree(os.path.join(tmp, "store"), app_store, copy_function=os.link)

        # ---- 11. the cut at full width; 12. compaction, last
        t0 = time.perf_counter()
        blk0 = open_block(backend, TENANT, metas[0].block_id)
        cut_counts, pairs, cut = phase_11(db, blk0, dev, tmp)
        splits.update(phase_11_table(cut, table))
        del cut
        # phase 12's retention deletes block 0: phase 13 takes what it
        # needs of it now
        ingest_queries = batch_queries(blk0, 2)
        span_s = (metas[0].start_time_unix_nano // 10**9, -(-metas[0].end_time_unix_nano // 10**9))
        log(f"[cut] phase 11 took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        union_counts = phase_12(db, os.path.join(tmp, "store"), tmp, dev, present, absent,
                                seq_found)
        log(f"[compact] phase 12 took {time.perf_counter() - t0:.1f} s")

        # ---- 13. the ingest plane and the live head, then its kernels
        t0 = time.perf_counter()
        p13 = phase_13(db, dev, pairs, ingest_queries, span_s, tmp)
        log(f"[ingest] phase 13 took {time.perf_counter() - t0:.1f} s")
        splits.update(phase_13_table(p13["snap"], table, p13["append"]))

        # ---- 14. the metrics-generator behind the distributor's tap
        t0 = time.perf_counter()
        p14 = phase_14(db, dev, pairs, tmp)
        del pairs
        log(f"[generator] phase 14 took {time.perf_counter() - t0:.1f} s")
        splits.update(phase_14_table(p14["last"], table, p14["b8b"], p14["n_series"]))
        for name in ("remap", "bloom_bits", "rowgroup"):
            launches[name] = cut_counts[name]
        for name in ("bloom_union", "bloom_test"):
            launches[name] = union_counts[name]
        for name in ("live_filter", "live_find", "live_append", "live_patch"):
            launches[name] = p13["counts"][name]
        for name in ("span_reduce", "edge_reduce"):
            launches[name] = p14["counts"][name]

        # ---- 15. the mesh: NCCL at one rank, then gloo 2x2 on the card
        t0 = time.perf_counter()
        p15 = phase_15(mesh_store, dev, tmp, ids64, seq_found, batch_q, meta0.block_id, want16,
                       metrics_card, lo_s, hi_s, responses)
        log(f"[mesh] phase 15 took {time.perf_counter() - t0:.1f} s")
        splits.update(phase_15_table(p15, table))

        # ---- 16. the read plane and the single binary, served over HTTP
        t0 = time.perf_counter()
        phase_16(app_store, dev, present, absent, seq_found, metrics_card[1], lo_s, hi_s, smi)
        log(f"[app] phase 16 took {time.perf_counter() - t0:.1f} s")
        k2_split(mask10, key10, cnt10, k10)
        for what, fns in splits.items():
            device_split(what, fns)
        del splits
        del p15["args"], p15["shards"]
        for name in ("find_elect", "mq_partial", "mq_combine", "timeseries_stacked",
                     "attr_partial", "mask_pack", "struct_packed", "search_partial",
                     "search_finish", "search_fused"):
            launches[name] = p15["counts"][name]
        for row in table:
            row["launches"] = launches[row["name"]]
        if len(table) != len(kernels.LAUNCHES) or any(r["launches"] <= 0 for r in table):
            raise AssertionError(f"kernel table: {[(r['name'], r['launches']) for r in table]}")
        # the port's order for redesigns after the kernels that lose to one
        # PyTorch call: launches on the path x (time - bound) of one call,
        # largest first (K1's row sums its 8 forms, B6's its 2)
        summed = {"filter": len(K1_QUERIES), "timeseries": 2}

        def gap(r):
            return r["launches"] * (r["ms"] - r["bound_ms"]) / summed.get(r["name"], 1)

        log("[rank] launches x (ms - bound_ms) a call: " + ", ".join(
            f"{r['name']} {gap(r):.3f}" for r in sorted(table, key=lambda r: -gap(r))))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log(f"[smoke] {time.perf_counter() - t_main:.1f} s from start to the kernel line")
    print(smi, flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
