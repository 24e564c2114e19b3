"""Stage vtpu block columns onto the card for filtering (port of
tempo_tpu/ops/stage.py).

Reads only the columns a condition set needs (ops.filter.required_columns),
optionally only a row-group range, pads every axis to its power-of-two
bucket, and uploads them in ONE host->device transfer. Staged tensors
are cached on the (immutable) block object keyed by (column set, group
range, device), under a global byte budget (an LRU over every block's
entries), so repeated queries against a hot block skip IO,
decompression and the transfer.

The `span@<res col>` columns are materialized once per staged entry by
kernel K4 (csrc/stage.cu) on CUDA tensors, `_res_to_span_plain` on CPU
tensors.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..block import schema as S
from ..block.reader import BackendBlock
from .device import PAD_I32, bucket, pad_rows, resolve_device
from .filter import TraceTiles, trace_tiles

_CACHE_MAX_ENTRIES = 32  # per block
_CACHE_MAX_ENTRY_BYTES = 256 << 20

# aggregate device-memory budget across EVERY block's staged cache: an
# LRU over (block, entry) pairs, so a wide working set evicts the
# coldest block's columns instead of growing until the card runs out
_GLOBAL_CACHE_BUDGET = 4 << 30
_lru_lock = threading.Lock()
_lru: OrderedDict[tuple[int, tuple], tuple] = OrderedDict()  # -> (blk weakref, nbytes)
_lru_bytes = 0


def _sweep_dead_locked() -> None:
    """Drop entries whose block weakref has died: their tensors are gone,
    so their bytes must not count against the budget."""
    global _lru_bytes
    dead = [k for k, (wr, _) in _lru.items() if wr() is None]
    for k in dead:
        _lru_bytes -= _lru.pop(k)[1]


def _lru_touch(blk, key: tuple, nbytes: int) -> None:
    global _lru_bytes
    k = (id(blk), key)
    with _lru_lock:
        existing = _lru.get(k)
        if existing is not None:
            if existing[0]() is blk:
                _lru.move_to_end(k)
                return
            # id() reuse after the old block was collected
            _lru_bytes -= existing[1]
            del _lru[k]
        _lru[k] = (weakref.ref(blk), nbytes)
        _lru_bytes += nbytes
        _evict_over_budget_locked()


def _lru_drop(blk, key: tuple) -> None:
    """Per-block cap evictions must release their global accounting."""
    global _lru_bytes
    with _lru_lock:
        entry = _lru.pop((id(blk), key), None)
        if entry is not None:
            _lru_bytes -= entry[1]


def _evict_over_budget_locked() -> None:
    global _lru_bytes
    _sweep_dead_locked()
    while _lru_bytes > _GLOBAL_CACHE_BUDGET and len(_lru) > 1:
        (_bid, key), (wr, nbytes) = _lru.popitem(last=False)
        _lru_bytes -= nbytes
        blk = wr()
        store = getattr(blk, "_staged_cache", None) if blk is not None else None
        if store is not None:
            store.pop(key, None)


# absolute-seconds origin (2020-01-01 UTC) for the derived trace@gkey_s
# column: a global trace start time in int32 seconds that orders traces
# ACROSS blocks -- per-block relative ms don't
GKEY_ORIGIN_S = 1_577_836_800


def gkey_from_start_ms(meta, start_ms):
    """The cross-block top-k ordering key (trace@gkey_s convention):
    absolute seconds since GKEY_ORIGIN_S from a block's relative
    start_ms column."""
    base_s = meta.start_time_unix_nano // 1_000_000_000 - GKEY_ORIGIN_S
    return np.asarray(start_ms).astype(np.int64) // 1000 + base_s


def _res_to_span_plain(res_vals: torch.Tensor, res_idx: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: res column broadcast to span rows; PAD where
    the span has no resource row."""
    out = res_vals[torch.clamp(res_idx, 0, res_vals.shape[0] - 1).long()]
    return torch.where(res_idx >= 0, out, int(PAD_I32))


def res_to_span(res_vals: torch.Tensor, res_idx: torch.Tensor) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if res_vals.device.type == "cpu":
        return _res_to_span_plain(res_vals, res_idx)
    from .. import kernels

    return kernels.res_to_span(res_vals, res_idx)


_AXIS_OF = {
    "span": S.AX_SPAN,
    "sattr": S.AX_SATTR,
    "rattr": None,  # res-axis tables are small: always loaded whole
    "res": None,
    "trace": None,
}


@dataclass
class StagedBlock:
    n_spans: int
    n_traces: int
    n_res: int
    n_spans_b: int
    n_traces_b: int
    n_res_b: int
    span_base: int  # global row of first staged span (group-range staging)
    cols: dict[str, torch.Tensor] = field(default_factory=dict)
    # K1's route plan inputs (ops/filter.trace_tiles), computed at
    # staging; None: no tiling, so K1 takes its multi-launch route
    tiles: TraceTiles | None = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.cols.values())


@dataclass
class StagePlan:
    read_names: list[str]  # real pack columns to read
    materialize: list[str]  # res columns to broadcast to span level
    want_gkey: bool
    start_ms_for_gkey_only: bool


def plan_stage(needed: list[str]) -> StagePlan:
    materialize = [n.split("@", 1)[1] for n in needed if n.startswith("span@")]
    want_gkey = "trace@gkey_s" in needed
    read_names = [n for n in needed if not n.startswith(("span@", "trace@"))]
    start_ms_for_gkey_only = want_gkey and "trace.start_ms" not in read_names
    if start_ms_for_gkey_only:
        read_names = read_names + ["trace.start_ms"]
    return StagePlan(read_names, materialize, want_gkey, start_ms_for_gkey_only)


def read_stage_columns(blk: BackendBlock, plan: StagePlan,
                       groups: list[int]) -> tuple[dict, int]:
    """The host-read phase: raw columns (sliced to `groups` on their
    axis) + the res-axis row count."""
    pack = blk.pack
    span_ax = pack.axes[S.AX_SPAN]
    host: dict[str, np.ndarray] = {}
    n_res = 0
    for name in plan.read_names:
        ax = _AXIS_OF.get(name.split(".", 1)[0])
        if ax is None:
            arr = pack.read(name)
        else:
            arr = pack.read_groups(name, groups) if span_ax.n_groups else pack.read(name)
        host[name] = arr
    for name, arr in host.items():
        if name.startswith("res."):
            n_res = max(n_res, arr.shape[0])
    return host, n_res


def stage_block(
    blk: BackendBlock,
    needed: list[str],
    groups: list[int] | None = None,
    cache: bool = True,
    device=None,
) -> StagedBlock:
    """Load `needed` columns (padded, on `device`). If `groups` is given,
    span/sattr-axis columns cover only those contiguous row groups.
    Results cache on the block object (blocks are immutable)."""
    dev = resolve_device(device)
    key = (tuple(needed), tuple(groups) if groups is not None else None, str(dev))
    store: dict | None = getattr(blk, "_staged_cache", None) if cache else None
    if store is not None:
        hit = store.get(key)
        if hit is not None:
            _lru_touch(blk, key, hit.nbytes)
            return hit
    plan = plan_stage(needed)
    span_ax = blk.pack.axes[S.AX_SPAN]
    if groups is None:
        groups = list(range(span_ax.n_groups))
    host, n_res = read_stage_columns(blk, plan, groups)
    staged, padded = assemble_stage(blk, plan, groups, host, n_res)
    upload_stage(plan, staged, padded, dev)
    if cache:
        _cache_insert(blk, key, staged)
    return staged


def _cache_insert(blk: BackendBlock, key: tuple, staged: StagedBlock) -> None:
    nbytes = staged.nbytes
    if nbytes > _CACHE_MAX_ENTRY_BYTES:
        return
    store = getattr(blk, "_staged_cache", None)
    if store is None:
        store = {}
        blk._staged_cache = store
    if len(store) >= _CACHE_MAX_ENTRIES:
        victim = next(iter(store))
        store.pop(victim)
        _lru_drop(blk, victim)
    store[key] = staged
    _lru_touch(blk, key, nbytes)


def assemble_stage(blk: BackendBlock, plan: StagePlan, groups: list[int],
                   host: dict, n_res: int) -> tuple[StagedBlock, dict]:
    """The pad/assemble phase: owner-offset transforms, derived columns,
    bucket padding. Pure host numpy -- no IO, no device."""
    host = dict(host)
    pack = blk.pack
    span_ax = pack.axes[S.AX_SPAN]
    span_base = span_ax.offsets[groups[0]] if groups else 0
    span_hi = span_ax.offsets[groups[-1] + 1] if groups else 0
    n_spans = span_hi - span_base
    n_traces = blk.meta.total_traces

    n_spans_b = bucket(max(n_spans, 1))
    n_traces_b = bucket(max(n_traces, 1))
    n_res_b = bucket(max(n_res, 1))

    staged = StagedBlock(
        n_spans=n_spans, n_traces=n_traces, n_res=n_res, n_spans_b=n_spans_b,
        n_traces_b=n_traces_b, n_res_b=n_res_b, span_base=span_base,
    )
    # owner-offset columns: rows of every child table are grouped by
    # owner, so the kernel walks each owner's row range -- the owner
    # row columns themselves never need to reach the device
    if "sattr.span" in host:
        owners = np.clip(host["sattr.span"] - span_base, 0, max(n_spans, 1) - 1)
        cnt = np.bincount(owners, minlength=max(n_spans, 1)) if owners.size else np.zeros(
            max(n_spans, 1), dtype=np.int64
        )
        off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
        host["sattr.off"] = pad_rows(off, n_spans_b + 1, off[-1] if off.size else 0)
        del host["sattr.span"]
    if "rattr.res" in host:
        owners = np.clip(host["rattr.res"], 0, max(n_res, 1) - 1)
        cnt = np.bincount(owners, minlength=max(n_res, 1)) if owners.size else np.zeros(
            max(n_res, 1), dtype=np.int64
        )
        off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int32)
        host["rattr.off"] = pad_rows(off, n_res_b + 1, off[-1] if off.size else 0)
        del host["rattr.res"]

    if plan.want_gkey:
        host["trace@gkey_s"] = gkey_from_start_ms(
            blk.meta, host["trace.start_ms"]).astype(np.int32)
        if plan.start_ms_for_gkey_only:
            host.pop("trace.start_ms", None)

    padded: dict[str, np.ndarray] = {}
    for name, arr in host.items():
        pref = name.split(".", 1)[0].split("@", 1)[0]
        if name == "trace.span_off":
            # rebase global span rows to the staged slice; padded trace
            # rows collapse to empty segments (count 0)
            arr = (np.clip(arr, span_base, span_hi) - span_base).astype(np.int32)
            arr = pad_rows(arr, n_traces_b + 1, arr[-1] if arr.size else 0)
        elif name in ("sattr.off", "rattr.off"):
            pass  # already padded above
        elif name == "trace@gkey_s":
            arr = pad_rows(arr, n_traces_b, np.int32(-(2**31)))
        elif pref == "span":
            arr = pad_rows(arr, n_spans_b, PAD_I32)
        elif pref in ("sattr", "rattr"):
            arr = pad_rows(arr, bucket(max(arr.shape[0], 1)), PAD_I32)
        elif pref == "res":
            arr = pad_rows(arr, n_res_b, PAD_I32)
        elif pref == "trace":
            if arr.dtype in (np.int32, np.float32):
                arr = pad_rows(arr, n_traces_b, PAD_I32 if arr.dtype == np.int32 else np.float32(0))
            else:
                continue  # host-only trace columns are not staged
        padded[name] = arr
    staged.tiles = _tiles_of(padded, n_spans)
    return staged, padded


def _tiles_of(padded: dict, n_spans: int) -> TraceTiles | None:
    if "trace.span_off" not in padded:
        return None
    return trace_tiles(padded["trace.span_off"], padded.get("span.parent_idx"),
                       padded.get("span.trace_sid"), n_spans)


_TILE_BOUNDS = "\0tile bounds"  # rides the one upload, then moves to StagedBlock.tiles


def _upload_with_tiles(staged: StagedBlock, arrays: dict, dev: torch.device) -> None:
    tiles = staged.tiles
    if tiles is not None and tiles.bounds is not None:
        arrays = {**arrays, _TILE_BOUNDS: tiles.bounds.numpy()}
    staged.cols = _upload(arrays, dev)
    if _TILE_BOUNDS in staged.cols:
        staged.tiles = replace(tiles, bounds=staged.cols.pop(_TILE_BOUNDS))


def _upload(arrays: dict[str, np.ndarray], dev: torch.device) -> dict[str, torch.Tensor]:
    """ONE host->device transfer: every array packed 16-byte aligned into
    one (pinned, for a card) host buffer, copied once, then viewed back
    per column on the device."""
    offs, total = {}, 0
    for name, a in arrays.items():
        offs[name] = total
        total = (total + a.nbytes + 15) & ~15
    host = torch.empty(max(total, 16), dtype=torch.uint8, pin_memory=dev.type == "cuda")
    hv = host.numpy()
    for name, a in arrays.items():
        hv[offs[name] : offs[name] + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    buf = host.to(dev) if dev.type != "cpu" else host
    out = {}
    for name, a in arrays.items():
        raw = buf[offs[name] : offs[name] + a.nbytes]
        out[name] = raw.view(getattr(torch, a.dtype.name)).reshape(a.shape)
    return out


def upload_stage(plan: StagePlan, staged: StagedBlock, padded: dict,
                 device) -> StagedBlock:
    """The host->device phase: one batched transfer + the query-
    independent res->span materialization (K4)."""
    _upload_with_tiles(staged, padded, resolve_device(device))
    if plan.materialize and "span.res_idx" in staged.cols:
        for name in plan.materialize:
            if name in staged.cols:
                staged.cols[f"span@{name}"] = res_to_span(
                    staged.cols[name], staged.cols["span.res_idx"])
    return staged


def staged_from_numpy(cols: dict[str, np.ndarray], n_spans: int, n_traces: int,
                      n_res: int, device) -> StagedBlock:
    """Already-padded staged columns (e.g. the JAX package's
    StagedBlock.cols pulled to numpy) -> the port's StagedBlock on
    `device`, through the same single upload."""
    staged = StagedBlock(
        n_spans=n_spans, n_traces=n_traces, n_res=n_res,
        n_spans_b=bucket(max(n_spans, 1)), n_traces_b=bucket(max(n_traces, 1)),
        n_res_b=bucket(max(n_res, 1)), span_base=0,
    )
    arrays = {k: np.asarray(v) for k, v in cols.items()}
    staged.tiles = _tiles_of(arrays, n_spans)
    _upload_with_tiles(staged, arrays, resolve_device(device))
    return staged
