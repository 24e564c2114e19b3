"""Segmented reduces for the metrics-generator (port of
tempo_tpu/ops/reduce.py).

A push window's spans fold into per-series (calls, latency sum, latency
histogram) in one pass (B8a), and its completed service-graph edges into
per-edge (count, failed count, client and server sums and histograms) in
another (B8b): series or edge ids are the segments, the histogram cell is
(id, searchsorted(edges, duration)). CUDA tensors go to the kernels
(csrc/reduce.cu), CPU tensors to the plain versions. Unlike the JAX
package, no fold is sent to the host when the link is slow: the device
the caller names runs it (util/linkcost.py measures the link).

The host twins `_reduce_host` / `_edge_reduce_host` are the JAX
package's numpy branch (float64 sums), kept as test oracles.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .device import bucket, resolve_device


def _bucket_idx(v: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """searchsorted(edges, v, 'left') in f32, as the count of edges e
    with !(v <= e): NaN lands in the last bucket, as numpy sorts it."""
    return (~(v[:, None] <= edges[None, :])).sum(dim=1)


def _valid(ids: torch.Tensor, n_valid: int, n_ids: int) -> torch.Tensor:
    rows = torch.arange(ids.shape[0], device=ids.device) < n_valid
    return rows & (ids >= 0) & (ids < n_ids)


def _fold_hist(ids: torch.Tensor, bidx: torch.Tensor, n_ids: int, nb: int) -> torch.Tensor:
    cell = ids.long() * nb + bidx
    return torch.bincount(cell, minlength=n_ids * nb).to(torch.int32).reshape(n_ids, nb)


def _reduce_plain(sid: torch.Tensor, dur: torch.Tensor, n_valid: int, edges: torch.Tensor,
                  n_ids: int):
    """B8a's plain version: (calls, lat_sum, hist) over rows i < n_valid
    whose id lies in [0, n_ids); sums in f32."""
    keep = _valid(sid, n_valid, n_ids)
    s, v = sid[keep].long(), dur[keep]
    nb = edges.shape[0] + 1
    calls = torch.bincount(s, minlength=n_ids).to(torch.int32)
    lsum = torch.zeros(n_ids, dtype=torch.float32, device=sid.device).index_add_(0, s, v)
    return calls, lsum, _fold_hist(s, _bucket_idx(v, edges), n_ids, nb)


def _edge_reduce_plain(eid: torch.Tensor, cdur: torch.Tensor, sdur: torch.Tensor,
                       failed: torch.Tensor, n_valid: int, edges: torch.Tensor, n_ids: int):
    """B8b's plain version: (counts, failed_counts, client_sum,
    server_sum, client_hist, server_hist); sums in f32."""
    keep = _valid(eid, n_valid, n_ids)
    e, c, s, f = eid[keep].long(), cdur[keep], sdur[keep], failed[keep]
    nb = edges.shape[0] + 1

    def fsum(v):
        return torch.zeros(n_ids, dtype=torch.float32, device=eid.device).index_add_(0, e, v)

    counts = torch.bincount(e, minlength=n_ids).to(torch.int32)
    fcounts = torch.zeros(n_ids, dtype=torch.int32, device=eid.device).index_add_(0, e, f)
    return (counts, fcounts, fsum(c), fsum(s), _fold_hist(e, _bucket_idx(c, edges), n_ids, nb),
            _fold_hist(e, _bucket_idx(s, edges), n_ids, nb))


def span_reduce(sid, dur, n_valid: int, edges, n_ids: int):
    """B8a on sid's device: the kernel for a CUDA tensor, the plain
    version for a CPU one."""
    if sid.device.type == "cuda":
        return kernels.span_reduce(sid, dur, n_valid, edges, n_ids)
    return _reduce_plain(sid, dur, n_valid, edges, n_ids)


def span_fold(sid, dur, n_valid: int, edges, n_ids: int) -> torch.Tensor:
    """B8a on sid's device into one packed int32 table (kernels.
    span_views' layout): the kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if sid.device.type == "cuda":
        return kernels.span_fold(sid, dur, n_valid, edges, n_ids)
    calls, lsum, hist = _reduce_plain(sid, dur, n_valid, edges, n_ids)
    return torch.cat([calls[:, None], lsum.view(torch.int32)[:, None], hist], dim=1).reshape(-1)


def edge_fold(eid, cdur, sdur, failed, n_valid: int, edges, n_ids: int) -> torch.Tensor:
    """B8b on eid's device into one packed int32 buffer (kernels.
    edge_views' layout): the kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if eid.device.type == "cuda":
        return kernels.edge_fold(eid, cdur, sdur, failed, n_valid, edges, n_ids)
    out = _edge_reduce_plain(eid, cdur, sdur, failed, n_valid, edges, n_ids)
    return torch.cat([o.reshape(-1).view(torch.int32) for o in out])


def edge_reduce(eid, cdur, sdur, failed, n_valid: int, edges, n_ids: int):
    """B8b's six outputs on eid's device (edge_fold, viewed)."""
    return kernels.edge_views(edge_fold(eid, cdur, sdur, failed, n_valid, edges, n_ids), n_ids,
                              edges.shape[0] + 1)


def _pad(arr: np.ndarray, n: int, fill, dtype) -> np.ndarray:
    out = np.full(n, fill, dtype=dtype)
    out[:arr.shape[0]] = arr
    return out


def span_metrics_reduce(sid: np.ndarray, dur_s: np.ndarray, n_series: int,
                        bucket_edges: tuple, device=None):
    """-> (calls (n_series,) int64, latency_sum (n_series,) float64,
    histogram (n_series, len(edges)+1) int64) as numpy, folded on
    `device` (None: the first card): one upload of the rows, one
    download of the table's first n_series rows. Rows pad to bucket(n)
    with id Sb = bucket(n_series), which the fold drops; sums are f32 on
    the device and f64 only after the slice to n_series."""
    n = sid.shape[0]
    nb = len(bucket_edges) + 1
    if n == 0 or n_series == 0:
        return (np.zeros(n_series, np.int64), np.zeros(n_series, np.float64),
                np.zeros((n_series, nb), np.int64))
    dev = resolve_device(device)
    Np, Sb = bucket(n), bucket(n_series)
    # sid and dur in one upload as int32 words (padded rows carry id Sb,
    # which the fold drops)
    rows = np.zeros((2, Np), np.int32)
    rows[0] = Sb
    rows[0, :n] = sid
    rows[1, :n] = np.asarray(dur_s, np.float32).view(np.int32)
    t = torch.from_numpy(rows).to(dev)
    packed = span_fold(t[0], t[1].view(torch.float32), n, _edges_on(dev, tuple(bucket_edges)), Sb)
    # one download: the table's first n_series rows are contiguous
    calls, lsum, hist = kernels.span_views(packed[:n_series * (nb + 2)].cpu(), n_series, nb)
    return (calls.numpy().astype(np.int64), lsum.numpy().astype(np.float64),
            hist.numpy().astype(np.int64))


def edge_metrics_reduce(eid: np.ndarray, cdur: np.ndarray, sdur: np.ndarray,
                        failed: np.ndarray, n_edges: int, bucket_edges: tuple, device=None):
    """-> (counts, failed_counts, client_sum, server_sum, client_hist,
    server_hist) per edge id, as numpy (int64 / float64), folded in one
    pass on `device` (None: the first card); padding as
    span_metrics_reduce's."""
    n = eid.shape[0]
    nb = len(bucket_edges) + 1
    if n == 0 or n_edges == 0:
        z = np.zeros(n_edges, np.int64)
        zf = np.zeros(n_edges, np.float64)
        zh = np.zeros((n_edges, nb), np.int64)
        return z, z.copy(), zf, zf.copy(), zh, zh.copy()
    dev = resolve_device(device)
    Np, Eb = bucket(n), bucket(n_edges)
    # the four row columns in one upload: eid, cdur, sdur, failed as
    # int32 words (padded rows carry id Eb, which the fold drops)
    rows = np.zeros((4, Np), np.int32)
    rows[0] = Eb
    rows[0, :n] = eid
    rows[1, :n] = np.asarray(cdur, np.float32).view(np.int32)
    rows[2, :n] = np.asarray(sdur, np.float32).view(np.int32)
    rows[3, :n] = failed
    t = torch.from_numpy(rows).to(dev)
    packed = edge_fold(t[0], t[1].view(torch.float32), t[2].view(torch.float32), t[3], n,
                       _edges_on(dev, tuple(bucket_edges)), Eb)
    out = kernels.edge_views(packed.cpu(), Eb, nb)  # one download
    types = (np.int64, np.int64, np.float64, np.float64, np.int64, np.int64)
    return tuple(o[:n_edges].numpy().astype(ty) for o, ty in zip(out, types))


@lru_cache(maxsize=16)
def _edges_on(dev: torch.device, bucket_edges: tuple) -> torch.Tensor:
    """The bucket edges as f32 on dev, uploaded once per device and tuple."""
    return torch.tensor(bucket_edges, dtype=torch.float32, device=dev)


def _reduce_host(sid: np.ndarray, dur_s: np.ndarray, n_series: int, bucket_edges: tuple):
    """Host twin (the JAX package's numpy branch): one searchsorted and
    two bincounts, sums in float64. A test oracle."""
    edges = np.asarray(bucket_edges, np.float32)
    nb = len(bucket_edges) + 1
    bidx = np.searchsorted(edges, dur_s.astype(np.float32))
    combo = sid.astype(np.int64) * nb + bidx
    hist = np.bincount(combo, minlength=n_series * nb)[: n_series * nb]
    hist = hist.reshape(n_series, nb)
    lsum = np.bincount(sid, weights=dur_s.astype(np.float64), minlength=n_series)[:n_series]
    return (hist.sum(axis=1).astype(np.int64), lsum.astype(np.float64),
            hist.astype(np.int64))


def _edge_reduce_host(eid: np.ndarray, cdur: np.ndarray, sdur: np.ndarray,
                      failed: np.ndarray, n_edges: int, bucket_edges: tuple):
    """Host twin of B8b: the span host fold per side plus a failed
    bincount. A test oracle."""
    counts, csum, chist = _reduce_host(eid, cdur, n_edges, bucket_edges)
    _, ssum, shist = _reduce_host(eid, sdur, n_edges, bucket_edges)
    fcounts = np.bincount(eid[failed.astype(bool)],
                          minlength=n_edges)[:n_edges].astype(np.int64)
    return counts, fcounts, csum, ssum, chist, shist
