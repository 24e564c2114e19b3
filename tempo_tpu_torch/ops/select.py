"""Top-k result selection: pick the `limit` newest matching traces
without shipping full masks to host (port of tempo_tpu/ops/select.py).

The filter produces (trace_mask, span_count) sized to the trace axis.
The selection runs on the card: key = trace start time under the mask,
a masked top-k with ties to the lower index (lax.top_k's order), and
ONE small fused int32 vector `[sids | counts | valid | n_match]` comes
back -- a single fetch whose size is O(k).

Host re-verification may reject candidates (conservative device
encodings), so callers over-select and escalate k (db/search.py).
CUDA tensors run kernel K2 (csrc/select.cu); CPU tensors run
`_select_plain`, a stable descending sort of the masked key.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -(2**31)


def k_bucket(k: int) -> int:
    """Power-of-two k so escalation reuses few launch shapes."""
    b = 16
    while b < k:
        b <<= 1
    return b


def _select_plain(mask: torch.Tensor, key: torch.Tensor, counts: torch.Tensor,
                  k: int) -> torch.Tensor:
    """Plain version of K2: the same packed buffer from a stable
    descending sort (equal keys keep index order)."""
    keyed = torch.where(mask, key.to(torch.int32), _NEG)
    topi = torch.sort(keyed, descending=True, stable=True).indices[:k]
    return torch.cat([
        topi.to(torch.int32),
        counts[topi].to(torch.int32),
        mask[topi].to(torch.int32),
        mask.to(torch.int32).sum().reshape(1).to(torch.int32),
    ])


def _select(mask, key, counts, k: int) -> np.ndarray:
    if mask.device.type == "cpu":
        out = _select_plain(mask, key, counts, k)
    else:
        from .. import kernels

        out = kernels.select_topk(mask, key.to(torch.int32), counts.to(torch.int32), k)
    return out.cpu().numpy()


def select_topk_device(mask, key, counts, k: int):
    """mask/key/counts: same-length tensors on one device; k <= len.
    Returns (sids desc-by-key, counts at sids, n_match) as numpy --
    one device sync total."""
    k = int(min(k, mask.shape[0]))
    out = _select(mask, key, counts, k)
    sids, cnts, valid = out[:k], out[k : 2 * k], out[2 * k : 3 * k] > 0
    return sids[valid], cnts[valid], int(out[3 * k])


def select_topk_device_multi(masks, keys, counts, k: int):
    """Top-k across MANY blocks' mask/key/count vectors: concatenated on
    the device, then one selection -> ONE device sync for the whole
    multi-block query. Returns (global_idx desc-by-key, counts at
    winners, total n_match); global_idx indexes the concatenation of the
    (padded) parts."""
    total = int(sum(m.shape[0] for m in masks))
    k = int(min(k, total))
    out = _select(torch.cat(list(masks)), torch.cat(list(keys)), torch.cat(list(counts)), k)
    gids, cnts, valid = out[:k], out[k : 2 * k], out[2 * k : 3 * k] > 0
    return gids[valid], cnts[valid], int(out[3 * k])


def select_topk_host(mask: np.ndarray, key: np.ndarray, counts: np.ndarray, k: int):
    """Numpy twin of select_topk_device (the live head's host engine):
    argpartition + sort, the same descending-key order."""
    n = mask.shape[0]
    n_match = int(np.count_nonzero(mask))
    k = int(min(k, n))
    keyed = np.where(mask, key.astype(np.int64), np.int64(-(2**62)))
    if k < n:
        part = np.argpartition(-keyed, k - 1)[:k] if k > 0 else np.empty(0, np.int64)
    else:
        part = np.arange(n)
    part = part[np.argsort(-keyed[part], kind="stable")]
    sids = part[mask[part]]
    return sids.astype(np.int64), counts[sids], n_match
