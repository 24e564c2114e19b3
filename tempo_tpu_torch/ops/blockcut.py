"""Block-cut kernels (B9): the device steps of a block's finalize.

Port of tempo_tpu/ops/blockcut.py. Three per-row host loops of a cut
become kernels: the dictionary remap of every code column through the
sort permutation (B9a), the bloom's K = 7 bits per trace id (B9b) and
the per-row-group pruning stats (B9c). Each op sends CUDA tensors to its
kernel (csrc/blockcut.cu through kernels.py) and CPU tensors to its
plain PyTorch version below; every output is an integer, so the two
agree exactly. The bloom's hashing runs with its scatter: the whole
function, (words, trace ids, shard_bits) -> words, is one op (on the
host in the JAX package, `bloom_scatter`, which the port keeps as a
yardstick).

The JAX package picks its engine by its backend and an env override
(TEMPO_CUT_ENGINE); the port picks by the device of the tensors, so a
cut on a card always runs these kernels. `CutEngine` is the builder's
numpy-facing side: it uploads, launches and downloads; a cut's code
columns go through it together (`CutEngine.remap_many`: one upload, one
launch, one download), and so do its bloom's words and ids
(`CutEngine.bloom_bits`) and its row groups' start_ms and dur_us
(`CutEngine.rowgroup_minmax`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..block.bloom import _K, WORD_BITS, shard_for_trace_id
from ..util import hashing as H
from ..util.hashing import bloom_hashes


# ---------------------------------------------------------------- B9a
def remap_codes(col: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    """Dictionary-finalize remap of one int32 code column: negatives
    (absent / sentinel codes) pass through, everything else gathers
    through the sort permutation. A code past the table takes its last
    entry (the kernel never reads outside it; a cut makes no such code)."""
    if col.device.type == "cuda":
        return kernels.remap_codes(col, remap)
    return _remap_plain(col, remap)


def _remap_plain(col: torch.Tensor, remap: torch.Tensor) -> torch.Tensor:
    if col.numel() == 0:
        return col.clone()
    idx = col.clamp(0, remap.shape[0] - 1).long()
    return torch.where(col >= 0, remap[idx], col)


def remap_many(codes: torch.Tensor, offs, remap: torch.Tensor) -> torch.Tensor:
    """remap_codes over consecutive segments of one code tensor (segment j
    is codes[offs[j]:offs[j + 1]]): one B9a launch on a card."""
    if codes.device.type == "cuda":
        return kernels.remap_many(codes, offs, remap)
    return _remap_many_plain(codes, offs, remap)


def _remap_many_plain(codes: torch.Tensor, offs, remap: torch.Tensor) -> torch.Tensor:
    """Plain version of remap_many: _remap_plain a segment."""
    offs = [int(o) for o in offs]
    if not offs or offs[0] != 0 or offs[-1] != codes.shape[0] \
            or any(b < a for a, b in zip(offs, offs[1:])):
        raise ValueError(f"remap_many: segment bounds {offs[:4]}... of {codes.shape[0]} codes")
    return torch.cat([codes[:0]] + [_remap_plain(codes[a:b], remap)
                                    for a, b in zip(offs, offs[1:])])


# ---------------------------------------------------------------- B9b
def bloom_scatter(trace_ids: list[bytes], n_shards: int, shard_bits: int):
    """Host control plane: hash every id to (global word index, one-bit
    word) pairs, deduped, as the JAX package's `_bloom_scatter`.
    Returns (word_idx int32, bits uint32, total words)."""
    n_words_per_shard = shard_bits // WORD_BITS
    keys = set()
    for tid in trace_ids:
        base = shard_for_trace_id(tid, n_shards) * shard_bits
        for pos in bloom_hashes(tid, _K, shard_bits):
            keys.add(base + pos)  # global bit index
    bit_idx = np.fromiter(keys, dtype=np.int64, count=len(keys))
    word_idx = (bit_idx // WORD_BITS).astype(np.int32)
    bits = (np.uint32(1) << (bit_idx % WORD_BITS).astype(np.uint32)).astype(np.uint32)
    return word_idx, bits, n_shards * n_words_per_shard


def bloom_bits(words: torch.Tensor, ids: torch.Tensor, shard_bits: int) -> torch.Tensor:
    """Every id's K bloom bits ORed into words IN PLACE (returned):
    words (n_shards, W) uint32 bit patterns in int32 storage, ids (T, 16)
    uint8, shard_bits a power of two. The same bits as ShardedBloom.add and
    the JAX package's bloom_bits_device: shard = FNV-1a 32 % n_shards,
    positions (h1 + i h2) & (shard_bits - 1), flat word (shard shard_bits +
    pos) / 32, dropped past the words. One B9b launch on a card."""
    if words.device.type == "cuda":
        return kernels.bloom_bits(words, ids, shard_bits, _K)
    return _bloom_bits_plain(words, ids, shard_bits)


def _u64(x: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return x - (1 << 64) if x >= 1 << 63 else x


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """A logical right shift of int64 bits (>> on int64 is arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _id_hashes(ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, 16) uint8 ids -> FNV-1a 32 (in [0, 2^32)), FNV-1a 64 and
    splitmix64(FNV-1a 64) | 1, each (T,) int64 (the 64-bit ones as the
    int64 of their bits: products and sums wrap modulo 2^64)."""
    b = ids.to(torch.int64)
    t = b.shape[0]
    h32 = torch.full((t,), H._FNV32_OFFSET, dtype=torch.int64, device=ids.device)
    h1 = torch.full((t,), _u64(H._FNV64_OFFSET), dtype=torch.int64, device=ids.device)
    for j in range(b.shape[1]):
        h32 = ((h32 ^ b[:, j]) * H._FNV32_PRIME) & H._MASK32
        h1 = (h1 ^ b[:, j]) * H._FNV64_PRIME
    z = h1 + _u64(0x9E3779B97F4A7C15)
    z = (z ^ _srl(z, 30)) * _u64(0xBF58476D1CE4E5B9)
    z = (z ^ _srl(z, 27)) * _u64(0x94D049BB133111EB)
    return h32, h1, (z ^ _srl(z, 31)) | 1


def _bloom_bits_plain(words: torch.Tensor, ids: torch.Tensor, shard_bits: int) -> torch.Tensor:
    shard_bits = int(shard_bits)
    if shard_bits < 1 or shard_bits & (shard_bits - 1):
        raise ValueError(f"bloom_bits: shard_bits {shard_bits} is not a power of two")
    if ids.dim() != 2 or ids.shape[1] != 16:
        raise ValueError(f"bloom_bits: ids {tuple(ids.shape)}, expected (T, 16) uint8")
    flat = words.view(-1)  # in place: a non-contiguous words raises here
    h32, h1, h2 = _id_hashes(ids)
    i = torch.arange(_K, dtype=torch.int64, device=ids.device)
    pos = (h1[:, None] + i * h2[:, None]) & (shard_bits - 1)
    bit = ((h32 % words.shape[0]) * shard_bits)[:, None] + pos
    # OR as a sum: each distinct set bit once (distinct bits of a word add
    # without carries); bits past the words drop
    key = torch.unique(bit[bit < flat.shape[0] * WORD_BITS])
    acc = torch.zeros(flat.shape[0], dtype=torch.int64, device=words.device)
    acc.index_add_(0, key // WORD_BITS, torch.ones_like(key) << (key % WORD_BITS))
    v = (flat.to(torch.int64) & 0xFFFFFFFF) | acc
    flat.copy_(torch.where(v >= 2**31, v - 2**32, v))
    return words


# ---------------------------------------------------------------- B9c
def rowgroup_minmax(start_ms: torch.Tensor, dur_us: torch.Tensor, group: int) -> torch.Tensor:
    """(3, G) int32 [min start_ms | max start_ms | max dur_us] of the
    contiguous groups of `group` rows (the last may be partial; every
    group is non-empty). Needs at least one row."""
    if start_ms.device.type == "cuda":
        return kernels.rowgroup_minmax(start_ms, dur_us, group)
    return _rowgroup_plain(start_ms, dur_us, group)


def _rowgroup_plain(start_ms: torch.Tensor, dur_us: torch.Tensor, group: int) -> torch.Tensor:
    n = start_ms.shape[0]
    if n == 0:
        raise ValueError("rowgroup_minmax: no rows")
    n_groups = -(-n // group)
    gid = torch.arange(n, device=start_ms.device) // group
    lo = torch.full((n_groups,), 2**31 - 1, dtype=torch.int32, device=start_ms.device)
    hi = torch.full((n_groups,), -(2**31), dtype=torch.int32, device=start_ms.device)
    du = hi.clone()
    lo.scatter_reduce_(0, gid, start_ms, "amin")
    hi.scatter_reduce_(0, gid, start_ms, "amax")
    du.scatter_reduce_(0, gid, dur_us, "amax")
    return torch.stack([lo, hi, du])


# ------------------------------------------------------ builder side
class CutEngine:
    """A cut's device steps on one device, numpy in and numpy out: the
    builder uploads each column, the op runs its kernel (card) or plain
    version (CPU), and the result comes back as int32 / uint32 numpy."""

    def __init__(self, device):
        self.device = torch.device(device)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def table(self, remap: np.ndarray) -> torch.Tensor:
        """The remap table on the device, uploaded once per cut."""
        return self._t(np.asarray(remap, dtype=np.int32))

    def remap(self, col, table: torch.Tensor) -> np.ndarray:
        """One code column: an upload, a launch and a download."""
        col = np.asarray(col, dtype=np.int32)
        return remap_codes(self._t(col), table).cpu().numpy()

    def remap_many(self, cols: list, table: torch.Tensor) -> list[np.ndarray]:
        """Every code column of a cut (lists or arrays of int codes) through
        one table in one round trip: the columns end to end in one host
        buffer (pinned on a card), one upload, one B9a launch over their
        segments, one download into a pinned buffer and one synchronize.
        Returns one int32 array a column (views of that buffer), equal to
        remap's column by column."""
        offs = np.zeros(len(cols) + 1, np.int64)
        np.cumsum([len(c) for c in cols], out=offs[1:])
        n = int(offs[-1])
        card = self.device.type == "cuda"
        host = torch.empty(n, dtype=torch.int32, pin_memory=card)
        h = host.numpy()
        for c, a, b in zip(cols, offs[:-1], offs[1:]):
            h[a:b] = c
        out = remap_many(host.to(self.device, non_blocking=True), offs.tolist(), table)
        if card:
            back = torch.empty(n, dtype=torch.int32, pin_memory=True)
            back.copy_(out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            out = back
        o = out.numpy()
        return [o[a:b] for a, b in zip(offs[:-1], offs[1:])]

    def bloom_bits(self, words: np.ndarray, ids: np.ndarray, shard_bits: int) -> np.ndarray:
        """Every trace id's K bits set in a copy of the (n_shards, W)
        uint32 words; ids a (T, 16) uint8 array (a block's trace.id rows).
        On a card: the words and the ids in one pinned buffer, one upload
        (the words land in the output), one B9b launch, one pinned
        download and one synchronize; no hashing on the host."""
        ids = np.ascontiguousarray(ids, dtype=np.uint8)
        if ids.ndim != 2 or ids.shape[1] != 16:
            raise ValueError(f"bloom_bits: ids {ids.shape}, expected (T, 16) uint8")
        words = np.ascontiguousarray(words, dtype=np.uint32)
        if self.device.type != "cuda":
            out = bloom_bits(torch.from_numpy(words.view(np.int32).copy()),
                             torch.from_numpy(ids.copy()), shard_bits)
            return out.numpy().view(np.uint32)
        wb = words.nbytes
        ib = -(-wb // 16) * 16  # the ids 16-byte aligned after the words
        host = torch.empty(ib + ids.nbytes, dtype=torch.uint8, pin_memory=True)
        h = host.numpy()
        h[:wb] = words.view(np.uint8).reshape(-1)
        h[ib:] = ids.reshape(-1)
        buf = host.to(self.device, non_blocking=True)
        w = buf[:wb].view(torch.int32).view(words.shape)
        bloom_bits(w, buf[ib:].view(-1, 16), shard_bits)
        back = torch.empty(wb, dtype=torch.uint8, pin_memory=True)
        back.copy_(buf[:wb], non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return back.numpy().view(np.uint32).reshape(words.shape)

    def rowgroup_minmax(self, start_ms: np.ndarray, dur_us: np.ndarray,
                        group: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(start_ms min, start_ms max, dur_us max) of every row group,
        three int32 arrays. On a card: start_ms and dur_us end to end in
        one pinned buffer (dur_us from a 16-byte boundary, so both take
        the kernel's 16-byte loads), one upload, one B9c launch, one pinned
        download of the (3, G) stats and one synchronize."""
        start_ms = np.asarray(start_ms, dtype=np.int32)
        dur_us = np.asarray(dur_us, dtype=np.int32)
        n = start_ms.shape[0]
        if self.device.type != "cuda":
            out = rowgroup_minmax(torch.from_numpy(np.ascontiguousarray(start_ms)),
                                  torch.from_numpy(np.ascontiguousarray(dur_us)), group).numpy()
            return out[0], out[1], out[2]
        if dur_us.shape != (n,):
            raise ValueError(f"rowgroup_minmax: {dur_us.shape} durations for {n} starts")
        at = -(-n // 4) * 4  # dur_us 16-byte aligned after start_ms
        host = torch.empty(at + n, dtype=torch.int32, pin_memory=True)
        h = host.numpy()
        h[:n] = start_ms
        h[at:] = dur_us
        buf = host.to(self.device, non_blocking=True)
        out = rowgroup_minmax(buf[:n], buf[at:], group)
        back = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        back.copy_(out, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        o = back.numpy()
        return o[0], o[1], o[2]
