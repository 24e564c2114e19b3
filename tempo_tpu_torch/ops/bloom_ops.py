"""Bloom filter kernels (B10): compaction union and batch membership test.

Port of tempo_tpu/ops/bloom_ops.py. When compaction inputs share bloom
geometry, the output block's filter is one elementwise OR over the
stacked (n_blocks, n_shards, words) bits (B10a) instead of re-inserting
every id. B10b tests many ids against one block's full bloom; nothing
calls it on a path of either package (the JAX package's own tests do),
and the port keeps it with its kernel all the same. The JAX package
hashes the ids on the host and gathers their bits on the device
(`_test_kernel`); here the whole function, ids to bools, is one op: the
ids travel as zero-padded 16-byte slots with a length each, and B10b
hashes them on the card (csrc/bloom.cu, the hash shared with B9b). CUDA
tensors go to the kernels, CPU tensors to the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..block.bloom import _K, WORD_BITS, ShardedBloom, shard_for_trace_id
from ..util import hashing as H
from ..util.hashing import bloom_hashes
from .device import resolve_device


def union(stacked: torch.Tensor) -> torch.Tensor:
    """(K, S, W) uint32 bit patterns (int32 storage) -> (S, W) OR."""
    if stacked.device.type == "cuda":
        return kernels.bloom_union(stacked)
    return _union_plain(stacked)


def _union_plain(stacked: torch.Tensor) -> torch.Tensor:
    out = stacked[0].clone()
    for j in range(1, stacked.shape[0]):
        out |= stacked[j]
    return out


def union_blooms(blooms: list[ShardedBloom], device) -> ShardedBloom:
    """Union of same-geometry blooms on `device`; ValueError on a
    geometry mismatch (the caller rebuilds instead)."""
    first = blooms[0]
    for b in blooms[1:]:
        if b.n_shards != first.n_shards or b.shard_bits != first.shard_bits:
            raise ValueError("bloom geometry mismatch")
    return union_planes([b.words for b in blooms], first.n_shards, first.shard_bits, device)


def union_planes(blooms, n_shards: int, shard_bits: int, device) -> ShardedBloom:
    """The OR of K blooms given shard by shard (blooms[k][s] the (W,)
    uint32 words of bloom k's shard s; a (S, W) array serves as well),
    on `device`. Each shard is written once, straight into one (K, S, W)
    host buffer; on a card that buffer is pinned: one upload, one B10a
    launch, one pinned download and one synchronize."""
    device = torch.device(device)
    card = device.type == "cuda"
    sb = ShardedBloom(n_shards, shard_bits)
    host = torch.empty((len(blooms),) + sb.words.shape, dtype=torch.int32, pin_memory=card)
    h = host.numpy().view(np.uint32)
    for k, shards in enumerate(blooms):
        if len(shards) != n_shards:
            raise ValueError(f"bloom {k}: {len(shards)} shards, expected {n_shards}")
        for i, words in enumerate(shards):
            h[k, i] = words
    out = union(host.to(device, non_blocking=True))
    if card:
        back = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
        back.copy_(out, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
        out = back
    sb.words = out.numpy().view(np.uint32)
    return sb


def bits_set(words: torch.Tensor, word_idx: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    """The positions form of the JAX package's `_test_kernel`: words (S,
    W), word_idx (Q, K, 2) [shard, word], bit_idx (Q, K) -> (Q,) bool, all
    K bits set; indexes clamp as XLA's gather clamps them, a bit past the
    word tests 0. CPU tensors only: on a card the test hashes the ids
    itself (test_ids, B10b), so host positions never reach it."""
    if words.device.type == "cuda":
        raise kernels.KernelError("bits_set: the positions form has no kernel; "
                                  "test ids with test_ids / batch_test")
    return _test_plain(words, word_idx, bit_idx)


def _test_plain(words: torch.Tensor, word_idx: torch.Tensor, bit_idx: torch.Tensor) -> torch.Tensor:
    s = word_idx[..., 0].clamp(0, words.shape[0] - 1).long()
    w = word_idx[..., 1].clamp(0, words.shape[1] - 1).long()
    gathered = words[s, w].long() & 0xFFFFFFFF
    ok = (bit_idx >= 0) & (bit_idx < WORD_BITS)
    bit = (gathered >> bit_idx.clamp(0, WORD_BITS - 1).long()) & 1
    return (ok & (bit == 1)).all(dim=-1)


def positions(trace_ids: list[bytes], n_shards: int, shard_bits: int):
    """Host side of the JAX package's test: every id's K (shard, word)
    pairs and bit indexes, (Q, K, 2) and (Q, K) int32 (the yardstick the
    id route is held against; no path of the port calls it)."""
    q = len(trace_ids)
    word_idx = np.zeros((q, _K, 2), dtype=np.int32)
    bit_idx = np.zeros((q, _K), dtype=np.int32)
    for i, tid in enumerate(trace_ids):
        shard = shard_for_trace_id(tid, n_shards)
        for j, pos in enumerate(bloom_hashes(tid, _K, shard_bits)):
            word_idx[i, j] = (shard, pos // WORD_BITS)
            bit_idx[i, j] = pos % WORD_BITS
    return word_idx, bit_idx


ID_SLOT = 16  # bytes an id slot holds: the longest trace id OTLP allows


def pack_ids(trace_ids: list[bytes], ids: np.ndarray, lens: np.ndarray, err=ValueError) -> None:
    """Write trace ids into (Q, 16) uint8 zero-padded slots and their
    (Q,) uint8 lengths (views of a pinned buffer on the card route). An id
    longer than a slot raises `err`."""
    q = len(trace_ids)
    n = np.fromiter(map(len, trace_ids), dtype=np.int64, count=q)
    if q and int(n.max()) > ID_SLOT:
        raise err(f"trace id of {int(n.max())} bytes: at most {ID_SLOT} are hashed")
    if q and int(n.min()) == ID_SLOT:
        flat = b"".join(trace_ids)
    else:
        flat = b"".join(bytes(t).ljust(ID_SLOT, b"\0") for t in trace_ids)
    ids[...] = np.frombuffer(flat, dtype=np.uint8).reshape(q, ID_SLOT)
    lens[...] = n


def test_ids(words: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor, n_shards: int,
             shard_bits: int) -> torch.Tensor:
    """(Q,) bool: each id's K bits set in words (S, W) int32. ids (Q, 16)
    uint8 zero-padded slots, lens (Q,) uint8 their lengths; an id hashes
    over its own bytes as util/hashing.bloom_hashes does, for any
    shard_bits. One B10b launch on a card."""
    if words.device.type == "cuda":
        return kernels.bloom_test(words, ids, lens, n_shards, shard_bits, _K)
    return _test_ids_plain(words, ids, lens, n_shards, shard_bits)


def _id_hashes_np(ids: np.ndarray, lens: np.ndarray):
    """(Q, 16) uint8 slots and (Q,) lengths -> FNV-1a 32 (uint32), FNV-1a
    64 and splitmix64(FNV-1a 64) | 1 (uint64), wrapping as the card's
    integer arithmetic wraps."""
    q = ids.shape[0]
    h32 = np.full(q, H._FNV32_OFFSET, dtype=np.uint32)
    h1 = np.full(q, H._FNV64_OFFSET, dtype=np.uint64)
    p32, p64 = np.uint32(H._FNV32_PRIME), np.uint64(H._FNV64_PRIME)
    with np.errstate(over="ignore"):
        for j in range(ids.shape[1]):
            live = lens > j
            b = ids[:, j]
            h32 = np.where(live, (h32 ^ b.astype(np.uint32)) * p32, h32)
            h1 = np.where(live, (h1 ^ b.astype(np.uint64)) * p64, h1)
        z = h1 + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return h32, h1, (z ^ (z >> np.uint64(31))) | np.uint64(1)


def _test_ids_plain(words: torch.Tensor, ids: torch.Tensor, lens: torch.Tensor, n_shards: int,
                    shard_bits: int) -> torch.Tensor:
    """Plain version of the id route, in numpy uint64 (CPU tensors)."""
    w = words.numpy().view(np.uint32)
    if w.ndim != 2 or 0 in w.shape:
        raise ValueError("test_ids: non-empty (S, W) words expected")
    idn, ln = ids.numpy(), lens.numpy()
    if idn.ndim != 2 or idn.shape[1] != ID_SLOT or ln.shape != (idn.shape[0],):
        raise ValueError(f"test_ids: ids {idn.shape} and lens {ln.shape}")
    if ln.size and int(ln.max()) > ID_SLOT:
        raise ValueError(f"test_ids: an id of {int(ln.max())} bytes")
    if int(n_shards) < 1 or int(shard_bits) < 1:
        raise ValueError(f"test_ids: {n_shards} shards of {shard_bits} bits")
    h32, h1, h2 = _id_hashes_np(idn, ln)
    sb = np.uint64(shard_bits)
    with np.errstate(over="ignore"):
        x = h1[:, None] + np.arange(_K, dtype=np.uint64) * h2[:, None]
    pos = x & (sb - np.uint64(1)) if not shard_bits & (shard_bits - 1) else x % sb
    shard = np.minimum(h32 % np.uint32(n_shards), w.shape[0] - 1).astype(np.int64)
    word = np.minimum(pos >> np.uint64(5), np.uint64(w.shape[1] - 1)).astype(np.int64)
    bit = (w[shard[:, None], word] >> (pos & np.uint64(31)).astype(np.uint32)) & np.uint32(1)
    return torch.from_numpy(bit.all(axis=1))


def batch_test(bloom_words, shard_bits: int, n_shards: int, trace_ids: list[bytes],
               device=None) -> np.ndarray:
    """Test many trace ids (at most 16 bytes each) against a block's full
    bloom: (Q,) bool. bloom_words is
    the (n_shards, W) uint32 numpy array, or an (n_shards, W) int32 tensor
    of the same bits already on the device. On a card: the words (unless already there) and the ids end to
    end in one pinned buffer, one upload, one B10b launch, one pinned
    download of Q bytes and one synchronize; no hashing on the host. On
    the CPU (device="cpu") the plain id route. An id past 16 bytes raises
    ValueError on the CPU and KernelError on a card."""
    q = len(trace_ids)
    if not q:
        return np.zeros(0, dtype=bool)
    on_card = isinstance(bloom_words, torch.Tensor) and bloom_words.device.type == "cuda"
    dev = bloom_words.device if on_card else resolve_device(device)
    if dev.type != "cuda":
        ids, lens = np.empty((q, ID_SLOT), np.uint8), np.empty(q, np.uint8)
        pack_ids(trace_ids, ids, lens)
        if isinstance(bloom_words, torch.Tensor):
            words = bloom_words.contiguous()
        else:
            words = torch.from_numpy(np.ascontiguousarray(bloom_words, np.uint32).view(np.int32))
        return _test_ids_plain(words, torch.from_numpy(ids), torch.from_numpy(lens), n_shards,
                               shard_bits).numpy()
    wb = 0
    if not on_card:
        wnp = np.ascontiguousarray(bloom_words, dtype=np.uint32)
        if wnp.ndim != 2:
            raise kernels.KernelError(f"batch_test: words {wnp.shape}, expected (S, W)")
        wb = -(-wnp.nbytes // ID_SLOT) * ID_SLOT  # the ids 16-byte aligned after the words
    host = torch.empty(wb + (ID_SLOT + 1) * q, dtype=torch.uint8, pin_memory=True)
    h = host.numpy()
    at = wb + ID_SLOT * q
    pack_ids(trace_ids, h[wb:at].reshape(q, ID_SLOT), h[at:], err=kernels.KernelError)
    if not on_card:
        h[:wnp.nbytes] = wnp.view(np.uint8).reshape(-1)
    buf = host.to(dev, non_blocking=True)
    words = bloom_words if on_card else buf[:wnp.nbytes].view(torch.int32).view(wnp.shape)
    out = test_ids(words, buf[wb:at].view(q, ID_SLOT), buf[at:], n_shards, shard_bits)
    back = torch.empty(q, dtype=torch.bool, pin_memory=True)
    back.copy_(out, non_blocking=True)
    torch.cuda.current_stream(dev).synchronize()
    return back.numpy()
