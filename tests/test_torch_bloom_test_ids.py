"""B10b's id route: many trace ids tested against a block's full bloom,
the ids hashed where the test runs (on the card, csrc/bloom.cu with the
hash B9b shares; on the CPU, the plain id route in numpy uint64).

On the CPU the plain id route is held against the JAX package's
`batch_test` (host positions, then its jitted `_test_kernel`) and
`ShardedBloom.test`, over 1, 4 and 12 shards, shard_bits that are and
are not powers of two, ids of 1-16 bytes, present, absent and mixed
ids, and none. The `cuda` cases (skipped where no card exists) hold the
kernel against the plain id route at Q = 1, 64 and 32,768, from numpy
words and from words already on the card, and B9b's bits through the
shared hash. Every output is a bool or a word, so every comparison is
exact."""

import numpy as np
import pytest
import torch

from tempo_tpu.block.bloom import ShardedBloom as RBloom
from tempo_tpu.ops import bloom_ops as RO
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.ops import bloom_ops as O
from tempo_tpu_torch.util.hashing import bloom_hashes, fnv1a_32


def _ids(rng, n, lo=1, hi=16, lead=None):
    out = []
    for _ in range(n):
        b = rng.integers(0, 256, size=int(rng.integers(lo, hi + 1)), dtype=np.uint8)
        if lead is not None:
            b[0] = lead
        out.append(b.tobytes())
    return out


def _words(n_shards, bits, ids):
    """(n_shards, ceil(bits / 32)) uint32 words with every id's 7 bits set
    for any shard_bits (ShardedBloom rounds shard_bits to a power of two)."""
    w = np.zeros((n_shards, -(-bits // 32)), dtype=np.uint32)
    for tid in ids:
        s = fnv1a_32(tid) % n_shards
        for pos in bloom_hashes(tid, 7, bits):
            w[s, pos // 32] |= np.uint32(1 << (pos % 32))
    return w


def _query(rng, which, present):
    absent = _ids(rng, 80, lead=0xEE)
    return {"present": present, "absent": absent,
            "mixed": [t for pair in zip(present, absent) for t in pair]}[which]


@pytest.mark.parametrize("which", ["present", "absent", "mixed"])
@pytest.mark.parametrize("pow2", [True, False], ids=["pow2", "odd_bits"])
@pytest.mark.parametrize("n_shards", [1, 4, 12])
def test_id_route_matches_reference(n_shards, pow2, which):
    rng = np.random.default_rng(n_shards * 7 + pow2 * 3 + len(which))
    present = _ids(rng, 80, lead=0x11)
    if pow2:
        ref, port = RBloom(n_shards, 1 << 13), ShardedBloom(n_shards, 1 << 13)
        ref.add_many(present)
        port.add_many(present)
        np.testing.assert_array_equal(port.words, ref.words)
        words, bits = port.words, port.shard_bits
    else:
        bits = 1000 if n_shards < 12 else 12_345
        words = _words(n_shards, bits, present)
    q = _query(rng, which, present)
    got = O.batch_test(words, bits, n_shards, q, "cpu")
    want = np.asarray(RO.batch_test(words, bits, n_shards, q))
    assert got.dtype == np.bool_ and got.shape == (len(q),)
    np.testing.assert_array_equal(got, want)
    if pow2:
        np.testing.assert_array_equal(got, [port.test(t) for t in q])
        np.testing.assert_array_equal(got, [ref.test(t) for t in q])
    if which == "present":
        assert got.all()
    if which == "absent":
        assert not got.all()


def test_every_id_length_hashes_over_its_own_bytes():
    """Ids of 0-16 bytes, each present, a zero-padded twin of each absent:
    a short id is hashed over its own length, never over its slot."""
    rng = np.random.default_rng(3)
    ids = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes() for n in range(17)]
    port, ref = ShardedBloom(3, 1 << 12), RBloom(3, 1 << 12)
    port.add_many(ids)
    ref.add_many(ids)
    padded = [t.ljust(16, b"\0") for t in ids[1:15]]
    q = ids + padded
    got = O.batch_test(port.words, port.shard_bits, port.n_shards, q, "cpu")
    np.testing.assert_array_equal(got, np.asarray(RO.batch_test(ref.words, ref.shard_bits,
                                                                 ref.n_shards, q)))
    np.testing.assert_array_equal(got, [port.test(t) for t in q])
    assert got[:17].all() and not got[17:].all()


def test_no_ids():
    b = ShardedBloom(2, 1024)
    assert O.batch_test(b.words, b.shard_bits, b.n_shards, [], "cpu").shape == (0,)
    assert RO.batch_test(b.words, b.shard_bits, b.n_shards, []).shape == (0,)
    empty = O.test_ids(torch.from_numpy(b.words.view(np.int32)),
                       torch.zeros((0, 16), dtype=torch.uint8), torch.zeros(0, dtype=torch.uint8),
                       2, 1024)
    assert empty.shape == (0,) and empty.dtype == torch.bool


def test_ids_past_16_bytes_raise_value_error():
    b = ShardedBloom(2, 1024)
    with pytest.raises(ValueError):
        O.batch_test(b.words, b.shard_bits, b.n_shards, [b"\x01" * 16, b"\x02" * 17], "cpu")
    with pytest.raises(ValueError):
        O.test_ids(torch.from_numpy(b.words.view(np.int32)),
                   torch.zeros((1, 16), dtype=torch.uint8),
                   torch.full((1,), 17, dtype=torch.uint8), 2, 1024)


# ----------------------------------------------------------------- cuda
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("on_card", [False, True], ids=["numpy_words", "cuda_words"])
@pytest.mark.parametrize("q", [1, 64, 32_768])
def test_kernel_matches_plain_id_route(cuda, q, on_card):
    """One B10b launch, bit for bit against the plain id route: present
    ids of 1-16 bytes and absent ones, a power-of-two geometry (12 x 2^20,
    the mask) and an odd one (the 64-bit %); an id past 16 bytes raises
    KernelError."""
    from tempo_tpu_torch import kernels

    rng = np.random.default_rng(q)
    ids = _ids(rng, q)
    for n_shards, bits in ((12, 1 << 20), (5, 12_345)):
        if bits & (bits - 1):
            words = _words(n_shards, bits, ids[::2])
        else:
            b = ShardedBloom(n_shards, bits)
            b.add_many(ids[::2])
            words = b.words
        want = O.batch_test(words, bits, n_shards, ids, "cpu")
        arg = torch.from_numpy(words.view(np.int32)).to(cuda) if on_card else words
        kernels.reset_counts()
        got = O.batch_test(arg, bits, n_shards, ids, cuda)
        assert kernels.LAUNCHES["bloom_test"] == 1
        assert kernels.grid_launches()["bloom_test"] == 1
        np.testing.assert_array_equal(got, want)
        assert got[::2].all()
    with pytest.raises(kernels.KernelError):
        O.batch_test(words, bits, n_shards, ids[:1] + [b"\x03" * 17], cuda)


@pytest.mark.cuda
def test_b9b_bits_unchanged_through_the_shared_hash(cuda):
    """B9b (tt_bloom_bits) now hashes through bloomhash.cuh: its words
    equal ShardedBloom.add_array's, and every id tests present through
    B10b on those words."""
    from tempo_tpu_torch.ops.blockcut import CutEngine

    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, size=(32_768, 16), dtype=np.uint8)
    host = ShardedBloom(1, 1 << 19)
    host.add_array(arr)
    got = CutEngine(cuda).bloom_bits(np.zeros_like(host.words), arr, host.shard_bits)
    np.testing.assert_array_equal(got, host.words)
    ids = [arr[i].tobytes() for i in range(arr.shape[0])]
    assert O.batch_test(got, host.shard_bits, 1, ids, cuda).all()
