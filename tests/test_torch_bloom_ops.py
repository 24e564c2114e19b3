"""The bloom kernels' plain versions (B10a union, B10b batch test) on the
CPU against the JAX package's jitted programs
(tempo_tpu/ops/bloom_ops.py, run on the CPU as tests/test_ops.py:160
runs them), plus the host bloom the port keeps (test, add_array).
Inputs come from numpy with a seed; every output is a word or a bool,
so every comparison is exact."""

import numpy as np
import pytest
import torch

from tempo_tpu.block.bloom import ShardedBloom as RBloom
from tempo_tpu.ops import bloom_ops as RO
from tempo_tpu_torch.block.bloom import ShardedBloom, union_shards
from tempo_tpu_torch.ops import bloom_ops as O


def _ids(rng, n, lead=None):
    out = []
    for _ in range(n):
        b = rng.integers(0, 256, size=16, dtype=np.uint8)
        if lead is not None:
            b[0] = lead
        out.append(b.tobytes())
    return out


def _pair(n_shards, bits, ids):
    ref, port = RBloom(n_shards, bits), ShardedBloom(n_shards, bits)
    ref.add_many(ids)
    port.add_many(ids)
    np.testing.assert_array_equal(port.words, ref.words)
    return ref, port


GEOMETRIES = [(1, 1024, 2), (4, 1 << 13, 2), (4, 1 << 13, 4), (12, 1 << 20, 3), (1, 1 << 19, 4)]


@pytest.mark.parametrize("n_shards,bits,k", GEOMETRIES)
def test_union_matches_reference(n_shards, bits, k):
    rng = np.random.default_rng(n_shards * k)
    ids = [_ids(rng, 40, lead=j) for j in range(k)]
    pairs = [_pair(n_shards, bits, x) for x in ids]
    want = RO.union_blooms([r for r, _ in pairs])
    got = O.union_blooms([p for _, p in pairs], "cpu")
    assert (got.n_shards, got.shard_bits) == (want.n_shards, want.shard_bits)
    assert got.words.dtype == np.uint32
    np.testing.assert_array_equal(got.words, np.asarray(want.words))
    host = pairs[0][1].words
    for _, p in pairs[1:]:
        host = union_shards(host, p.words)
    np.testing.assert_array_equal(got.words, host)
    assert all(got.test(t) for x in ids for t in x)


def test_union_of_random_full_words_matches_reference():
    rng = np.random.default_rng(11)
    blooms = []
    for _ in range(4):
        b = ShardedBloom(12, 1 << 20)
        b.words = rng.integers(0, 2**32, size=b.words.shape, dtype=np.uint64).astype(np.uint32)
        blooms.append(b)
    refs = []
    for b in blooms:
        r = RBloom(12, 1 << 20)
        r.words = b.words.copy()
        refs.append(r)
    np.testing.assert_array_equal(O.union_blooms(blooms, "cpu").words,
                                  np.asarray(RO.union_blooms(refs).words))


@pytest.mark.parametrize("other", [(2, 1 << 13), (4, 1 << 14)])
def test_union_geometry_mismatch_raises_as_reference(other):
    a_ref, a = _pair(4, 1 << 13, [b"\x01" * 16])
    b_ref, b = _pair(*other, [b"\x02" * 16])
    with pytest.raises(ValueError):
        RO.union_blooms([a_ref, b_ref])
    with pytest.raises(ValueError):
        O.union_blooms([a, b], "cpu")


@pytest.mark.parametrize("n_shards,bits", [(4, 1 << 13), (1, 1024), (12, 1 << 20)])
@pytest.mark.parametrize("which", ["present", "absent", "mixed"])
def test_batch_test_matches_reference(n_shards, bits, which):
    rng = np.random.default_rng(n_shards + len(which))
    present = _ids(rng, 100, lead=1)
    ref, port = _pair(n_shards, bits, present)
    absent = _ids(rng, 100, lead=9)
    q = {"present": present, "absent": absent,
         "mixed": [t for pair in zip(present, absent) for t in pair]}[which]
    got = O.batch_test(port.words, port.shard_bits, port.n_shards, q, "cpu")
    want = np.asarray(RO.batch_test(ref.words, ref.shard_bits, ref.n_shards, q))
    assert got.dtype == np.bool_ and got.shape == (len(q),)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [port.test(t) for t in q])
    if which == "present":
        assert got.all()


def test_batch_test_of_no_ids():
    b = ShardedBloom(2, 1024)
    assert O.batch_test(b.words, b.shard_bits, b.n_shards, [], "cpu").shape == (0,)
    assert RO.batch_test(b.words, b.shard_bits, b.n_shards, []).shape == (0,)


def test_bits_set_clamps_indices_and_rejects_bits_past_the_word():
    words = torch.tensor([[0b101, -1], [0, 1]], dtype=torch.int32)
    idx = torch.tensor([[[0, 0], [0, 0]], [[0, 0], [9, 9]], [[0, 5], [1, 1]], [[0, 0], [0, 0]]],
                       dtype=torch.int32)
    bit = torch.tensor([[0, 2], [0, 0], [31, 0], [0, 32]], dtype=torch.int32)
    assert O.bits_set(words, idx, bit).tolist() == [True, True, True, False]


def test_add_array_and_test_shard_match_reference():
    rng = np.random.default_rng(5)
    arr = rng.integers(0, 256, size=(300, 16), dtype=np.uint8)
    ref, port = RBloom(3, 1 << 12), ShardedBloom(3, 1 << 12)
    ref.add_array(arr)
    port.add_array(arr)
    np.testing.assert_array_equal(port.words, ref.words)
    for t in _ids(rng, 50) + [arr[i].tobytes() for i in range(0, 300, 7)]:
        assert port.test(t) == ref.test(t)
