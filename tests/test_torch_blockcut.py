"""The block cut's device steps B9a (remap) and B9b (the bloom, ids ->
words): the port's plain versions on the CPU against the JAX package's jitted
programs (tempo_tpu/ops/blockcut.py, run on the CPU as
tests/test_ingest.py:266 runs them) and their numpy twins. B9c is in
test_torch_rowgroups.py. Inputs come from numpy with a seed; every
output is an integer, so every comparison is exact."""

import numpy as np
import pytest
import torch

from tempo_tpu.block.bloom import ShardedBloom as RBloom
from tempo_tpu.ops import blockcut as RB
from tempo_tpu.util import hashing as RH
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.ops import blockcut as B

INT_MIN, INT_MAX = -(2**31), 2**31 - 1
CPU = B.CutEngine("cpu")


def _ids(rng, n):
    return [rng.integers(0, 256, size=16, dtype=np.uint8).tobytes() for _ in range(n)]


# ---------------------------------------------------------------- B9a
def _remap_case(case):
    rng = np.random.default_rng(len(case))
    r = {"dict50": 50, "corpus": 5677, "one": 1}.get(case.split("_")[0], 50)
    remap = rng.permutation(r).astype(np.int32)
    if case.startswith("dict50_n"):
        n = int(case.split("_n")[1])
        col = rng.integers(-1, 50, size=n).astype(np.int32)
    elif case == "empty":
        col = np.zeros(0, np.int32)
    elif case == "all_negative":
        col = np.full(300, -1, np.int32)
        col[::3] = INT_MIN
    elif case == "top_code":
        col = np.full(64, r - 1, np.int32)
        col[::2] = 0
    elif case == "corpus_span_names":
        col = rng.integers(0, r, size=40_000).astype(np.int32)
        col[::97] = -1
    else:  # one entry: every code is 0 or negative
        col = rng.integers(-1, 1, size=100).astype(np.int32)
    return col, remap


REMAP_CASES = ["dict50_n1", "dict50_n7", "dict50_n300", "empty", "all_negative", "top_code",
               "corpus_span_names", "one_entry"]


@pytest.mark.parametrize("case", REMAP_CASES)
def test_remap_matches_reference(case):
    col, remap = _remap_case(case)
    got = CPU.remap(col, CPU.table(remap))
    assert got.dtype == np.int32 and got.shape == col.shape
    np.testing.assert_array_equal(got, RB.remap_codes_host(col, remap))
    if col.size:  # the reference's device program pads an empty column to a bucket
        np.testing.assert_array_equal(got, np.asarray(RB.remap_codes_device(col, remap)))


def test_remap_tensor_op_passes_negatives_and_clamps_inside_the_table():
    remap = torch.tensor([7, 3, 5], dtype=torch.int32)
    col = torch.tensor([2, -1, 0, INT_MIN, 1], dtype=torch.int32)
    assert B.remap_codes(col, remap).tolist() == [5, -1, 7, INT_MIN, 3]
    # a code past the table takes its last entry and never reads outside it
    assert B.remap_codes(torch.tensor([3, 99], dtype=torch.int32), remap).tolist() == [5, 5]


# ---------------------------------------------------------------- B9b
def _bloom_geometry(case, n_ids):
    if case.startswith("twelve_shards"):
        return RBloom.for_estimated_items(1_000_000), ShardedBloom.for_estimated_items(1_000_000)
    if case == "twelve_at_1024":
        return RBloom(12, 1024), ShardedBloom(12, 1024)
    return RBloom.for_estimated_items(max(n_ids, 1)), ShardedBloom.for_estimated_items(max(n_ids, 1))


def _case_ids(case, rng, n_ids):
    tids = _ids(rng, n_ids)
    if case == "all_zero_bytes":  # the id of 16 zero bytes, twice, among others
        tids[:2] = [b"\x00" * 16] * 2
    elif case == "all_ff_bytes":
        tids[-2:] = [b"\xff" * 16] * 2
    return tids


@pytest.mark.parametrize("case,n_ids", [("default", 64), ("default", 1), ("default", 3000),
                                        ("twelve_shards", 2000), ("preset_words", 200),
                                        ("all_zero_bytes", 9), ("all_ff_bytes", 9),
                                        ("twelve_at_1024", 700), ("twelve_shards_preset", 500),
                                        ("one_id_preset", 1)])
def test_bloom_bits_match_reference(case, n_ids):
    """The whole function, ids -> words (CutEngine on the CPU: the plain
    version's hashing and OR), against the reference's jitted program,
    its numpy twin and ShardedBloom.add."""
    rng = np.random.default_rng(n_ids)
    tids = _case_ids(case, rng, n_ids)
    ref, port = _bloom_geometry(case, n_ids)
    assert (ref.n_shards, ref.shard_bits) == (port.n_shards, port.shard_bits)
    if case.startswith("twelve"):
        assert port.n_shards == 12
    words = np.zeros_like(ref.words)
    preset = "preset" in case
    if preset:  # the OR keeps bits already set
        words = rng.integers(0, 2**32, size=words.shape, dtype=np.uint64).astype(np.uint32)
    rows = np.frombuffer(b"".join(tids), np.uint8).reshape(-1, 16)  # as the builder has them
    got = CPU.bloom_bits(words.copy(), rows, port.shard_bits)
    assert got.dtype == np.uint32 and got.shape == words.shape
    np.testing.assert_array_equal(got, np.asarray(RB.bloom_bits_device(words.copy(), tids,
                                                                       ref.shard_bits)))
    np.testing.assert_array_equal(got, RB.bloom_bits_host(words, tids, ref.shard_bits))
    if not preset:
        ref.add_many(tids)
        np.testing.assert_array_equal(got, ref.words)


@pytest.mark.parametrize("shard_bits", [1, 1024, 1 << 19])
def test_plain_hashes_match_reference(shard_bits):
    """The plain version's int64 hashing (logical shifts, products modulo
    2^64, FNV-1a 32 unsigned) against the reference's hashing, 1,000
    seeded ids (and the all-0x00 and all-0xFF ids)."""
    ids = np.random.default_rng(shard_bits).integers(0, 256, (1000, 16), dtype=np.uint8)
    ids[0], ids[1] = 0, 255
    h32, h1, h2 = B._id_hashes(torch.from_numpy(ids))
    m64 = (1 << 64) - 1
    for i, row in enumerate(ids):
        t = row.tobytes()
        assert int(h32[i]) == RH.fnv1a_32(t)
        assert int(h1[i]) & m64 == RH.fnv1a_64(t)
        assert int(h2[i]) & m64 == RH.splitmix64(RH.fnv1a_64(t)) | 1
        pos = [(int(h1[i]) + k * int(h2[i])) & (shard_bits - 1) for k in range(7)]
        assert pos == RH.bloom_hashes(t, 7, shard_bits)


def test_bloom_scatter_matches_reference_pairs():
    tids = _ids(np.random.default_rng(3), 500)
    got = B.bloom_scatter(tids, 3, 1 << 14)
    want = RB._bloom_scatter(tids, 3, 1 << 14)
    order_g, order_w = np.argsort(got[0] * 32 + np.log2(got[1]).astype(np.int64)), \
        np.argsort(want[0] * 32 + np.log2(want[1]).astype(np.int64))
    np.testing.assert_array_equal(got[0][order_g], want[0][order_w])
    np.testing.assert_array_equal(got[1][order_g], want[1][order_w])
    assert got[2] == want[2]


@pytest.mark.parametrize("shard_bits", [0, 3, 1000, 1536])
def test_bloom_bits_refuses_shard_bits_not_a_power_of_two(shard_bits):
    words = torch.zeros((2, 64), dtype=torch.int32)
    ids = torch.zeros((3, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="power of two"):
        B.bloom_bits(words, ids, shard_bits)
    assert not words.any()


def test_bloom_bits_refuses_ids_not_16_bytes():
    with pytest.raises(ValueError, match="16"):
        CPU.bloom_bits(np.zeros((1, 32), np.uint32), np.zeros((2, 15), np.uint8), 1024)
    with pytest.raises(ValueError, match="16"):
        B.bloom_bits(torch.zeros((1, 32), dtype=torch.int32), torch.zeros((2, 8), dtype=torch.uint8),
                     1024)


def test_bloom_bits_op_works_in_place_and_drops_words_past_the_end():
    """The op ORs into its words and returns them; a flat word past a
    short last shard is dropped, as the reference's scatter drops it."""
    tids = _ids(np.random.default_rng(4), 300)
    ids = torch.from_numpy(np.frombuffer(b"".join(tids), np.uint8).reshape(-1, 16).copy())
    full = torch.zeros((1, 1024 // 32), dtype=torch.int32)
    assert B.bloom_bits(full, ids, 1024) is full and full.any()
    short = torch.zeros((1, 10), dtype=torch.int32)  # words 10-31 of the shard are missing
    B.bloom_bits(short, ids, 1024)
    assert torch.equal(short, full[:, :10])
