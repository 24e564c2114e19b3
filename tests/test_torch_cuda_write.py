"""Kernel-vs-plain tests of the write path's CUDA kernels (B9a-B9c,
B10a, B10b) on the card, and TempoDB's cut and compaction on the card
against TempoDB(device="cpu").

Marked `cuda`; the fixture below skips them where no card exists. Run
on a machine with one H100:

    python -m pytest -m cuda tests/test_torch_*.py

Every output is an integer, a bool or bytes, so every comparison is
exact."""

import numpy as np
import pytest
import torch

from tempo_tpu_torch.backend import MemBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.util.testdata import make_traces
from torch_tile_cases import REMAP_SEGMENTS, remap_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _rand_i32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("n,r", [(0, 5), (1, 1), (5000, 5677), (1 << 20, 5677)])
def test_remap_kernel(cuda, n, r):
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import blockcut as BC

    rng = np.random.default_rng(n + r)
    col = rng.integers(-3, r + 4, size=n).astype(np.int32)  # negatives and codes past the table
    if n:
        col[::7] = r - 1
        col[::11] = -(2**31)
    remap = rng.permutation(r).astype(np.int32)
    c, m = torch.from_numpy(col).to(cuda), torch.from_numpy(remap).to(cuda)
    kernels.reset_counts()
    got = BC.remap_codes(c, m)
    assert kernels.LAUNCHES["remap"] == 1
    assert torch.equal(got.cpu(), BC._remap_plain(c.cpu(), m.cpu()))


@pytest.mark.parametrize("shards,shard_bits,n_ids", [(1, 1 << 19, 32_768), (12, 1 << 20, 5000),
                                                     (12, 1024, 700), (2, 1024, 1),
                                                     (3, 32, 40)])
def test_bloom_bits_kernel(cuda, shards, shard_bits, n_ids):
    """B9b, ids -> words in place, against its plain version: preset
    words (the OR keeps them), the all-0x00 and all-0xFF ids, a shard of
    one word, a short last shard (words past the end dropped); one
    wrapper call and one __global__ a call; and CutEngine.bloom_bits
    (one pinned upload, the launch, one download) equal to the CPU's."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import blockcut as BC

    rng = np.random.default_rng(shards + n_ids)
    ids = rng.integers(0, 256, (n_ids, 16), dtype=np.uint8)
    ids[0], ids[-1] = 0, 255
    for w_len in (shard_bits // 32, max(1, shard_bits // 64)):  # the second: a short shard
        w = torch.from_numpy(_rand_i32(rng, (shards, w_len)) & 0x0F0F0F0F)
        want = BC._bloom_bits_plain(w.clone(), torch.from_numpy(ids), shard_bits)
        wc, ic = w.to(cuda), torch.from_numpy(ids).to(cuda)
        kernels.reset_counts()
        assert BC.bloom_bits(wc, ic, shard_bits) is wc
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bloom_bits"] == kernels.grid_launches()["bloom_bits"] == 1
        assert torch.equal(wc.cpu(), want)
    words = (_rand_i32(rng, (shards, shard_bits // 32)) & 0x0F0F0F0F).view(np.uint32)
    card = BC.CutEngine(cuda).bloom_bits(words, ids, shard_bits)
    assert np.array_equal(card, BC.CutEngine("cpu").bloom_bits(words, ids, shard_bits))


def test_bloom_bits_kernel_refuses(cuda):
    """shard_bits not a power of two, ids not (T, 16) uint8, ids off a
    16-byte boundary: KernelError, nothing launched, the words kept."""
    from tempo_tpu_torch import kernels

    w = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    ids = torch.zeros((5, 16), dtype=torch.uint8, device=cuda)
    kernels.reset_counts()
    for args in ((w, ids, 3), (w, ids, 1536), (w, ids.view(10, 8), 1024), (w, ids[:, :15], 1024),
                 (w, ids.view(-1)[1:65].view(4, 16), 1024), (w, ids.int(), 1024)):
        with pytest.raises(kernels.KernelError):
            kernels.bloom_bits(*args, 7)
    assert kernels.LAUNCHES["bloom_bits"] == 0 and not w.any()


@pytest.mark.parametrize("n,group,c", [(1, 1, 1), (1000, 333, 1), (50_001, 4093, 1),
                                       (16_384, 8192, 2), (24_577, 12_289, 2),
                                       (40_001, 20_001, 4), (1 << 22, 65_536, 4),
                                       (70_000, 65_533, 8), (70_000, 65_536, 8),
                                       (1 << 20, 65_536, 8),
                                       (3 * 65_536 + 1, 65_536, 8)])
def test_rowgroup_kernel(cuda, n, group, c):
    """B9c at every C of rowgroup_plan (1, 2, 4 and 8 CTAs a group; group
    % 4 != 0 at each; a last group of one row), on columns at a
    16-byte boundary, on views at offset 1 (the same phase: 16-byte loads
    from row 3) and on columns of two phases (row by row), against its
    plain version: one wrapper call and one __global__ a call.
    CutEngine.rowgroup_minmax (one pinned round trip) equals the CPU's."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import blockcut as BC

    plan = kernels.rowgroup_plan(n, group)
    assert plan.clusters == c
    rng = np.random.default_rng(n)
    sm = rng.integers(-(2**31), 2**31, size=n + 2, dtype=np.int64).astype(np.int32)
    du = rng.integers(-(2**31), 2**31, size=n + 2, dtype=np.int64).astype(np.int32)
    sm[5::7], du[3::11] = -(2**31), 2**31 - 1
    s, d = torch.from_numpy(sm).to(cuda), torch.from_numpy(du).to(cuda)
    views = {"aligned": (s[:n], d[:n]), "offset 1": (s[1:n + 1], d[1:n + 1]),
             "two phases": (s[1:n + 1], d[2:])}
    for label, (a, b) in views.items():
        kernels.reset_counts()
        got = BC.rowgroup_minmax(a, b, group)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["rowgroup"] == kernels.grid_launches()["rowgroup"] == 1
        assert got.shape == (3, plan.groups)
        assert torch.equal(got.cpu(), BC._rowgroup_plain(a.cpu(), b.cpu(), group)), label
    got = BC.CutEngine(cuda).rowgroup_minmax(sm[:n], du[:n], group)
    for g, w in zip(got, BC.CutEngine("cpu").rowgroup_minmax(sm[:n], du[:n], group)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(4, 12, 32768), (1, 1, 32), (3, 2, 100), (4, 1, 16384),
                                   (9, 3, 7), (10, 1, 33), (17, 2, 1029), (2, 1, 1)])
def test_bloom_union_kernel(cuda, shape):
    """B10a against its plain version and np.bitwise_or.reduce: S x W
    a multiple of 4 (the quad route) and not (word by word), K past the
    8 loads of one chunk, and a view off 16 bytes (word by word); one
    __global__ a call. union_blooms on the card (one pinned round trip)
    equals the CPU's."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block.bloom import ShardedBloom
    from tempo_tpu_torch.ops import bloom_ops as BO

    rng = np.random.default_rng(sum(shape))
    host = _rand_i32(rng, (int(np.prod(shape)) + 1,))
    flat = torch.from_numpy(host).to(cuda)
    for label, x in (("aligned", flat[:-1].view(shape)), ("off 16 bytes", flat[1:].view(shape))):
        want = np.bitwise_or.reduce(x.cpu().numpy(), axis=0)
        kernels.reset_counts()
        got = BO.union(x)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["bloom_union"] == kernels.grid_launches()["bloom_union"] == 1
        assert torch.equal(got.cpu(), BO._union_plain(x.cpu())), label
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=label)
    blooms = []
    for k in range(shape[0]):
        b = ShardedBloom(shape[1], 32 * shape[2])
        if b.words.shape == shape[1:]:
            b.words = _rand_i32(rng, shape[1:]).view(np.uint32)
            blooms.append(b)
    if blooms:
        np.testing.assert_array_equal(BO.union_blooms(blooms, cuda).words,
                                      BO.union_blooms(blooms, "cpu").words)


def test_bloom_test_kernel(cuda):
    """B10b (kernels.bloom_test) on random words against the plain id
    route: ids of 0-16 bytes, a power-of-two and an odd shard_bits, more
    shards asked than the words hold and words narrower than shard_bits
    (both clamp, as XLA's gather clamps); one launch a call."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import bloom_ops as BO

    rng = np.random.default_rng(4)
    q = 500
    lens = rng.integers(0, 17, size=q).astype(np.uint8)
    ids = rng.integers(0, 256, size=(q, 16), dtype=np.uint8)
    ids[np.arange(16)[None, :] >= lens[:, None]] = 0
    words = _rand_i32(rng, (3, 64)) | 0x11111111
    for n_shards, shard_bits in ((3, 2048), (3, 1000), (5, 2048), (3, 1 << 14)):
        args = [torch.from_numpy(a) for a in (words, ids, lens)]
        want = BO._test_ids_plain(*args, n_shards, shard_bits)
        kernels.reset_counts()
        got = BO.test_ids(*[a.to(cuda) for a in args], n_shards, shard_bits)
        assert kernels.grid_launches()["bloom_test"] == 1
        assert torch.equal(got.cpu(), want) and 0 < int(want.sum()) < q
    with pytest.raises(kernels.KernelError):
        BO.bits_set(torch.from_numpy(words).to(cuda), torch.zeros((1, 7, 2), dtype=torch.int32),
                    torch.zeros((1, 7), dtype=torch.int32))


@pytest.mark.parametrize("route", ["plan", "shared", "l2"])
@pytest.mark.parametrize("case", sorted(REMAP_SEGMENTS))
def test_remap_many_kernel(cuda, case, route):
    """B9a over consecutive segments (torch_tile_cases.REMAP_SEGMENTS:
    odd and empty segments, starts off 16-byte boundaries, more segments
    than travel by value, a table at the shared route's limit and past
    it) on each route against _remap_many_plain, one launch; the shared
    route refuses a table past its limit; a view starting off a 16-byte
    boundary takes the code-by-code path."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import blockcut as BC

    lens, r = REMAP_SEGMENTS[case]
    codes, offs, table = remap_case(len(lens) + r, lens, r)
    c, t = torch.from_numpy(codes).to(cuda), torch.from_numpy(table).to(cuda)
    plan = None if route == "plan" else route
    if route == "shared" and 4 * r > kernels.REMAP_SMEM_MAX:
        with pytest.raises(kernels.KernelError):
            kernels.remap_many(c, offs, t, plan=plan)
        return
    want = BC._remap_many_plain(torch.from_numpy(codes), offs, torch.from_numpy(table))
    kernels.reset_counts()
    got = kernels.remap_many(c, offs, t, plan=plan)
    assert kernels.LAUNCHES["remap"] == kernels.grid_launches()["remap"] == 1
    assert torch.equal(got.cpu(), want)
    if codes.shape[0] > 1:  # codes[1:]: no 16-byte aligned quad
        tail = offs[1:] - 1
        tail[tail < 0] = 0
        got = kernels.remap_many(c[1:], np.concatenate([[0], tail]), t, plan=plan)
        assert torch.equal(got.cpu(), want[1:])


def test_cut_is_one_remap_launch(cuda):
    """A cut's 29 code columns (span, trace, scope, event, link, the 9
    dedicated resource columns and the 4 attr tables' key and string
    columns) go through B9a in one launch with one upload and one
    download, and the finalized columns equal the CPU cut's byte for
    byte."""
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block.builder import BlockBuilder
    from tempo_tpu_torch.ops import blockcut as BC

    traces = make_traces(400, seed=15, n_spans=10)
    seen = []
    many = BC.CutEngine.remap_many

    def spy(self, cols, table):
        seen.append(len(cols))
        return many(self, cols, table)

    fins = []
    for dev in (cuda, "cpu"):
        b = BlockBuilder("t", device=dev)
        for tid, t in sorted(traces, key=lambda x: x[0]):
            b.add_trace(tid, t)
        kernels.reset_counts()
        BC.CutEngine.remap_many = spy
        try:
            fins.append(b.finalize())
        finally:
            BC.CutEngine.remap_many = many
        if dev == cuda:
            assert kernels.LAUNCHES["remap"] == kernels.grid_launches()["remap"] == 1
    assert seen == [29, 29]
    (g, w) = fins
    assert list(g.cols) == list(w.cols)
    for name in w.cols:
        assert g.cols[name].dtype == w.cols[name].dtype, name
        assert g.cols[name].tobytes() == w.cols[name].tobytes(), name


def test_tempodb_cut_card_matches_cpu(cuda):
    """write_block on the card (B9a/B9b/B9c launched) writes the same
    objects as on the CPU."""
    from tempo_tpu_torch import kernels

    traces = make_traces(300, seed=8, n_spans=12)
    dev_db = TempoDB(TempoDBConfig(row_group_spans=256), backend=MemBackend(), device=cuda)
    cpu_db = TempoDB(TempoDBConfig(row_group_spans=256), backend=MemBackend(), device="cpu")
    kernels.reset_counts()
    dm = dev_db.write_block("t", traces)
    assert kernels.LAUNCHES["remap"] > 0
    assert kernels.LAUNCHES["bloom_bits"] == kernels.LAUNCHES["rowgroup"] == 1
    assert kernels.grid_launches()["rowgroup"] == 1
    cm = cpu_db.write_block("t", traces)
    assert len(dm.row_groups) > 1
    for name in ["data.vtpu", "dict.vtpu"] + [f"bloom-{i}" for i in range(dm.bloom_shards)]:
        assert dev_db.backend.read("t", dm.block_id, name) == cpu_db.backend.read("t", cm.block_id,
                                                                                   name), name


@pytest.mark.parametrize("route", ["union", "columnar", "wire"])
def test_tempodb_compaction_card_matches_cpu(cuda, route):
    """compact_once on the card and on the CPU over copies of one store:
    equal outputs; the union route launches B10a once; the wire route's
    cut runs B9a and B9c but no B9b (the union is its bloom)."""
    from tempo_tpu_torch import kernels

    inputs = MemBackend()
    writer = TempoDB(TempoDBConfig(), backend=inputs, device="cpu")
    n = 8 if route != "columnar" else 200  # 4 x 200 traces: the union does not fit
    all_traces = make_traces(4 * n, seed=21, n_spans=4)
    for i in range(4):
        writer.write_block("t", all_traces[i * n:(i + 1) * n])
    dbs = []
    for dev in (cuda, "cpu"):
        store = MemBackend()
        store._objects = dict(inputs._objects)
        db = TempoDB(TempoDBConfig(), backend=store, device=dev)
        db.cfg.compaction.concat_small_input_bytes = 0
        db.cfg.compaction.columnar = route != "wire"
        db.poll_now()
        dbs.append(db)
    kernels.reset_counts()
    got = dbs[0].compact_once("t")
    counts, grids = dict(kernels.LAUNCHES), kernels.grid_launches()
    want = dbs[1].compact_once("t")
    assert counts["bloom_union"] == grids["bloom_union"] == (0 if route == "columnar" else 1)
    if route == "wire":
        assert counts["remap"] > 0 and counts["rowgroup"] == 1 and counts["bloom_bits"] == 0
    assert len(got) == len(want) == 1
    (g,), (w,) = got[0].new_blocks, want[0].new_blocks
    for name in ["data.vtpu", "dict.vtpu"] + [f"bloom-{i}" for i in range(g.bloom_shards)]:
        assert dbs[0].backend.read("t", g.block_id, name) == dbs[1].backend.read("t", w.block_id,
                                                                                 name), name
    for tid, t in all_traces[::9]:
        found = dbs[0].find_trace_by_id("t", tid)
        assert found is not None and found.span_count() == t.span_count()
