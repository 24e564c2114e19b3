"""B9c (the cut's row-group stats) and B10a (the bloom union) as their
kernels split the work (csrc/blockcut.cu rowgroup_kernel, csrc/bloom.cu
union_kernel), modelled in numpy and held against the JAX package's
programs run on the CPU: `rowgroup_minmax_device` (jit, bounds every
`group` rows) and its numpy twin `rowgroup_minmax_host`
(tempo_tpu/ops/blockcut.py), and `_union_kernel`
(tempo_tpu/ops/bloom_ops.py). Also the port's CPU paths
(`CutEngine("cpu").rowgroup_minmax`, `union_blooms(..., "cpu")`) and the
mesh's union body, which over an axis of one rank gathers nothing and
takes one union. Inputs come from numpy with a seed; every output is an
int32 or a uint32 word, so every comparison is exact. The kernels
themselves are held against their plain versions on the card
(tests/test_torch_cuda_write.py)."""

import numpy as np
import pytest
import torch

from tempo_tpu.block.bloom import ShardedBloom as RBloom
from tempo_tpu.ops import blockcut as RB
from tempo_tpu.ops import bloom_ops as RO
from tempo_tpu_torch import kernels
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.ops import blockcut as B
from tempo_tpu_torch.ops import bloom_ops as O
from tempo_tpu_torch.parallel import bloom as PB
from tempo_tpu_torch.parallel.mesh import Mesh

INT_MIN, INT_MAX = -(2**31), 2**31 - 1

# (n, group, values): the cut's shape, one group, ragged groups, a last
# group of one row, the largest a flush sees
RG_CASES = {
    "one_row": (1, 1, "random"),
    "1000_in_333": (1000, 333, "random"),
    "70000_in_65536": (70_000, 65_536, "random"),
    "cut_2^20": (1 << 20, 65_536, "random"),
    "2^22": (1 << 22, 65_536, "random"),
    "last_group_one_row": (3 * 65_536 + 1, 65_536, "random"),
    "int32_extremes": (200_003, 65_536, "extremes"),
}


def _columns(n, values, seed):
    rng = np.random.default_rng(seed)
    sm = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
    du = rng.integers(INT_MIN, INT_MAX, n, dtype=np.int64, endpoint=True).astype(np.int32)
    if values == "extremes":
        sm[::2], sm[1::3] = INT_MIN, INT_MAX
        du[::5], du[1::2] = INT_MAX, INT_MIN
    return sm, du


def _fold(fn, ident, *vals):
    return int(fn([ident] + [int(fn(v)) for v in vals if v.size]))


def _rowgroup_model(sm, du, group, clusters, sh):
    """rowgroup_kernel in numpy: group g's C CTAs take slices of a
    multiple of 4 rows; a slice's aligned quads (rows i with (i - sh) % 4
    == 0 start one; sh < 0: none) fold 4 rows at a time, the rows before
    the first and after the last quad one at a time; rank 0 folds the C
    partials. Returns the (3, G) stats and, a row, how many times it was
    read (every row once)."""
    n = sm.shape[0]
    g_n = -(-n // group)
    out = np.empty((3, g_n), np.int32)
    seen = np.zeros(n, np.int64)
    for g in range(g_n):
        a, b = g * group, min((g + 1) * group, n)
        sl = (-(-(b - a) // clusters) + 3) & ~3
        parts = []
        for r in range(clusters):
            lo_r = min(a + r * sl, b)
            hi_r = min(lo_r + sl, b)
            qa = qb = hi_r
            if sh >= 0:
                qa, qb = lo_r + (sh - lo_r) % 4, hi_r - (hi_r - sh) % 4
                if qb <= qa:
                    qa = qb = hi_r
            assert (qb - qa) % 4 == 0 and sl % 4 == 0
            quads_s, quads_d = sm[qa:qb].reshape(-1, 4), du[qa:qb].reshape(-1, 4)
            rows = np.r_[lo_r:qa, qb:hi_r]
            seen[qa:qb] += 1
            seen[rows] += 1
            # a quad folds its 4 rows, then the thread folds quads and rows
            parts.append((_fold(np.min, INT_MAX, quads_s.min(axis=1), sm[rows]),
                          _fold(np.max, INT_MIN, quads_s.max(axis=1), sm[rows]),
                          _fold(np.max, INT_MIN, quads_d.max(axis=1), du[rows])))
        out[:, g] = (min(p[0] for p in parts), max(p[1] for p in parts),
                     max(p[2] for p in parts))
    return out, seen


@pytest.mark.parametrize("case", sorted(RG_CASES))
def test_rowgroup_model_matches_reference(case):
    """The kernel's split at the plan's C (and at every C, for the
    shapes under 2^20 rows), for columns on a 16-byte boundary (sh 0),
    views off it (sh 3: a view at offset 1) and columns of two phases
    (row by row): the stats equal the reference's jitted program and its
    numpy twin, and every row is read once."""
    n, group, values = RG_CASES[case]
    sm, du = _columns(n, values, n + group)
    bounds = list(range(0, n, group)) + [n]
    dev = np.stack([np.asarray(x) for x in RB.rowgroup_minmax_device(sm, du, bounds)])
    host = np.stack(RB.rowgroup_minmax_host(sm, du, bounds))
    np.testing.assert_array_equal(dev, host)
    plan = kernels.rowgroup_plan(n, group)
    assert plan.groups == len(bounds) - 1 and plan.ctas == plan.groups * plan.clusters
    cs = [plan.clusters] if n >= 1 << 20 else [1, 2, 4, 8]
    for c in cs:
        for sh in ((0, 3, -1) if c == plan.clusters else (0,)):
            got, seen = _rowgroup_model(sm, du, group, c, sh)
            np.testing.assert_array_equal(got, dev, err_msg=f"C = {c}, sh = {sh}")
            assert (seen == 1).all(), (c, sh)


@pytest.mark.parametrize("n,group,want", [
    (1 << 20, 65_536, (8, 16, 128)),   # the cut: 16 groups, 128 CTAs
    (1 << 22, 65_536, (4, 64, 256)),   # 64 groups: 4 CTAs each fill the card
    (70_000, 65_536, (8, 2, 16)),
    (1 << 14, 8192, (2, 2, 4)),        # slices of 4,096 rows, the floor
    (1 << 14, 4096, (1, 4, 4)),        # halves under the floor: no cluster
    (1000, 333, (1, 4, 4)),            # a slice under a few thousand rows: no cluster
    (1, 1, (1, 1, 1)),
])
def test_rowgroup_plan(n, group, want):
    """rowgroup_plan fills the card where the rows allow it, splits no
    CTA's slice under ROWGROUP_SLICE_MIN rows, and gives C in {1, 2, 4,
    8}; a pure function of (n, group)."""
    plan = kernels.rowgroup_plan(n, group)
    assert tuple(plan) == want
    assert plan == kernels.rowgroup_plan(n, group)
    assert plan.clusters == 1 or min(group, n) // plan.clusters >= kernels.ROWGROUP_SLICE_MIN
    with pytest.raises(kernels.KernelError):
        kernels.rowgroup_plan(0, group)


def _union_model(stacked, off16):
    """union_kernel in numpy over (K, S, W) uint32 words: a thread a
    quad of 4 output words (the K planes' quads ORed in chunks of 8)
    where S x W is a multiple of 4 and no pointer is off 16 bytes, else
    a word an item. Returns the OR and the route taken."""
    k = stacked.shape[0]
    flat = stacked.reshape(k, -1)
    n = flat.shape[1]
    vec = n % 4 == 0 and not off16
    items = flat.reshape(k, -1, 4) if vec else flat.reshape(k, -1, 1)
    acc = np.zeros(items.shape[1:], np.uint32)
    for k0 in range(0, k, 8):
        chunk = items[k0:k0 + 8]
        acc |= np.bitwise_or.reduce(chunk, axis=0)
    return acc.reshape(stacked.shape[1:]), "quad" if vec else "word"


@pytest.mark.parametrize("k", [1, 2, 8, 9, 10])
def test_union_model_matches_reference(k):
    """For S x W mod 4 in {0, 1, 2, 3} and the pointer on or off 16
    bytes, the model's quad and word routes equal the reference's
    _union_kernel and the port's plain version."""
    rng = np.random.default_rng(k)
    shapes = ((3, 64), (1, 33), (3, 18), (1, 7))
    assert sorted(a * b % 4 for a, b in shapes) == [0, 1, 2, 3]
    for shape in shapes:
        x = rng.integers(0, 2**32, (k,) + shape, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(RO._union_kernel(x))
        plain = O._union_plain(torch.from_numpy(x.view(np.int32))).numpy().view(np.uint32)
        np.testing.assert_array_equal(plain, want)
        for off16 in (False, True):
            got, route = _union_model(x, off16)
            assert route == ("quad" if (shape[0] * shape[1]) % 4 == 0 and not off16 else "word")
            np.testing.assert_array_equal(got, want, err_msg=f"{shape}, off16 {off16}")


@pytest.mark.parametrize("case", ["1000_in_333", "last_group_one_row", "int32_extremes"])
def test_cut_engine_rowgroups_match_reference(case):
    n, group, values = RG_CASES[case]
    sm, du = _columns(n, values, 7 * n)
    bounds = list(range(0, n, group)) + [n]
    got = B.CutEngine("cpu").rowgroup_minmax(sm, du, group)
    want = RB.rowgroup_minmax_device(sm, du, bounds)
    host = RB.rowgroup_minmax_host(sm, du, bounds)
    for g, w, h in zip(got, want, host):
        assert g.dtype == np.int32 and g.shape == (len(bounds) - 1,)
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, h)


@pytest.mark.parametrize("k", [1, 9])
def test_union_blooms_and_planes_match_reference(k):
    """union_blooms over K same-geometry blooms, and union_planes over
    the same words given shard by shard (the compactor's inputs), equal
    the reference's union_blooms; a geometry mismatch still raises."""
    rng = np.random.default_rng(100 + k)
    ports, refs = [], []
    for _ in range(k):
        p, r = ShardedBloom(3, 1 << 12), RBloom(3, 1 << 12)
        p.words = rng.integers(0, 2**32, p.words.shape, dtype=np.uint64).astype(np.uint32)
        r.words = p.words.copy()
        ports.append(p)
        refs.append(r)
    want = np.asarray(RO.union_blooms(refs).words)
    got = O.union_blooms(ports, "cpu")
    assert got.words.dtype == np.uint32 and (got.n_shards, got.shard_bits) == (3, 1 << 12)
    np.testing.assert_array_equal(got.words, want)
    by_shard = [[p.words[i].copy() for i in range(3)] for p in ports]
    np.testing.assert_array_equal(O.union_planes(by_shard, 3, 1 << 12, "cpu").words, want)
    with pytest.raises(ValueError):
        O.union_blooms(ports + [ShardedBloom(2, 1 << 12)], "cpu")
    with pytest.raises(ValueError):
        O.union_planes(by_shard + [by_shard[0][:2]], 3, 1 << 12, "cpu")


class _StubMesh:
    """A mesh of dp x sp ranks seen from one rank whose partners hold the
    same partial: all_gather stacks n copies and counts itself."""

    def __init__(self, dp, sp):
        self.dp, self.sp, self.gathers = dp, sp, 0

    def all_gather(self, t, axis):
        self.gathers += 1
        return t[None].expand((self.dp if axis == "dp" else self.sp,) + tuple(t.shape)).clone()


@pytest.mark.parametrize("dp,sp,unions,gathers", [(1, 1, 1, 0), (2, 1, 2, 1), (1, 2, 2, 1),
                                                  (2, 2, 3, 2)])
def test_union_body_skips_axes_of_one_rank(monkeypatch, dp, sp, unions, gathers):
    """_union_body takes one union of its rank's blooms, then an
    all_gather and a union only over an axis of more than one rank: a
    1 x 1 mesh (run 1's shape) one union and no collective, a 2 x 2 mesh
    (run 2's) three and two; the answer is the reference's union."""
    rng = np.random.default_rng(dp * 10 + sp)
    x = rng.integers(0, 2**32, (4, 2, 64), dtype=np.uint64).astype(np.uint32)
    calls = []
    real = PB.union

    def counted(t):
        calls.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(PB, "union", counted)
    mesh = _StubMesh(dp, sp) if (dp, sp) != (1, 1) else Mesh(1, 1, "cpu")
    got = PB._union_body(mesh, {}, {"stacked": torch.from_numpy(x.view(np.int32))})
    assert len(calls) == unions and calls[0] == (4, 2, 64)
    assert (mesh.gathers if dp * sp > 1 else mesh.calls.get("all_gather", 0)) == gathers
    np.testing.assert_array_equal(got.view(np.uint32), np.asarray(RO._union_kernel(x)))
