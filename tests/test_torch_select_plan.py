"""K2's route and scratch sizes (kernels.select_plan), and its two-pass
decomposition against the JAX package's selection, on the CPU; the same
for B5b, which runs K2's routes on each row of a batch (kernels.mq_select
takes select_plan(n, k) for all Q rows).

The card's two-pass route (csrc/select.cu) keeps each tile's top k_pad
composites, then folds the candidates `buf` composites at a time into a
running top k_pad. `_two_pass` below runs that decomposition in torch with
select_plan's tiles, k_pad and buf, and the result is held bit for bit
against tempo_tpu's jitted `lax.top_k` selection on the same numpy
inputs. The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py::test_select_kernel)."""

import numpy as np
import pytest
import torch

from tempo_tpu.ops import multiquery as RMQ
from tempo_tpu.ops import select as RSE
from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import select as SE

PAD = torch.iinfo(torch.int64).min  # the pad composite, below every row


def _inputs(n, seed, p_mask, n_keys):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < p_mask
    key = rng.integers(0, n_keys, n).astype(np.int32)
    counts = rng.integers(0, 50, n).astype(np.int32)
    return mask, key, counts


def _topk(x: torch.Tensor, k: int) -> torch.Tensor:
    if x.numel() < k:
        x = torch.cat([x, torch.full((k - x.numel(),), PAD, dtype=torch.int64)])
    return torch.topk(x, k).values


def _two_pass(mask, key, counts, k):
    """The packed row by select.cu's decomposition. The composite is
    taken signed -- (key << 32) + (2^32 - 1 - idx), masked rows at key
    -2^31 -- which orders as the kernel's unsigned one does."""
    n = mask.shape[0]
    plan = kernels.select_plan(n, k)
    assert plan.tiled, (n, k)
    m, key, counts = torch.from_numpy(mask), torch.from_numpy(key), torch.from_numpy(counts)
    keyed = torch.where(m, key, SE._NEG).to(torch.int64)
    comp = keyed * (1 << 32) + ((1 << 32) - 1 - torch.arange(n))
    rows = plan.tiles * plan.tile
    tiles = torch.cat([comp, torch.full((rows - n,), PAD)]).reshape(plan.tiles, plan.tile)
    hits = torch.cat([m, torch.zeros(rows - n, dtype=torch.bool)]).reshape(plan.tiles, -1)
    cand = torch.stack([_topk(t, plan.k_pad) for t in tiles])  # pass 1
    per, run, nxt = plan.buf // plan.k_pad, None, 0  # pass 2, chunk by chunk
    while nxt < plan.tiles:
        take = per - (run is not None)
        chunk = cand[nxt:nxt + take].reshape(-1)
        run = _topk(chunk if run is None else torch.cat([run, chunk]), plan.k_pad)
        nxt += take
    idx = (1 << 32) - 1 - (run[:k] & 0xFFFFFFFF)
    return torch.cat([idx, counts[idx].long(), m[idx].long(),
                      hits.sum(dtype=torch.int64).reshape(1)]).to(torch.int32).numpy()


@pytest.mark.parametrize("n,k,p_mask,n_keys", [
    (4096, 64, 0.3, 7),  # exactly one tile
    (4097, 64, 0.3, 7),  # one row past a tile: a ragged last tile of one row
    (10000, 100, 0.005, 7),  # k above the match count
    (40000, kernels.K_SMALL, 0.3, 7),  # k at K_SMALL; the merge takes several chunks
    (270000, 1024, 0.3, 7),  # so many candidates that the tile doubles to 8,192
    (20000, 1, 0.5, 3),  # k = 1: runs of one composite
    (12289, 16, 0.0, 7),  # every row masked
    (12289, 16, 1.0, 2),  # no row masked, two keys
])
def test_two_pass_equals_jax_top_k(n, k, p_mask, n_keys):
    mask, key, counts = _inputs(n, n + k, p_mask, n_keys)
    got = _two_pass(mask, key, counts, k)
    want = np.asarray(RSE._compiled_select(k)(mask, key, counts))
    np.testing.assert_array_equal(got, want)
    sids, cnts, n_match = RSE.select_topk_device(mask, key, counts, k)
    valid = got[2 * k:3 * k] > 0
    np.testing.assert_array_equal(got[:k][valid], sids)
    np.testing.assert_array_equal(got[k:2 * k][valid], cnts)
    assert got[3 * k] == n_match == mask.sum()
    # the prefix property the escalation relies on: a k'-select is the
    # first k' slots of a k-select
    k2 = max(1, k // 4)
    if kernels.select_plan(n, k2).tiled:
        part = _two_pass(mask, key, counts, k2)
        for i in range(3):
            np.testing.assert_array_equal(part[i * k2:(i + 1) * k2], got[i * k:i * k + k2])


def test_select_plan_over_a_grid():
    for n in (1, 1000, 2048, 4095, 4096, 4097, 70000, 327_680, 1 << 20):
        for k in (1, 16, 63, 64, 65, 256, kernels.K_SMALL, kernels.K_SMALL + 1, 4096, n):
            if not 0 < k <= n:
                continue
            p = kernels.select_plan(n, k)
            assert p.k_pad >= k and p.k_pad < 2 * k and p.k_pad & (p.k_pad - 1) == 0, (n, k)
            if p.tiled:
                assert k <= kernels.K_SMALL and p.tiles * p.k_pad < n, (n, k)
                for size in (p.tile, p.buf):  # powers of two, in 128 KB of shared memory
                    assert size & (size - 1) == 0 and 2 * p.k_pad <= size <= 16384, (n, k)
                assert p.tile % 1024 == 0 and p.tiles == -(-n // p.tile), (n, k)
                # the tile doubles only while the one-CTA merge would fold
                # SELECT_CANDS candidates or more
                if p.tile > max(kernels.SELECT_TILE, 2 * p.k_pad):
                    assert -(-n // (p.tile // 2)) * p.k_pad >= kernels.SELECT_CANDS, (n, k)
                assert p.tile == 16384 or p.tiles * p.k_pad < kernels.SELECT_CANDS, (n, k)
                assert p.scratch == p.tiles * p.k_pad + (p.tiles + 1) // 2, (n, k)
            else:
                t = kernels._tiled_plan(n, k)
                assert k > kernels.K_SMALL or t.tiles * t.k_pad >= n, (n, k)
                assert p.n_pad >= max(n, 2048) and p.n_pad & (p.n_pad - 1) == 0, (n, k)
                assert p.scratch == p.n_pad, (n, k)


def test_select_plan_at_the_search_shapes():
    # ten blocks' trace vectors (phase 6 of chip_smoke.py), k = 64: the
    # two-pass route, 80 tiles, 41 KB of scratch in place of 4 MB
    p = kernels.select_plan(327_680, 64)
    assert p.tiled and (p.tile, p.tiles, p.k_pad) == (4096, 80, 64)
    assert p.scratch * 8 == 80 * 64 * 8 + 80 * 4
    # k = 1,024 there: 80 tiles of 4,096 would leave 81,920 candidates to
    # the one-CTA merge, so the tile doubles
    p = kernels.select_plan(327_680, 1024)
    assert p.tiled and (p.tile, p.tiles) == (8192, 40)
    p = kernels.select_plan(327_680, 2048)  # and to the largest, 16,384 rows
    assert p.tiled and (p.tile, p.tiles) == (16384, 20)
    # by shape alone: k past K_SMALL, or candidates not fewer than rows
    assert not kernels.select_plan(327_680, kernels.K_SMALL + 1).tiled
    assert not kernels.select_plan(1024, 1024).tiled
    assert not kernels.select_plan(60, 40).tiled


def test_mq_select_plan_at_the_batched_shape():
    """B5b at the batched search's shape (a block's 32,768 traces, k = 64
    for limit 20): the two passes, 8 tiles of 4,096 a row, so the tile
    pass is 8 x Q CTAs and the merge one CTA a row of 512 candidates;
    scratch Q x (8 x 64 + 4) int64 words. Past K_SMALL, or where the
    candidates are not fewer than the rows, the full sort."""
    p = kernels.select_plan(32768, 64)
    assert p.tiled and (p.tile, p.tiles, p.k_pad) == (4096, 8, 64)
    assert p.scratch == 8 * 64 + 4
    p = kernels.select_plan(32768, kernels.K_SMALL)
    assert p.tiled and (p.tile, p.tiles) == (4096, 8)
    assert not kernels.select_plan(32768, kernels.K_SMALL + 1).tiled
    assert not kernels.select_plan(4096, 4096).tiled
    assert kernels.select_plan(4096, 4096).n_pad == 4096


@pytest.mark.parametrize("q,n,k,seed", [
    (16, 32768, 64, 1),  # the batched search's shape
    (3, 5000, 64, 2),  # a ragged last tile in every row
    (5, 40000, kernels.K_SMALL, 3),  # each row's merge takes two chunks
])
def test_row_two_pass_equals_jax_mq_select(q, n, k, seed):
    """Each row by select.cu's decomposition, the key shared, equals
    tempo_tpu's jitted row-wise top-k over the (Q, n) batch."""
    rng = np.random.default_rng(seed)
    tm = rng.random((q, n)) < 0.3
    key = rng.integers(0, 9, n).astype(np.int32)
    counts = rng.integers(0, 50, (q, n)).astype(np.int32)
    want = np.asarray(RMQ._compiled_mq_select(k, q)(tm, key, counts))
    got = np.stack([_two_pass(tm[r], key, counts[r], k) for r in range(q)])
    np.testing.assert_array_equal(got, want)
