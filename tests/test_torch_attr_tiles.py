"""M5's tiled count (csrc/meshsearch.cu attr_tile_kernel) as a numpy
model, with the kernel's tile of owners, its window of rows, its chunk
walk with ballot words and their exclusive popcount prefix, and its
CTA-wide monotone vote, held against the reference's `owner_counts`
arithmetic (tempo_tpu/parallel/search.py:122-140, in jnp) and the port's
plain version (ops/meshsearch._attr_partial_plain) on one shard's rows:
sp cuts of 1, 2 and 4, owners with no rows, owners across a tile and a
shard cut, an owner with more rows than a chunk, falling and
out-of-range offsets inside one tile, PAD_I32 keys past the real rows,
and the `any`, string, int, float and table leaves. Partial counts over
the shards sum to the whole block's. Every output is an int: exact."""

import os
import re

import numpy as np
import pytest
import torch
from test_torch_meshsearch import _owner_counts_ref
from torch_tile_cases import ATTR_SPECS, CHUNK, TILE, attr_case, attr_hits, attr_shard

from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import meshsearch as MS

SPS = [1, 2, 4]


def _tiled_model(hit, off, arow0, stats):
    """attr_tile_kernel on one shard: hit (Bl, Al) the leaf's row hits,
    off (Bl, n_seg + 1) the global offsets -> (Bl, n_seg) counts. Counts
    the tiles that voted monotone, those that did not, and the chunks."""
    bl, al = hit.shape
    n_seg = off.shape[1] - 1
    out = np.zeros((bl, n_seg), np.int64)
    bit = np.uint64(1) << np.arange(32, dtype=np.uint64)
    for b in range(bl):
        c = np.clip(off[b].astype(np.int64) - arow0, 0, al)  # 64-bit, as clip_off
        for o0 in range(0, n_seg, TILE):
            n = min(TILE, n_seg - o0)
            lo, hi = c[o0:o0 + n], c[o0 + 1:o0 + n + 1]
            if not np.all(lo <= hi):  # the vote fails: each owner's rows, signed
                s = np.asarray([hit[b, min(x, y):max(x, y)].sum() for x, y in zip(lo, hi)])
                out[b, o0:o0 + n] = np.where(hi >= lo, s, -s)
                stats["owner"] += 1
                continue
            stats["mono"] += 1
            ct = c[o0:o0 + n + 1]  # the tile's offsets; the window [ct[0], ct[n])
            e = np.full(n + 1, -1, np.int64)  # E(ct[i]) - E(ct[0]), -1 until its chunk
            run = 0
            for base in range(ct[0], ct[n], CHUNK):
                rows = base + np.arange(CHUNK)
                h = np.zeros(CHUNK, bool)
                h[rows < ct[n]] = hit[b, rows[rows < ct[n]]]
                words = (h.reshape(-1, 32) * bit).sum(axis=1).astype(np.uint64)  # the ballots
                pc = np.bitwise_count(words).astype(np.int64)
                pre = np.concatenate([[0], np.cumsum(pc)])  # exclusive; [-1] the total
                pos = ct - base
                take = (e < 0) & (pos < CHUNK)
                k, low = pos[take] >> 5, (np.uint64(1) << (pos[take] & 31).astype(np.uint64))
                e[take] = run + pre[k] + np.bitwise_count(words[k] & (low - np.uint64(1)))
                run += int(pre[-1])
                stats["chunks"] += 1
            e[e < 0] = run  # ct[i] == ct[n] past the last chunk: the window's total
            out[b, o0:o0 + n] = e[1:] - e[:-1]
    return out


def _check_leaf(case, i, sp, stats):
    """Model, reference and plain version on every shard of sp; the shards'
    sum against the whole block's counts. Returns the whole counts."""
    hit = attr_hits(case, i)
    off = case["cols"]["sattr.off"]
    c = F.Cond(*ATTR_SPECS[i][:3], is_float=ATTR_SPECS[i][3])
    ops_i, ops_f = torch.from_numpy(case["ints"]), torch.from_numpy(case["floats"])
    table = torch.from_numpy(case["tables"][i]) if i in case["tables"] else None
    al = hit.shape[1] // sp
    total = np.zeros((2, off.shape[1] - 1), np.int64)
    for k in range(sp):
        part = {n: torch.from_numpy(a) for n, a in attr_shard(case, sp, k).items()}
        h = hit[:, k * al:(k + 1) * al]
        want = _owner_counts_ref(h, off, k * al)
        got = _tiled_model(h, off, k * al, stats)
        np.testing.assert_array_equal(got, want)
        plain = MS._attr_partial_plain(c, part, ops_i, ops_f, i, table, k * al).numpy()
        np.testing.assert_array_equal(plain, want)
        total += got
    return total


def test_tile_constants_match_the_kernel():
    src = open(os.path.join(kernels.CSRC, "meshsearch.cu")).read()
    d = {k: int(v) for k, v in re.findall(r"#define (AP_\w+) (\d+)", src)}
    assert d["AP_THREADS"] * d["AP_OWN"] == TILE
    assert d["AP_THREADS"] * d["AP_ROWS"] == CHUNK


@pytest.mark.parametrize("sp", SPS)
@pytest.mark.parametrize("leaf", range(len(ATTR_SPECS)),
                         ids=[s[1] + "_" + s[2] for s in ATTR_SPECS])
def test_tiled_model_matches_reference(sp, leaf):
    case = attr_case(40 + leaf)
    stats = dict.fromkeys(("mono", "owner", "chunks"), 0)
    total = _check_leaf(case, leaf, sp, stats)
    hit, off = attr_hits(case, leaf), case["cols"]["sattr.off"]
    whole = np.asarray([[hit[b, off[b, o]:off[b, o + 1]].sum() for o in range(off.shape[1] - 1)]
                        for b in range(2)])
    np.testing.assert_array_equal(total, whole)
    assert whole[:, 1500].min() > 0 and (whole == 0).any()  # not vacuous
    assert stats["owner"] == 0
    if sp == 1:
        assert stats["chunks"] > stats["mono"]  # owner 1,500's tile walks several chunks


@pytest.mark.parametrize("sp", SPS)
def test_tiled_model_hostile_offsets(sp):
    """Block 1's first tile is not monotone (a falling offset, offsets
    below 0 and past A): it takes the per-owner route, signs kept; its
    second tile, one offset past A only, stays monotone after clipping."""
    case = attr_case(7, hostile=True)
    stats = dict.fromkeys(("mono", "owner", "chunks"), 0)
    for leaf in range(len(ATTR_SPECS)):
        _check_leaf(case, leaf, sp, stats)
    assert stats["owner"] > 0 and stats["mono"] > 0
    hit = attr_hits(case, 0)
    got = _tiled_model(hit, case["cols"]["sattr.off"], 0, stats)
    assert got.min() < 0  # the falling range counts negative, as ecs[hi] - ecs[lo]


@pytest.mark.parametrize("shape", ["no_rows", "ragged_tile", "past_shard"])
def test_tiled_model_edges(shape):
    """Owners with no rows anywhere (empty windows), a last tile of 1
    owner, and a shard whose rows all lie past every offset."""
    if shape == "no_rows":
        case = attr_case(3, big=0)
        case["cols"]["sattr.off"][:] = 0
    elif shape == "ragged_tile":
        case = attr_case(4, n_own=TILE + 1)
    else:
        case = attr_case(5, big=0)
        case["cols"]["sattr.off"] //= 8  # every row below A / 8
    stats = dict.fromkeys(("mono", "owner", "chunks"), 0)
    for leaf in (0, 1):
        _check_leaf(case, leaf, 4, stats)
    assert stats["owner"] == 0
