"""K3's warp search (tempo_tpu_torch/csrc/find.cu) as a numpy model,
held against the JAX package's `_lookup_blocks_kernel` jitted on the
CPU, and against the port's plain `_bisect_plain`.

The model uses find.cu's probe arithmetic and lane count: while 32 or
more rows of [lo, hi) are open, lane j probes row lo + floor(j (hi - lo)
/ 32) and the popcount c of "row < query" narrows the range to (probe
c - 1, probe c]; then lanes 0 .. hi - lo probe rows lo .. hi below
n_valid, and the lane at the lower bound tests equality. A (block,
query) whose n_steps is below bit_length(n_valid), or whose n_valid lies
outside [0, T], runs the reference's lockstep loop (clamped probe, floor
mid) instead, as the kernel's one lane does.

The indexes are sorted as the block writer sorts them (signed lanes,
lexicographic, duplicates allowed), with pad rows 2**31 - 1 past
n_valid, or arbitrary rows there (the stacked form's caller may leave
anything). Exact."""

import numpy as np
import pytest
import torch

from tempo_tpu.ops import find as RF
from tempo_tpu_torch.ops import find as FD

LANES = 32  # find.cu: a warp a (block, query)
PAD = 2**31 - 1


def _less(rows: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Signed lexicographic rows < q for (n, 4) rows (find.cu lex_less)."""
    lt, eq = rows < q, rows == q
    return lt[:, 0] | (eq[:, 0] & (lt[:, 1] | (eq[:, 1] & (lt[:, 2] | (eq[:, 2] & lt[:, 3])))))


def lockstep(blk: np.ndarray, nv: int, q: np.ndarray, n_steps: int) -> int:
    """The kernel's one-lane loop: the reference's bisect_ids, step for step."""
    T = blk.shape[0]
    lo, hi = 0, nv
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        less = bool(_less(blk[min(max(mid, 0), T - 1)][None], q)[0])
        lo, hi = (mid + 1, hi) if less else (lo, mid)
    return lo if lo < nv and (blk[min(max(lo, 0), T - 1)] == q).all() else -1


def warp_search(blk: np.ndarray, nv: int, q: np.ndarray) -> tuple[int, int]:
    """find.cu find_warp: (row or -1, dependent load steps)."""
    lanes = np.arange(LANES, dtype=np.int64)
    lo, hi, steps = 0, nv, 0
    while hi - lo >= LANES:
        n = hi - lo
        probes = lo + ((lanes * n) >> 5)
        c = int(_less(blk[probes], q).sum())
        steps += 1
        if c == 0:
            hi = lo
            break
        if c < LANES:
            hi = lo + ((c * n) >> 5)
        lo += (((c - 1) * n) >> 5) + 1
    p = lo + lanes
    ok = (lanes <= hi - lo) & (p < nv)
    rows = blk[np.minimum(p, blk.shape[0] - 1)]
    less = ok & _less(rows, q)
    eq = ok & (rows == q).all(axis=1)
    c = int(less.sum())
    assert c <= hi - lo < LANES
    return (lo + c if eq[c] else -1), steps + 1


def model(ids: np.ndarray, queries: np.ndarray, n_valid: np.ndarray, n_steps: int) -> np.ndarray:
    """K3 on a (B, T, 4) stack: the kernel's choice of route a (block, query)."""
    B, T, _ = ids.shape
    out = np.empty((B, queries.shape[0]), np.int32)
    for b in range(B):
        nv = int(n_valid[b])
        short = nv < 0 or nv > T or n_steps < max(nv, 0).bit_length()
        for i, q in enumerate(queries):
            out[b, i] = (lockstep(ids[b], nv, q, n_steps) if short
                         else warp_search(ids[b], nv, q)[0])
    return out


def sorted_rows(rng, n: int) -> np.ndarray:
    """n rows sorted by signed lanes, with duplicates and shared prefixes."""
    pool = rng.integers(-(2**31), 2**31 - 1, (max(n // 3, 1), 4), dtype=np.int64)
    pool[:, 0] = rng.choice([-(2**31), -7, 0, 5, 2**31 - 2], pool.shape[0])  # shared heads
    a = pool[rng.integers(0, pool.shape[0], n)].astype(np.int32)
    return a[np.lexsort(a.T[::-1])]


def stack(rng, T: int, fill: str) -> tuple[np.ndarray, np.ndarray]:
    """One block a n_valid of {0, 1, 31, 32, 33, T - 1, T} within [0, T]."""
    nvs = sorted({n for n in (0, 1, 31, 32, 33, T - 1, T) if 0 <= n <= T})
    ids = np.full((len(nvs), T, 4), PAD, np.int32)
    if fill == "garbage":
        ids[:] = rng.integers(-(2**31), 2**31 - 1, ids.shape, dtype=np.int64).astype(np.int32)
    for b, n in enumerate(nvs):
        ids[b, :n] = sorted_rows(rng, n)
    return ids, np.asarray(nvs, np.int32)


def queries_for(rng, ids: np.ndarray, n_valid: np.ndarray) -> np.ndarray:
    """Rows of each block (at), rows nudged by one in a lane (between),
    the ends of the id space (below, and the pad row), and random ids."""
    qs = [np.full(4, -(2**31), np.int32), np.full(4, PAD, np.int32)]
    for b, n in enumerate(n_valid):
        for i in rng.integers(0, max(int(n), 1), 4) if n else []:
            row = ids[b, i].astype(np.int64)
            qs.append(row.astype(np.int32))
            nudged = row.copy()
            nudged[rng.integers(0, 4)] += rng.choice([-1, 1])
            qs.append(np.clip(nudged, -(2**31), 2**31 - 1).astype(np.int32))
    qs += list(rng.integers(-(2**31), 2**31 - 1, (6, 4), dtype=np.int64).astype(np.int32))
    return np.stack(qs)


@pytest.mark.parametrize("fill", ["pad", "garbage"])
@pytest.mark.parametrize("T", [1, 32, 1024, 2048])
def test_model_matches_jax(T, fill):
    """Every n_steps from 0 to bit_length(T) + 2: the warp route where
    the steps cover n_valid, the lockstep lane below that."""
    rng = np.random.default_rng(T * 2 + (fill == "garbage"))
    ids, n_valid = stack(rng, T, fill)
    queries = queries_for(rng, ids, n_valid)
    hits = 0
    for n_steps in range(T.bit_length() + 3):
        want = np.asarray(RF._lookup_blocks_kernel(ids, queries, n_valid, n_steps))
        got = model(ids, queries, n_valid, n_steps)
        np.testing.assert_array_equal(got, want, err_msg=f"T={T} n_steps={n_steps}")
        hits += int((got >= 0).sum())
    assert hits > 0


def test_duplicates_give_the_first_row():
    """A run of equal rows: the lower bound, the run's first row, on
    both routes and in the reference."""
    blk = np.repeat(np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 9, 9, 9]], np.int32),
                    [40, 700, 284], axis=0)
    ids, nv = blk[None], np.asarray([blk.shape[0]], np.int32)
    qs = np.asarray([[5, 6, 7, 8], [9, 9, 9, 9], [1, 2, 3, 4], [5, 6, 7, 9]], np.int32)
    want = np.asarray(RF._lookup_blocks_kernel(ids, qs, nv, 11))
    np.testing.assert_array_equal(want[0], [40, 740, 0, -1])
    np.testing.assert_array_equal(model(ids, qs, nv, 11), want)


@pytest.mark.parametrize("T,most", [(31, 1), (1024, 2), (32768, 3), (1 << 20, 4)])
def test_dependent_steps(T, most):
    """Search steps, then the equality lane's load: at most `most` + 1
    dependent loads a (block, query) where the bisection takes
    bit_length(T) + 1."""
    rng = np.random.default_rng(T)
    blk = np.sort(rng.choice(2**31 - 1, T, replace=False)).astype(np.int32)
    blk = np.stack([blk, blk, blk, blk], axis=1)
    for q in list(blk[rng.integers(0, T, 24)]) + [blk[0] - 1, blk[-1] + 1]:
        row, steps = warp_search(blk, T, q.astype(np.int32))
        assert steps <= most + 1, (T, steps)
        assert row == (int(np.searchsorted(blk[:, 0], q[0])) if (blk[:, 0] == q[0]).any() else -1)


def test_probes_narrow_32x():
    """For every open length from 32 to 5,000: 32 distinct probes, the
    first at lo and the last below hi, and each (probe c - 1, probe c]
    at most ceil(n / 32) rows."""
    lanes = np.arange(LANES, dtype=np.int64)
    for n in range(32, 5001):
        p = (lanes * n) >> 5
        assert p[0] == 0 and p[-1] < n and (np.diff(p) >= 1).all()
        gaps = np.diff(np.append(p, n))
        assert gaps.max() <= -(-n // 32)


@pytest.mark.parametrize("n_steps", [0, 3, 12])
def test_port_plain_matches_model(n_steps):
    """`_bisect_plain`, the card's yardstick, against the model on one
    stack of T = 2,048 at a full, short and zero step count."""
    rng = np.random.default_rng(40 + n_steps)
    ids, n_valid = stack(rng, 2048, "pad")
    queries = queries_for(rng, ids, n_valid)
    got = FD._bisect_plain(torch.from_numpy(ids), torch.from_numpy(queries),
                           torch.from_numpy(n_valid), n_steps)
    np.testing.assert_array_equal(got.numpy(), model(ids, queries, n_valid, n_steps))


def test_lockstep_outside_the_index():
    """n_valid above T or below 0: the lockstep lane, as the reference
    clamps its probe."""
    rng = np.random.default_rng(9)
    ids, _ = stack(rng, 64, "pad")
    ids = ids[-1:]
    queries = queries_for(rng, ids, np.asarray([64], np.int32))
    for nv in (-3, 65, 100):
        n_valid = np.asarray([nv], np.int32)
        for n_steps in (0, 7, 9):
            want = np.asarray(RF._lookup_blocks_kernel(ids, queries, n_valid, n_steps))
            np.testing.assert_array_equal(model(ids, queries, n_valid, n_steps), want)
