"""Seeded random batched TraceQL searches through both packages on the
CPU: the port's TempoDB.search_blocks_multi (device="cpu", so B5a and
B5b run their plain versions) against the JAX package's, each batching
on a 1x1 mesh, over the four blocks of test_torch_reference.slice_dbs.

Each burst is a list of batcher-eligible queries drawn from a seed: one
CNF shape whose conditions keep their kinds and draw operators and
operands, or four such families shuffled together, with limits of 5, 20
and 200 in one group (so the group's top-k is sliced to each query's
own k). Every response -- traces and inspected spans -- must be equal,
and each burst must have run at least one coalesced group. The last test
holds the port's row-wise select to the prefix property the batcher
relies on. Exact."""

import dataclasses
import random

import numpy as np
import pytest
import torch
from test_torch_reference import TENANT, slice_dbs

from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.parallel import make_mesh
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.ops import multiquery as MQ

# the two make_traces blocks' and the two synth blocks' names and services
NAMES = ["GET /", "GET /api", "db.query", "cache.get", "render", "op-0001", "op-0042", "op-0100"]
SERVICES = ["db", "auth", "frontend", "checkout", "svc-007", "svc-012", "svc-030"]
KINDS = ["server", "client", "internal", "producer", "consumer"]
# CNF shapes: one group of one, two and three clauses, OR inside a
# clause, two groups joined at trace level, a trace-level OR
SHAPES = ["{ A }", "{ A && B }", "{ A || B }", "{ (A || B) && C }", "{ A && B && C }",
          "{ (A && B) || C }", "{ A } && { B }", "{ A } || { B }"]
LIMITS = (5, 20, 200)


def _atom(r: random.Random, kind: int) -> str:
    """One condition of a kind (0-4 span-level, 5 resource, 6 trace),
    its operator and operand drawn from r."""
    if kind == 0:
        return f'name {r.choice(["=", "!="])} "{r.choice(NAMES)}"'
    if kind == 1:
        return f'duration {r.choice([">", "<", ">=", "<="])} {r.choice([1, 10, 100, 500, 1500])}ms'
    if kind == 2:
        return f'status {r.choice(["=", "!="])} {r.choice(["error", "ok", "unset"])}'
    if kind == 3:
        return f'kind {r.choice(["=", "!="])} {r.choice(KINDS)}'
    if kind == 4:
        return f'span.http.status_code {r.choice(["=", ">=", "<", "!="])} {r.choice([200, 404, 500])}'
    if kind == 5:
        return f'resource.service.name {r.choice(["=", "!="])} "{r.choice(SERVICES)}"'
    return f'traceDuration {r.choice([">", "<"])} {r.choice([100, 1000, 1900])}ms'


def _family(r: random.Random, shape: str, n: int) -> list[str]:
    """n queries of one shape whose conditions keep their kinds (the
    first a span-level one, so the plan stays on the span axis) and draw
    their operators and operands: one program shape and column set, so
    the batcher groups them."""
    kinds = [r.randrange(5)] + [r.randrange(7) for _ in range(2)]
    out = []
    for _ in range(n):
        q = shape
        for x, kind in zip("ABC", kinds):
            q = q.replace(x, _atom(r, kind), 1)
        out.append(q)
    return out


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(port, reference) TempoDBs over slice_dbs' store, both batching
    and promoting a block on its first search (slice_dbs' own pair does
    neither), the reference on a 1x1 mesh."""
    tmp = tmp_path_factory.mktemp("batched-diff")
    gen = slice_dbs(tmp)
    port0, _, _ = next(gen)
    port = TempoDB(TempoDBConfig(row_group_spans=256, device_promote_touches=1),
                   backend=port0.backend, device="cpu")
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": str(tmp / "store")},
                           wal_path=str(tmp / "wal-batched"), row_group_spans=256,
                           batch_enabled=True, device_promote_touches=1))
    ref._mesh = make_mesh(1)
    port.poll_now()
    ref.poll_now()
    yield port, ref
    ref.close()
    next(gen, None)


def _burst(dbs, queries: list[str]) -> None:
    """Every query on every block as one search_blocks_multi burst in
    each package: equal responses, and at least one coalesced group."""
    port, ref = dbs
    metas = port.metas(TENANT)
    rmetas = {m.block_id: m for m in ref.blocklist.metas(TENANT)}
    jobs = [(q, LIMITS[i % len(LIMITS)], m) for i, q in enumerate(queries) for m in metas]
    before = BX.routing_counts()
    got = port.search_blocks_multi([(TENANT, [m], SearchRequest(query=q, limit=lim))
                                    for q, lim, m in jobs])
    coalesced = (BX.routing_counts().get(("search_batch", "device", "coalesced"), 0)
                 - before.get(("search_batch", "device", "coalesced"), 0))
    want = ref.search_blocks_multi([(TENANT, [rmetas[m.block_id]], RRequest(query=q, limit=lim))
                                    for q, lim, m in jobs])
    for (q, lim, m), g, w in zip(jobs, got, want):
        assert [dataclasses.asdict(t) for t in g.traces] == \
            [dataclasses.asdict(t) for t in w.traces], (q, lim, m.block_id)
        assert g.inspected_spans == w.inspected_spans, (q, lim, m.block_id)
    assert coalesced >= 1, "no query group took the batched route"


@pytest.mark.parametrize("shape", SHAPES)
def test_shape_burst_matches_reference(dbs, shape):
    _burst(dbs, _family(random.Random(SHAPES.index(shape)), shape, 12))


@pytest.mark.parametrize("seed", range(6))
def test_mixed_burst_matches_reference(dbs, seed):
    """Four families of four queries, each of a random shape, shuffled
    into one burst."""
    r = random.Random(100 + seed)
    queries = [q for _ in range(4) for q in _family(r, r.choice(SHAPES), 4)]
    r.shuffle(queries)
    _burst(dbs, queries)


def test_select_multiquery_keeps_every_prefix():
    """A k-select's first k' slots, then valid, are the k'-select for
    every k' <= k: 16 rows with heavy key ties."""
    rng = np.random.default_rng(3)
    tm = torch.from_numpy(rng.random((16, 1000)) < 0.2)
    key = torch.from_numpy(rng.integers(0, 5, 1000).astype(np.int32))
    counts = torch.from_numpy(rng.integers(0, 40, (16, 1000)).astype(np.int32))
    k = 64
    full = MQ.select_multiquery(tm, key, counts, k)
    for kk in range(1, k + 1):
        part = MQ.select_multiquery(tm, key, counts, kk)
        for row, (s, c, v, n), (s2, c2, v2, n2) in zip(range(16), full, part):
            assert n == n2 == int(tm[row].sum())
            np.testing.assert_array_equal(s[:kk], s2)
            np.testing.assert_array_equal(c[:kk], c2)
            np.testing.assert_array_equal(v[:kk], v2)
