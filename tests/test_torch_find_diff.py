"""Seeded random finds through both packages' TempoDBs on the CPU: the
port's (device="cpu", so K3 runs its plain version through
lookup_ids_blocks_cached) against the JAX package's single-chip device
engine, over test_torch_reference.slice_dbs' four blocks plus two blocks
that split 12 traces between them (the first half of each trace's spans
written by the reference, the second half by the port).

Each draw mixes present ids of every block, split ids and absent ids
(random, and the ends of the id space). Single finds go through
find_trace_by_id; batched finds through find_in_blocks_multi, whose
port side coalesces ids sharing a candidate partition into one K3 call.
Every trace must be equal, partial traces combined. Exact."""

import dataclasses
import random

import numpy as np
import pytest
from test_torch_reference import TENANT, slice_dbs

from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu.wire import model as RM
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.util.testdata import make_traces
from tempo_tpu_torch.wire import model as PM

N_SPLIT = 12


def _halves(t, m) -> tuple:
    """The first and the second half of t's spans as two partial traces
    (each under its own copy of the resource and scope batches), built
    from the model module m."""
    spans = [(rs, ss, sp) for rs in t.resource_spans for ss in rs.scope_spans for sp in ss.spans]
    out = []
    for part in (spans[:len(spans) // 2], spans[len(spans) // 2:]):
        tr, last = m.Trace(), (None, None)
        for rs, ss, sp in part:
            if last[0] is not rs:
                tr.resource_spans.append(m.ResourceSpans(resource=rs.resource))
                last = (rs, None)
            if last[1] is not ss:
                tr.resource_spans[-1].scope_spans.append(m.ScopeSpans(scope=ss.scope))
                last = (rs, ss)
            tr.resource_spans[-1].scope_spans[-1].spans.append(sp)
        out.append(tr)
    return tuple(out)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """(port, reference, present ids, split ids): slice_dbs' pair with
    two more blocks, the reference's holding the first halves of
    N_SPLIT traces and the port's the second halves."""
    gen = slice_dbs(tmp_path_factory.mktemp("find-diff"))
    port, ref, ids = next(gen)
    rtr = r_make_traces(N_SPLIT, seed=21, n_spans=10)
    ptr = make_traces(N_SPLIT, seed=21, n_spans=10)
    assert [t for t, _ in rtr] == [t for t, _ in ptr]
    ref.write_block(TENANT, [(tid, _halves(t, RM)[0]) for tid, t in rtr])
    port.write_block(TENANT, [(tid, _halves(t, PM)[1]) for tid, t in ptr])
    port.poll_now()
    ref.poll_now()
    yield port, ref, ids, [t for t, _ in ptr]
    next(gen, None)


def _draw(dbs, seed: int, n: int = 16) -> list[bytes]:
    """n ids: present ones of every block, split ones, and absent ones."""
    _, _, present, split = dbs
    r = random.Random(seed)
    absent = [bytes(r.randrange(256) for _ in range(16)) for _ in range(2)]
    pool = present + split + absent + [b"\x00" * 16, b"\xff" * 16]
    return [r.choice(pool) for _ in range(n)]


def _same(got, want, tid: bytes) -> bool:
    assert (got is None) == (want is None), tid.hex()
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want), tid.hex()
    return got is not None


@pytest.mark.parametrize("seed", range(6))
def test_single_finds_match_reference(dbs, seed):
    port, ref, _, _ = dbs
    ids = _draw(dbs, seed)
    found = [_same(port.find_trace_by_id(TENANT, t), ref.find_trace_by_id(TENANT, t), t)
             for t in ids]
    assert any(found)


@pytest.mark.parametrize("seed", range(6))
def test_batched_finds_match_reference(dbs, seed):
    """One find_in_blocks_multi burst a package over one candidate set
    (every block), so the port coalesces the ids into one K3 group."""
    port, ref, _, _ = dbs
    ids = _draw(dbs, 100 + seed, n=24)
    metas = port.metas(TENANT)
    rmetas = {m.block_id: m for m in ref.blocklist.metas(TENANT)}
    before = BX.routing_counts().get(("find_batch", "device", "coalesced"), 0)
    got = port.find_in_blocks_multi([(TENANT, t, metas) for t in ids])
    coalesced = BX.routing_counts().get(("find_batch", "device", "coalesced"), 0) - before
    want = ref.find_in_blocks_multi([(TENANT, t, [rmetas[m.block_id] for m in metas])
                                     for t in ids])
    assert any([_same(g, w, t) for t, g, w in zip(ids, got, want)])
    assert coalesced >= 1


@pytest.mark.parametrize("batched", [False, True])
def test_split_ids_combine_like_the_reference(dbs, batched):
    """Every split trace: both halves found and combined, equal to the
    reference's combine and holding every span of the whole trace."""
    port, ref, _, split = dbs
    if batched:
        metas = port.metas(TENANT)
        rmetas = [m for m in ref.blocklist.metas(TENANT)]
        got = port.find_in_blocks_multi([(TENANT, t, metas) for t in split])
        want = ref.find_in_blocks_multi([(TENANT, t, rmetas) for t in split])
    else:
        got = [port.find_trace_by_id(TENANT, t) for t in split]
        want = [ref.find_trace_by_id(TENANT, t) for t in split]
    for t, g, w in zip(split, got, want):
        assert _same(g, w, t)
        assert g.span_count() == 10, t.hex()


def test_id_space_ends_and_neighbours(dbs):
    """Ids one below and one above present ids (last byte +-1), and the
    ends of the id space: absent in both, or equal where a neighbour
    happens to exist."""
    port, ref, present, _ = dbs
    rng = np.random.default_rng(3)
    ids = [b"\x00" * 16, b"\xff" * 16]
    for t in (present[i] for i in rng.choice(len(present), 8, replace=False)):
        v = int.from_bytes(t, "big")
        ids += [(v + d).to_bytes(16, "big") for d in (-1, 1) if 0 <= v + d < 2**128]
    for t in ids:
        _same(port.find_trace_by_id(TENANT, t), ref.find_trace_by_id(TENANT, t), t)
