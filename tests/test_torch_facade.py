"""The rest of the port's TempoDB facade against the JAX package's, over
test_torch_reference.slice_dbs' store (two make_traces blocks, one
written by each package, and two synth blocks): tag discovery
(`search_tags`, `search_tag_values`, with byte caps that cut: the same
sets and the same `exceeded`), `find_candidates` with time windows,
`Blocklist.metas_by_id`, a `Poller(build_index=False)` reading the other
package's tenant index (and a stale one ignored, a non-owner reading
the owner's), `enable_polling` picking up a block another TempoDB wrote,
and `close` joining the poll thread. All of it is host work: no kernel."""

import time

import numpy as np
import pytest
from test_torch_reference import TENANT, slice_dbs

import tempo_tpu.db.search as RS
from tempo_tpu.backend import LocalBackend as RLocal
from tempo_tpu.db.blocklist import Poller as RPoller
from tempo_tpu.util.distinct import DistinctStringCollector as RCollector
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.db import search as PS
from tempo_tpu_torch.db.blocklist import Poller
from tempo_tpu_torch.util.distinct import DistinctStringCollector
from tempo_tpu_torch.util.testdata import make_traces

TAGS = ["service.name", "name", "component", "cache.hit", "http.status_code",
        "k8s.namespace.name", "attr.key007", "no.such.tag"]
CAPS = [0, 1, 40, 300]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("facade")
    gen = slice_dbs(tmp)
    port, ref, ids = next(gen)
    yield port, ref, ids, tmp
    next(gen, None)


def _blocks(port, ref):
    pm = sorted(port.metas(TENANT), key=lambda m: m.block_id)
    rm = sorted(ref.blocklist.metas(TENANT), key=lambda m: m.block_id)
    assert [m.block_id for m in pm] == [m.block_id for m in rm] and len(pm) == 4
    return [(port.open_block(p), ref.open_block(r)) for p, r in zip(pm, rm)]


def test_search_tags_match_reference(dbs):
    port, ref, _, _ = dbs
    got = port.search_tags(TENANT)
    assert got == ref.search_tags(TENANT)
    assert {"component", "cache.hit", "service.name", "attr.key000"} <= set(got)


@pytest.mark.parametrize("cap", CAPS[1:])
def test_search_tags_capped_match_reference(dbs, cap):
    """A byte cap that cuts: the facade's sorted list and, block by block
    through one collector, the same set and the same `exceeded`."""
    port, ref, _, _ = dbs
    assert port.search_tags(TENANT, max_bytes=cap) == ref.search_tags(TENANT, max_bytes=cap)
    pc, rc = DistinctStringCollector(cap), RCollector(cap)
    for pb, rb in _blocks(port, ref):
        PS.search_tags(pb, pc)
        RS.search_tags(rb, rc)
        assert pc.strings() == rc.strings() and pc.exceeded == rc.exceeded
    assert pc.exceeded


@pytest.mark.parametrize("tag", TAGS)
def test_search_tag_values_match_reference(dbs, tag):
    """Every value of a tag (the intrinsic name, well-known resource
    columns, string, int and bool attributes, an absent tag), uncapped
    and at caps that cut: the vectorised collection keeps the reference's
    first-seen order, so each cap keeps exactly its set."""
    port, ref, _, _ = dbs
    for cap in CAPS:
        got = port.search_tag_values(TENANT, tag, max_bytes=cap)
        assert got == ref.search_tag_values(TENANT, tag, max_bytes=cap), cap
        pc, rc = DistinctStringCollector(cap), RCollector(cap)
        for pb, rb in _blocks(port, ref):
            PS.search_tag_values(pb, tag, pc)
            RS.search_tag_values(rb, tag, rc)
            assert (pc.strings(), pc.exceeded) == (rc.strings(), rc.exceeded), cap
    if tag in ("cache.hit",):
        assert port.search_tag_values(TENANT, tag) == ["false", "true"]
    if tag == "no.such.tag":
        assert got == []


@pytest.mark.parametrize("window", ["all", "covering", "disjoint"])
def test_find_candidates_match_reference(dbs, window):
    port, ref, ids, _ = dbs
    metas = port.metas(TENANT)
    lo = min(m.start_time_unix_nano for m in metas) // 10**9
    hi = -(-max(m.end_time_unix_nano for m in metas) // 10**9)
    t0, t1 = {"all": (0, 0), "covering": (lo, hi), "disjoint": (hi + 3600, hi + 7200)}[window]
    absent = [bytes([i]) * 16 for i in (0, 0x7F, 0xFF)] + [b"\x42"]
    n_found = 0
    for tid in ids + absent:
        got = [m.block_id for m in port.find_candidates(TENANT, tid, t0, t1)]
        assert got == [m.block_id for m in ref.find_candidates(TENANT, tid, t0, t1)]
        n_found += bool(got)
    assert (n_found == 0) == (window == "disjoint")


def test_metas_by_id_skips_missing(dbs):
    port, ref, _, _ = dbs
    metas = port.metas(TENANT)
    want = [metas[2].block_id, "missing-block", metas[0].block_id]
    got = port.blocklist.metas_by_id(TENANT, want)
    assert [m.block_id for m in got] == [metas[2].block_id, metas[0].block_id]
    assert [m.block_id for m in got] == \
        [m.block_id for m in ref.blocklist.metas_by_id(TENANT, want)]
    assert port.blocklist.metas_by_id("no-tenant", want) == []


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_index_reader_takes_the_other_packages_index(dbs, writer):
    """A poll that builds the index writes it; a Poller(build_index=False)
    of the other package reads it in place of a listing, meta for meta."""
    port, _, _, tmp = dbs
    store = str(tmp / "store")
    if writer == "port":
        built = Poller(LocalBackend(store)).poll_tenant(TENANT)
        got = RPoller(RLocal(store), build_index=False).poll_tenant(TENANT)
    else:
        built = RPoller(RLocal(store)).poll_tenant(TENANT)
        got = Poller(LocalBackend(store), build_index=False).poll_tenant(TENANT)
    assert [[m.to_json() for m in x] for x in got] == [[m.to_json() for m in x] for x in built]
    assert len(got[0]) == 4


def test_stale_index_is_ignored_and_non_owner_reads_it(tmp_path):
    """An index older than stale_index_max_age_s reads as none (the poller
    lists instead); a non-owner reads the index without listing."""
    be = LocalBackend(str(tmp_path / "s"))
    db = TempoDB(TempoDBConfig(), backend=be, device="cpu")
    db.write_block(TENANT, make_traces(6, seed=1, n_spans=2))
    Poller(be).poll()  # writes the index: one block
    db.write_block(TENANT, make_traces(6, seed=2, n_spans=2))
    assert len(Poller(be, build_index=False).poll_tenant(TENANT)[0]) == 1  # the index
    stale = Poller(be, build_index=False, stale_index_max_age_s=1e-9)
    time.sleep(0.01)
    assert stale._read_index(TENANT) is None
    assert len(stale.poll_tenant(TENANT)[0]) == 2  # listed
    deferred = Poller(be)
    deferred.owns_tenant = lambda t: False
    metas, _ = deferred.poll()
    assert len(metas[TENANT]) == 1
    assert RPoller(RLocal(str(tmp_path / "s")), build_index=False).poll_tenant(TENANT)[0][0] \
        .block_id == metas[TENANT][0].block_id


def test_enable_polling_picks_up_another_writer_and_close_joins(tmp_path):
    """A reader TempoDB polling every 50 ms sees a block another TempoDB
    wrote into the same store; close() stops and joins its thread."""
    store = str(tmp_path / "store")
    writer = TempoDB(TempoDBConfig(), backend=LocalBackend(store), device="cpu")
    writer.write_block(TENANT, make_traces(5, seed=3, n_spans=2))
    reader = TempoDB(TempoDBConfig(blocklist_poll_s=0.05), backend=LocalBackend(store),
                     device="cpu")
    reader.enable_polling()
    assert len(reader.metas(TENANT)) == 1  # the first poll runs at once
    thread = reader._poll_thread
    reader.enable_polling()  # a second call starts nothing
    assert reader._poll_thread is thread and thread.is_alive()
    traces = make_traces(5, seed=4, n_spans=2)
    meta = writer.write_block(TENANT, traces)
    deadline = time.time() + 10
    while len(reader.metas(TENANT)) < 2 and time.time() < deadline:
        time.sleep(0.02)
    assert meta.block_id in {m.block_id for m in reader.metas(TENANT)}
    tid, t = traces[2]
    assert reader.find_trace_by_id(TENANT, tid).span_count() == t.span_count()
    reader.close()
    assert not thread.is_alive() and reader.poll_errors == 0
    n = len(reader.metas(TENANT))
    writer.write_block(TENANT, make_traces(5, seed=5, n_spans=2))
    time.sleep(0.2)
    assert len(reader.metas(TENANT)) == n  # no poll after close
    writer.close()


def test_tag_values_first_seen_order_matches_row_loop():
    """The vectorised attribute collection against the reference's row
    loop on a hostile order: mixed types, repeats, and a cap that refuses
    a long value first and then takes shorter ones."""
    rng = np.random.default_rng(5)

    class Pack:
        def __init__(self, cols):
            self.cols = cols

        def read(self, n):
            return self.cols[n]

        def has(self, n):
            return n in self.cols

    class Dict:
        strs = ["", "tag", "a" * 30, "b", "cc", "ddd"]

        def lookup(self, s):
            return self.strs.index(s) if s in self.strs else -1

        def string(self, c):
            return self.strs[c]

    class Blk:
        pass

    n = 400
    cols = {"span.name_id": np.zeros(1, np.int32)}
    for pre in ("sattr", "rattr"):
        cols[f"{pre}.key_id"] = rng.choice([1, 1, 1, 3], size=n).astype(np.int32)
        cols[f"{pre}.vtype"] = rng.choice([0, 1, 2, 3], size=n).astype(np.int32)
        cols[f"{pre}.str_id"] = rng.integers(2, 6, size=n).astype(np.int32)
        cols[f"{pre}.int64"] = rng.integers(-3, 4, size=n).astype(np.int64)
    blk = Blk()
    blk.pack, blk.dictionary = Pack(cols), Dict()
    for cap in (0, 3, 12, 31, 40):
        pc, rc = DistinctStringCollector(cap), RCollector(cap)
        PS.search_tag_values(blk, "tag", pc)
        RS.search_tag_values(blk, "tag", rc)
        assert (pc.strings(), pc.exceeded) == (rc.strings(), rc.exceeded), cap
