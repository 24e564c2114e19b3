"""The port's blocklist, poller and retention after compaction against
the JAX package's, over copies of one backend (test_torch_write_cases.py):
the same blocklist and compacted metas after compact_once, the same
listing and tenant index from both pollers (compound blocks expanded),
the same union capacity rule, the same compacted-marker protocol, and
retention_once marking and deleting the same blocks."""

import json

import numpy as np
import pytest
from test_torch_write_cases import (
    COLLIDE,
    TENANT,
    _batches,
    _compact_both,
    _dbs,
    _doc,
    _finds_equal,
    _part,
    assert_same_output,
)

from tempo_tpu.block import open_block as r_open
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.db import compactor as rcomp
from tempo_tpu.db.blocklist import Poller as RPoller
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.block import open_block
from tempo_tpu_torch.db import compactor as comp
from tempo_tpu_torch.db.blocklist import Poller


def test_concat_parts_compact_again_and_poll_matches_reference(tmp_path):
    """Level 1: the parts merge through the columnar rewrite; each part
    gets its own marker, and both pollers list the same blocks."""
    ref, port = _dbs(tmp_path, "concat")
    _compact_both(ref, port)
    rres, pres = _compact_both(ref, port)
    for r, p in zip(rres, pres):
        for rm, pm in zip(r.new_blocks, p.new_blocks):
            assert_same_output(port.backend, pm, ref.backend, rm)
    rm, rc = RPoller(ref.backend).poll_tenant(TENANT)
    pm, pc = Poller(port.backend).poll_tenant(TENANT)
    rnew = {m.block_id for r in rres for m in r.new_blocks}
    pnew = {m.block_id for p in pres for m in p.new_blocks}
    assert sorted(_part(m.block_id) for m in pm if m.block_id not in pnew) == \
        sorted(_part(m.block_id) for m in rm if m.block_id not in rnew)
    assert len(pm) == len(rm) and len(pc) == len(rc)
    # compacted parts hold in the grace window: compacted input ids equal
    assert sorted(_part(m.block_id) for m in pc) == sorted(_part(m.block_id) for m in rc)
    ref.close()


@pytest.mark.parametrize("blocks,fits", [(2, True), (4, True), (8, False)])
def test_union_capacity_rule_matches_reference(blocks, fits, tmp_path):
    """Small blocks get the 1,024-bit floor, which holds 106 ids at the
    design load: 2 or 4 blocks of 8 traces fit; 8 blocks of 14 (112 ids)
    do not, and both packages rebuild instead."""
    rdir = tmp_path / "ref"
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": str(rdir)},
                           wal_path=str(tmp_path / "wal"), batch_enabled=False))
    for i in range(blocks):
        ref.write_block(TENANT, r_make_traces(8 if fits else 14, seed=40 + i))
    backend = LocalBackend(str(rdir))
    metas = ref.blocklist.metas(TENANT)
    rblocks = [r_open(ref.backend, TENANT, m.block_id) for m in metas]
    pblocks = [open_block(backend, TENANT, m.block_id) for m in metas]
    want = rcomp._union_input_blooms(rblocks)
    got = comp._union_input_blooms(pblocks, "cpu")
    assert (got is None) == (want is None) == (not fits)
    if fits:
        np.testing.assert_array_equal(got.words, np.asarray(want.words))
    ids, need, have = comp.union_capacity(pblocks)
    assert ids == sum(m.total_traces for m in metas) and (need <= have) == fits
    ref.close()


def test_blocklist_after_compact_once_matches_reference(tmp_path):
    ref, port = _dbs(tmp_path, "collision")
    before = {m.block_id for m in port.metas(TENANT)}
    gens = (port.blocklist.generation(TENANT), ref.blocklist.generation(TENANT))
    rres, pres = _compact_both(ref, port)
    pl, rl = port.metas(TENANT), ref.blocklist.metas(TENANT)
    assert [_doc(m) for m in pl] == [_doc(m) for m in rl]
    assert sorted(m.block_id for m in port.blocklist.compacted_metas(TENANT)) == \
        sorted(m.block_id for m in ref.blocklist.compacted_metas(TENANT)) == sorted(before)
    # one job, one change of the searchable set
    assert port.blocklist.generation(TENANT) - gens[0] == \
        ref.blocklist.generation(TENANT) - gens[1] == 1
    assert port.tenants() == ref.tenants() == [TENANT]
    # compacted readers are gone from the cache; finds see no duplicates
    assert not {k[1] for k in port._block_cache} & before
    _finds_equal(ref, port, [COLLIDE] + [t for b in _batches("collision") for t, _ in b][::4])
    # the backend marks the inputs compacted, as the reference's does
    rm, rc = RPoller(ref.backend).poll_tenant(TENANT)
    pm, pc = Poller(port.backend).poll_tenant(TENANT)
    assert sorted(m.block_id for m in pc) == sorted(m.block_id for m in rc) == sorted(before)
    assert all(m.compacted_at_unix > 0 for m in pc)
    ref.close()


@pytest.mark.parametrize("scenario", ["collision", "concat"])
def test_retention_matches_reference(scenario, tmp_path):
    """test_db.py:205: past retention, every live block is marked; the
    compacted inputs past compacted retention are deleted (compound parts
    wait for their whole)."""
    ref, port = _dbs(tmp_path, scenario)
    _compact_both(ref, port)
    for db in (ref, port):
        db.cfg.compaction.retention_s = 10
    rr, pr = ref.retention_once(TENANT), port.retention_once(TENANT)
    rnew = {m.block_id for m in ref.blocklist.compacted_metas(TENANT)}
    assert len(pr.marked) == len(rr.marked) >= 1
    assert sorted(pr.deleted) == sorted(rr.deleted)
    assert sorted(m.block_id for m in port.blocklist.compacted_metas(TENANT)) == sorted(rnew)
    assert port.metas(TENANT) == [] == ref.blocklist.metas(TENANT)
    for bid in pr.deleted:
        assert not port.backend.has_object(TENANT, bid, "meta.compacted.json")
    port.poll_now()
    ref.poll_now()
    assert len(port.metas(TENANT)) == len(ref.blocklist.metas(TENANT))
    ref.close()


def test_mark_compacted_protocol_matches_reference(tmp_path):
    """meta.json -> meta.compacted.json with a stamp; idempotent; a
    compound part gets a minimal marker; a missing block raises."""
    from tempo_tpu.backend import LocalBackend as RLocal
    from tempo_tpu_torch.backend import DoesNotExist

    ref, port = _dbs(tmp_path, "union")
    rb = RLocal(str(tmp_path / "ref"))
    for bid in [m.block_id for m in port.metas(TENANT)]:
        port.backend.mark_compacted(TENANT, bid)
        rb.mark_compacted(TENANT, bid)
        port.backend.mark_compacted(TENANT, bid)  # idempotent
        got = json.loads(port.backend.read(TENANT, bid, "meta.compacted.json"))
        want = json.loads(rb.read(TENANT, bid, "meta.compacted.json"))
        assert got.pop("compacted_at_unix") > 0 and want.pop("compacted_at_unix") > 0
        assert got == want
        assert not port.backend.has_object(TENANT, bid, "meta.json")
    port.backend.mark_compacted(TENANT, "cid/p0")
    assert json.loads(port.backend.read(TENANT, "cid/p0", "meta.compacted.json"))["block_id"] \
        == "cid/p0"
    with pytest.raises(DoesNotExist):
        port.backend.mark_compacted(TENANT, "no-such-block")
    assert port.backend.blocks(TENANT) == rb.blocks(TENANT)
    ref.close()


def test_reference_poller_reads_the_port_index(tmp_path):
    """The port's poll writes the tenant index the reference's
    index-reading poller (build_index=False) takes in place of a listing."""
    from tempo_tpu.backend import LocalBackend as RLocal

    ref, port = _dbs(tmp_path, "concat")
    _compact_both(ref, port)
    port.poll_now()
    got = RPoller(RLocal(str(tmp_path / "port")), build_index=False).poll_tenant(TENANT)
    want = Poller(port.backend).poll_tenant(TENANT)
    assert [[m.to_json() for m in x] for x in got] == [[m.to_json() for m in x] for x in want]
    assert sum(1 for m in got[0] if "/" in m.block_id) == 8
    ref.close()
