"""Compaction: the JAX package's compactor and the port's (device="cpu":
the bloom union B10a and the wire route's cut on their plain versions)
over copies of one backend (test_torch_write_cases.py). Each route
(concat, columnar with a collision and with size cuts, wire) must give
the same jobs, output columns, dictionary, bloom words and meta (block
id and compressed size aside: the two packages' zstd writers may emit
other bytes), and the same finds and searches afterwards; the union
route rebuilds no bloom. Blocklist, poller and retention:
test_torch_retention.py."""

import json

import pytest
from test_torch_write_cases import (
    ROUTES,
    TENANT,
    _batches,
    _compact_both,
    _dbs,
    _doc,
    _finds_equal,
    assert_same_output,
)

import tempo_tpu.native as r_native
from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu.db import compactor as rcomp
from tempo_tpu_torch.block.bloom import ShardedBloom
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig
from tempo_tpu_torch.db import compactor as comp
from tempo_tpu_torch.ops import bloom_ops
from tempo_tpu_torch.ops.blockcut import CutEngine


@pytest.mark.parametrize("scenario", ROUTES)
def test_select_jobs_match_reference(scenario, tmp_path):
    ref, port = _dbs(tmp_path, scenario)
    now = 1.8e9
    rj = rcomp.select_jobs(TENANT, ref.blocklist.metas(TENANT), ref.cfg.compaction, now=now)
    pj = comp.select_jobs(TENANT, port.metas(TENANT), port.cfg.compaction, now=now)
    assert [(j.hash, [m.block_id for m in j.blocks]) for j in pj] == \
        [(j.hash, [m.block_id for m in j.blocks]) for j in rj]
    assert [comp.concat_eligible(j, port.cfg.compaction) for j in pj] == \
        [rcomp.concat_eligible(j, ref.cfg.compaction) for j in rj]
    ref.close()


@pytest.mark.parametrize("scenario", [s for s in ROUTES if s != "concat"])
def test_compaction_outputs_match_reference(scenario, tmp_path):
    ref, port = _dbs(tmp_path, scenario)
    rres, pres = _compact_both(ref, port)
    for r, p in zip(rres, pres):
        for rm, pm in zip(r.new_blocks, p.new_blocks):
            assert "/" not in pm.block_id
            assert_same_output(port.backend, pm, ref.backend, rm)
    if scenario == "size_cuts":
        assert len(pres[0].new_blocks) > 1
    ref.close()


def test_concat_compound_matches_reference(tmp_path):
    ref, port = _dbs(tmp_path, "concat")
    rres, pres = _compact_both(ref, port)
    for r, p in zip(rres, pres):
        assert all("/" in m.block_id for m in p.new_blocks)
        assert [_doc(m) for m in p.new_blocks] == [_doc(m) for m in r.new_blocks]
        assert [m.block_id.split("/")[1] for m in p.new_blocks] == \
            [m.block_id.split("/")[1] for m in r.new_blocks]
        cid = p.new_blocks[0].block_id.split("/")[0]
        doc = json.loads(port.backend.read(TENANT, cid, "meta.json"))
        rdoc = json.loads(ref.backend.read(TENANT, r.new_blocks[0].block_id.split("/")[0],
                                           "meta.json"))
        for d in (doc, rdoc):
            d.pop("block_id"), d.pop("created_at")
            for part in d["parts"]:
                part.pop("block_id")
        assert doc == rdoc
    # a fresh poll expands the compound into parts that serve find
    fresh = TempoDB(TempoDBConfig(backend={"backend": "local", "path": str(tmp_path / "port")}),
                    device="cpu")
    fresh.poll_now()
    parts = [m for m in fresh.metas(TENANT) if "/" in m.block_id]
    assert len(parts) == 8 and all(m.compaction_level == 1 for m in parts)
    _finds_equal(ref, fresh, [t for b in _batches("concat") for t, _ in b][::3])
    ref.close()


def test_union_route_rebuilds_no_bloom(tmp_path, monkeypatch):
    """test_db.py:385-410 on the port: the output bloom is the union of
    the inputs' (one B10a call), never re-inserted id by id."""
    ref, port = _dbs(tmp_path, "union")

    def no_rebuild(*a, **k):
        raise AssertionError("bloom rebuilt key-by-key; union path not taken")

    for name in ("add_many", "add_array", "add"):
        monkeypatch.setattr(ShardedBloom, name, no_rebuild)
    monkeypatch.setattr(CutEngine, "bloom_bits", no_rebuild)
    calls = []
    union0 = bloom_ops.union
    monkeypatch.setattr(bloom_ops, "union", lambda s: calls.append(s.shape) or union0(s))
    m1, m2 = port.metas(TENANT)
    res = port.compact_once(TENANT)
    assert res and len(calls) == 1 and calls[0][0] == 2
    (out,) = port.metas(TENANT)
    assert (out.bloom_shards, out.bloom_shard_bits) == (m1.bloom_shards, m1.bloom_shard_bits)
    blk = port.open_block(out)
    assert all(blk.bloom_test(t) for b in _batches("union") for t, _ in b)
    rres = ref.compact_once(TENANT)
    assert_same_output(port.backend, out, ref.backend, rres[0].new_blocks[0])
    ref.close()


@pytest.mark.parametrize("scenario", ["collision", "concat", "wire"])
def test_find_and_search_after_compaction_match_reference(scenario, tmp_path):
    ref, port = _dbs(tmp_path, scenario)
    _compact_both(ref, port)
    tids = [t for b in _batches(scenario) for t, _ in b]
    _finds_equal(ref, port, sorted(set(tids))[::2])
    for tags, q in (({"service.name": "auth"}, None), ({}, '{ kind = server }'),
                    ({}, '{ duration > 1ms }')):
        got = port.search(TENANT, SearchRequest(tags=tags, query=q, limit=1000))
        want = ref.search(TENANT, RRequest(tags=tags, query=q, limit=1000))
        assert sorted((t.trace_id, t.start_time_unix_nano) for t in got.traces) == \
            sorted((t.trace_id, t.start_time_unix_nano) for t in want.traces)
        assert got.traces
    ref.close()


def test_columnar_equal_to_reference_native_fused_route(tmp_path):
    """The reference merges with its native library where built (the
    fused remap-in-copy route, columnar_compact.py:110-121, :488-496);
    the port takes the numpy route. The outputs are equal."""
    assert r_native.available()
    ref, port = _dbs(tmp_path, "collision")
    job_r = rcomp.select_jobs(TENANT, ref.blocklist.metas(TENANT), ref.cfg.compaction)[0]
    job_p = comp.select_jobs(TENANT, port.metas(TENANT), port.cfg.compaction)[0]
    from tempo_tpu.db.columnar_compact import plan_columnar as r_plan

    assert all(s is None or s.fused_remap for s in r_plan(ref.backend, job_r,
                                                           ref.cfg.compaction).sources[:3])
    r = rcomp.compact(ref.backend, job_r, ref.cfg.compaction)
    p = comp.compact(port.backend, job_p, port.cfg.compaction, "cpu")
    for rm, pm in zip(r.new_blocks, p.new_blocks):
        assert_same_output(port.backend, pm, ref.backend, rm)
    ref.close()


def test_compact_without_a_device_needs_a_card(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, port = _dbs(tmp_path, "union")
    job = comp.select_jobs(TENANT, port.metas(TENANT), port.cfg.compaction)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comp.compact(port.backend, job, port.cfg.compaction)
    ref.close()


def test_write_path_modules_import_no_jax_and_no_reference():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, tempo_tpu_torch.ops.blockcut, tempo_tpu_torch.ops.bloom_ops, "
            "tempo_tpu_torch.db.compactor, tempo_tpu_torch.db.columnar_compact, "
            "tempo_tpu_torch.db.concat_compact, tempo_tpu_torch.db.blocklist; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tempo_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr