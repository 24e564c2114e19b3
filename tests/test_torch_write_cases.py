"""Shared inputs and checks for the port's compaction tests
(test_torch_compaction.py, test_torch_retention.py): input blocks
written once by the JAX package and copied into the port's store, so
block ids, job hashes and the merge order agree. Imports both packages,
so only the CPU tests use it. Holds no tests."""

import dataclasses
import json
import shutil

import numpy as np

from tempo_tpu.block import open_block as r_open
from tempo_tpu.db import TempoDB as RTempoDB
from tempo_tpu.db import TempoDBConfig as RConfig
from tempo_tpu.util.testdata import make_trace as r_make_trace
from tempo_tpu.util.testdata import make_traces as r_make_traces
from tempo_tpu_torch.block import open_block
from tempo_tpu_torch.db import TempoDB, TempoDBConfig

TENANT = "t1"
COLLIDE = b"\x77" * 16


def _batches(kind):
    """Input blocks (lists of reference (id, trace) pairs) per scenario."""
    if kind == "concat":  # test_db.py:662: 8 small level-0 blocks
        t = r_make_traces(40, seed=61, n_spans=5)
        return [t[i * 5:(i + 1) * 5] for i in range(8)]
    if kind == "collision":  # test_db.py:427-459: a shared id in two blocks
        return [sorted(r_make_traces(12, seed=53, n_spans=6)
                       + [(COLLIDE, r_make_trace(51, trace_id=COLLIDE, n_spans=4))],
                       key=lambda p: p[0]),
                sorted(r_make_traces(12, seed=54, n_spans=6)
                       + [(COLLIDE, r_make_trace(52, trace_id=COLLIDE, n_spans=5))],
                       key=lambda p: p[0]),
                r_make_traces(12, seed=55, n_spans=6)]
    if kind == "size_cuts":  # test_db.py:461
        t = r_make_traces(24, seed=61, n_spans=5)
        return [t[:12], t[12:]]
    if kind == "union":  # test_db.py:385-410: blocks of 8 traces share a geometry
        return [r_make_traces(8, seed=31), r_make_traces(8, seed=32)]
    if kind == "mixed_geometry":  # 8 and 300 traces: the bloom is rebuilt
        return [r_make_traces(8, seed=33), r_make_traces(300, seed=34, n_spans=2)]
    return [r_make_traces(30, seed=12, n_spans=5)[i * 10:(i + 1) * 10] for i in range(3)]


CFGS = {
    "concat": {},
    "collision": {"concat_small_input_bytes": 0},
    "size_cuts": {"concat_small_input_bytes": 0, "target_block_bytes": 1},
    "union": {"concat_small_input_bytes": 0},
    "mixed_geometry": {"concat_small_input_bytes": 0},
    "wire": {"concat_small_input_bytes": 0, "columnar": False},
    "wire_collision": {"concat_small_input_bytes": 0, "columnar": False},
}


def _dbs(tmp_path, scenario, codec="zstd"):
    """(reference TempoDB, port TempoDB on the CPU) over two copies of one
    store whose input blocks the reference wrote."""
    kind = "collision" if scenario == "wire_collision" else scenario
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    ref = RTempoDB(RConfig(backend={"backend": "local", "path": str(rdir)},
                           wal_path=str(tmp_path / "wal"), block_codec=codec,
                           batch_enabled=False))
    for batch in _batches(kind):
        ref.write_block(TENANT, batch)
    shutil.copytree(rdir, pdir)
    port = TempoDB(TempoDBConfig(backend={"backend": "local", "path": str(pdir)},
                                 block_codec=codec), device="cpu")
    for k, v in CFGS[scenario].items():
        setattr(ref.cfg.compaction, k, v)
        setattr(port.cfg.compaction, k, v)
    ref.cfg.compaction.min_input_blocks = port.cfg.compaction.min_input_blocks = 2
    ref.cfg.compaction.max_input_blocks = port.cfg.compaction.max_input_blocks = 16
    ref.poll_now()
    port.poll_now()
    return ref, port


def _doc(meta):
    d = json.loads(meta.to_json())
    for k in ("block_id", "size_bytes"):
        d.pop(k)
    return d


def assert_same_output(pbackend, pmeta, rbackend, rmeta):
    assert _doc(pmeta) == _doc(rmeta)
    pb = open_block(pbackend, pmeta.tenant_id, pmeta.block_id)
    rb = r_open(rbackend, rmeta.tenant_id, rmeta.block_id)
    assert pb.pack.names() == rb.pack.names()
    for name in rb.pack.names():
        got, want = pb.pack.read(name), rb.pack.read(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pb.dictionary.strings == rb.dictionary.strings
    for i in range(rmeta.bloom_shards):
        np.testing.assert_array_equal(pb.bloom_shard(i), rb.bloom_shard(i))


def _part(block_id):
    """A compound part's id without its random compound id."""
    return block_id.split("/", 1)[-1]


def _compact_both(ref, port):
    rres, pres = ref.compact_once(TENANT), port.compact_once(TENANT)
    assert len(rres) == len(pres) >= 1
    for r, p in zip(rres, pres):
        assert sorted(map(_part, p.compacted_ids)) == sorted(map(_part, r.compacted_ids))
        assert (p.traces_out, p.spans_out) == (r.traces_out, r.spans_out)
        assert len(p.new_blocks) == len(r.new_blocks)
    return rres, pres


def _asdict(t):
    return None if t is None else dataclasses.asdict(t)


def _finds_equal(ref, port, tids):
    for tid in tids:
        got, want = port.find_trace_by_id(TENANT, tid), ref.find_trace_by_id(TENANT, tid)
        assert want is not None and _asdict(got) == _asdict(want), tid.hex()


ROUTES = ["concat", "collision", "size_cuts", "union", "mixed_geometry", "wire", "wire_collision"]
