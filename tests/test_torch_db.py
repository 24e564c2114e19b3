"""The whole slice on the CPU: the JAX package's TempoDB and the port's
TempoDB(device="cpu") over ONE local backend (test_torch_reference.slice_dbs)
give equal traces and equal tag / fallback / single-block search responses,
bit for bit; plus the port's import and device guards. The TraceQL
searches are in test_torch_search.py."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_reference import TENANT, slice_dbs

import tempo_tpu.db.search as r_search_mod
import tempo_tpu_torch.db.search as search_mod
from tempo_tpu.db import SearchRequest as RRequest
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import SearchRequest, TempoDB, TempoDBConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    yield from slice_dbs(tmp_path_factory.mktemp("slice"))


def _asdicts(traces):
    return [dataclasses.asdict(t) for t in traces]


def _find_both(dbs, tids):
    port, ref, _ = dbs
    out = []
    for tid in tids:
        got, want = port.find_trace_by_id(TENANT, tid), ref.find_trace_by_id(TENANT, tid)
        assert (got is None) == (want is None), tid.hex()
        if got is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        out.append(got)
    return out


@pytest.mark.parametrize("which", ["reference_block", "port_block", "synth_blocks"])
def test_find_present_ids_matches_reference(dbs, which):
    ids = dbs[2]
    part = {"reference_block": ids[:18], "port_block": ids[18:32], "synth_blocks": ids[32:]}[which]
    assert part and all(t is not None for t in _find_both(dbs, part))


@pytest.mark.parametrize("which", ["random", "id_space_ends"])
def test_find_absent_ids_matches_reference(dbs, which):
    rng = np.random.default_rng(1)
    tids = ([rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(8)]
            if which == "random" else [b"\x00" * 16, b"\xff" * 16])
    assert all(t is None for t in _find_both(dbs, tids))


@pytest.mark.parametrize("kw", [
    {"tags": {"service.name": "db"}},
    {"tags": {"http.status_code": "500"}, "min_duration_ms": 100},
    {"tags": {"component": "grpc"}, "start": 1_700_000_000, "end": 1_700_000_000},
    {"start": 1_700_000_001, "end": 1_700_003_000},
    {"tags": {"nope": "x"}},
])
def test_tag_search_matches_reference(dbs, kw):
    port, ref, _ = dbs
    got, want = port.search(TENANT, SearchRequest(**kw)), ref.search(TENANT, RRequest(**kw))
    assert _asdicts(got.traces) == _asdicts(want.traces)
    assert got.inspected_spans == want.inspected_spans


@pytest.mark.parametrize("query", [
    '{ resource.service.name = "db" }', '{ span.http.status_code = 500 }',
    '{ name =~ "GET.*|op-000.*" }', '{ true } > { kind = client }',
    '{ kind = server } >> { kind = client }'])
def test_per_block_fallback_matches_reference(dbs, monkeypatch, query):
    port, ref, _ = dbs
    monkeypatch.setattr(search_mod, "_DEVICE_SEARCH_MAX_BYTES", 0)
    monkeypatch.setattr(r_search_mod, "_DEVICE_SEARCH_MAX_BYTES", 0)
    monkeypatch.setattr(r_search_mod, "_link_rtt_ms", lambda: 0.0)
    got = port.search(TENANT, SearchRequest(query=query))
    want = ref.search(TENANT, RRequest(query=query))
    assert _asdicts(got.traces) == _asdicts(want.traces)
    assert got.inspected_spans == want.inspected_spans


@pytest.mark.parametrize("query", ['{ kind = server }', '{ true } > { kind = client }'])
def test_search_block_matches_reference(dbs, query):
    port, ref, _ = dbs
    meta = [m for m in port.metas(TENANT) if len(m.row_groups) >= 3][0]
    rmeta = [m for m in ref.blocklist.metas(TENANT) if m.block_id == meta.block_id][0]
    got = search_mod.search_block(port.open_block(meta), SearchRequest(query=query), device="cpu")
    want = r_search_mod.search_block(ref.open_block(rmeta), RRequest(query=query), mode="device")
    assert got.traces and _asdicts(got.traces) == _asdicts(want.traces)
    assert got.inspected_spans == want.inspected_spans


def test_port_imports_no_jax_and_no_reference():
    code = ("import sys, tempo_tpu_torch.db, tempo_tpu_torch.kernels, tempo_tpu_torch.util.synth, "
            "tempo_tpu_torch.ops.multiquery, tempo_tpu_torch.ops.timeseries, "
            "tempo_tpu_torch.ops.hostfilter, tempo_tpu_torch.db.batchexec, "
            "tempo_tpu_torch.db.metrics_exec; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tempo_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_tempodb_without_device_raises_on_a_cpu_only_box(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TempoDB(TempoDBConfig(), backend=LocalBackend(str(tmp_path)))


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
