"""The sharded metrics fold of the port (parallel/timeseries.py: M4 and
all_reduce; db/metrics_mesh.py; the mesh branch of
db/metrics_exec.metrics_query_range_blocks) over spawned gloo ranks on
the CPU, against the reference on a shard_map mesh of the same
(dp, sp): the host entry on stacked blocks with span, res and trace
conditions and NaN, +-0 and +-inf values (counts, min and max exact; f32
sums within rtol 1e-5, the order of the adds differing); the fallback
reasons of try_metrics_mesh; and TempoDB.metrics_query_range on the mesh
(as tests/test_metrics_query.py:296-306)."""

import numpy as np
import pytest
from test_metrics_query import BASE_S, RATE_Q, _req
from test_metrics_query import fixture_db  # noqa: F401  (the reference's fixture)
from test_torch_mesh_cases import SHAPE_IDS, SHAPES, start_mesh

from tempo_tpu.ops import filter as RF
from tempo_tpu.parallel import make_mesh as r_make_mesh
from tempo_tpu.parallel.timeseries import sharded_timeseries as r_sharded_ts
from tempo_tpu.util.kerneltel import TEL
from tempo_tpu_torch.backend import LocalBackend
from tempo_tpu_torch.db import TempoDB, TempoDBConfig
from tempo_tpu_torch.db import batchexec as BX
from tempo_tpu_torch.db import metrics_exec as ME
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.parallel import sharded_timeseries

# (target, column, op, is_float): one of each axis the mesh fold takes
SPECS = [("span", "span.dur_us", "gt", False), ("res", "res.service_id", "eq", False),
         ("trace", "trace.dur_ms", "ge", False), ("span", "span.dur_us", "ge", True)]
TREE = ("and", ("or", ("cond", 0), ("cond", 1)), ("or", ("cond", 2), ("cond", 3)))

# stacked-route queries (span, res and trace targets) and one that falls
# back (a generic attr target)
MESH_QUERIES = [
    '{ true } | rate() by(kind)',
    '{ true } | avg_over_time(duration) by(resource.service.name)',
    '{ resource.service.name = "a" && duration > 1s } | count_over_time()',
    '{ traceDuration > 2s || name = "op1" } | max_over_time(duration) by(name)',
    RATE_Q,
]
# (query, step_s): each of try_metrics_mesh's outcomes on the fixture
ROUTES = [
    ('{ true } | rate() by(kind)', 10),  # stacked
    (RATE_Q, 10),  # attr_targets
    ('{ .w > 5.0 } | rate()', 10),  # lossy_plan
    ('{ name = "op3" } | rate()', 10),  # too_few_blocks (block 1 prunes)
    ('{ true } | sum_over_time(.w)', 10),
    ('{ true } | rate()', 30 * 86_400),  # i32_step
]


@pytest.fixture(scope="module", params=SHAPES, ids=SHAPE_IDS)
def meshes(request, tmp_path_factory):
    yield from start_mesh(request.param, tmp_path_factory)


def _stacked(seed: int, has_val: bool):
    rng = np.random.default_rng(seed)
    B, S, R, NT = 4, 1024, 1024, 1024
    n_spans = np.asarray([900, 1024, 300, 0], np.int32)
    cols = {
        "span.start_ms": rng.integers(-5_000, 70_000, (B, S)).astype(np.int32),
        "span.trace_sid": np.sort(rng.integers(0, 200, (B, S)), axis=1).astype(np.int32),
        "span.dur_us": rng.integers(0, 40, (B, S)).astype(np.int32),
        "span.res_idx": rng.integers(-1, 50, (B, S)).astype(np.int32),
        "res.service_id": np.full((B, R), np.int32(-(2**31)), np.int32),
        "trace.dur_ms": rng.integers(0, 100, (B, NT)).astype(np.int32),
    }
    cols["res.service_id"][:, :50] = rng.integers(-1, 6, (B, 50))
    for b in range(B):
        cols["span.res_idx"][b, n_spans[b]:] = np.int32(-(2**31))
    rows = [[(0, 20 + b, 0, 0.0, 0.0), (0, b % 3, 0, 0.0, 0.0), (0, 60 - 5 * b, 0, 0.0, 0.0),
             (0, 0, 0, 30.5 - b, 0.0)] for b in range(B)]
    gid = rng.integers(-1, 5, (B, S)).astype(np.int32)
    val = pres = None
    if has_val:
        val = rng.integers(-8, 9, (B, S)).astype(np.float32) * np.float32(0.25)
        special = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)
        hit = rng.random((B, S)) < 0.03
        val[hit] = special[rng.integers(0, 5, hit.sum())]
        pres = rng.random((B, S)) < 0.8
    t0 = np.asarray([-3_000, 0, 12_345, 7], np.int32)
    return cols, rows, n_spans, t0, gid, val, pres


@pytest.mark.parametrize("has_val", [False, True])
def test_sharded_timeseries_matches_reference(meshes, has_val):
    mesh, rmesh = meshes
    cols, rows, n_spans, t0, gid, val, pres = _stacked(3 + has_val, has_val)
    rconds = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in SPECS)
    conds = tuple(F.Cond(t, c, op, is_float=f) for t, c, op, f in SPECS)
    args = (cols, n_spans, t0, gid, val, pres, 10_000, 7, 5)
    want = r_sharded_ts(rmesh, TREE, rconds, [RF.Operands.build(r) for r in rows], *args)
    # the reference on one device: its pmin / pmax over a multi-device
    # CPU mesh drop a NaN that its one-device fold (and B6) propagates;
    # the port keeps the one-device rule at every mesh size (ROADMAP §C)
    one = r_sharded_ts(r_make_mesh(1), TREE, rconds, [RF.Operands.build(r) for r in rows], *args)
    got = sharded_timeseries(mesh, TREE, conds, [F.Operands.build(r) for r in rows], *args)
    assert len(got) == len(want) == len(one) == (5 if has_val else 1)
    assert got[0].sum() > 0
    for i, (g, w, w1) in enumerate(zip(got, want, one)):
        w, w1 = np.asarray(w), np.asarray(w1)
        assert g.shape == w.shape and g.dtype == w.dtype, i
        if i == 2:  # f32 sums: the order of the adds differs
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=0)
            continue
        np.testing.assert_array_equal(g, w1, err_msg=f"output {i}")
        keep = ~np.isnan(w1)
        np.testing.assert_array_equal(g[keep], w[keep], err_msg=f"output {i}")
    if has_val:
        assert np.isnan(got[3]).any() and np.isinf(got[4]).any()
        assert not np.isnan(np.asarray(want[3])).any()  # the reference's mesh pmin dropped them


def _both(fixture_db, rmesh):  # noqa: F811
    ref, metas = fixture_db
    ref._mesh = rmesh
    port = TempoDB(TempoDBConfig(), backend=LocalBackend(ref.backend.path), device="cpu")
    port.poll_now()
    return port, ref


def _same_series(got, want):
    assert set(got.series) == set(want.series)
    for k, state in want.series.items():
        assert set(got.series[k]) == set(state)
        for f, arr in state.items():
            if f in ("count", "vcnt"):
                np.testing.assert_array_equal(got.series[k][f], arr, err_msg=f"{k} {f}")
            else:
                np.testing.assert_allclose(got.series[k][f], arr, rtol=1e-5, err_msg=f"{k} {f}")
    assert got.inspected_spans == want.inspected_spans


@pytest.mark.parametrize("query", MESH_QUERIES)
def test_metrics_query_range_on_mesh_matches_reference(meshes, fixture_db, query):  # noqa: F811
    mesh, rmesh = meshes
    port, ref = _both(fixture_db, rmesh)
    assert port.mesh is mesh
    req = _req(query)
    got = port.metrics_query_range("t", ME.MetricsRequest(req.query, req.start_ms, req.end_ms,
                                                          req.step_ms))
    want = ref.metrics_query_range("t", req)
    _same_series(got, want)


def _mesh_routes(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if k[0] == "metrics_mesh"}


def test_fallback_reasons_match_reference(meshes, fixture_db):  # noqa: F811
    mesh, rmesh = meshes
    port, ref = _both(fixture_db, rmesh)
    for query, step in ROUTES:
        p0, r0 = _mesh_routes(BX.routing_counts()), _mesh_routes(TEL.routing_counts())
        got = port.metrics_query_range("t", ME.align_params(query, BASE_S, BASE_S + 40, step))
        want = ref.metrics_query_range("t", _req(query, step_s=step))
        _same_series(got, want)
        p1, r1 = _mesh_routes(BX.routing_counts()), _mesh_routes(TEL.routing_counts())
        dp = {k: v - p0.get(k, 0) for k, v in p1.items() if v != p0.get(k, 0)}
        dr = {k: v - r0.get(k, 0) for k, v in r1.items() if v != r0.get(k, 0)}
        assert dp == dr and dp, (query, dp, dr)
