"""The port's mesh runtime (parallel/mesh.py, parallel/launch.py) on the
CPU: the reference's (dp, sp) factoring, rank coordinates, the header
and shard protocol over spawned gloo ranks, the stop, a follower fault
that reaches the controller as a MeshError well inside the group's
timeout, followers that never import jax, and the 1x1 mesh without a
group."""

import time

import numpy as np
import pytest
import torch
from test_torch_mesh_cases import SHAPE_IDS, SHAPES, TIMEOUT_S

from tempo_tpu.parallel.mesh import _factor as r_factor
from tempo_tpu_torch.parallel import launch
from tempo_tpu_torch.parallel import mesh as M


def test_factor_matches_reference():
    for n in range(1, 65):
        assert M._factor(n) == r_factor(n), n
        assert M.resolve_shape(n) == r_factor(n)
    assert M.resolve_shape(8, sp=8) == (1, 8) and M.resolve_shape(8, dp=4) == (4, 2)
    with pytest.raises(ValueError):
        M.resolve_shape(6, dp=4)


def test_make_mesh_without_group_is_1x1():
    assert not torch.distributed.is_initialized()
    mesh = M.make_mesh(device="cpu")
    assert (mesh.size, mesh.shape, mesh.rank, mesh.coords) == (1, {"dp": 1, "sp": 1}, 0, (0, 0))
    assert mesh.backend is None and not mesh.grouped
    with pytest.raises(ValueError):
        M.make_mesh(dp=2, device="cpu")
    # with no group, a program runs its body locally on whole operands
    rows = M.probe(mesh)
    assert rows.tolist() == [[0, 0, 0, rows[0, 3], 1, 1]]  # this process has jax loaded


def test_make_mesh_device_none_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()


def test_nccl_end_event_follows_the_stream_wait(monkeypatch):
    """NCCL runs a collective on a stream of its own: the end event must
    be recorded after work.wait() has made the current stream wait for
    it, and before the host polls for completion."""
    order, made = [], []

    class Event:
        def __init__(self, enable_timing):
            self.name = f"ev{len(made)}"
            made.append(self)

        def record(self):
            order.append(f"record {self.name}")

        def elapsed_time(self, end):
            return 2.5

    class Work:
        def wait(self):
            order.append("wait")

        def is_completed(self):
            order.append("poll")
            return True

    def launch():
        order.append("launch")
        return Work()

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    mesh = M.make_mesh(device="cpu")
    mesh.backend = "nccl"
    mesh._timed("all_reduce", launch)
    assert order == ["record ev0", "launch", "wait", "record ev1", "poll"]
    assert mesh.collective_seconds() == {"all_reduce": 0.0025}
    assert mesh.calls["all_reduce"] == 1


def test_waiter_polls_a_work_that_never_reports_completion(monkeypatch):
    """gloo's reduce_scatter work stays is_completed() False and blocks in
    wait(): through a _Waiter the wait loop still watches the store, so a
    fault recorded by another rank surfaces at once, and a finished
    work's error reaches the caller."""
    import threading

    release = threading.Event()

    class Work:
        def __init__(self, err=None):
            self.err = err

        def is_completed(self):
            return False

        def wait(self):
            release.wait()
            if self.err:
                raise self.err

    mesh = M.make_mesh(device="cpu")
    monkeypatch.setattr(mesh, "failed_ranks", lambda: {1: "boom"})
    t0 = time.monotonic()
    with pytest.raises(M.MeshError, match="rank 1 failed: boom"):
        mesh._wait(M._Waiter(Work()), "reduce_scatter")
    assert time.monotonic() - t0 < 1.0
    monkeypatch.setattr(mesh, "failed_ranks", lambda: {})
    release.set()
    mesh._wait(M._Waiter(Work()), "reduce_scatter")
    with pytest.raises(M.MeshError, match="reduce_scatter failed on rank 0: lost"):
        mesh._wait(M._Waiter(Work(RuntimeError("lost"))), "reduce_scatter")


def _start(shape, tmp_path):
    dp, sp = shape
    init = f"file://{tmp_path}/pg"
    procs = launch.spawn_followers(dp * sp, init, "gloo", "cpu", dp=dp, sp=sp,
                                   timeout_s=TIMEOUT_S)
    return launch.init_controller(dp * sp, init, "gloo", "cpu", dp=dp, sp=sp,
                                  timeout_s=TIMEOUT_S), procs


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_header_protocol_coords_and_stop(shape, tmp_path):
    mesh, procs = _start(shape, tmp_path)
    try:
        assert M.make_mesh() is mesh and M.make_mesh(dp=shape[0]) is mesh
        assert (mesh.dp, mesh.sp, mesh.rank, mesh.coords, mesh.backend) == \
            (*shape, 0, (0, 0), "gloo")
        for _ in range(3):  # several programs: the header sequence advances
            rows = M.probe(mesh)
        n = mesh.size
        assert rows[:, 0].tolist() == list(range(n))
        assert [tuple(r) for r in rows[:, 1:3]] == [(r // shape[1], r % shape[1])
                                                   for r in range(n)]
        assert len(set(rows[:, 3])) == n  # one process a rank
        assert rows[1:, 4].tolist() == [0] * (n - 1), "a follower imported jax"
        # rank r received shard r of arange(2n): [2r, 2r + 1]
        assert rows[:, 5].tolist() == [4 * r + 1 for r in range(n)]
        assert mesh.calls["header"] == 3 and mesh.calls["scatter"] == 3
        with pytest.raises(M.MeshError, match="does not split"):
            with M.DISPATCH_LOCK:
                mesh.run("probe", {}, shard0={"x": np.zeros(2 * n + 1)})
    finally:
        t0 = time.monotonic()
        codes = launch.shutdown(mesh, procs, join_timeout_s=TIMEOUT_S)
    assert codes == [0] * (mesh.size - 1)  # every follower left its loop on the stop
    assert time.monotonic() - t0 < TIMEOUT_S
    assert not torch.distributed.is_initialized()
    assert M.make_mesh(device="cpu").size == 1


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_follower_fault_surfaces_as_mesh_error(shape, tmp_path):
    mesh, procs = _start(shape, tmp_path)
    bad = mesh.size - 1
    try:
        M.probe(mesh)
        t0 = time.monotonic()
        with pytest.raises(M.MeshError, match=f"rank {bad} failed.*probe fault"):
            M.probe(mesh, fail_rank=bad)
        assert time.monotonic() - t0 < TIMEOUT_S / 4
        assert mesh.broken
        with pytest.raises(M.MeshError, match="broken"):
            M.probe(mesh)
    finally:
        t0 = time.monotonic()
        codes = launch.shutdown(mesh, procs, join_timeout_s=TIMEOUT_S)
    assert codes[bad - 1] not in (0, None)
    assert time.monotonic() - t0 < TIMEOUT_S + 10


def test_follower_fault_before_reduce_scatter_surfaces_as_mesh_error(tmp_path):
    """A follower of the controller's sp row fails before it joins a
    reduce_scatter: the controller, waiting in it, raises MeshError well
    inside the group's timeout."""
    mesh, procs = _start((1, 2), tmp_path)
    try:
        rows = M.probe(mesh, reduce_scatter=True)
        assert rows[:, 0].tolist() == [0, 1] and mesh.calls["reduce_scatter"] == 1
        t0 = time.monotonic()
        with pytest.raises(M.MeshError, match="rank 1 failed.*probe fault"):
            M.probe(mesh, fail_rank=1, reduce_scatter=True)
        assert time.monotonic() - t0 < TIMEOUT_S / 4
        assert mesh.broken
    finally:
        codes = launch.shutdown(mesh, procs, join_timeout_s=TIMEOUT_S)
    assert codes[0] not in (0, None)
