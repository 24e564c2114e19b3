"""The device mesh over torch.distributed (port of tempo_tpu/parallel/mesh.py).

The reference builds a jax.sharding.Mesh with axes ('dp', 'sp') over its
visible devices and runs shard_map programs from ONE host process. The
port keeps that single-controller model over a process group:

  * rank 0 is the controller. It owns the TempoDB, the batchers and the
    host entries (parallel/find.py, bloom.py, multiquery.py,
    timeseries.py, search.py, step.py), with the reference's signatures;
  * every other rank is a follower running `follow(mesh)`: for each
    program it waits for the controller's signal in the store, receives
    a small header by broadcast_object_list (the program's name, its
    static parameters and its operands' specs, or a stop), receives its
    shards by scatter or broadcast as the specs say, runs the program's
    body (its kernels) and joins the body's collectives;
  * one body for both roles: the controller sends the header, then runs
    the same body as the followers and keeps the result;
  * one program at a time: DISPATCH_LOCK serializes programs on the
    controller (two batcher leaders must never interleave headers).

Rank r sits at (r // sp, r % sp), so the flattened (dp, sp) shard index
of the reference (parallel/find.py:52-53) is the rank. An NCCL mesh runs
its collectives on card tensors. A gloo mesh copies kernel outputs to
the host, runs the collective there and copies the result back: the
kernels still run on the mesh's device. No collective uses a bitwise-OR
reduction (NCCL has none): the bloom union gathers and ORs with B10a.

Faults: every collective waits with the process group's timeout; a rank
whose body raises records the error under `mesh/err/<rank>` in the
store, and every other rank polls the store while it waits, so a fault
surfaces on the controller as a MeshError naming the rank well before
the timeout. A mesh that saw a fault is broken: every later program
raises, and `parallel/launch.shutdown` joins and kills the followers.
"""

from __future__ import annotations

import os
import threading
import time
import traceback
from collections import Counter
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# Two host threads dispatching collective programs at once would
# interleave their headers and collectives and hang the mesh (the
# reference's DISPATCH_LOCK, tempo_tpu/parallel/mesh.py:18): every host
# entry runs its program under this lock.
DISPATCH_LOCK = threading.Lock()

DEFAULT_TIMEOUT_S = 300.0
_POLL_S = 0.0002  # spin between completion checks of a collective
_STORE_POLL_S = 0.02  # store reads for other ranks' faults while waiting

# program name -> body(mesh, static, ops) -> result (the controller's)
PROGRAMS: dict = {}


class MeshError(RuntimeError):
    """A rank of the mesh failed, the mesh timed out, or it is broken."""


def program(name: str):
    """Register a mesh program body under `name` (import time, on every
    rank: followers import the same modules)."""

    def deco(fn):
        PROGRAMS[name] = fn
        return fn

    return deco


def _factor(n: int) -> tuple[int, int]:
    """(dp, sp) with dp*sp == n, dp the largest divisor <= sqrt(n)."""
    dp = 1
    d = 1
    while d * d <= n:
        if n % d == 0:
            dp = d
        d += 1
    return dp, n // dp


def resolve_shape(n: int, dp: int | None = None, sp: int | None = None) -> tuple[int, int]:
    """The reference's make_mesh arithmetic: near-square by default."""
    if dp is None and sp is None:
        dp, sp = _factor(n)
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp*sp ({dp}*{sp}) != mesh size ({n})")
    return dp, sp


def _wire(t: torch.Tensor) -> torch.Tensor:
    """Transport form: bools travel as uint8."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


class _Waiter:
    """A work whose completion can be polled, for one that never reports
    it: gloo's reduce_scatter work stays is_completed() False and its
    wait() ignores a timeout (torch 2.13). A daemon thread blocks in
    wait() and records its end or its error; Mesh._wait polls this
    object like any other work, watching the store between polls."""

    def __init__(self, work):
        self._work, self._err = work, None
        self._done = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        try:
            self._work.wait()
        except BaseException as e:  # re-raised on the polling thread
            self._err = e
        finally:
            self._done.set()

    def is_completed(self) -> bool:
        return self._done.is_set()

    def wait(self) -> None:
        self._done.wait()
        if self._err is not None:
            raise self._err


class Mesh:
    """A (dp, sp) mesh of ranks over the default process group, or a 1x1
    mesh with no group. `device` is this rank's device."""

    def __init__(self, dp: int, sp: int, device: torch.device, store=None,
                 timeout_s: float = DEFAULT_TIMEOUT_S):
        self.dp, self.sp = dp, sp
        self.size = dp * sp
        self.device = torch.device(device)
        self.grouped = dist.is_available() and dist.is_initialized()
        if self.grouped and dist.get_world_size() != self.size:
            raise MeshError(f"{dp}x{sp} mesh over a world of {dist.get_world_size()}")
        if not self.grouped and self.size != 1:
            raise MeshError(f"a {dp}x{sp} mesh needs a process group")
        self.rank = dist.get_rank() if self.grouped else 0
        self.coords = (self.rank // sp, self.rank % sp)
        self.backend = dist.get_backend() if self.grouped else None
        self.store = store
        self.timeout_s = timeout_s
        self.broken: str | None = None
        self._seq = 0
        # seconds on the host clock (gloo) or CUDA events (nccl) per
        # collective kind, and calls, for chip_smoke's table
        self.seconds: Counter = Counter()
        self.calls: Counter = Counter()
        self._events: list = []
        self.dp_group = self.sp_group = None
        if self.grouped:
            # new_group is collective: every rank builds every subgroup in
            # the same order and keeps its own
            to = timedelta(seconds=timeout_s)
            for d in range(dp):
                g = dist.new_group([d * sp + s for s in range(sp)], timeout=to)
                if self.coords[0] == d:
                    self.sp_group = g
            for s in range(sp):
                g = dist.new_group([d * sp + s for d in range(dp)], timeout=to)
                if self.coords[1] == s:
                    self.dp_group = g
            if self.backend == "nccl":
                # NCCL builds a group's communicator at its first
                # collective: build them here, outside every timed one
                x = torch.zeros(1, device=self.device)
                for g in (None, self.dp_group, self.sp_group):
                    dist.all_reduce(x, group=g)
                torch.cuda.synchronize(self.device)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, "sp": self.sp}

    def _group(self, axis: str | None):
        return {None: None, "dp": self.dp_group, "sp": self.sp_group}[axis]

    def _axis_size(self, axis: str | None) -> int:
        return {None: self.size, "dp": self.dp, "sp": self.sp}[axis]

    # ------------------------------------------------------------ faults
    def _fail(self, reason: str) -> None:
        self.broken = self.broken or reason
        if self.store is not None:
            self.store.set(f"mesh/err/{self.rank}", reason.encode())
            self.store.add("mesh/errs", 1)

    def failed_ranks(self) -> dict[int, str]:
        """Ranks that recorded a fault, with their messages."""
        if self.store is None or self.store.add("mesh/errs", 0) == 0:
            return {}
        out = {}
        for r in range(self.size):
            key = f"mesh/err/{r}"
            if self.store.check([key]):
                out[r] = self.store.get(key).decode(errors="replace")
        return out

    def _raise_if_failed(self) -> None:
        failed = {r: m for r, m in self.failed_ranks().items() if r != self.rank}
        if failed:
            r = min(failed)
            raise MeshError(f"mesh rank {r} failed: {failed[r]}")

    def _wait(self, work, kind: str, mark=None) -> None:
        """Wait for an async collective, watching the store for other
        ranks' faults; MeshError on a fault or past the timeout. With
        `mark` (NCCL), work.wait() comes first: it only makes the current
        stream wait for NCCL's stream, and mark() records the end event
        there before the host polls for completion."""
        t_end = time.monotonic() + self.timeout_s
        next_check = 0.0
        try:
            if mark is not None:
                work.wait()
                mark()
            while not work.is_completed():
                now = time.monotonic()
                if now >= next_check:
                    self._raise_if_failed()
                    next_check = now + _STORE_POLL_S
                if now > t_end:
                    raise MeshError(f"mesh {kind} timed out after {self.timeout_s} s")
                time.sleep(_POLL_S)
            if mark is None:
                work.wait()
        except RuntimeError as e:
            if isinstance(e, MeshError):
                raise
            self._raise_if_failed()
            raise MeshError(f"mesh {kind} failed on rank {self.rank}: {e}") from e

    def _timed(self, kind: str, launch):
        """Run one collective: `launch()` issues it async and returns the
        work. NCCL is timed by CUDA events on the current stream, the end
        event recorded once that stream waits for NCCL's; gloo by the host
        clock around the wait."""
        self.calls[kind] += 1
        if self.backend == "nccl":
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            self._wait(launch(), kind, mark=ev1.record)
            self._events.append((kind, ev0, ev1))
            return
        t0 = time.perf_counter()
        work = launch()
        self._wait(work, kind)
        self.seconds[kind] += time.perf_counter() - t0

    def collective_seconds(self) -> dict[str, float]:
        """Seconds spent in each collective kind so far (NCCL's events
        are read here, after a synchronize)."""
        if self._events:
            torch.cuda.synchronize(self.device)
            for kind, ev0, ev1 in self._events:
                self.seconds[kind] += ev0.elapsed_time(ev1) / 1e3
            self._events.clear()
        return dict(self.seconds)

    # ------------------------------------------------------- collectives
    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend's collective runs on: the card tensor
        itself for NCCL, a host copy for gloo."""
        t = _wire(t).contiguous()
        if self.backend == "nccl":
            return t.to(self.device)
        if t.device.type == "cpu":
            return t
        t0 = time.perf_counter()
        h = t.cpu()
        self.seconds["copy"] += time.perf_counter() - t0
        return h

    def _back(self, h: torch.Tensor, like_dtype: torch.dtype) -> torch.Tensor:
        if h.device == self.device and h.dtype == like_dtype:
            return h
        t0 = time.perf_counter()
        out = h.to(self.device).to(like_dtype)
        self.seconds["copy"] += time.perf_counter() - t0
        return out

    def all_reduce(self, t: torch.Tensor, op: str, axis: str | None = None) -> torch.Tensor:
        """Reduce t over the world (axis None) or one mesh axis; op is
        "sum", "min" or "max". Returns a new tensor on the mesh device."""
        if not self.grouped:
            return t
        rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
        c = self._comm(t)
        if c.data_ptr() == t.data_ptr():  # reduce into a copy, never the caller's tensor
            c = c.clone()
        self._timed("all_reduce", lambda: dist.all_reduce(c, rop, group=self._group(axis),
                                                          async_op=True))
        return self._back(c, t.dtype)

    def all_gather(self, t: torch.Tensor, axis: str | None = None,
                   dim: int | None = None) -> torch.Tensor:
        """(n, *t.shape): every rank's t over the world or one axis, in
        rank order; with `dim`, the parts concatenated along that dim
        instead (the reference's all_gather(..., tiled=True))."""
        n = self._axis_size(axis)
        if not self.grouped:
            return t[None] if dim is None else t
        c = self._comm(t).reshape((-1,) + tuple(t.shape[1:]))  # at least 1-D
        out = torch.empty((n * c.shape[0],) + tuple(c.shape[1:]), dtype=c.dtype, device=c.device)
        self._timed("all_gather", lambda: dist.all_gather_into_tensor(
            out, c, group=self._group(axis), async_op=True))
        out = out.view((n,) + tuple(t.shape))
        if dim is not None:
            shape = list(t.shape)
            shape[dim] *= n
            out = out.movedim(0, dim).reshape(shape)
        return self._back(out, t.dtype)

    def reduce_scatter(self, t: torch.Tensor, op: str, axis: str = "sp",
                       dim: int = 1) -> torch.Tensor:
        """Reduce t over one mesh axis and keep this rank's slice along
        `dim`: the rank at index k of the axis gets the reduced slice
        [k * m, (k + 1) * m), m = t.shape[dim] / n (the reference's
        psum_scatter(..., tiled=True)). The collective scatters along its
        first dim, so `dim` moves there and back. On gloo its work is
        polled through a _Waiter."""
        if not self.grouped:
            return t
        n = self._axis_size(axis)
        if t.shape[dim] % n:
            raise MeshError(f"reduce_scatter: dim {dim} ({t.shape[dim]}) does not split over {n}")
        rop = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}[op]
        c = self._comm(t.movedim(dim, 0).contiguous())
        out = torch.empty((c.shape[0] // n,) + tuple(c.shape[1:]), dtype=c.dtype, device=c.device)

        def launch():
            work = dist.reduce_scatter_tensor(out, c, rop, group=self._group(axis),
                                              async_op=True)
            return work if self.backend == "nccl" else _Waiter(work)

        self._timed("reduce_scatter", launch)
        return self._back(out.movedim(0, dim).contiguous(), t.dtype)

    def gather0(self, t: torch.Tensor) -> torch.Tensor | None:
        """Every rank's t, stacked in rank order on the controller (None
        on the followers)."""
        if not self.grouped:
            return t[None]
        c = self._comm(t)
        outs = ([torch.empty_like(c) for _ in range(self.size)] if self.rank == 0 else None)
        self._timed("gather", lambda: dist.gather(c, outs, dst=0, async_op=True))
        return self._back(torch.stack(outs), t.dtype) if self.rank == 0 else None

    # ----------------------------------------------------------- dispatch
    def _parts(self, kind: str, t: torch.Tensor) -> list[torch.Tensor]:
        """The per-rank parts of a scattered operand, in rank order."""
        if kind in ("shard0", "shard1"):
            return list(t.chunk(self.size, 0 if kind == "shard0" else 1))
        rows = t.chunk(self.dp, 0)
        if kind == "dp":
            return [rows[r // self.sp] for r in range(self.size)]
        return [rows[r // self.sp].chunk(self.sp, 1)[r % self.sp] for r in range(self.size)]

    def _recv_operands(self, specs: list, arrays: dict | None) -> dict[str, torch.Tensor]:
        """Each operand's local part on this rank's device: 'bcast' whole,
        'shard0' / 'shard1' this rank's equal slice along axis 0 / 1 of the
        flattened ranks, 'dp' its dp row's slice along axis 0, 'dpsp' its
        (dp, sp) tile of axes 0 and 1."""
        ops = {}
        for name, kind, shape, dtype in specs:
            dt = getattr(torch, dtype)
            wdt = torch.uint8 if dt == torch.bool else dt
            if not self.grouped:
                ops[name] = torch.as_tensor(arrays[name]).to(self.device).to(dt)
                continue
            dev = self.device if self.backend == "nccl" else torch.device("cpu")
            src = None
            if self.rank == 0:
                t0 = time.perf_counter()
                src = _wire(torch.as_tensor(arrays[name])).to(dev)
                self.seconds["copy"] += time.perf_counter() - t0
            if kind == "bcast":
                buf = src.contiguous() if src is not None else torch.empty(shape, dtype=wdt,
                                                                            device=dev)
                self._timed("broadcast", lambda: dist.broadcast(buf, src=0, async_op=True))
            else:
                local = self._parts(kind, torch.empty(shape, device="meta"))[self.rank].shape
                buf = torch.empty(local, dtype=wdt, device=dev)
                parts = ([c.contiguous() for c in self._parts(kind, src)]
                         if src is not None else None)
                self._timed("scatter", lambda: dist.scatter(buf, parts, src=0, async_op=True))
            ops[name] = self._back(buf, dt)
        return ops

    def _execute(self, header, arrays: dict | None):
        name, static, specs = header
        try:
            ops = self._recv_operands(specs, arrays)
            return PROGRAMS[name](self, static, ops)
        except BaseException as e:
            self._fail(f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=8)}")
            raise

    def run(self, name: str, static: dict, bcast: dict | None = None, shard0: dict | None = None,
            shard1: dict | None = None, dp: dict | None = None, dpsp: dict | None = None):
        """Controller: run program `name` on every rank with its operands
        (numpy arrays or tensors): `bcast` whole on every rank, `shard0` /
        `shard1` split in equal slices along axis 0 / 1 in rank order,
        `dp` split along axis 0 over the dp rows (the sp ranks of a row
        get the same slice), `dpsp` split along axis 0 over dp and axis 1
        over sp. The controller scatters a part to every rank, so an
        operand of kind `dp` crosses the wire sp times. Returns the body's
        result on this rank. Call under DISPATCH_LOCK."""
        if self.rank != 0:
            raise MeshError("only rank 0 dispatches mesh programs")
        if self.broken:
            raise MeshError(f"mesh is broken: {self.broken.splitlines()[0]}")
        splits = {"bcast": (), "shard0": ((0, self.size),), "shard1": ((1, self.size),),
                  "dp": ((0, self.dp),), "dpsp": ((0, self.dp), (1, self.sp))}
        arrays, specs = {}, []
        for kind, group in (("bcast", bcast), ("shard0", shard0), ("shard1", shard1), ("dp", dp),
                            ("dpsp", dpsp)):
            for k, a in (group or {}).items():
                t = torch.as_tensor(a)
                for axis, n in splits[kind]:
                    if t.shape[axis] % n:
                        raise MeshError(f"{name}: {k} axis {axis} ({t.shape[axis]}) does not "
                                        f"split over {n}")
                arrays[k] = t
                specs.append((k, kind, tuple(t.shape), str(t.dtype).split(".")[-1]))
        header = (name, static, specs)
        if self.grouped:
            self._signal(header)
        return self._execute(header, arrays)

    def _signal(self, header) -> None:
        """Wake the followers (a store key per program: idle followers wait
        on the store, never inside a collective that would time out),
        then broadcast the header."""
        self._seq += 1
        if self.store is not None:
            self.store.set(f"mesh/go/{self._seq}", b"1")
        t0 = time.perf_counter()
        try:
            dist.broadcast_object_list([header], src=0)
        except RuntimeError as e:
            self._fail(f"header broadcast: {e}")
            self._raise_if_failed()
            raise MeshError(f"mesh header broadcast failed: {e}") from e
        self.seconds["header"] += time.perf_counter() - t0
        self.calls["header"] += 1

    def stop(self) -> None:
        """Controller: tell the followers to leave their loops."""
        with DISPATCH_LOCK:
            if self.grouped and not self.broken and self.size > 1:
                self._signal(("stop", {}, []))


def follow(mesh: Mesh, parent_pid: int | None = None) -> None:
    """Follower loop: run every program the controller dispatches until a
    stop, a fault, or the controller's process is gone."""
    if mesh.store is None:
        raise MeshError("a follower needs the store")
    seq = 0
    while True:
        seq += 1
        key = f"mesh/go/{seq}"
        while True:
            try:
                mesh.store.wait([key], timedelta(seconds=1))
                break
            except RuntimeError:
                if parent_pid is not None and os.getppid() != parent_pid:
                    return  # the controller is gone
                if mesh.failed_ranks():
                    return
        box = [None]
        dist.broadcast_object_list(box, src=0)
        header = box[0]
        if header[0] == "stop":
            return
        mesh._execute(header, None)


_CURRENT: Mesh | None = None


def init_mesh(dp: int | None, sp: int | None, device, store, timeout_s: float) -> Mesh:
    """Build this process's mesh over the just-initialized default group
    (every rank calls it once, in the same order: subgroups are
    collective) and make it the one make_mesh() returns."""
    global _CURRENT
    dp, sp = resolve_shape(dist.get_world_size(), dp, sp)
    _CURRENT = Mesh(dp, sp, device, store=store, timeout_s=timeout_s)
    return _CURRENT


def clear_mesh() -> None:
    global _CURRENT
    _CURRENT = None


def make_mesh(dp: int | None = None, sp: int | None = None, device=None) -> Mesh:
    """The mesh for the sharded programs: the process group's mesh when
    one is initialized (parallel/launch.init_controller built it), else a
    1x1 mesh with no group. device None resolves to cuda:<local rank>
    and raises without a card."""
    if dist.is_available() and dist.is_initialized():
        if _CURRENT is None:
            raise MeshError("a process group without a mesh: start it with parallel/launch")
        if (dp, sp) != (None, None) and resolve_shape(_CURRENT.size, dp, sp) != \
                (_CURRENT.dp, _CURRENT.sp):
            raise MeshError(f"mesh is {_CURRENT.dp}x{_CURRENT.sp}, asked for {dp}x{sp}")
        return _CURRENT
    resolve_shape(1, dp, sp)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the mesh on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return Mesh(1, 1, device)


@program("probe")
def _probe(mesh: Mesh, static: dict, ops: dict):
    """The mesh's self-check: every rank reports (rank, dp index, sp index,
    pid, whether jax is loaded) to the controller; the rank named by
    static["fail_rank"] raises first (the fault path's test). With
    static["reduce_scatter"] the ranks first join a reduce_scatter over
    sp, the one collective whose gloo work is polled through a _Waiter."""
    import sys

    if static.get("fail_rank") == mesh.rank:
        raise RuntimeError(f"probe fault on rank {mesh.rank}")
    x = ops["x"]
    if static.get("reduce_scatter"):
        mesh.reduce_scatter(x.reshape(1, -1).repeat(1, mesh.sp), "sum")
    row = torch.tensor([mesh.rank, *mesh.coords, os.getpid(), int("jax" in sys.modules),
                        int(x.sum().item())], dtype=torch.int64)
    rows = mesh.gather0(row.to(mesh.device) if mesh.backend == "nccl" else row)
    return None if rows is None else rows.cpu().numpy()


def probe(mesh: Mesh, fail_rank: int | None = None, reduce_scatter: bool = False) -> np.ndarray:
    """(size, 6) int64 rows [rank, dp, sp, pid, jax loaded, sum of the
    rank's shard of arange(2 * size)], from every rank."""
    with DISPATCH_LOCK:
        return mesh.run("probe", {"fail_rank": fail_rank, "reduce_scatter": reduce_scatter},
                        shard0={"x": np.arange(2 * mesh.size, dtype=np.int64)})
