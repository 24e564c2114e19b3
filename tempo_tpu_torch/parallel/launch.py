"""Start and stop a mesh's processes: what stands for jax.devices() in
the port.

The reference sees every chip of its host from one process. The port's
mesh is a torch.distributed process group of `world` ranks: this
process becomes rank 0, the controller (`init_controller`), and
`spawn_followers` starts ranks 1 .. world - 1 as spawned processes that
build the same mesh and run `parallel/mesh.follow` until the controller
stops them. The rendezvous is a FileStore (`init_method="file://<path>"`:
no network, no fixed port, so many meshes can start side by side), and
every collective has the group's timeout. The children import the port
alone (never jax, never the JAX package).

    procs = spawn_followers(4, init, "gloo", "cpu")
    mesh = init_controller(4, init, "gloo", "cpu")
    ...  # TempoDB(...).mesh is now this 2x2 mesh
    shutdown(mesh, procs)

NCCL needs one card per rank; on one card the mesh runs NCCL at world
size 1 or gloo with every rank on that card.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist

from .mesh import DEFAULT_TIMEOUT_S, MeshError, clear_mesh, init_mesh


def _store_path(init_method: str) -> str:
    if not init_method.startswith("file://"):
        raise ValueError(f"init_method must be file://<path>, got {init_method!r}")
    return init_method[len("file://"):]


def _init(rank: int, world: int, init_method: str, backend: str, device, dp, sp,
          timeout_s: float):
    device = torch.device(device)
    if backend == "nccl":
        torch.cuda.set_device(device)
    store = dist.FileStore(_store_path(init_method), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return init_mesh(dp, sp, device, store, timeout_s)


def _follower_main(rank: int, world: int, init_method: str, backend: str, device: str,
                   dp, sp, timeout_s: float, parent_pid: int) -> None:
    from . import mesh as M  # the package's import registers every program body

    if torch.device(device).type == "cpu":  # ranks on one host share its cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    mesh = _init(rank, world, init_method, backend, device, dp, sp, timeout_s)
    try:
        M.follow(mesh, parent_pid)
    finally:
        clear_mesh()
        dist.destroy_process_group()


def spawn_followers(world: int, init_method: str, backend: str, device,
                    dp: int | None = None, sp: int | None = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Start ranks 1 .. world - 1 (spawned, daemonic) of a mesh whose
    controller this process becomes by init_controller with the same
    arguments. Returns the processes for shutdown()."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = []
    for rank in range(1, world):
        p = ctx.Process(target=_follower_main, daemon=True,
                        args=(rank, world, init_method, backend, str(device), dp, sp,
                              float(timeout_s), os.getpid()))
        p.start()
        procs.append(p)
    return procs


def init_controller(world: int, init_method: str, backend: str, device,
                    dp: int | None = None, sp: int | None = None,
                    timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join the mesh as rank 0 and return it (make_mesh() returns it too
    until shutdown)."""
    return _init(0, world, init_method, backend, device, dp, sp, timeout_s)


def shutdown(mesh, procs: list, join_timeout_s: float = 30.0) -> list[int]:
    """Stop the followers (a stop header unless the mesh is broken), join
    each within the timeout, kill the stragglers, and leave the process
    group. Returns the followers' exit codes (a killed one reads as
    negative)."""
    try:
        if mesh is not None:
            mesh.stop()
    except MeshError:
        pass  # a follower died: the joins below reap or kill the rest
    finally:
        codes = []
        for p in procs:
            p.join(join_timeout_s)
            if p.is_alive():
                p.kill()
                p.join(5.0)
            codes.append(p.exitcode)
        clear_mesh()
        if dist.is_initialized():
            dist.destroy_process_group()
    return codes
