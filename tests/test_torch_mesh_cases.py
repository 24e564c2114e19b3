"""Shared mesh set-up for the port's mesh tests: a gloo process group of
spawned follower ranks on the CPU, this process its controller, and the
reference's shard_map mesh of the same (dp, sp) on the virtual CPU
devices tests/conftest.py forces. Holds no tests."""

import time

from tempo_tpu.parallel import make_mesh as r_make_mesh
from tempo_tpu_torch.parallel import launch

# (dp, sp): world 2 both ways, and world 4
SHAPES = [(1, 2), (2, 1), (2, 2)]
SHAPE_IDS = ["1x2", "2x1", "2x2"]
TIMEOUT_S = 60.0  # every process group's collective timeout


def start_mesh(shape, tmp_path_factory):
    """Generator for a module fixture: yields (port mesh, reference mesh)
    and stops the followers afterwards; a mesh that stayed sound must
    see every follower leave with code 0."""
    dp, sp = shape
    world = dp * sp
    init = f"file://{tmp_path_factory.mktemp('mesh')}/pg"
    procs = launch.spawn_followers(world, init, "gloo", "cpu", dp=dp, sp=sp, timeout_s=TIMEOUT_S)
    mesh = launch.init_controller(world, init, "gloo", "cpu", dp=dp, sp=sp, timeout_s=TIMEOUT_S)
    try:
        yield mesh, r_make_mesh(n_devices=world, dp=dp, sp=sp)
    finally:
        broken = mesh.broken
        t0 = time.monotonic()
        codes = launch.shutdown(mesh, procs, join_timeout_s=TIMEOUT_S)
        if not broken:
            assert codes == [0] * (world - 1), codes
            assert time.monotonic() - t0 < TIMEOUT_S
