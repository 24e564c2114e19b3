"""Time K3 (the block find) and B7b (the live find) of one checkout of
the PyTorch/CUDA port on the card, so that two trees can be held
against each other on the same machine:

    python3 scripts/find_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version, and prints one JSON line:

- k3: kernels.find_rows on a (1, 32,768, 4) stack of sorted random ids
  with 48 present and 16 absent queries padded to their bucket (1,024
  rows): the stacked number of chip_smoke.py's K3 line (phase 4's shape);
- k3_wrapper: the wrapper the find path calls, at the path's shape (one
  block, one present id): kernels.find_rows on the id padded to 1,024
  rows where the tree has no kernels.find_blocks, else
  kernels.find_blocks on the block's own index and the one id (what
  chip_smoke.py's K3 row times);
- k3_path: ops/find.lookup_ids_blocks_cached on that block and id, its
  index already cached on the card (the call phase 5 makes a find);
- b7b: kernels.live_find over 16,384 live slots (random ids, 80 %
  alive, the query at slot 5,461), the query as the tree's wrapper
  takes it (a (4,) tensor on the card, or 4 ints);
- b7b_path: ops/livestage.find_slot_device on those slots (the call
  phase 13 makes a device-route find).

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 50
back-to-back calls, the host's path or the card's, whichever is slower),
`device_ms`, the card's time a call (chip_smoke.device_ms: 20 calls
queued behind a sleep kernel), and `grids`, the `__global__` launches of
one call (kernels.grid_launches). For a path call: `ms` on the host
clock, each call ending in its read-back (chip_smoke.host_ms: the median
of 7 means of 40 calls).

With --host, `host_us` adds the host's µs a call, 3,000 calls each with
no synchronisation, of the three wrappers and of the steps around a
find: `torch.empty` of a (1,) result, the upload of a (4,) query from a
pageable tensor (what the live find's path did before it took the codes
as ints), and the read-backs `.item()` of a (1,) result and `.cpu()` of
a (1, 1) one (500 calls each, as each waits for the card). Needs one
NVIDIA card."""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

N_IDS, N_SLOTS, Q_BUCKET = 1 << 15, 1 << 14, 1024
PAD_I32 = -(2**31)


def host_us(torch, fn, reps: int = 3000) -> float:
    """Host µs a call over reps calls, none waiting for the card."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn, reps=50), "device_ms": device_ms(fn), "grids": grids}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=12)
    ap.add_argument("--host", action="store_true", help="add the host's µs of each step")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("find_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block import schema as S
    from tempo_tpu_torch.ops import find as FD
    from tempo_tpu_torch.ops import livestage as L

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    out = {"tree": args.tree, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    # K3: one block's sorted index, as the block writer sorts it
    a = rng.integers(-(2**31), 2**31 - 1, (N_IDS, 4), dtype=np.int64).astype(np.int32)
    a = a[np.lexsort(a.T[::-1])]
    steps = N_IDS.bit_length()
    ids1 = torch.from_numpy(a[None]).to(dev)
    nv1 = torch.tensor([N_IDS], dtype=torch.int32, device=dev)
    absent = rng.integers(-(2**31), 2**31 - 1, (16, 4), dtype=np.int64).astype(np.int32)
    qcodes = np.concatenate([a[rng.integers(0, N_IDS, 48)], absent])
    qs = np.full((Q_BUCKET, 4), PAD_I32, np.int32)
    qs[:64] = qcodes
    qs = torch.from_numpy(qs).to(dev)
    got = kernels.find_rows(ids1, qs, nv1, steps)
    if not torch.equal(got, FD._bisect_plain(ids1, qs, nv1, steps)) or \
            int((got[0, :48] >= 0).sum()) != 48:
        raise AssertionError("K3 differs from its plain version or misses a present id")
    out["k3"] = timed(kernels, lambda: kernels.find_rows(ids1, qs, nv1, steps))

    blk = types.SimpleNamespace(trace_index={"trace.id_codes": a})
    q1 = np.ascontiguousarray(a[5:6])
    if int(FD.lookup_ids_blocks_cached([blk], q1, dev)[0, 0]) != 5:
        raise AssertionError("K3's path call misses row 5")
    if hasattr(kernels, "find_blocks"):
        per = [FD._device_ids(blk, dev)]

        def k3_wrapper():
            return kernels.find_blocks(per, q1, steps)
    else:
        q1_dev = torch.full((Q_BUCKET, 4), PAD_I32, dtype=torch.int32, device=dev)
        q1_dev[0] = torch.from_numpy(q1[0])

        def k3_wrapper():
            return kernels.find_rows(ids1, q1_dev, nv1, steps)
    if int(k3_wrapper()[0, 0]) != 5:
        raise AssertionError("K3's wrapper at the path's shape misses row 5")
    out["k3_wrapper"] = timed(kernels, k3_wrapper)
    out["k3_path"] = {"ms": host_ms(lambda: FD.lookup_ids_blocks_cached([blk], q1, dev))}

    # B7b: the live head's slots
    codes = rng.integers(-(2**31), 2**31 - 1, (N_SLOTS, 4), dtype=np.int64).astype(np.int32)
    alive = (rng.random(N_SLOTS) < 0.8).astype(np.int32)
    row = N_SLOTS // 3
    alive[row] = 1
    snap = types.SimpleNamespace(dev={"id_codes": torch.from_numpy(codes).to(dev),
                                      "alive": torch.from_numpy(alive).to(dev)},
                                 n_slots=N_SLOTS)
    d, q = snap.dev, [int(c) for c in codes[row]]
    if "codes" in inspect.signature(kernels.live_find).parameters:
        def b7b():
            return kernels.live_find(d["id_codes"], d["alive"], q, N_SLOTS)
    else:
        q_dev = torch.tensor(q, dtype=torch.int32, device=dev)

        def b7b():
            return kernels.live_find(d["id_codes"], d["alive"], q_dev, N_SLOTS)
    want = L._live_find_plain(d["id_codes"], d["alive"],
                              torch.tensor(q, dtype=torch.int32, device=dev), N_SLOTS)
    if not torch.equal(b7b(), want) or int(want.item()) != row:
        raise AssertionError("B7b differs from its plain version or misses its slot")
    out["b7b"] = timed(kernels, b7b)
    tid = S.codes_to_trace_id(q)
    if L.find_slot_device(snap, tid) != row:
        raise AssertionError("B7b's path call misses its slot")
    out["b7b_path"] = {"ms": host_ms(lambda: L.find_slot_device(snap, tid))}
    if args.host:
        q_cpu = torch.tensor(q, dtype=torch.int32)
        r1, r11 = (torch.zeros(s, dtype=torch.int32, device=dev) for s in ((1,), (1, 1)))
        out["host_us"] = {
            "k3_wrapper": host_us(torch, k3_wrapper),
            "k3 stacked": host_us(torch, lambda: kernels.find_rows(ids1, qs, nv1, steps)),
            "b7b": host_us(torch, b7b),
            "torch.empty (1,)": host_us(torch, lambda: torch.empty(1, dtype=torch.int32,
                                                                   device=dev)),
            "upload (4,)": host_us(torch, lambda: q_cpu.to(dev)),
            ".item() (1,)": host_us(torch, r1.item, reps=500),
            ".cpu() (1, 1)": host_us(torch, r11.cpu, reps=500)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
