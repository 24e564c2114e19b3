"""Time M5 (the sharded attr-leaf count) and B7a (the live filter) of one
checkout of the PyTorch/CUDA port on the card, so that two trees can be
held against each other on the same machine:

    python3 scripts/attr_live_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version, and prints one JSON line:

- m5_str, m5_any: kernels.attr_partial at phase 15's shape (10 blocks,
  1,048,576 owners a block, 2,097,152 attr rows a block, 0-4 rows an
  owner, about 2), a `span.<str> = ...` leaf whose key is 1 % of the
  rows, and the `any` leaf of the same key (the count only: not the
  mask after the collective);
- b7a_1, b7a_3, b7a_33: kernels.live_filter over the live head's shape
  (16,384 slots, 80 % alive; 2^21 kv rows of which 1,146,880 real and
  2^19 name rows of which 409,600 real, padded with owner 0 and code
  PAD_I32 as the stager pads them) with 1, 3 (two tags and a name, the
  window and min-duration prefilters on: chip_smoke.py's B7a row) and
  33 codes (two chunks), the codes as the tree's wrapper takes them (a
  tensor on the card, or ints with the real row counts);
- b7a_path: ops/livestage.eval_live_device of the 3-code search on a
  snapshot of those columns, then a synchronise (the call phase 13 makes
  for each live search).

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 20
back-to-back calls), `device_ms`, the card's time a call
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel), and
`grids`, the `__global__` launches of one call (kernels.grid_launches).
For the path call: `ms` on the host clock (chip_smoke.host_ms: the
median of 7 means of 40 calls). Needs one NVIDIA card."""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

BL, N_OWN, AL = 10, 1 << 20, 1 << 21
SLOT_B, KV_B, NAME_B, N_KV, N_NAME = 1 << 14, 1 << 21, 1 << 19, 1_146_880, 409_600
PAD_I32 = -(2**31)


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids}


def m5_shard(torch, F, MS, stack, rng, dev):
    """One rank's shard at sp = 1 holding phase 15's 10 blocks: span attr
    rows grouped by owner, a `str` leaf (0) and an `any` leaf (1) on key 7."""
    off = np.zeros((BL, N_OWN + 1), np.int64)
    off[:, 1:] = np.cumsum(rng.integers(0, 5, (BL, N_OWN)), axis=1)
    off = np.minimum(off, AL).astype(np.int32)
    key = rng.integers(0, 100, (BL, AL)).astype(np.int32)
    vt = rng.integers(0, 2, (BL, AL)).astype(np.int32)
    sid = rng.integers(0, 50, (BL, AL)).astype(np.int32)
    for b in range(BL):
        key[b, off[b, -1]:] = PAD_I32
    cols = {"span.trace_sid": np.zeros((BL, N_OWN), np.int32), "sattr.off": off,
            "sattr.key_id": key, "sattr.vtype": vt, "sattr.str_id": sid}
    cols = {n: torch.from_numpy(a).to(dev) for n, a in cols.items()}
    conds = (F.Cond("sattr", "str", "eq"), F.Cond("sattr", "any", "exists"))
    ints, floats, tabs = stack(F.Operands.build([(7, 3, 0, 0.0, 0.0), (7, 0, 0, 0.0, 0.0)]),
                               BL, 2)
    tree = F.normalize_tree(("or", ("cond", 0), ("cond", 1)), conds)
    return MS.ShardSearch(tree, conds, cols, ints, floats, tabs, [N_OWN] * BL, 0, 1)


def live_cols(torch, rng, dev):
    slots = [rng.integers(0, 1000, SLOT_B), rng.integers(0, 1000, SLOT_B),
             rng.integers(0, 5000, SLOT_B), rng.random(SLOT_B) < 0.8]
    slots = tuple(torch.from_numpy(c.astype(np.int32)).to(dev) for c in slots)
    rows = []
    for nb, n, n_codes in ((KV_B, N_KV, 200_000), (NAME_B, N_NAME, 512)):
        owner = np.zeros(nb, np.int32)
        code = np.full(nb, PAD_I32, np.int32)
        owner[:n] = rng.integers(0, SLOT_B, n)
        code[:n] = rng.integers(0, n_codes, n)
        rows.append((torch.from_numpy(owner).to(dev), torch.from_numpy(code).to(dev)))
    return slots, rows[0], rows[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=13)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attr_live_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import livestage as L
    from tempo_tpu_torch.ops import meshsearch as MS
    from tempo_tpu_torch.parallel.search import _stack_operands

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

    # M5
    sh = m5_shard(torch, F, MS, _stack_operands, rng, dev)
    for i, name in ((0, "m5_str"), (1, "m5_any")):
        def m5(i=i):
            return kernels.attr_partial(sh.descs, i, N_OWN, AL, 0)

        want = MS._attr_partial_plain(sh.conds[i], sh.cols, sh.ops_i, sh.ops_f, i, None, 0)
        if not torch.equal(m5(), want) or int(want.sum()) == 0:
            raise AssertionError(f"M5 {name} differs from its plain version or counts nothing")
        out[name] = timed(kernels, m5)
    del sh

    # B7a
    slots, kv, nm = live_cols(torch, rng, dev)
    s = SLOT_B // 3
    kv_c, nm_c = kv[1][:N_KV][kv[0][:N_KV] == s], nm[1][:N_NAME][nm[0][:N_NAME] == s]
    tags, names = [int(c) for c in kv_c[:2].tolist()], [int(nm_c[0])]
    for col, v in zip(slots, (100, 500, 1000, 1)):  # slot s passes the 3-code case's prefilters
        col[s] = v
    new_api = "n_kv" in inspect.signature(kernels.live_filter).parameters
    cases = {"b7a_1": (tags[:1], [], None, None, None),
             "b7a_3": (tags, names, 10, 900, 100),
             "b7a_33": ([int(c) for c in range(20)], [int(c) for c in range(13)], None, None,
                        None)}
    for name, (tg, nms, t0, t1, dmin) in cases.items():
        q = torch.tensor(tg + nms, dtype=torch.int32)
        if new_api:
            def b7a(tg=tg, nms=nms, t0=t0, t1=t1, dmin=dmin):
                return kernels.live_filter(slots, kv, nm, tg + nms, len(tg), t0, t1, dmin, SLOT_B,
                                           N_KV, N_NAME)
        else:
            q_dev = q.to(dev)

            def b7a(q_dev=q_dev, tg=tg, t0=t0, t1=t1, dmin=dmin):
                return kernels.live_filter(slots, kv, nm, q_dev, len(tg), t0, t1, dmin, SLOT_B)
        want = L._live_filter_plain(slots, kv, nm, q.to(dev), len(tg), t0, t1, dmin, SLOT_B)
        if not torch.equal(b7a(), want) or (name != "b7a_33" and not bool(want[s])):
            raise AssertionError(f"B7a {name} differs from its plain version or misses its slot")
        out[name] = timed(kernels, b7a)
    snap = types.SimpleNamespace(
        dev={"start_s": slots[0], "end_s": slots[1], "dur_ms": slots[2], "alive": slots[3],
             "kv_owner": kv[0], "kv_code": kv[1], "name_owner": nm[0], "name_code": nm[1]},
        n_slots=SLOT_B, n_kv=N_KV, n_name=N_NAME, slot_b=SLOT_B, kv_b=KV_B, name_b=NAME_B)

    def path():
        m = L.eval_live_device(snap, tags, names, 10, 900, 100)
        torch.cuda.synchronize()
        return m

    if not bool(path()[s]):
        raise AssertionError("B7a's path call misses its slot")
    out["b7a_path"] = {"ms": host_ms(path)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
