"""Time M6 (the sharded search's bit-packed lhs mask) and the struct pass
that reads it, of one checkout of the PyTorch/CUDA port on the card, so
that two trees can be held against each other on the same machine:

    python3 scripts/struct_mask_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each output against a numpy answer, and prints one JSON line.

At chip_smoke.py's phase-15 run-1 shape (Bl = 10 blocks of Sl = 2^20
span rows, 32 spans a trace, each span's parent an earlier span of its
trace; mask slots (Bl, 3, Sl) of 0/1 bytes, the lhs mask a strided slot
view):
- pack: `kernels.mask_pack` of the lhs slot;
- node: one `>` node's work on a shard, the all_gather left out: the
  pack, the unpack and K1's struct pass over the byte mask on a tree with
  `kernels.mask_unpack`; the pack and the struct pass reading the packed
  mask on a tree without it;
- struct: that struct pass alone (struct_bytes: the byte-mask pass, on a
  tree that has both);
- search_local: the search program's mesh body (`_search_body`, a `>`
  node between two span conditions) on a one-rank NCCL mesh, from its
  operands on the card to the (trace_mask, span_count) rows read back,
  on the host clock.

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 20
back-to-back calls), `device_ms`, the card's time a call
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel), `grids`,
the `__global__` launches of one call (kernels.grid_launches), and
`calls`, its wrapper calls by kernel (kernels.LAUNCHES). For the
host-clock row: `ms` (chip_smoke.host_ms) and `calls`. Needs one NVIDIA
card."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

BL, SL, PER = 10, 1 << 20, 32  # phase 15's run 1: blocks, span rows, spans a trace
NT = SL // PER


def nonzero(c: dict) -> dict:
    return {k: v for k, v in c.items() if v}


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    calls = nonzero(kernels.LAUNCHES)
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids, "calls": calls}


def inputs(rng) -> dict:
    """Columns of BL blocks: traces of PER spans, span 0 of each a root,
    every other span's parent an earlier span of its trace; kind and
    status codes; mask slots 0 (lhs) and 1 (rhs) of 0/1 bytes."""
    pos = np.arange(SL, dtype=np.int64)
    lo = pos - pos % PER
    par = lo + np.floor(rng.random((BL, SL)) * (pos - lo)).astype(np.int64)
    par = np.where(pos % PER == 0, -1, par).astype(np.int32)
    cols = {"span.parent_idx": par,
            "span.kind": rng.integers(0, 6, (BL, SL)).astype(np.int32),
            "span.status": rng.integers(0, 3, (BL, SL)).astype(np.int32),
            "span.trace_sid": np.broadcast_to((pos // PER).astype(np.int32), (BL, SL)).copy(),
            "trace.span_off": np.broadcast_to(np.arange(NT + 1, dtype=np.int32) * PER,
                                              (BL, NT + 1)).copy()}
    slots = np.zeros((BL, 3, SL), np.uint8)
    slots[:, 0] = cols["span.kind"] == 2
    slots[:, 1] = cols["span.status"] == 2
    return {"cols": cols, "slots": slots}


def child_want(lhs: np.ndarray, rhs: np.ndarray, pidx: np.ndarray) -> np.ndarray:
    """The `>` relation on every row (all rows valid, row0 0)."""
    hit = np.take_along_axis(lhs != 0, np.clip(pidx, 0, SL - 1), axis=1)
    return (rhs != 0) & (pidx >= 0) & hit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("struct_mask_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.parallel import launch
    from tempo_tpu_torch.parallel import mesh as PM
    from tempo_tpu_torch.parallel import search as PS

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    new = not hasattr(kernels, "mask_unpack")  # this change reads the packed mask in K1
    out = {"tree": args.tree, "new": new, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}
    rng = np.random.default_rng(args.seed)
    data = inputs(rng)
    cols_np, slots_np = data["cols"], data["slots"]

    # ---- the pack, the `>` node's work on a shard, the struct pass
    slots = torch.from_numpy(slots_np).to(dev)
    m = slots[:, 0]  # the lhs slot: a strided view, as the struct step packs it
    pidx = torch.from_numpy(cols_np["span.parent_idx"]).to(dev)
    n_spans = [SL] * BL
    want_pk = np.packbits(slots_np[:, 0] != 0, axis=1)
    want = child_want(slots_np[:, 0], slots_np[:, 1], cols_np["span.parent_idx"])
    work = slots.clone()

    def check_out(what):
        torch.cuda.synchronize()
        if not np.array_equal(work[:, 2].cpu().numpy() != 0, want):
            raise AssertionError(f"{what}: the `>` node's rows differ from numpy")
        work[:, 2].fill_(7)

    pk = kernels.mask_pack(m)
    if not np.array_equal(pk.cpu().numpy(), want_pk):
        raise AssertionError("pack differs from np.packbits")
    out["pack"] = timed(kernels, lambda: kernels.mask_pack(m))
    if new:
        def node():
            p = kernels.mask_pack(m)
            kernels.filter_struct_shard(">", p, work, 1, 2, pidx, n_spans, 0, packed=True)

        def struct():
            kernels.filter_struct_shard(">", pk, work, 1, 2, pidx, n_spans, 0, packed=True)

        def struct_bytes():
            kernels.filter_struct_shard(">", m, work, 1, 2, pidx, n_spans, 0)

        struct_bytes()
        check_out("struct_bytes")
        out["struct_bytes"] = timed(kernels, struct_bytes)
    else:
        lm = kernels.mask_unpack(pk)

        def node():
            p = kernels.mask_pack(m)
            kernels.filter_struct_shard(">", kernels.mask_unpack(p), work, 1, 2, pidx, n_spans, 0)

        def struct():
            kernels.filter_struct_shard(">", lm, work, 1, 2, pidx, n_spans, 0)

    for name, fn in (("node", node), ("struct", struct)):
        fn()
        check_out(name)
        out[name] = timed(kernels, fn)
    del slots, m, work, pk

    # ---- search_local's `>` node at sp = 1, the mesh body on one rank
    conds = (F.Cond("span", "span.kind", "eq"), F.Cond("span", "span.status", "eq"))
    tree = F.normalize_tree(("struct", ">", ("cond", 0), ("cond", 1)), conds)
    operands = F.Operands.build([(0, 2, 0, 0.0, 0.0), (0, 2, 0, 0.0, 0.0)])
    names = tuple(sorted(cols_np))
    ints, floats, tabs = PS._stack_operands(operands, BL, len(conds))
    dp, dpsp = PS.search_operands(names, cols_np, ints, floats, tabs)
    static = PS.search_static(tree, conds, names, [SL] * BL, NT, (), PS.struct_pack_enabled())
    ops = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for n, a in {**dp, **dpsp}.items()}
    sid = cols_np["span.trace_sid"]
    hit_rows = child_want(slots_np[:, 0], slots_np[:, 1], cols_np["span.parent_idx"])
    want_cnt = np.stack([np.bincount(sid[b][hit_rows[b]], minlength=NT) for b in range(BL)])
    tmp = tempfile.mkdtemp(prefix="struct_mask_ab")
    mesh = launch.init_controller(1, f"file://{tmp}/pg", "nccl", dev, timeout_s=60)
    try:
        body = PM.PROGRAMS["search"]

        def path():
            return body(mesh, static, ops)

        tm, sc = path()
        if not (np.array_equal(tm, want_cnt > 0) and np.array_equal(sc, want_cnt)):
            raise AssertionError("search_local's `>` node differs from numpy")
        kernels.reset_counts()
        path()
        calls = nonzero(kernels.LAUNCHES)
        out["search_local"] = {"ms": host_ms(path, reps=20, rounds=5, warm=3), "calls": calls}
    finally:
        launch.shutdown(mesh, [])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
