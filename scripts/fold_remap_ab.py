"""Time M4 (the sharded metrics fold) and B9a (the cut's code remap) of
one checkout of the PyTorch/CUDA port on the card, so that two trees can
be held against each other on the same machine:

    python3 scripts/fold_remap_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version, and prints one JSON line.

M4 at the shapes of chip_smoke.py's phase 15 (blocks of 32,768 traces x
32 spans = 1,048,576 rows, start times over an hour, 64 groups x 61
buckets of 60 s):
- m4_value: run 2's last fold on rank 0, `{ kind = server } |
  max_over_time(duration) by (resource.service.name)`: 3 blocks, a value
  on every span (the five accumulators);
- m4_rate: run 1's fold, `{ true } | rate() by (resource.service.name)`:
  10 blocks, counts only;
- m4_value_path: parallel/timeseries' mesh body (`_ts_body`) on a 1x1
  mesh at m4_value's shape, from its operands on the card to the
  accumulators read back, on the host clock (the mesh's collectives are
  no-ops at one rank).

B9a:
- b9a_one: kernels.remap_codes over one column of 1,048,576 codes through
  a 5,677-entry table (phase 4c's shape);
- b9a_cut: the 29 code columns of a cut of 32,768 traces (about phase
  11's: 6 span columns of 1,048,576 codes, 2 trace columns of 32,768, 2
  scope columns of 1, the event and link names empty, 9 dedicated
  resource columns of 98,304, the span attrs' key and string columns of
  2,097,152, the resource attrs' of 98,304, the event and link attrs'
  empty) through the same table: one kernels.remap_codes a column on a
  tree without kernels.remap_many, one remap_many call on a tree with it;
- b9a_cut_host: the same columns as numpy arrays through ops/blockcut's
  CutEngine (remap a column, or remap_many once), numpy back, on the
  host clock: the cut's remap steps.

On a tree with kernels.remap_many, b9a_one_l2 and b9a_cut_l2 force B9a's
L2 route (the table read through L2, not copied to shared memory).

With --split (a tree with this split's anchors in csrc/timeseries.cu),
it adds `m4_split`: M4's shared route at m4_value's and m4_rate's
shapes, in device µs a call, from copies of timeseries.cu built to stop
after the fold of the rows ("fold"), after the clusters' reduce
("reduce"), and a copy whose fold keeps each row's cell but adds nothing
to shared memory and stops there ("loop": the walk, the masks and the
bucketing alone), beside the whole kernel.

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 20
back-to-back calls), `device_ms`, the card's time a call
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel), and
`grids`, the `__global__` launches of one call (kernels.grid_launches).
For the host-clock rows: `ms` (chip_smoke.host_ms). Needs one NVIDIA
card."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

S, G, NB, STEP = 1 << 20, 64, 61, 60_000
R_TABLE = 5677
CUT_LENS = ([1 << 20] * 6 + [1 << 15] * 2 + [1] * 2 + [0] * 2 + [98_304] * 9
            + [1 << 21] * 2 + [98_304] * 2 + [0] * 4)


# copies of ts_one_kernel's shared route: (anchor, text put before it, or
# the anchor's replacement where the text is None)
SPLIT_COPIES = {
    "fold": [("        cl.sync();\n        // CTA r reduces its slice of cells",
              "        if (STK) return;\n")],
    "reduce": [("        cl.sync();  // no CTA leaves while another reads its copy",
                "        if (STK) { cl.sync(); return; }\n")],
    "loop": [("            ts_fold_span(smem + cell, cells, a.has_val, pres, v);",
              None, "            if (cell == 0x7FFFFFFF) smem[0] = (int)v + pres;"),
             ("        cl.sync();\n        // CTA r reduces its slice of cells",
              "        if (STK) return;\n")],
}


def m4_split(kernels, calls: dict) -> dict:
    """M4's shared route stopped after each phase (SPLIT_COPIES): device
    µs a call, keyed "<fold> <stop>"; calls maps a fold's name to a call
    of kernels.timeseries_stacked forced onto the shared route."""
    import ctypes

    here = os.path.join(os.path.dirname(kernels.BUILD_DIR), "m4_split")
    os.makedirs(here, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "timeseries.cu")) as f:
        src = f.read()
    procs = {}
    for stop, edits in SPLIT_COPIES.items():
        text = src
        for anchor, before, *repl in edits:
            if text.count(anchor) != 1:
                raise AssertionError(f"timeseries.cu: the {stop} anchor is not there once")
            text = text.replace(anchor, repl[0] if before is None else before + anchor)
        path = os.path.join(here, f"timeseries_{stop}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(here, f"libtimeseries_{stop}.so")
        procs[stop] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = kernels._load()
    whole = fns["tt_timeseries_stacked"]
    libs = {}
    for stop, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise AssertionError(f"nvcc {stop}: {log}")
        fn = ctypes.CDLL(lib).tt_timeseries_stacked
        fn.argtypes = kernels._SIGNATURES["tt_timeseries_stacked"][1]
        fn.restype = ctypes.c_int
        libs[stop] = fn
    libs["whole"] = whole
    res = {}
    try:
        for name, call in calls.items():
            for stop, fn in libs.items():
                fns["tt_timeseries_stacked"] = fn
                res[f"{name} {stop}"] = device_ms(call) * 1e3
    finally:
        fns["tt_timeseries_stacked"] = whole
    return res


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids}


def fold_inputs(torch, F, rng, dev, bl: int, has_val: bool):
    """bl stacked blocks of S rows: start times over an hour, kind 1-5,
    group ids 0-63 (a service a span), durations as values."""
    cols = {"span.start_ms": rng.integers(0, 3_600_000, (bl, S)).astype(np.int32),
            "span.trace_sid": np.broadcast_to(np.arange(S, dtype=np.int32) // 32, (bl, S)).copy(),
            "span.kind": rng.integers(1, 6, (bl, S)).astype(np.int32)}
    gid = rng.integers(0, G, (bl, S)).astype(np.int32)
    val = pres = None
    if has_val:
        val = (rng.integers(10, 1_000_000, (bl, S)) / 1e6).astype(np.float32)
        pres = np.ones((bl, S), bool)
    if has_val:
        conds = (F.Cond("span", "span.kind", "eq"),)
        tree = ("cond", 0)
        operands = [F.Operands.build([(0, 2, 0, 0.0, 0.0)]) for _ in range(bl)]
    else:
        conds, tree = (), None
        operands = [F.Operands.build([]) for _ in range(bl)]
    t0s = np.zeros(bl, np.int32)
    nspans = np.full(bl, S, np.int32)
    return cols, gid, val, pres, tree, conds, operands, t0s, nspans


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--split", action="store_true", help="also split M4's shared route")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fold_remap_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import blockcut as BC
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import timeseries as TS
    from tempo_tpu_torch.parallel import mesh as PM
    from tempo_tpu_torch.parallel import timeseries as PTS

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    new = hasattr(kernels, "remap_many")  # this change's entry points
    out = {"tree": args.tree, "new": new, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    # ---- M4
    split_calls = {}
    for name, bl, has_val in (("m4_value", 3, True), ("m4_rate", 10, False)):
        cols_np, gid_np, val_np, pres_np, tree, conds, operands, t0s, nspans = \
            fold_inputs(torch, F, rng, dev, bl, has_val)
        cols = {n: torch.from_numpy(a).to(dev) for n, a in cols_np.items()}
        gid = torch.from_numpy(gid_np).to(dev)
        val = torch.from_numpy(val_np).to(dev) if has_val else None
        pres = torch.from_numpy(pres_np).to(dev) if has_val else None
        query = (tree, conds)
        if new:
            prog, buf, blocks = TS.stacked_program(query, cols, operands, t0s, nspans)

            def fold(prog=prog, buf=buf, blocks=blocks, cols=cols, gid=gid, val=val, pres=pres):
                return kernels.timeseries_stacked(prog, buf, blocks, cols, gid, val, pres, STEP,
                                                  NB, G)
        else:
            prog, bufs, descs = TS.stacked_program(query, cols, operands)
            t0_d, ns_d = torch.from_numpy(t0s).to(dev), torch.from_numpy(nspans).to(dev)

            def fold(prog=prog, bufs=bufs, descs=descs, cols=cols, gid=gid, val=val, pres=pres,
                     t0_d=t0_d, ns_d=ns_d):
                return kernels.timeseries_stacked(prog, bufs, descs, cols, gid, val, pres, t0_d,
                                                  ns_d, STEP, NB, G)

        got = fold()
        want = TS._timeseries_stacked_plain(tree, conds, cols, operands, gid, val, pres,
                                            t0s.tolist(), nspans.tolist(), STEP, NB, G)
        for k, (g, w) in enumerate(zip(got, want)):
            same = (torch.allclose(g, w, rtol=1e-5, atol=0) if k == 2 else torch.equal(g, w))
            if not same:
                raise AssertionError(f"{name}: output {k} differs from the plain version")
        if int(want[0].sum()) == 0:
            raise AssertionError(f"{name}: no span folded")
        out[name] = timed(kernels, fold)
        if args.split:
            shared = kernels.timeseries_route("shared", G * NB, has_val)

            def split_call(prog=prog, buf=buf, blocks=blocks, cols=cols, gid=gid, val=val,
                           pres=pres, shared=shared):
                return kernels.timeseries_stacked(prog, buf, blocks, cols, gid, val, pres, STEP,
                                                  NB, G, shared)

            split_calls[name] = split_call
        if not has_val:
            continue
        # the mesh body on a 1x1 mesh, its operands as the mesh leaves them
        seen = {}

        class Capture:
            def run(self, program, static, **kinds):
                seen.update(program=program, static=static, shard0=kinds["shard0"])

        PTS.sharded_timeseries(Capture(), tree, conds, operands, cols_np, nspans, t0s, gid_np,
                               val_np, pres_np, STEP, NB, G)
        ops = {k: torch.as_tensor(v).to(dev) for k, v in seen["shard0"].items()}
        mesh = PM.Mesh(1, 1, dev)
        body = PM.PROGRAMS[seen["program"]]

        def path(mesh=mesh, body=body, ops=ops):
            return body(mesh, seen["static"], ops)

        res = path()
        if not (np.array_equal(res[0], want[0].cpu().numpy())
                and np.allclose(res[2], want[2].cpu().numpy(), rtol=1e-5, atol=0)
                and np.array_equal(res[3].view(np.int32),
                                   TS.ts_decode(want[3]).cpu().numpy().view(np.int32))):
            raise AssertionError("m4_value_path differs from the plain version")
        out["m4_value_path"] = {"ms": host_ms(path, reps=10, rounds=5, warm=3)}
        del ops, got, want
    if split_calls:
        out["m4_split"] = m4_split(kernels, split_calls)
    del split_calls

    # ---- B9a
    table_np = rng.permutation(R_TABLE).astype(np.int32)
    table = torch.from_numpy(table_np).to(dev)
    one = torch.from_numpy(rng.integers(-1, R_TABLE, 1 << 20).astype(np.int32)).to(dev)
    if not torch.equal(kernels.remap_codes(one, table).cpu(),
                       BC._remap_plain(one.cpu(), table.cpu())):
        raise AssertionError("b9a_one differs from the plain version")
    out["b9a_one"] = timed(kernels, lambda: kernels.remap_codes(one, table))
    cols_np = [rng.integers(-1, R_TABLE, n).astype(np.int32) for n in CUT_LENS]
    want = [table_np[np.minimum(c, R_TABLE - 1)] for c in cols_np]
    want = [np.where(c >= 0, w, c) for c, w in zip(cols_np, want)]
    offs = np.concatenate([[0], np.cumsum(CUT_LENS)]).astype(np.int64)
    codes = torch.from_numpy(np.concatenate(cols_np)).to(dev)
    if new:
        def cut(codes=codes):
            return kernels.remap_many(codes, offs.tolist(), table)

        got = cut().cpu().numpy()
        if not np.array_equal(got, np.concatenate(want)):
            raise AssertionError("b9a_cut differs from the plain version")
    else:
        parts = [codes[a:b] for a, b in zip(offs[:-1], offs[1:])]

        def cut(parts=parts):
            return [kernels.remap_codes(p, table) for p in parts]

        if not all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(cut(), want)):
            raise AssertionError("b9a_cut differs from the plain version")
    out["b9a_cut"] = timed(kernels, cut)
    if new:  # B9a's other route, forced
        out["b9a_one_l2"] = timed(kernels, lambda: kernels.remap_codes(one, table, "l2"))
        out["b9a_cut_l2"] = timed(kernels, lambda: kernels.remap_many(codes, offs.tolist(), table,
                                                                      "l2"))
    eng = BC.CutEngine(dev)
    tab = eng.table(table_np)
    if new:
        def steps():
            return eng.remap_many(cols_np, tab)
    else:
        def steps():
            return [eng.remap(c, tab) for c in cols_np]
    if not all(np.array_equal(g, w) for g, w in zip(steps(), want)):
        raise AssertionError("b9a_cut_host differs from the plain version")
    out["b9a_cut_host"] = {"ms": host_ms(steps, reps=5, rounds=5, warm=2)}
    out["b9a_cut_codes"] = int(offs[-1])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
