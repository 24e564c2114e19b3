"""Time the sharded search's tail -- M7 (the per-trace partial counts),
M8 (the trace program) and, where the checkout has it, the one launch of
both that a one-rank sp axis takes -- of one checkout of the PyTorch/CUDA
port on the card, so that two trees can be held against each other on
the same machine:

    python3 scripts/search_tail_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version, and prints one JSON line.

The shape is phase 15's span query on one rank (chip_smoke.py): 10
blocks of 1,048,576 span rows, 32,768 traces a block of 32 rows each,
one tracify slot (4 % of the rows set, as `span.http.status_code = 500
&& kind = server` sets them), no trace condition; `m8_tc` adds a trace
condition (`trace.dur_ms >= ...`) to the program.

- m7: kernels.search_partial over trace.span_off;
- m8, m8_tc: kernels.search_finish over M7's counts;
- fused (absent in a checkout without it): kernels.search_fused, M7's
  count and M8's program in one launch;
- tail_host: the shard's tail as parallel/search.search_local runs it
  at sp = 1 (M7 then M8; or the one launch), then a synchronise, on the
  host clock.

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 20
back-to-back calls), `device_ms`, the card's time a call
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel), and
`grids`, the `__global__` launches of one call (kernels.grid_launches).
For the tail: `ms` on the host clock (chip_smoke.host_ms). Needs one
NVIDIA card."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

BL, S, NT = 10, 1 << 20, 1 << 15


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids}


def shard(torch, F, MS, rng, dev, trace_cond: bool):
    """One rank's shard at sp = 1 of phase 15's span query, its tracify
    slot set at random (the span pass is not timed here)."""
    per = S // NT
    off = np.broadcast_to(np.arange(NT + 1, dtype=np.int32) * per, (BL, NT + 1))
    cols = {"span.trace_sid": np.broadcast_to(np.arange(S, dtype=np.int32) // per, (BL, S)),
            "span.http_status": rng.choice(np.asarray([200, 404, 500], np.int32), (BL, S)),
            "span.kind": rng.integers(1, 6, (BL, S)).astype(np.int32),
            "trace.span_off": off,
            "trace.dur_ms": rng.integers(0, 1000, (BL, NT)).astype(np.int32)}
    cols = {n: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for n, a in cols.items()}
    conds = (F.Cond("span", "span.http_status", "eq"), F.Cond("span", "span.kind", "eq"),
             F.Cond("trace", "trace.dur_ms", "ge"))
    tree = ("and", ("cond", 0), ("cond", 1))
    if trace_cond:
        tree = ("and", tree, ("cond", 2))
    ops = F.Operands.build([(0, 500, 0, 0.0, 0.0), (0, 2, 0, 0.0, 0.0), (0, 300, 0, 0.0, 0.0)])
    ints = np.broadcast_to(ops.ints[None], (BL, 3, 3)).copy()
    floats = np.broadcast_to(ops.floats[None], (BL, 3, 2)).copy()
    sh = MS.ShardSearch(F.normalize_tree(tree, conds), conds, cols, ints, floats, {},
                        [S] * BL, 0, NT)
    assert len(sh.prog.tslots) == 1
    sh.slots[:, sh.prog.tslots[0]] = torch.from_numpy(rng.random((BL, S)) < 0.04).to(dev)
    return sh


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=14)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("search_tail_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import meshsearch as MS

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
    fused = getattr(kernels, "search_fused", None)
    for name, trace_cond in (("", False), ("_tc", True)):
        sh = shard(torch, F, MS, rng, dev, trace_cond)
        span_off = sh.cols["trace.span_off"]

        def m7(sh=sh, span_off=span_off):
            return kernels.search_partial(sh.prog, sh.bufs[0], sh.slots, span_off, None,
                                          sh.n_spans_t, 0, NT)

        counts = m7()
        if not torch.equal(counts, MS._search_partial_plain(sh.slots, sh.prog.tslots, span_off,
                                                            None, sh.n_spans_t, 0, NT)):
            raise AssertionError("M7 differs from its plain version")

        def m8(sh=sh, counts=counts):
            return kernels.search_finish(sh.prog, sh.bufs[0], sh.descs, counts)

        want = MS._search_finish_plain(sh.prog.code(sh.prog.trace_off), sh.conds, sh.cols,
                                       sh.ops_i, sh.ops_f, sh.tables, counts)
        got = m8()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])) \
                or not bool(want[0].any()) or bool(want[0].all()):
            raise AssertionError(f"M8{name} differs from its plain version or is vacuous")
        if not trace_cond:
            out["m7"] = timed(kernels, m7)
        out[f"m8{name}"] = timed(kernels, m8)
        if trace_cond:
            continue
        tail = sh.finish
        if fused is not None:
            def fz(sh=sh, span_off=span_off):
                return fused(sh.prog, sh.bufs[0], sh.descs, sh.slots, span_off, sh.n_spans_t, 0,
                             NT)

            got = fz()
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError("the fused route differs from M7 then M8")
            out["fused"] = timed(kernels, fz)

        def path(sh=sh):
            r = sh.partial_finish() if hasattr(sh, "partial_finish") else tail(sh.partial())
            torch.cuda.synchronize()
            return r

        got = path()
        if not torch.equal(got[1], want[1]):
            raise AssertionError("the shard's tail differs from its plain version")
        out["tail_host"] = {"ms": host_ms(path)}
        del sh, counts
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
