"""Time B8a (the span-metrics fold) and B6 (the TraceQL-metrics fold) of
one checkout of the PyTorch/CUDA port on the card, at the shapes of
chip_smoke.py's main path, so that two trees can be held against each
other on the same machine:

    python3 scripts/metric_folds_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there), makes the inputs from a seed with numpy, checks each kernel
against its plain version, and prints one JSON line:

- b8a: 8,480 valid rows of 16,384 into 2^18 series x 15 buckets (phase
  14's window: ids over the registry's 180,000 series, padded rows
  carrying id 2^18, which the fold drops);
- b6_rate: `{ true } | rate()` over 1,048,576 spans (32 a trace, a
  trace's spans in one bucket) into 64 groups x 61 buckets, counts only;
- b6_avg: the same spans into 512 groups x 61 buckets with a value on 90
  % of them (avg_over_time's five accumulators).

For each: `ms`, a call of the wrapper (chip_smoke.cuda_ms: CUDA events
over 50 back-to-back calls, the host's path or the card's, whichever is
slower), and `device_ms`, the card's time a call (chip_smoke.device_ms:
20 calls queued behind a sleep kernel, so that the card runs them back
to back whatever the host's pace). The wrappers timed, kernels.
span_reduce and kernels.timeseries, exist on both trees. Needs one
NVIDIA card.

With --split (a tree with this split's anchors in csrc/timeseries.cu),
it adds `b6_shared_split`: B6's shared route at b6_rate's shape, counts
only and with values, in device µs a call, stopped after each phase
(the fold; the in-cluster reduce; the grid sync before the flush; the
whole kernel), from copies of timeseries.cu built with a `return` at
each stop, and the whole kernel at clusters of 1, 2, 4, 8 and 16."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms  # noqa: E402 -- one definition of the timings


# where a copy of ts_one_kernel<1> stops: a `return` before each anchor
SPLIT_STOPS = {
    "fold": "        cl.sync();\n        // CTA r reduces its slice of cells",
    "reduce": "        grid.sync();\n        // the cluster's slice into the output",
    "sync": "        // the cluster's slice into the output",
}


def shared_split(kernels, staged, prog, buf, gid, val, pres, n: int) -> dict:
    """B6's shared route by phase and by cluster size (see the module
    docstring): device µs a call, keyed "<counts|values> <stop>/<cluster>"."""
    import torch

    here = os.path.join(os.path.dirname(kernels.BUILD_DIR), "b6_split")
    os.makedirs(here, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "timeseries.cu")) as f:
        src = f.read()
    procs = {}
    for k, (stop, anchor) in enumerate(SPLIT_STOPS.items(), 1):
        if src.count(anchor) != 1:
            raise AssertionError(f"timeseries.cu: the {stop} anchor is not there once")
        path = os.path.join(here, f"timeseries_{stop}.cu")
        with open(path, "w") as f:
            f.write(src.replace(anchor, f"        if (TS_STOP == {k}) return;\n" + anchor))
        lib = os.path.join(here, f"libtimeseries_{stop}.so")
        procs[stop] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DTS_STOP={k}", "-I", kernels.CSRC, "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = kernels._load()
    whole = fns["tt_timeseries"]
    libs = {}
    for stop, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise AssertionError(f"nvcc {stop}: {log}")
        fn = ctypes.CDLL(lib).tt_timeseries
        fn.argtypes, fn.restype = kernels._SIGNATURES["tt_timeseries"][1], ctypes.c_int
        libs[stop] = fn
    libs["whole"] = whole
    cluster0, res = kernels.TS_SHARED_CLUSTER, {}
    try:
        for label, v, pr in (("counts", None, None), ("values", val, pres)):
            for stop, fn in libs.items():
                for c in ((1, 2, 4, 8, 16) if stop == "whole" else (cluster0,)):
                    kernels.TS_SHARED_CLUSTER = c
                    plan = kernels.timeseries_route("shared", 64 * 61, v is not None)
                    fns["tt_timeseries"] = fn

                    def call(plan=plan, v=v, pr=pr):
                        return kernels.timeseries_fold(
                            prog, buf, staged.cols, staged.cols["span.start_ms"], gid, v, pr, 0,
                            60_000, n, staged.n_res_b, staged.n_traces_b, 61, 64, plan)

                    res[f"{label} {stop}/{c}"] = device_ms(call) * 1e3
                    torch.cuda.synchronize()
    finally:
        kernels.TS_SHARED_CLUSTER, fns["tt_timeseries"] = cluster0, whole
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--split", action="store_true", help="also split B6's shared route")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("metric_folds_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import filter as F
    from tempo_tpu_torch.ops import reduce as R
    from tempo_tpu_torch.ops import stage as ST
    from tempo_tpu_torch.ops import timeseries as TS
    from tempo_tpu_torch.services.generator import LATENCY_BUCKETS

    assert os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__))) == \
        os.path.abspath(args.tree), kernels.__file__
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    out = {"tree": args.tree, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    # B8a at phase 14's window
    n, n_valid, n_ids = 16384, 8480, 1 << 18
    sid = np.full(n, n_ids, np.int32)
    sid[:n_valid] = rng.integers(0, 180_000, n_valid)
    dur = np.zeros(n, np.float32)
    dur[:n_valid] = rng.exponential(0.05, n_valid)
    s_t, d_t = torch.from_numpy(sid).to(dev), torch.from_numpy(dur).to(dev)
    edges = torch.tensor(LATENCY_BUCKETS, dtype=torch.float32, device=dev)

    def b8a():
        return kernels.span_reduce(s_t, d_t, n_valid, edges, n_ids)

    got, want = b8a(), R._reduce_plain(s_t, d_t, n_valid, edges, n_ids)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
            and torch.allclose(got[1], want[1], rtol=1e-5, atol=0)):
        raise AssertionError("B8a differs from its plain version")
    out["b8a"] = {"ms": cuda_ms(b8a, reps=50), "device_ms": device_ms(b8a)}

    # B6 over a block's 1,048,576 spans at a 60 s step
    n = 1 << 20
    start = (np.repeat(rng.integers(0, 3_600_000, n // 32), 32)
             + rng.integers(0, 500, n)).astype(np.int32)
    cols = {"span.start_ms": start,
            "span.trace_sid": np.repeat(np.arange(n // 32), 32).astype(np.int32)}
    staged = ST.staged_from_numpy(cols, n, n // 32, 1, dev)
    prog = TS._span_program(None, ())
    buf = prog.buffer(staged.cols, F.Operands.build([]), {})
    val = torch.from_numpy(rng.lognormal(0, 2, n).astype(np.float32)).to(dev)
    pres = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    for name, groups, has_val in (("b6_rate", 64, False), ("b6_avg", 512, True)):
        gid = torch.from_numpy(rng.integers(0, groups, n).astype(np.int32)).to(dev)
        v, p = (val, pres) if has_val else (None, None)

        def b6():
            return kernels.timeseries(prog, buf, staged.cols, staged.cols["span.start_ms"], gid,
                                      v, p, 0, 60_000, n, staged.n_res_b, staged.n_traces_b, 61,
                                      groups)

        got = b6()
        want = TS._timeseries_plain(None, (), staged.cols, None, None, {}, gid, v, p, 0, 60_000,
                                    n, 61, groups, staged.n_spans_b, staged.n_res_b,
                                    staged.n_traces_b)
        for i, (g, w) in enumerate(zip(got, want)):
            if not torch.allclose(g, w, rtol=1e-5 if i == 2 else 0, atol=0, equal_nan=True):
                raise AssertionError(f"B6 {name}: output {i} differs from its plain version")
        out[name] = {"ms": cuda_ms(b6, reps=50), "device_ms": device_ms(b6)}
        if name == "b6_rate" and args.split:
            out["b6_shared_split"] = shared_split(kernels, staged, prog, buf, gid, val, pres, n)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
