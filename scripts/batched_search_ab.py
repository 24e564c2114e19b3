"""Time B5a (the batched filter programs) and B5b (the batched top-k) of
one checkout of the PyTorch/CUDA port on the card, at the shape of
chip_smoke.py's phase 4b, so that two trees can be held against each
other on the same machine:

    python3 scripts/batched_search_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there), makes the inputs from a seed with numpy, checks each kernel
against its plain version, and prints one JSON line:

- b5a: 16 programs of the batched search's shape, `{ name = .. &&
  resource.service.name = .. }` (two span columns, the second a
  PAD-guarded span@res column), their operands read off 16 random spans,
  over 1,048,576 spans in 32,768 traces of 32 (names over 512 codes,
  services over 64);
- b5b: the 16 (32,768) trace-mask rows B5a gives, k = 64, the shared key
  a random trace start; beside it `torch.topk` over the same (16,
  32,768) int64 composites, whose order B5b's must equal;
- m2: M2 (kernels.mq_partial, B5a's span-level half) with the same 16
  programs over the first 262,144 rows, as chip_smoke.py's mesh phase
  takes a rank's slice of a 4-rank mesh;
- m3: M3 (kernels.mq_combine, the trace-level half) over M2's counts
  summed over the four slices of 262,144 rows, (16, 2, 32,768), checked
  against its plain version and, as the mesh's answer, against B5a.

For each: `ms`, a call of the wrapper (chip_smoke.cuda_ms: CUDA events
over 50 back-to-back calls, the host's path or the card's, whichever is
slower), `device_ms`, the card's time a call (chip_smoke.device_ms: 20
calls queued behind a sleep kernel), and `grids`, the `__global__`
launches of one call (kernels.grid_launches); m2 and m3 add `bound_us`,
their bytes over 3.35 TB/s. The wrappers timed, kernels.multiquery,
kernels.mq_select, kernels.mq_partial and kernels.mq_combine, exist on
both trees; kernels.multiquery is given n_spans_b where its signature
takes it, and kernels.mq_combine's (tm, counts) is read off its return,
the views of one packed allocation on a tree that has
kernels.mq_combine_packed. Needs one NVIDIA card.

With --split (a tree whose csrc/multiquery.cu has this split's anchors),
it adds `b5a_split`: B5a's device µs a call stopped after each phase --
the CTA's programs read and compiled; the trace walk with its span loads
and row writes but no program run; the walk with each span's condition
word; the whole kernel -- from copies of multiquery.cu built with a
`return` or `continue` at each stop; and `m2_split`, M2's the same way
(m2_split's docstring), at other tile sizes and under grid caps."""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms  # noqa: E402 -- one definition of the timings

N_TRACES, SPANS_PER, Q, K, M2_ROWS = 1 << 15, 32, 16, 64, 1 << 18
PAD_I32 = -(2**31)
# where a copy of mq_eval_kernel stops: a statement before each anchor
SPLIT_STOPS = {
    "programs": ("    const bool regular = pr->regular;\n",
                 "    if (MQ_STOP == 1) {  // a word of the compiled chunk out, so none of it is dropped\n"
                 "        if (threadIdx.x == 0) tm_out[blockIdx.x] = pr->hc ^ pr->eqcols ^ pr->n_other;\n"
                 "        return;\n    }\n"),
    "walk": ("                    const unsigned cb = in && regular ? mq_cond_bits(*pr, vals, vs) : 0u;\n",
             "                    if (MQ_STOP == 2) continue;\n"),
    "conditions": ("                    if (regular) {\n",
                   "                    if (MQ_STOP == 3) {\n                        heads |= cb;\n"
                   "                        continue;\n                    }\n"),
}


# where a copy of mq_partial_kernel stops (M2, --split): a statement
# before each anchor
M2_SPLIT_STOPS = {
    "launch": ("    const int K = nq * (NG + 1);\n    MqProg* pr",
               "    if (MQ2_STOP == 1) {\n        if (threadIdx.x == 0) out[blockIdx.x] = q_b;\n"
               "        return;\n    }\n"),
    "rows": ("    mq_compile(pg, nq, P, NC, NG, n_sc, pr);\n    const bool regular = pr->regular;  //",
             "    if (MQ2_STOP == 2) {\n        if (threadIdx.x == 0) out[blockIdx.x] = pg[0];\n"
             "        return;\n    }\n"),
    "programs": ("    const int vend = tt_clamp(",
                 "    if (MQ2_STOP == 3) {  // a word of the compiled chunk out\n"
                 "        if (threadIdx.x == 0) out[blockIdx.x] = pr->hc ^ pr->eqcols ^ csrc[0];\n"
                 "        return;\n    }\n"),
    "vote": ("        for (int i = warp; any && i < nt; i += MQ_WARPS) {",
             "        if (MQ2_STOP != 4)\n"),
    "walk": ("                if (regular) {\n                    const unsigned gw = in ? mq_group_word(",
             "                if (MQ2_STOP == 5) continue;\n"),
    "conditions": ("                    gsum += mq_colsum(gw, lane);\n",
                   "                    if (MQ2_STOP == 6) {\n"
                   "                        gsum += gw == 0x5A5A5A5Au;\n"
                   "                        continue;\n                    }\n"),
}
M2_TILES = (8, 32, 64)  # M2's traces a tile besides the source's, --split
M2_CAPS = (132, 264, 528)  # M2's grid capped at these CTAs, --split
M2_GRID = "    mq_partial_kernel<<<dim3(gx, n_chunks)"
M2_TILE = "#define MQ2_TT 16 "  # the source's tile size, replaced in a copy for M2_TILES


def variant_us(kernels, call, sym: str, variants: dict) -> dict:
    """Device µs a call of `call` with the library symbol `sym` taken
    from copies of multiquery.cu: variants maps a name to (edits, nvcc -D
    flags), each edit an (anchor, the text that replaces it); "whole" is
    the tree's own build."""
    here = os.path.join(os.path.dirname(kernels.BUILD_DIR), "mq_split")
    os.makedirs(here, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "multiquery.cu")) as f:
        src = f.read()
    procs = {}
    for name, (edits, flags) in variants.items():
        text = src
        for anchor, new in edits:
            if text.count(anchor) != 1:
                raise AssertionError(f"multiquery.cu: the {name} anchor is not there once")
            text = text.replace(anchor, new)
        path = os.path.join(here, f"multiquery_{sym}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(here, f"libmultiquery_{sym}_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, *flags, "-I", kernels.CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = kernels._load()
    whole, res = fns[sym], {}
    try:
        for name, (lib, p) in procs.items():
            log, _ = p.communicate()
            if p.returncode:
                raise AssertionError(f"nvcc {name}: {log}")
            fn = getattr(ctypes.CDLL(lib), sym)
            fn.argtypes, fn.restype = kernels._SIGNATURES[sym][1], ctypes.c_int
            fns[sym] = fn
            res[name] = device_ms(call) * 1e3
    finally:
        fns[sym] = whole
    res["whole"] = device_ms(call) * 1e3
    return res


def b5a_split(kernels, call) -> dict:
    """B5a's device µs a call at each stop (see the module docstring),
    `call` running kernels.multiquery on the A/B's inputs."""
    return variant_us(kernels, call, "tt_multiquery", {
        stop: ([(anchor, stmt + anchor)], [f"-DMQ_STOP={k}"])
        for k, (stop, (anchor, stmt)) in enumerate(SPLIT_STOPS.items(), 1)})


def m2_split(kernels, call) -> dict:
    """M2's device µs a call stopped after each phase -- the launch; the
    CTA's program rows read; the chunk compiled; the tiles' vote and rows
    with no walk; the walk with its span loads but no condition word; the
    walk with each span's group word but no count; the whole kernel -- at
    other tile sizes (MQ2_TT), and with the grid capped (M2_CAPS CTAs)."""
    variants = {stop: ([(anchor, stmt + anchor)], [f"-DMQ2_STOP={k}"])
                for k, (stop, (anchor, stmt)) in enumerate(M2_SPLIT_STOPS.items(), 1)}
    variants.update({f"tile{tt}": ([(M2_TILE, f"#define MQ2_TT {tt} ")], []) for tt in M2_TILES})
    variants.update({f"cap{c}": ([(M2_GRID, f"    gx = gx < {c} ? gx : {c};\n" + M2_GRID)], [])
                     for c in M2_CAPS})
    return variant_us(kernels, call, "tt_mq_partial", variants)


def programs(rng, names: np.ndarray, svc: np.ndarray) -> list[dict]:
    """Q programs as lower_plan gives `{ name = a && resource.service.name
    = b }`: one group of two one-condition clauses, the second guarded."""
    out = []
    for s in rng.choice(names.shape[0], Q, replace=False):
        out.append({
            "cond_col": [0, 1], "cond_op": [0, 0], "cond_v0": [int(names[s]), int(svc[s])],
            "cond_v1": [0, 0], "cond_guard": [False, True], "clause_off": [0, 1, 2],
            "group_off": [0, 2], "tcond_col": [0], "tcond_op": [-1], "tcond_v0": [0],
            "tcond_v1": [0], "atom_kind": [0], "atom_idx": [0], "tclause_off": [0, 1],
            "n_groups": 1, "n_tclauses": 1,
            "span_cols": ("span.name_id", "span@res.service_id"), "trace_cols": ()})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--split", action="store_true", help="also split B5a and M2 by phase")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("batched_search_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.ops import multiquery as MQ
    from tempo_tpu_torch.ops import stage as ST

    assert os.path.dirname(os.path.dirname(os.path.abspath(kernels.__file__))) == \
        os.path.abspath(args.tree), kernels.__file__
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    out = {"tree": args.tree, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    n = N_TRACES * SPANS_PER
    names = rng.integers(0, 512, n).astype(np.int32)
    svc = rng.integers(0, 64, n).astype(np.int32)
    cols = {"span.name_id": names, "span@res.service_id": svc,
            "span.trace_sid": np.repeat(np.arange(N_TRACES), SPANS_PER).astype(np.int32),
            "trace.span_off": np.arange(0, n + 1, SPANS_PER).astype(np.int32),
            "trace.start_ms": rng.integers(0, 3_600_000, N_TRACES).astype(np.int32)}
    staged = ST.staged_from_numpy(cols, n, N_TRACES, 1, dev)
    nt_b = staged.n_traces_b
    lowered = [MQ.LoweredQuery.from_arrays(p) for p in programs(rng, names, svc)]
    progs = MQ.pack_queries(lowered, Q)
    prog_t, dims, ptr_t = MQ.device_program(lowered, staged, progs)
    span_off = staged.cols["trace.span_off"]

    takes_nsb = "n_spans_b" in inspect.signature(kernels.multiquery).parameters
    nsb = (staged.n_spans_b,) if takes_nsb else ()

    def b5a():
        return kernels.multiquery(prog_t, dims, ptr_t, 2, 0, span_off, n, N_TRACES, nt_b, *nsb)

    tprogs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in progs.items()}
    want = MQ._multiquery_plain([staged.cols["span.name_id"], staged.cols["span@res.service_id"]],
                                [], span_off, tprogs, n, N_TRACES, staged.n_spans_b, nt_b)
    kernels.reset_counts()
    tm, counts = b5a()
    grids = kernels.grid_launches()["multiquery"]
    if not (torch.equal(tm, want[0]) and torch.equal(counts, want[1])) or \
            int(tm.sum(dim=1).min()) < 1:
        raise AssertionError("B5a differs from its plain version, or a program matched nothing")
    out["b5a"] = {"ms": cuda_ms(b5a, reps=50), "device_ms": device_ms(b5a), "grids": grids,
                  "matched": tm.sum(dim=1).tolist()}
    if args.split:
        out["b5a_split"] = b5a_split(kernels, b5a)

    key = staged.cols["trace.start_ms"]

    def b5b():
        return kernels.mq_select(tm, key, counts, K)

    kernels.reset_counts()
    got = b5b()
    grids = kernels.grid_launches()["mq_select"]
    comp = (torch.where(tm, key[None, :], PAD_I32).to(torch.int64) * (1 << 32)
            + ((1 << 32) - 1 - torch.arange(nt_b, device=dev))[None, :])
    if not torch.equal(got, MQ._mq_select_plain(tm, key, counts, K)) or \
            not torch.equal(torch.topk(comp, K, dim=1).indices.to(torch.int32), got[:, :K]):
        raise AssertionError("B5b differs from its plain version or from torch.topk's order")
    out["b5b"] = {"ms": cuda_ms(b5b, reps=50), "device_ms": device_ms(b5b), "grids": grids}
    out["topk"] = {"ms": cuda_ms(lambda: torch.topk(comp, K, dim=1), reps=50),
                   "device_ms": device_ms(lambda: torch.topk(comp, K, dim=1))}

    rows = torch.from_numpy(MQ._program_rows(progs)).to(dev)
    span_mat = torch.stack([staged.cols["span.name_id"][:M2_ROWS],
                            staged.cols["span@res.service_id"][:M2_ROWS]]).contiguous()

    def m2():
        return kernels.mq_partial(rows, dims, span_mat, 0, span_off, n)

    kernels.reset_counts()
    part = m2()
    grids = kernels.grid_launches()["mq_partial"]
    if not torch.equal(part, MQ._mq_partial_plain(span_mat, span_off,
                                                  MQ.program_tables(rows, dims), 0, n)):
        raise AssertionError("M2 differs from its plain version")
    out["m2"] = {"ms": cuda_ms(m2, reps=50), "device_ms": device_ms(m2), "grids": grids,
                 "bound_us": (span_mat.numel() + span_off.numel() + part.numel()) * 4 / 3.35e6}
    if args.split:
        out["m2_split"] = m2_split(kernels, m2)

    total = sum(kernels.mq_partial(rows, dims, torch.stack(
        [staged.cols[c][r * M2_ROWS:(r + 1) * M2_ROWS] for c in
         ("span.name_id", "span@res.service_id")]).contiguous(), r * M2_ROWS, span_off, n)
        for r in range(n // M2_ROWS)).to(torch.int32)
    trace_mat = torch.zeros((1, nt_b), dtype=torch.int32, device=dev)  # no trace column named

    def m3():
        return kernels.mq_combine(rows, dims, total, trace_mat, N_TRACES)

    kernels.reset_counts()
    tm3, cnt3 = m3()
    grids = kernels.grid_launches()["mq_combine"]
    want = MQ._mq_combine_plain(total, trace_mat, MQ.program_tables(rows, dims), N_TRACES)
    if not (torch.equal(tm3, want[0]) and torch.equal(cnt3, want[1])
            and torch.equal(tm3, tm) and torch.equal(cnt3, counts)):
        raise AssertionError("M3 differs from its plain version, or M2 + M3 from B5a")
    out["m3"] = {"ms": cuda_ms(m3, reps=50), "device_ms": device_ms(m3), "grids": grids,
                 "bound_us": (total.numel() + trace_mat.numel()) * 4 / 3.35e6
                 + tm3.numel() * 5 / 3.35e6}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
