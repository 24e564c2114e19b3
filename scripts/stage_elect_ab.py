"""Time K4 (the res->span gather) and M1 (the sharded find's election) of
one checkout of the PyTorch/CUDA port on the card, so that two trees can
be held against each other on the same machine:

    python3 scripts/stage_elect_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version (or a numpy answer), and
prints one JSON line.

K4 at chip_smoke.py's phase-4 shape (a resource table of n_res_b = 1,024
codes, span.res_idx of n_spans_b = 1,048,576 rows, -1 for a span with no
resource):
- k4_one: one column (`kernels.res_to_span`);
- k4_two: two columns, as staging materializes two `span@` columns: a
  `res_to_span` call a column on a tree without `kernels.res_to_span_many`,
  one `res_to_span_many` call on a tree with it;
- k4_m4: M4's mesh path, 3 stacked blocks of 1,048,576 spans and one
  resource condition (per-block tables of 1,024): a call a block and a
  `torch.stack` on a tree without `res_to_span_many`, one call on a tree
  with it.

M1 at phase 15's run-1 shape (Bl = 12 stacked blocks of T = 32,768 ids,
Q = 64 queries: 48 present, one of them in two blocks, and 16 absent):
- k3: K3 alone (`kernels.find_rows`), on both trees;
- elect: the sharded find's kernels on one rank: K3 then the two
  `find_elect` stages on a tree without the fused kernel, the one
  `find_elect` launch on a tree with it;
- find_body: parallel/find's mesh body (`_find_body`) on a one-rank NCCL
  mesh, from its operands on the card to the (Q, 2) answer read back, on
  the host clock (the collectives run, over one rank).

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 20
back-to-back calls), `device_ms`, the card's time a call
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel), `grids`,
the `__global__` launches of one call (kernels.grid_launches), and
`calls`, its wrapper calls (kernels.LAUNCHES). For the host-clock row:
`ms` (chip_smoke.host_ms). Needs one NVIDIA card."""

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

S, R = 1 << 20, 1024  # phase 4: n_spans_b, n_res_b
BL_M4 = 3  # phase 15's last stacked fold
BL, T, N_PRESENT, N_ABSENT = 12, 1 << 15, 48, 16  # phase 15's run 1
PAD = 2**31 - 1


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    calls = sum(kernels.LAUNCHES.values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids, "calls": calls}


def res_inputs(rng):
    """Tables of R codes (-1 among them, as a padded table holds) and
    res_idx rows in [-1, R): one (S,) row and a (BL_M4, S) stack."""
    tabs = [rng.integers(-1, 5000, R).astype(np.int32) for _ in range(2)]
    idx = rng.integers(-1, R, S).astype(np.int32)
    stab = rng.integers(-1, 5000, (BL_M4, R)).astype(np.int32)
    sidx = rng.integers(-1, R, (BL_M4, S)).astype(np.int32)
    return tabs, idx, stab, sidx


def res_want(tab: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """The reference's clamped gather, PAD_I32 where res_idx < 0."""
    r = tab.shape[-1]
    g = np.take_along_axis(tab, np.clip(idx, 0, r - 1), axis=-1) if idx.ndim == 2 \
        else tab[np.clip(idx, 0, r - 1)]
    return np.where(idx >= 0, g, np.int32(-(2**31))).astype(np.int32)


def find_inputs(rng):
    """BL sorted (T, 4) indexes (signed lanes, lexicographic), the last
    two empty (n_valid 0, as a stack padded to the mesh holds); queries:
    N_PRESENT rows of the blocks (the last full block's row 0 also in
    block 1) and N_ABSENT random ids."""
    ids = np.full((BL, T, 4), PAD, np.int32)
    nv = np.asarray([T] * (BL - 2) + [0, 0], np.int32)
    for b in range(BL - 2):
        ids[b] = np.unique(rng.integers(-(2**31), 2**31 - 1, (T, 4), dtype=np.int64)
                           .astype(np.int32), axis=0)
    shared = ids[BL - 3, 0].copy()
    one = np.concatenate([ids[1, : T - 1], shared[None]])
    ids[1] = one[np.lexsort(one.T[::-1])]
    blocks = rng.integers(0, BL - 2, N_PRESENT - 1)
    rows = rng.integers(0, T, N_PRESENT - 1)
    present = np.concatenate([ids[blocks, rows], shared[None]])
    absent = rng.integers(-(2**31), 2**31 - 1, (N_ABSENT, 4), dtype=np.int64).astype(np.int32)
    return ids, nv, np.concatenate([present, absent]).astype(np.int32)


def elect_want(ids: np.ndarray, nv: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """(Q, 2) [highest block holding the id, its row], (-1, -1) for a miss."""
    out = np.full((queries.shape[0], 2), -1, np.int32)
    for qi, q in enumerate(queries):
        for b in range(ids.shape[0]):
            hit = np.nonzero((ids[b, : nv[b]] == q).all(axis=1))[0]
            if hit.size:
                out[qi] = (b, hit[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=16)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stage_elect_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.parallel import find as PF  # noqa: F401 -- registers the "find" body
    from tempo_tpu_torch.parallel import launch
    from tempo_tpu_torch.parallel import mesh as PM

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    new = hasattr(kernels, "res_to_span_many")  # this change's entry points
    out = {"tree": args.tree, "new": new, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    # ---- K4
    tabs_np, idx_np, stab_np, sidx_np = res_inputs(rng)
    tabs = [torch.from_numpy(t).to(dev) for t in tabs_np]
    idx = torch.from_numpy(idx_np).to(dev)
    stab, sidx = torch.from_numpy(stab_np).to(dev), torch.from_numpy(sidx_np).to(dev)
    if new:
        def two():
            return kernels.res_to_span_many(tabs, idx)

        def m4():
            return kernels.res_to_span_many([stab], sidx)[0]
    else:
        def two():
            return [kernels.res_to_span(t, idx) for t in tabs]

        def m4():
            return torch.stack([kernels.res_to_span(stab[b], sidx[b]) for b in range(BL_M4)])

    def one():
        return kernels.res_to_span(tabs[0], idx)

    for name, fn, want in (("k4_one", one, [res_want(tabs_np[0], idx_np)]),
                           ("k4_two", two, [res_want(t, idx_np) for t in tabs_np]),
                           ("k4_m4", m4, [res_want(stab_np, sidx_np)])):
        got = fn()
        got = [got] if isinstance(got, torch.Tensor) and name != "k4_two" else list(got)
        if not all(np.array_equal(g.cpu().numpy(), w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from the reference's gather")
        out[name] = timed(kernels, fn)
    del tabs, idx, stab, sidx

    # ---- M1
    ids_np, nv_np, q_np = find_inputs(rng)
    want = elect_want(ids_np, nv_np, q_np)
    if (want[:, 0] >= 0).sum() != N_PRESENT or want[N_PRESENT - 1, 0] != BL - 3:
        raise AssertionError("find inputs: the present ids or the shared one are not as built")
    ids, nv, qs = (torch.from_numpy(a).to(dev) for a in (ids_np, nv_np, q_np))
    steps = T.bit_length()
    out["k3"] = timed(kernels, lambda: kernels.find_rows(ids, qs, nv, steps))
    if new:
        def elect():
            return kernels.find_elect(ids, qs, nv, steps, 0)

        k = elect().cpu().numpy()
        got = np.stack([(k >> 32).astype(np.int32),
                        (k & 0xFFFFFFFF).astype(np.uint32).view(np.int32)], axis=1)
    else:
        def elect():
            rows = kernels.find_rows(ids, qs, nv, steps)
            best = kernels.find_elect(rows, 0)
            return best, kernels.find_elect(rows, 0, best)

        best, row = elect()
        got = torch.stack([best, row], dim=1).cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError("elect differs from the numpy answer")
    out["elect"] = timed(kernels, elect)
    tmp = tempfile.mkdtemp(prefix="stage_elect_ab")
    mesh = launch.init_controller(1, f"file://{tmp}/pg", "nccl", dev, timeout_s=60)
    try:
        body, static = PM.PROGRAMS["find"], {"n_steps": steps}
        ops = {"ids": ids, "n_valid": nv, "queries": qs}

        def path():
            return body(mesh, static, ops)

        if not np.array_equal(np.asarray(path()), want):
            raise AssertionError("find_body differs from the numpy answer")
        out["find_body"] = {"ms": host_ms(path, reps=20, rounds=5, warm=3)}
    finally:
        launch.shutdown(mesh, [])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
