"""Time B9c (the cut's row-group stats) and B10a (the bloom union) of one
checkout of the PyTorch/CUDA port on the card, so that two trees can be
held against each other on the same machine:

    python3 scripts/rowgroup_union_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version, and prints one JSON line.

B9c (kernels.rowgroup_minmax) at a cut's 2^20 spans and a flush's 2^22
in groups of 65,536 (block/schema.py DEFAULT_ROW_GROUP_SPANS), and 1,000
spans in groups of 333:
- b9c_<n>: warm, the same inputs every call (they stay in the 50 MB L2);
- b9c_<n>_cold: `device_ms` only, the calls taking copies of the inputs
  in turn, more than 120 MB of them, so that each call reads from HBM;
- b9c_host: CutEngine.rowgroup_minmax at 2^20 spans, numpy in and out,
  host clock (the uploads, the launch, the download, the synchronize);
  beside it `fill_ms`, the copy of both columns into one pinned buffer,
  and `upload_ms`, that buffer's upload and a synchronize.
On a tree with kernels.rowgroup_plan, `plan` gives each shape's (C, G,
CTAs).

B10a (kernels.bloom_union) at (K, S, W) = (4, 1, 16,384) (blocks 0-3's
blooms in chip_smoke.py's phase 4), (4, 12, 32,768) and (10, 1, 16,384)
(K past one chunk of 8 loads), warm; (4, 12, 32,768) also cold as
above. b10a_host: ops/bloom_ops.union_blooms of 4 blooms of 1 x 2^19
and of 4 of 12 x 2^20 bits, host clock.

With --split (a tree with kernels.rowgroup_plan), `split` adds the
device µs a call of B9c (2^20 and 2^22, warm and cold) and B10a ((4, 12,
32,768), warm and cold) beside the same kernels built from copies of
csrc/blockcut.cu and csrc/bloom.cu with the other caching of their
loads: B9c's default-cached loads made evict-first (`__ldcs`), B10a's
evict-first loads and store (`__ldcs`, `__stcs`) made default.

For each wrapper: `ms`, a call (chip_smoke.cuda_ms: CUDA events over 20
back-to-back calls), `device_ms`, the card's time a call
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel), and
`grids`, the `__global__` launches of one call (kernels.grid_launches).
For the host-clock rows: `ms` (chip_smoke.host_ms). Needs one NVIDIA
card."""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

GROUP = 65_536
RG_SHAPES = ((1 << 20, GROUP), (1 << 22, GROUP), (1000, 333))
UNION_SHAPES = ((4, 1, 16_384), (4, 12, 32_768), (10, 1, 16_384))
COLD_BYTES = 120 << 20  # the inputs' copies a cold timing cycles through
# the other caching of each kernel's loads (and B10a's store): source ->
# (entry point, its own caching, the other, the substitutions)
ALTERNATE = {
    "blockcut": ("tt_rowgroup", "default", "evict-first",
                 [("x[u] = __ldg(s4 + q);", "x[u] = __ldcs(s4 + q);"),
                  ("y[u] = __ldg(d4 + q);", "y[u] = __ldcs(d4 + q);")]),
    "bloom": ("tt_bloom_union", "evict-first", "default",
              [("v[u] = __ldcs(in + ", "v[u] = __ldg(in + "),
               ("        __stcs(out + i, acc);", "        out[i] = acc;")]),
}


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids}


def cold(fn, copies: list) -> dict:
    """device_ms of fn over the copies in turn."""
    turn = itertools.cycle(copies)
    return {"device_ms": device_ms(lambda: fn(*next(turn)), reps=40), "copies": len(copies)}


def alternate_fns(kernels) -> dict:
    """Entry point -> the same entry point of a copy of its source with
    the other caching (ALTERNATE)."""
    here = os.path.join(os.path.dirname(kernels.BUILD_DIR), "rowgroup_union_split")
    os.makedirs(here, exist_ok=True)
    fns = {}
    for src, (name, _, _, subs) in ALTERNATE.items():
        with open(os.path.join(kernels.CSRC, src + ".cu")) as f:
            text = f.read()
        for old, new in subs:
            if text.count(old) != 1:
                raise AssertionError(f"{src}.cu: the anchor {old!r} is not there once")
            text = text.replace(old, new)
        path, lib = os.path.join(here, src + "_alt.cu"), os.path.join(here, f"lib{src}_alt.so")
        with open(path, "w") as f:
            f.write(text)
        p = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", lib,
                            path], capture_output=True, text=True)
        if p.returncode:
            raise AssertionError(f"nvcc {src}_alt: {p.stdout}{p.stderr}")
        fn = getattr(ctypes.CDLL(lib), name)
        fn.argtypes = kernels._SIGNATURES[name][1]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--split", action="store_true",
                    help="also time evict-first loads (a tree with rowgroup_plan)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("rowgroup_union_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block.bloom import ShardedBloom
    from tempo_tpu_torch.ops import blockcut as BC
    from tempo_tpu_torch.ops import bloom_ops as BO

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    new = hasattr(kernels, "rowgroup_plan")  # this change's entry points
    out = {"tree": args.tree, "new": new, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    # ---- B9c
    for n, group in RG_SHAPES:
        sm = rng.integers(0, 3_600_000, n).astype(np.int32)
        du = rng.integers(0, 2**31 - 1, n).astype(np.int32)
        s, d = torch.from_numpy(sm).to(dev), torch.from_numpy(du).to(dev)
        want = BC._rowgroup_plain(s.cpu(), d.cpu(), group)
        if not torch.equal(kernels.rowgroup_minmax(s, d, group).cpu(), want):
            raise AssertionError(f"b9c {n} / {group} differs from its plain version")
        key = f"b9c_{n}_{group}"
        out[key] = timed(kernels, lambda: kernels.rowgroup_minmax(s, d, group))
        if new:
            out[key]["plan"] = list(kernels.rowgroup_plan(n, group))
        if n >= 1 << 20:
            copies = [(s.clone(), d.clone()) for _ in range(-(-COLD_BYTES // (8 * n)))]
            out[key + "_cold"] = cold(lambda a, b: kernels.rowgroup_minmax(a, b, group), copies)
            del copies
        if n == 1 << 20:
            eng = BC.CutEngine(dev)
            ref = BC.CutEngine("cpu").rowgroup_minmax(sm, du, group)
            if not all(np.array_equal(g, w) for g, w in
                       zip(eng.rowgroup_minmax(sm, du, group), ref)):
                raise AssertionError("b9c_host differs from the CPU cut engine")
            out["b9c_host"] = {"ms": host_ms(lambda: eng.rowgroup_minmax(sm, du, group),
                                             reps=10, rounds=5, warm=3)}
            # the pinned route's two host steps alone: the fill of one
            # pinned buffer with both columns, and its upload
            pinned = torch.empty(2 * n, dtype=torch.int32, pin_memory=True)
            h = pinned.numpy()

            def fill():
                h[:n] = sm
                h[n:] = du

            def upload():
                pinned.to(dev, non_blocking=True)
                torch.cuda.synchronize()

            out["b9c_host"]["fill_ms"] = host_ms(fill, reps=10, rounds=5, warm=3)
            out["b9c_host"]["upload_ms"] = host_ms(upload, reps=10, rounds=5, warm=3)
        del s, d

    # ---- B10a
    for shape in UNION_SHAPES:
        x = torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
                             .view(np.int32)).to(dev)
        want = np.bitwise_or.reduce(x.cpu().numpy(), axis=0)
        if not np.array_equal(kernels.bloom_union(x).cpu().numpy(), want):
            raise AssertionError(f"b10a {shape} differs from np.bitwise_or.reduce")
        key = "b10a_" + "x".join(map(str, shape))
        out[key] = timed(kernels, lambda: kernels.bloom_union(x))
        if shape == (4, 12, 32_768):
            copies = [(x.clone(),) for _ in range(-(-COLD_BYTES // (4 * x.numel())))]
            out[key + "_cold"] = cold(kernels.bloom_union, copies)
            del copies
        del x
    for k, s_n, bits in ((4, 1, 1 << 19), (4, 12, 1 << 20)):
        blooms = []
        for _ in range(k):
            b = ShardedBloom(s_n, bits)
            b.words = rng.integers(0, 2**32, b.words.shape, dtype=np.uint64).astype(np.uint32)
            blooms.append(b)
        want = BO.union_blooms(blooms, "cpu").words
        if not np.array_equal(BO.union_blooms(blooms, dev).words, want):
            raise AssertionError("b10a_host differs from the CPU union")
        out[f"b10a_host_{k}x{s_n}x{bits}"] = {
            "ms": host_ms(lambda: BO.union_blooms(blooms, dev), reps=10, rounds=5, warm=3)}
    if args.split and new:
        out["split"] = split(kernels, rng, dev)
    out["at"] = time.strftime("%H:%M:%S")
    print(json.dumps(out), flush=True)
    return 0


def split(kernels, rng, dev) -> dict:
    """Device µs a call, each kernel's own caching against the other."""
    import torch

    fns = kernels._load()
    own = {name: fns[name] for name, *_ in ALTERNATE.values()}
    cases = []
    for n in (1 << 20, 1 << 22):
        s = torch.from_numpy(rng.integers(0, 3_600_000, n).astype(np.int32)).to(dev)
        d = torch.from_numpy(rng.integers(0, 2**31 - 1, n).astype(np.int32)).to(dev)
        copies = [(s.clone(), d.clone()) for _ in range(-(-COLD_BYTES // (8 * n)))]
        cases.append((f"b9c {n}", "blockcut",
                      lambda a, b: kernels.rowgroup_minmax(a, b, GROUP), copies))
    x = torch.from_numpy(rng.integers(0, 2**32, (4, 12, 32_768), dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).to(dev)
    copies = [(x.clone(),) for _ in range(-(-COLD_BYTES // (4 * x.numel())))]
    cases.append(("b10a 4x12x32768", "bloom", kernels.bloom_union, copies))
    out = {}
    try:
        for which, table in ((1, own), (2, alternate_fns(kernels))):
            fns.update(table)
            for what, src, fn, copies in cases:
                label = ALTERNATE[src][which]
                want = fn(*copies[0])
                if not torch.equal(fn(*copies[1]), want):
                    raise AssertionError(f"split {what} {label}: the copies differ")
                out[f"{what} {label} warm"] = device_ms(lambda: fn(*copies[0])) * 1e3
                out[f"{what} {label} cold"] = cold(fn, copies)["device_ms"] * 1e3
    finally:
        fns.update(own)
    return out


if __name__ == "__main__":
    sys.exit(main())
