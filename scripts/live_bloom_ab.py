"""Time B7c (the live head's delta append) and B9b (the cut's bloom) of
one checkout of the PyTorch/CUDA port on the card, so that two trees can
be held against each other on the same machine:

    python3 scripts/live_bloom_ab.py --tree <checkout>

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks each kernel against its plain version, and prints one JSON line.

B7c at chip_smoke.py's phase 13 first delta refresh (window 48): kv
columns of 2^20 rows holding 710,897 rows and taking 142,686 more (a
padded delta of 262,144), name columns of 2^19 holding 317,120 and
taking 63,668 (65,536):
- b7c: the refresh's appends on the card, their deltas already there:
  four kernels.live_append calls on a tree without
  kernels.live_append_many, one live_append_many call on a tree with it;
- b7c_host: LiveStager._upload_locked's append part on the host clock: a
  stager whose host tails hold the refresh's rows and whose device
  columns are the refresh before, no dirty slot, so that _upload_locked
  does the appends alone (the pads, the uploads, the launches), then a
  synchronize (`ms`; `enqueue_ms` without it);
- b7c_cold: b7c's device µs with the call taking 4 copies of its inputs
  in turn, 60 MB past the 50 MB L2, so that each call reads from HBM (b7c
  repeats one call on inputs that stay in L2).

B9b at phase 11's cut (32,768 ids into one shard of 2^19 bits):
- b9b: on the card: the parent's copy and OR kernels over the host's
  deduped (word, bit) pairs, the change's ids -> words kernel;
- b9b_host: CutEngine.bloom_bits, numpy in and out, host clock (on the
  parent the host hashing included).

With --split (a tree with the ids -> words kernel), `b9b_split` adds
B9b's device µs a call from a copy of csrc/blockcut.cu whose kernel
hashes every id but sets no bit ("hash only"), beside the whole kernel,
at one shard and at 12 shards of 2^20 bits (the atomics spread over 1.5
MB of words).

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

SLOTS, SLOT_B = 12_288, 1 << 14
KV_B, KV_OLD, KV_NEW = 1 << 20, 710_897, 853_583
NAME_B, NAME_OLD, NAME_NEW = 1 << 19, 317_120, 380_788
N_IDS = 32_768
# the ids -> words kernel with its atomics taken out (the hash kept live)
HASH_ONLY = ("        if ((bit >> 5) < n_words) atomicOr(words + (bit >> 5), "
             "1u << (unsigned)(bit & 31));", "        if (bit == ~0ull) words[0] = 1u;")


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids}


def hash_only_fn(kernels):
    """tt_bloom_bits of a copy of blockcut.cu whose kernel sets no bit."""
    here = os.path.join(os.path.dirname(kernels.BUILD_DIR), "b9b_split")
    os.makedirs(here, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "blockcut.cu")) as f:
        src = f.read()
    if src.count(HASH_ONLY[0]) != 1:
        raise AssertionError("blockcut.cu: the atomicOr anchor is not there once")
    path, lib = os.path.join(here, "blockcut_hash.cu"), os.path.join(here, "libblockcut_hash.so")
    with open(path, "w") as f:
        f.write(src.replace(*HASH_ONLY))
    p = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o", lib, path],
                       capture_output=True, text=True)
    if p.returncode:
        raise AssertionError(f"nvcc hash only: {p.stdout}{p.stderr}")
    fn = ctypes.CDLL(lib).tt_bloom_bits
    fn.argtypes = kernels._SIGNATURES["tt_bloom_bits"][1]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--split", action="store_true", help="also split B9b (hash only)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("live_bloom_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block.bloom import ShardedBloom
    from tempo_tpu_torch.ops import blockcut as BC
    from tempo_tpu_torch.ops import livestage as L
    from tempo_tpu_torch.ops.device import PAD_I32

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    rng = np.random.default_rng(args.seed)
    new = hasattr(kernels, "live_append_many")  # this change's entry points
    out = {"tree": args.tree, "new": new, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    # ---- B7c: a stager at the refresh before, its tails at the refresh
    st = L.LiveStager(device=dev)
    st.n_slots = SLOTS
    st._grow_slots_locked(SLOT_B)
    st.alive[:SLOTS] = 1
    st.id_codes[:SLOTS] = rng.integers(-2**31, 2**31, (SLOTS, 4), dtype=np.int64)
    for kind, n_new in (("kv", KV_NEW), ("name", NAME_NEW)):
        setattr(st, f"{kind}_owner", rng.integers(0, SLOTS, n_new).astype(np.int32))
        setattr(st, f"{kind}_code", rng.integers(0, 5000, n_new).astype(np.int32))
    st.n_kv, st.n_name = KV_OLD, NAME_OLD
    dev0 = st._upload_locked()  # full: the refresh before
    st.n_kv, st.n_name = KV_NEW, NAME_NEW
    rows0 = (SLOTS, KV_OLD, NAME_OLD)

    def appends():
        st._dev, st._dev_rows, st._dirty_slots = dev0, rows0, set()
        return st._upload_locked()

    def appends_synced():
        d = appends()
        torch.cuda.synchronize()
        return d

    got = appends_synced()
    if st.last_upload["full"]:
        raise AssertionError("b7c_host: the refresh re-uploaded whole")
    for kind, n, fill in (("kv", KV_NEW, 0), ("name", NAME_NEW, 0)):
        for col, pad in ((f"{kind}_owner", fill), (f"{kind}_code", PAD_I32)):
            want = np.full(dev0[col].shape[0], pad, np.int32)
            want[:n] = getattr(st, col)[:n]
            if not np.array_equal(got[col].cpu().numpy(), want):
                raise AssertionError(f"b7c_host: {col} differs from the host tail")
    out["b7c_host"] = {"ms": host_ms(appends_synced, reps=10, rounds=5, warm=3),
                       "enqueue_ms": host_ms(appends, reps=10, rounds=5, warm=3)}
    torch.cuda.synchronize()

    cols = ["kv_owner", "kv_code", "name_owner", "name_code"]
    olds = [KV_OLD, KV_OLD, NAME_OLD, NAME_OLD]
    news = [KV_NEW, KV_NEW, NAME_NEW, NAME_NEW]
    fills = [0, PAD_I32, 0, PAD_I32]
    dsts = [dev0[c] for c in cols]
    padded = []
    for c, o, n, fill in zip(cols, olds, news, fills):
        db = L._delta_bucket(n - o)
        padded.append((getattr(st, c)[o:n], db, fill))
    want = [got[c] for c in cols]
    if new:
        src, segs = L.upload_deltas(padded, [d.shape[0] for d in dsts], olds, dev)

        def append(dsts, src):
            return kernels.live_append_many(dsts, src, segs, olds)
    else:
        src = [torch.from_numpy(L.pad_rows(r, db, np.int32(f))).to(dev) for r, db, f in padded]

        def append(dsts, src):
            return [kernels.live_append(d, x, o) for d, x, o in zip(dsts, src, olds)]
    if not all(torch.equal(g, w) for g, w in zip(append(dsts, src), want)):
        raise AssertionError("b7c differs from the stager's columns")
    out["b7c"] = timed(kernels, lambda: append(dsts, src))
    # the same call over 4 copies of its inputs in turn (4 x 15 MB of
    # columns and deltas, past the 50 MB L2): each call reads from HBM
    copies = [([d.clone() for d in dsts],
               src.clone() if new else [x.clone() for x in src]) for _ in range(4)]
    turn = itertools.cycle(copies)
    out["b7c_cold"] = {"device_ms": device_ms(lambda: append(*next(turn)), reps=40)}
    out["b7c_rows"] = sum(d.shape[0] for d in dsts)
    del st, dev0, got, want, dsts, copies, turn

    # ---- B9b: 32,768 sorted seeded ids into their own geometry
    ids = np.unique(rng.integers(0, 256, (N_IDS, 16), dtype=np.uint8), axis=0)
    tids = [r.tobytes() for r in ids]
    bloom = ShardedBloom.for_estimated_items(len(tids))
    bits, words0 = bloom.shard_bits, np.zeros_like(bloom.words)
    ref = BC.CutEngine("cpu").bloom_bits(words0, ids if new else tids, bits)
    eng = BC.CutEngine(dev)
    zeros = torch.zeros(words0.shape, dtype=torch.int32, device=dev)
    if new:
        ids_d = torch.from_numpy(ids).to(dev)

        def b9b(w=zeros.clone()):
            return kernels.bloom_bits(w, ids_d, bits, BC._K)

        def host():
            return eng.bloom_bits(words0, ids, bits)
    else:
        wi, bt, _ = BC.bloom_scatter(tids, words0.shape[0], bits)
        wi, bt = torch.from_numpy(wi).to(dev), torch.from_numpy(bt.view(np.int32)).to(dev)

        def b9b():
            return kernels.bloom_bits(zeros, wi, bt)

        def host():
            return eng.bloom_bits(words0, tids, bits)
    if not np.array_equal(b9b().cpu().numpy().view(np.uint32), ref) or \
            not np.array_equal(host(), ref):
        raise AssertionError("b9b differs from the CPU cut engine")
    out["b9b"] = timed(kernels, b9b)
    out["b9b_host"] = {"ms": host_ms(host, reps=5, rounds=5, warm=2)}
    out["b9b_ids"], out["b9b_words"] = len(tids), int(words0.size)
    out["b9b_popcount"] = int(np.unpackbits(ref.view(np.uint8)).sum())
    if args.split and new:
        fns = kernels._load()
        whole = fns["tt_bloom_bits"]
        split = {}
        wide = torch.zeros((12, (1 << 20) // 32), dtype=torch.int32, device=dev)
        try:
            for label, fn in (("whole", whole), ("hash only", hash_only_fn(kernels))):
                fns["tt_bloom_bits"] = fn
                split[f"1 shard {label}"] = device_ms(b9b) * 1e3
                split[f"12 shards {label}"] = device_ms(
                    lambda: kernels.bloom_bits(wide, ids_d, 1 << 20, BC._K)) * 1e3
        finally:
            fns["tt_bloom_bits"] = whole
        out["b9b_split"] = split
    out["at"] = time.strftime("%H:%M:%S")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
