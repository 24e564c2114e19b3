"""Time B10b (the bloom's batch test) and its path call,
`ops/bloom_ops.batch_test`, of one checkout of the PyTorch/CUDA port on
the card, so that two trees can be held against each other on the same
machine:

    python3 scripts/bloom_test_ab.py --tree <checkout> [--split]

run once per tree, in turns (parent, change, change, parent). It imports
`tempo_tpu_torch` from the given checkout (which builds its own kernels
there) and asserts that it did, makes the inputs from a seed with numpy,
checks every answer against the host's `ShardedBloom.test`, and prints
one JSON line.

The inputs have the shapes of chip_smoke.py's phase 4c: 32,768 sorted
seeded 16-byte ids in a bloom of their own geometry
(`ShardedBloom.for_estimated_items`: one shard of 2^19 bits, block 0's),
tested as
- `q64`: 48 of those ids (present) and 16 absent ones;
- `q32768`: all 32,768 (every one present).

For each size:
- `kernel`: the wrapper with its inputs already on the card (the parent:
  `kernels.bloom_test` over the host's (Q, 7, 2) pairs and (Q, 7) bits;
  the change: over the (Q, 16) id slots and their lengths): `ms`, a call
  (chip_smoke.cuda_ms), `device_ms` (chip_smoke.device_ms, queued behind
  a sleep kernel) and `grids` (the `__global__` launches of one call);
- `path`: `batch_test(words, ...)` from the numpy words, numpy in and
  numpy out, on the host clock (chip_smoke.host_ms);
- `path_card_words` (the change only): the same with the words already
  a CUDA tensor, so only the ids travel.

With --split, `steps` times the path call's steps on the host clock,
each ended by a synchronize: the parent's `positions()` (the host's
hashing), its three pageable uploads, the launch and the `.cpu()`; the
change's packing of the ids into the pinned buffer, its one upload, the
launch, and the pinned download, and `from_packed`: the upload, the
launch and the download end to end from the packed buffer, what a caller
that held its ids as one array would pay. Needs one NVIDIA card."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import cuda_ms, device_ms, host_ms  # noqa: E402 -- one definition of the timings

N_IDS, N_OWN, N_ABSENT = 32_768, 48, 16


def timed(kernels, fn) -> dict:
    kernels.reset_counts()
    fn()
    grids = sum(kernels.grid_launches().values())
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn), "grids": grids}


def synced(torch, fn):
    def run():
        out = fn()
        torch.cuda.synchronize()
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="a checkout of the repo (its root)")
    ap.add_argument("--seed", type=int, default=19)
    ap.add_argument("--split", action="store_true", help="also time the path call's steps")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bloom_test_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.tree))
    import tempo_tpu_torch
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.block.bloom import _K, ShardedBloom
    from tempo_tpu_torch.ops import bloom_ops as BO

    root = os.path.dirname(os.path.dirname(os.path.abspath(tempo_tpu_torch.__file__)))
    assert root == os.path.abspath(args.tree), tempo_tpu_torch.__file__
    assert kernels.BUILD_DIR.startswith(os.path.join(root, "build")), kernels.BUILD_DIR
    dev = torch.device("cuda", 0)
    kernels.build()
    new = hasattr(BO, "test_ids")  # this change's id route
    out = {"tree": args.tree, "new": new, "kind": torch.cuda.get_device_name(0),
           "smi": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()}

    rng = np.random.default_rng(args.seed)
    ids = np.unique(rng.integers(0, 256, (N_IDS, 16), dtype=np.uint8), axis=0)
    tids = [r.tobytes() for r in ids]
    bloom = ShardedBloom.for_estimated_items(len(tids))
    bloom.add_array(ids)
    words, bits, shards = bloom.words, bloom.shard_bits, bloom.n_shards
    absent = [rng.integers(0, 256, 16, dtype=np.uint8).tobytes() for _ in range(N_ABSENT)]
    own = [tids[i] for i in rng.choice(len(tids), N_OWN, replace=False)]
    out["geometry"] = [shards, bits]
    w_card = torch.from_numpy(words.view(np.int32)).to(dev)
    for label, q in (("q64", own + absent), ("q32768", tids)):
        want = np.asarray([bloom.test(t) for t in q])
        got = BO.batch_test(words, bits, shards, q, dev)
        if not np.array_equal(got, want):
            raise AssertionError(f"{label}: batch_test differs from the host bloom test")
        row = {"ids": len(q), "present": int(want.sum())}
        if new:
            slots, lens = np.empty((len(q), 16), np.uint8), np.empty(len(q), np.uint8)
            BO.pack_ids(q, slots, lens)
            s_d, l_d = torch.from_numpy(slots).to(dev), torch.from_numpy(lens).to(dev)

            def kernel():
                return kernels.bloom_test(w_card, s_d, l_d, shards, bits, _K)
            row["path_card_words"] = {"ms": host_ms(
                lambda: BO.batch_test(w_card, bits, shards, q), reps=10, rounds=5, warm=3)}
            if not np.array_equal(BO.batch_test(w_card, bits, shards, q), want):
                raise AssertionError(f"{label}: batch_test from card words differs")
        else:
            wi, bi = BO.positions(q, shards, bits)
            wi_d, bi_d = torch.from_numpy(wi).to(dev), torch.from_numpy(bi).to(dev)

            def kernel():
                return kernels.bloom_test(w_card, wi_d, bi_d)
        if not np.array_equal(kernel().cpu().numpy(), want):
            raise AssertionError(f"{label}: the kernel differs from the host bloom test")
        row["kernel"] = timed(kernels, kernel)
        row["path"] = {"ms": host_ms(lambda: BO.batch_test(words, bits, shards, q, dev),
                                     reps=10 if len(q) < 1000 else 2, rounds=5, warm=2)}
        if args.split:
            steps = {}
            if new:
                n = len(q)
                assert words.nbytes % 16 == 0, words.shape
                host = torch.empty(words.nbytes + 17 * n, dtype=torch.uint8, pin_memory=True)
                h = host.numpy()
                at = words.nbytes + 16 * n

                def pack():
                    h[:words.nbytes] = words.view(np.uint8).reshape(-1)
                    BO.pack_ids(q, h[words.nbytes:at].reshape(n, 16), h[at:])
                buf = host.to(dev)
                wv = buf[:words.nbytes].view(torch.int32).view(words.shape)
                res = kernels.bloom_test(wv, buf[words.nbytes:at].view(n, 16), buf[at:], shards,
                                         bits, _K)
                back = torch.empty(n, dtype=torch.bool, pin_memory=True)
                steps["pack"] = host_ms(pack, reps=5, rounds=5, warm=2)
                steps["upload"] = host_ms(synced(torch, lambda: host.to(dev, non_blocking=True)),
                                          reps=10, rounds=5, warm=2)
                steps["launch"] = host_ms(synced(torch, lambda: kernels.bloom_test(
                    wv, buf[words.nbytes:at].view(n, 16), buf[at:], shards, bits, _K)),
                    reps=10, rounds=5, warm=2)
                steps["download"] = host_ms(synced(torch, lambda: back.copy_(
                    res, non_blocking=True)), reps=10, rounds=5, warm=2)

                def from_packed():
                    buf = host.to(dev, non_blocking=True)
                    r = kernels.bloom_test(buf[:words.nbytes].view(torch.int32).view(words.shape),
                                           buf[words.nbytes:at].view(n, 16), buf[at:], shards,
                                           bits, _K)
                    return back.copy_(r, non_blocking=True)
                steps["from_packed"] = host_ms(synced(torch, from_packed), reps=10, rounds=5,
                                               warm=2)
            else:
                steps["positions"] = host_ms(lambda: BO.positions(q, shards, bits),
                                             reps=10 if len(q) < 1000 else 1, rounds=5, warm=1)
                steps["uploads"] = host_ms(synced(torch, lambda: (
                    torch.from_numpy(words.view(np.int32)).to(dev), torch.from_numpy(wi).to(dev),
                    torch.from_numpy(bi).to(dev))), reps=10, rounds=5, warm=2)
                steps["launch"] = host_ms(synced(torch, kernel), reps=10, rounds=5, warm=2)
                res = kernel()
                steps["download"] = host_ms(lambda: res.cpu(), reps=10, rounds=5, warm=2)
            row["steps"] = steps
        out[label] = row
    out["at"] = time.strftime("%H:%M:%S")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
