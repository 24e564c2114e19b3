"""Time the compaction of chip_smoke.py's corpus (10 blocks of 32,768
traces of 32 spans, gzip, from the smoke's seed) through the compactor
service, `services.compactor.Compactor(db).run_once()`, in three
settings on one card in one run:

- `sequential`: concurrency 1, so `TempoDB.compact_once` a tenant;
- `pipeline_1g`: concurrency 2 under the shipped 1 GiB admission budget
  (`compact_tenants` over `db/compact_pipeline.CompactionPipeline`);
- `pipeline_8g`: concurrency 2 under 8 GiB, the smoke's phase 12.

    python3 scripts/compact_sweep_ab.py [--rounds 2] [--device cpu --blocks 4 --traces 64]

The corpus is built once; each run compacts a fresh copy of it, with
retention held off. The order is the three settings, then (with
--rounds 2) the same in reverse, so a drift of the host shows. Every
run's outputs must equal the first run's (chip_smoke.same_block). Prints
one JSON line a run (the wall on the host clock, the pipeline's stats)
and the card's name and power limit. Needs one NVIDIA card unless
--device cpu (a small check of the script itself)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import CODEC, N_BLOCKS, N_TRACES, SPANS_PER, TENANT, same_block  # noqa: E402

SETTINGS = {"sequential": (1, None), "pipeline_1g": (2, 1 << 30), "pipeline_8g": (2, 8 << 30)}


def out_key(m):
    return (m.compaction_level, m.total_traces, m.start_time_unix_nano, m.end_time_unix_nano)


def run(store: str, copy: str, label: str, device) -> tuple[dict, list]:
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.db import TempoDB, TempoDBConfig
    from tempo_tpu_torch.services.compactor import Compactor

    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(store, copy)
    db = TempoDB(TempoDBConfig(), backend=LocalBackend(copy), device=device)
    db.poll_now()
    cfg = db.cfg.compaction
    cfg.concurrency, cfg.pipeline_mem_budget_bytes = SETTINGS[label]
    cfg.retention_s = 10**10
    svc = Compactor(db)
    t0 = time.perf_counter()
    svc.run_once()
    wall = time.perf_counter() - t0
    if svc.stats.errors or not svc.stats.blocks_compacted:
        raise AssertionError(f"{label}: {svc.stats.blocks_compacted} blocks compacted, errors "
                             f"{svc.stats.errors!r}")
    db.poll_now()
    outs = sorted((m for m in db.metas(TENANT) if m.compaction_level > 0), key=out_key)
    row = {"run": label, "wall_s": wall, "blocks_compacted": svc.stats.blocks_compacted,
           "outputs": len(outs)}
    if cfg.concurrency > 1:
        st = db.compaction_stats.snapshot()
        row["pipeline"] = {k: st[k] for k in ("stage_seconds", "wall_seconds", "overlap_ratio",
                                              "prefetch", "max_jobs_inflight",
                                              "max_bytes_inflight")}
    return row, [(db.backend, m) for m in outs]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2, choices=(1, 2))
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--blocks", type=int, default=N_BLOCKS)
    ap.add_argument("--traces", type=int, default=N_TRACES)
    args = ap.parse_args()
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("compact_sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    from tempo_tpu_torch import kernels
    from tempo_tpu_torch.backend import LocalBackend
    from tempo_tpu_torch.util.synth import synth_block

    if args.device.startswith("cuda"):
        kernels.build()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
    else:
        smi = "not a card"
    tmp = tempfile.mkdtemp(prefix="compact-ab-")
    try:
        t0 = time.perf_counter()
        store = os.path.join(tmp, "store")
        rng, backend = np.random.default_rng(7), LocalBackend(store)
        for _ in range(args.blocks):
            synth_block(backend, TENANT, rng, args.traces, SPANS_PER, codec=CODEC)
        print(json.dumps({"corpus_blocks": args.blocks, "traces": args.traces,
                          "build_s": time.perf_counter() - t0, "smi": smi}), flush=True)
        order = list(SETTINGS)
        if args.rounds == 2:
            order += order[::-1]
        first = None
        for i, label in enumerate(order):
            row, outs = run(store, os.path.join(tmp, f"copy{i % 2}"), label, args.device)
            if first is None:
                first = (os.path.join(tmp, "first"), [m for _, m in outs])
                shutil.copytree(os.path.join(tmp, "copy0"), first[0])
            if len(outs) != len(first[1]):
                raise AssertionError(f"{label}: {len(outs)} outputs, {len(first[1])} first")
            be0 = LocalBackend(first[0])
            for (be, m), m0 in zip(outs, first[1]):
                same_block(be, m, be0, m0, f"{label} output {m.block_id}")
            row["equal_to_first"] = True
            row["at"] = time.strftime("%H:%M:%S")
            print(json.dumps(row), flush=True)
        print(smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
