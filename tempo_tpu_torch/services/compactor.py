"""Compactor service: ring-sharded ownership of the compaction and
retention loops over TempoDB (port of tempo_tpu/services/compactor.py;
the reference's modules/compactor/compactor.go -- Owns (:187, FNV-1a 32
of the job hash against ring tokens), wrapping tempodb's compaction and
retention drivers, tempodb/compactor.go:66-132, retention.go:14-90).

`run_once` takes the pipelined sweep (TempoDB.compact_tenants, on the
database's device) when resolve_concurrency(...) is above 1, else
compact_once a tenant; retention follows, a tenant at a time. The
reference's cycle-duration histogram is not ported yet (its metrics
plane): `CompactorStats.cycle_seconds` keeps each cycle's wall.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..db.compact_pipeline import resolve_concurrency
from ..db.tempodb import TempoDB
from ..ring.ring import Ring


@dataclass
class CompactorStats:
    runs: int = 0
    blocks_compacted: int = 0
    blocks_retained: int = 0
    errors: list = field(default_factory=list)
    # wall seconds of each compaction cycle (a tenant's compact_once, or
    # one pipelined sweep)
    cycle_seconds: list = field(default_factory=list)


class Compactor:
    def __init__(self, db: TempoDB, ring: Ring | None = None, instance_id: str = "",
                 cycle_s: float = 30.0):
        self.db = db
        self.ring = ring
        self.instance_id = instance_id
        self.cycle_s = cycle_s
        self.stats = CompactorStats()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # install ring ownership into the db's compaction driver
        if ring is not None and instance_id:
            self.db.owns_job = lambda h: ring.owns(instance_id, h)

    def run_once(self) -> None:
        self.stats.runs += 1
        if resolve_concurrency(self.db.cfg.compaction) > 1:
            self._run_once_pipelined()
            return
        for tenant in self.db.tenants():
            try:
                t0 = time.perf_counter()
                results = self.db.compact_once(tenant)
                self.stats.cycle_seconds.append(time.perf_counter() - t0)
                self.stats.blocks_compacted += sum(len(r.compacted_ids) for r in results)
                ret = self.db.retention_once(tenant)
                self.stats.blocks_retained += len(ret.deleted) if ret else 0
            except Exception as e:  # noqa: BLE001 - a tenant's fault must not stop the cycle
                self.stats.errors.append(e)

    def _run_once_pipelined(self) -> None:
        """Every tenant's owned jobs through the compaction pipeline;
        retention stays a tenant at a time (marker and delete IO, with
        the same ownership filter either way)."""
        try:
            t0 = time.perf_counter()
            outcomes = self.db.compact_tenants()
            self.stats.cycle_seconds.append(time.perf_counter() - t0)
            for oc in outcomes:
                if oc.error is not None:
                    self.stats.errors.append(oc.error)
                else:
                    self.stats.blocks_compacted += len(oc.result.compacted_ids)
        except Exception as e:  # noqa: BLE001 - the sweep's fault is recorded
            self.stats.errors.append(e)
        for tenant in self.db.tenants():
            try:
                ret = self.db.retention_once(tenant)
                self.stats.blocks_retained += len(ret.deleted) if ret else 0
            except Exception as e:  # noqa: BLE001 - a tenant's fault must not stop the cycle
                self.stats.errors.append(e)

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.cycle_s):
                self.run_once()

        self._thread = threading.Thread(target=loop, daemon=True, name="compactor")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
