"""Anonymous usage statistics (port of tempo_tpu/services/usagestats.py;
reference: pkg/usagestats).

The reference generates a persistent cluster seed (a UUID stored as a
backend object so every module of a cluster reports under one identity)
and periodically reports counters. This deployment-local variant keeps
the same seed protocol and report shape but never leaves the process:
the report is served at /status/usage-stats (operators can forward it
themselves; a tracing backend should not phone home by default).
"""

from __future__ import annotations

import json
import time
import uuid

from ..backend.base import DoesNotExist, RawBackend

_SEED_TENANT = "__cluster__"  # tenant-level object, like the reference's seed file
_SEED_NAME = "usage-stats-seed.json"


class UsageReporter:
    def __init__(self, backend: RawBackend, target: str):
        self.backend = backend
        self.target = target
        self.started_at = time.time()
        self._seed: dict | None = None

    def seed(self) -> dict:
        """Load-or-create the cluster seed (reference: usagestats seed
        object with leader election by first-writer-wins; a lost race
        just means re-reading the winner's seed)."""
        if self._seed is not None:
            return self._seed
        try:
            self._seed = json.loads(
                self.backend.read_tenant_object(_SEED_TENANT, _SEED_NAME)
            )
        except DoesNotExist:
            seed = {"UID": str(uuid.uuid4()), "created_at": time.time()}
            self.backend.write_tenant_object(
                _SEED_TENANT, _SEED_NAME, json.dumps(seed).encode()
            )
            try:  # re-read: another module may have won the write race
                self._seed = json.loads(
                    self.backend.read_tenant_object(_SEED_TENANT, _SEED_NAME)
                )
            except DoesNotExist:
                self._seed = seed
        return self._seed

    def report(self, app) -> dict:
        """The reference's report shape: seed + edition + target +
        uptime + coarse counters."""
        out = {
            "clusterID": self.seed().get("UID", ""),
            "edition": "cuda-oss",
            "target": self.target,
            "uptime_s": round(time.time() - self.started_at, 1),
            "metrics": {},
        }
        m = out["metrics"]
        if app.distributor is not None:
            m["spans_received"] = app.distributor.stats.spans_received
            m["bytes_received"] = app.distributor.stats.bytes_received
        if app.ingester is not None:
            m["blocks_flushed"] = sum(
                i.blocks_flushed for i in app.ingester.instances.values()
            )
        if app.compactor is not None:
            m["blocks_compacted"] = app.compactor.stats.blocks_compacted
        if app.querier is not None:
            m["searches"] = app.querier.stats.searches
            m["traces_found"] = app.querier.stats.traces_found
        m["tenants"] = len(app.db.blocklist.tenants())
        m["blocklist_length"] = sum(
            len(app.db.blocklist.metas(t)) for t in app.db.blocklist.tenants()
        )
        return out
