"""Per-tenant runtime limits (port of tempo_tpu/services/overrides.py;
reference: modules/overrides/limits.go).

Defaults mirror limits.go:90-108; a per-tenant overrides file (YAML,
read with PyYAML, imported only when a file is set) hot-reloads on a
period, same as the reference's runtime-config watcher. RateLimiter is
the distributor's per-tenant ingestion bucket; QueryAdmission is the
query frontend's per-tenant QoS gate.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field, fields, replace


@dataclass(frozen=True)
class Limits:
    # ingest (limits.go:92-99)
    ingestion_rate_limit_bytes: int = 15 * 1024 * 1024
    ingestion_burst_size_bytes: int = 20 * 1024 * 1024
    max_traces_per_user: int = 10_000
    max_bytes_per_trace: int = 5 * 1024 * 1024
    # query
    max_bytes_per_tag_values_query: int = 5 * 1024 * 1024
    max_search_duration_s: int = 0  # 0 = unlimited
    max_queriers_per_tenant: int = 0  # queue shuffle-shard size; 0 = all
    # read-plane QoS (frontend admission); 0 = unlimited
    max_concurrent_queries: int = 0
    max_inflight_query_bytes: int = 0
    # storage
    block_retention_s: int = 0  # 0 = use compactor default
    # generator
    metrics_generator_processors: tuple[str, ...] = ()
    metrics_generator_max_active_series: int = 0
    metrics_generator_ring_size: int = 0  # shuffle-shard size; 0 = all
    # per-tenant registry staleness window; 0 = generator default
    metrics_generator_stale_series_s: float = 0.0


@dataclass
class Overrides:
    """Defaults + per-tenant overlay, optionally file-backed."""

    defaults: Limits = field(default_factory=Limits)
    per_tenant: dict[str, Limits] = field(default_factory=dict)
    path: str = ""
    reload_period_s: float = 10.0

    def __post_init__(self):
        self._lock = threading.Lock()
        self._mtime = 0.0
        self._stop = threading.Event()
        self._reloader: threading.Thread | None = None
        if self.path:
            self.reload()

    def start_reloader(self) -> None:
        """Hot reload every reload_period_s (reference reloads the
        runtime-config file every 10s, modules/overrides/overrides.go)."""
        if self._reloader is not None or not self.path:
            return

        def loop():
            while not self._stop.wait(self.reload_period_s):
                try:
                    self.reload()
                except Exception:  # noqa: BLE001 - keep last good overrides
                    pass

        self._reloader = threading.Thread(target=loop, daemon=True, name="overrides-reload")
        self._reloader.start()

    def stop(self) -> None:
        self._stop.set()

    def for_tenant(self, tenant: str) -> Limits:
        with self._lock:
            return self.per_tenant.get(tenant, self.defaults)

    # ------------------------------------------------------------ reload
    def reload(self) -> None:
        """Read the overrides file if it changed (reference reloads every
        10s; callers drive the period)."""
        if not self.path or not os.path.exists(self.path):
            return
        mtime = os.path.getmtime(self.path)
        if mtime == self._mtime:
            return
        import yaml

        with open(self.path) as f:
            data = yaml.safe_load(f) or {}
        valid = {f.name for f in fields(Limits)}
        per_tenant = {}
        for tenant, vals in (data.get("overrides") or {}).items():
            kw = {k: v for k, v in (vals or {}).items() if k in valid}
            if "metrics_generator_processors" in kw:
                kw["metrics_generator_processors"] = tuple(kw["metrics_generator_processors"])
            per_tenant[tenant] = replace(self.defaults, **kw)
        with self._lock:
            self.per_tenant = per_tenant
            self._mtime = mtime


class QueryAdmission:
    """Per-tenant read-plane QoS gate (used by the query frontend):
    bounds how many queries a tenant runs concurrently and how many
    block bytes it may reference in flight, so one heavy tenant cannot
    monopolize the queue or churn every other tenant's staged device
    columns out of HBM. Overrides-driven like the ingest limits;
    try_admit never blocks -- an over-budget query sheds with 429
    (frontend.TooManyRequests), the reference's queue-full response
    applied per tenant instead of per process."""

    def __init__(self, overrides: Overrides):
        self.overrides = overrides
        self._lock = threading.Lock()
        self._queries: dict[str, int] = {}  # tenant -> queries in flight
        self._bytes: dict[str, int] = {}  # tenant -> referenced block bytes

    def try_admit(self, tenant: str, est_bytes: int = 0) -> str | None:
        """Admit one query referencing est_bytes of block data. Returns
        None on admission, else the name of the refusing budget
        ("concurrency" | "bytes"). A tenant with nothing in flight
        always admits: a single query larger than its own byte budget
        is the budget's unit of progress, not a livelock."""
        lim = self.overrides.for_tenant(tenant)
        with self._lock:
            q = self._queries.get(tenant, 0)
            b = self._bytes.get(tenant, 0)
            if q > 0:
                if 0 < lim.max_concurrent_queries <= q:
                    return "concurrency"
                if (lim.max_inflight_query_bytes > 0
                        and b + est_bytes > lim.max_inflight_query_bytes):
                    return "bytes"
            self._queries[tenant] = q + 1
            self._bytes[tenant] = b + est_bytes
            return None

    def release(self, tenant: str, est_bytes: int = 0) -> None:
        """Return one admitted query's budget. Must be called exactly
        once per successful try_admit (callers pair them try/finally)."""
        with self._lock:
            q = self._queries.get(tenant, 0) - 1
            if q <= 0:
                self._queries.pop(tenant, None)
                self._bytes.pop(tenant, None)
            else:
                self._queries[tenant] = q
                self._bytes[tenant] = max(
                    0, self._bytes.get(tenant, 0) - est_bytes)

    def inflight(self, tenant: str) -> tuple[int, int]:
        """(queries, bytes) a tenant currently holds (status surfaces)."""
        with self._lock:
            return self._queries.get(tenant, 0), self._bytes.get(tenant, 0)


class RateLimiter:
    """Token bucket per tenant over pushed bytes (reference: distributor
    rate limit, modules/distributor/distributor.go:312-319)."""

    def __init__(self, overrides: Overrides):
        self.overrides = overrides
        self._lock = threading.Lock()
        self._buckets: dict[str, tuple[float, float]] = {}  # tenant -> (tokens, last_ts)

    def peek(self, tenant: str, nbytes: int, now: float) -> bool:
        """Would a request of nbytes pass right now? Consumes nothing:
        the cheap pre-serialization gate -- callers pass a LOWER BOUND on
        the request's wire size, so a refusal here is also a refusal of
        the exact-bytes check, and a tenant over its limit never pays
        segment-encoding CPU for a doomed request."""
        lim = self.overrides.for_tenant(tenant)
        rate = lim.ingestion_rate_limit_bytes
        burst = lim.ingestion_burst_size_bytes
        if rate <= 0:
            return True
        with self._lock:
            tokens, last = self._buckets.get(tenant, (float(burst), now))
            return min(float(burst), tokens + (now - last) * rate) >= nbytes

    def allow(self, tenant: str, nbytes: int, now: float) -> bool:
        """Take nbytes from the tenant's bucket if it holds them."""
        lim = self.overrides.for_tenant(tenant)
        rate = lim.ingestion_rate_limit_bytes
        burst = lim.ingestion_burst_size_bytes
        if rate <= 0:
            return True
        with self._lock:
            tokens, last = self._buckets.get(tenant, (float(burst), now))
            tokens = min(float(burst), tokens + (now - last) * rate)
            if tokens >= nbytes:
                self._buckets[tenant] = (tokens - nbytes, now)
                return True
            self._buckets[tenant] = (tokens, now)
            return False
