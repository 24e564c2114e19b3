"""Per-tenant runtime limits (port of tempo_tpu/services/overrides.py;
reference: modules/overrides/limits.go).

Defaults mirror limits.go:90-108. The per-tenant YAML file and its
hot reload are not ported yet: limits come from `defaults` and the
`per_tenant` overlay the caller sets.
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
    """Defaults + per-tenant overlay."""

    defaults: Limits = field(default_factory=Limits)
    per_tenant: dict[str, Limits] = field(default_factory=dict)

    def for_tenant(self, tenant: str) -> Limits:
        return self.per_tenant.get(tenant, self.defaults)
