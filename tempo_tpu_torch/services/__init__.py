"""Service roles around the port's database (port of tempo_tpu/services/):
the distributor with its rate limiter and streaming generator tap, the
ingester and the per-tenant limits it enforces, the metrics-generator,
the compactor (ring-owned compaction and retention loops), the read
plane (querier, query frontend, result cache, querier worker) and the
App that wires them into one process behind the HTTP API."""
