"""Service roles around the port's database (port of tempo_tpu/services/):
the distributor with its rate limiter and streaming generator tap, the
ingester and the per-tenant limits it enforces, and the
metrics-generator."""
