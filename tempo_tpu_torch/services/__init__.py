"""Service roles around the port's database (port of tempo_tpu/services/):
the ingester and the per-tenant limits it enforces."""
