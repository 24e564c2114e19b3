"""Token ring, replication sets and the lifecycler (port of tempo_tpu/ring)."""

from .ring import (HEARTBEAT_TIMEOUT_S, NUM_TOKENS, InMemoryKV, InstanceDesc, InstanceState,
                   Lifecycler, ReplicationSet, Ring, deterministic_tokens)

__all__ = ["HEARTBEAT_TIMEOUT_S", "NUM_TOKENS", "InMemoryKV", "InstanceDesc", "InstanceState",
           "Lifecycler", "ReplicationSet", "Ring", "deterministic_tokens"]
