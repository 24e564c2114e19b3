"""Token ring, replication sets, shuffle sharding, lifecycler (port of
tempo_tpu/ring/ring.py).

Reference anatomy (all via dskit in the reference):
- ring tokens: each instance owns N random uint32 tokens; a key routes
  to the first token clockwise and walks on for replicas
  (ring.DoBatch semantics, modules/distributor/distributor.go:373).
- shuffle sharding: per-tenant deterministic sub-ring
  (modules/distributor/distributor.go:414, pkg/scheduler/queue).
- lifecycler: instance join/heartbeat/leave; unhealthy instances are
  skipped and eventually forgotten (modules/generator/generator.go:25-27).

Tokens, replica walks and shards are pure functions of the members'
names and the key, equal to the JAX package's for the same inputs.
"""

from __future__ import annotations

import bisect
import random
import threading
import time
from dataclasses import dataclass, field
from enum import Enum

from ..util.hashing import fnv1a_32

NUM_TOKENS = 128
HEARTBEAT_TIMEOUT_S = 60.0


def deterministic_tokens(ring_key: str, instance_id: str,
                         num_tokens: int = NUM_TOKENS) -> list[int]:
    """The token set an instance owns in a ring, as a pure function of
    (ring_key, instance_id): every reader agrees on placement without
    any coordination beyond knowing the member's name, so tokens cannot
    depend on join order or wall time."""
    rng = random.Random(fnv1a_32(f"{ring_key}/{instance_id}".encode()))
    return sorted(rng.randrange(0, 2**32) for _ in range(num_tokens))


class InstanceState(str, Enum):
    JOINING = "JOINING"
    ACTIVE = "ACTIVE"
    LEAVING = "LEAVING"
    LEFT = "LEFT"


@dataclass
class InstanceDesc:
    instance_id: str
    addr: str = ""  # opaque transport address (in-process: registry key)
    state: InstanceState = InstanceState.JOINING
    tokens: list[int] = field(default_factory=list)
    heartbeat_ts: float = 0.0

    def healthy(self, now: float | None = None, timeout: float = HEARTBEAT_TIMEOUT_S) -> bool:
        now = now if now is not None else time.time()
        return self.state == InstanceState.ACTIVE and (now - self.heartbeat_ts) < timeout


class InMemoryKV:
    """The single-binary ring store (reference: dskit inmemory KV,
    cmd/tempo/main.go:186-194). Thread-safe."""

    def __init__(self):
        self._lock = threading.RLock()
        self._data: dict[str, dict[str, InstanceDesc]] = {}

    def update(self, ring_key: str, desc: InstanceDesc) -> None:
        with self._lock:
            self._data.setdefault(ring_key, {})[desc.instance_id] = desc

    def remove(self, ring_key: str, instance_id: str) -> None:
        with self._lock:
            self._data.get(ring_key, {}).pop(instance_id, None)

    def get_all(self, ring_key: str) -> dict[str, InstanceDesc]:
        with self._lock:
            return dict(self._data.get(ring_key, {}))


@dataclass
class ReplicationSet:
    instances: list[InstanceDesc]
    max_errors: int  # quorum slack: majority ((len-1)//2), EXCEPT rf=2
    # where it's len-1 (eventually-consistent minSuccess=1, Ring.get)


class Ring:
    """Read-side view over one ring key of a KV."""

    def __init__(self, kv: InMemoryKV, ring_key: str, replication_factor: int = 1,
                 heartbeat_timeout: float = HEARTBEAT_TIMEOUT_S):
        self.kv = kv
        self.ring_key = ring_key
        self.rf = replication_factor
        self.heartbeat_timeout = heartbeat_timeout
        # token-map cache keyed on the instance id set (the ingest path
        # calls get() once per trace). Per-key dict get/set are atomic,
        # so concurrent readers never see a torn key/map pair
        self._cache: dict[tuple, tuple[list[int], list[InstanceDesc]]] = {}

    # ------------------------------------------------------------ views
    def instances(self) -> list[InstanceDesc]:
        return sorted(self.kv.get_all(self.ring_key).values(), key=lambda d: d.instance_id)

    def healthy_instances(self, now: float | None = None) -> list[InstanceDesc]:
        return [d for d in self.instances() if d.healthy(now, self.heartbeat_timeout)]

    @staticmethod
    def _token_map(descs: list[InstanceDesc]) -> tuple[list[int], list[InstanceDesc]]:
        pairs = sorted(((t, d) for d in descs for t in d.tokens), key=lambda p: p[0])
        return [p[0] for p in pairs], [p[1] for p in pairs]

    # ------------------------------------------------------------ routing
    def get(self, token: int, now: float | None = None,
            instances: list[InstanceDesc] | None = None) -> ReplicationSet:
        """Replication set for a key token: walk clockwise collecting RF
        distinct healthy instances."""
        descs = instances if instances is not None else self.healthy_instances(now)
        if not descs:
            return ReplicationSet([], 0)
        key = tuple(d.instance_id for d in descs)
        hit = self._cache.get(key)
        if hit is None:
            hit = self._token_map(descs)
            if len(self._cache) >= 64:  # membership/shard churn bound
                self._cache.clear()
            self._cache[key] = hit
        tokens, owners = hit
        out: list[InstanceDesc] = []
        seen: set[str] = set()
        i = bisect.bisect_right(tokens, token) % len(tokens)
        for _ in range(len(tokens)):
            d = owners[i]
            if d.instance_id not in seen:
                out.append(d)
                seen.add(d.instance_id)
                if len(out) >= self.rf:
                    break
            i = (i + 1) % len(tokens)
        if self.rf == 2:
            # at RF=2 a majority quorum is ALL replicas, so one dead
            # ingester would fail every write until the heartbeat timeout
            # marks it out; the reference's EventuallyConsistentStrategy
            # (pkg/ring/ring.go:52-86) needs minSuccess=1 instead
            return ReplicationSet(out, max_errors=max(0, len(out) - 1))
        return ReplicationSet(out, max_errors=max(0, (len(out) - 1) // 2))

    def shuffle_shard(self, tenant: str, size: int) -> list[InstanceDesc]:
        """Deterministic per-tenant sub-ring (reference: dskit shuffle
        sharding used for generators + queriers). size<=0 => all."""
        descs = self.healthy_instances()
        if size <= 0 or size >= len(descs):
            return descs
        rng = random.Random(fnv1a_32(tenant.encode()))
        return rng.sample(descs, size)

    def owner_of(self, job_hash: str,
                 instances: list[InstanceDesc] | None = None) -> str | None:
        """First owner clockwise of a key's token. `instances` overrides
        the healthy-instance view for callers that keep their own
        membership."""
        rs = self.get(fnv1a_32(job_hash.encode()), instances=instances)
        return rs.instances[0].instance_id if rs.instances else None

    def owns(self, instance_id: str, job_hash: str) -> bool:
        """Ring-sharded job ownership: the instance owning the token of
        fnv32(job_hash) owns the job (modules/compactor/compactor.go:187)."""
        return self.owner_of(job_hash) == instance_id


class Lifecycler:
    """Joins an instance into a ring and heartbeats it.

    With `prune_timeout` set, every heartbeat also evicts ring entries
    whose own heartbeat is older than the timeout: a killed peer never
    writes a LEAVE, so without pruning it stays a token owner in the
    shared KV and receives doomed writes. A pruned-but-alive peer writes
    itself back on its next heartbeat.
    """

    def __init__(self, kv: InMemoryKV, ring_key: str, instance_id: str, addr: str = "",
                 num_tokens: int = NUM_TOKENS, heartbeat_period: float = 5.0,
                 prune_timeout: float | None = None):
        self.kv = kv
        self.ring_key = ring_key
        self.desc = InstanceDesc(
            instance_id=instance_id,
            addr=addr or instance_id,
            tokens=deterministic_tokens(ring_key, instance_id, num_tokens),
        )
        self.heartbeat_period = heartbeat_period
        self.prune_timeout = prune_timeout
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def join(self, state: InstanceState = InstanceState.ACTIVE) -> None:
        self.desc.state = state
        self.desc.heartbeat_ts = time.time()
        self.kv.update(self.ring_key, self.desc)

    def heartbeat(self) -> None:
        self.desc.heartbeat_ts = time.time()
        self.kv.update(self.ring_key, self.desc)

    def prune(self, now: float | None = None) -> list[str]:
        """Evict peers whose heartbeat exceeded prune_timeout; returns
        the pruned instance ids."""
        if self.prune_timeout is None:
            return []
        now = time.time() if now is None else now
        pruned = []
        for iid, desc in self.kv.get_all(self.ring_key).items():
            if iid == self.desc.instance_id:
                continue
            if now - desc.heartbeat_ts > self.prune_timeout:
                self.kv.remove(self.ring_key, iid)
                pruned.append(iid)
        return pruned

    def start(self) -> None:
        """Join, then heartbeat (and prune) every heartbeat_period on a
        daemon thread until leave()."""
        self.join()

        def loop():
            while not self._stop.wait(self.heartbeat_period):
                self.heartbeat()
                self.prune()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name=f"lifecycler-{self.ring_key}")
        self._thread.start()

    def leave(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.heartbeat_period + 1.0)
        self.desc.state = InstanceState.LEFT
        self.kv.remove(self.ring_key, self.desc.instance_id)
