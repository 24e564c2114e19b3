"""Circuit breakers + per-query retry budgets (port of
tempo_tpu/util/breaker.py: the read-path armor).

CircuitBreaker: error-rate tripping with half-open probes. A leg
(backend block jobs, a remote ingester client) records each outcome into a
sliding time window; once volume and error rate cross the thresholds
the breaker opens and `allow()` sheds callers fast instead of letting
every query pay the full failure (timeout, retries, hedges) against a
dying dependency. After `open_s` it half-opens: a bounded number of
probe calls go through; all-success closes it, any failure re-opens.
Sheds land on the EXISTING per-class failure policy: a shed search
shard degrades coverage (partial results, query still 200), while
find/metrics queries -- whose shard-loss rule forbids silent partials
-- fail FAST with the breaker open instead of timing out against the
dead dependency. Either way no call pays the failing leg's latency.

RetryBudget: one counter per query capping TOTAL retries across all of
its shard jobs. Per-job retry caps compose multiplicatively with shard
fan-out -- a dying backend used to be able to trigger jobs x retries
extra load exactly when it could least afford it. The budget makes the
worst case additive.

Registry: breakers are process-wide singletons by leg name, so the
frontend, the querier legs and /metrics all see one state (this
package's registry, apart from the JAX package's). Defaults come from
TEMPO_BREAKER_* env vars read at creation time.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from .metrics import Counter, Gauge

STATES = ("closed", "half_open", "open")

# env-tunable creation defaults
ENV_DEFAULTS = {
    "window_s": ("TEMPO_BREAKER_WINDOW_S", 30.0),
    "min_volume": ("TEMPO_BREAKER_MIN_VOLUME", 8),
    "error_rate": ("TEMPO_BREAKER_ERROR_RATE", 0.5),
    "open_s": ("TEMPO_BREAKER_OPEN_S", 5.0),
    "probes": ("TEMPO_BREAKER_PROBES", 2),
    "probe_timeout_s": ("TEMPO_BREAKER_PROBE_TIMEOUT_S", 30.0),
}

STATE_GAUGE = Gauge(
    "tempo_circuit_breaker_state",
    help="breaker state by leg (0 closed, 1 half-open, 2 open)")
TRANSITIONS = Counter(
    "tempo_circuit_breaker_transitions_total",
    help="breaker state transitions by leg and destination state")
SHEDS = Counter(
    "tempo_circuit_breaker_sheds_total",
    help="calls refused fast by an open breaker, by leg")


class CircuitOpen(Exception):
    """Raised/recorded when a breaker sheds a call. Deliberately NOT an
    OSError: a shed must not be retried into the same open breaker."""


def _env_num(name: str, default):
    try:
        raw = os.environ.get(name, "")
        return type(default)(raw) if raw else default
    except ValueError:
        return default


class CircuitBreaker:
    def __init__(self, name: str, window_s: float | None = None,
                 min_volume: int | None = None,
                 error_rate: float | None = None,
                 open_s: float | None = None, probes: int | None = None,
                 probe_timeout_s: float | None = None):
        env = {k: _env_num(e, d) for k, (e, d) in ENV_DEFAULTS.items()}
        self.name = name
        self.window_s = window_s if window_s is not None else env["window_s"]
        self.min_volume = (min_volume if min_volume is not None
                           else env["min_volume"])
        self.error_rate = (error_rate if error_rate is not None
                           else env["error_rate"])
        self.open_s = open_s if open_s is not None else env["open_s"]
        self.probes = probes if probes is not None else env["probes"]
        self.probe_timeout_s = (probe_timeout_s if probe_timeout_s is not None
                                else env["probe_timeout_s"])
        # every guarded call crosses allow()/record() here
        self._lock = threading.Lock()
        self.state = "closed"
        self._window: deque = deque()  # (monotonic, ok)
        self._opened_at = 0.0
        # half-open probe slots: grant timestamps, so a slot whose call
        # never comes back (dead worker, expired lease -- paths that
        # allow() without a matching record()) is reclaimed after
        # probe_timeout_s instead of wedging the breaker half-open
        self._probe_slots: list[float] = []
        self._probe_successes = 0
        self.transitions: list[tuple[float, str]] = []  # (unix, to-state)
        self._publish_locked()

    # ------------------------------------------------------------ state
    def _to_locked(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        self.transitions.append((time.time(), state))
        del self.transitions[:-64]
        TRANSITIONS.inc(labels=f'leg="{self.name}",to="{state}"')
        self._publish_locked()

    def _publish_locked(self) -> None:
        STATE_GAUGE.set(STATES.index(self.state),
                        labels=f'leg="{self.name}"')

    def allow(self) -> bool:
        """May a call proceed on this leg right now? False = shed."""
        with self._lock:
            now = time.monotonic()
            if self.state == "open":
                if now - self._opened_at >= self.open_s:
                    self._to_locked("half_open")
                    self._probe_slots = []
                    self._probe_successes = 0
                else:
                    SHEDS.inc(labels=f'leg="{self.name}"')
                    return False
            if self.state == "half_open":
                # reclaim slots whose call never reported back
                cutoff = now - self.probe_timeout_s
                self._probe_slots = [t for t in self._probe_slots
                                     if t >= cutoff]
                if len(self._probe_slots) < self.probes:
                    self._probe_slots.append(now)
                    return True
                SHEDS.inc(labels=f'leg="{self.name}"')
                return False
            return True

    def record(self, ok: bool) -> None:
        with self._lock:
            now = time.monotonic()
            if self.state == "half_open":
                if self._probe_slots:
                    self._probe_slots.pop(0)
                if not ok:
                    self._opened_at = now
                    self._to_locked("open")
                    return
                self._probe_successes += 1
                if self._probe_successes >= self.probes:
                    self._window.clear()
                    self._to_locked("closed")
                return
            self._window.append((now, ok))
            cutoff = now - self.window_s
            while self._window and self._window[0][0] < cutoff:
                self._window.popleft()
            if self.state == "closed":
                vol = len(self._window)
                errs = sum(1 for _, o in self._window if not o)
                if vol >= self.min_volume and errs / vol >= self.error_rate:
                    self._opened_at = now
                    self._to_locked("open")

    def snapshot(self) -> dict:
        with self._lock:
            vol = len(self._window)
            errs = sum(1 for _, o in self._window if not o)
            return {
                "state": self.state,
                "window_volume": vol,
                "window_errors": errs,
                "error_rate": round(errs / vol, 4) if vol else 0.0,
                "transitions": [
                    {"at_unix": round(t, 3), "to": s}
                    for t, s in self.transitions[-8:]],
            }


class RetryBudget:
    """Total-retry cap shared by all shard jobs of one query."""

    def __init__(self, total: int):
        self.total = max(0, int(total))
        self.used = 0
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            if self.used < self.total:
                self.used += 1
                return True
            return False


# ------------------------------------------------------------ registry
_breakers: dict[str, CircuitBreaker] = {}
_registry_lock = threading.Lock()


def get_breaker(name: str, **params) -> CircuitBreaker:
    with _registry_lock:
        br = _breakers.get(name)
        if br is None:
            br = _breakers[name] = CircuitBreaker(name, **params)
        return br


def breakers_snapshot() -> dict:
    with _registry_lock:
        legs = list(_breakers.items())
    return {name: br.snapshot() for name, br in legs}


def reset_for_tests() -> None:
    with _registry_lock:
        _breakers.clear()


def metrics_lines() -> list[str]:
    return STATE_GAUGE.text() + TRANSITIONS.text() + SHEDS.text()


def help_entries() -> dict[str, str]:
    return {
        STATE_GAUGE.name: STATE_GAUGE.help,
        "tempo_circuit_breaker_transitions": TRANSITIONS.help,
        "tempo_circuit_breaker_sheds": SHEDS.help,
    }
