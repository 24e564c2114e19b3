"""The TEMPO_* environment knobs of the read plane (the frontend's
result cache, retry budget and affinity placement), with the defaults
the JAX package's readers apply (tempo_tpu/config_registry.py KNOBS;
the steal timeout's is services/frontend.AFFINITY_STEAL_MS there). A
typed read path: get() refuses a name missing here. The circuit
breakers read their own TEMPO_BREAKER_* knobs (util/breaker.py).
"""

from __future__ import annotations

import os

# env name -> (type, default, one-line doc)
KNOBS: dict[str, tuple[str, str, str]] = {
    "TEMPO_AFFINITY": (
        "bool", "1",
        "cache-affinity query placement across device domains (0 = off)"),
    "TEMPO_AFFINITY_STEAL_MS": (
        "float", "75.0",
        "idle-domain work-steal patience before breaking affinity"),
    "TEMPO_RESULT_CACHE": (
        "bool", "1",
        "frontend query-result cache ahead of queue admission (0 = "
        "every query executes; byte-identical to a cacheless build)"),
    "TEMPO_RESULT_CACHE_EXTEND": (
        "bool", "1",
        "incremental extension of cached results for moving now-edge "
        "ranges (0 = exact-range hits only)"),
    "TEMPO_RESULT_CACHE_LIVE_WINDOW_S": (
        "float", "30.0",
        "trailing window treated as mutable live head: ranges ending "
        "inside it key on the ingester live generation, and extension "
        "prefixes stop this far behind now"),
    "TEMPO_RESULT_CACHE_MAX_BYTES": (
        "int", "67108864",
        "result-cache LRU budget in serialized-payload bytes"),
    "TEMPO_RESULT_CACHE_TTL_S": (
        "float", "300.0",
        "result-cache entry lifetime; bounds staleness from spans "
        "arriving later than the live window into old ranges"),
    "TEMPO_RETRY_BUDGET": (
        "int", "0",
        "per-query retry budget override (0 = max(4, jobs/4))"),
}


def get(name: str) -> str:
    """The knob's value from the environment, else its default."""
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}: add it to tempo_tpu_torch/util/knobs.py")
    return os.environ.get(name, KNOBS[name][1])


def get_bool(name: str) -> bool:
    return get(name) not in ("", "0", "false")


def get_int(name: str) -> int:
    try:
        return int(float(get(name)))
    except ValueError:
        return int(float(KNOBS[name][1] or 0))


def get_float(name: str) -> float:
    try:
        return float(get(name))
    except ValueError:
        return float(KNOBS[name][1] or 0)
