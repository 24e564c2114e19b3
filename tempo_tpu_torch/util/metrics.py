"""Minimal Prometheus-style instruments (port of tempo_tpu/util/metrics.py:
the instruments the read plane and the App use; without its Registry and
the histograms' exemplars, which link to self-traces).

The role promauto plays across the reference (histograms + counters on
every subsystem, e.g. modules/distributor/distributor.go:56-103,
tempodb/blocklist/poller.go:26-68), sized to this codebase: lock-free
enough for the hot paths (float adds under a small lock), rendered to
exposition text by /metrics.

Exposition: instruments emit raw sample lines (`.text()`); the
/metrics endpoint runs everything through `render_openmetrics`, which
groups samples into families, synthesizes the `# TYPE` / `# HELP`
lines strict OpenMetrics parsers require, and never renders an empty
`{}` label set.
"""

from __future__ import annotations

import re
import threading
import time

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _fmt(name: str, labels: str) -> str:
    """Sample name with labels; empty label sets render bare (OpenMetrics
    forbids `name{}`)."""
    return f"{name}{{{labels}}}" if labels else name


def escape_label(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline).
    Any caller-controlled string reaching a label value -- tenant names
    off the X-Scope-OrgID header above all -- must pass through here:
    one unescaped quote corrupts every subsequent /metrics scrape line."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
             .replace("\n", "\\n"))


class Histogram:
    """Cumulative-bucket latency histogram."""

    def __init__(self, name: str, buckets: tuple[float, ...] = DEFAULT_BUCKETS,
                 help: str = ""):
        self.name = name
        self.help = help
        self.buckets = buckets
        self._lock = threading.Lock()
        self._counts: dict[str, list[int]] = {}
        self._sums: dict[str, float] = {}
        self._totals: dict[str, int] = {}

    def observe(self, value: float, labels: str = "") -> None:
        with self._lock:
            counts = self._counts.get(labels)
            if counts is None:
                counts = self._counts[labels] = [0] * (len(self.buckets) + 1)
                self._sums[labels] = 0.0
                self._totals[labels] = 0
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[labels] += value
            self._totals[labels] += 1

    def text(self) -> list[str]:
        out = []
        with self._lock:
            for labels, counts in self._counts.items():
                sep = "," if labels else ""
                cum = 0
                for i, edge in enumerate(self.buckets):
                    cum += counts[i]
                    out.append(f'{self.name}_bucket{{{labels}{sep}le="{edge}"}} {cum}')
                cum += counts[-1]
                out.append(f'{self.name}_bucket{{{labels}{sep}le="+Inf"}} {cum}')
                out.append(f"{_fmt(self.name + '_sum', labels)} {self._sums[labels]:.6f}")
                out.append(f"{_fmt(self.name + '_count', labels)} {self._totals[labels]}")
        return out


class Counter:
    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._vals: dict[str, float] = {}

    def inc(self, n: float = 1, labels: str = "") -> None:
        with self._lock:
            self._vals[labels] = self._vals.get(labels, 0) + n

    def text(self) -> list[str]:
        with self._lock:
            return [f"{_fmt(self.name, labels)} {v:g}"
                    for labels, v in self._vals.items()]


class Gauge:
    """Point-in-time value (blocklist length, queue depth, a breaker's
    state): set at scrape or event time, rendered like any other
    instrument."""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._vals: dict[str, float] = {}

    def set(self, value: float, labels: str = "") -> None:
        with self._lock:
            self._vals[labels] = float(value)

    def text(self) -> list[str]:
        with self._lock:
            return [f"{_fmt(self.name, labels)} {v:g}"
                    for labels, v in self._vals.items()]


class _Timed:
    __slots__ = ("hist", "labels", "t0")

    def __init__(self, hist, labels):
        self.hist = hist
        self.labels = labels

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self.t0, self.labels)
        return False


def timed(hist: Histogram, labels: str = ""):
    """Context manager: observe the block's wall time."""
    return _Timed(hist, labels)


# ------------------------------------------------------------ exposition

_NAME_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)")
_EMPTY_BRACES_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)\{\}")


def _family_of(name: str, hist_bases: set[str]) -> tuple[str, str]:
    """Sample name -> (family, type) per OpenMetrics suffix rules."""
    if name.endswith("_bucket") and name[:-7] in hist_bases:
        return name[:-7], "histogram"
    if name.endswith("_sum") and name[:-4] in hist_bases:
        return name[:-4], "histogram"
    if name.endswith("_count") and name[:-6] in hist_bases:
        return name[:-6], "histogram"
    if name.endswith("_total"):
        return name[:-6], "counter"
    return name, "gauge"


def render_openmetrics(lines: list[str], helps: dict[str, str] | None = None) -> str:
    """Raw sample lines -> OpenMetrics exposition text (no EOF marker).

    Groups samples into metric families, synthesizes `# TYPE`/`# HELP`
    per family (type inferred from the `_total` / `_bucket`+`le=` suffix
    conventions every emitter in this repo follows), strips empty `{}`
    label sets, and drops exact-duplicate sample lines -- strict parsers
    reject duplicates and interleaved families. Sample lines themselves
    pass through verbatim."""
    helps = helps or {}
    seen: set[str] = set()
    samples: list[tuple[str, str]] = []  # (name, line)
    hist_bases: set[str] = set()
    for ln in lines:
        if not ln or ln.startswith("#"):
            continue
        ln = _EMPTY_BRACES_RE.sub(r"\1", ln)
        if ln in seen:
            continue
        seen.add(ln)
        m = _NAME_RE.match(ln)
        if m is None:
            continue
        name = m.group(1)
        samples.append((name, ln))
        if name.endswith("_bucket") and 'le="' in ln:
            hist_bases.add(name[:-7])
    families: dict[str, tuple[str, list[str]]] = {}
    order: list[str] = []
    for name, ln in samples:
        fam, typ = _family_of(name, hist_bases)
        if fam not in families:
            families[fam] = (typ, [])
            order.append(fam)
        families[fam][1].append(ln)
    out: list[str] = []
    for fam in order:
        typ, fam_lines = families[fam]
        out.append(f"# HELP {fam} {helps.get(fam, f'tempo-tpu {typ} {fam}')}")
        out.append(f"# TYPE {fam} {typ}")
        out.extend(fam_lines)
    return "\n".join(out) + "\n" if out else ""
