"""Byte-bounded distinct-string collection for the tag and tag-value
APIs (port of tempo_tpu/util/distinct.py; the reference's
DistinctStringCollector, pkg/util/distinct_string_collector.go:15):
collect unique strings until a byte budget is hit, then drop further
additions and set `exceeded`.
"""

from __future__ import annotations


class DistinctStringCollector:
    def __init__(self, max_bytes: int = 0):
        self._max = max_bytes
        self._size = 0
        self._values: set[str] = set()
        self.exceeded = False

    def collect(self, s: str) -> None:
        if s in self._values:
            return
        n = len(s.encode("utf-8"))
        if self._max and self._size + n > self._max:
            self.exceeded = True
            return
        self._values.add(s)
        self._size += n

    def strings(self) -> list[str]:
        return sorted(self._values)

    def __len__(self) -> int:
        return len(self._values)
