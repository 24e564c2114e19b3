"""The single binary's wiring of the write path's metrics leg (port of
the part of tempo_tpu/services/app.py that connects the distributor's
streaming tap to the metrics-generator). The App class itself, with its
HTTP surface and service roles, is not ported yet.
"""

from __future__ import annotations


def generator_window_tap(ingester, generator):
    """The distributor's `generator_window` for an in-process ingester
    and generator (App._generator_window, services/app.py:391-405 of the
    JAX package). It runs on the distributor's tap worker: each
    segment's coded span columns come from the tenant instance's
    ColumnarIngest -- the one decode of that segment, whose cache the
    live head's refresh reads later -- and the window folds into the
    generator."""

    def tap(tenant: str, segs: list, push_ts: float) -> None:
        col = ingester.instance(tenant).columnar
        cols = []
        for seg in segs:
            feat = col.features_for(seg)
            if feat.spans is not None:
                cols.append(feat.spans)
        if cols:
            generator.push_window(tenant, cols, col.dict, push_ts)

    return tap
