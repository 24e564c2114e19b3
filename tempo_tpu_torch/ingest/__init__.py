"""The write path's columnar ingest plane (port of tempo_tpu/ingest/).

OTLP push windows append to the WAL as single windowed records with a
CRC each (walcodec, the "w2" format db/wal writes and replays), and
segments decode once into coded features shared by live-search staging
and the WAL's feature checkpoints (columnar.ColumnarIngest over the
never-remapping LiveDict).
"""

from .columnar import (
    ColumnarIngest,
    LiveDict,
    SegFeatures,
    compute_features,
    kv_pair_key,
)
from .walcodec import WAL2_VERSION

__all__ = [
    "ColumnarIngest",
    "LiveDict",
    "SegFeatures",
    "WAL2_VERSION",
    "compute_features",
    "kv_pair_key",
]
