"""The block cut's row-group stats (B9c): the port's plain version on
the CPU against the JAX package's jitted program
(tempo_tpu/ops/blockcut.py:149-158, run on the CPU as
tests/test_ingest.py:266 runs it) and its numpy twin, with partial last
groups and int32 extremes. Inputs come from numpy with a seed; the
outputs are int32, so the comparison is exact."""

import numpy as np
import pytest
import torch

from tempo_tpu.ops import blockcut as RB
from tempo_tpu_torch.ops import blockcut as B

INT_MIN, INT_MAX = -(2**31), 2**31 - 1
CPU = B.CutEngine("cpu")


RG_CASES = [(1, 1), (9, 4), (257, 64), (70_000, 65_536), (131_072, 65_536), (1000, 333)]


@pytest.mark.parametrize("spans,group", RG_CASES)
@pytest.mark.parametrize("values", ["random", "extremes"])
def test_rowgroup_minmax_matches_reference(spans, group, values):
    rng = np.random.default_rng(spans + group)
    start_ms = rng.integers(0, 2**31 - 1, size=spans).astype(np.int32)
    dur_us = rng.integers(0, 2**31 - 1, size=spans).astype(np.int32)
    if values == "extremes":
        start_ms[::2], start_ms[1::3] = INT_MIN, INT_MAX
        dur_us[::5] = INT_MAX
        dur_us[1::2] = INT_MIN
    bounds = list(range(0, spans, group)) + [spans]
    got = CPU.rowgroup_minmax(start_ms, dur_us, group)
    dev = RB.rowgroup_minmax_device(start_ms, dur_us, bounds)
    host = RB.rowgroup_minmax_host(start_ms, dur_us, bounds)
    for g, d, h in zip(got, dev, host):
        assert g.dtype == np.int32 and g.shape == (len(bounds) - 1,)
        np.testing.assert_array_equal(g, np.asarray(d))
        np.testing.assert_array_equal(g, h)


def test_rowgroup_minmax_needs_rows():
    with pytest.raises(ValueError):
        B.rowgroup_minmax(torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32), 4)
