"""B7a's one-launch route (csrc/livestage.cu: one `__global__` a chunk of
32 codes carried by value, the row pass over the snapshot's real rows
only, a PAD_I32 code of a padded kind set on slot 0 directly) as a numpy
model, held against the JAX package's jitted program
(tempo_tpu/ops/livestage.py:147 `_compiled_live_filter`, on the CPU),
which reads every padded row, and against the port's plain version: a
PAD_I32 query code over padded buckets and over full ones, owners below
0 and past slot_b, duplicate codes, 0, 1, 32, 33 and 70 codes, n_slots
in {0, 5, slot_b, slot_b + 7} and the clipped int32 thresholds. Every
output is a bool: exact."""

import os
import re

import numpy as np
import pytest
import torch
from torch_tile_cases import LIVE_CASES, PAD_I32, live_case

from tempo_tpu.ops import livestage as R
from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import livestage as L

CHUNK = 32
SHAPES = {"padded": (1024, 4096, 2048, 3000, 1500), "full": (1024, 4096, 2048, 4096, 2048)}


def _model(cols, tags, names, t0, t1, dmin, n_slots, n_kv, n_name, launches):
    """tt_live_filter as the wrapper drives it: a launch a chunk of 32
    codes, each zeroing its hit words, or'ing bits from the real rows of
    the kinds it has codes for, then the slot pass."""
    q, n_tags = list(tags) + list(names), len(tags)
    slot_b = cols["alive"].shape[0]
    pads = (cols["kv_owner"].shape[0] > n_kv, cols["name_owner"].shape[0] > n_name)
    mask = None
    for lo in range(0, max(len(q), 1), CHUNK):
        chunk = q[lo:lo + CHUNK]
        nt, n = min(max(n_tags - lo, 0), len(chunk)), len(chunk)
        hit = np.zeros(slot_b, np.uint32)
        for kind, n_real, j0, j1 in (("kv", n_kv, 0, nt), ("name", n_name, nt, n)):
            if j1 <= j0:
                continue  # a kind without a code of the chunk: no rows read
            code, owner = cols[f"{kind}_code"][:n_real], cols[f"{kind}_owner"][:n_real]
            bits = np.zeros(n_real, np.uint32)
            for j in range(j0, j1):
                bits |= (code == chunk[j]).astype(np.uint32) << np.uint32(j)
            on = bits != 0
            np.bitwise_or.at(hit, np.clip(owner[on], 0, slot_b - 1), bits[on])
        if lo == 0:
            m = (cols["alive"] > 0) & (np.arange(slot_b) < n_slots)
            if t0 is not None:
                m &= cols["end_s"] >= t0
            if t1 is not None:
                m &= cols["start_s"] <= t1
            if dmin is not None:
                m &= cols["dur_ms"] >= dmin
        else:
            m = mask
        if n:
            for j, c in enumerate(chunk):  # the padding rows: owner 0, code PAD_I32
                if c == PAD_I32 and pads[0 if j < nt else 1]:
                    hit[0] |= np.uint32(1) << np.uint32(j)
            full = 0xFFFFFFFF if n == CHUNK else (1 << n) - 1
            m = m & (hit == full)
        mask = m
        launches.append(lo)
    return mask


def _reference(cols, tags, names, t0, t1, dmin, n_slots):
    slot_b, kv_b, name_b = (cols["alive"].shape[0], cols["kv_owner"].shape[0],
                            cols["name_owner"].shape[0])
    fn = R._compiled_live_filter(len(tags), len(names), t0 is not None, t1 is not None,
                                 dmin is not None, slot_b, kv_b, name_b)
    out = fn(cols["start_s"], cols["end_s"], cols["dur_ms"], cols["alive"], cols["kv_owner"],
             cols["kv_code"], cols["name_owner"], cols["name_code"],
             np.asarray(tags or [0], np.int32), np.asarray(names or [0], np.int32),
             *(np.int32(0 if v is None else v) for v in (t0, t1, dmin)), np.int32(n_slots))
    return np.asarray(out)


def _plain(cols, tags, names, t0, t1, dmin, n_slots, n_kv, n_name):
    tc = {k: torch.from_numpy(v) for k, v in cols.items()}
    out = L.live_filter((tc["start_s"], tc["end_s"], tc["dur_ms"], tc["alive"]),
                        (tc["kv_owner"], tc["kv_code"]), (tc["name_owner"], tc["name_code"]),
                        list(tags) + list(names), len(tags), t0, t1, dmin, n_slots, n_kv, n_name)
    assert out.dtype == torch.bool
    return out.numpy()


def test_chunk_matches_the_kernel():
    src = open(os.path.join(kernels.CSRC, "livestage.cu")).read()
    assert int(re.search(r"#define LIVE_CHUNK (\d+)", src).group(1)) == CHUNK == kernels.LIVE_CHUNK


@pytest.mark.parametrize("case", sorted(LIVE_CASES))
def test_one_launch_model_matches_reference(case):
    tags, names, t0, t1, dmin = LIVE_CASES[case]
    hits = 0
    for shape, (slot_b, kv_b, name_b, n_kv, n_name) in SHAPES.items():
        cols = live_case(len(case), slot_b, kv_b, name_b, n_kv, n_name)
        for n_slots in (0, 5, slot_b, slot_b + 7):
            launches = []
            got = _model(cols, tags, names, t0, t1, dmin, n_slots, n_kv, n_name, launches)
            want = _reference(cols, tags, names, t0, t1, dmin, n_slots)
            np.testing.assert_array_equal(got, want, err_msg=f"{shape} n_slots={n_slots}")
            np.testing.assert_array_equal(
                _plain(cols, tags, names, t0, t1, dmin, n_slots, n_kv, n_name), want)
            assert len(launches) == max(1, -(-(len(tags) + len(names)) // CHUNK))
            hits += int(got.sum())
    if case != "int32_extremes":
        assert hits > 0  # not vacuous


def test_pad_code_sets_slot_zero_only_over_padding():
    """A PAD_I32 query code matches the padding rows (owner 0) that the
    reference reads: slot 0 passes where the kind's bucket has padding,
    and not where the bucket is full of real rows."""
    for shape, want0 in (("padded", True), ("full", False)):
        slot_b, kv_b, name_b, n_kv, n_name = SHAPES[shape]
        cols = live_case(9, slot_b, kv_b, name_b, n_kv, n_name)
        for tags, names in (([PAD_I32], []), ([], [PAD_I32])):
            got = _model(cols, tags, names, None, None, None, slot_b, n_kv, n_name, [])
            np.testing.assert_array_equal(
                got, _reference(cols, tags, names, None, None, None, slot_b))
            assert bool(got[0]) == want0 and not got[1:].any()


def test_live_filter_takes_ints_and_refuses_a_device_tensor():
    cols = live_case(11)
    tc = {k: torch.from_numpy(v) for k, v in cols.items()}
    args = ((tc["start_s"], tc["end_s"], tc["dur_ms"], tc["alive"]),
            (tc["kv_owner"], tc["kv_code"]), (tc["name_owner"], tc["name_code"]))
    a = L.live_filter(*args, [3, 7], 1, None, None, None, 700)
    b = L.live_filter(*args, torch.tensor([3, 7], dtype=torch.int32), 1, None, None, None, 700)
    assert torch.equal(a, b) and bool(a[42])
    with pytest.raises(ValueError):
        L.live_filter(*args, torch.zeros(2, dtype=torch.int32, device="meta"), 1, None, None,
                      None, 700)
