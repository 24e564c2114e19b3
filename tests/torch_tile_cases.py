"""Seeded inputs shared by the CPU tests of M5's tiled count and B7a's
one-launch filter (test_torch_attr_tiles.py, test_torch_live_filter_one.py,
which hold numpy models of the kernels against the JAX package) and by
their card tests (test_torch_cuda_mesh_search.py, test_torch_cuda_ingest.py,
which import no JAX). Plain numpy; not a test module."""

import numpy as np

PAD_I32 = -(2**31)
TILE, CHUNK = 2048, 8192  # M5's owners a CTA and rows a chunk (csrc/meshsearch.cu)

# M5's leaves: (target, value column, op, is_float), their per-block
# operand rows (key, v0, v1, f0, f1) and one table (leaf 4's)
ATTR_SPECS = [("sattr", "any", "exists", False), ("sattr", "str", "eq", False),
              ("sattr", "int", "ge", False), ("sattr", "float", "gt", True),
              ("sattr", "str", "intable", False)]
ATTR_ROWS = [[(1, 0, 0, 0.0, 0.0), (2, 3, 0, 0.0, 0.0), (1, 40, 0, 0.0, 0.0),
              (0, 0, 0, 0.5, 0.0), (2, 0, 0, 0.0, 0.0)],
             [(3, 0, 0, 0.0, 0.0), (0, 1, 0, 0.0, 0.0), (2, 75, 0, 0.0, 0.0),
              (3, 0, 0, 0.25, 0.0), (1, 0, 0, 0.0, 0.0)]]
ATTR_TABLES = [np.asarray([0, 1, 0, 1, 1, 0, 0, 0], np.uint8),
               np.asarray([1, 0, 0, 0, 0, 1, 0, 0], np.uint8)]


def attr_case(seed: int, n_own: int = 2600, A: int = 16384, big: int = 9000,
              hostile: bool = False) -> dict:
    """Two blocks of span attr rows grouped by owner (0-4 rows an owner,
    owners with none, owner 1,500 with `big` rows: more than a chunk),
    keys 0-3, vtypes 0-3 (str, int, float, bool), PAD_I32 keys past the
    real rows. With `hostile`, block 1's first tile (owners 0-2,047) holds
    a falling offset and offsets below 0 and past A, and its second tile
    one past A only. Returns the numpy columns ("sattr.*", "span.
    trace_sid" of n_own rows), ints (2, C, 3), floats (2, C, 2) and
    tables {4: (2, 8)}."""
    rng = np.random.default_rng(seed)
    bl = 2
    off = np.zeros((bl, n_own + 1), np.int64)
    for b in range(bl):
        c = rng.integers(0, 5, n_own)
        c[rng.random(n_own) < 0.2] = 0
        c[1500] = big
        c[np.cumsum(c) > A - 64] = 0
        off[b, 1:] = np.cumsum(c)
    off = off.astype(np.int32)
    if hostile:
        o = off[1]
        o[1100] = o[1101] + 37  # falling into 1,101
        o[1200], o[1300], o[2100] = -7, A + 100, A + 5
    cols = {"sattr.off": off,
            "sattr.key_id": rng.integers(0, 4, (bl, A)).astype(np.int32),
            "sattr.vtype": rng.integers(0, 4, (bl, A)).astype(np.int32),
            "sattr.str_id": rng.integers(0, 8, (bl, A)).astype(np.int32),
            "sattr.int32": rng.integers(0, 100, (bl, A)).astype(np.int32),
            "sattr.f32": rng.random((bl, A)).astype(np.float32),
            "span.trace_sid": np.zeros((bl, n_own), np.int32)}
    for b in range(bl):
        cols["sattr.key_id"][b, int(off[b, -1]):] = PAD_I32
    ints = np.asarray([[r[:3] for r in rows] for rows in ATTR_ROWS], np.int32)
    floats = np.asarray([[r[3:] for r in rows] for rows in ATTR_ROWS], np.float32)
    return {"cols": cols, "ints": ints, "floats": floats,
            "tables": {4: np.stack(ATTR_TABLES)}}


def attr_hits(case: dict, i: int) -> np.ndarray:
    """(2, A) bool: the rows leaf i matches in each block, in numpy."""
    cols, ints, floats = case["cols"], case["ints"], case["floats"]
    _, col, op, _ = ATTR_SPECS[i]
    hit = cols["sattr.key_id"] == ints[:, i, 0:1]
    if col == "any":
        return hit
    vt = {"str": 0, "int": 1, "float": 2}[col]
    x = cols[{"str": "sattr.str_id", "int": "sattr.int32", "float": "sattr.f32"}[col]]
    if op == "eq":
        v = x == ints[:, i, 1:2]
    elif op == "ge":
        v = x >= ints[:, i, 1:2]
    elif op == "gt":
        v = x > floats[:, i, 0:1]
    else:  # intable
        t = case["tables"][i]
        v = np.take_along_axis(t, np.clip(x, 0, t.shape[1] - 1), 1).astype(bool) & (x >= 0)
    return hit & (cols["sattr.vtype"] == vt) & v


def attr_shard(case: dict, sp: int, k: int) -> dict:
    """Shard k of sp: the attr and span columns cut along their rows, the
    offsets whole (replicated along sp)."""
    out = {}
    for n, a in case["cols"].items():
        if not n.endswith(".off"):
            w = a.shape[1] // sp
            a = a[:, k * w:(k + 1) * w]
        out[n] = np.ascontiguousarray(a)
    return out


def live_case(seed: int, slot_b: int = 1024, kv_b: int = 4096, name_b: int = 2048,
              n_kv: int = 3000, n_name: int = 1500, n_codes: int = 40) -> dict:
    """The live head's columns: real rows [0, n_kv) / [0, n_name) with
    owners from -3 to slot_b + 2 (clamped by the filter), slots 0 and 42
    holding every code 0..n_codes - 1, the rest of each bucket the
    stager's padding (owner 0, code PAD_I32); slots 0 and 42 pass every
    prefilter."""
    rng = np.random.default_rng(seed)
    cols = {"start_s": rng.integers(0, 1000, slot_b).astype(np.int32),
            "end_s": rng.integers(0, 1000, slot_b).astype(np.int32),
            "dur_ms": rng.integers(0, 5000, slot_b).astype(np.int32),
            "alive": (rng.random(slot_b) < 0.8).astype(np.int32)}
    for kind, nb, n in (("kv", kv_b, n_kv), ("name", name_b, n_name)):
        owner = np.zeros(nb, np.int32)
        code = np.full(nb, PAD_I32, np.int32)
        owner[:n] = rng.integers(-3, slot_b + 3, n)
        code[:n] = rng.integers(0, n_codes, n)
        if n >= 2 * n_codes:
            owner[n - 2 * n_codes:n] = np.repeat([0, 42], n_codes)
            code[n - 2 * n_codes:n] = np.tile(np.arange(n_codes), 2)
        cols[f"{kind}_owner"], cols[f"{kind}_code"] = owner, code
    for name, v in (("alive", 1), ("start_s", 10), ("end_s", 500), ("dur_ms", 3000)):
        cols[name][[0, 42]] = v
    return cols


# (tags, names, t0, t1, dmin): thresholds None where off
LIVE_CASES = {
    "0_codes": ([], [], None, None, None),
    "1_code": ([3], [], None, None, None),
    "pad_tag": ([PAD_I32], [], None, None, None),
    "pad_name_and_tag": ([5], [PAD_I32], 100, 900, 50),
    "duplicates": ([4, 4, 7], [4, 4], None, None, None),
    "32_codes": (list(range(20)), list(range(12)), None, None, None),
    "33_codes": (list(range(20)), list(range(13)), None, None, None),
    "70_codes": (list(range(34)) + [PAD_I32], list(range(35)), 1, 999, 1),
    "int32_extremes": ([1], [2], 2**31 - 1, -(2**31) + 1, 2**31 - 1),
    "low_extremes": ([1], [], -(2**31) + 1, 2**31 - 1, -(2**31) + 1),
}
