"""Seeded inputs shared by the CPU tests of M5's tiled count and B7a's
one-launch filter (test_torch_attr_tiles.py, test_torch_live_filter_one.py,
which hold numpy models of the kernels against the JAX package) and by
their card tests (test_torch_cuda_mesh_search.py, test_torch_cuda_ingest.py,
which import no JAX); likewise for the later kernels' models below. Plain
numpy; not a test module."""

import numpy as np
import test_torch_cases as TC

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


# M7 and M8 (the sharded search's tail, csrc/meshsearch.cu): conditions
# (target, column, op, is_float): span leaves 0-2 (each tracify'd leaf a
# mask slot; the cases set the slot bytes themselves), trace leaves 3-4
# and twenty more trace leaves 5-24 for a program with many conditions
SEARCH_SPECS = ([("span", "span.dur_us", "gt", False), ("span", "span.dur_us", "lt", False),
                 ("span", "span.kind", "eq", False), ("trace", "trace.dur_ms", "ge", False),
                 ("trace", "trace.root_name_id", "intable", False)]
                + [("trace", "trace.dur_ms", "ge", False)] * 20)


def _any(op, leaves):
    out = leaves[0]
    for x in leaves[1:]:
        out = (op, out, x)
    return out


SEARCH_TREES = {
    "n_tr0": ("or", ("cond", 3), ("cond", 4)),  # no tracify slot: the union is the valid rows
    "n_tr1": ("or", ("and", ("tracify", ("cond", 0)), ("cond", 3)), ("cond", 4)),
    "n_tr3": ("or", ("and", ("tracify", ("cond", 0)), ("tracify", ("cond", 1))),
              ("and", ("tracify", ("cond", 2)), ("cond", 3))),
    # 81 operations: past the 64 carried by value
    "long_program": ("and", ("tracify", ("cond", 0)),
                     _any("or", [("cond", 3 + (j % 2)) for j in range(40)])),
    # 20 trace conditions in 40 operations: past the 16 descriptor rows
    "many_conditions": ("and", ("tracify", ("cond", 0)),
                        _any("or", [("cond", 5 + j) for j in range(20)])),
}


def search_case(seed: int, S: int = 8192, nt: int = 1203, big: int = 0, hostile: bool = False,
                empty_tile: bool = False) -> dict:
    """Two blocks of S span rows grouped by trace (0-12 rows a trace, 15 %
    of traces empty; trace 700 with `big` rows; with `empty_tile`, traces
    512-1,023 all empty), n_spans S and S - 300, the last 20 offsets of
    block 0 past S (monotone after clipping). Four mask slots of bytes 0
    and 1, 2, 0x7F, 0x80, 0xFF (30 % not 0). With `hostile`, block 1's
    first tile holds a falling offset and offsets below 0 and past S.
    Returns the numpy "slots" (2, 4, S), "span_off" (2, nt + 1), "n_spans",
    the columns ("span.dur_us", "span.kind", "span.trace_sid", "trace.*"),
    ints (2, C, 3), floats (2, C, 2) and tables {4: (2, 8)} of
    SEARCH_SPECS."""
    rng = np.random.default_rng(seed)
    bl = 2
    off = np.zeros((bl, nt + 1), np.int64)
    for b in range(bl):
        c = rng.integers(0, 13, nt)
        c[rng.random(nt) < 0.15] = 0
        if big:
            c[700] = big
        if empty_tile:
            c[512:1024] = 0
        c[np.cumsum(c) > S - 8] = 0
        off[b, 1:] = np.cumsum(c)
    off[0, -20:] = S + 5 + np.arange(20)
    off = off.astype(np.int32)
    if hostile:
        o = off[1]
        o[100] = o[101] + 37  # falling into 101
        o[200], o[300] = -7, S + 100
    nz = rng.choice(np.asarray([1, 2, 0x7F, 0x80, 0xFF], np.uint8), (bl, 4, S))
    slots = np.where(rng.random((bl, 4, S)) < 0.3, nz, 0).astype(np.uint8)
    sid = np.stack([np.clip(np.searchsorted(np.clip(off[b], 0, S), np.arange(S), "right") - 1,
                            0, nt - 1) for b in range(bl)]).astype(np.int32)
    cols = {"span.dur_us": rng.integers(0, 1000, (bl, S)).astype(np.int32),
            "span.kind": rng.integers(0, 5, (bl, S)).astype(np.int32),
            "span.trace_sid": sid,
            "trace.dur_ms": rng.integers(0, 100, (bl, nt)).astype(np.int32),
            "trace.root_name_id": rng.integers(-1, 6, (bl, nt)).astype(np.int32)}
    n_c = len(SEARCH_SPECS)
    ints = np.zeros((bl, n_c, 3), np.int32)
    ints[:, 0, 1], ints[:, 1, 1], ints[:, 2, 1] = 500, 300, 2
    ints[:, 3, 1] = [60, 85]
    ints[:, 5:, 1] = rng.integers(90, 100, (bl, n_c - 5))
    tables = {4: (rng.random((bl, 8)) < 0.3).astype(np.uint8)}
    return {"slots": slots, "span_off": off, "n_spans": np.asarray([S, S - 300], np.int32),
            "cols": cols, "ints": ints, "floats": np.zeros((bl, n_c, 2), np.float32),
            "tables": tables}


# M4 (the sharded metrics fold over a rank's stacked blocks,
# csrc/timeseries.cu ts_one_kernel<route, true>): one condition of each
# axis the mesh fold takes, (target, column, op, is_float)
STACKED_SPECS = [("span", "span.dur_us", "gt", False), ("res", "res.service_id", "eq", False),
                 ("trace", "trace.dur_ms", "ge", False), ("span", "span.dur_us", "ge", True)]
STACKED_TREE = ("and", ("or", ("cond", 0), ("cond", 1)), ("or", ("cond", 2), ("cond", 3)))
STACKED_G, STACKED_NB, STACKED_STEP = 5, 7, 10_000


def stacked_case(seed: int, bl: int, S: int = 2048, has_val: bool = True,
                 dyadic: bool = True) -> dict:
    """bl stacked blocks of S span rows for M4: span counts cycling
    through S - 100, S, 0, 300 (blocks with none and full ones); start
    times before, inside and past the 7 buckets of 10 s, and in every
    third block near the int32 ends with an origin near the other end,
    so that start - t0 wraps as XLA's int32 arithmetic does; group ids
    from -3 to G + 2 (negative and past the grid); values dyadic (k / 4)
    or lognormal with NaN, -0.0, +0.0, +inf and -inf on 3 % of the spans,
    present on 80 %, and all four of NaN, +inf, -inf and -0.0 folded into
    cell (0, 0) by rows 0-3 of every block with spans. Returns the numpy "cols" (span, res and trace
    axes), "rows" (one Operands row set a block of STACKED_SPECS),
    "n_spans", "t0", "gid", "val" and "pres" (None for a counts-only
    fold)."""
    rng = np.random.default_rng(seed)
    R, NT = 256, 512
    n_spans = np.asarray([(S - 100, S, 0, 300)[b % 4] for b in range(bl)], np.int32)
    t0 = rng.integers(-20_000, 20_000, bl).astype(np.int32)
    start = rng.integers(-5_000, 75_000, (bl, S)).astype(np.int64)
    for b in range(0, bl, 3):  # the wrap: start near one end, t0 near the other
        t0[b] = -(2**31) + 1_000 if b % 2 else 2**31 - 1_000
        start[b] = start[b] + int(t0[b])
    start = ((start + 2**31) % 2**32 - 2**31).astype(np.int32)
    cols = {
        "span.start_ms": start,
        "span.trace_sid": np.sort(rng.integers(0, 200, (bl, S)), axis=1).astype(np.int32),
        "span.dur_us": rng.integers(0, 40, (bl, S)).astype(np.int32),
        "span.res_idx": rng.integers(-1, 50, (bl, S)).astype(np.int32),
        "res.service_id": rng.integers(-1, 6, (bl, R)).astype(np.int32),
        "trace.dur_ms": rng.integers(0, 100, (bl, NT)).astype(np.int32),
    }
    rows = [[(0, 20 + b % 7, 0, 0.0, 0.0), (0, b % 3, 0, 0.0, 0.0), (0, 60 - 5 * (b % 5), 0, 0.0, 0.0),
             (0, 0, 0, 30.5 - b % 4, 0.0)] for b in range(bl)]
    gid = rng.integers(-3, STACKED_G + 3, (bl, S)).astype(np.int32)
    val = pres = None
    if has_val:
        if dyadic:
            val = rng.integers(-8, 9, (bl, S)).astype(np.float32) * np.float32(0.25)
        else:
            val = rng.lognormal(0, 2, (bl, S)).astype(np.float32)
        hit = rng.random((bl, S)) < 0.03
        val[hit] = np.asarray([np.nan, -0.0, 0.0, np.inf, -np.inf], np.float32)[
            rng.integers(0, 5, hit.sum())]
        pres = rng.random((bl, S)) < 0.8
        # rows 0-3 of every block with spans fold into cell (0, 0): NaN,
        # +inf, -inf and -0.0, so each fold meets all four
        for b in np.nonzero(n_spans >= 4)[0]:
            cols["span.dur_us"][b, :4] = 39  # past leaves 0 and 3
            cols["span.start_ms"][b, :4] = np.int32(t0[b]) + np.int32(5)
            gid[b, :4] = 0
            val[b, :4] = np.asarray([np.nan, np.inf, -np.inf, -0.0], np.float32)
            pres[b, :4] = True
    return {"cols": cols, "rows": rows, "n_spans": n_spans, "t0": t0, "gid": gid, "val": val,
            "pres": pres}


def remap_case(seed: int, lens: tuple, r: int) -> tuple:
    """B9a over consecutive segments: code columns of the given lengths
    (codes from -3 to r + 3: negatives, and codes past the table that
    clamp to its last entry; every seventh r - 1 and every eleventh
    INT32_MIN) end to end, their bounds and a permutation table of r
    entries. Returns (codes, offs, table) as numpy int32 / int64."""
    rng = np.random.default_rng(seed)
    n = int(sum(lens))
    codes = rng.integers(-3, r + 4, n).astype(np.int32)
    codes[::7] = r - 1
    codes[::11] = PAD_I32
    offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return codes, offs, rng.permutation(r).astype(np.int32)


# (lengths, table size): odd lengths, starts off 16-byte boundaries,
# empty segments first, in the middle and last, a one-code column; a
# table at the shared route's limit (49,152 entries) and one past it
REMAP_SEGMENTS = {
    "cut_like": ((1021, 0, 5, 1, 4096, 33, 0, 2047, 3), 5677),
    "one_column": ((5000,), 5677),
    "empty_edges": ((0, 0, 17, 0), 50),
    "smem_limit": ((3, 30_000, 7), 49_152),
    "past_smem": ((30_001, 6), 49_153),
    "seventy_columns": (tuple(range(70)), 300),
}


# K4's shapes (csrc/stage.cu): (Bl or None for one (S,) row, S, n_res, C).
# "phase4": chip_smoke's phase 4 (a table of 1,024, 2^20 spans); "m4":
# M4's stacked fold; "odd": S off a multiple of 4 (spans one at a time);
# "odd_stacked": quads cut by a block's row; "big_table": a table of
# 20,000 entries; "chunked": more columns than a launch carries
# (RES_COLS = 8)
RES_SHAPES = {"phase4": (None, 1 << 20, 1024, 1), "phase4_two": (None, 1 << 20, 1024, 2),
              "m4": (3, 1 << 20, 1024, 1), "small": (None, 4096, 777, 3),
              "odd": (None, 4097, 777, 3), "odd_stacked": (4, 4097, 300, 2),
              "big_table": (None, 65536, 20000, 1), "chunked": (2, 8192, 100, 10)}


def res_case(seed: int, bl, S: int, n_res: int, C: int) -> tuple:
    """C resource tables of n_res codes (PAD_I32 and -1 among them), one a
    block where bl is set ((bl, n_res) each), and res_idx (S,) or (bl, S)
    in [-3, n_res + 50): negative (no resource) and past the table
    (clamped)."""
    rng = np.random.default_rng(seed)
    shape = (n_res,) if bl is None else (bl, n_res)
    tables = [rng.integers(-1, 1 << 20, shape).astype(np.int32) for _ in range(C)]
    for t in tables:
        t.reshape(-1)[:: 97] = PAD_I32
    idx = rng.integers(-3, n_res + 50, (S,) if bl is None else (bl, S)).astype(np.int32)
    return tables, idx


def elect_case(seed: int, bl: int, T: int = 256, q: int = 40, misses_only: bool = False) -> dict:
    """A rank's stack of bl sorted (T, 4) indexes of the global blocks
    base .. base + bl - 1 (n_valid from 0 to T, pad rows past it), queries
    of their rows (one of them held by the first and the last block, so
    the higher must win; block 0's row 0) and misses; or misses only."""
    rng = np.random.default_rng(seed)
    ids = np.full((bl, T, 4), 2**31 - 1, np.int32)
    nv = rng.integers(0, T + 1, bl).astype(np.int32)
    nv[0] = T
    for b in range(bl):
        a = np.unique(rng.integers(-(2**31), 2**31 - 1, (int(nv[b]), 4), dtype=np.int64)
                      .astype(np.int32), axis=0)
        nv[b] = a.shape[0]
        ids[b, : nv[b]] = a
    if bl > 1 and nv[-1] > 0:  # the last block's first row also in block 0
        one = np.concatenate([ids[0, : nv[0] - 1], ids[-1, :1]])
        ids[0, : nv[0]] = one[np.lexsort(one.T[::-1])]
    misses = rng.integers(-(2**31), 2**31 - 1, (q // 4, 4), dtype=np.int64).astype(np.int32)
    if misses_only:
        queries = misses
    else:
        full = [b for b in range(bl) if nv[b] > 0]
        blocks = rng.choice(full, q - q // 4 - 2)
        rows = [rng.integers(0, nv[b]) for b in blocks]
        queries = np.concatenate([ids[0, :1], ids[-1, :1], ids[blocks, rows], misses])
    return {"ids": ids, "n_valid": nv, "queries": queries.astype(np.int32),
            "base": int(seed % 5) * bl}


# ------------------------------------------- M2 and M3 (the mesh-batched search)

# row slices over the 2,048 padded span rows of TC.mq_cols, by slice
# count; the last slices lie past n_spans (1,500)
MQ_BOUNDS = {1: [0, 2048], 2: [0, 777, 2048], 3: [0, 517, 1203, 2048],
             4: [0, 333, 1001, 1499, 2048]}
MQ_CASES = ("regular", "hostile1", "hostile2", "ng8", "odd_p", "no_span_cols")


def mq_split_case(case: str, seed: int) -> tuple:
    """(program arrays, columns, q) of one M2 / M3 case over TC.mq_cols:
    "regular" 16 well-formed programs (4 chunks of 4 at P = 8); "hostile1"
    and "hostile2" 8 programs, programs 5 and 7 with TC.hostile_program's
    offsets (chunk 0 runs the word operations, chunk 1 the rows), over
    TC.hostile_cols with no offset below zero (the single-device run wraps
    one where the mesh clips it); "ng8" 5 programs of 8 groups (2 a
    chunk); "odd_p" 12 programs of 3 conditions (10 a chunk); "no_span_cols"
    8 programs that name no span column. Every fifth program has no group."""
    rng = np.random.default_rng(seed)
    dims = {"ng8": dict(TC.MQ_DIMS, n_conds_b=16, n_clauses_b=8, n_groups_b=8),
            "odd_p": dict(TC.MQ_DIMS, n_conds_b=3, n_clauses_b=1, n_groups_b=1)}.get(case)
    q = {"regular": 16, "ng8": 5, "odd_p": 12}.get(case, 8)
    arrays = [TC.random_program(rng, n_groups=0 if i % 5 == 4 else None, dims=dims)
              for i in range(q)]
    cols = TC.mq_cols(seed % 1000)
    if case.startswith("hostile"):
        kind = int(case[-1])
        arrays = [TC.hostile_program(p, rng, kind) if i in (5, 7) else p
                  for i, p in enumerate(arrays)]
        cols = TC.hostile_cols(kind)
        cols["trace.span_off"] = np.maximum(cols["trace.span_off"], 0)
    if case == "no_span_cols":
        for p in arrays:
            p["span_cols"] = ()
    return arrays, cols, q


def mq_cut_traces(span_off: np.ndarray, bounds: list) -> int:
    """The slice bounds that fall strictly inside a trace's span range."""
    lo, hi = span_off[:-1], span_off[1:]
    return sum(bool(((lo < b) & (b < hi)).any()) for b in bounds[1:-1])
