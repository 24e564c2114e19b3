"""M6, the sharded search's bit-packed lhs mask, as the port runs it: the
pack kernel's arithmetic (csrc/meshsearch.cu mask_pack_kernel: 8 mask
bytes a load folded by a multiply into a packed byte) as a numpy model
against np.packbits on every row alignment it takes, the packed read of K1's
shard struct pass (csrc/filter.cu lhs_at<true>) as a numpy model against
np.unpackbits, and search_local's struct nodes against the reference's
sharded search (tempo_tpu/parallel/search.py) on every sp cut of 1, 2 and
4: packed at sp > 1 (the pack, the all_gather, the packed struct step),
and at sp = 1 the shard's own slot and parent rows with no pack, no
unpack and no collective. The sp ranks run as threads of this process
over a barrier. Every output is a bool or an int: exact."""

import threading

import numpy as np
import pytest
import torch
from test_torch_mesh_search import CASES, _operands

from tempo_tpu.ops import filter as RF
from tempo_tpu.parallel import make_mesh as r_make_mesh
from tempo_tpu.parallel.search import sharded_search as r_sharded_search
from tempo_tpu_torch import kernels
from tempo_tpu_torch.ops import filter as F
from tempo_tpu_torch.ops import meshsearch as MS
from tempo_tpu_torch.parallel import make_mesh, sharded_search
from tempo_tpu_torch.parallel import search as PS

M7F = np.uint64(0x7F7F7F7F7F7F7F7F)
ONES = np.uint64(0x0101010101010101)
GATHER = np.uint64(0x8040201008040201)


def _pack8(x: np.ndarray) -> np.ndarray:
    """The kernel's pack8 on uint64 words (byte k the row 8j + k): bit 7
    of each nonzero byte, shifted to bit 0, gathered by the multiply."""
    x = (((x & M7F) + M7F) | x) >> np.uint64(7)
    x &= ONES
    return ((x * GATHER) >> np.uint64(56)).astype(np.uint8)


def _pack_model(mem: np.ndarray, ptr: int, stride: int, bl: int, sl: int) -> np.ndarray:
    """mask_pack_kernel over bl rows of sl bytes at mem[ptr + b * stride]
    (mem's address 0 stands for an aligned base): a packed byte from each
    8-byte load, which the wrapper takes only 8-byte aligned."""
    assert ptr % 8 == 0 and stride % 8 == 0 and sl % 8 == 0
    out = np.zeros((bl, sl // 8), np.uint8)
    for b in range(bl):
        row = mem[ptr + b * stride:ptr + b * stride + sl]
        out[b] = _pack8(np.frombuffer(row.tobytes(), "<u8"))  # an 8-byte load a byte
    return out


def _mask_bytes(rng, shape) -> np.ndarray:
    """Mask bytes as a slot may hold them: zeros and any nonzero byte."""
    return np.where(rng.random(shape) < 0.5, 0, rng.integers(1, 256, shape)).astype(np.uint8)


@pytest.mark.parametrize("layout", ["contiguous", "slot_view"])
@pytest.mark.parametrize("sl", [8, 16, 64, 1024])
def test_pack_model_matches_packbits(sl, layout):
    """The pack against np.packbits(m != 0) and the plain version, on a
    (Bl, Sl) array and on slot 2 of (Bl, 4, Sl) slots."""
    rng = np.random.default_rng(sl)
    bl, n_slots = 3, 4
    slots = _mask_bytes(rng, (bl, n_slots, sl))
    if layout == "contiguous":
        m, ptr, stride = slots[:, 0], 0, sl
        mem = np.ascontiguousarray(m).reshape(-1)
    else:
        m, ptr, stride = slots[:, 2], 2 * sl, n_slots * sl
        mem = slots.reshape(-1)
    want = np.packbits(m != 0, axis=1)
    np.testing.assert_array_equal(_pack_model(mem, ptr, stride, bl, sl), want)
    np.testing.assert_array_equal(MS._mask_pack_plain(torch.from_numpy(slots)[:, 2 if
                                  layout == "slot_view" else 0]).numpy(), want)


def test_pack_fold_every_byte_value():
    """pack8 folds each of the 256 byte values at each of the 8 positions,
    the other bytes random, as np.packbits(bytes != 0) does."""
    rng = np.random.default_rng(256)
    rows = _mask_bytes(rng, (256 * 8, 8))
    v, k = np.divmod(np.arange(256 * 8), 8)
    rows[np.arange(256 * 8), k] = v
    words = np.frombuffer(rows.tobytes(), "<u8")
    np.testing.assert_array_equal(_pack8(words), np.packbits(rows != 0, axis=1)[:, 0])


@pytest.mark.parametrize("sl,stride,ptr", [
    (1024, 4096, 2048),  # a mask slot's view of (Bl, 4, 1024) slots
    (512, 2048, 1536),  # the second sp = 2 shard's slot 3 of (Bl, 4, 512)
    (8, 32, 8),  # rows of 8: one packed byte a row
    (24, 24, 0),  # Sl an odd multiple of 8
    (1024, 1032, 0),  # a stride of 8 past a multiple of 16
    (1024, 4096, 8),  # a base of 8 past a multiple of 16
])
def test_pack_model_on_8_byte_aligned_rows(sl, stride, ptr):
    """The one route on every row the wrapper takes (base and stride
    multiples of 8, Sl % 8 == 0), 16-byte aligned or not, against
    np.packbits over mask bytes that are not only 0 and 1."""
    rng = np.random.default_rng(sl + stride + ptr)
    bl = 3
    mem = _mask_bytes(rng, (ptr + bl * stride,))
    rows = np.stack([mem[ptr + b * stride:ptr + b * stride + sl] for b in range(bl)])
    np.testing.assert_array_equal(_pack_model(mem, ptr, stride, bl, sl),
                                  np.packbits(rows != 0, axis=1))


def test_packed_read_matches_unpackbits():
    """lhs_at<true>(pk, clamp(p, 0, nb - 1)), as the struct kernels read
    the packed row, against np.unpackbits at p = 0, nb - 1, past the end
    (clamped), -1 (a root) and -2 (an orphan), and at every row."""
    rng = np.random.default_rng(5)
    nb = 64
    pk = rng.integers(0, 256, nb // 8).astype(np.uint8)
    bits = np.unpackbits(pk)

    def lhs_at(p):
        c = min(max(p, 0), nb - 1)
        return (int(pk[c >> 3]) >> (7 - (c & 7))) & 1

    for p in (0, nb - 1, nb + 5, -1, -2):
        assert lhs_at(p) == bits[min(max(p, 0), nb - 1)], p
    assert [lhs_at(p) for p in range(nb)] == bits.tolist()
    assert 0 < bits.sum() < nb


class _ThreadMesh:
    """Rank k of a 1 x sp mesh whose ranks are threads of this process:
    the collectives search_local calls, over a shared barrier."""

    def __init__(self, k: int, sp: int, board: list, barrier: threading.Barrier):
        self.coords, self.sp = (0, k), sp
        self.k, self.board, self.barrier = k, board, barrier
        self.gathers = 0

    def _exchange(self, t):
        self.board[self.k] = t
        self.barrier.wait()
        parts = list(self.board)
        self.barrier.wait()
        return parts

    def all_gather(self, t, axis, dim):
        self.gathers += 1
        return torch.cat(self._exchange(t), dim=dim)

    def all_reduce(self, t, op, axis):
        assert op == "sum"
        return sum(self._exchange(t))

    def reduce_scatter(self, t, op, axis, dim):
        w = t.shape[dim] // self.sp
        return self.all_reduce(t, op, axis).narrow(dim, self.k * w, w)


def _threaded_search(sp, tree, conds, operands, cols, n_spans, nt):
    """sharded_search's body on a 1 x sp mesh of threads: each rank's
    search_local on its row slice; rank 0's (trace_mask, span_count)."""
    names = tuple(sorted(cols))
    tree = F.normalize_tree(tree, conds)
    B = cols["span.trace_sid"].shape[0]
    ints, floats, tabs = PS._stack_operands(operands, B, len(conds))
    ints, floats = PS._min_rows(ints, floats)
    dp, dpsp = PS.search_operands(names, cols, ints, floats, tabs)
    static = PS.search_static(tree, conds, names, n_spans, nt, tuple(sorted(tabs)),
                              PS.struct_pack_enabled())
    board, barrier = [None] * sp, threading.Barrier(sp, timeout=60)
    meshes = [_ThreadMesh(k, sp, board, barrier) for k in range(sp)]
    out, errors = [None] * sp, []

    def rank(k):
        ops = {n: torch.from_numpy(a) for n, a in dp.items()}
        for n, a in dpsp.items():
            w = a.shape[1] // sp
            ops[n] = torch.from_numpy(np.ascontiguousarray(a[:, k * w:(k + 1) * w]))
        try:
            out[k] = PS.search_local(meshes[k], static, ops)
        except BaseException as e:  # surfaced below, with the barrier broken
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank, args=(k,)) for k in range(sp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return [x.numpy() for x in out[0]], meshes


def _reference(sp, tree, specs, rows, cols, n_spans, nt):
    rconds = tuple(RF.Cond(t, c, op, is_float=f) for t, c, op, f in specs)
    tm, sc = r_sharded_search(r_make_mesh(n_devices=sp, dp=1, sp=sp), tree, rconds,
                              _operands(RF, rows, None), cols, n_spans, nt=nt)
    return np.asarray(tm), np.asarray(sc)


def _struct_spy(monkeypatch) -> list:
    """Record each struct step's lhs mask, its packing and its pidx."""
    seen = []
    step0 = MS.ShardSearch.struct_step

    def spy(self, step, lm_g, pidx, packed=False):
        seen.append((self, step, lm_g, pidx, packed))
        return step0(self, step, lm_g, pidx, packed)

    monkeypatch.setattr(MS.ShardSearch, "struct_step", spy)
    return seen


@pytest.mark.parametrize("op", [">", ">>", "~"])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_packed_struct_step_matches_reference(monkeypatch, sp, op):
    """A struct node through search_local on every rank of 1 x sp: at sp
    > 1 the packed lhs mask (S / 8 bytes a block) read by the struct
    step, at sp = 1 the slot itself; the answers equal the reference's
    shard_map program on a mesh of the same shape."""
    monkeypatch.setenv("TEMPO_STRUCT_PACK", "1")
    _, specs, rows, _, cols, n_spans, nt = CASES["struct_pack"](np.random.default_rng(7))
    tree = ("struct", op, ("cond", 0), ("cond", 1))
    conds = tuple(F.Cond(t, c, o, is_float=f) for t, c, o, f in specs)
    seen = _struct_spy(monkeypatch)
    (tm, sc), meshes = _threaded_search(sp, tree, conds, _operands(F, rows, None), cols, n_spans,
                                        nt)
    want = _reference(sp, tree, specs, rows, cols, n_spans, nt)
    np.testing.assert_array_equal(tm, want[0])
    np.testing.assert_array_equal(sc, want[1])
    assert tm.any() and not tm.all()
    S = cols["span.trace_sid"].shape[1]
    assert len(seen) == sp
    for sh, step, lm_g, pidx, packed in seen:
        assert packed == (sp > 1)
        assert lm_g.shape == (2, S // 8 if sp > 1 else S)
        assert lm_g.dtype == torch.uint8
        assert pidx.shape[1] == (sh.sl if op == ">" else S)
    # the lhs mask a gather a node; '>>' and '~' the parent table once more
    assert all(m.gathers == (0 if sp == 1 else 1 + (op != ">")) for m in meshes)


@pytest.mark.parametrize("op", [">", ">>", "~"])
def test_sp1_route_skips_pack_and_unpack(monkeypatch, op):
    """sharded_search on a one-rank mesh: the struct step reads the
    shard's own slot (the view itself, no copy) and parent rows; M6's
    pack and unpack, patched to raise, are never called."""
    monkeypatch.setenv("TEMPO_STRUCT_PACK", "1")

    def refuse(*a, **k):
        raise AssertionError("M6 called on an sp axis of one rank")

    monkeypatch.setattr(PS, "mask_pack", refuse)
    monkeypatch.setattr(MS, "mask_pack", refuse)
    monkeypatch.setattr(MS, "_mask_unpack_plain", refuse)
    _, specs, rows, _, cols, n_spans, nt = CASES["struct_pack"](np.random.default_rng(7))
    tree = ("struct", op, ("cond", 0), ("cond", 1))
    conds = tuple(F.Cond(t, c, o, is_float=f) for t, c, o, f in specs)
    seen = _struct_spy(monkeypatch)
    tm, sc = sharded_search(make_mesh(device="cpu"), tree, conds, _operands(F, rows, None), cols,
                            n_spans, nt=nt)
    want = _reference(1, tree, specs, rows, cols, n_spans, nt)
    np.testing.assert_array_equal(tm, want[0])
    np.testing.assert_array_equal(sc, want[1])
    [(sh, step, lm_g, pidx, packed)] = seen
    slot = sh.slot(step[2])
    assert not packed
    assert lm_g.data_ptr() == slot.data_ptr() and lm_g.stride() == slot.stride()
    assert pidx is sh.cols["span.parent_idx"]
