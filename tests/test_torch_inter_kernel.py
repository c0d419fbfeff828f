"""The inter kernel's two forms against the plain inter program and the
JAX engine's, exactly.

csrc/inter.cu compiled for the host with g++: the new form's host entry
rav1d_inter_batches_host (the decoder path's kernel) walks the launch's
phases (zero, puts/warps/preps, combines, seguv, top blends, left blends,
residual add) with the kernel's own step functions, each warp's batches of
consecutive tiles (the batch's descriptors loaded lane by lane, then each
tile's steps for every lane in turn, the next tile's window held in the
lanes' registers between its issue and its commit), each barrier a loop
boundary, or a phase's batches from the last to the first (`reverse`);
the earlier form's rav1d_inter_frame_host walks the warps of a grid of
blocks in turn and each warp's tiles lane by lane, or a phase's tiles
backwards. Both run on the arguments ops/cuda/inter.py builds for the
launch (`inter_args`). The pools they are given hold a pattern, and so do
the warp's shared words before each writer, so a cell the kernel reads
without having zeroed or written it shows. The kernels themselves build
and run only on the card, where chip_smoke.py holds them to inter_plain.
Checked, for both forms where a test names a form:

- engine/programs.py inter_kernels through the host entry against
  inter_plain on every inter frame of the 256x192 sequences of
  tests/test_torch_inter.py (seeds 1 and 2) and of the formats of
  tests/test_torch_formats_programs.py (10-bit 4:2:2 with segy10, 8-bit
  4:4:4 with segy00, the 10-bit 4:2:2 header-tools sequence), and of a
  12-bit 4:0:0 and a 12-bit 4:2:0 sequence, forwards over 3 blocks and
  backwards over 1; seed 1's frame 1 through the new form also against
  mega.inter_prog (its blob is the port's, word-identical to run2's);
- hand-built blobs at 8, 10 and 12 bits with every slot: the five put and
  four prep cases, bilinear with mx and my each 0 or not, windows clamped
  at all four edges of the visible picture and stack rows outside the
  stack, warp filter indices clamped at both ends of the table, partial
  tiles of odd widths and heights, a pool row at capacity and one past
  it, pool rows no tile wrote, every combine with the chroma-subsampled
  DIFFWTD masks and both signs, wedge and blend masks read past the blob,
  top and left blends overlapping on a corner, host pool tiles with
  padding lanes, stores partly outside the planes, multi-chunk runs; at
  12 bits reference planes over the whole int16 range, where the int16
  wraps of the intermediates change the result;
- windows flush with each edge of the visible picture (the new form's
  word loads) and across it (its clamped gather), at 1- and 2-byte
  references whose planes and rows start off a 4-byte boundary; runs of
  33, 31, 1, 40 and 5 tiles whose batches straddle the runs' boundaries;
  a frame whose 3 x 65 cells leave a residual tail of 3 after the groups
  of 4;
- that the slots the kernel runs in one phase write disjoint pixels and
  pool cells on every packed frame above;
- the wrapper's rules: a CPU tensor raises and counts no launch, a run
  outside the blob raises, and programs.inter on CPU tensors is
  inter_plain (on stacked or listed reference planes).

Inputs are seeded with numpy. Tolerance: exact.
"""

import ctypes
import functools
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.engine import mega as JM
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.layout import (
    B_FLAT0, B_TH, B_TW, C_FLAT0, C_P0, C_P1, C_TH, C_TW, D_FLAT0, D_TH,
    D_TW, HB, HDR_LEN, IH0, INTER0, NBLEND, NCOMB, NPUT, NWARP, SLOTS, TB,
    W_FLAT0, W_TH, W_TW,
)
from rav1d_tpu_torch.engine.pack import InterRun, pack_frame
from rav1d_tpu_torch.engine.run import stack_planes
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops.cuda import inter as IK

CSRC = os.path.join(os.path.dirname(IK.__file__), "..", "..", "csrc")
_VOID = ctypes.c_void_p


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("inter") / "libinter_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", so, os.path.join(CSRC, "inter.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    for entry in HOST_ENTRIES.values():
        getattr(lib, entry).argtypes = [_VOID, ctypes.c_int, ctypes.c_int]
        getattr(lib, entry).restype = ctypes.c_int
    return lib


# the host entries of the two forms: the new one (rav1d_inter_batches, the
# decoder path's) and the earlier one (rav1d_inter_frame)
HOST_ENTRIES = {"new": "rav1d_inter_batches_host",
                "earlier": "rav1d_inter_frame_host"}
FORMS = tuple(HOST_ENTRIES)


class HostInter:
    """ops/cuda/inter.py's launch wrapper with a form's host entry in place
    of the launch: `grid` blocks, or every phase backwards with `reverse`;
    the pools filled with a pattern first. `n` counts the calls."""

    def __init__(self, lib, grid=3, reverse=False, form="new"):
        self.lib, self.grid, self.reverse, self.n = lib, grid, reverse, 0
        self.entry = getattr(lib, HOST_ENTRIES[form])

    def inter_frame(self, planes, ra, dev, hdr, runs, refsY, refsC, pool,
                    lap, mask, **geom):
        for t in (pool, lap, mask):
            t.fill_(0x5A5A5A5A)
        a = IK.inter_args(planes, ra, dev, hdr, runs, refsY, refsC, pool,
                          lap, mask, **geom)
        assert self.entry(ctypes.byref(a), self.grid, int(self.reverse)) == 0
        self.n += 1


WALKS = ((3, False), (1, True))  # (grid, reverse)


def _kernel_matches_plain(lib, planes, ra, dev, hdr, runs, sY, sC, geom,
                          form="new", walks=WALKS):
    want = P.inter_plain(planes.clone(), ra, dev, hdr, runs, sY, sC, **geom)
    for grid, reverse in walks:
        k = HostInter(lib, grid, reverse, form)
        got = P.inter_kernels(planes.clone(), ra, dev, hdr, runs, sY, sC,
                              k=k, **geom)
        assert k.n == 1
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    return want


# ---------------------------- packed frames ------------------------------

W, H = 256, 192  # the geometry of tests/test_torch_inter.py
SEQS = {
    "s1": lambda: synth.inter_sequence(W, H, 1),
    "s2": lambda: synth.inter_sequence(W, H, 2),
    "10bit-422": lambda: synth.inter_sequence(W, H, 1, bpc=10,
                                              layout=PL.I422),
    "8bit-444": lambda: synth.inter_sequence(W, H, 1, layout=PL.I444),
    "10bit-422-lf-tools": lambda: synth.inter_sequence(
        W, H, 1, bpc=10, layout=PL.I422, tools=synth.Tools(
            segmentation=True, delta_q=True, lf_deltas=True)),
    "12bit-400": lambda: synth.inter_sequence(W, H, 1, bpc=12,
                                              layout=PL.I400),
    "12bit-420": lambda: synth.inter_sequence(W, H, 3, bpc=12),
}
FRAMES = [(name, i) for name in SEQS for i in (1, 2)]


@functools.lru_cache(maxsize=None)
def _capture(name):
    return synth.capture_frames(SEQS[name]())


class Frame:
    """An inter frame's blob, its residuals (resid_plain), its reference
    stacks and the inter program's statics."""

    def __init__(self, name, i):
        f, plan = _capture(name)[i]
        assert plan is not None and plan.inter is not None
        self.f, self.pk = f, pack_frame(f, plan)
        ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
        self.dev, _ = Uploader("cpu").upload(self.pk, ah * aw, bpc)
        self.ra, _ = P.resid_plain(self.dev, self.pk.hdr, self.pk.tx_valid,
                                   ah=ah, aw=aw, bpc=bpc)
        sh = 0 if f.cur.layout == PL.I444 else 1
        sv = 1 if f.cur.layout == PL.I420 else 0
        ach, acw = f.cur.u.shape if f.cur.u is not None else (0, 0)
        self.sY = stack_planes(self.pk.srcs[0], "cpu", (ah, aw))
        self.sC = stack_planes(self.pk.srcs[1], "cpu", (ach, acw))
        self.geom = dict(ah=ah, aw=aw, bpc=bpc, vwY=f.cur.w, vhY=f.cur.h,
                         vwC=(f.cur.w + sh) >> sh, vhC=(f.cur.h + sv) >> sv)

    def zeros(self):
        return torch.zeros((3, self.geom["ah"], self.geom["aw"]),
                           dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def frame_of(name, i):
    return Frame(name, i)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,i", FRAMES, ids=lambda v: str(v))
def test_kernel_matches_inter_plain(host_lib, name, i, form):
    fr = frame_of(name, i)
    want = _kernel_matches_plain(host_lib, fr.zeros(), fr.ra, fr.dev,
                                 fr.pk.hdr, fr.pk.inter_runs, fr.sY, fr.sC,
                                 fr.geom, form)
    assert want.any()


def test_kernel_matches_jax_inter_prog(host_lib):
    """Seed 1's frame 1 through the new form against mega.inter_prog, at
    the geometry and stack depths tests/test_torch_inter.py compiles it
    with."""
    fr = frame_of("s1", 1)

    def jstack(srcs, depth):
        rows = [np.asarray((pic.y, pic.u, pic.v)[pl]) for pic, pl in srcs]
        rows += [rows[0]] * (depth - len(rows))
        return jnp.asarray(np.stack(rows[:depth]))

    got = P.inter_kernels(fr.zeros(), fr.ra, fr.dev, fr.pk.hdr,
                          fr.pk.inter_runs, fr.sY, fr.sC,
                          k=HostInter(host_lib), **fr.geom)
    want = JM.inter_prog(jnp.zeros((3, fr.geom["ah"], fr.geom["aw"]),
                                   jnp.int32),
                         jnp.asarray(fr.ra.numpy()),
                         jnp.asarray(fr.dev.numpy()),
                         jstack(fr.pk.srcs[0], 8), jstack(fr.pk.srcs[1], 16),
                         **fr.geom)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------- the phases' disjoint writes -----------------------


def _slot_rows(words, hdr, name, run, rows, B=TB):
    base = int(hdr[INTER0 + 2 * SLOTS[name]]) + run.c0 * rows * B
    d = words[base : base + run.nc * rows * B].reshape(run.nc, rows, B)
    return d.transpose(1, 0, 2).reshape(rows, -1)[:, : run.n].astype(np.int64)


def _cells(flat0, tw, th, stride, r=8, c=8):
    """Every (tile, cell) index flat0 + r * stride + c with r < th, c < tw."""
    rr = np.arange(r)[None, :, None]
    cc = np.arange(c)[None, None, :]
    idx = flat0[:, None, None] + rr * stride[..., None, None] + cc
    ok = (rr < th[:, None, None]) & (cc < tw[:, None, None])
    return idx[np.broadcast_to(ok, idx.shape)]


def phase_writes(words, hdr, runs, ah, aw):
    """{(phase, buffer): [(slot, written indices)]} of the packed frame: the
    planes' pixels, the lap and compound pools' cells and the mask pool's
    cells that each slot run of a phase of csrc/inter.cu writes (indices
    inside the buffer)."""
    psz = ah * aw
    rows = IK.pool_rows(ah, aw)
    size = {"planes": 3 * psz, "lap": rows * 64, "pool": rows * 64,
            "mask": psz}
    out = {}

    def add(phase, buf, name, idx):
        idx = idx[(idx >= 0) & (idx < size[buf])]
        out.setdefault((phase, buf), []).append((name, idx))

    for phase, slots in enumerate(IK.phases(runs)):
        for name, run in slots:
            if name == "hostpool":
                d = _slot_rows(words, hdr, name, run, 65, HB)
                ok = (d[0] >= 0) & (d[0] < rows)
                add(phase, "pool", name,
                    (d[0][ok, None] * 64 + np.arange(64)).ravel())
                continue
            if name in ("warpY", "warpC", "wprepY", "wprepC"):
                d = _slot_rows(words, hdr, name, run, NWARP)
                f0, tw, th = d[W_FLAT0], d[W_TW], d[W_TH]
            elif name == "blend":
                d = _slot_rows(words, hdr, name, run, NBLEND)
                f0, tw, th = d[B_FLAT0], d[B_TW], d[B_TH]
            elif name in IK.ROWS and IK.ROWS[name] == NCOMB:
                d = _slot_rows(words, hdr, name, run, NCOMB)
                f0, tw, th = d[C_FLAT0], d[C_TW], d[C_TH]
            else:
                d = _slot_rows(words, hdr, name, run, NPUT)
                f0, tw, th = d[D_FLAT0], d[D_TW], d[D_TH]
            buf = ("lap" if name.startswith("lap") else
                   "pool" if "prep" in name else "planes")
            stride = np.full(f0.shape, 8 if buf != "planes" else aw)
            add(phase, buf, name, _cells(f0, tw, th, stride))
            if name.startswith("segy"):
                sh, sv = int(name[4]), int(name[5])
                add(phase, "mask", name,
                    _cells(d[C_P0], (tw + sh) >> sh, (th + sv) >> sv, d[C_P1],
                           8 >> sv, 8 >> sh))
    return out


@pytest.mark.parametrize("name,i", FRAMES, ids=lambda v: str(v))
def test_phase_slots_write_disjoint_cells(name, i):
    """Within each phase of the kernel, no two tiles (of one slot run or of
    two runs merged into the phase) write the same pixel or pool cell."""
    fr = frame_of(name, i)
    g = fr.geom
    writes = phase_writes(fr.pk.words(), fr.pk.hdr, fr.pk.inter_runs,
                          g["ah"], g["aw"])
    slots = set()
    for (phase, buf), parts in writes.items():
        idx = np.concatenate([p for _, p in parts])
        assert np.unique(idx).size == idx.size, (phase, buf, [
            n for n, _ in parts])
        slots |= {n for n, p in parts if p.size}
    assert {"putY", "avg", "blend"} <= slots


# --------------------------- hand-built blobs ----------------------------

AH, AW = 64, 96
VIS = {0: (90, 60), 1: (45, 30)}  # (vw, vh) of the luma and chroma refs
REF_SHAPE = {0: (64, 96), 1: (32, 48)}


class Blob:
    """A hand-built frame blob: the header's words, then regions."""

    def __init__(self):
        self.hdr = np.zeros(HDR_LEN, np.int32)
        self.words = [np.zeros(HDR_LEN, np.int32)]
        self.pos = HDR_LEN

    def add(self, words):
        w = np.asarray(words, np.int32).reshape(-1)
        base = self.pos
        self.words.append(w)
        self.pos += w.size
        return base

    def slot(self, name, groups, rows, B=TB, pad=0):
        """Pack [(case, (n, rows) descriptors)] as the slot's case-pure
        chunks; returns its runs."""
        chunks, runs, c0 = [], [], 0
        for case, cols in groups:
            cols = np.asarray(cols, np.int64).reshape(-1, rows)
            n = cols.shape[0]
            nc = -(-n // B)
            flat = np.full((nc * B, rows), pad, np.int64)
            flat[:n] = cols
            chunks.append(flat.reshape(nc, B, rows).transpose(0, 2, 1))
            runs.append(InterRun(case, c0, nc, n))
            c0 += nc
        self.hdr[INTER0 + 2 * SLOTS[name]] = self.add(np.concatenate(chunks))
        self.hdr[INTER0 + 2 * SLOTS[name] + 1] = c0
        return runs

    def dev(self):
        w = np.concatenate(self.words + [np.zeros(16, np.int32)])
        w[:HDR_LEN] = self.hdr
        return torch.from_numpy(w)


def hand_frame(bpc, seed):
    """A blob with tiles in every slot (see the module docstring): returns
    (input planes, ra, blob, header, runs, luma and chroma reference
    planes, the program's statics)."""
    rng = np.random.default_rng(seed)
    psz = AH * AW
    prow = IK.pool_rows(AH, AW)
    pxmax = (1 << bpc) - 1
    desc = {}  # slot: {case: [descriptor columns]}

    def add(name, case, cols):
        desc.setdefault(name, {}).setdefault(case, []).append(
            [int(v) for v in cols])

    # 8x8 destination cells of the three planes, shuffled; three are kept
    # for the stores that leave the planes
    kept = [(0, 0, 8), (2, AH - 8, AW - 16), (2, AH - 8, AW - 8)]
    cells = [(p, y, x) for p in range(3) for y in range(0, AH, 8)
             for x in range(0, AW, 8) if (p, y, x) not in kept]
    cells = [cells[i] for i in rng.permutation(len(cells))]
    pool_free = [int(r) for r in rng.permutation(prow - 1)]  # not prow - 1
    lap_free = [int(r) for r in rng.permutation(prow)]
    put_cells, pool_rows, lap_rows = [], [prow - 1], []

    def cell():
        p, y, x = cells.pop()
        return p * psz + y * AW + x

    def tw_th(i):
        if i == 5:
            return 3, 5  # odd partial tile
        return (int(rng.integers(1, 9)) if rng.random() < 0.3 else 8,
                int(rng.integers(1, 9)) if rng.random() < 0.3 else 8)

    def src(k, i):
        """(stack row, window row, window column): tiles 0-3 cross the top,
        bottom, left and right edges of the visible picture, tile 4 names
        a stack row past the stack."""
        vw, vh = VIS[k]
        srow = 3 if i == 4 else (-1 if i == 6 else int(rng.integers(0, 2)))
        if i < 4:
            return (srow,) + [(-12, 5), (vh - 2, 5), (5, -12), (5, vw - 2)][i]
        return srow, int(rng.integers(-16, vh + 6)), int(
            rng.integers(-16, vw + 6))

    def put_desc(k, case, flat0, i):
        mx, my = int(rng.integers(0, 16)), int(rng.integers(0, 16))
        if case == 4:  # bilinear: mx and my each 0 or not
            mx, my = mx * (i % 2), my * ((i // 2) % 2)
        return (*src(k, i), mx, my, int(rng.integers(0, 11)), flat0,
                *tw_th(i), int(rng.choice([4, 8, 16])),
                int(rng.choice([4, 8, 16])), case)

    for name, k, ncases in (("putY", 0, 5), ("putC", 1, 5), ("lapY", 0, 5),
                            ("lapC", 1, 5), ("prepY", 0, 4),
                            ("prepC", 1, 4)):
        for case in range(ncases):
            for i in range(300 if (name, case) == ("prepY", 0) else 7):
                if name.startswith("put"):
                    f0 = cell()
                    put_cells.append(f0)
                elif name.startswith("lap"):
                    lap_rows.append(lap_free.pop())
                    f0 = lap_rows[-1] * 64
                else:
                    pool_rows.append(pool_free.pop())
                    f0 = pool_rows[-1] * 64
                add(name, case, put_desc(k, case, f0, i))
    # the last pool row, one past the pools; stores partly above plane 0
    # and partly past plane 2
    add("prepY", 3, put_desc(0, 3, (prow - 1) * 64, 7))
    add("prepY", 3, put_desc(0, 3, prow * 64, 7))
    add("putY", 3, put_desc(0, 3, -2 * AW + 8, 7))
    add("putY", 3, put_desc(0, 3, 2 * psz + (AH - 4) * AW + AW - 16, 7))

    for name, k in (("warpY", 0), ("warpC", 1), ("wprepY", 0),
                    ("wprepC", 1)):
        for i in range(9):
            if name.startswith("warp"):
                f0 = cell()
            else:
                pool_rows.append(pool_free.pop())
                f0 = pool_rows[-1] * 64
            a, b_, c, d = (int(v) for v in rng.integers(-3000, 3001, 4))
            mx, my = (int(v) for v in rng.integers(-70000, 70001, 2))
            if i == 7:
                mx = -200000  # every horizontal index below the table
            if i == 8:
                my = 250000  # every vertical index past it
            add(name, None, (*src(k, i), a, b_, c, d, mx, my, f0, *tw_th(i)))

    # host pool tiles: two chunks, padding lanes, rows before and past the
    # pools
    for i in range(70):
        row = -1 if i == 68 else (prow + 3 if i == 69 else pool_free.pop())
        if 0 <= row < prow:
            pool_rows.append(row)
        add("hostpool", None,
            (row, *rng.integers(-32768, 32768, 64)))

    # the wedge and blend masks: 0..64 at hbase
    L = 512
    masks = rng.integers(0, 65, L)

    def comb_rows():
        pick = [pool_rows[int(rng.integers(0, len(pool_rows)))]
                for _ in range(2)]
        u = rng.random()
        if u < 0.1:
            pick[0] = prow + 7  # clamped to the last row
        elif u < 0.15:
            pick[1] = -3  # clamped to row 0
        elif u < 0.25:
            pick[1] = pool_free[int(rng.integers(0, len(pool_free)))]
        return pick

    for i in range(10):
        add("avg", None, (*comb_rows(), cell(), int(rng.integers(0, 17)), 0,
                          0, *tw_th(i)))
    moffs = []
    moff = 64
    for name in ("segy00", "segy10", "segy11"):
        sh, sv = int(name[4]), int(name[5])
        for i in range(7):
            p0 = moff
            if (name, i) == ("segy11", 5):
                p0 = psz - 20  # partly past the mask pool
            elif (name, i) == ("segy00", 6):
                p0 = -20  # partly before it
            else:
                moff += 64
                moffs.append(p0)
            add(name, None, (*comb_rows(), cell(), p0, 8 >> sh, i % 2,
                             *tw_th(i)))
    for i in range(7):
        p0 = int(rng.integers(0, L - 130)) if i < 6 else 10 ** 6
        add("mask", None, (*comb_rows(), cell(), p0, int(rng.choice([8, 16])),
                           0, *tw_th(i)))
    for i in range(8):
        p0 = (moffs[i % len(moffs)] if i < 6 else
              (psz + 100 if i == 6 else -40))
        add("seguv", None, (*comb_rows(), cell(), p0, 8, 0, *tw_th(i)))

    # blends over put cells: each top blend's cell also has a left blend
    # (the corner both write), rows the lap tiles wrote, one they did not,
    # one past the pool; a mask read past the blob
    tops, lefts = [], []
    for i, f0 in enumerate(put_cells[:12]):
        row = (lap_rows[i] if i < 9 else
               (lap_free[0] if i == 9 else (prow + 2 if i == 10 else -1)))
        mo = int(rng.integers(0, L - 16)) if i != 11 else 10 ** 6
        tops.append((row, f0, mo, 1, 0, 8, int(rng.integers(1, 9))))
        lefts.append((row, f0, int(rng.integers(0, L - 16)), 0, 1,
                      int(rng.integers(1, 9)), 8))

    b = Blob()
    runs = {}
    for name in IK.PRED + IK.COMB + IK.SEGUV:
        if name in desc:
            rows = IK.ROWS[name]
            runs[name] = b.slot(name, sorted(desc[name].items(),
                                             key=lambda kv: kv[0] or 0),
                                rows, HB if name == "hostpool" else TB,
                                pad=1 << 30 if name == "hostpool" else 0)
    runs["blend"] = b.slot("blend", [("top", tops), ("left", lefts)], NBLEND)
    b.hdr[IH0] = b.add(masks)

    # at 12 bits the reference planes take every int16 value, so that the
    # int16 wraps of the intermediates bite
    dt = torch.uint8 if bpc == 8 else torch.int16
    lo, hi = (-32768, 32768) if bpc == 12 else (0, pxmax + 1)
    refs = [[torch.from_numpy(rng.integers(lo, hi, REF_SHAPE[k])).to(dt)
             for _ in range(2)] for k in (0, 1)]
    ra = torch.from_numpy(rng.integers(-pxmax, pxmax + 1, 6 * psz)
                          .astype(np.int32))
    planes = torch.from_numpy(rng.integers(0, pxmax + 1, (3, AH, AW))
                              .astype(np.int32))
    geom = dict(ah=AH, aw=AW, bpc=bpc, vwY=VIS[0][0], vhY=VIS[0][1],
                vwC=VIS[1][0], vhC=VIS[1][1])
    return planes, ra, b.dev(), b.hdr, runs, refs, geom


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bpc", (8, 10, 12))
def test_hand_built_blob(host_lib, bpc, form):
    """Every slot, case and clamp of a hand-built blob (module docstring),
    the reference planes stacked for the plain version and listed for the
    kernel."""
    planes, ra, dev, hdr, runs, (rY, rC), geom = hand_frame(bpc, bpc)
    assert {r.case for r in runs["putY"]} == {0, 1, 2, 3, 4}
    assert {r.case for r in runs["prepC"]} == {0, 1, 2, 3}
    assert runs["prepY"][0].nc == 2 and runs["hostpool"][0].nc == 2
    want = P.inter_plain(planes.clone(), ra, dev, hdr, runs,
                         torch.stack(rY), torch.stack(rC), **geom)
    for grid, reverse in WALKS:
        got = P.inter_kernels(planes.clone(), ra, dev, hdr, runs, rY, rC,
                              k=HostInter(host_lib, grid, reverse, form),
                              **geom)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want != planes).float().mean() > 0.5


# ------------------------------ the wrapper ------------------------------


def test_cpu_inter_runs_the_plain_version():
    """programs.inter on CPU tensors is inter_plain, on stacked or listed
    reference planes, and launches nothing; the wrappers of both forms
    and of their traced builds raise on CPU tensors and count no launch."""
    fr = frame_of("s1", 1)
    n0 = (IK.launches, IK.earlier_launches)
    want = P.inter_plain(fr.zeros(), fr.ra, fr.dev, fr.pk.hdr,
                         fr.pk.inter_runs, fr.sY, fr.sC, **fr.geom)
    got = P.inter(fr.zeros(), fr.ra, fr.dev, fr.pk.hdr, fr.pk.inter_runs,
                  fr.sY, fr.sC, **fr.geom)
    listed = P.inter(fr.zeros(), fr.ra, fr.dev, fr.pk.hdr, fr.pk.inter_runs,
                     list(fr.sY), list(fr.sC), **fr.geom)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(listed.numpy(), want.numpy())
    rows = IK.pool_rows(fr.geom["ah"], fr.geom["aw"])
    scratch = [torch.empty(rows * 64, dtype=torch.int32) for _ in range(2)]
    scratch.append(torch.empty(fr.geom["ah"] * fr.geom["aw"],
                               dtype=torch.int32))
    args = (fr.zeros(), fr.ra, fr.dev, fr.pk.hdr, fr.pk.inter_runs, fr.sY,
            fr.sC, *scratch)
    for call in (lambda: IK.inter_frame(*args, **fr.geom),
                 lambda: IK.inter_frame_earlier(*args, **fr.geom),
                 lambda: IK.trace_frame(*args, form="new", **fr.geom),
                 lambda: IK.trace_frame(*args, form="earlier", **fr.geom)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (IK.launches, IK.earlier_launches) == n0


def test_inter_args_refuse_what_the_kernel_does_not_take():
    """A run outside the blob, too many reference planes, references
    smaller than the visible picture and a bpc the kernel does not take
    raise before any launch; the segment table follows the phases."""
    fr = frame_of("s1", 1)
    g = dict(fr.geom)
    rows = IK.pool_rows(g["ah"], g["aw"])
    sc = [torch.empty(rows * 64, dtype=torch.int32) for _ in range(2)]
    sc.append(torch.empty(g["ah"] * g["aw"], dtype=torch.int32))
    args = (fr.zeros(), fr.ra, fr.dev, fr.pk.hdr)
    a = IK.inter_args(*args, fr.pk.inter_runs, fr.sY, fr.sC, *sc, **g)
    ph = IK.phases(fr.pk.inter_runs)
    assert list(a.ps) == list(np.cumsum([0] + [len(p) for p in ph]))
    assert a.seg_first[a.ps[5]] == sum(r.n for v in fr.pk.inter_runs.values()
                                       for r in v)
    assert a.nref[0] == fr.sY.shape[0] and a.esize[0] == 1
    bad = {k: list(v) for k, v in fr.pk.inter_runs.items()}
    r = bad["avg"][0]
    bad["avg"] = [InterRun(r.case, r.c0 + fr.dev.numel() // (8 * TB), r.nc,
                           r.n)]
    for runs, sY, kw, what in (
            (bad, fr.sY, g, "does not fit"),
            (fr.pk.inter_runs, [fr.sY[0]] * 17, g, "at most"),
            (fr.pk.inter_runs, fr.sY[:, :100], g, "outside"),
            (fr.pk.inter_runs, fr.sY, dict(g, bpc=9), "bpc")):
        with pytest.raises(ValueError, match=what):
            IK.inter_args(*args, runs, sY, fr.sC, *sc, **kw)


# ---------------------- windows, batches, the tail -----------------------

EDGE_VIS = {0: (90, 60), 1: (45, 30)}  # (vw, vh) of the luma and chroma refs
EDGE_REF = {0: (61, 91), 1: (31, 47)}  # their planes: rows of odd length


def _odd_planes(rng, shape, dt, hi, n=2):
    """n contiguous (H, W) planes that start one element into their
    storage, so that neither a plane nor (with W odd) most of its rows
    start on a 4-byte boundary."""
    out = []
    for _ in range(n):
        flat = torch.from_numpy(rng.integers(0, hi, shape[0] * shape[1] + 1)
                                ).to(dt)
        out.append(flat[1:].view(shape))
    return out


def edge_frame(bpc, seed):
    """Puts of all five cases and warps, luma and chroma, whose windows lie
    flush with each edge of the visible picture (inside it: the new form
    loads their rows as words), cross each edge by one to three pixels
    (the clamped gather) or lie inside at random. Returns (planes, ra,
    blob, header, runs, reference planes, statics, windows by (edge,
    inside))."""
    rng = np.random.default_rng(seed)
    psz = AH * AW
    pxmax = (1 << bpc) - 1
    cells = [p * psz + y * AW + x for p in range(3) for y in range(0, AH, 8)
             for x in range(0, AW, 8)]
    cells = [cells[i] for i in rng.permutation(len(cells))]
    wins = {}
    desc = {}

    def place(k, ny, nx, edge, flush):
        vw, vh = EDGE_VIS[k]
        y0 = int(rng.integers(0, vh - ny + 1))
        x0 = int(rng.integers(0, vw - nx + 1))
        out = 0 if flush else int(rng.integers(1, 4))
        if edge == "top":
            y0 = -out
        elif edge == "bottom":
            y0 = vh - ny + out
        elif edge == "left":
            x0 = -out
        elif edge == "right":
            x0 = vw - nx + out
        inside = 0 <= y0 <= vh - ny and 0 <= x0 <= vw - nx
        wins[edge, inside] = wins.get((edge, inside), 0) + 1
        return y0, x0

    spots = [(e, f) for e in ("top", "bottom", "left", "right")
             for f in (True, False)] + [("inside", True)] * 2
    for name, k in (("putY", 0), ("putC", 1)):
        for case in range(5):
            v, h = case in (0, 2), case in (0, 1)
            ny = 9 if case == 4 else (15 if v else 8)
            nx = 9 if case == 4 else (15 if h else 8)
            for edge, flush in spots:
                y0, x0 = place(k, ny, nx, edge, flush)
                desc.setdefault(name, {}).setdefault(case, []).append(
                    (int(rng.integers(0, 2)), y0 + 3 * v, x0 + 3 * h,
                     int(rng.integers(1, 16)), int(rng.integers(1, 16)),
                     int(rng.integers(0, 10)), cells.pop(), 8, 8,
                     int(rng.choice([4, 8])), int(rng.choice([4, 8])), case))
    for name, k in (("warpY", 0), ("warpC", 1)):
        for edge, flush in spots:
            y0, x0 = place(k, 15, 15, edge, flush)
            a, b_, c, d = (int(v) for v in rng.integers(-3000, 3001, 4))
            mx, my = (int(v) for v in rng.integers(-70000, 70001, 2))
            desc.setdefault(name, {}).setdefault(None, []).append(
                (int(rng.integers(0, 2)), y0 + 3, x0 + 3, a, b_, c, d, mx, my,
                 cells.pop(), 8, 8))
    b = Blob()
    runs = {name: b.slot(name, sorted(g.items(), key=lambda kv: kv[0] or 0),
                         IK.ROWS[name]) for name, g in desc.items()}
    b.hdr[IH0] = b.add(np.zeros(64, np.int32))
    dt = torch.uint8 if bpc == 8 else torch.int16
    refs = [_odd_planes(rng, EDGE_REF[k], dt, pxmax + 1) for k in (0, 1)]
    ra = torch.from_numpy(rng.integers(-pxmax, pxmax + 1, 6 * psz)
                          .astype(np.int32))
    planes = torch.from_numpy(rng.integers(0, pxmax + 1, (3, AH, AW))
                              .astype(np.int32))
    geom = dict(ah=AH, aw=AW, bpc=bpc, vwY=EDGE_VIS[0][0],
                vhY=EDGE_VIS[0][1], vwC=EDGE_VIS[1][0], vhC=EDGE_VIS[1][1])
    return planes, ra, b.dev(), b.hdr, runs, refs, geom, wins


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("bpc", (8, 10))
def test_windows_on_the_picture_edges(host_lib, bpc, form):
    """Windows flush with and across each edge of the visible picture, at
    1- and 2-byte references whose planes and rows start off a 4-byte
    boundary: the word loads and the clamped gather of the new form, and
    the earlier form's gather, against inter_plain."""
    planes, ra, dev, hdr, runs, (rY, rC), geom, wins = edge_frame(bpc, bpc)
    for edge in ("top", "bottom", "left", "right"):
        assert wins[edge, True] and wins[edge, False], edge
    assert all(t.data_ptr() % 4 for t in rY + rC)
    _kernel_matches_plain(host_lib, planes, ra, dev, hdr, runs,
                          torch.stack(rY), torch.stack(rC), geom, form)
    want = P.inter_plain(planes.clone(), ra, dev, hdr, runs,
                         torch.stack(rY), torch.stack(rC), **geom)
    got = P.inter_kernels(planes.clone(), ra, dev, hdr, runs, rY, rC,
                          k=HostInter(host_lib, 3, False, form), **geom)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def batches(n, nw):
    """csrc/inter.cu's batches of a phase of n tiles over nw warps: [(first
    tile, tiles)]."""
    bs = min(32, max(1, -(-n // (2 * nw))))
    return [(b, min(bs, n - b)) for b in range(0, n, bs)]


RUN_SIZES = (33, 31, 1, 40, 5)  # putY tiles of cases 0-4


@pytest.mark.parametrize("grid", (1, 2))
def test_batches_straddle_runs(host_lib, grid):
    """Runs of 33, 31, 1, 40 and 5 tiles (fewer and more than 32) in one
    phase: at 1 and 2 blocks (8 and 16 warps) batches of 7 and 4 tiles
    straddle the runs' boundaries; both forms against inter_plain."""
    rng = np.random.default_rng(7 + grid)
    psz = AH * AW
    cells = [p * psz + y * AW + x for p in range(3) for y in range(0, AH, 8)
             for x in range(0, AW, 8)]
    cells = [cells[i] for i in rng.permutation(len(cells))]
    groups = []
    for case, n in enumerate(RUN_SIZES):
        cols = []
        for _ in range(n):
            cols.append((int(rng.integers(0, 2)), int(rng.integers(-8, 64)),
                         int(rng.integers(-8, 94)), int(rng.integers(0, 16)),
                         int(rng.integers(0, 16)), int(rng.integers(0, 10)),
                         cells.pop(), *(int(v) for v in rng.integers(1, 9, 2)),
                         8, 8, case))
        groups.append((case, cols))
    b = Blob()
    runs = {"putY": b.slot("putY", groups, NPUT)}
    b.hdr[IH0] = b.add(np.zeros(64, np.int32))
    bounds = np.cumsum(RUN_SIZES)[:-1]
    got = batches(sum(RUN_SIZES), 8 * grid)
    assert any(b0 < e < b0 + n for b0, n in got for e in bounds)
    assert min(RUN_SIZES) < 32 < max(RUN_SIZES)
    refs = [torch.from_numpy(rng.integers(0, 256, REF_SHAPE[0])).to(
        torch.uint8) for _ in range(2)]
    geom = dict(ah=AH, aw=AW, bpc=8, vwY=VIS[0][0], vhY=VIS[0][1],
                vwC=VIS[1][0], vhC=VIS[1][1])
    planes = torch.from_numpy(rng.integers(0, 256, (3, AH, AW)).astype(
        np.int32))
    ra = torch.from_numpy(rng.integers(-255, 256, 6 * psz).astype(np.int32))
    for form in FORMS:
        _kernel_matches_plain(host_lib, planes, ra, b.dev(), b.hdr, runs,
                              torch.stack(refs), torch.stack(refs[:1]), geom,
                              form, walks=((grid, False), (grid, True)))


def test_residual_tail(host_lib):
    """A frame of 5 x 13 cells a plane (3 x 65 = 195 cells: 48 groups of 4
    and a tail of 3) with two partial puts: both forms against
    inter_plain, over 1 and 3 blocks."""
    rng = np.random.default_rng(11)
    ah, aw = 5, 13
    b = Blob()
    cols = [(0, 1, 2, 0, 0, 0, 0, 8, 5, 8, 8, 3),
            (0, 0, 5, 0, 0, 0, 2 * ah * aw + 8, 5, 5, 8, 8, 3)]
    runs = {"putY": b.slot("putY", [(3, cols)], NPUT)}
    b.hdr[IH0] = b.add(np.zeros(64, np.int32))
    refs = torch.from_numpy(rng.integers(0, 256, (1, 8, 16))).to(torch.uint8)
    geom = dict(ah=ah, aw=aw, bpc=8, vwY=13, vhY=5, vwC=7, vhC=3)
    planes = torch.from_numpy(rng.integers(0, 256, (3, ah, aw)).astype(
        np.int32))
    ra = torch.from_numpy(rng.integers(-255, 256, 6 * ah * aw).astype(
        np.int32))
    assert (3 * ah * aw) % 4 == 3
    for form in FORMS:
        want = _kernel_matches_plain(
            host_lib, planes, ra, b.dev(), b.hdr, runs, refs, refs, geom,
            form, walks=((1, False), (3, True)))
    assert (want[:, 4, 8:] != planes[:, 4, 8:]).any()
