"""The wave kernel against the plain wave step and the JAX engine, exactly.

csrc/wave.cu compiled for the host with g++ runs ops/cuda/wave.py
frame_args over a frame blob through both of its host entries: the
per-level entry (rav1d_wave_level_host, one call per level, as
wave_levels launches it) and the frame entry (rav1d_wave_frame_host, one
call per frame, as programs.wave launches rav1d_wave_frame on the card:
the frame kernel's level walk over the blob's counts, with every block's
read-ahead of level i+1 run before any item of level i). Each walks the
thread blocks with the kernel's own step functions, thread by thread, each
barrier a loop boundary; the kernels themselves build and run only on the
card, where chip_smoke.py holds them to wave_plain. Checked, through each
entry:

- every mode code (the DC family, V, H, Paeth, the smooth modes, Z1, Z2
  and Z3, filter intra, IDENT, the four CfL codes and an unknown code) on
  a hand-built level of each size class at 8, 10 and 12 bits (4:2:0,
  4:2:2 and 4:4:4 for CfL), against programs.wave_plain (engine/wave.py
  class_step): every edge-availability case (hav 0-3, phtr and phbl 0 and
  above 0), Z angles that take the edge filter and the upsampler, items
  with and without an interintra mask, with and without a residual;
- whole frames packed by the port against wave_plain: an 8-bit intra
  still, the 10-bit 4:2:2 and 8-bit 4:4:4 inter frames of
  tests/test_torch_formats_programs.py (interintra, segy slots; the inter
  program's planes as input), a 12-bit 4:0:0 still and a frame with
  128-px superblocks and 2x2 tiles;
- one of those frames against rav1d_tpu's mega.wave_prog on the CPU (the
  geometry of tests/test_torch_programs.py);
- a level with both classes and every mode in one launch against the
  small class then the large class (the order JAX uses), with the thread
  blocks run forwards and backwards;
- the frame entry against the per-level entry on each of those, and on
  two hand-built levels whose second reads, through its edges, IDENT,
  interintra and CfL, pixels that the first writes (a read-ahead that
  touched a pixel would read it unwritten).

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
from rav1d_tpu_torch.engine import wave as TW
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.layout import F_II, FI, HDR_LEN, N_FIELDS, WAVE0
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.engine.plan import CAP, CLS_L, CLS_S
from rav1d_tpu_torch.engine.run import stack_planes
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops import ipred_dyn as D
from rav1d_tpu_torch.ops.cuda import wave as cuda_wave

CSRC = os.path.join(os.path.dirname(cuda_wave.__file__), "..", "..", "csrc")
Z1, Z2, Z3, FILTER = 6, 7, 8, 13
UNKNOWN = 21
IDENT, CFL_DC = 14, 15
MODES = list(range(19)) + [UNKNOWN]  # 14 IDENT, 15-18 the CfL codes
ENTRIES = ["level", "frame"]  # the host entries: per level, per frame
SS = {8: (1, 1), 10: (1, 0), 12: (0, 0)}  # (ss_hor, ss_ver) per test bpc


@pytest.fixture(scope="module")
def host_wave(tmp_path_factory):
    """csrc/wave.cu compiled for the host with g++ and loaded."""
    so = os.path.join(str(tmp_path_factory.mktemp("wave")), "libwave_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", so, os.path.join(CSRC, "wave.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.rav1d_wave_level_host.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4
    lib.rav1d_wave_level_host.restype = ctypes.c_int
    lib.rav1d_wave_frame_host.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 2
    lib.rav1d_wave_frame_host.restype = ctypes.c_int
    lib.rav1d_wave_frame_levels_host.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_void_p, ctypes.c_int]
    lib.rav1d_wave_frame_levels_host.restype = ctypes.c_int
    return lib


def kernel_wave(lib, planes, ra, dev, hdr, waves, *, ah, aw, bpc, ss_hor,
                ss_ver, reverse=0, entry="level"):
    """programs.wave with the host build in place of the launches: the
    palette scatter, then one call per level with items (entry "level",
    wave_levels) or one call for the frame over grid(waves) blocks (entry
    "frame", wave_frame)."""
    pf = P.palette_pf(planes, dev, hdr)
    f = cuda_wave.frame_args(pf, ra, dev, hdr, waves, aw=aw, psz=ah * aw,
                             bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    if entry == "frame":
        assert lib.rav1d_wave_frame_host(ctypes.byref(f),
                                         cuda_wave.grid(waves), reverse) == 0
    else:
        for i, ns, nl in cuda_wave.levels(waves):
            assert lib.rav1d_wave_level_host(ctypes.byref(f), i, ns, nl,
                                             reverse) == 0
    return pf[: 3 * ah * aw].view(3, ah, aw)


def blob_of(levels, masks):
    """(hdr, blob, waves) of hand-built levels: per level the (rows, n) of
    the small class, then of the large class (CAP rows of the class, the
    first n its items; lane 0's wflags and wcount are set here), then the
    interintra mask words; `waves` is the packer's host view of them."""
    hdr = np.zeros(HDR_LEN, np.int32)
    waves = []
    for per in levels:
        view = []
        for rows, n in per:
            flags = F_II if n and (rows[:n, FI["iioff"]] >= 0).any() else 0
            rows[0, FI["wflags"]] = flags
            rows[0, FI["wcount"]] = n
            view.append((rows, n, flags,
                         tuple(sorted(set(rows[:n, FI["modes"]].tolist())))))
        waves.append(tuple(view))
    words = [hdr]
    pos = HDR_LEN
    for cls in (0, 1):
        region = np.stack([per[cls][0] for per in levels]).reshape(-1)
        hdr[WAVE0 + 1 + cls] = pos
        words.append(region)
        pos += region.size
    hdr[WAVE0] = len(levels)
    hdr[WAVE0 + 3] = pos
    words.append(masks)
    return hdr, torch.from_numpy(np.concatenate(words)), waves


def blank_rows(cls, psz):
    """CAP[cls] descriptor rows that write nothing (flat0 past the planes)."""
    rows = np.zeros((CAP[cls], N_FIELDS), np.int32)
    rows[:, FI["flat0"]] = 3 * psz
    rows[:, FI["w"]] = rows[:, FI["h"]] = 4
    rows[:, FI["iioff"]] = -1
    return rows


# ------------------------------ hand-built levels ------------------------


def _size(rng, cls):
    if cls == 0:
        return tuple(int(v) for v in rng.choice([4, 8, 16], 2))
    return [(8, 32), (32, 8), (16, 32), (32, 16), (32, 32), (16, 64),
            (64, 16), (32, 64), (64, 32), (64, 64)][rng.integers(10)]


def _angle(rng, mode, k):
    """A packed angle for the mode: every 4th item at an angle whose
    smaller deviation from its edge is below 40 degrees (the upsampler's
    range), 3 items of 4 with the edge filter on, is_sm at random."""
    near = k % 4 == 0
    if mode == Z1:
        a = int(rng.integers(51, 88) if near else rng.integers(3, 88))
    elif mode == Z2:
        a = int(rng.choice([rng.integers(93, 130), rng.integers(141, 178)])
                if near else rng.integers(93, 178))
    elif mode == Z3:
        a = int(rng.integers(183, 220) if near else rng.integers(183, 268))
    elif mode == FILTER:
        return int(rng.integers(0, 7))  # the filter index, clamped to 0-4
    else:
        return int(rng.integers(0, 2048))  # ignored
    return a | int(rng.integers(0, 2)) << 9 | int(k % 4 != 3) << 10


class Level:
    """One wave level of hand-built items: each item in a cell of its own
    (3 CH by 3 CW) that holds its block, every edge pixel it can read and
    nothing any other item writes; small-class items in plane 1,
    large-class in plane 2; CfL luma read from plane 0, which no item
    writes. Random planes, residuals and interintra masks."""

    def __init__(self, seed, bpc, modes_s, modes_l):
        rng = np.random.default_rng(seed)
        self.bpc = bpc
        self.ss_hor, self.ss_ver = SS[bpc]
        self.aw = 4 * 3 * CLS_L[0]
        rows_of = lambda n, per: -(-n // per)  # noqa: E731
        self.ah = max(3 * CLS_S[1] * rows_of(len(modes_s), 16),
                      3 * CLS_L[1] * rows_of(len(modes_l), 4), 1)
        ah, aw = self.ah, self.aw
        psz = ah * aw
        pxmax = (1 << bpc) - 1
        # pixels a little past [0, pxmax] too: only items with a residual
        # clip
        self.planes = torch.from_numpy(rng.integers(
            -(pxmax >> 3), pxmax + (pxmax >> 3), (3, ah, aw)).astype(np.int32))
        self.ra = torch.from_numpy(rng.integers(
            -pxmax - 1, pxmax + 2, 6 * psz).astype(np.int32))
        mask_n = CLS_L[0] * CLS_L[1] * (len(modes_s) + len(modes_l))
        masks = rng.integers(0, 65, mask_n).astype(np.int32)
        level, mask_off = [], 0
        for cls, modes, pl in ((0, modes_s, 1), (1, modes_l, 2)):
            CW, CH = (CLS_S, CLS_L)[cls]
            per_row = aw // (3 * CW)
            rows = blank_rows(cls, psz)
            for k, mode in enumerate(modes):
                # the upsampler needs w + h <= 8 (is_sm) or 16
                w, h = (4, 4) if cls == 0 and k % 4 == 0 else _size(rng, cls)
                y0 = (k // per_row) * 3 * CH + 1
                x0 = (k % per_row) * 3 * CW + 1
                r = rows[k]
                r[FI["modes"]] = mode
                r[FI["angles"]] = _angle(rng, mode, k)
                r[FI["flat0"]] = pl * psz + y0 * aw + x0
                r[FI["rmask"]] = rng.integers(0, 2)
                r[FI["z2mw"]] = rng.integers(0, w + 5)
                r[FI["z2mh"]] = rng.integers(0, h + 5)
                r[FI["z2sm"]] = rng.integers(0, 2)
                r[FI["w"]], r[FI["h"]] = w, h
                hav = k % 4
                r[FI["hav"]] = hav
                if hav & 1:
                    r[FI["phl"]] = rng.integers(1, h + 1)
                    r[FI["phbl"]] = 0 if k // 4 % 2 else rng.integers(1, h + 1)
                if hav & 2:
                    r[FI["pht"]] = rng.integers(1, w + 1)
                    r[FI["phtr"]] = 0 if k // 8 % 2 else rng.integers(1, w + 1)
                if k % 2:  # interintra over the block's own pixels
                    r[FI["iioff"]] = mask_off
                    mask_off += CW * CH
                r[FI["cfla"]] = rng.integers(-16, 17)
                ly = rng.integers(0, ah - (CH << self.ss_ver) + 1)
                lx = rng.integers(0, aw - (CW << self.ss_hor) + 1)
                r[FI["cfl0"]] = ly * aw + lx
                r[FI["cflwp"]] = rng.integers(0, 4)
                r[FI["cflhp"]] = rng.integers(0, 4)
            level.append((rows, len(modes)))
        self.hdr, self.dev, self.waves = blob_of([level], masks)

    def kw(self):
        return dict(ah=self.ah, aw=self.aw, bpc=self.bpc,
                    ss_hor=self.ss_hor, ss_ver=self.ss_ver)

    def plain(self):
        return P.wave_plain(self.planes.clone(), self.ra, self.dev, self.hdr,
                            self.waves, **self.kw())

    def kernel(self, lib, reverse=0, entry="level"):
        return kernel_wave(lib, self.planes.clone(), self.ra, self.dev,
                           self.hdr, self.waves, reverse=reverse, entry=entry,
                           **self.kw())


def _z_branches(level, cls):
    """(items whose Z prediction upsamples, items whose edge filter is
    on) of a class of a Z-mode level, by ipred_dyn's own rules."""
    rows, n = level.waves[0][cls][:2]
    r = torch.from_numpy(rows[:n])
    ang, is_sm, ief = D._decode_angle(r[:, FI["angles"]])
    wh = r[:, FI["w"]] + r[:, FI["h"]]
    mode = int(r[0, FI["modes"]])
    a = {Z1: 90 - ang, Z3: ang - 180}.get(mode, ang - 90)
    on = ief != 0
    return (int((D._ups_t(wh, a, is_sm)[on] != 0).sum()),
            int((D._fs_t(wh, a, is_sm)[on] > 0).sum()))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("cls", [0, 1], ids=["S16", "L64"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_class_step(host_wave, mode, cls, bpc, entry):
    n = 16 if cls == 0 else 8
    modes = [mode] * n
    level = Level(1000 * mode + 10 * bpc + cls, bpc,
                  modes if cls == 0 else [], modes if cls == 1 else [])
    calls = TW.calls
    want = level.plain()
    assert TW.calls == calls + 1
    got = level.kernel(host_wave, entry=entry)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if entry == "frame":
        np.testing.assert_array_equal(got.numpy(),
                                      level.kernel(host_wave).numpy())
    assert (want != level.planes).any()
    if mode in (Z1, Z2, Z3):
        ups, filt = _z_branches(level, cls)
        assert filt > 0 and (ups > 0 or cls == 1), (ups, filt)


@pytest.mark.parametrize("entry", ENTRIES)
def test_both_classes_in_one_launch_match_small_then_large(host_wave, entry):
    """One level with 64 small-class and 16 large-class items of every
    mode: one launch (its blocks forwards, then backwards) equals
    class_step on the small class, then on the large."""
    rng = np.random.default_rng(77)
    level = Level(77, 10, [int(m) for m in rng.choice(MODES, 64)],
                  [int(m) for m in rng.choice(MODES, 16)])
    want = level.plain()
    for reverse in (0, 1):
        np.testing.assert_array_equal(
            level.kernel(host_wave, reverse, entry).numpy(), want.numpy())


def _two_levels(with_first):
    """Two hand-built 8-bit 4:2:0 levels (or the second alone): the first
    writes 16x16 blocks B and D of plane 1 and a 32x32 luma block; the
    second reads them: an IDENT item with an interintra mask over D
    itself, a CfL item (with interintra) over plane 2 whose luma is the
    written block, a V item under B (top edge from B's last row) and an H
    item right of B (left edge from B's last column)."""
    rng = np.random.default_rng(808)
    ah, aw, bpc = 96, 256, 8
    psz = ah * aw
    planes = torch.from_numpy(rng.integers(0, 256, (3, ah, aw)).astype(np.int32))
    ra = torch.from_numpy(rng.integers(-255, 257, 6 * psz).astype(np.int32))
    masks = rng.integers(0, 65, 2 * CLS_S[0] * CLS_S[1]).astype(np.int32)

    def item(rows, k, mode, flat0, w, h, **kv):
        r = rows[k]
        r[FI["modes"]], r[FI["flat0"]], r[FI["w"]], r[FI["h"]] = mode, flat0, w, h
        r[FI["rmask"]] = 1
        for name, v in kv.items():
            r[FI[name]] = v

    b0 = psz + 16 * aw + 16  # block B: plane 1 at (16, 16)
    d0 = b0 + 48  # block D: plane 1 at (16, 64)
    luma = 64  # plane 0 at (0, 64)
    s0, l0 = blank_rows(0, psz), blank_rows(1, psz)
    item(s0, 0, 0, b0, 16, 16)  # DC, no edge: constants
    item(s0, 1, 0, d0, 16, 16)
    item(l0, 0, 0, luma, 32, 32)
    s1 = blank_rows(0, psz)
    item(s1, 0, IDENT, d0, 16, 16, iioff=0)
    item(s1, 1, CFL_DC, 2 * psz + 16 * aw + 16, 16, 16, cfl0=luma, cfla=5,
         iioff=CLS_S[0] * CLS_S[1], rmask=0)
    item(s1, 2, 1, b0 + 16 * aw, 16, 16, hav=2, pht=16)  # V under B
    item(s1, 3, 2, b0 + 16, 16, 16, hav=1, phl=16)  # H right of B
    second = [(s1, 4), (blank_rows(1, psz), 0)]
    levels = ([[(s0, 2), (l0, 1)]] if with_first else []) + [second]
    hdr, dev, waves = blob_of(levels, masks)
    return planes, ra, dev, hdr, waves, dict(ah=ah, aw=aw, bpc=bpc,
                                              ss_hor=1, ss_ver=1)


def test_frame_read_ahead_reads_no_pixel(host_wave):
    """Level 1 reads, through its edges, IDENT, interintra and CfL, pixels
    that level 0 writes: the frame entry, which runs every block's
    read-ahead of level 1 before level 0's items, equals wave_plain and
    the per-level entry, forwards and backwards; and each of those reads
    sees level 0's output (without level 0 every read block differs)."""
    planes, ra, dev, hdr, waves, kw = _two_levels(True)
    want = P.wave_plain(planes.clone(), ra, dev, hdr, waves, **kw)
    args = (planes.clone(), ra, dev, hdr, waves)
    np.testing.assert_array_equal(kernel_wave(host_wave, *args, **kw).numpy(),
                                  want.numpy())
    for reverse in (0, 1):
        got = kernel_wave(host_wave, planes.clone(), ra, dev, hdr, waves,
                          reverse=reverse, entry="frame", **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    alone = P.wave_plain(planes.clone(), *_two_levels(False)[1:5], **kw)
    for pl, y, x in ((1, 16, 64), (2, 16, 16), (1, 32, 16), (1, 16, 32)):
        blk = (pl, slice(y, y + 16), slice(x, x + 16))
        assert (want[blk] != alone[blk]).any(), (pl, y, x)


# ------------------------------- packed frames ---------------------------


# name: (packets, index of the frame); the inter frames are those of
# tests/test_torch_formats_programs.py, the 4:2:2 one with interintra items
FRAMES = {
    "8bit-420-intra": (lambda: [synth.still_picture(136, 96, 10)], 0),
    "10bit-422-inter": (lambda: synth.inter_sequence(
        256, 192, 1, bpc=10, layout=PL.I422), 1),
    "8bit-444-inter": (lambda: synth.inter_sequence(
        256, 192, 1, layout=PL.I444), 2),
    "12bit-400-intra": (lambda: [synth.still_picture(
        136, 96, 5, bpc=12, layout=PL.I400)], 0),
    "8bit-sb128-tiles": (lambda: [synth.still_picture(
        320, 256, 3, tools=synth.Tools(sb128=True, tiles=(1, 1)))], 0),
}


class Frame:
    """A packed frame and the wave programs' input: the residual buffer
    of resid_plain and, on an inter frame, the planes of programs.inter
    (both held to the JAX programs by tests/test_torch_programs.py and
    tests/test_torch_formats_programs.py)."""

    def __init__(self, name):
        self.name = name
        packets, i = FRAMES[name]
        self.f, self.plan = synth.capture_frames(packets())[i]
        f, plan = self.f, self.plan
        self.pk = pack_frame(f, plan)
        ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
        layout = f.cur.layout
        ss_hor = 0 if layout == PL.I444 else 1
        ss_ver = 1 if layout == PL.I420 else 0
        self.kw = dict(ah=ah, aw=aw, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
        self.dev, _ = Uploader("cpu").upload(self.pk, ah * aw, bpc)
        self.ra, planes = P.resid_plain(self.dev, self.pk.hdr,
                                        self.pk.tx_valid, ah=ah, aw=aw,
                                        bpc=bpc)
        if self.pk.srcs is not None:
            out = f.sr_cur
            ach, acw = out.u.shape if out.u is not None else (0, 0)
            srcsY, srcsC = self.pk.srcs
            planes = P.inter(
                planes, self.ra, self.dev, self.pk.hdr, self.pk.inter_runs,
                stack_planes(srcsY, "cpu", (ah, aw)),
                stack_planes(srcsC, "cpu", (ach, acw)), ah=ah, aw=aw,
                bpc=bpc, vwY=f.cur.w, vhY=f.cur.h,
                vwC=(f.cur.w + ss_hor) >> ss_hor,
                vhC=(f.cur.h + ss_ver) >> ss_ver)
        self.planes = planes

    def plain(self):
        return P.wave_plain(self.planes.clone(), self.ra, self.dev,
                            self.pk.hdr, self.pk.waves, **self.kw)

    def kernel(self, lib, reverse=0, entry="level"):
        return kernel_wave(lib, self.planes.clone(), self.ra, self.dev,
                           self.pk.hdr, self.pk.waves, reverse=reverse,
                           entry=entry, **self.kw)

    @functools.cached_property
    def want(self):
        return self.plain()


@functools.lru_cache(maxsize=None)
def packed(name):
    """The Frame of FRAMES[name], made once per process."""
    return Frame(name)


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request):
    return packed(request.param)


@pytest.mark.parametrize("entry", ENTRIES)
def test_frame_matches_wave_plain(host_wave, frame, entry):
    want = frame.want
    for reverse in (0, 1):
        got = frame.kernel(host_wave, reverse, entry)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        if entry == "frame":
            np.testing.assert_array_equal(
                got.numpy(), frame.kernel(host_wave, reverse).numpy())
    counts = [n for per in frame.pk.waves for _, n, _, _ in per]
    assert sum(counts) > 0 and (want != frame.planes).any()
    ii = sum(int((rows[:n, FI["iioff"]] >= 0).sum())
             for per in frame.pk.waves for rows, n, _, _ in per)
    assert ii > 0 or frame.name != "10bit-422-inter"


@functools.lru_cache(maxsize=None)
def jax_wave_prog(name):
    """mega.wave_prog on the port's blob of FRAMES[name] (word-identical
    to run2's, tests/test_torch_programs.py), compiled once per process."""
    frame = packed(name)
    return np.asarray(JM.wave_prog(jnp.asarray(frame.planes.numpy()),
                                   jnp.asarray(frame.ra.numpy()),
                                   jnp.asarray(frame.dev.numpy()), **frame.kw))


@pytest.mark.parametrize("entry", ENTRIES)
def test_frame_matches_jax_wave_prog(host_wave, entry):
    """The 8-bit still against mega.wave_prog."""
    got = packed("8bit-420-intra").kernel(host_wave, entry=entry)
    np.testing.assert_array_equal(got.numpy(), jax_wave_prog("8bit-420-intra"))


# ------------------------------ the wrapper ------------------------------


def test_cpu_wave_runs_the_plain_version(host_wave):
    """programs.wave on CPU tensors is wave_plain (class_step calls, no
    launch); the kernel's wrapper takes CUDA tensors only; the kernel's
    table layout is engine/consts.py's."""
    level = Level(5, 8, [0, Z1], [FILTER])
    launches = cuda_wave.launches, cuda_wave.level_launches
    calls = TW.calls
    got = P.wave(level.planes.clone(), level.ra, level.dev, level.hdr,
                 level.waves, **level.kw())
    np.testing.assert_array_equal(got.numpy(), level.plain().numpy())
    assert (cuda_wave.launches, cuda_wave.level_launches) == launches
    assert TW.calls == calls + 4
    pf = P.palette_pf(level.planes, level.dev, level.hdr)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wave.wave_levels(pf, level.ra, level.dev, level.hdr,
                              level.waves, aw=level.aw, psz=level.ah * level.aw,
                              bpc=8, ss_hor=1, ss_ver=1)
    assert cuda_wave.levels(level.waves) == [(0, 2, 1)]
    assert host_wave.rav1d_wave_table_len() == cuda_wave.table_numpy().size


def test_frame_wrapper_rules(host_wave, frame):
    """wave_frame takes CUDA tensors only (nothing launched or counted on a
    CPU tensor); its grid is the largest level's item count; the levels
    the frame kernel walks over the blob's counts are levels(waves)."""
    pk = frame.pk
    pf = P.palette_pf(frame.planes, frame.dev, pk.hdr)
    kw = dict(aw=frame.kw["aw"], psz=frame.kw["ah"] * frame.kw["aw"],
              bpc=frame.kw["bpc"], ss_hor=frame.kw["ss_hor"],
              ss_ver=frame.kw["ss_ver"])
    launches = cuda_wave.launches, cuda_wave.level_launches
    for fn in (cuda_wave.wave_frame, cuda_wave.barrier_frame):
        with pytest.raises(ValueError, match="CUDA"):
            fn(pf, frame.ra, frame.dev, pk.hdr, pk.waves, **kw)
    assert (cuda_wave.launches, cuda_wave.level_launches) == launches
    lv = cuda_wave.levels(pk.waves)
    assert cuda_wave.grid(pk.waves) == max(ns + nl for _, ns, nl in lv)
    f = cuda_wave.frame_args(pf, frame.ra, frame.dev, pk.hdr, pk.waves, **kw)
    assert f.nw == len(pk.waves) == int(pk.hdr[WAVE0])
    out = np.zeros(3 * len(pk.waves), np.int32)
    n = host_wave.rav1d_wave_frame_levels_host(ctypes.byref(f),
                                               out.ctypes.data, len(pk.waves))
    assert [tuple(int(v) for v in t) for t in out[: 3 * n].reshape(-1, 3)] == lv

