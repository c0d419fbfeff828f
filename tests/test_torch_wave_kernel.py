"""The wave kernel against the plain wave step and the JAX engine, exactly.

csrc/wave.cu compiled for the host with g++ (its host entry walks the
launch's thread blocks with the kernel's own step functions, thread by
thread, each barrier a loop boundary; the kernel itself builds and runs
only on the card, where chip_smoke.py holds it to wave_plain) runs
ops/cuda/wave.py frame_args over a frame blob, one call per level, as
programs.wave launches it on the card. Checked:

- every mode code (the DC family, V, H, Paeth, the smooth modes, Z1, Z2
  and Z3, filter intra, IDENT, the four CfL codes and an unknown code) on
  a hand-built level of each size class at 8, 10 and 12 bits (4:2:0,
  4:2:2 and 4:4:4 for CfL), against programs.wave_plain (engine/wave.py
  class_step): every edge-availability case (hav 0-3, phtr and phbl 0 and
  above 0), Z angles that take the edge filter and the upsampler, items
  with and without an interintra mask, with and without a residual;
- whole frames packed by the port, level by level, against wave_plain:
  an 8-bit intra still, the 10-bit 4:2:2 and 8-bit 4:4:4 inter frames of
  tests/test_torch_formats_programs.py (interintra, segy slots; the inter
  program's planes as input), a 12-bit 4:0:0 still and a frame with
  128-px superblocks and 2x2 tiles;
- one of those frames against rav1d_tpu's mega.wave_prog on the CPU (the
  geometry of tests/test_torch_programs.py);
- a level with both classes and every mode in one launch against the
  small class then the large class (the order JAX uses), with the thread
  blocks run forwards and backwards.

Inputs are seeded with numpy. Tolerance: exact.
"""

import ctypes
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
MODES = list(range(19)) + [UNKNOWN]  # 14 IDENT, 15-18 the CfL codes
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
    return lib


def kernel_wave(lib, planes, ra, dev, hdr, waves, *, ah, aw, bpc, ss_hor,
                ss_ver, reverse=0):
    """programs.wave with the host build in place of the launches: the
    palette scatter, then one call per level with items."""
    pf = P.palette_pf(planes, dev, hdr)
    f = cuda_wave.frame_args(pf, ra, dev, hdr, waves, aw=aw, psz=ah * aw,
                             bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    for i, ns, nl in cuda_wave.levels(waves):
        assert lib.rav1d_wave_level_host(ctypes.byref(f), i, ns, nl,
                                         reverse) == 0
    return pf[: 3 * ah * aw].view(3, ah, aw)


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
        regions, waves, mask_off = [], [], 0
        for cls, modes, pl in ((0, modes_s, 1), (1, modes_l, 2)):
            CW, CH = (CLS_S, CLS_L)[cls]
            per_row = aw // (3 * CW)
            rows = np.zeros((CAP[cls], N_FIELDS), np.int32)
            rows[:, FI["flat0"]] = 3 * psz
            rows[:, FI["w"]] = rows[:, FI["h"]] = 4
            rows[:, FI["iioff"]] = -1
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
            n = len(modes)
            flags = F_II if n and (rows[:n, FI["iioff"]] >= 0).any() else 0
            rows[0, FI["wflags"]] = flags
            rows[0, FI["wcount"]] = n
            regions.append(rows)
            waves.append((rows, n, flags,
                          tuple(sorted(set(rows[:n, FI["modes"]].tolist())))))
        self.waves = [tuple(waves)]
        hdr = np.zeros(HDR_LEN, np.int32)
        words = [hdr]
        pos = HDR_LEN
        for i, rows in enumerate(regions):
            hdr[WAVE0 + 1 + i] = pos
            words.append(rows.reshape(-1))
            pos += rows.size
        hdr[WAVE0] = 1
        hdr[WAVE0 + 3] = pos
        words.append(masks)
        self.hdr = hdr
        self.dev = torch.from_numpy(np.concatenate(words))

    def kw(self):
        return dict(ah=self.ah, aw=self.aw, bpc=self.bpc,
                    ss_hor=self.ss_hor, ss_ver=self.ss_ver)

    def plain(self):
        return P.wave_plain(self.planes.clone(), self.ra, self.dev, self.hdr,
                            self.waves, **self.kw())

    def kernel(self, lib, reverse=0):
        return kernel_wave(lib, self.planes.clone(), self.ra, self.dev,
                           self.hdr, self.waves, reverse=reverse, **self.kw())


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


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("cls", [0, 1], ids=["S16", "L64"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_class_step(host_wave, mode, cls, bpc):
    n = 16 if cls == 0 else 8
    modes = [mode] * n
    level = Level(1000 * mode + 10 * bpc + cls, bpc,
                  modes if cls == 0 else [], modes if cls == 1 else [])
    calls = TW.calls
    want = level.plain()
    assert TW.calls == calls + 1
    got = level.kernel(host_wave)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want != level.planes).any()
    if mode in (Z1, Z2, Z3):
        ups, filt = _z_branches(level, cls)
        assert filt > 0 and (ups > 0 or cls == 1), (ups, filt)


def test_both_classes_in_one_launch_match_small_then_large(host_wave):
    """One level with 64 small-class and 16 large-class items of every
    mode: one launch (its blocks forwards, then backwards) equals
    class_step on the small class, then on the large."""
    rng = np.random.default_rng(77)
    level = Level(77, 10, [int(m) for m in rng.choice(MODES, 64)],
                  [int(m) for m in rng.choice(MODES, 16)])
    want = level.plain()
    for reverse in (0, 1):
        np.testing.assert_array_equal(
            level.kernel(host_wave, reverse).numpy(), want.numpy())


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

    def kernel(self, lib, reverse=0):
        return kernel_wave(lib, self.planes.clone(), self.ra, self.dev,
                           self.pk.hdr, self.pk.waves, reverse=reverse,
                           **self.kw)


@pytest.fixture(scope="module", params=sorted(FRAMES))
def frame(request):
    return Frame(request.param)


def test_frame_matches_wave_plain(host_wave, frame):
    want = frame.plain()
    for reverse in (0, 1):
        np.testing.assert_array_equal(
            frame.kernel(host_wave, reverse).numpy(), want.numpy())
    counts = [n for per in frame.pk.waves for _, n, _, _ in per]
    assert sum(counts) > 0 and (want != frame.planes).any()
    ii = sum(int((rows[:n, FI["iioff"]] >= 0).sum())
             for per in frame.pk.waves for rows, n, _, _ in per)
    assert ii > 0 or frame.name != "10bit-422-inter"


def test_frame_matches_jax_wave_prog(host_wave):
    """The 8-bit still against mega.wave_prog on the port's blob (word-
    identical to run2's, tests/test_torch_programs.py)."""
    frame = Frame("8bit-420-intra")
    kw = frame.kw
    want = JM.wave_prog(jnp.asarray(frame.planes.numpy()),
                        jnp.asarray(frame.ra.numpy()),
                        jnp.asarray(frame.dev.numpy()), **kw)
    got = frame.kernel(host_wave)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------ the wrapper ------------------------------


def test_cpu_wave_runs_the_plain_version(host_wave):
    """programs.wave on CPU tensors is wave_plain (class_step calls, no
    launch); the kernel's wrapper takes CUDA tensors only; the kernel's
    table layout is engine/consts.py's."""
    level = Level(5, 8, [0, Z1], [FILTER])
    launches, calls = cuda_wave.launches, TW.calls
    got = P.wave(level.planes.clone(), level.ra, level.dev, level.hdr,
                 level.waves, **level.kw())
    np.testing.assert_array_equal(got.numpy(), level.plain().numpy())
    assert cuda_wave.launches == launches and TW.calls == calls + 4
    pf = P.palette_pf(level.planes, level.dev, level.hdr)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wave.wave_levels(pf, level.ra, level.dev, level.hdr,
                              level.waves, aw=level.aw, psz=level.ah * level.aw,
                              bpc=8, ss_hor=1, ss_ver=1)
    assert cuda_wave.levels(level.waves) == [(0, 2, 1)]
    assert host_wave.rav1d_wave_table_len() == cuda_wave.table_numpy().size
