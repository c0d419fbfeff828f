"""rav1d_tpu_torch at 2160p widths on the CPU, exactly.

The card decodes 3840x2160 streams (chip_smoke.py uhd_phase); here the
same 3840 columns run as full-width strips, small enough for the plain
versions:

- whole decodes through Decoder(device="cpu") (every program through its
  plain version) equal to the port's host path and to rav1d_tpu's host
  path, every frame on the engine and no host reference upload: a
  3840x64 10-bit 4:2:0 still (the format of the JAX bench's
  4k_10bit_intra) and a 3840x128 key frame and two inter frames in four
  tile columns (tile columns 960 pixels wide, as a 2160p encoder splits
  them);
- the g++ host builds of csrc/lf.cu, cdef.cu, lr.cu (through
  engine/programs.py filter_kernels, with the launches it makes, and the
  deblock kernel also with groups of 8 lines: 960 luma map columns a row)
  and of csrc/wave.cu's frame entry against their plain versions on each
  strip frame packed by the port;
- the wrappers' argument builders at the 3840x2160 geometry itself, on
  meta tensors (no frame is allocated): rav1d_deblock's groups and shared
  words in each direction and layout against lf.cu's formulas and the
  card's 232,448 bytes a block, and the blob's capacity (2^26 words at 8
  bits, 2^27 above) with every int16 and byte lane index inside int32;
- synth.capture_frames on the engine (how chip_smoke.py captures the
  2160p streams on the card) against the host capture: the same MD5s and,
  frame by frame, the same blob words.

Inputs are seeded with numpy. Tolerance: exact.
"""

import functools

import numpy as np
import pytest
import torch

import rav1d_tpu
from rav1d_tpu.engine import run2
import rav1d_tpu_torch as T
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader, bucket_pow2, det_cap_words
from rav1d_tpu_torch.engine.layout import DB0, HDR_LEN
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.engine.run import stack_planes
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops.cuda import filters as FK
from rav1d_tpu_torch.ops.cuda import wave as cuda_wave
from test_torch_filter_kernels import host_kernels
from test_torch_wave_kernel import host_wave, kernel_wave  # noqa: F401

UHD_W, UHD_H = 3840, 2160
STRIPS = {
    "still-10bit-3840x64": lambda: [synth.still_picture(UHD_W, 64, 1,
                                                        bpc=10)],
    "inter-tiles4-3840x128": lambda: synth.inter_sequence(
        UHD_W, 128, 3, tools=synth.Tools(tiles=(2, 0))),
}
# (strip, frame) of each engine frame the host builds run on
STRIP_FRAMES = [("still-10bit-3840x64", 0), ("inter-tiles4-3840x128", 0),
                ("inter-tiles4-3840x128", 1), ("inter-tiles4-3840x128", 2)]


@functools.lru_cache(maxsize=None)
def packets_of(name):
    return STRIPS[name]()


@functools.lru_cache(maxsize=None)
def captured(name):
    return synth.capture_frames(packets_of(name))


@pytest.mark.parametrize("name", sorted(STRIPS))
def test_strip_decodes_on_the_engine(name):
    packets = packets_of(name)
    ref = synth.decode_md5s(
        rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False, n_threads=1)),
        packets, eagain=rav1d_tpu.EAgain)
    host = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), packets)
    before = dict(T.engine.stats)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == host == ref and len(got) == len(packets)
    # every strip starts with its one key frame, planned natively
    assert {k: T.engine.stats[k] - before[k] for k in before} == dict(
        frames=len(packets), fallback=0, ref_uploads=0, plan_native=1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return host_kernels(str(tmp_path_factory.mktemp("uhd_filters")))


class StripFrame:
    """Frame i of strip `name` packed by the port: its blob, the wave
    program's input (zero planes, or the plain inter program's planes),
    the filter program's input `planes` (the plain wave program's output)
    and the filter program's statics, as the filter kernels' tests make
    them (test_torch_filter_kernels.py Frame)."""

    def __init__(self, name, i):
        f, plan = captured(name)[i]
        pk = self.pk = pack_frame(f, plan)
        ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
        self.dev, _ = Uploader("cpu").upload(pk, ah * aw, bpc)
        out = f.sr_cur
        ach, acw = out.u.shape
        self.ra, planes = P.resid_plain(self.dev, pk.hdr, pk.tx_valid, ah=ah,
                                        aw=aw, bpc=bpc)
        if pk.srcs is not None:
            planes = P.inter(planes, self.ra, self.dev, pk.hdr, pk.inter_runs,
                             stack_planes(pk.srcs[0], "cpu", (ah, aw)),
                             stack_planes(pk.srcs[1], "cpu", (ach, acw)),
                             ah=ah, aw=aw, bpc=bpc, vwY=f.cur.w, vhY=f.cur.h,
                             vwC=(f.cur.w + 1) >> 1, vhC=(f.cur.h + 1) >> 1)
        self.wave_in = planes
        self.wave_kw = dict(ah=ah, aw=aw, bpc=bpc, ss_hor=1, ss_ver=1)
        self.planes = P.wave_plain(planes.clone(), self.ra, self.dev, pk.hdr,
                                   pk.waves, **self.wave_kw)
        self.layout, self.bpc = int(f.cur.layout), bpc
        self.kw = dict(geom=(ah, aw, ach, acw, f.bh, f.bw, f.cur.h), bpc=bpc,
                       layout_i=self.layout, lr_ws=pk.lr_ws, sr_geom=None)

    def plain(self):
        return P.filter_plain(self.planes.clone(), self.dev, self.pk.hdr,
                              **self.kw)


@functools.lru_cache(maxsize=None)
def strip_frame(name, i):
    return StripFrame(name, i)


@pytest.mark.parametrize("name,i", STRIP_FRAMES)
def test_strip_filters_match_plain(host, name, i):
    frame = strip_frame(name, i)
    _, _, _, _, bh, bw, _ = frame.kw["geom"]
    a = FK.deblock_args(frame.planes, frame.dev, frame.pk.hdr, False,
                        group=8, bh=bh, bw=bw, layout_i=frame.layout,
                        bpc=frame.bpc)
    assert (a.group, a.maxnw, a.nw4[0]) == (8, UHD_W // 4, UHD_W // 4)
    planes, packed = frame.plain()
    for k in (host, host.of("new", group=8)):
        n0 = dict(k.n)
        got, got_packed = P.filter_kernels(frame.planes.clone(), frame.dev,
                                           frame.pk.hdr, k=k, **frame.kw)
        np.testing.assert_array_equal(got.numpy(), planes.numpy())
        np.testing.assert_array_equal(got_packed.numpy(), packed.numpy())
        w, s = FK.lr_launches(frame.pk.hdr, frame.layout)
        assert {key: k.n[key] - n0[key] for key in n0} == dict(
            lf=2, cdef=1, sr=0, wiener=w, sgr=s, wiener_plane=0,
            sgr_plane=0)
        assert w and s


@pytest.mark.parametrize("name,i", STRIP_FRAMES)
def test_strip_wave_frame_entry_matches_plain(host_wave, name, i):
    frame = strip_frame(name, i)
    pk = frame.pk
    got = kernel_wave(host_wave, frame.wave_in.clone(), frame.ra, frame.dev,
                      pk.hdr, pk.waves, entry="frame", **frame.wave_kw)
    np.testing.assert_array_equal(got.numpy(), frame.planes.numpy())
    assert cuda_wave.grid(pk.waves) > 0
    assert (frame.planes != frame.wave_in).any()


# ------------------------ the 3840x2160 geometry ------------------------

UHD_AH = 2176  # the planner's rows at 2160 (a multiple of 128)
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100


def _deblock_hdr(maps):
    """A header whose deblock region names the E/I luts and the six maps
    of `maps` ((nh4, nw4) of passes 0-5) one after another; the words the
    region takes."""
    hdr = np.zeros(HDR_LEN, np.int32)
    hdr[DB0] = HDR_LEN
    end = HDR_LEN + 128
    for i, (nh4, nw4) in enumerate(maps):
        hdr[DB0 + 1 + i] = end
        end += (nh4 * nw4 + 3) // 4
    return hdr, end


@pytest.mark.parametrize("hor", [False, True], ids=["vertical", "horizontal"])
@pytest.mark.parametrize("layout", [PL.I400, PL.I420, PL.I422, PL.I444],
                         ids=lambda v: v.name)
def test_deblock_groups_at_2160p(layout, hor):
    """rav1d_deblock's arguments for a 3840x2160 frame: the default group
    (4 rows, one map row; 8 columns, a band, for horizontal edges) and the
    group of 8 on either direction fit a block's shared memory by lf.cu's
    lfg_smem_words, the pitch is lf.cu's, and the groups cover every line
    of every plane that has map cells once."""
    bh, bw = UHD_H // 4, UHD_W // 4
    ss_hor, ss_ver = FK.subsampling(int(layout))
    ch4, cw4 = (bh + ss_ver) >> ss_ver, (bw + ss_hor) >> ss_hor
    shapes = [(bh, bw), (ch4, cw4), (ch4, cw4)]
    hdr, end = _deblock_hdr(shapes + [(w, h) for h, w in shapes])
    planes = torch.empty((3, UHD_AH, UHD_W), dtype=torch.int32, device="meta")
    dev = torch.empty(bucket_pow2(end), dtype=torch.int32, device="meta")
    np_ = 1 if layout == PL.I400 else 3
    nw4 = [(h if hor else w) for h, w in shapes][:np_]
    nh4 = [(w if hor else h) for h, w in shapes][:np_]
    ln, lines = (UHD_AH, UHD_W) if hor else (UHD_W, UHD_AH)
    assert max(nw4) == (bh if hor else bw)
    for group in (None, 8):
        a = FK.deblock_args(planes, dev, hdr, hor, bh=bh, bw=bw,
                            layout_i=int(layout), bpc=10, group=group)
        g = group or (8 if hor else 4)
        maxnw = max(nw4)
        assert (a.group, a.maxnw, a.nplanes) == (g, maxnw, np_)
        assert a.pitch % 64 == 8 and 4 * maxnw + 12 <= a.pitch < 4 * maxnw + 76
        cells = max(g // 4, 1) * maxnw
        words = (g * a.pitch + 12 + 128 + (cells + 3) // 4
                 + 3 * ((cells + 1) // 2))
        assert words * 4 <= SMEM_MAX
        first = 0
        for p in range(np_):
            nl = min(4 * nh4[p], lines)
            assert (a.nh4[p], a.nw4[p], a.nlines[p]) == (nh4[p], nw4[p], nl)
            assert a.ext[p] == min(ln, 4 * nw4[p] + 4)
            assert a.first[p] == first
            first += -(-nl // g)
        assert a.first[np_] == first


@pytest.mark.parametrize("bpc,log2", [(8, 26), (10, 27), (12, 27)])
def test_blob_capacity_at_2160p(bpc, log2):
    """The device blob of a 3840x2160 frame: the JAX engine's capacity
    (run2.det_cap_words), 2^26 words at 8 bits and 2^27 above, whose
    largest int16 lane index (2 words' lanes a word) and byte lane index
    (4 a word) stay inside int32, as the kernels index them."""
    psz = UHD_AH * UHD_W
    cap = det_cap_words(psz, bpc)
    assert cap == run2.det_cap_words(psz, bpc) == 1 << log2
    assert bucket_pow2(cap) == cap and 4 * cap - 1 < 2**31


def test_engine_capture_matches_host_capture():
    """synth.capture_frames on the engine (chip_smoke.py's 2160p phase
    captures so, on the card) gives the host capture's MD5s and, frame by
    frame, plans that pack to the same blob words, with every frame on
    the engine."""
    packets = synth.inter_sequence(200, 120, 1, tools=synth.Tools(
        tiles=(1, 0)))
    host_md5, card_md5 = [], []
    host = synth.capture_frames(packets, host_md5)
    before = dict(T.engine.stats)
    engine = synth.capture_frames(packets, card_md5, device="cpu")
    assert card_md5 == host_md5 and len(engine) == len(host) == 3
    # the capture materializes every frame's work items before it plans,
    # so the Python planner plans the key frame too
    assert {k: T.engine.stats[k] - before[k] for k in before} == dict(
        frames=3, fallback=0, ref_uploads=0, plan_native=0)
    for (f, plan), (g, gplan) in zip(host, engine):
        a, b = pack_frame(f, plan), pack_frame(g, gplan)
        np.testing.assert_array_equal(a.words(), b.words())
        assert a.inter_runs.keys() == b.inter_runs.keys()
