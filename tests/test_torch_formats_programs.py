"""The port's four programs against the JAX engine's at other bit depths,
layouts and with superres.

Four frames, one per combination that only these formats reach:

- 10-bit 4:2:2 inter (synth.inter_sequence frame 1): the segy10 compound
  masks, and the 10-bit prep bias and intermediate bits;
- 8-bit 4:4:4 inter (frame 2): the segy00 compound masks;
- 12-bit 4:0:0 intra (synth.still_picture): no chroma planes, the 12-bit
  transform clips, the 16-bit packed output;
- 8-bit 4:2:0 superres key frame: the upscale of the planes and of the
  post-deblock snapshot, and LR over the upscaled rows.

Each package decodes the same bytes through its own front end and packs
its own blob; the two blobs must be word-identical. Then resid, inter,
wave and filter_ of engine/programs.py must equal mega.resid_prog,
inter_prog, wave_prog and filter_prog, each port program on the JAX
program's own input, so a mismatch names its program. Tolerance: exact.
This file runs the two inter frames, test_torch_formats_programs_intra.py
the other two.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.engine import mega as JM
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.engine.run import stack_planes
from rav1d_tpu_torch.headers import PixelLayout as PL
from test_torch_pack import ref_capture, run2_pack, run2_words

W, H = 256, 192
# name: (packets, index of the frame compared)
COMBOS = {
    "10bit-422-inter": (lambda: synth.inter_sequence(W, H, 1, bpc=10,
                                                     layout=PL.I422), 1),
    "8bit-444-inter": (lambda: synth.inter_sequence(W, H, 1,
                                                    layout=PL.I444), 2),
    "12bit-400-intra": (lambda: [synth.still_picture(136, 96, 5, bpc=12,
                                                     layout=PL.I400)], 0),
    "8bit-420-superres": (lambda: [synth.still_picture(136, 96, 10,
                                                       superres=True)], 0),
}


def _jax_stack(srcs, pad_to, first=None):
    """run2._stack over the reference pictures' host planes, padded to
    pad_to rows with copies of the first (`first` where there are none:
    run2.execute then passes the luma stack's first row)."""
    rows = [np.asarray((pic.y, pic.u, pic.v)[pl]) for pic, pl in srcs]
    if not rows:
        return first
    rows += [rows[0]] * (pad_to - len(rows))
    return jnp.asarray(np.stack(rows[:pad_to]))


class Frame:
    """Both packages' view of one frame, and the statics of its programs."""

    def __init__(self, name):
        packets, i = COMBOS[name]
        packets = packets()
        (self.f, self.plan) = synth.capture_frames(packets)[i]
        rf, rplan = ref_capture(packets)[i]
        f, plan = self.f, self.plan
        self.pk = pack_frame(f, plan)
        self.ah, self.aw = plan.ah, plan.aw
        self.bpc = f.cur.bpc
        self.dev, cap = Uploader("cpu").upload(self.pk, self.ah * self.aw,
                                               self.bpc)
        hdr, blob, lr_ws, self.rsrcs = run2_pack(rf, rplan)
        words = run2_words(hdr, blob)
        np.testing.assert_array_equal(self.pk.words(), words)
        assert self.pk.lr_ws == lr_ws
        ref = np.zeros(cap, np.int32)
        ref[: words.size] = words
        self.devj = jnp.asarray(ref)
        layout = f.cur.layout
        self.layout = int(layout)
        self.ss_hor = 0 if layout == PL.I444 else 1
        self.ss_ver = 1 if layout == PL.I420 else 0
        out = f.sr_cur
        ach, acw = out.u.shape if out.u is not None else (0, 0)
        self.geom = (self.ah, self.aw, ach, acw, f.bh, f.bw, f.cur.h)
        self.sr_geom = None
        if self.pk.need_sr:
            self.sr_geom = out.y.shape + (out.w, out.h, 4 * f.bw)
        self.inter = dict(ah=self.ah, aw=self.aw, bpc=self.bpc, vwY=f.cur.w,
                          vhY=f.cur.h,
                          vwC=(f.cur.w + self.ss_hor) >> self.ss_hor,
                          vhC=(f.cur.h + self.ss_ver) >> self.ss_ver)

    def resid_jax(self):
        return JM.resid_prog(self.devj, ah=self.ah, aw=self.aw, bpc=self.bpc)

    def inter_jax(self, ra_j, planes_j):
        sY = _jax_stack(self.rsrcs[0], 8)
        sC = _jax_stack(self.rsrcs[1], 16, first=sY[:1])
        return JM.inter_prog(planes_j, ra_j, self.devj, sY, sC, **self.inter)

    def wave_input(self):
        """(ra, planes) of JAX's resid and, on an inter frame, its inter
        program: the input of both wave programs."""
        ra_j, planes_j = self.resid_jax()
        if self.pk.srcs is not None:
            planes_j = self.inter_jax(ra_j, planes_j)
        return ra_j, np.array(planes_j)

    def wave_jax(self, ra_j, pre):
        return JM.wave_prog(jnp.asarray(pre), ra_j, self.devj, ah=self.ah,
                            aw=self.aw, bpc=self.bpc, ss_hor=self.ss_hor,
                            ss_ver=self.ss_ver)

    def check_blob(self):
        n = self.pk.blob.pos
        np.testing.assert_array_equal(self.dev.numpy()[:n],
                                      np.asarray(self.devj)[:n])
        assert (self.pk.srcs is None) == (self.plan.inter is None)

    def check_resid(self):
        ra_j, planes_j = self.resid_jax()
        ra, planes = P.resid(self.dev, self.pk.hdr, self.pk.tx_valid,
                             ah=self.ah, aw=self.aw, bpc=self.bpc)
        np.testing.assert_array_equal(ra.numpy(), np.asarray(ra_j))
        np.testing.assert_array_equal(planes.numpy(), np.asarray(planes_j))
        assert np.asarray(ra_j).any()

    def check_inter(self):
        if self.pk.srcs is None:
            assert self.plan.inter is None
            return
        ra_j, planes_j = self.resid_jax()
        want = np.asarray(self.inter_jax(ra_j, planes_j))
        zeros = torch.zeros((3, self.ah, self.aw), dtype=torch.int32)
        srcsY, srcsC = self.pk.srcs
        got = P.inter(zeros, torch.from_numpy(np.array(ra_j)), self.dev,
                      self.pk.hdr, self.pk.inter_runs,
                      stack_planes(srcsY, "cpu", (self.ah, self.aw)),
                      stack_planes(srcsC, "cpu", self.geom[2:4]),
                      **self.inter)
        np.testing.assert_array_equal(got.numpy(), want)
        assert want.any()

    def check_wave(self):
        ra_j, pre = self.wave_input()
        want = self.wave_jax(ra_j, pre.copy())
        got = P.wave(torch.from_numpy(pre.copy()),
                     torch.from_numpy(np.array(ra_j)), self.dev, self.pk.hdr,
                     self.pk.waves, ah=self.ah, aw=self.aw, bpc=self.bpc,
                     ss_hor=self.ss_hor, ss_ver=self.ss_ver)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def check_filter(self):
        ra_j, pre = self.wave_input()
        pre = np.array(self.wave_jax(ra_j, pre))
        planes_j, packed_j = JM.filter_prog(
            jnp.asarray(pre), self.devj, geom=self.geom, bpc=self.bpc,
            layout_i=self.layout, need_sr=self.sr_geom is not None,
            sr_geom=self.sr_geom, lr_ws=self.pk.lr_ws)
        planes, packed = P.filter_(torch.from_numpy(pre.copy()), self.dev,
                                   self.pk.hdr, geom=self.geom, bpc=self.bpc,
                                   layout_i=self.layout, lr_ws=self.pk.lr_ws,
                                   sr_geom=self.sr_geom)
        packed = packed.numpy()
        if self.bpc > 8:
            assert packed.dtype == np.int16
            packed = packed.view(np.uint16)
        np.testing.assert_array_equal(packed, np.asarray(packed_j))
        np.testing.assert_array_equal(planes.numpy(),
                                      np.asarray(planes_j).astype(np.int32))


_FRAMES = {}


def frame_of(name):
    """The Frame of a combination, made once per process."""
    if name not in _FRAMES:
        _FRAMES[name] = Frame(name)
    return _FRAMES[name]


# the inter combinations here, the intra ones in
# test_torch_formats_programs_intra.py: each file compiles its own JAX
# programs, and pytest-xdist's --dist loadfile runs the files in parallel
@pytest.fixture(scope="module", params=["10bit-422-inter", "8bit-444-inter"])
def frame(request):
    return frame_of(request.param)


def test_blob_matches_run2(frame):
    frame.check_blob()


def test_resid(frame):
    frame.check_resid()


def test_inter(frame):
    frame.check_inter()


def test_wave(frame):
    frame.check_wave()


def test_filter(frame):
    frame.check_filter()


def test_compound_mask_slots_carry_tiles():
    """segy10 (4:2:2) and segy00 (4:4:4) carry tiles in the compared
    frames, beside their chroma twin seguv."""
    for name, slot in (("10bit-422-inter", "segy10"),
                       ("8bit-444-inter", "segy00")):
        packets, i = COMBOS[name]
        tiles = synth.features(*synth.capture_frames(packets())[i])[
            "inter_tiles"]
        assert tiles[slot] > 0 and tiles["seguv"] > 0, (name, tiles)
        assert tiles["segy11"] == 0, (name, tiles)
