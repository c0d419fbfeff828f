"""Whole decodes of every bit depth, chroma layout and superres through
rav1d_tpu_torch.Decoder on the CPU.

Seeded synthetic streams (rav1d_tpu_torch/synth.py) decode through the
port's Decoder with device="cpu" (every program, with the kernels' plain
versions) to the MD5s of the port's own host path (Decoder(host_path=
True)), frame by frame:

- still pictures at 8, 10 and 12 bits in 4:0:0, 4:2:0, 4:2:2 and 4:4:4;
- inter sequences (a key frame and two inter frames with every inter tool
  of the layout) at 10-bit 4:2:0, 12-bit 4:2:0, 10-bit 4:2:2, 10-bit 4:4:4
  and 10-bit 4:0:0;
- a superres still picture, and a superres inter sequence whose fourth
  frame reads scaled references: the planner's counted host fallback, the
  only one.

Every other frame runs on the engine. Tolerance: exact.
"""

import pytest

import rav1d_tpu_torch as T
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import run
from rav1d_tpu_torch.headers import PixelLayout as PL


def _host(packets):
    return synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), host_path=True), packets)


def _engine(packets):
    """Per frame: (MD5 on the engine, frames the engine handed to the
    host path while decoding it)."""
    dec = T.Decoder(T.Settings(apply_grain=False), device="cpu")
    out = []
    for data in packets:
        fb = T.engine.stats["fallback"]
        md5 = synth.decode_md5s(dec, [data])
        out += [(m, T.engine.stats["fallback"] - fb) for m in md5]
    return out


STILLS = [(bpc, layout) for bpc in (8, 10, 12) for layout in PL]


@pytest.mark.parametrize("bpc,layout", STILLS,
                         ids=["%dbit-%s" % (b, l.name) for b, l in STILLS])
def test_still_picture_matches_host_path(bpc, layout):
    packets = [synth.still_picture(120, 72, bpc + int(layout), bpc=bpc,
                                   layout=layout)]
    want = _host(packets)
    run.reset_stats()
    got = _engine(packets)
    assert got == [(want[0], 0)]
    assert run.stage_ms["programs"] > 0


INTERS = [(10, PL.I420), (12, PL.I420), (10, PL.I422), (10, PL.I444),
          (10, PL.I400)]


@pytest.mark.parametrize("bpc,layout", INTERS,
                         ids=["%dbit-%s" % (b, l.name) for b, l in INTERS])
def test_inter_sequence_matches_host_path(bpc, layout):
    """Key + two inter frames on the engine, references from the engine's
    own device planes only."""
    packets = synth.inter_sequence(136, 96, 2, bpc=bpc, layout=layout)
    want = _host(packets)
    assert len(want) == 3
    uploads = T.engine.stats["ref_uploads"]
    run.reset_stats()
    got = _engine(packets)
    assert got == [(m, 0) for m in want]
    assert T.engine.stats["ref_uploads"] == uploads
    assert run.stage_ms["inter"] > 0


def test_superres_still_picture_matches_host_path():
    packets = [synth.still_picture(136, 96, 3, superres=True)]
    (f, _), = synth.capture_frames(packets)
    assert f.cur.w < f.sr_cur.w == 136  # coded at 8/9 of the width
    assert _engine(packets) == [(_host(packets)[0], 0)]


def test_superres_inter_sequence_matches_host_path():
    """The superres key frame and the two inter frames at full width run
    on the engine; the fourth frame, coded with superres, reads scaled
    references, and is the one frame the planner sends to the host path."""
    packets = synth.inter_sequence(136, 96, 2, superres=True)
    want = _host(packets)
    assert len(want) == 4
    got = _engine(packets)
    assert got == [(want[0], 0), (want[1], 0), (want[2], 0), (want[3], 1)]
