"""Whole decodes through rav1d_tpu_torch.Decoder on the CPU.

Seeded synthetic still pictures and inter sequences
(rav1d_tpu_torch/synth.py) at small sizes that are not multiples of 64
decode through the port's Decoder with device="cpu" (every program, with
the kernels' plain versions) to the same MD5 as the rav1d_tpu host path,
with every frame on the engine and no fallback. A key frame that uses
intra block copy goes to the host path, and the engine's inter frames then
predict from its uploaded planes. (The other bit depths, layouts and
superres: tests/test_torch_formats.py.) Where the dav1d test vectors
exist, two conformance streams are held to their meson MD5s and the first
frames of the bench's inter stream and of its 10-bit stream to the port's
host path; elsewhere those tests skip.
"""

import os

import pytest

import rav1d_tpu
import rav1d_tpu_torch as T
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import run

CASES = [(200, 120, 0), (200, 120, 1), (72, 136, 0), (72, 136, 2),
         (120, 72, 6), (136, 96, 10)]


def _host(packets):
    return synth.decode_md5s(
        rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False)), packets,
        eagain=rav1d_tpu.EAgain)


@pytest.mark.parametrize("w,h,seed", CASES)
def test_synthetic_matches_host_path(w, h, seed):
    packets = [synth.still_picture(w, h, seed)]
    want = _host(packets)
    before = dict(T.engine.stats)
    run.reset_stats()
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == want
    assert T.engine.stats["frames"] - before["frames"] == 1
    assert T.engine.stats["fallback"] == before["fallback"]
    assert set(run.stage_ms) >= {"pack", "upload", "resid", "wave", "filter",
                                 "fetch", "programs"}
    assert run.stage_ms["programs"] > 0


def test_one_decoder_many_pictures():
    """One Decoder, several pictures of different sizes: the reused upload
    staging buffer and the per-frame state carry nothing across frames."""
    packets = [synth.still_picture(136, 96, 10), synth.still_picture(200, 120, 0),
               synth.still_picture(136, 96, 6)]
    want = _host(packets)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == want and len(got) == 3


@pytest.mark.parametrize("seed", [1, 6])
def test_synthetic_frame_exercises_the_slice(seed):
    """A synthetic picture carries every intra tool of the slice: palette,
    filter intra, directional and CfL modes, all LR kinds, 32/64-point
    transforms, and blocks of every size up to 16x16."""
    from rav1d_tpu_torch.engine.layout import SIZES

    (fp,) = synth.capture_frames([synth.still_picture(512, 256, seed)])
    ft = synth.features(*fp)
    for k in ("palette", "filter", "directional", "cfl", "tx32_64_chunks"):
        assert ft[k] > 0, (k, ft)
    assert ft["lr_chunks"]["wiener"] > 0, ft
    assert ft["lr_chunks"]["sgr5x5"] + ft["lr_chunks"]["sgrmix"] > 0, ft
    assert ft["lr_chunks"]["sgr3x3"] + ft["lr_chunks"]["sgrmix"] > 0, ft
    small = {"%dx%d" % (w, h) for w, h in SIZES if max(w, h) <= 16}
    assert small <= set(ft["tx_lanes"]), ft


INTER_CASES = [(200, 120, 1), (136, 96, 2), (72, 136, 3)]


@pytest.mark.parametrize("w,h,seed", INTER_CASES)
def test_inter_sequence_matches_host_path(w, h, seed):
    """A key frame and two inter frames (every inter tool of 4:2:0) on the
    engine, frame by frame equal to the host path, references from the
    engine's own device planes only."""
    packets = synth.inter_sequence(w, h, seed)
    want = _host(packets)
    assert len(want) == 3
    before = dict(T.engine.stats)
    run.reset_stats()
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == want
    assert T.engine.stats["frames"] - before["frames"] == 3
    assert T.engine.stats["fallback"] == before["fallback"]
    assert T.engine.stats["ref_uploads"] == before["ref_uploads"]
    assert run.stage_ms["inter"] > 0


def test_key_then_inter_matches_host_path():
    packets = synth.key_then_inter(96, 64, 1)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == _host(packets)


def test_host_path_frame_feeds_engine_frames():
    """Seed 1's key frame uses intra block copy, so it decodes on the host
    path (a counted fallback); the two inter frames run on the engine and
    read its host planes, uploaded once each."""
    packets = synth.inter_sequence(192, 128, 1, intrabc=True)
    want = _host(packets)
    before = dict(T.engine.stats)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets)
    assert got == want and len(got) == 3
    assert T.engine.stats["frames"] - before["frames"] == 3
    assert T.engine.stats["fallback"] - before["fallback"] == 1
    assert T.engine.stats["ref_uploads"] - before["ref_uploads"] == 3


VECTORS = [
    ("8-bit/issues/324_tennis.ivf", "53a0ba36b3a3656e6a12efb358d71f9e"),
    ("8-bit/issues/320_tennis.ivf", "86e9c91b80bb738693c3781e728fd7f5"),
]


def _data_dir():
    # $RAV1D_TEST_DATA, or the directory tests/conftest.py names
    from conftest import TEST_DATA

    for d in (os.environ.get("RAV1D_TEST_DATA"), TEST_DATA):
        if d and os.path.isdir(d):
            return d
    return None


@pytest.mark.parametrize("rel,md5", VECTORS, ids=["324_tennis", "320_tennis"])
def test_conformance_vectors(rel, md5):
    d = _data_dir()
    if d is None or not os.path.exists(os.path.join(d, rel)):
        pytest.skip("dav1d-test-data not present")
    import hashlib

    from rav1d_tpu_torch.io.ivf import IvfDemuxer

    dec = T.Decoder(T.Settings(apply_grain=False), device="cpu")
    m = hashlib.md5()
    for pkt in IvfDemuxer(os.path.join(d, rel)):
        dec.send_data(pkt.data, pkt.timestamp)
        while True:
            try:
                pic = dec.get_picture()
            except T.EAgain:
                break
            for rows in pic.iter_plane_rows():
                m.update(rows)
    assert m.hexdigest() == md5


BENCH_STREAM = "8-bit/data/00000627.ivf"  # bench.py's primary stream
BENCH_FRAMES = 8
# bench.py's 1080p_10bit stream, where the JAX engine differs from its own
# host path on frame 1 (CONFORMANCE.md)
TEN_BIT_STREAM = "10-bit/issues/318_tx_4x4.ivf"


def _first_frames_match_host_path(rel, n):
    """The first n pictures of a vector on the engine equal the port's
    host path, every frame on the engine."""
    d = _data_dir()
    if d is None or not os.path.exists(os.path.join(d, rel)):
        pytest.skip("dav1d-test-data not present")
    from rav1d_tpu_torch.io.ivf import IvfDemuxer

    packets = [pkt.data for pkt in IvfDemuxer(os.path.join(d, rel))]
    want, packets_used = [], []
    host = T.Decoder(T.Settings(apply_grain=False), host_path=True)
    for data in packets:
        if len(want) >= n:
            break
        packets_used.append(data)
        want += synth.decode_md5s(host, [data])
    before = dict(T.engine.stats)
    got = synth.decode_md5s(
        T.Decoder(T.Settings(apply_grain=False), device="cpu"), packets_used)
    assert got == want and len(got) >= n
    assert T.engine.stats["frames"] > before["frames"]
    assert T.engine.stats["fallback"] == before["fallback"]


def test_bench_stream_first_frames():
    _first_frames_match_host_path(BENCH_STREAM, BENCH_FRAMES)


def test_ten_bit_stream_first_frames():
    _first_frames_match_host_path(TEN_BIT_STREAM, 2)
