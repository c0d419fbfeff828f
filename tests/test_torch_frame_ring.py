"""rav1d_tpu_torch's frame ring on the CPU: the dense pass on a one-thread
FIFO worker (Settings.max_frame_delay), the engine's delayed-output ring
with dav1d's drain handshake, the fetch pool, and the first-failure-once
error contract.

The port at delays 2, 3 and 8 must give delay 1's MD5s, in order, and the
port's host path's, on an inter sequence, a 10-bit sequence with 2x2
tiles and an intrabc sequence (whose key frame falls back to the host
path inside the ring); its host-path ring must match rav1d_tpu's numpy
ring event for event. Geometries are those the port's other files
decode (136x96, 192x128, 200x120); no JAX program is compiled here.
"""

import sys
import threading

import pytest
import torch

import rav1d_tpu
import rav1d_tpu_torch as T
from rav1d_tpu_torch import cli, synth
from rav1d_tpu_torch.engine import run
from rav1d_tpu_torch.engine.blob import FetchPool
from rav1d_tpu_torch.synth import Tools

STREAMS = {
    "inter": lambda: synth.inter_sequence(136, 96, 2),
    "tiles-10bit": lambda: synth.inter_sequence(200, 120, 4, bpc=10,
                                                tools=Tools(tiles=(1, 1))),
    "intrabc": lambda: synth.inter_sequence(192, 128, 1, intrabc=True),
}
_CACHE = {}


def packets_of(name):
    if name not in _CACHE:
        _CACHE[name] = STREAMS[name]()
    return _CACHE[name]


def host_md5s(packets):
    """The port's host path (delay 1), which every delay must equal."""
    key = tuple(packets)
    if key not in _CACHE:
        _CACHE[key] = synth.decode_md5s(
            T.Decoder(T.Settings(apply_grain=False), host_path=True),
            packets)
    return _CACHE[key]


def settings(d):
    return T.Settings(apply_grain=False, max_frame_delay=d)


def engine_run(packets, d):
    """MD5s of a CPU-engine decode at delay d, and what it added to
    engine.stats."""
    before = dict(T.engine.stats)
    dec = T.Decoder(settings(d), device="cpu")
    got = synth.decode_md5s(dec, packets)
    dec.close()
    return got, {k: T.engine.stats[k] - before[k] for k in before}


def events(dec, packets, eagain):
    """What a dav1d-style caller sees: per packet, send_data and one
    get_picture (a picture's MD5 or "EAgain"); then the drain handshake,
    get_picture until two calls in a row raise."""
    out = []

    def get():
        try:
            out.append(synth.picture_md5(dec.get_picture()))
            return True
        except eagain:
            out.append("EAgain")
            return False

    for data in packets:
        dec.send_data(data)
        get()
    misses = 0
    while misses < 2:
        misses = 0 if get() else misses + 1
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_delays_match_delay_one_and_the_host_path(name):
    packets = packets_of(name)
    want, stats = engine_run(packets, 1)
    assert want == host_md5s(packets) and len(want) == len(packets)
    assert stats["frames"] == len(packets)
    assert stats["fallback"] == (name == "intrabc")
    assert stats["ref_uploads"] == (3 if name == "intrabc" else 0)
    for d in (2, 3, 8):
        got, st = engine_run(packets, d)
        assert got == want, d
        assert st == stats, d


@pytest.mark.parametrize("d", [2, 3])
def test_host_path_ring_matches_the_reference_ring(d):
    """Both packages' numpy rings at delay d: the same events over the
    same packets (the key frame twice, so the second run starts from a
    key frame in the middle of the ring)."""
    packets = packets_of("inter") * 2
    ref = events(rav1d_tpu.Decoder(rav1d_tpu.Settings(
        apply_grain=False, max_frame_delay=d, n_threads=1)), packets,
        rav1d_tpu.EAgain)
    port = events(T.Decoder(settings(d), host_path=True), packets, T.EAgain)
    assert port == ref
    assert sum(e != "EAgain" for e in port) == len(packets)


@pytest.mark.parametrize("d", [2, 3])
def test_output_ring_delays_by_d_and_drains_in_order(d):
    """On the engine the first picture leaves after d + 1 send_data
    calls (one get_picture after each); the drain handshake gives the
    rest, in order."""
    packets = packets_of("inter") * 2
    want = host_md5s(packets)
    ev = events(T.Decoder(settings(d), device="cpu"), packets, T.EAgain)
    n = len(packets)
    lag = d
    assert ev[:lag] == ["EAgain"] * lag
    assert ev[lag:n] == want[: n - lag]
    assert ev[n:] == want[n - lag:] + ["EAgain", "EAgain"]


def test_a_failed_dense_pass_raises_once_then_flush_recovers(monkeypatch):
    """A dense pass that fails on the worker (frame 1) raises DecodeError
    exactly once, no later than the call that would hand out picture 1,
    with no fallback counted, and picture 1 is never handed out; after
    flush() the stream decodes from its key frame to delay 1's MD5s."""
    packets = packets_of("inter")
    want = host_md5s(packets)
    real = T.engine.run_dense
    calls = []

    def failing(t, f, up):
        calls.append(f.frame_hdr.frame_offset)
        if len(calls) == 2:
            raise RuntimeError("injected dense-pass failure")
        return real(t, f, up)

    monkeypatch.setattr(T.engine, "run_dense", failing)
    before = dict(T.engine.stats)
    dec = T.Decoder(settings(2), device="cpu")
    seen = []  # pictures and errors in order
    for data in packets:
        while True:  # a send_data that raises has not taken the data
            try:
                dec.send_data(data)
                break
            except T.DecodeError:
                seen.append("error")
        try:
            seen.append(synth.picture_md5(dec.get_picture()))
        except T.EAgain:
            pass
        except T.DecodeError:
            seen.append("error")
    for _ in range(4):
        try:
            seen.append(synth.picture_md5(dec.get_picture()))
        except T.EAgain:
            pass
        except T.DecodeError:
            seen.append("error")
    assert seen.count("error") == 1
    assert seen.index("error") <= 1  # at most picture 0 before it
    pictures = [s for s in seen if s != "error"]
    assert len(pictures) == 2 and pictures[0] == want[0]  # 1 is dropped
    assert T.engine.stats["fallback"] == before["fallback"]
    monkeypatch.setattr(T.engine, "run_dense", real)
    dec.flush()
    assert synth.decode_md5s(dec, packets) == want
    dec.close()


def test_flush_mid_ring_waits_and_leaves_the_decoder_usable():
    """After rav1d_tpu's test_flush_waits_ring: three frames sent at delay
    4, then flush(), which must return (no deadlock); a decode from the
    key frame then equals delay 1."""
    packets = packets_of("inter") * 2
    want = host_md5s(packets)
    dec = T.Decoder(settings(4), device="cpu")
    for data in packets[:3]:
        dec.send_data(data)
        with pytest.raises(T.EAgain):
            dec.get_picture()
    done = threading.Thread(target=dec.flush)
    done.start()
    done.join(timeout=120)
    assert not done.is_alive()
    assert dec._dense_exec is None and not dec._out_fifo
    assert not dec.uploader.fetches.pending
    assert synth.decode_md5s(dec, packets) == want
    dec.close()


def test_ring_under_fast_thread_switching():
    """The worker and the caller's thread share the pictures and the fetch
    pool; with the interpreter switching threads every few microseconds,
    delay 3 still gives the host path's MD5s."""
    packets = packets_of("inter") * 2
    want = host_md5s(packets)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got, _ = engine_run(packets, 3)
    finally:
        sys.setswitchinterval(old)
    assert got == want


def test_frame_and_fetch_delays():
    """0 is auto: 2 for the engine on a CUDA device, 1 on the CPU engine
    and the host path; the output ring runs only on the engine with a
    delay above 1."""
    cpu = T.Decoder(settings(0), device="cpu")
    host = T.Decoder(settings(0), host_path=True)
    assert (cpu._frame_delay(), cpu._fetch_delay()) == (1, 0)
    assert (host._frame_delay(), host._fetch_delay()) == (1, 0)
    cpu.device = torch.device("cuda")  # the rule only; nothing runs
    assert (cpu._frame_delay(), cpu._fetch_delay()) == (2, 2)
    for d in (1, 2, 5):
        assert T.Decoder(settings(d), device="cpu")._fetch_delay() == (
            0 if d == 1 else d)
        h = T.Decoder(settings(d), host_path=True)
        assert (h._frame_delay(), h._fetch_delay()) == (d, 0)


def test_engine_picture_is_filled_when_materialized():
    """execute leaves the output in a fetch buffer, pending; the decoder
    hands the picture out materialized, with the frame's stages added to
    stage_ms then."""
    packets = [synth.still_picture(136, 96, 10)]
    dec = T.Decoder(settings(2), device="cpu")
    dec.send_data(packets[0])
    (f_pic,) = dec._out_fifo
    dec._drain_dense()
    assert f_pic._pending_fetch is dec.uploader.fetches
    assert not f_pic.y.any()
    run.reset_stats()
    with pytest.raises(T.EAgain):
        dec.get_picture()  # d = 2: held in the output ring
    pic = dec.get_picture()  # the drain handshake
    assert pic is f_pic and pic._pending_fetch is None and pic.y.any()
    assert run.stage_ms["programs"] > 0
    assert synth.picture_md5(pic) == host_md5s(packets)[0]


class _Pic:
    _pending_fetch = None


def test_fetch_pool_completes_the_oldest_when_dry():
    """With every buffer held, take() completes the oldest pending fetch
    first (rav1d_tpu's FETCH_LAG rule); a completed fetch frees its
    buffer; release() drops what is pending."""
    pool = FetchPool("cpu", 2)
    done = []
    pics = [_Pic() for _ in range(4)]
    for i in range(2):
        buf = pool.take(100)
        pool.add(pics[i], buf, lambda i=i: done.append(i))
    assert pool.count == 2 and not done
    buf = pool.take(50)  # dry: frame 0 completes first
    assert done == [0] and pics[0]._pending_fetch is None
    pool.add(pics[2], buf, lambda: done.append(2))
    pool.complete(pics[2])
    pool.complete(pics[2])  # a second completion does nothing
    assert done == [0, 2] and pool.count == 2
    big = pool.take(1 << 20)  # free buffers too small: one is replaced
    assert big.numel() >= 1 << 20 and pool.count == 2
    pool.add(pics[3], big, lambda: done.append(3))
    pool.release()
    assert done == [0, 2] and not pool.pending and pool.count == 0
    assert pics[1]._pending_fetch is None and pics[3]._pending_fetch is None


def test_cli_framedelay_moves_the_decoder(tmp_path, monkeypatch):
    """--framedelay 3 puts the CLI's decodes on the frame ring, and
    --verify still passes."""
    packets = packets_of("inter")
    path = str(tmp_path / "in.ivf")
    synth.write_ivf(path, packets, 136, 96)
    md5 = synth.stream_md5(packets)
    submitted = []
    real = T.Decoder._submit_dense
    monkeypatch.setattr(T.Decoder, "_submit_dense",
                        lambda self, f: submitted.append(1) or real(self, f))
    assert cli.main(["-i", path, "--verify", md5, "--device", "cpu", "-q",
                     "--framedelay", "3"]) == 0
    assert len(submitted) == len(packets)


def test_host_frame_in_the_ring_reads_engine_references():
    """synth.inter_sequence with superres: its fourth frame falls back to
    the host path, which reads the engine-decoded references on the
    worker (Picture.materialize waits for their fetches there)."""
    packets = synth.inter_sequence(136, 96, 2, superres=True)
    want, stats = engine_run(packets, 1)
    assert stats["fallback"] == 1
    got, st = engine_run(packets, 3)
    assert got == want == host_md5s(packets) and st == stats
