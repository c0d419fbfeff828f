"""The window's arithmetic on a fake clock and a fake decoder, and the
check's comparison."""

import pytest

from avbench import check, window
from avbench.streams import Stream


class Clock:
    def __init__(self):
        self.t = 0

    def __call__(self):
        return self.t


class EAgain(Exception):
    pass


class Pic:
    def __init__(self, ts):
        self.timestamp = ts

    def iter_plane_rows(self):
        yield bytes([self.timestamp % 256]) * 4


class FakeDecoder:
    """send_data takes 100 ticks, get_picture 50; a picture leaves once a
    later unit is in (delay 1), or on a second get with no send between
    (the drain handshake)."""

    def __init__(self, clock):
        self.clock = clock
        self.queue = []
        self.gets_since_send = 0

    def send_data(self, data, ts):
        self.clock.t += 100
        self.queue.append(ts)
        self.gets_since_send = 0

    def get_picture(self):
        self.clock.t += 50
        self.gets_since_send += 1
        if len(self.queue) > 1 or (self.queue and self.gets_since_send > 1):
            return Pic(self.queue.pop(0))
        raise EAgain()


def test_window_closes_at_the_first_picture_after_the_deadline():
    clock = Clock()
    dec = FakeDecoder(clock)
    spans = []
    win, feed = window.drive(dec, [b"u"] * 4, 1000, EAgain, clock=clock,
                             span=lambda *a: spans.append(a))
    # one get a send: sends at 0, 150, 300, ..., 900; pictures 0..5 at
    # 300, 450, ..., 1050: the last is the first after the deadline
    assert (win.t0, win.t1) == (0, 1050)
    assert win.pictures == 6 and win.sent == 7
    assert win.latencies == [300] * 6
    assert win.get_s == 7 * 50 and win.send_s == 7 * 100
    assert sorted(win.digests) == [0, 1, 2, 3, 4, 5]
    assert [s[0] for s in spans].count("send_data") == 7
    window.drain(dec, win, feed, EAgain, clock=clock)
    assert sorted(win.late) == [6]
    fps = __import__("avbench.metrics.decode_fps", fromlist=["read"])
    run = type("Run", (), {"window": win})()
    assert fps.read(run) == pytest.approx(6 / 1050)


class RefusingDecoder(FakeDecoder):
    """Refuses unit 2 the first time it is sent."""

    refused = False

    def send_data(self, data, ts):
        if ts == 2 and not self.refused:
            self.refused = True
            self.clock.t += 100
            raise EAgain()
        super().send_data(data, ts)


def test_a_refused_unit_is_sent_again_and_its_latency_counts_the_wait():
    clock = Clock()
    win, _ = window.drive(RefusingDecoder(clock), [b"u"] * 4, 1000, EAgain,
                          clock=clock)
    assert win.latencies == [300, 300, 450, 300, 300]
    assert (win.t1, win.sent) == (1050, 6)


def test_latency_readers():
    from avbench.spec import Spec

    win = window.Window(t0=0, t1=10)
    win.latencies = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 9.0, 10.0]
    win.get_s = 2.0
    run = type("Run", (), {"window": win})()
    spec = Spec()
    assert spec.reader("picture_latency_ms")(run) == pytest.approx(5500.0)
    assert spec.reader("get_wait_ms")(run) == pytest.approx(200.0)
    assert spec.reader("picture_latency_ms.p90")(run) == pytest.approx(9900.0)
    assert spec.reader("decode_fps")(run) == pytest.approx(1.0)


def test_compare_counts_mismatched_and_missing():
    s = Stream(units=[b"a", b"b", b"c", b"d"], group=[0, 0, 1, 1],
               seeds=[5, 6])
    ref = {0: ["A", "B"], 1: ["C", "D"]}
    got = {0: "A", 1: "B", 2: "C", 3: "D", 4: "A", 6: "x"}  # 5, 7 missing
    c = check.compare(s, 8, got, ref)
    assert (c.checked, c.mismatched, c.missing) == (6, 1, 2)
    assert not c.correct
    assert check.compare(s, 4, got, ref).correct
    assert not check.compare(s, 4, {}, ref).correct  # nothing compared


def test_sample_is_drawn_from_the_seed_among_the_window_groups():
    s = Stream(units=[b"u"] * 30, group=[i // 3 for i in range(30)],
               seeds=list(range(10)))
    a = check.sample_groups(s, 14, 2**33 + 1, 3)
    assert a == check.sample_groups(s, 14, 2**33 + 1, 3)
    assert len(a) == 3 and set(a) <= {0, 1, 2, 3, 4}
    assert check.sample_groups(s, 2, 1, 3) == [0]
