"""The measured window: one caller feeding a decoder temporal unit by
temporal unit and taking every picture it hands out, as a player or a
transcoder does (dav1d's send_data / get_picture loop).

The caller follows dav1d's command-line tool: one `send_data`, then one
`get_picture`, unit after unit. The window opens before the first
`send_data` and closes at the return of the first picture that comes
after `seconds` have passed: every picture
returned in it counts, over all of its time. A picture's latency runs
from the start of `send_data` for its temporal unit to the return of the
`get_picture` that hands it out. The units are cycled if the window
outlasts them. Each picture is reduced to its digest at once and
dropped. After the window, the pictures still in the decoder are drained
for the check, outside the window.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field


def digest(pic):
    """MD5 of the visible planes (the md5 muxer's digest)."""
    m = hashlib.md5()
    for rows in pic.iter_plane_rows():
        m.update(rows)
    return m.hexdigest()


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    sent: int = 0                 # temporal units sent in the window
    latencies: list = field(default_factory=list)  # s, one a picture
    get_s: float = 0.0            # the caller's time in get_picture
    send_s: float = 0.0           # the caller's time in send_data
    digests: dict = field(default_factory=dict)    # unit -> digest
    late: dict = field(default_factory=dict)       # drained after it
    errors: dict = field(default_factory=dict)     # unit -> message

    @property
    def seconds(self):
        return self.t1 - self.t0

    @property
    def pictures(self):
        return len(self.latencies)


class Feed:
    """Unit numbering and the send times the latencies start from."""

    def __init__(self, units):
        self.units = units
        self.next = 0         # units sent so far
        self.held = None      # a unit the decoder has not taken yet
        self.sent_at = {}

    def send(self, dec, eagain, clock, win, span):
        """send_data of the next unit, or again of the one the decoder
        refused with EAgain (dav1d: the data stays with the caller)."""
        if self.held is None:
            ts = self.next
            self.next += 1
            self.held = ts
            self.sent_at[ts] = clock()
        ts = self.held
        t = clock()
        try:
            dec.send_data(self.units[ts % len(self.units)], ts)
            self.held = None
        except eagain:
            pass
        except Exception as e:  # a unit the decoder refuses is a failure
            win.errors[ts] = repr(e)
            self.sent_at.pop(ts)
            self.held = None
        t1 = clock()
        win.send_s += t1 - t
        if span is not None:
            span("send_data", t, t1)


def drive(dec, units, seconds, eagain, clock=time.perf_counter,
          on_open=None, span=None):
    """Run the window on decoder `dec` (empty: no unit pending, no
    picture queued) over `units`, in the loop of dav1d's command-line
    tool: one send_data, then one get_picture (a second get with no send
    between would start the drain handshake and empty the frame ring).
    `eagain` is the exception the decoder raises when it cannot take a
    unit or has no picture ready. `on_open()` runs just before the window
    opens; `span(name, t0, t1)`, if given, records the caller's calls.
    Returns the Window and the feed (for the drain)."""
    win = Window()
    feed = Feed(units)
    if on_open is not None:
        on_open()
    win.t0 = clock()
    deadline = win.t0 + seconds
    while True:
        feed.send(dec, eagain, clock, win, span)
        g = clock()
        try:
            pic = dec.get_picture()
        except eagain:
            pic = None
        except Exception as e:  # a failed dense pass: its unit fails
            pic = None
            win.errors[f"get{len(win.errors)}"] = repr(e)
        t = clock()
        win.get_s += t - g
        if span is not None:
            span("get_picture", g, t)
        if pic is None:
            continue
        ts = pic.timestamp
        win.latencies.append(t - feed.sent_at.pop(ts))
        win.digests[ts] = digest(pic)
        del pic
        if t >= deadline:
            win.t1 = t
            win.sent = feed.next
            return win, feed


def drain(dec, win, feed, eagain, limit_s=60.0, clock=time.perf_counter):
    """After the window: take the pictures of units sent in it that the
    decoder still holds (dav1d's drain handshake: get_picture until two
    calls in a row find none), up to `limit_s` seconds."""
    end = clock() + limit_s
    misses = 0
    while misses < 2 and feed.sent_at and clock() < end:
        try:
            pic = dec.get_picture()
        except eagain:
            misses += 1
            continue
        except Exception as e:
            win.errors[f"drain{len(win.errors)}"] = repr(e)
            misses += 1
            continue
        misses = 0
        ts = pic.timestamp
        feed.sent_at.pop(ts, None)
        if ts < win.sent:
            win.late[ts] = digest(pic)
