"""The film grain kernels' wrappers: the grain of every plane of a picture
on the card.

`grain_frame(planes, t)` launches csrc/fg.cu rav1d_fg_frame (the new form,
kernel fg_tiles_kernel; the library is built at first use) once on the
current stream: it reads the grain-free padded planes (y[, u, v], uint8 or
int16 tensors, the engine's output or the uploaded host planes; every base
and stride a multiple of 16 bytes) and the picture's host tables `t`
(engine/grain.py GrainTables) and writes new planes of the same shapes,
returned. `grain_frame_earlier` launches the earlier form
(rav1d_fg_frame_earlier, kernel fg_frame_kernel), kept for comparison on
the card; no decoder path runs it. `trace_frame` runs either form's traced
build. The plain version is ops/fg.py grain_frame_plain.

The call costs little more than the launch: the tables are written into
one reused page-locked buffer per card (`TableStage`, its reuse guarded by
one event recorded again behind each launch) and copied by the C entry
itself, ahead of its launch, into the front of the one device allocation
that also holds the output planes (their views by `as_strided`); the
launch's arguments are packed in one `struct` call (`grain_args`). The
wrappers take CUDA tensors only and raise on anything else and on a failed
or refused launch; they never fall back. `grain_args` builds the arguments
for any device (the CPU tests hand them to the source's host build).
Counters: `launches` (the new form), `earlier_launches`.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np
import torch

from . import build

launches = 0
earlier_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_LIB = []
_TABLE_ALIGN = 256  # the output planes start this far into the allocation


class FgFrame(ctypes.Structure):
    """csrc/fg.cu struct FgFrame, field for field."""

    _fields_ = [("out", _P * 3), ("src", _P * 3), ("lut", _P),
                ("scaling", _P), ("rand", _P), ("bpc", _I), ("nplanes", _I),
                ("sx", _I), ("sy", _I), ("w", _I), ("h", _I), ("ph", _I * 3),
                ("pw", _I * 3), ("sc", _I * 3), ("n_rows", _I),
                ("n_cols", _I), ("overlap", _I), ("scaling_shift", _I),
                ("cfl", _I), ("uv_mult", _I * 2), ("uv_luma_mult", _I * 2),
                ("uv_offset", _I * 2), ("lo", _I * 2), ("hi", _I * 2)]


# FgFrame's bytes: nine pointers, then 30 ints, in field order
_ARGS = struct.Struct("=9Q30i")


def lib():
    """Build (at first use) and load the library of csrc/fg.cu."""
    if not _LIB:
        so = build.build("fg", "fg.cu")
        for name in ("rav1d_fg_frame", "rav1d_fg_frame_earlier"):
            getattr(so, name).argtypes = [_P, _P, _LL, _P]
            getattr(so, name + "_trace").argtypes = [_P, _P, _LL, _P, _P]
        so.rav1d_fg_grid.argtypes = [_P, _I]
        for fn in (so.rav1d_fg_frame, so.rav1d_fg_frame_earlier,
                   so.rav1d_fg_frame_trace, so.rav1d_fg_frame_earlier_trace,
                   so.rav1d_fg_grid, so.rav1d_fg_stamps):
            fn.restype = _I
        _LIB.append(so)
    return _LIB[0]


def table_layout(t):
    """(bytes, offsets of the grain tables (int16), the scaling tables and
    the random values) of the host tables `t` in one buffer, each part at a
    multiple of 16 bytes."""
    sc = t.lut.nbytes + 15 & ~15
    rnd = sc + t.scaling.nbytes + 15 & ~15
    return rnd + t.rand.nbytes, (0, sc, rnd)


def write_tables(t, buf):
    """Write the host tables `t` into the uint8 array `buf` at
    table_layout's offsets, the gaps between them zero; returns the
    offsets."""
    n, (lut, sc, rnd) = table_layout(t)
    for o, end, a, dt in ((lut, sc, t.lut, np.int16),
                          (sc, rnd, t.scaling, np.uint8),
                          (rnd, n, t.rand, np.uint8)):
        a = np.ascontiguousarray(a, dt).reshape(-1).view(np.uint8)
        buf[o : o + a.size] = a
        buf[o + a.size : end] = 0
    return lut, sc, rnd


def table_bytes(t):
    """The host tables in one new uint8 buffer, and their offsets."""
    n, _ = table_layout(t)
    buf = np.zeros(n, np.uint8)
    return buf, write_tables(t, buf)


def _event():
    return torch.cuda.Event()


class TableStage:
    """The reused host buffer (page-locked on a card) that a picture's
    tables go through to the card, and the one event that guards its
    reuse: the tables are written into it only once the last copy out of
    it is done (the event, recorded again behind each launch that copies
    out of it, has completed), as engine/blob.py Uploader guards its
    staging buffer. Hold `lock` from `write` until `copied`."""

    def __init__(self, device):
        self.pin = torch.device(device).type == "cuda"
        self.host = None  # uint8 tensor, and its numpy view
        self.view = None
        self.event = None
        self.pending = False  # a copy out of the buffer may be in flight
        self.lock = threading.Lock()

    def write(self, t):
        """(the buffer's address, the tables' bytes, their offsets): the
        tables `t` written into the buffer, after the last copy out of it
        (a larger buffer replaces a smaller one only after that copy
        too)."""
        n, _ = table_layout(t)
        if self.pending:
            self.event.synchronize()  # the last copy left the buffer
            self.pending = False
        if self.host is None or self.host.numel() < n:
            self.host = torch.empty(max(n, 1 << 16), dtype=torch.uint8,
                                    pin_memory=self.pin)
            self.view = self.host.numpy()
        return self.host.data_ptr(), n, write_tables(t, self.view)

    def copied(self, stream=None):
        """A copy out of the buffer was queued on `stream`: the event
        follows it."""
        if self.event is None:
            self.event = _event()
        self.event.record(stream)
        self.pending = True


_STAGES = {}
_STAGE_LOCK = threading.Lock()


def stage(device):
    """The TableStage of a card."""
    dev = torch.device(device)
    s = _STAGES.get(dev)
    if s is None:
        with _STAGE_LOCK:
            s = _STAGES.setdefault(dev, TableStage(dev))
    return s


def grain_args(out, planes, tables, offsets, t):
    """The FgFrame of a launch: output and source planes (lists of
    tensors, the source planes' shapes), the tables' buffer (a tensor
    holding write_tables' bytes at its front) and their offsets, the
    GrainTables `t`."""
    base = tables.data_ptr()
    n = len(planes)
    ptr = [0] * 6
    shape = [0] * 9  # ph, pw, sc
    for pl, (o, s) in enumerate(zip(out, planes)):
        ptr[pl], ptr[3 + pl] = o.data_ptr(), s.data_ptr()
        shape[pl], shape[3 + pl] = s.shape
        shape[6 + pl] = t.plane_scaling[pl]
    (lo_y, hi_y), (lo_c, hi_c) = t.clip
    a = FgFrame()
    _ARGS.pack_into(
        a, 0, *ptr, *(base + o for o in offsets), t.bpc, n, *t.ss, t.w, t.h,
        *shape, *t.rand.shape, int(t.overlap), t.scaling_shift, int(t.cfl),
        *t.uv_mult, *t.uv_luma_mult, *t.uv_offset, lo_y, lo_c, hi_y, hi_c)
    return a


def _call(planes, t, launch):
    """Check the planes, allocate the output planes behind the tables in
    one device tensor, write the tables into the card's TableStage, and
    call `launch(args, host, n, stream)` (the FgFrame, the tables' address
    and bytes in the stage's buffer, the current stream's handle), which
    calls a C entry (it copies the tables to the front of the allocation
    and launches) and returns its code; returns the output planes."""
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"grain_frame: CUDA tensors only, got {dev}")
    dtype = torch.int16 if t.bpc > 8 else torch.uint8
    card = dev.index
    if len(planes) != t.nplanes or any(
            p.get_device() != card or p.dtype != dtype or p.dim() != 2
            or not p.is_contiguous() for p in planes):
        raise ValueError("grain_frame: the picture's planes must be "
                         f"contiguous 2-D {dtype} tensors on one device")
    o = (table_layout(t)[0] + _TABLE_ALIGN - 1 & -_TABLE_ALIGN) // (
        1 + (t.bpc > 8))
    flat = torch.empty(o + sum(p.numel() for p in planes), dtype=dtype,
                       device=dev)
    out = []
    for p in planes:
        h, w = p.shape
        out.append(flat.as_strided((h, w), (w, 1), o))
        o += h * w
    stream = torch.cuda.current_stream(dev)
    st = stage(dev)
    with st.lock:
        host, n, offsets = st.write(t)
        rc = launch(grain_args(out, planes, flat, offsets, t), host, n,
                    stream.cuda_stream)
        st.copied(stream)
    if rc != 0:
        raise RuntimeError(f"film grain: the launch was refused or failed "
                           f"(error {rc})")
    return out


def grain_frame(planes, t):
    """The grained planes of a picture: one launch of rav1d_fg_frame."""
    global launches
    out = _call(planes, t, lambda a, h, n, s: lib().rav1d_fg_frame(
        ctypes.byref(a), h, n, s))
    launches += 1
    return out


def grain_frame_earlier(planes, t):
    """The grained planes of a picture through the earlier form: one
    launch of rav1d_fg_frame_earlier."""
    global earlier_launches
    out = _call(planes, t, lambda a, h, n, s: lib().rav1d_fg_frame_earlier(
        ctypes.byref(a), h, n, s))
    earlier_launches += 1
    return out


def trace_frame(planes, t, form="new"):
    """grain_frame (form "new") or grain_frame_earlier ("earlier") through
    its traced build: (the grained planes, an int64 tensor (blocks,
    stamps) on the card of each block's csrc/fg.cu FG_ST_* stamps: its SM,
    clock64 at its start and end, its staging cycles, tiles and stagings,
    the global timer in ns at its start and end). For measurement; not
    counted."""
    clk = []

    def launch(a, host, n, stream):
        so = lib()
        entry, which = ((so.rav1d_fg_frame_trace, 1) if form == "new"
                        else (so.rav1d_fg_frame_earlier_trace, 0))
        blocks = so.rav1d_fg_grid(ctypes.byref(a), which)
        if blocks < 1:
            return -1
        clk.append(torch.zeros((blocks, so.rav1d_fg_stamps()),
                               dtype=torch.int64, device=planes[0].device))
        return entry(ctypes.byref(a), host, n, clk[0].data_ptr(), stream)

    return _call(planes, t, launch), clk[0]
