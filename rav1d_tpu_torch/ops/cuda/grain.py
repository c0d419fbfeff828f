"""The film grain kernel's wrapper: the grain of every plane of a picture
on the card.

`grain_frame(planes, t)` launches csrc/fg.cu rav1d_fg_frame (built at
first use) once on the current stream: it reads the grain-free padded
planes (y[, u, v], uint8 or int16 tensors, the engine's output or the
uploaded host planes) and the picture's host tables `t`
(engine/grain.py GrainTables, copied to the card in one transfer) and
writes new planes of the same shapes, returned. The plain version is
ops/fg.py grain_frame_plain. The wrapper takes CUDA tensors only and
raises on anything else and on a failed or refused launch; it never
falls back. `grain_args` builds the launch's arguments for any device
(the CPU tests hand them to the source's host build). Counter:
`launches`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = []


class FgFrame(ctypes.Structure):
    """csrc/fg.cu struct FgFrame, field for field."""

    _fields_ = [("out", _P * 3), ("src", _P * 3), ("lut", _P),
                ("scaling", _P), ("rand", _P), ("bpc", _I), ("nplanes", _I),
                ("sx", _I), ("sy", _I), ("w", _I), ("h", _I), ("ph", _I * 3),
                ("pw", _I * 3), ("sc", _I * 3), ("n_rows", _I),
                ("n_cols", _I), ("overlap", _I), ("scaling_shift", _I),
                ("cfl", _I), ("uv_mult", _I * 2), ("uv_luma_mult", _I * 2),
                ("uv_offset", _I * 2), ("lo", _I * 2), ("hi", _I * 2)]


def lib():
    """Build (at first use) and load the library of csrc/fg.cu."""
    if not _LIB:
        so = build.build("fg", "fg.cu")
        so.rav1d_fg_frame.argtypes = [_P, _P]
        so.rav1d_fg_frame.restype = _I
        _LIB.append(so)
    return _LIB[0]


def table_bytes(t):
    """The host tables in one uint8 buffer, and the offsets of the grain
    tables (int16), the scaling tables and the random values in it."""
    lut = np.ascontiguousarray(t.lut, np.int16).view(np.uint8).ravel()
    sc = np.ascontiguousarray(t.scaling, np.uint8).ravel()
    rnd = np.ascontiguousarray(t.rand, np.uint8).ravel()
    buf = np.concatenate([lut, sc, rnd])
    return buf, (0, lut.size, lut.size + sc.size)


def grain_args(out, planes, tables, offsets, t):
    """The FgFrame of a launch: output and source planes (lists of
    tensors, the source planes' shapes), the tables' buffer (table_bytes,
    on the planes' device) and its offsets, the GrainTables `t`."""
    a = FgFrame()
    base = tables.data_ptr()
    for pl, (o, s) in enumerate(zip(out, planes)):
        a.out[pl] = o.data_ptr()
        a.src[pl] = s.data_ptr()
        a.ph[pl], a.pw[pl] = s.shape
        a.sc[pl] = t.plane_scaling[pl]
    a.lut, a.scaling, a.rand = (base + o for o in offsets)
    a.bpc, a.nplanes = t.bpc, t.nplanes
    a.sx, a.sy = t.ss
    a.w, a.h = t.w, t.h
    a.n_rows, a.n_cols = t.rand.shape
    a.overlap, a.scaling_shift, a.cfl = int(t.overlap), t.scaling_shift, int(t.cfl)
    for uv in range(2):
        a.uv_mult[uv] = t.uv_mult[uv]
        a.uv_luma_mult[uv] = t.uv_luma_mult[uv]
        a.uv_offset[uv] = t.uv_offset[uv]
    for k, (lo, hi) in enumerate(t.clip):
        a.lo[k], a.hi[k] = lo, hi
    return a


def grain_frame(planes, t):
    """The grained planes of a picture: one launch of rav1d_fg_frame."""
    global launches
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"grain_frame: CUDA tensors only, got {dev}")
    dtype = torch.int16 if t.bpc > 8 else torch.uint8
    if len(planes) != t.nplanes or any(
            p.device != dev or p.dtype != dtype or p.dim() != 2
            or not p.is_contiguous() for p in planes):
        raise ValueError("grain_frame: the picture's planes must be "
                         f"contiguous 2-D {dtype} tensors on one device")
    buf, offsets = table_bytes(t)
    tables = torch.from_numpy(buf).pin_memory().to(dev, non_blocking=True)
    flat = torch.empty(sum(p.numel() for p in planes), dtype=dtype,
                       device=dev)
    out, o = [], 0
    for p in planes:
        out.append(flat[o : o + p.numel()].view(p.shape))
        o += p.numel()
    a = grain_args(out, planes, tables, offsets, t)
    rc = lib().rav1d_fg_frame(ctypes.byref(a),
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rav1d_fg_frame: the launch failed (error {rc})")
    launches += 1
    return out
