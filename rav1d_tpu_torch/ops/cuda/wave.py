"""The wave kernel's wrappers: the intra wavefront of a frame on the card.

`wave_frame(pf, ra, dev, hdr, waves, ...)` runs the frame's intra
wavefront as one cooperative launch of the hand-written kernel csrc/wave.cu
rav1d_wave_frame (built at first use): a persistent grid of `grid(waves)`
blocks walks every level with items, with a grid-wide barrier between the
levels, and predicts, blends, adds the residual and writes back every item
of each level, both size classes and every mode, reading the descriptors,
the level counts and the interintra masks from the frame blob.
`wave_levels` is the earlier form of the same work, one launch of
rav1d_wave_level per level with items, kept as what the frame kernel is
held to and timed against. Their plain version is engine/wave.py
class_step, small class then large class per level
(engine/programs.wave_plain).

The wrappers take CUDA tensors only and raise on anything else, on a
failed or refused launch (a grid the card cannot keep resident is
refused), and never fall back; engine/programs.wave runs the plain
version on the CPU. A barrier wait that outlasts about a second traps in
the kernel, and the next synchronising call raises. `launches` counts the
frame launches and `level_launches` the per-level ones. `empty_levels`
launches an empty kernel over the grids of wave_levels through the same
calls (the launch path's own cost), `barrier_frame` the frame kernel's
level walk and barriers with no item work (its dependency floor) and
`trace_frame` the frame kernel with clock stamps per level and block;
none of them is counted.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...engine.consts import numpy_tables
from ...engine.layout import N_FIELDS, WAVE0
from ...engine.plan import CAP
from . import build

launches = 0
level_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None
I32 = torch.int32
TABLE_ORDER = ("ctz", "edge_kernels", "dr_intra_derivative", "sm_weights",
               "filter_intra_taps")


class WaveFrame(ctypes.Structure):
    """csrc/wave.cu struct WaveFrame, field for field."""

    _fields_ = [("pf", _P), ("ra", _P), ("blob", _P), ("tab", _P),
                ("n3", _I), ("blob_len", _I), ("base_s", _I),
                ("base_l", _I), ("mask_base", _I), ("aw", _I), ("psz", _I),
                ("bpc", _I), ("ss_hor", _I), ("ss_ver", _I), ("nw", _I)]


def lib():
    """Build (at first use) and load csrc/wave.cu; the handle and its entry
    points' signatures are set up once."""
    global _LIB
    if _LIB is None:
        so = build.build("wave", "wave.cu")
        for fn in (so.rav1d_wave_level, so.rav1d_wave_empty):
            fn.argtypes = [_P, _I, _I, _I, _P]
            fn.restype = _I
        for fn in (so.rav1d_wave_frame, so.rav1d_wave_barriers):
            fn.argtypes = [_P, _I, _P, _P]
            fn.restype = _I
        so.rav1d_wave_trace.argtypes = [_P, _I, _P, _P, _P]
        so.rav1d_wave_trace.restype = _I
        so.rav1d_wave_stamps.restype = _I
        so.rav1d_wave_table_len.restype = _I
        if so.rav1d_wave_table_len() != table_numpy().size:
            raise RuntimeError("csrc/wave.cu's table layout differs from "
                               "engine/consts.py's tables")
        _LIB = so
    return _LIB


@functools.lru_cache(maxsize=None)
def table_numpy():
    """The kernel's tables as one int32 array, in csrc/wave.cu's order."""
    t = numpy_tables()
    return np.concatenate([np.asarray(t[k], np.int32).reshape(-1)
                           for k in TABLE_ORDER])


@functools.lru_cache(maxsize=None)
def _table(device_str):
    return torch.from_numpy(table_numpy()).to(torch.device(device_str))


def table(device):
    """table_numpy() on `device`, made once per device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _table(str(device))


def frame_args(pf, ra, dev, hdr, waves, *, aw, psz, bpc, ss_hor, ss_ver):
    """The WaveFrame of a frame: pf the flat planes (3 * psz words, or
    more), ra the residuals (at least 3 * psz), dev the frame blob, hdr its
    header; `waves` (FramePack.waves) sizes the descriptor regions, which
    must lie inside the blob. It points into the tensors, which must
    outlive every launch over the frame (the table is kept per device)."""
    tab = table(pf.device)
    for t in (pf, ra, dev):
        if t.device != pf.device or t.dtype != I32 or not t.is_contiguous():
            raise ValueError("wave kernel: buffers must be contiguous int32 "
                             "tensors on one device")
    n3 = 3 * psz
    if pf.numel() < n3 or ra.numel() < n3 or bpc not in (8, 10, 12):
        raise ValueError(f"wave kernel: pf {pf.numel()}, ra {ra.numel()} "
                         f"words for 3 * psz = {n3}; bpc {bpc}")
    for reg, cap in ((WAVE0 + 1, CAP[0]), (WAVE0 + 2, CAP[1])):
        base = int(hdr[reg])
        if not (0 <= base and base + len(waves) * cap * N_FIELDS
                <= dev.numel()):
            raise ValueError(f"wave kernel: descriptor region at {base} "
                             f"does not fit a blob of {dev.numel()} words")
    nw = int(hdr[WAVE0]) if waves else 0
    if nw != len(waves):
        raise ValueError(f"wave kernel: hdr[WAVE0] = {nw} levels, the "
                         f"packer's view has {len(waves)}")
    return WaveFrame(pf.data_ptr(), ra.data_ptr(), dev.data_ptr(),
                     tab.data_ptr(), n3, dev.numel(), int(hdr[WAVE0 + 1]),
                     int(hdr[WAVE0 + 2]), int(hdr[WAVE0 + 3]), aw, psz, bpc,
                     ss_hor, ss_ver, nw)


def levels(waves):
    """[(level, small-class items, large-class items)] of the levels with
    items (the n of each class in FramePack.waves)."""
    return [(i, s[1], l[1]) for i, (s, l) in enumerate(waves)
            if s[1] or l[1]]


def grid(waves):
    """The frame kernel's blocks: the most items of any level (0 if none)."""
    return max((ns + nl for _, ns, nl in levels(waves)), default=0)


def _args(pf, ra, dev, hdr, waves, kw):
    if pf.device.type != "cuda":
        raise ValueError(f"wave kernel: CUDA tensors only, got {pf.device}")
    f = frame_args(pf, ra, dev, hdr, waves, **kw)
    return f, torch.cuda.current_stream(pf.device).cuda_stream


def _run(entry, counted, pf, ra, dev, hdr, waves, kw):
    global level_launches
    f, stream = _args(pf, ra, dev, hdr, waves, kw)
    fn = getattr(lib(), entry)
    ref = ctypes.byref(f)
    for i, ns, nl in levels(waves):
        rc = fn(ref, i, ns, nl, stream)
        if rc != 0:
            raise RuntimeError(f"wave kernel launch failed at level {i}: "
                               f"error {rc}")
        level_launches += counted


def _frame(entry, pf, ra, dev, hdr, waves, kw, *extra):
    """One cooperative launch of `entry` over the frame (`extra` pointers
    after the barrier word); False if no level has items (nothing is
    launched)."""
    f, stream = _args(pf, ra, dev, hdr, waves, kw)
    for i, ns, nl in levels(waves):
        if ns > CAP[0] or nl > CAP[1]:
            raise ValueError(f"wave kernel: level {i} has {ns} + {nl} "
                             f"items, over the caps {CAP}")
    g = grid(waves)
    if not g:
        return False
    bar = torch.zeros(1, dtype=I32, device=pf.device)  # the barrier count
    rc = getattr(lib(), entry)(ctypes.byref(f), g, bar.data_ptr(), *extra,
                               stream)
    if rc != 0:
        raise RuntimeError(f"wave kernel: the cooperative launch of {g} "
                           f"blocks failed (cudaError {rc})")
    return True


def wave_frame(pf, ra, dev, hdr, waves, *, aw, psz, bpc, ss_hor, ss_ver):
    """The frame's intra wavefront in place on pf (int32, on the card): one
    cooperative launch of the frame kernel if any level has items, on the
    current stream."""
    global launches
    kw = dict(aw=aw, psz=psz, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    launches += _frame("rav1d_wave_frame", pf, ra, dev, hdr, waves, kw)


def barrier_frame(pf, ra, dev, hdr, waves, *, aw, psz, bpc, ss_hor, ss_ver):
    """The frame kernel's grid, level walk and barriers with no item work:
    the floor that the chain of levels alone sets. Not counted."""
    kw = dict(aw=aw, psz=psz, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    _frame("rav1d_wave_barriers", pf, ra, dev, hdr, waves, kw)


def trace_frame(pf, ra, dev, hdr, waves, *, aw, psz, bpc, ss_hor, ss_ver):
    """wave_frame through the frame kernel's traced build, which also
    writes the SM's clock64 at each stamp of csrc/wave.cu (ST_START ..
    ST_ARRIVED) for every level with items and block: returns them as an
    int64 tensor (levels, grid, stamps) on the card. For measurement; not
    counted."""
    kw = dict(aw=aw, psz=psz, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    clk = torch.zeros((len(levels(waves)), grid(waves),
                       lib().rav1d_wave_stamps()), dtype=torch.int64,
                      device=pf.device)
    _frame("rav1d_wave_trace", pf, ra, dev, hdr, waves, kw, clk.data_ptr())
    return clk


def wave_levels(pf, ra, dev, hdr, waves, *, aw, psz, bpc, ss_hor, ss_ver):
    """The frame's intra wavefront in place on pf (int32, on the card), one
    launch of the level kernel per level with items, on the current
    stream."""
    kw = dict(aw=aw, psz=psz, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    _run("rav1d_wave_level", 1, pf, ra, dev, hdr, waves, kw)


def empty_levels(pf, ra, dev, hdr, waves, *, aw, psz, bpc, ss_hor, ss_ver):
    """An empty kernel over the grids of wave_levels, through the same
    calls: the floor that the launches alone set. Not counted."""
    kw = dict(aw=aw, psz=psz, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    _run("rav1d_wave_empty", 0, pf, ra, dev, hdr, waves, kw)
