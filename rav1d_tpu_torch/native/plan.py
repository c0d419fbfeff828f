"""ctypes bindings for the native key-frame planner (csrc/host/plan.c).

On key and intra-only frames, `plan_frame` goes from the syntax pass's
block records (`f._sy_rec`, the ranges in `f._wi_pending`) straight to what
engine/pack.py writes into the frame blob from a Python plan: the two wave
class arrays, the wave count and the palette scatter. It builds no
`WorkItem` and no per-item object. engine/plan.py's Python planner is its
twin, and what tests hold it to.

The library is built like the syntax pass's (native/__init__.py
build_host). `lib()` is None where it cannot be built; the Python planner
then plans every frame.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build_host

P = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64

PLAN_OK = 0
PLAN_GATE = 1  # a record is not an intra block: the frame takes the host path


class PlanArgsC(ctypes.Structure):
    _fields_ = [
        ("rec", P), ("ranges", P), ("tiles", P), ("pal", P), ("palidx", P),
        ("eob", P),
        ("n_rec", I64), ("n_pal", I64), ("n_palidx", I64), ("n_eob", I64),
        ("n_ranges", I32), ("n_tiles", I32),
        ("bw", I32), ("bh", I32), ("ah", I32), ("aw", I32),
        ("layout", I32), ("intra_edge_filter", I32),
        ("cap0", I32), ("cap1", I32),
    ]


class PlanOutC(ctypes.Structure):
    _fields_ = [
        ("status", I32), ("n_items", I32), ("n_waves", I32), ("pad", I32),
        ("n_pal", I64), ("state", P),
    ]


def _load():
    so = build_host("plan", ["plan.c"],
                    ["-O3", "-shared", "-fPIC", "-fvisibility=hidden"])
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)  # CDLL: the GIL is released for each call
    except OSError:
        return None
    ptr = ctypes.POINTER
    lib.rav1d_plan_frame.argtypes = [ptr(PlanArgsC), ptr(PlanOutC)]
    lib.rav1d_plan_frame.restype = I32
    lib.rav1d_plan_write.argtypes = [ptr(PlanArgsC), ptr(PlanOutC), P, P, P,
                                     P]
    lib.rav1d_plan_write.restype = I32
    lib.rav1d_plan_free.argtypes = [ptr(PlanOutC)]
    lib.rav1d_plan_free.restype = None
    lib.rav1d_plan_n_fields.argtypes = []
    lib.rav1d_plan_n_fields.restype = I32
    return lib


_LIB = _load()


def lib():
    """The loaded planner library, or None where it could not be built."""
    return _LIB


class NativeRows:
    """A natively planned frame's wave rows and palette scatter: `rows`,
    the S and L class arrays (n_waves, CAP[cls], N_FIELDS) int32 (n_waves
    at least 1), and `pal_idx` / `pal_val`, the flat plane indices and
    values of the palette pixels."""

    __slots__ = ("n_items", "rows", "pal_idx", "pal_val")

    def __init__(self, n_items, rows, pal_idx, pal_val):
        self.n_items = n_items
        self.rows = rows
        self.pal_idx = pal_idx
        self.pal_val = pal_val


def _ptr(a):
    return a.ctypes.data_as(P)


def plan_frame(f, ah, aw, cap, n_fields):
    """Plan the key or intra-only frame `f` from its pending records.
    Returns (PLAN_OK, n_waves, NativeRows), or (PLAN_GATE, 0, None) when a
    record is not an intra block. Raises RuntimeError on records that point
    outside their arrays."""
    L = _LIB
    if L.rav1d_plan_n_fields() != n_fields:
        raise RuntimeError("native planner built for another field layout")
    tile_states = f._dense_args[1]
    ranges = np.array([(idx, lo, hi) for idx, lo, hi, _e in f._wi_pending],
                      np.int32).reshape(-1, 3)
    tiles = np.array([(ts.col_start, ts.col_end, ts.row_start, ts.row_end)
                      for ts in tile_states], np.int32).reshape(-1, 4)
    rec = np.ascontiguousarray(f._sy_rec)
    if rec.dtype.itemsize != 128:
        raise ValueError("block records are not syntax.c BlockRecs")
    pal = np.ascontiguousarray(f._sy_pal, np.uint16)
    palidx = np.ascontiguousarray(f._sy_palidx, np.uint8)
    eob = np.ascontiguousarray(f.coef_store.eob, np.int32)
    a = PlanArgsC(
        rec=_ptr(rec), ranges=_ptr(ranges), tiles=_ptr(tiles),
        pal=_ptr(pal), palidx=_ptr(palidx), eob=_ptr(eob),
        n_rec=rec.size, n_pal=pal.size, n_palidx=palidx.size,
        n_eob=eob.size, n_ranges=len(ranges), n_tiles=len(tiles),
        bw=f.bw, bh=f.bh, ah=ah, aw=aw, layout=int(f.cur.layout),
        intra_edge_filter=int(f.seq_hdr.intra_edge_filter),
        cap0=cap[0], cap1=cap[1],
    )
    o = PlanOutC()
    st = L.rav1d_plan_frame(ctypes.byref(a), ctypes.byref(o))
    if st == PLAN_GATE:
        return PLAN_GATE, 0, None
    if st != PLAN_OK:
        raise RuntimeError(f"native planner failed (status {st})")
    try:
        nw = max(o.n_waves, 1)
        rows = (np.empty((nw, cap[0], n_fields), np.int32),
                np.empty((nw, cap[1], n_fields), np.int32))
        pal_idx = np.empty(o.n_pal, np.int32)
        pal_val = np.empty(o.n_pal, np.int32)
        L.rav1d_plan_write(ctypes.byref(a), ctypes.byref(o), _ptr(rows[0]),
                           _ptr(rows[1]), _ptr(pal_idx), _ptr(pal_val))
    finally:
        L.rav1d_plan_free(ctypes.byref(o))
    return PLAN_OK, o.n_waves, NativeRows(o.n_items, rows, pal_idx, pal_val)
