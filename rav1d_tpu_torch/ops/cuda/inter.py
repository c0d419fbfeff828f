"""The inter kernel's wrapper: a frame's whole inter phase on the card.

`inter_frame(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask,
...)` launches csrc/inter.cu rav1d_inter_batches (built at first use) once,
on the current stream: a persistent cooperative grid walks the frame's
puts, warps, preps and host pool tiles, the compound combines, the OBMC
blends (top laps, then left laps) and the residual add, with a grid-wide
barrier between those phases, reading the descriptors from the frame blob
in batches of consecutive tiles and the reference planes through their
pointers, and writing the planes in place. `inter_frame_earlier` launches
the earlier form, rav1d_inter_frame (a warp per tile, its descriptor and
taps read from global memory, a scalar residual add), on no decoder path:
it stays for comparison on the card. `trace_frame` runs either through its
traced build. Their plain version is engine/programs.py inter_plain.

The wrappers take CUDA tensors only and raise on anything else, on a
descriptor region outside the blob, and on a failed or refused launch; they
read nothing back from the card, copy nothing to it and never fall back.
`inter_args` builds the launch's arguments for any device (the CPU tests
hand them to the source's host builds). `launches` counts the new form's
launches, `earlier_launches` the earlier form's.
"""

from __future__ import annotations

import ctypes

import torch

from ...engine.consts import tables
from ...engine.layout import (
    HB, IH0, INTER0, NBLEND, NCOMB, NPUT, NWARP, SLOTS, TB,
)
from . import build

launches = 0
earlier_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None
I32 = torch.int32
REFS = 16  # reference planes of each kind a launch takes
SEGS = 64  # slot runs a launch takes

# the phases' slots, in the plain version's order (csrc/inter.cu PH_*): the
# blend slot's first run is the TOP phase, its second the LEFT phase
PRED = ("putY", "putC", "lapY", "lapC", "warpY", "warpC", "prepY", "prepC",
        "wprepY", "wprepC", "hostpool")
COMB = ("avg", "segy00", "segy10", "segy11", "mask")
SEGUV = ("seguv",)
ROWS = {name: (NPUT if name[:3] in ("put", "lap", "pre") else NWARP)
        for name in PRED[:10]}
ROWS.update(hostpool=65, seguv=NCOMB, blend=NBLEND,
            **{name: NCOMB for name in COMB})
PUT_CASES = {"putY": 4, "putC": 4, "lapY": 4, "lapC": 4, "prepY": 3,
             "prepC": 3}
# per slot: its id, lanes a chunk, words a chunk, the largest case its runs
# name (-1: its runs' cases are not passed)
_INFO = {name: (SLOTS[name], HB if name == "hostpool" else TB,
                ROWS[name] * (HB if name == "hostpool" else TB),
                PUT_CASES.get(name, -1)) for name in ROWS}


class InterFrame(ctypes.Structure):
    """csrc/inter.cu struct InterFrame, field for field."""

    _fields_ = [("planes", _P), ("ra", _P), ("blob", _P), ("pool", _P),
                ("lap", _P), ("mask", _P), ("subpel", _P), ("warpf", _P),
                ("fdir", _P), ("ref", (_P * REFS) * 2), ("nref", _I * 2),
                ("esize", _I * 2), ("refw", _I * 2), ("vw", _I * 2),
                ("vh", _I * 2), ("blob_len", _I), ("ah", _I), ("aw", _I),
                ("bpc", _I), ("poolrows", _I), ("hbase", _I), ("ps", _I * 6),
                ("seg_slot", _I * SEGS), ("seg_case", _I * SEGS),
                ("seg_base", _I * SEGS), ("seg_first", _I * (SEGS + 1))]


def lib():
    """Build (at first use) and load csrc/inter.cu; its entries'
    signatures are set up once."""
    global _LIB
    if _LIB is None:
        so = build.build("inter", "inter.cu")
        for e in ("rav1d_inter_frame", "rav1d_inter_batches"):
            getattr(so, e).argtypes = [_P, _I, _P, _P]
            getattr(so, e + "_trace").argtypes = [_P, _I, _P, _P, _P]
        so.rav1d_inter_grid.argtypes = [_I]
        for e in ("rav1d_inter_frame", "rav1d_inter_batches",
                  "rav1d_inter_frame_trace", "rav1d_inter_batches_trace",
                  "rav1d_inter_grid", "rav1d_inter_stamps"):
            getattr(so, e).restype = _I
        _LIB = so
    return _LIB


def pool_rows(ah, aw):
    """The pools' rows: the packer's limit, (8 * psz) // 64."""
    return (8 * ah * aw) // 64


def phases(runs):
    """[[(slot, InterRun)] of each phase PRED, COMB, SEGUV, TOP, LEFT]:
    the packer's runs (engine/pack.py FramePack.inter_runs) in the order
    the plain version runs them."""
    blend = list(runs.get("blend", ()))
    if len(blend) > 2:
        raise ValueError(f"inter kernel: {len(blend)} blend runs; it takes "
                         "a top-lap and a left-lap run")
    out = [[(name, r) for name in slots for r in runs.get(name, ())]
           for slots in (PRED, COMB, SEGUV)]
    return out + [[("blend", r)] for r in blend] + [[]] * (2 - len(blend))


def _refs(refs, vw, vh, dev, kind):
    """(pointers, element size, row stride) of one kind's reference planes:
    a stacked (S, H, W) tensor or a sequence of (H, W) planes, uint8 or
    int16, each plane at least the visible (vh, vw)."""
    if isinstance(refs, torch.Tensor):
        planes = list(refs) if refs.numel() else []
    else:
        planes = list(refs)
    if len(planes) > REFS:
        raise ValueError(f"inter kernel: {len(planes)} {kind} reference "
                         f"planes, at most {REFS}")
    if not planes:
        return [], 1, 0
    shape, dt = planes[0].shape, planes[0].dtype
    for t in planes:
        if (t.device != dev or t.dtype != dt or t.shape != shape
                or t.dim() != 2 or not t.is_contiguous()):
            raise ValueError(f"inter kernel: the {kind} reference planes must "
                             "be contiguous 2-D tensors of one shape and type "
                             "on the planes' device")
    if dt not in (torch.uint8, torch.int16):
        raise ValueError(f"inter kernel: {kind} reference planes of {dt}")
    if vh > shape[0] or vw > shape[1] or vw < 1 or vh < 1:
        raise ValueError(f"inter kernel: visible {vh}x{vw} outside the "
                         f"{kind} reference planes {tuple(shape)}")
    return [t.data_ptr() for t in planes], planes[0].element_size(), shape[1]


_TABS = {}  # device -> the filter tables' pointers


def _tab_ptrs(d_):
    if d_ not in _TABS:
        tab = tables(d_)
        _TABS[d_] = tuple(tab[k].data_ptr() for k in (
            "mc_subpel_filters", "mc_warp_filter", "filter_dir"))
    return _TABS[d_]


def inter_args(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask, *,
               ah, aw, bpc, vwY, vhY, vwC, vhC):
    """The InterFrame of a frame: `planes` (3, ah, aw) int32, written in
    place; `ra` the residual buffer (6 psz); `dev` the blob and `hdr` its
    header; `runs` the packer's {slot: [InterRun]}; refsY and refsC the
    luma and chroma reference planes the descriptors' stack rows name;
    `pool` and `lap` (pool_rows * 64 words) and `mask` (psz words) int32
    scratch, whose contents do not matter. It points into the tensors (and
    the device's tables), which must outlive the launch."""
    psz = ah * aw
    d_ = planes.device
    for t in (planes, ra, dev, pool, lap, mask):
        if t.device != d_ or t.dtype != I32 or not t.is_contiguous():
            raise ValueError("inter kernel: planes, ra, the blob and the "
                             "pools must be contiguous int32 tensors on one "
                             "device")
    if tuple(planes.shape) != (3, ah, aw) or ra.numel() < 6 * psz:
        raise ValueError(f"inter kernel: planes {tuple(planes.shape)}, ra "
                         f"{ra.numel()} words for ({ah}, {aw})")
    rows = pool_rows(ah, aw)
    if (pool.numel() < rows * 64 or lap.numel() < rows * 64
            or mask.numel() < psz or rows < 1):
        raise ValueError("inter kernel: pools smaller than the packer's limit")
    if bpc not in (8, 10, 12):
        raise ValueError(f"inter kernel: bpc {bpc}")
    a = InterFrame(planes.data_ptr(), ra.data_ptr(), dev.data_ptr(),
                   pool.data_ptr(), lap.data_ptr(), mask.data_ptr(),
                   *_tab_ptrs(d_))
    for k, (refs, vw, vh) in enumerate(((refsY, vwY, vhY),
                                        (refsC, vwC, vhC))):
        ptrs, es, stride = _refs(refs, vw, vh, d_, "YC"[k])
        a.ref[k][: len(ptrs)] = ptrs
        a.nref[k], a.esize[k], a.refw[k] = len(ptrs), es, stride
        a.vw[k], a.vh[k] = vw, vh
    n = dev.numel()
    h = hdr.tolist()
    a.blob_len, a.ah, a.aw, a.bpc = n, ah, aw, bpc
    a.poolrows, a.hbase = rows, h[IH0]
    ps, slot, case, base, first = [], [], [], [], [0]
    for phase in phases(runs):
        ps.append(len(slot))
        for name, run in phase:
            sid, B, words, cmax = _INFO[name]
            b = h[INTER0 + 2 * sid] + run.c0 * words
            nc, nt = run.nc, run.n
            if b < 0 or b + nc * words > n or nt < 0 or nt > nc * B:
                raise ValueError(f"inter kernel: the {name} run at {b} "
                                 f"({nc} chunks, {nt} tiles) does not "
                                 f"fit a blob of {n} words")
            slot.append(sid)
            case.append(0 if cmax < 0 else min(max(run.case, 0), cmax))
            base.append(b)
            first.append(first[-1] + nt)
    if len(slot) > SEGS:
        raise ValueError(f"inter kernel: more than {SEGS} slot runs")
    ps.append(len(slot))
    a.ps[:] = ps
    s = len(slot)
    a.seg_slot[:s], a.seg_case[:s], a.seg_base[:s] = slot, case, base
    a.seg_first[: s + 1] = first
    return a


_GRIDS = {}
_BARS = {}  # (device, stream) -> the new form's barrier word
# csrc/inter.cu rav1d_inter_grid's kernels
EARLIER, EARLIER_TRACE, NEW, NEW_TRACE = 0, 1, 2, 3


def grid(which=NEW):
    """The blocks a launch of kernel `which` takes on the current card: as
    many as stay resident (asked once per card and kernel)."""
    key = (torch.cuda.current_device(), which)
    if key not in _GRIDS:
        g = lib().rav1d_inter_grid(which)
        if g < 1:
            raise RuntimeError(f"inter kernel: no resident grid ({g})")
        _GRIDS[key] = g
    return _GRIDS[key]


def _cuda(planes):
    if planes.device.type != "cuda":
        raise ValueError(f"inter kernel: CUDA tensors only, got "
                         f"{planes.device}")


def _launch(entry, which, a, planes, *extra):
    """One cooperative launch of `entry` on the current stream. The new
    form's entries zero their barrier word on the stream themselves (one
    word kept per device and stream); the earlier form's gets a fresh
    zeroed word."""
    d_ = planes.device
    stream = torch.cuda.current_stream(d_).cuda_stream
    g = grid(which)
    if which in (NEW, NEW_TRACE):
        key = (d_, stream)
        if key not in _BARS:
            _BARS[key] = torch.zeros(1, dtype=I32, device=d_)
        bar = _BARS[key]
    else:
        bar = torch.zeros(1, dtype=I32, device=d_)  # barrier count
    rc = getattr(lib(), entry)(ctypes.byref(a), g, bar.data_ptr(), *extra,
                               stream)
    if rc != 0:
        raise RuntimeError(f"inter kernel: the cooperative launch of {g} "
                           f"blocks failed (error {rc})")


def inter_frame(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask,
                **geom):
    """The frame's inter phase into `planes` (3, ah, aw) int32 on the card,
    in place: one cooperative launch of the new form on the current
    stream."""
    global launches
    _cuda(planes)
    a = inter_args(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask,
                   **geom)
    _launch("rav1d_inter_batches", NEW, a, planes)
    launches += 1


def inter_frame_earlier(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap,
                        mask, **geom):
    """inter_frame through the earlier form, rav1d_inter_frame: one
    cooperative launch."""
    global earlier_launches
    _cuda(planes)
    a = inter_args(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask,
                   **geom)
    _launch("rav1d_inter_frame", EARLIER, a, planes)
    earlier_launches += 1


def trace_frame(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask,
                *, form="new", **geom):
    """inter_frame (form "new") or inter_frame_earlier ("earlier") through
    its traced build, which also writes the SM's clock64 at the start of
    each phase and when the block's part of it is done: returns them as an
    int64 tensor (grid, phases, 2) on the card, zero for a phase that does
    not run. For measurement; not counted."""
    _cuda(planes)
    a = inter_args(planes, ra, dev, hdr, runs, refsY, refsC, pool, lap, mask,
                   **geom)
    entry, which = (("rav1d_inter_batches_trace", NEW_TRACE) if form == "new"
                    else ("rav1d_inter_frame_trace", EARLIER_TRACE))
    clk = torch.zeros((grid(which), lib().rav1d_inter_stamps()),
                      dtype=torch.int64, device=planes.device)
    _launch(entry, which, a, planes, clk.data_ptr())
    return clk.view(clk.shape[0], -1, 2)
