"""The post filters' wrappers: deblock, CDEF, the superres upscale and
loop restoration on the card.

Each wrapper launches one hand-written kernel (built at first use from
csrc/, one library per source) on the current stream:

- `lf_pass(planes, dev, hdr, hor, ...)`: csrc/lf.cu rav1d_deblock, the
  deblocking filter of every plane in one direction (vertical edges, then
  `hor` for horizontal ones), in place, a group of lines per block;
- `cdef_frame(planes, pre, dev, hdr, ...)`: csrc/cdef.cu rav1d_cdef, the
  direction search and filter of every 8x8 unit of every plane, read
  from the pre-CDEF snapshot `pre` (staged in shared memory by area),
  written to `planes`;
- `superres_frame(planes, pre, hdr, ...)`: csrc/superres.cu
  rav1d_superres_frame, the upscale of every plane of the post-CDEF
  planes and of the snapshot, into a new (2, 3, s_ah, s_aw) tensor;
- `lr_wiener_frame(out, src, lpf, dev, hdr, ...)`: csrc/lr.cu
  rav1d_lr_wiener_frame, every Wiener stripe of every plane of the (3, ah,
  aw) planes, read from the post-CDEF planes `src` and the pre-CDEF planes
  `lpf`, written to `out`;
- `lr_sgr_frame(out, src, lpf, dev, hdr, ...)`: csrc/lr.cu
  rav1d_lr_sgr_frame, every self-guided stripe of every plane (all three
  kinds), likewise.

`lf_pass_lines` (csrc/lf.cu rav1d_lf_pass, a line per block),
`cdef_frame_global` (csrc/cdef.cu rav1d_cdef_frame, taps read from global
memory), `lr_wiener_plane` (csrc/lr.cu rav1d_lr_wiener, one launch per
plane, each tile pixel's source computed in place) and `lr_sgr_plane`
(csrc/lr.cu rav1d_lr_sgr, one launch per plane, each box sum straight from
the tile) are the earlier forms of deblock, CDEF and the two loop
restoration filters, on no decoder path: they stay for comparison on the
card.

Their plain versions are engine/filters.py lf_dir_pass, cdef_pass,
resize_plane (through engine/programs.py _superres), lr_wiener_pass and
lr_sgr_pass (engine/programs.py filter_plain). The
wrappers take CUDA tensors only and raise on anything else and on a failed
or refused launch; they read nothing back from the card, copy nothing to
it, and never fall back. `*_args` build a launch's arguments for any
device (the CPU tests hand them to the sources' host builds). Counters:
`lf_launches`, `cdef_launches`, `sr_launches`, `wiener_launches`,
`sgr_launches`; the earlier forms' `lf_lines_launches`,
`cdef_global_launches`, `wiener_plane_launches` and
`sgr_plane_launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ...engine.layout import CDEF0, DB0, LR0, LRB, SR0
from . import build

lf_launches = 0
cdef_launches = 0
lf_lines_launches = 0
cdef_global_launches = 0
sr_launches = 0
wiener_launches = 0
wiener_plane_launches = 0
sgr_launches = 0
sgr_plane_launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIBS = {}
I32 = torch.int32
SMEM_MAX = 232448  # bytes of shared memory a block can use on an H100
KINDS = ("w", 0, 1, 2)  # the LR slots of a plane, in the blob header's order


class LfPass(ctypes.Structure):
    """csrc/lf.cu struct LfPass, field for field."""

    _fields_ = [("planes", _P), ("blob", _P), ("ah", _I), ("aw", _I),
                ("hor", _I), ("bpc", _I), ("eih", _I), ("nplanes", _I),
                ("map", _I * 3), ("nh4", _I * 3), ("nw4", _I * 3),
                ("first", _I * 4), ("maxnw", _I)]


class LfGroups(ctypes.Structure):
    """csrc/lf.cu struct LfGroups, field for field."""

    _fields_ = [("planes", _P), ("blob", _P), ("ah", _I), ("aw", _I),
                ("hor", _I), ("bpc", _I), ("eih", _I), ("nplanes", _I),
                ("map", _I * 3), ("nh4", _I * 3), ("nw4", _I * 3),
                ("nlines", _I * 3), ("ext", _I * 3), ("first", _I * 4),
                ("group", _I), ("pitch", _I), ("maxnw", _I)]


class CdefFrame(ctypes.Structure):
    """csrc/cdef.cu struct CdefFrame, field for field."""

    _fields_ = [("planes", _P), ("pre", _P), ("blob", _P), ("ah", _I),
                ("aw", _I), ("ylvl", _I), ("uvlvl", _I), ("nby", _I),
                ("nbx", _I), ("bh", _I), ("bw", _I), ("damping", _I),
                ("bpc", _I), ("ss_hor", _I), ("ss_ver", _I), ("uv422", _I)]


class SrFrame(ctypes.Structure):
    """csrc/superres.cu struct SrFrame, field for field."""

    _fields_ = [("out", _P), ("planes", _P), ("pre", _P), ("ah", _I),
                ("aw", _I), ("s_ah", _I), ("s_aw", _I), ("bpc", _I),
                ("nplanes", _I), ("h", _I * 3), ("dst_w", _I * 3),
                ("src_w", _I * 3), ("dx", _I * 3), ("mx0", _I * 3)]


class LrPass(ctypes.Structure):
    """csrc/lr.cu struct LrPass, field for field."""

    _fields_ = [("out", _P), ("src", _P), ("lpf", _P), ("blob", _P),
                ("ah", _I), ("aw", _I), ("ph", _I), ("W", _I), ("bpc", _I),
                ("nreg", _I), ("base", _I * 3), ("first", _I * 4)]


class LrFrame(ctypes.Structure):
    """csrc/lr.cu struct LrFrame, field for field."""

    _fields_ = [("pl", LrPass * 3), ("nplanes", _I), ("ncb", _I * 3),
                ("item0", _I * 4)]


LR_CW = 32  # csrc/lr.cu: output columns of an item
_ENTRIES = {"lf": ("lf.cu", ("rav1d_deblock", "rav1d_lf_pass")),
            "cdef": ("cdef.cu", ("rav1d_cdef", "rav1d_cdef_frame")),
            "superres": ("superres.cu", ("rav1d_superres_frame",)),
            "lr": ("lr.cu", ("rav1d_lr_wiener", "rav1d_lr_wiener_frame",
                             "rav1d_lr_sgr", "rav1d_lr_sgr_frame"))}


def lib(name):
    """Build (at first use) and load the library of csrc/lf.cu, cdef.cu,
    superres.cu or lr.cu (`name` "lf", "cdef", "superres" or "lr"), its
    entries' signatures set."""
    if name not in _LIBS:
        src, entries = _ENTRIES[name]
        so = build.build(name, src)
        for e in entries:
            fn = getattr(so, e)
            fn.argtypes = [_P, _P]
            fn.restype = _I
        _LIBS[name] = so
    return _LIBS[name]


def subsampling(layout_i):
    """(ss_hor, ss_ver) of a PixelLayout int."""
    return (0 if layout_i == 3 else 1), (1 if layout_i == 1 else 0)


def _check(*ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.dtype != I32 or not t.is_contiguous():
            raise ValueError("filter kernels: buffers must be contiguous "
                             "int32 tensors on one device")


def _fits(dev, base, words, what):
    if not (0 <= base and base + words <= dev.numel()):
        raise ValueError(f"filter kernels: {what} at {base} ({words} words) "
                         f"does not fit a blob of {dev.numel()} words")


def _lf_maps(planes, dev, hdr, hor, bh, bw, layout_i):
    """[(plane, nh4, nw4, map base)] of one direction's pass: the maps of
    passes 0-2 (vertical edges) or 3-5 (`hor`), stored post-transpose for
    horizontal edges, as filter_plain reads them; and (line length, lines
    of a plane)."""
    _check(planes, dev)
    _, ah, aw = planes.shape
    ss_hor, ss_ver = subsampling(layout_i)
    ch4, cw4 = (bh + ss_ver) >> ss_ver, (bw + ss_hor) >> ss_hor
    shapes = [(bh, bw), (ch4, cw4), (ch4, cw4)][: 1 if layout_i == 0 else 3]
    if hor:
        shapes = [(w, h) for h, w in shapes]
    ln, lines = (ah, aw) if hor else (aw, ah)
    wp = (ln + 24) - (ln + 24) % 4
    _fits(dev, int(hdr[DB0]), 128, "the E/I luts")
    out = []
    for p, (nh4, nw4) in enumerate(shapes):
        if 4 * nw4 + 12 > wp or 4 * nh4 > lines + 8:
            raise ValueError(f"deblock kernel: a ({nh4}, {nw4}) map does not "
                             f"fit lines of {ln} pixels")
        base = int(hdr[DB0 + 1 + 3 * int(hor) + p])
        _fits(dev, base, (nh4 * nw4 + 3) // 4, "a deblock map")
        out.append((p, nh4, nw4, base))
    return out, ln, lines


def deblock_args(planes, dev, hdr, hor, *, bh, bw, layout_i, bpc, group=None):
    """The LfGroups of one direction's pass over the frame's planes (3, ah,
    aw) for rav1d_deblock: blocks of `group` adjacent lines of a plane (by
    default 4 rows, one map row, or for horizontal edges 8 columns, one
    32-byte sector of a row; 2 or 1 where lines that long do not fit a
    block's shared memory twice), only the lines with cells inside the
    plane."""
    maps, ln, lines = _lf_maps(planes, dev, hdr, hor, bh, bw, layout_i)
    _, ah, aw = planes.shape
    a = LfGroups(planes.data_ptr(), dev.data_ptr(), ah, aw, int(hor), bpc,
                 int(hdr[DB0]), len(maps))
    a.maxnw = max(nw4 for _, _, nw4, _ in maps)
    a.pitch = 4 * a.maxnw + 12 + (8 - (4 * a.maxnw + 12)) % 64

    def words(g):  # csrc/lf.cu lfg_smem_words
        cells = max(g // 4, 1) * a.maxnw
        return g * a.pitch + 12 + 128 + (cells + 3) // 4 + 3 * ((cells + 1) // 2)

    g = group or next((g for g in ((8 if hor else 4), 2, 1)
                       if words(g) * 4 <= SMEM_MAX), 0)
    if g not in (1, 2, 4, 8) or words(g) * 4 > SMEM_MAX or bpc not in (8, 10, 12):
        raise ValueError(f"deblock kernel: lines of {ln} pixels in groups of "
                         f"{g}, bpc {bpc}")
    first = 0
    for p, nh4, nw4, base in maps:
        a.map[p], a.nh4[p], a.nw4[p] = base, nh4, nw4
        a.nlines[p] = min(4 * nh4, lines)
        a.ext[p] = min(ln, 4 * nw4 + 4)
        a.first[p] = first
        first += -(-a.nlines[p] // g)
    a.first[len(maps)] = first
    a.group = g
    return a


def lf_args(planes, dev, hdr, hor, *, bh, bw, layout_i, bpc):
    """The LfPass of one direction's pass over the frame's planes (3, ah,
    aw) for the earlier form rav1d_lf_pass: a block per line."""
    maps, ln, _ = _lf_maps(planes, dev, hdr, hor, bh, bw, layout_i)
    _, ah, aw = planes.shape
    a = LfPass(planes.data_ptr(), dev.data_ptr(), ah, aw, int(hor), bpc,
               int(hdr[DB0]), len(maps))
    first = 0
    for p, nh4, nw4, base in maps:
        a.map[p], a.nh4[p], a.nw4[p], a.first[p] = base, nh4, nw4, first
        first += 4 * nh4
    a.first[len(maps)] = first
    a.maxnw = max(nw4 for _, _, nw4, _ in maps)
    if (2 * (ln + 24) + a.maxnw + 4) * 4 > SMEM_MAX:
        raise ValueError(f"deblock kernel: lines of {ln} pixels do not fit "
                         "a block's shared memory")
    if bpc not in (8, 10, 12):
        raise ValueError(f"deblock kernel: bpc {bpc}")
    return a


def cdef_args(planes, pre, dev, hdr, *, bh, bw, layout_i, bpc):
    """The CdefFrame of the frame: `pre` the pre-CDEF snapshot of
    `planes` (3, ah, aw), which cover its 8x8 units (as the plain pass
    needs them to), the byte maps and damping from the header."""
    _check(planes, pre, dev)
    if pre.shape != planes.shape:
        raise ValueError("cdef kernel: the snapshot's shape differs")
    _, ah, aw = planes.shape
    ss_hor, ss_ver = subsampling(layout_i)
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    uv422 = -1 if layout_i == 0 else (1 if layout_i == 2 else 0)
    a = CdefFrame(planes.data_ptr(), pre.data_ptr(), dev.data_ptr(), ah, aw,
                  int(hdr[CDEF0]), int(hdr[CDEF0 + 1]), nby, nbx, bh, bw,
                  int(hdr[CDEF0 + 2]), bpc, ss_hor, ss_ver, uv422)
    for base in (a.ylvl, a.uvlvl):
        _fits(dev, base, (nby * nbx + 3) // 4, "a cdef level map")
    if bpc not in (8, 10, 12) or ah < 8 * nby or aw < 8 * nbx:
        raise ValueError(f"cdef kernel: bpc {bpc}, ({ah}, {aw}) planes for "
                         f"({nby}, {nbx}) units")
    return a


def superres_args(out, planes, pre, hdr, *, cur_h, sr_geom, layout_i, bpc):
    """The SrFrame of a frame's upscale: `planes` (post-CDEF) and `pre`
    (the post-deblock snapshot), each (3, ah, aw), into `out` (2, 3, s_ah,
    s_aw); cur_h the coded picture's rows, sr_geom = (s_ah, s_aw, sr_w,
    sr_h, srcw_y) as programs.filter_ takes it, each plane's step and
    start from the header (SR0: luma, then chroma), as _superres reads
    them."""
    _check(out, planes, pre)
    s_ah, s_aw, sr_w, _, srcw_y = sr_geom
    if planes.dim() != 3 or planes.shape[0] != 3 or pre.shape != planes.shape:
        raise ValueError("superres kernel: planes and pre must be (3, ah, aw)")
    if tuple(out.shape) != (2, 3, s_ah, s_aw):
        raise ValueError(f"superres kernel: out {tuple(out.shape)}, not "
                         f"(2, 3, {s_ah}, {s_aw})")
    _, ah, aw = planes.shape
    ss_hor, ss_ver = subsampling(layout_i)
    a = SrFrame(out.data_ptr(), planes.data_ptr(), pre.data_ptr(), ah, aw,
                s_ah, s_aw, bpc, 1 if layout_i == 0 else 3)
    for pl in range(a.nplanes):
        sh, sv, ci = (ss_hor, ss_ver, 1) if pl else (0, 0, 0)
        a.h[pl] = (cur_h + sv) >> sv
        a.dst_w[pl] = (sr_w + sh) >> sh
        a.src_w[pl] = (srcw_y + sh) >> sh
        a.dx[pl] = int(hdr[SR0 + 2 * ci])
        a.mx0[pl] = int(hdr[SR0 + 2 * ci + 1])
        if not (0 <= a.h[pl] <= min(ah, s_ah) and 0 <= a.dst_w[pl] <= s_aw
                and 1 <= a.src_w[pl] <= aw and 1 <= a.dx[pl] <= 1 << 15
                and 0 <= a.mx0[pl] < 1 << 14
                and a.dst_w[pl] * a.dx[pl] < 1 << 30):
            raise ValueError(
                f"superres kernel: plane {pl}: {a.h[pl]} rows, {a.src_w[pl]} "
                f"to {a.dst_w[pl]} columns, step {a.dx[pl]}, start "
                f"{a.mx0[pl]} in ({ah}, {aw}) planes to ({s_ah}, {s_aw})")
    if bpc not in (8, 10, 12) or s_ah > 65535:
        raise ValueError(f"superres kernel: bpc {bpc}, {s_ah} rows")
    return a


def lr_chunks(hdr, pl):
    """{kind: (descriptor base, chunks)} of plane pl's LR slots."""
    w = hdr[LR0 + 8 * pl : LR0 + 8 * pl + 8].tolist()
    return {k: (w[2 * i], w[2 * i + 1]) for i, k in enumerate(KINDS)}


def _lr_pass(ptrs, dev, hdr, pl, kinds, *, ah, aw, ph, W, bpc):
    """The LrPass of plane pl's slots `kinds` on the (out, src, lpf)
    plane pointers `ptrs` of (ah, aw) int32 planes."""
    ch = lr_chunks(hdr, pl)
    a = LrPass(*ptrs, dev.data_ptr(), ah, aw, ph, W, bpc, len(kinds))
    first = 0
    for r, k in enumerate(kinds):
        base, n = ch[k]
        if n:
            _fits(dev, base, n * 16 * LRB, "an LR descriptor region")
        a.base[r], a.first[r] = base, first
        first += n * LRB
    a.first[len(kinds)] = first
    if not (0 <= ph <= ah) or W < 1 or bpc not in (8, 10, 12):
        raise ValueError(f"lr kernel: ph {ph} of {ah} rows, W {W}, bpc {bpc}")
    return a


def _lr_planes_check(out, src, lpf, dev, dim):
    _check(out, src, lpf, dev)
    if not (out.shape == src.shape == lpf.shape) or out.dim() != dim:
        raise ValueError("lr kernel: out, src and lpf must be "
                         + ("(ah, aw) planes" if dim == 2 else
                            "(3, ah, aw) planes"))


def lr_args(out, src, lpf, dev, hdr, pl, kinds, *, ph, W, bpc):
    """The LrPass of plane pl's slots `kinds` (("w",) or (0, 1, 2)): `out`
    its restored copy, `src` the post-CDEF plane and `lpf` the pre-CDEF
    plane, each (ah, aw); ph its visible rows; W the slot's tile width."""
    _lr_planes_check(out, src, lpf, dev, 2)
    ah, aw = out.shape
    return _lr_pass((out.data_ptr(), src.data_ptr(), lpf.data_ptr()), dev,
                    hdr, pl, kinds, ah=ah, aw=aw, ph=ph, W=W, bpc=bpc)


def lr_frame_args(out, src, lpf, dev, hdr, *, layout_i, phs, Ws, bpc,
                  kinds=(0, 1, 2)):
    """The LrFrame of a frame's self-guided stripes (`kinds` (0, 1, 2)) or
    Wiener stripes (("w",)): `out` the planes' restored copy, `src` the
    post-CDEF planes and `lpf` the pre-CDEF planes, each (3, ah, aw); phs
    and Ws each plane's visible rows and slot tile width. Its items: each
    plane's stripe slots (its kinds' regions) times the column blocks of
    its W. (Each plane's pointers are its tensor's plus the planes before
    it: one check and no view a plane, as the launch's host time counts.)"""
    _lr_planes_check(out, src, lpf, dev, 3)
    _, ah, aw = out.shape
    ptrs = (out.data_ptr(), src.data_ptr(), lpf.data_ptr())
    a = LrFrame()
    a.nplanes = 1 if layout_i == 0 else 3
    for p in range(a.nplanes):
        a.pl[p] = _lr_pass([q + 4 * p * ah * aw for q in ptrs], dev, hdr, p,
                           kinds, ah=ah, aw=aw, ph=phs[p], W=Ws[p], bpc=bpc)
        a.ncb[p] = -(-Ws[p] // LR_CW)
        a.item0[p + 1] = a.item0[p] + (a.pl[p].first[len(kinds)] * a.ncb[p]
                                       if phs[p] > 0 else 0)
    return a


def lr_planes(hdr, layout_i):
    """[(plane, Wiener stripes?, self-guided stripes?)] of the planes with
    LR stripes."""
    out = []
    for pl in range(1 if layout_i == 0 else 3):
        ch = lr_chunks(hdr, pl)
        w, s = bool(ch["w"][1]), any(ch[k][1] for k in (0, 1, 2))
        if w or s:
            out.append((pl, w, s))
    return out


def lr_launches(hdr, layout_i):
    """(Wiener launches, self-guided launches) of a frame: one if any
    plane has Wiener stripes, one if any plane has self-guided stripes."""
    planes = lr_planes(hdr, layout_i)
    return (int(any(w for _, w, _ in planes)),
            int(any(s for _, _, s in planes)))


def _launch(name, entry, a, t):
    if t.device.type != "cuda":
        raise ValueError(f"filter kernels: CUDA tensors only, got {t.device}")
    rc = getattr(lib(name), entry)(ctypes.byref(a),
                                   torch.cuda.current_stream(t.device)
                                   .cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: the launch failed (error {rc})")


def lf_pass(planes, dev, hdr, hor, *, bh, bw, layout_i, bpc):
    """One direction's deblocking of every plane of `planes` (3, ah, aw),
    in place: one launch of rav1d_deblock (exact where the pixels fit
    int16, as the decoder's always do: it stages the lines as int16)."""
    global lf_launches
    a = deblock_args(planes, dev, hdr, hor, bh=bh, bw=bw, layout_i=layout_i,
                     bpc=bpc)
    _launch("lf", "rav1d_deblock", a, planes)
    lf_launches += 1


def lf_pass_lines(planes, dev, hdr, hor, *, bh, bw, layout_i, bpc):
    """lf_pass through the earlier form, rav1d_lf_pass (a block per line):
    one launch."""
    global lf_lines_launches
    a = lf_args(planes, dev, hdr, hor, bh=bh, bw=bw, layout_i=layout_i,
                bpc=bpc)
    _launch("lf", "rav1d_lf_pass", a, planes)
    lf_lines_launches += 1


def cdef_frame(planes, pre, dev, hdr, *, bh, bw, layout_i, bpc):
    """CDEF of every plane: reads `pre`, writes the filtered units of
    `planes`: one launch of rav1d_cdef."""
    global cdef_launches
    a = cdef_args(planes, pre, dev, hdr, bh=bh, bw=bw, layout_i=layout_i,
                  bpc=bpc)
    _launch("cdef", "rav1d_cdef", a, planes)
    cdef_launches += 1


def cdef_frame_global(planes, pre, dev, hdr, *, bh, bw, layout_i, bpc):
    """cdef_frame through the earlier form, rav1d_cdef_frame (taps read
    from global memory): one launch."""
    global cdef_global_launches
    a = cdef_args(planes, pre, dev, hdr, bh=bh, bw=bw, layout_i=layout_i,
                  bpc=bpc)
    _launch("cdef", "rav1d_cdef_frame", a, planes)
    cdef_global_launches += 1


def superres_frame(planes, pre, hdr, *, cur_h, sr_geom, layout_i, bpc):
    """The upscale of every plane of `planes` and of the snapshot `pre`:
    one launch. Returns the (2, 3, s_ah, s_aw) output (the launch writes
    every cell): [0] the upscaled planes, [1] the upscaled snapshot."""
    global sr_launches
    out = torch.empty((2, 3) + tuple(sr_geom[:2]), dtype=I32,
                      device=planes.device)
    a = superres_args(out, planes, pre, hdr, cur_h=cur_h, sr_geom=sr_geom,
                      layout_i=layout_i, bpc=bpc)
    _launch("superres", "rav1d_superres_frame", a, out)
    sr_launches += 1
    return out


def lr_wiener_frame(out, src, lpf, dev, hdr, *, layout_i, phs, Ws, bpc):
    """Every Wiener stripe of every plane into `out` (3, ah, aw): one
    launch."""
    global wiener_launches
    a = lr_frame_args(out, src, lpf, dev, hdr, layout_i=layout_i, phs=phs,
                      Ws=Ws, bpc=bpc, kinds=("w",))
    _launch("lr", "rav1d_lr_wiener_frame", a, out)
    wiener_launches += 1


def lr_wiener_plane(out, src, lpf, dev, hdr, pl, *, ph, W, bpc):
    """Every Wiener stripe of plane pl into `out` through the earlier
    form, rav1d_lr_wiener: one launch."""
    global wiener_plane_launches
    a = lr_args(out, src, lpf, dev, hdr, pl, ("w",), ph=ph, W=W, bpc=bpc)
    _launch("lr", "rav1d_lr_wiener", a, out)
    wiener_plane_launches += 1


def lr_sgr_frame(out, src, lpf, dev, hdr, *, layout_i, phs, Ws, bpc):
    """Every self-guided stripe of every plane, all three kinds, into `out`
    (3, ah, aw): one launch."""
    global sgr_launches
    a = lr_frame_args(out, src, lpf, dev, hdr, layout_i=layout_i, phs=phs,
                      Ws=Ws, bpc=bpc)
    _launch("lr", "rav1d_lr_sgr_frame", a, out)
    sgr_launches += 1


def lr_sgr_plane(out, src, lpf, dev, hdr, pl, *, ph, W, bpc):
    """Every self-guided stripe of plane pl, all three kinds, into `out`
    through the earlier form, rav1d_lr_sgr: one launch."""
    global sgr_plane_launches
    a = lr_args(out, src, lpf, dev, hdr, pl, (0, 1, 2), ph=ph, W=W, bpc=bpc)
    _launch("lr", "rav1d_lr_sgr", a, out)
    sgr_plane_launches += 1
