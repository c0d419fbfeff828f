"""The post-filter kernels against the plain filter passes and the JAX
engine's, exactly.

csrc/lf.cu, csrc/cdef.cu and csrc/lr.cu compiled for the host with g++:
their host entries (rav1d_deblock_host and the earlier form's
rav1d_lf_pass_host, rav1d_cdef_host and the earlier rav1d_cdef_frame_host,
rav1d_lr_wiener_frame_host, rav1d_lr_sgr_frame_host and the earlier
per-plane rav1d_lr_wiener_host and rav1d_lr_sgr_host) walk the thread
blocks of a
launch with the kernels' own step functions, thread by thread, each
barrier a loop boundary (a thread's registers kept across it), shared
words and registers pre-filled with a pattern, on the arguments
ops/cuda/filters.py builds for the launch (`*_args`). The kernels
themselves build and run only on the card, where chip_smoke.py holds them
to their plain versions. Checked, the deblock, CDEF, Wiener and
self-guided cases for both forms ("new": the decoder path's entries;
"earlier"):

- deblock (`deblock_args`, `lf_args` over a hand-built blob): one
  direction's pass over all three planes against engine/filters.py
  lf_dir_pass per plane and rav1d_tpu's lf_dir_pass_raw (over
  ops/tpu/lf.py filter_lines_batch), both directions at 8, 10 and 12 bits
  (4:2:0, 4:2:2, 4:4:4): every width class, levels 0 and 63, cells whose
  windows cross the plane's left and right borders, flat and rough edges;
  and against lf_dir_pass alone: planes whose rows and columns are not a
  multiple of 4 or of the band (a plane edge inside a band, lines past
  the plane), bands of 4 and 8 columns, groups of 2 and 1 lines, 4:0:0
  (with chroma maps in the blob to ignore), runs of adjacent selected
  cells of one class (last-k-wins), a map with no selected cell, a
  class-2 write past the plane that a class-3 window reads;
- CDEF (`cdef_args`): the frame against cdef_pass and rav1d_tpu's
  cdef_pass_raw (find_dir_batch, cdef_filter_batch) in 4:2:0, 4:2:2 and
  4:4:4 at 8, 10 and 12 bits, damping 3-6 (and one below the packer's
  range, where the secondary shift is negative): all eight directions,
  units with the primary strength only, the secondary only, both and
  neither, a variance of 0, MISSING taps across each frame edge and the
  plane's, speckles whose filtered value the taps' range clamps; and
  against cdef_pass alone: several areas with odd bh and bw and a plane
  larger than the unit grid (the bottom and right frame edges inside the
  plane), 4:0:0, strength in chroma only, no strength at all, luma far
  past 8 bits (the direction costs wrap past 2^31);
- loop restoration (`lr_args`): Wiener and the self-guided kinds 0, 1
  and 2 against lr_wiener_pass / lr_sgr_pass and rav1d_tpu's
  lr_wiener_pass_raw / lr_sgr_pass_raw (wiener_batch, sgr_batch) at 8,
  10 and 12 bits, on stripes at the top, bottom, left and right of the
  frame, with S_W < W, S_W = W and S_W > W and S_H < 64, lpf rows from
  the pre-CDEF plane; 66 narrow stripes in two descriptor chunks; the
  Wiener stripes and the self-guided kinds each through their one-launch
  frame entry (blocks forwards and backwards) and the earlier per-plane
  one: three 4:4:4 planes also against wiener_batch and sgr_batch, 4:0:0
  (chroma stripes in the blob to ignore), 4:2:2 and 4:2:0, with a column
  range past the plane, lpf rows from cat row ph, no left context at x0 >
  0, S_W > W at a W of 48, and (self-guided) pixels up to 2^16 where the
  int32 arithmetic wraps;
- the kernels' constant tables and rav1d_cdef's packed direction tables
  against engine/consts.py and ops/cdef.py;
- engine/programs.py filter_kernels through the host entries (and
  csrc/superres.cu's, tests/test_torch_superres_kernel.py) against
  filter_plain on frames the other test files pack: the (136, 96) stills
  of tests/test_torch_programs.py, the 10-bit 4:2:2 deblock-tools frame of
  tests/test_torch_formats_programs.py, a 12-bit 4:4:4 and a 12-bit 4:0:0
  still and a superres still, with the launches the program makes;
  the 4:0:0 still against rav1d_tpu's mega.filter_prog;
- the wrappers' rules (the earlier forms' too): a CPU tensor raises and
  counts nothing; rav1d_deblock's block geometry;
  programs.filter_ on CPU tensors is filter_plain (engine/filters.py
  calls, no wrapper launch).

Inputs are seeded with numpy. Tolerance: exact.
"""

import ctypes
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.engine import filters as JF
from rav1d_tpu.engine import mega as JM
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.engine import filters as FL
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.blob import Uploader
from rav1d_tpu_torch.engine.consts import numpy_tables
from rav1d_tpu_torch.engine.layout import CDEF0, DB0, HDR_LEN, LR0, LRB
from rav1d_tpu_torch.engine.pack import pack_frame
from rav1d_tpu_torch.engine.run import stack_planes
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops import cdef as OC
from rav1d_tpu_torch.ops.cuda import filters as FK
from rav1d_tpu_torch.ops.ref.lf import calc_eih
from rav1d_tpu_torch.tables.spec_data import SGR_PARAMS

CSRC = os.path.join(os.path.dirname(FK.__file__), "..", "..", "csrc")
BPC_LAYOUT = {8: PL.I420, 10: PL.I422, 12: PL.I444}
_VOID = ctypes.c_void_p


def host_kernels(d):
    """The four sources compiled for the host with g++ into directory `d`
    and loaded, as a filter_kernels `k` that runs their host entries."""
    libs = {}
    for name in ("lf", "cdef", "superres", "lr"):
        so = os.path.join(d, f"lib{name}_host.so")
        subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                        "-fPIC", "-o", so, os.path.join(CSRC, name + ".cu")],
                       check=True)
        libs[name] = ctypes.CDLL(so)
    for fn in (libs["lf"].rav1d_deblock_host, libs["lf"].rav1d_lf_pass_host,
               libs["cdef"].rav1d_cdef_host, libs["cdef"].rav1d_cdef_frame_host,
               libs["superres"].rav1d_superres_frame_host,
               libs["lr"].rav1d_lr_wiener_host, libs["lr"].rav1d_lr_sgr_host,
               libs["cdef"].rav1d_cdef_tables_host,
               libs["cdef"].rav1d_cdef_area_tables_host,
               libs["superres"].rav1d_superres_table_host,
               libs["lr"].rav1d_lr_table_host):
        fn.argtypes = [_VOID]
        fn.restype = ctypes.c_int
    for fn in (libs["lr"].rav1d_lr_sgr_frame_host,
               libs["lr"].rav1d_lr_wiener_frame_host):
        fn.argtypes = [_VOID, ctypes.c_int]
        fn.restype = ctypes.c_int
    return HostKernels(libs)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return host_kernels(str(tmp_path_factory.mktemp("filters")))


FORMS = ["new", "earlier"]


class HostKernels:
    """ops/cuda/filters.py's launch wrappers with the host entries in place
    of the launches; `n` counts the calls per kernel. `form` "earlier"
    runs the earlier forms' entries for deblock, CDEF and the two loop
    restoration filters (lf_pass_lines, cdef_frame_global, lr_wiener_plane
    and lr_sgr_plane for each plane in place of lr_wiener_frame and
    lr_sgr_frame); `group` sets the deblock band; `reverse` runs the
    one-launch loop restoration entries' blocks from the last."""

    def __init__(self, libs, form="new", group=None, reverse=False):
        self.libs, self.form, self.group = libs, form, group
        self.reverse = reverse
        self.n = dict.fromkeys(("lf", "cdef", "sr", "wiener", "sgr",
                                "wiener_plane", "sgr_plane"), 0)

    def of(self, form, group=None, reverse=False):
        """The same libraries through another form."""
        return HostKernels(self.libs, form, group, reverse)

    def _run(self, lib, entry, a, key):
        assert getattr(self.libs[lib], entry)(ctypes.byref(a)) == 0
        self.n[key] += 1

    def lf_pass(self, planes, dev, hdr, hor, **kw):
        if self.form == "new":
            self._run("lf", "rav1d_deblock_host",
                      FK.deblock_args(planes, dev, hdr, hor, group=self.group,
                                      **kw), "lf")
        else:
            self._run("lf", "rav1d_lf_pass_host",
                      FK.lf_args(planes, dev, hdr, hor, **kw), "lf")

    def cdef_frame(self, planes, pre, dev, hdr, **kw):
        entry = ("rav1d_cdef_host" if self.form == "new"
                 else "rav1d_cdef_frame_host")
        self._run("cdef", entry, FK.cdef_args(planes, pre, dev, hdr, **kw),
                  "cdef")

    def superres_frame(self, planes, pre, hdr, **kw):
        """superres_frame's output, allocated as it allocates it and filled
        with a pattern first (the entry must write every cell)."""
        s_ah, s_aw = kw["sr_geom"][:2]
        out = torch.full((2, 3, s_ah, s_aw), 0x5A5A5A5A, dtype=torch.int32)
        self._run("superres", "rav1d_superres_frame_host",
                  FK.superres_args(out, planes, pre, hdr, **kw), "sr")
        return out

    def lr_wiener_plane(self, out, src, lpf, dev, hdr, pl, **kw):
        self._run("lr", "rav1d_lr_wiener_host",
                  FK.lr_args(out, src, lpf, dev, hdr, pl, ("w",), **kw),
                  "wiener_plane")

    def lr_sgr_plane(self, out, src, lpf, dev, hdr, pl, **kw):
        self._run("lr", "rav1d_lr_sgr_host",
                  FK.lr_args(out, src, lpf, dev, hdr, pl, (0, 1, 2), **kw),
                  "sgr_plane")

    def _lr_frame(self, sgr, out, src, lpf, dev, hdr, *, layout_i, phs, Ws,
                  bpc):
        if self.form == "earlier":  # one launch per plane with stripes
            plane = self.lr_sgr_plane if sgr else self.lr_wiener_plane
            for pl, w, s in FK.lr_planes(hdr, layout_i):
                if s if sgr else w:
                    plane(out[pl], src[pl], lpf[pl], dev, hdr, pl,
                          ph=phs[pl], W=Ws[pl], bpc=bpc)
            return
        a = FK.lr_frame_args(out, src, lpf, dev, hdr, layout_i=layout_i,
                             phs=phs, Ws=Ws, bpc=bpc,
                             kinds=(0, 1, 2) if sgr else ("w",))
        entry = ("rav1d_lr_sgr_frame_host" if sgr
                 else "rav1d_lr_wiener_frame_host")
        assert getattr(self.libs["lr"], entry)(ctypes.byref(a),
                                               int(self.reverse)) == 0
        self.n["sgr" if sgr else "wiener"] += 1

    def lr_wiener_frame(self, *a, **kw):
        self._lr_frame(False, *a, **kw)

    def lr_sgr_frame(self, *a, **kw):
        self._lr_frame(True, *a, **kw)


class Blob:
    """A hand-built frame blob: the header's words, then regions."""

    def __init__(self):
        self.hdr = np.zeros(HDR_LEN, np.int32)
        self.words = [np.zeros(HDR_LEN, np.int32)]
        self.pos = HDR_LEN

    def add(self, words):
        w = np.asarray(words, np.int32).reshape(-1)
        base = self.pos
        self.words.append(w)
        self.pos += w.size
        return base

    def add_u8(self, b):
        b = np.asarray(b, np.uint8).reshape(-1)
        return self.add(np.pad(b, (0, -b.size % 4)).view("<i4"))

    def dev(self):
        w = np.concatenate(self.words + [np.zeros(16, np.int32)])
        w[:HDR_LEN] = self.hdr
        return torch.from_numpy(w)


def _t(a):
    """A torch copy of a numpy array (the passes write their inputs)."""
    return torch.from_numpy(np.array(a, np.int32))


def _jit(fn, static):
    return jax.jit(fn, static_argnums=static)


_JLF = _jit(JF.lf_dir_pass_raw, (4, 5, 6))
_JCDEF = _jit(JF.cdef_pass_raw, tuple(range(2, 11)))
_JWIENER = _jit(JF.lr_wiener_pass_raw, (3, 4, 5))
_JSGR = _jit(JF.lr_sgr_pass_raw, (3, 4, 5, 6))


def _smooth(rng, shape, bpc, cell=4):
    """Pixels in range: a level per 16x16 region, a step of up to 4 << bd
    per (cell x cell) block, and noise of +-1 << bd on half of the blocks
    (the other half flat)."""
    bd = bpc - 8
    h, w = shape[-2:]
    lead = shape[:-2]
    coarse = rng.integers(0, 1 << bpc, lead + ((h + 15) // 16, (w + 15) // 16))
    steps = rng.integers(-4, 5, lead + ((h + cell - 1) // cell,
                                        (w + cell - 1) // cell)) << bd
    rough = rng.integers(0, 2, steps.shape)
    up = lambda a, k: a.repeat(k, -2).repeat(k, -1)[..., :h, :w]  # noqa: E731
    noise = rng.integers(-1, 2, shape) << bd
    v = up(coarse, 16) + up(steps, cell) + noise * up(rough, cell)
    return np.clip(v, 0, (1 << bpc) - 1).astype(np.int32)


def _ss(layout):
    return FK.subsampling(int(layout))


# -------------------------------- deblock --------------------------------


def _db_maps(rng, nh4, nw4):
    """(class, level) maps: every class, level 0 on some cells, 63 on
    others; the left and right border cells at width class 3."""
    cls = rng.integers(0, 4, (nh4, nw4))
    cls[:, 0] = 3
    cls[:, -1] = 3
    lvl = rng.integers(1, 63, (nh4, nw4))
    lvl[rng.random((nh4, nw4)) < 0.15] = 0
    lvl[rng.random((nh4, nw4)) < 0.15] = 63
    return cls.astype(np.int32), lvl.astype(np.int32)


def _deblock_blob(bpc, hor, maps):
    """A blob with the E/I luts of a filter level and one direction's
    `maps` [(class, level)] at their header slots."""
    e, i = calc_eih(bpc % 5)
    eih = np.array([e, i], np.int32)
    blob = Blob()
    blob.hdr[DB0] = blob.add(eih)
    for p, (cls, lvl) in enumerate(maps):
        blob.hdr[DB0 + 1 + 3 * hor + p] = blob.add_u8((cls << 6) | lvl)
    return blob, eih


def _deblock_shapes(layout, bh, bw, hor):
    """Each plane's (nh4, nw4) of one direction, as lf_args derives them."""
    ss_hor, ss_ver = _ss(layout)
    shapes = [(bh, bw), ((bh + ss_ver) >> ss_ver, (bw + ss_hor) >> ss_hor)]
    shapes = shapes[:1] if layout == PL.I400 else shapes + shapes[1:]
    return [(w, h) for h, w in shapes] if hor else shapes


def _deblock_plain(planes, maps, eih, hor, bpc):
    """One direction's plain passes (engine/filters.py lf_dir_pass)."""
    want = _t(planes)
    for p, (cls, lvl) in enumerate(maps):
        want[p] = FL.lf_dir_pass(want[p], _t(cls), _t(lvl), _t(eih), p == 0,
                                 hor, bpc)
    return want


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("hor", [False, True], ids=["vertical", "horizontal"])
@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_deblock_pass(host, bpc, hor, form):
    layout = BPC_LAYOUT[bpc]
    rng = np.random.default_rng(100 * bpc + hor)
    bh, bw = 10, 14
    ah, aw = 4 * bh, 4 * bw  # the luma edges reach the plane's borders
    planes = _smooth(rng, (3, ah, aw), bpc)
    maps = [_db_maps(rng, nh4, nw4)
            for nh4, nw4 in _deblock_shapes(layout, bh, bw, hor)]
    blob, eih = _deblock_blob(bpc, hor, maps)
    sel = np.concatenate([(c * (lv != 0)).ravel() for c, lv in maps])
    assert set(np.unique(sel)) == {0, 1, 2, 3}
    lv_sel = np.concatenate([lv[c != 0] for c, lv in maps])
    assert 63 in lv_sel and 0 in lv_sel

    want = _deblock_plain(planes, maps, eih, hor, bpc)
    jax_out = [np.asarray(_JLF(jnp.asarray(planes[p]), cls, lvl, eih, p == 0,
                               hor, bpc)) for p, (cls, lvl) in enumerate(maps)]
    np.testing.assert_array_equal(want.numpy(), np.stack(jax_out))
    got = _t(planes)
    host.of(form).lf_pass(got, blob.dev(), blob.hdr, hor, bh=bh, bw=bw,
                          layout_i=int(layout), bpc=bpc)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (want.numpy() != planes).sum() > 50


# (bpc, layout, bh, bw, (ah, aw) less (4 bh, 4 bw), lines per block of
# rav1d_deblock (None: its default), maps): "ragged" planes whose rows and
# columns are not a multiple of 4 or of the band (the last band crosses
# the plane's edge, the last map row's lines run past the plane), "runs"
# of adjacent selected cells of one class (each cell's left neighbours
# selected: last-k-wins on every pixel), groups of 4, 2 and 1 lines (a map
# row across blocks), 4:0:0, a map with no selected cell, and "pad": on a
# line 2 or 3 pixels short of its cells, the last cell's class-2 filter
# writes pixels past the plane that the class-3 cell before it reads
DEBLOCK_CASES = {
    "ragged": (8, PL.I420, 9, 13, (3, 2), None, "random"),
    "ragged-band4": (10, PL.I420, 9, 13, (3, 2), 4, "random"),
    "ragged-group2": (8, PL.I420, 9, 13, (3, 2), 2, "random"),
    "runs": (10, PL.I422, 10, 14, (0, 0), None, "runs"),
    "runs-group1": (12, PL.I422, 10, 14, (0, 0), 1, "runs"),
    "400": (12, PL.I400, 10, 14, (1, 6), None, "random"),
    "empty": (8, PL.I444, 6, 10, (0, 0), None, "empty"),
    "pad": (12, PL.I420, 9, 13, (3, 2), None, "pad"),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("hor", [False, True], ids=["vertical", "horizontal"])
@pytest.mark.parametrize("case", sorted(DEBLOCK_CASES))
def test_deblock_edges(host, case, hor, form):
    bpc, layout, bh, bw, (dh, dw), group, kind = DEBLOCK_CASES[case]
    rng = np.random.default_rng(sorted(DEBLOCK_CASES).index(case) * 2 + hor)
    ah, aw = 4 * bh - dh, 4 * bw - dw
    planes = _smooth(rng, (3, ah, aw), bpc)
    if kind == "pad":  # 12-bit luma of 0-16: every filter takes its flat
        # path, the windows that reach into the zero padding too
        planes[0] = rng.integers(0, 17, (ah, aw))
    maps = []
    for nh4, nw4 in _deblock_shapes(layout, bh, bw, hor):
        cls, lvl = _db_maps(rng, nh4, nw4)
        if kind == "runs":  # class 3 in runs of 3-6 cells, class 1 between
            run = (np.arange(nw4) % 7 < 5)[None, :]
            cls = np.where(run, 3, 1).repeat(nh4, 0).astype(np.int32)
            lvl = rng.integers(20, 63, (nh4, nw4)).astype(np.int32)
        elif kind == "empty":
            lvl[:] = 0
        elif kind == "pad":  # the last cell class 2, the one before class 3
            cls[:, -2:] = (3, 2)
            lvl[:, -2:] = 63
        maps.append((cls, lvl))
    blob, eih = _deblock_blob(bpc, hor, maps)
    if layout == PL.I400:  # chroma maps in the blob, which 4:0:0 ignores
        for p in (1, 2):
            cls, lvl = _db_maps(rng, *maps[0][0].shape)
            blob.hdr[DB0 + 1 + 3 * hor + p] = blob.add_u8((cls << 6) | lvl)
    want = _deblock_plain(planes, maps, eih, hor, bpc)
    got = _t(planes)
    host.of(form, group).lf_pass(got, blob.dev(), blob.hdr, hor, bh=bh,
                                 bw=bw, layout_i=int(layout), bpc=bpc)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    changed = (want.numpy() != planes).sum(axis=(1, 2))
    if kind == "empty":
        assert not changed.any()
    else:
        assert changed[0] > 20
        assert (changed[1:] > 0).all() == (layout != PL.I400)
    if case == "ragged" and hor:  # the last band is cut by the plane's edge
        a = FK.deblock_args(got, blob.dev(), blob.hdr, hor, bh=bh, bw=bw,
                            layout_i=int(layout), bpc=bpc)
        assert a.group == 8 and a.nlines[0] == aw and aw % 8


# --------------------------------- CDEF ----------------------------------

# orientation vectors of the luma units' line patterns
_ORIENT = [(0, 1), (1, 2), (1, 1), (2, 1), (1, 0), (2, -1), (1, -1), (1, -2)]


def _speckle(base, bd, shape):
    """A flat block with a bright pixel in every 4x4 (the filter's output
    overshoots the taps' range there, so the clamp to it decides)."""
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    return base + (((yy % 4 == 1) & (xx % 4 == 2)) * (2 << bd))


def _cdef_luma(rng, nby, nbx, ah, aw, bpc):
    """Luma whose 8x8 units carry lines of each orientation (so every
    direction wins somewhere), flat units (variance 0), speckles and
    noise."""
    bd = bpc - 8
    y = np.zeros((ah, aw), np.int64)
    yy, xx = np.mgrid[0:8, 0:8]
    for by in range(nby):
        for bx in range(nbx):
            k = (by * nbx + bx) % 11
            base = int(rng.integers(40, 200)) << bd
            if k < 8:
                a, b = _ORIENT[k]
                blk = base + ((((a * yy + b * xx) >> 1) & 3) * 9 << bd)
                blk = blk + (rng.integers(-1, 2, (8, 8)) << bd)
            elif k == 8:
                blk = np.full((8, 8), base)
            elif k == 9:
                blk = _speckle(base, bd, (8, 8))
            else:
                blk = base + (rng.integers(-12, 13, (8, 8)) << bd)
            y[by * 8 : by * 8 + 8, bx * 8 : bx * 8 + 8] = blk
    return np.clip(y, 0, (1 << bpc) - 1).astype(np.int32)


def _cdef_maps(lvl, bd):
    """(pri, sec) of level bytes, as the plain pass takes them."""
    s = lvl & 3
    return (lvl >> 2) << bd, np.where(s == 3, 4, s) << bd


def _cdef_run(host, form, planes, ylvl, uvlvl, damping, bh, bw, layout, bpc):
    """The frame through the host entry of `form` and through cdef_pass:
    (got, want, the plain pass's arguments and maps)."""
    bd = bpc - 8
    nby, nbx = ylvl.shape
    ss_hor, ss_ver = _ss(layout)
    blob = Blob()
    blob.hdr[CDEF0] = blob.add_u8(ylvl)
    blob.hdr[CDEF0 + 1] = blob.add_u8(uvlvl)
    blob.hdr[CDEF0 + 2] = damping
    maps = np.stack([*_cdef_maps(ylvl, bd), uvlvl,
                     *_cdef_maps(uvlvl, bd)]).astype(np.int32)
    uv422 = -1 if layout == PL.I400 else (1 if layout == PL.I422 else 0)
    args = (damping, nby, nbx, bh, bw, ss_hor, ss_ver, uv422, bpc)
    want = _t(planes)
    FL.cdef_pass(want, _t(maps), *args)
    got = _t(planes)
    host.of(form).cdef_frame(got, _t(planes), blob.dev(), blob.hdr, bh=bh,
                             bw=bw, layout_i=int(layout), bpc=bpc)
    return got, want, args, maps


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("layout", [PL.I420, PL.I422, PL.I444],
                         ids=lambda v: v.name)
@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_cdef_frame(host, bpc, layout, form):
    rng = np.random.default_rng(7 * bpc + int(layout))
    bd = bpc - 8
    bh, bw = 11, 15  # the last unit row and column have no bottom / right
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    ah, aw = 8 * nby, 8 * nbx  # the last units' taps cross the plane's edge
    speck = _speckle(0, bd, (ah, aw)) * (rng.random((ah, aw)) < 0.5)
    planes = np.stack([_cdef_luma(rng, nby, nbx, ah, aw, bpc)]
                      + [np.minimum(_smooth(rng, (ah, aw), bpc) + speck,
                                    (1 << bpc) - 1) for _ in range(2)])
    # per unit: neither strength, the primary only, the secondary only, both
    kind = rng.integers(0, 4, (nby, nbx))
    pri = np.where(kind & 1, rng.integers(1, 16, (nby, nbx)), 0)
    sec = np.where(kind & 2, rng.integers(1, 4, (nby, nbx)), 0)
    ylvl = (pri << 2) | sec
    ukind = rng.integers(0, 4, (nby, nbx))
    uvlvl = ((np.where(ukind & 1, rng.integers(1, 16, (nby, nbx)), 0) << 2)
             | np.where(ukind & 2, rng.integers(1, 4, (nby, nbx)), 0))
    # the header's damping is the frame's (3-6) + bd (pack.py _pack_cdef);
    # at 12-bit 4:4:4 it is 3, below what the packer writes, so that the
    # secondary shift goes negative (a right shift that fills with the sign)
    damping = 3 + (bpc + int(layout)) % 4 + bd
    if (bpc, layout) == (12, PL.I444):
        damping = 3

    blocks = _t(planes[0].reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
                .reshape(-1, 8, 8))
    dirs, var = OC.find_dir_batch(blocks, bpc)
    assert set(dirs.tolist()) == set(range(8)) and (var == 0).any()
    assert set(kind.ravel()) == {0, 1, 2, 3} == set(ukind.ravel())

    got, want, args, maps = _cdef_run(host, form, planes, ylvl, uvlvl,
                                      damping, bh, bw, layout, bpc)
    np.testing.assert_array_equal(
        want.numpy(), np.asarray(_JCDEF(jnp.asarray(planes), maps, *args)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for p in range(3):
        assert (want.numpy()[p] != planes[p]).sum() > 20


# (bpc, layout, bh, bw, plane rows and columns past the unit grid,
# strengths): "areas", several 64x64 areas at odd bh and bw with the
# frame's bottom and right edges inside the plane (the last unit row's and
# column's taps past them are MISSING though the plane has pixels there);
# 4:0:0; strength in chroma only (the direction still searched); no
# strength anywhere; "wide" luma values far past 8 bits, where the
# direction costs wrap in int32 and compare unsigned
CDEF_CASES = {
    "areas": (8, PL.I420, 35, 37, (5, 3), "both"),
    "400": (12, PL.I400, 19, 21, (8, 0), "both"),
    "chroma-only": (10, PL.I422, 19, 21, (0, 0), "chroma"),
    "none": (8, PL.I444, 11, 15, (0, 0), "none"),
    "wide": (8, PL.I420, 11, 15, (0, 0), "wide"),
}


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", sorted(CDEF_CASES))
def test_cdef_cases(host, case, form):
    bpc, layout, bh, bw, (dh, dw), which = CDEF_CASES[case]
    rng = np.random.default_rng(40 + sorted(CDEF_CASES).index(case))
    bd = bpc - 8
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    ah, aw = 8 * nby + dh, 8 * nbx + dw
    planes = np.stack([_smooth(rng, (ah, aw), bpc) for _ in range(3)])
    planes[0, : 8 * nby, : 8 * nbx] = _cdef_luma(rng, nby, nbx, 8 * nby,
                                                 8 * nbx, bpc)
    lv = rng.integers(0, 64, (2, nby, nbx)) * (rng.random((2, nby, nbx)) < .8)
    ylvl, uvlvl = lv[0] * (which != "chroma"), lv[1]
    if which == "none":
        ylvl, uvlvl = ylvl * 0, uvlvl * 0
    if which == "wide":  # luma far past 8 bits: the costs wrap past 2^31;
        # the directions steer chroma
        planes[0] = rng.integers(0, 1 << 22, planes[0].shape)
    if layout == PL.I400:
        planes[1:] = 0
    damping = 3 + bpc % 4 + bd
    got, want, *_ = _cdef_run(host, form, planes, ylvl, uvlvl, damping, bh,
                              bw, layout, bpc)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    changed = (want.numpy() != planes).sum(axis=(1, 2))
    assert (changed[0] > 0) == (which == "both")  # wide: every tap too far
    assert (changed[1:] > 0).all() == (which != "none" and layout != PL.I400)
    if which == "wide":  # some units' costs compare otherwise signed
        blocks = _t(planes[0].reshape(nby, 8, nbx, 8).transpose(0, 2, 1, 3)
                    .reshape(-1, 8, 8))
        px = (blocks.numpy().astype(np.int64) - 128).reshape(-1, 8, 8)
        rows = (px.sum(2) ** 2).sum(1) * 105  # cost 2 before the wrap
        assert ((rows & 0xFFFFFFFF) >= 1 << 31).any()
    if case == "areas":  # a unit row and column of the last areas filter
        assert (want.numpy()[0, 8 * (nby - 1) :] != planes[0, 8 * (nby - 1) :]
                ).any()
        assert (want.numpy()[0, :, 8 * (nbx - 1) :]
                != planes[0, :, 8 * (nbx - 1) :]).any()


# ---------------------------------- LR -----------------------------------

LR_AH, LR_AW, LR_PH, LR_VW, LR_W = 136, 208, 130, 200, 96


def _stripe(x0, y0, w, h, params):
    """A stripe descriptor as the packer writes one (pack.py _collect_lr)
    for a unit at (x0, y0) of a LR_VW x LR_PH plane: no lpf rows above the
    first stripe or below the last, the lpf rows of the pre-CDEF plane
    (cat rows >= LR_PH) elsewhere."""
    ph = LR_PH
    have_l, have_r = x0 > 0, x0 + w < LR_VW
    xlo, xhi = x0 - 3 * have_l, x0 + w - 1 + 3 * have_r
    top = (y0, y0) if y0 == 0 else (ph + y0 - 2, ph + y0 - 1)
    below = y0 + h
    below2 = below if below + 1 == ph else below + 1
    bot = ((y0 + h - 1, y0 + h - 1) if below == ph
           else (ph + below, ph + below2))
    return [x0, y0, w, h, xlo, xhi, *top, *bot, *params]


def _lr_params(rng, kind):
    if kind == "w":
        lo, hi = (-5, -23, -17), (10, 8, 46)
        return [int(rng.integers(a, b + 1)) for a, b in zip(lo + lo, hi + hi)]
    row = SGR_PARAMS[int(rng.integers(0, 10)) if kind == 0 else
                     int(rng.integers(10, 14)) if kind == 1 else
                     int(rng.integers(0, 10))]
    s0, s1 = int(row[0]), int(row[1])
    # weights in the spec's ranges, the 5x5 one away from 0 so that every
    # stripe changes
    w0 = int(rng.choice([-96, -60, -25, 20, 31]))
    w1 = int(rng.integers(-32, 96))
    return [s0, s1, w0, 128 - w0 - w1, 0, 0]


def _lr_case(rng, kind, narrow=False):
    """Stripe descriptors (16, n): top-left, top-right, a middle stripe with
    lpf rows on both sides and S_W > W (the plain version writes its first
    W columns), one at the right, a bottom stripe with S_W = W and S_H <
    64; or, `narrow`, 66 stripes 3 columns wide (two chunks)."""
    if narrow:
        cols = [_stripe(3 * i, 56, 3, 8, _lr_params(rng, kind))
                for i in range(66)]
    else:
        cols = [_stripe(0, 0, 64, 56, _lr_params(rng, kind)),
                _stripe(136, 0, 64, 56, _lr_params(rng, kind)),
                _stripe(64, 56, LR_W + 8, 64, _lr_params(rng, kind)),
                _stripe(168, 56, 32, 64, _lr_params(rng, kind)),
                _stripe(8, 120, LR_W, 10, _lr_params(rng, kind))]
    return np.asarray(cols, np.int32).T


def _lr_check(host, bpc, kind, d, form="new"):
    rng = np.random.default_rng(bpc * 31 + (9 if kind == "w" else kind))
    src = _smooth(rng, (LR_AH, LR_AW), bpc, cell=8)
    lpf = _smooth(rng, (LR_AH, LR_AW), bpc, cell=8)
    n = d.shape[1]
    nc = (n + LRB - 1) // LRB
    chunks = np.zeros((16, nc * LRB), np.int32)
    chunks[:, :n] = d
    blob = Blob()
    ki = FK.KINDS.index(kind)
    blob.hdr[LR0 + 2 * ki] = blob.add(
        chunks.reshape(16, nc, LRB).transpose(1, 0, 2))
    blob.hdr[LR0 + 2 * ki + 1] = nc
    dd = _t(chunks)
    cat = np.concatenate([src[:LR_PH], lpf[:LR_PH]])

    pf = torch.cat([_t(src).reshape(-1), torch.zeros(1, dtype=torch.int32)])
    if kind == "w":
        FL.lr_wiener_pass(pf, _t(cat), dd, LR_W, bpc, LR_AW)
        jout = _JWIENER(jnp.asarray(src.ravel()), cat, chunks, LR_W, bpc, LR_AW)
    else:
        FL.lr_sgr_pass(pf, _t(cat), dd, LR_W, kind, bpc, LR_AW)
        jout = _JSGR(jnp.asarray(src.ravel()), cat, chunks, LR_W, kind, bpc,
                     LR_AW)
    want = pf[:-1].view(LR_AH, LR_AW)
    np.testing.assert_array_equal(want.numpy().ravel(), np.asarray(jout))
    got = _t(src)
    # the earlier form's entry, or the frame entry over one plane (4:0:0)
    k = host.of(form)
    (k.lr_wiener_frame if kind == "w" else k.lr_sgr_frame)(
        got[None], _t(src)[None], _t(lpf)[None], blob.dev(), blob.hdr,
        layout_i=0, phs=(LR_PH,), Ws=(LR_W,), bpc=bpc)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    changed = want.numpy() != src
    for x0, y0, w, h in d[:4].T:
        assert changed[y0 : y0 + h, x0 : x0 + min(w, LR_W)].any()
    assert not changed[LR_PH:].any() and not changed[:, LR_VW:].any()
    if d.shape[1] == 5:  # the columns past W of the S_W > W stripe
        assert not changed[56:120, 64 + LR_W : 168].any()


# every kind through both forms (the one-launch frame entries and the
# earlier per-plane entries)
LR_FORMS = [(k, f) for k in ("w", 0, 1, 2) for f in FORMS]


@pytest.mark.parametrize("kind,form", LR_FORMS,
                         ids=lambda v: f"kind-{v}" if v not in FORMS else v)
@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_lr_stripes(host, bpc, kind, form):
    _lr_check(host, bpc, kind, _lr_case(np.random.default_rng(bpc), kind),
              form)


def test_lr_two_chunks(host):
    """66 narrow stripes: the second descriptor chunk, the region walk,
    through the Wiener frame entry and the earlier per-plane one."""
    for form in FORMS:
        _lr_check(host, 10, "w", _lr_case(np.random.default_rng(3), "w", True),
                  form)


# the planes of the frame cases: (vw, ph) of luma and chroma by layout
def _lr_planes_geom(layout):
    ss_hor, ss_ver = _ss(layout)
    n = 1 if layout == PL.I400 else 3
    return [(LR_VW, LR_PH) if p == 0 else
            ((LR_VW + ss_hor) >> ss_hor, (LR_PH + ss_ver) >> ss_ver)
            for p in range(n)]


# the extra stripes of the frame cases, by (plane, kind): a column range
# past the plane ("range"), a stripe at row 2 (lpf rows from cat row ph)
# with no left context at x0 > 0 ("row2"), S_W > W ("wide")
SGR_EXTRAS = {(0, 0): ("range",), (0, 1): ("row2",), (1, 2): ("wide",)}
WIENER_EXTRAS = {(0, "w"): ("range", "row2"), (1, "w"): ("wide",)}


def _lr_frame_case(layout, bpc, seed, kinds, extras, Ws, big=False):
    """Stripes of each of `kinds` in every plane of a layout, none sharing
    a pixel: per plane and kind one at the top, where the plane is tall
    enough one in the middle with lpf rows on both sides, and one of 10
    rows at the bottom right (4:0:0: in the chroma slots too, as 4:2:0
    would have them, for the launch to ignore); and `extras` (SGR_EXTRAS,
    WIENER_EXTRAS): in luma a column range past the plane and a stripe at
    row 2 with no left context, in the first chroma plane a stripe wider
    than its W (Ws[1]). `big`: pixels of up to 2^16, where the squares,
    the box sums of squares and the scaled variance wrap past 2^31.
    Returns (blob, src, lpf, {(plane, kind): (16, LRB) descriptors},
    phs)."""
    rng = np.random.default_rng(seed)
    blob = Blob()
    geo = _lr_planes_geom(PL.I420 if layout == PL.I400 else layout)
    descs = {}
    for p, (vw, ph) in enumerate(geo):
        for ki, kind in enumerate(kinds):
            def stripe(x0, y0, w, h):  # _stripe on this plane
                hl, hr = x0 > 0, x0 + w < vw
                top = (y0, y0) if y0 == 0 else (ph + y0 - 2, ph + y0 - 1)
                below = y0 + h
                bot = ((below - 1, below - 1) if below == ph else
                       (ph + below, ph + (below if below + 1 == ph
                                          else below + 1)))
                return [x0, y0, w, h, x0 - 3 * hl, x0 + w - 1 + 3 * hr,
                        *top, *bot, *_lr_params(rng, kind)]
            x = 16 * ki
            cols = [stripe(x, 0, 16, 56 if ph > 120 else 40)]
            if ph > 120:
                cols.append(stripe(x + 48, 56, 16, 64))
            cols.append(stripe(vw - 24 * (ki + 1), ph - 10, 24, 10))
            for extra in extras.get((p, kind), ()):
                if extra == "range":  # up to the plane's last column, with
                    cols.append(stripe(LR_AW - 24, 10, 24, 6))  # a column
                    cols[-1][5] = LR_AW + 2  # range past it
                elif extra == "row2":  # lpf rows from cat row ph on; no
                    cols.append(stripe(104, 2, 16, 6))  # left context at
                    cols[-1][4] = 104  # x0 > 0
                else:  # S_W > W
                    cols.append(stripe(48, 8, Ws[1] + 4, 8))
            d = np.asarray(cols, np.int32).T
            chunks = np.zeros((16, LRB), np.int32)
            chunks[:, : d.shape[1]] = d
            i = 4 * p + FK.KINDS.index(kind)
            blob.hdr[LR0 + 2 * i] = blob.add(
                chunks.reshape(16, 1, LRB).transpose(1, 0, 2))
            blob.hdr[LR0 + 2 * i + 1] = 1
            descs[p, kind] = chunks
    src = np.stack([_smooth(rng, (LR_AH, LR_AW), bpc, cell=8)
                    for _ in range(3)])
    lpf = np.stack([_smooth(rng, (LR_AH, LR_AW), bpc, cell=8)
                    for _ in range(3)])
    if big:
        src = src * 193 + rng.integers(0, 1 << 12, src.shape)
        lpf = lpf * 151 + rng.integers(0, 1 << 12, lpf.shape)
    phs = tuple(ph for _, ph in geo)
    return blob, src, lpf, descs, phs


def _lr_frame_check(host, layout, bpc, seed, kinds, Ws, jax_too=False,
                    big=False):
    """One frame entry's host call over every plane (the self-guided one
    for `kinds` (0, 1, 2), the Wiener one for ("w",)), its items in order
    and in reverse, against each plane's plain lr_sgr_pass /
    lr_wiener_pass calls (and rav1d_tpu's lr_sgr_pass_raw /
    lr_wiener_pass_raw, `jax_too`), and against the earlier per-plane
    entry. Returns the pixels the plain passes changed."""
    sgr = kinds != ("w",)
    blob, src, lpf, descs, phs = _lr_frame_case(
        layout, bpc, seed, kinds, SGR_EXTRAS if sgr else WIENER_EXTRAS, Ws,
        big)
    n = len(_lr_planes_geom(layout))
    want = _t(src)
    for p in range(n):
        cat = np.concatenate([src[p][: phs[p]], lpf[p][: phs[p]]])
        pf = torch.cat([_t(src[p]).reshape(-1),
                        torch.zeros(1, dtype=torch.int32)])
        jout = jnp.asarray(src[p].ravel())
        for kind in kinds:
            if sgr:
                FL.lr_sgr_pass(pf, _t(cat), _t(descs[p, kind]), Ws[p], kind,
                               bpc, LR_AW)
                if jax_too:
                    jout = _JSGR(jout, cat, descs[p, kind], Ws[p], kind, bpc,
                                 LR_AW)
            else:
                FL.lr_wiener_pass(pf, _t(cat), _t(descs[p, kind]), Ws[p],
                                  bpc, LR_AW)
                if jax_too:
                    jout = _JWIENER(jout, cat, descs[p, kind], Ws[p], bpc,
                                    LR_AW)
        want[p] = pf[:-1].view(LR_AH, LR_AW)
        if jax_too:
            np.testing.assert_array_equal(want[p].numpy().ravel(),
                                          np.asarray(jout))
        assert (want[p].numpy() != src[p]).any()
    kw = dict(layout_i=int(layout), phs=phs, Ws=Ws, bpc=bpc)
    for k in (host, host.of("new", reverse=True), host.of("earlier")):
        got = _t(src)
        (k.lr_sgr_frame if sgr else k.lr_wiener_frame)(
            got, _t(src), _t(lpf), blob.dev(), blob.hdr, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert FK.lr_launches(blob.hdr, int(layout)) == ((0, 1) if sgr
                                                     else (1, 0))
    return want.numpy() != src


def _sgr_frame_check(host, layout, bpc, seed, jax_too=False, big=False):
    """The self-guided frame entry over every plane (_lr_frame_check), the
    chroma planes' W 48."""
    _lr_frame_check(host, layout, bpc, seed, (0, 1, 2), (LR_W, 48, 48),
                    jax_too, big)


def _wiener_frame_check(host, layout, bpc, seed, Ws, jax_too=False):
    """The Wiener frame entry over every plane (_lr_frame_check): every
    plane changes but its rows past ph, and the S_W > W stripe's columns
    past W stay as they were."""
    changed = _lr_frame_check(host, layout, bpc, seed, ("w",), Ws, jax_too)
    geo = _lr_planes_geom(layout)
    n = len(geo)
    for p, (_, ph) in enumerate(geo):
        assert changed[p].any() and not changed[p, ph:].any()
    if n > 1:  # the S_W > W stripe: its first W columns only
        assert changed[1, 8:16, 48 : 48 + Ws[1]].any()
        assert not changed[1, 8:16, 48 + Ws[1] : 52 + Ws[1]].any()
    assert not changed[n:].any()


def test_lr_sgr_frame_three_planes(host):
    """Every kind in all three planes of a 4:4:4 frame in one launch, against
    the plain passes and rav1d_tpu's sgr_batch."""
    _sgr_frame_check(host, PL.I444, 10, 21, jax_too=True)


def test_lr_sgr_frame_wraps(host):
    """Pixels of up to 2^16 in a 4:2:0 frame: the squares, their box sums
    and the scaled variance wrap as the plain version's int32 arithmetic
    does; against rav1d_tpu's sgr_batch too."""
    _sgr_frame_check(host, PL.I420, 8, 25, jax_too=True, big=True)


@pytest.mark.parametrize("layout", [PL.I400, PL.I422, PL.I420],
                         ids=lambda v: v.name)
def test_lr_sgr_frame_layouts(host, layout):
    """The one-launch entry over 4:0:0 (one plane), 4:2:2 chroma (full
    height, half width) and 4:2:0 chroma planes."""
    _sgr_frame_check(host, layout, 8 + 2 * int(layout), 22 + int(layout))


def test_lr_wiener_frame_three_planes(host):
    """Wiener stripes in all three planes of a 4:4:4 frame in one launch,
    against the plain passes and rav1d_tpu's wiener_batch (at the W of
    test_lr_stripes' compile)."""
    _wiener_frame_check(host, PL.I444, 10, 31, (LR_W,) * 3, jax_too=True)


@pytest.mark.parametrize("layout", [PL.I400, PL.I422, PL.I420],
                         ids=lambda v: v.name)
def test_lr_wiener_frame_layouts(host, layout):
    """The one-launch Wiener entry over 4:0:0 (one plane; chroma stripes in
    the blob to ignore), 4:2:2 chroma (full height, half width) and 4:2:0
    chroma planes, chroma's W of 48 no multiple of 32."""
    _wiener_frame_check(host, layout, 8 + 2 * int(layout), 32 + int(layout),
                        (LR_W, 48, 48))


def test_constant_tables(host):
    """The kernels' constant tables are the plain versions' tables."""
    t = np.zeros(112, np.int32)
    assert host.libs["cdef"].rav1d_cdef_tables_host(t.ctypes.data) == 112
    offs = np.array([OC._PRI_OFF, OC._SEC1_OFF, OC._SEC2_OFF]).ravel()
    np.testing.assert_array_equal(t[:96], offs)
    np.testing.assert_array_equal(t[96:], numpy_tables()["uv_dirs"].ravel())
    # rav1d_cdef's offsets (from packed literals) and 4:2:2 chroma directions
    a = np.zeros(112, np.int32)
    assert host.libs["cdef"].rav1d_cdef_area_tables_host(a.ctypes.data) == 112
    np.testing.assert_array_equal(a, t)
    x = np.zeros(256, np.int32)
    assert host.libs["lr"].rav1d_lr_table_host(x.ctypes.data) == 256
    np.testing.assert_array_equal(x, numpy_tables()["sgr_x_by_x"])


# ------------------------------ whole frames ------------------------------


def _formats_packets():
    from test_torch_formats_programs import COMBOS

    return COMBOS["10bit-422-lf-tools"][0]()


# name: (packets, index of the frame)
FRAMES = {
    "8bit-420-s10": (lambda: [synth.still_picture(136, 96, 10)], 0),
    "8bit-420-s6": (lambda: [synth.still_picture(136, 96, 6)], 0),
    "10bit-422-lf-tools": (_formats_packets, 1),
    "12bit-444": (lambda: [synth.still_picture(136, 96, 4, bpc=12,
                                               layout=PL.I444)], 0),
    "12bit-400": (lambda: [synth.still_picture(136, 96, 5, bpc=12,
                                               layout=PL.I400)], 0),
    "8bit-420-superres": (lambda: [synth.still_picture(136, 96, 10,
                                                       superres=True)], 0),
}


class Frame:
    """Frame i of `packets`: its blob and its filter program's input (the
    port's plain resid, inter and wave programs), and the program's
    statics."""

    def __init__(self, packets, i):
        f, plan = synth.capture_frames(packets)[i]
        pk = self.pk = pack_frame(f, plan)
        ah, aw, bpc = plan.ah, plan.aw, f.cur.bpc
        self.dev, _ = Uploader("cpu").upload(pk, ah * aw, bpc)
        layout = f.cur.layout
        ss_hor, ss_ver = _ss(layout)
        out = f.sr_cur
        ach, acw = out.u.shape if out.u is not None else (0, 0)
        ra, planes = P.resid(self.dev, pk.hdr, pk.tx_valid, ah=ah, aw=aw,
                             bpc=bpc)
        if pk.srcs is not None:
            planes = P.inter(planes, ra, self.dev, pk.hdr, pk.inter_runs,
                             stack_planes(pk.srcs[0], "cpu", (ah, aw)),
                             stack_planes(pk.srcs[1], "cpu", (ach, acw)),
                             ah=ah, aw=aw, bpc=bpc, vwY=f.cur.w, vhY=f.cur.h,
                             vwC=(f.cur.w + ss_hor) >> ss_hor,
                             vhC=(f.cur.h + ss_ver) >> ss_ver)
        self.planes = P.wave(planes, ra, self.dev, pk.hdr, pk.waves, ah=ah,
                             aw=aw, bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
        self.layout, self.bpc = int(layout), bpc
        sr = (out.y.shape + (out.w, out.h, 4 * f.bw)) if pk.need_sr else None
        self.kw = dict(geom=(ah, aw, ach, acw, f.bh, f.bw, f.cur.h), bpc=bpc,
                       layout_i=self.layout, lr_ws=pk.lr_ws, sr_geom=sr)

    def plain(self):
        return P.filter_plain(self.planes.clone(), self.dev, self.pk.hdr,
                              **self.kw)


def plain_lr_calls(hdr, layout_i):
    """The plain LR passes filter_plain makes on a frame: one per plane
    and kind with stripes."""
    return sum(bool(FK.lr_chunks(hdr, p)[k][1])
               for p in range(1 if layout_i == 0 else 3) for k in FK.KINDS)


@functools.lru_cache(maxsize=None)
def frame_of(name):
    packets, i = FRAMES[name]
    return Frame(packets(), i)


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_filter_program_matches_plain(host, name):
    frame = frame_of(name)
    planes, packed = frame.plain()
    n0, c0 = dict(host.n), FL.calls
    got, got_packed = P.filter_kernels(frame.planes.clone(), frame.dev,
                                       frame.pk.hdr, k=host, **frame.kw)
    np.testing.assert_array_equal(got.numpy(), planes.numpy())
    np.testing.assert_array_equal(got_packed.numpy(), packed.numpy())
    w, s = FK.lr_launches(frame.pk.hdr, frame.layout)
    sr = int(frame.kw["sr_geom"] is not None)
    assert sr == (name == "8bit-420-superres")
    assert {k: host.n[k] - n0[k] for k in n0} == dict(
        lf=2, cdef=1, sr=sr, wiener=w, sgr=s, wiener_plane=0, sgr_plane=0)
    lr = FK.lr_planes(frame.pk.hdr, frame.layout)
    assert (w, s) == (int(any(p for _, p, _ in lr)),
                      int(any(p for _, _, p in lr)))
    assert FL.calls == c0
    assert w + s > 0 or name == "10bit-422-lf-tools"


def test_filter_program_matches_jax_filter_prog(host):
    """The 12-bit 4:0:0 still against mega.filter_prog (its blob is the
    port's, word-identical to run2's: tests/test_torch_formats_programs.py)."""
    frame = frame_of("12bit-400")
    got, packed = P.filter_kernels(frame.planes.clone(), frame.dev,
                                   frame.pk.hdr, k=host, **frame.kw)
    kw = dict(frame.kw)
    planes_j, packed_j = JM.filter_prog(
        jnp.asarray(frame.planes.numpy()), jnp.asarray(frame.dev.numpy()),
        need_sr=False, **kw)
    np.testing.assert_array_equal(packed.numpy().view(np.uint16),
                                  np.asarray(packed_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(planes_j))


# ------------------------------ the wrappers ------------------------------


def test_cpu_filter_runs_the_plain_version():
    """programs.filter_ on CPU tensors is filter_plain: the plain passes run
    (engine/filters.py calls) and no wrapper launches or counts."""
    frame = frame_of("8bit-420-s10")
    launches = (FK.lf_launches, FK.cdef_launches, FK.wiener_launches,
                FK.sgr_launches, FK.wiener_plane_launches)
    c0 = FL.calls
    planes, packed = P.filter_(frame.planes.clone(), frame.dev, frame.pk.hdr,
                               **frame.kw)
    want, want_packed = frame.plain()
    np.testing.assert_array_equal(planes.numpy(), want.numpy())
    np.testing.assert_array_equal(packed.numpy(), want_packed.numpy())
    lr = plain_lr_calls(frame.pk.hdr, frame.layout)
    assert FL.calls - c0 == 2 * (6 + 1 + lr)  # filter_ and frame.plain
    assert (FK.lf_launches, FK.cdef_launches, FK.wiener_launches,
            FK.sgr_launches, FK.wiener_plane_launches) == launches


def test_wrappers_take_cuda_tensors_only():
    """Each wrapper, the earlier forms' too, raises on CPU tensors before
    any launch, and counts nothing; its arguments are built as for the
    card."""
    frame = frame_of("8bit-420-s10")
    hdr, dev, kw = frame.pk.hdr, frame.dev, frame.kw
    _, _, _, _, bh, bw, vis_h = kw["geom"]
    planes = frame.planes.clone()
    k = dict(bh=bh, bw=bw, layout_i=frame.layout, bpc=8)
    lw = dict(ph=vis_h, W=kw["lr_ws"][0], bpc=8)

    def counts():
        return (FK.lf_launches, FK.cdef_launches, FK.wiener_launches,
                FK.sgr_launches, FK.lf_lines_launches,
                FK.cdef_global_launches, FK.wiener_plane_launches,
                FK.sgr_plane_launches)

    before = counts()
    calls = [
        lambda: FK.lf_pass(planes, dev, hdr, False, **k),
        lambda: FK.lf_pass(planes, dev, hdr, True, **k),
        lambda: FK.lf_pass_lines(planes, dev, hdr, True, **k),
        lambda: FK.cdef_frame(planes, planes.clone(), dev, hdr, **k),
        lambda: FK.cdef_frame_global(planes, planes.clone(), dev, hdr, **k),
        lambda: FK.lr_wiener_plane(planes[0], planes[0], planes[0], dev, hdr,
                                   0, **lw),
        lambda: FK.lr_wiener_frame(planes, planes, planes, dev, hdr,
                                   layout_i=frame.layout, phs=(vis_h,) * 3,
                                   Ws=kw["lr_ws"][:1] * 3, bpc=8),
        lambda: FK.lr_sgr_plane(planes[0], planes[0], planes[0], dev, hdr, 0,
                                **lw),
        lambda: FK.lr_sgr_frame(planes, planes, planes, dev, hdr,
                                layout_i=frame.layout, phs=(vis_h,) * 3,
                                Ws=kw["lr_ws"][:1] * 3, bpc=8),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert counts() == before
    a = FK.lf_args(planes, dev, hdr, True, **k)
    # the horizontal pass's lines: the luma plane's 4 * bw columns, then
    # each 4:2:0 chroma plane's
    assert (a.nplanes, a.hor, a.first[3]) == (3, 1, 4 * bw + 8 * ((bw + 1) >> 1))
    # rav1d_deblock: bands of 8 columns (4:2:0 chroma planes have half the
    # lines), each block's threads covering its cells; rows: one map row a
    # block
    _, ah, aw = planes.shape
    for hor, g, lines in ((True, 8, aw), (False, 4, ah)):
        a = FK.deblock_args(planes, dev, hdr, hor, **k)
        nl = [min(4 * bw, lines), min(4 * ((bw + 1) >> 1), lines)] if hor else [
            min(4 * bh, lines), min(4 * ((bh + 1) >> 1), lines)]
        assert (a.group, list(a.nlines)) == (g, nl[:1] + nl[1:] * 2)
        assert list(a.first) == [0, -(-nl[0] // g), -(-nl[0] // g) + -(-nl[1] // g),
                                 -(-nl[0] // g) + 2 * -(-nl[1] // g)]
        assert a.pitch % 64 == 8 and a.pitch >= 4 * a.maxnw + 12
    with pytest.raises(ValueError, match="int32"):
        FK.cdef_args(planes.to(torch.int64), planes, dev, hdr, **k)
    with pytest.raises(ValueError, match="units"):  # planes short of the grid
        FK.cdef_args(planes[:, :8].contiguous(), planes[:, :8].contiguous(), dev,
                     hdr, **k)
    with pytest.raises(ValueError, match="groups of 6"):
        FK.deblock_args(planes, dev, hdr, True, group=6, **k)
