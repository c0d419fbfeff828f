"""rav1d_tpu_torch's film grain against rav1d_tpu's, exactly.

Checked:

- ops/fg.py fg_blend_batch against rav1d_tpu/ops/tpu/fg.py's at 8, 10
  and 12 bits (random pixels, grain, scaling tables, shifts and ranges);
- ops/fg.py grain_frame_plain, on the host tables of engine/grain.py,
  against rav1d_tpu's recon/fg_apply.py apply_grain on random padded
  pictures and random film grain parameters: every layout at 8, 10 and
  12 bits, odd widths and heights, overlap on and off, AR lag 0-3,
  chroma_scaling_from_luma, restricted range with and without the
  identity matrix, luma or chroma without points (copied), the clip-only
  case (chroma_scaling_from_luma and restricted range, no points), and a
  picture wide enough for two blocks of kernel columns;
- csrc/fg.cu compiled for the host with g++, both forms: the new one
  (rav1d_fg_frame_host walks the persistent grid's blocks, each block's
  tiles and each tile's steps with the kernel's step functions, thread by
  thread, each barrier a loop boundary) on the H100's grid and on grids
  of one and two blocks (a block takes several tiles and crosses planes,
  staging each plane's tables once), and the earlier one
  (rav1d_fg_frame_earlier_host), against grain_frame_plain on the same
  cases, the output pre-filled with a pattern; the arguments each form
  refuses (the new one also a plane base or stride that is not a multiple
  of 16 bytes); the kernels themselves build and run only on the card,
  where chip_smoke.py holds them to grain_frame_plain;
- the wrapper's host side: grain_args packs every FgFrame field; the
  reused table buffer (TableStage) is rewritten only after the event
  recorded behind its last copy has completed (a recording stand-in for
  torch.cuda.Event); engine/grain.py HostCopy hands out copies, never
  views of its reused buffer;
- synth's film grain parameters (Tools(film_grain=True)) parsed by the
  port's obu.py as by rav1d_tpu's, across seeds covering every branch:
  no grain, new parameters, parameters loaded from a reference
  (update_grain = 0, equal to that reference's but for the seed), no luma
  or no chroma points, chroma_scaling_from_luma, AR lags 0-3, overlap and
  restricted range on and off;
- whole decodes with grain: Decoder(Settings(apply_grain=True),
  device="cpu") (the engine, grain_frame_plain) and the host path
  against rav1d_tpu.Decoder, a still, an inter sequence followed by a
  show_existing_frame of frame 1 (the same grained bytes again: the
  reference picture stays grain-free) and an inter sequence whose key
  frame falls back to the host path (its planes uploaded for the grain
  step); the CLI with --filmgrain 1 against rav1d_tpu's;
- a cuda:1 decoder at delays 1-3 (torch.cuda.device replaced by a
  recorder, the dense pass by a stub, the device step by the plain
  version): every grain step runs inside cuda:1, one a grained picture,
  and rav1d_tpu_torch's host grain (recon/fg_apply.py) is never called;
- the kernels' wrappers raise on CPU tensors and count nothing.

Inputs are seeded with numpy. Tolerance: exact.
"""

import copy
import ctypes
import dataclasses
import functools
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rav1d_tpu
import rav1d_tpu_torch as T
from rav1d_tpu import headers as RH
from rav1d_tpu import picture as RP
from rav1d_tpu.ops.tpu import fg as JFG
from rav1d_tpu.recon import fg_apply as ref_fg_apply
from rav1d_tpu_torch import cli, synth
from rav1d_tpu_torch import headers as H
from rav1d_tpu_torch import picture as P
from rav1d_tpu_torch.engine import grain as G
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops import fg as FG
from rav1d_tpu_torch.ops.cuda import grain as GK
from rav1d_tpu_torch.recon import fg_apply
from rav1d_tpu_torch.recon import frame as RF
from test_torch_device import Devices
from test_torch_frontend import _plain

CSRC = os.path.join(os.path.dirname(GK.__file__), "..", "..", "csrc")
GRAIN = synth.Tools(film_grain=True)


# ----------------------------- fg_blend_batch -----------------------------


@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_fg_blend_batch_matches_jax(bpc):
    rng = np.random.default_rng(bpc)
    pxmax = (1 << bpc) - 1
    g = 128 << (bpc - 8)
    src = rng.integers(0, pxmax + 1, (6, 32, 32)).astype(np.int32)
    src[0, 0, :4] = (0, pxmax, 0, pxmax)
    grain = rng.integers(-g, g, (6, 32, 32)).astype(np.int32)
    scaling = rng.integers(0, 256, 1 << bpc).astype(np.int32)
    for shift in range(8, 12):
        for lo, hi in ((0, pxmax), (16 << (bpc - 8), 235 << (bpc - 8))):
            want = JFG.fg_blend_batch(jnp.asarray(src), jnp.asarray(grain),
                                      jnp.asarray(scaling), shift, lo, hi)
            got = FG.fg_blend_batch(torch.from_numpy(src),
                                    torch.from_numpy(grain),
                                    torch.from_numpy(scaling), shift, lo, hi)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------- pictures and parameters -------------------------


def grain_fields(rng, layout, *, overlap=True, lag=3, cfl=False,
                 restricted=False, luma=True, chroma=True):
    """Random FilmGrainData fields (plain values): `luma`/`chroma` whether
    the planes have points (chroma's only without cfl)."""

    def pts(n):
        xs = np.sort(rng.choice(256, size=n, replace=False))
        return [[int(x), int(y)] for x, y in zip(xs, rng.integers(0, 256, n))]

    num_y = int(rng.integers(1, 15)) if luma else 0
    num_uv = [0, 0]
    if chroma and not cfl and layout != PL.I400:
        num_uv = [int(v) for v in rng.integers(1, 11, 2)]
    y_pts = pts(num_y) + [[0, 0]] * (14 - num_y)
    uv_pts = [pts(n) + [[0, 0]] * (10 - n) for n in num_uv]
    return dict(
        seed=int(rng.integers(0, 1 << 16)), num_y_points=num_y,
        y_points=y_pts, chroma_scaling_from_luma=cfl, num_uv_points=num_uv,
        uv_points=uv_pts, scaling_shift=int(rng.integers(8, 12)),
        ar_coeff_lag=lag,
        ar_coeffs_y=[int(v) for v in rng.integers(-128, 128, 24)],
        ar_coeffs_uv=[[int(v) for v in rng.integers(-128, 128, 28)]
                      for _ in range(2)],
        ar_coeff_shift=int(rng.integers(6, 10)),
        grain_scale_shift=int(rng.integers(0, 4)),
        uv_mult=[int(v) for v in rng.integers(-128, 128, 2)],
        uv_luma_mult=[int(v) for v in rng.integers(-128, 128, 2)],
        uv_offset=[int(v) for v in rng.integers(-256, 256, 2)],
        overlap_flag=overlap, clip_to_restricted_range=restricted)


def picture(pkg, fields, layout, bpc, w, h, planes, mtrx):
    """A Picture of package `pkg` (rav1d_tpu's modules or the port's)
    carrying the parameters and copies of the planes."""
    hdrs, pic_mod = pkg
    fh = hdrs.FrameHeader()
    fh.film_grain.data = hdrs.FilmGrainData(**copy.deepcopy(fields))
    sh = hdrs.SequenceHeader()
    sh.mtrx = mtrx
    y, u, v = (None if p is None else p.copy() for p in planes)
    return pic_mod.Picture(w=w, h=h, layout=hdrs.PixelLayout(int(layout)),
                           bpc=bpc, y=y, u=u, v=v, frame_hdr=fh, seq_hdr=sh)


# name: (layout, bpc, w, h, grain_fields options, mtrx)
CASES = {
    "420-8bit-odd": (PL.I420, 8, 97, 65, dict(lag=3), 2),
    "420-10bit-restricted": (PL.I420, 10, 130, 66,
                             dict(lag=2, restricted=True), 2),
    "420-12bit-no-overlap": (PL.I420, 12, 97, 65, dict(overlap=False, lag=1),
                             2),
    "420-8bit-cfl-odd": (PL.I420, 8, 99, 33, dict(lag=0, cfl=True), 2),
    "420-8bit-wide": (PL.I420, 8, 300, 40, dict(lag=1), 2),
    "420-10bit-clip-only": (PL.I420, 10, 97, 65, dict(
        lag=2, cfl=True, restricted=True, luma=False), 2),
    "420-8bit-no-chroma-points": (PL.I420, 8, 97, 65, dict(
        lag=1, chroma=False), 2),
    "422-8bit-cfl": (PL.I422, 8, 97, 66, dict(lag=0, cfl=True), 2),
    "422-10bit-odd-identity": (PL.I422, 10, 99, 65, dict(
        lag=3, restricted=True), 0),
    "422-12bit-no-luma-points": (PL.I422, 12, 64, 48, dict(
        lag=2, luma=False), 2),
    "444-8bit": (PL.I444, 8, 130, 66, dict(lag=1), 2),
    "444-10bit-no-overlap-odd": (PL.I444, 10, 97, 65, dict(
        overlap=False, lag=0), 2),
    "444-12bit-identity": (PL.I444, 12, 66, 40, dict(
        lag=3, restricted=True), 0),
    "444-8bit-clip-only": (PL.I444, 8, 64, 40, dict(
        lag=0, cfl=True, restricted=True, luma=False), 2),
    "400-8bit-odd": (PL.I400, 8, 97, 65, dict(lag=2), 2),
    "400-10bit-restricted": (PL.I400, 10, 130, 66, dict(
        lag=0, restricted=True), 2),
    "400-12bit-no-overlap": (PL.I400, 12, 64, 33, dict(
        overlap=False, lag=3), 2),
}


@functools.lru_cache(maxsize=None)
def case(name):
    """(the port's Picture, its GrainTables, grain_frame_plain's planes,
    rav1d_tpu's apply_grain planes) of a case: random padded planes in
    range (the padding too)."""
    layout, bpc, w, h, opts, mtrx = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    fields = grain_fields(rng, layout, **opts)
    dt = np.uint8 if bpc == 8 else np.uint16
    pxmax = (1 << bpc) - 1
    ah, aw = (h + 127) & ~127, (w + 127) & ~127
    y = rng.integers(0, pxmax + 1, (ah, aw)).astype(dt)
    y[:4, :8] = pxmax  # the range's top reached
    u = v = None
    if layout != PL.I400:
        sx, sy = int(layout != PL.I444), int(layout == PL.I420)
        cw, ch = (w + sx) >> sx, (h + sy) >> sy
        shape = ((ch + 127) & ~127, (cw + 127) & ~127)
        u = rng.integers(0, pxmax + 1, shape).astype(dt)
        v = rng.integers(0, pxmax + 1, shape).astype(dt)
    planes = (y, u, v)
    pic = picture((H, P), fields, layout, bpc, w, h, planes, mtrx)
    t = G.tables(pic)
    src = [torch.from_numpy(a.view(np.int16) if bpc > 8 else a)
           for a in planes[: t.nplanes]]
    plain = [p.numpy() for p in FG.grain_frame_plain(src, t)]
    ref = ref_fg_apply.apply_grain(
        picture((RH, RP), fields, layout, bpc, w, h, planes, mtrx))
    want = [a.view(np.int16) if bpc > 8 else a
            for a in (ref.y, ref.u, ref.v)[: t.nplanes]]
    return pic, t, plain, want


@pytest.mark.parametrize("name", sorted(CASES))
def test_grain_frame_plain_matches_reference(name):
    pic, t, plain, want = case(name)
    assert len(plain) == t.nplanes
    for got, ref in zip(plain, want):
        np.testing.assert_array_equal(got, ref)
    # the grain changed the planes it grains, and only those
    src = (pic.y, pic.u, pic.v)
    for pl in range(t.nplanes):
        a = src[pl].view(np.int16) if t.bpc > 8 else src[pl]
        assert (plain[pl] != a).any() == (t.plane_scaling[pl] >= 0), pl


def test_cases_cover_every_branch():
    layouts, flags = set(), set()
    for name in CASES:
        _, t, _, _ = case(name)
        layout, bpc, w, h, opts, mtrx = CASES[name]
        layouts.add((int(layout), bpc))
        flags |= {("overlap", t.overlap), ("cfl", t.cfl),
                  ("odd", bool(w & 1 and h & 1)),
                  ("lag", opts["lag"]), ("copy-luma", t.plane_scaling[0] < 0),
                  ("clip-only", t.plane_scaling == (-1, 0, 0)),
                  ("restricted-identity", (opts.get("restricted", False),
                                           mtrx == 0))}
    assert layouts >= {(int(l), b) for l in PL for b in (8, 10, 12)}
    assert flags >= {("overlap", True), ("overlap", False), ("cfl", True),
                     ("odd", True), ("copy-luma", True), ("clip-only", True),
                     ("restricted-identity", (True, True)),
                     ("restricted-identity", (True, False))} | {
        ("lag", k) for k in range(4)}


# ------------------------- the kernel's host build -------------------------


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("fg") / "libfg_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", so, os.path.join(CSRC, "fg.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.rav1d_fg_frame_host.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rav1d_fg_frame_earlier_host.argtypes = [ctypes.c_void_p]
    lib.rav1d_fg_tiles.argtypes = [ctypes.c_void_p]
    for fn in (lib.rav1d_fg_frame_host, lib.rav1d_fg_frame_earlier_host,
               lib.rav1d_fg_tiles):
        fn.restype = ctypes.c_int
    return lib


HOST_GRID = 2 * 132  # the new form's grid on an H100: two blocks an SM


def host_args(name):
    """(the FgFrame, the output planes pre-filled with a pattern,
    grain_frame_plain's planes) of a case; the source planes and the
    tables in freshly allocated tensors (every base 16-byte aligned)."""
    pic, t, plain, _ = case(name)
    src = [torch.from_numpy(a.view(np.int16) if t.bpc > 8 else a).clone()
           for a in (pic.y, pic.u, pic.v)[: t.nplanes]]
    out = [torch.full_like(s, 0x5A) for s in src]
    buf, offsets = GK.table_bytes(t)
    tables = torch.from_numpy(buf).clone()
    a = GK.grain_args(out, src, tables, offsets, t)
    return a, out, plain, (src, tables)


def run_host(lib, form, a, grid=HOST_GRID):
    if form == "new":
        return lib.rav1d_fg_frame_host(ctypes.byref(a), grid)
    return lib.rav1d_fg_frame_earlier_host(ctypes.byref(a))


@pytest.mark.parametrize("form", ["new", "earlier"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_host_kernel_matches_plain(lib, name, form):
    a, out, plain, _ = host_args(name)
    assert run_host(lib, form, a) == 0
    for got, want in zip(out, plain):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("grid", [1, 2])
@pytest.mark.parametrize("name", ["420-8bit-wide", "422-12bit-no-luma-points",
                                  "444-10bit-no-overlap-odd"])
def test_host_kernel_small_grid(lib, name, grid):
    """The new form on a grid of one or two blocks: each block walks
    several tiles and crosses planes (with three planes, one of two
    contiguous ranges holds two planes' tiles), staging each plane's
    tables once it enters it; the 420-8bit-wide luma plane also has
    tiles of padding rows only, which stage nothing."""
    a, out, plain, _ = host_args(name)
    tiles = lib.rav1d_fg_tiles(ctypes.byref(a))
    assert a.nplanes == 3 and tiles >= 2 * grid + 1
    assert run_host(lib, "new", a, grid) == 0
    for got, want in zip(out, plain):
        np.testing.assert_array_equal(got.numpy(), want)


def test_host_kernel_refuses_bad_arguments(lib):
    a, _, _, keep = host_args("420-8bit-odd")
    for field, value in (("bpc", 9), ("n_cols", a.n_cols + 1),
                         ("scaling_shift", 7), ("nplanes", 2)):
        b = GK.FgFrame.from_buffer_copy(a)
        setattr(b, field, value)
        for form in ("new", "earlier"):
            assert run_host(lib, form, b) == -1, (field, form)
    # the new form reads and writes 16 bytes a row: a stride or a plane
    # base that is not a multiple of 16 bytes is refused
    for field, pl, step in (("pw", 0, 8), ("pw", 1, 4), ("src", 1, 8),
                            ("out", 2, 4), ("src", 0, 1)):
        b = GK.FgFrame.from_buffer_copy(a)
        getattr(b, field)[pl] += step
        assert run_host(lib, "new", b) == -1, (field, pl, step)
    b = GK.FgFrame.from_buffer_copy(a)
    b.pw[0] += 8  # the earlier form reads pixel by pixel: it takes it
    out = [torch.full((a.ph[pl], b.pw[pl]), 0x5A, dtype=torch.uint8)
           for pl in range(3)]
    src = [torch.zeros_like(o) for o in out]
    for pl in range(3):
        b.out[pl], b.src[pl] = out[pl].data_ptr(), src[pl].data_ptr()
    assert run_host(lib, "earlier", b) == 0
    del keep


def test_grain_args_fill_every_field():
    a, out, _, (src, tables) = host_args("422-10bit-odd-identity")
    _, t, _, _ = case("422-10bit-odd-identity")
    assert GK._ARGS.size == ctypes.sizeof(GK.FgFrame)
    _, offsets = GK.table_layout(t)
    assert list(a.out) == [o.data_ptr() for o in out]
    assert list(a.src) == [s.data_ptr() for s in src]
    assert [a.lut, a.scaling, a.rand] == [tables.data_ptr() + o
                                          for o in offsets]
    assert (a.bpc, a.nplanes, a.sx, a.sy, a.w, a.h) == (
        10, 3, 1, 0, t.w, t.h)
    assert list(a.ph) == [s.shape[0] for s in src]
    assert list(a.pw) == [s.shape[1] for s in src]
    assert tuple(a.sc) == t.plane_scaling
    assert (a.n_rows, a.n_cols) == t.rand.shape
    assert (a.overlap, a.scaling_shift, a.cfl) == (
        int(t.overlap), t.scaling_shift, int(t.cfl))
    assert (tuple(a.uv_mult), tuple(a.uv_luma_mult), tuple(a.uv_offset)) == (
        t.uv_mult, t.uv_luma_mult, t.uv_offset)
    assert tuple(zip(a.lo, a.hi)) == t.clip


def test_table_stage_rewrites_only_after_the_last_copy(monkeypatch):
    """ops/cuda/grain.py TableStage on the CPU, torch.cuda.Event replaced
    by a recorder, each copy out of the buffer (on a card the C entry's,
    ahead of its launch) made here before `copied`: each picture's tables
    go into the one reused buffer only once the event recorded behind the
    last copy has completed (at that wait the buffer still holds what the
    copy read), a larger picture's buffer replaces it only after that wait
    too, one event serves every copy, and every copy delivers the tables
    it was given."""
    st = GK.TableStage("cpu")
    log = []

    class Recorder:
        def __init__(self):
            self.read = None
            log.append("new")

        def record(self, stream=None):
            self.read = st.view.copy()  # what the copy in flight reads
            log.append("record")

        def synchronize(self):
            assert (st.view == self.read).all(), "rewritten before the wait"
            log.append("wait")

    monkeypatch.setattr(GK, "_event", Recorder)
    buffers = []
    _, big, _, _ = case("444-12bit-identity")
    big = dataclasses.replace(big, rand=np.ones((200, 300), np.uint8))
    for name in ("420-8bit-odd", "422-10bit-odd-identity", "444-12bit-identity",
                 big):
        t = big if name is big else case(name)[1]
        want, offsets = GK.table_bytes(t)
        with st.lock:
            host, n, got_offsets = st.write(t)
            dst = np.frombuffer(ctypes.string_at(host, n), np.uint8)
            st.copied()
        assert (n, got_offsets) == (want.size, offsets)
        np.testing.assert_array_equal(dst, want)
        buffers.append(st.host.data_ptr())
    assert len(set(buffers)) == 2 and buffers[0] == buffers[2]
    assert log == ["new", "record", "wait", "record", "wait", "record",
                   "wait", "record"]


@pytest.mark.parametrize("bpc", [8, 10])
def test_host_copy_hands_out_copies(bpc):
    """engine/grain.py HostCopy: the planes handed out equal the device
    planes and never alias the reused buffer, so the next picture's copy
    leaves them as they were."""
    rng = np.random.default_rng(bpc)
    dt = torch.int16 if bpc > 8 else torch.uint8
    hc = G.HostCopy("cpu")

    def planes():
        return [torch.from_numpy(rng.integers(0, 1 << bpc, s).astype(
            np.int16 if bpc > 8 else np.uint8)).to(dt)
            for s in ((128, 256), (128, 128), (128, 128))]

    first, second = planes(), planes()
    got = hc.planes(first, bpc)
    kept = [g.copy() for g in got]
    got2 = hc.planes(second, bpc)
    for g, k, p in zip(got, kept, first):
        assert g.dtype == (np.uint16 if bpc > 8 else np.uint8)
        np.testing.assert_array_equal(g, k)
        np.testing.assert_array_equal(g.view(p.numpy().dtype), p.numpy())
    for g, p in zip(got2, second):
        np.testing.assert_array_equal(g.view(p.numpy().dtype), p.numpy())
    for g in got + got2:
        assert not np.shares_memory(g, hc.buf.numpy())


def test_random_table_is_the_block_chain():
    """engine/grain.py random_table: each block's value is the one
    ops/ref/fg.py's block loop draws for it (row r's chain, and row r - 1's
    as its top neighbour)."""
    from rav1d_tpu_torch.ops.ref import fg

    pic, t, _, _ = case("420-8bit-wide")
    data = pic.frame_hdr.film_grain.data
    for r in range(t.rand.shape[0]):
        seed = fg._row_seed(2, r, data) if r else fg._row_seed(1, r, data)
        for c in range(t.rand.shape[1]):
            for k in range(2 if r else 1):
                v, seed[k] = fg._get_random_number(8, seed[k])
                assert v == t.rand[r - k, c]


def test_wrapper_takes_cuda_tensors_only():
    pic, t, _, _ = case("420-8bit-odd")
    before = GK.launches
    with pytest.raises(ValueError, match="CUDA"):
        GK.grain_frame([torch.from_numpy(a) for a in (pic.y, pic.u, pic.v)],
                       t)
    assert GK.launches == before


def test_earlier_wrapper_takes_cuda_tensors_only():
    pic, t, _, _ = case("420-8bit-odd")
    before = (GK.launches, GK.earlier_launches)
    planes = [torch.from_numpy(a) for a in (pic.y, pic.u, pic.v)]
    for fn in (GK.grain_frame_earlier,
               lambda p, t: GK.trace_frame(p, t, form="earlier"),
               lambda p, t: GK.trace_frame(p, t, form="new")):
        with pytest.raises(ValueError, match="CUDA"):
            fn(planes, t)
    assert (GK.launches, GK.earlier_launches) == before


# ------------------------------ synth streams ------------------------------


class _Syntax(T.Decoder):
    """The port's host path without the dense pass (headers only)."""

    def _decode_dense(self, f):
        pass


def grain_headers(packets):
    dec = _Syntax(T.Settings(apply_grain=False), host_path=True)
    out = []
    for data in packets:
        dec.send_data(data)
        out.append(dec.get_picture().frame_hdr.film_grain)
    return out


def test_synth_grain_parameters_round_trip():
    """Across seeds: every branch of film_grain_params(); a frame without
    an update carries its reference's parameters with its own seed; both
    packages parse the same headers."""
    seen = set()
    for seed in range(10):
        for layout in (PL.I420, PL.I444, PL.I400):
            pk = synth.inter_sequence(64, 64, seed, layout=layout,
                                      tools=GRAIN)
            key, f1, f2 = grain_headers(pk)
            assert key.present and key.update and f2.present
            assert not f2.update
            assert any(dict(_plain(f2.data), seed=0)
                       == dict(_plain(x.data), seed=0)
                       for x in (key, f1) if x.present)
            for fg in (key, f1):
                if not fg.present:
                    seen.add("no grain")
                    continue
                dd = fg.data
                seen.add("update" if fg.update else "load")
                seen |= {("lag", dd.ar_coeff_lag), ("overlap", dd.overlap_flag),
                         ("restricted", dd.clip_to_restricted_range),
                         ("cfl", dd.chroma_scaling_from_luma),
                         ("no y", dd.num_y_points == 0),
                         ("uv", bool(dd.num_uv_points[0]))}
    assert seen >= {"no grain", "update", "load", ("cfl", True),
                    ("no y", True), ("uv", True), ("overlap", True),
                    ("overlap", False), ("restricted", True),
                    ("restricted", False)} | {("lag", k) for k in range(4)}
    pk = synth.inter_sequence(64, 64, 1, tools=GRAIN)
    got = [_plain(x) for x in grain_headers(pk)]
    want = []
    dec = rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=False))
    for data in pk:
        dec.send_data(data)
        want.append(_plain(dec.get_picture().frame_hdr.film_grain))
    assert got == want


# ------------------------------ whole decodes ------------------------------


def show_existing(slot):
    """A temporal unit showing reference slot `slot` again."""
    b = synth._Bits()
    b.put(1, 1)  # show_existing_frame
    b.put(slot, 3)  # frame_to_show_map_idx
    b.trailing()
    return synth._obu(synth.OBU_TD, b"") + synth._obu(3, b.bytes())


STREAMS = {
    "still-10bit-422-odd": lambda: [synth.still_picture(
        99, 66, 3, bpc=10, layout=PL.I422, tools=GRAIN)],
    "inter-8bit-420-show-existing": lambda: synth.inter_sequence(
        97, 65, 0, tools=GRAIN) + [show_existing(0)],
    # the key frame on the host path (intra block copy): no device planes,
    # its host planes uploaded for the grain step
    "inter-8bit-420-intrabc": lambda: synth.inter_sequence(
        96, 64, 6, intrabc=True, tools=GRAIN),
}


@functools.lru_cache(maxsize=None)
def reference_md5s(name):
    return synth.decode_md5s(
        rav1d_tpu.Decoder(rav1d_tpu.Settings(apply_grain=True)),
        STREAMS[name](), eagain=rav1d_tpu.EAgain)


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("path", ["cpu", "host"])
def test_decoder_grain_matches_reference(name, path):
    packets = STREAMS[name]()
    dec = T.Decoder(T.Settings(apply_grain=True), **(
        dict(device="cpu") if path == "cpu" else dict(host_path=True)))
    calls = []
    real = fg_apply.apply_grain
    fg_apply.apply_grain = lambda pic: calls.append(1) or real(pic)
    T.engine.stats.update(frames=0, fallback=0, ref_uploads=0)
    try:
        got = synth.decode_md5s(dec, packets)
    finally:
        fg_apply.apply_grain = real
    if path == "cpu":
        assert T.engine.stats["fallback"] == int("intrabc" in name)
    want = reference_md5s(name)
    assert got == want
    plain = synth.decode_md5s(T.Decoder(T.Settings(apply_grain=False),
                                        host_path=True), packets)
    assert got[0] != plain[0]  # grain changed the first picture
    assert bool(calls) == (path == "host")
    if "show-existing" in name:
        assert len(got) == 4 and got[3] == got[1]


def test_cli_filmgrain_matches_reference(tmp_path):
    from rav1d_tpu import cli as ref_cli

    name = "inter-8bit-420-show-existing"
    packets = STREAMS[name]()
    path = str(tmp_path / "in.ivf")
    synth.write_ivf(path, packets, 97, 65)
    got, want = tmp_path / "port.yuv", tmp_path / "ref.yuv"
    assert cli.main(["-i", path, "-o", str(got), "--filmgrain", "1",
                     "--device", "cpu", "-q"]) == 0
    assert ref_cli.main(["-i", path, "-o", str(want), "--filmgrain", "1",
                         "-q"]) == 0
    assert got.read_bytes() == want.read_bytes()
    md5 = tmp_path / "port.md5"
    assert cli.main(["-i", path, "-o", str(md5), "--filmgrain", "1",
                     "--device", "cpu", "-q"]) == 0
    assert md5.read_text().strip() != synth.stream_md5(packets)


@pytest.fixture
def recorded(monkeypatch):
    """{"grain": [the device each grain step ran in], "host": [each call
    of the host grain]} of decodes on a cuda:1 stand-in whose dense pass
    leaves the picture's zero planes as its device planes (CPU tensors)."""
    devices = Devices()
    got = {"grain": [], "host": []}

    def decode_frame_dense(f, up):
        pic = f.sr_cur
        planes = (pic.y, pic.u, pic.v)[: 1 if pic.u is None else 3]
        pic._dev_planes = {pl: torch.from_numpy(
            a.view(np.int16) if pic.bpc > 8 else a)
            for pl, a in enumerate(planes)}
        up.fetches.add(pic, torch.empty(1, dtype=torch.uint8), lambda: None)

    def grain_planes(planes, t):
        got["grain"].append(devices.current())
        return FG.grain_frame_plain(planes, t)

    monkeypatch.setattr(torch.cuda, "device", devices)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(RF, "decode_frame_dense", decode_frame_dense)
    monkeypatch.setattr(G, "grain_planes", grain_planes)
    monkeypatch.setattr(fg_apply, "apply_grain",
                        lambda pic: got["host"].append(pic))
    return got


@pytest.mark.parametrize("d", [1, 2, 3])
def test_grain_runs_inside_the_decoders_device(recorded, d):
    packets = synth.inter_sequence(97, 65, 0, tools=GRAIN)
    dec = T.Decoder(T.Settings(apply_grain=True, max_frame_delay=d),
                    device="cuda:1")
    pics = synth.decode_md5s(dec, packets)
    dec.close()
    grained = sum(1 for fg in grain_headers(packets) if fg.present and (
        fg.data.num_y_points or any(fg.data.num_uv_points)
        or fg.data.chroma_scaling_from_luma and fg.data.clip_to_restricted_range))
    assert len(pics) == 3 and grained >= 2
    assert recorded == {"grain": [torch.device("cuda:1")] * grained,
                        "host": []}
