"""The superres upscale kernel against the plain upscale and the JAX
engine's, exactly.

csrc/superres.cu compiled for the host with g++: its host entry
rav1d_superres_frame_host walks the thread blocks of the launch with the
kernel's own step functions, thread by thread, the barrier a loop
boundary, on the SrFrame ops/cuda/filters.py superres_args builds for the
launch. The kernel itself builds and runs only on the card, where
chip_smoke.py holds it to its plain version. Checked:

- the frame entry on hand-built planes and snapshots at 8, 10 and 12 bits
  in 4:0:0, 4:2:0, 4:2:2 and 4:4:4, at every superres denominator 9-16
  (each plane's step and start from the port's decoder.py _scale_fac and
  recon/superres.py get_upscale_x0, as the decoder computes them), on an
  odd upscaled width, on a coded width of 16 and on rows of three blocks
  of columns, with pixels at 0 and at the largest value so that the clip
  is reached at both ends: against
  engine/programs.py _superres (engine/filters.py resize_plane, the plain
  version) and rav1d_tpu's resize_plane_raw per plane, on an output
  pre-filled with a pattern (the entry must write the pads and a 4:0:0
  frame's chroma planes with zeros);
- the kernel's filter table against engine/consts.py resize_filter;
- engine/programs.py filter_kernels through the host builds of the four
  filter sources against filter_plain on a 10-bit 4:2:2 superres still
  (tests/test_torch_filter_kernels.py holds the 8-bit 4:2:0 one), with
  one upscale launch and no plain pass;
- the wrapper's rules: a CPU tensor raises and counts nothing;
  programs.filter_ on CPU tensors is filter_plain and calls the plain
  upscale.

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
from rav1d_tpu_torch import synth
from rav1d_tpu_torch.decoder import _scale_fac
from rav1d_tpu_torch.engine import filters as FL
from rav1d_tpu_torch.engine import programs as P
from rav1d_tpu_torch.engine.consts import numpy_tables
from rav1d_tpu_torch.engine.layout import HDR_LEN, SR0
from rav1d_tpu_torch.headers import PixelLayout as PL
from rav1d_tpu_torch.ops.cuda import filters as FK
from rav1d_tpu_torch.recon.superres import get_upscale_x0
from test_torch_filter_kernels import Frame, host_kernels, plain_lr_calls

CSRC = os.path.join(os.path.dirname(FK.__file__), "..", "..", "csrc")
PATTERN = 0x5A5A5A5A
# rav1d_tpu's upscale, one compile per (rows, output columns, padded width):
# the source width, step, start and bit depth are traced
_JRESIZE = jax.jit(JF.resize_plane_raw, static_argnums=(1, 2, 7))


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    so = str(tmp_path_factory.mktemp("superres") / "libsuperres_host.so")
    subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O1", "-shared",
                    "-fPIC", "-o", so, os.path.join(CSRC, "superres.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    for fn in (lib.rav1d_superres_frame_host, lib.rav1d_superres_table_host):
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def coded_width(sr_w, denom):
    """The coded luma width of an upscaled width (obu.py's frame size)."""
    return max((sr_w * 8 + (denom >> 1)) // denom, min(16, sr_w))


def sr_header(coded_w, sr_w, layout):
    """A header with the steps and starts decoder.py computes for a frame
    coded at coded_w and upscaled to sr_w (pack.py writes them at SR0)."""
    hdr = np.zeros(HDR_LEN, np.int32)
    ss_hor = FK.subsampling(int(layout))[0]
    for ci, (i, o) in enumerate(((coded_w, sr_w),
                                 ((coded_w + ss_hor) >> ss_hor,
                                  (sr_w + ss_hor) >> ss_hor))):
        step = _scale_fac(i, o)
        hdr[SR0 + 2 * ci] = step
        hdr[SR0 + 2 * ci + 1] = get_upscale_x0(i, o, step)
    return hdr


def edge_planes(rng, shape, bpc):
    """Pixels in range: random runs at 0 and at the largest value (steps
    whose upscale overshoots both ends of the range), smooth ramps and
    noise."""
    pxmax = (1 << bpc) - 1
    n, h, w = shape
    v = rng.integers(0, pxmax + 1, shape)
    ramp = (np.arange(w) * pxmax // max(w - 1, 1))[None, None, :]
    run = rng.integers(0, 3, (n, h, (w + 5) // 6)).repeat(6, -1)[..., :w]
    v = np.where(run == 0, 0, np.where(run == 1, pxmax, v))
    v[:, ::4] = ramp
    return v.astype(np.int32)


def unclipped(src, h, dst_w, src_w, dx, mx0):
    """(-acc + 64) >> 7 of the upscale before its clip, in numpy."""
    rf = numpy_tables()["resize_filter"].astype(np.int64)
    pos = mx0 + np.arange(dst_w) * dx
    sx = -1 + (pos >> 14) - (mx0 >> 14)
    cols = np.clip(sx[:, None] + np.arange(8)[None, :] - 3, 0, src_w - 1)
    acc = (src[:h, cols].astype(np.int64) * rf[(pos & 0x3FFF) >> 8]).sum(-1)
    return (-acc + 64) >> 7


def run_case(lib, rng, bpc, layout, sr_w, cur_h, denom):
    """One frame's upscale by the host entry, against _superres and
    rav1d_tpu's resize_plane_raw. Returns (the output, the geometry of each
    plane with pixels, the source planes)."""
    coded = coded_width(sr_w, denom)
    srcw_y = ((coded + 7) >> 3) << 3  # 4 * bw, as engine/run.py passes it
    # planes wide enough for the widest coded width of sr_w, so that the
    # JAX function keeps its shapes (and its compile) across denominators
    ah, aw = ((cur_h + 7) >> 3) << 3, (((sr_w + 7) >> 3) << 3) + 8
    s_ah, s_aw = ah + 4, ((sr_w + 63) >> 6) * 64 + 16
    sr_geom = (s_ah, s_aw, sr_w, cur_h, srcw_y)
    hdr = sr_header(coded, sr_w, layout)
    planes = edge_planes(rng, (3, ah, aw), bpc)
    pre = edge_planes(rng, (3, ah, aw), bpc)
    kw = dict(cur_h=cur_h, sr_geom=sr_geom, layout_i=int(layout), bpc=bpc)

    out = torch.full((2, 3, s_ah, s_aw), PATTERN, dtype=torch.int32)
    a = FK.superres_args(out, torch.from_numpy(planes), torch.from_numpy(pre),
                         hdr, **kw)
    assert lib.rav1d_superres_frame_host(ctypes.byref(a)) == 0

    ss_hor, ss_ver = FK.subsampling(int(layout))
    c0 = FL.calls
    want = P._superres(torch.from_numpy(planes), torch.from_numpy(pre), hdr,
                       cur_h, sr_geom, ss_hor, ss_ver, int(layout) != 0, bpc)
    want = torch.stack(want[:2])
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    npl = 1 if layout == PL.I400 else 3
    assert FL.calls - c0 == 2 * npl

    geo = [(a.h[pl], a.dst_w[pl], a.src_w[pl], a.dx[pl], a.mx0[pl])
           for pl in range(npl)]
    for i, src in enumerate((planes, pre)):
        for pl, (h, dst_w, src_w, dx, mx0) in enumerate(geo):
            j = _JRESIZE(jnp.asarray(src[pl]), h, dst_w, src_w, dx, mx0, bpc,
                         s_aw)
            np.testing.assert_array_equal(out.numpy()[i, pl, :h],
                                          np.asarray(j))
    return out.numpy(), geo, planes


@pytest.mark.parametrize("layout", [PL.I400, PL.I420, PL.I422, PL.I444],
                         ids=lambda v: v.name)
@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_superres_frame_every_denominator(lib, bpc, layout):
    """An odd upscaled width (99) and odd rows, every denominator; the
    clip reached at both ends."""
    rng = np.random.default_rng(17 * bpc + int(layout))
    pxmax = (1 << bpc) - 1
    for denom in range(9, 17):
        out, geo, planes = run_case(lib, rng, bpc, layout, 99, 21, denom)
        h, dst_w, src_w, dx, mx0 = geo[0]
        u = unclipped(planes[0], h, dst_w, src_w, dx, mx0)
        assert u.min() < 0 and u.max() > pxmax
        assert (out[0, 0, :h, :dst_w] == 0).any()
        assert (out[0, 0, :h, :dst_w] == pxmax).any()
        assert dst_w == 99 and src_w == ((coded_width(99, denom) + 7) >> 3) << 3


@pytest.mark.parametrize("bpc, layout, sr_w", [(8, PL.I420, 30),
                                               (12, PL.I444, 30),
                                               (10, PL.I422, 613)],
                         ids=["narrow-8bit-420", "narrow-12bit-444",
                              "wide-10bit-422"])
def test_superres_frame_width(lib, bpc, layout, sr_w):
    """An upscaled width of 30, coded at 16 columns (the floor of the frame
    size) at denominator 16 and wider at the others; and one of 613, whose
    rows take three blocks of 256 columns (a span that starts inside the
    row)."""
    rng = np.random.default_rng(3 + bpc)
    widths = set()
    for denom in range(9, 17):
        widths.add(coded_width(sr_w, denom))
        run_case(lib, rng, bpc, layout, sr_w, 12, denom)
    assert (16 in widths) == (sr_w == 30)


def test_superres_frame_pads_and_monochrome_chroma(lib):
    """Rows past h, columns past dst_w and both chroma planes of a 4:0:0
    frame are written with 0 over the pattern."""
    rng = np.random.default_rng(5)
    for layout in (PL.I400, PL.I420):
        out, geo, _ = run_case(lib, rng, 10, layout, 99, 21, 11)
        assert not (out == PATTERN).any()
        for pl, (h, dst_w, *_) in enumerate(geo):
            assert not out[:, pl, h:].any() and not out[:, pl, :, dst_w:].any()
            assert (out[:, pl, :h, :dst_w] != 0).any()
        if layout == PL.I400:
            assert len(geo) == 1 and not out[:, 1:].any()


def test_superres_table(lib):
    """The kernel's filter table is engine/consts.py's resize_filter."""
    t = np.zeros(512, np.int32)
    assert lib.rav1d_superres_table_host(t.ctypes.data) == 512
    np.testing.assert_array_equal(t, numpy_tables()["resize_filter"].ravel())


# ------------------------------ whole frames ------------------------------


@functools.lru_cache(maxsize=None)
def frame_422():
    """A 10-bit 4:2:2 superres still (coded 121 columns of 136)."""
    return Frame([synth.still_picture(136, 96, 11, bpc=10, layout=PL.I422,
                                      superres=True)], 0)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return host_kernels(str(tmp_path_factory.mktemp("filters")))


def test_filter_program_superres_matches_plain(host):
    frame = frame_422()
    assert frame.kw["sr_geom"] is not None and frame.layout == int(PL.I422)
    planes, packed = frame.plain()
    n0, c0 = dict(host.n), FL.calls
    got, got_packed = P.filter_kernels(frame.planes.clone(), frame.dev,
                                       frame.pk.hdr, k=host, **frame.kw)
    np.testing.assert_array_equal(got.numpy(), planes.numpy())
    np.testing.assert_array_equal(got_packed.numpy(), packed.numpy())
    w, s = FK.lr_launches(frame.pk.hdr, frame.layout)
    assert {k: host.n[k] - n0[k] for k in n0} == dict(
        lf=2, cdef=1, sr=1, wiener=w, sgr=s, wiener_plane=0, sgr_plane=0)
    assert FL.calls == c0


# ------------------------------ the wrapper -------------------------------


def test_wrapper_takes_cuda_tensors_only():
    """superres_frame raises on CPU tensors before any launch and counts
    nothing; programs.filter_ on CPU tensors runs filter_plain, whose
    plain upscale engine/filters.py calls counts (two per plane)."""
    frame = frame_422()
    kw = frame.kw
    _, _, _, _, _, _, cur_h = kw["geom"]
    before = FK.sr_launches
    with pytest.raises(ValueError, match="CUDA"):
        FK.superres_frame(frame.planes, frame.planes.clone(), frame.pk.hdr,
                          cur_h=cur_h, sr_geom=kw["sr_geom"],
                          layout_i=frame.layout, bpc=kw["bpc"])
    assert FK.sr_launches == before
    launches = (FK.lf_launches, FK.cdef_launches, FK.sr_launches,
                FK.wiener_launches, FK.sgr_launches)
    c0 = FL.calls
    planes, packed = P.filter_(frame.planes.clone(), frame.dev, frame.pk.hdr,
                               **kw)
    want, want_packed = frame.plain()
    np.testing.assert_array_equal(planes.numpy(), want.numpy())
    np.testing.assert_array_equal(packed.numpy(), want_packed.numpy())
    lr = plain_lr_calls(frame.pk.hdr, frame.layout)
    assert FL.calls - c0 == 2 * (6 + 1 + 2 * 3 + lr)  # filter_, plain
    assert (FK.lf_launches, FK.cdef_launches, FK.sr_launches,
            FK.wiener_launches, FK.sgr_launches) == launches
