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
- csrc/fg.cu compiled for the host with g++ (rav1d_fg_frame_host walks
  the launch's blocks with the kernel's step functions, thread by thread)
  against grain_frame_plain on the same cases, its output pre-filled with
  a pattern; the kernel itself builds and runs only on the card, where
  chip_smoke.py holds it to grain_frame_plain;
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
- the kernel's wrapper raises on CPU tensors and counts nothing.

Inputs are seeded with numpy. Tolerance: exact.
"""

import copy
import ctypes
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
    lib.rav1d_fg_frame_host.argtypes = [ctypes.c_void_p]
    lib.rav1d_fg_frame_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_kernel_matches_plain(lib, name):
    pic, t, plain, _ = case(name)
    src = [torch.from_numpy(np.ascontiguousarray(
        a.view(np.int16) if t.bpc > 8 else a))
        for a in (pic.y, pic.u, pic.v)[: t.nplanes]]
    out = [torch.full_like(s, 0x5A) for s in src]
    buf, offsets = GK.table_bytes(t)
    tables = torch.from_numpy(buf)
    a = GK.grain_args(out, src, tables, offsets, t)
    assert lib.rav1d_fg_frame_host(ctypes.byref(a)) == 0
    for got, want in zip(out, plain):
        np.testing.assert_array_equal(got.numpy(), want)


def test_host_kernel_refuses_bad_arguments(lib):
    pic, t, _, _ = case("420-8bit-odd")
    src = [torch.from_numpy(a) for a in (pic.y, pic.u, pic.v)]
    buf, offsets = GK.table_bytes(t)
    a = GK.grain_args([s.clone() for s in src], src, torch.from_numpy(buf),
                      offsets, t)
    for field, value in (("bpc", 9), ("n_cols", t.rand.shape[1] + 1),
                         ("scaling_shift", 7), ("nplanes", 2)):
        b = GK.FgFrame.from_buffer_copy(a)
        setattr(b, field, value)
        assert lib.rav1d_fg_frame_host(ctypes.byref(b)) == -1, field


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
