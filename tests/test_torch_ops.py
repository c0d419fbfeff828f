"""The port's ops against the JAX package's, on the same numpy inputs.

ipred_dyn modes (base, z1/z2/z3, filter, cfl), filter_lines_batch,
find_dir_batch, cdef_filter_batch, wiener_batch and sgr_batch of
rav1d_tpu_torch.ops against rav1d_tpu.ops.tpu. Tolerance: exact
(assert_array_equal on every output element, including the lanes beyond
an item's block size, which both sides compute the same way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rav1d_tpu.ops.tpu import cdef as JC
from rav1d_tpu.ops.tpu import ipred_dyn as JD
from rav1d_tpu.ops.tpu import lf as JL
from rav1d_tpu.ops.tpu import lr as JR
from rav1d_tpu.tables.spec_data import SGR_PARAMS
from rav1d_tpu_torch.ops import cdef as TC
from rav1d_tpu_torch.ops import ipred_dyn as TD
from rav1d_tpu_torch.ops import lf as TL
from rav1d_tpu_torch.ops import lr as TR

BASE = ["dc_dyn", "dc_top_dyn", "dc_left_dyn", "dc_128_dyn", "v_dyn",
        "h_dyn", "paeth_dyn", "smooth_dyn", "smooth_v_dyn", "smooth_h_dyn"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _sizes(CW, CH):
    return [(w, h) for w in (4, 8, 16, 32, 64) for h in (4, 8, 16, 32, 64)
            if w <= CW and h <= CH and max(w, h) <= 4 * min(w, h)]


def _edges(rng, CW, CH, bpc, reps=2):
    sizes = _sizes(CW, CH) * reps
    B = len(sizes)
    edge = rng.integers(0, 1 << bpc, (B, 2 * CH + 1 + 2 * CW)).astype(np.int32)
    w = np.array([s[0] for s in sizes], np.int32)
    h = np.array([s[1] for s in sizes], np.int32)
    return edge, w, h


@pytest.mark.parametrize("CW,CH", [(16, 16), (64, 64)])
@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_base_modes(CW, CH, bpc):
    rng = np.random.default_rng(CW + bpc)
    edge, w, h = _edges(rng, CW, CH, bpc)
    C = 2 * CH
    for name in BASE:
        ref = getattr(JD, name)(jnp.asarray(edge), C, CW, CH, jnp.asarray(w),
                                jnp.asarray(h), bpc)
        got = getattr(TD, name)(_t(edge), C, CW, CH, _t(w), _t(h), bpc)
        _eq(got, ref)


def _angles(rng, n, lo, hi):
    out = []
    bases = [90, 180, 45, 135, 113, 157, 203, 67]
    while len(out) < n:
        a = int(rng.choice(bases)) + 3 * int(rng.integers(-3, 4))
        if lo < a < hi:
            out.append(a | (int(rng.integers(0, 2)) << 9)
                       | (int(rng.integers(0, 2)) << 10))
    return np.array(out, np.int32)


@pytest.mark.parametrize("CW,CH", [(16, 16), (64, 64)])
@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("z", ["z1", "z2", "z3"])
def test_z_modes(CW, CH, bpc, z):
    rng = np.random.default_rng(CW * 7 + bpc + ord(z[1]))
    edge, w, h = _edges(rng, CW, CH, bpc, reps=3)
    C = 2 * CH
    B = edge.shape[0]
    lo, hi = {"z1": (0, 90), "z2": (90, 180), "z3": (180, 270)}[z]
    ang = _angles(rng, B, lo, hi)
    if z == "z2":
        mw = (w + rng.integers(0, 8, B)).astype(np.int32)
        mh = (h + rng.integers(0, 8, B)).astype(np.int32)
        sm = rng.integers(0, 2, B).astype(bool)
        ref = JD.z2_dyn(jnp.asarray(edge), C, CW, CH, jnp.asarray(w),
                        jnp.asarray(h), bpc, jnp.asarray(ang),
                        jnp.asarray(mw), jnp.asarray(mh), jnp.asarray(sm))
        got = TD.z2_dyn(_t(edge), C, CW, CH, _t(w), _t(h), bpc, _t(ang),
                        _t(mw), _t(mh), _t(sm))
    else:
        fn = z + "_dyn"
        ref = getattr(JD, fn)(jnp.asarray(edge), C, CW, CH, jnp.asarray(w),
                              jnp.asarray(h), bpc, jnp.asarray(ang))
        got = getattr(TD, fn)(_t(edge), C, CW, CH, _t(w), _t(h), bpc, _t(ang))
    _eq(got, ref)


# (ext, bpc); the 8-bit cases keep the ids they had before 10 and 12
EXT_BPC = [(e, b) for b in (8, 10, 12) for e in (None, 32)]


@pytest.mark.parametrize("CW,CH", [(16, 16), (64, 64)])
@pytest.mark.parametrize(
    "ext,bpc", EXT_BPC,
    ids=[str(e) if b == 8 else "%s-%dbit" % (e, b) for e, b in EXT_BPC])
def test_filter_intra(CW, CH, ext, bpc):
    rng = np.random.default_rng(CW + bpc - 8)
    cases = [(w, h) for w in (4, 8, 16, 32) for h in (4, 8, 16, 32)
             if w <= CW and h <= CH]
    C = 2 * CH
    edge = rng.integers(0, 1 << bpc, (len(cases), 2 * CH + 1 + 2 * CW)
                        ).astype(np.int32)
    w = np.array([c[0] for c in cases], np.int32)
    h = np.array([c[1] for c in cases], np.int32)
    fi = rng.integers(0, 5, len(cases)).astype(np.int32)
    ref = JD.filter_dyn(jnp.asarray(edge), C, CW, CH, jnp.asarray(w),
                        jnp.asarray(h), bpc, jnp.asarray(fi))
    # the port may bound its walk by the largest filter block (32x32)
    got = TD.filter_dyn(_t(edge), C, CW, CH, _t(w), _t(h), bpc, _t(fi),
                        ext_w=ext, ext_h=ext)
    _eq(got, ref)


@pytest.mark.parametrize("ss_hor,ss_ver", [(1, 1), (1, 0), (0, 0)])
def test_cfl(ss_hor, ss_ver):
    rng = np.random.default_rng(3 + ss_hor + 2 * ss_ver)
    CW = CH = 16
    cases = [(w, h) for w in (4, 8, 16) for h in (4, 8, 16)] * 2
    B = len(cases)
    ypx = rng.integers(0, 256, (B, CH << ss_ver, CW << ss_hor)).astype(np.int32)
    w = np.array([c[0] for c in cases], np.int32)
    h = np.array([c[1] for c in cases], np.int32)
    wp = np.array([rng.integers(0, max(c[0] // 4 - 1, 1)) for c in cases], np.int32)
    hp = np.array([rng.integers(0, max(c[1] // 4 - 1, 1)) for c in cases], np.int32)
    ref = JD.cfl_ac_dyn(jnp.asarray(ypx), CW, CH, jnp.asarray(w),
                        jnp.asarray(h), ss_hor, ss_ver, jnp.asarray(wp),
                        jnp.asarray(hp))
    got = TD.cfl_ac_dyn(_t(ypx), CW, CH, _t(w), _t(h), ss_hor, ss_ver,
                        _t(wp), _t(hp))
    _eq(got, ref)
    dc = rng.integers(0, 256, B).astype(np.int32)
    alpha = rng.integers(-16, 17, B).astype(np.int32)
    ref2 = JD.cfl_pred_dyn(jnp.asarray(dc), ref, jnp.asarray(alpha), 8)
    got2 = TD.cfl_pred_dyn(_t(dc), got, _t(alpha), 8)
    _eq(got2, ref2)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("wd", [4, 6, 8, 16])
def test_filter_lines(bpc, wd):
    rng = np.random.default_rng(wd * 31 + bpc)
    N = 257
    mx = (1 << bpc) - 1
    px = rng.integers(0, mx, (N, 16)).astype(np.int32)
    base = rng.integers(0, mx, (N // 2, 1))
    px[: N // 2] = base + rng.integers(-2, 3, (N // 2, 16))
    px = np.clip(px, 0, mx).astype(np.int32)
    L = rng.integers(1, 64, N).astype(np.int32)
    E = (2 * (L + 2) + np.minimum(L, 9)).astype(np.int32)
    I = np.maximum(L >> 1, 1).astype(np.int32)
    H = (L >> 4).astype(np.int32)
    ref = JL.filter_lines_batch(px, E, I, H, wd, bpc)
    got = TL.filter_lines_batch(_t(px), _t(E), _t(I), _t(H), wd, bpc)
    _eq(got, ref)


@pytest.mark.parametrize("bpc", [8, 10, 12])
def test_find_dir(bpc):
    rng = np.random.default_rng(bpc)
    blocks = rng.integers(0, 1 << bpc, (200, 8, 8)).astype(np.int32)
    # extreme blocks: the cost sums wrap in int32 there
    blocks[:20] = np.where(rng.integers(0, 2, (20, 8, 8)), (1 << bpc) - 1, 0)
    rd, rv = JC.find_dir_batch(blocks, bpc)
    gd, gv = TC.find_dir_batch(_t(blocks), bpc)
    _eq(gd, rd)
    _eq(gv, rv)


# (h, w, bpc); the 8-bit cases keep the ids they had before 10 and 12
HW_BPC = [(h, w, b) for b in (8, 10, 12) for h, w in ((8, 8), (4, 4), (8, 4))]


@pytest.mark.parametrize(
    "hw,bpc", [((h, w), b) for h, w, b in HW_BPC],
    ids=["hw%d" % (i % 3) if b == 8 else "%dx%d-%dbit" % (h, w, b)
         for i, (h, w, b) in enumerate(HW_BPC)])
def test_cdef_filter(hw, bpc):
    h, w = hw
    rng = np.random.default_rng(h * 10 + w + bpc - 8)
    N = 96
    tiles = rng.integers(0, 1 << bpc, (N, h + 4, w + 4)).astype(np.int32)
    for n in range(N):
        if n % 3 == 0:
            tiles[n, :2, :] = TC.MISSING
        if n % 4 == 0:
            tiles[n, :, :2] = TC.MISSING
        if n % 5 == 0:
            tiles[n, -2:, :] = TC.MISSING
    # strengths are scaled by the bit depth (cdef_apply.rs)
    pri = (rng.integers(0, 16, N) << (bpc - 8)).astype(np.int32)
    sec = np.asarray([0, 1, 2, 4] * (N // 4), np.int32) << (bpc - 8)
    pri[::7] = 0
    direction = rng.integers(0, 8, N).astype(np.int32)
    damping = rng.integers(3, 7, N).astype(np.int32)
    ref = JC.cdef_filter_batch(tiles, pri, sec, direction, damping, bpc)
    got = TC.cdef_filter_batch(_t(tiles), _t(pri), _t(sec), _t(direction),
                               _t(damping), bpc)
    _eq(got, ref)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(96, 64), (64, 33)])
def test_wiener(bpc, w, h):
    rng = np.random.default_rng(w + h + bpc)
    N = 5
    tmps = rng.integers(0, (1 << bpc) - 1, (N, h + 6, w + 6)).astype(np.int32)
    fhs = rng.integers(-16, 16, (N, 3)).astype(np.int32)
    fvs = rng.integers(-16, 16, (N, 3)).astype(np.int32)
    ref = JR.wiener_batch(tmps, fhs, fvs, w, h, bpc)
    got = TR.wiener_batch(_t(tmps), _t(fhs), _t(fvs), w, h, bpc)
    _eq(got, ref)


@pytest.mark.parametrize("bpc", [8, 10, 12])
@pytest.mark.parametrize("kind", [0, 1, 2])
def test_sgr(bpc, kind):
    rng = np.random.default_rng(bpc * 3 + kind)
    idxs = {
        0: [i for i in range(16) if SGR_PARAMS[i][0] and not SGR_PARAMS[i][1]],
        1: [i for i in range(16) if not SGR_PARAMS[i][0] and SGR_PARAMS[i][1]],
        2: [i for i in range(16) if SGR_PARAMS[i][0] and SGR_PARAMS[i][1]],
    }[kind]
    N, w, h = 5, 96, 64
    tmps = rng.integers(0, (1 << bpc) - 1, (N, h + 6, w + 6)).astype(np.int32)
    cur = rng.integers(0, (1 << bpc) - 1, (N, h, w)).astype(np.int32)
    sel = rng.choice(idxs, N)
    wts = rng.integers(-96, 32, (N, 2))
    s0 = np.asarray([SGR_PARAMS[i][0] for i in sel], np.int32)
    s1 = np.asarray([SGR_PARAMS[i][1] for i in sel], np.int32)
    w0w1 = np.stack([wts[:, 0], 128 - (wts[:, 0] + wts[:, 1])], 1).astype(np.int32)
    ref = JR.sgr_batch(cur, tmps, s0, s1, w0w1, w, h, kind, bpc)
    got = TR.sgr_batch(_t(cur), _t(tmps), _t(s0), _t(s1), _t(w0w1), w, h,
                       kind, bpc)
    _eq(got, ref)
