"""Motion compensation: 8-tap/bilinear put+prep, compound combiners,
warp, emu_edge, resize.

Behavior parity: src/mc.rs (put_8tap_rust:130, prep_8tap_rust:277,
*_scaled, put/prep_bilin, avg:654, w_avg:681, mask:711, blend*:747,
w_mask:814, warp_affine_8x8(t):896, emu_edge:1026, resize:1114).
Vectorized with numpy over rows/columns; exact integer arithmetic.

Conventions: all image planes are 2D numpy arrays. `prep` intermediates
are int32 (h, w) arrays holding the reference's i16 values (PREP_BIAS
subtracted). Sub-pel filter taps are selected per dav1d's
get_filter(m, d, type): 4-wide blocks use the 4-tap rows of the table.
"""

from __future__ import annotations

import numpy as np

from ...tables.spec_data import (
    MC_SUBPEL_FILTERS,
    MC_WARP_FILTER,
    OBMC_MASKS,
    RESIZE_FILTER,
)

# FILTER_DIR[filter2d] = (h_type, v_type). The Filter2d enum NAME is
# (horizontal, vertical): mc_tmpl.c:376 filter_fns(regular_smooth,
# h=REGULAR, v=SMOOTH). Verified against the C dsp via harness.
FILTER_DIR = [
    (0, 0), (0, 1), (0, 2),
    (2, 0), (2, 1), (2, 2),
    (1, 0), (1, 1), (1, 2),
    (3, 3),
]


def intermediate_bits(bpc):
    return 4 if bpc <= 10 else 2


def prep_bias(bpc):
    return 0 if bpc == 8 else 8192


def _i16(a):
    """Wrap an int array to i16 like the reference's `as i16` casts."""
    return ((a + 0x8000) & 0xFFFF) - 0x8000


def _get_filter(m, d, ftype):
    """mc.rs get_filter: returns 8-tap row or None for full-pel."""
    if m == 0:
        return None
    i = ftype if d > 4 else 3 + (ftype & 1)
    return MC_SUBPEL_FILTERS[i][m - 1]


def _hfilter(region, fh, w):
    """Horizontal 8-tap over a (rows, w+7) region -> (rows, w) int64."""
    r = region.astype(np.int64)
    acc = np.zeros((r.shape[0], w), dtype=np.int64)
    for k in range(8):
        acc += int(fh[k]) * r[:, k : k + w]
    return acc


def _vfilter(mid, fv, h):
    """Vertical 8-tap over a (h+7, w) array -> (h, w) int64."""
    m = mid.astype(np.int64)
    acc = np.zeros((h, m.shape[1]), dtype=np.int64)
    for k in range(8):
        acc += int(fv[k]) * m[k : k + h, :]
    return acc


def put_8tap(dst, dy, dx, src, sy, sx, w, h, mx, my, filter2d, bpc):
    """mc.rs put_8tap_rust:130. Reads src[sy-3.., sx-3..]; caller ensures
    bounds (emu_edge)."""
    ft_h, ft_v = FILTER_DIR[filter2d]
    ib = intermediate_bits(bpc)
    intermediate_rnd = 32 + ((1 << (6 - ib)) >> 1)
    fh = _get_filter(mx, w, ft_h)
    fv = _get_filter(my, h, ft_v)
    pxmax = (1 << bpc) - 1

    if fh is not None:
        if fv is not None:
            region = src[sy - 3 : sy + h + 4, sx - 3 : sx + w + 4]
            mid = _hfilter(region, fh, w)
            sh = 6 - ib
            mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
            out = _vfilter(mid, fv, h)
            sh = 6 + ib
            out = np.clip((out + ((1 << sh) >> 1)) >> sh, 0, pxmax)
        else:
            region = src[sy : sy + h, sx - 3 : sx + w + 4]
            out = _hfilter(region, fh, w)
            out = np.clip((out + intermediate_rnd) >> 6, 0, pxmax)
    elif fv is not None:
        region = src[sy - 3 : sy + h + 4, sx : sx + w]
        out = _vfilter(region, fv, h)
        out = np.clip((out + 32) >> 6, 0, pxmax)
    else:
        out = src[sy : sy + h, sx : sx + w]
    dst[dy : dy + h, dx : dx + w] = out


def put_8tap_batch(dst, src, dys, dxs, sys_, sxs, w, h, mxs, mys, f2ds,
                   vis_w, vis_h, bpc):
    """Batched put_8tap over N same-size blocks of one (dst, src) plane pair.
    See compute_8tap_batch; kept for same-dst batches."""
    out = compute_8tap_batch(src, sys_, sxs, w, h, mxs, mys, f2ds, vis_w,
                             vis_h, bpc)
    dys = np.asarray(dys)
    dxs = np.asarray(dxs)
    drows = dys[:, None] + np.arange(h)[None, :]
    dcols = dxs[:, None] + np.arange(w)[None, :]
    dst[drows[:, :, None], dcols[:, None, :]] = out.astype(dst.dtype)


def compute_8tap_batch(src, sys_, sxs, w, h, mxs, mys, f2ds, vis_w, vis_h, bpc):
    """Batched 8-tap filtering over N same-size blocks of one src plane.

    All jobs share (w, h) and the same subpel-presence pattern
    (all mxs nonzero or all zero; same for mys) — the executor buckets by
    that. Source windows are gathered with coordinate clamping, which
    reproduces emu_edge's border replication exactly. This gather→separable
    filter dataflow is the TPU mc kernel shape. Returns (N, h, w) int64."""
    N = len(sys_)
    sys_ = np.asarray(sys_)
    sxs = np.asarray(sxs)
    mxs = np.asarray(mxs)
    mys = np.asarray(mys)
    f2ds = np.asarray(f2ds)
    F = np.asarray(MC_SUBPEL_FILTERS, dtype=np.int64)
    FD = np.asarray(FILTER_DIR, dtype=np.int64)[f2ds]  # (N, 2)
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    has_h = bool(mxs[0])
    has_v = bool(mys[0])

    def gather(y0s, nrow, x0s, ncol):
        rows = np.clip(y0s[:, None] + np.arange(nrow)[None, :], 0, vis_h - 1)
        cols = np.clip(x0s[:, None] + np.arange(ncol)[None, :], 0, vis_w - 1)
        # i32 accumulation is exact: |px|<=4095, |tap|<=127, 8 taps, and
        # the v-pass sums i16 mids * taps (<= 2^25)
        return src[rows[:, :, None], cols[:, None, :]].astype(np.int32)

    def hrow(ft_dir):
        i = np.where(w > 4, ft_dir, 3 + (ft_dir & 1))
        return F[i, mxs - 1].astype(np.int32)  # (N, 8)

    def vrow(ft_dir):
        i = np.where(h > 4, ft_dir, 3 + (ft_dir & 1))
        return F[i, mys - 1].astype(np.int32)

    if has_h and has_v:
        win = gather(sys_ - 3, h + 7, sxs - 3, w + 7)
        fh = hrow(FD[:, 0])
        fv = vrow(FD[:, 1])
        mid = np.zeros((N, h + 7, w), dtype=np.int32)
        for k in range(8):
            mid += fh[:, k, None, None] * win[:, :, k : k + w]
        sh = 6 - ib
        mid = _i16((mid + ((1 << sh) >> 1)) >> sh).astype(np.int32)
        out = np.zeros((N, h, w), dtype=np.int32)
        for k in range(8):
            out += fv[:, k, None, None] * mid[:, k : k + h, :]
        sh = 6 + ib
        out = np.clip((out + ((1 << sh) >> 1)) >> sh, 0, pxmax)
    elif has_h:
        win = gather(sys_, h, sxs - 3, w + 7)
        fh = hrow(FD[:, 0])
        out = np.zeros((N, h, w), dtype=np.int32)
        for k in range(8):
            out += fh[:, k, None, None] * win[:, :, k : k + w]
        intermediate_rnd = 32 + ((1 << (6 - ib)) >> 1)
        out = np.clip((out + intermediate_rnd) >> 6, 0, pxmax)
    elif has_v:
        win = gather(sys_ - 3, h + 7, sxs, w)
        fv = vrow(FD[:, 1])
        out = np.zeros((N, h, w), dtype=np.int32)
        for k in range(8):
            out += fv[:, k, None, None] * win[:, k : k + h, :]
        out = np.clip((out + 32) >> 6, 0, pxmax)
    else:
        out = gather(sys_, h, sxs, w)
    return out


def compute_prep_8tap_batch(src, sys_, sxs, w, h, mxs, mys, f2ds, vis_w,
                            vis_h, bpc):
    """Batched prep_8tap over N same-size blocks of one src plane (same
    bucketing rules as compute_8tap_batch). Returns (N, h, w) int32 prep
    intermediates (i16 values, PREP_BIAS subtracted)."""
    N = len(sys_)
    sys_ = np.asarray(sys_)
    sxs = np.asarray(sxs)
    mxs = np.asarray(mxs)
    mys = np.asarray(mys)
    f2ds = np.asarray(f2ds)
    F = np.asarray(MC_SUBPEL_FILTERS, dtype=np.int64)
    FD = np.asarray(FILTER_DIR, dtype=np.int64)[f2ds]
    ib = intermediate_bits(bpc)
    bias = prep_bias(bpc)
    has_h = bool(mxs[0])
    has_v = bool(mys[0])

    def gather(y0s, nrow, x0s, ncol):
        rows = np.clip(y0s[:, None] + np.arange(nrow)[None, :], 0, vis_h - 1)
        cols = np.clip(x0s[:, None] + np.arange(ncol)[None, :], 0, vis_w - 1)
        return src[rows[:, :, None], cols[:, None, :]].astype(np.int64)

    def hrow(ft_dir):
        i = np.where(w > 4, ft_dir, 3 + (ft_dir & 1))
        return F[i, mxs - 1]

    def vrow(ft_dir):
        i = np.where(h > 4, ft_dir, 3 + (ft_dir & 1))
        return F[i, mys - 1]

    sh = 6 - ib
    if has_h and has_v:
        win = gather(sys_ - 3, h + 7, sxs - 3, w + 7)
        fh = hrow(FD[:, 0])
        fv = vrow(FD[:, 1])
        mid = np.zeros((N, h + 7, w), dtype=np.int64)
        for k in range(8):
            mid += fh[:, k, None, None] * win[:, :, k : k + w]
        mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
        out = np.zeros((N, h, w), dtype=np.int64)
        for k in range(8):
            out += fv[:, k, None, None] * mid[:, k : k + h, :]
        out = ((out + 32) >> 6) - bias
    elif has_h:
        win = gather(sys_, h, sxs - 3, w + 7)
        fh = hrow(FD[:, 0])
        out = np.zeros((N, h, w), dtype=np.int64)
        for k in range(8):
            out += fh[:, k, None, None] * win[:, :, k : k + w]
        out = ((out + ((1 << sh) >> 1)) >> sh) - bias
    elif has_v:
        win = gather(sys_ - 3, h + 7, sxs, w)
        fv = vrow(FD[:, 1])
        out = np.zeros((N, h, w), dtype=np.int64)
        for k in range(8):
            out += fv[:, k, None, None] * win[:, k : k + h, :]
        out = ((out + ((1 << sh) >> 1)) >> sh) - bias
    else:
        out = (gather(sys_, h, sxs, w) << ib) - bias
    return _i16(out).astype(np.int32)


def prep_8tap(src, sy, sx, w, h, mx, my, filter2d, bpc):
    """mc.rs prep_8tap_rust:277. Returns (h, w) int32 intermediate."""
    ft_h, ft_v = FILTER_DIR[filter2d]
    ib = intermediate_bits(bpc)
    bias = prep_bias(bpc)
    fh = _get_filter(mx, w, ft_h)
    fv = _get_filter(my, h, ft_v)

    if fh is not None:
        if fv is not None:
            region = src[sy - 3 : sy + h + 4, sx - 3 : sx + w + 4]
            mid = _hfilter(region, fh, w)
            sh = 6 - ib
            mid = _i16((mid + ((1 << sh) >> 1)) >> sh)
            out = _vfilter(mid, fv, h)
            out = ((out + 32) >> 6) - bias
        else:
            region = src[sy : sy + h, sx - 3 : sx + w + 4]
            sh = 6 - ib
            out = ((_hfilter(region, fh, w) + ((1 << sh) >> 1)) >> sh) - bias
    elif fv is not None:
        region = src[sy - 3 : sy + h + 4, sx : sx + w]
        sh = 6 - ib
        out = ((_vfilter(region, fv, h) + ((1 << sh) >> 1)) >> sh) - bias
    else:
        out = (src[sy : sy + h, sx : sx + w].astype(np.int64) << ib) - bias
    return _i16(out).astype(np.int32)


def put_8tap_scaled(dst, dy_, dx_, src, sy, sx, w, h, mx, my, dx, dy, filter2d, bpc):
    """mc.rs put_8tap_scaled_rust:212. mx/my are 10-bit subpel starts,
    dx/dy the 10-bit steps."""
    ft_h, ft_v = FILTER_DIR[filter2d]
    ib = intermediate_bits(bpc)
    intermediate_rnd = (1 << ib) >> 1
    pxmax = (1 << bpc) - 1
    tmp_h = (((h - 1) * dy + my) >> 10) + 8
    mid = np.zeros((tmp_h, w), dtype=np.int64)
    s64 = src.astype(np.int64)
    for yy in range(tmp_h):
        imx = mx
        ioff = 0
        row = s64[sy - 3 + yy]
        for x in range(w):
            fh = _get_filter(imx >> 6, w, ft_h)
            if fh is not None:
                v = 0
                for k in range(8):
                    v += int(fh[k]) * int(row[sx + ioff + k - 3])
                sh = 6 - ib
                mid[yy, x] = (v + ((1 << sh) >> 1)) >> sh
            else:
                mid[yy, x] = int(row[sx + ioff]) << ib
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
    mid = _i16(mid)
    mrow = 3
    out = np.zeros((h, w), dtype=np.int64)
    for yy in range(h):
        fv = _get_filter(my >> 6, h, ft_v)
        if fv is not None:
            v = np.zeros(w, dtype=np.int64)
            for k in range(8):
                v += int(fv[k]) * mid[mrow + k - 3]
            sh = 6 + ib
            out[yy] = np.clip((v + ((1 << sh) >> 1)) >> sh, 0, pxmax)
        else:
            out[yy] = np.clip((mid[mrow] + intermediate_rnd) >> ib, 0, pxmax)
        my += dy
        mrow += my >> 10
        my &= 0x3FF
    dst[dy_ : dy_ + h, dx_ : dx_ + w] = out


def prep_8tap_scaled(src, sy, sx, w, h, mx, my, dx, dy, filter2d, bpc):
    """mc.rs prep_8tap_scaled_rust:351."""
    ft_h, ft_v = FILTER_DIR[filter2d]
    ib = intermediate_bits(bpc)
    bias = prep_bias(bpc)
    tmp_h = (((h - 1) * dy + my) >> 10) + 8
    mid = np.zeros((tmp_h, w), dtype=np.int64)
    s64 = src.astype(np.int64)
    for yy in range(tmp_h):
        imx = mx
        ioff = 0
        row = s64[sy - 3 + yy]
        for x in range(w):
            fh = _get_filter(imx >> 6, w, ft_h)
            if fh is not None:
                v = 0
                for k in range(8):
                    v += int(fh[k]) * int(row[sx + ioff + k - 3])
                sh = 6 - ib
                mid[yy, x] = (v + ((1 << sh) >> 1)) >> sh
            else:
                mid[yy, x] = int(row[sx + ioff]) << ib
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
    mid = _i16(mid)
    mrow = 3
    out = np.zeros((h, w), dtype=np.int64)
    for yy in range(h):
        fv = _get_filter(my >> 6, h, ft_v)
        if fv is not None:
            v = np.zeros(w, dtype=np.int64)
            for k in range(8):
                v += int(fv[k]) * mid[mrow + k - 3]
            out[yy] = ((v + 32) >> 6) - bias
        else:
            out[yy] = mid[mrow] - bias
        my += dy
        mrow += my >> 10
        my &= 0x3FF
    return _i16(out).astype(np.int32)


def _bilin_h(region, mx, w):
    r = region.astype(np.int64)
    return 16 * r[:, :w] + mx * (r[:, 1 : w + 1] - r[:, :w])


def _bilin_v(mid, my, h):
    m = mid.astype(np.int64)
    return 16 * m[:h, :] + my * (m[1 : h + 1, :] - m[:h, :])


def put_bilin(dst, dy, dx, src, sy, sx, w, h, mx, my, bpc):
    """mc.rs put_bilin_rust:431."""
    ib = intermediate_bits(bpc)
    intermediate_rnd = (1 << ib) >> 1
    pxmax = (1 << bpc) - 1
    if mx:
        if my:
            region = src[sy : sy + h + 1, sx : sx + w + 1]
            sh = 4 - ib
            mid = _i16((_bilin_h(region, mx, w) + ((1 << sh) >> 1)) >> sh)
            sh = 4 + ib
            out = np.clip((_bilin_v(mid, my, h) + ((1 << sh) >> 1)) >> sh, 0, pxmax)
        else:
            region = src[sy : sy + h, sx : sx + w + 1]
            sh = 4 - ib
            px = (_bilin_h(region, mx, w) + ((1 << sh) >> 1)) >> sh
            out = np.clip((px + intermediate_rnd) >> ib, 0, pxmax)
    elif my:
        region = src[sy : sy + h + 1, sx : sx + w]
        out = np.clip((_bilin_v(region, my, h) + 8) >> 4, 0, pxmax)
    else:
        out = src[sy : sy + h, sx : sx + w]
    dst[dy : dy + h, dx : dx + w] = out


def prep_bilin(src, sy, sx, w, h, mx, my, bpc):
    """mc.rs prep_bilin_rust:543."""
    ib = intermediate_bits(bpc)
    bias = prep_bias(bpc)
    if mx:
        if my:
            region = src[sy : sy + h + 1, sx : sx + w + 1]
            sh = 4 - ib
            mid = _i16((_bilin_h(region, mx, w) + ((1 << sh) >> 1)) >> sh)
            out = ((_bilin_v(mid, my, h) + 8) >> 4) - bias
        else:
            region = src[sy : sy + h, sx : sx + w + 1]
            sh = 4 - ib
            out = ((_bilin_h(region, mx, w) + ((1 << sh) >> 1)) >> sh) - bias
    elif my:
        region = src[sy : sy + h + 1, sx : sx + w]
        sh = 4 - ib
        out = ((_bilin_v(region, my, h) + ((1 << sh) >> 1)) >> sh) - bias
    else:
        out = (src[sy : sy + h, sx : sx + w].astype(np.int64) << ib) - bias
    return _i16(out).astype(np.int32)


def put_bilin_scaled(dst, dy_, dx_, src, sy, sx, w, h, mx, my, dx, dy, bpc):
    """mc.rs put_bilin_scaled_rust:496."""
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    tmp_h = (((h - 1) * dy + my) >> 10) + 2
    mid = np.zeros((tmp_h, w), dtype=np.int64)
    s64 = src.astype(np.int64)
    for yy in range(tmp_h):
        imx = mx
        ioff = 0
        row = s64[sy + yy]
        sh = 4 - ib
        for x in range(w):
            fmx = imx >> 6
            v = 16 * int(row[sx + ioff]) + fmx * (
                int(row[sx + ioff + 1]) - int(row[sx + ioff])
            )
            mid[yy, x] = (v + ((1 << sh) >> 1)) >> sh
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
    mid = _i16(mid)
    mrow = 0
    out = np.zeros((h, w), dtype=np.int64)
    sh = 4 + ib
    for yy in range(h):
        fmy = my >> 6
        v = 16 * mid[mrow] + fmy * (mid[mrow + 1] - mid[mrow])
        out[yy] = np.clip((v + ((1 << sh) >> 1)) >> sh, 0, pxmax)
        my += dy
        mrow += my >> 10
        my &= 0x3FF
    dst[dy_ : dy_ + h, dx_ : dx_ + w] = out


def prep_bilin_scaled(src, sy, sx, w, h, mx, my, dx, dy, bpc):
    """mc.rs prep_bilin_scaled_rust:608."""
    ib = intermediate_bits(bpc)
    bias = prep_bias(bpc)
    tmp_h = (((h - 1) * dy + my) >> 10) + 2
    mid = np.zeros((tmp_h, w), dtype=np.int64)
    s64 = src.astype(np.int64)
    for yy in range(tmp_h):
        imx = mx
        ioff = 0
        row = s64[sy + yy]
        sh = 4 - ib
        for x in range(w):
            fmx = imx >> 6
            v = 16 * int(row[sx + ioff]) + fmx * (
                int(row[sx + ioff + 1]) - int(row[sx + ioff])
            )
            mid[yy, x] = (v + ((1 << sh) >> 1)) >> sh
            imx += dx
            ioff += imx >> 10
            imx &= 0x3FF
    mid = _i16(mid)
    mrow = 0
    out = np.zeros((h, w), dtype=np.int64)
    for yy in range(h):
        fmy = my >> 6
        v = 16 * mid[mrow] + fmy * (mid[mrow + 1] - mid[mrow])
        out[yy] = ((v + 8) >> 4) - bias
        my += dy
        mrow += my >> 10
        my &= 0x3FF
    return _i16(out).astype(np.int32)


def avg(dst, dy, dx, tmp1, tmp2, w, h, bpc):
    """mc.rs avg_rust:654."""
    ib = intermediate_bits(bpc)
    sh = ib + 1
    rnd = (1 << ib) + prep_bias(bpc) * 2
    out = (tmp1.astype(np.int64) + tmp2.astype(np.int64) + rnd) >> sh
    dst[dy : dy + h, dx : dx + w] = np.clip(out, 0, (1 << bpc) - 1)


def w_avg(dst, dy, dx, tmp1, tmp2, w, h, weight, bpc):
    """mc.rs w_avg_rust:681."""
    ib = intermediate_bits(bpc)
    sh = ib + 4
    rnd = (8 << ib) + prep_bias(bpc) * 16
    out = (
        tmp1.astype(np.int64) * weight + tmp2.astype(np.int64) * (16 - weight) + rnd
    ) >> sh
    dst[dy : dy + h, dx : dx + w] = np.clip(out, 0, (1 << bpc) - 1)


def mask(dst, dy, dx, tmp1, tmp2, w, h, msk, bpc):
    """mc.rs mask_rust:711. msk: (h, w) uint8-ish array."""
    ib = intermediate_bits(bpc)
    sh = ib + 6
    rnd = (32 << ib) + prep_bias(bpc) * 64
    m = msk.astype(np.int64)
    out = (tmp1.astype(np.int64) * m + tmp2.astype(np.int64) * (64 - m) + rnd) >> sh
    dst[dy : dy + h, dx : dx + w] = np.clip(out, 0, (1 << bpc) - 1)


def blend(dst, dy, dx, tmp, w, h, msk):
    """mc.rs blend_rust:747. tmp: (h, w) pixel array; msk: (h, w)."""
    a = dst[dy : dy + h, dx : dx + w].astype(np.int64)
    b = tmp.astype(np.int64)
    m = msk.astype(np.int64)
    dst[dy : dy + h, dx : dx + w] = (a * (64 - m) + b * m + 32) >> 6


def blend_v(dst, dy, dx, tmp, w, h):
    """mc.rs blend_v_rust:771 (obmc left-neighbour blend)."""
    vw = (w * 3) >> 2
    m = OBMC_MASKS[w : w + vw].astype(np.int64)
    a = dst[dy : dy + h, dx : dx + vw].astype(np.int64)
    b = tmp[:, :vw].astype(np.int64)
    dst[dy : dy + h, dx : dx + vw] = (a * (64 - m) + b * m + 32) >> 6


def blend_h(dst, dy, dx, tmp, w, h):
    """mc.rs blend_h_rust (obmc top-neighbour blend)."""
    vh = (h * 3) >> 2
    m = OBMC_MASKS[h : h + vh].astype(np.int64)[:, None]
    a = dst[dy : dy + vh, dx : dx + w].astype(np.int64)
    b = tmp[:vh, :].astype(np.int64)
    dst[dy : dy + vh, dx : dx + w] = (a * (64 - m) + b * m + 32) >> 6


def w_mask(dst, dy, dx, tmp1, tmp2, w, h, sign, ss_hor, ss_ver, bpc):
    """mc.rs w_mask_rust:814. Returns the (h>>ss_ver, w>>ss_hor) mask."""
    ib = intermediate_bits(bpc)
    sh = ib + 6
    rnd = (32 << ib) + prep_bias(bpc) * 64
    mask_sh = bpc + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    t1 = tmp1.astype(np.int64)
    t2 = tmp2.astype(np.int64)
    m = np.minimum(38 + ((np.abs(t1 - t2) + mask_rnd) >> mask_sh), 64)
    out = (t1 * m + t2 * (64 - m) + rnd) >> sh
    dst[dy : dy + h, dx : dx + w] = np.clip(out, 0, (1 << bpc) - 1)

    if ss_hor:
        mn = m[:, 0::2] + m[:, 1::2]  # m + n per 2-wide pair
        if ss_ver:
            # 4:2:0 — even rows store m+n; odd rows fold: (prev + m+n + 2-sign)>>2
            folded = (mn[0::2] + mn[1::2] + 2 - sign) >> 2
            return folded.astype(np.uint8)
        return ((mn + 1 - sign) >> 1).astype(np.uint8)
    return m.astype(np.uint8)


_WARP_F = None


def _warp_filters():
    global _WARP_F
    if _WARP_F is None:
        _WARP_F = np.asarray(MC_WARP_FILTER, dtype=np.int64)
    return _WARP_F


def _warp_pass(src, sy, sx, abcd, mx, my, ib):
    """Shared warp passes: returns (vert_acc (8,8) int64 pre-shift).

    Vectorized gather formulation: per-pixel filter phases tmx/tmy are
    affine in (x, y), so the 64-phase warp taps are fetched with one fancy
    index and applied over sliding windows.
    """
    F = _warp_filters()
    ys = np.arange(15, dtype=np.int64)[:, None]
    xs = np.arange(8, dtype=np.int64)[None, :]
    tmx = int(mx) + ys * int(abcd[1]) + xs * int(abcd[0])
    taps = F[64 + ((tmx + 512) >> 10)]  # (15, 8, 8)
    region = np.asarray(src[sy - 3 : sy + 12, sx - 3 : sx + 12], dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(region, 8, axis=1)
    sh = 7 - ib
    mid = _i16(((taps * win).sum(axis=2) + ((1 << sh) >> 1)) >> sh)

    ys8 = np.arange(8, dtype=np.int64)[:, None]
    tmy = int(my) + ys8 * int(abcd[3]) + xs * int(abcd[2])
    vtaps = F[64 + ((tmy + 512) >> 10)]  # (8, 8, 8)
    vwin = np.lib.stride_tricks.sliding_window_view(mid, 8, axis=0)
    return (vtaps * vwin).sum(axis=2)


def warp_affine_8x8(dst, dy, dx, src, sy, sx, abcd, mx, my, bpc):
    """mc.rs warp_affine_8x8_rust:896. Filters a 8x8 block."""
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    v = _warp_pass(src, sy, sx, abcd, mx, my, ib)
    sh = 7 + ib
    dst[dy : dy + 8, dx : dx + 8] = np.clip(
        (v + ((1 << sh) >> 1)) >> sh, 0, pxmax
    )


def warp_affine_8x8_batch(dst, src, dys, dxs, sys_, sxs, abcds, mxs, mys,
                          vis_w, vis_h, bpc):
    """Batched warp_affine_8x8 over N tiles of one (dst, src) plane pair.
    Source windows gathered with coordinate clamping (≡ emu_edge border
    replication); per-tile affine params/phases. TPU warp kernel shape."""
    N = len(dys)
    F = _warp_filters()
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    dys = np.asarray(dys)
    dxs = np.asarray(dxs)
    sys_ = np.asarray(sys_, dtype=np.int64)
    sxs = np.asarray(sxs, dtype=np.int64)
    abcds = np.asarray(abcds, dtype=np.int64)  # (N, 4)
    mxs = np.asarray(mxs, dtype=np.int64)
    mys = np.asarray(mys, dtype=np.int64)

    rows = np.clip(sys_[:, None] - 3 + np.arange(15)[None, :], 0, vis_h - 1)
    cols = np.clip(sxs[:, None] - 3 + np.arange(15)[None, :], 0, vis_w - 1)
    # i32 accumulation is exact here: |px|<=4095, |tap|<=127, 8 taps
    region = src[rows[:, :, None], cols[:, None, :]].astype(np.int32)  # (N,15,15)

    ys = np.arange(15, dtype=np.int64)[None, :, None]
    xs = np.arange(8, dtype=np.int64)[None, None, :]
    tmx = mxs[:, None, None] + ys * abcds[:, 1, None, None] + xs * abcds[:, 0, None, None]
    taps = F[64 + ((tmx + 512) >> 10)].astype(np.int32)  # (N, 15, 8, 8)
    win = np.lib.stride_tricks.sliding_window_view(region, 8, axis=2)  # (N,15,8,8)
    sh = 7 - ib
    mid = _i16(
        (np.einsum("nrxk,nrxk->nrx", taps, win, dtype=np.int32) +
         ((1 << sh) >> 1)) >> sh
    ).astype(np.int32)  # (N,15,8)

    ys8 = np.arange(8, dtype=np.int64)[None, :, None]
    tmy = mys[:, None, None] + ys8 * abcds[:, 3, None, None] + xs * abcds[:, 2, None, None]
    vtaps = F[64 + ((tmy + 512) >> 10)].astype(np.int32)  # (N, 8, 8, 8)
    vwin = np.lib.stride_tricks.sliding_window_view(mid, 8, axis=1)  # (N,8,8,8)
    v = np.einsum("nyxk,nyxk->nyx", vtaps, vwin, dtype=np.int32)
    sh = 7 + ib
    out = np.clip((v + ((1 << sh) >> 1)) >> sh, 0, pxmax)

    drows = dys[:, None] + np.arange(8)[None, :]
    dcols = dxs[:, None] + np.arange(8)[None, :]
    dst[drows[:, :, None], dcols[:, None, :]] = out.astype(dst.dtype)


def warp_affine_8x8t(tmp, ty, tx, src, sy, sx, abcd, mx, my, bpc):
    """mc.rs warp_affine_8x8t_rust:980: prep-domain warp into tmp."""
    ib = intermediate_bits(bpc)
    bias = prep_bias(bpc)
    v = _warp_pass(src, sy, sx, abcd, mx, my, ib)
    tmp[ty : ty + 8, tx : tx + 8] = _i16(((v + 64) >> 7) - bias)


def emu_edge(bw, bh, iw, ih, x, y, ref):
    """mc.rs emu_edge_rust:1026: returns a (bh, bw) block with edge
    replication for out-of-picture regions."""
    dst = np.zeros((bh, bw), dtype=ref.dtype)
    ry = min(max(y, 0), ih - 1)
    rx = min(max(x, 0), iw - 1)
    left_ext = min(max(-x, 0), bw - 1)
    right_ext = min(max(x + bw - iw, 0), bw - 1)
    assert left_ext + right_ext < bw
    top_ext = min(max(-y, 0), bh - 1)
    bottom_ext = min(max(y + bh - ih, 0), bh - 1)
    assert top_ext + bottom_ext < bh
    center_w = bw - left_ext - right_ext
    center_h = bh - top_ext - bottom_ext
    dst[top_ext : top_ext + center_h, left_ext : left_ext + center_w] = ref[
        ry : ry + center_h, rx : rx + center_w
    ]
    if left_ext:
        dst[top_ext : top_ext + center_h, :left_ext] = dst[
            top_ext : top_ext + center_h, left_ext : left_ext + 1
        ]
    if right_ext:
        dst[top_ext : top_ext + center_h, left_ext + center_w :] = dst[
            top_ext : top_ext + center_h,
            left_ext + center_w - 1 : left_ext + center_w,
        ]
    if top_ext:
        dst[:top_ext] = dst[top_ext]
    if bottom_ext:
        dst[top_ext + center_h :] = dst[top_ext + center_h - 1]
    return dst


def resize(dst, dst_y, dst_x0, src, src_y, src_x0, dst_w, h, src_w, dx, mx0, bpc):
    """mc.rs resize_rust:1114: horizontal 8-tap resample (superres)."""
    pxmax = (1 << bpc) - 1
    # precompute per-output-x source positions and filters
    mx = mx0
    src_x = -1
    cols = np.zeros((dst_w, 8), dtype=np.int64)
    filts = np.zeros((dst_w, 8), dtype=np.int64)
    for x in range(dst_w):
        F = RESIZE_FILTER[mx >> 8]
        for k in range(8):
            cols[x, k] = min(max(src_x + k - 3, 0), src_w - 1)
            filts[x, k] = int(F[k])
        mx += dx
        src_x += mx >> 14
        mx &= 0x3FFF
    s = src[src_y : src_y + h, src_x0 : src_x0 + src_w].astype(np.int64)
    acc = np.zeros((h, dst_w), dtype=np.int64)
    for k in range(8):
        acc += filts[:, k][None, :] * s[:, cols[:, k]]
    out = np.clip((-acc + 64) >> 7, 0, pxmax)
    dst[dst_y : dst_y + h, dst_x0 : dst_x0 + dst_w] = out
