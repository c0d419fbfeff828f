"""Intra predictors (DC/V/H/Paeth/Smooth*/Z1-3/Filter) + CfL + palette.

Behavior parity: src/ipred.rs Rust fallbacks. The edge buffer convention
matches rav1d: a 257-entry array with the top-left sample at index 128,
left pixels below it (descending), top pixels above it (ascending).

All functions take `dst` as a numpy (h, w) view into the plane and `topleft`
as a 1-D int array with the top-left sample at index `off`.
"""

from __future__ import annotations

import numpy as np

from ...tables.spec_data import (
    DR_INTRA_DERIVATIVE,
    FILTER_INTRA_TAPS,
    SM_WEIGHTS,
)


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


def splat_dc(dst, dc):
    dst[:, :] = dc


def dc_gen_top(tl, off, width):
    return (int(tl[off + 1 : off + 1 + width].sum()) + (width >> 1)) >> _ctz(width)


def dc_gen_left(tl, off, height):
    return (int(tl[off - height : off].sum()) + (height >> 1)) >> _ctz(height)


def dc_gen(tl, off, width, height, bpc):
    mult_1x2, mult_1x4, base_shift = (
        (0x5556, 0x3334, 16) if bpc == 8 else (0xAAAB, 0x6667, 17)
    )
    dc = (width + height) >> 1
    dc += int(tl[off + 1 : off + 1 + width].sum())
    dc += int(tl[off - height : off].sum())
    dc >>= _ctz(width + height)
    if width != height:
        dc *= mult_1x4 if (width > height * 2 or height > width * 2) else mult_1x2
        dc >>= base_shift
    return dc


def ipred_dc(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    splat_dc(dst, dc_gen(tl, off, w, h, bpc))


def ipred_dc_top(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    splat_dc(dst, dc_gen_top(tl, off, w))


def ipred_dc_left(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    splat_dc(dst, dc_gen_left(tl, off, h))


def ipred_dc_128(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    splat_dc(dst, ((1 << bpc) - 1 + 1) >> 1)


def ipred_v(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    dst[:, :] = tl[off + 1 : off + 1 + w][None, :]


def ipred_h(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    dst[:, :] = tl[off - h : off][::-1][:h, None]


def ipred_paeth(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    topleft = int(tl[off])
    top = tl[off + 1 : off + 1 + w].astype(np.int32)[None, :]
    left = tl[off - h : off][::-1].astype(np.int32)[:, None]
    base = left + top - topleft
    ldiff = np.abs(left - base)
    tdiff = np.abs(top - base)
    tldiff = np.abs(topleft - base)
    out = np.where(
        (ldiff <= tdiff) & (ldiff <= tldiff),
        np.broadcast_to(left, (h, w)),
        np.where(tdiff <= tldiff, np.broadcast_to(top, (h, w)), topleft),
    )
    dst[:, :] = out.astype(dst.dtype)


def ipred_smooth(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    weights_hor = SM_WEIGHTS[w : w + w][None, :]
    weights_ver = SM_WEIGHTS[h : h + h][:, None]
    right = int(tl[off + w])
    bottom = int(tl[off - h])
    top = tl[off + 1 : off + 1 + w].astype(np.int64)[None, :]
    left = tl[off - h : off][::-1].astype(np.int64)[:, None]
    pred = (
        weights_ver * top
        + (256 - weights_ver) * bottom
        + weights_hor * left
        + (256 - weights_hor) * right
    )
    dst[:, :] = ((pred + 256) >> 9).astype(dst.dtype)


def ipred_smooth_v(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    weights_ver = SM_WEIGHTS[h : h + h][:, None]
    bottom = int(tl[off - h])
    top = tl[off + 1 : off + 1 + w].astype(np.int64)[None, :]
    pred = weights_ver * top + (256 - weights_ver) * bottom
    dst[:, :] = ((pred + 128) >> 8).astype(dst.dtype)


def ipred_smooth_h(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    weights_hor = SM_WEIGHTS[w : w + w][None, :]
    right = int(tl[off + w])
    left = tl[off - h : off][::-1].astype(np.int64)[:, None]
    pred = weights_hor * left + (256 - weights_hor) * right
    dst[:, :] = ((pred + 128) >> 8).astype(dst.dtype)


def _get_filter_strength(wh, angle, is_sm):
    if is_sm:
        if wh <= 8:
            if angle >= 64:
                return 2
            if angle >= 40:
                return 1
        elif wh <= 16:
            if angle >= 48:
                return 2
            if angle >= 20:
                return 1
        elif wh <= 24:
            if angle >= 4:
                return 3
        else:
            return 3
    else:
        if wh <= 8:
            if angle >= 56:
                return 1
        elif wh <= 16:
            if angle >= 40:
                return 1
        elif wh <= 24:
            if angle >= 32:
                return 3
            if angle >= 16:
                return 2
            if angle >= 8:
                return 1
        elif wh <= 32:
            if angle >= 32:
                return 3
            if angle >= 4:
                return 2
            return 1
        else:
            return 3
    return 0


_EDGE_KERNELS = [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]]


def _filter_edge(out, sz, lim_from, lim_to, src, src_base, src_from, src_to, strength):
    """out[i] for i<sz from src[base + iclip(i, from, to-1)] with 5-tap
    smoothing in [lim_from, lim_to) (src/ipred.rs filter_edge). Explicit base
    avoids Python negative-index wrapping."""
    kern = _EDGE_KERNELS[strength - 1]

    def s(i):
        return int(src[src_base + min(max(i, src_from), src_to - 1)])

    i = 0
    while i < min(sz, lim_from):
        out[i] = s(i)
        i += 1
    while i < min(lim_to, sz):
        acc = 0
        for j in range(5):
            acc += s(i - 2 + j) * kern[j]
        out[i] = (acc + 8) >> 4
        i += 1
    while i < sz:
        out[i] = s(i)
        i += 1


def _get_upsample(wh, angle, is_sm):
    return 1 if (angle < 40 and wh <= (16 >> is_sm)) else 0


def _upsample_edge(out, hsz, src, src_base, src_from, src_to, bpc):
    pixel_max = (1 << bpc) - 1

    def s(i):
        return int(src[src_base + min(max(i, src_from), src_to - 1)])

    for i in range(hsz - 1):
        out[i * 2] = s(i)
        acc = -s(i - 1) + 9 * s(i) + 9 * s(i + 1) - s(i + 2)
        out[i * 2 + 1] = min(max((acc + 8) >> 4, 0), pixel_max)
    out[(hsz - 1) * 2] = s(hsz - 1)


def ipred_z1(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    is_sm = (angle >> 9) & 1
    enable_ief = angle >> 10
    angle &= 511
    assert angle < 90
    dx = int(DR_INTRA_DERIVATIVE[angle >> 1])
    top_out = np.zeros(128, dtype=np.int32)
    upsample_above = _get_upsample(w + h, 90 - angle, is_sm) if enable_ief else 0
    if upsample_above:
        _upsample_edge(top_out, w + h, tl, off + 1, -1, w + min(w, h), bpc)
        top = top_out
        max_base_x = 2 * (w + h) - 2
        dx <<= 1
    else:
        fs = _get_filter_strength(w + h, 90 - angle, is_sm) if enable_ief else 0
        if fs:
            _filter_edge(top_out, w + h, 0, w + h, tl, off + 1, -1, w + min(w, h), fs)
            top = top_out
            max_base_x = w + h - 1
        else:
            top = tl[off + 1 :]
            max_base_x = w + min(w, h) - 1
    base_inc = 1 + upsample_above
    xpos = dx
    for y in range(h):
        frac = xpos & 0x3E
        base = xpos >> 6
        for x in range(w):
            if base < max_base_x:
                v = int(top[base]) * (64 - frac) + int(top[base + 1]) * frac
                dst[y, x] = (v + 32) >> 6
                base += base_inc
            else:
                dst[y, x:] = top[max_base_x]
                break
        xpos += dx


def ipred_z2(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    is_sm = (angle >> 9) & 1
    enable_ief = angle >> 10
    angle &= 511
    assert 90 < angle < 180
    dy = int(DR_INTRA_DERIVATIVE[(angle - 90) >> 1])
    dx = int(DR_INTRA_DERIVATIVE[(180 - angle) >> 1])
    upsample_left = _get_upsample(w + h, 180 - angle, is_sm) if enable_ief else 0
    upsample_above = _get_upsample(w + h, angle - 90, is_sm) if enable_ief else 0
    edge = np.zeros(129, dtype=np.int32)
    tl_off = 64  # topleft position within edge
    if upsample_above:
        _upsample_edge(edge[tl_off:], w + 1, tl, off, 0, w + 1, bpc)
        dx <<= 1
    else:
        fs = _get_filter_strength(w + h, angle - 90, is_sm) if enable_ief else 0
        if fs:
            _filter_edge(edge[tl_off + 1 :], w, 0, max_w, tl, off + 1, -1, w, fs)
        else:
            edge[tl_off + 1 : tl_off + 1 + w] = tl[off + 1 : off + 1 + w]
    if upsample_left:
        _upsample_edge(edge[tl_off - h * 2 :], h + 1, tl, off - h, 0, h + 1, bpc)
        dy <<= 1
    else:
        fs = _get_filter_strength(w + h, 180 - angle, is_sm) if enable_ief else 0
        if fs:
            _filter_edge(
                edge[tl_off - h :], h, h - max_h, h, tl, off - h, 0, h + 1, fs
            )
        else:
            edge[tl_off - h : tl_off] = tl[off - h : off]
    edge[tl_off] = tl[off]
    base_inc_x = 1 + upsample_above
    left_off = tl_off - (1 + upsample_left)
    xpos = ((1 + upsample_above) << 6) - dx
    for y in range(h):
        base_x = xpos >> 6
        frac_x = xpos & 0x3E
        ypos = (y << (6 + upsample_left)) - dy
        for x in range(w):
            if base_x >= 0:
                v = int(edge[tl_off + base_x]) * (64 - frac_x) + int(
                    edge[tl_off + base_x + 1]
                ) * frac_x
            else:
                base_y = ypos >> 6
                frac_y = ypos & 0x3E
                v = int(edge[left_off - base_y]) * (64 - frac_y) + int(
                    edge[left_off - (base_y + 1)]
                ) * frac_y
            dst[y, x] = (v + 32) >> 6
            base_x += base_inc_x
            ypos -= dy
        xpos -= dx


def ipred_z3(dst, tl, off, w, h, angle, max_w, max_h, bpc):
    is_sm = (angle >> 9) & 1
    enable_ief = angle >> 10
    angle &= 511
    assert angle > 180
    dy = int(DR_INTRA_DERIVATIVE[(270 - angle) >> 1])
    left_out = np.zeros(128, dtype=np.int32)
    upsample_left = _get_upsample(w + h, angle - 180, is_sm) if enable_ief else 0
    if upsample_left:
        _upsample_edge(
            left_out, w + h, tl, off - (w + h), max(w - h, 0), w + h + 1, bpc
        )
        left = left_out
        left_base = 2 * (w + h) - 2
        max_base_y = 2 * (w + h) - 2
        dy <<= 1
    else:
        fs = _get_filter_strength(w + h, angle - 180, is_sm) if enable_ief else 0
        if fs:
            _filter_edge(
                left_out,
                w + h,
                0,
                w + h,
                tl,
                off - (w + h),
                max(w - h, 0),
                w + h + 1,
                fs,
            )
            left = left_out
            left_base = w + h - 1
            max_base_y = w + h - 1
        else:
            left = tl  # left[left_base - base] == tl[off - 1 - base]
            left_base = off - 1
            max_base_y = h + min(w, h) - 1
    base_inc = 1 + upsample_left
    ypos = dy
    for x in range(w):
        frac = ypos & 0x3E
        base = ypos >> 6
        for y in range(h):
            if base < max_base_y:
                v = int(left[left_base - base]) * (64 - frac) + int(
                    left[left_base - (base + 1)]
                ) * frac
                dst[y, x] = (v + 32) >> 6
                base += base_inc
            else:
                dst[y:, x] = left[left_base - max_base_y]
                break
        ypos += dy


def ipred_filter(dst, tl, off, w, h, filt_idx, max_w, max_h, bpc):
    filt_idx &= 511
    filt = FILTER_INTRA_TAPS[filt_idx]  # (8 positions, 7 taps)
    pixel_max = (1 << bpc) - 1
    # Work on an int buffer with the edge row/column attached.
    out = np.zeros((h + 1, w + 1), dtype=np.int32)
    out[0, 1:] = tl[off + 1 : off + 1 + w]
    out[1:, 0] = tl[off - h : off][::-1][:h]
    out[0, 0] = tl[off]
    # 2x4 blocks depend on the previous row/column of OUTPUT pixels, so rows
    # of blocks are sequential; blocks within a row-pair depend on the left
    # block's rightmost column, so x is sequential too — but all 8 output
    # taps of one block are computed at once.
    fm = np.asarray(filt, dtype=np.int64)  # (8, 7)
    for y in range(0, h, 2):
        for x in range(0, w, 4):
            ps = np.array(
                [out[y, x], out[y, x + 1], out[y, x + 2], out[y, x + 3],
                 out[y, x + 4], out[y + 1, x], out[y + 2, x]],
                dtype=np.int64,
            )
            acc = fm @ ps  # (8,)
            vals = np.clip((acc + 8) >> 4, 0, pixel_max)
            out[y + 1, x + 1 : x + 5] = vals[:4]
            out[y + 2, x + 1 : x + 5] = vals[4:]
    dst[:, :] = out[1:, 1:].astype(dst.dtype)


def cfl_ac(ac, ypx, w_pad, h_pad, width, height, ss_hor, ss_ver):
    """ac: int16 (height, width) out; ypx: luma view starting at block origin.
    Parity: cfl_ac_rust (src/ipred.rs)."""
    for y in range(height - 4 * h_pad):
        for x in range(width - 4 * w_pad):
            s = int(ypx[y << ss_ver, x << ss_hor])
            if ss_hor:
                s += int(ypx[y << ss_ver, x * 2 + 1])
            if ss_ver:
                s += int(ypx[(y << ss_ver) + 1, x << ss_hor])
                if ss_hor:
                    s += int(ypx[(y << ss_ver) + 1, x * 2 + 1])
            ac[y, x] = s << (1 + (ss_ver == 0) + (ss_hor == 0))
        for x in range(width - 4 * w_pad, width):
            ac[y, x] = ac[y, x - 1]
    for y in range(height - 4 * h_pad, height):
        ac[y, :] = ac[y - 1, :]
    log2sz = _ctz(width) + _ctz(height)
    total = (1 << log2sz >> 1) + int(ac[:height, :width].sum())
    avg = total >> log2sz
    ac[:height, :width] -= avg


def cfl_pred_apply(dst, dc, ac, alpha, bpc):
    pixel_max = (1 << bpc) - 1
    diff = alpha * ac.astype(np.int32)
    adj = np.where(diff < 0, -((np.abs(diff) + 32) >> 6), (np.abs(diff) + 32) >> 6)
    dst[:, :] = np.clip(dc + adj, 0, pixel_max).astype(dst.dtype)


# cfl "dc" variants use the same dc_gen family, then cfl_pred_apply.

def pal_pred(dst, pal, idx, w, h):
    """dst[y,x] = pal[idx[y*w+x]] (src/ipred.rs pal_pred)."""
    lut = np.asarray(pal)
    m = np.asarray(idx[: w * h], dtype=np.int64).reshape(h, w)
    dst[:, :] = lut[m].astype(dst.dtype)
