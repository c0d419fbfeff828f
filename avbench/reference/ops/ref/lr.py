"""Loop restoration filters: Wiener (7-tap separable) and self-guided (SGR).

Behavior parity: src/looprestoration.rs (padding, wiener_rust, boxsum3/5,
selfguided_filter, sgr_5x5/3x3/mix_rust). Works on a padded (h+6) x (w+6)
stripe buffer assembled by `padding`.
"""

from __future__ import annotations

import numpy as np

from ...tables.spec_data import SGR_PARAMS, SGR_X_BY_X

STRIDE = 390  # REST_UNIT_STRIDE


def padding(tmp, p, y0, x0, left_src, lpf, lpf_above_y, lpf_below_y, w, h,
            have_left, have_right, have_top, have_bottom, lpf_below_y2=None):
    """Assemble (h+6)x(w+6+...) padded stripe into tmp (2D (h+6, w+6)).

    p: pre-LR plane (reads for in-stripe rows); left_src: pre-LR plane for
    the 3 left columns (separate because rav1d uses a pre-LR backup of the
    previous unit); lpf: pre-CDEF plane for boundary rows at lpf_above_y
    (2 rows) and lpf_below_y (2 rows).
    """
    hl3 = 3 if have_left else 0
    hr3 = 3 if have_right else 0
    uw = w + hl3 + hr3
    xoff = 3 - hl3  # column in tmp where copies start
    xs = x0 - hl3

    def prow(src, y, n):
        return src[y, xs : xs + n]

    # top 3 rows
    if have_top:
        tmp[0, xoff : xoff + uw] = prow(lpf, lpf_above_y, uw)
        tmp[1, xoff : xoff + uw] = prow(lpf, lpf_above_y, uw)
        tmp[2, xoff : xoff + uw] = prow(lpf, lpf_above_y + 1, uw)
    else:
        r = prow(p, y0, uw).copy()
        if have_left:
            r[:3] = left_src[y0, x0 - 3 : x0]
        tmp[0, xoff : xoff + uw] = r
        tmp[1, xoff : xoff + uw] = r
        tmp[2, xoff : xoff + uw] = r

    # bottom 3 rows; the second backup line duplicates the first when the
    # stripe boundary + 1 hits the frame bottom (lf_apply backup_lpf n_lines)
    if have_bottom:
        if lpf_below_y2 is None:
            lpf_below_y2 = lpf_below_y + 1
        tmp[3 + h, xoff : xoff + uw] = prow(lpf, lpf_below_y, uw)
        tmp[4 + h, xoff : xoff + uw] = prow(lpf, lpf_below_y2, uw)
        tmp[5 + h, xoff : xoff + uw] = prow(lpf, lpf_below_y2, uw)
    else:
        r = prow(p, y0 + h - 1, uw).copy()
        if have_left:
            r[:3] = left_src[y0 + h - 1, x0 - 3 : x0]
        tmp[3 + h, xoff : xoff + uw] = r
        tmp[4 + h, xoff : xoff + uw] = r
        tmp[5 + h, xoff : xoff + uw] = r

    # inner rows (main pixels; left 3 columns from left_src)
    for j in range(h):
        tmp[3 + j, 3 : 3 + w] = p[y0 + j, x0 : x0 + w]
        if have_left:
            tmp[3 + j, 0:3] = left_src[y0 + j, x0 - 3 : x0]
        if have_right:
            tmp[3 + j, 3 + w : 6 + w] = p[y0 + j, x0 + w : x0 + w + 3]

    if not have_right:
        for j in range(h + 6):
            tmp[j, 3 + w : 6 + w] = tmp[j, 3 + w - 1]
    if not have_left:
        for j in range(h + 6):
            tmp[j, 0:3] = tmp[j, 3]


def wiener(dst, y0, x0, tmp, w, h, filter_h, filter_v, bpc):
    """7-tap separable Wiener (wiener_rust). tmp: (h+6, w+6) int array."""
    fh = [filter_h[0], filter_h[1], filter_h[2], 0, filter_h[2], filter_h[1], filter_h[0]]
    fh[3] = -(filter_h[0] + filter_h[1] + filter_h[2]) * 2
    if bpc != 8:
        fh[3] += 128
    fv = [filter_v[0], filter_v[1], filter_v[2], 0, filter_v[2], filter_v[1], filter_v[0]]
    fv[3] = 128 - (filter_v[0] + filter_v[1] + filter_v[2]) * 2

    round_bits_h = 3 + (2 if bpc == 12 else 0)
    rounding_off_h = 1 << (round_bits_h - 1)
    clip_limit = 1 << (bpc + 1 + 7 - round_bits_h)
    t64 = tmp.astype(np.int64)
    hor = np.zeros((h + 6, w), dtype=np.int64)
    acc = np.full((h + 6, w), 1 << (bpc + 6), dtype=np.int64)
    if bpc == 8:
        acc += t64[:, 3 : 3 + w] * 128
    for k in range(7):
        acc += t64[:, k : k + w] * fh[k]
    hor = np.clip((acc + rounding_off_h) >> round_bits_h, 0, clip_limit - 1)

    round_bits_v = 11 - (2 if bpc == 12 else 0)
    rounding_off_v = 1 << (round_bits_v - 1)
    round_offset = 1 << (bpc + round_bits_v - 1)
    acc = np.full((h, w), -round_offset, dtype=np.int64)
    for k in range(7):
        acc += hor[k : k + h, :] * fv[k]
    out = np.clip((acc + rounding_off_v) >> round_bits_v, 0, (1 << bpc) - 1)
    dst[y0 : y0 + h, x0 : x0 + w] = out.astype(dst.dtype)


def _boxsum3(src, w, h):
    """3x3 box sums (boxsum3): stored[r, x] = sum of src[r..r+3, x-1..x+2]
    for r in [1, h-3), x in [2, w-2) — the consumer reads centered at
    (r+1, x), matching the reference's top-aligned vertical pass."""
    s = src.astype(np.int64)
    s2 = s * s
    vs = np.zeros_like(s)
    vq = np.zeros_like(s2)
    vs[1 : h - 3] = s[1 : h - 3] + s[2 : h - 2] + s[3 : h - 1]
    vq[1 : h - 3] = s2[1 : h - 3] + s2[2 : h - 2] + s2[3 : h - 1]
    out_s = np.zeros_like(s)
    out_q = np.zeros_like(s2)
    out_s[:, 2 : w - 2] = vs[:, 1 : w - 3] + vs[:, 2 : w - 2] + vs[:, 3 : w - 1]
    out_q[:, 2 : w - 2] = vq[:, 1 : w - 3] + vq[:, 2 : w - 2] + vq[:, 3 : w - 1]
    return out_q, out_s


def _boxsum5(src, w, h):
    """5x5 box sums (boxsum5): stored[r, x] = sum of src[r-1..r+4, x-2..x+3]."""
    s = src.astype(np.int64)
    s2 = s * s
    vs = np.zeros_like(s)
    vq = np.zeros_like(s2)
    vs[1 : h - 3] = s[0 : h - 4] + s[1 : h - 3] + s[2 : h - 2] + s[3 : h - 1] + s[4:h]
    vq[1 : h - 3] = (
        s2[0 : h - 4] + s2[1 : h - 3] + s2[2 : h - 2] + s2[3 : h - 1] + s2[4:h]
    )
    out_s = np.zeros_like(s)
    out_q = np.zeros_like(s2)
    out_s[:, 2 : w - 2] = (
        vs[:, 0 : w - 4] + vs[:, 1 : w - 3] + vs[:, 2 : w - 2] + vs[:, 3 : w - 1] + vs[:, 4:w]
    )
    out_q[:, 2 : w - 2] = (
        vq[:, 0 : w - 4] + vq[:, 1 : w - 3] + vq[:, 2 : w - 2] + vq[:, 3 : w - 1] + vq[:, 4:w]
    )
    return out_q, out_s


def _selfguided(tmp, w, h, n, s, bpc):
    """selfguided_filter: tmp (h+6, w+6); returns dst (h, w) int32."""
    sgr_one_by_x = 164 if n == 25 else 455
    W, H = w + 6, h + 6
    if n == 25:
        sumsq, ssum = _boxsum5(tmp, W, H)
    else:
        sumsq, ssum = _boxsum3(tmp, W, H)
    bdm8 = bpc - 8
    # A/B arrays anchored at (2,3) offset like the cursor math
    A = sumsq
    B = ssum
    step = 2 if n == 25 else 1
    # AB pass, vectorized: rows j=-1..h step, cols i=-1..w (xx = 2..w+3)
    ys = np.arange(-1, h + 1, step) + 2
    As = A[ys, 2 : w + 4]
    Bs = B[ys, 2 : w + 4]
    a = (As + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
    b = (Bs + ((1 << bdm8) >> 1)) >> bdm8
    p = np.maximum(a * n - b * b, 0)
    z = (p * s + (1 << 19)) >> 20
    x = SGR_X_BY_X[np.minimum(z, 255)].astype(np.int64)
    A[ys[:, None], np.arange(2, w + 4)[None, :]] = (
        x * Bs * sgr_one_by_x + (1 << 11)
    ) >> 12
    B[ys[:, None], np.arange(2, w + 4)[None, :]] = x

    src = tmp  # pixel source at (3 + j, 3 + i)
    dst = np.zeros((h, w), dtype=np.int64)
    cs = slice(3, w + 3)
    cl = slice(2, w + 2)
    cr = slice(4, w + 4)

    def six_rows(M, yy):
        return (M[yy - 1, cs] + M[yy + 1, cs]) * 6 + (
            M[yy - 1, cl] + M[yy + 1, cl] + M[yy - 1, cr] + M[yy + 1, cr]
        ) * 5

    def eight_rows(M, yy):
        return (
            M[yy, cs] + M[yy, cl] + M[yy, cr] + M[yy - 1, cs] + M[yy + 1, cs]
        ) * 4 + (
            M[yy - 1, cl] + M[yy + 1, cl] + M[yy - 1, cr] + M[yy + 1, cr]
        ) * 3

    if n == 25:
        je = np.arange(0, h, 2)
        yy = je + 2
        aa = six_rows(B, yy)
        bb = six_rows(A, yy)
        dst[je] = (bb - aa * src[je + 3, cs] + (1 << 8)) >> 9
        jo = np.arange(1, h, 2)
        if jo.size:
            yy = jo + 2
            aa = B[yy, cs] * 6 + (B[yy, cl] + B[yy, cr]) * 5
            bb = A[yy, cs] * 6 + (A[yy, cl] + A[yy, cr]) * 5
            dst[jo] = (bb - aa * src[jo + 3, cs] + (1 << 7)) >> 8
    else:
        jj = np.arange(h)
        yy = jj + 2
        aa = eight_rows(B, yy)
        bb = eight_rows(A, yy)
        dst[jj] = (bb - aa * src[jj + 3, cs] + (1 << 8)) >> 9
    return dst


def sgr(dst, y0, x0, tmp, w, h, sgr_idx, sgr_weights, bpc):
    """Self-guided restoration (sgr_5x5 / 3x3 / mix)."""
    s0, s1 = int(SGR_PARAMS[sgr_idx][0]), int(SGR_PARAMS[sgr_idx][1])
    w0 = sgr_weights[0]
    w1 = 128 - (sgr_weights[0] + sgr_weights[1])
    pixel_max = (1 << bpc) - 1
    cur = dst[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
    if s0 and s1:
        d0 = _selfguided(tmp, w, h, 25, s0, bpc)
        d1 = _selfguided(tmp, w, h, 9, s1, bpc)
        v = w0 * d0 + w1 * d1
    elif s0:
        d0 = _selfguided(tmp, w, h, 25, s0, bpc)
        v = w0 * d0
    else:
        d1 = _selfguided(tmp, w, h, 9, s1, bpc)
        v = w1 * d1
    out = np.clip(cur + ((v + (1 << 10)) >> 11), 0, pixel_max)
    dst[y0 : y0 + h, x0 : x0 + w] = out.astype(dst.dtype)
