"""Deblocking filter kernel (behavior parity: src/loopfilter.rs loop_filter).

`filter_edge_v` filters one vertical edge segment (4 rows) at plane[y0:y0+4,
x0] reading/writing columns x0-7..x0+6; `filter_edge_h` the transpose.
"""

from __future__ import annotations

import numpy as np


def calc_eih(sharp):
    """E/I LUTs per level (rav1d_calc_eih, src/lf_mask.rs:604)."""
    e = [0] * 64
    i_lut = [0] * 64
    for level in range(64):
        limit = level
        if sharp > 0:
            limit >>= (sharp + 3) >> 2
            limit = min(limit, 9 - sharp)
        limit = max(limit, 1)
        i_lut[level] = limit
        e[level] = 2 * (level + 2) + limit
    return e, i_lut


def _filter4(px, E, I, H, wd, bpc):
    """Filter one 1-D line of pixels around an edge. px: int list indexed so
    that px[off-1]=p0, px[off]=q0 with off=8 (13+ entries); modified in place.
    Mirrors the scalar body of loop_filter (src/loopfilter.rs:397)."""
    off = 8
    bd_min8 = bpc - 8
    F = 1 << bd_min8
    pixel_max = (1 << bpc) - 1
    # thresholds are specified at 8-bit scale (loopfilter_tmpl.c:44)
    E <<= bd_min8
    I <<= bd_min8
    H <<= bd_min8

    p1, p0 = px[off - 2], px[off - 1]
    q0, q1 = px[off], px[off + 1]
    fm = abs(p1 - p0) <= I and abs(q1 - q0) <= I and abs(p0 - q0) * 2 + (
        abs(p1 - q1) >> 1
    ) <= E
    p2 = p3 = q2 = q3 = 0
    if wd > 4:
        p2, q2 = px[off - 3], px[off + 2]
        fm = fm and abs(p2 - p1) <= I and abs(q2 - q1) <= I
        if wd > 6:
            p3, q3 = px[off - 4], px[off + 3]
            fm = fm and abs(p3 - p2) <= I and abs(q3 - q2) <= I
    if not fm:
        return
    flat8out = False
    flat8in = False
    if wd >= 16:
        p6, p5, p4 = px[off - 7], px[off - 6], px[off - 5]
        q4, q5, q6 = px[off + 4], px[off + 5], px[off + 6]
        flat8out = (
            abs(p6 - p0) <= F
            and abs(p5 - p0) <= F
            and abs(p4 - p0) <= F
            and abs(q4 - q0) <= F
            and abs(q5 - q0) <= F
            and abs(q6 - q0) <= F
        )
    if wd >= 6:
        flat8in = (
            abs(p2 - p0) <= F
            and abs(p1 - p0) <= F
            and abs(q1 - q0) <= F
            and abs(q2 - q0) <= F
        )
    if wd >= 8:
        flat8in = flat8in and abs(p3 - p0) <= F and abs(q3 - q0) <= F
    if wd >= 16 and flat8out and flat8in:
        px[off - 6] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4
        px[off - 5] = (
            p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8
        ) >> 4
        px[off - 4] = (
            p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8
        ) >> 4
        px[off - 3] = (
            p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8
        ) >> 4
        px[off - 2] = (
            p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8
        ) >> 4
        px[off - 1] = (
            p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8
        ) >> 4
        px[off + 0] = (
            p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8
        ) >> 4
        px[off + 1] = (
            p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8
        ) >> 4
        px[off + 2] = (
            p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8
        ) >> 4
        px[off + 3] = (
            p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8
        ) >> 4
        px[off + 4] = (
            p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8
        ) >> 4
        px[off + 5] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4
    elif wd >= 8 and flat8in:
        px[off - 3] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3
        px[off - 2] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3
        px[off - 1] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3
        px[off + 0] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3
        px[off + 1] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3
        px[off + 2] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3
    elif wd == 6 and flat8in:
        px[off - 2] = (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3
        px[off - 1] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
        px[off + 0] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3
        px[off + 1] = (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3
    else:
        hev = abs(p1 - p0) > H or abs(q1 - q0) > H
        lim_lo = -128 * (1 << bd_min8)
        lim_hi = 128 * (1 << bd_min8) - 1

        def clip_diff(v):
            return max(lim_lo, min(v, lim_hi))

        if hev:
            fv = clip_diff(p1 - q1)
            fv = clip_diff(3 * (q0 - p0) + fv)
            f1 = min(fv + 4, lim_hi) >> 3
            f2 = min(fv + 3, lim_hi) >> 3
            px[off - 1] = max(0, min(p0 + f2, pixel_max))
            px[off + 0] = max(0, min(q0 - f1, pixel_max))
        else:
            fv = clip_diff(3 * (q0 - p0))
            f1 = min(fv + 4, lim_hi) >> 3
            f2 = min(fv + 3, lim_hi) >> 3
            px[off - 1] = max(0, min(p0 + f2, pixel_max))
            px[off + 0] = max(0, min(q0 - f1, pixel_max))
            fv = (f1 + 1) >> 1
            px[off - 2] = max(0, min(p1 + fv, pixel_max))
            px[off + 1] = max(0, min(q1 - fv, pixel_max))


def filter_lines_batch(px, E, I, H, wd, bpc):
    """Batched line filter: px is (N, 16) int32 (px[:, 8] = q0), E/I/H are
    (N,) int32 at 8-bit scale. Returns filtered copy. Vectorized
    re-expression of `_filter4`; AV1 guarantees edges within one direction
    pass never overlap, so whole-class batching is bit-exact."""
    px = px.astype(np.int32)
    off = 8
    bd_min8 = bpc - 8
    F = 1 << bd_min8
    pixel_max = (1 << bpc) - 1
    E = E.astype(np.int32) << bd_min8
    I = I.astype(np.int32) << bd_min8
    H = H.astype(np.int32) << bd_min8

    p1, p0 = px[:, off - 2], px[:, off - 1]
    q0, q1 = px[:, off], px[:, off + 1]
    fm = (
        (np.abs(p1 - p0) <= I)
        & (np.abs(q1 - q0) <= I)
        & (np.abs(p0 - q0) * 2 + (np.abs(p1 - q1) >> 1) <= E)
    )
    zero = np.zeros_like(p0)
    p2 = p3 = q2 = q3 = zero
    if wd > 4:
        p2, q2 = px[:, off - 3], px[:, off + 2]
        fm &= (np.abs(p2 - p1) <= I) & (np.abs(q2 - q1) <= I)
        if wd > 6:
            p3, q3 = px[:, off - 4], px[:, off + 3]
            fm &= (np.abs(p3 - p2) <= I) & (np.abs(q3 - q2) <= I)
    out = px.copy()

    flat8in = np.zeros_like(fm)
    if wd >= 6:
        flat8in = (
            (np.abs(p2 - p0) <= F)
            & (np.abs(p1 - p0) <= F)
            & (np.abs(q1 - q0) <= F)
            & (np.abs(q2 - q0) <= F)
        )
    if wd >= 8:
        flat8in &= (np.abs(p3 - p0) <= F) & (np.abs(q3 - q0) <= F)

    if wd >= 16:
        p6, p5, p4 = px[:, off - 7], px[:, off - 6], px[:, off - 5]
        q4, q5, q6 = px[:, off + 4], px[:, off + 5], px[:, off + 6]
        flat8out = (
            (np.abs(p6 - p0) <= F)
            & (np.abs(p5 - p0) <= F)
            & (np.abs(p4 - p0) <= F)
            & (np.abs(q4 - q0) <= F)
            & (np.abs(q5 - q0) <= F)
            & (np.abs(q6 - q0) <= F)
        )
        m16 = fm & flat8out & flat8in
        vals = [
            (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4,
            (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4,
            (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4,
            (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4,
            (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4,
            (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4,
            (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4,
            (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4,
            (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4,
            (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4,
            (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4,
            (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4,
        ]
        for k, v in enumerate(vals):
            c = off - 6 + k
            out[:, c] = np.where(m16, v, out[:, c])
        narrow = fm & ~(flat8out & flat8in)
    else:
        narrow = fm

    if wd >= 8:
        m8 = narrow & flat8in
        vals = [
            (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
            (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
            (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
            (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
            (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
            (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
        ]
        for k, v in enumerate(vals):
            c = off - 3 + k
            out[:, c] = np.where(m8, v, out[:, c])
        narrow = narrow & ~flat8in
    elif wd == 6:
        m6 = narrow & flat8in
        vals = [
            (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3,
            (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
            (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3,
        ]
        for k, v in enumerate(vals):
            c = off - 2 + k
            out[:, c] = np.where(m6, v, out[:, c])
        narrow = narrow & ~flat8in

    # narrow 4-tap filter (with/without high-edge-variance)
    hev = (np.abs(p1 - p0) > H) | (np.abs(q1 - q0) > H)
    lim_lo = -128 << bd_min8
    lim_hi = (128 << bd_min8) - 1

    def clipd(v):
        return np.clip(v, lim_lo, lim_hi)

    fv_h = clipd(3 * (q0 - p0) + clipd(p1 - q1))
    fv_n = clipd(3 * (q0 - p0))
    fv = np.where(hev, fv_h, fv_n)
    f1 = np.minimum(fv + 4, lim_hi) >> 3
    f2 = np.minimum(fv + 3, lim_hi) >> 3
    np0 = np.clip(p0 + f2, 0, pixel_max)
    nq0 = np.clip(q0 - f1, 0, pixel_max)
    fv2 = (f1 + 1) >> 1
    np1 = np.where(hev, p1, np.clip(p1 + fv2, 0, pixel_max))
    nq1 = np.where(hev, q1, np.clip(q1 - fv2, 0, pixel_max))
    out[:, off - 2] = np.where(narrow, np1, out[:, off - 2])
    out[:, off - 1] = np.where(narrow, np0, out[:, off - 1])
    out[:, off + 0] = np.where(narrow, nq0, out[:, off + 0])
    out[:, off + 1] = np.where(narrow, nq1, out[:, off + 1])
    return out


# write extents per filter width: (lo, hi) columns of the 16-wide line that
# the filter may modify (scatter only these back — neighboring edges' write
# regions never overlap, per the AV1 parallel-deblock guarantee)
WRITE_EXTENT = {4: (6, 10), 6: (6, 10), 8: (5, 11), 16: (2, 14)}


def filter_edge_v(plane, y0, x0, E, I, H, wd, bpc):
    """Vertical edge at column x0, rows y0..y0+4."""
    h, w = plane.shape
    for r in range(4):
        y = y0 + r
        lo = x0 - 8
        hi = x0 + 8
        px = [0] * 16
        for i in range(16):
            xi = lo + i
            px[i] = int(plane[y, xi]) if 0 <= xi < w else 0
        _filter4(px, E, I, H, wd, bpc)
        for i in range(16):
            xi = lo + i
            if 0 <= xi < w:
                plane[y, xi] = px[i]


def filter_edge_h(plane, y0, x0, E, I, H, wd, bpc):
    """Horizontal edge at row y0, columns x0..x0+4."""
    h, w = plane.shape
    for c in range(4):
        x = x0 + c
        lo = y0 - 8
        px = [0] * 16
        for i in range(16):
            yi = lo + i
            px[i] = int(plane[yi, x]) if 0 <= yi < h else 0
        _filter4(px, E, I, H, wd, bpc)
        for i in range(16):
            yi = lo + i
            if 0 <= yi < h:
                plane[yi, x] = px[i]
