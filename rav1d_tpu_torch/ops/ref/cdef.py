"""CDEF: constrained directional enhancement filter.

Behavior parity: src/cdef.rs (cdef_filter_block_c, cdef_find_dir_rust) and
src/cdef_apply.rs (rav1d_cdef_brow). All neighbour pixels come from the
pre-CDEF image copy, which is exactly what rav1d's 2-line backups provide.
"""

from __future__ import annotations

import numpy as np

from ...tables.spec_data import CDEF_DIRECTIONS

MISSING = -32768  # i16::MIN fill for unavailable edges


def _ulog2(v):
    return v.bit_length() - 1


def constrain(diff, threshold, shift):
    adiff = abs(diff)
    v = min(adiff, max(0, threshold - (adiff >> shift)))
    return -v if diff < 0 else v


_FD_IDX = None


def _find_dir_idx():
    """Precomputed flat scatter indices for the 8 partial-sum projections."""
    global _FD_IDX
    if _FD_IDX is None:
        ys, xs = np.mgrid[0:8, 0:8]
        _FD_IDX = [
            (ys + xs).ravel(),  # diag0 (15)
            (ys + (xs >> 1)).ravel(),  # alt0 (11)
            ys.ravel(),  # hv0 (8)
            (3 + ys - (xs >> 1)).ravel(),  # alt1
            (7 + ys - xs).ravel(),  # diag1
            (3 - (ys >> 1) + xs).ravel(),  # alt2
            xs.ravel(),  # hv1
            ((ys >> 1) + xs).ravel(),  # alt3
        ]
    return _FD_IDX


def find_dir(img, bpc):
    """img: (8,8) int array. Returns (dir, var) (cdef_find_dir_rust)."""
    bdm8 = bpc - 8
    px = ((np.asarray(img, dtype=np.int64) >> bdm8) - 128).ravel()
    idx = _find_dir_idx()
    partial_sum_diag = [
        np.bincount(idx[0], px, minlength=15).astype(np.int64),
        np.bincount(idx[4], px, minlength=15).astype(np.int64),
    ]
    partial_sum_alt = [
        np.bincount(idx[1], px, minlength=11).astype(np.int64),
        np.bincount(idx[3], px, minlength=11).astype(np.int64),
        np.bincount(idx[5], px, minlength=11).astype(np.int64),
        np.bincount(idx[7], px, minlength=11).astype(np.int64),
    ]
    partial_sum_hv = [
        np.bincount(idx[2], px, minlength=8).astype(np.int64),
        np.bincount(idx[6], px, minlength=8).astype(np.int64),
    ]
    M = 0xFFFFFFFF
    cost = [0] * 8
    for n in range(8):
        cost[2] = (cost[2] + partial_sum_hv[0][n] ** 2) & M
        cost[6] = (cost[6] + partial_sum_hv[1][n] ** 2) & M
    cost[2] = (cost[2] * 105) & M
    cost[6] = (cost[6] * 105) & M
    div_table = [840, 420, 280, 210, 168, 140, 120]
    for n in range(7):
        d = div_table[n]
        cost[0] = (
            cost[0]
            + (partial_sum_diag[0][n] ** 2 + partial_sum_diag[0][14 - n] ** 2) * d
        ) & M
        cost[4] = (
            cost[4]
            + (partial_sum_diag[1][n] ** 2 + partial_sum_diag[1][14 - n] ** 2) * d
        ) & M
    cost[0] = (cost[0] + partial_sum_diag[0][7] ** 2 * 105) & M
    cost[4] = (cost[4] + partial_sum_diag[1][7] ** 2 * 105) & M
    for n in range(4):
        c = cost[n * 2 + 1]
        for m in range(5):
            c = (c + partial_sum_alt[n][3 + m] ** 2) & M
        c = (c * 105) & M
        for m in range(3):
            d = div_table[2 * m + 1]
            c = (
                c + (partial_sum_alt[n][m] ** 2 + partial_sum_alt[n][10 - m] ** 2) * d
            ) & M
        cost[n * 2 + 1] = c
    cost = [int(c) for c in cost]
    best_dir = 0
    best_cost = cost[0]
    for n in range(1, 8):
        if cost[n] > best_cost:
            best_cost = cost[n]
            best_dir = n
    var = ((best_cost - cost[best_dir ^ 4]) & M) >> 10
    return best_dir, var


_FD_PROJ = None


def _find_dir_proj():
    """One-hot projection matrices (90, 64) stacked for all 8 partial sums."""
    global _FD_PROJ
    if _FD_PROJ is None:
        idx = _find_dir_idx()
        sizes = [15, 11, 8, 11, 15, 11, 8, 11]
        rows = []
        for d in range(8):
            m = np.zeros((sizes[d], 64), dtype=np.int64)
            m[idx[d], np.arange(64)] = 1
            rows.append(m)
        _FD_PROJ = np.concatenate(rows, axis=0)
    return _FD_PROJ


def find_dir_blocks(blocks, bpc):
    """Batched find_dir: blocks (N,8,8) -> (dirs (N,), vars (N,)).
    Identical u32-wrapping cost arithmetic to `find_dir`."""
    bdm8 = bpc - 8
    N = blocks.shape[0]
    px = ((np.asarray(blocks, dtype=np.int64) >> bdm8) - 128).reshape(N, 64)
    proj = _find_dir_proj()
    part = px @ proj.T  # (N, 90)
    o = np.cumsum([0, 15, 11, 8, 11, 15, 11, 8, 11])
    diag = [part[:, o[0] : o[1]], part[:, o[4] : o[5]]]
    alt = [part[:, o[1] : o[2]], part[:, o[3] : o[4]], part[:, o[5] : o[6]], part[:, o[7] : o[8]]]
    hv = [part[:, o[2] : o[3]], part[:, o[6] : o[7]]]
    M = 0xFFFFFFFF
    div_table = np.array([840, 420, 280, 210, 168, 140, 120], dtype=np.int64)
    cost = np.zeros((N, 8), dtype=np.int64)
    cost[:, 2] = ((hv[0] ** 2).sum(axis=1) * 105) & M
    cost[:, 6] = ((hv[1] ** 2).sum(axis=1) * 105) & M
    for j, d in enumerate(diag):
        c = ((d[:, :7] ** 2 + d[:, 14:7:-1] ** 2) * div_table).sum(axis=1)
        cost[:, j * 4] = (c + d[:, 7] ** 2 * 105) & M
    for n, a in enumerate(alt):
        c = ((a[:, 3:8] ** 2).sum(axis=1) * 105) & M
        c = (c + ((a[:, :3] ** 2 + a[:, 10:7:-1] ** 2) * div_table[1::2]).sum(axis=1)) & M
        cost[:, n * 2 + 1] = c
    best_dir = np.argmax(cost, axis=1)
    best_cost = cost[np.arange(N), best_dir]
    var = ((best_cost - cost[np.arange(N), best_dir ^ 4]) & M) >> 10
    return best_dir.astype(np.int32), var


_ULOG2_LUT = None


def _ulog2_arr(v):
    global _ULOG2_LUT
    if _ULOG2_LUT is None:
        _ULOG2_LUT = np.array([0] + [i.bit_length() - 1 for i in range(1, 4096)], dtype=np.int32)
    return _ULOG2_LUT[v]


def adjust_strength_arr(strength, var):
    """Vectorized adjust_strength: strength (N,), var (N,) -> (N,)."""
    v6 = var >> 6
    i = np.where(
        v6 >= 4096, 12, np.minimum(_ulog2_arr(np.minimum(v6, 4095)), 12)
    )
    adj = (strength * (4 + i) + 8) >> 4
    return np.where(var == 0, 0, adj).astype(np.int64)


def cdef_filter_blocks(windows, pri, sec, direction, damping, bpc):
    """Batched CDEF filter. windows: (N, h+4, w+4) int32 with MISSING in
    unavailable border cells; pri/sec/direction: (N,) ints; damping scalar.
    Returns (N, h, w) filtered output (same selection/rounding/clip
    semantics as `cdef_filter_block`, vectorized over N)."""
    N, hp, wp = windows.shape
    h, w = hp - 4, wp - 4
    bdm8 = bpc - 8
    pri = np.asarray(pri, dtype=np.int64)
    sec = np.asarray(sec, dtype=np.int64)
    direction = np.asarray(direction, dtype=np.int64)
    win = np.asarray(windows, dtype=np.int64)

    pri_tap0 = 4 - ((pri >> bdm8) & 1)
    pri_shift = np.maximum(0, damping - _ulog2_arr(pri.astype(np.int64)))
    sec_shift = np.where(sec > 0, damping - _ulog2_arr(sec), 0)

    px = win[:, 2 : 2 + h, 2 : 2 + w]
    nidx = np.arange(N)[:, None, None]
    ri = np.arange(h)[None, :, None]
    ci = np.arange(w)[None, None, :]

    def gather(oy, ox):
        return win[nidx, 2 + oy[:, None, None] + ri, 2 + ox[:, None, None] + ci]

    def con(diff, thr, shift):
        adiff = np.abs(diff)
        v = np.minimum(adiff, np.maximum(0, thr[:, None, None] - (adiff >> shift[:, None, None])))
        return np.where(diff < 0, -v, v)

    s = np.zeros((N, h, w), dtype=np.int64)
    mn = px.copy()
    mx = px.copy()

    def track(v):
        nonlocal mn, mx
        uv = v.astype(np.uint64)
        mn = np.where(uv < mn.astype(np.uint64), v, mn)
        mx = np.maximum(v, mx)

    dirs = np.asarray(CDEF_DIRECTIONS)
    pri_tap_k = pri_tap0.copy()
    for k in range(2):
        o = dirs[direction + 2, k].astype(np.int64)
        dy = (o + 6) // 12
        dx = o - dy * 12
        p0 = gather(dy, dx)
        p1 = gather(-dy, -dx)
        s += pri_tap_k[:, None, None] * (
            con(p0 - px, pri, pri_shift) + con(p1 - px, pri, pri_shift)
        )
        pri_tap_k = (pri_tap_k & 3) | 2
        track(p0)
        track(p1)
        sec_tap = 2 - k
        for row_off in (4, 0):
            o2 = dirs[direction + row_off, k].astype(np.int64)
            dy2 = (o2 + 6) // 12
            dx2 = o2 - dy2 * 12
            for sy, sx in ((dy2, dx2), (-dy2, -dx2)):
                sv = gather(sy, sx)
                s += sec_tap * con(sv - px, sec, sec_shift)
                track(sv)
    out = px + ((s - (s < 0) + 8) >> 4)
    both = (pri > 0) & (sec > 0)
    clipped = np.maximum(mn, np.minimum(out, mx))
    return np.where(both[:, None, None], clipped, out)


def adjust_strength(strength, var):
    if var == 0:
        return 0
    i = min(_ulog2(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def _constrain_arr(diff, threshold, shift):
    """Vectorized constrain() over an int array."""
    adiff = np.abs(diff)
    v = np.minimum(adiff, np.maximum(0, threshold - (adiff >> shift)))
    return np.where(diff < 0, -v, v)


def cdef_filter_block(
    dst, src, y0, x0, w, h, pri_strength, sec_strength, direction, damping,
    have_left, have_right, have_top, have_bottom, bpc,
):
    """Filter a w x h block at (y0, x0): read from `src` (pre-CDEF copy),
    write into `dst`. Parity: cdef_filter_block_c with padding().
    Vectorized over the block (shifted-window formulation — the same shape
    the TPU kernel uses)."""
    # build tmp with 2px border, MISSING where unavailable
    tmp = np.full((h + 4, w + 4), MISSING, dtype=np.int32)
    ph, pw = src.shape
    ys = y0 - 2 if have_top else y0
    ye = y0 + h + 2 if have_bottom else y0 + h
    xs = x0 - 2 if have_left else x0
    xe = x0 + w + 2 if have_right else x0 + w
    ys_c, ye_c = max(ys, 0), min(ye, ph)
    xs_c, xe_c = max(xs, 0), min(xe, pw)
    tmp[
        2 + (ys_c - y0) : 2 + (ye_c - y0), 2 + (xs_c - x0) : 2 + (xe_c - x0)
    ] = src[ys_c:ye_c, xs_c:xe_c]

    bdm8 = bpc - 8
    if pri_strength:
        pri_tap = 4 - ((pri_strength >> bdm8) & 1)
        pri_shift = max(0, damping - _ulog2(pri_strength))
    sec_shift = damping - _ulog2(sec_strength) if sec_strength else 0

    def win(oy, ox):
        return tmp[2 + oy : 2 + oy + h, 2 + ox : 2 + ox + w].astype(np.int64)

    px = dst[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
    s = np.zeros((h, w), dtype=np.int64)
    if pri_strength and sec_strength:
        mn = px.copy()
        mx = px.copy()
        u = px.astype(np.uint64)

        def track(v):
            nonlocal mn, mx
            uv = v.astype(np.uint64)
            mn = np.where(uv < mn.astype(np.uint64), v, mn)
            mx = np.maximum(v, mx)

        pri_tap_k = pri_tap
        for k in range(2):
            oy, ox = _off(CDEF_DIRECTIONS[direction + 2][k])
            p0 = win(oy, ox)
            p1 = win(-oy, -ox)
            s += pri_tap_k * (
                _constrain_arr(p0 - px, pri_strength, pri_shift)
                + _constrain_arr(p1 - px, pri_strength, pri_shift)
            )
            pri_tap_k = (pri_tap_k & 3) | 2
            track(p0)
            track(p1)
            oy2, ox2 = _off(CDEF_DIRECTIONS[direction + 4][k])
            oy3, ox3 = _off(CDEF_DIRECTIONS[direction + 0][k])
            sec_tap = 2 - k
            for sv in (win(oy2, ox2), win(-oy2, -ox2), win(oy3, ox3), win(-oy3, -ox3)):
                s += sec_tap * _constrain_arr(sv - px, sec_strength, sec_shift)
                track(sv)
        out = px + ((s - (s < 0) + 8) >> 4)
        out = np.maximum(mn, np.minimum(out, mx))
        dst[y0 : y0 + h, x0 : x0 + w] = out
    elif pri_strength:
        pri_tap_k = pri_tap
        for k in range(2):
            oy, ox = _off(CDEF_DIRECTIONS[direction + 2][k])
            s += pri_tap_k * (
                _constrain_arr(win(oy, ox) - px, pri_strength, pri_shift)
                + _constrain_arr(win(-oy, -ox) - px, pri_strength, pri_shift)
            )
            pri_tap_k = (pri_tap_k & 3) | 2
        dst[y0 : y0 + h, x0 : x0 + w] = px + ((s - (s < 0) + 8) >> 4)
    else:
        for k in range(2):
            oy2, ox2 = _off(CDEF_DIRECTIONS[direction + 4][k])
            oy3, ox3 = _off(CDEF_DIRECTIONS[direction + 0][k])
            sec_tap = 2 - k
            for sv in (win(oy2, ox2), win(-oy2, -ox2), win(oy3, ox3), win(-oy3, -ox3)):
                s += sec_tap * _constrain_arr(sv - px, sec_strength, sec_shift)
        dst[y0 : y0 + h, x0 : x0 + w] = px + ((s - (s < 0) + 8) >> 4)


def _umin(a, b):
    """min with u32-cast semantics (MISSING treated as huge)."""
    return b if (a & 0xFFFFFFFF) >= (b & 0xFFFFFFFF) else a


def _off(o):
    """Decode a packed cdef direction offset o = dy*12 + dx (dx in -2..2)."""
    o = int(o)
    dy = (o + 6) // 12
    return dy, o - dy * 12
