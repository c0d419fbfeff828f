"""CDEF application driver (parity: src/cdef_apply.rs rav1d_cdef_brow).

Whole-frame batched formulation: all active 8x8 luma units are gathered into
(N, 12, 12) windows read from the pre-CDEF frame copy (equivalent to rav1d's
2-line/2x8 backups), direction-searched and filtered in one vectorized pass,
then scattered back in place. Chroma shares the luma directions (mapped for
4:2:2) exactly as rav1d does.
"""

from __future__ import annotations

import numpy as np

from ..headers import PixelLayout
from ..ops.ref.cdef import (
    MISSING,
    adjust_strength_arr,
    cdef_filter_blocks,
    find_dir_blocks,
)

UV_DIRS = [
    [0, 1, 2, 3, 4, 5, 6, 7],
    [7, 0, 2, 4, 5, 6, 6, 6],  # 4:2:2
]


def _gather_windows(src, ys, xs, h, w, have_l, have_r, have_t, have_b):
    """(N, h+4, w+4) windows at (ys, xs) px coords with MISSING where the
    2-px border is unavailable (frame edge or 8x8-unit availability)."""
    ph, pw = src.shape
    pad = np.full((ph + 4, pw + 4), MISSING, dtype=np.int32)
    pad[2 : 2 + ph, 2 : 2 + pw] = src
    n = len(ys)
    rows = ys[:, None] + np.arange(h + 4)[None, :]  # pad coords: y-2+2
    cols = xs[:, None] + np.arange(w + 4)[None, :]
    win = pad[rows[:, None, :].transpose(0, 2, 1), cols[:, None, :]]
    # mask out borders ruled unavailable by the unit flags
    win[~have_t, :2, :] = MISSING
    win[~have_b, h + 2 :, :] = MISSING
    win[~have_l, :, :2] = MISSING
    win[~have_r, :, w + 2 :] = MISSING
    return win


def apply_cdef(f):
    frame_hdr = f.frame_hdr
    cdef = frame_hdr.cdef
    if all(
        cdef.y_strength[i] == 0 and cdef.uv_strength[i] == 0
        for i in range(1 << cdef.n_bits)
    ):
        return
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    bpc = f.cur.bpc
    bdm8 = bpc - 8
    damping = cdef.damping + bdm8
    uv_dir_map = np.array(UV_DIRS[1 if layout == PixelLayout.I422 else 0])

    bw, bh = f.bw, f.bh
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1  # 8x8-px units

    # active-unit selection (noskip + cdef_idx + nonzero strengths)
    ys_u, xs_u = np.nonzero(f.noskip8[:nby, :nbx])
    if len(ys_u) == 0:
        return
    cdef_idx = f.cdef_idx[(ys_u * 2) >> 4, (xs_u * 2) >> 4].astype(np.int64)
    ok = cdef_idx >= 0
    y_str = np.asarray(cdef.y_strength, dtype=np.int64)
    uv_str = np.asarray(cdef.uv_strength, dtype=np.int64)
    y_lvl = np.where(ok, y_str[np.maximum(cdef_idx, 0)], 0)
    uv_lvl = np.where(ok, uv_str[np.maximum(cdef_idx, 0)], 0)
    keep = ok & ((y_lvl != 0) | (uv_lvl != 0))
    if not keep.any():
        return
    ys_u, xs_u = ys_u[keep], xs_u[keep]
    y_lvl, uv_lvl = y_lvl[keep], uv_lvl[keep]

    y_pri = (y_lvl >> 2) << bdm8
    y_sec = y_lvl & 3
    y_sec = np.where(y_sec == 3, 4, y_sec) << bdm8
    uv_pri = (uv_lvl >> 2) << bdm8
    uv_sec = uv_lvl & 3
    uv_sec = np.where(uv_sec == 3, 4, uv_sec) << bdm8

    have_t = ys_u > 0
    have_b = (ys_u * 2 + 2) < bh
    have_l = xs_u > 0
    have_r = (xs_u * 2 + 2) < bw

    y_src = f.cur.y.copy()

    # direction search on pre-CDEF luma for units with any primary strength
    direction = np.zeros(len(ys_u), dtype=np.int64)
    variance = np.zeros(len(ys_u), dtype=np.int64)
    need_dir = (y_pri > 0) | (uv_pri > 0)
    if need_dir.any():
        di, dv = np.nonzero(need_dir)[0], None
        rows = (ys_u[di] * 8)[:, None] + np.arange(8)[None, :]
        cols = (xs_u[di] * 8)[:, None] + np.arange(8)[None, :]
        blocks = y_src[rows[:, None, :].transpose(0, 2, 1), cols[:, None, :]]
        d, v = find_dir_blocks(blocks, bpc)
        direction[di] = d
        variance[di] = v

    # luma: effective pri is variance-adjusted; dir forced 0 when pri==0
    adj = adjust_strength_arr(y_pri, variance)
    pri_eff = np.where(y_pri > 0, adj, 0)
    dir_eff = np.where(y_pri > 0, direction, 0)
    do_y = (y_lvl != 0) & ((pri_eff > 0) | (y_sec > 0))
    if do_y.any():
        sel = np.nonzero(do_y)[0]
        wins = _gather_windows(
            y_src, ys_u[sel] * 8, xs_u[sel] * 8, 8, 8,
            have_l[sel], have_r[sel], have_t[sel], have_b[sel],
        )
        out = cdef_filter_blocks(wins, pri_eff[sel], y_sec[sel], dir_eff[sel], damping, bpc)
        rows = (ys_u[sel] * 8)[:, None] + np.arange(8)[None, :]
        cols = (xs_u[sel] * 8)[:, None] + np.arange(8)[None, :]
        f.cur.y[rows[:, None, :].transpose(0, 2, 1), cols[:, None, :]] = out.astype(
            f.cur.y.dtype
        )

    if layout == PixelLayout.I400:
        return
    do_uv = uv_lvl != 0
    if not do_uv.any():
        return
    sel = np.nonzero(do_uv)[0]
    uvdir = np.where(uv_pri[sel] > 0, uv_dir_map[direction[sel]], 0)
    cw, ch = 8 >> ss_hor, 8 >> ss_ver
    cys = (ys_u[sel] * 8) >> ss_ver
    cxs = (xs_u[sel] * 8) >> ss_hor
    rows = cys[:, None] + np.arange(ch)[None, :]
    cols = cxs[:, None] + np.arange(cw)[None, :]
    for dst in (f.cur.u, f.cur.v):
        src = dst.copy()
        wins = _gather_windows(
            src, cys, cxs, ch, cw, have_l[sel], have_r[sel], have_t[sel], have_b[sel]
        )
        out = cdef_filter_blocks(wins, uv_pri[sel], uv_sec[sel], uvdir, damping - 1, bpc)
        dst[rows[:, None, :].transpose(0, 2, 1), cols[:, None, :]] = out.astype(dst.dtype)
