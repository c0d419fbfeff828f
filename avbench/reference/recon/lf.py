"""Deblock edge-map recording and whole-frame application.

Equivalent reformulation of rav1d's per-128x128 bitmask machinery
(src/lf_mask.rs mask_edges_* + src/lf_apply.rs filter_plane_*): during
decode we record, per 4x4 cell, the filter-width class of the vertical /
horizontal edge at its left/top border (0 = unfiltered), plus the per-cell
filter levels. Application then filters all vertical edges, then all
horizontal edges (spec ordering; equivalent to rav1d's sbrow staging).
"""

from __future__ import annotations

import numpy as np

from ..headers import PixelLayout
from ..tables.block_tables import BLOCK_DIMENSIONS, TXFM_DIMENSIONS
from ..ops.ref.lf import WRITE_EXTENT, calc_eih, filter_lines_batch


def init_lf_maps(f):
    h4, w4 = f.bh, f.bw
    f.lf_level = np.zeros((h4 + 1, f.b4_stride, 4), dtype=np.uint8)
    f.lf_cls = [
        np.zeros((h4 + 1, w4 + 1), dtype=np.uint8),  # y vertical edges
        np.zeros((h4 + 1, w4 + 1), dtype=np.uint8),  # y horizontal edges
        np.zeros((h4 + 1, w4 + 1), dtype=np.uint8),  # uv vertical (chroma coords)
        np.zeros((h4 + 1, w4 + 1), dtype=np.uint8),  # uv horizontal
    ]


def _fix_tile_cols(f):
    """Clamp edge classes at tile boundaries (lf_apply
    dav1d_loopfilter_sbrow_cols fixes): vertical edges at tile column
    starts by the left tile's right-edge tx backup, horizontal edges at
    tile row starts by the above tile's bottom (a ctx) tx."""
    tiling = f.frame_hdr.tiling
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    sb_shift = f.sb_shift
    cls_v, cls_v_uv = f.lf_cls[0], f.lf_cls[2]
    for tile_col in range(1, tiling.cols):
        x0 = tiling.col_start_sb[tile_col] << sb_shift
        if x0 >= f.bw:
            break
        lpf_y = f.tx_lpf_right_edge[0][tile_col - 1]
        lpf_uv = f.tx_lpf_right_edge[1][tile_col - 1]
        for y in range(f.bh):
            c = cls_v[y, x0]
            if c:
                cls_v[y, x0] = min(c, lpf_y[y] + 1)
        x0c = x0 >> ss_hor
        for y in range((f.bh + ss_ver) >> ss_ver):
            c = cls_v_uv[y, x0c]
            if c:
                cls_v_uv[y, x0c] = min(c, lpf_uv[y] + 1)

    # tile row boundaries: horizontal-edge classes clamped by the ABOVE
    # tile row's final a-context tx_lpf
    cls_h, cls_h_uv = f.lf_cls[1], f.lf_cls[3]
    cols = tiling.cols
    for tile_row in range(1, tiling.rows):
        y0 = tiling.row_start_sb[tile_row] << sb_shift
        if y0 >= f.bh:
            break
        above = [
            f.tile_states[(tile_row - 1) * cols + c] for c in range(cols)
        ]
        for x in range(f.w4):
            c = cls_h[y0, x]
            if c:
                # find the above tile covering column x
                tc = 0
                while tc + 1 < cols and (tiling.col_start_sb[tc + 1] << sb_shift) <= x:
                    tc += 1
                cls_h[y0, x] = min(c, above[tc].a.tx_lpf_y[x] + 1)
        y0c = y0 >> ss_ver
        for x in range((f.w4 + ss_hor) >> ss_hor):
            c = cls_h_uv[y0c, x]
            if c:
                tc = 0
                while tc + 1 < cols and ((tiling.col_start_sb[tc + 1] << sb_shift) >> ss_hor) <= x:
                    tc += 1
                cls_h_uv[y0c, x] = min(c, above[tc].a.tx_lpf_uv[x] + 1)


def _decomp_tx(txa, from_tx, depth, y_off, x_off, tx_masks):
    """src/lf_mask.rs decomp_tx: fill per-cell (txw,txh) maps for var-tx.
    txa: np.uint8 array (2, 2, 32, 32); leaves filled with slice writes."""
    t_dim = TXFM_DIMENSIONS[from_tx]
    y0 = y_off * t_dim.h
    x0 = x_off * t_dim.w
    if from_tx == 0 or depth > 1:
        is_split = False
    else:
        is_split = (tx_masks[depth] >> (y_off * 4 + x_off)) & 1 != 0
    if is_split:
        sub = t_dim.sub
        _decomp_tx(txa, sub, depth + 1, y_off * 2, x_off * 2, tx_masks)
        if t_dim.w >= t_dim.h:
            _decomp_tx(txa, sub, depth + 1, y_off * 2, x_off * 2 + 1, tx_masks)
        if t_dim.h >= t_dim.w:
            _decomp_tx(txa, sub, depth + 1, y_off * 2 + 1, x_off * 2, tx_masks)
            if t_dim.w >= t_dim.h:
                _decomp_tx(txa, sub, depth + 1, y_off * 2 + 1, x_off * 2 + 1, tx_masks)
    else:
        txa[0, 0, y0 : y0 + t_dim.h, x0 : x0 + t_dim.w] = min(2, t_dim.lw)
        txa[1, 0, y0 : y0 + t_dim.h, x0 : x0 + t_dim.w] = min(2, t_dim.lh)
        txa[0, 1, y0 : y0 + t_dim.h, x0] = t_dim.w
        txa[1, 1, y0, x0 : x0 + t_dim.w] = t_dim.h


def record_lf_intra(f, ts, t, b, bs, has_chroma):
    """mask_edges_intra + _chroma + level fill (create_lf_mask_intra)."""
    frame_hdr = f.frame_hdr
    lvls = ts.lflvl[b.seg_id]
    bx, by = t.bx, t.by
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4 = min(f.w4 - bx, b_dim[0])
    bh4 = min(f.h4 - by, b_dim[1])

    if bw4 > 0 and bh4 > 0:
        f.lf_level[by : by + bh4, bx : bx + bw4, 0] = lvls[0][0][0]
        f.lf_level[by : by + bh4, bx : bx + bw4, 1] = lvls[1][0][0]
        t_dim = TXFM_DIMENSIONS[b.tx]
        twl4c = min(2, t_dim.lw)
        thl4c = min(2, t_dim.lh)
        cls_v, cls_h = f.lf_cls[0], f.lf_cls[1]
        # left block edge: class min(this tx, left neighbour tx)
        for y in range(bh4):
            cls_v[by + y, bx] = min(twl4c, t.l.tx_lpf_y[(by + y) & 31]) + 1
        # top block edge
        for x in range(bw4):
            cls_h[by, bx + x] = min(thl4c, ts.a.tx_lpf_y[bx + x]) + 1
        # inner tx edges (always coded for intra)
        for x in range(t_dim.w, bw4, t_dim.w):
            cls_v[by : by + bh4, bx + x] = twl4c + 1
        for y in range(t_dim.h, bh4, t_dim.h):
            cls_h[by + y, bx : bx + bw4] = thl4c + 1
        for y in range(bh4):
            t.l.tx_lpf_y[(by + y) & 31] = twl4c
        for x in range(bw4):
            ts.a.tx_lpf_y[bx + x] = thl4c

    if not has_chroma:
        return
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    cbw4 = min(((f.w4 + ss_hor) >> ss_hor) - (bx >> ss_hor), (b_dim[0] + ss_hor) >> ss_hor)
    cbh4 = min(((f.h4 + ss_ver) >> ss_ver) - (by >> ss_ver), (b_dim[1] + ss_ver) >> ss_ver)
    if cbw4 <= 0 or cbh4 <= 0:
        return
    cbx = bx >> ss_hor
    cby = by >> ss_ver
    f.lf_level[cby : cby + cbh4, cbx : cbx + cbw4, 2] = lvls[2][0][0]
    f.lf_level[cby : cby + cbh4, cbx : cbx + cbw4, 3] = lvls[3][0][0]
    record_chroma_edges(f, ts, t, b.uvtx, cbx, cby, cbw4, cbh4, False)


def record_lf_inter(f, ts, t, b, bs, is_comp, has_chroma):
    """mask_edges_inter + chroma + level fill (rav1d_create_lf_mask_inter,
    src/lf_mask.rs:486). Var-tx aware via b.tx_split0/1."""
    from ..syntax.levels import GLOBALMV, GLOBALMV_GLOBALMV, TX_4X4

    frame_hdr = f.frame_hdr
    is_globalmv = b.inter_mode == (GLOBALMV_GLOBALMV if is_comp else GLOBALMV)
    idx = 0 if is_globalmv else 1
    lvls = ts.lflvl[b.seg_id]
    ref = b.ref[0] + 1
    bx, by = t.bx, t.by
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4 = min(f.w4 - bx, b_dim[0])
    bh4 = min(f.h4 - by, b_dim[1])
    max_ytx = b.max_ytx
    uvtx = b.uvtx
    if frame_hdr.segmentation.lossless[b.seg_id]:
        max_ytx = TX_4X4
        uvtx = TX_4X4
    tx_masks = [b.tx_split0, b.tx_split1]

    if bw4 > 0 and bh4 > 0:
        f.lf_level[by : by + bh4, bx : bx + bw4, 0] = lvls[0][ref][idx]
        f.lf_level[by : by + bh4, bx : bx + bw4, 1] = lvls[1][ref][idx]

        t_dim = TXFM_DIMENSIONS[max_ytx]
        # decompose the var-tx tree into per-cell (lw, lh, stepw, steph) maps
        txa = np.zeros((2, 2, 32, 32), dtype=np.uint8)
        for y_off in range((bh4 + t_dim.h - 1) // t_dim.h):
            for x_off in range((bw4 + t_dim.w - 1) // t_dim.w):
                _decomp_tx(txa, max_ytx, 0, y_off, x_off, tx_masks)

        cls_v, cls_h = f.lf_cls[0], f.lf_cls[1]
        ltx_l = t.l.tx_lpf_y
        # left block edge
        cls_v[by : by + bh4, bx] = (
            np.minimum(
                txa[0, 0, :bh4, 0],
                np.array([ltx_l[(by + y) & 31] for y in range(bh4)], np.uint8),
            )
            + 1
        )
        # top block edge
        cls_h[by, bx : bx + bw4] = (
            np.minimum(txa[1, 0, 0, :bw4], np.asarray(ts.a.tx_lpf_y[bx : bx + bw4], np.uint8)) + 1
        )
        if not b.skip:
            # inner (tx) vertical edges
            tv = txa[0, 0]
            sv = txa[0, 1]
            for y in range(bh4):
                ltx = int(tv[y, 0])
                x = int(sv[y, 0])
                while x < bw4:
                    rtx = int(tv[y, x])
                    cls_v[by + y, bx + x] = min(rtx, ltx) + 1
                    ltx = rtx
                    x += int(sv[y, x])
            # inner (tx) horizontal edges
            th = txa[1, 0]
            sh = txa[1, 1]
            for x in range(bw4):
                ttx = int(th[0, x])
                y = int(sh[0, x])
                while y < bh4:
                    btx = int(th[y, x])
                    cls_h[by + y, bx + x] = min(ttx, btx) + 1
                    ttx = btx
                    y += int(sh[y, x])
        for y in range(bh4):
            t.l.tx_lpf_y[(by + y) & 31] = txa[0, 0, y, bw4 - 1]
        for x in range(bw4):
            ts.a.tx_lpf_y[bx + x] = txa[1, 0, bh4 - 1, x]

    if not has_chroma:
        return
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    cbw4 = min(
        ((f.w4 + ss_hor) >> ss_hor) - (bx >> ss_hor), (b_dim[0] + ss_hor) >> ss_hor
    )
    cbh4 = min(
        ((f.h4 + ss_ver) >> ss_ver) - (by >> ss_ver), (b_dim[1] + ss_ver) >> ss_ver
    )
    if cbw4 <= 0 or cbh4 <= 0:
        return
    cbx = bx >> ss_hor
    cby = by >> ss_ver
    f.lf_level[cby : cby + cbh4, cbx : cbx + cbw4, 2] = lvls[2][ref][idx]
    f.lf_level[cby : cby + cbh4, cbx : cbx + cbw4, 3] = lvls[3][ref][idx]
    record_chroma_edges(f, ts, t, uvtx, cbx, cby, cbw4, cbh4, bool(b.skip))


def record_chroma_edges(f, ts, t, uvtx, cbx, cby, cbw4, cbh4, skip_inter):
    uv_t_dim = TXFM_DIMENSIONS[uvtx]
    twl4c = 1 if uv_t_dim.lw else 0
    thl4c = 1 if uv_t_dim.lh else 0
    cls_v, cls_h = f.lf_cls[2], f.lf_cls[3]
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    cby4 = cby & (31 >> ss_ver)  # position within sb for left ctx
    for y in range(cbh4):
        cls_v[cby + y, cbx] = min(twl4c, t.l.tx_lpf_uv[(cby4 + y) & 31]) + 1
    for x in range(cbw4):
        cls_h[cby, cbx + x] = min(thl4c, ts.a.tx_lpf_uv[cbx + x]) + 1
    if not skip_inter:
        for x in range(uv_t_dim.w, cbw4, uv_t_dim.w):
            cls_v[cby : cby + cbh4, cbx + x] = twl4c + 1
        for y in range(uv_t_dim.h, cbh4, uv_t_dim.h):
            cls_h[cby + y, cbx : cbx + cbw4] = thl4c + 1
    for y in range(cbh4):
        t.l.tx_lpf_uv[(cby4 + y) & 31] = twl4c
    for x in range(cbw4):
        ts.a.tx_lpf_uv[cbx + x] = thl4c


def apply_loopfilter(f):
    """Filter all vertical edges, then all horizontal edges, all planes."""
    frame_hdr = f.frame_hdr
    if frame_hdr.loopfilter.level_y == [0, 0] and (
        frame_hdr.loopfilter.level_u == 0 and frame_hdr.loopfilter.level_v == 0
    ):
        return
    _fix_tile_cols(f)
    bpc = f.cur.bpc
    e_lut, i_lut = calc_eih(frame_hdr.loopfilter.sharpness)
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    h4, w4 = f.bh, f.bw
    ch4 = (f.bh + ss_ver) >> ss_ver
    cw4 = (f.bw + ss_hor) >> ss_hor
    lvl = f.lf_level
    have_y = frame_hdr.loopfilter.level_y != [0, 0]
    have_uv = (
        layout != PixelLayout.I400
        and (frame_hdr.loopfilter.level_u or frame_hdr.loopfilter.level_v)
    )

    e_arr = np.asarray(e_lut, dtype=np.int32)
    i_arr = np.asarray(i_lut, dtype=np.int32)

    def run(plane, cls_map, comp, nh4, nw4, horizontal):
        """Batched mask-driven edge filtering: gather all 4-px edge segments
        of one width class into (N*4, 16) line windows, filter in one
        vectorized call, scatter back only the write extent. Bit-exact with
        sequential order because AV1 deblock edges within one direction
        never overlap (write regions are disjoint by filter-size rules)."""
        cm = np.asarray(cls_map[:nh4, :nw4])
        lv = lvl[:nh4, :nw4, comp].astype(np.int32)
        # level fallback to the neighbor cell across the edge
        lprev = np.zeros_like(lv)
        if horizontal:
            lprev[1:, :] = lv[:-1, :]
            lv = np.where(lv != 0, lv, lprev)
            lv[0, :] = 0  # no frame-top edge
        else:
            lprev[:, 1:] = lv[:, :-1]
            lv = np.where(lv != 0, lv, lprev)
            lv[:, 0] = 0  # no frame-left edge
        active = (cm != 0) & (lv != 0)
        if not active.any():
            return
        # work on the transpose for horizontal edges: same math, swapped axes
        arr = plane.T if horizontal else plane
        pad = np.zeros((arr.shape[0] + 16, arr.shape[1] + 16), dtype=np.int32)
        pad[8:-8, 8:-8] = arr
        for cls_ in (1, 2, 3):
            sel = active & (cm == cls_)
            if not sel.any():
                continue
            ys, xs = np.nonzero(sel)
            if horizontal:
                ys, xs = xs, ys  # transposed coords
            L = lv.T[ys, xs] if horizontal else lv[ys, xs]
            wd = (4 << (cls_ - 1)) if comp < 2 else (4 + 2 * (cls_ - 1))
            # each edge is 4 lines: rows y*4..y*4+3, cols x*4-8..x*4+8
            rows = (ys[:, None] * 4 + np.arange(4)[None, :]).reshape(-1) + 8
            base = np.repeat(xs * 4, 4)
            cols = base[:, None] + np.arange(16)[None, :]  # +8 pad -8 window
            px = pad[rows[:, None], cols]
            Lr = np.repeat(L, 4)
            out = filter_lines_batch(px, e_arr[Lr], i_arr[Lr], Lr >> 4, wd, bpc)
            lo, hi = WRITE_EXTENT[wd]
            pad[rows[:, None], cols[:, lo:hi]] = out[:, lo:hi]
        arr[:, :] = pad[8 : 8 + arr.shape[0], 8 : 8 + arr.shape[1]].astype(arr.dtype)

    if have_y:
        run(f.cur.y, f.lf_cls[0], 0, h4, w4, False)
    if have_uv:
        run(f.cur.u, f.lf_cls[2], 2, ch4, cw4, False)
        run(f.cur.v, f.lf_cls[2], 3, ch4, cw4, False)
    if have_y:
        run(f.cur.y, f.lf_cls[1], 1, h4, w4, True)
    if have_uv:
        run(f.cur.u, f.lf_cls[3], 2, ch4, cw4, True)
        run(f.cur.v, f.lf_cls[3], 3, ch4, cw4, True)
