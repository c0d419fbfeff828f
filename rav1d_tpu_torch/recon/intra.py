"""Intra block reconstruction (behavior parity: src/recon.rs:2402
rav1d_recon_b_intra): per-16x16-chunk loop of edge prep → prediction →
coefficient decode → inverse transform add, in exact symbol order.
"""

from __future__ import annotations

import numpy as np

from ..syntax.levels import (
    CFL_PRED,
    DC_PRED,
    FILTER_PRED,
    SMOOTH_H_PRED,
    SMOOTH_PRED,
    SMOOTH_V_PRED,
    LEFT_DC_PRED,
    TOP_DC_PRED,
    DC_128_PRED,
    Z1_PRED,
    Z2_PRED,
    Z3_PRED,
    HOR_PRED,
    VERT_PRED,
    PAETH_PRED,
    SMOOTH_PRED as _SM,
)
from ..headers import PixelLayout
from ..tables.block_tables import BLOCK_DIMENSIONS, TXFM_DIMENSIONS
from ..syntax import intra_edge as ie
from .coefs import decode_coefs
from ..syntax.decode import trace
from .ipred_prepare import EDGE_OFF, prepare_intra_edges
from ..ops.ref import ipred as P
from ..ops.ref.itx import inv_txfm_add

_IPRED_FNS = {
    DC_PRED: P.ipred_dc,
    VERT_PRED: P.ipred_v,
    HOR_PRED: P.ipred_h,
    LEFT_DC_PRED: P.ipred_dc_left,
    TOP_DC_PRED: P.ipred_dc_top,
    DC_128_PRED: P.ipred_dc_128,
    Z1_PRED: P.ipred_z1,
    Z2_PRED: P.ipred_z2,
    Z3_PRED: P.ipred_z3,
    SMOOTH_PRED: P.ipred_smooth,
    SMOOTH_V_PRED: P.ipred_smooth_v,
    SMOOTH_H_PRED: P.ipred_smooth_h,
    PAETH_PRED: P.ipred_paeth,
    FILTER_PRED: P.ipred_filter,
}


def _sm_flag(b, idx):
    if not b.intra[idx]:
        return 0
    m = b.mode[idx]
    return 512 if m in (SMOOTH_PRED, SMOOTH_H_PRED, SMOOTH_V_PRED) else 0


def _sm_uv_flag(b, idx):
    m = b.uvmode[idx]
    return 512 if m in (SMOOTH_PRED, SMOOTH_H_PRED, SMOOTH_V_PRED) else 0


def recon_b_intra(t, f, ts, bs, intra_edge_flags, b, phase="both", item=None):
    rd = phase in ("both", "read")
    ap = phase in ("both", "apply")
    store = f.coef_store
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    bx4 = t.bx & 31
    by4 = t.by & 31
    cbx4 = bx4 >> ss_hor
    cby4 = by4 >> ss_ver
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4, bh4 = b_dim[0], b_dim[1]
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver
    has_chroma = (
        layout != PixelLayout.I400
        and (bw4 > ss_hor or t.bx & 1)
        and (bh4 > ss_ver or t.by & 1)
    )
    t_dim = TXFM_DIMENSIONS[b.tx]
    uv_t_dim = TXFM_DIMENSIONS[b.uvtx]
    cbw4 = (bw4 + ss_hor) >> ss_hor
    cbh4 = (bh4 + ss_ver) >> ss_ver
    intra_edge_filter = f.seq_hdr.intra_edge_filter
    ief_flag = intra_edge_filter << 10
    bpc = f.cur.bpc
    ypl = f.cur.y
    layout_int = int(layout)

    init_y = 0
    while init_y < h4:
        sub_h4 = min(h4, 16 + init_y)
        sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
        init_x = 0
        while init_x < w4:
            if ap and b.pal_sz[0]:
                dst = ypl[4 * t.by : 4 * t.by + bh4 * 4, 4 * t.bx : 4 * t.bx + bw4 * 4]
                P.pal_pred(dst, t.pal[0], t.pal_idx, bw4 * 4, bh4 * 4)

            intra_flags = (
                (item.sm_fl | ief_flag)
                if item is not None
                else (_sm_flag(ts.a, t.bx) | _sm_flag(t.l, by4) | ief_flag)
            )
            if init_x + 16 < w4:
                sb_has_tr = True
            elif init_y:
                sb_has_tr = False
            else:
                sb_has_tr = bool(intra_edge_flags & ie.I444_TOP_HAS_RIGHT)
            if init_x:
                sb_has_bl = False
            elif init_y + 16 < h4:
                sb_has_bl = True
            else:
                sb_has_bl = bool(intra_edge_flags & ie.I444_LEFT_HAS_BOTTOM)

            sub_w4 = min(w4, init_x + 16)
            y = init_y
            t.by += init_y
            while y < sub_h4:
                x = init_x
                t.bx += init_x
                while x < sub_w4:
                    if ap and not b.pal_sz[0]:
                        angle = b.y_angle
                        ef = (
                            ie.I444_TOP_HAS_RIGHT
                            if not (
                                (y > init_y or not sb_has_tr)
                                and x + t_dim.w >= sub_w4
                            )
                            else 0
                        ) | (
                            ie.I444_LEFT_HAS_BOTTOM
                            if not (
                                x > init_x
                                or (not sb_has_bl and y + t_dim.h >= sub_h4)
                            )
                            else 0
                        )
                        top_sb_edge = None
                        if (t.by & (f.sb_step - 1)) == 0:
                            sby_i = t.by >> f.sb_shift
                            top_sb_edge = f.ipred_edge[0][sby_i - 1]
                        m, angle = prepare_intra_edges(
                            t.bx,
                            t.bx > ts.col_start,
                            t.by,
                            t.by > ts.row_start,
                            ts.col_end,
                            ts.row_end,
                            ef,
                            ypl,
                            top_sb_edge,
                            b.y_mode,
                            angle,
                            t_dim.w,
                            t_dim.h,
                            intra_edge_filter,
                            t.edge_buf,
                            bpc,
                        )
                        dst = ypl[
                            4 * t.by : 4 * t.by + t_dim.h * 4,
                            4 * t.bx : 4 * t.bx + t_dim.w * 4,
                        ]
                        _IPRED_FNS[m](
                            dst,
                            t.edge_buf,
                            EDGE_OFF,
                            t_dim.w * 4,
                            t_dim.h * 4,
                            angle | intra_flags,
                            4 * f.bw - 4 * t.bx,
                            4 * f.bh - 4 * t.by,
                            bpc,
                        )
                    if not b.skip:
                        sz = min(t_dim.w, 8) * min(t_dim.h, 8) * 16
                        if rd:
                            cf = store.alloc_cf(sz)
                            eob, txtp, cf_ctx = decode_coefs(
                                f,
                                ts,
                                ts.a.lcoef,
                                t.l.lcoef,
                                t.bx,
                                by4 + y,
                                b.tx,
                                bs,
                                b,
                                1,
                                0,
                                cf,
                            )
                            store.push(eob, txtp, sz, t_dim.w * 4, t_dim.h * 4)
                            trace(
                                f"Post-y-cf-blk[tx={b.tx},txtp={txtp},eob={eob}]: r={ts.msac.rng}"
                            )
                            for i in range(min(t_dim.h, f.bh - t.by)):
                                t.l.lcoef[(by4 + y + i) & 31] = cf_ctx
                            for i in range(min(t_dim.w, f.bw - t.bx)):
                                ts.a.lcoef[t.bx + i] = cf_ctx
                        if ap:
                            idx, eob, txtp, cf = store.pop_idx(sz)
                            if eob >= 0:
                                dst = ypl[
                                    4 * t.by : 4 * t.by + t_dim.h * 4,
                                    4 * t.bx : 4 * t.bx + t_dim.w * 4,
                                ]
                                res = (
                                    store.residuals.get(idx)
                                    if store.residuals is not None
                                    else None
                                )
                                if res is not None:
                                    dst[:, :] = np.clip(
                                        dst.astype(np.int64) + res, 0, (1 << bpc) - 1
                                    ).astype(dst.dtype)
                                else:
                                    inv_txfm_add(
                                        dst, cf, eob, t_dim.w * 4, t_dim.h * 4, txtp, bpc
                                    )
                    elif rd:
                        for i in range(t_dim.h):
                            t.l.lcoef[(by4 + y + i) & 31] = 0x40
                        for i in range(t_dim.w):
                            ts.a.lcoef[t.bx + i] = 0x40
                    x += t_dim.w
                    t.bx += t_dim.w
                t.bx -= x
                y += t_dim.h
                t.by += t_dim.h
            t.by -= y

            if has_chroma:
                _recon_chroma(
                    t, f, ts, b, bs,
                    init_x, init_y, sub_ch4, cw4, ch4, cbw4, cbh4,
                    cbx4, cby4, ss_hor, ss_ver, uv_t_dim, t_dim,
                    intra_edge_flags, sb_has_tr, sb_has_bl, layout_int,
                    phase, item,
                )
            init_x += 16
        init_y += 16


def _recon_chroma(
    t, f, ts, b, bs,
    init_x, init_y, sub_ch4, cw4, ch4, cbw4, cbh4,
    cbx4, cby4, ss_hor, ss_ver, uv_t_dim, t_dim,
    intra_edge_flags, sb_has_tr, sb_has_bl, layout_int,
    phase="both", item=None,
):
    rd = phase in ("both", "read")
    ap = phase in ("both", "apply")
    store = f.coef_store
    bpc = f.cur.bpc
    intra_edge_filter = f.seq_hdr.intra_edge_filter
    ief_flag = intra_edge_filter << 10
    uvpl = [f.cur.u, f.cur.v]
    cbx_abs = t.bx >> ss_hor

    if ap and b.uv_mode == CFL_PRED:
        assert init_x == 0 and init_y == 0
        ac = t.ac
        furthest_r = ((cw4 << ss_hor) + t_dim.w - 1) & ~(t_dim.w - 1)
        furthest_b = ((ch4 << ss_ver) + t_dim.h - 1) & ~(t_dim.h - 1)
        y_src = f.cur.y[
            4 * (t.by & ~ss_ver) :, 4 * (t.bx & ~ss_hor) :
        ]
        P.cfl_ac(
            ac,
            y_src,
            cbw4 - (furthest_r >> ss_hor),
            cbh4 - (furthest_b >> ss_ver),
            cbw4 * 4,
            cbh4 * 4,
            ss_hor,
            ss_ver,
        )
        for pl in range(2):
            if b.cfl_alpha[pl] == 0:
                continue
            angle = 0
            top_sb_edge = None
            if (t.by & ~ss_ver & (f.sb_step - 1)) == 0:
                sby_i = t.by >> f.sb_shift
                top_sb_edge = f.ipred_edge[1 + pl][sby_i - 1]
            xpos = t.bx >> ss_hor
            ypos = t.by >> ss_ver
            xstart = ts.col_start >> ss_hor
            ystart = ts.row_start >> ss_ver
            m, angle = prepare_intra_edges(
                xpos,
                xpos > xstart,
                ypos,
                ypos > ystart,
                ts.col_end >> ss_hor,
                ts.row_end >> ss_ver,
                0,
                uvpl[pl],
                top_sb_edge,
                DC_PRED,
                angle,
                uv_t_dim.w,
                uv_t_dim.h,
                0,
                t.edge_buf,
                bpc,
            )
            dst = uvpl[pl][
                4 * ypos : 4 * ypos + uv_t_dim.h * 4,
                4 * xpos : 4 * xpos + uv_t_dim.w * 4,
            ]
            # cfl dc generation per impl mode
            if m == DC_PRED:
                dc = P.dc_gen(t.edge_buf, EDGE_OFF, uv_t_dim.w * 4, uv_t_dim.h * 4, bpc)
            elif m == TOP_DC_PRED:
                dc = P.dc_gen_top(t.edge_buf, EDGE_OFF, uv_t_dim.w * 4)
            elif m == LEFT_DC_PRED:
                dc = P.dc_gen_left(t.edge_buf, EDGE_OFF, uv_t_dim.h * 4)
            else:  # DC_128
                dc = ((1 << bpc)) >> 1
            P.cfl_pred_apply(
                dst,
                dc,
                ac[: uv_t_dim.h * 4, : uv_t_dim.w * 4],
                b.cfl_alpha[pl],
                bpc,
            )
    elif ap and b.pal_sz[1]:
        xpos = t.bx >> ss_hor
        ypos = t.by >> ss_ver
        pal_idx = t.pal_idx[
            BLOCK_DIMENSIONS[bs][0] * BLOCK_DIMENSIONS[bs][1] * 16 :
        ]
        for pl in range(2):
            dst = uvpl[pl][
                4 * ypos : 4 * ypos + cbh4 * 4, 4 * xpos : 4 * xpos + cbw4 * 4
            ]
            P.pal_pred(dst, t.pal[1 + pl], pal_idx, cbw4 * 4, cbh4 * 4)

    sm_uv_fl = (
        item.sm_uv_fl
        if item is not None
        else (_sm_uv_flag(ts.a, cbx_abs) | _sm_uv_flag(t.l, cby4))
    )
    if (init_x + 16) >> ss_hor < cw4:
        uv_sb_has_tr = True
    elif init_y:
        uv_sb_has_tr = False
    else:
        uv_sb_has_tr = bool(
            intra_edge_flags & (ie.I420_TOP_HAS_RIGHT >> (layout_int - 1))
        )
    if init_x:
        uv_sb_has_bl = False
    elif (init_y + 16) >> ss_ver < ch4:
        uv_sb_has_bl = True
    else:
        uv_sb_has_bl = bool(
            intra_edge_flags & (ie.I420_LEFT_HAS_BOTTOM >> (layout_int - 1))
        )

    sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
    for pl in range(2):
        y = init_y >> ss_ver
        t.by += init_y
        while y < sub_ch4:
            x = init_x >> ss_hor
            t.bx += init_x
            while x < sub_cw4:
                if ap and not (
                    (b.uv_mode == CFL_PRED and b.cfl_alpha[pl] != 0)
                    or b.pal_sz[1] != 0
                ):
                    angle = b.uv_angle
                    ef = (
                        0
                        if (
                            (y > (init_y >> ss_ver) or not uv_sb_has_tr)
                            and x + uv_t_dim.w >= sub_cw4
                        )
                        else ie.I444_TOP_HAS_RIGHT
                    ) | (
                        0
                        if (
                            x > (init_x >> ss_hor)
                            or (not uv_sb_has_bl and y + uv_t_dim.h >= sub_ch4)
                        )
                        else ie.I444_LEFT_HAS_BOTTOM
                    )
                    top_sb_edge = None
                    if (t.by & ~ss_ver & (f.sb_step - 1)) == 0:
                        sby_i = t.by >> f.sb_shift
                        top_sb_edge = f.ipred_edge[1 + pl][sby_i - 1]
                    uv_mode = DC_PRED if b.uv_mode == CFL_PRED else b.uv_mode
                    xpos = t.bx >> ss_hor
                    ypos = t.by >> ss_ver
                    xstart = ts.col_start >> ss_hor
                    ystart = ts.row_start >> ss_ver
                    m, angle = prepare_intra_edges(
                        xpos,
                        xpos > xstart,
                        ypos,
                        ypos > ystart,
                        ts.col_end >> ss_hor,
                        ts.row_end >> ss_ver,
                        ef,
                        uvpl[pl],
                        top_sb_edge,
                        uv_mode,
                        angle,
                        uv_t_dim.w,
                        uv_t_dim.h,
                        intra_edge_filter,
                        t.edge_buf,
                        bpc,
                    )
                    angle |= ief_flag
                    dst = uvpl[pl][
                        4 * ypos : 4 * ypos + uv_t_dim.h * 4,
                        4 * xpos : 4 * xpos + uv_t_dim.w * 4,
                    ]
                    _IPRED_FNS[m](
                        dst,
                        t.edge_buf,
                        EDGE_OFF,
                        uv_t_dim.w * 4,
                        uv_t_dim.h * 4,
                        angle | sm_uv_fl,
                        (4 * f.bw + ss_hor - 4 * (t.bx & ~ss_hor)) >> ss_hor,
                        (4 * f.bh + ss_ver - 4 * (t.by & ~ss_ver)) >> ss_ver,
                        bpc,
                    )
                if not b.skip:
                    sz = uv_t_dim.w * uv_t_dim.h * 16
                    if rd:
                        cf = store.alloc_cf(sz)
                        eob, txtp, cf_ctx = decode_coefs(
                            f,
                            ts,
                            ts.a.ccoef[pl],
                            t.l.ccoef[pl],
                            (t.bx >> ss_hor),
                            cby4 + y,
                            b.uvtx,
                            bs,
                            b,
                            1,
                            1 + pl,
                            cf,
                        )
                        store.push(eob, txtp, sz, uv_t_dim.w * 4, uv_t_dim.h * 4)
                        trace(
                            f"Post-uv-cf-blk[pl={pl},tx={b.uvtx},txtp={txtp},eob={eob}]: r={ts.msac.rng}"
                        )
                        for i in range(
                            min(uv_t_dim.h, (f.bh - t.by + ss_ver) >> ss_ver)
                        ):
                            t.l.ccoef[pl][(cby4 + y + i) & 31] = cf_ctx
                        for i in range(
                            min(uv_t_dim.w, (f.bw - t.bx + ss_hor) >> ss_hor)
                        ):
                            ts.a.ccoef[pl][(t.bx >> ss_hor) + i] = cf_ctx
                    if ap:
                        idx, eob, txtp, cf = store.pop_idx(sz)
                        if eob >= 0:
                            xpos = t.bx >> ss_hor
                            ypos = t.by >> ss_ver
                            dst = uvpl[pl][
                                4 * ypos : 4 * ypos + uv_t_dim.h * 4,
                                4 * xpos : 4 * xpos + uv_t_dim.w * 4,
                            ]
                            res = (
                                store.residuals.get(idx)
                                if store.residuals is not None
                                else None
                            )
                            if res is not None:
                                dst[:, :] = np.clip(
                                    dst.astype(np.int64) + res, 0, (1 << bpc) - 1
                                ).astype(dst.dtype)
                            else:
                                inv_txfm_add(
                                    dst, cf, eob, uv_t_dim.w * 4, uv_t_dim.h * 4, txtp, bpc
                                )
                elif rd:
                    for i in range(uv_t_dim.h):
                        t.l.ccoef[pl][(cby4 + y + i) & 31] = 0x40
                    for i in range(uv_t_dim.w):
                        ts.a.ccoef[pl][(t.bx >> ss_hor) + i] = 0x40
                x += uv_t_dim.w
                t.bx += uv_t_dim.w << ss_hor
            t.bx -= x << ss_hor
            y += uv_t_dim.h
            t.by += uv_t_dim.h << ss_ver
        t.by -= y << ss_ver
