"""Inter block reconstruction (parity: src/recon.rs rav1d_recon_b_inter:3162,
mc:2025, obmc:2205, warp_affine:2311, read_coef_tree).

numpy reference plane; the compound intermediates ("prep"/dst16 buffers)
are int32 arrays carrying the reference's i16 values.
"""

from __future__ import annotations

import numpy as np

from ..headers import PixelLayout, WarpedMotionType
from ..syntax.levels import *  # noqa: F403
from ..tables.block_tables import BLOCK_DIMENSIONS, TXFM_DIMENSIONS
from ..tables.wedge import II_MASKS, WEDGE_MASKS
from ..ops.ref import mc as M
from ..ops.ref.itx import inv_txfm_add
from .coefs import decode_coefs
from ..syntax.decode import trace


def _plane(pic, pl):
    return (pic.y, pic.u, pic.v)[pl]


class _PrepHandle:
    """Placeholder for a deferred compound prep result (index into
    f.prep_results, filled by the batched prep executor)."""

    __slots__ = ("idx",)

    def __init__(self, idx):
        self.idx = idx


class _WarpPrepHandle:
    """Placeholder for a deferred warp compound prep (the block's 8x8 warp
    tiles are queued in f.warp_prep_jobs tagged with this handle's id)."""

    __slots__ = ("idx", "h", "w")

    def __init__(self, idx, h, w):
        self.idx = idx
        self.h = h
        self.w = w


def _resolve(x, f):
    return f.prep_results[x.idx] if isinstance(x, _PrepHandle) else x


def run_comp_record(f, rec):
    """Numpy interpreter for one compound-combine record (the immediate /
    host execution of the typed records recon_b_inter emits; the device
    engine translates the same records into batched kernels)."""
    kind, pl, dy, dx, w, h, s0, s1, extra = rec
    dst = _plane(f.cur, pl)
    bpc = f.cur.bpc
    a = _resolve(s0, f)
    c = _resolve(s1, f)
    if kind == "avg":
        M.avg(dst, dy, dx, a, c, w, h, bpc)
    elif kind == "wavg":
        M.w_avg(dst, dy, dx, a, c, w, h, extra, bpc)
    elif kind == "mask":
        M.mask(dst, dy, dx, a, c, w, h, extra, bpc)
    elif kind == "seg_y":
        sign, sh_, sv_, seg_id = extra
        msk = M.w_mask(dst, dy, dx, a, c, w, h, sign, sh_, sv_, bpc)
        if not hasattr(f, "seg_masks"):
            f.seg_masks = {}
        f.seg_masks[seg_id] = msk
    elif kind == "seg_uv":
        # both chroma planes consume the same luma-produced mask
        msk = f.seg_masks.get(extra)
        if msk is not None and msk.shape != (h, w):
            msk = msk.reshape(h, w)
        M.mask(dst, dy, dx, a, c, w, h, msk, bpc)


def mc(f, t, dst, dst_y, dst_x, bw4, bh4, bx, by, pl, mv, refp, refidx,
       filter2d, prep=False, defer_ok=False):
    """recon.rs mc:2025. If prep, returns an int32 (h, w) intermediate;
    else writes pixels into dst at (dst_y, dst_x). With defer_ok and an
    active f.mc_jobs list, simple unscaled 8-tap puts are queued for the
    batched executor instead of running inline."""
    layout = f.cur.layout
    ss_ver = 1 if (pl and layout == PixelLayout.I420) else 0
    ss_hor = 1 if (pl and layout != PixelLayout.I444) else 0
    h_mul = 4 >> ss_hor
    v_mul = 4 >> ss_ver
    mvx, mvy = mv[0], mv[1]
    mx = mvx & (15 >> (0 if ss_hor else 1))
    my = mvy & (15 >> (0 if ss_ver else 1))
    bpc = f.cur.bpc
    plane = _plane(refp, pl)
    bw_px = bw4 * h_mul
    bh_px = bh4 * v_mul

    if refp.w == f.cur.w and refp.h == f.cur.h:
        dx = bx * h_mul + (mvx >> (3 + ss_hor))
        dy = by * v_mul + (mvy >> (3 + ss_ver))
        if refp is not f.cur:
            w = (f.cur.w + ss_hor) >> ss_hor
            h = (f.cur.h + ss_ver) >> ss_ver
        else:
            w = (f.bw * 4) >> ss_hor
            h = (f.bh * 4) >> ss_ver
        mx3 = 3 if mx else 0
        my3 = 3 if my else 0
        if (
            prep
            and defer_ok
            and filter2d != FILTER_2D_BILINEAR
            and getattr(f, "prep_jobs", None) is not None
        ):
            f.prep_jobs.append(
                (plane, dy, dx, bw_px, bh_px, mx << (0 if ss_hor else 1),
                 my << (0 if ss_ver else 1), filter2d, w, h)
            )
            return _PrepHandle(len(f.prep_jobs) - 1)
        if defer_ok and not prep and getattr(f, "mc_jobs", None) is not None:
            # the batched executor's clamped gather reproduces emu_edge's
            # border replication, so out-of-bounds puts defer too
            job = (dst, dst_y, dst_x, plane, dy, dx, bw_px, bh_px,
                   mx << (0 if ss_hor else 1), my << (0 if ss_ver else 1),
                   filter2d, w, h)
            if filter2d != FILTER_2D_BILINEAR:
                f.mc_jobs.append(job)
                return None
            if getattr(f, "bilin_jobs", None) is not None:
                f.bilin_jobs.append(job)
                return None
        # host-computed path from here on: the ref's pixels must be on the
        # host (engine-decoded refs may still be device-resident with a
        # deferred batched fetch — run2.flush_fetches)
        if getattr(refp, "_pending_fetch", None) is not None:
            refp.materialize()
        if (
            dx < mx3
            or dy < my3
            or dx + bw_px + (4 if mx else 0) > w
            or dy + bh_px + (4 if my else 0) > h
        ):
            src = M.emu_edge(
                bw_px + (7 if mx else 0), bh_px + (7 if my else 0),
                w, h, dx - mx3, dy - my3, plane,
            )
            sy, sx = my3, mx3
        else:
            src, sy, sx = plane, dy, dx
        fmx = mx << (0 if ss_hor else 1)
        fmy = my << (0 if ss_ver else 1)
        if prep:
            if filter2d == FILTER_2D_BILINEAR:
                return M.prep_bilin(src, sy, sx, bw_px, bh_px, fmx, fmy, bpc)
            return M.prep_8tap(src, sy, sx, bw_px, bh_px, fmx, fmy, filter2d, bpc)
        if filter2d == FILTER_2D_BILINEAR:
            M.put_bilin(dst, dst_y, dst_x, src, sy, sx, bw_px, bh_px, fmx, fmy, bpc)
        else:
            M.put_8tap(
                dst, dst_y, dst_x, src, sy, sx, bw_px, bh_px, fmx, fmy, filter2d, bpc
            )
        return None
    else:
        # scaled reference (recon.rs mc scaled branch) — always
        # host-computed: fetch deferred device-resident ref pixels first
        if getattr(refp, "_pending_fetch", None) is not None:
            refp.materialize()

        def apply_sign64(v, s):
            return -v if s < 0 else v

        scale_x = f.svc[refidx][0]["scale"]
        scale_y = f.svc[refidx][1]["scale"]
        step_x = f.svc[refidx][0]["step"]
        step_y = f.svc[refidx][1]["step"]
        orig_pos_y = (by * v_mul << 4) + mvy * (2 >> ss_ver)
        orig_pos_x = (bx * h_mul << 4) + mvx * (2 >> ss_hor)
        tmp = orig_pos_x * scale_x + (scale_x - 0x4000) * 8
        pos_x = apply_sign64((abs(tmp) + 128) >> 8, tmp) + 32
        tmp = orig_pos_y * scale_y + (scale_y - 0x4000) * 8
        pos_y = apply_sign64((abs(tmp) + 128) >> 8, tmp) + 32
        left = pos_x >> 10
        top = pos_y >> 10
        right = ((pos_x + (bw_px - 1) * step_x) >> 10) + 1
        bottom = ((pos_y + (bh_px - 1) * step_y) >> 10) + 1
        w = (refp.w + ss_hor) >> ss_hor
        h = (refp.h + ss_ver) >> ss_ver
        if left < 3 or top < 3 or right + 4 > w or bottom + 4 > h:
            src = M.emu_edge(
                right - left + 7, bottom - top + 7, w, h, left - 3, top - 3, plane
            )
            sy, sx = 3, 3
        else:
            src, sy, sx = plane, top, left
        pmx = pos_x & 0x3FF
        pmy = pos_y & 0x3FF
        if prep:
            if filter2d == FILTER_2D_BILINEAR:
                return M.prep_bilin_scaled(
                    src, sy, sx, bw_px, bh_px, pmx, pmy, step_x, step_y, bpc
                )
            return M.prep_8tap_scaled(
                src, sy, sx, bw_px, bh_px, pmx, pmy, step_x, step_y, filter2d, bpc
            )
        if filter2d == FILTER_2D_BILINEAR:
            M.put_bilin_scaled(
                dst, dst_y, dst_x, src, sy, sx, bw_px, bh_px, pmx, pmy,
                step_x, step_y, bpc,
            )
        else:
            M.put_8tap_scaled(
                dst, dst_y, dst_x, src, sy, sx, bw_px, bh_px, pmx, pmy,
                step_x, step_y, filter2d, bpc,
            )
        return None


def _filter2d_of(fdir0, fdir1):
    """tables.rs dav1d_filter_2d[vert][horiz] lookup for neighbour filters."""
    from ..syntax.decode import FILTER_2D

    return FILTER_2D[fdir1][fdir0]


def obmc(f, t, ts, dst, dst_y, dst_x, b_dim, pl, bx4, by4, w4, h4, item=None):
    """recon.rs obmc:2205: overlapped block MC from top/left neighbours."""
    assert t.bx & 1 == 0 and t.by & 1 == 0
    if item is not None:
        af = lambda d, idx: item.a_filter[d][idx - item.bx]  # noqa: E731
        lfi = lambda d, idx: item.l_filter[d][idx]  # noqa: E731
    else:
        af = lambda d, idx: ts.a.filter[d][idx]  # noqa: E731
        lfi = lambda d, idx: t.l.filter[d][idx]  # noqa: E731
    layout = f.cur.layout
    ss_ver = 1 if (pl and layout == PixelLayout.I420) else 0
    ss_hor = 1 if (pl and layout != PixelLayout.I444) else 0
    h_mul = 4 >> ss_hor
    v_mul = 4 >> ss_ver
    rf = f.rf

    if t.by > ts.row_start and (pl == 0 or b_dim[0] * h_mul + b_dim[1] * v_mul >= 16):
        i = 0
        x = 0
        while x < w4 and i < min(b_dim[2], 4):
            a_r = rf.r[t.by - 1, t.bx + x + 1]
            a_b_dim = BLOCK_DIMENSIONS[int(a_r["bs"])]
            step4 = min(max(a_b_dim[0], 2), 16)
            if int(a_r["ref"][0]) > 0:
                ow4 = min(step4, b_dim[0])
                oh4 = (min(b_dim[1], 16)) >> 1
                lap = np.zeros((((oh4 * 3 + 3) >> 2) * v_mul, ow4 * h_mul),
                               dtype=dst.dtype)
                f2d = _filter2d_of(
                    af(0, t.bx + x + 1), af(1, t.bx + x + 1)
                )
                mc(
                    f, t, lap, 0, 0, ow4, (oh4 * 3 + 3) >> 2, t.bx + x, t.by, pl,
                    (int(a_r["mv"][0][0]), int(a_r["mv"][0][1])),
                    f.refp[int(a_r["ref"][0]) - 1], int(a_r["ref"][0]) - 1, f2d,
                    defer_ok=True,
                )
                blends = getattr(f, "obmc_blends", None)
                if blends is not None:
                    blends.append(("h", dst, dst_y, dst_x + x * h_mul, lap,
                                   h_mul * ow4, v_mul * oh4))
                else:
                    M.blend_h(dst, dst_y, dst_x + x * h_mul, lap, h_mul * ow4, v_mul * oh4)
                i += 1
            x += step4
    if t.bx > ts.col_start:
        i = 0
        y = 0
        while y < h4 and i < min(b_dim[3], 4):
            l_r = rf.r[t.by + y + 1, t.bx - 1]
            l_b_dim = BLOCK_DIMENSIONS[int(l_r["bs"])]
            step4 = min(max(l_b_dim[1], 2), 16)
            if int(l_r["ref"][0]) > 0:
                ow4 = min(b_dim[0], 16) >> 1
                oh4 = min(step4, b_dim[1])
                lap = np.zeros((oh4 * v_mul, ow4 * h_mul), dtype=dst.dtype)
                f2d = _filter2d_of(
                    lfi(0, (by4 + y + 1) & 31), lfi(1, (by4 + y + 1) & 31)
                )
                mc(
                    f, t, lap, 0, 0, ow4, oh4, t.bx, t.by + y, pl,
                    (int(l_r["mv"][0][0]), int(l_r["mv"][0][1])),
                    f.refp[int(l_r["ref"][0]) - 1], int(l_r["ref"][0]) - 1, f2d,
                    defer_ok=True,
                )
                blends = getattr(f, "obmc_blends", None)
                if blends is not None:
                    blends.append(("v", dst, dst_y + y * v_mul, dst_x, lap,
                                   h_mul * ow4, v_mul * oh4))
                else:
                    M.blend_v(dst, dst_y + y * v_mul, dst_x, lap, h_mul * ow4, v_mul * oh4)
                i += 1
            y += step4
    return None


def warp_affine(f, t, dst, dst_y, dst_x, prep_out, b_dim, pl, refp, wmp):
    """recon.rs warp_affine:2311. Writes pixels (dst) or prep (prep_out)."""
    layout = f.cur.layout
    ss_ver = 1 if (pl and layout == PixelLayout.I420) else 0
    ss_hor = 1 if (pl and layout != PixelLayout.I444) else 0
    h_mul = 4 >> ss_hor
    v_mul = 4 >> ss_ver
    assert (b_dim[0] * h_mul) & 7 == 0 and (b_dim[1] * v_mul) & 7 == 0
    mat = wmp.matrix
    abcd = (wmp.alpha, wmp.beta, wmp.gamma, wmp.delta)
    width = (refp.w + ss_hor) >> ss_hor
    height = (refp.h + ss_ver) >> ss_ver
    plane = _plane(refp, pl)
    bpc = f.cur.bpc

    prep_handle = isinstance(prep_out, _WarpPrepHandle)
    for y in range(0, b_dim[1] * v_mul, 8):
        src_y = t.by * 4 + ((y + 4) << ss_ver)
        mat3_y = mat[3] * src_y + mat[0]
        mat5_y = mat[5] * src_y + mat[1]
        for x in range(0, b_dim[0] * h_mul, 8):
            src_x = t.bx * 4 + ((x + 4) << ss_hor)
            mvx = (mat[2] * src_x + mat3_y) >> ss_hor
            mvy = (mat[4] * src_x + mat5_y) >> ss_ver
            dx = (mvx >> 16) - 4
            mx = ((mvx & 0xFFFF) - wmp.alpha * 4 - wmp.beta * 7) & ~0x3F
            dy = (mvy >> 16) - 4
            my = ((mvy & 0xFFFF) - wmp.gamma * 4 - wmp.delta * 4) & ~0x3F
            if prep_handle:
                f.warp_prep_jobs.append(
                    (prep_out.idx, y, x, plane, dy, dx, abcd, mx, my,
                     width, height)
                )
                continue
            if prep_out is None and getattr(f, "warp_jobs", None) is not None:
                f.warp_jobs.append(
                    (dst, dst_y + y, dst_x + x, plane, dy, dx, abcd, mx, my,
                     width, height)
                )
                continue
            if getattr(refp, "_pending_fetch", None) is not None:
                refp.materialize()  # host warp reads ref pixels directly
            if dx < 3 or dx + 8 + 4 > width or dy < 3 or dy + 8 + 4 > height:
                src = M.emu_edge(15, 15, width, height, dx - 3, dy - 3, plane)
                sy, sx = 3, 3
            else:
                src, sy, sx = plane, dy, dx
            if prep_out is not None:
                M.warp_affine_8x8t(prep_out, y, x, src, sy, sx, abcd, mx, my, bpc)
            else:
                M.warp_affine_8x8(
                    dst, dst_y + y, dst_x + x, src, sy, sx, abcd, mx, my, bpc
                )


def read_coef_tree(t, f, ts, bs, b, ytx, depth, tx_split, x_off, y_off, dst,
                   dst_y, dst_x, phase="both"):
    """recon.rs read_coef_tree: var-tx recursive coefficient decode + itx."""
    rd = phase in ("both", "read")
    ap = phase in ("both", "apply")
    t_dim = TXFM_DIMENSIONS[ytx]
    txw, txh = t_dim.w, t_dim.h
    if (
        depth < 2
        and tx_split[depth]
        and tx_split[depth] & (1 << (y_off * 4 + x_off))
    ):
        sub = t_dim.sub
        sub_t_dim = TXFM_DIMENSIONS[sub]
        txsw, txsh = sub_t_dim.w, sub_t_dim.h
        read_coef_tree(
            t, f, ts, bs, b, sub, depth + 1, tx_split, x_off * 2, y_off * 2,
            dst, dst_y, dst_x, phase,
        )
        t.bx += txsw
        if txw >= txh and t.bx < f.bw:
            read_coef_tree(
                t, f, ts, bs, b, sub, depth + 1, tx_split, x_off * 2 + 1,
                y_off * 2, dst, dst_y, dst_x + 4 * txsw, phase,
            )
        t.bx -= txsw
        t.by += txsh
        if txh >= txw and t.by < f.bh:
            read_coef_tree(
                t, f, ts, bs, b, sub, depth + 1, tx_split, x_off * 2,
                y_off * 2 + 1, dst, dst_y + 4 * txsh, dst_x, phase,
            )
            t.bx += txsw
            if txw >= txh and t.bx < f.bw:
                read_coef_tree(
                    t, f, ts, bs, b, sub, depth + 1, tx_split, x_off * 2 + 1,
                    y_off * 2 + 1, dst, dst_y + 4 * txsh, dst_x + 4 * txsw, phase,
                )
            t.bx -= txsw
        t.by -= txsh
    else:
        bx4 = t.bx & 31
        by4 = t.by & 31
        store = f.coef_store
        sz = min(t_dim.w, 8) * min(t_dim.h, 8) * 16
        if rd:
            cf = store.alloc_cf(sz)
            eob, txtp, cf_ctx = decode_coefs(
                f, ts, ts.a.lcoef, t.l.lcoef, t.bx, by4, ytx, bs, b, 0, 0, cf
            )
            store.push(eob, txtp, sz, txw * 4, txh * 4)
            trace(f"Post-y-cf-blk[tx={ytx},txtp={txtp},eob={eob}]: r={ts.msac.rng}")
            for i in range(min(txh, f.bh - t.by)):
                t.l.lcoef[(by4 + i) & 31] = cf_ctx
            for i in range(min(txw, f.bw - t.bx)):
                ts.a.lcoef[t.bx + i] = cf_ctx
            t.txtp_map[by4 : by4 + txh, bx4 : bx4 + txw] = txtp
        if ap:
            idx, eob, txtp, cf = store.pop_idx(sz)
            if eob >= 0:
                jobs = getattr(f, "itx_jobs", None)
                if jobs is not None:
                    jobs.append((0, dst_y, dst_x, txw * 4, txh * 4, eob, txtp, cf))
                else:
                    dv = dst[dst_y : dst_y + 4 * txh, dst_x : dst_x + 4 * txw]
                    res = (
                        store.residuals.get(idx)
                        if store.residuals is not None
                        else None
                    )
                    if res is not None:
                        dv[:, :] = np.clip(
                            dv.astype(np.int64) + res, 0, (1 << f.cur.bpc) - 1
                        ).astype(dv.dtype)
                    else:
                        inv_txfm_add(
                            dv, cf, eob, txw * 4, txh * 4, txtp, f.cur.bpc,
                        )


def recon_b_inter(t, f, ts, bs, b, phase="both", item=None,
                  skip_residuals=False):
    """recon.rs rav1d_recon_b_inter:3162."""
    rd = phase in ("both", "read")
    ap = phase in ("both", "apply")
    from ..syntax.env import get_uv_inter_txtp
    from .intra import _IPRED_FNS
    from .ipred_prepare import EDGE_OFF, prepare_intra_edges

    bx4 = t.bx & 31
    by4 = t.by & 31
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    cbx4 = bx4 >> ss_hor
    cby4 = by4 >> ss_ver
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4, bh4 = b_dim[0], b_dim[1]
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    has_chroma = (
        layout != PixelLayout.I400
        and (bw4 > ss_hor or t.bx & 1)
        and (bh4 > ss_ver or t.by & 1)
    )
    if layout == PixelLayout.I400:
        chr_layout_idx = 0
    else:
        chr_layout_idx = int(PixelLayout.I444) - int(layout)
    cbh4 = (bh4 + ss_ver) >> ss_ver
    cbw4 = (bw4 + ss_hor) >> ss_hor
    frame_hdr = f.frame_hdr
    bpc = f.cur.bpc
    ypl = f.cur.y
    dsty, dstx = 4 * t.by, 4 * t.bx
    cdsty, cdstx = 4 * (t.by >> ss_ver), 4 * (t.bx >> ss_hor)

    if not ap:
        # syntax pass: keep only the rolling tl_4x4_filter context update
        if (not frame_hdr.frame_type.is_key_or_intra) and b.comp_type == COMP_INTER_NONE:
            t.tl_4x4_filter = b.filter2d
    else:
        if frame_hdr.frame_type.is_key_or_intra:
            # intra block copy
            assert not frame_hdr.size.super_res.enabled
            mc(
                f, t, ypl, dsty, dstx, bw4, bh4, t.bx, t.by, 0,
                tuple(b.mv[0]), f.sr_cur, 0, FILTER_2D_BILINEAR,
            )
            if has_chroma:
                for pl in (1, 2):
                    mc(
                        f, t, _plane(f.cur, pl), cdsty, cdstx,
                        bw4 << (1 if bw4 == ss_hor else 0),
                        bh4 << (1 if bh4 == ss_ver else 0),
                        t.bx & ~ss_hor, t.by & ~ss_ver, pl,
                        tuple(b.mv[0]), f.sr_cur, 0, FILTER_2D_BILINEAR,
                    )
        elif b.comp_type != COMP_INTER_NONE:
            filter2d = b.filter2d
            records = getattr(f, "comp_records", None)

            def emit(rec):
                if records is not None:
                    records.append(rec)
                else:
                    run_comp_record(f, rec)

            def prep_one(i, pl, cw, ch):
                refp = f.refp[b.ref[i]]
                use_warp = (
                    b.inter_mode == GLOBALMV_GLOBALMV
                    and f.gmv_warp_allowed[b.ref[i]]
                    and (pl == 0 or min(cbw4, cbh4) > 1)
                )
                if use_warp:
                    if getattr(f, "warp_prep_jobs", None) is not None:
                        hl = f.warp_prep_handles
                        hnd = _WarpPrepHandle(len(hl), ch, cw)
                        hl.append(hnd)
                        warp_affine(
                            f, t, None, 0, 0, hnd, b_dim, pl, refp,
                            frame_hdr.gmv[b.ref[i]],
                        )
                        return hnd
                    arr = np.zeros((ch, cw), dtype=np.int32)
                    warp_affine(
                        f, t, None, 0, 0, arr, b_dim, pl, refp,
                        frame_hdr.gmv[b.ref[i]],
                    )
                    return arr
                return mc(
                    f, t, None, 0, 0, bw4, bh4, t.bx, t.by, pl,
                    tuple(b.mv[i]), refp, b.ref[i], filter2d, prep=True,
                    defer_ok=True,
                )

            t0 = prep_one(0, 0, bw4 * 4, bh4 * 4)
            t1 = prep_one(1, 0, bw4 * 4, bh4 * 4)
            jnt_weight = 0
            sign = b.mask_sign
            seg_id = None
            if b.comp_type == COMP_INTER_AVG:
                emit(("avg", 0, dsty, dstx, bw4 * 4, bh4 * 4, t0, t1, None))
            elif b.comp_type == COMP_INTER_WEIGHTED_AVG:
                jnt_weight = f.jnt_weights[b.ref[0]][b.ref[1]]
                emit(("wavg", 0, dsty, dstx, bw4 * 4, bh4 * 4, t0, t1,
                      jnt_weight))
            elif b.comp_type == COMP_INTER_SEG:
                ta, tb = (t1, t0) if sign else (t0, t1)
                sh_ = ss_hor if chr_layout_idx else 0
                sv_ = ss_ver if chr_layout_idx == 2 else 0
                seg_id = getattr(f, "seg_masks_n", 0)
                f.seg_masks_n = seg_id + 1
                emit(("seg_y", 0, dsty, dstx, bw4 * 4, bh4 * 4, ta, tb,
                      (sign, sh_, sv_, seg_id)))
            elif b.comp_type == COMP_INTER_WEDGE:
                ta, tb = (t1, t0) if sign else (t0, t1)
                wm = WEDGE_MASKS[bs][0][0][b.wedge_idx].reshape(bh4 * 4, bw4 * 4)
                emit(("mask", 0, dsty, dstx, bw4 * 4, bh4 * 4, ta, tb, wm))
            if has_chroma:
                cw_px = (bw4 * 4) >> ss_hor
                ch_px = (bh4 * 4) >> ss_ver
                for pl in range(2):
                    c0 = prep_one(0, 1 + pl, cw_px, ch_px)
                    c1 = prep_one(1, 1 + pl, cw_px, ch_px)
                    if b.comp_type == COMP_INTER_AVG:
                        emit(("avg", 1 + pl, cdsty, cdstx, cw_px, ch_px,
                              c0, c1, None))
                    elif b.comp_type == COMP_INTER_WEIGHTED_AVG:
                        emit(("wavg", 1 + pl, cdsty, cdstx, cw_px, ch_px,
                              c0, c1, jnt_weight))
                    elif b.comp_type == COMP_INTER_SEG:
                        ca, cb = (c1, c0) if sign else (c0, c1)
                        emit(("seg_uv", 1 + pl, cdsty, cdstx, cw_px, ch_px,
                              ca, cb, seg_id))
                    else:
                        ca, cb = (c1, c0) if sign else (c0, c1)
                        wmc = WEDGE_MASKS[bs][chr_layout_idx][sign][
                            b.wedge_idx
                        ].reshape(ch_px, cw_px)
                        emit(("mask", 1 + pl, cdsty, cdstx, cw_px, ch_px,
                              ca, cb, wmc))
        else:
            refp = f.refp[b.ref[0]]
            filter2d = b.filter2d
            if min(bw4, bh4) > 1 and (
                (b.inter_mode == GLOBALMV and f.gmv_warp_allowed[b.ref[0]])
                or (
                    b.motion_mode == MM_WARP
                    and t.warpmv.type > WarpedMotionType.TRANSLATION
                )
            ):
                wmp = t.warpmv if b.motion_mode == MM_WARP else frame_hdr.gmv[b.ref[0]]
                warp_affine(f, t, ypl, dsty, dstx, None, b_dim, 0, refp, wmp)
            else:
                mc(
                    f, t, ypl, dsty, dstx, bw4, bh4, t.bx, t.by, 0,
                    tuple(b.mv[0]), refp, b.ref[0], filter2d,
                    defer_ok=b.motion_mode != MM_OBMC
                    or getattr(f, "engine_collect", False),
                )
                if b.motion_mode == MM_OBMC:
                    obmc(f, t, ts, ypl, dsty, dstx, b_dim, 0, bx4, by4, w4, h4, item)
            if b.interintra_type != INTER_INTRA_NONE and not getattr(
                f, "engine_collect", False
            ):
                m = SMOOTH_PRED if b.interintra_mode == 3 else b.interintra_mode
                top_sb_edge = None
                if (t.by & (f.sb_step - 1)) == 0:
                    top_sb_edge = f.ipred_edge[0][(t.by >> f.sb_shift) - 1]
                m, angle = prepare_intra_edges(
                    t.bx, t.bx > ts.col_start, t.by, t.by > ts.row_start,
                    ts.col_end, ts.row_end, 0, ypl, top_sb_edge, m, 0,
                    bw4, bh4, 0, t.edge_buf, bpc,
                )
                ii_tmp = np.zeros((bh4 * 4, bw4 * 4), dtype=ypl.dtype)
                _IPRED_FNS[m](
                    ii_tmp, t.edge_buf, EDGE_OFF, bw4 * 4, bh4 * 4, angle, 0, 0, bpc
                )
                if b.interintra_type == INTER_INTRA_BLEND:
                    ii_mask = II_MASKS[bs][0][b.interintra_mode]
                else:
                    ii_mask = WEDGE_MASKS[bs][0][0][b.wedge_idx]
                M.blend(
                    ypl, dsty, dstx, ii_tmp, bw4 * 4, bh4 * 4,
                    ii_mask[: bh4 * 4 * bw4 * 4].reshape(bh4 * 4, bw4 * 4)
                    if len(ii_mask) >= bh4 * 4 * bw4 * 4
                    else np.broadcast_to(ii_mask, (bh4 * 4, bw4 * 4)),
                )
            if has_chroma:
                is_sub8x8 = bw4 == ss_hor or bh4 == ss_ver
                if is_sub8x8:
                    assert ss_hor == 1
                    rf = f.rf
                    if bw4 == 1:
                        is_sub8x8 &= int(rf.r[t.by, t.bx - 1]["ref"][0]) > 0
                    if bh4 == ss_ver:
                        is_sub8x8 &= int(rf.r[t.by - 1, t.bx]["ref"][0]) > 0
                    if bw4 == 1 and bh4 == ss_ver:
                        is_sub8x8 &= int(rf.r[t.by - 1, t.bx - 1]["ref"][0]) > 0
                if is_sub8x8:
                    h_off = 0
                    v_off = 0
                    if bw4 == 1 and bh4 == ss_ver:
                        for pl in range(2):
                            r = f.rf.r[t.by - 1, t.bx - 1]
                            mc(
                                f, t, _plane(f.cur, 1 + pl), cdsty, cdstx,
                                bw4, bh4, t.bx - 1, t.by - 1, 1 + pl,
                                (int(r["mv"][0][0]), int(r["mv"][0][1])),
                                f.refp[int(r["ref"][0]) - 1], int(r["ref"][0]) - 1,
                                t.tl_4x4_filter, defer_ok=True,
                            )
                        v_off = 2
                        h_off = 2
                    if bw4 == 1:
                        left_f2d = _filter2d_of(
                            (item.l_filter[0][by4] if item is not None else t.l.filter[0][by4]),
                            (item.l_filter[1][by4] if item is not None else t.l.filter[1][by4]),
                        )
                        for pl in range(2):
                            r = f.rf.r[t.by, t.bx - 1]
                            mc(
                                f, t, _plane(f.cur, 1 + pl), cdsty + v_off, cdstx,
                                bw4, bh4, t.bx - 1, t.by, 1 + pl,
                                (int(r["mv"][0][0]), int(r["mv"][0][1])),
                                f.refp[int(r["ref"][0]) - 1], int(r["ref"][0]) - 1,
                                left_f2d, defer_ok=True,
                            )
                        h_off = 2
                    if bh4 == ss_ver:
                        top_f2d = _filter2d_of(
                            (item.a_filter[0][0] if item is not None else ts.a.filter[0][t.bx]),
                            (item.a_filter[1][0] if item is not None else ts.a.filter[1][t.bx]),
                        )
                        for pl in range(2):
                            r = f.rf.r[t.by - 1, t.bx]
                            mc(
                                f, t, _plane(f.cur, 1 + pl), cdsty, cdstx + h_off,
                                bw4, bh4, t.bx, t.by - 1, 1 + pl,
                                (int(r["mv"][0][0]), int(r["mv"][0][1])),
                                f.refp[int(r["ref"][0]) - 1], int(r["ref"][0]) - 1,
                                top_f2d, defer_ok=True,
                            )
                        v_off = 2
                    for pl in range(2):
                        mc(
                            f, t, _plane(f.cur, 1 + pl), cdsty + v_off, cdstx + h_off,
                            bw4, bh4, t.bx, t.by, 1 + pl,
                            tuple(b.mv[0]), refp, b.ref[0], filter2d,
                            defer_ok=True,
                        )
                else:
                    if min(cbw4, cbh4) > 1 and (
                        (b.inter_mode == GLOBALMV and f.gmv_warp_allowed[b.ref[0]])
                        or (
                            b.motion_mode == MM_WARP
                            and t.warpmv.type > WarpedMotionType.TRANSLATION
                        )
                    ):
                        wmp = (
                            t.warpmv
                            if b.motion_mode == MM_WARP
                            else frame_hdr.gmv[b.ref[0]]
                        )
                        for pl in range(2):
                            warp_affine(
                                f, t, _plane(f.cur, 1 + pl), cdsty, cdstx, None,
                                b_dim, 1 + pl, refp, wmp,
                            )
                    else:
                        for pl in range(2):
                            mc(
                                f, t, _plane(f.cur, 1 + pl), cdsty, cdstx,
                                bw4 << (1 if bw4 == ss_hor else 0),
                                bh4 << (1 if bh4 == ss_ver else 0),
                                t.bx & ~ss_hor, t.by & ~ss_ver, 1 + pl,
                                tuple(b.mv[0]), refp, b.ref[0], filter2d,
                                defer_ok=b.motion_mode != MM_OBMC
                                or getattr(f, "engine_collect", False),
                            )
                            if b.motion_mode == MM_OBMC:
                                obmc(
                                    f, t, ts, _plane(f.cur, 1 + pl), cdsty, cdstx,
                                    b_dim, 1 + pl, bx4, by4, w4, h4, item,
                                )
                    if b.interintra_type != INTER_INTRA_NONE and not getattr(
                        f, "engine_collect", False
                    ):
                        if b.interintra_type == INTER_INTRA_BLEND:
                            ii_mask = II_MASKS[bs][chr_layout_idx][b.interintra_mode]
                        else:
                            ii_mask = WEDGE_MASKS[bs][chr_layout_idx][0][b.wedge_idx]
                        for pl in range(2):
                            m = SMOOTH_PRED if b.interintra_mode == 3 else b.interintra_mode
                            uvpl = _plane(f.cur, 1 + pl)
                            top_sb_edge = None
                            if (t.by & (f.sb_step - 1)) == 0:
                                top_sb_edge = f.ipred_edge[pl + 1][
                                    (t.by >> f.sb_shift) - 1
                                ]
                            m, angle = prepare_intra_edges(
                                t.bx >> ss_hor,
                                (t.bx >> ss_hor) > (ts.col_start >> ss_hor),
                                t.by >> ss_ver,
                                (t.by >> ss_ver) > (ts.row_start >> ss_ver),
                                ts.col_end >> ss_hor,
                                ts.row_end >> ss_ver,
                                0, uvpl, top_sb_edge, m, 0, cbw4, cbh4, 0,
                                t.edge_buf, bpc,
                            )
                            ii_tmp = np.zeros((cbh4 * 4, cbw4 * 4), dtype=uvpl.dtype)
                            _IPRED_FNS[m](
                                ii_tmp, t.edge_buf, EDGE_OFF, cbw4 * 4, cbh4 * 4,
                                angle, 0, 0, bpc,
                            )
                            M.blend(
                                uvpl, cdsty, cdstx, ii_tmp, cbw4 * 4, cbh4 * 4,
                                ii_mask[: cbh4 * 4 * cbw4 * 4].reshape(
                                    cbh4 * 4, cbw4 * 4
                                ),
                            )
            t.tl_4x4_filter = filter2d


    # residuals
    if skip_residuals:
        # batch phase: itx jobs are emitted wholesale from the coef store
        # (recon/frame.py _emit_batch_itx_from_store)
        return
    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver
    if b.skip:
        if rd:
            for i in range(bw4):
                ts.a.lcoef[t.bx + i] = 0x40
            for i in range(bh4):
                t.l.lcoef[(by4 + i) & 31] = 0x40
            if has_chroma:
                cbx_abs = t.bx >> ss_hor
                for pl in range(2):
                    for i in range(cbw4):
                        ts.a.ccoef[pl][cbx_abs + i] = 0x40
                    for i in range(cbh4):
                        t.l.ccoef[pl][(cby4 + i) & 31] = 0x40
        return
    uvt_dim = TXFM_DIMENSIONS[b.uvtx]
    yt_dim = TXFM_DIMENSIONS[b.max_ytx]
    tx_split = [b.tx_split0, b.tx_split1]
    for init_y in range(0, bh4, 16):
        for init_x in range(0, bw4, 16):
            y_off = 1 if init_y else 0
            y = init_y
            t.by += init_y
            while y < min(h4, init_y + 16):
                x_off = 1 if init_x else 0
                x = init_x
                t.bx += init_x
                while x < min(w4, init_x + 16):
                    read_coef_tree(
                        t, f, ts, bs, b, b.max_ytx, 0, tx_split, x_off, y_off,
                        ypl, 4 * t.by, 4 * t.bx, phase,
                    )
                    t.bx += yt_dim.w
                    x += yt_dim.w
                    x_off += 1
                t.bx -= x
                t.by += yt_dim.h
                y += yt_dim.h
                y_off += 1
            t.by -= y
            if has_chroma:
                for pl in range(2):
                    uvpl = _plane(f.cur, 1 + pl)
                    y = init_y >> ss_ver
                    t.by += init_y
                    while y < min(ch4, (init_y + 16) >> ss_ver):
                        x = init_x >> ss_hor
                        t.bx += init_x
                        while x < min(cw4, (init_x + 16) >> ss_hor):
                            sz = min(uvt_dim.w, 8) * min(uvt_dim.h, 8) * 16
                            store = f.coef_store
                            if rd:
                                ytxtp = int(
                                    t.txtp_map[
                                        (by4 + (y << ss_ver)) & 31,
                                        (bx4 + (x << ss_hor)) & 31,
                                    ]
                                )
                                cf = store.alloc_cf(sz)
                                eob, txtp, cf_ctx = decode_coefs(
                                    f, ts, ts.a.ccoef[pl], t.l.ccoef[pl],
                                    (t.bx >> ss_hor), cby4 + y, b.uvtx, bs, b, 0,
                                    1 + pl, cf, ytxtp,
                                )
                                store.push(eob, txtp, sz, uvt_dim.w * 4, uvt_dim.h * 4)
                                trace(
                                    f"Post-uv-cf-blk[pl={pl},tx={b.uvtx},"
                                    f"txtp={txtp},eob={eob}]: r={ts.msac.rng}"
                                )
                                for i in range(
                                    min(uvt_dim.h, (f.bh - t.by + ss_ver) >> ss_ver)
                                ):
                                    t.l.ccoef[pl][(cby4 + y + i) & 31] = cf_ctx
                                for i in range(
                                    min(uvt_dim.w, (f.bw - t.bx + ss_hor) >> ss_hor)
                                ):
                                    ts.a.ccoef[pl][(t.bx >> ss_hor) + i] = cf_ctx
                            if ap:
                                idx, eob, txtp, cf = store.pop_idx(sz)
                                if eob >= 0:
                                    jobs = getattr(f, "itx_jobs", None)
                                    if jobs is not None:
                                        jobs.append((
                                            1 + pl, 4 * (t.by >> ss_ver),
                                            4 * (t.bx >> ss_hor),
                                            uvt_dim.w * 4, uvt_dim.h * 4,
                                            eob, txtp, cf,
                                        ))
                                    else:
                                        dv = uvpl[
                                            4 * (t.by >> ss_ver) : 4
                                            * (t.by >> ss_ver)
                                            + uvt_dim.h * 4,
                                            4 * (t.bx >> ss_hor) : 4
                                            * (t.bx >> ss_hor)
                                            + uvt_dim.w * 4,
                                        ]
                                        res = (
                                            store.residuals.get(idx)
                                            if store.residuals is not None
                                            else None
                                        )
                                        if res is not None:
                                            dv[:, :] = np.clip(
                                                dv.astype(np.int64) + res, 0,
                                                (1 << bpc) - 1,
                                            ).astype(dv.dtype)
                                        else:
                                            inv_txfm_add(
                                                dv, cf, eob, uvt_dim.w * 4,
                                                uvt_dim.h * 4, txtp, bpc,
                                            )
                            t.bx += uvt_dim.w << ss_hor
                            x += uvt_dim.w
                        t.bx -= x << ss_hor
                        t.by += uvt_dim.h << ss_ver
                        y += uvt_dim.h
                    t.by -= y << ss_ver
