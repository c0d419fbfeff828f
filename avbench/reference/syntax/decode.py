"""Tile syntax decode: partition walk + per-block mode decode.

Behavior parity: src/decode.rs (decode_sb:3260, decode_b:1131,
decode_tile_sbrow:3853, setup_tile:3652) — intra path; inter lands next.
"""

from __future__ import annotations

import numpy as np

from ..entropy.msac import MsacContext
from ..headers import (
    FilterMode,
    FrameType,
    PixelLayout,
    TxfmMode,
    WarpedMotionType,
    PRIMARY_REF_NONE,
)
from ..tables.block_tables import (
    AL_PART_CTX,
    BLOCK_DIMENSIONS,
    BLOCK_SIZES,
    CFL_ALLOWED_MASK,
    INTRA_MODE_CONTEXT,
    MAX_TXFM_SIZE_FOR_BS,
    PARTITION_TYPE_COUNT,
    TXFM_DIMENSIONS,
    YMODE_SIZE_CONTEXT,
)
from ..tables.spec_data import DQ_TBL
from . import intra_edge as ie
from . import refmvs
from .env import (
    BlockContext,
    N_SWITCHABLE_FILTERS,
    av1_get_bwd_ref_1_ctx,
    av1_get_bwd_ref_ctx,
    av1_get_fwd_ref_1_ctx,
    av1_get_fwd_ref_2_ctx,
    av1_get_fwd_ref_ctx,
    av1_get_ref_ctx,
    av1_get_uni_p1_ctx,
    fix_mv_precision,
    gather_left_partition_prob,
    gather_top_partition_prob,
    get_comp_ctx,
    get_comp_dir_ctx,
    get_drl_context,
    get_filter_ctx,
    get_gmv_2d,
    get_intra_ctx,
    get_jnt_comp_ctx,
    get_mask_comp_ctx,
    get_partition_ctx,
    get_tx_ctx,
)
from ..recon.warp import derive_warpmv


def get_cur_frame_segid_2d(bx, by, have_top, have_left, seg_map):
    """2-D variant of src/env.rs get_cur_frame_segid."""
    if have_left and have_top:
        l = int(seg_map[by, bx - 1])
        a = int(seg_map[by - 1, bx])
        al = int(seg_map[by - 1, bx - 1])
        if l == a == al:
            seg_ctx = 2
        elif l == a or al == l or a == al:
            seg_ctx = 1
        else:
            seg_ctx = 0
        return (a if a == al else l), seg_ctx
    if have_left:
        return int(seg_map[by, bx - 1]), 0
    if have_top:
        return int(seg_map[by - 1, bx]), 0
    return 0, 0
from .levels import *  # noqa: F403


class DecodeError(ValueError):
    pass


TRACE = [False]


def trace(msg):
    if TRACE[0]:
        print(msg)


def iclip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def iclip_u8(v):
    return iclip(v, 0, 255)


def neg_deinterleave(diff, ref, max_):
    if ref == 0:
        return diff
    if ref >= max_ - 1:
        return max_ - diff - 1
    if 2 * ref < max_:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    else:
        if diff <= 2 * (max_ - ref - 1):
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return max_ - (diff + 1)


class TileState:
    """Per-tile decode state (Rav1dTileState, src/internal.rs:824)."""

    def __init__(self, f, tile_row, tile_col, data):
        frame_hdr = f.frame_hdr
        seq_hdr = f.seq_hdr
        self.tile_row = tile_row
        self.tile_col = tile_col
        sb_shift = f.sb_shift
        t = frame_hdr.tiling
        self.col_start = t.col_start_sb[tile_col] << sb_shift
        self.col_end = min(t.col_start_sb[tile_col + 1] << sb_shift, f.bw)
        self.row_start = t.row_start_sb[tile_row] << sb_shift
        self.row_end = min(t.row_start_sb[tile_row + 1] << sb_shift, f.bh)
        self.msac = MsacContext(data, frame_hdr.disable_cdf_update != 0)
        self.cdf = f.in_cdf.clone()
        self.last_qidx = frame_hdr.quant.yac
        self.last_delta_lf = [0, 0, 0, 0]
        self._have_hp = frame_hdr.hp
        # dq table: default frame-wide; per-sb local when delta-q in use
        self.dq = f.dq
        self.lflvl = f.lf_lvl  # frame-wide lf levels
        # above context spans the tile width (absolute bx4 indexing),
        # padded so right-edge overhanging blocks can write freely
        self.a = BlockContext(f.bw + 64)
        # restoration-unit exp-coding references (setup_tile, decode.rs:3712)
        from ..recon.lr_apply import RestorationUnit

        self.lr_ref = [RestorationUnit(), RestorationUnit(), RestorationUnit()]


class TaskContext:
    """Per-worker scratch (Rav1dTaskContext, src/internal.rs:981)."""

    def __init__(self, f):
        self.bx = 0
        self.by = 0
        self.l = BlockContext(32)
        self.cf = np.zeros(32 * 32, dtype=np.int32)
        self.al_pal = np.zeros((2, 32, 3, 8), dtype=np.uint16)  # [dir][b4][plane][palsz]
        self.pal_sz_uv = [[0] * 32, [0] * 32]  # [dir][b4]
        self.pal = np.zeros((3, 8), dtype=np.uint16)  # current block's palettes
        self.pal_idx = np.zeros(2 * 64 * 64, dtype=np.uint8)
        self.edge_buf = np.zeros(257 + 32, dtype=np.int32)
        self.ac = np.zeros((32, 32), dtype=np.int32)
        self.txtp_map = np.zeros((32, 32), dtype=np.uint8)
        self.cur_sb_cdef_idx = 0
        self.lf_mask = None
        self.tl_4x4_filter = 0
        self.frame_thread_pass = 0
        self.rt = None  # RefMvsTile, set per tile-sbrow
        from ..headers import WarpedMotionParams

        self.warpmv = WarpedMotionParams()


def init_quant_tables(seq_hdr, frame_hdr, qidx, dq):
    """dq: [8][3][2] list (src/decode.rs:194)."""
    seg_on = frame_hdr.segmentation.enabled
    for i in range(8 if seg_on else 1):
        yac = (
            iclip_u8(qidx + frame_hdr.segmentation.seg_data.d[i].delta_q)
            if seg_on
            else qidx
        )
        ydc = iclip_u8(yac + frame_hdr.quant.ydc_delta)
        uac = iclip_u8(yac + frame_hdr.quant.uac_delta)
        udc = iclip_u8(yac + frame_hdr.quant.udc_delta)
        vac = iclip_u8(yac + frame_hdr.quant.vac_delta)
        vdc = iclip_u8(yac + frame_hdr.quant.vdc_delta)
        hbd = seq_hdr.hbd
        dq[i][0][0] = int(DQ_TBL[hbd][ydc][0])
        dq[i][0][1] = int(DQ_TBL[hbd][yac][1])
        dq[i][1][0] = int(DQ_TBL[hbd][udc][0])
        dq[i][1][1] = int(DQ_TBL[hbd][uac][1])
        dq[i][2][0] = int(DQ_TBL[hbd][vdc][0])
        dq[i][2][1] = int(DQ_TBL[hbd][vac][1])


def reset_context(ctx: BlockContext, keyframe: bool, pass_: int = 0):
    n = len(ctx.mode)
    ctx.intra[:] = [1 if keyframe else 0] * n
    ctx.uvmode[:] = [DC_PRED] * n
    if keyframe:
        ctx.mode[:] = [DC_PRED] * n
    if pass_ == 2:
        return
    ctx.partition[:] = [0] * (n >> 1)
    ctx.skip[:] = [0] * n
    ctx.skip_mode[:] = [0] * n
    ctx.tx_lpf_y[:] = [2] * n
    ctx.tx_lpf_uv[:] = [1] * n
    ctx.tx_intra[:] = [-1] * n
    ctx.tx[:] = [TX_64X64] * n
    if not keyframe:
        ctx.ref[0][:] = [-1] * n
        ctx.ref[1][:] = [-1] * n
        ctx.comp_type[:] = [0] * n
        ctx.mode[:] = [NEARESTMV] * n
    ctx.lcoef[:] = [0x40] * n
    ctx.ccoef[0][:] = [0x40] * n
    ctx.ccoef[1][:] = [0x40] * n
    ctx.filter[0][:] = [N_SWITCHABLE_FILTERS] * n
    ctx.filter[1][:] = [N_SWITCHABLE_FILTERS] * n
    ctx.seg_pred[:] = [0] * n
    ctx.pal_sz[:] = [0] * n


N_SWITCHABLE_FILTERS = 3


def get_prev_frame_segid(frame_hdr, bx, by, w4, h4, prev_segmap):
    """MINIMUM seg id over the colocated area (src/decode.rs:855)."""
    assert frame_hdr.primary_ref_frame != PRIMARY_REF_NONE
    seg = prev_segmap[by : by + h4, bx : bx + w4]
    return int(seg.min()) if seg.size else 8


def read_tx_tree(t, f, ts, from_tx, depth, masks, x_off, y_off):
    """src/decode.rs:313."""
    bx4 = t.bx & 31
    by4 = t.by & 31
    t_dim = TXFM_DIMENSIONS[from_tx]
    txw, txh = t_dim.lw, t_dim.lh
    if depth < 2 and from_tx > TX_4X4:
        cat = 2 * (TX_64X64 - t_dim.max) - depth
        a = 1 if ts.a.tx[t.bx] < txw else 0
        l = 1 if t.l.tx[by4] < txh else 0
        is_split = ts.msac.decode_bool_adapt(ts.cdf.m.txpart[cat][a + l])
        if is_split:
            masks[depth] |= 1 << (y_off * 4 + x_off)
    else:
        is_split = False
    if is_split and t_dim.max > TX_8X8:
        sub = t_dim.sub
        sub_t_dim = TXFM_DIMENSIONS[sub]
        txsw, txsh = sub_t_dim.w, sub_t_dim.h
        read_tx_tree(t, f, ts, sub, depth + 1, masks, x_off * 2 + 0, y_off * 2 + 0)
        t.bx += txsw
        if txw >= txh and t.bx < f.bw:
            read_tx_tree(t, f, ts, sub, depth + 1, masks, x_off * 2 + 1, y_off * 2)
        t.bx -= txsw
        t.by += txsh
        if txh >= txw and t.by < f.bh:
            read_tx_tree(t, f, ts, sub, depth + 1, masks, x_off * 2, y_off * 2 + 1)
            t.bx += txsw
            if txw >= txh and t.bx < f.bw:
                read_tx_tree(
                    t, f, ts, sub, depth + 1, masks, x_off * 2 + 1, y_off * 2 + 1
                )
            t.bx -= txsw
        t.by -= txsh
    else:
        av = TX_4X4 if is_split else txw
        lv = TX_4X4 if is_split else txh
        for i in range(t_dim.w):
            ts.a.tx[t.bx + i] = av
        for i in range(t_dim.h):
            t.l.tx[(by4 + i) & 31] = lv


def _read_pal_plane(t, f, ts, b, pl, sz_ctx, bx4, by4):
    """src/recon.rs:4443 rav1d_read_pal_plane."""
    pli = 1 if pl else 0
    not_pl = 0 if pl else 1
    msac = ts.msac
    pal_sz = msac.decode_symbol_adapt(ts.cdf.m.pal_sz[pli][sz_ctx], 6) + 2
    b.pal_sz[pli] = pal_sz
    cache = []
    l_cache = t.pal_sz_uv[1][by4] if pl else t.l.pal_sz[by4]
    n_cache = 0
    a_cache = 0
    if t.by & 15:  # don't reuse above palette outside SB64 boundaries
        a_cache = t.pal_sz_uv[0][bx4] if pl else ts.a.pal_sz[t.bx]
    l = list(t.al_pal[1][by4][pli])
    a = list(t.al_pal[0][bx4][pli])
    li = ai = 0
    while l_cache and a_cache:
        if l[li] < a[ai]:
            if not cache or cache[-1] != l[li]:
                cache.append(int(l[li]))
            li += 1
            l_cache -= 1
        else:
            if a[ai] == l[li]:
                li += 1
                l_cache -= 1
            if not cache or cache[-1] != a[ai]:
                cache.append(int(a[ai]))
            ai += 1
            a_cache -= 1
    if l_cache:
        while True:
            if not cache or cache[-1] != l[li]:
                cache.append(int(l[li]))
            li += 1
            l_cache -= 1
            if l_cache <= 0:
                break
    elif a_cache:
        while True:
            if not cache or cache[-1] != a[ai]:
                cache.append(int(a[ai]))
            ai += 1
            a_cache -= 1
            if a_cache <= 0:
                break
    used_cache = []
    for c in cache:
        if len(used_cache) >= pal_sz:
            break
        if msac.decode_bool_equi():
            used_cache.append(c)

    pal = t.pal[pli]
    i = len(used_cache)
    bpc = f.cur.bpc
    if i < pal_sz:
        prev = msac.decode_bools(bpc)
        pal[i] = prev
        i += 1
        if i < pal_sz:
            bits = bpc + msac.decode_bools(2) - 3
            maxv = (1 << bpc) - 1
            while True:
                delta = msac.decode_bools(bits)
                prev = min(prev + delta + not_pl, maxv)
                pal[i] = prev
                i += 1
                if prev + not_pl >= maxv:
                    for j in range(i, pal_sz):
                        pal[j] = maxv
                    break
                bits = min(bits, 1 + _ulog2(maxv - prev - not_pl))
                if i >= pal_sz:
                    break
        # merge sorted cache+new entries
        merged = [0] * pal_sz
        n = 0
        m = len(used_cache)
        new_vals = [int(pal[k]) for k in range(pal_sz)]
        for k in range(pal_sz):
            if n < len(used_cache) and (m >= pal_sz or used_cache[n] <= new_vals[m]):
                merged[k] = used_cache[n]
                n += 1
            else:
                merged[k] = new_vals[m]
                m += 1
        for k in range(pal_sz):
            pal[k] = merged[k]
    else:
        for k, v in enumerate(used_cache):
            pal[k] = v


def _ulog2(v):
    return v.bit_length() - 1


def _read_pal_uv(t, f, ts, b, sz_ctx, bx4, by4):
    _read_pal_plane(t, f, ts, b, True, sz_ctx, bx4, by4)
    msac = ts.msac
    pal = t.pal[2]
    bpc = f.cur.bpc
    n = b.pal_sz[1]
    if msac.decode_bool_equi():
        bits = bpc + msac.decode_bools(2) - 4
        prev = msac.decode_bools(bpc)
        pal[0] = prev
        maxv = (1 << bpc) - 1
        for k in range(1, n):
            delta = msac.decode_bools(bits)
            if delta and msac.decode_bool_equi():
                delta = -delta
            prev = (prev + delta) & maxv
            pal[k] = prev
    else:
        for k in range(n):
            pal[k] = msac.decode_bools(bpc)


def _order_palette(pal_idx, stride, i, first, last):
    """src/decode.rs:638; returns (order, ctx) lists for the diagonal."""
    have_top = i > first
    orders = []
    ctxs = []
    offset = first + (i - first) * stride
    for j in range(first, last - 1, -1):
        have_left = j > 0
        mask = 0
        o = []

        def add(v):
            nonlocal mask
            o.append(v)
            mask |= 1 << v

        if not have_left:
            ctxs.append(0)
            add(int(pal_idx[offset - stride]))
        elif not have_top:
            ctxs.append(0)
            add(int(pal_idx[offset - 1]))
        else:
            l = int(pal_idx[offset - 1])
            tp = int(pal_idx[offset - stride])
            tl = int(pal_idx[offset - (stride + 1)])
            same_t_l = tp == l
            same_t_tl = tp == tl
            same_l_tl = l == tl
            same_all = same_t_l and same_t_tl and same_l_tl
            if same_all:
                ctxs.append(4)
                add(tp)
            elif same_t_l:
                ctxs.append(3)
                add(tp)
                add(tl)
            elif same_t_tl or same_l_tl:
                ctxs.append(2)
                add(tl)
                add(l if same_t_tl else tp)
            else:
                ctxs.append(1)
                add(min(tp, l))
                add(max(tp, l))
                add(tl)
        for bit in range(8):
            if not (mask & (1 << bit)):
                o.append(bit)
        orders.append(o)
        have_top = True
        offset += stride - 1
    return orders, ctxs


def _read_pal_indices(t, ts, pal_idx, b, pl, w4, h4, bw4, bh4):
    """src/decode.rs:714."""
    pli = 1 if pl else 0
    pal_sz = b.pal_sz[pli]
    stride = bw4 * 4
    msac = ts.msac
    pal_idx[0] = msac.decode_uniform(pal_sz)
    color_map_cdf = ts.cdf.m.color_map[pli][pal_sz - 2]
    for i in range(1, 4 * (w4 + h4) - 1):
        first = min(i, w4 * 4 - 1)
        last = max(i + 1 - h4 * 4, 0)
        orders, ctxs = _order_palette(pal_idx, stride, i, first, last)
        for m, j in enumerate(range(first, last - 1, -1)):
            color_idx = msac.decode_symbol_adapt(
                color_map_cdf[ctxs[m]], pal_sz - 1
            )
            pal_idx[(i - j) * stride + j] = orders[m][color_idx]
    if bw4 > w4:
        for y in range(4 * h4):
            off = y * stride + 4 * w4
            pal_idx[off : off + 4 * (bw4 - w4)] = pal_idx[off - 1]
    if h4 < bh4:
        src = pal_idx[stride * (h4 * 4 - 1) : stride * (h4 * 4 - 1) + stride]
        for y in range(h4 * 4, bh4 * 4):
            pal_idx[y * stride : (y + 1) * stride] = src


# BlockSize bit masks (tables.rs wedge_allowed_mask / interintra_allowed_mask):
# 8x8..32x32 rectangular-ish sizes where wedge/interintra compound is legal.
_WEDGE_SIZES = (BS_32x32, BS_32x16, BS_32x8, BS_16x32, BS_16x16, BS_16x8,
                BS_8x32, BS_8x16, BS_8x8)
WEDGE_ALLOWED_MASK = sum(1 << b for b in _WEDGE_SIZES)
_II_SIZES = (BS_32x32, BS_32x16, BS_16x32, BS_16x16, BS_16x8, BS_8x16, BS_8x8)
INTERINTRA_ALLOWED_MASK = sum(1 << b for b in _II_SIZES)
WEDGE_CTX_LUT = [0, 0, 0, 0, 0, 0, 0, 6, 5, 8, 0, 4, 3, 2, 0, 7, 1, 0, 0, 0, 0, 0]

# FILTER_2D[filter_v][filter_h] (tables.rs dav1d_filter_2d)
FILTER_2D = [
    [FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR_SMOOTH, FILTER_2D_8TAP_REGULAR_SHARP, FILTER_2D_8TAP_REGULAR],
    [FILTER_2D_8TAP_SMOOTH_REGULAR, FILTER_2D_8TAP_SMOOTH, FILTER_2D_8TAP_SMOOTH_SHARP, FILTER_2D_8TAP_REGULAR],
    [FILTER_2D_8TAP_SHARP_REGULAR, FILTER_2D_8TAP_SHARP_SMOOTH, FILTER_2D_8TAP_SHARP, FILTER_2D_8TAP_REGULAR],
    [FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR, FILTER_2D_BILINEAR],
]


def _i16(v):
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def read_mv_component_diff(ts, mcdf, have_fp):
    """src/decode.rs read_mv_component_diff."""
    msac = ts.msac
    have_hp = ts._have_hp
    sign = msac.decode_bool_adapt(mcdf.sign)
    cl = msac.decode_symbol_adapt(mcdf.classes, 10)
    if cl == 0:
        up = msac.decode_bool_adapt(mcdf.class0)
        if have_fp:
            fp = msac.decode_symbol_adapt(mcdf.class0_fp[up], 3)
            hp = msac.decode_bool_adapt(mcdf.class0_hp) if have_hp else 1
        else:
            fp = 3
            hp = 1
    else:
        up = 1 << cl
        for n in range(cl):
            up |= msac.decode_bool_adapt(mcdf.classN[n]) << n
        if have_fp:
            fp = msac.decode_symbol_adapt(mcdf.classN_fp, 3)
            hp = msac.decode_bool_adapt(mcdf.classN_hp) if have_hp else 1
        else:
            fp = 3
            hp = 1
    diff = ((up << 3) | (fp << 1) | hp) + 1
    return -diff if sign else diff


def read_mv_residual(ts, refmv, mv_cdf, have_fp):
    """src/decode.rs read_mv_residual. refmv: mutable [x, y] list.

    Like the reference (and dav1d C), the joint symbol always uses
    cdf.mv.joint, even when component cdfs come from cdf.dmv (intrabc)."""
    jt = ts.msac.decode_symbol_adapt(ts.cdf.mv.joint, 3)
    if jt == MV_JOINT_HV:
        refmv[1] = _i16(refmv[1] + read_mv_component_diff(ts, mv_cdf.comp[0], have_fp))
        refmv[0] = _i16(refmv[0] + read_mv_component_diff(ts, mv_cdf.comp[1], have_fp))
    elif jt == MV_JOINT_H:
        refmv[0] = _i16(refmv[0] + read_mv_component_diff(ts, mv_cdf.comp[1], have_fp))
    elif jt == MV_JOINT_V:
        refmv[1] = _i16(refmv[1] + read_mv_component_diff(ts, mv_cdf.comp[0], have_fp))


def read_vartx_tree(t, f, ts, b, bs, bx4, by4):
    """src/decode.rs read_vartx_tree."""
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4, bh4 = b_dim[0], b_dim[1]
    tx_split = [0, 0]
    b.max_ytx = MAX_TXFM_SIZE_FOR_BS[bs][0]
    frame_hdr = f.frame_hdr
    txfm_mode = frame_hdr.txfm_mode
    if not b.skip and (
        frame_hdr.segmentation.lossless[b.seg_id] or b.max_ytx == TX_4X4
    ):
        b.uvtx = TX_4X4
        b.max_ytx = TX_4X4
        if txfm_mode == TxfmMode.SWITCHABLE:
            for i in range(bw4):
                ts.a.tx[t.bx + i] = TX_4X4
            for i in range(bh4):
                t.l.tx[(by4 + i) & 31] = TX_4X4
    elif txfm_mode != TxfmMode.SWITCHABLE or b.skip:
        if txfm_mode == TxfmMode.SWITCHABLE:
            for i in range(bw4):
                ts.a.tx[t.bx + i] = b_dim[2]
            for i in range(bh4):
                t.l.tx[(by4 + i) & 31] = b_dim[3]
        b.uvtx = MAX_TXFM_SIZE_FOR_BS[bs][int(f.cur.layout)]
    else:
        ytx = TXFM_DIMENSIONS[b.max_ytx]
        for y_off in range(bh4 // ytx.h):
            for x_off in range(bw4 // ytx.w):
                read_tx_tree(t, f, ts, b.max_ytx, 0, tx_split, x_off, y_off)
                t.bx += ytx.w
            t.bx -= bw4
            t.by += ytx.h
        t.by -= bh4
        trace(f"Post-vartxtree[{tx_split[0]:x}/{tx_split[1]:x}]: r={ts.msac.rng}")
        b.uvtx = MAX_TXFM_SIZE_FOR_BS[bs][int(f.cur.layout)]
    assert tx_split[0] & ~0x33 == 0
    b.tx_split0 = tx_split[0]
    b.tx_split1 = tx_split[1]


def find_matching_ref(f, t, ts, intra_edge_flags, bw4, bh4, w4, h4,
                      have_left, have_top, ref):
    """src/decode.rs find_matching_ref. Returns masks [2] (64-bit ints)."""
    rf = f.rf
    masks = [0, 0]
    count = 0
    have_topleft = have_top and have_left
    have_topright = (
        max(bw4, bh4) < 32
        and have_top
        and t.bx + bw4 < ts.col_end
        and (intra_edge_flags & ie.I444_TOP_HAS_RIGHT)
    )

    def rec(row, col):
        r2 = rf.r[row, col]
        return (
            int(r2["ref"][0]),
            int(r2["ref"][1]),
            BLOCK_DIMENSIONS[int(r2["bs"])],
        )

    if have_top:
        row = t.by - 1
        col = t.bx
        r0, r1, bd = rec(row, col)
        if r0 == ref + 1 and r1 == -1:
            masks[0] |= 1
            count = 1
        aw4 = bd[0]
        if aw4 >= bw4:
            off = t.bx & (aw4 - 1)
            if off:
                have_topleft = False
            if aw4 - off > bw4:
                have_topright = False
        else:
            mask = 1 << aw4
            x = aw4
            while x < w4:
                col += aw4
                r0, r1, bd = rec(row, col)
                if r0 == ref + 1 and r1 == -1:
                    masks[0] |= mask
                    count += 1
                    if count >= 8:
                        return masks
                aw4 = bd[0]
                mask <<= aw4
                x += aw4
    if have_left:
        row = t.by
        col = t.bx - 1
        r0, r1, bd = rec(row, col)
        if r0 == ref + 1 and r1 == -1:
            masks[1] |= 1
            count += 1
            if count >= 8:
                return masks
        lh4 = bd[1]
        if lh4 >= bh4:
            if t.by & (lh4 - 1):
                have_topleft = False
        else:
            mask = 1 << lh4
            y = lh4
            while y < h4:
                row += lh4
                r0, r1, bd = rec(row, col)
                if r0 == ref + 1 and r1 == -1:
                    masks[1] |= mask
                    count += 1
                    if count >= 8:
                        return masks
                lh4 = bd[1]
                mask <<= lh4
                y += lh4
    if have_topleft:
        r0, r1, _ = rec(t.by - 1, t.bx - 1)
        if r0 == ref + 1 and r1 == -1:
            masks[1] |= 1 << 32
            count += 1
            if count >= 8:
                return masks
    if have_topright:
        r0, r1, _ = rec(t.by - 1, t.bx + bw4)
        if r0 == ref + 1 and r1 == -1:
            masks[0] |= 1 << 32
    return masks


def _findoddzero(vals):
    """decode.rs findoddzero: any zero at an odd index."""
    for i in range(1, len(vals), 2):
        if not vals[i]:
            return True
    return False


def _snapshot_inter_item(t, f, ts, bs, b, bw4, bh4, by4):
    """Queue an inter work item with the mutable-context snapshots the
    deferred dense pass needs (filters for OBMC/sub8x8, warp params, the
    rolling top-left filter)."""
    from ..recon.store import WorkItem
    from ..headers import WarpedMotionParams

    wi = WorkItem("inter", t, ts, bs, b)
    w4 = min(bw4, f.bw - t.bx)
    wi.a_filter = (
        ts.a.filter[0][t.bx : t.bx + w4 + 2].copy(),
        ts.a.filter[1][t.bx : t.bx + w4 + 2].copy(),
    )
    wi.l_filter = (t.l.filter[0].copy(), t.l.filter[1].copy())
    wi.tl_4x4_filter = t.tl_4x4_filter
    if getattr(b, "motion_mode", 0) == 2 and t.warpmv is not None:  # MM_WARP
        wm = WarpedMotionParams()
        wm.type = t.warpmv.type
        wm.matrix = list(t.warpmv.matrix)
        wm.alpha, wm.beta = t.warpmv.alpha, t.warpmv.beta
        wm.gamma, wm.delta = t.warpmv.gamma, t.warpmv.delta
        wi.warpmv = wm
    wi.tx_pos = f.coef_store.tx_pos
    wi.cf_pos = f.coef_store.cf_pos
    f.work_items.append(wi)
    return wi


def decode_b(t, f, ts, bl, bs, bp, intra_edge_flags):
    """Per-block decode (src/decode.rs:1159 decode_b_inner)."""
    from ..recon.intra import recon_b_intra
    from ..recon.inter import recon_b_inter

    b = Av1Block()
    b_dim = BLOCK_DIMENSIONS[bs]
    bx4 = t.bx & 31
    by4 = t.by & 31
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    cbx4 = bx4 >> ss_hor
    cby4 = by4 >> ss_ver
    bw4 = b_dim[0]
    bh4 = b_dim[1]
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    cbw4 = (bw4 + ss_hor) >> ss_hor
    cbh4 = (bh4 + ss_ver) >> ss_ver
    have_left = t.bx > ts.col_start
    have_top = t.by > ts.row_start
    has_chroma = (
        layout != PixelLayout.I400
        and (bw4 > ss_hor or t.bx & 1)
        and (bh4 > ss_ver or t.by & 1)
    )
    frame_hdr = f.frame_hdr
    seq_hdr = f.seq_hdr
    frame_type = frame_hdr.frame_type
    msac = ts.msac
    cdf = ts.cdf

    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver

    b.bl = bl
    b.bp = bp
    b.bs = bs

    seg = None
    seg_pred = False

    # segment_id (preskip)
    if frame_hdr.segmentation.enabled:
        if not frame_hdr.segmentation.update_map:
            if f.prev_segmap is not None:
                seg_id = get_prev_frame_segid(
                    frame_hdr, t.bx, t.by, w4, h4, f.prev_segmap
                )
                if seg_id >= 8:
                    raise DecodeError("bad prev segid")
                b.seg_id = seg_id
            else:
                b.seg_id = 0
            seg = frame_hdr.segmentation.seg_data.d[b.seg_id]
        elif frame_hdr.segmentation.seg_data.preskip:
            if frame_hdr.segmentation.temporal:
                index = ts.a.seg_pred[t.bx] + t.l.seg_pred[by4]
                seg_pred = bool(
                    msac.decode_bool_adapt(cdf.m.seg_pred[index])
                )
            else:
                seg_pred = False
            if frame_hdr.segmentation.temporal and seg_pred:
                if f.prev_segmap is not None:
                    seg_id = get_prev_frame_segid(
                        frame_hdr, t.bx, t.by, w4, h4, f.prev_segmap
                    )
                    if seg_id >= 8:
                        raise DecodeError("bad prev segid")
                    b.seg_id = seg_id
                else:
                    b.seg_id = 0
            else:
                pred_seg_id, seg_ctx = get_cur_frame_segid_2d(
                    t.bx, t.by, have_top, have_left, f.cur_segmap
                )
                diff = msac.decode_symbol_adapt(cdf.m.seg_id[seg_ctx], 7)
                last_active_seg_id = frame_hdr.segmentation.seg_data.last_active_segid
                b.seg_id = neg_deinterleave(
                    diff, int(pred_seg_id), last_active_seg_id + 1
                ) & 0xFF  # reference casts to u8 before clamping
                if b.seg_id > last_active_seg_id or b.seg_id >= 8:
                    b.seg_id = 0
            seg = frame_hdr.segmentation.seg_data.d[b.seg_id]
    else:
        b.seg_id = 0

    # skip_mode
    if (
        (seg is None or (seg.globalmv == 0 and seg.ref == -1 and seg.skip == 0))
        and frame_hdr.skip_mode.enabled
        and min(bw4, bh4) > 1
    ):
        smctx = ts.a.skip_mode[t.bx] + t.l.skip_mode[by4]
        b.skip_mode = msac.decode_bool_adapt(cdf.m.skip_mode[smctx])
        trace(f"Post-skipmode[{b.skip_mode}]: r={msac.rng}")
    else:
        b.skip_mode = 0

    # skip
    if b.skip_mode or (seg is not None and seg.skip):
        b.skip = 1
    else:
        sctx = ts.a.skip[t.bx] + t.l.skip[by4]
        b.skip = msac.decode_bool_adapt(cdf.m.skip[sctx])
        trace(f"Post-skip[{b.skip}]: r={msac.rng}")

    # segment_id (postskip)
    if (
        frame_hdr.segmentation.enabled
        and frame_hdr.segmentation.update_map
        and not frame_hdr.segmentation.seg_data.preskip
    ):
        if not b.skip and frame_hdr.segmentation.temporal:
            index = ts.a.seg_pred[t.bx] + t.l.seg_pred[by4]
            seg_pred = bool(msac.decode_bool_adapt(cdf.m.seg_pred[index]))
        else:
            seg_pred = False
        if not b.skip and frame_hdr.segmentation.temporal and seg_pred:
            if f.prev_segmap is not None:
                seg_id = get_prev_frame_segid(
                    frame_hdr, t.bx, t.by, w4, h4, f.prev_segmap
                )
                if seg_id >= 8:
                    raise DecodeError("bad prev segid")
                b.seg_id = seg_id
            else:
                b.seg_id = 0
        else:
            pred_seg_id, seg_ctx = get_cur_frame_segid_2d(
                t.bx, t.by, have_top, have_left, f.cur_segmap
            )
            if b.skip:
                b.seg_id = int(pred_seg_id)
            else:
                diff = msac.decode_symbol_adapt(cdf.m.seg_id[seg_ctx], 7)
                last_active_seg_id = frame_hdr.segmentation.seg_data.last_active_segid
                b.seg_id = neg_deinterleave(
                    diff, int(pred_seg_id), last_active_seg_id + 1
                ) & 0xFF  # reference casts to u8 before clamping
                if b.seg_id > last_active_seg_id:
                    b.seg_id = 0
            if b.seg_id >= 8:
                b.seg_id = 0
        seg = frame_hdr.segmentation.seg_data.d[b.seg_id]

    # cdef index (one per 64x64 unit; first non-skip block reads it)
    if not b.skip:
        f.noskip4[t.by : t.by + bh4, t.bx : t.bx + bw4] = 1
        uy, ux = t.by >> 4, t.bx >> 4
        if f.cdef_idx[uy, ux] == -1:
            v = msac.decode_bools(frame_hdr.cdef.n_bits)
            trace(f"Post-cdef_idx[{v}]: r={msac.rng}")
            f.cdef_idx[uy, ux] = v
            if bw4 > 16:
                f.cdef_idx[uy, ux + 1] = v
            if bh4 > 16:
                f.cdef_idx[uy + 1, ux] = v
            if bw4 == 32 and bh4 == 32:
                f.cdef_idx[uy + 1, ux + 1] = v

    # delta q/lf (at sb boundaries)
    not_sb128 = 0 if seq_hdr.sb128 else 1
    if (t.bx & (31 >> not_sb128)) == 0 and (t.by & (31 >> not_sb128)) == 0:
        prev_qidx = ts.last_qidx
        sb_bs = BS_128x128 if seq_hdr.sb128 else BS_64x64
        have_delta_q = frame_hdr.delta.q.present and (
            bs != sb_bs or not b.skip
        )
        prev_delta_lf = list(ts.last_delta_lf)
        if have_delta_q:
            delta_q = msac.decode_symbol_adapt(cdf.m.delta_q, 3)
            if delta_q == 3:
                n_bits = 1 + msac.decode_bools(3)
                delta_q = msac.decode_bools(n_bits) + 1 + (1 << n_bits)
            if delta_q:
                if msac.decode_bool_equi():
                    delta_q = -delta_q
                delta_q *= 1 << frame_hdr.delta.q.res_log2
            ts.last_qidx = iclip(ts.last_qidx + delta_q, 1, 255)
            trace(f"Post-delta_q[{delta_q}->{ts.last_qidx}]: r={msac.rng}")
            if frame_hdr.delta.lf.present:
                n_lfs = (
                    (4 if layout != PixelLayout.I400 else 2)
                    if frame_hdr.delta.lf.multi
                    else 1
                )
                for i in range(n_lfs):
                    idx = i + frame_hdr.delta.lf.multi
                    delta_lf = msac.decode_symbol_adapt(cdf.m.delta_lf[idx], 3)
                    if delta_lf == 3:
                        n_bits = 1 + msac.decode_bools(3)
                        delta_lf = msac.decode_bools(n_bits) + 1 + (1 << n_bits)
                    if delta_lf:
                        if msac.decode_bool_equi():
                            delta_lf = -delta_lf
                        delta_lf *= 1 << frame_hdr.delta.lf.res_log2
                    ts.last_delta_lf[i] = iclip(
                        ts.last_delta_lf[i] + delta_lf, -63, 63
                    )
                    trace(f"Post-delta_lf[{i}:{delta_lf}]: r={msac.rng}")
        if ts.last_qidx == frame_hdr.quant.yac:
            ts.dq = f.dq
        elif ts.last_qidx != prev_qidx:
            dqmem = [[[0, 0] for _ in range(3)] for _ in range(8)]
            init_quant_tables(seq_hdr, frame_hdr, ts.last_qidx, dqmem)
            ts.dq = dqmem
        if ts.last_delta_lf == [0, 0, 0, 0]:
            ts.lflvl = f.lf_lvl
        elif ts.last_delta_lf != prev_delta_lf:
            from ..recon.lf_mask import calc_lf_values

            ts.lflvl = calc_lf_values(frame_hdr, ts.last_delta_lf)

    # intra flag
    if b.skip_mode:
        b.intra = 0
    elif frame_type.is_inter_or_switch:
        if seg is not None and (seg.ref >= 0 or seg.globalmv):
            b.intra = 1 if seg.ref == 0 else 0
        else:
            ictx = get_intra_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
            b.intra = 0 if msac.decode_bool_adapt(cdf.m.intra[ictx]) else 1
    elif frame_hdr.allow_intrabc:
        b.intra = 0 if msac.decode_bool_adapt(cdf.m.intrabc) else 1
        trace(f"Post-intrabcflag[{b.intra}]: r={msac.rng}")
    else:
        b.intra = 1

    if b.intra:
        if frame_type.is_inter_or_switch:
            ymode_cdf = cdf.m.y_mode[YMODE_SIZE_CONTEXT[bs]]
        else:
            ymode_cdf = cdf.kfym[INTRA_MODE_CONTEXT[ts.a.mode[t.bx]]][
                INTRA_MODE_CONTEXT[t.l.mode[by4]]
            ]
        b.y_mode = msac.decode_symbol_adapt(ymode_cdf, N_INTRA_PRED_MODES - 1)
        trace(f"Post-ymode[{b.y_mode}]: r={msac.rng}")

        if (
            b_dim[2] + b_dim[3] >= 2
            and VERT_PRED <= b.y_mode <= VERT_LEFT_PRED
        ):
            acdf = cdf.m.angle_delta[b.y_mode - VERT_PRED]
            angle = msac.decode_symbol_adapt(acdf, 6)
            b.y_angle = angle - 3
        else:
            b.y_angle = 0

        if has_chroma:
            cfl_allowed = (
                (cbw4 == 1 and cbh4 == 1)
                if frame_hdr.segmentation.lossless[b.seg_id]
                else bool(CFL_ALLOWED_MASK & (1 << bs))
            )
            uvmode_cdf = cdf.m.uv_mode[1 if cfl_allowed else 0][b.y_mode]
            b.uv_mode = msac.decode_symbol_adapt(
                uvmode_cdf, N_UV_INTRA_PRED_MODES - 1 - (0 if cfl_allowed else 1)
            )
            trace(f"Post-uvmode[{b.uv_mode}]: r={msac.rng}")
            b.uv_angle = 0
            if b.uv_mode == CFL_PRED:
                sign = msac.decode_symbol_adapt(cdf.m.cfl_sign, 7) + 1
                sign_u = (sign * 0x56) >> 8
                sign_v = sign - sign_u * 3
                if sign_u:
                    ctx = (1 if sign_u == 2 else 0) * 3 + sign_v
                    b.cfl_alpha[0] = (
                        msac.decode_symbol_adapt(cdf.m.cfl_alpha[ctx], 15) + 1
                    )
                    if sign_u == 1:
                        b.cfl_alpha[0] = -b.cfl_alpha[0]
                else:
                    b.cfl_alpha[0] = 0
                if sign_v:
                    ctx = (1 if sign_v == 2 else 0) * 3 + sign_u
                    b.cfl_alpha[1] = (
                        msac.decode_symbol_adapt(cdf.m.cfl_alpha[ctx], 15) + 1
                    )
                    if sign_v == 1:
                        b.cfl_alpha[1] = -b.cfl_alpha[1]
                else:
                    b.cfl_alpha[1] = 0
                trace(f"Post-uvalphas[{b.cfl_alpha[0]}/{b.cfl_alpha[1]}]: r={msac.rng}")
            elif (
                b_dim[2] + b_dim[3] >= 2
                and VERT_PRED <= b.uv_mode <= VERT_LEFT_PRED
            ):
                acdf = cdf.m.angle_delta[b.uv_mode - VERT_PRED]
                angle = msac.decode_symbol_adapt(acdf, 6)
                b.uv_angle = angle - 3

        b.pal_sz = [0, 0]
        if (
            frame_hdr.allow_screen_content_tools
            and max(bw4, bh4) <= 16
            and bw4 + bh4 >= 4
        ):
            sz_ctx = b_dim[2] + b_dim[3] - 2
            if b.y_mode == DC_PRED:
                pal_ctx = (1 if ts.a.pal_sz[t.bx] > 0 else 0) + (
                    1 if t.l.pal_sz[by4] > 0 else 0
                )
                use_y_pal = msac.decode_bool_adapt(cdf.m.pal_y[sz_ctx][pal_ctx])
                if use_y_pal:
                    _read_pal_plane(t, f, ts, b, False, sz_ctx, bx4, by4)
            if has_chroma and b.uv_mode == DC_PRED:
                pal_ctx = 1 if b.pal_sz[0] > 0 else 0
                use_uv_pal = msac.decode_bool_adapt(cdf.m.pal_uv[pal_ctx])
                if use_uv_pal:
                    _read_pal_uv(t, f, ts, b, sz_ctx, bx4, by4)

        if (
            b.y_mode == DC_PRED
            and b.pal_sz[0] == 0
            and max(b_dim[2], b_dim[3]) <= 3
            and seq_hdr.filter_intra
        ):
            is_filter = msac.decode_bool_adapt(cdf.m.use_filter_intra[bs])
            if is_filter:
                b.y_mode = FILTER_PRED
                b.y_angle = msac.decode_symbol_adapt(cdf.m.filter_intra, 4)
            trace(f"Post-filterintramode[{b.y_mode}/{b.y_angle}]: r={msac.rng}")

        if b.pal_sz[0]:
            _read_pal_indices(
                t, ts, t.pal_idx, b, False, w4, h4, bw4, bh4
            )
        if has_chroma and b.pal_sz[1]:
            _read_pal_indices(
                t,
                ts,
                t.pal_idx[bw4 * bh4 * 16 :],
                b,
                True,
                cw4,
                ch4,
                cbw4,
                cbh4,
            )

        if frame_hdr.segmentation.lossless[b.seg_id]:
            b.uvtx = TX_4X4
            b.tx = b.uvtx
            t_dim = TXFM_DIMENSIONS[TX_4X4]
        else:
            b.tx = MAX_TXFM_SIZE_FOR_BS[bs][0]
            b.uvtx = MAX_TXFM_SIZE_FOR_BS[bs][int(layout)]
            t_dim = TXFM_DIMENSIONS[b.tx]
            if frame_hdr.txfm_mode == TxfmMode.SWITCHABLE and t_dim.max > TX_4X4:
                tctx = get_tx_ctx(ts.a, t.l, t_dim, by4, t.bx)
                tx_cdf = cdf.m.txsz[t_dim.max - 1][tctx]
                depth = msac.decode_symbol_adapt(tx_cdf, min(t_dim.max, 2))
                for _ in range(depth):
                    b.tx = t_dim.sub
                    t_dim = TXFM_DIMENSIONS[b.tx]
            trace(f"Post-tx[{b.tx}]: r={msac.rng}")

        # pass 1: coefficient decode now; dense work queued as a work item
        # (two-pass split, rav1d frame-thread analog)
        from ..recon.intra import _sm_flag, _sm_uv_flag
        from ..recon.store import WorkItem

        wi = WorkItem("intra", t, ts, bs, b)
        wi.intra_edge_flags = intra_edge_flags
        wi.sm_fl = _sm_flag(ts.a, t.bx) | _sm_flag(t.l, by4)
        wi.sm_uv_fl = _sm_uv_flag(ts.a, t.bx >> ss_hor) | _sm_uv_flag(t.l, cby4)
        if b.pal_sz[0] or b.pal_sz[1]:
            wi.pal = [np.array(pp, copy=True) for pp in t.pal]
            wi.pal_idx = t.pal_idx.copy()
        wi.tx_pos = f.coef_store.tx_pos
        wi.cf_pos = f.coef_store.cf_pos
        f.work_items.append(wi)
        recon_b_intra(t, f, ts, bs, intra_edge_flags, b, phase="read")

        if frame_hdr.loopfilter.level_y != [0, 0]:
            from ..recon.lf import record_lf_intra

            record_lf_intra(f, ts, t, b, bs, has_chroma)

        y_mode_nofilt = DC_PRED if b.y_mode == FILTER_PRED else b.y_mode
        for i in range(bw4):
            x = t.bx + i
            ts.a.tx_intra[x] = t_dim.lw
            ts.a.tx[x] = t_dim.lw
            ts.a.mode[x] = y_mode_nofilt
            ts.a.pal_sz[x] = b.pal_sz[0]
            ts.a.seg_pred[x] = 1 if seg_pred else 0
            ts.a.skip_mode[x] = 0
            ts.a.intra[x] = 1
            ts.a.skip[x] = b.skip
            t.pal_sz_uv[0][(t.bx + i) & 31] = b.pal_sz[1] if has_chroma else 0
            if frame_type.is_inter_or_switch:
                ts.a.comp_type[x] = 0
                ts.a.ref[0][x] = -1
                ts.a.ref[1][x] = -1
                ts.a.filter[0][x] = N_SWITCHABLE_FILTERS
                ts.a.filter[1][x] = N_SWITCHABLE_FILTERS
        for i in range(bh4):
            y = (by4 + i) & 31
            t.l.tx_intra[y] = t_dim.lh
            t.l.tx[y] = t_dim.lh
            t.l.mode[y] = y_mode_nofilt
            t.l.pal_sz[y] = b.pal_sz[0]
            t.l.seg_pred[y] = 1 if seg_pred else 0
            t.l.skip_mode[y] = 0
            t.l.intra[y] = 1
            t.l.skip[y] = b.skip
            t.pal_sz_uv[1][y] = b.pal_sz[1] if has_chroma else 0
            if frame_type.is_inter_or_switch:
                t.l.comp_type[y] = 0
                t.l.ref[0][y] = -1
                t.l.ref[1][y] = -1
                t.l.filter[0][y] = N_SWITCHABLE_FILTERS
                t.l.filter[1][y] = N_SWITCHABLE_FILTERS
        if b.pal_sz[0]:
            # copy y palette into al_pal for both dirs
            for i in range(bw4):
                t.al_pal[0][(bx4 + i)][0][:] = t.pal[0]
            for i in range(bh4):
                t.al_pal[1][(by4 + i)][0][:] = t.pal[0]
        if has_chroma:
            cbx_abs = t.bx >> ss_hor
            for i in range(cbw4):
                ts.a.uvmode[cbx_abs + i] = b.uv_mode
            for i in range(cbh4):
                t.l.uvmode[(cby4 + i) & 31] = b.uv_mode
            if b.pal_sz[1]:
                for i in range(bw4):
                    t.al_pal[0][bx4 + i][1][:] = t.pal[1]
                    t.al_pal[0][bx4 + i][2][:] = t.pal[2]
                for i in range(bh4):
                    t.al_pal[1][by4 + i][1][:] = t.pal[1]
                    t.al_pal[1][by4 + i][2][:] = t.pal[2]
        if frame_type.is_inter_or_switch or frame_hdr.allow_intrabc:
            # splat_intraref (decode.rs:963)
            refmvs.splat_mv(
                f.rf, t.by, t.bx, bw4, bh4,
                refmvs.INVALID_MV, (0, 0), 0, -1, bs, 0,
            )
    elif frame_type.is_key_or_intra:
        # intra block copy (decode.rs:1989)
        mvstack, n_mvs, _ctx = refmvs.refmvs_find(
            t.rt, f.rf, (0, -1), bs, intra_edge_flags, t.by, t.bx, frame_hdr
        )
        if tuple(mvstack[0].mv[0]) != (0, 0):
            b.mv[0] = list(mvstack[0].mv[0])
        elif tuple(mvstack[1].mv[0]) != (0, 0):
            b.mv[0] = list(mvstack[1].mv[0])
        elif t.by - (16 << seq_hdr.sb128) < ts.row_start:
            b.mv[0] = [-(512 << seq_hdr.sb128) - 2048, 0]
        else:
            b.mv[0] = [0, -(512 << seq_hdr.sb128)]

        ref_mv = list(b.mv[0])
        read_mv_residual(ts, b.mv[0], ts.cdf.dmv, False)

        # clip intrabc mv to decoded parts of the current tile
        border_left = ts.col_start * 4
        border_top = ts.row_start * 4
        if has_chroma:
            if bw4 < 2 and ss_hor:
                border_left += 4
            if bh4 < 2 and ss_ver:
                border_top += 4
        src_left = t.bx * 4 + (b.mv[0][0] >> 3)
        src_top = t.by * 4 + (b.mv[0][1] >> 3)
        src_right = src_left + bw4 * 4
        src_bottom = src_top + bh4 * 4
        border_right = ((ts.col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4

        if src_left < border_left:
            src_right += border_left - src_left
            src_left = border_left
        elif src_right > border_right:
            src_left -= src_right - border_right
            src_right = border_right
        if src_top < border_top:
            src_bottom += border_top - src_top
            src_top = border_top

        sbx = (t.bx >> (4 + seq_hdr.sb128)) << (6 + seq_hdr.sb128)
        sby = (t.by >> (4 + seq_hdr.sb128)) << (6 + seq_hdr.sb128)
        sb_size = 1 << (6 + seq_hdr.sb128)
        if src_bottom > sby and src_right > sbx:
            if src_top - border_top >= src_bottom - sby:
                src_top -= src_bottom - sby
                src_bottom = sby
            elif src_left - border_left >= src_right - sbx:
                src_left -= src_right - sbx
                src_right = sbx
        if src_bottom > sby + sb_size:
            src_top -= src_bottom - (sby + sb_size)
            src_bottom = sby + sb_size
        if src_bottom > sby and src_right > sbx:
            raise DecodeError("intrabc mv overlaps current superblock")

        b.mv[0] = [(src_left - t.bx * 4) * 8, (src_top - t.by * 4) * 8]
        trace(
            f"Post-dmv[{b.mv[0][1]}/{b.mv[0][0]},ref={ref_mv[1]}/{ref_mv[0]}|"
            f"{mvstack[0].mv[0][1]}/{mvstack[0].mv[0][0]}]: r={ts.msac.rng}"
        )
        read_vartx_tree(t, f, ts, b, bs, bx4, by4)
        b.filter2d = FILTER_2D_BILINEAR
        _snapshot_inter_item(t, f, ts, bs, b, bw4, bh4, by4)
        recon_b_inter(t, f, ts, bs, b, phase="read")

        # splat_intrabc_mv (decode.rs:919)
        refmvs.splat_mv(
            f.rf, t.by, t.bx, bw4, bh4, tuple(b.mv[0]), (0, 0), 0, -1, bs, 0
        )

        for i in range(bw4):
            x = t.bx + i
            ts.a.tx_intra[x] = b_dim[2]
            ts.a.mode[x] = DC_PRED
            ts.a.pal_sz[x] = 0
            t.pal_sz_uv[0][x & 31] = 0
            ts.a.seg_pred[x] = 1 if seg_pred else 0
            ts.a.skip_mode[x] = 0
            ts.a.intra[x] = 0
            ts.a.skip[x] = b.skip
        for i in range(bh4):
            y = (by4 + i) & 31
            t.l.tx_intra[y] = b_dim[3]
            t.l.mode[y] = DC_PRED
            t.l.pal_sz[y] = 0
            t.pal_sz_uv[1][y] = 0
            t.l.seg_pred[y] = 1 if seg_pred else 0
            t.l.skip_mode[y] = 0
            t.l.intra[y] = 0
            t.l.skip[y] = b.skip
        if has_chroma:
            cbx_abs = t.bx >> ss_hor
            for i in range(cbw4):
                ts.a.uvmode[cbx_abs + i] = DC_PRED
            for i in range(cbh4):
                t.l.uvmode[(cby4 + i) & 31] = DC_PRED
    else:
        # inter-specific mode/mv coding (decode.rs:2133)
        has_subpel_filter = False

        if b.skip_mode:
            is_comp = True
        elif (
            (seg is None or (seg.ref == -1 and seg.globalmv == 0 and seg.skip == 0))
            and frame_hdr.switchable_comp_refs
            and min(bw4, bh4) > 1
        ):
            cctx = get_comp_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
            is_comp = bool(msac.decode_bool_adapt(cdf.m.comp[cctx]))
            trace(f"Post-compflag[{1 if is_comp else 0}]: r={msac.rng}")
        else:
            is_comp = False

        if b.skip_mode:
            b.ref = [frame_hdr.skip_mode.refs[0], frame_hdr.skip_mode.refs[1]]
            b.comp_type = COMP_INTER_AVG
            b.inter_mode = NEARESTMV_NEARESTMV
            b.drl_idx = DRL_NEAREST
            has_subpel_filter = False

            mvstack, n_mvs, _ctx = refmvs.refmvs_find(
                t.rt, f.rf, (b.ref[0] + 1, b.ref[1] + 1), bs, intra_edge_flags,
                t.by, t.bx, frame_hdr,
            )
            b.mv[0] = list(mvstack[0].mv[0])
            b.mv[1] = list(mvstack[0].mv[1])
            b.mv[0] = list(fix_mv_precision(frame_hdr, b.mv[0][0], b.mv[0][1]))
            b.mv[1] = list(fix_mv_precision(frame_hdr, b.mv[1][0], b.mv[1][1]))
            trace(
                f"Post-skipmodeblock[mv=1:y={b.mv[0][1]},x={b.mv[0][0]},"
                f"2:y={b.mv[1][1]},x={b.mv[1][0]},refs={b.ref[0]}+{b.ref[1]}"
            )
        elif is_comp:
            dir_ctx = get_comp_dir_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
            if msac.decode_bool_adapt(cdf.m.comp_dir[dir_ctx]):
                # bidir - first reference (fw)
                ctx1 = av1_get_fwd_ref_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
                if msac.decode_bool_adapt(cdf.m.comp_fwd_ref[0][ctx1]):
                    ctx2 = av1_get_fwd_ref_2_ctx(
                        ts.a, t.l, by4, t.bx, have_top, have_left
                    )
                    b.ref[0] = 2 + msac.decode_bool_adapt(cdf.m.comp_fwd_ref[2][ctx2])
                else:
                    ctx2 = av1_get_fwd_ref_1_ctx(
                        ts.a, t.l, by4, t.bx, have_top, have_left
                    )
                    b.ref[0] = msac.decode_bool_adapt(cdf.m.comp_fwd_ref[1][ctx2])
                # second reference (bw)
                ctx3 = av1_get_bwd_ref_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
                if msac.decode_bool_adapt(cdf.m.comp_bwd_ref[0][ctx3]):
                    b.ref[1] = 6
                else:
                    ctx4 = av1_get_bwd_ref_1_ctx(
                        ts.a, t.l, by4, t.bx, have_top, have_left
                    )
                    b.ref[1] = 4 + msac.decode_bool_adapt(cdf.m.comp_bwd_ref[1][ctx4])
            else:
                # unidir
                uctx_p = av1_get_ref_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
                if msac.decode_bool_adapt(cdf.m.comp_uni_ref[0][uctx_p]):
                    b.ref = [4, 6]
                else:
                    uctx_p1 = av1_get_uni_p1_ctx(
                        ts.a, t.l, by4, t.bx, have_top, have_left
                    )
                    b.ref = [0, 1 + msac.decode_bool_adapt(cdf.m.comp_uni_ref[1][uctx_p1])]
                    if b.ref[1] == 2:
                        uctx_p2 = av1_get_fwd_ref_2_ctx(
                            ts.a, t.l, by4, t.bx, have_top, have_left
                        )
                        b.ref[1] += msac.decode_bool_adapt(cdf.m.comp_uni_ref[2][uctx_p2])
            trace(f"Post-refs[{b.ref[0]}/{b.ref[1]}]: r={msac.rng}")

            mvstack, n_mvs, mctx = refmvs.refmvs_find(
                t.rt, f.rf, (b.ref[0] + 1, b.ref[1] + 1), bs, intra_edge_flags,
                t.by, t.bx, frame_hdr,
            )
            b.inter_mode = msac.decode_symbol_adapt(
                cdf.m.comp_inter_mode[mctx], N_COMP_INTER_PRED_MODES - 1
            )
            trace(
                f"Post-compintermode[{b.inter_mode},ctx={mctx},n_mvs={n_mvs}]:"
                f" r={msac.rng}"
            )

            im = COMP_INTER_PRED_MODES[b.inter_mode]
            b.drl_idx = DRL_NEAREST
            if b.inter_mode == NEWMV_NEWMV:
                if n_mvs > 1:
                    drl_ctx_v1 = get_drl_context(mvstack, 0)
                    if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v1]):
                        b.drl_idx = DRL_NEARER
                        if n_mvs > 2:
                            drl_ctx_v2 = get_drl_context(mvstack, 1)
                            if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v2]):
                                b.drl_idx = DRL_NEAR
                    trace(
                        f"Post-drlidx[{b.drl_idx},n_mvs={n_mvs}]: r={msac.rng}"
                    )
            elif im[0] == NEARMV or im[1] == NEARMV:
                b.drl_idx = DRL_NEARER
                if n_mvs > 2:
                    drl_ctx_v2 = get_drl_context(mvstack, 1)
                    if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v2]):
                        b.drl_idx = DRL_NEAR
                        if n_mvs > 3:
                            drl_ctx_v3 = get_drl_context(mvstack, 2)
                            if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v3]):
                                b.drl_idx = DRL_NEARISH
                    trace(
                        f"Post-drlidx[{b.drl_idx},n_mvs={n_mvs}]: r={msac.rng}"
                    )

            has_subpel_filter = min(bw4, bh4) == 1 or b.inter_mode != GLOBALMV_GLOBALMV
            for idx in range(2):
                if im[idx] in (NEARMV, NEARESTMV):
                    mv = list(mvstack[b.drl_idx].mv[idx])
                    b.mv[idx] = list(fix_mv_precision(frame_hdr, mv[0], mv[1]))
                elif im[idx] == GLOBALMV:
                    has_subpel_filter |= (
                        frame_hdr.gmv[b.ref[idx]].type == WarpedMotionType.TRANSLATION
                    )
                    b.mv[idx] = list(
                        get_gmv_2d(frame_hdr.gmv[b.ref[idx]], t.bx, t.by, bw4, bh4, frame_hdr)
                    )
                elif im[idx] == NEWMV:
                    b.mv[idx] = list(mvstack[b.drl_idx].mv[idx])
                    read_mv_residual(
                        ts, b.mv[idx], ts.cdf.mv, not frame_hdr.force_integer_mv
                    )
            trace(
                f"Post-residual_mv[1:y={b.mv[0][1]},x={b.mv[0][0]},"
                f"2:y={b.mv[1][1]},x={b.mv[1][0]}]: r={msac.rng}"
            )

            # jnt_comp vs. seg vs. wedge
            is_segwedge = False
            if seq_hdr.masked_compound:
                mask_ctx = get_mask_comp_ctx(ts.a, t.l, by4, t.bx)
                is_segwedge = bool(msac.decode_bool_adapt(cdf.m.mask_comp[mask_ctx]))
                trace(
                    f"Post-segwedge_vs_jntavg[{1 if is_segwedge else 0},"
                    f"ctx={mask_ctx}]: r={msac.rng}"
                )

            if not is_segwedge:
                if seq_hdr.jnt_comp:
                    ref0poc = f.refp[b.ref[0]].frame_hdr.frame_offset
                    ref1poc = f.refp[b.ref[1]].frame_hdr.frame_offset
                    jnt_ctx = get_jnt_comp_ctx(
                        seq_hdr.order_hint_n_bits,
                        frame_hdr.frame_offset,
                        ref0poc,
                        ref1poc,
                        ts.a,
                        t.l,
                        by4,
                        t.bx,
                    )
                    b.comp_type = COMP_INTER_WEIGHTED_AVG + msac.decode_bool_adapt(
                        cdf.m.jnt_comp[jnt_ctx]
                    )
                    trace(
                        f"Post-jnt_comp[{1 if b.comp_type == COMP_INTER_AVG else 0},"
                        f"ctx={jnt_ctx}[ac:{ts.a.comp_type[t.bx]},"
                        f"ar:{ts.a.ref[0][t.bx]},lc:{t.l.comp_type[by4]},"
                        f"lr:{t.l.ref[0][by4]}]]: r={msac.rng}"
                    )
                else:
                    b.comp_type = COMP_INTER_AVG
            else:
                if WEDGE_ALLOWED_MASK & (1 << bs):
                    wctx = WEDGE_CTX_LUT[bs]
                    b.comp_type = COMP_INTER_WEDGE - msac.decode_bool_adapt(
                        cdf.m.wedge_comp[wctx]
                    )
                    if b.comp_type == COMP_INTER_WEDGE:
                        b.wedge_idx = msac.decode_symbol_adapt(cdf.m.wedge_idx[wctx], 15)
                else:
                    b.comp_type = COMP_INTER_SEG
                b.mask_sign = msac.decode_bool_equi()
                trace(
                    f"Post-seg/wedge[{1 if b.comp_type == COMP_INTER_WEDGE else 0},"
                    f"wedge_idx={b.wedge_idx},sign={b.mask_sign}]: r={msac.rng}"
                )
        else:
            b.comp_type = COMP_INTER_NONE

            # ref
            if seg is not None and seg.ref > 0:
                b.ref[0] = seg.ref - 1
            elif seg is not None and (seg.globalmv or seg.skip):
                b.ref[0] = 0
            else:
                ctx1 = av1_get_ref_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
                if msac.decode_bool_adapt(cdf.m.ref[0][ctx1]):
                    ctx2 = av1_get_bwd_ref_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
                    if msac.decode_bool_adapt(cdf.m.ref[1][ctx2]):
                        b.ref[0] = 6
                    else:
                        ctx3 = av1_get_bwd_ref_1_ctx(
                            ts.a, t.l, by4, t.bx, have_top, have_left
                        )
                        b.ref[0] = 4 + msac.decode_bool_adapt(cdf.m.ref[5][ctx3])
                else:
                    ctx2 = av1_get_fwd_ref_ctx(ts.a, t.l, by4, t.bx, have_top, have_left)
                    if msac.decode_bool_adapt(cdf.m.ref[2][ctx2]):
                        ctx3 = av1_get_fwd_ref_2_ctx(
                            ts.a, t.l, by4, t.bx, have_top, have_left
                        )
                        b.ref[0] = 2 + msac.decode_bool_adapt(cdf.m.ref[4][ctx3])
                    else:
                        ctx3 = av1_get_fwd_ref_1_ctx(
                            ts.a, t.l, by4, t.bx, have_top, have_left
                        )
                        b.ref[0] = msac.decode_bool_adapt(cdf.m.ref[3][ctx3])
                trace(f"Post-ref[{b.ref[0]}]: r={msac.rng}")
            b.ref[1] = -1

            mvstack, n_mvs, mctx = refmvs.refmvs_find(
                t.rt, f.rf, (b.ref[0] + 1, -1), bs, intra_edge_flags,
                t.by, t.bx, frame_hdr,
            )

            # mode parsing and mv derivation from ref_mvs
            seg_skip_gmv = seg is not None and (seg.skip or seg.globalmv)
            if seg_skip_gmv or msac.decode_bool_adapt(cdf.m.newmv_mode[mctx & 7]):
                if seg_skip_gmv or not msac.decode_bool_adapt(
                    cdf.m.globalmv_mode[(mctx >> 3) & 1]
                ):
                    b.inter_mode = GLOBALMV
                    b.mv[0] = list(
                        get_gmv_2d(frame_hdr.gmv[b.ref[0]], t.bx, t.by, bw4, bh4, frame_hdr)
                    )
                    has_subpel_filter = (
                        min(bw4, bh4) == 1
                        or frame_hdr.gmv[b.ref[0]].type == WarpedMotionType.TRANSLATION
                    )
                else:
                    has_subpel_filter = True
                    if msac.decode_bool_adapt(cdf.m.refmv_mode[(mctx >> 4) & 15]):
                        b.inter_mode = NEARMV
                        b.drl_idx = DRL_NEARER
                        if n_mvs > 2:
                            drl_ctx_v2 = get_drl_context(mvstack, 1)
                            if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v2]):
                                b.drl_idx = DRL_NEAR
                                if n_mvs > 3:
                                    drl_ctx_v3 = get_drl_context(mvstack, 2)
                                    if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v3]):
                                        b.drl_idx = DRL_NEARISH
                    else:
                        b.inter_mode = NEARESTMV
                        b.drl_idx = DRL_NEAREST
                    b.mv[0] = list(mvstack[b.drl_idx].mv[0])
                    if b.drl_idx < DRL_NEAR:
                        b.mv[0] = list(
                            fix_mv_precision(frame_hdr, b.mv[0][0], b.mv[0][1])
                        )
                trace(
                    f"Post-intermode[{b.inter_mode},drl={b.drl_idx},"
                    f"mv=y:{b.mv[0][1]},x:{b.mv[0][0]},n_mvs={n_mvs}]: r={msac.rng}"
                )
            else:
                has_subpel_filter = True
                b.inter_mode = NEWMV
                b.drl_idx = DRL_NEAREST
                if n_mvs > 1:
                    drl_ctx_v1 = get_drl_context(mvstack, 0)
                    if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v1]):
                        b.drl_idx = DRL_NEARER
                        if n_mvs > 2:
                            drl_ctx_v2 = get_drl_context(mvstack, 1)
                            if msac.decode_bool_adapt(cdf.m.drl_bit[drl_ctx_v2]):
                                b.drl_idx = DRL_NEAR
                if n_mvs > 1:
                    b.mv[0] = list(mvstack[b.drl_idx].mv[0])
                else:
                    assert b.drl_idx == DRL_NEAREST
                    mv = list(mvstack[0].mv[0])
                    b.mv[0] = list(fix_mv_precision(frame_hdr, mv[0], mv[1]))
                trace(f"Post-intermode[{b.inter_mode},drl={b.drl_idx}]: r={msac.rng}")
                read_mv_residual(
                    ts, b.mv[0], ts.cdf.mv, not frame_hdr.force_integer_mv
                )
                trace(
                    f"Post-residualmv[mv=y:{b.mv[0][1]},x:{b.mv[0][0]}]: r={msac.rng}"
                )

            # interintra flags
            ii_sz_grp = YMODE_SIZE_CONTEXT[bs]
            if (
                seq_hdr.inter_intra
                and INTERINTRA_ALLOWED_MASK & (1 << bs)
                and msac.decode_bool_adapt(cdf.m.interintra[ii_sz_grp])
            ):
                b.interintra_mode = msac.decode_symbol_adapt(
                    cdf.m.interintra_mode[ii_sz_grp], 3
                )
                wedge_ctx = WEDGE_CTX_LUT[bs]
                b.interintra_type = INTER_INTRA_BLEND + msac.decode_bool_adapt(
                    cdf.m.interintra_wedge[wedge_ctx]
                )
                if b.interintra_type == INTER_INTRA_WEDGE:
                    b.wedge_idx = msac.decode_symbol_adapt(cdf.m.wedge_idx[wedge_ctx], 15)
            else:
                b.interintra_type = INTER_INTRA_NONE
            if seq_hdr.inter_intra and INTERINTRA_ALLOWED_MASK & (1 << bs):
                trace(
                    f"Post-interintra[t={b.interintra_type},m={b.interintra_mode},"
                    f"w={b.wedge_idx}]: r={msac.rng}"
                )

            # motion variation
            if (
                frame_hdr.switchable_motion_mode
                and b.interintra_type == INTER_INTRA_NONE
                and min(bw4, bh4) >= 2
                and not (
                    not frame_hdr.force_integer_mv
                    and b.inter_mode == GLOBALMV
                    and frame_hdr.gmv[b.ref[0]].type > WarpedMotionType.TRANSLATION
                )
                and (
                    (have_left and _findoddzero([t.l.intra[(by4 + i) & 31] for i in range(h4)]))
                    or (have_top and _findoddzero([ts.a.intra[t.bx + i] for i in range(w4)]))
                )
            ):
                masks = find_matching_ref(
                    f, t, ts, intra_edge_flags, bw4, bh4, w4, h4,
                    have_left, have_top, b.ref[0],
                )
                allow_warp = (
                    f.svc[b.ref[0]][0]["scale"] == 0
                    and not frame_hdr.force_integer_mv
                    and frame_hdr.warp_motion
                    and (masks[0] | masks[1])
                )
                if allow_warp:
                    b.motion_mode = msac.decode_symbol_adapt(cdf.m.motion_mode[bs], 2)
                else:
                    b.motion_mode = msac.decode_bool_adapt(cdf.m.obmc[bs])
                if b.motion_mode == MM_WARP:
                    has_subpel_filter = False
                    derive_warpmv(
                        f.rf, t, bw4, bh4, masks, b.mv[0][0], b.mv[0][1], t.warpmv
                    )
                    if t.warpmv.type == WarpedMotionType.AFFINE:
                        b.matrix = [
                            t.warpmv.matrix[2] - 0x10000,
                            t.warpmv.matrix[3],
                            t.warpmv.matrix[4],
                            t.warpmv.matrix[5] - 0x10000,
                        ]
                    else:
                        b.matrix = [-32768, 0, 0, 0]
                trace(
                    f"Post-motionmode[{b.motion_mode}]: r={msac.rng}"
                    f" [mask: 0x{masks[0]:x}/0x{masks[1]:x}]"
                )
            else:
                b.motion_mode = MM_TRANSLATION

        # subpel filter
        if frame_hdr.subpel_filter_mode == FilterMode.SWITCHABLE:
            if has_subpel_filter:
                comp = b.comp_type != COMP_INTER_NONE
                ctx1 = get_filter_ctx(ts.a, t.l, comp, False, b.ref[0], by4, t.bx)
                filter0 = msac.decode_symbol_adapt(
                    cdf.m.filter[0][ctx1], N_SWITCHABLE_FILTERS - 1
                )
                if seq_hdr.dual_filter:
                    ctx2 = get_filter_ctx(ts.a, t.l, comp, True, b.ref[0], by4, t.bx)
                    trace(f"Post-subpel_filter1[{filter0},ctx={ctx1}]: r={msac.rng}")
                    filter1 = msac.decode_symbol_adapt(
                        cdf.m.filter[1][ctx2], N_SWITCHABLE_FILTERS - 1
                    )
                    trace(f"Post-subpel_filter2[{filter1},ctx={ctx2}]: r={msac.rng}")
                    filter_ = [filter0, filter1]
                else:
                    trace(f"Post-subpel_filter[{filter0},ctx={ctx1}]: r={msac.rng}")
                    filter_ = [filter0, filter0]
            else:
                filter_ = [FilterMode.REGULAR_8TAP, FilterMode.REGULAR_8TAP]
        else:
            filter_ = [int(frame_hdr.subpel_filter_mode)] * 2
        b.filter2d = FILTER_2D[filter_[1]][filter_[0]]

        read_vartx_tree(t, f, ts, b, bs, bx4, by4)
        _snapshot_inter_item(t, f, ts, bs, b, bw4, bh4, by4)
        recon_b_inter(t, f, ts, bs, b, phase="read")

        if frame_hdr.loopfilter.level_y != [0, 0]:
            from ..recon.lf import record_lf_inter

            record_lf_inter(f, ts, t, b, bs, is_comp, has_chroma)

        # context updates (splat_{one,two}ref_mv, decode.rs:892/941)
        if is_comp:
            mode = b.inter_mode
            mf = (1 if mode == GLOBALMV_GLOBALMV else 0) | (
                2 if ((1 << mode) & 0xBC) else 0
            )
            refmvs.splat_mv(
                f.rf, t.by, t.bx, bw4, bh4, tuple(b.mv[0]), tuple(b.mv[1]),
                b.ref[0] + 1, b.ref[1] + 1, bs, mf,
            )
        else:
            mode = b.inter_mode
            mf = (1 if (mode == GLOBALMV and min(bw4, bh4) >= 2) else 0) | (
                2 if mode == NEWMV else 0
            )
            ref1 = 0 if b.interintra_type != INTER_INTRA_NONE else -1
            refmvs.splat_mv(
                f.rf, t.by, t.bx, bw4, bh4, tuple(b.mv[0]), (0, 0),
                b.ref[0] + 1, ref1, bs, mf,
            )

        for i in range(bw4):
            x = t.bx + i
            ts.a.seg_pred[x] = 1 if seg_pred else 0
            ts.a.skip_mode[x] = b.skip_mode
            ts.a.intra[x] = 0
            ts.a.skip[x] = b.skip
            ts.a.pal_sz[x] = 0
            t.pal_sz_uv[0][x & 31] = 0
            ts.a.tx_intra[x] = b_dim[2]
            ts.a.comp_type[x] = b.comp_type
            ts.a.filter[0][x] = filter_[0]
            ts.a.filter[1][x] = filter_[1]
            ts.a.mode[x] = b.inter_mode
            ts.a.ref[0][x] = b.ref[0]
            ts.a.ref[1][x] = b.ref[1]
        for i in range(bh4):
            y = (by4 + i) & 31
            t.l.seg_pred[y] = 1 if seg_pred else 0
            t.l.skip_mode[y] = b.skip_mode
            t.l.intra[y] = 0
            t.l.skip[y] = b.skip
            t.l.pal_sz[y] = 0
            t.pal_sz_uv[1][y] = 0
            t.l.tx_intra[y] = b_dim[3]
            t.l.comp_type[y] = b.comp_type
            t.l.filter[0][y] = filter_[0]
            t.l.filter[1][y] = filter_[1]
            t.l.mode[y] = b.inter_mode
            t.l.ref[0][y] = b.ref[0]
            t.l.ref[1][y] = b.ref[1]
        if has_chroma:
            cbx_abs = t.bx >> ss_hor
            for i in range(cbw4):
                ts.a.uvmode[cbx_abs + i] = DC_PRED
            for i in range(cbh4):
                t.l.uvmode[(cby4 + i) & 31] = DC_PRED

    # update segmap
    if frame_hdr.segmentation.enabled and frame_hdr.segmentation.update_map:
        f.cur_segmap[t.by : t.by + bh4, t.bx : t.bx + bw4] = b.seg_id

    return b


def decode_sb(t, f, ts, bl, edge_node):
    """Recursive partition walk (src/decode.rs:3260)."""
    hsz = 16 >> bl
    have_h_split = f.bw > t.bx + hsz
    have_v_split = f.bh > t.by + hsz

    if not have_h_split and not have_v_split:
        assert bl < BL_8X8
        return decode_sb(t, f, ts, bl + 1, edge_node.split[0])

    msac = ts.msac
    bx8 = (t.bx & 31) >> 1
    by8 = (t.by & 31) >> 1
    ctx = get_partition_ctx_abs(ts.a, t.l, bl, by8, t.bx >> 1)
    pc = ts.cdf.m.partition[bl][ctx]

    if have_h_split and have_v_split:
        bp = msac.decode_symbol_adapt(pc, PARTITION_TYPE_COUNT[bl])
        trace(f"poc={f.frame_hdr.frame_offset},y={t.by},x={t.bx},bl={bl},ctx={ctx},bp={bp}: r={msac.rng}")
        if f.cur.layout == PixelLayout.I422 and bp in (
            PARTITION_V,
            PARTITION_V4,
            PARTITION_T_LEFT_SPLIT,
            PARTITION_T_RIGHT_SPLIT,
        ):
            raise DecodeError("vertical partition in 4:2:2")
        b0, b1 = BLOCK_SIZES[bl][bp]

        if bp == PARTITION_NONE:
            decode_b(t, f, ts, bl, b0, bp, edge_node.o)
        elif bp == PARTITION_H:
            decode_b(t, f, ts, bl, b0, bp, edge_node.h[0])
            t.by += hsz
            decode_b(t, f, ts, bl, b0, bp, edge_node.h[1])
            t.by -= hsz
        elif bp == PARTITION_V:
            decode_b(t, f, ts, bl, b0, bp, edge_node.v[0])
            t.bx += hsz
            decode_b(t, f, ts, bl, b0, bp, edge_node.v[1])
            t.bx -= hsz
        elif bp == PARTITION_SPLIT:
            if bl == BL_8X8:
                tip = edge_node
                assert hsz == 1
                decode_b(t, f, ts, bl, BS_4x4, bp, ie.ALL_TR_AND_BL)
                tl_filter = t.tl_4x4_filter
                t.bx += 1
                decode_b(t, f, ts, bl, BS_4x4, bp, tip.split[0])
                t.bx -= 1
                t.by += 1
                decode_b(t, f, ts, bl, BS_4x4, bp, tip.split[1])
                t.bx += 1
                t.tl_4x4_filter = tl_filter
                decode_b(t, f, ts, bl, BS_4x4, bp, tip.split[2])
                t.bx -= 1
                t.by -= 1
            else:
                branch = edge_node
                decode_sb(t, f, ts, bl + 1, branch.split[0])
                t.bx += hsz
                decode_sb(t, f, ts, bl + 1, branch.split[1])
                t.bx -= hsz
                t.by += hsz
                decode_sb(t, f, ts, bl + 1, branch.split[2])
                t.bx += hsz
                decode_sb(t, f, ts, bl + 1, branch.split[3])
                t.bx -= hsz
                t.by -= hsz
        elif bp == PARTITION_T_TOP_SPLIT:
            decode_b(t, f, ts, bl, b0, bp, ie.ALL_TR_AND_BL)
            t.bx += hsz
            decode_b(t, f, ts, bl, b0, bp, edge_node.v[1])
            t.bx -= hsz
            t.by += hsz
            decode_b(t, f, ts, bl, b1, bp, edge_node.h[1])
            t.by -= hsz
        elif bp == PARTITION_T_BOTTOM_SPLIT:
            decode_b(t, f, ts, bl, b0, bp, edge_node.h[0])
            t.by += hsz
            decode_b(t, f, ts, bl, b1, bp, edge_node.v[0])
            t.bx += hsz
            decode_b(t, f, ts, bl, b1, bp, 0)
            t.bx -= hsz
            t.by -= hsz
        elif bp == PARTITION_T_LEFT_SPLIT:
            decode_b(t, f, ts, bl, b0, bp, ie.ALL_TR_AND_BL)
            t.by += hsz
            decode_b(t, f, ts, bl, b0, bp, edge_node.h[1])
            t.by -= hsz
            t.bx += hsz
            decode_b(t, f, ts, bl, b1, bp, edge_node.v[1])
            t.bx -= hsz
        elif bp == PARTITION_T_RIGHT_SPLIT:
            decode_b(t, f, ts, bl, b0, bp, edge_node.v[0])
            t.bx += hsz
            decode_b(t, f, ts, bl, b1, bp, edge_node.h[0])
            t.by += hsz
            decode_b(t, f, ts, bl, b1, bp, 0)
            t.by -= hsz
            t.bx -= hsz
        elif bp == PARTITION_H4:
            branch = edge_node
            decode_b(t, f, ts, bl, b0, bp, branch.h[0])
            t.by += hsz >> 1
            decode_b(t, f, ts, bl, b0, bp, branch.h4)
            t.by += hsz >> 1
            decode_b(t, f, ts, bl, b0, bp, ie.ALL_LEFT_HAS_BOTTOM)
            t.by += hsz >> 1
            if t.by < f.bh:
                decode_b(t, f, ts, bl, b0, bp, branch.h[1])
            t.by -= (hsz * 3) >> 1
        elif bp == PARTITION_V4:
            branch = edge_node
            decode_b(t, f, ts, bl, b0, bp, branch.v[0])
            t.bx += hsz >> 1
            decode_b(t, f, ts, bl, b0, bp, branch.v4)
            t.bx += hsz >> 1
            decode_b(t, f, ts, bl, b0, bp, ie.ALL_TOP_HAS_RIGHT)
            t.bx += hsz >> 1
            if t.bx < f.bw:
                decode_b(t, f, ts, bl, b0, bp, branch.v[1])
            t.bx -= (hsz * 3) >> 1
    elif have_h_split:
        is_split = msac.decode_bool(gather_top_partition_prob(pc, bl))
        trace(f"poc={f.frame_hdr.frame_offset},y={t.by},x={t.bx},bl={bl},ctx={ctx},bp={3 if is_split else 1}: r={msac.rng}")
        assert bl < BL_8X8
        if is_split:
            bp = PARTITION_SPLIT
            decode_sb(t, f, ts, bl + 1, edge_node.split[0])
            t.bx += hsz
            decode_sb(t, f, ts, bl + 1, edge_node.split[1])
            t.bx -= hsz
        else:
            bp = PARTITION_H
            decode_b(t, f, ts, bl, BLOCK_SIZES[bl][PARTITION_H][0], bp, edge_node.h[0])
    else:
        assert have_v_split
        is_split = msac.decode_bool(gather_left_partition_prob(pc, bl))
        trace(f"poc={f.frame_hdr.frame_offset},y={t.by},x={t.bx},bl={bl},ctx={ctx},bp={3 if is_split else 2}: r={msac.rng}")
        if f.cur.layout == PixelLayout.I422 and not is_split:
            raise DecodeError("no vertical split in 4:2:2")
        assert bl < BL_8X8
        if is_split:
            bp = PARTITION_SPLIT
            decode_sb(t, f, ts, bl + 1, edge_node.split[0])
            t.by += hsz
            decode_sb(t, f, ts, bl + 1, edge_node.split[2])
            t.by -= hsz
        else:
            bp = PARTITION_V
            decode_b(t, f, ts, bl, BLOCK_SIZES[bl][PARTITION_V][0], bp, edge_node.v[0])

    if bp != PARTITION_SPLIT or bl == BL_8X8:
        val_a = AL_PART_CTX[0][bl][bp]
        val_l = AL_PART_CTX[1][bl][bp]
        for i in range(hsz):
            ts.a.partition[(t.bx >> 1) + i] = val_a
            t.l.partition[by8 + i] = val_l


def get_partition_ctx_abs(a, l, bl, yb8, xb8_abs):
    sh = 4 - bl
    return ((a.partition[xb8_abs] >> sh) & 1) + 2 * ((l.partition[yb8] >> sh) & 1)


def read_restoration_info(ts, lr, p, frame_type_r):
    """src/decode.rs:3749."""
    from ..headers import RestorationType
    from ..tables.spec_data import SGR_PARAMS

    msac = ts.msac
    lr_ref = ts.lr_ref[p]
    if frame_type_r == RestorationType.SWITCHABLE:
        filt = msac.decode_symbol_adapt(ts.cdf.m.restore_switchable, 2)
        lr.type = (
            RestorationType.NONE
            if filt == 0
            else (RestorationType.SGRPROJ if filt == 2 else RestorationType.WIENER)
        )
        if lr.type == RestorationType.SGRPROJ:
            lr.sgr_idx = 0
    else:
        bit = msac.decode_bool_adapt(
            ts.cdf.m.restore_wiener
            if frame_type_r == RestorationType.WIENER
            else ts.cdf.m.restore_sgrproj
        )
        lr.type = frame_type_r if bit else RestorationType.NONE

    def lr_subexp(ref, k, adjustment):
        return msac.decode_subexp(ref + adjustment, 8 << k, k) - adjustment

    if lr.type == RestorationType.WIENER:
        lr.filter_v = [
            0 if p else lr_subexp(lr_ref.filter_v[0], 1, 5),
            lr_subexp(lr_ref.filter_v[1], 2, 23),
            lr_subexp(lr_ref.filter_v[2], 3, 17),
        ]
        lr.filter_h = [
            0 if p else lr_subexp(lr_ref.filter_h[0], 1, 5),
            lr_subexp(lr_ref.filter_h[1], 2, 23),
            lr_subexp(lr_ref.filter_h[2], 3, 17),
        ]
        lr.sgr_weights = list(lr_ref.sgr_weights)
        ts.lr_ref[p] = lr.copy()
        trace(
            f"Post-lr_wiener[pl={p},v[{lr.filter_v[0]},{lr.filter_v[1]},{lr.filter_v[2]}],"
            f"h[{lr.filter_h[0]},{lr.filter_h[1]},{lr.filter_h[2]}]]: r={msac.rng}"
        )
    elif lr.type == RestorationType.SGRPROJ:
        sgr_idx = msac.decode_bools(4)
        lr.sgr_idx = sgr_idx
        s0, s1 = int(SGR_PARAMS[sgr_idx][0]), int(SGR_PARAMS[sgr_idx][1])
        lr.sgr_weights = [
            lr_subexp(lr_ref.sgr_weights[0], 4, 96) if s0 else 0,
            lr_subexp(lr_ref.sgr_weights[1], 4, 32) if s1 else 95,
        ]
        lr.filter_v = list(lr_ref.filter_v)
        lr.filter_h = list(lr_ref.filter_h)
        ts.lr_ref[p] = lr.copy()
        trace(
            f"Post-lr_sgrproj[pl={p},idx={sgr_idx},"
            f"w[{lr.sgr_weights[0]},{lr.sgr_weights[1]}]]: r={msac.rng}"
        )


def _read_sb_restoration(t, f, ts, sb_step):
    """Per-superblock restoration info reads (decode.rs:3957)."""
    from ..headers import PixelLayout as PL, RestorationType
    from ..recon.lr_apply import RestorationUnit, restore_planes_mask

    frame_hdr = f.frame_hdr
    restore_planes = restore_planes_mask(frame_hdr)
    if not restore_planes:
        return
    for p in range(3):
        if not ((restore_planes >> p) & 1):
            continue
        ss_ver = 1 if (p and f.cur.layout == PL.I420) else 0
        ss_hor = 1 if (p and f.cur.layout != PL.I444) else 0
        unit_size_log2 = frame_hdr.restoration.unit_size[1 if p else 0]
        y = (t.by * 4) >> ss_ver
        h = (f.cur.h + ss_ver) >> ss_ver
        unit_size = 1 << unit_size_log2
        mask = unit_size - 1
        if y & mask:
            continue
        half_unit = unit_size >> 1
        if y and y + half_unit > h:
            continue
        frame_type_r = frame_hdr.restoration.type[p]
        if frame_hdr.size.width[0] != frame_hdr.size.width[1]:
            # superres: LR units live in post-upscale coordinates
            w = (f.sr_cur.w + ss_hor) >> ss_hor
            n_units = max(1, (w + half_unit) >> unit_size_log2)
            d = frame_hdr.size.super_res.width_scale_denominator
            rnd = unit_size * 8 - 1
            shift = unit_size_log2 + 3
            x0 = (((4 * t.bx * d) >> ss_hor) + rnd) >> shift
            x1 = (((4 * (t.bx + sb_step) * d) >> ss_hor) + rnd) >> shift
            for x in range(x0, min(x1, n_units)):
                px_x = x << (unit_size_log2 + ss_hor)
                sb_idx = (t.by >> 5) * f.sr_sb128w + (px_x >> 7)
                unit_idx = ((t.by & 16) >> 3) + ((px_x & 64) >> 6)
                lr = f.lr_units.get((p, sb_idx, unit_idx))
                if lr is None:
                    lr = RestorationUnit()
                    f.lr_units[(p, sb_idx, unit_idx)] = lr
                read_restoration_info(ts, lr, p, frame_type_r)
            continue
        x = (4 * t.bx) >> ss_hor
        if x & mask:
            continue
        w = (f.cur.w + ss_hor) >> ss_hor
        if x and x + half_unit > w:
            continue
        sb_idx = (t.by >> 5) * f.sr_sb128w + (t.bx >> 5)
        unit_idx = ((t.by & 16) >> 3) + ((t.bx & 16) >> 4)
        lr = f.lr_units.get((p, sb_idx, unit_idx))
        if lr is None:
            lr = RestorationUnit()
            f.lr_units[(p, sb_idx, unit_idx)] = lr
        read_restoration_info(ts, lr, p, frame_type_r)


def decode_tile_sbrow(t, f, ts, sby):
    """Decode one superblock row of one tile (src/decode.rs:3853, intra)."""
    from .intra_edge import root

    sb128 = f.seq_hdr.sb128
    root_bl = BL_128X128 if sb128 else BL_64X64
    sb_step = f.sb_step
    tile_row = ts.tile_row

    t.by = sby << f.sb_shift
    frame_hdr = f.frame_hdr
    if frame_hdr.frame_type.is_inter_or_switch or frame_hdr.allow_intrabc:
        t.rt = refmvs.RefMvsTile(
            f.rf, ts.col_start, ts.col_end, ts.row_start, ts.row_end
        )
    reset_context(t.l, not frame_hdr.frame_type.is_inter_or_switch, 0)
    edge_root = root(bool(sb128))

    t.bx = ts.col_start
    while t.bx < ts.col_end:
        _read_sb_restoration(t, f, ts, sb_step)
        decode_sb(t, f, ts, root_bl, edge_root)
        t.bx += sb_step

    # backup t.l tx_lpf at the tile's right edge for the loopfilter's
    # tile-boundary strength fixup (decode.rs:4540)
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    off = t.by & 16
    f.tx_lpf_right_edge[0][ts.tile_col, t.by : t.by + sb_step] = t.l.tx_lpf_y[
        off : off + sb_step
    ]
    cstep = sb_step >> ss_ver
    f.tx_lpf_right_edge[1][
        ts.tile_col, (t.by >> ss_ver) : (t.by >> ss_ver) + cstep
    ] = t.l.tx_lpf_uv[(off >> ss_ver) : (off >> ss_ver) + cstep]
