"""Coefficient decoding: skip ctx, tx-type, eob, base/hi tokens, dequant.

Behavior parity: src/recon.rs decode_coefs (:478), get_skip_ctx (:252),
get_dc_sign_ctx (:318), get_lo_ctx (:449). This is the pass-1 hot sequential
loop; it fills the coefficient buffer in the dav1d "rc" layout (the scan
tables' position encoding) and returns (eob, txtp, cul_level_ctx).
"""

from __future__ import annotations

import numpy as np

from ..syntax.levels import (
    DCT_DCT,
    IDTX,
    WHT_WHT,
    FILTER_PRED,
    TX_4X4,
    TX_16X16,
    TX_32X32,
    TX_64X64,
    RTX_4X8,
    TX_CLASS_2D,
    TX_CLASS_H,
    TX_CLASS_V,
    TX_TYPE_CLASS,
)
from ..tables.block_tables import (
    BLOCK_DIMENSIONS,
    LO_CTX_OFFSETS,
    MAX_TXFM_SIZE_FOR_BS,
    SKIP_CTX,
    TXFM_DIMENSIONS,
    TXTP_FROM_UVMODE,
    TX_TYPES_PER_SET,
    FILTER_MODE_TO_Y_MODE,
)
from ..tables.spec_data import SCANS
from ..syntax.env import get_uv_inter_txtp


def get_skip_ctx(t_dim, bs, a, l, a_off, l_off, chroma, layout) -> int:
    """a/l are the lcoef/ccoef context lists; offsets are bx4/by4 indices."""
    b_dim = BLOCK_DIMENSIONS[bs]
    if chroma:
        ss_ver = layout == 1  # I420
        ss_hor = layout != 3  # not I444
        not_one_blk = (
            b_dim[2] - (1 if b_dim[2] and ss_hor else 0) > t_dim.lw
            or b_dim[3] - (1 if b_dim[3] and ss_ver else 0) > t_dim.lh
        )
        ca = any(a[a_off + i] != 0x40 for i in range(1 << t_dim.lw))
        cl = any(l[l_off + i] != 0x40 for i in range(1 << t_dim.lh))
        return 7 + (3 if not_one_blk else 0) + (1 if ca else 0) + (1 if cl else 0)
    if b_dim[2] == t_dim.lw and b_dim[3] == t_dim.lh:
        return 0
    la = 0
    for i in range(min(1 << t_dim.lw, 16)):
        la |= a[a_off + i]
    ll = 0
    for i in range(min(1 << t_dim.lh, 16)):
        ll |= l[l_off + i]
    la = min(la & 0x3F, 4)
    ll = min(ll & 0x3F, 4)
    return SKIP_CTX[la][ll]


def get_dc_sign_ctx(tx, a, l, a_off, l_off) -> int:
    """Sum of packed sign-tracking bytes' top-2 bits minus neutral count."""
    t_dim = TXFM_DIMENSIONS[tx]
    wn = min(t_dim.w, 16)  # bytes covered (4px units), capped like the asm
    hn = min(t_dim.h, 16)
    s = 0
    for i in range(wn):
        s += a[a_off + i] >> 6
    for i in range(hn):
        s += l[l_off + i] >> 6
    s -= wn + hn
    return (1 if s != 0 else 0) + (1 if s > 0 else 0)


def _get_lo_ctx(levels, base, tx_class, ctx_offsets, x, y, stride):
    """Returns (ctx, hi_mag) (src/recon.rs:449 get_lo_ctx)."""
    mag = levels[base + stride + 0] + levels[base + 1]
    if tx_class == TX_CLASS_2D:
        mag += levels[base + stride + 1]
        hi_mag = mag
        mag += levels[base + 2] + levels[base + 2 * stride]
        offset = ctx_offsets[min(y, 4)][min(x, 4)]
    else:
        mag += levels[base + 2]
        hi_mag = mag
        mag += levels[base + 3] + levels[base + 4]
        offset = 26 + (10 if y > 1 else y * 5)
    return offset + (4 if mag > 512 else (mag + 64) >> 7), hi_mag


def read_golomb(msac) -> int:
    length = 0
    val = 1
    while not msac.decode_bool_equi() and length < 32:
        length += 1
    for _ in range(length):
        val = (val << 1) + msac.decode_bool_equi()
    return val - 1


from ..native import AVAILABLE as _NATIVE

if _NATIVE:
    import ctypes

    from ..native import LIB as _LIB, CoefCdfPtrs as _CCdf, CoefCallParams as _CP

    _SKIP_CTX_NP = np.ascontiguousarray(np.asarray(SKIP_CTX, dtype=np.uint8))
    _LO_CTX_NP = np.ascontiguousarray(np.asarray(LO_CTX_OFFSETS, dtype=np.uint8))
    _TXSET_NP = np.asarray(TX_TYPES_PER_SET, dtype=np.uint8)
    _TXCLS_NP = np.asarray(TX_TYPE_CLASS, dtype=np.uint8)

    _CP_REUSE = _CP()
    _CP_REUSE.skip_ctx_tbl = _SKIP_CTX_NP.ctypes.data
    _CP_REUSE.lo_ctx_offsets = _LO_CTX_NP.ctypes.data
    _CP_REUSE.tx_types_per_set = _TXSET_NP.ctypes.data
    _CP_REUSE.tx_type_class = _TXCLS_NP.ctypes.data

    def _coef_cdf_ptrs(coef):
        """Cache a CoefCdfPtrs struct on the cdf coef group (tables are
        contiguous numpy arrays whose buffers are stable for its lifetime)."""
        ptrs = getattr(coef, "_native_ptrs", None)
        if ptrs is None:
            ptrs = _CCdf()
            for name, _ in _CCdf._fields_:
                ptrs.__setattr__(name, getattr(coef, name).ctypes.data)
            coef._native_ptrs = ptrs
        return ptrs

    def decode_coefs(
        f, ts, a, l, a_off, l_off, tx, bs, b, intra, plane, cf, txtp_in=DCT_DCT
    ):
        """Native decode_coefs: txtp-cdf selection stays host-side; the
        symbol loop runs in C (native/entropy.c dav1d_decode_coefs)."""
        cdf = ts.cdf
        chroma = 1 if plane else 0
        frame_hdr = f.frame_hdr
        lossless = frame_hdr.segmentation.lossless[b.seg_id]
        t_dim = TXFM_DIMENSIONS[tx]
        layout = int(f.cur.layout)

        p = _CP_REUSE  # single decode thread: reuse one struct per call
        p.tdim_lw = t_dim.lw
        p.tdim_lh = t_dim.lh
        p.tdim_w = t_dim.w
        p.tdim_h = t_dim.h
        p.tdim_ctx = t_dim.ctx
        p.tdim_min = t_dim.min
        p.tdim_max = t_dim.max
        b_dim = BLOCK_DIMENSIONS[bs]
        p.bdim_lw = b_dim[2]
        p.bdim_lh = b_dim[3]
        p.chroma = chroma
        p.ss_ver = 1 if layout == 1 else 0
        p.ss_hor = 1 if layout != 3 else 0
        nonsquare = 1 if tx >= RTX_4X8 else 0
        p.ctx_off_idx = nonsquare + (tx & nonsquare)
        p.idtx_val = IDTX
        p.skip_txtp = WHT_WHT if lossless else DCT_DCT

        # txtp selection (mirrors the Python reference branch for branch)
        txtp_cdf = None
        if lossless:
            p.txtp_mode = 0
            p.txtp_fixed = WHT_WHT
        elif t_dim.max + intra >= TX_64X64:
            p.txtp_mode = 0
            p.txtp_fixed = DCT_DCT
        elif chroma:
            p.txtp_mode = 0
            p.txtp_fixed = (
                TXTP_FROM_UVMODE[b.uv_mode]
                if intra
                else get_uv_inter_txtp(t_dim, txtp_in)
            )
        elif frame_hdr.segmentation.qidx[b.seg_id] == 0:
            p.txtp_mode = 0
            p.txtp_fixed = DCT_DCT
        elif intra:
            y_mode_nofilt = (
                FILTER_MODE_TO_Y_MODE[b.y_angle]
                if b.y_mode == FILTER_PRED
                else b.y_mode
            )
            if frame_hdr.reduced_txtp_set or t_dim.min == TX_16X16:
                p.txtp_mode = 1
                txtp_cdf = cdf.m.txtp_intra2[t_dim.min][y_mode_nofilt]
            else:
                p.txtp_mode = 2
                txtp_cdf = cdf.m.txtp_intra1[t_dim.min][y_mode_nofilt]
        elif frame_hdr.reduced_txtp_set or t_dim.max == TX_32X32:
            p.txtp_mode = 3
            txtp_cdf = cdf.m.txtp_inter3[t_dim.min]
        elif t_dim.min == TX_16X16:
            p.txtp_mode = 4
            txtp_cdf = cdf.m.txtp_inter2
        else:
            p.txtp_mode = 5
            txtp_cdf = cdf.m.txtp_inter1[t_dim.min]
        p.txtp_cdf = 0 if txtp_cdf is None else txtp_cdf.ctypes.data

        dq = ts.dq[b.seg_id][plane]
        p.dq_dc = int(dq[0])
        p.dq_ac = int(dq[1])
        p.dq_shift = max(0, t_dim.ctx - 2)
        p.cf_max = (1 << (f.cur.bpc + 7)) - 1
        p.a = a.ctypes.data
        p.a_off = a_off
        p.l = l.ctypes.data
        p.l_off = l_off
        p.scan = SCANS[tx].ctypes.data
        qm_tbl = f.qm[tx][plane]
        p.qm = 0 if qm_tbl is None else qm_tbl.ctypes.data
        p.cf = cf.ctypes.data

        _LIB.dav1d_decode_coefs(ts.msac._sp, ctypes.byref(_coef_cdf_ptrs(cdf.coef)), ctypes.byref(p))
        return p.eob, p.txtp, p.cf_ctx


def decode_coefs_py(
    f, ts, a, l, a_off, l_off, tx, bs, b, intra, plane, cf, txtp_in=DCT_DCT
):
    """Decode one transform block's coefficients into cf (int32 array in
    scan-position layout). Returns (eob, txtp, cf_ctx); eob=-1 if all-skip.
    """
    msac = ts.msac
    cdf = ts.cdf
    chroma = 1 if plane else 0
    frame_hdr = f.frame_hdr
    lossless = frame_hdr.segmentation.lossless[b.seg_id]
    t_dim = TXFM_DIMENSIONS[tx]
    layout = int(f.cur.layout)

    sctx = get_skip_ctx(t_dim, bs, a, l, a_off, l_off, chroma, layout)
    all_skip = msac.decode_bool_adapt(cdf.coef.skip[t_dim.ctx][sctx])
    if all_skip:
        return -1, (WHT_WHT if lossless else DCT_DCT), 0x40

    # tx type
    if lossless:
        assert t_dim.max == TX_4X4
        txtp = WHT_WHT
    elif t_dim.max + intra >= TX_64X64:
        txtp = DCT_DCT
    elif chroma:
        txtp = (
            TXTP_FROM_UVMODE[b.uv_mode]
            if intra
            else get_uv_inter_txtp(t_dim, txtp_in)
        )
    elif frame_hdr.segmentation.qidx[b.seg_id] == 0:
        txtp = DCT_DCT
    else:
        if intra:
            y_mode_nofilt = (
                FILTER_MODE_TO_Y_MODE[b.y_angle]
                if b.y_mode == FILTER_PRED
                else b.y_mode
            )
            if frame_hdr.reduced_txtp_set or t_dim.min == TX_16X16:
                idx = msac.decode_symbol_adapt(
                    cdf.m.txtp_intra2[t_dim.min][y_mode_nofilt], 4
                )
                txtp = TX_TYPES_PER_SET[idx + 0]
            else:
                idx = msac.decode_symbol_adapt(
                    cdf.m.txtp_intra1[t_dim.min][y_mode_nofilt], 6
                )
                txtp = TX_TYPES_PER_SET[idx + 5]
        else:
            if frame_hdr.reduced_txtp_set or t_dim.max == TX_32X32:
                idx = msac.decode_bool_adapt(cdf.m.txtp_inter3[t_dim.min])
                txtp = (idx - 1) & IDTX
            elif t_dim.min == TX_16X16:
                idx = msac.decode_symbol_adapt(cdf.m.txtp_inter2, 11)
                txtp = TX_TYPES_PER_SET[idx + 12]
            else:
                idx = msac.decode_symbol_adapt(cdf.m.txtp_inter1[t_dim.min], 15)
                txtp = TX_TYPES_PER_SET[idx + 24]

    # eob
    tx2dszctx = min(t_dim.lw, TX_32X32) + min(t_dim.lh, TX_32X32)
    tx_class = TX_TYPE_CLASS[txtp]
    is_1d = 1 if tx_class != TX_CLASS_2D else 0
    if tx2dszctx == 0:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_16[chroma][is_1d], 4)
    elif tx2dszctx == 1:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_32[chroma][is_1d], 5)
    elif tx2dszctx == 2:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_64[chroma][is_1d], 6)
    elif tx2dszctx == 3:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_128[chroma][is_1d], 7)
    elif tx2dszctx == 4:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_256[chroma][is_1d], 8)
    elif tx2dszctx == 5:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_512[chroma], 9)
    else:
        eob_bin = msac.decode_symbol_adapt(cdf.coef.eob_bin_1024[chroma], 10)

    if eob_bin > 1:
        eob_hi_bit = msac.decode_bool_adapt(
            cdf.coef.eob_hi_bit[t_dim.ctx][chroma][eob_bin]
        )
        eob = ((eob_hi_bit | 2) << (eob_bin - 2)) | msac.decode_bools(eob_bin - 2)
    else:
        eob = eob_bin

    eob_cdf = cdf.coef.eob_base_tok[t_dim.ctx][chroma]
    hi_cdf = cdf.coef.br_tok[min(t_dim.ctx, 3)][chroma]

    if eob:
        lo_cdf = cdf.coef.base_tok[t_dim.ctx][chroma]
        sw = min(t_dim.w, 8)
        sh = min(t_dim.h, 8)
        ctx = 1 + (1 if eob > sw * sh * 2 else 0) + (1 if eob > sw * sh * 4 else 0)
        eob_tok = msac.decode_symbol_adapt(eob_cdf[ctx], 2)
        tok = eob_tok + 1
        level_tok = tok * 0x41

        if tx_class == TX_CLASS_2D:
            nonsquare_tx = 1 if tx >= RTX_4X8 else 0
            ctx_offsets = LO_CTX_OFFSETS[nonsquare_tx + (tx & nonsquare_tx)]
            scan = SCANS[tx]
            stride = 4 * sh
            shift = t_dim.lh + 2 if t_dim.lh < 4 else 5
            shift2 = 0
            mask = 4 * sh - 1
            clear = stride * (4 * sw + 2)
        elif tx_class == TX_CLASS_H:
            ctx_offsets = None
            scan = None
            stride = 16
            shift = t_dim.lh + 2
            shift2 = 0
            mask = 4 * sh - 1
            clear = stride * (4 * sh + 2)
        else:  # V
            ctx_offsets = None
            scan = None
            stride = 16
            shift = t_dim.lw + 2
            shift2 = t_dim.lh + 2
            mask = 4 * sw - 1
            clear = stride * (4 * sw + 2)

        levels = [0] * (clear + 2 * stride + 5)  # headroom for ctx reads

        # eob position
        if tx_class == TX_CLASS_2D:
            rc = int(scan[eob])
            x = rc >> shift
            y = rc & mask
        elif tx_class == TX_CLASS_H:
            x = eob & mask
            y = eob >> shift
            rc = eob
        else:
            x = eob & mask
            y = eob >> shift
            rc = (x << shift2) | y

        if eob_tok == 2:
            hictx = (
                14
                if ((x | y) > 1 if tx_class == TX_CLASS_2D else y != 0)
                else 7
            )
            tok = msac.decode_hi_tok(hi_cdf[hictx])
            level_tok = tok + (3 << 6)
        cf[rc] = tok << 11
        levels[x * stride + y] = level_tok & 0xFF

        for i in range(eob - 1, 0, -1):
            if tx_class == TX_CLASS_2D:
                rc_i = int(scan[i])
                x = rc_i >> shift
                y = rc_i & mask
            elif tx_class == TX_CLASS_H:
                x = i & mask
                y = i >> shift
                rc_i = i
            else:
                x = i & mask
                y = i >> shift
                rc_i = (x << shift2) | y
            base = x * stride + y
            ctx, mag = _get_lo_ctx(
                levels, base, tx_class, ctx_offsets, x, y, stride
            )
            if tx_class == TX_CLASS_2D:
                y |= x
            tok = msac.decode_symbol_adapt(lo_cdf[ctx], 3)
            if tok == 3:
                mag &= 63
                hictx = (
                    14 if y > (1 if tx_class == TX_CLASS_2D else 0) else 7
                ) + (6 if mag > 12 else (mag + 1) >> 1)
                tok = msac.decode_hi_tok(hi_cdf[hictx])
                levels[base] = (tok + (3 << 6)) & 0xFF
                cf[rc_i] = (tok << 11) | rc
                rc = rc_i
            else:
                tok *= 0x17FF41
                levels[base] = tok & 0xFF
                tok = (tok >> 9) & (rc + ~0x7FF & 0xFFFFFFFF)
                if tok:
                    rc = rc_i
                cf[rc_i] = tok

        # dc token
        if tx_class == TX_CLASS_2D:
            ctx = 0
        else:
            ctx, mag = _get_lo_ctx(levels, 0, tx_class, ctx_offsets, 0, 0, stride)
        dc_tok = msac.decode_symbol_adapt(lo_cdf[ctx], 3)
        if dc_tok == 3:
            if tx_class == TX_CLASS_2D:
                mag = levels[1] + levels[stride] + levels[stride + 1]
            mag &= 63
            hictx = 6 if mag > 12 else (mag + 1) >> 1
            dc_tok = msac.decode_hi_tok(hi_cdf[hictx])
    else:
        tok_br = msac.decode_symbol_adapt(eob_cdf[0], 2)
        dc_tok = 1 + tok_br
        if tok_br == 2:
            dc_tok = msac.decode_hi_tok(hi_cdf[0])
        rc = 0

    # dequantization (cap: cf_max = ~(~127 << bpc))
    dq_tbl = ts.dq[b.seg_id][plane]
    qm_tbl = f.qm[tx][plane] if txtp < IDTX else None
    dq_shift = max(0, t_dim.ctx - 2)
    cf_max = (1 << (f.cur.bpc + 7)) - 1

    if dc_tok == 0:
        cul_level = 0
        dc_sign_level = 1 << 6
    else:
        dc_sign_ctx = get_dc_sign_ctx(tx, a, l, a_off, l_off)
        dc_sign = msac.decode_bool_adapt(cdf.coef.dc_sign[chroma][dc_sign_ctx])
        dc_dq = dq_tbl[0]
        dc_sign_level = (dc_sign - 1) & (2 << 6)
        if qm_tbl is not None:
            dc_dq = (dc_dq * qm_tbl[0] + 16) >> 5
            if dc_tok == 15:
                dc_tok = (read_golomb(msac) + 15) & 0xFFFFF
                dc_dq = (dc_dq * dc_tok) & 0xFFFFFF
            else:
                dc_dq = dc_dq * dc_tok
            cul_level = dc_tok
            dc_dq >>= dq_shift
            dc_dq = min(dc_dq, cf_max + dc_sign)
        else:
            if dc_tok == 15:
                dc_tok = (read_golomb(msac) + 15) & 0xFFFFF
                dc_dq = ((dc_dq * dc_tok) & 0xFFFFFF) >> dq_shift
                dc_dq = min(dc_dq, cf_max + dc_sign)
            else:
                dc_dq = (dc_dq * dc_tok) >> dq_shift
            cul_level = dc_tok
        cf[0] = -dc_dq if dc_sign else dc_dq

    if rc:
        ac_dq = dq_tbl[1]
        while True:
            sign = msac.decode_bool_equi()
            rc_tok = int(cf[rc]) & 0xFFFFFFFF
            if qm_tbl is not None:
                dq = (ac_dq * qm_tbl[rc] + 16) >> 5
                if rc_tok >= 15 << 11:
                    tok = (read_golomb(msac) + 15) & 0xFFFFF
                    dq = (dq * tok) & 0xFFFFFF
                else:
                    tok = rc_tok >> 11
                    dq = dq * tok
                cul_level += tok
                dq >>= dq_shift
                dq = min(dq, cf_max + sign)
            else:
                if rc_tok >= 15 << 11:
                    tok = (read_golomb(msac) + 15) & 0xFFFFF
                    dq = ((ac_dq * tok) & 0xFFFFFF) >> dq_shift
                    dq = min(dq, cf_max + sign)
                else:
                    tok = rc_tok >> 11
                    dq = (ac_dq * tok) >> dq_shift
                cul_level += tok
            cf[rc] = -dq if sign else dq
            rc = rc_tok & 0x3FF
            if not rc:
                break

    cf_ctx = min(cul_level, 63) | dc_sign_level
    return eob, txtp, cf_ctx


if not _NATIVE:
    decode_coefs = decode_coefs_py  # noqa: F811 — pure-Python fallback
