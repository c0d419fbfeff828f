"""Reference MV candidate machinery (parity: src/refmvs.rs).

rav1d keeps a 35-row ring buffer of 4x4-resolution spatial MV blocks per
sbrow plus a 16-row ring of projected temporal MVs. Since we decode a
whole frame at a time, both are stored as full-frame 2D arrays: `r`
(spatial, 4x4 units) and `rp_proj` (temporal projection, 8x8 units). The
ring-index arithmetic in the reference ((by4&31)+5+k etc.) maps 1:1 onto
absolute row indexing, because only odd rows above the current superblock
row are ever read — exactly the rows the reference preserves across the
ring swap (refmvs.rs rav1d_refmvs_tile_sbrow_init:1319).

MV convention here is (x, y) tuples/int pairs, matching syntax/env.py.
"""

from __future__ import annotations

import numpy as np

from .env import _i16, fix_mv_precision, get_gmv_2d, get_poc_diff
from ..headers import WarpedMotionType
from ..tables.block_tables import BLOCK_DIMENSIONS

INVALID_MV = (-32768, -32768)

# spatial block record: mv[2] as (x, y), ref[2], bs, mf
RB_DT = np.dtype(
    [("mv", np.int16, (2, 2)), ("ref", np.int8, (2,)), ("bs", np.uint8), ("mf", np.uint8)]
)
# temporal block record
TB_DT = np.dtype([("mv", np.int16, (2,)), ("ref", np.int8)])

_DIV_MULT = [
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638, 1489,
    1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744, 712, 682,
    655, 630, 606, 585, 564, 546, 528,
]


def _iclip(v, lo, hi):
    return lo if v < lo else (hi if v > hi else v)


def _apply_sign(v, s):
    return -v if s < 0 else v


def mv_projection(mvx, mvy, num, den):
    """Scale mv by num/den (refmvs.rs mv_projection)."""
    assert 0 < den < 32 and -32 < num < 32
    frac = num * _DIV_MULT[den]
    x = mvx * frac
    y = mvy * frac
    mx = (1 << 14) - 1
    return (
        _iclip((x + 8192 + (x >> 31)) >> 14, -mx, mx),
        _iclip((y + 8192 + (y >> 31)) >> 14, -mx, mx),
    )


class RefMvsTile:
    __slots__ = ("col_start", "col_end", "row_start", "row_end")

    def __init__(self, rf, col_start4, col_end4, row_start4, row_end4):
        self.col_start = col_start4
        self.col_end = min(col_end4, rf.iw4)
        self.row_start = row_start4
        self.row_end = min(row_end4, rf.ih4)


class RefMvsFrame:
    """Per-frame MV predictor state (refmvs.rs RefMvsFrame + init_frame)."""

    def __init__(self):
        self.r = None
        self.rp = None
        self.rp_proj = None
        self.rp_ref = [None] * 7
        self.use_ref_frame_mvs = 0

    def init_frame(self, seq_hdr, frame_hdr, ref_poc, rp, ref_ref_poc, rp_ref):
        """refmvs.rs rav1d_refmvs_init_frame:1521.

        ref_poc: [7] frame_offset of each forward ref; rp: this frame's
        temporal block array ((sb128h*16, rp_stride) TB_DT); ref_ref_poc:
        [7][7] refpoc of each ref's refs; rp_ref: [7] temporal arrays of
        refs (None if unusable).
        """
        self.sbsz = 16 << seq_hdr.sb128
        self.iw8 = (frame_hdr.size.width[0] + 7) >> 3
        self.ih8 = (frame_hdr.size.height + 7) >> 3
        self.iw4 = self.iw8 << 1
        self.ih4 = self.ih8 << 1

        r_stride = ((frame_hdr.size.width[0] + 127) & ~127) >> 2
        n_rows4 = ((self.ih4 + self.sbsz - 1) // self.sbsz) * self.sbsz
        self.r = np.zeros((n_rows4, r_stride), dtype=RB_DT)
        self.r_stride = r_stride
        rp_stride = r_stride >> 1
        self.rp_stride = rp_stride
        self.rp = rp
        self.rp_proj = np.zeros((n_rows4 >> 1, rp_stride), dtype=TB_DT)
        self.rp_ref = rp_ref

        poc = frame_hdr.frame_offset
        ohb = seq_hdr.order_hint_n_bits
        self.sign_bias = [0] * 7
        self.mfmv_sign = [0] * 7
        self.pocdiff = [0] * 7
        for i in range(7):
            d = get_poc_diff(ohb, ref_poc[i], poc)
            self.sign_bias[i] = 1 if d > 0 else 0
            self.mfmv_sign[i] = 1 if d < 0 else 0
            self.pocdiff[i] = _iclip(get_poc_diff(ohb, poc, ref_poc[i]), -31, 31)

        self.n_mfmvs = 0
        self.mfmv_ref = [0] * 3
        self.mfmv_ref2cur = [0] * 3
        self.mfmv_ref2ref = [[0] * 7 for _ in range(3)]
        if frame_hdr.use_ref_frame_mvs and ohb:
            total = 2
            if rp_ref[0] is not None and ref_ref_poc[0][6] != ref_poc[3]:
                self.mfmv_ref[self.n_mfmvs] = 0  # last
                self.n_mfmvs += 1
                total = 3
            if rp_ref[4] is not None and get_poc_diff(ohb, ref_poc[4], poc) > 0:
                self.mfmv_ref[self.n_mfmvs] = 4  # bwd
                self.n_mfmvs += 1
            if rp_ref[5] is not None and get_poc_diff(ohb, ref_poc[5], poc) > 0:
                self.mfmv_ref[self.n_mfmvs] = 5  # altref2
                self.n_mfmvs += 1
            if (
                self.n_mfmvs < total
                and rp_ref[6] is not None
                and get_poc_diff(ohb, ref_poc[6], poc) > 0
            ):
                self.mfmv_ref[self.n_mfmvs] = 6  # altref
                self.n_mfmvs += 1
            if self.n_mfmvs < total and rp_ref[1] is not None:
                self.mfmv_ref[self.n_mfmvs] = 1  # last2
                self.n_mfmvs += 1

            for n in range(self.n_mfmvs):
                rpoc = ref_poc[self.mfmv_ref[n]]
                diff1 = get_poc_diff(ohb, rpoc, poc)
                if abs(diff1) > 31:
                    self.mfmv_ref2cur[n] = -(1 << 31)
                else:
                    self.mfmv_ref2cur[n] = -diff1 if self.mfmv_ref[n] < 4 else diff1
                    for m in range(7):
                        rrpoc = ref_ref_poc[self.mfmv_ref[n]][m]
                        diff2 = get_poc_diff(ohb, rpoc, rrpoc)
                        self.mfmv_ref2ref[n][m] = 0 if not (0 <= diff2 <= 31) else diff2
        self.use_ref_frame_mvs = 1 if self.n_mfmvs > 0 else 0


def splat_mv(rf, by4, bx4, bw4, bh4, mv0, mv1, ref0, ref1, bs, mf):
    """Fill the spatial MV grid for one block (refmvs.rs splat_mv)."""
    rec = np.zeros((), dtype=RB_DT)
    rec["mv"][0] = mv0
    rec["mv"][1] = mv1
    rec["ref"][0] = ref0
    rec["ref"][1] = ref1
    rec["bs"] = bs
    rec["mf"] = mf
    rf.r[by4 : by4 + bh4, bx4 : bx4 + bw4] = rec


def save_tmvs(rf, col_start8, col_end8, row_start8, row_end8):
    """Copy 4x4 spatial MVs into 8x8 temporal blocks (refmvs.rs save_tmvs_c:1481)."""
    from ..native import syntax as _nsy

    if _nsy.enabled():
        return _nsy.save_tmvs(rf, col_start8, col_end8, row_start8, row_end8)
    row_end8 = min(row_end8, rf.ih8)
    col_end8 = min(col_end8, rf.iw8)
    ref_sign = rf.mfmv_sign
    r = rf.r
    rp = rf.rp
    for y in range(row_start8, row_end8):
        row = r[y * 2 + 1]
        x = col_start8
        while x < col_end8:
            cand = row[x * 2 + 1]
            bw8 = (BLOCK_DIMENSIONS[cand["bs"]][0] + 1) >> 1
            blk = None
            for i in (1, 0):
                rr = int(cand["ref"][i])
                mx, my = int(cand["mv"][i][0]), int(cand["mv"][i][1])
                if rr > 0 and ref_sign[rr - 1] and (abs(my) | abs(mx)) < 4096:
                    blk = ((mx, my), rr)
                    break
            if blk is None:
                blk = ((0, 0), 0)
            rp["mv"][y, x : x + bw8] = blk[0]
            rp["ref"][y, x : x + bw8] = blk[1]
            x += bw8


def load_tmvs(rf, frame_hdr, col_start8, col_end8, row_start8, row_end8):
    """Project temporal MVs into rp_proj (refmvs.rs load_tmvs_c:1379)."""
    from ..native import syntax as _nsy

    if _nsy.enabled():
        return _nsy.load_tmvs(rf, col_start8, col_end8, row_start8, row_end8)
    row_end8 = min(row_end8, rf.ih8)
    col_start8i = max(col_start8 - 8, 0)
    col_end8i = min(col_end8 + 8, rf.iw8)
    rp_proj = rf.rp_proj
    rp_proj["mv"][row_start8:row_end8, col_start8:col_end8] = INVALID_MV
    for n in range(rf.n_mfmvs):
        ref2cur = rf.mfmv_ref2cur[n]
        if ref2cur == -(1 << 31):
            continue
        refidx = rf.mfmv_ref[n]
        ref_sign = refidx - 4
        rarr = rf.rp_ref[refidx]
        ref2ref_n = rf.mfmv_ref2ref[n]
        for y in range(row_start8, row_end8):
            y_sb_align = y & ~7
            y_proj_start = max(y_sb_align, row_start8)
            y_proj_end = min(y_sb_align + 8, row_end8)
            rrow_ref = rarr["ref"][y]
            rrow_mv = rarr["mv"][y]
            x = col_start8i
            while x < col_end8i:
                b_ref = int(rrow_ref[x])
                if b_ref == 0:
                    x += 1
                    continue
                ref2ref = ref2ref_n[b_ref - 1]
                if ref2ref == 0:
                    x += 1
                    continue
                b_mvx, b_mvy = int(rrow_mv[x][0]), int(rrow_mv[x][1])
                ox, oy = mv_projection(b_mvx, b_mvy, ref2cur, ref2ref)
                pos_x = x + _apply_sign(abs(ox) >> 6, ox ^ ref_sign)
                pos_y = y + _apply_sign(abs(oy) >> 6, oy ^ ref_sign)
                if y_proj_start <= pos_y < y_proj_end:
                    while True:
                        x_sb_align = x & ~7
                        if (
                            max(x_sb_align - 8, col_start8)
                            <= pos_x
                            < min(x_sb_align + 16, col_end8)
                        ):
                            rp_proj["mv"][pos_y, pos_x] = (b_mvx, b_mvy)
                            rp_proj["ref"][pos_y, pos_x] = ref2ref
                        x += 1
                        if x >= col_end8i:
                            break
                        if (
                            int(rrow_ref[x]) != b_ref
                            or int(rrow_mv[x][0]) != b_mvx
                            or int(rrow_mv[x][1]) != b_mvy
                        ):
                            break
                        pos_x += 1
                else:
                    while True:
                        x += 1
                        if x >= col_end8i:
                            break
                        if (
                            int(rrow_ref[x]) != b_ref
                            or int(rrow_mv[x][0]) != b_mvx
                            or int(rrow_mv[x][1]) != b_mvy
                        ):
                            break


class Candidate:
    __slots__ = ("mv", "weight")

    def __init__(self):
        self.mv = [[0, 0], [0, 0]]  # [n] = [x, y]
        self.weight = 0

    def __getitem__(self, i):
        # decode.py's drl helpers index candidates as cand[0]=mvpair, cand[1]=weight
        return self.mv if i == 0 else self.weight


def _cand_block(rf, row, col):
    b = rf.r[row, col]
    return (
        (int(b["mv"][0][0]), int(b["mv"][0][1])),
        (int(b["mv"][1][0]), int(b["mv"][1][1])),
        (int(b["ref"][0]), int(b["ref"][1])),
        int(b["bs"]),
        int(b["mf"]),
    )


def _add_spatial_candidate(mvstack, cnt, weight, cand, ref_pair, gmv, newmv, refmv):
    """refmvs.rs add_spatial_candidate. newmv/refmv: 1-elem list holders
    standing in for the reference's &mut have_newmv_match/have_refmv_match."""
    mv0, mv1, refs, _bs, mf = cand
    if mv0 == INVALID_MV:  # intra block without intrabc
        return cnt
    mf_odd = (mf & 1) != 0
    if ref_pair[1] == -1:
        for n in range(2):
            if refs[n] == ref_pair[0]:
                cand_mv = gmv[0] if (mf_odd and gmv[0] != INVALID_MV) else (mv0 if n == 0 else mv1)
                refmv[0] = 1
                newmv[0] |= mf >> 1
                for c in mvstack[:cnt]:
                    if tuple(c.mv[0]) == cand_mv:
                        c.weight += weight
                        return cnt
                if cnt < 8:
                    mvstack[cnt].mv[0] = list(cand_mv)
                    mvstack[cnt].weight = weight
                    cnt += 1
                return cnt
    elif refs == tuple(ref_pair):
        cand_pair = (
            gmv[0] if (mf_odd and gmv[0] != INVALID_MV) else mv0,
            gmv[1] if (mf_odd and gmv[1] != INVALID_MV) else mv1,
        )
        refmv[0] = 1
        newmv[0] |= mf >> 1
        for c in mvstack[:cnt]:
            if tuple(c.mv[0]) == cand_pair[0] and tuple(c.mv[1]) == cand_pair[1]:
                c.weight += weight
                return cnt
        if cnt < 8:
            mvstack[cnt].mv[0] = list(cand_pair[0])
            mvstack[cnt].mv[1] = list(cand_pair[1])
            mvstack[cnt].weight = weight
            cnt += 1
    return cnt


def _scan_row(mvstack, cnt, ref_pair, gmv, rf, row, bx4, bw4, w4, max_rows, step, newmv, refmv):
    """refmvs.rs scan_row. Returns (n_rows, cnt)."""
    cand = _cand_block(rf, row, bx4)
    first_dim = BLOCK_DIMENSIONS[cand[3]]
    cand_bw4 = first_dim[0]
    length = max(step, min(bw4, cand_bw4))
    if bw4 <= cand_bw4:
        weight = 2 if bw4 == 1 else max(2, min(2 * max_rows, first_dim[1]))
        cnt = _add_spatial_candidate(mvstack, cnt, length * weight, cand, ref_pair, gmv, newmv, refmv)
        return weight >> 1, cnt
    x = 0
    while True:
        cnt = _add_spatial_candidate(mvstack, cnt, length * 2, cand, ref_pair, gmv, newmv, refmv)
        x += length
        if x >= w4:
            return 1, cnt
        cand = _cand_block(rf, row, bx4 + x)
        cand_bw4 = BLOCK_DIMENSIONS[cand[3]][0]
        length = max(step, cand_bw4)


def _scan_col(mvstack, cnt, ref_pair, gmv, rf, row0, col, bh4, h4, max_cols, step, newmv, refmv):
    """refmvs.rs scan_col. Returns (n_cols, cnt)."""
    cand = _cand_block(rf, row0, col)
    first_dim = BLOCK_DIMENSIONS[cand[3]]
    cand_bh4 = first_dim[1]
    length = max(step, min(bh4, cand_bh4))
    if bh4 <= cand_bh4:
        weight = 2 if bh4 == 1 else max(2, min(2 * max_cols, first_dim[0]))
        cnt = _add_spatial_candidate(mvstack, cnt, length * weight, cand, ref_pair, gmv, newmv, refmv)
        return weight >> 1, cnt
    y = 0
    while True:
        cnt = _add_spatial_candidate(mvstack, cnt, length * 2, cand, ref_pair, gmv, newmv, refmv)
        y += length
        if y >= h4:
            return 1, cnt
        cand = _cand_block(rf, row0 + y, col)
        cand_bh4 = BLOCK_DIMENSIONS[cand[3]][1]
        length = max(step, cand_bh4)


def _add_temporal_candidate(rf, mvstack, cnt, tb, ref_pair, globalmv, frame_hdr):
    """refmvs.rs add_temporal_candidate. Returns (cnt, globalmv_ctx)."""
    tmvx, tmvy = int(tb["mv"][0]), int(tb["mv"][1])
    gctx = None
    if (tmvx, tmvy) == INVALID_MV:
        return cnt, gctx
    tref = int(tb["ref"])
    mx, my = mv_projection(tmvx, tmvy, rf.pocdiff[ref_pair[0] - 1], tref)
    mx, my = fix_mv_precision(frame_hdr, mx, my)
    if ref_pair[1] == -1:
        if globalmv is not None:
            gmv0 = globalmv[0]
            gctx = 1 if (abs(mx - gmv0[0]) | abs(my - gmv0[1])) >= 16 else 0
        for c in mvstack[:cnt]:
            if tuple(c.mv[0]) == (mx, my):
                c.weight += 2
                return cnt, gctx
        if cnt < 8:
            mvstack[cnt].mv[0] = [mx, my]
            mvstack[cnt].weight = 2
            cnt += 1
    else:
        mx1, my1 = mv_projection(tmvx, tmvy, rf.pocdiff[ref_pair[1] - 1], tref)
        mx1, my1 = fix_mv_precision(frame_hdr, mx1, my1)
        for c in mvstack[:cnt]:
            if tuple(c.mv[0]) == (mx, my) and tuple(c.mv[1]) == (mx1, my1):
                c.weight += 2
                return cnt, gctx
        if cnt < 8:
            mvstack[cnt].mv[0] = [mx, my]
            mvstack[cnt].mv[1] = [mx1, my1]
            mvstack[cnt].weight = 2
            cnt += 1
    return cnt, gctx


def _neg_mv(m):
    return (_i16(-m[0]), _i16(-m[1]))


def _add_compound_extended_candidate(same, same_count, cand, sign0, sign1, ref_pair, sign_bias):
    """refmvs.rs add_compound_extended_candidate. same: 4 Candidates
    (slots [0:2]=same, [2:4]=diff); same_count: [4] list."""
    mv0, mv1, refs, _bs, _mf = cand
    for n in range(2):
        cand_ref = refs[n]
        if cand_ref <= 0:
            break
        sb = sign_bias[cand_ref - 1]
        cand_mv = mv0 if n == 0 else mv1
        if cand_ref == ref_pair[0]:
            if same_count[0] < 2:
                same[same_count[0]].mv[0] = list(cand_mv)
                same_count[0] += 1
            if same_count[3] < 2:
                m = _neg_mv(cand_mv) if (sign1 ^ sb) else cand_mv
                same[2 + same_count[3]].mv[1] = list(m)
                same_count[3] += 1
        elif cand_ref == ref_pair[1]:
            if same_count[1] < 2:
                same[same_count[1]].mv[1] = list(cand_mv)
                same_count[1] += 1
            if same_count[2] < 2:
                m = _neg_mv(cand_mv) if (sign0 ^ sb) else cand_mv
                same[2 + same_count[2]].mv[0] = list(m)
                same_count[2] += 1
        else:
            i_cand_mv = _neg_mv(cand_mv)
            if same_count[2] < 2:
                same[2 + same_count[2]].mv[0] = list(i_cand_mv if (sign0 ^ sb) else cand_mv)
                same_count[2] += 1
            if same_count[3] < 2:
                same[2 + same_count[3]].mv[1] = list(i_cand_mv if (sign1 ^ sb) else cand_mv)
                same_count[3] += 1


def _add_single_extended_candidate(mvstack, cnt, cand, sign, sign_bias):
    """refmvs.rs add_single_extended_candidate."""
    mv0, mv1, refs, _bs, _mf = cand
    for n in range(2):
        cand_ref = refs[n]
        if cand_ref <= 0:
            break
        cand_mv = mv0 if n == 0 else mv1
        if sign ^ sign_bias[cand_ref - 1]:
            cand_mv = _neg_mv(cand_mv)
        dup = False
        for c in mvstack[:cnt]:
            if tuple(c.mv[0]) == cand_mv:
                dup = True
                break
        if not dup:
            mvstack[cnt].mv[0] = list(cand_mv)
            mvstack[cnt].weight = 2
            cnt += 1
    return cnt


_BDIMS_NP = None


def _bdims_np():
    global _BDIMS_NP
    if _BDIMS_NP is None:
        _BDIMS_NP = np.ascontiguousarray(
            np.array([[d[0], d[1], d[2], d[3]] for d in BLOCK_DIMENSIONS], np.uint8)
        )
    return _BDIMS_NP


def refmvs_find_native(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr):
    """Native-core refmvs_find (native/refmvs.c); same returns as the
    Python anchor below."""
    from ..native import LIB_REFMVS, RefMvsCall
    import ctypes

    from .intra_edge import I444_TOP_HAS_RIGHT

    b_dim = BLOCK_DIMENSIONS[bs]
    bw4, bh4 = b_dim[0], b_dim[1]
    p = RefMvsCall()
    p.r = rf.r.ctypes.data
    p.r_stride = rf.r_stride
    p.rp_proj = rf.rp_proj.ctypes.data
    p.rp_stride = rf.rp_stride
    bd = _bdims_np()
    p.bdims = bd.ctypes.data
    for i in range(7):
        p.pocdiff[i] = rf.pocdiff[i]
        p.sign_bias[i] = rf.sign_bias[i]
    p.use_ref_frame_mvs = rf.use_ref_frame_mvs
    p.iw4, p.ih4 = rf.iw4, rf.ih4
    p.col_start, p.col_end = rt.col_start, rt.col_end
    p.row_start, p.row_end = rt.row_start, rt.row_end
    p.bs, p.bw4, p.bh4 = bs, bw4, bh4
    p.bx4, p.by4 = bx4, by4
    p.ref0, p.ref1 = ref_pair[0], ref_pair[1]
    p.edge_has_tr = 1 if (edge_flags & I444_TOP_HAS_RIGHT) else 0
    p.force_integer_mv = 1 if frame_hdr.force_integer_mv else 0
    p.hp = 1 if frame_hdr.hp else 0
    p.use_rfm_hdr = 1 if frame_hdr.use_ref_frame_mvs else 0
    for n in range(2):
        tg = (0, 0)
        gm = INVALID_MV
        if ref_pair[n] > 0:
            tg = get_gmv_2d(
                frame_hdr.gmv[ref_pair[n] - 1], bx4, by4, bw4, bh4, frame_hdr
            )
            if frame_hdr.gmv[ref_pair[n] - 1].type > WarpedMotionType.TRANSLATION:
                gm = tg
        p.tgmv[n][0], p.tgmv[n][1] = tg[0], tg[1]
        p.gmv[n][0], p.gmv[n][1] = gm[0], gm[1]

    LIB_REFMVS.dav1d_refmvs_find(ctypes.byref(p))

    mvstack = [Candidate() for _ in range(8)]
    for i in range(8):
        mvstack[i].mv[0] = [p.out_mv[i][0][0], p.out_mv[i][0][1]]
        mvstack[i].mv[1] = [p.out_mv[i][1][0], p.out_mv[i][1][1]]
        mvstack[i].weight = p.out_weight[i]
    return mvstack, p.out_cnt, p.out_ctx


def refmvs_find(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr):
    """refmvs.rs rav1d_refmvs_find:939.

    Returns (mvstack: [Candidate; 8], cnt, ctx).
    ref_pair: (ref0, ref1) in 1-based refs (0 = intrabc cur frame).
    edge_flags: syntax.intra_edge EdgeFlags of the block.
    """
    from ..native import LIB_REFMVS

    if LIB_REFMVS is not None:
        return refmvs_find_native(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr)
    return refmvs_find_py(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr)


def refmvs_find_py(rt, rf, ref_pair, bs, edge_flags, by4, bx4, frame_hdr):
    """Pure-Python refmvs_find (the correctness anchor for the C core)."""
    from .intra_edge import I444_TOP_HAS_RIGHT

    b_dim = BLOCK_DIMENSIONS[bs]
    bw4 = b_dim[0]
    w4 = min(bw4, 16, rt.col_end - bx4)
    bh4 = b_dim[1]
    h4 = min(bh4, 16, rt.row_end - by4)
    gmv = [INVALID_MV, INVALID_MV]
    tgmv = [(0, 0), (0, 0)]

    mvstack = [Candidate() for _ in range(8)]
    cnt = 0
    if ref_pair[0] > 0:
        tgmv[0] = get_gmv_2d(frame_hdr.gmv[ref_pair[0] - 1], bx4, by4, bw4, bh4, frame_hdr)
        gmv[0] = (
            tgmv[0]
            if frame_hdr.gmv[ref_pair[0] - 1].type > WarpedMotionType.TRANSLATION
            else INVALID_MV
        )
    if ref_pair[1] > 0:
        tgmv[1] = get_gmv_2d(frame_hdr.gmv[ref_pair[1] - 1], bx4, by4, bw4, bh4, frame_hdr)
        gmv[1] = (
            tgmv[1]
            if frame_hdr.gmv[ref_pair[1] - 1].type > WarpedMotionType.TRANSLATION
            else INVALID_MV
        )

    # top row scan
    newmv = [0]  # have_newmv_match, shared across row+col primary scans
    row_mvs = [0]  # have_row_mvs
    col_mvs = [0]  # have_col_mvs
    if by4 > rt.row_start:
        max_rows = min((by4 - rt.row_start + 1) >> 1, 2 + (1 if bh4 > 1 else 0))
        n_rows, cnt = _scan_row(
            mvstack, cnt, ref_pair, gmv, rf, by4 - 1, bx4, bw4, w4, max_rows,
            4 if bw4 >= 16 else 1, newmv, row_mvs,
        )
    else:
        max_rows = 0
        n_rows = -1

    # left column scan
    if bx4 > rt.col_start:
        max_cols = min((bx4 - rt.col_start + 1) >> 1, 2 + (1 if bw4 > 1 else 0))
        n_cols, cnt = _scan_col(
            mvstack, cnt, ref_pair, gmv, rf, by4, bx4 - 1, bh4, h4, max_cols,
            4 if bh4 >= 16 else 1, newmv, col_mvs,
        )
    else:
        max_cols = 0
        n_cols = -1

    # top/right
    if (
        n_rows != -1
        and (edge_flags & I444_TOP_HAS_RIGHT)
        and max(bw4, bh4) <= 16
        and bw4 + bx4 < rt.col_end
    ):
        cnt = _add_spatial_candidate(
            mvstack, cnt, 4, _cand_block(rf, by4 - 1, bx4 + bw4), ref_pair, gmv,
            newmv, row_mvs,
        )

    nearest_match = col_mvs[0] + row_mvs[0]
    nearest_cnt = cnt
    for c in mvstack[:nearest_cnt]:
        c.weight += 640

    # temporal
    globalmv_ctx = frame_hdr.use_ref_frame_mvs
    if rf.use_ref_frame_mvs:
        by8 = by4 >> 1
        bx8 = bx4 >> 1
        step_h = 2 if bw4 >= 16 else 1
        step_v = 2 if bh4 >= 16 else 1
        w8 = min((w4 + 1) >> 1, 8)
        h8 = min((h4 + 1) >> 1, 8)
        for y in range(0, h8, step_v):
            for x in range(0, w8, step_h):
                tb = rf.rp_proj[by8 + y, bx8 + x]
                cnt, gctx = _add_temporal_candidate(
                    rf, mvstack, cnt, tb, ref_pair,
                    tgmv if (x | y) == 0 else None, frame_hdr,
                )
                if gctx is not None:
                    globalmv_ctx = gctx
        if min(bw4, bh4) >= 2 and max(bw4, bh4) < 16:
            bh8 = bh4 >> 1
            bw8 = bw4 >> 1
            yb = by8 + bh8
            has_bottom = yb < min(rt.row_end >> 1, (by8 & ~7) + 8)
            if has_bottom and bx8 - 1 >= max(rt.col_start >> 1, bx8 & ~7):
                cnt, _ = _add_temporal_candidate(
                    rf, mvstack, cnt, rf.rp_proj[yb, bx8 - 1], ref_pair, None, frame_hdr
                )
            if bx8 + bw8 < min(rt.col_end >> 1, (bx8 & ~7) + 8):
                if has_bottom:
                    cnt, _ = _add_temporal_candidate(
                        rf, mvstack, cnt, rf.rp_proj[yb, bx8 + bw8], ref_pair, None, frame_hdr
                    )
                if (by8 + bh8 - 1) < min(rt.row_end >> 1, (by8 & ~7) + 8):
                    cnt, _ = _add_temporal_candidate(
                        rf, mvstack, cnt, rf.rp_proj[yb - 1, bx8 + bw8], ref_pair, None,
                        frame_hdr,
                    )
    assert cnt <= 8

    # top/left (part of "secondary" references: dummy newmv accumulator)
    dummy_newmv = [0]
    if n_rows != -1 and n_cols != -1:
        cnt = _add_spatial_candidate(
            mvstack, cnt, 4, _cand_block(rf, by4 - 1, bx4 - 1), ref_pair, gmv,
            dummy_newmv, row_mvs,
        )

    # secondary (8x8-resolution) top & left edges
    sb_base = by4 - (by4 & 31)
    for n in (2, 3):
        if n_rows != -1 and n > n_rows and n <= max_rows:
            row = sb_base + (((by4 & 31) - 2 * n + 1) | 1)
            d, cnt = _scan_row(
                mvstack, cnt, ref_pair, gmv, rf, row, bx4 | 1, bw4, w4,
                1 + max_rows - n, 4 if bw4 >= 16 else 2, dummy_newmv, row_mvs,
            )
            n_rows += d
        if n_cols != -1 and n > n_cols and n <= max_cols:
            d, cnt = _scan_col(
                mvstack, cnt, ref_pair, gmv, rf, by4 | 1, ((bx4 - n * 2 + 1) | 1), bh4, h4,
                1 + max_cols - n, 4 if bh4 >= 16 else 2, dummy_newmv, col_mvs,
            )
            n_cols += d
    assert cnt <= 8

    ref_match_count = col_mvs[0] + row_mvs[0]
    have_newmv = newmv[0]

    if nearest_match == 0:
        refmv_ctx, newmv_ctx = min(2, ref_match_count), (1 if ref_match_count > 0 else 0)
    elif nearest_match == 1:
        refmv_ctx, newmv_ctx = min(ref_match_count * 3, 4), 3 - have_newmv
    elif nearest_match == 2:
        refmv_ctx, newmv_ctx = 5, 5 - have_newmv
    else:
        refmv_ctx, newmv_ctx = 0, 0

    # stable sort by descending weight, nearest group then secondary group
    mvstack[:nearest_cnt] = sorted(mvstack[:nearest_cnt], key=lambda c: -c.weight)
    mvstack[nearest_cnt:cnt] = sorted(mvstack[nearest_cnt:cnt], key=lambda c: -c.weight)

    if ref_pair[1] > 0:
        if cnt < 2:
            sign0 = rf.sign_bias[ref_pair[0] - 1]
            sign1 = rf.sign_bias[ref_pair[1] - 1]
            sz4 = min(w4, h4)
            cur_cnt = cnt
            same = mvstack[cur_cnt : cur_cnt + 4]
            while len(same) < 4:
                same.append(Candidate())
            same_count = [0, 0, 0, 0]

            if n_rows != -1:
                x = 0
                while x < sz4:
                    cand = _cand_block(rf, by4 - 1, bx4 + x)
                    _add_compound_extended_candidate(
                        same, same_count, cand, sign0, sign1, ref_pair, rf.sign_bias
                    )
                    x += BLOCK_DIMENSIONS[cand[3]][0]
            if n_cols != -1:
                y = 0
                while y < sz4:
                    cand = _cand_block(rf, by4 + y, bx4 - 1)
                    _add_compound_extended_candidate(
                        same, same_count, cand, sign0, sign1, ref_pair, rf.sign_bias
                    )
                    y += BLOCK_DIMENSIONS[cand[3]][1]

            # merge same/diff
            for n in range(2):
                m = same_count[n]
                if m >= 2:
                    continue
                l = same_count[2 + n]
                if l:
                    same[m].mv[n] = list(same[2].mv[n])
                    m += 1
                    if m == 2:
                        continue
                    if l == 2:
                        same[1].mv[n] = list(same[3].mv[n])
                        continue
                for c in same[m:2]:
                    c.mv[n] = list(tgmv[n])

            if cnt == 1 and tuple(mvstack[0].mv[0]) == tuple(same[0].mv[0]) and tuple(
                mvstack[0].mv[1]
            ) == tuple(same[0].mv[1]):
                mvstack[1].mv[0] = list(same[1].mv[0])
                mvstack[1].mv[1] = list(same[1].mv[1])
            for c in mvstack[cnt:2]:
                c.weight = 2
            cnt = 2

        # clamping
        left = -(bx4 + bw4 + 4) * 4 * 8
        right = (rf.iw4 - bx4 + 4) * 4 * 8
        top = -(by4 + bh4 + 4) * 4 * 8
        bottom = (rf.ih4 - by4 + 4) * 4 * 8
        for c in mvstack[:cnt]:
            c.mv[0][0] = _iclip(c.mv[0][0], left, right)
            c.mv[0][1] = _iclip(c.mv[0][1], top, bottom)
            c.mv[1][0] = _iclip(c.mv[1][0], left, right)
            c.mv[1][1] = _iclip(c.mv[1][1], top, bottom)

        rc = refmv_ctx >> 1
        if rc == 0:
            ctx = min(newmv_ctx, 1)
        elif rc == 1:
            ctx = 1 + min(newmv_ctx, 3)
        else:
            ctx = _iclip(3 + newmv_ctx, 4, 7)
        return mvstack, cnt, ctx

    elif cnt < 2 and ref_pair[0] > 0:
        sign = rf.sign_bias[ref_pair[0] - 1]
        sz4 = min(w4, h4)
        if n_rows != -1:
            x = 0
            while x < sz4 and cnt < 2:
                cand = _cand_block(rf, by4 - 1, bx4 + x)
                cnt = _add_single_extended_candidate(mvstack, cnt, cand, sign, rf.sign_bias)
                x += BLOCK_DIMENSIONS[cand[3]][0]
        if n_cols != -1:
            y = 0
            while y < sz4 and cnt < 2:
                cand = _cand_block(rf, by4 + y, bx4 - 1)
                cnt = _add_single_extended_candidate(mvstack, cnt, cand, sign, rf.sign_bias)
                y += BLOCK_DIMENSIONS[cand[3]][1]
    assert cnt <= 8

    if cnt:
        left = -(bx4 + bw4 + 4) * 4 * 8
        right = (rf.iw4 - bx4 + 4) * 4 * 8
        top = -(by4 + bh4 + 4) * 4 * 8
        bottom = (rf.ih4 - by4 + 4) * 4 * 8
        for c in mvstack[:cnt]:
            c.mv[0][0] = _iclip(c.mv[0][0], left, right)
            c.mv[0][1] = _iclip(c.mv[0][1], top, bottom)

    for c in mvstack[min(cnt, 2) : 2]:
        c.mv[0] = list(tgmv[0])

    ctx = (refmv_ctx << 4) | (globalmv_ctx << 3) | newmv_ctx
    return mvstack, cnt, ctx
