"""Above/left neighbour context state and context-derivation helpers.

Behavior parity: src/env.rs. `a` (above) arrays are tile-wide, indexed by
absolute-in-tile bx4; `l` (left) arrays cover one superblock column (32
4px-units), indexed by by4 & 31.
"""

from __future__ import annotations

import numpy as np

from .levels import *  # noqa: F403

COMP_NONE = 0  # comp_type sentinel in context arrays (0 = no comp/intra)


class BlockContext:
    """Neighbour state arrays (BlockContext, src/env.rs:32-50)."""

    __slots__ = (
        "mode", "lcoef", "ccoef", "seg_pred", "skip", "skip_mode", "intra",
        "comp_type", "ref", "filter", "tx_intra", "tx", "tx_lpf_y",
        "tx_lpf_uv", "partition", "uvmode", "pal_sz",
    )

    def __init__(self, n: int = 32):
        self.mode = [0] * n
        # lcoef/ccoef are numpy so the native decode_coefs reads them by ptr
        self.lcoef = np.full(n, 0x40, dtype=np.uint8)
        self.ccoef = [
            np.full(n, 0x40, dtype=np.uint8),
            np.full(n, 0x40, dtype=np.uint8),
        ]
        self.seg_pred = [0] * n
        self.skip = [0] * n
        self.skip_mode = [0] * n
        self.intra = [0] * n
        self.comp_type = [COMP_NONE] * n
        self.ref = [[-1] * n, [-1] * n]
        self.filter = [[N_SWITCHABLE_FILTERS] * n, [N_SWITCHABLE_FILTERS] * n]
        self.tx_intra = [0] * n
        self.tx = [0] * n
        self.tx_lpf_y = [0] * n
        self.tx_lpf_uv = [0] * n
        self.partition = [0] * (n >> 1)
        self.uvmode = [0] * n
        self.pal_sz = [0] * n


N_SWITCHABLE_FILTERS = 3


def get_intra_ctx(a, l, yb4, xb4, have_top, have_left):
    if have_left:
        if have_top:
            ctx = l.intra[yb4] + a.intra[xb4]
            return ctx + (1 if ctx == 2 else 0)
        return l.intra[yb4] * 2
    return a.intra[xb4] * 2 if have_top else 0


def get_tx_ctx(a, l, max_tx, yb4, xb4):
    return (1 if l.tx_intra[yb4] >= max_tx.lh else 0) + (
        1 if a.tx_intra[xb4] >= max_tx.lw else 0
    )


def get_partition_ctx(a, l, bl, yb8, xb8):
    sh = 4 - bl
    return ((a.partition[xb8] >> sh) & 1) + 2 * ((l.partition[yb8] >> sh) & 1)


def gather_left_partition_prob(cdf, bl):
    cdf = [int(v) for v in cdf]
    # sum of probabilities of partitions with horizontal splits
    out = cdf[PARTITION_H - 1] - cdf[PARTITION_H]
    out += cdf[PARTITION_SPLIT - 1] - cdf[PARTITION_T_LEFT_SPLIT]
    if bl != BL_128X128:
        out += cdf[PARTITION_H4 - 1] - cdf[PARTITION_H4]
    return out & 0xFFFFFFFF


def gather_top_partition_prob(cdf, bl):
    cdf = [int(v) for v in cdf]
    out = cdf[PARTITION_V - 1] - cdf[PARTITION_T_TOP_SPLIT]
    out += cdf[PARTITION_T_LEFT_SPLIT - 1]
    if bl != BL_128X128:
        out += cdf[PARTITION_V4 - 1] - cdf[PARTITION_T_RIGHT_SPLIT]
    return out & 0xFFFFFFFF


def get_uv_inter_txtp(uvt_dim, ytxtp):
    if uvt_dim.max == TX_32X32:
        return IDTX if ytxtp == IDTX else DCT_DCT
    if uvt_dim.min == TX_16X16 and (
        (1 << ytxtp)
        & ((1 << H_FLIPADST) | (1 << V_FLIPADST) | (1 << H_ADST) | (1 << V_ADST))
    ):
        return DCT_DCT
    return ytxtp


def get_filter_ctx(a, l, comp, direction, ref, yb4, xb4):
    if a.ref[0][xb4] == ref or a.ref[1][xb4] == ref:
        a_filter = a.filter[1 if direction else 0][xb4]
    else:
        a_filter = N_SWITCHABLE_FILTERS
    if l.ref[0][yb4] == ref or l.ref[1][yb4] == ref:
        l_filter = l.filter[1 if direction else 0][yb4]
    else:
        l_filter = N_SWITCHABLE_FILTERS
    if a_filter == l_filter:
        val = a_filter
    elif a_filter == N_SWITCHABLE_FILTERS:
        val = l_filter
    elif l_filter == N_SWITCHABLE_FILTERS:
        val = a_filter
    else:
        val = N_SWITCHABLE_FILTERS
    return (4 if comp else 0) + val


def get_comp_ctx(a, l, yb4, xb4, have_top, have_left):
    if have_top:
        if have_left:
            if a.comp_type[xb4]:
                if l.comp_type[yb4]:
                    return 4
                # "(unsigned)ref >= 4" means intra (-1 wraps) or bwd
                return 2 + (1 if (l.ref[0][yb4] & 0xFF) >= 4 else 0)
            elif l.comp_type[yb4]:
                return 2 + (1 if (a.ref[0][xb4] & 0xFF) >= 4 else 0)
            else:
                return 1 if (l.ref[0][yb4] >= 4) != (a.ref[0][xb4] >= 4) else 0
        else:
            return 3 if a.comp_type[xb4] else (1 if a.ref[0][xb4] >= 4 else 0)
    elif have_left:
        return 3 if l.comp_type[yb4] else (1 if l.ref[0][yb4] >= 4 else 0)
    return 1


def _has_uni_comp(edge, off):
    return (edge.ref[0][off] < 4) == (edge.ref[1][off] < 4)


def get_comp_dir_ctx(a, l, yb4, xb4, have_top, have_left):
    if have_top and have_left:
        a_intra = a.intra[xb4] != 0
        l_intra = l.intra[yb4] != 0
        if a_intra and l_intra:
            return 2
        if a_intra or l_intra:
            edge = l if a_intra else a
            off = yb4 if a_intra else xb4
            if not edge.comp_type[off]:
                return 2
            return 1 + 2 * (1 if _has_uni_comp(edge, off) else 0)
        a_comp = bool(a.comp_type[xb4])
        l_comp = bool(l.comp_type[yb4])
        a_ref0 = a.ref[0][xb4]
        l_ref0 = l.ref[0][yb4]
        if not a_comp and not l_comp:
            return 1 + 2 * (1 if (a_ref0 >= 4) == (l_ref0 >= 4) else 0)
        elif not a_comp or not l_comp:
            edge = a if a_comp else l
            off = xb4 if a_comp else yb4
            if not _has_uni_comp(edge, off):
                return 1
            return 3 + (1 if (a_ref0 >= 4) == (l_ref0 >= 4) else 0)
        else:
            a_uni = _has_uni_comp(a, xb4)
            l_uni = _has_uni_comp(l, yb4)
            if not a_uni and not l_uni:
                return 0
            if not a_uni or not l_uni:
                return 2
            return 3 + (1 if (a_ref0 == 4) == (l_ref0 == 4) else 0)
    elif have_top or have_left:
        edge = l if have_left else a
        off = yb4 if have_left else xb4
        if edge.intra[off]:
            return 2
        if not edge.comp_type[off]:
            return 2
        return 4 * (1 if _has_uni_comp(edge, off) else 0)
    return 2


def get_poc_diff(order_hint_n_bits, poc0, poc1):
    if order_hint_n_bits == 0:
        return 0
    mask = 1 << (order_hint_n_bits - 1)
    diff = poc0 - poc1
    return (diff & (mask - 1)) - (diff & mask)


def get_jnt_comp_ctx(order_hint_n_bits, poc, ref0poc, ref1poc, a, l, yb4, xb4):
    d0 = abs(get_poc_diff(order_hint_n_bits, ref0poc, poc))
    d1 = abs(get_poc_diff(order_hint_n_bits, poc, ref1poc))
    offset = 1 if d0 == d1 else 0
    a_ctx = 1 if (a.comp_type[xb4] >= COMP_INTER_AVG or a.ref[0][xb4] == 6) else 0
    l_ctx = 1 if (l.comp_type[yb4] >= COMP_INTER_AVG or l.ref[0][yb4] == 6) else 0
    return 3 * offset + a_ctx + l_ctx


def get_mask_comp_ctx(a, l, yb4, xb4):
    a_ctx = 1 if a.comp_type[xb4] >= COMP_INTER_SEG else (3 if a.ref[0][xb4] == 6 else 0)
    l_ctx = 1 if l.comp_type[yb4] >= COMP_INTER_SEG else (3 if l.ref[0][yb4] == 6 else 0)
    return min(a_ctx + l_ctx, 5)


def _cmp_counts(c1, c2):
    return 0 if c1 < c2 else (1 if c1 == c2 else 2)


def av1_get_ref_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0]
    if have_top and not a.intra[xb4]:
        cnt[1 if a.ref[0][xb4] >= 4 else 0] += 1
        if a.comp_type[xb4]:
            cnt[1 if a.ref[1][xb4] >= 4 else 0] += 1
    if have_left and not l.intra[yb4]:
        cnt[1 if l.ref[0][yb4] >= 4 else 0] += 1
        if l.comp_type[yb4]:
            cnt[1 if l.ref[1][yb4] >= 4 else 0] += 1
    return _cmp_counts(cnt[0], cnt[1])


def av1_get_fwd_ref_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0, 0, 0]
    if have_top and not a.intra[xb4]:
        if a.ref[0][xb4] < 4:
            cnt[a.ref[0][xb4]] += 1
        if a.comp_type[xb4] and a.ref[1][xb4] < 4:
            cnt[a.ref[1][xb4]] += 1
    if have_left and not l.intra[yb4]:
        if l.ref[0][yb4] < 4:
            cnt[l.ref[0][yb4]] += 1
        if l.comp_type[yb4] and l.ref[1][yb4] < 4:
            cnt[l.ref[1][yb4]] += 1
    return _cmp_counts(cnt[0] + cnt[1], cnt[2] + cnt[3])


def av1_get_fwd_ref_1_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0]
    if have_top and not a.intra[xb4]:
        if 0 <= a.ref[0][xb4] < 2:
            cnt[a.ref[0][xb4]] += 1
        if a.comp_type[xb4] and 0 <= a.ref[1][xb4] < 2:
            cnt[a.ref[1][xb4]] += 1
    if have_left and not l.intra[yb4]:
        if 0 <= l.ref[0][yb4] < 2:
            cnt[l.ref[0][yb4]] += 1
        if l.comp_type[yb4] and 0 <= l.ref[1][yb4] < 2:
            cnt[l.ref[1][yb4]] += 1
    return _cmp_counts(cnt[0], cnt[1])


def av1_get_fwd_ref_2_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0]
    if have_top and not a.intra[xb4]:
        if (a.ref[0][xb4] ^ 2) < 2 and a.ref[0][xb4] >= 2:
            cnt[a.ref[0][xb4] - 2] += 1
        if a.comp_type[xb4] and (a.ref[1][xb4] ^ 2) < 2 and a.ref[1][xb4] >= 2:
            cnt[a.ref[1][xb4] - 2] += 1
    if have_left and not l.intra[yb4]:
        if (l.ref[0][yb4] ^ 2) < 2 and l.ref[0][yb4] >= 2:
            cnt[l.ref[0][yb4] - 2] += 1
        if l.comp_type[yb4] and (l.ref[1][yb4] ^ 2) < 2 and l.ref[1][yb4] >= 2:
            cnt[l.ref[1][yb4] - 2] += 1
    return _cmp_counts(cnt[0], cnt[1])


def av1_get_bwd_ref_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0, 0]
    if have_top and not a.intra[xb4]:
        if a.ref[0][xb4] >= 4:
            cnt[a.ref[0][xb4] - 4] += 1
        if a.comp_type[xb4] and a.ref[1][xb4] >= 4:
            cnt[a.ref[1][xb4] - 4] += 1
    if have_left and not l.intra[yb4]:
        if l.ref[0][yb4] >= 4:
            cnt[l.ref[0][yb4] - 4] += 1
        if l.comp_type[yb4] and l.ref[1][yb4] >= 4:
            cnt[l.ref[1][yb4] - 4] += 1
    return _cmp_counts(cnt[1] + cnt[0], cnt[2])


def av1_get_bwd_ref_1_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0, 0]
    if have_top and not a.intra[xb4]:
        if a.ref[0][xb4] >= 4:
            cnt[a.ref[0][xb4] - 4] += 1
        if a.comp_type[xb4] and a.ref[1][xb4] >= 4:
            cnt[a.ref[1][xb4] - 4] += 1
    if have_left and not l.intra[yb4]:
        if l.ref[0][yb4] >= 4:
            cnt[l.ref[0][yb4] - 4] += 1
        if l.comp_type[yb4] and l.ref[1][yb4] >= 4:
            cnt[l.ref[1][yb4] - 4] += 1
    return _cmp_counts(cnt[0], cnt[1])


def av1_get_uni_p1_ctx(a, l, yb4, xb4, have_top, have_left):
    cnt = [0, 0, 0]
    if have_top and not a.intra[xb4]:
        r = a.ref[0][xb4] - 1
        if 0 <= r < 3:
            cnt[r] += 1
        if a.comp_type[xb4]:
            r = a.ref[1][xb4] - 1
            if 0 <= r < 3:
                cnt[r] += 1
    if have_left and not l.intra[yb4]:
        r = l.ref[0][yb4] - 1
        if 0 <= r < 3:
            cnt[r] += 1
        if l.comp_type[yb4]:
            r = l.ref[1][yb4] - 1
            if 0 <= r < 3:
                cnt[r] += 1
    return _cmp_counts(cnt[0], cnt[1] + cnt[2])


def get_drl_context(ref_mv_stack, ref_idx):
    if ref_mv_stack[ref_idx][1] >= 640:
        return 1 if ref_mv_stack[ref_idx + 1][1] < 640 else 0
    return 2 if ref_mv_stack[ref_idx + 1][1] < 640 else 0


def get_cur_frame_segid(bx, by, have_top, have_left, cur_seg_map, stride):
    """Returns (seg_id, seg_ctx) (src/env.rs get_cur_frame_segid)."""
    offset = bx + by * stride - (1 if have_left else 0) - (stride if have_top else 0)
    if have_left and have_top:
        l = cur_seg_map[offset + stride]
        a = cur_seg_map[offset + 1]
        al = cur_seg_map[offset]
        if l == a == al:
            seg_ctx = 2
        elif l == a or al == l or a == al:
            seg_ctx = 1
        else:
            seg_ctx = 0
        return (a if a == al else l), seg_ctx
    if have_left or have_top:
        return cur_seg_map[offset], 0
    return 0, 0


def _i16(v):
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def fix_int_mv_precision(x, y):
    x = (x - (x >> 15) + 3) & ~7
    y = (y - (y >> 15) + 3) & ~7
    return _i16(x), _i16(y)


def fix_mv_precision(hdr, x, y):
    if hdr.force_integer_mv:
        return fix_int_mv_precision(x, y)
    if not hdr.hp:
        return _i16((x - (x >> 15)) & ~1), _i16((y - (y >> 15)) & ~1)
    return x, y


def _apply_sign(v, s):
    return -v if s < 0 else v


def get_gmv_2d(gmv, bx4, by4, bw4, bh4, hdr):
    """Project the global motion model at block center → (mv_x, mv_y)."""
    from ..headers import WarpedMotionType

    if gmv.type == WarpedMotionType.TRANSLATION:
        x, y = gmv.matrix[1] >> 13, gmv.matrix[0] >> 13
        if hdr.force_integer_mv:
            x, y = fix_int_mv_precision(x, y)
        return _i16(x), _i16(y)
    if gmv.type == WarpedMotionType.IDENTITY:
        return 0, 0
    x = bx4 * 4 + bw4 * 2 - 1
    y = by4 * 4 + bh4 * 2 - 1
    xc = (gmv.matrix[2] - (1 << 16)) * x + gmv.matrix[3] * y + gmv.matrix[0]
    yc = (gmv.matrix[5] - (1 << 16)) * y + gmv.matrix[4] * x + gmv.matrix[1]
    shift = 16 - (3 - (0 if hdr.hp else 1))
    rnd = (1 << shift) >> 1
    sh2 = 0 if hdr.hp else 1
    mx = _apply_sign(((abs(xc) + rnd) >> shift) << sh2, xc)
    my = _apply_sign(((abs(yc) + rnd) >> shift) << sh2, yc)
    if hdr.force_integer_mv:
        mx, my = fix_int_mv_precision(mx, my)
    return _i16(mx), _i16(my)
