"""Loop restoration application driver (parity: src/lr_apply.rs).

Whole-frame formulation: in-stripe pixels read from the pre-LR (post-CDEF)
copy, stripe-boundary rows from the post-deblock pre-CDEF copy (what
rav1d's copy_lpf line buffers hold), output written in place.
"""

from __future__ import annotations

import numpy as np

from ..headers import PixelLayout, RestorationType
from ..ops.ref.lr import padding, sgr, wiener


class RestorationUnit:
    __slots__ = ("type", "filter_h", "filter_v", "sgr_idx", "sgr_weights")

    def __init__(self):
        self.type = RestorationType.NONE
        self.filter_h = [3, -7, 15]
        self.filter_v = [3, -7, 15]
        self.sgr_idx = 0
        self.sgr_weights = [-32, 31]

    def copy(self):
        u = RestorationUnit()
        u.type = self.type
        u.filter_h = list(self.filter_h)
        u.filter_v = list(self.filter_v)
        u.sgr_idx = self.sgr_idx
        u.sgr_weights = list(self.sgr_weights)
        return u


def restore_planes_mask(frame_hdr):
    m = 0
    for i, t in enumerate(frame_hdr.restoration.type):
        if t != RestorationType.NONE:
            m |= 1 << i
    return m


def apply_lr(f, pre_cdef):
    """pre_cdef: [y,u,v] post-deblock pre-CDEF plane copies."""
    frame_hdr = f.frame_hdr
    restore_planes = restore_planes_mask(frame_hdr)
    if not restore_planes:
        return
    seq_hdr = f.seq_hdr
    sb128 = seq_hdr.sb128
    layout = f.cur.layout
    sr = f.sr_cur  # restoration runs post-superres (recon.rs filter_sbrow)
    planes = [sr.y, sr.u, sr.v]
    pre_lr = [p.copy() if p is not None else None for p in planes]

    for sby in range(f.sbh):
        offset_y = 8 if sby else 0
        not_last = 1 if sby + 1 < f.sbh else 0
        if restore_planes & 1:
            h = sr.h
            w = sr.w
            next_row_y = (sby + 1) << (6 + sb128)
            row_h = min(next_row_y - 8 * not_last, h)
            y_stripe = (sby << (6 + sb128)) - offset_y
            _lr_sbrow(
                f, planes[0], pre_lr[0], pre_cdef[0], y_stripe, w, h, row_h, 0, sby
            )
        if restore_planes & 6 and layout != PixelLayout.I400:
            ss_ver = 1 if layout == PixelLayout.I420 else 0
            ss_hor = 1 if layout != PixelLayout.I444 else 0
            h = (sr.h + ss_ver) >> ss_ver
            w = (sr.w + ss_hor) >> ss_hor
            next_row_y = (sby + 1) << (6 - ss_ver + sb128)
            row_h = min(next_row_y - (8 >> ss_ver) * not_last, h)
            offset_uv = offset_y >> ss_ver
            y_stripe = (sby << (6 - ss_ver + sb128)) - offset_uv
            if restore_planes & 2:
                _lr_sbrow(
                    f, planes[1], pre_lr[1], pre_cdef[1], y_stripe, w, h, row_h, 1, sby
                )
            if restore_planes & 4:
                _lr_sbrow(
                    f, planes[2], pre_lr[2], pre_cdef[2], y_stripe, w, h, row_h, 2, sby
                )


def _lr_sbrow(f, p, pre_lr, lpf, y, w, h, row_h, plane, sby):
    """src/lr_apply.rs lr_sbrow."""
    frame_hdr = f.frame_hdr
    layout = f.cur.layout
    chroma = 1 if plane else 0
    ss_ver = chroma & (1 if layout == PixelLayout.I420 else 0)
    ss_hor = chroma & (1 if layout != PixelLayout.I444 else 0)
    unit_size_log2 = frame_hdr.restoration.unit_size[1 if plane else 0]
    unit_size = 1 << unit_size_log2
    half_unit = unit_size >> 1
    max_unit_size = unit_size + half_unit

    row_y = y + ((8 >> ss_ver) if y else 0)
    shift_hor = 7 - ss_hor

    aligned_unit_pos = row_y & ~(unit_size - 1)
    if aligned_unit_pos and aligned_unit_pos + half_unit > h:
        aligned_unit_pos -= unit_size
    aligned_unit_pos <<= ss_ver
    sb_idx = (aligned_unit_pos >> 7) * f.sr_sb128w
    unit_idx = ((aligned_unit_pos >> 6) & 1) << 1

    def get_unit(si, ui):
        u = f.lr_units.get((plane, si, ui))
        return u if u is not None else RestorationUnit()

    lr = [get_unit(sb_idx, unit_idx), None]
    restore = lr[0].type != RestorationType.NONE
    x = 0
    bit = 0
    while x + max_unit_size <= w:
        next_x = x + unit_size
        next_u_idx = unit_idx + ((next_x >> (shift_hor - 1)) & 1)
        lr[1 - bit] = get_unit(sb_idx + (next_x >> shift_hor), next_u_idx)
        if restore:
            _lr_stripe(f, p, pre_lr, lpf, x, y, plane, unit_size, row_h, lr[bit], h)
        x = next_x
        restore = lr[1 - bit].type != RestorationType.NONE
        bit = 1 - bit
    if restore:
        _lr_stripe(f, p, pre_lr, lpf, x, y, plane, w - x, row_h, lr[bit], h)


def _lr_stripe(f, p, pre_lr, lpf, x, y, plane, unit_w, row_h, lr, plane_h):
    seq_hdr = f.seq_hdr
    layout = f.cur.layout
    chroma = 1 if plane else 0
    ss_ver = chroma & (1 if layout == PixelLayout.I420 else 0)
    bpc = f.cur.bpc
    stripe_h = min((64 - 8 * (1 if y == 0 else 0)) >> ss_ver, row_h - y)
    have_left_unit = x > 0
    sh = chroma & (1 if layout != PixelLayout.I444 else 0)
    w_plane = (f.sr_cur.w + sh) >> sh
    sby_cur = (y + ((8 << ss_ver) if y else 0)) >> (6 - ss_ver + seq_hdr.sb128)
    have_top = y > 0
    while y + stripe_h <= row_h:
        have_bottom = sby_cur + 1 != f.sbh or y + stripe_h != row_h
        have_right = x + unit_w < w_plane
        tmp = np.zeros((stripe_h + 6, unit_w + 6), dtype=np.int64)
        below = y + stripe_h
        below2 = below if below + 1 == plane_h else below + 1
        padding(
            tmp,
            pre_lr,
            y,
            x,
            pre_lr,
            lpf,
            y - 2,
            below,
            unit_w,
            stripe_h,
            have_left_unit,
            have_right,
            have_top,
            have_bottom,
            lpf_below_y2=below2,
        )
        if lr.type == RestorationType.WIENER:
            wiener(p, y, x, tmp, unit_w, stripe_h, lr.filter_h, lr.filter_v, bpc)
        else:
            sgr(p, y, x, tmp, unit_w, stripe_h, lr.sgr_idx, lr.sgr_weights, bpc)
        y += stripe_h
        have_top = True
        stripe_h = min(64 >> ss_ver, row_h - y)
        if stripe_h == 0:
            break
