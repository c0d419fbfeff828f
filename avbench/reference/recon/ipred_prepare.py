"""Intra prediction edge assembly (behavior parity: src/ipred_prepare.rs).

Builds the 257-entry top-left edge buffer (top-left sample at index 128)
with the AV1 availability/fallback/filtering rules, and remaps the coding
mode to the implementation mode (DC variants, Z1/Z2/Z3).
"""

from __future__ import annotations

import numpy as np

from ..syntax.levels import (
    DC_128_PRED,
    DC_PRED,
    FILTER_PRED,
    HOR_PRED,
    LEFT_DC_PRED,
    PAETH_PRED,
    SMOOTH_H_PRED,
    SMOOTH_PRED,
    SMOOTH_V_PRED,
    TOP_DC_PRED,
    VERT_LEFT_PRED,
    VERT_PRED,
    Z1_PRED,
    Z2_PRED,
    Z3_PRED,
)
from ..syntax.intra_edge import I444_LEFT_HAS_BOTTOM, I444_TOP_HAS_RIGHT

EDGE_OFF = 128  # top-left sample position in the edge buffer

# mode remap under (have_left, have_top) for DC and PAETH
_MODE_CONV = {
    DC_PRED: [[DC_128_PRED, TOP_DC_PRED], [LEFT_DC_PRED, DC_PRED]],
    PAETH_PRED: [[DC_128_PRED, VERT_PRED], [HOR_PRED, PAETH_PRED]],
}

_MODE_TO_ANGLE = [90, 180, 45, 135, 113, 157, 203, 67]  # VERT..VERT_LEFT

# per-implementation-mode edge requirements
NEED_LEFT = 1 << 0
NEED_TOP = 1 << 1
NEED_TOP_LEFT = 1 << 2
NEED_TOP_RIGHT = 1 << 3
NEED_BOTTOM_LEFT = 1 << 4

_NEEDS = [0] * 14
_NEEDS[DC_PRED] = NEED_TOP | NEED_LEFT
_NEEDS[VERT_PRED] = NEED_TOP
_NEEDS[HOR_PRED] = NEED_LEFT
_NEEDS[LEFT_DC_PRED] = NEED_LEFT
_NEEDS[TOP_DC_PRED] = NEED_TOP
_NEEDS[DC_128_PRED] = 0
_NEEDS[Z1_PRED] = NEED_TOP | NEED_TOP_RIGHT | NEED_TOP_LEFT
_NEEDS[Z2_PRED] = NEED_LEFT | NEED_TOP | NEED_TOP_LEFT
_NEEDS[Z3_PRED] = NEED_LEFT | NEED_BOTTOM_LEFT | NEED_TOP_LEFT
_NEEDS[SMOOTH_PRED] = NEED_LEFT | NEED_TOP
_NEEDS[SMOOTH_V_PRED] = NEED_LEFT | NEED_TOP
_NEEDS[SMOOTH_H_PRED] = NEED_LEFT | NEED_TOP
_NEEDS[PAETH_PRED] = NEED_LEFT | NEED_TOP | NEED_TOP_LEFT
_NEEDS[FILTER_PRED] = NEED_LEFT | NEED_TOP | NEED_TOP_LEFT


def prepare_intra_edges(
    x,
    have_left,
    y,
    have_top,
    w,
    h,
    edge_flags,
    plane,  # full numpy plane (padded)
    top_sb_edge,  # 1-D array of the row above this superblock, or None
    mode,
    angle,
    tw,
    th,
    filter_edge,
    edge_buf,  # int32 array len >= 257
    bpc,
):
    """Returns (impl_mode, angle). x/y/w/h in 4px blocks; tw/th tx dims in
    4px units. plane is indexed [row, col] in pixels."""
    assert y < h and x < w
    bitdepth = bpc

    px_x, px_y = 4 * x, 4 * y

    if VERT_PRED <= mode <= VERT_LEFT_PRED:
        angle = _MODE_TO_ANGLE[mode - VERT_PRED] + 3 * angle
        if angle <= 90:
            mode = Z1_PRED if angle < 90 and have_top else VERT_PRED
        elif angle < 180:
            mode = Z2_PRED
        else:
            mode = Z3_PRED if angle > 180 and have_left else HOR_PRED
    elif mode in (DC_PRED, PAETH_PRED):
        mode = _MODE_CONV[mode][1 if have_left else 0][1 if have_top else 0]

    needs = _NEEDS[mode]

    # row of pixels directly above the block (with optional top-left sample)
    def top_row(n, with_left):
        if top_sb_edge is not None:
            start = px_x - (1 if with_left else 0)
            return top_sb_edge[start : start + n]
        return plane[px_y - 1, px_x - (1 if with_left else 0) :][:n]

    dst_top = None
    if have_top and (
        needs & NEED_TOP
        or needs & NEED_TOP_LEFT
        or (needs & NEED_LEFT and not have_left)
    ):
        px_have = min(8 * tw, 4 * (w - x))
        dst_top = top_row(px_have + (1 if have_left else 0), have_left)

    if needs & NEED_LEFT:
        sz = 4 * th
        left_base = EDGE_OFF - sz
        if have_left:
            px_have = min(sz, (h - y) << 2)
            for i in range(px_have):
                edge_buf[EDGE_OFF - 1 - i] = plane[px_y + i, px_x - 1]
            if px_have < sz:
                edge_buf[left_base : EDGE_OFF - px_have] = edge_buf[
                    EDGE_OFF - px_have
                ]
        else:
            fill = (
                int(dst_top[0])
                if have_top
                else ((1 << bitdepth) >> 1) + 1
            )
            edge_buf[left_base:EDGE_OFF] = fill
        if needs & NEED_BOTTOM_LEFT:
            bl_base = EDGE_OFF - 2 * sz
            have_bl = (
                have_left
                and y + th < h
                and bool(edge_flags & I444_LEFT_HAS_BOTTOM)
            )
            if have_bl:
                px_have = min(sz, (h - y - th) << 2)
                for i in range(px_have):
                    edge_buf[left_base - 1 - i] = plane[px_y + sz + i, px_x - 1]
                if px_have < sz:
                    edge_buf[bl_base : left_base - px_have] = edge_buf[
                        left_base - px_have
                    ]
            else:
                edge_buf[bl_base:left_base] = edge_buf[left_base]

    if needs & NEED_TOP:
        sz = 4 * tw
        top_base = EDGE_OFF + 1
        if have_top:
            px_have = min(sz, (w - x) << 2)
            src = dst_top[(1 if have_left else 0) :][:px_have]
            edge_buf[top_base : top_base + px_have] = src
            if px_have < sz:
                edge_buf[top_base + px_have : top_base + sz] = edge_buf[
                    top_base + px_have - 1
                ]
        else:
            fill = (
                int(plane[px_y, px_x - 1])
                if have_left
                else ((1 << bitdepth) >> 1) - 1
            )
            edge_buf[top_base : top_base + sz] = fill
        if needs & NEED_TOP_RIGHT:
            have_tr = (
                have_top
                and x + tw < w
                and bool(edge_flags & I444_TOP_HAS_RIGHT)
            )
            if have_tr:
                px_have = min(sz, (w - x - tw) << 2)
                tr = top_row(
                    sz + (1 if have_left else 0) + px_have, have_left
                )[sz + (1 if have_left else 0) :][:px_have]
                edge_buf[top_base + sz : top_base + sz + px_have] = tr
                if px_have < sz:
                    edge_buf[top_base + sz + px_have : top_base + 2 * sz] = (
                        edge_buf[top_base + sz + px_have - 1]
                    )
            else:
                edge_buf[top_base + sz : top_base + 2 * sz] = edge_buf[
                    top_base + sz - 1
                ]

    if needs & NEED_TOP_LEFT:
        if have_top:
            edge_buf[EDGE_OFF] = dst_top[0]
        elif have_left:
            edge_buf[EDGE_OFF] = plane[px_y, px_x - 1]
        else:
            edge_buf[EDGE_OFF] = (1 << bitdepth) >> 1
        if mode == Z2_PRED and tw + th >= 6 and filter_edge:
            edge_buf[EDGE_OFF] = (
                (int(edge_buf[EDGE_OFF - 1]) + int(edge_buf[EDGE_OFF + 1])) * 5
                + int(edge_buf[EDGE_OFF]) * 6
                + 8
            ) >> 4

    return mode, angle
