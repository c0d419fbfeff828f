"""Intra-edge availability tree.

For each node of the recursive partition, precompute which top-right /
bottom-left neighbour edges are available for intra prediction, per chroma
layout. Behavior parity: src/intra_edge.rs (EdgeFlags, EdgeTip/EdgeBranch
trees for 64- and 128-px superblocks).
"""

from __future__ import annotations

from .levels import BL_128X128, BL_16X16, BL_32X32, BL_64X64

# EdgeFlags bits
I444_TOP_HAS_RIGHT = 1 << 0
I422_TOP_HAS_RIGHT = 1 << 1
I420_TOP_HAS_RIGHT = 1 << 2
I444_LEFT_HAS_BOTTOM = 1 << 3
I422_LEFT_HAS_BOTTOM = 1 << 4
I420_LEFT_HAS_BOTTOM = 1 << 5

ALL_TOP_HAS_RIGHT = I444_TOP_HAS_RIGHT | I422_TOP_HAS_RIGHT | I420_TOP_HAS_RIGHT
ALL_LEFT_HAS_BOTTOM = (
    I444_LEFT_HAS_BOTTOM | I422_LEFT_HAS_BOTTOM | I420_LEFT_HAS_BOTTOM
)
ALL_TR_AND_BL = ALL_TOP_HAS_RIGHT | ALL_LEFT_HAS_BOTTOM


def edge_flags_for_layout(flags: int, layout: int) -> int:
    """flags >> (layout - 1): selects the layout-specific bits
    (EdgeFlags::Shr<Rav1dPixelLayout>, src/intra_edge.rs:58)."""
    return flags >> (layout - 1)


class EdgeNode:
    __slots__ = ("o", "h", "v")

    def __init__(self, flags: int):
        self.o = flags
        self.h = [flags | ALL_LEFT_HAS_BOTTOM, flags & ALL_LEFT_HAS_BOTTOM]
        self.v = [flags | ALL_TOP_HAS_RIGHT, flags & ALL_TOP_HAS_RIGHT]


class EdgeTip(EdgeNode):
    __slots__ = ("split",)

    def __init__(self, flags: int):
        super().__init__(flags)
        # tips override h[1]/v[1] with layout-aware variants
        self.h = [
            flags | ALL_LEFT_HAS_BOTTOM,
            flags & (ALL_LEFT_HAS_BOTTOM | I420_TOP_HAS_RIGHT),
        ]
        self.v = [
            flags | ALL_TOP_HAS_RIGHT,
            flags
            & (ALL_TOP_HAS_RIGHT | I420_LEFT_HAS_BOTTOM | I422_LEFT_HAS_BOTTOM),
        ]
        self.split = [
            (flags & ALL_TOP_HAS_RIGHT) | I422_LEFT_HAS_BOTTOM,
            flags | I444_TOP_HAS_RIGHT,
            flags
            & (I420_TOP_HAS_RIGHT | I420_LEFT_HAS_BOTTOM | I422_LEFT_HAS_BOTTOM),
        ]


class EdgeBranch(EdgeNode):
    __slots__ = ("h4", "v4", "split")

    def __init__(self, flags: int, bl: int):
        super().__init__(flags)
        self.h4 = (
            (flags & I420_TOP_HAS_RIGHT if bl == BL_16X16 else 0)
            | ALL_LEFT_HAS_BOTTOM
        )
        self.v4 = (
            (
                flags & (I420_LEFT_HAS_BOTTOM | I422_LEFT_HAS_BOTTOM)
                if bl == BL_16X16
                else 0
            )
            | ALL_TOP_HAS_RIGHT
        )
        self.split = [None] * 4  # child nodes


def _build(root_bl: int) -> EdgeBranch:
    """Build the edge tree rooted at root_bl (BL_128X128 or BL_64X64)."""

    def make(bl: int, top_has_right: bool, left_has_bottom: bool):
        flags = (ALL_TOP_HAS_RIGHT if top_has_right else 0) | (
            ALL_LEFT_HAS_BOTTOM if left_has_bottom else 0
        )
        branch = EdgeBranch(flags, bl)
        for n in range(4):
            thr = not (n == 3 or (n == 1 and not top_has_right))
            lhb = n == 0 or (n == 2 and left_has_bottom)
            if bl == BL_16X16:
                tip_flags = (ALL_TOP_HAS_RIGHT if thr else 0) | (
                    ALL_LEFT_HAS_BOTTOM if lhb else 0
                )
                branch.split[n] = EdgeTip(tip_flags)
            else:
                branch.split[n] = make(bl + 1, thr, lhb)
        return branch

    return make(root_bl, True, False)


_ROOT_SB128 = _build(BL_128X128)
_ROOT_SB64 = _build(BL_64X64)


def root(sb128: bool):
    return _ROOT_SB128 if sb128 else _ROOT_SB64
