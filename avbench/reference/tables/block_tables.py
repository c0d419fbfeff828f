"""Block/transform geometry and context-derivation tables.

AV1 spec constants (parity: src/tables.rs). Most are derivable from the
block-size geometry; all are cross-checked against the reference semantics.
Dimensions are in 4-pixel luma block units.
"""

from __future__ import annotations

from ..syntax.levels import *  # noqa: F401,F403 — table values reference the enums

# block_dimensions[bs] = (w4, h4, log2w4, log2h4)  (src/tables.rs:181)
BLOCK_SIZES_PX = [
    (128, 128), (128, 64), (64, 128), (64, 64), (64, 32), (64, 16),
    (32, 64), (32, 32), (32, 16), (32, 8), (16, 64), (16, 32), (16, 16),
    (16, 8), (16, 4), (8, 32), (8, 16), (8, 8), (8, 4), (4, 16), (4, 8),
    (4, 4),
]

BLOCK_DIMENSIONS = [
    (w // 4, h // 4, (w // 4).bit_length() - 1, (h // 4).bit_length() - 1)
    for (w, h) in BLOCK_SIZES_PX
]

# partition → sub-block sizes: block_sizes[bl][partition] = (bs0, bs1)
# (src/tables.rs:112 dav1d_block_sizes); 255 = unreachable
_X = 255
BLOCK_SIZES = [
    # BL_128X128
    [
        (BS_128x128, _X), (BS_128x64, _X), (BS_64x128, _X), (_X, _X),
        (BS_64x64, BS_128x64), (BS_128x64, BS_64x64),
        (BS_64x64, BS_64x128), (BS_64x128, BS_64x64), (_X, _X), (_X, _X),
    ],
    # BL_64X64
    [
        (BS_64x64, _X), (BS_64x32, _X), (BS_32x64, _X), (_X, _X),
        (BS_32x32, BS_64x32), (BS_64x32, BS_32x32),
        (BS_32x32, BS_32x64), (BS_32x64, BS_32x32),
        (BS_64x16, _X), (BS_16x64, _X),
    ],
    # BL_32X32
    [
        (BS_32x32, _X), (BS_32x16, _X), (BS_16x32, _X), (_X, _X),
        (BS_16x16, BS_32x16), (BS_32x16, BS_16x16),
        (BS_16x16, BS_16x32), (BS_16x32, BS_16x16),
        (BS_32x8, _X), (BS_8x32, _X),
    ],
    # BL_16X16
    [
        (BS_16x16, _X), (BS_16x8, _X), (BS_8x16, _X), (_X, _X),
        (BS_8x8, BS_16x8), (BS_16x8, BS_8x8),
        (BS_8x8, BS_8x16), (BS_8x16, BS_8x8),
        (BS_16x4, _X), (BS_4x16, _X),
    ],
    # BL_8X8
    [
        (BS_8x8, _X), (BS_8x4, _X), (BS_4x8, _X), (BS_4x4, _X),
        (_X, _X), (_X, _X), (_X, _X), (_X, _X), (_X, _X), (_X, _X),
    ],
]

# above/left partition context bits: al_part_ctx[al][bl][partition]
# (src/tables.rs:95)
AL_PART_CTX = [
    [
        [0x00, 0x00, 0x10, 0xFF, 0x00, 0x10, 0x10, 0x10, 0xFF, 0xFF],
        [0x10, 0x10, 0x18, 0xFF, 0x10, 0x18, 0x18, 0x18, 0x10, 0x1C],
        [0x18, 0x18, 0x1C, 0xFF, 0x18, 0x1C, 0x1C, 0x1C, 0x18, 0x1E],
        [0x1C, 0x1C, 0x1E, 0xFF, 0x1C, 0x1E, 0x1E, 0x1E, 0x1C, 0x1F],
        [0x1E, 0x1E, 0x1F, 0x1F, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF],
    ],
    [
        [0x00, 0x10, 0x00, 0xFF, 0x10, 0x10, 0x00, 0x10, 0xFF, 0xFF],
        [0x10, 0x18, 0x10, 0xFF, 0x18, 0x18, 0x10, 0x18, 0x1C, 0x10],
        [0x18, 0x1C, 0x18, 0xFF, 0x1C, 0x1C, 0x18, 0x1C, 0x1E, 0x18],
        [0x1C, 0x1E, 0x1C, 0xFF, 0x1E, 0x1E, 0x1C, 0x1E, 0x1F, 0x1C],
        [0x1E, 0x1F, 0x1E, 0x1F, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF],
    ],
]

# txfm_dimensions[tx] = (w4, h4, lw, lh, min, max, sub, ctx)
# (src/tables.rs:206); sub = next-smaller split size
TXFM_SIZES_PX = [
    (4, 4), (8, 8), (16, 16), (32, 32), (64, 64),  # square TX_*
    (4, 8), (8, 4), (8, 16), (16, 8), (16, 32), (32, 16), (32, 64),
    (64, 32), (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16),
]

_TX_SUB = [
    0, TX_4X4, TX_8X8, TX_16X16, TX_32X32,
    TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
    RTX_4X8, RTX_8X4, RTX_8X16, RTX_16X8, RTX_16X32, RTX_32X16,
]


class TxfmInfo:
    __slots__ = ("w", "h", "lw", "lh", "min", "max", "sub", "ctx")

    def __init__(self, w, h, lw, lh, mn, mx, sub, ctx):
        self.w, self.h, self.lw, self.lh = w, h, lw, lh
        self.min, self.max, self.sub, self.ctx = mn, mx, sub, ctx


TXFM_DIMENSIONS = []
for _i, (_w, _h) in enumerate(TXFM_SIZES_PX):
    _w4, _h4 = _w // 4, _h // 4
    _lw, _lh = _w4.bit_length() - 1, _h4.bit_length() - 1
    _mn, _mx = min(_lw, _lh), max(_lw, _lh)
    _ctx = min(_mx, 4) if _mn == _mx else min(_mx, 4)
    # ctx per reference: (lw + lh + 1) >> 1 clamped — actually it's
    # min(max,4) for squares and min(max,4) for rects except 4xN/Nx4 use
    # the min+1 form. Use the reference values directly:
    TXFM_DIMENSIONS.append(TxfmInfo(_w4, _h4, _lw, _lh, _mn, _mx, _TX_SUB[_i], 0))

# ctx column from the reference table (src/tables.rs:206): used for txsz ctx
_TX_CTX = [0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 1, 1, 2, 2, 3, 3]
for _i, _c in enumerate(_TX_CTX):
    TXFM_DIMENSIONS[_i].ctx = _c

# max_txfm_size_for_bs[bs][layout_idx]  (src/tables.rs:399)
# layout_idx: 0=luma/444, 1=420, 2=422, 3=411? (reference: [4] columns for
# chroma subsampling variants: [0]=luma, then chroma by layout)
MAX_TXFM_SIZE_FOR_BS = [
    (TX_64X64, TX_32X32, TX_32X32, TX_32X32),
    (TX_64X64, TX_32X32, TX_32X32, TX_32X32),
    (TX_64X64, TX_32X32, 0, TX_32X32),
    (TX_64X64, TX_32X32, TX_32X32, TX_32X32),
    (RTX_64X32, RTX_32X16, TX_32X32, TX_32X32),
    (RTX_64X16, RTX_32X8, RTX_32X16, RTX_32X16),
    (RTX_32X64, RTX_16X32, 0, TX_32X32),
    (TX_32X32, TX_16X16, RTX_16X32, TX_32X32),
    (RTX_32X16, RTX_16X8, TX_16X16, RTX_32X16),
    (RTX_32X8, RTX_16X4, RTX_16X8, RTX_32X8),
    (RTX_16X64, RTX_8X32, 0, RTX_16X32),
    (RTX_16X32, RTX_8X16, 0, RTX_16X32),
    (TX_16X16, TX_8X8, RTX_8X16, TX_16X16),
    (RTX_16X8, RTX_8X4, TX_8X8, RTX_16X8),
    (RTX_16X4, RTX_8X4, RTX_8X4, RTX_16X4),
    (RTX_8X32, RTX_4X16, 0, RTX_8X32),
    (RTX_8X16, RTX_4X8, 0, RTX_8X16),
    (TX_8X8, TX_4X4, RTX_4X8, TX_8X8),
    (RTX_8X4, TX_4X4, TX_4X4, RTX_8X4),
    (RTX_4X16, RTX_4X8, 0, RTX_4X16),
    (RTX_4X8, TX_4X4, 0, RTX_4X8),
    (TX_4X4, TX_4X4, TX_4X4, TX_4X4),
]

# uv intra mode → tx type  (src/tables.rs:464)
TXTP_FROM_UVMODE = [
    DCT_DCT,    # DC
    ADST_DCT,   # V
    DCT_ADST,   # H
    DCT_DCT,    # D45 (diag down left)
    ADST_ADST,  # D135
    ADST_DCT,   # D113 (vert right)
    DCT_ADST,   # D157 (hor down)
    DCT_ADST,   # D203 (hor up)
    ADST_DCT,   # D67 (vert left)
    ADST_ADST,  # SMOOTH
    ADST_DCT,   # SMOOTH_V
    DCT_ADST,   # SMOOTH_H
    ADST_ADST,  # PAETH
    0,
]

PARTITION_TYPE_COUNT = [7, 9, 9, 9, 3]

# tx type sets (src/tables.rs:503): offsets into this list select the set
TX_TYPES_PER_SET = [
    # intra set 1 (5): IDTX,DCT,ADST,ADST_DCT,DCT_ADST
    IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    # intra set 2 (7)
    IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    # inter set 1 (9) at offset 12
    IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
    DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST,
    # inter set 2 (16) at offset 24
    IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
    DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST,
]

YMODE_SIZE_CONTEXT = [
    3, 3, 3, 3, 3, 2, 3, 3, 2, 1, 2, 2, 2, 1, 0, 1, 1, 1, 0, 0, 0, 0,
]

# coefficient context offsets (lo_ctx_offsets[tx_class][row%5][col%5])
LO_CTX_OFFSETS = [
    [
        [0, 1, 6, 6, 21],
        [1, 6, 6, 21, 21],
        [6, 6, 21, 21, 21],
        [6, 21, 21, 21, 21],
        [21, 21, 21, 21, 21],
    ],
    [
        [0, 16, 6, 6, 21],
        [16, 16, 6, 21, 21],
        [16, 16, 21, 21, 21],
        [16, 16, 21, 21, 21],
        [16, 16, 21, 21, 21],
    ],
    [
        [0, 11, 11, 11, 11],
        [11, 11, 11, 11, 11],
        [6, 6, 21, 21, 21],
        [6, 21, 21, 21, 21],
        [21, 21, 21, 21, 21],
    ],
]

SKIP_CTX = [
    [1, 2, 2, 2, 3],
    [2, 4, 4, 4, 5],
    [2, 4, 4, 4, 5],
    [2, 4, 4, 4, 5],
    [3, 5, 5, 5, 6],
]

# 2d filter selection: filter_2d[vertical_filter][horizontal_filter]
FILTER_2D = [
    [FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR_SMOOTH, FILTER_2D_8TAP_REGULAR_SHARP, 0],
    [FILTER_2D_8TAP_SMOOTH_REGULAR, FILTER_2D_8TAP_SMOOTH, FILTER_2D_8TAP_SMOOTH_SHARP, 0],
    [FILTER_2D_8TAP_SHARP_REGULAR, FILTER_2D_8TAP_SHARP_SMOOTH, FILTER_2D_8TAP_SHARP, 0],
    [0, 0, 0, FILTER_2D_BILINEAR],
]

# filter_dir[filter2d] = (horizontal 1d filter, vertical 1d filter)
FILTER_DIR = [
    (0, 0), (1, 0), (2, 0), (0, 2), (1, 2), (2, 2), (0, 1), (1, 1), (2, 1), (3, 3),
]

FILTER_MODE_TO_Y_MODE = [DC_PRED, VERT_PRED, HOR_PRED, HOR_DOWN_PRED, DC_PRED]

INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]

WEDGE_CTX_LUT = [0, 0, 0, 0, 0, 0, 0, 6, 5, 8, 0, 4, 3, 2, 0, 7, 1, 0, 0, 0, 0, 0]


def _mask(*sizes):
    m = 0
    for s in sizes:
        m |= 1 << s
    return m


CFL_ALLOWED_MASK = _mask(
    BS_32x32, BS_32x16, BS_32x8, BS_16x32, BS_16x16, BS_16x8, BS_16x4,
    BS_8x32, BS_8x16, BS_8x8, BS_8x4, BS_4x16, BS_4x8, BS_4x4,
)
WEDGE_ALLOWED_MASK = _mask(
    BS_32x32, BS_32x16, BS_32x8, BS_16x32, BS_16x16, BS_16x8,
    BS_8x32, BS_8x16, BS_8x8,
)
INTERINTRA_ALLOWED_MASK = _mask(
    BS_32x32, BS_32x16, BS_16x32, BS_16x16, BS_16x8, BS_8x16, BS_8x8,
)
