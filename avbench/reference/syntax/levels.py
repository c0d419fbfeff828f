"""Block-level enums and per-block record types.

Behavior parity: src/levels.rs. The Av1Block record is the unit of the
entropy→recon work-item stream (rav1d's Av1Block, src/levels.rs:Av1Block).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# -- transform sizes (square) ----------------------------------------------
N_TX_SIZES = 5
TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 = range(5)

# -- rectangular transform sizes -------------------------------------------
N_RECT_TX_SIZES = 19
(
    RTX_4X8,
    RTX_8X4,
    RTX_8X16,
    RTX_16X8,
    RTX_16X32,
    RTX_32X16,
    RTX_32X64,
    RTX_64X32,
    RTX_4X16,
    RTX_16X4,
    RTX_8X32,
    RTX_32X8,
    RTX_16X64,
    RTX_64X16,
) = range(5, 19)

# -- transform types --------------------------------------------------------
N_TX_TYPES_PLUS_LL = 17
(
    DCT_DCT,
    ADST_DCT,
    DCT_ADST,
    ADST_ADST,
    FLIPADST_DCT,
    DCT_FLIPADST,
    FLIPADST_FLIPADST,
    ADST_FLIPADST,
    FLIPADST_ADST,
    IDTX,
    V_DCT,
    H_DCT,
    V_ADST,
    H_ADST,
    V_FLIPADST,
    H_FLIPADST,
    WHT_WHT,
) = range(17)

# tx class: how coefficients scan (2-D, vertical-only, horizontal-only)
TX_CLASS_2D, TX_CLASS_H, TX_CLASS_V = range(3)

TX_TYPE_CLASS = [
    TX_CLASS_2D,  # DCT_DCT
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,
    TX_CLASS_2D,  # IDTX
    TX_CLASS_V,  # V_DCT
    TX_CLASS_H,  # H_DCT
    TX_CLASS_V,
    TX_CLASS_H,
    TX_CLASS_V,
    TX_CLASS_H,
    TX_CLASS_2D,  # WHT_WHT
]

# -- intra prediction modes -------------------------------------------------
N_INTRA_PRED_MODES = 13
N_UV_INTRA_PRED_MODES = 14
(
    DC_PRED,
    VERT_PRED,
    HOR_PRED,
    DIAG_DOWN_LEFT_PRED,
    DIAG_DOWN_RIGHT_PRED,
    VERT_RIGHT_PRED,
    HOR_DOWN_PRED,
    HOR_UP_PRED,
    VERT_LEFT_PRED,
    SMOOTH_PRED,
    SMOOTH_V_PRED,
    SMOOTH_H_PRED,
    PAETH_PRED,
) = range(13)
CFL_PRED = 13
# implementation-only DC variants used by the ipred dispatch
LEFT_DC_PRED = 3
TOP_DC_PRED = 4
DC_128_PRED = 5
Z1_PRED = 6
Z2_PRED = 7
Z3_PRED = 8
FILTER_PRED = 13
N_IMPL_INTRA_PRED_MODES = 14

# -- inter prediction modes -------------------------------------------------
NEARESTMV, NEARMV, GLOBALMV, NEWMV = range(4)
N_COMP_INTER_PRED_MODES = 8
(
    NEARESTMV_NEARESTMV,
    NEARMV_NEARMV,
    NEARESTMV_NEWMV,
    NEWMV_NEARESTMV,
    NEARMV_NEWMV,
    NEWMV_NEARMV,
    GLOBALMV_GLOBALMV,
    NEWMV_NEWMV,
) = range(8)

COMP_INTER_PRED_MODES = [
    (NEARESTMV, NEARESTMV),
    (NEARMV, NEARMV),
    (NEARESTMV, NEWMV),
    (NEWMV, NEARESTMV),
    (NEARMV, NEWMV),
    (NEWMV, NEARMV),
    (GLOBALMV, GLOBALMV),
    (NEWMV, NEWMV),
]

# interintra
II_DC_PRED, II_VERT_PRED, II_HOR_PRED, II_SMOOTH_PRED = range(4)

# motion modes
MM_TRANSLATION, MM_OBMC, MM_WARP = range(3)

# comp inter types
COMP_INTER_NONE = 0
COMP_INTER_WEIGHTED_AVG = 1
COMP_INTER_AVG = 2
COMP_INTER_SEG = 3
COMP_INTER_WEDGE = 4

# interintra types
INTER_INTRA_NONE = 0
INTER_INTRA_BLEND = 1
INTER_INTRA_WEDGE = 2

# -- block partitions -------------------------------------------------------
(
    PARTITION_NONE,
    PARTITION_H,
    PARTITION_V,
    PARTITION_SPLIT,
    PARTITION_T_TOP_SPLIT,
    PARTITION_T_BOTTOM_SPLIT,
    PARTITION_T_LEFT_SPLIT,
    PARTITION_T_RIGHT_SPLIT,
    PARTITION_H4,
    PARTITION_V4,
) = range(10)
N_PARTITIONS = 10
N_SUB8X8_PARTITIONS = 4

# -- block levels (BL_*) ----------------------------------------------------
BL_128X128, BL_64X64, BL_32X32, BL_16X16, BL_8X8 = range(5)
N_BL_LEVELS = 5

# -- block sizes (BS_*) -----------------------------------------------------
(
    BS_128x128,
    BS_128x64,
    BS_64x128,
    BS_64x64,
    BS_64x32,
    BS_64x16,
    BS_32x64,
    BS_32x32,
    BS_32x16,
    BS_32x8,
    BS_16x64,
    BS_16x32,
    BS_16x16,
    BS_16x8,
    BS_16x4,
    BS_8x32,
    BS_8x16,
    BS_8x8,
    BS_8x4,
    BS_4x16,
    BS_4x8,
    BS_4x4,
) = range(22)
N_BS_SIZES = 22

# -- filters ---------------------------------------------------------------
(
    FILTER_2D_8TAP_REGULAR,
    FILTER_2D_8TAP_REGULAR_SMOOTH,
    FILTER_2D_8TAP_REGULAR_SHARP,
    FILTER_2D_8TAP_SHARP_REGULAR,
    FILTER_2D_8TAP_SHARP_SMOOTH,
    FILTER_2D_8TAP_SHARP,
    FILTER_2D_8TAP_SMOOTH_REGULAR,
    FILTER_2D_8TAP_SMOOTH,
    FILTER_2D_8TAP_SMOOTH_SHARP,
    FILTER_2D_BILINEAR,
) = range(10)

# mv joints
MV_JOINT_ZERO, MV_JOINT_H, MV_JOINT_V, MV_JOINT_HV = range(4)

# DRL proximity ordering
DRL_NEAREST, DRL_NEARER, DRL_NEAR, DRL_NEARISH = range(4)


@dataclass
class Av1Block:
    """Per-block mode record (the pass-1 → pass-2 work item)."""

    bl: int = 0
    bs: int = 0
    bp: int = 0
    intra: int = 1
    seg_id: int = 0
    skip_mode: int = 0
    skip: int = 0
    uvtx: int = 0
    # intra fields
    y_mode: int = 0
    uv_mode: int = 0
    tx: int = 0
    pal_sz: list = field(default_factory=lambda: [0, 0])
    y_angle: int = 0
    uv_angle: int = 0
    cfl_alpha: list = field(default_factory=lambda: [0, 0])
    # inter fields
    mv: list = field(default_factory=lambda: [(0, 0), (0, 0)])  # (y, x) pairs
    wedge_idx: int = 0
    mask_sign: int = 0
    interintra_mode: int = 0
    mv2d: tuple = (0, 0)
    matrix: list = field(default_factory=lambda: [0, 0, 0, 0])
    comp_type: int = COMP_INTER_NONE
    inter_mode: int = 0
    motion_mode: int = 0
    drl_idx: int = DRL_NEAREST
    ref: list = field(default_factory=lambda: [-1, -1])
    max_ytx: int = 0
    filter2d: int = 0
    interintra_type: int = INTER_INTRA_NONE
    tx_split0: int = 0
    tx_split1: int = 0
