"""Quantizer-matrix tables (parity: src/qm.rs dav1d_qm_tbl:3059).

Base tables are extracted as data (tools_py/extract_spec_tables.py); the
derived per-tx-size tables are generated here like the reference's const
eval: untriangled (triangular-packed squares), transposed rectangles, and
16x16/32x32 subsampling. QM_TBL[qm_level][is_chroma][rect_tx_size] is a
flat uint8 array in the reference's transposed coefficient order (matching
decode_coefs' `rc` indexing), or None.
"""

from __future__ import annotations

import numpy as np

from .spec_data import _NPZ
from ..syntax.levels import (
    TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
    RTX_4X8, RTX_8X4, RTX_8X16, RTX_16X8, RTX_16X32, RTX_32X16,
    RTX_4X16, RTX_16X4, RTX_8X32, RTX_32X8, RTX_16X64, RTX_64X16,
    RTX_32X64, RTX_64X32, N_RECT_TX_SIZES,
)


def _untriangled(src, sz):
    """qm.rs untriangled: expand the triangular-packed symmetric matrix."""
    dst = np.zeros(sz * sz, dtype=np.int32)
    dst_off = 0
    src_off = 0
    for y in range(sz):
        dst[dst_off : dst_off + y + 1] = src[src_off : src_off + y + 1]
        src_ptr_off = y
        for x in range(y + 1, sz):
            src_ptr_off += x
            dst[dst_off + x] = src[src_off + src_ptr_off]
        dst_off += sz
        src_off += y + 1
    return dst


def _transposed(src, w, h):
    return src.reshape(h, w).T.reshape(-1).copy()


def _subsampled(src, sz, step):
    return src.reshape(sz * step, sz * step)[::step, ::step].reshape(-1).copy()


def _build():
    t = {k: _NPZ[k].astype(np.int32) for k in (
        "qm_tbl_4x4_t", "qm_tbl_8x4", "qm_tbl_8x8_t", "qm_tbl_16x4",
        "qm_tbl_16x8", "qm_tbl_32x8", "qm_tbl_32x16", "qm_tbl_32x32_t",
    )}
    n = 15
    tbl = [[[None] * N_RECT_TX_SIZES for _ in range(2)] for _ in range(16)]
    for i in range(n):
        for j in range(2):
            qm_4x4 = _untriangled(t["qm_tbl_4x4_t"][i][j], 4)
            qm_8x8 = _untriangled(t["qm_tbl_8x8_t"][i][j], 8)
            qm_32x32 = _untriangled(t["qm_tbl_32x32_t"][i][j], 32)
            qm_4x8 = _transposed(t["qm_tbl_8x4"][i][j], 8, 4)
            qm_4x16 = _transposed(t["qm_tbl_16x4"][i][j], 16, 4)
            qm_8x16 = _transposed(t["qm_tbl_16x8"][i][j], 16, 8)
            qm_8x32 = _transposed(t["qm_tbl_32x8"][i][j], 32, 8)
            qm_16x32 = _transposed(t["qm_tbl_32x16"][i][j], 32, 16)
            qm_16x16 = _subsampled(qm_32x32, 16, 2)
            row = tbl[i][j]
            # w/h inverted on purpose: coefficients are stored transposed
            # (qm.rs:3070)
            row[RTX_4X8] = t["qm_tbl_8x4"][i][j]
            row[RTX_8X4] = qm_4x8
            row[RTX_4X16] = t["qm_tbl_16x4"][i][j]
            row[RTX_16X4] = qm_4x16
            row[RTX_8X16] = t["qm_tbl_16x8"][i][j]
            row[RTX_16X8] = qm_8x16
            row[RTX_8X32] = t["qm_tbl_32x8"][i][j]
            row[RTX_32X8] = qm_8x32
            row[RTX_16X32] = t["qm_tbl_32x16"][i][j]
            row[RTX_32X16] = qm_16x32
            row[TX_4X4] = qm_4x4
            row[TX_8X8] = qm_8x8
            row[TX_16X16] = qm_16x16
            row[TX_32X32] = qm_32x32
            row[TX_64X64] = qm_32x32
            row[RTX_64X32] = qm_32x32
            row[RTX_64X16] = qm_16x32
            row[RTX_32X64] = qm_32x32
            row[RTX_16X64] = t["qm_tbl_32x16"][i][j]
    return tbl


QM_TBL = _build()
