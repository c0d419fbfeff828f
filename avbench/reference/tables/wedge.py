"""Wedge and inter-intra blend masks, generated at import time.

Behavior parity: src/wedge.rs (build_master, fill2d_16x2, init_chroma,
build_nondc_ii_masks). These are deterministic spec-defined masks that
dav1d also computes at startup; we generate them with numpy.

WEDGE_MASKS[bs][layout_idx][sign][wedge_idx] -> flat uint8 mask
    layout_idx: 0 = 4:4:4 / luma, 1 = 4:2:2, 2 = 4:2:0
II_MASKS[bs][layout_idx][interintra_mode] -> flat uint8 mask
"""

from __future__ import annotations

import numpy as np

from ..syntax.levels import (
    BS_8x8, BS_8x16, BS_8x32, BS_16x8, BS_16x16, BS_16x32,
    BS_32x8, BS_32x16, BS_32x32, N_BS_SIZES,
)

_HORIZONTAL, _VERTICAL, _OBL27, _OBL63, _OBL117, _OBL153 = range(6)

_MASTER_BORDER = {
    "odd": [1, 2, 6, 18, 37, 53, 60, 63],
    "even": [1, 4, 11, 27, 46, 58, 62, 63],
    "vert": [0, 2, 7, 21, 43, 57, 62, 64],
}


def _insert_border(row, src, ctr):
    if ctr > 4:
        row[: ctr - 4] = 0
    dst_off = max(ctr - 4, 0)
    src_off = max(4 - ctr, 0)
    ln = min(64 - ctr, 8)
    row[dst_off : dst_off + ln] = src[src_off : src_off + ln]
    if ctr + 4 < 64:
        row[ctr + 4 :] = 64


def _build_master():
    master = [np.zeros((64, 64), dtype=np.uint8) for _ in range(6)]
    for y in range(64):
        _insert_border(master[_VERTICAL][y], np.array(_MASTER_BORDER["vert"]), 32)
    for y in range(0, 64, 2):
        ctr = 48 - y // 2
        _insert_border(master[_OBL63][y], np.array(_MASTER_BORDER["even"]), ctr)
        _insert_border(master[_OBL63][y + 1], np.array(_MASTER_BORDER["odd"]), ctr - 1)
    master[_OBL27] = master[_OBL63].T.copy()
    master[_HORIZONTAL] = master[_VERTICAL].T.copy()
    master[_OBL117] = master[_OBL63][:, ::-1].copy()
    master[_OBL153] = master[_OBL27][:, ::-1].copy()
    return master


# wedge codebooks (wedge.rs WedgeCodeBook::build): (x_off, y_off, direction)
_CB_HGTW = [
    (4, 4, _OBL27), (4, 4, _OBL63), (4, 4, _OBL117), (4, 4, _OBL153),
    (4, 2, _HORIZONTAL), (4, 4, _HORIZONTAL), (4, 6, _HORIZONTAL),
    (4, 4, _VERTICAL),
    (4, 2, _OBL27), (4, 6, _OBL27), (4, 2, _OBL153), (4, 6, _OBL153),
    (2, 4, _OBL63), (6, 4, _OBL63), (2, 4, _OBL117), (6, 4, _OBL117),
]
_CB_HLTW = [
    (4, 4, _OBL27), (4, 4, _OBL63), (4, 4, _OBL117), (4, 4, _OBL153),
    (2, 4, _VERTICAL), (4, 4, _VERTICAL), (6, 4, _VERTICAL),
    (4, 4, _HORIZONTAL),
    (4, 2, _OBL27), (4, 6, _OBL27), (4, 2, _OBL153), (4, 6, _OBL153),
    (2, 4, _OBL63), (6, 4, _OBL63), (2, 4, _OBL117), (6, 4, _OBL117),
]
_CB_HEQW = [
    (4, 4, _OBL27), (4, 4, _OBL63), (4, 4, _OBL117), (4, 4, _OBL153),
    (4, 2, _HORIZONTAL), (4, 6, _HORIZONTAL),
    (2, 4, _VERTICAL), (6, 4, _VERTICAL),
    (4, 2, _OBL27), (4, 6, _OBL27), (4, 2, _OBL153), (4, 6, _OBL153),
    (2, 4, _OBL63), (6, 4, _OBL63), (2, 4, _OBL117), (6, 4, _OBL117),
]


def _init_chroma(luma2d, sign, ss_ver):
    """wedge.rs init_chroma: 2:1 (and 2:2 when ss_ver) downsample."""
    l = luma2d.astype(np.uint16)
    pair = l[:, 0::2] + l[:, 1::2] + 1
    if ss_ver:
        s = pair[0::2] + pair[1::2]
        return ((s - sign) >> 2).astype(np.uint8)
    return ((pair - sign) >> 1).astype(np.uint8)


def _build_wedge():
    master = _build_master()
    out = [None] * N_BS_SIZES
    specs = [
        (BS_32x32, 32, 32, 0x7BFB),
        (BS_32x16, 32, 16, 0x7BEB),
        (BS_32x8, 32, 8, 0x6BEB),
        (BS_16x32, 16, 32, 0x7BEB),
        (BS_16x16, 16, 16, 0x7BFB),
        (BS_16x8, 16, 8, 0x7BEB),
        (BS_8x32, 8, 32, 0x7AEB),
        (BS_8x16, 8, 16, 0x7BEB),
        (BS_8x8, 8, 8, 0x7BFB),
    ]
    for bs, w, h, signs in specs:
        if h < w:
            cb = _CB_HLTW
        elif h > w:
            cb = _CB_HGTW
        else:
            cb = _CB_HEQW
        m444 = [[None] * 16, [None] * 16]
        m422 = [[None] * 16, [None] * 16]
        m420 = [[None] * 16, [None] * 16]
        for n in range(16):
            x_off, y_off, d = cb[n]
            xo = 32 - ((w * x_off) >> 3)
            yo = 32 - ((h * y_off) >> 3)
            m444[0][n] = master[d][yo : yo + h, xo : xo + w].copy()
            m444[1][n] = (64 - m444[0][n].astype(np.int16)).astype(np.uint8)
        for n in range(16):
            sign = (signs >> n) & 1
            luma = m444[sign][n]
            m422[sign][n] = _init_chroma(luma, 0, False)
            m422[1 - sign][n] = _init_chroma(luma, 1, False)
            m420[sign][n] = _init_chroma(luma, 0, True)
            m420[1 - sign][n] = _init_chroma(luma, 1, True)
        # externally visible layout (wedge.rs WedgeMasks::slice)
        vis = [[[None] * 16 for _ in range(2)] for _ in range(3)]
        for n in range(16):
            sign = (signs >> n) & 1
            vis[0][0][n] = m444[sign][n].reshape(-1)
            vis[0][1][n] = m444[sign][n].reshape(-1)
            vis[1][0][n] = m422[sign][n].reshape(-1)
            vis[1][1][n] = m422[1 - sign][n].reshape(-1)
            vis[2][0][n] = m420[sign][n].reshape(-1)
            vis[2][1][n] = m420[1 - sign][n].reshape(-1)
        out[bs] = vis
    return out


_II_WEIGHTS_1D = np.array(
    [60, 52, 45, 39, 34, 30, 26, 22, 19, 17, 15, 13, 11, 10, 8, 7, 6, 6, 5,
     4, 4, 3, 3, 2, 2, 2, 2, 1, 1, 1, 1, 1],
    dtype=np.uint8,
)


def _nondc_ii(w, h, step):
    """wedge.rs build_nondc_ii_masks → [vert, hor, smooth] (h, w) arrays."""
    ys = _II_WEIGHTS_1D[np.arange(h) * step]
    xs = _II_WEIGHTS_1D[np.arange(w) * step]
    vert = np.repeat(ys[:, None], w, axis=1)
    hor = np.repeat(xs[None, :], h, axis=0)
    mn = np.minimum(np.arange(w)[None, :], np.arange(h)[:, None])
    smooth = _II_WEIGHTS_1D[mn * step]
    return vert, hor, smooth


def _build_ii():
    out = [None] * N_BS_SIZES
    # per-bs (luma, 422, 420) mask dims (wedge.rs dav1d_ii_masks)
    specs = {
        BS_8x8: [(8, 8, 4), (4, 8, 4), (4, 4, 8)],
        BS_8x16: [(8, 16, 2), (4, 16, 2), (4, 8, 4)],
        BS_16x8: [(16, 16, 2), (8, 8, 4), (8, 8, 4)],
        BS_16x16: [(16, 16, 2), (8, 16, 2), (8, 8, 4)],
        BS_16x32: [(16, 32, 1), (8, 32, 1), (8, 16, 2)],
        BS_32x16: [(32, 32, 1), (16, 16, 2), (16, 16, 2)],
        BS_32x32: [(32, 32, 1), (16, 32, 1), (16, 16, 2)],
    }
    dc = np.full(32 * 32, 32, dtype=np.uint8)
    for bs, dims in specs.items():
        per_layout = []
        for w, h, step in dims:
            vert, hor, smooth = _nondc_ii(w, h, step)
            per_layout.append(
                [dc, vert.reshape(-1), hor.reshape(-1), smooth.reshape(-1)]
            )
        out[bs] = per_layout
    return out


WEDGE_MASKS = _build_wedge()
II_MASKS = _build_ii()
