"""Film grain synthesis (parity: src/filmgrain.rs).

Grain LUT generation (AR-filtered gaussian noise) plus the 32x32-block
noise application with row/column overlap blending. Planes are numpy
arrays; grain LUTs are int32 (GRAIN_HEIGHT+1, GRAIN_WIDTH) arrays.
"""

from __future__ import annotations

import numpy as np

from ...tables.spec_data import GAUSSIAN_SEQUENCE

GRAIN_WIDTH = 82
GRAIN_HEIGHT = 73
BLOCK_SIZE = 32
SUB_GRAIN_WIDTH = 44
SUB_GRAIN_HEIGHT = 38
AR_PAD = 3


def _round2(x, shift):
    return (x + ((1 << shift) >> 1)) >> shift


def _get_random_number(bits, state):
    r = state
    bit = (r ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
    state = (r >> 1) | (bit << 15)
    return (state >> (16 - bits)) & ((1 << bits) - 1), state


def generate_grain_y(data, bpc):
    """filmgrain.rs generate_grain_y_rust. Returns (73+1, 82) int32 LUT."""
    bdm8 = bpc - 8
    seed = data.seed
    shift = 4 - bdm8 + data.grain_scale_shift
    grain_ctr = 128 << bdm8
    buf = np.zeros((GRAIN_HEIGHT + 1, GRAIN_WIDTH), dtype=np.int32)
    gs = GAUSSIAN_SEQUENCE
    for y in range(GRAIN_HEIGHT):
        for x in range(GRAIN_WIDTH):
            v, seed = _get_random_number(11, seed)
            buf[y, x] = _round2(int(gs[v]), shift)

    ar_lag = data.ar_coeff_lag & 3
    coeffs = data.ar_coeffs_y
    for y in range(GRAIN_HEIGHT - AR_PAD):
        for x in range(GRAIN_WIDTH - 2 * AR_PAD):
            s = 0
            ci = 0
            broke = False
            # rows AR_PAD-ar_lag ..= AR_PAD relative to y
            for dy in range(ar_lag + 1):
                row = buf[y + AR_PAD - ar_lag + dy]
                for dx in range(2 * ar_lag + 1):
                    if dx == ar_lag and dy == ar_lag:
                        broke = True
                        break
                    s += int(coeffs[ci]) * int(row[x + AR_PAD - ar_lag + dx])
                    ci += 1
                if broke:
                    break
            gy = y + AR_PAD
            gx = x + AR_PAD
            grain = int(buf[gy, gx]) + _round2(s, data.ar_coeff_shift)
            buf[gy, gx] = min(max(grain, -grain_ctr), grain_ctr - 1)
    return buf


def generate_grain_uv(buf_y, data, is_uv, is_subx, is_suby, bpc):
    """filmgrain.rs generate_grain_uv_rust."""
    uv = 1 if is_uv else 0
    bdm8 = bpc - 8
    seed = data.seed ^ (0x49D8 if is_uv else 0xB524)
    shift = 4 - bdm8 + data.grain_scale_shift
    grain_ctr = 128 << bdm8
    ch = SUB_GRAIN_HEIGHT if is_suby else GRAIN_HEIGHT
    cw = SUB_GRAIN_WIDTH if is_subx else GRAIN_WIDTH
    buf = np.zeros((GRAIN_HEIGHT + 1, GRAIN_WIDTH), dtype=np.int32)
    gs = GAUSSIAN_SEQUENCE
    for y in range(ch):
        for x in range(cw):
            v, seed = _get_random_number(11, seed)
            buf[y, x] = _round2(int(gs[v]), shift)

    ar_lag = data.ar_coeff_lag & 3
    coeffs = data.ar_coeffs_uv[uv]
    suby = 1 if is_suby else 0
    subx = 1 if is_subx else 0
    for y in range(ch - AR_PAD):
        for x in range(cw - 2 * AR_PAD):
            s = 0
            ci = 0
            broke = False
            for dy in range(ar_lag + 1):
                row = buf[y + AR_PAD - ar_lag + dy]
                for dx in range(2 * ar_lag + 1):
                    if dx == ar_lag and dy == ar_lag:
                        luma_y = (y << suby) + AR_PAD
                        luma_x = (x << subx) + AR_PAD
                        luma = 0
                        for i in range(1 + suby):
                            for j in range(1 + subx):
                                luma += int(buf_y[luma_y + i, luma_x + j])
                        luma = _round2(luma, suby + subx)
                        s += luma * int(coeffs[ci])
                        broke = True
                        break
                    s += int(coeffs[ci]) * int(row[x + AR_PAD - ar_lag + dx])
                    ci += 1
                if broke:
                    break
            gy = y + AR_PAD
            gx = x + AR_PAD
            grain = int(buf[gy, gx]) + _round2(s, data.ar_coeff_shift)
            buf[gy, gx] = min(max(grain, -grain_ctr), grain_ctr - 1)
    return buf


def _row_seed(rows, row_num, data):
    seed = [0, 0]
    for i in range(rows):
        s = data.seed
        s ^= (((row_num - i) * 37 + 178) & 0xFF) << 8
        s ^= ((row_num - i) * 173 + 105) & 0xFF
        seed[i] = s
    return seed


def _sample_block(grain_lut, offsets, subx, suby, bx_, by_, bw, bh):
    """Vectorized sample_lut over a (bh, bw) block."""
    randval = offsets[bx_][by_]
    offx = 3 + (2 >> subx) * (3 + (randval >> 4))
    offy = 3 + (2 >> suby) * (3 + (randval & 15))
    oy = offy + (BLOCK_SIZE >> suby) * by_
    ox = offx + (BLOCK_SIZE >> subx) * bx_
    return grain_lut[oy : oy + bh, ox : ox + bw].astype(np.int64)


def fgy_32x32xn(dst, src, data, pw, scaling, grain_lut, bh, row_num, bpc):
    """filmgrain.rs fgy_32x32xn_rust. dst/src: row views (bh, >=pw)."""
    rows = 1 + (1 if (data.overlap_flag and row_num > 0) else 0)
    bdm8 = bpc - 8
    grain_ctr = 128 << bdm8
    grain_min, grain_max = -grain_ctr, grain_ctr - 1
    if data.clip_to_restricted_range:
        min_value, max_value = 16 << bdm8, 235 << bdm8
    else:
        min_value, max_value = 0, (1 << bpc) - 1
    seed = _row_seed(rows, row_num, data)
    offsets = [[0, 0], [0, 0]]
    W = np.array([[27, 17], [17, 27]], dtype=np.int64)
    sc = scaling.astype(np.int64)

    for bx in range(0, pw, BLOCK_SIZE):
        bw = min(BLOCK_SIZE, pw - bx)
        if data.overlap_flag and bx:
            for i in range(rows):
                offsets[1][i] = offsets[0][i]
        for i in range(rows):
            offsets[0][i], seed[i] = _get_random_number(8, seed[i])

        ystart = min(2, bh) if (data.overlap_flag and row_num) else 0
        xstart = min(2, bw) if (data.overlap_flag and bx) else 0

        grain = _sample_block(grain_lut, offsets, 0, 0, 0, 0, bw, bh)
        if xstart:
            old = _sample_block(grain_lut, offsets, 0, 0, 1, 0, xstart, bh)
            g = _round2(old * W[:xstart, 0][None, :] + grain[:, :xstart] * W[:xstart, 1][None, :], 5)
            grain[:, :xstart] = np.clip(g, grain_min, grain_max)
        if ystart:
            old = _sample_block(grain_lut, offsets, 0, 0, 0, 1, bw, ystart)
            if xstart:
                # doubly-overlapped corner: top blended first with top-left
                oldc = _sample_block(grain_lut, offsets, 0, 0, 1, 1, xstart, ystart)
                top = _round2(
                    oldc * W[:xstart, 0][None, :] + old[:, :xstart] * W[:xstart, 1][None, :], 5
                )
                old[:, :xstart] = np.clip(top, grain_min, grain_max)
            g = _round2(old * W[:ystart, 0][:, None] + grain[:ystart, :] * W[:ystart, 1][:, None], 5)
            grain[:ystart, :] = np.clip(g, grain_min, grain_max)

        s = src[:bh, bx : bx + bw].astype(np.int64)
        noise = _round2(sc[s] * grain, data.scaling_shift)
        dst[:bh, bx : bx + bw] = np.clip(s + noise, min_value, max_value)


def fguv_32x32xn(dst, src, data, pw, scaling, grain_lut, bh, row_num, luma,
                 is_uv, is_id, sx, sy, bpc):
    """filmgrain.rs fguv_32x32xn_rust. luma: co-located luma row view."""
    uv = 1 if is_uv else 0
    rows = 1 + (1 if (data.overlap_flag and row_num > 0) else 0)
    bdm8 = bpc - 8
    grain_ctr = 128 << bdm8
    grain_min, grain_max = -grain_ctr, grain_ctr - 1
    if data.clip_to_restricted_range:
        min_value = 16 << bdm8
        max_value = (235 if is_id else 240) << bdm8
    else:
        min_value, max_value = 0, (1 << bpc) - 1
    seed = _row_seed(rows, row_num, data)
    offsets = [[0, 0], [0, 0]]
    W = np.array([[[27, 17], [17, 27]], [[23, 22], [0, 0]]], dtype=np.int64)
    sc = scaling.astype(np.int64)

    for bx in range(0, pw, BLOCK_SIZE >> sx):
        bw = min(BLOCK_SIZE >> sx, pw - bx)
        if data.overlap_flag and bx:
            for i in range(rows):
                offsets[1][i] = offsets[0][i]
        for i in range(rows):
            offsets[0][i], seed[i] = _get_random_number(8, seed[i])

        ystart = min(2 >> sy, bh) if (data.overlap_flag and row_num) else 0
        xstart = min(2 >> sx, bw) if (data.overlap_flag and bx) else 0

        grain = _sample_block(grain_lut, offsets, sx, sy, 0, 0, bw, bh)
        if xstart:
            old = _sample_block(grain_lut, offsets, sx, sy, 1, 0, xstart, bh)
            g = _round2(
                old * W[sx, :xstart, 0][None, :] + grain[:, :xstart] * W[sx, :xstart, 1][None, :],
                5,
            )
            grain[:, :xstart] = np.clip(g, grain_min, grain_max)
        if ystart:
            old = _sample_block(grain_lut, offsets, sx, sy, 0, 1, bw, ystart)
            if xstart:
                oldc = _sample_block(grain_lut, offsets, sx, sy, 1, 1, xstart, ystart)
                top = _round2(
                    oldc * W[sx, :xstart, 0][None, :]
                    + old[:, :xstart] * W[sx, :xstart, 1][None, :],
                    5,
                )
                old[:, :xstart] = np.clip(top, grain_min, grain_max)
            g = _round2(
                old * W[sy, :ystart, 0][:, None] + grain[:ystart, :] * W[sy, :ystart, 1][:, None],
                5,
            )
            grain[:ystart, :] = np.clip(g, grain_min, grain_max)

        # luma average for scaling lookup
        lx = bx << sx
        lum = luma[: bh << sy : 1 << sy, lx : lx + (bw << sx)].astype(np.int64)
        if sx:
            avg = (lum[:, 0::2] + lum[:, 1::2] + 1) >> 1
        else:
            avg = lum
        s = src[:bh, bx : bx + bw].astype(np.int64)
        if not data.chroma_scaling_from_luma:
            combined = avg * data.uv_luma_mult[uv] + s * data.uv_mult[uv]
            val = np.clip(
                (combined >> 6) + data.uv_offset[uv] * (1 << bdm8), 0, (1 << bpc) - 1
            )
        else:
            val = avg
        noise = _round2(sc[val] * grain, data.scaling_shift)
        dst[:bh, bx : bx + bw] = np.clip(s + noise, min_value, max_value)
