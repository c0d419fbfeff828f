"""Out-of-loop film grain application (parity: src/fg_apply.rs).

Returns a NEW picture with grain applied; the reference-slot picture stays
grain-free (grain is applied at output time only).
"""

from __future__ import annotations

import numpy as np

from ..headers import PixelLayout
from ..ops.ref import fg


def generate_scaling(bpc, points):
    """fg_apply.rs generate_scaling."""
    scaling_size = 1 << bpc
    out = np.zeros(scaling_size, dtype=np.uint8)
    if not len(points):
        return out
    shift_x = bpc - 8
    out[: points[0][0] << shift_x] = points[0][1]
    for i in range(len(points) - 1):
        bx, by = points[i]
        ex, ey = points[i + 1]
        dx = ex - bx
        dy = ey - by
        assert dx > 0
        delta = dy * ((0x10000 + (dx >> 1)) // dx)
        d = 0x8000
        for x in range(dx):
            out[(bx + x) << shift_x] = by + (d >> 16)
            d += delta
    n = points[-1][0] << shift_x
    out[n:] = points[-1][1]

    if bpc != 8:
        pad = 1 << shift_x
        rnd = pad >> 1
        for i in range(len(points) - 1):
            bx = points[i][0] << shift_x
            ex = points[i + 1][0] << shift_x
            dx = ex - bx
            for x in range(0, dx, pad):
                rng = int(out[bx + x + pad]) - int(out[bx + x])
                r = rnd
                for k in range(1, pad):
                    r += rng
                    out[bx + x + k] = int(out[bx + x]) + (r >> shift_x)
    return out


def apply_grain(pic):
    """fg_apply.rs rav1d_prep_grain + rav1d_apply_grain_row over all rows."""
    data = pic.frame_hdr.film_grain.data
    seq_hdr = pic.seq_hdr
    bpc = pic.bpc
    layout = pic.layout
    ss_y = 1 if layout == PixelLayout.I420 else 0
    ss_x = 1 if layout != PixelLayout.I444 else 0

    import dataclasses

    out = dataclasses.replace(
        pic,
        y=pic.y.copy(),
        u=pic.u.copy() if pic.u is not None else None,
        v=pic.v.copy() if pic.v is not None else None,
    )

    # grain LUTs
    lut_y = fg.generate_grain_y(data, bpc)
    lut_u = lut_v = None
    if layout != PixelLayout.I400:
        if data.num_uv_points[0] or data.chroma_scaling_from_luma:
            lut_u = fg.generate_grain_uv(lut_y, data, False, ss_x == 1, ss_y == 1, bpc)
        if data.num_uv_points[1] or data.chroma_scaling_from_luma:
            lut_v = fg.generate_grain_uv(lut_y, data, True, ss_x == 1, ss_y == 1, bpc)

    scaling = [
        generate_scaling(bpc, data.y_points[: data.num_y_points]),
        generate_scaling(bpc, data.uv_points[0][: data.num_uv_points[0]]),
        generate_scaling(bpc, data.uv_points[1][: data.num_uv_points[1]]),
    ]

    is_id = seq_hdr.mtrx == 0  # MC_IDENTITY
    w, h = pic.w, pic.h
    cpw = (w + ss_x) >> ss_x

    # extend luma padding column for odd widths (chroma averaging reads it)
    if w & ss_x:
        pic.y[:, w] = pic.y[:, w - 1]

    n_rows = (h + 31) >> 5
    for row in range(n_rows):
        y0 = row * 32
        bh = min(h - y0, 32)
        if data.num_y_points:
            fg.fgy_32x32xn(
                out.y[y0 : y0 + bh], pic.y[y0 : y0 + bh], data, w,
                scaling[0], lut_y, bh, row, bpc,
            )
        if (
            layout == PixelLayout.I400
            or (
                data.num_uv_points[0] == 0
                and data.num_uv_points[1] == 0
                and not data.chroma_scaling_from_luma
            )
        ):
            continue
        cbh = (min(h - y0, 32) + ss_y) >> ss_y
        cy0 = y0 >> ss_y
        luma_row = pic.y[y0:]
        for pl, (lut, dstp, srcp) in enumerate(
            ((lut_u, out.u, pic.u), (lut_v, out.v, pic.v))
        ):
            if data.chroma_scaling_from_luma:
                fg.fguv_32x32xn(
                    dstp[cy0 : cy0 + cbh], srcp[cy0 : cy0 + cbh], data, cpw,
                    scaling[0], lut, cbh, row, luma_row, pl == 1, is_id,
                    ss_x, ss_y, bpc,
                )
            elif data.num_uv_points[pl]:
                fg.fguv_32x32xn(
                    dstp[cy0 : cy0 + cbh], srcp[cy0 : cy0 + cbh], data, cpw,
                    scaling[1 + pl], lut, cbh, row, luma_row, pl == 1, is_id,
                    ss_x, ss_y, bpc,
                )
    return out
