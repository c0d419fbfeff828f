"""Deblocking filter lines on torch (port of rav1d_tpu/ops/tpu/lf.py).

All 4-px edge segments of one width class filter as (N, 16) pixel lines in
one shot; AV1 guarantees edges within a direction pass never overlap, so
the batch is bit-exact. Parity: src/loopfilter.rs loop_filter.
"""

from __future__ import annotations

import torch


def filter_lines_batch(px, E, I, H, wd, bpc):
    """px: (N, 16) int32 lines (px[:, 8] = q0); E/I/H: (N,) 8-bit-scale
    thresholds; wd filter width (4/6/8/16). Returns filtered lines."""
    px = px.to(torch.int32)
    off = 8
    bd_min8 = bpc - 8
    F = 1 << bd_min8
    pixel_max = (1 << bpc) - 1
    E = E.to(torch.int32) << bd_min8
    I = I.to(torch.int32) << bd_min8
    H = H.to(torch.int32) << bd_min8

    p1, p0 = px[:, off - 2], px[:, off - 1]
    q0, q1 = px[:, off], px[:, off + 1]
    fm = (
        ((p1 - p0).abs() <= I)
        & ((q1 - q0).abs() <= I)
        & ((p0 - q0).abs() * 2 + ((p1 - q1).abs() >> 1) <= E)
    )
    zero = torch.zeros_like(p0)
    p2 = p3 = q2 = q3 = zero
    if wd > 4:
        p2, q2 = px[:, off - 3], px[:, off + 2]
        fm &= ((p2 - p1).abs() <= I) & ((q2 - q1).abs() <= I)
        if wd > 6:
            p3, q3 = px[:, off - 4], px[:, off + 3]
            fm &= ((p3 - p2).abs() <= I) & ((q3 - q2).abs() <= I)
    out = px.clone()

    flat8in = torch.zeros_like(fm)
    if wd >= 6:
        flat8in = (
            ((p2 - p0).abs() <= F)
            & ((p1 - p0).abs() <= F)
            & ((q1 - q0).abs() <= F)
            & ((q2 - q0).abs() <= F)
        )
    if wd >= 8:
        flat8in &= ((p3 - p0).abs() <= F) & ((q3 - q0).abs() <= F)

    if wd >= 16:
        p6, p5, p4 = px[:, off - 7], px[:, off - 6], px[:, off - 5]
        q4, q5, q6 = px[:, off + 4], px[:, off + 5], px[:, off + 6]
        flat8out = (
            ((p6 - p0).abs() <= F)
            & ((p5 - p0).abs() <= F)
            & ((p4 - p0).abs() <= F)
            & ((q4 - q0).abs() <= F)
            & ((q5 - q0).abs() <= F)
            & ((q6 - q0).abs() <= F)
        )
        m16 = fm & flat8out & flat8in
        vals = [
            (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4,
            (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4,
            (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4,
            (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4,
            (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4,
            (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4,
            (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4,
            (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4,
            (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4,
            (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4,
            (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4,
            (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4,
        ]
        for k, v in enumerate(vals):
            c = off - 6 + k
            out[:, c] = torch.where(m16, v, out[:, c])
        narrow = fm & ~(flat8out & flat8in)
    else:
        narrow = fm

    if wd >= 8:
        m8 = narrow & flat8in
        vals = [
            (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3,
            (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3,
            (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3,
            (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3,
            (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3,
            (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3,
        ]
        for k, v in enumerate(vals):
            c = off - 3 + k
            out[:, c] = torch.where(m8, v, out[:, c])
        narrow = narrow & ~flat8in
    elif wd == 6:
        m6 = narrow & flat8in
        vals = [
            (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3,
            (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
            (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
            (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3,
        ]
        for k, v in enumerate(vals):
            c = off - 2 + k
            out[:, c] = torch.where(m6, v, out[:, c])
        narrow = narrow & ~flat8in

    hev = ((p1 - p0).abs() > H) | ((q1 - q0).abs() > H)
    lim_lo = -128 << bd_min8
    lim_hi = (128 << bd_min8) - 1

    def clipd(v):
        return v.clamp(lim_lo, lim_hi)

    fv_h = clipd(3 * (q0 - p0) + clipd(p1 - q1))
    fv_n = clipd(3 * (q0 - p0))
    fv = torch.where(hev, fv_h, fv_n)
    f1 = (fv + 4).clamp(max=lim_hi) >> 3
    f2 = (fv + 3).clamp(max=lim_hi) >> 3
    np0 = (p0 + f2).clamp(0, pixel_max)
    nq0 = (q0 - f1).clamp(0, pixel_max)
    fv2 = (f1 + 1) >> 1
    np1 = torch.where(hev, p1, (p1 + fv2).clamp(0, pixel_max))
    nq1 = torch.where(hev, q1, (q1 - fv2).clamp(0, pixel_max))
    out[:, off - 2] = torch.where(narrow, np1, out[:, off - 2])
    out[:, off - 1] = torch.where(narrow, np0, out[:, off - 1])
    out[:, off + 0] = torch.where(narrow, nq0, out[:, off + 0])
    out[:, off + 1] = torch.where(narrow, nq1, out[:, off + 1])
    return out
