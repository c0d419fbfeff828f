"""Loop restoration on torch (port of rav1d_tpu/ops/tpu/lr.py).

Batched 7-tap separable Wiener and self-guided restoration over N padded
stripes at once, each stripe with its own parameters. Parity:
src/looprestoration.rs wiener_rust / sgr_*; every intermediate stays in
int32, with the reference's exact 13-bit split multiplies.
"""

from __future__ import annotations

import torch

from ..engine.consts import tables

I32 = torch.int32


def wiener_batch(tmps, fhs, fvs, w, h, bpc):
    """tmps: (N, h+6, w+6) int32 padded stripes; fhs/fvs: (N, 3) taps.
    Returns (N, h, w) int32 restored pixels."""
    f3h = -(fhs[:, 0] + fhs[:, 1] + fhs[:, 2]) * 2 + (0 if bpc == 8 else 128)
    f3v = 128 - (fvs[:, 0] + fvs[:, 1] + fvs[:, 2]) * 2
    fh = [fhs[:, 0], fhs[:, 1], fhs[:, 2], f3h, fhs[:, 2], fhs[:, 1], fhs[:, 0]]
    fv = [fvs[:, 0], fvs[:, 1], fvs[:, 2], f3v, fvs[:, 2], fvs[:, 1], fvs[:, 0]]

    round_bits_h = 3 + (2 if bpc == 12 else 0)
    rounding_off_h = 1 << (round_bits_h - 1)
    clip_limit = 1 << (bpc + 1 + 7 - round_bits_h)
    t = tmps.to(I32)
    acc = torch.full((t.shape[0], h + 6, w), 1 << (bpc + 6), dtype=I32,
                     device=t.device)
    if bpc == 8:
        acc = acc + t[:, :, 3 : 3 + w] * 128
    for k in range(7):
        acc = acc + t[:, :, k : k + w] * fh[k][:, None, None]
    hor = ((acc + rounding_off_h) >> round_bits_h).clamp(0, clip_limit - 1)

    round_bits_v = 11 - (2 if bpc == 12 else 0)
    rounding_off_v = 1 << (round_bits_v - 1)
    round_offset = 1 << (bpc + round_bits_v - 1)
    acc = torch.full((t.shape[0], h, w), -round_offset, dtype=I32,
                     device=t.device)
    for k in range(7):
        acc = acc + hor[:, k : k + h, :] * fv[k][:, None, None]
    return ((acc + rounding_off_v) >> round_bits_v).clamp(0, (1 << bpc) - 1)


def _pad(x, rows, cols):
    """Zero-pad the last two dims: rows=(top, bottom), cols=(left, right)."""
    return torch.nn.functional.pad(x, (cols[0], cols[1], rows[0], rows[1]))


def _boxsum(tmp, W, H, five):
    """Box sums over the padded stripe (looprestoration.rs boxsum3/5):
    returns (sumsq, sum) with the reference's top-aligned anchoring."""
    s = tmp
    s2 = s * s
    if five:
        vs = s[:, 0 : H - 4] + s[:, 1 : H - 3] + s[:, 2 : H - 2] + s[:, 3 : H - 1] + s[:, 4:H]
        vq = s2[:, 0 : H - 4] + s2[:, 1 : H - 3] + s2[:, 2 : H - 2] + s2[:, 3 : H - 1] + s2[:, 4:H]
    else:
        vs = s[:, 1 : H - 3] + s[:, 2 : H - 2] + s[:, 3 : H - 1]
        vq = s2[:, 1 : H - 3] + s2[:, 2 : H - 2] + s2[:, 3 : H - 1]
    vs = _pad(vs, (1, 3), (0, 0))
    vq = _pad(vq, (1, 3), (0, 0))
    if five:
        os_ = vs[:, :, 0 : W - 4] + vs[:, :, 1 : W - 3] + vs[:, :, 2 : W - 2] + vs[:, :, 3 : W - 1] + vs[:, :, 4:W]
        oq = vq[:, :, 0 : W - 4] + vq[:, :, 1 : W - 3] + vq[:, :, 2 : W - 2] + vq[:, :, 3 : W - 1] + vq[:, :, 4:W]
    else:
        os_ = vs[:, :, 1 : W - 3] + vs[:, :, 2 : W - 2] + vs[:, :, 3 : W - 1]
        oq = vq[:, :, 1 : W - 3] + vq[:, :, 2 : W - 2] + vq[:, :, 3 : W - 1]
    return _pad(oq, (0, 0), (2, 2)), _pad(os_, (0, 0), (2, 2))


def _mul_shift_exact(p, s, sh):
    """Exact (p * s + (1 << (sh-1))) >> sh for products up to ~2^38, kept in
    int32 via a 13-bit split (p, s >= 0)."""
    p_hi = p >> 13
    p_lo = p & 8191
    t1 = (p_lo * s + (1 << (sh - 1))) >> 13
    return (p_hi * s + t1) >> (sh - 13)


def _selfguided(tmp, w, h, n, strengths, bpc):
    """selfguided_filter (looprestoration.rs): tmp (N, h+6, w+6) int32,
    strengths (N,); returns (N, h, w) int32."""
    dev = tmp.device
    obx = 164 if n == 25 else 455
    W, H = w + 6, h + 6
    sumsq, ssum = _boxsum(tmp, W, H, n == 25)
    bdm8 = bpc - 8
    step = 2 if n == 25 else 1
    ys = torch.arange(-1, h + 1, step, device=dev) + 2
    As = sumsq[:, ys, 2 : w + 4]
    Bs = ssum[:, ys, 2 : w + 4]
    a = (As + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
    b = (Bs + ((1 << bdm8) >> 1)) >> bdm8
    p = (a * n - b * b).clamp(min=0)
    z = _mul_shift_exact(p, strengths[:, None, None], 20)
    x = tables(dev)["sgr_x_by_x"][z.clamp(max=255).long()]
    m = x * Bs
    m_hi, m_lo = m >> 12, m & 4095
    A_rows = m_hi * obx + ((m_lo * obx + (1 << 11)) >> 12)
    B_rows = x
    # scatter the strided rows back into full (H) row tables
    A = torch.zeros((tmp.shape[0], H, w + 6), dtype=I32, device=dev)
    B = torch.zeros((tmp.shape[0], H, w + 6), dtype=I32, device=dev)
    A[:, ys, 2 : w + 4] = A_rows
    B[:, ys, 2 : w + 4] = B_rows

    cs = slice(3, w + 3)
    cl = slice(2, w + 2)
    cr = slice(4, w + 4)

    def six(M, yy):
        return (M[:, yy - 1, cs] + M[:, yy + 1, cs]) * 6 + (
            M[:, yy - 1, cl] + M[:, yy + 1, cl]
            + M[:, yy - 1, cr] + M[:, yy + 1, cr]
        ) * 5

    def eight(M, yy):
        return (
            M[:, yy, cs] + M[:, yy, cl] + M[:, yy, cr]
            + M[:, yy - 1, cs] + M[:, yy + 1, cs]
        ) * 4 + (
            M[:, yy - 1, cl] + M[:, yy + 1, cl]
            + M[:, yy - 1, cr] + M[:, yy + 1, cr]
        ) * 3

    if n == 25:
        je = torch.arange(0, h, 2, device=dev)
        yye = je + 2
        aa_e = six(B, yye)
        bb_e = six(A, yye)
        src_e = tmp[:, je + 3, cs]
        out_e = (bb_e - aa_e * src_e + (1 << 8)) >> 9
        jo = torch.arange(1, h, 2, device=dev)
        yyo = jo + 2
        aa_o = B[:, yyo, cs] * 6 + (B[:, yyo, cl] + B[:, yyo, cr]) * 5
        bb_o = A[:, yyo, cs] * 6 + (A[:, yyo, cl] + A[:, yyo, cr]) * 5
        src_o = tmp[:, jo + 3, cs]
        out_o = (bb_o - aa_o * src_o + (1 << 7)) >> 8
        out = torch.zeros((tmp.shape[0], h, w), dtype=I32, device=dev)
        out[:, je, :] = out_e
        out[:, jo, :] = out_o
        return out
    jj = torch.arange(h, device=dev)
    yy = jj + 2
    aa = eight(B, yy)
    bb = eight(A, yy)
    src = tmp[:, jj + 3, cs]
    return (bb - aa * src + (1 << 8)) >> 9


def sgr_batch(cur, tmps, s0s, s1s, w0w1, w, h, kind, bpc):
    """Batched self-guided restoration (looprestoration.rs sgr_5x5/3x3/mix).

    cur: (N, h, w) int32 pre-LR pixels of each stripe; tmps: (N, h+6, w+6)
    padded stripe buffers; s0s/s1s (N,) strengths; w0w1 (N, 2) weights
    (w0, 128 - w0 - w1). kind: 0 = 5x5, 1 = 3x3, 2 = mix. Returns restored
    (N, h, w) int32 pixels."""
    if kind == 0:
        d0 = _selfguided(tmps, w, h, 25, s0s, bpc)
        v = w0w1[:, 0, None, None] * d0
    elif kind == 1:
        d1 = _selfguided(tmps, w, h, 9, s1s, bpc)
        v = w0w1[:, 1, None, None] * d1
    else:
        d0 = _selfguided(tmps, w, h, 25, s0s, bpc)
        d1 = _selfguided(tmps, w, h, 9, s1s, bpc)
        v = w0w1[:, 0, None, None] * d0 + w0w1[:, 1, None, None] * d1
    return (cur + ((v + (1 << 10)) >> 11)).clamp(0, (1 << bpc) - 1)
