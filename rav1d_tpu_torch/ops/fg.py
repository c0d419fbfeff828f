"""Film grain on torch: the plain versions of the grain step (port of
rav1d_tpu/ops/tpu/fg.py).

`fg_blend_batch` is the JAX function's twin: the per-pixel scaling lookup,
the grain multiply with its rounding, and the clip, over a batch of
blocks. `grain_frame_plain` is the whole grain step of a picture on whole
planes: what recon/fg_apply.py apply_grain computes block by block
(parity: src/filmgrain.rs fgy_32x32xn_rust, fguv_32x32xn_rust), from the
host tables of engine/grain.py (GrainTables). It is the plain version of
csrc/fg.cu rav1d_fg_frame (ops/cuda/grain.py grain_frame): the CPU engine
runs it, and chip_smoke.py holds the kernel to it; a decoder on a card
runs neither.

Per pixel (y, x) of a plane with grain, its 32x32 luma block (row r,
column c; 32 >> ss pixels a side on a subsampled chroma plane) and the
block's 8-bit random value rv give the offset into the plane's grain
table: (3 + (2 >> ss_y) * (3 + (rv & 15)), 3 + (2 >> ss_x) * (3 +
(rv >> 4))). With overlap_flag the first 2 >> ss_x columns of a block
blend in the left block's grain past its edge, and the first 2 >> ss_y
rows the top block's (itself first blended with the top-left block's at
the corner), each blend round2(old * w0 + new * w1, 5) clipped to the
grain range, weights (27, 17), (17, 27), or (23, 22) on a subsampled
axis. Then noise = round2(scaling[v] * grain, scaling_shift) with v the
pixel (luma), or the co-located luma average (chroma_scaling_from_luma),
or clip(((avg * uv_luma_mult + src * uv_mult) >> 6) + (uv_offset <<
(bpc - 8))), and the output pixel is clip(src + noise) to the plane's
range. Every other pixel of the padded planes is copied.
"""

from __future__ import annotations

import torch

I32 = torch.int32
GRAIN_W = 82  # ops/ref/fg.py GRAIN_WIDTH: the tables' row length
# blend weights (old, new) by subsampling and position in the overlap
WEIGHTS = {0: ((27, 17), (17, 27)), 1: ((23, 22), (0, 0))}


def _round2(x, shift):
    return (x + ((1 << shift) >> 1)) >> shift


def _noise_add(src, val, grain, scaling, scaling_shift, min_value, max_value):
    """clip(src + round2(scaling[val] * grain, scaling_shift)), int32."""
    sc = scaling[val.long()]
    rnd = (1 << scaling_shift) >> 1
    noise = (sc * grain + rnd) >> scaling_shift
    return torch.clamp(src + noise, min_value, max_value)


def fg_blend_batch(src, grain, scaling, scaling_shift, min_value, max_value):
    """rav1d_tpu/ops/tpu/fg.py fg_blend_batch: src (N, h, w) int32 pixels,
    grain (N, h, w) int32 (post-overlap), scaling (1 << bpc,) int32 LUT.
    Returns the clipped noisy pixels, int32."""
    return _noise_add(src, src, grain, scaling.to(I32), scaling_shift,
                      min_value, max_value)


def plane_grain(lut, rand, ph, pw, ss_x, ss_y, overlap, bpc):
    """The (ph, pw) int32 grain of a plane's visible pixels after the
    overlap blends: `lut` its (74, 82) grain table, `rand` the picture's
    (block rows, block columns) random values, both tensors."""
    dev = rand.device
    bw, bh = 32 >> ss_x, 32 >> ss_y
    y = torch.arange(ph, device=dev)
    x = torch.arange(pw, device=dev)
    r, i = y // bh, y % bh
    c, j = x // bw, x % bw
    flat = lut.reshape(-1).to(I32)
    rv_all = rand.to(torch.int64)
    top = flat.numel() - 1

    def sample(rr, cc, dy, dx):
        """The table sample of block (rr, cc) at this block's pixel
        offsets, shifted a block down (dy) or right (dx); only positions
        inside an overlap read a neighbour's, the rest are clamped and
        unused."""
        rv = rv_all[rr.clamp(min=0)][:, cc.clamp(min=0)]
        offx = 3 + (2 >> ss_x) * (3 + (rv >> 4))
        offy = 3 + (2 >> ss_y) * (3 + (rv & 15))
        idx = ((offy + bh * dy + i[:, None]) * GRAIN_W
               + offx + bw * dx + j[None, :])
        return flat[idx.clamp(0, top)]

    g = sample(r, c, 0, 0)
    if not overlap:
        return g
    gmax = (128 << (bpc - 8)) - 1
    gmin = -(128 << (bpc - 8))
    wx = torch.tensor(WEIGHTS[ss_x], dtype=I32, device=dev)[j.clamp(max=1)]
    wy = torch.tensor(WEIGHTS[ss_y], dtype=I32, device=dev)[i.clamp(max=1)]
    wx0, wx1 = wx[None, :, 0], wx[None, :, 1]
    wy0, wy1 = wy[:, None, 0], wy[:, None, 1]
    xm = ((c > 0) & (j < (2 >> ss_x)))[None, :]
    ym = ((r > 0) & (i < (2 >> ss_y)))[:, None]

    def blend(old, new, w0, w1):
        return torch.clamp(_round2(old * w0 + new * w1, 5), gmin, gmax)

    g = torch.where(xm, blend(sample(r, c - 1, 0, 1), g, wx0, wx1), g)
    above = sample(r - 1, c, 1, 0)
    above = torch.where(xm, blend(sample(r - 1, c - 1, 1, 1), above, wx0,
                                  wx1), above)
    return torch.where(ym, blend(above, g, wy0, wy1), g)


def grain_frame_plain(planes, t):
    """The grain of every plane of a picture: `planes` its padded planes
    (y[, u, v]) as uint8 (8-bit) or int16 tensors, `t` its
    engine/grain.py GrainTables. Returns new planes of the same shapes and
    type (the input stays grain-free)."""
    dev = planes[0].device
    out = [p.clone() for p in planes]
    ss_x, ss_y = t.ss
    rand = torch.as_tensor(t.rand, device=dev)
    lut = torch.as_tensor(t.lut, device=dev)
    scaling = torch.as_tensor(t.scaling, device=dev).to(I32)
    bdm8 = t.bpc - 8
    luma = planes[0].to(I32)
    for pl in range(t.nplanes):
        k = t.plane_scaling[pl]
        if k < 0:
            continue
        sx, sy = (0, 0) if pl == 0 else (ss_x, ss_y)
        ph, pw = (t.h + sy) >> sy, (t.w + sx) >> sx
        grain = plane_grain(lut[pl], rand, ph, pw, sx, sy, t.overlap, t.bpc)
        src = planes[pl][:ph, :pw].to(I32)
        if pl == 0:
            val = src
        else:
            ly = torch.arange(ph, device=dev) << sy
            lx = torch.arange(pw, device=dev) << sx
            rows = luma[ly]
            avg = rows[:, lx]
            if sx:  # the pair's right column, column w - 1 past the edge
                avg = (avg + rows[:, (lx + 1).clamp(max=t.w - 1)] + 1) >> 1
            if t.cfl:
                val = avg
            else:
                uv = pl - 1
                comb = avg * t.uv_luma_mult[uv] + src * t.uv_mult[uv]
                val = torch.clamp((comb >> 6) + t.uv_offset[uv] * (1 << bdm8),
                                  0, (1 << t.bpc) - 1)
        lo, hi = t.clip[min(pl, 1)]
        res = _noise_add(src, val, grain, scaling[k], t.scaling_shift, lo, hi)
        out[pl][:ph, :pw] = res.to(out[pl].dtype)
    return out
