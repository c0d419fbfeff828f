"""Whole-frame post filters on torch: deblock, CDEF, superres, loop
restoration.

Port of rav1d_tpu/engine/filters.py (lf_dir_pass_raw, cdef_pass_raw,
resize_plane_raw, _gather_stripes, _lr_scatter, lr_wiener_pass_raw,
lr_sgr_pass_raw), fed by the level/stripe descriptors of the frame blob.
Gathers clamp their indices as JAX gathers do; scatters send out-of-range
writes to the trash word at the end of the flat buffer, as JAX's
mode="drop" discards them.

These are the plain versions of the hand-written filter kernels
(ops/cuda/filters.py), which run every frame's filters on the card;
`calls` counts the calls of the deblock, CDEF, superres and LR passes, so
a run can show that the card's filter stage made none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cdef import MISSING, cdef_filter_batch, find_dir_batch, ulog2
from ..ops.lf import filter_lines_batch
from ..ops.lr import sgr_batch, wiener_batch
from ..ops.ref.lf import WRITE_EXTENT
from .consts import tables

I32 = torch.int32
calls = 0


def _ar(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


# --------------------------------------------------------------------------
# deblock
# --------------------------------------------------------------------------


def lf_dir_pass(plane, cmap, lmap, eih, luma, hor, bpc):
    """All three width classes of one (plane, direction) deblock pass.

    plane: (H, W) int32; cmap/lmap: (nh4, nw4) final edge class / level
    maps; eih: (2, 64) E/I luts. hor transposes so the same math serves
    both directions. Returns the filtered plane."""
    global calls
    calls += 1
    if hor:
        plane = plane.T
    nh4, nw4 = cmap.shape
    H = nh4 * 4
    # zero padding mirrors the host deblock's pad array exactly
    pad = F.pad(plane, (8, 8 + 8, 8, 8))
    Wp = pad.shape[1] - (pad.shape[1] % 4)
    padr = pad[:, :Wp].contiguous().reshape(pad.shape[0], Wp // 4, 4)

    lines4 = lmap.repeat_interleave(4, dim=0)  # (H, nw4)
    L = lines4.reshape(-1).long()
    E = eih[0][L]
    I = eih[1][L]
    Hh = lines4.reshape(-1) >> 4

    for cls_ in (1, 2, 3):
        wd = (4 << (cls_ - 1)) if luma else (4 + 2 * (cls_ - 1))
        # window col k for cell x lives at pad col x*4 + k = group x + k//4
        win = torch.stack(
            [padr[8 : 8 + H, (k >> 2) : (k >> 2) + nw4, k & 3]
             for k in range(16)],
            dim=-1,
        )  # (H, nw4, 16)
        out = filter_lines_batch(win.reshape(-1, 16), E, I, Hh, wd, bpc)
        out = out.reshape(H, nw4, 16)
        sel = ((cmap == cls_) & (lmap != 0)).repeat_interleave(4, dim=0)
        lo, hi = WRITE_EXTENT[wd]
        for k in range(lo, hi):
            cur = padr[8 : 8 + H, (k >> 2) : (k >> 2) + nw4, k & 3]
            padr[8 : 8 + H, (k >> 2) : (k >> 2) + nw4, k & 3] = torch.where(
                sel, out[:, :, k], cur)
    res = padr.reshape(pad.shape[0], Wp)[8 : 8 + plane.shape[0],
                                         8 : 8 + plane.shape[1]]
    return res.T if hor else res


# --------------------------------------------------------------------------
# cdef
# --------------------------------------------------------------------------


def _take2(src, rows, cols):
    """src[rows, cols] with clamped indices (rows/cols broadcastable)."""
    r = rows.clamp(0, src.shape[0] - 1).long()
    c = cols.clamp(0, src.shape[1] - 1).long()
    return src[r, c]


def cdef_pass(planes, maps, damping, nby, nbx, bh, bw, ss_hor, ss_ver,
              uv422, bpc):
    """Dense whole-frame CDEF: direction search on pre-CDEF luma + filter
    of every active 8x8 unit, all planes, in place on planes (3, H, W)."""
    global calls
    calls += 1
    dev = planes.device
    y_pri, y_sec, uv_lvl, uv_pri, uv_sec = (maps[0], maps[1], maps[2],
                                            maps[3], maps[4])
    N = nby * nbx

    ys = _ar(nby, dev) * 8
    xs = _ar(nbx, dev) * 8
    ones_x = torch.ones(nbx, dtype=torch.bool, device=dev)[None, :]
    ones_y = torch.ones(nby, dtype=torch.bool, device=dev)[:, None]
    # unit availability at frame edges (cdef_apply.rs:36)
    have_t = (_ar(nby, dev) > 0)[:, None] & ones_x
    have_b = ((_ar(nby, dev) * 2 + 2) < bh)[:, None] & ones_x
    have_l = ones_y & (_ar(nbx, dev) > 0)[None, :]
    have_r = ones_y & ((_ar(nbx, dev) * 2 + 2) < bw)[None, :]

    def windows(src, cys, cxs, ch, cw):
        padp = F.pad(src, (2, 2, 2, 2), value=MISSING)
        rows = cys[:, None] + _ar(ch + 4, dev)[None, :]
        cols = cxs[:, None] + _ar(cw + 4, dev)[None, :]
        win = _take2(padp, rows[:, None, :, None], cols[None, :, None, :])
        # (nby, nbx, ch+4, cw+4); mask unavailable borders
        rr = _ar(ch + 4, dev)
        cc = _ar(cw + 4, dev)
        miss = torch.full_like(win, MISSING)
        win = torch.where(have_t[:, :, None, None]
                          | (rr >= 2)[None, None, :, None], win, miss)
        win = torch.where(have_b[:, :, None, None]
                          | (rr < ch + 2)[None, None, :, None], win, miss)
        win = torch.where(have_l[:, :, None, None]
                          | (cc >= 2)[None, None, None, :], win, miss)
        win = torch.where(have_r[:, :, None, None]
                          | (cc < cw + 2)[None, None, None, :], win, miss)
        return win.reshape(N, ch + 4, cw + 4)

    # direction search on pre-CDEF luma
    pre_y = planes[0]
    rows = ys[:, None] + _ar(8, dev)[None, :]
    cols = xs[:, None] + _ar(8, dev)[None, :]
    r4 = rows[:, None, :, None]
    c4 = cols[None, :, None, :]
    blocks = _take2(pre_y, r4, c4)
    direction, variance = find_dir_batch(blocks.reshape(N, 8, 8), bpc)

    ypri_f = y_pri.reshape(-1)
    ysec_f = y_sec.reshape(-1)
    # variance-adjusted primary strength (cdef.rs adjust_strength)
    v6 = variance >> 6
    lg = ulog2(v6.clamp(max=4095).clamp(min=1))
    i = torch.where(v6 >= 4096, torch.full_like(lg, 12), lg.clamp(max=12))
    adj = (ypri_f * (4 + i) + 8) >> 4
    zero = torch.zeros_like(adj)
    pri_eff = torch.where(ypri_f > 0, torch.where(variance == 0, zero, adj), zero)
    dir_eff = torch.where(ypri_f > 0, direction, zero)
    do_y = (pri_eff > 0) | (ysec_f > 0)

    wins = windows(pre_y, ys, xs, 8, 8)
    outy = cdef_filter_batch(wins, pri_eff, ysec_f, dir_eff,
                             torch.full((N,), damping, dtype=I32, device=dev),
                             bpc)
    sel = do_y.reshape(nby, nbx)[:, :, None, None]
    blk = _take2(pre_y, r4, c4)
    outy = torch.where(sel, outy.reshape(nby, nbx, 8, 8), blk)
    planes[0][r4.long(), c4.long()] = outy

    if uv422 >= 0:  # chroma present
        uv_dirs = tables(dev)["uv_dirs"][uv422]
        uvp = uv_pri.reshape(-1)
        uvs = uv_sec.reshape(-1)
        do_uv = uv_lvl.reshape(-1) != 0
        uvdir = torch.where(uvp > 0, uv_dirs[direction.long()], zero)
        ch, cw = 8 >> ss_ver, 8 >> ss_hor
        cys = ys >> ss_ver
        cxs = xs >> ss_hor
        crows = (cys[:, None] + _ar(ch, dev)[None, :])[:, None, :, None]
        ccols = (cxs[:, None] + _ar(cw, dev)[None, :])[None, :, None, :]
        seluv = do_uv.reshape(nby, nbx)[:, :, None, None]
        for pl in (1, 2):
            src = planes[pl]
            wins = windows(src, cys, cxs, ch, cw)
            out = cdef_filter_batch(
                wins, uvp, uvs, uvdir,
                torch.full((N,), damping - 1, dtype=I32, device=dev), bpc)
            blk = _take2(src, crows, ccols)
            out = torch.where(seluv, out.reshape(nby, nbx, ch, cw), blk)
            planes[pl][crows.long(), ccols.long()] = out
    return planes


# --------------------------------------------------------------------------
# super-resolution
# --------------------------------------------------------------------------


def resize_plane(src, h, dst_w, src_w, dx, mx0, bpc, out_w):
    """Horizontal 8-tap upscale of src[:h, :src_w] to dst_w columns
    (mc.rs resize_rust:1114): output column x reads source columns around
    (mx0 + x * dx) >> 14 with the filter of its 1/64 phase, clamped to the
    row. Returns (h, out_w) int32, zero past dst_w."""
    global calls
    calls += 1
    d_ = src.device
    RF = tables(d_)["resize_filter"]
    pos = mx0 + _ar(dst_w, d_) * dx
    src_x = -1 + (pos >> 14) - (mx0 >> 14)
    filt = RF[((pos & 0x3FFF) >> 8).long()]
    acc = torch.zeros((h, dst_w), dtype=I32, device=d_)
    for k in range(8):
        cols = (src_x + k - 3).clamp(0, src_w - 1).long()
        acc += filt[None, :, k] * src[:h, cols]
    out = ((-acc + 64) >> 7).clamp(0, (1 << bpc) - 1)
    return F.pad(out, (0, out_w - dst_w))


# --------------------------------------------------------------------------
# loop restoration
# --------------------------------------------------------------------------

# stripe descriptor rows
(S_X0, S_Y0, S_W, S_H, S_XLO, S_XHI, S_TOP0, S_TOP1, S_BOT0, S_BOT1,
 S_P0, S_P1, S_P2, S_P3, S_P4, S_P5) = range(16)


def gather_stripes(cat, d, W6):
    """cat: (2*H, W) concat(pre_lr, lpf); d: (16, N). -> (N, 70, W6)."""
    dev = cat.device
    i = _ar(70, dev)[None, :]
    h = d[S_H][:, None]
    y0 = d[S_Y0][:, None]
    inner = y0 + torch.minimum((i - 3).clamp(min=0), (h - 1).clamp(min=0))
    rmap = torch.where(
        i < 2, d[S_TOP0][:, None],
        torch.where(
            i < 3, d[S_TOP1][:, None],
            torch.where(
                i < 3 + h, inner,
                torch.where(i == 3 + h, d[S_BOT0][:, None], d[S_BOT1][:, None]),
            ),
        ),
    )
    c = _ar(W6, dev)[None, :]
    cmap = torch.minimum(torch.maximum(d[S_X0][:, None] - 3 + c,
                                       d[S_XLO][:, None]), d[S_XHI][:, None])
    return _take2(cat, rmap[:, :, None], cmap[:, None, :])


def lr_scatter(pf, out, d, aw):
    """Write each stripe's valid (h, w) region into pf (flat, trash word
    last), in place."""
    dev = pf.device
    n = pf.shape[0] - 1
    r = _ar(out.shape[1], dev)
    c = _ar(out.shape[2], dev)
    idx = ((d[S_Y0][:, None, None] + r[None, :, None]) * aw
           + d[S_X0][:, None, None] + c[None, None, :])
    valid = (r[None, :, None] < d[S_H][:, None, None]) & (
        c[None, None, :] < d[S_W][:, None, None]
    ) & (idx >= 0) & (idx < n)
    idx = torch.where(valid, idx, torch.full_like(idx, n))
    pf[idx.reshape(-1).long()] = out.reshape(-1)


def lr_wiener_pass(pf, cat, d, W, bpc, aw):
    global calls
    calls += 1
    tmps = gather_stripes(cat, d, W + 6)
    out = wiener_batch(tmps, torch.stack([d[S_P0], d[S_P1], d[S_P2]], 1),
                       torch.stack([d[S_P3], d[S_P4], d[S_P5]], 1), W, 64, bpc)
    lr_scatter(pf, out, d, aw)


def lr_sgr_pass(pf, cat, d, W, kind, bpc, aw):
    global calls
    calls += 1
    tmps = gather_stripes(cat, d, W + 6)
    cur = tmps[:, 3 : 3 + 64, 3 : 3 + W]
    out = sgr_batch(cur, tmps, d[S_P0], d[S_P1],
                    torch.stack([d[S_P2], d[S_P3]], 1), W, 64, kind, bpc)
    lr_scatter(pf, out, d, aw)
