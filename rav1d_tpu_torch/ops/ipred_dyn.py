"""Traced-size batched intra prediction on torch (the wave step's modes).

Port of rav1d_tpu/ops/tpu/ipred_dyn.py: every function runs at a static
size class (CW, CH) while each item's block size (w, h) is per-item data.
Same edge layout: `edge` is (B, EL) int32, EL = 2*CH + 1 + 2*CW, the
top-left sample at C = 2*CH, top pixels ascending from C+1, left pixels
descending from C-1. Predicted pixels beyond an item's (w, h) are garbage
that the caller's scatter masks. Every gather clamps its indices, as JAX
gathers do. Semantics parity: src/ipred.rs ipred_*_rust.
"""

from __future__ import annotations

import torch

from ..engine.consts import tables

I32 = torch.int32


def _ar(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


def _ctz(v):
    t = tables(v.device)["ctz"]
    return t[v.clamp(0, 256).long()]


def _gat(edge, pos):
    """edge (B, EL) gathered at clamped positions pos (B or 1, L)."""
    pos = pos.clamp(0, edge.shape[1] - 1).long()
    if pos.shape[0] != edge.shape[0]:
        pos = pos.expand(edge.shape[0], -1)
    return torch.gather(edge, 1, pos)


def _scalar(edge, pos):
    """edge gathered at one clamped position per item; pos (B,) -> (B,)."""
    return _gat(edge, pos[:, None])[:, 0]


def _decode_angle(angle):
    return angle & 511, (angle >> 9) & 1, angle >> 10


def _w(cond, a, b):
    """torch.where that keeps int32 when a and b are Python ints (filled on
    the device: a host tensor copy would synchronise the stream)."""
    if not torch.is_tensor(a) and not torch.is_tensor(b):
        b = torch.full(cond.shape, b, dtype=I32, device=cond.device)
    return torch.where(cond, a, b)


def _fs_t(wh, a, is_sm):
    """_get_filter_strength with per-item wh/angle (src/ipred.rs)."""
    sm = _w(
        wh <= 8,
        _w(a >= 64, 2, _w(a >= 40, 1, 0)),
        _w(
            wh <= 16,
            _w(a >= 48, 2, _w(a >= 20, 1, 0)),
            _w(wh <= 24, _w(a >= 4, 3, 0), 3),
        ),
    )
    ns = _w(
        wh <= 8,
        _w(a >= 56, 1, 0),
        _w(
            wh <= 16,
            _w(a >= 40, 1, 0),
            _w(
                wh <= 24,
                _w(a >= 32, 3, _w(a >= 16, 2, _w(a >= 8, 1, 0))),
                _w(wh <= 32, _w(a >= 32, 3, _w(a >= 4, 2, 1)), 3),
            ),
        ),
    )
    return torch.where(is_sm != 0, sm, ns)


def _ups_t(wh, a, is_sm):
    lim = _w(is_sm != 0, 8, 16)
    return ((a < 40) & (wh <= lim)).to(I32)


def _dr(idx):
    t = tables(idx.device)["dr_intra_derivative"]
    return t[idx.clamp(0, t.shape[0] - 1).long()]


def _top(edge, C, CW):
    return edge[:, C + 1 : C + 1 + 2 * CW]


def _left_desc(edge, C, CH):
    # j-th lane = edge[C - 1 - j]
    return edge[:, :C].flip(1)


def _sum(x, dim):
    # int32 sums wrap like the JAX engine's (torch would widen to int64)
    return x.sum(dim, dtype=I32)


def dc_dyn(edge, C, CW, CH, w, h, bpc):
    dev = edge.device
    i = _ar(2 * CW, dev)[None, :]
    j = _ar(2 * CH, dev)[None, :]
    tsum = _sum(_w(i < w[:, None], _top(edge, C, CW), 0), 1)
    lsum = _sum(_w(j < h[:, None], _left_desc(edge, C, CH), 0), 1)
    wh = w + h
    dc = ((wh >> 1) + tsum + lsum) >> _ctz(wh)
    mult_1x2, mult_1x4, base_shift = (
        (0x5556, 0x3334, 16) if bpc == 8 else (0xAAAB, 0x6667, 17)
    )
    mult = _w((w > (h << 1)) | (h > (w << 1)), mult_1x4, mult_1x2)
    dc = torch.where(w != h, (dc * mult) >> base_shift, dc)
    return dc[:, None, None].expand(edge.shape[0], CH, CW)


def dc_top_dyn(edge, C, CW, CH, w, h, bpc):
    i = _ar(2 * CW, edge.device)[None, :]
    tsum = _sum(_w(i < w[:, None], _top(edge, C, CW), 0), 1)
    dc = (tsum + (w >> 1)) >> _ctz(w)
    return dc[:, None, None].expand(edge.shape[0], CH, CW)


def dc_left_dyn(edge, C, CW, CH, w, h, bpc):
    j = _ar(2 * CH, edge.device)[None, :]
    lsum = _sum(_w(j < h[:, None], _left_desc(edge, C, CH), 0), 1)
    dc = (lsum + (h >> 1)) >> _ctz(h)
    return dc[:, None, None].expand(edge.shape[0], CH, CW)


def dc_128_dyn(edge, C, CW, CH, w, h, bpc):
    return torch.full((edge.shape[0], CH, CW), (1 << bpc) >> 1, dtype=I32,
                      device=edge.device)


def v_dyn(edge, C, CW, CH, w, h, bpc):
    return _top(edge, C, CW)[:, None, :CW].expand(edge.shape[0], CH, CW)


def h_dyn(edge, C, CW, CH, w, h, bpc):
    return _left_desc(edge, C, CH)[:, :CH, None].expand(edge.shape[0], CH, CW)


def paeth_dyn(edge, C, CW, CH, w, h, bpc):
    B = edge.shape[0]
    tl = edge[:, C][:, None, None]
    top = _top(edge, C, CW)[:, None, :CW]
    left = _left_desc(edge, C, CH)[:, :CH, None]
    base = left + top - tl
    ldiff = (left - base).abs()
    tdiff = (top - base).abs()
    tldiff = (tl - base).abs()
    return torch.where(
        (ldiff <= tdiff) & (ldiff <= tldiff),
        left.expand(B, CH, CW),
        torch.where(tdiff <= tldiff, top.expand(B, CH, CW),
                    tl.expand(B, CH, CW)),
    )


def _sm(idx):
    t = tables(idx.device)["sm_weights"]
    return t[idx.clamp(0, t.shape[0] - 1).long()]


def smooth_dyn(edge, C, CW, CH, w, h, bpc):
    dev = edge.device
    wx = _sm(w[:, None] + _ar(CW, dev)[None, :])[:, None, :]
    wy = _sm(h[:, None] + _ar(CH, dev)[None, :])[:, :, None]
    right = _scalar(edge, C + w)[:, None, None]
    bottom = _scalar(edge, C - h)[:, None, None]
    top = _top(edge, C, CW)[:, None, :CW]
    left = _left_desc(edge, C, CH)[:, :CH, None]
    pred = wy * top + (256 - wy) * bottom + wx * left + (256 - wx) * right
    return (pred + 256) >> 9


def smooth_v_dyn(edge, C, CW, CH, w, h, bpc):
    wy = _sm(h[:, None] + _ar(CH, edge.device)[None, :])[:, :, None]
    bottom = _scalar(edge, C - h)[:, None, None]
    top = _top(edge, C, CW)[:, None, :CW]
    pred = wy * top + (256 - wy) * bottom
    return ((pred + 128) >> 8).expand(edge.shape[0], CH, CW)


def smooth_h_dyn(edge, C, CW, CH, w, h, bpc):
    wx = _sm(w[:, None] + _ar(CW, edge.device)[None, :])[:, None, :]
    right = _scalar(edge, C + w)[:, None, None]
    left = _left_desc(edge, C, CH)[:, :CH, None]
    pred = wx * left + (256 - wx) * right
    return ((pred + 128) >> 8).expand(edge.shape[0], CH, CW)


def _kernels(fs, dev):
    return tables(dev)["edge_kernels"][(fs.clamp(min=1) - 1).long()]


_OFFS = {}


def _offsets(dev, offs, L):
    """(1, len(offs) * L) int32: offs[g] repeated over each block of L."""
    key = (str(dev), offs, L)
    if key not in _OFFS:
        _OFFS[key] = torch.tensor([o for o in offs for _ in range(L)],
                                  dtype=I32, device=dev)[None, :]
    return _OFFS[key]


def _gat_groups(edge, pos, n):
    """One gather of edge at pos (B, n*L) -> list of n (B, L) tensors."""
    g = _gat(edge, pos)
    L = g.shape[1] // n
    return [g[:, k * L : (k + 1) * L] for k in range(n)]


def _gat3_many(vec, idxs):
    """vec (B, L) gathered at each of several (B, CH, CW)-broadcastable
    index tensors (clamped), in one gather."""
    B = vec.shape[0]
    shp = torch.broadcast_shapes(*[i.shape for i in idxs])
    shp = (B,) + tuple(shp[1:])
    flat = torch.cat([torch.broadcast_to(i, shp).reshape(B, -1) for i in idxs],
                     dim=1)
    g = torch.gather(vec, 1, flat.clamp(0, vec.shape[1] - 1).long())
    n = g.shape[1] // len(idxs)
    return [g[:, k * n : (k + 1) * n].reshape(shp) for k in range(len(idxs))]


# The directional modes read the edge at many shifted positions. Each
# mode builds all its positions first and gathers once; every position is
# the JAX twin's, index for index.
_TAP_OFFS = (-2, -1, 0, 1, 2)   # 5-tap edge filter around i
_UP_OFFS = (-1, 0, 1, 2)        # 4-tap upsampler around k = i >> 1


def z1_dyn(edge, C, CW, CH, w, h, bpc, angles):
    dev = edge.device
    angle, is_sm, ief = _decode_angle(angles)
    dx = _dr(angle >> 1)
    wh = w + h
    wmin = torch.minimum(w, h)
    ups = _ups_t(wh, 90 - angle, is_sm) * (ief != 0)
    fs = _fs_t(wh, 90 - angle, is_sm) * (ief != 0)
    pxmax = (1 << bpc) - 1

    Lmax = 2 * (CW + CH)
    i = _ar(Lmax, dev)[None, :]
    hi = (w + wmin)[:, None]
    # s(k) = edge[C + 1 + clip(k, -1, hi - 1)] at i + tap and (i >> 1) + up
    k = i >> 1
    ks = torch.cat([i.repeat(1, 5), k.repeat(1, 4)], dim=1) + _offsets(
        dev, _TAP_OFFS + _UP_OFFS, Lmax)
    g = _gat_groups(edge, C + 1 + torch.minimum(ks.clamp(min=-1), hi - 1), 9)
    taps, (sm1, ev, sp1, sp2) = g[:5], g[5:]
    raw = taps[2]
    K = _kernels(fs, dev)
    acc = torch.zeros_like(raw)
    for jj in range(5):
        acc = acc + K[:, jj : jj + 1] * taps[jj]
    flt = torch.where(i < wh[:, None], (acc + 8) >> 4, raw)
    odd = ((-sm1 + 9 * ev + 9 * sp1 - sp2 + 8) >> 4).clamp(0, pxmax)
    up = torch.where((i & 1) == 0, ev, odd)

    u = (ups != 0)[:, None]
    top = torch.where(u, up, torch.where((fs > 0)[:, None], flt, raw))
    max_base = torch.where(
        ups != 0, 2 * wh - 2, torch.where(fs > 0, wh - 1, w + wmin - 1)
    )[:, None, None]

    dx_e = (dx << ups)[:, None, None]
    binc = (1 + ups)[:, None, None]
    ys = _ar(CH, dev)[None, :, None]
    xs = _ar(CW, dev)[None, None, :]
    xpos = dx_e * (ys + 1)
    frac = xpos & 0x3E
    base = (xpos >> 6) + xs * binc
    idx = torch.minimum(base, max_base)
    t0, t1, fill = _gat3_many(top, [idx, torch.clamp(idx + 1, max=Lmax - 1),
                                    max_base])
    interp = (t0 * (64 - frac) + t1 * frac + 32) >> 6
    return torch.where(base < max_base, interp, fill)


def z3_dyn(edge, C, CW, CH, w, h, bpc, angles):
    dev = edge.device
    angle, is_sm, ief = _decode_angle(angles)
    dy = _dr((270 - angle) >> 1)
    wh = w + h
    hmin = torch.minimum(w, h)
    ups = _ups_t(wh, angle - 180, is_sm) * (ief != 0)
    fs = _fs_t(wh, angle - 180, is_sm) * (ief != 0)
    pxmax = (1 << bpc) - 1

    Lmax = 2 * (CW + CH)
    i = _ar(Lmax, dev)[None, :]
    lo = (w - h).clamp(min=0)[:, None]
    whc = wh[:, None]
    # raw: edge[C - 1 - i]; s(k) = edge[C - wh + clip(k, lo, wh)] at the
    # filter taps around kf = wh - 1 - i and the upsampler around
    # k = (2 wh - 2 - i) >> 1
    kf = whc - 1 - i
    t = 2 * whc - 2 - i
    k = t >> 1
    ks = torch.cat([kf.repeat(1, 5), k.repeat(1, 4)], dim=1) + _offsets(
        dev, _TAP_OFFS + _UP_OFFS, Lmax)
    spos = (C - whc) + torch.minimum(torch.maximum(ks, lo), whc)
    rpos = (C - 1 - i).expand(edge.shape[0], Lmax)
    g = _gat_groups(edge, torch.cat([rpos, spos], dim=1), 10)
    raw, taps, (sm1, ev, sp1, sp2) = g[0], g[1:6], g[6:]
    K = _kernels(fs, dev)
    acc = torch.zeros((edge.shape[0], Lmax), dtype=I32, device=dev)
    for jj in range(5):
        acc = acc + K[:, jj : jj + 1] * taps[jj]
    flt = (acc + 8) >> 4
    odd = ((-sm1 + 9 * ev + 9 * sp1 - sp2 + 8) >> 4).clamp(0, pxmax)
    up = torch.where((t & 1) == 0, ev, odd)

    u = (ups != 0)[:, None]
    left = torch.where(u, up, torch.where((fs > 0)[:, None], flt, raw))
    max_base = torch.where(
        ups != 0, 2 * wh - 2, torch.where(fs > 0, wh - 1, h + hmin - 1)
    )[:, None, None]

    dy_e = (dy << ups)[:, None, None]
    binc = (1 + ups)[:, None, None]
    ys = _ar(CH, dev)[None, :, None]
    xs = _ar(CW, dev)[None, None, :]
    ypos = dy_e * (xs + 1)
    frac = ypos & 0x3E
    base = (ypos >> 6) + ys * binc
    idx = torch.minimum(base, max_base)
    t0, t1, fill = _gat3_many(left, [idx, torch.clamp(idx + 1, max=Lmax - 1),
                                     max_base])
    interp = (t0 * (64 - frac) + t1 * frac + 32) >> 6
    return torch.where(base < max_base, interp, fill)


def z2_dyn(edge, C, CW, CH, w, h, bpc, angles, max_ws, max_hs, smooth_tl):
    dev = edge.device
    angle, is_sm, ief = _decode_angle(angles)
    dy = _dr((angle - 90) >> 1)
    dx = _dr((180 - angle) >> 1)
    wh = w + h
    ua = _ups_t(wh, angle - 90, is_sm) * (ief != 0)
    ul = _ups_t(wh, 180 - angle, is_sm) * (ief != 0)
    fs_a = _fs_t(wh, angle - 90, is_sm) * (ief != 0)
    fs_l = _fs_t(wh, 180 - angle, is_sm) * (ief != 0)
    pxmax = (1 << bpc) - 1

    # top-left smoothing (rav1d_prepare_intra_edges, ipred_prepare.rs:184)
    tl0 = edge[:, C]
    sm_tl = ((edge[:, C - 1] + edge[:, C + 1]) * 5 + tl0 * 6 + 8) >> 4
    edge = edge.clone()
    edge[:, C] = torch.where(smooth_tl, sm_tl, tl0)

    EL = edge.shape[1]
    j = _ar(EL, dev)[None, :] - C
    wc = w[:, None]
    hc = h[:, None]

    # above: s_a(k) = edge[C + clip(k, 0, w)] around k = j >> 1, and the
    # raw/filter taps r_a(i) = edge[C + 1 + clip(i, -1, w - 1)]
    #                        = s_a(i + 1) around i_a = j - 1
    k = j >> 1
    i_a = j - 1
    ka = torch.cat([k.repeat(1, 4), i_a.repeat(1, 5)], dim=1) + _offsets(
        dev, _UP_OFFS + tuple(o + 1 for o in _TAP_OFFS), EL)
    pos_a = C + torch.minimum(ka.clamp(min=0), wc)
    # below: s_b(k) = edge[C - h + clip(k, 0, h)] around kb = (j + 2h) >> 1
    # and around i_l = j + h
    tb = j + 2 * hc
    kb = tb >> 1
    i_l = j + hc
    kbl = torch.cat([kb.repeat(1, 4), i_l.repeat(1, 5)], dim=1) + _offsets(
        dev, _UP_OFFS + _TAP_OFFS, EL)
    pos_b = (C - hc) + torch.minimum(kbl.clamp(min=0), hc)
    g = _gat_groups(edge, torch.cat([pos_a, pos_b], dim=1), 18)
    (am1, ev_a, ap1, ap2), taps_a = g[0:4], g[4:9]
    (bm1, ev_b, bp1, bp2), taps_b = g[9:13], g[13:18]

    odd_a = ((-am1 + 9 * ev_a + 9 * ap1 - ap2 + 8) >> 4).clamp(0, pxmax)
    up_above = torch.where((j & 1) == 0, ev_a, odd_a)
    raw_a = taps_a[2]
    Ka = _kernels(fs_a, dev)
    acc = torch.zeros_like(raw_a)
    for jj in range(5):
        acc = acc + Ka[:, jj : jj + 1] * taps_a[jj]
    sm_a = (acc + 8) >> 4
    flt_a = torch.where(
        (i_a >= 0) & (i_a < max_ws[:, None]) & (fs_a > 0)[:, None], sm_a, raw_a
    )
    above = torch.where((ua != 0)[:, None], up_above, flt_a)

    odd_b = ((-bm1 + 9 * ev_b + 9 * bp1 - bp2 + 8) >> 4).clamp(0, pxmax)
    up_below = torch.where((tb & 1) == 0, ev_b, odd_b)
    raw_l = taps_b[2]
    Kl = _kernels(fs_l, dev)
    accl = torch.zeros_like(raw_l)
    for jj in range(5):
        accl = accl + Kl[:, jj : jj + 1] * taps_b[jj]
    sm_l = (accl + 8) >> 4
    flt_l = torch.where(
        (i_l >= (hc - max_hs[:, None])) & (i_l < hc) & (fs_l > 0)[:, None],
        sm_l,
        raw_l,
    )
    below = torch.where((ul != 0)[:, None], up_below, flt_l)

    edge_v = torch.where(j > 0, above,
                         torch.where(j < 0, below, edge[:, C : C + 1]))

    dx_e = (dx << ua)[:, None, None]
    ys = _ar(CH, dev)[None, :, None]
    xs = _ar(CW, dev)[None, None, :]
    xpos = ((1 + ua) << 6)[:, None, None] - dx_e * (ys + 1)
    base_x = (xpos >> 6) + xs * (1 + ua)[:, None, None]
    frac_x = xpos & 0x3E
    ypos = (ys << (6 + ul)[:, None, None]) - (dy << ul)[:, None, None] * (xs + 1)
    base_y = ypos >> 6
    frac_y = ypos & 0x3E

    left_off = C - (1 + ul)[:, None, None]
    t0, t1, l0, l1 = _gat3_many(edge_v, [
        C + base_x, C + base_x + 1, left_off - base_y, left_off - base_y - 1])
    top_v = t0 * (64 - frac_x) + t1 * frac_x
    left_v = l0 * (64 - frac_y) + l1 * frac_y
    v = torch.where(base_x >= 0, top_v, left_v)
    return (v + 32) >> 6


_FILTER_STEPS = {}


def _filter_steps(dev, nyg, nxg):
    """Index tensors for the anti-diagonal walk over an nyg x nxg grid of
    4x2 filter-intra sub-blocks: per step, the (y, x) origins, the 7 input
    positions and the 8 output positions of each sub-block in the
    (CH+1, CW+1) work buffer. A sub-block reads only outputs of its left,
    top and top-left neighbours, all on earlier anti-diagonals, so every
    sub-block of one anti-diagonal computes at once."""
    key = (str(dev), nyg, nxg)
    if key not in _FILTER_STEPS:
        steps = []
        for s in range(nyg + nxg - 1):
            blk = [(2 * iy, 4 * (s - iy)) for iy in range(nyg) if 0 <= s - iy < nxg]
            ys = [y for y, _ in blk]
            xs = [x for _, x in blk]
            rr = [[y] * 5 + [y + 1, y + 2] for y in ys]
            rc = [[x + k for k in range(5)] + [x, x] for x in xs]
            wr = [[y + 1] * 4 + [y + 2] * 4 for y in ys]
            wc = [[x + 1 + k for k in range(4)] * 2 for x in xs]
            steps.append(tuple(
                torch.tensor(a, dtype=torch.int64, device=dev)
                for a in (ys, xs, rr, rc, wr, wc)))
        _FILTER_STEPS[key] = steps
    return _FILTER_STEPS[key]


def filter_dyn(edge, C, CW, CH, w, h, bpc, filt_idx, ext_w=None, ext_h=None):
    """FILTER_PRED with per-item (w, h), batched over items (src/ipred.rs
    ipred_filter_rust). The JAX twin walks the class's 4x2 sub-blocks in
    row-major order; this one walks anti-diagonals of them (_filter_steps),
    which reads the same values. ext_w/ext_h (host ints) bound the walk to
    the largest filter block present: sub-blocks beyond every item's extent
    change nothing."""
    dev = edge.device
    B = edge.shape[0]
    taps = tables(dev)["filter_intra_taps"]  # (5, 8, 7)
    pxmax = (1 << bpc) - 1
    ext_w = CW if ext_w is None else min(ext_w, CW)
    ext_h = CH if ext_h is None else min(ext_h, CH)

    fm = taps[(filt_idx & 511).clamp(0, 4).long()][:, None]  # (B, 1, 8, 7)
    buf = torch.zeros((B, CH + 1, CW + 1), dtype=I32, device=dev)
    buf[:, 0, 1:] = edge[:, C + 1 : C + 1 + CW]
    buf[:, 1:, 0] = _left_desc(edge, C, CH)[:, :CH]
    buf[:, 0, 0] = edge[:, C]
    steps = _filter_steps(dev, (ext_h + 1) // 2, (ext_w + 3) // 4)
    for ys, xs, rr, rc, wr, wc in steps:
        active = ((xs[None, :] < w[:, None]) & (ys[None, :] < h[:, None]))
        ps = buf[:, rr, rc]  # (B, m, 7)
        vals = (((fm * ps[:, :, None, :]).sum(3, dtype=I32) + 8) >> 4
                ).clamp(0, pxmax)  # (B, m, 8)
        buf[:, wr, wc] = torch.where(active[:, :, None], vals, buf[:, wr, wc])
    return buf[:, 1:, 1:]


def cfl_ac_dyn(ypx, CW, CH, w, h, ss_hor, ss_ver, w_pads, h_pads):
    """cfl_ac with per-item (w, h): ypx (B, CH << ss_ver, CW << ss_hor) luma
    pixels from the block origin -> (B, CH, CW) ac values."""
    dev = ypx.device
    s = ypx.to(I32)
    if ss_hor:
        s = s[:, :, 0::2] + s[:, :, 1::2]
    if ss_ver:
        s = s[:, 0::2, :] + s[:, 1::2, :]
    s = s << (1 + (ss_ver == 0) + (ss_hor == 0))
    valid_w = (w - 4 * w_pads)[:, None, None]
    valid_h = (h - 4 * h_pads)[:, None, None]
    ys = torch.minimum(_ar(CH, dev)[None, :, None], valid_h - 1)
    xs = torch.minimum(_ar(CW, dev)[None, None, :], valid_w - 1)
    B = ypx.shape[0]
    flat = s.reshape(B, -1)
    pos = (ys * CW + xs).clamp(0, CH * CW - 1)
    pos = torch.broadcast_to(pos, (B, CH, CW)).reshape(B, -1).long()
    ac = torch.gather(flat, 1, pos).reshape(B, CH, CW)
    log2sz = _ctz(w) + _ctz(h)
    mask = (_ar(CW, dev)[None, None, :] < w[:, None, None]) & (
        _ar(CH, dev)[None, :, None] < h[:, None, None]
    )
    one = torch.ones_like(log2sz)
    total = ((one << log2sz) >> 1) + _sum(_w(mask, ac, 0).reshape(B, -1), 1)
    avg = total >> log2sz
    return ac - avg[:, None, None]


def cfl_pred_dyn(dcs, acs, alphas, bpc):
    diff = alphas[:, None, None] * acs
    mag = (diff.abs() + 32) >> 6
    adj = torch.where(diff < 0, -mag, mag)
    return (dcs[:, None, None] + adj).clamp(0, (1 << bpc) - 1)
