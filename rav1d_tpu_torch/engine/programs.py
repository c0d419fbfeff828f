"""The device engine's four programs on torch.

Ports of rav1d_tpu/engine/mega.py resid_prog, inter_prog, wave_prog and
filter_prog; resid, inter, wave and filter_ launch hand-written kernels on
the card and run their plain versions (resid_plain, inter_plain,
wave_plain, filter_plain) on the CPU. Every
program reads the frame's descriptors from the one uploaded int32 blob
`dev`, at the word offsets of the header; the trip counts, filter cases
and feature gates that JAX reads from the device blob come from the host
header `hdr` and the packer's counts instead, so no count is ever read
back from the device during a frame.

Layout conventions (as in the JAX engine): `ra` is the (6*psz,) residual
buffer, [0, 3psz) for the wavefront's blocks; planes are (3, ah, aw)
int32. Flat buffers written by scatters carry one trash word at the end:
out-of-range writes land there, as JAX's mode="drop" discards them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cuda import filters as cuda_filters
from ..ops.cuda import inter as cuda_inter
from ..ops.cuda import itx as cuda_itx
from ..ops.cuda import wave as cuda_wave
from ..ops.ref.mc import intermediate_bits
from ..syntax.levels import FILTER_PRED
from . import filters as FL
from . import tiles as T
from .consts import tables
from .kernels import itx_any_core, wht_core
from .layout import (
    B_FLAT0, B_MCS, B_MOFF, B_MRS, B_ROW, B_TH, B_TW, C_FLAT0, C_P0, C_P1,
    C_P2, C_R0, C_R1, C_TH, C_TW, CDEF0, CF0, D_FLAT0, D_MX, D_MY, D_SROW,
    D_SX, D_SY, D_TH, D_TW, DB0, FI, HB, IH0, INTER0, LR0, LRB, N_FIELDS,
    NBLEND, NCOMB, NPUT, NWARP, PAL0, PAL_B, R0, SIZES, SLOTS, TB, W_A, W_B,
    SR0, W_C, W_D, W_FLAT0, W_MX, W_MY, W_SROW, W_SX, W_SY, W_TH, W_TW,
    WAVE0, WHT0, WHT_B, chunk_for,
)
from .plan import CAP, CLS_L, CLS_S
from .wave import build_coords, class_step, unpack

I32 = torch.int32


def _ar(n, dev):
    return torch.arange(n, dtype=I32, device=dev)


def _region(dev, base, n):
    """dev[base : base + n]; a region the packer wrote always fits."""
    assert 0 <= base and base + n <= dev.shape[0], (base, n, dev.shape)
    return dev[base : base + n]


def _gather(dev, idx):
    return dev[idx.clamp(0, dev.shape[0] - 1).long()]


def _coefs(dev, cf_base, offs, M, bpc):
    """(N, M) int32 coefficients of each lane's block (int16 pairs packed
    little-endian into the blob's words at 8 bpc, blob2.add_i16)."""
    if bpc == 8:
        wds = _gather(dev, cf_base + (offs[:, None] >> 1)
                      + _ar(M // 2, dev.device)[None, :])
        return wds.contiguous().view(torch.int16).to(I32)
    return _gather(dev, cf_base + offs[:, None] + _ar(M, dev.device)[None, :])


def _scatter_drop(buf, idx, vals):
    """buf[idx] = vals for idx in [0, len(buf) - 1); other writes go to the
    trash word buf[-1]."""
    n = buf.shape[0] - 1
    idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
    buf[idx.reshape(-1).long()] = vals.reshape(-1)


def u8_region(dev, base, n):
    """n bytes packed four per word from word `base` (blob2.add_u8), as
    int32."""
    wds = _region(dev, base, (n + 3) // 4).contiguous()
    return wds.view(torch.uint8)[:n].to(I32)


# ------------------------------ residuals --------------------------------


def resid(dev, hdr, tx_valid, *, ah, aw, bpc):
    """Inverse-transform every coefficient block of the frame into the
    residual buffer: one launch of the itx kernel on the card
    (ops/cuda/itx.py itx_frame), the plain version `resid_plain` on the
    CPU. tx_valid: {size index or 'wht': filled lanes} from the packer
    (lanes past it are chunk padding). Returns (ra, planes)."""
    if dev.device.type == "cpu":
        return resid_plain(dev, hdr, tx_valid, ah=ah, aw=aw, bpc=bpc)
    psz = ah * aw
    ra = torch.zeros(6 * psz, dtype=I32, device=dev.device)
    cuda_itx.itx_frame(dev, hdr, tx_valid, ra, aw, bpc)
    return ra, torch.zeros((3, ah, aw), dtype=I32, device=dev.device)


def resid_plain(dev, hdr, tx_valid, *, ah, aw, bpc):
    """The plain version of `resid` (mega.py resid_prog in torch): per
    class, gather the coefficients, transform them with
    kernels.itx_any_core (wht_core for the lossless WHT) and scatter the
    residuals, dropping out-of-range destinations."""
    d_ = dev.device
    psz = ah * aw
    ra = torch.zeros(6 * psz + 1, dtype=I32, device=d_)
    cf_base = int(hdr[CF0])

    for si, (w, h) in enumerate(SIZES):
        nc = int(hdr[R0 + 2 * si + 1])
        n = tx_valid.get(si, 0)
        if not nc or not n:
            continue
        B = chunk_for(w, h)
        sh_, sw_ = min(h, 32), min(w, 32)
        d = _region(dev, int(hdr[R0 + 2 * si]), nc * 4 * B).view(nc, 4, B)
        d = d.permute(1, 0, 2).reshape(4, nc * B)[:, :n]
        offs, flat0, f0, f1 = d[0], d[1], d[2].contiguous(), d[3].contiguous()
        cfs = _coefs(dev, cf_base, offs, sh_ * sw_, bpc)
        cb = cfs.reshape(n, sw_, sh_).transpose(1, 2)
        res = itx_any_core(cb, f0, f1, w, h, bpc)
        idx = (flat0[:, None, None] + _ar(h, d_)[None, :, None] * aw
               + _ar(w, d_)[None, None, :])
        _scatter_drop(ra, idx, res)

    # lossless WHT 4x4 (src/itx_1d.rs inv_wht4_1d)
    wn = int(hdr[WHT0 + 1])
    n = tx_valid.get("wht", 0)
    if wn and n:
        d = _region(dev, int(hdr[WHT0]), wn * 2 * WHT_B).view(wn, 2, WHT_B)
        d = d.permute(1, 0, 2).reshape(2, wn * WHT_B)[:, :n]
        cfs = _coefs(dev, cf_base, d[0], 16, bpc)
        res = wht_core(cfs.reshape(n, 4, 4).transpose(1, 2))
        idx = (d[1][:, None, None] + _ar(4, d_)[None, :, None] * aw
               + _ar(4, d_)[None, None, :])
        _scatter_drop(ra, idx, res)
    planes = torch.zeros((3, ah, aw), dtype=I32, device=d_)
    return ra[: 6 * psz], planes


# -------------------------------- inter ----------------------------------


def _run_rows(dev, hdr, name, rows, run, B=TB):
    """(rows, run.n) descriptors of a run of one slot's chunks."""
    base = int(hdr[INTER0 + 2 * SLOTS[name]]) + run.c0 * rows * B
    d = _region(dev, base, run.nc * rows * B).view(run.nc, rows, B)
    return d.permute(1, 0, 2).reshape(rows, run.nc * B)[:, : run.n]


def _scatter8(buf, out, flat0, tw, th, stride):
    """Write each lane's 8x8 tile at flat0 + r*stride + c, its rows below
    th and columns below tw only (mega.py _scatter8)."""
    r = _ar(8, buf.device)
    idx = flat0[:, None, None] + r[None, :, None] * stride + r[None, None, :]
    valid = (r[None, :, None] < th[:, None, None]) & (
        r[None, None, :] < tw[:, None, None])
    _scatter_drop(buf, torch.where(valid, idx, torch.full_like(idx, -1)), out)


def _put_out(stack, d, case, vw, vh, bpc):
    """One case of 8-tap or bilinear put tiles (mega.py _put_out): 0 = h+v,
    1 = h only, 2 = v only, 3 = copy, 4 = bilinear."""
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    sh = 6 - ib
    if case == 0:
        win = T._gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX] - 3, 15,
                        vw, vh)
        fh, fv = T._filters(d)
        mid = T._i16((T.htap(win, fh) + ((1 << sh) >> 1)) >> sh)
        sh2 = 6 + ib
        return ((T.vtap(mid, fv) + ((1 << sh2) >> 1)) >> sh2).clamp(0, pxmax)
    if case == 1:
        win = T._gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX] - 3, 15, vw, vh)
        ho = T.htap(win, T._filters(d)[0])
        return ((ho + 32 + ((1 << sh) >> 1)) >> 6).clamp(0, pxmax)
    if case == 2:
        win = T._gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX], 8, vw, vh)
        vo = T.vtap(win, T._filters(d)[1])
        return ((vo + 32) >> 6).clamp(0, pxmax)
    if case == 3:
        return T._gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX], 8, vw, vh)
    b = T._gather(stack, d[D_SROW], d[D_SY], 9, d[D_SX], 9, vw, vh)
    mx = d[D_MX][:, None, None]
    my = d[D_MY][:, None, None]
    sh_h = 4 - ib
    hrnd = (1 << sh_h) >> 1
    hsrc = b[:, :, :8]
    hf = 16 * hsrc + mx * (b[:, :, 1:9] - hsrc)
    mid_f = T._i16((hf + hrnd) >> sh_h)
    vf_f = 16 * mid_f[:, :8, :] + my * (mid_f[:, 1:9, :] - mid_f[:, :8, :])
    vf_r = 16 * hsrc[:, :8, :] + my * (hsrc[:, 1:9, :] - hsrc[:, :8, :])
    sh_v = 4 + ib
    ird = (1 << ib) >> 1
    outb = torch.where(
        my != 0,
        torch.where(mx != 0, (vf_f + ((1 << sh_v) >> 1)) >> sh_v,
                    (vf_r + 8) >> 4),
        torch.where(mx != 0, (mid_f[:, :8, :] + ird) >> ib, hsrc[:, :8, :]),
    )
    return outb.clamp(0, pxmax)


def _prep_out(stack, d, case, vw, vh, bpc):
    """One case of 8-tap prep tiles (mega.py _prep_out): 0 = h+v, 1 = h,
    2 = v, 3 = copy; int16 intermediates."""
    ib = intermediate_bits(bpc)
    bias = 0 if bpc == 8 else 8192
    sh = 6 - ib
    if case == 0:
        win = T._gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX] - 3, 15,
                        vw, vh)
        fh, fv = T._filters(d)
        mid = T._i16((T.htap(win, fh) + ((1 << sh) >> 1)) >> sh)
        out = ((T.vtap(mid, fv) + 32) >> 6) - bias
    elif case == 1:
        win = T._gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX] - 3, 15, vw, vh)
        ho = T.htap(win, T._filters(d)[0])
        out = ((ho + ((1 << sh) >> 1)) >> sh) - bias
    elif case == 2:
        win = T._gather(stack, d[D_SROW], d[D_SY] - 3, 15, d[D_SX], 8, vw, vh)
        vo = T.vtap(win, T._filters(d)[1])
        out = ((vo + ((1 << sh) >> 1)) >> sh) - bias
    else:
        win = T._gather(stack, d[D_SROW], d[D_SY], 8, d[D_SX], 8, vw, vh)
        out = (win << ib) - bias
    return T._i16(out)


def _warp_out(stack, d, vw, vh, bpc):
    """8x8 affine warp tiles before their final rounding (mega.py
    _warp_out); the filter index is clamped to the table."""
    F = tables(stack.device)["mc_warp_filter"]
    nF = F.shape[0] - 1
    d_ = stack.device
    ib = intermediate_bits(bpc)
    region = T._gather(stack, d[W_SROW], d[W_SY] - 3, 15, d[W_SX] - 3, 15,
                       vw, vh)
    ys = _ar(15, d_)[None, :, None]
    xs = _ar(8, d_)[None, None, :]
    tmx = (d[W_MX][:, None, None] + ys * d[W_B][:, None, None]
           + xs * d[W_A][:, None, None])
    taps = F[(64 + ((tmx + 512) >> 10)).clamp(0, nF).long()]
    sh = 7 - ib
    mid = (region.unfold(2, 8, 1) * taps).sum(-1, dtype=I32)
    mid = T._i16((mid + ((1 << sh) >> 1)) >> sh)
    ys8 = _ar(8, d_)[None, :, None]
    tmy = (d[W_MY][:, None, None] + ys8 * d[W_D][:, None, None]
           + xs * d[W_C][:, None, None])
    vtaps = F[(64 + ((tmy + 512) >> 10)).clamp(0, nF).long()]
    return (mid.unfold(1, 8, 1) * vtaps).sum(-1, dtype=I32)


def _as_stack(refs, vw, vh):
    """A (S, H, W) stack of reference planes from a stacked tensor or a
    sequence of planes (a zero plane of the visible size for none, which
    reads as 0 wherever a tile reads it)."""
    if isinstance(refs, torch.Tensor):
        return refs
    if not len(refs):
        return torch.zeros((1, max(vh, 1), max(vw, 1)), dtype=torch.uint8)
    return torch.stack(list(refs))


def inter(planes, ra, dev, hdr, runs, stackY, stackC, *, ah, aw, bpc, vwY,
          vhY, vwC, vhC):
    """The frame's whole inter phase (mega.py inter_prog): on the card one
    cooperative launch of the inter kernel (inter_kernels, ops/cuda/
    inter.py), which writes `planes` in place and returns it; on the CPU
    the plain version `inter_plain`. stackY and stackC are the reference
    planes the descriptors' stack rows name, as a stacked (S, H, W) tensor
    or a sequence of (H, W) planes (the kernel reads each through its
    pointer; the plain version stacks them)."""
    kw = dict(ah=ah, aw=aw, bpc=bpc, vwY=vwY, vhY=vhY, vwC=vwC, vhC=vhC)
    if planes.device.type == "cpu":
        return inter_plain(planes, ra, dev, hdr, runs,
                           _as_stack(stackY, vwY, vhY),
                           _as_stack(stackC, vwC, vhC), **kw)
    return inter_kernels(planes, ra, dev, hdr, runs, stackY, stackC, **kw)


def inter_kernels(planes, ra, dev, hdr, runs, stackY, stackC, *, ah, aw, bpc,
                  vwY, vhY, vwC, vhC, k=cuda_inter):
    """`inter` through the inter kernel of `k` (ops/cuda/inter.py, whose
    wrapper launches it on the card; the CPU tests pass the source's host
    build): one launch over every slot run of the frame and the residual
    add, into `planes` in place (made contiguous first). The pools are
    scratch of the packer's limit that the kernel zeroes where a combine,
    a blend or seguv reads. Returns the planes."""
    d_ = planes.device
    rows = cuda_inter.pool_rows(ah, aw)
    planes = planes.contiguous()
    pool = torch.empty(rows * 64, dtype=I32, device=d_)
    lap = torch.empty(rows * 64, dtype=I32, device=d_)
    mask = torch.empty(ah * aw, dtype=I32, device=d_)
    k.inter_frame(planes, ra, dev, hdr, runs, stackY, stackC, pool, lap,
                  mask, ah=ah, aw=aw, bpc=bpc, vwY=vwY, vhY=vhY, vwC=vwC,
                  vhC=vhC)
    return planes


inter_plain_calls = 0  # calls of inter_plain (none on the card's path)


def inter_plain(planes, ra, dev, hdr, runs, stackY, stackC, *, ah, aw, bpc,
                vwY, vhY, vwC, vhC):
    """The plain version of `inter` (mega.py inter_prog in torch): puts and
    warps into the planes, OBMC laps into the lap pool, preps into the
    compound pool, the compound combines, the OBMC lap blends, then the
    batch residual add. `runs` is the packer's {slot: [InterRun]}
    (engine/pack.py), `stackY` and `stackC` the reference planes (uint8,
    or int16 above 8 bits) the descriptors' stack rows name. Each run is
    one batch: the tiles of a slot write disjoint pixels, except the
    blends, whose top-lap run is finished before the left-lap run starts.
    Pools are sized to the packer's limit, (8 * psz) // 64 rows (the JAX
    program allocates 6/8 of it and clamps beyond)."""
    global inter_plain_calls
    inter_plain_calls += 1
    d_ = dev.device
    psz = ah * aw
    ib = intermediate_bits(bpc)
    pxmax = (1 << bpc) - 1
    poolrows = (8 * psz) // 64
    hbase = int(hdr[IH0])
    pf = torch.cat([planes.reshape(-1), torch.zeros(1, dtype=I32, device=d_)])
    pools = {}

    def pool(name, n):
        if name not in pools:
            pools[name] = torch.zeros(n + 1, dtype=I32, device=d_)
        return pools[name]

    def pool_tiles(name, rows):
        p = pool(name, poolrows * 64)[:-1].view(poolrows, 8, 8)
        return p[rows.clamp(0, poolrows - 1).long()]

    def each(name, rows):
        for run in runs.get(name, ()):
            yield run, _run_rows(dev, hdr, name, rows, run)

    geo = {"Y": (stackY, vwY, vhY), "C": (stackC, vwC, vhC)}

    # 1. puts into the planes / the OBMC lap pool
    for kind in ("put", "lap"):
        for pl in ("Y", "C"):
            stack, vw, vh = geo[pl]
            for run, d in each(kind + pl, NPUT):
                out = _put_out(stack, d, min(max(run.case, 0), 4), vw, vh,
                               bpc)
                if kind == "lap":
                    _scatter8(pool("lap", poolrows * 64), out, d[D_FLAT0],
                              d[D_TW], d[D_TH], 8)
                else:
                    _scatter8(pf, out, d[D_FLAT0], d[D_TW], d[D_TH], aw)

    # 2. warp puts
    for pl in ("Y", "C"):
        stack, vw, vh = geo[pl]
        for _, d in each("warp" + pl, NWARP):
            sh = 7 + ib
            out = ((_warp_out(stack, d, vw, vh, bpc) + ((1 << sh) >> 1))
                   >> sh).clamp(0, pxmax)
            _scatter8(pf, out, d[W_FLAT0], d[W_TW], d[W_TH], aw)

    # 3. compound preps into the pool: 8-tap, warp, then the host's tiles
    for pl in ("Y", "C"):
        stack, vw, vh = geo[pl]
        for run, d in each("prep" + pl, NPUT):
            out = _prep_out(stack, d, min(max(run.case, 0), 3), vw, vh, bpc)
            _scatter8(pool("pool", poolrows * 64), out, d[D_FLAT0], d[D_TW],
                      d[D_TH], 8)
    for pl in ("Y", "C"):
        stack, vw, vh = geo[pl]
        for _, d in each("wprep" + pl, NWARP):
            bias = 0 if bpc == 8 else 8192
            out = T._i16(((_warp_out(stack, d, vw, vh, bpc) + 64) >> 7) - bias)
            _scatter8(pool("pool", poolrows * 64), out, d[W_FLAT0], d[W_TW],
                      d[W_TH], 8)
    for run in runs.get("hostpool", ()):
        # chunk layout: HB row ids, then HB 8x8 int32 tiles
        d = _run_rows(dev, hdr, "hostpool", 65, run, HB)
        idx = (d[0].long()[:, None] * 64
               + torch.arange(64, dtype=torch.int64, device=d_)[None, :])
        _scatter_drop(pool("pool", poolrows * 64), idx, d[1:].T)

    # 4. compound combines
    rnd_avg = (8 << ib) + (0 if bpc == 8 else 8192) * 16
    rnd_msk = (32 << ib) + (0 if bpc == 8 else 8192) * 64
    r8 = _ar(8, d_)
    for _, d in each("avg", NCOMB):
        t1 = pool_tiles("pool", d[C_R0])
        t2 = pool_tiles("pool", d[C_R1])
        wt = d[C_P0][:, None, None]
        out = (t1 * wt + t2 * (16 - wt) + rnd_avg) >> (ib + 4)
        _scatter8(pf, out.clamp(0, pxmax), d[C_FLAT0], d[C_TW], d[C_TH], aw)

    mask_sh = bpc + ib - 4
    mask_rnd = 1 << (mask_sh - 5)
    for name, sh_, sv_ in (("segy00", 0, 0), ("segy10", 1, 0),
                           ("segy11", 1, 1)):
        for _, d in each(name, NCOMB):
            t1 = pool_tiles("pool", d[C_R0])
            t2 = pool_tiles("pool", d[C_R1])
            m = torch.clamp(38 + (((t1 - t2).abs() + mask_rnd) >> mask_sh),
                            max=64)
            out = (t1 * m + t2 * (64 - m) + rnd_msk) >> (ib + 6)
            _scatter8(pf, out.clamp(0, pxmax), d[C_FLAT0], d[C_TW], d[C_TH],
                      aw)
            signs = d[C_P2][:, None, None]
            if sh_:
                mn = m[:, :, 0::2] + m[:, :, 1::2]
                if sv_:
                    msk = (mn[:, 0::2, :] + mn[:, 1::2, :] + 2 - signs) >> 2
                else:
                    msk = (mn + 1 - signs) >> 1
            else:
                msk = m
            r = _ar(8 >> sv_, d_)
            c = _ar(8 >> sh_, d_)
            midx = (d[C_P0][:, None, None]
                    + r[None, :, None] * d[C_P1][:, None, None]
                    + c[None, None, :])
            valid = (r[None, :, None] < ((d[C_TH][:, None, None] + sv_) >> sv_)
                     ) & (c[None, None, :]
                          < ((d[C_TW][:, None, None] + sh_) >> sh_))
            _scatter_drop(pool("mask", psz),
                          torch.where(valid, midx, torch.full_like(midx, -1)),
                          msk)

    for _, d in each("mask", NCOMB):
        # wedge masks gather from the blob's mask region
        t1 = pool_tiles("pool", d[C_R0])
        t2 = pool_tiles("pool", d[C_R1])
        midx = (hbase + d[C_P0][:, None, None]
                + r8[None, :, None] * d[C_P1][:, None, None]
                + r8[None, None, :])
        m = _gather(dev, midx)
        out = (t1 * m + t2 * (64 - m) + rnd_msk) >> (ib + 6)
        _scatter8(pf, out.clamp(0, pxmax), d[C_FLAT0], d[C_TW], d[C_TH], aw)

    for _, d in each("seguv", NCOMB):
        t1 = pool_tiles("pool", d[C_R0])
        t2 = pool_tiles("pool", d[C_R1])
        midx = (d[C_P0][:, None, None]
                + r8[None, :, None] * d[C_P1][:, None, None]
                + r8[None, None, :])
        m = pool("mask", psz)[midx.clamp(0, psz - 1).long()]
        out = (t1 * m + t2 * (64 - m) + rnd_msk) >> (ib + 6)
        _scatter8(pf, out.clamp(0, pxmax), d[C_FLAT0], d[C_TW], d[C_TH], aw)

    # 5. OBMC lap blends: the top-lap run, then the left-lap run
    for _, d in each("blend", NBLEND):
        idx = (d[B_FLAT0][:, None, None] + r8[None, :, None] * aw
               + r8[None, None, :])
        a = pf[idx.clamp(0, 3 * psz - 1).long()]
        b = pool_tiles("lap", d[B_ROW])
        midx = (hbase + d[B_MOFF][:, None, None]
                + r8[None, :, None] * d[B_MRS][:, None, None]
                + r8[None, None, :] * d[B_MCS][:, None, None])
        m = _gather(dev, midx)
        out = (a * (64 - m) + b * m + 32) >> 6
        valid = (r8[None, :, None] < d[B_TH][:, None, None]) & (
            r8[None, None, :] < d[B_TW][:, None, None])
        _scatter_drop(pf, torch.where(valid, idx, torch.full_like(idx, -1)),
                      out)

    # 6. the batch-phase residual add (zero outside batch-phase blocks)
    rb = ra[3 * psz : 6 * psz].view(3, ah, aw)
    return (pf[: 3 * psz].view(3, ah, aw) + rb).clamp(0, pxmax)


# ------------------------------ wavefront --------------------------------


def palette_pf(planes, dev, hdr):
    """The planes flat with a trash word at 3*psz, after the palette
    scatters."""
    pf = torch.cat([planes.reshape(-1),
                    torch.zeros(1, dtype=I32, device=planes.device)])
    pn = int(hdr[PAL0 + 1])
    if pn:
        d = _region(dev, int(hdr[PAL0]), pn * 2 * PAL_B).view(pn, 2, PAL_B)
        _scatter_drop(pf, d[:, 0].reshape(-1), d[:, 1].reshape(-1))
    return pf


def wave(planes, ra, dev, hdr, waves, *, ah, aw, bpc, ss_hor, ss_ver):
    """Palette scatters then the intra wavefront, wave by wave (the
    recon_b_intra order of src/recon.rs:2402): on the card one persistent
    launch of the wave kernel per frame, a grid-wide barrier between its
    levels (ops/cuda/wave.py wave_frame), the plain version `wave_plain` on
    the CPU. `waves` is the packer's per-wave host view (engine/pack.py
    FramePack.waves); only its item counts are read here."""
    if planes.device.type == "cpu":
        return wave_plain(planes, ra, dev, hdr, waves, ah=ah, aw=aw, bpc=bpc,
                          ss_hor=ss_hor, ss_ver=ss_ver)
    psz = ah * aw
    pf = palette_pf(planes, dev, hdr)
    if waves:
        cuda_wave.wave_frame(pf, ra, dev, hdr, waves, aw=aw, psz=psz,
                             bpc=bpc, ss_hor=ss_hor, ss_ver=ss_ver)
    return pf[: 3 * psz].view(3, ah, aw)


def wave_plain(planes, ra, dev, hdr, waves, *, ah, aw, bpc, ss_hor, ss_ver):
    """The plain version of `wave` (mega.py wave_prog in torch): per wave,
    engine/wave.py class_step on the small class's items, then on the
    large class's."""
    psz = ah * aw
    pf = palette_pf(planes, dev, hdr)
    resid_ = ra[: 3 * psz]

    if not waves:
        return pf[: 3 * psz].view(3, ah, aw)
    mask_base = int(hdr[WAVE0 + 3])  # interintra masks (inter frames)
    # every wave's descriptors and edge plans, one batch per class: the
    # plans depend only on descriptors, never on pixels
    classes = []
    for reg, cap, (CW, CH) in ((WAVE0 + 1, CAP[0], CLS_S),
                               (WAVE0 + 2, CAP[1], CLS_L)):
        rows = _region(dev, int(hdr[reg]), len(waves) * cap * N_FIELDS)
        rows = rows.view(len(waves), cap, N_FIELDS)
        coords = build_coords(unpack(rows.reshape(-1, N_FIELDS)), CW, CH, aw,
                              psz, bpc).view(len(waves), cap, -1)
        classes.append((rows, coords, CW, CH))
    for i, per in enumerate(waves):
        for (rows, coords, CW, CH), (rows_np, n, flags, modes) in zip(
                classes, per):
            if n == 0:
                continue
            filt = rows_np[:n][rows_np[:n, FI["modes"]] == FILTER_PRED]
            filt_ext = ((int(filt[:, FI["w"]].max()), int(filt[:, FI["h"]].max()))
                        if filt.size else (0, 0))
            class_step(pf, resid_, rows[i, :n], coords[i, :n], CW, CH, bpc,
                       ss_hor, ss_ver, aw, psz, flags, modes, filt_ext,
                       dev, mask_base)
    return pf[: 3 * psz].view(3, ah, aw)


# ------------------------------- filters ---------------------------------


def filter_(planes, dev, hdr, *, geom, bpc, layout_i, lr_ws, sr_geom=None):
    """Deblock -> CDEF -> superres -> loop restoration -> packed output.
    geom = (ah, aw, ach, acw, bh, bw, cur_h); layout_i = PixelLayout int;
    lr_ws = (Wy, Wc) LR stripe tile widths; sr_geom = (s_ah, s_aw, sr_w,
    sr_h, srcw_y), the upscaled planes' shape, the upscaled picture's size
    and the coded luma width, or None without superres. Returns (planes,
    packed output: the whole luma plane then the (ach, acw) chroma planes,
    uint8 at 8 bits, int16 at 10 and 12). On the card the hand-written
    filter kernels (filter_kernels: two deblock launches, one CDEF launch,
    one superres launch with sr_geom, one Wiener launch if any plane has
    such stripes, one self-guided launch if any plane has such stripes); on
    the CPU the plain version `filter_plain`."""
    kw = dict(geom=geom, bpc=bpc, layout_i=layout_i, lr_ws=lr_ws,
              sr_geom=sr_geom)
    if planes.device.type == "cpu":
        return filter_plain(planes, dev, hdr, **kw)
    return filter_kernels(planes, dev, hdr, **kw)


def _superres(planes, pre_cdef, hdr, cur_h, sr_geom, ss_hor, ss_ver,
              has_chroma, bpc):
    """The upscale of both the planes and the post-deblock snapshot (plain
    torch: engine/filters.py resize_plane; filter_plain's, the plain
    version of csrc/superres.cu). Returns (planes, pre_cdef, the upscaled
    width, the upscaled picture's rows)."""
    d_ = planes.device
    s_ah, s_aw, sr_w, vis_h, srcw_y = sr_geom
    outs, pres = [], []
    for pl in range(3):
        if pl and not has_chroma:
            z = torch.zeros((s_ah, s_aw), dtype=I32, device=d_)
            outs.append(z)
            pres.append(z)
            continue
        sh = ss_hor if pl else 0
        sv = ss_ver if pl else 0
        ci = 1 if pl else 0
        h = (cur_h + sv) >> sv
        args = (h, (sr_w + sh) >> sh, (srcw_y + sh) >> sh,
                int(hdr[SR0 + 2 * ci]), int(hdr[SR0 + 2 * ci + 1]), bpc,
                s_aw)
        outs.append(F.pad(FL.resize_plane(planes[pl], *args),
                          (0, 0, 0, s_ah - h)))
        pres.append(F.pad(FL.resize_plane(pre_cdef[pl], *args),
                          (0, 0, 0, s_ah - h)))
    return torch.stack(outs), torch.stack(pres), s_aw, vis_h


def _pack_out(planes, ach, acw, bpc, has_chroma):
    """The packed output (the only device->host payload)."""
    odt = torch.uint8 if bpc == 8 else torch.int16
    y = planes[0].reshape(-1)
    if has_chroma:
        u = planes[1][:ach, :acw].reshape(-1)
        v = planes[2][:ach, :acw].reshape(-1)
        return torch.cat([y, u, v]).to(odt)
    return y.to(odt)


def filter_kernels(planes, dev, hdr, *, geom, bpc, layout_i, lr_ws,
                   sr_geom=None, k=cuda_filters):
    """`filter_` through the filter kernels of `k` (ops/cuda/filters.py,
    whose wrappers launch them on the card; the CPU tests pass the
    sources' host builds): deblock in place, one launch per direction over
    every plane; the post-deblock snapshot; CDEF from the snapshot into the
    planes, one launch; with sr_geom, the upscale of every plane of the
    planes and the snapshot into a new tensor, one launch; loop
    restoration from the planes and the snapshot into a copy of the
    planes, one Wiener launch and then one self-guided launch, each over
    every plane's stripes of its kind; the packed output."""
    _, _, ach, acw, bh, bw, cur_h = geom
    ss_ver = cuda_filters.subsampling(layout_i)[1]
    kw = dict(bh=bh, bw=bw, layout_i=layout_i, bpc=bpc)
    planes = planes.contiguous()
    k.lf_pass(planes, dev, hdr, False, **kw)
    k.lf_pass(planes, dev, hdr, True, **kw)
    pre_cdef = planes.clone()  # post-deblock snapshot: CDEF's input, LR's lpf
    k.cdef_frame(planes, pre_cdef, dev, hdr, **kw)
    vis_h = cur_h
    if sr_geom is not None:
        sr = k.superres_frame(planes, pre_cdef, hdr, cur_h=cur_h,
                              sr_geom=sr_geom, layout_i=layout_i, bpc=bpc)
        planes, pre_cdef, vis_h = sr[0], sr[1], sr_geom[3]
    lr = cuda_filters.lr_planes(hdr, layout_i)
    if lr:
        out = planes.clone()  # every stripe reads the planes before any write
        phs = tuple((vis_h + sv) >> sv for sv in (0, ss_ver, ss_ver))
        Ws = (lr_ws[0], lr_ws[1], lr_ws[1])
        kw = dict(layout_i=layout_i, phs=phs, Ws=Ws, bpc=bpc)
        if any(wiener for _, wiener, _ in lr):
            k.lr_wiener_frame(out, planes, pre_cdef, dev, hdr, **kw)
        if any(sgr for _, _, sgr in lr):
            k.lr_sgr_frame(out, planes, pre_cdef, dev, hdr, **kw)
        planes = out
    return planes, _pack_out(planes, ach, acw, bpc, layout_i != 0)


def filter_plain(planes, dev, hdr, *, geom, bpc, layout_i, lr_ws,
                 sr_geom=None):
    """The plain version of `filter_` (mega.py filter_prog in torch):
    engine/filters.py's deblock, CDEF, superres and LR passes."""
    d_ = dev.device
    ah, aw, ach, acw, bh, bw, cur_h = geom
    ss_hor = 0 if layout_i == 3 else 1
    ss_ver = 1 if layout_i == 1 else 0
    has_chroma = layout_i != 0
    h4, w4 = bh, bw
    ch4 = (bh + ss_ver) >> ss_ver
    cw4 = (bw + ss_hor) >> ss_hor

    # ---- deblock: 6 passes over byte-packed class|level maps ----
    eih = _region(dev, int(hdr[DB0]), 128).view(2, 64)

    def db(pl_idx, pass_i, nh4, nw4, luma, hor):
        b = u8_region(dev, int(hdr[DB0 + 1 + pass_i]), nh4 * nw4)
        cm = (b >> 6).reshape(nh4, nw4)
        lv = (b & 63).reshape(nh4, nw4)
        planes[pl_idx] = FL.lf_dir_pass(planes[pl_idx], cm, lv, eih, luma,
                                        hor, bpc)

    # maps are stored post-transpose for horizontal passes (host resolve)
    db(0, 0, h4, w4, True, False)
    if has_chroma:
        db(1, 1, ch4, cw4, False, False)
        db(2, 2, ch4, cw4, False, False)
    db(0, 3, w4, h4, True, True)
    if has_chroma:
        db(1, 4, cw4, ch4, False, True)
        db(2, 5, cw4, ch4, False, True)

    pre_cdef = planes.clone()  # post-deblock snapshot for LR's lpf lines

    # ---- cdef: level maps as bytes; strengths derived on device ----
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    bdm8 = bpc - 8
    ylvl = u8_region(dev, int(hdr[CDEF0]), nby * nbx).reshape(nby, nbx)
    uvlvl = u8_region(dev, int(hdr[CDEF0 + 1]), nby * nbx).reshape(nby, nbx)
    damping = int(hdr[CDEF0 + 2])
    y_pri = (ylvl >> 2) << bdm8
    y_sec = ylvl & 3
    y_sec = torch.where(y_sec == 3, torch.full_like(y_sec, 4), y_sec) << bdm8
    uv_pri = (uvlvl >> 2) << bdm8
    uv_sec = uvlvl & 3
    uv_sec = torch.where(uv_sec == 3, torch.full_like(uv_sec, 4), uv_sec) << bdm8
    maps = torch.stack([y_pri, y_sec, uvlvl, uv_pri, uv_sec])
    uv422 = -1 if layout_i == 0 else (1 if layout_i == 2 else 0)
    FL.cdef_pass(planes, maps, damping, nby, nbx, bh, bw, ss_hor, ss_ver,
                 uv422, bpc)

    # ---- superres: both the planes and the post-deblock snapshot ----
    vis_h = cur_h
    if sr_geom is not None:
        planes, pre_cdef, aw, vis_h = _superres(
            planes, pre_cdef, hdr, cur_h, sr_geom, ss_hor, ss_ver, has_chroma,
            bpc)

    # ---- loop restoration: stripes of each (kind, plane) slot ----
    Wy, Wc = lr_ws
    for pl in range(3):
        if pl and not has_chroma:
            continue
        sv = ss_ver if pl else 0
        ph = (vis_h + sv) >> sv
        W = Wc if pl else Wy
        plane = planes[pl]
        cat = torch.cat([plane[:ph], pre_cdef[pl][:ph]])
        pfl = None
        for ki, kind in enumerate(("w", 0, 1, 2)):
            n = int(hdr[LR0 + 2 * (4 * pl + ki) + 1])
            if not n:
                continue
            base = int(hdr[LR0 + 2 * (4 * pl + ki)])
            # all chunks of the slot at once: they read only `cat` and
            # write disjoint stripes
            d = _region(dev, base, n * 16 * LRB).view(n, 16, LRB)
            d = d.permute(1, 0, 2).reshape(16, n * LRB)
            if pfl is None:
                pfl = torch.cat([plane.reshape(-1),
                                 torch.zeros(1, dtype=I32, device=d_)])
            if kind == "w":
                FL.lr_wiener_pass(pfl, cat, d, W, bpc, aw)
            else:
                FL.lr_sgr_pass(pfl, cat, d, W, kind, bpc, aw)
        if pfl is not None:
            planes[pl] = pfl[:-1].view(plane.shape)

    return planes, _pack_out(planes, ach, acw, bpc, has_chroma)
