"""The device engine's three intra-frame programs on torch.

Ports of rav1d_tpu/engine/mega.py resid_prog, wave_prog and filter_prog
(without superres). Every program reads the frame's descriptors from the
one uploaded int32 blob `dev`, at the word offsets of the header; the trip
counts and feature gates that JAX reads from the device blob come from the
host header `hdr` and the packer's counts instead, so no count is ever
read back from the device during a frame.

Layout conventions (as in the JAX engine): `ra` is the (6*psz,) residual
buffer, [0, 3psz) for the wavefront's blocks; planes are (3, ah, aw)
int32. Flat buffers written by scatters carry one trash word at the end:
out-of-range writes land there, as JAX's mode="drop" discards them.
"""

from __future__ import annotations

import torch

from ..ops.cuda import itx as cuda_itx
from ..syntax.levels import FILTER_PRED
from . import filters as FL
from .kernels import itx_any_core, wht_core
from .layout import (
    CDEF0, CF0, DB0, FI, LR0, LRB, N_FIELDS, PAL0, PAL_B, R0, SIZES, WAVE0,
    WHT0, WHT_B, chunk_for,
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


# ------------------------------ wavefront --------------------------------


def wave(planes, ra, dev, hdr, waves, *, ah, aw, bpc, ss_hor, ss_ver):
    """Palette scatters then the intra wavefront, wave by wave (the
    recon_b_intra order of src/recon.rs:2402). `waves` is the packer's
    per-wave host view (engine/pack.py FramePack.waves)."""
    psz = ah * aw
    pf = torch.cat([planes.reshape(-1),
                    torch.zeros(1, dtype=I32, device=planes.device)])
    resid_ = ra[: 3 * psz]

    pn = int(hdr[PAL0 + 1])
    if pn:
        d = _region(dev, int(hdr[PAL0]), pn * 2 * PAL_B).view(pn, 2, PAL_B)
        _scatter_drop(pf, d[:, 0].reshape(-1), d[:, 1].reshape(-1))

    if not waves:
        return pf[: 3 * psz].view(3, ah, aw)
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
                       ss_hor, ss_ver, aw, psz, flags, modes, filt_ext)
    return pf[: 3 * psz].view(3, ah, aw)


# ------------------------------- filters ---------------------------------


def filter_(planes, dev, hdr, *, geom, bpc, layout_i, lr_ws):
    """Deblock -> CDEF -> loop restoration -> packed output.
    geom = (ah, aw, ach, acw, bh, bw, cur_h); layout_i = PixelLayout int;
    lr_ws = (Wy, Wc) LR stripe tile widths. Returns (planes, packed uint8
    output: the whole luma plane then the (ach, acw) chroma planes)."""
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

    # ---- loop restoration: stripes of each (kind, plane) slot ----
    Wy, Wc = lr_ws
    for pl in range(3):
        if pl and not has_chroma:
            continue
        sv = ss_ver if pl else 0
        ph = (cur_h + sv) >> sv
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

    # ---- pack the output (the only device->host payload) ----
    y = planes[0].reshape(-1)
    if has_chroma:
        u = planes[1][:ach, :acw].reshape(-1)
        v = planes[2][:ach, :acw].reshape(-1)
        packed = torch.cat([y, u, v]).to(torch.uint8)
    else:
        packed = y.to(torch.uint8)
    return planes, packed
