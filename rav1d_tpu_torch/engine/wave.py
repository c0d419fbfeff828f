"""One wave level of one size class of the intra wavefront, on torch.

Port of rav1d_tpu/engine/wave2.py `_class_step` and `_build_coords`:
gather each item's edge from the current planes, predict, add the
residual, and scatter the disjoint blocks back. Items of a wave are
independent, so the step is one batch.

Where the JAX step computes all fourteen modes and selects (its compile
keys must not depend on content), the port computes only the modes the
host says are present in this wave and class, and only over the wave's
filled lanes; every lane still gets exactly its own mode's prediction.
The JAX step's optimization barriers work around an XLA fusion problem
and have no counterpart here.

`class_step` is the plain version of the wave kernel (ops/cuda/wave.py,
csrc/wave.cu), which runs every item of a level, both classes, in one
launch on the card; `calls` counts class_step's calls, so a run can show
that the card's wavefront made none.
"""

from __future__ import annotations

import torch

from ..ops import ipred_dyn as D
from ..syntax.levels import (
    DC_128_PRED, DC_PRED, FILTER_PRED, HOR_PRED, LEFT_DC_PRED, PAETH_PRED,
    SMOOTH_H_PRED, SMOOTH_PRED, SMOOTH_V_PRED, TOP_DC_PRED, VERT_PRED,
    Z1_PRED, Z2_PRED, Z3_PRED,
)
from .layout import F_II, FIELDS
from .plan import (
    MODE_CFL_128, MODE_CFL_DC, MODE_CFL_LEFT, MODE_CFL_TOP, MODE_IDENT,
)

I32 = torch.int32
calls = 0

BASE_FNS = {
    DC_PRED: D.dc_dyn,
    VERT_PRED: D.v_dyn,
    HOR_PRED: D.h_dyn,
    LEFT_DC_PRED: D.dc_left_dyn,
    TOP_DC_PRED: D.dc_top_dyn,
    DC_128_PRED: D.dc_128_dyn,
    SMOOTH_PRED: D.smooth_dyn,
    SMOOTH_V_PRED: D.smooth_v_dyn,
    SMOOTH_H_PRED: D.smooth_h_dyn,
    PAETH_PRED: D.paeth_dyn,
}

CFL_DC_FNS = {
    MODE_CFL_DC: D.dc_dyn,
    MODE_CFL_TOP: D.dc_top_dyn,
    MODE_CFL_LEFT: D.dc_left_dyn,
    MODE_CFL_128: D.dc_128_dyn,
}

Z_MODES = (Z1_PRED, Z2_PRED, Z3_PRED)
KNOWN = set(BASE_FNS) | set(CFL_DC_FNS) | set(Z_MODES) | {FILTER_PRED, MODE_IDENT}


def unpack(rows):
    """(n, N_FIELDS) int32 device rows -> dict of (n,) field tensors."""
    d = {}
    for i, k in enumerate(FIELDS):
        v = rows[:, i]
        d[k] = (v != 0) if k in ("rmask", "z2sm") else v
    return d


def build_coords(d, CW, CH, aw, psz, bpc):
    """The prepare_intra_edges index plan (B, 2CH+1+2CW) from the
    parametric descriptor: value >= 0 is a flat plane index, value < 0
    decodes to the constant -(v)-1 (src/ipred_prepare.rs:118)."""
    dev = d["flat0"].device
    flat0 = d["flat0"]
    rem = flat0 % psz
    plbase = flat0 - rem
    py = rem // aw
    px = rem % aw
    have_l = (d["hav"] & 1) != 0
    have_t = (d["hav"] & 2) != 0
    phl, phbl = d["phl"], d["phbl"]
    pht, phtr = d["pht"], d["phtr"]
    w = d["w"]
    h = d["h"]
    half = (1 << bpc) >> 1
    constL = torch.full_like(flat0, -(half + 1 + 1))  # left fill, -(c+1)
    constT = torch.full_like(flat0, -(half - 1 + 1))  # top fill
    constC = torch.full_like(flat0, -(half + 1))      # corner

    top0 = plbase + (py - 1) * aw + px - have_l.to(I32)
    leftpix = plbase + py * aw + (px - 1)
    left_fill = torch.where(have_t, top0, constL)
    top_fill = torch.where(have_l, leftpix, constT)
    corner = torch.where(have_t, top0, torch.where(have_l, leftpix, constC))

    colbase = plbase + (px - 1)

    def left_at(i):
        return torch.where(
            have_l[:, None],
            colbase[:, None] + (py[:, None]
                                + torch.minimum(i, phl[:, None] - 1)) * aw,
            left_fill[:, None],
        )

    j = torch.arange(2 * CH, dtype=I32, device=dev)[None, :]
    k = 2 * CH - 1 - j
    hh = h[:, None]
    lval = left_at(k)
    l_last = left_at(hh - 1)
    bl_repl = colbase[:, None] + (
        py[:, None] + hh + torch.minimum(k - hh, phbl[:, None] - 1)
    ) * aw
    blval = torch.where(phbl[:, None] > 0, bl_repl, l_last)
    neg1 = torch.full_like(lval, -1)
    bottom = torch.where(k < hh, lval, torch.where(k < 2 * hh, blval, neg1))

    rowbase = plbase + (py - 1) * aw + px

    def top_at(i):
        return torch.where(
            have_t[:, None],
            rowbase[:, None] + torch.minimum(i, pht[:, None] - 1),
            top_fill[:, None],
        )

    j2 = torch.arange(2 * CW, dtype=I32, device=dev)[None, :]
    ww = w[:, None]
    tval = top_at(j2)
    t_last = top_at(ww - 1)
    tr_repl = rowbase[:, None] + ww + torch.minimum(j2 - ww, phtr[:, None] - 1)
    trval = torch.where(phtr[:, None] > 0, tr_repl, t_last)
    neg1 = torch.full_like(tval, -1)
    top = torch.where(j2 < ww, tval, torch.where(j2 < 2 * ww, trval, neg1))

    return torch.cat([bottom, corner[:, None], top], dim=1)


def class_step(pf, resid, rows, coords, CW, CH, bpc, ss_hor, ss_ver, aw,
               psz, flags, modes, filt_ext, maskbuf, mask_base):
    """One wave step for one size class, in place on pf.

    pf: (3*psz + 1,) int32 flat planes with a trash word at 3*psz (the
    target of every dropped write); resid: (3*psz,) residuals; rows:
    (n, N_FIELDS) device descriptors of the wave's filled lanes and coords
    their build_coords edge plans; flags, modes, filt_ext: the host's
    feature bits, modes present, and the largest filter-intra block (w, h)
    of these lanes; maskbuf: the word buffer (the frame blob) that holds
    the interintra blend masks from word mask_base on."""
    global calls
    calls += 1
    dev = pf.device
    n3 = 3 * psz
    C = 2 * CH
    d = unpack(rows)
    w = d["w"]
    h = d["h"]
    edge = torch.where(coords < 0, -coords - 1,
                       pf[coords.clamp(0, n3 - 1).long()])
    m3 = d["modes"][:, None, None]
    angles = d["angles"]
    pxmax = (1 << bpc) - 1
    present = set(modes)

    out = None

    def put(out, code, pred):
        if out is None:
            return pred.expand(rows.shape[0], CH, CW)
        return torch.where(m3 == code, pred, out)

    base = [c for c in BASE_FNS if c in present]
    if present - KNOWN and DC_PRED not in base:
        base.insert(0, DC_PRED)  # unknown codes predict DC, as in JAX
    for code in base:
        out = put(out, code, BASE_FNS[code](edge, C, CW, CH, w, h, bpc))
    if Z1_PRED in present:
        out = put(out, Z1_PRED, D.z1_dyn(edge, C, CW, CH, w, h, bpc, angles))
    if Z2_PRED in present:
        out = put(out, Z2_PRED, D.z2_dyn(edge, C, CW, CH, w, h, bpc, angles,
                                         d["z2mw"], d["z2mh"], d["z2sm"]))
    if Z3_PRED in present:
        out = put(out, Z3_PRED, D.z3_dyn(edge, C, CW, CH, w, h, bpc, angles))
    if FILTER_PRED in present:
        out = put(out, FILTER_PRED,
                  D.filter_dyn(edge, C, CW, CH, w, h, bpc, angles,
                               ext_w=filt_ext[0], ext_h=filt_ext[1]))

    dy = torch.arange(CH, dtype=I32, device=dev)[None, :, None] * aw
    dx = torch.arange(CW, dtype=I32, device=dev)[None, None, :]
    idx = d["flat0"][:, None, None] + dy + dx

    if MODE_IDENT in present:
        out = put(out, MODE_IDENT, pf[idx.clamp(0, n3 - 1).long()])
    cfl = [c for c in CFL_DC_FNS if c in present]
    if cfl:
        ldy = torch.arange(CH << ss_ver, dtype=I32, device=dev)[None, :, None] * aw
        ldx = torch.arange(CW << ss_hor, dtype=I32, device=dev)[None, None, :]
        lidx = d["cfl0"][:, None, None] + ldy + ldx
        ypx = pf[lidx.clamp(0, n3 - 1).long()]
        ac = D.cfl_ac_dyn(ypx, CW, CH, w, h, ss_hor, ss_ver,
                          d["cflwp"], d["cflhp"])
        for code in cfl:
            dc = CFL_DC_FNS[code](edge, C, CW, CH, w, h, bpc)[:, 0, 0]
            out = put(out, code, D.cfl_pred_dyn(dc, ac, d["cfla"], bpc))

    if flags & F_II:
        # interintra: blend the intra prediction over the block's inter
        # pixels by its mask, stored at the class width's stride
        own = pf[idx.clamp(0, n3 - 1).long()]
        moff = d["iioff"]
        dyl = torch.arange(CH, dtype=I32, device=dev)[None, :, None]
        midx = mask_base + moff[:, None, None] + dyl * CW + dx
        m = maskbuf[midx.clamp(0, maskbuf.shape[0] - 1).long()]
        blended = (own * (64 - m) + out * m + 32) >> 6
        out = torch.where((moff >= 0)[:, None, None], blended, out)

    res = resid[idx.clamp(0, resid.shape[0] - 1).long()]
    out = torch.where(d["rmask"][:, None, None],
                      (out + res).clamp(0, pxmax), out)
    mask = (dx < w[:, None, None]) & (
        torch.arange(CH, dtype=I32, device=dev)[None, :, None] < h[:, None, None]
    )
    idx = torch.where(mask & (idx >= 0) & (idx < n3), idx,
                      torch.full_like(idx, n3))
    pf[idx.reshape(-1).long()] = out.reshape(-1)
