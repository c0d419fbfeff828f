"""Host packers: serialize one decoded frame's plan into the frame blob.

The functions from _chunked to _pack_lr, the inter packer (_pack_slot,
_plan_inter_v3) included, are copies of rav1d_tpu/engine/run2.py's numpy
packers (that module imports JAX at load time), changed only in their
import lines and without run2's RAV1D_ENGINE_SKIP stage switch;
tests/test_torch_pack.py and tests/test_torch_inter.py hold the blobs they
write to run2's word for word. `pack_frame` is the packing half of
run2.execute, superres step and start included, and also returns the
host-side counts the device programs loop and branch on, so no program
reads a count back from the device.
"""

from __future__ import annotations

import numpy as np

from ..syntax.levels import WHT_WHT
from .blob import FrameBlob
from .layout import (
    B_MRS, B_TW, C_TW, CDEF0, CF0, D_TW, DB0, FI, HB, HDR_LEN, IH0, INTER0,
    LR0, LRB, NBLEND, NCOMB, NPUT, NWARP, PAL0, PAL_B, R0, SIZES, SLOTS, SR0,
    TB, TXTP_FIRST, TXTP_SECOND, W_TW, WAVE0, WHT0, WHT_B, chunk_for,
)
from .plan import CAP, MODE_CFL_DC, MODE_IDENT, item_class

SIZE_IDX = {wh: i for i, wh in enumerate(SIZES)}


def _chunked(cols_rows, n, B, pads=None):
    """Stack per-item descriptor columns (rows, n) into (nc, rows, B) with
    per-row pad values (default 0)."""
    rows = len(cols_rows)
    nc = max((n + B - 1) // B, 0)
    d = np.zeros((nc, rows, B), np.int32)
    for r in range(rows):
        buf = np.full(nc * B, 0 if pads is None else pads[r], np.int32)
        buf[:n] = cols_rows[r]
        d[:, r, :] = buf.reshape(nc, B)
    return d, nc


# ------------------------------ residuals --------------------------------


def _pack_residuals(blob, hdr, store, plan, psz, aw):
    sels = []
    if plan.wavefront_tx is not None and plan.wavefront_tx.size:
        sels.append((np.asarray(plan.wavefront_tx), 0))
    if plan.inter is not None and plan.batch_tx is not None \
            and plan.batch_tx.size:
        sels.append((np.asarray(plan.batch_tx), 3 * psz))
    if not sels:
        return
    keys, offs, flat0s, f0s, f1s = [], [], [], [], []
    for sel, boff in sels:
        sel = sel[store.eob[sel] >= 0]
        if not sel.size:
            continue
        tps = store.txtp[sel].astype(np.int64)
        ws = store.txw[sel].astype(np.int64)
        hs = store.txh[sel].astype(np.int64)
        keys.append(np.where(tps == WHT_WHT, -1, ws * 2048 + hs))
        offs.append(store.cf_off[sel].astype(np.int32))
        flat0s.append(
            (store.txpl[sel].astype(np.int64) * psz
             + store.txy[sel].astype(np.int64) * aw
             + store.txx[sel] + boff).astype(np.int32)
        )
        f0s.append(TXTP_FIRST[tps])
        f1s.append(TXTP_SECOND[tps])
    if not keys:
        return
    key = np.concatenate(keys)
    offs = np.concatenate(offs)
    flat0 = np.concatenate(flat0s)
    f0 = np.concatenate(f0s)
    f1 = np.concatenate(f1s)
    oob = np.int32(6 * psz)
    for k in np.unique(key):
        m = key == k
        o, fl, a, b = offs[m], flat0[m], f0[m], f1[m]
        n = o.size
        if k == -1:
            d, nc = _chunked([o, fl], n, WHT_B, pads=[0, oob])
            hdr[WHT0] = blob.add_words(d)
            hdr[WHT0 + 1] = nc
        else:
            w, h = int(k) // 2048, int(k) % 2048
            B = chunk_for(w, h)
            d, nc = _chunked([o, fl, a, b], n, B, pads=[0, oob, 0, 0])
            si = SIZE_IDX[(w, h)]
            hdr[R0 + 2 * si] = blob.add_words(d)
            hdr[R0 + 2 * si + 1] = nc


# ------------------------------ palette ----------------------------------


def _pack_palette(blob, hdr, plan, psz, aw):
    if plan.native is not None:  # the native planner's scatter
        idx, val = plan.native.pal_idx, plan.native.pal_val
    elif plan.pal:
        idxs, vals = [], []
        for pl, y, x, pix in plan.pal:
            h, w = pix.shape
            base = pl * psz + y * aw + x
            ii = base + np.arange(h)[:, None] * aw + np.arange(w)[None, :]
            idxs.append(ii.ravel().astype(np.int32))
            vals.append(pix.ravel().astype(np.int32))
        idx = np.concatenate(idxs)
        val = np.concatenate(vals)
    else:
        return
    if not idx.size:
        return
    d, nc = _chunked([idx, val], idx.size, PAL_B, pads=[3 * psz, 0])
    hdr[PAL0] = blob.add_words(d)
    hdr[PAL0 + 1] = nc


# ------------------------------ wavefront --------------------------------


def _pack_class(items, NW, B, psz):
    """Pack one class's wave items into (NW, B, N_FIELDS) int32 rows
    (layout in wave2.FIELDS; the edge plan is the 5-field parametric
    descriptor expanded on device by wave2._build_coords). Lane 0 carries
    the per-wave feature flags and item count that let the device
    cond-skip absent features."""
    from ..syntax.levels import FILTER_PRED, Z1_PRED, Z2_PRED, Z3_PRED
    from .layout import (
        F_CFL, F_FILTER, F_IDENT, F_II, F_Z, FIELDS, N_FIELDS,
    )

    blob = np.zeros((NW, B, N_FIELDS), np.int32)
    fi = {k: i for i, k in enumerate(FIELDS)}
    blob[:, :, fi["flat0"]] = 3 * psz  # padded lanes scatter out of bounds
    blob[:, :, fi["w"]] = 4
    blob[:, :, fi["h"]] = 4
    blob[:, :, fi["iioff"]] = -1
    fill = np.zeros(NW, np.int32)
    wflags = np.zeros(NW, np.int32)
    for it, aw in items:
        wv = it.wave - 1
        k = fill[wv]
        fill[wv] += 1
        row = blob[wv, k]
        row[fi["modes"]] = it.mode
        row[fi["angles"]] = it.angle
        row[fi["flat0"]] = it.pl * psz + it.y * aw + it.x
        row[fi["rmask"]] = it.tx >= 0
        row[fi["z2mw"]] = it.z2_mw
        row[fi["z2mh"]] = it.z2_mh
        row[fi["z2sm"]] = it.z2_sm
        row[fi["w"]] = it.w
        row[fi["h"]] = it.h
        row[fi["iioff"]] = it.iioff
        row[fi["hav"]] = it.hav
        row[fi["phl"]] = it.phl
        row[fi["phbl"]] = it.phbl
        row[fi["pht"]] = it.pht
        row[fi["phtr"]] = it.phtr
        if it.mode in (Z1_PRED, Z2_PRED, Z3_PRED):
            wflags[wv] |= F_Z
        elif it.mode == FILTER_PRED:
            wflags[wv] |= F_FILTER
        elif it.mode == MODE_IDENT:
            wflags[wv] |= F_IDENT
        if it.iioff >= 0:
            wflags[wv] |= F_II
        if it.mode >= MODE_CFL_DC:
            wflags[wv] |= F_CFL
            row[fi["cfla"]] = it.cfl_alpha
            row[fi["cfl0"]] = it.cfl_ly * aw + it.cfl_lx
            row[fi["cflwp"]] = it.cfl_wpad
            row[fi["cflhp"]] = it.cfl_hpad
    blob[:, 0, fi["wflags"]] = wflags
    blob[:, 0, fi["wcount"]] = fill
    return blob


def _pack_wave(blob, hdr, plan, psz, aw):
    if plan.ii_masks:
        hdr[WAVE0 + 3] = blob.add_words(
            np.concatenate(plan.ii_masks).astype(np.int32)
        )
    if plan.native is not None:  # rows written by the native planner
        if plan.native.n_items:
            hdr[WAVE0] = max(plan.n_waves, 1)
            hdr[WAVE0 + 1] = blob.add_words(plan.native.rows[0])
            hdr[WAVE0 + 2] = blob.add_words(plan.native.rows[1])
        return
    if not plan.items:
        return
    sitems = [(it, aw) for it in plan.items if item_class(it.w, it.h) == 0]
    litems = [(it, aw) for it in plan.items if item_class(it.w, it.h) == 1]
    NW = max(plan.n_waves, 1)
    hdr[WAVE0] = NW
    hdr[WAVE0 + 1] = blob.add_words(_pack_class(sitems, NW, CAP[0], psz))
    hdr[WAVE0 + 2] = blob.add_words(_pack_class(litems, NW, CAP[1], psz))


# -------------------------------- inter ----------------------------------


def _pack_slot(blob, hdr, name, cols, rows, B=TB, case_row=None):
    """Pack a slot's tile descriptors into (nc, rows, B) chunks. With
    case_row set, chunks are CASE-PURE (grouped by that column): the
    device body lax.switches once per chunk and computes only that
    filter case's gather + taps."""
    if not cols:
        return
    a = np.asarray(cols, np.int32)
    if case_row is None:
        groups = [a]
    else:
        groups = [a[a[:, case_row] == c]
                  for c in np.unique(a[:, case_row])]
    chunks = []
    total = 0
    for g in groups:
        d, nc = _chunked(list(g.T), g.shape[0], B)
        if case_row is not None:
            d[:, case_row, :] = g[0, case_row]
        chunks.append(d)
        total += nc
    hdr[INTER0 + 2 * SLOTS[name]] = blob.add_words(np.concatenate(chunks))
    hdr[INTER0 + 2 * SLOTS[name] + 1] = total


def _plan_inter_v3(f, plan, blob, hdr, psz, aw):
    """Serialize the collected inter job lists into slot descriptor chunks
    (see engine/inter.py collect_inter for the job collection walk and
    engine/mega.py for the slot set). Returns (srcsY, srcsC) or None when
    a pool capacity would overflow (caller falls back to the host path)."""
    from ..recon.inter import _PrepHandle, _WarpPrepHandle
    from ..tables.spec_data import OBMC_MASKS

    jobs = plan.inter
    POOLROWS = (8 * psz) // 64

    srcsY, srcsC = [], []
    srcrow = {}
    _src_pics = {}
    for refp in f.refp:
        if refp is None:
            continue
        for pl, arr in enumerate((refp.y, refp.u, refp.v)):
            if arr is not None and id(arr) not in _src_pics:
                _src_pics[id(arr)] = (refp, pl)

    def src_of(plane):
        key = id(plane)
        if key not in srcrow:
            pic, pl = _src_pics[key]
            if pl == 0:
                srcrow[key] = (0, len(srcsY))
                srcsY.append((pic, pl))
            else:
                srcrow[key] = (1, len(srcsC))
                srcsC.append((pic, pl))
        return srcrow[key]

    dstmap = {id(f.cur.y): 0}
    if f.cur.u is not None:
        dstmap[id(f.cur.u)] = 1
        dstmap[id(f.cur.v)] = 2

    # --- OBMC lap pool rows ---
    lap_rows = {}
    nlap = 0
    for kind, dst, dy, dx, lap, w, h in jobs.blends:
        if id(lap) not in lap_rows:
            lh, lw = lap.shape
            ntx = (lw + 7) >> 3
            nty = (lh + 7) >> 3
            lap_rows[id(lap)] = (nlap, ntx, nty, lw, lh)
            nlap += ntx * nty
    if nlap > POOLROWS:
        return None

    # --- puts (8-tap + bilin share slots; phases/bilin are data) ---
    put_cols = {("putY"): [], ("putC"): [], ("lapY"): [], ("lapC"): []}

    def add_put(job, bilin):
        dst, dsty, dstx, plane, dy, dx, w, h, fmx, fmy, f2d, vw, vh = job
        kind, row = src_of(plane)
        di = dstmap.get(id(dst))
        if di is None:
            g = put_cols["lapY" if kind == 0 else "lapC"]
        else:
            g = put_cols["putY" if kind == 0 else "putC"]
        # filter case (mega._put_out): 0 hv / 1 h / 2 v / 3 copy / 4 bilin
        if bilin:
            case = 4
        elif fmy:
            case = 0 if fmx else 2
        else:
            case = 1 if fmx else 3
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                if di is not None:
                    flat0 = di * psz + (dsty + ty) * aw + (dstx + tx)
                else:
                    base, ntx, nty, lw, lh = lap_rows[id(dst)]
                    if dsty + ty >= lh or dstx + tx >= lw:
                        continue
                    flat0 = (base + ((dsty + ty) >> 3) * ntx
                             + ((dstx + tx) >> 3)) * 64
                g.append((row, dy + ty, dx + tx, fmx, fmy, f2d, flat0,
                          tw, th, w, h, case))

    for job in jobs.mc:
        add_put(job, False)
    for job in jobs.bilin:
        add_put(job, True)
    for name, cols in put_cols.items():
        _pack_slot(blob, hdr, name, cols, NPUT, case_row=11)

    # --- warp puts ---
    warp_cols = {0: [], 1: []}
    for dst, dsty, dstx, plane, dy, dx, abcd, mx, my, vw, vh in jobs.warp:
        kind, row = src_of(plane)
        di = dstmap[id(dst)]
        flat0 = di * psz + dsty * aw + dstx
        warp_cols[kind].append(
            (row, dy, dx, abcd[0], abcd[1], abcd[2], abcd[3], mx, my,
             flat0, 8, 8)
        )
    _pack_slot(blob, hdr, "warpY", warp_cols[0], NWARP)
    _pack_slot(blob, hdr, "warpC", warp_cols[1], NWARP)

    # --- compound prep pool ---
    pool_rows = {}
    npool = 0
    prep_cols = {0: [], 1: []}
    for idx, (plane, dy, dx, w, h, fmx, fmy, f2d, vw, vh) in enumerate(
            jobs.prep):
        kind, row = src_of(plane)
        ntx = (w + 7) >> 3
        nty = (h + 7) >> 3
        pool_rows[("p", idx)] = (npool, ntx)
        g = prep_cols[kind]
        if fmy:
            case = 0 if fmx else 2
        else:
            case = 1 if fmx else 3
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                flat0 = (npool + (ty >> 3) * ntx + (tx >> 3)) * 64
                g.append((row, dy + ty, dx + tx, fmx, fmy, f2d, flat0,
                          tw, th, w, h, case))
        npool += ntx * nty
    _pack_slot(blob, hdr, "prepY", prep_cols[0], NPUT, case_row=11)
    _pack_slot(blob, hdr, "prepC", prep_cols[1], NPUT, case_row=11)

    wh_base = {}
    for hnd in jobs.warp_handles:
        ntx = (hnd.w + 7) >> 3
        nty = (hnd.h + 7) >> 3
        wh_base[hnd.idx] = (npool, ntx)
        pool_rows[("w", hnd.idx)] = (npool, ntx)
        npool += ntx * nty
    wprep_cols = {0: [], 1: []}
    for hidx, y, x, plane, dy, dx, abcd, mx, my, vw, vh in jobs.warp_prep:
        kind, row = src_of(plane)
        base, ntx = wh_base[hidx]
        flat0 = (base + (y >> 3) * ntx + (x >> 3)) * 64
        wprep_cols[kind].append(
            (row, dy, dx, abcd[0], abcd[1], abcd[2], abcd[3], mx, my,
             flat0, 8, 8)
        )
    _pack_slot(blob, hdr, "wprepY", wprep_cols[0], NWARP)
    _pack_slot(blob, hdr, "wprepC", wprep_cols[1], NWARP)

    # --- host-computed preps (rare: bilinear compound) ---
    host_rows = []
    host_tiles = []

    def host_pool_rows(arr):
        nonlocal npool
        h, w = arr.shape
        ntx = (w + 7) >> 3
        nty = (h + 7) >> 3
        base = npool
        a = np.zeros((nty * 8, ntx * 8), np.int32)
        a[:h, :w] = arr
        for ty in range(nty):
            for tx in range(ntx):
                host_rows.append(base + ty * ntx + tx)
                host_tiles.append(a[ty * 8 : ty * 8 + 8, tx * 8 : tx * 8 + 8])
        npool += ntx * nty
        return (base, ntx)

    def rows_of(s):
        if isinstance(s, _PrepHandle):
            return pool_rows[("p", s.idx)]
        if isinstance(s, _WarpPrepHandle):
            return pool_rows[("w", s.idx)]
        return host_pool_rows(np.asarray(s, np.int32))

    # --- compound combine tiles ---
    hmask_parts = []
    hmask_off = 0
    comb = {"avg": [], "mask": [], "seguv": [],
            "segy00": [], "segy10": [], "segy11": []}
    seg_off = {}
    mask_off = 0
    for rec in jobs.recs:
        kind, pl, dy, dx, w, h, s0, s1, extra = rec
        (b0, ntx0) = rows_of(s0)
        (b1, ntx1) = rows_of(s1)
        flat00 = pl * psz + dy * aw + dx
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                r0 = b0 + (ty >> 3) * ntx0 + (tx >> 3)
                r1 = b1 + (ty >> 3) * ntx1 + (tx >> 3)
                flat0 = flat00 + ty * aw + tx
                if kind in ("avg", "wavg"):
                    wt = 8 if kind == "avg" else extra
                    comb["avg"].append((r0, r1, flat0, wt, 0, 0, tw, th))
                elif kind == "mask":
                    moff = hmask_off + ty * w + tx
                    comb["mask"].append((r0, r1, flat0, moff, w, 0, tw, th))
                elif kind == "seg_y":
                    sign, sh_, sv_, seg_id = extra
                    if seg_id not in seg_off:
                        seg_off[seg_id] = (mask_off, w >> sh_, sh_, sv_)
                        mask_off += (w >> sh_) * (h >> sv_)
                    mo, mw, _, _ = seg_off[seg_id]
                    p0 = mo + (ty >> sv_) * mw + (tx >> sh_)
                    comb[f"segy{sh_}{sv_}"].append(
                        (r0, r1, flat0, p0, mw, sign, tw, th)
                    )
                else:  # seg_uv
                    mo, mw, _, _ = seg_off[extra]
                    p0 = mo + ty * mw + tx
                    comb["seguv"].append((r0, r1, flat0, p0, mw, 0, tw, th))
        if kind == "mask":
            m = np.zeros((h, w), np.int32)
            me = np.asarray(extra)
            if me.ndim == 2:
                m[: me.shape[0], : me.shape[1]] = me[:h, :w]
            else:
                m[:, :] = np.broadcast_to(
                    me.reshape(-1)[: h * w].reshape(h, w), (h, w)
                )
            hmask_parts.append(m.reshape(-1))
            hmask_off += h * w
    if npool > POOLROWS or mask_off > psz:
        return None
    for name in ("avg", "mask", "seguv", "segy00", "segy10", "segy11"):
        _pack_slot(blob, hdr, name, comb[name], NCOMB)

    if host_tiles:
        rows = np.asarray(host_rows, np.int32)
        tiles = np.stack(host_tiles).reshape(len(host_rows), 64)
        nh = rows.size
        nc = (nh + HB - 1) // HB
        d = np.full((nc, 65, HB), 0, np.int32)
        d[:, 0, :] = np.concatenate(
            [rows, np.full(nc * HB - nh, 1 << 30, np.int32)]
        ).reshape(nc, HB)
        tp = np.zeros((nc * HB, 64), np.int32)
        tp[:nh] = tiles
        d[:, 1:, :] = tp.reshape(nc, HB, 64).transpose(0, 2, 1)
        hdr[INTER0 + 2 * SLOTS["hostpool"]] = blob.add_words(d)
        hdr[INTER0 + 2 * SLOTS["hostpool"] + 1] = nc

    # --- OBMC blend tiles (tops packed before lefts: recon.rs obmc order)
    omask_off = {}
    blend_cols = {"h": [], "v": []}
    for kind, dst, dy, dx, lap, w, h in jobs.blends:
        di = dstmap[id(dst)]
        base, ntx, nty, lw, lh = lap_rows[id(lap)]
        n = h if kind == "h" else w
        mk = (kind, n)
        if mk not in omask_off:
            vn = (n * 3) >> 2
            vec = np.zeros(n, np.int32)
            vec[:vn] = np.asarray(OBMC_MASKS[n : n + vn], np.int32)
            omask_off[mk] = hmask_off
            hmask_parts.append(vec)
            hmask_off += n
        mo = omask_off[mk]
        for ty in range(0, h, 8):
            th = min(8, h - ty)
            for tx in range(0, w, 8):
                tw = min(8, w - tx)
                flat0 = di * psz + (dy + ty) * aw + (dx + tx)
                if ty < lh and tx < lw:
                    row = base + (ty >> 3) * ntx + (tx >> 3)
                else:
                    row = base  # mask is zero there; any valid row works
                if kind == "h":
                    moff, mrs, mcs = mo + ty, 1, 0
                else:
                    moff, mrs, mcs = mo + tx, 0, 1
                blend_cols[kind].append((row, flat0, moff, mrs, mcs, tw, th))
    # A chunk's tiles all read pf BEFORE any of the chunk's writes, so
    # overlapping blends must land in different chunks. The only
    # overlaps are a block's own top-lap x left-lap corner (top rows x
    # left cols), so: all top blends, pad to a chunk boundary, then
    # all left blends — left corners then read post-top-blend pixels,
    # exactly the host's per-block h-then-v order.
    hc, nh = _chunked(
        list(np.asarray(blend_cols["h"], np.int32).T),
        len(blend_cols["h"]), TB,
    ) if blend_cols["h"] else (np.zeros((0, NBLEND, TB), np.int32), 0)
    vc, nv = _chunked(
        list(np.asarray(blend_cols["v"], np.int32).T),
        len(blend_cols["v"]), TB,
    ) if blend_cols["v"] else (np.zeros((0, NBLEND, TB), np.int32), 0)
    if nh or nv:
        hdr[INTER0 + 2 * SLOTS["blend"]] = blob.add_words(
            np.concatenate([hc, vc])
        )
        hdr[INTER0 + 2 * SLOTS["blend"] + 1] = nh + nv

    if hmask_parts:
        hdr[IH0] = blob.add_words(np.concatenate(hmask_parts))
    return srcsY, srcsC


# ------------------------------- filters ---------------------------------


def _pack_deblock(f, blob, hdr):
    """Byte-packed final class|level maps (host-resolved: neighbour-level
    fallback + tile fixups; lf_apply.rs:597). Absent deblock points at a
    zeroed region (level 0 = no-op)."""
    from ..headers import PixelLayout
    from ..ops.ref.lf import calc_eih
    from ..recon.lf import _fix_tile_cols

    frame_hdr = f.frame_hdr
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    h4, w4 = f.bh, f.bw
    ch4 = (f.bh + ss_ver) >> ss_ver
    cw4 = (f.bw + ss_hor) >> ss_hor
    e_lut, i_lut = calc_eih(frame_hdr.loopfilter.sharpness)
    hdr[DB0] = blob.add_words(
        np.stack([np.asarray(e_lut, np.int32), np.asarray(i_lut, np.int32)])
    )
    have_y = frame_hdr.loopfilter.level_y != [0, 0]
    have_uv = (
        layout != PixelLayout.I400
        and (frame_hdr.loopfilter.level_u or frame_hdr.loopfilter.level_v)
    )
    if have_y or have_uv:
        _fix_tile_cols(f)

    def resolve(cls_map, comp, nh4, nw4, horizontal):
        cm = np.asarray(cls_map[:nh4, :nw4], np.int64)
        lv = f.lf_level[:nh4, :nw4, comp].astype(np.int64)
        lprev = np.zeros_like(lv)
        if horizontal:
            lprev[1:, :] = lv[:-1, :]
            lv = np.where(lv != 0, lv, lprev)
            lv[0, :] = 0
        else:
            lprev[:, 1:] = lv[:, :-1]
            lv = np.where(lv != 0, lv, lprev)
            lv[:, 0] = 0
        cm = np.where(lv != 0, cm, 0)
        if horizontal:
            cm, lv = cm.T, lv.T  # the kernel transposes the plane
        return blob.add_u8(((cm << 6) | lv).astype(np.uint8))

    sizes = [h4 * w4, ch4 * cw4, ch4 * cw4] * 2
    for i in range(6):
        hor = i >= 3
        chroma = (i % 3) != 0
        have = have_uv if chroma else have_y
        if not have:
            hdr[DB0 + 1 + i] = blob.alloc_zeros((sizes[i] + 3) // 4)
            continue
        if not chroma:
            hdr[DB0 + 1 + i] = resolve(f.lf_cls[1 if hor else 0],
                                       1 if hor else 0, h4, w4, hor)
        else:
            comp = 2 if (i % 3) == 1 else 3
            hdr[DB0 + 1 + i] = resolve(f.lf_cls[3 if hor else 2], comp,
                                       ch4, cw4, hor)


def _pack_cdef(f, blob, hdr):
    """Per-8x8 cdef level maps as bytes (cdef_apply.rs:159 strengths);
    absent cdef = zeroed maps (no-op)."""
    frame_hdr = f.frame_hdr
    cdef = frame_hdr.cdef
    bw, bh = f.bw, f.bh
    nby, nbx = (bh + 1) >> 1, (bw + 1) >> 1
    hdr[CDEF0 + 2] = cdef.damping + (f.cur.bpc - 8)
    active = any(
        cdef.y_strength[i] or cdef.uv_strength[i]
        for i in range(1 << cdef.n_bits)
    )
    if not active:
        hdr[CDEF0] = blob.alloc_zeros((nby * nbx + 3) // 4)
        hdr[CDEF0 + 1] = blob.alloc_zeros((nby * nbx + 3) // 4)
        return
    noskip = f.noskip8[:nby, :nbx] != 0
    cdef_idx = f.cdef_idx[
        (np.arange(nby)[:, None] * 2) >> 4, (np.arange(nbx)[None, :] * 2) >> 4
    ].astype(np.int64)
    ok = (cdef_idx >= 0) & noskip
    y_str = np.asarray(cdef.y_strength, np.int64)
    uv_str = np.asarray(cdef.uv_strength, np.int64)
    y_lvl = np.where(ok, y_str[np.maximum(cdef_idx, 0)], 0)
    uv_lvl = np.where(ok, uv_str[np.maximum(cdef_idx, 0)], 0)
    keep = (y_lvl != 0) | (uv_lvl != 0)
    y_lvl = np.where(keep, y_lvl, 0)
    uv_lvl = np.where(keep, uv_lvl, 0)
    hdr[CDEF0] = blob.add_u8(y_lvl.astype(np.uint8))
    hdr[CDEF0 + 1] = blob.add_u8(uv_lvl.astype(np.uint8))


def _collect_lr(f):
    """Walk the LR unit grid exactly like recon/lr_apply.py apply_lr and
    collect per-stripe descriptors grouped by (kind, plane)
    (lr_apply.rs:261). Returns (groups, (Wy, Wc))."""
    from ..headers import PixelLayout, RestorationType
    from ..recon.lr_apply import RestorationUnit, restore_planes_mask

    frame_hdr = f.frame_hdr
    restore_planes = restore_planes_mask(frame_hdr)
    if not restore_planes:
        return {}, (96, 96)
    seq_hdr = f.seq_hdr
    sb128 = seq_hdr.sb128
    layout = f.cur.layout
    sr = f.sr_cur
    groups = {}
    ws = [96, 96]

    def emit_stripes(plane_idx, x, y, unit_w, row_h, lr, plane_h, w_plane,
                     ss_ver, Wmax):
        stripe_h = min((64 - 8 * (1 if y == 0 else 0)) >> ss_ver, row_h - y)
        have_left = x > 0
        have_top = y > 0
        sby_cur = (y + ((8 << ss_ver) if y else 0)) >> (6 - ss_ver + sb128)
        while y + stripe_h <= row_h:
            have_bottom = sby_cur + 1 != f.sbh or y + stripe_h != row_h
            have_right = x + unit_w < w_plane
            below = y + stripe_h
            below2 = below if below + 1 == plane_h else below + 1
            H = plane_h
            xlo = x - (3 if have_left else 0)
            xhi = x + unit_w - 1 + (3 if have_right else 0)
            if have_top:
                top0 = H + (y - 2)
                top1 = H + (y - 2) + 1
            else:
                top0 = top1 = y
            if have_bottom:
                bot0 = H + below
                bot1 = H + below2
            else:
                bot0 = bot1 = y + stripe_h - 1
            if lr.type == RestorationType.WIENER:
                key = ("w", plane_idx)
                p = (lr.filter_h[0], lr.filter_h[1], lr.filter_h[2],
                     lr.filter_v[0], lr.filter_v[1], lr.filter_v[2])
            else:
                from ..tables.spec_data import SGR_PARAMS

                s0 = int(SGR_PARAMS[lr.sgr_idx][0])
                s1 = int(SGR_PARAMS[lr.sgr_idx][1])
                w0 = lr.sgr_weights[0]
                w1 = 128 - (lr.sgr_weights[0] + lr.sgr_weights[1])
                kind = 2 if (s0 and s1) else (0 if s0 else 1)
                key = (kind, plane_idx)
                p = (s0, s1, w0, w1, 0, 0)
            groups.setdefault(key, []).append(
                (x, y, unit_w, stripe_h, xlo, xhi, top0, top1, bot0, bot1) + p
            )
            y += stripe_h
            have_top = True  # later stripes of a 128px SB row have lpf rows
            stripe_h = min(64 >> ss_ver, row_h - y)
            if stripe_h == 0:
                break

    def walk_plane(plane_idx, w, h, ss_ver, ss_hor):
        unit_size_log2 = frame_hdr.restoration.unit_size[1 if plane_idx else 0]
        unit_size = 1 << unit_size_log2
        half_unit = unit_size >> 1
        max_unit_size = unit_size + half_unit
        ws[1 if plane_idx else 0] = max_unit_size
        shift_hor = 7 - ss_hor
        for sby in range(f.sbh):
            offset = (8 >> ss_ver) if sby else 0
            not_last = 1 if sby + 1 < f.sbh else 0
            next_row_y = (sby + 1) << (6 - ss_ver + sb128)
            row_h = min(next_row_y - (8 >> ss_ver) * not_last, h)
            y_stripe = (sby << (6 - ss_ver + sb128)) - offset
            y = y_stripe
            row_y = y + ((8 >> ss_ver) if y else 0)
            aligned_unit_pos = row_y & ~(unit_size - 1)
            if aligned_unit_pos and aligned_unit_pos + half_unit > h:
                aligned_unit_pos -= unit_size
            aligned_unit_pos <<= ss_ver
            sb_idx = (aligned_unit_pos >> 7) * f.sr_sb128w
            unit_idx = ((aligned_unit_pos >> 6) & 1) << 1

            def get_unit(si, ui):
                u = f.lr_units.get((plane_idx, si, ui))
                return u if u is not None else RestorationUnit()

            lr = [get_unit(sb_idx, unit_idx), None]
            restore = lr[0].type != RestorationType.NONE
            x = 0
            bit = 0
            while x + max_unit_size <= w:
                next_x = x + unit_size
                next_u_idx = unit_idx + ((next_x >> (shift_hor - 1)) & 1)
                lr[1 - bit] = get_unit(sb_idx + (next_x >> shift_hor),
                                       next_u_idx)
                if restore:
                    emit_stripes(plane_idx, x, y, unit_size, row_h, lr[bit],
                                 h, w, ss_ver, max_unit_size)
                x = next_x
                restore = lr[1 - bit].type != RestorationType.NONE
                bit = 1 - bit
            if restore:
                emit_stripes(plane_idx, x, y, w - x, row_h, lr[bit], h, w,
                             ss_ver, max_unit_size)

    if restore_planes & 1:
        walk_plane(0, sr.w, sr.h, 0, 0)
    if layout != PixelLayout.I400 and restore_planes & 6:
        ss_ver = 1 if layout == PixelLayout.I420 else 0
        ss_hor = 1 if layout != PixelLayout.I444 else 0
        cw = (sr.w + ss_hor) >> ss_hor
        ch = (sr.h + ss_ver) >> ss_ver
        if restore_planes & 2:
            walk_plane(1, cw, ch, ss_ver, ss_hor)
        if restore_planes & 4:
            walk_plane(2, cw, ch, ss_ver, ss_hor)
    return groups, (ws[0], ws[1])


_KINDS = ("w", 0, 1, 2)


def _pack_lr(f, blob, hdr):
    groups, lr_ws = _collect_lr(f)
    for (kind, pl), cols in groups.items():
        a = np.asarray(cols, np.int32).T  # (16, n)
        d, nc = _chunked(list(a), a.shape[1], LRB)
        slot = 4 * pl + _KINDS.index(kind)
        hdr[LR0 + 2 * slot] = blob.add_words(d)
        hdr[LR0 + 2 * slot + 1] = nc
    # Quantize the per-frame max unit widths to two buckets: lr_ws is a
    # STATIC of filter_prog, and letting it track frame content minted 5
    # filter compile keys in the 140-frame bench stream alone (round-5
    # measured: each costs 35-78 s of compile). The stripe kernels iterate
    # data-driven unit lists, so a wider static W only pads the per-stripe
    # tile; 384 = the largest possible edge-merged unit
    # (unit_size 256 * 3/2, lr_apply.rs:261 max_unit_size).
    Wy, Wc = lr_ws
    return (96 if Wy <= 96 else 384, 96 if Wc <= 96 else 384)


# ---------------------------------------------------------------------------
# the frame's packing pass (run2.execute)
# ---------------------------------------------------------------------------


class FramePack:
    """A packed frame: the header words, the blob allocator holding every
    region, the static LR stripe widths, the host-side counts, and an
    inter frame's reference sources, and whether the frame needs the
    superres upscale."""

    __slots__ = ("hdr", "blob", "lr_ws", "need_sr", "waves", "tx_valid",
                 "srcs", "inter_runs")

    def __init__(self, hdr, blob, lr_ws, need_sr, waves, tx_valid, srcs,
                 inter_runs):
        self.hdr = hdr
        self.blob = blob
        self.lr_ws = lr_ws
        self.need_sr = need_sr
        # per wave: [(class rows (B, N_FIELDS) int32, n items, wflags,
        # sorted tuple of the modes present)] for the S and L classes
        self.waves = waves
        # {size index, or "wht": filled lanes of its chunks}
        self.tx_valid = tx_valid
        # inter frames: (srcsY, srcsC), the distinct reference planes the
        # tile descriptors' stack rows name, as [(picture, plane index)]
        self.srcs = srcs
        # inter frames: {slot name: [InterRun]} for every slot with chunks
        self.inter_runs = inter_runs

    def write_into(self, buf):
        """Write the used prefix of the blob (header first, zeroed regions
        zero) into the int32 array buf[: blob.pos]: what the device blob
        holds below its capacity padding. buf may hold an earlier frame."""
        buf[: self.hdr.size] = self.hdr
        for off, a in self.blob.parts:
            buf[off : off + a.size] = a
        for off, n in self.blob.zparts:
            buf[off : off + n] = 0
        return buf

    def words(self):
        """The used prefix of the blob as one new int32 array."""
        return self.write_into(np.zeros(self.blob.pos, np.int32))


class InterRun:
    """A run of consecutive chunks of one inter slot that the device
    program executes as one batch: chunks [c0, c0 + nc) of the slot, the
    first n lanes of them filled (the rest is padding of the run's last
    chunk). `case` is the filter case of a put or prep run (0 8-tap h+v,
    1 h, 2 v, 3 copy, 4 bilinear), "top" or "left" for the OBMC blend
    slot's two runs, None elsewhere."""

    __slots__ = ("case", "c0", "nc", "n")

    def __init__(self, case, c0, nc, n):
        self.case, self.c0, self.nc, self.n = case, c0, nc, n


# descriptor rows and the row that is nonzero on a filled lane, per slot
_SLOT_ROWS = {
    "putY": (NPUT, D_TW), "putC": (NPUT, D_TW), "lapY": (NPUT, D_TW),
    "lapC": (NPUT, D_TW), "prepY": (NPUT, D_TW), "prepC": (NPUT, D_TW),
    "warpY": (NWARP, W_TW), "warpC": (NWARP, W_TW),
    "wprepY": (NWARP, W_TW), "wprepC": (NWARP, W_TW),
    "hostpool": (65, None),
    "avg": (NCOMB, C_TW), "segy00": (NCOMB, C_TW), "segy10": (NCOMB, C_TW),
    "segy11": (NCOMB, C_TW), "mask": (NCOMB, C_TW), "seguv": (NCOMB, C_TW),
    "blend": (NBLEND, B_TW),
}
_CASE_SLOTS = ("putY", "putC", "lapY", "lapC", "prepY", "prepC")


def _inter_runs(blob, hdr):
    """Host view of the inter slots _plan_inter_v3 wrote: {slot name:
    [InterRun]}. Put and prep slots split into their case-pure runs, the
    blend slot into its top-lap and left-lap runs."""
    parts = dict(blob.parts)
    out = {}
    for name, (rows, live) in _SLOT_ROWS.items():
        nc = int(hdr[INTER0 + 2 * SLOTS[name] + 1])
        if not nc:
            continue
        B = HB if name == "hostpool" else TB
        d = parts[int(hdr[INTER0 + 2 * SLOTS[name]])].reshape(nc, rows, B)
        if name == "hostpool":
            filled = d[:, 0, :] != (1 << 30)
        else:
            filled = d[:, live, :] > 0
        if name in _CASE_SLOTS:
            cases = d[:, 11, 0].tolist()
        elif name == "blend":
            cases = ["top" if v == 1 else "left" for v in d[:, B_MRS, 0]]
        else:
            cases = [None] * nc
        runs = []
        c0 = 0
        for c in range(1, nc + 1):
            if c < nc and cases[c] == cases[c0]:
                continue
            fl = filled[c0:c].reshape(-1)
            n = int(fl.sum())
            assert fl[:n].all(), "padding lanes must come last in a run"
            runs.append(InterRun(cases[c0], c0, c - c0, n))
            c0 = c
        out[name] = runs
    return out


def _wave_classes(blob, hdr):
    """Host view of the wave descriptors _pack_wave wrote: per wave and
    class, the rows, the item count, the feature flags and the modes."""
    if not hdr[WAVE0]:  # no wave item
        return []
    NW = int(hdr[WAVE0])
    out = []
    for cls, reg in ((0, WAVE0 + 1), (1, WAVE0 + 2)):
        B = CAP[cls]
        arr = dict(blob.parts)[int(hdr[reg])].reshape(NW, B, -1)
        out.append(arr)
    waves = []
    for i in range(NW):
        per = []
        for arr in out:
            rows = arr[i]
            n = int(rows[0, FI["wcount"]])
            modes = tuple(sorted(set(rows[:n, FI["modes"]].tolist())))
            per.append((rows, n, int(rows[0, FI["wflags"]]), modes))
        waves.append(per)
    return waves


def _tx_valid(blob, hdr, psz):
    """Filled lanes of each transform class's chunks (the packer pads only
    the last chunk, with flat0 = 6*psz)."""
    parts = dict(blob.parts)
    oob = 6 * psz
    out = {}
    regions = [(si, R0 + 2 * si, 4, 1, chunk_for(w, h))
               for si, (w, h) in enumerate(SIZES)]
    regions.append(("wht", WHT0, 2, 1, WHT_B))
    for key, reg, rows, row, B in regions:
        nc = int(hdr[reg + 1])
        if not nc:
            continue
        d = parts[int(hdr[reg])].reshape(nc, rows, B)
        flat0 = d[:, row, :].reshape(-1)
        n = int((flat0 != oob).sum())
        assert (flat0[n:] == oob).all(), "padding lanes must come last"
        out[key] = n
    return out


def pack_frame(f, plan):
    """Pack a frame: returns a FramePack, or None when an inter frame would
    overflow a pool of the inter program (the caller runs the host path,
    as run2.execute does)."""
    ah, aw = plan.ah, plan.aw
    psz = ah * aw
    bpc = f.cur.bpc
    store = f.coef_store

    hdr = np.zeros(HDR_LEN, np.int32)
    blob = FrameBlob(HDR_LEN)
    if store.tx_pos:
        cf = store.cf[: store.cf_pos]
        hdr[CF0] = blob.add_i16(cf) if bpc == 8 else blob.add_words(cf)
    _pack_residuals(blob, hdr, store, plan, psz, aw)
    srcs = None
    if plan.inter is not None:
        srcs = _plan_inter_v3(f, plan, blob, hdr, psz, aw)
        if srcs is None:
            return None
    _pack_palette(blob, hdr, plan, psz, aw)
    _pack_wave(blob, hdr, plan, psz, aw)
    _pack_deblock(f, blob, hdr)
    _pack_cdef(f, blob, hdr)
    need_sr = f.frame_hdr.size.width[0] != f.frame_hdr.size.width[1]
    if need_sr:
        for ci in range(2):
            hdr[SR0 + 2 * ci] = f.resize_step[ci]
            hdr[SR0 + 2 * ci + 1] = f.resize_start[ci]
    lr_ws = _pack_lr(f, blob, hdr)
    return FramePack(hdr, blob, lr_ws, need_sr,
                     _wave_classes(blob, hdr),
                     _tx_valid(blob, hdr, psz), srcs,
                     _inter_runs(blob, hdr) if srcs is not None else {})
