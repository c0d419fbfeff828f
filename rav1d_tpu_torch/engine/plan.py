"""Frame plan: host-side planning of the device dense pass.

The planner walks the frame's work items in decode order — the same walk as
the numpy replay (recon/intra.py recon_b_intra, parity src/recon.rs:2402) —
but instead of computing pixels it emits flat descriptors:

- *palette scatters*: pixel blocks fully determined by the entropy pass
  (palette + indices), written to the device planes before the wavefront;
- *wavefront items*: one per intra transform block (or CfL/palette-residual
  unit), carrying the prediction mode, packed angle, residual store index,
  and the block's *edge plan* — a fixed-length vector of flat plane indices
  (or encoded constants) that reproduces rav1d_prepare_intra_edges'
  availability/replication rules as a device gather
  (src/ipred_prepare.rs:118);
- a *wave schedule*: items are assigned topological levels over a 4x4-cell
  "last writer" grid so that every item's edge (and CfL luma) reads land in
  strictly earlier waves. Items in one wave execute as independent batches.

The entropy pass never reads pixels, so everything here is control data; no
pixel ever flows host->device except the initial upload.

On a key or intra-only frame whose block records are still pending (not yet
WorkItems), and where the library loaded, build_plan hands the frame to the
native planner (native/plan.py, csrc/host/plan.c): it writes the wave rows
and the palette scatter that engine/pack.py would write from this module's
items, and builds no per-item object. The Python planner below is its twin
and plans inter frames, and every frame where the library is missing.
"""

from __future__ import annotations

import numpy as np

from ..headers import PixelLayout
from ..syntax import intra_edge as ie
from ..syntax.levels import (
    CFL_PRED,
    DC_128_PRED,
    DC_PRED,
    FILTER_PRED,
    HOR_PRED,
    LEFT_DC_PRED,
    PAETH_PRED,
    SMOOTH_H_PRED,
    SMOOTH_PRED,
    SMOOTH_V_PRED,
    TOP_DC_PRED,
    VERT_LEFT_PRED,
    VERT_PRED,
    WHT_WHT,
    Z1_PRED,
    Z2_PRED,
    Z3_PRED,
)
from ..tables.block_tables import BLOCK_DIMENSIONS, TXFM_DIMENSIONS
from ..recon.ipred_prepare import (
    _MODE_CONV,
    _MODE_TO_ANGLE,
    _NEEDS,
    NEED_BOTTOM_LEFT,
    NEED_LEFT,
    NEED_TOP,
    NEED_TOP_LEFT,
    NEED_TOP_RIGHT,
)

# engine-only mode codes (0..13 are the impl intra modes)
MODE_IDENT = 14  # prediction = current plane content (palette residual add)
MODE_CFL_DC = 15
MODE_CFL_TOP = 16
MODE_CFL_LEFT = 17
MODE_CFL_128 = 18

_CFL_MAP = {
    DC_PRED: MODE_CFL_DC,
    TOP_DC_PRED: MODE_CFL_TOP,
    LEFT_DC_PRED: MODE_CFL_LEFT,
    DC_128_PRED: MODE_CFL_128,
}


class FramePlan:
    __slots__ = (
        "items", "pal", "n_waves", "ah", "aw",
        "wavefront_tx", "batch_tx", "inter", "ii_masks", "ii_off",
        "native",
    )

    def __init__(self):
        self.items = []  # list of _Item
        self.pal = []    # (pl, y, x, pixels ndarray)
        self.n_waves = 0
        self.wavefront_tx = None
        self.batch_tx = None   # txs applied by the fused batch residual add
        self.inter = None      # InterJobs (engine/inter.py) for inter frames
        self.ii_masks = []     # interintra blend masks (flat int32 chunks)
        self.ii_off = 0
        self.native = None     # native/plan.py NativeRows (key frames)


class _Item:
    __slots__ = (
        "pl", "x", "y", "w", "h", "mode", "angle", "tx",
        "hav", "phl", "phbl", "pht", "phtr",
        "z2_mw", "z2_mh", "z2_sm",
        "cfl_alpha", "cfl_ly", "cfl_lx", "cfl_wpad", "cfl_hpad",
        "rd_top_x1", "rd_left_y1", "wave", "iioff",
    )

    def __init__(self, pl, x, y, w, h, mode, angle, tx, edge_params=None):
        self.pl = pl
        self.x = x
        self.y = y
        self.w = w
        self.h = h
        self.mode = mode
        self.angle = angle
        self.tx = tx
        # parametric edge descriptor (wave2._build_coords reconstructs the
        # full prepare_intra_edges index plan on device from these):
        # hav bit0 have_left / bit1 have_top; ph* = available pixel counts
        # for the left / bottom-left / top / top-right strips (0 = absent)
        self.hav, self.phl, self.phbl, self.pht, self.phtr = (
            edge_params if edge_params is not None else (0, 0, 0, 0, 0)
        )
        self.z2_mw = 0
        self.z2_mh = 0
        self.z2_sm = 0
        self.cfl_alpha = 0
        self.cfl_ly = 0
        self.cfl_lx = 0
        self.cfl_wpad = 0
        self.cfl_hpad = 0
        self.rd_top_x1 = -1  # read extents for the wave grid (-1: none)
        self.rd_left_y1 = -1
        self.wave = 0
        self.iioff = -1      # interintra blend mask offset (-1: none)


# wavefront size classes (engine/wave2.py executes one traced-size kernel
# program per class): S covers tx <= 16x16, L the rest up to 64x64
CLS_S = (16, 16)
CLS_L = (64, 64)
# per-wave slot capacity per class; overflowing items are pushed to later
# waves by _assign_waves (always dependency-safe)
CAP = {0: 64, 1: 16}


def item_class(w_px, h_px):
    return 0 if (w_px <= CLS_S[0] and h_px <= CLS_S[1]) else 1


def plan_edges(x, have_left, y, have_top, w, h, edge_flags,
               mode, angle, tw, th, filter_edge):
    """Parametric twin of prepare_intra_edges (recon/ipred_prepare.py):
    refines (mode, angle) and computes the availability descriptor the
    device uses to rebuild the full edge index plan
    (wave2._build_coords). Returns (impl_mode, angle, smooth_tl,
    (hav, phl, phbl, pht, phtr))."""
    if VERT_PRED <= mode <= VERT_LEFT_PRED:
        angle = _MODE_TO_ANGLE[mode - VERT_PRED] + 3 * angle
        if angle <= 90:
            mode = Z1_PRED if angle < 90 and have_top else VERT_PRED
        elif angle < 180:
            mode = Z2_PRED
        else:
            mode = Z3_PRED if angle > 180 and have_left else HOR_PRED
    elif mode in (DC_PRED, PAETH_PRED):
        mode = _MODE_CONV[mode][1 if have_left else 0][1 if have_top else 0]

    szl = 4 * th
    phl = min(szl, (h - y) << 2) if have_left else 0
    have_bl = (
        have_left and y + th < h
        and bool(edge_flags & ie.I444_LEFT_HAS_BOTTOM)
    )
    phbl = min(szl, (h - y - th) << 2) if have_bl else 0
    szt = 4 * tw
    pht = min(szt, (w - x) << 2) if have_top else 0
    have_tr = (
        have_top and x + tw < w
        and bool(edge_flags & ie.I444_TOP_HAS_RIGHT)
    )
    phtr = min(szt, (w - x - tw) << 2) if have_tr else 0

    smooth_tl = bool(
        _NEEDS[mode] & NEED_TOP_LEFT
        and mode == Z2_PRED and tw + th >= 6 and filter_edge
    )
    hav = (1 if have_left else 0) | (2 if have_top else 0)
    return mode, angle, smooth_tl, (hav, phl, phbl, pht, phtr)


def build_plan(t, f):
    """Build the device plan for a frame, or None if the frame uses a
    feature the engine does not cover yet (host fallback)."""
    frame_hdr = f.frame_hdr

    def _fb(reason):  # the frame decodes on the host path, for `reason`
        return None

    # engine coverage gates (remaining: intra block copy, scaled refs).
    # allow_intrabc is only the frame-header PERMISSION (it also disables
    # in-loop filters, which the syntax pass already records as zero
    # levels); frames that permit but never USE intra block copy decode on
    # the engine — blocks that do use it surface as non-intra work items
    # in a key/intra frame and gate below (round-5: the 4K bench vector
    # is exactly the permit-but-unused case).

    plan = FramePlan()
    store = f.coef_store
    plan.ah, plan.aw = f.cur.y.shape

    if frame_hdr.frame_type.is_key_or_intra:
        from ..native import plan as NP

        if f._wi_pending and NP.lib() is not None:
            # records not yet WorkItems: planned, and the waves packed, in C
            if not _plan_native(plan, f):
                return _fb("non-intra item in key/intra frame")
            return plan
        for wi in f.work_items:
            if wi.kind != "intra":
                return _fb("non-intra item in key/intra frame")
            t.bx, t.by = wi.bx, wi.by
            cur = [wi.tx_pos]  # store cursor (mirror of store.pop)
            if wi.pal is not None:
                t.pal = wi.pal
                t.pal_idx = wi.pal_idx
            _plan_b_intra(plan, t, f, wi.ts, wi.bs, wi.intra_edge_flags,
                          wi.b, wi, cur)
        plan.wavefront_tx = np.arange(store.tx_pos)
    else:
        if any(f.svc[i][0]["scale"] for i in range(7)):
            return _fb("scaled references (svc)")
        from .inter import collect_inter

        if not collect_inter(t, f, plan):
            return _fb("collect_inter: uncovered inter feature")

    _assign_waves(plan, f)
    return plan


def _plan_native(plan, f):
    """Fill `plan` for a key or intra-only frame from its pending block
    records in C: the Python plan's wave count, and its wave rows and
    palette scatter as engine/pack.py would write them. False when a record
    is not an intra block."""
    from ..native import plan as NP
    from .layout import N_FIELDS

    st, n_waves, rows = NP.plan_frame(f, plan.ah, plan.aw, CAP, N_FIELDS)
    if st != NP.PLAN_OK:
        return False
    plan.native = rows
    plan.n_waves = n_waves
    plan.wavefront_tx = np.arange(f.coef_store.tx_pos)
    return True


def _pop(store, cur):
    idx = cur[0]
    cur[0] += 1
    return idx, int(store.eob[idx])


def _assign_waves(plan, f):
    """Topological wave levels over a per-plane 4x4-cell last-writer grid.
    An item's reads (top strip incl. top-right, left strip incl.
    bottom-left, CfL luma rect) must come from strictly earlier waves;
    decode order makes every read a prior write, so a single forward pass
    suffices (cf. rav1d's sbrow task ordering, src/thread_task.rs:473).

    Waves have per-class slot capacity (CAP): an item landing in a full
    wave is pushed later, which is always dependency-safe (dependents read
    the pushed wave from the grid). Capacity is what lets the wave-scan
    executor use small static batch shapes."""
    ah, aw = plan.ah, plan.aw
    gh, gw = ah >> 2, aw >> 2
    grid = np.zeros((3, gh, gw), dtype=np.int32)
    counts = [[], []]  # per-class per-wave item counts (1-based waves)
    maxw = 0
    for it in plan.items:
        cy, cx = it.y >> 2, it.x >> 2
        ch = (it.h + 3) >> 2
        cw = (it.w + 3) >> 2
        w = 0
        if it.rd_top_x1 >= 0 and cy > 0:
            x0 = max(cx - 1, 0)
            x1 = min(it.rd_top_x1, gw)
            w = max(w, int(grid[it.pl, cy - 1, x0:x1].max(initial=0)))
        if it.rd_left_y1 >= 0 and cx > 0:
            y0 = max(cy - 1, 0)
            y1 = min(it.rd_left_y1, gh)
            w = max(w, int(grid[it.pl, y0:y1, cx - 1].max(initial=0)))
        if it.mode >= MODE_CFL_DC:
            ly, lx = it.cfl_ly >> 2, it.cfl_lx >> 2
            lh = (it.h << (1 if f.cur.layout == PixelLayout.I420 else 0)) >> 2
            lw = (it.w << (1 if f.cur.layout != PixelLayout.I444 else 0)) >> 2
            w = max(w, int(grid[0, ly : ly + max(lh, 1),
                                lx : lx + max(lw, 1)].max(initial=0)))
        if it.mode == MODE_IDENT or it.iioff >= 0:
            # own-pixel readers (palette/interintra residual adds, ii
            # blends) must run after any earlier wave item that wrote
            # their own rect (e.g. the ii blend before its residual)
            w = max(w, int(grid[it.pl, cy : cy + ch, cx : cx + cw]
                           .max(initial=0)))
        cls = item_class(it.w, it.h)
        cnt = counts[cls]
        cap = CAP[cls]
        w += 1
        while True:
            while len(cnt) <= w:
                cnt.append(0)
            if cnt[w] < cap:
                break
            w += 1
        cnt[w] += 1
        it.wave = w
        grid[it.pl, cy : cy + ch, cx : cx + cw] = it.wave
        if it.wave > maxw:
            maxw = it.wave
    plan.n_waves = maxw


def _emit(plan, f, pl, px, py, w_px, h_px, mode, angle, tx_idx, edge_params,
          smooth_tl, mw=0, mh=0, have_top=False, have_left=False):
    it = _Item(pl, px, py, w_px, h_px, mode, angle, tx_idx, edge_params)
    it.z2_sm = int(smooth_tl)
    it.z2_mw = mw
    it.z2_mh = mh
    if have_top:
        # top strip incl. top-right reach (2*w) and the top-left corner
        it.rd_top_x1 = ((px + 2 * w_px) >> 2) + 1
    if have_left:
        it.rd_left_y1 = ((py + 2 * h_px) >> 2) + 1
    plan.items.append(it)
    return it


def _plan_b_intra(plan, t, f, ts, bs, intra_edge_flags, b, item, cur):
    """Descriptor-emitting twin of recon_b_intra's apply phase."""
    from ..ops.ref import ipred as P

    store = f.coef_store
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    by4 = t.by & 31
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4, bh4 = b_dim[0], b_dim[1]
    w4 = min(bw4, f.bw - t.bx)
    h4 = min(bh4, f.bh - t.by)
    cw4 = (w4 + ss_hor) >> ss_hor
    ch4 = (h4 + ss_ver) >> ss_ver
    has_chroma = (
        layout != PixelLayout.I400
        and (bw4 > ss_hor or t.bx & 1)
        and (bh4 > ss_ver or t.by & 1)
    )
    t_dim = TXFM_DIMENSIONS[b.tx]
    uv_t_dim = TXFM_DIMENSIONS[b.uvtx]
    cbw4 = (bw4 + ss_hor) >> ss_hor
    cbh4 = (bh4 + ss_ver) >> ss_ver
    intra_edge_filter = f.seq_hdr.intra_edge_filter
    ief_flag = intra_edge_filter << 10
    bpc = f.cur.bpc
    ah, aw = plan.ah, plan.aw
    psz = ah * aw
    layout_int = int(layout)

    if b.pal_sz[0]:
        dst = np.zeros((bh4 * 4, bw4 * 4), dtype=np.int32)
        P.pal_pred(dst, t.pal[0], t.pal_idx, bw4 * 4, bh4 * 4)
        plan.pal.append((0, 4 * t.by, 4 * t.bx, dst))

    intra_flags = item.sm_fl | ief_flag

    init_y = 0
    while init_y < h4:
        sub_h4 = min(h4, 16 + init_y)
        sub_ch4 = min(ch4, (init_y + 16) >> ss_ver)
        init_x = 0
        while init_x < w4:
            if init_x + 16 < w4:
                sb_has_tr = True
            elif init_y:
                sb_has_tr = False
            else:
                sb_has_tr = bool(intra_edge_flags & ie.I444_TOP_HAS_RIGHT)
            if init_x:
                sb_has_bl = False
            elif init_y + 16 < h4:
                sb_has_bl = True
            else:
                sb_has_bl = bool(intra_edge_flags & ie.I444_LEFT_HAS_BOTTOM)

            sub_w4 = min(w4, init_x + 16)
            y = init_y
            t.by += init_y
            while y < sub_h4:
                x = init_x
                t.bx += init_x
                while x < sub_w4:
                    tx_idx = -1
                    if not b.skip:
                        idx, eob = _pop(store, cur)
                        if eob >= 0:
                            tx_idx = idx
                    if b.pal_sz[0]:
                        if tx_idx >= 0:
                            _emit(plan, f, 0, 4 * t.bx, 4 * t.by,
                                  t_dim.w * 4, t_dim.h * 4, MODE_IDENT, 0,
                                  tx_idx, None, False)
                    else:
                        ef = (
                            ie.I444_TOP_HAS_RIGHT
                            if not (
                                (y > init_y or not sb_has_tr)
                                and x + t_dim.w >= sub_w4
                            )
                            else 0
                        ) | (
                            ie.I444_LEFT_HAS_BOTTOM
                            if not (
                                x > init_x
                                or (not sb_has_bl and y + t_dim.h >= sub_h4)
                            )
                            else 0
                        )
                        have_left = t.bx > ts.col_start
                        have_top = t.by > ts.row_start
                        m, angle, sm_tl, ep = plan_edges(
                            t.bx, have_left, t.by,
                            have_top, ts.col_end, ts.row_end, ef,
                            b.y_mode, b.y_angle, t_dim.w, t_dim.h,
                            intra_edge_filter,
                        )
                        _emit(plan, f, 0, 4 * t.bx, 4 * t.by, t_dim.w * 4,
                              t_dim.h * 4, m, angle | intra_flags, tx_idx,
                              ep, sm_tl,
                              mw=4 * f.bw - 4 * t.bx, mh=4 * f.bh - 4 * t.by,
                              have_top=have_top, have_left=have_left)
                    x += t_dim.w
                    t.bx += t_dim.w
                t.bx -= x
                y += t_dim.h
                t.by += t_dim.h
            t.by -= y

            if has_chroma:
                _plan_chroma(
                    plan, t, f, ts, b, bs, init_x, init_y, sub_ch4, cw4, ch4,
                    cbw4, cbh4, ss_hor, ss_ver, uv_t_dim, t_dim,
                    intra_edge_flags, sb_has_tr, sb_has_bl, layout_int,
                    item, cur,
                )
            init_x += 16
        init_y += 16


def _plan_chroma(plan, t, f, ts, b, bs, init_x, init_y, sub_ch4, cw4, ch4,
                 cbw4, cbh4, ss_hor, ss_ver, uv_t_dim, t_dim,
                 intra_edge_flags, sb_has_tr, sb_has_bl, layout_int,
                 item, cur):
    from ..ops.ref import ipred as P

    store = f.coef_store
    bpc = f.cur.bpc
    intra_edge_filter = f.seq_hdr.intra_edge_filter
    ief_flag = intra_edge_filter << 10
    ah, aw = plan.ah, plan.aw
    psz = ah * aw

    cfl = b.uv_mode == CFL_PRED
    cfl_pads = None
    if cfl and init_x == 0 and init_y == 0:
        furthest_r = ((cw4 << ss_hor) + t_dim.w - 1) & ~(t_dim.w - 1)
        furthest_b = ((ch4 << ss_ver) + t_dim.h - 1) & ~(t_dim.h - 1)
        cfl_pads = (cbw4 - (furthest_r >> ss_hor),
                    cbh4 - (furthest_b >> ss_ver))

    if b.pal_sz[1] and init_x == 0 and init_y == 0:
        xpos = t.bx >> ss_hor
        ypos = t.by >> ss_ver
        pal_idx = t.pal_idx[
            BLOCK_DIMENSIONS[bs][0] * BLOCK_DIMENSIONS[bs][1] * 16 :
        ]
        for pl in range(2):
            dst = np.zeros((cbh4 * 4, cbw4 * 4), dtype=np.int32)
            P.pal_pred(dst, t.pal[1 + pl], pal_idx, cbw4 * 4, cbh4 * 4)
            plan.pal.append((1 + pl, 4 * ypos, 4 * xpos, dst))

    sm_uv_fl = item.sm_uv_fl
    if (init_x + 16) >> ss_hor < cw4:
        uv_sb_has_tr = True
    elif init_y:
        uv_sb_has_tr = False
    else:
        uv_sb_has_tr = bool(
            intra_edge_flags & (ie.I420_TOP_HAS_RIGHT >> (layout_int - 1))
        )
    if init_x:
        uv_sb_has_bl = False
    elif (init_y + 16) >> ss_ver < ch4:
        uv_sb_has_bl = True
    else:
        uv_sb_has_bl = bool(
            intra_edge_flags & (ie.I420_LEFT_HAS_BOTTOM >> (layout_int - 1))
        )

    sub_cw4 = min(cw4, (init_x + 16) >> ss_hor)
    for pl in range(2):
        y = init_y >> ss_ver
        t.by += init_y
        while y < sub_ch4:
            x = init_x >> ss_hor
            t.bx += init_x
            while x < sub_cw4:
                tx_idx = -1
                if not b.skip:
                    idx, eob = _pop(store, cur)
                    if eob >= 0:
                        tx_idx = idx
                xpos = t.bx >> ss_hor
                ypos = t.by >> ss_ver
                if cfl and b.cfl_alpha[pl] != 0:
                    # CfL: DC-family edges + luma ac (computed on device)
                    xstart = ts.col_start >> ss_hor
                    ystart = ts.row_start >> ss_ver
                    have_left = xpos > xstart
                    have_top = ypos > ystart
                    m, _, _, ep = plan_edges(
                        xpos, have_left, ypos,
                        have_top, ts.col_end >> ss_hor, ts.row_end >> ss_ver,
                        0, DC_PRED, 0, uv_t_dim.w, uv_t_dim.h, 0,
                    )
                    it = _emit(
                        plan, f, 1 + pl, 4 * xpos, 4 * ypos, uv_t_dim.w * 4,
                        uv_t_dim.h * 4, _CFL_MAP[m], 0, tx_idx, ep,
                        False, have_top=have_top, have_left=have_left,
                    )
                    it.cfl_alpha = b.cfl_alpha[pl]
                    it.cfl_ly = 4 * (t.by & ~ss_ver)
                    it.cfl_lx = 4 * (t.bx & ~ss_hor)
                    it.cfl_wpad, it.cfl_hpad = cfl_pads
                elif b.pal_sz[1]:
                    if tx_idx >= 0:
                        _emit(plan, f, 1 + pl, 4 * xpos, 4 * ypos,
                              uv_t_dim.w * 4, uv_t_dim.h * 4, MODE_IDENT,
                              0, tx_idx, None, False)
                else:
                    angle = b.uv_angle
                    ef = (
                        0
                        if (
                            (y > (init_y >> ss_ver) or not uv_sb_has_tr)
                            and x + uv_t_dim.w >= sub_cw4
                        )
                        else ie.I444_TOP_HAS_RIGHT
                    ) | (
                        0
                        if (
                            x > (init_x >> ss_hor)
                            or (not uv_sb_has_bl and y + uv_t_dim.h >= sub_ch4)
                        )
                        else ie.I444_LEFT_HAS_BOTTOM
                    )
                    uv_mode = DC_PRED if cfl else b.uv_mode
                    xstart = ts.col_start >> ss_hor
                    ystart = ts.row_start >> ss_ver
                    have_left = xpos > xstart
                    have_top = ypos > ystart
                    m, angle, sm_tl, ep = plan_edges(
                        xpos, have_left, ypos,
                        have_top, ts.col_end >> ss_hor, ts.row_end >> ss_ver,
                        ef, uv_mode, angle, uv_t_dim.w,
                        uv_t_dim.h, intra_edge_filter,
                    )
                    angle |= ief_flag
                    _emit(plan, f, 1 + pl, 4 * xpos, 4 * ypos,
                          uv_t_dim.w * 4, uv_t_dim.h * 4, m,
                          angle | sm_uv_fl, tx_idx, ep, sm_tl,
                          mw=(4 * f.bw + ss_hor - 4 * (t.bx & ~ss_hor)) >> ss_hor,
                          mh=(4 * f.bh + ss_ver - 4 * (t.by & ~ss_ver)) >> ss_ver,
                          have_top=have_top, have_left=have_left)
                x += uv_t_dim.w
                t.bx += uv_t_dim.w << ss_hor
            t.bx -= x << ss_hor
            y += uv_t_dim.h
            t.by += uv_t_dim.h << ss_ver
        t.by -= y << ss_ver
