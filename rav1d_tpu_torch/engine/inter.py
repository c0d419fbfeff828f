"""Device execution of inter prediction (E2).

Collection reuses the host syntax products: every inter work item runs
through recon_b_inter's apply-phase walk with all pixel work deferred into
job lists (mc/bilin/warp/prep/compound-records/obmc-blends) — the same
lists the numpy path batches — and the engine translates them into device
descriptor groups that gather from device-resident reference planes and
scatter into the frame's device planes. Interintra blocks become wavefront
items (the intra pred + mask blend reads reconstructed neighbours), and
per-tx residuals route to the batch residual buffer (fused whole-plane
add) or the wavefront residual buffer.

Role parity: src/recon.rs recon_b_inter:3162 / mc:2025 / obmc:2205 /
warp_affine:2311 plus the compound combiners of src/mc.rs:1322-1338,
re-expressed as batched gather->filter->scatter device phases.

This is the port's copy of rav1d_tpu/engine/inter.py, changed only at its
seams: it imports no JAX (nor the unused ops/tpu/mc.py), and it has no
IdxBlob or _slice (the earlier engine's) and no dev_plane, whose role the
port's frame runner takes (engine/run.py dev_plane).
"""

from __future__ import annotations

import numpy as np

from ..syntax.levels import (
    INTER_INTRA_BLEND,
    INTER_INTRA_NONE,
    SMOOTH_PRED,
)
from ..tables.block_tables import BLOCK_DIMENSIONS
from ..tables.wedge import II_MASKS, WEDGE_MASKS


class InterJobs:
    __slots__ = ("mc", "bilin", "warp", "warp_prep", "prep", "recs",
                 "blends", "warp_handles")

    def __init__(self):
        self.mc = []
        self.bilin = []
        self.warp = []
        self.warp_prep = []
        self.prep = []
        self.recs = []
        self.blends = []
        self.warp_handles = []


def collect_inter(t, f, plan):
    """Walk the frame's work items, planning intra/interintra blocks into
    the wavefront and translating inter pixel work into job lists. Returns
    None on an uncovered feature (caller falls back to the numpy path)."""
    from ..recon.inter import recon_b_inter
    from .plan import _plan_b_intra

    jobs = InterJobs()
    f.mc_jobs = jobs.mc
    f.bilin_jobs = jobs.bilin
    f.warp_jobs = jobs.warp
    f.warp_prep_jobs = jobs.warp_prep
    f.warp_prep_handles = jobs.warp_handles
    f.prep_jobs = jobs.prep
    f.comp_records = jobs.recs
    f.obmc_blends = jobs.blends
    f.seg_masks_n = 0
    f.seg_masks = {}
    f.engine_collect = True
    store = f.coef_store
    items = f.work_items
    n = len(items)
    ends = [
        items[i].tx_end if items[i].tx_end is not None
        else (items[i + 1].tx_pos if i + 1 < n else store.tx_pos)
        for i in range(n)
    ]
    wave_blocks = np.zeros(n, bool)
    try:
        for i, wi in enumerate(items):
            t.bx, t.by = wi.bx, wi.by
            if wi.kind == "intra":
                if wi.pal is not None:
                    t.pal = wi.pal
                    t.pal_idx = wi.pal_idx
                cur = [wi.tx_pos]
                _plan_b_intra(plan, t, f, wi.ts, wi.bs, wi.intra_edge_flags,
                              wi.b, wi, cur)
                wave_blocks[i] = True
            else:
                if wi.warpmv is not None:
                    t.warpmv = wi.warpmv
                t.tl_4x4_filter = wi.tl_4x4_filter
                recon_b_inter(t, f, wi.ts, wi.bs, wi.b, phase="apply",
                              item=wi, skip_residuals=True)
                if wi.b.interintra_type != INTER_INTRA_NONE:
                    _emit_ii_items(plan, t, f, wi, ends[i])
                    wave_blocks[i] = True
    finally:
        f.engine_collect = False
        f.mc_jobs = f.bilin_jobs = f.warp_jobs = None
        f.warp_prep_jobs = f.prep_jobs = f.warp_prep_handles = None
        f.comp_records = f.obmc_blends = None
    plan.inter = jobs
    starts = np.fromiter((wi.tx_pos for wi in items), np.int64, count=n)
    endsa = np.fromiter(ends, np.int64, count=n)
    wave_tx = np.zeros(store.tx_pos, bool)
    for i in np.nonzero(wave_blocks)[0]:
        wave_tx[starts[i] : endsa[i]] = True
    plan.wavefront_tx = np.nonzero(wave_tx)[0]
    plan.batch_tx = np.nonzero(~wave_tx)[0]
    return True


def _ii_mask_flat(mask, h, w, cw):
    """Flatten an interintra blend mask padded to the item's wave-class
    width `cw`: the wave kernel then reads it at a CONSTANT stride (a
    per-item stride makes the mask read an irregular gather — measured
    170 ms/step on v5e vs sub-ms for the affine form)."""
    arr = np.asarray(mask)
    if arr.size >= h * w:
        m = arr[: h * w].reshape(h, w)
    else:
        m = np.broadcast_to(arr, (h, w))
    out = np.zeros((h, cw), np.int32)
    out[:, :w] = m
    return out.ravel()


def _emit_ii_items(plan, t, f, wi, tx_end):
    """Interintra: the intra prediction + mask blend reads reconstructed
    neighbours, so it executes as wavefront items (the block's inter pred
    is already in the planes from the batch phase); residual txs become
    MODE_IDENT wave items (recon.rs recon_b_inter interintra section)."""
    from ..headers import PixelLayout
    from .plan import MODE_IDENT, _emit, plan_edges

    b = wi.b
    bs = wi.bs
    ts = wi.ts
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    b_dim = BLOCK_DIMENSIONS[bs]
    bw4, bh4 = b_dim[0], b_dim[1]
    bpc = f.cur.bpc
    aw = plan.aw
    psz = plan.ah * plan.aw
    if layout == PixelLayout.I400:
        chr_layout_idx = 0
    else:
        chr_layout_idx = int(PixelLayout.I444) - int(layout)
    has_chroma = (
        layout != PixelLayout.I400
        and (bw4 > ss_hor or t.bx & 1)
        and (bh4 > ss_ver or t.by & 1)
    )
    mode = SMOOTH_PRED if b.interintra_mode == 3 else b.interintra_mode

    def emit_one(pl, x4, y4, w4, h4, cs, ce, rs, re, mask):
        w_px, h_px = 4 * w4, 4 * h4
        have_left = x4 > cs
        have_top = y4 > rs
        m, angle, sm_tl, ep = plan_edges(
            x4, have_left, y4, have_top, ce, re, 0,
            mode, 0, w4, h4, 0,
        )
        it = _emit(plan, f, pl, 4 * x4, 4 * y4, w_px, h_px, m, angle, -1,
                   ep, sm_tl, have_top=have_top, have_left=have_left)
        from .plan import CLS_L, CLS_S, item_class

        cw_cls = (CLS_S if item_class(w_px, h_px) == 0 else CLS_L)[0]
        it.iioff = plan.ii_off
        flat = _ii_mask_flat(mask, h_px, w_px, cw_cls)
        plan.ii_masks.append(flat)
        plan.ii_off += flat.size

    if b.interintra_type == INTER_INTRA_BLEND:
        ymask = II_MASKS[bs][0][b.interintra_mode]
    else:
        ymask = WEDGE_MASKS[bs][0][0][b.wedge_idx]
    emit_one(0, t.bx, t.by, bw4, bh4, ts.col_start, ts.col_end,
             ts.row_start, ts.row_end, ymask)
    if has_chroma:
        cbw4 = (bw4 + ss_hor) >> ss_hor
        cbh4 = (bh4 + ss_ver) >> ss_ver
        if b.interintra_type == INTER_INTRA_BLEND:
            cmask = II_MASKS[bs][chr_layout_idx][b.interintra_mode]
        else:
            cmask = WEDGE_MASKS[bs][chr_layout_idx][0][b.wedge_idx]
        for pl in (1, 2):
            emit_one(pl, t.bx >> ss_hor, t.by >> ss_ver, cbw4, cbh4,
                     ts.col_start >> ss_hor, ts.col_end >> ss_hor,
                     ts.row_start >> ss_ver, ts.row_end >> ss_ver, cmask)

    # residual add as MODE_IDENT wave items (own pixels + residual, after
    # the blend; the last-writer grid orders them behind the ii items)
    store = f.coef_store
    for tx in range(wi.tx_pos, tx_end):
        if store.eob[tx] < 0:
            continue
        w_px = int(store.txw[tx])
        h_px = int(store.txh[tx])
        _emit(plan, f, int(store.txpl[tx]), int(store.txx[tx]),
              int(store.txy[tx]), w_px, h_px, MODE_IDENT, 0, tx, None,
              False)
