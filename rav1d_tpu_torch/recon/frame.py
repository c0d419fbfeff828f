"""Whole-frame decode driver (parity: src/decode.rs rav1d_decode_frame_init
:4069, _init_cdf :4400, _main :4497 — synchronous single-context path)."""

from __future__ import annotations

import os

import numpy as np

from ..headers import PixelLayout
from ..syntax.decode import (
    DecodeError,
    TaskContext,
    TileState,
    init_quant_tables,
    decode_tile_sbrow,
    reset_context,
)


def decode_frame(ctx, f):
    """Synchronous decode: syntax pass then dense pass (n_fc==1)."""
    decode_frame_syntax(ctx, f)
    decode_frame_dense(f)


def decode_frame_syntax(ctx, f):
    """Entropy/syntax half: the per-sbrow msac walk that fills the coef
    store + work items, plus the CDF refresh. Produces everything a LATER
    frame's syntax pass needs (CDF, refmvs, segmap) — no pixels — so the
    decoder can pipeline it ahead of the dense pass (rav1d's two-pass
    frame threading, src/decode.rs:3895 pass=1, src/internal.rs:159)."""
    seq_hdr = f.seq_hdr
    frame_hdr = f.frame_hdr

    # work-item buffers: the syntax pass stores coefficients + block records
    # here; the dense pass replays them (rav1d frame-thread analog)
    from .store import CoefStore

    f.coef_store = CoefStore(f.bw, f.bh)
    f.work_items = []
    # native-core record ranges pending conversion to WorkItem objects:
    # the conversion is the dense pass's input format, not syntax work
    # (rav1d pass-1 just writes records, src/decode.rs:3853), and costs
    # ~0.6 s/frame at 4K — so it is deferred to decode_frame_dense
    # (materialize_work_items), off the syntax plane's critical path
    f._wi_pending = []

    # frame-wide quant tables
    f.dq = [[[0, 0] for _ in range(3)] for _ in range(8)]
    init_quant_tables(seq_hdr, frame_hdr, frame_hdr.quant.yac, f.dq)
    f.qm = [[None] * 3 for _ in range(19)]
    if frame_hdr.quant.qm:
        from ..tables.qm import QM_TBL

        for i in range(19):
            f.qm[i][0] = QM_TBL[frame_hdr.quant.qm_y][0][i]
            f.qm[i][1] = QM_TBL[frame_hdr.quant.qm_u][1][i]
            f.qm[i][2] = QM_TBL[frame_hdr.quant.qm_v][1][i]

    # frame-wide loopfilter levels (per seg): [8][4]
    from .lf_mask import calc_lf_values

    f.lf_lvl = calc_lf_values(frame_hdr, [0, 0, 0, 0])

    # cdef index storage: one per 64x64 unit
    n64w = (f.bw + 15) >> 4
    n64h = (f.bh + 15) >> 4
    f.cdef_idx = np.full((n64h + 1, n64w + 1), -1, dtype=np.int32)
    f.noskip4 = np.zeros((f.bh + 32, f.bw + 32), dtype=np.uint8)
    f.lr_units = {}
    f.sr_sb128w = (f.sr_cur.w + 127) >> 7  # post-superres sb128 cols

    # intra-prediction top edges per superblock row (pre-filter pixel rows)
    layout = f.cur.layout
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    f.ipred_edge = [
        np.zeros((f.sbh, f.sb128w * 128), dtype=np.int32) for _ in range(3)
    ]

    from .lf import init_lf_maps

    init_lf_maps(f)
    # tile-column right-edge tx_lpf backups (decode.rs:4540, f.lf.tx_lpf_right_edge)
    ss_ver_lf = 1 if layout == PixelLayout.I420 else 0
    align_h = (f.bh + 31) & ~31
    f.tx_lpf_right_edge = [
        np.full((frame_hdr.tiling.cols, align_h), 2, dtype=np.int8),
        np.full((frame_hdr.tiling.cols, align_h >> ss_ver_lf), 1, dtype=np.int8),
    ]
    f.all_lossless_cdef = frame_hdr.all_lossless

    # ref mvs (decode.rs:4327 init refmvs frame state)
    from ..syntax import refmvs as _refmvs

    if frame_hdr.frame_type.is_inter_or_switch or frame_hdr.allow_intrabc:
        f.rf = _refmvs.RefMvsFrame()
        f.rf.init_frame(
            seq_hdr, frame_hdr, f.refpoc, f.mvs, f.refrefpoc, f.ref_mvs
        )
    else:
        f.rf = None

    # per-frame flat segmap view for context derivation
    if f.cur_segmap is None and frame_hdr.segmentation.enabled:
        f.cur_segmap = np.zeros((f.sb128h * 32, f.b4_stride), dtype=np.uint8)

    keyframe = frame_hdr.frame_type.is_key_or_intra

    cols = frame_hdr.tiling.cols
    rows = frame_hdr.tiling.rows

    # slice tile data out of the tile groups (src/decode.rs:4400 init_cdf)
    tile_data = _split_tiles(f, frame_hdr)

    # native syntax pass (C decode_sb/decode_b, native/syntax.c)
    from ..native import syntax as _nsy

    native = _nsy.enabled()

    # tile states
    tile_states = []
    for tr in range(rows):
        for tc in range(cols):
            ts = TileState(f, tr, tc, tile_data[tr * cols + tc])
            if native:
                ts.a = _nsy.NpBlockContext(f.bw + 64)
            reset_context(ts.a, keyframe, 0)
            tile_states.append(ts)

    t = TaskContext(f)
    f.tile_states = tile_states  # lf tile-boundary fixups read final ctx state

    if native:
        f._sy_frame, f._sy_out = _nsy.build_frame(f)
        for i, ts in enumerate(tile_states):
            ts._sy = _nsy.build_tile(f._sy_frame, ts)
            ts._sy.tile_idx = i
        f._sy_task = _nsy.build_task(t)

    update_idx = frame_hdr.tiling.update
    out_cdf = None

    is_inter_or_switch = frame_hdr.frame_type.is_inter_or_switch
    sbrow_marks = []  # (tile_row, sby, work-item end index) per syntax sbrow
    n_threads = ctx.settings.n_threads or (os.cpu_count() or 1)
    if native and n_threads > 1 and rows * cols > 1:
        _syntax_tiles_parallel(ctx, f, tile_states, rows, cols,
                               sbrow_marks, n_threads)
    else:
        for tile_row in range(rows):
            sbh_start = frame_hdr.tiling.row_start_sb[tile_row]
            sbh_end = min(frame_hdr.tiling.row_start_sb[tile_row + 1], f.sbh)
            for sby in range(sbh_start, sbh_end):
                by = sby << f.sb_shift
                by_end = (by + f.sb_step) >> 1
                if frame_hdr.use_ref_frame_mvs:
                    _refmvs.load_tmvs(
                        f.rf, frame_hdr, 0, f.bw >> 1, by >> 1, by_end
                    )
                for col in range(cols):
                    ts = tile_states[tile_row * cols + col]
                    if ts.msac.cnt < -15:
                        raise DecodeError("msac overread")
                    if native:
                        _decode_tile_sbrow_native(t, f, ts, sby, tile_states)
                    else:
                        t.pal_sz_uv[1] = [0] * 32
                        decode_tile_sbrow_wrap(t, f, ts, sby)
                if is_inter_or_switch:
                    _refmvs.save_tmvs(f.rf, 0, f.bw >> 1, by >> 1, by_end)
                sbrow_marks.append((tile_row, sby, _wi_len(f)))

    f.noskip8 = (
        f.noskip4[0 : f.bh + 32 : 2, 0 : f.bw + 32 : 2]
        | f.noskip4[1 : f.bh + 32 : 2, 1 : f.bw + 32 : 2]
        | f.noskip4[0 : f.bh + 32 : 2, 1 : f.bw + 32 : 2]
        | f.noskip4[1 : f.bh + 32 : 2, 0 : f.bw + 32 : 2]
    )

    # CDF refresh is a syntax product (src/decode.rs:4497 update_tile_ctx):
    # available to the NEXT frame before this frame's pixels exist
    if frame_hdr.refresh_context:
        f.out_cdf = tile_states[update_idx].cdf.updated(frame_hdr, f.in_cdf)

    f._dense_args = (t, tile_states, sbrow_marks, cols)


def _wi_len(f):
    """Logical work-item count: materialized items plus pending native
    record ranges (1 record = 1 item)."""
    return len(f.work_items) + sum(
        hi - lo for _idx, lo, hi, _e in f._wi_pending
    )


def materialize_work_items(f):
    """Convert pending native record ranges into WorkItem objects, in
    decode order (the dense pass's input; deferred off the syntax plane)."""
    pending = f._wi_pending
    if not pending:
        return
    f._wi_pending = []
    from ..native import syntax as _nsy

    tile_states = f._dense_args[1]
    for idx, lo, hi, tx_ends in pending:
        f._sy_cur_tile = idx
        f.work_items.extend(
            _nsy.records_to_work_items(f, tile_states, lo, hi,
                                       tx_ends=tx_ends)
        )


def decode_frame_dense(f, up=None):
    """Dense/pixel half: the torch device engine when the decoder passes
    its engine context `up` (an engine/blob.py Uploader: batched device
    phases + wave-scheduled intra + device post-filter chain; engine/),
    else the numpy replay (sbrow by sbrow so next-row intra prediction
    sees its top edge backup) followed by the host filter chain. Reads
    only reference PIXELS from other frames, so it runs behind the syntax
    plane on the frame pipeline (rav1d pass=2, src/thread_task.rs:714)."""
    from .. import engine as _engine

    frame_hdr = f.frame_hdr
    # deferred dense-pass input conversion; on the engine, a key or
    # intra-only frame is planned from its records (engine/plan.py
    # _plan_native) and needs no WorkItem unless the engine declines it
    from ..native import plan as _nplan

    if up is None or not (frame_hdr.frame_type.is_key_or_intra
                          and _nplan.lib() is not None):
        materialize_work_items(f)
    t, tile_states, sbrow_marks, cols = f._dense_args

    if up is not None and _engine.run_dense(t, f, up):
        f._dense_args = None
        f.work_items = []
        f._wi_pending = []
    else:
        if f._wi_pending:  # a key frame the engine declined
            materialize_work_items(f)
        f._dense_args = None
        # the numpy replay reads reference pixels on the host: fetch any
        # engine-decoded (device-resident) refs first
        for refp in f.refp:
            if refp is not None:
                refp.materialize()
        run_dense_pass(t, f, tile_states, sbrow_marks, cols)

        from .lf import apply_loopfilter
        from .cdef_apply import apply_cdef
        from .lr_apply import apply_lr, restore_planes_mask

        apply_loopfilter(f)
        pre_cdef = None
        if restore_planes_mask(frame_hdr):
            pre_cdef = [
                f.cur.y.copy(),
                f.cur.u.copy() if f.cur.u is not None else None,
                f.cur.v.copy() if f.cur.v is not None else None,
            ]
        apply_cdef(f)
        if frame_hdr.size.width[0] != frame_hdr.size.width[1]:
            _superres(f)
            if pre_cdef is not None:
                pre_cdef = _resize_planes(f, pre_cdef)
        if pre_cdef is not None:
            apply_lr(f, pre_cdef)


def _superres(f):
    """Horizontal super-resolution upscale (recon.rs rav1d_filter_sbrow_resize
    :4215, whole-frame formulation): f.cur planes -> f.sr_cur planes."""
    from ..ops.ref.mc import resize

    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    bpc = f.cur.bpc
    planes = [(f.cur.y, f.sr_cur.y, 0)]
    if layout != PixelLayout.I400:
        planes += [(f.cur.u, f.sr_cur.u, 1), (f.cur.v, f.sr_cur.v, 1)]
    for src, dst, chroma in planes:
        sv = ss_ver if chroma else 0
        sh = ss_hor if chroma else 0
        dst_w = (f.sr_cur.w + sh) >> sh
        src_w = (4 * f.bw + sh) >> sh
        h = (f.cur.h + sv) >> sv
        resize(
            dst, 0, 0, src, 0, 0, dst_w, h, src_w,
            f.resize_step[1 if chroma else 0], f.resize_start[1 if chroma else 0],
            bpc,
        )


def _resize_planes(f, planes):
    """Resize the pre-CDEF backup planes to super-res width (the reference
    resizes its saved lpf line buffers the same way, lf_apply_tmpl.c:76)."""
    from ..ops.ref.mc import resize

    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    bpc = f.cur.bpc
    out = []
    for pl, src in enumerate(planes):
        if src is None:
            out.append(None)
            continue
        sh = ss_hor if pl else 0
        sv = ss_ver if pl else 0
        dst = np.zeros(
            ((f.sr_cur.y.shape[0] >> sv), f.sr_cur.y.shape[1] >> sh),
            dtype=src.dtype,
        )
        dst_w = (f.sr_cur.w + sh) >> sh
        src_w = (4 * f.bw + sh) >> sh
        h = (f.cur.h + sv) >> sv
        resize(
            dst, 0, 0, src, 0, 0, dst_w, h, src_w,
            f.resize_step[1 if pl else 0], f.resize_start[1 if pl else 0], bpc,
        )
        out.append(dst)
    return out


def run_dense_pass(t, f, tile_states, sbrow_marks, cols):
    """Replay queued work items (rav1d pass-2 analog: TileReconstruction
    replay, src/decode.rs:3895-3916), restructured for batching:

    1. "batch" items — plain inter blocks reading only reference frames —
       run first in any order: per-block prediction now, residuals collected
       as itx jobs and executed in one batched shot per (plane, size, type).
    2. "wavefront" items — intra / intrabc / inter-intra blocks that read
       reconstructed neighbour pixels — replay per-sbrow in decode order.
    """
    from ..syntax.levels import INTER_INTRA_NONE
    from .intra import recon_b_intra
    from .inter import recon_b_inter

    store = f.coef_store
    items = f.work_items
    is_key = f.frame_hdr.frame_type.is_key_or_intra

    def batchable(wi):
        return (
            wi.kind == "inter"
            and not is_key
            and wi.b.interintra_type == INTER_INTRA_NONE
        )

    # phase 1: batchable inter blocks (prediction + deferred residuals).
    # With the native syntax pass, simple-translation single-ref blocks are
    # emitted wholesale from the flat record/store arrays (no per-block
    # Python); complex blocks (compound, OBMC, warp, sub8x8 chroma, scaled
    # refs, interintra) still replay per block.
    f.itx_jobs = []
    f.mc_jobs = []
    f.bilin_jobs = []
    f.warp_jobs = []
    f.obmc_blends = []
    f.prep_jobs = []
    f.comp_records = []
    f.seg_masks_n = 0
    f.seg_masks = {}
    f.prep_results = None
    fast = None
    recs = getattr(f, "_sy_rec", None)
    if recs is not None and getattr(f, "_sy_out", None) is not None and \
            f._sy_out.n_rec == len(items):
        fast = _fast_block_mask(f, recs[: len(items)], is_key)
    for i, wi in enumerate(items):
        if not batchable(wi) or (fast is not None and fast[i]):
            continue
        t.bx, t.by = wi.bx, wi.by
        store.seek(wi.tx_pos, wi.cf_pos)
        if wi.warpmv is not None:
            t.warpmv = wi.warpmv
        t.tl_4x4_filter = wi.tl_4x4_filter
        recon_b_inter(t, f, wi.ts, wi.bs, wi.b, phase="apply", item=wi,
                      skip_residuals=fast is not None)
    if fast is not None and fast.any():
        _emit_fast_mc(f, recs[: len(items)], fast)
    _run_mc_jobs(f)
    f.mc_jobs = None
    _run_bilin_jobs(f)
    f.bilin_jobs = None
    _run_warp_jobs(f)
    f.warp_jobs = None
    _run_prep_jobs(f)
    f.prep_jobs = None
    from .inter import run_comp_record

    for rec in f.comp_records:
        run_comp_record(f, rec)
    f.comp_records = None
    _run_obmc_blends(f)
    f.obmc_blends = None
    if fast is not None:
        _emit_batch_itx_from_store(f, items, batchable)
    _run_itx_jobs(f)
    f.itx_jobs = None

    # precompute wavefront residuals batched (residuals are entropy-only
    # products, independent of the prediction wavefront)
    _precompute_wavefront_residuals(f, items, batchable)

    # phase 2: wavefront items per sbrow in decode order
    pos = 0
    for tile_row, sby, end in sbrow_marks:
        for wi in items[pos:end]:
            if batchable(wi):
                continue
            t.bx, t.by = wi.bx, wi.by
            store.seek(wi.tx_pos, wi.cf_pos)
            if wi.kind == "intra":
                if wi.pal is not None:
                    t.pal = wi.pal
                    t.pal_idx = wi.pal_idx
                recon_b_intra(
                    t, f, wi.ts, wi.bs, wi.intra_edge_flags, wi.b,
                    phase="apply", item=wi,
                )
            else:
                if wi.warpmv is not None:
                    t.warpmv = wi.warpmv
                t.tl_4x4_filter = wi.tl_4x4_filter
                recon_b_inter(t, f, wi.ts, wi.bs, wi.b, phase="apply", item=wi)
        pos = end
        _backup_ipred_edges(f, tile_states, tile_row, cols, sby)
    f.work_items = []


def _precompute_wavefront_residuals(f, items, batchable):
    """Batch-compute the inverse transforms of every wavefront (intra /
    intrabc / inter-intra) txblock up front, grouped by (w, h, txtp); the
    per-block wavefront then only predicts and adds. WHT (lossless) blocks
    fall back to the inline path."""
    from collections import defaultdict

    from ..ops.ref.itx import compute_residual_batch
    from ..syntax.levels import WHT_WHT

    store = f.coef_store
    n = len(items)
    groups = defaultdict(list)
    for i, wi in enumerate(items):
        if batchable(wi):
            continue
        end = wi.tx_end if wi.tx_end is not None else (
            items[i + 1].tx_pos if i + 1 < n else store.tx_pos
        )
        for tx in range(wi.tx_pos, end):
            eob = int(store.eob[tx])
            if eob < 0:
                continue
            tp = int(store.txtp[tx])
            if tp == WHT_WHT:
                continue
            groups[(int(store.txw[tx]), int(store.txh[tx]), tp)].append(tx)
    res = {}
    bpc = f.cur.bpc
    for (w, h, tp), idxs in groups.items():
        sw, sh = min(w, 32), min(h, 32)
        cfs = np.stack(
            [store.cf[store.cf_off[i] : store.cf_off[i] + sw * sh] for i in idxs]
        )
        out = compute_residual_batch(cfs, store.eob[idxs], w, h, tp, bpc)
        for k, i in enumerate(idxs):
            res[i] = out[k]
    store.residuals = res


def _run_mc_jobs(f):
    """Execute deferred simple 8-tap puts batched by (src plane, size,
    subpel pattern). Destinations may differ per job (frame planes, OBMC
    lap buffers); filtering is batched, the scatter is per job."""
    from ..ops.ref.mc import compute_8tap_batch

    groups = {}
    for job in f.mc_jobs:
        dst, dy, dx, src, sy, sx, w, h, fmx, fmy, f2d, vw, vh = job
        key = (id(src), w, h, fmx != 0, fmy != 0)
        groups.setdefault(key, []).append(job)
    bpc = f.cur.bpc
    for jobs in groups.values():
        _, _, _, src, _, _, w, h, _, _, _, vw, vh = jobs[0]
        out = compute_8tap_batch(
            src,
            [j[4] for j in jobs], [j[5] for j in jobs],
            w, h,
            [j[8] for j in jobs], [j[9] for j in jobs],
            [j[10] for j in jobs], vw, vh, bpc,
        )
        for k, j in enumerate(jobs):
            j[0][j[1] : j[1] + h, j[2] : j[2] + w] = out[k].astype(j[0].dtype)


def _run_bilin_jobs(f):
    """Execute deferred bilinear puts (rare: b.filter2d == BILINEAR); per
    job, with the same emu-edge branch as the inline path (recon/inter.mc)."""
    from ..ops.ref import mc as M

    bpc = f.cur.bpc
    for dst, dst_y, dst_x, plane, dy, dx, w_px, h_px, fmx, fmy, f2d, vw, vh \
            in f.bilin_jobs:
        mx3 = 3 if fmx else 0
        my3 = 3 if fmy else 0
        if (
            dx < mx3
            or dy < my3
            or dx + w_px + (4 if fmx else 0) > vw
            or dy + h_px + (4 if fmy else 0) > vh
        ):
            src = M.emu_edge(
                w_px + (7 if fmx else 0), h_px + (7 if fmy else 0),
                vw, vh, dx - mx3, dy - my3, plane,
            )
            sy, sx = my3, mx3
        else:
            src, sy, sx = plane, dy, dx
        M.put_bilin(dst, dst_y, dst_x, src, sy, sx, w_px, h_px, fmx, fmy, bpc)


def _run_prep_jobs(f):
    """Execute deferred compound prep filters batched by (src plane, size,
    subpel pattern); results land in f.prep_results for the combiners."""
    from ..ops.ref.mc import compute_prep_8tap_batch

    f.prep_results = [None] * len(f.prep_jobs)
    groups = {}
    for idx, job in enumerate(f.prep_jobs):
        plane, dy, dx, w, h, fmx, fmy, f2d, vw, vh = job
        key = (id(plane), w, h, fmx != 0, fmy != 0)
        groups.setdefault(key, []).append((idx, job))
    bpc = f.cur.bpc
    for pairs in groups.values():
        _, (plane, _, _, w, h, _, _, _, vw, vh) = pairs[0][0], pairs[0][1]
        out = compute_prep_8tap_batch(
            plane,
            [j[1] for _, j in pairs], [j[2] for _, j in pairs],
            w, h,
            [j[5] for _, j in pairs], [j[6] for _, j in pairs],
            [j[7] for _, j in pairs], vw, vh, bpc,
        )
        for k, (idx, _) in enumerate(pairs):
            f.prep_results[idx] = out[k]


def _run_obmc_blends(f):
    """Apply deferred OBMC blends in decode order (top laps before left
    laps within a block, rav1d obmc ordering; regions of different blocks
    are disjoint)."""
    from ..ops.ref import mc as M

    for kind, dst, dy, dx, lap, w, h in f.obmc_blends:
        if kind == "h":
            M.blend_h(dst, dy, dx, lap, w, h)
        else:
            M.blend_v(dst, dy, dx, lap, w, h)


def _run_warp_jobs(f):
    """Execute deferred warp tiles batched per (dst, src) plane pair."""
    from ..ops.ref.mc import warp_affine_8x8_batch

    groups = {}
    for job in f.warp_jobs:
        key = (id(job[0]), id(job[3]))
        groups.setdefault(key, []).append(job)
    bpc = f.cur.bpc
    for jobs in groups.values():
        dst, _, _, src, _, _, _, _, _, vw, vh = jobs[0]
        warp_affine_8x8_batch(
            dst, src,
            [j[1] for j in jobs], [j[2] for j in jobs],
            [j[4] for j in jobs], [j[5] for j in jobs],
            [j[6] for j in jobs], [j[7] for j in jobs], [j[8] for j in jobs],
            vw, vh, bpc,
        )


def _run_itx_jobs(f):
    """Execute collected inter residual jobs batched by (plane, w, h, txtp).
    Inter residual regions are mutually disjoint, so batching is exact."""
    from collections import defaultdict

    from ..ops.ref.itx import inv_txfm_add_batch

    groups = defaultdict(list)
    for pl, y, x, w, h, eob, txtp, cf in f.itx_jobs:
        groups[(pl, w, h, txtp)].append((y, x, eob, cf))
    planes = (f.cur.y, f.cur.u, f.cur.v)
    bpc = f.cur.bpc
    for (pl, w, h, txtp), jobs in groups.items():
        ys = np.array([j[0] for j in jobs])
        xs = np.array([j[1] for j in jobs])
        eobs = np.array([j[2] for j in jobs])
        sw, sh = min(w, 32), min(h, 32)
        cfs = np.stack([j[3][: sw * sh] for j in jobs])
        inv_txfm_add_batch(planes[pl], ys, xs, cfs, eobs, w, h, txtp, bpc)


def decode_tile_sbrow_wrap(t, f, ts, sby):
    decode_tile_sbrow(t, f, ts, sby)


def _decode_tile_sbrow_native(t, f, ts, sby, tile_states):
    """Native-core tile-sbrow decode: the Python shell of decode_tile_sbrow
    (restoration reads, refmvs tile bounds, tx_lpf edge backup) around C
    sy_decode_sb calls (native/syntax.c)."""
    from ..native import syntax as _nsy
    from ..syntax.decode import _read_sb_restoration

    out = f._sy_out
    store = f.coef_store
    rec_start = out.n_rec

    _sbrow_core(t, f, ts, sby, out, f._sy_task)

    # sync CoefStore cursors with the native output state
    store.tx_pos = out.tx_pos
    store.cf_pos = out.cf_pos

    # queue the new records for lazy WorkItem conversion (dense-pass input)
    f._wi_pending.append((ts._sy.tile_idx, rec_start, out.n_rec, None))


def _syntax_tiles_parallel(ctx, f, tile_states, rows, cols, sbrow_marks,
                           n_threads):
    """Tile-parallel syntax plane: every tile's entropy state is
    independent (src/internal.rs:824-845), so tiles decode on host threads
    — the C core releases the GIL per superblock call — each writing a
    DISJOINT region of the shared coefficient store / record arenas.
    After the join, tile-local offsets are rebased and records merge into
    decode order (sbrow-major, tile-column order), so every downstream
    consumer sees exactly the serial data model. Parity: the tile tasks of
    src/thread_task.rs:178-249 with --threads (lib.rs get_num_threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..native import syntax as _nsy
    from ..syntax import refmvs as _refmvs
    from ..syntax.decode import DecodeError, TaskContext

    frame_hdr = f.frame_hdr
    store = f.coef_store
    is_inter_or_switch = frame_hdr.frame_type.is_inter_or_switch

    # per-tile region budgets (same shape as CoefStore's frame budget)
    bases = []
    cf_pos = tx_pos = rec_pos = filt_pos = pal_pos = palidx_pos = 0
    for ts in tile_states:
        w4t = ts.col_end - ts.col_start
        h4t = ts.row_end - ts.row_start
        pw = (w4t + 16 + 15) & ~15
        ph = (h4t + 16 + 15) & ~15
        b = {
            "cf_b": cf_pos, "cf_cap": pw * ph * 16 * 3 + 1024,
            "tx_b": tx_pos, "tx_cap": pw * ph * 3 + 64,
            "rec_b": rec_pos, "rec_cap": w4t * h4t + 1024,
            "filt_b": filt_pos, "pal_b": pal_pos, "palidx_b": palidx_pos,
        }
        b["filt_cap"] = b["rec_cap"] * 80 + 4096
        b["pal_cap"] = b["rec_cap"] * 24 + 64
        b["palidx_cap"] = 2 * w4t * h4t * 16 + 8192
        cf_pos += b["cf_cap"]
        tx_pos += b["tx_cap"]
        rec_pos += b["rec_cap"]
        filt_pos += b["filt_cap"]
        pal_pos += b["pal_cap"]
        palidx_pos += b["palidx_cap"]
        bases.append(b)

    # grow the shared arrays to the sum of regions (per-tile padding makes
    # this larger than the serial frame budget)
    if cf_pos > store.cf.size:
        store.cf = np.zeros(cf_pos, store.cf.dtype)
    if tx_pos > store.eob.size:
        for nm, dt in (("eob", np.int32), ("txtp", np.int32),
                       ("txw", np.int16), ("txh", np.int16),
                       ("cf_off", np.int64), ("txpl", np.uint8),
                       ("txx", np.int32), ("txy", np.int32)):
            setattr(store, nm, np.zeros(tx_pos, dt))
    store.eob[:] = -1  # region gaps must read as "no coefficients"
    if rec_pos > f._sy_rec.size:
        f._sy_rec = np.zeros(rec_pos, dtype=_nsy.BLOCK_REC_DTYPE)
    if filt_pos > f._sy_filt.size:
        f._sy_filt = np.zeros(filt_pos, np.uint8)
    if pal_pos > f._sy_pal.size:
        f._sy_pal = np.zeros(pal_pos, np.uint16)
    if palidx_pos > f._sy_palidx.size:
        f._sy_palidx = np.zeros(palidx_pos, np.uint8)
    f._sy_out = None  # the serial fast-path mask keys off this

    def run_tile(idx):
        ts = tile_states[idx]
        out = _nsy.build_tile_out(store, f._sy_rec, f._sy_filt, f._sy_pal,
                                  f._sy_palidx, bases[idx])
        tl = TaskContext(f)
        stk = _nsy.build_task(tl)
        marks = []
        tr = ts.tile_row
        sbh_start = frame_hdr.tiling.row_start_sb[tr]
        sbh_end = min(frame_hdr.tiling.row_start_sb[tr + 1], f.sbh)
        c0, c1 = ts.col_start >> 1, ts.col_end >> 1
        for sby in range(sbh_start, sbh_end):
            by = sby << f.sb_shift
            by_end = (by + f.sb_step) >> 1
            if frame_hdr.use_ref_frame_mvs:
                _refmvs.load_tmvs(f.rf, frame_hdr, c0, c1, by >> 1, by_end)
            if ts.msac.cnt < -15:
                raise DecodeError("msac overread")
            rec0 = out.n_rec
            _sbrow_core(tl, f, ts, sby, out, stk)
            if is_inter_or_switch:
                _refmvs.save_tmvs(f.rf, c0, c1, by >> 1, by_end)
            marks.append((sby, rec0, out.n_rec))
        return idx, out, marks

    with ThreadPoolExecutor(min(n_threads, len(tile_states))) as ex:
        results = list(ex.map(run_tile, range(len(tile_states))))

    # rebase tile-local offsets into the shared arrays + store cursors
    ends_by_tile = {}
    rows_by_tile = {}
    for idx, out, marks in results:
        b = bases[idx]
        n = out.n_rec
        r = f._sy_rec[b["rec_b"] : b["rec_b"] + n]
        r["cf_pos"] += b["cf_b"]
        r["tx_pos"] += b["tx_b"]
        for nm in ("afilter_off", "pal_off", "palidx_off"):
            v = r[nm]
            base = {"afilter_off": b["filt_b"], "pal_off": b["pal_b"],
                    "palidx_off": b["palidx_b"]}[nm]
            r[nm] = np.where(v >= 0, v + base, v)
        store.cf_off[b["tx_b"] : b["tx_b"] + out.tx_pos] += b["cf_b"]
        store.tx_pos = max(store.tx_pos, b["tx_b"] + out.tx_pos)
        store.cf_pos = max(store.cf_pos, b["cf_b"] + out.cf_pos)
        ends_by_tile[idx] = np.append(
            r["tx_pos"][1:], b["tx_b"] + out.tx_pos
        ).tolist()
        rows_by_tile[idx] = {sby: (lo, hi) for sby, lo, hi in marks}

    # merge records into decode order (sbrow-major, tile-column order)
    for tr in range(rows):
        sbh_start = frame_hdr.tiling.row_start_sb[tr]
        sbh_end = min(frame_hdr.tiling.row_start_sb[tr + 1], f.sbh)
        for sby in range(sbh_start, sbh_end):
            for col in range(cols):
                idx = tr * cols + col
                lo, hi = rows_by_tile[idx][sby]
                gb = bases[idx]["rec_b"]
                f._wi_pending.append(
                    (idx, gb + lo, gb + hi, ends_by_tile[idx][lo:hi])
                )
            sbrow_marks.append((tr, sby, _wi_len(f)))


def _sbrow_core(t, f, ts, sby, out, stk):
    """One tile-sbrow through the native core into `out`/`stk` (no shared
    cursors: usable from per-tile threads; recon/frame.py tile-parallel
    syntax). Parity: rav1d_decode_tile_sbrow, src/decode.rs:3853."""
    from ..native import syntax as _nsy
    from ..syntax.decode import _read_sb_restoration

    frame_hdr = f.frame_hdr
    sb_step = f.sb_step
    t.by = sby << f.sb_shift
    stk.by = t.by

    if frame_hdr.frame_type.is_inter_or_switch or frame_hdr.allow_intrabc:
        stk.rt_col_start = ts.col_start
        stk.rt_col_end = min(ts.col_end, f.rf.iw4)
        stk.rt_row_start = ts.row_start
        stk.rt_row_end = min(ts.row_end, f.rf.ih4)
    reset_context(t.l_np, not frame_hdr.frame_type.is_inter_or_switch, 0)
    t.pal_sz_uv_np[1][:] = 0

    t.bx = ts.col_start
    while t.bx < ts.col_end:
        _read_sb_restoration(t, f, ts, sb_step)
        stk.bx = t.bx
        stk.by = t.by
        _nsy.decode_sb(f._sy_frame, ts._sy, stk, out)
        t.bx += sb_step

    # tile right-edge tx_lpf backup (decode.rs:4540)
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    off = t.by & 16
    lnp = t.l_np
    f.tx_lpf_right_edge[0][ts.tile_col, t.by : t.by + sb_step] = lnp.tx_lpf_y[
        off : off + sb_step
    ]
    cstep = sb_step >> ss_ver
    f.tx_lpf_right_edge[1][
        ts.tile_col, (t.by >> ss_ver) : (t.by >> ss_ver) + cstep
    ] = lnp.tx_lpf_uv[(off >> ss_ver) : (off >> ss_ver) + cstep]


def _backup_ipred_edges(f, tile_states, tile_row, cols, sby):
    """Save the bottom pixel row of this sbrow as next row's top edge
    (rav1d_backup_ipred_edge, src/recon.rs:4340)."""
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    by = sby << f.sb_shift
    y_row = (by + f.sb_step) * 4 - 1
    for col in range(cols):
        ts = tile_states[tile_row * cols + col]
        x0 = ts.col_start * 4
        x1 = ts.col_end * 4
        f.ipred_edge[0][sby, x0:x1] = f.cur.y[y_row, x0:x1]
        if layout != PixelLayout.I400:
            uv_row = (((by + f.sb_step) * 4) >> ss_ver) - 1
            cx0 = x0 >> ss_hor
            cx1 = x1 >> ss_hor
            f.ipred_edge[1][sby, cx0:cx1] = f.cur.u[uv_row, cx0:cx1]
            f.ipred_edge[2][sby, cx0:cx1] = f.cur.v[uv_row, cx0:cx1]


def _split_tiles(f, frame_hdr):
    """Slice the accumulated tile-group payloads into per-tile msac buffers
    (parity: rav1d_decode_frame_init_cdf tile setup, src/decode.rs:4400)."""
    from ..bits import GetBits

    n_tiles = frame_hdr.tiling.cols * frame_hdr.tiling.rows
    out = [None] * n_tiles
    for tg in f.tiles:
        data = tg.data
        start, end = tg.hdr.start, tg.hdr.end
        pos = 0
        for n in range(start, end + 1):
            if n == end:
                sz = len(data) - pos
            else:
                sz = 0
                n_bytes = frame_hdr.tiling.n_bytes
                for i in range(n_bytes):
                    sz |= data[pos + i] << (i * 8)
                sz += 1
                pos += n_bytes
            if sz > len(data) - pos:
                raise DecodeError("tile size overruns tile group")
            out[n] = data[pos : pos + sz]
            pos += sz
    if any(v is None for v in out):
        raise DecodeError("missing tiles")
    f.tiles = []
    return out


def _fast_block_mask(f, r, is_key):
    """Vector predicate over the flat block records selecting simple
    single-ref translation blocks whose prediction + residuals can be
    emitted wholesale (no per-block Python)."""
    from ..tables.block_tables import BLOCK_DIMENSIONS
    from ..syntax.levels import GLOBALMV, FILTER_2D_BILINEAR

    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    bd = np.asarray(BLOCK_DIMENSIONS, dtype=np.int32)
    bw4 = bd[r["bs"], 0]
    bh4 = bd[r["bs"], 1]
    gwa = np.asarray(
        [1 if v else 0 for v in f.gmv_warp_allowed] + [0], dtype=np.int32
    )
    ref0 = r["ref0"].astype(np.int32)
    svc = np.asarray([f.svc[i][0]["scale"] for i in range(7)] + [0],
                     dtype=np.int64)
    mask = (
        (r["kind"] == 1)
        & (not is_key)
        & (r["interintra_type"] == 0)
        & (r["comp_type"] == 0)
        & (r["motion_mode"] == 0)
        & ~((r["inter_mode"] == GLOBALMV) & (gwa[ref0] != 0))
        & (svc[ref0] == 0)
        & (r["filter2d"] != FILTER_2D_BILINEAR)
        & (bw4 > ss_hor)
        & (bh4 > ss_ver)
    )
    return mask


def _emit_fast_mc(f, r, fast):
    """Append batched-executor mc jobs for all fast blocks directly from
    the record arrays (the vectorized form of recon_b_inter's simple
    translation path, recon.rs mc:2025 unscaled branch)."""
    from ..tables.block_tables import BLOCK_DIMENSIONS
    from ..ops.ref.mc import compute_8tap_batch

    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0
    bd = np.asarray(BLOCK_DIMENSIONS, dtype=np.int32)
    idx = np.nonzero(fast)[0]
    bs = r["bs"][idx]
    bw4 = bd[bs, 0]
    bh4 = bd[bs, 1]
    bx = r["bx"][idx].astype(np.int32)
    by = r["by"][idx].astype(np.int32)
    mv = r["mv"][idx].astype(np.int32)  # (K, 2, 2) [n][x,y]
    mvx, mvy = mv[:, 0, 0], mv[:, 0, 1]
    ref0 = r["ref0"][idx].astype(np.int32)
    f2d = r["filter2d"][idx].astype(np.int32)
    bpc = f.cur.bpc

    planes = [
        # (pl, ss_h, ss_v)
        (0, 0, 0),
    ]
    if layout != PixelLayout.I400:
        planes += [(1, ss_hor, ss_ver), (2, ss_hor, ss_ver)]

    for pl, sh, sv in planes:
        h_mul, v_mul = 4 >> sh, 4 >> sv
        mx = mvx & (15 >> (0 if sh else 1))
        my = mvy & (15 >> (0 if sv else 1))
        dx = bx * h_mul + (mvx >> (3 + sh))
        dy = by * v_mul + (mvy >> (3 + sv))
        fmx = mx << (0 if sh else 1)
        fmy = my << (0 if sv else 1)
        w_px = bw4 * h_mul
        h_px = bh4 * v_mul
        vis_w = (f.cur.w + sh) >> sh
        vis_h = (f.cur.h + sv) >> sv
        key = (
            (ref0.astype(np.int64) * 2048 + w_px) * 2048 + h_px
        ) * 4 + (fmx != 0) * 2 + (fmy != 0)
        uniq, inv = np.unique(key, return_inverse=True)
        dstp = (f.cur.y, f.cur.u, f.cur.v)[pl]
        for g in range(len(uniq)):
            sel = np.nonzero(inv == g)[0]
            refidx = int(ref0[sel[0]])
            src = (f.refp[refidx].y, f.refp[refidx].u, f.refp[refidx].v)[pl]
            w = int(w_px[sel[0]])
            h = int(h_px[sel[0]])
            out = compute_8tap_batch(
                src, dy[sel], dx[sel], w, h, fmx[sel], fmy[sel], f2d[sel],
                vis_w, vis_h, bpc,
            )
            drows = by[sel][:, None] * v_mul + np.arange(h)[None, :]
            dcols = bx[sel][:, None] * h_mul + np.arange(w)[None, :]
            dstp[drows[:, :, None], dcols[:, None, :]] = out.astype(
                dstp.dtype
            )


def _emit_batch_itx_from_store(f, items, batchable):
    """Append itx jobs for every batchable block straight from the coef
    store's per-txblock (plane, x, y) records (written by the native
    syntax pass) — the vectorized form of read_coef_tree's apply walk."""
    store = f.coef_store
    n = len(items)
    ntx = store.tx_pos
    starts = np.fromiter(
        (wi.tx_pos for wi in items), dtype=np.int64, count=n
    )
    if items[0].tx_end is not None:
        ends = np.fromiter(
            (wi.tx_end for wi in items), dtype=np.int64, count=n
        )
    else:
        ends = np.empty(n, dtype=np.int64)
        ends[:-1] = starts[1:]
        ends[-1] = ntx
    bsel = np.fromiter((batchable(wi) for wi in items), dtype=bool, count=n)
    d = np.zeros(ntx + 1, dtype=np.int32)
    np.add.at(d, starts[bsel], 1)
    np.add.at(d, ends[bsel], -1)
    mask = np.cumsum(d[:-1]) > 0
    mask &= store.eob[:ntx] >= 0
    tidx = np.nonzero(mask)[0]
    if not tidx.size:
        return
    pls = store.txpl[tidx]
    ws = store.txw[tidx].astype(np.int64)
    hs = store.txh[tidx].astype(np.int64)
    tps = store.txtp[tidx].astype(np.int64)
    key = ((pls.astype(np.int64) * 2048 + ws) * 2048 + hs) * 32 + tps
    uniq, inv = np.unique(key, return_inverse=True)
    from ..ops.ref.itx import inv_txfm_add_batch

    planes = (f.cur.y, f.cur.u, f.cur.v)
    bpc = f.cur.bpc
    for g in range(len(uniq)):
        sel = tidx[inv == g]
        pl = int(store.txpl[sel[0]])
        w = int(store.txw[sel[0]])
        h = int(store.txh[sel[0]])
        txtp = int(store.txtp[sel[0]])
        sw, shh = min(w, 32), min(h, 32)
        sz = (sw >> 2) * (shh >> 2) * 16
        offs = store.cf_off[sel]
        cfs = store.cf[offs[:, None] + np.arange(sz)[None, :]]
        inv_txfm_add_batch(
            planes[pl], store.txy[sel], store.txx[sel], cfs,
            store.eob[sel], w, h, txtp, bpc,
        )