"""ctypes bindings + glue for the native syntax pass (csrc/host/syntax.c).

The native core runs the full decode_sb/decode_b walk per superblock,
writing coefficients into the frame CoefStore arrays and per-block work
records (BlockRec) + side arenas. This module mirrors the C interface
structs, builds them from the decoder's Python state, and converts the
flat records back into the WorkItem objects the dense pass replays.

The library is built like the entropy core's (native/__init__.py
build_host). Where it cannot be built, the pure-Python syntax pass in
syntax/decode.py (the correctness anchor) runs instead.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import build_host

_SRCS = ["entropy.c", "refmvs.c", "syntax.c"]

P = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64


def _build():
    return build_host("syntaxfull", _SRCS, ["-O2", "-fPIC", "-shared"])


class MvCompCdfC(ctypes.Structure):
    _fields_ = [(n, P) for n in (
        "classes", "class0_fp", "classN_fp", "class0_hp", "classN_hp",
        "class0", "classN", "sign",
    )]


_CDF_M_NAMES = (
    "partition", "kfym", "y_mode", "uv_mode", "angle_delta", "filter_intra",
    "use_filter_intra", "cfl_sign", "cfl_alpha", "txsz", "txpart", "skip",
    "skip_mode", "seg_pred", "seg_id", "delta_q", "delta_lf", "intra",
    "intrabc", "pal_y", "pal_uv", "pal_sz", "color_map", "comp", "comp_dir",
    "comp_fwd_ref", "comp_bwd_ref", "comp_uni_ref", "ref", "comp_inter_mode",
    "newmv_mode", "globalmv_mode", "refmv_mode", "drl_bit", "interintra",
    "interintra_mode", "interintra_wedge", "wedge_comp", "wedge_idx",
    "jnt_comp", "mask_comp", "motion_mode", "obmc", "filter", "txtp_intra1",
    "txtp_intra2", "txtp_inter1", "txtp_inter2", "txtp_inter3",
)

_COEF_NAMES = (
    "skip", "eob_bin_16", "eob_bin_32", "eob_bin_64", "eob_bin_128",
    "eob_bin_256", "eob_bin_512", "eob_bin_1024", "eob_hi_bit",
    "eob_base_tok", "base_tok", "br_tok", "dc_sign",
)


class CoefCdfPtrsC(ctypes.Structure):
    _fields_ = [(n, P) for n in _COEF_NAMES]


class SyCdfC(ctypes.Structure):
    _fields_ = (
        [(n, P) for n in _CDF_M_NAMES]
        + [("mv_joint", P)]
        + [("mv_comp", MvCompCdfC * 2), ("dmv_comp", MvCompCdfC * 2)]
        + [("coef", CoefCdfPtrsC)]
    )


_BLKCTX_NAMES = (
    "mode", "uvmode", "lcoef", "ccoef0", "ccoef1", "seg_pred", "skip",
    "skip_mode", "intra", "comp_type", "ref0", "ref1", "filter0", "filter1",
    "tx_intra", "tx", "tx_lpf_y", "tx_lpf_uv", "partition", "pal_sz",
)


class BlkCtxC(ctypes.Structure):
    _fields_ = [(n, P) for n in _BLKCTX_NAMES]


class SySegDataC(ctypes.Structure):
    _fields_ = [
        ("delta_q", I32), ("delta_lf_y_v", I32), ("delta_lf_y_h", I32),
        ("delta_lf_u", I32), ("delta_lf_v", I32), ("ref", I32),
        ("skip", I32), ("globalmv", I32),
    ]


class SyGmvC(ctypes.Structure):
    _fields_ = [("type", I32), ("matrix", I32 * 6)]


class SyFrameC(ctypes.Structure):
    _fields_ = [
        ("bw", I32), ("bh", I32), ("w4", I32), ("h4", I32),
        ("sb_shift", I32), ("sb_step", I32),
        ("sb128", I32), ("layout", I32), ("bpc", I32), ("b4_stride", I32),
        ("sr_sb128w", I32),
        ("frame_type", I32), ("allow_intrabc", I32), ("frame_offset", I32),
        ("skip_mode_enabled", I32), ("skip_mode_refs0", I32),
        ("skip_mode_refs1", I32),
        ("switchable_comp_refs", I32), ("switchable_motion_mode", I32),
        ("warp_motion", I32),
        ("force_integer_mv", I32), ("hp", I32), ("subpel_filter_mode", I32),
        ("dual_filter", I32),
        ("txfm_mode", I32), ("reduced_txtp_set", I32),
        ("allow_screen_content_tools", I32),
        ("filter_intra", I32), ("inter_intra", I32), ("masked_compound", I32),
        ("jnt_comp", I32),
        ("order_hint_n_bits", I32), ("use_ref_frame_mvs", I32),
        ("cdef_n_bits", I32),
        ("delta_q_present", I32), ("delta_q_res_log2", I32),
        ("delta_lf_present", I32), ("delta_lf_res_log2", I32),
        ("delta_lf_multi", I32),
        ("qidx_yac", I32), ("ydc_delta", I32), ("uac_delta", I32),
        ("udc_delta", I32), ("vac_delta", I32), ("vdc_delta", I32),
        ("hbd", I32),
        ("seg_enabled", I32), ("seg_update_map", I32), ("seg_temporal", I32),
        ("seg_preskip", I32), ("seg_last_active_segid", I32),
        ("seg_lossless", I32 * 8), ("seg_qidx", I32 * 8),
        ("seg", SySegDataC * 8),
        ("lf_level_y", I32 * 2), ("lf_level_u", I32), ("lf_level_v", I32),
        ("lf_mode_ref_delta_enabled", I32), ("lf_mode_delta", I32 * 2),
        ("lf_ref_delta", I32 * 8),
        ("gmv", SyGmvC * 7), ("refpoc", I32 * 7), ("svc_scale", I32 * 7),
        ("dq_tbl", P), ("scans", P * 19), ("qm", (P * 3) * 19),
        ("cdef_idx", P), ("cdef_stride", I32),
        ("noskip4", P), ("noskip_stride", I32),
        ("cur_segmap", P), ("prev_segmap", P), ("segmap_stride", I32),
        ("lf_level", P), ("lf_cls", P * 4), ("lf_cls_stride", I32),
        ("rmv_r", P), ("rmv_r_stride", I32),
        ("rmv_rp_proj", P), ("rmv_rp_stride", I32),
        ("rmv_pocdiff", I32 * 7), ("rmv_sign_bias", I32 * 7),
        ("rmv_use_ref_frame_mvs", I32), ("rmv_iw4", I32), ("rmv_ih4", I32),
        ("dbg_trace", I32),
    ]


class SyTileC(ctypes.Structure):
    _fields_ = [
        ("msac", P),
        ("cdf", SyCdfC),
        ("a", BlkCtxC),
        ("col_start", I32), ("col_end", I32), ("row_start", I32),
        ("row_end", I32), ("tile_row", I32), ("tile_col", I32),
        ("tile_idx", I32),
        ("last_qidx", I32),
        ("last_delta_lf", I32 * 4),
        ("dq", ((I32 * 2) * 3) * 8),
        ("lflvl", ctypes.c_uint8 * (8 * 4 * 8 * 2)),
    ]


class SyTaskC(ctypes.Structure):
    _fields_ = [
        ("bx", I32), ("by", I32),
        ("l", BlkCtxC),
        ("al_pal", P), ("pal_sz_uv", P), ("pal", P), ("pal_idx", P),
        ("txtp_map", P),
        ("tl_4x4_filter", I32),
        ("wm_type", I32), ("wm_mat", I32 * 6),
        ("wm_alpha", I32), ("wm_beta", I32), ("wm_gamma", I32),
        ("wm_delta", I32),
        ("rt_col_start", I32), ("rt_col_end", I32), ("rt_row_start", I32),
        ("rt_row_end", I32),
    ]


class TmvsCallC(ctypes.Structure):
    _fields_ = [
        ("r", P), ("r_stride", I32),
        ("rp", P), ("rp_stride", I32),
        ("rp_proj", P), ("proj_stride", I32),
        ("rp_ref", P * 7), ("rp_ref_stride", I32 * 7),
        ("mfmv_ref", I32 * 3), ("mfmv_ref2cur", I32 * 3),
        ("mfmv_ref2ref", (I32 * 7) * 3), ("n_mfmvs", I32),
        ("mfmv_sign", I32 * 7),
        ("iw8", I32), ("ih8", I32),
        ("col_start8", I32), ("col_end8", I32),
        ("row_start8", I32), ("row_end8", I32),
        ("bdims", P),
    ]


class SyOutC(ctypes.Structure):
    _fields_ = [
        ("cf", P), ("eob", P), ("txtp", P), ("txw", P), ("txh", P),
        ("cf_off", P), ("txpl", P), ("txx", P), ("txy", P),
        ("cf_pos", I64), ("tx_pos", I32), ("pad0", I32),
        ("rec", P), ("n_rec", I32), ("rec_cap", I32),
        ("filt_arena", P), ("filt_pos", I32), ("filt_cap", I32),
        ("pal_arena", P), ("pal_pos", I32), ("pal_cap", I32),
        ("palidx_arena", P), ("palidx_pos", I32), ("palidx_cap", I32),
        ("error", I32), ("pad1", I32),
    ]


# numpy mirror of struct BlockRec (native/syntax.c); 128 bytes
BLOCK_REC_DTYPE = np.dtype({
    "names": [
        "cf_pos", "tx_pos", "afilter_off", "pal_off", "palidx_off",
        "wm_mat", "matrix", "dbg_rng", "bx", "by", "mv",
        "wm_alpha", "wm_beta", "wm_gamma", "wm_delta", "sm_fl", "sm_uv_fl",
        "tx_split1",
        "kind", "bl", "bs", "bp", "intra", "seg_id", "skip_mode", "skip",
        "y_mode", "uv_mode", "tx", "uvtx", "max_ytx",
        "y_angle", "uv_angle", "cfl_alpha0", "cfl_alpha1",
        "pal_sz0", "pal_sz1", "tx_split0",
        "inter_mode", "drl_idx", "comp_type", "motion_mode", "filter2d",
        "ref0", "ref1",
        "interintra_type", "interintra_mode", "wedge_idx", "mask_sign",
        "wm_type", "tl_4x4_filter", "intra_edge_flags",
    ],
    "formats": [
        np.int64, np.int32, np.int32, np.int32, np.int32,
        (np.int32, (6,)), (np.int32, (4,)), np.uint32, np.int16, np.int16,
        (np.int16, (2, 2)),
        np.int16, np.int16, np.int16, np.int16, np.int16, np.int16,
        np.uint16,
        np.uint8, np.uint8, np.uint8, np.uint8, np.uint8, np.uint8,
        np.uint8, np.uint8,
        np.uint8, np.uint8, np.uint8, np.uint8, np.uint8,
        np.int8, np.int8, np.int8, np.int8,
        np.uint8, np.uint8, np.uint8,
        np.uint8, np.uint8, np.uint8, np.uint8, np.uint8,
        np.int8, np.int8,
        np.uint8, np.uint8, np.uint8, np.uint8,
        np.uint8, np.uint8, np.uint8,
    ],
    "offsets": [
        0, 8, 12, 16, 20,
        24, 48, 64, 68, 70, 72,
        80, 82, 84, 86, 88, 90,
        92,
        94, 95, 96, 97, 98, 99, 100, 101,
        102, 103, 104, 105, 106,
        107, 108, 109, 110,
        111, 112, 113,
        114, 115, 116, 117, 118,
        119, 120,
        121, 122, 123, 124,
        125, 126, 127,
    ],
    "itemsize": 128,
})


def _load():
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.sy_global_init.argtypes = []
    lib.sy_global_init.restype = I32
    lib.sy_global_init()  # thread-safe lazy-table init (tile threads)
    lib.sy_decode_sb.argtypes = [
        ctypes.POINTER(SyFrameC), ctypes.POINTER(SyTileC),
        ctypes.POINTER(SyTaskC), ctypes.POINTER(SyOutC),
    ]
    lib.sy_decode_sb.restype = I32
    lib.sy_tile_init_tables.argtypes = [
        ctypes.POINTER(SyFrameC), ctypes.POINTER(SyTileC),
    ]
    lib.sy_tile_init_tables.restype = None
    lib.sy_save_tmvs.argtypes = [ctypes.POINTER(TmvsCallC)]
    lib.sy_save_tmvs.restype = None
    lib.sy_load_tmvs.argtypes = [ctypes.POINTER(TmvsCallC)]
    lib.sy_load_tmvs.restype = None
    return lib


LIB = _load()
AVAILABLE = LIB is not None
# runtime escape hatch (tests that exercise the Python syntax anchor)
FORCE_OFF = False


def enabled() -> bool:
    return AVAILABLE and not FORCE_OFF


class NpBlockContext:
    """numpy-backed BlockContext for the native core (same attribute shape
    as syntax/env.py BlockContext so shared Python touchpoints work)."""

    __slots__ = (
        "mode", "lcoef", "ccoef", "seg_pred", "skip", "skip_mode", "intra",
        "comp_type", "ref", "filter", "tx_intra", "tx", "tx_lpf_y",
        "tx_lpf_uv", "partition", "uvmode", "pal_sz",
    )

    def __init__(self, n: int = 32):
        self.mode = np.zeros(n, np.uint8)
        self.lcoef = np.full(n, 0x40, np.uint8)
        self.ccoef = [
            np.full(n, 0x40, np.uint8),
            np.full(n, 0x40, np.uint8),
        ]
        self.seg_pred = np.zeros(n, np.uint8)
        self.skip = np.zeros(n, np.uint8)
        self.skip_mode = np.zeros(n, np.uint8)
        self.intra = np.zeros(n, np.uint8)
        self.comp_type = np.zeros(n, np.uint8)
        self.ref = [np.full(n, -1, np.int8), np.full(n, -1, np.int8)]
        self.filter = [np.full(n, 3, np.uint8), np.full(n, 3, np.uint8)]
        self.tx_intra = np.zeros(n, np.int8)
        self.tx = np.zeros(n, np.int8)
        self.tx_lpf_y = np.zeros(n, np.uint8)
        self.tx_lpf_uv = np.zeros(n, np.uint8)
        self.partition = np.zeros(n >> 1, np.uint8)
        self.uvmode = np.zeros(n, np.uint8)
        self.pal_sz = np.zeros(n, np.uint8)


def _fill_blkctx(dst: BlkCtxC, ctx: NpBlockContext):
    dst.mode = ctx.mode.ctypes.data
    dst.uvmode = ctx.uvmode.ctypes.data
    dst.lcoef = ctx.lcoef.ctypes.data
    dst.ccoef0 = ctx.ccoef[0].ctypes.data
    dst.ccoef1 = ctx.ccoef[1].ctypes.data
    dst.seg_pred = ctx.seg_pred.ctypes.data
    dst.skip = ctx.skip.ctypes.data
    dst.skip_mode = ctx.skip_mode.ctypes.data
    dst.intra = ctx.intra.ctypes.data
    dst.comp_type = ctx.comp_type.ctypes.data
    dst.ref0 = ctx.ref[0].ctypes.data
    dst.ref1 = ctx.ref[1].ctypes.data
    dst.filter0 = ctx.filter[0].ctypes.data
    dst.filter1 = ctx.filter[1].ctypes.data
    dst.tx_intra = ctx.tx_intra.ctypes.data
    dst.tx = ctx.tx.ctypes.data
    dst.tx_lpf_y = ctx.tx_lpf_y.ctypes.data
    dst.tx_lpf_uv = ctx.tx_lpf_uv.ctypes.data
    dst.partition = ctx.partition.ctypes.data
    dst.pal_sz = ctx.pal_sz.ctypes.data


def _fill_mv_comp(dst: MvCompCdfC, comp):
    dst.classes = comp.classes.ctypes.data
    dst.class0_fp = comp.class0_fp.ctypes.data
    dst.classN_fp = comp.classN_fp.ctypes.data
    dst.class0_hp = comp.class0_hp.ctypes.data
    dst.classN_hp = comp.classN_hp.ctypes.data
    dst.class0 = comp.class0.ctypes.data
    dst.classN = comp.classN.ctypes.data
    dst.sign = comp.sign.ctypes.data


def fill_cdf(dst: SyCdfC, cdf):
    for name in _CDF_M_NAMES:
        src = cdf.kfym if name == "kfym" else getattr(cdf.m, name)
        setattr(dst, name, src.ctypes.data)
    dst.mv_joint = cdf.mv.joint.ctypes.data
    for i in range(2):
        _fill_mv_comp(dst.mv_comp[i], cdf.mv.comp[i])
        _fill_mv_comp(dst.dmv_comp[i], cdf.dmv.comp[i])
    for name in _COEF_NAMES:
        setattr(dst.coef, name, getattr(cdf.coef, name).ctypes.data)


def build_frame(f) -> tuple[SyFrameC, SyOutC]:
    """Build the native frame-param + output structs from the decoder's
    frame state (call after decode_frame has allocated all buffers)."""
    from ..headers import PixelLayout
    from ..tables.spec_data import DQ_TBL, SCANS

    frame_hdr = f.frame_hdr
    seq_hdr = f.seq_hdr
    sf = SyFrameC()
    sf.bw = f.bw
    sf.bh = f.bh
    sf.w4 = f.w4
    sf.h4 = f.h4
    sf.sb_shift = f.sb_shift
    sf.sb_step = f.sb_step
    sf.sb128 = 1 if seq_hdr.sb128 else 0
    sf.layout = int(f.cur.layout)
    sf.bpc = f.cur.bpc
    sf.b4_stride = f.b4_stride
    sf.sr_sb128w = f.sr_sb128w
    sf.frame_type = int(frame_hdr.frame_type)
    sf.allow_intrabc = int(frame_hdr.allow_intrabc)
    sf.frame_offset = frame_hdr.frame_offset
    sf.skip_mode_enabled = int(frame_hdr.skip_mode.enabled)
    sf.skip_mode_refs0 = frame_hdr.skip_mode.refs[0]
    sf.skip_mode_refs1 = frame_hdr.skip_mode.refs[1]
    sf.switchable_comp_refs = int(frame_hdr.switchable_comp_refs)
    sf.switchable_motion_mode = int(frame_hdr.switchable_motion_mode)
    sf.warp_motion = int(frame_hdr.warp_motion)
    sf.force_integer_mv = int(frame_hdr.force_integer_mv)
    sf.hp = int(frame_hdr.hp)
    sf.subpel_filter_mode = int(frame_hdr.subpel_filter_mode)
    sf.dual_filter = int(seq_hdr.dual_filter)
    sf.txfm_mode = int(frame_hdr.txfm_mode)
    sf.reduced_txtp_set = int(frame_hdr.reduced_txtp_set)
    sf.allow_screen_content_tools = int(frame_hdr.allow_screen_content_tools)
    sf.filter_intra = int(seq_hdr.filter_intra)
    sf.inter_intra = int(seq_hdr.inter_intra)
    sf.masked_compound = int(seq_hdr.masked_compound)
    sf.jnt_comp = int(seq_hdr.jnt_comp)
    sf.order_hint_n_bits = int(seq_hdr.order_hint_n_bits)
    sf.use_ref_frame_mvs = int(frame_hdr.use_ref_frame_mvs)
    sf.cdef_n_bits = int(frame_hdr.cdef.n_bits)
    sf.delta_q_present = int(frame_hdr.delta.q.present)
    sf.delta_q_res_log2 = int(frame_hdr.delta.q.res_log2)
    sf.delta_lf_present = int(frame_hdr.delta.lf.present)
    sf.delta_lf_res_log2 = int(frame_hdr.delta.lf.res_log2)
    sf.delta_lf_multi = int(frame_hdr.delta.lf.multi)
    sf.qidx_yac = frame_hdr.quant.yac
    sf.ydc_delta = frame_hdr.quant.ydc_delta
    sf.uac_delta = frame_hdr.quant.uac_delta
    sf.udc_delta = frame_hdr.quant.udc_delta
    sf.vac_delta = frame_hdr.quant.vac_delta
    sf.vdc_delta = frame_hdr.quant.vdc_delta
    sf.hbd = int(seq_hdr.hbd)
    segm = frame_hdr.segmentation
    sf.seg_enabled = int(segm.enabled)
    sf.seg_update_map = int(segm.update_map)
    sf.seg_temporal = int(segm.temporal)
    sf.seg_preskip = int(segm.seg_data.preskip)
    sf.seg_last_active_segid = int(segm.seg_data.last_active_segid)
    for i in range(8):
        sf.seg_lossless[i] = int(segm.lossless[i])
        sf.seg_qidx[i] = int(segm.qidx[i])
        d = segm.seg_data.d[i]
        sf.seg[i].delta_q = d.delta_q
        sf.seg[i].delta_lf_y_v = d.delta_lf_y_v
        sf.seg[i].delta_lf_y_h = d.delta_lf_y_h
        sf.seg[i].delta_lf_u = d.delta_lf_u
        sf.seg[i].delta_lf_v = d.delta_lf_v
        sf.seg[i].ref = d.ref
        sf.seg[i].skip = d.skip
        sf.seg[i].globalmv = d.globalmv
    lf = frame_hdr.loopfilter
    sf.lf_level_y[0] = lf.level_y[0]
    sf.lf_level_y[1] = lf.level_y[1]
    sf.lf_level_u = lf.level_u
    sf.lf_level_v = lf.level_v
    sf.lf_mode_ref_delta_enabled = int(lf.mode_ref_delta_enabled)
    sf.lf_mode_delta[0] = lf.mode_ref_deltas.mode_delta[0]
    sf.lf_mode_delta[1] = lf.mode_ref_deltas.mode_delta[1]
    for i in range(8):
        sf.lf_ref_delta[i] = lf.mode_ref_deltas.ref_delta[i]
    for i in range(7):
        g = frame_hdr.gmv[i]
        sf.gmv[i].type = int(g.type)
        for j in range(6):
            sf.gmv[i].matrix[j] = g.matrix[j]
        refp = f.refp[i]
        sf.refpoc[i] = (
            refp.frame_hdr.frame_offset
            if refp is not None and refp.frame_hdr is not None
            else 0
        )
        sf.svc_scale[i] = f.svc[i][0]["scale"]
    sf.dq_tbl = DQ_TBL.ctypes.data
    for tx in range(19):
        sf.scans[tx] = SCANS[tx].ctypes.data
        for pl in range(3):
            qm = f.qm[tx][pl]
            sf.qm[tx][pl] = 0 if qm is None else qm.ctypes.data
    sf.cdef_idx = f.cdef_idx.ctypes.data
    sf.cdef_stride = f.cdef_idx.shape[1]
    sf.noskip4 = f.noskip4.ctypes.data
    sf.noskip_stride = f.noskip4.shape[1]
    sf.cur_segmap = (
        f.cur_segmap.ctypes.data if f.cur_segmap is not None else 0
    )
    sf.prev_segmap = (
        f.prev_segmap.ctypes.data if f.prev_segmap is not None else 0
    )
    sf.segmap_stride = f.b4_stride
    sf.lf_level = f.lf_level.ctypes.data
    for i in range(4):
        sf.lf_cls[i] = f.lf_cls[i].ctypes.data
    sf.lf_cls_stride = f.lf_cls[0].shape[1]
    rf = f.rf
    if rf is not None:
        sf.rmv_r = rf.r.ctypes.data
        sf.rmv_r_stride = rf.r_stride
        sf.rmv_rp_proj = rf.rp_proj.ctypes.data
        sf.rmv_rp_stride = rf.rp_stride
        for i in range(7):
            sf.rmv_pocdiff[i] = rf.pocdiff[i]
            sf.rmv_sign_bias[i] = rf.sign_bias[i]
        sf.rmv_use_ref_frame_mvs = rf.use_ref_frame_mvs
        sf.rmv_iw4 = rf.iw4
        sf.rmv_ih4 = rf.ih4

    # output buffers
    out = SyOutC()
    store = f.coef_store
    out.cf = store.cf.ctypes.data
    out.eob = store.eob.ctypes.data
    out.txtp = store.txtp.ctypes.data
    out.txw = store.txw.ctypes.data
    out.txh = store.txh.ctypes.data
    out.cf_off = store.cf_off.ctypes.data
    out.txpl = store.txpl.ctypes.data
    out.txx = store.txx.ctypes.data
    out.txy = store.txy.ctypes.data
    out.cf_pos = store.cf_pos
    out.tx_pos = store.tx_pos
    n_blocks = f.bw * f.bh + 1024
    f._sy_rec = np.zeros(n_blocks, dtype=BLOCK_REC_DTYPE)
    # filter arena worst case: one inter block per 4x4 cell, 2*(w4+2)+64 B
    f._sy_filt = np.zeros(n_blocks * 80 + 4096, np.uint8)
    f._sy_pal = np.zeros(n_blocks * 24 + 64, np.uint16)
    f._sy_palidx = np.zeros(2 * f.bw * f.bh * 16 + 8192, np.uint8)
    out.rec = f._sy_rec.ctypes.data
    out.n_rec = 0
    out.rec_cap = n_blocks
    out.filt_arena = f._sy_filt.ctypes.data
    out.filt_pos = 0
    out.filt_cap = f._sy_filt.size
    out.pal_arena = f._sy_pal.ctypes.data
    out.pal_pos = 0
    out.pal_cap = f._sy_pal.size
    out.palidx_arena = f._sy_palidx.ctypes.data
    out.palidx_pos = 0
    out.palidx_cap = f._sy_palidx.size
    out.error = 0
    return sf, out


def build_tile_out(store, rec, filt, pal, palidx, b) -> SyOutC:
    """SyOutC over a tile's disjoint REGIONS of the shared store/arena
    arrays (tile-parallel syntax): the C core writes tile-local offsets,
    rebased after the join (recon/frame.py _syntax_tiles_parallel).
    b: dict of region bases/caps."""
    out = SyOutC()
    out.cf = store.cf.ctypes.data + b["cf_b"] * store.cf.itemsize
    for nm in ("eob", "txtp", "txw", "txh", "cf_off", "txpl", "txx", "txy"):
        a = getattr(store, nm)
        setattr(out, nm, a.ctypes.data + b["tx_b"] * a.itemsize)
    out.cf_pos = 0
    out.tx_pos = 0
    out.rec = rec.ctypes.data + b["rec_b"] * rec.itemsize
    out.n_rec = 0
    out.rec_cap = b["rec_cap"]
    out.filt_arena = filt.ctypes.data + b["filt_b"] * filt.itemsize
    out.filt_pos = 0
    out.filt_cap = b["filt_cap"]
    out.pal_arena = pal.ctypes.data + b["pal_b"] * pal.itemsize
    out.pal_pos = 0
    out.pal_cap = b["pal_cap"]
    out.palidx_arena = palidx.ctypes.data + b["palidx_b"] * palidx.itemsize
    out.palidx_pos = 0
    out.palidx_cap = b["palidx_cap"]
    out.error = 0
    return out


def build_tile(sf: SyFrameC, ts) -> SyTileC:
    st = SyTileC()
    st.msac = ctypes.addressof(ts.msac._s)
    fill_cdf(st.cdf, ts.cdf)
    _fill_blkctx(st.a, ts.a)
    st.col_start = ts.col_start
    st.col_end = ts.col_end
    st.row_start = ts.row_start
    st.row_end = ts.row_end
    st.tile_row = ts.tile_row
    st.tile_col = ts.tile_col
    LIB.sy_tile_init_tables(ctypes.byref(sf), ctypes.byref(st))
    return st


def build_task(t) -> SyTaskC:
    """Native task scratch; t is the Python TaskContext (numpy buffers)."""
    stk = SyTaskC()
    t.l_np = NpBlockContext(32)
    _fill_blkctx(stk.l, t.l_np)
    t.pal_sz_uv_np = np.zeros((2, 32), np.uint8)
    stk.al_pal = t.al_pal.ctypes.data
    stk.pal_sz_uv = t.pal_sz_uv_np.ctypes.data
    stk.pal = t.pal.ctypes.data
    stk.pal_idx = t.pal_idx.ctypes.data
    stk.txtp_map = t.txtp_map.ctypes.data
    stk.tl_4x4_filter = 0
    stk.wm_type = 0
    return stk


class NativeSyntaxError(ValueError):
    pass


_ERR_NAMES = {
    -1: "bad prev segid",
    -2: "intrabc mv overlaps current superblock",
    -3: "vertical partition in 4:2:2",
    -4: "work-record overflow",
    -5: "arena overflow",
}


def decode_sb(sf, st, stk, out) -> None:
    err = LIB.sy_decode_sb(
        ctypes.byref(sf), ctypes.byref(st), ctypes.byref(stk),
        ctypes.byref(out),
    )
    if err:
        raise NativeSyntaxError(_ERR_NAMES.get(err, f"native error {err}"))


def records_to_work_items(f, tile_states, start: int, end: int,
                          tx_ends=None):
    """Convert BlockRec[start:end] into WorkItem objects (the dense pass's
    input), mirroring decode.py's WorkItem/_snapshot_inter_item fields.
    Columns are batch-extracted via .tolist() (C-speed) so the per-block
    Python work is just object assembly."""
    from ..headers import WarpedMotionParams
    from ..recon.store import WorkItem
    from ..syntax.levels import Av1Block
    from ..tables.block_tables import BLOCK_DIMENSIONS

    if end <= start:
        return []
    sub = f._sy_rec[start:end]
    filt = f._sy_filt
    pal = f._sy_pal
    palidx = f._sy_palidx
    C = {name: sub[name].tolist() for name in (
        "cf_pos", "tx_pos", "afilter_off", "pal_off", "palidx_off",
        "matrix", "bx", "by", "mv", "sm_fl", "sm_uv_fl",
        "kind", "bl", "bs", "bp", "intra", "seg_id", "skip_mode", "skip",
        "y_mode", "uv_mode", "tx", "uvtx", "max_ytx", "y_angle", "uv_angle",
        "cfl_alpha0", "cfl_alpha1", "pal_sz0", "pal_sz1", "tx_split0",
        "tx_split1", "inter_mode", "drl_idx", "comp_type", "motion_mode",
        "filter2d", "ref0", "ref1", "interintra_type", "interintra_mode",
        "wedge_idx", "mask_sign", "tl_4x4_filter", "intra_edge_flags",
    )}
    wm_cols = None
    items = []
    ts = tile_states[f._sy_cur_tile]
    n = end - start
    new_b = Av1Block.__new__
    new_wi = WorkItem.__new__
    for k in range(n):
        b = new_b(Av1Block)
        b.bl = C["bl"][k]
        b.bs = C["bs"][k]
        b.bp = C["bp"][k]
        b.intra = C["intra"][k]
        b.seg_id = C["seg_id"][k]
        b.skip_mode = C["skip_mode"][k]
        b.skip = C["skip"][k]
        b.uvtx = C["uvtx"][k]
        b.y_mode = C["y_mode"][k]
        b.uv_mode = C["uv_mode"][k]
        b.tx = C["tx"][k]
        b.pal_sz = [C["pal_sz0"][k], C["pal_sz1"][k]]
        b.y_angle = C["y_angle"][k]
        b.uv_angle = C["uv_angle"][k]
        b.cfl_alpha = [C["cfl_alpha0"][k], C["cfl_alpha1"][k]]
        b.mv = C["mv"][k]
        b.wedge_idx = C["wedge_idx"][k]
        b.mask_sign = C["mask_sign"][k]
        b.interintra_mode = C["interintra_mode"][k]
        b.mv2d = (0, 0)
        b.matrix = C["matrix"][k]
        b.comp_type = C["comp_type"][k]
        b.inter_mode = C["inter_mode"][k]
        b.motion_mode = C["motion_mode"][k]
        b.drl_idx = C["drl_idx"][k]
        b.ref = [C["ref0"][k], C["ref1"][k]]
        b.max_ytx = C["max_ytx"][k]
        b.filter2d = C["filter2d"][k]
        b.interintra_type = C["interintra_type"][k]
        b.tx_split0 = C["tx_split0"][k]
        b.tx_split1 = C["tx_split1"][k]

        wi = new_wi(WorkItem)
        wi.kind = "intra" if C["kind"][k] == 0 else "inter"
        wi.bx = C["bx"][k]
        wi.by = C["by"][k]
        wi.bs = b.bs
        wi.b = b
        wi.ts = ts
        wi.intra_edge_flags = C["intra_edge_flags"][k]
        wi.sm_fl = C["sm_fl"][k]
        wi.sm_uv_fl = C["sm_uv_fl"][k]
        wi.pal = None
        wi.pal_idx = None
        wi.warpmv = None
        wi.tl_4x4_filter = C["tl_4x4_filter"][k]
        wi.a_filter = None
        wi.l_filter = None
        wi.tx_pos = C["tx_pos"][k]
        wi.cf_pos = C["cf_pos"][k]
        wi.tx_end = None if tx_ends is None else tx_ends[k]

        po = C["pal_off"][k]
        if po >= 0:
            wi.pal = pal[po : po + 24].reshape(3, 8).copy()
            pio = C["palidx_off"][k]
            bd = BLOCK_DIMENSIONS[b.bs]
            nn = 2 * bd[0] * bd[1] * 16
            wi.pal_idx = palidx[pio : pio + nn].copy()

        ao = C["afilter_off"][k]
        if ao >= 0:
            bw4 = BLOCK_DIMENSIONS[b.bs][0]
            w4 = min(bw4, f.bw - wi.bx)
            alen = w4 + 2
            wi.a_filter = (
                filt[ao : ao + alen],
                filt[ao + alen : ao + 2 * alen],
            )
            wi.l_filter = (
                filt[ao + 2 * alen : ao + 2 * alen + 32],
                filt[ao + 2 * alen + 32 : ao + 2 * alen + 64],
            )

        if b.motion_mode == 2:  # MM_WARP
            if wm_cols is None:
                wm_cols = {nm: sub[nm].tolist() for nm in (
                    "wm_type", "wm_mat", "wm_alpha", "wm_beta", "wm_gamma",
                    "wm_delta")}
            wm = WarpedMotionParams()
            wm.type = wm_cols["wm_type"][k]
            wm.matrix = wm_cols["wm_mat"][k]
            wm.alpha = wm_cols["wm_alpha"][k]
            wm.beta = wm_cols["wm_beta"][k]
            wm.gamma = wm_cols["wm_gamma"][k]
            wm.delta = wm_cols["wm_delta"][k]
            wi.warpmv = wm

        items.append(wi)
    return items


def _tmvs_call(rf, col_start8, col_end8, row_start8, row_end8) -> TmvsCallC:
    from ..syntax.refmvs import _bdims_np

    p = TmvsCallC()
    p.r = rf.r.ctypes.data
    p.r_stride = rf.r_stride
    p.rp = rf.rp.ctypes.data
    p.rp_stride = rf.rp.shape[1]
    p.rp_proj = rf.rp_proj.ctypes.data
    p.proj_stride = rf.rp_stride
    for i in range(7):
        ref = rf.rp_ref[i]
        p.rp_ref[i] = 0 if ref is None else ref.ctypes.data
        p.rp_ref_stride[i] = 0 if ref is None else ref.shape[1]
        p.mfmv_sign[i] = rf.mfmv_sign[i]
    for n in range(3):
        p.mfmv_ref[n] = rf.mfmv_ref[n]
        p.mfmv_ref2cur[n] = rf.mfmv_ref2cur[n]
        for m in range(7):
            p.mfmv_ref2ref[n][m] = rf.mfmv_ref2ref[n][m]
    p.n_mfmvs = rf.n_mfmvs
    p.iw8 = rf.iw8
    p.ih8 = rf.ih8
    p.col_start8 = col_start8
    p.col_end8 = col_end8
    p.row_start8 = row_start8
    p.row_end8 = row_end8
    p.bdims = _bdims_np().ctypes.data
    return p


def save_tmvs(rf, col_start8, col_end8, row_start8, row_end8):
    p = _tmvs_call(rf, col_start8, col_end8, row_start8, row_end8)
    LIB.sy_save_tmvs(ctypes.byref(p))


def load_tmvs(rf, col_start8, col_end8, row_start8, row_end8):
    p = _tmvs_call(rf, col_start8, col_end8, row_start8, row_end8)
    LIB.sy_load_tmvs(ctypes.byref(p))
