"""Adaptive CDF contexts.

Behavior parity: src/cdf.rs — CdfContext (mode/kfym/coef/mv/dmv groups),
rav1d_cdf_thread_init_static (qindex-category defaults), and
rav1d_cdf_thread_update (post-tile refresh: copy probs, zero counters).

Storage convention: each CDF is a mutable Python list of u16 where
list[i] = (32768 - spec_cdf[i]) & 0x7fff and the adaptation counter lives at
list[n_symbols] (which doubles as the terminal zero since counter <= 32 and
msac shifts by EC_PROB_SHIFT=6). Default tables are AV1-spec normative data
loaded from tables/default_cdf.npz (see tools_py/extract_cdf_tables.py).
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "..", "tables", "default_cdf.npz")

N_INTRA_PRED_MODES = 13
N_UV_INTRA_PRED_MODES = 14
N_COMP_INTER_PRED_MODES = 8
N_TX_SIZES = 5
N_MV_JOINTS = 4
N_BS = 22  # BlockSize::COUNT
N_BL = 5  # BlockLevel::COUNT
MAX_SEGMENTS = 8
N_SWITCHABLE_FILTERS = 3

# partition symbol count per block level (dav1d_partition_type_count):
# levels 128..16 have 10 partition types (9 probs), 8x8 has 4 (3 probs).
PARTITION_TYPE_COUNT = [7, 9, 9, 9, 3]  # [COUNT-3, COUNT-1 x3, N_SUB8X8-1]


def _load_defaults():
    data = np.load(_NPZ)
    return {k: data[k] for k in data.files}


_DEFAULTS = _load_defaults()


def _to_lists(arr: np.ndarray, pad: int = 1):
    """Pad the innermost axis of a CDF table by `pad` zero slots (adaptation
    counter headroom) and return a C-contiguous uint16 array. Contiguity
    makes every row directly addressable from the native core (ctypes)."""
    padded = np.zeros(arr.shape[:-1] + (arr.shape[-1] + pad,), dtype=np.uint16)
    padded[..., : arr.shape[-1]] = arr
    return padded


def _clone(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    return [_clone(x) for x in v]


class _Group(SimpleNamespace):
    def clone(self):
        g = _Group()
        for k, v in self.__dict__.items():
            g.__dict__[k] = _clone(v)
        return g


def _mv_component_template():
    c = _Group()
    c.classes = _to_lists(_DEFAULTS["mv_comp.classes"])
    c.class0_fp = _to_lists(_DEFAULTS["mv_comp.class0_fp"])
    c.classN_fp = _to_lists(_DEFAULTS["mv_comp.classN_fp"])
    c.class0_hp = _to_lists(_DEFAULTS["mv_comp.class0_hp"])
    c.classN_hp = _to_lists(_DEFAULTS["mv_comp.classN_hp"])
    c.class0 = _to_lists(_DEFAULTS["mv_comp.class0"])
    c.classN = _to_lists(_DEFAULTS["mv_comp.classN"])
    c.sign = _to_lists(_DEFAULTS["mv_comp.sign"])
    return c


def get_qcat_idx(q: int) -> int:
    if q <= 20:
        return 0
    if q <= 60:
        return 1
    if q <= 120:
        return 2
    return 3


class CdfContext:
    """All adaptive symbol contexts for one tile/frame."""

    __slots__ = ("m", "kfym", "coef", "mv", "dmv")

    def __init__(self, m, kfym, coef, mv, dmv):
        self.m = m
        self.kfym = kfym
        self.coef = coef
        self.mv = mv
        self.dmv = dmv

    @classmethod
    def from_qindex(cls, qidx: int) -> "CdfContext":
        qcat = get_qcat_idx(qidx)
        m = _Group()
        for key, arr in _DEFAULTS.items():
            if key.startswith("m."):
                setattr(m, key[2:], _to_lists(arr))
        kfym = _to_lists(_DEFAULTS["kfym"])
        coef = _Group()
        for key, arr in _DEFAULTS.items():
            if key.startswith(f"coef{qcat}."):
                setattr(coef, key.split(".", 1)[1], _to_lists(arr))
        mv = _Group(
            joint=_to_lists(_DEFAULTS["mv_joint"]),
            comp=[_mv_component_template(), _mv_component_template()],
        )
        dmv = _Group(
            joint=_to_lists(_DEFAULTS["mv_joint"]),
            comp=[_mv_component_template(), _mv_component_template()],
        )
        return cls(m, kfym, coef, mv, dmv)

    def clone(self) -> "CdfContext":
        mv = _Group(
            joint=_clone(self.mv.joint),
            comp=[self.mv.comp[0].clone(), self.mv.comp[1].clone()],
        )
        dmv = _Group(
            joint=_clone(self.dmv.joint),
            comp=[self.dmv.comp[0].clone(), self.dmv.comp[1].clone()],
        )
        return CdfContext(
            self.m.clone(), _clone(self.kfym), self.coef.clone(), mv, dmv
        )

    # -- post-tile refresh (rav1d_cdf_thread_update, src/cdf.rs:4906) -------

    def updated(self, frame_hdr, in_cdf) -> "CdfContext":
        """Post-frame CDF refresh (rav1d_cdf_thread_update, src/cdf.rs:4906).

        The refreshed context starts from the frame's INPUT cdf (decode.c:3162
        dav1d_cdf_thread_copy(out, in)); only the listed tables are copied
        from the tile state, with their adaptation counters zeroed. Tables
        outside the list (e.g. mv.joint adapted via intrabc on intra frames)
        revert to their pre-frame values.
        """
        dst = in_cdf.clone()
        m, coef = dst.m, dst.coef
        sm, scoef = self.m, self.coef

        def cdf1(dl, sl, n):
            dl[:] = sl[:]
            dl[n] = 0

        def cdf2(dls, sls, n):
            for dl, sl in zip(dls, sls):
                dl[:] = sl[:]
                dl[n] = 0

        def cdf3(dls, sls, n):
            for d2, s2 in zip(dls, sls):
                cdf2(d2, s2, n)

        def cdf4(dls, sls, n):
            for d3, s3 in zip(dls, sls):
                cdf3(d3, s3, n)

        def bit0(dl, sl):
            dl[:] = sl[:]
            dl[1] = 0

        def bit1(dls, sls):
            for dl, sl in zip(dls, sls):
                dl[:] = sl[:]
                dl[1] = 0

        def bit2(dls, sls):
            for d2, s2 in zip(dls, sls):
                bit1(d2, s2)

        def bit3(dls, sls):
            for d3, s3 in zip(dls, sls):
                bit2(d3, s3)

        bit1(m.use_filter_intra, sm.use_filter_intra)
        cdf1(m.filter_intra, sm.filter_intra, 4)
        for k in range(2):
            cdf2(m.uv_mode[k], sm.uv_mode[k], N_UV_INTRA_PRED_MODES - 1 - (1 if k == 0 else 0))
        cdf2(m.angle_delta, sm.angle_delta, 6)
        for k in range(N_TX_SIZES - 1):
            cdf2(m.txsz[k], sm.txsz[k], min(k + 1, 2))
        cdf3(m.txtp_intra1, sm.txtp_intra1, 6)
        cdf3(m.txtp_intra2, sm.txtp_intra2, 4)
        bit1(m.skip, sm.skip)
        for k in range(N_BL):
            cdf2(m.partition[k], sm.partition[k], PARTITION_TYPE_COUNT[k])
        bit2(coef.skip, scoef.skip)
        cdf3(coef.eob_bin_16, scoef.eob_bin_16, 4)
        cdf3(coef.eob_bin_32, scoef.eob_bin_32, 5)
        cdf3(coef.eob_bin_64, scoef.eob_bin_64, 6)
        cdf3(coef.eob_bin_128, scoef.eob_bin_128, 7)
        cdf3(coef.eob_bin_256, scoef.eob_bin_256, 8)
        cdf2(coef.eob_bin_512, scoef.eob_bin_512, 9)
        cdf2(coef.eob_bin_1024, scoef.eob_bin_1024, 10)
        bit3(coef.eob_hi_bit, scoef.eob_hi_bit)
        cdf4(coef.eob_base_tok, scoef.eob_base_tok, 2)
        cdf4(coef.base_tok, scoef.base_tok, 3)
        bit2(coef.dc_sign, scoef.dc_sign)
        cdf4(coef.br_tok, scoef.br_tok, 3)
        cdf2(m.seg_id, sm.seg_id, MAX_SEGMENTS - 1)
        cdf1(m.cfl_sign, sm.cfl_sign, 7)
        cdf2(m.cfl_alpha, sm.cfl_alpha, 15)
        bit0(m.restore_wiener, sm.restore_wiener)
        bit0(m.restore_sgrproj, sm.restore_sgrproj)
        cdf1(m.restore_switchable, sm.restore_switchable, 2)
        cdf1(m.delta_q, sm.delta_q, 3)
        cdf2(m.delta_lf, sm.delta_lf, 3)
        bit2(m.pal_y, sm.pal_y)
        bit1(m.pal_uv, sm.pal_uv)
        cdf3(m.pal_sz, sm.pal_sz, 6)
        for l in range(2):
            for k in range(7):
                cdf2(m.color_map[l][k], sm.color_map[l][k], k + 1)
        bit2(m.txpart, sm.txpart)
        cdf2(m.txtp_inter1, sm.txtp_inter1, 15)
        cdf1(m.txtp_inter2, sm.txtp_inter2, 11)
        bit1(m.txtp_inter3, sm.txtp_inter3)

        if frame_hdr.frame_type.is_key_or_intra:
            bit0(m.intrabc, sm.intrabc)
            cdf1(dst.dmv.joint, self.dmv.joint, N_MV_JOINTS - 1)
            for k in range(2):
                cdf1(dst.dmv.comp[k].classes, self.dmv.comp[k].classes, 10)
                bit0(dst.dmv.comp[k].class0, self.dmv.comp[k].class0)
                bit1(dst.dmv.comp[k].classN, self.dmv.comp[k].classN)
                bit0(dst.dmv.comp[k].sign, self.dmv.comp[k].sign)
            return dst

        bit1(m.skip_mode, sm.skip_mode)
        cdf2(m.y_mode, sm.y_mode, N_INTRA_PRED_MODES - 1)
        cdf3(m.filter, sm.filter, N_SWITCHABLE_FILTERS - 1)
        bit1(m.newmv_mode, sm.newmv_mode)
        bit1(m.globalmv_mode, sm.globalmv_mode)
        bit1(m.refmv_mode, sm.refmv_mode)
        bit1(m.drl_bit, sm.drl_bit)
        cdf2(m.comp_inter_mode, sm.comp_inter_mode, N_COMP_INTER_PRED_MODES - 1)
        bit1(m.intra, sm.intra)
        bit1(m.comp, sm.comp)
        bit1(m.comp_dir, sm.comp_dir)
        bit1(m.jnt_comp, sm.jnt_comp)
        bit1(m.mask_comp, sm.mask_comp)
        bit1(m.wedge_comp, sm.wedge_comp)
        cdf2(m.wedge_idx, sm.wedge_idx, 15)
        bit2(m.ref, sm.ref)
        bit2(m.comp_fwd_ref, sm.comp_fwd_ref)
        bit2(m.comp_bwd_ref, sm.comp_bwd_ref)
        bit2(m.comp_uni_ref, sm.comp_uni_ref)
        bit1(m.seg_pred, sm.seg_pred)
        bit1(m.interintra, sm.interintra)
        bit1(m.interintra_wedge, sm.interintra_wedge)
        cdf2(m.interintra_mode, sm.interintra_mode, 3)
        cdf2(m.motion_mode, sm.motion_mode, 2)
        bit1(m.obmc, sm.obmc)

        cdf1(dst.mv.joint, self.mv.joint, N_MV_JOINTS - 1)
        for k in range(2):
            c = dst.mv.comp[k]
            sc = self.mv.comp[k]
            cdf1(c.classes, sc.classes, 10)
            bit0(c.class0, sc.class0)
            bit1(c.classN, sc.classN)
            cdf2(c.class0_fp, sc.class0_fp, 3)
            cdf1(c.classN_fp, sc.classN_fp, 3)
            bit0(c.class0_hp, sc.class0_hp)
            bit0(c.classN_hp, sc.classN_hp)
            bit0(c.sign, sc.sign)
        return dst
