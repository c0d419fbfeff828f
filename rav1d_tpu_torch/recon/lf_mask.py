"""Loopfilter level derivation (parity: src/lf_mask.rs rav1d_calc_lf_values,
rav1d_calc_eih). Deblock mask/application machinery lands in recon/lf.py.
"""

from __future__ import annotations


def _iclip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def _calc_lf_value(base_lvl, lf_delta, seg_delta, mr_delta):
    """Returns [8][2] levels per (ref, mode) (src/lf_mask.rs:628)."""
    base = _iclip(_iclip(base_lvl + lf_delta, 0, 63) + seg_delta, 0, 63)
    out = [[0, 0] for _ in range(8)]
    if mr_delta is not None:
        sh = 1 if base >= 32 else 0
        v = _iclip(base + mr_delta.ref_delta[0] * (1 << sh), 0, 63)
        out[0] = [v, v]
        for r in range(1, 8):
            for m in range(2):
                delta = mr_delta.mode_delta[m] + mr_delta.ref_delta[r]
                out[r][m] = _iclip(base + delta * (1 << sh), 0, 63)
    else:
        for r in range(8):
            out[r] = [base, base]
    return out


def _calc_lf_value_chroma(base_lvl, lf_delta, seg_delta, mr_delta):
    if base_lvl == 0:
        return [[0, 0] for _ in range(8)]
    return _calc_lf_value(base_lvl, lf_delta, seg_delta, mr_delta)


def calc_lf_values(hdr, lf_delta):
    """Returns [8 segs][4 planes][8 refs][2 modes] levels (src/lf_mask.rs:670)."""
    n_seg = 8 if hdr.segmentation.enabled else 1
    out = [
        [[[0, 0] for _ in range(8)] for _ in range(4)] for _ in range(8)
    ]
    if hdr.loopfilter.level_y[0] == 0 and hdr.loopfilter.level_y[1] == 0:
        return out
    mr = (
        hdr.loopfilter.mode_ref_deltas
        if hdr.loopfilter.mode_ref_delta_enabled
        else None
    )
    multi = hdr.delta.lf.multi
    for s in range(n_seg):
        segd = hdr.segmentation.seg_data.d[s] if hdr.segmentation.enabled else None
        out[s][0] = _calc_lf_value(
            hdr.loopfilter.level_y[0],
            lf_delta[0],
            segd.delta_lf_y_v if segd else 0,
            mr,
        )
        out[s][1] = _calc_lf_value(
            hdr.loopfilter.level_y[1],
            lf_delta[1 if multi else 0],
            segd.delta_lf_y_h if segd else 0,
            mr,
        )
        out[s][2] = _calc_lf_value_chroma(
            hdr.loopfilter.level_u,
            lf_delta[2 if multi else 0],
            segd.delta_lf_u if segd else 0,
            mr,
        )
        out[s][3] = _calc_lf_value_chroma(
            hdr.loopfilter.level_v,
            lf_delta[3 if multi else 0],
            segd.delta_lf_v if segd else 0,
            mr,
        )
    return out
