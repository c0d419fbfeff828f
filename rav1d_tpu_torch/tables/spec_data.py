"""Loader for the extracted AV1 numeric normative tables (spec_tables.npz).

See tools_py/extract_spec_tables.py for provenance. Exposes:
- SCANS[rtx]: coefficient scan order per rectangular tx size (src/scan.rs)
- DQ_TBL[bitdepth_idx][qidx] = (dc_q, ac_q) (src/dequant_tables.rs)
- DSP filter coefficient tables (src/tables.rs)
"""

from __future__ import annotations

import os

import numpy as np

_NPZ = np.load(os.path.join(os.path.dirname(__file__), "spec_tables.npz"))

# scan per RectTxfmSize (order mirrors dav1d_scans, src/scan.rs:204):
# square 4..64 (64 reuses 32x32 since coefs beyond 32x32 are zeroed), then
# rect sizes in RTX_* order.
_S = {k: _NPZ[k] for k in _NPZ.files if k.startswith("scan_")}
SCANS = [
    _S["scan_4x4"],
    _S["scan_8x8"],
    _S["scan_16x16"],
    _S["scan_32x32"],
    _S["scan_32x32"],  # TX_64X64
    _S["scan_4x8"],
    _S["scan_8x4"],
    _S["scan_8x16"],
    _S["scan_16x8"],
    _S["scan_16x32"],
    _S["scan_32x16"],
    _S["scan_32x32"],  # RTX_32X64
    _S["scan_32x32"],  # RTX_64X32
    _S["scan_4x16"],
    _S["scan_16x4"],
    _S["scan_8x32"],
    _S["scan_32x8"],
    _S["scan_16x32"],  # RTX_16X64
    _S["scan_32x16"],  # RTX_64X16
]

DQ_TBL = _NPZ["dq_tbl"]  # [3][256][2] — bitdepth (8/10/12), qidx, (dc, ac)

MC_SUBPEL_FILTERS = _NPZ["mc_subpel_filters"].astype(np.int32)  # [6][15][8]
MC_WARP_FILTER = _NPZ["mc_warp_filter"].astype(np.int32)  # [193][8]
RESIZE_FILTER = _NPZ["resize_filter"].astype(np.int32)  # [64][8]
SM_WEIGHTS = _NPZ["sm_weights"].astype(np.int32)  # [128]
DR_INTRA_DERIVATIVE = _NPZ["dr_intra_derivative"].astype(np.int32)  # [44]
FILTER_INTRA_TAPS = _NPZ["filter_intra_taps"].astype(np.int32)  # [5][8][7]
OBMC_MASKS = _NPZ["obmc_masks"].astype(np.int32)  # [64]
GAUSSIAN_SEQUENCE = _NPZ["gaussian_sequence"].astype(np.int32)  # [2048]
SGR_PARAMS = _NPZ["sgr_params"].astype(np.int32)  # [16][2]
SGR_X_BY_X = _NPZ["sgr_x_by_x"].astype(np.int32)  # [256]
CDEF_DIRECTIONS = _NPZ["cdef_directions"].astype(np.int32)  # [12][2]
