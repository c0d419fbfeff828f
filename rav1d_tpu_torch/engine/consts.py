"""The decoder's constant tables as device tensors, made once per device.

These play the part of a model's weights: the same numpy tables the JAX
package reads (rav1d_tpu/tables/spec_data.py and the small tables of its
ops), turned into int32 tensors on the device the port runs on, so both
packages compute from the same numbers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.ref.mc import FILTER_DIR
from ..tables.spec_data import (
    DR_INTRA_DERIVATIVE,
    FILTER_INTRA_TAPS,
    MC_SUBPEL_FILTERS,
    MC_WARP_FILTER,
    RESIZE_FILTER,
    SGR_X_BY_X,
    SM_WEIGHTS,
)

_CTZ = np.zeros(257, np.int32)
for _i in range(1, 257):
    _CTZ[_i] = (_i & -_i).bit_length() - 1


def numpy_tables():
    return {
        "ctz": _CTZ,
        "edge_kernels": np.asarray(
            [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]], np.int32),
        "dr_intra_derivative": np.asarray(DR_INTRA_DERIVATIVE, np.int32),
        "sm_weights": np.asarray(SM_WEIGHTS, np.int32),
        "filter_intra_taps": np.asarray(FILTER_INTRA_TAPS, np.int32),
        "sgr_x_by_x": np.asarray(SGR_X_BY_X, np.int32),
        # chroma CDEF direction remap, 4:2:0/4:4:4 row then 4:2:2 row
        "uv_dirs": np.asarray(
            [[0, 1, 2, 3, 4, 5, 6, 7], [7, 0, 2, 4, 5, 6, 6, 6]], np.int32),
        # inter: 8-tap subpel filters (6, 15, 8), warp filters (193, 8),
        # the (h, v) filter types of each 2-D filter code
        "mc_subpel_filters": np.asarray(MC_SUBPEL_FILTERS, np.int32),
        "mc_warp_filter": np.asarray(MC_WARP_FILTER, np.int32),
        "filter_dir": np.asarray(FILTER_DIR, np.int32),
        # superres: the 8-tap upscale filters of each 1/64 phase (64, 8)
        "resize_filter": np.asarray(RESIZE_FILTER, np.int32),
    }


@functools.lru_cache(maxsize=None)
def _tables(device_str):
    dev = torch.device(device_str)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in numpy_tables().items()}


def tables(device):
    """dict of int32 tensors on `device` (cached per device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _tables(str(device))
