"""Plain-torch inverse transforms of the device engine.

`itx_any_core` is the torch twin of rav1d_tpu/engine/kernels.py
itx_any_core: a batch of blocks with per-block tx types, every 1-D variant
the size allows computed and selected per block. `wht_core` is the
lossless 4x4 Walsh-Hadamard. Both are the plain versions of the
hand-written itx kernel (ops/cuda/itx.py), which runs every size on the
card; `calls` counts their calls, so a run can show that the card's
residual stage made none.
"""

from __future__ import annotations

import torch

from ..ops.itx import Lanes, apply_1d
from ..ops.ref import itx as R
from .layout import _VCODE, variants_for

calls = 0


def _clips(bpc):
    if bpc == 8:
        rmn = cmn = -(1 << 15)
    else:
        bmax = (1 << bpc) - 1
        rmn = (~bmax) << 7
        cmn = (~bmax) << 5
    return rmn, ~rmn, cmn, ~cmn


def _sel_pass(vals_in, variants, codes, n, mn, mx):
    """Run every 1-D variant over the lane list and select per batch lane.
    vals_in: list of n tensors (N, L); codes: (N,) variant codes."""
    outs = []
    for name in variants:
        lanes = Lanes(list(vals_in))
        apply_1d(name, n, lanes, mn, mx)
        outs.append([lanes.vals[i] for i in range(n)])
    if len(variants) == 1:
        return outs[0]
    sel = []
    c = codes[:, None]
    for i in range(n):
        v = outs[0][i]
        for k, name in enumerate(variants[1:], start=1):
            v = torch.where(c == _VCODE[name], outs[k][i], v)
        sel.append(v)
    return sel


def itx_any_core(cb, firstv, secondv, w, h, bpc):
    """cb: (N, min(h,32), min(w,32)) int32 coefficients in natural (y, x)
    order; firstv/secondv: (N,) variant codes. Returns (N, h, w) int32
    residuals, bit-exact with the JAX engine's itx_any_core."""
    global calls
    calls += 1
    shift = R._SHIFTS[(w, h)]
    is_rect2 = w * 2 == h or h * 2 == w
    rnd = (1 << shift) >> 1
    sh = min(h, 32)
    sw = min(w, 32)
    row_clip_min, row_clip_max, col_clip_min, col_clip_max = _clips(bpc)

    cb = cb.to(torch.int32)
    if is_rect2:
        cb = (cb * 181 + 128) >> 8

    zeros = cb.new_zeros((cb.shape[0], sh))
    vals = [cb[:, :, x] if x < sw else zeros for x in range(w)]
    vals = _sel_pass(vals, variants_for(w), firstv, w,
                     row_clip_min, row_clip_max)
    mid = torch.stack(vals, dim=2)  # (N, sh, w)
    mid = ((mid + rnd) >> shift).clip(col_clip_min, col_clip_max)

    zeros2 = cb.new_zeros((cb.shape[0], w))
    vals = [mid[:, y, :] if y < sh else zeros2 for y in range(h)]
    vals = _sel_pass(vals, variants_for(h), secondv, h,
                     col_clip_min, col_clip_max)
    res = torch.stack(vals, dim=1)  # (N, h, w)
    return (res + 8) >> 4


def wht_core(cb):
    """4x4 Walsh-Hadamard (lossless; src/itx_1d.rs inv_wht4_1d).
    cb: (N, 4, 4) int32. Returns (N, 4, 4) int32 residuals."""
    global calls
    calls += 1
    t = cb >> 2

    def wht4(l0, l1, l2, l3):
        t0 = l0 + l1
        t2 = l2 - l3
        t4 = (t0 - t2) >> 1
        t3 = t4 - l3
        t1 = t4 - l1
        return t0 - t3, t3, t1, t2 + t1

    r = wht4(*[t[:, :, i] for i in range(4)])
    m = torch.stack(r, dim=2)
    c = wht4(*[m[:, i, :] for i in range(4)])
    return torch.stack(c, dim=1)
