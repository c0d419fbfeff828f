"""The itx kernel's wrapper: batched 2-D inverse transforms, nine classes.

`itx(cb, firstv, secondv, w, h, bpc)` is the port's counterpart of
rav1d_tpu/ops/pallas/itx_all.py itx_pallas_core. For a CUDA tensor it
launches the hand-written kernel csrc/itx.cu (built at first use) on the
current stream, or raises; for a CPU tensor it runs the kernel's plain
version, engine/kernels.itx_any_core. There is no fallback from the card
to the plain version. `launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...engine.kernels import itx_any_core
from ...engine.layout import KERNEL_SIZES
from . import build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None


def lib():
    """Build (at first use) and load the kernel library (csrc/itx.cu: the
    itx kernel and the 8x8 DCT_DCT kernel of ops/itx8.py); the handle and
    its entry points' signatures are set up once."""
    global _LIB
    if _LIB is None:
        so = build.build("itx", "itx.cu", deps=("itx_1d.cuh",))
        so.rav1d_itx.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
        so.rav1d_itx.restype = _I
        so.rav1d_idct8x8.argtypes = [_P, _P, _I, _I, _P]
        so.rav1d_idct8x8.restype = _I
        _LIB = so
    return _LIB


def itx(cb, firstv, secondv, w, h, bpc):
    """cb: (N, h, w) int32 natural-order coefficients; firstv/secondv: (N,)
    int32 variant codes. Returns (N, h, w) int32 residuals."""
    global launches
    if (w, h) not in KERNEL_SIZES:
        raise ValueError(f"itx kernel covers {sorted(KERNEL_SIZES)}, not {(w, h)}")
    if cb.device.type == "cpu":
        return itx_any_core(cb, firstv, secondv, w, h, bpc)
    if cb.device.type != "cuda":
        raise ValueError(f"itx: unsupported device {cb.device}")
    n = cb.shape[0]
    if cb.dtype != torch.int32 or tuple(cb.shape[1:]) != (h, w):
        raise ValueError(f"itx: cb must be int32 (N, {h}, {w}), got "
                         f"{cb.dtype} {tuple(cb.shape)}")
    for t in (firstv, secondv):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) or t.device != cb.device:
            raise ValueError("itx: codes must be int32 (N,) on cb's device")
    if bpc not in (8, 10, 12):
        raise ValueError(f"itx: bpc {bpc}")
    cb = cb.contiguous()
    firstv = firstv.contiguous()
    secondv = secondv.contiguous()
    out = torch.empty_like(cb)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(cb.device).cuda_stream
    rc = lib().rav1d_itx(cb.data_ptr(), firstv.data_ptr(), secondv.data_ptr(),
                       out.data_ptr(), n, w, h, bpc, stream)
    if rc != 0:
        raise RuntimeError(f"itx kernel launch failed: cuda error {rc}")
    launches += 1
    return out
