"""The itx kernel's wrappers: every inverse transform of a frame in one
launch, and the per-size entry points over the same kernel.

`itx_frame(dev, hdr, tx_valid, ra, aw, bpc)` transforms every coefficient
block of a packed frame blob into the residual buffer `ra` with one launch
of the hand-written kernel csrc/itx.cu rav1d_itx_frame (built at first
use): all 19 tx sizes and the lossless WHT, read from the blob's
descriptor regions and coefficients, written to `ra` with out-of-range
destinations dropped. Its plain version is engine/programs.resid_plain.

`itx(cb, firstv, secondv, w, h, bpc)` (any of the 19 sizes; the port's
counterpart of rav1d_tpu/ops/pallas/itx_all.py itx_pallas_core) and
`wht(cb)` run the same kernel with a one-class table over a contiguous
batch; their plain versions are engine/kernels.itx_any_core and wht_core.

For a CUDA tensor each wrapper launches the kernel on the current stream
or raises; `itx` and `wht` run their plain version for a CPU tensor, and
`itx_frame` takes CUDA tensors only (engine/programs.resid runs the plain
version on the CPU). There is no fallback from the card to a plain
version. `launches` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...engine.kernels import itx_any_core, wht_core
from ...engine.layout import CF0, R0, SIZES, WHT0, WHT_B, chunk_for
from . import build

launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LIB = None
I32 = torch.int32
BPCS = (8, 10, 12)


def lib():
    """Build (at first use) and load the kernel library (csrc/itx.cu: the
    frame kernel and the 8x8 DCT_DCT kernel of ops/itx8.py); the handle and
    its entry points' signatures are set up once."""
    global _LIB
    if _LIB is None:
        so = build.build("itx", "itx.cu", deps=("itx_1d.cuh",))
        so.rav1d_itx_frame.argtypes = [_P, _P, _P] + [_I] * 7 + [_P, _I, _P]
        so.rav1d_itx_frame.restype = _I
        so.rav1d_idct8x8.argtypes = [_P, _P, _I, _I, _P]
        so.rav1d_idct8x8.restype = _I
        _LIB = so
    return _LIB


def frame_table(hdr, tx_valid, blob_len):
    """The kernel's class table for a packed frame: (ncls, 4) int32 rows of
    (w * 100 + h or 0 for the WHT, filled lanes, descriptor region base, lanes
    per chunk), in the order of engine/layout.SIZES then the WHT, for the
    classes with filled lanes. Each region must lie inside the blob."""
    rows = []
    regions = [(w * 100 + h, R0 + 2 * si, 4, chunk_for(w, h), si)
               for si, (w, h) in enumerate(SIZES)]
    regions.append((0, WHT0, 2, WHT_B, "wht"))
    for wh, reg, nrows, B, key in regions:
        nc = int(hdr[reg + 1])
        n = tx_valid.get(key, 0)
        if not nc or not n:
            continue
        base = int(hdr[reg])
        if not (0 <= base and base + nc * nrows * B <= blob_len and n <= nc * B):
            raise ValueError(f"itx_frame: class {wh} region ({base}, {nc}) "
                             f"does not fit a blob of {blob_len} words")
        rows.append((wh, n, base, B))
    return np.asarray(rows, np.int32).reshape(-1, 4)


def frame_args(dev, hdr, tx_valid, ra, aw, bpc):
    """rav1d_itx_frame's arguments, before the stream, for a frame: the blob
    `dev` as descriptors and coefficients (int16 pairs at 8 bpc, each
    block column by column), the residual buffer `ra` with row pitch aw,
    and frame_table's rows."""
    table = frame_table(hdr, tx_valid, dev.numel())
    return (dev, dev, ra, dev.numel(), int(hdr[CF0]), ra.numel(), aw,
            int(bpc == 8), 1, bpc, table)


def batch_args(cb, codes, out, w, h, bpc):
    """rav1d_itx_frame's arguments, before the stream, for a contiguous
    batch: cb (N, min(h,32), min(w,32)) int32 row-major, residual i at
    out[i * w * h] with row pitch w. codes: [firstv, secondv], or [] for
    the WHT."""
    n = cb.shape[0]
    i = torch.arange(n, dtype=I32, device=cb.device)
    m = min(h, 32) * min(w, 32)
    desc = torch.stack([i * m, i * (w * h)] + list(codes)).contiguous()
    table = np.asarray([[w * 100 + h if codes else 0, n, 0, n]], np.int32)
    return (desc, cb, out, cb.numel(), 0, out.numel(), w, 0, 0, bpc, table)


def c_args(args):
    """The ctypes values of frame_args' or batch_args' tuple (tensors and
    the table as addresses; the tuple must outlive the call)."""
    desc, coef, out, *ints, table = args
    return [desc.data_ptr(), coef.data_ptr(), out.data_ptr(), *ints,
            table.ctypes.data, len(table)]


def _launch(args):
    """One launch of the kernel over `args` on the current stream of the
    output's device (none for an empty table)."""
    global launches
    desc, coef, out, *_, table = args
    if not len(table):
        return
    for t in (desc, coef):
        if t.device != out.device or t.dtype != I32 or not t.is_contiguous():
            raise ValueError("itx kernel: buffers must be contiguous int32 "
                             "tensors on one CUDA device")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = lib().rav1d_itx_frame(*c_args(args), stream)
    if rc != 0:
        raise RuntimeError(f"itx kernel launch failed: error {rc}")
    launches += 1


def itx_frame(dev, hdr, tx_valid, ra, aw, bpc):
    """Transform every coefficient block of the frame blob `dev` (int32, on
    the card) into `ra` ((6*psz,) int32, written where blocks land, left
    as it is elsewhere) with one launch. hdr/tx_valid: the packer's header
    and filled lanes per class (engine/pack.py FramePack)."""
    if dev.device.type != "cuda" or ra.device != dev.device:
        raise ValueError(f"itx_frame: dev and ra must be on one CUDA device, "
                         f"got {dev.device} and {ra.device}")
    if bpc not in BPCS or ra.dtype != I32 or not ra.is_contiguous():
        raise ValueError(f"itx_frame: bpc {bpc}, ra {ra.dtype}")
    _launch(frame_args(dev, hdr, tx_valid, ra, aw, bpc))


def _batch_launch(cb, codes, w, h, bpc):
    n = cb.shape[0]
    out = torch.empty((n, h, w), dtype=I32, device=cb.device)
    if n == 0:
        return out
    if n * w * h >= 2**31:
        raise ValueError(f"itx: batch of {n} {w}x{h} blocks is too large")
    _launch(batch_args(cb.contiguous(), codes, out, w, h, bpc))
    return out


def itx(cb, firstv, secondv, w, h, bpc):
    """cb: (N, min(h,32), min(w,32)) int32 natural-order coefficients;
    firstv/secondv: (N,) int32 variant codes. Returns (N, h, w) int32
    residuals."""
    if (w, h) not in SIZES:
        raise ValueError(f"itx: no tx size {(w, h)}")
    if cb.device.type == "cpu":
        return itx_any_core(cb, firstv, secondv, w, h, bpc)
    if cb.device.type != "cuda":
        raise ValueError(f"itx: unsupported device {cb.device}")
    n = cb.shape[0]
    if cb.dtype != I32 or tuple(cb.shape[1:]) != (min(h, 32), min(w, 32)):
        raise ValueError(f"itx: cb must be int32 (N, {min(h, 32)}, "
                         f"{min(w, 32)}), got {cb.dtype} {tuple(cb.shape)}")
    for t in (firstv, secondv):
        if t.dtype != I32 or tuple(t.shape) != (n,) or t.device != cb.device:
            raise ValueError("itx: codes must be int32 (N,) on cb's device")
    if bpc not in BPCS:
        raise ValueError(f"itx: bpc {bpc}")
    return _batch_launch(cb, [firstv, secondv], w, h, bpc)


def wht(cb):
    """Lossless 4x4 WHT. cb: (N, 4, 4) int32 natural-order coefficients.
    Returns (N, 4, 4) int32 residuals."""
    if cb.device.type == "cpu":
        return wht_core(cb)
    if cb.device.type != "cuda":
        raise ValueError(f"wht: unsupported device {cb.device}")
    if cb.dtype != I32 or tuple(cb.shape[1:]) != (4, 4):
        raise ValueError(f"wht: cb must be int32 (N, 4, 4), got {cb.dtype} "
                         f"{tuple(cb.shape)}")
    return _batch_launch(cb, [], 4, 4, 8)
