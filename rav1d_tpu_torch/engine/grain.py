"""Film grain of a picture the engine hands out: the host tables, and the
grain step of a decoder's output.

The split is rav1d_tpu/ops/tpu/fg.py's: the host builds what is O(blocks)
or O(1) a picture, the device does the O(pixels) work. `tables(pic)`
builds, with the reference's own functions (ops/ref/fg.py,
recon/fg_apply.py), the grain table of each plane (generate_grain_y/uv,
the AR-filtered gaussian noise), the three scaling tables
(generate_scaling, 1 << bpc entries each), the clip ranges, and one table
of the 8-bit random values of every 32x32 luma block (row r, column c):
the reference draws them row by row from _row_seed(r), and the value that
a block row's top overlap reads (its chain seeded with row r - 1) is the
row above's own, so one table serves the block, its left, top and
top-left neighbours, on every plane (chroma draws the same chain, and its
block columns are as many as luma's: ceil(ceil(w / 2) / 16) =
ceil(w / 32)).

`apply(pic, device)` is the grain step of a decoder on `device`: the
picture's planes on the device (the engine's output, `_dev_planes`, or
its host planes uploaded where it has none), one launch of csrc/fg.cu
rav1d_fg_frame on a CUDA device (ops/cuda/grain.py grain_frame) or
ops/fg.py grain_frame_plain on the CPU, and the result copied into a new
Picture's host planes (from a card through its reused page-locked buffer,
`HostCopy`, into new arrays); the picture itself stays grain-free, the
reference for later frames. As recon/fg_apply.py does, at an odd width
with subsampled chroma the grain-free luma plane's padding column w
becomes a copy of column w - 1 (the kernels read column w - 1 for it).
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..headers import PixelLayout
from ..ops import fg as FG
from ..ops.cuda import grain as GK
from ..ops.ref import fg
from ..recon import fg_apply

GRAIN_H = fg.GRAIN_HEIGHT + 1  # rows of a grain table (74)
GRAIN_W = fg.GRAIN_WIDTH  # (82)


@dataclass
class GrainTables:
    """What the grain of one picture needs besides its planes."""

    bpc: int
    ss: tuple  # the chroma planes' (ss_x, ss_y)
    w: int  # the luma plane's visible size
    h: int
    nplanes: int  # 1 (4:0:0) or 3
    lut: np.ndarray  # (3, 74, 82) int16: each plane's grain table
    scaling: np.ndarray  # (3, 1 << bpc) uint8: y, cb, cr points' tables
    rand: np.ndarray  # (block rows, block columns) uint8
    plane_scaling: tuple  # each plane's scaling table, -1 for a copy
    overlap: bool
    scaling_shift: int
    cfl: bool  # chroma_scaling_from_luma
    uv_mult: tuple
    uv_luma_mult: tuple
    uv_offset: tuple
    clip: tuple  # ((lo, hi) of luma, (lo, hi) of chroma)


def random_table(data, w, h, ss_x):
    """(block rows, block columns) uint8: the random value of each 32x32
    luma block, each row's chain from its own _row_seed."""
    n_rows, n_cols = (h + 31) >> 5, (w + 31) >> 5
    cw = (w + ss_x) >> ss_x
    assert -(-cw // (32 >> ss_x)) == n_cols  # chroma's block columns
    seeds = np.array([fg._row_seed(1, r, data)[0] for r in range(n_rows)],
                     np.int64)
    out = np.empty((n_rows, n_cols), np.uint8)
    for c in range(n_cols):
        v, seeds = fg._get_random_number(8, seeds)
        out[:, c] = v
    return out


def tables(pic):
    """The GrainTables of a picture with film grain parameters."""
    data = pic.frame_hdr.film_grain.data
    bpc = pic.bpc
    ss_x, ss_y = pic.ss_hor, pic.ss_ver
    chroma = pic.layout != PixelLayout.I400
    lut = np.zeros((3, GRAIN_H, GRAIN_W), np.int16)
    lut_y = fg.generate_grain_y(data, bpc)
    lut[0] = lut_y
    sc = [0 if data.num_y_points else -1, -1, -1]
    for uv in range(2 if chroma else 0):
        if data.num_uv_points[uv] or data.chroma_scaling_from_luma:
            lut[1 + uv] = fg.generate_grain_uv(lut_y, data, uv == 1,
                                               ss_x == 1, ss_y == 1, bpc)
            sc[1 + uv] = 0 if data.chroma_scaling_from_luma else 1 + uv
    scaling = np.stack([
        fg_apply.generate_scaling(bpc, data.y_points[: data.num_y_points]),
        fg_apply.generate_scaling(bpc, data.uv_points[0][: data.num_uv_points[0]]),
        fg_apply.generate_scaling(bpc, data.uv_points[1][: data.num_uv_points[1]]),
    ])
    bdm8 = bpc - 8
    if data.clip_to_restricted_range:
        top_c = 235 if pic.seq_hdr.mtrx == 0 else 240  # MC_IDENTITY
        clip = ((16 << bdm8, 235 << bdm8), (16 << bdm8, top_c << bdm8))
    else:
        clip = ((0, (1 << bpc) - 1),) * 2
    return GrainTables(
        bpc=bpc, ss=(ss_x, ss_y), w=pic.w, h=pic.h,
        nplanes=3 if chroma else 1, lut=lut, scaling=scaling,
        rand=random_table(data, pic.w, pic.h, ss_x), plane_scaling=tuple(sc),
        overlap=bool(data.overlap_flag), scaling_shift=data.scaling_shift,
        cfl=bool(data.chroma_scaling_from_luma),
        uv_mult=tuple(data.uv_mult), uv_luma_mult=tuple(data.uv_luma_mult),
        uv_offset=tuple(data.uv_offset), clip=clip)


def source_planes(pic, device):
    """The picture's planes on `device` as the kernels read them (uint8,
    or int16 above 8 bits): the engine's output where the picture has it,
    else its host planes uploaded (a host-path frame)."""
    dev = getattr(pic, "_dev_planes", None) or {}
    host = (pic.y, pic.u, pic.v)[: 1 if pic.layout == PixelLayout.I400 else 3]
    out = []
    for pl, a in enumerate(host):
        t = dev.get(pl)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(a).view(
                np.int16 if pic.bpc > 8 else np.uint8)).to(device)
        out.append(t)
    return out


def grain_planes(planes, t):
    """The grained planes: one launch of the kernel on CUDA tensors, the
    plain version on CPU ones."""
    if planes[0].device.type == "cuda":
        return GK.grain_frame(planes, t)
    return FG.grain_frame_plain(planes, t)


class HostCopy:
    """The reused host buffer (page-locked on a card) that a card's
    grained planes are copied through to the host, and its lock. The
    planes handed out are copies out of it, never views: the next
    picture's copy rewrites the buffer (engine/blob.py FetchPool copies out
    of its buffers by the same rule)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pin = self.device.type == "cuda"
        self.buf = None
        self.lock = threading.Lock()

    def fill(self, planes):
        """Views of the buffer holding a copy of `planes`, the device's
        copy waited for (under the lock, or in a single thread)."""
        sizes = [p.numel() * p.element_size() for p in planes]
        if self.buf is None or self.buf.numel() < sum(sizes):
            self.buf = None  # the old buffer goes before the new one
            self.buf = torch.empty(sum(sizes), dtype=torch.uint8,
                                   pin_memory=self.pin)
        host, o = [], 0
        for p, n in zip(planes, sizes):
            h = self.buf[o : o + n].view(p.dtype).view(p.shape)
            h.copy_(p, non_blocking=self.pin)
            host.append(h)
            o += n
        if self.pin:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            ev.synchronize()
        return host

    def planes(self, planes, bpc):
        """numpy copies of `planes` (uint8, or uint16 above 8 bits)."""
        dt = np.uint16 if bpc > 8 else np.uint8
        with self.lock:
            return [h.numpy().view(dt).copy() for h in self.fill(planes)]


_HOST = {}
_HOST_LOCK = threading.Lock()


def host_copy(device):
    """The HostCopy of a card."""
    dev = torch.device(device)
    with _HOST_LOCK:
        h = _HOST.get(dev)
        if h is None:
            h = _HOST[dev] = HostCopy(dev)
    return h


def to_host(planes, bpc):
    """numpy copies of planes (uint8, or uint16 above 8 bits): from a card
    through its HostCopy, waited for; CPU planes as they are."""
    if planes[0].device.type == "cuda":
        return host_copy(planes[0].device).planes(planes, bpc)
    out = [p.numpy() for p in planes]
    return [a.view(np.uint16) if bpc > 8 else a for a in out]


def apply(pic, device):
    """A new Picture: `pic` with its film grain applied on `device`."""
    pic.materialize()
    t = tables(pic)
    planes = to_host(grain_planes(source_planes(pic, device), t), pic.bpc)
    if pic.w & pic.ss_hor:
        pic.y[:, pic.w] = pic.y[:, pic.w - 1]
    return dataclasses.replace(pic, y=planes[0],
                               u=planes[1] if len(planes) > 1 else None,
                               v=planes[2] if len(planes) > 1 else None)
