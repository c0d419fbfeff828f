"""Frame runner: pack one frame, upload it once, run the programs (resid,
inter for an inter frame, wave, filter), and start the fetch of the packed
output into a host buffer.

Port of rav1d_tpu/engine/run2.py execute (with run2._stack and
engine/inter.py dev_plane), for every bit depth and chroma layout, with
superres (the filter program upscales into the geometry of f.sr_cur). The
capture and trace switches are not here. Nothing in `execute` waits for
the device: the output is copied with `non_blocking` into a buffer of the
uploader's FetchPool (engine/blob.py) after the frame's programs on the
current stream, and the picture's `materialize` (picture.py) waits for
that copy, fills the host planes and adds the frame's stage times, read
from its CUDA events then. The decoder materializes every picture it
hands out. The frame's device tensors stay referenced until then.

Reference planes stay on the device, as uint8 at 8 bits and as int16 at
10 and 12 bits (values up to 4095; torch.uint16 lacks indexing on some
backends), which the host sees as its uint16 planes. A picture the engine
decoded keeps views of its packed output as its device planes; a picture
the host path decoded (a fallback frame) has a host plane uploaded on
first use and cached, each upload counted in engine.stats["ref_uploads"].

`stage_ms` accumulates the same stages as run2.stage_ms (pack, upload,
programs, fetch) over the process, with "programs" also split into resid,
inter, wave and filter; a frame's stages are added when its picture is
materialized. Device stages are timed with CUDA events on a CUDA device,
with the host clock on the CPU.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..headers import PixelLayout
from . import programs as P
from . import stats
from .pack import pack_frame

STAGES = ("pack", "upload", "resid", "inter", "wave", "filter", "fetch",
          "programs")
stage_ms = dict.fromkeys(STAGES, 0.0)


class _Marks:
    """Timestamps between stages: CUDA events on a CUDA device (read once
    the last one has completed: `wait`), the host clock elsewhere."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def wait(self):
        """Wait for the work before the last mark (an event, not a stream
        synchronisation)."""
        if self.cuda:
            self.marks[-1][1].synchronize()

    def spans(self):
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def reset_stats():
    stage_ms.update(dict.fromkeys(STAGES, 0.0))


def dev_plane(pic, pl, device):
    """Plane `pl` of a decoded reference picture on `device`, cached on
    the picture (reference pictures do not change once in the slots,
    src/decode.rs:5002). A picture the engine decoded already holds views
    of its output; a host plane is uploaded once, and counted."""
    cache = getattr(pic, "_dev_planes", None)
    if cache is None:
        cache = pic._dev_planes = {}
    if pl not in cache:
        host = torch.from_numpy(
            np.ascontiguousarray((pic.y, pic.u, pic.v)[pl]).view(
                np.int16 if pic.bpc > 8 else np.uint8))
        if torch.device(device).type == "cuda":  # no host wait: pinned
            host = host.pin_memory()
        cache[pl] = host.to(device, non_blocking=True)
        stats["ref_uploads"] += 1
    return cache[pl]


def stack_planes(srcs, device, shape):
    """The distinct reference planes [(picture, plane)] the packer named,
    stacked in its order: (len(srcs), *shape) (one zero plane when there
    are none, which no tile then reads)."""
    rows = [dev_plane(pic, pl, device) for pic, pl in srcs]
    if not rows:
        return torch.zeros((1,) + tuple(shape), dtype=torch.uint8,
                           device=device)
    return torch.stack(rows)


def execute(f, plan, up):
    """Queue the dense pass of a frame on the device of `up` (an
    engine/blob.py Uploader) and the fetch of its output for f.sr_cur's
    host planes, which the picture's `materialize` fills. Returns False,
    having run nothing on the device, when the packer finds that an inter
    frame would overflow a pool (the caller runs the host path)."""
    t0 = time.perf_counter()
    ah, aw = plan.ah, plan.aw
    psz = ah * aw
    bpc = f.cur.bpc
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0

    pack = pack_frame(f, plan)
    if pack is None:
        return False
    hdr = pack.hdr
    pack_ms = (time.perf_counter() - t0) * 1e3

    out_pic = f.sr_cur
    if out_pic.u is not None:
        ach, acw = out_pic.u.shape
    else:
        ach = acw = 0
    s_ah, s_aw = out_pic.y.shape  # (ah, aw) without superres
    sr_geom = None
    if pack.need_sr:
        sr_geom = (s_ah, s_aw, out_pic.w, out_pic.h, 4 * f.bw)
    m = _Marks(up.device)
    m.mark("start")
    dev, _cap = up.upload(pack, psz, bpc)
    m.mark("upload")
    ra, planes = P.resid(dev, hdr, pack.tx_valid, ah=ah, aw=aw, bpc=bpc)
    m.mark("resid")
    refs = ()
    if pack.srcs is not None:
        # the reference planes as they are (no stacked copy): the kernel
        # reads each through its pointer, the plain version stacks them
        refs = tuple([dev_plane(pic, pl, up.device) for pic, pl in srcs]
                     for srcs in pack.srcs)
        planes = P.inter(planes, ra, dev, hdr, pack.inter_runs, *refs,
                         ah=ah, aw=aw, bpc=bpc, vwY=f.cur.w,
                         vhY=f.cur.h, vwC=(f.cur.w + ss_hor) >> ss_hor,
                         vhC=(f.cur.h + ss_ver) >> ss_ver)
    m.mark("inter")
    planes = P.wave(planes, ra, dev, hdr, pack.waves, ah=ah, aw=aw, bpc=bpc,
                    ss_hor=ss_hor, ss_ver=ss_ver)
    m.mark("wave")

    geom = (ah, aw, ach, acw, f.bh, f.bw, f.cur.h)
    _, packed = P.filter_(planes, dev, hdr, geom=geom, bpc=bpc,
                          layout_i=int(layout), lr_ws=pack.lr_ws,
                          sr_geom=sr_geom)
    m.mark("filter")
    # the output planes stay on the device as the picture's reference
    # planes: views of the packed output, the host planes' shapes
    spsz = s_ah * s_aw
    csz = ach * acw
    out_pic._dev_planes = {0: packed[:spsz].view(s_ah, s_aw)}
    if out_pic.u is not None:
        out_pic._dev_planes[1] = packed[spsz : spsz + csz].view(ach, acw)
        out_pic._dev_planes[2] = packed[spsz + csz :].view(ach, acw)
    # the fetch: an async copy after the programs, completed (and the
    # stages read) when the picture is materialized
    nbytes = packed.numel() * packed.element_size()
    buf = up.fetches.take(nbytes)
    host = buf[:nbytes].view(packed.dtype)
    host.copy_(packed, non_blocking=True)
    m.mark("fetch")
    keep = (dev, ra, planes, packed, refs)
    up.fetches.add(out_pic, buf, lambda: _finish(out_pic, host, m, pack_ms,
                                                 keep))
    return True


def _finish(out_pic, host, m, pack_ms, keep):
    """Complete a frame's fetch (FetchPool.complete): wait for the copy,
    fill the host planes from the buffer, add the frame's stage times.
    `keep` holds the frame's device tensors until then: the kernels read
    them through raw pointers that the caching allocator does not see."""
    m.wait()
    flat = host.numpy()
    if flat.dtype == np.int16:
        flat = flat.view(np.uint16)
    s_ah, s_aw = out_pic.y.shape
    spsz = s_ah * s_aw
    out_pic.y[:, :] = flat[:spsz].reshape(s_ah, s_aw)
    if out_pic.u is not None:
        ach, acw = out_pic.u.shape
        csz = ach * acw
        out_pic.u[:, :] = flat[spsz : spsz + csz].reshape(ach, acw)
        out_pic.v[:, :] = flat[spsz + csz :].reshape(ach, acw)

    sp = m.spans()
    rec = {
        "pack": pack_ms,
        "upload": sp["upload"],
        "resid": sp["resid"],
        "inter": sp["inter"],
        "wave": sp["wave"],
        "filter": sp["filter"],
        "fetch": sp["fetch"],
    }
    rec["programs"] = (rec["resid"] + rec["inter"] + rec["wave"]
                       + rec["filter"])
    for k in STAGES:
        stage_ms[k] += rec[k]
