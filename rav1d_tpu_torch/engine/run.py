"""Frame runner: pack one intra frame, upload it once, run the three
programs, fetch the packed output into the picture's host planes.

Port of rav1d_tpu/engine/run2.py execute for an intra frame. The inter
phase, superres, the capture and trace switches, and the deferred batched
fetch are not here: the port fetches each frame synchronously, so a
decoded picture's planes are complete when the decoder hands it out.

`stage_ms` accumulates the same stages as run2.stage_ms (pack, upload,
programs, fetch) over the process, with "programs" also split into resid,
wave and filter. Device stages are timed with CUDA events on a CUDA
device, with the host clock on the CPU.
"""

from __future__ import annotations

import time

import torch

from ..headers import PixelLayout
from . import programs as P
from .pack import pack_frame

STAGES = ("pack", "upload", "resid", "wave", "filter", "fetch", "programs")
stage_ms = dict.fromkeys(STAGES, 0.0)


class _Marks:
    """Timestamps between stages: CUDA events on a CUDA device (read after
    the frame's final synchronisation), the host clock elsewhere."""

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

    def spans(self):
        if self.cuda:
            self.marks[-1][1].synchronize()
        out = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
        return out


def reset_stats():
    stage_ms.update(dict.fromkeys(STAGES, 0.0))


def execute(f, plan, up):
    """Run the dense pass of an intra 8-bit 4:2:0 frame on the device of
    `up` (an engine/blob.py Uploader) and write the result into
    f.sr_cur's host planes."""
    t0 = time.perf_counter()
    ah, aw = plan.ah, plan.aw
    psz = ah * aw
    bpc = f.cur.bpc
    layout = f.cur.layout
    ss_ver = 1 if layout == PixelLayout.I420 else 0
    ss_hor = 1 if layout != PixelLayout.I444 else 0

    pack = pack_frame(f, plan)
    hdr = pack.hdr
    pack_ms = (time.perf_counter() - t0) * 1e3

    m = _Marks(up.device)
    m.mark("start")
    dev, _cap = up.upload(pack, psz, bpc)
    m.mark("upload")
    ra, planes = P.resid(dev, hdr, pack.tx_valid, ah=ah, aw=aw, bpc=bpc)
    m.mark("resid")
    planes = P.wave(planes, ra, dev, hdr, pack.waves, ah=ah, aw=aw, bpc=bpc,
                    ss_hor=ss_hor, ss_ver=ss_ver)
    m.mark("wave")

    out_pic = f.sr_cur
    if out_pic.u is not None:
        ach, acw = out_pic.u.shape
    else:
        ach = acw = 0
    geom = (ah, aw, ach, acw, f.bh, f.bw, f.cur.h)
    _, packed = P.filter_(planes, dev, hdr, geom=geom, bpc=bpc,
                          layout_i=int(layout), lr_ws=pack.lr_ws)
    m.mark("filter")
    flat = packed.cpu().numpy()  # synchronous: the frame is complete here
    m.mark("fetch")

    out_pic.y[:, :] = flat[:psz].reshape(ah, aw)
    if out_pic.u is not None:
        csz = ach * acw
        out_pic.u[:, :] = flat[psz : psz + csz].reshape(ach, acw)
        out_pic.v[:, :] = flat[psz + csz :].reshape(ach, acw)

    sp = m.spans()
    rec = {
        "pack": pack_ms,
        "upload": sp["upload"],
        "resid": sp["resid"],
        "wave": sp["wave"],
        "filter": sp["filter"],
        "fetch": sp["fetch"],
    }
    rec["programs"] = rec["resid"] + rec["wave"] + rec["filter"]
    for k in STAGES:
        stage_ms[k] += rec[k]
    return True
