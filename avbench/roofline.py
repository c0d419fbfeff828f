"""The least bytes a frame's device work must move, from the picture's
geometry and the frame header alone (never from the packed blob), the
kernel families by name, and the table of peaks.

A frame the engine runs must write its coded planes once (the
reconstruction: residual, inter and intra prediction together), read
each distinct reference picture's planes once (an inter frame), and,
where a post filter is on (deblock, CDEF, loop restoration, superres),
read the planes once and write the output planes once: the filters
together, so that a kernel that fuses them is held to the same count. A
grained picture is read once and written once. Samples are one byte at
8 bits and two above, as the planes are held. That is the least any
implementation moves, so the share of the roofline is at most 100%.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def plane_bytes(w, h, layout, bpc):
    """Bytes of a picture's planes: layout 0 (4:0:0) .. 3 (4:4:4)."""
    n = w * h
    if int(layout) != 0:
        ss_hor = int(int(layout) != 3)
        ss_ver = int(int(layout) == 1)
        n += 2 * ((w + ss_hor) >> ss_hor) * ((h + ss_ver) >> ss_ver)
    return n * (1 if bpc == 8 else 2)


def _pic_bytes(pic):
    return plane_bytes(pic.w, pic.h, pic.layout, pic.bpc)


def _filters_on(hdr):
    lf = hdr.loopfilter
    cd = hdr.cdef
    return bool(lf.level_y[0] or lf.level_y[1]
                or any(cd.y_strength) or any(cd.uv_strength)
                or any(int(t) for t in hdr.restoration.type)
                or hdr.size.width[0] != hdr.size.width[1])


def frame_bytes(f):
    """The least bytes of frame context `f`'s device work."""
    hdr = f.frame_hdr
    b = _pic_bytes(f.cur)
    if hdr.frame_type.is_inter_or_switch:
        refs = {id(p): p for p in f.refp if p is not None}
        b += sum(_pic_bytes(p) for p in refs.values())
    if _filters_on(hdr):
        b += _pic_bytes(f.cur) + _pic_bytes(f.sr_cur)
    return b


def grain_bytes(pic):
    """The least bytes of one grained picture: read once, written once."""
    return 2 * _pic_bytes(pic)


def _load(name):
    with open(os.path.join(HERE, name)) as fh:
        return json.load(fh)


class Kernels:
    """kernels.json: a device operation's family by a part of its name."""

    def __init__(self):
        doc = _load("kernels.json")
        self.families = doc["families"]
        self.copies = doc["copies"]

    def family(self, name):
        for part, fam in self.families.items():
            if part in name:
                return fam
        for part in self.copies:
            if part in name:
                return "copy"
        return "other"


def peak_bytes_per_s(kind):
    """The published memory bandwidth of the device named `kind`, or None
    for a device the table lacks."""
    for row in _load("peaks.json")["devices"]:
        if row["match"] in kind:
            return row["hbm_bytes_per_s"]
    return None
