"""Output muxers: md5 (the test oracle), y4m, raw yuv, null.

Behavior parity: rav1d tools/output/{md5,y4m2,yuv,null}.rs. The md5 digest is
a standard MD5 over every frame's visible plane rows in Y,U,V order — row
length is w bytes (8-bit) or 2*w bytes little-endian (10/12-bit); chroma
dimensions follow the layout's subsampling (tools/output/md5.rs md5_write).
"""

from __future__ import annotations

import hashlib

import numpy as np


class Md5Muxer:
    name = "md5"

    def __init__(self, path=None):
        self._md5 = hashlib.md5()
        self._path = path

    def write_header(self, params=None, fps=None):
        pass

    def write_picture(self, pic):
        for plane in pic.iter_plane_rows():
            self._md5.update(plane)

    def digest(self) -> str:
        return self._md5.hexdigest()

    def write_trailer(self):
        out = self.digest() + "\n"
        if self._path in (None, "-"):
            print(out, end="")
        else:
            with open(self._path, "w") as f:
                f.write(out)

    def verify(self, expected: str) -> bool:
        return self.digest() == expected.strip().lower()


class YuvMuxer:
    name = "yuv"

    def __init__(self, path):
        self._f = open(path, "wb") if path != "-" else None

    def write_header(self, params=None, fps=None):
        pass

    def write_picture(self, pic):
        for rows in pic.iter_plane_rows():
            self._f.write(rows)

    def write_trailer(self):
        if self._f:
            self._f.close()


class Y4mMuxer:
    name = "y4m"

    _CSS = {
        ((1, 1), 8): "420jpeg",
        ((1, 1), 10): "420p10",
        ((1, 1), 12): "420p12",
        ((1, 0), 8): "422",
        ((1, 0), 10): "422p10",
        ((1, 0), 12): "422p12",
        ((0, 0), 8): "444",
        ((0, 0), 10): "444p10",
        ((0, 0), 12): "444p12",
    }

    def __init__(self, path):
        self._f = open(path, "wb") if path != "-" else None
        self._wrote_header = False

    def write_header(self, params=None, fps=None):
        pass

    def write_picture(self, pic):
        if not self._wrote_header:
            ss = (pic.ss_hor, pic.ss_ver)
            if pic.layout == 0:  # monochrome
                css = "mono" + ("" if pic.bpc == 8 else f"p{pic.bpc}")
            else:
                css = self._CSS[(ss, pic.bpc)]
            fps = getattr(pic, "fps", (25, 1))
            self._f.write(
                f"YUV4MPEG2 W{pic.w} H{pic.h} F{fps[0]}:{fps[1]} Ip A0:0 C{css}\n".encode()
            )
            self._wrote_header = True
        self._f.write(b"FRAME\n")
        for rows in pic.iter_plane_rows():
            self._f.write(rows)

    def write_trailer(self):
        if self._f:
            self._f.close()


class NullMuxer:
    name = "null"

    def __init__(self, path=None):
        pass

    def write_header(self, params=None, fps=None):
        pass

    def write_picture(self, pic):
        pass

    def write_trailer(self):
        pass


def make_muxer(name: str, path=None):
    table = {m.name: m for m in (Md5Muxer, YuvMuxer, Y4mMuxer, NullMuxer)}
    if name not in table:
        raise ValueError(f"unknown muxer {name!r}")
    return table[name](path)
