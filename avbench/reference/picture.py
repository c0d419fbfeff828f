"""Decoded pictures and the 8-slot reference state machine.

Behavior parity: src/picture.rs (picture alloc, layout) and the ref-slot
update logic of src/decode.rs:5002-5027. Planes are numpy arrays, padded to
superblock alignment internally; muxers see only the visible w×h region.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .headers import PixelLayout


def plane_dtype(bpc: int):
    return np.uint8 if bpc == 8 else np.uint16


@dataclass
class Picture:
    """A decoded frame: Y plane + optional U/V planes (numpy, padded)."""

    w: int
    h: int
    layout: PixelLayout
    bpc: int
    y: np.ndarray = None
    u: np.ndarray = None
    v: np.ndarray = None
    # presentation metadata
    timestamp: int = 0
    fps: tuple = (25, 1)
    frame_hdr: object = None
    seq_hdr: object = None
    content_light: object = None
    mastering_display: object = None
    itut_t35: object = None

    @property
    def ss_hor(self) -> int:
        return 1 if self.layout != PixelLayout.I444 else 0

    @property
    def ss_ver(self) -> int:
        return 1 if self.layout == PixelLayout.I420 else 0

    @property
    def chroma_w(self) -> int:
        return (self.w + self.ss_hor) >> self.ss_hor

    @property
    def chroma_h(self) -> int:
        return (self.h + self.ss_ver) >> self.ss_ver

    def materialize(self):
        """The host planes are complete once the picture is decoded."""
        return self

    def iter_plane_rows(self):
        """Yield each visible plane's bytes (rows concatenated), Y then U,V.

        Matches the md5/yuv muxer row walk (tools/output/md5.rs md5_write):
        w bytes per row at 8 bpc, 2*w little-endian bytes at 10/12 bpc.
        """
        self.materialize()
        yield np.ascontiguousarray(self.y[: self.h, : self.w]).tobytes()
        if self.layout != PixelLayout.I400:
            cw, ch = self.chroma_w, self.chroma_h
            yield np.ascontiguousarray(self.u[:ch, :cw]).tobytes()
            yield np.ascontiguousarray(self.v[:ch, :cw]).tobytes()


class PictureAllocator:
    """Pluggable picture allocator (parity: Dav1dPicAllocator,
    src/picture.rs:147-225). Subclass and pass via
    Settings.allocator to control plane storage (e.g. pooled or
    pinned buffers). alloc_plane must return a zeroed (h, w) ndarray of
    `dtype`; release_picture is called when the decoder drops its last
    reference (flush/close)."""

    def alloc_plane(self, h: int, w: int, dtype) -> np.ndarray:
        return np.zeros((h, w), dtype=dtype)

    def release_picture(self, pic: "Picture") -> None:
        pass


_DEFAULT_ALLOCATOR = PictureAllocator()


def alloc_picture(w: int, h: int, layout: PixelLayout, bpc: int,
                  allocator: PictureAllocator | None = None) -> Picture:
    """Allocate a picture with planes padded to 128-pixel alignment.

    The default dav1d allocator aligns dimensions to 128 (src/picture.rs:91);
    we also pad so superblock-granular kernels never bounds-check.
    """
    alloc = allocator or _DEFAULT_ALLOCATOR
    dt = plane_dtype(bpc)
    aw = (w + 127) & ~127
    ah = (h + 127) & ~127
    pic = Picture(w=w, h=h, layout=layout, bpc=bpc)
    pic._allocator = alloc
    pic.y = alloc.alloc_plane(ah, aw, dt)
    if layout != PixelLayout.I400:
        ss_hor = 1 if layout != PixelLayout.I444 else 0
        ss_ver = 1 if layout == PixelLayout.I420 else 0
        cw = (w + ss_hor) >> ss_hor
        ch = (h + ss_ver) >> ss_ver
        acw = (cw + 127) & ~127
        ach = (ch + 127) & ~127
        pic.u = alloc.alloc_plane(ach, acw, dt)
        pic.v = alloc.alloc_plane(ach, acw, dt)
    return pic


@dataclass
class RefSlot:
    """One of the 8 reference slots (Rav1dContext_refs, src/internal.rs:225)."""

    picture: Picture = None
    frame_hdr: object = None
    seq_hdr: object = None
    segmap: np.ndarray = None  # per-4x4 segment ids
    refmvs: np.ndarray = None  # per-4x4 temporal mvs
    refpoc: tuple = ()
    cdf: object = None  # CdfContext snapshot
    showable: bool = False

    def clear(self):
        self.picture = None
        self.frame_hdr = None
        self.seq_hdr = None
        self.segmap = None
        self.refmvs = None
        self.refpoc = ()
        self.cdf = None
        self.showable = False

    def reset(self):
        # Header-only update used when frames are skipped.
        self.picture = None
        self.segmap = None
        self.refmvs = None
