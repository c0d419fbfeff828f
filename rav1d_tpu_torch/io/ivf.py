"""IVF / Annex-B / Section-5 demuxers.

Behavior parity: rav1d tools/input/{ivf,annexb,section5}.rs. Probe-based
selection like tools/input/input.rs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


@dataclass
class Packet:
    data: bytes
    timestamp: int = 0
    offset: int = 0  # demuxer "offset" prop (byte offset / ordinal)


class IvfDemuxer:
    """IVF container: 32-byte 'DKIF' header, frames of (u32le size, u64le ts)."""

    name = "ivf"

    @staticmethod
    def probe(data: bytes) -> bool:
        return data[:6] == b"DKIF\x00\x00" and data[8:12] == b"AV01"

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            self._buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                self._buf = f.read()
        hdr = self._buf[:32]
        if hdr[:4] != b"DKIF":
            raise ValueError("not an IVF file")
        if hdr[8:12] != b"AV01":
            raise ValueError("not an AV1 IVF file")
        (self.width, self.height) = struct.unpack_from("<HH", hdr, 12)
        num, den = struct.unpack_from("<II", hdr, 16)
        self.timebase = (num, den)
        (self.num_frames,) = struct.unpack_from("<I", hdr, 24)
        self._pos = 32

    def __iter__(self):
        return self

    def __next__(self) -> Packet:
        buf, pos = self._buf, self._pos
        if pos + 12 > len(buf):
            raise StopIteration
        (sz,) = struct.unpack_from("<I", buf, pos)
        (ts,) = struct.unpack_from("<Q", buf, pos + 4)
        start = pos + 12
        end = start + sz
        if end > len(buf):
            raise StopIteration
        self._pos = end
        return Packet(data=buf[start:end], timestamp=ts, offset=pos)

    def read(self):
        try:
            return next(self)
        except StopIteration:
            return None


class Section5Demuxer:
    """Raw low-overhead OBU stream: temporal units delimited by OBU_TD.

    Parity: tools/input/section5.rs — each packet is one temporal unit
    (starts at a temporal delimiter OBU, runs until the next one).
    """

    name = "section5"

    @staticmethod
    def probe(data: bytes) -> bool:
        # First OBU must be a temporal delimiter (type 2) with has_size field.
        if not data:
            return False
        b0 = data[0]
        if b0 & 0x80:  # forbidden bit
            return False
        obu_type = (b0 >> 3) & 0xF
        has_size = (b0 >> 1) & 1
        return obu_type == 2 and has_size == 1

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            self._buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                self._buf = f.read()
        self.timebase = (25, 1)
        self.num_frames = 0
        self._pos = 0
        self._ts = 0

    @staticmethod
    def _obu_len(buf: bytes, pos: int):
        """Parse one OBU header at pos; return (obu_type, total_len) or None."""
        if pos >= len(buf):
            return None
        b0 = buf[pos]
        obu_type = (b0 >> 3) & 0xF
        ext = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        off = pos + 1 + ext
        if not has_size:
            return None
        # uleb128
        val = 0
        i = 0
        while True:
            if off >= len(buf):
                return None
            v = buf[off]
            off += 1
            val |= (v & 0x7F) << i
            i += 7
            if not (v & 0x80):
                break
            if i >= 56:
                return None
        return obu_type, (off - pos) + val

    def __iter__(self):
        return self

    def __next__(self) -> Packet:
        buf, pos = self._buf, self._pos
        if pos >= len(buf):
            raise StopIteration
        first = self._obu_len(buf, pos)
        if first is None:
            raise StopIteration
        end = pos + first[1]
        while end < len(buf):
            nxt = self._obu_len(buf, end)
            if nxt is None:
                end = len(buf)
                break
            if nxt[0] == 2:  # next temporal delimiter → unit boundary
                break
            end += nxt[1]
        self._pos = end
        ts = self._ts
        self._ts += 1
        return Packet(data=buf[pos:end], timestamp=ts, offset=pos)

    def read(self):
        try:
            return next(self)
        except StopIteration:
            return None


class AnnexBDemuxer:
    """Length-delimited Annex-B stream (temporal_unit_size uleb128 framing).

    Parity: tools/input/annexb.rs.
    """

    name = "annexb"

    @staticmethod
    def _uleb(buf: bytes, pos: int):
        val = 0
        i = 0
        while True:
            if pos >= len(buf):
                return None
            v = buf[pos]
            pos += 1
            val |= (v & 0x7F) << i
            i += 7
            if not (v & 0x80):
                break
            if i >= 56:
                return None
        return val, pos

    @staticmethod
    def _parse_obu_header(buf: bytes):
        """Returns (obu_type, obu_size) or None (annexb.rs parse_obu_header
        with allow_implicit_size)."""
        if not buf or buf[0] & 0x80:
            return None
        obu_type = (buf[0] >> 3) & 0xF
        ext = (buf[0] >> 2) & 1
        has_size = (buf[0] >> 1) & 1
        pos = 1 + ext
        if has_size:
            r = AnnexBDemuxer._uleb(buf, pos)
            if r is None:
                return None
            return obu_type, r[0]
        return obu_type, len(buf) - pos

    @classmethod
    def probe(cls, data: bytes) -> bool:
        # annexb.rs annexb_probe: td (size 0) first, then a seq hdr must
        # appear before the first frame / frame hdr.
        r = cls._uleb(data, 0)
        if r is None:
            return False
        tu_size, pos = r
        r = cls._uleb(data, pos)
        if r is None or r[0] + (r[1] - pos) > tu_size:
            return False
        fu_size, pos2 = r
        tu_size -= pos2 - pos
        r = cls._uleb(data, pos2)
        if r is None or r[0] + (r[1] - pos2) >= fu_size:
            return False
        obu_unit_size, pos = r
        tu_size -= obu_unit_size + (pos - pos2)
        fu_size -= obu_unit_size + (pos - pos2)
        hdr = cls._parse_obu_header(data[pos : pos + obu_unit_size])
        if hdr is None or hdr[0] != 2 or hdr[1] > 0:
            return False
        pos += obu_unit_size
        seq = False
        while pos < len(data):
            pos0 = pos
            r = cls._uleb(data, pos)
            if r is None or r[0] + (r[1] - pos0) > fu_size:
                return False
            obu_unit_size, pos = r
            fu_size -= pos - pos0
            hdr = cls._parse_obu_header(data[pos : pos + obu_unit_size])
            if hdr is None:
                return False
            pos += obu_unit_size
            t = hdr[0]
            if t == 1:  # seq hdr
                seq = True
            elif t in (3, 6):  # frame hdr / frame
                return seq
            elif t in (2, 4):  # td / tile group
                return False
            fu_size -= obu_unit_size
            if fu_size <= 0:
                return False
        return seq

    def __init__(self, path_or_bytes):
        if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
            self._buf = bytes(path_or_bytes)
        else:
            with open(path_or_bytes, "rb") as f:
                self._buf = f.read()
        self.timebase = (25, 1)
        self.num_frames = 0
        self._pos = 0
        self._ts = 0
        self._tu_left = 0
        self._fu_left = 0

    def __iter__(self):
        return self

    def __next__(self) -> Packet:
        # Emit one length-framed OBU per packet (tools/input/annexb.c
        # annexb_read): the decoder handles OBUs without size fields when
        # each data buffer holds exactly one OBU.
        buf = self._buf
        if self._pos >= len(buf):
            raise StopIteration
        if self._tu_left == 0:
            r = self._uleb(buf, self._pos)
            if r is None:
                raise StopIteration
            self._tu_left, self._pos = r
            self._ts += 1
        if self._fu_left == 0:
            pos0 = self._pos
            r = self._uleb(buf, self._pos)
            if r is None:
                raise StopIteration
            self._fu_left, self._pos = r
            if self._fu_left + (self._pos - pos0) > self._tu_left:
                raise StopIteration
            self._tu_left -= self._pos - pos0
        pos0 = self._pos
        r = self._uleb(buf, self._pos)
        if r is None:
            raise StopIteration
        obu_len, data_start = r
        hdr_len = data_start - pos0
        if obu_len + hdr_len > self._fu_left:
            raise StopIteration
        end = data_start + obu_len
        if end > len(buf):
            raise StopIteration
        self._pos = end
        self._tu_left -= obu_len + hdr_len
        self._fu_left -= obu_len + hdr_len
        return Packet(data=buf[data_start:end], timestamp=self._ts - 1, offset=pos0)

    def read(self):
        try:
            return next(self)
        except StopIteration:
            return None


_DEMUXERS = [IvfDemuxer, AnnexBDemuxer, Section5Demuxer]


def probe_demuxer(path):
    """Pick a demuxer by probing file contents (tools/input/input.rs parity)."""
    with open(path, "rb") as f:
        head = f.read(2048)
    for cls in _DEMUXERS:
        if cls.probe(head):
            return cls(path)
    raise ValueError(f"no demuxer accepts {path!r}")
