"""MSB-first bit reader for AV1 header (OBU) parsing.

Control-plane only — headers are a few hundred bits per frame, so pure Python
is the right tool. Behavioral parity target: rav1d src/getbits.rs (GetBits):
reads past end-of-buffer return zero bits and latch an error flag instead of
raising, uleb128 caps at 56 bits / u32 range, subexp uses inv_recenter.
"""

from __future__ import annotations


def ulog2(v: int) -> int:
    """Floor log2 for v >= 1 (31 - clz in the reference)."""
    return v.bit_length() - 1


def inv_recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if (v & 1) == 0:
        return (v >> 1) + r
    return r - ((v + 1) >> 1)


class GetBits:
    __slots__ = ("data", "bitpos", "nbits", "error")

    def __init__(self, data: bytes | bytearray | memoryview):
        self.data = bytes(data)
        self.bitpos = 0
        self.nbits = len(self.data) * 8
        self.error = 0

    # -- core reads ---------------------------------------------------------

    def get_bit(self) -> int:
        p = self.bitpos
        if p >= self.nbits:
            self.error = 1
            return 0
        self.bitpos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def get_bits(self, n: int) -> int:
        assert 0 < n <= 32
        p = self.bitpos
        end = p + n
        if end > self.nbits:
            # Reference refill(): reads whole bytes; bits past EOB read as 0
            # and error is latched.
            self.error = 1
            avail = self.nbits - p
            if avail <= 0:
                self.bitpos = end
                return 0
            v = self._extract(p, avail) << (n - avail)
            self.bitpos = end
            return v
        self.bitpos = end
        return self._extract(p, n)

    def _extract(self, p: int, n: int) -> int:
        first = p >> 3
        last = (p + n - 1) >> 3
        chunk = int.from_bytes(self.data[first : last + 1], "big")
        total = (last - first + 1) * 8
        return (chunk >> (total - (p & 7) - n)) & ((1 << n) - 1)

    def get_sbits(self, n: int) -> int:
        """n-bit two's-complement signed read (arithmetic-shift semantics)."""
        v = self.get_bits(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    # -- composite reads ----------------------------------------------------

    def get_uleb128(self) -> int:
        val = 0
        i = 0
        more = 0
        while True:
            v = self.get_bits(8)
            more = v & 0x80
            val |= (v & 0x7F) << i
            i += 7
            if not (more and i < 56):
                break
        if val > 0xFFFFFFFF or more:
            self.error = 1
            return 0
        return val

    def get_uniform(self, max_: int) -> int:
        """Non-symmetric uniform distribution ns(max) per AV1 spec 4.10.7."""
        assert max_ > 1
        l = ulog2(max_) + 1
        m = (1 << l) - max_
        v = self.get_bits(l - 1)
        if v < m:
            return v
        return (v << 1) - m + self.get_bit()

    def get_vlc(self) -> int:
        if self.get_bit():
            return 0
        n_bits = 0
        while True:
            n_bits += 1
            if n_bits == 32:
                return 0xFFFFFFFF
            if self.get_bit():
                break
        return (1 << n_bits) - 1 + self.get_bits(n_bits)

    def _get_bits_subexp_u(self, ref: int, n: int) -> int:
        v = 0
        i = 0
        while True:
            b = 3 + i - 1 if i else 3
            if n < v + 3 * (1 << b):
                v += self.get_uniform(n - v + 1)
                break
            elif not self.get_bit():
                v += self.get_bits(b)
                break
            else:
                v += 1 << b
                i += 1
        if ref * 2 <= n:
            return inv_recenter(ref, v)
        return n - inv_recenter(n - ref, v)

    def get_bits_subexp(self, ref: int, n: int) -> int:
        return self._get_bits_subexp_u(ref + (1 << n), 2 << n) - (1 << n)

    # -- position -----------------------------------------------------------

    def bytealign(self):
        self.bitpos = (self.bitpos + 7) & ~7

    @property
    def pos(self) -> int:
        return self.bitpos

    @property
    def byte_pos(self) -> int:
        return (self.bitpos + 7) >> 3

    def has_pending_bits(self) -> bool:
        return (self.bitpos & 7) != 0
