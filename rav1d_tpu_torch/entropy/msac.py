"""msac: the AV1 non-adaptive-binary / multi-symbol arithmetic range decoder.

Behavior parity: src/msac.rs (64-bit window variant). CDFs are numpy uint16
rows with the adaptation counter in the last slot; probabilities are 15-bit,
updated with rate = 4 + (count>>4) (+1 for >2 symbols).

Two implementations:
- MsacContext: the production path, backed by the native C core
  (native/entropy.c) via ctypes; CDF rows are passed by pointer.
- PyMsacContext: the pure-Python reference (correctness anchor); also the
  automatic fallback when the native library is unavailable.
"""

from __future__ import annotations

import ctypes

from ..native import AVAILABLE as _NATIVE, LIB as _LIB, MsacState

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
EC_WIN_SIZE = 64
_WIN_MASK = (1 << EC_WIN_SIZE) - 1


class PyMsacContext:
    __slots__ = ("buf", "pos", "end", "dif", "rng", "cnt", "allow_update_cdf")

    def __init__(self, data: bytes, disable_cdf_update: bool = False):
        self.buf = data
        self.pos = 0
        self.end = len(data)
        self.dif = (1 << (EC_WIN_SIZE - 1)) - 1
        self.rng = 0x8000
        self.cnt = -15
        self.allow_update_cdf = not disable_cdf_update
        self._refill()

    # -- internals ----------------------------------------------------------

    def _refill(self):
        c = EC_WIN_SIZE - 24 - self.cnt
        dif = self.dif
        buf, pos, end = self.buf, self.pos, self.end
        while c >= 0 and pos < end:
            dif ^= buf[pos] << c
            pos += 1
            c -= 8
        self.pos = pos
        self.dif = dif
        self.cnt = EC_WIN_SIZE - 24 - c

    def _norm(self, dif: int, rng: int):
        d = 15 - (rng.bit_length() - 1)  # 15 ^ (31 ^ clz(rng))
        self.cnt -= d
        self.dif = (((dif + 1) << d) - 1) & _WIN_MASK
        self.rng = rng << d
        if self.cnt < 0:
            self._refill()

    # -- primitive decodes --------------------------------------------------

    def decode_bool_equi(self) -> int:
        r = self.rng
        dif = self.dif
        v = ((r >> 8) << 7) + EC_MIN_PROB
        vw = v << (EC_WIN_SIZE - 16)
        ret = dif >= vw
        if ret:
            dif -= vw
            v = r - v
        self._norm(dif, v)
        return 0 if ret else 1

    def decode_bool(self, f: int) -> int:
        r = self.rng
        dif = self.dif
        v = ((r >> 8) * (int(f) >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) + EC_MIN_PROB
        vw = v << (EC_WIN_SIZE - 16)
        ret = dif >= vw
        if ret:
            dif -= vw
            v = r - v
        self._norm(dif, v)
        return 0 if ret else 1

    def decode_bool_adapt(self, cdf) -> int:
        bit = self.decode_bool(cdf[0])
        if self.allow_update_cdf:
            count = int(cdf[1])
            rate = 4 + (count >> 4)
            if bit:
                cdf[0] += ((1 << 15) - int(cdf[0])) >> rate
            else:
                cdf[0] -= int(cdf[0]) >> rate
            cdf[1] = count + (1 if count < 32 else 0)
        return bit

    def decode_symbol_adapt(self, cdf, n_symbols: int) -> int:
        """Decode one of n_symbols+1 symbols; cdf has n_symbols probs + counter."""
        c = self.dif >> (EC_WIN_SIZE - 16)
        r = self.rng >> 8
        v = self.rng
        val = 0
        while True:
            u = v
            v = r * (int(cdf[val]) >> EC_PROB_SHIFT)
            v >>= 7 - EC_PROB_SHIFT
            v += EC_MIN_PROB * (n_symbols - val)
            if c >= v:
                break
            val += 1
        self._norm(self.dif - (v << (EC_WIN_SIZE - 16)), u - v)
        if self.allow_update_cdf:
            count = int(cdf[n_symbols])
            rate = 4 + (count >> 4) + (1 if n_symbols > 2 else 0)
            for i in range(val):
                cdf[i] += ((1 << 15) - int(cdf[i])) >> rate
            for i in range(val, n_symbols):
                cdf[i] -= int(cdf[i]) >> rate
            cdf[n_symbols] = count + (1 if count < 32 else 0)
        return val

    def decode_hi_tok(self, cdf) -> int:
        tok_br = self.decode_symbol_adapt(cdf, 3)
        tok = 3 + tok_br
        if tok_br == 3:
            tok_br = self.decode_symbol_adapt(cdf, 3)
            tok = 6 + tok_br
            if tok_br == 3:
                tok_br = self.decode_symbol_adapt(cdf, 3)
                tok = 9 + tok_br
                if tok_br == 3:
                    tok = 12 + self.decode_symbol_adapt(cdf, 3)
        return tok

    # -- composite decodes --------------------------------------------------

    def decode_bools(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.decode_bool_equi()
        return v

    def decode_uniform(self, n: int) -> int:
        assert n > 0
        l = n.bit_length()  # ulog2(n) + 1
        assert l > 1
        m = (1 << l) - n
        v = self.decode_bools(l - 1)
        if v < m:
            return v
        return (v << 1) - m + self.decode_bool_equi()

    def decode_subexp(self, ref: int, n: int, k: int) -> int:
        assert n >> k == 8
        a = 0
        if self.decode_bool_equi():
            if self.decode_bool_equi():
                k += self.decode_bool_equi() + 1
            a = 1 << k
        v = self.decode_bools(k) + a
        if ref * 2 <= n:
            return _inv_recenter(ref, v)
        return n - 1 - _inv_recenter(n - 1 - ref, v)


def _inv_recenter(r: int, v: int) -> int:
    if v > (r << 1):
        return v
    if (v & 1) == 0:
        return (v >> 1) + r
    return r - ((v + 1) >> 1)


class NativeMsacContext:
    """C-backed msac state; cdf arguments are numpy uint16 rows (views into
    the contiguous CdfContext tables) passed by pointer."""

    __slots__ = ("_s", "_sp", "_buf", "allow_update_cdf")

    def __init__(self, data: bytes, disable_cdf_update: bool = False):
        self._buf = bytes(data)  # keep alive: C retains the pointer
        self._s = MsacState()
        self._sp = ctypes.byref(self._s)
        _LIB.msac_init(self._sp, self._buf, len(self._buf), disable_cdf_update)
        self.allow_update_cdf = not disable_cdf_update

    @property
    def rng(self):
        return self._s.rng

    @property
    def cnt(self):
        return self._s.cnt

    @property
    def dif(self):
        return self._s.dif

    @property
    def pos(self):
        return self._s.pos

    def decode_bool_equi(self) -> int:
        return _LIB.msac_decode_bool_equi(self._sp)

    def decode_bool(self, f: int) -> int:
        return _LIB.msac_decode_bool(self._sp, int(f))

    def decode_bool_adapt(self, cdf) -> int:
        return _LIB.msac_decode_bool_adapt(self._sp, cdf.ctypes.data)

    def decode_symbol_adapt(self, cdf, n_symbols: int) -> int:
        return _LIB.msac_decode_symbol_adapt(self._sp, cdf.ctypes.data, n_symbols)

    def decode_hi_tok(self, cdf) -> int:
        return _LIB.msac_decode_hi_tok(self._sp, cdf.ctypes.data)

    def decode_bools(self, n: int) -> int:
        return _LIB.msac_decode_bools(self._sp, n)

    def decode_uniform(self, n: int) -> int:
        return _LIB.msac_decode_uniform(self._sp, n)

    def decode_subexp(self, ref: int, n: int, k: int) -> int:
        return _LIB.msac_decode_subexp(self._sp, ref, n, k)


MsacContext = NativeMsacContext if _NATIVE else PyMsacContext
