"""Generate csrc/itx_1d.cuh: the 1-D AV1 butterflies as straight-line C.

The butterflies' one normative source is rav1d_tpu/ops/ref/itx.py
(`_FAMILY` and `_wht4`, parity src/itx_1d.rs). Rather than retype ~900
lines of integer arithmetic, this script runs those same Python functions
over symbolic values that record every operation, and prints one C
function per (variant, size) that the itx kernel needs. Every add,
subtract, multiply and negate goes through the wrapping helpers of
csrc/itx.cu, so the C code wraps exactly as int32 arithmetic does in
numpy, torch and JAX (signed overflow is undefined in C++). `>>` on a
negative int is arithmetic in nvcc and g++, as in the frameworks.

    python -m rav1d_tpu_torch.ops.cuda.gen_itx_1d > rav1d_tpu_torch/csrc/itx_1d.cuh

tests/test_torch_itx.py checks that the committed header is this script's
output and runs it, compiled for the host, against the plain torch twin.
"""

from __future__ import annotations

import sys

from ..itx import Lanes, apply_1d
from ..ref import itx as R

# the (variant, n) pairs of the 19 tx sizes (AV1 allows the adst families
# up to 16 points, the identity up to 32, the dct up to 64; the 64-point
# dct reads only its first 32 inputs), and the lossless 4-point WHT
FUNCS = ([(name, n) for name in ("dct", "adst", "flipadst", "identity")
          for n in (4, 8, 16)]
         + [("dct", 32), ("identity", 32), ("dct", 64), ("wht", 4)])


class _Sym:
    """An int32 value in the C program being written."""

    __slots__ = ("expr", "em")

    def __init__(self, expr, em):
        self.expr = expr
        self.em = em

    def _bin(self, fn, other, swap=False):
        o = other.expr if isinstance(other, _Sym) else str(int(other))
        a, b = (o, self.expr) if swap else (self.expr, o)
        return self.em.temp(f"{fn}({a}, {b})")

    def __add__(self, o):
        return self._bin("wadd", o)

    def __radd__(self, o):
        return self._bin("wadd", o, swap=True)

    def __sub__(self, o):
        return self._bin("wsub", o)

    def __rsub__(self, o):
        return self._bin("wsub", o, swap=True)

    def __mul__(self, o):
        return self._bin("wmul", o)

    def __rmul__(self, o):
        return self._bin("wmul", o, swap=True)

    def __rshift__(self, k):
        assert isinstance(k, int) and 0 <= k < 32
        return self.em.temp(f"({self.expr} >> {k})")

    def __neg__(self):
        return self.em.temp(f"wneg({self.expr})")

    def clip(self, mn, mx):
        return self.em.temp(f"clip3({self.expr}, {mn.expr}, {mx.expr})")


class _Emitter:
    def __init__(self):
        self.lines = []
        self.n = 0

    def temp(self, expr):
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"    const int {name} = {expr};")
        return _Sym(name, self)


def emit_function(name, n):
    em = _Emitter()
    # inputs are read into locals first, so the stores at the end can
    # never overwrite an input that a later store still reads
    em.lines = [f"    const int i{i} = c[{i}];" for i in range(n)]
    lanes = Lanes([_Sym(f"i{i}", em) for i in range(n)])
    if name == "wht":
        R._wht4(lanes)
    else:
        apply_1d(name, n, lanes, _Sym("mn", em), _Sym("mx", em))
    outs = [lanes.vals[i].expr for i in range(n)]
    body = em.lines + [f"    c[{i}] = {outs[i]};" for i in range(n)]
    return "\n".join(
        [f"RAV1D_HD void {name}{n}(int* c, int mn, int mx) {{",
         "    (void)mn; (void)mx;"] + body + ["}"]
    )


def op_count(name, n):
    """32-bit integer operations of one generated 1-D transform: each
    add, subtract, multiply, shift and negate counts one, a clip two (a
    min and a max). Used for the kernels' bounds."""
    body = emit_function(name, n).splitlines()
    temps = [ln for ln in body if ln.startswith("    const int t")]
    return len(temps) + sum("clip3(" in ln for ln in temps)


def generate():
    parts = [
        "// Generated by rav1d_tpu_torch/ops/cuda/gen_itx_1d.py from",
        "// rav1d_tpu/ops/ref/itx.py (_FAMILY, _wht4): do not edit by hand.",
        "// Each function runs one n-point 1-D inverse transform in place on",
        "// c[0..n); mn/mx are the clip bounds of the pass.",
        "#pragma once",
        "",
    ]
    for name, n in FUNCS:
        parts.append(emit_function(name, n))
        parts.append("")
    return "\n".join(parts)


if __name__ == "__main__":
    sys.stdout.write(generate())
