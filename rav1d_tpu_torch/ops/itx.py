"""1-D inverse-transform butterflies over torch tensors.

The integer butterflies are not retyped: rav1d_tpu/ops/ref/itx.py writes
them against a generic array protocol (operators and ``.clip``), so they
run over torch int32 tensors through the lane adapter below exactly as
they run over numpy arrays (parity: src/itx_1d.rs). torch int32 arithmetic
wraps like the JAX engine's int32 arithmetic.
"""

from __future__ import annotations

from .ref import itx as R


class Lanes:
    """List-of-tensors view with numpy-slice semantics over the lane axis.

    The ref 1-D kernels index/assign single lanes and recurse on strided
    slices (``c[::2]``); this adapter maps those accesses onto a shared
    Python list of tensors (each statement builds new tensors, so no lane
    is ever updated in place).
    """

    __slots__ = ("vals", "idx")

    def __init__(self, vals, idx=None):
        self.vals = vals
        self.idx = list(range(len(vals))) if idx is None else idx

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return Lanes(self.vals, self.idx[i])
        return self.vals[self.idx[i]]

    def __setitem__(self, i, v):
        if isinstance(i, slice):
            for j, vv in zip(self.idx[i], v):
                self.vals[j] = vv
            return
        self.vals[self.idx[i]] = v


def apply_1d(name, n, lanes, mn, mx):
    """Run the n-point 1-D variant `name` over `lanes` in place."""
    if name == "identity":
        if n == 4:
            for i in range(4):
                lanes[i] = lanes[i] + ((lanes[i] * 1697 + 2048) >> 12)
        elif n == 8:
            for i in range(8):
                lanes[i] = lanes[i] * 2
        elif n == 16:
            for i in range(16):
                lanes[i] = 2 * lanes[i] + ((lanes[i] * 1697 + 1024) >> 11)
        else:
            for i in range(32):
                lanes[i] = lanes[i] * 4
        return
    R._FAMILY[name][n](lanes, mn, mx)
