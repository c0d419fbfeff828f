"""CDEF on torch: direction search + constrained filter, batched over all
8x8 blocks of a frame (port of rav1d_tpu/ops/tpu/cdef.py).

Same integer semantics as rav1d_tpu.ops.ref.cdef. The direction costs are
unsigned 32-bit in the reference and wrap in int32 on the way there; the
port keeps int32 sums (wrapping as JAX does) and compares their unsigned
values in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables.spec_data import CDEF_DIRECTIONS

MISSING = -32768
I32 = torch.int32
_U32 = 0xFFFFFFFF


def _off(o):
    o = int(o)
    dy = (o + 6) // 12
    return dy, o - dy * 12


# (dy, dx) offset tables per direction for the 3 tap rings
_PRI_OFF = [[_off(CDEF_DIRECTIONS[d + 2][k]) for k in range(2)] for d in range(8)]
_SEC1_OFF = [[_off(CDEF_DIRECTIONS[d + 4][k]) for k in range(2)] for d in range(8)]
_SEC2_OFF = [[_off(CDEF_DIRECTIONS[d + 0][k]) for k in range(2)] for d in range(8)]


def _fd_bins():
    """Partial-sum bin of each of the 64 pixels for the 8 axes."""
    ys, xs = np.mgrid[0:8, 0:8]
    return [
        ((ys + xs).ravel(), 15),
        ((ys + (xs >> 1)).ravel(), 11),
        (ys.ravel(), 8),
        ((3 + ys - (xs >> 1)).ravel(), 11),
        ((7 + ys - xs).ravel(), 15),
        ((3 - (ys >> 1) + xs).ravel(), 11),
        (xs.ravel(), 8),
        (((ys >> 1) + xs).ravel(), 11),
    ]


_FD_BINS = _fd_bins()
_FD_DEV = {}  # device -> (the bins' index tensors, the cost divisors)


def _fd_consts(dev):
    """find_dir's constant tensors on `dev`, copied there once (a copy from
    pageable memory per frame would wait for the device)."""
    key = str(dev)
    if key not in _FD_DEV:
        _FD_DEV[key] = (
            [torch.from_numpy(ix).to(dev) for ix, _ in _FD_BINS],
            torch.tensor([840, 420, 280, 210, 168, 140, 120], dtype=I32,
                         device=dev))
    return _FD_DEV[key]


def _sq(x):
    return x * x


def find_dir_batch(blocks, bpc):
    """blocks: (N, 8, 8) int32. Returns (dir (N,), var (N,)) int32 — parity
    with rav1d_tpu.ops.ref.cdef.find_dir per block."""
    dev = blocks.device
    bdm8 = bpc - 8
    px = ((blocks.to(I32) >> bdm8) - 128).reshape(-1, 64)
    n = px.shape[0]
    sums = []
    ixs, div = _fd_consts(dev)
    for ix, (_, nb) in zip(ixs, _FD_BINS):
        s = torch.zeros((n, nb), dtype=I32, device=dev)
        s.index_add_(1, ix, px)
        sums.append(s)
    d0, a0, h0, a1, d1, a2, h1, a3 = sums

    cost = [None] * 8
    cost[2] = _sq(h0).sum(1, dtype=I32) * 105
    cost[6] = _sq(h1).sum(1, dtype=I32) * 105
    for ci, dd in ((0, d0), (4, d1)):
        v = ((_sq(dd[:, :7]) + _sq(dd[:, 8:15].flip(1)))
             * div[None, :]).sum(1, dtype=I32)
        cost[ci] = v + _sq(dd[:, 7]) * 105
    div135 = div[1:6:2]  # 420, 210, 140
    for k, aa in ((0, a0), (1, a1), (2, a2), (3, a3)):
        c = _sq(aa[:, 3:8]).sum(1, dtype=I32) * 105
        c = c + ((_sq(aa[:, :3]) + _sq(aa[:, 8:11].flip(1))) * div135[None, :]
                 ).sum(1, dtype=I32)
        cost[k * 2 + 1] = c
    # unsigned 32-bit values of the wrapped int32 costs
    costs = torch.stack(cost, dim=1).to(torch.int64) & _U32  # (N, 8)
    best_dir = costs.argmax(dim=1)
    best = costs.gather(1, best_dir[:, None])[:, 0]
    alt = costs.gather(1, (best_dir ^ 4)[:, None])[:, 0]
    var = ((best - alt) & _U32) >> 10
    return best_dir.to(I32), var.to(I32)


def _constrain(diff, threshold, shift):
    adiff = diff.abs()
    v = torch.minimum(adiff, (threshold - (adiff >> shift)).clamp(min=0))
    return torch.where(diff < 0, -v, v)


def ulog2(v):
    """floor(log2(v)) for int32 v >= 1 (31 - clz)."""
    r = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (v >> s) > 0
        r = torch.where(big, r + s, r)
        v = torch.where(big, v >> s, v)
    return r


def _lt_unsigned(a, b):
    # a < b as uint32, on int32 values
    m = -(1 << 31)
    return (a ^ m) < (b ^ m)


def cdef_filter_batch(tiles, pri, sec, direction, damping, bpc):
    """Filter a batch of padded CDEF tiles.

    tiles: (N, h+4, w+4) int32, pre-padded with MISSING where edges are
    unavailable (the 2px ring). pri/sec/direction: (N,) int32 per-block
    params (0 strength = skip that stage). damping: (N,) int32.
    Returns (N, h, w) filtered pixels. Parity: cdef_filter_block_c.
    """
    h = tiles.shape[1] - 4
    w = tiles.shape[2] - 4
    bdm8 = bpc - 8

    px = tiles[:, 2 : 2 + h, 2 : 2 + w]
    pri_tap = 4 - ((pri >> bdm8) & 1)
    zero = torch.zeros_like(pri)
    pri_shift = (damping - torch.where(pri > 0, ulog2(pri.clamp(min=1)), zero)
                 ).clamp(min=0)
    sec_shift = damping - torch.where(sec > 0, ulog2(sec.clamp(min=1)), zero)

    dsel = direction.long()[None, :, None, None]

    def win(offsets):
        """(N, h, w) window at each block's direction-dependent offset."""
        alld = torch.stack(
            [tiles[:, 2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]
             for dy, dx in offsets], dim=0,
        )  # (8, N, h, w)
        return torch.take_along_dim(alld, dsel, dim=0)[0]

    pv = pri[:, None, None]
    sv = sec[:, None, None]
    psh = pri_shift[:, None, None]
    ssh = sec_shift[:, None, None]

    s = torch.zeros_like(px)
    mn = px
    mx = px

    def track(mn, mx, v):
        return torch.where(_lt_unsigned(v, mn), v, mn), torch.maximum(v, mx)

    have_sec = sv > 0
    have_pri = pv > 0
    both = have_pri & have_sec
    tap = pri_tap[:, None, None]
    for k in range(2):
        offs = [_PRI_OFF[d][k] for d in range(8)]
        p0 = win(offs)
        p1 = win([(-dy, -dx) for dy, dx in offs])
        contrib = tap * (_constrain(p0 - px, pv, psh)
                         + _constrain(p1 - px, pv, psh))
        s = s + torch.where(have_pri, contrib, 0)
        mn, mx = track(mn, mx, torch.where(both, p0, px))
        mn, mx = track(mn, mx, torch.where(both, p1, px))
        tap = (tap & 3) | 2

        o1 = [_SEC1_OFF[d][k] for d in range(8)]
        o2 = [_SEC2_OFF[d][k] for d in range(8)]
        s0 = win(o1)
        s1 = win([(-dy, -dx) for dy, dx in o1])
        s2 = win(o2)
        s3 = win([(-dy, -dx) for dy, dx in o2])
        sec_tap = 2 - k
        contrib = sec_tap * (
            _constrain(s0 - px, sv, ssh)
            + _constrain(s1 - px, sv, ssh)
            + _constrain(s2 - px, sv, ssh)
            + _constrain(s3 - px, sv, ssh)
        )
        s = s + torch.where(have_sec, contrib, 0)
        for svv in (s0, s1, s2, s3):
            mn, mx = track(mn, mx, torch.where(both, svv, px))

    out = px + ((s - (s < 0).to(I32) + 8) >> 4)
    # clamp to [mn, mx] only when both stages ran (reference behavior)
    clamped = torch.maximum(mn, torch.minimum(out, mx))
    out = torch.where(both, clamped, out)
    return torch.where(have_pri | have_sec, out, px)
