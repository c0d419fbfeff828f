"""Tile helpers of the plain inter program on torch
(engine/programs.py inter_plain; on the card csrc/inter.cu computes the
same per tile).

Ports of rav1d_tpu/engine/tiles.py `_i16`, `_gather` and `_filters`: every
inter pixel job is a batch of 8x8 destination tiles, each gathering its
source window from a stack of reference planes with the coordinates clamped
to the visible picture (which reproduces emu_edge's border replication),
then filtering it with the taps its descriptor selects (the tables of
engine/consts.py).

Where jnp indexing clamps an out-of-range index silently, these clamp it
explicitly: torch raises instead.
"""

from __future__ import annotations

import torch

from .consts import tables
from .layout import D_BH, D_BW, D_F2D, D_MX, D_MY

I32 = torch.int32


def _i16(a):
    return ((a + 0x8000) & 0xFFFF) - 0x8000


def _gather(stack, srow, y0, nrow, x0, ncol, vw, vh):
    """(N, nrow, ncol) int32 windows of the plane stack (S, H, W):
    lane i reads plane srow[i] from (y0[i], x0[i]), rows clamped to
    [0, vh - 1] and columns to [0, vw - 1]."""
    d_ = stack.device
    rows = (y0[:, None] + torch.arange(nrow, dtype=I32, device=d_)[None, :]
            ).clamp(0, vh - 1)
    cols = (x0[:, None] + torch.arange(ncol, dtype=I32, device=d_)[None, :]
            ).clamp(0, vw - 1)
    srow = srow.clamp(0, stack.shape[0] - 1)
    return stack[srow.long()[:, None, None], rows.long()[:, :, None],
                 cols.long()[:, None, :]].to(I32)


def _filters(d):
    """The 8-tap horizontal and vertical filters (N, 8) of each lane: the
    filter type of its 2-D filter code per direction (4-tap variants for
    blocks 4 pixels wide or tall) at subpel phase mx - 1, my - 1. A phase
    of 0 reads phase 1's taps, as the JAX program's callers arrange by
    raising mx and my to at least 1 (mega.py _put_out mk_filters)."""
    t = tables(d.device)
    F = t["mc_subpel_filters"]
    FD = t["filter_dir"]
    FD = FD[d[D_F2D].clamp(0, FD.shape[0] - 1).long()]
    hi = torch.where(d[D_BW] > 4, FD[:, 0], 3 + (FD[:, 0] & 1))
    vi = torch.where(d[D_BH] > 4, FD[:, 1], 3 + (FD[:, 1] & 1))
    nf, nph = F.shape[0], F.shape[1]
    hi = hi.clamp(0, nf - 1).long()
    vi = vi.clamp(0, nf - 1).long()
    return (F[hi, (d[D_MX] - 1).clamp(0, nph - 1).long()],
            F[vi, (d[D_MY] - 1).clamp(0, nph - 1).long()])


def htap(win, taps):
    """out[n, r, j] = sum_k taps[n, k] * win[n, r, j + k]: (N, R, J + 7)
    windows, (N, 8) taps -> (N, R, J)."""
    return (win.unfold(2, 8, 1) * taps[:, None, None, :]).sum(-1, dtype=I32)


def vtap(win, taps):
    """out[n, i, j] = sum_k taps[n, k] * win[n, i + k, j]: (N, I + 7, J)
    windows, (N, 8) taps -> (N, I, J)."""
    return (win.unfold(1, 8, 1) * taps[:, None, None, :]).sum(-1, dtype=I32)
