"""Work-item buffers connecting the entropy plane to the dense plane.

This is the TPU-native analog of rav1d's frame-thread two-pass split
(pass 1 `read_coef_blocks` storing into `Rav1dFrameContext_frame_thread`
buffers sized at src/decode.rs:4110-4165; pass 2 replay in recon.rs): the
sequential syntax/entropy pass stores every transform block's coefficients
plus a fully-resolved per-block work record; the dense pass then replays —
and can batch — the pixel work with no entropy dependencies left.
"""

from __future__ import annotations

import numpy as np


class CoefStore:
    """Frame-wide sequential coefficient store (eob, txtp, cf per txblock).

    Written in syntax order by the read pass, consumed in the same order by
    the apply pass. Mirrors rav1d's frame_thread.cf buffer + per-block cursors.
    """

    def __init__(self, bw, bh, layout_mult=3):
        # transform blocks at the frame edge decode their FULL size even
        # when partially outside (read_coef_tree walks whole txblocks), so
        # budget on tx-aligned padded dims, not the frame area
        pw = (bw + 16 + 15) & ~15
        ph = (bh + 16 + 15) & ~15
        cap_tx = pw * ph * layout_mult + 64
        cap_cf = pw * ph * 16 * layout_mult + 1024
        self.cf = np.zeros(cap_cf, dtype=np.int32)
        # -1 = no coefficients; tile-parallel syntax leaves gaps between
        # per-tile store regions, and every consumer filters on eob >= 0
        self.eob = np.full(cap_tx, -1, dtype=np.int32)
        self.txtp = np.zeros(cap_tx, dtype=np.int32)
        self.txw = np.zeros(cap_tx, dtype=np.int16)  # pixel dims for batching
        self.txh = np.zeros(cap_tx, dtype=np.int16)
        self.cf_off = np.zeros(cap_tx, dtype=np.int64)
        # per-txblock destination (native syntax pass fills these; they
        # let the dense pass emit itx jobs straight from the store)
        self.txpl = np.zeros(cap_tx, dtype=np.uint8)
        self.txx = np.zeros(cap_tx, dtype=np.int32)
        self.txy = np.zeros(cap_tx, dtype=np.int32)
        self.cf_pos = 0
        self.tx_pos = 0
        self.cf_rpos = 0
        self.tx_rpos = 0
        self.residuals = None  # optional tx_idx -> precomputed (h, w) residual

    def alloc_cf(self, sz):
        """Zeroed cf slice for decode_coefs to fill in place."""
        s = self.cf[self.cf_pos : self.cf_pos + sz]
        s[:] = 0
        return s

    def push(self, eob, txtp, sz, w=0, h=0):
        self.eob[self.tx_pos] = eob
        self.txtp[self.tx_pos] = txtp
        self.txw[self.tx_pos] = w
        self.txh[self.tx_pos] = h
        self.cf_off[self.tx_pos] = self.cf_pos
        self.tx_pos += 1
        self.cf_pos += sz

    def pop(self, sz):
        idx = self.tx_rpos
        eob = int(self.eob[idx])
        txtp = int(self.txtp[idx])
        self.tx_rpos += 1
        cf = self.cf[self.cf_rpos : self.cf_rpos + sz]
        self.cf_rpos += sz
        return eob, txtp, cf

    def pop_idx(self, sz):
        idx = self.tx_rpos
        eob, txtp, cf = self.pop(sz)
        return idx, eob, txtp, cf

    def seek(self, tx_pos, cf_pos):
        self.tx_rpos = tx_pos
        self.cf_rpos = cf_pos


class WorkItem:
    """One block's deferred dense work, with every mutable-context value it
    needs snapshotted at syntax time (the mutable a/l contexts advance past
    the block before the dense pass runs)."""

    __slots__ = (
        "kind",  # 'intra' | 'inter'
        "bx",
        "by",
        "bs",
        "b",
        "ts",
        "intra_edge_flags",
        "sm_fl",
        "sm_uv_fl",
        "pal",
        "pal_idx",
        "warpmv",
        "tl_4x4_filter",
        "a_filter",
        "l_filter",
        "tx_pos",
        "cf_pos",
        "tx_end",  # end of this block's tx range (None: next item's tx_pos)
    )

    def __init__(self, kind, t, ts, bs, b):
        self.kind = kind
        self.bx = t.bx
        self.by = t.by
        self.bs = bs
        self.b = b
        self.ts = ts
        self.intra_edge_flags = 0
        self.sm_fl = 0
        self.sm_uv_fl = 0
        self.pal = None
        self.pal_idx = None
        self.warpmv = None
        self.tl_4x4_filter = 0
        self.a_filter = None
        self.l_filter = None
        self.tx_pos = 0
        self.cf_pos = 0
        self.tx_end = None
