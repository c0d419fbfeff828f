"""Frame-blob layout shared with the JAX engine, word for word.

Copies of the constants that fix where each region of the per-frame int32
blob lives (rav1d_tpu/engine/mega.py header, inter slots + chunk
geometry), the inter tile descriptor rows (engine/tiles.py D_*, W_*, C_*,
B_*), the wave descriptor field order (engine/wave2.py FIELDS), the
tx-type to 1-D variant maps and the itx chunk sizes (engine/kernels.py).
They are copies, not imports, because those modules import JAX;
tests/test_torch_pack.py holds every value here to its original.
"""

from __future__ import annotations

import numpy as np

from ..ops.ref import itx as R

# ------------------------------- header ----------------------------------

HDR_LEN = 512
SIZES = sorted(R._SHIFTS.keys())  # 19 (w, h) itx size classes
R0 = 8
WHT0 = R0 + 2 * len(SIZES)
CF0 = WHT0 + 2
PAL0 = CF0 + 1
WAVE0 = PAL0 + 2
INTER0 = WAVE0 + 4
N_SLOTS = 18
IH0 = INTER0 + 2 * N_SLOTS  # inter hmask region base
DB0 = IH0 + 1               # eih base + 6 pass map bases
CDEF0 = DB0 + 7             # ylvl base, uvlvl base, damping
SR0 = CDEF0 + 3             # dx0, mx00, dx1, mx01
LR0 = SR0 + 4               # 12 x (base, count): kind {w,0,1,2} x plane
assert LR0 + 24 <= HDR_LEN

SLOTS = {
    "putY": 0, "putC": 1, "lapY": 2, "lapC": 3,
    "warpY": 4, "warpC": 5,
    "prepY": 6, "prepC": 7, "wprepY": 8, "wprepC": 9,
    "hostpool": 10,
    "avg": 11, "segy00": 12, "segy10": 13, "segy11": 14,
    "mask": 15, "seguv": 16, "blend": 17,
}

# chunk geometry
PAL_B = 1024      # palette (idx, val) pairs per chunk
TB = 256          # inter tiles per chunk
NPUT = 12         # put descriptor rows: the D_* rows + the case row
NWARP = 12
NCOMB = 8
NBLEND = 7
HB = 64           # host-pool tiles per chunk
LRB = 64          # LR stripes per chunk
WHT_B = 256

# ------------------------------ inter tiles ------------------------------

# put/prep descriptor rows (row 11, past these, is the chunk's filter case)
D_SROW, D_SY, D_SX, D_MX, D_MY, D_F2D, D_FLAT0, D_TW, D_TH, D_BW, D_BH = \
    range(11)
# warp descriptor rows
W_SROW, W_SY, W_SX, W_A, W_B, W_C, W_D, W_MX, W_MY, W_FLAT0, W_TW, W_TH = \
    range(12)
# combiner descriptor rows
C_R0, C_R1, C_FLAT0, C_P0, C_P1, C_P2, C_TW, C_TH = range(8)
# OBMC blend descriptor rows
B_ROW, B_FLAT0, B_MOFF, B_MRS, B_MCS, B_TW, B_TH = range(7)

# ------------------------------ wavefront --------------------------------

FIELDS = ("modes", "angles", "flat0", "rmask", "z2mw", "z2mh", "z2sm",
          "cfla", "cfl0", "cflwp", "cflhp", "w", "h", "iioff",
          "wflags", "wcount",
          "hav", "phl", "phbl", "pht", "phtr")
N_FIELDS = len(FIELDS)
FI = {k: i for i, k in enumerate(FIELDS)}

# wflags bits
F_Z = 1
F_FILTER = 2
F_CFL = 4
F_IDENT = 8
F_II = 16

# ------------------------------ transforms -------------------------------

# 1-D variant order; per-block codes index into this
VARIANTS = ("dct", "adst", "flipadst", "identity")
_VCODE = {name: i for i, name in enumerate(VARIANTS)}

# txtp -> (first_code, second_code); WHT handled separately
TXTP_FIRST = np.zeros(17, np.int32)
TXTP_SECOND = np.zeros(17, np.int32)
for _tp, (_f, _s) in R._TXTP_1D.items():
    TXTP_FIRST[_tp] = _VCODE[_f]
    TXTP_SECOND[_tp] = _VCODE[_s]

def variants_for(n):
    """1-D variants AV1 allows at size n (adst families stop at 16)."""
    if n <= 16:
        return VARIANTS
    if n == 32:
        return ("dct", "identity")
    return ("dct",)


def chunk_for(w, h):
    """Descriptor chunk length per tx size (the packer's layout unit)."""
    b = 16384 // (w * h)
    p = 32
    while p < b:
        p <<= 1
    return min(p, 1024)
