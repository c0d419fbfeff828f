"""Warped-motion parameter derivation (behavior parity: src/warpmv.rs).

Pure-Python control plane: shear validation, affine least-squares from
neighbour MVs. The actual warp filtering is in rav1d_tpu.ops.mc.
"""

from __future__ import annotations

# div_lut[f] = round(2^22 / (256 + f)) — the AV1 spec division LUT
# (spec 7.11.3.7); generated, identical in every conforming decoder.
DIV_LUT = [(2**22 + (256 + f) // 2) // (256 + f) for f in range(257)]


def iclip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def apply_sign(v, s):
    return -v if s < 0 else v


def _iclip_wmp(v: int) -> int:
    cv = iclip(v, -32768, 32767)
    return apply_sign((abs(cv) + 32) >> 6, cv) * (1 << 6)


def _resolve_divisor_32(d: int):
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    if shift > 8:
        f = (e + (1 << (shift - 9))) >> (shift - 8)
    else:
        f = e << (8 - shift)
    return shift + 14, DIV_LUT[f]


def _resolve_divisor_64(d: int):
    return _resolve_divisor_32(d)  # same formula; python ints are wide


def _i16(v):
    v &= 0xFFFF
    return v - 0x10000 if v >= 0x8000 else v


def get_shear_params(wm) -> bool:
    """Compute alpha/beta/gamma/delta; returns True if params are INVALID
    (ref: src/warpmv.rs:51 rav1d_get_shear_params). The stored shear params
    wrap to i16 like the reference's `as i16` casts."""
    mat = wm.matrix
    if mat[2] <= 0:
        return True
    alpha = _i16(_iclip_wmp(mat[2] - 0x10000))
    beta = _i16(_iclip_wmp(mat[3]))
    shift, y = _resolve_divisor_32(abs(mat[2]))
    y = apply_sign(y, mat[2])
    v1 = mat[4] * 0x10000 * y
    rnd = (1 << shift) >> 1
    gamma = _i16(_iclip_wmp(apply_sign((abs(v1) + rnd) >> shift, v1)))
    v2 = mat[3] * mat[4] * y
    delta = _i16(
        _iclip_wmp(mat[5] - apply_sign((abs(v2) + rnd) >> shift, v2) - 0x10000)
    )
    wm.alpha, wm.beta, wm.gamma, wm.delta = alpha, beta, gamma, delta
    return (
        4 * abs(alpha) + 7 * abs(beta) >= 0x10000
        or 4 * abs(gamma) + 4 * abs(delta) >= 0x10000
    )


def _get_mult_shift_ndiag(px: int, idet: int, shift: int) -> int:
    v1 = px * idet
    v2 = apply_sign((abs(v1) + ((1 << shift) >> 1)) >> shift, v1)
    return iclip(v2, -0x1FFF, 0x1FFF)


def _get_mult_shift_diag(px: int, idet: int, shift: int) -> int:
    v1 = px * idet
    v2 = apply_sign((abs(v1) + ((1 << shift) >> 1)) >> shift, v1)
    return iclip(v2, 0xE001, 0x11FFF)


def set_affine_mv2d(bw4, bh4, mv_x, mv_y, wm, bx4, by4):
    """ref: src/warpmv.rs rav1d_set_affine_mv2d."""
    mat = wm.matrix
    rsuy = 2 * bh4 - 1
    rsux = 2 * bw4 - 1
    isuy = by4 * 4 + rsuy
    isux = bx4 * 4 + rsux
    mat[0] = iclip(
        mv_x * 0x2000 - (isux * (mat[2] - 0x10000) + isuy * mat[3]),
        -0x800000,
        0x7FFFFF,
    )
    mat[1] = iclip(
        mv_y * 0x2000 - (isux * mat[4] + isuy * (mat[5] - 0x10000)),
        -0x800000,
        0x7FFFFF,
    )


def find_affine_int(pts, np_, bw4, bh4, mv_x, mv_y, wm, bx4, by4) -> bool:
    """Least-squares affine fit from neighbour MVs; True on failure
    (ref: src/warpmv.rs rav1d_find_affine_int)."""
    mat = wm.matrix
    a = [[0, 0], [0, 0]]
    bx = [0, 0]
    by = [0, 0]
    rsuy = 2 * bh4 - 1
    rsux = 2 * bw4 - 1
    suy = rsuy * 8
    sux = rsux * 8
    duy = suy + mv_y
    dux = sux + mv_x
    isuy = by4 * 4 + rsuy
    isux = bx4 * 4 + rsux

    for p in pts[:np_]:
        dx = p[1][0] - dux
        dy = p[1][1] - duy
        sx = p[0][0] - sux
        sy = p[0][1] - suy
        if abs(sx - dx) < 256 and abs(sy - dy) < 256:
            a[0][0] += ((sx * sx) >> 2) + sx * 2 + 8
            a[0][1] += ((sx * sy) >> 2) + sx + sy + 4
            a[1][1] += ((sy * sy) >> 2) + sy * 2 + 8
            bx[0] += ((sx * dx) >> 2) + sx + dx + 8
            bx[1] += ((sy * dx) >> 2) + sy + dx + 4
            by[0] += ((sx * dy) >> 2) + sx + dy + 4
            by[1] += ((sy * dy) >> 2) + sy + dy + 8

    det = a[0][0] * a[1][1] - a[0][1] * a[0][1]
    if det == 0:
        return True
    shift, idet = _resolve_divisor_64(abs(det))
    idet = apply_sign(idet, det)
    shift -= 16
    if shift < 0:
        idet <<= -shift
        shift = 0

    mat[2] = _get_mult_shift_diag(a[1][1] * bx[0] - a[0][1] * bx[1], idet, shift)
    mat[3] = _get_mult_shift_ndiag(a[0][0] * bx[1] - a[0][1] * bx[0], idet, shift)
    mat[4] = _get_mult_shift_ndiag(a[1][1] * by[0] - a[0][1] * by[1], idet, shift)
    mat[5] = _get_mult_shift_diag(a[0][0] * by[1] - a[0][1] * by[0], idet, shift)
    mat[0] = iclip(
        mv_x * 0x2000 - (isux * (mat[2] - 0x10000) + isuy * mat[3]),
        -0x800000,
        0x7FFFFF,
    )
    mat[1] = iclip(
        mv_y * 0x2000 - (isux * mat[4] + isuy * (mat[5] - 0x10000)),
        -0x800000,
        0x7FFFFF,
    )
    return False


def derive_warpmv(rf, t, bw4, bh4, masks, mvx, mvy, wmp):
    """decode.rs derive_warpmv: gather up to 8 neighbour samples flagged in
    masks and least-squares-fit an affine model."""
    from ..headers import WarpedMotionType
    from ..tables.block_tables import BLOCK_DIMENSIONS

    pts = [[[0, 0], [0, 0]] for _ in range(8)]
    np_ = 0

    def rp(i, j):
        # row t.by + i (i may be negative within the ring-equivalent window)
        return rf.r[t.by + i, j]

    def bdim(rec):
        return BLOCK_DIMENSIONS[int(rec["bs"])]

    def add_sample(np_, dx, dy, sx, sy, rec):
        d = bdim(rec)
        pts[np_][0][0] = 16 * (2 * dx + sx * d[0]) - 8
        pts[np_][0][1] = 16 * (2 * dy + sy * d[1]) - 8
        pts[np_][1][0] = pts[np_][0][0] + int(rec["mv"][0][0])
        pts[np_][1][1] = pts[np_][0][1] + int(rec["mv"][0][1])
        return np_ + 1

    def ctz(v):
        return (v & -v).bit_length() - 1

    if (masks[0] & 0xFFFFFFFF) == 1 and (masks[1] >> 32) == 0:
        off = t.bx & (bdim(rp(-1, t.bx))[0] - 1)
        np_ = add_sample(np_, -off, 0, 1, -1, rp(-1, t.bx))
    else:
        off = 0
        xmask = masks[0] & 0xFFFFFFFF
        while np_ < 8 and xmask:
            tz = ctz(xmask)
            off += tz
            xmask >>= tz
            np_ = add_sample(np_, off, 0, 1, -1, rp(-1, t.bx + off))
            xmask &= ~1
    if np_ < 8 and (masks[1] & 0xFFFFFFFF) == 1:
        off = t.by & (bdim(rp(0, t.bx - 1))[1] - 1)
        np_ = add_sample(np_, 0, -off, -1, 1, rp(-off, t.bx - 1))
    else:
        off = 0
        ymask = masks[1] & 0xFFFFFFFF
        while np_ < 8 and ymask:
            tz = ctz(ymask)
            off += tz
            ymask >>= tz
            np_ = add_sample(np_, 0, off, -1, 1, rp(off, t.bx - 1))
            ymask &= ~1
    if np_ < 8 and (masks[1] >> 32):
        np_ = add_sample(np_, 0, 0, -1, -1, rp(-1, t.bx - 1))
    if np_ < 8 and (masks[0] >> 32):
        np_ = add_sample(np_, bw4, 0, 1, -1, rp(-1, t.bx + bw4))
    assert 0 < np_ <= 8

    # select samples by MV-difference threshold
    mvd = [0] * 8
    ret = 0
    thresh = 4 * iclip(max(bw4, bh4), 4, 28)
    for i in range(np_):
        mvd[i] = abs(pts[i][1][0] - pts[i][0][0] - mvx) + abs(
            pts[i][1][1] - pts[i][0][1] - mvy
        )
        if mvd[i] > thresh:
            mvd[i] = -1
        else:
            ret += 1
    if ret == 0:
        ret = 1
    else:
        i = 0
        j = np_ - 1
        for _ in range(np_ - ret):
            while mvd[i] != -1:
                i += 1
            while mvd[j] == -1:
                j -= 1
            assert i != j
            if i > j:
                break
            mvd[i] = mvd[j]
            pts[i] = [list(pts[j][0]), list(pts[j][1])]
            i += 1
            j -= 1

    if not find_affine_int(pts, ret, bw4, bh4, mvx, mvy, wmp, t.bx, t.by) and not (
        get_shear_params(wmp)
    ):
        wmp.type = WarpedMotionType.AFFINE
    else:
        wmp.type = WarpedMotionType.IDENTITY
    return wmp
