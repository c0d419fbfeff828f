"""Seeded synthetic AV1 streams: hand-written headers, random tile data.

An AV1 entropy decoder turns any byte string into a valid symbol sequence,
so a frame whose uncompressed header is well formed and whose tile payload
is random bytes is a valid picture that exercises whatever tools the header
allows. `still_picture` writes the Section-5 OBUs of one key frame
(temporal delimiter, sequence header, one frame OBU) with screen content
tools (palette), filter intra, the intra edge filter, CDEF with eight
nonzero strengths, switchable loop restoration on every plane and
TX_MODE_SELECT, so one frame carries every intra tool of the device
engine's intra path. `inter_sequence` writes a key frame and two inter
frames that reach every inter tool of the layout (compound modes, OBMC,
local and global warp, interintra, the bilinear filter); `key_then_inter`
the plain single-reference case. Both `still_picture` and
`inter_sequence` take a bit depth (8, 10, 12), a chroma layout (4:0:0,
4:2:0, 4:2:2, 4:4:4; the sequence header picks the profile) and
superres; their defaults are 8-bit 4:2:0 without superres. Both also
take `tools=Tools(...)`, the header tools the defaults leave off (128-px
superblocks, several tiles, segmentation with a lossless segment, delta q
and delta lf, loop filter deltas, TX_MODE_LARGEST, the reduced transform
set, 64-px restoration units); `Tools()` writes every stream byte for byte
as before. `write_ivf` puts packets in an IVF file.

This is test input, not a decoder feature: the oracle for a decode of
these bytes is the reference decoder's host path.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from .headers import PixelLayout

OBU_SEQ_HDR = 1
OBU_TD = 2
OBU_FRAME = 6
ORDER_HINT_BITS = 7  # inter_sequence's order_hint_bits
BILINEAR = 3  # interpolation_filter code (headers.FilterMode.BILINEAR)


@dataclass(frozen=True)
class Tools:
    """Header tools of a synthetic stream. Each default is the value the
    writers always used, and with the defaults no extra random value is
    drawn, so `Tools()` leaves every stream byte for byte as it was.

    - sb128: use_128x128_superblock (tile info in 128-px superblocks; the
      lr_unit_shift bit is then the only unit-size bit);
    - tiles: (cols_log2, rows_log2), uniform spacing; each tile but the
      last carries a 4-byte size field, each its own random payload, the
      payload split by tile area;
    - segmentation: segmentation_enabled, each of the 8 segments with a
      random alt_q and alt_lf_y_v/y_h/u/v, one segment's alt_q bringing its
      qindex to 0 (a lossless segment: 4x4 WHT blocks);
    - delta_q: delta_q_present with a random delta_q_res, and (where the
      frame does not allow intra block copy) delta_lf_present with a random
      delta_lf_res and delta_lf_multi = `delta_lf_multi`;
    - lf_deltas: loop_filter_delta_enabled and _update, random ref_deltas
      and mode_deltas;
    - tx_mode_largest: tx_mode_select = 0 (TX_MODE_LARGEST) and
      reduced_tx_set = 1;
    - lr_unit_shift: lr_unit_shift and, at 4:2:0, lr_uv_shift (1: 128-px
      luma units, 64-px chroma units at 4:2:0; 0 with 64-px superblocks:
      64-px units on every plane);
    - film_grain: film_grain_params_present, and film_grain_params() in
      every frame (_film_grain): random points, AR coefficients and
      shifts, chroma multipliers, overlap and range clip; inter_sequence's
      frame 1 may skip grain or load it from a reference, its frame 2
      always loads it (update_grain = 0).
    """

    sb128: bool = False
    tiles: tuple = (0, 0)
    segmentation: bool = False
    delta_q: bool = False
    delta_lf_multi: bool = False
    lf_deltas: bool = False
    tx_mode_largest: bool = False
    lr_unit_shift: int = 1
    film_grain: bool = False


DEFAULT_TOOLS = Tools()


class _Bits:
    """MSB-first bit writer (the inverse of bits.GetBits)."""

    def __init__(self):
        self.bits = []

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def sbits(self, value, n):
        """An n-bit two's-complement value (the inverse of
        bits.GetBits.get_sbits)."""
        assert -(1 << (n - 1)) <= value < (1 << (n - 1)), (value, n)
        self.put(value & ((1 << n) - 1), n)

    def uniform(self, max_, v):
        """ns(max_) (the inverse of bits.GetBits.get_uniform)."""
        l = max_.bit_length()
        m = (1 << l) - max_
        if v < m:
            self.put(v, l - 1)
        else:
            self.put((v + m) >> 1, l - 1)
            self.put((v + m) & 1, 1)

    def subexp(self, value, ref, n):
        """A signed value coded relative to `ref` (the inverse of
        bits.GetBits.get_bits_subexp)."""
        mx = 2 << n
        r = ref + (1 << n)
        x = value + (1 << n)
        assert 0 <= x <= mx, (value, ref, n)
        if r * 2 > mx:
            r, x = mx - r, mx - x
        v = x if x > 2 * r else (2 * (x - r) if x >= r else 2 * (r - x) - 1)
        base, i = 0, 0
        while True:
            k = 3 + i - 1 if i else 3
            if mx < base + 3 * (1 << k):
                self.uniform(mx - base + 1, v - base)
                return
            if v - base < (1 << k):
                self.put(0, 1)
                self.put(v - base, k)
                return
            self.put(1, 1)
            base += 1 << k
            i += 1

    def trailing(self):
        """trailing_bits(): a one bit, then zeros to the byte boundary."""
        self.bits.append(1)
        self.align()

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def bytes(self):
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            v = 0
            for b in self.bits[i : i + 8]:
                v = (v << 1) | b
            out.append(v)
        return bytes(out)


def _leb128(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _obu(obu_type, payload):
    return bytes([(obu_type << 3) | 2]) + _leb128(len(payload)) + payload


def _tile_log2(sz, tgt):
    k = 0
    while (sz << k) < tgt:
        k += 1
    return k


def _profile(bpc, layout):
    """seq_profile for a bit depth and layout: 12 bits and 4:2:2 need
    Professional, 4:4:4 High, the rest Main."""
    if bpc == 12 or layout == PixelLayout.I422:
        return 2
    return 1 if layout == PixelLayout.I444 else 0


def _seq_header(w, h, *, reduced, bpc, superres, layout=PixelLayout.I420,
                inter_tools=False, sb128=False, film_grain=False):
    profile = _profile(bpc, layout)
    b = _Bits()
    b.put(profile, 3)  # seq_profile
    b.put(1 if reduced else 0, 1)  # still_picture
    b.put(1 if reduced else 0, 1)  # reduced_still_picture_header
    level = 8  # seq_level_idx 4.0: up to 2048x1152
    if reduced:
        b.put(level, 5)
    else:
        b.put(0, 1)  # timing_info_present_flag
        b.put(0, 1)  # initial_display_delay_present_flag
        b.put(0, 5)  # operating_points_cnt_minus_1
        b.put(0, 12)  # operating_point_idc[0]
        b.put(level, 5)
        b.put(0, 1)  # seq_tier[0] (level > 7)
    wb = max((w - 1).bit_length(), 1)
    hb = max((h - 1).bit_length(), 1)
    b.put(wb - 1, 4)
    b.put(hb - 1, 4)
    b.put(w - 1, wb)
    b.put(h - 1, hb)
    if not reduced:
        b.put(0, 1)  # frame_id_numbers_present_flag
    b.put(1 if sb128 else 0, 1)  # use_128x128_superblock
    b.put(1, 1)  # enable_filter_intra
    b.put(1, 1)  # enable_intra_edge_filter
    if not reduced:
        t = 1 if inter_tools else 0
        b.put(t, 1)  # enable_interintra_compound
        b.put(t, 1)  # enable_masked_compound
        b.put(t, 1)  # enable_warped_motion
        b.put(t, 1)  # enable_dual_filter
        b.put(t, 1)  # enable_order_hint
        if t:
            b.put(1, 1)  # enable_jnt_comp
            b.put(0, 1)  # enable_ref_frame_mvs
        b.put(1, 1)  # seq_choose_screen_content_tools (adaptive)
        b.put(1, 1)  # seq_choose_integer_mv (adaptive)
        if t:
            b.put(ORDER_HINT_BITS - 1, 3)  # order_hint_bits_minus_1
    b.put(1 if superres else 0, 1)  # enable_superres
    b.put(1, 1)  # enable_cdef
    b.put(1, 1)  # enable_restoration
    # color_config
    b.put(1 if bpc > 8 else 0, 1)  # high_bitdepth
    if profile == 2 and bpc > 8:
        b.put(1 if bpc == 12 else 0, 1)  # twelve_bit
    mono = layout == PixelLayout.I400
    if profile != 1:
        b.put(1 if mono else 0, 1)  # mono_chrome
    b.put(0, 1)  # color_description_present_flag
    b.put(0, 1)  # color_range
    if not mono:
        ss_x = 0 if layout == PixelLayout.I444 else 1
        ss_y = 1 if layout == PixelLayout.I420 else 0
        if profile == 2 and bpc == 12:
            b.put(ss_x, 1)  # subsampling_x
            if ss_x:
                b.put(ss_y, 1)  # subsampling_y
        if ss_x and ss_y:
            b.put(0, 2)  # chroma_sample_position
        b.put(0, 1)  # separate_uv_delta_q
    b.put(1 if film_grain else 0, 1)  # film_grain_params_present
    b.trailing()
    return b.bytes()


def _tiling(w, h, tools):
    """The tile grid of a frame under `tools` (uniform spacing, as
    obu.py _parse_tiling computes it): ([col starts], [row starts]) in
    pixels, each list ending at the frame's edge, and (max_log2_cols,
    max_log2_rows)."""
    sb = 128 if tools.sb128 else 64
    sbw = -(-w // sb)
    sbh = -(-h // sb)
    lc, lr = tools.tiles
    max_cols = _tile_log2(1, min(sbw, 64))
    max_rows = _tile_log2(1, min(sbh, 64))
    assert _tile_log2(4096 // sb, sbw) == 0, "more tile columns than one"
    assert _tile_log2(4096 * 2304 // (sb * sb), sbw * sbh) == 0
    assert lc <= max_cols and lr <= max_rows, (tools.tiles, max_cols, max_rows)
    tw = 1 + ((sbw - 1) >> lc)
    th = 1 + ((sbh - 1) >> lr)
    cols = [min(x * sb, w) for x in range(0, sbw, tw)] + [w]
    rows = [min(y * sb, h) for y in range(0, sbh, th)] + [h]
    return cols, rows, (max_cols, max_rows)


def _frame_tail(b, w, h, rng, *, key, q, layout, intrabc=False, inter=None,
                tools=DEFAULT_TOOLS):
    """Everything from tile_info() to film_grain_params() (obu.py
    parse_frame_hdr from _parse_tiling on). A 4:0:0 frame codes no chroma
    field (delta q, filter levels, CDEF strengths, LR types). With intrabc
    the in-loop filter parameters and delta lf are not coded; `inter` (a
    dict: skip_mode None or the skip_mode_present bit, warped None or the
    allow_warped_motion bit, gmv the seven (type, params) of _put_gmv)
    writes an inter frame's compound, warp and global motion fields,
    reference_select on. `tools` (Tools) adds the tiles, segmentation,
    delta q/lf, loop filter deltas, transform mode and LR unit size."""
    # tile_info: uniform spacing
    cols, rows, (max_log2_cols, max_log2_rows) = _tiling(w, h, tools)
    b.put(1, 1)  # uniform_tile_spacing_flag
    for lg, mx in zip(tools.tiles, (max_log2_cols, max_log2_rows)):
        b.put((1 << lg) - 1, lg)  # increment_tile_{cols,rows}_log2
        if lg < mx:
            b.put(0, 1)
    if sum(tools.tiles):
        n_tiles = (len(cols) - 1) * (len(rows) - 1)
        b.put(int(rng.integers(0, n_tiles)), sum(tools.tiles))
        b.put(3, 2)  # tile_size_bytes_minus_1: 4-byte tile sizes
    chroma = layout != PixelLayout.I400
    # quantization_params
    b.put(q, 8)  # base_q_idx
    b.put(0, 1)  # DeltaQYDc
    if chroma:
        b.put(0, 1)  # DeltaQUDc
        b.put(0, 1)  # DeltaQUAc
    b.put(0, 1)  # using_qmatrix
    b.put(1 if tools.segmentation else 0, 1)  # segmentation_enabled
    if tools.segmentation:
        # primary_ref_frame is none: update_map and update_data implied
        lossless = int(rng.integers(0, 8))
        for i in range(8):
            dq = -q if i == lossless else int(rng.integers(-40, 41))
            b.put(1, 1)  # feature_enabled: alt_q
            b.sbits(dq, 9)
            for lf in rng.integers(-63, 64, size=4):  # alt_lf_y_v .. v
                b.put(1, 1)
                b.sbits(int(lf), 7)
            b.put(0, 3)  # ref_frame, skip, globalmv features off
    b.put(1 if tools.delta_q else 0, 1)  # delta_q_present
    if tools.delta_q:
        b.put(int(rng.integers(0, 4)), 2)  # delta_q_res
        if not intrabc:
            b.put(1, 1)  # delta_lf_present
            b.put(int(rng.integers(0, 4)), 2)  # delta_lf_res
            b.put(1 if tools.delta_lf_multi else 0, 1)  # delta_lf_multi
    if not intrabc:  # intra block copy turns the in-loop filters off
        # loop_filter_params: nonzero levels on every plane and direction
        for lv in rng.integers(8, 40, size=4)[: 4 if chroma else 2]:
            b.put(int(lv), 6)
        b.put(int(rng.integers(0, 8)), 3)  # loop_filter_sharpness
        b.put(1 if tools.lf_deltas else 0, 1)  # loop_filter_delta_enabled
        if tools.lf_deltas:
            b.put(1, 1)  # loop_filter_delta_update
            for d in rng.integers(-32, 33, size=10):  # 8 ref, 2 mode deltas
                b.put(1, 1)  # update_{ref,mode}_delta
                b.sbits(int(d), 7)
        # cdef_params: cdef_bits = 3, eight nonzero strength pairs
        b.put(int(rng.integers(0, 4)), 2)  # cdef_damping_minus_3
        b.put(3, 2)  # cdef_bits
        for _ in range(8):
            b.put(int(rng.integers(1, 64)), 6)  # cdef_y strength
            uv = int(rng.integers(1, 64))
            if chroma:
                b.put(uv, 6)  # cdef_uv strength
        # lr_params: switchable on every plane
        for _ in range(3 if chroma else 1):
            b.put(1, 2)  # lr_type: RESTORE_SWITCHABLE
        b.put(tools.lr_unit_shift, 1)  # lr_unit_shift
        if tools.lr_unit_shift and not tools.sb128:
            b.put(0, 1)  # lr_unit_extra_shift
        if layout == PixelLayout.I420:
            b.put(tools.lr_unit_shift, 1)  # lr_uv_shift
    b.put(0 if tools.tx_mode_largest else 1, 1)  # tx_mode_select
    reduced_tx_set = 1 if tools.tx_mode_largest else 0
    if inter is not None:
        b.put(1, 1)  # reference_select
        if inter["skip_mode"] is not None:
            b.put(inter["skip_mode"], 1)  # skip_mode_present
        if inter["warped"] is not None:
            b.put(inter["warped"], 1)  # allow_warped_motion
        b.put(reduced_tx_set, 1)  # reduced_tx_set
        for g in inter["gmv"]:
            _put_gmv(b, *g)
        return
    if not key:
        b.put(0, 1)  # reference_select
        # skip_mode_present is not coded without order hints
    b.put(reduced_tx_set, 1)  # reduced_tx_set
    if not key:
        for _ in range(7):
            b.put(0, 1)  # is_global: identity


def _tile_group(b, w, h, rng, payload_bytes, tools):
    """The frame OBU's header bits `b` (byte-aligned after the frame
    header), then its tile group: with one tile, `payload_bytes` random
    bytes running to the end of the OBU; with several, the
    tile_start_and_end_present_flag (0), then each tile's random bytes,
    `payload_bytes` split by tile area, each but the last behind its
    4-byte size field."""
    cols, rows, _ = _tiling(w, h, tools)
    if len(cols) * len(rows) == 4:  # one tile
        tile = rng.integers(0, 256, size=payload_bytes, dtype=np.uint8)
        return b.bytes() + tile.tobytes()
    b.put(0, 1)  # tile_start_and_end_present_flag
    b.align()
    out = bytearray(b.bytes())
    tiles = [(y1 - y0) * (x1 - x0) for y0, y1 in zip(rows, rows[1:])
             for x0, x1 in zip(cols, cols[1:])]
    for i, area in enumerate(tiles):
        n = max(payload_bytes * area // (w * h), 16)
        if i < len(tiles) - 1:
            out += struct.pack("<I", n - 1)  # tile_size_minus_1
        out += rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    return bytes(out)


def _put_gmv(b, kind, params):
    """One reference's global motion (obu.py _parse_gmv, no primary
    reference frame): "identity", or "rotzoom" with (t0, t1, z, r): matrix
    [t0 << 10, t1 << 10, 65536 + 2z, 2r, -2r, 65536 + 2z]."""
    if kind == "identity":
        b.put(0, 1)  # is_global
        return
    assert kind == "rotzoom", kind
    t0, t1, z, r = params
    b.put(1, 1)  # is_global
    b.put(1, 1)  # is_rot_zoom
    b.subexp(z, 0, 12)
    b.subexp(r, 0, 12)
    b.subexp(t0, 0, 12)
    b.subexp(t1, 0, 12)


def _film_grain(b, rng, layout, *, inter=False, apply=True, update=True,
                ref_slots=()):
    """film_grain_params() (obu.py _parse_film_grain) of a shown frame:
    apply_grain, a random grain_seed and, on an inter frame, update_grain;
    without an update, film_grain_params_ref_idx, one of `ref_slots`.
    Otherwise random parameters within what the syntax allows: up to 14
    luma points and 10 points a chroma plane (x rising; both chroma planes
    with points or neither at 4:2:0, none at 4:2:0 without luma points),
    chroma_scaling_from_luma a quarter of the time, any scaling shift, AR
    lag 0-3 with coefficients over their whole range, AR and grain scale
    shifts, chroma multipliers and offsets, overlap_flag and
    clip_to_restricted_range."""
    b.put(1 if apply else 0, 1)  # apply_grain
    if not apply:
        return
    b.put(int(rng.integers(0, 1 << 16)), 16)  # grain_seed
    if inter:
        b.put(1 if update else 0, 1)  # update_grain
        if not update:
            b.put(int(rng.choice(ref_slots)), 3)  # film_grain_params_ref_idx
            return

    def points(n):
        xs = np.sort(rng.choice(256, size=n, replace=False))
        for x, y in zip(xs, rng.integers(0, 256, size=n)):
            b.put(int(x), 8)  # point_{y,cb,cr}_value
            b.put(int(y), 8)  # point_{y,cb,cr}_scaling

    num_y = max(int(rng.integers(-2, 15)), 0)
    b.put(num_y, 4)  # num_y_points
    points(num_y)
    mono = layout == PixelLayout.I400
    cfl = False
    if not mono:
        cfl = bool(rng.integers(0, 4) == 0)
        b.put(1 if cfl else 0, 1)  # chroma_scaling_from_luma
    num_uv = [0, 0]
    if not (mono or cfl or (layout == PixelLayout.I420 and num_y == 0)):
        num_uv[0] = int(rng.integers(0, 11))
        if layout == PixelLayout.I420:  # both planes with points or neither
            num_uv[1] = int(rng.integers(1, 11)) if num_uv[0] else 0
        else:
            num_uv[1] = int(rng.integers(0, 11))
        for n in num_uv:
            b.put(n, 4)  # num_cb_points, num_cr_points
            points(n)
    b.put(int(rng.integers(0, 4)), 2)  # grain_scaling_minus_8
    lag = int(rng.integers(0, 4))
    b.put(lag, 2)  # ar_coeff_lag
    num_pos = 2 * lag * (lag + 1)
    if num_y:
        for c in rng.integers(0, 256, size=num_pos):
            b.put(int(c), 8)  # ar_coeffs_y_plus_128
    for n in num_uv:
        if n or cfl:
            for c in rng.integers(0, 256, size=num_pos + (1 if num_y else 0)):
                b.put(int(c), 8)  # ar_coeffs_{cb,cr}_plus_128
    b.put(int(rng.integers(0, 4)), 2)  # ar_coeff_shift_minus_6
    b.put(int(rng.integers(0, 4)), 2)  # grain_scale_shift
    for n in num_uv:
        if n:
            b.put(int(rng.integers(0, 256)), 8)  # {cb,cr}_mult
            b.put(int(rng.integers(0, 256)), 8)  # {cb,cr}_luma_mult
            b.put(int(rng.integers(0, 512)), 9)  # {cb,cr}_offset
    b.put(int(rng.integers(0, 2)), 1)  # overlap_flag
    b.put(int(rng.integers(0, 2)), 1)  # clip_to_restricted_range


def _skip_mode_allowed(ref_hints, cur):
    """obu.py _parse_skip_mode's test, for order hints that do not wrap."""
    before = [x for x in ref_hints if x < cur]
    if before and any(x > cur for x in ref_hints):
        return True
    return bool(before) and any(x < max(before) for x in ref_hints)


def _frame_obu(w, h, rng, *, reduced, key, q, payload_bytes, superres,
               layout=PixelLayout.I420, refresh=0xFF, order_hint=None,
               intrabc=False, tools=DEFAULT_TOOLS):
    b = _Bits()
    if not reduced:
        b.put(0, 1)  # show_existing_frame
        b.put(0 if key else 1, 2)  # frame_type: KEY / INTER
        b.put(1, 1)  # show_frame
        if not key:
            b.put(1, 1)  # error_resilient_mode
    b.put(0, 1)  # disable_cdf_update
    b.put(1 if key else 0, 1)  # allow_screen_content_tools
    if key:
        b.put(0, 1)  # force_integer_mv (seq adaptive)
    if not reduced:
        b.put(0, 1)  # frame_size_override_flag
    if order_hint is not None:
        b.put(order_hint, ORDER_HINT_BITS)  # order_hint
    if not key:
        b.put(refresh, 8)  # refresh_frame_flags
        for _ in range(7):
            b.put(0, 3)  # ref_frame_idx: all slot 0 (the key frame)
    if superres:
        b.put(1, 1)  # use_superres
        b.put(0, 3)  # coded_denom: 9/8
    b.put(0, 1)  # render_and_frame_size_different
    if key:
        if not superres:
            b.put(1 if intrabc else 0, 1)  # allow_intrabc
    else:
        b.put(0, 1)  # allow_high_precision_mv
        b.put(1, 1)  # is_filter_switchable
        b.put(0, 1)  # is_motion_mode_switchable
    if not reduced:
        b.put(0, 1)  # disable_frame_end_update_cdf
    _frame_tail(b, w, h, rng, key=key, q=q, layout=layout, intrabc=intrabc,
                tools=tools)
    if tools.film_grain:
        _film_grain(b, rng, layout, inter=not key, ref_slots=(0,))
    b.align()  # byte_alignment() before the tile group
    return _obu(OBU_FRAME, _tile_group(b, w, h, rng, payload_bytes, tools))


def _check_tools(tools, layout, superres):
    """The combinations the writers support: several tiles or 128-px
    superblocks only without superres (tile info is written for the
    upscaled width), and one tile in 4:2:2 (_fit_422 redraws one tile)."""
    assert isinstance(tools, Tools), tools
    if superres:
        assert tools.tiles == (0, 0) and not tools.sb128, tools
    if layout == PixelLayout.I422:
        assert tools.tiles == (0, 0), tools


def still_picture(w, h, seed, *, bpc=8, layout=PixelLayout.I420,
                  superres=False, tools=DEFAULT_TOOLS):
    """One temporal unit: TD + sequence header + one key frame OBU whose
    tile payload is `numpy.random.default_rng(seed)` bytes, about one byte
    per two pixels (random symbols consume more than real ones). `bpc` is
    8, 10 or 12, `layout` a headers.PixelLayout; `superres` codes the
    frame at 8/9 of its width and upscales it; `tools` (Tools) turns on
    header tools."""
    _check_tools(tools, layout, superres)
    rng = np.random.default_rng(seed)
    q = int(rng.integers(60, 160))
    seq = _seq_header(w, h, reduced=True, bpc=bpc, superres=superres,
                      layout=layout, sb128=tools.sb128,
                      film_grain=tools.film_grain)
    payload = max(w * h // 2, 256)
    frame = _frame_obu(w, h, rng, reduced=True, key=True, q=q,
                       payload_bytes=payload, superres=superres,
                       layout=layout, tools=tools)
    data = _obu(OBU_TD, b"") + _obu(OBU_SEQ_HDR, seq) + frame
    if layout == PixelLayout.I422:
        (data,) = _fit_422([data], payload, seed)
    return data


def key_then_inter(w, h, seed):
    """Two temporal units: a key frame, then an error-resilient inter
    frame that predicts from it with one reference per block and the
    8-tap filters (no order hints, no compound, no motion modes)."""
    rng = np.random.default_rng(seed)
    seq = _seq_header(w, h, reduced=False, bpc=8, superres=False)
    key = _frame_obu(w, h, rng, reduced=False, key=True, q=100,
                     payload_bytes=max(w * h // 2, 256), superres=False)
    inter = _frame_obu(w, h, rng, reduced=False, key=False, q=100,
                       payload_bytes=max(w * h // 2, 256), superres=False)
    return [_obu(OBU_TD, b"") + _obu(OBU_SEQ_HDR, seq) + key,
            _obu(OBU_TD, b"") + inter]


def _inter_frame_obu(w, h, rng, *, q, payload_bytes, order_hint, refresh,
                     refidx, slot_hints, error_resilient, filt, gmv, layout,
                     superres=None, tools=DEFAULT_TOOLS, grain=None):
    """An inter frame of inter_sequence: no primary reference frame,
    switchable motion modes, reference_select, `filt` the frame's
    interpolation filter (None: switchable per block), `gmv` seven
    _put_gmv arguments, `slot_hints` the order hints of the eight slots,
    `superres` None where the sequence disables superres, else the
    frame's use_superres; `tools` a Tools; `grain` _film_grain's apply,
    update and ref_slots where tools.film_grain is on."""
    b = _Bits()
    b.put(0, 1)  # show_existing_frame
    b.put(1, 2)  # frame_type: INTER
    b.put(1, 1)  # show_frame
    b.put(error_resilient, 1)  # error_resilient_mode
    b.put(0, 1)  # disable_cdf_update
    b.put(0, 1)  # allow_screen_content_tools
    b.put(0, 1)  # frame_size_override_flag
    b.put(order_hint, ORDER_HINT_BITS)  # order_hint
    if not error_resilient:
        b.put(7, 3)  # primary_ref_frame: none
    b.put(refresh, 8)  # refresh_frame_flags
    if error_resilient:
        for hint in slot_hints:
            b.put(hint, ORDER_HINT_BITS)  # ref_order_hint[i]
    b.put(0, 1)  # frame_refs_short_signaling
    for r in refidx:
        b.put(r, 3)  # ref_frame_idx
    if superres is not None:
        b.put(1 if superres else 0, 1)  # use_superres
        if superres:
            b.put(0, 3)  # coded_denom: 9/8
    b.put(0, 1)  # render_and_frame_size_different
    b.put(1, 1)  # allow_high_precision_mv
    if filt is None:
        b.put(1, 1)  # is_filter_switchable
    else:
        b.put(0, 1)
        b.put(filt, 2)  # interpolation_filter
    b.put(1, 1)  # is_motion_mode_switchable
    b.put(0, 1)  # disable_frame_end_update_cdf
    skip = _skip_mode_allowed([slot_hints[r] for r in refidx], order_hint)
    _frame_tail(b, w, h, rng, key=False, q=q, layout=layout, inter=dict(
        skip_mode=1 if skip else None,
        warped=None if error_resilient else 1, gmv=gmv), tools=tools)
    if tools.film_grain:
        _film_grain(b, rng, layout, inter=True, **grain)
    b.align()
    return _obu(OBU_FRAME, _tile_group(b, w, h, rng, payload_bytes, tools))


def inter_sequence(w, h, seed, *, bpc=8, layout=PixelLayout.I420,
                   superres=False, intrabc=False, tools=DEFAULT_TOOLS):
    """Three temporal units with every inter tool of the layout: the
    sequence header turns on interintra, masked compound, warped motion,
    dual filter and order hints with distance-weighted compound. Then

    - a key frame (order hint 0; with `intrabc`, intra block copy is
      allowed, which sends it to the host path of the engine);
    - inter frame 1 (hint 1), predicting from the key frame only:
      switchable and dual interpolation filters, compound references,
      switchable motion modes (OBMC, local warp), ROTZOOM global motion on
      two references; it refreshes slots 0-3;
    - inter frame 2 (hint 2, error resilient): the BILINEAR filter, its
      references mixing frame 1 (slots 0-3) and the key frame (4-7), skip
      mode present.

    `bpc` is 8, 10 or 12 and `layout` a headers.PixelLayout. With
    `superres` the key frame is coded at 8/9 of its width and upscaled,
    frames 1 and 2 are not, and a fourth temporal unit follows: inter
    frame 3 (hint 3), coded with superres, so that every reference it
    reads is scaled (which sends it to the host path of the engine).

    `tools` (Tools) turns on header tools in every frame. Tile payloads
    are `numpy.random.default_rng(seed)` bytes."""
    _check_tools(tools, layout, superres)
    rng = np.random.default_rng(seed)
    payload = max(w * h // 2, 256)
    seq = _seq_header(w, h, reduced=False, bpc=bpc, superres=superres,
                      layout=layout, inter_tools=True, sb128=tools.sb128,
                      film_grain=tools.film_grain)
    key = _frame_obu(w, h, rng, reduced=False, key=True,
                     q=int(rng.integers(60, 160)), payload_bytes=payload,
                     superres=superres, layout=layout, order_hint=0,
                     intrabc=intrabc, tools=tools)
    sr = False if superres else None
    g1 = g2 = g3 = None
    if tools.film_grain:
        # frame 1: grain three times in four, its parameters new or loaded
        # from the key frame; frames 2 and 3 (references 0, 4, 1, 5, 2, 6,
        # 3) load frame 1's (slots 0-3) or, where it has none, the key
        # frame's (slots 4-6); frame 3 may also update
        apply1 = bool(rng.integers(0, 4))
        g1 = dict(apply=apply1, update=bool(rng.integers(0, 2)),
                  ref_slots=(0, 1, 2, 3, 4, 5, 6))
        later = (0, 4, 1, 5, 2, 6, 3) if apply1 else (4, 5, 6)
        g2 = dict(update=False, ref_slots=later)
        g3 = dict(update=bool(rng.integers(0, 2)), ref_slots=later)
    ident = ("identity", ())
    gmv1 = [("rotzoom", (-70, 45, 60, -25)), ident, ident, ident,
            ("rotzoom", (33, -20, -40, 30)), ident, ident]
    f1 = _inter_frame_obu(w, h, rng, q=int(rng.integers(60, 160)),
                          payload_bytes=payload, order_hint=1, refresh=0x0F,
                          refidx=(0, 1, 2, 3, 4, 5, 6), slot_hints=[0] * 8,
                          error_resilient=0, filt=None, gmv=gmv1,
                          layout=layout, superres=sr, tools=tools, grain=g1)
    gmv2 = [ident, ("rotzoom", (50, 20, -30, -45)), ident, ident, ident,
            ident, ident]
    f2 = _inter_frame_obu(w, h, rng, q=int(rng.integers(60, 160)),
                          payload_bytes=payload, order_hint=2, refresh=0x00,
                          refidx=(0, 4, 1, 5, 2, 6, 3),
                          slot_hints=[1, 1, 1, 1, 0, 0, 0, 0],
                          error_resilient=1, filt=BILINEAR, gmv=gmv2,
                          layout=layout, superres=sr, tools=tools, grain=g2)
    out = [_obu(OBU_TD, b"") + _obu(OBU_SEQ_HDR, seq) + key,
           _obu(OBU_TD, b"") + f1, _obu(OBU_TD, b"") + f2]
    if superres:
        f3 = _inter_frame_obu(w, h, rng, q=int(rng.integers(60, 160)),
                              payload_bytes=payload, order_hint=3,
                              refresh=0x00, refidx=(0, 4, 1, 5, 2, 6, 3),
                              slot_hints=[1, 1, 1, 1, 0, 0, 0, 0],
                              error_resilient=1, filt=None, gmv=[ident] * 7,
                              layout=layout, superres=True, tools=tools,
                              grain=g3)
        out.append(_obu(OBU_TD, b"") + f3)
    if layout == PixelLayout.I422:
        out = _fit_422(out, payload, seed)
    return out


def _fit_422(packets, payload, seed):
    """Make random tiles valid 4:2:2: a 4:2:2 stream may not split a block
    vertically only (PARTITION_V, V4 and the T splits with a vertical
    cut), and random bytes decode such partitions often. Each packet
    ends in its one tile's `payload` bytes; parse the packets in order on
    the host path's syntax pass and, where a partition symbol is refused,
    redraw the tile bytes that symbol's decision read (the 16 stream bits
    below the range decoder's window after it), until the packet parses.
    The decisions before it read earlier bits and stay as they were."""
    from .decoder import DecodeError, Decoder, EAgain, Settings

    class _Syntax(Decoder):
        def _decode_dense(self, f):
            pass

    rng = np.random.default_rng([seed, 422])
    dec = _Syntax(Settings(apply_grain=False, logger=lambda msg: None),
                  host_path=True)
    out = []
    for data in packets:
        data = bytearray(data)
        base = len(data) - payload
        for _ in range(100000):
            try:
                dec.send_data(bytes(data))
                break
            except DecodeError as e:
                if "4:2:2" not in str(e):
                    raise
                pos, cnt = _msac_at(e.__cause__)
                b = 8 * pos - cnt - 15  # stream bit at the window's top
                lo = base + max((b - 16) // 8, 0)
                hi = min(base + (b - 1) // 8 + 1, len(data))
                data[lo:hi] = rng.integers(0, 256, size=hi - lo,
                                           dtype=np.uint8).tobytes()
        else:
            raise RuntimeError("no valid 4:2:2 tile found")
        try:
            dec.get_picture()
        except EAgain:
            pass
        out.append(bytes(data))
    return out


def _msac_at(exc):
    """(bytes read, window count) of the range decoder of the tile whose
    syntax pass raised `exc`: the innermost frame of its traceback with a
    tile state `ts` (recon/frame.py decode_frame_syntax)."""
    state = None
    tb = exc.__traceback__
    while tb is not None:
        ts = tb.tb_frame.f_locals.get("ts")
        if ts is not None and hasattr(ts, "msac"):
            state = getattr(ts.msac, "_s", ts.msac)
        tb = tb.tb_next
    return int(state.pos), int(state.cnt)


def smoke_stream(digests, name):
    """The packets of entry `name` of smoke_digests.json's "formats": a
    still_picture or an inter_sequence at the file's picture size, with the
    entry's seed, bit depth and layout."""
    e = digests["formats"][name]
    args = (digests["width"], digests["height"], e["seed"])
    kw = dict(bpc=e["bpc"], layout=PixelLayout[e["layout"]])
    if e["kind"] == "inter_sequence":
        return inter_sequence(*args, **kw)
    return [still_picture(*args, **kw)]


def uhd_stream(digests, name):
    """The packets of stream `name` of smoke_digests.json's "uhd": a
    still_picture or an inter_sequence at that section's picture size
    (3840x2160), with the entry's seed, bit depth, layout and tile columns
    and rows (log2)."""
    uhd = digests["uhd"]
    e = uhd["streams"][name]
    args = (uhd["width"], uhd["height"], e["seed"])
    kw = dict(bpc=e["bpc"], layout=PixelLayout[e["layout"]],
              tools=Tools(tiles=tuple(e["tiles"])))
    if e["kind"] == "inter_sequence":
        return inter_sequence(*args, **kw)
    return [still_picture(*args, **kw)]


def grain_stream(digests, name):
    """The packets of stream `name` of smoke_digests.json's "grain": a
    still_picture or an inter_sequence with film grain parameters
    (Tools(film_grain=True)), at the entry's picture size, seed, bit depth
    and layout."""
    e = digests["grain"]["streams"][name]
    args = (e["width"], e["height"], e["seed"])
    kw = dict(bpc=e["bpc"], layout=PixelLayout[e["layout"]],
              tools=Tools(film_grain=True))
    if e["kind"] == "inter_sequence":
        return inter_sequence(*args, **kw)
    return [still_picture(*args, **kw)]


def write_ivf(path, packets, w, h):
    """Write `packets` (one temporal unit each) to an IVF file at `path`:
    the 32-byte DKIF header (version 0, fourcc AV01, w x h, time base
    1/25, the frame count), then each packet behind its 12-byte frame
    header (its size, and its index as the timestamp)."""
    with open(path, "wb") as fh:
        fh.write(struct.pack("<4sHH4sHHIII4x", b"DKIF", 0, 32, b"AV01", w,
                             h, 25, 1, len(packets)))
        for i, data in enumerate(packets):
            fh.write(struct.pack("<IQ", len(data), i))
            fh.write(data)


def picture_md5(pic):
    """MD5 over the visible planes (the md5 muxer's digest)."""
    import hashlib

    m = hashlib.md5()
    for rows in pic.iter_plane_rows():
        m.update(rows)
    return m.hexdigest()


def stream_md5(packets):
    """The md5 muxer's digest of a stream (what `--verify` checks): MD5
    over every picture's visible planes in output order, decoded on the
    port's host path."""
    import hashlib

    from .decoder import Decoder, EAgain, Settings

    dec = Decoder(Settings(apply_grain=False), host_path=True)
    m = hashlib.md5()
    for data in packets:
        dec.send_data(data)
        while True:
            try:
                pic = dec.get_picture()
            except EAgain:
                break
            for rows in pic.iter_plane_rows():
                m.update(rows)
    return m.hexdigest()


def decode_md5s(dec, packets, eagain=None):
    """Feed `packets` to a decoder with the rav1d_tpu API; MD5 per picture.
    After the last packet, the drain handshake: get_picture until two calls
    in a row raise, so a decoder with an output ring gives its last
    pictures too. `eagain` is the class get_picture raises when no picture
    is ready (default: this package's EAgain)."""
    if eagain is None:
        from .decoder import EAgain as eagain

    out = []
    for data in packets:
        dec.send_data(data)
        while True:
            try:
                out.append(picture_md5(dec.get_picture()))
            except eagain:
                break
    misses = 0
    while misses < 2:
        try:
            out.append(picture_md5(dec.get_picture()))
            misses = 0
        except eagain:
            misses += 1
    return out


def capture_frames(packets, md5s=None, device=None):
    """Decode on the port's host path and return each frame's context as
    its dense pass starts (syntax done, work items materialized), with the
    planner's plan (None where the planner sends the frame to the host):
    [(f, plan)]. Each frame's dense pass then runs on the host as usual;
    the pictures' MD5s are appended to the list `md5s` if one is given.
    With `device`, the dense passes run on the engine there instead (at
    frame delay 1), each on the plan captured, so the planner runs once a
    frame; a frame that the planner or the packer declines runs on the
    host path, as in any engine decode."""
    from .decoder import Decoder, Settings
    from .engine import plan as PL
    from .recon.frame import materialize_work_items

    got = []

    class _Capture(Decoder):
        def _decode_dense(self, f):
            materialize_work_items(f)
            plan = PL.build_plan(f._dense_args[0], f)
            got.append((f, plan))
            real = PL.build_plan
            PL.build_plan = lambda t, f_: plan  # engine.run_dense's planner
            try:
                super()._decode_dense(f)
            finally:
                PL.build_plan = real

    if device is None:
        dec = _Capture(Settings(apply_grain=False), host_path=True)
    else:
        dec = _Capture(Settings(apply_grain=False, max_frame_delay=1),
                       device=device)
    out = decode_md5s(dec, packets)
    if md5s is not None:
        md5s += out
    return got


def features(f, plan):
    """What a captured frame exercises: item counts per intra tool, LR
    stripe chunks per kind, chunks of the 32- and 64-point transform
    classes, and the filled lanes of each transform class ("WxH": N); for
    an inter frame also the tiles of each inter slot ("inter_tiles", every
    slot of engine/layout.py SLOTS), the interintra wave items, and the
    compound and OBMC lap pool rows the frame fills beside the inter
    program's capacity, (8 * psz) // 64 rows each."""
    from .engine.layout import (
        B_ROW, C_R0, C_R1, D_FLAT0, INTER0, LR0, NBLEND, NCOMB, NPUT, R0,
        SIZES, SLOTS, TB,
    )
    from .engine.pack import pack_frame
    from .engine.plan import MODE_CFL_DC
    from .syntax.levels import FILTER_PRED, Z1_PRED, Z2_PRED, Z3_PRED

    pack = pack_frame(f, plan)
    hdr = pack.hdr
    modes = {}
    for it in plan.items:
        modes[it.mode] = modes.get(it.mode, 0) + 1
    lr = {kind: sum(int(hdr[LR0 + 2 * (4 * pl + ki) + 1]) for pl in range(3))
          for ki, kind in enumerate(("wiener", "sgr5x5", "sgr3x3", "sgrmix"))}
    big = sum(int(hdr[R0 + 2 * si + 1]) for si, (w, h) in enumerate(SIZES)
              if max(w, h) >= 32)
    inter = {}
    if pack.srcs is not None:
        parts = dict(pack.blob.parts)

        def rows(name, nrows):
            """Every lane of the slot's chunks (padding lanes are zero)."""
            n = int(hdr[INTER0 + 2 * SLOTS[name] + 1])
            if not n:
                return np.zeros((nrows, 0), np.int32)
            d = parts[int(hdr[INTER0 + 2 * SLOTS[name]])]
            return d.reshape(n, nrows, TB).transpose(1, 0, 2).reshape(nrows, -1)

        used = [0]  # the combines read every prep and host tile's row
        for name in ("avg", "segy00", "segy10", "segy11", "mask", "seguv"):
            d = rows(name, NCOMB)
            used += [int(d[C_R0].max(initial=-1)) + 1,
                     int(d[C_R1].max(initial=-1)) + 1]
        laps = [int(rows(n, NPUT)[D_FLAT0].max(initial=-64)) // 64 + 1
                for n in ("lapY", "lapC")]
        laps.append(int(rows("blend", NBLEND)[B_ROW].max(initial=-1)) + 1)
        runs = pack.inter_runs
        inter = {
            "inter_tiles": {name: sum(r.n for r in runs.get(name, ()))
                            for name in SLOTS},
            "ii_items": sum(1 for it in plan.items if it.iioff >= 0),
            "pool_rows": max(used), "lap_rows": max(laps),
            "pool_cap": (8 * plan.ah * plan.aw) // 64,
        }
    return dict(inter, **{
        "items": len(plan.items), "waves": plan.n_waves,
        "palette": len(plan.pal),
        "filter": modes.get(FILTER_PRED, 0),
        "directional": sum(modes.get(m, 0) for m in (Z1_PRED, Z2_PRED, Z3_PRED)),
        "cfl": sum(v for m, v in modes.items() if m >= MODE_CFL_DC),
        "lr_chunks": lr, "tx32_64_chunks": big,
        "tx_lanes": {"%dx%d" % SIZES[k]: n for k, n in pack.tx_valid.items()
                     if k != "wht"},
    })
