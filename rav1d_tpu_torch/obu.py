"""OBU (Open Bitstream Unit) parser: sequence/frame headers, tile groups.

Behavior parity: reference src/obu.rs (rav1d_parse_obus, parse_seq_hdr at
obu.rs:129, parse_frame_hdr at obu.rs:1737, parse_tile_grp at obu.rs:2207).
Pure Python: this is control plane (a few hundred bits per frame).
"""

from __future__ import annotations

from dataclasses import dataclass

from .bits import GetBits, ulog2
from .headers import (
    AdaptiveBoolean,
    Cdef,
    ChromaSamplePosition,
    ContentLightLevel,
    Delta,
    DeltaLf,
    DeltaQ,
    FilmGrain,
    FilmGrainData,
    FilterMode,
    FrameHeader,
    FrameSize,
    FrameType,
    ITUTT35,
    Loopfilter,
    MasteringDisplay,
    ModeRefDeltas,
    ObuType,
    OperatingPoint,
    OperatingParameterInfo,
    PixelLayout,
    Profile,
    Quant,
    Restoration,
    RestorationType,
    Segmentation,
    SegmentationData,
    SegmentationDataSet,
    SequenceHeader,
    SkipMode,
    SuperRes,
    Tiling,
    TxfmMode,
    WarpedMotionParams,
    WarpedMotionType,
    get_poc_diff,
    MAX_TILE_COLS,
    MAX_TILE_ROWS,
    PRIMARY_REF_NONE,
    REFS_PER_FRAME,
)

MAX_CDEF_STRENGTHS = 8


class ParseError(ValueError):
    pass


def iclip_u8(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def parse_seq_hdr(gb: GetBits, strict_std_compliance: bool = False) -> SequenceHeader:
    """Parse a sequence header OBU payload (ref: src/obu.rs:129 parse_seq_hdr)."""
    h = SequenceHeader()
    try:
        h.profile = Profile(gb.get_bits(3))
    except ValueError:
        raise ParseError("bad profile")
    h.still_picture = gb.get_bit()
    h.reduced_still_picture_header = gb.get_bit()
    if h.reduced_still_picture_header and not h.still_picture:
        raise ParseError("reduced_still_picture_header without still_picture")

    if h.reduced_still_picture_header:
        h.num_operating_points = 1
        op = h.operating_points[0]
        op.major_level = gb.get_bits(3)
        op.minor_level = gb.get_bits(2)
        op.initial_display_delay = 10
    else:
        h.timing_info_present = gb.get_bit()
        if h.timing_info_present:
            h.num_units_in_tick = gb.get_bits(32)
            h.time_scale = gb.get_bits(32)
            if strict_std_compliance and (
                h.num_units_in_tick == 0 or h.time_scale == 0
            ):
                raise ParseError("bad timing info")
            h.equal_picture_interval = gb.get_bit()
            if h.equal_picture_interval:
                v = gb.get_vlc()
                if v == 0xFFFFFFFF:
                    raise ParseError("bad num_ticks_per_picture")
                h.num_ticks_per_picture = v + 1
            h.decoder_model_info_present = gb.get_bit()
            if h.decoder_model_info_present:
                h.encoder_decoder_buffer_delay_length = gb.get_bits(5) + 1
                h.num_units_in_decoding_tick = gb.get_bits(32)
                if strict_std_compliance and h.num_units_in_decoding_tick == 0:
                    raise ParseError("bad decoding tick")
                h.buffer_removal_delay_length = gb.get_bits(5) + 1
                h.frame_presentation_delay_length = gb.get_bits(5) + 1
        h.display_model_info_present = gb.get_bit()
        h.num_operating_points = gb.get_bits(5) + 1
        for i in range(h.num_operating_points):
            op = h.operating_points[i]
            op.idc = gb.get_bits(12)
            if op.idc and (not (op.idc & 0xFF) or not (op.idc & 0xF00)):
                raise ParseError("bad operating point idc")
            op.major_level = 2 + gb.get_bits(3)
            op.minor_level = gb.get_bits(2)
            if op.major_level > 3:
                op.tier = gb.get_bit()
            if h.decoder_model_info_present:
                op.decoder_model_param_present = gb.get_bit()
                if op.decoder_model_param_present:
                    opi = h.operating_parameter_info[i]
                    opi.decoder_buffer_delay = gb.get_bits(
                        h.encoder_decoder_buffer_delay_length
                    )
                    opi.encoder_buffer_delay = gb.get_bits(
                        h.encoder_decoder_buffer_delay_length
                    )
                    opi.low_delay_mode = gb.get_bit()
            if h.display_model_info_present:
                op.display_model_param_present = gb.get_bit()
            op.initial_display_delay = (
                gb.get_bits(4) + 1 if op.display_model_param_present else 10
            )

    h.width_n_bits = gb.get_bits(4) + 1
    h.height_n_bits = gb.get_bits(4) + 1
    h.max_width = gb.get_bits(h.width_n_bits) + 1
    h.max_height = gb.get_bits(h.height_n_bits) + 1
    if not h.reduced_still_picture_header:
        h.frame_id_numbers_present = gb.get_bit()
        if h.frame_id_numbers_present:
            h.delta_frame_id_n_bits = gb.get_bits(4) + 2
            h.frame_id_n_bits = gb.get_bits(3) + h.delta_frame_id_n_bits + 1

    h.sb128 = gb.get_bit()
    h.filter_intra = gb.get_bit()
    h.intra_edge_filter = gb.get_bit()
    if h.reduced_still_picture_header:
        h.screen_content_tools = AdaptiveBoolean.ADAPTIVE
        h.force_integer_mv = AdaptiveBoolean.ADAPTIVE
    else:
        h.inter_intra = gb.get_bit()
        h.masked_compound = gb.get_bit()
        h.warped_motion = gb.get_bit()
        h.dual_filter = gb.get_bit()
        h.order_hint = gb.get_bit()
        if h.order_hint:
            h.jnt_comp = gb.get_bit()
            h.ref_frame_mvs = gb.get_bit()
        h.screen_content_tools = (
            AdaptiveBoolean.ADAPTIVE
            if gb.get_bit()
            else AdaptiveBoolean(gb.get_bit())
        )
        if h.screen_content_tools != AdaptiveBoolean.OFF:
            h.force_integer_mv = (
                AdaptiveBoolean.ADAPTIVE
                if gb.get_bit()
                else AdaptiveBoolean(gb.get_bit())
            )
        else:
            h.force_integer_mv = AdaptiveBoolean.ADAPTIVE
        if h.order_hint:
            h.order_hint_n_bits = gb.get_bits(3) + 1
    h.super_res = gb.get_bit()
    h.cdef = gb.get_bit()
    h.restoration = gb.get_bit()

    h.hbd = gb.get_bit()
    if h.profile == Profile.PROFESSIONAL and h.hbd:
        h.hbd += gb.get_bit()
    if h.profile != Profile.HIGH:
        h.monochrome = gb.get_bit()
    h.color_description_present = gb.get_bit()
    if h.color_description_present:
        h.pri = gb.get_bits(8)
        h.trc = gb.get_bits(8)
        h.mtrx = gb.get_bits(8)
    else:
        h.pri = h.trc = h.mtrx = 2  # unknown

    # color config (pri=1/trc=13/mtrx=0 is the sRGB triplet)
    if h.monochrome:
        h.color_range = gb.get_bit()
        h.layout = PixelLayout.I400
        h.ss_hor = h.ss_ver = 1
        h.chr = ChromaSamplePosition.UNKNOWN
    elif h.pri == 1 and h.trc == 13 and h.mtrx == 0:
        h.layout = PixelLayout.I444
        h.color_range = 1
        if h.profile != Profile.HIGH and not (
            h.profile == Profile.PROFESSIONAL and h.hbd == 2
        ):
            raise ParseError("sRGB requires 4:4:4-capable profile")
    else:
        h.color_range = gb.get_bit()
        if h.profile == Profile.MAIN:
            h.layout = PixelLayout.I420
            h.ss_hor = h.ss_ver = 1
        elif h.profile == Profile.HIGH:
            h.layout = PixelLayout.I444
        else:
            if h.hbd == 2:
                h.ss_hor = gb.get_bit()
                if h.ss_hor:
                    h.ss_ver = gb.get_bit()
            else:
                h.ss_hor = 1
            h.layout = (
                (PixelLayout.I420 if h.ss_ver else PixelLayout.I422)
                if h.ss_hor
                else PixelLayout.I444
            )
        if h.ss_hor & h.ss_ver:
            h.chr = ChromaSamplePosition(gb.get_bits(2))
    if strict_std_compliance and h.mtrx == 0 and h.layout != PixelLayout.I444:
        raise ParseError("identity matrix requires 4:4:4")
    if not h.monochrome:
        h.separate_uv_delta_q = gb.get_bit()
    h.film_grain_present = gb.get_bit()
    gb.get_bit()  # dummy bit
    return h


def parse_sequence_header(data: bytes) -> SequenceHeader:
    """Scan a buffer of OBUs for a sequence header (dav1d_parse_sequence_header)."""
    res = None
    pos = 0
    while pos < len(data):
        gb = GetBits(data[pos:])
        gb.get_bit()
        obu_type = gb.get_bits(4)
        has_extension = gb.get_bit()
        has_length_field = gb.get_bit()
        gb.get_bits(1 + has_extension * 8)
        if has_length_field:
            length = gb.get_uleb128()
            obu_end = gb.byte_pos + length
            if obu_end > len(data) - pos:
                raise ParseError("OBU overruns buffer")
        else:
            obu_end = len(data) - pos
        if obu_type == ObuType.SEQ_HDR:
            res = parse_seq_hdr(gb, False)
            if gb.byte_pos > obu_end:
                raise ParseError("seq hdr overrun")
        if gb.error:
            raise ParseError("bit buffer overrun")
        pos += obu_end
    if res is None:
        raise ParseError("no sequence header found")
    return res


def _parse_frame_size(ctx, seqhdr: SequenceHeader, refidx, frame_size_override, gb):
    """ref: src/obu.rs:583 parse_frame_size."""
    if refidx is not None:
        for i in range(7):
            if gb.get_bit():
                ref_hdr = ctx.refs[refidx[i]].frame_hdr
                if ref_hdr is None:
                    raise ParseError("missing ref for frame size")
                ref_size = ref_hdr.size
                width1 = ref_size.width[1]
                height = ref_size.height
                enabled = bool(seqhdr.super_res and gb.get_bit())
                if enabled:
                    d = 9 + gb.get_bits(3)
                    width0 = max((width1 * 8 + (d >> 1)) // d, min(16, width1))
                else:
                    d = 8
                    width0 = width1
                return FrameSize(
                    width=(width0, width1),
                    height=height,
                    render_width=ref_size.render_width,
                    render_height=ref_size.render_height,
                    super_res=SuperRes(enabled=enabled, width_scale_denominator=d),
                    have_render_size=0,
                )
    if frame_size_override:
        width1 = gb.get_bits(seqhdr.width_n_bits) + 1
        height = gb.get_bits(seqhdr.height_n_bits) + 1
    else:
        width1 = seqhdr.max_width
        height = seqhdr.max_height
    enabled = bool(seqhdr.super_res and gb.get_bit())
    if enabled:
        d = 9 + gb.get_bits(3)
        width0 = max((width1 * 8 + (d >> 1)) // d, min(16, width1))
    else:
        d = 8
        width0 = width1
    have_render_size = gb.get_bit()
    if have_render_size:
        render_width = gb.get_bits(16) + 1
        render_height = gb.get_bits(16) + 1
    else:
        render_width = width1
        render_height = height
    return FrameSize(
        width=(width0, width1),
        height=height,
        render_width=render_width,
        render_height=render_height,
        super_res=SuperRes(enabled=enabled, width_scale_denominator=d),
        have_render_size=have_render_size,
    )


def _tile_log2(sz: int, tgt: int) -> int:
    k = 0
    while (sz << k) < tgt:
        k += 1
    return k


def _parse_refidx(ctx, seqhdr, frame_ref_short_signaling, frame_offset, frame_id, gb):
    """ref: src/obu.rs:691 parse_refidx."""
    refidx = [-1] * REFS_PER_FRAME
    if frame_ref_short_signaling:
        refidx[0] = gb.get_bits(3)
        refidx[3] = gb.get_bits(3)
        shifted_frame_offset = []
        current_frame_offset = 1 << (seqhdr.order_hint_n_bits - 1)
        for i in range(8):
            rh = ctx.refs[i].frame_hdr
            if rh is None:
                raise ParseError("missing ref in short signaling")
            shifted_frame_offset.append(
                current_frame_offset
                + get_poc_diff(seqhdr.order_hint_n_bits, rh.frame_offset, frame_offset)
            )
        used_frame = [0] * 8
        used_frame[refidx[0]] = 1
        used_frame[refidx[3]] = 1

        latest_frame_offset = -1
        for i in range(8):
            hint = shifted_frame_offset[i]
            if (
                not used_frame[i]
                and hint >= current_frame_offset
                and hint >= latest_frame_offset
            ):
                refidx[6] = i
                latest_frame_offset = hint
        if latest_frame_offset != -1:
            used_frame[refidx[6]] = 1

        for slot in (4, 5):
            earliest_frame_offset = 1 << 62
            for i in range(8):
                hint = shifted_frame_offset[i]
                if (
                    not used_frame[i]
                    and hint >= current_frame_offset
                    and hint < earliest_frame_offset
                ):
                    refidx[slot] = i
                    earliest_frame_offset = hint
            if earliest_frame_offset != 1 << 62:
                used_frame[refidx[slot]] = 1

        for i in range(1, 7):
            if refidx[i] < 0:
                latest_frame_offset = -1
                for j in range(8):
                    hint = shifted_frame_offset[j]
                    if (
                        not used_frame[j]
                        and hint < current_frame_offset
                        and hint >= latest_frame_offset
                    ):
                        refidx[i] = j
                        latest_frame_offset = hint
                if latest_frame_offset != -1:
                    used_frame[refidx[i]] = 1

        earliest_frame_offset = 1 << 62
        ref = -1
        for i in range(8):
            hint = shifted_frame_offset[i]
            if hint < earliest_frame_offset:
                ref = i
                earliest_frame_offset = hint
        for i in range(7):
            if refidx[i] < 0:
                refidx[i] = ref

    for i in range(7):
        if not frame_ref_short_signaling:
            refidx[i] = gb.get_bits(3)
        if seqhdr.frame_id_numbers_present:
            delta = gb.get_bits(seqhdr.delta_frame_id_n_bits)
            ref_frame_id = (frame_id + (1 << seqhdr.frame_id_n_bits) - delta - 1) & (
                (1 << seqhdr.frame_id_n_bits) - 1
            )
            rh = ctx.refs[refidx[i]].frame_hdr
            if rh is None or rh.frame_id != ref_frame_id:
                raise ParseError("ref frame id mismatch")
    return refidx


def _parse_tiling(seqhdr, size: FrameSize, gb) -> Tiling:
    """ref: src/obu.rs:817 parse_tiling."""
    t = Tiling()
    t.uniform = gb.get_bit()
    sbsz_min1 = (64 << seqhdr.sb128) - 1
    sbsz_log2 = 6 + seqhdr.sb128
    sbw = (size.width[0] + sbsz_min1) >> sbsz_log2
    sbh = (size.height + sbsz_min1) >> sbsz_log2
    max_tile_width_sb = 4096 >> sbsz_log2
    max_tile_area_sb = (4096 * 2304) >> (2 * sbsz_log2)
    t.min_log2_cols = _tile_log2(max_tile_width_sb, sbw)
    t.max_log2_cols = _tile_log2(1, min(sbw, MAX_TILE_COLS))
    t.max_log2_rows = _tile_log2(1, min(sbh, MAX_TILE_ROWS))
    min_log2_tiles = max(_tile_log2(max_tile_area_sb, sbw * sbh), t.min_log2_cols)
    if t.uniform:
        t.log2_cols = t.min_log2_cols
        while t.log2_cols < t.max_log2_cols and gb.get_bit():
            t.log2_cols += 1
        tile_w = 1 + ((sbw - 1) >> t.log2_cols)
        t.cols = 0
        sbx = 0
        while sbx < sbw:
            t.col_start_sb[t.cols] = sbx
            sbx += tile_w
            t.cols += 1
        min_log2_rows = max(min_log2_tiles - t.log2_cols, 0)
        t.log2_rows = min_log2_rows
        while t.log2_rows < t.max_log2_rows and gb.get_bit():
            t.log2_rows += 1
        tile_h = 1 + ((sbh - 1) >> t.log2_rows)
        t.rows = 0
        sby = 0
        while sby < sbh:
            t.row_start_sb[t.rows] = sby
            sby += tile_h
            t.rows += 1
    else:
        t.cols = 0
        widest_tile = 0
        max_tile_area_sb = sbw * sbh
        sbx = 0
        while sbx < sbw and t.cols < MAX_TILE_COLS:
            tile_width_sb = min(sbw - sbx, max_tile_width_sb)
            tile_w = 1 + gb.get_uniform(tile_width_sb) if tile_width_sb > 1 else 1
            t.col_start_sb[t.cols] = sbx
            sbx += tile_w
            widest_tile = max(widest_tile, tile_w)
            t.cols += 1
        t.log2_cols = _tile_log2(1, t.cols)
        if min_log2_tiles:
            max_tile_area_sb >>= min_log2_tiles + 1
        max_tile_height_sb = max(max_tile_area_sb // widest_tile, 1)
        t.rows = 0
        sby = 0
        while sby < sbh and t.rows < MAX_TILE_ROWS:
            tile_height_sb = min(sbh - sby, max_tile_height_sb)
            tile_h = 1 + gb.get_uniform(tile_height_sb) if tile_height_sb > 1 else 1
            t.row_start_sb[t.rows] = sby
            sby += tile_h
            t.rows += 1
        t.log2_rows = _tile_log2(1, t.rows)
    t.col_start_sb[t.cols] = sbw
    t.row_start_sb[t.rows] = sbh
    if t.log2_cols or t.log2_rows:
        t.update = gb.get_bits(t.log2_cols + t.log2_rows)
        if t.update >= t.cols * t.rows:
            raise ParseError("bad context update tile id")
        t.n_bytes = gb.get_bits(2) + 1
    else:
        t.update = 0
        t.n_bytes = 0
    return t


def _parse_quant(seqhdr, gb) -> Quant:
    q = Quant()
    q.yac = gb.get_bits(8)
    q.ydc_delta = gb.get_sbits(7) if gb.get_bit() else 0
    if not seqhdr.monochrome:
        diff_uv_delta = gb.get_bit() if seqhdr.separate_uv_delta_q else 0
        q.udc_delta = gb.get_sbits(7) if gb.get_bit() else 0
        q.uac_delta = gb.get_sbits(7) if gb.get_bit() else 0
        if diff_uv_delta:
            q.vdc_delta = gb.get_sbits(7) if gb.get_bit() else 0
            q.vac_delta = gb.get_sbits(7) if gb.get_bit() else 0
        else:
            q.vdc_delta = q.udc_delta
            q.vac_delta = q.uac_delta
    q.qm = gb.get_bit()
    if q.qm:
        q.qm_y = gb.get_bits(4)
        q.qm_u = gb.get_bits(4)
        q.qm_v = gb.get_bits(4) if seqhdr.separate_uv_delta_q else q.qm_u
    return q


def _parse_seg_data(gb) -> SegmentationDataSet:
    s = SegmentationDataSet()
    s.preskip = 0
    s.last_active_segid = -1
    for i in range(8):
        d = s.d[i]
        if gb.get_bit():
            d.delta_q = gb.get_sbits(9)
            s.last_active_segid = i
        else:
            d.delta_q = 0
        if gb.get_bit():
            d.delta_lf_y_v = gb.get_sbits(7)
            s.last_active_segid = i
        else:
            d.delta_lf_y_v = 0
        if gb.get_bit():
            d.delta_lf_y_h = gb.get_sbits(7)
            s.last_active_segid = i
        else:
            d.delta_lf_y_h = 0
        if gb.get_bit():
            d.delta_lf_u = gb.get_sbits(7)
            s.last_active_segid = i
        else:
            d.delta_lf_u = 0
        if gb.get_bit():
            d.delta_lf_v = gb.get_sbits(7)
            s.last_active_segid = i
        else:
            d.delta_lf_v = 0
        if gb.get_bit():
            d.ref = gb.get_bits(3)
            s.last_active_segid = i
            s.preskip = 1
        else:
            d.ref = -1
        d.skip = gb.get_bit()
        if d.skip:
            s.last_active_segid = i
            s.preskip = 1
        d.globalmv = gb.get_bit()
        if d.globalmv:
            s.last_active_segid = i
            s.preskip = 1
    return s


def _parse_segmentation(ctx, primary_ref_frame, refidx, quant, gb) -> Segmentation:
    import copy

    s = Segmentation()
    s.enabled = gb.get_bit()
    if s.enabled:
        if primary_ref_frame == PRIMARY_REF_NONE:
            s.update_map = 1
            s.temporal = 0
            s.update_data = 1
        else:
            s.update_map = gb.get_bit()
            s.temporal = gb.get_bit() if s.update_map else 0
            s.update_data = gb.get_bit()
        if s.update_data:
            s.seg_data = _parse_seg_data(gb)
        else:
            assert primary_ref_frame != PRIMARY_REF_NONE
            pri_ref = refidx[primary_ref_frame]
            rh = ctx.refs[pri_ref].frame_hdr
            if rh is None:
                raise ParseError("missing primary ref for segmentation")
            s.seg_data = copy.deepcopy(rh.segmentation.seg_data)
    else:
        s.seg_data = SegmentationDataSet()
        for d in s.seg_data.d:
            d.ref = -1
    delta_lossless = (
        quant.ydc_delta == 0
        and quant.udc_delta == 0
        and quant.uac_delta == 0
        and quant.vdc_delta == 0
        and quant.vac_delta == 0
    )
    for i in range(8):
        s.qidx[i] = (
            iclip_u8(quant.yac + s.seg_data.d[i].delta_q) if s.enabled else quant.yac
        )
        s.lossless[i] = int(s.qidx[i] == 0 and delta_lossless)
    return s


def _parse_delta(quant, allow_intrabc, gb) -> Delta:
    q_present = gb.get_bit() if quant.yac else 0
    q = DeltaQ(present=q_present, res_log2=gb.get_bits(2) if q_present else 0)
    lf_present = int(bool(q.present) and not allow_intrabc and bool(gb.get_bit()))
    lf = DeltaLf(
        present=lf_present,
        res_log2=gb.get_bits(2) if lf_present else 0,
        multi=gb.get_bit() if lf_present else 0,
    )
    return Delta(q=q, lf=lf)


def _parse_loopfilter(
    ctx, seqhdr, all_lossless, allow_intrabc, primary_ref_frame, refidx, gb
) -> Loopfilter:
    import copy

    lf = Loopfilter()
    if all_lossless or allow_intrabc:
        lf.level_y = [0, 0]
        lf.level_u = lf.level_v = 0
        lf.sharpness = 0
        lf.mode_ref_delta_enabled = 1
        lf.mode_ref_delta_update = 1
        lf.mode_ref_deltas = ModeRefDeltas()
    else:
        lf.level_y = [gb.get_bits(6), gb.get_bits(6)]
        if not seqhdr.monochrome and (lf.level_y[0] or lf.level_y[1]):
            lf.level_u = gb.get_bits(6)
            lf.level_v = gb.get_bits(6)
        lf.sharpness = gb.get_bits(3)
        if primary_ref_frame == PRIMARY_REF_NONE:
            lf.mode_ref_deltas = ModeRefDeltas()
        else:
            ref = refidx[primary_ref_frame]
            rh = ctx.refs[ref].frame_hdr
            if rh is None:
                raise ParseError("missing primary ref for loopfilter")
            lf.mode_ref_deltas = copy.deepcopy(rh.loopfilter.mode_ref_deltas)
        lf.mode_ref_delta_enabled = gb.get_bit()
        if lf.mode_ref_delta_enabled:
            lf.mode_ref_delta_update = gb.get_bit()
            if lf.mode_ref_delta_update:
                for i in range(8):
                    if gb.get_bit():
                        lf.mode_ref_deltas.ref_delta[i] = gb.get_sbits(7)
                for i in range(2):
                    if gb.get_bit():
                        lf.mode_ref_deltas.mode_delta[i] = gb.get_sbits(7)
    return lf


def _parse_cdef(seqhdr, all_lossless, allow_intrabc, gb) -> Cdef:
    c = Cdef()
    if not all_lossless and seqhdr.cdef and not allow_intrabc:
        c.damping = gb.get_bits(2) + 3
        c.n_bits = gb.get_bits(2)
        for i in range(1 << c.n_bits):
            c.y_strength[i] = gb.get_bits(6)
            if not seqhdr.monochrome:
                c.uv_strength[i] = gb.get_bits(6)
    else:
        c.n_bits = 0
        c.y_strength[0] = 0
        c.uv_strength[0] = 0
    return c


def _parse_restoration(
    seqhdr, all_lossless, super_res_enabled, allow_intrabc, gb
) -> Restoration:
    if (
        (not all_lossless or super_res_enabled)
        and seqhdr.restoration
        and not allow_intrabc
    ):
        type0 = RestorationType(gb.get_bits(2))
        if not seqhdr.monochrome:
            types = (
                type0,
                RestorationType(gb.get_bits(2)),
                RestorationType(gb.get_bits(2)),
            )
        else:
            types = (type0, RestorationType.NONE, RestorationType.NONE)
        if types == (RestorationType.NONE,) * 3:
            unit_size = (8, 0)
        else:
            us0 = 6 + seqhdr.sb128
            if gb.get_bit():
                us0 += 1
                if not seqhdr.sb128:
                    us0 += gb.get_bit()
            us1 = us0
            if (
                (types[1] != RestorationType.NONE or types[2] != RestorationType.NONE)
                and seqhdr.ss_hor == 1
                and seqhdr.ss_ver == 1
            ):
                us1 = us0 - gb.get_bit()
            unit_size = (us0, us1)
        return Restoration(type=types, unit_size=unit_size)
    return Restoration(type=(RestorationType.NONE,) * 3, unit_size=(0, 0))


def _parse_skip_mode(
    ctx, seqhdr, switchable_comp_refs, frame_type, frame_offset, refidx, gb
) -> SkipMode:
    sm = SkipMode()
    if switchable_comp_refs and frame_type.is_inter_or_switch and seqhdr.order_hint:
        poc = frame_offset
        off_before = 0xFFFFFFFF
        off_after = -1
        off_before_idx = 0
        off_after_idx = 0
        for i in range(7):
            rh = ctx.refs[refidx[i]].frame_hdr
            if rh is None:
                raise ParseError("missing ref for skip mode")
            refpoc = rh.frame_offset
            diff = get_poc_diff(seqhdr.order_hint_n_bits, refpoc, poc)
            if diff > 0:
                if (
                    off_after == -1
                    or get_poc_diff(seqhdr.order_hint_n_bits, off_after, refpoc) > 0
                ):
                    off_after = refpoc
                    off_after_idx = i
            elif diff < 0 and (
                off_before == 0xFFFFFFFF
                or get_poc_diff(seqhdr.order_hint_n_bits, refpoc, off_before) > 0
            ):
                off_before = refpoc
                off_before_idx = i
        if off_before != 0xFFFFFFFF and off_after != -1:
            sm.refs = (
                min(off_before_idx, off_after_idx),
                max(off_before_idx, off_after_idx),
            )
            sm.allowed = 1
        elif off_before != 0xFFFFFFFF:
            off_before2 = 0xFFFFFFFF
            off_before2_idx = 0
            for i in range(7):
                rh = ctx.refs[refidx[i]].frame_hdr
                refpoc = rh.frame_offset
                if get_poc_diff(seqhdr.order_hint_n_bits, refpoc, off_before) < 0:
                    if (
                        off_before2 == 0xFFFFFFFF
                        or get_poc_diff(seqhdr.order_hint_n_bits, refpoc, off_before2)
                        > 0
                    ):
                        off_before2 = refpoc
                        off_before2_idx = i
            if off_before2 != 0xFFFFFFFF:
                sm.refs = (
                    min(off_before_idx, off_before2_idx),
                    max(off_before_idx, off_before2_idx),
                )
                sm.allowed = 1
    sm.enabled = gb.get_bit() if sm.allowed else 0
    return sm


def _parse_gmv(ctx, frame_type, primary_ref_frame, refidx, hp, gb):
    gmv = [WarpedMotionParams() for _ in range(REFS_PER_FRAME)]
    if frame_type.is_inter_or_switch:
        for i, g in enumerate(gmv):
            if not gb.get_bit():
                g.type = WarpedMotionType.IDENTITY
            elif gb.get_bit():
                g.type = WarpedMotionType.ROT_ZOOM
            elif gb.get_bit():
                g.type = WarpedMotionType.TRANSLATION
            else:
                g.type = WarpedMotionType.AFFINE
            if g.type == WarpedMotionType.IDENTITY:
                continue
            if primary_ref_frame == PRIMARY_REF_NONE:
                ref_gmv = WarpedMotionParams()
            else:
                pri_ref = refidx[primary_ref_frame]
                rh = ctx.refs[pri_ref].frame_hdr
                if rh is None:
                    raise ParseError("missing primary ref for gmv")
                ref_gmv = rh.gmv[i]
            mat = g.matrix
            ref_mat = ref_gmv.matrix
            if g.type >= WarpedMotionType.ROT_ZOOM:
                mat[2] = (1 << 16) + 2 * gb.get_bits_subexp(
                    (ref_mat[2] - (1 << 16)) >> 1, 12
                )
                mat[3] = 2 * gb.get_bits_subexp(ref_mat[3] >> 1, 12)
                bits = 12
                shift = 10
            else:
                bits = 9 - (not hp)
                shift = 13 + (not hp)
            if g.type == WarpedMotionType.AFFINE:
                mat[4] = 2 * gb.get_bits_subexp(ref_mat[4] >> 1, 12)
                mat[5] = (1 << 16) + 2 * gb.get_bits_subexp(
                    (ref_mat[5] - (1 << 16)) >> 1, 12
                )
            else:
                mat[4] = -mat[3]
                mat[5] = mat[2]
            mat[0] = gb.get_bits_subexp(ref_mat[0] >> shift, bits) * (1 << shift)
            mat[1] = gb.get_bits_subexp(ref_mat[1] >> shift, bits) * (1 << shift)
    return gmv


def _parse_film_grain_data(seqhdr, seed, gb) -> FilmGrainData:
    fg = FilmGrainData(seed=seed)
    fg.num_y_points = gb.get_bits(4)
    if fg.num_y_points > 14:
        raise ParseError("too many y points")
    for i in range(fg.num_y_points):
        fg.y_points[i][0] = gb.get_bits(8)
        if i and fg.y_points[i - 1][0] >= fg.y_points[i][0]:
            raise ParseError("non-monotonic y points")
        fg.y_points[i][1] = gb.get_bits(8)
    fg.chroma_scaling_from_luma = bool(not seqhdr.monochrome and gb.get_bit())
    if (
        seqhdr.monochrome
        or fg.chroma_scaling_from_luma
        or (seqhdr.ss_ver == 1 and seqhdr.ss_hor == 1 and fg.num_y_points == 0)
    ):
        fg.num_uv_points = [0, 0]
    else:
        for pl in range(2):
            fg.num_uv_points[pl] = gb.get_bits(4)
            if fg.num_uv_points[pl] > 10:
                raise ParseError("too many uv points")
            for i in range(fg.num_uv_points[pl]):
                fg.uv_points[pl][i][0] = gb.get_bits(8)
                if i and fg.uv_points[pl][i - 1][0] >= fg.uv_points[pl][i][0]:
                    raise ParseError("non-monotonic uv points")
                fg.uv_points[pl][i][1] = gb.get_bits(8)
    if seqhdr.ss_hor == 1 and seqhdr.ss_ver == 1:
        if bool(fg.num_uv_points[0]) != bool(fg.num_uv_points[1]):
            raise ParseError("inconsistent uv points")
    fg.scaling_shift = gb.get_bits(2) + 8
    fg.ar_coeff_lag = gb.get_bits(2)
    num_y_pos = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
    if fg.num_y_points:
        for i in range(num_y_pos):
            fg.ar_coeffs_y[i] = ((gb.get_bits(8) - 128) + 128) % 256 - 128
    for pl in range(2):
        if fg.num_uv_points[pl] or fg.chroma_scaling_from_luma:
            num_uv_pos = num_y_pos + (1 if fg.num_y_points else 0)
            for i in range(num_uv_pos):
                fg.ar_coeffs_uv[pl][i] = ((gb.get_bits(8) - 128) + 128) % 256 - 128
            if not fg.num_y_points:
                fg.ar_coeffs_uv[pl][num_uv_pos] = 0
    fg.ar_coeff_shift = gb.get_bits(2) + 6
    fg.grain_scale_shift = gb.get_bits(2)
    for pl in range(2):
        if fg.num_uv_points[pl]:
            fg.uv_mult[pl] = gb.get_bits(8) - 128
            fg.uv_luma_mult[pl] = gb.get_bits(8) - 128
            fg.uv_offset[pl] = gb.get_bits(9) - 256
    fg.overlap_flag = bool(gb.get_bit())
    fg.clip_to_restricted_range = bool(gb.get_bit())
    return fg


def _parse_film_grain(
    ctx, seqhdr, show_frame, showable_frame, frame_type, ref_indices, gb
) -> FilmGrain:
    import copy

    f = FilmGrain()
    f.present = int(
        bool(
            seqhdr.film_grain_present
            and (show_frame or showable_frame)
            and gb.get_bit()
        )
    )
    if f.present:
        seed = gb.get_bits(16)
        f.update = int(frame_type != FrameType.INTER or bool(gb.get_bit()))
        if not f.update:
            refidx = gb.get_bits(3)
            if refidx not in ref_indices:
                raise ParseError("film grain ref not in refidx")
            rh = ctx.refs[refidx].frame_hdr
            if rh is None:
                raise ParseError("missing ref for film grain")
            f.data = copy.deepcopy(rh.film_grain.data)
            f.data.seed = seed
        else:
            f.data = _parse_film_grain_data(seqhdr, seed, gb)
    return f


def parse_frame_hdr(
    ctx, seqhdr: SequenceHeader, temporal_id: int, spatial_id: int, gb: GetBits
) -> FrameHeader:
    """ref: src/obu.rs:1737 parse_frame_hdr.

    `ctx` provides refs[i].frame_hdr for cross-frame header inheritance plus
    strict_std_compliance.
    """
    h = FrameHeader()
    h.temporal_id = temporal_id
    h.spatial_id = spatial_id
    h.show_existing_frame = int(
        not seqhdr.reduced_still_picture_header and bool(gb.get_bit())
    )
    if h.show_existing_frame:
        h.existing_frame_idx = gb.get_bits(3)
        if seqhdr.decoder_model_info_present and not seqhdr.equal_picture_interval:
            h.frame_presentation_delay = gb.get_bits(
                seqhdr.frame_presentation_delay_length
            )
        if seqhdr.frame_id_numbers_present:
            h.frame_id = gb.get_bits(seqhdr.frame_id_n_bits)
            rh = ctx.refs[h.existing_frame_idx].frame_hdr
            if rh is None or rh.frame_id != h.frame_id:
                raise ParseError("show_existing frame id mismatch")
        return h

    h.frame_type = (
        FrameType.KEY
        if seqhdr.reduced_still_picture_header
        else FrameType(gb.get_bits(2))
    )
    h.show_frame = int(seqhdr.reduced_still_picture_header or bool(gb.get_bit()))
    if h.show_frame:
        if seqhdr.decoder_model_info_present and not seqhdr.equal_picture_interval:
            h.frame_presentation_delay = gb.get_bits(
                seqhdr.frame_presentation_delay_length
            )
        h.showable_frame = int(h.frame_type != FrameType.KEY)
    else:
        h.showable_frame = gb.get_bit()
    h.error_resilient_mode = int(
        (h.frame_type == FrameType.KEY and h.show_frame)
        or h.frame_type == FrameType.SWITCH
        or seqhdr.reduced_still_picture_header
        or bool(gb.get_bit())
    )
    h.disable_cdf_update = gb.get_bit()
    if seqhdr.screen_content_tools == AdaptiveBoolean.ADAPTIVE:
        h.allow_screen_content_tools = bool(gb.get_bit())
    else:
        h.allow_screen_content_tools = seqhdr.screen_content_tools == AdaptiveBoolean.ON
    if h.allow_screen_content_tools:
        if seqhdr.force_integer_mv == AdaptiveBoolean.ADAPTIVE:
            h.force_integer_mv = bool(gb.get_bit())
        else:
            h.force_integer_mv = seqhdr.force_integer_mv == AdaptiveBoolean.ON
    else:
        h.force_integer_mv = False
    if h.frame_type.is_key_or_intra:
        h.force_integer_mv = True

    if seqhdr.frame_id_numbers_present:
        h.frame_id = gb.get_bits(seqhdr.frame_id_n_bits)

    if seqhdr.reduced_still_picture_header:
        h.frame_size_override = False
    elif h.frame_type == FrameType.SWITCH:
        h.frame_size_override = True
    else:
        h.frame_size_override = bool(gb.get_bit())
    h.frame_offset = (
        gb.get_bits(seqhdr.order_hint_n_bits) if seqhdr.order_hint else 0
    )
    h.primary_ref_frame = (
        gb.get_bits(3)
        if not h.error_resilient_mode and h.frame_type.is_inter_or_switch
        else PRIMARY_REF_NONE
    )

    if seqhdr.decoder_model_info_present:
        h.buffer_removal_time_present = gb.get_bit()
        if h.buffer_removal_time_present:
            for i in range(seqhdr.num_operating_points):
                seqop = seqhdr.operating_points[i]
                if seqop.decoder_model_param_present:
                    in_temporal_layer = (seqop.idc >> temporal_id) & 1
                    in_spatial_layer = (seqop.idc >> (spatial_id + 8)) & 1
                    if seqop.idc == 0 or (in_temporal_layer and in_spatial_layer):
                        h.operating_points[i].buffer_removal_time = gb.get_bits(
                            seqhdr.buffer_removal_delay_length
                        )

    if h.frame_type.is_key_or_intra:
        h.refresh_frame_flags = (
            0xFF
            if h.frame_type == FrameType.KEY and h.show_frame
            else gb.get_bits(8)
        )
        if (
            h.refresh_frame_flags != 0xFF
            and h.error_resilient_mode
            and seqhdr.order_hint
        ):
            for _ in range(8):
                gb.get_bits(seqhdr.order_hint_n_bits)
        if (
            ctx.strict_std_compliance
            and h.frame_type == FrameType.INTRA
            and h.refresh_frame_flags == 0xFF
        ):
            raise ParseError("intra frame with refresh 0xff")
        h.size = _parse_frame_size(ctx, seqhdr, None, h.frame_size_override, gb)
        h.allow_intrabc = bool(
            h.allow_screen_content_tools
            and not h.size.super_res.enabled
            and gb.get_bit()
        )
        h.use_ref_frame_mvs = 0
        h.subpel_filter_mode = FilterMode.REGULAR_8TAP
    else:
        h.allow_intrabc = False
        h.refresh_frame_flags = (
            0xFF if h.frame_type == FrameType.SWITCH else gb.get_bits(8)
        )
        if h.error_resilient_mode and seqhdr.order_hint:
            for _ in range(8):
                gb.get_bits(seqhdr.order_hint_n_bits)
        h.frame_ref_short_signaling = int(bool(seqhdr.order_hint and gb.get_bit()))
        h.refidx = _parse_refidx(
            ctx,
            seqhdr,
            h.frame_ref_short_signaling,
            h.frame_offset,
            h.frame_id,
            gb,
        )
        use_ref = not h.error_resilient_mode and h.frame_size_override
        h.size = _parse_frame_size(
            ctx, seqhdr, h.refidx if use_ref else None, h.frame_size_override, gb
        )
        h.hp = bool(not h.force_integer_mv and gb.get_bit())
        h.subpel_filter_mode = (
            FilterMode.SWITCHABLE if gb.get_bit() else FilterMode(gb.get_bits(2))
        )
        h.switchable_motion_mode = gb.get_bit()
        h.use_ref_frame_mvs = int(
            bool(
                not h.error_resilient_mode
                and seqhdr.ref_frame_mvs
                and seqhdr.order_hint
                and h.frame_type.is_inter_or_switch
                and gb.get_bit()
            )
        )

    h.refresh_context = int(
        not seqhdr.reduced_still_picture_header
        and not h.disable_cdf_update
        and not gb.get_bit()
    )
    h.tiling = _parse_tiling(seqhdr, h.size, gb)
    h.quant = _parse_quant(seqhdr, gb)
    h.segmentation = _parse_segmentation(
        ctx, h.primary_ref_frame, h.refidx, h.quant, gb
    )
    h.all_lossless = all(h.segmentation.lossless)
    h.delta = _parse_delta(h.quant, h.allow_intrabc, gb)
    h.loopfilter = _parse_loopfilter(
        ctx,
        seqhdr,
        h.all_lossless,
        h.allow_intrabc,
        h.primary_ref_frame,
        h.refidx,
        gb,
    )
    h.cdef = _parse_cdef(seqhdr, h.all_lossless, h.allow_intrabc, gb)
    h.restoration = _parse_restoration(
        seqhdr, h.all_lossless, h.size.super_res.enabled, h.allow_intrabc, gb
    )
    if h.all_lossless:
        h.txfm_mode = TxfmMode.ONLY_4X4
    elif gb.get_bit():
        h.txfm_mode = TxfmMode.SWITCHABLE
    else:
        h.txfm_mode = TxfmMode.LARGEST
    h.switchable_comp_refs = (
        gb.get_bit() if h.frame_type.is_inter_or_switch else 0
    )
    h.skip_mode = _parse_skip_mode(
        ctx,
        seqhdr,
        h.switchable_comp_refs,
        h.frame_type,
        h.frame_offset,
        h.refidx,
        gb,
    )
    h.warp_motion = int(
        bool(
            not h.error_resilient_mode
            and h.frame_type.is_inter_or_switch
            and seqhdr.warped_motion
            and gb.get_bit()
        )
    )
    h.reduced_txtp_set = gb.get_bit()
    h.gmv = _parse_gmv(ctx, h.frame_type, h.primary_ref_frame, h.refidx, h.hp, gb)
    h.film_grain = _parse_film_grain(
        ctx,
        seqhdr,
        h.show_frame,
        h.showable_frame,
        h.frame_type,
        h.refidx,
        gb,
    )
    return h


@dataclass
class TileGroupHeader:
    start: int = 0
    end: int = 0


@dataclass
class TileGroup:
    data: bytes = b""
    hdr: TileGroupHeader = None


def parse_tile_hdr(tiling: Tiling, gb: GetBits) -> TileGroupHeader:
    n_tiles = tiling.cols * tiling.rows
    have_tile_pos = gb.get_bit() if n_tiles > 1 else 0
    if have_tile_pos:
        n_bits = tiling.log2_cols + tiling.log2_rows
        return TileGroupHeader(start=gb.get_bits(n_bits), end=gb.get_bits(n_bits))
    return TileGroupHeader(start=0, end=n_tiles - 1)


def parse_obus(ctx, data: bytes, props=None) -> int:
    """Parse one OBU from `data`; returns bytes consumed.

    `ctx` is the Decoder context (rav1d_tpu.decoder.Decoder): holds seq_hdr,
    frame_hdr, refs[8], tiles, n_tiles, and the submit/output machinery.
    ref: src/obu.rs:2662 rav1d_parse_obus.
    """
    gb = GetBits(data)
    gb.get_bit()  # obu_forbidden_bit
    raw_type = gb.get_bits(4)
    try:
        obu_type = ObuType(raw_type)
    except ValueError:
        obu_type = None
    has_extension = gb.get_bit()
    has_length_field = gb.get_bit()
    gb.get_bit()  # reserved

    temporal_id = spatial_id = 0
    if has_extension:
        temporal_id = gb.get_bits(3)
        spatial_id = gb.get_bits(2)
        gb.get_bits(3)  # reserved

    if has_length_field:
        length = gb.get_uleb128()
    else:
        length = len(data) - 1 - has_extension
    if gb.error:
        raise ParseError("error reading OBU header")

    init_bit_pos = gb.pos
    init_byte_pos = init_bit_pos >> 3
    assert init_bit_pos & 7 == 0

    if length > len(data) - init_byte_pos:
        raise ParseError("OBU payload overruns buffer")

    def check_overrun():
        if gb.error:
            raise ParseError("overrun in OBU bit buffer")
        pos = gb.pos
        assert init_bit_pos <= pos
        if pos - init_bit_pos > 8 * length:
            raise ParseError("overrun into next OBU")

    def skip_frame():
        # Update refs with headers only when skipping a frame
        # (decode_frame_type gating; ref obu.rs:2137-2151).
        for i in range(8):
            if ctx.frame_hdr.refresh_frame_flags & (1 << i):
                ctx.refs[i].reset()
                ctx.refs[i].frame_hdr = ctx.frame_hdr
                ctx.refs[i].seq_hdr = ctx.seq_hdr
        ctx.frame_hdr = None
        ctx.n_tiles = 0
        return length + init_byte_pos

    # skip OBUs not in the selected operating point
    if (
        obu_type not in (ObuType.SEQ_HDR, ObuType.TD)
        and has_extension
        and ctx.operating_point_idc != 0
    ):
        in_temporal_layer = (ctx.operating_point_idc >> temporal_id) & 1
        in_spatial_layer = (ctx.operating_point_idc >> (spatial_id + 8)) & 1
        if not in_temporal_layer or not in_spatial_layer:
            return length + init_byte_pos

    def do_tile_grp():
        hdr = parse_tile_hdr(ctx.frame_hdr.tiling, gb)
        gb.bytealign()
        check_overrun()
        pkt_bytelen = init_byte_pos + length
        bit_pos = gb.pos
        assert bit_pos & 7 == 0
        assert pkt_bytelen >= bit_pos >> 3
        tile_data = data[bit_pos >> 3 : pkt_bytelen]
        if hdr.start > hdr.end or hdr.start != ctx.n_tiles:
            ctx.tiles.clear()
            ctx.n_tiles = 0
            raise ParseError("tile groups out of order")
        ctx.n_tiles += 1 + hdr.end - hdr.start
        ctx.tiles.append(TileGroup(data=tile_data, hdr=hdr))

    if obu_type == ObuType.SEQ_HDR:
        seq_hdr = parse_seq_hdr(gb, ctx.strict_std_compliance)
        check_overrun()
        op_idx = (
            ctx.operating_point
            if ctx.operating_point < seq_hdr.num_operating_points
            else 0
        )
        ctx.operating_point_idc = seq_hdr.operating_points[op_idx].idc
        spatial_mask = ctx.operating_point_idc >> 8
        ctx.max_spatial_id = ulog2(spatial_mask) != 0 if spatial_mask else False
        if ctx.seq_hdr is None:
            ctx.frame_hdr = None
            ctx.on_new_sequence()
        elif not seq_hdr.eq_without_operating_parameter_info(ctx.seq_hdr):
            # new video sequence: reset all cross-frame state
            ctx.frame_hdr = None
            ctx.content_light = None
            ctx.mastering_display = None
            for ref in ctx.refs:
                ref.clear()
            ctx.on_new_sequence()
        elif [
            op for op in seq_hdr.operating_parameter_info
        ] != [op for op in ctx.seq_hdr.operating_parameter_info]:
            ctx.on_new_op_params()
        ctx.seq_hdr = seq_hdr
    elif obu_type == ObuType.REDUNDANT_FRAME_HDR and ctx.frame_hdr is not None:
        pass
    elif obu_type in (ObuType.REDUNDANT_FRAME_HDR, ObuType.FRAME, ObuType.FRAME_HDR):
        if ctx.seq_hdr is None:
            raise ParseError("frame header before sequence header")
        ctx.frame_hdr = None
        frame_hdr = parse_frame_hdr(ctx, ctx.seq_hdr, temporal_id, spatial_id, gb)
        ctx.tiles.clear()
        ctx.n_tiles = 0
        if obu_type != ObuType.FRAME:
            gb.get_bit()  # trailing bit
            check_overrun()
        if (
            ctx.frame_size_limit
            and frame_hdr.size.width[1] * frame_hdr.size.height > ctx.frame_size_limit
        ):
            raise ParseError("frame size exceeds limit")
        if obu_type == ObuType.FRAME and frame_hdr.show_existing_frame:
            raise ParseError("OBU_FRAME with show_existing_frame")
        ctx.frame_hdr = frame_hdr
        if obu_type == ObuType.FRAME:
            gb.bytealign()
            do_tile_grp()
    elif obu_type == ObuType.TILE_GRP:
        if ctx.frame_hdr is None:
            raise ParseError("tile group before frame header")
        do_tile_grp()
    elif obu_type == ObuType.METADATA:
        meta_type = gb.get_uleb128()
        meta_type_len = (gb.pos - init_bit_pos) >> 3
        if gb.error:
            raise ParseError("error reading metadata type")
        if meta_type == 1:  # HDR CLL
            mcll = gb.get_bits(16)
            mfall = gb.get_bits(16)
            gb.get_bit()
            gb.bytealign()
            check_overrun()
            ctx.content_light = ContentLightLevel(
                max_content_light_level=mcll,
                max_frame_average_light_level=mfall,
            )
        elif meta_type == 2:  # HDR MDCV
            md = MasteringDisplay()
            md.primaries = [[gb.get_bits(16), gb.get_bits(16)] for _ in range(3)]
            md.white_point = [gb.get_bits(16), gb.get_bits(16)]
            md.max_luminance = gb.get_bits(32)
            md.min_luminance = gb.get_bits(32)
            gb.get_bit()
            gb.bytealign()
            check_overrun()
            ctx.mastering_display = md
        elif meta_type == 4:  # ITU-T T.35
            payload_size = length
            while payload_size > 0 and data[init_byte_pos + payload_size - 1] == 0:
                payload_size -= 1
            payload_size -= 1  # trailing_one_bit + zeros
            payload_size -= meta_type_len
            country_code_extension_byte = 0
            country_code = gb.get_bits(8)
            payload_size -= 1
            if country_code == 0xFF:
                country_code_extension_byte = gb.get_bits(8)
                payload_size -= 1
            if payload_size > 0:
                payload = bytes(gb.get_bits(8) for _ in range(payload_size))
                ctx.itut_t35 = ITUTT35(
                    country_code=country_code,
                    country_code_extension_byte=country_code_extension_byte,
                    payload=payload,
                )
        # scalability (3) / timecode (5) / unknown: ignored
    elif obu_type == ObuType.TD:
        ctx.on_new_temporal_unit()
    elif obu_type == ObuType.PADDING:
        pass
    # unknown OBU types: warn-and-ignore

    if ctx.seq_hdr is not None and ctx.frame_hdr is not None:
        fh = ctx.frame_hdr
        if fh.show_existing_frame:
            ref_hdr = ctx.refs[fh.existing_frame_idx].frame_hdr
            if ref_hdr is None:
                raise ParseError("show_existing_frame with empty slot")
            if ref_hdr.frame_type.is_inter_or_switch and ctx.decode_frame_type > 1:
                return skip_frame()
            if ref_hdr.frame_type == FrameType.INTRA and ctx.decode_frame_type > 2:
                return skip_frame()
            ctx.output_existing_frame(fh)
            ctx.frame_hdr = None
        elif ctx.n_tiles == fh.tiling.cols * fh.tiling.rows:
            dft = ctx.decode_frame_type
            if fh.frame_type.is_inter_or_switch:
                if dft > 1 or (dft == 1 and not fh.refresh_frame_flags):
                    return skip_frame()
            elif fh.frame_type == FrameType.INTRA:
                if dft > 2 or (dft == 1 and not fh.refresh_frame_flags):
                    return skip_frame()
            if not ctx.tiles:
                raise ParseError("no tiles")
            ctx.submit_frame()
            assert not ctx.tiles
            ctx.frame_hdr = None
            ctx.n_tiles = 0

    return length + init_byte_pos
