"""The reference decoder: the dav1d open/send_data/get_picture state
machine over the numpy host path.

A frozen copy of the port's decoder.py with its device engine and frame
ring taken out: every frame's syntax pass (the C pass under csrc/host/)
and dense pass (recon/, ops/ref/) run in the caller's thread, and a
picture is handed out as soon as it is decoded (frame delay 1). Film
grain is applied on the host (recon/fg_apply.py). Behavior parity:
src/lib.rs (rav1d_send_data:538, rav1d_get_picture:571, gen_picture:507,
flush:671) and src/decode.rs rav1d_submit_frame:4650.
"""

from __future__ import annotations

import errno
import sys
from dataclasses import dataclass, field

import numpy as np

from . import obu as _obu
from .headers import FrameType, PixelLayout, PRIMARY_REF_NONE, WarpedMotionType
from .picture import Picture, RefSlot, alloc_picture


class DecodeError(ValueError):
    """Decode failure carrying a negative-errno result code (parity:
    Rav1dError <-> Dav1dResult, src/error.rs). `code` defaults to -EINVAL
    (malformed bitstream); other sites set -ENOMEM / -ENOPROTOOPT etc."""

    def __init__(self, *args, code: int = -errno.EINVAL):
        super().__init__(*args)
        self.code = code


def _has_grain(pic):
    """lib.rs has_grain: any grain parameters actually active."""
    d = pic.frame_hdr.film_grain.data
    return bool(
        d.num_y_points
        or d.num_uv_points[0]
        or d.num_uv_points[1]
        or (d.clip_to_restricted_range and d.chroma_scaling_from_luma)
    )


class EAgain(Exception):
    """Raised when the call cannot make progress (dav1d EAGAIN semantics;
    result code parity: -EAGAIN, src/error.rs)."""

    code = -errno.EAGAIN


@dataclass
class Settings:
    """Parity: Dav1dSettings (include/dav1d/dav1d.rs:127-141)."""

    n_threads: int = 0
    max_frame_delay: int = 0
    apply_grain: bool = True
    operating_point: int = 0
    all_layers: bool = True
    frame_size_limit: int = 0
    strict_std_compliance: bool = False
    output_invisible_frames: bool = False
    inloop_filters: int = 7  # bit0 deblock, bit1 cdef+superres, bit2 restoration
    decode_frame_type: int = 0  # 0 all, 1 reference, 2 intra, 3 key
    # pluggable hooks (parity: Dav1dSettings.logger / .allocator,
    # src/log.rs:11-50, src/picture.rs:147-225)
    logger: object = None     # callable(str) -> None; None = stderr
    allocator: object = None  # picture.PictureAllocator subclass instance


@dataclass
class FrameContext:
    """Per-frame decode state (Rav1dFrameData analog, src/internal.rs:729)."""

    seq_hdr: object = None
    frame_hdr: object = None
    refp: list = field(default_factory=lambda: [None] * 7)  # ref Pictures
    ref_coded_width: list = field(default_factory=lambda: [0] * 7)
    gmv_warp_allowed: list = field(default_factory=lambda: [0] * 7)
    svc: list = field(default_factory=lambda: [[{"scale": 0, "step": 0} for _ in range(2)] for _ in range(7)])
    in_cdf: object = None
    out_cdf: object = None
    tiles: list = field(default_factory=list)
    cur: Picture = None  # coded-width picture
    sr_cur: Picture = None  # super-res'd output picture
    mvs: np.ndarray = None
    ref_mvs: list = field(default_factory=lambda: [None] * 7)
    refpoc: list = field(default_factory=lambda: [0] * 7)
    refrefpoc: list = field(default_factory=lambda: [[0] * 7 for _ in range(7)])
    prev_segmap: np.ndarray = None
    cur_segmap: np.ndarray = None
    resize_step: list = field(default_factory=lambda: [0, 0])
    resize_start: list = field(default_factory=lambda: [0, 0])
    # derived geometry
    w4: int = 0
    h4: int = 0
    bw: int = 0
    bh: int = 0
    sb128w: int = 0
    sb128h: int = 0
    sb_shift: int = 0
    sb_step: int = 0
    sbh: int = 0
    b4_stride: int = 0
    bitdepth_max: int = 255
    # filled by decode_frame
    lf = None
    frame_thread = None


def _scale_fac(ref_sz: int, this_sz: int) -> int:
    return ((ref_sz << 14) + (this_sz >> 1)) // this_sz


class Decoder:
    """AV1 decoder context (Rav1dContext analog) on the numpy host path."""

    def __init__(self, settings: Settings | None = None):
        self.settings = settings or Settings()
        self.seq_hdr = None
        self.frame_hdr = None
        self.refs = [RefSlot() for _ in range(8)]
        self.cdf_slots = [None] * 8  # c.cdf[8]
        self.tiles = []
        self.n_tiles = 0
        self.operating_point = self.settings.operating_point
        self.operating_point_idc = 0
        self.max_spatial_id = False
        self.strict_std_compliance = self.settings.strict_std_compliance
        self.frame_size_limit = self.settings.frame_size_limit
        self.decode_frame_type = self.settings.decode_frame_type
        self.output_invisible_frames = self.settings.output_invisible_frames
        self.apply_grain = self.settings.apply_grain
        self.content_light = None
        self.mastering_display = None
        self.itut_t35 = None
        self.event_flags = 0
        self._pending_input = None  # Packet with unconsumed bytes
        self._out = None  # next output Picture
        self._cache = None  # layered-stream single-layer output cache (lib.rs c.cache)
        self._tu_flag = False  # NEW_TEMPORAL_UNIT pending (picture.rs flags)
        self.all_layers = self.settings.all_layers
        self._timebase = (25, 1)
        self._log = self.settings.logger or (
            lambda msg: print(msg, file=sys.stderr)
        )

    # -- event hooks used by obu.parse_obus --------------------------------

    def on_new_sequence(self):
        self.event_flags |= 1

    def on_new_op_params(self):
        self.event_flags |= 2

    def on_new_temporal_unit(self):
        self._tu_flag = True  # obu.rs:2484 frame_flags |= NEW_TEMPORAL_UNIT

    # -- layered-stream output gating (lib.rs output_picture_ready:412,
    #    output_image:391: with all_layers=0, only the operating point's
    #    top spatial layer of each temporal unit is output) ---------------

    def _layered(self):
        return (not self.all_layers) and self.max_spatial_id

    def _queue_out(self, pic):
        pic.new_tu = self._tu_flag
        self._tu_flag = False
        self._out = pic

    def _picture_ready(self, drain):
        if not self._layered():
            return self._out is not None
        if self._out is not None and self._cache is not None:
            if (
                self.max_spatial_id == (self._cache.frame_hdr.spatial_id != 0)
            ) or getattr(self._out, "new_tu", False):
                return True
            self._cache = self._out
            self._out = None
            return False
        if self._cache is not None and drain:
            return True
        if self._out is not None:
            self._cache = self._out
            self._out = None
        return False

    def _output_image(self):
        if self._layered():
            out = self._cache
            self._cache = self._out
            self._out = None
        else:
            out = self._out
            self._out = None
        return out

    # -- public API --------------------------------------------------------

    def send_data(self, data: bytes, timestamp: int = 0):
        """Feed one temporal unit. Raises EAgain if input is still pending.

        Error semantics match dav1d's poison-not-kill contract
        (src/lib.rs:538 rav1d_send_data -> gen_picture, cached_error at
        src/lib.rs:347; fuzzer invariant tests/libfuzzer/dav1d_fuzzer.c):
        a malformed temporal unit raises DecodeError, the offending input
        is dropped, and the decoder remains usable — reference state is
        kept consistent so later valid frames keep decoding.
        """
        if self._pending_input is not None:
            raise EAgain("previous input not fully consumed")
        if len(data) == 0:
            raise DecodeError("empty data")
        self._pending_input = [bytes(data), timestamp]
        try:
            self._gen_picture()
        except EAgain:
            raise
        except (TimeoutError, KeyboardInterrupt):
            raise  # harness alarms are not bitstream errors (no poison)
        except Exception as e:
            self._pending_input = None  # poison this TU, keep the decoder
            self.frame_hdr = None
            self.tiles.clear()
            self.n_tiles = 0
            self._log(f"rav1d: dropping temporal unit: {e}")
            err = e if isinstance(e, DecodeError) else DecodeError(str(e))
            raise err from e

    def _gen_picture(self):
        """Parse buffered input until a picture is produced or input runs dry
        (gen_picture, src/lib.rs:507)."""
        if self._pending_input is None:
            return
        while not self._picture_ready(False) and self._pending_input is not None:
            buf, ts = self._pending_input
            self._cur_timestamp = ts
            consumed = _obu.parse_obus(self, buf)
            if consumed >= len(buf):
                self._pending_input = None
            else:
                self._pending_input[0] = buf[consumed:]

    def get_picture(self) -> Picture:
        """Return the next decoded picture. Raises EAgain when none is
        ready (rav1d_get_picture: output_picture_ready(c, 1))."""
        try:
            self._gen_picture()
        except EAgain:
            raise
        except (TimeoutError, KeyboardInterrupt):
            raise  # harness alarms are not bitstream errors (no poison)
        except Exception as e:
            self._pending_input = None
            self.frame_hdr = None
            self.tiles.clear()
            self.n_tiles = 0
            err = e if isinstance(e, DecodeError) else DecodeError(str(e))
            raise err from e
        if self._picture_ready(True):
            out = self._output_image()
            if self.apply_grain and out.frame_hdr is not None and _has_grain(out):
                out = self._apply_grain(out)
            return out
        raise EAgain("no picture ready")

    def flush(self):
        """Drop all buffered input/output and reference state (dav1d_flush).
        The decoder then decodes from the next key frame."""
        self._pending_input = None
        self._out = None
        self._cache = None
        self._tu_flag = False
        self.frame_hdr = None
        self.tiles.clear()
        self.n_tiles = 0
        self.itut_t35 = None
        for ref in self.refs:
            if ref.picture is not None:
                alloc = getattr(ref.picture, "_allocator", None)
                if alloc is not None:
                    alloc.release_picture(ref.picture)
            ref.clear()
        self.cdf_slots = [None] * 8

    def close(self):
        self.flush()

    # -- grain -------------------------------------------------------------

    def _apply_grain(self, pic: Picture) -> Picture:
        """A new picture with `pic`'s film grain (recon/fg_apply.py)."""
        from .recon import fg_apply

        return fg_apply.apply_grain(pic)

    # -- show_existing_frame path ------------------------------------------

    def output_existing_frame(self, frame_hdr):
        slot = self.refs[frame_hdr.existing_frame_idx]
        if slot.picture is None:
            raise _obu.ParseError("show_existing_frame references empty slot")
        if self.strict_std_compliance and not slot.showable:
            raise _obu.ParseError("frame not showable")
        out = slot.picture
        out.timestamp = getattr(self, "_cur_timestamp", 0)
        out.content_light = self.content_light
        out.mastering_display = self.mastering_display
        out.itut_t35 = self.itut_t35
        self.itut_t35 = None
        self._queue_out(out)
        if slot.frame_hdr.frame_type == FrameType.KEY:
            r = frame_hdr.existing_frame_idx
            self.refs[r].showable = False
            for i in range(8):
                if i == r:
                    continue
                self.refs[i].picture = self.refs[r].picture
                self.refs[i].frame_hdr = self.refs[r].frame_hdr
                self.refs[i].seq_hdr = self.refs[r].seq_hdr
                self.refs[i].showable = self.refs[r].showable
                self.cdf_slots[i] = self.cdf_slots[r]
                self.refs[i].segmap = self.refs[r].segmap
                self.refs[i].refmvs = None

    # -- frame submission (rav1d_submit_frame, src/decode.rs:4650) ----------

    def submit_frame(self):
        from .entropy.cdf import CdfContext
        from .recon.frame import decode_frame

        f = FrameContext()
        f.seq_hdr = self.seq_hdr
        f.frame_hdr = self.frame_hdr
        self.frame_hdr = None
        seq_hdr = f.seq_hdr
        frame_hdr = f.frame_hdr
        bpc = 8 + 2 * seq_hdr.hbd

        if frame_hdr.frame_type.is_inter_or_switch:
            if frame_hdr.primary_ref_frame != PRIMARY_REF_NONE:
                pri_ref = frame_hdr.refidx[frame_hdr.primary_ref_frame]
                if self.refs[pri_ref].picture is None:
                    raise DecodeError("missing primary reference frame")
            for i in range(7):
                refidx = frame_hdr.refidx[i]
                ref = self.refs[refidx]
                if (
                    ref.picture is None
                    or frame_hdr.size.width[0] * 2 < ref.picture.w
                    or frame_hdr.size.height * 2 < ref.picture.h
                    or frame_hdr.size.width[0] > ref.picture.w * 16
                    or frame_hdr.size.height > ref.picture.h * 16
                    or seq_hdr.layout != ref.picture.layout
                    or bpc != ref.picture.bpc
                ):
                    raise DecodeError("invalid reference frame")
                f.refp[i] = ref.picture
                f.ref_coded_width[i] = ref.frame_hdr.size.width[0]
                if (
                    frame_hdr.size.width[0] != ref.picture.w
                    or frame_hdr.size.height != ref.picture.h
                ):
                    f.svc[i][0]["scale"] = _scale_fac(ref.picture.w, frame_hdr.size.width[0])
                    f.svc[i][1]["scale"] = _scale_fac(ref.picture.h, frame_hdr.size.height)
                    f.svc[i][0]["step"] = (f.svc[i][0]["scale"] + 8) >> 4
                    f.svc[i][1]["step"] = (f.svc[i][1]["scale"] + 8) >> 4
                else:
                    f.svc[i][0]["scale"] = f.svc[i][1]["scale"] = 0
                from .recon.warp import get_shear_params

                f.gmv_warp_allowed[i] = int(
                    frame_hdr.gmv[i].type > WarpedMotionType.TRANSLATION
                    and not frame_hdr.force_integer_mv
                    and not get_shear_params(frame_hdr.gmv[i])
                    and f.svc[i][0]["scale"] == 0
                )

        # jnt_comp weights (decode.rs:4362 setup)
        f.jnt_weights = [[0] * 7 for _ in range(7)]
        if frame_hdr.frame_type.is_inter_or_switch and frame_hdr.switchable_comp_refs:
            from .syntax.env import get_poc_diff

            quant_dist_weight = [[2, 3], [2, 5], [2, 7]]
            quant_dist_lookup_table = [[9, 7], [11, 5], [12, 4], [13, 3]]
            ref_pocs = [f.refp[i].frame_hdr.frame_offset for i in range(7)]
            for i in range(7):
                for j in range(i + 1, 7):
                    d = [
                        min(
                            abs(
                                get_poc_diff(
                                    seq_hdr.order_hint_n_bits,
                                    ref_pocs[ij],
                                    frame_hdr.frame_offset,
                                )
                            ),
                            31,
                        )
                        for ij in (j, i)
                    ]
                    order = d[0] <= d[1]
                    k = len(quant_dist_weight)
                    for kk, weight in enumerate(quant_dist_weight):
                        c0 = weight[1 if order else 0]
                        c1 = weight[0 if order else 1]
                        dc0, dc1 = d[0] * c0, d[1] * c1
                        if (not order and dc0 < dc1) or (order and dc0 > dc1):
                            k = kk
                            break
                    f.jnt_weights[i][j] = quant_dist_lookup_table[k][
                        1 if order else 0
                    ]

        # entropy state: inherit CDFs from primary ref or reset from qindex
        if frame_hdr.primary_ref_frame == PRIMARY_REF_NONE:
            f.in_cdf = CdfContext.from_qindex(frame_hdr.quant.yac)
        else:
            pri_ref = frame_hdr.refidx[frame_hdr.primary_ref_frame]
            f.in_cdf = self.cdf_slots[pri_ref]
            if f.in_cdf is None:
                raise DecodeError("missing CDF state for primary ref")

        f.tiles = self.tiles
        self.tiles = []

        # allocate output picture (coded width; superres upscale separate)
        layout = seq_hdr.layout
        f.sr_cur = alloc_picture(
            frame_hdr.size.width[1], frame_hdr.size.height, layout, bpc,
            allocator=self.settings.allocator,
        )
        f.sr_cur.frame_hdr = frame_hdr
        f.sr_cur.seq_hdr = seq_hdr
        f.sr_cur.timestamp = getattr(self, "_cur_timestamp", 0)
        f.sr_cur.content_light = self.content_light
        f.sr_cur.mastering_display = self.mastering_display
        f.sr_cur.itut_t35 = self.itut_t35
        self.itut_t35 = None
        if frame_hdr.size.width[0] != frame_hdr.size.width[1]:
            f.cur = alloc_picture(
                frame_hdr.size.width[0], frame_hdr.size.height, layout, bpc,
                allocator=self.settings.allocator,
            )
            f.resize_step[0] = _scale_fac(f.cur.w, f.sr_cur.w)
            ss_hor = 1 if layout != PixelLayout.I444 else 0
            in_cw = (f.cur.w + ss_hor) >> ss_hor
            out_cw = (f.sr_cur.w + ss_hor) >> ss_hor
            f.resize_step[1] = _scale_fac(in_cw, out_cw)
            from .recon.superres import get_upscale_x0

            f.resize_start[0] = get_upscale_x0(f.cur.w, f.sr_cur.w, f.resize_step[0])
            f.resize_start[1] = get_upscale_x0(in_cw, out_cw, f.resize_step[1])
        else:
            f.cur = f.sr_cur

        # geometry (src/decode.rs:4890-4900)
        f.w4 = (frame_hdr.size.width[0] + 3) >> 2
        f.h4 = (frame_hdr.size.height + 3) >> 2
        f.bw = ((frame_hdr.size.width[0] + 7) >> 3) << 1
        f.bh = ((frame_hdr.size.height + 7) >> 3) << 1
        f.sb128w = (f.bw + 31) >> 5
        f.sb128h = (f.bh + 31) >> 5
        f.sb_shift = 4 + seq_hdr.sb128
        f.sb_step = 16 << seq_hdr.sb128
        f.sbh = (f.bh + f.sb_step - 1) >> f.sb_shift
        f.b4_stride = (f.bw + 31) & ~31
        f.bitdepth_max = (1 << bpc) - 1

        # mvs / refpoc
        if frame_hdr.frame_type.is_inter_or_switch or frame_hdr.allow_intrabc:
            from .syntax.refmvs import TB_DT

            f.mvs = np.zeros((f.sb128h * 16, f.b4_stride >> 1), dtype=TB_DT)
            if not frame_hdr.allow_intrabc:
                for i in range(7):
                    f.refpoc[i] = f.refp[i].frame_hdr.frame_offset
            if frame_hdr.use_ref_frame_mvs:
                for i in range(7):
                    refidx = frame_hdr.refidx[i]
                    ref_w = ((f.ref_coded_width[i] + 7) >> 3) << 1
                    ref_h = ((f.refp[i].h + 7) >> 3) << 1
                    if (
                        self.refs[refidx].refmvs is not None
                        and ref_w == f.bw
                        and ref_h == f.bh
                    ):
                        f.ref_mvs[i] = self.refs[refidx].refmvs
                    f.refrefpoc[i] = list(self.refs[refidx].refpoc or [0] * 7)

        # segmap
        if frame_hdr.segmentation.enabled:
            f.prev_segmap = None
            if frame_hdr.segmentation.temporal or not frame_hdr.segmentation.update_map:
                pri_ref = frame_hdr.primary_ref_frame
                assert pri_ref != PRIMARY_REF_NONE
                ref_w = ((f.ref_coded_width[pri_ref] + 7) >> 3) << 1
                ref_h = ((f.refp[pri_ref].h + 7) >> 3) << 1
                if ref_w == f.bw and ref_h == f.bh:
                    f.prev_segmap = self.refs[frame_hdr.refidx[pri_ref]].segmap
            if frame_hdr.segmentation.update_map or f.prev_segmap is None:
                f.cur_segmap = np.zeros((f.sb128h * 32, f.b4_stride), dtype=np.uint8)
            else:
                f.cur_segmap = f.prev_segmap  # read-only reuse

        # syntax pass now (host C, synchronous): produces CDFs, refmvs,
        # segmap — everything frame N+1's syntax pass needs — before any
        # pixel work (rav1d pass=1, src/decode.rs:3895)
        from .recon.frame import decode_frame_syntax

        decode_frame_syntax(self, f)

        # CDF refresh output
        out_cdf = f.out_cdf if frame_hdr.refresh_context else f.in_cdf

        # update the 8 reference slots (src/decode.rs:5002-5027)
        for i in range(8):
            if frame_hdr.refresh_frame_flags & (1 << i):
                slot = self.refs[i]
                slot.picture = f.sr_cur
                slot.frame_hdr = frame_hdr
                slot.seq_hdr = seq_hdr
                slot.showable = bool(frame_hdr.showable_frame)
                self.cdf_slots[i] = out_cdf
                slot.segmap = f.cur_segmap
                slot.refmvs = None if frame_hdr.allow_intrabc else f.mvs
                slot.refpoc = tuple(f.refpoc)

        # dense pass, inline (n_fc == 1)
        from .recon.frame import decode_frame_dense

        decode_frame_dense(f)

        if frame_hdr.show_frame or self.output_invisible_frames:
            self._queue_out(f.sr_cur)
