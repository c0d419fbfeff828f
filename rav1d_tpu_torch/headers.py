"""AV1 sequence / frame header types.

Plain Python dataclasses (control plane). Field semantics follow the AV1
specification; derived-field conventions (e.g. width[0]=post-superres,
width[1]=pre-superres) match the reference decoder so downstream logic can be
checked against it (behavior parity: include/dav1d/headers.rs, src/obu.rs).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace as _replace

MAX_OPERATING_POINTS = 32
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64
MAX_CDEF_STRENGTHS = 8
MAX_SEGMENTS = 8
REFS_PER_FRAME = 7
TOTAL_REFS_PER_FRAME = 8
PRIMARY_REF_NONE = 7


class ObuType(enum.IntEnum):
    SEQ_HDR = 1
    TD = 2
    FRAME_HDR = 3
    TILE_GRP = 4
    METADATA = 5
    FRAME = 6
    REDUNDANT_FRAME_HDR = 7
    PADDING = 15


class Profile(enum.IntEnum):
    MAIN = 0
    HIGH = 1
    PROFESSIONAL = 2


class PixelLayout(enum.IntEnum):
    I400 = 0
    I420 = 1
    I422 = 2
    I444 = 3


class FrameType(enum.IntEnum):
    KEY = 0
    INTER = 1
    INTRA = 2
    SWITCH = 3

    @property
    def is_key_or_intra(self) -> bool:
        return self in (FrameType.KEY, FrameType.INTRA)

    @property
    def is_inter_or_switch(self) -> bool:
        return self in (FrameType.INTER, FrameType.SWITCH)


class TxfmMode(enum.IntEnum):
    ONLY_4X4 = 0
    LARGEST = 1
    SWITCHABLE = 2


class FilterMode(enum.IntEnum):
    REGULAR_8TAP = 0
    SMOOTH_8TAP = 1
    SHARP_8TAP = 2
    BILINEAR = 3
    SWITCHABLE = 4


class RestorationType(enum.IntEnum):
    NONE = 0
    SWITCHABLE = 1
    WIENER = 2
    SGRPROJ = 3


class WarpedMotionType(enum.IntEnum):
    IDENTITY = 0
    TRANSLATION = 1
    ROT_ZOOM = 2
    AFFINE = 3


class AdaptiveBoolean(enum.IntEnum):
    OFF = 0
    ON = 1
    ADAPTIVE = 2


class ChromaSamplePosition(enum.IntEnum):
    UNKNOWN = 0
    VERTICAL = 1
    COLOCATED = 2
    RESERVED = 3


@dataclass
class OperatingPoint:
    major_level: int = 0
    minor_level: int = 0
    initial_display_delay: int = 0
    idc: int = 0
    tier: int = 0
    decoder_model_param_present: int = 0
    display_model_param_present: int = 0


@dataclass
class OperatingParameterInfo:
    decoder_buffer_delay: int = 0
    encoder_buffer_delay: int = 0
    low_delay_mode: int = 0


@dataclass
class SequenceHeader:
    profile: Profile = Profile.MAIN
    max_width: int = 0
    max_height: int = 0
    layout: PixelLayout = PixelLayout.I420
    pri: int = 2  # color primaries (2 = unknown)
    trc: int = 2
    mtrx: int = 2
    chr: ChromaSamplePosition = ChromaSamplePosition.UNKNOWN
    hbd: int = 0  # 0: 8bpc, 1: 10bpc, 2: 12bpc
    color_range: int = 0
    num_operating_points: int = 1
    operating_points: list = field(
        default_factory=lambda: [OperatingPoint() for _ in range(MAX_OPERATING_POINTS)]
    )
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    timing_info_present: int = 0
    num_units_in_tick: int = 0
    time_scale: int = 0
    equal_picture_interval: int = 0
    num_ticks_per_picture: int = 0
    decoder_model_info_present: int = 0
    encoder_decoder_buffer_delay_length: int = 0
    num_units_in_decoding_tick: int = 0
    buffer_removal_delay_length: int = 0
    frame_presentation_delay_length: int = 0
    display_model_info_present: int = 0
    width_n_bits: int = 0
    height_n_bits: int = 0
    frame_id_numbers_present: int = 0
    delta_frame_id_n_bits: int = 0
    frame_id_n_bits: int = 0
    sb128: int = 0
    filter_intra: int = 0
    intra_edge_filter: int = 0
    inter_intra: int = 0
    masked_compound: int = 0
    warped_motion: int = 0
    dual_filter: int = 0
    order_hint: int = 0
    jnt_comp: int = 0
    ref_frame_mvs: int = 0
    screen_content_tools: AdaptiveBoolean = AdaptiveBoolean.OFF
    force_integer_mv: AdaptiveBoolean = AdaptiveBoolean.OFF
    order_hint_n_bits: int = 0
    super_res: int = 0
    cdef: int = 0
    restoration: int = 0
    ss_hor: int = 0
    ss_ver: int = 0
    monochrome: int = 0
    color_description_present: int = 0
    separate_uv_delta_q: int = 0
    film_grain_present: int = 0
    operating_parameter_info: list = field(
        default_factory=lambda: [
            OperatingParameterInfo() for _ in range(MAX_OPERATING_POINTS)
        ]
    )

    @property
    def bpc(self) -> int:
        return 8 + 2 * self.hbd

    def eq_without_operating_parameter_info(self, other: "SequenceHeader") -> bool:
        a = _replace(
            self,
            operating_parameter_info=[],
            operating_points=[
                _replace(op, decoder_model_param_present=0, display_model_param_present=0)
                for op in self.operating_points
            ],
        )
        b = _replace(
            other,
            operating_parameter_info=[],
            operating_points=[
                _replace(op, decoder_model_param_present=0, display_model_param_present=0)
                for op in other.operating_points
            ],
        )
        return a == b


@dataclass
class SuperRes:
    enabled: bool = False
    width_scale_denominator: int = 8


@dataclass
class FrameSize:
    width: tuple = (0, 0)  # [0]=post-superres (coded), [1]=pre-superres (final)
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    super_res: SuperRes = field(default_factory=SuperRes)
    have_render_size: int = 0


@dataclass
class Tiling:
    uniform: int = 1
    n_bytes: int = 0
    min_log2_cols: int = 0
    max_log2_cols: int = 0
    log2_cols: int = 0
    cols: int = 1
    max_log2_rows: int = 0
    log2_rows: int = 0
    rows: int = 1
    col_start_sb: list = field(default_factory=lambda: [0] * (MAX_TILE_COLS + 1))
    row_start_sb: list = field(default_factory=lambda: [0] * (MAX_TILE_ROWS + 1))
    update: int = 0


@dataclass
class Quant:
    yac: int = 0
    ydc_delta: int = 0
    udc_delta: int = 0
    uac_delta: int = 0
    vdc_delta: int = 0
    vac_delta: int = 0
    qm: int = 0
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0


@dataclass
class SegmentationData:
    delta_q: int = 0
    delta_lf_y_v: int = 0
    delta_lf_y_h: int = 0
    delta_lf_u: int = 0
    delta_lf_v: int = 0
    ref: int = -1
    skip: int = 0
    globalmv: int = 0


@dataclass
class SegmentationDataSet:
    d: list = field(default_factory=lambda: [SegmentationData() for _ in range(8)])
    preskip: int = 0
    last_active_segid: int = -1


@dataclass
class Segmentation:
    enabled: int = 0
    update_map: int = 0
    temporal: int = 0
    update_data: int = 0
    seg_data: SegmentationDataSet = field(default_factory=SegmentationDataSet)
    lossless: list = field(default_factory=lambda: [0] * 8)
    qidx: list = field(default_factory=lambda: [0] * 8)


@dataclass
class DeltaQ:
    present: int = 0
    res_log2: int = 0


@dataclass
class DeltaLf:
    present: int = 0
    res_log2: int = 0
    multi: int = 0


@dataclass
class Delta:
    q: DeltaQ = field(default_factory=DeltaQ)
    lf: DeltaLf = field(default_factory=DeltaLf)


DEFAULT_MODE_REF_DELTAS = dict(
    mode_delta=[0, 0],
    ref_delta=[1, 0, 0, 0, -1, 0, -1, -1],
)


@dataclass
class ModeRefDeltas:
    mode_delta: list = field(default_factory=lambda: [0, 0])
    ref_delta: list = field(default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])


@dataclass
class Loopfilter:
    level_y: list = field(default_factory=lambda: [0, 0])
    level_u: int = 0
    level_v: int = 0
    mode_ref_delta_enabled: int = 0
    mode_ref_delta_update: int = 0
    mode_ref_deltas: ModeRefDeltas = field(default_factory=ModeRefDeltas)
    sharpness: int = 0


@dataclass
class Cdef:
    damping: int = 0
    n_bits: int = 0
    y_strength: list = field(default_factory=lambda: [0] * MAX_CDEF_STRENGTHS)
    uv_strength: list = field(default_factory=lambda: [0] * MAX_CDEF_STRENGTHS)


@dataclass
class Restoration:
    type: tuple = (RestorationType.NONE,) * 3
    unit_size: tuple = (0, 0)


@dataclass
class SkipMode:
    allowed: int = 0
    enabled: int = 0
    refs: tuple = (0, 0)


@dataclass
class WarpedMotionParams:
    type: WarpedMotionType = WarpedMotionType.IDENTITY
    matrix: list = field(default_factory=lambda: [0, 0, 1 << 16, 0, 0, 1 << 16])
    # shear params (alpha, beta, gamma, delta) filled by get_shear_params
    alpha: int = 0
    beta: int = 0
    gamma: int = 0
    delta: int = 0

    def is_identity(self) -> bool:
        return self.type == WarpedMotionType.IDENTITY


@dataclass
class FilmGrainData:
    seed: int = 0
    num_y_points: int = 0
    y_points: list = field(default_factory=lambda: [[0, 0] for _ in range(14)])
    chroma_scaling_from_luma: bool = False
    num_uv_points: list = field(default_factory=lambda: [0, 0])
    uv_points: list = field(
        default_factory=lambda: [[[0, 0] for _ in range(10)] for _ in range(2)]
    )
    scaling_shift: int = 0
    ar_coeff_lag: int = 0
    ar_coeffs_y: list = field(default_factory=lambda: [0] * 24)
    ar_coeffs_uv: list = field(default_factory=lambda: [[0] * 28 for _ in range(2)])
    ar_coeff_shift: int = 0
    grain_scale_shift: int = 0
    uv_mult: list = field(default_factory=lambda: [0, 0])
    uv_luma_mult: list = field(default_factory=lambda: [0, 0])
    uv_offset: list = field(default_factory=lambda: [0, 0])
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


@dataclass
class FilmGrain:
    data: FilmGrainData = field(default_factory=FilmGrainData)
    present: int = 0
    update: int = 0


@dataclass
class FrameHeaderOperatingPoint:
    buffer_removal_time: int = 0


@dataclass
class FrameHeader:
    size: FrameSize = field(default_factory=FrameSize)
    film_grain: FilmGrain = field(default_factory=FilmGrain)
    frame_type: FrameType = FrameType.KEY
    frame_offset: int = 0
    temporal_id: int = 0
    spatial_id: int = 0
    show_existing_frame: int = 0
    existing_frame_idx: int = 0
    frame_id: int = 0
    frame_presentation_delay: int = 0
    show_frame: int = 0
    showable_frame: int = 0
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    allow_screen_content_tools: bool = False
    force_integer_mv: bool = False
    frame_size_override: bool = False
    primary_ref_frame: int = PRIMARY_REF_NONE
    buffer_removal_time_present: int = 0
    operating_points: list = field(
        default_factory=lambda: [
            FrameHeaderOperatingPoint() for _ in range(MAX_OPERATING_POINTS)
        ]
    )
    refresh_frame_flags: int = 0
    allow_intrabc: bool = False
    frame_ref_short_signaling: int = 0
    refidx: list = field(default_factory=lambda: [0] * REFS_PER_FRAME)
    hp: bool = False
    subpel_filter_mode: FilterMode = FilterMode.REGULAR_8TAP
    switchable_motion_mode: int = 0
    use_ref_frame_mvs: int = 0
    refresh_context: int = 0
    tiling: Tiling = field(default_factory=Tiling)
    quant: Quant = field(default_factory=Quant)
    segmentation: Segmentation = field(default_factory=Segmentation)
    delta: Delta = field(default_factory=Delta)
    all_lossless: bool = False
    loopfilter: Loopfilter = field(default_factory=Loopfilter)
    cdef: Cdef = field(default_factory=Cdef)
    restoration: Restoration = field(default_factory=Restoration)
    txfm_mode: TxfmMode = TxfmMode.ONLY_4X4
    switchable_comp_refs: int = 0
    skip_mode: SkipMode = field(default_factory=SkipMode)
    warp_motion: int = 0
    reduced_txtp_set: int = 0
    gmv: list = field(
        default_factory=lambda: [WarpedMotionParams() for _ in range(REFS_PER_FRAME)]
    )


@dataclass
class ContentLightLevel:
    max_content_light_level: int = 0
    max_frame_average_light_level: int = 0


@dataclass
class MasteringDisplay:
    primaries: list = field(default_factory=lambda: [[0, 0]] * 3)
    white_point: list = field(default_factory=lambda: [0, 0])
    max_luminance: int = 0
    min_luminance: int = 0


@dataclass
class ITUTT35:
    country_code: int = 0
    country_code_extension_byte: int = 0
    payload: bytes = b""


def get_poc_diff(order_hint_n_bits: int, poc0: int, poc1: int) -> int:
    """Signed wraparound distance between two order hints (src/env.rs get_poc_diff)."""
    if order_hint_n_bits == 0:
        return 0
    mask = 1 << (order_hint_n_bits - 1)
    diff = poc0 - poc1
    return (diff & (mask - 1)) - (diff & mask)
