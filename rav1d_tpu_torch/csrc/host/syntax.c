/* Native syntax pass: full per-superblock decode_sb/decode_b walk.
 *
 * Behavior parity: rav1d src/decode.rs (decode_sb:3260, decode_b:1131),
 * src/env.rs context helpers, src/warpmv.rs, src/lf_mask.rs recording,
 * src/recon.rs read_coef_blocks ordering. This is a fresh C implementation
 * ported from the validated Python anchor (rav1d_tpu/syntax/decode.py,
 * rav1d_tpu/recon/{coefs,intra,inter,lf,lf_mask}.py, syntax/{env,refmvs}.py)
 * which is itself bit-exact against the dav1d test-data md5 oracle.
 *
 * The decoder's two-pass split (rav1d frame-thread analog) is preserved:
 * this pass consumes msac symbols and emits (a) dequantized coefficient
 * blocks into the frame-wide CoefStore arrays and (b) fixed-size per-block
 * work records (BlockRec) plus side arenas (palettes, filter snapshots)
 * that the Python/TPU dense pass replays.
 *
 * Linked together with entropy.c (msac + decode_coefs) and refmvs.c
 * (dav1d_refmvs_find) into libsyntax.so; see rav1d_tpu/native/syntax.py.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define API __attribute__((visibility("default")))

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline int iclip_u8(int v) { return iclip(v, 0, 255); }
static inline int to_i16(int v) { return (int)(int16_t)(uint16_t)(v & 0xFFFF); }
static inline int apply_sign(int v, int64_t s) { return s < 0 ? -v : v; }
static inline int apply_sign64(int v, int64_t s) { return s < 0 ? -v : v; }
static inline int ulog2(unsigned v) { return 31 - __builtin_clz(v); }

/* ---------------------------------------------------------------------- */
/* structs shared with entropy.c / refmvs.c (kept in exact sync)          */

typedef struct Msac {
    const uint8_t *buf;
    size_t pos, end;
    uint64_t dif;
    uint32_t rng;
    int32_t cnt;
    int32_t allow_update;
} Msac;

uint32_t msac_decode_bool_equi(Msac *s);
uint32_t msac_decode_bool(Msac *s, uint32_t f);
uint32_t msac_decode_bool_adapt(Msac *s, uint16_t *cdf);
uint32_t msac_decode_symbol_adapt(Msac *s, uint16_t *cdf, size_t n_symbols);
uint32_t msac_decode_hi_tok(Msac *s, uint16_t *cdf);
uint32_t msac_decode_bools(Msac *s, uint32_t n);
uint32_t msac_decode_uniform(Msac *s, uint32_t n);
int32_t msac_decode_subexp(Msac *s, int32_t ref, int32_t n, uint32_t k);

typedef struct CoefCdfPtrs {
    uint16_t *skip;
    uint16_t *eob_bin_16;
    uint16_t *eob_bin_32;
    uint16_t *eob_bin_64;
    uint16_t *eob_bin_128;
    uint16_t *eob_bin_256;
    uint16_t *eob_bin_512;
    uint16_t *eob_bin_1024;
    uint16_t *eob_hi_bit;
    uint16_t *eob_base_tok;
    uint16_t *base_tok;
    uint16_t *br_tok;
    uint16_t *dc_sign;
} CoefCdfPtrs;

typedef struct CoefCallParams {
    int32_t tdim_lw, tdim_lh, tdim_w, tdim_h, tdim_ctx, tdim_min, tdim_max;
    int32_t bdim_lw, bdim_lh;
    int32_t chroma, ss_ver, ss_hor;
    int32_t ctx_off_idx;
    int32_t txtp_mode;
    int32_t txtp_fixed;
    int32_t skip_txtp;
    int32_t idtx_val;
    uint16_t *txtp_cdf;
    int32_t dq_dc, dq_ac, dq_shift, cf_max;
    uint8_t *a; int32_t a_off;
    uint8_t *l; int32_t l_off;
    const uint8_t *skip_ctx_tbl;
    const uint8_t *lo_ctx_offsets;
    const uint8_t *tx_types_per_set;
    const uint8_t *tx_type_class;
    const uint16_t *scan;
    const int32_t *qm;
    int32_t *cf;
    int32_t eob, txtp, cf_ctx;
} CoefCallParams;

void dav1d_decode_coefs(Msac *s, CoefCdfPtrs *cdf, CoefCallParams *p);

typedef struct RefMvsCall {
    const uint8_t *r;
    int32_t r_stride;
    const uint8_t *rp_proj;
    int32_t rp_stride;
    const uint8_t *bdims;
    int32_t pocdiff[7];
    int32_t sign_bias[7];
    int32_t use_ref_frame_mvs;
    int32_t iw4, ih4;
    int32_t col_start, col_end, row_start, row_end;
    int32_t bs, bw4, bh4;
    int32_t bx4, by4;
    int32_t ref0, ref1;
    int32_t edge_has_tr;
    int32_t force_integer_mv, hp;
    int32_t use_rfm_hdr;
    int32_t gmv[2][2];
    int32_t tgmv[2][2];
    int16_t out_mv[8][2][2];
    int32_t out_weight[8];
    int32_t out_cnt;
    int32_t out_ctx;
} RefMvsCall;

void dav1d_refmvs_find(RefMvsCall *p);

/* ---------------------------------------------------------------------- */
/* enums (rav1d src/levels.rs; values match rav1d_tpu/syntax/levels.py)    */

enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64 };
enum {
    RTX_4X8 = 5, RTX_8X4, RTX_8X16, RTX_16X8, RTX_16X32, RTX_32X16,
    RTX_32X64, RTX_64X32, RTX_4X16, RTX_16X4, RTX_8X32, RTX_32X8,
    RTX_16X64, RTX_64X16,
};
enum {
    DCT_DCT = 0, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST, IDTX, V_DCT, H_DCT,
    V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, WHT_WHT,
};
enum { TX_CLASS_2D = 0, TX_CLASS_H = 1, TX_CLASS_V = 2 };
enum {
    DC_PRED = 0, VERT_PRED, HOR_PRED, DIAG_DOWN_LEFT_PRED,
    DIAG_DOWN_RIGHT_PRED, VERT_RIGHT_PRED, HOR_DOWN_PRED, HOR_UP_PRED,
    VERT_LEFT_PRED, SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
};
#define CFL_PRED 13
#define FILTER_PRED 13
#define N_INTRA_PRED_MODES 13
#define N_UV_INTRA_PRED_MODES 14
#define N_COMP_INTER_PRED_MODES 8

enum { NEARESTMV = 0, NEARMV, GLOBALMV, NEWMV };
enum {
    NEARESTMV_NEARESTMV = 0, NEARMV_NEARMV, NEARESTMV_NEWMV,
    NEWMV_NEARESTMV, NEARMV_NEWMV, NEWMV_NEARMV, GLOBALMV_GLOBALMV,
    NEWMV_NEWMV,
};
enum { MM_TRANSLATION = 0, MM_OBMC, MM_WARP };
enum {
    COMP_INTER_NONE = 0, COMP_INTER_WEIGHTED_AVG, COMP_INTER_AVG,
    COMP_INTER_SEG, COMP_INTER_WEDGE,
};
enum { INTER_INTRA_NONE = 0, INTER_INTRA_BLEND, INTER_INTRA_WEDGE };
enum {
    PARTITION_NONE = 0, PARTITION_H, PARTITION_V, PARTITION_SPLIT,
    PARTITION_T_TOP_SPLIT, PARTITION_T_BOTTOM_SPLIT, PARTITION_T_LEFT_SPLIT,
    PARTITION_T_RIGHT_SPLIT, PARTITION_H4, PARTITION_V4,
};
enum { BL_128X128 = 0, BL_64X64, BL_32X32, BL_16X16, BL_8X8 };
enum {
    BS_128x128 = 0, BS_128x64, BS_64x128, BS_64x64, BS_64x32, BS_64x16,
    BS_32x64, BS_32x32, BS_32x16, BS_32x8, BS_16x64, BS_16x32, BS_16x16,
    BS_16x8, BS_16x4, BS_8x32, BS_8x16, BS_8x8, BS_8x4, BS_4x16, BS_4x8,
    BS_4x4,
};
enum {
    FILTER_2D_8TAP_REGULAR = 0, FILTER_2D_8TAP_REGULAR_SMOOTH,
    FILTER_2D_8TAP_REGULAR_SHARP, FILTER_2D_8TAP_SHARP_REGULAR,
    FILTER_2D_8TAP_SHARP_SMOOTH, FILTER_2D_8TAP_SHARP,
    FILTER_2D_8TAP_SMOOTH_REGULAR, FILTER_2D_8TAP_SMOOTH,
    FILTER_2D_8TAP_SMOOTH_SHARP, FILTER_2D_BILINEAR,
};
enum { MV_JOINT_ZERO = 0, MV_JOINT_H, MV_JOINT_V, MV_JOINT_HV };
enum { DRL_NEAREST = 0, DRL_NEARER, DRL_NEAR, DRL_NEARISH };
#define N_SWITCHABLE_FILTERS 3
#define INVALID_MV_X (-32768)
#define INVALID_MV_Y (-32768)

/* FrameType */
enum { FT_KEY = 0, FT_INTER, FT_INTRA, FT_SWITCH };
#define FT_IS_INTER_OR_SWITCH(t) ((t) == FT_INTER || (t) == FT_SWITCH)
#define FT_IS_KEY_OR_INTRA(t) ((t) == FT_KEY || (t) == FT_INTRA)
/* TxfmMode */
enum { TXFM_ONLY_4X4 = 0, TXFM_LARGEST, TXFM_SWITCHABLE };
/* FilterMode */
enum { FM_REGULAR = 0, FM_SMOOTH, FM_SHARP, FM_BILINEAR, FM_SWITCHABLE };
/* WarpedMotionType */
enum { WM_IDENTITY = 0, WM_TRANSLATION, WM_ROT_ZOOM, WM_AFFINE };
/* PixelLayout */
enum { PL_I400 = 0, PL_I420, PL_I422, PL_I444 };

/* ---------------------------------------------------------------------- */
/* spec tables (AV1 normative; parity src/tables.rs, block_tables.py)      */

/* block_dimensions[bs] = {w4, h4, lw4, lh4} (src/tables.rs:181) */
static const uint8_t b_dims[22][4] = {
    {32, 32, 5, 5}, {32, 16, 5, 4}, {16, 32, 4, 5}, {16, 16, 4, 4},
    {16, 8, 4, 3},  {16, 4, 4, 2},  {8, 16, 3, 4},  {8, 8, 3, 3},
    {8, 4, 3, 2},   {8, 2, 3, 1},   {4, 16, 2, 4},  {4, 8, 2, 3},
    {4, 4, 2, 2},   {4, 2, 2, 1},   {4, 1, 2, 0},   {2, 8, 1, 3},
    {2, 4, 1, 2},   {2, 2, 1, 1},   {2, 1, 1, 0},   {1, 4, 0, 2},
    {1, 2, 0, 1},   {1, 1, 0, 0},
};

/* txfm_dimensions[tx] = {w4, h4, lw, lh, min, max, sub, ctx} */
typedef struct TxfmInfo {
    uint8_t w, h, lw, lh, min, max, sub, ctx;
} TxfmInfo;
static const TxfmInfo t_dims[19] = {
    {1, 1, 0, 0, 0, 0, 0, 0},          /* TX_4X4 */
    {2, 2, 1, 1, 1, 1, TX_4X4, 1},     /* TX_8X8 */
    {4, 4, 2, 2, 2, 2, TX_8X8, 2},     /* TX_16X16 */
    {8, 8, 3, 3, 3, 3, TX_16X16, 3},   /* TX_32X32 */
    {16, 16, 4, 4, 4, 4, TX_32X32, 4}, /* TX_64X64 */
    {1, 2, 0, 1, 0, 1, TX_4X4, 1},     /* RTX_4X8 */
    {2, 1, 1, 0, 0, 1, TX_4X4, 1},     /* RTX_8X4 */
    {2, 4, 1, 2, 1, 2, TX_8X8, 2},     /* RTX_8X16 */
    {4, 2, 2, 1, 1, 2, TX_8X8, 2},     /* RTX_16X8 */
    {4, 8, 2, 3, 2, 3, TX_16X16, 3},   /* RTX_16X32 */
    {8, 4, 3, 2, 2, 3, TX_16X16, 3},   /* RTX_32X16 */
    {8, 16, 3, 4, 3, 4, TX_32X32, 4},  /* RTX_32X64 */
    {16, 8, 4, 3, 3, 4, TX_32X32, 4},  /* RTX_64X32 */
    {1, 4, 0, 2, 0, 2, RTX_4X8, 1},    /* RTX_4X16 */
    {4, 1, 2, 0, 0, 2, RTX_8X4, 1},    /* RTX_16X4 */
    {2, 8, 1, 3, 1, 3, RTX_8X16, 2},   /* RTX_8X32 */
    {8, 2, 3, 1, 1, 3, RTX_16X8, 2},   /* RTX_32X8 */
    {4, 16, 2, 4, 2, 4, RTX_16X32, 3}, /* RTX_16X64 */
    {16, 4, 4, 2, 2, 4, RTX_32X16, 3}, /* RTX_64X16 */
};

/* block_sizes[bl][partition] = {bs0, bs1} (src/tables.rs:112) */
#define XX 255
static const uint8_t block_sizes_tbl[5][10][2] = {
    {{BS_128x128, XX}, {BS_128x64, XX}, {BS_64x128, XX}, {XX, XX},
     {BS_64x64, BS_128x64}, {BS_128x64, BS_64x64},
     {BS_64x64, BS_64x128}, {BS_64x128, BS_64x64}, {XX, XX}, {XX, XX}},
    {{BS_64x64, XX}, {BS_64x32, XX}, {BS_32x64, XX}, {XX, XX},
     {BS_32x32, BS_64x32}, {BS_64x32, BS_32x32},
     {BS_32x32, BS_32x64}, {BS_32x64, BS_32x32}, {BS_64x16, XX},
     {BS_16x64, XX}},
    {{BS_32x32, XX}, {BS_32x16, XX}, {BS_16x32, XX}, {XX, XX},
     {BS_16x16, BS_32x16}, {BS_32x16, BS_16x16},
     {BS_16x16, BS_16x32}, {BS_16x32, BS_16x16}, {BS_32x8, XX},
     {BS_8x32, XX}},
    {{BS_16x16, XX}, {BS_16x8, XX}, {BS_8x16, XX}, {XX, XX},
     {BS_8x8, BS_16x8}, {BS_16x8, BS_8x8},
     {BS_8x8, BS_8x16}, {BS_8x16, BS_8x8}, {BS_16x4, XX}, {BS_4x16, XX}},
    {{BS_8x8, XX}, {BS_8x4, XX}, {BS_4x8, XX}, {BS_4x4, XX},
     {XX, XX}, {XX, XX}, {XX, XX}, {XX, XX}, {XX, XX}, {XX, XX}},
};

/* al_part_ctx[al][bl][partition] (src/tables.rs:95) */
static const uint8_t al_part_ctx[2][5][10] = {
    {{0x00, 0x00, 0x10, 0xFF, 0x00, 0x10, 0x10, 0x10, 0xFF, 0xFF},
     {0x10, 0x10, 0x18, 0xFF, 0x10, 0x18, 0x18, 0x18, 0x10, 0x1C},
     {0x18, 0x18, 0x1C, 0xFF, 0x18, 0x1C, 0x1C, 0x1C, 0x18, 0x1E},
     {0x1C, 0x1C, 0x1E, 0xFF, 0x1C, 0x1E, 0x1E, 0x1E, 0x1C, 0x1F},
     {0x1E, 0x1E, 0x1F, 0x1F, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF}},
    {{0x00, 0x10, 0x00, 0xFF, 0x10, 0x10, 0x00, 0x10, 0xFF, 0xFF},
     {0x10, 0x18, 0x10, 0xFF, 0x18, 0x18, 0x10, 0x18, 0x1C, 0x10},
     {0x18, 0x1C, 0x18, 0xFF, 0x1C, 0x1C, 0x18, 0x1C, 0x1E, 0x18},
     {0x1C, 0x1E, 0x1C, 0xFF, 0x1E, 0x1E, 0x1C, 0x1E, 0x1F, 0x1C},
     {0x1E, 0x1F, 0x1E, 0x1F, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0xFF}},
};

static const uint8_t partition_type_count[5] = {7, 9, 9, 9, 3};

/* max_txfm_size_for_bs[bs][layout] (src/tables.rs:399) */
static const uint8_t max_txfm_size_for_bs[22][4] = {
    {TX_64X64, TX_32X32, TX_32X32, TX_32X32},
    {TX_64X64, TX_32X32, TX_32X32, TX_32X32},
    {TX_64X64, TX_32X32, 0, TX_32X32},
    {TX_64X64, TX_32X32, TX_32X32, TX_32X32},
    {RTX_64X32, RTX_32X16, TX_32X32, TX_32X32},
    {RTX_64X16, RTX_32X8, RTX_32X16, RTX_32X16},
    {RTX_32X64, RTX_16X32, 0, TX_32X32},
    {TX_32X32, TX_16X16, RTX_16X32, TX_32X32},
    {RTX_32X16, RTX_16X8, TX_16X16, RTX_32X16},
    {RTX_32X8, RTX_16X4, RTX_16X8, RTX_32X8},
    {RTX_16X64, RTX_8X32, 0, RTX_16X32},
    {RTX_16X32, RTX_8X16, 0, RTX_16X32},
    {TX_16X16, TX_8X8, RTX_8X16, TX_16X16},
    {RTX_16X8, RTX_8X4, TX_8X8, RTX_16X8},
    {RTX_16X4, RTX_8X4, RTX_8X4, RTX_16X4},
    {RTX_8X32, RTX_4X16, 0, RTX_8X32},
    {RTX_8X16, RTX_4X8, 0, RTX_8X16},
    {TX_8X8, TX_4X4, RTX_4X8, TX_8X8},
    {RTX_8X4, TX_4X4, TX_4X4, RTX_8X4},
    {RTX_4X16, RTX_4X8, 0, RTX_4X16},
    {RTX_4X8, TX_4X4, 0, RTX_4X8},
    {TX_4X4, TX_4X4, TX_4X4, TX_4X4},
};

static const uint8_t txtp_from_uvmode[14] = {
    DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, 0,
};

static const uint8_t tx_types_per_set_tbl[40] = {
    IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
    IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
    DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST,
    IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST,
    DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
    FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST,
};

static const uint8_t tx_type_class_tbl[17] = {
    TX_CLASS_2D, TX_CLASS_2D, TX_CLASS_2D, TX_CLASS_2D, TX_CLASS_2D,
    TX_CLASS_2D, TX_CLASS_2D, TX_CLASS_2D, TX_CLASS_2D, TX_CLASS_2D,
    TX_CLASS_V, TX_CLASS_H, TX_CLASS_V, TX_CLASS_H, TX_CLASS_V,
    TX_CLASS_H, TX_CLASS_2D,
};

static const uint8_t ymode_size_context[22] = {
    3, 3, 3, 3, 3, 2, 3, 3, 2, 1, 2, 2, 2, 1, 0, 1, 1, 1, 0, 0, 0, 0,
};

static const uint8_t intra_mode_context[13] = {
    0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0,
};

static const uint8_t filter_mode_to_y_mode[5] = {
    DC_PRED, VERT_PRED, HOR_PRED, HOR_DOWN_PRED, DC_PRED,
};

/* lo_ctx_offsets[idx][5][5] (block_tables.py LO_CTX_OFFSETS) */
static const uint8_t lo_ctx_offsets_tbl[3][25] = {
    {0, 1, 6, 6, 21, 1, 6, 6, 21, 21, 6, 6, 21, 21, 21, 6, 21, 21, 21, 21,
     21, 21, 21, 21, 21},
    {0, 16, 6, 6, 21, 16, 16, 6, 21, 21, 16, 16, 21, 21, 21, 16, 16, 21,
     21, 21, 16, 16, 21, 21, 21},
    {0, 11, 11, 11, 11, 11, 11, 11, 11, 11, 6, 6, 21, 21, 21, 6, 21, 21,
     21, 21, 21, 21, 21, 21, 21},
};

/* skip_ctx[la][ll] (block_tables.py SKIP_CTX) */
static const uint8_t skip_ctx_tbl2[5][5] = {
    {1, 2, 2, 2, 3},
    {2, 4, 4, 4, 5},
    {2, 4, 4, 4, 5},
    {2, 4, 4, 4, 5},
    {3, 5, 5, 5, 6},
};

/* filter_2d[filter_v][filter_h] (src/tables.rs dav1d_filter_2d) */
static const uint8_t filter_2d_tbl[4][4] = {
    {FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR_SMOOTH,
     FILTER_2D_8TAP_REGULAR_SHARP, FILTER_2D_8TAP_REGULAR},
    {FILTER_2D_8TAP_SMOOTH_REGULAR, FILTER_2D_8TAP_SMOOTH,
     FILTER_2D_8TAP_SMOOTH_SHARP, FILTER_2D_8TAP_REGULAR},
    {FILTER_2D_8TAP_SHARP_REGULAR, FILTER_2D_8TAP_SHARP_SMOOTH,
     FILTER_2D_8TAP_SHARP, FILTER_2D_8TAP_REGULAR},
    {FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR, FILTER_2D_8TAP_REGULAR,
     FILTER_2D_BILINEAR},
};

/* wedge/interintra masks (decode.py WEDGE_ALLOWED_MASK etc.) */
#define WEDGE_ALLOWED_MASK                                                  \
    ((1u << BS_32x32) | (1u << BS_32x16) | (1u << BS_32x8) |                \
     (1u << BS_16x32) | (1u << BS_16x16) | (1u << BS_16x8) |                \
     (1u << BS_8x32) | (1u << BS_8x16) | (1u << BS_8x8))
#define INTERINTRA_ALLOWED_MASK                                             \
    ((1u << BS_32x32) | (1u << BS_32x16) | (1u << BS_16x32) |               \
     (1u << BS_16x16) | (1u << BS_16x8) | (1u << BS_8x16) | (1u << BS_8x8))
static const uint8_t wedge_ctx_lut[22] = {
    0, 0, 0, 0, 0, 0, 0, 6, 5, 8, 0, 4, 3, 2, 0, 7, 1, 0, 0, 0, 0, 0,
};
/* cfl_allowed_mask: block sizes <= 32x32 with min dim <= 32 (tables.rs) */
#define CFL_ALLOWED_MASK                                                    \
    ((1u << BS_32x32) | (1u << BS_32x16) | (1u << BS_32x8) |                \
     (1u << BS_16x32) | (1u << BS_16x16) | (1u << BS_16x8) |                \
     (1u << BS_16x4) | (1u << BS_8x32) | (1u << BS_8x16) | (1u << BS_8x8) | \
     (1u << BS_8x4) | (1u << BS_4x16) | (1u << BS_4x8) | (1u << BS_4x4))

/* comp_inter_pred_modes[mode] = {mv0 mode, mv1 mode} */
static const uint8_t comp_inter_pred_modes[8][2] = {
    {NEARESTMV, NEARESTMV}, {NEARMV, NEARMV}, {NEARESTMV, NEWMV},
    {NEWMV, NEARESTMV}, {NEARMV, NEWMV}, {NEWMV, NEARMV},
    {GLOBALMV, GLOBALMV}, {NEWMV, NEWMV},
};

/* interintra_allowed sizes use ymode ctx; partition type count above. */

/* div_lut[f] = round(2^22/(256+f)) (AV1 spec 7.11.3.7; warp.py DIV_LUT) */
static int32_t div_lut[257];
static int div_lut_init_done = 0;
static void div_lut_init(void) {
    if (div_lut_init_done) return;
    for (int f = 0; f <= 256; f++)
        div_lut[f] = (int32_t)(((1 << 22) + (256 + f) / 2) / (256 + f));
    div_lut_init_done = 1;
}

/* ---------------------------------------------------------------------- */
/* interface structs (ctypes mirrors in rav1d_tpu/native/syntax.py)        */

typedef struct MvCompCdf {
    uint16_t *classes;   /* (11,)  */
    uint16_t *class0_fp; /* (2,4)  */
    uint16_t *classN_fp; /* (4,)   */
    uint16_t *class0_hp; /* (2,)   */
    uint16_t *classN_hp; /* (2,)   */
    uint16_t *class0;    /* (2,)   */
    uint16_t *classN;    /* (10,2) */
    uint16_t *sign;      /* (2,)   */
} MvCompCdf;

/* strides are the padded numpy layouts from entropy/cdf.py (+1 slot) */
typedef struct SyCdf {
    uint16_t *partition;       /* (5,4,10)  */
    uint16_t *kfym;            /* (5,5,13)  */
    uint16_t *y_mode;          /* (4,13)    */
    uint16_t *uv_mode;         /* (2,13,14) */
    uint16_t *angle_delta;     /* (8,7)     */
    uint16_t *filter_intra;    /* (5,)      */
    uint16_t *use_filter_intra;/* (22,2)    */
    uint16_t *cfl_sign;        /* (8,)      */
    uint16_t *cfl_alpha;       /* (6,16)    */
    uint16_t *txsz;            /* (4,3,3)   */
    uint16_t *txpart;          /* (7,3,2)   */
    uint16_t *skip;            /* (3,2)     */
    uint16_t *skip_mode;       /* (3,2)     */
    uint16_t *seg_pred;        /* (3,2)     */
    uint16_t *seg_id;          /* (3,8)     */
    uint16_t *delta_q;         /* (4,)      */
    uint16_t *delta_lf;        /* (5,4)     */
    uint16_t *intra;           /* (4,2)     */
    uint16_t *intrabc;         /* (2,)      */
    uint16_t *pal_y;           /* (7,3,2)   */
    uint16_t *pal_uv;          /* (2,2)     */
    uint16_t *pal_sz;          /* (2,7,7)   */
    uint16_t *color_map;       /* (2,7,5,8) */
    uint16_t *comp;            /* (5,2)     */
    uint16_t *comp_dir;        /* (5,2)     */
    uint16_t *comp_fwd_ref;    /* (3,3,2)   */
    uint16_t *comp_bwd_ref;    /* (2,3,2)   */
    uint16_t *comp_uni_ref;    /* (3,3,2)   */
    uint16_t *ref;             /* (6,3,2)   */
    uint16_t *comp_inter_mode; /* (8,8)     */
    uint16_t *newmv_mode;      /* (6,2)     */
    uint16_t *globalmv_mode;   /* (2,2)     */
    uint16_t *refmv_mode;      /* (6,2)     */
    uint16_t *drl_bit;         /* (3,2)     */
    uint16_t *interintra;      /* (7,2)     */
    uint16_t *interintra_mode; /* (4,4)     */
    uint16_t *interintra_wedge;/* (7,2)     */
    uint16_t *wedge_comp;      /* (9,2)     */
    uint16_t *wedge_idx;       /* (9,16)    */
    uint16_t *jnt_comp;        /* (6,2)     */
    uint16_t *mask_comp;       /* (6,2)     */
    uint16_t *motion_mode;     /* (22,3)    */
    uint16_t *obmc;            /* (22,2)    */
    uint16_t *filter;          /* (2,8,3)   */
    uint16_t *txtp_intra1;     /* (2,13,7)  */
    uint16_t *txtp_intra2;     /* (3,13,5)  */
    uint16_t *txtp_inter1;     /* (2,16)    */
    uint16_t *txtp_inter2;     /* (12,)     */
    uint16_t *txtp_inter3;     /* (4,2)     */
    uint16_t *mv_joint;        /* (4,)      */
    MvCompCdf mv_comp[2];
    MvCompCdf dmv_comp[2];
    CoefCdfPtrs coef;
} SyCdf;

/* neighbour context arrays (BlockContext; src/env.rs:32-50) */
typedef struct BlkCtx {
    uint8_t *mode, *uvmode;
    uint8_t *lcoef, *ccoef0, *ccoef1;
    uint8_t *seg_pred, *skip, *skip_mode, *intra, *comp_type;
    int8_t *ref0, *ref1;
    uint8_t *filter0, *filter1;
    int8_t *tx_intra;
    int8_t *tx;
    uint8_t *tx_lpf_y, *tx_lpf_uv;
    uint8_t *partition;
    uint8_t *pal_sz;
} BlkCtx;

/* the per-block output record (pass-1 -> pass-2 work item) */
typedef struct BlockRec {
    int64_t cf_pos;
    int32_t tx_pos;
    int32_t afilter_off;
    int32_t pal_off;
    int32_t palidx_off;
    int32_t wm_mat[6];
    int32_t matrix[4];
    uint32_t dbg_rng;
    int16_t bx, by;
    int16_t mv[2][2]; /* [n][x,y] */
    int16_t wm_alpha, wm_beta, wm_gamma, wm_delta;
    int16_t sm_fl, sm_uv_fl;
    uint16_t tx_split1; /* depth-1 var-tx mask is 16 bits wide */
    uint8_t kind;
    uint8_t bl, bs, bp;
    uint8_t intra, seg_id, skip_mode, skip;
    uint8_t y_mode, uv_mode, tx, uvtx, max_ytx;
    int8_t y_angle, uv_angle;
    int8_t cfl_alpha0, cfl_alpha1;
    uint8_t pal_sz0, pal_sz1;
    uint8_t tx_split0;
    uint8_t inter_mode, drl_idx, comp_type, motion_mode, filter2d;
    int8_t ref0, ref1;
    uint8_t interintra_type, interintra_mode, wedge_idx, mask_sign;
    uint8_t wm_type;
    uint8_t tl_4x4_filter;
    uint8_t intra_edge_flags;
} BlockRec;
_Static_assert(sizeof(BlockRec) == 128, "BlockRec layout");

/* frame-wide output cursors + arenas (CoefStore + work items) */
typedef struct SyOut {
    int32_t *cf;
    int32_t *eob;
    int32_t *txtp;
    int16_t *txw;
    int16_t *txh;
    int64_t *cf_off;
    uint8_t *txpl;   /* per-txblock dest plane */
    int32_t *txx;    /* per-txblock dest pixel coords */
    int32_t *txy;
    int64_t cf_pos;
    int32_t tx_pos;
    int32_t pad0;
    BlockRec *rec;
    int32_t n_rec, rec_cap;
    uint8_t *filt_arena;
    int32_t filt_pos, filt_cap;
    uint16_t *pal_arena;
    int32_t pal_pos, pal_cap; /* in u16 units */
    uint8_t *palidx_arena;
    int32_t palidx_pos, palidx_cap;
    int32_t error;
    int32_t pad1;
} SyOut;

/* per-segment data (Rav1dSegmentationData) */
typedef struct SySegData {
    int32_t delta_q;
    int32_t delta_lf_y_v, delta_lf_y_h, delta_lf_u, delta_lf_v;
    int32_t ref;
    int32_t skip;
    int32_t globalmv;
} SySegData;

typedef struct SyGmv {
    int32_t type;
    int32_t matrix[6];
} SyGmv;

/* frame-level constants + buffer pointers */
typedef struct SyFrame {
    /* geometry */
    int32_t bw, bh, w4, h4;
    int32_t sb_shift, sb_step, sb128, layout, bpc, b4_stride;
    int32_t sr_sb128w;
    /* frame header flags */
    int32_t frame_type, allow_intrabc, frame_offset;
    int32_t skip_mode_enabled, skip_mode_refs0, skip_mode_refs1;
    int32_t switchable_comp_refs, switchable_motion_mode, warp_motion;
    int32_t force_integer_mv, hp, subpel_filter_mode, dual_filter;
    int32_t txfm_mode, reduced_txtp_set, allow_screen_content_tools;
    int32_t filter_intra, inter_intra, masked_compound, jnt_comp;
    int32_t order_hint_n_bits, use_ref_frame_mvs;
    int32_t cdef_n_bits;
    int32_t delta_q_present, delta_q_res_log2;
    int32_t delta_lf_present, delta_lf_res_log2, delta_lf_multi;
    /* quant */
    int32_t qidx_yac, ydc_delta, uac_delta, udc_delta, vac_delta, vdc_delta;
    int32_t hbd; /* 0/1/2 dq-table row */
    /* segmentation */
    int32_t seg_enabled, seg_update_map, seg_temporal, seg_preskip;
    int32_t seg_last_active_segid;
    int32_t seg_lossless[8];
    int32_t seg_qidx[8];
    SySegData seg[8];
    /* loopfilter */
    int32_t lf_level_y[2], lf_level_u, lf_level_v;
    int32_t lf_mode_ref_delta_enabled;
    int32_t lf_mode_delta[2];
    int32_t lf_ref_delta[8];
    /* global motion + refs */
    SyGmv gmv[7];
    int32_t refpoc[7];   /* refp[i].frame_hdr.frame_offset */
    int32_t svc_scale[7];/* f.svc[i][0].scale */
    /* spec table pointers */
    const uint16_t *dq_tbl;    /* (3,256,2) */
    const uint16_t *scans[19];
    const int32_t *qm[19][3];  /* NULL when qm disabled */
    /* frame map buffers */
    int32_t *cdef_idx;  /* (n64h+1, cdef_stride) */
    int32_t cdef_stride;
    uint8_t *noskip4;   /* (bh+32, noskip_stride) */
    int32_t noskip_stride;
    uint8_t *cur_segmap; /* (rows, b4_stride) or NULL */
    uint8_t *prev_segmap;
    int32_t segmap_stride;
    uint8_t *lf_level;  /* (bh+1, b4_stride, 4) */
    uint8_t *lf_cls[4]; /* (bh+1, bw+1) each */
    int32_t lf_cls_stride;
    /* refmvs grids */
    uint8_t *rmv_r;      /* RB records, 12B */
    int32_t rmv_r_stride;
    uint8_t *rmv_rp_proj;/* TB records, 5B */
    int32_t rmv_rp_stride;
    int32_t rmv_pocdiff[7], rmv_sign_bias[7];
    int32_t rmv_use_ref_frame_mvs, rmv_iw4, rmv_ih4;
    /* debug */
    int32_t dbg_trace;
} SyFrame;

typedef struct SyTile {
    Msac *msac;
    SyCdf cdf;
    BlkCtx a;
    int32_t col_start, col_end, row_start, row_end;
    int32_t tile_row, tile_col, tile_idx;
    int32_t last_qidx;
    int32_t last_delta_lf[4];
    int32_t dq[8][3][2];
    uint8_t lflvl[8][4][8][2];
} SyTile;

typedef struct SyTask {
    int32_t bx, by;
    BlkCtx l;
    uint16_t *al_pal;   /* (2,32,3,8) */
    uint8_t *pal_sz_uv; /* (2,32) */
    uint16_t *pal;      /* (3,8) */
    uint8_t *pal_idx;   /* 2*64*64 */
    uint8_t *txtp_map;  /* (32,32) */
    int32_t tl_4x4_filter;
    int32_t wm_type;
    int32_t wm_mat[6];
    int32_t wm_alpha, wm_beta, wm_gamma, wm_delta;
    int32_t rt_col_start, rt_col_end, rt_row_start, rt_row_end;
} SyTask;

/* error codes */
enum {
    SYE_OK = 0,
    SYE_BAD_PREV_SEGID = -1,
    SYE_INTRABC_OVERLAP = -2,
    SYE_I422_VERT = -3,
    SYE_REC_OVERFLOW = -4,
    SYE_ARENA_OVERFLOW = -5,
};

/* ---------------------------------------------------------------------- */
/* small helpers ported from syntax/env.py + decode.py                     */

static int neg_deinterleave(int diff, int ref, int max) {
    if (ref == 0)
        return diff;
    if (ref >= max - 1)
        return max - diff - 1;
    if (2 * ref < max) {
        if (diff <= 2 * ref) {
            if (diff & 1)
                return ref + ((diff + 1) >> 1);
            return ref - (diff >> 1);
        }
        return diff;
    } else {
        if (diff <= 2 * (max - ref - 1)) {
            if (diff & 1)
                return ref + ((diff + 1) >> 1);
            return ref - (diff >> 1);
        }
        return max - (diff + 1);
    }
}

static int get_intra_ctx(const BlkCtx *a, const BlkCtx *l, int yb4, int xb4,
                         int have_top, int have_left) {
    if (have_left) {
        if (have_top) {
            int ctx = l->intra[yb4] + a->intra[xb4];
            return ctx + (ctx == 2);
        }
        return l->intra[yb4] * 2;
    }
    return have_top ? a->intra[xb4] * 2 : 0;
}

static int get_tx_ctx(const BlkCtx *a, const BlkCtx *l, const TxfmInfo *max_tx,
                      int yb4, int xb4) {
    return (l->tx_intra[yb4] >= (int)max_tx->lh) +
           (a->tx_intra[xb4] >= (int)max_tx->lw);
}

static uint32_t gather_left_partition_prob(const uint16_t *cdf, int bl) {
    uint32_t out = (uint32_t)cdf[PARTITION_H - 1] - cdf[PARTITION_H];
    out += (uint32_t)cdf[PARTITION_SPLIT - 1] - cdf[PARTITION_T_LEFT_SPLIT];
    if (bl != BL_128X128)
        out += (uint32_t)cdf[PARTITION_H4 - 1] - cdf[PARTITION_H4];
    return out;
}

static uint32_t gather_top_partition_prob(const uint16_t *cdf, int bl) {
    uint32_t out = (uint32_t)cdf[PARTITION_V - 1] - cdf[PARTITION_T_TOP_SPLIT];
    out += (uint32_t)cdf[PARTITION_T_LEFT_SPLIT - 1];
    if (bl != BL_128X128)
        out += (uint32_t)cdf[PARTITION_V4 - 1] - cdf[PARTITION_T_RIGHT_SPLIT];
    return out;
}

static int get_uv_inter_txtp(const TxfmInfo *uvt_dim, int ytxtp) {
    if (uvt_dim->max == TX_32X32)
        return ytxtp == IDTX ? IDTX : DCT_DCT;
    if (uvt_dim->min == TX_16X16 &&
        ((1 << ytxtp) & ((1 << H_FLIPADST) | (1 << V_FLIPADST) |
                         (1 << H_ADST) | (1 << V_ADST))))
        return DCT_DCT;
    return ytxtp;
}

static int get_filter_ctx(const BlkCtx *a, const BlkCtx *l, int comp,
                          int direction, int ref, int yb4, int xb4) {
    int a_filter = N_SWITCHABLE_FILTERS;
    if (a->ref0[xb4] == ref || a->ref1[xb4] == ref)
        a_filter = direction ? a->filter1[xb4] : a->filter0[xb4];
    int l_filter = N_SWITCHABLE_FILTERS;
    if (l->ref0[yb4] == ref || l->ref1[yb4] == ref)
        l_filter = direction ? l->filter1[yb4] : l->filter0[yb4];
    int val;
    if (a_filter == l_filter)
        val = a_filter;
    else if (a_filter == N_SWITCHABLE_FILTERS)
        val = l_filter;
    else if (l_filter == N_SWITCHABLE_FILTERS)
        val = a_filter;
    else
        val = N_SWITCHABLE_FILTERS;
    return (comp ? 4 : 0) + val;
}

static int get_comp_ctx(const BlkCtx *a, const BlkCtx *l, int yb4, int xb4,
                        int have_top, int have_left) {
    if (have_top) {
        if (have_left) {
            if (a->comp_type[xb4]) {
                if (l->comp_type[yb4])
                    return 4;
                return 2 + ((l->ref0[yb4] & 0xFF) >= 4);
            } else if (l->comp_type[yb4]) {
                return 2 + ((a->ref0[xb4] & 0xFF) >= 4);
            } else {
                return (l->ref0[yb4] >= 4) != (a->ref0[xb4] >= 4) ? 1 : 0;
            }
        } else {
            return a->comp_type[xb4] ? 3 : (a->ref0[xb4] >= 4 ? 1 : 0);
        }
    } else if (have_left) {
        return l->comp_type[yb4] ? 3 : (l->ref0[yb4] >= 4 ? 1 : 0);
    }
    return 1;
}

static int has_uni_comp(const BlkCtx *e, int off) {
    return (e->ref0[off] < 4) == (e->ref1[off] < 4);
}

static int get_comp_dir_ctx(const BlkCtx *a, const BlkCtx *l, int yb4, int xb4,
                            int have_top, int have_left) {
    if (have_top && have_left) {
        int a_intra = a->intra[xb4] != 0, l_intra = l->intra[yb4] != 0;
        if (a_intra && l_intra)
            return 2;
        if (a_intra || l_intra) {
            const BlkCtx *edge = a_intra ? l : a;
            int off = a_intra ? yb4 : xb4;
            if (!edge->comp_type[off])
                return 2;
            return 1 + 2 * (has_uni_comp(edge, off) ? 1 : 0);
        }
        int a_comp = a->comp_type[xb4] != 0, l_comp = l->comp_type[yb4] != 0;
        int a_ref0 = a->ref0[xb4], l_ref0 = l->ref0[yb4];
        if (!a_comp && !l_comp) {
            return 1 + 2 * ((a_ref0 >= 4) == (l_ref0 >= 4));
        } else if (!a_comp || !l_comp) {
            const BlkCtx *edge = a_comp ? a : l;
            int off = a_comp ? xb4 : yb4;
            if (!has_uni_comp(edge, off))
                return 1;
            return 3 + ((a_ref0 >= 4) == (l_ref0 >= 4));
        } else {
            int a_uni = has_uni_comp(a, xb4), l_uni = has_uni_comp(l, yb4);
            if (!a_uni && !l_uni)
                return 0;
            if (!a_uni || !l_uni)
                return 2;
            return 3 + ((a_ref0 == 4) == (l_ref0 == 4));
        }
    } else if (have_top || have_left) {
        const BlkCtx *edge = have_left ? l : a;
        int off = have_left ? yb4 : xb4;
        if (edge->intra[off])
            return 2;
        if (!edge->comp_type[off])
            return 2;
        return 4 * (has_uni_comp(edge, off) ? 1 : 0);
    }
    return 2;
}

static int get_poc_diff(int order_hint_n_bits, int poc0, int poc1) {
    if (order_hint_n_bits == 0)
        return 0;
    int mask = 1 << (order_hint_n_bits - 1);
    int diff = poc0 - poc1;
    return (diff & (mask - 1)) - (diff & mask);
}

static int get_jnt_comp_ctx(int order_hint_n_bits, int poc, int ref0poc,
                            int ref1poc, const BlkCtx *a, const BlkCtx *l,
                            int yb4, int xb4) {
    int d0 = get_poc_diff(order_hint_n_bits, ref0poc, poc);
    int d1 = get_poc_diff(order_hint_n_bits, poc, ref1poc);
    if (d0 < 0) d0 = -d0;
    if (d1 < 0) d1 = -d1;
    int offset = d0 == d1;
    int a_ctx = a->comp_type[xb4] >= COMP_INTER_AVG || a->ref0[xb4] == 6;
    int l_ctx = l->comp_type[yb4] >= COMP_INTER_AVG || l->ref0[yb4] == 6;
    return 3 * offset + a_ctx + l_ctx;
}

static int get_mask_comp_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                             int xb4) {
    int a_ctx = a->comp_type[xb4] >= COMP_INTER_SEG
                    ? 1
                    : (a->ref0[xb4] == 6 ? 3 : 0);
    int l_ctx = l->comp_type[yb4] >= COMP_INTER_SEG
                    ? 1
                    : (l->ref0[yb4] == 6 ? 3 : 0);
    return imin(a_ctx + l_ctx, 5);
}

static int cmp_counts(int c1, int c2) { return c1 < c2 ? 0 : (c1 == c2 ? 1 : 2); }

static int av1_get_ref_ctx(const BlkCtx *a, const BlkCtx *l, int yb4, int xb4,
                           int have_top, int have_left) {
    int cnt[2] = {0, 0};
    if (have_top && !a->intra[xb4]) {
        cnt[a->ref0[xb4] >= 4] += 1;
        if (a->comp_type[xb4])
            cnt[a->ref1[xb4] >= 4] += 1;
    }
    if (have_left && !l->intra[yb4]) {
        cnt[l->ref0[yb4] >= 4] += 1;
        if (l->comp_type[yb4])
            cnt[l->ref1[yb4] >= 4] += 1;
    }
    return cmp_counts(cnt[0], cnt[1]);
}

static int av1_get_fwd_ref_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                               int xb4, int have_top, int have_left) {
    int cnt[4] = {0, 0, 0, 0};
    if (have_top && !a->intra[xb4]) {
        if (a->ref0[xb4] >= 0 && a->ref0[xb4] < 4)
            cnt[a->ref0[xb4]] += 1;
        if (a->comp_type[xb4] && a->ref1[xb4] >= 0 && a->ref1[xb4] < 4)
            cnt[a->ref1[xb4]] += 1;
    }
    if (have_left && !l->intra[yb4]) {
        if (l->ref0[yb4] >= 0 && l->ref0[yb4] < 4)
            cnt[l->ref0[yb4]] += 1;
        if (l->comp_type[yb4] && l->ref1[yb4] >= 0 && l->ref1[yb4] < 4)
            cnt[l->ref1[yb4]] += 1;
    }
    return cmp_counts(cnt[0] + cnt[1], cnt[2] + cnt[3]);
}

static int av1_get_fwd_ref_1_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                                 int xb4, int have_top, int have_left) {
    int cnt[2] = {0, 0};
    if (have_top && !a->intra[xb4]) {
        if (a->ref0[xb4] >= 0 && a->ref0[xb4] < 2)
            cnt[a->ref0[xb4]] += 1;
        if (a->comp_type[xb4] && a->ref1[xb4] >= 0 && a->ref1[xb4] < 2)
            cnt[a->ref1[xb4]] += 1;
    }
    if (have_left && !l->intra[yb4]) {
        if (l->ref0[yb4] >= 0 && l->ref0[yb4] < 2)
            cnt[l->ref0[yb4]] += 1;
        if (l->comp_type[yb4] && l->ref1[yb4] >= 0 && l->ref1[yb4] < 2)
            cnt[l->ref1[yb4]] += 1;
    }
    return cmp_counts(cnt[0], cnt[1]);
}

static int av1_get_fwd_ref_2_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                                 int xb4, int have_top, int have_left) {
    int cnt[2] = {0, 0};
    if (have_top && !a->intra[xb4]) {
        if (a->ref0[xb4] >= 2 && a->ref0[xb4] < 4)
            cnt[a->ref0[xb4] - 2] += 1;
        if (a->comp_type[xb4] && a->ref1[xb4] >= 2 && a->ref1[xb4] < 4)
            cnt[a->ref1[xb4] - 2] += 1;
    }
    if (have_left && !l->intra[yb4]) {
        if (l->ref0[yb4] >= 2 && l->ref0[yb4] < 4)
            cnt[l->ref0[yb4] - 2] += 1;
        if (l->comp_type[yb4] && l->ref1[yb4] >= 2 && l->ref1[yb4] < 4)
            cnt[l->ref1[yb4] - 2] += 1;
    }
    return cmp_counts(cnt[0], cnt[1]);
}

static int av1_get_bwd_ref_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                               int xb4, int have_top, int have_left) {
    int cnt[3] = {0, 0, 0};
    if (have_top && !a->intra[xb4]) {
        if (a->ref0[xb4] >= 4)
            cnt[a->ref0[xb4] - 4] += 1;
        if (a->comp_type[xb4] && a->ref1[xb4] >= 4)
            cnt[a->ref1[xb4] - 4] += 1;
    }
    if (have_left && !l->intra[yb4]) {
        if (l->ref0[yb4] >= 4)
            cnt[l->ref0[yb4] - 4] += 1;
        if (l->comp_type[yb4] && l->ref1[yb4] >= 4)
            cnt[l->ref1[yb4] - 4] += 1;
    }
    return cmp_counts(cnt[1] + cnt[0], cnt[2]);
}

static int av1_get_bwd_ref_1_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                                 int xb4, int have_top, int have_left) {
    int cnt[3] = {0, 0, 0};
    if (have_top && !a->intra[xb4]) {
        if (a->ref0[xb4] >= 4)
            cnt[a->ref0[xb4] - 4] += 1;
        if (a->comp_type[xb4] && a->ref1[xb4] >= 4)
            cnt[a->ref1[xb4] - 4] += 1;
    }
    if (have_left && !l->intra[yb4]) {
        if (l->ref0[yb4] >= 4)
            cnt[l->ref0[yb4] - 4] += 1;
        if (l->comp_type[yb4] && l->ref1[yb4] >= 4)
            cnt[l->ref1[yb4] - 4] += 1;
    }
    return cmp_counts(cnt[0], cnt[1]);
}

static int av1_get_uni_p1_ctx(const BlkCtx *a, const BlkCtx *l, int yb4,
                              int xb4, int have_top, int have_left) {
    int cnt[3] = {0, 0, 0};
    if (have_top && !a->intra[xb4]) {
        int r = a->ref0[xb4] - 1;
        if (r >= 0 && r < 3)
            cnt[r] += 1;
        if (a->comp_type[xb4]) {
            r = a->ref1[xb4] - 1;
            if (r >= 0 && r < 3)
                cnt[r] += 1;
        }
    }
    if (have_left && !l->intra[yb4]) {
        int r = l->ref0[yb4] - 1;
        if (r >= 0 && r < 3)
            cnt[r] += 1;
        if (l->comp_type[yb4]) {
            r = l->ref1[yb4] - 1;
            if (r >= 0 && r < 3)
                cnt[r] += 1;
        }
    }
    return cmp_counts(cnt[0], cnt[1] + cnt[2]);
}

/* mv precision fixes (env.py fix_mv_precision) */
static void fix_int_mv_precision(int *x, int *y) {
    *x = to_i16((*x - (*x >> 15) + 3) & ~7);
    *y = to_i16((*y - (*y >> 15) + 3) & ~7);
}

static void fix_mv_precision(const SyFrame *f, int *x, int *y) {
    if (f->force_integer_mv) {
        fix_int_mv_precision(x, y);
    } else if (!f->hp) {
        *x = to_i16((*x - (*x >> 15)) & ~1);
        *y = to_i16((*y - (*y >> 15)) & ~1);
    }
}

/* global-mv projection (env.py get_gmv_2d) */
static void get_gmv_2d(const SyFrame *f, const SyGmv *gmv, int bx4, int by4,
                       int bw4, int bh4, int *ox, int *oy) {
    if (gmv->type == WM_TRANSLATION) {
        int x = gmv->matrix[1] >> 13, y = gmv->matrix[0] >> 13;
        if (f->force_integer_mv)
            fix_int_mv_precision(&x, &y);
        *ox = to_i16(x);
        *oy = to_i16(y);
        return;
    }
    if (gmv->type == WM_IDENTITY) {
        *ox = 0;
        *oy = 0;
        return;
    }
    int x = bx4 * 4 + bw4 * 2 - 1;
    int y = by4 * 4 + bh4 * 2 - 1;
    int64_t xc = (int64_t)(gmv->matrix[2] - (1 << 16)) * x +
                 (int64_t)gmv->matrix[3] * y + gmv->matrix[0];
    int64_t yc = (int64_t)(gmv->matrix[5] - (1 << 16)) * y +
                 (int64_t)gmv->matrix[4] * x + gmv->matrix[1];
    int shift = 16 - (3 - (f->hp ? 0 : 1));
    int64_t rnd = (1ll << shift) >> 1;
    int sh2 = f->hp ? 0 : 1;
    int64_t axc = xc < 0 ? -xc : xc;
    int64_t ayc = yc < 0 ? -yc : yc;
    int mx = apply_sign64((int)(((axc + rnd) >> shift) << sh2), xc);
    int my = apply_sign64((int)(((ayc + rnd) >> shift) << sh2), yc);
    if (f->force_integer_mv)
        fix_int_mv_precision(&mx, &my);
    *ox = to_i16(mx);
    *oy = to_i16(my);
}

/* quant table init (decode.py init_quant_tables; src/decode.rs:194) */
static void init_quant_tables(const SyFrame *f, int qidx, int32_t dq[8][3][2]) {
    int n = f->seg_enabled ? 8 : 1;
    for (int i = 0; i < n; i++) {
        int yac = f->seg_enabled ? iclip_u8(qidx + f->seg[i].delta_q) : qidx;
        int ydc = iclip_u8(yac + f->ydc_delta);
        int uac = iclip_u8(yac + f->uac_delta);
        int udc = iclip_u8(yac + f->udc_delta);
        int vac = iclip_u8(yac + f->vac_delta);
        int vdc = iclip_u8(yac + f->vdc_delta);
        const uint16_t *tbl = f->dq_tbl + (size_t)f->hbd * 256 * 2;
        dq[i][0][0] = tbl[ydc * 2 + 0];
        dq[i][0][1] = tbl[yac * 2 + 1];
        dq[i][1][0] = tbl[udc * 2 + 0];
        dq[i][1][1] = tbl[uac * 2 + 1];
        dq[i][2][0] = tbl[vdc * 2 + 0];
        dq[i][2][1] = tbl[vac * 2 + 1];
    }
}

/* loopfilter level derivation (recon/lf_mask.py calc_lf_values;
 * src/lf_mask.rs:628-717) */
static void calc_lf_value(uint8_t out[8][2], int base_lvl, int lf_delta,
                          int seg_delta, const SyFrame *f) {
    int base = iclip(iclip(base_lvl + lf_delta, 0, 63) + seg_delta, 0, 63);
    if (f->lf_mode_ref_delta_enabled) {
        int sh = base >= 32;
        int v = iclip(base + f->lf_ref_delta[0] * (1 << sh), 0, 63);
        out[0][0] = out[0][1] = v;
        for (int r = 1; r < 8; r++)
            for (int m = 0; m < 2; m++) {
                int delta = f->lf_mode_delta[m] + f->lf_ref_delta[r];
                out[r][m] = iclip(base + delta * (1 << sh), 0, 63);
            }
    } else {
        for (int r = 0; r < 8; r++)
            out[r][0] = out[r][1] = base;
    }
}

static void calc_lf_values(const SyFrame *f, const int32_t lf_delta[4],
                           uint8_t out[8][4][8][2]) {
    int n_seg = f->seg_enabled ? 8 : 1;
    memset(out, 0, 8 * 4 * 8 * 2);
    if (f->lf_level_y[0] == 0 && f->lf_level_y[1] == 0)
        return;
    int multi = f->delta_lf_multi;
    for (int s = 0; s < n_seg; s++) {
        const SySegData *segd = f->seg_enabled ? &f->seg[s] : NULL;
        calc_lf_value(out[s][0], f->lf_level_y[0], lf_delta[0],
                      segd ? segd->delta_lf_y_v : 0, f);
        calc_lf_value(out[s][1], f->lf_level_y[1], lf_delta[multi ? 1 : 0],
                      segd ? segd->delta_lf_y_h : 0, f);
        if (f->lf_level_u)
            calc_lf_value(out[s][2], f->lf_level_u, lf_delta[multi ? 2 : 0],
                          segd ? segd->delta_lf_u : 0, f);
        if (f->lf_level_v)
            calc_lf_value(out[s][3], f->lf_level_v, lf_delta[multi ? 3 : 0],
                          segd ? segd->delta_lf_v : 0, f);
    }
}

/* tile-level table init, called from Python at tile setup */
API void sy_tile_init_tables(const SyFrame *f, SyTile *ts) {
    div_lut_init();
    ts->last_qidx = f->qidx_yac;
    ts->last_delta_lf[0] = ts->last_delta_lf[1] = 0;
    ts->last_delta_lf[2] = ts->last_delta_lf[3] = 0;
    init_quant_tables(f, f->qidx_yac, ts->dq);
    static const int32_t zero4[4] = {0, 0, 0, 0};
    calc_lf_values(f, zero4, ts->lflvl);
}

/* ---------------------------------------------------------------------- */
/* warped-motion derivation (recon/warp.py; src/warpmv.rs)                 */

typedef struct WarpP {
    int type;
    int32_t mat[6];
    int alpha, beta, gamma, delta;
} WarpP;

static int iclip_wmp(int v) {
    int cv = iclip(v, -32768, 32767);
    int acv = cv < 0 ? -cv : cv;
    return apply_sign((acv + 32) >> 6, cv) * (1 << 6);
}

static void resolve_divisor_32(uint32_t d, int *shift, int *div) {
    int sh = ulog2(d);
    int e = d - (1u << sh);
    int f = sh > 8 ? (e + (1 << (sh - 9))) >> (sh - 8) : e << (8 - sh);
    *shift = sh + 14;
    *div = div_lut[f];
}

static void resolve_divisor_64(uint64_t d, int *shift, int *div) {
    int sh = 63 - __builtin_clzll(d);
    uint64_t e = d - (1ull << sh);
    int f = sh > 8 ? (int)((e + (1ull << (sh - 9))) >> (sh - 8))
                   : (int)(e << (8 - sh));
    *shift = sh + 14;
    *div = div_lut[f];
}

/* returns 1 when shear params are invalid (src/warpmv.rs:51) */
static int get_shear_params(WarpP *wm) {
    const int32_t *mat = wm->mat;
    if (mat[2] <= 0)
        return 1;
    int alpha = to_i16(iclip_wmp(mat[2] - 0x10000));
    int beta = to_i16(iclip_wmp(mat[3]));
    int shift, y0;
    resolve_divisor_32((uint32_t)(mat[2] < 0 ? -mat[2] : mat[2]), &shift, &y0);
    int64_t y = mat[2] < 0 ? -(int64_t)y0 : y0;
    int64_t v1 = (int64_t)mat[4] * 0x10000 * y;
    int64_t rnd = (1ll << shift) >> 1;
    int64_t av1 = v1 < 0 ? -v1 : v1;
    int gamma = to_i16(iclip_wmp(apply_sign64((int)((av1 + rnd) >> shift), v1)));
    int64_t v2 = (int64_t)mat[3] * mat[4] * y;
    int64_t av2 = v2 < 0 ? -v2 : v2;
    int delta = to_i16(
        iclip_wmp(mat[5] - apply_sign64((int)((av2 + rnd) >> shift), v2) -
                  0x10000));
    wm->alpha = alpha;
    wm->beta = beta;
    wm->gamma = gamma;
    wm->delta = delta;
    int aa = alpha < 0 ? -alpha : alpha, ab = beta < 0 ? -beta : beta;
    int ag = gamma < 0 ? -gamma : gamma, ad = delta < 0 ? -delta : delta;
    return 4 * aa + 7 * ab >= 0x10000 || 4 * ag + 4 * ad >= 0x10000;
}

static int get_mult_shift_ndiag(int64_t px, int idet, int shift) {
    int64_t v1 = px * idet;
    int64_t av1 = v1 < 0 ? -v1 : v1;
    int v2 = apply_sign64((int)((av1 + ((1ll << shift) >> 1)) >> shift), v1);
    return iclip(v2, -0x1FFF, 0x1FFF);
}

static int get_mult_shift_diag(int64_t px, int idet, int shift) {
    int64_t v1 = px * idet;
    int64_t av1 = v1 < 0 ? -v1 : v1;
    int v2 = apply_sign64((int)((av1 + ((1ll << shift) >> 1)) >> shift), v1);
    return iclip(v2, 0xE001, 0x11FFF);
}

/* least-squares affine fit; returns 1 on failure (src/warpmv.rs:126) */
static int find_affine_int(int pts[8][2][2], int np, int bw4, int bh4,
                           int mv_x, int mv_y, WarpP *wm, int bx4, int by4) {
    int32_t *mat = wm->mat;
    int64_t a[2][2] = {{0, 0}, {0, 0}};
    int64_t bx[2] = {0, 0}, by[2] = {0, 0};
    int rsuy = 2 * bh4 - 1;
    int rsux = 2 * bw4 - 1;
    int suy = rsuy * 8, sux = rsux * 8;
    int duy = suy + mv_y, dux = sux + mv_x;
    int isuy = by4 * 4 + rsuy, isux = bx4 * 4 + rsux;

    for (int i = 0; i < np; i++) {
        int dx = pts[i][1][0] - dux;
        int dy = pts[i][1][1] - duy;
        int sx = pts[i][0][0] - sux;
        int sy = pts[i][0][1] - suy;
        int adx = sx - dx < 0 ? dx - sx : sx - dx;
        int ady = sy - dy < 0 ? dy - sy : sy - dy;
        if (adx < 256 && ady < 256) {
            a[0][0] += ((sx * sx) >> 2) + sx * 2 + 8;
            a[0][1] += ((sx * sy) >> 2) + sx + sy + 4;
            a[1][1] += ((sy * sy) >> 2) + sy * 2 + 8;
            bx[0] += ((sx * dx) >> 2) + sx + dx + 8;
            bx[1] += ((sy * dx) >> 2) + sy + dx + 4;
            by[0] += ((sx * dy) >> 2) + sx + dy + 4;
            by[1] += ((sy * dy) >> 2) + sy + dy + 8;
        }
    }

    int64_t det = a[0][0] * a[1][1] - a[0][1] * a[0][1];
    if (det == 0)
        return 1;
    int shift, idet0;
    resolve_divisor_64((uint64_t)(det < 0 ? -det : det), &shift, &idet0);
    int idet = det < 0 ? -idet0 : idet0;
    shift -= 16;
    if (shift < 0) {
        idet <<= -shift;
        shift = 0;
    }

    mat[2] = get_mult_shift_diag(a[1][1] * bx[0] - a[0][1] * bx[1], idet, shift);
    mat[3] = get_mult_shift_ndiag(a[0][0] * bx[1] - a[0][1] * bx[0], idet, shift);
    mat[4] = get_mult_shift_ndiag(a[1][1] * by[0] - a[0][1] * by[1], idet, shift);
    mat[5] = get_mult_shift_diag(a[0][0] * by[1] - a[0][1] * by[0], idet, shift);
    mat[0] = iclip(
        mv_x * 0x2000 - (isux * (mat[2] - 0x10000) + isuy * mat[3]),
        -0x800000, 0x7FFFFF);
    mat[1] = iclip(
        mv_y * 0x2000 - (isux * mat[4] + isuy * (mat[5] - 0x10000)),
        -0x800000, 0x7FFFFF);
    return 0;
}

/* refmvs spatial grid accessors (RB_DT packed 12-byte records) */
typedef struct RGridRec {
    int mv0x, mv0y, mv1x, mv1y;
    int ref0, ref1, bs, mf;
} RGridRec;

static inline void rgrid_load(const SyFrame *f, int row, int col, RGridRec *o) {
    const uint8_t *b =
        f->rmv_r + ((size_t)row * f->rmv_r_stride + col) * 12;
    const int16_t *mv = (const int16_t *)b;
    o->mv0x = mv[0];
    o->mv0y = mv[1];
    o->mv1x = mv[2];
    o->mv1y = mv[3];
    o->ref0 = (int8_t)b[8];
    o->ref1 = (int8_t)b[9];
    o->bs = b[10];
    o->mf = b[11];
}

/* splat_mv (refmvs.py splat_mv; refmvs.rs splat_mv) */
static void splat_mv(const SyFrame *f, int by4, int bx4, int bw4, int bh4,
                     int mv0x, int mv0y, int mv1x, int mv1y, int ref0,
                     int ref1, int bs, int mf) {
    uint8_t rec[12];
    int16_t *mv = (int16_t *)rec;
    mv[0] = (int16_t)mv0x;
    mv[1] = (int16_t)mv0y;
    mv[2] = (int16_t)mv1x;
    mv[3] = (int16_t)mv1y;
    rec[8] = (uint8_t)(int8_t)ref0;
    rec[9] = (uint8_t)(int8_t)ref1;
    rec[10] = (uint8_t)bs;
    rec[11] = (uint8_t)mf;
    for (int y = 0; y < bh4; y++) {
        uint8_t *row =
            f->rmv_r + ((size_t)(by4 + y) * f->rmv_r_stride + bx4) * 12;
        for (int x = 0; x < bw4; x++)
            memcpy(row + (size_t)x * 12, rec, 12);
    }
}

/* derive_warpmv (decode.py/recon/warp.py derive_warpmv) */
static void derive_warpmv(const SyFrame *f, SyTask *t, int bw4, int bh4,
                          uint64_t mask0, uint64_t mask1, int mvx, int mvy,
                          WarpP *wmp) {
    int pts[8][2][2];
    int np = 0;
    RGridRec r;

#define ADD_SAMPLE(dx, dy, sx, sy, rec)                                      \
    do {                                                                     \
        int _w4 = b_dims[(rec).bs][0], _h4 = b_dims[(rec).bs][1];            \
        pts[np][0][0] = 16 * (2 * (dx) + (sx) * _w4) - 8;                    \
        pts[np][0][1] = 16 * (2 * (dy) + (sy) * _h4) - 8;                    \
        pts[np][1][0] = pts[np][0][0] + (rec).mv0x;                          \
        pts[np][1][1] = pts[np][0][1] + (rec).mv0y;                          \
        np++;                                                                \
    } while (0)

    if ((mask0 & 0xFFFFFFFFull) == 1 && !(mask1 >> 32)) {
        rgrid_load(f, t->by - 1, t->bx, &r);
        int off = t->bx & (b_dims[r.bs][0] - 1);
        ADD_SAMPLE(-off, 0, 1, -1, r);
    } else {
        int off = 0;
        uint64_t xmask = mask0 & 0xFFFFFFFFull;
        while (np < 8 && xmask) {
            int tz = __builtin_ctzll(xmask);
            off += tz;
            xmask >>= tz;
            rgrid_load(f, t->by - 1, t->bx + off, &r);
            ADD_SAMPLE(off, 0, 1, -1, r);
            xmask &= ~(uint64_t)1;
        }
    }
    if (np < 8 && (mask1 & 0xFFFFFFFFull) == 1) {
        /* off derives from the block record at row 0; the sample itself is
         * taken at row -off (decode.py derive_warpmv left-single case) */
        rgrid_load(f, t->by, t->bx - 1, &r);
        int off = t->by & (b_dims[r.bs][1] - 1);
        RGridRec r2;
        rgrid_load(f, t->by - off, t->bx - 1, &r2);
        ADD_SAMPLE(0, -off, -1, 1, r2);
    } else {
        int off = 0;
        uint64_t ymask = mask1 & 0xFFFFFFFFull;
        while (np < 8 && ymask) {
            int tz = __builtin_ctzll(ymask);
            off += tz;
            ymask >>= tz;
            rgrid_load(f, t->by + off, t->bx - 1, &r);
            ADD_SAMPLE(0, off, -1, 1, r);
            ymask &= ~(uint64_t)1;
        }
    }
    if (np < 8 && (mask1 >> 32)) {
        rgrid_load(f, t->by - 1, t->bx - 1, &r);
        ADD_SAMPLE(0, 0, -1, -1, r);
    }
    if (np < 8 && (mask0 >> 32)) {
        rgrid_load(f, t->by - 1, t->bx + bw4, &r);
        ADD_SAMPLE(bw4, 0, 1, -1, r);
    }
#undef ADD_SAMPLE

    /* select samples by MV-difference threshold */
    int mvd[8];
    int ret = 0;
    int thresh = 4 * iclip(imax(bw4, bh4), 4, 28);
    for (int i = 0; i < np; i++) {
        int dx = pts[i][1][0] - pts[i][0][0] - mvx;
        int dy = pts[i][1][1] - pts[i][0][1] - mvy;
        mvd[i] = (dx < 0 ? -dx : dx) + (dy < 0 ? -dy : dy);
        if (mvd[i] > thresh)
            mvd[i] = -1;
        else
            ret++;
    }
    if (ret == 0) {
        ret = 1;
    } else {
        int i = 0, j = np - 1;
        for (int k = 0; k < np - ret; k++) {
            while (mvd[i] != -1)
                i++;
            while (mvd[j] == -1)
                j--;
            if (i > j)
                break;
            mvd[i] = mvd[j];
            pts[i][0][0] = pts[j][0][0];
            pts[i][0][1] = pts[j][0][1];
            pts[i][1][0] = pts[j][1][0];
            pts[i][1][1] = pts[j][1][1];
            i++;
            j--;
        }
    }

    if (!find_affine_int(pts, ret, bw4, bh4, mvx, mvy, wmp, t->bx, t->by) &&
        !get_shear_params(wmp))
        wmp->type = WM_AFFINE;
    else
        wmp->type = WM_IDENTITY;
}

/* drl context (env.py get_drl_context) over the refmvs_find output */
static int get_drl_ctx(const RefMvsCall *rc, int idx) {
    if (rc->out_weight[idx] >= 640)
        return rc->out_weight[idx + 1] < 640 ? 1 : 0;
    return rc->out_weight[idx + 1] < 640 ? 2 : 0;
}

/* run the native refmvs candidate scan (native/refmvs.c) */
static void refmvs_find(const SyFrame *f, const SyTask *t, int ref0, int ref1,
                        int bs, int edge_flags, RefMvsCall *rc) {
    rc->r = f->rmv_r;
    rc->r_stride = f->rmv_r_stride;
    rc->rp_proj = f->rmv_rp_proj;
    rc->rp_stride = f->rmv_rp_stride;
    rc->bdims = &b_dims[0][0];
    for (int i = 0; i < 7; i++) {
        rc->pocdiff[i] = f->rmv_pocdiff[i];
        rc->sign_bias[i] = f->rmv_sign_bias[i];
    }
    rc->use_ref_frame_mvs = f->rmv_use_ref_frame_mvs;
    rc->iw4 = f->rmv_iw4;
    rc->ih4 = f->rmv_ih4;
    rc->col_start = t->rt_col_start;
    rc->col_end = t->rt_col_end;
    rc->row_start = t->rt_row_start;
    rc->row_end = t->rt_row_end;
    rc->bs = bs;
    rc->bw4 = b_dims[bs][0];
    rc->bh4 = b_dims[bs][1];
    rc->bx4 = t->bx;
    rc->by4 = t->by;
    rc->ref0 = ref0;
    rc->ref1 = ref1;
    rc->edge_has_tr = (edge_flags & 1) ? 1 : 0; /* I444_TOP_HAS_RIGHT */
    rc->force_integer_mv = f->force_integer_mv;
    rc->hp = f->hp;
    rc->use_rfm_hdr = f->use_ref_frame_mvs;
    int refs[2] = {ref0, ref1};
    for (int n = 0; n < 2; n++) {
        int tgx = 0, tgy = 0;
        int gx = INVALID_MV_X, gy = INVALID_MV_Y;
        if (refs[n] > 0) {
            get_gmv_2d(f, &f->gmv[refs[n] - 1], t->bx, t->by, rc->bw4,
                       rc->bh4, &tgx, &tgy);
            if (f->gmv[refs[n] - 1].type > WM_TRANSLATION) {
                gx = tgx;
                gy = tgy;
            }
        }
        rc->tgmv[n][0] = tgx;
        rc->tgmv[n][1] = tgy;
        rc->gmv[n][0] = gx;
        rc->gmv[n][1] = gy;
    }
    dav1d_refmvs_find(rc);
}

/* ---------------------------------------------------------------------- */
/* per-block working record                                                */

typedef struct Blk {
    int bl, bs, bp, intra, seg_id, skip_mode, skip;
    int y_mode, uv_mode, tx, uvtx, max_ytx;
    int y_angle, uv_angle;
    int cfl_alpha[2];
    int pal_sz[2];
    int tx_split0, tx_split1;
    int inter_mode, drl_idx, comp_type, motion_mode, filter2d;
    int ref[2];
    int interintra_type, interintra_mode, wedge_idx, mask_sign;
    int mv[2][2]; /* [n][x,y] */
    int matrix[4];
} Blk;

/* ---------------------------------------------------------------------- */
/* decode_coefs bridge (recon/coefs.py decode_coefs native wrapper)        */

static void store_push(SyOut *out, int eob, int txtp, int sz, int w, int h,
                       int pl, int x, int y) {
    int i = out->tx_pos;
    out->eob[i] = eob;
    out->txtp[i] = txtp;
    out->txw[i] = (int16_t)w;
    out->txh[i] = (int16_t)h;
    out->cf_off[i] = out->cf_pos;
    out->txpl[i] = (uint8_t)pl;
    out->txx[i] = x;
    out->txy[i] = y;
    out->tx_pos = i + 1;
    out->cf_pos += sz;
}

static int decode_coefs_c(const SyFrame *f, SyTile *ts, SyOut *out,
                          uint8_t *a, int a_off, uint8_t *l, int l_off,
                          int tx, int bs, const Blk *b, int intra, int plane,
                          int ytxtp, int dst_x, int dst_y, int *eob_out,
                          int *txtp_out) {
    CoefCallParams p;
    const TxfmInfo *td = &t_dims[tx];
    int chroma = plane ? 1 : 0;
    int lossless = f->seg_lossless[b->seg_id];
    SyCdf *cdf = &ts->cdf;

    p.tdim_lw = td->lw;
    p.tdim_lh = td->lh;
    p.tdim_w = td->w;
    p.tdim_h = td->h;
    p.tdim_ctx = td->ctx;
    p.tdim_min = td->min;
    p.tdim_max = td->max;
    p.bdim_lw = b_dims[bs][2];
    p.bdim_lh = b_dims[bs][3];
    p.chroma = chroma;
    p.ss_ver = f->layout == PL_I420;
    p.ss_hor = f->layout != PL_I444;
    int nonsquare = tx >= RTX_4X8;
    p.ctx_off_idx = nonsquare + (tx & nonsquare);
    p.idtx_val = IDTX;
    p.skip_txtp = lossless ? WHT_WHT : DCT_DCT;

    uint16_t *txtp_cdf = NULL;
    if (lossless) {
        p.txtp_mode = 0;
        p.txtp_fixed = WHT_WHT;
    } else if (td->max + intra >= TX_64X64) {
        p.txtp_mode = 0;
        p.txtp_fixed = DCT_DCT;
    } else if (chroma) {
        p.txtp_mode = 0;
        p.txtp_fixed = intra ? txtp_from_uvmode[b->uv_mode]
                             : get_uv_inter_txtp(td, ytxtp);
    } else if (f->seg_qidx[b->seg_id] == 0) {
        p.txtp_mode = 0;
        p.txtp_fixed = DCT_DCT;
    } else if (intra) {
        int ym = b->y_mode == FILTER_PRED ? filter_mode_to_y_mode[b->y_angle]
                                          : b->y_mode;
        if (f->reduced_txtp_set || td->min == TX_16X16) {
            p.txtp_mode = 1;
            txtp_cdf = cdf->txtp_intra2 + ((size_t)td->min * 13 + ym) * 5;
        } else {
            p.txtp_mode = 2;
            txtp_cdf = cdf->txtp_intra1 + ((size_t)td->min * 13 + ym) * 7;
        }
    } else if (f->reduced_txtp_set || td->max == TX_32X32) {
        p.txtp_mode = 3;
        txtp_cdf = cdf->txtp_inter3 + (size_t)td->min * 2;
    } else if (td->min == TX_16X16) {
        p.txtp_mode = 4;
        txtp_cdf = cdf->txtp_inter2;
    } else {
        p.txtp_mode = 5;
        txtp_cdf = cdf->txtp_inter1 + (size_t)td->min * 16;
    }
    p.txtp_cdf = txtp_cdf;

    p.dq_dc = ts->dq[b->seg_id][plane][0];
    p.dq_ac = ts->dq[b->seg_id][plane][1];
    p.dq_shift = imax(0, td->ctx - 2);
    p.cf_max = (1 << (f->bpc + 7)) - 1;
    p.a = a;
    p.a_off = a_off;
    p.l = l;
    p.l_off = l_off;
    p.skip_ctx_tbl = &skip_ctx_tbl2[0][0];
    p.lo_ctx_offsets = &lo_ctx_offsets_tbl[0][0];
    p.tx_types_per_set = tx_types_per_set_tbl;
    p.tx_type_class = tx_type_class_tbl;
    p.scan = f->scans[tx];
    p.qm = f->qm[tx][plane];

    int sz = imin(td->w, 8) * imin(td->h, 8) * 16;
    int32_t *cf = out->cf + out->cf_pos;
    memset(cf, 0, (size_t)sz * 4);
    p.cf = cf;

    dav1d_decode_coefs(ts->msac, &cdf->coef, &p);
    *eob_out = p.eob;
    *txtp_out = p.txtp;
    store_push(out, p.eob, p.txtp, sz, td->w * 4, td->h * 4, plane, dst_x,
               dst_y);
    return p.cf_ctx;
}

/* intra coefficient-read walk (recon/intra.py recon_b_intra rd-parts +
 * _recon_chroma rd-parts; src/recon.rs read_coef_blocks ordering) */
static void intra_read_coefs(const SyFrame *f, SyTile *ts, SyTask *t,
                             SyOut *out, const Blk *b, int bs) {
    int layout = f->layout;
    int ss_ver = layout == PL_I420;
    int ss_hor = layout != PL_I444;
    int by4 = t->by & 31;
    int cby4 = by4 >> ss_ver;
    int bw4 = b_dims[bs][0], bh4 = b_dims[bs][1];
    int w4 = imin(bw4, f->bw - t->bx);
    int h4 = imin(bh4, f->bh - t->by);
    int cw4 = (w4 + ss_hor) >> ss_hor;
    int ch4 = (h4 + ss_ver) >> ss_ver;
    int has_chroma = layout != PL_I400 && (bw4 > ss_hor || (t->bx & 1)) &&
                     (bh4 > ss_ver || (t->by & 1));
    const TxfmInfo *td = &t_dims[b->tx];
    const TxfmInfo *uvtd = &t_dims[b->uvtx];

    for (int init_y = 0; init_y < h4; init_y += 16) {
        int sub_h4 = imin(h4, 16 + init_y);
        int sub_ch4 = imin(ch4, (init_y + 16) >> ss_ver);
        for (int init_x = 0; init_x < w4; init_x += 16) {
            int sub_w4 = imin(w4, init_x + 16);
            /* luma txblocks */
            int y = init_y;
            t->by += init_y;
            while (y < sub_h4) {
                int x = init_x;
                t->bx += init_x;
                while (x < sub_w4) {
                    if (!b->skip) {
                        int eob, txtp;
                        int cf_ctx = decode_coefs_c(
                            f, ts, out, ts->a.lcoef, t->bx, t->l.lcoef,
                            by4 + y, b->tx, bs, b, 1, 0, DCT_DCT,
                            4 * t->bx, 4 * t->by, &eob, &txtp);
                        int hn = imin(td->h, f->bh - t->by);
                        for (int i = 0; i < hn; i++)
                            t->l.lcoef[(by4 + y + i) & 31] = (uint8_t)cf_ctx;
                        int wn = imin(td->w, f->bw - t->bx);
                        for (int i = 0; i < wn; i++)
                            ts->a.lcoef[t->bx + i] = (uint8_t)cf_ctx;
                    } else {
                        for (int i = 0; i < td->h; i++)
                            t->l.lcoef[(by4 + y + i) & 31] = 0x40;
                        for (int i = 0; i < td->w; i++)
                            ts->a.lcoef[t->bx + i] = 0x40;
                    }
                    x += td->w;
                    t->bx += td->w;
                }
                t->bx -= x;
                y += td->h;
                t->by += td->h;
            }
            t->by -= y;

            if (has_chroma) {
                int sub_cw4 = imin(cw4, (init_x + 16) >> ss_hor);
                for (int pl = 0; pl < 2; pl++) {
                    uint8_t *ac = pl ? ts->a.ccoef1 : ts->a.ccoef0;
                    uint8_t *lc = pl ? t->l.ccoef1 : t->l.ccoef0;
                    int cy = init_y >> ss_ver;
                    t->by += init_y;
                    while (cy < sub_ch4) {
                        int cx = init_x >> ss_hor;
                        t->bx += init_x;
                        while (cx < sub_cw4) {
                            if (!b->skip) {
                                int eob, txtp;
                                int cf_ctx = decode_coefs_c(
                                    f, ts, out, ac, t->bx >> ss_hor, lc,
                                    cby4 + cy, b->uvtx, bs, b, 1, 1 + pl,
                                    DCT_DCT, 4 * (t->bx >> ss_hor),
                                    4 * (t->by >> ss_ver), &eob, &txtp);
                                int hn = imin(uvtd->h,
                                              (f->bh - t->by + ss_ver) >>
                                                  ss_ver);
                                for (int i = 0; i < hn; i++)
                                    lc[(cby4 + cy + i) & 31] =
                                        (uint8_t)cf_ctx;
                                int wn = imin(uvtd->w,
                                              (f->bw - t->bx + ss_hor) >>
                                                  ss_hor);
                                for (int i = 0; i < wn; i++)
                                    ac[(t->bx >> ss_hor) + i] =
                                        (uint8_t)cf_ctx;
                            } else {
                                for (int i = 0; i < uvtd->h; i++)
                                    lc[(cby4 + cy + i) & 31] = 0x40;
                                for (int i = 0; i < uvtd->w; i++)
                                    ac[(t->bx >> ss_hor) + i] = 0x40;
                            }
                            cx += uvtd->w;
                            t->bx += uvtd->w << ss_hor;
                        }
                        t->bx -= cx << ss_hor;
                        cy += uvtd->h;
                        t->by += uvtd->h << ss_ver;
                    }
                    t->by -= cy << ss_ver;
                }
            }
        }
    }
}

/* inter var-tx coefficient-read recursion (recon/inter.py read_coef_tree) */
static void read_coef_tree(const SyFrame *f, SyTile *ts, SyTask *t,
                           SyOut *out, const Blk *b, int bs, int ytx,
                           int depth, const int tx_split[2], int x_off,
                           int y_off) {
    const TxfmInfo *td = &t_dims[ytx];
    int txw = td->w, txh = td->h;
    if (depth < 2 && tx_split[depth] &&
        (tx_split[depth] & (1 << (y_off * 4 + x_off)))) {
        int sub = td->sub;
        const TxfmInfo *std = &t_dims[sub];
        int txsw = std->w, txsh = std->h;
        read_coef_tree(f, ts, t, out, b, bs, sub, depth + 1, tx_split,
                       x_off * 2, y_off * 2);
        t->bx += txsw;
        if (txw >= txh && t->bx < f->bw)
            read_coef_tree(f, ts, t, out, b, bs, sub, depth + 1, tx_split,
                           x_off * 2 + 1, y_off * 2);
        t->bx -= txsw;
        t->by += txsh;
        if (txh >= txw && t->by < f->bh) {
            read_coef_tree(f, ts, t, out, b, bs, sub, depth + 1, tx_split,
                           x_off * 2, y_off * 2 + 1);
            t->bx += txsw;
            if (txw >= txh && t->bx < f->bw)
                read_coef_tree(f, ts, t, out, b, bs, sub, depth + 1,
                               tx_split, x_off * 2 + 1, y_off * 2 + 1);
            t->bx -= txsw;
        }
        t->by -= txsh;
    } else {
        int bx4 = t->bx & 31;
        int by4 = t->by & 31;
        int eob, txtp;
        int cf_ctx = decode_coefs_c(f, ts, out, ts->a.lcoef, t->bx,
                                    t->l.lcoef, by4, ytx, bs, b, 0, 0,
                                    DCT_DCT, 4 * t->bx, 4 * t->by, &eob,
                                    &txtp);
        int hn = imin(txh, f->bh - t->by);
        for (int i = 0; i < hn; i++)
            t->l.lcoef[(by4 + i) & 31] = (uint8_t)cf_ctx;
        int wn = imin(txw, f->bw - t->bx);
        for (int i = 0; i < wn; i++)
            ts->a.lcoef[t->bx + i] = (uint8_t)cf_ctx;
        for (int yy = 0; yy < txh; yy++)
            for (int xx = 0; xx < txw; xx++)
                t->txtp_map[(by4 + yy) * 32 + bx4 + xx] = (uint8_t)txtp;
    }
}

/* inter residual read walk (recon/inter.py recon_b_inter residuals,
 * rd-parts) */
static void inter_read_coefs(const SyFrame *f, SyTile *ts, SyTask *t,
                             SyOut *out, const Blk *b, int bs) {
    int layout = f->layout;
    int ss_ver = layout == PL_I420;
    int ss_hor = layout != PL_I444;
    int bx4 = t->bx & 31;
    int by4 = t->by & 31;
    int cby4 = by4 >> ss_ver;
    int bw4 = b_dims[bs][0], bh4 = b_dims[bs][1];
    int w4 = imin(bw4, f->bw - t->bx);
    int h4 = imin(bh4, f->bh - t->by);
    int cbw4 = (bw4 + ss_hor) >> ss_hor;
    int cbh4 = (bh4 + ss_ver) >> ss_ver;
    int has_chroma = layout != PL_I400 && (bw4 > ss_hor || (t->bx & 1)) &&
                     (bh4 > ss_ver || (t->by & 1));
    int cw4 = (w4 + ss_hor) >> ss_hor;
    int ch4 = (h4 + ss_ver) >> ss_ver;

    if (b->skip) {
        for (int i = 0; i < bw4; i++)
            ts->a.lcoef[t->bx + i] = 0x40;
        for (int i = 0; i < bh4; i++)
            t->l.lcoef[(by4 + i) & 31] = 0x40;
        if (has_chroma) {
            int cbx_abs = t->bx >> ss_hor;
            for (int pl = 0; pl < 2; pl++) {
                uint8_t *ac = pl ? ts->a.ccoef1 : ts->a.ccoef0;
                uint8_t *lc = pl ? t->l.ccoef1 : t->l.ccoef0;
                for (int i = 0; i < cbw4; i++)
                    ac[cbx_abs + i] = 0x40;
                for (int i = 0; i < cbh4; i++)
                    lc[(cby4 + i) & 31] = 0x40;
            }
        }
        return;
    }
    const TxfmInfo *uvtd = &t_dims[b->uvtx];
    const TxfmInfo *ytd = &t_dims[b->max_ytx];
    int tx_split[2] = {b->tx_split0, b->tx_split1};

    for (int init_y = 0; init_y < bh4; init_y += 16) {
        for (int init_x = 0; init_x < bw4; init_x += 16) {
            int y_off = init_y ? 1 : 0;
            int y = init_y;
            t->by += init_y;
            while (y < imin(h4, init_y + 16)) {
                int x_off = init_x ? 1 : 0;
                int x = init_x;
                t->bx += init_x;
                while (x < imin(w4, init_x + 16)) {
                    read_coef_tree(f, ts, t, out, b, bs, b->max_ytx, 0,
                                   tx_split, x_off, y_off);
                    t->bx += ytd->w;
                    x += ytd->w;
                    x_off++;
                }
                t->bx -= x;
                t->by += ytd->h;
                y += ytd->h;
                y_off++;
            }
            t->by -= y;
            if (has_chroma) {
                for (int pl = 0; pl < 2; pl++) {
                    uint8_t *ac = pl ? ts->a.ccoef1 : ts->a.ccoef0;
                    uint8_t *lc = pl ? t->l.ccoef1 : t->l.ccoef0;
                    int cy = init_y >> ss_ver;
                    t->by += init_y;
                    while (cy < imin(ch4, (init_y + 16) >> ss_ver)) {
                        int cx = init_x >> ss_hor;
                        t->bx += init_x;
                        while (cx < imin(cw4, (init_x + 16) >> ss_hor)) {
                            int ytxtp = t->txtp_map
                                [((by4 + (cy << ss_ver)) & 31) * 32 +
                                 ((bx4 + (cx << ss_hor)) & 31)];
                            int eob, txtp;
                            int cf_ctx = decode_coefs_c(
                                f, ts, out, ac, t->bx >> ss_hor, lc,
                                cby4 + cy, b->uvtx, bs, b, 0, 1 + pl,
                                ytxtp, 4 * (t->bx >> ss_hor),
                                4 * (t->by >> ss_ver), &eob, &txtp);
                            int hn = imin(uvtd->h,
                                          (f->bh - t->by + ss_ver) >> ss_ver);
                            for (int i = 0; i < hn; i++)
                                lc[(cby4 + cy + i) & 31] = (uint8_t)cf_ctx;
                            int wn = imin(uvtd->w,
                                          (f->bw - t->bx + ss_hor) >> ss_hor);
                            for (int i = 0; i < wn; i++)
                                ac[(t->bx >> ss_hor) + i] = (uint8_t)cf_ctx;
                            t->bx += uvtd->w << ss_hor;
                            cx += uvtd->w;
                        }
                        t->bx -= cx << ss_hor;
                        t->by += uvtd->h << ss_ver;
                        cy += uvtd->h;
                    }
                    t->by -= cy << ss_ver;
                }
            }
        }
    }
}

/* ---------------------------------------------------------------------- */
/* loopfilter mask recording (recon/lf.py record_lf_*; src/lf_mask.rs)     */

static void decomp_tx(uint8_t txa[2][2][32][32], int from_tx, int depth,
                      int y_off, int x_off, const int tx_masks[2]) {
    const TxfmInfo *td = &t_dims[from_tx];
    int y0 = y_off * td->h;
    int x0 = x_off * td->w;
    int is_split = 0;
    if (from_tx != 0 && depth <= 1)
        is_split = (tx_masks[depth] >> (y_off * 4 + x_off)) & 1;
    if (is_split) {
        int sub = td->sub;
        decomp_tx(txa, sub, depth + 1, y_off * 2, x_off * 2, tx_masks);
        if (td->w >= td->h)
            decomp_tx(txa, sub, depth + 1, y_off * 2, x_off * 2 + 1,
                      tx_masks);
        if (td->h >= td->w) {
            decomp_tx(txa, sub, depth + 1, y_off * 2 + 1, x_off * 2,
                      tx_masks);
            if (td->w >= td->h)
                decomp_tx(txa, sub, depth + 1, y_off * 2 + 1, x_off * 2 + 1,
                          tx_masks);
        }
    } else {
        int lw = imin(2, td->lw), lh = imin(2, td->lh);
        for (int yy = y0; yy < y0 + td->h; yy++)
            for (int xx = x0; xx < x0 + td->w; xx++) {
                txa[0][0][yy][xx] = (uint8_t)lw;
                txa[1][0][yy][xx] = (uint8_t)lh;
            }
        for (int yy = y0; yy < y0 + td->h; yy++)
            txa[0][1][yy][x0] = (uint8_t)td->w;
        for (int xx = x0; xx < x0 + td->w; xx++)
            txa[1][1][y0][xx] = (uint8_t)td->h;
    }
}

static inline uint8_t *lf_lvl_at(const SyFrame *f, int row, int col, int c) {
    return f->lf_level + ((size_t)row * f->b4_stride + col) * 4 + c;
}

static void record_chroma_edges(const SyFrame *f, SyTile *ts, SyTask *t,
                                int uvtx, int cbx, int cby, int cbw4,
                                int cbh4, int skip_inter) {
    const TxfmInfo *uvtd = &t_dims[uvtx];
    int twl4c = uvtd->lw ? 1 : 0;
    int thl4c = uvtd->lh ? 1 : 0;
    uint8_t *cls_v = f->lf_cls[2];
    uint8_t *cls_h = f->lf_cls[3];
    int stride = f->lf_cls_stride;
    int ss_ver = f->layout == PL_I420;
    int cby4 = cby & (31 >> ss_ver);
    for (int y = 0; y < cbh4; y++)
        cls_v[(size_t)(cby + y) * stride + cbx] =
            imin(twl4c, t->l.tx_lpf_uv[(cby4 + y) & 31]) + 1;
    for (int x = 0; x < cbw4; x++)
        cls_h[(size_t)cby * stride + cbx + x] =
            imin(thl4c, ts->a.tx_lpf_uv[cbx + x]) + 1;
    if (!skip_inter) {
        for (int x = uvtd->w; x < cbw4; x += uvtd->w)
            for (int y = 0; y < cbh4; y++)
                cls_v[(size_t)(cby + y) * stride + cbx + x] = twl4c + 1;
        for (int y = uvtd->h; y < cbh4; y += uvtd->h)
            for (int x = 0; x < cbw4; x++)
                cls_h[(size_t)(cby + y) * stride + cbx + x] = thl4c + 1;
    }
    for (int y = 0; y < cbh4; y++)
        t->l.tx_lpf_uv[(cby4 + y) & 31] = (uint8_t)twl4c;
    for (int x = 0; x < cbw4; x++)
        ts->a.tx_lpf_uv[cbx + x] = (uint8_t)thl4c;
}

static void record_lf_intra(const SyFrame *f, SyTile *ts, SyTask *t,
                            const Blk *b, int bs, int has_chroma) {
    const uint8_t (*lvls)[8][2] = ts->lflvl[b->seg_id];
    int bx = t->bx, by = t->by;
    int bw4 = imin(f->w4 - bx, b_dims[bs][0]);
    int bh4 = imin(f->h4 - by, b_dims[bs][1]);

    if (bw4 > 0 && bh4 > 0) {
        for (int y = 0; y < bh4; y++)
            for (int x = 0; x < bw4; x++) {
                uint8_t *cell = lf_lvl_at(f, by + y, bx + x, 0);
                cell[0] = lvls[0][0][0];
                cell[1] = lvls[1][0][0];
            }
        const TxfmInfo *td = &t_dims[b->tx];
        int twl4c = imin(2, td->lw);
        int thl4c = imin(2, td->lh);
        uint8_t *cls_v = f->lf_cls[0];
        uint8_t *cls_h = f->lf_cls[1];
        int stride = f->lf_cls_stride;
        for (int y = 0; y < bh4; y++)
            cls_v[(size_t)(by + y) * stride + bx] =
                imin(twl4c, t->l.tx_lpf_y[(by + y) & 31]) + 1;
        for (int x = 0; x < bw4; x++)
            cls_h[(size_t)by * stride + bx + x] =
                imin(thl4c, ts->a.tx_lpf_y[bx + x]) + 1;
        for (int x = td->w; x < bw4; x += td->w)
            for (int y = 0; y < bh4; y++)
                cls_v[(size_t)(by + y) * stride + bx + x] = twl4c + 1;
        for (int y = td->h; y < bh4; y += td->h)
            for (int x = 0; x < bw4; x++)
                cls_h[(size_t)(by + y) * stride + bx + x] = thl4c + 1;
        for (int y = 0; y < bh4; y++)
            t->l.tx_lpf_y[(by + y) & 31] = (uint8_t)twl4c;
        for (int x = 0; x < bw4; x++)
            ts->a.tx_lpf_y[bx + x] = (uint8_t)thl4c;
    }

    if (!has_chroma)
        return;
    int ss_ver = f->layout == PL_I420;
    int ss_hor = f->layout != PL_I444;
    int cbw4 = imin(((f->w4 + ss_hor) >> ss_hor) - (bx >> ss_hor),
                    (b_dims[bs][0] + ss_hor) >> ss_hor);
    int cbh4 = imin(((f->h4 + ss_ver) >> ss_ver) - (by >> ss_ver),
                    (b_dims[bs][1] + ss_ver) >> ss_ver);
    if (cbw4 <= 0 || cbh4 <= 0)
        return;
    int cbx = bx >> ss_hor, cby = by >> ss_ver;
    for (int y = 0; y < cbh4; y++)
        for (int x = 0; x < cbw4; x++) {
            uint8_t *cell = lf_lvl_at(f, cby + y, cbx + x, 0);
            cell[2] = lvls[2][0][0];
            cell[3] = lvls[3][0][0];
        }
    record_chroma_edges(f, ts, t, b->uvtx, cbx, cby, cbw4, cbh4, 0);
}

static void record_lf_inter(const SyFrame *f, SyTile *ts, SyTask *t,
                            const Blk *b, int bs, int is_comp,
                            int has_chroma) {
    int is_globalmv =
        b->inter_mode == (is_comp ? GLOBALMV_GLOBALMV : GLOBALMV);
    int idx = is_globalmv ? 0 : 1;
    const uint8_t (*lvls)[8][2] = ts->lflvl[b->seg_id];
    int ref = b->ref[0] + 1;
    int bx = t->bx, by = t->by;
    int bw4 = imin(f->w4 - bx, b_dims[bs][0]);
    int bh4 = imin(f->h4 - by, b_dims[bs][1]);
    int max_ytx = b->max_ytx;
    int uvtx = b->uvtx;
    if (f->seg_lossless[b->seg_id]) {
        max_ytx = TX_4X4;
        uvtx = TX_4X4;
    }
    int tx_masks[2] = {b->tx_split0, b->tx_split1};

    if (bw4 > 0 && bh4 > 0) {
        for (int y = 0; y < bh4; y++)
            for (int x = 0; x < bw4; x++) {
                uint8_t *cell = lf_lvl_at(f, by + y, bx + x, 0);
                cell[0] = lvls[0][ref][idx];
                cell[1] = lvls[1][ref][idx];
            }
        const TxfmInfo *td = &t_dims[max_ytx];
        static uint8_t txa[2][2][32][32];
        memset(txa, 0, sizeof(txa));
        for (int y_off = 0; y_off < (bh4 + td->h - 1) / td->h; y_off++)
            for (int x_off = 0; x_off < (bw4 + td->w - 1) / td->w; x_off++)
                decomp_tx(txa, max_ytx, 0, y_off, x_off, tx_masks);

        uint8_t *cls_v = f->lf_cls[0];
        uint8_t *cls_h = f->lf_cls[1];
        int stride = f->lf_cls_stride;
        for (int y = 0; y < bh4; y++)
            cls_v[(size_t)(by + y) * stride + bx] =
                imin(txa[0][0][y][0], t->l.tx_lpf_y[(by + y) & 31]) + 1;
        for (int x = 0; x < bw4; x++)
            cls_h[(size_t)by * stride + bx + x] =
                imin(txa[1][0][0][x], ts->a.tx_lpf_y[bx + x]) + 1;
        if (!b->skip) {
            for (int y = 0; y < bh4; y++) {
                int ltx = txa[0][0][y][0];
                int x = txa[0][1][y][0];
                while (x < bw4) {
                    int rtx = txa[0][0][y][x];
                    cls_v[(size_t)(by + y) * stride + bx + x] =
                        imin(rtx, ltx) + 1;
                    ltx = rtx;
                    x += txa[0][1][y][x];
                }
            }
            for (int x = 0; x < bw4; x++) {
                int ttx = txa[1][0][0][x];
                int y = txa[1][1][0][x];
                while (y < bh4) {
                    int btx = txa[1][0][y][x];
                    cls_h[(size_t)(by + y) * stride + bx + x] =
                        imin(ttx, btx) + 1;
                    ttx = btx;
                    y += txa[1][1][y][x];
                }
            }
        }
        for (int y = 0; y < bh4; y++)
            t->l.tx_lpf_y[(by + y) & 31] = txa[0][0][y][bw4 - 1];
        for (int x = 0; x < bw4; x++)
            ts->a.tx_lpf_y[bx + x] = txa[1][0][bh4 - 1][x];
    }

    if (!has_chroma)
        return;
    int ss_ver = f->layout == PL_I420;
    int ss_hor = f->layout != PL_I444;
    int cbw4 = imin(((f->w4 + ss_hor) >> ss_hor) - (bx >> ss_hor),
                    (b_dims[bs][0] + ss_hor) >> ss_hor);
    int cbh4 = imin(((f->h4 + ss_ver) >> ss_ver) - (by >> ss_ver),
                    (b_dims[bs][1] + ss_ver) >> ss_ver);
    if (cbw4 <= 0 || cbh4 <= 0)
        return;
    int cbx = bx >> ss_hor, cby = by >> ss_ver;
    for (int y = 0; y < cbh4; y++)
        for (int x = 0; x < cbw4; x++) {
            uint8_t *cell = lf_lvl_at(f, cby + y, cbx + x, 0);
            cell[2] = lvls[2][ref][idx];
            cell[3] = lvls[3][ref][idx];
        }
    record_chroma_edges(f, ts, t, uvtx, cbx, cby, cbw4, cbh4, b->skip);
}

/* ---------------------------------------------------------------------- */
/* work-record emission                                                    */

static BlockRec *emit_rec(SyOut *out) {
    if (out->n_rec >= out->rec_cap) {
        if (!out->error)
            out->error = SYE_REC_OVERFLOW;
        return NULL;
    }
    BlockRec *r = &out->rec[out->n_rec++];
    memset(r, 0, sizeof(*r));
    r->afilter_off = -1;
    r->pal_off = -1;
    r->palidx_off = -1;
    return r;
}

static void rec_fill_blk(BlockRec *r, const Blk *b, const SyTask *t) {
    r->bx = (int16_t)t->bx;
    r->by = (int16_t)t->by;
    r->bl = (uint8_t)b->bl;
    r->bs = (uint8_t)b->bs;
    r->bp = (uint8_t)b->bp;
    r->intra = (uint8_t)b->intra;
    r->seg_id = (uint8_t)b->seg_id;
    r->skip_mode = (uint8_t)b->skip_mode;
    r->skip = (uint8_t)b->skip;
    r->y_mode = (uint8_t)b->y_mode;
    r->uv_mode = (uint8_t)b->uv_mode;
    r->tx = (uint8_t)b->tx;
    r->uvtx = (uint8_t)b->uvtx;
    r->max_ytx = (uint8_t)b->max_ytx;
    r->y_angle = (int8_t)b->y_angle;
    r->uv_angle = (int8_t)b->uv_angle;
    r->cfl_alpha0 = (int8_t)b->cfl_alpha[0];
    r->cfl_alpha1 = (int8_t)b->cfl_alpha[1];
    r->pal_sz0 = (uint8_t)b->pal_sz[0];
    r->pal_sz1 = (uint8_t)b->pal_sz[1];
    r->tx_split0 = (uint8_t)b->tx_split0;
    r->tx_split1 = (uint16_t)b->tx_split1;
    r->inter_mode = (uint8_t)b->inter_mode;
    r->drl_idx = (uint8_t)b->drl_idx;
    r->comp_type = (uint8_t)b->comp_type;
    r->motion_mode = (uint8_t)b->motion_mode;
    r->filter2d = (uint8_t)b->filter2d;
    r->ref0 = (int8_t)b->ref[0];
    r->ref1 = (int8_t)b->ref[1];
    r->interintra_type = (uint8_t)b->interintra_type;
    r->interintra_mode = (uint8_t)b->interintra_mode;
    r->wedge_idx = (uint8_t)b->wedge_idx;
    r->mask_sign = (uint8_t)b->mask_sign;
    r->mv[0][0] = (int16_t)b->mv[0][0];
    r->mv[0][1] = (int16_t)b->mv[0][1];
    r->mv[1][0] = (int16_t)b->mv[1][0];
    r->mv[1][1] = (int16_t)b->mv[1][1];
    for (int i = 0; i < 4; i++)
        r->matrix[i] = b->matrix[i];
}

/* inter work item with mutable-context snapshots
 * (decode.py _snapshot_inter_item) */
static BlockRec *snapshot_inter_item(const SyFrame *f, SyTile *ts, SyTask *t,
                                     SyOut *out, const Blk *b) {
    BlockRec *r = emit_rec(out);
    if (!r)
        return NULL;
    rec_fill_blk(r, b, t);
    r->kind = 1;
    int bw4 = b_dims[b->bs][0];
    int w4 = imin(bw4, f->bw - t->bx);
    int alen = w4 + 2;
    int need = 2 * alen + 64;
    if (out->filt_pos + need > out->filt_cap) {
        if (!out->error)
            out->error = SYE_ARENA_OVERFLOW;
        return NULL;
    }
    r->afilter_off = out->filt_pos;
    uint8_t *dst = out->filt_arena + out->filt_pos;
    memcpy(dst, ts->a.filter0 + t->bx, alen);
    memcpy(dst + alen, ts->a.filter1 + t->bx, alen);
    memcpy(dst + 2 * alen, t->l.filter0, 32);
    memcpy(dst + 2 * alen + 32, t->l.filter1, 32);
    out->filt_pos += need;
    r->tl_4x4_filter = (uint8_t)t->tl_4x4_filter;
    if (b->motion_mode == MM_WARP) {
        r->wm_type = (uint8_t)t->wm_type;
        for (int i = 0; i < 6; i++)
            r->wm_mat[i] = t->wm_mat[i];
        r->wm_alpha = (int16_t)t->wm_alpha;
        r->wm_beta = (int16_t)t->wm_beta;
        r->wm_gamma = (int16_t)t->wm_gamma;
        r->wm_delta = (int16_t)t->wm_delta;
    }
    r->tx_pos = out->tx_pos;
    r->cf_pos = out->cf_pos;
    return r;
}

/* ---------------------------------------------------------------------- */
/* mv residual coding (decode.py read_mv_component_diff/read_mv_residual)  */

static int read_mv_component_diff(Msac *s, const MvCompCdf *mcdf, int have_fp,
                                  int have_hp) {
    int sign = msac_decode_bool_adapt(s, mcdf->sign);
    int cl = msac_decode_symbol_adapt(s, mcdf->classes, 10);
    int up, fp, hp;
    if (cl == 0) {
        up = msac_decode_bool_adapt(s, mcdf->class0);
        if (have_fp) {
            fp = msac_decode_symbol_adapt(s, mcdf->class0_fp + up * 4, 3);
            hp = have_hp ? msac_decode_bool_adapt(s, mcdf->class0_hp) : 1;
        } else {
            fp = 3;
            hp = 1;
        }
    } else {
        up = 1 << cl;
        for (int n = 0; n < cl; n++)
            up |= msac_decode_bool_adapt(s, mcdf->classN + n * 2) << n;
        if (have_fp) {
            fp = msac_decode_symbol_adapt(s, mcdf->classN_fp, 3);
            hp = have_hp ? msac_decode_bool_adapt(s, mcdf->classN_hp) : 1;
        } else {
            fp = 3;
            hp = 1;
        }
    }
    int diff = ((up << 3) | (fp << 1) | hp) + 1;
    return sign ? -diff : diff;
}

/* refmv: int[2] = {x, y}. The joint always uses cdf.mv.joint, even with
 * dmv component cdfs (decode.py read_mv_residual). */
static void read_mv_residual(SyTile *ts, int mv[2], const MvCompCdf comp[2],
                             int have_fp, int have_hp) {
    Msac *s = ts->msac;
    int jt = msac_decode_symbol_adapt(s, ts->cdf.mv_joint, 3);
    if (jt == MV_JOINT_HV) {
        mv[1] = to_i16(mv[1] +
                       read_mv_component_diff(s, &comp[0], have_fp, have_hp));
        mv[0] = to_i16(mv[0] +
                       read_mv_component_diff(s, &comp[1], have_fp, have_hp));
    } else if (jt == MV_JOINT_H) {
        mv[0] = to_i16(mv[0] +
                       read_mv_component_diff(s, &comp[1], have_fp, have_hp));
    } else if (jt == MV_JOINT_V) {
        mv[1] = to_i16(mv[1] +
                       read_mv_component_diff(s, &comp[0], have_fp, have_hp));
    }
}

/* ---------------------------------------------------------------------- */
/* var-tx tree read (decode.py read_tx_tree / read_vartx_tree)             */

static void read_tx_tree(const SyFrame *f, SyTile *ts, SyTask *t, int from_tx,
                         int depth, int masks[2], int x_off, int y_off) {
    int by4 = t->by & 31;
    const TxfmInfo *td = &t_dims[from_tx];
    int txw = td->lw, txh = td->lh;
    int is_split;
    if (depth < 2 && from_tx > TX_4X4) {
        int cat = 2 * (TX_64X64 - td->max) - depth;
        int a = ts->a.tx[t->bx] < txw;
        int l = t->l.tx[by4] < txh;
        is_split = msac_decode_bool_adapt(
            ts->msac, ts->cdf.txpart + ((size_t)cat * 3 + a + l) * 2);
        if (is_split)
            masks[depth] |= 1 << (y_off * 4 + x_off);
    } else {
        is_split = 0;
    }
    if (is_split && td->max > TX_8X8) {
        int sub = td->sub;
        const TxfmInfo *std = &t_dims[sub];
        int txsw = std->w, txsh = std->h;
        read_tx_tree(f, ts, t, sub, depth + 1, masks, x_off * 2, y_off * 2);
        t->bx += txsw;
        if (txw >= txh && t->bx < f->bw)
            read_tx_tree(f, ts, t, sub, depth + 1, masks, x_off * 2 + 1,
                         y_off * 2);
        t->bx -= txsw;
        t->by += txsh;
        if (txh >= txw && t->by < f->bh) {
            read_tx_tree(f, ts, t, sub, depth + 1, masks, x_off * 2,
                         y_off * 2 + 1);
            t->bx += txsw;
            if (txw >= txh && t->bx < f->bw)
                read_tx_tree(f, ts, t, sub, depth + 1, masks, x_off * 2 + 1,
                             y_off * 2 + 1);
            t->bx -= txsw;
        }
        t->by -= txsh;
    } else {
        int av = is_split ? TX_4X4 : txw;
        int lv = is_split ? TX_4X4 : txh;
        for (int i = 0; i < td->w; i++)
            ts->a.tx[t->bx + i] = (int8_t)av;
        for (int i = 0; i < td->h; i++)
            t->l.tx[(by4 + i) & 31] = (int8_t)lv;
    }
}

static void read_vartx_tree(const SyFrame *f, SyTile *ts, SyTask *t, Blk *b,
                            int bs, int bx4, int by4) {
    int bw4 = b_dims[bs][0], bh4 = b_dims[bs][1];
    int tx_split[2] = {0, 0};
    b->max_ytx = max_txfm_size_for_bs[bs][0];
    int txfm_mode = f->txfm_mode;
    if (!b->skip &&
        (f->seg_lossless[b->seg_id] || b->max_ytx == TX_4X4)) {
        b->uvtx = TX_4X4;
        b->max_ytx = TX_4X4;
        if (txfm_mode == TXFM_SWITCHABLE) {
            for (int i = 0; i < bw4; i++)
                ts->a.tx[t->bx + i] = TX_4X4;
            for (int i = 0; i < bh4; i++)
                t->l.tx[(by4 + i) & 31] = TX_4X4;
        }
    } else if (txfm_mode != TXFM_SWITCHABLE || b->skip) {
        if (txfm_mode == TXFM_SWITCHABLE) {
            for (int i = 0; i < bw4; i++)
                ts->a.tx[t->bx + i] = (int8_t)b_dims[bs][2];
            for (int i = 0; i < bh4; i++)
                t->l.tx[(by4 + i) & 31] = (int8_t)b_dims[bs][3];
        }
        b->uvtx = max_txfm_size_for_bs[bs][f->layout];
    } else {
        const TxfmInfo *ytd = &t_dims[b->max_ytx];
        for (int y_off = 0; y_off < bh4 / ytd->h; y_off++) {
            for (int x_off = 0; x_off < bw4 / ytd->w; x_off++) {
                read_tx_tree(f, ts, t, b->max_ytx, 0, tx_split, x_off,
                             y_off);
                t->bx += ytd->w;
            }
            t->bx -= bw4;
            t->by += ytd->h;
        }
        t->by -= bh4;
        b->uvtx = max_txfm_size_for_bs[bs][f->layout];
    }
    b->tx_split0 = tx_split[0];
    b->tx_split1 = tx_split[1];
}

/* ---------------------------------------------------------------------- */
/* palette coding (decode.py _read_pal_plane/_read_pal_uv/_read_pal_indices
 * ; src/recon.rs rav1d_read_pal_*)                                        */

static inline uint16_t *al_pal_at(SyTask *t, int dir, int b4, int pl) {
    return t->al_pal + (((size_t)dir * 32 + b4) * 3 + pl) * 8;
}

static void read_pal_plane(const SyFrame *f, SyTile *ts, SyTask *t, Blk *b,
                           int pl, int sz_ctx, int bx4, int by4) {
    Msac *s = ts->msac;
    int pli = pl ? 1 : 0;
    int not_pl = pl ? 0 : 1;
    int pal_sz =
        msac_decode_symbol_adapt(
            s, ts->cdf.pal_sz + ((size_t)pli * 7 + sz_ctx) * 7, 6) +
        2;
    b->pal_sz[pli] = pal_sz;
    int cache[16];
    int n_cache = 0;
    int l_cache = pl ? t->pal_sz_uv[32 + by4] : t->l.pal_sz[by4];
    int a_cache = 0;
    if (t->by & 15)
        a_cache = pl ? t->pal_sz_uv[bx4] : ts->a.pal_sz[t->bx];
    const uint16_t *lp = al_pal_at(t, 1, by4, pli);
    const uint16_t *ap = al_pal_at(t, 0, bx4, pli);
    int li = 0, ai = 0;
    while (l_cache && a_cache) {
        if (lp[li] < ap[ai]) {
            if (!n_cache || cache[n_cache - 1] != lp[li])
                cache[n_cache++] = lp[li];
            li++;
            l_cache--;
        } else {
            if (ap[ai] == lp[li]) {
                li++;
                l_cache--;
            }
            if (!n_cache || cache[n_cache - 1] != ap[ai])
                cache[n_cache++] = ap[ai];
            ai++;
            a_cache--;
        }
    }
    if (l_cache) {
        do {
            if (!n_cache || cache[n_cache - 1] != lp[li])
                cache[n_cache++] = lp[li];
            li++;
            l_cache--;
        } while (l_cache > 0);
    } else if (a_cache) {
        do {
            if (!n_cache || cache[n_cache - 1] != ap[ai])
                cache[n_cache++] = ap[ai];
            ai++;
            a_cache--;
        } while (a_cache > 0);
    }
    int used_cache[8];
    int n_used = 0;
    for (int c = 0; c < n_cache; c++) {
        if (n_used >= pal_sz)
            break;
        if (msac_decode_bool_equi(s))
            used_cache[n_used++] = cache[c];
    }

    uint16_t *pal = t->pal + (size_t)pli * 8;
    int i = n_used;
    int bpc = f->bpc;
    if (i < pal_sz) {
        int prev = msac_decode_bools(s, bpc);
        pal[i++] = (uint16_t)prev;
        if (i < pal_sz) {
            int bits = bpc + msac_decode_bools(s, 2) - 3;
            int maxv = (1 << bpc) - 1;
            for (;;) {
                int delta = msac_decode_bools(s, bits);
                prev = imin(prev + delta + not_pl, maxv);
                pal[i++] = (uint16_t)prev;
                if (prev + not_pl >= maxv) {
                    for (int j = i; j < pal_sz; j++)
                        pal[j] = (uint16_t)maxv;
                    break;
                }
                bits = imin(bits, 1 + ulog2(maxv - prev - not_pl));
                if (i >= pal_sz)
                    break;
            }
        }
        /* merge sorted cache + new entries */
        int merged[8];
        int n = 0, m = n_used;
        int new_vals[8];
        for (int k = 0; k < pal_sz; k++)
            new_vals[k] = pal[k];
        for (int k = 0; k < pal_sz; k++) {
            if (n < n_used && (m >= pal_sz || used_cache[n] <= new_vals[m]))
                merged[k] = used_cache[n++];
            else
                merged[k] = new_vals[m++];
        }
        for (int k = 0; k < pal_sz; k++)
            pal[k] = (uint16_t)merged[k];
    } else {
        for (int k = 0; k < n_used; k++)
            pal[k] = (uint16_t)used_cache[k];
    }
}

static void read_pal_uv(const SyFrame *f, SyTile *ts, SyTask *t, Blk *b,
                        int sz_ctx, int bx4, int by4) {
    read_pal_plane(f, ts, t, b, 1, sz_ctx, bx4, by4);
    Msac *s = ts->msac;
    uint16_t *pal = t->pal + 2 * 8;
    int bpc = f->bpc;
    int n = b->pal_sz[1];
    if (msac_decode_bool_equi(s)) {
        int bits = bpc + msac_decode_bools(s, 2) - 4;
        int prev = msac_decode_bools(s, bpc);
        pal[0] = (uint16_t)prev;
        int maxv = (1 << bpc) - 1;
        for (int k = 1; k < n; k++) {
            int delta = msac_decode_bools(s, bits);
            if (delta && msac_decode_bool_equi(s))
                delta = -delta;
            prev = (prev + delta) & maxv;
            pal[k] = (uint16_t)prev;
        }
    } else {
        for (int k = 0; k < n; k++)
            pal[k] = (uint16_t)msac_decode_bools(s, bpc);
    }
}

/* diagonal scan order helper (decode.py _order_palette) */
static void order_palette(const uint8_t *pal_idx, int stride, int i,
                          int first, int last, uint8_t order[64][8],
                          uint8_t ctx[64]) {
    int have_top = i > first;
    int n = 0;
    int offset = first + (i - first) * stride;
    for (int j = first; j >= last; j--, n++) {
        int have_left = j > 0;
        unsigned mask = 0;
        int no = 0;
        uint8_t *o = order[n];
#define ADD(v)                                                               \
    do {                                                                     \
        o[no++] = (uint8_t)(v);                                              \
        mask |= 1u << (v);                                                   \
    } while (0)
        if (!have_left) {
            ctx[n] = 0;
            ADD(pal_idx[offset - stride]);
        } else if (!have_top) {
            ctx[n] = 0;
            ADD(pal_idx[offset - 1]);
        } else {
            int l = pal_idx[offset - 1];
            int tp = pal_idx[offset - stride];
            int tl = pal_idx[offset - (stride + 1)];
            int same_t_l = tp == l;
            int same_t_tl = tp == tl;
            int same_l_tl = l == tl;
            int same_all = same_t_l && same_t_tl && same_l_tl;
            if (same_all) {
                ctx[n] = 4;
                ADD(tp);
            } else if (same_t_l) {
                ctx[n] = 3;
                ADD(tp);
                ADD(tl);
            } else if (same_t_tl || same_l_tl) {
                ctx[n] = 2;
                ADD(tl);
                ADD(same_t_tl ? l : tp);
            } else {
                ctx[n] = 1;
                ADD(imin(tp, l));
                ADD(imax(tp, l));
                ADD(tl);
            }
        }
        for (int bit = 0; bit < 8; bit++)
            if (!(mask & (1u << bit)))
                o[no++] = (uint8_t)bit;
#undef ADD
        have_top = 1;
        offset += stride - 1;
    }
}

static void read_pal_indices(SyTile *ts, SyTask *t, uint8_t *pal_idx, Blk *b,
                             int pl, int w4, int h4, int bw4, int bh4) {
    Msac *s = ts->msac;
    int pli = pl ? 1 : 0;
    int pal_sz = b->pal_sz[pli];
    int stride = bw4 * 4;
    pal_idx[0] = (uint8_t)msac_decode_uniform(s, pal_sz);
    uint16_t *color_map_cdf =
        ts->cdf.color_map + (((size_t)pli * 7 + (pal_sz - 2)) * 5) * 8;
    static uint8_t order[64][8];
    static uint8_t ctx[64];
    for (int i = 1; i < 4 * (w4 + h4) - 1; i++) {
        int first = imin(i, w4 * 4 - 1);
        int last = imax(i + 1 - h4 * 4, 0);
        order_palette(pal_idx, stride, i, first, last, order, ctx);
        int m = 0;
        for (int j = first; j >= last; j--, m++) {
            int color_idx = msac_decode_symbol_adapt(
                s, color_map_cdf + (size_t)ctx[m] * 8, pal_sz - 1);
            pal_idx[(i - j) * stride + j] = order[m][color_idx];
        }
    }
    if (bw4 > w4) {
        for (int y = 0; y < 4 * h4; y++) {
            int off = y * stride + 4 * w4;
            memset(pal_idx + off, pal_idx[off - 1], 4 * (bw4 - w4));
        }
    }
    if (h4 < bh4) {
        const uint8_t *src = pal_idx + (size_t)stride * (h4 * 4 - 1);
        for (int y = h4 * 4; y < bh4 * 4; y++)
            memcpy(pal_idx + (size_t)y * stride, src, stride);
    }
}

/* ---------------------------------------------------------------------- */
/* matching-ref scan for warp (decode.py find_matching_ref)                */

static void find_matching_ref(const SyFrame *f, const SyTask *t, SyTile *ts,
                              int intra_edge_flags, int bw4, int bh4, int w4,
                              int h4, int have_left, int have_top, int ref,
                              uint64_t masks[2]) {
    masks[0] = masks[1] = 0;
    int count = 0;
    int have_topleft = have_top && have_left;
    int have_topright = imax(bw4, bh4) < 32 && have_top &&
                        t->bx + bw4 < ts->col_end &&
                        (intra_edge_flags & 1); /* I444_TOP_HAS_RIGHT */
    RGridRec r;

    if (have_top) {
        int row = t->by - 1;
        int col = t->bx;
        rgrid_load(f, row, col, &r);
        if (r.ref0 == ref + 1 && r.ref1 == -1) {
            masks[0] |= 1;
            count = 1;
        }
        int aw4 = b_dims[r.bs][0];
        if (aw4 >= bw4) {
            int off = t->bx & (aw4 - 1);
            if (off)
                have_topleft = 0;
            if (aw4 - off > bw4)
                have_topright = 0;
        } else {
            uint64_t mask = 1ull << aw4;
            int x = aw4;
            while (x < w4) {
                col += aw4;
                rgrid_load(f, row, col, &r);
                if (r.ref0 == ref + 1 && r.ref1 == -1) {
                    masks[0] |= mask;
                    count++;
                    if (count >= 8)
                        return;
                }
                aw4 = b_dims[r.bs][0];
                mask <<= aw4;
                x += aw4;
            }
        }
    }
    if (have_left) {
        int row = t->by;
        int col = t->bx - 1;
        rgrid_load(f, row, col, &r);
        if (r.ref0 == ref + 1 && r.ref1 == -1) {
            masks[1] |= 1;
            count++;
            if (count >= 8)
                return;
        }
        int lh4 = b_dims[r.bs][1];
        if (lh4 >= bh4) {
            if (t->by & (lh4 - 1))
                have_topleft = 0;
        } else {
            uint64_t mask = 1ull << lh4;
            int y = lh4;
            while (y < h4) {
                row += lh4;
                rgrid_load(f, row, col, &r);
                if (r.ref0 == ref + 1 && r.ref1 == -1) {
                    masks[1] |= mask;
                    count++;
                    if (count >= 8)
                        return;
                }
                lh4 = b_dims[r.bs][1];
                mask <<= lh4;
                y += lh4;
            }
        }
    }
    if (have_topleft) {
        rgrid_load(f, t->by - 1, t->bx - 1, &r);
        if (r.ref0 == ref + 1 && r.ref1 == -1) {
            masks[1] |= 1ull << 32;
            count++;
            if (count >= 8)
                return;
        }
    }
    if (have_topright) {
        rgrid_load(f, t->by - 1, t->bx + bw4, &r);
        if (r.ref0 == ref + 1 && r.ref1 == -1)
            masks[0] |= 1ull << 32;
    }
}

static int findoddzero_l(const SyTask *t, int by4, int n) {
    for (int i = 1; i < n; i += 2)
        if (!t->l.intra[(by4 + i) & 31])
            return 1;
    return 0;
}

static int findoddzero_a(const SyTile *ts, int bx, int n) {
    for (int i = 1; i < n; i += 2)
        if (!ts->a.intra[bx + i])
            return 1;
    return 0;
}

/* smooth-filter flags for the intra work item (recon/intra.py _sm_flag) */
static int sm_flag_mode(int m) {
    return (m == SMOOTH_PRED || m == SMOOTH_H_PRED || m == SMOOTH_V_PRED)
               ? 512
               : 0;
}

/* ---------------------------------------------------------------------- */
/* segment-id prediction helpers                                           */

/* minimum seg id over the colocated area (decode.py get_prev_frame_segid) */
static int get_prev_frame_segid(const SyFrame *f, int bx, int by, int w4,
                                int h4) {
    int seg = 8;
    const uint8_t *m = f->prev_segmap;
    for (int y = 0; y < h4; y++) {
        const uint8_t *row = m + (size_t)(by + y) * f->segmap_stride + bx;
        for (int x = 0; x < w4; x++)
            if (row[x] < seg)
                seg = row[x];
    }
    return seg;
}

static int get_cur_frame_segid_2d(const SyFrame *f, int bx, int by,
                                  int have_top, int have_left, int *seg_ctx) {
    const uint8_t *m = f->cur_segmap;
    int stride = f->segmap_stride;
    if (have_left && have_top) {
        int l = m[(size_t)by * stride + bx - 1];
        int a = m[(size_t)(by - 1) * stride + bx];
        int al = m[(size_t)(by - 1) * stride + bx - 1];
        if (l == a && a == al)
            *seg_ctx = 2;
        else if (l == a || al == l || a == al)
            *seg_ctx = 1;
        else
            *seg_ctx = 0;
        return a == al ? a : l;
    }
    *seg_ctx = 0;
    if (have_left)
        return m[(size_t)by * stride + bx - 1];
    if (have_top)
        return m[(size_t)(by - 1) * stride + bx];
    return 0;
}

/* ---------------------------------------------------------------------- */
/* decode_b (decode.py decode_b; src/decode.rs:1159 decode_b_inner)        */

static int decode_b(const SyFrame *f, SyTile *ts, SyTask *t, SyOut *out,
                    int bl, int bs, int bp, int intra_edge_flags) {
    Blk bstk;
    Blk *b = &bstk;
    memset(b, 0, sizeof(*b));
    b->intra = 1;
    b->ref[0] = b->ref[1] = -1;
    b->drl_idx = DRL_NEAREST;

    const uint8_t *b_dim = b_dims[bs];
    int bx4 = t->bx & 31;
    int by4 = t->by & 31;
    int layout = f->layout;
    int ss_ver = layout == PL_I420;
    int ss_hor = layout != PL_I444;
    int cby4 = by4 >> ss_ver;
    int bw4 = b_dim[0], bh4 = b_dim[1];
    int w4 = imin(bw4, f->bw - t->bx);
    int h4 = imin(bh4, f->bh - t->by);
    int cbw4 = (bw4 + ss_hor) >> ss_hor;
    int cbh4 = (bh4 + ss_ver) >> ss_ver;
    int have_left = t->bx > ts->col_start;
    int have_top = t->by > ts->row_start;
    int has_chroma = layout != PL_I400 && (bw4 > ss_hor || (t->bx & 1)) &&
                     (bh4 > ss_ver || (t->by & 1));
    int frame_type = f->frame_type;
    Msac *s = ts->msac;
    SyCdf *cdf = &ts->cdf;

    int cw4 = (w4 + ss_hor) >> ss_hor;
    int ch4 = (h4 + ss_ver) >> ss_ver;

    b->bl = bl;
    b->bp = bp;
    b->bs = bs;

    const SySegData *seg = NULL;
    int seg_pred = 0;

    /* segment_id (preskip) */
    if (f->seg_enabled) {
        if (!f->seg_update_map) {
            if (f->prev_segmap) {
                int seg_id = get_prev_frame_segid(f, t->bx, t->by, w4, h4);
                if (seg_id >= 8)
                    return SYE_BAD_PREV_SEGID;
                b->seg_id = seg_id;
            } else {
                b->seg_id = 0;
            }
            seg = &f->seg[b->seg_id];
        } else if (f->seg_preskip) {
            if (f->seg_temporal) {
                int index = ts->a.seg_pred[t->bx] + t->l.seg_pred[by4];
                seg_pred = msac_decode_bool_adapt(
                    s, cdf->seg_pred + (size_t)index * 2);
            } else {
                seg_pred = 0;
            }
            if (f->seg_temporal && seg_pred) {
                if (f->prev_segmap) {
                    int seg_id =
                        get_prev_frame_segid(f, t->bx, t->by, w4, h4);
                    if (seg_id >= 8)
                        return SYE_BAD_PREV_SEGID;
                    b->seg_id = seg_id;
                } else {
                    b->seg_id = 0;
                }
            } else {
                int seg_ctx;
                int pred_seg_id = get_cur_frame_segid_2d(
                    f, t->bx, t->by, have_top, have_left, &seg_ctx);
                int diff = msac_decode_symbol_adapt(
                    s, cdf->seg_id + (size_t)seg_ctx * 8, 7);
                int last_active_seg_id = f->seg_last_active_segid;
                b->seg_id = neg_deinterleave(diff, pred_seg_id,
                                             last_active_seg_id + 1) &
                            0xFF;
                if (b->seg_id > last_active_seg_id || b->seg_id >= 8)
                    b->seg_id = 0;
            }
            seg = &f->seg[b->seg_id];
        }
    } else {
        b->seg_id = 0;
    }

    /* skip_mode */
    if ((seg == NULL ||
         (seg->globalmv == 0 && seg->ref == -1 && seg->skip == 0)) &&
        f->skip_mode_enabled && imin(bw4, bh4) > 1) {
        int smctx = ts->a.skip_mode[t->bx] + t->l.skip_mode[by4];
        b->skip_mode = msac_decode_bool_adapt(
            s, cdf->skip_mode + (size_t)smctx * 2);
    } else {
        b->skip_mode = 0;
    }

    /* skip */
    if (b->skip_mode || (seg && seg->skip)) {
        b->skip = 1;
    } else {
        int sctx = ts->a.skip[t->bx] + t->l.skip[by4];
        b->skip = msac_decode_bool_adapt(s, cdf->skip + (size_t)sctx * 2);
    }

    /* segment_id (postskip) */
    if (f->seg_enabled && f->seg_update_map && !f->seg_preskip) {
        if (!b->skip && f->seg_temporal) {
            int index = ts->a.seg_pred[t->bx] + t->l.seg_pred[by4];
            seg_pred = msac_decode_bool_adapt(
                s, cdf->seg_pred + (size_t)index * 2);
        } else {
            seg_pred = 0;
        }
        if (!b->skip && f->seg_temporal && seg_pred) {
            if (f->prev_segmap) {
                int seg_id = get_prev_frame_segid(f, t->bx, t->by, w4, h4);
                if (seg_id >= 8)
                    return SYE_BAD_PREV_SEGID;
                b->seg_id = seg_id;
            } else {
                b->seg_id = 0;
            }
        } else {
            int seg_ctx;
            int pred_seg_id = get_cur_frame_segid_2d(
                f, t->bx, t->by, have_top, have_left, &seg_ctx);
            if (b->skip) {
                b->seg_id = pred_seg_id;
            } else {
                int diff = msac_decode_symbol_adapt(
                    s, cdf->seg_id + (size_t)seg_ctx * 8, 7);
                int last_active_seg_id = f->seg_last_active_segid;
                b->seg_id = neg_deinterleave(diff, pred_seg_id,
                                             last_active_seg_id + 1) &
                            0xFF;
                if (b->seg_id > last_active_seg_id)
                    b->seg_id = 0;
            }
            if (b->seg_id >= 8)
                b->seg_id = 0;
        }
        seg = &f->seg[b->seg_id];
    }

    /* cdef index */
    if (!b->skip) {
        for (int y = 0; y < bh4; y++)
            memset(f->noskip4 + (size_t)(t->by + y) * f->noskip_stride +
                       t->bx,
                   1, bw4);
        int uy = t->by >> 4, ux = t->bx >> 4;
        int32_t *ci = f->cdef_idx + (size_t)uy * f->cdef_stride + ux;
        if (*ci == -1) {
            int v = msac_decode_bools(s, f->cdef_n_bits);
            *ci = v;
            if (bw4 > 16)
                ci[1] = v;
            if (bh4 > 16)
                ci[f->cdef_stride] = v;
            if (bw4 == 32 && bh4 == 32)
                ci[f->cdef_stride + 1] = v;
        }
    }

    /* delta q/lf at sb boundaries */
    int not_sb128 = f->sb128 ? 0 : 1;
    if ((t->bx & (31 >> not_sb128)) == 0 && (t->by & (31 >> not_sb128)) == 0) {
        int prev_qidx = ts->last_qidx;
        int sb_bs = f->sb128 ? BS_128x128 : BS_64x64;
        int have_delta_q = f->delta_q_present && (bs != sb_bs || !b->skip);
        int prev_delta_lf[4];
        memcpy(prev_delta_lf, ts->last_delta_lf, sizeof(prev_delta_lf));
        if (have_delta_q) {
            int delta_q = msac_decode_symbol_adapt(s, cdf->delta_q, 3);
            if (delta_q == 3) {
                int n_bits = 1 + msac_decode_bools(s, 3);
                delta_q = msac_decode_bools(s, n_bits) + 1 + (1 << n_bits);
            }
            if (delta_q) {
                if (msac_decode_bool_equi(s))
                    delta_q = -delta_q;
                delta_q *= 1 << f->delta_q_res_log2;
            }
            ts->last_qidx = iclip(ts->last_qidx + delta_q, 1, 255);
            if (f->delta_lf_present) {
                int n_lfs = f->delta_lf_multi
                                ? (layout != PL_I400 ? 4 : 2)
                                : 1;
                for (int i = 0; i < n_lfs; i++) {
                    int idx = i + f->delta_lf_multi;
                    int delta_lf = msac_decode_symbol_adapt(
                        s, cdf->delta_lf + (size_t)idx * 4, 3);
                    if (delta_lf == 3) {
                        int n_bits = 1 + msac_decode_bools(s, 3);
                        delta_lf =
                            msac_decode_bools(s, n_bits) + 1 + (1 << n_bits);
                    }
                    if (delta_lf) {
                        if (msac_decode_bool_equi(s))
                            delta_lf = -delta_lf;
                        delta_lf *= 1 << f->delta_lf_res_log2;
                    }
                    ts->last_delta_lf[i] =
                        iclip(ts->last_delta_lf[i] + delta_lf, -63, 63);
                }
            }
        }
        if (ts->last_qidx != prev_qidx)
            init_quant_tables(f, ts->last_qidx, ts->dq);
        if (memcmp(ts->last_delta_lf, prev_delta_lf, sizeof(prev_delta_lf)))
            calc_lf_values(f, ts->last_delta_lf, ts->lflvl);
    }

    /* intra flag */
    if (b->skip_mode) {
        b->intra = 0;
    } else if (FT_IS_INTER_OR_SWITCH(frame_type)) {
        if (seg && (seg->ref >= 0 || seg->globalmv)) {
            b->intra = seg->ref == 0;
        } else {
            int ictx =
                get_intra_ctx(&ts->a, &t->l, by4, t->bx, have_top, have_left);
            b->intra = !msac_decode_bool_adapt(
                s, cdf->intra + (size_t)ictx * 2);
        }
    } else if (f->allow_intrabc) {
        b->intra = !msac_decode_bool_adapt(s, cdf->intrabc);
    } else {
        b->intra = 1;
    }

    if (b->intra) {
        /* ---------------- intra path ---------------- */
        uint16_t *ymode_cdf;
        if (FT_IS_INTER_OR_SWITCH(frame_type))
            ymode_cdf = cdf->y_mode + (size_t)ymode_size_context[bs] * 13;
        else
            ymode_cdf = cdf->kfym +
                        ((size_t)intra_mode_context[ts->a.mode[t->bx]] * 5 +
                         intra_mode_context[t->l.mode[by4]]) *
                            13;
        b->y_mode =
            msac_decode_symbol_adapt(s, ymode_cdf, N_INTRA_PRED_MODES - 1);

        if (b_dim[2] + b_dim[3] >= 2 && b->y_mode >= VERT_PRED &&
            b->y_mode <= VERT_LEFT_PRED) {
            uint16_t *acdf =
                cdf->angle_delta + (size_t)(b->y_mode - VERT_PRED) * 7;
            int angle = msac_decode_symbol_adapt(s, acdf, 6);
            b->y_angle = angle - 3;
        } else {
            b->y_angle = 0;
        }

        if (has_chroma) {
            int cfl_allowed;
            if (f->seg_lossless[b->seg_id])
                cfl_allowed = cbw4 == 1 && cbh4 == 1;
            else
                cfl_allowed = (CFL_ALLOWED_MASK >> bs) & 1;
            uint16_t *uvmode_cdf =
                cdf->uv_mode +
                ((size_t)(cfl_allowed ? 1 : 0) * 13 + b->y_mode) * 14;
            b->uv_mode = msac_decode_symbol_adapt(
                s, uvmode_cdf,
                N_UV_INTRA_PRED_MODES - 1 - (cfl_allowed ? 0 : 1));
            b->uv_angle = 0;
            if (b->uv_mode == CFL_PRED) {
                int sign = msac_decode_symbol_adapt(s, cdf->cfl_sign, 7) + 1;
                int sign_u = (sign * 0x56) >> 8;
                int sign_v = sign - sign_u * 3;
                if (sign_u) {
                    int ctx = (sign_u == 2 ? 1 : 0) * 3 + sign_v;
                    b->cfl_alpha[0] =
                        msac_decode_symbol_adapt(
                            s, cdf->cfl_alpha + (size_t)ctx * 16, 15) +
                        1;
                    if (sign_u == 1)
                        b->cfl_alpha[0] = -b->cfl_alpha[0];
                } else {
                    b->cfl_alpha[0] = 0;
                }
                if (sign_v) {
                    int ctx = (sign_v == 2 ? 1 : 0) * 3 + sign_u;
                    b->cfl_alpha[1] =
                        msac_decode_symbol_adapt(
                            s, cdf->cfl_alpha + (size_t)ctx * 16, 15) +
                        1;
                    if (sign_v == 1)
                        b->cfl_alpha[1] = -b->cfl_alpha[1];
                } else {
                    b->cfl_alpha[1] = 0;
                }
            } else if (b_dim[2] + b_dim[3] >= 2 && b->uv_mode >= VERT_PRED &&
                       b->uv_mode <= VERT_LEFT_PRED) {
                uint16_t *acdf =
                    cdf->angle_delta + (size_t)(b->uv_mode - VERT_PRED) * 7;
                int angle = msac_decode_symbol_adapt(s, acdf, 6);
                b->uv_angle = angle - 3;
            }
        }

        b->pal_sz[0] = b->pal_sz[1] = 0;
        if (f->allow_screen_content_tools && imax(bw4, bh4) <= 16 &&
            bw4 + bh4 >= 4) {
            int sz_ctx = b_dim[2] + b_dim[3] - 2;
            if (b->y_mode == DC_PRED) {
                int pal_ctx = (ts->a.pal_sz[t->bx] > 0) +
                              (t->l.pal_sz[by4] > 0);
                int use_y_pal = msac_decode_bool_adapt(
                    s, cdf->pal_y + ((size_t)sz_ctx * 3 + pal_ctx) * 2);
                if (use_y_pal)
                    read_pal_plane(f, ts, t, b, 0, sz_ctx, bx4, by4);
            }
            if (has_chroma && b->uv_mode == DC_PRED) {
                int pal_ctx = b->pal_sz[0] > 0;
                int use_uv_pal = msac_decode_bool_adapt(
                    s, cdf->pal_uv + (size_t)pal_ctx * 2);
                if (use_uv_pal)
                    read_pal_uv(f, ts, t, b, sz_ctx, bx4, by4);
            }
        }

        if (b->y_mode == DC_PRED && b->pal_sz[0] == 0 &&
            imax(b_dim[2], b_dim[3]) <= 3 && f->filter_intra) {
            int is_filter = msac_decode_bool_adapt(
                s, cdf->use_filter_intra + (size_t)bs * 2);
            if (is_filter) {
                b->y_mode = FILTER_PRED;
                b->y_angle = msac_decode_symbol_adapt(s, cdf->filter_intra, 4);
            }
        }

        if (b->pal_sz[0])
            read_pal_indices(ts, t, t->pal_idx, b, 0, w4, h4, bw4, bh4);
        if (has_chroma && b->pal_sz[1])
            read_pal_indices(ts, t, t->pal_idx + (size_t)bw4 * bh4 * 16, b,
                             1, cw4, ch4, cbw4, cbh4);

        const TxfmInfo *td;
        if (f->seg_lossless[b->seg_id]) {
            b->uvtx = TX_4X4;
            b->tx = b->uvtx;
            td = &t_dims[TX_4X4];
        } else {
            b->tx = max_txfm_size_for_bs[bs][0];
            b->uvtx = max_txfm_size_for_bs[bs][layout];
            td = &t_dims[b->tx];
            if (f->txfm_mode == TXFM_SWITCHABLE && td->max > TX_4X4) {
                int tctx = get_tx_ctx(&ts->a, &t->l, td, by4, t->bx);
                uint16_t *tx_cdf =
                    cdf->txsz + ((size_t)(td->max - 1) * 3 + tctx) * 3;
                int depth = msac_decode_symbol_adapt(s, tx_cdf,
                                                     imin(td->max, 2));
                for (int d = 0; d < depth; d++) {
                    b->tx = td->sub;
                    td = &t_dims[b->tx];
                }
            }
        }

        /* emit intra work item, then coefficient reads */
        BlockRec *rec = emit_rec(out);
        if (!rec)
            return out->error;
        rec->kind = 0;
        rec->intra_edge_flags = (uint8_t)intra_edge_flags;
        int sm_a = ts->a.intra[t->bx] ? sm_flag_mode(ts->a.mode[t->bx]) : 0;
        int sm_l = t->l.intra[by4] ? sm_flag_mode(t->l.mode[by4]) : 0;
        rec->sm_fl = (int16_t)(sm_a | sm_l);
        int cbx_abs = t->bx >> ss_hor;
        rec->sm_uv_fl = (int16_t)(sm_flag_mode(ts->a.uvmode[cbx_abs]) |
                                  sm_flag_mode(t->l.uvmode[cby4]));
        if (b->pal_sz[0] || b->pal_sz[1]) {
            if (out->pal_pos + 24 > out->pal_cap ||
                out->palidx_pos + 2 * bw4 * bh4 * 16 > out->palidx_cap) {
                if (!out->error)
                    out->error = SYE_ARENA_OVERFLOW;
                return out->error;
            }
            rec->pal_off = out->pal_pos;
            memcpy(out->pal_arena + out->pal_pos, t->pal, 24 * 2);
            out->pal_pos += 24;
            rec->palidx_off = out->palidx_pos;
            memcpy(out->palidx_arena + out->palidx_pos, t->pal_idx,
                   (size_t)2 * bw4 * bh4 * 16);
            out->palidx_pos += 2 * bw4 * bh4 * 16;
        }
        rec->tx_pos = out->tx_pos;
        rec->cf_pos = out->cf_pos;
        rec_fill_blk(rec, b, t);

        intra_read_coefs(f, ts, t, out, b, bs);

        if (f->lf_level_y[0] || f->lf_level_y[1])
            record_lf_intra(f, ts, t, b, bs, has_chroma);

        int y_mode_nofilt = b->y_mode == FILTER_PRED ? DC_PRED : b->y_mode;
        for (int i = 0; i < bw4; i++) {
            int x = t->bx + i;
            ts->a.tx_intra[x] = (int8_t)td->lw;
            ts->a.tx[x] = (int8_t)td->lw;
            ts->a.mode[x] = (uint8_t)y_mode_nofilt;
            ts->a.pal_sz[x] = (uint8_t)b->pal_sz[0];
            ts->a.seg_pred[x] = (uint8_t)(seg_pred ? 1 : 0);
            ts->a.skip_mode[x] = 0;
            ts->a.intra[x] = 1;
            ts->a.skip[x] = (uint8_t)b->skip;
            t->pal_sz_uv[x & 31] =
                (uint8_t)(has_chroma ? b->pal_sz[1] : 0);
            if (FT_IS_INTER_OR_SWITCH(frame_type)) {
                ts->a.comp_type[x] = 0;
                ts->a.ref0[x] = -1;
                ts->a.ref1[x] = -1;
                ts->a.filter0[x] = N_SWITCHABLE_FILTERS;
                ts->a.filter1[x] = N_SWITCHABLE_FILTERS;
            }
        }
        for (int i = 0; i < bh4; i++) {
            int y = (by4 + i) & 31;
            t->l.tx_intra[y] = (int8_t)td->lh;
            t->l.tx[y] = (int8_t)td->lh;
            t->l.mode[y] = (uint8_t)y_mode_nofilt;
            t->l.pal_sz[y] = (uint8_t)b->pal_sz[0];
            t->l.seg_pred[y] = (uint8_t)(seg_pred ? 1 : 0);
            t->l.skip_mode[y] = 0;
            t->l.intra[y] = 1;
            t->l.skip[y] = (uint8_t)b->skip;
            t->pal_sz_uv[32 + y] =
                (uint8_t)(has_chroma ? b->pal_sz[1] : 0);
            if (FT_IS_INTER_OR_SWITCH(frame_type)) {
                t->l.comp_type[y] = 0;
                t->l.ref0[y] = -1;
                t->l.ref1[y] = -1;
                t->l.filter0[y] = N_SWITCHABLE_FILTERS;
                t->l.filter1[y] = N_SWITCHABLE_FILTERS;
            }
        }
        if (b->pal_sz[0]) {
            for (int i = 0; i < bw4; i++)
                memcpy(al_pal_at(t, 0, bx4 + i, 0), t->pal, 8 * 2);
            for (int i = 0; i < bh4; i++)
                memcpy(al_pal_at(t, 1, by4 + i, 0), t->pal, 8 * 2);
        }
        if (has_chroma) {
            for (int i = 0; i < cbw4; i++)
                ts->a.uvmode[cbx_abs + i] = (uint8_t)b->uv_mode;
            for (int i = 0; i < cbh4; i++)
                t->l.uvmode[(cby4 + i) & 31] = (uint8_t)b->uv_mode;
            if (b->pal_sz[1]) {
                for (int i = 0; i < bw4; i++) {
                    memcpy(al_pal_at(t, 0, bx4 + i, 1), t->pal + 8, 8 * 2);
                    memcpy(al_pal_at(t, 0, bx4 + i, 2), t->pal + 16, 8 * 2);
                }
                for (int i = 0; i < bh4; i++) {
                    memcpy(al_pal_at(t, 1, by4 + i, 1), t->pal + 8, 8 * 2);
                    memcpy(al_pal_at(t, 1, by4 + i, 2), t->pal + 16, 8 * 2);
                }
            }
        }
        if (FT_IS_INTER_OR_SWITCH(frame_type) || f->allow_intrabc)
            splat_mv(f, t->by, t->bx, bw4, bh4, INVALID_MV_X, INVALID_MV_Y,
                     0, 0, 0, -1, bs, 0);
        rec->dbg_rng = s->rng;
        goto segmap_update;
    }

    if (FT_IS_KEY_OR_INTRA(frame_type)) {
        /* ---------------- intra block copy ---------------- */
        RefMvsCall rc;
        refmvs_find(f, t, 0, -1, bs, intra_edge_flags, &rc);
        if (rc.out_mv[0][0][0] != 0 || rc.out_mv[0][0][1] != 0) {
            b->mv[0][0] = rc.out_mv[0][0][0];
            b->mv[0][1] = rc.out_mv[0][0][1];
        } else if (rc.out_mv[1][0][0] != 0 || rc.out_mv[1][0][1] != 0) {
            b->mv[0][0] = rc.out_mv[1][0][0];
            b->mv[0][1] = rc.out_mv[1][0][1];
        } else if (t->by - (16 << f->sb128) < ts->row_start) {
            b->mv[0][0] = -(512 << f->sb128) - 2048;
            b->mv[0][1] = 0;
        } else {
            b->mv[0][0] = 0;
            b->mv[0][1] = -(512 << f->sb128);
        }

        read_mv_residual(ts, b->mv[0], cdf->dmv_comp, 0, f->hp);

        /* clip intrabc mv to decoded parts of the current tile */
        int border_left = ts->col_start * 4;
        int border_top = ts->row_start * 4;
        if (has_chroma) {
            if (bw4 < 2 && ss_hor)
                border_left += 4;
            if (bh4 < 2 && ss_ver)
                border_top += 4;
        }
        int src_left = t->bx * 4 + (b->mv[0][0] >> 3);
        int src_top = t->by * 4 + (b->mv[0][1] >> 3);
        int src_right = src_left + bw4 * 4;
        int src_bottom = src_top + bh4 * 4;
        int border_right = ((ts->col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;

        if (src_left < border_left) {
            src_right += border_left - src_left;
            src_left = border_left;
        } else if (src_right > border_right) {
            src_left -= src_right - border_right;
            src_right = border_right;
        }
        if (src_top < border_top) {
            src_bottom += border_top - src_top;
            src_top = border_top;
        }

        int sbx = (t->bx >> (4 + f->sb128)) << (6 + f->sb128);
        int sby = (t->by >> (4 + f->sb128)) << (6 + f->sb128);
        int sb_size = 1 << (6 + f->sb128);
        if (src_bottom > sby && src_right > sbx) {
            if (src_top - border_top >= src_bottom - sby) {
                src_top -= src_bottom - sby;
                src_bottom = sby;
            } else if (src_left - border_left >= src_right - sbx) {
                src_left -= src_right - sbx;
                src_right = sbx;
            }
        }
        if (src_bottom > sby + sb_size) {
            src_top -= src_bottom - (sby + sb_size);
            src_bottom = sby + sb_size;
        }
        if (src_bottom > sby && src_right > sbx)
            return SYE_INTRABC_OVERLAP;

        b->mv[0][0] = (src_left - t->bx * 4) * 8;
        b->mv[0][1] = (src_top - t->by * 4) * 8;

        read_vartx_tree(f, ts, t, b, bs, bx4, by4);
        b->filter2d = FILTER_2D_BILINEAR;
        BlockRec *rec = snapshot_inter_item(f, ts, t, out, b);
        if (!rec)
            return out->error;
        inter_read_coefs(f, ts, t, out, b, bs);

        splat_mv(f, t->by, t->bx, bw4, bh4, b->mv[0][0], b->mv[0][1], 0, 0,
                 0, -1, bs, 0);

        for (int i = 0; i < bw4; i++) {
            int x = t->bx + i;
            ts->a.tx_intra[x] = (int8_t)b_dim[2];
            ts->a.mode[x] = DC_PRED;
            ts->a.pal_sz[x] = 0;
            t->pal_sz_uv[x & 31] = 0;
            ts->a.seg_pred[x] = (uint8_t)(seg_pred ? 1 : 0);
            ts->a.skip_mode[x] = 0;
            ts->a.intra[x] = 0;
            ts->a.skip[x] = (uint8_t)b->skip;
        }
        for (int i = 0; i < bh4; i++) {
            int y = (by4 + i) & 31;
            t->l.tx_intra[y] = (int8_t)b_dim[3];
            t->l.mode[y] = DC_PRED;
            t->l.pal_sz[y] = 0;
            t->pal_sz_uv[32 + y] = 0;
            t->l.seg_pred[y] = (uint8_t)(seg_pred ? 1 : 0);
            t->l.skip_mode[y] = 0;
            t->l.intra[y] = 0;
            t->l.skip[y] = (uint8_t)b->skip;
        }
        if (has_chroma) {
            int cbx_abs = t->bx >> ss_hor;
            for (int i = 0; i < cbw4; i++)
                ts->a.uvmode[cbx_abs + i] = DC_PRED;
            for (int i = 0; i < cbh4; i++)
                t->l.uvmode[(cby4 + i) & 31] = DC_PRED;
        }
        rec->dbg_rng = s->rng;
        goto segmap_update;
    }

    /* ---------------- inter path ---------------- */
    {
        int has_subpel_filter = 0;
        int is_comp;
        RefMvsCall rc;
        int filter_[2];

        if (b->skip_mode) {
            is_comp = 1;
        } else if ((seg == NULL || (seg->ref == -1 && seg->globalmv == 0 &&
                                    seg->skip == 0)) &&
                   f->switchable_comp_refs && imin(bw4, bh4) > 1) {
            int cctx =
                get_comp_ctx(&ts->a, &t->l, by4, t->bx, have_top, have_left);
            is_comp = msac_decode_bool_adapt(s, cdf->comp + (size_t)cctx * 2);
        } else {
            is_comp = 0;
        }

        if (b->skip_mode) {
            b->ref[0] = f->skip_mode_refs0;
            b->ref[1] = f->skip_mode_refs1;
            b->comp_type = COMP_INTER_AVG;
            b->inter_mode = NEARESTMV_NEARESTMV;
            b->drl_idx = DRL_NEAREST;
            has_subpel_filter = 0;

            refmvs_find(f, t, b->ref[0] + 1, b->ref[1] + 1, bs,
                        intra_edge_flags, &rc);
            b->mv[0][0] = rc.out_mv[0][0][0];
            b->mv[0][1] = rc.out_mv[0][0][1];
            b->mv[1][0] = rc.out_mv[0][1][0];
            b->mv[1][1] = rc.out_mv[0][1][1];
            fix_mv_precision(f, &b->mv[0][0], &b->mv[0][1]);
            fix_mv_precision(f, &b->mv[1][0], &b->mv[1][1]);
        } else if (is_comp) {
            int dir_ctx = get_comp_dir_ctx(&ts->a, &t->l, by4, t->bx,
                                           have_top, have_left);
            if (msac_decode_bool_adapt(s, cdf->comp_dir + (size_t)dir_ctx * 2)) {
                /* bidir - first reference (fw) */
                int ctx1 = av1_get_fwd_ref_ctx(&ts->a, &t->l, by4, t->bx,
                                               have_top, have_left);
                if (msac_decode_bool_adapt(
                        s, cdf->comp_fwd_ref + ((size_t)0 * 3 + ctx1) * 2)) {
                    int ctx2 = av1_get_fwd_ref_2_ctx(&ts->a, &t->l, by4,
                                                     t->bx, have_top,
                                                     have_left);
                    b->ref[0] =
                        2 + msac_decode_bool_adapt(
                                s, cdf->comp_fwd_ref +
                                       ((size_t)2 * 3 + ctx2) * 2);
                } else {
                    int ctx2 = av1_get_fwd_ref_1_ctx(&ts->a, &t->l, by4,
                                                     t->bx, have_top,
                                                     have_left);
                    b->ref[0] = msac_decode_bool_adapt(
                        s, cdf->comp_fwd_ref + ((size_t)1 * 3 + ctx2) * 2);
                }
                int ctx3 = av1_get_bwd_ref_ctx(&ts->a, &t->l, by4, t->bx,
                                               have_top, have_left);
                if (msac_decode_bool_adapt(
                        s, cdf->comp_bwd_ref + ((size_t)0 * 3 + ctx3) * 2)) {
                    b->ref[1] = 6;
                } else {
                    int ctx4 = av1_get_bwd_ref_1_ctx(&ts->a, &t->l, by4,
                                                     t->bx, have_top,
                                                     have_left);
                    b->ref[1] =
                        4 + msac_decode_bool_adapt(
                                s, cdf->comp_bwd_ref +
                                       ((size_t)1 * 3 + ctx4) * 2);
                }
            } else {
                /* unidir */
                int uctx_p = av1_get_ref_ctx(&ts->a, &t->l, by4, t->bx,
                                             have_top, have_left);
                if (msac_decode_bool_adapt(
                        s, cdf->comp_uni_ref + ((size_t)0 * 3 + uctx_p) * 2)) {
                    b->ref[0] = 4;
                    b->ref[1] = 6;
                } else {
                    int uctx_p1 = av1_get_uni_p1_ctx(&ts->a, &t->l, by4,
                                                     t->bx, have_top,
                                                     have_left);
                    b->ref[0] = 0;
                    b->ref[1] =
                        1 + msac_decode_bool_adapt(
                                s, cdf->comp_uni_ref +
                                       ((size_t)1 * 3 + uctx_p1) * 2);
                    if (b->ref[1] == 2) {
                        int uctx_p2 = av1_get_fwd_ref_2_ctx(
                            &ts->a, &t->l, by4, t->bx, have_top, have_left);
                        b->ref[1] += msac_decode_bool_adapt(
                            s, cdf->comp_uni_ref +
                                   ((size_t)2 * 3 + uctx_p2) * 2);
                    }
                }
            }

            refmvs_find(f, t, b->ref[0] + 1, b->ref[1] + 1, bs,
                        intra_edge_flags, &rc);
            int mctx = rc.out_ctx;
            int n_mvs = rc.out_cnt;
            b->inter_mode = msac_decode_symbol_adapt(
                s, cdf->comp_inter_mode + (size_t)mctx * 8,
                N_COMP_INTER_PRED_MODES - 1);

            const uint8_t *im = comp_inter_pred_modes[b->inter_mode];
            b->drl_idx = DRL_NEAREST;
            if (b->inter_mode == NEWMV_NEWMV) {
                if (n_mvs > 1) {
                    int drl_ctx_v1 = get_drl_ctx(&rc, 0);
                    if (msac_decode_bool_adapt(
                            s, cdf->drl_bit + (size_t)drl_ctx_v1 * 2)) {
                        b->drl_idx = DRL_NEARER;
                        if (n_mvs > 2) {
                            int drl_ctx_v2 = get_drl_ctx(&rc, 1);
                            if (msac_decode_bool_adapt(
                                    s, cdf->drl_bit +
                                           (size_t)drl_ctx_v2 * 2))
                                b->drl_idx = DRL_NEAR;
                        }
                    }
                }
            } else if (im[0] == NEARMV || im[1] == NEARMV) {
                b->drl_idx = DRL_NEARER;
                if (n_mvs > 2) {
                    int drl_ctx_v2 = get_drl_ctx(&rc, 1);
                    if (msac_decode_bool_adapt(
                            s, cdf->drl_bit + (size_t)drl_ctx_v2 * 2)) {
                        b->drl_idx = DRL_NEAR;
                        if (n_mvs > 3) {
                            int drl_ctx_v3 = get_drl_ctx(&rc, 2);
                            if (msac_decode_bool_adapt(
                                    s, cdf->drl_bit +
                                           (size_t)drl_ctx_v3 * 2))
                                b->drl_idx = DRL_NEARISH;
                        }
                    }
                }
            }

            has_subpel_filter = imin(bw4, bh4) == 1 ||
                                b->inter_mode != GLOBALMV_GLOBALMV;
            for (int idx = 0; idx < 2; idx++) {
                if (im[idx] == NEARMV || im[idx] == NEARESTMV) {
                    b->mv[idx][0] = rc.out_mv[b->drl_idx][idx][0];
                    b->mv[idx][1] = rc.out_mv[b->drl_idx][idx][1];
                    fix_mv_precision(f, &b->mv[idx][0], &b->mv[idx][1]);
                } else if (im[idx] == GLOBALMV) {
                    has_subpel_filter |=
                        f->gmv[b->ref[idx]].type == WM_TRANSLATION;
                    get_gmv_2d(f, &f->gmv[b->ref[idx]], t->bx, t->by, bw4,
                               bh4, &b->mv[idx][0], &b->mv[idx][1]);
                } else if (im[idx] == NEWMV) {
                    b->mv[idx][0] = rc.out_mv[b->drl_idx][idx][0];
                    b->mv[idx][1] = rc.out_mv[b->drl_idx][idx][1];
                    read_mv_residual(ts, b->mv[idx], cdf->mv_comp,
                                     !f->force_integer_mv, f->hp);
                }
            }

            /* jnt_comp vs. seg vs. wedge */
            int is_segwedge = 0;
            if (f->masked_compound) {
                int mask_ctx = get_mask_comp_ctx(&ts->a, &t->l, by4, t->bx);
                is_segwedge = msac_decode_bool_adapt(
                    s, cdf->mask_comp + (size_t)mask_ctx * 2);
            }
            if (!is_segwedge) {
                if (f->jnt_comp) {
                    int jnt_ctx = get_jnt_comp_ctx(
                        f->order_hint_n_bits, f->frame_offset,
                        f->refpoc[b->ref[0]], f->refpoc[b->ref[1]], &ts->a,
                        &t->l, by4, t->bx);
                    b->comp_type = COMP_INTER_WEIGHTED_AVG +
                                   msac_decode_bool_adapt(
                                       s, cdf->jnt_comp + (size_t)jnt_ctx * 2);
                } else {
                    b->comp_type = COMP_INTER_AVG;
                }
            } else {
                if ((WEDGE_ALLOWED_MASK >> bs) & 1) {
                    int wctx = wedge_ctx_lut[bs];
                    b->comp_type = COMP_INTER_WEDGE -
                                   msac_decode_bool_adapt(
                                       s, cdf->wedge_comp + (size_t)wctx * 2);
                    if (b->comp_type == COMP_INTER_WEDGE)
                        b->wedge_idx = msac_decode_symbol_adapt(
                            s, cdf->wedge_idx + (size_t)wctx * 16, 15);
                } else {
                    b->comp_type = COMP_INTER_SEG;
                }
                b->mask_sign = msac_decode_bool_equi(s);
            }
        } else {
            b->comp_type = COMP_INTER_NONE;

            /* ref */
            if (seg && seg->ref > 0) {
                b->ref[0] = seg->ref - 1;
            } else if (seg && (seg->globalmv || seg->skip)) {
                b->ref[0] = 0;
            } else {
                int ctx1 = av1_get_ref_ctx(&ts->a, &t->l, by4, t->bx,
                                           have_top, have_left);
                if (msac_decode_bool_adapt(
                        s, cdf->ref + ((size_t)0 * 3 + ctx1) * 2)) {
                    int ctx2 = av1_get_bwd_ref_ctx(&ts->a, &t->l, by4, t->bx,
                                                   have_top, have_left);
                    if (msac_decode_bool_adapt(
                            s, cdf->ref + ((size_t)1 * 3 + ctx2) * 2)) {
                        b->ref[0] = 6;
                    } else {
                        int ctx3 = av1_get_bwd_ref_1_ctx(
                            &ts->a, &t->l, by4, t->bx, have_top, have_left);
                        b->ref[0] =
                            4 + msac_decode_bool_adapt(
                                    s, cdf->ref + ((size_t)5 * 3 + ctx3) * 2);
                    }
                } else {
                    int ctx2 = av1_get_fwd_ref_ctx(&ts->a, &t->l, by4, t->bx,
                                                   have_top, have_left);
                    if (msac_decode_bool_adapt(
                            s, cdf->ref + ((size_t)2 * 3 + ctx2) * 2)) {
                        int ctx3 = av1_get_fwd_ref_2_ctx(
                            &ts->a, &t->l, by4, t->bx, have_top, have_left);
                        b->ref[0] =
                            2 + msac_decode_bool_adapt(
                                    s, cdf->ref + ((size_t)4 * 3 + ctx3) * 2);
                    } else {
                        int ctx3 = av1_get_fwd_ref_1_ctx(
                            &ts->a, &t->l, by4, t->bx, have_top, have_left);
                        b->ref[0] = msac_decode_bool_adapt(
                            s, cdf->ref + ((size_t)3 * 3 + ctx3) * 2);
                    }
                }
            }
            b->ref[1] = -1;

            refmvs_find(f, t, b->ref[0] + 1, -1, bs, intra_edge_flags, &rc);
            int mctx = rc.out_ctx;
            int n_mvs = rc.out_cnt;

            int seg_skip_gmv = seg && (seg->skip || seg->globalmv);
            if (seg_skip_gmv ||
                msac_decode_bool_adapt(
                    s, cdf->newmv_mode + (size_t)(mctx & 7) * 2)) {
                if (seg_skip_gmv ||
                    !msac_decode_bool_adapt(
                        s, cdf->globalmv_mode + (size_t)((mctx >> 3) & 1) * 2)) {
                    b->inter_mode = GLOBALMV;
                    get_gmv_2d(f, &f->gmv[b->ref[0]], t->bx, t->by, bw4, bh4,
                               &b->mv[0][0], &b->mv[0][1]);
                    has_subpel_filter =
                        imin(bw4, bh4) == 1 ||
                        f->gmv[b->ref[0]].type == WM_TRANSLATION;
                } else {
                    has_subpel_filter = 1;
                    if (msac_decode_bool_adapt(
                            s, cdf->refmv_mode +
                                   (size_t)((mctx >> 4) & 15) * 2)) {
                        b->inter_mode = NEARMV;
                        b->drl_idx = DRL_NEARER;
                        if (n_mvs > 2) {
                            int drl_ctx_v2 = get_drl_ctx(&rc, 1);
                            if (msac_decode_bool_adapt(
                                    s, cdf->drl_bit +
                                           (size_t)drl_ctx_v2 * 2)) {
                                b->drl_idx = DRL_NEAR;
                                if (n_mvs > 3) {
                                    int drl_ctx_v3 = get_drl_ctx(&rc, 2);
                                    if (msac_decode_bool_adapt(
                                            s, cdf->drl_bit +
                                                   (size_t)drl_ctx_v3 * 2))
                                        b->drl_idx = DRL_NEARISH;
                                }
                            }
                        }
                    } else {
                        b->inter_mode = NEARESTMV;
                        b->drl_idx = DRL_NEAREST;
                    }
                    b->mv[0][0] = rc.out_mv[b->drl_idx][0][0];
                    b->mv[0][1] = rc.out_mv[b->drl_idx][0][1];
                    if (b->drl_idx < DRL_NEAR)
                        fix_mv_precision(f, &b->mv[0][0], &b->mv[0][1]);
                }
            } else {
                has_subpel_filter = 1;
                b->inter_mode = NEWMV;
                b->drl_idx = DRL_NEAREST;
                if (n_mvs > 1) {
                    int drl_ctx_v1 = get_drl_ctx(&rc, 0);
                    if (msac_decode_bool_adapt(
                            s, cdf->drl_bit + (size_t)drl_ctx_v1 * 2)) {
                        b->drl_idx = DRL_NEARER;
                        if (n_mvs > 2) {
                            int drl_ctx_v2 = get_drl_ctx(&rc, 1);
                            if (msac_decode_bool_adapt(
                                    s, cdf->drl_bit +
                                           (size_t)drl_ctx_v2 * 2))
                                b->drl_idx = DRL_NEAR;
                        }
                    }
                }
                if (n_mvs > 1) {
                    b->mv[0][0] = rc.out_mv[b->drl_idx][0][0];
                    b->mv[0][1] = rc.out_mv[b->drl_idx][0][1];
                } else {
                    b->mv[0][0] = rc.out_mv[0][0][0];
                    b->mv[0][1] = rc.out_mv[0][0][1];
                    fix_mv_precision(f, &b->mv[0][0], &b->mv[0][1]);
                }
                read_mv_residual(ts, b->mv[0], cdf->mv_comp,
                                 !f->force_integer_mv, f->hp);
            }

            /* interintra flags */
            int ii_sz_grp = ymode_size_context[bs];
            if (f->inter_intra && ((INTERINTRA_ALLOWED_MASK >> bs) & 1) &&
                msac_decode_bool_adapt(
                    s, cdf->interintra + (size_t)ii_sz_grp * 2)) {
                b->interintra_mode = msac_decode_symbol_adapt(
                    s, cdf->interintra_mode + (size_t)ii_sz_grp * 4, 3);
                int wedge_ctx = wedge_ctx_lut[bs];
                b->interintra_type =
                    INTER_INTRA_BLEND +
                    msac_decode_bool_adapt(
                        s, cdf->interintra_wedge + (size_t)wedge_ctx * 2);
                if (b->interintra_type == INTER_INTRA_WEDGE)
                    b->wedge_idx = msac_decode_symbol_adapt(
                        s, cdf->wedge_idx + (size_t)wedge_ctx * 16, 15);
            } else {
                b->interintra_type = INTER_INTRA_NONE;
            }

            /* motion variation */
            if (f->switchable_motion_mode &&
                b->interintra_type == INTER_INTRA_NONE &&
                imin(bw4, bh4) >= 2 &&
                !(!f->force_integer_mv && b->inter_mode == GLOBALMV &&
                  f->gmv[b->ref[0]].type > WM_TRANSLATION) &&
                ((have_left && findoddzero_l(t, by4, h4)) ||
                 (have_top && findoddzero_a(ts, t->bx, w4)))) {
                uint64_t masks[2];
                find_matching_ref(f, t, ts, intra_edge_flags, bw4, bh4, w4,
                                  h4, have_left, have_top, b->ref[0], masks);
                int allow_warp = f->svc_scale[b->ref[0]] == 0 &&
                                 !f->force_integer_mv && f->warp_motion &&
                                 (masks[0] | masks[1]) != 0;
                if (allow_warp)
                    b->motion_mode = msac_decode_symbol_adapt(
                        s, cdf->motion_mode + (size_t)bs * 3, 2);
                else
                    b->motion_mode = msac_decode_bool_adapt(
                        s, cdf->obmc + (size_t)bs * 2);
                if (b->motion_mode == MM_WARP) {
                    has_subpel_filter = 0;
                    WarpP wm;
                    wm.type = t->wm_type;
                    memcpy(wm.mat, t->wm_mat, sizeof(wm.mat));
                    wm.alpha = t->wm_alpha;
                    wm.beta = t->wm_beta;
                    wm.gamma = t->wm_gamma;
                    wm.delta = t->wm_delta;
                    derive_warpmv(f, t, bw4, bh4, masks[0], masks[1],
                                  b->mv[0][0], b->mv[0][1], &wm);
                    t->wm_type = wm.type;
                    memcpy(t->wm_mat, wm.mat, sizeof(wm.mat));
                    t->wm_alpha = wm.alpha;
                    t->wm_beta = wm.beta;
                    t->wm_gamma = wm.gamma;
                    t->wm_delta = wm.delta;
                    if (wm.type == WM_AFFINE) {
                        b->matrix[0] = wm.mat[2] - 0x10000;
                        b->matrix[1] = wm.mat[3];
                        b->matrix[2] = wm.mat[4];
                        b->matrix[3] = wm.mat[5] - 0x10000;
                    } else {
                        b->matrix[0] = -32768;
                        b->matrix[1] = b->matrix[2] = b->matrix[3] = 0;
                    }
                }
            } else {
                b->motion_mode = MM_TRANSLATION;
            }
        }

        /* subpel filter */
        if (f->subpel_filter_mode == FM_SWITCHABLE) {
            if (has_subpel_filter) {
                int comp = b->comp_type != COMP_INTER_NONE;
                int ctx1 = get_filter_ctx(&ts->a, &t->l, comp, 0, b->ref[0],
                                          by4, t->bx);
                int filter0 = msac_decode_symbol_adapt(
                    s, cdf->filter + ((size_t)0 * 8 + ctx1) * 3,
                    N_SWITCHABLE_FILTERS - 1);
                if (f->dual_filter) {
                    int ctx2 = get_filter_ctx(&ts->a, &t->l, comp, 1,
                                              b->ref[0], by4, t->bx);
                    int filter1 = msac_decode_symbol_adapt(
                        s, cdf->filter + ((size_t)1 * 8 + ctx2) * 3,
                        N_SWITCHABLE_FILTERS - 1);
                    filter_[0] = filter0;
                    filter_[1] = filter1;
                } else {
                    filter_[0] = filter0;
                    filter_[1] = filter0;
                }
            } else {
                filter_[0] = filter_[1] = FM_REGULAR;
            }
        } else {
            filter_[0] = filter_[1] = f->subpel_filter_mode;
        }
        b->filter2d = filter_2d_tbl[filter_[1]][filter_[0]];

        read_vartx_tree(f, ts, t, b, bs, bx4, by4);
        BlockRec *rec = snapshot_inter_item(f, ts, t, out, b);
        if (!rec)
            return out->error;
        /* syntax-pass rolling top-left filter update
         * (recon/inter.py recon_b_inter rd-part) */
        if (!FT_IS_KEY_OR_INTRA(frame_type) &&
            b->comp_type == COMP_INTER_NONE)
            t->tl_4x4_filter = b->filter2d;
        inter_read_coefs(f, ts, t, out, b, bs);

        if (f->lf_level_y[0] || f->lf_level_y[1])
            record_lf_inter(f, ts, t, b, bs,
                            b->comp_type != COMP_INTER_NONE ? 1 : 0,
                            has_chroma);

        /* splat (decode.rs:892/941) */
        if (b->comp_type != COMP_INTER_NONE || b->skip_mode) {
            int mode = b->inter_mode;
            int mf = (mode == GLOBALMV_GLOBALMV ? 1 : 0) |
                     (((1 << mode) & 0xBC) ? 2 : 0);
            splat_mv(f, t->by, t->bx, bw4, bh4, b->mv[0][0], b->mv[0][1],
                     b->mv[1][0], b->mv[1][1], b->ref[0] + 1, b->ref[1] + 1,
                     bs, mf);
        } else {
            int mode = b->inter_mode;
            int mf = ((mode == GLOBALMV && imin(bw4, bh4) >= 2) ? 1 : 0) |
                     (mode == NEWMV ? 2 : 0);
            int ref1 = b->interintra_type != INTER_INTRA_NONE ? 0 : -1;
            splat_mv(f, t->by, t->bx, bw4, bh4, b->mv[0][0], b->mv[0][1], 0,
                     0, b->ref[0] + 1, ref1, bs, mf);
        }

        for (int i = 0; i < bw4; i++) {
            int x = t->bx + i;
            ts->a.seg_pred[x] = (uint8_t)(seg_pred ? 1 : 0);
            ts->a.skip_mode[x] = (uint8_t)b->skip_mode;
            ts->a.intra[x] = 0;
            ts->a.skip[x] = (uint8_t)b->skip;
            ts->a.pal_sz[x] = 0;
            t->pal_sz_uv[x & 31] = 0;
            ts->a.tx_intra[x] = (int8_t)b_dim[2];
            ts->a.comp_type[x] = (uint8_t)b->comp_type;
            ts->a.filter0[x] = (uint8_t)filter_[0];
            ts->a.filter1[x] = (uint8_t)filter_[1];
            ts->a.mode[x] = (uint8_t)b->inter_mode;
            ts->a.ref0[x] = (int8_t)b->ref[0];
            ts->a.ref1[x] = (int8_t)b->ref[1];
        }
        for (int i = 0; i < bh4; i++) {
            int y = (by4 + i) & 31;
            t->l.seg_pred[y] = (uint8_t)(seg_pred ? 1 : 0);
            t->l.skip_mode[y] = (uint8_t)b->skip_mode;
            t->l.intra[y] = 0;
            t->l.skip[y] = (uint8_t)b->skip;
            t->l.pal_sz[y] = 0;
            t->pal_sz_uv[32 + y] = 0;
            t->l.tx_intra[y] = (int8_t)b_dim[3];
            t->l.comp_type[y] = (uint8_t)b->comp_type;
            t->l.filter0[y] = (uint8_t)filter_[0];
            t->l.filter1[y] = (uint8_t)filter_[1];
            t->l.mode[y] = (uint8_t)b->inter_mode;
            t->l.ref0[y] = (int8_t)b->ref[0];
            t->l.ref1[y] = (int8_t)b->ref[1];
        }
        if (has_chroma) {
            int cbx_abs = t->bx >> ss_hor;
            for (int i = 0; i < cbw4; i++)
                ts->a.uvmode[cbx_abs + i] = DC_PRED;
            for (int i = 0; i < cbh4; i++)
                t->l.uvmode[(cby4 + i) & 31] = DC_PRED;
        }

        rec->dbg_rng = s->rng;
    }

segmap_update:
    /* update segmap */
    if (f->seg_enabled && f->seg_update_map && f->cur_segmap) {
        for (int y = 0; y < bh4; y++)
            memset(f->cur_segmap + (size_t)(t->by + y) * f->segmap_stride +
                       t->bx,
                   b->seg_id, bw4);
    }
    return out->error;
}

/* ---------------------------------------------------------------------- */
/* intra-edge availability tree (syntax/intra_edge.py; src/intra_edge.rs)  */

#define EF_I444_THR 1
#define EF_I422_THR 2
#define EF_I420_THR 4
#define EF_I444_LHB 8
#define EF_I422_LHB 16
#define EF_I420_LHB 32
#define EF_ALL_THR (EF_I444_THR | EF_I422_THR | EF_I420_THR)
#define EF_ALL_LHB (EF_I444_LHB | EF_I422_LHB | EF_I420_LHB)
#define EF_ALL (EF_ALL_THR | EF_ALL_LHB)

typedef struct ENode {
    uint8_t o, h[2], v[2], h4, v4;
    int16_t child[4];      /* branch children (pool idx); -1 for tips */
    uint8_t tip_split[3];  /* tip-only split flags */
    uint8_t is_tip;
} ENode;

static ENode edge_pool[512];
static int edge_pool_n = 0;
static int edge_root_sb128 = -1;
static int edge_root_sb64 = -1;

static int edge_make_tip(int flags) {
    int idx = edge_pool_n++;
    ENode *n = &edge_pool[idx];
    n->is_tip = 1;
    n->o = (uint8_t)flags;
    n->h[0] = (uint8_t)(flags | EF_ALL_LHB);
    n->h[1] = (uint8_t)(flags & (EF_ALL_LHB | EF_I420_THR));
    n->v[0] = (uint8_t)(flags | EF_ALL_THR);
    n->v[1] = (uint8_t)(flags & (EF_ALL_THR | EF_I420_LHB | EF_I422_LHB));
    n->h4 = n->v4 = 0;
    n->child[0] = n->child[1] = n->child[2] = n->child[3] = -1;
    n->tip_split[0] = (uint8_t)((flags & EF_ALL_THR) | EF_I422_LHB);
    n->tip_split[1] = (uint8_t)(flags | EF_I444_THR);
    n->tip_split[2] =
        (uint8_t)(flags & (EF_I420_THR | EF_I420_LHB | EF_I422_LHB));
    return idx;
}

static int edge_make(int bl, int top_has_right, int left_has_bottom) {
    int flags = (top_has_right ? EF_ALL_THR : 0) |
                (left_has_bottom ? EF_ALL_LHB : 0);
    int idx = edge_pool_n++;
    {
        ENode *n = &edge_pool[idx];
        n->is_tip = 0;
        n->o = (uint8_t)flags;
        n->h[0] = (uint8_t)(flags | EF_ALL_LHB);
        n->h[1] = (uint8_t)(flags & EF_ALL_LHB);
        n->v[0] = (uint8_t)(flags | EF_ALL_THR);
        n->v[1] = (uint8_t)(flags & EF_ALL_THR);
        n->h4 = (uint8_t)(((bl == BL_16X16) ? (flags & EF_I420_THR) : 0) |
                          EF_ALL_LHB);
        n->v4 = (uint8_t)(((bl == BL_16X16)
                               ? (flags & (EF_I420_LHB | EF_I422_LHB))
                               : 0) |
                          EF_ALL_THR);
    }
    for (int n4 = 0; n4 < 4; n4++) {
        int thr = !(n4 == 3 || (n4 == 1 && !top_has_right));
        int lhb = n4 == 0 || (n4 == 2 && left_has_bottom);
        int child;
        if (bl == BL_16X16) {
            int tip_flags =
                (thr ? EF_ALL_THR : 0) | (lhb ? EF_ALL_LHB : 0);
            child = edge_make_tip(tip_flags);
        } else {
            child = edge_make(bl + 1, thr, lhb);
        }
        edge_pool[idx].child[n4] = (int16_t)child;
    }
    return idx;
}

static void edge_init(void) {
    if (edge_root_sb128 >= 0)
        return;
    edge_root_sb128 = edge_make(BL_128X128, 1, 0);
    edge_root_sb64 = edge_make(BL_64X64, 1, 0);
}

/* ---------------------------------------------------------------------- */
/* decode_sb: recursive partition walk (decode.py decode_sb;
 * src/decode.rs:3260)                                                     */

static int decode_sb(const SyFrame *f, SyTile *ts, SyTask *t, SyOut *out,
                     int bl, const ENode *node) {
    int hsz = 16 >> bl;
    int have_h_split = f->bw > t->bx + hsz;
    int have_v_split = f->bh > t->by + hsz;
    Msac *s = ts->msac;

    if (!have_h_split && !have_v_split)
        return decode_sb(f, ts, t, out, bl + 1,
                         &edge_pool[node->child[0]]);

    int by8 = (t->by & 31) >> 1;
    int ctx = ((ts->a.partition[t->bx >> 1] >> (4 - bl)) & 1) +
              2 * ((t->l.partition[by8] >> (4 - bl)) & 1);
    uint16_t *pc = ts->cdf.partition + ((size_t)bl * 4 + ctx) * 10;
    int bp;
    int err;

    if (have_h_split && have_v_split) {
        bp = msac_decode_symbol_adapt(s, pc, partition_type_count[bl]);
        if (f->layout == PL_I422 &&
            (bp == PARTITION_V || bp == PARTITION_V4 ||
             bp == PARTITION_T_LEFT_SPLIT || bp == PARTITION_T_RIGHT_SPLIT))
            return SYE_I422_VERT;
        int b0 = block_sizes_tbl[bl][bp][0];
        int b1 = block_sizes_tbl[bl][bp][1];

        switch (bp) {
        case PARTITION_NONE:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, node->o)))
                return err;
            break;
        case PARTITION_H:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, node->h[0])))
                return err;
            t->by += hsz;
            err = decode_b(f, ts, t, out, bl, b0, bp, node->h[1]);
            t->by -= hsz;
            if (err)
                return err;
            break;
        case PARTITION_V:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, node->v[0])))
                return err;
            t->bx += hsz;
            err = decode_b(f, ts, t, out, bl, b0, bp, node->v[1]);
            t->bx -= hsz;
            if (err)
                return err;
            break;
        case PARTITION_SPLIT:
            if (bl == BL_8X8) {
                if ((err = decode_b(f, ts, t, out, bl, BS_4x4, bp, EF_ALL)))
                    return err;
                int tl_filter = t->tl_4x4_filter;
                t->bx += 1;
                if ((err = decode_b(f, ts, t, out, bl, BS_4x4, bp,
                                    node->tip_split[0])))
                    return err;
                t->bx -= 1;
                t->by += 1;
                if ((err = decode_b(f, ts, t, out, bl, BS_4x4, bp,
                                    node->tip_split[1])))
                    return err;
                t->bx += 1;
                t->tl_4x4_filter = tl_filter;
                err = decode_b(f, ts, t, out, bl, BS_4x4, bp,
                               node->tip_split[2]);
                t->bx -= 1;
                t->by -= 1;
                if (err)
                    return err;
            } else {
                if ((err = decode_sb(f, ts, t, out, bl + 1,
                                     &edge_pool[node->child[0]])))
                    return err;
                t->bx += hsz;
                err = decode_sb(f, ts, t, out, bl + 1,
                                &edge_pool[node->child[1]]);
                t->bx -= hsz;
                if (err)
                    return err;
                t->by += hsz;
                if ((err = decode_sb(f, ts, t, out, bl + 1,
                                     &edge_pool[node->child[2]]))) {
                    t->by -= hsz;
                    return err;
                }
                t->bx += hsz;
                err = decode_sb(f, ts, t, out, bl + 1,
                                &edge_pool[node->child[3]]);
                t->bx -= hsz;
                t->by -= hsz;
                if (err)
                    return err;
            }
            break;
        case PARTITION_T_TOP_SPLIT:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, EF_ALL)))
                return err;
            t->bx += hsz;
            err = decode_b(f, ts, t, out, bl, b0, bp, node->v[1]);
            t->bx -= hsz;
            if (err)
                return err;
            t->by += hsz;
            err = decode_b(f, ts, t, out, bl, b1, bp, node->h[1]);
            t->by -= hsz;
            if (err)
                return err;
            break;
        case PARTITION_T_BOTTOM_SPLIT:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, node->h[0])))
                return err;
            t->by += hsz;
            if ((err = decode_b(f, ts, t, out, bl, b1, bp, node->v[0]))) {
                t->by -= hsz;
                return err;
            }
            t->bx += hsz;
            err = decode_b(f, ts, t, out, bl, b1, bp, 0);
            t->bx -= hsz;
            t->by -= hsz;
            if (err)
                return err;
            break;
        case PARTITION_T_LEFT_SPLIT:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, EF_ALL)))
                return err;
            t->by += hsz;
            err = decode_b(f, ts, t, out, bl, b0, bp, node->h[1]);
            t->by -= hsz;
            if (err)
                return err;
            t->bx += hsz;
            err = decode_b(f, ts, t, out, bl, b1, bp, node->v[1]);
            t->bx -= hsz;
            if (err)
                return err;
            break;
        case PARTITION_T_RIGHT_SPLIT:
            if ((err = decode_b(f, ts, t, out, bl, b0, bp, node->v[0])))
                return err;
            t->bx += hsz;
            if ((err = decode_b(f, ts, t, out, bl, b1, bp, node->h[0]))) {
                t->bx -= hsz;
                return err;
            }
            t->by += hsz;
            err = decode_b(f, ts, t, out, bl, b1, bp, 0);
            t->by -= hsz;
            t->bx -= hsz;
            if (err)
                return err;
            break;
        case PARTITION_H4: {
            int by0 = t->by;
            err = decode_b(f, ts, t, out, bl, b0, bp, node->h[0]);
            if (!err) {
                t->by += hsz >> 1;
                err = decode_b(f, ts, t, out, bl, b0, bp, node->h4);
            }
            if (!err) {
                t->by += hsz >> 1;
                err = decode_b(f, ts, t, out, bl, b0, bp, EF_ALL_LHB);
            }
            if (!err) {
                t->by += hsz >> 1;
                if (t->by < f->bh)
                    err = decode_b(f, ts, t, out, bl, b0, bp, node->h[1]);
            }
            t->by = by0;
            if (err)
                return err;
            break;
        }
        case PARTITION_V4: {
            int bx0 = t->bx;
            err = decode_b(f, ts, t, out, bl, b0, bp, node->v[0]);
            if (!err) {
                t->bx += hsz >> 1;
                err = decode_b(f, ts, t, out, bl, b0, bp, node->v4);
            }
            if (!err) {
                t->bx += hsz >> 1;
                err = decode_b(f, ts, t, out, bl, b0, bp, EF_ALL_THR);
            }
            if (!err) {
                t->bx += hsz >> 1;
                if (t->bx < f->bw)
                    err = decode_b(f, ts, t, out, bl, b0, bp, node->v[1]);
            }
            t->bx = bx0;
            if (err)
                return err;
            break;
        }
        }
    } else if (have_h_split) {
        int is_split =
            msac_decode_bool(s, gather_top_partition_prob(pc, bl));
        if (is_split) {
            bp = PARTITION_SPLIT;
            if ((err = decode_sb(f, ts, t, out, bl + 1,
                                 &edge_pool[node->child[0]])))
                return err;
            t->bx += hsz;
            err = decode_sb(f, ts, t, out, bl + 1,
                            &edge_pool[node->child[1]]);
            t->bx -= hsz;
            if (err)
                return err;
        } else {
            bp = PARTITION_H;
            if ((err = decode_b(f, ts, t, out, bl,
                                block_sizes_tbl[bl][PARTITION_H][0], bp,
                                node->h[0])))
                return err;
        }
    } else {
        int is_split =
            msac_decode_bool(s, gather_left_partition_prob(pc, bl));
        if (f->layout == PL_I422 && !is_split)
            return SYE_I422_VERT;
        if (is_split) {
            bp = PARTITION_SPLIT;
            if ((err = decode_sb(f, ts, t, out, bl + 1,
                                 &edge_pool[node->child[0]])))
                return err;
            t->by += hsz;
            err = decode_sb(f, ts, t, out, bl + 1,
                            &edge_pool[node->child[2]]);
            t->by -= hsz;
            if (err)
                return err;
        } else {
            bp = PARTITION_V;
            if ((err = decode_b(f, ts, t, out, bl,
                                block_sizes_tbl[bl][PARTITION_V][0], bp,
                                node->v[0])))
                return err;
        }
    }

    if (bp != PARTITION_SPLIT || bl == BL_8X8) {
        int val_a = al_part_ctx[0][bl][bp];
        int val_l = al_part_ctx[1][bl][bp];
        for (int i = 0; i < hsz; i++) {
            ts->a.partition[(t->bx >> 1) + i] = (uint8_t)val_a;
            t->l.partition[by8 + i] = (uint8_t)val_l;
        }
    }
    return 0;
}

/* entry: decode one superblock rooted at (t->bx, t->by) */
API int32_t sy_decode_sb(const SyFrame *f, SyTile *ts, SyTask *t,
                         SyOut *out) {
    edge_init();
    div_lut_init();
    int root = f->sb128 ? edge_root_sb128 : edge_root_sb64;
    int root_bl = f->sb128 ? BL_128X128 : BL_64X64;
    int err = decode_sb(f, ts, t, out, root_bl, &edge_pool[root]);
    if (!err)
        err = out->error;
    return err;
}

/* ---------------------------------------------------------------------- */
/* temporal MV save/load (syntax/refmvs.py save_tmvs/load_tmvs;
 * src/refmvs.rs save_tmvs_c:1481 / load_tmvs_c:1379).
 * TB records are packed 5 bytes: {int16 mv[2]; int8 ref}.                 */

typedef struct TmvsCall {
    const uint8_t *r;     /* RB grid */
    int32_t r_stride;
    uint8_t *rp;          /* this frame's temporal grid (TB) */
    int32_t rp_stride;
    uint8_t *rp_proj;     /* projection target (TB) */
    int32_t proj_stride;
    const uint8_t *rp_ref[7]; /* refs' temporal grids (TB), NULL if unusable */
    int32_t rp_ref_stride[7];
    int32_t mfmv_ref[3];
    int32_t mfmv_ref2cur[3];
    int32_t mfmv_ref2ref[3][7];
    int32_t n_mfmvs;
    int32_t mfmv_sign[7];
    int32_t iw8, ih8;
    int32_t col_start8, col_end8, row_start8, row_end8;
    const uint8_t *bdims;
} TmvsCall;

static const int32_t tmv_div_mult[32] = {
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638, 1489,
    1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744, 712, 682,
    655, 630, 606, 585, 564, 546, 528,
};

static inline void tmv_projection(int mvx, int mvy, int num, int den,
                                  int *ox, int *oy) {
    int64_t frac = (int64_t)num * tmv_div_mult[den];
    int64_t x = mvx * frac;
    int64_t y = mvy * frac;
    int mx = (1 << 14) - 1;
    *ox = iclip((int)((x + 8192 + (x >> 63)) >> 14), -mx, mx);
    *oy = iclip((int)((y + 8192 + (y >> 63)) >> 14), -mx, mx);
}

API void sy_save_tmvs(const TmvsCall *p) {
    int row_end8 = imin(p->row_end8, p->ih8);
    int col_end8 = imin(p->col_end8, p->iw8);
    for (int y = p->row_start8; y < row_end8; y++) {
        const uint8_t *row =
            p->r + ((size_t)(y * 2 + 1) * p->r_stride) * 12;
        int x = p->col_start8;
        while (x < col_end8) {
            const uint8_t *cand = row + (size_t)(x * 2 + 1) * 12;
            const int16_t *cmv = (const int16_t *)cand;
            int bs = cand[10];
            int bw8 = (p->bdims[bs * 4 + 0] + 1) >> 1;
            int bmx = 0, bmy = 0, bref = 0;
            for (int i = 1; i >= 0; i--) {
                int rr = (int8_t)cand[8 + i];
                int mx = cmv[i * 2 + 0], my = cmv[i * 2 + 1];
                int amx = mx < 0 ? -mx : mx, amy = my < 0 ? -my : my;
                if (rr > 0 && p->mfmv_sign[rr - 1] && (amy | amx) < 4096) {
                    bmx = mx;
                    bmy = my;
                    bref = rr;
                    break;
                }
            }
            uint8_t *dst = p->rp + ((size_t)y * p->rp_stride + x) * 5;
            /* python writes the full bw8 span (numpy clamps at the array
             * width, not col_end8) */
            for (int k = 0; k < bw8 && x + k < p->rp_stride; k++) {
                int16_t *dmv = (int16_t *)(dst + (size_t)k * 5);
                dmv[0] = (int16_t)bmx;
                dmv[1] = (int16_t)bmy;
                dst[(size_t)k * 5 + 4] = (uint8_t)(int8_t)bref;
            }
            x += bw8;
        }
    }
}

API void sy_load_tmvs(const TmvsCall *p) {
    int row_end8 = imin(p->row_end8, p->ih8);
    int col_start8i = imax(p->col_start8 - 8, 0);
    int col_end8i = imin(p->col_end8 + 8, p->iw8);
    /* invalidate the target region */
    for (int y = p->row_start8; y < row_end8; y++) {
        uint8_t *row = p->rp_proj + (size_t)y * p->proj_stride * 5;
        for (int x = p->col_start8; x < p->col_end8; x++) {
            int16_t *mv = (int16_t *)(row + (size_t)x * 5);
            mv[0] = INVALID_MV_X;
            mv[1] = INVALID_MV_Y;
        }
    }
    for (int n = 0; n < p->n_mfmvs; n++) {
        int ref2cur = p->mfmv_ref2cur[n];
        if (ref2cur == (int32_t)0x80000000)
            continue;
        int refidx = p->mfmv_ref[n];
        int ref_sign = refidx - 4;
        const uint8_t *rarr = p->rp_ref[refidx];
        if (!rarr)
            continue;
        int ref_stride = p->rp_ref_stride[refidx];
        const int32_t *ref2ref_n = p->mfmv_ref2ref[n];
        for (int y = p->row_start8; y < row_end8; y++) {
            int y_sb_align = y & ~7;
            int y_proj_start = imax(y_sb_align, p->row_start8);
            int y_proj_end = imin(y_sb_align + 8, row_end8);
            const uint8_t *rrow = rarr + (size_t)y * ref_stride * 5;
            int x = col_start8i;
            while (x < col_end8i) {
                const uint8_t *tb = rrow + (size_t)x * 5;
                int b_ref = (int8_t)tb[4];
                if (b_ref == 0) {
                    x++;
                    continue;
                }
                int ref2ref = ref2ref_n[b_ref - 1];
                if (ref2ref == 0) {
                    x++;
                    continue;
                }
                int b_mvx = ((const int16_t *)tb)[0];
                int b_mvy = ((const int16_t *)tb)[1];
                int ox, oy;
                tmv_projection(b_mvx, b_mvy, ref2cur, ref2ref, &ox, &oy);
                int aox = ox < 0 ? -ox : ox, aoy = oy < 0 ? -oy : oy;
                int pos_x =
                    x + ((int64_t)(ox ^ ref_sign) < 0 ? -(aox >> 6)
                                                      : (aox >> 6));
                int pos_y =
                    y + ((int64_t)(oy ^ ref_sign) < 0 ? -(aoy >> 6)
                                                      : (aoy >> 6));
                if (pos_y >= y_proj_start && pos_y < y_proj_end) {
                    for (;;) {
                        int x_sb_align = x & ~7;
                        if (pos_x >= imax(x_sb_align - 8, p->col_start8) &&
                            pos_x < imin(x_sb_align + 16, p->col_end8)) {
                            uint8_t *dst =
                                p->rp_proj +
                                ((size_t)pos_y * p->proj_stride + pos_x) * 5;
                            int16_t *dmv = (int16_t *)dst;
                            dmv[0] = (int16_t)b_mvx;
                            dmv[1] = (int16_t)b_mvy;
                            dst[4] = (uint8_t)(int8_t)ref2ref;
                        }
                        x++;
                        if (x >= col_end8i)
                            break;
                        const uint8_t *tb2 = rrow + (size_t)x * 5;
                        if ((int8_t)tb2[4] != b_ref ||
                            ((const int16_t *)tb2)[0] != b_mvx ||
                            ((const int16_t *)tb2)[1] != b_mvy)
                            break;
                        pos_x++;
                    }
                } else {
                    for (;;) {
                        x++;
                        if (x >= col_end8i)
                            break;
                        const uint8_t *tb2 = rrow + (size_t)x * 5;
                        if ((int8_t)tb2[4] != b_ref ||
                            ((const int16_t *)tb2)[0] != b_mvx ||
                            ((const int16_t *)tb2)[1] != b_mvy)
                            break;
                    }
                }
            }
        }
    }
}

/* ---------------------------------------------------------------------- */
/* One-time global table init, called once from Python at library load so
 * per-tile decode threads never race the lazy initializers
 * (div_lut for warp params, the static intra-edge tree — the analog of
 * rav1d's const-built IntraEdges::DEFAULT, src/intra_edge.rs:370). */

int32_t sy_global_init(void) {
    div_lut_init();
    edge_init();
    return 0;
}
