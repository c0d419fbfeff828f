/* Native entropy core: msac range decoder + coefficient-block decoder.
 *
 * Behavior parity: src/msac.rs (64-bit window) and src/recon.rs decode_coefs
 * (:478) / get_skip_ctx (:252) / get_dc_sign_ctx (:318) / get_lo_ctx (:449).
 * This is a fresh implementation matching the Python reference in
 * rav1d_tpu/entropy/msac.py and rav1d_tpu/recon/coefs.py (the correctness
 * anchor, bit-exact against the oracle); all spec data tables are passed in
 * from Python (no tables are duplicated here).
 *
 * Exposed via ctypes (see rav1d_tpu/native/__init__.py).
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define EC_WIN_SIZE 64

#define API __attribute__((visibility("default")))

typedef struct Msac {
    const uint8_t *buf;
    size_t pos, end;
    uint64_t dif;
    uint32_t rng;
    int32_t cnt;
    int32_t allow_update;
} Msac;

static void msac_refill(Msac *s) {
    int c = EC_WIN_SIZE - 24 - s->cnt;
    uint64_t dif = s->dif;
    const uint8_t *buf = s->buf;
    size_t pos = s->pos, end = s->end;
    while (c >= 0 && pos < end) {
        dif ^= (uint64_t)buf[pos++] << c;
        c -= 8;
    }
    s->pos = pos;
    s->dif = dif;
    s->cnt = EC_WIN_SIZE - 24 - c;
}

static void msac_norm(Msac *s, uint64_t dif, uint32_t rng) {
    int d = 15 ^ (31 ^ __builtin_clz(rng));
    s->cnt -= d;
    s->dif = ((dif + 1) << d) - 1;
    s->rng = rng << d;
    if (s->cnt < 0)
        msac_refill(s);
}

API void msac_init(Msac *s, const uint8_t *buf, size_t len,
                   int disable_cdf_update) {
    s->buf = buf;
    s->pos = 0;
    s->end = len;
    s->dif = ((uint64_t)1 << (EC_WIN_SIZE - 1)) - 1;
    s->rng = 0x8000;
    s->cnt = -15;
    s->allow_update = !disable_cdf_update;
    msac_refill(s);
}

API uint32_t msac_decode_bool_equi(Msac *s) {
    uint32_t r = s->rng;
    uint64_t dif = s->dif;
    uint32_t v = ((r >> 8) << 7) + EC_MIN_PROB;
    uint64_t vw = (uint64_t)v << (EC_WIN_SIZE - 16);
    int ret = dif >= vw;
    if (ret) {
        dif -= vw;
        v = r - v;
    }
    msac_norm(s, dif, v);
    return !ret;
}

API uint32_t msac_decode_bool(Msac *s, uint32_t f) {
    uint32_t r = s->rng;
    uint64_t dif = s->dif;
    uint32_t v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT)) +
                 EC_MIN_PROB;
    uint64_t vw = (uint64_t)v << (EC_WIN_SIZE - 16);
    int ret = dif >= vw;
    if (ret) {
        dif -= vw;
        v = r - v;
    }
    msac_norm(s, dif, v);
    return !ret;
}

API uint32_t msac_decode_bool_adapt(Msac *s, uint16_t *cdf) {
    uint32_t bit = msac_decode_bool(s, cdf[0]);
    if (s->allow_update) {
        uint32_t count = cdf[1];
        uint32_t rate = 4 + (count >> 4);
        if (bit)
            cdf[0] += (32768 - cdf[0]) >> rate;
        else
            cdf[0] -= cdf[0] >> rate;
        cdf[1] = count + (count < 32);
    }
    return bit;
}

API uint32_t msac_decode_symbol_adapt(Msac *s, uint16_t *cdf,
                                      size_t n_symbols) {
    uint32_t c = (uint32_t)(s->dif >> (EC_WIN_SIZE - 16));
    uint32_t r = s->rng >> 8;
    uint32_t u, v = s->rng;
    uint32_t val = 0;
    do {
        u = v;
        v = r * (cdf[val] >> EC_PROB_SHIFT);
        v >>= 7 - EC_PROB_SHIFT;
        v += EC_MIN_PROB * ((uint32_t)n_symbols - val);
        if (c >= v)
            break;
        val++;
    } while (1);
    msac_norm(s, s->dif - ((uint64_t)v << (EC_WIN_SIZE - 16)), u - v);
    if (s->allow_update) {
        uint32_t count = cdf[n_symbols];
        uint32_t rate = 4 + (count >> 4) + (n_symbols > 2);
        uint32_t i = 0;
        for (; i < val; i++)
            cdf[i] += (32768 - cdf[i]) >> rate;
        for (; i < n_symbols; i++)
            cdf[i] -= cdf[i] >> rate;
        cdf[n_symbols] = count + (count < 32);
    }
    return val;
}

API uint32_t msac_decode_hi_tok(Msac *s, uint16_t *cdf) {
    uint32_t tok_br = msac_decode_symbol_adapt(s, cdf, 3);
    uint32_t tok = 3 + tok_br;
    if (tok_br == 3) {
        tok_br = msac_decode_symbol_adapt(s, cdf, 3);
        tok = 6 + tok_br;
        if (tok_br == 3) {
            tok_br = msac_decode_symbol_adapt(s, cdf, 3);
            tok = 9 + tok_br;
            if (tok_br == 3)
                tok = 12 + msac_decode_symbol_adapt(s, cdf, 3);
        }
    }
    return tok;
}

API uint32_t msac_decode_bools(Msac *s, uint32_t n) {
    uint32_t v = 0;
    while (n--)
        v = (v << 1) | msac_decode_bool_equi(s);
    return v;
}

API uint32_t msac_decode_uniform(Msac *s, uint32_t n) {
    int l = 32 - __builtin_clz(n); /* ulog2(n) + 1 */
    uint32_t m = (1u << l) - n;
    uint32_t v = msac_decode_bools(s, l - 1);
    if (v < m)
        return v;
    return (v << 1) - m + msac_decode_bool_equi(s);
}

static int inv_recenter(int r, int v) {
    if (v > (r << 1))
        return v;
    if ((v & 1) == 0)
        return (v >> 1) + r;
    return r - ((v + 1) >> 1);
}

API int32_t msac_decode_subexp(Msac *s, int32_t ref, int32_t n, uint32_t k) {
    uint32_t a = 0;
    if (msac_decode_bool_equi(s)) {
        if (msac_decode_bool_equi(s))
            k += msac_decode_bool_equi(s) + 1;
        a = 1u << k;
    }
    uint32_t v = msac_decode_bools(s, k) + a;
    if (ref * 2 <= n)
        return inv_recenter(ref, v);
    return n - 1 - inv_recenter(n - 1 - ref, v);
}

static uint32_t read_golomb(Msac *s) {
    int len = 0;
    uint32_t val = 1;
    while (!msac_decode_bool_equi(s) && len < 32)
        len++;
    while (len--)
        val = (val << 1) + msac_decode_bool_equi(s);
    return val - 1;
}

/* ---------------------------------------------------------------------- */
/* decode_coefs                                                            */

enum { TX_CLASS_2D = 0, TX_CLASS_H = 1, TX_CLASS_V = 2 };

/* txtp decode kinds (see rav1d_tpu/recon/coefs.py decode_coefs) */
enum {
    TXTP_FIXED = 0,   /* use txtp_fixed as-is, no symbol read */
    TXTP_INTRA2 = 1,  /* symbol n=4,  set offset 0 */
    TXTP_INTRA1 = 2,  /* symbol n=6,  set offset 5 */
    TXTP_INTER3 = 3,  /* bool_adapt: txtp = (bit - 1) & idtx_val */
    TXTP_INTER2 = 4,  /* symbol n=11, set offset 12 */
    TXTP_INTER1 = 5,  /* symbol n=15, set offset 24 */
};

/* All spec tables are passed by pointer from the Python side (single source
 * of truth: the extracted .npz data).  CDF table strides below mirror the
 * padded numpy layouts built in rav1d_tpu/entropy/cdf.py (last axis padded
 * by one counter slot). */
typedef struct CoefCdfPtrs {
    uint16_t *skip;          /* (5, 13, 2)     */
    uint16_t *eob_bin_16;    /* (2, 2, 5)      */
    uint16_t *eob_bin_32;    /* (2, 2, 6)      */
    uint16_t *eob_bin_64;    /* (2, 2, 7)      */
    uint16_t *eob_bin_128;   /* (2, 2, 8)      */
    uint16_t *eob_bin_256;   /* (2, 2, 9)      */
    uint16_t *eob_bin_512;   /* (2, 10)        */
    uint16_t *eob_bin_1024;  /* (2, 11)        */
    uint16_t *eob_hi_bit;    /* (5, 2, 11, 2)  */
    uint16_t *eob_base_tok;  /* (5, 2, 4, 3)   */
    uint16_t *base_tok;      /* (5, 2, 41, 4)  */
    uint16_t *br_tok;        /* (4, 2, 21, 4)  */
    uint16_t *dc_sign;       /* (2, 3, 2)      */
} CoefCdfPtrs;

typedef struct CoefCallParams {
    /* geometry */
    int32_t tdim_lw, tdim_lh, tdim_w, tdim_h, tdim_ctx, tdim_min, tdim_max;
    int32_t bdim_lw, bdim_lh;    /* b_dim[2], b_dim[3] */
    int32_t chroma, ss_ver, ss_hor;
    int32_t ctx_off_idx;         /* LO_CTX_OFFSETS first index (2D only) */
    /* txtp selection */
    int32_t txtp_mode;           /* TXTP_* */
    int32_t txtp_fixed;          /* for TXTP_FIXED */
    int32_t skip_txtp;           /* txtp reported when all-skip (WHT/DCT) */
    int32_t idtx_val;            /* IDTX enum value (for TXTP_INTER3) */
    uint16_t *txtp_cdf;          /* cdf row for non-fixed modes */
    /* dequant */
    int32_t dq_dc, dq_ac, dq_shift, cf_max;
    /* neighbour ctx */
    uint8_t *a; int32_t a_off;
    uint8_t *l; int32_t l_off;
    /* spec tables */
    const uint8_t *skip_ctx_tbl;      /* (5,5) */
    const uint8_t *lo_ctx_offsets;    /* (3,5,5), or row selected by idx */
    const uint8_t *tx_types_per_set;  /* 40 entries */
    const uint8_t *tx_type_class;     /* per-txtp class */
    const uint16_t *scan;             /* scan table for this tx (2D) */
    const int32_t *qm;                /* qm row or NULL */
    /* output */
    int32_t *cf;
    /* results */
    int32_t eob, txtp, cf_ctx;
} CoefCallParams;

static int get_skip_ctx(const CoefCallParams *p) {
    if (p->chroma) {
        int not_one_blk =
            (p->bdim_lw - (p->bdim_lw && p->ss_hor) > p->tdim_lw) ||
            (p->bdim_lh - (p->bdim_lh && p->ss_ver) > p->tdim_lh);
        int ca = 0, cl = 0;
        for (int i = 0; i < (1 << p->tdim_lw); i++)
            ca |= p->a[p->a_off + i] != 0x40;
        for (int i = 0; i < (1 << p->tdim_lh); i++)
            cl |= p->l[p->l_off + i] != 0x40;
        return 7 + not_one_blk * 3 + ca + cl;
    }
    if (p->bdim_lw == p->tdim_lw && p->bdim_lh == p->tdim_lh)
        return 0;
    int la = 0, ll = 0;
    int wn = 1 << p->tdim_lw;  if (wn > 16) wn = 16;
    int hn = 1 << p->tdim_lh;  if (hn > 16) hn = 16;
    for (int i = 0; i < wn; i++)
        la |= p->a[p->a_off + i];
    for (int i = 0; i < hn; i++)
        ll |= p->l[p->l_off + i];
    la &= 0x3F; if (la > 4) la = 4;
    ll &= 0x3F; if (ll > 4) ll = 4;
    return p->skip_ctx_tbl[la * 5 + ll];
}

static int get_dc_sign_ctx(const CoefCallParams *p) {
    int wn = p->tdim_w < 16 ? p->tdim_w : 16;
    int hn = p->tdim_h < 16 ? p->tdim_h : 16;
    int s = 0;
    for (int i = 0; i < wn; i++)
        s += p->a[p->a_off + i] >> 6;
    for (int i = 0; i < hn; i++)
        s += p->l[p->l_off + i] >> 6;
    s -= wn + hn;
    return (s != 0) + (s > 0);
}

static int get_lo_ctx(const uint8_t *levels, int base, int tx_class,
                      const uint8_t *ctx_offsets, int x, int y, int stride,
                      unsigned *hi_mag_out) {
    unsigned mag = levels[base + stride] + levels[base + 1];
    int offset;
    if (tx_class == TX_CLASS_2D) {
        mag += levels[base + stride + 1];
        *hi_mag_out = mag;
        mag += levels[base + 2] + levels[base + 2 * stride];
        int yy = y < 4 ? y : 4, xx = x < 4 ? x : 4;
        offset = ctx_offsets[yy * 5 + xx];
    } else {
        mag += levels[base + 2];
        *hi_mag_out = mag;
        mag += levels[base + 3] + levels[base + 4];
        offset = 26 + (y > 1 ? 10 : y * 5);
    }
    return offset + (mag > 512 ? 4 : (mag + 64) >> 7);
}

API void dav1d_decode_coefs(Msac *s, const CoefCdfPtrs *cdf,
                            CoefCallParams *p) {
    const int chroma = p->chroma;
    const int tctx = p->tdim_ctx;

    /* skip */
    int sctx = get_skip_ctx(p);
    if (msac_decode_bool_adapt(s, cdf->skip + (tctx * 13 + sctx) * 2)) {
        p->eob = -1;
        p->txtp = p->skip_txtp;
        p->cf_ctx = 0x40;
        return;
    }

    /* tx type */
    int txtp;
    switch (p->txtp_mode) {
    case TXTP_FIXED:
        txtp = p->txtp_fixed;
        break;
    case TXTP_INTRA2:
        txtp = p->tx_types_per_set[msac_decode_symbol_adapt(s, p->txtp_cdf, 4)];
        break;
    case TXTP_INTRA1:
        txtp = p->tx_types_per_set[5 +
                   msac_decode_symbol_adapt(s, p->txtp_cdf, 6)];
        break;
    case TXTP_INTER3:
        txtp = ((int)msac_decode_bool_adapt(s, p->txtp_cdf) - 1) & p->idtx_val;
        break;
    case TXTP_INTER2:
        txtp = p->tx_types_per_set[12 +
                   msac_decode_symbol_adapt(s, p->txtp_cdf, 11)];
        break;
    default:
        txtp = p->tx_types_per_set[24 +
                   msac_decode_symbol_adapt(s, p->txtp_cdf, 15)];
        break;
    }
    p->txtp = txtp;

    /* eob */
    int lw = p->tdim_lw < 3 ? p->tdim_lw : 3; /* min(lw, TX_32X32) */
    int lh = p->tdim_lh < 3 ? p->tdim_lh : 3;
    int tx2dszctx = lw + lh;
    int tx_class = p->tx_type_class[txtp];
    int is_1d = tx_class != TX_CLASS_2D;
    int eob_bin;
    switch (tx2dszctx) {
    case 0:
        eob_bin = msac_decode_symbol_adapt(
            s, cdf->eob_bin_16 + (chroma * 2 + is_1d) * 5, 4);
        break;
    case 1:
        eob_bin = msac_decode_symbol_adapt(
            s, cdf->eob_bin_32 + (chroma * 2 + is_1d) * 6, 5);
        break;
    case 2:
        eob_bin = msac_decode_symbol_adapt(
            s, cdf->eob_bin_64 + (chroma * 2 + is_1d) * 7, 6);
        break;
    case 3:
        eob_bin = msac_decode_symbol_adapt(
            s, cdf->eob_bin_128 + (chroma * 2 + is_1d) * 8, 7);
        break;
    case 4:
        eob_bin = msac_decode_symbol_adapt(
            s, cdf->eob_bin_256 + (chroma * 2 + is_1d) * 9, 8);
        break;
    case 5:
        eob_bin = msac_decode_symbol_adapt(s, cdf->eob_bin_512 + chroma * 10, 9);
        break;
    default:
        eob_bin = msac_decode_symbol_adapt(s, cdf->eob_bin_1024 + chroma * 11,
                                           10);
        break;
    }

    int eob;
    if (eob_bin > 1) {
        int eob_hi_bit = msac_decode_bool_adapt(
            s, cdf->eob_hi_bit + ((tctx * 2 + chroma) * 11 + eob_bin) * 2);
        eob = ((eob_hi_bit | 2) << (eob_bin - 2)) |
              msac_decode_bools(s, eob_bin - 2);
    } else {
        eob = eob_bin;
    }
    p->eob = eob;

    uint16_t *eob_cdf = cdf->eob_base_tok + (tctx * 2 + chroma) * 4 * 3;
    int brctx = tctx < 3 ? tctx : 3;
    uint16_t *hi_cdf = cdf->br_tok + (brctx * 2 + chroma) * 21 * 4;
    int32_t *cf = p->cf;

    unsigned rc = 0;
    unsigned dc_tok;

    if (eob) {
        uint16_t *lo_cdf = cdf->base_tok + (tctx * 2 + chroma) * 41 * 4;
        int sw = p->tdim_w < 8 ? p->tdim_w : 8;
        int sh = p->tdim_h < 8 ? p->tdim_h : 8;
        int ctx = 1 + (eob > sw * sh * 2) + (eob > sw * sh * 4);
        unsigned eob_tok = msac_decode_symbol_adapt(s, eob_cdf + ctx * 3, 2);
        unsigned tok = eob_tok + 1;
        unsigned level_tok = tok * 0x41;

        const uint8_t *ctx_offsets = NULL;
        const uint16_t *scan = p->scan;
        int stride, shift, shift2, mask, clear;
        if (tx_class == TX_CLASS_2D) {
            ctx_offsets = p->lo_ctx_offsets + p->ctx_off_idx * 25;
            stride = 4 * sh;
            shift = p->tdim_lh < 4 ? p->tdim_lh + 2 : 5;
            shift2 = 0;
            mask = 4 * sh - 1;
            clear = stride * (4 * sw + 2);
        } else if (tx_class == TX_CLASS_H) {
            stride = 16;
            shift = p->tdim_lh + 2;
            shift2 = 0;
            mask = 4 * sh - 1;
            clear = stride * (4 * sh + 2);
        } else {
            stride = 16;
            shift = p->tdim_lw + 2;
            shift2 = p->tdim_lh + 2;
            mask = 4 * sw - 1;
            clear = stride * (4 * sw + 2);
        }

        uint8_t levels[32 * 34 + 2 * 32 + 5];
        memset(levels, 0, clear + 2 * stride + 5);

        int x, y;
        if (tx_class == TX_CLASS_2D) {
            rc = scan[eob];
            x = rc >> shift;
            y = rc & mask;
        } else if (tx_class == TX_CLASS_H) {
            x = eob & mask;
            y = eob >> shift;
            rc = eob;
        } else {
            x = eob & mask;
            y = eob >> shift;
            rc = (x << shift2) | y;
        }

        if (eob_tok == 2) {
            int hictx = (tx_class == TX_CLASS_2D ? (x | y) > 1 : y != 0) ? 14
                                                                         : 7;
            tok = msac_decode_hi_tok(s, hi_cdf + hictx * 4);
            level_tok = tok + (3 << 6);
        }
        cf[rc] = tok << 11;
        levels[x * stride + y] = (uint8_t)level_tok;

        for (int i = eob - 1; i > 0; i--) {
            unsigned rc_i;
            if (tx_class == TX_CLASS_2D) {
                rc_i = scan[i];
                x = rc_i >> shift;
                y = rc_i & mask;
            } else if (tx_class == TX_CLASS_H) {
                x = i & mask;
                y = i >> shift;
                rc_i = i;
            } else {
                x = i & mask;
                y = i >> shift;
                rc_i = (x << shift2) | y;
            }
            int base = x * stride + y;
            unsigned mag;
            ctx = get_lo_ctx(levels, base, tx_class, ctx_offsets, x, y, stride,
                             &mag);
            if (tx_class == TX_CLASS_2D)
                y |= x;
            tok = msac_decode_symbol_adapt(s, lo_cdf + ctx * 4, 3);
            if (tok == 3) {
                mag &= 63;
                int hictx =
                    ((y > (tx_class == TX_CLASS_2D ? 1 : 0)) ? 14 : 7) +
                    (mag > 12 ? 6 : (mag + 1) >> 1);
                tok = msac_decode_hi_tok(s, hi_cdf + hictx * 4);
                levels[base] = (uint8_t)(tok + (3 << 6));
                cf[rc_i] = (tok << 11) | rc;
                rc = rc_i;
            } else {
                tok *= 0x17FF41;
                levels[base] = (uint8_t)tok;
                tok = (tok >> 9) & (rc + ~0x7FFu);
                if (tok)
                    rc = rc_i;
                cf[rc_i] = tok;
            }
        }

        /* dc token */
        unsigned mag = 0;
        if (tx_class == TX_CLASS_2D) {
            ctx = 0;
        } else {
            ctx = get_lo_ctx(levels, 0, tx_class, ctx_offsets, 0, 0, stride,
                             &mag);
        }
        dc_tok = msac_decode_symbol_adapt(s, lo_cdf + ctx * 4, 3);
        if (dc_tok == 3) {
            if (tx_class == TX_CLASS_2D)
                mag = levels[1] + levels[stride] + levels[stride + 1];
            mag &= 63;
            int hictx = mag > 12 ? 6 : (mag + 1) >> 1;
            dc_tok = msac_decode_hi_tok(s, hi_cdf + hictx * 4);
        }
    } else {
        unsigned tok_br = msac_decode_symbol_adapt(s, eob_cdf, 2);
        dc_tok = 1 + tok_br;
        if (tok_br == 2)
            dc_tok = msac_decode_hi_tok(s, hi_cdf);
        rc = 0;
    }

    /* dequantization (qm applies only to non-identity transforms) */
    const int32_t *qm = txtp < p->idtx_val ? p->qm : NULL;
    int dq_shift = p->dq_shift;
    int32_t cf_max = p->cf_max;
    unsigned cul_level;
    int dc_sign_level;

    if (dc_tok == 0) {
        cul_level = 0;
        dc_sign_level = 1 << 6;
    } else {
        int dc_sign_ctx = get_dc_sign_ctx(p);
        int dc_sign = msac_decode_bool_adapt(
            s, cdf->dc_sign + (chroma * 3 + dc_sign_ctx) * 2);
        unsigned dc_dq = p->dq_dc;
        dc_sign_level = (dc_sign - 1) & (2 << 6);
        if (qm) {
            dc_dq = (dc_dq * (unsigned)qm[0] + 16) >> 5;
            if (dc_tok == 15) {
                dc_tok = (read_golomb(s) + 15) & 0xFFFFF;
                dc_dq = (dc_dq * dc_tok) & 0xFFFFFF;
            } else {
                dc_dq *= dc_tok;
            }
            cul_level = dc_tok;
            dc_dq >>= dq_shift;
            if (dc_dq > (unsigned)(cf_max + dc_sign))
                dc_dq = cf_max + dc_sign;
        } else {
            if (dc_tok == 15) {
                dc_tok = (read_golomb(s) + 15) & 0xFFFFF;
                dc_dq = ((dc_dq * dc_tok) & 0xFFFFFF) >> dq_shift;
                if (dc_dq > (unsigned)(cf_max + dc_sign))
                    dc_dq = cf_max + dc_sign;
            } else {
                dc_dq = (dc_dq * dc_tok) >> dq_shift;
            }
            cul_level = dc_tok;
        }
        cf[0] = dc_sign ? -(int32_t)dc_dq : (int32_t)dc_dq;
    }

    if (rc) {
        unsigned ac_dq = p->dq_ac;
        do {
            int sign = msac_decode_bool_equi(s);
            unsigned rc_tok = (unsigned)cf[rc];
            unsigned tok, dq;
            if (qm) {
                dq = (ac_dq * (unsigned)qm[rc] + 16) >> 5;
                if (rc_tok >= (15u << 11)) {
                    tok = (read_golomb(s) + 15) & 0xFFFFF;
                    dq = (dq * tok) & 0xFFFFFF;
                } else {
                    tok = rc_tok >> 11;
                    dq *= tok;
                }
                cul_level += tok;
                dq >>= dq_shift;
                if (dq > (unsigned)(cf_max + sign))
                    dq = cf_max + sign;
            } else {
                if (rc_tok >= (15u << 11)) {
                    tok = (read_golomb(s) + 15) & 0xFFFFF;
                    dq = ((ac_dq * tok) & 0xFFFFFF) >> dq_shift;
                    if (dq > (unsigned)(cf_max + sign))
                        dq = cf_max + sign;
                } else {
                    tok = rc_tok >> 11;
                    dq = (ac_dq * tok) >> dq_shift;
                }
                cul_level += tok;
            }
            cf[rc] = sign ? -(int32_t)dq : (int32_t)dq;
            rc = rc_tok & 0x3FF;
        } while (rc);
    }

    p->cf_ctx = (cul_level < 63 ? cul_level : 63) | dc_sign_level;
}
