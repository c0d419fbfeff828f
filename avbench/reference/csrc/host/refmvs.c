/* Native MV-predictor scan: rav1d_refmvs_find equivalent.
 *
 * Behavior parity with rav1d src/refmvs.rs:939 (rav1d_refmvs_find), ported
 * from the validated Python anchor (rav1d_tpu/syntax/refmvs.py). Operates
 * directly on the decoder's numpy grids:
 *   r:       packed 12-byte records {int16 mv[2][2]; int8 ref[2]; u8 bs; u8 mf}
 *   rp_proj: packed 5-byte records {int16 mv[2]; int8 ref}
 * Invoked per block via ctypes with a single call-params struct.
 */

#include <stdint.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

#define INVALID_X -32768
#define INVALID_Y -32768

typedef struct Cand {
    int32_t mv[2][2]; /* [which][x,y] */
    int32_t weight;
} Cand;

typedef struct RefMvsCall {
    const uint8_t *r;       /* RB grid base */
    int32_t r_stride;       /* records per row */
    const uint8_t *rp_proj; /* TB grid base */
    int32_t rp_stride;
    const uint8_t *bdims;   /* (N_BS, 4) uint8: w4, h4, ... */
    int32_t pocdiff[7];
    int32_t sign_bias[7];
    int32_t use_ref_frame_mvs; /* rf.use_ref_frame_mvs */
    int32_t iw4, ih4;
    int32_t col_start, col_end, row_start, row_end;
    int32_t bs, bw4, bh4;
    int32_t bx4, by4;
    int32_t ref0, ref1; /* 1-based; ref1 == -1 for single */
    int32_t edge_has_tr;
    int32_t force_integer_mv, hp;
    int32_t use_rfm_hdr; /* frame_hdr.use_ref_frame_mvs */
    int32_t gmv[2][2];   /* [n][x,y]; INVALID when not global-projected */
    int32_t tgmv[2][2];
    /* outputs */
    int16_t out_mv[8][2][2];
    int32_t out_weight[8];
    int32_t out_cnt;
    int32_t out_ctx;
} RefMvsCall;

static const int32_t div_mult[32] = {
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638, 1489,
    1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744, 712, 682,
    655, 630, 606, 585, 564, 546, 528,
};

static inline int32_t iclip(int32_t v, int32_t lo, int32_t hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline int32_t to_i16(int32_t v) {
    return (int32_t)(int16_t)(uint16_t)(v & 0xFFFF);
}

typedef struct CandBlk {
    int32_t mv0[2], mv1[2];
    int32_t ref0, ref1;
    int32_t bs, mf;
} CandBlk;

static inline void load_blk(const RefMvsCall *p, int row, int col, CandBlk *c) {
    const uint8_t *b = p->r + ((size_t)row * p->r_stride + col) * 12;
    const int16_t *mv = (const int16_t *)b;
    c->mv0[0] = mv[0];
    c->mv0[1] = mv[1];
    c->mv1[0] = mv[2];
    c->mv1[1] = mv[3];
    c->ref0 = (int8_t)b[8];
    c->ref1 = (int8_t)b[9];
    c->bs = b[10];
    c->mf = b[11];
}

static inline int bw4_of(const RefMvsCall *p, int bs) { return p->bdims[bs * 4]; }
static inline int bh4_of(const RefMvsCall *p, int bs) { return p->bdims[bs * 4 + 1]; }

static int add_spatial(Cand *stack, int cnt, int weight, const CandBlk *c,
                       const RefMvsCall *p, int *newmv, int *refmv) {
    if (c->mv0[0] == INVALID_X && c->mv0[1] == INVALID_Y)
        return cnt;
    int mf_odd = c->mf & 1;
    if (p->ref1 == -1) {
        for (int n = 0; n < 2; n++) {
            int ref = n == 0 ? c->ref0 : c->ref1;
            if (ref == p->ref0) {
                const int32_t *src = n == 0 ? c->mv0 : c->mv1;
                int32_t cx, cy;
                if (mf_odd && !(p->gmv[0][0] == INVALID_X && p->gmv[0][1] == INVALID_Y)) {
                    cx = p->gmv[0][0];
                    cy = p->gmv[0][1];
                } else {
                    cx = src[0];
                    cy = src[1];
                }
                *refmv = 1;
                *newmv |= c->mf >> 1;
                for (int i = 0; i < cnt; i++) {
                    if (stack[i].mv[0][0] == cx && stack[i].mv[0][1] == cy) {
                        stack[i].weight += weight;
                        return cnt;
                    }
                }
                if (cnt < 8) {
                    stack[cnt].mv[0][0] = cx;
                    stack[cnt].mv[0][1] = cy;
                    stack[cnt].weight = weight;
                    cnt++;
                }
                return cnt;
            }
        }
    } else if (c->ref0 == p->ref0 && c->ref1 == p->ref1) {
        int32_t c0x, c0y, c1x, c1y;
        if (mf_odd && !(p->gmv[0][0] == INVALID_X && p->gmv[0][1] == INVALID_Y)) {
            c0x = p->gmv[0][0];
            c0y = p->gmv[0][1];
        } else {
            c0x = c->mv0[0];
            c0y = c->mv0[1];
        }
        if (mf_odd && !(p->gmv[1][0] == INVALID_X && p->gmv[1][1] == INVALID_Y)) {
            c1x = p->gmv[1][0];
            c1y = p->gmv[1][1];
        } else {
            c1x = c->mv1[0];
            c1y = c->mv1[1];
        }
        *refmv = 1;
        *newmv |= c->mf >> 1;
        for (int i = 0; i < cnt; i++) {
            if (stack[i].mv[0][0] == c0x && stack[i].mv[0][1] == c0y &&
                stack[i].mv[1][0] == c1x && stack[i].mv[1][1] == c1y) {
                stack[i].weight += weight;
                return cnt;
            }
        }
        if (cnt < 8) {
            stack[cnt].mv[0][0] = c0x;
            stack[cnt].mv[0][1] = c0y;
            stack[cnt].mv[1][0] = c1x;
            stack[cnt].mv[1][1] = c1y;
            stack[cnt].weight = weight;
            cnt++;
        }
    }
    return cnt;
}

static int scan_row(Cand *stack, int *cnt, const RefMvsCall *p, int row,
                    int bx4, int bw4, int w4, int max_rows, int step,
                    int *newmv, int *refmv) {
    CandBlk c;
    load_blk(p, row, bx4, &c);
    int cand_bw4 = bw4_of(p, c.bs);
    int length = step > (bw4 < cand_bw4 ? bw4 : cand_bw4) ? step
                 : (bw4 < cand_bw4 ? bw4 : cand_bw4);
    if (bw4 <= cand_bw4) {
        int weight;
        if (bw4 == 1)
            weight = 2;
        else {
            int h = bh4_of(p, c.bs);
            int m = 2 * max_rows < h ? 2 * max_rows : h;
            weight = m > 2 ? m : 2;
        }
        *cnt = add_spatial(stack, *cnt, length * weight, &c, p, newmv, refmv);
        return weight >> 1;
    }
    int x = 0;
    for (;;) {
        *cnt = add_spatial(stack, *cnt, length * 2, &c, p, newmv, refmv);
        x += length;
        if (x >= w4)
            return 1;
        load_blk(p, row, bx4 + x, &c);
        cand_bw4 = bw4_of(p, c.bs);
        length = step > cand_bw4 ? step : cand_bw4;
    }
}

static int scan_col(Cand *stack, int *cnt, const RefMvsCall *p, int row0,
                    int col, int bh4, int h4, int max_cols, int step,
                    int *newmv, int *refmv) {
    CandBlk c;
    load_blk(p, row0, col, &c);
    int cand_bh4 = bh4_of(p, c.bs);
    int length = step > (bh4 < cand_bh4 ? bh4 : cand_bh4) ? step
                 : (bh4 < cand_bh4 ? bh4 : cand_bh4);
    if (bh4 <= cand_bh4) {
        int weight;
        if (bh4 == 1)
            weight = 2;
        else {
            int w = bw4_of(p, c.bs);
            int m = 2 * max_cols < w ? 2 * max_cols : w;
            weight = m > 2 ? m : 2;
        }
        *cnt = add_spatial(stack, *cnt, length * weight, &c, p, newmv, refmv);
        return weight >> 1;
    }
    int y = 0;
    for (;;) {
        *cnt = add_spatial(stack, *cnt, length * 2, &c, p, newmv, refmv);
        y += length;
        if (y >= h4)
            return 1;
        load_blk(p, row0 + y, col, &c);
        cand_bh4 = bh4_of(p, c.bs);
        length = step > cand_bh4 ? step : cand_bh4;
    }
}

static void mv_project(int32_t mvx, int32_t mvy, int num, int den,
                       int32_t *ox, int32_t *oy) {
    int64_t frac = (int64_t)num * div_mult[den];
    int64_t x = mvx * frac;
    int64_t y = mvy * frac;
    int32_t mx = (1 << 14) - 1;
    *ox = iclip((int32_t)((x + 8192 + (x >> 63)) >> 14), -mx, mx);
    *oy = iclip((int32_t)((y + 8192 + (y >> 63)) >> 14), -mx, mx);
}

static void fix_precision(const RefMvsCall *p, int32_t *x, int32_t *y) {
    if (p->force_integer_mv) {
        *x = to_i16((*x - (*x >> 15) + 3) & ~7);
        *y = to_i16((*y - (*y >> 15) + 3) & ~7);
    } else if (!p->hp) {
        *x = to_i16((*x - (*x >> 15)) & ~1);
        *y = to_i16((*y - (*y >> 15)) & ~1);
    }
}

/* returns globalmv ctx (-1 = unchanged) */
static int add_temporal(Cand *stack, int *cnt, const RefMvsCall *p,
                        int row8, int col8, int use_gmv) {
    const uint8_t *b = p->rp_proj + ((size_t)row8 * p->rp_stride + col8) * 5;
    const int16_t *mv = (const int16_t *)b;
    int32_t tmvx = mv[0], tmvy = mv[1];
    int gctx = -1;
    if (tmvx == INVALID_X && tmvy == INVALID_Y)
        return gctx;
    int tref = (int8_t)b[4];
    int32_t mx, my;
    mv_project(tmvx, tmvy, p->pocdiff[p->ref0 - 1], tref, &mx, &my);
    fix_precision(p, &mx, &my);
    if (p->ref1 == -1) {
        if (use_gmv) {
            int32_t dx = mx - p->tgmv[0][0];
            int32_t dy = my - p->tgmv[0][1];
            if (dx < 0) dx = -dx;
            if (dy < 0) dy = -dy;
            gctx = (dx | dy) >= 16 ? 1 : 0;
        }
        for (int i = 0; i < *cnt; i++) {
            if (stack[i].mv[0][0] == mx && stack[i].mv[0][1] == my) {
                stack[i].weight += 2;
                return gctx;
            }
        }
        if (*cnt < 8) {
            stack[*cnt].mv[0][0] = mx;
            stack[*cnt].mv[0][1] = my;
            stack[*cnt].weight = 2;
            (*cnt)++;
        }
    } else {
        int32_t mx1, my1;
        mv_project(tmvx, tmvy, p->pocdiff[p->ref1 - 1], tref, &mx1, &my1);
        fix_precision(p, &mx1, &my1);
        for (int i = 0; i < *cnt; i++) {
            if (stack[i].mv[0][0] == mx && stack[i].mv[0][1] == my &&
                stack[i].mv[1][0] == mx1 && stack[i].mv[1][1] == my1) {
                stack[i].weight += 2;
                return gctx;
            }
        }
        if (*cnt < 8) {
            stack[*cnt].mv[0][0] = mx;
            stack[*cnt].mv[0][1] = my;
            stack[*cnt].mv[1][0] = mx1;
            stack[*cnt].mv[1][1] = my1;
            stack[*cnt].weight = 2;
            (*cnt)++;
        }
    }
    return gctx;
}

static void add_compound_ext(Cand same[4], int same_count[4], const CandBlk *c,
                             int sign0, int sign1, const RefMvsCall *p) {
    for (int n = 0; n < 2; n++) {
        int cand_ref = n == 0 ? c->ref0 : c->ref1;
        if (cand_ref <= 0)
            break;
        int sb = p->sign_bias[cand_ref - 1];
        const int32_t *cm = n == 0 ? c->mv0 : c->mv1;
        if (cand_ref == p->ref0) {
            if (same_count[0] < 2) {
                same[same_count[0]].mv[0][0] = cm[0];
                same[same_count[0]].mv[0][1] = cm[1];
                same_count[0]++;
            }
            if (same_count[3] < 2) {
                int neg = sign1 ^ sb;
                same[2 + same_count[3]].mv[1][0] = neg ? to_i16(-cm[0]) : cm[0];
                same[2 + same_count[3]].mv[1][1] = neg ? to_i16(-cm[1]) : cm[1];
                same_count[3]++;
            }
        } else if (cand_ref == p->ref1) {
            if (same_count[1] < 2) {
                same[same_count[1]].mv[1][0] = cm[0];
                same[same_count[1]].mv[1][1] = cm[1];
                same_count[1]++;
            }
            if (same_count[2] < 2) {
                int neg = sign0 ^ sb;
                same[2 + same_count[2]].mv[0][0] = neg ? to_i16(-cm[0]) : cm[0];
                same[2 + same_count[2]].mv[0][1] = neg ? to_i16(-cm[1]) : cm[1];
                same_count[2]++;
            }
        } else {
            if (same_count[2] < 2) {
                int neg = sign0 ^ sb;
                same[2 + same_count[2]].mv[0][0] = neg ? to_i16(-cm[0]) : cm[0];
                same[2 + same_count[2]].mv[0][1] = neg ? to_i16(-cm[1]) : cm[1];
                same_count[2]++;
            }
            if (same_count[3] < 2) {
                int neg = sign1 ^ sb;
                same[2 + same_count[3]].mv[1][0] = neg ? to_i16(-cm[0]) : cm[0];
                same[2 + same_count[3]].mv[1][1] = neg ? to_i16(-cm[1]) : cm[1];
                same_count[3]++;
            }
        }
    }
}

static int add_single_ext(Cand *stack, int cnt, const CandBlk *c, int sign,
                          const RefMvsCall *p) {
    for (int n = 0; n < 2; n++) {
        int cand_ref = n == 0 ? c->ref0 : c->ref1;
        if (cand_ref <= 0)
            break;
        const int32_t *cm = n == 0 ? c->mv0 : c->mv1;
        int32_t cx = cm[0], cy = cm[1];
        if (sign ^ p->sign_bias[cand_ref - 1]) {
            cx = to_i16(-cx);
            cy = to_i16(-cy);
        }
        int dup = 0;
        for (int i = 0; i < cnt; i++) {
            if (stack[i].mv[0][0] == cx && stack[i].mv[0][1] == cy) {
                dup = 1;
                break;
            }
        }
        if (!dup) {
            stack[cnt].mv[0][0] = cx;
            stack[cnt].mv[0][1] = cy;
            stack[cnt].weight = 2;
            cnt++;
        }
    }
    return cnt;
}

/* stable insertion sort descending by weight */
static void sort_desc(Cand *a, int n) {
    for (int i = 1; i < n; i++) {
        Cand key = a[i];
        int j = i - 1;
        while (j >= 0 && a[j].weight < key.weight) {
            a[j + 1] = a[j];
            j--;
        }
        a[j + 1] = key;
    }
}

EXPORT void dav1d_refmvs_find(RefMvsCall *p) {
    int bw4 = p->bw4, bh4 = p->bh4;
    int bx4 = p->bx4, by4 = p->by4;
    int w4 = bw4 < 16 ? bw4 : 16;
    if (w4 > p->col_end - bx4) w4 = p->col_end - bx4;
    int h4 = bh4 < 16 ? bh4 : 16;
    if (h4 > p->row_end - by4) h4 = p->row_end - by4;

    Cand stack[12];
    memset(stack, 0, sizeof(stack));
    int cnt = 0;
    int newmv = 0, row_mvs = 0, col_mvs = 0;
    int n_rows = -1, n_cols = -1, max_rows = 0, max_cols = 0;

    if (by4 > p->row_start) {
        int mr = (by4 - p->row_start + 1) >> 1;
        int cap = 2 + (bh4 > 1 ? 1 : 0);
        max_rows = mr < cap ? mr : cap;
        n_rows = scan_row(stack, &cnt, p, by4 - 1, bx4, bw4, w4, max_rows,
                          bw4 >= 16 ? 4 : 1, &newmv, &row_mvs);
    }
    if (bx4 > p->col_start) {
        int mcs = (bx4 - p->col_start + 1) >> 1;
        int cap = 2 + (bw4 > 1 ? 1 : 0);
        max_cols = mcs < cap ? mcs : cap;
        n_cols = scan_col(stack, &cnt, p, by4, bx4 - 1, bh4, h4, max_cols,
                          bh4 >= 16 ? 4 : 1, &newmv, &col_mvs);
    }

    if (n_rows != -1 && p->edge_has_tr && (bw4 > bh4 ? bw4 : bh4) <= 16 &&
        bw4 + bx4 < p->col_end) {
        CandBlk c;
        load_blk(p, by4 - 1, bx4 + bw4, &c);
        cnt = add_spatial(stack, cnt, 4, &c, p, &newmv, &row_mvs);
    }

    int nearest_match = col_mvs + row_mvs;
    int nearest_cnt = cnt;
    for (int i = 0; i < nearest_cnt; i++)
        stack[i].weight += 640;

    int globalmv_ctx = p->use_rfm_hdr;
    if (p->use_ref_frame_mvs) {
        int by8 = by4 >> 1, bx8 = bx4 >> 1;
        int step_h = bw4 >= 16 ? 2 : 1;
        int step_v = bh4 >= 16 ? 2 : 1;
        int w8 = (w4 + 1) >> 1;
        if (w8 > 8) w8 = 8;
        int h8 = (h4 + 1) >> 1;
        if (h8 > 8) h8 = 8;
        for (int y = 0; y < h8; y += step_v)
            for (int x = 0; x < w8; x += step_h) {
                int g = add_temporal(stack, &cnt, p, by8 + y, bx8 + x,
                                     (x | y) == 0);
                if (g >= 0)
                    globalmv_ctx = g;
            }
        int mn = bw4 < bh4 ? bw4 : bh4;
        int mx_ = bw4 > bh4 ? bw4 : bh4;
        if (mn >= 2 && mx_ < 16) {
            int bh8 = bh4 >> 1, bw8 = bw4 >> 1;
            int yb = by8 + bh8;
            int row_lim = p->row_end >> 1;
            if (row_lim > (by8 & ~7) + 8) row_lim = (by8 & ~7) + 8;
            int has_bottom = yb < row_lim;
            int col_lo = p->col_start >> 1;
            if (col_lo < (bx8 & ~7)) col_lo = bx8 & ~7;
            if (has_bottom && bx8 - 1 >= col_lo)
                add_temporal(stack, &cnt, p, yb, bx8 - 1, 0);
            int col_hi = p->col_end >> 1;
            if (col_hi > (bx8 & ~7) + 8) col_hi = (bx8 & ~7) + 8;
            if (bx8 + bw8 < col_hi) {
                if (has_bottom)
                    add_temporal(stack, &cnt, p, yb, bx8 + bw8, 0);
                if (by8 + bh8 - 1 < row_lim)
                    add_temporal(stack, &cnt, p, yb - 1, bx8 + bw8, 0);
            }
        }
    }

    int dummy_newmv = 0;
    if (n_rows != -1 && n_cols != -1) {
        CandBlk c;
        load_blk(p, by4 - 1, bx4 - 1, &c);
        cnt = add_spatial(stack, cnt, 4, &c, p, &dummy_newmv, &row_mvs);
    }

    int sb_base = by4 - (by4 & 31);
    for (int n = 2; n <= 3; n++) {
        if (n_rows != -1 && n > n_rows && n <= max_rows) {
            int row = sb_base + ((((by4 & 31) - 2 * n + 1)) | 1);
            n_rows += scan_row(stack, &cnt, p, row, bx4 | 1, bw4, w4,
                               1 + max_rows - n, bw4 >= 16 ? 4 : 2,
                               &dummy_newmv, &row_mvs);
        }
        if (n_cols != -1 && n > n_cols && n <= max_cols) {
            n_cols += scan_col(stack, &cnt, p, by4 | 1, (bx4 - n * 2 + 1) | 1,
                               bh4, h4, 1 + max_cols - n, bh4 >= 16 ? 4 : 2,
                               &dummy_newmv, &col_mvs);
        }
    }

    int ref_match_count = col_mvs + row_mvs;
    int have_newmv = newmv;
    int refmv_ctx, newmv_ctx;
    if (nearest_match == 0) {
        refmv_ctx = ref_match_count < 2 ? ref_match_count : 2;
        newmv_ctx = ref_match_count > 0 ? 1 : 0;
    } else if (nearest_match == 1) {
        refmv_ctx = ref_match_count * 3 < 4 ? ref_match_count * 3 : 4;
        newmv_ctx = 3 - have_newmv;
    } else if (nearest_match == 2) {
        refmv_ctx = 5;
        newmv_ctx = 5 - have_newmv;
    } else {
        refmv_ctx = 0;
        newmv_ctx = 0;
    }

    sort_desc(stack, nearest_cnt);
    sort_desc(stack + nearest_cnt, cnt - nearest_cnt);

    if (p->ref1 > 0) {
        if (cnt < 2) {
            int sign0 = p->sign_bias[p->ref0 - 1];
            int sign1 = p->sign_bias[p->ref1 - 1];
            int sz4 = w4 < h4 ? w4 : h4;
            Cand same[4];
            memset(same, 0, sizeof(same));
            int same_count[4] = {0, 0, 0, 0};
            if (n_rows != -1) {
                int x = 0;
                while (x < sz4) {
                    CandBlk c;
                    load_blk(p, by4 - 1, bx4 + x, &c);
                    add_compound_ext(same, same_count, &c, sign0, sign1, p);
                    x += bw4_of(p, c.bs);
                }
            }
            if (n_cols != -1) {
                int y = 0;
                while (y < sz4) {
                    CandBlk c;
                    load_blk(p, by4 + y, bx4 - 1, &c);
                    add_compound_ext(same, same_count, &c, sign0, sign1, p);
                    y += bh4_of(p, c.bs);
                }
            }
            for (int n = 0; n < 2; n++) {
                int m = same_count[n];
                if (m >= 2)
                    continue;
                int l = same_count[2 + n];
                if (l) {
                    same[m].mv[n][0] = same[2].mv[n][0];
                    same[m].mv[n][1] = same[2].mv[n][1];
                    m++;
                    if (m == 2)
                        continue;
                    if (l == 2) {
                        same[1].mv[n][0] = same[3].mv[n][0];
                        same[1].mv[n][1] = same[3].mv[n][1];
                        continue;
                    }
                }
                for (int i = m; i < 2; i++) {
                    same[i].mv[n][0] = p->tgmv[n][0];
                    same[i].mv[n][1] = p->tgmv[n][1];
                }
            }
            if (cnt == 1 && stack[0].mv[0][0] == same[0].mv[0][0] &&
                stack[0].mv[0][1] == same[0].mv[0][1] &&
                stack[0].mv[1][0] == same[0].mv[1][0] &&
                stack[0].mv[1][1] == same[0].mv[1][1]) {
                stack[1].mv[0][0] = same[1].mv[0][0];
                stack[1].mv[0][1] = same[1].mv[0][1];
                stack[1].mv[1][0] = same[1].mv[1][0];
                stack[1].mv[1][1] = same[1].mv[1][1];
            } else {
                /* stack slots cnt..2 already carry `same` values via the
                 * Python aliasing: mvstack[cnt:cnt+4] IS `same` there. */
                for (int i = cnt; i < 2; i++) {
                    stack[i].mv[0][0] = same[i - cnt].mv[0][0];
                    stack[i].mv[0][1] = same[i - cnt].mv[0][1];
                    stack[i].mv[1][0] = same[i - cnt].mv[1][0];
                    stack[i].mv[1][1] = same[i - cnt].mv[1][1];
                }
            }
            for (int i = cnt; i < 2; i++)
                stack[i].weight = 2;
            cnt = 2;
        }
        int32_t left = -(bx4 + bw4 + 4) * 4 * 8;
        int32_t right = (p->iw4 - bx4 + 4) * 4 * 8;
        int32_t top = -(by4 + bh4 + 4) * 4 * 8;
        int32_t bottom = (p->ih4 - by4 + 4) * 4 * 8;
        for (int i = 0; i < cnt; i++) {
            stack[i].mv[0][0] = iclip(stack[i].mv[0][0], left, right);
            stack[i].mv[0][1] = iclip(stack[i].mv[0][1], top, bottom);
            stack[i].mv[1][0] = iclip(stack[i].mv[1][0], left, right);
            stack[i].mv[1][1] = iclip(stack[i].mv[1][1], top, bottom);
        }
        int rc = refmv_ctx >> 1;
        int ctx;
        if (rc == 0)
            ctx = newmv_ctx < 1 ? newmv_ctx : 1;
        else if (rc == 1)
            ctx = 1 + (newmv_ctx < 3 ? newmv_ctx : 3);
        else
            ctx = iclip(3 + newmv_ctx, 4, 7);
        p->out_ctx = ctx;
        goto done;
    } else if (cnt < 2 && p->ref0 > 0) {
        int sign = p->sign_bias[p->ref0 - 1];
        int sz4 = w4 < h4 ? w4 : h4;
        if (n_rows != -1) {
            int x = 0;
            while (x < sz4 && cnt < 2) {
                CandBlk c;
                load_blk(p, by4 - 1, bx4 + x, &c);
                cnt = add_single_ext(stack, cnt, &c, sign, p);
                x += bw4_of(p, c.bs);
            }
        }
        if (n_cols != -1) {
            int y = 0;
            while (y < sz4 && cnt < 2) {
                CandBlk c;
                load_blk(p, by4 + y, bx4 - 1, &c);
                cnt = add_single_ext(stack, cnt, &c, sign, p);
                y += bh4_of(p, c.bs);
            }
        }
    }

    if (cnt) {
        int32_t left = -(bx4 + bw4 + 4) * 4 * 8;
        int32_t right = (p->iw4 - bx4 + 4) * 4 * 8;
        int32_t top = -(by4 + bh4 + 4) * 4 * 8;
        int32_t bottom = (p->ih4 - by4 + 4) * 4 * 8;
        for (int i = 0; i < cnt; i++) {
            stack[i].mv[0][0] = iclip(stack[i].mv[0][0], left, right);
            stack[i].mv[0][1] = iclip(stack[i].mv[0][1], top, bottom);
        }
    }
    for (int i = cnt < 2 ? cnt : 2; i < 2; i++) {
        stack[i].mv[0][0] = p->tgmv[0][0];
        stack[i].mv[0][1] = p->tgmv[0][1];
    }
    p->out_ctx = (refmv_ctx << 4) | (globalmv_ctx << 3) | newmv_ctx;

done:
    p->out_cnt = cnt;
    for (int i = 0; i < 8; i++) {
        p->out_weight[i] = stack[i].weight;
        for (int n = 0; n < 2; n++) {
            p->out_mv[i][n][0] = (int16_t)stack[i].mv[n][0];
            p->out_mv[i][n][1] = (int16_t)stack[i].mv[n][1];
        }
    }
}
