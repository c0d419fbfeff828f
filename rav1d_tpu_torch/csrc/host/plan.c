/* Key-frame planner: from the syntax pass's block records to the wave
 * descriptor rows of the frame blob.
 *
 * The native twin of engine/plan.py's intra planner and of the wave half of
 * engine/pack.py, for key and intra-only frames: one walk over the block
 * records (syntax.c BlockRec) in decode order that does what
 *   _plan_b_intra / _plan_chroma  (the 16x16 sub-block walk, palette,
 *                                  CfL, filter intra, the store cursor),
 *   plan_edges                    (mode remap + parametric edge descriptor),
 *   _emit                         (read extents),
 *   _assign_waves                 (last-writer grid, per-class capacity)
 * do, and writes each item straight into its (wave, slot) row of the two
 * class arrays that engine/pack.py _pack_class writes from the Python plan,
 * plus the palette scatter of _pack_palette. No per-item object exists.
 *
 * Two calls: rav1d_plan_frame walks the records (items kept in an internal
 * buffer) and reports the sizes; the caller allocates the outputs and
 * rav1d_plan_write fills them; rav1d_plan_free releases the buffer. No
 * state is shared between calls on different frames (no statics).
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* the per-block record (syntax.c BlockRec, 128 bytes) */
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
    int16_t mv[2][2];
    int16_t wm_alpha, wm_beta, wm_gamma, wm_delta;
    int16_t sm_fl, sm_uv_fl;
    uint16_t tx_split1;
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

/* intra modes (syntax/levels.py), coding and implementation */
enum {
    DC_PRED = 0, VERT_PRED = 1, HOR_PRED = 2, VERT_LEFT_PRED = 8,
    PAETH_PRED = 12, CFL_PRED = 13,
    LEFT_DC_PRED = 3, TOP_DC_PRED = 4, DC_128_PRED = 5,
    Z1_PRED = 6, Z2_PRED = 7, Z3_PRED = 8, FILTER_PRED = 13,
};
/* engine-only mode codes (engine/plan.py) */
enum {
    MODE_IDENT = 14, MODE_CFL_DC = 15, MODE_CFL_TOP = 16, MODE_CFL_LEFT = 17,
    MODE_CFL_128 = 18,
};
/* edge flags (syntax/intra_edge.py) */
enum {
    I444_TOP_HAS_RIGHT = 1, I420_TOP_HAS_RIGHT = 4,
    I444_LEFT_HAS_BOTTOM = 8, I420_LEFT_HAS_BOTTOM = 32,
};
/* wflags bits and wave descriptor fields (engine/layout.py) */
enum { F_Z = 1, F_FILTER = 2, F_CFL = 4, F_IDENT = 8 };
enum {
    FD_MODES, FD_ANGLES, FD_FLAT0, FD_RMASK, FD_Z2MW, FD_Z2MH, FD_Z2SM,
    FD_CFLA, FD_CFL0, FD_CFLWP, FD_CFLHP, FD_W, FD_H, FD_IIOFF,
    FD_WFLAGS, FD_WCOUNT, FD_HAV, FD_PHL, FD_PHBL, FD_PHT, FD_PHTR,
    N_FIELDS,
};
enum { I400 = 0, I420 = 1, I422 = 2, I444 = 3 };

/* status */
enum { PLAN_OK = 0, PLAN_GATE = 1, PLAN_BAD_INPUT = 2, PLAN_NO_MEMORY = 3 };

/* block and transform sizes in 4-pixel units (tables/block_tables.py) */
static const uint8_t BLK_W4[22] = {32, 32, 16, 16, 16, 16, 8, 8, 8, 8, 4,
                                   4,  4,  4,  4,  2,  2,  2, 2, 1, 1, 1};
static const uint8_t BLK_H4[22] = {32, 16, 32, 16, 8, 4, 16, 8, 4, 2, 16,
                                   8,  4,  2,  1,  8, 4, 2,  1, 4, 2, 1};
static const uint8_t TX_W4[19] = {1, 2, 4, 8, 16, 1, 2, 2, 4, 4,
                                  8, 8, 16, 1, 4, 2, 8, 4, 16};
static const uint8_t TX_H4[19] = {1, 2, 4, 8, 16, 2, 1, 4, 2, 8,
                                  4, 16, 8, 4, 1, 8, 2, 16, 4};
static const int16_t MODE_TO_ANGLE[8] = {90, 180, 45, 135, 113, 157, 203, 67};

typedef struct PlanArgs {
    const BlockRec *rec;
    const int32_t *ranges;  /* n_ranges x (tile index, lo, hi) */
    const int32_t *tiles;   /* n_tiles x (col_start, col_end, row_start,
                               row_end), 4-pixel units */
    const uint16_t *pal;    /* palette arena: 3 x 8 entries a block */
    const uint8_t *palidx;  /* palette index arena */
    const int32_t *eob;     /* coefficient store eob per transform block */
    int64_t n_rec, n_pal, n_palidx, n_eob;
    int32_t n_ranges, n_tiles;
    int32_t bw, bh;         /* frame in 4-pixel units */
    int32_t ah, aw;         /* luma plane rows and columns */
    int32_t layout, intra_edge_filter;
    int32_t cap0, cap1;     /* wave slots per class */
} PlanArgs;

typedef struct PlanOut {
    int32_t status;
    int32_t n_items;
    int32_t n_waves;
    int32_t pad;
    int64_t n_pal;          /* palette scatter entries */
    void *state;
} PlanOut;

typedef struct Item {
    int32_t row[N_FIELDS];
    int32_t wave, slot, cls;
} Item;

typedef struct State {
    Item *items;
    int64_t n_items, items_cap;
    int32_t *pal_idx, *pal_val;
    int64_t n_pal, pal_cap;
    int32_t *cnt[2], *flags[2];  /* per class, per wave (1-based) */
    int64_t waves_cap;
    int32_t max_wave;
} State;

typedef struct Ctx {
    const PlanArgs *a;
    State *s;
    int32_t *grid;              /* 3 x gh x gw last-writer waves */
    int32_t gh, gw;
    int64_t psz;
    int32_t ss_hor, ss_ver;
    int32_t cur;                /* store cursor */
    int32_t err;
} Ctx;

/* one planned item before its wave is known (engine/plan.py _Item) */
typedef struct It {
    int32_t pl, x, y, w, h, mode, angle, tx;
    int32_t hav, phl, phbl, pht, phtr;
    int32_t z2_mw, z2_mh, z2_sm;
    int32_t cfl_alpha, cfl_ly, cfl_lx, cfl_wpad, cfl_hpad;
    int32_t rd_top_x1, rd_left_y1;
} It;

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }

static int grow(void **p, int64_t *cap, int64_t need, size_t elem) {
    if (need <= *cap)
        return 0;
    int64_t n = *cap ? *cap : 1024;
    while (n < need)
        n *= 2;
    void *q = realloc(*p, (size_t)n * elem);
    if (!q)
        return -1;
    *p = q;
    *cap = n;
    return 0;
}

static int grow_waves(State *s, int64_t need) {
    if (need <= s->waves_cap)
        return 0;
    int64_t n = s->waves_cap ? s->waves_cap : 1024;
    while (n < need)
        n *= 2;
    for (int c = 0; c < 2; c++) {
        int32_t *a = realloc(s->cnt[c], (size_t)n * sizeof(int32_t));
        if (!a)
            return -1;
        s->cnt[c] = a;
        int32_t *b = realloc(s->flags[c], (size_t)n * sizeof(int32_t));
        if (!b)
            return -1;
        s->flags[c] = b;
        memset(a + s->waves_cap, 0, (size_t)(n - s->waves_cap) * 4);
        memset(b + s->waves_cap, 0, (size_t)(n - s->waves_cap) * 4);
    }
    s->waves_cap = n;
    return 0;
}

static int grow_pal(State *s, int64_t need) {
    if (need <= s->pal_cap)
        return 0;
    int64_t n = s->pal_cap ? s->pal_cap : 4096;
    while (n < need)
        n *= 2;
    int32_t *i = realloc(s->pal_idx, (size_t)n * sizeof(int32_t));
    if (!i)
        return -1;
    s->pal_idx = i;
    int32_t *v = realloc(s->pal_val, (size_t)n * sizeof(int32_t));
    if (!v)
        return -1;
    s->pal_val = v;
    s->pal_cap = n;
    return 0;
}

/* plan_edges: refined (mode, angle), smooth top-left and the parametric
 * edge descriptor (hav, phl, phbl, pht, phtr) */
static void plan_edges(int x, int have_left, int y, int have_top, int w,
                       int h, int edge_flags, int mode, int angle, int tw,
                       int th, int filter_edge, It *it) {
    if (mode >= VERT_PRED && mode <= VERT_LEFT_PRED) {
        angle = MODE_TO_ANGLE[mode - VERT_PRED] + 3 * angle;
        if (angle <= 90)
            mode = angle < 90 && have_top ? Z1_PRED : VERT_PRED;
        else if (angle < 180)
            mode = Z2_PRED;
        else
            mode = angle > 180 && have_left ? Z3_PRED : HOR_PRED;
    } else if (mode == DC_PRED) {
        mode = have_left ? (have_top ? DC_PRED : LEFT_DC_PRED)
                         : (have_top ? TOP_DC_PRED : DC_128_PRED);
    } else if (mode == PAETH_PRED) {
        mode = have_left ? (have_top ? PAETH_PRED : HOR_PRED)
                         : (have_top ? VERT_PRED : DC_128_PRED);
    }
    int szl = 4 * th, szt = 4 * tw;
    it->phl = have_left ? imin(szl, (h - y) << 2) : 0;
    int have_bl = have_left && y + th < h &&
                  (edge_flags & I444_LEFT_HAS_BOTTOM);
    it->phbl = have_bl ? imin(szl, (h - y - th) << 2) : 0;
    it->pht = have_top ? imin(szt, (w - x) << 2) : 0;
    int have_tr = have_top && x + tw < w && (edge_flags & I444_TOP_HAS_RIGHT);
    it->phtr = have_tr ? imin(szt, (w - x - tw) << 2) : 0;
    it->z2_sm = mode == Z2_PRED && tw + th >= 6 && filter_edge;
    it->hav = (have_left ? 1 : 0) | (have_top ? 2 : 0);
    it->mode = mode;
    it->angle = angle;
}

static void it_init(It *it, int pl, int px, int py, int w_px, int h_px,
                    int tx) {
    memset(it, 0, sizeof(*it));
    it->pl = pl;
    it->x = px;
    it->y = py;
    it->w = w_px;
    it->h = h_px;
    it->tx = tx;
    it->rd_top_x1 = -1;
    it->rd_left_y1 = -1;
}

/* _emit's read extents */
static void it_reads(It *it, int have_top, int have_left) {
    if (have_top)
        it->rd_top_x1 = ((it->x + 2 * it->w) >> 2) + 1;
    if (have_left)
        it->rd_left_y1 = ((it->y + 2 * it->h) >> 2) + 1;
}

static int32_t region_max(const int32_t *g, int gw, int y0, int y1, int x0,
                          int x1, int32_t m) {
    for (int y = y0; y < y1; y++) {
        const int32_t *r = g + (size_t)y * gw;
        for (int x = x0; x < x1; x++)
            if (r[x] > m)
                m = r[x];
    }
    return m;
}

/* _assign_waves for one item, in item order, then the item's row */
static void place(Ctx *c, const It *it) {
    if (c->err)
        return;
    State *s = c->s;
    const int gh = c->gh, gw = c->gw;
    if (it->pl < 0 || it->pl > 2 || it->x < 0 || it->y < 0 ||
        (it->y >> 2) >= gh || (it->x >> 2) >= gw) {
        c->err = PLAN_BAD_INPUT;
        return;
    }
    int32_t *g = c->grid + (size_t)it->pl * gh * gw;
    int cy = it->y >> 2, cx = it->x >> 2;
    int ch = (it->h + 3) >> 2, cw = (it->w + 3) >> 2;
    int32_t w = 0;
    if (it->rd_top_x1 >= 0 && cy > 0)
        w = region_max(g, gw, cy - 1, cy, imax(cx - 1, 0),
                       imin(it->rd_top_x1, gw), w);
    if (it->rd_left_y1 >= 0 && cx > 0)
        w = region_max(g, gw, imax(cy - 1, 0), imin(it->rd_left_y1, gh),
                       cx - 1, cx, w);
    if (it->mode >= MODE_CFL_DC) {
        int ly = it->cfl_ly >> 2, lx = it->cfl_lx >> 2;
        int lh = (it->h << (c->a->layout == I420 ? 1 : 0)) >> 2;
        int lw = (it->w << (c->a->layout != I444 ? 1 : 0)) >> 2;
        w = region_max(c->grid, gw, ly, imin(ly + imax(lh, 1), gh), lx,
                       imin(lx + imax(lw, 1), gw), w);
    }
    if (it->mode == MODE_IDENT)
        w = region_max(g, gw, cy, imin(cy + ch, gh), cx, imin(cx + cw, gw),
                       w);
    const int cls = it->w <= 16 && it->h <= 16 ? 0 : 1;
    const int32_t cap = cls ? c->a->cap1 : c->a->cap0;
    w += 1;
    for (;;) {
        if (grow_waves(s, (int64_t)w + 2)) {
            c->err = PLAN_NO_MEMORY;
            return;
        }
        if (s->cnt[cls][w] < cap)
            break;
        w++;
    }
    if (grow((void **)&s->items, &s->items_cap, s->n_items + 1,
             sizeof(Item))) {
        c->err = PLAN_NO_MEMORY;
        return;
    }
    Item *o = &s->items[s->n_items++];
    o->wave = w;
    o->slot = s->cnt[cls][w]++;
    o->cls = cls;
    for (int y = cy; y < imin(cy + ch, gh); y++)
        for (int x = cx; x < imin(cx + cw, gw); x++)
            g[(size_t)y * gw + x] = w;
    if (w > s->max_wave)
        s->max_wave = w;

    int32_t *r = o->row;
    memset(r, 0, sizeof(o->row));
    const int aw = c->a->aw;
    r[FD_MODES] = it->mode;
    r[FD_ANGLES] = it->angle;
    r[FD_FLAT0] = (int32_t)(it->pl * c->psz + (int64_t)it->y * aw + it->x);
    r[FD_RMASK] = it->tx >= 0;
    r[FD_Z2MW] = it->z2_mw;
    r[FD_Z2MH] = it->z2_mh;
    r[FD_Z2SM] = it->z2_sm;
    r[FD_W] = it->w;
    r[FD_H] = it->h;
    r[FD_IIOFF] = -1;
    r[FD_HAV] = it->hav;
    r[FD_PHL] = it->phl;
    r[FD_PHBL] = it->phbl;
    r[FD_PHT] = it->pht;
    r[FD_PHTR] = it->phtr;
    int32_t fl = 0;
    if (it->mode == Z1_PRED || it->mode == Z2_PRED || it->mode == Z3_PRED)
        fl |= F_Z;
    else if (it->mode == FILTER_PRED)
        fl |= F_FILTER;
    else if (it->mode == MODE_IDENT)
        fl |= F_IDENT;
    if (it->mode >= MODE_CFL_DC) {
        fl |= F_CFL;
        r[FD_CFLA] = it->cfl_alpha;
        r[FD_CFL0] = it->cfl_ly * aw + it->cfl_lx;
        r[FD_CFLWP] = it->cfl_wpad;
        r[FD_CFLHP] = it->cfl_hpad;
    }
    s->flags[cls][w] |= fl;
}

/* _pop: the next transform block of the store, or -1 without
 * coefficients */
static int pop(Ctx *c) {
    int idx = c->cur++;
    if (idx < 0 || idx >= c->a->n_eob) {
        c->err = PLAN_BAD_INPUT;
        return -1;
    }
    return c->a->eob[idx] >= 0 ? idx : -1;
}

/* P.pal_pred into the scatter: a (h x w) block of palette lookups at
 * plane pl, pixel (y, x) */
static void pal_scatter(Ctx *c, int pl, int y, int x, int w, int h,
                        const uint16_t *lut, int64_t idx_off) {
    State *s = c->s;
    const PlanArgs *a = c->a;
    if (idx_off < 0 || idx_off + (int64_t)w * h > a->n_palidx) {
        c->err = PLAN_BAD_INPUT;
        return;
    }
    if (grow_pal(s, s->n_pal + (int64_t)w * h)) {
        c->err = PLAN_NO_MEMORY;
        return;
    }
    const uint8_t *ix = a->palidx + idx_off;
    int64_t base = pl * c->psz + (int64_t)y * a->aw + x;
    int64_t n = s->n_pal;
    for (int r = 0; r < h; r++)
        for (int q = 0; q < w; q++) {
            uint8_t k = ix[r * w + q];
            if (k >= 8) {
                c->err = PLAN_BAD_INPUT;
                return;
            }
            s->pal_idx[n] = (int32_t)(base + (int64_t)r * a->aw + q);
            s->pal_val[n] = lut[k];
            n++;
        }
    s->n_pal = n;
}

/* _plan_chroma: both chroma planes of one 16x16 luma sub-block */
static void plan_chroma(Ctx *c, const BlockRec *b, const int32_t *tile,
                        int init_x, int init_y, int sub_ch4, int cw4,
                        int ch4, int cbw4, int cbh4, int t_w, int t_h) {
    const PlanArgs *a = c->a;
    const int ss_hor = c->ss_hor, ss_ver = c->ss_ver;
    const int bx = b->bx, by = b->by;
    const int uv_w = TX_W4[b->uvtx], uv_h = TX_H4[b->uvtx];
    const int ief = a->intra_edge_filter;
    const int ief_flag = ief << 10;
    const int flags = b->intra_edge_flags;
    const int col_start = tile[0], col_end = tile[1];
    const int row_start = tile[2], row_end = tile[3];

    const int cfl = b->uv_mode == CFL_PRED;
    int have_pads = 0, wpad = 0, hpad = 0;
    if (cfl && init_x == 0 && init_y == 0) {
        int furthest_r = ((cw4 << ss_hor) + t_w - 1) & ~(t_w - 1);
        int furthest_b = ((ch4 << ss_ver) + t_h - 1) & ~(t_h - 1);
        wpad = cbw4 - (furthest_r >> ss_hor);
        hpad = cbh4 - (furthest_b >> ss_ver);
        have_pads = 1;
    }
    if (b->pal_sz1 && init_x == 0 && init_y == 0) {
        if (b->pal_off < 0 || b->pal_off + 24 > a->n_pal) {
            c->err = PLAN_BAD_INPUT;
            return;
        }
        int xpos = bx >> ss_hor, ypos = by >> ss_ver;
        int64_t off = (int64_t)b->palidx_off +
                      (int64_t)BLK_W4[b->bs] * BLK_H4[b->bs] * 16;
        for (int pl = 0; pl < 2; pl++)
            pal_scatter(c, 1 + pl, 4 * ypos, 4 * xpos, cbw4 * 4, cbh4 * 4,
                        a->pal + b->pal_off + 8 * (1 + pl), off);
    }

    int uv_sb_has_tr, uv_sb_has_bl;
    if (((init_x + 16) >> ss_hor) < cw4)
        uv_sb_has_tr = 1;
    else if (init_y)
        uv_sb_has_tr = 0;
    else
        uv_sb_has_tr = !!(flags & (I420_TOP_HAS_RIGHT >> (a->layout - 1)));
    if (init_x)
        uv_sb_has_bl = 0;
    else if (((init_y + 16) >> ss_ver) < ch4)
        uv_sb_has_bl = 1;
    else
        uv_sb_has_bl =
            !!(flags & (I420_LEFT_HAS_BOTTOM >> (a->layout - 1)));

    const int sub_cw4 = imin(cw4, (init_x + 16) >> ss_hor);
    const int xstart = col_start >> ss_hor, ystart = row_start >> ss_ver;
    const int xend = col_end >> ss_hor, yend = row_end >> ss_ver;
    for (int pl = 0; pl < 2; pl++) {
        const int alpha = pl ? b->cfl_alpha1 : b->cfl_alpha0;
        for (int y = init_y >> ss_ver; y < sub_ch4; y += uv_h) {
            for (int x = init_x >> ss_hor; x < sub_cw4; x += uv_w) {
                int tx_idx = b->skip ? -1 : pop(c);
                if (c->err)
                    return;
                const int tbx = bx + (x << ss_hor), tby = by + (y << ss_ver);
                const int xpos = tbx >> ss_hor, ypos = tby >> ss_ver;
                const int have_left = xpos > xstart, have_top = ypos > ystart;
                It it;
                it_init(&it, 1 + pl, 4 * xpos, 4 * ypos, uv_w * 4, uv_h * 4,
                        tx_idx);
                if (cfl && alpha != 0) {
                    if (!have_pads) {
                        c->err = PLAN_BAD_INPUT;
                        return;
                    }
                    plan_edges(xpos, have_left, ypos, have_top, xend, yend,
                               0, DC_PRED, 0, uv_w, uv_h, 0, &it);
                    it.mode = it.mode == DC_PRED       ? MODE_CFL_DC
                              : it.mode == TOP_DC_PRED ? MODE_CFL_TOP
                              : it.mode == LEFT_DC_PRED ? MODE_CFL_LEFT
                                                        : MODE_CFL_128;
                    it.angle = 0;
                    it.z2_sm = 0;
                    it_reads(&it, have_top, have_left);
                    it.cfl_alpha = alpha;
                    it.cfl_ly = 4 * (tby & ~ss_ver);
                    it.cfl_lx = 4 * (tbx & ~ss_hor);
                    it.cfl_wpad = wpad;
                    it.cfl_hpad = hpad;
                    place(c, &it);
                } else if (b->pal_sz1) {
                    if (tx_idx >= 0) {
                        it.mode = MODE_IDENT;
                        place(c, &it);
                    }
                } else {
                    int ef = (((y > (init_y >> ss_ver) || !uv_sb_has_tr) &&
                               x + uv_w >= sub_cw4)
                                  ? 0
                                  : I444_TOP_HAS_RIGHT) |
                             ((x > (init_x >> ss_hor) ||
                               (!uv_sb_has_bl && y + uv_h >= sub_ch4))
                                  ? 0
                                  : I444_LEFT_HAS_BOTTOM);
                    int uv_mode = cfl ? DC_PRED : b->uv_mode;
                    plan_edges(xpos, have_left, ypos, have_top, xend, yend,
                               ef, uv_mode, b->uv_angle, uv_w, uv_h, ief,
                               &it);
                    it.angle = (it.angle | ief_flag) | b->sm_uv_fl;
                    it.z2_mw = (4 * a->bw + ss_hor - 4 * (tbx & ~ss_hor)) >>
                               ss_hor;
                    it.z2_mh = (4 * a->bh + ss_ver - 4 * (tby & ~ss_ver)) >>
                               ss_ver;
                    it_reads(&it, have_top, have_left);
                    place(c, &it);
                }
                if (c->err)
                    return;
            }
        }
    }
}

/* _plan_b_intra: one intra block */
static void plan_block(Ctx *c, const BlockRec *b, const int32_t *tile) {
    const PlanArgs *a = c->a;
    const int ss_hor = c->ss_hor, ss_ver = c->ss_ver;
    if (b->bs >= 22 || b->tx >= 19 || b->uvtx >= 19) {
        c->err = PLAN_BAD_INPUT;
        return;
    }
    const int bx = b->bx, by = b->by;
    const int bw4 = BLK_W4[b->bs], bh4 = BLK_H4[b->bs];
    const int w4 = imin(bw4, a->bw - bx), h4 = imin(bh4, a->bh - by);
    const int cw4 = (w4 + ss_hor) >> ss_hor, ch4 = (h4 + ss_ver) >> ss_ver;
    const int has_chroma = a->layout != I400 && (bw4 > ss_hor || (bx & 1)) &&
                           (bh4 > ss_ver || (by & 1));
    const int t_w = TX_W4[b->tx], t_h = TX_H4[b->tx];
    const int cbw4 = (bw4 + ss_hor) >> ss_hor, cbh4 = (bh4 + ss_ver) >> ss_ver;
    const int ief = a->intra_edge_filter;
    const int intra_flags = b->sm_fl | (ief << 10);
    const int flags = b->intra_edge_flags;
    const int col_start = tile[0], col_end = tile[1];
    const int row_start = tile[2], row_end = tile[3];

    c->cur = b->tx_pos;
    if (b->pal_sz0) {
        if (b->pal_off < 0 || b->pal_off + 24 > a->n_pal) {
            c->err = PLAN_BAD_INPUT;
            return;
        }
        pal_scatter(c, 0, 4 * by, 4 * bx, bw4 * 4, bh4 * 4,
                    a->pal + b->pal_off, b->palidx_off);
        if (c->err)
            return;
    }

    for (int init_y = 0; init_y < h4; init_y += 16) {
        const int sub_h4 = imin(h4, 16 + init_y);
        const int sub_ch4 = imin(ch4, (init_y + 16) >> ss_ver);
        for (int init_x = 0; init_x < w4; init_x += 16) {
            int sb_has_tr, sb_has_bl;
            if (init_x + 16 < w4)
                sb_has_tr = 1;
            else if (init_y)
                sb_has_tr = 0;
            else
                sb_has_tr = !!(flags & I444_TOP_HAS_RIGHT);
            if (init_x)
                sb_has_bl = 0;
            else if (init_y + 16 < h4)
                sb_has_bl = 1;
            else
                sb_has_bl = !!(flags & I444_LEFT_HAS_BOTTOM);
            const int sub_w4 = imin(w4, init_x + 16);
            for (int y = init_y; y < sub_h4; y += t_h) {
                for (int x = init_x; x < sub_w4; x += t_w) {
                    int tx_idx = b->skip ? -1 : pop(c);
                    if (c->err)
                        return;
                    const int tbx = bx + x, tby = by + y;
                    It it;
                    it_init(&it, 0, 4 * tbx, 4 * tby, t_w * 4, t_h * 4,
                            tx_idx);
                    if (b->pal_sz0) {
                        if (tx_idx >= 0) {
                            it.mode = MODE_IDENT;
                            place(c, &it);
                        }
                    } else {
                        int ef = (!((y > init_y || !sb_has_tr) &&
                                    x + t_w >= sub_w4)
                                      ? I444_TOP_HAS_RIGHT
                                      : 0) |
                                 (!(x > init_x ||
                                    (!sb_has_bl && y + t_h >= sub_h4))
                                      ? I444_LEFT_HAS_BOTTOM
                                      : 0);
                        const int have_left = tbx > col_start;
                        const int have_top = tby > row_start;
                        plan_edges(tbx, have_left, tby, have_top, col_end,
                                   row_end, ef, b->y_mode, b->y_angle, t_w,
                                   t_h, ief, &it);
                        it.angle |= intra_flags;
                        it.z2_mw = 4 * a->bw - 4 * tbx;
                        it.z2_mh = 4 * a->bh - 4 * tby;
                        it_reads(&it, have_top, have_left);
                        place(c, &it);
                    }
                    if (c->err)
                        return;
                }
            }
            if (has_chroma) {
                plan_chroma(c, b, tile, init_x, init_y, sub_ch4, cw4, ch4,
                            cbw4, cbh4, t_w, t_h);
                if (c->err)
                    return;
            }
        }
    }
}

static void state_free(State *s) {
    if (!s)
        return;
    free(s->items);
    free(s->pal_idx);
    free(s->pal_val);
    for (int c = 0; c < 2; c++) {
        free(s->cnt[c]);
        free(s->flags[c]);
    }
    free(s);
}

EXPORT void rav1d_plan_free(PlanOut *o) {
    state_free((State *)o->state);
    o->state = NULL;
}

/* Plan a key or intra-only frame. Returns the status (also in o->status):
 * PLAN_GATE when a record is not an intra block (intra block copy: the
 * frame goes to the host path), PLAN_BAD_INPUT when a record or range
 * points outside its arrays. On PLAN_OK, o->state holds the items until
 * rav1d_plan_free. */
EXPORT int32_t rav1d_plan_frame(const PlanArgs *a, PlanOut *o) {
    memset(o, 0, sizeof(*o));
    Ctx c;
    memset(&c, 0, sizeof(c));
    c.a = a;
    c.gh = a->ah >> 2;
    c.gw = a->aw >> 2;
    c.psz = (int64_t)a->ah * a->aw;
    c.ss_hor = a->layout != I444;
    c.ss_ver = a->layout == I420;
    if (a->layout < I400 || a->layout > I444 || c.gh <= 0 || c.gw <= 0) {
        o->status = PLAN_BAD_INPUT;
        return o->status;
    }
    /* a gated frame is found before any work */
    for (int i = 0; i < a->n_ranges; i++) {
        const int32_t *rg = a->ranges + 3 * i;
        if (rg[0] < 0 || rg[0] >= a->n_tiles || rg[1] < 0 || rg[2] < rg[1] ||
            rg[2] > a->n_rec) {
            o->status = PLAN_BAD_INPUT;
            return o->status;
        }
        for (int32_t k = rg[1]; k < rg[2]; k++)
            if (a->rec[k].kind != 0) {
                o->status = PLAN_GATE;
                return o->status;
            }
    }
    c.s = calloc(1, sizeof(State));
    c.grid = calloc((size_t)3 * c.gh * c.gw, sizeof(int32_t));
    if (!c.s || !c.grid) {
        free(c.grid);
        state_free(c.s);
        o->status = PLAN_NO_MEMORY;
        return o->status;
    }
    for (int i = 0; i < a->n_ranges && !c.err; i++) {
        const int32_t *rg = a->ranges + 3 * i;
        const int32_t *tile = a->tiles + 4 * rg[0];
        for (int32_t k = rg[1]; k < rg[2] && !c.err; k++)
            plan_block(&c, &a->rec[k], tile);
    }
    free(c.grid);
    if (c.err) {
        state_free(c.s);
        o->status = c.err;
        return o->status;
    }
    o->n_items = (int32_t)c.s->n_items;
    o->n_waves = c.s->max_wave;
    o->n_pal = c.s->n_pal;
    o->state = c.s;
    o->status = PLAN_OK;
    return PLAN_OK;
}

static void write_class(const State *s, int cls, int32_t *out, int nw,
                        int cap, int64_t psz) {
    const size_t n = (size_t)nw * cap;
    for (size_t i = 0; i < n; i++) {
        int32_t *r = out + i * N_FIELDS;
        memset(r, 0, N_FIELDS * sizeof(int32_t));
        r[FD_FLAT0] = (int32_t)(3 * psz);
        r[FD_W] = 4;
        r[FD_H] = 4;
        r[FD_IIOFF] = -1;
    }
    for (int64_t i = 0; i < s->n_items; i++) {
        const Item *it = &s->items[i];
        if (it->cls != cls)
            continue;
        int32_t *r = out + ((size_t)(it->wave - 1) * cap + it->slot) *
                               N_FIELDS;
        memcpy(r, it->row, sizeof(it->row));
    }
    for (int w = 0; w < nw; w++) {
        int32_t *r = out + (size_t)w * cap * N_FIELDS;
        int in = w + 1 < s->waves_cap;
        r[FD_WFLAGS] = in ? s->flags[cls][w + 1] : 0;
        r[FD_WCOUNT] = in ? s->cnt[cls][w + 1] : 0;
    }
}

/* Fill the outputs of a planned frame: the two class arrays (nw, cap0 or
 * cap1, N_FIELDS) int32, nw = max(n_waves, 1), as _pack_class writes them,
 * and the palette scatter's flat indices and values (n_pal each). */
EXPORT int32_t rav1d_plan_write(const PlanArgs *a, const PlanOut *o,
                                int32_t *rows0, int32_t *rows1,
                                int32_t *pal_idx, int32_t *pal_val) {
    const State *s = (const State *)o->state;
    if (!s)
        return PLAN_BAD_INPUT;
    const int nw = o->n_waves > 1 ? o->n_waves : 1;
    const int64_t psz = (int64_t)a->ah * a->aw;
    write_class(s, 0, rows0, nw, a->cap0, psz);
    write_class(s, 1, rows1, nw, a->cap1, psz);
    if (s->n_pal) {
        memcpy(pal_idx, s->pal_idx, (size_t)s->n_pal * sizeof(int32_t));
        memcpy(pal_val, s->pal_val, (size_t)s->n_pal * sizeof(int32_t));
    }
    return PLAN_OK;
}

/* the number of wave descriptor fields this build writes */
EXPORT int32_t rav1d_plan_n_fields(void) { return N_FIELDS; }
