// One level of the intra wavefront, CUDA C++ for sm_90a: every item of the
// level, both size classes and every prediction mode, in one launch
// (rav1d_wave_level).
//
// Replaces the XLA device kernel the JAX engine runs once per level and
// class: rav1d_tpu/engine/wave2.py _class_step (:74) with _build_coords
// (:223), over the mode kernels of rav1d_tpu/ops/tpu/ipred_dyn.py (dc_dyn
// :117 to cfl_pred_dyn :468), which rav1d_tpu/engine/mega.py wave_prog
// (:213) loops over. The port's plain version is engine/wave.py class_step
// over ops/ipred_dyn.py; this kernel computes exactly what it computes.
//
// Per item (one thread block): read the item's descriptor row (the 21
// fields of engine/layout.py FIELDS) straight from the frame blob; build
// its edge in shared memory from the descriptor as build_coords does, at
// the layout of its size class (CW, CH): EL = 2*CH + 1 + 2*CW values, the
// top-left sample at C = 2*CH, the top row ascending from C + 1, the left
// column descending from C - 1; a coordinate below 0 decodes to the
// constant -v - 1, and -1 (so 0) lies past 2w and 2h. Every read of the
// edge or of a mode's intermediate vector clamps its index to that vector,
// as the plain version's gathers do, so a clamp that reaches a valid
// sample decides it. Then predict by the item's mode code (an unknown code
// predicts DC), blend an interintra item over its own pixels by its mask
// (stored at the class width's stride), add the residual where rmask is
// set and clip, and write the pixels inside (w, h) whose index lies in
// [0, 3 * psz).
//
// Both classes share a launch: thread blocks [0, n_s) take the small
// class's lanes (16x16, cap 64) and [n_s, n_s + n_l) the large class's
// (64x64, cap 16). engine/plan.py _assign_waves puts every pixel an item
// reads (edges, CfL luma, its own pixels for IDENT and interintra) in a
// strictly earlier wave than the item, and no two items of a level write
// the same pixel, so the items of a level, of either class, are
// independent and may run in any order; the plain version's small class
// then large class order gives the same planes
// (tests/test_torch_wave_kernel.py holds it).
//
// Bound on this card. Bytes: descriptors, edge pixels, residuals, own and
// CfL luma pixels and masks read, pixels written: 22-30 MB for a 1080p
// 4:2:0 frame at int32 planes (51 MB at 12-bit 4:4:4; chip_smoke.py
// wave_work), 7-9 us at 3.35 TB/s. Operations: a few tens of int32
// operations per pixel, below the bytes. The real floor is the dependency
// chain: a 1080p frame has 1,600-2,500 levels, each a launch that waits
// for the one before. On an H100 80GB HBM3 an empty kernel launched the
// same way takes 3.9-4.8 us a level and this kernel 5.9-7.9 us of device
// time, 10.6-15.3 ms per frame (PERF.md). What the design does: one launch
// per level (not per level and class), all of an item's intermediates in
// shared memory (no device buffer, no allocation), the descriptors and
// tables read in place, and a handful of barriers per item (one per filter
// intra anti-diagonal). A persistent kernel with a grid-wide barrier
// between levels, or a captured graph of the launches, would take the
// launch latency and the host's per-level call off the chain; that is
// later work.
//
// Design: 256 threads per block for either class; the threads of a block
// loop over the item's w x h pixels, x fastest (coalesced rows), in steps
// separated by barriers: (0) the descriptor into shared memory; (1) the
// edge; then by mode: the Z1/Z3 filtered or upsampled edge vector, the Z2
// combined edge, filter intra's work buffer and one step per anti-diagonal
// of its 4x2 sub-blocks, or CfL's subsampled luma and its sum (shared
// atomics); (n-2) the prediction into a shared (CH, CW) tile, with the
// interintra blend over the block's own pixels; (n-1) the residual add,
// clip and store. Reads of the block's own pixels end at the barrier
// before the store. Shared memory: 35.5 KB per block, static.
//
// Integer semantics: every add, subtract, multiply and negate that can
// leave int32 wraps (the frameworks' int32 arithmetic wraps; C++ signed
// overflow is undefined), computed in uint32_t; `>>` on negative values
// is arithmetic; sums wrap at int32, as the plain version's int32 sums do.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_wave_level_host walks the same blocks with the same step
// functions, thread by thread, each barrier a loop boundary, for the CPU
// tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define WV_HD __host__ __device__ __forceinline__
#define WV_MEM __host__ __device__ __forceinline__
#else
#define WV_HD static inline
#define WV_MEM inline
#endif

// a read of the tables (read-only for the whole launch)
WV_HD int WV_LD(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

WV_HD int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
WV_HD int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
WV_HD int wmul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }
WV_HD int wneg(int a) { return (int)(0u - (uint32_t)a); }
WV_HD int imin(int a, int b) { return a < b ? a : b; }
WV_HD int imax(int a, int b) { return a > b ? a : b; }
WV_HD int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
// floor division and modulo (torch's // and % on int tensors)
WV_HD int fdiv(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
WV_HD int fmodi(int a, int b) { return wsub(a, wmul(fdiv(a, b), b)); }

#define WV_THREADS 256
#define WV_FIELDS 21
#define WV_CAP_S 64   // engine/plan.py CAP
#define WV_CAP_L 16

// descriptor fields (engine/layout.py FIELDS)
enum {
    F_MODES, F_ANGLES, F_FLAT0, F_RMASK, F_Z2MW, F_Z2MH, F_Z2SM, F_CFLA,
    F_CFL0, F_CFLWP, F_CFLHP, F_W, F_H, F_IIOFF, F_WFLAGS, F_WCOUNT, F_HAV,
    F_PHL, F_PHBL, F_PHT, F_PHTR,
    F_SUM = WV_FIELDS  // the CfL ac sum, beside the fields in shared memory
};

// mode codes (syntax/levels.py, engine/plan.py MODE_*)
enum {
    M_DC, M_V, M_H, M_LEFT_DC, M_TOP_DC, M_DC_128, M_Z1, M_Z2, M_Z3,
    M_SMOOTH, M_SMOOTH_V, M_SMOOTH_H, M_PAETH, M_FILTER, M_IDENT,
    M_CFL_DC, M_CFL_TOP, M_CFL_LEFT, M_CFL_128
};

// The tables of engine/consts.py numpy_tables(), one int32 array in this
// order (ops/cuda/wave.py table): ctz (257), edge_kernels (3 x 5),
// dr_intra_derivative (44), sm_weights (128), filter_intra_taps (5x8x7).
#define T_CTZ 0
#define T_EK 257
#define T_DR 272
#define T_SM 316
#define T_FT 444
#define T_LEN 724

// The launch's parameter, by value; ops/cuda/wave.py WaveFrame mirrors it.
struct WaveFrame {
    int* pf;          // the planes, 3 * psz words (and maybe a trash word)
    const int* ra;    // residuals; ra[i] for i < 3 * psz
    const int* blob;  // the frame blob: descriptors and interintra masks
    const int* tab;   // the tables above
    int n3;           // 3 * psz: writes land in [0, n3), reads clamp to it
    int blob_len;
    int base_s;       // word of the small class's descriptor region
    int base_l;       // the large class's
    int mask_base;    // word of the interintra masks
    int aw;           // plane row pitch
    int psz;          // words per plane
    int bpc;
    int ss_hor;
    int ss_ver;
};

// shared memory words of one block, laid out for the large class
#define SM_DSC 0                      // the descriptor and the CfL sum
#define SM_EDGE 24                    // the edge, EL <= 257
#define SM_VEC (SM_EDGE + 260)        // Z1/Z3 vector (<= 256), Z2 edge
#define SM_OUT (SM_VEC + 260)         // (CH, CW) prediction / CfL ac
#define SM_FBUF (SM_OUT + 64 * 64)    // filter intra (CH + 1, CW + 1)
#define SM_WORDS (SM_FBUF + 65 * 65)

WV_HD int ctz_t(const int* tab, int v) { return WV_LD(tab + T_CTZ + clampi(v, 0, 256)); }
WV_HD int dr_t(const int* tab, int i) { return WV_LD(tab + T_DR + clampi(i, 0, 43)); }
WV_HD int sm_t(const int* tab, int i) { return WV_LD(tab + T_SM + clampi(i, 0, 127)); }
WV_HD int ek_t(const int* tab, int fs, int j) {
    return WV_LD(tab + T_EK + 5 * (imax(fs, 1) - 1) + j);
}

// _get_filter_strength and _upsample of the directional modes (per item)
WV_HD int fs_t(int wh, int a, int is_sm) {
    if (is_sm) {
        if (wh <= 8) return a >= 64 ? 2 : (a >= 40 ? 1 : 0);
        if (wh <= 16) return a >= 48 ? 2 : (a >= 20 ? 1 : 0);
        if (wh <= 24) return a >= 4 ? 3 : 0;
        return 3;
    }
    if (wh <= 8) return a >= 56 ? 1 : 0;
    if (wh <= 16) return a >= 40 ? 1 : 0;
    if (wh <= 24) return a >= 32 ? 3 : (a >= 16 ? 2 : (a >= 8 ? 1 : 0));
    if (wh <= 32) return a >= 32 ? 3 : (a >= 4 ? 2 : 1);
    return 3;
}
WV_HD int ups_t(int wh, int a, int is_sm) {
    return (a < 40 && wh <= (is_sm ? 8 : 16)) ? 1 : 0;
}

// the 4-tap upsampler's odd sample and the 5-tap edge filter
WV_HD int ups_odd(int m1, int e, int p1, int p2, int pxmax) {
    const int v = wadd(wsub(wadd(wmul(9, e), wmul(9, p1)), wadd(m1, p2)), 8);
    return clampi(v >> 4, 0, pxmax);
}
WV_HD int filt5(const int* tab, int fs, const int* taps) {
    int acc = 0;
    for (int j = 0; j < 5; j++) acc = wadd(acc, wmul(ek_t(tab, fs, j), taps[j]));
    return wadd(acc, 8) >> 4;
}

// Everything one thread block needs about its item and class.
template <int CW, int CH>
struct Item {
    static constexpr int C = 2 * CH;
    static constexpr int EL = 2 * CH + 1 + 2 * CW;
    static constexpr int LMAX = 2 * (CW + CH);
    const WaveFrame& p;
    int* sm;
    const int* d;   // the descriptor in shared memory
    int* e;         // the edge
    int* vec;
    int* out;
    int* fbuf;
    int w, h, ew, eh;  // block size; the part inside the class
    WV_MEM Item(const WaveFrame& p_, int* sm_)
        : p(p_), sm(sm_), d(sm_ + SM_DSC), e(sm_ + SM_EDGE),
          vec(sm_ + SM_VEC), out(sm_ + SM_OUT), fbuf(sm_ + SM_FBUF) {
        w = d[F_W];
        h = d[F_H];
        ew = clampi(w, 0, CW);
        eh = clampi(h, 0, CH);
    }
    WV_MEM int E(int pos) const { return e[clampi(pos, 0, EL - 1)]; }
    WV_MEM int top(int i) const { return e[C + 1 + i]; }
    WV_MEM int left(int j) const { return e[C - 1 - j]; }
    WV_MEM int pxmax() const { return (1 << p.bpc) - 1; }
};

// build_coords at edge position q: a flat plane index, or -v - 1 for the
// constant v
template <int CW, int CH>
WV_HD int edge_coord(const Item<CW, CH>& it, int q) {
    const int* d = it.d;
    const int aw = it.p.aw;
    const int flat0 = d[F_FLAT0];
    const int rem = fmodi(flat0, it.p.psz);
    const int plbase = wsub(flat0, rem);
    const int py = fdiv(rem, aw), px = fmodi(rem, aw);
    const int hl = d[F_HAV] & 1, ht = (d[F_HAV] & 2) != 0;
    const int half = (1 << it.p.bpc) >> 1;
    const int top0 = wsub(wadd(wadd(plbase, wmul(py - 1, aw)), px), hl);
    const int leftpix = wadd(wadd(plbase, wmul(py, aw)), px - 1);
    const int colbase = wadd(plbase, px - 1);
    const int rowbase = wadd(wadd(plbase, wmul(py - 1, aw)), px);
    const int w = it.w, h = it.h;
    constexpr int C = Item<CW, CH>::C;
    if (q < C) {
        const int k = C - 1 - q;
        const int phl = d[F_PHL], phbl = d[F_PHBL];
        const int lfill = ht ? top0 : -(half + 2);
        const int i = k < h ? k : h - 1;  // left_at(k) or left_at(h - 1)
        const int lval = hl ? wadd(colbase, wmul(wadd(py, imin(i, phl - 1)), aw))
                            : lfill;
        if (k < h) return lval;
        if (k < 2 * h)
            return phbl > 0
                ? wadd(colbase, wmul(wadd(wadd(py, h), imin(k - h, phbl - 1)), aw))
                : lval;
        return -1;
    }
    if (q == C) return ht ? top0 : (hl ? leftpix : -(half + 1));
    const int j = q - C - 1;
    const int pht = d[F_PHT], phtr = d[F_PHTR];
    const int i = j < w ? j : w - 1;  // top_at(j) or top_at(w - 1)
    const int tval = ht ? wadd(rowbase, imin(i, pht - 1)) : (hl ? leftpix : -half);
    if (j < w) return tval;
    if (j < 2 * w)
        return phtr > 0 ? wadd(wadd(rowbase, w), imin(j - w, phtr - 1)) : tval;
    return -1;
}

// the DC value of dc_dyn, dc_top_dyn, dc_left_dyn, dc_128_dyn by code (the
// CfL codes by their DC variant; any other code: DC)
template <int CW, int CH>
WV_HD int dc_value(const Item<CW, CH>& it, int code) {
    const int* tab = it.p.tab;
    const int w = it.w, h = it.h;
    if (code == M_DC_128 || code == M_CFL_128) return (1 << it.p.bpc) >> 1;
    int tsum = 0, lsum = 0;
    const int nt = clampi(w, 0, 2 * CW), nl = clampi(h, 0, 2 * CH);
    if (code != M_LEFT_DC && code != M_CFL_LEFT)
        for (int i = 0; i < nt; i++) tsum = wadd(tsum, it.top(i));
    if (code != M_TOP_DC && code != M_CFL_TOP)
        for (int j = 0; j < nl; j++) lsum = wadd(lsum, it.left(j));
    if (code == M_TOP_DC || code == M_CFL_TOP)
        return wadd(tsum, w >> 1) >> ctz_t(tab, w);
    if (code == M_LEFT_DC || code == M_CFL_LEFT)
        return wadd(lsum, h >> 1) >> ctz_t(tab, h);
    const int wh = w + h;
    int dc = wadd(wadd(wh >> 1, tsum), lsum) >> ctz_t(tab, wh);
    if (w != h) {
        const bool b8 = it.p.bpc == 8;
        const bool r4 = w > (h << 1) || h > (w << 1);
        const int mult = r4 ? (b8 ? 0x3334 : 0x6667) : (b8 ? 0x5556 : 0xAAAB);
        dc = wmul(dc, mult) >> (b8 ? 16 : 17);
    }
    return dc;
}

// Z1's filtered or upsampled top vector at i (z1_dyn)
template <int CW, int CH>
WV_HD int z1_vec(const Item<CW, CH>& it, int i) {
    constexpr int C = Item<CW, CH>::C;
    const int a = it.d[F_ANGLES];
    const int angle = a & 511, is_sm = (a >> 9) & 1, ief = (a >> 10) != 0;
    const int w = it.w, wh = it.w + it.h, wmin = imin(it.w, it.h);
    const int ups = ief ? ups_t(wh, 90 - angle, is_sm) : 0;
    const int fs = ief ? fs_t(wh, 90 - angle, is_sm) : 0;
    const int hi = w + wmin;
    int taps[5];
    for (int j = 0; j < 5; j++) taps[j] = it.E(C + 1 + imin(imax(i + j - 2, -1), hi - 1));
    if (ups) {
        const int k = i >> 1;
        int s[4];
        for (int j = 0; j < 4; j++) s[j] = it.E(C + 1 + imin(imax(k + j - 1, -1), hi - 1));
        return (i & 1) == 0 ? s[1] : ups_odd(s[0], s[1], s[2], s[3], it.pxmax());
    }
    if (fs > 0) return i < wh ? filt5(it.p.tab, fs, taps) : taps[2];
    return taps[2];
}

// Z3's filtered or upsampled left vector at i (z3_dyn)
template <int CW, int CH>
WV_HD int z3_vec(const Item<CW, CH>& it, int i) {
    constexpr int C = Item<CW, CH>::C;
    const int a = it.d[F_ANGLES];
    const int angle = a & 511, is_sm = (a >> 9) & 1, ief = (a >> 10) != 0;
    const int wh = it.w + it.h;
    const int ups = ief ? ups_t(wh, angle - 180, is_sm) : 0;
    const int fs = ief ? fs_t(wh, angle - 180, is_sm) : 0;
    const int lo = imax(it.w - it.h, 0);
    if (ups) {
        const int t = 2 * wh - 2 - i, k = t >> 1;
        int s[4];
        for (int j = 0; j < 4; j++) s[j] = it.E(C - wh + imin(imax(k + j - 1, lo), wh));
        return (t & 1) == 0 ? s[1] : ups_odd(s[0], s[1], s[2], s[3], it.pxmax());
    }
    if (fs > 0) {
        const int kf = wh - 1 - i;
        int taps[5];
        for (int j = 0; j < 5; j++) taps[j] = it.E(C - wh + imin(imax(kf + j - 2, lo), wh));
        return filt5(it.p.tab, fs, taps);
    }
    return it.E(C - 1 - i);
}

// Z2's edge with the top-left smoothing: its value at (clamped) position pos
template <int CW, int CH>
WV_HD int z2_e(const Item<CW, CH>& it, int pos, int tl) {
    const int cp = clampi(pos, 0, Item<CW, CH>::EL - 1);
    return cp == Item<CW, CH>::C ? tl : it.e[cp];
}

template <int CW, int CH>
WV_HD int z2_tl(const Item<CW, CH>& it) {
    constexpr int C = Item<CW, CH>::C;
    const int tl0 = it.e[C];
    if (!it.d[F_Z2SM]) return tl0;
    return wadd(wadd(wmul(wadd(it.e[C - 1], it.e[C + 1]), 5), wmul(tl0, 6)), 8) >> 4;
}

// Z2's combined edge at position q (z2_dyn's edge_v)
template <int CW, int CH>
WV_HD int z2_vec(const Item<CW, CH>& it, int q, int tl) {
    constexpr int C = Item<CW, CH>::C;
    const int a = it.d[F_ANGLES];
    const int angle = a & 511, is_sm = (a >> 9) & 1, ief = (a >> 10) != 0;
    const int w = it.w, h = it.h, wh = it.w + it.h;
    const int pxmax = it.pxmax();
    const int j = q - C;
    if (j == 0) return z2_e(it, C, tl);
    int s[5];
    if (j > 0) {  // above: s_a(k) = edge[C + clip(k, 0, w)]
        const int ua = ief ? ups_t(wh, angle - 90, is_sm) : 0;
        if (ua) {
            const int k = j >> 1;
            for (int m = 0; m < 4; m++) s[m] = z2_e(it, C + imin(imax(k + m - 1, 0), w), tl);
            return (j & 1) == 0 ? s[1] : ups_odd(s[0], s[1], s[2], s[3], pxmax);
        }
        const int fs = ief ? fs_t(wh, angle - 90, is_sm) : 0;
        const int i_a = j - 1;
        for (int m = 0; m < 5; m++) s[m] = z2_e(it, C + imin(imax(j + m - 2, 0), w), tl);
        return (i_a >= 0 && i_a < it.d[F_Z2MW] && fs > 0) ? filt5(it.p.tab, fs, s) : s[2];
    }
    // below: s_b(k) = edge[C - h + clip(k, 0, h)]
    const int ul = ief ? ups_t(wh, 180 - angle, is_sm) : 0;
    if (ul) {
        const int tb = j + 2 * h, kb = tb >> 1;
        for (int m = 0; m < 4; m++) s[m] = z2_e(it, C - h + imin(imax(kb + m - 1, 0), h), tl);
        return (tb & 1) == 0 ? s[1] : ups_odd(s[0], s[1], s[2], s[3], pxmax);
    }
    const int fs = ief ? fs_t(wh, 180 - angle, is_sm) : 0;
    const int i_l = j + h;
    for (int m = 0; m < 5; m++) s[m] = z2_e(it, C - h + imin(imax(i_l + m - 2, 0), h), tl);
    return (i_l >= h - it.d[F_Z2MH] && i_l < h && fs > 0) ? filt5(it.p.tab, fs, s) : s[2];
}

// the interpolation between two samples at 1/64 positions
WV_HD int interp(int t0, int t1, int frac) {
    return wadd(wadd(wmul(t0, 64 - frac), wmul(t1, frac)), 32) >> 6;
}

// The prediction of pixel (y, x) for the non-buffered modes.
template <int CW, int CH>
WV_HD int predict(const Item<CW, CH>& it, int mode, int y, int x, int dc) {
    constexpr int C = Item<CW, CH>::C;
    const int* tab = it.p.tab;
    const int w = it.w, h = it.h;
    switch (mode) {
        case M_V: return it.top(x);
        case M_H: return it.left(y);
        case M_PAETH: {
            const int tl = it.e[C], t = it.top(x), l = it.left(y);
            const int base = wsub(wadd(l, t), tl);
            const int ld = wsub(l, base), td = wsub(t, base), tld = wsub(tl, base);
            const int la = ld < 0 ? wneg(ld) : ld, ta = td < 0 ? wneg(td) : td;
            const int tla = tld < 0 ? wneg(tld) : tld;
            return (la <= ta && la <= tla) ? l : (ta <= tla ? t : tl);
        }
        case M_SMOOTH: case M_SMOOTH_V: case M_SMOOTH_H: {
            const int wx = sm_t(tab, w + x), wy = sm_t(tab, h + y);
            const int right = it.E(C + w), bottom = it.E(C - h);
            const int vv = wadd(wmul(wy, it.top(x)), wmul(256 - wy, bottom));
            const int hh = wadd(wmul(wx, it.left(y)), wmul(256 - wx, right));
            if (mode == M_SMOOTH_V) return wadd(vv, 128) >> 8;
            if (mode == M_SMOOTH_H) return wadd(hh, 128) >> 8;
            return wadd(wadd(vv, hh), 256) >> 9;
        }
        case M_Z1: case M_Z3: {
            constexpr int L = Item<CW, CH>::LMAX;
            const int a = it.d[F_ANGLES];
            const int angle = a & 511, is_sm = (a >> 9) & 1, ief = (a >> 10) != 0;
            const int wh = w + h, mn = imin(w, h);
            const int aa = mode == M_Z1 ? 90 - angle : angle - 180;
            const int ups = ief ? ups_t(wh, aa, is_sm) : 0;
            const int fs = ief ? fs_t(wh, aa, is_sm) : 0;
            const int d = mode == M_Z1 ? dr_t(tab, angle >> 1) : dr_t(tab, (270 - angle) >> 1);
            const int max_base = ups ? 2 * wh - 2
                : (fs > 0 ? wh - 1 : (mode == M_Z1 ? w : h) + mn - 1);
            const int pos = wmul(d << ups, (mode == M_Z1 ? y : x) + 1);
            const int frac = pos & 0x3E;
            const int base = wadd(pos >> 6, wmul(mode == M_Z1 ? x : y, 1 + ups));
            if (base >= max_base) return it.vec[clampi(max_base, 0, L - 1)];
            const int idx = imin(base, max_base);
            return interp(it.vec[clampi(idx, 0, L - 1)],
                          it.vec[clampi(imin(idx + 1, L - 1), 0, L - 1)], frac);
        }
        case M_Z2: {
            constexpr int EL = Item<CW, CH>::EL;
            const int a = it.d[F_ANGLES];
            const int angle = a & 511, is_sm = (a >> 9) & 1, ief = (a >> 10) != 0;
            const int wh = w + h;
            const int ua = ief ? ups_t(wh, angle - 90, is_sm) : 0;
            const int ul = ief ? ups_t(wh, 180 - angle, is_sm) : 0;
            const int dy = dr_t(tab, (angle - 90) >> 1);
            const int dx = dr_t(tab, (180 - angle) >> 1);
            const int xpos = wsub((1 + ua) << 6, wmul(dx << ua, y + 1));
            const int base_x = wadd(xpos >> 6, wmul(x, 1 + ua));
            if (base_x >= 0) {
                const int f = xpos & 0x3E;
                return interp(it.vec[clampi(C + base_x, 0, EL - 1)],
                              it.vec[clampi(C + base_x + 1, 0, EL - 1)], f);
            }
            const int ypos = wsub(wmul(y, 1 << (6 + ul)), wmul(dy << ul, x + 1));
            const int base_y = ypos >> 6, f = ypos & 0x3E;
            const int lo = C - (1 + ul) - base_y;
            return interp(it.vec[clampi(lo, 0, EL - 1)],
                          it.vec[clampi(lo - 1, 0, EL - 1)], f);
        }
        default:  // the DC family, and an unknown code (DC)
            return dc;
    }
}

WV_HD bool is_cfl(int mode) { return mode >= M_CFL_DC && mode <= M_CFL_128; }
WV_HD bool is_z(int mode) { return mode == M_Z1 || mode == M_Z2 || mode == M_Z3; }
// the DC family, the CfL codes and every unknown code read a DC value
WV_HD bool uses_dc(int mode) {
    return mode == M_DC || mode == M_LEFT_DC || mode == M_TOP_DC || mode == M_DC_128
        || mode < 0 || mode > M_IDENT;
}

// The number of steps of the item in shared memory (valid after step 0).
template <int CW, int CH>
WV_HD int item_nsteps(const int* sm) {
    const int mode = sm[SM_DSC + F_MODES];
    if (is_z(mode) || is_cfl(mode)) return 5;
    if (mode == M_FILTER) {
        const int ew = clampi(sm[SM_DSC + F_W], 0, CW);
        const int eh = clampi(sm[SM_DSC + F_H], 0, CH);
        return 5 + imax(((eh + 1) >> 1) + ((ew + 3) >> 2) - 1, 0);
    }
    return 4;
}

// Step s of thread t in the block of the item whose descriptor row starts
// at blob word `row`. The steps run in order, each finished by every
// thread before the next begins.
template <int CW, int CH>
WV_HD void item_step(int s, int t, const WaveFrame& p, int row, int* sm) {
    if (s == 0) {
        if (t < WV_FIELDS) sm[SM_DSC + t] = p.blob[row + t];
        if (t == F_SUM) sm[SM_DSC + F_SUM] = 0;
        return;
    }
    const Item<CW, CH> it(p, sm);
    constexpr int C = Item<CW, CH>::C;
    const int* d = it.d;
    const int mode = d[F_MODES];
    const int n = item_nsteps<CW, CH>(sm);
    const int npx = it.ew * it.eh;
    if (s == 1) {  // the edge
        for (int q = t; q < Item<CW, CH>::EL; q += WV_THREADS) {
            const int c = edge_coord(it, q);
            it.e[q] = c < 0 ? wsub(wneg(c), 1) : p.pf[clampi(c, 0, p.n3 - 1)];
        }
        return;
    }
    if (s == n - 1) {  // residual add, clip, store
        const int flat0 = d[F_FLAT0], rmask = d[F_RMASK] != 0;
        const int pxmax = it.pxmax();
        for (int q = t; q < npx; q += WV_THREADS) {
            const int y = q / it.ew, x = q - y * it.ew;
            const int idx = wadd(wadd(flat0, wmul(y, p.aw)), x);
            if (idx < 0 || idx >= p.n3) continue;
            int v = it.out[y * CW + x];
            if (rmask) v = clampi(wadd(v, p.ra[idx]), 0, pxmax);
            p.pf[idx] = v;
        }
        return;
    }
    if (s == n - 2) {  // the prediction, then the interintra blend
        const int flat0 = d[F_FLAT0], iioff = d[F_IIOFF];
        const int dc = uses_dc(mode) ? dc_value(it, mode) : 0;
        int avg = 0;
        if (is_cfl(mode)) {
            const int l2 = ctz_t(p.tab, it.w) + ctz_t(p.tab, it.h);
            avg = wadd((1 << l2) >> 1, d[F_SUM]) >> l2;
        }
        for (int q = t; q < npx; q += WV_THREADS) {
            const int y = q / it.ew, x = q - y * it.ew;
            const int idx = wadd(wadd(flat0, wmul(y, p.aw)), x);
            int v;
            if (mode == M_FILTER) {
                v = it.fbuf[(y + 1) * (CW + 1) + x + 1];
            } else if (mode == M_IDENT) {
                v = p.pf[clampi(idx, 0, p.n3 - 1)];
            } else if (is_cfl(mode)) {
                const int diff = wmul(d[F_CFLA], wsub(it.out[y * CW + x], avg));
                const int mag = wadd(diff < 0 ? wneg(diff) : diff, 32) >> 6;
                v = clampi(wadd(dc, diff < 0 ? wneg(mag) : mag), 0, it.pxmax());
            } else {
                v = predict(it, mode, y, x, dc);
            }
            if (iioff >= 0) {
                const int own = p.pf[clampi(idx, 0, p.n3 - 1)];
                const int mi = wadd(wadd(wadd(p.mask_base, iioff), wmul(y, CW)), x);
                const int m = p.blob[clampi(mi, 0, p.blob_len - 1)];
                v = wadd(wadd(wmul(own, 64 - m), wmul(v, m)), 32) >> 6;
            }
            it.out[y * CW + x] = v;
        }
        return;
    }
    // the steps between: each mode's intermediates
    if (mode == M_Z1 || mode == M_Z3) {
        for (int i = t; i < Item<CW, CH>::LMAX; i += WV_THREADS)
            it.vec[i] = mode == M_Z1 ? z1_vec(it, i) : z3_vec(it, i);
    } else if (mode == M_Z2) {
        const int tl = z2_tl(it);
        for (int q = t; q < Item<CW, CH>::EL; q += WV_THREADS) it.vec[q] = z2_vec(it, q, tl);
    } else if (is_cfl(mode)) {
        // the subsampled luma at each pixel's clamped position
        // (cfl_ac_dyn), and its sum over the block
        const int ssh = p.ss_hor, ssv = p.ss_ver;
        const int sh = 1 + (ssv == 0) + (ssh == 0);
        const int vw = it.w - 4 * d[F_CFLWP], vh = it.h - 4 * d[F_CFLHP];
        int sum = 0;
        for (int q = t; q < npx; q += WV_THREADS) {
            const int y = q / it.ew, x = q - y * it.ew;
            const int pos = clampi(imin(y, vh - 1) * CW + imin(x, vw - 1), 0, CH * CW - 1);
            const int sy = pos / CW, sx = pos - sy * CW;
            int acc = 0;
            for (int dy = 0; dy <= ssv; dy++)
                for (int dx = 0; dx <= ssh; dx++) {
                    const int li = wadd(wadd(d[F_CFL0], wmul((sy << ssv) + dy, p.aw)),
                                        (sx << ssh) + dx);
                    acc = wadd(acc, p.pf[clampi(li, 0, p.n3 - 1)]);
                }
            acc = wmul(acc, 1 << sh);
            it.out[y * CW + x] = acc;
            sum = wadd(sum, acc);
        }
#ifdef __CUDA_ARCH__
        atomicAdd(sm + SM_DSC + F_SUM, sum);
#else
        sm[SM_DSC + F_SUM] = wadd(sm[SM_DSC + F_SUM], sum);
#endif
    } else if (mode == M_FILTER) {
        constexpr int FP = CW + 1;
        if (s == 2) {  // the work buffer's top row and left column
            for (int q = t; q < FP + CH; q += WV_THREADS) {
                if (q < FP) it.fbuf[q] = it.e[C + q];
                else it.fbuf[(q - CW) * FP] = it.e[C - (q - CW)];
            }
            return;
        }
        // anti-diagonal s - 3 of the 4x2 sub-blocks: one thread per output
        const int diag = s - 3;
        const int nxg = (it.ew + 3) >> 2, nyg = (it.eh + 1) >> 1;
        const int iy = imax(0, diag - (nxg - 1)) + (t >> 3), ix = diag - iy;
        if (iy >= nyg || ix < 0) return;
        const int k = t & 7;
        const int y = 2 * iy, x = 4 * ix;
        const int fi = clampi(d[F_ANGLES] & 511, 0, 4);
        const int* f = p.tab + T_FT + fi * 56 + k * 7;
        const int* b = it.fbuf;
        int acc = 0;
        for (int j = 0; j < 5; j++) acc = wadd(acc, wmul(WV_LD(f + j), b[y * FP + x + j]));
        acc = wadd(acc, wmul(WV_LD(f + 5), b[(y + 1) * FP + x]));
        acc = wadd(acc, wmul(WV_LD(f + 6), b[(y + 2) * FP + x]));
        it.fbuf[(y + 1 + (k >> 2)) * FP + x + 1 + (k & 3)] =
            clampi(wadd(acc, 8) >> 4, 0, it.pxmax());
    }
}

// thread block b of a launch: the small class's lanes, then the large's
WV_HD int row_of(const WaveFrame& p, int wave, int n_s, int b) {
    return b < n_s ? p.base_s + (wave * WV_CAP_S + b) * WV_FIELDS
                   : p.base_l + (wave * WV_CAP_L + b - n_s) * WV_FIELDS;
}

extern "C" int rav1d_wave_table_len(void) { return T_LEN; }

#ifdef __CUDACC__

template <int CW, int CH>
__device__ __forceinline__ void run_item(const WaveFrame& p, int row, int* sm) {
    item_step<CW, CH>(0, threadIdx.x, p, row, sm);
    __syncthreads();
    const int n = item_nsteps<CW, CH>(sm);
    for (int s = 1; s < n; s++) {
        item_step<CW, CH>(s, threadIdx.x, p, row, sm);
        if (s + 1 < n) __syncthreads();
    }
}

__global__ void __launch_bounds__(WV_THREADS)
wave_level_kernel(const __grid_constant__ WaveFrame p, int wave, int n_s) {
    __shared__ int sm[SM_WORDS];
    const int b = blockIdx.x;
    const int row = row_of(p, wave, n_s, b);
    if (b < n_s) run_item<16, 16>(p, row, sm);
    else run_item<64, 64>(p, row, sm);
}

// the same grid with no work: the launch path's own cost
__global__ void wave_empty_kernel(const __grid_constant__ WaveFrame p, int wave,
                                  int n_s) {}

// Plain C entries (bound with ctypes): one launch over level `wave`'s n_s
// small-class and n_l large-class items on `stream`. Return the launch's
// cudaGetLastError().
extern "C" int rav1d_wave_level(const WaveFrame* f, int wave, int n_s, int n_l,
                                void* stream) {
    if (n_s < 0 || n_l < 0 || n_s > WV_CAP_S || n_l > WV_CAP_L) return -1;
    if (n_s + n_l == 0) return 0;
    wave_level_kernel<<<n_s + n_l, WV_THREADS, 0, (cudaStream_t)stream>>>(*f, wave, n_s);
    return (int)cudaGetLastError();
}

extern "C" int rav1d_wave_empty(const WaveFrame* f, int wave, int n_s, int n_l,
                                void* stream) {
    if (n_s + n_l == 0) return 0;
    wave_empty_kernel<<<n_s + n_l, WV_THREADS, 0, (cudaStream_t)stream>>>(*f, wave, n_s);
    return (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

// One thread block on the host: each step for every thread in turn. The
// shared words start as a pattern, so a read of a word no step wrote shows.
template <int CW, int CH>
static void host_item(const WaveFrame& p, int row) {
    static int sm[SM_WORDS];
    for (int i = 0; i < SM_WORDS; i++) sm[i] = 0x5a5a5a5a;
    for (int t = 0; t < WV_THREADS; t++) item_step<CW, CH>(0, t, p, row, sm);
    const int n = item_nsteps<CW, CH>(sm);
    for (int s = 1; s < n; s++)
        for (int t = 0; t < WV_THREADS; t++) item_step<CW, CH>(s, t, p, row, sm);
}

// rav1d_wave_level's arguments without the stream: runs every thread block
// of the launch, in order, or from the last one back if `reverse`. Returns
// 0, or -1 for counts the kernel does not take.
extern "C" int rav1d_wave_level_host(const WaveFrame* f, int wave, int n_s,
                                     int n_l, int reverse) {
    if (n_s < 0 || n_l < 0 || n_s > WV_CAP_S || n_l > WV_CAP_L) return -1;
    const int nb = n_s + n_l;
    for (int i = 0; i < nb; i++) {
        const int b = reverse ? nb - 1 - i : i;
        const int row = row_of(*f, wave, n_s, b);
        if (b < n_s) host_item<16, 16>(*f, row);
        else host_item<64, 64>(*f, row);
    }
    return 0;
}

#endif  // __CUDACC__
