// The intra wavefront, CUDA C++ for sm_90a: every item of every level of a
// frame, both size classes and every prediction mode, in one persistent
// launch with a grid-wide barrier between the levels (rav1d_wave_frame);
// and the earlier form, one launch per level (rav1d_wave_level), which the
// tests and chip_smoke.py hold the frame kernel to and time it against.
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
// Both classes share a level: thread blocks [0, n_s) take the small
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
// chain: a 1080p frame has 1,600-2,500 levels, each of which waits for the
// one before. As one launch per level, on an H100 80GB HBM3, an empty
// kernel launched the same way took 3.9-4.8 us a level and the level
// kernel 5.9-7.9 us of device time, 10.6-15.3 ms per frame (PERF.md).
//
// The frame kernel takes the launches off that chain. One cooperative
// launch per frame (residency of the whole grid guaranteed, or the launch
// is refused) of G = the largest n_s + n_l over the frame's levels blocks,
// one block per SM; each block walks the levels 0..NW-1 that have items
// (the counts are lane 0's wcount of each class's rows in the blob, as
// mega.py reads them; a level with none is skipped by every block alike),
// runs its item of each level (block b: small item b, large item b - n_s,
// or none) and meets the others at a grid-wide barrier between the levels:
// a counter in device memory that only rises, zeroed per frame by the
// wrapper; a block arrives once per level (after a block barrier behind
// its stores, a release fence at device scope and a relaxed add, as
// CUTLASS's grid barrier arrives) and waits (an acquiring spin) until the
// count reaches G times its levels so far. A wait that outlasts ~2^31
// cycles traps, so a broken barrier fails the launch instead of hanging.
// What depends on no pixel is read ahead (frame_levels): the next level's
// number and counts, its descriptor row (loaded into a register per
// thread during the current level, stored to shared memory after the
// arrival) and, into registers (struct Pre), the residual and interintra
// mask words of the block's pixels, its edge coordinates and filter
// intra's taps; after the barrier only the edge read, the mode's steps,
// the blend, the residual add and the store remain. Every read of a plane
// word (the edge, IDENT's and interintra's own pixels, CfL's luma) goes
// through ld.global.cg (WV_PX): a persistent block keeps its SM's L1
// across levels, and a line cached there at one level may hold pixels
// another SM writes at a later one; .cg reads L2, where those writes land.
// A traced build (wave_trace_kernel) stamps each level's phases per block
// (chip_smoke.py wave_trace reads them); the barrier-only build
// (wave_barrier_kernel) walks the same levels with no item work.
//
// Design of the steps: 256 threads per block for either class; the
// threads of a block loop over the item's w x h pixels, x fastest
// (coalesced rows), in steps separated by block barriers: (0) the
// descriptor into shared memory; (1) the edge, and from its values filter
// intra's work buffer edge and the DC value's top and left sums (a warp
// reduction, then a shared atomic per warp), with CfL's subsampled luma
// and its sum, whose loads go out beside the edge's; then by mode:
// the Z1/Z3 filtered or upsampled edge vector, the Z2 combined edge, or
// one step per anti-diagonal of filter intra's 4x2 sub-blocks (run only
// by the warps that hold its longest diagonal, with a named barrier among
// them, each thread's taps and grid read once: FilterWalk); (n-2) the
// prediction into a shared (CH, CW) tile; (n-1) the interintra blend over
// the block's own pixels, the residual add, clip and store, each pixel by
// the thread that predicted it (a pixel's own value is read by the thread
// that then writes it). A thread starts all its plane loads of a step
// before its first store (a store through a plain pointer would hold the
// later loads back). The tables live in shared memory (once per frame in
// the frame kernel, per launch in the level kernel). Shared memory: 38.4
// KB per block, static. Both kernels run these same step functions
// (item_step, item_nsteps, row_of, run_steps); the frame kernel passes its
// read-ahead, the level kernel computes and reads the same words in the
// steps.
//
// Integer semantics: every add, subtract, multiply and negate that can
// leave int32 wraps (the frameworks' int32 arithmetic wraps; C++ signed
// overflow is undefined), computed in uint32_t; `>>` on negative values
// is arithmetic; sums wrap at int32, as the plain version's int32 sums do.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_wave_level_host and rav1d_wave_frame_host walk the same
// blocks with the same step functions, thread by thread, each barrier a
// loop boundary, for the CPU tests. The frame entry runs every block's
// read-ahead of level i+1 before any item of level i, so a read-ahead that
// touched a pixel would read it before level i writes it.

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

// a read of the tables, the blob or the residuals (read-only for the
// whole launch)
WV_HD int WV_LD(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// a read of a plane word, which an earlier level may have written: from
// L2, never from a line the SM's L1 kept
WV_HD int WV_PX(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldcg(p);
#else
    return *p;
#endif
}

#ifdef __CUDACC__
#define WV_UNROLL _Pragma("unroll")
#else
#define WV_UNROLL
#endif

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
// the row and column of pixel q >= 0 of a block ew > 0 wide: shifts when
// ew is a power of two (every AV1 block), a division otherwise
WV_HD void rowcol(int q, int ew, int& y, int& x) {
    if ((ew & (ew - 1)) == 0) {
#ifdef __CUDA_ARCH__
        y = q >> (__ffs(ew) - 1);
#else
        y = q >> __builtin_ctz((unsigned)ew);
#endif
        x = q & (ew - 1);
    } else {
        y = q / ew;
        x = q - y * ew;
    }
}

#define WV_THREADS 256
#define WV_FIELDS 21
#define WV_CAP_S 64   // engine/plan.py CAP
#define WV_CAP_L 16
#define WV_PRE (64 * 64 / WV_THREADS)  // a thread's pixels in a 64x64 item

// descriptor fields (engine/layout.py FIELDS)
enum {
    F_MODES, F_ANGLES, F_FLAT0, F_RMASK, F_Z2MW, F_Z2MH, F_Z2SM, F_CFLA,
    F_CFL0, F_CFLWP, F_CFLHP, F_W, F_H, F_IIOFF, F_WFLAGS, F_WCOUNT, F_HAV,
    F_PHL, F_PHBL, F_PHT, F_PHTR,
    // beside the fields in shared memory: the CfL ac sum, and the sums of
    // the top and left edge that the DC value reads (dc_value)
    F_SUM = WV_FIELDS, F_TSUM, F_LSUM
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
    int nw;           // the levels (hdr[WAVE0]); the frame kernel walks them
};

// What the frame kernel reads ahead of a level for one thread: the
// residual (0 where rmask is off or the pixel lies outside the planes) and
// the interintra mask word of each of its pixels q = t + k * WV_THREADS,
// the coordinates (edge_coord) of its edge positions, and filter intra's
// taps.
struct Pre {
    int r[WV_PRE];
    int m[WV_PRE];
    int ec[2];  // the edge coordinates of positions t and t + WV_THREADS
    int ft[7];  // filter intra's taps of output t & 7 (filter items only)
};

// shared memory words of one block, laid out for the large class
#define SM_DSC 0                      // the descriptor and the CfL sum
#define SM_EDGE 24                    // the edge, EL <= 257
#define SM_VEC (SM_EDGE + 260)        // Z1/Z3 vector (<= 256), Z2 edge
#define SM_OUT (SM_VEC + 260)         // (CH, CW) prediction / CfL ac
#define SM_FBUF (SM_OUT + 64 * 64)    // filter intra (CH + 1, CW + 1)
#define SM_TAB (SM_FBUF + 65 * 65)    // the tables (T_LEN)
#define SM_WORDS (SM_TAB + T_LEN)

// the tables into shared memory, thread t's share (before a block barrier)
WV_HD void tab_load(int* sm, const int* tab, int t) {
    for (int i = t; i < T_LEN; i += WV_THREADS) sm[SM_TAB + i] = WV_LD(tab + i);
}

// reads of the tables in shared memory (tab = sm + SM_TAB)
WV_HD int ctz_t(const int* tab, int v) { return tab[T_CTZ + clampi(v, 0, 256)]; }
WV_HD int dr_t(const int* tab, int i) { return tab[T_DR + clampi(i, 0, 43)]; }
WV_HD int sm_t(const int* tab, int i) { return tab[T_SM + clampi(i, 0, 127)]; }
WV_HD int ek_t(const int* tab, int fs, int j) {
    return tab[T_EK + 5 * (imax(fs, 1) - 1) + j];
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
    const int* tab; // the tables in shared memory
    int* e;         // the edge
    int* vec;
    int* out;
    int* fbuf;
    int w, h, ew, eh;  // block size; the part inside the class
    WV_MEM Item(const WaveFrame& p_, int* sm_)
        : p(p_), sm(sm_), d(sm_ + SM_DSC), tab(sm_ + SM_TAB), e(sm_ + SM_EDGE),
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
// CfL codes by their DC variant; any other code: DC), after the edge step
template <int CW, int CH>
WV_HD int dc_value(const Item<CW, CH>& it, int code) {
    const int* tab = it.tab;
    const int w = it.w, h = it.h;
    if (code == M_DC_128 || code == M_CFL_128) return (1 << it.p.bpc) >> 1;
    // the sums of top(i), i < clamp(w, 0, 2 CW), and of left(j),
    // j < clamp(h, 0, 2 CH), that the edge step made
    const int tsum = it.d[F_TSUM], lsum = it.d[F_LSUM];
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
    if (fs > 0) return i < wh ? filt5(it.tab, fs, taps) : taps[2];
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
        return filt5(it.tab, fs, taps);
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
        return (i_a >= 0 && i_a < it.d[F_Z2MW] && fs > 0) ? filt5(it.tab, fs, s) : s[2];
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
    return (i_l >= h - it.d[F_Z2MH] && i_l < h && fs > 0) ? filt5(it.tab, fs, s) : s[2];
}

// the interpolation between two samples at 1/64 positions
WV_HD int interp(int t0, int t1, int frac) {
    return wadd(wadd(wmul(t0, 64 - frac), wmul(t1, frac)), 32) >> 6;
}

// The prediction of pixel (y, x) for the non-buffered modes.
template <int CW, int CH>
WV_HD int predict(const Item<CW, CH>& it, int mode, int y, int x, int dc) {
    constexpr int C = Item<CW, CH>::C;
    const int* tab = it.tab;
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

// Filter intra's anti-diagonals of 4x2 sub-blocks (steps 2 .. 2 + n - 1),
// and the threads that compute them (8 per sub-block of the longest
// diagonal, in whole warps); valid after step 0.
template <int CW, int CH>
WV_HD int filter_diags(const int* sm) {
    const int ew = clampi(sm[SM_DSC + F_W], 0, CW);
    const int eh = clampi(sm[SM_DSC + F_H], 0, CH);
    return imax(((eh + 1) >> 1) + ((ew + 3) >> 2) - 1, 0);
}
template <int CW, int CH>
WV_HD int filter_threads(const int* sm) {
    const int ew = clampi(sm[SM_DSC + F_W], 0, CW);
    const int eh = clampi(sm[SM_DSC + F_H], 0, CH);
    const int most = imin((eh + 1) >> 1, (ew + 3) >> 2);
    return imin((8 * most + 31) & ~31, WV_THREADS);
}

// The number of steps of the item in shared memory (valid after step 0).
template <int CW, int CH>
WV_HD int item_nsteps(const int* sm) {
    const int mode = sm[SM_DSC + F_MODES];
    if (is_z(mode)) return 5;
    if (mode == M_FILTER) return 4 + filter_diags<CW, CH>(sm);
    return 4;
}

// the interintra mask word of pixel (y, x) of the item whose masks start
// at `iioff` (stored at the class width's stride)
template <int CW>
WV_HD int mask_word(const WaveFrame& p, int iioff, int y, int x) {
    const int mi = wadd(wadd(wadd(p.mask_base, iioff), wmul(y, CW)), x);
    return WV_LD(p.blob + clampi(mi, 0, p.blob_len - 1));
}

// The read-ahead of thread t for the item whose descriptor is in shared
// memory (after step 0): no plane word is read.
template <int CW, int CH>
WV_HD void item_pre(int t, const WaveFrame& p, int* sm, Pre& pre) {
    static_assert(CW * CH / WV_THREADS <= WV_PRE, "Pre holds a 64x64 item");
    const Item<CW, CH> it(p, sm);
    WV_UNROLL
    for (int k = 0; k < 2; k++)
        if (t + k * WV_THREADS < Item<CW, CH>::EL) pre.ec[k] = edge_coord(it, t + k * WV_THREADS);
    const int* d = sm + SM_DSC;
    const int ew = clampi(d[F_W], 0, CW), eh = clampi(d[F_H], 0, CH);
    const int npx = ew * eh;
    const int flat0 = d[F_FLAT0], rmask = d[F_RMASK] != 0, iioff = d[F_IIOFF];
    WV_UNROLL
    for (int k = 0; k < CW * CH / WV_THREADS; k++) {
        const int q = t + k * WV_THREADS;
        if (q >= npx) break;
        int y, x;
        rowcol(q, ew, y, x);
        const int idx = wadd(wadd(flat0, wmul(y, p.aw)), x);
        pre.r[k] = rmask && idx >= 0 && idx < p.n3 ? WV_LD(p.ra + idx) : 0;
        pre.m[k] = iioff >= 0 ? mask_word<CW>(p, iioff, y, x) : 0;
    }
    if (d[F_MODES] == M_FILTER) {
        const int fi = clampi(d[F_ANGLES] & 511, 0, 4);
        for (int j = 0; j < 7; j++) pre.ft[j] = sm[SM_TAB + T_FT + fi * 56 + (t & 7) * 7 + j];
    }
}

// What filter intra's anti-diagonal steps of thread t read, once per item:
// the sub-block grid, the output's taps, the work buffer.
struct FilterWalk {
    int nxg, nyg, k, pxmax;
    int tap[7];
    int* fbuf;
};

template <int CW, int CH>
WV_HD FilterWalk filter_walk(const Item<CW, CH>& it, int t, const Pre* pre) {
    FilterWalk fw;
    fw.nxg = (it.ew + 3) >> 2;
    fw.nyg = (it.eh + 1) >> 1;
    fw.k = t & 7;
    fw.pxmax = it.pxmax();
    fw.fbuf = it.fbuf;
    const int fi = clampi(it.d[F_ANGLES] & 511, 0, 4);
    const int* f = it.tab + T_FT + fi * 56 + fw.k * 7;
    for (int j = 0; j < 7; j++) fw.tap[j] = pre ? pre->ft[j] : f[j];
    return fw;
}

// anti-diagonal `diag` of filter intra's 4x2 sub-blocks: one thread per
// output (8 per sub-block)
template <int CW>
WV_HD void filter_diag(const FilterWalk& fw, int diag, int t) {
    constexpr int FP = CW + 1;
    const int iy = imax(0, diag - (fw.nxg - 1)) + (t >> 3), ix = diag - iy;
    if (iy >= fw.nyg || ix < 0) return;
    const int k = fw.k, y = 2 * iy, x = 4 * ix;
    const int* b = fw.fbuf;
    int acc = 0;
    for (int j = 0; j < 5; j++) acc = wadd(acc, wmul(fw.tap[j], b[y * FP + x + j]));
    acc = wadd(acc, wmul(fw.tap[5], b[(y + 1) * FP + x]));
    acc = wadd(acc, wmul(fw.tap[6], b[(y + 2) * FP + x]));
    fw.fbuf[(y + 1 + (k >> 2)) * FP + x + 1 + (k & 3)] = clampi(wadd(acc, 8) >> 4, 0, fw.pxmax);
}

// Step 0, the descriptor into shared memory, in its two halves: the word
// thread t loads from the row at blob word `row`, and its store (with the
// zeros of the sums beside it).
WV_HD int desc_load(const WaveFrame& p, int row, int t) {
    return t < WV_FIELDS ? p.blob[row + t] : 0;
}
WV_HD void desc_store(int* sm, int t, int w) {
    if (t < WV_FIELDS) sm[SM_DSC + t] = w;
    if (t >= F_SUM && t <= F_LSUM) sm[SM_DSC + t] = 0;
}

// *sum += v over the block's threads (int32, wrapping): a warp's values
// summed by a shuffle reduction, then one shared atomic per warp
WV_HD void block_add(int* sum, int v) {
#ifdef __CUDA_ARCH__
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) atomicAdd(sum, v);
#else
    *sum = wadd(*sum, v);
#endif
}

// CfL's subsampled luma at each pixel's clamped position (cfl_ac_dyn) into
// the (CH, CW) tile, and its sum over the block (shared atomics). Every
// luma load of the thread is started before the first store to the tile (a
// store through a plain pointer would hold back the loads after it).
template <int CW, int CH>
WV_HD void cfl_luma(const Item<CW, CH>& it, int t, int* sm) {
    constexpr int KP = CW * CH / WV_THREADS;
    const WaveFrame& p = it.p;
    const int* d = it.d;
    const int npx = it.ew * it.eh;
    const int ssh = p.ss_hor, ssv = p.ss_ver;
    const int sh = 1 + (ssv == 0) + (ssh == 0);
    const int vw = it.w - 4 * d[F_CFLWP], vh = it.h - 4 * d[F_CFLHP];
    int acc[KP];
    WV_UNROLL
    for (int k = 0; k < KP; k++) {
        const int q = t + k * WV_THREADS;
        if (q >= npx) break;
        int y, x;
        rowcol(q, it.ew, y, x);
        const int pos = clampi(imin(y, vh - 1) * CW + imin(x, vw - 1), 0, CH * CW - 1);
        const int sy = pos / CW, sx = pos - sy * CW;
        int a = 0;
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++) {
                if (dy > ssv || dx > ssh) continue;
                const int li = wadd(wadd(d[F_CFL0], wmul((sy << ssv) + dy, p.aw)),
                                    (sx << ssh) + dx);
                a = wadd(a, WV_PX(p.pf + clampi(li, 0, p.n3 - 1)));
            }
        acc[k] = wmul(a, 1 << sh);
    }
    int sum = 0;
    WV_UNROLL
    for (int k = 0; k < KP; k++) {
        const int q = t + k * WV_THREADS;
        if (q >= npx) break;
        int y, x;
        rowcol(q, it.ew, y, x);
        it.out[y * CW + x] = acc[k];
        sum = wadd(sum, acc[k]);
    }
#ifdef __CUDA_ARCH__
    atomicAdd(sm + SM_DSC + F_SUM, sum);
#else
    sm[SM_DSC + F_SUM] = wadd(sm[SM_DSC + F_SUM], sum);
#endif
}

// Step s of thread t in the block of the item whose descriptor row starts
// at blob word `row`. The steps run in order, each finished by every
// thread before the next begins. `pre` is the thread's read-ahead (the
// frame kernel), or null: the store step then reads the residual and the
// mask itself (the level kernel).
template <int CW, int CH>
WV_HD void item_step(int s, int t, const WaveFrame& p, int row, int* sm,
                     const Pre* pre = nullptr) {
    if (s == 0) {
        desc_store(sm, t, desc_load(p, row, t));
        return;
    }
    const Item<CW, CH> it(p, sm);
    constexpr int C = Item<CW, CH>::C;
    const int* d = it.d;
    const int mode = d[F_MODES];
    const int n = item_nsteps<CW, CH>(sm);
    const int npx = it.ew * it.eh;
    if (s == 1) {  // the edge, and what needs it no sooner than its values
        constexpr int EL = Item<CW, CH>::EL;
        constexpr int FP = CW + 1;
        static_assert(EL <= 2 * WV_THREADS, "Pre holds two edge positions");
        const int nt = clampi(it.w, 0, 2 * CW), nl = clampi(it.h, 0, 2 * CH);
        int tsum = 0, lsum = 0, ev[2];
        WV_UNROLL
        for (int k = 0; k < 2; k++) {  // the edge loads, in flight together
            const int q = t + k * WV_THREADS;
            if (q >= EL) break;
            const int c = pre ? pre->ec[k] : edge_coord(it, q);
            ev[k] = c < 0 ? wsub(wneg(c), 1) : WV_PX(p.pf + clampi(c, 0, p.n3 - 1));
        }
        if (is_cfl(mode)) cfl_luma(it, t, sm);  // CfL's luma: its loads join them
        WV_UNROLL
        for (int k = 0; k < 2; k++) {
            const int q = t + k * WV_THREADS;
            if (q >= EL) break;
            const int v = ev[k];
            it.e[q] = v;
            if (mode == M_FILTER) {  // filter intra's work buffer: top row, left column
                if (q >= C && q <= C + CW) it.fbuf[q - C] = v;
                else if (q >= C - CH && q < C) it.fbuf[(C - q) * FP] = v;
            }
            if (q > C && q <= C + nt) tsum = wadd(tsum, v);  // top(q - C - 1)
            if (q < C && q >= C - nl) lsum = wadd(lsum, v);  // left(C - 1 - q)
        }
        if (uses_dc(mode)) {  // the DC value's sums (dc_value)
            block_add(sm + SM_DSC + F_TSUM, tsum);
            block_add(sm + SM_DSC + F_LSUM, lsum);
        }
        return;
    }
    if (s == n - 1) {  // interintra blend, residual add, clip, store
        constexpr int KP = CW * CH / WV_THREADS;
        const int flat0 = d[F_FLAT0], rmask = d[F_RMASK] != 0;
        const int iioff = d[F_IIOFF];
        const int pxmax = it.pxmax();
        int own[KP];  // interintra's own pixels, all loads started before a store
        if (iioff >= 0) {
            WV_UNROLL
            for (int k = 0; k < KP; k++) {
                const int q = t + k * WV_THREADS;
                if (q >= npx) break;
                int y, x;
                rowcol(q, it.ew, y, x);
                const int idx = wadd(wadd(flat0, wmul(y, p.aw)), x);
                own[k] = idx >= 0 && idx < p.n3 ? WV_PX(p.pf + idx) : 0;
            }
        }
        WV_UNROLL
        for (int k = 0; k < KP; k++) {
            const int q = t + k * WV_THREADS;
            if (q >= npx) break;
            int y, x;
            rowcol(q, it.ew, y, x);
            const int idx = wadd(wadd(flat0, wmul(y, p.aw)), x);
            if (idx < 0 || idx >= p.n3) continue;
            int v = it.out[y * CW + x];
            if (iioff >= 0) {
                const int m = pre ? pre->m[k] : mask_word<CW>(p, iioff, y, x);
                v = wadd(wadd(wmul(own[k], 64 - m), wmul(v, m)), 32) >> 6;
            }
            if (rmask) v = clampi(wadd(v, pre ? pre->r[k] : p.ra[idx]), 0, pxmax);
            p.pf[idx] = v;
        }
        return;
    }
    if (s == n - 2 && mode == M_IDENT) {  // the prediction: its own pixels
        constexpr int KP = CW * CH / WV_THREADS;
        const int flat0 = d[F_FLAT0];
        int own[KP];  // every load started before a store to the tile
        WV_UNROLL
        for (int k = 0; k < KP; k++) {
            const int q = t + k * WV_THREADS;
            if (q >= npx) break;
            int y, x;
            rowcol(q, it.ew, y, x);
            own[k] = WV_PX(p.pf + clampi(wadd(wadd(flat0, wmul(y, p.aw)), x), 0, p.n3 - 1));
        }
        WV_UNROLL
        for (int k = 0; k < KP; k++) {
            const int q = t + k * WV_THREADS;
            if (q >= npx) break;
            int y, x;
            rowcol(q, it.ew, y, x);
            it.out[y * CW + x] = own[k];
        }
        return;
    }
    if (s == n - 2) {  // the prediction
        const int dc = uses_dc(mode) ? dc_value(it, mode) : 0;
        int avg = 0;
        if (is_cfl(mode)) {
            const int l2 = ctz_t(it.tab, it.w) + ctz_t(it.tab, it.h);
            avg = wadd((1 << l2) >> 1, d[F_SUM]) >> l2;
        }
        for (int q = t; q < npx; q += WV_THREADS) {
            int y, x;
            rowcol(q, it.ew, y, x);
            int v;
            if (mode == M_FILTER) {
                v = it.fbuf[(y + 1) * (CW + 1) + x + 1];
            } else if (is_cfl(mode)) {
                const int diff = wmul(d[F_CFLA], wsub(it.out[y * CW + x], avg));
                const int mag = wadd(diff < 0 ? wneg(diff) : diff, 32) >> 6;
                v = clampi(wadd(dc, diff < 0 ? wneg(mag) : mag), 0, it.pxmax());
            } else {
                v = predict(it, mode, y, x, dc);
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
    } else if (mode == M_FILTER) {
        filter_diag<CW>(filter_walk(it, t, pre), s - 2, t);
    }
}

// thread block b of a level: the small class's lanes, then the large's
WV_HD int row_of(const WaveFrame& p, int wave, int n_s, int b) {
    return b < n_s ? p.base_s + (wave * WV_CAP_S + b) * WV_FIELDS
                   : p.base_l + (wave * WV_CAP_L + b - n_s) * WV_FIELDS;
}

// the blob word of level j's class-`cls` item count (lane 0's wcount)
WV_HD const int* count_at(const WaveFrame& p, int j, int cls) {
    return p.blob + (cls ? p.base_l + j * WV_CAP_L * WV_FIELDS
                         : p.base_s + j * WV_CAP_S * WV_FIELDS) + F_WCOUNT;
}

// The first level after `lvl` with items, and its counts (clamped to each
// class's cap); p.nw if none is left.
WV_HD int next_level(const WaveFrame& p, int lvl, int* n_s, int* n_l) {
    for (int j = lvl + 1; j < p.nw; j++) {
        *n_s = clampi(WV_LD(count_at(p, j, 0)), 0, WV_CAP_S);
        *n_l = clampi(WV_LD(count_at(p, j, 1)), 0, WV_CAP_L);
        if (*n_s + *n_l) return j;
    }
    *n_s = *n_l = 0;
    return p.nw;
}

extern "C" int rav1d_wave_table_len(void) { return T_LEN; }

#ifdef __CUDACC__

// The traced frame kernel's clock stamps (clock64 of thread 0, after a
// block barrier), per level with items and block: the level's start (its
// wait returned), the edge built (step 1), the prediction done (before
// the store step), the stores done, the read-ahead of the next level done
// (before the wait for it), and (by the arriving thread) the arrival.
enum { ST_START, ST_EDGE, ST_PRED, ST_STORE, ST_AHEAD, ST_ARRIVED, WV_STAMPS };

__device__ __forceinline__ void stamp(long long* st, int k, int by = 0) {
    if (st && threadIdx.x == by) st[k] = clock64();
}

__device__ __forceinline__ int next_desc(const WaveFrame& p, const int* ctl, int b, int t);

// Steps 1.. of the item whose descriptor is in shared memory, each
// followed by a block barrier, but for filter intra's anti-diagonals:
// only the threads that compute them run them, with a named barrier
// (id 1) among themselves, and one block barrier after the last. `pre`:
// the frame kernel's read-ahead, or null (the level kernel). With `ctl`,
// each thread loads its word of the next level's descriptor into `*dw`
// after the edge step.
template <int CW, int CH>
__device__ __forceinline__ void run_steps(const WaveFrame& p, int row, int* sm,
                                          const Pre* pre, const int* ctl, int b,
                                          int* dw, long long* st) {
    const int t = threadIdx.x;
    const int n = item_nsteps<CW, CH>(sm);
    for (int s = 1; s < n; s++) {
        if (s == 2 && n > 4 && sm[SM_DSC + F_MODES] == M_FILTER) {
            const int nd = n - 4, nt = filter_threads<CW, CH>(sm);
            if (t < nt) {  // item_step's diagonal steps, their walk made once
                const FilterWalk fw = filter_walk(Item<CW, CH>(p, sm), t, pre);
                for (int k = 0; k < nd; k++) {
                    filter_diag<CW>(fw, k, t);
                    asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
                }
            }
            __syncthreads();
            s += nd - 1;  // on to step n - 2
            continue;
        }
        item_step<CW, CH>(s, t, p, row, sm, pre);
        if (s + 1 < n) __syncthreads();
        if (s == 1) {
            stamp(st, ST_EDGE);
            if (ctl) *dw = next_desc(p, ctl, b, t);
        }
        if (s == n - 2) stamp(st, ST_PRED);
    }
}

template <int CW, int CH>
__device__ __forceinline__ void run_item(const WaveFrame& p, int row, int* sm) {
    tab_load(sm, p.tab, threadIdx.x);
    item_step<CW, CH>(0, threadIdx.x, p, row, sm);
    __syncthreads();
    run_steps<CW, CH>(p, row, sm, nullptr, nullptr, 0, nullptr, nullptr);
}

// one block per SM is all a level (at most 80 blocks) or a frame needs:
// the bound lets ptxas give each thread the registers of its read-ahead
__global__ void __launch_bounds__(WV_THREADS, 1)
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

// ---- the frame kernel ----

#define WV_SPIN_CYCLES (1ll << 31)  // ~1 s at 1.98 GHz: far above any level

// Arrive at the grid barrier, after a block barrier that follows every
// store of the level: a release fence at device scope, then the count's
// add (CUTLASS's grid barrier arrives so), by a thread of warp 1, so that
// warp 0's read-ahead does not wait for it.
#define WV_ARRIVER 32
__device__ __forceinline__ void grid_arrive(int* bar, long long* st) {
    if (threadIdx.x == WV_ARRIVER) {
        asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.s32 [%0], %1;"
                     ::"l"(bar), "r"(1) : "memory");
        stamp(st, ST_ARRIVED, WV_ARRIVER);
    }
}

// Wait until `target` arrivals: one thread spins on an acquiring load,
// then the block barrier hands the order on to every thread.
__device__ __forceinline__ void grid_wait(const int* bar, int target) {
    if (threadIdx.x == 0) {
        const long long t0 = clock64();
        for (;;) {
            int v;
            asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
            if (v >= target) break;
            if (clock64() - t0 > WV_SPIN_CYCLES) __trap();
        }
    }
    __syncthreads();
}

// thread t's descriptor word of block b's item in the level whose number
// and counts are in `ctl` (0 if the block has none there)
__device__ __forceinline__ int next_desc(const WaveFrame& p, const int* ctl, int b, int t) {
    return ctl[0] < p.nw && b < ctl[1] + ctl[2] ? desc_load(p, row_of(p, ctl[0], ctl[1], b), t)
                                                 : 0;
}

// Every level of the frame; without WORK only the level walk and the
// barriers (the dependency floor). With `clk`, the stamps of item level m
// and block b at clk[(m * gridDim.x + b) * WV_STAMPS].
//
// The read-ahead is spread so that what follows a block's arrival is short
// (the last block to arrive starts the next level only when it is done):
// thread 0 learns the next level's number and counts (next_level) while
// the block waits at the barrier before the current level, and publishes
// them in `ctl` at the level's start; after the edge step each thread
// loads its word of the next level's descriptor into a register (dw);
// after the arrival the block stores it, thread 0 looks up the level
// after, and each thread starts its Pre loads, then the block waits.
template <bool WORK>
__device__ __forceinline__ void frame_levels(const WaveFrame& p, int* bar, int* sm,
                                             int* ctl, long long* clk) {
    const int b = blockIdx.x, t = threadIdx.x, G = gridDim.x;
    Pre pre;
    int nx = 0, nx_s = 0, nx_l = 0;  // thread 0: the item level after `lvl`
    if (WORK) tab_load(sm, p.tab, t);  // once per frame
    if (t == 0) {
        ctl[0] = next_level(p, -1, &ctl[1], &ctl[2]);
        if (ctl[1] + ctl[2] > G) __trap();  // a grid smaller than a level
    }
    __syncthreads();
    int lvl = ctl[0], n_s = ctl[1], n_l = ctl[2], arrived = 0;
    int dw = WORK ? next_desc(p, ctl, b, t) : 0;
    long long* prev = nullptr;
    while (lvl < p.nw) {
        const bool item = WORK && b < n_s + n_l;
        long long* st = clk ? clk + ((long long)arrived * G + b) * WV_STAMPS : nullptr;
        // the read-ahead of level lvl
        if (item) desc_store(sm, t, dw);
        if (t == 0) {
            nx = next_level(p, lvl, &nx_s, &nx_l);
            if (nx_s + nx_l > G) __trap();
        }
        __syncthreads();
        if (item) {
            if (b < n_s) item_pre<16, 16>(t, p, sm, pre);
            else item_pre<64, 64>(t, p, sm, pre);
        }
        stamp(prev, ST_AHEAD);
        if (arrived) grid_wait(bar, arrived * G);
        // level lvl
        stamp(st, ST_START);
        if (t == 0) {
            ctl[0] = nx;
            ctl[1] = nx_s;
            ctl[2] = nx_l;
        }
        if (item) {
            const int row = row_of(p, lvl, n_s, b);
            if (b < n_s) run_steps<16, 16>(p, row, sm, &pre, ctl, b, &dw, st);
            else run_steps<64, 64>(p, row, sm, &pre, ctl, b, &dw, st);
        } else {
            __syncthreads();
            if (WORK) dw = next_desc(p, ctl, b, t);
            stamp(st, ST_EDGE);
            stamp(st, ST_PRED);
        }
        __syncthreads();
        stamp(st, ST_STORE);
        grid_arrive(bar, st);
        arrived++;
        lvl = ctl[0];
        n_s = ctl[1];
        n_l = ctl[2];
        prev = st;
    }
    stamp(prev, ST_AHEAD);
}

__global__ void __launch_bounds__(WV_THREADS, 1)
wave_frame_kernel(const __grid_constant__ WaveFrame p, int* bar) {
    __shared__ int sm[SM_WORDS];
    __shared__ int ctl[3];
    frame_levels<true>(p, bar, sm, ctl, nullptr);
}

// the frame kernel with its clock stamps, for measurement
__global__ void __launch_bounds__(WV_THREADS, 1)
wave_trace_kernel(const __grid_constant__ WaveFrame p, int* bar, long long* clk) {
    __shared__ int sm[SM_WORDS];
    __shared__ int ctl[3];
    frame_levels<true>(p, bar, sm, ctl, clk);
}

__global__ void __launch_bounds__(WV_THREADS)
wave_barrier_kernel(const __grid_constant__ WaveFrame p, int* bar) {
    __shared__ int ctl[3];
    frame_levels<false>(p, bar, nullptr, ctl, nullptr);
}

// Plain C entries (bound with ctypes). Return the launch's error code.

// One launch over level `wave`'s n_s small-class and n_l large-class items
// on `stream`.
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

static int launch_frame(const void* kernel, const WaveFrame* f, int grid, int* bar,
                        long long* clk, void* stream) {
    if (grid < 1 || grid > WV_CAP_S + WV_CAP_L) return -1;
    void* args[] = {(void*)f, (void*)&bar, (void*)&clk};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        kernel, dim3(grid), dim3(WV_THREADS), args, 0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// One cooperative launch of `grid` blocks over every level of the frame;
// `bar` is one int32 in device memory, 0 at the launch.
extern "C" int rav1d_wave_frame(const WaveFrame* f, int grid, int* bar, void* stream) {
    return launch_frame((const void*)wave_frame_kernel, f, grid, bar, nullptr, stream);
}

// the same grid, levels and barriers with no item work
extern "C" int rav1d_wave_barriers(const WaveFrame* f, int grid, int* bar, void* stream) {
    return launch_frame((const void*)wave_barrier_kernel, f, grid, bar, nullptr, stream);
}

// rav1d_wave_frame with the clock stamps of every item level and block in
// `clk` (levels x grid x WV_STAMPS int64)
extern "C" int rav1d_wave_trace(const WaveFrame* f, int grid, int* bar, long long* clk,
                                void* stream) {
    return launch_frame((const void*)wave_trace_kernel, f, grid, bar, clk, stream);
}

extern "C" int rav1d_wave_stamps(void) { return WV_STAMPS; }

#else  // a host build of the same functions, for the CPU tests

#include <utility>
#include <vector>

// One thread block on the host: each step for every thread in turn. The
// shared words start as a pattern, so a read of a word no step wrote shows.
template <int CW, int CH>
static void host_item(const WaveFrame& p, int row) {
    static int sm[SM_WORDS];
    for (int i = 0; i < SM_WORDS; i++) sm[i] = 0x5a5a5a5a;
    for (int t = 0; t < WV_THREADS; t++) {
        tab_load(sm, p.tab, t);
        item_step<CW, CH>(0, t, p, row, sm);
    }
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

// A frame-kernel block's state between its read-ahead and its item: the
// descriptor words of its shared memory and each thread's Pre.
struct HostBlock {
    int dsc[SM_EDGE];
    Pre pre[WV_THREADS];
};

// The frame kernel's read-ahead on the host, for every block (in the
// order `reverse` gives): the next level after `lvl` and, for each block
// with an item in it, step 0 and item_pre into its HostBlock. Returns the
// level; -1 for a level with more items than blocks.
static int host_read_ahead(const WaveFrame& p, int lvl, int grid, int reverse,
                           std::vector<HostBlock>& blk, int* n_s, int* n_l) {
    static int sm[SM_WORDS];
    const int next = next_level(p, lvl, n_s, n_l);
    if (*n_s + *n_l > grid) return -1;
    for (int i = 0; i < grid; i++) {
        const int b = reverse ? grid - 1 - i : i;
        HostBlock& hb = blk[b];
        for (int w = 0; w < SM_WORDS; w++) sm[w] = 0x5a5a5a5a;
        for (int t = 0; t < WV_THREADS; t++) tab_load(sm, p.tab, t);
        if (next < p.nw && b < *n_s + *n_l) {
            const int row = row_of(p, next, *n_s, b);
            for (int t = 0; t < WV_THREADS; t++) desc_store(sm, t, desc_load(p, row, t));
            for (int t = 0; t < WV_THREADS; t++) {
                if (b < *n_s) item_pre<16, 16>(t, p, sm, hb.pre[t]);
                else item_pre<64, 64>(t, p, sm, hb.pre[t]);
            }
        }
        for (int w = 0; w < SM_EDGE; w++) hb.dsc[w] = sm[SM_DSC + w];
    }
    return next;
}

template <int CW, int CH>
static void host_steps(const WaveFrame& p, int row, const HostBlock& hb) {
    static int sm[SM_WORDS];
    for (int i = 0; i < SM_WORDS; i++) sm[i] = 0x5a5a5a5a;
    for (int t = 0; t < WV_THREADS; t++) tab_load(sm, p.tab, t);
    for (int w = 0; w < SM_EDGE; w++) sm[SM_DSC + w] = hb.dsc[w];
    const int n = item_nsteps<CW, CH>(sm);
    for (int s = 1; s < n; s++)
        for (int t = 0; t < WV_THREADS; t++)
            item_step<CW, CH>(s, t, p, row, sm, &hb.pre[t]);
}

// rav1d_wave_frame's arguments without the barrier word and the stream:
// walks the levels as the frame kernel does, and runs every block's
// read-ahead of the next level before any item of the current one; the
// blocks of a level in order, or from the last one back if `reverse`.
// Returns 0, or -1 for a grid the kernel does not take.
extern "C" int rav1d_wave_frame_host(const WaveFrame* f, int grid, int reverse) {
    if (grid < 1 || grid > WV_CAP_S + WV_CAP_L) return -1;
    const WaveFrame& p = *f;
    std::vector<HostBlock> cur(grid), nxt(grid);
    int n_s, n_l, m_s, m_l;
    int lvl = host_read_ahead(p, -1, grid, reverse, cur, &n_s, &n_l);
    while (lvl >= 0 && lvl < p.nw) {
        const int next = host_read_ahead(p, lvl, grid, reverse, nxt, &m_s, &m_l);
        if (next < 0) return -1;
        for (int i = 0; i < grid; i++) {
            const int b = reverse ? grid - 1 - i : i;
            if (b >= n_s + n_l) continue;
            const int row = row_of(p, lvl, n_s, b);
            if (b < n_s) host_steps<16, 16>(p, row, cur[b]);
            else host_steps<64, 64>(p, row, cur[b]);
        }
        std::swap(cur, nxt);
        lvl = next;
        n_s = m_s;
        n_l = m_l;
    }
    return lvl < 0 ? -1 : 0;
}

// The levels the frame kernel walks: (level, n_s, n_l) triples into `out`
// (room for `cap`); returns how many there are.
extern "C" int rav1d_wave_frame_levels_host(const WaveFrame* f, int* out, int cap) {
    int n = 0, n_s, n_l;
    for (int lvl = next_level(*f, -1, &n_s, &n_l); lvl < f->nw;
         lvl = next_level(*f, lvl, &n_s, &n_l), n++) {
        if (n < cap) {
            out[3 * n] = lvl;
            out[3 * n + 1] = n_s;
            out[3 * n + 2] = n_l;
        }
    }
    return n;
}

#endif  // __CUDACC__
