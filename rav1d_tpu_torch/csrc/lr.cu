// Loop restoration, CUDA C++ for sm_90a: every Wiener stripe of every plane
// in one launch a frame (rav1d_lr_wiener_frame; the earlier form,
// rav1d_lr_wiener, takes a plane a launch and stays for comparison), every
// self-guided stripe of all three kinds of every plane in one launch a
// frame (rav1d_lr_sgr_frame; the earlier form, rav1d_lr_sgr, takes a plane a
// launch and stays for comparison).
//
// Replaces the XLA device kernels the JAX engine runs per (kind, plane)
// slot: rav1d_tpu/engine/filters.py _gather_stripes (:212), _lr_scatter
// (:234) and lr_wiener_pass_raw (:246) over rav1d_tpu/ops/tpu/lr.py
// wiener_batch (:21), and lr_sgr_pass_raw (:253) over sgr_batch (:156)
// with _selfguided (:85), _boxsum (:52) and _mul_shift_exact (:76), called
// by rav1d_tpu/engine/mega.py filter_prog (:678). The port's plain
// versions are engine/filters.py gather_stripes, lr_scatter,
// lr_wiener_pass and lr_sgr_pass over ops/lr.py wiener_batch and
// sgr_batch (engine/programs.py filter_plain); these kernels compute
// exactly what they compute.
//
// What the plain version computes, per stripe of a slot (16 descriptor
// rows S_* of engine/filters.py, LRB stripes per chunk in the blob): a
// 70-row tile of W + 6 columns gathered from cat = [the post-CDEF plane's
// first ph rows; the pre-CDEF plane's first ph rows]: tile rows 0-1 from
// row TOP0, 2 from TOP1, 3 .. 3 + h - 1 the stripe's rows y0 + i - 3
// (clamped to [0, h - 1]), 3 + h from BOT0 and the rest from BOT1 (a row
// >= ph is the pre-CDEF plane's row - ph; rows clamped to [0, 2 ph - 1]);
// column c from x0 - 3 + c clamped to [XLO, XHI] and then to the plane.
// Then the 7-tap Wiener filter (horizontal into a clipped intermediate,
// then vertical; the 12-bit rounding shifts differ) or the self-guided
// filter: 5x5 (n = 25) and/or 3x3 (n = 9) box sums of the tile and of its
// squares, per row of the filter's row set the scaled variance p, the
// index z = (p * s + 2^19) >> 20 (exact: a 13-bit split in int32), x =
// sgr_x_by_x[min(z, 255)] and the two tables A (from x * sum, at 164 or
// 455 over 2^12) and B = x; then per pixel the 6/5 (5x5: even rows from
// the rows above and below, odd rows from their own) or 4/3 (3x3)
// weighted neighbourhoods, their difference with the pixel, and the
// weighted sum of the filters' outputs added to the pixel and clipped.
// The outputs of rows < min(h, 64) and columns < min(S_W, W) are written
// to the plane at (y0 + r) * aw + x0 + c, where that lies in the plane.
// Every intermediate is int32 arithmetic that wraps as the frameworks'
// does (computed in uint32 here; C++ signed overflow is undefined).
//
// Design (the earlier forms and the self-guided frame entry; the Wiener
// frame entry below, at LrWienerSm): one thread block per (stripe, 32
// output columns), 256 threads;
// blocks past the stripe's h or width return at once. The block gathers
// its tile (70 x 38 words) straight from the two planes through the
// stripe's row and column maps (no concatenated copy of the planes), into
// shared memory, with the table; Wiener: the horizontal pass into a
// shared 70 x 32 intermediate, then the vertical pass and the store;
// self-guided: the A and B tables of its filters (5x5: 33 rows, 3x3: 66
// rows, 34 columns) into shared memory, then each pixel and the store. A
// self-guided launch takes the three kinds' regions of the plane, the
// kind of a stripe given by its region; the frame entry takes every
// plane's, 384 threads a block, with separable box sums (below, at
// LrFrame). The output is a separate plane
// (the program's copy of the planes), so no stripe reads a pixel another
// wrote. The kernel covers the stripe's own width, not the padded bucket
// W (a TPU compile-key artifact): the columns it leaves are ones the
// plain version drops.
//
// Bound on this card: bytes for Wiener, operations for the self-guided
// filter. A plane's stripes read their rows once plus 6 rows of context
// and write them once: about 2.1 planes' words moved, 17.5 MB for 1080p
// luma if every unit restores, 5 us at 3.35 TB/s; the self-guided box sums
// and table steps (about 60 int32 operations per pixel for one filter,
// 120 for the mixed kind) take 0.0005-0.018 ms of the card's 16.7 T/s on
// the 1080p test frames (chip_smoke.py filter_work). On an H100 80GB
// HBM3 the self-guided frame entry took 0.013-0.060 ms of device time
// there, the earlier form's three launches 0.025-0.065 ms (PERF.md): the
// gather and the A/B step's arithmetic and weighted sums hold it, not the
// box sums. The earlier Wiener form's launches took 0.026-0.038 ms a frame,
// 6-15x their bytes bound: three serial launches of one wave of blocks
// each, a per-pixel gather, and seven shared reads per intermediate.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_lr_wiener_host, rav1d_lr_wiener_frame_host,
// rav1d_lr_sgr_host and rav1d_lr_sgr_frame_host walk the same blocks with
// the same step functions, thread by thread, each barrier a loop boundary,
// for the CPU tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LR_HD __host__ __device__ __forceinline__
#define LR_CONST __constant__
#else
#define LR_HD static inline
#define LR_CONST static const
#endif

enum {
    LR_THREADS = 256,
    LR_FRAME_THREADS = 384,  // the one-launch self-guided kernel's: 12 warps a block
    LR_LRB = 64,      // stripes per descriptor chunk (engine/layout.py LRB)
    LR_ROWS = 70,     // tile rows: 64 + 6
    LR_CW = 32,       // output columns per block
    LR_TC = LR_CW + 6,  // tile columns per block
    LR_AC = LR_CW + 2,  // A and B table columns per block
    LR_R5 = 33,       // 5x5 table rows: 1, 3, .., 65
    LR_R3 = 66,       // 3x3 table rows: 1 .. 66
};

// descriptor rows (engine/filters.py S_*)
enum { S_X0, S_Y0, S_W, S_H, S_XLO, S_XHI, S_TOP0, S_TOP1, S_BOT0, S_BOT1, S_P0 };

// sgr_x_by_x (engine/consts.py, from the spec tables)
LR_CONST int LR_X_BY_X[256] = {
    255, 128,  85,  64,  51,  43,  37,  32,  28,  26,  23,  21,  20,  18,  17,  16,
     15,  14,  13,  13,  12,  12,  11,  11,  10,  10,   9,   9,   9,   9,   8,   8,
      8,   8,   7,   7,   7,   7,   7,   6,   6,   6,   6,   6,   6,   6,   5,   5,
      5,   5,   5,   5,   5,   5,   5,   5,   4,   4,   4,   4,   4,   4,   4,   4,
      4,   4,   4,   4,   4,   4,   4,   4,   4,   3,   3,   3,   3,   3,   3,   3,
      3,   3,   3,   3,   3,   3,   3,   3,   3,   3,   3,   3,   3,   3,   3,   3,
      3,   3,   3,   3,   3,   3,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,
      2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,
      2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,
      2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   2,
      2,   2,   2,   2,   2,   2,   2,   2,   2,   2,   1,   1,   1,   1,   1,   1,
      1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,
      1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,
      1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,
      1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,
      1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   1,   0};

// The launch's arguments (ops/cuda/filters.py LrPass, field for field).
struct LrPass {
    int* out;          // the plane's restored copy, (ah, aw) int32
    const int* src;    // the post-CDEF plane, (ah, aw) int32
    const int* lpf;    // the pre-CDEF (post-deblock) plane, (ah, aw) int32
    const int* blob;   // the frame blob
    int ah, aw;
    int ph;            // the plane's visible rows (cat's half)
    int W;             // the slot's tile width: output columns < W
    int bpc;
    int nreg;          // descriptor regions: 1 (Wiener) or 3 (self-guided kinds 0, 1, 2)
    int base[3];       // word offset of each region
    int first[4];      // first stripe of each region (LRB per chunk)
};

// wrapping int32 arithmetic
LR_HD int wadd(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
LR_HD int wsub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
LR_HD int wmul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

LR_HD int lr_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

LR_HD int lr_ld(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// One block's stripe: its descriptor and shared buffers.
struct LrStripe {
    int kind;          // -1 Wiener, else the self-guided kind
    int d[16];         // the descriptor (its first nd words: lr_stripe)
    const int* dsc;    // its first word in the blob (stride LR_LRB)
    int c0;            // the block's first output column
    int hh, ww;        // output rows and columns of the stripe
    int* tile;         // LR_ROWS x LR_TC
    int* tmp;          // Wiener: LR_ROWS x LR_CW; self-guided: the A/B tables
    int* xbx;          // self-guided: sgr_x_by_x
};

LR_HD int lr_blocks(const LrPass& p) {
    return p.nreg == 1 || p.nreg == 3 ? p.first[p.nreg] : -1;
}

// stripe s of the pass, column block cb: its kind, the first nd words of
// its descriptor (16, or the Wiener frame entry's S_P0: the geometry, the
// taps read by one thread a block) and its shared buffers from sm
LR_HD LrStripe lr_stripe(const LrPass& p, int s, int cb, int* sm, int nd = 16) {
    LrStripe b;
    int r = 0;
    while (r + 1 < p.nreg && s >= p.first[r + 1]) r++;
    const int j = s - p.first[r];
    b.kind = p.nreg == 1 ? -1 : r;
    b.dsc = p.blob + p.base[r] + (size_t)(j / LR_LRB) * 16 * LR_LRB + (j % LR_LRB);
    for (int f = 0; f < nd; f++) b.d[f] = lr_ld(b.dsc + f * LR_LRB);
    b.c0 = cb * LR_CW;
    b.hh = b.d[S_H] < 64 ? b.d[S_H] : 64;
    b.ww = b.d[S_W] < p.W ? b.d[S_W] : p.W;
    b.tile = sm;
    b.tmp = sm + LR_ROWS * LR_TC;
    b.xbx = sm + LR_ROWS * LR_TC + 2 * LR_AC * (LR_R5 + LR_R3);
    return b;
}

LR_HD bool lr_active(const LrStripe& b) { return b.hh > 0 && b.c0 < b.ww; }

LR_HD int lr_smem_words() { return LR_ROWS * LR_TC + 2 * LR_AC * (LR_R5 + LR_R3) + 256; }

// the cat row of tile row i (engine/filters.py gather_stripes)
LR_HD int lr_row(const LrStripe& b, int i) {
    const int h = b.d[S_H];
    if (i < 2) return b.d[S_TOP0];
    if (i < 3) return b.d[S_TOP1];
    if (i < 3 + h) {
        int k = i - 3 < 0 ? 0 : i - 3;
        const int m = h - 1 < 0 ? 0 : h - 1;
        return b.d[S_Y0] + (k < m ? k : m);
    }
    return i == 3 + h ? b.d[S_BOT0] : b.d[S_BOT1];
}

// step 1: the tile (and the table); nt: the block's threads
// the source row of tile row r: cat row lr_row, clamped to cat; a row >= ph
// is the pre-CDEF plane's
LR_HD const int* lr_src_row(const LrPass& p, const LrStripe& b, int r) {
    const int rr = lr_clamp(lr_row(b, r), 0, 2 * p.ph - 1);
    return rr < p.ph ? p.src + (size_t)rr * p.aw : p.lpf + (size_t)(rr - p.ph) * p.aw;
}

// the source column of tile column c: clamped to [XLO, XHI], then to the plane
LR_HD int lr_src_col(const LrPass& p, const LrStripe& b, int c) {
    int cc = b.d[S_X0] - 3 + b.c0 + c;
    cc = cc > b.d[S_XLO] ? cc : b.d[S_XLO];
    cc = cc < b.d[S_XHI] ? cc : b.d[S_XHI];
    return lr_clamp(cc, 0, p.aw - 1);
}

LR_HD void lr_load(const LrPass& p, const LrStripe& b, int t, int nt = LR_THREADS) {
    for (int i = t; i < LR_ROWS * LR_TC; i += nt) {
        const int r = i / LR_TC, c = i % LR_TC;
        b.tile[i] = lr_ld(lr_src_row(p, b, r) + lr_src_col(p, b, c));
    }
    if (b.kind >= 0)
        for (int i = t; i < 256; i += nt) b.xbx[i] = LR_X_BY_X[i];
}

LR_HD void lr_store(const LrPass& p, const LrStripe& b, int r, int c, int v) {
    const long long idx = (long long)(b.d[S_Y0] + r) * p.aw + b.d[S_X0] + c;
    if (idx >= 0 && idx < (long long)p.ah * p.aw) p.out[idx] = v;
}

// ---------------------------------- Wiener ----------------------------------

LR_HD void lr_taps(const LrPass& p, const LrStripe& b, int* fh, int* fv) {
    const int* q = b.d + S_P0;
    const int f3h = wadd(wmul(wsub(0, wadd(wadd(q[0], q[1]), q[2])), 2), p.bpc == 8 ? 0 : 128);
    const int f3v = wsub(128, wmul(wadd(wadd(q[3], q[4]), q[5]), 2));
    const int h[7] = {q[0], q[1], q[2], f3h, q[2], q[1], q[0]};
    const int v[7] = {q[3], q[4], q[5], f3v, q[5], q[4], q[3]};
    for (int k = 0; k < 7; k++) {
        fh[k] = h[k];
        fv[k] = v[k];
    }
}

// step 2: the horizontal pass (ops/lr.py wiener_batch)
LR_HD void lr_wiener_hor(const LrPass& p, const LrStripe& b, int t) {
    int fh[7], fv[7];
    lr_taps(p, b, fh, fv);
    const int rb = 3 + (p.bpc == 12 ? 2 : 0);
    const int clip = 1 << (p.bpc + 1 + 7 - rb);
    const int nrow = b.hh + 6;
    for (int i = t; i < nrow * LR_CW; i += LR_THREADS) {
        const int r = i / LR_CW, c = i % LR_CW;
        const int* row = b.tile + r * LR_TC + c;
        int acc = 1 << (p.bpc + 6);
        if (p.bpc == 8) acc = wadd(acc, wmul(row[3], 128));
        for (int k = 0; k < 7; k++) acc = wadd(acc, wmul(row[k], fh[k]));
        b.tmp[i] = lr_clamp(wadd(acc, 1 << (rb - 1)) >> rb, 0, clip - 1);
    }
}

// step 3: the vertical pass and the store
LR_HD void lr_wiener_ver(const LrPass& p, const LrStripe& b, int t) {
    int fh[7], fv[7];
    lr_taps(p, b, fh, fv);
    const int rb = 11 - (p.bpc == 12 ? 2 : 0);
    const int off = 1 << (p.bpc + rb - 1);
    for (int i = t; i < b.hh * LR_CW; i += LR_THREADS) {
        const int r = i / LR_CW, c = i % LR_CW;
        if (b.c0 + c >= b.ww) continue;
        int acc = -off;
        for (int k = 0; k < 7; k++) acc = wadd(acc, wmul(b.tmp[(r + k) * LR_CW + c], fv[k]));
        lr_store(p, b, r, b.c0 + c,
                 lr_clamp(wadd(acc, 1 << (rb - 1)) >> rb, 0, (1 << p.bpc) - 1));
    }
}

// ------------------------------- self-guided --------------------------------

// (p * s + 2^(sh-1)) >> sh through the 13-bit split of ops/lr.py
// _mul_shift_exact, in its int32 arithmetic
LR_HD int lr_mul_shift(int p, int s, int sh) {
    const int hi = p >> 13, lo = p & 8191;
    const int t1 = wadd(wmul(lo, s), 1 << (sh - 1)) >> 13;
    return wadd(wmul(hi, s), t1) >> (sh - 13);
}

// A and B of a box from its sum and sum of squares (ops/lr.py _selfguided)
LR_HD void lr_ab_of(const LrPass& p, const LrStripe& b, int five, int sum, int sq, int* A,
                    int* B) {
    const int n = five ? 25 : 9, obx = five ? 164 : 455;
    const int bd = p.bpc - 8;
    const int a = wadd(sq, (1 << (2 * bd)) >> 1) >> (2 * bd);
    const int bb = wadd(sum, (1 << bd) >> 1) >> bd;
    int pv = wsub(wmul(a, n), wmul(bb, bb));
    pv = pv < 0 ? 0 : pv;
    const int s = five ? b.d[S_P0] : b.d[S_P0 + 1];
    int z = lr_mul_shift(pv, s, 20);
    z = z < 255 ? z : 255;
    const int x = b.xbx[z < 0 ? (z < -256 ? 0 : z + 256) : z];  // a negative index counts from the end
    const int m = wmul(x, sum);
    *A = wadd(wmul(m >> 12, obx), wadd(wmul(m & 4095, obx), 1 << 11) >> 12);
    *B = x;
}

// A and B of the box at cat row R, tile column C (global to the stripe):
// 5x5 sums rows R-1..R+3, columns C-2..C+2; 3x3 rows R..R+2, C-1..C+1
// (ops/lr.py _boxsum's anchoring), each sum straight from the tile (the
// earlier form)
LR_HD void lr_ab(const LrPass& p, const LrStripe& b, int five, int R, int Cl, int* A, int* B) {
    const int r0 = five ? R - 1 : R, nr = five ? 5 : 3;
    const int cl0 = five ? Cl - 2 : Cl - 1;  // local tile columns
    int sum = 0, sq = 0;
    for (int y = 0; y < nr; y++)
        for (int x = 0; x < nr; x++) {
            const int v = b.tile[(r0 + y) * LR_TC + cl0 + x];
            sum = wadd(sum, v);
            sq = wadd(sq, wmul(v, v));
        }
    lr_ab_of(p, b, five, sum, sq, A, B);
}

// step 2: the tables. 5x5 at rows R = 1, 3, .., 65 (index (R - 1) / 2),
// 3x3 at R = 1 .. 66 (index R - 1); columns C = c0 + 2 + a, a < LR_AC.
LR_HD void lr_sgr_tables(const LrPass& p, const LrStripe& b, int t) {
    int* A5 = b.tmp;
    int* B5 = A5 + LR_R5 * LR_AC;
    int* A3 = B5 + LR_R5 * LR_AC;
    int* B3 = A3 + LR_R3 * LR_AC;
    if (b.kind != 1)
        for (int i = t; i < LR_R5 * LR_AC; i += LR_THREADS) {
            const int ri = i / LR_AC, a = i % LR_AC;
            lr_ab(p, b, 1, 2 * ri + 1, a + 2, A5 + i, B5 + i);
        }
    if (b.kind != 0)
        for (int i = t; i < LR_R3 * LR_AC; i += LR_THREADS) {
            const int ri = i / LR_AC, a = i % LR_AC;
            lr_ab(p, b, 0, ri + 1, a + 2, A3 + i, B3 + i);
        }
}

// the 5x5 filter's output at stripe row j, table column a (the pixel's
// column c0 + a - 1 + ... : a = local output column + 1)
LR_HD int lr_out5(const LrStripe& b, int j, int a, int src) {
    const int* A = b.tmp;
    const int* B = A + LR_R5 * LR_AC;
    if (!(j & 1)) {  // rows above and below (R = j + 1 and j + 3)
        const int u = (j >> 1) * LR_AC, d = u + LR_AC;
        const int aa = wadd(wmul(wadd(B[u + a], B[d + a]), 6),
                            wmul(wadd(wadd(B[u + a - 1], B[d + a - 1]),
                                      wadd(B[u + a + 1], B[d + a + 1])), 5));
        const int bb = wadd(wmul(wadd(A[u + a], A[d + a]), 6),
                            wmul(wadd(wadd(A[u + a - 1], A[d + a - 1]),
                                      wadd(A[u + a + 1], A[d + a + 1])), 5));
        return wadd(wsub(bb, wmul(aa, src)), 1 << 8) >> 9;
    }
    const int m = ((j + 1) >> 1) * LR_AC;  // its own row, R = j + 2
    const int aa = wadd(wmul(B[m + a], 6), wmul(wadd(B[m + a - 1], B[m + a + 1]), 5));
    const int bb = wadd(wmul(A[m + a], 6), wmul(wadd(A[m + a - 1], A[m + a + 1]), 5));
    return wadd(wsub(bb, wmul(aa, src)), 1 << 7) >> 8;
}

LR_HD int lr_eight(const int* M, int j, int a) {
    const int u = j * LR_AC, m = u + LR_AC, d = m + LR_AC;  // R = j + 1, j + 2, j + 3
    const int four = wadd(wadd(wadd(M[m + a], M[m + a - 1]), wadd(M[m + a + 1], M[u + a])),
                          M[d + a]);
    const int three = wadd(wadd(M[u + a - 1], M[d + a - 1]), wadd(M[u + a + 1], M[d + a + 1]));
    return wadd(wmul(four, 4), wmul(three, 3));
}

LR_HD int lr_out3(const LrStripe& b, int j, int a, int src) {
    const int* A = b.tmp + 2 * LR_R5 * LR_AC;
    const int* B = A + LR_R3 * LR_AC;
    return wadd(wsub(lr_eight(A, j, a), wmul(lr_eight(B, j, a), src)), 1 << 8) >> 9;
}

// step 3: each pixel and the store (ops/lr.py sgr_batch)
LR_HD void lr_sgr_out(const LrPass& p, const LrStripe& b, int t, int nt = LR_THREADS) {
    const int w0 = b.d[S_P0 + 2], w1 = b.d[S_P0 + 3];
    for (int i = t; i < b.hh * LR_CW; i += nt) {
        const int j = i / LR_CW, c = i % LR_CW;
        if (b.c0 + c >= b.ww) continue;
        const int src = b.tile[(j + 3) * LR_TC + c + 3];
        int v;
        if (b.kind == 0) v = wmul(w0, lr_out5(b, j, c + 1, src));
        else if (b.kind == 1) v = wmul(w1, lr_out3(b, j, c + 1, src));
        else v = wadd(wmul(w0, lr_out5(b, j, c + 1, src)), wmul(w1, lr_out3(b, j, c + 1, src)));
        lr_store(p, b, j, b.c0 + c,
                 lr_clamp(wadd(src, wadd(v, 1 << 10) >> 11), 0, (1 << p.bpc) - 1));
    }
}

// ------------------- self-guided, every plane in one launch -------------------
//
// The frame entry (rav1d_lr_sgr_frame): each plane's pass, and the launch's
// work items, a (stripe, column block) each, plane by plane, a block of 384
// threads each; an item with no output (a padding stripe slot, a column
// block past the stripe's width) exits after its descriptor, before any
// load. (A persistent grid walking the items measured slower on the card:
// its blocks ran their items one after another, where the hardware
// overlaps one item's blocks with another's.) The tile is gathered through
// a row map and a column map made first (each source row and column
// computed once, not once a pixel: the per-pixel gather was half of the
// launch), a thread a column with its rows' loads in flight together. The
// box sums are separable: each tile pixel squared once (into the table
// area, free until the tables), the 3-row sums of values and squares per
// column (rows R..R+2, R = 1..66), the 5-row sums of the 5x5's rows (R
// odd) from them and the rows R-1 and R+3, then each table entry from 5 or
// 3 of those along its row. int32 addition wraps mod 2^32 and is
// associative, so the sums are the same words as the plain version's in
// any order.

struct LrFrame {
    LrPass pl[3];   // each plane's pass (nreg 3: the self-guided kinds; 1: Wiener)
    int nplanes;
    int ncb[3];     // column blocks of a stripe of the plane: ceil(W / LR_CW)
    int item0[4];   // the first item of each plane: item0[p] + stripe * ncb + block
};

enum { LR_V3 = 66, LR_V5 = 33 };  // rows of the 3-row and the 5-row sums

// shared words of the frame kernel: lr_smem_words(), then the 3-row sums of
// values and of squares and the 5-row sums of each (LR_TC columns a row)
LR_HD int lr_frame_smem_words() { return lr_smem_words() + 2 * (LR_V3 + LR_V5) * LR_TC; }

LR_HD int* lr_v3s(const LrStripe& b) { return b.xbx + 256; }
LR_HD int* lr_v3q(const LrStripe& b) { return lr_v3s(b) + LR_V3 * LR_TC; }
LR_HD int* lr_v5s(const LrStripe& b) { return lr_v3q(b) + LR_V3 * LR_TC; }
LR_HD int* lr_v5q(const LrStripe& b) { return lr_v5s(b) + LR_V5 * LR_TC; }

// arguments a frame kernel takes, every plane's pass with nreg regions: 0,
// or -1
LR_HD int lr_frame_check(const LrFrame& f, int nreg) {
    if (f.nplanes < 1 || f.nplanes > 3 || f.item0[0] != 0) return -1;
    for (int i = 0; i < f.nplanes; i++) {
        const LrPass& p = f.pl[i];
        if (p.nreg != nreg || p.W < 1 || p.bpc < 8 || p.bpc > 12 || lr_blocks(p) < 0) return -1;
        if (f.ncb[i] != (p.W + LR_CW - 1) / LR_CW) return -1;
        if (f.item0[i + 1] - f.item0[i] != (p.ph > 0 ? lr_blocks(p) * f.ncb[i] : 0)) return -1;
    }
    return 0;
}

// the plane, stripe and column block of an item
LR_HD int lr_item(const LrFrame& f, int item, int* s, int* cb) {
    int pl = 0;
    while (item >= f.item0[pl + 1]) pl++;
    const int j = item - f.item0[pl];
    *s = j / f.ncb[pl];
    *cb = j % f.ncb[pl];
    return pl;
}

// The gather's maps, in the 3-row sums' area (free until step 2): each tile
// row's source row, then each tile column's source column.
LR_HD const int** lr_rowmap(const LrStripe& b) { return (const int**)lr_v3s(b); }
LR_HD int* lr_colmap(const LrStripe& b) { return lr_v3s(b) + 2 * LR_ROWS; }

// step 1a: the maps (a thread a row, then a thread a column), and the table
LR_HD void lr_maps(const LrPass& p, const LrStripe& b, int t) {
    if (t < LR_ROWS) lr_rowmap(b)[t] = lr_src_row(p, b, t);
    else if (t < LR_ROWS + LR_TC) lr_colmap(b)[t - LR_ROWS] = lr_src_col(p, b, t - LR_ROWS);
    for (int i = t; i < 256; i += LR_FRAME_THREADS) b.xbx[i] = LR_X_BY_X[i];
}

// step 1b: the tile through the maps, a thread a column and every
// LR_GROUPS-th row, its loads issued together; each pixel squared once,
// into the table area (free until step 3)
enum { LR_GROUPS = LR_FRAME_THREADS / LR_TC, LR_RPT = (LR_ROWS + LR_GROUPS - 1) / LR_GROUPS };

LR_HD void lr_gather_sq(const LrStripe& b, int t) {
    if (t >= LR_GROUPS * LR_TC) return;
    const int c = t % LR_TC, r0 = t / LR_TC, x = lr_colmap(b)[c];
    const int* const* rows = lr_rowmap(b);
    int v[LR_RPT];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < LR_RPT; k++) {
        const int r = r0 + k * LR_GROUPS;
        v[k] = r < LR_ROWS ? lr_ld(rows[r] + x) : 0;
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < LR_RPT; k++) {
        const int i = (r0 + k * LR_GROUPS) * LR_TC + c;
        if (i < LR_ROWS * LR_TC) {
            b.tile[i] = v[k];
            b.tmp[i] = wmul(v[k], v[k]);
        }
    }
}

// step 2: the 3-row sums at R = 1..66 (the 5x5 alone needs the odd R) and
// from them the 5-row sums at R odd (kinds 0 and 2)
LR_HD void lr_vsums(const LrStripe& b, int t) {
    const int* v = b.tile;
    const int* q = b.tmp;
    for (int i = t; i < LR_V3 * LR_TC; i += LR_FRAME_THREADS) {
        const int R = i / LR_TC + 1, c = i % LR_TC;
        if (b.kind == 0 && !(R & 1)) continue;
        const int o = R * LR_TC + c;
        const int vs = wadd(wadd(v[o], v[o + LR_TC]), v[o + 2 * LR_TC]);
        const int vq = wadd(wadd(q[o], q[o + LR_TC]), q[o + 2 * LR_TC]);
        lr_v3s(b)[i] = vs;
        lr_v3q(b)[i] = vq;
        if ((R & 1) && b.kind != 1) {
            const int k = (R >> 1) * LR_TC + c;
            lr_v5s(b)[k] = wadd(wadd(vs, v[o - LR_TC]), v[o + 3 * LR_TC]);
            lr_v5q(b)[k] = wadd(wadd(vq, q[o - LR_TC]), q[o + 3 * LR_TC]);
        }
    }
}

// step 3: the tables (lr_sgr_tables' entries), each sum along its row
LR_HD void lr_sgr_tables_sep(const LrPass& p, const LrStripe& b, int t) {
    int* A5 = b.tmp;
    int* B5 = A5 + LR_R5 * LR_AC;
    int* A3 = B5 + LR_R5 * LR_AC;
    int* B3 = A3 + LR_R3 * LR_AC;
    if (b.kind != 1)
        for (int i = t; i < LR_R5 * LR_AC; i += LR_FRAME_THREADS) {
            const int ri = i / LR_AC, a = i % LR_AC;
            const int* s5 = lr_v5s(b) + ri * LR_TC + a;  // rows 2 ri .. 2 ri + 4
            const int* q5 = lr_v5q(b) + ri * LR_TC + a;  // columns a .. a + 4
            const int sum = wadd(wadd(wadd(s5[0], s5[1]), wadd(s5[2], s5[3])), s5[4]);
            const int sq = wadd(wadd(wadd(q5[0], q5[1]), wadd(q5[2], q5[3])), q5[4]);
            lr_ab_of(p, b, 1, sum, sq, A5 + i, B5 + i);
        }
    if (b.kind != 0)
        for (int i = t; i < LR_R3 * LR_AC; i += LR_FRAME_THREADS) {
            const int ri = i / LR_AC, a = i % LR_AC;
            const int* s3 = lr_v3s(b) + ri * LR_TC + a + 1;  // rows ri + 1 .. ri + 3
            const int* q3 = lr_v3q(b) + ri * LR_TC + a + 1;  // columns a + 1 .. a + 3
            lr_ab_of(p, b, 0, wadd(wadd(s3[0], s3[1]), s3[2]), wadd(wadd(q3[0], q3[1]), q3[2]),
                     A3 + i, B3 + i);
        }
}

// --------------------- Wiener, every plane in one launch ---------------------
//
// The frame entry (rav1d_lr_wiener_frame): each plane's Wiener pass (nreg 1)
// and the launch's work items laid out as LrFrame lays them (a (stripe,
// column block) each, plane by plane), a block of LR_THREADS threads each.
// An item with no output (a padding stripe slot, a column block past the
// stripe's width) exits after its descriptor's geometry, before any load.
// The earlier form's three serial launches of one wave each (a 4:2:0
// frame's planes) become one. Each block: the row map (a thread a tile row,
// only the h + 6 rows the stripe reads) and the column map (a thread a
// tile column); the tile through the maps, a thread a column with its rows'
// loads in flight together, while one more thread reads the six filter
// parameters and builds the taps (once a block); the horizontal pass into
// the clipped intermediate (70 x 32 words), a tap pair per symmetric
// column pair; the vertical pass a thread an output column and a run of
// LR_VRUN rows, the last seven intermediates in registers (each read once
// from shared memory, not seven times), a warp a row on the store. The
// taps' products are summed in another order than lr_wiener_hor /
// lr_wiener_ver's, and the bpc-8 horizontal term 128 * x3 joins the centre
// tap (128 - 2 (q0 + q1 + q2) at every bpc): int32 addition and
// multiplication wrap mod 2^32, so the sums are the same words. The launch
// reads only src, lpf and the blob and writes only out. 20,344 bytes of
// static shared memory a block.

enum {
    LR_WGROUPS = LR_THREADS / LR_TC,                       // gather: 6 threads a column
    LR_WRPT = (LR_ROWS + LR_WGROUPS - 1) / LR_WGROUPS,     // and 12 rows a thread
    LR_VRUN = 64 / (LR_THREADS / LR_CW),                   // vertical pass: 8 rows a thread
};

// a Wiener frame block's shared memory (the steps below take it whole; of
// lr_stripe's buffers they use none)
struct LrWienerSm {
    const int* rows[LR_ROWS];  // each tile row's source row
    int cols[LR_TC];           // each tile column's source column
    int taps[8];               // horizontal (outer to centre), then vertical
    int tile[LR_ROWS * LR_TC];
    int mid[LR_ROWS * LR_CW];  // the clipped horizontal pass
};

// step 1a: the maps, a thread a row (the h + 6 the stripe reads), then a
// thread a column
LR_HD void lr_wmaps(const LrPass& p, const LrStripe& b, LrWienerSm& sm, int t) {
    if (t < b.hh + 6) sm.rows[t] = lr_src_row(p, b, t);
    else if (t >= LR_ROWS && t < LR_ROWS + LR_TC) sm.cols[t - LR_ROWS] = lr_src_col(p, b, t - LR_ROWS);
}

// step 1b: the tile through the maps, a thread a column and every
// LR_WGROUPS-th row, its loads issued together; the next thread reads the
// parameters and builds the taps (lr_taps' values, the bpc-8 centre term
// folded in)
LR_HD void lr_wgather(const LrStripe& b, LrWienerSm& sm, int t) {
    if (t == LR_WGROUPS * LR_TC) {
        int q[6];
        for (int k = 0; k < 6; k++) q[k] = lr_ld(b.dsc + (S_P0 + k) * LR_LRB);
        for (int k = 0; k < 3; k++) {
            sm.taps[k] = q[k];
            sm.taps[4 + k] = q[3 + k];
        }
        sm.taps[3] = wsub(128, wmul(wadd(wadd(q[0], q[1]), q[2]), 2));
        sm.taps[7] = wsub(128, wmul(wadd(wadd(q[3], q[4]), q[5]), 2));
    }
    if (t >= LR_WGROUPS * LR_TC) return;
    const int c = t % LR_TC, r0 = t / LR_TC, x = sm.cols[c], nrow = b.hh + 6;
    int v[LR_WRPT];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < LR_WRPT; k++) {
        const int r = r0 + k * LR_WGROUPS;
        v[k] = r < nrow ? lr_ld(sm.rows[r] + x) : 0;
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int k = 0; k < LR_WRPT; k++) {
        const int r = r0 + k * LR_WGROUPS;
        if (r < nrow) sm.tile[r * LR_TC + c] = v[k];
    }
}

// step 2: the horizontal pass (ops/lr.py wiener_batch) over the h + 6 rows
LR_HD void lr_whor(const LrPass& p, const LrStripe& b, LrWienerSm& sm, int t) {
    const int rb = 3 + (p.bpc == 12 ? 2 : 0);
    const int clip = (1 << (p.bpc + 1 + 7 - rb)) - 1;
    const int f0 = sm.taps[0], f1 = sm.taps[1], f2 = sm.taps[2], f3 = sm.taps[3];
    const int base = wadd(1 << (p.bpc + 6), 1 << (rb - 1));
    for (int i = t; i < (b.hh + 6) * LR_CW; i += LR_THREADS) {
        const int* x = sm.tile + (i / LR_CW) * LR_TC + i % LR_CW;
        int acc = wadd(base, wmul(x[3], f3));
        acc = wadd(acc, wmul(wadd(x[0], x[6]), f0));
        acc = wadd(acc, wmul(wadd(x[1], x[5]), f1));
        acc = wadd(acc, wmul(wadd(x[2], x[4]), f2));
        sm.mid[i] = lr_clamp(acc >> rb, 0, clip);
    }
}

// step 3: the vertical pass and the store: output column t % LR_CW, rows
// LR_VRUN * (t / LR_CW) on, the window of seven intermediates in registers
LR_HD void lr_wver(const LrPass& p, const LrStripe& b, const LrWienerSm& sm, int t) {
    const int c = t % LR_CW, r0 = (t / LR_CW) * LR_VRUN;
    if (b.c0 + c >= b.ww || r0 >= b.hh) return;
    const int rb = 11 - (p.bpc == 12 ? 2 : 0);
    const int base = wsub(1 << (rb - 1), 1 << (p.bpc + rb - 1));
    const int pmax = (1 << p.bpc) - 1;
    const int f0 = sm.taps[4], f1 = sm.taps[5], f2 = sm.taps[6], f3 = sm.taps[7];
    const int* m = sm.mid + r0 * LR_CW + c;
    int w0 = m[0], w1 = m[LR_CW], w2 = m[2 * LR_CW], w3 = m[3 * LR_CW], w4 = m[4 * LR_CW],
        w5 = m[5 * LR_CW];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int j = 0; j < LR_VRUN; j++) {
        if (r0 + j >= b.hh) break;
        const int w6 = m[(j + 6) * LR_CW];
        int acc = wadd(base, wmul(w3, f3));
        acc = wadd(acc, wmul(wadd(w0, w6), f0));
        acc = wadd(acc, wmul(wadd(w1, w5), f1));
        acc = wadd(acc, wmul(wadd(w2, w4), f2));
        lr_store(p, b, r0 + j, b.c0 + c, lr_clamp(acc >> rb, 0, pmax));
        w0 = w1;
        w1 = w2;
        w2 = w3;
        w3 = w4;
        w4 = w5;
        w5 = w6;
    }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LR_THREADS) lr_wiener_kernel(const __grid_constant__ LrPass p) {
    __shared__ int sm[LR_ROWS * LR_TC + LR_ROWS * LR_CW];
    const LrStripe b = lr_stripe(p, blockIdx.x, blockIdx.y, sm);
    if (!lr_active(b)) return;  // the same for every thread of the block
    lr_load(p, b, threadIdx.x);
    __syncthreads();
    lr_wiener_hor(p, b, threadIdx.x);
    __syncthreads();
    lr_wiener_ver(p, b, threadIdx.x);
}

__global__ void __launch_bounds__(LR_THREADS) lr_sgr_kernel(const __grid_constant__ LrPass p) {
    __shared__ int sm[LR_ROWS * LR_TC + 2 * LR_AC * (LR_R5 + LR_R3) + 256];
    const LrStripe b = lr_stripe(p, blockIdx.x, blockIdx.y, sm);
    if (!lr_active(b)) return;
    lr_load(p, b, threadIdx.x);
    __syncthreads();
    lr_sgr_tables(p, b, threadIdx.x);
    __syncthreads();
    lr_sgr_out(p, b, threadIdx.x);
}

__global__ void __launch_bounds__(LR_FRAME_THREADS)
    lr_sgr_frame_kernel(const __grid_constant__ LrFrame f) {
    extern __shared__ int lr_sm[];
    int s, cb;
    const LrPass& p = f.pl[lr_item(f, blockIdx.x, &s, &cb)];
    const LrStripe b = lr_stripe(p, s, cb, lr_sm);
    if (!lr_active(b)) return;  // the same for every thread of the block
    lr_maps(p, b, threadIdx.x);
    __syncthreads();
    lr_gather_sq(b, threadIdx.x);
    __syncthreads();
    lr_vsums(b, threadIdx.x);
    __syncthreads();
    lr_sgr_tables_sep(p, b, threadIdx.x);
    __syncthreads();
    lr_sgr_out(p, b, threadIdx.x, LR_FRAME_THREADS);
}

__global__ void __launch_bounds__(LR_THREADS)
    lr_wiener_frame_kernel(const __grid_constant__ LrFrame f) {
    __shared__ LrWienerSm sm;
    int s, cb;
    const LrPass& p = f.pl[lr_item(f, blockIdx.x, &s, &cb)];
    const LrStripe b = lr_stripe(p, s, cb, sm.tile, S_P0);
    if (!lr_active(b)) return;  // the same for every thread of the block
    lr_wmaps(p, b, sm, threadIdx.x);
    __syncthreads();
    lr_wgather(b, sm, threadIdx.x);
    __syncthreads();
    lr_whor(p, b, sm, threadIdx.x);
    __syncthreads();
    lr_wver(p, b, sm, threadIdx.x);
}

static int lr_launch(const void* kernel, const LrPass* f, void* stream) {
    const int ns = lr_blocks(*f);
    if (ns < 0 || f->W < 1 || f->bpc < 8 || f->bpc > 12) return -1;
    if (ns == 0 || f->ph <= 0) return 0;
    void* args[] = {(void*)f};
    const cudaError_t e = cudaLaunchKernel(kernel, dim3(ns, (f->W + LR_CW - 1) / LR_CW),
                                           dim3(LR_THREADS), args, 0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Plain C entries (bound with ctypes): one launch over every stripe of
// the regions on `stream`. Return the launch's error code (-1 for
// arguments the kernels do not take).
extern "C" int rav1d_lr_wiener(const LrPass* f, void* stream) {
    return f->nreg != 1 ? -1 : lr_launch((const void*)lr_wiener_kernel, f, stream);
}

extern "C" int rav1d_lr_sgr(const LrPass* f, void* stream) {
    return f->nreg != 3 ? -1 : lr_launch((const void*)lr_sgr_kernel, f, stream);
}

// Every Wiener stripe of every plane in one launch on `stream`: a block per
// item (static shared memory).
extern "C" int rav1d_lr_wiener_frame(const LrFrame* f, void* stream) {
    if (lr_frame_check(*f, 1)) return -1;
    const int items = f->item0[f->nplanes];
    if (items == 0) return 0;
    lr_wiener_frame_kernel<<<items, LR_THREADS, 0, (cudaStream_t)stream>>>(*f);
    return (int)cudaGetLastError();
}

// Every self-guided stripe of every plane in one launch on `stream`: a block
// per item, each with lr_frame_smem_words() of dynamic shared memory (the
// limit raised once per device).
static bool lr_smem_set[64];

extern "C" int rav1d_lr_sgr_frame(const LrFrame* f, void* stream) {
    if (lr_frame_check(*f, 3)) return -1;
    const int items = f->item0[f->nplanes];
    if (items == 0) return 0;
    const int bytes = lr_frame_smem_words() * (int)sizeof(int);
    int dev;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 0 || dev >= 64) return -1;
    if (!lr_smem_set[dev]) {
        e = cudaFuncSetAttribute((const void*)lr_sgr_frame_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return (int)e;
        lr_smem_set[dev] = true;
    }
    lr_sgr_frame_kernel<<<items, LR_FRAME_THREADS, bytes, (cudaStream_t)stream>>>(*f);
    return (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

#include <string.h>

#include <vector>

static int lr_host(const LrPass& p, int sgr) {
    const int ns = lr_blocks(p);
    if (ns < 0 || p.W < 1 || p.bpc < 8 || p.bpc > 12 || p.nreg != (sgr ? 3 : 1)) return -1;
    if (p.ph <= 0) return 0;
    std::vector<int> sm(lr_smem_words());
    for (int s = 0; s < ns; s++)
        for (int cb = 0; cb < (p.W + LR_CW - 1) / LR_CW; cb++) {
            for (int& w : sm) w = 0x5a5a5a5a;
            const LrStripe b = lr_stripe(p, s, cb, sm.data());
            if (!lr_active(b)) continue;
            for (int t = 0; t < LR_THREADS; t++) lr_load(p, b, t);
            if (sgr) {
                for (int t = 0; t < LR_THREADS; t++) lr_sgr_tables(p, b, t);
                for (int t = 0; t < LR_THREADS; t++) lr_sgr_out(p, b, t);
            } else {
                for (int t = 0; t < LR_THREADS; t++) lr_wiener_hor(p, b, t);
                for (int t = 0; t < LR_THREADS; t++) lr_wiener_ver(p, b, t);
            }
        }
    return 0;
}

// rav1d_lr_wiener and rav1d_lr_sgr without the stream: every block in
// order, each step for every thread in turn.
extern "C" int rav1d_lr_wiener_host(const LrPass* f) { return lr_host(*f, 0); }

extern "C" int rav1d_lr_sgr_host(const LrPass* f) { return lr_host(*f, 1); }

// rav1d_lr_sgr_frame without the stream: every item's block, in order or
// (`reverse`) from the last to the first, each step for every thread in
// turn (the shared words start as a pattern at each block). Returns 0, or
// -1 for arguments the kernel does not take.
extern "C" int rav1d_lr_sgr_frame_host(const LrFrame* f, int reverse) {
    if (lr_frame_check(*f, 3)) return -1;
    std::vector<int> sm(lr_frame_smem_words());
    const int items = f->item0[f->nplanes];
    for (int i = 0; i < items; i++) {
        const int item = reverse ? items - 1 - i : i;
        int s, cb;
        const LrPass& p = f->pl[lr_item(*f, item, &s, &cb)];
        for (int& w : sm) w = 0x5a5a5a5a;
        const LrStripe b = lr_stripe(p, s, cb, sm.data());
        if (!lr_active(b)) continue;
        for (int t = 0; t < LR_FRAME_THREADS; t++) lr_maps(p, b, t);
        for (int t = 0; t < LR_FRAME_THREADS; t++) lr_gather_sq(b, t);
        for (int t = 0; t < LR_FRAME_THREADS; t++) lr_vsums(b, t);
        for (int t = 0; t < LR_FRAME_THREADS; t++) lr_sgr_tables_sep(p, b, t);
        for (int t = 0; t < LR_FRAME_THREADS; t++) lr_sgr_out(p, b, t, LR_FRAME_THREADS);
    }
    return 0;
}

// rav1d_lr_wiener_frame without the stream: every item's block, in order or
// (`reverse`) from the last to the first, each step for every thread in
// turn (the shared words, the row map's pointers too, start as a pattern at
// each block). Returns 0, or -1 for arguments the kernel does not take.
extern "C" int rav1d_lr_wiener_frame_host(const LrFrame* f, int reverse) {
    if (lr_frame_check(*f, 1)) return -1;
    LrWienerSm sm;
    const int items = f->item0[f->nplanes];
    for (int i = 0; i < items; i++) {
        const int item = reverse ? items - 1 - i : i;
        int s, cb;
        const LrPass& p = f->pl[lr_item(*f, item, &s, &cb)];
        memset(&sm, 0x5a, sizeof sm);
        const LrStripe b = lr_stripe(p, s, cb, sm.tile, S_P0);
        if (!lr_active(b)) continue;
        for (int t = 0; t < LR_THREADS; t++) lr_wmaps(p, b, sm, t);
        for (int t = 0; t < LR_THREADS; t++) lr_wgather(b, sm, t);
        for (int t = 0; t < LR_THREADS; t++) lr_whor(p, b, sm, t);
        for (int t = 0; t < LR_THREADS; t++) lr_wver(p, b, sm, t);
    }
    return 0;
}

// sgr_x_by_x, for the tests (256 ints)
extern "C" int rav1d_lr_table_host(int* out) {
    for (int i = 0; i < 256; i++) out[i] = LR_X_BY_X[i];
    return 256;
}

#endif  // __CUDACC__
