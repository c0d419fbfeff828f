// Film grain of a picture, CUDA C++ for sm_90a: every plane in one launch
// (rav1d_fg_frame, kernel fg_tiles_kernel), and the earlier form kept for
// comparison (rav1d_fg_frame_earlier, kernel fg_frame_kernel); each has a
// traced build.
//
// Replaces the device half of rav1d_tpu's film grain,
// rav1d_tpu/ops/tpu/fg.py fg_blend_batch (:19, an XLA function: the
// scaling lookup, the noise (scaling * grain + round) >> shift and the
// clip), and takes on the 2-px overlap blend that the JAX package left on
// the host, which is per pixel too. The port's plain version is
// ops/fg.py grain_frame_plain; both forms compute exactly what it
// computes, which is what recon/fg_apply.py apply_grain computes block by
// block (src/filmgrain.rs fgy_32x32xn_rust, fguv_32x32xn_rust). The host
// tables (each plane's grain table, the scaling tables, the random value
// of every 32x32 luma block) come from engine/grain.py tables.
//
// What a plane with grain gets, per visible pixel (y, x) of block row
// r = y / bh and column c = x / bw (bw, bh = 32 >> ss_x, 32 >> ss_y of
// the plane, 32 on luma), i = y % bh, j = x % bw, with R(r, c) the block
// random value and off(v) = (3 + (2 >> ss_y) * (3 + (v & 15)),
// 3 + (2 >> ss_x) * (3 + (v >> 4))): g = L[off(R(r, c)) + (i, j)]; with
// overlap, where c > 0 and j < 2 >> ss_x, g = blend(L[off(R(r, c - 1)) +
// (i, bw + j)], g, Wx[j]); where r > 0 and i < 2 >> ss_y, the top sample
// T = L[off(R(r - 1, c)) + (bh + i, j)], itself first blended (where the
// column overlaps) with the top-left one L[off(R(r - 1, c - 1)) + (bh +
// i, bw + j)], and g = blend(T, g, Wy[i]); blend(a, b, w) =
// clip(round2(a * w0 + b * w1, 5)) to [-128 << bdm8, (128 << bdm8) - 1],
// weights (27, 17), (17, 27) on a full axis, (23, 22) on a subsampled
// one. The scaling index is the pixel (luma); on chroma the co-located
// luma average ((Y[2y'][2x'] + Y[2y'][min(2x' + 1, w - 1)] + 1) >> 1
// where subsampled), itself with chroma_scaling_from_luma, else
// clip(((avg * uv_luma_mult + src * uv_mult) >> 6) + uv_offset *
// 2^bdm8, 0, pxmax). The output is clip(src + round2(scaling[v] * g,
// scaling_shift)) to the plane's range. Every other pixel of the padded
// planes (padding, planes without grain) is copied, so the wrapper
// allocates the output with torch.empty.
//
// Bound on this card: bytes at 10 and 12 bits, the arithmetic at 8. The
// launch must read every padded plane once and write it once (7.1 MB for
// a 1080p 8-bit 4:2:0 picture, 2.1 us at 3.35 TB/s; 51 MB at 2160p
// 10-bit, 15 us), plus the tables (about 50 KB); the arithmetic, about
// 10 int32 operations a luma pixel, 20 a chroma pixel and 10 more in an
// overlap, is 45 M operations at 1080p 4:2:0, 2.7 us at the int32 rate.
//
// The new form (rav1d_fg_frame). An item is 16 bytes of FG2_ROWS (4)
// consecutive rows of a plane: 16 pixels at 8 bits, 8 above. Its thread
// issues the loads of all its rows (one 16-byte load a row; on chroma also
// the co-located luma, two 16-byte loads a row where subsampled across)
// before it uses the first, so a warp keeps whole 512-byte rows in flight
// where the earlier form moved 32 or 64 bytes a row a load. An item's
// pixels lie in one grain block, so its thread finds its table bases
// once. A tile is FG2_THREADS items of one plane in (row group, 16-byte
// column) order, a thread an item. The grid is persistent, at most
// FG2_BLOCKS_PER_SM blocks an SM: block b walks a contiguous range of the
// picture's tiles, plane after plane, so it enters a plane at most once
// and stages that plane's grain table (12,136 bytes) and scaling table
// (1 << bpc bytes) in shared memory once for all its tiles there, with
// 8-byte loads issued after its first tile there has issued its pixel
// loads. No block is launched for chroma past the chroma width or for an
// absent plane. The pixel step is straight-line code for each kind of
// tile (luma, chroma, chroma subsampled across) and row (with or without
// the top overlap): bytes taken apart and packed with PRMT, copied pixels
// past the visible width merged a word at a time, luma pairs averaged two
// at a time; every index is fixed at compile time, so the rows stay in
// registers. The random values (a byte a block) are read through the
// read-only path. Every plane base and stride must be a multiple of 16
// bytes (the decoder's planes are padded to 128 columns); rav1d_fg_frame
// refuses anything else, and there is no scalar path.
//
// The earlier form (rav1d_fg_frame_earlier): a thread block per (256
// columns, block row, plane), 256 threads, a thread a column walking the
// block row's 32 (16) rows, one pixel load and one store a row; a block
// with visible pixels to grain first stages its plane's grain table, its
// scaling table and its stretch of the random-value table (16.4 KB of
// shared memory). On a 1080p 4:2:0 picture that is 960 blocks, 352 of them
// with nothing to do, and 544 stagings of the whole table, 18-20% of the
// blocks' cycles (its traced build, chip_smoke.py grain_trace).
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_fg_frame_host and rav1d_fg_frame_earlier_host walk the same
// blocks with the same step functions, thread by thread, each barrier a
// loop boundary, for the CPU tests.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FG_HD __host__ __device__ __forceinline__
#else
#define FG_HD static inline
#endif

enum {
    FG_THREADS = 256,
    FG_T = 256,             // columns of a block
    FG_GW = 82,             // a grain table's row length
    FG_GH = 74,             // and its rows
    FG_RC = FG_T / 16 + 2,  // random values a block stages a block row: its
                            // block columns (16 columns at least) and one left
};

// The launch's arguments (ops/cuda/grain.py FgFrame, field for field).
struct FgFrame {
    void* out[3];            // the output planes, the source planes' shapes
    const void* src[3];      // the grain-free planes (uint8, or uint16 above 8 bits)
    const int16_t* lut;      // (3, 74, 82): each plane's grain table
    const uint8_t* scaling;  // (3, 1 << bpc): the y, cb and cr tables
    const uint8_t* rand;     // (n_rows, n_cols): each luma block's random value
    int bpc;
    int nplanes;             // 1 (4:0:0) or 3
    int sx, sy;              // the chroma planes' subsampling
    int w, h;                // the luma plane's visible size
    int ph[3], pw[3];        // each plane's padded rows and columns (its stride)
    int sc[3];               // each plane's scaling table, -1: copied
    int n_rows, n_cols;
    int overlap, scaling_shift, cfl;
    int uv_mult[2], uv_luma_mult[2], uv_offset[2];
    int lo[2], hi[2];        // the output range: luma, chroma
};

FG_HD int fg_clamp(int v, int lo, int hi) {
    v = v < lo ? lo : v;
    return v > hi ? hi : v;
}

// pixel `off` of a plane (uint16 above 8 bits), a read-only load
FG_HD int fg_px(const void* p, int hbd, size_t off) {
#ifdef __CUDA_ARCH__
    return hbd ? (int)__ldg((const unsigned short*)p + off)
               : (int)__ldg((const unsigned char*)p + off);
#else
    return hbd ? (int)((const uint16_t*)p)[off] : (int)((const uint8_t*)p)[off];
#endif
}

FG_HD void fg_put(void* p, int hbd, size_t off, int v) {
    if (hbd)
        ((uint16_t*)p)[off] = (uint16_t)v;
    else
        ((uint8_t*)p)[off] = (uint8_t)v;
}

FG_HD int fg_ld16(const int16_t* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

FG_HD int fg_ld8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
    return __ldg((const unsigned char*)p);
#else
    return *p;
#endif
}

// a plane's subsampling and visible size
FG_HD void fg_plane(const FgFrame& p, int pl, int* ssx, int* ssy, int* vh, int* vw) {
    *ssx = pl ? p.sx : 0;
    *ssy = pl ? p.sy : 0;
    *vh = (p.h + *ssy) >> *ssy;
    *vw = (p.w + *ssx) >> *ssx;
}

// arguments the earlier form takes: 0, else -1
FG_HD int fg_check(const FgFrame& p) {
    if (p.bpc != 8 && p.bpc != 10 && p.bpc != 12) return -1;
    if ((p.nplanes != 1 && p.nplanes != 3) || p.sx < 0 || p.sx > 1 || p.sy < 0 || p.sy > 1) return -1;
    if (p.w < 1 || p.h < 1 || p.n_rows != (p.h + 31) >> 5 || p.n_cols != (p.w + 31) >> 5) return -1;
    if (p.scaling_shift < 8 || p.scaling_shift > 11) return -1;
    for (int pl = 0; pl < p.nplanes; pl++) {
        int ssx, ssy, vh, vw;
        fg_plane(p, pl, &ssx, &ssy, &vh, &vw);
        if (p.ph[pl] < vh || p.pw[pl] < vw || p.ph[pl] > 65535 * 16) return -1;
        if (p.sc[pl] < -1 || p.sc[pl] > 2) return -1;
    }
    return 0;
}

// the grain table index of random value v's block sample, shifted dy
// rows and dx columns (a neighbour's past its edge)
FG_HD int fg_base(int v, int ssx, int ssy, int dy, int dx) {
    const int offx = 3 + (2 >> ssx) * (3 + (v >> 4));
    const int offy = 3 + (2 >> ssy) * (3 + (v & 15));
    return (offy + dy) * FG_GW + offx + dx;
}

// the overlap weight of `old` (which 0) or the block's own grain (1) at
// position k of a full (ss 0) or subsampled axis
FG_HD int fg_w(int ss, int k, int which) {
    if (ss) return which ? 22 : 23;
    return (k == 0) == (which == 0) ? 27 : 17;
}

FG_HD int fg_blend(int a, int b, int w0, int w1, int gmin, int gmax) {
    return fg_clamp((a * w0 + b * w1 + 16) >> 5, gmin, gmax);
}

// ---------------------------------------------------------------------------
// The new form: 16-byte items, a persistent grid of tiles.

enum {
    FG2_THREADS = 256,        // a block's threads, and a tile's items at most
    FG2_ROWS = 4,             // rows of an item, their loads in flight together
    FG2_BLOCKS_PER_SM = 2,    // the persistent grid's blocks an SM
    FG2_LUT_WORDS = FG_GH * FG_GW / 4,  // a grain table in 8-byte words (1,517)
};

struct FgShared2 {
    alignas(16) int16_t lut[FG_GH * FG_GW];  // the plane's grain table
    alignas(16) uint8_t scaling[4096];       // its scaling table
};

#ifdef __CUDACC__
typedef uint4 FgVec;
#else
struct FgVec {
    uint32_t x, y, z, w;
};
#endif

FG_HD uint32_t fg_word(const FgVec& v, int k) { return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w; }

FG_HD FgVec fg_vec(const uint32_t* w) {
    FgVec v;
    v.x = w[0];
    v.y = w[1];
    v.z = w[2];
    v.w = w[3];
    return v;
}

// 16 bytes at p (16-byte aligned), a read-only load
FG_HD FgVec fg_ldv(const char* p) {
#ifdef __CUDA_ARCH__
    return __ldg((const uint4*)p);
#else
    FgVec v;
    memcpy(&v, p, 16);
    return v;
#endif
}

FG_HD void fg_stv(char* p, const FgVec& v) {
#ifdef __CUDA_ARCH__
    *(uint4*)p = v;
#else
    memcpy(p, &v, 16);
#endif
}

// 8 bytes from global `src` to shared `dst`, both 8-byte aligned
FG_HD void fg_copy8(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
    *(unsigned long long*)dst = __ldg((const unsigned long long*)src);
#else
    memcpy(dst, src, 8);
#endif
}

// PRMT: bytes of the 8-byte {b, a} picked by the selector's nibbles
// (0-3: a's bytes, 4-7: b's), one instruction on the card
FG_HD uint32_t fg_perm(uint32_t a, uint32_t b, uint32_t sel) {
#ifdef __CUDA_ARCH__
    return __byte_perm(a, b, sel);
#else
    const uint64_t x = (uint64_t)b << 32 | a;
    uint32_t r = 0;
    for (int i = 0; i < 4; i++) r |= (uint32_t)(x >> (8 * ((sel >> (4 * i)) & 7)) & 0xff) << (8 * i);
    return r;
#endif
}

// pixel k (k fixed at compile time once unrolled) of a 16-byte vector
template <bool HBD>
FG_HD int fg_vpx(const FgVec& v, int k) {
    if (HBD) return (int)fg_perm(fg_word(v, k >> 1), 0, k & 1 ? 0x4432 : 0x4410);
    return (int)fg_perm(fg_word(v, k >> 2), 0, 0x4440 | (k & 3));
}

// four 8-bit pixel values (each below 256) packed into a word
FG_HD uint32_t fg_pack4(uint32_t p0, uint32_t p1, uint32_t p2, uint32_t p3) {
    return fg_perm(fg_perm(p0, p1, 0x0040), fg_perm(p2, p3, 0x0040), 0x5410);
}

FG_HD int fg2_esz(const FgFrame& p) { return p.bpc > 8 ? 2 : 1; }

// a plane's 16-byte columns a row and its row groups
FG_HD int fg2_vecs(const FgFrame& p, int pl) { return p.pw[pl] * fg2_esz(p) / 16; }
FG_HD int fg2_groups(const FgFrame& p, int pl) { return (p.ph[pl] + FG2_ROWS - 1) / FG2_ROWS; }

// arguments the new form takes: the earlier form's, and every plane's
// base and stride a multiple of 16 bytes, the tables 8-byte aligned, the
// luma a chroma item reads inside the luma plane's rows
FG_HD int fg2_check(const FgFrame& p) {
    if (fg_check(p)) return -1;
    if (((uintptr_t)p.lut | (uintptr_t)p.scaling) & 7) return -1;
    const int esz = fg2_esz(p), npx = 16 / esz;
    for (int pl = 0; pl < p.nplanes; pl++) {
        if ((((uintptr_t)p.src[pl] | (uintptr_t)p.out[pl]) & 15) || (p.pw[pl] * esz) & 15) return -1;
        if (p.pw[pl] > 65536) return -1;
        int ssx, ssy, vh, vw;
        fg_plane(p, pl, &ssx, &ssy, &vh, &vw);
        if (pl && p.sc[pl] >= 0 && ((vw + npx - 1) / npx * npx) << ssx > p.pw[0]) return -1;
    }
    return 0;
}

// each plane's tiles (FG2_THREADS items, the last one fewer), and their sum
struct FgPlan {
    int tiles[3], total;
};

FG_HD FgPlan fg2_plan(const FgFrame& p) {
    FgPlan q;
    q.total = 0;
    for (int pl = 0; pl < 3; pl++) {
        const int items = pl < p.nplanes ? fg2_groups(p, pl) * fg2_vecs(p, pl) : 0;
        q.tiles[pl] = (items + FG2_THREADS - 1) / FG2_THREADS;
        q.total += q.tiles[pl];
    }
    return q;
}

// block b's tiles of `grid`: a contiguous range, plane after plane
FG_HD void fg2_range(const FgPlan& q, int b, int grid, int* t0, int* t1) {
    *t0 = (int)((long long)q.total * b / grid);
    *t1 = (int)((long long)q.total * (b + 1) / grid);
}

// A tile: its plane, its first item in the plane, and whether the block
// stages the plane's tables for it (the plane has grain and the tile's
// first row is visible; the same for every thread of the block)
struct FgTile {
    int pl, item0, stage;
};

FG_HD FgTile fg2_tile(const FgFrame& p, const FgPlan& q, int T) {
    FgTile tl;
    tl.pl = 0;
    while (T >= q.tiles[tl.pl]) T -= q.tiles[tl.pl++];
    tl.item0 = T * FG2_THREADS;
    int ssx, ssy, vh, vw;
    fg_plane(p, tl.pl, &ssx, &ssy, &vh, &vw);
    tl.stage = p.sc[tl.pl] >= 0 && tl.item0 / fg2_vecs(p, tl.pl) * FG2_ROWS < vh;
    return tl;
}

// A thread's item: its rows as loaded, the co-located luma of a chroma
// item, and its table bases (each at the item's first row)
struct FgItem {
    FgVec s[FG2_ROWS];
    FgVec l[FG2_ROWS][2];
    int y0, x0;               // its first row and column (pixels)
    int ok;                   // inside the plane
    int grain;                // pixels to grain
    int cur, top, left, tl;   // table bases: own, top, left, top-left
    int xm;                   // the left overlap on its first columns
    int ytop;                 // its rows with the top overlap
};

// step 1: thread t's item of the tile: its rows' loads (and the luma's),
// its random values and table bases
FG_HD void fg2_load(const FgFrame& p, const FgTile& tl, int t, FgItem& it) {
    const int pl = tl.pl, esz = fg2_esz(p), V = fg2_vecs(p, pl);
    const int item = tl.item0 + t, g = item / V;
    it.y0 = g * FG2_ROWS;
    it.x0 = (item - g * V) * (16 / esz);
    it.ok = it.y0 < p.ph[pl];  // items past the plane's last: rows past it
    it.grain = 0;
    if (!it.ok) return;
    int ssx, ssy, vh, vw;
    fg_plane(p, pl, &ssx, &ssy, &vh, &vw);
    const size_t stride = (size_t)p.pw[pl] * esz;
    const char* src = (const char*)p.src[pl] + (size_t)it.y0 * stride + (size_t)it.x0 * esz;
#pragma unroll
    for (int i = 0; i < FG2_ROWS; i++)
        if (it.y0 + i < p.ph[pl]) it.s[i] = fg_ldv(src + i * stride);
    it.grain = p.sc[pl] >= 0 && it.y0 < vh && it.x0 < vw;
    if (!it.grain) return;
    if (pl) {  // the co-located luma rows, 16 or 32 bytes each
        const size_t ls = (size_t)p.pw[0] * esz;
        const char* lum = (const char*)p.src[0] + (size_t)(it.y0 << ssy) * ls + (size_t)(it.x0 << ssx) * esz;
#pragma unroll
        for (int i = 0; i < FG2_ROWS; i++)
            if (it.y0 + i < vh) {
                it.l[i][0] = fg_ldv(lum + (i << ssy) * ls);
                if (ssx) it.l[i][1] = fg_ldv(lum + (i << ssy) * ls + 16);
            }
    }
    const int bw = 32 >> ssx, bh = 32 >> ssy;
    const int r = it.y0 / bh, c = it.x0 / bw, i0 = it.y0 - r * bh, j0 = it.x0 - c * bw;
    const uint8_t* rr = p.rand + (size_t)r * p.n_cols + c;
    it.xm = p.overlap && c > 0 && j0 == 0;
    it.ytop = p.overlap && r > 0 && i0 == 0 ? 2 >> ssy : 0;
    it.cur = fg_base(fg_ld8(rr), ssx, ssy, i0, 0) + j0;
    it.top = it.ytop ? fg_base(fg_ld8(rr - p.n_cols), ssx, ssy, bh, 0) + j0 : 0;
    it.left = it.xm ? fg_base(fg_ld8(rr - 1), ssx, ssy, i0, bw) : 0;
    it.tl = it.xm && it.ytop ? fg_base(fg_ld8(rr - p.n_cols - 1), ssx, ssy, bh, bw) : 0;
}

// step 2 (a block entering a plane to grain): thread t's share of the
// plane's grain table and scaling table, 8 bytes a load
FG_HD void fg2_stage(const FgFrame& p, int pl, FgShared2* sm, int t) {
    const char* lut = (const char*)(p.lut + (size_t)pl * FG_GH * FG_GW);
    for (int k = t; k < FG2_LUT_WORDS; k += FG2_THREADS) fg_copy8((char*)sm->lut + 8 * k, lut + 8 * k);
    const int n = 1 << p.bpc;
    const char* sc = (const char*)p.scaling + (size_t)p.sc[pl] * n;
    for (int k = t; k < n / 8; k += FG2_THREADS) fg_copy8(sm->scaling + 8 * k, sc + 8 * k);
}

// An item's kind, the same for every item of a tile: luma, chroma at the
// luma's width, chroma subsampled across (two luma columns a pixel).
enum { FG_LUMA, FG_CHROMA, FG_CHROMA_SSX };

// What the pixels of an item share (the picture's constants are read from
// the launch's arguments where they are used).
struct FgRow {
    const int16_t* L;          // the staged grain table, at the row
    int cur, top, left, tl;    // table bases
    int xm, wy0, wy1;          // the left overlap on its first columns; the top one's weights
    uint32_t vis[4];           // each output word's visible pixels' bits
    int uvl, uvm, uvo, lxw;    // lxw: pixels whose luma pair lies inside w
    int pxmax, gmin, gmax, rnd;
};

// The co-located luma of a row of chroma items: each pixel's average of
// its luma pair (KIND FG_CHROMA_SSX; two pairs a word at 8 bits), or its
// luma (FG_CHROMA). Past the edge a pair's right column is w - 1: on the
// item at the picture's right edge (EDGE) a pixel k >= lxw averages its
// left luma with itself (k = lxw is the last visible pixel at an odd
// width; every later one is copied, not grained). Every index is fixed at
// compile time, so the rows stay in registers.
template <bool HBD, int KIND, bool EDGE>
FG_HD void fg2_luma(const FgRow& r, const FgVec& l0, const FgVec& l1, int* avg) {
    enum { NPX = HBD ? 8 : 16 };
    if (KIND == FG_CHROMA) {
#pragma unroll
        for (int k = 0; k < NPX; k++) avg[k] = fg_vpx<HBD>(l0, k);
        return;
    }
#pragma unroll
    for (int q = 0; q < 8; q++) {  // the luma pairs' 8 words
        const uint32_t x = fg_word(q < 4 ? l0 : l1, q & 3);
        if (HBD) {  // a pair a word
            const uint32_t lo = x & 0xffff;
            const uint32_t hi = EDGE && q >= r.lxw ? lo : x >> 16;
            avg[q] = (int)((lo + hi + 1) >> 1);
        } else {  // two pairs in 16-bit lanes; bytes 0 and 2 hold the averages
            const uint32_t e = x & 0x00ff00ff;
            uint32_t o = (x >> 8) & 0x00ff00ff;
            if (EDGE) {
                const uint32_t m = (2 * q < r.lxw ? 0xffffu : 0u) | (2 * q + 1 < r.lxw ? 0xffff0000u : 0u);
                o = (o & m) | (e & ~m);
            }
            const uint32_t a = (e + o + 0x00010001) >> 1;
            avg[2 * q] = (int)fg_perm(a, 0, 0x4440);
            avg[2 * q + 1] = (int)fg_perm(a, 0, 0x4442);
        }
    }
}

// pixel K of an item's row of kind KIND (YT: a row with the top overlap)
// grained: src its source value, avg its co-located luma (chroma)
template <bool HBD, int KIND, bool YT, int K>
FG_HD uint32_t fg2_px(const FgFrame& p, const FgRow& r, const uint8_t* S, int src, int avg) {
    enum { SSX = KIND == FG_CHROMA_SSX, XN = 2 >> SSX, C = KIND != FG_LUMA };  // XN: the left overlap's columns
    int g = r.L[r.cur + K];
    if (K < XN) {
        const int b = fg_blend(r.L[r.left + K], g, fg_w(SSX, K, 0), fg_w(SSX, K, 1), r.gmin, r.gmax);
        g = r.xm ? b : g;
    }
    if (YT) {
        int a = r.L[r.top + K];
        if (K < XN) {
            const int ab = fg_blend(r.L[r.tl + K], a, fg_w(SSX, K, 0), fg_w(SSX, K, 1), r.gmin, r.gmax);
            a = r.xm ? ab : a;
        }
        g = fg_blend(a, g, r.wy0, r.wy1, r.gmin, r.gmax);
    }
    int v = src;
    if (C) v = p.cfl ? avg : fg_clamp(((avg * r.uvl + src * r.uvm) >> 6) + r.uvo, 0, r.pxmax);
    if (HBD) v = fg_clamp(v, 0, r.pxmax);  // 8-bit values index 256 entries
    return (uint32_t)fg_clamp(src + (((int)S[v] * g + r.rnd) >> p.scaling_shift), p.lo[C], p.hi[C]);
}

// word Q of an item's output row: its 4 (2 above 8 bits) pixels grained
// where visible, else copied
template <bool HBD, int KIND, bool YT, int Q>
FG_HD uint32_t fg2_word(const FgFrame& p, const FgRow& r, const uint8_t* S, const FgVec& s, const int* avg) {
    const uint32_t w = fg_word(s, Q);
    uint32_t g;
    if (HBD) {
        g = fg_perm(fg2_px<HBD, KIND, YT, 2 * Q>(p, r, S, (int)(w & 0xffff), avg[2 * Q]),
                    fg2_px<HBD, KIND, YT, 2 * Q + 1>(p, r, S, (int)(w >> 16), avg[2 * Q + 1]), 0x5410);
    } else {
        g = fg_pack4(fg2_px<HBD, KIND, YT, 4 * Q>(p, r, S, (int)fg_perm(w, 0, 0x4440), avg[4 * Q]),
                     fg2_px<HBD, KIND, YT, 4 * Q + 1>(p, r, S, (int)fg_perm(w, 0, 0x4441), avg[4 * Q + 1]),
                     fg2_px<HBD, KIND, YT, 4 * Q + 2>(p, r, S, (int)fg_perm(w, 0, 0x4442), avg[4 * Q + 2]),
                     fg2_px<HBD, KIND, YT, 4 * Q + 3>(p, r, S, (int)(w >> 24), avg[4 * Q + 3]));
    }
    return (g & r.vis[Q]) | (w & ~r.vis[Q]);
}

template <bool HBD, int KIND, bool YT>
FG_HD FgVec fg2_row(const FgFrame& p, const FgRow& r, const uint8_t* S, const FgVec& s, const FgVec& l0,
                    const FgVec& l1) {
    enum { NPX = HBD ? 8 : 16 };
    int avg[NPX] = {};
    if (KIND == FG_CHROMA_SSX && (unsigned)r.lxw < (unsigned)NPX)
        fg2_luma<HBD, KIND, true>(r, l0, l1, avg);
    else if (KIND != FG_LUMA)
        fg2_luma<HBD, KIND, false>(r, l0, l1, avg);
    FgVec o;
    o.x = fg2_word<HBD, KIND, YT, 0>(p, r, S, s, avg);
    o.y = fg2_word<HBD, KIND, YT, 1>(p, r, S, s, avg);
    o.z = fg2_word<HBD, KIND, YT, 2>(p, r, S, s, avg);
    o.w = fg2_word<HBD, KIND, YT, 3>(p, r, S, s, avg);
    return o;
}

// step 3: thread t's item of a tile of kind KIND, grained or copied, one
// 16-byte store a row
template <bool HBD, int KIND>
FG_HD void fg2_out(const FgFrame& p, const FgTile& tl, const FgItem& it, const FgShared2* sm) {
    if (!it.ok) return;
    enum { ESZ = HBD ? 2 : 1 };
    const int pl = tl.pl;
    int ssx, ssy, vh, vw;
    fg_plane(p, pl, &ssx, &ssy, &vh, &vw);
    const size_t stride = (size_t)p.pw[pl] * ESZ;
    char* out = (char*)p.out[pl] + (size_t)it.y0 * stride + (size_t)it.x0 * ESZ;
    FgRow r = {};
    if (it.grain) {
        const int bdm8 = p.bpc - 8, uv = pl ? pl - 1 : 0;
        r.cur = it.cur;
        r.top = it.top;
        r.left = it.left;
        r.tl = it.tl;
        r.xm = it.xm;
        const int nvis = vw - it.x0, pw = 4 / ESZ;  // its visible pixels; pixels a word
        for (int q = 0; q < 4; q++) {
            const int k = nvis - q * pw;  // the word's visible pixels
            r.vis[q] = k >= pw ? 0xffffffffu : k <= 0 ? 0u : (1u << (8 * ESZ * k)) - 1;
        }
        r.uvl = p.uv_luma_mult[uv];
        r.uvm = p.uv_mult[uv];
        r.uvo = p.uv_offset[uv] * (1 << bdm8);
        r.lxw = (p.w >> 1) - it.x0;
        r.pxmax = (1 << p.bpc) - 1;
        r.gmin = -(128 << bdm8);
        r.gmax = (128 << bdm8) - 1;
        r.rnd = (1 << p.scaling_shift) >> 1;
    }
#pragma unroll
    for (int i = 0; i < FG2_ROWS; i++) {
        if (it.y0 + i < p.ph[pl]) {
            FgVec o = it.s[i];
            if (it.grain && it.y0 + i < vh) {
                r.L = sm->lut + i * FG_GW;
                const FgVec &s = it.s[i], &l0 = it.l[i][0], &l1 = it.l[i][1];
                if (i < 2 && i < it.ytop) {  // the top overlap's rows (2 >> ss_y)
                    r.wy0 = fg_w(ssy, i, 0);
                    r.wy1 = fg_w(ssy, i, 1);
                    o = fg2_row<HBD, KIND, true>(p, r, sm->scaling, s, l0, l1);
                } else {
                    o = fg2_row<HBD, KIND, false>(p, r, sm->scaling, s, l0, l1);
                }
            }
            fg_stv(out + i * stride, o);
        }
    }
}

// step 3 for any tile: its kind chosen once (the same for the block)
template <bool HBD>
FG_HD void fg2_out_tile(const FgFrame& p, const FgTile& tl, const FgItem& it, const FgShared2* sm) {
    if (tl.pl == 0)
        fg2_out<HBD, FG_LUMA>(p, tl, it, sm);
    else if (p.sx)
        fg2_out<HBD, FG_CHROMA_SSX>(p, tl, it, sm);
    else
        fg2_out<HBD, FG_CHROMA>(p, tl, it, sm);
}

#ifdef __CUDACC__

// The traced builds' stamps, per block (thread 0, after a block barrier):
// its SM, clock64 at its start and end, the cycles it spent staging
// tables (from the barrier before a staging to the one after), its tiles
// (0: a block with nothing to do), its stagings, and the global timer
// (ns) at its start and end.
enum { FG_ST_SM, FG_ST_START, FG_ST_END, FG_ST_STAGE, FG_ST_TILES, FG_ST_STAGES, FG_ST_T0, FG_ST_T1, FG_STAMPS };

__device__ __forceinline__ long long fg_ns() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

template <bool TRACE>
__device__ __forceinline__ void fg_stamps(long long* clk, long long c0, long long t0, long long stage, int tiles,
                                          int stages) {
    if (!TRACE) return;
    __syncthreads();
    if (threadIdx.x) return;
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    const size_t b = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    long long* s = clk + b * FG_STAMPS;
    s[FG_ST_SM] = sm;
    s[FG_ST_START] = c0;
    s[FG_ST_END] = clock64();
    s[FG_ST_STAGE] = stage;
    s[FG_ST_TILES] = tiles;
    s[FG_ST_STAGES] = stages;
    s[FG_ST_T0] = t0;
    s[FG_ST_T1] = fg_ns();
}

template <bool HBD, bool TRACE>
__global__ void __launch_bounds__(FG2_THREADS, FG2_BLOCKS_PER_SM)
    fg_tiles_kernel(const __grid_constant__ FgFrame p, long long* clk) {
    __shared__ FgShared2 sm;
    const long long c0 = TRACE ? clock64() : 0, t0 = TRACE ? fg_ns() : 0;
    long long stage = 0;
    const FgPlan q = fg2_plan(p);
    int T0, T1, staged = -1, stages = 0;
    fg2_range(q, blockIdx.x, gridDim.x, &T0, &T1);
    for (int T = T0; T < T1; T++) {
        const FgTile tl = fg2_tile(p, q, T);
        FgItem it;
        fg2_load(p, tl, threadIdx.x, it);
        if (tl.stage && tl.pl != staged) {  // the same for every thread of the block
            const long long s0 = TRACE ? clock64() : 0;
            __syncthreads();  // the last plane's table read by every thread
            fg2_stage(p, tl.pl, &sm, threadIdx.x);
            __syncthreads();
            staged = tl.pl;
            stages++;
            if (TRACE) stage += clock64() - s0;
        }
        fg2_out_tile<HBD>(p, tl, it, &sm);
    }
    fg_stamps<TRACE>(clk, c0, t0, stage, T1 - T0, stages);
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// The earlier form: a block per (256 columns, block row, plane).

struct FgShared {
    int16_t lut[FG_GH * FG_GW];
    uint8_t scaling[4096];
    uint8_t rnd[2][FG_RC];   // block rows r - 1 and r, block columns c0 - 1 ..
};

// the launch's grid: (column blocks, block rows, planes) of the largest plane
FG_HD void fg_grid(const FgFrame& p, int* gx, int* gy) {
    *gx = *gy = 0;
    for (int pl = 0; pl < p.nplanes; pl++) {
        const int bh = 32 >> (pl ? p.sy : 0);
        const int cols = (p.pw[pl] + FG_T - 1) / FG_T, rows = (p.ph[pl] + bh - 1) / bh;
        if (cols > *gx) *gx = cols;
        if (rows > *gy) *gy = rows;
    }
}

// One block: its plane, block row and columns.
struct FgBlock {
    int pl, ssx, ssy, bw, bh;
    int r, x0, y0;
    int nrow;                // the plane's rows in the block: 0 for a block past the plane
    int vh, vw;              // the plane's visible size
    int active;              // pixels to grain: the block stages the tables
    int c0;                  // its first block column
    FgShared* sm;
};

FG_HD FgBlock fg_block(const FgFrame& p, int bx, int by, int z, FgShared* sm) {
    FgBlock b;
    b.pl = z;
    b.sm = sm;
    fg_plane(p, z, &b.ssx, &b.ssy, &b.vh, &b.vw);
    b.bw = 32 >> b.ssx;
    b.bh = 32 >> b.ssy;
    b.r = by;
    b.x0 = bx * FG_T;
    b.y0 = by * b.bh;
    b.c0 = b.x0 / b.bw;
    b.nrow = b.active = 0;
    if (z >= p.nplanes || b.y0 >= p.ph[z] || b.x0 >= p.pw[z]) return b;
    b.nrow = p.ph[z] - b.y0 < b.bh ? p.ph[z] - b.y0 : b.bh;
    b.active = p.sc[z] >= 0 && b.y0 < b.vh && b.x0 < b.vw;
    return b;
}

// step 1 (a block with pixels to grain): thread t's share of the plane's
// grain table, its scaling table and the block's random values
FG_HD void fg_stage(const FgFrame& p, const FgBlock& b, int t) {
    const int16_t* lut = p.lut + (size_t)b.pl * FG_GH * FG_GW;
    for (int k = t; k < FG_GH * FG_GW; k += FG_THREADS) b.sm->lut[k] = (int16_t)fg_ld16(lut + k);
    const int n = 1 << p.bpc;
    const uint8_t* sc = p.scaling + (size_t)p.sc[b.pl] * n;
    for (int k = t; k < n; k += FG_THREADS) b.sm->scaling[k] = (uint8_t)fg_ld8(sc + k);
    for (int k = t; k < 2 * FG_RC; k += FG_THREADS) {
        const int row = b.r - 1 + k / FG_RC, col = b.c0 - 1 + k % FG_RC;
        const int in = row >= 0 && row < p.n_rows && col >= 0 && col < p.n_cols;
        b.sm->rnd[k / FG_RC][k % FG_RC] = (uint8_t)(in ? fg_ld8(p.rand + (size_t)row * p.n_cols + col) : 0);
    }
}

// step 2: thread t's column in each row of the block, grained or copied
FG_HD void fg_out(const FgFrame& p, const FgBlock& b, int t) {
    const int x = b.x0 + t;
    if (!b.nrow || t >= FG_T || x >= p.pw[b.pl]) return;
    const int hbd = p.bpc > 8;
    const size_t stride = (size_t)p.pw[b.pl];
    const void* src = p.src[b.pl];
    void* out = p.out[b.pl];
    const int grain = b.active && x < b.vw;
    int cur = 0, left = 0, top = 0, tl = 0, xm = 0, wx0 = 0, wx1 = 0;
    if (grain) {
        const int c = x / b.bw, j = x % b.bw, k = c - b.c0 + 1;
        const uint8_t* up = b.sm->rnd[0];
        const uint8_t* own = b.sm->rnd[1];
        cur = fg_base(own[k], b.ssx, b.ssy, 0, 0) + j;
        top = fg_base(up[k], b.ssx, b.ssy, b.bh, 0) + j;
        xm = p.overlap && c > 0 && j < (2 >> b.ssx);
        if (xm) {
            left = fg_base(own[k - 1], b.ssx, b.ssy, 0, b.bw) + j;
            tl = fg_base(up[k - 1], b.ssx, b.ssy, b.bh, b.bw) + j;
            wx0 = fg_w(b.ssx, j, 0);
            wx1 = fg_w(b.ssx, j, 1);
        }
    }
    const int bdm8 = p.bpc - 8;
    const int gmin = -(128 << bdm8), gmax = (128 << bdm8) - 1;
    const int pxmax = (1 << p.bpc) - 1;
    const int lo = p.lo[b.pl ? 1 : 0], hi = p.hi[b.pl ? 1 : 0];
    const int rnd = (1 << p.scaling_shift) >> 1;
    const int ytop = p.overlap && b.r > 0 ? 2 >> b.ssy : 0;
    const int16_t* L = b.sm->lut;
    for (int i = 0; i < b.nrow; i++) {
        const int y = b.y0 + i;
        const size_t off = (size_t)y * stride + x;
        int s = fg_px(src, hbd, off);
        if (grain && y < b.vh) {
            const int o = i * FG_GW;
            int g = L[cur + o];
            if (xm) g = fg_blend(L[left + o], g, wx0, wx1, gmin, gmax);
            if (i < ytop) {
                int a = L[top + o];
                if (xm) a = fg_blend(L[tl + o], a, wx0, wx1, gmin, gmax);
                g = fg_blend(a, g, fg_w(b.ssy, i, 0), fg_w(b.ssy, i, 1), gmin, gmax);
            }
            int v = s;
            if (b.pl) {  // the co-located luma (column w - 1 past the edge)
                const size_t row = (size_t)(y << b.ssy) * p.pw[0];
                const int lx = x << b.ssx;
                int avg = fg_px(p.src[0], hbd, row + lx);
                if (b.ssx)
                    avg = (avg + fg_px(p.src[0], hbd, row + (lx + 1 < p.w ? lx + 1 : p.w - 1)) + 1) >> 1;
                if (p.cfl) {
                    v = avg;
                } else {
                    const int uv = b.pl - 1;
                    v = fg_clamp(((avg * p.uv_luma_mult[uv] + s * p.uv_mult[uv]) >> 6)
                                     + p.uv_offset[uv] * (1 << bdm8), 0, pxmax);
                }
            }
            const int noise = ((int)b.sm->scaling[fg_clamp(v, 0, pxmax)] * g + rnd) >> p.scaling_shift;
            s = fg_clamp(s + noise, lo, hi);
        }
        fg_put(out, hbd, off, s);
    }
}

#ifdef __CUDACC__

template <bool TRACE>
__global__ void __launch_bounds__(FG_THREADS) fg_frame_kernel(const __grid_constant__ FgFrame p, long long* clk) {
    __shared__ FgShared sm;
    const long long c0 = TRACE ? clock64() : 0, t0 = TRACE ? fg_ns() : 0;
    const FgBlock b = fg_block(p, blockIdx.x, blockIdx.y, blockIdx.z, &sm);
    long long stage = 0;
    if (b.active) {  // the same for every thread of the block
        fg_stage(p, b, threadIdx.x);
        __syncthreads();
        if (TRACE) stage = clock64() - c0;
    }
    fg_out(p, b, threadIdx.x);
    fg_stamps<TRACE>(clk, c0, t0, stage, b.nrow ? 1 : 0, b.active);
}

// the new form's grid on the current card: FG2_BLOCKS_PER_SM blocks an SM,
// at most one a tile; 0 where the card's SMs cannot be read
static int fg2_grid(const FgPlan& q) {
    static int sms[64];  // each card's SMs, read once
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 0;
    int n = dev >= 0 && dev < 64 ? sms[dev] : 0;
    if (!n && cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    if (dev >= 0 && dev < 64) sms[dev] = n;
    const int g = FG2_BLOCKS_PER_SM * n;
    return q.total < g ? q.total : g;
}

static int fg_launch(const void* kernel, dim3 grid, int threads, const FgFrame* f, long long* clk, void* stream) {
    void* args[] = {(void*)f, (void*)&clk};
    const cudaError_t e = cudaLaunchKernel(kernel, grid, dim3(threads), args, 0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// the tables' `n` bytes at `host` (page-locked) copied to the device at
// f->lut, on the stream ahead of the launch
static int fg_tables(const FgFrame* f, const void* host, long long n, void* stream) {
    if (n <= 0) return 0;
    return (int)cudaMemcpyAsync((void*)f->lut, host, (size_t)n, cudaMemcpyHostToDevice, (cudaStream_t)stream);
}

static int fg2_run(const FgFrame* f, const void* host, long long n, long long* clk, void* stream) {
    if (fg2_check(*f)) return -1;
    const int grid = fg2_grid(fg2_plan(*f));
    if (grid < 1) return -1;
    if (const int e = fg_tables(f, host, n, stream)) return e;
    const void* k = f->bpc > 8 ? (clk ? (const void*)fg_tiles_kernel<true, true> : (const void*)fg_tiles_kernel<true, false>)
                               : (clk ? (const void*)fg_tiles_kernel<false, true> : (const void*)fg_tiles_kernel<false, false>);
    return fg_launch(k, dim3(grid), FG2_THREADS, f, clk, stream);
}

static int fg_run_earlier(const FgFrame* f, const void* host, long long n, long long* clk, void* stream) {
    if (fg_check(*f)) return -1;
    if (const int e = fg_tables(f, host, n, stream)) return e;
    int gx, gy;
    fg_grid(*f, &gx, &gy);
    const void* k = clk ? (const void*)fg_frame_kernel<true> : (const void*)fg_frame_kernel<false>;
    return fg_launch(k, dim3(gx, gy, f->nplanes), FG_THREADS, f, clk, stream);
}

// Plain C entries (bound with ctypes): the tables' `n` bytes at `host`
// copied to f->lut (none for n = 0), then one launch over every plane, on
// `stream`. Each returns the first error code (-1 for arguments the
// kernel does not take, before anything is queued).
extern "C" int rav1d_fg_frame(const FgFrame* f, const void* host, long long n, void* stream) {
    return fg2_run(f, host, n, nullptr, stream);
}

extern "C" int rav1d_fg_frame_earlier(const FgFrame* f, const void* host, long long n, void* stream) {
    return fg_run_earlier(f, host, n, nullptr, stream);
}

// The traced builds: the same, each block's FG_STAMPS stamps into `clk`
// (int64, rav1d_fg_grid(f, form) blocks).
extern "C" int rav1d_fg_frame_trace(const FgFrame* f, const void* host, long long n, long long* clk, void* stream) {
    return fg2_run(f, host, n, clk, stream);
}

extern "C" int rav1d_fg_frame_earlier_trace(const FgFrame* f, const void* host, long long n, long long* clk,
                                            void* stream) {
    return fg_run_earlier(f, host, n, clk, stream);
}

// the blocks of form 1 (the new one) or 0 (the earlier one) on the current
// card, -1 for arguments that form does not take
extern "C" int rav1d_fg_grid(const FgFrame* f, int form) {
    if (form) return fg2_check(*f) ? -1 : fg2_grid(fg2_plan(*f));
    if (fg_check(*f)) return -1;
    int gx, gy;
    fg_grid(*f, &gx, &gy);
    return gx * gy * f->nplanes;
}

extern "C" int rav1d_fg_stamps(void) { return FG_STAMPS; }

#else  // a host build of the same functions, for the CPU tests

#include <vector>

template <bool HBD>
static void fg2_host(const FgFrame& f, int grid) {
    const FgPlan q = fg2_plan(f);
    std::vector<FgItem> items(FG2_THREADS);
    std::vector<FgShared2> sm(1);
    for (int b = 0; b < grid; b++) {
        memset(sm.data(), 0x5a, sizeof(FgShared2));
        int T0, T1, staged = -1;
        fg2_range(q, b, grid, &T0, &T1);
        for (int T = T0; T < T1; T++) {
            const FgTile tl = fg2_tile(f, q, T);
            for (int t = 0; t < FG2_THREADS; t++) fg2_load(f, tl, t, items[t]);
            if (tl.stage && tl.pl != staged) {
                for (int t = 0; t < FG2_THREADS; t++) fg2_stage(f, tl.pl, sm.data(), t);
                staged = tl.pl;
            }
            for (int t = 0; t < FG2_THREADS; t++) fg2_out_tile<HBD>(f, tl, items[t], sm.data());
        }
    }
}

// the picture's tiles (the new form's grid is at most one block a tile)
extern "C" int rav1d_fg_tiles(const FgFrame* f) { return fg2_check(*f) ? -1 : fg2_plan(*f).total; }

// rav1d_fg_frame without the stream, on a grid of `grid` blocks (at most
// one a tile): every block in order, its tiles in order, each step for
// every thread in turn (shared memory filled with a pattern before each
// block, so that a read of a byte no thread staged shows).
extern "C" int rav1d_fg_frame_host(const FgFrame* f, int grid) {
    if (fg2_check(*f)) return -1;
    const int total = fg2_plan(*f).total;
    if (grid < 1 || grid > total) grid = total;
    if (f->bpc > 8)
        fg2_host<true>(*f, grid);
    else
        fg2_host<false>(*f, grid);
    return 0;
}

// rav1d_fg_frame_earlier without the stream: every block in order, each
// step for every thread in turn (shared memory filled with a pattern
// before each block).
extern "C" int rav1d_fg_frame_earlier_host(const FgFrame* f) {
    if (fg_check(*f)) return -1;
    int gx, gy;
    fg_grid(*f, &gx, &gy);
    std::vector<FgShared> sm(1);
    for (int z = 0; z < f->nplanes; z++)
        for (int by = 0; by < gy; by++)
            for (int bx = 0; bx < gx; bx++) {
                memset(sm.data(), 0x5a, sizeof(FgShared));
                const FgBlock b = fg_block(*f, bx, by, z, sm.data());
                if (b.active)
                    for (int t = 0; t < FG_THREADS; t++) fg_stage(*f, b, t);
                for (int t = 0; t < FG_THREADS; t++) fg_out(*f, b, t);
            }
    return 0;
}

#endif  // __CUDACC__
