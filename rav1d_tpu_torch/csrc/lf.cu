// The deblocking filter of a frame, CUDA C++ for sm_90a: one launch per
// direction, every plane of the frame in it. Two forms:
// - rav1d_deblock (kernels lf_rows_kernel, lf_cols_kernel): the form on
//   the decoder path (ops/cuda/filters.py lf_pass);
// - rav1d_lf_pass (kernel lf_pass_kernel): the earlier form, one block per
//   line, kept for comparison (ops/cuda/filters.py lf_pass_lines); no
//   decoder path runs it.
//
// Both replace the XLA device kernel the JAX engine runs six times a frame
// (three planes, two directions): rav1d_tpu/engine/filters.py
// lf_dir_pass_raw (:34) over rav1d_tpu/ops/tpu/lf.py filter_lines_batch
// (:20), called by rav1d_tpu/engine/mega.py filter_prog (:678). The port's
// plain version is engine/filters.py lf_dir_pass over ops/lf.py
// filter_lines_batch (engine/programs.py filter_plain); both compute
// exactly what it computes.
//
// What the plain version computes, per (plane, direction): the plane
// (transposed for horizontal edges, so a "line" is a plane row for the
// vertical-edge pass and a plane column for the horizontal one) zero-padded
// by 8 before and 16 after each line; lines 0 .. 4 * nh4 - 1, each cut into
// nw4 cells whose edge is the cell's left boundary (q0 at line position
// 4x). For width class 1, then 2, then 3: every cell reads its 16-pixel
// window (positions 4x - 8 .. 4x + 7) from the line as the previous class
// left it, the cells of that class with a nonzero level are filtered
// (filter width 4/8/16 for luma, 4/6/8 for chroma; E and I from the
// blob's lut at hdr[DB0] by level, H = level >> 4), and the window's
// write extent (WRITE_EXTENT) is written back k = lo .. hi - 1 in order,
// so where two selected cells of one class cover a pixel, the one further
// left (the larger k) wins. Pixels past the plane read as 0 and their
// writes stay in the padding, where a later class of the same line reads
// them; only the plane's own pixels are stored.
//
// Design of rav1d_deblock: one thread block of 256 threads per group of
// adjacent lines of one plane (every window lies on its line, so a group
// has no seam a window crosses): for vertical edges the 4 rows of one map
// row, so the cell bytes are read once for 4 lines; for horizontal edges a
// band of 8 adjacent columns over all the plane's rows, read and written a
// row segment of the band at a time (coalesced: 8 columns are one 32-byte
// sector), transposed into shared memory so that each column is a line
// there too. (Lines too long for two buffers in shared memory take groups
// of 2 or 1.) A block first reads its map rows and the E/I luts into
// shared memory and lists each class's selected cells there; a group with
// no selected cell of any class loads and stores nothing, and only the
// lines of map rows with a selected cell are loaded and stored, and only
// the positions a window can reach (4 * nw4 + 12 padded words). The padded
// lines sit in shared memory as int16 (exact for pixels of up to 15 bits:
// the filter's outputs lie between its inputs, and the padding is 0; the
// decoder's pixels have at most 12), each line `pitch` int16 (8 mod 64:
// the transposing copy of a band is free of bank conflicts), staged with
// 8 loads a thread in flight together. Per class with a
// selected cell, over the class's list only (a warp's lanes all filter,
// each with the class's filter width: no lane idles on an unselected
// cell): step A, each thread reads the windows of its items (a listed
// cell on one of its map row's lines; four 16-byte reads a window) from
// the current lines and writes the pixels each wins into the next lines
// (a cell yields a pixel to a selected cell of the class one or two cells
// to its left whose extent covers it: the plain version's last-k-wins
// order); a block barrier; step B, each thread copies the pixels its
// items won from the next lines to the current ones (each pixel has one
// winner, so no thread reads another's next-line words, and no current
// word is read in step B); a block barrier. Nothing is copied for the
// cells that were not selected, and registers hold one window at a time.
//
// Bound on this card: bytes. The pass reads and writes each plane's pixels
// that a window can reach once (about 25 MB each way for a 1080p 4:2:0
// frame in int32 words, 7.5 us a direction at 3.35 TB/s); the filter's
// arithmetic, tens of int32 operations per filtered line, stays below
// that.
//
// Design of rav1d_lf_pass (the earlier form): one thread block per line of
// each plane, 128 threads. The block stages its padded line in shared
// memory (cur) and its cells' class|level bytes (read straight from the
// frame blob's byte maps); per class with a selected cell, it copies cur
// to nxt, each thread filters its cells from cur in registers and writes
// the pixels it wins into nxt, and the buffers swap at a block barrier;
// then the line goes back to the plane. The horizontal pass reads a column
// per block (4 bytes of each 32-byte sector). Dynamic shared memory: 2 *
// (line + 24) + nw4 + 4 words (17.5 KB for a 1920-pixel row).
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_deblock_host and rav1d_lf_pass_host walk the same blocks
// with the same step functions, thread by thread, each barrier a loop
// boundary (a thread's registers kept per thread across it), for the CPU
// tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LF_HD __host__ __device__ __forceinline__
#define LF_UNROLL _Pragma("unroll")
#else
#define LF_HD static inline
#define LF_UNROLL
#endif

enum { LF_THREADS = 128, LF_PAD_L = 8, LF_PAD = 24 };

// The launch's arguments (ops/cuda/filters.py LfPass, field for field).
struct LfPass {
    int* planes;        // (3, ah, aw) int32, filtered in place
    const int* blob;    // the frame blob
    int ah, aw;         // the planes' rows and columns
    int hor;            // 0: vertical edges (lines are rows); 1: horizontal
    int bpc;
    int eih;            // word offset of the (2, 64) E and I luts
    int nplanes;        // planes with a pass: 1 (4:0:0) or 3
    int map[3];         // word offset of each plane's byte map (class << 6 | level)
    int nh4[3], nw4[3]; // each map's cells (rows of 4 lines, cells per line)
    int first[4];       // first block of each plane (4 * nh4 lines each)
    int maxnw;          // the largest nw4
};

// a read of the blob (read-only for the launch)
LF_HD int LF_LD(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

LF_HD int lf_len(const LfPass& p) { return p.hor ? p.ah : p.aw; }

LF_HD int lf_smem_words(const LfPass& p) { return 2 * (lf_len(p) + LF_PAD) + p.maxnw + 4; }

LF_HD int lf_abs(int v) { return v < 0 ? -v : v; }

LF_HD int lf_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// One block's line: where it is and its shared buffers.
struct LfLine {
    int p, l, cy, nw, len, valid;  // plane, line, map row, cells, line length, line inside the plane
    int* cur;                      // the padded line (pad column i = line position i - 8)
    int* nxt;                      // the class's output
    int* mp;                       // the cells' class << 6 | level
    int* any;                      // any[c]: a cell of class c is selected
};

LF_HD LfLine lf_line(const LfPass& p, int blk, int* sm) {
    LfLine b;
    int pl = 0;
    while (pl + 1 < p.nplanes && blk >= p.first[pl + 1]) pl++;
    b.p = pl;
    b.l = blk - p.first[pl];
    b.cy = b.l >> 2;
    b.nw = p.nw4[pl];
    b.len = lf_len(p);
    b.valid = b.l < (p.hor ? p.aw : p.ah);
    const int lp = b.len + LF_PAD;
    b.cur = sm;
    b.nxt = sm + lp;
    b.mp = sm + 2 * lp;
    b.any = sm + 2 * lp + p.maxnw;
    return b;
}

LF_HD size_t lf_addr(const LfPass& p, const LfLine& b, int q) {
    const size_t base = (size_t)b.p * p.ah * p.aw;
    return p.hor ? base + (size_t)q * p.aw + b.l : base + (size_t)b.l * p.aw + q;
}

// The filter of one window w[16] (w[8] = q0) at width WD into o[16]
// (o = w on entry). Parity: ops/lf.py filter_lines_batch.
template <int WD>
LF_HD void lf_filter(const int* w, int E, int I, int H, int bpc, int* o) {
    const int bd = bpc - 8, F = 1 << bd, pmax = (1 << bpc) - 1;
    E <<= bd;
    I <<= bd;
    H <<= bd;
    const int p1 = w[6], p0 = w[7], q0 = w[8], q1 = w[9];
    bool fm = lf_abs(p1 - p0) <= I && lf_abs(q1 - q0) <= I &&
              lf_abs(p0 - q0) * 2 + (lf_abs(p1 - q1) >> 1) <= E;
    int p2 = 0, p3 = 0, q2 = 0, q3 = 0;
    if (WD > 4) {
        p2 = w[5];
        q2 = w[10];
        fm = fm && lf_abs(p2 - p1) <= I && lf_abs(q2 - q1) <= I;
        if (WD > 6) {
            p3 = w[4];
            q3 = w[11];
            fm = fm && lf_abs(p3 - p2) <= I && lf_abs(q3 - q2) <= I;
        }
    }
    bool flat8in = false;
    if (WD >= 6)
        flat8in = lf_abs(p2 - p0) <= F && lf_abs(p1 - p0) <= F && lf_abs(q1 - q0) <= F &&
                  lf_abs(q2 - q0) <= F;
    if (WD >= 8) flat8in = flat8in && lf_abs(p3 - p0) <= F && lf_abs(q3 - q0) <= F;
    bool narrow = fm;
    if (WD >= 16) {
        const int p6 = w[1], p5 = w[2], p4 = w[3], q4 = w[12], q5 = w[13], q6 = w[14];
        const bool flat8out = lf_abs(p6 - p0) <= F && lf_abs(p5 - p0) <= F &&
                              lf_abs(p4 - p0) <= F && lf_abs(q4 - q0) <= F &&
                              lf_abs(q5 - q0) <= F && lf_abs(q6 - q0) <= F;
        if (fm && flat8out && flat8in) {
            o[2] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4;
            o[3] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4;
            o[4] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4;
            o[5] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4;
            o[6] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 +
                    8) >> 4;
            o[7] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 +
                    8) >> 4;
            o[8] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 +
                    8) >> 4;
            o[9] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 +
                    8) >> 4;
            o[10] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4;
            o[11] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4;
            o[12] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4;
            o[13] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4;
        }
        narrow = fm && !(flat8out && flat8in);
    }
    if (WD >= 8) {
        if (narrow && flat8in) {
            o[5] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
            o[6] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
            o[7] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
            o[8] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
            o[9] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
            o[10] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
        }
        narrow = narrow && !flat8in;
    } else if (WD == 6) {
        if (narrow && flat8in) {
            o[6] = (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3;
            o[7] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            o[8] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
            o[9] = (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3;
        }
        narrow = narrow && !flat8in;
    }
    if (!narrow) return;
    const bool hev = lf_abs(p1 - p0) > H || lf_abs(q1 - q0) > H;
    const int lo = -128 << bd, hi = (128 << bd) - 1;
    const int fv_h = lf_clamp(3 * (q0 - p0) + lf_clamp(p1 - q1, lo, hi), lo, hi);
    const int fv_n = lf_clamp(3 * (q0 - p0), lo, hi);
    const int fv = hev ? fv_h : fv_n;
    const int f1 = (fv + 4 < hi ? fv + 4 : hi) >> 3;
    const int f2 = (fv + 3 < hi ? fv + 3 : hi) >> 3;
    const int fv2 = (f1 + 1) >> 1;
    o[6] = hev ? p1 : lf_clamp(p1 + fv2, 0, pmax);
    o[7] = lf_clamp(p0 + f2, 0, pmax);
    o[8] = lf_clamp(q0 - f1, 0, pmax);
    o[9] = hev ? q1 : lf_clamp(q1 - fv2, 0, pmax);
}

LF_HD int lf_wd(int luma, int cls) { return luma ? (4 << (cls - 1)) : (4 + 2 * (cls - 1)); }

// WRITE_EXTENT (ops/ref/lf.py): the window columns [lo, hi) a width writes
LF_HD int lf_lo(int wd) { return wd == 16 ? 2 : (wd == 8 ? 5 : 6); }
LF_HD int lf_hi(int wd) { return wd == 16 ? 14 : (wd == 8 ? 11 : 10); }

LF_HD bool lf_sel(const LfLine& b, int x, int cls) {
    return x >= 0 && (b.mp[x] >> 6) == cls && (b.mp[x] & 63);
}

// step 0: the class flags cleared
LF_HD void lf_init(const LfLine& b, int t) {
    if (t < 4) b.any[t] = 0;
}

// step 1: the padded line and the cell bytes into shared memory
LF_HD void lf_load(const LfPass& p, const LfLine& b, int t) {
    const int lp = b.len + LF_PAD;
    for (int i = t; i < lp; i += LF_THREADS) {
        const int q = i - LF_PAD_L;
        b.cur[i] = (b.valid && q >= 0 && q < b.len) ? p.planes[lf_addr(p, b, q)] : 0;
    }
    const unsigned char* bytes = (const unsigned char*)(p.blob + p.map[b.p]);
    for (int x = t; x < b.nw; x += LF_THREADS) {
        const int m = bytes[(size_t)b.cy * b.nw + x];
        b.mp[x] = m;
        if ((m & 63) && (m >> 6)) b.any[m >> 6] = 1;
    }
}

// before a class: nxt = cur
LF_HD void lf_copy(const LfLine& b, int t) {
    for (int i = t; i < b.len + LF_PAD; i += LF_THREADS) b.nxt[i] = b.cur[i];
}

template <int WD>
LF_HD void lf_cell(const LfPass& p, const LfLine& b, int x, int cls) {
    const int lvl = b.mp[x] & 63;
    int w[16], o[16];
    for (int k = 0; k < 16; k++) o[k] = w[k] = b.cur[4 * x + k];
    lf_filter<WD>(w, LF_LD(p.blob + p.eih + lvl), LF_LD(p.blob + p.eih + 64 + lvl), lvl >> 4,
                  p.bpc, o);
    const int lo = lf_lo(WD), hi = lf_hi(WD);
    for (int k = lo; k < hi; k++) {
        // the plain version writes k = lo .. hi - 1 in order: a selected
        // cell to the left whose extent covers this pixel writes it later
        if (k + 4 < hi && lf_sel(b, x - 1, cls)) continue;
        if (k + 8 < hi && lf_sel(b, x - 2, cls)) continue;
        b.nxt[4 * x + k] = o[k];
    }
}

// a class: each thread's selected cells, read from cur, written to nxt
LF_HD void lf_class(const LfPass& p, const LfLine& b, int cls, int t) {
    const int wd = lf_wd(b.p == 0, cls);
    for (int x = t; x < b.nw; x += LF_THREADS) {
        if (!lf_sel(b, x, cls)) continue;
        switch (wd) {
            case 4: lf_cell<4>(p, b, x, cls); break;
            case 6: lf_cell<6>(p, b, x, cls); break;
            case 8: lf_cell<8>(p, b, x, cls); break;
            default: lf_cell<16>(p, b, x, cls); break;
        }
    }
}

// the last step: the line's plane pixels back to the plane
LF_HD void lf_store(const LfPass& p, const LfLine& b, int t) {
    if (!b.valid) return;
    for (int q = t; q < b.len; q += LF_THREADS) p.planes[lf_addr(p, b, q)] = b.cur[q + LF_PAD_L];
}

LF_HD int lf_blocks(const LfPass& p) {
    return p.nplanes >= 1 && p.nplanes <= 3 ? p.first[p.nplanes] : -1;
}

// ---------------------------------------------------------------------------
// rav1d_deblock: a group of lines per block
// ---------------------------------------------------------------------------

enum {
    LFG_THREADS = 256,
    LFG_FLAGS = 12,
    LFG_LUT = 128,
    LFG_BATCH = 8,  // loads a thread has in flight while staging
};

// The launch's arguments (ops/cuda/filters.py LfGroups, field for field).
struct LfGroups {
    int* planes;         // (3, ah, aw) int32, filtered in place
    const int* blob;     // the frame blob
    int ah, aw;          // the planes' rows and columns
    int hor;             // 0: vertical edges (lines are rows); 1: horizontal
    int bpc;
    int eih;             // word offset of the (2, 64) E and I luts
    int nplanes;         // planes with a pass: 1 (4:0:0) or 3
    int map[3];          // word offset of each plane's byte map (class << 6 | level)
    int nh4[3], nw4[3];  // each map's cells (rows of 4 lines, cells per line)
    int nlines[3];       // each plane's lines with cells: min(4 nh4, the plane's lines)
    int ext[3];          // line positions a window reaches inside the plane: min(length, 4 nw4 + 4)
    int first[4];        // first block of each plane
    int group;           // lines per block: 1, 2, 4 or 8
    int pitch;           // shared int16 per line: >= 4 maxnw + 12, 8 mod 64
    int maxnw;           // the largest nw4
};

LF_HD int lfg_log2(int g) { return g == 8 ? 3 : (g == 4 ? 2 : (g == 2 ? 1 : 0)); }

// map rows a block spans, at most
LF_HD int lfg_mrows(const LfGroups& p) { return p.group > 4 ? p.group / 4 : 1; }

LF_HD bool lfg_ok(const LfGroups& p) {
    if (p.nplanes < 1 || p.nplanes > 3 || (p.hor != 0 && p.hor != 1)) return false;
    if ((p.group != 1 && p.group != 2 && p.group != 4 && p.group != 8) || p.maxnw < 1 ||
        p.maxnw > 0x7fff || p.pitch % 8 || p.pitch < 4 * p.maxnw + 12)
        return false;
    for (int pl = 0; pl < p.nplanes; pl++)
        if (p.nw4[pl] < 1 || p.nw4[pl] > p.maxnw || p.ext[pl] < 0 ||
            p.ext[pl] > 4 * p.nw4[pl] + 4 || p.nlines[pl] < 0 || p.nlines[pl] > 4 * p.nh4[pl] ||
            p.first[pl + 1] - p.first[pl] != (p.nlines[pl] + p.group - 1) / p.group)
            return false;
    return p.first[0] == 0;
}

// shared words: the current and the next lines (int16), the flags and
// counts, the E/I luts, the map rows' bytes, each class's list of selected
// cells
LF_HD int lfg_smem_words(const LfGroups& p) {
    const int cells = lfg_mrows(p) * p.maxnw;
    return p.group * p.pitch + LFG_FLAGS + LFG_LUT + (cells + 3) / 4 + 3 * ((cells + 1) / 2);
}

// One block's group of lines: where it is and its shared buffers.
struct LfGrp {
    int p, l0, nw, ext, nl;  // plane, first line, cells per line, staged positions, lines with cells
    short* cur;              // the padded lines (pad word i = line position i - 8), pitch words each
    short* nxt;              // a class's filtered pixels, where its cells write them
    int* any;                // [1..3]: a cell of the class is selected; [4 + j]: a cell of map row j;
                             // [9 + c - 1]: class c's selected cells
    int* eih;                // the E and I luts
    unsigned char* mp;       // the group's map rows, nw bytes each
    unsigned short* list;    // class c's selected cells (j << 15 | x) at (c - 1) * mrows * maxnw
};

LF_HD LfGrp lfg_block(const LfGroups& p, int blk, int* sm) {
    LfGrp b;
    int pl = 0;
    while (pl + 1 < p.nplanes && blk >= p.first[pl + 1]) pl++;
    b.p = pl;
    b.l0 = (blk - p.first[pl]) * p.group;
    b.nw = p.nw4[pl];
    b.ext = p.ext[pl];
    b.nl = p.nlines[pl];
    b.cur = (short*)sm;
    b.nxt = b.cur + p.group * p.pitch;
    b.any = sm + p.group * p.pitch;
    b.eih = b.any + LFG_FLAGS;
    const int cells = lfg_mrows(p) * p.maxnw;
    b.mp = (unsigned char*)(b.eih + LFG_LUT);
    b.list = (unsigned short*)(b.eih + LFG_LUT + (cells + 3) / 4);
    return b;
}

// the map row (of the block's) of line li
LF_HD int lfg_row(const LfGrp& b, int li) { return ((b.l0 + li) >> 2) - (b.l0 >> 2); }

// a line of the group that is in the plane, on a map row with a selected cell
LF_HD bool lfg_line_on(const LfGrp& b, int li) {
    return b.l0 + li < b.nl && b.any[4 + lfg_row(b, li)];
}

// cell x of map row j is selected in class cls
LF_HD bool lfg_sel(const LfGrp& b, int j, int x, int cls) {
    if (x < 0) return false;
    const int m = b.mp[j * b.nw + x];
    return (m >> 6) == cls && (m & 63);
}

LF_HD bool lfg_any(const LfGrp& b) { return b.any[1] || b.any[2] || b.any[3]; }

// step 0: the flags and counts cleared
LF_HD void lfg_init(const LfGrp& b, int t) {
    if (t < LFG_FLAGS) b.any[t] = 0;
}

// a class's next list slot
LF_HD int lfg_slot(int* n) {
#ifdef __CUDA_ARCH__
    return atomicAdd(n, 1);
#else
    return (*n)++;
#endif
}

// step 1: the group's map rows and the luts into shared memory, the flags
// set and each class's selected cells listed (in any order: a cell's
// output does not depend on the others' of its class); the pixels are
// read only after it, and only on map rows with a selected cell
LF_HD void lfg_map(const LfGroups& p, const LfGrp& b, int t) {
    for (int i = t; i < LFG_LUT; i += LFG_THREADS) b.eih[i] = LF_LD(p.blob + p.eih + i);
    const unsigned char* bytes = (const unsigned char*)(p.blob + p.map[b.p]);
    const int cap = lfg_mrows(p) * p.maxnw;
    for (int j = 0; j < lfg_mrows(p) && b.l0 + 4 * j < b.nl; j++) {
        const unsigned char* row = bytes + (size_t)((b.l0 >> 2) + j) * b.nw;
        for (int x = t; x < b.nw; x += LFG_THREADS) {
            const int m = row[x], cls = m & 63 ? m >> 6 : 0;
            b.mp[j * b.nw + x] = (unsigned char)m;
            for (int c = 1; c <= 3; c++)  // the same address across the warp
                if (cls == c) {
                    b.list[(c - 1) * cap + lfg_slot(b.any + 8 + c)] = (unsigned short)(j << 15 | x);
                    b.any[c] = 1;
                    b.any[4 + j] = 1;
                }
        }
    }
}

LF_HD size_t lfg_addr(const LfGroups& p, const LfGrp& b, int li, int q) {
    const size_t base = (size_t)b.p * p.ah * p.aw;
    const int l = b.l0 + li;
    return p.hor ? base + (size_t)q * p.aw + l : base + (size_t)l * p.aw + q;
}

// the padded words of a line that a window can read
LF_HD int lfg_span(const LfGrp& b) { return 4 * b.nw + 12; }

// step 2: the on lines into shared memory, zero before and past the
// plane. Item i is pad word i >> log2(group) of line i & (group - 1): a
// warp's lanes cover the group's lines at 32 / group neighbouring
// positions (for a band, a row segment of the band: coalesced; for rows,
// a 32-byte sector of each row), LFG_BATCH plane words a thread in
// flight together (every one read before any is written)
LF_HD void lfg_load(const LfGroups& p, const LfGrp& b, int t) {
    const int gs = lfg_log2(p.group), n = lfg_span(b) << gs;
    for (int i0 = t; i0 < n; i0 += LFG_THREADS * LFG_BATCH) {
        int v[LFG_BATCH], at[LFG_BATCH];
        LF_UNROLL
        for (int u = 0; u < LFG_BATCH; u++) {
            const int i = i0 + u * LFG_THREADS, li = i & (p.group - 1), k = i >> gs;
            const int q = k - LF_PAD_L;
            at[u] = i < n && lfg_line_on(b, li) ? li * p.pitch + k : -1;
            v[u] = at[u] >= 0 && q >= 0 && q < b.ext ? p.planes[lfg_addr(p, b, li, q)] : 0;
        }
        LF_UNROLL
        for (int u = 0; u < LFG_BATCH; u++)
            if (at[u] >= 0) b.cur[at[u]] = (short)v[u];
    }
}

// the last step: the on lines' plane pixels back to the plane, the items
// as the load's
LF_HD void lfg_store(const LfGroups& p, const LfGrp& b, int t) {
    const int gs = lfg_log2(p.group);
    for (int i = t; i < b.ext << gs; i += LFG_THREADS) {
        const int li = i & (p.group - 1), q = i >> gs;
        if (lfg_line_on(b, li)) p.planes[lfg_addr(p, b, li, q)] = b.cur[li * p.pitch + q + LF_PAD_L];
    }
}

// the 16 words of a window, as four 8-byte reads (8-byte aligned: the
// lines' pitch and 4x are multiples of 4 int16)
LF_HD void lfg_window(const short* src, int* w) {
#ifdef __CUDA_ARCH__
    LF_UNROLL
    for (int j = 0; j < 4; j++) {
        const int2 v = reinterpret_cast<const int2*>(src)[j];
        w[4 * j] = (short)v.x;
        w[4 * j + 1] = v.x >> 16;
        w[4 * j + 2] = (short)v.y;
        w[4 * j + 3] = v.y >> 16;
    }
#else
    for (int k = 0; k < 16; k++) w[k] = src[k];
#endif
}

// the lines of one map row in a block
LF_HD int lfg_lpr(const LfGroups& p) { return p.group < 4 ? p.group : 4; }

// a class's work items: each listed cell on each line of its map row
LF_HD int lfg_items(const LfGroups& p, const LfGrp& b, int cls) {
    return b.any[8 + cls] << lfg_log2(lfg_lpr(p));
}

// A class's work item i < lfg_items: cell (j, x) of its list and a line li
// of map row j; false for a line that is off.
LF_HD bool lfg_item(const LfGroups& p, const LfGrp& b, int cls, int i, int* li, int* j, int* x) {
    const int lpr = lfg_lpr(p), ls = lfg_log2(lpr);
    const int e = b.list[(cls - 1) * lfg_mrows(p) * p.maxnw + (i >> ls)];
    *j = e >> 15;
    *x = e & 0x7fff;
    *li = (p.group < 4 ? 0 : 4 * *j) + (i & (lpr - 1));
    return lfg_line_on(b, *li);
}

// the first window position of [lo, hi) that cell x of map row j wins in
// its class: the plain version writes k = lo .. hi - 1 in order, so a
// selected cell one or two to the left, whose extent covers the positions
// below hi - 4 or hi - 8, writes them later
LF_HD int lfg_wins(const LfGrp& b, int j, int x, int cls, int lo, int hi) {
    const int k = lfg_sel(b, j, x - 1, cls) ? hi - 4 : (lfg_sel(b, j, x - 2, cls) ? hi - 8 : lo);
    return k > lo ? k : lo;
}

// a class, step A: each of the thread's items read from the current lines
// and filtered, the pixels it wins written to the next lines
template <int WD>
LF_HD void lfg_filter(const LfGroups& p, const LfGrp& b, int cls, int t) {
    const int lo = lf_lo(WD), hi = lf_hi(WD);
    int li, j, x;
    for (int i = t; i < lfg_items(p, b, cls); i += LFG_THREADS) {
        if (!lfg_item(p, b, cls, i, &li, &j, &x)) continue;
        const int lvl = b.mp[j * b.nw + x] & 63;
        int w[16], o[16];
        lfg_window(b.cur + li * p.pitch + 4 * x, w);
        LF_UNROLL
        for (int k = 0; k < 16; k++) o[k] = w[k];
        lf_filter<WD>(w, b.eih[lvl], b.eih[64 + lvl], lvl >> 4, p.bpc, o);
        short* d = b.nxt + li * p.pitch + 4 * x;
        const int k0 = lfg_wins(b, j, x, cls, lo, hi);
        LF_UNROLL
        for (int k = lo; k < hi; k++)
            if (k >= k0) d[k] = (short)o[k];
    }
}

// a class, step B (after a barrier: no current line word is read any
// more): the pixels each of the thread's items won, next to current
template <int WD>
LF_HD void lfg_merge(const LfGroups& p, const LfGrp& b, int cls, int t) {
    const int lo = lf_lo(WD), hi = lf_hi(WD);
    int li, j, x;
    for (int i = t; i < lfg_items(p, b, cls); i += LFG_THREADS) {
        if (!lfg_item(p, b, cls, i, &li, &j, &x)) continue;
        const int o = li * p.pitch + 4 * x;
        for (int k = lfg_wins(b, j, x, cls, lo, hi); k < hi; k++) b.cur[o + k] = b.nxt[o + k];
    }
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(LF_THREADS) lf_pass_kernel(const __grid_constant__ LfPass p) {
    extern __shared__ int lf_sm[];
    LfLine b = lf_line(p, blockIdx.x, lf_sm);
    const int t = threadIdx.x;
    lf_init(b, t);
    __syncthreads();
    lf_load(p, b, t);
    __syncthreads();
    const bool any = b.any[1] || b.any[2] || b.any[3];
    for (int cls = 1; cls <= 3; cls++) {
        if (!b.any[cls]) continue;  // the same for every thread of the block
        lf_copy(b, t);
        __syncthreads();
        lf_class(p, b, cls, t);
        __syncthreads();
        int* c = b.cur;
        b.cur = b.nxt;
        b.nxt = c;
    }
    if (any) lf_store(p, b, t);
}

// Plain C entry (bound with ctypes): one launch over every line of the
// pass's planes on `stream`. Returns the launch's error code (-1 for
// arguments the kernel does not take).
extern "C" int rav1d_lf_pass(const LfPass* f, void* stream) {
    const int nb = lf_blocks(*f);
    if (nb < 0) return -1;
    if (nb == 0) return 0;
    const int smem = lf_smem_words(*f) * (int)sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(lf_pass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    lf_pass_kernel<<<nb, LF_THREADS, smem, (cudaStream_t)stream>>>(*f);
    return (int)cudaGetLastError();
}

// rav1d_deblock's kernels: one per direction, so that each has its own
// name in a profile
__device__ __forceinline__ void lfg_body(const LfGroups& p) {
    extern __shared__ int lf_sm[];
    const LfGrp b = lfg_block(p, blockIdx.x, lf_sm);
    const int t = threadIdx.x;
    lfg_init(b, t);
    __syncthreads();
    lfg_map(p, b, t);
    __syncthreads();
    if (!lfg_any(b)) return;  // the same for every thread of the block
    lfg_load(p, b, t);
    __syncthreads();
    for (int cls = 1; cls <= 3; cls++) {
        if (!b.any[cls]) continue;
        switch (lf_wd(b.p == 0, cls)) {  // the same for every thread of the block
#define LFG_CLASS(WD)                 \
    case WD:                          \
        lfg_filter<WD>(p, b, cls, t); \
        __syncthreads();              \
        lfg_merge<WD>(p, b, cls, t);  \
        break;
            LFG_CLASS(4)
            LFG_CLASS(6)
            LFG_CLASS(8)
            LFG_CLASS(16)
#undef LFG_CLASS
        }
        __syncthreads();
    }
    lfg_store(p, b, t);
}

__global__ void __launch_bounds__(LFG_THREADS) lf_rows_kernel(const __grid_constant__ LfGroups p) {
    lfg_body(p);
}

__global__ void __launch_bounds__(LFG_THREADS) lf_cols_kernel(const __grid_constant__ LfGroups p) {
    lfg_body(p);
}

// Plain C entry (bound with ctypes): one launch over every group of lines
// of the pass's planes on `stream`. Returns the launch's error code (-1
// for arguments the kernel does not take).
extern "C" int rav1d_deblock(const LfGroups* f, void* stream) {
    if (!lfg_ok(*f)) return -1;
    const int nb = f->first[f->nplanes];
    if (nb == 0) return 0;
    void (*k)(const LfGroups) = f->hor ? lf_cols_kernel : lf_rows_kernel;
    const int smem = lfg_smem_words(*f) * (int)sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    k<<<nb, LFG_THREADS, smem, (cudaStream_t)stream>>>(*f);
    return (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

#include <vector>

// rav1d_lf_pass without the stream: every block in order, each step for
// every thread in turn. The shared words start as a pattern, so a read of
// a word no step wrote shows.
extern "C" int rav1d_lf_pass_host(const LfPass* f) {
    const LfPass& p = *f;
    const int nb = lf_blocks(p);
    if (nb < 0) return -1;
    std::vector<int> sm(lf_smem_words(p));
    for (int blk = 0; blk < nb; blk++) {
        for (int& w : sm) w = 0x5a5a5a5a;
        LfLine b = lf_line(p, blk, sm.data());
        for (int t = 0; t < LF_THREADS; t++) lf_init(b, t);
        for (int t = 0; t < LF_THREADS; t++) lf_load(p, b, t);
        const bool any = b.any[1] || b.any[2] || b.any[3];
        for (int cls = 1; cls <= 3; cls++) {
            if (!b.any[cls]) continue;
            for (int t = 0; t < LF_THREADS; t++) lf_copy(b, t);
            for (int t = 0; t < LF_THREADS; t++) lf_class(p, b, cls, t);
            int* c = b.cur;
            b.cur = b.nxt;
            b.nxt = c;
        }
        if (any)
            for (int t = 0; t < LF_THREADS; t++) lf_store(p, b, t);
    }
    return 0;
}

// rav1d_deblock without the stream: every block in order, each step for
// every thread in turn. The shared words start as a pattern, so a read of
// a word no step wrote shows.
extern "C" int rav1d_deblock_host(const LfGroups* f) {
    if (!lfg_ok(*f)) return -1;
    const LfGroups& p = *f;
    std::vector<int> sm(lfg_smem_words(p));
    for (int blk = 0; blk < p.first[p.nplanes]; blk++) {
        for (int& w : sm) w = 0x5a5a5a5a;
        const LfGrp b = lfg_block(p, blk, sm.data());
        for (int t = 0; t < LFG_THREADS; t++) lfg_init(b, t);
        for (int t = 0; t < LFG_THREADS; t++) lfg_map(p, b, t);
        if (!lfg_any(b)) continue;
        for (int t = 0; t < LFG_THREADS; t++) lfg_load(p, b, t);
        for (int cls = 1; cls <= 3; cls++) {
            if (!b.any[cls]) continue;
            switch (lf_wd(b.p == 0, cls)) {
#define LFG_CLASS(WD)                                                       \
    case WD:                                                                \
        for (int t = 0; t < LFG_THREADS; t++) lfg_filter<WD>(p, b, cls, t); \
        for (int t = 0; t < LFG_THREADS; t++) lfg_merge<WD>(p, b, cls, t);  \
        break;
                LFG_CLASS(4)
                LFG_CLASS(6)
                LFG_CLASS(8)
                LFG_CLASS(16)
#undef LFG_CLASS
            }
        }
        for (int t = 0; t < LFG_THREADS; t++) lfg_store(p, b, t);
    }
    return 0;
}

#endif  // __CUDACC__
