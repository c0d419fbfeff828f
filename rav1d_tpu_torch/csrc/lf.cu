// The deblocking filter of a frame, CUDA C++ for sm_90a: one launch per
// direction (rav1d_lf_pass), every plane of the frame in it.
//
// Replaces the XLA device kernel the JAX engine runs six times a frame
// (three planes, two directions): rav1d_tpu/engine/filters.py
// lf_dir_pass_raw (:34) over rav1d_tpu/ops/tpu/lf.py filter_lines_batch
// (:20), called by rav1d_tpu/engine/mega.py filter_prog (:678). The port's
// plain version is engine/filters.py lf_dir_pass over ops/lf.py
// filter_lines_batch (engine/programs.py filter_plain); this kernel
// computes exactly what it computes.
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
// Design: one thread block per line of each plane (the lines of a plane
// are independent: every window lies on its line), 128 threads. The block
// stages its padded line in shared memory (cur) and its cells' class|level
// bytes (read straight from the frame blob's byte maps); per class with a
// selected cell, it copies cur to nxt, each thread filters its cells from
// cur in registers and writes the pixels it wins into nxt (a cell yields
// a pixel to a selected cell of the class one or two cells to its left
// whose extent covers it: the plain version's last-k-wins order), and the
// buffers swap at a block barrier; then the line goes back to the plane.
// No transposed copy is made: the horizontal pass addresses the plane's
// columns directly. Dynamic shared memory: 2 * (line + 24) + nw4 + 4
// words (17.5 KB for a 1920-pixel row).
//
// Bound on this card: bytes. The pass reads and writes each plane once
// (12.5 MB each way for a 1080p 4:2:0 frame in int32 words, 7.5 us at
// 3.35 TB/s a direction); the filter's arithmetic, tens of int32
// operations per filtered line, stays below that. The horizontal pass
// reads a column per block (4 bytes of each 32-byte sector; neighbouring
// blocks share the rest through L2).
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_lf_pass_host walks the same blocks with the same step
// functions, thread by thread, each barrier a loop boundary, for the CPU
// tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LF_HD __host__ __device__ __forceinline__
#else
#define LF_HD static inline
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

#endif  // __CUDACC__
