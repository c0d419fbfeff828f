// Film grain of a picture, CUDA C++ for sm_90a: every plane in one launch
// (rav1d_fg_frame).
//
// Replaces the device half of rav1d_tpu's film grain,
// rav1d_tpu/ops/tpu/fg.py fg_blend_batch (:19, an XLA function: the
// scaling lookup, the noise (scaling * grain + round) >> shift and the
// clip), and takes on the 2-px overlap blend that the JAX package left on
// the host, which is per pixel too. The port's plain version is
// ops/fg.py grain_frame_plain; this kernel computes exactly what it
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
// Design: a thread block per (256 columns, block row, plane), 256
// threads, a thread a column, walking the block row's 32 (16) rows: the
// block's grain offsets are the same for all of a column's rows, so each
// thread finds its four table bases once. A block with visible pixels to
// grain first stages its plane's grain table (74 x 82 int16, 12,136
// bytes), the scaling table it reads (1 << bpc bytes) and its stretch of
// the random-value table (the block row and the one above, its block
// columns and the one left of them) in shared memory: 16.4 KB of static
// shared memory, so that the table gathers, which scatter with the
// random offsets, never leave the SM. Pixels are read and written as
// neighbouring bytes (halfwords above 8 bits) across a warp; chroma's
// luma average reads the grain-free luma plane from global memory.
//
// Bound on this card: bytes at 10 and 12 bits, the arithmetic at 8. The
// launch must read every padded plane once and write it once (7.1 MB for
// a 1080p 8-bit 4:2:0 picture, 2.1 us at 3.35 TB/s; 51 MB at 2160p
// 10-bit, 15 us), plus the tables (about 50 KB); the arithmetic, about
// 10 int32 operations a luma pixel, 20 a chroma pixel and 10 more in an
// overlap, is 45 M operations at 1080p 4:2:0, 2.7 us at the int32 rate.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_fg_frame_host walks the same blocks with the same step
// functions, thread by thread, the barrier a loop boundary, for the CPU
// tests.

#include <stddef.h>
#include <stdint.h>

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

struct FgShared {
    int16_t lut[FG_GH * FG_GW];
    uint8_t scaling[4096];
    uint8_t rnd[2][FG_RC];   // block rows r - 1 and r, block columns c0 - 1 ..
};

FG_HD int fg_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

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

// arguments the kernel takes: 0, else -1
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

__global__ void __launch_bounds__(FG_THREADS) fg_frame_kernel(const __grid_constant__ FgFrame p) {
    __shared__ FgShared sm;
    const FgBlock b = fg_block(p, blockIdx.x, blockIdx.y, blockIdx.z, &sm);
    if (b.active) {  // the same for every thread of the block
        fg_stage(p, b, threadIdx.x);
        __syncthreads();
    }
    fg_out(p, b, threadIdx.x);
}

// Plain C entry (bound with ctypes): one launch over every plane on
// `stream`. Returns the launch's error code (-1 for arguments the kernel
// does not take).
extern "C" int rav1d_fg_frame(const FgFrame* f, void* stream) {
    if (fg_check(*f)) return -1;
    int gx, gy;
    fg_grid(*f, &gx, &gy);
    void* args[] = {(void*)f};
    const cudaError_t e = cudaLaunchKernel((const void*)fg_frame_kernel, dim3(gx, gy, f->nplanes),
                                           dim3(FG_THREADS), args, 0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

#include <string.h>

#include <vector>

// rav1d_fg_frame without the stream: every block in order, each step for
// every thread in turn (shared memory filled with a pattern before each
// block, so that a read of a byte no thread staged shows).
extern "C" int rav1d_fg_frame_host(const FgFrame* f) {
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
