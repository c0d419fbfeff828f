// The superres upscale of a frame, CUDA C++ for sm_90a: every plane of
// both inputs (the post-CDEF planes and the post-deblock snapshot) in one
// launch (rav1d_superres_frame).
//
// Replaces the XLA device kernel the JAX engine runs six times a superres
// frame: rav1d_tpu/engine/filters.py resize_plane_raw (:185), called by
// rav1d_tpu/engine/mega.py filter_prog (:740-770) on each plane of the
// planes and of the post-deblock snapshot. The port's plain version is
// engine/filters.py resize_plane, called by engine/programs.py _superres
// (filter_plain); this kernel computes exactly what they compute.
//
// What the plain version computes, per input i (0: the planes, 1: the
// snapshot) and plane pl, with h, dst_w, src_w, dx and mx0 of the plane
// (the chroma planes share theirs): output (r, x) for r < h and x < dst_w
// is, with pos = mx0 + x * dx and src_x = -1 + (pos >> 14) - (mx0 >> 14),
// acc = sum over k < 8 of RESIZE_FILTER[(pos & 0x3FFF) >> 8][k] *
// src[r][clamp(src_x + k - 3, 0, src_w - 1)], then clamp((-acc + 64) >> 7,
// 0, (1 << bpc) - 1); every other cell of the (s_ah, s_aw) output plane
// (rows >= h, columns >= dst_w, both chroma planes of 4:0:0) is 0. All of
// it is int32 arithmetic that wraps as the frameworks' does (computed in
// uint32 here; C++ signed overflow is undefined); shifts are arithmetic.
//
// Design: one thread block per (8 output rows, 256 output columns, input
// and plane), 256 threads, one column each. A block with pixels to
// compute first stages the source span its columns read in each of its
// rows (at most 2 * 256 + 8 words a row for dx <= 2^15, the wrapper's
// limit; superres has dx < 2^14) into shared memory, each source column
// clamped to the row as the plain version clamps it, with neighbouring
// threads on neighbouring words; then each thread reads its column's 8
// taps once, as one 8-byte load from the int8 filter table in global
// memory (512 bytes, which stay in L1; in constant memory the lanes'
// different phases would serialize), and computes and writes its column's
// output in each row, a row across neighbouring threads. Rows past the
// plane's, columns past dst_w and a 4:0:0 frame's chroma planes are
// written with zeros (a block with nothing to compute stages nothing).
// Every cell of the output is written, so the wrapper allocates it with
// torch.empty.
//
// Bound on this card: bytes. The launch reads each input's visible source
// rows once and writes the (2, 3, s_ah, s_aw) int32 output once: 75 MB for
// a 1080p 4:2:0 frame at denominator 9, 22 us at 3.35 TB/s; the
// arithmetic, about 20 int32 operations per visible output pixel, comes to
// 0.12 G operations, 7 us at the int32 issue rate.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_superres_frame_host walks the same blocks with the same step
// functions, thread by thread, the barrier a loop boundary, for the CPU
// tests; rav1d_superres_table_host returns the filter table.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SR_HD __host__ __device__ __forceinline__
#define SR_TABLE_MEM __device__ const __align__(8)
#else
#define SR_HD static inline
#define SR_TABLE_MEM static const
#endif

enum {
    SR_THREADS = 256,
    SR_T = 256,                 // output columns per block
    SR_ROWS = 8,                // output rows per block
    SR_SPAN = 2 * SR_T + 16,    // source words a block stages, at most
    SR_TABLE = 64 * 8,          // the filter table: 64 phases x 8 taps
    SR_MAX_DX = 1 << 15,        // the step the span is sized for
};

// RESIZE_FILTER (tables/spec_data.py, engine/consts.py resize_filter),
// phase by phase (every tap fits int8: -128 .. 20)
SR_TABLE_MEM int8_t SR_FILTER[SR_TABLE] = {
       0,    0,    0, -128,    0,    0,    0,    0,
       0,    0,    1, -128,   -2,    1,    0,    0,
       0,   -1,    3, -127,   -4,    2,   -1,    0,
       0,   -1,    4, -127,   -6,    3,   -1,    0,
       0,   -2,    6, -126,   -8,    3,   -1,    0,
       0,   -2,    7, -125,  -11,    4,   -1,    0,
       1,   -2,    8, -125,  -13,    5,   -2,    0,
       1,   -3,    9, -124,  -15,    6,   -2,    0,
       1,   -3,   10, -123,  -18,    6,   -2,    1,
       1,   -3,   11, -122,  -20,    7,   -3,    1,
       1,   -4,   12, -121,  -22,    8,   -3,    1,
       1,   -4,   13, -120,  -25,    9,   -3,    1,
       1,   -4,   14, -118,  -28,    9,   -3,    1,
       1,   -4,   15, -117,  -30,   10,   -4,    1,
       1,   -5,   16, -116,  -32,   11,   -4,    1,
       1,   -5,   16, -114,  -35,   12,   -4,    1,
       1,   -5,   17, -112,  -38,   12,   -4,    1,
       1,   -5,   18, -111,  -40,   13,   -5,    1,
       1,   -5,   18, -109,  -43,   14,   -5,    1,
       1,   -6,   19, -107,  -45,   14,   -5,    1,
       1,   -6,   19, -105,  -48,   15,   -5,    1,
       1,   -6,   19, -103,  -51,   16,   -5,    1,
       1,   -6,   20, -101,  -53,   16,   -6,    1,
       1,   -6,   20,  -99,  -56,   17,   -6,    1,
       1,   -6,   20,  -97,  -58,   17,   -6,    1,
       1,   -6,   20,  -95,  -61,   18,   -6,    1,
       2,   -7,   20,  -93,  -64,   18,   -6,    2,
       2,   -7,   20,  -91,  -66,   19,   -6,    1,
       2,   -7,   20,  -88,  -69,   19,   -6,    1,
       2,   -7,   20,  -86,  -71,   19,   -6,    1,
       2,   -7,   20,  -84,  -74,   20,   -7,    2,
       2,   -7,   20,  -81,  -76,   20,   -7,    1,
       2,   -7,   20,  -79,  -79,   20,   -7,    2,
       1,   -7,   20,  -76,  -81,   20,   -7,    2,
       2,   -7,   20,  -74,  -84,   20,   -7,    2,
       1,   -6,   19,  -71,  -86,   20,   -7,    2,
       1,   -6,   19,  -69,  -88,   20,   -7,    2,
       1,   -6,   19,  -66,  -91,   20,   -7,    2,
       2,   -6,   18,  -64,  -93,   20,   -7,    2,
       1,   -6,   18,  -61,  -95,   20,   -6,    1,
       1,   -6,   17,  -58,  -97,   20,   -6,    1,
       1,   -6,   17,  -56,  -99,   20,   -6,    1,
       1,   -6,   16,  -53, -101,   20,   -6,    1,
       1,   -5,   16,  -51, -103,   19,   -6,    1,
       1,   -5,   15,  -48, -105,   19,   -6,    1,
       1,   -5,   14,  -45, -107,   19,   -6,    1,
       1,   -5,   14,  -43, -109,   18,   -5,    1,
       1,   -5,   13,  -40, -111,   18,   -5,    1,
       1,   -4,   12,  -38, -112,   17,   -5,    1,
       1,   -4,   12,  -35, -114,   16,   -5,    1,
       1,   -4,   11,  -32, -116,   16,   -5,    1,
       1,   -4,   10,  -30, -117,   15,   -4,    1,
       1,   -3,    9,  -28, -118,   14,   -4,    1,
       1,   -3,    9,  -25, -120,   13,   -4,    1,
       1,   -3,    8,  -22, -121,   12,   -4,    1,
       1,   -3,    7,  -20, -122,   11,   -3,    1,
       1,   -2,    6,  -18, -123,   10,   -3,    1,
       0,   -2,    6,  -15, -124,    9,   -3,    1,
       0,   -2,    5,  -13, -125,    8,   -2,    1,
       0,   -1,    4,  -11, -125,    7,   -2,    0,
       0,   -1,    3,   -8, -126,    6,   -2,    0,
       0,   -1,    3,   -6, -127,    4,   -1,    0,
       0,   -1,    2,   -4, -127,    3,   -1,    0,
       0,    0,    1,   -2, -128,    1,    0,    0
};

// The launch's arguments (ops/cuda/filters.py SrFrame, field for field).
struct SrFrame {
    int* out;            // (2, 3, s_ah, s_aw) int32: the planes', then the snapshot's
    const int* planes;   // the post-CDEF planes, (3, ah, aw) int32
    const int* pre;      // the post-deblock snapshot, (3, ah, aw) int32
    int ah, aw;
    int s_ah, s_aw;
    int bpc;
    int nplanes;         // planes with pixels: 1 (4:0:0) or 3
    int h[3];            // output rows of each plane
    int dst_w[3];        // output columns
    int src_w[3];        // source columns (the clamp's limit)
    int dx[3];           // step, 1/2^14 source columns per output column
    int mx0[3];          // start position (14 fractional bits)
};

// wrapping int32 arithmetic
SR_HD int sr_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
SR_HD int sr_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }
SR_HD int sr_mul(int a, int b) { return (int)((unsigned)a * (unsigned)b); }

SR_HD int sr_clamp(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

SR_HD int sr_ld(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// the 8 taps of a phase (nvcc's host pass, which no launch reaches, reads
// no device table)
SR_HD void sr_taps(int ph, int* f) {
#if defined(__CUDA_ARCH__)
    const int2 w = __ldg((const int2*)(SR_FILTER + ph * 8));
    for (int k = 0; k < 4; k++) {
        f[k] = (int)(int8_t)(w.x >> (8 * k));
        f[k + 4] = (int)(int8_t)(w.y >> (8 * k));
    }
#elif !defined(__CUDACC__)
    for (int k = 0; k < 8; k++) f[k] = SR_FILTER[ph * 8 + k];
#else
    for (int k = 0; k < 8; k++) f[k] = ph * 0;
#endif
}

// arguments the kernel takes: 0, else -1
SR_HD int sr_check(const SrFrame& p) {
    if (p.bpc < 8 || p.bpc > 12 || (p.nplanes != 1 && p.nplanes != 3)) return -1;
    if (p.ah < 0 || p.aw < 1 || p.s_ah < 0 || p.s_ah > 65535 || p.s_aw < 1) return -1;
    for (int pl = 0; pl < p.nplanes; pl++) {
        if (p.h[pl] < 0 || p.h[pl] > p.ah || p.h[pl] > p.s_ah) return -1;
        if (p.dst_w[pl] < 0 || p.dst_w[pl] > p.s_aw) return -1;
        if (p.src_w[pl] < 1 || p.src_w[pl] > p.aw) return -1;
        if (p.dx[pl] < 1 || p.dx[pl] > SR_MAX_DX || p.mx0[pl] < 0 || p.mx0[pl] >= (1 << 14)) return -1;
        if ((long long)p.dst_w[pl] * p.dx[pl] >= (1LL << 30)) return -1;
    }
    return 0;
}

SR_HD int sr_col_blocks(const SrFrame& p) { return (p.s_aw + SR_T - 1) / SR_T; }

SR_HD int sr_row_blocks(const SrFrame& p) { return (p.s_ah + SR_ROWS - 1) / SR_ROWS; }

// One block: its input, plane, first row and column, and its spans.
struct SrBlock {
    int in, pl, r0, x0;
    int nrow;            // output rows of the block (the last block's are fewer)
    int rows;            // of them, rows with pixels: 0 for a block of zeros
    int n;               // columns with pixels
    int lo;              // the first source column of the spans (unclamped)
    int len;             // a span's length
    const int* src;      // the source row r0
    int* out;            // the output row r0
    int* span;           // shared: SR_ROWS spans of SR_SPAN words
};

SR_HD int sr_pos(const SrFrame& p, int pl, int x) { return sr_add(p.mx0[pl], sr_mul(x, p.dx[pl])); }

SR_HD int sr_src_x(const SrFrame& p, int pl, int pos) { return -1 + (pos >> 14) - (p.mx0[pl] >> 14); }

SR_HD SrBlock sr_block(const SrFrame& p, int bx, int by, int z, int* sm) {
    SrBlock b;
    b.in = z / 3;
    b.pl = z % 3;
    b.r0 = by * SR_ROWS;
    b.x0 = bx * SR_T;
    b.nrow = p.s_ah - b.r0 < SR_ROWS ? p.s_ah - b.r0 : SR_ROWS;
    b.out = p.out + (((size_t)z * p.s_ah) + b.r0) * p.s_aw;
    b.span = sm;
    b.rows = b.n = b.lo = b.len = 0;
    b.src = 0;
    if (b.pl < p.nplanes && b.r0 < p.h[b.pl] && b.x0 < p.dst_w[b.pl]) {
        const int pl = b.pl;
        b.rows = p.h[pl] - b.r0 < SR_ROWS ? p.h[pl] - b.r0 : SR_ROWS;
        b.n = p.dst_w[pl] - b.x0 < SR_T ? p.dst_w[pl] - b.x0 : SR_T;
        b.lo = sr_src_x(p, pl, sr_pos(p, pl, b.x0)) - 3;
        b.len = sr_src_x(p, pl, sr_pos(p, pl, b.x0 + b.n - 1)) + 4 - b.lo + 1;
        b.src = (b.in ? p.pre : p.planes) + ((size_t)pl * p.ah + b.r0) * p.aw;
    }
    return b;
}

// step 1: the spans of the rows with pixels
SR_HD void sr_load(const SrFrame& p, const SrBlock& b, int t) {
    const int last = p.src_w[b.pl] - 1;
    for (int r = 0; r < b.rows; r++)
        for (int j = t; j < b.len; j += SR_THREADS)
            b.span[r * SR_SPAN + j] = sr_ld(b.src + (size_t)r * p.aw + sr_clamp(b.lo + j, 0, last));
}

// step 2: thread t's column in each row of the block, or its zeros
SR_HD void sr_out(const SrFrame& p, const SrBlock& b, int t) {
    const int x = b.x0 + t;
    if (t >= SR_T || x >= p.s_aw) return;
    int r = 0;
    if (t < b.n) {
        const int pos = sr_pos(p, b.pl, x);
        int f[8];
        sr_taps((pos & 0x3FFF) >> 8, f);
        const int off = sr_src_x(p, b.pl, pos) - 3 - b.lo;
        const int pxmax = (1 << p.bpc) - 1;
        for (; r < b.rows; r++) {
            const int* s = b.span + r * SR_SPAN + off;
            int acc = 0;
            for (int k = 0; k < 8; k++) acc = sr_add(acc, sr_mul(f[k], s[k]));
            b.out[(size_t)r * p.s_aw + x] = sr_clamp(sr_add(sr_sub(0, acc), 64) >> 7, 0, pxmax);
        }
    }
    for (; r < b.nrow; r++) b.out[(size_t)r * p.s_aw + x] = 0;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(SR_THREADS) superres_kernel(const __grid_constant__ SrFrame p) {
    __shared__ int sm[SR_ROWS * SR_SPAN];
    const SrBlock b = sr_block(p, blockIdx.x, blockIdx.y, blockIdx.z, sm);
    if (b.rows) {  // the same for every thread of the block
        sr_load(p, b, threadIdx.x);
        __syncthreads();
    }
    sr_out(p, b, threadIdx.x);
}

// Plain C entry (bound with ctypes): one launch over every plane of both
// inputs on `stream`. Returns the launch's error code (-1 for arguments
// the kernel does not take).
extern "C" int rav1d_superres_frame(const SrFrame* f, void* stream) {
    if (sr_check(*f)) return -1;
    if (f->s_ah == 0) return 0;
    void* args[] = {(void*)f};
    const cudaError_t e = cudaLaunchKernel((const void*)superres_kernel,
                                           dim3(sr_col_blocks(*f), sr_row_blocks(*f), 6),
                                           dim3(SR_THREADS), args, 0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

#include <vector>

// rav1d_superres_frame without the stream: every block in order, each
// step for every thread in turn (shared memory filled with a pattern
// before each block, so that a read of a word no thread staged shows).
extern "C" int rav1d_superres_frame_host(const SrFrame* f) {
    if (sr_check(*f)) return -1;
    std::vector<int> sm(SR_ROWS * SR_SPAN);
    for (int z = 0; z < 6; z++)
        for (int by = 0; by < sr_row_blocks(*f); by++)
            for (int bx = 0; bx < sr_col_blocks(*f); bx++) {
                for (int& w : sm) w = 0x5a5a5a5a;
                const SrBlock b = sr_block(*f, bx, by, z, sm.data());
                if (b.rows)
                    for (int t = 0; t < SR_THREADS; t++) sr_load(*f, b, t);
                for (int t = 0; t < SR_THREADS; t++) sr_out(*f, b, t);
            }
    return 0;
}

// the filter table, for the tests (512 ints)
extern "C" int rav1d_superres_table_host(int* out) {
    for (int i = 0; i < SR_TABLE; i++) out[i] = SR_FILTER[i];
    return SR_TABLE;
}

#endif  // __CUDACC__
