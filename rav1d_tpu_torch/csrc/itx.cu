// Batched 2-D AV1 inverse transforms, CUDA C++ for sm_90a: the nine small
// tx classes (4x4 ... 16x16, rav1d_itx) and the 8x8 DCT_DCT batch
// (rav1d_idct8x8, at the end of the file).
//
// Replaces the TPU kernel rav1d_tpu/ops/pallas/itx_all.py itx_pallas_core:
// the same function, bit-exact with rav1d_tpu/ops/ref/itx.py (the 1-D
// butterflies in itx_1d.cuh are generated from that file). Per block: scale
// 2:1 rectangles by 181/256, run the row pass (dct / adst / flipadst /
// identity by the block's first code) clipped to the row bounds, round by
// the class shift and clip to the column bounds, run the column pass by
// the second code, output (v + 8) >> 4.
//
// Bound: close to balanced. Each coefficient is read once (4 B) plus the
// block's two codes, and each residual written once (4 B): about 8 B of
// traffic per coefficient against 14 (4x4 identity) to 53 (16x16 adst)
// 32-bit integer operations (ops/cuda/gen_itx_1d.py op_count), 2 to 7 per
// byte, while the H100 issues about 5 int32 operations in the time it moves
// one byte (132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7 T/s, NVIDIA's Hopper
// whitepaper, against 3.35 TB/s). Which limit binds depends on the mix of
// classes and 1-D types; chip_smoke.py computes it for the main path's.
//
// Design: one thread per transform block, the w*h coefficients in local
// memory, one template instance per (w, h); the thread branches on the
// block's 1-D codes instead of computing all four variants and selecting
// (the TPU kernel's trick to keep XLA's compile keys fixed). What this
// simple design leaves on the table: a thread reads its block as w*h
// consecutive words, so a warp's loads are strided by w*h words and not
// coalesced; the 16x16 class keeps 256 ints per thread in local memory;
// warps diverge where neighbouring blocks have different tx types. A
// shared-memory tile per warp (coalesced loads, a transposed layout) or one
// warp per block would fix all three.
//
// Integer semantics: every add, subtract, multiply and negate wraps as
// int32 (the frameworks' int32 arithmetic wraps; C++ signed overflow is
// undefined), computed in uint32_t. `>>` on negative values is arithmetic.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RAV1D_HD __host__ __device__ __forceinline__
#else
#define RAV1D_HD static inline
#endif

RAV1D_HD int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
RAV1D_HD int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
RAV1D_HD int wmul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }
RAV1D_HD int wneg(int a) { return (int)(0u - (uint32_t)a); }
RAV1D_HD int clip3(int v, int mn, int mx) {
    return v < mn ? mn : (v > mx ? mx : v);
}

#include "itx_1d.cuh"

// 1-D variant codes (rav1d_tpu engine VARIANTS order); any other code runs
// the dct, as the TPU kernel's select chain does
template <int N>
RAV1D_HD void apply_1d(int code, int* c, int mn, int mx) {
    if constexpr (N == 4) {
        if (code == 1) adst4(c, mn, mx);
        else if (code == 2) flipadst4(c, mn, mx);
        else if (code == 3) identity4(c, mn, mx);
        else dct4(c, mn, mx);
    } else if constexpr (N == 8) {
        if (code == 1) adst8(c, mn, mx);
        else if (code == 2) flipadst8(c, mn, mx);
        else if (code == 3) identity8(c, mn, mx);
        else dct8(c, mn, mx);
    } else {
        if (code == 1) adst16(c, mn, mx);
        else if (code == 2) flipadst16(c, mn, mx);
        else if (code == 3) identity16(c, mn, mx);
        else dct16(c, mn, mx);
    }
}

// final shift per (w, h) (rav1d_tpu/ops/ref/itx.py _SHIFTS)
template <int W, int H>
struct Shift {
    static const int value =
        (W == 4 && H == 16) || (W == 8 && H == 8) || (W == 8 && H == 16) ||
        (W == 16 && H == 4) || (W == 16 && H == 8) ? 1
        : (W == 16 && H == 16) ? 2 : 0;
};

// One block: cb (H, W) natural-order coefficients -> out (H, W) residuals.
template <int W, int H>
RAV1D_HD void itx_block(const int* cb, int first, int second, int* out,
                        int rmn, int rmx, int cmn, int cmx) {
    const int shift = Shift<W, H>::value;
    const int rnd = (1 << shift) >> 1;
    const bool rect2 = W * 2 == H || H * 2 == W;
    int mid[H * W];
    int c[16];
    for (int y = 0; y < H; y++) {
        for (int x = 0; x < W; x++) {
            int v = cb[y * W + x];
            if (rect2) v = wadd(wmul(v, 181), 128) >> 8;
            c[x] = v;
        }
        apply_1d<W>(first, c, rmn, rmx);
        for (int x = 0; x < W; x++)
            mid[y * W + x] = clip3(wadd(c[x], rnd) >> shift, cmn, cmx);
    }
    for (int x = 0; x < W; x++) {
        for (int y = 0; y < H; y++) c[y] = mid[y * W + x];
        apply_1d<H>(second, c, cmn, cmx);
        for (int y = 0; y < H; y++) out[y * W + x] = wadd(c[y], 8) >> 4;
    }
}

// clip bounds of the two passes (itx_all.py _clips)
RAV1D_HD void itx_clips(int bpc, int* b) {
    int rmn, cmn;
    if (bpc == 8) {
        rmn = cmn = -(1 << 15);
    } else {
        const int bmax = (1 << bpc) - 1;
        rmn = (int)((uint32_t)(~bmax) << 7);
        cmn = (int)((uint32_t)(~bmax) << 5);
    }
    b[0] = rmn; b[1] = ~rmn; b[2] = cmn; b[3] = ~cmn;
}

// ---------------------------------------------------------------------------
// 8x8 DCT_DCT batch. Replaces the TPU kernel rav1d_tpu/ops/pallas/itx8.py
// idct8x8_batch_pallas: per block, the row DCT8 clipped to the row bounds,
// (v + 1) >> 1 clipped to the column bounds, the column DCT8, (v + 8) >> 4
// (the itx kernel's 8x8 class with both codes 0). Both 1-D passes are the
// compile-time dct8 of itx_1d.cuh: no per-block codes, no branch on them.
//
// Bound: device-memory bytes, narrowly. 512 B move per block (each
// coefficient read once, each residual written once) against 1,952 integer
// operations (ops/cuda/gen_itx_1d.py op_count), 3.8 per byte, while the
// card issues about 5 int32 operations in the time it moves one byte (see
// the itx kernel's note above).
//
// Design: a thread block of 128 threads takes 16 blocks; it loads their
// 1,024 consecutive words coalesced into shared memory, each thread then
// runs one row (row pass) and one column (column pass) of one block in
// place, and the block stores coalesced. Rows are padded to 9 words, so the
// 32 threads of a warp hit 32 different banks in both passes.

// the row pass of one row (8 values at stride s, in place)
RAV1D_HD void idct8x8_row(int* v, int s, int rmn, int rmx, int cmn, int cmx) {
    int c[8];
    for (int i = 0; i < 8; i++) c[i] = v[i * s];
    dct8(c, rmn, rmx);
    for (int i = 0; i < 8; i++) v[i * s] = clip3(wadd(c[i], 1) >> 1, cmn, cmx);
}

// the column pass of one column (8 values at stride s, in place)
RAV1D_HD void idct8x8_col(int* v, int s, int cmn, int cmx) {
    int c[8];
    for (int i = 0; i < 8; i++) c[i] = v[i * s];
    dct8(c, cmn, cmx);
    for (int i = 0; i < 8; i++) v[i * s] = wadd(c[i], 8) >> 4;
}

#ifdef __CUDACC__

template <int W, int H>
__global__ void itx_kernel(const int* __restrict__ cb,
                           const int* __restrict__ first,
                           const int* __restrict__ second,
                           int* __restrict__ out, int n,
                           int rmn, int rmx, int cmn, int cmx) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t off = (size_t)i * (W * H);
    itx_block<W, H>(cb + off, first[i], second[i], out + off,
                    rmn, rmx, cmn, cmx);
}

template <int W, int H>
static void launch(const int* cb, const int* f, const int* s, int* out,
                   int n, const int* b, cudaStream_t st) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    itx_kernel<W, H><<<blocks, threads, 0, st>>>(cb, f, s, out, n,
                                                  b[0], b[1], b[2], b[3]);
}

// Plain C entry (bound with ctypes). cb/out: (n, h, w) int32 contiguous,
// first/second: (n,) int32. Launches on `stream` and returns the launch's
// cudaGetLastError() (-1 for a class the kernel does not cover).
extern "C" int rav1d_itx(const void* cb, const void* first,
                         const void* second, void* out, int n, int w,
                         int h, int bpc, void* stream) {
    if (n <= 0) return 0;
    int b[4];
    itx_clips(bpc, b);
    const int* c = (const int*)cb;
    const int* f = (const int*)first;
    const int* s = (const int*)second;
    int* o = (int*)out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (w * 100 + h) {
        case 404: launch<4, 4>(c, f, s, o, n, b, st); break;
        case 408: launch<4, 8>(c, f, s, o, n, b, st); break;
        case 416: launch<4, 16>(c, f, s, o, n, b, st); break;
        case 804: launch<8, 4>(c, f, s, o, n, b, st); break;
        case 808: launch<8, 8>(c, f, s, o, n, b, st); break;
        case 816: launch<8, 16>(c, f, s, o, n, b, st); break;
        case 1604: launch<16, 4>(c, f, s, o, n, b, st); break;
        case 1608: launch<16, 8>(c, f, s, o, n, b, st); break;
        case 1616: launch<16, 16>(c, f, s, o, n, b, st); break;
        default: return -1;
    }
    return (int)cudaGetLastError();
}

#define I8_BLOCKS 16               // 8x8 blocks per thread block
#define I8_PITCH 9                 // shared-memory row pitch, in words
#define I8_TILE (8 * I8_PITCH)     // one block's words in shared memory

__global__ void __launch_bounds__(128)
idct8x8_kernel(const int* __restrict__ cb, int* __restrict__ out, int n,
               int rmn, int rmx, int cmn, int cmx) {
    __shared__ int tile[I8_BLOCKS * I8_TILE];
    const int t = threadIdx.x;
    const size_t base = (size_t)blockIdx.x * (I8_BLOCKS * 64);
    const int nb = min(I8_BLOCKS, n - (int)blockIdx.x * I8_BLOCKS);
    for (int k = t; k < nb * 64; k += blockDim.x)
        tile[(k >> 6) * I8_TILE + ((k >> 3) & 7) * I8_PITCH + (k & 7)] =
            cb[base + k];
    __syncthreads();
    const int b = t >> 3, r = t & 7;
    if (b < nb)
        idct8x8_row(&tile[b * I8_TILE + r * I8_PITCH], 1, rmn, rmx, cmn, cmx);
    __syncthreads();
    if (b < nb) idct8x8_col(&tile[b * I8_TILE + r], I8_PITCH, cmn, cmx);
    __syncthreads();
    for (int k = t; k < nb * 64; k += blockDim.x)
        out[base + k] =
            tile[(k >> 6) * I8_TILE + ((k >> 3) & 7) * I8_PITCH + (k & 7)];
}

// Plain C entry (bound with ctypes). cb/out: (n, 8, 8) int32 contiguous.
// Launches on `stream` and returns the launch's cudaGetLastError().
extern "C" int rav1d_idct8x8(const void* cb, void* out, int n, int bpc,
                             void* stream) {
    if (n <= 0) return 0;
    int b[4];
    itx_clips(bpc, b);
    const int grid = (n + I8_BLOCKS - 1) / I8_BLOCKS;
    idct8x8_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const int*)cb, (int*)out, n, b[0], b[1], b[2], b[3]);
    return (int)cudaGetLastError();
}

#else  // a host build of the same block functions, for the CPU tests

template <int W, int H>
static void host_loop(const int* cb, const int* f, const int* s, int* out,
                      int n, const int* b) {
    for (int i = 0; i < n; i++)
        itx_block<W, H>(cb + (size_t)i * W * H, f[i], s[i],
                        out + (size_t)i * W * H, b[0], b[1], b[2], b[3]);
}

extern "C" int rav1d_itx_host(const int* cb, const int* f, const int* s,
                              int* o, int n, int w, int h, int bpc) {
    int b[4];
    itx_clips(bpc, b);
    switch (w * 100 + h) {
        case 404: host_loop<4, 4>(cb, f, s, o, n, b); break;
        case 408: host_loop<4, 8>(cb, f, s, o, n, b); break;
        case 416: host_loop<4, 16>(cb, f, s, o, n, b); break;
        case 804: host_loop<8, 4>(cb, f, s, o, n, b); break;
        case 808: host_loop<8, 8>(cb, f, s, o, n, b); break;
        case 816: host_loop<8, 16>(cb, f, s, o, n, b); break;
        case 1604: host_loop<16, 4>(cb, f, s, o, n, b); break;
        case 1608: host_loop<16, 8>(cb, f, s, o, n, b); break;
        case 1616: host_loop<16, 16>(cb, f, s, o, n, b); break;
        default: return -1;
    }
    return 0;
}

extern "C" int rav1d_idct8x8_host(const int* cb, int* o, int n, int bpc) {
    int b[4];
    itx_clips(bpc, b);
    for (int i = 0; i < n; i++) {
        int v[64];
        for (int k = 0; k < 64; k++) v[k] = cb[(size_t)i * 64 + k];
        for (int r = 0; r < 8; r++)
            idct8x8_row(v + r * 8, 1, b[0], b[1], b[2], b[3]);
        for (int c = 0; c < 8; c++) idct8x8_col(v + c, 8, b[2], b[3]);
        for (int k = 0; k < 64; k++) o[(size_t)i * 64 + k] = v[k];
    }
    return 0;
}

#endif  // __CUDACC__
