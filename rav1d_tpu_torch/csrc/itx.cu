// AV1 inverse transforms, CUDA C++ for sm_90a: every coefficient block of a
// frame in one launch (rav1d_itx_frame), and the 8x8 DCT_DCT batch
// (rav1d_idct8x8, at the end of the file).
//
// rav1d_itx_frame replaces the TPU kernel
// rav1d_tpu/ops/pallas/itx_all.py itx_pallas_core and, beyond it, the
// XLA transforms the JAX engine runs for the other sizes
// (rav1d_tpu/engine/mega.py resid_prog): all 19 (w, h) sizes, 4x4 to
// 64x64, and the lossless 4x4 WHT, bit-exact with the plain torch versions
// rav1d_tpu_torch/engine/kernels.py itx_any_core and wht_core (the 1-D
// butterflies in itx_1d.cuh are generated from rav1d_tpu/ops/ref/itx.py).
// Per block: only the top-left min(h,32) x min(w,32) coefficients exist;
// scale 2:1 rectangles by 181/256, run the row pass (dct / adst / flipadst
// / identity by the block's first code; a code the size does not allow
// runs the dct) clipped to the row bounds, round by the size's shift and
// clip to the column bounds, run the column pass by the second code,
// output (v + 8) >> 4. The WHT shifts its input right by 2 and runs the
// 4-point WHT on rows, then columns, with no clip or rounding.
//
// The launch reads the frame blob as the packer wrote it and writes the
// residual buffer `ra` directly, so the per-class gather and scatter of
// the plain version are fused in. A class table goes by value as the
// kernel parameter (ItxFrame): per class its size, filled lanes, the
// descriptor region (nc chunks of (4, B) words: coefficient offset, flat
// destination index, first code, second code; the WHT's (2, B): offset,
// destination) and its first thread block. Coefficients are int16 pairs
// (8 bpc) or words, each block's run stored column by column as
// (min(w,32), min(h,32)) in the blob. Residual (y, x) of a block goes to
// out[flat0 + y * pitch + x]; an index outside [0, out_len) is dropped, as
// the plain version's trash word drops it. The same kernel serves the
// per-size entry point (ops/cuda/itx.py itx) with a one-class table over a
// contiguous (N, min(h,32), min(w,32)) row-major buffer.
//
// Bound: operations, narrowly. A block moves 2 B per stored coefficient at
// 8 bpc, 16 B of descriptors and 4 B per residual, against 14 (4x4
// identity) to 1,666 (one 64-point dct) 32-bit operations per 1-D
// transform (ops/cuda/gen_itx_1d.py op_count), while the H100 issues about
// 5 int32 operations in the time it moves one byte (132 SMs x 64 INT32
// lanes x 1.98 GHz = 16.7 T/s, NVIDIA's Hopper whitepaper, against 3.35
// TB/s); chip_smoke.py computes both for the main path's frames. In
// practice the launch is bound by latency: one thread's chain of 64-point
// transforms, since a frame holds far too few blocks to fill the card.
//
// Design: one thread per 1-D transform. A 128-thread block takes K blocks
// of one class, K = 128 / max(min(h,32), w) (32 4x4 blocks ... two 64x64
// blocks), in four steps separated by barriers: (1) the K blocks'
// descriptors into shared memory; (2) their coefficient runs, read
// coalesced (consecutive threads, consecutive words of one run) into a
// shared tile of min(h,32) rows of w words per block, rows padded to w+1
// words so the row pass (a warp on consecutive rows) and the column pass (a
// warp on consecutive columns) hit distinct banks; (3) one thread per row:
// the row transform in registers, back into the tile; (4) one thread per
// column: the column transform in registers, then h stores, where a warp
// stores one residual row of w consecutive words per block. Thread blocks
// take the table from its end, so the 64-point classes, the longest, start
// first. The row and column functions are not inlined: each of the five
// transform lengths is compiled once and shared by the sizes that use it,
// which keeps the 64-point code (1,666 straight-line operations) to two
// copies; inlined, each class alone ran faster but a whole frame slower.
// Warps of small classes cover several blocks and diverge where their
// codes differ. Tensor cores do not apply: the butterflies round and clip
// between stages.
//
// Integer semantics: every add, subtract, multiply and negate wraps as
// int32 (the frameworks' int32 arithmetic wraps; C++ signed overflow is
// undefined), computed in uint32_t. `>>` on negative values is arithmetic.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_itx_frame_host walks the same class table with the same step
// functions, thread by thread, for the CPU tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define RAV1D_HD __host__ __device__ __forceinline__
#define RAV1D_PASS __host__ __device__ __noinline__
#define RAV1D_UNROLL _Pragma("unroll")
#else
#define RAV1D_HD static inline
#define RAV1D_PASS static
#define RAV1D_UNROLL
#endif

RAV1D_HD int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
RAV1D_HD int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }
RAV1D_HD int wmul(int a, int b) { return (int)((uint32_t)a * (uint32_t)b); }
RAV1D_HD int wneg(int a) { return (int)(0u - (uint32_t)a); }
RAV1D_HD int clip3(int v, int mn, int mx) {
    return v < mn ? mn : (v > mx ? mx : v);
}

#include "itx_1d.cuh"

// 1-D variant codes (rav1d_tpu engine VARIANTS order); a code the size
// does not allow runs the dct, as the plain version's select chain does
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
    } else if constexpr (N == 16) {
        if (code == 1) adst16(c, mn, mx);
        else if (code == 2) flipadst16(c, mn, mx);
        else if (code == 3) identity16(c, mn, mx);
        else dct16(c, mn, mx);
    } else if constexpr (N == 32) {
        if (code == 3) identity32(c, mn, mx);
        else dct32(c, mn, mx);
    } else {
        (void)code;
        dct64(c, mn, mx);
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
// The frame kernel.

#define ITX_THREADS 128
#define ITX_MAXK 32           // most blocks a thread block takes (4x4)
#define ITX_SMEM 4224         // tile words of the largest class (32x32)
#define ITX_MAX_CLASSES 20    // 19 sizes and the WHT

// the 19 (w, h) sizes (rav1d_tpu/ops/ref/itx.py _SHIFTS)
#define ITX_SIZES(X)                                                        \
    X(4, 4) X(4, 8) X(4, 16) X(8, 4) X(8, 8) X(8, 16) X(8, 32) X(16, 4)     \
    X(16, 8) X(16, 16) X(16, 32) X(16, 64) X(32, 8) X(32, 16) X(32, 32)     \
    X(32, 64) X(64, 16) X(64, 32) X(64, 64)

// final shift per (w, h) (rav1d_tpu/ops/ref/itx.py _SHIFTS)
constexpr int itx_shift(int w, int h) {
    switch (w * 100 + h) {
        case 404: case 408: case 804: return 0;
        case 416: case 808: case 816: case 1604: case 1608: case 1632:
        case 3216: case 3264: case 6432: return 1;
        default: return 2;  // 8x32 16x16 16x64 32x8 32x32 64x16 64x64
    }
}

// tile geometry of one (w, h) class
template <int W, int H>
struct Geo {
    static constexpr int SH = H < 32 ? H : 32;  // stored coefficient rows
    static constexpr int SW = W < 32 ? W : 32;  // stored coefficient columns
    static constexpr int M = SH * SW;           // stored coefficients
    static constexpr int K = ITX_THREADS / (SH > W ? SH : W);  // blocks
    static constexpr int PITCH = W + 1;         // tile row, words
    // one block's tile; where a warp's column pass covers several blocks,
    // a multiple of 32 words would put them on the same banks
    static constexpr int TILE =
        SH * PITCH + (W < 32 && (SH * PITCH) % 32 == 0 ? W : 0);
    static_assert(K * TILE <= ITX_SMEM && K <= ITX_MAXK, "tile too large");
};

// One class of the table.
struct ItxClass {
    int wh;    // w * 100 + h, or 0 for the lossless 4x4 WHT
    int n;     // filled lanes
    int desc;  // word offset of the class's descriptor region in `desc`
    int B;     // lanes per descriptor chunk
    int cta0;  // the class's first thread block
};

// The launch's parameter: the buffers and the class table, by value.
struct ItxFrame {
    const int* desc;  // descriptor regions
    const int* coef;  // coefficient words; reads clamp to [0, coef_len)
    int* out;         // residuals; writes outside [0, out_len) are dropped
    int coef_len;
    int cf_base;      // word of the first coefficient
    int out_len;
    int pitch;        // destination row pitch, words
    int packed;       // 1: int16 pairs; 0: one word per coefficient
    int col_major;    // 1: blocks stored column by column; 0: row by row
    int clip[4];      // row min, row max, column min, column max
    int ncls;
    ItxClass cls[ITX_MAX_CLASSES];
};

// The row pass of one row: v[0..min(N,32)) in, v[0..N) out, in place.
template <int N>
RAV1D_PASS void row_pass(int code, int* v, int rect2, int shift, int rmn,
                         int rmx, int cmn, int cmx) {
    constexpr int NIN = N < 32 ? N : 32;
    int c[N];
    RAV1D_UNROLL
    for (int x = 0; x < N; x++) {
        int u = x < NIN ? v[x] : 0;
        if (rect2) u = wadd(wmul(u, 181), 128) >> 8;
        c[x] = u;
    }
    apply_1d<N>(code, c, rmn, rmx);
    const int rnd = (1 << shift) >> 1;
    RAV1D_UNROLL
    for (int x = 0; x < N; x++) v[x] = clip3(wadd(c[x], rnd) >> shift, cmn, cmx);
}

// The column pass of one column: v[y * stride] for y < min(N,32) in;
// residual y to out[base + y * pitch] unless that index leaves [0, len).
template <int N>
RAV1D_PASS void col_pass(int code, const int* v, int stride, int* out,
                         int base, int pitch, int len, int cmn, int cmx) {
    constexpr int NIN = N < 32 ? N : 32;
    int c[N];
    RAV1D_UNROLL
    for (int y = 0; y < N; y++) c[y] = y < NIN ? v[y * stride] : 0;
    apply_1d<N>(code, c, cmn, cmx);
    RAV1D_UNROLL
    for (int y = 0; y < N; y++) {
        const int idx = wadd(base, wmul(y, pitch));
        if ((uint32_t)idx < (uint32_t)len) out[idx] = wadd(c[y], 8) >> 4;
    }
}

// The WHT's row pass (input >> 2) and column pass (no rounding).
RAV1D_PASS void wht_row(int* v) {
    int c[4];
    RAV1D_UNROLL
    for (int x = 0; x < 4; x++) c[x] = v[x] >> 2;
    wht4(c, 0, 0);
    RAV1D_UNROLL
    for (int x = 0; x < 4; x++) v[x] = c[x];
}

RAV1D_PASS void wht_col(const int* v, int stride, int* out, int base,
                        int pitch, int len) {
    int c[4];
    RAV1D_UNROLL
    for (int y = 0; y < 4; y++) c[y] = v[y * stride];
    wht4(c, 0, 0);
    RAV1D_UNROLL
    for (int y = 0; y < 4; y++) {
        const int idx = wadd(base, wmul(y, pitch));
        if ((uint32_t)idx < (uint32_t)len) out[idx] = c[y];
    }
}

// coefficient word i of the source, clamped into the buffer as the plain
// version's gather clamps
RAV1D_HD int coef_word(const ItxFrame& p, int i) {
    return p.coef[i < 0 ? 0 : (i >= p.coef_len ? p.coef_len - 1 : i)];
}

// Step 2: the coefficient runs of blocks [0, nb) into the tile.
template <int W, int H, bool PACKED, bool COLMAJ>
RAV1D_HD void load_coefs(int t, const ItxFrame& p, int nb, int* tile,
                         const int* offs) {
    using G = Geo<W, H>;
    constexpr int MW = PACKED ? G::M / 2 : G::M;  // words per block
    for (int k = t; k < nb * MW; k += ITX_THREADS) {
        const int b = k / MW, i = k - b * MW;
        int* dst = tile + b * G::TILE;
        if (PACKED) {
            const int wd = coef_word(p, wadd(wadd(p.cf_base, offs[b] >> 1), i));
            const int vals[2] = {(int)(int16_t)(wd & 0xffff),
                                 (int)(int16_t)((uint32_t)wd >> 16)};
            for (int h = 0; h < 2; h++) {
                const int q = 2 * i + h;
                const int y = COLMAJ ? q % G::SH : q / G::SW;
                const int x = COLMAJ ? q / G::SH : q % G::SW;
                dst[y * G::PITCH + x] = vals[h];
            }
        } else {
            const int y = COLMAJ ? i % G::SH : i / G::SW;
            const int x = COLMAJ ? i / G::SH : i % G::SW;
            dst[y * G::PITCH + x] = coef_word(p, wadd(wadd(p.cf_base, offs[b]), i));
        }
    }
}

// Step `step` (0-3) of thread t in the j-th thread block of class c. The
// steps must run in order, each completing for every thread before the
// next begins. dsc holds the blocks' descriptors, row r of block b at
// dsc[r * ITX_MAXK + b].
template <int W, int H, bool WHT>
RAV1D_HD void cta_step(int step, int t, const ItxFrame& p, const ItxClass& c,
                       int j, int* tile, int* dsc) {
    using G = Geo<W, H>;
    constexpr int R = WHT ? 2 : 4;  // descriptor rows
    const int lane0 = j * G::K;
    const int nb = c.n - lane0 < G::K ? c.n - lane0 : G::K;
    if (step == 0) {
        const int r = t / G::K, b = t % G::K;
        if (r < R && b < nb) {
            const int l = lane0 + b;
            dsc[r * ITX_MAXK + b] =
                p.desc[c.desc + (l / c.B) * R * c.B + r * c.B + l % c.B];
        }
    } else if (step == 1) {
        if (p.packed && p.col_major) load_coefs<W, H, true, true>(t, p, nb, tile, dsc);
        else if (p.packed) load_coefs<W, H, true, false>(t, p, nb, tile, dsc);
        else if (p.col_major) load_coefs<W, H, false, true>(t, p, nb, tile, dsc);
        else load_coefs<W, H, false, false>(t, p, nb, tile, dsc);
    } else if (step == 2) {
        if (t < nb * G::SH) {
            const int b = t / G::SH, r = t % G::SH;
            int* v = tile + b * G::TILE + r * G::PITCH;
            if (WHT) {
                wht_row(v);
            } else {
                constexpr int rect2 = W * 2 == H || H * 2 == W;
                row_pass<W>(dsc[2 * ITX_MAXK + b], v, rect2, itx_shift(W, H),
                            p.clip[0], p.clip[1], p.clip[2], p.clip[3]);
            }
        }
    } else {
        if (t < nb * W) {
            const int b = t / W, x = t % W;
            const int* v = tile + b * G::TILE + x;
            const int base = wadd(dsc[ITX_MAXK + b], x);
            if (WHT)
                wht_col(v, G::PITCH, p.out, base, p.pitch, p.out_len);
            else
                col_pass<H>(dsc[3 * ITX_MAXK + b], v, G::PITCH, p.out, base,
                            p.pitch, p.out_len, p.clip[2], p.clip[3]);
        }
    }
}

// the class of thread block `cta` (classes in order of cta0)
RAV1D_HD int itx_class_of(const ItxFrame& p, int cta) {
    int ci = 0;
    while (ci + 1 < p.ncls && cta >= p.cls[ci + 1].cta0) ci++;
    return ci;
}

// blocks per thread block of a class, 0 for an unknown one
static int itx_blocks_per_cta(int wh) {
    switch (wh) {
#define X(w, h) case w * 100 + h: return Geo<w, h>::K;
        ITX_SIZES(X)
#undef X
        case 0: return Geo<4, 4>::K;
        default: return 0;
    }
}

// Fill the launch parameter from the caller's table: ncls rows of (wh, n,
// desc, B) int32. Returns the number of thread blocks, or -1 for a table
// the kernel does not take.
static int itx_table(ItxFrame* p, const void* desc, const void* coef,
                     void* out, int coef_len, int cf_base, int out_len,
                     int pitch, int packed, int col_major, int bpc,
                     const int* cls, int ncls) {
    if (ncls < 0 || ncls > ITX_MAX_CLASSES || coef_len <= 0) return -1;
    p->desc = (const int*)desc;
    p->coef = (const int*)coef;
    p->out = (int*)out;
    p->coef_len = coef_len;
    p->cf_base = cf_base;
    p->out_len = out_len;
    p->pitch = pitch;
    p->packed = packed;
    p->col_major = col_major;
    itx_clips(bpc, p->clip);
    int grid = 0;
    p->ncls = 0;
    for (int i = 0; i < ncls; i++) {
        const int* r = cls + 4 * i;
        const int k = itx_blocks_per_cta(r[0]);
        if (!k || r[1] < 0 || r[3] <= 0) return -1;
        if (!r[1]) continue;
        ItxClass& e = p->cls[p->ncls++];
        e.wh = r[0];
        e.n = r[1];
        e.desc = r[2];
        e.B = r[3];
        e.cta0 = grid;
        grid += (r[1] + k - 1) / k;
    }
    return grid;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(ITX_THREADS)
itx_frame_kernel(const __grid_constant__ ItxFrame p) {
    __shared__ int tile[ITX_SMEM];
    __shared__ int dsc[4 * ITX_MAXK];
    // the table runs from 4x4 to 64x64, then the WHT: walk it backwards,
    // so the thread blocks with the longest transforms are scheduled early
    // and do not make the tail of the launch
    const int cta = gridDim.x - 1 - blockIdx.x;
    const ItxClass c = p.cls[itx_class_of(p, cta)];
    const int j = cta - c.cta0;
    switch (c.wh) {
#define X(w, h)                                                         \
        case w * 100 + h:                                               \
            for (int s = 0; s < 4; s++) {                               \
                cta_step<w, h, false>(s, threadIdx.x, p, c, j, tile, dsc); \
                __syncthreads();                                        \
            }                                                           \
            break;
        ITX_SIZES(X)
#undef X
        default:  // 0: the WHT
            for (int s = 0; s < 4; s++) {
                cta_step<4, 4, true>(s, threadIdx.x, p, c, j, tile, dsc);
                __syncthreads();
            }
    }
}

// Plain C entry (bound with ctypes): one launch over the class table
// `cls` (ncls rows of (wh, n, desc, B), host memory) on `stream`. Returns
// the launch's cudaGetLastError(), or -1 for a table the kernel does not
// take.
extern "C" int rav1d_itx_frame(const void* desc, const void* coef, void* out,
                               int coef_len, int cf_base, int out_len,
                               int pitch, int packed, int col_major, int bpc,
                               const int* cls, int ncls, void* stream) {
    ItxFrame p;
    const int grid = itx_table(&p, desc, coef, out, coef_len, cf_base,
                               out_len, pitch, packed, col_major, bpc, cls,
                               ncls);
    if (grid < 0) return -1;
    if (grid == 0) return 0;
    itx_frame_kernel<<<grid, ITX_THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__

// ---------------------------------------------------------------------------
// 8x8 DCT_DCT batch. Replaces the TPU kernel rav1d_tpu/ops/pallas/itx8.py
// idct8x8_batch_pallas: per block, the row DCT8 clipped to the row bounds,
// (v + 1) >> 1 clipped to the column bounds, the column DCT8, (v + 8) >> 4
// (the 8x8 size with both codes 0). Both 1-D passes are the compile-time
// dct8 of itx_1d.cuh: no per-block codes, no branch on them.
//
// Bound: device-memory bytes, narrowly. 512 B move per block (each
// coefficient read once, each residual written once) against 1,952 integer
// operations (ops/cuda/gen_itx_1d.py op_count), 3.8 per byte, while the
// card issues about 5 int32 operations in the time it moves one byte (see
// the frame kernel's note above).
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

#else  // a host build of the same functions, for the CPU tests

// One thread block on the host: each step for every thread in turn.
template <int W, int H, bool WHT>
static void host_cta(const ItxFrame& p, const ItxClass& c, int j) {
    int tile[ITX_SMEM];
    int dsc[4 * ITX_MAXK];
    for (int s = 0; s < 4; s++)
        for (int t = 0; t < ITX_THREADS; t++)
            cta_step<W, H, WHT>(s, t, p, c, j, tile, dsc);
}

// rav1d_itx_frame's arguments without the stream; runs every thread block
// of the launch in order. Returns 0, or -1 for a table the kernel does not
// take.
extern "C" int rav1d_itx_frame_host(const void* desc, const void* coef,
                                    void* out, int coef_len, int cf_base,
                                    int out_len, int pitch, int packed,
                                    int col_major, int bpc, const int* cls,
                                    int ncls) {
    ItxFrame p;
    const int grid = itx_table(&p, desc, coef, out, coef_len, cf_base,
                               out_len, pitch, packed, col_major, bpc, cls,
                               ncls);
    if (grid < 0) return -1;
    for (int cta = 0; cta < grid; cta++) {
        const ItxClass c = p.cls[itx_class_of(p, cta)];
        const int j = cta - c.cta0;
        switch (c.wh) {
#define X(w, h) case w * 100 + h: host_cta<w, h, false>(p, c, j); break;
            ITX_SIZES(X)
#undef X
            default: host_cta<4, 4, true>(p, c, j);
        }
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
