// The inter phase of a frame, CUDA C++ for sm_90a: every put, warp, prep,
// compound combine and OBMC blend of the frame and the batch residual add,
// in one persistent cooperative launch whose phases meet at a grid-wide
// barrier: rav1d_inter_batches (the decoder path's), or the earlier form
// rav1d_inter_frame, kept for comparison; each has a traced build.
//
// Replaces the XLA device program the JAX engine runs once per inter frame:
// rav1d_tpu/engine/mega.py inter_prog (:466), with _put_out (:289),
// _prep_out (:369), _warp_out (:423) and the tile helpers of
// rav1d_tpu/engine/tiles.py (_i16, _gather, _filters: :38-58). The port's
// plain version is engine/programs.py inter_plain (one batch of torch ops
// per slot run); these kernels compute exactly what it computes.
//
// What the plain version computes: 8x8 destination tiles, each described by
// one lane of a slot's descriptor chunks in the frame blob (engine/layout.py
// SLOTS, D_*/W_*/C_*/B_* rows), in this order: (1) puts of the five filter
// cases (8-tap h+v, h, v, copy, bilinear) from the reference planes into the
// planes (putY/putC) or the OBMC lap pool (lapY/lapC); (2) affine warp puts
// (warpY/warpC); (3) preps of the four 8-tap cases and warp preps into the
// compound pool (prepY/prepC, wprepY/wprepC), then the host's pool tiles
// (hostpool); (4) the compound combines from the pool (avg, the DIFFWTD
// segy00/segy10/segy11, which also write the mask pool, the wedge `mask`,
// then seguv, which reads the mask pool); (5) the OBMC blends of the lap
// pool over the planes, the top-lap run before the left-lap run; (6) the
// residual add of ra[3 psz, 6 psz) over the planes, clipped. Every source
// window is clamped to the reference's visible size (emu_edge's border
// replication); every scatter writes only the cells r < th, c < tw and drops
// an index outside its buffer; every gather clamps its index as the plain
// version does (pool rows, the blob, the mask pool, the planes, the stack).
//
// Design: one launch per inter frame, 256 threads a block, a grid of as many
// blocks as the card keeps resident (cudaLaunchCooperativeKernel refuses
// more). Phases, each a range of the launch's segment table (one segment
// per slot run, from the packer's runs):
//   ZERO   the pool rows the combines read, the lap rows the blends read and
//          the mask cells seguv reads set to 0 (the plain version's pools
//          start as zeros; these buffers are not filled otherwise);
//   PRED   every put, lap, warp, prep, warp prep and host pool tile: they
//          read only the reference planes and the blob and write disjoint
//          pixels and pool rows (tests/test_torch_inter_kernel.py checks it
//          on every test frame);
//   COMB   avg, segy00/10/11 and mask (disjoint pixels);
//   SEGUV  seguv, after the DIFFWTD mask writes;
//   TOP    the blend slot's first run (the top laps);
//   LEFT   its second run (the left laps), which reads what TOP wrote;
//   RESID  the residual add, a flat pass over the three planes.
// Empty phases are skipped by every block alike; a grid-wide barrier (the
// wave kernel's: a rising counter set to 0 before the launch, a release
// fence and a relaxed add to arrive, an acquiring spin to wait) separates
// two phases that run. Each phase waits on the one before for a write it
// reads (ZERO's zeros under PRED's preps and the combines' reads, the
// preps' pool rows, the DIFFWTD masks, TOP's corners, every pixel under
// the residual add), so every barrier stays. Reads of what the launch
// itself writes (planes, pools) go through ld.global.cg: a persistent
// block keeps its SM's L1 across phases.
//
// The new form (rav1d_inter_batches). The earlier form's trace (chip_smoke
// inter_trace) showed the puts' phase issue-bound at a tile a warp, the
// residual add at 20-43% of the launch and each small phase a barrier plus
// one tile's latency. So: the warp filter (193 x 8) and the sub-pixel
// filters (6 x 15 x 8) are copied into shared memory as int8 once a block
// (a row of warp taps is one 8-byte shared load); a warp takes a batch of
// consecutive tiles (two batches a warp, block-major, so that a warp's and
// an SM's work mixes the phase's slots), lane l loading tile l's slot,
// case and descriptor rows (row r of the batch in one load of consecutive
// words; the segment search once a batch); a window inside the visible
// picture loads as the aligned 32-bit words that hold its pixels, 4
// pixels a lane from one to three words by a funnel shift, the next tile's
// while the current one computes (registers as the second buffer); a
// window across an edge is the clamped gather, as before; the taps sit in
// registers for the passes; the combine, blend and host-pool stores read
// both of a lane's cells before storing either; and the residual add is a
// 16-byte pass (ld.global.cg of the planes, a non-coherent load of the
// residuals) with a scalar tail, or scalar where the two are not 16-byte
// aligned.
//
// Bound on this card: bytes. A 1080p inter frame moves the residual add's
// three int32 planes (read, residuals read, written: 75 MB) and its tiles'
// descriptors and windows: 85-110 MB, 25-33 us at 3.35 TB/s, against
// 31-186 M int32 operations (2-11 us; chip_smoke.py inter_work). On an
// H100 80GB HBM3 the new form took 0.079-0.149 ms of device time on the
// 1080p test frames, the earlier form 0.083-0.176 ms in the same call
// (PERF.md): the residual add runs near the memory's rate, the puts' phase
// stays issue-bound and uneven across the SMs, and the barriers and the
// small phases' tiles hold about a fifth of the launch.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_inter_batches_host and rav1d_inter_frame_host walk the same
// phases, warps, batches and tiles with the same step functions, lane by
// lane, each barrier a loop boundary, for the CPU tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define IK_HD __host__ __device__ __forceinline__
#define IK_M __host__ __device__ __forceinline__
#else
#define IK_HD static inline
#define IK_M inline
#endif

enum {
    IK_THREADS = 256,
    IK_WARPS = IK_THREADS / 32,
    IK_SEGS = 64,  // segments (slot runs) a launch takes
    IK_REFS = 16,  // reference planes of each kind (luma, chroma)
    IK_TB = 256,   // lanes of an inter chunk (engine/layout.py TB)
    IK_HB = 64,    // lanes of a host pool chunk (HB)
};

// phases; PRED..LEFT are ranges of the segment table, ZERO covers COMB..LEFT
enum { PH_ZERO, PH_PRED, PH_COMB, PH_SEGUV, PH_TOP, PH_LEFT, PH_RESID };

// the slots (engine/layout.py SLOTS)
enum {
    S_PUTY, S_PUTC, S_LAPY, S_LAPC, S_WARPY, S_WARPC, S_PREPY, S_PREPC, S_WPREPY,
    S_WPREPC, S_HOST, S_AVG, S_SEGY00, S_SEGY10, S_SEGY11, S_MASK, S_SEGUV, S_BLEND
};

// descriptor rows (engine/layout.py D_*, W_*, C_*, B_*)
enum { D_SROW, D_SY, D_SX, D_MX, D_MY, D_F2D, D_FLAT0, D_TW, D_TH, D_BW, D_BH };
enum { W_SROW, W_SY, W_SX, W_A, W_B, W_C, W_D, W_MX, W_MY, W_FLAT0, W_TW, W_TH };
enum { C_R0, C_R1, C_FLAT0, C_P0, C_P1, C_P2, C_TW, C_TH };
enum { B_ROW, B_FLAT0, B_MOFF, B_MRS, B_MCS, B_TW, B_TH };

// a warp's shared words: descriptor, taps (h then v), window (15 rows of 16),
// the horizontal pass (15 rows of 8), the DIFFWTD mask (8 x 8)
enum {
    WS_D = 0,
    WS_T = 16,
    WS_WIN = 32,
    WS_MID = WS_WIN + 15 * 16,
    WS_M = WS_MID + 15 * 8,
    WS_WORDS = WS_M + 64
};

// table sizes (engine/consts.py): mc_subpel_filters (6, 15, 8),
// mc_warp_filter (193, 8), filter_dir (10, 2)
enum { IK_NF = 6, IK_NPH = 15, IK_NWF = 193, IK_NFD = 10 };

// The launch's arguments (ops/cuda/inter.py InterFrame, field for field).
struct InterFrame {
    int* planes;      // (3, ah, aw) int32, written in place
    const int* ra;    // the residual buffer (6 psz); [3 psz, 6 psz) is added last
    const int* blob;  // the frame blob
    int* pool;        // the compound pool, poolrows x 64 words
    int* lap;         // the OBMC lap pool, poolrows x 64 words
    int* mask;        // the DIFFWTD mask pool, psz words
    const int* subpel;  // mc_subpel_filters
    const int* warpf;   // mc_warp_filter
    const int* fdir;    // filter_dir
    const void* ref[2][IK_REFS];  // luma, chroma reference planes (uint8 or int16)
    int nref[2];      // reference planes of each kind (0: every read is 0)
    int esize[2];     // their element size: 1 (uint8) or 2 (int16)
    int refw[2];      // their row stride in elements
    int vw[2], vh[2];  // the visible picture a window is clamped to
    int blob_len, ah, aw, bpc, poolrows, hbase;
    int ps[6];        // segments of phase PRED + i: [ps[i], ps[i + 1])
    int seg_slot[IK_SEGS];   // each segment's slot
    int seg_case[IK_SEGS];   // its filter case (puts 0-4, preps 0-3; else 0)
    int seg_base[IK_SEGS];   // the blob word of its first chunk
    int seg_first[IK_SEGS + 1];  // its first tile, counted over the table
};

// a read of what the launch never writes (the blob, the tables, the planes of
// the references)
template <typename T>
IK_HD T IK_LD(const T* p) {
#ifdef __CUDA_ARCH__
    return __ldg(p);
#else
    return *p;
#endif
}

// a read of what the launch writes (planes, pools): from L2, past the SM's L1
IK_HD int IK_CG(const int* p) {
#ifdef __CUDA_ARCH__
    return __ldcg(p);
#else
    return *p;
#endif
}

// torch.clamp(v, lo, hi): max first, then min
IK_HD int ik_clamp(int v, int lo, int hi) {
    const int t = v < lo ? lo : v;
    return t > hi ? hi : t;
}

IK_HD int ik_i16(int a) { return ((a + 0x8000) & 0xFFFF) - 0x8000; }

IK_HD int ik_ib(int bpc) { return bpc <= 10 ? 4 : 2; }

IK_HD int ik_rows(int slot) {
    return slot == S_HOST ? 65 : slot == S_BLEND ? 7 : slot >= S_AVG ? 8 : 12;
}

// a slot of 8-tap or bilinear tiles (puts, laps, preps: the D_* rows)
IK_HD bool ik_mc_slot(int slot) { return slot <= S_LAPC || slot == S_PREPY || slot == S_PREPC; }

IK_HD bool ik_warp_slot(int slot) {
    return slot == S_WARPY || slot == S_WARPC || slot == S_WPREPY || slot == S_WPREPC;
}

// The filter tables as a kernel reads them: from global memory (the earlier
// form) or from the block's int8 copies in shared memory (the new form; the
// tables' values lie in [-22, 127]).
struct IkGlobalTabs {
    const InterFrame* p;
    IK_M int fdir(int i) const { return IK_LD(p->fdir + i); }
    IK_M int subpel(int i) const { return IK_LD(p->subpel + i); }
    IK_M void warp(int row, int* t) const {
        for (int k = 0; k < 8; k++) t[k] = IK_LD(p->warpf + row * 8 + k);
    }
};

struct IkSharedTabs {
    const int8_t* warpf;  // IK_NWF x 8, 8-byte aligned
    const int8_t* sub;    // IK_NF x IK_NPH x 8
    const int* fd;        // IK_NFD x 2
    IK_M int fdir(int i) const { return fd[i]; }
    IK_M int subpel(int i) const { return sub[i]; }
    // a row's 8 taps: one 8-byte shared load, each byte sign-extended
    IK_M void warp(int row, int* t) const {
#ifdef __CUDA_ARCH__
        const int2 v = *(const int2*)(warpf + row * 8);
#pragma unroll
        for (int k = 0; k < 4; k++) {
            t[k] = (int)((unsigned)v.x << (24 - 8 * k)) >> 24;
            t[k + 4] = (int)((unsigned)v.y << (24 - 8 * k)) >> 24;
        }
#else
        for (int k = 0; k < 8; k++) t[k] = warpf[row * 8 + k];
#endif
    }
};

// the warp filter's row of a position m (mega.py _warp_out)
IK_HD int ik_warp_row(int m) { return ik_clamp(64 + ((m + 512) >> 10), 0, IK_NWF - 1); }

// tap `lane` (< 16: horizontal, then vertical) of an 8-tap tile (tiles.py
// _filters: the filter types of the 2-D code, 4-tap variants for blocks 4
// wide or tall, phase 0 reading phase 1)
template <class TB>
IK_HD int ik_subpel_tap(const TB& tb, int f2d, int bw, int bh, int mx, int my, int lane) {
    const int dir = lane >> 3, tap = lane & 7;
    const int fd = tb.fdir(2 * ik_clamp(f2d, 0, IK_NFD - 1) + dir);
    const int big = dir ? bh > 4 : bw > 4;
    const int fi = ik_clamp(big ? fd : 3 + (fd & 1), 0, IK_NF - 1);
    const int ph = ik_clamp((dir ? my : mx) - 1, 0, IK_NPH - 1);
    return tb.subpel((fi * IK_NPH + ph) * 8 + tap);
}

// A tile: its segment's slot and case and the blob word of its descriptor's
// row 0 (row r at word + r * lanes a chunk).
struct IkTile {
    int slot, cs, word, B;
};

// the first and last tile of a phase
IK_HD void ik_range(const InterFrame& p, int ph, int* g0, int* g1) {
    if (ph == PH_ZERO) {
        *g0 = p.seg_first[p.ps[1]];
        *g1 = p.seg_first[p.ps[5]];
    } else {
        *g0 = p.seg_first[p.ps[ph - PH_PRED]];
        *g1 = p.seg_first[p.ps[ph - PH_PRED + 1]];
    }
}

IK_HD IkTile ik_tile(const InterFrame& p, int g) {
    int s = 0;
    while (p.seg_first[s + 1] <= g) s++;
    IkTile t;
    t.slot = p.seg_slot[s];
    t.cs = p.seg_case[s];
    t.B = t.slot == S_HOST ? IK_HB : IK_TB;
    const int i = g - p.seg_first[s], c = i / t.B, l = i % t.B;
    t.word = p.seg_base[s] + c * ik_rows(t.slot) * t.B + l;
    return t;
}

IK_HD int ik_desc(const InterFrame& p, const IkTile& t, int r) {
    return IK_LD(p.blob + t.word + r * t.B);
}

// pixel (y, x) of reference plane srow of kind k, each index clamped
IK_HD int ik_ref(const InterFrame& p, int k, int srow, int y, int x) {
    if (p.nref[k] <= 0) return 0;
    srow = ik_clamp(srow, 0, p.nref[k] - 1);
    y = ik_clamp(y, 0, p.vh[k] - 1);
    x = ik_clamp(x, 0, p.vw[k] - 1);
    const size_t o = (size_t)y * p.refw[k] + x;
    if (p.esize[k] == 1) return IK_LD((const uint8_t*)p.ref[k][srow] + o);
    return IK_LD((const int16_t*)p.ref[k][srow] + o);
}

// the window of an 8-tap or bilinear case: first row and column, rows, columns
IK_HD void ik_win_geom(int cs, const int* d, int* y0, int* x0, int* ny, int* nx) {
    const bool v = cs == 0 || cs == 2, h = cs == 0 || cs == 1;
    *y0 = d[D_SY] - (v ? 3 : 0);
    *x0 = d[D_SX] - (h ? 3 : 0);
    *ny = cs == 4 ? 9 : (v ? 15 : 8);
    *nx = cs == 4 ? 9 : (h ? 15 : 8);
}

// a masked 8x8 store: cell o of the tile at flat0 with rows `stride` apart
IK_HD void ik_store(int* buf, long long n, int flat0, int stride, int tw, int th, int o, int v) {
    const int r = o >> 3, c = o & 7;
    if (r >= th || c >= tw) return;
    const long long idx = (long long)flat0 + (long long)r * stride + c;
    if (idx >= 0 && idx < n) buf[idx] = v;
}

IK_HD long long ik_pool_words(const InterFrame& p) { return (long long)p.poolrows * 64; }

IK_HD int ik_psz(const InterFrame& p) { return p.ah * p.aw; }

// step 0: the descriptor into the warp's shared words
IK_HD void ik_step_desc(const InterFrame& p, const IkTile& t, int lane, int* ws) {
    if (t.slot != S_HOST && lane < ik_rows(t.slot)) ws[WS_D + lane] = ik_desc(p, t, lane);
}

// step 1: the source window and the taps of a put, prep or warp tile
template <class TB>
IK_HD void ik_step_window(const TB& tb, const InterFrame& p, const IkTile& t, int lane, int* ws) {
    const int* d = ws + WS_D;
    const int k = t.slot & 1;  // slots 0-9 alternate luma, chroma
    if (ik_mc_slot(t.slot)) {
        int y0, x0, ny, nx;
        ik_win_geom(t.cs, d, &y0, &x0, &ny, &nx);
        for (int i = lane; i < ny * nx; i += 32) {
            const int r = i / nx, c = i % nx;
            ws[WS_WIN + r * 16 + c] = ik_ref(p, k, d[D_SROW], y0 + r, x0 + c);
        }
        if (t.cs <= 2 && lane < 16)
            ws[WS_T + lane] =
                ik_subpel_tap(tb, d[D_F2D], d[D_BW], d[D_BH], d[D_MX], d[D_MY], lane);
    } else if (ik_warp_slot(t.slot)) {
        for (int i = lane; i < 225; i += 32) {
            const int r = i / 15, c = i % 15;
            ws[WS_WIN + r * 16 + c] = ik_ref(p, k, d[W_SROW], d[W_SY] - 3 + r, d[W_SX] - 3 + c);
        }
    }
}

IK_HD int ik_pool_cell(const int* pool, const InterFrame& p, int row, int o) {
    return IK_CG(pool + (size_t)ik_clamp(row, 0, p.poolrows - 1) * 64 + o);
}

// the DIFFWTD mask value of a cell
IK_HD int ik_seg_m(const InterFrame& p, int t1, int t2) {
    const int ib = ik_ib(p.bpc), sh = p.bpc + ib - 4;
    const int d = t1 - t2;
    const int m = 38 + (((d < 0 ? -d : d) + (1 << (sh - 5))) >> sh);
    return m > 64 ? 64 : m;
}

// step 2: the horizontal pass (8-tap h+v, bilinear, warp), the DIFFWTD mask
// (fh: the horizontal taps, the shared words' or registers the new form
// loaded them into)
template <class TB>
IK_HD void ik_step_h(const TB& tb, const InterFrame& p, const IkTile& t, int lane, int* ws,
                     const int* fh) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc);
    if (ik_mc_slot(t.slot) && t.cs == 0) {
        const int sh = 6 - ib;
        for (int i = lane; i < 120; i += 32) {
            const int r = i >> 3, x = i & 7;
            int s = 0;
            for (int k = 0; k < 8; k++) s += fh[k] * ws[WS_WIN + r * 16 + x + k];
            ws[WS_MID + i] = ik_i16((s + ((1 << sh) >> 1)) >> sh);
        }
    } else if (ik_mc_slot(t.slot) && t.cs == 4) {
        const int sh = 4 - ib, rnd = (1 << sh) >> 1;
        for (int i = lane; i < 72; i += 32) {
            const int r = i >> 3, x = i & 7;
            const int h0 = ws[WS_WIN + r * 16 + x], h1 = ws[WS_WIN + r * 16 + x + 1];
            ws[WS_MID + i] = ik_i16((16 * h0 + d[D_MX] * (h1 - h0) + rnd) >> sh);
        }
    } else if (ik_warp_slot(t.slot)) {
        const int sh = 7 - ib;
        for (int i = lane; i < 120; i += 32) {
            const int y = i >> 3, x = i & 7;
            int f[8];
            tb.warp(ik_warp_row(d[W_MX] + y * d[W_B] + x * d[W_A]), f);
            int s = 0;
            for (int k = 0; k < 8; k++) s += f[k] * ws[WS_WIN + y * 16 + x + k];
            ws[WS_MID + i] = ik_i16((s + ((1 << sh) >> 1)) >> sh);
        }
    } else if (t.slot >= S_SEGY00 && t.slot <= S_SEGY11) {
        for (int o = lane; o < 64; o += 32)
            ws[WS_M + o] = ik_seg_m(p, ik_pool_cell(p.pool, p, d[C_R0], o),
                                    ik_pool_cell(p.pool, p, d[C_R1], o));
    }
}

// the vertical 8-tap sum of column c from row r of the window or of mid
IK_HD int ik_vsum(const int* fv, const int* ws, int base, int stride, int r, int c) {
    int s = 0;
    for (int k = 0; k < 8; k++) s += fv[k] * ws[base + (r + k) * stride + c];
    return s;
}

IK_HD int ik_hsum(const int* fh, const int* ws, int r, int c) {
    int s = 0;
    for (int k = 0; k < 8; k++) s += fh[k] * ws[WS_WIN + r * 16 + c + k];
    return s;
}

// cell o of a put tile (mega.py _put_out); fh, fv: the taps
IK_HD int ik_put_px(const InterFrame& p, int cs, const int* ws, int o, const int* fh,
                    const int* fv) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc), pxmax = (1 << p.bpc) - 1, sh = 6 - ib;
    const int r = o >> 3, c = o & 7;
    int v;
    switch (cs) {
        case 0: {
            const int sh2 = 6 + ib;
            v = (ik_vsum(fv, ws, WS_MID, 8, r, c) + ((1 << sh2) >> 1)) >> sh2;
            break;
        }
        case 1: v = (ik_hsum(fh, ws, r, c) + 32 + ((1 << sh) >> 1)) >> 6; break;
        case 2: v = (ik_vsum(fv, ws, WS_WIN, 16, r, c) + 32) >> 6; break;
        case 3: return ws[WS_WIN + r * 16 + c];
        default: {
            const int mx = d[D_MX], my = d[D_MY];
            const int h0 = ws[WS_WIN + r * 16 + c], h1 = ws[WS_WIN + (r + 1) * 16 + c];
            const int f0 = ws[WS_MID + r * 8 + c], f1 = ws[WS_MID + (r + 1) * 8 + c];
            const int shv = 4 + ib;
            if (my != 0)
                v = mx != 0 ? (16 * f0 + my * (f1 - f0) + ((1 << shv) >> 1)) >> shv
                            : (16 * h0 + my * (h1 - h0) + 8) >> 4;
            else
                v = mx != 0 ? (f0 + ((1 << ib) >> 1)) >> ib : h0;
        }
    }
    return ik_clamp(v, 0, pxmax);
}

// cell o of a prep tile (mega.py _prep_out)
IK_HD int ik_prep_px(const InterFrame& p, int cs, const int* ws, int o, const int* fh,
                     const int* fv) {
    const int ib = ik_ib(p.bpc), bias = p.bpc == 8 ? 0 : 8192, sh = 6 - ib;
    const int r = o >> 3, c = o & 7;
    int v;
    switch (cs) {
        case 0: v = ((ik_vsum(fv, ws, WS_MID, 8, r, c) + 32) >> 6) - bias; break;
        case 1: v = ((ik_hsum(fh, ws, r, c) + ((1 << sh) >> 1)) >> sh) - bias; break;
        case 2: v = ((ik_vsum(fv, ws, WS_WIN, 16, r, c) + ((1 << sh) >> 1)) >> sh) - bias; break;
        default: v = (ws[WS_WIN + r * 16 + c] << ib) - bias;
    }
    return ik_i16(v);
}

// cell o of a warp tile before its rounding (mega.py _warp_out)
template <class TB>
IK_HD int ik_warp_px(const TB& tb, const int* ws, int o) {
    const int* d = ws + WS_D;
    const int y = o >> 3, x = o & 7;
    int f[8];
    tb.warp(ik_warp_row(d[W_MY] + y * d[W_D] + x * d[W_C]), f);
    int s = 0;
    for (int k = 0; k < 8; k++) s += f[k] * ws[WS_MID + (y + k) * 8 + x];
    return s;
}

// step 3 of a PRED tile: the output and its masked store
// (PAIR: as in ik_comb_out, for the host pool tiles' copy)
template <bool PAIR, class TB>
IK_HD void ik_pred_out(const TB& tb, const InterFrame& p, const IkTile& t, int lane, const int* ws,
                       const int* fh, const int* fv) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc), pxmax = (1 << p.bpc) - 1, bias = p.bpc == 8 ? 0 : 8192;
    const long long n3 = 3ll * ik_psz(p), np = ik_pool_words(p);
    if (t.slot == S_HOST) {
        const int row = ik_desc(p, t, 0);
        if (row < 0 || row >= p.poolrows) return;
        if (PAIR) {
            const int v0 = ik_desc(p, t, 1 + lane), v1 = ik_desc(p, t, 33 + lane);
            p.pool[(size_t)row * 64 + lane] = v0;
            p.pool[(size_t)row * 64 + lane + 32] = v1;
            return;
        }
        for (int o = lane; o < 64; o += 32) p.pool[(size_t)row * 64 + o] = ik_desc(p, t, 1 + o);
        return;
    }
    for (int o = lane; o < 64; o += 32) {
        switch (t.slot) {
            case S_PUTY: case S_PUTC:
                ik_store(p.planes, n3, d[D_FLAT0], p.aw, d[D_TW], d[D_TH], o,
                         ik_put_px(p, t.cs, ws, o, fh, fv));
                break;
            case S_LAPY: case S_LAPC:
                ik_store(p.lap, np, d[D_FLAT0], 8, d[D_TW], d[D_TH], o,
                         ik_put_px(p, t.cs, ws, o, fh, fv));
                break;
            case S_PREPY: case S_PREPC:
                ik_store(p.pool, np, d[D_FLAT0], 8, d[D_TW], d[D_TH], o,
                         ik_prep_px(p, t.cs, ws, o, fh, fv));
                break;
            case S_WARPY: case S_WARPC: {
                const int sh = 7 + ib;
                const int v = ik_clamp((ik_warp_px(tb, ws, o) + ((1 << sh) >> 1)) >> sh, 0, pxmax);
                ik_store(p.planes, n3, d[W_FLAT0], p.aw, d[W_TW], d[W_TH], o, v);
                break;
            }
            default: {  // S_WPREPY, S_WPREPC
                const int v = ik_i16(((ik_warp_px(tb, ws, o) + 64) >> 7) - bias);
                ik_store(p.pool, np, d[W_FLAT0], 8, d[W_TW], d[W_TH], o, v);
            }
        }
    }
}

// the inputs of cell o of a combine tile: its two pool cells and its mask
// value (the wedge's, the mask pool's, the DIFFWTD's; avg: none)
IK_HD void ik_comb_in(const InterFrame& p, const IkTile& t, const int* ws, int o, int* t1,
                      int* t2, int* m) {
    const int* d = ws + WS_D;
    const int r = o >> 3, c = o & 7;
    *t1 = ik_pool_cell(p.pool, p, d[C_R0], o);
    *t2 = ik_pool_cell(p.pool, p, d[C_R1], o);
    if (t.slot == S_MASK)
        *m = IK_LD(p.blob + ik_clamp(p.hbase + d[C_P0] + r * d[C_P1] + c, 0, p.blob_len - 1));
    else if (t.slot == S_SEGUV)
        *m = IK_CG(p.mask + ik_clamp(d[C_P0] + r * d[C_P1] + c, 0, ik_psz(p) - 1));
    else if (t.slot != S_AVG)
        *m = ws[WS_M + o];
}

// the masked store of combine cell o from its inputs
IK_HD void ik_comb_store(const InterFrame& p, const IkTile& t, const int* ws, int o, int t1, int t2,
                         int m) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc), pxmax = (1 << p.bpc) - 1, bias = p.bpc == 8 ? 0 : 8192;
    int v;
    if (t.slot == S_AVG) {
        const int wt = d[C_P0];
        v = (t1 * wt + t2 * (16 - wt) + (8 << ib) + bias * 16) >> (ib + 4);
    } else {
        v = (t1 * m + t2 * (64 - m) + (32 << ib) + bias * 64) >> (ib + 6);
    }
    ik_store(p.planes, 3ll * ik_psz(p), d[C_FLAT0], p.aw, d[C_TW], d[C_TH], o,
             ik_clamp(v, 0, pxmax));
}

// the mask pool of a DIFFWTD tile: the cells of the (sub-sampled) mask,
// with the sign bits
IK_HD void ik_comb_mask(const InterFrame& p, const IkTile& t, int lane, const int* ws) {
    if (t.slot < S_SEGY00 || t.slot > S_SEGY11) return;
    const int* d = ws + WS_D;
    const int psz = ik_psz(p);
    const int sh = t.slot != S_SEGY00, sv = t.slot == S_SEGY11;
    const int mw = 8 >> sh, ncell = (8 >> sv) * mw, signs = d[C_P2];
    const int* m = ws + WS_M;
    for (int i = lane; i < ncell; i += 32) {
        const int r = i / mw, c = i % mw;
        int v;
        if (!sh) {
            v = m[r * 8 + c];
        } else if (!sv) {
            v = (m[r * 8 + 2 * c] + m[r * 8 + 2 * c + 1] + 1 - signs) >> 1;
        } else {
            v = (m[2 * r * 8 + 2 * c] + m[2 * r * 8 + 2 * c + 1] + m[(2 * r + 1) * 8 + 2 * c] +
                 m[(2 * r + 1) * 8 + 2 * c + 1] + 2 - signs) >> 2;
        }
        if (r >= ((d[C_TH] + sv) >> sv) || c >= ((d[C_TW] + sh) >> sh)) continue;
        const long long idx = (long long)d[C_P0] + (long long)r * d[C_P1] + c;
        if (idx >= 0 && idx < psz) p.mask[idx] = v;
    }
}

// step 3 of a combine tile (mega.py avg_body, the DIFFWTD bodies, mask_body,
// seguv_body); PAIR (the new form): both of the lane's cells read before
// either is stored
template <bool PAIR>
IK_HD void ik_comb_out(const InterFrame& p, const IkTile& t, int lane, const int* ws) {
    int t1[2], t2[2], m[2] = {0, 0};
    if (PAIR) {
        for (int h = 0; h < 2; h++) ik_comb_in(p, t, ws, lane + 32 * h, t1 + h, t2 + h, m + h);
        for (int h = 0; h < 2; h++) ik_comb_store(p, t, ws, lane + 32 * h, t1[h], t2[h], m[h]);
    } else {
        for (int o = lane; o < 64; o += 32) {
            ik_comb_in(p, t, ws, o, t1, t2, m);
            ik_comb_store(p, t, ws, o, t1[0], t2[0], m[0]);
        }
    }
    ik_comb_mask(p, t, lane, ws);
}

// the inputs of cell o of a blend tile (mega.py blend_body): the plane's
// pixel, the lap's and the mask's, and the pixel's index
IK_HD void ik_blend_in(const InterFrame& p, const int* ws, int o, int* a, int* b, int* m,
                       int* idx) {
    const int* d = ws + WS_D;
    const int n3 = 3 * ik_psz(p);
    const int r = o >> 3, c = o & 7;
    *idx = d[B_FLAT0] + r * p.aw + c;
    *a = IK_CG(p.planes + ik_clamp(*idx, 0, n3 - 1));
    *b = ik_pool_cell(p.lap, p, d[B_ROW], o);
    *m = IK_LD(p.blob + ik_clamp(p.hbase + d[B_MOFF] + r * d[B_MRS] + c * d[B_MCS], 0,
                                 p.blob_len - 1));
}

IK_HD void ik_blend_store(const InterFrame& p, const int* ws, int o, int a, int b, int m, int idx) {
    const int* d = ws + WS_D;
    const int r = o >> 3, c = o & 7;
    if (r < d[B_TH] && c < d[B_TW] && idx >= 0 && idx < 3 * ik_psz(p))
        p.planes[idx] = (a * (64 - m) + b * m + 32) >> 6;
}

// step 3 of a blend tile; PAIR as in ik_comb_out (the two cells lie four
// rows apart, and no two tiles of a phase write one pixel)
template <bool PAIR>
IK_HD void ik_blend_out(const InterFrame& p, int lane, const int* ws) {
    int a[2], b[2], m[2], idx[2];
    if (PAIR) {
        for (int h = 0; h < 2; h++) ik_blend_in(p, ws, lane + 32 * h, a + h, b + h, m + h, idx + h);
        for (int h = 0; h < 2; h++) ik_blend_store(p, ws, lane + 32 * h, a[h], b[h], m[h], idx[h]);
    } else {
        for (int o = lane; o < 64; o += 32) {
            ik_blend_in(p, ws, o, a, b, m, idx);
            ik_blend_store(p, ws, o, a[0], b[0], m[0], idx[0]);
        }
    }
}

// step 3 of the ZERO phase: what a combine or blend tile will read, zeroed
IK_HD void ik_zero_out(const InterFrame& p, const IkTile& t, int lane, const int* ws) {
    const int* d = ws + WS_D;
    for (int o = lane; o < 64; o += 32) {
        if (t.slot == S_BLEND) {
            p.lap[(size_t)ik_clamp(d[B_ROW], 0, p.poolrows - 1) * 64 + o] = 0;
            continue;
        }
        p.pool[(size_t)ik_clamp(d[C_R0], 0, p.poolrows - 1) * 64 + o] = 0;
        p.pool[(size_t)ik_clamp(d[C_R1], 0, p.poolrows - 1) * 64 + o] = 0;
        if (t.slot == S_SEGUV)
            p.mask[ik_clamp(d[C_P0] + (o >> 3) * d[C_P1] + (o & 7), 0, ik_psz(p) - 1)] = 0;
    }
}

enum { IK_STEPS = 4 };

// step 3 of a tile in phase ph (fh, fv: the taps; PAIR: as in ik_comb_out)
template <bool PAIR, class TB>
IK_HD void ik_out(const TB& tb, const InterFrame& p, int ph, const IkTile& t, int lane, int* ws,
                  const int* fh, const int* fv) {
    if (ph == PH_ZERO) ik_zero_out(p, t, lane, ws);
    else if (ph == PH_PRED) ik_pred_out<PAIR>(tb, p, t, lane, ws, fh, fv);
    else if (t.slot == S_BLEND) ik_blend_out<PAIR>(p, lane, ws);
    else ik_comb_out<PAIR>(p, t, lane, ws);
}

// step s of tile t in phase ph for one lane (the earlier form)
IK_HD void ik_step(const InterFrame& p, int ph, const IkTile& t, int s, int lane, int* ws) {
    const IkGlobalTabs tb{&p};
    switch (s) {
        case 0: ik_step_desc(p, t, lane, ws); break;
        case 1: if (ph == PH_PRED) ik_step_window(tb, p, t, lane, ws); break;
        case 2: if (ph != PH_ZERO) ik_step_h(tb, p, t, lane, ws, ws + WS_T); break;
        default: ik_out<false>(tb, p, ph, t, lane, ws, ws + WS_T, ws + WS_T + 8);
    }
}

// the residual add of flat pixel i
IK_HD void ik_resid(const InterFrame& p, int i) {
    const int n3 = 3 * ik_psz(p);
    p.planes[i] = ik_clamp(IK_CG(p.planes + i) + IK_LD(p.ra + n3 + i), 0, (1 << p.bpc) - 1);
}

// arguments the kernel takes: 0, or -1
IK_HD int ik_check(const InterFrame& p) {
    if (p.bpc != 8 && p.bpc != 10 && p.bpc != 12) return -1;
    if (p.ah < 1 || p.aw < 1 || p.poolrows < 1 || p.blob_len < 1) return -1;
    for (int i = 0; i < 5; i++)
        if (p.ps[i] < 0 || p.ps[i] > p.ps[i + 1] || p.ps[i + 1] > IK_SEGS) return -1;
    if (p.ps[0] != 0) return -1;
    for (int s = 0; s < p.ps[5]; s++) {
        if (p.seg_slot[s] < 0 || p.seg_slot[s] > S_BLEND) return -1;
        if (p.seg_first[s] > p.seg_first[s + 1]) return -1;
    }
    for (int k = 0; k < 2; k++) {
        if (p.nref[k] < 0 || p.nref[k] > IK_REFS) return -1;
        if (p.nref[k] && (p.esize[k] < 1 || p.esize[k] > 2 || p.vw[k] < 1 || p.vh[k] < 1))
            return -1;
    }
    return 0;
}

// ------------------------ the new form: batches ------------------------
//
// A warp takes a batch of consecutive tiles of a phase: lane l loads tile
// l's slot, case and blob word (the segment search once a batch) and its
// descriptor rows, row r of the batch's tiles in one load of consecutive
// words; then the warp works through the batch tile by tile, the next
// tile's source window loaded into registers while the current one
// computes and written to its shared words after.

enum {
    IB_ROWS = 12,                   // descriptor rows a batch keeps (all a non-host tile has)
    WB_D = 0,                       // row r of the batch's tile l at r * 32 + l
    WB_META = WB_D + IB_ROWS * 32,  // each tile's slot | case << 8
    WB_WORD = WB_META + 32,         // the blob word of its row 0
    WB_TILE = WB_WORD + 32,         // the current tile's words (WS_* layout)
    WB_WORDS = WB_TILE + WS_WORDS,
    IB_WIN = 6,                     // a lane's window words: three a pass
};

// the first segment of a phase
IK_HD int ik_seg0(const InterFrame& p, int ph) { return p.ps[ph == PH_ZERO ? 1 : ph - PH_PRED]; }

// the warp that takes a phase's batches w, w + warps, .. (ikb_frame)
IK_HD int ik_warp_of(int warp, int block, int grid) { return warp * grid + block; }

// tiles a batch takes in a phase of n tiles over nw warps: every warp two
// batches (from far apart in the phase: ik_warp_of) where 32 a batch allow
// it, so that a warp's work mixes the phase's slots
IK_HD int ik_batch(int n, int nw) {
    const int b = (n + 2 * nw - 1) / (2 * nw);
    return b < 1 ? 1 : (b > 32 ? 32 : b);
}

// lane's part of a batch load: tile g (of a segment from s0 on)
IK_HD void ikb_load(const InterFrame& p, int s0, int g, int lane, int* wb) {
    int s = s0;
    while (p.seg_first[s + 1] <= g) s++;
    const int slot = p.seg_slot[s], B = slot == S_HOST ? IK_HB : IK_TB;
    const int i = g - p.seg_first[s];
    const int word = p.seg_base[s] + (i / B) * ik_rows(slot) * B + i % B;
    const int nr = slot == S_HOST ? 0 : ik_rows(slot);
    int v[IB_ROWS];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int r = 0; r < IB_ROWS; r++) v[r] = r < nr ? IK_LD(p.blob + word + r * B) : 0;
    wb[WB_META + lane] = slot | p.seg_case[s] << 8;
    wb[WB_WORD + lane] = word;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int r = 0; r < IB_ROWS; r++)
        if (r < nr) wb[WB_D + r * 32 + lane] = v[r];
}

IK_HD IkTile ikb_tile(const int* wb, int j) {
    IkTile t;
    t.slot = wb[WB_META + j] & 255;
    t.cs = wb[WB_META + j] >> 8;
    t.B = t.slot == S_HOST ? IK_HB : IK_TB;
    t.word = wb[WB_WORD + j];
    return t;
}

// the source window of batch tile j in phase PRED (a put, lap, prep or warp
// tile): its kind, stack row, first row and column, rows and columns
IK_HD bool ikb_win(const int* wb, int j, int* k, int* srow, int* y0, int* x0, int* ny, int* nx) {
    const IkTile t = ikb_tile(wb, j);
    const int* d = wb + WB_D + j;  // row r at d[32 r]
    *k = t.slot & 1;
    if (ik_mc_slot(t.slot)) {
        int g[16];
        g[D_SY] = d[32 * D_SY];
        g[D_SX] = d[32 * D_SX];
        ik_win_geom(t.cs, g, y0, x0, ny, nx);
        *srow = d[32 * D_SROW];
        return true;
    }
    if (ik_warp_slot(t.slot)) {
        *srow = d[32 * W_SROW];
        *y0 = d[32 * W_SY] - 3;
        *x0 = d[32 * W_SX] - 3;
        *ny = *nx = 15;
        return true;
    }
    return false;
}

// whether a window lies inside the visible picture of a reference plane the
// launch has: then no index needs a clamp, and its rows load as words
IK_HD bool ik_inside(const InterFrame& p, int k, int srow, int y0, int x0, int ny, int nx) {
    return p.nref[k] > 0 && srow >= 0 && srow < p.nref[k] && y0 >= 0 && y0 <= p.vh[k] - ny &&
           x0 >= 0 && x0 <= p.vw[k] - nx;
}

// A lane's share of a window in registers: `n` 0 (no window), 1 (a window
// that crosses an edge: the commit gathers it) or 2 (inside: each pass q's
// aligned 32-bit words in v[3q] .. v[3q + 2]).
struct IkWin {
    int n;
    unsigned v[IB_WIN];
};

// Inside a window a lane takes, in pass q (of 2), the 4 pixels from column
// c of row r: 4 lanes a row of 16 columns, 8 rows a pass. They span 2
// aligned words at 1 byte a pixel, 3 at 2.
IK_HD void ik_lane_cell(int lane, int q, int* r, int* c) {
    *r = (lane >> 2) + 8 * q;
    *c = 4 * (lane & 3);
}

// the first byte of pixel (y, x) of reference plane srow of kind k
IK_HD const uint8_t* ik_cell_ptr(const InterFrame& p, int k, int srow, int y, int x) {
    return (const uint8_t*)p.ref[k][srow] + ((size_t)y * p.refw[k] + x) * p.esize[k];
}

// (hi:lo) >> sh, sh a multiple of 8 below 32 (a funnel shift on the card)
IK_HD unsigned ik_funnel(unsigned lo, unsigned hi, int sh) {
#ifdef __CUDA_ARCH__
    return __funnelshift_r(lo, hi, sh);
#else
    return (unsigned)((((unsigned long long)hi << 32) | lo) >> sh);
#endif
}

// issue: the loads of batch tile j's window into the lane's registers: the
// aligned words that hold a byte of its pixels (so none past the row)
IK_HD void ikb_issue(const InterFrame& p, const int* wb, int j, int lane, IkWin* w) {
    int k, srow, y0, x0, ny, nx;
    w->n = 0;
    if (!ikb_win(wb, j, &k, &srow, &y0, &x0, &ny, &nx)) return;
    if (!ik_inside(p, k, srow, y0, x0, ny, nx)) {  // an edge: gathered at the commit
        w->n = 1;
        return;
    }
    w->n = 2;
    const int es = p.esize[k];
    for (int q = 0; q < 2; q++) {
        int r, c;
        ik_lane_cell(lane, q, &r, &c);
        if (r >= ny || c >= nx) continue;
        const uint8_t* a = ik_cell_ptr(p, k, srow, y0 + r, x0 + c);
        const unsigned* ab = (const unsigned*)((uintptr_t)a & ~(uintptr_t)3);
        const int last = (int)(a - (const uint8_t*)ab) + (nx - c < 4 ? nx - c : 4) * es - 1;
        w->v[3 * q] = IK_LD(ab);
        w->v[3 * q + 1] = last >= 4 ? IK_LD(ab + 1) : 0u;
        w->v[3 * q + 2] = last >= 8 ? IK_LD(ab + 2) : 0u;
    }
}

// commit: the registers' window cells into the shared words (or, at an
// edge, the clamped gather, a pixel a lane at a time), and the taps
template <class TB>
IK_HD void ikb_commit(const TB& tb, const InterFrame& p, const int* wb, int j, int lane,
                      const IkWin* w, int* ws) {
    int k, srow, y0, x0, ny, nx;
    if (!w->n || !ikb_win(wb, j, &k, &srow, &y0, &x0, &ny, &nx)) return;
    if (w->n == 1) {
        for (int q = 0; q < 8; q++) {
            const int r = (lane >> 4) + 2 * q, c = lane & 15;
            if (r < ny && c < nx) ws[WS_WIN + r * 16 + c] = ik_ref(p, k, srow, y0 + r, x0 + c);
        }
    } else {
        const int es = p.esize[k];
        for (int q = 0; q < 2; q++) {
            int r, c;
            ik_lane_cell(lane, q, &r, &c);
            if (r >= ny || c >= nx) continue;
            const int sh = 8 * (int)((uintptr_t)ik_cell_ptr(p, k, srow, y0 + r, x0 + c) & 3);
            const unsigned u0 = ik_funnel(w->v[3 * q], w->v[3 * q + 1], sh);
            const unsigned u1 = ik_funnel(w->v[3 * q + 1], w->v[3 * q + 2], sh);
            int* o = ws + WS_WIN + r * 16 + c;
            for (int b = 0; b < 4 && c + b < nx; b++)
                o[b] = es == 1 ? (int)((u0 >> (8 * b)) & 255)
                               : (int)(int16_t)(((b < 2 ? u0 : u1) >> (16 * (b & 1))) & 65535);
        }
    }
    const IkTile t = ikb_tile(wb, j);
    if (ik_mc_slot(t.slot) && t.cs <= 2 && lane < 16) {
        const int* d = wb + WB_D + j;
        ws[WS_T + lane] = ik_subpel_tap(tb, d[32 * D_F2D], d[32 * D_BW], d[32 * D_BH],
                                        d[32 * D_MX], d[32 * D_MY], lane);
    }
}

// the steps of batch tile j (of n) in phase ph for one lane; `w` is the
// lane's window registers
enum { IB_DESC, IB_ISSUE, IB_H, IB_OUT, IB_COMMIT, IB_STEPS };

template <class TB>
IK_HD void ikb_step(const TB& tb, const InterFrame& p, int ph, int* wb, int j, int n, int s,
                    int lane, IkWin* w) {
    int* ws = wb + WB_TILE;
    const bool next = ph == PH_PRED && j + 1 < n;
    switch (s) {
        case IB_DESC:  // the tile's rows into WS_D; the batch's first window
            if (lane < IB_ROWS) ws[WS_D + lane] = wb[WB_D + lane * 32 + j];
            if (ph == PH_PRED && j == 0) {
                ikb_issue(p, wb, 0, lane, w);
                ikb_commit(tb, p, wb, 0, lane, w, ws);
            }
            break;
        case IB_ISSUE: if (next) ikb_issue(p, wb, j + 1, lane, w); break;
        case IB_H:
            if (ph != PH_ZERO) {
                int fh[8];  // the taps in registers
                for (int q = 0; q < 8; q++) fh[q] = ws[WS_T + q];
                ik_step_h(tb, p, ikb_tile(wb, j), lane, ws, fh);
            }
            break;
        case IB_OUT: {
            int fh[8], fv[8];
            for (int q = 0; q < 8; q++) {
                fh[q] = ws[WS_T + q];
                fv[q] = ws[WS_T + 8 + q];
            }
            ik_out<true>(tb, p, ph, ikb_tile(wb, j), lane, ws, fh, fv);
            break;
        }
        default: if (next) ikb_commit(tb, p, wb, j + 1, lane, w, ws);
    }
}

// the residual add of cells 4v .. 4v + 3: one 16-byte load of the planes
// (from L2), one of the residuals (non-coherent) and one store on the card
IK_HD void ik_resid4(const InterFrame& p, int v) {
#ifdef __CUDA_ARCH__
    const int mx = (1 << p.bpc) - 1;
    int4* pl = (int4*)p.planes + v;
    const int4 a = __ldcg(pl);
    const int4 r = __ldg((const int4*)(p.ra + 3 * ik_psz(p)) + v);
    *pl = make_int4(ik_clamp(a.x + r.x, 0, mx), ik_clamp(a.y + r.y, 0, mx),
                    ik_clamp(a.z + r.z, 0, mx), ik_clamp(a.w + r.w, 0, mx));
#else
    for (int i = 4 * v; i < 4 * v + 4; i++) ik_resid(p, i);
#endif
}

#ifdef __CUDACC__

#define IK_SPIN_CYCLES (1ll << 31)  // ~1 s at 1.98 GHz: far above any phase

// The traced builds' clock stamps (clock64 of thread 0), per block and
// phase: the phase's start (the barrier before it passed) and the block's
// tiles done (after a block barrier). A block's wait at a barrier is the
// next phase's start less this one's done.
enum { IK_ST_START, IK_ST_DONE, IK_STAMPS, IK_PHASES = PH_RESID + 1 };

template <bool TRACE>
__device__ __forceinline__ void ik_stamp(long long* clk, int ph, int k) {
    if (!TRACE) return;
    if (k == IK_ST_DONE) __syncthreads();
    if (threadIdx.x == 0) clk[((size_t)blockIdx.x * IK_PHASES + ph) * IK_STAMPS + k] = clock64();
}

// The grid-wide barrier (csrc/wave.cu's): every store of the block before a
// block barrier, then one thread's release fence and relaxed add; it waits
// with an acquiring spin until all `grid` blocks arrived `n` times, and the
// block barrier hands the order on. A wait that outlasts ~2^31 cycles traps.
__device__ __forceinline__ void ik_grid_sync(int* bar, int target) {
    __syncthreads();
    if (threadIdx.x == 0) {
        asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.s32 [%0], %1;" ::"l"(bar),
                     "r"(1)
                     : "memory");
        const long long t0 = clock64();
        for (;;) {
            int v;
            asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
            if (v >= target) break;
            if (clock64() - t0 > IK_SPIN_CYCLES) __trap();
        }
    }
    __syncthreads();
}

// The earlier form's frame kernel: tile g to warp g mod warps, each
// tile's descriptor, window and taps read from global memory, a scalar
// residual add. TRACE: with the clock stamps.
template <bool TRACE>
__device__ __forceinline__ void ik_frame(const InterFrame& p, int* bar, long long* clk) {
    __shared__ int sm[IK_WARPS * WS_WORDS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* ws = sm + warp * WS_WORDS;
    const int nw = gridDim.x * IK_WARPS, w = blockIdx.x * IK_WARPS + warp;
    int syncs = 0;
    bool ran = false;
    for (int ph = PH_ZERO; ph < PH_RESID; ph++) {
        int g0, g1;
        ik_range(p, ph, &g0, &g1);
        if (g0 >= g1) continue;  // the same for every block
        if (ran) ik_grid_sync(bar, ++syncs * gridDim.x);
        ran = true;
        ik_stamp<TRACE>(clk, ph, IK_ST_START);
        for (int g = g0 + w; g < g1; g += nw) {
            const IkTile t = ik_tile(p, g);
            for (int s = 0; s < IK_STEPS; s++) {
                ik_step(p, ph, t, s, lane, ws);
                __syncwarp();
            }
        }
        ik_stamp<TRACE>(clk, ph, IK_ST_DONE);
    }
    if (ran) ik_grid_sync(bar, ++syncs * gridDim.x);
    ik_stamp<TRACE>(clk, PH_RESID, IK_ST_START);
    const int n3 = 3 * ik_psz(p);
    for (int i = blockIdx.x * IK_THREADS + threadIdx.x; i < n3; i += gridDim.x * IK_THREADS)
        ik_resid(p, i);
    ik_stamp<TRACE>(clk, PH_RESID, IK_ST_DONE);
}

__global__ void __launch_bounds__(IK_THREADS)
    inter_frame_kernel(const __grid_constant__ InterFrame p, int* bar) {
    ik_frame<false>(p, bar, nullptr);
}

__global__ void __launch_bounds__(IK_THREADS)
    inter_frame_trace_kernel(const __grid_constant__ InterFrame p, int* bar, long long* clk) {
    ik_frame<true>(p, bar, clk);
}

// The new form: the filter tables copied into shared memory as int8 once a
// block, then each phase's tiles in batches (ik_batch tiles a warp takes,
// block-major: ik_warp_of), and the residual add as a 16-byte
// pass where the planes and the residuals are 16-byte aligned (the scalar
// pass where not, and for the tail). TRACE: with the clock stamps.
template <bool TRACE>
__device__ __forceinline__ void ikb_frame(const InterFrame& p, int* bar, long long* clk) {
    __shared__ __align__(16) int8_t s_warpf[IK_NWF * 8];
    __shared__ int8_t s_sub[IK_NF * IK_NPH * 8];
    __shared__ int s_fdir[IK_NFD * 2];
    __shared__ int sm[IK_WARPS * WB_WORDS];
    for (int i = threadIdx.x; i < IK_NWF * 8; i += IK_THREADS) s_warpf[i] = (int8_t)__ldg(p.warpf + i);
    for (int i = threadIdx.x; i < IK_NF * IK_NPH * 8; i += IK_THREADS)
        s_sub[i] = (int8_t)__ldg(p.subpel + i);
    if (threadIdx.x < IK_NFD * 2) s_fdir[threadIdx.x] = __ldg(p.fdir + threadIdx.x);
    __syncthreads();
    const IkSharedTabs tb{s_warpf, s_sub, s_fdir};
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int* wb = sm + warp * WB_WORDS;
    // batch b to warp b / grid of block b mod grid: consecutive batches (of
    // one slot, and often one cost) spread over the blocks and their SMs (a
    // counter that hands the batches out as warps come free measured
    // slower on the card: its atomics)
    const int nw = gridDim.x * IK_WARPS, w = ik_warp_of(warp, blockIdx.x, gridDim.x);
    int syncs = 0;
    bool ran = false;
    for (int ph = PH_ZERO; ph < PH_RESID; ph++) {
        int g0, g1;
        ik_range(p, ph, &g0, &g1);
        if (g0 >= g1) continue;  // the same for every block
        if (ran) ik_grid_sync(bar, ++syncs * gridDim.x);
        ran = true;
        ik_stamp<TRACE>(clk, ph, IK_ST_START);
        const int s0 = ik_seg0(p, ph), bs = ik_batch(g1 - g0, nw);
        for (int b0 = g0 + w * bs; b0 < g1; b0 += nw * bs) {
            const int n = g1 - b0 < bs ? g1 - b0 : bs;
            if (lane < n) ikb_load(p, s0, b0 + lane, lane, wb);
            __syncwarp();
            IkWin win;
            for (int j = 0; j < n; j++) {
#pragma unroll
                for (int st = 0; st < IB_STEPS; st++) {
                    ikb_step(tb, p, ph, wb, j, n, st, lane, &win);
                    if (st != IB_ISSUE) __syncwarp();
                }
            }
        }
        ik_stamp<TRACE>(clk, ph, IK_ST_DONE);
    }
    if (ran) ik_grid_sync(bar, ++syncs * gridDim.x);
    ik_stamp<TRACE>(clk, PH_RESID, IK_ST_START);
    const int n3 = 3 * ik_psz(p), t0 = blockIdx.x * IK_THREADS + threadIdx.x;
    const int nt = gridDim.x * IK_THREADS;
    int i = t0;
    if ((((uintptr_t)p.planes | (uintptr_t)(p.ra + n3)) & 15) == 0) {
        for (int v = t0; v < n3 >> 2; v += nt) ik_resid4(p, v);
        i = (n3 & ~3) + t0;
    }
    for (; i < n3; i += nt) ik_resid(p, i);
    ik_stamp<TRACE>(clk, PH_RESID, IK_ST_DONE);
}

// four blocks an SM, as the earlier form keeps: at most 64 registers
__global__ void __launch_bounds__(IK_THREADS, 4)
    inter_batch_kernel(const __grid_constant__ InterFrame p, int* bar) {
    ikb_frame<false>(p, bar, nullptr);
}

__global__ void __launch_bounds__(IK_THREADS, 4)
    inter_batch_trace_kernel(const __grid_constant__ InterFrame p, int* bar, long long* clk) {
    ikb_frame<true>(p, bar, clk);
}

// The blocks one launch of a kernel takes on this card: as many as stay
// resident. `which`: 0 the earlier frame kernel, 1 its traced build, 2 the
// new form, 3 its traced build.
extern "C" int rav1d_inter_grid(int which) {
    const void* k[] = {(const void*)inter_frame_kernel, (const void*)inter_frame_trace_kernel,
                       (const void*)inter_batch_kernel, (const void*)inter_batch_trace_kernel};
    int dev, sms, per;
    if (which < 0 || which > 3) return -1;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, k[which], IK_THREADS, 0) != cudaSuccess)
        return -1;
    return sms * per;
}

extern "C" int rav1d_inter_stamps(void) { return IK_PHASES * IK_STAMPS; }

// Plain C entry (bound with ctypes): one cooperative launch of `grid` blocks
// over the frame's inter phase on `stream`; `bar` is one int32 in device
// memory, 0 at the launch. Returns the launch's error code (-1 for
// arguments the kernel does not take).
extern "C" int rav1d_inter_frame(const InterFrame* f, int grid, int* bar, void* stream) {
    if (ik_check(*f) || grid < 1) return -1;
    void* args[] = {(void*)f, (void*)&bar};
    const cudaError_t e = cudaLaunchCooperativeKernel((const void*)inter_frame_kernel, dim3(grid),
                                                      dim3(IK_THREADS), args, 0,
                                                      (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

static int ik_launch(const void* kernel, const InterFrame* f, int grid, int* bar,
                     long long* clk, void* stream) {
    if (ik_check(*f) || grid < 1) return -1;
    const cudaError_t z = cudaMemsetAsync(bar, 0, sizeof(int), (cudaStream_t)stream);
    if (z != cudaSuccess) return (int)z;
    void* args[] = {(void*)f, (void*)&bar, (void*)&clk};
    const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(IK_THREADS), args,
                                                      0, (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// Plain C entry of the new form (bound with ctypes): the barrier word `bar`
// (one int32 in device memory, kept by the caller) set to 0 on `stream`,
// then one cooperative launch of `grid` blocks over the frame's inter phase.
// Returns the first error code (-1 for arguments the kernel does not take).
extern "C" int rav1d_inter_batches(const InterFrame* f, int grid, int* bar, void* stream) {
    return ik_launch((const void*)inter_batch_kernel, f, grid, bar, nullptr, stream);
}

// rav1d_inter_batches through its traced build, the stamps into `clk` as
// rav1d_inter_frame_trace writes them
extern "C" int rav1d_inter_batches_trace(const InterFrame* f, int grid, int* bar, long long* clk,
                                         void* stream) {
    return ik_launch((const void*)inter_batch_trace_kernel, f, grid, bar, clk, stream);
}

// rav1d_inter_frame through its traced build: the clock stamps of every
// block and phase into `clk` (grid x IK_PHASES x IK_STAMPS int64, zero
// where a phase does not run).
extern "C" int rav1d_inter_frame_trace(const InterFrame* f, int grid, int* bar, long long* clk,
                                       void* stream) {
    if (ik_check(*f) || grid < 1) return -1;
    void* args[] = {(void*)f, (void*)&bar, (void*)&clk};
    const cudaError_t e = cudaLaunchCooperativeKernel((const void*)inter_frame_trace_kernel,
                                                      dim3(grid), dim3(IK_THREADS), args, 0,
                                                      (cudaStream_t)stream);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

#else  // a host build of the same functions, for the CPU tests

#include <algorithm>
#include <vector>

// rav1d_inter_frame without the barrier word and the stream: the phases in
// order, each barrier a loop boundary; in a phase the warps of `grid` blocks
// in turn, each of its tiles step by step for every lane in turn, or, with
// `reverse`, the phase's tiles from the last to the first. The warp's shared
// words start as a pattern at each tile, so a read of a word no step wrote
// shows. Returns 0, or -1 for arguments the kernel does not take.
extern "C" int rav1d_inter_frame_host(const InterFrame* f, int grid, int reverse) {
    const InterFrame& p = *f;
    if (ik_check(p) || grid < 1) return -1;
    std::vector<int> ws(WS_WORDS);
    const int nw = grid * IK_WARPS;
    auto tile = [&](int ph, int g) {
        for (int& v : ws) v = 0x5a5a5a5a;
        const IkTile t = ik_tile(p, g);
        for (int s = 0; s < IK_STEPS; s++)
            for (int lane = 0; lane < 32; lane++) ik_step(p, ph, t, s, lane, ws.data());
    };
    for (int ph = PH_ZERO; ph < PH_RESID; ph++) {
        int g0, g1;
        ik_range(p, ph, &g0, &g1);
        if (reverse) {
            for (int g = g1 - 1; g >= g0; g--) tile(ph, g);
            continue;
        }
        for (int w = 0; w < nw; w++)
            for (int g = g0 + w; g < g1; g += nw) tile(ph, g);
    }
    const int n3 = 3 * ik_psz(p);
    for (int b = 0; b < grid; b++)
        for (int t = 0; t < IK_THREADS; t++)
            for (int i = b * IK_THREADS + t; i < n3; i += grid * IK_THREADS) ik_resid(p, i);
    return 0;
}

// rav1d_inter_batches without the barrier word and the stream: the tables
// as int8 copies, then the phases in order, each barrier a loop boundary;
// in a phase the warps of `grid` blocks in turn, each warp's batches in
// order (with `reverse`, all of them from the last to the first), each
// batch's load lane by lane, then each tile's steps, each step for
// every lane in turn, the lanes' window registers kept between the steps.
// The warp's words start as a pattern at each batch, a tile's
// intermediates at each tile and the taps and window before each commit,
// so a read of a word no step wrote shows. The
// residual add walks the blocks' threads as the kernel does. Returns 0, or
// -1 for arguments the kernel does not take.
extern "C" int rav1d_inter_batches_host(const InterFrame* f, int grid, int reverse) {
    const InterFrame& p = *f;
    if (ik_check(p) || grid < 1) return -1;
    std::vector<int8_t> warpf(IK_NWF * 8), sub(IK_NF * IK_NPH * 8);
    std::vector<int> fdir(IK_NFD * 2), wb(WB_WORDS);
    for (int i = 0; i < IK_NWF * 8; i++) warpf[i] = (int8_t)p.warpf[i];
    for (int i = 0; i < IK_NF * IK_NPH * 8; i++) sub[i] = (int8_t)p.subpel[i];
    for (int i = 0; i < IK_NFD * 2; i++) fdir[i] = p.fdir[i];
    const IkSharedTabs tb{warpf.data(), sub.data(), fdir.data()};
    std::vector<IkWin> win(32);
    const int nw = grid * IK_WARPS;
    for (int ph = PH_ZERO; ph < PH_RESID; ph++) {
        int g0, g1;
        ik_range(p, ph, &g0, &g1);
        if (g0 >= g1) continue;
        const int s0 = ik_seg0(p, ph), bs = ik_batch(g1 - g0, nw);
        std::vector<int> order;  // the batches' first tiles, warp by warp
        for (int b = 0; b < grid; b++)
            for (int k = 0; k < IK_WARPS; k++)
                for (int b0 = g0 + ik_warp_of(k, b, grid) * bs; b0 < g1; b0 += nw * bs)
                    order.push_back(b0);
        if (reverse) std::sort(order.rbegin(), order.rend());
        for (const int b0 : order) {
            const int n = g1 - b0 < bs ? g1 - b0 : bs;
            for (int& v : wb) v = 0x5a5a5a5a;
            for (int lane = 0; lane < n; lane++) ikb_load(p, s0, b0 + lane, lane, wb.data());
            for (int j = 0; j < n; j++)
                for (int st = 0; st < IB_STEPS; st++) {
                    if (st == IB_DESC)  // the tile's own intermediates
                        for (int c = WS_MID; c < WS_WORDS; c++) wb[WB_TILE + c] = 0x5a5a5a5a;
                    if (st == IB_COMMIT || (st == IB_DESC && j == 0))  // taps, window
                        for (int c = WS_T; c < WS_MID; c++) wb[WB_TILE + c] = 0x5a5a5a5a;
                    for (int lane = 0; lane < 32; lane++)
                        ikb_step(tb, p, ph, wb.data(), j, n, st, lane, &win[lane]);
                }
        }
    }
    const int n3 = 3 * ik_psz(p);
    for (int b = 0; b < grid; b++)
        for (int t = 0; t < IK_THREADS; t++) {
            const int t0 = b * IK_THREADS + t;
            for (int v = t0; v < n3 >> 2; v += grid * IK_THREADS) ik_resid4(p, v);
            for (int i = (n3 & ~3) + t0; i < n3; i += grid * IK_THREADS) ik_resid(p, i);
        }
    return 0;
}

#endif  // __CUDACC__
