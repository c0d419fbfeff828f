// The inter phase of a frame, CUDA C++ for sm_90a: every put, warp, prep,
// compound combine and OBMC blend of the frame and the batch residual add,
// in one persistent cooperative launch (rav1d_inter_frame) whose phases
// meet at a grid-wide barrier.
//
// Replaces the XLA device program the JAX engine runs once per inter frame:
// rav1d_tpu/engine/mega.py inter_prog (:466), with _put_out (:289),
// _prep_out (:369), _warp_out (:423) and the tile helpers of
// rav1d_tpu/engine/tiles.py (_i16, _gather, _filters: :38-58). The port's
// plain version is engine/programs.py inter_plain (one batch of torch ops
// per slot run); this kernel computes exactly what it computes.
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
// wave kernel's: a rising counter zeroed per frame by the wrapper, a release
// fence and a relaxed add to arrive, an acquiring spin to wait) separates
// two phases that run. Within a phase, each warp takes 8x8 tiles in turn
// (tile g to warp g mod warps): step 0 loads the descriptor into its shared
// words, step 1 the source window (clamped gather) and the taps, step 2 the
// horizontal pass (or the DIFFWTD mask), step 3 the vertical pass, the
// combine or the blend, and the masked stores; __syncwarp between steps.
// Reads of what the launch itself writes (planes, pools) go through
// ld.global.cg: a persistent block keeps its SM's L1 across phases.
//
// Bound on this card: bytes. A 1080p inter frame moves the residual add's
// three int32 planes (read, residuals read, written: 75 MB) and its tiles'
// descriptors and windows: 85-110 MB, 25-33 us at 3.35 TB/s, against
// 31-186 M int32 operations (2-11 us; chip_smoke.py inter_work). On an
// H100 80GB HBM3 the launch took 0.066-0.146 ms of device time on the
// 1080p test frames (PERF.md): 2.6-4.4x the bound. What the design leaves
// on the table: a warp per tile with its taps read from shared memory, a
// scalar residual-add pass, and reference windows read a byte or two a
// lane.
//
// The same source compiles for the host with g++ (the #else branch at the
// end): rav1d_inter_frame_host walks the same phases, warps and tiles with
// the same step functions, lane by lane, each barrier a loop boundary, for
// the CPU tests.

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define IK_HD __host__ __device__ __forceinline__
#else
#define IK_HD static inline
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
IK_HD void ik_step_window(const InterFrame& p, const IkTile& t, int lane, int* ws) {
    const int* d = ws + WS_D;
    const int k = t.slot & 1;  // slots 0-9 alternate luma, chroma
    if (ik_mc_slot(t.slot)) {
        int y0, x0, ny, nx;
        ik_win_geom(t.cs, d, &y0, &x0, &ny, &nx);
        for (int i = lane; i < ny * nx; i += 32) {
            const int r = i / nx, c = i % nx;
            ws[WS_WIN + r * 16 + c] = ik_ref(p, k, d[D_SROW], y0 + r, x0 + c);
        }
        if (t.cs <= 2 && lane < 16) {
            // tiles.py _filters: the filter types of the 2-D code, 4-tap
            // variants for blocks 4 wide or tall, phase 0 reading phase 1
            const int dir = lane >> 3, tap = lane & 7;
            const int fd = IK_LD(p.fdir + 2 * ik_clamp(d[D_F2D], 0, IK_NFD - 1) + dir);
            const int big = dir ? d[D_BH] > 4 : d[D_BW] > 4;
            const int fi = ik_clamp(big ? fd : 3 + (fd & 1), 0, IK_NF - 1);
            const int ph = ik_clamp((dir ? d[D_MY] : d[D_MX]) - 1, 0, IK_NPH - 1);
            ws[WS_T + lane] = IK_LD(p.subpel + (fi * IK_NPH + ph) * 8 + tap);
        }
    } else if (ik_warp_slot(t.slot)) {
        for (int i = lane; i < 225; i += 32) {
            const int r = i / 15, c = i % 15;
            ws[WS_WIN + r * 16 + c] = ik_ref(p, k, d[W_SROW], d[W_SY] - 3 + r, d[W_SX] - 3 + c);
        }
    }
}

IK_HD int ik_warp_tap(const InterFrame& p, int m, int k) {
    return IK_LD(p.warpf + ik_clamp(64 + ((m + 512) >> 10), 0, IK_NWF - 1) * 8 + k);
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
IK_HD void ik_step_h(const InterFrame& p, const IkTile& t, int lane, int* ws) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc);
    if (ik_mc_slot(t.slot) && t.cs == 0) {
        const int sh = 6 - ib;
        for (int i = lane; i < 120; i += 32) {
            const int r = i >> 3, x = i & 7;
            int s = 0;
            for (int k = 0; k < 8; k++) s += ws[WS_T + k] * ws[WS_WIN + r * 16 + x + k];
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
            const int m = d[W_MX] + y * d[W_B] + x * d[W_A];
            int s = 0;
            for (int k = 0; k < 8; k++) s += ik_warp_tap(p, m, k) * ws[WS_WIN + y * 16 + x + k];
            ws[WS_MID + i] = ik_i16((s + ((1 << sh) >> 1)) >> sh);
        }
    } else if (t.slot >= S_SEGY00 && t.slot <= S_SEGY11) {
        for (int o = lane; o < 64; o += 32)
            ws[WS_M + o] = ik_seg_m(p, ik_pool_cell(p.pool, p, d[C_R0], o),
                                    ik_pool_cell(p.pool, p, d[C_R1], o));
    }
}

// the vertical 8-tap sum of column c from row r of the window or of mid
IK_HD int ik_vsum(const int* ws, int base, int stride, int r, int c) {
    int s = 0;
    for (int k = 0; k < 8; k++) s += ws[WS_T + 8 + k] * ws[base + (r + k) * stride + c];
    return s;
}

IK_HD int ik_hsum(const int* ws, int r, int c) {
    int s = 0;
    for (int k = 0; k < 8; k++) s += ws[WS_T + k] * ws[WS_WIN + r * 16 + c + k];
    return s;
}

// cell o of a put tile (mega.py _put_out)
IK_HD int ik_put_px(const InterFrame& p, int cs, const int* ws, int o) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc), pxmax = (1 << p.bpc) - 1, sh = 6 - ib;
    const int r = o >> 3, c = o & 7;
    int v;
    switch (cs) {
        case 0: {
            const int sh2 = 6 + ib;
            v = (ik_vsum(ws, WS_MID, 8, r, c) + ((1 << sh2) >> 1)) >> sh2;
            break;
        }
        case 1: v = (ik_hsum(ws, r, c) + 32 + ((1 << sh) >> 1)) >> 6; break;
        case 2: v = (ik_vsum(ws, WS_WIN, 16, r, c) + 32) >> 6; break;
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
IK_HD int ik_prep_px(const InterFrame& p, int cs, const int* ws, int o) {
    const int ib = ik_ib(p.bpc), bias = p.bpc == 8 ? 0 : 8192, sh = 6 - ib;
    const int r = o >> 3, c = o & 7;
    int v;
    switch (cs) {
        case 0: v = ((ik_vsum(ws, WS_MID, 8, r, c) + 32) >> 6) - bias; break;
        case 1: v = ((ik_hsum(ws, r, c) + ((1 << sh) >> 1)) >> sh) - bias; break;
        case 2: v = ((ik_vsum(ws, WS_WIN, 16, r, c) + ((1 << sh) >> 1)) >> sh) - bias; break;
        default: v = (ws[WS_WIN + r * 16 + c] << ib) - bias;
    }
    return ik_i16(v);
}

// cell o of a warp tile before its rounding (mega.py _warp_out)
IK_HD int ik_warp_px(const InterFrame& p, const int* ws, int o) {
    const int* d = ws + WS_D;
    const int y = o >> 3, x = o & 7;
    const int m = d[W_MY] + y * d[W_D] + x * d[W_C];
    int s = 0;
    for (int k = 0; k < 8; k++) s += ik_warp_tap(p, m, k) * ws[WS_MID + (y + k) * 8 + x];
    return s;
}

// step 3 of a PRED tile: the output and its masked store
IK_HD void ik_pred_out(const InterFrame& p, const IkTile& t, int lane, const int* ws) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc), pxmax = (1 << p.bpc) - 1, bias = p.bpc == 8 ? 0 : 8192;
    const long long n3 = 3ll * ik_psz(p), np = ik_pool_words(p);
    if (t.slot == S_HOST) {
        const int row = ik_desc(p, t, 0);
        if (row < 0 || row >= p.poolrows) return;
        for (int o = lane; o < 64; o += 32) p.pool[(size_t)row * 64 + o] = ik_desc(p, t, 1 + o);
        return;
    }
    for (int o = lane; o < 64; o += 32) {
        switch (t.slot) {
            case S_PUTY: case S_PUTC:
                ik_store(p.planes, n3, d[D_FLAT0], p.aw, d[D_TW], d[D_TH], o,
                         ik_put_px(p, t.cs, ws, o));
                break;
            case S_LAPY: case S_LAPC:
                ik_store(p.lap, np, d[D_FLAT0], 8, d[D_TW], d[D_TH], o, ik_put_px(p, t.cs, ws, o));
                break;
            case S_PREPY: case S_PREPC:
                ik_store(p.pool, np, d[D_FLAT0], 8, d[D_TW], d[D_TH], o,
                         ik_prep_px(p, t.cs, ws, o));
                break;
            case S_WARPY: case S_WARPC: {
                const int sh = 7 + ib;
                const int v = ik_clamp((ik_warp_px(p, ws, o) + ((1 << sh) >> 1)) >> sh, 0, pxmax);
                ik_store(p.planes, n3, d[W_FLAT0], p.aw, d[W_TW], d[W_TH], o, v);
                break;
            }
            default: {  // S_WPREPY, S_WPREPC
                const int v = ik_i16(((ik_warp_px(p, ws, o) + 64) >> 7) - bias);
                ik_store(p.pool, np, d[W_FLAT0], 8, d[W_TW], d[W_TH], o, v);
            }
        }
    }
}

// step 3 of a combine tile (mega.py avg_body, the DIFFWTD bodies, mask_body,
// seguv_body)
IK_HD void ik_comb_out(const InterFrame& p, const IkTile& t, int lane, const int* ws) {
    const int* d = ws + WS_D;
    const int ib = ik_ib(p.bpc), pxmax = (1 << p.bpc) - 1, bias = p.bpc == 8 ? 0 : 8192;
    const int psz = ik_psz(p);
    const long long n3 = 3ll * psz;
    for (int o = lane; o < 64; o += 32) {
        const int r = o >> 3, c = o & 7;
        const int t1 = ik_pool_cell(p.pool, p, d[C_R0], o), t2 = ik_pool_cell(p.pool, p, d[C_R1], o);
        int v;
        if (t.slot == S_AVG) {
            const int wt = d[C_P0];
            v = (t1 * wt + t2 * (16 - wt) + (8 << ib) + bias * 16) >> (ib + 4);
        } else {
            int m;
            if (t.slot == S_MASK)
                m = IK_LD(p.blob + ik_clamp(p.hbase + d[C_P0] + r * d[C_P1] + c, 0, p.blob_len - 1));
            else if (t.slot == S_SEGUV)
                m = IK_CG(p.mask + ik_clamp(d[C_P0] + r * d[C_P1] + c, 0, psz - 1));
            else
                m = ws[WS_M + o];
            v = (t1 * m + t2 * (64 - m) + (32 << ib) + bias * 64) >> (ib + 6);
        }
        ik_store(p.planes, n3, d[C_FLAT0], p.aw, d[C_TW], d[C_TH], o, ik_clamp(v, 0, pxmax));
    }
    if (t.slot < S_SEGY00 || t.slot > S_SEGY11) return;
    // the mask pool: the cells of the (sub-sampled) mask, with the sign bits
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

// step 3 of a blend tile (mega.py blend_body)
IK_HD void ik_blend_out(const InterFrame& p, int lane, const int* ws) {
    const int* d = ws + WS_D;
    const int n3 = 3 * ik_psz(p);
    for (int o = lane; o < 64; o += 32) {
        const int r = o >> 3, c = o & 7;
        const int idx = d[B_FLAT0] + r * p.aw + c;
        const int a = IK_CG(p.planes + ik_clamp(idx, 0, n3 - 1));
        const int b = ik_pool_cell(p.lap, p, d[B_ROW], o);
        const int m = IK_LD(p.blob + ik_clamp(p.hbase + d[B_MOFF] + r * d[B_MRS] + c * d[B_MCS], 0,
                                               p.blob_len - 1));
        if (r < d[B_TH] && c < d[B_TW] && idx >= 0 && idx < n3)
            p.planes[idx] = (a * (64 - m) + b * m + 32) >> 6;
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

// step s of tile t in phase ph for one lane
IK_HD void ik_step(const InterFrame& p, int ph, const IkTile& t, int s, int lane, int* ws) {
    switch (s) {
        case 0: ik_step_desc(p, t, lane, ws); break;
        case 1: if (ph == PH_PRED) ik_step_window(p, t, lane, ws); break;
        case 2: if (ph != PH_ZERO) ik_step_h(p, t, lane, ws); break;
        default:
            if (ph == PH_ZERO) ik_zero_out(p, t, lane, ws);
            else if (ph == PH_PRED) ik_pred_out(p, t, lane, ws);
            else if (t.slot == S_BLEND) ik_blend_out(p, lane, ws);
            else ik_comb_out(p, t, lane, ws);
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

#ifdef __CUDACC__

#define IK_SPIN_CYCLES (1ll << 31)  // ~1 s at 1.98 GHz: far above any phase

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

__global__ void __launch_bounds__(IK_THREADS)
    inter_frame_kernel(const __grid_constant__ InterFrame p, int* bar) {
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
        for (int g = g0 + w; g < g1; g += nw) {
            const IkTile t = ik_tile(p, g);
            for (int s = 0; s < IK_STEPS; s++) {
                ik_step(p, ph, t, s, lane, ws);
                __syncwarp();
            }
        }
    }
    if (ran) ik_grid_sync(bar, ++syncs * gridDim.x);
    const int n3 = 3 * ik_psz(p);
    for (int i = blockIdx.x * IK_THREADS + threadIdx.x; i < n3; i += gridDim.x * IK_THREADS)
        ik_resid(p, i);
}

// The blocks one launch takes on this card: as many as stay resident.
extern "C" int rav1d_inter_grid(void) {
    int dev, sms, per;
    if (cudaGetDevice(&dev) != cudaSuccess) return -1;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return -1;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, inter_frame_kernel, IK_THREADS, 0) !=
        cudaSuccess)
        return -1;
    return sms * per;
}

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

#else  // a host build of the same functions, for the CPU tests

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

#endif  // __CUDACC__
